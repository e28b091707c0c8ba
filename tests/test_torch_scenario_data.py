"""Port parity: the scenario generators (Sent140, Shakespeare, the
production recommender, the LM dialect corpora) against the JAX
package's, and the local-head view of the recommender.

Every generator draws from one numpy `RandomState`, so the port's copy
gives the reference's arrays bit for bit: same client count, same
dtypes, same x and y, and the same `split_clients`. The local-label view
keeps client order, features and sizes (so the seeded sampling streams
are the global view's), `FederatedDataset.view` refuses a transform
that changes a client's size, and ``lazy=True`` gives a lazy registry
bitwise equal to the eager dataset."""
import numpy as np
import pytest

import repro.data as R
from repro.data.federated import TaskStream as JaxTaskStream
import repro_torch.data as T
from repro_torch.data.federated import ClientData, FederatedDataset, TaskStream

GENERATORS = {
    "sent140": ("make_sent140", dict(num_clients=12)),
    "sent140-short": ("make_sent140",
                      dict(num_clients=9, seq_len=7, vocab=60,
                           mean_samples=12, seed=3)),
    "shakespeare": ("make_shakespeare", dict(num_clients=8,
                                             mean_samples=40)),
    "shakespeare-vocab": ("make_shakespeare",
                          dict(num_clients=5, seq_len=9, mean_samples=25,
                               vocab=30, seed=2)),
    "recommend": ("make_recommend", dict(num_clients=12)),
    "recommend-small": ("make_recommend",
                        dict(num_clients=10, num_services=60, ctx_dim=4,
                             mean_records=40, rank=3, seed=5)),
    "femnist": ("make_femnist", dict(num_clients=6, mean_samples=12)),
    "lm": ("make_lm_clients", dict(num_clients=12)),
    "lm-small": ("make_lm_clients", dict(num_clients=7, mean_seqs=5,
                                         seq_len=8, vocab=32, seed=4)),
}


def _same_clients(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert ca.x.dtype == cb.x.dtype and ca.y.dtype == cb.y.dtype
        np.testing.assert_array_equal(ca.x, cb.x)
        np.testing.assert_array_equal(ca.y, cb.y)


@pytest.mark.parametrize("case", list(GENERATORS))
def test_generator_bitwise_equal_to_reference(case):
    name, kw = GENERATORS[case]
    j, t = getattr(R, name)(**kw), getattr(T, name)(**kw)
    assert (t.num_classes, t.name) == (j.num_classes, j.name)
    _same_clients(j.clients, t.clients)
    for seed in (0, 7):
        for a, b in zip(j.split_clients(seed), t.split_clients(seed)):
            _same_clients(a, b)


def test_lm_task_batch_bitwise_equal_to_reference():
    j = R.make_lm_task_batch(3, 2, 3, 8, 32, seed=1)
    t = T.make_lm_task_batch(3, 2, 3, 8, 32, seed=1)
    assert t._fields == j._fields
    for a, b in zip(j, t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["make_sent140", "make_shakespeare",
                                  "make_recommend", "make_lm_clients",
                                  "make_femnist"])
def test_lazy_population_matches_eager(name):
    """``lazy=True`` gives a `ClientRegistry` bitwise equal to the eager
    dataset (the sequential mode, through a cache of 2), with its name,
    class count and splits; the eager path takes the reference's
    keywords and ignores them."""
    kw = dict(num_clients=6, seed=1)
    if name == "make_femnist":
        kw["mean_samples"] = 12
    eager = getattr(T, name)(**kw)
    lazy = getattr(T, name)(lazy=True, cache_clients=2, **kw)
    assert (len(lazy), lazy.num_classes, lazy.name) == \
        (len(eager.clients), eager.num_classes, eager.name)
    _same_clients(eager.clients, [lazy[i] for i in range(len(lazy))])
    for a, b in zip(eager.split_clients(0), lazy.split_clients(0)):
        _same_clients(a, list(b))
    assert lazy.cache_stats()["peak_resident"] <= 2
    ds = getattr(T, name)(num_clients=3, lazy=False, independent=True,
                          cache_clients=2)
    assert len(ds.clients) == 3


def test_localize_clients_matches_reference():
    kw = dict(num_clients=12, num_services=60, ctx_dim=4, mean_records=40,
              seed=0)
    jds, tds = R.make_recommend(**kw), T.make_recommend(**kw)
    local = T.localize_clients(tds.clients, head_size=40)
    _same_clients(R.localize_clients(jds.clients, head_size=40), local)
    for orig, loc in zip(tds.clients, local):
        assert loc.n == orig.n
        np.testing.assert_array_equal(loc.x, orig.x)
        services = np.unique(orig.y)
        np.testing.assert_array_equal(np.unique(loc.y),
                                      np.arange(len(services)))
        np.testing.assert_array_equal(services[loc.y], orig.y)
    view = T.localize_recommend(tds, head_size=40)
    jview = R.localize_recommend(jds, head_size=40)
    assert (view.num_classes, view.name) == (jview.num_classes, jview.name)
    _same_clients(jview.clients, view.clients)


def test_localize_clients_rejects_small_head():
    c = ClientData(np.zeros((5, 2), np.float32),
                   np.array([0, 3, 7, 9, 11], np.int32))
    with pytest.raises(ValueError, match="head_size"):
        T.localize_clients([c], head_size=3)
    ds = T.make_recommend(num_clients=6, num_services=60, ctx_dim=4,
                          mean_records=40, seed=0)
    most = max(len(np.unique(c.y)) for c in ds.clients)
    with pytest.raises(ValueError, match="head_size"):
        T.localize_recommend(ds, head_size=most - 1)
    assert T.localize_recommend(ds, head_size=most).num_classes == most


def test_dataset_view_contract():
    ds = FederatedDataset([ClientData(np.zeros((3, 2), np.float32),
                                      np.array([0, 1, 0], np.int64))], 2)
    v = ds.view(lambda c: ClientData(c.x, 1 - c.y), num_classes=2)
    np.testing.assert_array_equal(v.clients[0].y, [1, 0, 1])
    assert (v.num_classes, v.name) == (2, ds.name)
    with pytest.raises(ValueError, match="preserve client sizes"):
        ds.view(lambda c: ClientData(c.x[:1], c.y[:1]))


def test_local_view_shares_the_sampling_stream():
    """The local-label and global views draw the same task stream (same
    picks, support and query examples, weights and counts), and each is
    the reference's."""
    kw = dict(num_clients=16, num_services=60, ctx_dim=4, mean_records=40,
              seed=0)
    ds = T.make_recommend(**kw)
    local = T.localize_clients(ds.clients, head_size=40)
    jlocal = R.localize_clients(R.make_recommend(**kw).clients, 40)
    a = TaskStream(ds.clients, 4, 0.5, 8, 8, np.random.RandomState(7))
    b = TaskStream(local, 4, 0.5, 8, 8, np.random.RandomState(7))
    c = JaxTaskStream(jlocal, 4, 0.5, 8, 8, np.random.RandomState(7))
    for _ in range(3):
        ta, tb, tc = a.next(), b.next(), c.next()
        for f in ("support_x", "query_x", "weight", "query_count",
                  "client_idx"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        for f in tb._fields:
            np.testing.assert_array_equal(getattr(tb, f), getattr(tc, f))
