"""Port parity: `FedAvgTrainer` (FedAvg and FedAvg(Meta)) against the JAX
package's, from the same initial θ on the same FEMNIST clients.

The local minibatch indices come from the same numpy stream, so they
are equal exactly; bytes are equal exactly. Per-round metrics and the
eval accuracy and loss are held at rtol 1e-4 / atol 1e-5 (the network
tolerance of the other port tests). θ after local Adam is held within
Σ_t 2·√t·lr for each round's local steps (step t of Adam moves an entry
by at most √t·lr, see test_torch_compression; a near-zero gradient entry
can take any sign) and at the network tolerance on 99 % of its entries.
The chunked client axis is held against the whole axis at rtol 1e-5 /
atol 1e-6 (a tensordot summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import classification_loss as jax_cls_loss
from repro.data.synth_femnist import make_femnist as jax_make_femnist
from repro.federated.fedavg import FedAvgTrainer as JaxFedAvg
from repro.federated.server import evaluate_global as jax_evaluate_global
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_femnist, sample_task_batch
from repro_torch.federated.fedavg import FedAvgTrainer
from repro_torch.federated.server import evaluate_global
from repro_torch.models.paper import femnist_cnn

NET = dict(rtol=1e-4, atol=1e-5)
HID, LR, STEPS, ROUNDS = 16, 1e-3, 3, 3
KW = dict(local_lr=LR, local_steps=STEPS, clients_per_round=4,
          support_frac=0.2, support_size=8, query_size=8, seed=0)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def setup():
    jm = jax_femnist_cnn(62, hidden=HID)
    tm = femnist_cnn(62, hidden=HID, device="cpu")
    theta = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jsplit = jax_make_femnist(num_clients=30, mean_samples=30,
                              seed=0).split_clients(0)
    tsplit = make_femnist(num_clients=30, mean_samples=30,
                          seed=0).split_clients(0)
    return jm, tm, theta, jsplit, tsplit


def _finetune_idx(n, reps=STEPS):
    """The reference's FedAvg(Meta) draw: randint(PRNGKey(seed))."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (reps, n),
                                         0, n))


@pytest.fixture(scope="module", params=["fedavg", "fedavg(meta)"])
def runs(setup, request):
    jm, tm, theta, (jtr, jval, _), (ttr, tval, _) = setup
    meta = request.param == "fedavg(meta)"
    jt = JaxFedAvg(*jax_cls_loss(jm.apply), train_clients=jtr,
                   meta_eval=meta, **KW)
    js = jt.run(jt.init(0, lambda k: jax.tree.map(jnp.asarray, theta)),
                ROUNDS, eval_every=2, eval_clients=jval)
    tt = FedAvgTrainer(*classification_loss(tm.apply), train_clients=ttr,
                       meta_eval=meta, device="cpu",
                       finetune_idx=_finetune_idx(KW["support_size"]), **KW)
    ts = tt.run(tt.init(0, tm.init, theta=from_numpy_tree(theta, "cpu")),
                ROUNDS, eval_every=2, eval_clients=tval)
    return jt, js, tt, ts


def test_history_and_bytes_match_reference(runs):
    jt, _, tt, _ = runs
    assert tt.name == jt.name
    assert len(tt.history) == len(jt.history) == ROUNDS
    for a, b in zip(tt.history, jt.history):
        assert sorted(a) == sorted(b)
        for k in ("round", "rounds", "comm_MB", "upload_MB", "download_MB",
                  "phi_MB"):
            assert a[k] == b[k], k
        for k in ("train_loss", "accuracy", "eval_acc", "eval_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], **NET)
    assert [r["round"] for r in tt.history if "eval_acc" in r] == [2, 3]
    for k in ("phi_bytes", "rounds", "download_bytes", "upload_bytes",
              "total_bytes"):
        assert getattr(tt.comm, k) == getattr(jt.comm, k), k
    # the full model both ways, every round
    assert tt.comm.upload_bytes == tt.comm.download_bytes == \
        ROUNDS * 4 * tt.comm.phi_bytes


def test_local_minibatch_picks_are_the_reference(runs):
    """Both streams end where the reference's end, and the same task
    batch yields the same (m, steps, B) minibatches."""
    jt, _, tt, _ = runs
    for a, b in ((tt._rng, jt._rng), (tt._local_rng, jt._local_rng)):
        sa, sb = a.get_state(), b.get_state()
        np.testing.assert_array_equal(sa[1], sb[1])
        assert sa[2] == sb[2]
    tb = sample_task_batch(tt.train_clients, 4, 0.2, 8, 8,
                           np.random.RandomState(9))
    (bx, by), (px, py) = tt._local_batches(tb)
    (jbx, jby), (jpx, jpy) = jt._local_batches(tb)
    for a, b in ((bx, jbx), (by, jby), (px, jpx), (py, jpy)):
        np.testing.assert_array_equal(a, b)


def test_theta_matches_reference(runs):
    _, js, _, ts = runs
    bound = ROUNDS * sum(2 * np.sqrt(t) * LR for t in range(1, STEPS + 1))
    for a, b in zip(_leaves(to_numpy_tree(ts["theta"])), _leaves(js["theta"])):
        assert np.all(np.abs(a - b) <= bound * 1.0001)
        close = np.isclose(a, b, **NET)
        assert close.mean() > 0.99


def test_weighted_average_and_chunked_axis(setup):
    """One round_step from the same θ and batches: the data-count
    weighted average equals the reference's, and a chunk of 3 (padding
    4 clients to 6 with zero weight) equals the whole axis."""
    jm, tm, theta, (jtr, _, _), (ttr, _, _) = setup
    tb = sample_task_batch(ttr, 4, 0.2, 8, 8, np.random.RandomState(3))
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 8, (4, 2, 8))
    rows = np.arange(4)[:, None, None]
    bx, by = tb.support_x[rows, idx], tb.support_y[rows, idx]
    w = tb.weight
    jt = JaxFedAvg(*jax_cls_loss(jm.apply), train_clients=jtr, **KW)
    want = jt.round_step({"theta": jax.tree.map(jnp.asarray, theta)},
                         (jnp.asarray(bx), jnp.asarray(by)),
                         jnp.asarray(w))["theta"]
    outs = []
    for chunk in (None, 3):
        tt = FedAvgTrainer(*classification_loss(tm.apply), train_clients=ttr,
                           client_chunk=chunk, device="cpu", **KW)
        outs.append(tt.round_step({"theta": from_numpy_tree(theta, "cpu")},
                                  (torch.from_numpy(bx), torch.from_numpy(by)),
                                  w)["theta"])
    bound = sum(2 * np.sqrt(t) * LR for t in range(1, 3))
    for a, b in zip(_leaves(to_numpy_tree(outs[0])), _leaves(want)):
        assert np.all(np.abs(a - b) <= bound * 1.0001)
        assert np.isclose(a, b, **NET).mean() > 0.99
    for a, b in zip(_leaves(to_numpy_tree(outs[0])),
                    _leaves(to_numpy_tree(outs[1]))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_finetune_and_evaluate_global_match_reference(setup):
    """`finetune` with the reference's indices injected, and
    `evaluate_global` with and without it, from the same θ."""
    jm, tm, theta, (_, jval, _), (_, tval, _) = setup
    jt = JaxFedAvg(*jax_cls_loss(jm.apply), meta_eval=True, **KW)
    tt = FedAvgTrainer(*classification_loss(tm.apply), meta_eval=True,
                       device="cpu", finetune_idx=_finetune_idx(8), **KW)
    rng = np.random.RandomState(6)
    sup = (rng.rand(8, 28, 28).astype(np.float32),
           rng.randint(0, 62, 8).astype(np.int32))
    jth = jax.jit(jt.finetune)(jax.tree.map(jnp.asarray, theta),
                               jax.tree.map(jnp.asarray, sup))
    tth = tt.finetune(from_numpy_tree(theta, "cpu"),
                      tuple(map(torch.from_numpy, sup)))
    bound = sum(2 * np.sqrt(t) * LR for t in range(1, STEPS + 1))
    for a, b in zip(_leaves(to_numpy_tree(tth)), _leaves(jth)):
        assert np.all(np.abs(a - b) <= bound * 1.0001)
    kw = dict(support_frac=0.2, support_size=8, query_size=8, seed=0)
    for ft in (False, True):
        jacc, jper, jloss = jax_evaluate_global(
            jt.eval_fn, jax.tree.map(jnp.asarray, theta), jval,
            finetune=jt.finetune if ft else None, **kw)
        tacc, tper, tloss = evaluate_global(
            tt.eval_fn, from_numpy_tree(theta, "cpu"), tval,
            finetune=tt.finetune if ft else None, **kw)
        np.testing.assert_allclose(tacc, jacc, **NET)
        np.testing.assert_allclose(tloss, jloss, **NET)
        np.testing.assert_allclose(tper, np.asarray(jper), **NET)


def test_finetune_draws_and_async_knob(setup):
    """Without injection the indices come from a generator seeded with
    `seed`: the same for every call (as the reference's fixed key), in
    range; a wrongly shaped injection raises. A prefetching trainer
    (prefetch_depth=2, flush_every=2) runs, and its history equals the
    synchronous one record for record."""
    tt = FedAvgTrainer(lambda p, b: 0, lambda p, b: (0, {}), 1e-3,
                       device="cpu")
    a, b = tt.finetune_indices(8, 5, 4), tt.finetune_indices(8, 5, 4)
    assert torch.equal(a, b) and a.shape == (5, 4)
    assert int(a.min()) >= 0 and int(a.max()) < 8
    tt.finetune_idx = np.zeros((2, 2), np.int64)
    with pytest.raises(ValueError, match="finetune_idx"):
        tt.finetune_indices(8, 5, 4)
    _, tm, theta, _, (ttr, tval, _) = setup

    def run(**kw):
        tr = FedAvgTrainer(*classification_loss(tm.apply), train_clients=ttr,
                           device="cpu", **KW, **kw)
        tr.run(tr.init(0, tm.init, theta=from_numpy_tree(theta, "cpu")), 2,
               eval_every=2, eval_clients=tval)
        return tr.history

    piped = run(prefetch_depth=2, flush_every=2)
    assert len(piped) == 2 and piped == run()
