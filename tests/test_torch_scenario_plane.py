"""Port parity: `run_comparison` on the Sent140 and production-recommender
scenarios against the JAX package's, and the recommender's two views.

A reduced plan (16 clients, 2 rounds, an eval every round, the client
plane) runs in both packages, the port started from the reference's
initial parameters drawn from each method's own view model (the
recommender's FedMeta methods from the 40-way local head, FedAvg from
the 120-way global head). Records are held as
`test_torch_experiment._hold` holds them: byte fields exactly, round 1's
metrics at the network tolerance, later numbers at the after-Adam
tolerances. Sent140's final φ (where `sent_lstm` may leave NaN entries
in either package) compares NaN masks and the finite entries. The
recommender's FedMeta and FedAvg views must pay different θ bytes and
draw one sampling stream."""
import jax
import numpy as np
import pytest
import torch

from repro.federated import experiment as jx
from repro_torch.data.federated import TaskStream
from repro_torch.federated import experiment as tx
from test_torch_experiment import BYTES, _hold, _reference_init

PLAN = dict(rounds=2, eval_every=1, num_clients=16, pipeline="client_plane")
# FedAvg, a first-order and a second-order FedMeta method, and Meta-SGD
METHODS = ("fedavg", "fomaml", "maml", "meta-sgd")
# bytes of one round (download + upload, m clients) by dataset and method
ROUND_BYTES = {
    "sent140": {"fedavg": 2_986_112, "fomaml": 2_986_112,
                "maml": 2_986_112, "meta-sgd": 5_972_224},
    "recommend": {"fedavg": 1_093_120, "fomaml": 760_320,
                  "maml": 760_320, "meta-sgd": 1_520_640},
    "shakespeare": {"fedavg": 3_636_608, "fomaml": 3_636_608,
                    "maml": 3_636_608},
    "lm": {"fedavg": 2_500_608, "fomaml": 2_500_608},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def compare(dataset, methods, **kw):
    """(reference record, port record, reference plan) of one reduced
    comparison, the port started from the reference's initial
    parameters."""
    jplan = jx.default_plan(dataset, methods=methods, **PLAN, **kw)
    tplan = tx.default_plan(dataset, methods=methods, **PLAN, **kw)
    jout = jx.run_comparison(jplan, save=False)
    tout = tx.run_comparison(tplan, device="cpu",
                             init_params=_reference_init(jplan))
    return jout, tout, jplan


def hold_records(jout, tout, round_bytes):
    """Every record of the port's comparison against the reference's."""
    assert tout["plan"] == jout["plan"]
    assert list(tout["methods"]) == list(jout["methods"])
    for m, jrec in jout["methods"].items():
        trec = tout["methods"][m]
        assert sorted(trec) == sorted(jrec)
        for k in BYTES:
            assert trec["comm"][k] == jrec["comm"][k], (m, k)
        assert round(trec["comm"]["comm_MB"] * 1e6) == \
            trec["comm"]["rounds"] * round_bytes[m]
        assert len(trec["history"]) == len(jrec["history"])
        for r, (a, b) in enumerate(zip(trec["history"], jrec["history"])):
            assert sorted(a) == sorted(b), (m, r)
            for k in BYTES + ("round",):
                assert a[k] == b[k], (m, r, k)
            for k in b:
                if k in BYTES or k in ("round", "client_GFLOPs"):
                    continue
                _hold(a[k], b[k], k, first=(r == 0 and "eval" not in k))
        _hold(trec["test_acc"], jrec["test_acc"], "accuracy")
        _hold(trec["test_loss"], jrec["test_loss"], "loss")
        assert trec["fairness"]["num_clients"] == \
            jrec["fairness"]["num_clients"]
    assert list(tout["comm_to_target"]) == list(jout["comm_to_target"])


@pytest.fixture(scope="module")
def sent140():
    return compare("sent140", METHODS)


@pytest.fixture(scope="module")
def recommend():
    return compare("recommend", METHODS)


@pytest.mark.parametrize("dataset", ["sent140", "recommend"])
def test_scenario_records_match_reference(dataset, request):
    jout, tout, _ = request.getfixturevalue(dataset)
    hold_records(jout, tout, ROUND_BYTES[dataset])


def test_sent140_phi_nan_masks_and_finite_entries(sent140):
    """Sent140's final φ of each FedMeta method against the reference
    trainer's on the same plan (the eval passes draw from their own
    stream, so a run without them trains the same φ): equal NaN masks,
    and the finite entries within Adam's 2·lr a round of each other."""
    _, tout, jplan = sent140
    init = _reference_init(jplan)
    _, mview = jx._build_views(jplan, jx.DATASETS["sent140"])
    for m in ("fomaml", "maml", "meta-sgd"):
        tr = jx.make_trainer(jplan, m, mview.loss_fn, mview.eval_fn,
                             mview.train)
        state = tr.init(jax.random.PRNGKey(jplan.seed), mview.model.init)
        tr.measure_flops(state)
        state = tr.run(state, jplan.rounds)
        jphi = np.asarray(state["phi"])
        tphi = tout["states"][m]["phi"].numpy()
        assert tphi.shape == jphi.shape
        np.testing.assert_array_equal(np.isnan(tphi), np.isnan(jphi))
        live = ~np.isnan(jphi)
        assert np.all(np.abs(tphi[live] - jphi[live])
                      <= 2 * jplan.outer_lr * jplan.rounds * (1 + 1e-5)), m
        n0 = sum(a.size for a in jax.tree.leaves(init[m]))
        assert np.array_equal(tphi[n0:], jphi[n0:])     # the zero tail


def test_recommend_theta_asymmetry(recommend):
    """FedMeta ships the 40-way local head, FedAvg the 120-way global
    head: different θ bytes on both legs, the size on every record, and
    top-4 accuracy (paper Table 3) in every record."""
    jout, tout, _ = recommend
    fa, fm = tout["methods"]["fedavg"], tout["methods"]["fomaml"]
    assert (fa["comm"]["phi_MB"], fm["comm"]["phi_MB"]) == (0.06832, 0.04752)
    assert tout["methods"]["meta-sgd"]["comm"]["phi_MB"] == 0.09504
    assert fa["comm"]["rounds"] == fm["comm"]["rounds"] == PLAN["rounds"]
    assert fa["comm"]["download_MB"] > fm["comm"]["download_MB"]
    assert fa["comm"]["upload_MB"] > fm["comm"]["upload_MB"]
    for m, rec in tout["methods"].items():
        for h in rec["history"]:
            assert h["phi_MB"] == rec["comm"]["phi_MB"]
            assert ("top4" in h) == ("top4" in
                                     jout["methods"][m]["history"][0])
    assert all("top4" in h for m in ("fomaml", "maml", "meta-sgd")
               for h in tout["methods"][m]["history"])
    assert tout["plan"]["local_head"] == 40
    # the FedMeta plane is sized by the local head (11,880 padded to
    # 1024), FedAvg's rows are the dense global model
    assert tout["states"]["fomaml"]["phi"].numel() == 12_288
    assert sum(v.numel() for v in
               tout["states"]["fedavg"]["theta"].values()) == 17_080


def test_recommend_views_share_sampling_stream():
    """The FedMeta (local-label) and FedAvg (global-label) views of one
    plan draw the same task stream — same picks, support and query
    examples, weights and counts; only the labels differ — and the meta
    view's labels fit the 40-way head."""
    plan = tx.default_plan("recommend", num_clients=24)
    gview, mview = tx._build_views(plan, tx.DATASETS["recommend"], "cpu")
    assert gview is not mview
    for a, b in ((gview.train, mview.train), (gview.val, mview.val),
                 (gview.test, mview.test)):
        assert [c.n for c in a] == [c.n for c in b]
    ga = TaskStream(gview.train, 8, 0.5, 32, 16, np.random.RandomState(7))
    mb = TaskStream(mview.train, 8, 0.5, 32, 16, np.random.RandomState(7))
    for _ in range(3):
        ta, tb = ga.next(), mb.next()
        for f in ("support_x", "query_x", "weight", "query_count",
                  "client_idx"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        assert tb.support_y.max() < 40
        assert not np.array_equal(ta.support_y, tb.support_y)
    gsize = sum(v.numel() for v in gview.model.init(0).values())
    msize = sum(v.numel() for v in mview.model.init(0).values())
    assert (gsize, msize) == (17_080, 11_880)
    # a scenario without an asymmetry gives one view
    g, m = tx._build_views(tx.default_plan("sent140", num_clients=12),
                           tx.DATASETS["sent140"], "cpu")
    assert g is m
