"""Port parity: the failure plane's robust reductions — row liveness, the
masked mean, norm screening, the trimmed mean (K5's plain version and the
sort-based route), `robust_aggregate` — and the packed step with faults
and robust aggregators, against the JAX package on seeded numpy inputs.

The reference runs as its own tests run it: ``impl="xla"``, and the
Pallas interpreter for K5. Tolerances:

  * K5's plain version does the reference kernel's arithmetic in its
    order (one f32 rounding per add, subtract and divide), so it is held
    BITWISE against `trimmed_mean_flat(interpret=True)`, degenerate
    rounds included (NaN and ±inf at the same positions); the sort route
    against the reference's sort oracle at rtol 1e-6.
  * Masked mean and screen sum the rows (and the screen's squared norms)
    in other orders than the reference's dot and reduce: rtol 1e-5 /
    atol 1e-6, as the reference's own kernel-vs-oracle tests.
  * Through a packed step: metrics and the meta-gradient (Adam's
    m/(1−b1)) at rtol 1e-4 / atol 1e-5, the network tolerance of the
    other port tests; φ within 2·lr of the reference (Adam's first step
    moves a near-zero entry by up to lr either way, see
    test_torch_fedmeta); ``skipped`` exactly. Port-vs-port contracts (a
    zero-fraction config and the guard on a clean round change nothing,
    a poisoned round freezes the state) are bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedmeta as jfm
from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.federated.faults import FaultConfig as JaxFaultConfig
from repro.kernels.meta_update import aggregate as ja
from repro.kernels.meta_update.ops import robust_aggregate as jax_robust
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.optim import adam as jax_adam
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.convert import from_numpy_tree
from repro_torch.core import fedmeta as tfm
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.federated.faults import FaultConfig
from repro_torch.kernels.meta_update import aggregate as ta
from repro_torch.kernels.meta_update import ops
from repro_torch.models.paper import femnist_cnn
from repro_torch.optim import adam
from repro_torch.utils.flat import plane_for

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and small CPU convolutions spread over
    every core in each of them spend most of their time waiting for
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 2048
NET = dict(rtol=1e-4, atol=1e-5)
SUM_ORDER = dict(rtol=1e-5, atol=1e-6)
ALGOS = ["maml", "fomaml", "meta-sgd", "reptile"]
IMG, HID, INNER_LR, LR = 12, 16, 0.05, 1e-2


def _block(m=8, seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (m, n)).astype(np.float32),
            rng.uniform(0.5, 2.0, (m,)).astype(np.float32))


def _adversarial(seed=2):
    """The reference test's block: rows ×−1000 and ×1000, a NaN row, and
    (here) two identical rows for the first-index tie-break."""
    gs, w = _block(m=8, seed=seed)
    gs[1] *= -1000.0
    gs[6] *= 1000.0
    gs[4] = np.nan
    gs[7] = gs[3]
    return gs, w


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _hold_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---- liveness, masked mean, screen -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_liveness_matches_reference(dtype):
    gs, w = _block()
    gs[2, 5] = np.nan
    gs[5, 7] = np.inf
    w[6] = 0.0
    jg = jnp.asarray(gs).astype(getattr(jnp, dtype))
    want = np.asarray(ja.row_liveness(jg, jnp.asarray(w)))
    got = ta.row_liveness(_t(gs).to(getattr(torch, dtype)), _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [1, 1, 0, 1, 1, 0, 0, 1]


def test_masked_mean_matches_reference():
    """Dropped rows (w = 0) renormalize over the arrived ones; the kernel
    wrapper on a CPU tensor is the plain version."""
    gs, w = _block()
    w = w * np.asarray([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
    want = np.asarray(ja.masked_mean_ref(jnp.asarray(gs), jnp.asarray(w)))
    kern = np.asarray(ja.masked_mean_flat(jnp.asarray(gs), jnp.asarray(w),
                                          interpret=True))
    for fn in (ta.masked_mean_ref, ta.masked_mean_flat):
        got = fn(_t(gs), _t(w)).numpy()
        np.testing.assert_allclose(got, want, **SUM_ORDER)
        np.testing.assert_allclose(got, kern, **SUM_ORDER)
    ones = ta.masked_mean_flat(torch.ones((8, N)), _t(w))
    np.testing.assert_allclose(ones.numpy(), 1.0, rtol=1e-6)
    assert ta.launches == 0


def test_screened_weights_hand_check():
    """The reference's hand check: a row at 100× the median norm is
    clipped to 3 × the lower median of the live norms, honest rows keep
    weight 1, the NaN row is rejected from both sums, and the
    denominator keeps the unclipped weight."""
    m = 4
    gs = np.ones((m, N), np.float32)
    gs[1] *= 100.0
    gs[2] = np.nan
    w = np.ones((m,), np.float32)
    w_num, w_den = (x.numpy() for x in ta.screened_weights(
        _t(gs), _t(w), factor=3.0))
    norms = np.linalg.norm(gs, axis=1)
    med = np.median([norms[0], norms[3]])
    assert np.isclose(w_num[0], 1.0) and np.isclose(w_num[3], 1.0)
    assert np.isclose(w_num[1], 3.0 * med / norms[1], rtol=1e-5)
    assert w_num[2] == 0.0 and w_den[2] == 0.0
    assert np.isclose(w_den[1], 1.0)
    j_num, j_den = ja.screened_weights(jnp.asarray(gs), jnp.asarray(w),
                                       factor=3.0)
    np.testing.assert_allclose(w_num, np.asarray(j_num), **SUM_ORDER)
    np.testing.assert_array_equal(w_den, np.asarray(j_den))


@pytest.mark.parametrize("factor", [3.0, 1.5])
def test_screened_aggregate_matches_reference(factor):
    """A ×1000 row is clipped, a NaN row rejected: ref and kernel-wrapper
    routes against the reference's oracle and its interpret kernel."""
    gs, w = _block()
    gs[3] *= 1000.0
    gs[5] = np.nan
    jw = (jnp.asarray(gs), jnp.asarray(w))
    want = np.asarray(ja.screened_aggregate_ref(*jw, factor=factor))
    kern = np.asarray(ja.screened_aggregate_flat(*jw, factor=factor,
                                                 interpret=True))
    assert np.all(np.isfinite(want))
    wn, wd = ta.screened_weights(_t(gs), _t(w), factor=factor)
    jn, jd = ja.screened_weights(*jw, factor=factor)
    np.testing.assert_allclose(wn.numpy(), np.asarray(jn), **SUM_ORDER)
    np.testing.assert_array_equal(wd.numpy(), np.asarray(jd))
    for fn in (ta.screened_aggregate_ref, ta.screened_aggregate_flat):
        got = fn(_t(gs), _t(w), factor=factor).numpy()
        np.testing.assert_allclose(got, want, **SUM_ORDER)
        np.testing.assert_allclose(got, kern, **SUM_ORDER)


def test_screen_of_an_all_dead_round_is_nonfinite():
    gs, w = _block(m=4)
    gs[:] = np.nan
    out = ta.screened_aggregate_flat(_t(gs), _t(w))
    assert not torch.isfinite(out).any()


# ---- the trimmed mean: K5's plain version and the sort route -----------------

def _hold_trimmed(gs, live, trim):
    """K5's plain version (and the wrapper on a CPU tensor) bitwise
    against the reference's interpret kernel; the sort route against its
    sort oracle."""
    jg, jl = jnp.asarray(gs), jnp.asarray(live)
    kern = np.asarray(ja.trimmed_mean_flat(jg, jl, trim=trim,
                                           interpret=True))
    oracle = np.asarray(ja.trimmed_mean_ref(jg, jl, trim=trim))
    for fn in (ta.trimmed_mean_plain, ta.trimmed_mean_flat):
        _hold_bitwise(fn(_t(gs), _t(live), trim=trim).numpy(), kern)
    sort = ta.trimmed_mean_ref(_t(gs), _t(live), trim=trim).numpy()
    np.testing.assert_array_equal(np.isnan(sort), np.isnan(oracle))
    np.testing.assert_allclose(sort, oracle, rtol=1e-6, atol=1e-6)
    return kern, oracle


@pytest.mark.parametrize("trim", [1, 2])
def test_trimmed_mean_matches_reference_adversarial(trim):
    """Sign-flip ×1000 rows, a NaN row made dead by `row_liveness`, and
    two identical rows (the first index wins a tie)."""
    gs, w = _adversarial()
    live = ta.row_liveness(_t(gs), _t(w)).numpy()
    assert live.tolist() == [1, 1, 1, 1, 0, 1, 1, 1]
    kern, _ = _hold_trimmed(gs, live, trim)
    if trim == 2:
        honest = gs[[0, 2, 3, 5, 7]]
        assert np.all(kern <= honest.max(0) + 1e-3)
        assert np.all(kern >= honest.min(0) - 1e-3)


def test_trimmed_mean_hand_check_and_ties():
    """Columns [1, 3, 100, 5, 7] at trim 1: mean(3, 5, 7) = 5, and with
    row 2 dead mean(3, 5) = 4; a column of ties [1, 3, 3, 5, 7]."""
    for col, live, want in (([1, 3, 100, 5, 7], [1, 1, 1, 1, 1], 5.0),
                            ([1, 3, 100, 5, 7], [1, 1, 0, 1, 1], 4.0),
                            ([1, 3, 3, 5, 7], [1, 1, 1, 1, 1], 11 / 3)):
        gs = np.tile(np.asarray(col, np.float32)[:, None], (1, N))
        kern, _ = _hold_trimmed(gs, np.asarray(live, np.float32), 1)
        np.testing.assert_allclose(kern, want, rtol=1e-6)


def test_trimmed_mean_bf16_block_matches_reference():
    gs, _ = _block(seed=4)
    jg = jnp.asarray(gs).astype(jnp.bfloat16)
    live = np.ones((8,), np.float32)
    kern = np.asarray(ja.trimmed_mean_flat(jg, jnp.asarray(live), trim=2,
                                           interpret=True))
    tg = _t(gs).bfloat16()
    _hold_bitwise(ta.trimmed_mean_flat(tg, _t(live), trim=2).numpy(), kern)
    np.testing.assert_allclose(
        ta.trimmed_mean_ref(tg, _t(live), trim=2).numpy(),
        np.asarray(ja.trimmed_mean_ref(jg, jnp.asarray(live), trim=2)),
        rtol=1e-6, atol=1e-6)


# (m, live, trim) -> what the reference's kernel and sort oracle give
DEGENERATE = {
    "one_dead": (4, [1, 1, 1, 0], 1),     # finite, the middle value
    "two_live": (4, [1, 1, 0, 0], 1),     # kernel NaN and ±inf, oracle NaN
    "one_live": (4, [1, 0, 0, 0], 1),     # kernel: the live row; oracle −0
    "none_live": (4, [0, 0, 0, 0], 1),    # kernel −0 (finite); oracle −0
    "none_live_trim2": (8, [0] * 8, 2),   # kernel NaN (sentinels overflow)
}


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_trimmed_mean_degenerate_rounds_match_reference(case):
    """With n_live ≤ 2·trim the reference's kernel is not always
    non-finite and its sort oracle disagrees with it; the port keeps
    both routes as they are, every bit and every NaN and ±inf in place.
    Dead rows hold NaN, reached only through a select."""
    m, live, trim = DEGENERATE[case]
    gs, _ = _block(m=m, seed=5)
    live = np.asarray(live, np.float32)
    gs[live == 0] = np.nan
    kern, oracle = _hold_trimmed(gs, live, trim)
    if case == "one_dead":
        assert np.all(np.isfinite(kern))
        np.testing.assert_allclose(kern, np.median(gs[:3], axis=0),
                                   rtol=1e-6, atol=1e-6)
    elif case == "two_live":
        assert np.isnan(kern).any() and np.isinf(kern).any()
        assert not np.isfinite(kern).any() and np.isnan(oracle).all()
    elif case == "one_live":
        _hold_bitwise(kern, gs[0])
        assert np.all(oracle == 0) and np.all(np.signbit(oracle))
    elif case == "none_live":
        assert np.all(kern == 0) and np.all(oracle == 0)
    else:
        assert np.isnan(kern).all() and np.all(oracle == 0)


def test_torch_sort_puts_nan_last():
    """The sort route relies on NaN sorting after every number, ±inf
    included, as `jnp.sort` places it."""
    x = torch.tensor([[np.nan, 1.0], [-np.inf, np.nan], [np.inf, -2.0],
                      [0.5, np.nan]])
    got = torch.sort(x, dim=0).values
    want = np.sort(x.numpy(), axis=0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isnan(got[-1]).all() and torch.isnan(got[2:, 1]).all()


def test_trimmed_mean_refuses_a_trim_it_cannot_take():
    gs, _ = _block(m=4)
    with pytest.raises(ValueError, match="trim"):
        ta.trimmed_mean_flat(_t(gs), torch.ones(4), trim=2)


# ---- robust_aggregate --------------------------------------------------------

@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_robust_aggregate_dispatch_matches_reference(impl):
    """All four aggregators on a clean block and on one with a ×1000 row
    and a dropped row: the port's route ("torch": plain, "cuda": the
    kernel wrappers, plain on CPU tensors) against the reference's xla
    and interpret routes; no kernel launches on CPU tensors; an unknown
    name raises."""
    launches = (ta.launches, ta.trimmed_launches)
    for gs, w in (_block(), _adversarial()):
        w = w * np.asarray([1, 1, 1, 1, 1, 0, 1, 1], np.float32)
        for agg in ops.AGGREGATORS:
            got = ops.robust_aggregate(_t(gs), _t(w), aggregator=agg,
                                       impl=impl, trim=2).numpy()
            for jimpl in ("xla", "pallas_interpret"):
                want = np.asarray(jax_robust(
                    jnp.asarray(gs), jnp.asarray(w), aggregator=agg,
                    impl=jimpl, trim=2))
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
                if agg == "trimmed" and impl == "cuda" and \
                        jimpl == "pallas_interpret":
                    tol = dict(rtol=0, atol=0)       # K5's plain version
                elif agg == "trimmed" and impl == "torch" and jimpl == "xla":
                    tol = dict(rtol=1e-6, atol=1e-6)  # sort against sort
                elif agg == "trimmed":
                    # kernel against sort: the reference's own bound for
                    # the cancellation of the ±1000× rows in the sums
                    tol = dict(rtol=0, atol=1e-3)
                else:
                    tol = dict(rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(got, want, **tol)
    assert (ta.launches, ta.trimmed_launches) == launches
    assert ops.AGGREGATORS == ("mean", "masked_mean", "screen", "trimmed")
    with pytest.raises(ValueError, match="aggregator"):
        ops.robust_aggregate(_t(gs), _t(w), aggregator="median", impl=impl)


# ---- the packed step ---------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    jm = jax_femnist_cnn(10, image_size=IMG, hidden=HID)
    tm = femnist_cnn(10, image_size=IMG, hidden=HID, device="cpu")
    theta = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    alpha = jax.tree.map(lambda p: (INNER_LR * (0.5 + rng.rand(*p.shape))
                                    ).astype(np.float32), theta)
    return jm, tm, theta, alpha


def _round(seed, m=4, S=6, Q=5):
    rng = np.random.RandomState(seed)
    sup = (rng.rand(m, S, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, S)).astype(np.int32))
    qry = (rng.rand(m, Q, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, Q)).astype(np.int32))
    w = rng.randint(5, 50, m).astype(np.float32)
    return sup, qry, w


FAULTS = {"dropout": dict(dropout=0.25), "nonfinite": dict(nonfinite=0.25),
          "sign_flip": dict(byzantine=0.25)}


def _packed_pair(cnn, name, **kw):
    """(reference step, its state, port step, its state) from one φ."""
    jm, tm, theta, alpha = cnn
    jalgo = jax_make_algorithm(name, *jax_cls_loss(jm.apply), INNER_LR)
    talgo = make_algorithm(name, *classification_loss(tm.apply), INNER_LR)
    phi = ({"theta": theta, "alpha": alpha} if name == "meta-sgd"
           else {"theta": theta})
    jphi = jax.tree.map(jnp.asarray, phi)
    tphi = from_numpy_tree(phi, "cpu")
    jp, tp = jax_plane_for(jphi), plane_for(tphi)
    jkw = dict(kw)
    if kw.get("faults") is not None:
        jkw["faults"] = JaxFaultConfig(**kw["faults"])
        kw = {**kw, "faults": FaultConfig(**kw["faults"])}
    js = jfm.make_packed_meta_train_step(jalgo, jax_adam(LR), jp,
                                         impl="xla", client_plane=True,
                                         **jkw)
    ts = tfm.make_packed_meta_train_step(talgo, adam(LR), tp,
                                         client_plane=True, **kw)
    return (js, jfm.init_packed_state(jax_adam(LR), jp, jphi), ts,
            tfm.init_packed_state(adam(LR), tp, tphi))


def _meta_grad(state):
    return np.asarray(state["opt"]["m"], np.float32) / 0.1   # b1 = 0.9


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("aggregator", ["mean", "masked_mean", "screen",
                                        "trimmed"])
def test_packed_step_with_faults_matches_reference(cnn, aggregator, fault):
    """One FOMAML round, m = 4, one faulty client (dropped, NaN or
    sign-flipped ×10), each aggregator, the guard on: the same fault pick
    in both packages."""
    js, jst, ts, tst = _packed_pair(cnn, "fomaml", aggregator=aggregator,
                                    trim=1, faults=FAULTS[fault], guard=True)
    sup, qry, w = _round(21)
    pick = FaultConfig(**FAULTS[fault]).pick(4, np.random.RandomState(3))
    jpick = JaxFaultConfig(**FAULTS[fault]).pick(4, np.random.RandomState(3))
    for a, b in zip(pick, jpick):
        np.testing.assert_array_equal(a, b)
    j_new, j_met = js(jst, *(jax.tree.map(jnp.asarray, x)
                             for x in (sup, qry, w)),
                      fault=tuple(map(jnp.asarray, jpick)))
    phi0 = tst["phi"].clone()
    t_new, t_met = ts(tst, *(from_numpy_tree(x, "cpu") for x in (sup, qry)),
                      torch.from_numpy(w), fault=pick)
    assert sorted(t_met) == sorted(j_met)
    assert float(t_met["skipped"]) == float(j_met["skipped"])
    skipped = float(j_met["skipped"]) == 1.0
    # the mean and the masked mean do not screen rows: a NaN row poisons
    # them and the guard skips the round
    assert skipped == (fault == "nonfinite" and
                       aggregator in ("mean", "masked_mean"))
    for k in j_met:
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]), **NET)
    np.testing.assert_allclose(_meta_grad(t_new), _meta_grad(j_new), **NET)
    tp_, jp_ = t_new["phi"].numpy(), np.asarray(j_new["phi"])
    assert np.all(np.abs(tp_ - jp_) <= 2 * LR * (1 + 1e-5))
    if skipped:
        assert torch.equal(t_new["phi"], phi0)
        assert int(t_new["opt"]["step"]) == 0 and not t_new["opt"]["m"].any()


def test_scaled_noise_faults_match_reference_with_the_injected_draw(cnn):
    """The scaled-noise Byzantine row from the reference's own
    `jax.random.normal(PRNGKey(seed))` draw, handed to the port in place
    of the seed: screened and trimmed rounds agree."""
    cfg = dict(byzantine=0.25, byzantine_mode="scaled_noise",
               byzantine_scale=5.0)
    for aggregator in ("screen", "trimmed"):
        js, jst, ts, tst = _packed_pair(cnn, "fomaml", aggregator=aggregator,
                                        faults=cfg, guard=True)
        sup, qry, w = _round(22)
        pick = FaultConfig(**cfg).pick(4, np.random.RandomState(5))
        j_new, j_met = js(jst, *(jax.tree.map(jnp.asarray, x)
                                 for x in (sup, qry, w)),
                          fault=tuple(map(jnp.asarray, pick)))
        draw = torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(pick[3]), (4, ts_n(tst)), jnp.float32)))
        t_new, t_met = ts(tst, *(from_numpy_tree(x, "cpu")
                                 for x in (sup, qry)),
                          torch.from_numpy(w), fault=pick[:3] + (draw,))
        for k in j_met:
            np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                       **NET)
        np.testing.assert_allclose(_meta_grad(t_new), _meta_grad(j_new),
                                   **NET)


def ts_n(state):
    return state["phi"].shape[0]


@pytest.mark.parametrize("name", ALGOS)
def test_failure_knobs_off_and_guard_are_bitwise_noops(cnn, name):
    """Port against port, every algorithm (the reference's own guard
    test fails for Reptile on this tree): a zero-fraction FaultConfig
    with the mean, and the guard on a clean round, leave φ, the Adam
    state and the metrics bit for bit as without them (the guard adds
    skipped = 0)."""
    outs = []
    for kw in ({}, dict(faults={}, guard=False), dict(guard=True)):
        _, _, ts, st = _packed_pair(cnn, name, **kw)
        for r in range(2):
            sup, qry, w = _round(30 + r)
            extra = {}
            if kw.get("faults") is not None:
                extra["fault"] = FaultConfig().pick(
                    4, np.random.RandomState(r))
            st, met = ts(st, *(from_numpy_tree(x, "cpu")
                               for x in (sup, qry)),
                         torch.from_numpy(w), **extra)
        outs.append((st, met))
    (s0, m0) = outs[0]
    for s, m in outs[1:]:
        if "skipped" in m:
            assert float(m.pop("skipped")) == 0.0
        assert m.keys() == m0.keys()
        assert all(torch.equal(m[k], m0[k]) for k in m0)
        assert torch.equal(s["phi"], s0["phi"])
        assert all(torch.equal(s["opt"][k], s0["opt"][k]) for k in s0["opt"])


def test_guard_freezes_a_poisoned_round(cnn):
    """Half the rows NaN with the mean: the round is skipped, φ and the
    Adam state (step count included) bit for bit as before it; the next
    clean round then steps from them."""
    _, _, ts, st = _packed_pair(cnn, "fomaml", faults=dict(nonfinite=0.5),
                                guard=True)
    sup, qry, w = _round(40)
    args = (*(from_numpy_tree(x, "cpu") for x in (sup, qry)),
            torch.from_numpy(w))
    before = {"phi": st["phi"].clone(),
              **{k: v.clone() for k, v in st["opt"].items()}}
    pick = FaultConfig(nonfinite=0.5).pick(4, np.random.RandomState(0))
    assert pick[1].sum() == 2
    st, met = ts(st, *args, fault=pick)
    assert float(met["skipped"]) == 1.0
    assert torch.equal(st["phi"], before["phi"])
    assert all(torch.equal(st["opt"][k], before[k]) for k in st["opt"])
    clean = (np.ones(4, np.float32), np.zeros(4, bool), np.zeros(4, bool),
             np.uint32(0))
    st, met = ts(st, *args, fault=clean)
    assert float(met["skipped"]) == 0.0 and int(st["opt"]["step"]) == 1
