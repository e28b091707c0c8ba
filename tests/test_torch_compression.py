"""Port parity: the bytes-on-the-wire plane — the int8 codec (K6 and its
plain version), the top-k codec, error feedback, the packed step with
compression and central DP, bf16 Adam state — against the JAX package
on seeded numpy inputs.

Tolerances. On one input block the int8 payload is equal element for
element (scales, reciprocals and products are each rounded once in both
packages, `round` is half-to-even in both); only an element whose g·inv
lies within an ulp of a .5 boundary could round differently, and such
elements are counted. The residual g − s·q is held at rtol 1e-6: XLA
may contract it into one FMA. Top-k is exact, ties included. Through a
whole packed step the gradients differ by float noise (rtol 1e-4 /
atol 1e-5, the network tolerance of the other port tests); an int8
element of the corrected block that lands on a rounding boundary then
flips q by one, which moves its residual by exactly one quantization
step s_u and the meta-gradient by w_u·s_u at that coordinate. The step
tests count such flips, check each one's size, and hold everything
else at the network tolerance; φ after Adam is held within 2·lr (see
test_torch_fedmeta)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedmeta as jfm
from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.federated.privacy import DPConfig as JaxDP
from repro.federated.comm import CommTracker as JaxComm
from repro.kernels.meta_update import compress as jc
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.optim import adam as jax_adam
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.convert import from_numpy_tree
from repro_torch.core import fedmeta as tfm
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_femnist
from repro_torch.federated.privacy import DPConfig
from repro_torch.federated.server import FederatedTrainer
from repro_torch.kernels.meta_update import compress as tc
from repro_torch.kernels.meta_update import fused, ops
from repro_torch.models.paper import femnist_cnn
from repro_torch.optim import adam
from repro_torch.utils.flat import plane_for

NET = dict(rtol=1e-4, atol=1e-5)
IMG, HID, INNER_LR, LR, NC = 12, 16, 0.05, 1e-2, 7


def _block(m=5, n=4096, seed=0, zero_row=None):
    G = np.random.RandomState(seed).normal(0, 1, (m, n)).astype(np.float32)
    if zero_row is not None:
        G[zero_row] = 0.0
    return G


def _weights(m=5, seed=1):
    w = np.random.RandomState(seed).uniform(0.1, 1.0, m).astype(np.float32)
    return w / w.sum()


def _t(a):
    return from_numpy_tree(a, "cpu")


def _boundary(g, inv):
    """Elements whose f32 product g·inv lies within 1 ulp of a .5
    boundary (where a last-bit difference could flip the rounding)."""
    x = np.abs(g * inv[:, None]).astype(np.float64)
    return np.abs(x - np.floor(x) - 0.5) <= np.spacing(
        x.astype(np.float32)).astype(np.float64)


# ---- int8 codec ------------------------------------------------------------

@pytest.mark.parametrize("route", ["ref", "pallas_interpret"])
def test_int8_encode_matches_reference(route):
    """Seeded Gaussians and an all-zero row: scales equal, payload equal
    except at rounding boundaries (none on this input), residual at
    rtol 1e-6; the kernel wrapper on a CPU tensor is the plain version."""
    G = _block(zero_row=2)
    jq, js, jr = (jc.int8_encode_ref(jnp.asarray(G)) if route == "ref" else
                  jc.int8_encode_flat(jnp.asarray(G), interpret=True))
    js = np.asarray(js)
    for q, s, r in (tc.int8_encode_ref(torch.from_numpy(G)),
                    tc.int8_encode_flat(torch.from_numpy(G)),
                    ops.int8_encode(torch.from_numpy(G), impl="torch")):
        assert q.dtype == torch.int8 and r.dtype == torch.float32
        if route == "ref":
            np.testing.assert_array_equal(s.numpy(), js)
            atol = 1e-7
        else:
            # jit turns x / 127 into x · (1/127): a last-bit difference
            # in s, which moves s·q by up to 127 ulp(s)
            np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)
            atol = 127 * np.spacing(js.max())
        inv = np.where(js > 0, 1 / np.maximum(js, 1e-30), 0)
        edge = _boundary(G, inv.astype(np.float32))
        assert int(edge.sum()) == 0
        differ = q.numpy() != np.asarray(jq)
        assert not (differ & ~edge).any()
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                                   atol=atol)
        assert float(s[2]) == 0 and not q[2].any() and not r[2].any()
    assert tc.launches == 0     # CPU tensors never reach the kernel


def test_int8_rounds_half_to_even():
    """Entries at exact .5 multiples of the scale (s = 1: max |g| = 127)
    round to the even neighbour, as `jnp.round` does; the residual is
    then exactly ±0.5."""
    half = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)
    G = np.stack([np.concatenate([half, [127.0, 0.0]]).astype(np.float32),
                  np.zeros(half.size + 2, np.float32)])
    pad = (-G.shape[1]) % 1024
    G = np.pad(G, ((0, 0), (0, pad)))
    q, s, r = tc.int8_encode_flat(torch.from_numpy(G))
    jq, js, jr = jc.int8_encode_flat(jnp.asarray(G), interpret=True)
    assert float(s[0]) == 1.0 and float(s[1]) == 0.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    want = np.round(half)                         # numpy: half to even
    assert np.all(want % 2 == 0)
    np.testing.assert_array_equal(q.numpy()[0, :half.size], want)
    np.testing.assert_array_equal(np.abs(r.numpy()[0, :half.size]), 0.5)


def test_int8_aggregate_and_row_norms_match_reference():
    """K2 with the scale folded into the weight (its plain loop, on the
    CPU) against the reference's dot_general oracle and its Pallas
    aggregate in interpret mode; decoded row norms at rtol 1e-5."""
    G, w = _block(), _weights()
    q, s, _ = jc.int8_encode_ref(jnp.asarray(G))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    tw = torch.from_numpy(w)
    want = np.asarray(jc.int8_aggregate_ref(q, s, jnp.asarray(w)))
    kern = np.asarray(jc.int8_aggregate_flat(q, s, jnp.asarray(w),
                                             interpret=True))
    for got in (tc.int8_aggregate_flat(tq, ts, tw),
                ops.int8_aggregate(tq, ts, tw, impl="torch")):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), kern, atol=1e-6)
    np.testing.assert_allclose(tc.int8_row_norms(tq, ts).numpy(),
                               np.asarray(jc.int8_row_norms(q, s)),
                               rtol=1e-5)


# ---- top-k codec -------------------------------------------------------------

@pytest.mark.parametrize("val_dtype", ["float32", "bfloat16"])
def test_topk_encode_exact_with_ties(val_dtype):
    """Magnitudes drawn from a few levels, so most of them tie: the
    indices are `lax.top_k`'s exactly (ties to the lower index), values
    and residuals equal bit for bit."""
    rng = np.random.RandomState(3)
    G = (rng.randint(1, 6, (4, 2048)) * rng.choice([-1, 1], (4, 2048))
         * 0.25).astype(np.float32)
    G[1, :7] = 0.0
    jv, ji, jr = jc.topk_encode(jnp.asarray(G), 100,
                                val_dtype=getattr(jnp, val_dtype))
    tv, ti, tr = tc.topk_encode(torch.from_numpy(G), 100,
                                val_dtype=getattr(torch, val_dtype))
    assert ti.dtype == torch.int32 and tv.dtype == getattr(torch, val_dtype)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert np.all(np.diff(ti.numpy(), axis=1)[np.diff(
        np.abs(G)[np.arange(4)[:, None], ti.numpy().astype(int)],
        axis=1) == 0] > 0)      # within a tie, indices ascend


def test_topk_cast_error_lands_in_residual():
    """bf16 wire values: the residual holds the cast error, so decode +
    residual gives G back."""
    G = _block(m=2, n=1024)
    vals, idx, resid = tc.topk_encode(torch.from_numpy(G), 64,
                                      val_dtype=torch.bfloat16)
    dense = tc.topk_densify(vals, idx, G.shape[1])
    assert vals.dtype == torch.bfloat16
    assert (vals.float() != torch.from_numpy(G).gather(
        1, idx.long())).any()           # the cast did round
    np.testing.assert_allclose((dense + resid).numpy(), G, atol=1e-6)


def test_topk_aggregate_matches_reference():
    G, w = _block(), _weights()
    jv, ji, _ = jc.topk_encode(jnp.asarray(G), 128)
    want = np.asarray(jc.topk_aggregate_ref(jv, ji, jnp.asarray(w), 4096))
    kern = np.asarray(jc.topk_aggregate_flat(jv, ji, jnp.asarray(w), 4096,
                                             interpret=True))
    tv, ti = torch.from_numpy(np.asarray(jv)), torch.from_numpy(
        np.asarray(ji))
    for impl in ("cuda", "torch"):
        got = ops.topk_aggregate(tv, ti, torch.from_numpy(w), 4096,
                                 impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        np.testing.assert_allclose(got, kern, atol=1e-6)
    np.testing.assert_allclose(tc.topk_row_norms(tv).numpy(),
                               np.asarray(jc.topk_row_norms(jv)), rtol=1e-6)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_error_feedback_telescopes(codec):
    """Over T rounds of one client: Σ_t decode(encode(g_t + e_t)) + e_T
    == Σ_t g_t (f64 sums, atol 1e-4)."""
    rng = np.random.RandomState(7)
    n, T = 1024, 8
    e = torch.zeros((1, n))
    sum_g, sum_dec = np.zeros(n), np.zeros(n)
    for _ in range(T):
        g = torch.from_numpy(rng.normal(0, 1, (1, n)).astype(np.float32))
        sum_g += g[0].double().numpy()
        if codec == "int8":
            q, s, e = tc.int8_encode_flat(g + e)
            dec = s[:, None] * q.float()
        else:
            vals, idx, e = tc.topk_encode(g + e, 64)
            dec = tc.topk_densify(vals, idx, n)
        sum_dec += dec[0].double().numpy()
    np.testing.assert_allclose(sum_dec + e[0].double().numpy(), sum_g,
                               atol=1e-4)


# ---- config surface ----------------------------------------------------------

def test_compression_config_surface_and_bytes_match_reference():
    for kw in (dict(codec="int8"), dict(codec="int8", error_feedback=False),
               dict(codec="topk", topk_frac=0.05),
               dict(codec="topk", topk_frac=0.1, error_feedback=False),
               dict(codec="topk", topk_frac=1e-9)):
        t, j = tc.CompressionConfig(**kw), jc.CompressionConfig(**kw)
        assert t.label() == j.label()
        for n in (10, 1000, 461_630):
            assert t.k_for(n) == j.k_for(n)
            for item in (2, 4):
                assert t.upload_bytes(n, item) == j.upload_bytes(n, item)
    # FEMNIST (n_real 461,630): int8 461,634 B and top-5% bf16 23,082 × 6
    assert tc.CompressionConfig("int8").upload_bytes(461_630) == 461_634
    assert tc.CompressionConfig("topk").upload_bytes(461_630, 2) == \
        23_082 * 6
    with pytest.raises(ValueError, match="unknown codec"):
        tc.CompressionConfig("gzip")
    with pytest.raises(ValueError, match="topk_frac"):
        tc.CompressionConfig("topk", topk_frac=0.0)
    with pytest.raises(ValueError, match="clip_norm"):
        DPConfig(clip_norm=0.0)
    with pytest.raises(ValueError, match="noise_multiplier"):
        DPConfig(noise_multiplier=-1.0)


def test_trainer_knob_validation():
    """The reference's validation: the codec knobs need the packed vmap
    pipeline and refuse staleness, faults, robust aggregators and fused
    rounds."""
    algo = make_algorithm("fomaml", lambda p, b: 0, lambda p, b: (0, {}), 0.1)
    kw = dict(train_clients=[], clients_per_round=4, support_frac=0.5,
              support_size=8, query_size=8, seed=0, device="cpu")
    for knob in (dict(compression=tc.CompressionConfig("int8")),
                 dict(dp=DPConfig())):
        with pytest.raises(ValueError, match="packed"):
            FederatedTrainer(algo, adam(1e-3), packed=False, **knob, **kw)
        with pytest.raises(ValueError, match="packed"):
            FederatedTrainer(algo, adam(1e-3), packed=True,
                             client_axis="chunked", **knob, **kw)
        for clash in (dict(staleness=object()), dict(faults=object()),
                      dict(aggregator="trimmed"), dict(fuse_rounds=2),
                      dict(over_select=0.5)):
            with pytest.raises(ValueError):
                FederatedTrainer(algo, adam(1e-3), packed=True, **clash,
                                 **knob, **kw)
    with pytest.raises(ValueError, match="num_clients"):
        tfm.init_packed_state(adam(1e-3), plane_for({"a": torch.zeros(3)}),
                              {"a": torch.zeros(3)},
                              compression=tc.CompressionConfig("int8"))


# ---- the packed step ---------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    jm = jax_femnist_cnn(10, image_size=IMG, hidden=HID)
    tm = femnist_cnn(10, image_size=IMG, hidden=HID, device="cpu")
    theta = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    ja = jax_make_algorithm("fomaml", *jax_cls_loss(jm.apply), INNER_LR)
    ta = make_algorithm("fomaml", *classification_loss(tm.apply), INNER_LR)
    jp = jax_plane_for({"theta": jax.tree.map(jnp.asarray, theta)})
    tp = plane_for(_t({"theta": theta}))
    return ja, ta, jp, tp, {"theta": theta}


def _round_inputs(seed, m=4, S=6, Q=5):
    rng = np.random.RandomState(seed)
    sup = (rng.rand(m, S, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, S)).astype(np.int32))
    qry = (rng.rand(m, Q, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, Q)).astype(np.int32))
    w = rng.randint(5, 50, m).astype(np.float32)
    idx = np.array([5, 0, 3, 5][:m], np.int64)   # client 5 picked twice
    return sup, qry, w / w.sum(), idx


def _ef0(n, seed=11):
    return (np.random.RandomState(seed).normal(0, 1e-3, (NC, n))
            .astype(np.float32))


def _reference_step(cnn, jcfg, jdp, bd, sup, qry, w, idx, ef0, dp_round=1):
    ja, _, jp, _, phi = cnn
    opt = jax_adam(LR)
    step = jfm.make_packed_meta_train_step(
        ja, opt, jp, impl="xla", client_plane=True, compression=jcfg,
        dp=jdp, block_dtype=bd)
    state = jfm.init_packed_state(opt, jp, jax.tree.map(jnp.asarray, phi),
                                  compression=jcfg, num_clients=NC)
    if jcfg is not None and jcfg.error_feedback:
        state["ef"] = jnp.asarray(ef0)
    kw = {}
    if jcfg is not None and jcfg.error_feedback:
        kw["ef_idx"] = jnp.asarray(idx, jnp.int32)
    if jdp is not None and jdp.noise_multiplier > 0:
        kw["dp_key"] = jdp.round_key(dp_round)
    sup_j, qry_j = (jax.tree.map(jnp.asarray, x) for x in (sup, qry))
    new, met = step(state, sup_j, qry_j, jnp.asarray(w), **kw)
    # the corrected block the reference encoded, for the flip check
    G = np.asarray(jnp.asarray(_reference_rows(cnn, sup, qry)).astype(
        bd or jnp.float32), np.float32)
    if jcfg is not None and jcfg.error_feedback:
        G = G + ef0[idx]
    return new, met, G


_ROWS = {}


def _reference_rows(cnn, sup, qry):
    """The reference's (m, N) gradient block of the round (cached: every
    case runs the same round)."""
    key = (sup[0].tobytes(), qry[0].tobytes())
    if key not in _ROWS:
        ja, _, jp, _, phi = cnn
        jphi = jax.tree.map(jnp.asarray, phi)
        _ROWS[key] = jax.jit(lambda s, q: ja.client_grad_chunk_packed(
            jp, jax_plane_for(jphi["theta"]), jphi, s, q, impl="xla")[0])(
            *(jax.tree.map(jnp.asarray, x) for x in (sup, qry)))
    return _ROWS[key]


def _port_step(cnn, tcfg, tdp, bd, sup, qry, w, idx, ef0, noise=None,
               impl="cuda"):
    _, ta, _, tp, phi = cnn
    opt = adam(LR)
    step = tfm.make_packed_meta_train_step(
        ta, opt, tp, impl=impl, client_plane=True, compression=tcfg, dp=tdp,
        block_dtype=bd)
    state = tfm.init_packed_state(opt, tp, _t(phi), compression=tcfg,
                                  num_clients=NC)
    args = [_t(sup), _t(qry), torch.from_numpy(w)]
    if tcfg is not None and tcfg.error_feedback:
        state["ef"] = torch.from_numpy(ef0.copy())
        args.append(torch.from_numpy(idx))
    elif noise is not None:
        args.append(None)
    if noise is not None:
        args.append(noise)
    return step(state, *args)


def _flat(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _bf16_flip_sizes(rows):
    """(m, N) f32 block -> (m, N) sizes of the bf16 flips it admits: an
    entry that lies within NET's rtol of a bf16 rounding boundary (the
    midpoint to a bf16 neighbour in magnitude) may round to either side
    in the two packages, a move of exactly the gap to that neighbour;
    elsewhere the size is 0 (no flip admitted)."""
    g = np.abs(np.asarray(rows, np.float32))
    bits = torch.from_numpy(np.ascontiguousarray(g)).bfloat16().view(
        torch.int16).numpy().astype(np.uint32)

    def f32(b):
        return (b << 16).astype(np.uint32).view(np.float32)

    a = f32(bits)
    gap_up = f32(bits + 1) - a
    gap_dn = np.where(bits > 0, a - f32(np.maximum(bits, 1) - 1), gap_up)
    at_up = np.abs(g - (a + gap_up / 2)) <= NET["rtol"] * g
    at_dn = np.abs(g - (a - gap_dn / 2)) <= NET["rtol"] * g
    return np.where(at_up, gap_up, np.where(at_dn, gap_dn, 0.0)).astype(
        np.float32)


def _topk_bf16_flips(te, je, rows, corrected, idx, w, k):
    """The top-k codec with a bf16 block. The two packages' f32 gradient
    rows differ in their last bits, so the bf16 cast of the block may
    round an entry that sits on a rounding boundary to neighbouring bf16
    values (`_bf16_flip_sizes`). Each far EF entry must be such a flip,
    exactly one gap in size, or one of a pair whose top-k selection the
    flip swapped, and then the two magnitudes at the k-th boundary were
    a tie or one gap apart in the reference's corrected block. Returns
    (flips counted, the meta-gradient slack per coordinate): a flip at a
    coordinate the row uploads moves the meta-gradient by w_u·gap there,
    a swap by the uploaded values, and nowhere else."""
    size = _bf16_flip_sizes(rows)
    far = ~np.isclose(te, je, **NET)
    slack = np.zeros(te.shape[1], np.float32)
    picked = []
    for u in range(rows.shape[0]):
        order = np.argsort(-np.abs(corrected[u]), kind="stable")
        picked.append(np.zeros(te.shape[1], bool))
        picked[u][order[:k]] = True
        slack += np.where(picked[u], w[u] * size[u] * 1.001, 0.0)
    flips = 0
    last = {int(c): u for u, c in enumerate(idx)}
    for c, u in last.items():
        cols = np.flatnonzero(far[c])
        d = np.abs(te[c] - je[c])[cols]
        one = (size[u, cols] > 0) & np.isclose(d, size[u, cols], rtol=1e-3)
        flips += int(one.sum())
        swapped = cols[~one]
        if swapped.size:
            into = swapped[picked[u][swapped]]      # the reference's picks
            out = swapped[~picked[u][swapped]]      # the port's instead
            assert into.size == out.size, (c, swapped)
            mag = np.abs(corrected[u])
            gap = size[u, swapped].max()
            assert gap > 0, (c, swapped)            # a flip made the swap
            assert mag[into].max() - mag[out].min() <= gap * 1.001, (
                c, mag[into], mag[out], gap)
            # the reference kept its residual below a bf16 cast error at
            # its picks and the raw entry at the others; the port the
            # other way round
            assert np.all(np.abs(te[c, into] - corrected[u, into])
                          <= gap * 1.001 + NET["atol"])
            assert np.all(np.abs(je[c, out] - corrected[u, out])
                          <= NET["atol"] + NET["rtol"] * mag[out])
            slack[swapped] += w[u] * (mag[swapped] + 2 * gap) * 1.001
            flips += int(swapped.size)
    return flips, slack


def _hold_codec_step(t_new, j_new, t_met, j_met, corrected, idx, w, codec,
                     n_real, ef0=None, rows=None, k=None):
    """Metrics at NET; EF rows of clients not picked this round exactly
    as they were; picked EF rows at NET except int8 rounding flips, each
    exactly one step s_u, and (top-k over a bf16 block, where ``rows``,
    the reference's f32 block, is given) bf16 rounding flips at rounding
    boundaries (`_topk_bf16_flips`); the meta-gradient (m/(1−b1)) at NET
    except at flipped coordinates, within the slack each flip admits; φ
    within 2·lr."""
    for k_ in j_met:
        np.testing.assert_allclose(float(t_met[k_]), float(j_met[k_]), **NET)
    b1 = 0.9
    tg = _flat(t_new["opt"]["m"]) / (1 - b1)
    jg = _flat(j_new["opt"]["m"]) / (1 - b1)
    slack = np.zeros_like(jg)
    flips = 0
    if "ef" in j_new:
        te, je = _flat(t_new["ef"]), _flat(j_new["ef"])
        far = ~np.isclose(te, je, **NET)
        last = {int(c): u for u, c in enumerate(idx)}
        others = [c for c in range(te.shape[0]) if c not in last]
        np.testing.assert_array_equal(te[others], ef0[others])
        np.testing.assert_array_equal(je[others], ef0[others])
        if codec == "int8":
            s = np.abs(corrected).max(axis=1) / 127
            for c, u in last.items():
                d = np.abs(te[c] - je[c])[far[c]]
                np.testing.assert_allclose(d, s[u], rtol=1e-3)
                slack[far[c]] += w[u] * s[u] * 1.001
                flips += int(far[c].sum())
        elif rows is not None:
            flips, slack = _topk_bf16_flips(te, je, rows, corrected, idx, w,
                                            k)
        else:
            assert not far.any()
        assert flips <= 1e-3 * far.size
    _hold_meta_grad(tg, jg, slack)
    tp_, jp_ = _flat(t_new["phi"]), _flat(j_new["phi"])
    assert np.all(np.abs(tp_ - jp_) <= 2 * LR * (1 + 1e-5))
    assert not tp_[n_real:].any()
    return flips


def _hold_meta_grad(tg, jg, slack):
    ok = np.abs(tg - jg) <= NET["atol"] + NET["rtol"] * np.abs(jg) + slack
    assert ok.all(), np.abs(tg - jg)[~ok][:5]


CASES = {"int8+ef": (dict(codec="int8"), None, None),
         "int8": (dict(codec="int8", error_feedback=False), None, None),
         "topk0.05+ef(bf16)": (dict(codec="topk", topk_frac=0.05), None,
                               "bfloat16"),
         "int8+ef+dp": (dict(codec="int8"),
                        dict(clip_norm=0.5, noise_multiplier=0.1, seed=3),
                        None),
         "topk+ef+dp": (dict(codec="topk", topk_frac=0.05),
                        dict(clip_norm=0.5, noise_multiplier=0.1, seed=3),
                        None),
         "dp": (None, dict(clip_norm=0.5, noise_multiplier=0.3, seed=3),
                None)}


@pytest.mark.parametrize("case", list(CASES))
def test_packed_step_matches_reference(cnn, case):
    """One FOMAML round on the client plane, m = 4 (client 5 twice), from
    the same φ, batches and EF plane; under DP the reference's own
    `jax.random.normal(dp.round_key(1), ...)` draw is injected."""
    ckw, dkw, bd = CASES[case]
    jcfg = tc_cfg = None
    if ckw is not None:
        jcfg, tc_cfg = jc.CompressionConfig(**ckw), tc.CompressionConfig(**ckw)
    jdp = tdp = None
    if dkw is not None:
        jdp, tdp = JaxDP(**dkw), DPConfig(**dkw)
    sup, qry, w, idx = _round_inputs(21)
    _, _, jp, tp, _ = cnn
    ef0 = _ef0(jp.n_padded)
    ef0[:, jp.n_real:] = 0.0
    j_new, j_met, corrected = _reference_step(
        cnn, jcfg, jdp, getattr(jnp, bd) if bd else None, sup, qry, w, idx,
        ef0)
    noise = None
    if jdp is not None:
        noise = torch.from_numpy(np.asarray(jax.random.normal(
            jdp.round_key(1), (jp.n_padded,), jnp.float32)))
    t_new, t_met = _port_step(cnn, tc_cfg, tdp,
                              getattr(torch, bd) if bd else None, sup, qry,
                              w, idx, ef0, noise=noise)
    assert ("ef" in t_new) == ("ef" in j_new)
    codec = ckw["codec"] if ckw else None
    rows = k = None
    if codec == "topk" and bd == "bfloat16":
        rows = np.asarray(_reference_rows(cnn, sup, qry), np.float32)
        k = tc_cfg.k_for(tp.n_real)
    _hold_codec_step(t_new, j_new, t_met, j_met, corrected, idx, w, codec,
                     tp.n_real, ef0=ef0, rows=rows, k=k)


def _bf16_neighbour(x, step):
    """The bf16 value ``step`` ulps from bf16 ``x`` in magnitude."""
    b = torch.tensor([x], dtype=torch.float32).bfloat16().view(torch.int16)
    return float((b + step).view(torch.bfloat16).float())


def _synthetic_topk_round(rows, port_block, k=4):
    """A top-k round over a bf16 block, EF plane zero, clients [2, 0, 1]:
    the reference encodes bf16(rows), the port ``port_block`` -> (port
    EF, reference EF, port meta-gradient, reference meta-gradient,
    reference corrected block, picks, weights)."""
    idx = np.array([2, 0, 1])
    w = np.array([0.5, 0.3, 0.2], np.float32)

    def run(block):
        vals, ix, resid = tc.topk_encode(torch.from_numpy(block), k,
                                         val_dtype=torch.bfloat16)
        ef = np.zeros_like(block)
        ef[idx] = resid.numpy()
        g = tc.topk_aggregate_ref(vals, ix, torch.from_numpy(w),
                                  block.shape[1]).numpy()
        return ef, g

    ref_block = torch.from_numpy(rows).bfloat16().float().numpy()
    je, jg = run(ref_block)
    te, tg = run(port_block)
    return te, je, tg, jg, ref_block, idx, w


def _tie_rows():
    """(3, 64) f32: small Gaussian rows; row 0 holds 1.0, 0.9, 0.8 at
    columns 0-2 and 0.5 at columns 5 and 9 (a tie at the k = 4 boundary,
    the lower index picked), with column 5's f32 entry exactly on the
    rounding boundary below 0.5."""
    rows = (np.random.RandomState(4).normal(0, 0.01, (3, 64))
            .astype(np.float32))
    rows[0, :3] = (1.0, 0.9, 0.8)
    rows[0, 9] = 0.5
    rows[0, 5] = (0.5 + _bf16_neighbour(0.5, -1)) / 2
    return rows


@pytest.mark.parametrize("case", ["boundary", "off_boundary"])
def test_topk_bf16_flip_check_tells_drift_from_fault(case):
    """A one-ulp bf16 flip of an unpicked entry is admitted where the
    reference's f32 entry sits on the rounding boundary, and refused
    where it does not: the packed-step check tells the two packages'
    last-bit drift from a real fault."""
    rows = _tie_rows()
    a = _bf16_neighbour(0.003, 0)       # well below the row's top 4
    gap = _bf16_neighbour(a, 1) - a
    rows[1, 20] = a + gap / 2 if case == "boundary" else a + gap / 4
    ref_block = torch.from_numpy(rows).bfloat16().float().numpy()
    port = ref_block.copy()
    port[1, 20] = a + gap if ref_block[1, 20] == a else a
    te, je, tg, jg, corrected, idx, w = _synthetic_topk_round(rows, port)
    assert not np.isclose(te[0, 20], je[0, 20], **NET)   # far in EF
    if case == "boundary":
        flips, slack = _topk_bf16_flips(te, je, rows, corrected, idx, w, 4)
        assert flips == 1
        _hold_meta_grad(tg, jg, slack)
    else:
        with pytest.raises(AssertionError):
            _topk_bf16_flips(te, je, rows, corrected, idx, w, 4)


@pytest.mark.parametrize("case", ["tie", "apart"])
def test_topk_bf16_selection_swap_needs_a_tie(case):
    """A flip at the k-th boundary may swap the top-k selection: admitted
    when the two magnitudes were a tie (or one bf16 ulp apart) in the
    reference's block, refused when a swap comes with magnitudes that
    far apart."""
    rows = _tie_rows()
    ref_block = torch.from_numpy(rows).bfloat16().float().numpy()
    assert ref_block[0, 5] == 0.5 == ref_block[0, 9]
    port = ref_block.copy()
    if case == "tie":
        port[0, 5] = _bf16_neighbour(0.5, -1)     # rounds the other way
    else:
        rows[0, 9] = port[0, 9] = 0.25
        port[0, 5] = 0.125                        # not a one-ulp move
    te, je, tg, jg, corrected, idx, w = _synthetic_topk_round(rows, port)
    far_cols = np.flatnonzero(~np.isclose(te[2], je[2], **NET))
    assert set(far_cols) == {5, 9}                 # the selection swapped
    if case == "tie":
        flips, slack = _topk_bf16_flips(te, je, rows, corrected, idx, w, 4)
        assert flips == 2
        _hold_meta_grad(tg, jg, slack)
    else:
        with pytest.raises(AssertionError):
            _topk_bf16_flips(te, je, rows, corrected, idx, w, 4)


def test_codec_knobs_off_are_bitwise_noops(cnn):
    """compression=None, dp=None builds the uncompressed step: two rounds
    give the same φ, Adam state and metrics, bit for bit."""
    _, ta, _, tp, phi = cnn
    outs = []
    for kw in ({}, dict(compression=None, dp=None)):
        step = tfm.make_packed_meta_train_step(ta, adam(LR), tp,
                                               client_plane=True, **kw)
        st = tfm.init_packed_state(adam(LR), tp, _t(phi),
                                   compression=kw.get("compression"))
        for r in range(2):
            sup, qry, w, _ = _round_inputs(30 + r)
            st, met = step(st, _t(sup), _t(qry), torch.from_numpy(w))
        outs.append((st, met))
    (s0, m0), (s1, m1) = outs
    assert sorted(s0) == sorted(s1) == ["opt", "phi"]
    assert torch.equal(s0["phi"], s1["phi"])
    assert all(torch.equal(s0["opt"][k], s1["opt"][k]) for k in s0["opt"])
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_kernel_and_plain_routes_agree_bitwise_with_a_shared_generator(cnn):
    """int8+ef with DP noise from one seeded generator: the "cuda" and
    "torch" routes (both plain on the CPU) give identical states, and
    the noise changed φ."""
    ckw, dkw, _ = CASES["int8+ef+dp"]
    sup, qry, w, idx = _round_inputs(22)
    ef0 = _ef0(cnn[3].n_padded)
    outs = [_port_step(cnn, tc.CompressionConfig(**ckw), DPConfig(**dkw),
                       None, sup, qry, w, idx, ef0,
                       noise=DPConfig(**dkw).round_generator(1, "cpu"),
                       impl=impl)[0] for impl in ("cuda", "torch")]
    quiet = _port_step(cnn, tc.CompressionConfig(**ckw),
                       DPConfig(clip_norm=0.5), None, sup, qry, w, idx,
                       ef0)[0]
    assert torch.equal(outs[0]["phi"], outs[1]["phi"])
    assert torch.equal(outs[0]["ef"], outs[1]["ef"])
    assert not torch.equal(outs[0]["phi"], quiet["phi"])
    # the generator is a pure function of (seed, round)
    g1, g2 = (DPConfig(seed=4).round_generator(7, "cpu") for _ in range(2))
    assert torch.equal(torch.randn(5, generator=g1),
                       torch.randn(5, generator=g2))
    assert DPConfig(seed=4).round_seed(7) != DPConfig(seed=4).round_seed(8)


def test_dp_noise_leaves_padding_zero():
    """A noisy DP run through the trainer: φ's alignment padding stays
    exactly zero (noise is masked to the n_real live entries)."""
    tm = femnist_cnn(62, image_size=28, hidden=8, device="cpu")
    train, _, _ = make_femnist(num_clients=12, mean_samples=20,
                               seed=0).split_clients(0)
    algo = make_algorithm("fomaml", *classification_loss(tm.apply), 0.05)
    tr = FederatedTrainer(algo, adam(1e-3), train, 4, support_frac=0.5,
                          support_size=8, query_size=8, seed=0, packed=True,
                          client_plane=True, device="cpu",
                          compression=tc.CompressionConfig("int8"),
                          dp=DPConfig(clip_norm=0.5, noise_multiplier=1.0,
                                      seed=9))
    state = tr.run(tr.init(0, tm.init), 3)
    n_real = tr._plane.n_real
    assert not state["phi"][n_real:].any()
    assert state["phi"][:n_real].abs().sum() > 0
    assert not state["ef"][:, n_real:].any()
    assert state["ef"].shape == (len(train), tr._plane.n_padded)
    # codec-true bytes as the reference's tracker reckons them
    jt = JaxComm(tr.comm.phi_bytes, 4,
                 grad_bytes=jc.CompressionConfig("int8").upload_bytes(
                     n_real), codec="int8+ef")
    jt.tick(3)
    assert tr.comm.summary() == {**jt.summary(),
                                 "client_GFLOPs": 0.0}
    assert [r["codec"] for r in tr.history] == ["int8+ef"] * 3


def test_bf16_adam_state(cnn):
    """Adam with bf16 moments (K3's bf16 state) over 3 int8+ef steps: the
    moments are stored in bf16, and φ stays within Σ_t 2·√t·lr of the
    reference's bf16-state run and of the port's f32-state run (step t
    of Adam moves an entry by at most √t·lr: |m̂_t| ≤ √t·√v̂_t by
    Cauchy–Schwarz over the first t gradients)."""
    ja, ta, jp, tp, phi = cnn
    steps = 3
    bound = sum(2 * np.sqrt(t) * LR for t in range(1, steps + 1)) * 1.0001
    runs = {}
    for sd in ("float32", "bfloat16"):
        opt = adam(LR, state_dtype=getattr(torch, sd))
        cfg = tc.CompressionConfig("int8")
        step = tfm.make_packed_meta_train_step(ta, opt, tp, client_plane=True,
                                               compression=cfg)
        st = tfm.init_packed_state(opt, tp, _t(phi), compression=cfg,
                                   num_clients=NC)
        for r in range(steps):
            sup, qry, w, idx = _round_inputs(40 + r)
            st, _ = step(st, _t(sup), _t(qry), torch.from_numpy(w),
                         torch.from_numpy(idx))
        runs[sd] = st
    assert runs["bfloat16"]["opt"]["m"].dtype == torch.bfloat16
    assert runs["bfloat16"]["opt"]["v"].dtype == torch.bfloat16
    assert runs["float32"]["opt"]["m"].dtype == torch.float32
    assert np.all(np.abs(runs["bfloat16"]["phi"].numpy()
                         - runs["float32"]["phi"].numpy()) <= bound)
    jopt = jax_adam(LR, state_dtype=jnp.bfloat16)
    jcfg = jc.CompressionConfig("int8")
    jstep = jfm.make_packed_meta_train_step(ja, jopt, jp, impl="xla",
                                            client_plane=True,
                                            compression=jcfg)
    js = jfm.init_packed_state(jopt, jp, jax.tree.map(jnp.asarray, phi),
                               compression=jcfg, num_clients=NC)
    for r in range(steps):
        sup, qry, w, idx = _round_inputs(40 + r)
        js, _ = jstep(js, *(jax.tree.map(jnp.asarray, x) for x in (sup, qry)),
                      jnp.asarray(w), ef_idx=jnp.asarray(idx, jnp.int32))
    assert js["opt"]["m"].dtype == jnp.bfloat16
    assert np.all(np.abs(runs["bfloat16"]["phi"].numpy()
                         - np.asarray(js["phi"])) <= bound)


def test_meta_update_flat_matches_reference():
    """K4's wrapper (plain version on the CPU) against the reference's
    `meta_update_flat` in interpret mode; a bf16 θ raises."""
    from repro.kernels.meta_update.fused import meta_update_flat as jmu
    rng = np.random.RandomState(5)
    theta, alpha, g = (rng.normal(0, 1, 4096).astype(np.float32)
                       for _ in range(3))
    want = np.asarray(jmu(*map(jnp.asarray, (theta, alpha, g)),
                          interpret=True))
    got = fused.meta_update_flat(*map(torch.from_numpy, (theta, alpha, g)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert fused.meta_update_launches == 0
    with pytest.raises(TypeError, match="float32"):
        fused.meta_update_flat(torch.zeros(8, dtype=torch.bfloat16),
                               torch.zeros(8), torch.zeros(8))
