"""Port parity: each kernel module of the port against the JAX package.

On the CPU each port wrapper runs its kernel's plain PyTorch version
(the CUDA kernels run only on the card, where `chip_smoke.py` holds
them against these same plain versions). The JAX side runs the Pallas
kernels in interpret mode, as the JAX package's own tests do. Inputs
come from seeded numpy streams and go through both.

Tolerances: the inner update is one rounded product and one rounded
difference on both sides — f32 rtol 1e-5 / atol 1e-6. The aggregation
and the fused Adam round each step the same way on both sides but may
differ in the last bit (XLA may fuse or reorder, and `b ** t` may differ
by an ulp between XLA and PyTorch): f32 rtol 1e-5 / atol 1e-6 as well. Attention sums
in another order (online softmax over tiles vs one pass), so it is held
at 2e-5, the reference's own kernel-vs-oracle tolerance
(tests/test_kernels_attention.py). The flash-attention case test also
holds both packages against a float64 oracle at a bound derived from
float32 accumulation, element by element (see `_attention_f64`), and
each other at the larger of the two."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.flash_attention import flash_attention_bhld as jax_flash
from repro.kernels.attention.ref import mha_reference as jax_mha
from repro.kernels.decode_attention.flash_decode import flash_decode as jax_decode
from repro.kernels.meta_update import ops as jax_mu
from repro.kernels.meta_update.aggregate import weighted_aggregate_flat as jax_agg
from repro.kernels.meta_update.fused import inner_update_plane as jax_plane
from repro.optim.fused_adam import adam_flat_update as jax_adam_flat
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.flash_attention import flash_attention_bhld
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.meta_update import aggregate, fused, ops as mu_ops
from repro_torch.optim import fused_adam

F32 = dict(rtol=1e-5, atol=1e-6)
ATT = dict(rtol=2e-5, atol=2e-5)
C, N = 3, 2048


def _t(a):
    return torch.from_numpy(np.array(a))


def _alpha(kind, rng):
    if kind == "scalar":
        return 0.05
    shape = (N,) if kind == "shared" else (C, N)
    return (rng.rand(*shape) * 0.1).astype(np.float32)


# ---- K1: inner update -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inner_update_case(kind):
    """Inputs and the Pallas (interpret) result, shared by both impls."""
    rng = np.random.RandomState(0)
    theta = rng.randn(C, N).astype(np.float32)
    g = rng.randn(C, N).astype(np.float32)
    alpha = _alpha(kind, rng)
    expect = jax_mu.inner_update(
        jnp.asarray(theta), alpha if kind == "scalar" else jnp.asarray(alpha),
        jnp.asarray(g), impl="pallas_interpret")
    return theta, g, alpha, np.asarray(expect)


@pytest.mark.parametrize("kind", ["scalar", "shared", "per_client"])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_inner_update_matches_pallas(kind, impl):
    theta, g, alpha, expect = _inner_update_case(kind)
    a = alpha if kind == "scalar" else _t(alpha)
    got = mu_ops.inner_update(_t(theta), a, _t(g), impl=impl)
    np.testing.assert_allclose(got.numpy(), expect, **F32)


def test_inner_update_one_client_plane_and_in_place():
    rng = np.random.RandomState(1)
    theta = rng.randn(N).astype(np.float32)
    g = rng.randn(N).astype(np.float32)
    alpha = (rng.rand(N) * 0.1).astype(np.float32)
    expect = jax_mu.inner_update(jnp.asarray(theta), jnp.asarray(alpha),
                                 jnp.asarray(g), impl="pallas_interpret")
    t = _t(theta)
    got = mu_ops.inner_update(t, _t(alpha), _t(g), impl="cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **F32)
    # no gradient to track: θ itself was updated (input_output_aliases)
    assert got.data_ptr() == t.data_ptr()
    with pytest.raises(ValueError):
        mu_ops.inner_update(_t(theta), _t(np.zeros((C, N), np.float32)),
                            _t(g), impl="cuda")


@pytest.mark.parametrize("kind", ["scalar", "shared", "per_client"])
def test_inner_update_vjp_matches_jax(kind):
    rng = np.random.RandomState(2)
    theta = rng.randn(C, N).astype(np.float32)
    g = rng.randn(C, N).astype(np.float32)
    ct = rng.randn(C, N).astype(np.float32)
    alpha = _alpha(kind, rng)
    if kind == "scalar":
        f = lambda t, gg: jax_plane(t, alpha, gg, interpret=True)
        _, vjp = jax.vjp(f, jnp.asarray(theta), jnp.asarray(g))
        jt, jg = vjp(jnp.asarray(ct))
        ja = None
    else:
        f = lambda t, a, gg: jax_plane(t, a, gg, interpret=True)
        _, vjp = jax.vjp(f, jnp.asarray(theta), jnp.asarray(alpha),
                         jnp.asarray(g))
        jt, ja, jg = vjp(jnp.asarray(ct))
    tt = _t(theta).requires_grad_(True)
    tg = _t(g).requires_grad_(True)
    ins = [tt, tg]
    ta = alpha
    if kind != "scalar":
        ta = _t(alpha).requires_grad_(True)
        ins.append(ta)
    out = fused.inner_update_plane(tt, ta, tg)
    assert out.data_ptr() != tt.data_ptr()        # out of place under grad
    grads = torch.autograd.grad(out, ins, _t(ct))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jt), **F32)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg), **F32)
    if ja is not None:
        np.testing.assert_allclose(grads[2].numpy(), np.asarray(ja),
                                   rtol=1e-5, atol=1e-5)


# ---- K7: flash attention --------------------------------------------------

ATTN_CASES = {   # B, Lq, Lk, H, Kv, hd, hd_v, causal, window, q_offset
    "causal": (2, 64, 64, 4, 4, 32, 32, True, None, 0),
    "gqa": (2, 64, 64, 6, 2, 32, 32, True, None, 0),
    "window": (1, 64, 64, 4, 2, 32, 32, True, 16, 0),
    "q_offset": (2, 32, 64, 4, 2, 32, 32, True, None, 32),
    "hd_v": (1, 64, 64, 4, 4, 40, 24, True, None, 0),
    "bidirectional": (1, 64, 64, 4, 2, 32, 32, False, None, 0),
    # cross-attention: text queries over encoder frames, no mask
    "cross": (2, 96, 32, 4, 4, 32, 32, False, None, 0),
    # cross-attention at a decode step: one query over every frame
    "one_query": (2, 1, 64, 4, 4, 32, 32, False, None, 0),
}


def _qkv(rng, B, Lq, Lk, H, Kv, hd, hd_v):
    return (rng.randn(B, Lq, H, hd).astype(np.float32),
            rng.randn(B, Lk, Kv, hd).astype(np.float32),
            rng.randn(B, Lk, Kv, hd_v).astype(np.float32))


U32 = 2.0 ** -24     # float32 unit roundoff


def _gamma(n):
    return n * U32 / (1 - n * U32)


def _attention_f64(q, k, v, causal, window, q_offset):
    """Exact attention in float64 and, per element, a first-order bound
    on the error of any float32 evaluation of it.

    A score s_j = scale·Σ_i q_i k_ij over hd terms carries at most
    Δs_j = γ_hd·scale·Σ_i |q_i k_ij| + u·|s_j| (γ_n = n·u/(1 − n·u),
    u = 2^-24). A softmax weight p_j = e^(s_j − m)/Σ e^(s − m) then
    carries a relative error of at most 2·max_j Δs_j (its own score and
    the normalizer's weighted mean of the others) + γ_Lk (the
    normalizer's sum) + 16u (the exponentials, the division and an
    online softmax's rescales over a few tiles, a few ulp each). The
    output Σ_j p_j v_j adds γ_Lk·Σ_j p_j |v_j|. So
    |o_f32 − o| ≤ (2·max Δs + 2·γ_Lk + 16u)·Σ_j p_j |v_j|."""
    B, Lq, H, hd = q.shape
    _, Lk, Kv, hd_v = v.shape
    G = H // Kv
    scale = 1.0 / np.sqrt(hd)
    qd = q.astype(np.float64).reshape(B, Lq, Kv, G, hd)
    kd, vd = k.astype(np.float64), v.astype(np.float64)
    s = np.einsum("bqkgd,bjkd->bkgqj", qd, kd) * scale
    ds = (_gamma(hd) * scale * np.einsum("bqkgd,bjkd->bkgqj", np.abs(qd),
                                         np.abs(kd)) + U32 * np.abs(s))
    qpos = np.arange(Lq)[:, None] + q_offset
    jpos = np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= jpos <= qpos
    if window is not None:
        mask &= jpos > qpos - window
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bkgqj,bjkd->bqkgd", p, vd).reshape(B, Lq, H, hd_v)
    pv = np.einsum("bkgqj,bjkd->bqkgd", p, np.abs(vd)).reshape(
        B, Lq, H, hd_v)
    rel = (2 * np.where(mask, ds, 0).max(-1) + 2 * _gamma(Lk) + 16 * U32)
    rel = np.moveaxis(rel, 3, 1).reshape(B, Lq, H)[..., None]
    return o, rel * pv


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_matches_pallas(case):
    """Both packages' float32 attention against the float64 oracle at its
    derived per-element bound, so that a drift shows which side moved,
    and against each other at the larger of the old fixed tolerance
    (ATT) and that bound. A fixed 2e-5 failed here once in a 6-worker
    run (3.05e-5 on 9 of 8192 elements, cause not found); the usual gap
    is 4.8e-7 and did not move with torch's or XLA's thread count."""
    B, Lq, Lk, H, Kv, hd, hd_v, causal, window, qoff = ATTN_CASES[case]
    q, k, v = _qkv(np.random.RandomState(3), B, Lq, Lk, H, Kv, hd, hd_v)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    expect = np.asarray(jnp.swapaxes(
        jax_flash(sw(q), sw(k), sw(v), causal=causal, window=window,
                  q_offset=qoff, block_q=32, block_k=32, interpret=True),
        1, 2))
    exact, bound = _attention_f64(q, k, v, causal, window, qoff)
    assert np.all(np.abs(expect - exact) <= bound)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    got = attn_ops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    # the (B, H, L, hd) entry point, on transposed views
    bhld = flash_attention_bhld(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                _t(v).transpose(1, 2), **kw)
    for out in (got, bhld.transpose(1, 2).numpy()):
        assert np.all(np.abs(out - exact) <= bound)
        assert np.all(np.abs(out - expect) <= np.maximum(
            ATT["atol"] + ATT["rtol"] * np.abs(expect), bound))


def test_flash_attention_gradient_matches_jax():
    """The adaptation differentiates through attention: the port's
    gradient equals jax.grad of the reference oracle."""
    B, Lq, Lk, H, Kv, hd, hd_v, causal, window, qoff = ATTN_CASES["gqa"]
    rng = np.random.RandomState(4)
    q, k, v = _qkv(rng, B, Lq, Lk, H, Kv, hd, hd_v)
    w = rng.randn(B, Lq, H, hd_v).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jax_mha(*a, causal=True) * w),
                          argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = attn_ops.flash_attention(*ins, causal=True)
    tg = torch.autograd.grad((out * _t(w)).sum(), ins)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


KV_LENGTHS = {"ragged": np.array([5, 16], np.int32),
              "zero_row": np.array([0, 11], np.int32),
              "scalar": 7}


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("kvl", sorted(KV_LENGTHS))
def test_flash_attention_kv_length_stays_on_plain_version(kvl, impl):
    """Ragged kv_length goes to the oracle under either impl, as the
    reference's dispatch sends it to its own; a row with kv_length 0
    gives 0 (the oracle's guard for fully masked rows)."""
    q, k, v = _qkv(np.random.RandomState(5), 2, 8, 16, 2, 1, 16, 16)
    kv = KV_LENGTHS[kvl]
    expect = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, kv_length=jnp.asarray(kv))
    got = attn_ops.flash_attention(
        _t(q), _t(k), _t(v), causal=False, impl=impl,
        kv_length=kv if kvl == "scalar" else _t(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **ATT)
    if kvl == "zero_row":
        assert not got[0].any() and np.all(np.asarray(expect)[0] == 0)


def test_flash_attention_kv_length_never_reaches_the_kernel(monkeypatch):
    """With kv_length the dispatcher never calls K7's entry point, on
    either impl (the card's route is the same code)."""
    def refuse(*args, **kwargs):
        raise AssertionError("kv_length reached the kernel route")
    monkeypatch.setattr(attn_ops, "flash_attention_bhld", refuse)
    q, k, v = _qkv(np.random.RandomState(6), 2, 8, 16, 2, 1, 16, 16)
    for impl in ("cuda", "torch"):
        out = attn_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                       kv_length=_t(np.array([3, 16])),
                                       impl=impl)
        assert out.shape == (2, 8, 2, 16)
    with pytest.raises(AssertionError, match="kernel route"):
        attn_ops.flash_attention(_t(q), _t(k), _t(v), impl="cuda")


@pytest.mark.parametrize("dtype,hd,hd_v,takes", [
    (torch.bfloat16, 192, 128, True), (torch.bfloat16, 256, 128, False),
    (torch.bfloat16, 192, 192, True), (torch.bfloat16, 192, 256, False),
    (torch.float32, 192, 192, True), (torch.float16, 64, 64, False)])
def test_flash_attention_launch_checks_head_dims_first(monkeypatch, dtype,
                                                       hd, hd_v, takes):
    """K7's launcher refuses what the kernel does not take with a
    ValueError before it reaches the extension (a check failing inside
    the extension took the whole process down on the card), and hands
    DeepSeek's MLA shape (qk 192, value 128, bf16) and Nemotron-4's
    (qk and value 192, bf16) to the kernel."""
    from repro_torch.kernels.attention import flash_attention as k7
    calls = []

    class Ext:
        def flash_attention(self, q, k, v, out, *args):
            calls.append((tuple(q.shape), tuple(v.shape), args))

    monkeypatch.setattr(k7, "get_ext", Ext)
    q = torch.zeros((1, 2, 8, hd), dtype=dtype)
    v = torch.zeros((1, 2, 8, hd_v), dtype=dtype)
    before = k7.launches
    if takes:
        k7._launch(q, q, v, True, None, 0)
        assert calls and calls[0][2][-1] == pytest.approx(hd ** -0.5)
        assert k7.launches == before + 1
    else:
        with pytest.raises(ValueError, match="K7 takes"):
            k7._launch(q, q, v, True, None, 0)
        assert not calls and k7.launches == before


def _flash_bf16_emulated(q, k, v, terms, block_k=64):
    """K7's bf16 route on the CPU: scores from bf16 operands summed in
    f32, masked and scaled, the online softmax over tiles of 64 keys in
    f32, and P·V with P rounded to `terms` bf16 terms (1: bf16(p); 2: hi
    = bf16(p) and lo = bf16(p − hi)) against bf16 V, f32 sums, the
    output rounded to bf16. Causal, q_offset 0."""
    B, Lq, H, hd = q.shape
    _, Lk, Kv, hdv = v.shape
    G = H // Kv
    qf = q.float().reshape(B, Lq, Kv, G, hd)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float()) / np.sqrt(hd)
    keep = torch.arange(Lk)[None, :] <= torch.arange(Lq)[:, None]
    s = torch.where(keep, s, torch.tensor(-1e30))
    m = torch.full(s.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Kv, G, Lq, hdv)
    for k0 in range(0, Lk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = v.float()[:, k0:k0 + block_k]
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgqj,bjkd->bkgqd", hi, vt)
        if terms == 2:
            lo = (p - hi).bfloat16().float()
            pv = pv + torch.einsum("bkgqj,bjkd->bkgqd", lo, vt)
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, hdv).bfloat16()


@pytest.mark.parametrize("terms,fits", [(2, True), (1, False)])
def test_flash_bf16_p_rounding_against_the_card_limit(terms, fits):
    """Which P·V operand rounding meets the limit K7's bf16 route is held
    to on the card (`chip_smoke.closeness`: 2^-7·|plain| + 1e-4 per
    element, plain the oracle in bf16): P as hi + lo bf16 terms fits; P
    as one bf16 term (2^-9 relative a weight) exceeds the 1e-4 absolute
    part on outputs near zero, by about 10x here. K7 carries two terms.
    The kernel itself is held on the card."""
    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, 2, 128, 128, 6, 2, 64, 64))
    plain = attn_ops.flash_attention(q, k, v, causal=True, impl="torch")
    got = _flash_bf16_emulated(q, k, v, terms)
    limit = 2.0 ** -7 * plain.float().abs() + 1e-4
    worst = float(((got.float() - plain.float()).abs() / limit).max())
    assert (worst <= 1.0) == fits, worst


@pytest.mark.parametrize("terms,fits", [(2, True), (1, False)])
def test_flash_bf16_p_rounding_at_mla_head_dims(terms, fits):
    """The same emulation at DeepSeek-V2's MLA shape, qk dim 192 (128
    nope + 64 rope, scale 1/√192) and value dim 128, which K7 runs as
    `flash_attention_mma_kernel<192, 128>`: P as hi + lo bf16 terms
    stays within the card's limit, one bf16 term exceeds it (about 12x
    here)."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(rng, 1, 128, 128, 4, 4, 192, 128))
    plain = attn_ops.flash_attention(q, k, v, causal=True, impl="torch")
    assert plain.shape == (1, 128, 4, 128)
    got = _flash_bf16_emulated(q, k, v, terms)
    limit = 2.0 ** -7 * plain.float().abs() + 1e-4
    worst = float(((got.float() - plain.float()).abs() / limit).max())
    assert (worst <= 1.0) == fits, worst


# ---- K8: flash decode -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decode_case(B, Cc, Kv, G, hd):
    """Inputs and the Pallas (interpret) results for a ragged and a
    scalar kv_length, shared by both impls."""
    rng = np.random.RandomState(6)
    q = rng.randn(B, Kv * G, hd).astype(np.float32)
    kc = rng.randn(B, Cc, Kv, hd).astype(np.float32)
    vc = rng.randn(B, Cc, Kv, hd).astype(np.float32)
    kvl = rng.randint(1, Cc + 1, size=B).astype(np.int32)
    expect = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(kvl), block_k=32, interpret=True)
    ref1 = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      jnp.full((B,), kvl[0], jnp.int32), block_k=32,
                      interpret=True)
    return q, kc, vc, kvl, np.asarray(expect), np.asarray(ref1)


@pytest.mark.parametrize("B,Cc,Kv,G,hd", [(3, 64, 2, 3, 32), (2, 96, 1, 4, 16)])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_flash_decode_matches_pallas(B, Cc, Kv, G, hd, impl):
    q, kc, vc, kvl, expect, ref1 = _decode_case(B, Cc, Kv, G, hd)
    got = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(kvl), impl=impl)
    np.testing.assert_allclose(got.numpy(), expect, **ATT)
    # a scalar kv_length broadcasts over the batch
    one = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), int(kvl[0]),
                                   impl=impl)
    np.testing.assert_allclose(one.numpy(), ref1, **ATT)


def test_flash_attention_function_backward_recomputes_plain(monkeypatch):
    """K7's autograd.Function (the card's route under a gradient):
    forward = the kernel, backward = recomputation with the plain
    version. With the launch stood in by the plain version on the CPU,
    its gradients equal plain autograd's."""
    from repro_torch.kernels.attention import flash_attention as k7
    monkeypatch.setattr(k7, "_launch", lambda q, k, v, c, w, o:
                        k7._plain_bhld(q, k, v, c, w, o).detach().clone())
    B, Lq, Lk, H, Kv, hd, hd_v, causal, window, qoff = ATTN_CASES["window"]
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, B, Lq, Lk, H, Kv, hd, hd_v)
    w = torch.from_numpy(rng.randn(B, H, Lq, hd_v).astype(np.float32))
    ins = [_t(a).transpose(1, 2).requires_grad_(True) for a in (q, k, v)]
    out = k7._FlashAttention.apply(*ins, causal, window, qoff)
    got = torch.autograd.grad((out * w).sum(), ins)
    ref_ins = [x.detach().clone().requires_grad_(True) for x in ins]
    expect = torch.autograd.grad(
        (k7._plain_bhld(*ref_ins, causal, window, qoff) * w).sum(), ref_ins)
    for a, b in zip(got, expect):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- K2: weighted aggregation ---------------------------------------------

@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_weighted_aggregate_matches_pallas(m, dtype, impl):
    rng = np.random.RandomState(m)
    G = jnp.asarray(rng.randn(m, N).astype(np.float32)).astype(dtype)
    w = rng.rand(m).astype(np.float32)
    w /= w.sum()
    expect = np.asarray(jax_agg(G, jnp.asarray(w), interpret=True))
    Gt = tensor_from_numpy(np.asarray(G), "cpu")
    got = mu_ops.weighted_aggregate(Gt, _t(w), impl=impl)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_allclose(got.numpy(), expect, **F32)


def test_weighted_aggregate_plain_version_sums_rows_in_order():
    """The plain version is the Pallas loop's order, row by row from
    zero — the order the CUDA kernel reproduces bit for bit; an int8
    block (the int8 codec's slice folds scales into w) sums exactly."""
    rng = np.random.RandomState(4)
    G = torch.from_numpy(rng.randint(-127, 128, (5, N)).astype(np.int8))
    w = torch.from_numpy(rng.rand(5).astype(np.float32))
    acc = torch.zeros(N)
    for u in range(5):
        acc = acc + w[u] * G[u].float()
    launches = aggregate.launches
    assert torch.equal(aggregate.weighted_aggregate_flat(G, w), acc)
    assert aggregate.launches == launches      # CPU: no kernel launch


# ---- K3: fused Adam --------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_adam_flat_update_matches_pallas(wd, state_dtype, impl):
    """Three steps from zero moments against the Pallas kernel run in
    interpret mode; φ, m and v after each step. bf16 moments are held
    to one bf16 ulp (rtol 2^-7): their f32 value before the store may
    differ in the last bit between XLA and PyTorch and round the other
    way, which then moves that element's φ step by under 1e-5."""
    rng = np.random.RandomState(7)
    phi = rng.randn(N).astype(np.float32)
    grads = [rng.randn(N).astype(np.float32) for _ in range(3)]
    kw = dict(lr=1e-3, wd=wd)
    jp, jm, jv = jnp.asarray(phi), jnp.zeros(N, state_dtype), \
        jnp.zeros(N, state_dtype)
    jstep = jnp.zeros((), jnp.int32)
    tdt = getattr(torch, state_dtype)
    tp, tm, tv = _t(phi), torch.zeros(N, dtype=tdt), torch.zeros(N, dtype=tdt)
    tstep = torch.zeros((), dtype=torch.int32)
    p_tol, s_tol = (F32, F32) if state_dtype == "float32" else (
        dict(rtol=1e-5, atol=1e-5), dict(rtol=2.0 ** -7, atol=1e-6))
    for g in grads:
        jp, jm, jv, jstep = jax_adam_flat(
            jp, jnp.asarray(g), jm, jv, jstep, state_dtype=jnp.dtype(
                state_dtype), impl="pallas_interpret", **kw)
        tp, tm, tv, tstep = fused_adam.adam_flat_update(
            tp, _t(g), tm, tv, tstep, state_dtype=tdt, impl=impl, **kw)
        assert tm.dtype == tdt and tv.dtype == tdt
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **p_tol)
        for t, j in ((tm, jm), (tv, jv)):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), **s_tol)
    assert int(tstep) == int(jstep) == 3


def test_adam_kernel_wrapper_updates_in_place_on_cpu():
    """`adam_flat_pallas` writes φ, m, v where they lie (the reference's
    aliases), with the plain version's values."""
    rng = np.random.RandomState(8)
    phi, g = _t(rng.randn(N).astype(np.float32)), _t(rng.randn(N).astype(
        np.float32))
    m, v = torch.zeros(N), torch.zeros(N)
    scales = torch.tensor([10.0, 1000.0])
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)
    expect = fused_adam.adam_flat_ref(phi, g, m, v, scales, **kw)
    out = fused_adam.adam_flat_pallas(phi, g, m, v, scales, **kw)
    assert out[0] is phi and out[1] is m and out[2] is v
    for a, b in zip(out, expect):
        assert torch.equal(a, b)
