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
(tests/test_kernels_attention.py)."""
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
}


def _qkv(rng, B, Lq, Lk, H, Kv, hd, hd_v):
    return (rng.randn(B, Lq, H, hd).astype(np.float32),
            rng.randn(B, Lk, Kv, hd).astype(np.float32),
            rng.randn(B, Lk, Kv, hd_v).astype(np.float32))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_matches_pallas(case):
    B, Lq, Lk, H, Kv, hd, hd_v, causal, window, qoff = ATTN_CASES[case]
    q, k, v = _qkv(np.random.RandomState(3), B, Lq, Lk, H, Kv, hd, hd_v)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    expect = jnp.swapaxes(jax_flash(sw(q), sw(k), sw(v), causal=causal,
                                    window=window, q_offset=qoff,
                                    block_q=32, block_k=32, interpret=True),
                          1, 2)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    got = attn_ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **ATT)
    # the (B, H, L, hd) entry point, on transposed views
    bhld = flash_attention_bhld(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                _t(v).transpose(1, 2), **kw)
    np.testing.assert_allclose(bhld.transpose(1, 2).numpy(),
                               np.asarray(expect), **ATT)


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


def test_flash_attention_kv_length_stays_on_plain_version():
    q, k, v = _qkv(np.random.RandomState(5), 2, 8, 16, 2, 1, 16, 16)
    kvl = np.array([5, 16], np.int32)
    expect = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, kv_length=jnp.asarray(kvl))
    got = attn_ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                   kv_length=_t(kvl))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **ATT)


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
