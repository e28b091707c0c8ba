"""Port parity: the Mamba2 SSD scan (`repro_torch/kernels/ssd`) against
the JAX package's, on the same seeded numpy inputs, on the CPU.

- K9's plain version `ssd_intra_chunk_plain` against the reference's
  Pallas kernel in interpret mode: rtol 1e-5 and an atol of 1e-5 of the
  largest |output| (both sum the same f32 products, in other orders).
- `ssd_chunked` on both port routes against the reference's
  "pallas_interpret" and "xla" routes and the sequential recurrence, at
  the reference's own 1e-4 (`tests/test_kernels_ssd.py:33-36`).
- An input whose above-diagonal decay overflows: the reference's
  chunked oracle (a product with a 0/1 mask) gives NaN there, its kernel
  and the port's plain version (a select) stay finite and agree.

The kernel itself runs only on the card; here the wrapper takes its
plain version because the tensors lie on the CPU, and the
`autograd.Function` around the kernel is driven with a stand-in launch
that runs the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jax_ops
from repro.kernels.ssd.ref import ssd_chunked_ref as jax_chunked_ref
from repro.kernels.ssd.ref import ssd_sequential as jax_sequential
from repro.kernels.ssd.ssd_scan import ssd_intra_chunk_pallas
from repro_torch.kernels.ssd import ops, ref, ssd_scan

SEQ = dict(rtol=1e-4, atol=1e-4)

# (B, L, nh, hp, N, chunk): the reference's own cases, then an odd chunk
# (Q = 37) and Q = 1
SHAPES = [(1, 32, 2, 8, 16, 8), (2, 64, 3, 8, 16, 16), (1, 128, 4, 16, 32, 64),
          (2, 64, 1, 4, 8, 64), (2, 74, 2, 8, 16, 37), (1, 5, 2, 4, 8, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(seed, B, L, nh, hp, N, dt_scale=1.0):
    """The reference test's inputs (`test_kernels_ssd.py:11-18`)."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, (B, L, nh, hp)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.normal(-1, 0.5, (B, L, nh)))) * dt_scale
          ).astype(np.float32)
    A = (-np.exp(rng.normal(0, 0.3, (nh,)))).astype(np.float32)
    Bm = rng.normal(0, 1, (B, L, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _kernel_inputs(x, dt, A, Bm, Cm):
    """The kernel's operands as the reference's "pallas" route forms them
    (`ops.py:40-49`): xdt (B, nh, L, hp), a (B, nh, L)."""
    xdt = np.moveaxis(x * dt[..., None], 2, 1)
    a = np.moveaxis(dt * A[None, None, :], 2, 1)
    return xdt, a, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _hold_rel(got, want, rtol=1e-5):
    """rtol and an atol of rtol times the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("B,L,nh,hp,N,chunk", SHAPES)
def test_intra_chunk_plain_matches_pallas_interpret(B, L, nh, hp, N, chunk):
    xdt, a, Bm, Cm = _kernel_inputs(*_mk(0, B, L, nh, hp, N))
    jy, jS = ssd_intra_chunk_pallas(jnp.asarray(xdt), jnp.asarray(a[..., None]),
                                    jnp.asarray(Bm), jnp.asarray(Cm),
                                    chunk=chunk, interpret=True)
    ty, tS = ref.ssd_intra_chunk_plain(*_t(xdt, a, Bm, Cm), chunk=chunk)
    assert ty.shape == (B, nh, L, hp) and ty.dtype == torch.float32
    assert tS.shape == (B, nh, L // chunk, N, hp) and tS.dtype == torch.float32
    _hold_rel(ty.numpy(), jy)
    _hold_rel(tS.numpy(), jS)
    # the wrapper takes the plain version for CPU tensors, and the
    # kernel's transposed-view layout gives the same numbers
    y2, S2 = ssd_scan.ssd_intra_chunk(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(xdt, 1, 2))
                         ).transpose(1, 2),
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 1, 2))
                         ).transpose(1, 2),
        *_t(Bm, Cm), chunk=chunk)
    assert torch.equal(y2, ty) and torch.equal(S2, tS)


@pytest.mark.parametrize("B,L,nh,hp,N,chunk", SHAPES)
def test_chunked_routes_match_reference_and_sequential(B, L, nh, hp, N, chunk):
    x, dt, A, Bm, Cm = _mk(1, B, L, nh, hp, N)
    jx = [jnp.asarray(v) for v in (x, dt, A, Bm, Cm)]
    exact = np.asarray(jax_sequential(*jx))
    j_pallas = np.asarray(jax_ops.ssd_chunked(*jx, chunk=chunk,
                                              impl="pallas_interpret"))
    j_xla = np.asarray(jax_ops.ssd_chunked(*jx, chunk=chunk, impl="xla"))
    tx = _t(x, dt, A, Bm, Cm)
    t_seq = ref.ssd_sequential(*tx).numpy()
    np.testing.assert_allclose(t_seq, exact, **SEQ)
    for impl, jy in (("cuda", j_pallas), ("torch", j_xla)):
        ty = ops.ssd_chunked(*tx, chunk=chunk, impl=impl)
        assert ty.shape == (B, L, nh, hp)
        np.testing.assert_allclose(ty.numpy(), jy, **SEQ)
        np.testing.assert_allclose(ty.numpy(), exact, **SEQ)
    # the scoped default reaches the dispatcher
    with ops.use_impl("torch"):
        assert torch.equal(ops.ssd_chunked(*tx, chunk=chunk),
                           ops.ssd_chunked(*tx, chunk=chunk, impl="torch"))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_final_state_continues_into_decode_steps(impl):
    """Prefill's final state continues exactly into decode steps
    (`test_kernels_ssd.py:39-51`), against both packages' recurrence."""
    B, L, nh, hp, N, chunk = 1, 32, 2, 4, 8, 8
    x, dt, A, Bm, Cm = _mk(2, B, L + 4, nh, hp, N)
    tx, tdt, tA, tB, tC = _t(x, dt, A, Bm, Cm)
    y_pre, state = ops.ssd_chunked(tx[:, :L], tdt[:, :L], tA, tB[:, :L],
                                   tC[:, :L], chunk=chunk, impl=impl,
                                   return_final_state=True)
    assert state.shape == (B, nh, hp, N) and state.dtype == torch.float32
    _, jstate = jax_ops.ssd_chunked(
        *(jnp.asarray(v) for v in (x[:, :L], dt[:, :L], A, Bm[:, :L],
                                   Cm[:, :L])),
        chunk=chunk, impl="pallas_interpret" if impl == "cuda" else "xla",
        return_final_state=True)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **SEQ)
    y_ref = np.asarray(jax_sequential(*(jnp.asarray(v)
                                        for v in (x, dt, A, Bm, Cm))))
    np.testing.assert_allclose(y_pre.numpy(), y_ref[:, :L], **SEQ)
    for t in range(L, L + 4):
        y_t, state = ops.ssd_decode_step(state, tx[:, t], tdt[:, t], tA,
                                         tB[:, t], tC[:, t])
        np.testing.assert_allclose(y_t.numpy(), y_ref[:, t], **SEQ)


def test_decode_step_matches_reference():
    rng = np.random.RandomState(3)
    B, nh, hp, N = 2, 3, 4, 8
    state = rng.normal(0, 1, (B, nh, hp, N)).astype(np.float32)
    x = rng.normal(0, 1, (B, nh, hp)).astype(np.float32)
    dt = rng.rand(B, nh).astype(np.float32)
    A = -rng.rand(nh).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (B, N)).astype(np.float32) for _ in range(2))
    jy, js = jax_ops.ssd_decode_step(*(jnp.asarray(v)
                                       for v in (state, x, dt, A, Bm, Cm)))
    ty, ts = ops.ssd_decode_step(*_t(state, x, dt, A, Bm, Cm))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


def _overflow_inputs():
    """dt·|A| near 10 per step: within a chunk of 16, cum_j − cum_i
    above the diagonal reaches ~140 > 88.7, where f32 exp overflows."""
    return _mk(4, 1, 32, 2, 8, 16, dt_scale=30.0)


def test_overflow_above_diagonal_is_nan_in_the_oracle_only():
    x, dt, A, Bm, Cm = _overflow_inputs()
    chunk = 16
    assert float((dt * -A[None, None]).sum(1).min()) > 88.7
    jx = [jnp.asarray(v) for v in (x, dt, A, Bm, Cm)]
    # the reference: its jnp oracle multiplies inf by 0, its kernel selects
    j_xla = np.asarray(jax_chunked_ref(*jx, chunk))
    assert np.isnan(j_xla).any()
    j_pallas = np.asarray(jax_ops.ssd_chunked(*jx, chunk=chunk,
                                              impl="pallas_interpret"))
    assert np.isfinite(j_pallas).all()
    # the port reproduces each route as it is
    tx = _t(x, dt, A, Bm, Cm)
    assert torch.isnan(ops.ssd_chunked(*tx, chunk=chunk, impl="torch")).any()
    t_cuda = ops.ssd_chunked(*tx, chunk=chunk, impl="cuda")
    assert torch.isfinite(t_cuda).all()
    _hold_rel(t_cuda.numpy(), j_pallas)
    np.testing.assert_allclose(t_cuda.numpy(),
                               np.asarray(jax_sequential(*jx)), **SEQ)
    # K9's plain version against the reference's interpret kernel
    xdt, a, _, _ = _kernel_inputs(x, dt, A, Bm, Cm)
    jy, jS = ssd_intra_chunk_pallas(jnp.asarray(xdt), jnp.asarray(a[..., None]),
                                    jnp.asarray(Bm), jnp.asarray(Cm),
                                    chunk=chunk, interpret=True)
    ty, tS = ref.ssd_intra_chunk_plain(*_t(xdt, a, Bm, Cm), chunk=chunk)
    assert torch.isfinite(ty).all() and torch.isfinite(tS).all()
    _hold_rel(ty.numpy(), jy)
    _hold_rel(tS.numpy(), jS)


def test_plain_version_gradient_is_finite_under_overflow():
    """The exponent is masked to −inf before the exp, so autograd never
    forms 0 · inf above the diagonal: every gradient is finite."""
    xdt, a, Bm, Cm = (t.requires_grad_(True) for t in _t(
        *_kernel_inputs(*_overflow_inputs())))
    y, S = ref.ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=16)
    (y.sum() + S.square().sum()).backward()
    for t in (xdt, a, Bm, Cm):
        assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("needs", [(True, True, True, True),
                                   (True, False, False, True)])
def test_autograd_function_backward_recomputes_plain(monkeypatch, needs):
    """The kernel's `autograd.Function`, with a stand-in launch (the plain
    version, counted): its forward is the launch and its gradients equal
    autograd through the plain version, for the inputs that need them."""
    calls = []

    def fake_launch(xdt, a, Bm, Cm, chunk):
        calls.append(chunk)
        return ref.ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(ssd_scan, "_launch", fake_launch)
    ins = _t(*_kernel_inputs(*_mk(5, 2, 32, 3, 8, 16)))
    rng = np.random.RandomState(6)
    gy = torch.from_numpy(rng.normal(0, 1, (2, 3, 32, 8)).astype(np.float32))
    gS = torch.from_numpy(rng.normal(0, 1, (2, 3, 2, 16, 8)).astype(np.float32))
    a1 = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
    y, S = ssd_scan._SsdIntraChunk.apply(*a1, 16)
    torch.autograd.backward((y, S), (gy, gS))
    assert calls == [16]
    a2 = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
    y2, S2 = ref.ssd_intra_chunk_plain(*a2, chunk=16)
    torch.autograd.backward((y2, S2), (gy, gS))
    assert torch.equal(y.detach(), y2.detach())
    for t1, t2, n in zip(a1, a2, needs):
        if n:
            assert torch.equal(t1.grad, t2.grad)
        else:
            assert t1.grad is None


# ---- K9's operand rounding on the tensor cores (numerics only) -------------

U32 = 2.0 ** -24


def _tf32(x):
    """Round float32 to tf32 (10 stored mantissa bits) to nearest, ties
    away from zero, as K9's split does (`ssd_chunk.cu` `split`, the
    rounding of cvt.rna.tf32.f32): add half of the 13 dropped bits to
    the magnitude, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """tf32 by clearing the 13 low bits: how the tensor cores read an f32
    pattern, and K9's lo term."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, scheme):
    """a @ b in float32 with each operand rounded as the kernel's MMAs
    see it: "3xtf32" splits x into hi = tf32(x) and lo = x - hi truncated
    to tf32 and adds lo·hi, hi·lo and hi·hi (K9's products); "tf32" is
    hi·hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if scheme == "tf32":
        return ah @ bh
    al, bl = _tf32_truncated(a - ah), _tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _intra_chunk_emulated(xdt, a, Bm, Cm, chunk, scheme):
    """K9's function in its order: cumsum, C Bᵀ, P = (C Bᵀ) ⊙ D by a
    select, y = P xdt, S = (B ⊙ sd)ᵀ xdt, every product through `_mm`."""
    B, nh, L, hp = xdt.shape
    N, nc = Bm.shape[-1], L // chunk
    x = xdt.reshape(B, nh, nc, chunk, hp)
    cum = torch.cumsum(a.reshape(B, nh, nc, chunk), dim=-1)
    Bc = Bm.reshape(B, 1, nc, chunk, N)
    Cc = Cm.reshape(B, 1, nc, chunk, N)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    D = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                              float("-inf")))
    y = _mm(_mm(Cc, Bc.transpose(-1, -2), scheme) * D, x, scheme)
    sd = torch.exp(cum[..., -1:] - cum)
    S = _mm((Bc * sd[..., None]).transpose(-1, -2), x, scheme)
    return y.reshape(B, nh, L, hp), S


def _f64_bound(xdt, a, Bm, Cm, chunk):
    """The float64 evaluation and the per-element limits of
    `chip_smoke.py`'s `ssd_f64_oracle` (the bound `check_k9` holds K9 to
    on the card), copied: |y − y64| <= ((1 + (Q + N + 2)u)(1 + eps_D) − 1)
    ((|C||B|ᵀ ⊙ D) @ |xdt|), |S − S64| <= ((1 + (Q + 2)u)(1 + eps_D) − 1)
    ((|B| ⊙ sd)ᵀ @ |xdt|), eps_D = expm1(((2Q + 1)|cum_last| + 2)u)."""
    B, nh, L, hp = xdt.shape
    N, Q, nc = Bm.shape[-1], chunk, L // chunk
    x = xdt.double().reshape(B, nh, nc, Q, hp)
    cum = torch.cumsum(a.double().reshape(B, nh, nc, Q), dim=-1)
    Bc = Bm.double().reshape(B, 1, nc, Q, N)
    Cc = Cm.double().reshape(B, 1, nc, Q, N)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    D = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                              float("-inf")))
    sd = torch.exp(cum[..., -1:] - cum)
    y = torch.matmul(torch.matmul(Cc, Bc.transpose(-1, -2)) * D, x)
    S = torch.matmul((Bc * sd[..., None]).transpose(-1, -2), x)
    ymag = torch.matmul(torch.matmul(Cc.abs(), Bc.abs().transpose(-1, -2)) * D,
                        x.abs())
    Smag = torch.matmul((Bc.abs() * sd[..., None]).transpose(-1, -2), x.abs())
    eps_d = torch.expm1(((2 * Q + 1) * cum[..., -1].abs() + 2) * U32
                        )[..., None, None]
    y_lim = ((1 + (Q + N + 2) * U32) * (1 + eps_d) - 1) * ymag
    S_lim = ((1 + (Q + 2) * U32) * (1 + eps_d) - 1) * Smag
    return y.reshape(B, nh, L, hp), S, y_lim.reshape(B, nh, L, hp), S_lim


@pytest.mark.parametrize("scheme,fits", [("3xtf32", True), ("tf32", False)])
def test_tensor_core_operand_rounding_against_the_f64_bound(scheme, fits):
    """K9 runs its three products on the tensor cores as 3xTF32. With the
    operands rounded that way (and f32 sums), y and S stay within the
    float64 bound that `check_k9` holds the kernel to; with plain TF32
    (one term, ~2^-11 a product) they do not. The kernel itself is held
    on the card."""
    xdt, a, Bm, Cm = _t(*_kernel_inputs(*_mk(2, 1, 128, 2, 16, 32)))
    y, S = _intra_chunk_emulated(xdt, a, Bm, Cm, 64, scheme)
    y64, S64, y_lim, S_lim = _f64_bound(xdt, a, Bm, Cm, 64)
    worst = max(float(((y.double() - y64).abs() / y_lim).max()),
                float(((S.double() - S64).abs() / S_lim).max()))
    assert (worst <= 1.0) == fits, worst


def _states_list_and_stack(S, chunk_decay):
    """`inter_chunk_states` as it was: each entering state appended to a
    list, stacked at the end (the states held twice)."""
    B, nh, nc, N, hp = S.shape
    S_prev = torch.zeros((B, nh, N, hp), dtype=torch.float32)
    S_in = []
    for c in range(nc):
        S_in.append(S_prev)
        S_prev = S[:, :, c] + S_prev * chunk_decay[:, :, c, None, None]
    return torch.stack(S_in, 2), S_prev


def test_inter_chunk_states_into_one_buffer():
    """The entering states written into one (B, nh, nc, N, hp) buffer are
    bitwise the list-and-stack version's, and the loop's f32 values are
    the reference's `lax.scan` (`repro/kernels/ssd/ops.py`, the same
    step) at rtol 1e-5 / atol 1e-6: XLA fuses a step's product and sum
    into one FMA, which PyTorch on the CPU rounds twice (1-ulp drift a
    step, carried along the chain). Under `torch.func.vmap` the buffer
    takes the batch dim."""
    import jax
    rng = np.random.RandomState(23)
    B, nh, nc, N, hp = 2, 3, 9, 8, 4
    S = rng.randn(B, nh, nc, N, hp).astype(np.float32)
    decay = rng.rand(B, nh, nc).astype(np.float32)
    got_in, got_last = ops.inter_chunk_states(*_t(S, decay))
    want_in, want_last = _states_list_and_stack(*_t(S, decay))
    assert torch.equal(got_in, want_in) and torch.equal(got_last, want_last)

    def scan_step(S_prev, inp):                 # the reference's step
        S_c, dec = inp
        return S_c + S_prev * dec[..., None, None], S_prev
    j_last, j_in = jax.lax.scan(scan_step, jnp.zeros((B, nh, N, hp)),
                                (jnp.moveaxis(jnp.asarray(S), 2, 0),
                                 jnp.moveaxis(jnp.asarray(decay), 2, 0)))
    np.testing.assert_allclose(got_in.numpy(),
                               np.moveaxis(np.asarray(j_in), 0, 2),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(j_last),
                               rtol=1e-5, atol=1e-6)
    # two requests, the second's states halved: one vmap, each row its own
    S2, d2 = _t(np.stack([S, S * 0.5]), np.stack([decay, decay]))
    mapped_in, mapped_last = torch.func.vmap(ops.inter_chunk_states)(S2, d2)
    for r in range(2):
        want = ops.inter_chunk_states(S2[r], d2[r])
        assert torch.equal(mapped_in[r], want[0])
        assert torch.equal(mapped_last[r], want[1])
