"""K1: the fused client-plane inner update θ ← θ − α∘g as a CUDA kernel
(`kernels/csrc/inner_update.cu`).

Counterpart of `repro/kernels/meta_update/fused.py`
`inner_update_plane` (the Pallas kernels `_inner_plane_scalar_call`
and `_inner_plane_vec_call`). θ and g are a ``(C, N)`` f32 client
plane; α is a python scalar (a kernel argument), a shared ``(N,)``
vector (read with stride 0 over C) or a per-client ``(C, N)`` block.

In place when no gradient is required — the reference's
``input_output_aliases={0: 0}`` — and out of place otherwise, through
an ``autograd.Function`` that carries the reference's VJP
(``fused.py:150-195``) in plain torch: dθ = ḡ, dα = −g∘ḡ reduced to α's
shape, dg = −α∘ḡ.

K4, `meta_update_flat` (the reference's `_meta_update_kernel`,
`fused.py:51-80`), is the same kernel with C = 1 and a shared ``(N,)``
α, out of place, with its own launch count. The reference calls it
nowhere (its `ops.meta_update` routes through K1); it ships for
completeness of the kernel set.

On a CPU tensor the wrappers run the plain version (`ref.py`); on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.meta_update import ref

launches = 0   # K1 launches; only `_launch` adds to it
meta_update_launches = 0   # K4 launches; only `meta_update_flat` adds to it


def _launch(theta, alpha, g, out):
    """θ − α∘g written into ``out`` (which may be θ itself)."""
    global launches
    if not theta.is_cuda:
        out.copy_(ref.inner_update_plane_ref(theta, alpha, g))
        return out
    if theta.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("the inner-update kernel takes float32 planes, got "
                        f"theta {theta.dtype}, g {g.dtype}")
    if isinstance(alpha, torch.Tensor):
        a, a_s = alpha.float().contiguous(), 0.0
    else:
        a, a_s = torch.empty(0), float(alpha)
    get_ext().inner_update(theta, out, a, a_s, g.contiguous())
    launches += 1
    return out


def _reduce_to_shape(x, shape):
    """Sum-reduce ``x`` down to ``shape`` (inverse of broadcasting)."""
    if tuple(x.shape) == tuple(shape):
        return x
    extra = x.ndim - len(shape)
    if extra:
        x = x.sum(dim=tuple(range(extra)))
    axes = tuple(i for i, d in enumerate(shape) if d == 1 and x.shape[i] != 1)
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x


class _InnerUpdatePlane(torch.autograd.Function):
    """Out-of-place kernel launch with the reference's VJP."""

    @staticmethod
    def forward(ctx, theta, alpha_t, g, alpha_s):
        ctx.alpha_s = alpha_s
        ctx.save_for_backward(alpha_t, g)
        out = torch.empty_like(theta, memory_format=torch.contiguous_format)
        return _launch(theta, alpha_s if alpha_t is None else alpha_t, g, out)

    @staticmethod
    def backward(ctx, ct):
        alpha, g = ctx.saved_tensors
        if alpha is None:
            return ct, None, -ctx.alpha_s * ct, None
        d_alpha = _reduce_to_shape(-g * ct, alpha.shape)
        return ct, d_alpha, -alpha * ct, None


def inner_update_plane(theta, alpha, g):
    """Fused θ ← θ − α∘g over a (C, N) client plane, differentiable.

    theta, g: (C, N); alpha: python scalar, (N,) or (C, N). Without a
    gradient to track, θ is updated in place and returned."""
    scalar = isinstance(alpha, (int, float))
    tensors = (theta, g) if scalar else (theta, g, alpha)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _InnerUpdatePlane.apply(theta, None if scalar else alpha, g,
                                       float(alpha) if scalar else 0.0)
    return _launch(theta, alpha, g, out=theta)


def meta_update_flat(theta, alpha, g):
    """K4: θ − α∘g on flat (N,) buffers, one client, a full (N,) α; a
    new tensor. θ must be float32 (a bf16 θ raises ``TypeError``, on
    every device). On the card: K1's kernel at C = 1 with α read as
    shared rates, 16 bytes an element (θ, α, g read, out written)."""
    global meta_update_launches
    if theta.dtype != torch.float32:
        raise TypeError(f"meta_update_flat takes a float32 theta, got "
                        f"{theta.dtype}")
    if theta.ndim != 1 or alpha.shape != theta.shape or \
            g.shape != theta.shape:
        raise ValueError("theta, alpha and g must be (N,) of one shape")
    if not theta.is_cuda:
        return ref.meta_update_flat_ref(theta, alpha, g)
    out = torch.empty_like(theta, memory_format=torch.contiguous_format)
    get_ext().inner_update(theta.contiguous()[None], out[None],
                           alpha.float().contiguous(), 0.0,
                           g.float().contiguous()[None])
    meta_update_launches += 1
    return out
