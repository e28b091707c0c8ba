"""Dispatchers for the fused meta-step ops: the inner update (K1) and
the weighted aggregation (K2).

impl: "cuda" (default; the kernels for CUDA tensors, their plain
versions for CPU tensors) or "torch" (the plain version everywhere),
selected per call — the port's counterpart of the reference's
xla/pallas switch (`repro/kernels/meta_update/ops.py:43-60`).
The robust reductions (K5) and compression (K6) join with their slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.meta_update import ref
from repro_torch.kernels.meta_update.aggregate import weighted_aggregate_flat
from repro_torch.kernels.meta_update.fused import inner_update_plane
from repro_torch.utils.flat import plane_for

_IMPLS = ("torch", "cuda")
_DEFAULT_IMPL = "cuda"


def resolve_impl(impl: str | None) -> str:
    impl = impl or _DEFAULT_IMPL
    assert impl in _IMPLS, impl
    return impl


def meta_update(theta, alpha, grads, *, impl: str | None = None):
    """θ' = θ − α ∘ g on parameter trees; α is a scalar or a tree
    matching θ. The kernel route packs the trees onto the plane and runs
    K1 with its VJP, as the reference's pallas path does
    (`ops.py:63-77`)."""
    impl = resolve_impl(impl)
    if impl == "torch":
        return ref.meta_update_ref(theta, alpha, grads)
    plane = plane_for(theta)
    t = plane.pack(theta)
    a = alpha if isinstance(alpha, (int, float)) else plane.pack(alpha)
    out = inner_update(t, a, plane.pack(grads), impl=impl)
    return plane.unpack_ad(out) if out.requires_grad else plane.unpack(out)


def inner_update(theta, alpha, g, *, impl: str | None = None):
    """Fused inner update on flat client-plane buffers, differentiable.

    theta, g: (C, N) — or (N,), treated as a one-client plane. alpha:
    python scalar, 0-d tensor, (N,) shared rates, or a (C, N) block.
    "torch" returns a new tensor; the kernel route updates θ in place
    when no gradient is required (see `fused.inner_update_plane`)."""
    impl = resolve_impl(impl)
    if impl == "torch":
        return ref.inner_update_plane_ref(theta, alpha, g)
    if isinstance(alpha, torch.Tensor) and alpha.ndim == 0:
        # a 0-d rate runs as shared (N,) rates, as in the reference
        alpha = alpha.float().expand(theta.shape[-1]).contiguous()
    squeeze = theta.ndim == 1
    if squeeze:
        theta, g = theta[None], g[None]
        if isinstance(alpha, torch.Tensor) and alpha.ndim == 2:
            raise ValueError("2-D alpha with 1-D theta")
    out = inner_update_plane(theta, alpha, g)
    return out[0] if squeeze else out


def weighted_aggregate(gs, w, *, impl: str | None = None):
    """(m, N) packed client grads × (m,) weights -> (N,) Σ_u w_u·g_u."""
    impl = resolve_impl(impl)
    if impl == "torch":
        return ref.weighted_aggregate_ref(gs, w)
    return weighted_aggregate_flat(gs, w)
