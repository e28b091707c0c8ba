"""Dispatchers for the fused meta-step ops: the inner update (K1), the
weighted aggregation (K2), the upload codecs (int8 encode K6, whose
dequantization folds into K2; top-k decode into K2) and the failure
plane's robust reductions (`robust_aggregate`: masked mean and screen on
K2, the trimmed mean on K5).

impl: "cuda" (default; the kernels for CUDA tensors, their plain
versions for CPU tensors) or "torch" (the plain version everywhere),
selected per call or scoped with `use_impl` — the port's counterpart of
the reference's xla/pallas switch (`repro/kernels/meta_update/ops.py:43-60`).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.meta_update import ref
from repro_torch.kernels.meta_update.aggregate import (masked_mean_flat,
                                                       masked_mean_ref,
                                                       row_liveness,
                                                       screened_aggregate_flat,
                                                       screened_aggregate_ref,
                                                       trimmed_mean_flat,
                                                       trimmed_mean_ref,
                                                       weighted_aggregate_flat)
from repro_torch.kernels.meta_update.compress import (int8_aggregate_flat,
                                                      int8_aggregate_ref,
                                                      int8_encode_flat,
                                                      int8_encode_ref,
                                                      topk_aggregate_flat,
                                                      topk_aggregate_ref)
from repro_torch.kernels.meta_update.fused import inner_update_plane
from repro_torch.sharding.dtensor import is_dtensor, local_call
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_unflatten

_IMPLS = ("torch", "cuda")
_DEFAULT_IMPL = "cuda"


@contextlib.contextmanager
def use_impl(impl: str):
    """Scoped default-impl override (restores on exit)."""
    global _DEFAULT_IMPL
    assert impl in _IMPLS, impl
    prev, _DEFAULT_IMPL = _DEFAULT_IMPL, impl
    try:
        yield
    finally:
        _DEFAULT_IMPL = prev


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
    leaves, treedef = tree_flatten(theta)
    if is_dtensor(leaves[0]):
        # a step on a mesh: each rank packs and updates its own shards
        # (the update is elementwise), every operand in θ's placements
        n = len(leaves)
        tree_alpha = not isinstance(alpha, (int, float))
        args = leaves + tree_flatten(grads)[0] + (
            tree_flatten(alpha)[0] if tree_alpha else [])
        pls = tuple(x.placements for x in leaves)

        def local(*xs):
            a = tree_unflatten(treedef, xs[2 * n:]) if tree_alpha else alpha
            return tuple(tree_flatten(meta_update(
                tree_unflatten(treedef, xs[:n]), a,
                tree_unflatten(treedef, xs[n:2 * n]), impl=impl))[0])

        return tree_unflatten(treedef, local_call(
            local, args, pls * (3 if tree_alpha else 2), pls))
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


def int8_encode(G, *, impl: str | None = None, inplace: bool = False):
    """(m, N) block -> (q int8, (m,) f32 scales, (m, N) f32 residual):
    per-row-scaled int8 quantization with the error-feedback residual.
    "torch" runs the plain version; "cuda" K6 (``inplace``: the residual
    may overwrite an f32 block the caller owns)."""
    impl = resolve_impl(impl)
    if impl == "torch":
        return int8_encode_ref(G)
    return int8_encode_flat(G, inplace=inplace)


def int8_aggregate(q, scales, w, *, impl: str | None = None):
    """Dequantize-and-aggregate Σ_u w_u·s_u·q_u -> (N,) f32 (K2 with the
    scale folded into the weight)."""
    impl = resolve_impl(impl)
    if impl == "torch":
        return int8_aggregate_ref(q, scales, w)
    return int8_aggregate_flat(q, scales, w)


def topk_aggregate(vals, idx, w, n: int, *, impl: str | None = None):
    """Decode-and-aggregate (m, k) top-k uploads -> (n,) f32 weighted
    sum. (Encoding is ``compress.topk_encode`` on every impl.)"""
    impl = resolve_impl(impl)
    if impl == "torch":
        return topk_aggregate_ref(vals, idx, w, n)
    return topk_aggregate_flat(vals, idx, w, n)


AGGREGATORS = ("mean", "masked_mean", "screen", "trimmed")


def robust_aggregate(gs, w, *, aggregator: str = "mean",
                     impl: str | None = None, screen_factor: float = 3.0,
                     trim: int = 1):
    """The failure plane's reduce of the (m, N) client block.

      mean         Σ w·g through K2, caller-normalized weights — the
                   plain round's reduce.
      masked_mean  Σ w·g / Σ w — renormalizes over arrived (w > 0) rows.
      screen       rejects non-finite and dropped rows, clips rows with
                   ‖g‖ > screen_factor × median(live ‖g‖), renormalizes.
      trimmed      coordinate-wise trimmed mean over the live rows
                   (arrived and finite), dropping the ``trim`` largest
                   and smallest values per coordinate, unweighted.

    "torch" runs the plain versions, the sort-based `trimmed_mean_ref`
    for the trimmed mean (the reference's xla route); "cuda" runs K2 and
    K5 on CUDA tensors, their plain versions on CPU tensors. Degenerate
    rounds (every row dead, or n_live ≤ 2·trim) may give a non-finite
    result, which the step's guard turns into a skipped round — except
    where the reference's own kernel gives a finite one (see
    `aggregate.trimmed_mean_plain`)."""
    impl = resolve_impl(impl)
    if aggregator == "mean":
        return weighted_aggregate(gs, w, impl=impl)
    if aggregator == "masked_mean":
        if impl == "torch":
            return masked_mean_ref(gs, w)
        return masked_mean_flat(gs, w)
    if aggregator == "screen":
        if impl == "torch":
            return screened_aggregate_ref(gs, w, factor=screen_factor)
        return screened_aggregate_flat(gs, w, factor=screen_factor)
    if aggregator == "trimmed":
        live = row_liveness(gs, w)
        if impl == "torch":
            return trimmed_mean_ref(gs, live, trim=trim)
        return trimmed_mean_flat(gs, live, trim=trim)
    raise ValueError(f"unknown aggregator {aggregator!r}; "
                     f"expected one of {AGGREGATORS}")
