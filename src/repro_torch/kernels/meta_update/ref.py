"""Plain-PyTorch version of the fused inner update θ' = θ − α ∘ g.

Counterpart of `repro/kernels/meta_update/ref.py`. α is a python
scalar, a tensor broadcastable to θ, or (tree form) a tree matching θ.
The product and the difference are two eager ops, each rounded once —
the rounding the K1 kernel reproduces bit for bit on the card.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_map


def _f32(alpha):
    return alpha.float() if isinstance(alpha, torch.Tensor) else float(alpha)


def inner_update_plane_ref(theta, alpha, grads):
    """Flat version of the client-plane inner update: θ − α∘g over
    (C, N) (or (N,)) buffers with α a scalar, (N,), or (C, N)."""
    return (theta.float() - _f32(alpha) * grads.float()).to(theta.dtype)


def meta_update_ref(theta, alpha, grads):
    if isinstance(alpha, (int, float)):
        return tree_map(
            lambda p, g: (p.float() - float(alpha) * g.float()).to(p.dtype),
            theta, grads)
    return tree_map(
        lambda p, a, g: (p.float() - a.float() * g.float()).to(p.dtype),
        theta, alpha, grads)


def weighted_aggregate_ref(gs, w):
    """Plain version of K2: Σ_u w_u·gs[u] into (N,) f32, summed in the
    order u = 0..m-1 from zero, one rounded product and one rounded sum
    per row — the Pallas kernel's `fori_loop` order, which the CUDA
    kernel reproduces bit for bit. gs: (m, N) f32, bf16 or int8; w: (m,)
    weights, already normalized by the caller."""
    w = w.float()
    acc = torch.zeros(gs.shape[1:], dtype=torch.float32, device=gs.device)
    for u in range(gs.shape[0]):
        acc = acc + w[u] * gs[u].float()
    return acc
