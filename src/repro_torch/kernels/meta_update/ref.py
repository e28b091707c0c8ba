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
