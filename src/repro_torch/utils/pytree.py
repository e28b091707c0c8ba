"""Nested-container utilities for parameter trees (torch tensors).

Parameters are plain nested dicts, as in the reference. Leaf order is
the reference's `jax.tree.flatten` order — dict keys sorted at every
level, lists and tuples in position order, ``None`` holds no leaf — so
a flat plane packed here lines up element for element with one packed
by the JAX package.
"""
from __future__ import annotations

import math

import torch


def tree_flatten(tree):
    """-> (leaves, treedef). `treedef` is a hashable skeleton."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, len(t), tuple(walk(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return ("leaf",)

    treedef = walk(tree)
    # `walk` refers to itself through its closure cell, a cycle that
    # would keep `leaves` (and every leaf) alive until the garbage
    # collector runs; emptying the cell frees them with their last user
    del walk
    return leaves, treedef


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        out = [build(c) for c in d[2]]
        return out if kind == "list" else tuple(out)

    tree = build(treedef)
    del build            # the same cycle, through `it` (tree_flatten)
    return tree


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(x, *xs) for x, *xs in zip(leaves, *others)])


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_size(a) -> int:
    """Total number of elements across all leaves."""
    return sum(math.prod(x.shape) for x in tree_leaves(a))


def tree_bytes(a) -> int:
    """Total bytes across all leaves (honours per-leaf dtype)."""
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(a))


def tree_norm(a):
    """Global L2 norm of a tree, as a 0-d f32 tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(a)))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_any_nan(a):
    """0-d bool tensor: any non-finite value in a floating leaf."""
    flags = [torch.any(~torch.isfinite(x)) for x in tree_leaves(a)
             if x.is_floating_point()]
    if not flags:
        return torch.tensor(False)
    return torch.any(torch.stack(flags))


def tree_axpy(alpha, x, y):
    """y + alpha * x, leafwise."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)
