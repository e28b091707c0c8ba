"""The packed parameter plane: θ as one padded flat f32 buffer.

Counterpart of `repro/utils/flat.py`. The layout is the reference's:
leaves in `jax.tree.flatten` order (`utils/pytree.py`), each leaf's
elements contiguous at its slot offset, and a zero tail up to
``n_padded``, a multiple of ``ALIGN = 8 * 128``. The alignment came
from the TPU's (8, 128) tile; the port keeps it so planes compare
element for element across the two packages, and so every row of a
``(C, N)`` plane starts 16-byte aligned for the inner-update kernel's
vector loads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.pytree import tree_flatten, tree_unflatten

ALIGN = 8 * 128          # kept from the reference's (sublane, lane) tile


def dtype_name(dtype: torch.dtype) -> str:
    """torch dtype -> the reference's dtype name ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def dtype_from_name(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the plane."""
    offset: int
    size: int
    shape: tuple
    dtype: str


@dataclasses.dataclass(frozen=True)
class FlatPlane:
    """Cached flattening spec for one parameter-tree structure.

    Shape-only and hashable; ``pack``/``unpack`` are the only methods
    that touch data."""
    treedef: Any
    slots: tuple          # tuple[LeafSlot, ...] in leaf order
    n_real: int
    n_padded: int

    @classmethod
    def from_tree(cls, tree, align: int = ALIGN) -> "FlatPlane":
        leaves, treedef = tree_flatten(tree)
        slots, off = [], 0
        for x in leaves:
            size = math.prod(x.shape) if len(x.shape) else 1
            slots.append(LeafSlot(off, size, tuple(x.shape),
                                  dtype_name(x.dtype)))
            off += size
        n_padded = off + ((-off) % align)
        return cls(treedef, tuple(slots), off, max(n_padded, align))

    # ---- data movement --------------------------------------------------
    def pack(self, tree, dtype=torch.float32):
        """tree -> (n_padded,) plane with a zero tail. One concatenate;
        its backward is one slice per leaf."""
        leaves = tree_flatten(tree)[0]
        assert len(leaves) == len(self.slots), \
            f"tree has {len(leaves)} leaves, plane expects {len(self.slots)}"
        parts = []
        for s, x in zip(self.slots, leaves):
            assert x.numel() == s.size, (tuple(x.shape), s)
            parts.append(x.reshape(-1).to(dtype))
        pad = self.n_padded - self.n_real
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def unpack(self, flat):
        """(n_padded,) plane -> tree with the original shapes and dtypes.
        One ``torch.split`` of the real region; float32 leaves are views
        of ``flat``, other dtypes are cast copies."""
        sizes = [s.size for s in self.slots]
        parts = torch.split(flat[:self.n_real], sizes)
        out = [p.view(s.shape).to(dtype_from_name(s.dtype))
               for s, p in zip(self.slots, parts)]
        return tree_unflatten(self.treedef, out)

    def unpack_rows(self, rows):
        """R (n_padded,) planes -> one tree with a leading (R,) axis on
        every leaf: ``unpack`` of each row (the same casts, so the same
        bits), written leaf by leaf into one buffer of the leaf's dtype,
        so no (R, n_padded) f32 stack is made."""
        rows = list(rows)
        out = []
        for s in self.slots:
            leaf = torch.empty((len(rows),) + tuple(s.shape),
                               dtype=dtype_from_name(s.dtype),
                               device=rows[0].device)
            for i, r in enumerate(rows):
                leaf[i].copy_(r[s.offset:s.offset + s.size].view(s.shape))
            out.append(leaf)
        return tree_unflatten(self.treedef, out)

    def pack_batch(self, tree, dtype=torch.float32):
        """tree with a leading batch axis on every leaf -> (B, n_padded)."""
        leaves = tree_flatten(tree)[0]
        B = leaves[0].shape[0]
        parts = [x.reshape(B, -1).to(dtype) for x in leaves]
        pad = self.n_padded - self.n_real
        if pad:
            parts.append(parts[0].new_zeros((B, pad)))
        return torch.cat(parts, dim=1)

    def zeros(self, device="cuda"):
        return torch.zeros((self.n_padded,), dtype=torch.float32,
                           device=device)

    def unpack_ad(self, flat):
        """``unpack`` whose backward writes every leaf's gradient straight
        into one zeroed f32 plane: a single (n_padded,) buffer per
        backward pass, with no concatenate and no padded copy on top.
        At full SmolLM-360M width one plane row is 1.45 GB, so this is
        what keeps the per-row gradient at one plane of transient memory."""
        return tree_unflatten(self.treedef, _UnpackAD.apply(self, flat))


class _UnpackAD(torch.autograd.Function):
    """Leaves out of a flat plane; the gradient goes back as one plane."""

    @staticmethod
    def forward(ctx, plane, flat):
        ctx.plane = plane
        ctx.device = flat.device
        leaves = tree_flatten(plane.unpack(flat))[0]
        # float32 leaves would alias `flat`; hand autograd fresh tensors
        return tuple(x.clone() if x.dtype == flat.dtype else x
                     for x in leaves)

    @staticmethod
    def backward(ctx, *cts):
        plane = ctx.plane
        flat_ct = torch.zeros((plane.n_padded,), dtype=torch.float32,
                              device=ctx.device)
        for s, ct in zip(plane.slots, cts):
            if ct is not None:
                flat_ct[s.offset:s.offset + s.size].copy_(ct.reshape(-1))
        return None, flat_ct


# ---- spec cache ---------------------------------------------------------
_PLANE_CACHE: dict = {}


def plane_for(tree, align: int = ALIGN) -> FlatPlane:
    """FlatPlane for ``tree``'s structure, memoized by (treedef, shapes,
    dtypes) so hot paths never recompute offsets."""
    leaves, treedef = tree_flatten(tree)
    key = (treedef, tuple((tuple(x.shape), dtype_name(x.dtype))
                          for x in leaves), align)
    plane = _PLANE_CACHE.get(key)
    if plane is None:
        plane = _PLANE_CACHE[key] = FlatPlane.from_tree(tree, align)
    return plane
