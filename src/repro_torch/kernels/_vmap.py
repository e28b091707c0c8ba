"""The request axis of `torch.func.vmap` folded into a kernel's batch axis.

The reference serves a prompt-shape group as one program,
`jax.jit(jax.vmap(gen_one))`, and Pallas batches each `pallas_call`
over the mapped requests. The port's counterpart: K7, K8 and K9 sit in
``autograd.Function``s whose ``vmap`` rule calls `fold`, so a kernel
reached under `torch.func.vmap` over R requests launches once on R·B
batch rows, not once a request.

`fold` moves each operand's vmap dim to the front, expands an unbatched
operand to R, merges (R, B) into R·B, calls the function once and
splits each output back into (R, B, …) (out dim 0). A merge is a view
where the operand's strides allow it; where they do not (an expanded
operand, a vmap dim that is not outermost in memory), the merge copies,
and the bytes it copies are added to `copy_bytes`, which only `merge`
raises, so a run can report them. Non-tensor arguments (a Python-int
``kv_length``, a chunk size) pass through unchanged.

The kernels' wrappers take their plain versions for CPU tensors, so on
the CPU `fold` is reached only by calling it (the tests call it on the
plain versions) or by calling the Functions directly.
"""
from __future__ import annotations

import torch

copy_bytes = 0   # bytes copied by merges that could not be views


def merge(t, dim, R: int):
    """t with its vmap dim at ``dim`` (None: unbatched, expanded to R)
    -> (R·B, …): the vmap dim merged into the leading batch dim."""
    global copy_bytes
    t = t.expand(R, *t.shape) if dim is None else t.movedim(dim, 0)
    B = t.shape[1]
    out = t.reshape(R * B, *t.shape[2:])
    if R > 1 and B > 1 and t.stride(0) != t.stride(1) * B:
        copy_bytes += out.numel() * out.element_size()
    return out


def split(t, R: int):
    """(R·B, …) -> (R, B, …): always a view."""
    return t.unflatten(0, (R, t.shape[0] // R))


def fold(fn, R: int, args, in_dims):
    """``fn(*args)`` with the vmap dim of every tensor argument folded
    into its leading batch dim (``in_dims``: one entry per argument, an
    int or None), called once. Returns fn's output (a tensor or a tuple
    of tensors) with each tensor split back into (R, B, …)."""
    merged = [merge(a, d, R) if isinstance(a, torch.Tensor) else a
              for a, d in zip(args, in_dims)]
    out = fn(*merged)
    if isinstance(out, tuple):
        return tuple(split(o, R) for o in out)
    return split(out, R)
