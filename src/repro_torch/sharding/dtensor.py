"""DTensor helpers for model code that runs on plain tensors and on
DTensors placed by the specs (`rules.py`).

A plain tensor passes through every helper unchanged, so the meshless
path runs the same code with no cost beyond an isinstance check.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.sharding.rules import (DATA_AXIS, MODEL_AXIS, P, batch_axes,
                                        mesh_sizes, placements)
from repro_torch.utils.pytree import tree_flatten, tree_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, spec):
    """Redistribute a DTensor ``x`` to ``spec``'s placements on its own
    mesh (the counterpart of `with_sharding_constraint`); a plain tensor
    is returned as is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _batch_entry(mesh, batch: int):
    """The spec entry of a batch dim of ``batch`` rows: over pod+data
    where it splits evenly into shards of more than nothing, else over
    data alone (a multi-pod step runs one client group at a time, its
    rows over data), else None (whole; DTensor keeps no shard on a dim
    of size 1)."""
    sizes = mesh_sizes(mesh)
    for axes in (batch_axes(mesh), (DATA_AXIS,)):
        if batch > 1 and batch % math.prod(sizes[a] for a in axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def activation_spec(mesh, ndim: int, batch: int, *, seq_dim=None):
    """The residual stream's spec: the batch dim as `_batch_entry`
    splits it, the sequence over model when ``seq_dim`` is given, the
    rest whole."""
    spec = [_batch_entry(mesh, batch)] + [None] * (ndim - 1)
    if seq_dim is not None:
        spec[seq_dim] = MODEL_AXIS
    return P(*spec)


def hidden_layout(h):
    """An MLP's hidden activation (B, L, ff) on a mesh: the batch as
    `activation_spec` splits it, ff over model where it divides (the
    tensor-parallel layout; DTensor's own choice for the product that
    makes it can leave a strided shard its next matmul refuses). A
    plain tensor passes through."""
    if not is_dtensor(h):
        return h
    mesh = h.device_mesh
    m = MODEL_AXIS if h.shape[-1] % mesh_sizes(mesh)[MODEL_AXIS] == 0 \
        else None
    return constrain(h, P(_batch_entry(mesh, h.shape[0]),
                          *[None] * (h.ndim - 2), m))


def batch_layout(tree):
    """Every DTensor of ``tree`` with its batch (dim 0) over pod+data,
    or whole where the batch is one row: the layout a step's inputs
    take once a client's rows are sliced out of a placed batch. Plain
    tensors and None pass through."""
    return tree_map(lambda x: constrain(x, activation_spec(
        x.device_mesh, x.ndim, x.shape[0])) if is_dtensor(x) else x, tree)


def replicated(fn, *args):
    """Run ``fn`` on the full values of its DTensor arguments (each
    redistributed to Replicate, then taken as its local tensor) and
    return its tensor outputs as replicated DTensors: the route for a
    function whose ops DTensor has no sharding rule for. With no DTensor
    argument it is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in tree_flatten(list(args))[0]
                 if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim

    def full(a):
        return a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a

    out = fn(*tree_map(full, list(args)))
    return tree_map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


def summed_over_batch(mesh, b) -> tuple:
    """Gradient placements of an operand that every rank holds whole but
    applies to its own batch rows (batch entry ``b``, None when the batch
    is not split): Partial (each rank's share, summed) on the batch's
    mesh dims, Replicate on the others."""
    split = set(b if isinstance(b, tuple) else (b,)) - {None}
    return tuple(Partial() if n in split else Replicate()
                 for n in mesh_sizes(mesh))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a contiguous gradient: DTensor
    views a local gradient where eager PyTorch would reshape it, and a
    kernel's plain backward can return strided ones."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn, args, in_specs, out_specs, in_grad_specs=None):
    """Call ``fn`` — a hand-written kernel's wrapper, which takes plain
    tensors — on the local shards of DTensor arguments, through
    `torch.distributed.tensor.experimental.local_map`: each argument is
    redistributed to its entry of ``in_specs`` (a `P`, a tuple of
    placements, or None for a non-tensor argument) and ``fn``'s outputs
    are wrapped by ``out_specs`` (one spec, or a tuple of specs for a
    tuple of outputs). A tensor argument that is not a DTensor is taken
    as replicated. ``in_grad_specs`` (default: ``in_specs``) gives the
    placements of each argument's gradient (`summed_over_batch` for an
    operand held whole and applied to a batch shard). With no DTensor
    argument it is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    def pl(s):
        # one value's placements go to local_map as a list: a tuple
        # there means one entry per output
        if s is None:
            return None
        return list(placements(s, mesh) if isinstance(s, P) else s)

    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    single = isinstance(out_specs, P) or (
        len(out_specs) > 0 and not isinstance(out_specs[0], (P, tuple, list)))
    outs = pl(out_specs) if single else tuple(pl(s) for s in out_specs)
    ins = tuple(pl(s) for s in in_specs)
    grads = ins if in_grad_specs is None else tuple(
        pl(s) for s in in_grad_specs)

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))

    return local_map(local, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def kernel_axes(x, batch: int, heads: int | None = None, *,
                group: int = 1):
    """(batch entry, heads entry) of a kernel's local_map spec for a
    DTensor ``x``'s mesh: the batch as `activation_spec` splits it, the heads over model when ``heads`` and the ``group``
    heads sharing a kv head split evenly (so every rank's query heads
    find their kv heads on the same rank); else None (whole)."""
    mesh = x.device_mesh
    b = _batch_entry(mesh, batch)
    m = mesh_sizes(mesh)[MODEL_AXIS]
    h = MODEL_AXIS if heads is not None and heads % m == 0 and \
        (heads // group) % m == 0 else None
    return b, h


def reshape(x, *shape):
    """``x.reshape(*shape)``. A DTensor whose split dim DTensor cannot
    view as ``shape`` (heads or widths that do not divide by the model
    axis, such as a reduced config's 4 heads on a 16-way axis) is first
    gathered to the batch layout, then wholly replicated if that is not
    enough, as GSPMD reshards before such a reshape; its gradient comes
    back in the result's placements."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    try:
        y = x.reshape(*shape)
    except RuntimeError:
        try:
            y = constrain(x, activation_spec(x.device_mesh, x.ndim,
                                             x.shape[0])).reshape(*shape)
        except RuntimeError:
                    y = constrain(x, P()).reshape(*shape)
    # a same-placement redistribute: its backward brings the gradient to
    # y's placements, which the reshape's backward can view back
    return y.redistribute(y.device_mesh, y.placements)


def embedding(tokens, table):
    """``F.embedding(tokens, table)``. With DTensors the lookup runs on
    each rank's token rows against the whole table (gathered): DTensor's
    rule for a vocabulary-sharded table leaves a masked partial that
    its backward cannot meet; the table's gradient is then each rank's
    share, summed over the batch's mesh dims."""
    if not (is_dtensor(tokens) or is_dtensor(table)):
        return F.embedding(tokens, table)
    t = tokens if is_dtensor(tokens) else table
    b, _ = kernel_axes(t, tokens.shape[0])
    ts = P(b, *[None] * (tokens.ndim - 1))
    return local_call(F.embedding, (tokens, table), (ts, P(None, None)),
                      P(b, *[None] * tokens.ndim),
                      in_grad_specs=(ts, summed_over_batch(t.device_mesh,
                                                           b)))
