"""Sharding rules: parameter name -> partition spec. Counterpart of
`repro/sharding/rules.py`; the specs are the reference's, element for
element.

Strategy (the reference's baseline):
  - 2-D parameter sharding: the contract dim of every large matmul is
    FSDP-sharded over DATA (jointly over POD+DATA on a multi-pod mesh),
    the parallel dim (heads / d_ff / vocab / latents) over MODEL;
  - stacked-layer and stacked-expert leaves take the same rule
    right-aligned to their trailing dims; leading dims stay whole;
  - small leaves (norms, biases of the model width, scalars) replicate.

A spec is a `P`: one entry a tensor dim, each an axis name, a tuple of
axis names (one tensor dim split over several mesh dims, major first)
or None (the dim is whole). `placements` turns a spec into DTensor
placements on a `DeviceMesh`.

The functions read only a mesh's axis names and sizes (`mesh_sizes`),
so they take a `torch.distributed.device_mesh.DeviceMesh` or any object
with ``axis_names`` and ``devices.shape`` (a stand-in for a production
mesh that needs no devices).
"""
from __future__ import annotations

import math

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: ``P("data", None)``; ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> dict:
    """Axis name -> size, of a DeviceMesh or of a stand-in with
    ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def fsdp_axes(mesh) -> tuple:
    """FSDP shards over data (and pod when present)."""
    if POD_AXIS in mesh_sizes(mesh):
        return (POD_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def batch_axes(mesh) -> tuple:
    return fsdp_axes(mesh)


def _joined(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


# rule tables: leaf name -> right-aligned axis tuple
# "F" = the FSDP axes, "M" = the model axis
_COL_PARALLEL = {  # (d_in [F], d_out [M])
    "wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_gate", "w_up", "w_in",
    "lm_head", "mod_proj", "w_dq",
}
_ROW_PARALLEL = {"wo", "w_down", "w_out"}   # (d_in [M], d_out [F])
_VOCAB_MAJOR = {"embed"}                    # (vocab [M], d [F])
_MODEL_VEC = {"bq", "bk", "bv", "conv_b"}   # 1-d, beside an M-sharded dim
_HEAD_VEC = {"A_log", "D", "dt_bias"}       # per-SSM-head vectors


def _rule_for(name) -> tuple:
    if name in _COL_PARALLEL:
        return ("F", "M")
    if name in _ROW_PARALLEL or name in _VOCAB_MAJOR:
        return ("M", "F")
    if name in _MODEL_VEC or name in _HEAD_VEC:
        return ("M",)
    return ()


def _materialize(rule: tuple, shape, mesh) -> P:
    """The rule right-aligned to ``shape``; a dim that does not divide
    by its axes' size stays whole (the divisibility guard)."""
    F = fsdp_axes(mesh)
    sizes = mesh_sizes(mesh)
    rank = len(shape)
    axes: list = [None] * rank
    for i, a in enumerate(rule):
        dim = rank - len(rule) + i
        if dim < 0:
            continue
        if a == "F":
            if shape[dim] % math.prod(sizes[x] for x in F) == 0:
                axes[dim] = _joined(F)
        elif a == "M":
            if shape[dim] % sizes[MODEL_AXIS] == 0:
                axes[dim] = MODEL_AXIS
    return P(*axes)


def _map_named(fn, tree, name=None):
    """Map ``fn(name, leaf)`` over a tree of dicts, ``name`` the nearest
    dict key above the leaf (the reference's last ``DictKey``)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def param_pspecs(params, mesh, *, mode: str = "train"):
    """Spec tree matching ``params`` (leaf-name rules).

    mode="train": 2-D FSDP(data) + TP(model) sharding.
    mode="serve_tp": TP only, weights replicated over the data axis.
    A dim that does not divide by its target axes' size replicates (the
    15 heads of SmolLM on a 16-way model axis, odd vocabularies)."""
    if mode not in ("train", "serve_tp"):
        raise ValueError(f"unknown mode {mode!r}")

    def leaf_spec(name, leaf):
        rule = _rule_for(name)
        if mode == "serve_tp":
            rule = tuple(None if a == "F" else a for a in rule)
        return _materialize(rule, tuple(leaf.shape), mesh)

    return _map_named(leaf_spec, params)


def state_pspecs(state, params_spec, mesh):
    """Specs of the train state {phi: {theta[, alpha]}, opt: {...}}: φ's
    leaves mirror the parameter specs, the optimizer's moments mirror φ,
    the step count replicates."""
    phi_spec = {k: params_spec for k in state["phi"]}
    opt_spec = {k: P() if k == "step" else phi_spec for k in state["opt"]}
    return {"phi": phi_spec, "opt": opt_spec}


def batch_pspec(mesh, ndim: int, *, batch_dim: int = 0) -> P:
    """The batch dim over pod+data; everything else whole."""
    axes: list = [None] * ndim
    axes[batch_dim] = _joined(batch_axes(mesh))
    return P(*axes)


# unstacked rank of each decode-cache leaf (a leading n_reps axis on
# the leaves under "stack" adds one)
_CACHE_RANK = {"k": 4, "v": 4, "c": 3, "kpe": 3, "conv": 3, "state": 4,
               "enc_out": 3}
_CACHE_MODEL_DIM = {"k": 2, "v": 2, "conv": 2, "state": 1}


def cache_pspecs(cache, mesh, *, batch_sharded: bool = True,
                 seq_shard: bool = False):
    """Decode-cache specs: the batch dim over pod+data (when it
    divides), head or width dims over model. Layouts:
      k/v:     (B, C, Kv, hd)   -> (B_ax, None, model, None)
      c:       (B, C, R)        -> (B_ax, None, None)
      kpe:     (B, C, rope)     -> (B_ax, None, None)
      conv:    (B, W-1, conv_d) -> (B_ax, None, model)
      state:   (B, nh, hp, N)   -> (B_ax, model, None, None)
      enc_out: (B, T, d)        -> (B_ax, None, None)
    ``seq_shard`` splits the cache length over model instead of the kv
    heads (for k, v, c, kpe and enc_out)."""
    sizes = mesh_sizes(mesh)
    B_ax = batch_axes(mesh)
    bsz_div = math.prod(sizes[a] for a in B_ax)
    m_div = sizes[MODEL_AXIS]

    def spec(name, leaf):
        if name == "length":
            return P()
        shape = tuple(leaf.shape)
        rank = len(shape)
        stacked = rank > _CACHE_RANK.get(name, rank)
        axes: list = [None] * rank
        bdim = 1 if stacked else 0
        if batch_sharded and shape[bdim] % bsz_div == 0:
            axes[bdim] = _joined(B_ax)
        if seq_shard and name in ("k", "v", "c", "kpe", "enc_out"):
            if shape[bdim + 1] % m_div == 0:
                axes[bdim + 1] = MODEL_AXIS
            return P(*axes)
        mdim = _CACHE_MODEL_DIM.get(name)
        if mdim is not None:
            mdim += 1 if stacked else 0
            if shape[mdim] % m_div == 0:
                axes[mdim] = MODEL_AXIS
        return P(*axes)

    return _map_named(spec, cache)


def placements(spec, mesh) -> tuple:
    """A spec -> DTensor placements on ``mesh``, one a mesh dim: mesh
    dim ``a`` shards the tensor dim whose entry names ``a`` (alone or in
    a tuple), and replicates where no entry does. A tuple entry such as
    ("pod", "data") shards one tensor dim over both mesh dims, pod the
    major one, as the reference's tuple axis does."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                if name in owner:
                    raise ValueError(f"{spec}: axis {name!r} shards two dims")
                owner[name] = dim
    names = tuple(mesh_sizes(mesh))
    unknown = set(owner) - set(names)
    if unknown:
        raise ValueError(f"{spec}: the mesh has no axis {sorted(unknown)}")
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree (a `P` is a leaf
    there, though it is a tuple); leaves that are not tensors (a
    cache's ``length``) pass through."""
    if isinstance(specs, P):
        return fn(tree, specs) if hasattr(tree, "shape") else tree
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    return type(tree)(map_with_specs(fn, v, s) for v, s in zip(tree, specs))


def distribute(tree, specs, mesh):
    """Place every tensor of ``tree`` on ``mesh`` as a DTensor by its
    spec: each rank keeps its shard of the full tensor it holds, and a
    DTensor is redistributed to the spec."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(x, s):
        pl = placements(s, mesh)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl)
        return distribute_tensor(x, mesh, pl)

    return map_with_specs(place, tree, specs)
