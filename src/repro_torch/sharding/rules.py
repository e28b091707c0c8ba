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


def map_with_specs(fn, tree, specs, *rest):
    """``fn(leaf, spec, *rest_leaves)`` over a tree, its spec tree (a
    `P` is a leaf there, though it is a tuple) and trees laid out as
    ``tree``; leaves that are not tensors (a cache's ``length``) pass
    through."""
    if isinstance(specs, P):
        return fn(tree, specs, *rest) if hasattr(tree, "shape") else tree
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k], *(r[k] for r in rest))
                for k, v in tree.items()}
    return type(tree)(map_with_specs(fn, v, s, *rs)
                      for v, s, *rs in zip(tree, specs, *rest))


def _leaves_with_specs(tree, specs, path=()):
    """(path, leaf, spec) for each tensor of ``tree``, as
    `map_with_specs` pairs them."""
    if isinstance(specs, P):
        if hasattr(tree, "shape"):
            yield path, tree, specs
        return
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    for k, v in items:
        yield from _leaves_with_specs(v, specs[k], path + (k,))


def check_placeable(tree, specs, mesh, *, prefix=()):
    """Raise ValueError where a spec cuts a dim unevenly: a leaf's dim
    must divide by the product of the mesh axes its spec puts on it.
    JAX refuses such a placement (`device_put` or `jit` with a
    NamedSharding: "the global size of its dimension d should be
    divisible by n"), where DTensor would cut it unevenly and run a
    program the reference cannot. ``tree`` may hold meta tensors."""
    sizes = mesh_sizes(mesh)
    for path, leaf, spec in _leaves_with_specs(tree, specs, tuple(prefix)):
        for dim, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            div = math.prod(sizes[n] for n in names if n is not None)
            if leaf.shape[dim] % div:
                where = "".join(f"[{k!r}]" for k in path)
                raise ValueError(
                    f"{where}: spec {spec} puts {entry!r} ({div} ways) on "
                    f"dim {dim}, whose size {leaf.shape[dim]} does not "
                    f"divide by {div} (shape {tuple(leaf.shape)})")


def distribute(tree, specs, mesh):
    """Place every tensor of ``tree`` on ``mesh`` as a DTensor by its
    spec: each rank keeps its shard of the full tensor it holds, and a
    DTensor is redistributed to the spec. A spec that cuts a dim
    unevenly raises first (`check_placeable`)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    check_placeable(tree, specs, mesh)

    def place(x, s):
        pl = placements(s, mesh)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl)
        return distribute_tensor(x, mesh, pl)

    return map_with_specs(place, tree, specs)


# ------------------------------------------------- shard-only placement
#
# The launchers on a mesh make each rank's shards only: the state's
# shapes come from the meta device, and each rank cuts what it draws to
# its own shard (`distribute_tensor` with ``src_data_rank=None`` splits
# locally, as `distribute` splits rank 0's copy before it scatters). No
# collective runs, and the whole state is never live on one rank.

def local_shard(x, pl, mesh):
    """This rank's shard of ``x``, a whole tensor that every rank holds
    the same, as a plain tensor: a copy, so it keeps none of the rest
    of ``x`` alive."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, pl,
                             src_data_rank=None).to_local().clone()


def cut(x, pl, mesh):
    """`local_shard` of ``x`` as a DTensor of ``x``'s shape."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(x, pl, mesh), mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def shard_like(ref, x):
    """``x`` placed as ``ref``: ``x`` itself beside a plain tensor, else
    `cut` to ref's mesh and placements."""
    from torch.distributed.tensor import DTensor
    if not isinstance(ref, DTensor):
        return x
    return cut(x, ref.placements, ref.device_mesh)


def place_local(tree, specs, mesh):
    """`distribute` for a tree that every rank holds the same, with no
    collective: a plain tensor is `cut` to its spec; a DTensor must
    already have its spec's placements. A spec that cuts a dim unevenly
    raises first (`check_placeable`)."""
    from torch.distributed.tensor import DTensor
    check_placeable(tree, specs, mesh)

    def place(x, s):
        pl = placements(s, mesh)
        if isinstance(x, DTensor):
            if tuple(x.placements) != pl:
                raise ValueError(f"placed {x.placements}, spec {s}")
            return x
        return cut(x, pl, mesh)

    return map_with_specs(place, tree, specs)


def zeros_placed(shapes, specs, mesh):
    """A tree of zeros laid out as ``shapes`` (meta tensors), as
    DTensors by ``specs``: each rank makes its shard only. A spec that
    cuts a dim unevenly raises first (`check_placeable`)."""
    from torch.distributed.tensor import zeros
    check_placeable(shapes, specs, mesh)
    return map_with_specs(
        lambda m, s: zeros(m.shape, dtype=m.dtype, device_mesh=mesh,
                           placements=placements(s, mesh)), shapes, specs)


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def materialize_units(units, specs, mesh):
    """This rank's shards, as DTensors placed by ``specs``, of a tree
    that is drawn one unit at a time (`models.lm.init_units`). Each
    unit's leaves are cut to the rank's shard before the next unit is
    drawn, so the rank holds its shards and one unit at a time. A unit
    with ``rep`` (r, n) is repetition r of leaves stacked on a leading
    axis, which stays whole: its shard is row r of the stacked shard.
    A spec that cuts a dim unevenly raises before the unit is placed
    (`check_placeable`, on the stacked shape for a repetition)."""
    from torch.distributed.tensor import Shard, empty
    out = {}
    for path, unit, rep in units:
        sub_specs = get_path(specs, path)
        if rep is None:
            check_placeable(unit, sub_specs, mesh, prefix=path)
            set_path(out, path, map_with_specs(
                lambda x, s: cut(x, placements(s, mesh), mesh),
                unit, sub_specs))
            continue
        r, n = rep

        def fill(x, s, buf=None):
            pl = placements(s, mesh)
            if buf is None:
                buf = empty((n, *x.shape), dtype=x.dtype, device_mesh=mesh,
                            placements=pl)
            # the repetition's leaf: the stacked placements one dim down
            row = [Shard(p.dim - 1) if isinstance(p, Shard) else p
                   for p in pl]
            buf.to_local()[r].copy_(local_shard(x, row, mesh))
            return buf

        if r == 0:
            check_placeable(map_with_specs(
                lambda x, s: x.new_empty((n, *x.shape), device="meta"),
                unit, sub_specs), sub_specs, mesh, prefix=path)
            set_path(out, path, map_with_specs(fill, unit, sub_specs))
        else:
            map_with_specs(fill, unit, sub_specs, get_path(out, path))
        del unit
    return out
