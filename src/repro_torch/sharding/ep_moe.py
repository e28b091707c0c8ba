"""Expert-parallel MoE with an explicit all-to-all. Counterpart of
`repro/sharding/ep_moe.py`.

The baseline (`models/moe.py`) is tensor-parallel: every rank holds a
slice of every expert. This variant shards the EXPERTS over the mesh's
"model" axis (E / model_size experts a rank):
  1. local top-k routing of the rank's own tokens (`moe.moe_route`: ties
     to the lower expert id, the capacity from the local token count,
     the reference's rank-0 clobber made deterministic),
  2. the capacity-bucketed dispatch (E, capacity, d),
  3. an all-to-all over the model axis's process group moves each
     expert's bucket to the rank that owns the expert: (E, C, d) ->
     (E / mp, mp · C, d), the senders' buckets side by side,
  4. the local experts at full d_ff as one batched matmul,
  5. the reverse all-to-all and the weighted combine (a token's entries
     added from zero in ascending expert order, as `moe_apply`).
Shared experts are added after, on the whole batch.

Collective cost: 2 all-to-alls of (tokens · k · d) bytes a layer over
the model axis, in place of the TP layer's all-reduces of the full
activation.
"""
from __future__ import annotations

import torch

from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_apply
from repro_torch.sharding.collectives import all_to_all
from repro_torch.sharding.dtensor import is_dtensor, kernel_axes, local_call
from repro_torch.sharding.rules import MODEL_AXIS, P, mesh_sizes

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _local_experts(w, E: int, E_loc: int, rank: int):
    """A rank's (E_loc, ...) expert slice: ``w`` as is when it holds
    E_loc experts, its slice when it holds all E."""
    if w.shape[0] == E_loc:
        return w
    if w.shape[0] == E:
        return w[rank * E_loc:(rank + 1) * E_loc]
    raise ValueError(f"expert weights of {w.shape[0]} experts: expected "
                     f"{E} or this rank's {E_loc}")


def _ep_local(x, w_router, experts, cfg, cf, group, mp: int):
    """One rank's layer on its own tokens x (B_l, L, d) and its own
    experts -> its tokens' routed output (B_l, L, d), no shared experts."""
    B_l, L, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    E_loc = E // mp
    T = B_l * L
    xt = x.reshape(T, d)
    r = moe_mod.moe_route({"w_router": w_router}, cfg, xt, cf)
    cap = r["capacity"]
    x_e = moe_mod._dispatch(xt, r["slot_src"], K, E, cap)
    if mp > 1:
        # chunk j (experts j·E_loc ..) goes to rank j; what arrives from
        # rank j is its bucket for this rank's experts
        recv = all_to_all(x_e, group).view(mp, E_loc, cap, d)
        x_e = recv.transpose(0, 1).reshape(E_loc, mp * cap, d)
    y_e = moe_mod._expert_ffn(experts, cfg, x_e)
    if mp > 1:
        send = y_e.view(E_loc, mp, cap, d).transpose(0, 1).contiguous()
        y_e = all_to_all(send, group)
    y = moe_mod._combine(y_e.reshape(E * cap, d), r["expert_ids"],
                         r["tok_slot"], r["gates"])
    return y.reshape(B_l, L, d).to(x.dtype)


def ep_moe_apply(params, cfg, x, mesh, *, capacity_factor=None):
    """Expert-parallel MoE layer on ``mesh`` (a DeviceMesh with a
    "model" axis). ``E % model_size`` must be 0.

    DTensor operands (a step on a mesh) enter through `local_map`: x
    with its batch over pod+data, the router whole, the experts'
    leading E dim over "model" (the reference's shard_map specs). Plain
    tensors are this rank's own: x its tokens, the expert weights its
    E / model_size experts (or all E, sliced to its own). Returns y
    (B, L, d); the aux loss is the caller's (the reference returns
    none on this path)."""
    E = cfg.num_experts
    mp = mesh_sizes(mesh)[MODEL_AXIS]
    if E % mp:
        raise ValueError(f"{cfg.name}: {E} experts do not split over a "
                         f"{mp}-way model axis")
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor
    group = mesh.get_group(MODEL_AXIS) if mp > 1 else None
    keys = [k for k in _EXPERT_KEYS if k in params]

    def local(x_, w_router, *ws):
        rank = mesh.get_local_rank(MODEL_AXIS) if mp > 1 else 0
        experts = {k: _local_experts(w, E, E // mp, rank)
                   for k, w in zip(keys, ws)}
        return _ep_local(x_, w_router, experts, cfg, cf, group, mp)

    args = (x, params["w_router"], *[params[k] for k in keys])
    if any(is_dtensor(a) for a in args):
        b, _ = kernel_axes(next(a for a in args if is_dtensor(a)),
                           x.shape[0])
        xs, es = P(b, None, None), P(MODEL_AXIS, None, None)
        y = local_call(local, args, (xs, P(None, None)) + (es,) * len(keys),
                       xs)
    else:
        y = local(*args)
    if cfg.num_shared_experts > 0:
        y = y + mlp_apply(params["shared"], x, cfg.mlp_act)
    return y
