"""Mixture-of-Experts FFN: top-k routing and capacity-based dispatch.
Counterpart of `repro/models/moe.py`.

Dispatch, as in the reference (Switch-style capacity; every shape and
the capacity depend only on (T, K, E, capacity_factor), never on the
data):
  1. f32 router logits of a product in x's dtype -> top-K experts (ties
     to the lower expert id, as `lax.top_k`) and softmax-renormalized
     gates, plus the Switch load-balance aux loss;
  2. the (token, k) entries, token-major, stable-sorted by expert; the
     rank within each expert; entries with rank >= capacity drop;
  3. gather kept entries into (E, capacity, d), run all experts as one
     batched matmul, combine back weighted by the gates.

Two behaviours of the reference are kept on purpose, deterministically:
- **The rank-0 clobber.** The reference writes its dispatch slots with
  a scatter in which every dropped entry also writes (token 0, mask 0)
  into slot e·capacity, its expert's first slot (`moe.py:92-95`);
  XLA applies the writes in order, so for an expert that overflows its
  capacity that slot ends empty and the expert's rank-0 token loses
  the expert's output. The port writes the kept entries (no index
  twice), then empties slot e·capacity of each overflowing expert.
- **The combine's order.** A token's kept contributions are added one
  by one in the sorted order (ascending expert id), from zero, in the
  experts' output dtype, each the gate cast to that dtype times the
  expert's output.

Determinism on the card: dispatch and combine are gathers whose indices
hit each real row at most once (a (token, k) entry feeds one slot, a
slot one entry; empty and dropped positions read an extra zero row), so
their backward scatter-adds add one value into each real row and the
MoE gradient has the same bits from run to run without
`torch.use_deterministic_algorithms`. A token's K entries meet in the
backward of an expand, a fixed-order sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Rng, dense_init, mlp_apply, mlp_init
from repro_torch.sharding.dtensor import replicated


def moe_init(rng: Rng, cfg, dtype):
    """Router (d, E), stacked expert weights (E, d, ff) / (E, ff, d) and
    the shared experts' MLP, drawn in the reference's order."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"w_router": dense_init(rng, d, E, dtype)}

    def stack(d_in, d_out):
        return torch.stack([dense_init(rng, d_in, d_out, dtype)
                            for _ in range(E)])

    if cfg.mlp_act == "swiglu":
        p["w_gate"] = stack(d, ff)
    p["w_up"] = stack(d, ff)
    p["w_down"] = stack(ff, d)
    if cfg.num_shared_experts > 0:
        p["shared"] = mlp_init(rng, d, ff * cfg.num_shared_experts,
                               cfg.mlp_act, dtype)
    return p


def _expert_ffn(params, cfg, x_e):
    """x_e: (E, C, d) -> (E, C, d): every expert as one batched matmul."""
    if cfg.mlp_act == "swiglu":
        h = (F.silu(torch.bmm(x_e, params["w_gate"]))
             * torch.bmm(x_e, params["w_up"]))
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(torch.bmm(x_e, params["w_up"])))
    elif cfg.mlp_act == "gelu":
        h = F.gelu(torch.bmm(x_e, params["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown act {cfg.mlp_act}")
    return torch.bmm(h, params["w_down"])


def capacity_of(T: int, K: int, E: int, cf: float) -> int:
    """Slots an expert takes: the reference's ``int(np.ceil(T * K / E *
    cf))``, evaluated in the same order in Python floats."""
    return int(math.ceil(T * K / E * cf))


def top_k_lower_ties(logits, K: int):
    """`jax.lax.top_k`: the K largest along the last axis, in descending
    order, equal values in ascending index order (a stable descending
    sort; `torch.topk` promises no tie order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def moe_route(params, cfg, xt, capacity_factor: float | None = None):
    """Routing of the (T, d) tokens `xt`: a dict with the gates and
    expert ids (T, K), the aux loss, the capacity, each expert's entry
    count, `keep` (T, K) (the entry holds a slot), `slot_src` (E·cap,)
    (the flat entry t·K + k a slot reads, T·K where it stays empty:
    unfilled, or emptied by the rank-0 clobber) and `tok_slot` (T, K)
    (an entry's slot, E·cap where it was dropped)."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    cf = (capacity_factor if capacity_factor is not None
          else cfg.capacity_factor)
    dev = xt.device

    logits = (xt @ params["w_router"]).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k_lower_ties(logits, K)        # (T, K)
    gates = torch.softmax(gate_vals, dim=-1)

    # Switch load-balance loss: E · Σ_e frac_top1(e) · mean_prob(e) · coef
    onehot = F.one_hot(expert_ids[:, 0], E).float()
    aux = E * torch.sum(onehot.mean(0) * probs.mean(0)) * cfg.router_aux_coef

    capacity = capacity_of(T, K, E, cf)
    flat_expert = expert_ids.reshape(-1)                       # (T*K,)
    sorted_expert, order = torch.sort(flat_expert, stable=True)
    # a fixed-size count (bincount's output size depends on the data);
    # integer adds, so the order the scatter adds in does not matter
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add(
        0, flat_expert, torch.ones_like(flat_expert))
    group_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=dev) - group_start[sorted_expert]
    keep_sorted = rank < capacity
    slot_sorted = sorted_expert * capacity + rank

    # dropped entries aim at one spare position past the slots, cut off
    # after the scatter (no host sync, no kept slot written twice).
    # Every write here is out of place, so the routing runs under
    # `torch.func.vmap` (the serving engine's batch of requests).
    slot_or_spare = torch.where(keep_sorted, slot_sorted,
                                torch.full_like(slot_sorted, E * capacity))
    slot_src = torch.full((E * capacity + 1,), T * K, dtype=torch.long,
                          device=dev).scatter(0, slot_or_spare, order)
    slot_src = slot_src[:-1].view(E, capacity)
    first = torch.where(counts > capacity,
                        torch.full_like(slot_src[:, 0], T * K),
                        slot_src[:, 0])
    slot_src = torch.cat([first[:, None], slot_src[:, 1:]], dim=1)

    # `order` is a permutation: each entry is written once
    tok_slot = torch.empty(T * K, dtype=torch.long, device=dev).scatter(
        0, order, slot_or_spare)
    keep = torch.empty(T * K, dtype=torch.bool, device=dev).scatter(
        0, order, keep_sorted)
    return {"gates": gates, "expert_ids": expert_ids, "aux": aux,
            "capacity": capacity, "counts": counts,
            "keep": keep.view(T, K), "slot_src": slot_src.reshape(-1),
            "tok_slot": tok_slot.view(T, K)}


def _with_zero_row(x):
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _dispatch(xt, slot_src, K: int, E: int, cap: int):
    """Slot s reads entry slot_src[s] of the (T·K, d) entries (row T·K
    is zero) -> (E, cap, d)."""
    T, d = xt.shape
    entries = _with_zero_row(xt[:, None, :].expand(T, K, d).reshape(T * K, d))
    return entries[slot_src].view(E, cap, d)


def _combine(y_e, expert_ids, tok_slot, gates):
    """Entry (t, k) reads slot tok_slot[t, k] of the (E·cap, d) expert
    outputs (row E·cap is zero); a token's entries are added in
    ascending expert order from zero -> (T, d)."""
    T, K = expert_ids.shape
    asc = torch.argsort(expert_ids, dim=1)
    slots = torch.gather(tok_slot, 1, asc)
    gates = torch.gather(gates, 1, asc).to(y_e.dtype)
    contrib = gates[:, :, None] * _with_zero_row(y_e)[slots]  # (T, K, d)
    y = torch.zeros((T, y_e.shape[1]), dtype=y_e.dtype, device=y_e.device)
    for k in range(K):
        y = y + contrib[:, k]
    return y


def moe_apply(params, cfg, x, *, capacity_factor: float | None = None):
    """x: (B, L, d) -> (y, aux_loss). On DTensors (a step on a mesh) the
    routing, the dispatch and the combine run on the whole token set
    (`sharding.dtensor.replicated`: DTensor has no rule for their sorts,
    bincount and index scatters), the expert matmuls on the placed
    weights."""
    B, L, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * L
    xt = x.reshape(T, d)
    r = replicated(lambda w, t: moe_route({"w_router": w}, cfg, t,
                                          capacity_factor),
                   params["w_router"], xt)
    cap = r["capacity"]
    x_e = replicated(lambda t, s: _dispatch(t, s, K, E, cap), xt,
                     r["slot_src"])
    y_e = _expert_ffn(params, cfg, x_e)
    y = replicated(lambda ye, *rt: _combine(ye.reshape(E * cap, d), *rt),
                   y_e, r["expert_ids"], r["tok_slot"],
                   r["gates"]).reshape(B, L, d)

    if cfg.num_shared_experts > 0:
        y = y + mlp_apply(params["shared"], x, cfg.mlp_act)
    return y.to(x.dtype), r["aux"]


def dropped_entries(route) -> int:
    """(token, expert) entries that found no slot: Σ_e max(count_e −
    capacity, 0)."""
    return int((~route["keep"]).sum())
