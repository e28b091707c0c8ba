"""Optimizers over parameter trees (counterpart of
`repro/optim/optimizers.py`).

An Optimizer is an (init, update) pair over parameter trees:

    opt = adam(1e-3)
    state = opt.init(params)
    new_params, new_state = opt.update(params, grads, state)

States are trees of tensors; the step count is a 0-d int32 tensor on
the parameters' device. The tree Adam is plain PyTorch with the
reference's formula m·s1 / (sqrt(v·s2) + eps) — not `torch.optim.Adam`,
which rounds differently. `make_flat_optimizer` lifts Adam onto the
packed plane through the fused kernel K3 (`optim/fused_adam.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils.pytree import tree_flatten, tree_map, tree_norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]
    name: str = "optimizer"
    # hyperparameter record ({"kind": ..., ...}) so the packed-plane
    # fused Adam can rebuild the update; None for custom optimizers
    hyper: Any = None


def _step0(params):
    leaves = tree_flatten(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(params, grads, state):
        if momentum == 0.0:
            new_params = tree_map(lambda p, g: p - lr * g.to(p.dtype),
                                  params, grads)
            return new_params, {"step": state["step"] + 1}
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        new_params = tree_map(lambda p, m: p - lr * m.to(p.dtype), params, mu)
        return new_params, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update, name=f"sgd(lr={lr},mom={momentum})",
                     hyper={"kind": "sgd", "lr": lr, "momentum": momentum})


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0).

    state_dtype: dtype of the m/v moments (bfloat16 halves optimizer
    memory)."""

    def init(params):
        return {"step": _step0(params),
                "m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype),
                              params)}

    def update(params, grads, state):
        step = state["step"] + 1
        t = step.float()
        m = tree_map(lambda m_, g: (b1 * m_.float() + (1 - b1) * g.float()
                                    ).to(state_dtype), state["m"], grads)
        v = tree_map(lambda v_, g: (b2 * v_.float()
                                    + (1 - b2) * torch.square(g.float())
                                    ).to(state_dtype), state["v"], grads)
        mhat_scale = 1.0 / (1 - b1 ** t)
        vhat_scale = 1.0 / (1 - b2 ** t)

        def upd(p, m_, v_):
            # moments promote to f32 as in the reference (a bf16 moment
            # times the f32 scale is f32 there; torch would keep bf16)
            u = (m_.float() * mhat_scale) / (
                torch.sqrt(v_.float() * vhat_scale) + eps)
            if weight_decay > 0.0:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, name=f"adam(lr={lr})",
                     hyper={"kind": "adam", "lr": lr, "b1": b1, "b2": b2,
                            "eps": eps, "weight_decay": weight_decay,
                            "state_dtype": state_dtype})


def adamw(lr: float, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def make_flat_optimizer(opt: Optimizer, *, impl: str = "cuda") -> Optimizer:
    """Lift ``opt`` onto the packed parameter plane (flat (N,) params).

    Adam gets the single-pass fused update (K3, ``optim/fused_adam.py``);
    impl "cuda" launches the kernel on CUDA tensors (in place), "torch"
    runs its plain version. Any other optimizer is itself: a flat buffer
    is a valid one-leaf tree."""
    hyp = opt.hyper
    if not (isinstance(hyp, dict) and hyp.get("kind") == "adam"):
        return opt

    from repro_torch.optim.fused_adam import adam_flat_update

    state_dtype = hyp["state_dtype"]

    def init(flat_phi):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=flat_phi.device),
                "m": torch.zeros_like(flat_phi, dtype=state_dtype),
                "v": torch.zeros_like(flat_phi, dtype=state_dtype)}

    def update(flat_phi, flat_g, state):
        phi, m, v, step = adam_flat_update(
            flat_phi, flat_g, state["m"], state["v"], state["step"],
            lr=hyp["lr"], b1=hyp["b1"], b2=hyp["b2"], eps=hyp["eps"],
            wd=hyp["weight_decay"], state_dtype=state_dtype, impl=impl)
        return phi, {"step": step, "m": m, "v": v}

    return Optimizer(init, update, name=f"flat_{opt.name}[{impl}]",
                     hyper=hyp)


def clip_by_global_norm(grads, max_norm: float):
    norm = tree_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
