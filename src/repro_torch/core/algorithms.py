"""The paper's meta-learners (Algorithm 1), deployment side.

Counterpart of `repro/core/algorithms.py`. This slice ports what
serving runs: the algorithm classes with `init_state`, `make_algorithm`,
and the adaptation paths — `adapt` (tree), `adapt_packed` and
`adapt_packed_batch` (the flat (C, N) client plane, through the fused
inner-update kernel K1). The client-gradient training paths raise until
the training slice lands.

The reference's `jax.vmap(jax.grad(flat_loss))` over the C plane rows
is a loop over rows here, each taking its gradient with
`torch.autograd.grad` into one (C, N) f32 block G. That is exact
because row c only enters client c's loss. Then ONE K1 launch updates
the whole plane, outside any per-row code (`algorithms.py:80-86`): no
kernel ever runs under `torch.func.vmap`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.models.layers import Rng
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

_TRAINING_SLICE = ("is not ported yet; the client-gradient training paths "
                   "join the port with the training slice")


def _grad_tree(loss_fn, params, batch):
    """∇_params loss_fn(params, batch) as a tree (zeros for unused leaves)."""
    leaves, treedef = tree_flatten(params)
    req = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), batch)
        gs = torch.autograd.grad(loss, req, allow_unused=True)
    return tree_unflatten(treedef, [torch.zeros_like(x) if g is None else g
                                    for x, g in zip(req, gs)])


def _inner_adapt(loss_fn, theta, alpha, support, steps: int,
                 second_order: bool, impl=None):
    """k gradient steps on the support set, on the parameter tree."""
    if second_order:
        raise NotImplementedError("second-order inner loops " + _TRAINING_SLICE)
    for _ in range(steps):
        g = _grad_tree(loss_fn, theta, support)
        theta = mu_ops.meta_update(theta, alpha, g, impl=impl)
    return theta


# ---- client-plane (packed) inner loop -----------------------------------

def _flat_fn(fn, plane):
    """Lift ``fn(params_tree, batch)`` to a flat θ row (`unpack_ad`, so
    each backward pass writes one plane, not L)."""
    def flat(theta_flat, batch):
        return fn(plane.unpack_ad(theta_flat), batch)
    return flat


def _row(tree, c: int):
    return tree_map(lambda x: x[c], tree)


def _inner_adapt_plane(loss_fn, tplane, Theta, alpha, support, steps: int,
                       second_order: bool, impl):
    """k fused gradient steps for a chunk of clients in lockstep.

    Theta: (C, N) f32 client plane, updated in place by the kernel route;
    support leaves carry a leading C axis. alpha: python scalar, shared
    (N,), or per-client (C, N) flat rates."""
    if second_order:
        raise NotImplementedError("second-order inner loops " + _TRAINING_SLICE)
    flat_loss = _flat_fn(loss_fn, tplane)
    G = torch.empty_like(Theta)
    for _ in range(steps):
        for c in range(Theta.shape[0]):
            row = Theta[c].detach().requires_grad_(True)
            with torch.enable_grad():
                loss = flat_loss(row, _row(support, c))
                (g,) = torch.autograd.grad(loss, row)
            G[c].copy_(g)
            del g, loss, row
        with torch.no_grad():
            Theta = mu_ops.inner_update(Theta, alpha, G, impl=impl)
    return Theta


def _chunk_len(tree):
    return tree_flatten(tree)[0][0].shape[0]


@dataclasses.dataclass
class MetaAlgorithm:
    """Common interface; see the factory classes below."""
    name: str
    loss_fn: Callable                     # (params, batch) -> scalar
    eval_fn: Callable                     # (params, batch) -> (loss, metrics)
    inner_lr: float
    inner_steps: int = 1

    # ---- subclass hooks -------------------------------------------------
    def init_state(self, key, model_init: Callable):
        raise NotImplementedError

    def client_grad(self, phi, support, query):
        raise NotImplementedError("client_grad " + _TRAINING_SLICE)

    def client_grad_chunk_packed(self, pplane, tplane, phi, support, query,
                                 *, impl=None):
        raise NotImplementedError("client_grad_chunk_packed " + _TRAINING_SLICE)

    def adapt(self, phi, support, steps: int | None = None):
        """Deployment: adapt θ to a new client's support set (tree path)."""
        alpha = phi.get("alpha", self.inner_lr)
        return _inner_adapt(self.loss_fn, phi["theta"], alpha, support,
                            steps or self.inner_steps, second_order=False)

    def adapt_packed(self, phi, support, steps: int | None = None, *,
                     impl=None, plane=None):
        """Deployment on the packed plane: same math as ``adapt``, with
        the inner loop fused over flat θ. Returns the adapted θ tree."""
        tplane = plane or plane_for(phi["theta"])
        sup = tree_map(lambda x: x[None], support)
        Theta = self.adapt_packed_batch(phi, sup, steps, impl=impl,
                                        plane=tplane)
        return tplane.unpack(Theta[0])

    def adapt_packed_batch(self, phi, supports, steps: int | None = None, *,
                           impl=None, plane=None):
        """Deployment at serving scale: C clients adapt in lockstep on
        the flat (C, N) plane through the same fused inner-update kernel
        that training uses. ``supports`` leaves carry a leading C axis.
        Rows are independent, so each adapted row equals that client's
        solo ``adapt_packed`` bit for bit. Returns the (C, n_padded)
        plane; rows unpack via ``plane_for(phi["theta"])``."""
        tplane = plane or plane_for(phi["theta"])
        C = _chunk_len(supports)
        with torch.no_grad():
            Theta = tplane.pack(phi["theta"]).expand(C, -1).contiguous()
            alpha = phi.get("alpha")
            alpha = self.inner_lr if alpha is None else tplane.pack(alpha)
        return _inner_adapt_plane(self.loss_fn, tplane, Theta, alpha,
                                  supports, steps or self.inner_steps,
                                  second_order=False, impl=impl)


class MAML(MetaAlgorithm):
    def __init__(self, loss_fn, eval_fn, inner_lr, inner_steps=1, order=2,
                 name=None):
        super().__init__(name or ("maml" if order == 2 else "fomaml"),
                         loss_fn, eval_fn, inner_lr, inner_steps)
        assert order in (1, 2)
        self.order = order

    def init_state(self, key, model_init):
        return {"theta": model_init(key)}


def FOMAML(loss_fn, eval_fn, inner_lr, inner_steps=1):
    return MAML(loss_fn, eval_fn, inner_lr, inner_steps, order=1)


class MetaSGD(MetaAlgorithm):
    def __init__(self, loss_fn, eval_fn, inner_lr, inner_steps=1, order=2):
        super().__init__("meta-sgd" if order == 2 else "meta-sgd-fo",
                         loss_fn, eval_fn, inner_lr, inner_steps)
        self.order = order

    def init_state(self, key, model_init):
        """θ from ``model_init(seed)``; α around inner_lr with a small
        uniform spread (paper [12]), drawn from a generator split off
        ``key`` on θ's device."""
        split = Rng(key, device="cpu")
        theta = model_init(split.next_seed())
        device = tree_flatten(theta)[0][0].device
        gen = Rng(split.next_seed(), device=device)
        alpha = tree_map(
            lambda p: self.inner_lr * (0.5 + torch.rand(
                p.shape, dtype=torch.float32, device=device,
                generator=gen.next())),
            theta)
        return {"theta": theta, "alpha": alpha}


class Reptile(MetaAlgorithm):
    """Beyond-paper extra: first-order, no support/query split needed."""

    def __init__(self, loss_fn, eval_fn, inner_lr, inner_steps=3):
        super().__init__("reptile", loss_fn, eval_fn, inner_lr, inner_steps)

    def init_state(self, key, model_init):
        return {"theta": model_init(key)}


def make_algorithm(name: str, loss_fn, eval_fn, inner_lr: float,
                   inner_steps: int = 1) -> MetaAlgorithm:
    name = name.lower()
    if name == "maml":
        return MAML(loss_fn, eval_fn, inner_lr, inner_steps, order=2)
    if name == "fomaml":
        return MAML(loss_fn, eval_fn, inner_lr, inner_steps, order=1)
    if name in ("meta-sgd", "metasgd"):
        return MetaSGD(loss_fn, eval_fn, inner_lr, inner_steps, order=2)
    if name in ("meta-sgd-fo", "metasgd-fo"):
        return MetaSGD(loss_fn, eval_fn, inner_lr, inner_steps, order=1)
    if name == "reptile":
        return Reptile(loss_fn, eval_fn, inner_lr, inner_steps)
    raise ValueError(f"unknown algorithm {name!r}")
