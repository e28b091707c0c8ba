"""The paper's meta-learners (Algorithm 1): client training and
deployment. Counterpart of `repro/core/algorithms.py`.

  MAML      φ = {theta};        θ_u = θ − α∇L_S(θ); g = ∇_θ L_Q(θ_u)
            (order 2 differentiates through the inner update)
  FOMAML    same, g = ∇_{θ_u} L_Q(θ_u)
  Meta-SGD  φ = {theta, alpha}; θ_u = θ − α∘∇L_S(θ); g = ∇_{(θ,α)} L_Q(θ_u)
  Reptile   φ = {theta};        k SGD steps, then g = θ − θ_k

Two executions of the inner loop, as in the reference:

- tree (`_inner_adapt`, `client_grad`, `adapt`): θ stays a tree;
- client plane (`_inner_adapt_plane`, `client_grad_chunk_packed`,
  `adapt_packed_batch`): a chunk of C clients adapts in lockstep on a
  flat (C, N) f32 plane, one K1 launch per inner step for the chunk.

The reference's `jax.vmap(jax.grad(...))` over the plane rows is a loop
over rows here, each taking its gradient with `torch.autograd.grad`.
That is exact because row c only enters client c's loss; no kernel ever
runs under `torch.func.vmap`. For the second-order algorithms the row
gradients are taken with ``create_graph=True`` and stacked, so the
block G stays in the graph and K1's VJP (dg = −α∘ḡ) reaches it. For the
first-order ones G is detached and written row by row into one
buffer. K1 updates the plane in place when no gradient is tracked, so
a plane that is needed afterwards (Reptile's θ_0) is cloned first.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.models.layers import Rng
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten


def _grads(loss, xs, create_graph=False):
    """∂loss/∂x for each x, zeros for the ones loss does not reach."""
    gs = torch.autograd.grad(loss, xs, create_graph=create_graph,
                             allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]


def _detached_leaves(tree):
    leaves, treedef = tree_flatten(tree)
    return [x.detach().requires_grad_(True) for x in leaves], treedef


def _grad_tree(loss_fn, params, batch):
    """∇_params loss_fn(params, batch) as a detached tree."""
    req, treedef = _detached_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, req), batch)
        gs = _grads(loss, req)
    return tree_unflatten(treedef, gs)


def _inner_adapt(loss_fn, theta, alpha, support, steps: int,
                 second_order: bool, impl=None):
    """k gradient steps on the support set. With ``second_order`` the
    step's gradient stays in the graph (θ's leaves must require grad);
    otherwise it is detached, the reference's stop_gradient."""
    for _ in range(steps):
        if second_order:
            leaves, treedef = tree_flatten(theta)
            with torch.enable_grad():
                g = tree_unflatten(treedef, _grads(
                    loss_fn(theta, support), leaves, create_graph=True))
        else:
            g = _grad_tree(loss_fn, theta, support)
        theta = mu_ops.meta_update(theta, alpha, g, impl=impl)
    return theta


def _value_and_grad(fn, params, batch):
    """((loss, metrics), ∇_params loss) of fn(params, batch) -> (loss,
    metrics), all detached."""
    req, treedef = _detached_leaves(params)
    with torch.enable_grad():
        loss, met = fn(tree_unflatten(treedef, req), batch)
        gs = _grads(loss, req)
    return (loss.detach(), _detach(met)), tree_unflatten(treedef, gs)


def _detach(tree):
    return tree_map(lambda x: x.detach(), tree)


# ---- client-plane (packed) inner loop -----------------------------------

def _flat_fn(fn, plane):
    """Lift ``fn(params_tree, batch)`` to a flat θ row (`unpack_ad`, so
    each backward pass writes one plane, not L)."""
    def flat(theta_flat, batch):
        return fn(plane.unpack_ad(theta_flat), batch)
    return flat


def _row(tree, c: int):
    return tree_map(lambda x: x[c], tree)


def _chunk_len(tree):
    return tree_flatten(tree)[0][0].shape[0]


def _inner_adapt_plane(loss_fn, tplane, Theta, alpha, support, steps: int,
                       second_order: bool, impl):
    """k fused gradient steps for a chunk of clients in lockstep.

    Theta: (C, N) f32 client plane — updated in place by K1 when no
    gradient is tracked; support leaves carry a leading C axis. alpha:
    python scalar, shared (N,), or per-client (C, N) flat rates."""
    flat_loss = _flat_fn(loss_fn, tplane)
    C = Theta.shape[0]
    if not second_order:
        G = torch.empty(Theta.shape, dtype=Theta.dtype, device=Theta.device)
    for _ in range(steps):
        if second_order:
            rows = []
            with torch.enable_grad():
                for c in range(C):
                    row = Theta[c]
                    (g,) = torch.autograd.grad(
                        flat_loss(row, _row(support, c)), row,
                        create_graph=True)
                    rows.append(g)
            G = torch.stack(rows)
            del rows
        else:
            for c in range(C):
                row = Theta[c].detach().requires_grad_(True)
                with torch.enable_grad():
                    (g,) = torch.autograd.grad(
                        flat_loss(row, _row(support, c)), row)
                G[c].copy_(g)
                del g, row
        Theta = mu_ops.inner_update(Theta, alpha, G, impl=impl)
    return Theta


def _plane_rows(tplane, theta, C):
    """θ packed and copied into a fresh (C, N) plane (K1 may write it)."""
    with torch.no_grad():
        return tplane.pack(theta).expand(C, -1).contiguous()


def _eval_rows(flat_eval, Theta, query):
    """Per-row (losses (C,), metrics with leading C) of the flat eval."""
    losses, mets = [], []
    for c in range(Theta.shape[0]):
        loss, met = flat_eval(Theta[c], _row(query, c))
        losses.append(loss)
        mets.append(met)
    return torch.stack(losses), _stack_metrics(mets)


def _stack_metrics(mets):
    return {k: torch.stack([m[k].detach() for m in mets]) for k in mets[0]}


def _eval_grad_rows(flat_eval, Theta, query):
    """First-order meta-gradients: per row, the gradient of the query
    loss at the adapted row. -> (G (C, N), losses (C,), metrics)."""
    C = Theta.shape[0]
    G = torch.empty(Theta.shape, dtype=torch.float32, device=Theta.device)
    losses, mets = [], []
    for c in range(C):
        row = Theta[c].detach().requires_grad_(True)
        with torch.enable_grad():
            loss, met = flat_eval(row, _row(query, c))
            (g,) = torch.autograd.grad(loss, row)
        G[c].copy_(g)
        losses.append(loss.detach())
        mets.append(met)
        del g, row
    return G, torch.stack(losses), _stack_metrics(mets)


def _assemble_phi_rows(pplane, tplane, parts: dict):
    """Per-part flat (C, tplane.n_padded) grads -> (C, pplane.n_padded)
    rows in φ-plane layout: the sorted-key concatenation of each part's
    real region, plus the alignment pad."""
    assert pplane.n_real == len(parts) * tplane.n_real, \
        (pplane.n_real, tplane.n_real, sorted(parts))
    body = torch.cat([parts[k][..., :tplane.n_real] for k in sorted(parts)],
                     dim=-1)
    pad = pplane.n_padded - body.shape[-1]
    if pad:
        body = torch.cat([body, body.new_zeros(body.shape[:-1] + (pad,))],
                         dim=-1)
    return body


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
        """ModelTraining on one client: (g_u matching φ, metrics)."""
        raise NotImplementedError

    def client_grad_chunk_packed(self, pplane, tplane, phi, support, query,
                                 *, impl=None):
        """ModelTraining for a chunk of C clients on the flat client
        plane: support/query leaves carry a leading C axis; returns
        (G: (C, pplane.n_padded) f32 rows matching the φ plane, metrics
        with leading C)."""
        raise NotImplementedError

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
        Theta = _plane_rows(tplane, phi["theta"], _chunk_len(supports))
        with torch.no_grad():
            alpha = phi.get("alpha")
            alpha = self.inner_lr if alpha is None else tplane.pack(alpha)
        return _inner_adapt_plane(self.loss_fn, tplane, Theta, alpha,
                                  supports, steps or self.inner_steps,
                                  second_order=False, impl=impl)

    def query_metrics(self, phi, support, query):
        theta_u = self.adapt(phi, support)
        with torch.no_grad():
            loss, m = self.eval_fn(theta_u, query)
        return {"query_loss": loss, **m}


class MAML(MetaAlgorithm):
    def __init__(self, loss_fn, eval_fn, inner_lr, inner_steps=1, order=2,
                 name=None):
        super().__init__(name or ("maml" if order == 2 else "fomaml"),
                         loss_fn, eval_fn, inner_lr, inner_steps)
        assert order in (1, 2)
        self.order = order

    def init_state(self, key, model_init):
        return {"theta": model_init(key)}

    def client_grad(self, phi, support, query):
        if self.order == 2:
            req, treedef = _detached_leaves(phi["theta"])
            with torch.enable_grad():
                theta_u = _inner_adapt(self.loss_fn,
                                       tree_unflatten(treedef, req),
                                       self.inner_lr, support,
                                       self.inner_steps, second_order=True)
                loss, metrics = self.eval_fn(theta_u, query)
                g = tree_unflatten(treedef, _grads(loss, req))
            loss, metrics = loss.detach(), _detach(metrics)
        else:
            # FOMAML: gradient at the adapted parameters
            theta_u = _inner_adapt(self.loss_fn, phi["theta"], self.inner_lr,
                                   support, self.inner_steps,
                                   second_order=False)
            (loss, metrics), g = _value_and_grad(self.eval_fn, theta_u,
                                                 query)
        return {"theta": g}, {"query_loss": loss, **metrics}

    def client_grad_chunk_packed(self, pplane, tplane, phi, support, query,
                                 *, impl=None):
        # φ = {"theta"}: the φ plane IS the θ plane (same leaves, order)
        assert pplane.n_padded == tplane.n_padded, \
            (pplane.n_padded, tplane.n_padded)
        Theta0 = _plane_rows(tplane, phi["theta"], _chunk_len(support))
        flat_eval = _flat_fn(self.eval_fn, tplane)
        if self.order == 2:
            Theta0.requires_grad_(True)
            with torch.enable_grad():
                Theta_u = _inner_adapt_plane(
                    self.loss_fn, tplane, Theta0, self.inner_lr, support,
                    self.inner_steps, second_order=True, impl=impl)
                losses, mets = _eval_rows(flat_eval, Theta_u, query)
                (G,) = torch.autograd.grad(losses.sum(), Theta0)
            losses = losses.detach()
        else:
            Theta_u = _inner_adapt_plane(
                self.loss_fn, tplane, Theta0, self.inner_lr, support,
                self.inner_steps, second_order=False, impl=impl)
            G, losses, mets = _eval_grad_rows(flat_eval, Theta_u, query)
        return G, {"query_loss": losses, **mets}


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
        ``key`` on θ's device. Beside a θ of DTensors each α leaf is
        drawn whole, then cut to its θ leaf's placement
        (`sharding.rules.shard_like`)."""
        from repro_torch.sharding.rules import shard_like
        split = Rng(key, device="cpu")
        theta = model_init(split.next_seed())
        device = tree_flatten(theta)[0][0].device
        gen = Rng(split.next_seed(), device=device)
        alpha = tree_map(
            lambda p: shard_like(p, self.inner_lr * (0.5 + torch.rand(
                p.shape, dtype=torch.float32, device=device,
                generator=gen.next()))),
            theta)
        return {"theta": theta, "alpha": alpha}

    def client_grad(self, phi, support, query):
        req, treedef = _detached_leaves(phi)
        with torch.enable_grad():
            phi_ = tree_unflatten(treedef, req)
            theta_u = _inner_adapt(self.loss_fn, phi_["theta"],
                                   phi_["alpha"], support, self.inner_steps,
                                   second_order=(self.order == 2))
            loss, metrics = self.eval_fn(theta_u, query)
            g = tree_unflatten(treedef, _grads(loss, req))
        return g, {"query_loss": loss.detach(), **_detach(metrics)}

    def client_grad_chunk_packed(self, pplane, tplane, phi, support, query,
                                 *, impl=None):
        C = _chunk_len(support)
        Theta0 = _plane_rows(tplane, phi["theta"], C).requires_grad_(True)
        # per-client α copies, so the gradient w.r.t. the (C, N) block is
        # the per-client α-gradient, not the chunk sum
        Alpha0 = _plane_rows(tplane, phi["alpha"], C).requires_grad_(True)
        flat_eval = _flat_fn(self.eval_fn, tplane)
        with torch.enable_grad():
            Theta_u = _inner_adapt_plane(
                self.loss_fn, tplane, Theta0, Alpha0, support,
                self.inner_steps, second_order=(self.order == 2), impl=impl)
            losses, mets = _eval_rows(flat_eval, Theta_u, query)
            gT, gA = torch.autograd.grad(losses.sum(), (Theta0, Alpha0))
        G = _assemble_phi_rows(pplane, tplane, {"theta": gT, "alpha": gA})
        return G, {"query_loss": losses.detach(), **mets}


class Reptile(MetaAlgorithm):
    """Beyond-paper extra: first-order, no support/query split needed."""

    def __init__(self, loss_fn, eval_fn, inner_lr, inner_steps=3):
        super().__init__("reptile", loss_fn, eval_fn, inner_lr, inner_steps)

    def init_state(self, key, model_init):
        return {"theta": model_init(key)}

    def client_grad(self, phi, support, query):
        theta_k = _inner_adapt(self.loss_fn, phi["theta"], self.inner_lr,
                               support, self.inner_steps, second_order=False)
        # one extra pass over the query set (uses all local data, like the
        # original Reptile which has no support/query distinction)
        theta_k = _inner_adapt(self.loss_fn, theta_k, self.inner_lr, query,
                               1, second_order=False)
        with torch.no_grad():
            g = tree_map(lambda a, b: (a - b).float(), phi["theta"], theta_k)
            loss, metrics = self.eval_fn(theta_k, query)
        return {"theta": g}, {"query_loss": loss, **metrics}

    def client_grad_chunk_packed(self, pplane, tplane, phi, support, query,
                                 *, impl=None):
        assert pplane.n_padded == tplane.n_padded, \
            (pplane.n_padded, tplane.n_padded)
        Theta0 = _plane_rows(tplane, phi["theta"], _chunk_len(support))
        # K1 adapts its input in place: adapt a copy, keep θ_0
        Theta_k = _inner_adapt_plane(
            self.loss_fn, tplane, Theta0.clone(), self.inner_lr, support,
            self.inner_steps, second_order=False, impl=impl)
        Theta_k = _inner_adapt_plane(
            self.loss_fn, tplane, Theta_k, self.inner_lr, query, 1,
            second_order=False, impl=impl)
        with torch.no_grad():
            G = (Theta0 - Theta_k).float()
            losses, mets = _eval_rows(_flat_fn(self.eval_fn, tplane),
                                      Theta_k, query)
        return G, {"query_loss": losses, **mets}


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
