"""The FedMeta server round (paper Algorithm 1, AlgorithmUpdate).
Counterpart of `repro/core/fedmeta.py`.

One meta-training round:
  1. a batch of m sampled clients' (support, query) data arrives with a
     leading client axis on every leaf,
  2. every client computes g_u = ModelTraining(φ; D_S^u, D_Q^u),
  3. the server updates φ with the weighted average of the g_u through
     the outer optimizer (Adam, paper A.2).

Client axes: "vmap" (all clients of the round as one chunk — a loop over
clients, or over chunk rows on the client plane), "scan" (one client at
a time into an accumulator) and "chunked" (chunks of ``client_chunk``
clients, the tail padded with zero-weight copies of client 0). PyTorch
runs eagerly, so the three differ in how much is alive at once, not in
what is computed.

Two parameter representations:
  - tree (`make_meta_train_step`): φ stays a tree; aggregation and the
    outer step run per leaf;
  - packed plane (`make_packed_meta_train_step`): φ is one flat f32
    buffer; client gradients form an (m, N) block reduced by K2
    (`weighted_aggregate`), and φ advances by K3 (the fused Adam). With
    ``client_plane=True`` the inner loop runs on the flat (C, N) plane
    through K1 as well.

The knobs of later slices (staleness, faults, robust aggregators,
compression, DP, the sharded axis) raise `NotImplementedError` naming
their slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.utils.flat import FlatPlane, plane_for
from repro_torch.utils.pytree import (tree_add, tree_flatten, tree_map,
                                      tree_scale, tree_zeros_like)

CLIENT_AXES = ("vmap", "scan", "chunked")


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet: it joins the "
                               f"port with the {slice_name} slice")


def _check_axis(client_axis):
    if client_axis == "sharded":
        raise _not_ported("client_axis='sharded'", "multi-device")
    if client_axis not in CLIENT_AXES:
        raise ValueError(client_axis)


def _leading(tree):
    x = tree_flatten(tree)[0][0]
    return x.shape[0], x.device


def _normalize_weights(weights, m, device):
    if weights is None:
        return torch.full((m,), 1.0 / m, dtype=torch.float32, device=device)
    weights = weights.float()
    return weights / torch.sum(weights)


def _pad_client_axis(support, query, w, m, multiple):
    """Pad the leading client axis to a multiple of ``multiple`` with
    zero-weight copies of client 0 (w is already normalized, so the
    padding contributes exactly nothing to gradients or metrics)."""
    pad = (-m) % multiple
    if pad:
        idx = torch.cat([torch.arange(m), torch.zeros((pad,),
                                                      dtype=torch.long)])
        support, query = tree_map(lambda x: x[idx.to(x.device)],
                                  (support, query))
        w = torch.cat([w, w.new_zeros((pad,))])
    return support, query, w, m + pad


def _chunk_client_axis(support, query, w, m, chunk):
    """Split the leading client axis m into chunks of ``chunk``, padding
    the tail with zero-weight copies of client 0 when chunk ∤ m.
    -> a list of (support, query, w) per chunk."""
    support, query, w, m_pad = _pad_client_axis(support, query, w, m, chunk)
    return [(*tree_map(lambda x, i=i: x[i:i + chunk], (support, query)),
             w[i:i + chunk]) for i in range(0, m_pad, chunk)]


def _weighted_metrics(w, mets):
    """Per-client metrics (leading m axis) -> weighted scalar summary,
    the same reduction on every client axis."""
    return tree_map(lambda x: torch.sum(w * x), mets)


def _scan_chunks(chunk_fn, acc0, add, support, query, w, m, chunk):
    """Chunk-by-chunk reduction: chunk_fn(s, q, wc) -> (partial
    aggregate, per-chunk weighted metrics); ``add`` folds partials into
    the ``acc0``-shaped carry. Returns (aggregate, metric sums)."""
    acc, per_chunk = acc0, []
    for s, q, wc in _chunk_client_axis(support, query, w, m, chunk):
        partial, mets = chunk_fn(s, q, wc)
        acc = add(acc, partial)
        per_chunk.append(mets)
    return acc, {k: torch.stack([p[k] for p in per_chunk]).sum()
                 for k in per_chunk[0]}


def _client(tree, u):
    return tree_map(lambda x: x[u], tree)


def _stack_metrics(mets):
    """[metrics dict] per client -> one dict of (m,) tensors."""
    return {k: torch.stack([x[k] for x in mets]) for k in mets[0]}


def _stack_clients(results):
    """[(g tree, metrics)] per client -> (trees stacked on a leading m
    axis, metrics stacked likewise)."""
    gs = tree_map(lambda *xs: torch.stack(xs), *[g for g, _ in results])
    return gs, _stack_metrics([met for _, met in results])


def federated_meta_step(algo, optimizer, phi, opt_state, support, query,
                        weights=None, *, client_axis: str = "vmap",
                        client_chunk: int | None = None):
    """support/query: trees with a leading client axis m on each leaf.
    weights: (m,) aggregation weights (paper A.2 weights by local data
    count); None = uniform 1/m. Returns (phi, opt_state, metrics)."""
    _check_axis(client_axis)
    m, device = _leading(support)
    w = _normalize_weights(weights, m, device)

    def tree_chunk(s, q, wc):
        """Weighted per-leaf partial + weighted metrics for one chunk."""
        gs, mets = _stack_clients([
            algo.client_grad(phi, _client(s, u), _client(q, u))
            for u in range(wc.shape[0])])
        partial = tree_map(
            lambda g: torch.tensordot(wc, g.float(), dims=1), gs)
        return partial, _weighted_metrics(wc, mets)

    def tree_acc0():
        return tree_zeros_like(tree_map(lambda x: x.float(), phi))

    if client_axis == "vmap":
        meta_g, metrics = tree_chunk(support, query, w)
    elif client_axis == "scan":
        meta_g, mets = tree_acc0(), []
        for u in range(m):
            g, met = algo.client_grad(phi, _client(support, u),
                                      _client(query, u))
            meta_g = tree_add(meta_g, tree_scale(
                tree_map(lambda x: x.float(), g), w[u]))
            mets.append(met)
        metrics = _weighted_metrics(w, _stack_metrics(mets))
    else:
        meta_g, metrics = _scan_chunks(
            tree_chunk, tree_acc0(), tree_add, support, query, w, m,
            client_chunk or min(m, 8))

    new_phi, new_opt = optimizer.update(phi, meta_g, opt_state)
    return new_phi, new_opt, metrics


def make_meta_train_step(algo, optimizer, *, client_axis: str = "vmap",
                         client_chunk: int | None = None):
    """-> step(state, support, query, weights) with state = {phi, opt}."""
    _check_axis(client_axis)

    def step(state, support, query, weights=None):
        phi, opt_state, metrics = federated_meta_step(
            algo, optimizer, state["phi"], state["opt"], support, query,
            weights, client_axis=client_axis, client_chunk=client_chunk)
        return {"phi": phi, "opt": opt_state}, metrics

    return step


# ---- packed parameter plane pipeline ------------------------------------

def init_packed_state(optimizer, plane: FlatPlane, phi, *, staleness=None,
                      compression=None):
    """φ tree -> {"phi": flat plane, "opt": flat optimizer state}."""
    from repro_torch.optim.optimizers import make_flat_optimizer
    if staleness is not None:
        raise _not_ported("staleness-aware aggregation", "async")
    if compression is not None:
        raise _not_ported("upload compression", "bytes-on-the-wire")
    flat = plane.pack(phi)
    return {"phi": flat, "opt": make_flat_optimizer(optimizer).init(flat)}


def make_packed_meta_train_step(algo, optimizer, plane: FlatPlane, *,
                                client_axis: str = "vmap",
                                client_chunk: int | None = None,
                                impl: str | None = None,
                                block_dtype=None,
                                client_plane: bool = False,
                                staleness=None,
                                aggregator: str = "mean",
                                faults=None,
                                guard: bool = False,
                                compression=None,
                                dp=None):
    """Meta-train step over the packed plane: state = {phi: (N,), opt}.

    φ is unpacked to a tree once per round (the client model needs
    structured parameters); after the per-client gradients, aggregation
    (K2) and the outer Adam (K3) stay on flat buffers. ``impl`` picks
    "cuda" (the kernels on CUDA tensors) or "torch" (their plain
    versions). ``block_dtype`` sets the dtype of the packed (m, N)
    client-gradient block (None = f32; bf16 halves the aggregation
    traffic, K2 still sums in f32). ``client_plane=True`` runs the inner
    loop on the flat (C, N) plane too (`client_grad_chunk_packed`).

    ``guard`` turns on the non-finite check: if the meta-gradient holds
    a NaN or inf, φ and the optimizer state (step count included) pass
    through unchanged and the metrics carry ``skipped=1``. K3 updates φ
    in place, so the guard keeps a copy of the state from before the
    step."""
    from repro_torch.optim.optimizers import make_flat_optimizer
    _check_axis(client_axis)
    if staleness is not None:
        raise _not_ported("staleness-aware aggregation", "async")
    if aggregator != "mean" or faults is not None:
        raise _not_ported("robust aggregation / fault injection",
                          "failure-plane")
    if compression is not None or dp is not None:
        raise _not_ported("compression / DP", "bytes-on-the-wire")
    impl = mu_ops.resolve_impl(impl)
    flat_opt = make_flat_optimizer(optimizer, impl=impl)
    bd = block_dtype or torch.float32

    def finish(state, meta_g, metrics):
        """Outer optimizer step + optional non-finite guard."""
        if guard:
            ok = torch.all(torch.isfinite(meta_g))
            old_phi = state["phi"].clone()
            old_opt = tree_map(torch.clone, state["opt"])
        new_flat, new_opt = flat_opt.update(state["phi"], meta_g,
                                            state["opt"])
        if guard:
            new_flat = torch.where(ok, new_flat, old_phi)
            new_opt = tree_map(lambda n, o: torch.where(ok, n, o), new_opt,
                               old_opt)
            metrics = {**metrics,
                       "skipped": torch.logical_not(ok).float()}
        return {"phi": new_flat, "opt": new_opt}, metrics

    def step(state, support, query, weights=None):
        phi = plane.unpack(state["phi"])
        m, device = _leading(support)
        w = _normalize_weights(weights, m, device)

        if client_plane:
            tplane = plane_for(phi["theta"])

            def chunk_grads(s, q):
                """(C, N) gradient rows + metrics for a chunk of clients,
                computed on the flat client plane."""
                G, mets = algo.client_grad_chunk_packed(
                    plane, tplane, phi, s, q, impl=impl)
                return G.to(bd), mets
        else:
            def one_packed(s, q):
                g, met = algo.client_grad(phi, s, q)
                return plane.pack(g, bd), met

            def chunk_grads(s, q):
                return _stack_clients([one_packed(_client(s, u),
                                                  _client(q, u))
                                       for u in range(_leading(s)[0])])

        def packed_chunk(s, q, wc):
            """Fused (N,) weighted partial + weighted metrics for one
            chunk of clients."""
            G, mets = chunk_grads(s, q)
            return (mu_ops.weighted_aggregate(G, wc, impl=impl),
                    _weighted_metrics(wc, mets))

        if client_axis == "vmap":
            meta_g, metrics = packed_chunk(support, query, w)
        elif client_axis == "scan":
            meta_g, mets = plane.zeros(device), []
            for u in range(m):
                s, q = _client(support, u), _client(query, u)
                if client_plane:
                    G, met = chunk_grads(
                        *tree_map(lambda x: x[None], (s, q)))
                    g, met = G[0], tree_map(lambda x: x[0], met)
                else:
                    g, met = one_packed(s, q)
                meta_g = meta_g + w[u] * g.float()
                mets.append(met)
            metrics = _weighted_metrics(w, _stack_metrics(mets))
        else:
            meta_g, metrics = _scan_chunks(
                packed_chunk, plane.zeros(device), torch.add, support,
                query, w, m, client_chunk or min(m, 8))

        return finish(state, meta_g, metrics)

    return step
