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
a time into an accumulator), "chunked" (chunks of ``client_chunk``
clients, the tail padded with zero-weight copies of client 0) and
"sharded" (the clients split over the ranks of a process group: every
rank holds the round's whole batch, pads it to a multiple of the world
with zero-weight copies of client 0, reduces its own slice — one chunk,
or chunks of ``client_chunk`` — to a partial meta-gradient and weighted
metrics, and one all-reduce sums them; every rank then takes the same
outer step). PyTorch runs eagerly, so vmap, scan and chunked differ in
how much is alive at once, not in what is computed.

Two parameter representations:
  - tree (`make_meta_train_step`): φ stays a tree; aggregation and the
    outer step run per leaf;
  - packed plane (`make_packed_meta_train_step`): φ is one flat f32
    buffer; client gradients form an (m, N) block reduced by K2
    (`weighted_aggregate`), and φ advances by K3 (the fused Adam). With
    ``client_plane=True`` the inner loop runs on the flat (C, N) plane
    through K1 as well.

The bytes-on-the-wire knobs (``compression``, ``dp``), the failure
plane (``faults``, robust ``aggregator``s, the non-finite ``guard``) and
staleness-aware aggregation (``staleness``, its ring in the state) run
on the packed vmap axis only, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.sharding.context import get_mesh
from repro_torch.utils.flat import FlatPlane, plane_for
from repro_torch.utils.pytree import (tree_add, tree_flatten, tree_map,
                                      tree_scale, tree_unflatten,
                                      tree_zeros_like)

CLIENT_AXES = ("vmap", "scan", "chunked", "sharded")


def _check_axis(client_axis):
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


def _resolve_axis(mesh, mesh_axis):
    """The process group clients shard over, its size and this rank's
    index in it -> (group, size, rank).

    Precedence (the reference's `_resolve_mesh`): an explicit ``mesh``
    (a DeviceMesh; ``mesh_axis`` names its dim, default its first), then
    the ambient mesh (`sharding.context`), then a 1-D "clients" axis
    over the default group's world. With no group initialized that is a
    world of one (group None), as the reference's one-device host mesh
    is, and nothing is communicated."""
    import torch.distributed as dist
    mesh = mesh or get_mesh()
    if mesh is not None:
        ax = mesh_axis or mesh.mesh_dim_names[0]
        return (mesh.get_group(ax), mesh.size(mesh.mesh_dim_names.index(ax)),
                mesh.get_local_rank(ax))
    if mesh_axis is not None:
        raise ValueError(f"mesh_axis={mesh_axis!r} needs a mesh")
    if not dist.is_initialized():
        return None, 1, 0
    return dist.group.WORLD, dist.get_world_size(), dist.get_rank()


def _sharded_reduce(chunk_fn, acc0, add, support, query, w, m, client_chunk,
                    mesh, mesh_axis):
    """The sharded axis's reduction, shared by the tree and packed
    pipelines. Clients are padded to a multiple of the axis's size and
    this rank takes its slice; chunk_fn runs on it (chunk by chunk when
    ``client_chunk`` < the local count), and ONE all-reduce (SUM) over
    the axis's group sums the partial aggregates (a flat (N,) buffer or
    a tree: its leaves laid end to end) together with the weighted
    metrics. Returns (aggregate, metric sums), equal on every rank."""
    from repro_torch.sharding.collectives import all_reduce_sum
    group, size, rank = _resolve_axis(mesh, mesh_axis)
    sup_p, qry_p, w_p, m_pad = _pad_client_axis(support, query, w, m, size)
    m_loc = m_pad // size
    lo = rank * m_loc
    s, q = tree_map(lambda x: x[lo:lo + m_loc], (sup_p, qry_p))
    wl = w_p[lo:lo + m_loc]
    if client_chunk and client_chunk < m_loc:
        partial, mets = _scan_chunks(chunk_fn, acc0, add, s, q, wl, m_loc,
                                     client_chunk)
    else:
        partial, mets = chunk_fn(s, q, wl)
    if group is None:
        return partial, mets
    leaves, treedef = tree_flatten(partial)
    keys = sorted(mets)
    buf = torch.cat([x.reshape(-1).float() for x in leaves]
                    + [mets[k].reshape(1).float() for k in keys])
    all_reduce_sum(buf, group)
    out, off = [], 0
    for x in leaves:
        out.append(buf[off:off + x.numel()].view(x.shape).to(x.dtype))
        off += x.numel()
    return (tree_unflatten(treedef, out),
            {k: buf[off + i] for i, k in enumerate(keys)})


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
                        client_chunk: int | None = None, mesh=None,
                        mesh_axis: str | None = None):
    """support/query: trees with a leading client axis m on each leaf.
    weights: (m,) aggregation weights (paper A.2 weights by local data
    count); None = uniform 1/m. Returns (phi, opt_state, metrics).
    mesh/mesh_axis: only for client_axis="sharded" (default: the ambient
    mesh, its first axis; else the default group's world)."""
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
    elif client_axis == "chunked":
        meta_g, metrics = _scan_chunks(
            tree_chunk, tree_acc0(), tree_add, support, query, w, m,
            client_chunk or min(m, 8))
    else:
        meta_g, metrics = _sharded_reduce(
            tree_chunk, tree_acc0(), tree_add, support, query, w, m,
            client_chunk, mesh, mesh_axis)

    new_phi, new_opt = optimizer.update(phi, meta_g, opt_state)
    return new_phi, new_opt, metrics


def make_meta_train_step(algo, optimizer, *, client_axis: str = "vmap",
                         client_chunk: int | None = None, mesh=None,
                         mesh_axis: str | None = None):
    """-> step(state, support, query, weights) with state = {phi, opt}."""
    _check_axis(client_axis)

    def step(state, support, query, weights=None):
        phi, opt_state, metrics = federated_meta_step(
            algo, optimizer, state["phi"], state["opt"], support, query,
            weights, client_axis=client_axis, client_chunk=client_chunk,
            mesh=mesh, mesh_axis=mesh_axis)
        return {"phi": phi, "opt": opt_state}, metrics

    return step


# ---- packed parameter plane pipeline ------------------------------------

def init_packed_state(optimizer, plane: FlatPlane, phi, *, staleness=None,
                      clients_per_round=None, block_dtype=None,
                      compression=None, num_clients=None):
    """φ tree -> {"phi": flat plane, "opt": flat optimizer state}.

    With ``staleness`` (`StalenessConfig`) the state also carries the
    in-flight straggler ring ``state["stale"]``: a ``(delay, k, N)``
    block of not-yet-arrived gradient rows at the block dtype and their
    ``(delay, k)`` f32 weights ``w``, zero at the start, so the warm-up
    rounds aggregate fresh rows only; under ``jitter`` also each row's
    remaining-rounds counter ``c`` and drawn delay ``d`` (int32).

    With ``compression`` set and error feedback on, the state also
    carries the per-client residual plane ``state["ef"]``: a
    ``(num_clients, N)`` f32 buffer of quantization error not yet
    uploaded, zero at the start (a first upload compresses the raw
    gradient)."""
    from repro_torch.optim.optimizers import make_flat_optimizer
    flat = plane.pack(phi)
    state = {"phi": flat, "opt": make_flat_optimizer(optimizer).init(flat)}
    if compression is not None and compression.error_feedback:
        if num_clients is None:
            raise ValueError("error feedback needs num_clients (total "
                             "train clients) to size the residual plane")
        state["ef"] = torch.zeros((num_clients, plane.n_padded),
                                  dtype=torch.float32, device=flat.device)
    if staleness is not None:
        if clients_per_round is None:
            raise ValueError("staleness needs clients_per_round to size "
                             "the straggler buffer")
        k = staleness.num_stragglers(clients_per_round)
        shape = (staleness.delay, k)
        state["stale"] = {
            "G": torch.zeros(shape + (plane.n_padded,),
                             dtype=block_dtype or torch.float32,
                             device=flat.device),
            "w": torch.zeros(shape, dtype=torch.float32, device=flat.device)}
        if staleness.jitter:
            for key in ("c", "d"):
                state["stale"][key] = torch.zeros(shape, dtype=torch.int32,
                                                  device=flat.device)
    return state


def make_packed_meta_train_step(algo, optimizer, plane: FlatPlane, *,
                                client_axis: str = "vmap",
                                client_chunk: int | None = None,
                                impl: str | None = None,
                                block_dtype=None,
                                client_plane: bool = False,
                                staleness=None,
                                aggregator: str = "mean",
                                screen_factor: float = 3.0,
                                trim: int = 1,
                                faults=None,
                                guard: bool = False,
                                compression=None,
                                dp=None,
                                mesh=None, mesh_axis: str | None = None):
    """Meta-train step over the packed plane: state = {phi: (N,), opt}.

    φ is unpacked to a tree once per round (the client model needs
    structured parameters); after the per-client gradients, aggregation
    (K2) and the outer Adam (K3) stay on flat buffers. ``impl`` picks
    "cuda" (the kernels on CUDA tensors) or "torch" (their plain
    versions). ``block_dtype`` sets the dtype of the packed (m, N)
    client-gradient block (None = f32; bf16 halves the aggregation
    traffic, K2 still sums in f32). ``client_plane=True`` runs the inner
    loop on the flat (C, N) plane too (`client_grad_chunk_packed`).
    ``client_axis="sharded"`` splits the clients over the ranks of
    ``mesh``'s ``mesh_axis`` (default: the ambient mesh, else the
    default group's world): each rank reduces its slice with K2 and one
    all-reduce sums the (N,) partials and the metrics before K3.

    The failure plane (vmap axis only; ``client_plane=True`` allowed):

      * ``aggregator`` picks the (m, N) → (N,) reduce, "mean" (K2, the
        plain round), "masked_mean", "screen" (``screen_factor``) or
        "trimmed" (``trim``, K5) — see `ops.robust_aggregate`;
      * ``faults`` (`FaultConfig`) makes the step take ``fault=``, a
        keyword: the round's ``FaultConfig.pick`` tuple of host arrays
        (its last entry the noise seed, or an injected (m, N) draw).
        The block is corrupted in place before the reduce — dropped rows
        zero their weight, non-finite rows turn NaN, Byzantine rows are
        rewritten — and the metrics are weighted over the arrived
        clients;
      * ``guard`` turns on the non-finite check: if the meta-gradient
        holds a NaN or inf, φ and the optimizer state (step count
        included) pass through unchanged and the metrics carry
        ``skipped=1``. K3 updates φ in place, so the guard keeps a copy
        of the state from before the step.

    With every failure knob off the step runs the default reduce, the
    same graph as without the knobs.

    ``staleness`` (`StalenessConfig`; vmap axis only) turns on
    staleness-aware aggregation: the step takes ``stale=``, a keyword,
    the round's ``(straggler_idx, fresh_idx[, delays])`` pick. Straggler
    rows of the (m, N) block detour through the state's ``(delay, k, N)``
    ring; the rows that arrive this round join the fresh rows in one
    aggregation block, built in the reference's order — fresh rows, then
    (under jitter) this round's straggler rows, then the ring's rows —
    at weight w·γ^s, and the weights renormalize over the block before
    K2 (the robust aggregators take the same block). Fixed delay: the
    ring's oldest slot arrives at γ^delay. Jitter: each ring row counts
    down ``c`` and arrives when it reaches 0 at γ^d, γ^d computed in f32
    as ``float32(discount) ** d``; an arrived row's weight turns 0 so it
    cannot arrive twice, and a d = 0 straggler joins its own round at
    γ^0. Faults corrupt the block before the detour, so corrupted rows
    ride the ring like honest ones. The block is a new (m − k + delay·k
    or m − k + 1, N) tensor each round, as the reference's concatenate.

    The bytes-on-the-wire plane (vmap axis only), both knobs bitwise
    no-ops when off:

      * ``compression`` (`CompressionConfig`) encodes each row of the
        (m, N) block — int8 through K6, or top-k — and aggregates the
        encoded uploads through K2 (the int8 scale folds into the
        weight; top-k scatters to a dense block first). With error
        feedback the step takes ``ef_idx``, this round's client indices
        into ``state["ef"]``: the residual rejoins the gradient before
        encoding and the new residual is written back in place. A
        client picked twice in one round keeps its LAST row's residual.
      * ``dp`` (`DPConfig`) clips each row as a weight scale, with the
        row norms taken in the codec domain (s·‖q‖, ‖top-k values‖,
        ‖g‖), and adds N(0, σ²) with σ = z·S/m to the aggregated
        meta-gradient on the n_real live entries only (the padding stays
        zero). The step then takes ``dp_noise``: the round's
        `torch.Generator` (`DPConfig.round_generator`) or an injected
        (N,) standard-normal draw.

    Order with both on: EF-correct → encode → clip → aggregate → noise.
    The EF-corrected block is a temporary of the step, so K6 writes the
    residual over it."""
    from repro_torch.federated.privacy import dp_clip_factors, gaussian
    from repro_torch.kernels.meta_update.compress import (int8_row_norms,
                                                          topk_encode,
                                                          topk_row_norms)
    from repro_torch.optim.optimizers import make_flat_optimizer
    from repro_torch.federated.faults import apply_faults
    _check_axis(client_axis)
    if aggregator not in mu_ops.AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; expected "
                         f"one of {mu_ops.AGGREGATORS}")
    if staleness is not None and client_axis != "vmap":
        raise ValueError("staleness-aware aggregation needs the full "
                         "(m, N) gradient block before the reduce — "
                         "client_axis='vmap' only")
    failure = faults is not None or aggregator != "mean"
    if failure and client_axis != "vmap":
        raise ValueError("fault injection / robust aggregation need the "
                         "full (m, N) gradient block before the reduce — "
                         "client_axis='vmap' only")
    if compression is not None or dp is not None:
        if client_axis != "vmap":
            raise ValueError("compression / DP need the full (m, N) "
                             "gradient block before the reduce — "
                             "client_axis='vmap' only")
        if staleness is not None or failure:
            raise ValueError("compression / DP compose with each other "
                             "but not with staleness, faults, or robust "
                             "aggregators — the codec/clip semantics of "
                             "ring rows and corrupted rows are undefined")
    impl = mu_ops.resolve_impl(impl)
    flat_opt = make_flat_optimizer(optimizer, impl=impl)
    bd = block_dtype or torch.float32

    def finish(state, meta_g, metrics, extra=None):
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
        new_state = {"phi": new_flat, "opt": new_opt}
        if extra is not None:
            new_state.update(extra)
        return new_state, metrics

    def wire(state, chunk_grads, support, query, w, ef_idx, dp_noise):
        """The round's (m, N) block through the bytes-on-the-wire reduce
        -> (meta-gradient, metrics, the state's new entries). The block
        is this function's own temporary: the EF residual is added into
        it and K6 writes the new residual over it."""
        G, mets = chunk_grads(support, query)
        metrics = _weighted_metrics(w, mets)
        m = G.shape[0]
        extra, w_agg = None, w
        if compression is not None:
            corrected = G.float()
            del G
            if compression.error_feedback:
                corrected.add_(state["ef"][ef_idx])
            if compression.codec == "int8":
                q, scales, resid = mu_ops.int8_encode(corrected, impl=impl,
                                                      inplace=True)
                if dp is not None:
                    w_agg = w * dp_clip_factors(int8_row_norms(q, scales),
                                                dp.clip_norm)
                meta_g = mu_ops.int8_aggregate(q, scales, w_agg, impl=impl)
            else:
                vals, idx, resid = topk_encode(
                    corrected, compression.k_for(plane.n_real),
                    val_dtype=bd)
                if dp is not None:
                    w_agg = w * dp_clip_factors(topk_row_norms(vals),
                                                dp.clip_norm)
                meta_g = mu_ops.topk_aggregate(vals, idx, w_agg,
                                               plane.n_padded, impl=impl)
            if compression.error_feedback:
                # row by row, in order, so the last row of a client
                # picked twice wins (one scatter would pick either)
                ef = state["ef"]
                for u in range(m):
                    ef.index_copy_(0, ef_idx[u:u + 1], resid[u:u + 1])
                extra = {"ef": ef}
        else:
            norms = torch.sqrt(torch.sum(torch.square(G.float()), dim=1))
            w_agg = w * dp_clip_factors(norms, dp.clip_norm)
            meta_g = mu_ops.weighted_aggregate(G, w_agg, impl=impl)
        if dp is not None and dp.noise_multiplier > 0:
            live = (torch.arange(plane.n_padded, device=meta_g.device)
                    < plane.n_real).float()
            noise = gaussian((plane.n_padded,), dp_noise, meta_g.device)
            meta_g = meta_g + dp.sigma(m) * live * noise
        return meta_g, metrics, extra

    def failure_plane(chunk_grads, support, query, w, fault):
        """The round's (m, N) block, corrupted by ``fault`` (in place),
        through the robust reduce -> (meta-gradient, metrics)."""
        G, mets = chunk_grads(support, query)
        w_agg = w_rep = w
        if faults is not None:
            G, w_agg, w_rep = apply_faults(faults, G, w, fault)
        return (mu_ops.robust_aggregate(G, w_agg, aggregator=aggregator,
                                        impl=impl,
                                        screen_factor=screen_factor,
                                        trim=trim),
                _weighted_metrics(w_rep, mets))

    def aggregate(G, w_agg):
        """The staleness block's reduce: mean normalizes the weights
        over the block first (the reference's ``prenorm``)."""
        if aggregator == "mean":
            return mu_ops.weighted_aggregate(G, w_agg / torch.sum(w_agg),
                                             impl=impl)
        return mu_ops.robust_aggregate(G, w_agg, aggregator=aggregator,
                                       impl=impl,
                                       screen_factor=screen_factor,
                                       trim=trim)

    def stale_round(state, chunk_grads, support, query, w, stale, fault):
        """The round's (m, N) block with its stragglers detoured through
        the ring -> (meta-gradient, metrics, the state's new ring)."""
        dev = w.device
        sel = [torch.as_tensor(x, dtype=torch.long, device=dev)
               for x in stale]
        strag, fresh = sel[0], sel[1]
        G, mets = chunk_grads(support, query)
        w_rep = w
        if faults is not None:
            G, w, w_rep = apply_faults(faults, G, w, fault)
        metrics = _weighted_metrics(w_rep, mets)
        buf = state["stale"]
        g_strag = G[strag]
        if staleness.jitter:
            delays = sel[2]
            c = buf["c"] - 1
            arrive = (c <= 0) & (buf["w"] > 0)
            gamma_d = torch.pow(torch.tensor(staleness.discount,
                                             dtype=torch.float32, device=dev),
                                buf["d"].float())
            dk = buf["G"].shape[0] * buf["G"].shape[1]
            agg_G = torch.cat([G[fresh], g_strag,
                               buf["G"].reshape(dk, buf["G"].shape[2])])
            agg_w = torch.cat([
                w[fresh], torch.where(delays == 0, w[strag], 0.0),
                torch.where(arrive, buf["w"] * gamma_d, 0.0).reshape(dk)])
            kept_w = torch.where(arrive, 0.0, buf["w"])
            d32 = delays.to(torch.int32)[None]
            ring = {"w": torch.cat([kept_w[1:], torch.where(
                        delays > 0, w[strag], 0.0)[None]]),
                    "c": torch.cat([c[1:], d32]),
                    "d": torch.cat([buf["d"][1:], d32])}
        else:
            gamma = float(np.float32(staleness.discount ** staleness.delay))
            agg_G = torch.cat([G[fresh], buf["G"][0]])
            agg_w = torch.cat([w[fresh], buf["w"][0] * gamma])
            ring = {"w": torch.cat([buf["w"][1:], w[strag][None]])}
        del G
        meta_g = aggregate(agg_G, agg_w)
        del agg_G
        ring["G"] = torch.cat([buf["G"][1:], g_strag[None]])
        return meta_g, metrics, {"stale": ring}

    def step(state, support, query, weights=None, ef_idx=None,
             dp_noise=None, *, fault=None, stale=None):
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

        if staleness is not None:
            return finish(state, *stale_round(state, chunk_grads, support,
                                              query, w, stale, fault))
        if compression is not None or dp is not None:
            return finish(state, *wire(state, chunk_grads, support, query,
                                       w, ef_idx, dp_noise))
        if failure:
            return finish(state, *failure_plane(chunk_grads, support, query,
                                                w, fault))
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
        elif client_axis == "chunked":
            meta_g, metrics = _scan_chunks(
                packed_chunk, plane.zeros(device), torch.add, support,
                query, w, m, client_chunk or min(m, 8))
        else:
            meta_g, metrics = _sharded_reduce(
                packed_chunk, plane.zeros(device), torch.add, support,
                query, w, m, client_chunk, mesh, mesh_axis)

        return finish(state, meta_g, metrics)

    return step
