"""Federated training: the server round loop, client sampling,
communication accounting, the paper's evaluation schemes and crash-safe
checkpoints. Counterpart of `repro/federated/server.py:35-629`.

Evaluation (paper §4.1 + A.2): accuracy w.r.t. all data points on
held-out clients; each adapts on its support set (FedMeta, FedAvg(Meta))
or not (FedAvg) and is scored on its query set.

Task batches are drawn with numpy from the trainer's seeded
`RandomState`, call for call as in the reference, and moved to the
trainer's ``device`` (default "cuda"; the tests pass "cpu"). On the
sharded client axis (``client_axis="sharded"``, ``mesh``,
``mesh_axis``) every rank runs this trainer with the same seed, so
every rank draws the same cohort from the same stream (the reference
is one controller), each reduces its own slice of the clients, and only
rank 0 writes checkpoints. The rounds
run on the async round engine (`async_engine.AsyncRoundEngine`):
prefetching, deferred metrics, fused-K blocks, staleness picks and
checkpoints at block boundaries, each bitwise neutral to the history.

The population plane (``unreliability``, ``over_select``,
``round_deadline``) replaces the plain task stream: each round samples
m·(1+over_select) candidates that the circuit breaker has not
quarantined, `population.plan_round` decides who arrives before the
deadline, and the arrived clients fill the (m, N) block with zero-weight
pad rows that the `masked_mean` aggregator (K2, then one division)
leaves out.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.fedmeta import (init_packed_state,
                                      make_meta_train_step,
                                      make_packed_meta_train_step)
from repro_torch.data.federated import (TaskStream, assemble_task_batch,
                                        sample_task_batch,
                                        stack_task_batches)
from repro_torch.federated.async_engine import (AsyncRoundEngine,
                                                DeviceStager, WorkerPool)
from repro_torch.federated.comm import CommTracker, measure_client_flops
from repro_torch.federated.population import CircuitBreaker, plan_round
from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.optim import Optimizer
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_size


def _rng_state_payload(state):
    """np.random.RandomState.get_state() tuple -> checkpointable dict
    (the 624-word key vector as an array, scalars as python types): the
    reference's payload."""
    alg, keys, pos, has_gauss, cached = state
    return {"alg": alg, "keys": np.asarray(keys, np.uint32),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached": float(cached)}


def _rng_state_from_payload(p):
    keys = p["keys"]
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    return (str(p["alg"]), np.asarray(keys, np.uint32),
            int(p["pos"]), int(p["has_gauss"]), float(p["cached"]))


def _batch_eval(eval_one, clients, m, support_frac, support_size, query_size,
                rng):
    tb = sample_task_batch(clients, m, support_frac, support_size, query_size,
                           rng)
    accs, losses = eval_one((tb.support_x, tb.support_y),
                            (tb.query_x, tb.query_y))
    counts = (np.ones((m,), np.float64) if tb.query_count is None
              else np.asarray(tb.query_count, np.float64))
    return (accs.detach().cpu().numpy(), losses.detach().cpu().numpy(),
            counts)


def _count_weighted(accs, losses, counts):
    """§4.1 evaluation: accuracy w.r.t. *all data points*, i.e. each
    client's (fixed-shape resampled) query accuracy weighted by the
    number of query examples that client actually holds. Same reduction
    for the loss."""
    w = counts / counts.sum()
    return float(np.sum(w * accs)), float(np.sum(w * losses))


def make_meta_evaluator(algo, adapt_steps=None):
    """-> eval_batch(phi, support, query) -> (accs (m,), losses (m,)):
    each client adapts on its support set (tree `adapt`) and is scored
    on its query set. Batches may be numpy; they move to φ's device."""

    def eval_batch(phi, support, query):
        device = tree_flatten(phi)[0][0].device

        def to_dev(x):
            return torch.as_tensor(x, device=device)

        support, query = tree_map(to_dev, (support, query))
        accs, losses = [], []
        for c in range(tree_flatten(support)[0][0].shape[0]):
            s = tree_map(lambda x: x[c], support)
            q = tree_map(lambda x: x[c], query)
            theta_u = algo.adapt(phi, s, steps=adapt_steps)
            with torch.no_grad():
                loss, met = algo.eval_fn(theta_u, q)
            accs.append(met["accuracy"])
            losses.append(loss)
        return torch.stack(accs), torch.stack(losses)

    return eval_batch


def make_global_evaluator(eval_fn, finetune: Optional[Callable] = None):
    """-> eval_batch(theta, support, query) -> (accs (m,), losses (m,)):
    each client scores the global θ on its query set, after fine-tuning
    it on its support set when ``finetune`` is given (FedAvg(Meta))."""

    def eval_batch(theta, support, query):
        device = tree_flatten(theta)[0][0].device

        def to_dev(x):
            return torch.as_tensor(x, device=device)

        support, query = tree_map(to_dev, (support, query))
        accs, losses = [], []
        for c in range(tree_flatten(support)[0][0].shape[0]):
            s = tree_map(lambda x: x[c], support)
            q = tree_map(lambda x: x[c], query)
            th = theta if finetune is None else finetune(theta, s)
            with torch.no_grad():
                loss, met = eval_fn(th, q)
            accs.append(met["accuracy"])
            losses.append(loss)
        return torch.stack(accs), torch.stack(losses)

    return eval_batch


def evaluate_meta(algo, phi, clients, *, support_frac, support_size,
                  query_size, seed=0, adapt_steps=None, evaluator=None):
    """Per-client adapted accuracy over all given clients; returns
    (acc, per_client_accs, mean_loss) with acc and mean_loss weighted by
    each client's true query count (§4.1)."""
    rng = np.random.RandomState(seed)
    ev = evaluator or make_meta_evaluator(algo, adapt_steps)
    accs, losses, counts = _batch_eval(
        lambda s, q: ev(phi, s, q), clients, len(clients), support_frac,
        support_size, query_size, rng)
    acc, loss = _count_weighted(accs, losses, counts)
    return acc, accs, loss


def evaluate_global(eval_fn, theta, clients, *, support_frac, support_size,
                    query_size, seed=0, finetune: Optional[Callable] = None,
                    evaluator=None):
    """FedAvg (finetune=None) / FedAvg(Meta) (finetune=trainer.finetune).
    Returns (acc, per_client_accs, mean_loss), query-count weighted like
    `evaluate_meta`."""
    rng = np.random.RandomState(seed)
    ev = evaluator or make_global_evaluator(eval_fn, finetune)
    accs, losses, counts = _batch_eval(
        lambda s, q: ev(theta, s, q), clients, len(clients), support_frac,
        support_size, query_size, rng)
    acc, loss = _count_weighted(accs, losses, counts)
    return acc, accs, loss


@dataclasses.dataclass
class FederatedTrainer:
    """FedMeta meta-training loop (Algorithm 1 AlgorithmUpdate), on the
    tree pipeline, the packed plane (``packed=True``) or the packed
    client plane (``packed=True, client_plane=True``)."""
    algo: object
    optimizer: Optimizer
    train_clients: list
    clients_per_round: int
    support_frac: float
    support_size: int
    query_size: int
    weighted: bool = True          # paper A.2: weight by local data count
    client_axis: str = "vmap"
    seed: int = 0
    client_chunk: Optional[int] = None   # for client_axis="chunked"
    packed: bool = False                 # packed parameter plane pipeline
    impl: Optional[str] = None           # "cuda" | "torch" kernels (packed)
    block_dtype: Optional[object] = None  # client-grad block dtype (packed)
    client_plane: bool = False  # fused flat inner loop (packed only)
    device: str = "cuda"        # where φ, the batches and the steps live
    # ---- async round engine
    prefetch_depth: int = 0     # staged round blocks ahead; 0 = inline
    flush_every: int = 1        # drain deferred metrics every k rounds
                                # (0 = only at eval rounds / run() exit)
    fuse_rounds: int = 1        # rounds a fused block runs (packed)
    staleness: Optional[object] = None  # StalenessConfig (packed + vmap)
    # ---- failure plane (packed + vmap axis only)
    aggregator: str = "mean"    # mean | masked_mean | screen | trimmed
    screen_factor: float = 3.0  # screen: clip rows > factor × median ‖g‖
    trim: int = 1               # trimmed: per-coordinate trim count
    faults: Optional[object] = None  # FaultConfig
    guard: Optional[bool] = None  # non-finite skip-round guard; None =
                                  # auto (on iff faults or robust agg)
    # ---- bytes-on-the-wire plane (packed + vmap axis only)
    compression: Optional[object] = None  # CompressionConfig
    dp: Optional[object] = None           # DPConfig: central clip + noise
    prefetch_retries: int = 0   # transient staging failures retried
    checkpoint_every: int = 0   # rounds between checkpoints (0 = off)
    checkpoint_dir: Optional[str] = None
    checkpoint_keep: int = 3    # keep-last-k retention
    pool_workers: int = 0       # client-materializing workers (0 = inline)
    pool_retries: int = 2       # per-client retry-with-backoff budget
    task_timeout: Optional[float] = None  # per-client pool timeout (s)
    # ---- population plane (packed + vmap axis only)
    unreliability: Optional[object] = None  # UnreliabilityConfig
    over_select: float = 0.0    # sample m·(1+over_select) candidates
    round_deadline: Optional[float] = None  # latency cutoff
    breaker_threshold: int = 3  # consecutive failures before quarantine
    breaker_cooldown: int = 10  # quarantine length in rounds
    # ---- the sharded client axis
    mesh: Optional[object] = None  # DeviceMesh for client_axis="sharded"
    mesh_axis: Optional[str] = None  # (None = ambient mesh, first axis;
                                     # else the default group's world)

    def __post_init__(self):
        if self.client_plane and not self.packed:
            raise ValueError("client_plane=True requires packed=True")
        if self.fuse_rounds > 1 and not self.packed:
            raise ValueError("fuse_rounds>1 (fused-K round blocks) is a "
                             "packed-pipeline mode")
        if self.staleness is not None:
            if not self.packed or self.client_axis != "vmap":
                raise ValueError("staleness-aware aggregation requires "
                                 "packed=True and client_axis='vmap'")
            if self.fuse_rounds > 1:
                raise ValueError("staleness and fuse_rounds>1 are mutually "
                                 "exclusive (stragglers need per-round "
                                 "straggler picks)")
        if self.over_select < 0:
            raise ValueError("over_select must be >= 0")
        if self._population_active:
            if not self.packed or self.client_axis != "vmap":
                raise ValueError("the population plane (unreliability / "
                                 "over_select / round_deadline) needs "
                                 "the full (m, N) client block — "
                                 "packed=True and client_axis='vmap'")
            if self.fuse_rounds > 1:
                raise ValueError("the population plane and fuse_rounds>1 "
                                 "are mutually exclusive (arrival plans "
                                 "are per-round)")
            if self.staleness is not None:
                raise ValueError("staleness simulation and the population "
                                 "plane are mutually exclusive — the "
                                 "deadline model already decides who "
                                 "arrives late")
            if self.aggregator == "mean":
                # partial rounds need the renormalizing aggregator: the
                # zero-weight pad rows must be exact no-ops
                self.aggregator = "masked_mean"
        if self.aggregator not in mu_ops.AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}; "
                             f"expected one of {mu_ops.AGGREGATORS}")
        if self.faults is not None or self.aggregator != "mean":
            if not self.packed or self.client_axis != "vmap":
                raise ValueError("fault injection / robust aggregation "
                                 "need the full (m, N) client block — "
                                 "packed=True and client_axis='vmap'")
        if self.faults is not None and self.fuse_rounds > 1:
            raise ValueError("faults and fuse_rounds>1 are mutually "
                             "exclusive (failures need per-round picks)")
        if self.aggregator == "trimmed" and \
                2 * self.trim >= self.clients_per_round:
            raise ValueError(f"trimmed mean needs 2·trim < clients_per_"
                             f"round ({self.trim} vs "
                             f"{self.clients_per_round})")
        if self.compression is not None or self.dp is not None:
            if not self.packed or self.client_axis != "vmap":
                raise ValueError("compression / DP need the full (m, N) "
                                 "client block — packed=True and "
                                 "client_axis='vmap'")
            if (self.staleness is not None or self.faults is not None
                    or self.aggregator != "mean"
                    or self._population_active):
                raise ValueError("compression / DP compose with each "
                                 "other but not with staleness, faults, "
                                 "robust aggregators, or the population "
                                 "plane")
            if self.fuse_rounds > 1:
                raise ValueError("compression / DP and fuse_rounds>1 are "
                                 "mutually exclusive (EF indices and "
                                 "noise keys are per-round inputs)")
        if self.guard is None:
            # auto: any failure-plane knob needs skip-round semantics
            self.guard = (self.faults is not None or
                          self.aggregator != "mean")
        if self.guard and not self.packed:
            raise ValueError("the non-finite guard is a flat-plane check "
                             "— packed=True only")
        if torch.device(self.device).type == "cuda":
            # float32 convolutions and matmuls in full f32 (cuDNN would
            # take TF32 by default) and deterministic cuDNN algorithms,
            # so two runs of a round are bitwise equal
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        # the packed step needs φ's FlatPlane, built in init(); the tree
        # step has no such dependency and is built eagerly
        self._step = None if self.packed else make_meta_train_step(
            self.algo, self.optimizer, client_axis=self.client_axis,
            client_chunk=self.client_chunk, mesh=self.mesh,
            mesh_axis=self.mesh_axis)
        self._fused = None
        self._plane = None
        self._rng = np.random.RandomState(self.seed)
        # the straggler and fault picks draw from their own streams, so
        # turning either on never perturbs the task stream
        self._stale_rng = (np.random.RandomState(self.staleness.seed)
                           if self.staleness is not None else None)
        self._fault_rng = (np.random.RandomState(self.faults.seed)
                           if self.faults is not None else None)
        self._rng_snaps: dict = {}   # round -> rng states (prefetch-safe)
        self._breaker = (CircuitBreaker(self.breaker_threshold,
                                        self.breaker_cooldown)
                         if self._population_active else None)
        self._pool: Optional[WorkerPool] = None
        self._stager: Optional[DeviceStager] = None
        self._evaluator = make_meta_evaluator(self.algo)
        self.comm: Optional[CommTracker] = None
        self.history: list = []

    @property
    def _population_active(self) -> bool:
        """Arrival staging replaces the plain task stream. A bare pool
        (``pool_workers > 0``, the rest off) is not population mode: it
        only pre-warms the clients of the upcoming picks, so staging
        stays bitwise the pool-less path."""
        return (self.unreliability is not None or self.over_select > 0
                or self.round_deadline is not None)

    def init(self, key, model_init, phi=None):
        """The initial train state. ``phi`` (a tree on ``device``) stands
        in for ``algo.init_state(key, model_init)`` — how a run starts
        from another package's initial parameters."""
        if phi is None:
            phi = self.algo.init_state(key, model_init)
        if self.packed:
            self._plane = plane_for(phi)
            self._step = make_packed_meta_train_step(
                self.algo, self.optimizer, self._plane,
                client_axis=self.client_axis, client_chunk=self.client_chunk,
                impl=self.impl, block_dtype=self.block_dtype,
                client_plane=self.client_plane, staleness=self.staleness,
                aggregator=self.aggregator,
                screen_factor=self.screen_factor, trim=self.trim,
                faults=self.faults, guard=bool(self.guard),
                compression=self.compression, dp=self.dp, mesh=self.mesh,
                mesh_axis=self.mesh_axis)
            if self.fuse_rounds > 1:
                self._fused = self._fused_step
            state = init_packed_state(
                self.optimizer, self._plane, phi, staleness=self.staleness,
                clients_per_round=self.clients_per_round,
                block_dtype=self.block_dtype, compression=self.compression,
                num_clients=len(self.train_clients))
        else:
            state = {"phi": phi, "opt": self.optimizer.init(phi)}
        self.comm = CommTracker.for_state(
            phi, self.clients_per_round,
            block_dtype=self.block_dtype if self.packed else None)
        if self.packed and self.compression is not None:
            # codec-true upload bytes: payload + side information over
            # the REAL parameter count, top-k values at the block dtype's
            # width; the download leg stays the dense φ
            itemsize = torch.empty(
                (), dtype=self.block_dtype or torch.float32).element_size()
            self.comm.grad_bytes = self.compression.upload_bytes(
                tree_size(phi), itemsize)
            self.comm.codec = self.compression.label()
        return state

    def _fused_step(self, state, staged):
        """K stacked rounds back to back on the device (the reference's
        `lax.scan` over rounds): the same step as K single rounds, no
        host sync between them; metrics stacked on a leading (K,) axis."""
        (sx, sy), (qx, qy), w = staged
        mets = []
        for i in range(sx.shape[0]):
            state, met = self._step(state, (sx[i], sy[i]), (qx[i], qy[i]),
                                    None if w is None else w[i])
            mets.append(met)
        return state, {k: torch.stack([m[k] for m in mets])
                       for k in mets[0]}

    def phi_tree(self, state):
        """φ as a tree regardless of parameter representation."""
        if self.packed:
            return self._plane.unpack(state["phi"])
        return state["phi"]

    def evaluator(self):
        """The trainer's meta-evaluator, for `evaluate_meta`."""
        return self._evaluator

    def measure_flops(self, state):
        """FLOPs of one client's procedure (`measure_client_flops`), on
        one sampled client. It draws that client's task batch from the
        trainer's stream, as the reference does, so the rounds that
        follow see the reference's picks."""
        tb = sample_task_batch(self.train_clients, 1, self.support_frac,
                               self.support_size, self.query_size, self._rng)

        def first(a):
            return torch.as_tensor(a[0], device=self.device)

        sup = (first(tb.support_x), first(tb.support_y))
        qry = (first(tb.query_x), first(tb.query_y))
        phi = self.phi_tree(state)
        fl = measure_client_flops(
            lambda s, q: self.algo.client_grad(phi, s, q), sup, qry)
        if self.comm:
            self.comm.flops_per_client = fl
        return fl

    def _stage_block(self, stream, put, k, round_):
        """Host half of one round block: sample, then stage on the device
        with ``put`` -> (positional inputs, keyword inputs) of the step.
        Runs on the prefetch thread (in block order) when pipelined.

        A fused block (k > 1) stages the k rounds' batches as one
        stacked (k, m, ...) buffer. A single round's optional inputs
        follow the batch positionally — ``(ef_idx, dp_noise)``, trailing
        ``None``s dropped: this round's picks (the rows of the EF plane)
        and its noise generator, a pure function of ``round_``. The
        straggler pick (``stale``, from the trainer's staleness stream)
        and the failure pick (``fault``, host arrays from the fault
        stream) go as keywords."""
        if k > 1:
            tb = stack_task_batches(stream.take(k))
            return ((put(tb.support_x), put(tb.support_y)),
                    (put(tb.query_x), put(tb.query_y)),
                    put(tb.weight) if self.weighted else None), {}
        tb = stream.next()
        args = ((put(tb.support_x), put(tb.support_y)),
                (put(tb.query_x), put(tb.query_y)),
                put(tb.weight) if self.weighted else None)
        kw = {}
        if self.staleness is not None:
            # (straggler_idx, fresh_idx[, delays]): delays only with
            # jitter on, so the fixed path takes its own draws
            kw["stale"] = tuple(
                put(x, torch.long) for x in self.staleness.pick(
                    self.clients_per_round, self._stale_rng))
        if self.faults is not None:
            kw["fault"] = self.faults.pick(self.clients_per_round,
                                           self._fault_rng)
        ef_idx = None
        if self.compression is not None and \
                self.compression.error_feedback:
            ef_idx = put(np.asarray(tb.client_idx, np.int64))
        noise = None
        if self.dp is not None and self.dp.noise_multiplier > 0:
            noise = self.dp.round_generator(round_, self.device)
        tail = [ef_idx, noise]
        while tail and tail[-1] is None:
            tail.pop()
        return args + tuple(tail), kw

    def _peek_picks(self):
        """The upcoming task batch's client picks without consuming the
        stream: the rng state is saved and restored, so the real draw
        that follows replays them (pool cache pre-warming)."""
        st = self._rng.get_state()
        n = len(self.train_clients)
        picks = self._rng.choice(n, size=self.clients_per_round,
                                 replace=n < self.clients_per_round)
        self._rng.set_state(st)
        return picks

    def _stage_population(self, put, round_):
        """Host half of one population round: sample ``m·(1+over_select)``
        candidates the breaker has not quarantined, plan their arrivals,
        materialize the arrived clients (through the worker pool when
        there is one) and stage the zero-weight padded batch the
        `masked_mean` step renormalizes -> (positional inputs, keyword
        inputs) of the step. Runs on the prefetch thread (in round
        order) when pipelined; every draw is the reference's."""
        clients = self.train_clients
        m = self.clients_per_round
        rng = self._rng
        n_cand = m + int(round(self.over_select * m))
        quar = self._breaker.blocked(round_)
        n_total = len(clients)
        if quar and len(quar) < n_total:
            avail = np.setdiff1d(np.arange(n_total, dtype=np.int64),
                                 np.fromiter(quar, np.int64, len(quar)))
            cand = avail[rng.choice(len(avail), size=n_cand,
                                    replace=len(avail) < n_cand)]
        else:
            cand = rng.choice(n_total, size=n_cand,
                              replace=n_total < n_cand).astype(np.int64)
        plan = plan_round(cand, round_, self.unreliability,
                          self.round_deadline, m)
        for c in plan.failed:
            self._breaker.record_failure(int(c), round_)
        for c in plan.arrived:
            self._breaker.record_success(int(c))
        idxs = [int(c) for c in plan.arrived]
        label = f"round {round_}"
        if self._pool is not None:
            shards = self._pool.map(idxs, label=label)
            probe = (None if idxs else
                     self._pool.map([int(cand[0])], label=label)[0])
        else:
            shards = [clients[i] for i in idxs]
            probe = None if idxs else clients[int(cand[0])]
        tb = assemble_task_batch(shards, m, self.support_frac,
                                 self.support_size, self.query_size, rng,
                                 weighted=self.weighted, probe=probe)
        # download: φ went to every candidate; upload: the arrivals only
        self.comm.record_round(len(cand), len(idxs), len(quar))
        # the weights are always staged: the zero rows are the arrivals'
        # mask
        args = ((put(tb.support_x), put(tb.support_y)),
                (put(tb.query_x), put(tb.query_y)), put(tb.weight))
        kw = {}
        if self.faults is not None:
            kw["fault"] = self.faults.pick(m, self._fault_rng)
        return args, kw

    # ---- crash-safe checkpointing ------------------------------------
    def _capture_rngs(self):
        """Snapshot every seeded host stream the run consumes; the
        breaker and the participation log ride along (they change when a
        round is staged, so a retry or a resume rolls them back with the
        rngs)."""
        snap = {"task": self._rng.get_state()}
        if self._stale_rng is not None:
            snap["stale"] = self._stale_rng.get_state()
        if self._fault_rng is not None:
            snap["fault"] = self._fault_rng.get_state()
        if self._breaker is not None:
            snap["breaker"] = self._breaker.state_dict()
            snap["participation"] = (list(self.comm.participation)
                                     if self.comm is not None else [])
        return snap

    def _restore_rngs(self, snap):
        self._rng.set_state(snap["task"])
        if self._stale_rng is not None:
            self._stale_rng.set_state(snap["stale"])
        if self._fault_rng is not None:
            self._fault_rng.set_state(snap["fault"])
        if self._breaker is not None and "breaker" in snap:
            self._breaker.load_state(snap["breaker"])
            if self.comm is not None:
                self.comm.participation[:] = snap.get("participation", [])

    def save_checkpoint(self, state, round_: int, ckpt_dir=None) -> str:
        """Write one atomic checkpoint holding everything a resumed run
        needs for a bitwise equal history: the train state (φ, the
        optimizer, the staleness ring, the EF plane), the rng states *as
        of round ``round_``* (under prefetching the live streams are
        already past it: the snapshot staged at that block boundary is
        used), the CommTracker counters, the flushed history and, under
        the population plane, the breaker and the participation log. The
        payload's keys and layout are the reference's. On the sharded
        axis every rank holds the same state and only rank 0 writes;
        the others return the path it writes to."""
        import torch.distributed as dist
        from repro_torch.checkpoint.io import save_server_state
        snap = self._rng_snaps.pop(round_, None) or self._capture_rngs()
        self._rng_snaps = {r: s for r, s in self._rng_snaps.items()
                           if r > round_}
        payload = {
            "round": int(round_),
            "state": state,
            "rng": {k: _rng_state_payload(snap[k])
                    for k in ("task", "stale", "fault") if k in snap},
            "comm_rounds": int(self.comm.rounds),
            "flops_per_client": float(self.comm.flops_per_client or 0.0),
            "history": list(self.history),
        }
        if "breaker" in snap:      # the population plane's host state
            payload["breaker"] = snap["breaker"]
            payload["participation"] = [list(p) for p in
                                        snap.get("participation", [])]
        ckpt_dir = ckpt_dir or self.checkpoint_dir
        if self.client_axis == "sharded" and dist.is_initialized() and \
                dist.get_rank() != 0:
            return os.path.join(ckpt_dir, f"step_{int(round_):08d}")
        return save_server_state(ckpt_dir, round_, payload,
                                 keep_last=self.checkpoint_keep)

    def resume(self, ckpt_dir=None, step: int | None = None):
        """Restore a killed run from its latest (or ``step``-numbered)
        checkpoint, written by this package or by the reference's. Call
        after ``init()``; returns ``(state, start_round)`` for
        ``run(state, rounds, start_round=start_round)``, whose tail
        reproduces the uninterrupted run's history record for record.
        The state's tensors land on the trainer's device in their saved
        dtypes (bf16 where the manifest lists them)."""
        from repro_torch.checkpoint.io import load_server_state
        payload = load_server_state(ckpt_dir or self.checkpoint_dir, step)
        for name, rng in (("task", self._rng), ("stale", self._stale_rng),
                          ("fault", self._fault_rng)):
            if name in payload["rng"] and rng is not None:
                rng.set_state(_rng_state_from_payload(
                    payload["rng"][name]))
        self.comm.rounds = int(payload["comm_rounds"])
        if payload["flops_per_client"]:
            self.comm.flops_per_client = payload["flops_per_client"]
        if self._breaker is not None and payload.get("breaker") is not None:
            self._breaker.load_state(payload["breaker"])
        self.comm.participation[:] = [
            tuple(int(x) for x in p)
            for p in payload.get("participation", [])]
        self.history[:] = payload["history"]
        state = tree_map(lambda t: t.to(self.device), payload["state"])
        return state, int(payload["round"])

    def run(self, state, rounds: int, eval_every: int = 0,
            eval_clients=None, log: Callable = None,
            start_round: int = 0):
        """Drive rounds ``start_round + 1``..``rounds`` through the async
        round engine. The default knobs (prefetch_depth=0, flush_every=1,
        fuse_rounds=1) are the synchronous loop; every pipelined
        configuration gives a bitwise equal history under the same seed.
        A record is appended EVERY round; eval fields only when evaluated
        (every ``eval_every`` rounds and the last). ``start_round``
        continues a resumed run (see ``resume``)."""
        stream = TaskStream(self.train_clients, self.clients_per_round,
                            self.support_frac, self.support_size,
                            self.query_size, self._rng)
        # pipelined on the card: pinned host buffers copied on a side
        # stream, the step's stream waits on each block's event
        self._stager = DeviceStager(self.device,
                                    side_stream=self.prefetch_depth > 0)
        put = self._stager.put
        produced = {"r": start_round}   # the staging thread's cursor
        if self.pool_workers > 0:
            clients = self.train_clients
            self._pool = WorkerPool(lambda i: clients[i],
                                    workers=self.pool_workers,
                                    max_retries=self.pool_retries,
                                    task_timeout=self.task_timeout)

        def stage(k):
            # retry safety: a failed stage() must not leak partial stream
            # draws, or the retry would see other tasks than the
            # synchronous run
            entry = self._capture_rngs()
            try:
                if self._population_active:
                    block = self._stage_population(put, produced["r"] + 1)
                else:
                    if self._pool is not None and k == 1:
                        # pre-warm the client shards of the upcoming
                        # picks, peeked without consuming the stream
                        self._pool.map(
                            sorted({int(p) for p in self._peek_picks()}),
                            label=f"round {produced['r'] + 1} warm")
                    block = self._stage_block(stream, put, k,
                                              produced["r"] + 1)
            except BaseException:
                self._stager.abort()
                self._restore_rngs(entry)
                raise
            produced["r"] += k
            if self.checkpoint_every:
                # rng states *after* this block = the states a resume
                # from its boundary round must start from
                self._rng_snaps[produced["r"]] = self._capture_rngs()
            return self._stager.end(block)

        evaluate = None
        if eval_every and eval_clients is not None:
            def evaluate(st):
                acc, _, loss = evaluate_meta(
                    self.algo, self.phi_tree(st), eval_clients,
                    support_frac=self.support_frac,
                    support_size=self.support_size,
                    query_size=self.query_size, seed=self.seed,
                    evaluator=self._evaluator)
                return {"eval_acc": acc, "eval_loss": loss}

        checkpoint = None
        if self.checkpoint_every and self.checkpoint_dir:
            checkpoint = self.save_checkpoint
        engine = AsyncRoundEngine(
            stage=stage,
            step=lambda st, a: self._step(st, *a[0], **a[1]),
            comm=self.comm, history=self.history,
            fused_step=(None if self._fused is None else
                        lambda st, a: self._fused(st, a[0])),
            prefetch_depth=self.prefetch_depth,
            flush_every=self.flush_every, fuse_rounds=self.fuse_rounds,
            checkpoint=checkpoint, checkpoint_every=self.checkpoint_every,
            prefetch_retries=self.prefetch_retries)
        try:
            return engine.run(state, rounds, eval_every=eval_every,
                              evaluate=evaluate, log=log,
                              start_round=start_round)
        finally:
            if self._pool is not None:
                self._pool.close()   # no leaked worker threads, ever
                self._pool = None
