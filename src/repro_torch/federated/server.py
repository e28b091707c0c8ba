"""Federated training: the server round loop, client sampling,
communication accounting and the paper's evaluation schemes.
Counterpart of `repro/federated/server.py:49-122,126-405,548-629`.

Evaluation (paper §4.1 + A.2): accuracy w.r.t. all data points on
held-out clients; each adapts on its support set (FedMeta, FedAvg(Meta))
or not (FedAvg) and is scored on its query set.

Task batches are drawn with numpy from the trainer's seeded
`RandomState`, call for call as in the reference, and moved to the
trainer's ``device`` (default "cuda"; the tests pass "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.fedmeta import (init_packed_state,
                                      make_meta_train_step,
                                      make_packed_meta_train_step)
from repro_torch.data.federated import TaskStream, sample_task_batch
from repro_torch.federated.async_engine import AsyncRoundEngine
from repro_torch.federated.comm import CommTracker, measure_client_flops
from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.optim import Optimizer
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_size


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


# knobs of the reference trainer that later slices bring: field ->
# (its default, the slice that ports it)
_PENDING = {
    "mesh": (None, "multi-device"), "mesh_axis": (None, "multi-device"),
    "prefetch_depth": (0, "async"), "fuse_rounds": (1, "async"),
    "staleness": (None, "async"), "prefetch_retries": (0, "async"),
    "checkpoint_every": (0, "async (checkpointing)"),
    "checkpoint_dir": (None, "async (checkpointing)"),
    "unreliability": (None, "population"), "over_select": (0.0, "population"),
    "round_deadline": (None, "population"), "pool_workers": (0, "population"),
}


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
    flush_every: int = 1        # drain deferred metrics every k rounds
    device: str = "cuda"        # where φ, the batches and the steps live
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
    # ---- knobs of later slices: they raise unless left at the default
    mesh: Optional[object] = None
    mesh_axis: Optional[str] = None
    prefetch_depth: int = 0
    fuse_rounds: int = 1
    staleness: Optional[object] = None
    prefetch_retries: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    unreliability: Optional[object] = None
    over_select: float = 0.0
    round_deadline: Optional[float] = None
    pool_workers: int = 0

    def __post_init__(self):
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
                    or self.unreliability is not None
                    or self.over_select or self.round_deadline is not None):
                raise ValueError("compression / DP compose with each "
                                 "other but not with staleness, faults, "
                                 "robust aggregators, or the population "
                                 "plane")
            if self.fuse_rounds > 1:
                raise ValueError("compression / DP and fuse_rounds>1 are "
                                 "mutually exclusive (EF indices and "
                                 "noise keys are per-round inputs)")
        for name, (default, slice_name) in _PENDING.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"FederatedTrainer({name}=...) is not ported yet: it "
                    f"joins the port with the {slice_name} slice")
        if self.client_axis == "sharded":
            raise NotImplementedError(
                "client_axis='sharded' is not ported yet: it joins the port "
                "with the multi-device slice")
        if self.client_plane and not self.packed:
            raise ValueError("client_plane=True requires packed=True")
        if self.guard is None:
            # auto: any failure-plane knob needs skip-round semantics
            self.guard = (self.faults is not None or
                          self.aggregator != "mean")
        if torch.device(self.device).type == "cuda":
            # float32 convolutions and matmuls in full f32 (cuDNN would
            # take TF32 by default) and deterministic cuDNN algorithms,
            # so two runs of a round are bitwise equal
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        if self.guard and not self.packed:
            raise ValueError("the non-finite guard is a flat-plane check "
                             "— packed=True only")
        # the packed step needs φ's FlatPlane, built in init(); the tree
        # step has no such dependency and is built eagerly
        self._step = None if self.packed else make_meta_train_step(
            self.algo, self.optimizer, client_axis=self.client_axis,
            client_chunk=self.client_chunk)
        self._plane = None
        self._rng = np.random.RandomState(self.seed)
        # the fault picks draw from their own stream, so turning faults
        # on never perturbs the task stream
        self._fault_rng = (np.random.RandomState(self.faults.seed)
                           if self.faults is not None else None)
        self._evaluator = make_meta_evaluator(self.algo)
        self.comm: Optional[CommTracker] = None
        self.history: list = []

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
                client_plane=self.client_plane, aggregator=self.aggregator,
                screen_factor=self.screen_factor, trim=self.trim,
                faults=self.faults, guard=bool(self.guard),
                compression=self.compression, dp=self.dp)
            state = init_packed_state(self.optimizer, self._plane, phi,
                                      compression=self.compression,
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

    def _stage(self, stream, round_):
        """Host half of one round: sample, then move to the device ->
        (positional inputs, keyword inputs) of the step.

        The step's optional inputs follow the batch positionally —
        ``(ef_idx, dp_noise)``, trailing ``None``s dropped: this round's
        picks (the rows of the EF plane) and its noise generator, a pure
        function of ``round_``. With faults on, the round's failure pick
        (host arrays, from the trainer's own fault stream) goes as the
        keyword ``fault``."""
        tb = stream.next()

        def dp(a):
            return torch.as_tensor(a, device=self.device)

        args = ((dp(tb.support_x), dp(tb.support_y)),
                (dp(tb.query_x), dp(tb.query_y)),
                dp(tb.weight) if self.weighted else None)
        ef_idx = None
        if self.compression is not None and \
                self.compression.error_feedback:
            ef_idx = dp(np.asarray(tb.client_idx, np.int64))
        noise = None
        if self.dp is not None and self.dp.noise_multiplier > 0:
            noise = self.dp.round_generator(round_, self.device)
        tail = [ef_idx, noise]
        while tail and tail[-1] is None:
            tail.pop()
        kw = {}
        if self.faults is not None:
            kw["fault"] = self.faults.pick(self.clients_per_round,
                                           self._fault_rng)
        return args + tuple(tail), kw

    def run(self, state, rounds: int, eval_every: int = 0,
            eval_clients=None, log: Callable = None):
        """Drive ``rounds`` rounds. A record is appended EVERY round;
        eval fields only when evaluated (every ``eval_every`` rounds and
        the last)."""
        stream = TaskStream(self.train_clients, self.clients_per_round,
                            self.support_frac, self.support_size,
                            self.query_size, self._rng)
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

        produced = {"r": 0}

        def stage():
            produced["r"] += 1
            return self._stage(stream, produced["r"])

        engine = AsyncRoundEngine(
            stage=stage,
            step=lambda st, a: self._step(st, *a[0], **a[1]),
            comm=self.comm, history=self.history,
            flush_every=self.flush_every)
        return engine.run(state, rounds, eval_every=eval_every,
                          evaluate=evaluate, log=log)
