"""Federated training: the server round loop, client sampling,
communication accounting and the paper's meta-evaluation. Counterpart
of `repro/federated/server.py:49-107,126-350,548-629`.

Evaluation (paper §4.1 + A.2): accuracy w.r.t. all data points on
held-out clients; each adapts on its support set and is scored on its
query set.

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
from repro_torch.federated.comm import CommTracker
from repro_torch.optim import Optimizer
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_flatten, tree_map


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


# knobs of the reference trainer that later slices bring: field ->
# (its default, the slice that ports it)
_PENDING = {
    "mesh": (None, "multi-device"), "mesh_axis": (None, "multi-device"),
    "prefetch_depth": (0, "async"), "fuse_rounds": (1, "async"),
    "staleness": (None, "async"), "prefetch_retries": (0, "async"),
    "aggregator": ("mean", "failure-plane"),
    "faults": (None, "failure-plane"),
    "checkpoint_every": (0, "failure-plane (checkpointing)"),
    "checkpoint_dir": (None, "failure-plane (checkpointing)"),
    "compression": (None, "bytes-on-the-wire"),
    "dp": (None, "bytes-on-the-wire"),
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
    guard: Optional[bool] = None  # non-finite skip-round guard (packed)
    device: str = "cuda"        # where φ, the batches and the steps live
    # ---- knobs of later slices: they raise unless left at the default
    mesh: Optional[object] = None
    mesh_axis: Optional[str] = None
    prefetch_depth: int = 0
    fuse_rounds: int = 1
    staleness: Optional[object] = None
    prefetch_retries: int = 0
    aggregator: str = "mean"
    faults: Optional[object] = None
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    compression: Optional[object] = None
    dp: Optional[object] = None
    unreliability: Optional[object] = None
    over_select: float = 0.0
    round_deadline: Optional[float] = None
    pool_workers: int = 0

    def __post_init__(self):
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
        self.guard = bool(self.guard)
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
        self._evaluator = make_meta_evaluator(self.algo)
        self.comm: Optional[CommTracker] = None
        self.history: list = []

    def init(self, key, model_init):
        phi = self.algo.init_state(key, model_init)
        if self.packed:
            self._plane = plane_for(phi)
            self._step = make_packed_meta_train_step(
                self.algo, self.optimizer, self._plane,
                client_axis=self.client_axis, client_chunk=self.client_chunk,
                impl=self.impl, block_dtype=self.block_dtype,
                client_plane=self.client_plane, guard=self.guard)
            state = init_packed_state(self.optimizer, self._plane, phi)
        else:
            state = {"phi": phi, "opt": self.optimizer.init(phi)}
        self.comm = CommTracker.for_state(
            phi, self.clients_per_round,
            block_dtype=self.block_dtype if self.packed else None)
        return state

    def phi_tree(self, state):
        """φ as a tree regardless of parameter representation."""
        if self.packed:
            return self._plane.unpack(state["phi"])
        return state["phi"]

    def evaluator(self):
        """The trainer's meta-evaluator, for `evaluate_meta`."""
        return self._evaluator

    def _stage(self, stream):
        """Host half of one round: sample, then move to the device."""
        tb = stream.next()

        def dp(a):
            return torch.as_tensor(a, device=self.device)

        return ((dp(tb.support_x), dp(tb.support_y)),
                (dp(tb.query_x), dp(tb.query_y)),
                dp(tb.weight) if self.weighted else None)

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

        engine = AsyncRoundEngine(
            stage=lambda: self._stage(stream),
            step=lambda st, a: self._step(st, *a),
            comm=self.comm, history=self.history,
            flush_every=self.flush_every)
        return engine.run(state, rounds, eval_every=eval_every,
                          evaluate=evaluate, log=log)
