"""Federated Averaging baseline (McMahan et al. 2017) and FedAvg(Meta).
Counterpart of `repro/federated/fedavg.py`.

FedAvg: each sampled client runs ``local_steps`` minibatch steps of local
Adam (paper A.2) from the global model; the server replaces the global
model with the example-count-weighted average of the returned models —
a ``tensordot`` over the client axis, a plain product that stays a
PyTorch op as it stays XLA in the reference.

FedAvg(Meta) is an evaluation-time variant (paper §4.1): the global
model is fine-tuned on a test client's support set before it is scored
on the query set (``meta_eval=True`` / `finetune`).

The trainer runs on the same round loop as `FederatedTrainer`: one
`sample_task_batch` per round from ``RandomState(seed)``, the same call
pattern, so both trainers see the same client picks; the local
minibatch indices come from a separate ``RandomState(seed + 0x5EED)``
stream, byte-compatible with the reference's, so the picks are the
reference's exactly. `CommTracker` charges the full model both ways.

Randomness that the port cannot reproduce: the reference draws
`finetune`'s with-replacement indices with `jax.random.randint` from
``PRNGKey(seed)`` — the same indices for every client. The port draws
them from a `torch.Generator` seeded with ``seed``, again the same for
every client, and takes injected indices (``finetune_idx``) so parity
tests can hand in the reference's draw.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import _grad_tree
from repro_torch.core.fedmeta import (_client, _normalize_weights,
                                      _scan_chunks, _stack_metrics,
                                      _weighted_metrics)
from repro_torch.data.federated import TaskStream, sample_task_batch
from repro_torch.federated.async_engine import AsyncRoundEngine
from repro_torch.federated.comm import CommTracker, measure_client_flops
from repro_torch.optim import adam, sgd
from repro_torch.utils.pytree import (tree_add, tree_flatten, tree_map,
                                      tree_zeros_like)


@dataclasses.dataclass
class FedAvgTrainer:
    loss_fn: Callable
    eval_fn: Callable
    local_lr: float
    local_steps: int = 5
    local_optimizer: str = "adam"          # paper A.2 uses Adam locally
    name: str = "fedavg"
    # ---- driver-loop parity with FederatedTrainer --------------------
    train_clients: Optional[list] = None
    clients_per_round: int = 4
    support_frac: float = 0.5       # split recorded per batch; FedAvg
    support_size: int = 16          # trains on support+query combined
    query_size: int = 16
    weighted: bool = True           # paper A.2: weight by local data count
    client_chunk: Optional[int] = None   # chunks over the client axis
    local_batch_size: Optional[int] = None     # None = support_size
    finetune_batch_size: Optional[int] = None  # None = full support size
    meta_eval: bool = False         # FedAvg(Meta) scoring at eval time
    seed: int = 0
    flush_every: int = 1            # drain deferred metrics every k rounds
    device: str = "cuda"            # where θ, the batches and the steps live
    # injected (reps, bs) fine-tune indices (the reference's draw)
    finetune_idx: Optional[np.ndarray] = None
    prefetch_depth: int = 0         # the async slice's knob: must stay 0

    def __post_init__(self):
        if self.prefetch_depth:
            raise NotImplementedError(
                "FedAvgTrainer(prefetch_depth=...) is not ported yet: it "
                "joins the port with the async slice")
        if self.meta_eval and self.name == "fedavg":
            self.name = "fedavg(meta)"
        if torch.device(self.device).type == "cuda":
            # full-f32 convolutions and matmuls, deterministic cuDNN
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = True
        self._rng = np.random.RandomState(self.seed)
        self._local_rng = np.random.RandomState(self.seed + 0x5EED)
        self._evaluator = None
        self.comm: Optional[CommTracker] = None
        self.history: list = []

    def _opt(self):
        return (adam(self.local_lr) if self.local_optimizer == "adam"
                else sgd(self.local_lr))

    # ---- state ------------------------------------------------------
    def init(self, key, model_init, theta=None):
        """{"theta": model_init(key)}; ``theta`` (a tree on ``device``)
        stands in for the init — how a run starts from another
        package's initial parameters."""
        state = {"theta": model_init(key) if theta is None else theta}
        self.comm = CommTracker.for_state(state["theta"],
                                          self.clients_per_round)
        return state

    def init_state(self, key, model_init):
        return self.init(key, model_init)

    def phi_tree(self, state):
        """The global model as a tree (parity with FederatedTrainer)."""
        return state["theta"]

    def evaluator(self):
        """The trainer's global evaluator (fine-tuning when
        ``meta_eval``), for `evaluate_global`. Built lazily."""
        if self._evaluator is None:
            from repro_torch.federated.server import make_global_evaluator
            self._evaluator = make_global_evaluator(
                self.eval_fn, self.finetune if self.meta_eval else None)
        return self._evaluator

    # ---- client procedure -------------------------------------------
    def local_train(self, theta, batches):
        """batches: tree with a leading (steps,) axis of minibatches."""
        opt = self._opt()
        st = opt.init(theta)
        steps = tree_flatten(batches)[0][0].shape[0]
        for t in range(steps):
            batch = tree_map(lambda x, t=t: x[t], batches)
            g = _grad_tree(self.loss_fn, theta, batch)
            theta, st = opt.update(theta, g, st)
        return theta

    def finetune_indices(self, n: int, reps: int, bs: int) -> torch.Tensor:
        """(reps, bs) with-replacement indices into a support set of n:
        the injected ``finetune_idx``, else a draw from a generator
        seeded with ``seed`` (the same for every client)."""
        if self.finetune_idx is not None:
            idx = torch.tensor(np.asarray(self.finetune_idx),
                               dtype=torch.long)
            if tuple(idx.shape) != (reps, bs):
                raise ValueError(f"finetune_idx has shape {tuple(idx.shape)}"
                                 f", expected {(reps, bs)}")
            return idx
        gen = torch.Generator(device="cpu").manual_seed(self.seed)
        return torch.randint(0, n, (reps, bs), generator=gen)

    def finetune(self, theta, support, steps: int | None = None):
        """FedAvg(Meta): fine-tune on a test client's support set with a
        fresh with-replacement minibatch per step (paper A.2 local
        training)."""
        reps = steps or self.local_steps
        n = tree_flatten(support)[0][0].shape[0]
        bs = min(self.finetune_batch_size or n, n)
        idx = self.finetune_indices(n, reps, bs)
        batches = tree_map(lambda x: x[idx.to(x.device)], support)
        return self.local_train(theta, batches)

    # ---- server round -----------------------------------------------
    def _round(self, theta, batches, eval_batch, w):
        """Weighted model average over the client axis.

        batches: leading (m, steps, B, ...) local minibatches;
        eval_batch: optional (m, P, ...) data each locally trained model
        is scored on (train loss / accuracy); w: normalized (m,)."""

        def chunk_fn(b, e, wc):
            thetas, mets = [], []
            for u in range(wc.shape[0]):
                th = self.local_train(theta, _client(b, u))
                thetas.append(th)
                if e is not None:
                    with torch.no_grad():
                        loss, met = self.eval_fn(th, _client(e, u))
                    mets.append({"train_loss": loss, **met})
            stacked = tree_map(lambda *xs: torch.stack(xs), *thetas)
            partial = tree_map(
                lambda t: torch.tensordot(wc, t.float(), dims=1), stacked)
            metrics = (_weighted_metrics(wc, _stack_metrics(mets))
                       if mets else {})
            return partial, metrics

        m = tree_flatten(batches)[0][0].shape[0]
        if self.client_chunk and self.client_chunk < m:
            acc0 = tree_zeros_like(tree_map(lambda x: x.float(), theta))
            avg, metrics = _scan_chunks(chunk_fn, acc0, tree_add, batches,
                                        eval_batch, w, m, self.client_chunk)
        else:
            avg, metrics = chunk_fn(batches, eval_batch, w)
        new_theta = tree_map(lambda a, t: a.to(t.dtype), avg, theta)
        return new_theta, metrics

    def round_step(self, state, client_batches, weights=None):
        """client_batches: leading axes (m, steps, ...) on every leaf."""
        m, device = _leading_axis(client_batches)
        w = _normalize_weights(
            None if weights is None else torch.as_tensor(weights,
                                                         device=device),
            m, device)
        theta, _ = self._round(state["theta"], client_batches, None, w)
        return {"theta": theta}

    def _local_batches(self, tb):
        """Per-round local minibatches from the sampled clients' FULL
        local data (support + query — FedAvg has no query split, paper
        §4.1): (m, steps, B, ...) with per-step indices from the
        dedicated local stream."""
        px = np.concatenate([tb.support_x, tb.query_x], axis=1)
        py = np.concatenate([tb.support_y, tb.query_y], axis=1)
        m, pool = py.shape[:2]
        bs = min(self.local_batch_size or self.support_size, pool)
        idx = self._local_rng.randint(0, pool,
                                      size=(m, self.local_steps, bs))
        rows = np.arange(m)[:, None, None]
        return (px[rows, idx], py[rows, idx]), (px, py)

    def measure_flops(self, state):
        """FLOPs of one client's local training (`measure_client_flops`),
        on one sampled client; the draws advance both streams as the
        reference's do."""
        tb = sample_task_batch(self.train_clients, 1, self.support_frac,
                               self.support_size, self.query_size, self._rng)
        (bx, by), _ = self._local_batches(tb)
        batch = (torch.as_tensor(bx[0], device=self.device),
                 torch.as_tensor(by[0], device=self.device))
        fl = measure_client_flops(
            lambda b: self.local_train(state["theta"], b), batch)
        if self.comm:
            self.comm.flops_per_client = fl
        return fl

    def run(self, state, rounds: int, eval_every: int = 0,
            eval_clients=None, log: Callable = None):
        """The round loop of `FederatedTrainer.run`: one record per
        round, eval fields on eval rounds (FedAvg(Meta) fine-tunes at
        eval when ``meta_eval``)."""
        from repro_torch.federated.server import evaluate_global
        evaluator = self.evaluator()
        stream = TaskStream(self.train_clients, self.clients_per_round,
                            self.support_frac, self.support_size,
                            self.query_size, self._rng)

        def dp(a):
            return torch.as_tensor(a, device=self.device)

        def stage():
            tb = stream.next()
            (bx, by), (px, py) = self._local_batches(tb)
            w = _normalize_weights(dp(tb.weight) if self.weighted else None,
                                   len(tb.weight), self.device)
            return ((dp(bx), dp(by)), (dp(px), dp(py)), w)

        def step(st, args):
            theta, metrics = self._round(st["theta"], *args)
            return {"theta": theta}, metrics

        evaluate = None
        if eval_every and eval_clients is not None:
            def evaluate(st):
                acc, _, loss = evaluate_global(
                    self.eval_fn, st["theta"], eval_clients,
                    support_frac=self.support_frac,
                    support_size=self.support_size,
                    query_size=self.query_size, seed=self.seed,
                    evaluator=evaluator)
                return {"eval_acc": acc, "eval_loss": loss}

        engine = AsyncRoundEngine(stage=stage, step=step, comm=self.comm,
                                  history=self.history,
                                  flush_every=self.flush_every)
        return engine.run(state, rounds, eval_every=eval_every,
                          evaluate=evaluate, log=log)


def _leading_axis(tree):
    x = tree_flatten(tree)[0][0]
    return x.shape[0], x.device
