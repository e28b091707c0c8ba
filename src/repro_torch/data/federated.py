"""Federated dataset abstraction (numpy), the port's own copy of
`repro/data/federated.py:22-187`.

A federated dataset is a list of clients, each holding local (x, y)
arrays. Every client doubles as a meta-learning *task*: its data is split
into a disjoint support set (inner/local training) and query set
(evaluation / meta-gradient), following the paper's evaluation scheme
(§4.1): 80/10/10 client split into train/val/test clients, and a support
fraction p per client.

The sampling code is the reference's, call for call, so a given seed
gives the same arrays and advances a `RandomState` the same way. Batches
are padded to fixed shapes. `FederatedDataset.view`/`stats` and
`assemble_task_batch` (population plane) wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np


@dataclasses.dataclass
class ClientData:
    x: np.ndarray  # (n, ...) features
    y: np.ndarray  # (n,) int labels

    @property
    def n(self) -> int:
        return len(self.y)


class TaskBatch(NamedTuple):
    """A fixed-shape batch of m client tasks."""
    support_x: np.ndarray  # (m, S, ...)
    support_y: np.ndarray  # (m, S)
    query_x: np.ndarray    # (m, Q, ...)
    query_y: np.ndarray    # (m, Q)
    # weights for weighted server aggregation (∝ #local examples, paper A.2)
    weight: np.ndarray     # (m,)
    # true per-client query-set sizes *before* the fixed-shape resample —
    # the §4.1 "accuracy w.r.t. all data points" evaluation weights each
    # client by how many query examples it actually holds
    query_count: np.ndarray = None  # (m,) int
    # the picked client indices behind the m rows (recorded from a draw
    # the sampler already makes)
    client_idx: np.ndarray = None  # (m,) int


@dataclasses.dataclass
class FederatedDataset:
    clients: list[ClientData]
    num_classes: int
    name: str = "federated"

    def __post_init__(self):
        assert len(self.clients) > 0

    def split_clients(self, seed: int = 0,
                      fractions: Sequence[float] = (0.8, 0.1, 0.1)):
        """80/10/10 train/val/test split over *clients* (paper §4.1)."""
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(self.clients))
        n = len(idx)
        n_train = int(fractions[0] * n)
        n_val = int(fractions[1] * n)
        train = [self.clients[i] for i in idx[:n_train]]
        val = [self.clients[i] for i in idx[n_train:n_train + n_val]]
        test = [self.clients[i] for i in idx[n_train + n_val:]]
        return train, val, test


def support_query_split(client: ClientData, support_frac: float,
                        rng: np.random.RandomState):
    """Disjoint support/query split of one client's local data."""
    n = client.n
    perm = rng.permutation(n)
    n_sup = max(1, min(n - 1, int(round(support_frac * n))))
    sup = perm[:n_sup]
    qry = perm[n_sup:]
    return (client.x[sup], client.y[sup]), (client.x[qry], client.y[qry])


def _resample_to(x: np.ndarray, y: np.ndarray, size: int,
                 rng: np.random.RandomState):
    """Fixed-size batch from a variable-size set (sample w/ replacement
    when short, subsample when long) — keeps batch shapes fixed."""
    n = len(y)
    if n >= size:
        idx = rng.choice(n, size=size, replace=False)
    else:
        idx = rng.choice(n, size=size, replace=True)
    return x[idx], y[idx]


@dataclasses.dataclass
class TaskStream:
    """The task-sampling stream one trainer consumes: exactly one
    `sample_task_batch` per `next()`, drawn from the trainer's seeded
    `RandomState` with the call pattern every trainer shares (one batch
    per round), advanced sequentially."""
    clients: list
    m: int
    support_frac: float
    support_size: int
    query_size: int
    rng: np.random.RandomState

    def next(self) -> TaskBatch:
        return sample_task_batch(self.clients, self.m, self.support_frac,
                                 self.support_size, self.query_size, self.rng)

    def take(self, k: int) -> list[TaskBatch]:
        return [self.next() for _ in range(k)]


def stack_task_batches(tbs: Sequence[TaskBatch]) -> TaskBatch:
    """k TaskBatches -> one TaskBatch with a leading (k,) round axis on
    every field — the stacked buffer the fused-K round mode scans over.
    Optional fields that any batch leaves as None stay None."""
    def stk(f):
        vals = [getattr(tb, f) for tb in tbs]
        return None if any(v is None for v in vals) else np.stack(vals)

    return TaskBatch(*(stk(f) for f in TaskBatch._fields))


def sample_task_batch(clients: list[ClientData], m: int, support_frac: float,
                      support_size: int, query_size: int,
                      rng: np.random.RandomState) -> TaskBatch:
    """Sample m clients uniformly and build a fixed-shape TaskBatch."""
    picks = rng.choice(len(clients), size=m, replace=len(clients) < m)
    sx, sy, qx, qy, w, qc = [], [], [], [], [], []
    for ci in picks:
        c = clients[ci]
        (a, b), (p, q) = support_query_split(c, support_frac, rng)
        qc.append(len(q))
        a, b = _resample_to(a, b, support_size, rng)
        p, q = _resample_to(p, q, query_size, rng)
        sx.append(a); sy.append(b); qx.append(p); qy.append(q)
        w.append(c.n)
    w = np.asarray(w, np.float32)
    return TaskBatch(np.stack(sx), np.stack(sy), np.stack(qx), np.stack(qy),
                     w / w.sum(), np.asarray(qc, np.int64),
                     np.asarray(picks, np.int64))
