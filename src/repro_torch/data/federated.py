"""Federated dataset abstraction (numpy), the port's own copy of
`repro/data/federated.py`.

A federated dataset is a list of clients, each holding local (x, y)
arrays. Every client doubles as a meta-learning *task*: its data is split
into a disjoint support set (inner/local training) and query set
(evaluation / meta-gradient), following the paper's evaluation scheme
(§4.1): 80/10/10 client split into train/val/test clients, and a support
fraction p per client.

The sampling code is the reference's, call for call, so a given seed
gives the same arrays and advances a `RandomState` the same way. Batches
are padded to fixed shapes. `assemble_task_batch` builds the population
plane's partial round: the arrived clients, zero-weight padded to m rows.
The lazy population (`data/registry.py`) has the same read surface.
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

    def view(self, transform, num_classes: int | None = None,
             name: str | None = None) -> "FederatedDataset":
        """A per-client re-labelled/re-featured view of the same dataset.

        ``transform(client) -> ClientData`` runs on every client and MUST
        preserve client order and per-client example counts ``n``. Under
        that contract a view consumes the same seeded sampling streams as
        the original (`sample_task_batch` draws depend only on the client
        count and each client's ``n``), which lets the experiment plane
        run FedMeta on a local-label view and FedAvg on the global view
        of one dataset.
        """
        clients = []
        for c in self.clients:
            t = transform(c)
            if t.n != c.n:
                raise ValueError("view transform must preserve client "
                                 f"sizes (got {t.n}, want {c.n})")
            clients.append(t)
        return FederatedDataset(clients, num_classes or self.num_classes,
                                name=name or self.name)

    def stats(self) -> dict:
        ns = np.array([c.n for c in self.clients])
        classes = np.array([len(np.unique(c.y)) for c in self.clients])
        return {
            "clients": len(self.clients),
            "samples": int(ns.sum()),
            "classes": self.num_classes,
            "samples_per_client_mean": float(ns.mean()),
            "samples_per_client_std": float(ns.std()),
            "classes_per_client_min": int(classes.min()),
            "classes_per_client_max": int(classes.max()),
        }


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


def assemble_task_batch(shards, m: int, support_frac: float,
                        support_size: int, query_size: int,
                        rng: np.random.RandomState,
                        weighted: bool = True, probe=None) -> TaskBatch:
    """Fixed-shape TaskBatch from pre-picked *arrived* client shards,
    zero-weight padded to ``m`` rows (the population plane's partial
    round).

    The first ``len(shards)`` rows are the arrived clients in arrival
    order, weighted by data count (or uniformly with ``weighted=False``)
    and renormalized over the arrived set; the remaining rows are copies
    of row 0 with weight 0, which the `masked_mean` aggregation (Σ w·g /
    Σ w over w > 0 rows) and the weighted metrics ignore. An empty
    arrived set (``probe`` supplies the row shapes: any client of the
    same dataset) gives an all-zero weight vector: the step's weight
    normalization then goes non-finite and the guard skips the round.
    The draws are the reference's, call for call.
    """
    a = len(shards)
    if a > m:
        raise ValueError(f"need at most {m} arrived shards, got {a}")
    if a == 0 and probe is None:
        raise ValueError("empty arrived set needs a shape probe client")
    sx, sy, qx, qy, w, qc = [], [], [], [], [], []
    for c in (shards if a else [probe]):
        (s_x, s_y), (q_x, q_y) = support_query_split(c, support_frac, rng)
        qc.append(len(q_y))
        s_x, s_y = _resample_to(s_x, s_y, support_size, rng)
        q_x, q_y = _resample_to(q_x, q_y, query_size, rng)
        sx.append(s_x); sy.append(s_y); qx.append(q_x); qy.append(q_y)
        w.append(c.n if weighted else 1.0)
    if a == 0:                   # the probe row is itself a zero-weight pad
        w[0] = 0.0; qc[0] = 0
    for _ in range(m - max(a, 1)):  # zero-weight pads (copies of row 0)
        sx.append(sx[0]); sy.append(sy[0])
        qx.append(qx[0]); qy.append(qy[0])
        w.append(0.0); qc.append(0)
    w = np.asarray(w, np.float32)
    s = w.sum()
    return TaskBatch(np.stack(sx), np.stack(sy), np.stack(qx), np.stack(qy),
                     w / s if s > 0 else w, np.asarray(qc, np.int64))
