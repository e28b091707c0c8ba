"""Lazy client registry: bounded-memory federated populations (numpy),
the port's own copy of `repro/data/registry.py`.

`FederatedDataset` materializes every client up front, which is fine at
the experiment scales (~10^2 clients) and hopeless at the paper's
deployment scale of 10^5–10^6 mobile devices. `ClientRegistry` has the
same read surface (`len()`, integer indexing: everything
`sample_task_batch` and the evaluators read) with clients synthesized on
demand from a per-client source and held in a bounded LRU host cache,
so resident memory is O(cache), not O(population).

Three sources:

  * `SequentialClientSource` replays the eager generator's sequential
    `RandomState`: construction runs the generator once and snapshots
    the rng state before each client, and `get(i)` re-runs client i's
    body from its snapshot. Every draw is the one the eager loop made,
    so a lazy dataset in this mode is bitwise equal to the eager one.
    Cost: one generation pass at construction and ~2.5 KB of rng state
    a client.
  * `IndependentClientSource` seeds client i's rng in O(1) from
    `SeedSequence((seed, i))`: no construction pass, no per-client
    state, any population size. Its draws are not the sequential
    stream's; they are the reference's, client for client.
  * `ShardIndexSource` loads `client_%08d.npz` shards from an index
    directory written by `save_shards` (either package's).

`split_clients` and `view` mirror the eager dataset: splits are
`RegistryView`s (index views, nothing materializes), and views apply an
order- and size-preserving per-client transform lazily, under the same
size check as `FederatedDataset.view`.

Thread safety: `__getitem__` is safe under concurrent access (the worker
pool materializes clients from K threads); an in-flight map makes sure a
client is synthesized once even when K workers race for it.
"""
from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset


def _seeded_rng(*entropy) -> np.random.RandomState:
    """O(1) per-client RandomState from a SeedSequence entropy tuple."""
    return np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence(entropy)))


class SequentialClientSource:
    """Bitwise-eager lazy source: per-client rng-state snapshots of the
    eager generator's sequential stream."""

    def __init__(self, body: Callable, num_clients: int,
                 rng: np.random.RandomState, warm: Callable = None):
        self._body = body
        self.num_clients = num_clients
        self._snaps = []
        for i in range(num_clients):
            self._snaps.append(rng.get_state())
            c = body(rng)          # advance the stream exactly as eager
            if warm is not None:
                warm(i, c)         # the construction pass warms the cache

    def get(self, i: int) -> ClientData:
        rng = np.random.RandomState(0)   # state replaced before any draw
        rng.set_state(self._snaps[i])
        return self._body(rng)


class IndependentClientSource:
    """O(1) lazy source: client i's rng is seeded from
    `SeedSequence((seed, i))`, for 10^5–10^6 clients."""

    def __init__(self, body: Callable, num_clients: int, seed: int):
        self._body = body
        self.num_clients = num_clients
        self.seed = seed

    def get(self, i: int) -> ClientData:
        return self._body(_seeded_rng(self.seed, i))


class ShardIndexSource:
    """On-disk shard index: `client_%08d.npz` files and `index.json`
    written by `save_shards`."""

    def __init__(self, shard_dir: str):
        self.shard_dir = shard_dir
        with open(os.path.join(shard_dir, "index.json")) as f:
            self.index = json.load(f)
        self.num_clients = int(self.index["num_clients"])

    def get(self, i: int) -> ClientData:
        path = os.path.join(self.shard_dir, f"client_{i:08d}.npz")
        with np.load(path) as z:
            return ClientData(z["x"], z["y"])


class ClientRegistry:
    """Lazy client population behind a bounded, thread-safe LRU cache.

    Sequence protocol: ``len(reg)`` and ``reg[i]`` (negative indices and
    slices work; a slice is a `RegistryView` and nothing materializes).
    ``cache_clients=None`` is unbounded (every touched client stays
    resident); an integer bounds the resident set, and
    `cache_stats()["peak_resident"]` shows it held.

    ``self._lock`` is a leaf lock: it guards the cache dict, the
    in-flight map and the counters, and is never held across a blocking
    call. The in-flight ``Event.wait`` and the ``source.get(i)``
    synthesis run with it released, so the worker synthesizing client i
    can always reach `_insert` (which takes the lock to publish and
    ``set()`` the Event).
    """

    def __init__(self, source, num_classes: int, name: str = "registry",
                 cache_clients: Optional[int] = None):
        if cache_clients is not None and cache_clients < 1:
            raise ValueError("cache_clients must be >= 1 (or None)")
        self._source = source
        self.num_classes = num_classes
        self.name = name
        self.cache_clients = cache_clients
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._hits = self._misses = self._evictions = 0
        self._peak = 0

    def __len__(self) -> int:
        return self._source.num_clients

    def __getitem__(self, i):
        if isinstance(i, slice):
            return RegistryView(self, range(*i.indices(len(self))))
        i = int(i)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        while True:
            with self._lock:
                if i in self._cache:
                    self._hits += 1
                    self._cache.move_to_end(i)
                    return self._cache[i]
                ev = self._inflight.get(i)
                if ev is None:
                    self._inflight[i] = threading.Event()
                    self._misses += 1
                    break
            ev.wait()          # another thread is synthesizing client i
        try:
            c = self._source.get(i)
        except BaseException:
            with self._lock:
                self._inflight.pop(i).set()
            raise
        self._insert(i, c)
        return c

    def _insert(self, i: int, c: ClientData):
        with self._lock:
            self._cache[i] = c
            self._cache.move_to_end(i)
            cap = self.cache_clients
            while cap is not None and len(self._cache) > cap:
                self._cache.popitem(last=False)
                self._evictions += 1
            self._peak = max(self._peak, len(self._cache))
            ev = self._inflight.pop(i, None)
            if ev is not None:
                ev.set()

    def cache_stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "resident": len(self._cache),
                    "peak_resident": self._peak,
                    "cache_clients": self.cache_clients}

    def split_clients(self, seed: int = 0,
                      fractions: Sequence[float] = (0.8, 0.1, 0.1)):
        """`FederatedDataset.split_clients`'s permutation: the same seed
        gives the same client-index split, as index views."""
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(self))
        n = len(idx)
        n_train = int(fractions[0] * n)
        n_val = int(fractions[1] * n)
        return (RegistryView(self, idx[:n_train].tolist()),
                RegistryView(self, idx[n_train:n_train + n_val].tolist()),
                RegistryView(self, idx[n_train + n_val:].tolist()))

    def view(self, transform, num_classes: Optional[int] = None,
             name: Optional[str] = None) -> "RegistryView":
        """Lazy `FederatedDataset.view`: the transform runs on each
        access, under the same size-preserving contract."""
        return RegistryView(self, range(len(self)), transform=transform,
                            num_classes=num_classes or self.num_classes,
                            name=name or self.name)

    def materialize(self) -> FederatedDataset:
        """Eager snapshot (small populations and tests only)."""
        return FederatedDataset([self[i] for i in range(len(self))],
                                self.num_classes, name=self.name)

    def stats(self, max_clients: Optional[int] = None) -> dict:
        """`FederatedDataset.stats` over the first ``max_clients``
        clients (None = all: materializes the population once)."""
        k = len(self) if max_clients is None else min(max_clients,
                                                     len(self))
        ns = np.array([self[i].n for i in range(k)])
        classes = np.array([len(np.unique(self[i].y)) for i in range(k)])
        return {
            "clients": len(self), "sampled": k,
            "samples": int(ns.sum()), "classes": self.num_classes,
            "samples_per_client_mean": float(ns.mean()),
            "samples_per_client_std": float(ns.std()),
            "classes_per_client_min": int(classes.min()),
            "classes_per_client_max": int(classes.max()),
        }


def _checked(transform, c: ClientData) -> ClientData:
    t = transform(c)
    if t.n != c.n:
        raise ValueError("view transform must preserve client sizes "
                         f"(got {t.n}, want {c.n})")
    return t


class RegistryView:
    """Index (and optional transform) view of a `ClientRegistry`: the
    lazy split and view lists. Sequence protocol; a `view` of a view
    chains the transforms."""

    def __init__(self, base, indices, transform=None,
                 num_classes: Optional[int] = None,
                 name: Optional[str] = None):
        self._base = base
        self._indices = list(indices)
        self._transform = transform
        self.num_classes = num_classes or base.num_classes
        self.name = name or getattr(base, "name", "registry-view")

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, j):
        if isinstance(j, slice):
            return RegistryView(self._base, self._indices[j],
                                transform=self._transform,
                                num_classes=self.num_classes,
                                name=self.name)
        c = self._base[self._indices[j]]
        if self._transform is not None:
            return _checked(self._transform, c)
        return c

    def view(self, transform, num_classes: Optional[int] = None,
             name: Optional[str] = None) -> "RegistryView":
        prev = self._transform

        def chained(c):
            return transform(c if prev is None else _checked(prev, c))

        return RegistryView(self._base, self._indices, transform=chained,
                            num_classes=num_classes or self.num_classes,
                            name=name or self.name)


def registry_from_body(body: Callable, num_clients: int, num_classes: int,
                       name: str, *, rng: np.random.RandomState = None,
                       seed: int = 0, independent: bool = False,
                       cache_clients: Optional[int] = None
                       ) -> ClientRegistry:
    """A `ClientRegistry` over a per-client generator body
    ``body(rng) -> ClientData``.

    ``independent=False`` (default) consumes ``rng`` sequentially, so the
    registry is bitwise equal to the eager generator (the construction
    pass also warms the cache through the bounded insert);
    ``independent=True`` seeds each client in O(1) from ``seed``.
    """
    if independent:
        return ClientRegistry(IndependentClientSource(body, num_clients,
                                                      seed),
                              num_classes, name=name,
                              cache_clients=cache_clients)
    if rng is None:
        raise ValueError("sequential registry needs the generator's rng "
                         "(independent=False)")
    reg = ClientRegistry(None, num_classes, name=name,
                         cache_clients=cache_clients)
    reg._source = SequentialClientSource(body, num_clients, rng,
                                         warm=reg._insert)
    return reg


def save_shards(clients, out_dir: str, num_classes: int,
                name: str = "shards") -> str:
    """Write a Sequence of clients as an on-disk shard index
    (`client_%08d.npz` + `index.json`); returns the index path."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(clients)
    for i in range(n):
        c = clients[i]
        np.savez(os.path.join(out_dir, f"client_{i:08d}.npz"),
                 x=c.x, y=c.y)
    path = os.path.join(out_dir, "index.json")
    with open(path, "w") as f:
        json.dump({"num_clients": n, "num_classes": num_classes,
                   "name": name}, f)
    return path


def load_shard_registry(shard_dir: str,
                        cache_clients: Optional[int] = None
                        ) -> ClientRegistry:
    """Open an on-disk shard index as a lazy `ClientRegistry`."""
    src = ShardIndexSource(shard_dir)
    return ClientRegistry(src, int(src.index["num_classes"]),
                          name=str(src.index.get("name", "shards")),
                          cache_clients=cache_clients)
