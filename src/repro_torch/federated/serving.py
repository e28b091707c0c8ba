"""Personalized serving plane: adaptation-on-demand (paper §3.2).

Counterpart of `repro/federated/serving.py`. A request carries a
support set D_S^u; the server adapts the meta-learned θ to that client
with the same fused inner-update kernel that training uses (K1), then
answers the prompt with θ_u through prefill (K7) and decode (K8).

  TrafficModel      seeded synthetic open-loop traffic, a pure function
                    of (seed, request id): the reference's draws, made
                    here with the port's own copy of `_draw_rng`, so the
                    two packages generate the same request stream.
  AdaptationCache   bounded thread-safe LRU of adapted flat rows φ_u,
                    keyed (client, φ-version, support digest).
  ServingEngine     batches cache-miss adaptations through
                    `MetaAlgorithm.adapt_packed_batch` on the (C, N)
                    plane, then generates each prompt-shape group as
                    one `torch.func.vmap` of `generate` (the reference's
                    `jax.jit(jax.vmap(gen_one))`), each request under its
                    own θ_u: the group's unpacked bf16 parameter trees
                    are stacked and mapped, so every projection is a
                    batched matmul, and K7, K8 and K9 fold the request
                    axis into their batch axis (`kernels/_vmap.py`) and
                    launch once a layer and step for the whole group.
                    A group of one runs `generate` unmapped.

Rows are independent (row c only enters client c's loss), so a served
φ_u equals that client's solo `adapt_packed` bit for bit at any batch
size — pinned on the card by chip_smoke.py.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.convert import numpy_view
from repro_torch.utils.flat import dtype_name, plane_for
from repro_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["TrafficModel", "AdaptationCache", "ServeRequest",
           "ServingEngine", "ServeReport", "support_digest"]


def _draw_rng(*entropy) -> np.random.RandomState:
    """Stateless keyed stream (copy of `repro/federated/population.py`
    `_draw_rng`)."""
    return np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence(entropy)))


# ----------------------------------------------------------- traffic model

@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One serving request: client u asks for `prompt` to be continued
    under its personalized model, supplying the support set to adapt
    with. `arrival` is the (simulated) arrival time in seconds."""
    rid: int
    client: int
    arrival: float
    support: Any
    prompt: Any = None


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Seeded synthetic serving traffic: Poisson arrivals at `rate`
    requests/s, Zipf-skewed clients (popularity ∝ rank^-hot_skew), a
    per-client support-set size from `support_sizes`, and a per-client
    `think_time` floor between requests. Every field draws from its own
    salted `_draw_rng` stream, so `arrival_table(n)` is content-stable
    under extension and identical to the reference's."""
    num_clients: int = 32
    rate: float = 8.0
    support_sizes: tuple = (2, 4)
    hot_skew: float = 1.0
    think_time: float = 0.0
    seed: int = 0

    _TABLE_SALT = 0x5EF1
    _SUPPORT_SALT = 0x5EF2
    _PROMPT_SALT = 0x5EF3

    def arrival_table(self, n: int) -> tuple:
        """First `n` arrivals as ((rid, client, time, support_size), ...),
        sorted by (time, rid)."""
        gaps = _draw_rng(self.seed, self._TABLE_SALT, 0).exponential(
            1.0 / self.rate, size=n)
        times = np.cumsum(gaps)
        ranks = np.arange(self.num_clients, dtype=np.float64)
        w = (ranks + 1.0) ** -self.hot_skew
        clients = _draw_rng(self.seed, self._TABLE_SALT, 1).choice(
            self.num_clients, size=n, p=w / w.sum())
        by_client = _draw_rng(self.seed, self._TABLE_SALT, 2).choice(
            np.asarray(self.support_sizes), size=self.num_clients)
        sizes = by_client[clients]
        if self.think_time > 0.0:
            last: dict = {}
            for i in range(n):          # rid order == raw arrival order
                c = int(clients[i])
                floor = last.get(c)
                if floor is not None and times[i] < floor + self.think_time:
                    times[i] = floor + self.think_time
                last[c] = times[i]
        order = sorted(range(n), key=lambda i: (times[i], i))
        return tuple((i, int(clients[i]), float(times[i]), int(sizes[i]))
                     for i in order)

    def requests(self, n: int, make_support: Callable,
                 make_prompt: Optional[Callable] = None) -> tuple:
        """Materialize the first `n` requests. `make_support(rng, size)`
        (and optionally `make_prompt(rng)`) build the payloads from a
        stateless keyed RandomState — supports per *client*, prompts per
        *request* — so content never depends on processing order."""
        out = []
        for rid, client, t, size in self.arrival_table(n):
            sup = make_support(
                _draw_rng(self.seed, self._SUPPORT_SALT, client), size)
            prm = (make_prompt(_draw_rng(self.seed, self._PROMPT_SALT, rid))
                   if make_prompt is not None else None)
            out.append(ServeRequest(rid=rid, client=client, arrival=t,
                                    support=sup, prompt=prm))
        return tuple(out)


# -------------------------------------------------------- adaptation cache

def _dtype_str(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def support_digest(support) -> str:
    """Content digest of a support tree (shape, dtype and bytes of every
    leaf, in canonical order) — the cache-key component that invalidates
    a client's cached φ_u when its data changes. Hashes numpy views of
    the leaves, so the string equals the reference's for the same
    support."""
    h = hashlib.sha1()
    for leaf in tree_leaves(support):
        a = numpy_view(leaf)
        h.update(str(a.shape).encode())
        h.update(_dtype_str(leaf).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class AdaptationCache:
    """Bounded thread-safe LRU of adapted flat rows, keyed
    (client, φ-version, support digest).

    ``self._lock`` is a leaf lock guarding only the store and the
    counters, never held across a blocking call; ``stats()`` reports
    ``peak_resident`` to prove the bound. ``capacity=None`` means
    unbounded. At full SmolLM-360M width a row is 1.45 GB of f32."""

    def __init__(self, capacity: Optional[int] = 64):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        self.capacity = capacity
        self._store: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._hits = self._misses = self._evictions = 0
        self._peak = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def get(self, key):
        with self._lock:
            if key in self._store:
                self._hits += 1
                self._store.move_to_end(key)
                return self._store[key]
            self._misses += 1
            return None

    def put(self, key, row) -> None:
        with self._lock:
            self._store[key] = row
            self._store.move_to_end(key)
            cap = self.capacity
            while cap is not None and len(self._store) > cap:
                self._store.popitem(last=False)
                self._evictions += 1
            self._peak = max(self._peak, len(self._store))

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "resident": len(self._store),
                    "peak_resident": self._peak,
                    "capacity": self.capacity}

    def clear(self) -> None:
        """Drop entries and counters (warm-up -> measure reset)."""
        with self._lock:
            self._store.clear()
            self._hits = self._misses = self._evictions = 0
            self._peak = 0


# ----------------------------------------------------------- serve report

@dataclasses.dataclass
class ServeReport:
    """Per-request records + wall time for one `ServingEngine.serve`."""
    records: list
    wall_s: float
    cache_stats: dict

    def summary(self) -> dict:
        n = len(self.records)
        hits = sum(1 for r in self.records if r["hit"])
        adapt = np.asarray([r["adapt_ms"] for r in self.records], np.float64)
        out = {"requests": n, "hits": hits, "misses": n - hits,
               "wall_s": self.wall_s,
               "requests_per_s": (n / self.wall_s if self.wall_s > 0
                                  else float("inf")),
               "adapt_p50_ms": float(np.percentile(adapt, 50)) if n else 0.0,
               "adapt_p99_ms": float(np.percentile(adapt, 99)) if n else 0.0,
               "cache": self.cache_stats}
        dec = np.asarray([r["decode_ms"] for r in self.records
                          if r.get("decode_ms") is not None], np.float64)
        if dec.size:
            out["decode_p50_ms"] = float(np.percentile(dec, 50))
            out["decode_p99_ms"] = float(np.percentile(dec, 99))
        return out


# ----------------------------------------------------------- serving engine

def _shape_sig(tree) -> tuple:
    return tuple((tuple(np.shape(x)), _dtype_str(x)) for x in tree_leaves(tree))


class ServingEngine:
    """Adaptation-on-demand: batch concurrent support-set adaptations on
    the training kernel's (C, N) plane, cache φ_u rows, serve decode.

    `serve(requests)` processes requests in (arrival, rid) order:

      1. cache lookup under (client, φ-version, support digest) — a hit
         skips adaptation (adapt_ms = 0);
      2. misses are bucketed by support shape signature, and a bucket is
         flushed through `adapt_packed_batch` when it holds `adapt_batch`
         requests; partial buckets at the end are padded to
         `adapt_batch` by repeating the last request (rows are
         independent, so padding never perturbs real rows);
      3. with `max_new_tokens > 0`, requests are grouped by prompt shape
         and each group is decoded greedily in one `generate_batch`,
         each request under its own θ_u; a record's decode_ms is the
         wall time of its whole group, as in the reference.

    Times are host wall clock around work that ends in a device
    synchronize. The engine is a single-threaded orchestrator; only
    `AdaptationCache` is shared."""

    def __init__(self, algo, phi, *, adapt_batch: int = 4,
                 adapt_steps: Optional[int] = None,
                 cache: Optional[AdaptationCache] = None,
                 prefill_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None,
                 impl: Optional[str] = None, phi_version: int = 0,
                 device="cuda"):
        if adapt_batch < 1:
            raise ValueError("adapt_batch must be >= 1")
        self.algo = algo
        self.adapt_batch = int(adapt_batch)
        self.adapt_steps = adapt_steps
        self.cache = cache if cache is not None else AdaptationCache()
        self.phi_version = int(phi_version)
        self.device = torch.device(device)
        self._phi = phi
        self.plane = plane_for(phi["theta"])
        self._prefill_fn = prefill_fn
        self._decode_fn = decode_fn
        self._impl = impl

    # -- φ lifecycle ------------------------------------------------------

    def publish_phi(self, phi) -> None:
        """Install a fresh meta-initialization. Bumps the φ-version so
        every cached row goes stale by keying."""
        self._phi = phi
        self.phi_version += 1

    def unpack_row(self, row):
        """Adapted flat row -> parameter tree (serving-side θ_u)."""
        return self.plane.unpack(row)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(self.device)

    # -- adaptation -------------------------------------------------------

    def _flush(self, items: list, records: dict) -> None:
        t0 = time.perf_counter()
        reqs = [r for r, _ in items]
        padded = reqs + [reqs[-1]] * (self.adapt_batch - len(reqs))
        supports = tree_map(
            lambda *xs: torch.stack([self._to_device(x) for x in xs]),
            *[r.support for r in padded])
        plane_rows = self.algo.adapt_packed_batch(
            self._phi, supports, self.adapt_steps, impl=self._impl,
            plane=self.plane)
        # own copies of the real rows, so the cache does not pin the plane
        rows = [plane_rows[i].clone() for i in range(len(items))]
        del plane_rows
        self._sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for row, (req, key) in zip(rows, items):
            self.cache.put(key, row)
            records[req.rid] = {"rid": req.rid, "client": req.client,
                                "arrival": req.arrival, "hit": False,
                                "adapt_ms": wall_ms, "batch_fill": len(items),
                                "row": row}

    # -- decode -----------------------------------------------------------

    def _generate(self, params, prompt, max_new_tokens: int):
        """The reference's `gen_one` on an unpacked θ_u: prefill
        (capacity = prompt length), then `max_new_tokens - 1` greedy
        decode steps. The cache's length stays a Python int, so the
        same code runs under `torch.func.vmap`."""
        logits, cache = self._prefill_fn(params, prompt[None])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)       # (1,)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self._decode_fn(params, cache, tok[:, None])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out)

    @torch.no_grad()
    def generate(self, row, prompt, max_new_tokens: int):
        """Greedy decode of one prompt under the adapted row: prefill
        (capacity = prompt length, as the reference's `gen_one`), then
        `max_new_tokens - 1` decode steps. Returns (max_new_tokens,) int32."""
        return self._generate(self.plane.unpack(row), prompt, max_new_tokens)

    @torch.no_grad()
    def generate_batch(self, rows, prompts, max_new_tokens: int):
        """`generate` mapped over a group of R requests with one
        `torch.func.vmap`, as the reference's `jax.jit(jax.vmap(gen_one))
        (rows, prompts)`. rows: R adapted (n_padded,) rows; prompts:
        (R, L) int32. The map runs over the stacked unpacked parameter
        trees (`FlatPlane.unpack_rows`: R bf16 trees, not R more f32
        rows). A group of one runs `generate` itself: the map would
        fold nothing and costs host time on every op. Returns
        (R, max_new_tokens) int32."""
        if len(rows) == 1:
            return self.generate(rows[0], prompts[0], max_new_tokens)[None]
        params = self.plane.unpack_rows(rows)
        gen = functools.partial(self._generate,
                                max_new_tokens=max_new_tokens)
        return torch.func.vmap(gen)(params, prompts)

    # -- the serve loop ---------------------------------------------------

    def serve(self, requests, *, max_new_tokens: int = 0) -> ServeReport:
        """Serve a request stream (processed in (arrival, rid) order).
        Each record carries the adapted flat row under "row" and, when
        decoding, the generated tokens under "tokens"."""
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        t_start = time.perf_counter()
        records: dict = {}
        buckets: OrderedDict = OrderedDict()
        for req in reqs:
            key = (req.client, self.phi_version, support_digest(req.support))
            row = self.cache.get(key)
            if row is not None:
                records[req.rid] = {"rid": req.rid, "client": req.client,
                                    "arrival": req.arrival, "hit": True,
                                    "adapt_ms": 0.0, "batch_fill": 0,
                                    "row": row}
                continue
            sig = _shape_sig(req.support)
            buckets.setdefault(sig, []).append((req, key))
            if len(buckets[sig]) == self.adapt_batch:
                self._flush(buckets.pop(sig), records)
        for sig in list(buckets):       # insertion order — deterministic
            self._flush(buckets.pop(sig), records)

        if max_new_tokens > 0:
            if self._prefill_fn is None or self._decode_fn is None:
                raise ValueError("decode requested but the engine has no "
                                 "prefill_fn/decode_fn wired in")
            groups: OrderedDict = OrderedDict()
            for req in reqs:
                if req.prompt is not None:
                    groups.setdefault(tuple(np.shape(req.prompt)),
                                      []).append(req)
            for shape in list(groups):
                greqs = groups.pop(shape)
                prompts = torch.stack([self._to_device(r.prompt, torch.int32)
                                       for r in greqs])
                t0 = time.perf_counter()
                toks = self.generate_batch(
                    [records[r.rid]["row"] for r in greqs], prompts,
                    max_new_tokens).cpu().numpy()
                wall_ms = (time.perf_counter() - t0) * 1e3
                for i, r in enumerate(greqs):
                    records[r.rid]["tokens"] = toks[i]
                    records[r.rid]["decode_ms"] = wall_ms

        wall_s = time.perf_counter() - t_start
        return ServeReport(records=[records[r.rid] for r in reqs],
                           wall_s=wall_s, cache_stats=self.cache.stats())
