"""Async round engine: the pipelined host↔device round loop.
Counterpart of `repro/federated/async_engine.py`.

The synchronous loop pays three host↔device stalls a round: numpy task
sampling, blocking copies to the device, and a ``float(v)`` readback of
the metrics that drains the device before the next round is sampled.
The engine removes all three and leaves the math of the loop untouched:

  * **prefetch** — a background thread owns the trainer's `TaskStream`
    and stages the next ``prefetch_depth`` round blocks while the current
    one computes. The stream (and every other seeded host stream) advances
    on that one thread, in block order, so the run is the synchronous
    loop's under a fixed seed. On the card the producer copies pinned
    host buffers on a side stream (`DeviceStager`); the consumer's stream
    waits on the block's event before the step reads it.
    ``prefetch_depth=0`` stages inline, with no thread.
  * **deferred metrics** — a round's metrics stay device tensors in a
    pending list, drained to ``history`` every ``flush_every`` rounds, at
    eval rounds and at exit: the loop's only host sync.
  * **fused-K** — with ``fuse_rounds=K > 1`` the trainer stages K rounds
    as one stacked ``(K, ...)`` buffer and ``fused_step`` runs them back
    to back with no host sync between them (the reference's `lax.scan`
    over rounds); blocks end at every eval round (`plan_blocks`).

`StalenessConfig` simulates straggler clients whose meta-gradients
arrive late, discounted by ``discount**s``; the step-level wiring is in
`core/fedmeta.make_packed_meta_train_step`, this module owns the config
and the per-round pick (the reference's draws, draw for draw).
`WorkerPool` is the fault-tolerant pool of worker threads that
materializes client shards.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

PREFETCH_THREAD_NAME = "repro-round-prefetch"
WORKER_THREAD_NAME = "repro-pool-worker"


class PrefetchError(RuntimeError):
    """The prefetch producer failed permanently. Raised at the
    consumer's ``get()`` with ``__cause__`` chained to the producer's
    original exception, so its traceback survives the thread hop."""


class WorkerPoolError(PrefetchError):
    """A worker-pool task failed permanently (retries exhausted, task
    timeout, or dead pool). The message names the failing work; a task
    failure chains the worker's exception as ``__cause__``."""


def call_with_retry(fn, *, max_retries: int, backoff: float,
                    stop: Optional[threading.Event] = None):
    """Run ``fn()`` with bounded exponential-backoff retries
    (``backoff · 2^attempt`` seconds between attempts; ``fn`` must be
    retry-safe), the one retry loop of the prefetcher and the pool.

    Returns ``(None, result, attempts)`` on success,
    ``(exc, None, attempts)`` after exhaustion, or ``None`` if ``stop``
    was set before an attempt started."""
    for attempt in range(max(0, max_retries) + 1):
        if stop is not None and stop.is_set():
            return None
        try:
            return (None, fn(), attempt + 1)
        except BaseException as exc:
            if attempt >= max_retries:
                return (exc, None, attempt + 1)
            time.sleep(backoff * (2 ** attempt))
    return None  # unreachable


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """Simulated straggler clients with discount-weighted aggregation.

    Each round, ``fraction`` of the sampled clients straggle: the
    meta-gradient they computed against the current φ arrives ``delay``
    rounds later, weighted by its data-count weight times ``discount**s``
    (s = its rounds of staleness), and the round's weights renormalize
    over the rows aggregated. The pick draws from its own seeded stream
    (``seed``), so staleness never perturbs task sampling.

    ``jitter=True``: each straggler draws its own delay s ∈ [0, delay]
    (0 = joins its own round) and rejoins after s rounds at w·γ^s. With
    ``jitter=False`` the rng takes exactly the fixed path's draws.

    >>> cfg = StalenessConfig(delay=2, fraction=0.25, jitter=True)
    >>> strag, fresh, delays = cfg.pick(4, np.random.RandomState(0))
    >>> delays.shape == strag.shape and (delays <= 2).all()
    True
    """
    delay: int = 1          # s_max: rounds between training and arrival
    fraction: float = 0.25  # fraction of each round's clients that straggle
    discount: float = 0.5   # γ: an arrived gradient weighs w * γ^s
    jitter: bool = False    # per-straggler random delay in [0, delay]
    seed: int = 0

    def __post_init__(self):
        if self.delay < 1:
            raise ValueError("staleness delay must be >= 1")
        if not 0.0 <= self.fraction < 1.0:
            raise ValueError("straggler fraction must be in [0, 1)")

    def num_stragglers(self, m: int) -> int:
        """Per-round straggler count; at least one client stays fresh."""
        return max(0, min(m - 1, int(round(self.fraction * m))))

    def pick(self, m: int, rng: np.random.RandomState):
        """One round's pick as sorted int32 arrays: ``(straggler_idx,
        fresh_idx)``, plus each straggler's ``delays`` under jitter."""
        k = self.num_stragglers(m)
        perm = rng.permutation(m)
        sel = (np.sort(perm[:k]).astype(np.int32),
               np.sort(perm[k:]).astype(np.int32))
        if not self.jitter:
            return sel
        return sel + (rng.randint(0, self.delay + 1,
                                  size=k).astype(np.int32),)


class Staged:
    """A block staged on a side stream: the trainer's inputs, the event
    recorded after their copies, and the tensors the copies wrote (the
    pinned host sources stay referenced until the block is consumed)."""
    __slots__ = ("item", "event", "device", "tensors", "pinned")

    def __init__(self, item, event, device, tensors, pinned):
        self.item, self.event, self.device = item, event, device
        self.tensors, self.pinned = tensors, pinned

    def ready(self):
        """The inputs, once the current stream waits on their copies.
        Each staged tensor is marked as used by that stream, so the
        caching allocator cannot hand its memory out while the step
        still reads it."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)
        self.pinned = None
        return self.item


class DeviceStager:
    """Host → device copies of one block. On a CUDA device with
    ``side_stream=True`` (the prefetch thread's staging) every array is
    copied from pinned memory on a side stream, and `end` seals the block
    with an event; otherwise `put` is ``torch.as_tensor(a, device=...)``.
    One producer uses it at a time (the prefetch thread, or the caller
    when staging inline)."""

    def __init__(self, device, side_stream: bool = False):
        self.device = torch.device(device)
        self.side = (torch.cuda.Stream(self.device)
                     if side_stream and self.device.type == "cuda" else None)
        self._tensors, self._pinned = [], []

    def put(self, a, dtype=None):
        if self.side is None:
            return torch.as_tensor(a, dtype=dtype, device=self.device)
        host = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
        host = host.pin_memory()
        with torch.cuda.stream(self.side):
            t = host.to(self.device, non_blocking=True)
        self._tensors.append(t)
        self._pinned.append(host)
        return t

    def end(self, item):
        """Seal the block staged since the last `end`."""
        if self.side is None:
            return item
        event = torch.cuda.Event()
        event.record(self.side)
        out = Staged(item, event, self.device, self._tensors, self._pinned)
        self._tensors, self._pinned = [], []
        return out

    def abort(self):
        """Forget a failed attempt's copies: their memory is reused only
        by later work on the side stream, after the copies, and the
        caching host allocator keeps a pinned source until its copy is
        done."""
        self._tensors, self._pinned = [], []


class Prefetcher:
    """Bounded background producer of staged round blocks.

    ``produce(k)`` performs the host half of a k-round block — sampling
    and staging — and is only ever called on this one thread, in block
    order, so seeded streams advance exactly as they would inline. The
    queue holds at most ``depth`` staged blocks. Example::

        pf = Prefetcher(stage, sizes=[1, 1, 1], depth=2)
        try:
            for _ in range(3):
                staged = pf.get()       # blocks until produced
        finally:
            pf.close()                  # joins the thread, always

    Failure on either side releases the other:

      * a producer exception is re-raised at the ``get()`` of the failed
        block (``max_retries > 0`` wraps it in a `PrefetchError` naming
        the rounds, chained via ``__cause__``);
      * ``close()`` sets the stop flag, drains the queue so a blocked
        ``put`` sees it, and joins the thread;
      * a ``get()`` for a block a dead producer never staged raises
        (the stored producer error, else a `PrefetchError`) instead of
        blocking forever.

    ``max_retries`` re-calls ``produce(k)`` up to that many extra times
    with ``retry_backoff · 2^attempt`` seconds between, so ``produce``
    must leave its seeded streams where they started when it fails (the
    trainers snapshot and restore their rngs). ``first_round`` only
    labels error messages.

    Lock order: the handoff rides the queue and the stop Event;
    ``self._lock`` guards the stored producer error alone and is a leaf
    lock, never held around ``put``/``get`` or any blocking call.
    """

    def __init__(self, produce: Callable, sizes, depth: int, *,
                 max_retries: int = 0, retry_backoff: float = 0.05,
                 first_round: int = 1):
        self._produce = produce
        self._sizes = list(sizes)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._max_retries = max(0, max_retries)
        self._retry_backoff = retry_backoff
        self._first_round = first_round
        # leaf lock for _error: written on the producer thread, read on
        # the consumer thread after it sees the producer dead
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=PREFETCH_THREAD_NAME, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _wrap(self, exc, k, r, attempts):
        if self._max_retries == 0:
            return exc      # no retry facility: surface verbatim
        rounds = (f"round {r}" if k == 1 else
                  f"rounds {r}..{r + k - 1}")
        err = PrefetchError(
            f"prefetch producer failed staging {rounds} after "
            f"{attempts} attempt(s) (max_retries={self._max_retries} "
            f"exhausted): {type(exc).__name__}: {exc}")
        err.__cause__ = exc
        return err

    def _produce_with_retry(self, k, r):
        out = call_with_retry(lambda: self._produce(k),
                              max_retries=self._max_retries,
                              backoff=self._retry_backoff,
                              stop=self._stop)
        if out is None:
            return None
        exc, item, attempts = out
        if exc is not None:
            return (self._wrap(exc, k, r, attempts), None)
        return (None, item)

    def _run(self):
        r = self._first_round
        try:
            for k in self._sizes:
                if self._stop.is_set():
                    return
                item = self._produce_with_retry(k, r)
                if item is None:
                    return
                if item[0] is not None:
                    with self._lock:
                        self._error = item[0]
                    self._put(item)
                    return
                if not self._put(item):
                    return
                r += k
        except BaseException as exc:  # pragma: no cover - safety net
            with self._lock:
                self._error = exc
            self._put((exc, None))

    def get(self):
        while True:
            try:
                exc, item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    with self._lock:
                        err = self._error
                    if err is not None:
                        raise err
                    raise PrefetchError(
                        "prefetch producer thread exited without "
                        "staging the requested block")
        if exc is not None:
            raise exc
        return item

    def close(self):
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()


class _PoolTask:
    """One queued unit of pool work. ``result`` and ``error`` are written
    by one worker before ``done.set()`` and read only after ``done`` is
    seen set (the Event is the happens-before edge). ``started_at`` is
    published unsynchronized: the gather side polls it only to arm the
    task timeout, so a stale read delays the timeout by one poll."""
    __slots__ = ("item", "result", "error", "started_at", "done")

    def __init__(self, item):
        self.item = item
        self.result = None
        self.error: Optional[BaseException] = None
        self.started_at: Optional[float] = None
        self.done = threading.Event()


class WorkerPool:
    """``workers`` persistent threads running ``fn(item)``.

    ``map(items)`` fans the items out and blocks until every task is
    done, returning results in submission order. Each task runs under
    `call_with_retry` (``fn`` must be retry-safe); ``task_timeout``
    counts from the moment a worker starts the task. Failures mirror
    `PrefetchError`:

      * a task that exhausts its retries raises `WorkerPoolError` at
        ``map()`` naming the item and the caller's ``label``, the
        worker's exception chained as ``__cause__``;
      * a task over ``task_timeout`` raises without waiting for it;
      * ``map()`` on a pool whose workers have all died raises;
      * ``close()`` stops the workers, releases queued tasks' waiters
        and joins every thread.

    Example::

        pool = WorkerPool(lambda i: clients[i], workers=4, max_retries=2)
        try:
            shards = pool.map([3, 17, 42], label="round 7")
        finally:
            pool.close()

    Lock order: the gather side waits on each task's ``done`` Event
    holding no lock; a worker's ``fn`` takes any lock of its own (a
    client registry's) as a leaf, released before any blocking call.
    """

    def __init__(self, fn: Callable, workers: int = 2, *,
                 max_retries: int = 0, retry_backoff: float = 0.05,
                 task_timeout: Optional[float] = None):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._fn = fn
        self._max_retries = max(0, max_retries)
        self._retry_backoff = retry_backoff
        self._task_timeout = task_timeout
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"{WORKER_THREAD_NAME}-{i}")
            for i in range(workers)]
        for t in self._threads:
            t.start()

    def _work(self):
        while not self._stop.is_set():
            try:
                task = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            task.started_at = time.monotonic()
            out = call_with_retry(lambda: self._fn(task.item),
                                  max_retries=self._max_retries,
                                  backoff=self._retry_backoff,
                                  stop=self._stop)
            if out is None:      # stopped mid-retry
                task.error = WorkerPoolError("worker pool closed")
            elif out[0] is not None:
                task.error = out[0]
            else:
                task.result = out[1]
            task.done.set()

    def _fail(self, msg, cause=None) -> WorkerPoolError:
        err = WorkerPoolError(msg)
        if cause is not None:
            err.__cause__ = cause
        return err

    def map(self, items, label: str = "") -> list:
        """Run ``fn`` over ``items`` concurrently; results in order."""
        tasks = [_PoolTask(it) for it in items]
        for t in tasks:
            self._q.put(t)
        where = f" for {label}" if label else ""
        out = []
        for t in tasks:
            while not t.done.wait(timeout=0.05):
                if self._task_timeout is not None and \
                        t.started_at is not None and \
                        time.monotonic() - t.started_at > \
                        self._task_timeout:
                    raise self._fail(
                        f"worker task {t.item!r}{where} exceeded the "
                        f"{self._task_timeout}s task timeout")
                if not any(th.is_alive() for th in self._threads):
                    raise self._fail(
                        f"worker pool died before task {t.item!r}"
                        f"{where} completed")
            if t.error is not None:
                raise self._fail(
                    f"worker pool failed materializing {t.item!r}"
                    f"{where} after {self._max_retries + 1} attempt(s) "
                    f"(max_retries={self._max_retries} exhausted): "
                    f"{type(t.error).__name__}: {t.error}", t.error)
            out.append(t.result)
        return out

    def close(self):
        self._stop.set()
        while True:              # release waiters of never-run tasks
            try:
                task = self._q.get_nowait()
            except queue.Empty:
                break
            task.error = WorkerPoolError("worker pool closed")
            task.done.set()
        for t in self._threads:
            t.join(timeout=10.0)

    @property
    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)


def plan_blocks(rounds: int, eval_every: int, fuse: int,
                start: int = 0) -> list:
    """Round-block sizes covering rounds ``start + 1``..``rounds``: at
    most ``fuse`` rounds per block, and a block boundary at every eval
    round (and the final round). A resumed run (``start > 0``) gets the
    uninterrupted plan's tail.

    >>> plan_blocks(10, 4, 3)   # eval rounds 4 and 8 end their blocks
    [3, 1, 3, 1, 2]
    >>> plan_blocks(10, 4, 3, start=4)
    [3, 1, 2]
    """
    fuse = max(1, fuse)
    if rounds <= start:
        return []
    bounds = {rounds}
    if eval_every:
        bounds.update(b for b in range(eval_every, rounds + 1, eval_every)
                      if b > start)
    blocks, r = [], start
    for b in sorted(bounds):
        seg = b - r
        while seg > 0:
            k = min(fuse, seg)
            blocks.append(k)
            seg -= k
        r = b
    return blocks


@dataclasses.dataclass
class AsyncRoundEngine:
    """The round loop shared by `FederatedTrainer` and `FedAvgTrainer`:

      stage(k)            host half of the next k rounds (in stream
                          order; on the prefetch thread when
                          ``prefetch_depth > 0``); the step waits on a
                          `Staged` block's copies (`Staged.ready`)
      step(state, staged) one round -> (state, metrics)
      fused_step          optional: (state, k-round staged) -> (state,
                          metrics with a leading (k,) axis)
      comm                CommTracker (ticked per round by the engine)
      history             the trainer's record list, appended at flush
      checkpoint          optional (state, round) -> None, called every
                          ``checkpoint_every`` rounds at block boundaries,
                          after the pending metrics are flushed
      prefetch_retries    retries of a failed staging (Prefetcher)

    Example::

        engine = AsyncRoundEngine(stage=stage, step=step, comm=comm,
                                  history=history, prefetch_depth=2,
                                  flush_every=4)
        state = engine.run(state, rounds=100, eval_every=10,
                           evaluate=lambda st: {"eval_acc": ...})
    """
    stage: Callable
    step: Callable
    comm: object
    history: list
    fused_step: Optional[Callable] = None
    prefetch_depth: int = 0
    flush_every: int = 1
    fuse_rounds: int = 1
    checkpoint: Optional[Callable] = None
    checkpoint_every: int = 0
    prefetch_retries: int = 0

    def run(self, state, rounds: int, *, eval_every: int = 0,
            evaluate: Optional[Callable] = None, log: Callable = None,
            start_round: int = 0):
        fuse = self.fuse_rounds if self.fused_step is not None else 1
        blocks = plan_blocks(rounds, eval_every if evaluate else 0, fuse,
                             start=start_round)
        pending: list = []

        def flush():
            # the only host sync of the loop: float() on the pending
            # rounds' metric tensors
            for n, metrics, comm_rounds, eval_fields in pending:
                rec = {"round": n,
                       **{k: float(v) for k, v in metrics.items()},
                       **self.comm.summary_at(comm_rounds)}
                if eval_fields:
                    rec.update(eval_fields)
                self.history.append(rec)
                if log:
                    log(rec)
            pending.clear()

        prefetch = None
        if self.prefetch_depth > 0:
            prefetch = Prefetcher(self.stage, blocks, self.prefetch_depth,
                                  max_retries=self.prefetch_retries,
                                  first_round=start_round + 1)
        r = start_round
        last_ckpt = start_round
        try:
            for bk in blocks:
                staged = prefetch.get() if prefetch else self.stage(bk)
                if isinstance(staged, Staged):
                    staged = staged.ready()
                if bk == 1:
                    state, metrics = self.step(state, staged)
                    per_round = [metrics]
                else:
                    state, stacked = self.fused_step(state, staged)
                    per_round = [{k: v[i] for k, v in stacked.items()}
                                 for i in range(bk)]
                del staged
                for metrics in per_round:
                    r += 1
                    self.comm.tick()
                    eval_fields = None
                    if evaluate and eval_every and \
                            (r % eval_every == 0 or r == rounds):
                        eval_fields = evaluate(state)
                    pending.append((r, metrics, self.comm.rounds,
                                    eval_fields))
                    # eval rounds already synced the device to read φ,
                    # so draining there is free
                    if eval_fields is not None or (
                            self.flush_every and
                            r % self.flush_every == 0):
                        flush()
                if (self.checkpoint is not None and self.checkpoint_every
                        and r - last_ckpt >= self.checkpoint_every):
                    # flush first: the payload holds the history up to
                    # and including round r, never a pending tail
                    flush()
                    self.checkpoint(state, r)
                    last_ckpt = r
            return state
        finally:
            if prefetch is not None:
                prefetch.close()
            flush()
