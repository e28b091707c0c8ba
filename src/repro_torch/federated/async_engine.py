"""The round loop (counterpart of `repro/federated/async_engine.py:
478-618`), synchronous path only.

`AsyncRoundEngine` stages each round's inputs, runs the step, ticks the
comm tracker and appends one history record per round, with eval fields
on eval rounds. Metrics stay device tensors until a flush every
``flush_every`` rounds (and at eval rounds and at exit) reads them with
``float()`` — the only host sync of the loop.

Prefetching (``prefetch_depth > 0``), fused-K round blocks
(``fuse_rounds > 1``), checkpoint hooks and resumed runs join the port
with the async slice (the trainer refuses those knobs); the worker pool
and staleness classes raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


def _async_slice(what: str):
    return NotImplementedError(f"{what} is not ported yet: it joins the "
                               f"port with the async slice")


class Prefetcher:
    def __init__(self, *args, **kwargs):
        raise _async_slice("Prefetcher (round prefetching)")


class WorkerPool:
    def __init__(self, *args, **kwargs):
        raise _async_slice("WorkerPool")


class StalenessConfig:
    def __init__(self, *args, **kwargs):
        raise _async_slice("StalenessConfig (staleness-aware aggregation)")


def plan_blocks(rounds: int, eval_every: int, fuse: int,
                start: int = 0) -> list:
    """Round-block sizes covering rounds ``start + 1``..``rounds``: at
    most ``fuse`` rounds per block, and a block boundary at every eval
    round (and the final round).

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
    """The round loop shared by the trainers:

      stage()             staging of the next round's inputs
      step(state, staged) one round; -> (state, metrics)
      comm                CommTracker (ticked per round by the engine)
      history             the trainer's record list, appended at flush
    """
    stage: Callable
    step: Callable
    comm: object
    history: list
    flush_every: int = 1

    def run(self, state, rounds: int, *, eval_every: int = 0,
            evaluate: Optional[Callable] = None, log: Callable = None):
        pending: list = []

        def flush():
            # the only host-device sync in the loop: float() on the
            # pending rounds' metric tensors
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

        try:
            for r in range(1, rounds + 1):
                state, metrics = self.step(state, self.stage())
                self.comm.tick()
                eval_fields = None
                if evaluate and eval_every and \
                        (r % eval_every == 0 or r == rounds):
                    eval_fields = evaluate(state)
                pending.append((r, metrics, self.comm.rounds, eval_fields))
                # eval rounds already synced the device to read φ, so
                # draining there is free
                if eval_fields is not None or (
                        self.flush_every and r % self.flush_every == 0):
                    flush()
            return state
        finally:
            flush()
