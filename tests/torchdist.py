"""Process groups for the port's multi-device tests, on the CPU.

`world` starts a gloo group of one in this process over a FileStore in
a test's tmp dir and destroys it on exit. `spawn_world` runs a function
in ``n`` spawned processes that form a gloo world over a FileStore, each
with its own timeout, and returns each rank's result (a picklable value
written through torch.save); a rank that raises fails the call with its
traceback. Nothing here imports jax: the children start from a fresh
interpreter.
"""
from __future__ import annotations

import contextlib
import os
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@contextlib.contextmanager
def world(tmp_path, name="pg"):
    """A gloo world of one (rank 0) for the duration."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / f"{name}.store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _child(rank, n, store, out_dir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        res = {"ok": True, "value": fn(rank, *args)}
    except BaseException:        # recorded for the parent, then raised
        res = {"ok": False, "trace": traceback.format_exc()}
        raise
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def spawn_world(tmp_path, n, fn, *args, timeout=600):
    """[fn(rank, *args) for each rank] of an n-rank gloo world. ``fn``
    must be importable by the children (a module-level function)."""
    out = tmp_path / f"world{n}"
    out.mkdir(exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, n, str(out / "store"),
                                              str(out), fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r, p in enumerate(procs):
        path = out / f"rank{r}.pt"
        if not path.exists():
            raise RuntimeError(f"rank {r} left no result (exit {p.exitcode})")
        res = torch.load(path, weights_only=False)
        if not res["ok"]:
            raise RuntimeError(f"rank {r} failed:\n{res['trace']}")
        results.append(res["value"])
    return results
