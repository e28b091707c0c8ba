#!/usr/bin/env python3
"""Probe which collectives two ranks on one CUDA card can run on CUDA
tensors, through DTensor and the functional collectives: over gloo given
the CUDA tensors themselves, and over the port's `staged_gloo` backend
(`repro_torch.sharding.collectives.StagedGloo`, gloo on pinned host
copies).

    python3 tools/probe_gloo_cuda.py

Each operation runs on a 1x2 ("data", "model") DeviceMesh on ``cuda:0``
(a FileStore in a temp dir): `distribute_tensor` with
``src_data_rank=None`` (no collective), DTensor redistributions that
need an all-gather, an all-reduce, a reduce-scatter and an all-to-all,
a tensor-parallel matmul, the functional all-to-all, `distribute_tensor`'s
scatter from rank 0, and `torch.distributed`'s own all-gather, all-reduce
and broadcast. Over gloo each operation gets a fresh pair of processes,
since a segmentation fault ends the process and cannot be caught; over
`staged_gloo` one pair runs them all. Python's fault handler writes
where a rank ended. Prints each run's exit codes and results, then one
JSON line: operation -> {"gloo": ..., "staged_gloo": ...}, each "ok
<value>", "FAIL <error>" or "exit <code>" for a rank that ended without
a result.

This is why `chip_smoke.py`'s two ranks on one card step the launcher in
a world on `staged_gloo`: NCCL takes one rank a card.
"""
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
OPS = ("distribute_local", "all_gather", "all_reduce", "reduce_scatter",
       "all_to_all", "matmul_tp", "funcol_all_to_all", "distribute_scatter",
       "dist_all_gather", "dist_all_reduce", "dist_broadcast")


def child(rank, backend, ops, store, out):
    try:
        body(rank, backend, ops, store, out)
    except Exception:
        with open(os.path.join(out, f"r{rank}.err"), "w") as f:
            f.write(traceback.format_exc()[-2500:])


def body(rank, backend, ops, store, out):
    import faulthandler
    faulthandler.enable(open(os.path.join(out, f"fault{rank}.txt"), "w"))
    sys.path.insert(0, SRC)
    from repro_torch.sharding.collectives import register_staged_gloo
    register_staged_gloo()
    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    res = {"torch": torch.__version__}
    x = torch.arange(16., device="cuda").reshape(4, 4)
    rs, r = [Replicate(), Shard(0)], [Replicate(), Partial()]

    def save():
        with open(os.path.join(out, f"r{rank}.json"), "w") as f:
            json.dump(res, f)

    def local(t, pl):
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    def dist_all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x.clone())
        return sum(p.sum() for p in parts).item()

    def dist_all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y.sum().item()

    def dist_broadcast():
        y = x.clone() * (rank + 1)
        dist.broadcast(y, 0)
        return y.sum().item()

    fns = {
        "distribute_local": lambda: local(x, rs).to_local().sum().item(),
        "all_gather": lambda: local(x, rs).full_tensor().sum().item(),
        "all_reduce": lambda: DTensor.from_local(
            x.clone(), mesh, r).full_tensor().sum().item(),
        "reduce_scatter": lambda: DTensor.from_local(
            x.clone(), mesh, r).redistribute(mesh, rs).to_local().sum().item(),
        "all_to_all": lambda: local(x, rs).redistribute(
            mesh, [Replicate(), Shard(1)]).to_local().sum().item(),
        "matmul_tp": lambda: (local(x, [Replicate(), Shard(1)])
                              @ local(x, rs)).full_tensor().sum().item(),
        "funcol_all_to_all": lambda: funcol.all_to_all_single(
            x.clone(), None, None, mesh.get_group("model")).sum().item(),
        "distribute_scatter": lambda: distribute_tensor(
            x, mesh, rs).to_local().sum().item(),
        "dist_all_gather": dist_all_gather,
        "dist_all_reduce": dist_all_reduce,
        "dist_broadcast": dist_broadcast,
    }
    for name in ops:
        res[name] = "started"
        save()
        try:
            v = fns[name]()
            torch.cuda.synchronize()
            res[name] = f"ok {v}"
        except Exception as e:       # noqa: BLE001 — recorded
            res[name] = f"FAIL {type(e).__name__}: {str(e)[:200]}"
        save()
    dist.destroy_process_group()


def run(backend, ops):
    """One pair of ranks running ``ops`` over ``backend``; returns
    operation -> result, as rank 0 saw it."""
    out = tempfile.mkdtemp(prefix="probe_gloo_cuda_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=child,
                         args=(r, backend, ops, os.path.join(out, "store"),
                               out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print(f"{backend} {list(ops)}: exit codes {codes}", flush=True)
    recs = []
    for r in range(2):
        for name in (f"r{r}.json", f"r{r}.err", f"fault{r}.txt"):
            path = os.path.join(out, name)
            if os.path.exists(path) and os.path.getsize(path):
                print(f"  rank {r} {name}: {open(path).read()[-1500:]}",
                      flush=True)
        path = os.path.join(out, f"r{r}.json")
        recs.append(json.load(open(path)) if os.path.exists(path) else {})
    got = {}
    for name in ops:
        v = recs[0].get(name)
        got[name] = v if v not in (None, "started") else f"exit {codes}"
    return got


def main():
    table = {name: {} for name in OPS}
    for name in OPS:
        table[name]["gloo"] = run("gloo", (name,))[name]
    for name, v in run("staged_gloo", OPS).items():
        table[name]["staged_gloo"] = v
    print(json.dumps(table), flush=True)


if __name__ == "__main__":
    main()
