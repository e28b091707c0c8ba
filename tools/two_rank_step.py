#!/usr/bin/env python3
"""The launcher's step on two ranks of one card, on the 2x1 and the 1x2
mesh, against the meshless step: where and by how much they differ.

    python3 tools/two_rank_step.py

Builds the kernels (`chip_smoke.phase_build`), then spawns two ranks on
``cuda:0`` in a world on the backend `staged_gloo` (DTensor's
collectives as `repro_torch.sharding.collectives.StagedGloo`). Rank 0
runs `chip_smoke.md_launcher_setup`'s step with no mesh (SmolLM-360M at
full width, 1 + 1 sequences of 4,096 tokens, from the seed-0 draw);
then both ranks run it on each mesh from the state drawn shard by
shard. For each mesh rank 0 prints the loss against the meshless one,
the staged collectives' calls and bytes, and for each φ leaf the
largest step |φ' − φ₀| over lr on both routes, the largest gap to the
meshless φ, and the worst entry (φ₀, meshless, mesh) against the
bound 2·lr + eps(bf16)·|mesh entry|, with the count over it and over
the bound on the larger entry's ulp. Prints one JSON line.
"""
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def leaf_record(p, x, y, lr):
    """φ₀ ``p``, meshless ``x`` and mesh ``y`` of one leaf."""
    p, x, y = p.float(), x.float(), y.float()
    eps = torch.finfo(torch.bfloat16).eps
    gap = (x - y).abs()
    over = gap - 2 * lr - eps * y.abs()
    over_both = gap - 2 * lr - eps * torch.maximum(x.abs(), y.abs())
    j = int(over.argmax())
    return {"shape": list(p.shape),
            "meshless_step_over_lr": float((x - p).abs().max()) / lr,
            "mesh_step_over_lr": float((y - p).abs().max()) / lr,
            "max_gap": float(gap.max()), "entries_differing": int(
                (gap > 0).sum()), "entries": p.numel(),
            "worst": {"phi0": float(p.flatten()[j]),
                      "meshless": float(x.flatten()[j]),
                      "mesh": float(y.flatten()[j]),
                      "over_mesh_ulp": float(over.flatten()[j])},
            "n_over_mesh_ulp": int((over > 0).sum()),
            "n_over_larger_ulp": int((over_both > 0).sum())}


def child(rank, store, out):
    import chip_smoke as c
    torch.cuda.set_device(0)
    c._md_flags(torch)
    from repro_torch.kernels import _build
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import collectives as coll
    from repro_torch.utils.pytree import tree_leaves
    _build.get_ext()
    dist.init_process_group(coll.register_staged_gloo(),
                            store=dist.FileStore(store, 2), rank=rank,
                            world_size=2)
    cfg, shape = c.md_launcher_setup()
    lr = c.LAUNCH_LR["outer_lr"]
    res = {}
    if rank == 0:
        phi0 = tree_leaves(make_train_step(cfg)[1](0, device="cuda")["phi"])
        st, r0 = tl.train(cfg, shape, steps=1, device="cuda",
                          log_every=10 ** 9, **c.LAUNCH_LR)
        ref = tree_leaves(st["phi"])
        res["meshless"] = {"loss": r0[0]["query_loss"],
                           "step_s": r0[0]["wall_s"]}
        del st
    dist.barrier()
    for data, model in ((2, 1), (1, 2)):
        mesh = make_host_mesh(data, model, device_type="cuda")
        coll.reset()
        st, r1 = tl.train(cfg, shape, steps=1, device="cuda",
                          log_every=10 ** 9, mesh=mesh, **c.LAUNCH_LR)
        calls = {"calls": dict(coll.calls), "bytes": dict(coll.bytes_)}
        got = tree_leaves(tl.full(st["phi"]))
        del st
        if rank == 0:
            loss = r1[0]["query_loss"]
            res[f"{data}x{model}"] = {
                "loss": loss, "loss_rel_gap": abs(
                    loss - res["meshless"]["loss"]) / abs(
                        res["meshless"]["loss"]),
                "step_s": r1[0]["wall_s"], "collectives": calls,
                "leaves": [leaf_record(p, x, y, lr)
                           for p, x, y in zip(phi0, ref, got)]}
        del got
        dist.barrier()
    with open(os.path.join(out, f"r{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main():
    import chip_smoke as c
    c.phase_build(torch)
    out = tempfile.mkdtemp(prefix="two_rank_step_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=child,
                         args=(r, os.path.join(out, "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    path = os.path.join(out, "r0.json")
    if codes != [0, 0] or not os.path.exists(path):
        print(f"exit codes {codes}", flush=True)
        return 1
    print(json.dumps(json.load(open(path))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
