"""Multi-pod dry run: every (arch x input shape) on the production mesh
of 256 ranks (512 with ``--multi-pod``), without devices. Counterpart
of `repro/launch/dryrun.py`, with its CLI and its record.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k [--multi-pod] [--algo fomaml] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --json DIR

There is no compiler to lower to. The mesh is built over PyTorch's
"fake" process group (every collective returns at once); the state,
parameters, cache and batch are fake tensors (shapes and dtypes, no
memory) placed as DTensors by the ported specs, and one step runs
eagerly under `FakeTensorMode` as rank 0 of the world. The record holds

  memory.argument_bytes / output_bytes  the local shard bytes of rank
                                        0's inputs and outputs;
  cost.flops                            rank 0's FLOPs (`FlopCounterMode`);
  collectives                           counts and result bytes by type
                                        of the collectives the step ran;
  status                                "ok", "error", or "skipped" (the
                                        reference's seamless-m4t-medium x
                                        long_500k skip).

XLA's compile-time keys (``temp_bytes``, ``generated_code_bytes``,
``transcendentals``, ``optimal_seconds``, ``bytes accessed``) have no
counterpart and are left out. The collective schedule is DTensor's, not
XLA's SPMD partitioner's, so the counts are the port's own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import PRODUCTION_SHAPE, make_production_mesh
from repro_torch.launch.steps import (input_specs, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      resolve_serving_config)
from repro_torch.models import init_lm
from repro_torch.sharding.rules import distribute, param_pspecs, state_pspecs
from repro_torch.utils.pytree import tree_flatten, tree_map

# collective op name (functional or c10d) -> the reference's type name
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "broadcast"))


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives dispatched under it and their result
    bytes, by type (the reference sums result-shape bytes too)."""

    def __init__(self):
        super().__init__()
        self.counts: dict = {}
        self.bytes_by_type: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd",
                  "c10d_functional", "c10d"):
            name = func._opname
            kind = next((k for p, k in _COLLECTIVES if p in name), None)
            if kind is not None:
                self.counts[kind] = self.counts.get(kind, 0) + 1
                self.bytes_by_type[kind] = (self.bytes_by_type.get(kind, 0)
                                            + _nbytes(out))
        return out

    def record(self) -> dict:
        return {"bytes_by_type": dict(self.bytes_by_type),
                "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_type.values())}


def _nbytes(tree) -> int:
    from repro_torch.sharding.dtensor import is_dtensor
    n = 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            n += t.numel() * t.element_size()
    return n


@contextlib.contextmanager
def fake_world(world: int):
    """The "fake" process group at ``world`` ranks, this process rank 0,
    for the duration; an existing default group is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(tree):
    """Meta tensors -> fake CPU tensors of the same shape and dtype
    (called under FakeTensorMode); other leaves pass through."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               algo: str = "fomaml", remat: bool = True,
               extra_tag: str = "", moe_impl: str = "tp",
               shard_seq: bool = False,
               opt_state_dtype: str = "float32") -> dict:
    """One (arch, shape) step on the production mesh over the fake
    group (which the caller has started: `fake_world`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.sharding.context import stepping_on

    cfg = get_config(arch)
    if moe_impl != "tp" or shard_seq:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl,
                                  shard_seq=shard_seq)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, PRODUCTION_SHAPE[multi_pod][0])),
           "algo": algo, "tag": extra_tag, "moe_impl": moe_impl,
           "shard_seq": shard_seq, "opt_state_dtype": opt_state_dtype}
    t0 = time.time()
    grad = torch.enable_grad
    if shape.kind == "train":
        step, init_state, _, _ = make_train_step(
            cfg, algo_name=algo, remat=remat,
            opt_state_dtype=opt_state_dtype)
        state = init_state(0, device="meta")
        spec = input_specs(cfg, shape, mesh)
        place = lambda: (
            distribute(_fake(state), state_pspecs(
                state, param_pspecs(state["phi"]["theta"], mesh), mesh),
                mesh),
            distribute(_fake(spec["batch"]), spec["pspec"], mesh))
    elif shape.kind == "prefill":
        scfg = resolve_serving_config(cfg, shape)
        step = make_prefill_step(scfg)
        params = init_lm(0, scfg, device="meta")
        spec = input_specs(scfg, shape, mesh)
        place = lambda: (
            distribute(_fake(params), param_pspecs(params, mesh), mesh),
            distribute(_fake(spec["batch"]), spec["pspec"], mesh))
        grad = torch.no_grad
    else:
        spec = input_specs(cfg, shape, mesh)
        scfg = spec["serving_cfg"]
        step = make_decode_step(scfg)
        params = init_lm(0, scfg, device="meta")
        b, ps = spec["batch"], spec["pspec"]
        place = lambda: (
            distribute(_fake(params), param_pspecs(params, mesh), mesh),
            distribute(_fake(b["cache"]), ps["cache"], mesh),
            distribute(_fake(b["tokens"]), ps["tokens"], mesh))
        grad = torch.no_grad

    with FakeTensorMode(allow_non_fake_inputs=True):
        args = place()
        arg_bytes = _nbytes(args)
        comms, flops = CollectiveCounter(), FlopCounterMode(display=False)
        with stepping_on(mesh), grad(), flops, comms:
            out = step(*args)
        rec["run_s"] = round(time.time() - t0, 1)
        rec["memory"] = {"argument_bytes": arg_bytes,
                         "output_bytes": _nbytes(out)}
    rec["cost"] = {"flops": float(flops.get_total_flops())}
    rec["collectives"] = comms.record()
    rec["status"] = "ok"
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--algo", default="fomaml")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--moe-impl", default="tp", choices=["tp", "ep"])
    ap.add_argument("--shard-seq", action="store_true")
    ap.add_argument("--opt-dtype", default="float32")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json", default=None,
                    help="output file (single) or directory (--all)")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        pairs = [(args.arch, args.shape)]
    world = 512 if args.multi_pod else 256
    results = []
    with fake_world(world):
        for arch, shape in pairs:
            # the reference's documented skip: enc-dec at 512k decode
            if arch == "seamless-m4t-medium" and shape == "long_500k":
                rec = {"arch": arch, "shape": shape, "status": "skipped",
                       "reason": "enc-dec decoder is full-attention; 512k "
                                 "decode outside operating regime "
                                 "(DESIGN.md)"}
            else:
                try:
                    rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                                     algo=args.algo,
                                     remat=not args.no_remat,
                                     extra_tag=args.tag,
                                     moe_impl=args.moe_impl,
                                     shard_seq=args.shard_seq,
                                     opt_state_dtype=args.opt_dtype)
                except Exception as e:    # noqa: BLE001 — recorded
                    rec = {"arch": arch, "shape": shape, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
            results.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "trace"}), flush=True)
            if args.json:
                if args.all:
                    os.makedirs(args.json, exist_ok=True)
                    tag = "pod2" if args.multi_pod else "pod1"
                    path = os.path.join(
                        args.json, f"{arch}__{shape}__{tag}"
                        f"{('__' + args.tag) if args.tag else ''}.json")
                else:
                    path = args.json
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    return results


if __name__ == "__main__":
    main()
