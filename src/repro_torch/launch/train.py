"""LM training launcher: FedMeta meta-training of an LM config through
`launch.steps.make_train_step`. Counterpart of `repro/launch/train.py`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --reduced --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --shape train_4k --steps 2 --seqs-per-client 16 --clients 1

The CLI runs on a device mesh (`launch/mesh.launcher_mesh`): the
production mesh in a world of 256 ranks (one pod) or 512 with
``--multi-pod``, the 1x1 host mesh in a world of one (a run started
without torchrun). The state and each batch are DTensors placed by the
ported specs (`sharding/rules.py`, `launch/steps.input_specs`); each
rank draws only its own shards of the state, so a state larger than one
card launches, as the reference's ``out_shardings`` init does. The
step is `make_train_step`'s, unchanged: the kernels run on local shards
through `local_map`. ``--reduced`` takes the reference's reduced config
and shape (64 tokens, 2 clients of 2 sequences). ``--seqs-per-client``
and ``--clients`` cut a train shape to what one card holds (train_4k's
8 clients of 32 sequences of 4,096 tokens at full width do not fit 80
GB). `train(..., mesh=None)` runs in process with no mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import (INPUT_SHAPES, get_config, list_archs,
                                 reduced_config)
from repro_torch.data.lm_tasks import make_lm_task_batch
from repro_torch.launch.steps import make_train_step, train_batch_layout
from repro_torch.models.layers import as_dtype
from repro_torch.sharding.context import stepping_on
from repro_torch.sharding.rules import distribute

ALGOS = ("maml", "fomaml", "meta-sgd", "meta-sgd-fo", "reptile")


def reduced_shape(shape):
    """The reference's `--reduced` shape replacement."""
    return dataclasses.replace(shape, seq_len=64, global_batch=4,
                               clients_per_round=2, seqs_per_client=2)


def cut_shape(shape, *, seqs_per_client=None, clients=None):
    """A train shape with fewer sequences a client or fewer clients (its
    sequence length kept)."""
    S = seqs_per_client or shape.seqs_per_client
    C = clients or shape.clients_per_round
    return dataclasses.replace(shape, global_batch=C * S,
                               clients_per_round=C, seqs_per_client=S)


def task_batch(cfg, shape, it: int, device):
    """Step ``it``'s batch: `make_lm_task_batch(G·C, ...)` with seed
    ``it``, as (G, C, S, L) int32 token tensors on ``device``. A vision
    or audio config also gets "embeds" (G, C, S, n_mod, d_model) drawn
    as the reference's launcher draws them
    (`repro/launch/train.py:86-91`): ``normal(0, 0.1)`` from
    ``RandomState(it)``, support then query, cast to ``cfg.dtype``."""
    G, C, S_sup, S_qry, L, n_mod = train_batch_layout(cfg, shape, 1)
    tasks = make_lm_task_batch(G * C, S_sup, S_qry, L, cfg.vocab_size,
                               seed=it)
    part = lambda a, S: {"tokens": torch.as_tensor(
        a.reshape(G, C, S, L), dtype=torch.int32, device=device)}
    batch = {"support": part(tasks.support_tokens, S_sup),
             "query": part(tasks.query_tokens, S_qry)}
    if cfg.modality:
        rngd = np.random.RandomState(it)
        for name, S in (("support", S_sup), ("query", S_qry)):
            batch[name]["embeds"] = torch.as_tensor(rngd.normal(
                0, 0.1, (G, C, S, n_mod, cfg.d_model))).to(
                device=device, dtype=as_dtype(cfg.dtype))
    return batch


def check_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; use "
                           "--device cpu")
    return device


def place_state(state, mesh):
    """The train state as DTensors on ``mesh``: φ by `param_pspecs`,
    the optimizer's moments as φ, the step count replicated
    (`state_pspecs`)."""
    from repro_torch.sharding.rules import param_pspecs, state_pspecs
    pspec = param_pspecs(state["phi"]["theta"], mesh)
    return distribute(state, state_pspecs(state, pspec, mesh), mesh)


def full(tree):
    """DTensors -> their full values as plain tensors (on every rank);
    plain tensors pass through."""
    from repro_torch.sharding.dtensor import is_dtensor
    from repro_torch.utils.pytree import tree_map
    return tree_map(lambda x: x.full_tensor() if is_dtensor(x) else x, tree)


def train(cfg, shape, *, algo: str = "fomaml", steps: int = 10,
          inner_lr: float = 0.01, outer_lr: float = 1e-4,
          remat: bool = True, device="cuda", phi=None, log_every: int = 1,
          on_step=None, mesh=None):
    """Run ``steps`` meta-training steps; returns (state, records), one
    record a step: its metrics and wall seconds (the card synchronized).
    ``phi`` injects the initial parameters; else φ is drawn from seed 0
    on ``device``. ``on_step(it, state, metrics)``, if given,
    runs after each step. With ``mesh`` the state and the batches are
    placed on it as DTensors (`input_specs`) and the step runs with it
    as the ambient mesh; the returned state is then DTensors too
    (`full` gathers it). A drawn state is made shard by shard on each
    rank, an injected ``phi`` placed whole (`make_train_step`'s
    ``init_state(mesh=...)``)."""
    if shape.kind != "train":
        raise ValueError("use launch/serve.py for inference shapes")
    device = check_device(device)
    train_step, init_state, _, _ = make_train_step(
        cfg, algo_name=algo, inner_lr=inner_lr, outer_lr=outer_lr,
        remat=remat)
    state = init_state(0, phi=phi, device=device, mesh=mesh)
    if mesh is not None:
        from repro_torch.launch.steps import input_specs
        bspec = input_specs(cfg, shape, mesh)["pspec"]
    records = []
    for it in range(steps):
        batch = task_batch(cfg, shape, it, device)
        if mesh is not None:
            batch = distribute(batch, bspec, mesh)
        t0 = time.perf_counter()
        with stepping_on(mesh):
            state, metrics = train_step(state, batch)
            metrics = full(metrics)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        rec = {"step": it + 1, "wall_s": wall,
               **{k: float(v) for k, v in metrics.items()}}
        records.append(rec)
        if on_step is not None:
            on_step(it, state, metrics)
        if (it + 1) % log_every == 0:
            print(f"step {it + 1:4d}  loss={rec['query_loss']:.4f}  "
                  f"acc={rec['accuracy']:.4f}  ({wall:.2f}s)", flush=True)
    return state, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--algo", default="fomaml", choices=list(ALGOS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--inner-lr", type=float, default=0.01)
    ap.add_argument("--outer-lr", type=float, default=1e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config and shape (runs on the CPU)")
    ap.add_argument("--seqs-per-client", type=int, default=None)
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.reduced:
        cfg = reduced_config(cfg)
        shape = reduced_shape(shape)
    shape = cut_shape(shape, seqs_per_client=args.seqs_per_client,
                      clients=args.clients)
    from repro_torch.launch.mesh import launcher_world
    from repro_torch.sharding.rules import mesh_sizes
    with launcher_world(args.multi_pod and not args.reduced,
                        check_device(args.device).type) as mesh:
        state, records = train(cfg, shape, algo=args.algo, steps=args.steps,
                               inner_lr=args.inner_lr,
                               outer_lr=args.outer_lr, device=args.device,
                               log_every=args.log_every, mesh=mesh)
        out = {"arch": cfg.name, "shape": dataclasses.asdict(shape),
               "algo": args.algo, "mesh": mesh_sizes(mesh),
               "records": records}
        if args.ckpt:
            import torch.distributed as dist
            from repro_torch.checkpoint import save_server_state
            host = full(state)             # every rank joins the gathers
            if dist.get_rank() == 0:
                path = save_server_state(args.ckpt, args.steps, host)
                print("checkpoint:", path)
                out["checkpoint"] = path
    return out


if __name__ == "__main__":
    main()
