"""Experiment-plane launcher of the port: the counterpart of
`examples/compression_femnist.py` (``--sweep compression``) and of the
FEMNIST comparison plan behind `examples/femnist_fedmeta.py` and
``results/experiments/femnist_compare.json`` (``--sweep femnist``).

    PYTHONPATH=src python -m repro_torch.launch.compare --sweep compression
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep femnist \\
        --device cpu --pipeline tree --init-from init.npz --outdir /tmp/f

``compression``: FOMAML on FEMNIST under four upload codecs — dense f32,
a bf16 block, int8 with error feedback and top-5% with error feedback
(bf16 values) — on the same split and stream, target accuracy 0.12; it
prints each variant's bytes and the upload-bytes-to-target ratio against
bf16. ``femnist``: FedAvg, FedAvg(Meta), MAML, FOMAML and Meta-SGD on
the committed comparison plan; it prints the comm-to-target table.
JSON is written only where ``--outdir`` says. Runs on the card unless
``--device cpu``. ``--init-from`` starts every method from the initial
parameters in an ``.npz`` (keys ``method|path|to|leaf``, plus
``finetune_idx`` for FedAvg(Meta)); ``python tests/test_torch_experiment.py
--write-init init.npz`` writes the JAX reference's, so the port can
replay the committed comparison from the reference's starting point.
"""
from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np

from repro_torch.federated.experiment import (default_plan, format_table,
                                             run_comparison)
from repro_torch.kernels.meta_update.compress import CompressionConfig

TARGET_ACC = 0.12
METHOD = "fomaml"

VARIANTS = {
    "f32": {},
    "bf16": dict(block_dtype="bfloat16"),
    "int8+ef": dict(compression=CompressionConfig("int8")),
    # top-k values ride the bf16 wire dtype: 0.05·(4+2) = 0.3 B/param
    "topk0.05+ef": dict(compression=CompressionConfig("topk",
                                                      topk_frac=0.05),
                        block_dtype="bfloat16"),
}


def compression_plan(label: str, *, rounds=30, eval_every=2, seed=0,
                     num_clients=100, target=TARGET_ACC,
                     pipeline="client_plane"):
    """The committed compression sweep's plan for one variant."""
    return default_plan("femnist", methods=(METHOD,), rounds=rounds,
                        eval_every=eval_every, num_clients=num_clients,
                        target_acc=target, pipeline=pipeline, seed=seed,
                        name=f"compression_{label}", **VARIANTS[label])


def femnist_plan(*, rounds=100, eval_every=2, seed=0,
                 pipeline="client_plane"):
    """The committed FEMNIST comparison plan (five methods, FOMAML's
    inner_lr 0.05 from the registry's overrides)."""
    return default_plan("femnist", rounds=rounds, eval_every=eval_every,
                        seed=seed, pipeline=pipeline)


def upload_ratios(variants: dict, base: str = "bf16") -> dict:
    """Upload bytes to the target, the base variant's over each one's."""
    ratios = {}
    ref = variants[base]["comm_to_target"]
    for label, v in variants.items():
        row = v["comm_to_target"]
        if ref and row and row["upload_MB"] > 0:
            ratios[label] = round(ref["upload_MB"] / row["upload_MB"], 2)
    return ratios


def load_init(path: str):
    """An ``.npz`` of initial parameters -> ({method: nested dict of
    arrays}, finetune_idx or None)."""
    init, ft = {}, None
    with np.load(path) as z:
        for key in z.files:
            if key == "finetune_idx":
                ft = z[key]
                continue
            method, *parts = key.split("|")
            node = init.setdefault(method, {})
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return init, ft


def sweep_compression(*, rounds, eval_every, seed, device,
                      pipeline="client_plane", log=print, init=(None, None),
                      around=None):
    """FOMAML under each of the four upload codecs. ``around(label,
    run)``, where given, is called in place of ``run()`` for each
    variant (``run`` returns `run_comparison`'s record), so a caller can
    time or count each run and keep its final state."""
    variants = {}
    for label in VARIANTS:
        plan = compression_plan(label, rounds=rounds, eval_every=eval_every,
                                seed=seed, pipeline=pipeline)
        run = functools.partial(run_comparison, plan, log, device=device,
                                init_params=init[0], finetune_idx=init[1])
        out = around(label, run) if around else run()
        rec = out["methods"][METHOD]
        variants[label] = {"history": rec["history"],
                           "test_acc": rec["test_acc"], "comm": rec["comm"],
                           "comm_to_target": out["comm_to_target"].get(
                               METHOD),
                           "seconds": rec["seconds"]}
    return {"dataset": "femnist", "method": METHOD, "target_acc": TARGET_ACC,
            "rounds": rounds, "seed": seed, "sustain_evals": 2,
            "baseline": "bf16", "device": device, "variants": variants,
            "upload_to_target_ratio_vs_bf16": upload_ratios(variants)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", choices=("compression", "femnist"),
                    default="compression")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 30 (compression), 100 (femnist)")
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default=None,
                    help="write the JSON record here (default: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipeline", default="client_plane",
                    choices=("tree", "packed", "client_plane"))
    ap.add_argument("--init-from", default=None,
                    help=".npz of initial parameters (see load_init)")
    args = ap.parse_args(argv)
    init = load_init(args.init_from) if args.init_from else (None, None)
    if args.sweep == "compression":
        out = sweep_compression(rounds=args.rounds or 30,
                                eval_every=args.eval_every, seed=args.seed,
                                device=args.device, pipeline=args.pipeline,
                                init=init)
        for label, v in out["variants"].items():
            print(f"[{label}] upload_MB/round "
                  f"{v['comm']['upload_MB'] / out['rounds']:.6f} "
                  f"to-target {v['comm_to_target']}")
        print("upload-bytes-to-target vs bf16:",
              out["upload_to_target_ratio_vs_bf16"])
        name = "compression_femnist.json"
    else:
        plan = femnist_plan(rounds=args.rounds or 100,
                            eval_every=args.eval_every, seed=args.seed,
                            pipeline=args.pipeline)
        out = run_comparison(plan, print, device=args.device,
                             init_params=init[0], finetune_idx=init[1])
        out.pop("states")
        print(format_table(out))
        name = "femnist_compare.json"
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        path = os.path.join(args.outdir, name)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
