"""Experiment-plane launcher of the port: the counterpart of
`examples/compression_femnist.py` (``--sweep compression``), of the
FEMNIST comparison plan behind `examples/femnist_fedmeta.py` and
``results/experiments/femnist_compare.json`` (``--sweep femnist``), and
of `examples/robustness_femnist.py` (``--sweep robustness``).

    PYTHONPATH=src python -m repro_torch.launch.compare --sweep compression
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep femnist \\
        --device cpu --pipeline tree --init-from init.npz --outdir /tmp/f
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep robustness

``compression``: FOMAML on FEMNIST under four upload codecs — dense f32,
a bf16 block, int8 with error feedback and top-5% with error feedback
(bf16 values) — on the same split and stream, target accuracy 0.12; it
prints each variant's bytes and the upload-bytes-to-target ratio against
bf16. ``femnist``: FedAvg, FedAvg(Meta), MAML, FOMAML and Meta-SGD on
the committed comparison plan; it prints the comm-to-target table.
``robustness``: FOMAML on FEMNIST (60 clients, 8 a round, 40 rounds,
eval every 5) under five failure scenarios — clean, dropout 0.25,
sign-flip ×10 Byzantine at 0.125 and 0.25, non-finite 0.125 — each with
the mean, screened and trimmed (trim 2) aggregators on the packed
pipeline, the committed `results/experiments/robustness_femnist.json`'s
settings; it writes that file's JSON shape (``--rounds``,
``--eval-every`` and ``--clients`` cut it down).
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


# the committed robustness sweep (`examples/robustness_femnist.py`):
# one failure mode per scenario, as a fraction of clients per round
ROBUSTNESS_SCENARIOS = (("clean", 0.0), ("dropout", 0.25),
                        ("byzantine", 0.125), ("byzantine", 0.25),
                        ("nonfinite", 0.125))
ROBUSTNESS_AGGREGATORS = ("mean", "screen", "trimmed")
ROBUSTNESS = dict(rounds=40, eval_every=5, clients=60, clients_per_round=8,
                  support_frac=0.2, support_size=16, query_size=16,
                  inner_lr=0.05, outer_lr=1e-3, trim=2, screen_factor=3.0,
                  byzantine_scale=10.0, seed=0)


def robustness_faults(kind: str, fraction: float, scale: float):
    """The scenario's `FaultConfig` (None for the clean one)."""
    from repro_torch.federated.faults import FaultConfig
    if kind == "clean" or fraction == 0.0:
        return None
    return FaultConfig(**{kind: fraction}, byzantine_scale=scale)


def robustness_cell(kind, fraction, aggregator, *, data, model, cfg,
                    device="cuda", impl=None, init_phi=None, around=None):
    """One cell of the robustness sweep, as the reference's `run_cell`:
    a packed `FederatedTrainer` with the cell's aggregator and faults
    (the guard on by default), its eval curve on the validation clients
    and its test accuracy. ``init_phi``, a numpy φ tree, replaces the
    port's own initial parameters; ``around(tag, run)``, where given, is
    called in place of ``run()`` (which returns (trainer, final state))."""
    from repro_torch.convert import initial_params
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.federated.server import FederatedTrainer, evaluate_meta
    from repro_torch.optim import adam
    train, val, test = data
    loss_fn, eval_fn = classification_loss(model.apply)
    algo = make_algorithm("fomaml", loss_fn, eval_fn,
                          inner_lr=cfg["inner_lr"])
    tr = FederatedTrainer(
        algo, adam(cfg["outer_lr"]), train, cfg["clients_per_round"],
        support_frac=cfg["support_frac"], support_size=cfg["support_size"],
        query_size=cfg["query_size"], seed=cfg["seed"], packed=True,
        aggregator=aggregator, trim=cfg["trim"],
        screen_factor=cfg["screen_factor"], impl=impl, device=device,
        faults=robustness_faults(kind, fraction, cfg["byzantine_scale"]))

    def run():
        phi = (None if init_phi is None
               else initial_params("fomaml", init_phi, device))
        state = tr.init(cfg["seed"], model.init, phi=phi)
        return tr, tr.run(state, cfg["rounds"],
                          eval_every=cfg["eval_every"], eval_clients=val)

    _, state = (around(f"{kind} {fraction} {aggregator}", run) if around
                else run())
    test_acc, _, test_loss = evaluate_meta(
        algo, tr.phi_tree(state), test, support_frac=cfg["support_frac"],
        support_size=cfg["support_size"], query_size=cfg["query_size"],
        seed=cfg["seed"], evaluator=tr.evaluator())
    curve = [[r["round"], r["eval_acc"]] for r in tr.history
             if "eval_acc" in r]
    return {
        "kind": kind, "fraction": fraction, "aggregator": aggregator,
        "final_test_acc": test_acc, "final_test_loss": test_loss,
        "best_val_acc": max((a for _, a in curve), default=None),
        "skipped_rounds": int(sum(r.get("skipped", 0.0)
                                  for r in tr.history)),
        "rounds": cfg["rounds"],
        "eval_curve": curve,
    }


def sweep_robustness(*, device="cuda", impl=None, init=(None, None),
                     log=print, around=None, cells=None, **overrides):
    """Every (scenario, aggregator) cell of the robustness sweep on one
    shared split and task stream -> the committed artifact's JSON shape
    (``config``, ``headline``, ``cells``). ``overrides`` replace
    `ROBUSTNESS` settings; ``cells``, a list of (kind, fraction,
    aggregator), runs those cells only; ``init`` is `load_init`'s pair
    (the FOMAML φ is used)."""
    from repro_torch.federated.experiment import DATASETS
    cfg = {**ROBUSTNESS, **overrides}
    su = DATASETS["femnist"]
    data = su["data"](cfg["clients"], cfg["seed"]).split_clients(
        seed=cfg["seed"])
    model = su["model"](device)
    init_phi = init[0]["fomaml"] if init[0] is not None else None
    todo = cells or [(k, f, a) for k, f in ROBUSTNESS_SCENARIOS
                     for a in ROBUSTNESS_AGGREGATORS]
    out_cells = []
    for kind, fraction, aggregator in todo:
        cell = robustness_cell(kind, fraction, aggregator, data=data,
                               model=model, cfg=cfg, device=device,
                               impl=impl, init_phi=init_phi, around=around)
        out_cells.append(cell)
        if log:
            log(f"[{kind} {fraction:.3f}] {aggregator:8s} "
                f"test_acc={cell['final_test_acc']:.4f} "
                f"skipped={cell['skipped_rounds']}/{cfg['rounds']}")
    headline = {}
    for kind, fraction in dict.fromkeys((c["kind"], c["fraction"])
                                        for c in out_cells):
        key = f"{kind}_{fraction}" if fraction else "clean"
        headline[key] = {c["aggregator"]: c["final_test_acc"]
                         for c in out_cells
                         if (c["kind"], c["fraction"]) == (kind, fraction)}
    config = {"dataset": "femnist", "method": "fomaml", **cfg,
              "byzantine_mode": "sign_flip",
              "regen": "PYTHONPATH=src python -m repro_torch.launch.compare "
                       "--sweep robustness"}
    return {"config": config, "headline": headline, "cells": out_cells}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", choices=("compression", "femnist",
                                        "robustness"),
                    default="compression")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 30 (compression), 100 (femnist), 40 "
                         "(robustness)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="default: 2 (compression, femnist), 5 "
                         "(robustness)")
    ap.add_argument("--clients", type=int, default=None,
                    help="robustness: the client population (default 60)")
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
    if args.sweep == "robustness":
        over = {k: v for k, v in (("rounds", args.rounds),
                                  ("eval_every", args.eval_every),
                                  ("clients", args.clients))
                if v is not None}
        out = sweep_robustness(device=args.device, init=init,
                               seed=args.seed, **over)
        print(json.dumps(out["headline"], indent=1))
        name = "robustness_femnist.json"
    elif args.sweep == "compression":
        out = sweep_compression(rounds=args.rounds or 30,
                                eval_every=args.eval_every or 2,
                                seed=args.seed,
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
                            eval_every=args.eval_every or 2, seed=args.seed,
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
