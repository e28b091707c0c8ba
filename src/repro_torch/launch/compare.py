"""Experiment-plane launcher of the port: the counterpart of
`examples/compression_femnist.py` (``--sweep compression``), of the
comparison plans behind ``results/experiments/{femnist,sent140,
recommend}_compare.json`` and the registry's other scenarios (``--sweep
femnist|sent140|shakespeare|recommend|lm``), of
`examples/robustness_femnist.py` (``--sweep robustness``) and of
`examples/population_scale.py` (``--sweep population``).

    PYTHONPATH=src python -m repro_torch.launch.compare --sweep compression
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep sent140 \\
        --device cpu --pipeline tree --init-from init.npz --outdir /tmp/f
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep robustness
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep femnist \\
        --pipeline packed --prefetch-depth 2 --fuse-rounds 2 --flush-every 4
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep population
    PYTHONPATH=src python -m repro_torch.launch.compare --sweep sent140 \\
        --pipeline packed --lazy-population --over-select 0.5 \\
        --unreliable-fail-rate 0.25 --round-deadline 1.5 --pool-workers 2

``compression``: FOMAML on FEMNIST under four upload codecs — dense f32,
a bf16 block, int8 with error feedback and top-5% with error feedback
(bf16 values) — on the same split and stream, target accuracy 0.12; it
prints each variant's bytes and the upload-bytes-to-target ratio against
bf16. A scenario (``femnist``, ``sent140``, ``shakespeare``,
``recommend``, ``lm``): FedAvg, FedAvg(Meta), MAML, FOMAML and Meta-SGD
on the committed comparison plan where one exists (FEMNIST 100 rounds,
Sent140 and the recommender 60, an eval every 2; Sent140's target 0.7),
else on the registry's defaults; it prints the comm-to-target table.
``robustness``: FOMAML on FEMNIST (60 clients, 8 a round, 40 rounds,
eval every 5) under five failure scenarios — clean, dropout 0.25,
sign-flip ×10 Byzantine at 0.125 and 0.25, non-finite 0.125 — each with
the mean, screened and trimmed (trim 2) aggregators on the packed
pipeline, the committed `results/experiments/robustness_femnist.json`'s
settings; it writes that file's JSON shape (``--rounds``,
``--eval-every`` and ``--clients`` cut it down). ``population``: FOMAML
on Sent140 (100 clients served from a lazy registry with a 32-client
LRU through 2 pool workers, 8 a round, 60 rounds, eval every 3) in three
cells on one split and task stream — ``clean`` (everyone arrives),
``overselect`` (per-round failures at 0.65 and a 0.75 deadline,
countered by over-selection ×5 candidates) and ``baseline`` (the same
failures, no over-selection) — the committed
`results/experiments/population_sent140.json`'s settings and JSON shape
(``--rounds``, ``--eval-every`` and ``--clients`` cut it down). The
scenario sweeps take the population flags of
`examples/compare_fedmeta_fedavg.py` (``--lazy-population``,
``--cache-clients``, ``--over-select``, ``--round-deadline``,
``--unreliable-fail-rate``, ``--pool-workers``, ``--eval-clients-cap``;
the arrival knobs reach the FedMeta methods on a packed pipeline).
JSON is written only where ``--outdir`` says. Runs on the card unless
``--device cpu``. ``--init-from`` starts every method from the initial
parameters in an ``.npz`` (keys ``method|path|to|leaf``, plus
``finetune_idx`` for FedAvg(Meta)); ``python tests/test_torch_experiment.py
--write-init init.npz [--dataset sent140]`` writes the JAX reference's,
so the port can replay a committed comparison from the reference's
starting point.
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


# the committed comparison artifacts' plans
# (results/experiments/<dataset>_compare.json), beside the registry's
COMMITTED_PLANS = {"femnist": dict(rounds=100, eval_every=2),
                   "sent140": dict(rounds=60, eval_every=2, target_acc=0.7),
                   "recommend": dict(rounds=60, eval_every=2)}
SCENARIOS = ("femnist", "sent140", "shakespeare", "recommend", "lm")


def comparison_plan(dataset: str, *, rounds=None, eval_every=None, seed=0,
                    pipeline="client_plane", **engine):
    """The committed comparison plan of ``dataset`` (five methods, the
    registry's hyperparameters and overrides), or the registry's
    defaults where no artifact exists; ``rounds`` and ``eval_every``
    override either. ``engine`` sets the async round engine's knobs
    (``prefetch_depth``, ``flush_every``, ``fuse_rounds``)."""
    kw = dict(COMMITTED_PLANS.get(dataset, {}))
    kw.update({k: v for k, v in (("rounds", rounds),
                                 ("eval_every", eval_every))
               if v is not None})
    return default_plan(dataset, seed=seed, pipeline=pipeline, **kw,
                        **engine)


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


# the committed population artifact (`examples/population_scale.py`):
# FOMAML on Sent140 under an unreliable fleet
POPULATION = dict(dataset="sent140", rounds=60, eval_every=3, clients=100,
                  clients_per_round=8, support_frac=0.2, support_size=16,
                  query_size=16, inner_lr=0.01, outer_lr=1e-3,
                  fail_rate=0.65, round_deadline=0.75, over_select=4.0,
                  cache_clients=32, pool_workers=2, seed=0)
POPULATION_CELLS = ("clean", "overselect", "baseline")


def population_cell(name, *, data, model, cfg, device="cuda", impl=None,
                    init_phi=None, around=None):
    """One cell of the population sweep, as the reference's `run_cell`:
    a packed FOMAML `FederatedTrainer` on the vmap axis with the cell's
    arrival model, over-selection and deadline (``clean``: none), its
    eval curve, loss curve, cohort accounting and comm block.
    ``init_phi``, a numpy φ tree, replaces the port's own initial
    parameters; ``around(name, run)``, where given, is called in place of
    ``run()`` (which returns (trainer, final state))."""
    from repro_torch.convert import initial_params
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.federated.population import UnreliabilityConfig
    from repro_torch.federated.server import FederatedTrainer, evaluate_meta
    from repro_torch.optim import adam
    train, val, test = data
    m = cfg["clients_per_round"]
    unrel = (None if name == "clean" else
             UnreliabilityConfig(fail_rate=cfg["fail_rate"],
                                 seed=cfg["seed"]))
    over_select = cfg["over_select"] if name == "overselect" else 0.0
    deadline = None if name == "clean" else cfg["round_deadline"]
    loss_fn, eval_fn = classification_loss(model.apply)
    algo = make_algorithm("fomaml", loss_fn, eval_fn,
                          inner_lr=cfg["inner_lr"])
    tr = FederatedTrainer(
        algo, adam(cfg["outer_lr"]), train, m,
        support_frac=cfg["support_frac"], support_size=cfg["support_size"],
        query_size=cfg["query_size"], seed=cfg["seed"], packed=True,
        unreliability=unrel, over_select=over_select,
        round_deadline=deadline, pool_workers=cfg["pool_workers"],
        impl=impl, device=device)

    def run():
        phi = (None if init_phi is None
               else initial_params("fomaml", init_phi, device))
        state = tr.init(cfg["seed"], model.init, phi=phi)
        return tr, tr.run(state, cfg["rounds"],
                          eval_every=cfg["eval_every"], eval_clients=val)

    _, state = around(name, run) if around else run()
    test_acc, _, test_loss = evaluate_meta(
        algo, tr.phi_tree(state), test, support_frac=cfg["support_frac"],
        support_size=cfg["support_size"], query_size=cfg["query_size"],
        seed=cfg["seed"], evaluator=tr.evaluator())
    curve = [[r["round"], r["eval_acc"]] for r in tr.history
             if "eval_acc" in r]
    arrived = [r["arrived"] for r in tr.history if "arrived" in r]
    skipped = int(sum(r.get("skipped", 0.0) for r in tr.history))
    mean_arr = (sum(arrived) / len(arrived)) if arrived else float(m)
    rounds = cfg["rounds"]
    return {
        "cell": name, "over_select": over_select,
        "round_deadline": deadline,
        "fail_rate": unrel.fail_rate if unrel else 0.0,
        "final_val_acc": curve[-1][1] if curve else None,
        "best_val_acc": max((a for _, a in curve), default=None),
        "final_test_acc": test_acc, "final_test_loss": test_loss,
        "eval_curve": curve,
        # the per-round meta query loss; a guard-skipped round has none
        "loss_curve": [[r["round"], r["query_loss"]] for r in tr.history
                       if "query_loss" in r
                       and r["query_loss"] == r["query_loss"]],
        "rounds": rounds, "skipped_rounds": skipped,
        "dead_round_frac": skipped / rounds,
        "mean_arrived": mean_arr, "cohort_fill": mean_arr / m,
        # the client updates that reached the aggregator
        "client_updates": (int(round(sum(arrived))) if arrived
                           else m * rounds),
        "comm": tr.comm.summary(),
    }


def sweep_population(*, device="cuda", impl=None, init=(None, None),
                     log=print, around=None, **overrides):
    """The three population cells on one lazy Sent140 registry, split and
    task stream -> the committed artifact's JSON shape (``config``,
    ``headline``, ``registry_cache``, ``cells``). ``overrides`` replace
    `POPULATION` settings; ``init`` is `load_init`'s pair (the FOMAML φ
    is used)."""
    from repro_torch.federated.experiment import DATASETS
    cfg = {**POPULATION, **overrides}
    su = DATASETS[cfg["dataset"]]
    # the lazy sequential registry: bitwise the eager dataset, clients
    # materialized on demand into a bounded LRU
    reg = su["data"](cfg["clients"], cfg["seed"], lazy=True,
                     cache_clients=cfg["cache_clients"])
    data = reg.split_clients(seed=cfg["seed"])
    model = su["model"](device)
    init_phi = init[0]["fomaml"] if init[0] is not None else None
    cells = []
    for name in POPULATION_CELLS:
        cell = population_cell(name, data=data, model=model, cfg=cfg,
                               device=device, impl=impl, init_phi=init_phi,
                               around=around)
        cells.append(cell)
        if log:
            log(f"[{name:10s}] final_val={cell['final_val_acc']:.4f} "
                f"fill={cell['cohort_fill']:.2f} "
                f"dead={cell['skipped_rounds']}/{cfg['rounds']} "
                f"updates={cell['client_updates']}")
    headline = {c["cell"]: {
        "final_val_acc": c["final_val_acc"],
        "best_val_acc": c["best_val_acc"],
        "cohort_fill": round(c["cohort_fill"], 3),
        "dead_round_frac": round(c["dead_round_frac"], 3),
        "client_updates": c["client_updates"],
    } for c in cells}
    config = {"method": "fomaml", **cfg,
              "regen": "PYTHONPATH=src python -m repro_torch.launch.compare "
                       "--sweep population"}
    return {"config": config, "headline": headline,
            "registry_cache": reg.cache_stats(), "cells": cells}


def population_overrides(args) -> dict:
    """The scenario sweeps' population flags -> `ExperimentPlan` fields
    (as `examples/compare_fedmeta_fedavg.py` maps them)."""
    over = {}
    if args.lazy_population:
        over.update(lazy_population=True,
                    cache_clients=args.cache_clients or None)
    if args.over_select:
        over["over_select"] = args.over_select
    if args.round_deadline:
        over["round_deadline"] = args.round_deadline
    if args.unreliable_fail_rate:
        from repro_torch.federated.population import UnreliabilityConfig
        over["unreliability"] = UnreliabilityConfig(
            fail_rate=args.unreliable_fail_rate, seed=args.seed)
    if args.pool_workers:
        over["pool_workers"] = args.pool_workers
    if args.eval_clients_cap:
        over["eval_clients_cap"] = args.eval_clients_cap
    return over


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", choices=("compression", "robustness",
                                        "population") + SCENARIOS,
                    default="compression")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default: 30 (compression), 40 (robustness), the "
                         "committed plan's or else the registry's "
                         "(scenarios)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="default: 2 (compression), 5 (robustness), the "
                         "committed plan's or else the registry's "
                         "(scenarios)")
    ap.add_argument("--clients", type=int, default=None,
                    help="robustness / population: the client population "
                         "(default 60 / 100)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default=None,
                    help="write the JSON record here (default: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pipeline", default="client_plane",
                    choices=("tree", "packed", "client_plane"))
    ap.add_argument("--init-from", default=None,
                    help=".npz of initial parameters (see load_init)")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="scenarios: async round engine, staged round "
                         "blocks ahead of the device (0 = synchronous "
                         "loop; the history is bitwise equal either way)")
    ap.add_argument("--flush-every", type=int, default=1,
                    help="scenarios: deferred-metrics drain cadence (0 = "
                         "at eval rounds and exit)")
    ap.add_argument("--fuse-rounds", type=int, default=1,
                    help="scenarios: rounds a fused block runs back to "
                         "back (packed pipelines)")
    ap.add_argument("--lazy-population", action="store_true",
                    help="scenarios: serve clients from the lazy "
                         "ClientRegistry (sequential mode: bitwise the "
                         "eager dataset)")
    ap.add_argument("--cache-clients", type=int, default=0,
                    help="scenarios: LRU cap on resident lazy clients "
                         "(0 = unbounded)")
    ap.add_argument("--over-select", type=float, default=0.0,
                    help="scenarios: sample m·(1+x) candidates a round, "
                         "aggregate the first m arrivals (FedMeta "
                         "methods; a packed pipeline)")
    ap.add_argument("--round-deadline", type=float, default=0.0,
                    help="scenarios: arrival latency cutoff, in the "
                         "arrival model's units (0 = no deadline)")
    ap.add_argument("--unreliable-fail-rate", type=float, default=0.0,
                    help="scenarios: per-(client, round) transient "
                         "failure probability of the arrival model")
    ap.add_argument("--pool-workers", type=int, default=0,
                    help="scenarios: client-materializing worker threads "
                         "(0 = inline)")
    ap.add_argument("--eval-clients-cap", type=int, default=0,
                    help="scenarios: cap on the val/test cohorts (large "
                         "lazy populations)")
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
    elif args.sweep == "population":
        over = {k: v for k, v in (("rounds", args.rounds),
                                  ("eval_every", args.eval_every),
                                  ("clients", args.clients))
                if v is not None}
        out = sweep_population(device=args.device, init=init,
                               seed=args.seed, **over)
        print(json.dumps(out["headline"], indent=1))
        name = f"population_{out['config']['dataset']}.json"
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
        plan = comparison_plan(args.sweep, rounds=args.rounds,
                               eval_every=args.eval_every, seed=args.seed,
                               pipeline=args.pipeline,
                               prefetch_depth=args.prefetch_depth,
                               flush_every=args.flush_every,
                               fuse_rounds=args.fuse_rounds,
                               **population_overrides(args))
        out = run_comparison(plan, print, device=args.device,
                             init_params=init[0], finetune_idx=init[1])
        out.pop("states")
        print(format_table(out))
        name = f"{args.sweep}_compare.json"
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        path = os.path.join(args.outdir, name)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
