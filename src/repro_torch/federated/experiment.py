"""The experiment plane: FedMeta against FedAvg under identical
conditions. Counterpart of `repro/federated/experiment.py:59-698`.

The paper's headline claims are comparisons — FedMeta reaches a target
accuracy with 2.82–4.33× less communication than FedAvg — and a
comparison only means something when every method runs on the same
client split, the same per-round sampling stream and honest byte
accounting. `run_comparison(plan)` enforces that:

  * one dataset, one `split_clients(seed)`, shared by every method;
  * one `sample_task_batch` per round from ``RandomState(seed)`` in
    every trainer, so round r samples the same clients for every method
    (FedAvg's local minibatches come from a separate stream);
  * per-round history records with cumulative bytes, per-method θ size;
  * the paper's comm-to-target metric (`comm_to_target`) against one
    shared target, and per-method fairness statistics.

The port has the FEMNIST scenario. The other datasets and the knobs of
later slices (the population plane, prefetching and fused rounds)
raise, naming their slice. The plan's ``compression``, ``dp``,
``block_dtype`` and ``opt_state_dtype`` run the bytes-on-the-wire
round; its ``faults``, ``aggregator``, ``screen_factor`` and ``trim``
the failure plane (packed pipelines only).

Injection: `run_comparison` takes the reference's initial parameters
(``init_params``) and FedAvg(Meta)'s fine-tune indices
(``finetune_idx``), the draws torch cannot reproduce, so a CPU parity
test starts the port where the reference starts. Without them nothing
changes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from repro_torch.federated.fedavg import FedAvgTrainer
from repro_torch.federated.privacy import DPConfig
from repro_torch.federated.server import (FederatedTrainer, evaluate_global,
                                         evaluate_meta)
from repro_torch.kernels.meta_update.compress import CompressionConfig

FEDMETA_METHODS = ("maml", "fomaml", "meta-sgd", "reptile")
FEDAVG_METHODS = ("fedavg", "fedavg(meta)")
DEFAULT_METHODS = FEDAVG_METHODS + ("maml", "fomaml", "meta-sgd")


def _femnist_data(num_clients, seed):
    from repro_torch.data import make_femnist
    return make_femnist(num_clients=num_clients, mean_samples=60, seed=seed)


def _femnist_model(device):
    from repro_torch.models.paper import femnist_cnn
    return femnist_cnn(num_classes=62, hidden=128, device=device)


# dataset name -> builders + paper-Table-4-shaped hyperparameters (the
# reference's values). Learning rates may be tuned per algorithm
# (method_overrides); the sharing discipline is about splits, sampling
# streams and byte accounting.
DATASETS = {
    "femnist": dict(data=_femnist_data, model=_femnist_model,
                    inner_lr=0.01, outer_lr=1e-3, local_lr=1e-3,
                    clients_per_round=4, support_size=16, query_size=16,
                    num_clients=100,
                    # first-order MAML stagnates at inner_lr=0.01 on
                    # synthetic femnist; 0.05 converges
                    method_overrides={"fomaml": {"inner_lr": 0.05}}),
}
# the reference's other scenarios and the port slice that brings each
PENDING_DATASETS = {"sent140": "scenario", "shakespeare": "scenario",
                    "recommend": "scenario", "lm": "scenario"}


def _scenario(dataset: str) -> dict:
    if dataset in PENDING_DATASETS:
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet: it joins the port "
            f"with the {PENDING_DATASETS[dataset]} slice")
    return DATASETS.get(dataset, {})


@dataclasses.dataclass
class ExperimentPlan:
    """Everything needed to reproduce one FedMeta-vs-FedAvg comparison.
    The fields are the reference's, so ``to_json`` gives the same keys.

    ``pipeline`` picks the FedMeta substrate: "tree", "packed" or
    "client_plane" (the baselines are substrate-independent).
    ``data_fn(num_clients, seed)``, ``model_fn(device)`` and
    ``loss_builder(model)`` override the named registry (callables are
    not serialized); ``meta_model_fn``/``meta_data_fn`` (the recommend
    scenario's local head) wait for the scenario slice."""
    dataset: str
    methods: Sequence[str] = DEFAULT_METHODS
    rounds: int = 100
    eval_every: int = 10
    num_clients: int = 100
    clients_per_round: int = 4
    support_frac: float = 0.2
    support_size: int = 16
    query_size: int = 16
    inner_lr: float = 0.01
    inner_steps: int = 1
    outer_lr: float = 1e-3
    local_lr: float = 1e-3
    local_steps: int = 3
    target_acc: Optional[float] = None   # None = shared reachable target
    # a target counts as reached only when held for this many
    # consecutive evals (charged at the window's last round)
    sustain_evals: int = 2
    pipeline: str = "tree"               # tree | packed | client_plane
    client_chunk: Optional[int] = None
    prefetch_depth: int = 0              # async slice
    flush_every: int = 1
    fuse_rounds: int = 1                 # async slice
    aggregator: str = "mean"             # failure plane (packed only)
    screen_factor: float = 3.0
    trim: int = 1
    faults: Optional[object] = None      # FaultConfig (packed only)
    lazy_population: bool = False        # population slice
    independent_population: bool = False
    cache_clients: Optional[int] = None
    eval_clients_cap: Optional[int] = None
    over_select: float = 0.0             # population slice
    round_deadline: Optional[float] = None
    unreliability: Optional[object] = None
    pool_workers: int = 0
    # bytes-on-the-wire plane: upload compression and central DP for the
    # FedMeta methods (packed pipelines only; FedAvg ships dense models).
    # Dtypes are NAMES ("bfloat16") so plans stay JSON-serializable.
    compression: Optional[CompressionConfig] = None
    dp: Optional[DPConfig] = None
    block_dtype: Optional[str] = None
    opt_state_dtype: Optional[str] = None
    local_head: Optional[int] = None
    # per-method lr/step overrides: {"fomaml": {"inner_lr": 0.05}}
    method_overrides: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    name: str = ""
    data_fn: Optional[Callable] = None
    model_fn: Optional[Callable] = None
    loss_builder: Optional[Callable] = None
    meta_model_fn: Optional[Callable] = None
    meta_data_fn: Optional[Callable] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for fn in ("data_fn", "model_fn", "loss_builder", "meta_model_fn",
                   "meta_data_fn"):
            d.pop(fn)
        d["methods"] = list(self.methods)
        return d


def default_plan(dataset: str, **overrides) -> ExperimentPlan:
    """Plan with the registry hyperparameters for a named dataset.

    >>> default_plan("femnist").method_overrides
    {'fomaml': {'inner_lr': 0.05}}
    """
    su = _scenario(dataset)
    if not su:
        raise KeyError(f"unknown dataset {dataset!r}")
    base = dict(clients_per_round=su["clients_per_round"],
                support_size=su["support_size"],
                query_size=su["query_size"], inner_lr=su["inner_lr"],
                outer_lr=su["outer_lr"], local_lr=su["local_lr"],
                num_clients=su["num_clients"],
                # copy: plans must not alias (and mutate) the registry
                method_overrides={k: dict(v) for k, v in
                                  su.get("method_overrides", {}).items()})
    for opt in ("support_frac", "local_head", "inner_steps"):
        if opt in su:
            base[opt] = su[opt]
    base.update(overrides)
    return ExperimentPlan(dataset=dataset, **base)


def _dtype(name):
    import torch
    return getattr(torch, name)


def make_trainer(plan: ExperimentPlan, method: str, loss_fn, eval_fn,
                 train_clients, *, device="cuda", impl=None,
                 finetune_idx=None):
    """One trainer per method, all sharing the plan's sampling config:
    FedAvg methods get a `FedAvgTrainer` (full-model shipping), FedMeta
    methods a `FederatedTrainer` on the plan's pipeline, with
    ``method_overrides`` applied per method. ``impl`` ("cuda" or
    "torch") picks the FedMeta kernels' route."""
    common = dict(clients_per_round=plan.clients_per_round,
                  support_frac=plan.support_frac,
                  support_size=plan.support_size,
                  query_size=plan.query_size, seed=plan.seed,
                  prefetch_depth=plan.prefetch_depth,
                  flush_every=plan.flush_every, device=device)
    over = plan.method_overrides.get(method, {})
    if method in FEDAVG_METHODS:
        return FedAvgTrainer(
            loss_fn, eval_fn,
            local_lr=over.get("local_lr", plan.local_lr),
            local_steps=over.get("local_steps", plan.local_steps),
            train_clients=train_clients, client_chunk=plan.client_chunk,
            meta_eval=(method == "fedavg(meta)"),
            finetune_idx=finetune_idx, **common)
    from repro_torch.core import make_algorithm
    from repro_torch.optim import adam
    algo = make_algorithm(method, loss_fn, eval_fn,
                          inner_lr=over.get("inner_lr", plan.inner_lr),
                          inner_steps=over.get("inner_steps",
                                               plan.inner_steps))
    packed = plan.pipeline in ("packed", "client_plane")
    if (plan.faults is not None or plan.aggregator != "mean") and not packed:
        raise ValueError("plan.faults / plan.aggregator need the packed "
                         "pipeline — set pipeline='packed' or "
                         "'client_plane'")
    if (plan.compression is not None or plan.dp is not None
            or plan.block_dtype) and not packed:
        raise ValueError("plan.compression / plan.dp / plan.block_dtype "
                         "need the packed pipeline — set pipeline="
                         "'packed' or 'client_plane'")
    opt_kw = {}
    if plan.opt_state_dtype:
        # bf16 Adam moments: K3 keeps m and v in this dtype
        opt_kw["state_dtype"] = _dtype(plan.opt_state_dtype)
    pop = {}
    if (plan.unreliability is not None or plan.over_select
            or plan.round_deadline is not None or plan.pool_workers):
        if (plan.unreliability is not None or plan.over_select
                or plan.round_deadline is not None) and not packed:
            raise ValueError("plan.unreliability / over_select / "
                             "round_deadline need the packed pipeline — "
                             "set pipeline='packed' or 'client_plane'")
        pop = dict(unreliability=plan.unreliability,
                   over_select=plan.over_select,
                   round_deadline=plan.round_deadline,
                   pool_workers=plan.pool_workers)
    return FederatedTrainer(
        algo, adam(over.get("outer_lr", plan.outer_lr), **opt_kw),
        train_clients,
        client_axis="chunked" if plan.client_chunk else "vmap",
        client_chunk=plan.client_chunk, packed=packed,
        client_plane=(plan.pipeline == "client_plane"),
        block_dtype=(_dtype(plan.block_dtype) if plan.block_dtype
                     else None),
        impl=impl, compression=plan.compression, dp=plan.dp,
        fuse_rounds=plan.fuse_rounds if packed else 1,
        aggregator=plan.aggregator, screen_factor=plan.screen_factor,
        trim=plan.trim, faults=plan.faults, **pop, **common)


@dataclasses.dataclass
class _View:
    """One method family's view of the scenario: the client splits it
    trains and evaluates on, and the model and loss that go with them."""
    train: list
    val: list
    test: list
    model: object
    loss_fn: Callable
    eval_fn: Callable


def _build_views(plan: ExperimentPlan, su: dict, device="cuda"):
    """-> (global_view, meta_view). FEMNIST has no per-method asymmetry,
    so the two are one view; the local-head scenarios (meta_model /
    meta_data) join with the scenario slice."""
    from repro_torch.core.losses import classification_loss
    if plan.lazy_population:
        raise NotImplementedError("plan.lazy_population is not ported yet: "
                                  "it joins the port with the population "
                                  "slice")
    if (plan.meta_model_fn or su.get("meta_model") or plan.meta_data_fn
            or su.get("meta_data")):
        raise NotImplementedError("per-method model/data views are not "
                                  "ported yet: they join the port with "
                                  "the scenario slice")
    data_fn = plan.data_fn or su["data"]
    model_fn = plan.model_fn or su["model"]
    loss_builder = plan.loss_builder or su.get("loss") or (
        lambda model: classification_loss(model.apply))
    ds = data_fn(plan.num_clients, plan.seed)
    train, val, test = ds.split_clients(seed=plan.seed)
    model = model_fn(device)
    view = _View(train, val, test, model, *loss_builder(model))
    return view, view


def _cap_clients(clients, cap: Optional[int]):
    """Bound an eval cohort to its first ``cap`` clients."""
    return clients[:cap] if cap and len(clients) > cap else clients


def _eval_records(history: list) -> list:
    return [rec for rec in history if rec.get("eval_acc") is not None]


def comm_to_target(history: list, target_acc: float,
                   sustain: int = 1) -> Optional[dict]:
    """The paper's Fig.-3 metric: cumulative communication (and client
    compute) to reach ``target_acc`` on held-out clients.

    With ``sustain=k`` the target must hold on k consecutive evals, and
    the cost is charged at the LAST round of the first such window.
    Records carry cumulative fields, so the result is monotone in the
    target. None when the target is never (sustainably) reached.

    >>> hist = [{"round": r, "eval_acc": 0.1 * r, "comm_MB": 2.0 * r,
    ...          "upload_MB": r, "download_MB": r, "client_GFLOPs": 0.0}
    ...         for r in (1, 2, 3)]
    >>> comm_to_target(hist, 0.2)["rounds"]
    2
    """
    evals = _eval_records(history)
    k = max(1, min(sustain, len(evals)))
    for i in range(len(evals) - k + 1):
        window = evals[i:i + k]
        if all(rec["eval_acc"] >= target_acc for rec in window):
            rec = window[-1]
            return {"rounds": rec["round"], "comm_MB": rec["comm_MB"],
                    "upload_MB": rec["upload_MB"],
                    "download_MB": rec["download_MB"],
                    "client_GFLOPs": rec["client_GFLOPs"],
                    "eval_acc": rec["eval_acc"]}
    return None


def fairness_stats(per_client) -> dict:
    """Accuracy-distribution summary across clients: deciles, variance
    and the mean over the worst-off 10% of clients.

    >>> fairness_stats([1.0, 0.0])["worst10_mean"]
    0.0
    """
    import numpy as np
    a = np.sort(np.asarray(per_client, np.float64))
    k = max(1, int(np.ceil(0.1 * len(a))))
    return {
        "mean": float(a.mean()),
        "variance": float(a.var()),
        "deciles": [float(np.percentile(a, p)) for p in range(10, 100, 10)],
        "worst10_mean": float(a[:k].mean()),
        "num_clients": int(len(a)),
    }


def _sustained_best(history: list, sustain: int) -> Optional[float]:
    """Best accuracy the method HELD for ``sustain`` consecutive evals."""
    evals = [rec["eval_acc"] for rec in _eval_records(history)]
    if not evals:
        return None
    k = max(1, min(sustain, len(evals)))
    return max(min(evals[i:i + k]) for i in range(len(evals) - k + 1))


def _shared_target(results: dict, sustain: int) -> Optional[float]:
    """Highest accuracy every method sustainably reached."""
    best = []
    for r in results.values():
        b = _sustained_best(r["history"], sustain)
        if b is None:
            return None
        best.append(b)
    return min(best) if best else None


def run_comparison(plan: ExperimentPlan, log: Callable = None, *,
                   device="cuda", impl=None, init_params=None,
                   finetune_idx=None) -> dict:
    """Run every plan method on the shared split and stream; return the
    comparison record, schema as the reference's. It writes no file:
    `launch/compare.py --outdir` does, so no run can overwrite the
    committed reference artifacts under ``results/``. ``device``: where the trainers run; ``impl``: the
    FedMeta kernels' route ("cuda" or "torch"). ``init_params``
    ({method: numpy tree}, see `convert.initial_params`) and
    ``finetune_idx`` inject the reference's draws. Beside the
    reference's keys the record carries ``states``, each method's final
    train state (not written to the file)."""
    from repro_torch.convert import initial_params
    say = log or (lambda *a, **k: None)
    su = _scenario(plan.dataset)
    gview, mview = _build_views(plan, su, device)

    results = {}
    for method in plan.methods:
        view = gview if method in FEDAVG_METHODS else mview
        val = _cap_clients(view.val, plan.eval_clients_cap)
        test = _cap_clients(view.test, plan.eval_clients_cap)
        tr = make_trainer(plan, method, view.loss_fn, view.eval_fn,
                          view.train, device=device, impl=impl,
                          finetune_idx=finetune_idx)
        init = None
        if init_params is not None:
            init = initial_params(method, init_params[method], device)
        if method in FEDAVG_METHODS:
            state = tr.init(plan.seed, view.model.init, theta=init)
        else:
            state = tr.init(plan.seed, view.model.init, phi=init)
        tr.measure_flops(state)
        t0 = time.perf_counter()
        state = tr.run(state, plan.rounds, eval_every=plan.eval_every,
                       eval_clients=val)
        seconds = time.perf_counter() - t0
        if method in FEDAVG_METHODS:
            test_acc, per_client, test_loss = evaluate_global(
                view.eval_fn, state["theta"], test,
                support_frac=plan.support_frac,
                support_size=plan.support_size, query_size=plan.query_size,
                seed=plan.seed, evaluator=tr.evaluator())
        else:
            test_acc, per_client, test_loss = evaluate_meta(
                tr.algo, tr.phi_tree(state), test,
                support_frac=plan.support_frac,
                support_size=plan.support_size, query_size=plan.query_size,
                seed=plan.seed, evaluator=tr.evaluator())
        results[method] = {
            "history": tr.history,
            "test_acc": test_acc, "test_loss": test_loss,
            "per_client": [float(a) for a in per_client],
            "fairness": fairness_stats(per_client),
            "comm": tr.comm.summary(), "seconds": seconds,
            "state": state,
        }
        say(f"[{plan.dataset}] {method}: test_acc={test_acc:.4f} "
            f"comm_MB={tr.comm.summary()['comm_MB']:.2f} "
            f"phi_MB={tr.comm.summary()['phi_MB']:.4f} ({seconds:.1f}s)")

    target = plan.target_acc if plan.target_acc is not None \
        else _shared_target(results, plan.sustain_evals)
    table = {}
    if target is not None:
        table = {m: comm_to_target(r["history"], target,
                                   sustain=plan.sustain_evals)
                 for m, r in results.items()}
        base = table.get("fedavg")
        # FedAvg never (sustainably) reaching the target is itself the
        # paper's claim: reductions then use its full-run spend and are
        # lower bounds
        if base is not None:
            base_mb, bound = base["comm_MB"], False
        elif "fedavg" in results:
            base_mb, bound = results["fedavg"]["comm"]["comm_MB"], True
        else:
            base_mb, bound = None, False
        for m, row in table.items():
            if row and base_mb and row["comm_MB"]:
                row["comm_reduction_vs_fedavg"] = round(
                    base_mb / row["comm_MB"], 2)
                if bound:
                    row["comm_reduction_is_lower_bound"] = True

    out = {"plan": plan.to_json(), "target_acc": target,
           "comm_to_target": table,
           "methods": {m: {k: v for k, v in r.items()
                           if k not in ("per_client", "state")}
                       for m, r in results.items()},
           "per_client": {m: r["per_client"] for m, r in results.items()}}
    out["states"] = {m: r["state"] for m, r in results.items()}
    return out


def format_table(out: dict) -> str:
    """Human-readable comm-to-target table for one comparison record."""
    lines = [f"target accuracy: {out['target_acc']}",
             f"{'method':<14} {'rounds':>6} {'comm_MB':>9} {'up_MB':>8} "
             f"{'down_MB':>8} {'GFLOPs':>8} {'test_acc':>8} {'vs_fedavg':>9}"]
    for m, res in out["methods"].items():
        row = (out.get("comm_to_target") or {}).get(m)
        if row:
            red = row.get("comm_reduction_vs_fedavg", "")
            if red and row.get("comm_reduction_is_lower_bound"):
                red = f">={red}"
            lines.append(
                f"{m:<14} {row['rounds']:>6} {row['comm_MB']:>9.2f} "
                f"{row['upload_MB']:>8.2f} {row['download_MB']:>8.2f} "
                f"{row['client_GFLOPs']:>8.2f} {res['test_acc']:>8.4f} "
                f"{red:>9}")
        else:
            lines.append(f"{m:<14} {'—':>6} {'—':>9} {'—':>8} {'—':>8} "
                         f"{'—':>8} {res['test_acc']:>8.4f} {'—':>9}")
    return "\n".join(lines)
