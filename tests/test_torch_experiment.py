"""Port parity: the experiment plane (`federated/experiment.py`) against
the JAX package's.

The pure functions (comm-to-target, the sustained target, fairness) are
held equal on the same histories. A reduced FEMNIST comparison — 24
clients, 4 rounds, an eval every 2, the five methods on the client
plane, plus FOMAML under int8 uploads with error feedback — runs in
both packages from the reference's initial parameters (and its
FedAvg(Meta) fine-tune draw): the byte fields are equal exactly; the
first round's metrics (taken before any φ update) at rtol 1e-4 /
atol 1e-5, the network tolerance of the other port tests. Numbers
taken after Adam has moved φ — later rounds' metrics, eval and test
accuracy and loss — are held looser, since a near-zero meta-gradient
entry moves φ by up to 2·lr in either package (see test_torch_fedmeta):
losses at rtol 2e-3, accuracies within 0.0125, two flipped predictions
of an accuracy counted over ~160 query examples (measured on the CPU:
accuracies equal, losses within 2.7e-4 relative)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.federated import experiment as jx
from repro.kernels.meta_update.compress import \
    CompressionConfig as JaxCompression
from repro_torch.federated import experiment as tx
from repro_torch.federated.faults import FaultConfig
from repro_torch.kernels.meta_update.compress import CompressionConfig

NET = dict(rtol=1e-4, atol=1e-5)
ACC_AFTER_ADAM, LOSS_AFTER_ADAM = 0.0125, dict(rtol=2e-3, atol=1e-6)
BYTES = ("rounds", "comm_MB", "upload_MB", "download_MB", "phi_MB")


def _mk_history(accs):
    return [{"round": r, "rounds": r, "comm_MB": 2.0 * r, "upload_MB": r,
             "download_MB": r, "client_GFLOPs": 0.5 * r,
             **({} if a is None else {"eval_acc": a})}
            for r, a in enumerate(accs, start=1)]


@pytest.mark.parametrize("accs,targets,sustain", [
    ([None, 0.3, None, 0.5, None, 0.7], (0.1, 0.3, 0.4, 0.5, 0.69, 0.71), 1),
    ([0.2, 0.6, 0.4, 0.8], (0.5, 0.7, 0.9), 1),
    ([0.2, 0.6, 0.4, 0.7, 0.8], (0.1, 0.5, 0.75), 2),
    ([0.2, 0.6, 0.4, 0.7, 0.8], (0.1,), 99)])
def test_comm_to_target_matches_reference(accs, targets, sustain):
    """Monotone in the target, the first (sustained) crossing, a single
    spike ignored under sustain=2 — row for row the reference's."""
    hist = _mk_history(accs)
    rows = [tx.comm_to_target(hist, t, sustain) for t in targets]
    assert rows == [jx.comm_to_target(hist, t, sustain) for t in targets]
    mbs = [r["comm_MB"] for r in rows if r is not None]
    assert mbs == sorted(mbs)
    assert tx._sustained_best(hist, sustain) == \
        jx._sustained_best(hist, sustain)
    res = {"a": {"history": hist}, "b": {"history": _mk_history([0.1, 0.4])}}
    assert tx._shared_target(res, sustain) == jx._shared_target(res, sustain)
    if sustain == 2:
        assert tx.comm_to_target(hist, 0.5, sustain=2)["rounds"] == 5


def test_fairness_stats_match_reference():
    rng = np.random.RandomState(0)
    for n in (1, 7, 30):
        a = rng.rand(n).tolist()
        assert tx.fairness_stats(a) == jx.fairness_stats(a)


def test_plan_json_and_defaults_match_reference():
    kw = dict(rounds=4, eval_every=2, num_clients=24, pipeline="client_plane",
              name="x")
    t, j = tx.default_plan("femnist", **kw), jx.default_plan("femnist", **kw)
    assert t.to_json() == j.to_json()
    tc = tx.default_plan("femnist", compression=CompressionConfig("int8"),
                         block_dtype="bfloat16", opt_state_dtype="bfloat16")
    jc = jx.default_plan("femnist", compression=JaxCompression("int8"),
                         block_dtype="bfloat16", opt_state_dtype="bfloat16")
    assert tc.to_json() == jc.to_json()
    assert [f.name for f in dataclasses.fields(tx.ExperimentPlan)] == \
        [f.name for f in dataclasses.fields(jx.ExperimentPlan)]
    # plans must not alias the registry
    t.method_overrides["fomaml"]["inner_lr"] = 9.0
    assert tx.default_plan("femnist").method_overrides == \
        {"fomaml": {"inner_lr": 0.05}}
    for name in tx.PENDING_DATASETS:
        with pytest.raises(NotImplementedError, match="scenario slice"):
            tx.default_plan(name)


def test_method_overrides_and_trainer_knobs():
    plan = tx.ExperimentPlan(
        dataset="femnist", inner_lr=0.1, local_steps=2, pipeline="packed",
        opt_state_dtype="bfloat16", block_dtype="bfloat16",
        compression=CompressionConfig("int8"),
        method_overrides={"fomaml": {"inner_lr": 0.05},
                          "fedavg": {"local_steps": 7}})
    lf, ef = (lambda p, b: 0), (lambda p, b: (0, {}))
    fo = tx.make_trainer(plan, "fomaml", lf, ef, [], device="cpu")
    assert fo.algo.inner_lr == 0.05 and fo.packed and not fo.client_plane
    assert fo.optimizer.hyper["state_dtype"] == __import__("torch").bfloat16
    assert fo.compression == CompressionConfig("int8")
    assert tx.make_trainer(plan, "maml", lf, ef, [],
                           device="cpu").algo.inner_lr == 0.1
    fa = tx.make_trainer(plan, "fedavg", lf, ef, [], device="cpu")
    assert fa.local_steps == 7 and fa.name == "fedavg"
    assert tx.make_trainer(plan, "fedavg(meta)", lf, ef, [],
                           device="cpu").name == "fedavg(meta)"
    tree = dataclasses.replace(plan, pipeline="tree")
    with pytest.raises(ValueError, match="packed"):
        tx.make_trainer(tree, "fomaml", lf, ef, [], device="cpu")
    for knob in (dict(fuse_rounds=2), dict(prefetch_depth=2),
                 dict(over_select=0.5)):
        bad = dataclasses.replace(plan, compression=None, block_dtype=None,
                                  **knob)
        with pytest.raises(NotImplementedError, match="slice"):
            tx.make_trainer(bad, "fomaml", lf, ef, [], device="cpu")
    # the failure plane's knobs reach the trainer (packed pipelines only)
    robust = dataclasses.replace(plan, compression=None, block_dtype=None,
                                 aggregator="trimmed", trim=1,
                                 screen_factor=2.5,
                                 faults=FaultConfig(byzantine=0.25))
    fo = tx.make_trainer(robust, "fomaml", lf, ef, [], device="cpu")
    assert (fo.aggregator, fo.trim, fo.screen_factor) == ("trimmed", 1, 2.5)
    assert fo.faults == FaultConfig(byzantine=0.25) and fo.guard is True
    with pytest.raises(ValueError, match="packed"):
        tx.make_trainer(dataclasses.replace(robust, pipeline="tree"),
                        "fomaml", lf, ef, [], device="cpu")
    with pytest.raises(NotImplementedError, match="population slice"):
        tx.run_comparison(tx.default_plan("femnist", lazy_population=True),
                          device="cpu")


# ---- a reduced comparison, both packages --------------------------------------

PLANS = {
    "methods": dict(rounds=4, eval_every=2, num_clients=24,
                    pipeline="client_plane"),
    "int8+ef": dict(rounds=4, eval_every=2, num_clients=24,
                    pipeline="client_plane", methods=("fomaml",),
                    name="compression_int8+ef", target_acc=0.12),
}


def _reference_init(plan):
    """The reference's initial parameters for every method of ``plan``,
    as `jx.run_comparison` draws them (key PRNGKey(seed))."""
    model = jx._femnist_model()
    key = jax.random.PRNGKey(plan.seed)
    out = {}
    for m in plan.methods:
        if m in jx.FEDAVG_METHODS:
            tree = model.init(key)
        else:
            over = plan.method_overrides.get(m, {})
            algo = jax_make_algorithm(m, None, None,
                                      over.get("inner_lr", plan.inner_lr))
            tree = algo.init_state(key, model.init)
        out[m] = jax.tree.map(np.asarray, tree)
    return out


@pytest.fixture(scope="module", params=list(PLANS))
def compared(request):
    kw = dict(PLANS[request.param])
    tkw, jkw = dict(kw), dict(kw)
    if request.param == "int8+ef":
        tkw["compression"] = CompressionConfig("int8")
        jkw["compression"] = JaxCompression("int8")
    jplan = jx.default_plan("femnist", **jkw)
    tplan = tx.default_plan("femnist", **tkw)
    jout = jx.run_comparison(jplan, save=False)
    n = jplan.support_size
    ft = np.asarray(jax.random.randint(jax.random.PRNGKey(jplan.seed),
                                       (jplan.local_steps, n), 0, n))
    tout = tx.run_comparison(tplan, device="cpu",
                             init_params=_reference_init(jplan),
                             finetune_idx=ft)
    return jout, tout


def _hold(got, want, key, first=False):
    if first:
        np.testing.assert_allclose(got, want, **NET)
    elif "acc" in key:
        assert abs(got - want) <= ACC_AFTER_ADAM, key
    else:
        np.testing.assert_allclose(got, want, **LOSS_AFTER_ADAM)


def test_comparison_records_match_reference(compared):
    jout, tout = compared
    assert tout["plan"] == jout["plan"]
    assert sorted(tout) == sorted(list(jout) + ["states"])
    assert list(tout["methods"]) == list(jout["methods"])
    for m, jrec in jout["methods"].items():
        trec = tout["methods"][m]
        assert sorted(trec) == sorted(jrec)
        for k in BYTES + ("codec",):
            assert trec["comm"].get(k) == jrec["comm"].get(k), (m, k)
        assert len(trec["history"]) == len(jrec["history"])
        for r, (a, b) in enumerate(zip(trec["history"], jrec["history"])):
            assert sorted(a) == sorted(b)
            for k in BYTES + ("round", "codec"):
                assert a.get(k) == b.get(k), (m, r, k)
            for k in b:
                if k in BYTES or k in ("round", "codec", "client_GFLOPs"):
                    continue
                _hold(a[k], b[k], k, first=(r == 0 and "eval" not in k))
        _hold(trec["test_acc"], jrec["test_acc"], "accuracy")
        _hold(trec["test_loss"], jrec["test_loss"], "loss")
        assert trec["fairness"]["num_clients"] == \
            jrec["fairness"]["num_clients"]
        assert trec["comm"]["client_GFLOPs"] > 0


def test_comm_to_target_tables_match_reference(compared):
    """The same shared target rule and the same byte fields whenever
    both packages cross at the same round."""
    jout, tout = compared
    assert list(tout["comm_to_target"]) == list(jout["comm_to_target"])
    if jout["target_acc"] is not None and tout["target_acc"] is not None:
        assert abs(tout["target_acc"] - jout["target_acc"]) <= \
            ACC_AFTER_ADAM
    for m, jrow in jout["comm_to_target"].items():
        trow = tout["comm_to_target"][m]
        if trow and jrow and trow["rounds"] == jrow["rounds"]:
            for k in ("comm_MB", "upload_MB", "download_MB"):
                assert trow[k] == jrow[k]


def test_format_table_lists_every_method(compared):
    _, tout = compared
    text = tx.format_table(tout)
    assert text.splitlines()[0].startswith("target accuracy:")
    for m in tout["methods"]:
        assert any(line.startswith(m) for line in text.splitlines()[2:])


# bytes of one FEMNIST round at m = 4 by upload codec (download φ in f32
# both ways, upload by codec): the committed compression sweep's
ROUND_BYTES = {"f32": 14_772_160, "bf16": 11_079_120, "int8+ef": 9_232_616,
               "topk0.05+ef": 7_940_048}


def test_compression_sweep_bytes_and_writes_no_file(tmp_path, monkeypatch):
    """One round of each codec through `sweep_compression` and its
    ``around`` hook: bytes per round exactly the committed ones, and no
    file written anywhere (the committed artifacts stay untouched)."""
    from repro_torch.launch import compare
    monkeypatch.chdir(tmp_path)
    seen = []

    def around(label, run):
        seen.append(label)
        out = run()
        assert "fomaml" in out["states"]
        return out

    out = compare.sweep_compression(rounds=1, eval_every=0, seed=0,
                                    device="cpu", log=None, around=around)
    assert seen == list(compare.VARIANTS)
    for label, v in out["variants"].items():
        assert round(v["comm"]["comm_MB"] * 1e6) == ROUND_BYTES[label]
        assert v["comm"].get("codec") == (label if "+ef" in label else None)
    assert list(tmp_path.iterdir()) == []


def write_reference_init(path, methods=jx.DEFAULT_METHODS, seed=0):
    """Write the JAX reference's initial parameters of the FEMNIST plan
    (and its FedAvg(Meta) fine-tune draw) to ``path`` in the layout
    `repro_torch.launch.compare.load_init` reads."""
    plan = jx.default_plan("femnist", methods=tuple(methods), seed=seed)
    flat = {}
    for m, tree in _reference_init(plan).items():
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["|".join([m] + [k.key for k in keys])] = np.asarray(leaf)
    n = plan.support_size
    flat["finetune_idx"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), (plan.local_steps, n), 0, n))
    np.savez(path, **flat)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="write the JAX reference's initial FEMNIST parameters")
    ap.add_argument("--write-init", required=True, metavar="NPZ")
    ap.add_argument("--legacy-threefry", action="store_true",
                    help="draw with jax_threefry_partitionable=False, the "
                         "default of the JAX that made the committed "
                         "results/experiments/*.json (jax 0.9 draws "
                         "other numbers from the same key)")
    args = ap.parse_args()
    if args.legacy_threefry:
        jax.config.update("jax_threefry_partitionable", False)
    write_reference_init(args.write_init)
