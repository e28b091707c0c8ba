"""Shared body of the port's dry-run tests (`test_torch_dryrun*.py`):
the CLI (`python -m repro_torch.launch.dryrun --all`) on reduced configs
and short shapes, substituted into its module, under the "fake" process
group at 256 or 512 ranks; and the argument bytes each record should
hold, worked out from the JAX package's own specs on a stand-in mesh."""
import dataclasses
import json
import math
import types

import jax
import numpy as np
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch import steps as jsteps
from repro.models import init_lm as jax_init_lm
from repro.sharding import rules as jr
from repro_torch.configs import INPUT_SHAPES, get_config, reduced_config
from repro_torch.launch import dryrun

SEQ = 32


def shapes(multi_pod):
    """Every input shape at 32 tokens; train_4k at one client of 32
    sequences a group (16 + 16: the support and query rows split over
    the 16-way data axis), one group a pod."""
    G = 2 if multi_pod else 1
    out = {k: dataclasses.replace(v, seq_len=SEQ)
           for k, v in INPUT_SHAPES.items()}
    out["train_4k"] = dataclasses.replace(
        out["train_4k"], global_batch=32 * G, clients_per_round=G,
        seqs_per_client=32)
    return out


def run_cli(monkeypatch, tmp, multi_pod):
    """The CLI over every arch x shape -> {(arch, shape): record}."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: reduced_config(get_config(a)))
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", shapes(multi_pod))
    argv = ["--all", "--json", str(tmp), "--no-remat"]
    if multi_pod:
        argv.append("--multi-pod")
    recs = dryrun.main(argv)
    tag = "pod2" if multi_pod else "pod1"
    for r in recs:
        with open(tmp / f"{r['arch']}__{r['shape']}__{tag}.json") as f:
            assert json.load(f) == json.loads(json.dumps(r))
    return {(r["arch"], r["shape"]): r for r in recs}


def _stub(multi_pod):
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))


def _bytes(tree, specs, sizes):
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    n = 0
    for x, s in zip(leaves, spec_leaves):
        split = math.prod(sizes[a] for e in s if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
        n += math.prod(x.shape) * np.dtype(x.dtype).itemsize // split
    return n


def reference_argument_bytes(arch, shape_name, multi_pod):
    """Rank 0's argument bytes implied by the reference's specs: the
    train state and batch, the prefill's parameters and batch, the
    decode step's parameters, cache (its length scalar left out: the
    port keeps it a Python int) and tokens."""
    mesh = _stub(multi_pod)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    cfg = jax_reduced_config(jax_get_config(arch))
    shape = dataclasses.replace(J_SHAPES[shape_name],
                                **{k: getattr(shapes(multi_pod)[shape_name],
                                              k) for k in
                                   ("seq_len", "global_batch",
                                    "clients_per_round",
                                    "seqs_per_client")})
    key = jax.random.PRNGKey(0)
    if shape.kind == "train":
        _, init, _, _ = jsteps.make_train_step(cfg)
        state = jax.eval_shape(lambda: init(key))
        sspec = jr.state_pspecs(state, jr.param_pspecs(
            state["phi"]["theta"], mesh), mesh)
        spec = jsteps.input_specs(cfg, shape, mesh)
        return _bytes(state, sspec, sizes) + _bytes(
            spec["batch"], spec["pspec"], sizes)
    if shape.kind == "prefill":
        scfg = jsteps.resolve_serving_config(cfg, shape)
        params = jax.eval_shape(lambda: jax_init_lm(key, scfg))
        spec = jsteps.input_specs(scfg, shape, mesh)
        return _bytes(params, jr.param_pspecs(params, mesh), sizes) + \
            _bytes(spec["batch"], spec["pspec"], sizes)
    spec = jsteps.input_specs(cfg, shape, mesh)
    params = jax.eval_shape(lambda: jax_init_lm(key, spec["serving_cfg"]))
    cache = {k: v for k, v in spec["batch"]["cache"].items()
             if k != "length"}
    cspec = {k: v for k, v in spec["pspec"]["cache"].items()
             if k != "length"}
    return (_bytes(params, jr.param_pspecs(params, mesh), sizes)
            + _bytes(cache, cspec, sizes)
            + _bytes(spec["batch"]["tokens"], spec["pspec"]["tokens"],
                     sizes))


def check(recs, arch, shape, multi_pod):
    rec = recs[(arch, shape)]
    if arch == "seamless-m4t-medium" and shape == "long_500k":
        assert rec["status"] == "skipped" and "DESIGN.md" in rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rec["memory"]["argument_bytes"] == reference_argument_bytes(
        arch, shape, multi_pod)
    assert rec["memory"]["output_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    col = rec["collectives"]
    assert sum(col["counts"].values()) > 0
    assert col["total_bytes"] == sum(col["bytes_by_type"].values()) > 0
    assert set(col["counts"]) <= {"all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all", "broadcast"}
