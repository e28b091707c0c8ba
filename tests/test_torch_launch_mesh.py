"""The launch paths on a device mesh, on the CPU: the port's
counterpart of the reference's
`test_launch_path_lowers_on_host_mesh[train|prefill|decode]`. Reduced
qwen2.5-3b (float32, q/k/v biases) with the state, parameters, cache
and batch placed as DTensors by the ported specs, on a gloo 1x1 mesh
(in process), and 2x1 (batch over data) and 1x2 (heads and widths over
model) meshes (one spawned world of 2 for the module). The train step's
loss and state, the prefill's logits and cache and the decode step's
logits and cache are held against the meshless port step and the
reference's step on the same inputs, from the reference's φ.

Tolerance (f32): metrics at rtol 1e-5; logits and caches at rtol 1e-4
/ atol 1e-5 (the LM tests' tolerance: matmuls summed in other orders,
here also across ranks); after Adam's first step the first moment at
that tolerance and φ there too where |m| > 1e-6·max|m|, and within
2·lr everywhere. ``shard_seq`` (the sequence over "model" at block
boundaries) changes no number beyond that tolerance. The
``scan_clients`` / ``unroll_layers`` settings give bitwise-equal steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro_torch.configs import INPUT_SHAPES, get_config, reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.launch.steps import (input_specs, make_decode_step,
                                      make_prefill_step, make_train_step)

import torchdist

ARCH = "qwen2.5-3b"
NET = dict(rtol=1e-4, atol=1e-5)
LR = 1e-4
MESHES = [(2, 1), (1, 2)]
TRAIN = dict(seq_len=32, global_batch=8, clients_per_round=2,
             seqs_per_client=4)


def _shape(kind):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    extra = TRAIN if kind == "train" else dict(seq_len=32, global_batch=4)
    return (dataclasses.replace(INPUT_SHAPES[name], **extra),
            dataclasses.replace(J_SHAPES[name], **extra))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def inputs():
    """The reference's φ, one train batch (support, query: (1, 2, 2, 32)
    tokens), prefill tokens (4, 32) and the decode token."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    _, jinit, _, _ = jax_make_train_step(jcfg, outer_lr=LR)
    phi = _np(jinit(jax.random.PRNGKey(0))["phi"])
    rng = np.random.RandomState(0)
    tok = lambda *s: rng.randint(0, jcfg.vocab_size, s).astype(np.int32)
    return {"phi": phi, "sup": tok(1, 2, 2, 32), "qry": tok(1, 2, 2, 32),
            "prompt": tok(4, 32), "next": tok(4, 1)}


def run_port(x, mesh=None, shard_seq=False, **step_kw):
    """One train step, a prefill and a decode step of the port (on
    ``mesh`` as DTensors when given) -> numpy results."""
    from repro_torch.launch.train import full, place_state
    from repro_torch.sharding.context import stepping_on
    from repro_torch.sharding.rules import (cache_pspecs, distribute,
                                            param_pspecs)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              shard_seq=shard_seq)
    step, init, _, _ = make_train_step(cfg, outer_lr=LR, **step_kw)
    state = init(phi=from_numpy_tree(x["phi"], "cpu"), device="cpu")
    batch = {"support": {"tokens": torch.from_numpy(x["sup"])},
             "query": {"tokens": torch.from_numpy(x["qry"])}}
    params = from_numpy_tree(x["phi"]["theta"], "cpu")
    prompt = {"tokens": torch.from_numpy(x["prompt"])}
    nxt = torch.from_numpy(x["next"])
    pshape, _ = _shape("prefill")
    if mesh is not None:
        state = place_state(state, mesh)
        tshape, _ = _shape("train")
        batch = distribute(batch, input_specs(cfg, tshape, mesh)["pspec"],
                           mesh)
        params = distribute(params, param_pspecs(params, mesh), mesh)
        prompt = distribute(prompt, input_specs(cfg, pshape, mesh)["pspec"],
                            mesh)
    with stepping_on(mesh):
        state, met = step(state, batch)
        with torch.no_grad():
            logits, cache = make_prefill_step(cfg)(params, prompt)
            out = {"state": to_numpy_tree(full(state)),
                   "metrics": {k: float(full(v)) for k, v in met.items()},
                   "prefill": to_numpy_tree(full(logits)),
                   # a copy: the decode step writes the cache in place
                   "cache": jax.tree.map(np.copy, to_numpy_tree(full(
                       {k: v for k, v in cache.items() if k != "length"})))}
            if mesh is not None:
                cache = distribute(cache, cache_pspecs(cache, mesh), mesh)
                nxt = distribute({"t": nxt}, {"t": input_specs(
                    cfg, _shape("decode")[0], mesh)["pspec"]["tokens"]},
                    mesh)["t"]
            dl, dc = make_decode_step(cfg)(params, cache, nxt)
            out["decode"] = to_numpy_tree(full(dl))
            out["decode_cache"] = to_numpy_tree(full(
                {k: v for k, v in dc.items() if k != "length"}))
    return out


@pytest.fixture(scope="module")
def x():
    return inputs()


@pytest.fixture(scope="module")
def reference(x):
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    step, jinit, _, _ = jax_make_train_step(jcfg, outer_lr=LR)
    state = {"phi": jax.tree.map(jnp.asarray, x["phi"]),
             "opt": jinit(jax.random.PRNGKey(0))["opt"]}
    state, met = jax.jit(step)(state, {
        "support": {"tokens": jnp.asarray(x["sup"])},
        "query": {"tokens": jnp.asarray(x["qry"])}})
    params = jax.tree.map(jnp.asarray, x["phi"]["theta"])
    logits, cache = jax.jit(jax_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(x["prompt"])})
    pre = {"prefill": np.asarray(logits),
           "cache": _np({k: v for k, v in cache.items() if k != "length"})}
    dl, dc = jax.jit(jax_decode_step(jcfg))(params, cache,
                                            jnp.asarray(x["next"]))
    return {"state": _np(state), "metrics": {k: float(v) for k, v in
                                             met.items()},
            **pre, "decode": np.asarray(dl),
            "decode_cache": _np({k: v for k, v in dc.items()
                                 if k != "length"})}


@pytest.fixture(scope="module")
def meshless(x):
    return run_port(x)


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(a, np.float32))
                           for a in jax.tree.leaves(tree)])


def _hold(got, want):
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    tm, wm = _flat(got["state"]["opt"]["m"]), _flat(want["state"]["opt"]["m"])
    np.testing.assert_allclose(tm, wm, **NET)
    tp, wp = _flat(got["state"]["phi"]), _flat(want["state"]["phi"])
    live = np.abs(wm) > 1e-6 * np.abs(wm).max()
    np.testing.assert_allclose(tp[live], wp[live], **NET)
    assert np.all(np.abs(tp - wp) <= 2 * LR * (1 + 1e-5))
    for k in ("prefill", "cache", "decode", "decode_cache"):
        for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            np.testing.assert_allclose(a, b, **NET, err_msg=k)


def test_meshless_matches_reference(meshless, reference):
    _hold(meshless, reference)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_launch_path_on_host_mesh_1x1(tmp_path, x, meshless, reference,
                                      kind):
    """The 1x1 host mesh in a gloo world of one (the card's launchers)."""
    from repro_torch.launch.mesh import make_host_mesh
    with torchdist.world(tmp_path):
        got = run_port(x, make_host_mesh(1, 1, device_type="cpu"))
    keys = {"train": ("state", "metrics"), "prefill": ("prefill", "cache"),
            "decode": ("decode", "decode_cache")}[kind]
    for want in (meshless, reference):
        sub = lambda r: {k: r[k] for k in keys}   # noqa: E731
        if kind == "train":
            _hold({**got, "prefill": [], "cache": [], "decode": [],
                   "decode_cache": []}, {**want, "prefill": [], "cache": [],
                                         "decode": [], "decode_cache": []})
        else:
            for k in keys:
                for a, b in zip(jax.tree.leaves(sub(got)[k]),
                                jax.tree.leaves(sub(want)[k])):
                    np.testing.assert_allclose(a, b, **NET, err_msg=k)


def _cut(seqs):
    """The reduced train shape at one client of ``seqs`` sequences."""
    from repro_torch.launch import train as tl
    return tl.cut_shape(tl.reduced_shape(INPUT_SHAPES["train_4k"]),
                        seqs_per_client=seqs, clients=1)


def refusals(mesh):
    """On the 2x1 mesh: `distribute` of the launcher's batch at 1 + 1
    sequences (a sequence axis of one over "data") and `train` at 1 + 1
    raise ValueError, the latter before it draws anything; at 2 + 2
    the launcher's step runs. Returns the messages, the draws made
    before the refusal and (mesh, meshless) losses at 2 + 2."""
    from repro_torch.launch import train as tl
    from repro_torch.sharding.rules import distribute
    cfg = reduced_config(get_config(ARCH))
    one, two = _cut(2), _cut(4)
    out = {}
    batch = tl.task_batch(cfg, one, 0, "cpu")
    try:
        distribute(batch, input_specs(cfg, one, mesh)["pspec"], mesh)
        out["distribute"] = None
    except ValueError as e:
        out["distribute"] = str(e)
    drawn, real = [], tl.make_train_step

    def spy(*a, **k):
        step, init, algo, opt = real(*a, **k)
        return step, lambda *a, **k: drawn.append(1) or init(*a, **k), \
            algo, opt

    tl.make_train_step = spy
    try:
        tl.train(cfg, one, steps=1, device="cpu", mesh=mesh,
                 log_every=10 ** 9)
        out["train"] = None
    except ValueError as e:
        out["train"] = str(e)
    finally:
        tl.make_train_step = real
    out["drawn"] = len(drawn)
    _, rec = tl.train(cfg, two, steps=1, device="cpu", mesh=mesh,
                      log_every=10 ** 9)
    _, ref = tl.train(cfg, two, steps=1, device="cpu", log_every=10 ** 9)
    out["loss"] = (rec[0]["query_loss"], ref[0]["query_loss"])
    return out


def world2_worker(rank, x):
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    for shape in MESHES:
        mesh = make_host_mesh(*shape, device_type="cpu")
        out[shape] = run_port(x, mesh)
        out[(shape, "shard_seq")] = run_port(x, mesh, shard_seq=True)
    out["refusals"] = refusals(make_host_mesh(2, 1, device_type="cpu"))
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory, x):
    return torchdist.spawn_world(tmp_path_factory.mktemp("launch2"), 2,
                                 world2_worker, x, timeout=600)


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "1x2"])
def test_launch_path_on_two_rank_meshes(world2, meshless, reference, mesh,
                                        shard_seq):
    """Both ranks agree, and each holds the meshless step's and the
    reference's numbers: train, prefill and decode."""
    key = (mesh, "shard_seq") if shard_seq else mesh
    r0, r1 = (r[key] for r in world2)
    for a, b in zip(jax.tree.leaves(r0), jax.tree.leaves(r1)):
        np.testing.assert_array_equal(a, b)
    _hold(r0, meshless)
    _hold(r0, reference)


def test_scan_and_unroll_settings_are_bitwise_equal(x):
    """Eager PyTorch runs the same loops either way."""
    a = run_port(x)
    b = run_port(x, scan_clients=False, unroll_layers=True)
    for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(p, q)


def test_two_by_one_mesh_refuses_a_batch_of_one_sequence(world2):
    """A spec that cuts a dim unevenly raises, as the reference's
    `device_put` and `jit` do (`test_reference_refuses_the_same_spec`):
    `distribute` at 1 + 1 on 2x1 names the leaf, the dim, its size and
    the divisor; `train` raises before it draws the state; 2 + 2 runs,
    its loss within rtol 1e-5 of the meshless step's."""
    for r in world2:
        got = r["refusals"]
        assert got["distribute"] and "['support']['tokens']" in \
            got["distribute"], got
        assert "dim 2, whose size 1 does not divide by 2" in \
            got["distribute"], got
        assert got["train"] and "does not divide by 2" in got["train"], got
        assert got["drawn"] == 0, got
        np.testing.assert_allclose(got["loss"][0], got["loss"][1],
                                   rtol=1e-5)


JAX_PLACEMENT = r"""
import dataclasses, json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import INPUT_SHAPES, get_config, reduced_config
from repro.launch.steps import input_specs
seqs = int(sys.argv[1])
cfg = reduced_config(get_config(sys.argv[2]))
shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64,
                            global_batch=seqs, clients_per_round=1,
                            seqs_per_client=seqs)
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
spec = input_specs(cfg, shape, mesh)
leaves = jax.tree.leaves(spec["batch"])
specs = jax.tree.leaves(spec["pspec"], is_leaf=lambda s: isinstance(s, P))
out = {"devices": len(jax.devices())}
for name, place in (
        ("device_put", lambda x, s: jax.device_put(x, s)),
        ("jit", lambda x, s: jax.jit(lambda a: a + 1, in_shardings=s)(x))):
    try:
        for x, s in zip(leaves, specs):
            jax.block_until_ready(place(np.zeros(x.shape, x.dtype),
                                        NamedSharding(mesh, s)))
        out[name] = None
    except ValueError as e:
        out[name] = str(e)
print(json.dumps(out))
"""


@pytest.mark.parametrize("seqs", [2, 4], ids=["1+1", "2+2"])
def test_reference_refuses_the_same_spec(seqs):
    """The reference's train batch spec on a 2x1 mesh of two host
    devices: 1 + 1 refused by `device_put` and by `jit`'s
    ``in_shardings``, 2 + 2 placed; the port's `check_placeable` gives
    the same answer on the same spec."""
    import json
    import os
    import subprocess
    import sys
    import types
    from repro_torch.sharding.rules import check_placeable
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(root, "src"))
    run = subprocess.run([sys.executable, "-c", JAX_PLACEMENT, str(seqs),
                          ARCH], capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["devices"] == 2
    refused = seqs == 2
    for name in ("device_put", "jit"):
        assert bool(got[name]) == refused, got
        if refused:
            assert "should be divisible by 2" in got[name], got
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=types.SimpleNamespace(shape=(2, 1)))
    spec = input_specs(reduced_config(get_config(ARCH)), _cut(seqs), mesh)
    if refused:
        with pytest.raises(ValueError, match="does not divide by 2"):
            check_placeable(spec["batch"], spec["pspec"], mesh)
    else:
        check_placeable(spec["batch"], spec["pspec"], mesh)
