"""The port's sharding rules, `input_specs` and meshes against the JAX
package: `param_pspecs` (train and serve_tp), `state_pspecs`,
`batch_pspec`, `cache_pspecs` (seq_shard off and on) and `input_specs`
leaf for leaf, for all ten configs on the production meshes (16x16 and
2x16x16) and every input shape. Both packages get the same stand-in
mesh (``axis_names`` and ``devices.shape``, all their functions read),
so no device is needed; the port's parameters, state and caches are
meta tensors. Specs compare entry by entry (the port's `P` is a tuple of
axis names, tuples of names or None)."""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.steps import input_specs as jax_input_specs
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.sharding import rules as jr
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import input_specs, make_train_step
from repro_torch.sharding import rules as tr

import torchdist

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def stub_mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))


def _ref_specs(tree):
    """path -> spec tuple of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(tree, prefix=""):
    if isinstance(tree, tr.P):
        return {prefix: tuple(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_port_specs(v, f"{prefix}[{k!r}]"))
    return out


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in flat}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[1])}
    return {prefix: ((), "int32")}        # a cache's length


@pytest.fixture(scope="module")
def shapes_of():
    """arch -> (port params, reference params, port state, reference
    state), shapes only."""
    cache = {}

    def get(arch):
        if arch not in cache:
            _, jinit, _, _ = jax_make_train_step(jax_get_config(arch))
            js = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0)))
            jp = js["phi"]["theta"]
            cfg = get_config(arch)
            _, init_state, _, _ = make_train_step(cfg)
            ts = init_state(0, device="meta")
            cache[arch] = (ts["phi"]["theta"], jp, ts, js)
        return cache[arch]

    return get


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(shapes_of, arch, shape, mesh_name):
    mesh = stub_mesh(mesh_name)
    tp, jp, ts, js = shapes_of(arch)
    kind = INPUT_SHAPES[shape].kind
    if kind == "train":
        for mode in ("train", "serve_tp"):
            assert _port_specs(tr.param_pspecs(tp, mesh, mode=mode)) == \
                _ref_specs(jr.param_pspecs(jp, mesh, mode=mode))
        pspec = tr.param_pspecs(tp, mesh)
        assert _port_specs(tr.state_pspecs(ts, pspec, mesh)) == _ref_specs(
            jr.state_pspecs(js, jr.param_pspecs(jp, mesh), mesh))
    for nd in (2, 3):
        assert tuple(tr.batch_pspec(mesh, nd)) == tuple(
            jr.batch_pspec(mesh, nd))
    got = input_specs(get_config(arch), INPUT_SHAPES[shape], mesh)
    want = jax_input_specs(jax_get_config(arch), J_SHAPES[shape], mesh)
    assert _port_specs(got["pspec"]) == _ref_specs(want["pspec"])
    assert _port_leaves(got["batch"]) == _ref_leaves(want["batch"])
    if kind == "decode":
        assert got["serving_cfg"].sliding_window == \
            want["serving_cfg"].sliding_window
        for seq in (False, True):
            assert _port_specs(tr.cache_pspecs(
                got["batch"]["cache"], mesh, seq_shard=seq)) == _ref_specs(
                jr.cache_pspecs(want["batch"]["cache"], mesh,
                                seq_shard=seq))


def test_divisibility_guard_and_placements():
    """A dim that does not divide its axes stays whole (SmolLM's 15
    heads of 64 = 960 columns divide 16; a 7-row table does not), and a
    spec turns into one placement a mesh dim, a tuple entry sharding one
    tensor dim over both mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = stub_mesh("2x16x16")
    p = {"wq": torch.empty((960, 960), device="meta"),
         "embed": torch.empty((7, 960), device="meta"),
         "norm": torch.empty((960,), device="meta")}
    specs = tr.param_pspecs(p, mesh)
    assert tuple(specs["wq"]) == (("pod", "data"), "model")
    assert tuple(specs["embed"]) == (None, ("pod", "data"))
    assert tuple(specs["norm"]) == (None,)
    assert tr.placements(specs["wq"], mesh) == (Shard(0), Shard(0), Shard(1))
    assert tr.placements(tr.P(None, "model"), stub_mesh("16x16")) == (
        Replicate(), Shard(1))
    with pytest.raises(ValueError, match="two dims"):
        tr.placements(tr.P("data", "data"), mesh)
    with pytest.raises(ValueError, match="no axis"):
        tr.placements(tr.P("pod"), stub_mesh("16x16"))
    with pytest.raises(ValueError, match="mode"):
        tr.param_pspecs(p, mesh, mode="serve")


def test_meshes_need_their_world(tmp_path):
    """A gloo world of one: the 1x1 host mesh and the launchers' choice
    of it; a mesh of another size raises naming both numbers, the
    production meshes naming 256 and 512; the rules read a DeviceMesh as
    they read the stand-in."""
    with torchdist.world(tmp_path):
        m = tmesh.make_host_mesh(1, 1, device_type="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tr.mesh_sizes(m) == {"data": 1, "model": 1}
        assert tmesh.launcher_mesh(device_type="cpu").mesh_dim_names == (
            "data", "model")
        with pytest.raises(ValueError, match="needs a world of 2 ranks; "
                           "this world has 1"):
            tmesh.make_host_mesh(2, 1, device_type="cpu")
        with pytest.raises(ValueError, match="256 ranks"):
            tmesh.make_production_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="512 ranks"):
            tmesh.launcher_mesh(multi_pod=True, device_type="cpu")
        p = {"wq": torch.empty((960, 960), device="meta")}
        one = types.SimpleNamespace(
            axis_names=("data", "model"),
            devices=types.SimpleNamespace(shape=(1, 1)))
        assert tr.param_pspecs(p, m) == tr.param_pspecs(p, one)
