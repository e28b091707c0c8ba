"""Expert-parallel MoE (`sharding/ep_moe.py`) against the JAX package's
`ep_moe_apply` on its one-device mesh and against the port's own
tensor-parallel `moe_apply`: reduced mixtral-8x22b without shared
experts (as `tests/test_configs_and_sharding.py` runs it) and reduced
deepseek-v2-236b with its shared expert, at the config's capacity factor
and at 0.25 (every expert overflows: the rank-0 clobber). At a gloo
world of 2 (a 1x2 model mesh, 2 experts a rank; one spawned world for
the module) the layer, and an LM forward with ``moe_impl="ep"`` on
DTensor parameters, against a world of one.

Tolerance: rtol = atol = 2e-4 in f32 against the reference (the
reference test's); the port's world-one layer is bitwise its
`moe_apply` (the same routing, dispatch, experts and combine)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import moe as jax_moe
from repro.models.layers import Rng as JaxRng
from repro.sharding.ep_moe import ep_moe_apply as jax_ep_moe_apply
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import moe
from repro_torch.sharding.ep_moe import ep_moe_apply

import torchdist

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = [(a, cf) for a in ("mixtral-8x22b", "deepseek-v2-236b")
         for cf in (None, 0.25)]


def _cfgs(arch):
    shared = {} if arch == "deepseek-v2-236b" else {"num_shared_experts": 0}
    return (dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                **shared),
            dataclasses.replace(reduced_config(get_config(arch)), **shared))


def _inputs(arch):
    jcfg, _ = _cfgs(arch)
    params = jax.tree.map(np.asarray, jax_moe.moe_init(
        JaxRng(jax.random.PRNGKey(0)), jcfg, jnp.float32))
    x = np.random.RandomState(0).normal(0, 0.5, (2, 8, jcfg.d_model)
                                        ).astype(np.float32)
    return params, x


def _mesh(model, data=1):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data, model, device_type="cpu")


@pytest.mark.parametrize("arch,cf", CASES)
def test_ep_world1_matches_reference(tmp_path, arch, cf):
    jcfg, cfg = _cfgs(arch)
    params, x = _inputs(arch)
    want = np.asarray(jax_ep_moe_apply(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(x),
        jax_host_mesh(1, 1), capacity_factor=cf))
    tp = from_numpy_tree(params, "cpu")
    with torchdist.world(tmp_path):
        got = ep_moe_apply(tp, cfg, torch.from_numpy(x), _mesh(1),
                           capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    y_tp, _ = moe.moe_apply(tp, cfg, torch.from_numpy(x), capacity_factor=cf)
    assert torch.equal(got, y_tp)
    if cf is not None:
        r = moe.moe_route(tp, cfg, torch.from_numpy(x).reshape(-1, cfg.d_model),
                          cf)
        assert moe.dropped_entries(r) > 0 and bool(
            (r["counts"] > r["capacity"]).all())


def test_experts_must_split_over_the_model_axis():
    _, cfg = _cfgs("mixtral-8x22b")
    params, x = _inputs("mixtral-8x22b")
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=types.SimpleNamespace(shape=(1, 3)))
    with pytest.raises(ValueError, match="do not split"):
        ep_moe_apply(from_numpy_tree(params, "cpu"), cfg,
                     torch.from_numpy(x), mesh)


def world2_worker(rank):
    """This rank's EP layer for every case (its 2 of 4 experts) and an
    LM forward of reduced mixtral with moe_impl="ep" on DTensor
    parameters over the 1x2 mesh."""
    from repro_torch.models import init_lm, lm_apply
    from repro_torch.sharding.context import stepping_on
    from repro_torch.sharding.rules import distribute, param_pspecs
    mesh = _mesh(2)
    out = {}
    for arch, cf in CASES:
        _, cfg = _cfgs(arch)
        params, x = _inputs(arch)
        with torch.no_grad():
            out[(arch, cf)] = ep_moe_apply(
                from_numpy_tree(params, "cpu"), cfg, torch.from_numpy(x),
                mesh, capacity_factor=cf).numpy()
    cfg = dataclasses.replace(reduced_config(get_config("mixtral-8x22b")),
                              moe_impl="ep")
    p = init_lm(0, cfg, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    dp = distribute(p, param_pspecs(p, mesh), mesh)
    with torch.no_grad(), stepping_on(mesh):
        logits, _ = lm_apply(dp, cfg, tok, remat=False)
        out["lm"] = logits.full_tensor().numpy()
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torchdist.spawn_world(tmp_path_factory.mktemp("ep2"), 2,
                                 world2_worker, timeout=600)


@pytest.mark.parametrize("arch,cf", CASES)
def test_ep_world2_matches_world1(world2, arch, cf):
    """Both ranks hold the whole batch (data = 1), route it alike and
    exchange buckets: each equals the world-one layer."""
    _, cfg = _cfgs(arch)
    params, x = _inputs(arch)
    want, _ = moe.moe_apply(from_numpy_tree(params, "cpu"), cfg,
                            torch.from_numpy(x), capacity_factor=cf)
    for r in world2:
        np.testing.assert_allclose(r[(arch, cf)], want.numpy(), **TOL)


def test_lm_with_ep_on_a_mesh(world2):
    """`blocks._moe` takes the expert-parallel layer on a mesh: the
    logits equal the meshless tensor-parallel forward's."""
    from repro_torch.models import init_lm, lm_apply
    cfg = reduced_config(get_config("mixtral-8x22b"))
    p = init_lm(0, cfg, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        want, _ = lm_apply(p, cfg, tok, remat=False)
    for r in world2:
        np.testing.assert_allclose(r["lm"], want.numpy(), **TOL)
