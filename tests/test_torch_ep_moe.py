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
`moe_apply` (the same routing, dispatch, experts and combine).

Training through the layer (the same world of 2): each rank routes its
own tokens x_r against its own cotangent, so the two ranks' loss is
Σ_r (moe_apply(x_r) · cot_r).sum(). Each rank's input gradient, router
gradient and shared-expert gradient are held against `moe_apply`'s on
its own tokens, and each rank's expert-shard gradient against its
slice of the sum of `moe_apply`'s expert gradients over both ranks'
tokens (an expert sees both ranks' buckets). Bound: f32 allclose at
rtol 1e-5, with an atol of 1e-6 of the largest entry of the leaf (the
expert's gradient sums both buckets in one matmul, moe_apply's in two:
entries that cancel keep only that rounding)."""
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


EXPERT_KEYS = ("w_gate", "w_up", "w_down")
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-6


def _rank_data(arch, rank):
    """Rank ``rank``'s own tokens (2, 8, d) and cotangent."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.RandomState(10 + rank)
    x = rng.normal(0, 0.5, (2, 8, jcfg.d_model)).astype(np.float32)
    return x, rng.normal(0, 1, x.shape).astype(np.float32)


def _grads(fn, params, x, cot):
    """(y, dx, dparams) of (fn(params, x) · cot).sum(), as numpy."""
    from repro_torch.utils.pytree import tree_map
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    xt = torch.from_numpy(x).requires_grad_()
    y = fn(p, xt)
    (y * torch.from_numpy(cot)).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            tree_map(lambda t: t.grad.numpy(), p))


def _ep_grads(mesh, rank, arch, cf):
    """This rank's EP layer trained through: the router and the shared
    experts whole, its E/2 experts, its own tokens."""
    _, cfg = _cfgs(arch)
    params, _ = _inputs(arch)
    E_loc = cfg.num_experts // 2
    p = {k: (v[rank * E_loc:(rank + 1) * E_loc] if k in EXPERT_KEYS
             else v) for k, v in from_numpy_tree(params, "cpu").items()}
    return _grads(lambda p_, x_: ep_moe_apply(p_, cfg, x_, mesh,
                                              capacity_factor=cf),
                  p, *_rank_data(arch, rank))


def world2_worker(rank):
    """This rank's EP layer for every case (its 2 of 4 experts), its
    gradients through the layer on its own tokens, and an LM forward of
    reduced mixtral with moe_impl="ep" on DTensor parameters over the
    1x2 mesh."""
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
        out[("grad", arch, cf)] = _ep_grads(mesh, rank, arch, cf)
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


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("arch,cf", CASES)
def test_ep_world2_gradients_match_moe_apply(world2, arch, cf):
    """EP training's gradient: each rank's input, router and shared
    gradients are `moe_apply`'s on its tokens; its expert shard's is
    its slice of `moe_apply`'s expert gradient summed over both ranks'
    tokens."""
    _, cfg = _cfgs(arch)
    params, _ = _inputs(arch)
    full = from_numpy_tree(params, "cpu")
    want = [_grads(lambda p_, x_: moe.moe_apply(p_, cfg, x_,
                                                capacity_factor=cf)[0],
                   full, *_rank_data(arch, r)) for r in range(2)]
    E_loc = cfg.num_experts // 2
    for r, rec in enumerate(world2):
        (y, dx, dp), (wy, wdx, wdp) = rec[("grad", arch, cf)], want[r]
        np.testing.assert_allclose(y, wy, **TOL)
        _close(dx, wdx, f"rank {r} dx")
        _close(dp["w_router"], wdp["w_router"], f"rank {r} router")
        experts = [k for k in EXPERT_KEYS if k in dp]
        assert experts
        for k in experts:
            summed = want[0][2][k] + want[1][2][k]
            _close(dp[k], summed[r * E_loc:(r + 1) * E_loc], f"rank {r} {k}")
        shared = jax.tree.leaves(dp.get("shared", {}))
        assert len(shared) == (3 if cfg.num_shared_experts else 0)
        for a, b in zip(shared, jax.tree.leaves(wdp.get("shared", {}))):
            _close(a, b, f"rank {r} shared")
    if cf is not None:      # every expert overflows: the drops train too
        x0 = torch.from_numpy(_rank_data(arch, 0)[0])
        r0 = moe.moe_route(full, cfg, x0.reshape(-1, cfg.d_model), cf)
        assert moe.dropped_entries(r0) > 0
