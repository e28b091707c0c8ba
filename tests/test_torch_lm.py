"""Port parity: the LM stack (config, init shapes, forward, loss and its
flat gradient, prefill cache, decode) on the reduced SmolLM-360M config
in f32, with the JAX package's parameters carried over by `convert`.

Tolerance: f32 rtol 1e-5 / atol 1e-6 for what one op computes; the
logits, loss gradient and decode outputs pass through two 256-wide
layers whose matmuls XLA and PyTorch sum in different orders, so they
are held at rtol 1e-4 / atol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.losses import lm_loss as jax_lm_loss
from repro.launch.steps import make_apply_fn as jax_apply_fn
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import init_lm as jax_init_lm
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.models.layers import apply_rope as jax_rope
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.algorithms import _flat_fn
from repro_torch.core.losses import lm_loss
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import init_lm
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.utils.flat import plane_for

F32 = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config(jax_get_config("smollm-360m"))
    tcfg = reduced_config(get_config("smollm-360m"))
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    j, t = jax_get_config("smollm-360m"), get_config("smollm-360m")
    if reduced:
        j, t = jax_reduced_config(j), reduced_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_init_lm_tree_matches_reference_layout(setup):
    _, tcfg, jparams, _, _ = setup
    tparams = init_lm(0, tcfg, device="cpu")
    jp, tp = jax_plane_for(jparams), plane_for(tparams)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]
    # dense_init is a ±2σ truncated normal scaled by 1/sqrt(d_in)
    w = tparams["stack"]["pos0"]["mixer"]["wq"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(w.shape[1]) + 1e-6
    assert torch.all(tparams["final_norm"]["scale"] == 1)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(jax_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        **F32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), **F32)


def test_logits_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jlog, _ = jax_apply_fn(jcfg, remat=False)(jparams, jnp.asarray(tokens))
    tlog, aux = make_apply_fn(tcfg)(tparams, torch.from_numpy(tokens))
    assert tlog.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)


def test_lm_loss_and_flat_gradient_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jloss_fn, _ = jax_lm_loss(jax_apply_fn(jcfg, remat=False))
    jplane = jax_plane_for(jparams)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda f: jloss_fn(jplane.unpack(f), jnp.asarray(tokens))))(
            jplane.pack(jparams))
    tloss_fn, teval_fn = lm_loss(make_apply_fn(tcfg))
    tplane = plane_for(tparams)
    flat = tplane.pack(tparams).requires_grad_(True)
    tl = _flat_fn(tloss_fn, tplane)(flat, torch.from_numpy(tokens))
    (tg,) = torch.autograd.grad(tl, flat)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **F32)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **NET)
    with torch.no_grad():
        el, met = teval_fn(tparams, torch.from_numpy(tokens))
    assert set(met) == {"accuracy", "nll"}
    np.testing.assert_allclose(float(el), float(jl), **F32)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_cache_and_three_decode_steps_match_reference(setup, window):
    """window=8 < prompt length 16: the ring holds only the last 8
    tokens (`_ring_place`) and attention masks a sliding window."""
    jcfg, tcfg, jparams, tparams, tokens = setup
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jpre, jdec = jax.jit(jax_prefill_step(jcfg)), jax.jit(jax_decode_step(jcfg))
    tpre, tdec = make_prefill_step(tcfg), make_decode_step(tcfg)
    jl, jc = jpre(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = tpre(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    assert tc["length"] == int(jc["length"]) == tokens.shape[1]
    assert tc["stack"]["pos0"]["k"].shape[2] == (window or tokens.shape[1])
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc["stack"]["pos0"][name].numpy(),
            np.asarray(jc["stack"]["pos0"][name]), **NET)
    # drive both with the reference's greedy tokens
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(3):
        jl, jc = jdec(jparams, jc, tok[:, None])
        with torch.no_grad():
            tl, tc = tdec(tparams, tc, torch.from_numpy(np.array(tok))[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
    assert tc["length"] == int(jc["length"])
    # the ring after three decode steps (the prefill ring quirk:
    # capacity = prompt length, so decode overwrote slots 0..2)
    got = to_numpy_tree(tc["stack"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got["pos0"][name],
                                   np.asarray(jc["stack"]["pos0"][name]),
                                   **NET)
