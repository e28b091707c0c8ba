"""Port parity at the two long assigned shapes, prefill_32k and
long_500k, on reduced configs in f32 with the reference's parameters
carried over by `convert`.

- `make_prefill_step` on a 1,024-token prompt (64 SSD chunks at the
  reduced chunk of 16; 16 K7 key tiles of 64) against the reference's
  prefill step: the last position's logits and every cache leaf, for
  SmolLM-360M, Mamba2-370M and deepseek-v2-236b (lead dense layer + one
  MoE layer, MLA's latent cache).
- The port's decode at long_500k (batch 1, 524,288 slots, marked as
  holding 64 tokens, greedy from token 0: `serve.decode_state`'s cache
  stepped by `make_decode_step`, the CLI's body) against the reference's
  `make_decode_step` under its `resolve_serving_config` driven as its
  serve CLI drives it: the 8,192 GQA ring of the window long_500k gives
  SmolLM, Mamba2's SSM state, and deepseek's MLA latents over all
  524,288 slots. Each step's logits and the final cache, leaf for leaf;
  `serve.decode_steps`' record (window, cache bytes, finite logits).
- `input_specs` and `cache_pspecs` at both shapes on the launchers' host
  meshes (1x1, 2x1, 1x2), for all ten configs, against the reference's
  (`tests/test_torch_sharding.py` holds the production meshes).

The JAX side runs jitted, with its SSD on the chunked jnp route (the
default on the CPU) and attention on its jnp reference; the port's
kernel wrappers take their plain versions because the tensors lie on
the CPU.

Tolerance: the LM tests' rtol 1e-4 / atol 1e-5 for the logits and every
cache leaf. Even the first layer's keys come out of a 256-term matmul
that XLA and PyTorch sum in other orders: at rtol 1e-5 / atol 1e-6,
0.44 % of its entries (near zero, at most 4.1e-6 apart) fail.

Serial time: ~30 s (26 s in pytest, 30 s wall, on this file alone).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.steps import input_specs as jax_input_specs
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import resolve_serving_config as jax_resolve
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_lm as jax_init_lm
from repro.sharding import rules as jr
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs import reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.launch import serve
from repro_torch.launch.steps import (input_specs, make_decode_step,
                                      make_prefill_step,
                                      resolve_serving_config)
from repro_torch.sharding import rules as tr

NET = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["smollm-360m", "mamba2-370m", "deepseek-v2-236b"]
PROMPT = 1024
DECODE_STEPS = 4
HOST_MESHES = {"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference params, port
    params), the port's carried over from the reference's seed-0 draw."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_reduced_config(jax_get_config(arch))
        jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, reduced_config(get_config(arch)), jparams,
                     from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu"))
    return out


def _paths(tree, prefix=""):
    """path -> leaf of a tree of dicts (numpy or tensor leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _hold_caches(got, want, tol):
    got = _paths(to_numpy_tree({k: v for k, v in got.items()
                                if k != "length"}))
    want = _paths(jax.tree.map(np.asarray, {k: v for k, v in want.items()
                                            if k != "length"}))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], **tol,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_of_a_long_prompt_matches_reference(models, arch):
    jcfg, tcfg, jparams, tparams = models[arch]
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = jax.jit(jax_prefill_step(jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tparams, torch.from_numpy(tokens))
    assert tl.shape == (2, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    assert tc["length"] == int(jc["length"]) == PROMPT
    _hold_caches(tc, jc, NET)


def _reference_decode(jcfg, jparams):
    """The reference's serve CLI body at long_500k, batch 1, no mesh:
    a zero cache of the shape's slots marked as holding 64 tokens, token
    0, greedy steps (`repro/launch/serve.py:84-120`)."""
    shape = J_SHAPES["long_500k"]
    scfg = jax_resolve(jcfg, shape)
    cache = jax_init_decode_cache(scfg, shape.global_batch, shape.seq_len)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), cache)
    cache["length"] = jnp.asarray(min(64, shape.seq_len), jnp.int32)
    step = jax.jit(jax_decode_step(scfg))
    tok = jnp.zeros((shape.global_batch, 1), jnp.int32)
    logits = []
    for _ in range(DECODE_STEPS):
        lg, cache = step(jparams, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
    return scfg, logits, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_at_long_500k_match_reference(models, arch):
    jcfg, tcfg, jparams, tparams = models[arch]
    shape = INPUT_SHAPES["long_500k"]
    jscfg, jlogits, jcache = _reference_decode(jcfg, jparams)
    scfg = resolve_serving_config(tcfg, shape)
    assert scfg.sliding_window == jscfg.sliding_window
    assert scfg.sliding_window == (8192 if arch == "smollm-360m" else None)
    _, cache = serve.decode_state(scfg, shape.global_batch, shape.seq_len,
                                  device="cpu", params=tparams)
    step = make_decode_step(scfg)
    tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
    with torch.no_grad():
        for want in jlogits:
            logits, cache = step(tparams, cache, tok)
            np.testing.assert_allclose(logits.numpy(), want, **NET)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        rec = serve.decode_steps(scfg, shape.global_batch, shape.seq_len, 1,
                                 device="cpu", params=tparams)
    assert cache["length"] == int(jcache["length"]) == 64 + DECODE_STEPS
    _hold_caches(cache, jcache, NET)
    assert rec["logits_finite"]
    assert rec["sliding_window"] == scfg.sliding_window
    want_bytes = sum(x.size * x.dtype.itemsize
                     for x in jax.tree.leaves(jcache)) - 4  # the length
    assert rec["cache_bytes"] == want_bytes
    if arch == "smollm-360m":       # a ring of the window, not the shape
        assert cache["stack"]["pos0"]["k"].shape[2] == 8192
    if arch == "deepseek-v2-236b":  # MLA is not windowed
        assert cache["lead_0"]["c"].shape[1] == shape.seq_len


def _stub(shape):
    names = ("data", "model")
    return types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=shape))


def _specs(tree, prefix=""):
    if isinstance(tree, (tr.P, jax.sharding.PartitionSpec)):
        return {prefix: tuple(tree)}
    return {p: s for k, v in tree.items()
            for p, s in _specs(v, f"{prefix}/{k}").items()}


def _leaf_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _leaf_shapes(v, f"{prefix}/{k}").items()}
    return {prefix: tuple(getattr(tree, "shape", ()))}


@pytest.mark.parametrize("shape", ["prefill_32k", "long_500k"])
@pytest.mark.parametrize("arch", list_archs())
def test_specs_on_host_meshes_match_reference(arch, shape):
    """Every spec at the shape on the 1x1, 2x1 and 1x2 meshes, the
    batch's shapes, the cache specs (seq_shard off and on) and the
    resolved window equal the reference's; every placement they give is
    one `check_placeable` takes (a batch of 1 at long_500k stays whole:
    the reference's divisibility guard)."""
    for mesh_shape in HOST_MESHES.values():
        mesh = _stub(mesh_shape)
        got = input_specs(get_config(arch), INPUT_SHAPES[shape], mesh)
        want = jax_input_specs(jax_get_config(arch), J_SHAPES[shape], mesh)
        assert _specs(got["pspec"]) == _specs(want["pspec"])
        assert _leaf_shapes(got["batch"]) == _leaf_shapes(want["batch"])
        tr.check_placeable(got["batch"], got["pspec"], mesh)
        if shape == "long_500k":
            assert got["serving_cfg"].sliding_window == \
                want["serving_cfg"].sliding_window
            for seq in (False, True):
                assert _specs(tr.cache_pspecs(
                    got["batch"]["cache"], mesh, seq_shard=seq)) == _specs(
                    jr.cache_pspecs(want["batch"]["cache"], mesh,
                                    seq_shard=seq))
