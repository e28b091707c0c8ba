"""Port parity: seamless-m4t's encoder-decoder against the JAX package —
cross-attention, the bidirectional encoder, `lm_apply` with and without
the prefill cache, the prefill -> decode handoff, and f32 frames into a
bf16 model — on the reduced config in float32 (bf16 for the mixed-dtype
case), the reference's parameters carried over by `convert`.

Tolerances: one block (cross-attention, the encoder's layers) at rtol
1e-5 / atol 1e-6 scaled to the output, the port's convention for f32
paths that sum in other orders; whole-model logits at rtol 1e-4 / atol
1e-5 (`test_torch_dense_configs.py`: layers of 256-wide matmuls summed
in other orders by XLA and PyTorch). The handoff (the port's prefill,
then decode, against its own full forward) at the reference's own 2e-3
(`tests/test_arch_smoke.py:145-168`). The bf16 model rounds each
product to bf16 on both sides, in other summation orders: logits within
2^-6 of the largest, a few bf16 ulps."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import attention as jax_attn
from repro.models import init_lm as jax_init_lm
from repro.models import lm as jax_lm
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import attention, init_decode_cache, lm, lm_apply
from repro_torch.models import lm_decode_step

ARCH = "seamless-m4t-medium"
F32 = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=1e-4, atol=1e-5)
HANDOFF = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(dtype="float32"):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                               dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, from_numpy_tree(_np(jparams), "cpu")


@pytest.fixture(scope="module")
def s2t():
    jcfg, tcfg, jparams, tparams = _setup()
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    frames = rng.normal(0, 0.1, (2, jcfg.num_modality_tokens,
                                 jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, tokens, frames


def _shapes(tree, path=()):
    """{"a/b/c": shape} over the leaves of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {"/".join(path): tuple(tree.shape)}


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def test_config_and_tree(s2t):
    """12 + 12 layers at full size; the reduced tree has each decoder
    block's ``norm_cross`` and ``cross/{wq,wk,wv,wo}``, ``mod_proj`` and
    the stacked ``encoder``, leaf for leaf the reference's."""
    full = get_config(ARCH)
    assert (full.num_layers, full.num_encoder_layers) == (12, 12)
    jcfg, tcfg, jparams, _, _, _ = s2t
    block = jparams["stack"]["pos0"]
    assert {"norm_cross", "cross"} <= set(block)
    assert set(block["cross"]) == {"wq", "wk", "wv", "wo"}
    assert set(jparams["encoder"]) == {"stack", "final_norm"}
    mine = lm.init_lm(0, tcfg, device="cpu")
    assert _shapes(mine) == _shapes(jparams)


def test_cross_attn_forward_matches_reference(s2t):
    """Lq = 12 text positions over T = 8 frames, no mask, no rope; and at
    Lq = 1, a decode step's query."""
    jcfg, tcfg, jparams, tparams, _, _ = s2t
    rng = np.random.RandomState(4)
    enc = rng.randn(2, jcfg.num_modality_tokens, jcfg.d_model).astype(
        np.float32)
    for Lq in (12, 1):
        x = rng.randn(2, Lq, jcfg.d_model).astype(np.float32)
        jp = jax.tree.map(lambda a: a[0], jparams["stack"]["pos0"]["cross"])
        tp = {k: v[0] for k, v in tparams["stack"]["pos0"]["cross"].items()}
        want = np.asarray(jax_attn.cross_attn_forward(
            jp, jcfg, jnp.asarray(x), jnp.asarray(enc)))
        got = attention.cross_attn_forward(tp, tcfg, torch.from_numpy(x),
                                           torch.from_numpy(enc))
        assert got.shape == (2, Lq, jcfg.d_model)
        _close(got.numpy(), want, F32)


def test_run_encoder_matches_reference(s2t):
    jcfg, tcfg, jparams, tparams, _, frames = s2t
    want = np.asarray(jax_lm._run_encoder(jparams, jcfg,
                                          jnp.asarray(frames)))
    with torch.no_grad():
        got = lm._run_encoder(tparams, tcfg, torch.from_numpy(frames))
    _close(got.numpy(), want, F32)


def test_lm_apply_matches_reference(s2t):
    """Logits over the text (the encoder's output is not in them), and
    the prefill cache: every layer's K / V ring and ``enc_out``."""
    jcfg, tcfg, jparams, tparams, tokens, frames = s2t
    jlog, _ = jax_lm.lm_apply(jparams, jcfg, jnp.asarray(tokens),
                              modality_embeds=jnp.asarray(frames),
                              remat=False)
    jlog2, _, jcache = jax_lm.lm_apply(
        jparams, jcfg, jnp.asarray(tokens),
        modality_embeds=jnp.asarray(frames), collect_cache=True,
        cache_capacity=16)
    with torch.no_grad():
        tlog, _ = lm_apply(tparams, tcfg, torch.from_numpy(tokens),
                           modality_embeds=torch.from_numpy(frames),
                           remat=False)
        tlog2, _, tcache = lm_apply(
            tparams, tcfg, torch.from_numpy(tokens),
            modality_embeds=torch.from_numpy(frames), collect_cache=True,
            cache_capacity=16)
    assert tlog.shape == (2, 12, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), **NET)
    assert tcache["length"] == int(jcache["length"]) == 12
    _close(tcache["enc_out"].numpy(), np.asarray(jcache["enc_out"]), F32)
    for key in ("k", "v"):
        want = np.asarray(jcache["stack"]["pos0"][key])
        assert tcache["stack"]["pos0"][key].shape == want.shape
        np.testing.assert_allclose(tcache["stack"]["pos0"][key].numpy(),
                                   want, **NET)


def test_prefill_decode_handoff_against_full_forward():
    """Prefill 20 tokens over 8 frames into a cache with room, decode 4
    more one at a time: each step's logits are the full forward's at its
    position (cross-attention recomputes K and V from ``enc_out``)."""
    cfg = reduced_config(get_config(ARCH))
    params = lm.init_lm(0, cfg, device="cpu")
    rng = np.random.RandomState(5)
    L, extra = 20, 4
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                         (1, L + extra)), dtype=torch.int32)
    frames = torch.as_tensor(rng.normal(0, 0.1, (1, 8, cfg.d_model)),
                             dtype=torch.float32)
    with torch.no_grad():
        full, _ = lm_apply(params, cfg, tokens, modality_embeds=frames,
                           remat=False)
        pre, _, cache = lm_apply(params, cfg, tokens[:, :L],
                                 modality_embeds=frames, remat=False,
                                 collect_cache=True, cache_capacity=L + extra,
                                 logits_mode="last")
        np.testing.assert_allclose(pre[:, 0].numpy(), full[:, L - 1].numpy(),
                                   **HANDOFF)
        for t in range(L, L + extra):
            dec, cache = lm_decode_step(params, cfg, tokens[:, t:t + 1],
                                        cache)
            np.testing.assert_allclose(dec[:, 0].numpy(), full[:, t].numpy(),
                                       **HANDOFF)
    assert cache["length"] == L + extra


def test_decode_cache_carries_enc_out():
    cfg = reduced_config(get_config(ARCH))
    enc = torch.zeros((2, cfg.num_modality_tokens, cfg.d_model))
    cache = init_decode_cache(cfg, 2, 16, enc_out=enc, device="cpu")
    assert cache["enc_out"] is enc
    params = lm.init_lm(0, cfg, device="cpu")
    with torch.no_grad():
        logits, new = lm_decode_step(params, cfg,
                                     torch.zeros((2, 1), dtype=torch.int32),
                                     cache)
    assert new["enc_out"] is enc and new["length"] == 17
    assert torch.isfinite(logits).all()


def test_f32_frames_into_a_bf16_model_promote_as_jax():
    """The reference computes ``frames @ mod_proj`` with no cast, so f32
    frames into a bf16 model give an f32 encoder and an f32 ``enc_out``;
    the decoder's bf16 queries then meet f32 keys and values. The port
    promotes as JAX does: same dtypes out (bf16 logits' f32 cast, an f32
    enc_out), values within the bf16 limit, through prefill and one
    decode step."""
    jcfg, tcfg, jparams, tparams = _setup("bfloat16")
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    frames = rng.normal(0, 0.1, (2, jcfg.num_modality_tokens,
                                 jcfg.d_model)).astype(np.float32)
    jenc = jax_lm._run_encoder(jparams, jcfg, jnp.asarray(frames))
    batch = {"tokens": tokens, "embeds": frames}
    jl, jc = jax.jit(jax_prefill_step(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        tenc = lm._run_encoder(tparams, tcfg, torch.from_numpy(frames))
        tl, tc = make_prefill_step(tcfg)(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert jenc.dtype == jnp.float32 and tenc.dtype == torch.float32
    assert tc["enc_out"].dtype == torch.float32
    assert jc["enc_out"].dtype == jnp.float32
    assert tc["stack"]["pos0"]["k"].dtype == torch.bfloat16
    _close(tenc.numpy(), np.asarray(jenc), dict(rtol=2 ** -6, atol=2 ** -6))
    limit = 2 ** -6 * float(np.abs(np.asarray(jl)).max())
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= limit
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, _ = jax.jit(jax_decode_step(jcfg))(jparams, jc, jnp.asarray(tok))
    with torch.no_grad():
        tl, _ = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(tok))
    assert tl.dtype == torch.float32
    limit = 2 ** -6 * float(np.abs(np.asarray(jl)).max())
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= limit
