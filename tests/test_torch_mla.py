"""Port parity: DeepSeek-V2's latent attention (MLA) against the JAX
package's, and K7's plain version at an MLA-style qk dim ≠ value dim
against the reference's Pallas kernel in interpret mode.

MLA runs on deepseek-v2-236b's reduced config in float32 (4 heads of
64 + 16 rope dims, a 32-wide q-LoRA and KV latent), with the
reference's parameters carried over by `convert`. Tolerance: rtol 1e-4
/ atol 1e-5, `test_torch_lm.py`'s network tolerance (several 256-wide
matmuls summed in other orders by XLA and PyTorch); attention alone at
2e-5, the reference's own kernel-vs-oracle tolerance
(`tests/test_kernels_attention.py:66-73`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.attention.ops import flash_attention as jax_flash
from repro.models import attention as jax_attn
from repro.models.layers import Rng as JaxRng
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import Rng

NET = dict(rtol=1e-4, atol=1e-5)
ATT = dict(rtol=2e-5, atol=2e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def mla():
    jcfg = jax_reduced_config(jax_get_config("deepseek-v2-236b"))
    tcfg = reduced_config(get_config("deepseek-v2-236b"))
    jp = _np(jax_attn.mla_init(JaxRng(jax.random.PRNGKey(0)), jcfg,
                               jnp.float32))
    x = np.random.RandomState(1).randn(2, 24, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, from_numpy_tree(jp, "cpu"), x


def test_mla_init_tree_matches_reference(mla):
    jcfg, tcfg, jp, _, _ = mla
    tp = attn.mla_init(Rng(0, "cpu"), tcfg, torch.float32)
    assert sorted(tp) == sorted(jp)
    shape = lambda t: ({k: tuple(v.shape) for k, v in t.items()}
                       if isinstance(t, dict) else tuple(t.shape))
    assert {k: shape(v) for k, v in tp.items()} == \
        {k: shape(v) for k, v in jp.items()}
    assert tcfg.q_lora_rank > 0 and "q_norm" in tp


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_reference(mla, causal):
    jcfg, tcfg, jp, tp, x = mla
    pos = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32), x.shape[:2])
    jy, (jc, jk) = jax.jit(lambda p, x: jax_attn.mla_forward(
        p, jcfg, x, jnp.asarray(pos), causal=causal,
        return_latents=True))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        ty, (tc, tk) = attn.mla_forward(tp, tcfg, torch.from_numpy(x),
                                        torch.from_numpy(pos.copy()),
                                        causal=causal, return_latents=True)
    for got, want in ((ty, jy), (tc, jc), (tk, jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)


def test_mla_decode_matches_reference(mla):
    """Three absorbed decode steps after a ring of 24 cached latents
    (capacity 32): scores over the latent cache, the −inf mask past the
    valid slots, the new latents written at slot length % C."""
    jcfg, tcfg, jp, tp, x = mla
    B, L, _ = x.shape
    C = 32
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))
    _, (jc, jk) = jax_attn.mla_forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                       jnp.asarray(x), jnp.asarray(pos),
                                       return_latents=True)
    jcache = jax_attn.mla_init_cache(jcfg, B, C, jnp.float32)
    jcache = {"c": jcache["c"].at[:, :L].set(jc),
              "kpe": jcache["kpe"].at[:, :L].set(jk)}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    rng = np.random.RandomState(2)
    jdec = jax.jit(lambda p, x, c, n: jax_attn.mla_decode(p, jcfg, x, c, n))
    for step in range(3):
        xt = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
        jy, jcache = jdec(jax.tree.map(jnp.asarray, jp), jnp.asarray(xt),
                          jcache, jnp.asarray(L + step, jnp.int32))
        with torch.no_grad():
            ty, tcache = attn.mla_decode(tp, tcfg, torch.from_numpy(xt),
                                         tcache, L + step)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **NET)
        for k in ("c", "kpe"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), **NET)


def test_flash_attention_plain_at_mla_value_dim_matches_pallas():
    """K7's plain version at qk dim 80 ≠ value dim 64 (scale 1/√80)
    against the reference's Pallas kernel in interpret mode, as
    `tests/test_kernels_attention.py::test_flash_mla_value_dim` runs it."""
    rng = np.random.RandomState(0)
    B, L, H, hd, hd_v = 1, 128, 4, 80, 64
    q = rng.randn(B, L, H, hd).astype(np.float32)
    k = rng.randn(B, L, H, hd).astype(np.float32)
    v = rng.randn(B, L, H, hd_v).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     impl="pallas_interpret", block_q=64, block_k=64)
    got = attn_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))
    assert got.shape == (B, L, H, hd_v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT)
