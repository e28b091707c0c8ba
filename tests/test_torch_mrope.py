"""Port parity: qwen2-vl's M-RoPE and its [prefix | text] positions
against the JAX package, and the reference's decode-position quirk,
reproduced on purpose.

`apply_mrope` is f32 math on both sides (cos / sin of the same f32
angles, one product and one sum per element): held at rtol 1e-5 /
atol 1e-6. Positions are integers, held exactly.

The quirk: `_positions` gives text token i the components t = h = w =
i + grid (grid = ⌈√n_mod⌉), while `gqa_decode` rotates the new token at
``length`` = n_mod + L_text through `text_mrope_positions`. So a decoded
token's logits are not the full forward's at its position; both
packages decode alike, and both miss the full forward by O(1). Logits
are held as in `test_torch_dense_configs.py` (rtol 1e-4 / atol 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import init_lm as jax_init_lm
from repro.models import lm_apply as jax_lm_apply
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import layers, lm, lm_apply

F32 = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=1e-4, atol=1e-5)
ARCH = "qwen2-vl-7b"


@pytest.mark.parametrize("hd,sections,theta", [
    (128, (16, 24, 24), 1e6),      # qwen2-vl-7b
    (64, (16, 8, 8), 1e6),         # its reduced config
    (32, (4, 4, 8), 1e4)])
def test_apply_mrope_matches_reference(hd, sections, theta):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 10, 3, hd).astype(np.float32)
    pos3 = rng.randint(0, 5000, (2, 10, 3)).astype(np.int32)
    want = np.asarray(jax_layers.apply_mrope(jnp.asarray(x),
                                             jnp.asarray(pos3), theta,
                                             sections))
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             theta, sections)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_text_positions_make_mrope_equal_to_rope():
    """Three equal components rotate as plain RoPE does, on both
    sides."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 7, 2, 64).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)[None] + 40
    lifted = layers.text_mrope_positions(torch.from_numpy(pos))
    np.testing.assert_array_equal(
        lifted.numpy(),
        np.asarray(jax_layers.text_mrope_positions(jnp.asarray(pos))))
    got = layers.apply_mrope(torch.from_numpy(x), lifted, 1e6, (16, 8, 8))
    rope = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), rope.numpy(), **F32)


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-medium"])
@pytest.mark.parametrize("n_mod,L_text", [(0, 5), (1, 3), (8, 12),
                                           (1024, 3072), (30, 2)])
def test_positions_match_reference(arch, n_mod, L_text):
    """The vision layout (patch i at (0, i // grid, i % grid), text at
    i + grid) and the 1-D layout, exactly."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = np.asarray(jax_lm._positions(jcfg, n_mod, L_text, 2))
    got = lm._positions(tcfg, n_mod, L_text, 2, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def vl():
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    embeds = rng.normal(0, 0.1, (2, jcfg.num_modality_tokens,
                                 jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, tokens, embeds


def test_decode_position_quirk_is_the_references(vl):
    """8 patch embeddings and 12 text tokens prefilled, token 13 decoded:
    the prefill's last logits are `lm_apply`'s in both packages; the
    decoded token's logits are the reference's decode, and in both
    packages O(1) away from the full forward at position 20."""
    jcfg, tcfg, jparams, tparams, tokens, embeds = vl
    n_mod = jcfg.num_modality_tokens
    assert n_mod == 8
    jfull, _ = jax_lm_apply(jparams, jcfg, jnp.asarray(tokens),
                            modality_embeds=jnp.asarray(embeds), remat=False)
    jfull = np.asarray(jfull)
    with torch.no_grad():
        tfull, _ = lm_apply(tparams, tcfg, torch.from_numpy(tokens),
                            modality_embeds=torch.from_numpy(embeds),
                            remat=False)
    np.testing.assert_allclose(tfull.numpy(), jfull, **NET)

    prompt = {"tokens": tokens[:, :12], "embeds": embeds}
    jl, jc = jax.jit(jax_prefill_step(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in prompt.items()})
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(
            tparams, {k: torch.from_numpy(v) for k, v in prompt.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    np.testing.assert_allclose(np.asarray(jl), jfull[:, n_mod + 11], **NET)
    assert tc["length"] == int(jc["length"]) == n_mod + 12

    nxt = tokens[:, 12:13]
    jl, _ = jax.jit(jax_decode_step(jcfg))(jparams, jc, jnp.asarray(nxt))
    with torch.no_grad():
        tl, _ = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    scale = np.abs(jfull[:, n_mod + 12]).max()
    for got in (np.asarray(jl), tl.numpy()):
        gap = np.abs(got - jfull[:, n_mod + 12]).max()
        assert 0.05 * scale < gap, (gap, scale)
