"""Port parity at nemotron-4-340b's head geometry: 96 query heads over 8
kv heads (G = 12) of head_dim 192, on the CPU against the JAX package.

On the card K7 runs this shape as `flash_attention_mma_kernel<192,
192>` and K8 in bf16 as the tensor-core `flash_decode_wide_kernel<192>`
(in f32 as the CUDA-core `flash_decode_kernel` built for kG = 12, kHD =
192; `chip_smoke.py` holds them against these plain versions);
here each wrapper takes its plain version because the tensors lie on
the CPU.

- K7's plain version against the reference's `flash_attention_bhld(...,
  interpret=True)` at (1, 12 heads, 1 kv head, 256, 192), hd_v 192:
  causal, causal with a window, and a q_offset. f32 at rtol 1e-5 /
  atol 1e-5; bf16 at the card's per-element limit, 2^-7·|reference| +
  1e-4 (`chip_smoke.closeness`: one bf16 ulp of the output beside an
  f32 gap from the other summation order).
- K8's plain version against the reference's `flash_decode(...,
  interpret=True)` at G = 12, hd = 192, C = 1,024 with ragged lengths
  and a row of kv_length 0: the plain version gives NaN there (the jnp
  oracle's -inf mask), the reference kernel and the split model that
  K8 follows give the mean of V. f32 at 2e-5, the reference's own
  kernel-vs-oracle tolerance (`tests/test_torch_decode_split.py`).
- nemotron's reduced config with its head geometry put back (12 heads
  over 1 kv head, head_dim 192; relu2, 2 layers, vocabulary 512): the
  reference's `init_lm` weights through `convert`, `make_prefill_step`'s
  logits and cache and 4 `make_decode_step` steps against the
  reference's, f32, at rtol 1e-5 and an atol of 1e-5 of the largest
  |logit| (2,304-wide projections summed in other orders by XLA and
  PyTorch).
- K7's and K8's launchers hand these shapes to the extension (a stub)
  and still refuse the next ones up with a ValueError first.

Serial time: about 17 s (9 s in the tests, the rest importing jax and
torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.attention.flash_attention import flash_attention_bhld as jax_flash
from repro.kernels.decode_attention.flash_decode import flash_decode as jax_decode
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import init_lm as jax_init_lm
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import _checks
from repro_torch.kernels.attention import flash_attention as k7
from repro_torch.kernels.decode_attention import flash_decode as k8
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.launch.steps import make_decode_step, make_prefill_step

ARCH = "nemotron-4-340b"
H, KV, HD = 12, 1, 192            # one kv head's group of the full model
F32 = dict(rtol=1e-5, atol=1e-5)
ATT = dict(rtol=2e-5, atol=2e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_full_config_is_the_head_shape_under_test():
    cfg = get_config(ARCH)
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (96, 8, 192)
    assert cfg.num_heads // cfg.num_kv_heads == H // KV


# ---- K7 at hd = hd_v = 192, G = 12 ----------------------------------------

def _qkv(seed, Lq, Lk, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, H, Lq, HD).astype(np.float32)
    k = rng.randn(1, KV, Lk, HD).astype(np.float32)
    v = rng.randn(1, KV, Lk, HD).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return ([torch.from_numpy(a).to(dtype) for a in (q, k, v)],
            [jnp.asarray(a, jd) for a in (q, k, v)])


# (Lq, Lk, causal, window, q_offset)
K7_CASES = {"causal": (256, 256, True, None, 0),
            "window": (256, 256, True, 64, 0),
            "q_offset": (128, 256, True, None, 128)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_k7_plain_matches_pallas_at_nemotron_heads(case, dtype):
    Lq, Lk, causal, window, q_offset = K7_CASES[case]
    (q, k, v), (jq, jk, jv) = _qkv(3, Lq, Lk, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(jax_flash(jq, jk, jv, interpret=True, **kw)
                      .astype(jnp.float32))
    got = k7.flash_attention_bhld(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == (1, H, Lq, HD)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        limit = 2.0 ** -7 * np.abs(want) + 1e-4
        assert np.all(np.abs(got.float().numpy() - want) <= limit)


# ---- K8 at G = 12, hd = 192 -----------------------------------------------

def test_k8_plain_matches_pallas_at_nemotron_heads():
    B, C = 4, 1024
    rng = np.random.RandomState(4)
    q = rng.randn(B, KV * H, HD).astype(np.float32)
    kc = rng.randn(B, C, KV, HD).astype(np.float32)
    vc = rng.randn(B, C, KV, HD).astype(np.float32)
    kvl = np.array([0, 1, 517, 1024], np.int32)
    want = np.asarray(jax_decode(*(jnp.asarray(a) for a in (q, kc, vc, kvl)),
                                 interpret=True))
    args = [torch.from_numpy(a) for a in (q, kc, vc, kvl)]
    plain = k8.flash_decode(*args)
    # the jnp oracle's NaN row; the kernel's mean of V beside it
    assert torch.isnan(plain[0]).all()
    np.testing.assert_allclose(want[0], np.repeat(vc[0].mean(0), H, 0), **ATT)
    np.testing.assert_allclose(plain[1:].numpy(), want[1:], **ATT)
    # the split arithmetic K8 runs, every row (the 0 row too), as the
    # card's B = 4 ragged case splits it
    for splits in (1, 16):
        split = dec_ref.decode_attention_split_plain(*args, splits, tile=32)
        np.testing.assert_allclose(split.numpy(), want, **ATT)


# ---- the narrow config with nemotron's heads --------------------------------

def test_narrow_nemotron_prefill_and_decode_match_reference():
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                               num_heads=H, num_kv_heads=KV, head_dim=HD)
    tcfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                               num_heads=H, num_kv_heads=KV, head_dim=HD)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.num_layers, tcfg.vocab_size, tcfg.mlp_act) == (2, 512,
                                                                 "relu2")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(_np_tree(jparams), "cpu")
    tokens = np.random.RandomState(5).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)

    def close(t, j):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(
            t.float().numpy(), j, rtol=F32["rtol"],
            atol=F32["atol"] * max(float(np.abs(j).max()), 1.0))

    def close_tree(t, j):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j)
            for k in t:
                close_tree(t[k], j[k])
        elif isinstance(t, torch.Tensor):
            close(t, j)
        else:
            assert t == int(j)

    jl, jc = jax.jit(jax_prefill_step(jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tparams, torch.from_numpy(tokens))
    close(tl, jl)
    close_tree(tc, jc)
    jdec, step = jax.jit(jax_decode_step(jcfg)), make_decode_step(tcfg)
    for _ in range(4):
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = jdec(jparams, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = step(tparams, tc, torch.from_numpy(tok))
        close(tl, jl)
    assert tc["length"] == int(jc["length"]) == tokens.shape[1] + 4
    close_tree(tc, jc)


# ---- the launchers take the shape and refuse the next one up ----------------

class _Ext:
    def __init__(self):
        self.calls = []

    def flash_attention(self, *args):
        self.calls.append("flash_attention")

    def flash_decode(self, *args):
        self.calls.append(("flash_decode", args[-2]))


@pytest.fixture
def ext(monkeypatch):
    fake = _Ext()
    for mod in (k7, k8):
        monkeypatch.setattr(mod, "get_ext", lambda: fake)
        monkeypatch.setattr(mod, "launches", mod.launches)
    monkeypatch.setattr(k8, "_sm_count", lambda device: 132)
    return fake


def test_k7_launcher_takes_bf16_hd_192_and_refuses_256(ext):
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)   # noqa: E731
    before = k7.launches
    k7._launch(z(1, 96, 8, HD), z(1, 8, 8, HD), z(1, 8, 8, HD), True, None,
               0)
    assert ext.calls == ["flash_attention"] and k7.launches == before + 1
    for hd, hd_v in ((256, 192), (192, 256)):
        with pytest.raises(ValueError, match="K7 takes"):
            k7._launch(z(1, 96, 8, hd), z(1, 8, 8, hd), z(1, 8, 8, hd_v),
                       True, None, 0)
    assert ext.calls == ["flash_attention"] and k7.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_launcher_takes_g12_hd192_and_refuses_past_it(ext, dtype):
    z = lambda *s: torch.zeros(s, dtype=dtype)   # noqa: E731
    before = k8.launches
    k8._launch(z(2, 96, HD), z(2, 64, 8, HD), z(2, 64, 8, HD), 64)
    assert ext.calls == [("flash_decode", 1)] and k8.launches == before + 1
    refused = ((z(2, 104, HD), z(2, 64, 8, HD)),     # G = 13
               (z(2, 16, 256), z(2, 64, 8, 256)),    # hd 256
               (z(2, 16, 136), z(2, 64, 8, 136)))    # hd 136: not % 24
    for q, c in refused:
        with pytest.raises(ValueError, match="refuses the call"):
            k8._launch(q, c, c, 64)
    assert len(ext.calls) == 1 and k8.launches == before + 1
    assert (_checks.DECODE_MAX_G, _checks.DECODE_MAX_HD) == (12, 192)


def test_k8_wide_kernels_plan_one_block_an_sm():
    """The f32 kernels built for G > 8 or hd > 128 (nemotron's heads at
    kG = 12, kHD = 192: 255 registers a thread) keep one block an SM,
    so the split count fills 132 SMs with one wave of single blocks;
    bf16's tensor-core kernel at those heads (`flash_decode_wide_kernel
    <192>`, two 51.2 KB stages) keeps two."""
    assert k8.blocks_per_sm(12, 192, torch.float32) == 1
    assert k8.blocks_per_sm(3, 192, torch.float32) == 1
    assert k8.blocks_per_sm(12, 192, torch.bfloat16) == k8.BLOCKS_PER_SM == 2
    # one decode step of 1 sequence over a 32K cache: 8 kv heads
    assert k8.num_splits(1, 8, 32768, per_sm=1) == 132 // 8
    assert k8.num_splits(1, 8, 32768) == 2 * 132 // 8
    # decode_32k's batch of 128: one split
    assert k8.num_splits(128, 8, 32768, per_sm=1) == 1


# (dtype, G, hd, B, Kv, span) -> (blocks an SM, splits): the residency
# of the kernel `kernel_for` names (kBlocksPerSM for bf16's tensor-core
# kernels, `Shape::kMinBlocks` for f32's) and the splits that follow on
# 132 SMs
RESIDENCY = [
    (torch.bfloat16, 12, 192, 1, 8, 32768, 2, 33),    # nemotron, one row
    (torch.bfloat16, 12, 192, 128, 8, 32768, 2, 1),   # its decode_32k
    (torch.bfloat16, 12, 192, 4, 8, 4096, 2, 8),      # ragged, 8 splits
    (torch.bfloat16, 7, 128, 1, 4, 32768, 2, 66),     # qwen2-vl, one row
    (torch.bfloat16, 7, 128, 4, 4, 4096, 2, 16),      # its ragged case
    (torch.bfloat16, 8, 128, 2, 2, 64, 2, 1),         # qwen2.5's group
    (torch.bfloat16, 12, 64, 1, 8, 32768, 2, 33),     # G 12, hd 64
    (torch.bfloat16, 3, 64, 1, 5, 32768, 2, 52),      # SmolLM's 32K step
    (torch.float32, 12, 192, 1, 8, 32768, 1, 16),     # f32, 255 registers
    (torch.float32, 8, 128, 1, 2, 32768, 2, 128),
]


@pytest.mark.parametrize("dtype,G,hd,Bq,Kv,span,blocks,splits", RESIDENCY)
def test_k8_residency_sets_the_split_count(dtype, G, hd, Bq, Kv, span,
                                           blocks, splits):
    assert k8.blocks_per_sm(G, hd, dtype) == blocks
    assert k8.num_splits(Bq, Kv, span, 132, blocks) == splits
