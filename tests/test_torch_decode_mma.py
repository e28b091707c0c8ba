"""K8's tensor-core arithmetic at hd 128 / 192 and G up to 12, on the CPU.

On the card every bf16 K8 call with hd above 64 or G above 8 runs
``flash_decode_wide_kernel`` (`kernels/csrc/flash_decode.cu`): its 4
warps each take a 16-key slice of every 64-key tile with their own
online softmax in log2 units, carry P into P·V as hi + lo bf16 terms,
and merge (m, l, O) once at the end; the splits then merge in
``flash_decode_combine_kernel``. `ref.decode_attention_split_plain(...,
tile=64, warps=4, p_terms=True)` models that arithmetic in plain
PyTorch; here it is held against the reference's Pallas kernel
(`flash_decode(..., interpret=True)`) on seeded numpy inputs at G in
{7, 12}, hd in {128, 192} (192 with G = 12, nemotron's heads), ragged
lengths with a row of kv_length 0 (the mean of V), and 1 and 3 splits.
Tolerance: 2e-5, as `tests/test_torch_decode_split.py` (the reference's
own kernel-vs-oracle tolerance; both sides sum in f32 in different
orders, and the hi + lo terms keep 2^-17 of each weight).

Also: `kernel_for` on every (dtype, G, hd) bucket `launch_all` routes,
and the launcher handing a bf16 hd-128 call and a G-12 call to the
extension (a stub) once each, with the split count of the kernel's
residency.

Serial time: about 19 s (14 s in the tests, most of it the Pallas
interpreter; the rest importing jax and torch).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.flash_decode import flash_decode as jax_decode
from repro_torch.kernels.decode_attention import flash_decode as k8
from repro_torch.kernels.decode_attention import ref
from test_torch_nemotron import ext  # noqa: F401 — `_Ext`, the stub extension

ATT = dict(rtol=2e-5, atol=2e-5)
B, CC, KV = 4, 160, 2
LENGTHS = (0, 37, 160, 101)   # a 0 row, a partial tile, full, ragged


@functools.lru_cache(maxsize=None)
def _case(G, hd):
    """Seeded inputs and the Pallas (interpret) result."""
    rng = np.random.RandomState(31 + G + hd)
    q = rng.randn(B, KV * G, hd).astype(np.float32)
    kc = rng.randn(B, CC, KV, hd).astype(np.float32)
    vc = rng.randn(B, CC, KV, hd).astype(np.float32)
    kvl = np.asarray(LENGTHS, np.int32)
    expect = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(kvl), block_k=32, interpret=True)
    return q, kc, vc, kvl, np.asarray(expect)


@pytest.mark.parametrize("G,hd", [(7, 128), (12, 128), (12, 192)])
@pytest.mark.parametrize("splits", [1, 3])
def test_wide_model_matches_pallas(G, hd, splits):
    q, kc, vc, kvl, expect = _case(G, hd)
    got = ref.decode_attention_split_plain(
        *(torch.from_numpy(a) for a in (q, kc, vc, kvl)), splits, tile=64,
        warps=4, p_terms=True)
    np.testing.assert_allclose(got.numpy(), expect, **ATT)
    # the row of kv_length 0: the mean of V over all C slots
    mean_v = np.repeat(vc[0].mean(0), G, axis=0)
    np.testing.assert_allclose(got[0].numpy(), mean_v, **ATT)


def test_wide_model_moves_from_the_one_slice_model_within_the_p_terms():
    """The warps' slices and the hi + lo weights change the summation,
    not the answer: the model with them and without them agree within
    the tolerance, and differ (the slices are really taken)."""
    q, kc, vc, kvl, _ = _case(12, 192)
    args = [torch.from_numpy(a) for a in (q, kc, vc, kvl)]
    wide = ref.decode_attention_split_plain(*args, 3, tile=64, warps=4,
                                            p_terms=True)
    one = ref.decode_attention_split_plain(*args, 3, tile=64)
    np.testing.assert_allclose(wide.numpy(), one.numpy(), **ATT)
    assert not torch.equal(wide, one)


# (dtype, G, hd) -> the kernel `launch_all` / `launch_g` take: bf16 at
# hd <= 64 and G <= 8 on the dims-split tensor-core kernel, every other
# bf16 call on the keys-split one by head-dim bucket; f32 on the CUDA
# cores, built for the head-dim bucket and G bucket (2, 3, 4, 8, 12)
BF16, F32 = torch.bfloat16, torch.float32
ROUTES = [
    (BF16, 1, 32, "flash_decode_mma_kernel"),
    (BF16, 8, 64, "flash_decode_mma_kernel"),
    (BF16, 12, 64, "flash_decode_wide_kernel<128>"),
    (BF16, 1, 96, "flash_decode_wide_kernel<128>"),
    (BF16, 7, 128, "flash_decode_wide_kernel<128>"),
    (BF16, 12, 128, "flash_decode_wide_kernel<128>"),
    (BF16, 4, 144, "flash_decode_wide_kernel<192>"),
    (BF16, 12, 192, "flash_decode_wide_kernel<192>"),
    (F32, 1, 16, "flash_decode_kernel<float, 32, 2>"),
    (F32, 3, 32, "flash_decode_kernel<float, 32, 3>"),
    (F32, 4, 64, "flash_decode_kernel<float, 64, 4>"),
    (F32, 5, 64, "flash_decode_kernel<float, 64, 8>"),
    (F32, 8, 128, "flash_decode_kernel<float, 128, 8>"),
    (F32, 9, 128, "flash_decode_kernel<float, 128, 12>"),
    (F32, 2, 168, "flash_decode_kernel<float, 192, 2>"),
    (F32, 12, 192, "flash_decode_kernel<float, 192, 12>"),
]


@pytest.mark.parametrize("dtype,G,hd,kernel", ROUTES)
def test_kernel_for_names_the_route(dtype, G, hd, kernel):
    assert k8.kernel_for(dtype, G, hd) == kernel


@pytest.mark.parametrize("Bq,C,Kv,G,hd,splits", [
    (2, 64, 2, 8, 128, 1),        # qwen2.5's serving group
    (1, 32768, 4, 7, 128, 66),    # a long cache: 2 blocks an SM
    (1, 32768, 8, 12, 192, 33),   # nemotron's heads: 2 blocks an SM
    (2, 64, 8, 12, 64, 1),        # G = 12 at hd 64
])
def test_a_wide_call_reaches_the_extension_once(ext, Bq, C, Kv, G, hd,  # noqa: F811
                                               splits):
    z = lambda *s: torch.empty(s, dtype=torch.bfloat16)   # noqa: E731
    before = k8.launches
    k8._launch(z(Bq, Kv * G, hd), z(Bq, C, Kv, hd), z(Bq, C, Kv, hd), C)
    assert ext.calls == [("flash_decode", splits)]
    assert k8.launches == before + 1
