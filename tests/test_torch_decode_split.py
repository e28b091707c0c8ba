"""K8's split arithmetic against the reference's flash-decode kernel.

K8 on the card cuts the cache axis into splits, reads each split's
valid slots in tiles with its own online softmax in log2 units, and
merges the splits' (m, l, acc) partials. `decode_attention_split_plain`
models that arithmetic in plain PyTorch; here it is held against the
reference's Pallas kernel (`flash_decode(..., interpret=True)`) on
seeded numpy inputs, for several split counts, ragged lengths, a row
with kv_length 0 and G in {1, 3, 8}. Tolerance: `ATT` of
`test_torch_kernels.py` (2e-5, the reference's own kernel-vs-oracle
tolerance): both sides sum in f32 in different orders.

Also: the split count (one split at the serving step, several on a
long cache), the slots a split divides, and a Python-int kv_length on
the CPU against the (B,) tensor.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.flash_decode import flash_decode as jax_decode
from repro_torch.kernels.decode_attention import flash_decode as k8
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref

ATT = dict(rtol=2e-5, atol=2e-5)
B, CC, KV, HD = 4, 96, 2, 16


@functools.lru_cache(maxsize=None)
def _case(G, lengths):
    """Seeded inputs and the Pallas (interpret) result; `lengths` is a
    tuple of B valid slot counts (0: the mean of V)."""
    rng = np.random.RandomState(17 + G)
    q = rng.randn(B, KV * G, HD).astype(np.float32)
    kc = rng.randn(B, CC, KV, HD).astype(np.float32)
    vc = rng.randn(B, CC, KV, HD).astype(np.float32)
    kvl = np.asarray(lengths, np.int32)
    expect = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(kvl), block_k=32, interpret=True)
    return q, kc, vc, kvl, np.asarray(expect)


RAGGED = (1, 37, 96, 64)
ZERO_ROW = (0, 50, 96, 7)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_model_matches_pallas_ragged(splits, G):
    q, kc, vc, kvl, expect = _case(G, RAGGED)
    got = ref.decode_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kvl), splits, tile=16)
    np.testing.assert_allclose(got.numpy(), expect, **ATT)


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_model_zero_row_is_the_mean_of_v(splits):
    """A row with kv_length 0: the Pallas kernel scores every slot at
    -1e30, so its softmax is uniform and it returns the mean of V over
    all C slots; the split model (and K8) keep that answer, through the
    combine when there are several splits. The jnp oracle and the
    port's plain version give NaN there."""
    G = 3
    q, kc, vc, kvl, expect = _case(G, ZERO_ROW)
    mean_v = np.repeat(vc[0].mean(0), G, axis=0)
    np.testing.assert_allclose(expect[0], mean_v, **ATT)
    got = ref.decode_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(kvl), splits, tile=16)
    np.testing.assert_allclose(got.numpy(), expect, **ATT)
    plain = ref.decode_attention_ref(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), torch.from_numpy(kvl))
    assert torch.isnan(plain[0]).all() and torch.isfinite(plain[1:]).all()


@pytest.mark.parametrize("splits", [1, 2, 7])
def test_split_model_with_an_int_length_divides_only_the_valid_slots(splits):
    """A Python-int kv_length divides its valid slots among the splits
    (`cache_span`), a tensor the whole cache: the same answer."""
    G = 3
    q, kc, vc, _, _ = _case(G, RAGGED)
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    as_int = ref.decode_attention_split_plain(*args, 40, splits, tile=16)
    as_tensor = ref.decode_attention_split_plain(
        *args, torch.full((B,), 40, dtype=torch.int32), splits, tile=16)
    expect = ref.decode_attention_ref(*args, torch.full((B,), 40))
    np.testing.assert_allclose(as_int.numpy(), as_tensor.numpy(), **ATT)
    np.testing.assert_allclose(as_int.numpy(), expect.numpy(), **ATT)


def test_cache_span():
    assert ref.cache_span(40, 96) == 40
    assert ref.cache_span(500, 96) == 96
    assert ref.cache_span(0, 96) == 96           # the mean of V: every slot
    assert ref.cache_span(torch.tensor([3, 5]), 96) == 96


def test_num_splits_one_at_the_serving_step_several_on_a_long_cache():
    # SmolLM-360M's decode step: B = 1, C = 64, Kv = 5 — one block per
    # kv head, one launch
    assert k8.num_splits(1, 5, 64) == 1
    assert k8.num_splits(16, 5, 100) == 1
    long = k8.num_splits(1, 5, 32768)
    assert long > 1
    # enough blocks to fill the card, each split a few hundred slots
    assert long * 5 >= 132
    assert 32768 / long >= k8.MIN_KEYS_PER_SPLIT
    assert k8.num_splits(16, 5, 4096) > 1
    assert k8.num_splits(1, 1, 10 ** 9) <= k8.MAX_SPLITS


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_int_kv_length_on_the_cpu_matches_the_tensor(impl):
    q, kc, vc, _, _ = _case(3, RAGGED)
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    as_int = dec_ops.decode_attention(*args, 53, impl=impl)
    as_tensor = dec_ops.decode_attention(
        *args, torch.full((B,), 53, dtype=torch.int32), impl=impl)
    assert torch.equal(as_int, as_tensor)
    expect = jax_decode(*(jnp.asarray(a) for a in (q, kc, vc)),
                        jnp.full((B,), 53, jnp.int32), block_k=32,
                        interpret=True)
    np.testing.assert_allclose(as_int.numpy(), np.asarray(expect), **ATT)
