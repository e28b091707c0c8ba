"""K8: flash-decode as CUDA kernels (`kernels/csrc/flash_decode.cu`).

Counterpart of `repro/kernels/decode_attention/flash_decode.py`
`flash_decode`: one-token attention of q (B, H, hd) over a
(B, C, Kv, hd) cache, slots with position >= kv_length[b] masked. A
block per (split of the cache axis, kv head, batch row) stages its
K and V tiles into shared memory before it computes, serves the G
query heads of its kv head, and reads no slot past the row's valid
length; with more than one split a second kernel merges the splits'
online-softmax partials. `num_splits` picks the split count: one at the
serving step's short cache, so one launch there. A Python-int
kv_length goes to the kernel as an argument, so a call launches no
fill. Any cache length C is accepted. bf16 runs on the tensor cores
(``flash_decode_mma_kernel`` at hd <= 64 and G <= 8, the serving path;
``flash_decode_wide_kernel`` for every other bf16 call), f32 on the
CUDA cores; `kernel_for` names the kernel a call takes.

The launch sits in an ``autograd.Function`` (no backward: decode runs
without a gradient) whose ``vmap`` rule folds the request axis of
`torch.func.vmap` into the batch axis (`kernels/_vmap.py`): the serving
engine's batch of R requests decodes with one launch a layer and step.
A Python-int kv_length stays an argument; a (B,) tensor becomes (R·B,),
repeated R times where it is not mapped. `splits_for` sees the folded
batch.

On a CPU tensor the wrapper runs the plain version (`ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _checks, _vmap
from repro_torch.kernels._build import get_ext
from repro_torch.kernels.decode_attention import ref

launches = 0   # kernel launches; only `_launch` adds to it

BLOCKS_PER_SM = 2           # K8 blocks resident on an SM (kBlocksPerSM)
MIN_KEYS_PER_SPLIT = 256    # below this a split's set-up outweighs its keys
MAX_SPLITS = 512            # the combine kernel's limit


def kernel_for(dtype, group: int, hd: int) -> str:
    """The ``__global__`` K8 launches for a call in `dtype` with G =
    `group` query heads a kv head at head dim `hd`, as the profiler names
    it (template arguments included): `launch_all` and `launch_g` in
    csrc/flash_decode.cu, line for line. bf16 runs on the tensor cores,
    f32 on the CUDA cores; a call with more than one split also launches
    ``flash_decode_combine_kernel``."""
    if dtype == torch.bfloat16:
        if hd <= 64 and group <= 8:
            return "flash_decode_mma_kernel"
        if hd <= 128:
            return "flash_decode_wide_kernel<128>"
        return "flash_decode_wide_kernel<192>"
    k_hd = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 192
    if group <= 2:
        k_g = 2
    elif group == 3:
        k_g = 3
    elif group == 4:
        k_g = 4
    elif group <= 8:
        k_g = 8
    else:
        k_g = 12
    return f"flash_decode_kernel<float, {k_hd}, {k_g}>"


def blocks_per_sm(group: int, hd: int, dtype=torch.bfloat16) -> int:
    """K8 blocks resident on an SM for the kernel `kernel_for` names: the
    minimum of its ``__launch_bounds__``, which its shared memory also
    allows. BLOCKS_PER_SM (kBlocksPerSM in csrc/flash_decode.cu: bf16's
    two tensor-core kernels), but one for the f32 kernels built for G
    above 8 or hd above 128, which take up to 255 registers a thread
    (`Shape::kMinBlocks`)."""
    if kernel_for(dtype, group, hd).startswith("flash_decode_kernel<"):
        return 1 if group > 8 or hd > 128 else BLOCKS_PER_SM
    return BLOCKS_PER_SM


def num_splits(batch: int, kv_heads: int, span: int, sms: int = 132,
               per_sm: int = BLOCKS_PER_SM) -> int:
    """Splits of the cache axis for K8: as many (split, kv head, batch
    row) blocks as `sms` SMs hold at once, `per_sm` each (one wave: a
    block more would run alone in a second), but at least
    MIN_KEYS_PER_SPLIT slots of `span` (`ref.cache_span`) a split."""
    want = sms * per_sm // max(batch * kv_heads, 1)
    return max(1, min(want, span // MIN_KEYS_PER_SPLIT, MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits_for(k_cache, kv_length, group: int = 1) -> int:
    """The split count K8 takes for a cache on the card, a kv_length (a
    Python int or a (B,) tensor) and G = `group` query heads a kv
    head."""
    B, C, Kv, hd = k_cache.shape
    return num_splits(B, Kv, ref.cache_span(kv_length, C),
                      _sm_count(k_cache.device),
                      blocks_per_sm(group, hd, k_cache.dtype))


class _FlashDecode(torch.autograd.Function):
    """Kernel launch; under `torch.func.vmap`, one launch over the folded
    batch. The output is not differentiable."""

    @staticmethod
    def forward(q, k_cache, v_cache, kv_length):
        return _launch(q, k_cache, v_cache, kv_length)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, q, k_cache, v_cache, kv_length):
        out = _vmap.fold(_FlashDecode.apply, info.batch_size,
                         (q, k_cache, v_cache, kv_length), in_dims)
        return out, 0


def flash_decode(q, k_cache, v_cache, kv_length):
    """q: (B, H, hd); caches: (B, C, Kv, hd); kv_length: a Python int for
    every row, or (B,) int. Returns (B, H, hd) in q's dtype."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_length)
    return _FlashDecode.apply(q, k_cache, v_cache, kv_length)


def _launch(q, k_cache, v_cache, kv_length):
    """Launch K8, or raise `_checks.Refused` (a ValueError) before the
    extension for a call its binding would refuse."""
    global launches
    B, H, hd = q.shape[0], q.shape[1], q.shape[-1]
    Kv = k_cache.shape[2]
    q = q.contiguous()
    out = torch.empty_like(q)
    if isinstance(kv_length, int):
        kvl, kvl_s = None, kv_length
    else:
        kvl = kv_length.to(device=q.device, dtype=torch.int32).contiguous()
        kvl_s = 0
    G = H // max(Kv, 1)
    splits = splits_for(k_cache, kv_length, G)
    scratch = torch.empty(B * Kv * splits * G * (hd + 2) if splits > 1 else 0,
                          dtype=torch.float32, device=q.device)
    _checks.flash_decode(q, k_cache, v_cache, kvl, kvl_s, out, scratch,
                         splits)
    get_ext().flash_decode(q, k_cache, v_cache, kvl, kvl_s, out, scratch,
                           splits, 1.0 / (hd ** 0.5))
    launches += 1
    return out
