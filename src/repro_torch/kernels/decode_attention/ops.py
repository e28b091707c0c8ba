"""Dispatcher for one-token decode attention.

impl: "cuda" (default; K8 for CUDA tensors, the plain version for CPU
tensors) or "torch" (the plain version everywhere), per call or scoped
with `use_impl`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._impl import ImplSwitch
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.decode_attention.flash_decode import flash_decode
from repro_torch.sharding.dtensor import is_dtensor, kernel_axes, local_call
from repro_torch.sharding.rules import P

_IMPL = ImplSwitch()
set_default_impl, get_default_impl, use_impl = (
    _IMPL.set, _IMPL.get, _IMPL.use)


def decode_attention(q, k_cache, v_cache, kv_length, *,
                     impl: str | None = None):
    """q: (B, H, hd); caches: (B, C, Kv, hd); kv_length: int, () or (B,).

    DTensor operands (a step on a mesh) enter through `local_map`, the
    batch over pod+data and the heads over model where they split
    evenly: each rank runs this function on its own shards."""
    impl = _IMPL.resolve(impl)
    B = q.shape[0]
    if is_dtensor(q) or is_dtensor(k_cache):
        t = q if is_dtensor(q) else k_cache
        b, h = kernel_axes(t, B, q.shape[1],
                           group=q.shape[1] // k_cache.shape[2])
        qs, cs = P(b, h, None), P(b, None, h, None)
        if isinstance(kv_length, int):
            return local_call(
                lambda q_, k_, v_: decode_attention(q_, k_, v_, kv_length,
                                                    impl=impl),
                (q, k_cache, v_cache), (qs, cs, cs), qs)
        kvl = torch.as_tensor(kv_length, dtype=torch.int32,
                              device=q.device)
        kvl = kvl.expand(B).contiguous() if kvl.ndim == 0 else kvl
        return local_call(
            lambda q_, k_, v_, l_: decode_attention(q_, k_, v_, l_,
                                                    impl=impl),
            (q, k_cache, v_cache, kvl), (qs, cs, cs, P(b)), qs)
    if isinstance(kv_length, int):
        if impl == "cuda":
            # K8 takes it as a kernel argument: no fill launch
            return flash_decode(q, k_cache, v_cache, kv_length)
        # a fill kernel, not a host-to-device copy that would stall the host
        kvl = torch.full((B,), kv_length, dtype=torch.int32, device=q.device)
    else:
        kvl = torch.as_tensor(kv_length, dtype=torch.int32, device=q.device)
        kvl = kvl.expand(B) if kvl.ndim == 0 else kvl
    if impl == "torch":
        return ref.decode_attention_ref(q, k_cache, v_cache, kvl)
    return flash_decode(q, k_cache, v_cache, kvl)
