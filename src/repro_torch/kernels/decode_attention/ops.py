"""Dispatcher for one-token decode attention.

impl: "cuda" (default; K8 for CUDA tensors, the plain version for CPU
tensors) or "torch" (the plain version everywhere), per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.decode_attention.flash_decode import flash_decode

_IMPLS = ("torch", "cuda")


def decode_attention(q, k_cache, v_cache, kv_length, *, impl: str = "cuda"):
    """q: (B, H, hd); caches: (B, C, Kv, hd); kv_length: int, () or (B,)."""
    assert impl in _IMPLS, impl
    B = q.shape[0]
    if isinstance(kv_length, int):
        # a fill kernel, not a host-to-device copy that would stall the host
        kvl = torch.full((B,), kv_length, dtype=torch.int32, device=q.device)
    else:
        kvl = torch.as_tensor(kv_length, dtype=torch.int32, device=q.device)
        kvl = kvl.expand(B) if kvl.ndim == 0 else kvl
    if impl == "torch":
        return ref.decode_attention_ref(q, k_cache, v_cache, kvl)
    return flash_decode(q, k_cache, v_cache, kvl)
