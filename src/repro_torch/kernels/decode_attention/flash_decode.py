"""K8: flash-decode as a CUDA kernel (`kernels/csrc/flash_decode.cu`).

Counterpart of `repro/kernels/decode_attention/flash_decode.py`
`flash_decode`: one-token attention of q (B, H, hd) over a
(B, C, Kv, hd) cache, slots with position >= kv_length[b] masked. One
block per (kv head, batch row) holds that kv head's G query rows and
streams the cache once, bf16 in and f32 math. Any cache length C is
accepted.

On a CPU tensor the wrapper runs the plain version (`ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.decode_attention import ref

launches = 0   # kernel launches; only this wrapper adds to it


def flash_decode(q, k_cache, v_cache, kv_length):
    """q: (B, H, hd); caches: (B, C, Kv, hd); kv_length: (B,) int.
    Returns (B, H, hd) in q's dtype."""
    global launches
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_length)
    q = q.contiguous()
    out = torch.empty_like(q)
    kvl = kv_length.to(device=q.device, dtype=torch.int32).contiguous()
    get_ext().flash_decode(q, k_cache, v_cache, kvl, out,
                           1.0 / (q.shape[-1] ** 0.5))
    launches += 1
    return out
