"""Plain-PyTorch one-token decode attention over a KV cache.

Counterpart of `repro/kernels/decode_attention/ref.py`: the version the
K8 kernel is held against, and the CPU path.
"""
from __future__ import annotations

import numpy as np
import torch


def decode_attention_ref(q, k_cache, v_cache, kv_length):
    """q: (B, H, hd); k_cache/v_cache: (B, C, Kv, hd); kv_length: () or
    (B,) valid cache slots. Returns (B, H, hd); softmax in f32."""
    B, H, hd = q.shape
    _, C, Kv, _ = k_cache.shape
    G = H // Kv
    qf = q.float().reshape(B, Kv, G, hd)
    s = torch.einsum("bkgd,bjkd->bkgj", qf, k_cache.float()) / float(
        np.sqrt(hd))
    kvl = torch.as_tensor(kv_length, device=q.device)
    pos = torch.arange(C, device=q.device)
    mask = pos[None, :] < (kvl[:, None] if kvl.ndim else kvl)
    if mask.ndim == 1:
        mask = mask[None]
    s = torch.where(mask[:, None, None, :], s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return o.reshape(B, H, hd).to(q.dtype)
