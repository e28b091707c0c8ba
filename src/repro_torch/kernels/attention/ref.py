"""Plain-PyTorch multi-head attention (GQA, causal, sliding window).

Counterpart of `repro/kernels/attention/ref.py` `mha_reference`: the
version the K7 kernel is held against, and the CPU path.
"""
from __future__ import annotations

import numpy as np
import torch


def mha_reference(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, kv_length=None, scale: float | None = None):
    """q: (B, Lq, H, hd); k, v: (B, Lk, Kv, hd) with H % Kv == 0.
    q_offset: absolute position of q[0] relative to k[0].
    kv_length: optional (B,) or scalar count of valid kv slots (from 0).
    window: query i attends keys j with i - window < j <= i.
    Returns (B, Lq, H, hd_v) in q.dtype; softmax in float32."""
    B, Lq, H, hd = q.shape
    _, Lk, Kv, _ = k.shape
    hd_v = v.shape[-1]
    assert H % Kv == 0
    G = H // Kv
    if scale is None:
        scale = 1.0 / np.sqrt(hd)
    dev = q.device

    qf = q.float().reshape(B, Lq, Kv, G, hd)
    s = torch.einsum("bqkgd,bjkd->bkgqj", qf, k.float()) * float(scale)

    qpos = torch.arange(Lq, device=dev) + q_offset
    jpos = torch.arange(Lk, device=dev)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=dev)
    if causal:
        mask &= jpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= jpos[None, :] > qpos[:, None] - window
    if kv_length is not None:
        kvl = torch.as_tensor(kv_length, device=dev)
        if kvl.ndim == 0:
            mask &= (jpos < kvl)[None, :]
        else:
            mask = mask[None] & (jpos[None, None, :] < kvl[:, None, None])
    if mask.ndim == 2:
        mask = mask[None]
    s = torch.where(mask[:, None, None], s, float("-inf"))
    # guard fully-masked rows (can happen with kv_length=0)
    smax = torch.amax(s, dim=-1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    p = torch.exp(s - smax)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp_min(denom, 1e-30)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
    return o.reshape(B, Lq, H, hd_v).to(q.dtype)
