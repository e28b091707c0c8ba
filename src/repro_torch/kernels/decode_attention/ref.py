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


def cache_span(kv_length, C: int) -> int:
    """The slots K8's splits divide: a Python int kv_length > 0 gives its
    valid slots (at most C); a tensor, or 0 (a row whose answer is the
    mean of V over every slot), gives the whole cache."""
    if isinstance(kv_length, int) and kv_length > 0:
        return min(kv_length, C)
    return C


def decode_attention_split_plain(q, k_cache, v_cache, kv_length, splits,
                                 tile: int = 64, warps: int = 1,
                                 p_terms: bool = False):
    """Plain model of K8's arithmetic, for tests: the cache axis cut into
    `splits` ranges of ceil(span / splits) slots (`cache_span`), each
    range read in tiles of `tile` slots up to the row's valid length.
    Each of `warps` key slices of a tile (tile / warps consecutive slots,
    a warp's share in ``flash_decode_wide_kernel``) keeps its own online
    softmax (m, l, acc) in log2 units over its slots of every tile; a
    state that saw no valid slot keeps m = -1e30, l = 0. With `p_terms`
    the weights enter P·V as the sum of two bf16 terms, hi = bf16(p) and
    lo = bf16(p - hi), as the tensor-core kernels carry them. The warps'
    states merge at the end of a range, then the ranges, each with
    weights exp2(m - max m). A row with kv_length 0 scores every slot at
    -1e30, so it gives the mean of V, as the reference kernel does.
    Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    G = H // Kv
    per = -(-cache_span(kv_length, C) // splits)
    step = tile // warps
    lens = torch.as_tensor(kv_length).expand(B)
    scale2 = 1.0 / (float(np.sqrt(hd)) * float(np.log(2.0)))
    qf = q.float().reshape(B, Kv, G, hd)
    kf, vf = k_cache.float(), v_cache.float()
    out = torch.empty((B, Kv, G, hd), dtype=torch.float32)

    def pv(p, vt):
        if not p_terms:
            return torch.einsum("kgn,knd->kgd", p, vt)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        return (torch.einsum("kgn,knd->kgd", lo, vt)
                + torch.einsum("kgn,knd->kgd", hi, vt))

    def merge(ms, ls, accs):
        m_all = torch.stack(ms)                             # (S, Kv, G)
        w = torch.exp2(m_all - m_all.amax(0))
        return (m_all.amax(0), (w * torch.stack(ls)).sum(0),
                (w[..., None] * torch.stack(accs)).sum(0))

    for b in range(B):
        length = int(lens[b])
        empty = length <= 0
        span = C if empty else min(length, C)
        ms, ls, accs = [], [], []
        for s in range(splits):
            hi_s = min((s + 1) * per, span)
            wm, wl, wacc = [], [], []
            for w in range(warps):
                m = torch.full((Kv, G), -1e30)
                l = torch.zeros((Kv, G))
                acc = torch.zeros((Kv, G, hd))
                for t0 in range(s * per, hi_s, tile):
                    j0 = t0 + w * step
                    j1 = min(j0 + step, hi_s)
                    if j0 >= j1:
                        continue
                    kt = kf[b, j0:j1].transpose(0, 1)      # (Kv, n, hd)
                    vt = vf[b, j0:j1].transpose(0, 1)
                    sc = torch.einsum("kgd,knd->kgn", qf[b], kt) * scale2
                    if empty:
                        sc = torch.full_like(sc, -1e30)
                    m_new = torch.maximum(m, sc.amax(-1))
                    a = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    l = a * l + p.sum(-1)
                    acc = a[..., None] * acc + pv(p, vt)
                    m = m_new
                wm.append(m)
                wl.append(l)
                wacc.append(acc)
            m, l, acc = merge(wm, wl, wacc)
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        _, l_tot, acc_tot = merge(ms, ls, accs)
        out[b] = acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)
