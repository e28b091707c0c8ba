"""GQA attention: the full-sequence forward and the one-token decode
against a ring cache. Counterpart of the GQA part of
`repro/models/attention.py` (lines 25-121).

Cache layout (per layer): {"k": (B, C, Kv, hd), "v": (B, C, Kv, hd)},
C = cache capacity; the new token's slot is length % C. The port
writes the new token's K/V into the cache tensors in place (the
reference's dynamic_update_slice returns new buffers); a caller that
needs an older cache afterwards clones it first.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models.layers import Rng, apply_rope, as_dtype, dense_init


def _unported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported yet; it joins the port "
                              f"with the {slice_name} slice")


def gqa_init(rng: Rng, cfg, dtype, *, cross: bool = False):
    if cross:
        _unported("cross-attention", "encoder-decoder (seamless-m4t)")
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(rng, d, H * hd, dtype),
        "wk": dense_init(rng, d, Kv * hd, dtype),
        "wv": dense_init(rng, d, Kv * hd, dtype),
        "wo": dense_init(rng, H * hd, d, dtype),
    }
    if cfg.qkv_bias:
        dt = as_dtype(dtype)
        p["bq"] = torch.zeros((H * hd,), dtype=dt, device=rng.device)
        p["bk"] = torch.zeros((Kv * hd,), dtype=dt, device=rng.device)
        p["bv"] = torch.zeros((Kv * hd,), dtype=dt, device=rng.device)
    return p


def _qkv(params, cfg, x):
    B, L, _ = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (q.reshape(B, L, H, hd), k.reshape(B, L, Kv, hd),
            v.reshape(B, L, Kv, hd))


def _rope_qk(cfg, q, k, q_positions, k_positions):
    if cfg.mrope:
        _unported("M-RoPE", "qwen2-vl")
    return (apply_rope(q, q_positions, cfg.rope_theta),
            apply_rope(k, k_positions, cfg.rope_theta))


def gqa_forward(params, cfg, x, positions, *, causal: bool = True,
                window=None, return_kv: bool = False):
    """Training / prefill self-attention. x: (B, L, d)."""
    B, L, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    q, k = _rope_qk(cfg, q, k, positions, positions)
    o = attn_ops.flash_attention(q, k, v, causal=causal, window=window)
    y = o.reshape(B, L, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return (y, (k, v)) if return_kv else y


def gqa_init_cache(cfg, batch: int, capacity: int, dtype, device="cuda"):
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    dt = as_dtype(dtype)
    return {
        "k": torch.zeros((batch, capacity, Kv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, capacity, Kv, hd), dtype=dt, device=device),
    }


def gqa_decode(params, cfg, x, cache, length: int, *, window=None):
    """One-token decode. x: (B, 1, d); length: valid tokens in the cache.

    The new token's position is `length`; its K/V go into ring slot
    length % C (in place). Decode then attends over min(length + 1, C)
    slots through the flash-decode dispatcher (K8)."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q, k, v = _qkv(params, cfg, x)
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q, k = _rope_qk(cfg, q, k, pos, pos)
    slot = length % C
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    valid = min(length + 1, C)
    o = dec_ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)
    y = o[:, None].reshape(B, 1, cfg.num_heads * cfg.head_dim) @ params["wo"]
    return y, {"k": cache["k"], "v": cache["v"]}
