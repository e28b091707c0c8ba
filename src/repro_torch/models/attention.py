"""Attention modules: GQA (optional bias and sliding window) and MLA
(DeepSeek-V2's latent attention with a compressed KV cache), each with
its full-sequence forward and its one-token decode. Counterpart of
`repro/models/attention.py` without M-RoPE and cross-attention, which
join with the qwen2-vl and seamless-m4t slices.

Cache layouts (per layer), C = cache capacity, the new token's slot
length % C:
  GQA:  {"k": (B, C, Kv, hd), "v": (B, C, Kv, hd)} (a ring of the
        window's size under sliding-window attention)
  MLA:  {"c": (B, C, kv_lora_rank), "kpe": (B, C, rope_head_dim)}
The port writes the new token's entries into the cache tensors in
place (the reference's dynamic_update_slice returns new buffers); a
caller that needs an older cache afterwards clones it first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models.layers import (Rng, apply_rope, as_dtype, dense_init,
                                       rmsnorm, rmsnorm_init)


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


# ================================================================= MLA

def mla_init(rng: Rng, cfg, dtype):
    """DeepSeek-V2 MLA (`repro/models/attention.py:126-143`): q through a
    LoRA with its own RMSNorm (or one projection without q_lora_rank),
    K/V compressed to a kv_lora_rank latent plus a shared rope key."""
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, R = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    dev = rng.device
    p = {}
    if cfg.q_lora_rank > 0:
        p["w_dq"] = dense_init(rng, d, cfg.q_lora_rank, dtype)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, dev)
        p["w_uq"] = dense_init(rng, cfg.q_lora_rank, H * (nope + rope_d),
                               dtype)
    else:
        p["wq"] = dense_init(rng, d, H * (nope + rope_d), dtype)
    p["w_dkv"] = dense_init(rng, d, R, dtype)
    p["kv_norm"] = rmsnorm_init(R, dtype, dev)
    p["w_kpe"] = dense_init(rng, d, rope_d, dtype)
    p["w_uk"] = dense_init(rng, R, H * nope, dtype)
    p["w_uv"] = dense_init(rng, R, H * nope, dtype)
    p["wo"] = dense_init(rng, H * nope, d, dtype)
    return p


def _mla_q(params, cfg, x):
    """-> (q_nope, q_pe): (B, L, H, head_dim), (B, L, H, rope_head_dim).
    The q-LoRA's norm takes RMSNorm's default eps, as the reference's."""
    B, L, _ = x.shape
    H, nope, rope_d = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank > 0:
        q = rmsnorm(params["q_norm"], x @ params["w_dq"]) @ params["w_uq"]
    else:
        q = x @ params["wq"]
    q = q.reshape(B, L, H, nope + rope_d)
    return q[..., :nope], q[..., nope:]


def _mla_latents(params, cfg, x, positions):
    c = rmsnorm(params["kv_norm"], x @ params["w_dkv"])      # (B, L, R)
    kpe = x @ params["w_kpe"]                                # (B, L, rope_d)
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c, kpe


def mla_forward(params, cfg, x, positions, *, causal: bool = True,
                return_latents: bool = False):
    """Training / prefill MLA: per-head K and V materialized from the
    latents, attention through K7 at qk dim head_dim + rope_head_dim
    (scale 1/√ of it) and value dim head_dim."""
    B, L, _ = x.shape
    H, nope, rope_d = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    q_nope, q_pe = _mla_q(params, cfg, x)
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    c, kpe = _mla_latents(params, cfg, x, positions)
    k_nope = (c @ params["w_uk"]).reshape(B, L, H, nope)
    v = (c @ params["w_uv"]).reshape(B, L, H, nope)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, L, H, rope_d)],
                  dim=-1)
    o = attn_ops.flash_attention(q, k, v, causal=causal)
    y = o.reshape(B, L, H * nope) @ params["wo"]
    return (y, (c, kpe)) if return_latents else y


def mla_init_cache(cfg, batch: int, capacity: int, dtype, device="cuda"):
    dt = as_dtype(dtype)
    return {
        "c": torch.zeros((batch, capacity, cfg.kv_lora_rank), dtype=dt,
                         device=device),
        "kpe": torch.zeros((batch, capacity, cfg.rope_head_dim), dtype=dt,
                           device=device),
    }


def mla_decode(params, cfg, x, cache, length: int):
    """Absorbed one-token MLA decode (`repro/models/attention.py:
    190-226`): attention runs over the latent cache without per-head K/V
    — scores (W_ukᵀ q_nope)·c + q_pe·kpe over √(head_dim + rope_head_dim),
    the output W_uvᵀ (p·c) — in float32 with plain einsums and a −inf
    mask past the valid slots, as the reference; no kernel. The new
    token's latents go into ring slot length % C in place."""
    B = x.shape[0]
    H, nope, rope_d, R = (cfg.num_heads, cfg.head_dim, cfg.rope_head_dim,
                          cfg.kv_lora_rank)
    C = cache["c"].shape[1]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _mla_q(params, cfg, x)                   # (B, 1, H, ·)
    q_pe = apply_rope(q_pe, pos, cfg.rope_theta)
    c_new, kpe_new = _mla_latents(params, cfg, x, pos)
    slot = length % C
    cache["c"][:, slot] = c_new[:, 0].to(cache["c"].dtype)
    cache["kpe"][:, slot] = kpe_new[:, 0].to(cache["kpe"].dtype)
    c, kpe = cache["c"], cache["kpe"]
    valid = min(length + 1, C)
    w_uk = params["w_uk"].reshape(R, H, nope)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())
    c32 = c.float()
    s = torch.einsum("bhr,bjr->bhj", q_lat, c32)
    s = s + torch.einsum("bhd,bjd->bhj", q_pe[:, 0].float(), kpe.float())
    s = s / float(np.sqrt(nope + rope_d))
    mask = torch.arange(C, device=x.device)[None, None, :] < valid
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhj,bjr->bhr", p, c32)                # (B, H, R)
    w_uv = params["w_uv"].reshape(R, H, nope)
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv.float())
    y = o.reshape(B, 1, H * nope).to(x.dtype) @ params["wo"]
    return y, {"c": c, "kpe": kpe}
