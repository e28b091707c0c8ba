"""Decoder blocks. Counterpart of `repro/models/blocks.py` for the dense
("attn", "mlp") spec — the one SmolLM-360M runs. MoE, SSM, MLA and
cross-attention blocks raise until their slices land.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import Rng, mlp_apply, mlp_init, rmsnorm, rmsnorm_init


def layer_spec(cfg, i: int):
    kind = cfg.layer_pattern[i % len(cfg.layer_pattern)]
    if cfg.d_ff == 0:
        ffn = "none"
    elif cfg.num_experts > 0 and cfg.is_moe_layer(i):
        ffn = "moe"
    else:
        ffn = "mlp"
    return (kind, ffn)


def _check(cfg, spec):
    kind, ffn = spec
    if kind != "attn":
        attn._unported(f"the {kind!r} mixer", "mamba2 / jamba")
    if ffn == "moe":
        attn._unported("MoE", "mixtral / deepseek-v2")
    if cfg.attention != "gqa":
        attn._unported(f"{cfg.attention!r} attention", "deepseek-v2")


def block_init(rng: Rng, cfg, spec, dtype, *, cross: bool = False):
    _check(cfg, spec)
    _, ffn = spec
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, rng.device),
         "mixer": attn.gqa_init(rng, cfg, dtype, cross=False)}
    if cross:
        attn._unported("cross-attention", "encoder-decoder (seamless-m4t)")
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, rng.device)
        p["ffn"] = mlp_init(rng, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
    return p


def _ffn(params, cfg, spec, x):
    if spec[1] == "none":
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(params["ffn"], h, cfg.mlp_act)


def block_forward(params, cfg, spec, x, positions, *, causal: bool = True):
    """Full-sequence forward. Returns (y, aux_loss)."""
    _check(cfg, spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    x = x + attn.gqa_forward(params["mixer"], cfg, h, positions,
                             causal=causal, window=cfg.sliding_window)
    return _ffn(params, cfg, spec, x), aux


def _ring_place(full, capacity: int):
    """Place the last min(L, capacity) of (B, L, ...) into a (B, capacity,
    ...) ring buffer at slots (j % capacity) — decode-coherent."""
    B, L = full.shape[:2]
    m = min(L, capacity)
    base = L - m
    slots = (base + torch.arange(m, device=full.device)) % capacity
    buf = torch.zeros((B, capacity) + tuple(full.shape[2:]), dtype=full.dtype,
                      device=full.device)
    buf[:, slots] = full[:, base:]
    return buf


def block_prefill(params, cfg, spec, x, positions, capacity: int):
    """Forward that also emits a decode-ready cache. Returns (y, aux, cache)."""
    _check(cfg, spec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    cap = (min(capacity, cfg.sliding_window) if cfg.sliding_window
           else capacity)
    y, (k, v) = attn.gqa_forward(params["mixer"], cfg, h, positions,
                                 window=cfg.sliding_window, return_kv=True)
    cache = {"k": _ring_place(k, cap), "v": _ring_place(v, cap)}
    x = x + y
    return _ffn(params, cfg, spec, x), aux, cache


def block_init_cache(cfg, spec, batch: int, capacity: int, dtype,
                     device="cuda"):
    _check(cfg, spec)
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity
    return attn.gqa_init_cache(cfg, batch, cap, dtype, device)


def block_decode(params, cfg, spec, x, cache, length: int):
    """One-token decode. x: (B, 1, d). Returns (y, cache) — the cache's
    tensors are updated in place."""
    _check(cfg, spec)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    y, cache = attn.gqa_decode(params["mixer"], cfg, h, cache, length,
                               window=cfg.sliding_window)
    x = x + y
    return _ffn(params, cfg, spec, x), cache
