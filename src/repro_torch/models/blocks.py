"""Decoder blocks assembled from mixers (GQA or MLA attention, Mamba2)
and FFNs (none, MLP, MoE). Counterpart of `repro/models/blocks.py`
without cross-attention, which joins with the encoder-decoder
(seamless-m4t) slice.

A *layer spec* is (kind, ffn) with kind in {"attn", "mamba"} and ffn in
{"none", "mlp", "moe"}; the LM groups layers with identical specs into
stacked periods (see lm.py).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
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


def _mla(cfg) -> bool:
    return cfg.attention == "mla"


def block_init(rng: Rng, cfg, spec, dtype, *, cross: bool = False):
    kind, ffn = spec
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, rng.device)}
    if kind == "attn":
        p["mixer"] = (attn.mla_init(rng, cfg, dtype) if _mla(cfg)
                      else attn.gqa_init(rng, cfg, dtype))
    elif kind == "mamba":
        p["mixer"] = ssm.mamba_init(rng, cfg, dtype)
    else:
        raise ValueError(kind)
    if cross:
        attn._unported("cross-attention", "encoder-decoder (seamless-m4t)")
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, rng.device)
        p["ffn"] = (moe_mod.moe_init(rng, cfg, dtype) if ffn == "moe"
                    else mlp_init(rng, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                  dtype))
    return p


def _moe(params, cfg, h):
    """The MoE FFN. ``cfg.moe_impl == "ep"`` takes the reference's
    all-to-all path only on a mesh (`repro/models/blocks.py:82-91`);
    without one it runs `moe_apply`, as here: nothing in the port builds
    a mesh before the multi-device slice, which brings `ep_moe_apply`."""
    return moe_mod.moe_apply(params, cfg, h)


def _ffn(params, cfg, spec, x):
    """The residual FFN half of a block: (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec[1] == "none":
        return x, aux
    h = rmsnorm(params["norm2"], x, cfg.norm_eps)
    if spec[1] == "moe":
        y, aux = _moe(params["ffn"], cfg, h)
    else:
        y = mlp_apply(params["ffn"], h, cfg.mlp_act)
    return x + y, aux


def block_forward(params, cfg, spec, x, positions, *, causal: bool = True):
    """Full-sequence forward. Returns (y, aux_loss)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn":
        if _mla(cfg):
            y = attn.mla_forward(params["mixer"], cfg, h, positions,
                                 causal=causal)
        else:
            y = attn.gqa_forward(params["mixer"], cfg, h, positions,
                                 causal=causal, window=cfg.sliding_window)
    else:
        y = ssm.mamba_forward(params["mixer"], cfg, h)
    return _ffn(params, cfg, spec, x + y)


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


def _gqa_capacity(cfg, capacity: int) -> int:
    """A sliding window caps the GQA ring at the window
    (`repro/models/blocks.py:118-119,146`)."""
    return (min(capacity, cfg.sliding_window) if cfg.sliding_window
            else capacity)


def block_prefill(params, cfg, spec, x, positions, capacity: int):
    """Forward that also emits a decode-ready cache. Returns (y, aux, cache)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn" and _mla(cfg):
        y, (c, kpe) = attn.mla_forward(params["mixer"], cfg, h, positions,
                                       return_latents=True)
        cache = {"c": _ring_place(c, capacity),
                 "kpe": _ring_place(kpe, capacity)}
    elif spec[0] == "attn":
        cap = _gqa_capacity(cfg, capacity)
        y, (k, v) = attn.gqa_forward(params["mixer"], cfg, h, positions,
                                     window=cfg.sliding_window, return_kv=True)
        cache = {"k": _ring_place(k, cap), "v": _ring_place(v, cap)}
    else:
        y, cache = ssm.mamba_forward(params["mixer"], cfg, h,
                                     return_cache=True)
    x, aux = _ffn(params, cfg, spec, x + y)
    return x, aux, cache


def block_init_cache(cfg, spec, batch: int, capacity: int, dtype,
                     device="cuda"):
    if spec[0] == "mamba":
        return ssm.mamba_init_cache(cfg, batch, dtype, device)
    if _mla(cfg):
        return attn.mla_init_cache(cfg, batch, capacity, dtype, device)
    return attn.gqa_init_cache(cfg, batch, _gqa_capacity(cfg, capacity),
                               dtype, device)


def block_decode(params, cfg, spec, x, cache, length: int):
    """One-token decode. x: (B, 1, d). Returns (y, cache) — the cache's
    tensors (the KV or latent ring, or the conv window and SSM state)
    are updated in place."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn" and _mla(cfg):
        y, cache = attn.mla_decode(params["mixer"], cfg, h, cache, length)
    elif spec[0] == "attn":
        y, cache = attn.gqa_decode(params["mixer"], cfg, h, cache, length,
                                   window=cfg.sliding_window)
    else:
        y, cache = ssm.mamba_decode(params["mixer"], cfg, h, cache)
    x, _ = _ffn(params, cfg, spec, x + y)
    return x, cache
