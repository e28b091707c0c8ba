"""Decoder and encoder blocks assembled from mixers (GQA or MLA
attention, Mamba2), the encoder-decoder's cross-attention and FFNs
(none, MLP, MoE). Counterpart of `repro/models/blocks.py`.

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
from repro_torch.sharding.dtensor import batch_layout


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
        p["norm_cross"] = rmsnorm_init(cfg.d_model, dtype, rng.device)
        p["cross"] = attn.gqa_init(rng, cfg, dtype, cross=True)
    if ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, rng.device)
        p["ffn"] = (moe_mod.moe_init(rng, cfg, dtype) if ffn == "moe"
                    else mlp_init(rng, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                  dtype))
    return p


def _moe(params, cfg, h):
    """The MoE FFN (`repro/models/blocks.py:82-91`): with
    ``cfg.moe_impl == "ep"`` and an ambient mesh, the expert-parallel
    all-to-all layer (`sharding/ep_moe.py`, no aux loss); else the
    tensor-parallel `moe_apply`."""
    if cfg.moe_impl == "ep":
        from repro_torch.sharding.context import get_mesh
        mesh = get_mesh()
        if mesh is not None:
            from repro_torch.sharding.ep_moe import ep_moe_apply
            return (ep_moe_apply(params, cfg, h, mesh),
                    torch.zeros((), dtype=torch.float32, device=h.device))
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
    return batch_layout(x + y), aux


def _cross(params, cfg, x, enc_out):
    """The residual cross-attention half of an encoder-decoder block
    (a block without ``cross`` passes x through)."""
    if "cross" not in params:
        return x
    h = rmsnorm(params["norm_cross"], x, cfg.norm_eps)
    return batch_layout(x + attn.cross_attn_forward(params["cross"], cfg, h,
                                                    enc_out))


def block_forward(params, cfg, spec, x, positions, *, causal: bool = True,
                  enc_out=None):
    """Full-sequence forward. Returns (y, aux_loss). On a mesh x enters
    in the batch layout: a sequence-sharded residual (``shard_seq``) is
    gathered here, before the block's attention."""
    x = batch_layout(x)
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
    return _ffn(params, cfg, spec, _cross(params, cfg, batch_layout(x + y),
                                          enc_out))


def _ring_place(full, capacity: int):
    """Place the last min(L, capacity) of (B, L, ...) into a (B, capacity,
    ...) ring buffer at slots (j % capacity) — decode-coherent. Built as
    a rotation of [kept tokens | zeros], ops DTensor has rules for."""
    B, L = full.shape[:2]
    m = min(L, capacity)
    base = L - m
    buf = full[:, base:]
    if m < capacity:
        buf = torch.cat([buf, torch.zeros(
            (B, capacity - m) + tuple(full.shape[2:]), dtype=full.dtype,
            device=full.device)], dim=1)
    shift = base % capacity
    return torch.roll(buf, shifts=shift, dims=1) if shift else buf


def _gqa_capacity(cfg, capacity: int) -> int:
    """A sliding window caps the GQA ring at the window
    (`repro/models/blocks.py:118-119,146`)."""
    return (min(capacity, cfg.sliding_window) if cfg.sliding_window
            else capacity)


def block_prefill(params, cfg, spec, x, positions, capacity: int, *,
                  enc_out=None):
    """Forward that also emits a decode-ready cache. Returns (y, aux, cache)."""
    x = batch_layout(x)
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
    x, aux = _ffn(params, cfg, spec,
                  _cross(params, cfg, batch_layout(x + y), enc_out))
    return x, aux, cache


def block_init_cache(cfg, spec, batch: int, capacity: int, dtype,
                     device="cuda"):
    if spec[0] == "mamba":
        return ssm.mamba_init_cache(cfg, batch, dtype, device)
    if _mla(cfg):
        return attn.mla_init_cache(cfg, batch, capacity, dtype, device)
    return attn.gqa_init_cache(cfg, batch, _gqa_capacity(cfg, capacity),
                               dtype, device)


def block_decode(params, cfg, spec, x, cache, length: int, *, enc_out=None):
    """One-token decode. x: (B, 1, d). Returns (y, cache) — the cache's
    tensors (the KV or latent ring, or the conv window and SSM state)
    are updated in place. Cross-attention recomputes K and V from
    ``enc_out`` at every step, as the reference does."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if spec[0] == "attn" and _mla(cfg):
        y, cache = attn.mla_decode(params["mixer"], cfg, h, cache, length)
    elif spec[0] == "attn":
        y, cache = attn.gqa_decode(params["mixer"], cfg, h, cache, length,
                                   window=cfg.sliding_window)
    else:
        y, cache = ssm.mamba_decode(params["mixer"], cfg, h, cache)
    x, _ = _ffn(params, cfg, spec,
                _cross(params, cfg, batch_layout(x + y), enc_out))
    return x, cache
