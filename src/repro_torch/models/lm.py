"""Causal LM assembly: embeddings -> layer stack -> final norm -> logits.
Counterpart of `repro/models/lm.py` for dense decoder-only archs.

The parameter tree is the reference's: the repeating layer period is
stored stacked, ``stack/pos{j}`` leaves with a leading ``n_reps`` axis,
so a JAX φ loads with no remapping. The reference's ``lax.scan`` over
repetitions is a Python loop here. Modality prefixes and the encoder
raise until their slices land.

Entry points:
  init_lm            parameter init
  lm_apply           training / prefill forward (optionally emits cache)
  init_decode_cache  decode cache
  lm_decode_step     one-token decode against the cache (in place)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _unported
from repro_torch.models.blocks import (block_decode, block_forward, block_init,
                                       block_init_cache, block_prefill,
                                       layer_spec)
from repro_torch.models.layers import (Rng, as_dtype, dense_init, embed_init,
                                       rmsnorm, rmsnorm_init)
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten


# ---------------------------------------------------------------- grouping

def layer_groups(cfg):
    """-> (lead_specs, period_specs, n_reps): lead layers stand alone,
    the rest is a stack of `n_reps` repetitions of the period."""
    specs = [layer_spec(cfg, i) for i in range(cfg.num_layers)]
    lead = specs[:cfg.first_k_dense]
    rest = specs[cfg.first_k_dense:]
    P = len(cfg.layer_pattern)
    if cfg.num_experts > 0:
        P = math.lcm(P, cfg.moe_layer_period)
    assert len(rest) % P == 0, (cfg.name, len(rest), P)
    for i, s in enumerate(rest):
        assert s == rest[i % P], f"{cfg.name}: aperiodic layer stack"
    return lead, rest[:P], len(rest) // P


def _check_text_only(cfg):
    if cfg.is_encoder_decoder:
        _unported("the encoder-decoder path", "seamless-m4t")
    if cfg.modality is not None:
        _unported(f"the {cfg.modality} modality prefix", "qwen2-vl")


def _reps(stack, n_reps):
    """Per-repetition views of stacked leaves, through one ``unbind`` per
    leaf: its backward is one stack, where indexing each repetition would
    build a zero-padded full-size gradient per repetition."""
    leaves, treedef = tree_flatten(stack)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[r] for p in parts])
            for r in range(n_reps)]


# ---------------------------------------------------------------- init

def init_lm(key, cfg, *, device="cuda"):
    """Parameters from an int seed (or an `Rng`), on `device`."""
    _check_text_only(cfg)
    rng = key if isinstance(key, Rng) else Rng(key, device)
    dtype = as_dtype(cfg.dtype)
    d, vocab = cfg.d_model, cfg.vocab_size
    params = {"embed": embed_init(rng, vocab, d, dtype)}
    lead, period, n_reps = layer_groups(cfg)
    for i, spec in enumerate(lead):
        params[f"lead_{i}"] = block_init(rng, cfg, spec, dtype)
    stack = {}
    for j, spec in enumerate(period):
        reps = [block_init(rng, cfg, spec, dtype) for _ in range(n_reps)]
        stack[f"pos{j}"] = tree_map(lambda *xs: torch.stack(xs), *reps)
        del reps
    params["stack"] = stack
    params["final_norm"] = rmsnorm_init(d, dtype, rng.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(rng, d, vocab, dtype)
    return params


# ---------------------------------------------------------------- forward

def _logits(params, cfg, x):
    head = (params["embed"].t() if cfg.tie_embeddings else params["lm_head"])
    return (x @ head).float()


def lm_apply(params, cfg, tokens, *, collect_cache: bool = False,
             cache_capacity: int | None = None, logits_mode: str = "all"):
    """Training / prefill forward. tokens: (B, L) int.

    Returns (logits, aux_loss[, cache]). The reference's `remat` and
    `unroll_layers` have no counterpart: eager PyTorch keeps every
    activation and always runs the layers as a loop."""
    _check_text_only(cfg)
    B, L = tokens.shape
    lead, period, n_reps = layer_groups(cfg)
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(L, dtype=torch.int32,
                             device=tokens.device).expand(B, L)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    capacity = cache_capacity or L

    caches = {}
    for i, spec in enumerate(lead):
        if collect_cache:
            x, a, caches[f"lead_{i}"] = block_prefill(
                params[f"lead_{i}"], cfg, spec, x, positions, capacity)
        else:
            x, a = block_forward(params[f"lead_{i}"], cfg, spec, x, positions)
        aux = aux + a

    outs = []
    for rep in _reps(params["stack"], n_reps):
        rep_caches = {}
        for j, spec in enumerate(period):
            if collect_cache:
                x, a, rep_caches[f"pos{j}"] = block_prefill(
                    rep[f"pos{j}"], cfg, spec, x, positions, capacity)
            else:
                x, a = block_forward(rep[f"pos{j}"], cfg, spec, x, positions)
            aux = aux + a
        outs.append(rep_caches)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]          # serving prefill: next-token logits only
    logits = _logits(params, cfg, x)
    if collect_cache:
        caches["stack"] = tree_map(lambda *xs: torch.stack(xs), *outs)
        caches["length"] = L
        return logits, aux, caches
    return logits, aux


# ---------------------------------------------------------------- decode

def init_decode_cache(cfg, batch: int, capacity: int, dtype=None, *,
                      full: bool = True, device="cuda"):
    """Decode cache sized for `capacity` cached tokens. With full=True
    the cache is marked as already holding `capacity` tokens
    (steady-state decode). The stacked buffers are real (decode writes
    them in place), where the reference broadcasts one zero buffer."""
    _check_text_only(cfg)
    dtype = as_dtype(dtype or cfg.dtype)
    lead, period, n_reps = layer_groups(cfg)
    caches = {}
    for i, spec in enumerate(lead):
        caches[f"lead_{i}"] = block_init_cache(cfg, spec, batch, capacity,
                                               dtype, device)
    stack = {}
    for j, spec in enumerate(period):
        one = block_init_cache(cfg, spec, batch, capacity, dtype, device)
        stack[f"pos{j}"] = tree_map(
            lambda x: torch.zeros((n_reps,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), one)
    caches["stack"] = stack
    caches["length"] = capacity if full else 0
    return caches


def lm_decode_step(params, cfg, tokens, cache):
    """One-token decode. tokens: (B, 1) int. Returns (logits, cache): the
    cache's tensors are updated in place and the returned dict holds
    them with ``length`` advanced by one."""
    _check_text_only(cfg)
    lead, period, n_reps = layer_groups(cfg)
    x = F.embedding(tokens, params["embed"])
    length = int(cache["length"])
    new_cache = {"length": length + 1}
    for i, spec in enumerate(lead):
        x, new_cache[f"lead_{i}"] = block_decode(
            params[f"lead_{i}"], cfg, spec, x, cache[f"lead_{i}"], length)
    rep_params = _reps(params["stack"], n_reps)
    rep_caches = _reps(cache["stack"], n_reps)
    for rep, rc in zip(rep_params, rep_caches):
        for j, spec in enumerate(period):
            x, _ = block_decode(rep[f"pos{j}"], cfg, spec, x, rc[f"pos{j}"],
                                length)
    new_cache["stack"] = cache["stack"]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), new_cache
