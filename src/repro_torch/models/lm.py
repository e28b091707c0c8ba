"""LM assembly: embeddings -> layer stack -> final norm -> logits.
Counterpart of `repro/models/lm.py` for every arch of the registry:
dense GQA (SmolLM-360M, granite-3-2b, qwen2.5-3b, nemotron-4-340b), MoE
with sliding-window GQA (mixtral-8x22b), Mamba2 (Mamba2-370M), the
hybrid Mamba / attention / MoE period (jamba-v0.1-52b), MLA with a lead
dense layer and shared experts (deepseek-v2-236b), the vision prefix
with M-RoPE (qwen2-vl-7b) and the encoder-decoder (seamless-m4t-medium).

Modality stubs: precomputed patch or frame embeddings (B, n_mod,
d_model) enter through ``mod_proj``. A vision config puts them in front
of the text ([prefix | text], logits over both; M-RoPE positions from
`_positions`); the encoder-decoder runs a bidirectional encoder over
them, and every decoder block cross-attends to its output (kept in the
prefill's and the decode cache as ``enc_out``).

The parameter tree is the reference's: the repeating layer period is
stored stacked, ``stack/pos{j}`` leaves with a leading ``n_reps`` axis
(and ``encoder/stack`` with ``num_encoder_layers``), so a JAX φ loads
with no remapping. The reference's ``lax.scan`` over repetitions is a
Python loop here.

Entry points:
  init_lm            parameter init
  lm_apply           training / prefill forward (optionally emits cache)
  init_decode_cache  decode cache
  lm_decode_step     one-token decode against the cache (in place: the
                     KV or MLA latent ring, or each Mamba2 layer's
                     conv window and SSM state)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import (block_decode, block_forward, block_init,
                                       block_init_cache, block_prefill,
                                       layer_spec)
from repro_torch.models.layers import (Rng, as_dtype, dense_init, embed_init,
                                       rmsnorm, rmsnorm_init)
from repro_torch.sharding.context import get_mesh
from repro_torch.sharding.dtensor import (activation_spec, batch_layout,
                                         constrain, embedding, is_dtensor)
from repro_torch.sharding.rules import set_path
from repro_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten


# ---------------------------------------------------------------- grouping

ENC_SPEC = ("attn", "mlp")   # every encoder layer

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


def _reps(stack, n_reps):
    """Per-repetition views of stacked leaves, through one ``unbind`` per
    leaf: its backward is one stack, where indexing each repetition would
    build a zero-padded full-size gradient per repetition."""
    leaves, treedef = tree_flatten(stack)
    parts = [x.unbind(0) for x in leaves]
    return [tree_unflatten(treedef, [p[r] for p in parts])
            for r in range(n_reps)]


# ---------------------------------------------------------------- init

def init_units(rng: Rng, cfg):
    """`init_lm`'s draws in the reference's order, one unit at a time:
    (path, tree, rep), ``path`` the unit's key path in the parameter
    tree, ``rep`` None for a unit that stands alone or (r, n) for
    repetition r of n stacked on a leading axis. The order: embed, lead
    blocks, the stack (with cross-attention in each block of an
    encoder-decoder), final norm, lm_head, mod_proj, then the encoder's
    stack of ("attn", "mlp") blocks and its final norm."""
    dtype = as_dtype(cfg.dtype)
    d, vocab = cfg.d_model, cfg.vocab_size
    yield ("embed",), embed_init(rng, vocab, d, dtype), None
    lead, period, n_reps = layer_groups(cfg)
    for i, spec in enumerate(lead):
        yield (f"lead_{i}",), block_init(rng, cfg, spec, dtype), None
    for j, spec in enumerate(period):
        for r in range(n_reps):
            yield (("stack", f"pos{j}"),
                   block_init(rng, cfg, spec, dtype,
                              cross=cfg.is_encoder_decoder), (r, n_reps))
    yield ("final_norm",), rmsnorm_init(d, dtype, rng.device), None
    if not cfg.tie_embeddings:
        yield ("lm_head",), dense_init(rng, d, vocab, dtype), None
    if cfg.modality is not None:
        yield ("mod_proj",), dense_init(rng, d, d, dtype), None
    if cfg.is_encoder_decoder:
        n_enc = cfg.num_encoder_layers
        for r in range(n_enc):
            yield (("encoder", "stack"),
                   block_init(rng, cfg, ENC_SPEC, dtype), (r, n_enc))
        yield (("encoder", "final_norm"),
               rmsnorm_init(d, dtype, rng.device), None)


def init_lm(key, cfg, *, device="cuda", mesh=None):
    """Parameters from an int seed (or an `Rng`), on `device`, drawn in
    `init_units`' order; the stacked leaves are the repetitions' draws
    stacked.

    With ``mesh`` they are DTensors placed by `param_pspecs`, and each
    rank makes only its own shards (`sharding.rules.materialize_units`):
    it draws one unit at a time, as the whole draw does, keeps its
    shard and drops the rest. The shards are bitwise those that `distribute`
    cuts from the whole draw, with no collective; a rank holds its
    shards and one unit (one layer, its f32 staging) at most."""
    rng = key if isinstance(key, Rng) else Rng(key, device)
    if mesh is not None:
        from repro_torch.sharding.rules import (materialize_units,
                                                param_pspecs)
        shapes = init_lm(Rng(0, "meta"), cfg)
        return materialize_units(init_units(rng, cfg),
                                 param_pspecs(shapes, mesh), mesh)
    # each repetition is copied into its slot of the stacked leaves as it
    # is drawn (bitwise a stack of the draws), so the stack is held once:
    # stacking a list of the draws held it twice (82.8 GB at nemotron's
    # 6 layers)
    params, stacks = {}, {}
    for path, tree, rep in init_units(rng, cfg):
        if rep is None:
            set_path(params, path, tree)
            continue
        r, n = rep
        if r == 0:
            stacks[path] = tree_map(
                lambda x: x.new_empty((n,) + tuple(x.shape)), tree)
        tree_map(lambda buf, x: buf[r].copy_(x), stacks[path], tree)
        del tree
        if r == n - 1:
            set_path(params, path, stacks.pop(path))
    return params


# ---------------------------------------------------------------- positions

def _positions(cfg, n_mod: int, L_text: int, batch: int, device):
    """Position ids for the [modality prefix | text] layout: (B, L) ints,
    or (B, L, 3) (t, h, w) M-RoPE components, where the prefix's patch i
    sits at (0, i // grid, i % grid) on a grid of ⌈√n_mod⌉ and text token
    i at t = h = w = i + grid (the grid computed in Python ints, as the
    reference computes it)."""
    if cfg.mrope:
        grid = max(1, int(math.ceil(math.sqrt(max(n_mod, 1)))))
        idx = torch.arange(n_mod, device=device)
        ppos = torch.stack([torch.zeros_like(idx), idx // grid, idx % grid],
                           dim=-1)
        t = torch.arange(L_text, device=device) + grid
        pos = torch.cat([ppos, torch.stack([t, t, t], dim=-1)]).to(
            torch.int32)
        return pos.expand((batch,) + tuple(pos.shape))
    pos = torch.arange(n_mod + L_text, dtype=torch.int32, device=device)
    return pos.expand(batch, n_mod + L_text)


# ---------------------------------------------------------------- forward

def _logits(params, cfg, x):
    head = (params["embed"].t() if cfg.tie_embeddings else params["lm_head"])
    return (x @ head).float()


def _run_encoder(params, cfg, frames):
    """The bidirectional encoder over modality frame embeddings
    (`repro/models/lm.py:104-117`): ``frames @ mod_proj`` with no cast,
    then ``num_encoder_layers`` ("attn", "mlp") blocks, no causal mask,
    positions 0..T-1, and the encoder's final norm. Where the frames'
    dtype differs from the weights' (f32 frames into a bf16 model), the
    encoder runs in their promoted dtype, the weights cast up, as JAX
    promotes each product: its output is then f32."""
    enc, proj = params["encoder"], params["mod_proj"]
    dt = torch.promote_types(frames.dtype, proj.dtype)
    if dt != proj.dtype:
        enc, proj = tree_map(lambda a: a.to(dt), enc), proj.to(dt)
    x = frames.to(dt) @ proj
    B, T, _ = x.shape
    pos = torch.arange(T, dtype=torch.int32, device=x.device).expand(B, T)
    for rep in _reps(enc["stack"], cfg.num_encoder_layers):
        x, _ = block_forward(rep, cfg, ENC_SPEC, x, pos, causal=False)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def _maybe_shard_seq(cfg, h):
    """The residual stream's layout at a block boundary
    (`repro/models/lm.py:120-137`). A plain tensor passes through. A
    DTensor (the launcher on a mesh) is redistributed to the batch over
    pod+data, and, with ``cfg.shard_seq`` and an ambient mesh, to the
    sequence over "model" (Megatron-style sequence sharding: with remat
    the stored activation shrinks by the model axis's size, for an
    all-gather before each block's attention). The numbers do not
    change."""
    if not is_dtensor(h):
        return h
    seq_dim = 1 if cfg.shard_seq and get_mesh() is not None else None
    return constrain(h, activation_spec(h.device_mesh, h.ndim, h.shape[0],
                                        seq_dim=seq_dim))


def _rep_forward(rep, cfg, period, x, aux, positions, enc_out):
    """One repetition of the layer period: the reference's scan body,
    (x, aux) -> (x, aux)."""
    for j, spec in enumerate(period):
        x, a = block_forward(rep[f"pos{j}"], cfg, spec, x, positions,
                             enc_out=enc_out)
        aux = aux + a
    return _maybe_shard_seq(cfg, x), aux


def _writable(tree) -> bool:
    """Whether ``tree``'s tensors can be copied into plain buffers in
    place: not DTensors and not under a functorch transform (vmap,
    grad), whose wrapped tensors take no such write."""
    from torch._C._functorch import is_functorch_wrapped_tensor
    return all(type(x) is torch.Tensor and not is_functorch_wrapped_tensor(x)
               for x in tree_flatten(tree)[0])


def lm_apply(params, cfg, tokens, *, modality_embeds=None, remat: bool = True,
             collect_cache: bool = False, cache_capacity: int | None = None,
             logits_mode: str = "all"):
    """Training / prefill forward. tokens: (B, L_text) int;
    modality_embeds: (B, n_mod, d_model) for the vision and audio
    configs (the stub frontend's output).

    Returns (logits, aux_loss[, cache]). A vision config's logits cover
    [prefix | text]; `core.losses.lm_loss` scores the last L_text. The
    cache's ``length`` is n_mod + L_text; an encoder-decoder's cache
    holds ``enc_out``. With ``remat`` each repetition
    of the layer period runs under a non-reentrant
    `torch.utils.checkpoint`, where the reference puts
    ``jax.checkpoint(body)`` (`repro/models/lm.py:206-216`): a backward
    pass keeps only each repetition's input and recomputes its forward,
    and a second-order pass (MAML) differentiates through the
    recomputation. The forward draws no random numbers, so the
    checkpoint stashes no RNG state. The ``lead_*`` blocks and the
    prefill path (``collect_cache``) are never checkpointed, as in the
    reference. The reference's ``unroll_layers`` has no counterpart: the
    layers always run as a Python loop. The prefill writes each
    repetition's cache into the stacked buffers as the repetition ends,
    as the reference's scan stacks its outputs (`_writable`; DTensors
    and functorch transforms stack at the end): a stack of every
    repetition's cache at the end would hold the cache twice, 85.8 GB
    for SmolLM-360M at prefill_32k's batch of 32."""
    B, L_text = tokens.shape
    lead, period, n_reps = layer_groups(cfg)
    tokens, modality_embeds = batch_layout((tokens, modality_embeds))
    x = embedding(tokens, params["embed"])
    enc_out, n_mod = None, 0
    if cfg.modality is not None and modality_embeds is None:
        raise ValueError(f"{cfg.name} takes modality_embeds (B, n_mod, "
                         f"{cfg.d_model})")
    if cfg.is_encoder_decoder:
        enc_out = _run_encoder(params, cfg, modality_embeds)
    elif cfg.modality is not None:
        n_mod = modality_embeds.shape[1]
        x = torch.cat([modality_embeds.to(x.dtype) @ params["mod_proj"], x],
                      dim=1)
    x = _maybe_shard_seq(cfg, x)
    positions = _positions(cfg, n_mod, L_text, B, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    L_total = n_mod + L_text
    capacity = cache_capacity or L_total

    caches = {}
    for i, spec in enumerate(lead):
        if collect_cache:
            x, a, caches[f"lead_{i}"] = block_prefill(
                params[f"lead_{i}"], cfg, spec, x, positions, capacity,
                enc_out=enc_out)
        else:
            x, a = block_forward(params[f"lead_{i}"], cfg, spec, x, positions,
                                 enc_out=enc_out)
        aux = aux + a

    outs, stacked = [], None
    for r, rep in enumerate(_reps(params["stack"], n_reps)):
        if not collect_cache:
            if remat and torch.is_grad_enabled():
                x, aux = checkpoint(_rep_forward, rep, cfg, period, x, aux,
                                    positions, enc_out, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = _rep_forward(rep, cfg, period, x, aux, positions,
                                      enc_out)
            continue
        rep_caches = {}
        for j, spec in enumerate(period):
            x, a, rep_caches[f"pos{j}"] = block_prefill(
                rep[f"pos{j}"], cfg, spec, x, positions, capacity,
                enc_out=enc_out)
            aux = aux + a
        x = _maybe_shard_seq(cfg, x)
        if r == 0 and _writable(rep_caches):
            stacked = tree_map(
                lambda c: c.new_empty((n_reps,) + tuple(c.shape)), rep_caches)
        if stacked is None:
            outs.append(rep_caches)
        else:
            tree_map(lambda buf, c: buf[r].copy_(c), stacked, rep_caches)
        del rep_caches

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]          # serving prefill: next-token logits only
    logits = _logits(params, cfg, x)
    if collect_cache:
        caches["stack"] = (stacked if stacked is not None else
                           tree_map(lambda *xs: torch.stack(xs), *outs))
        caches["length"] = L_total
        if enc_out is not None:
            caches["enc_out"] = enc_out
        return logits, aux, caches
    return logits, aux


# ---------------------------------------------------------------- decode

def init_decode_cache(cfg, batch: int, capacity: int, dtype=None,
                      enc_out=None, *, full: bool = True, device="cuda"):
    """Decode cache sized for `capacity` cached tokens. With full=True
    the cache is marked as already holding `capacity` tokens
    (steady-state decode). The stacked buffers are real (decode writes
    them in place), where the reference broadcasts one zero buffer. An
    encoder-decoder's cache carries ``enc_out`` (B, T_frames, d_model),
    which every decode step's cross-attention reads."""
    dtype = as_dtype(dtype or cfg.dtype)
    lead, period, n_reps = layer_groups(cfg)
    caches = {}
    for i, spec in enumerate(lead):
        caches[f"lead_{i}"] = block_init_cache(cfg, spec, batch, capacity,
                                               dtype, device)
    stack = {}
    for j, spec in enumerate(period):
        # one repetition's layout on the meta device (shapes, no memory:
        # jamba's attention ring is 17.2 GB at decode_32k)
        one = block_init_cache(cfg, spec, batch, capacity, dtype, "meta")
        stack[f"pos{j}"] = tree_map(
            lambda x: torch.zeros((n_reps,) + tuple(x.shape), dtype=x.dtype,
                                  device=device), one)
    caches["stack"] = stack
    caches["length"] = capacity if full else 0
    if enc_out is not None:
        caches["enc_out"] = enc_out
    return caches


def lm_decode_step(params, cfg, tokens, cache):
    """One-token decode. tokens: (B, 1) int. Returns (logits, cache): the
    cache's tensors are updated in place and the returned dict holds
    them with ``length`` advanced by one."""
    lead, period, n_reps = layer_groups(cfg)
    x = embedding(tokens, params["embed"])
    length = int(cache["length"])
    enc_out = cache.get("enc_out")
    new_cache = {"length": length + 1}
    if enc_out is not None:
        new_cache["enc_out"] = enc_out
    for i, spec in enumerate(lead):
        x, new_cache[f"lead_{i}"] = block_decode(
            params[f"lead_{i}"], cfg, spec, x, cache[f"lead_{i}"], length,
            enc_out=enc_out)
    rep_params = _reps(params["stack"], n_reps)
    rep_caches = _reps(cache["stack"], n_reps)
    for rep, rc in zip(rep_params, rep_caches):
        for j, spec in enumerate(period):
            x, _ = block_decode(rep[f"pos{j}"], cfg, spec, x, rc[f"pos{j}"],
                                length, enc_out=enc_out)
    new_cache["stack"] = cache["stack"]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x), new_cache
