"""Entry-point builders for the LM configs. Counterpart of
`repro/launch/steps.py`:

  train_step    FedMeta meta-training round over a task batch of clients
                (G client groups × C clients in turn × S sequences)
  prefill_step  (params, batch) -> (next-token logits, decode cache)
  decode_step   (params, cache, tokens) -> (logits, cache)

`input_specs` gives every entry point's inputs as meta tensors (shape
and dtype, no memory) with their partition specs on a mesh, as the
reference's ShapeDtypeStructs and PartitionSpecs: the dry run and the
launchers on a mesh place against them.

The reference's ``scan_clients=False`` and ``unroll_layers=True`` give
loop-free HLO for XLA's cost probes, which count a loop body once. The
builders here take both, and both settings run the same Python loops
over clients and layers: eager PyTorch has no loop body for a compiler
to count once, so the steps are bitwise equal either way.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import lm_loss
from repro_torch.models import init_lm, lm_apply, lm_decode_step
from repro_torch.models.layers import as_dtype
from repro_torch.optim import adam
from repro_torch.sharding.dtensor import batch_layout
from repro_torch.utils.pytree import tree_flatten, tree_map


def _tokens_embeds(batch):
    """(tokens, embeds or None) of a batch: a token tensor, or a dict
    with "tokens" and, for the vision and audio configs, "embeds"."""
    if isinstance(batch, dict):
        return batch["tokens"], batch.get("embeds")
    return batch, None


LONG_CONTEXT_WINDOW = 8192   # SWA window applied to dense archs @ long_500k


def resolve_serving_config(cfg, shape):
    """long_500k needs sub-quadratic attention: a dense full-attention
    arch runs its sliding-window variant
    (`repro/launch/steps.py:34-41`)."""
    if (shape.name == "long_500k" and cfg.sliding_window is None
            and cfg.attention == "gqa" and any(k == "attn"
                                               for k in cfg.layer_pattern)):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def make_apply_fn(cfg, *, remat: bool = True, unroll_layers: bool = False):
    """apply(params, batch) -> (logits, aux); batch = tokens or dict
    (with "embeds" for the vision and audio configs). ``remat``
    checkpoints each layer-period repetition (the reference's
    default). ``unroll_layers`` changes nothing (module docstring)."""
    del unroll_layers

    def apply_fn(params, batch):
        tokens, embeds = _tokens_embeds(batch)
        return lm_apply(params, cfg, tokens, modality_embeds=embeds,
                        remat=remat)

    return apply_fn


# ------------------------------------------------------------- train step

def make_train_step(cfg, *, algo_name: str = "fomaml",
                    inner_lr: float = 0.01, outer_lr: float = 1e-4,
                    inner_steps: int = 1, remat: bool = True,
                    scan_clients: bool = True, unroll_layers: bool = False,
                    opt_state_dtype="float32"):
    """FedMeta meta-training step for an LM arch
    (`repro/launch/steps.py:59-118`).

    state = {"phi": {...}, "opt": {...}}
    batch = {"support": leaf (G, C, S, L), "query": ...}: G client
    groups, C clients, S sequences of L tokens. Clients run one at a
    time into an f32 meta-gradient accumulator, so only one adapted θ_u
    is live at a time; the accumulator covers θ, or the whole φ for
    Meta-SGD. Each group's sum is divided by C, the groups are averaged,
    and the tree Adam (``state_dtype=opt_state_dtype``) steps φ. Metrics
    are averaged the same way.

    Returns (train_step, init_state, algo, optimizer).
    ``init_state(key=0, *, phi=None, device="cuda", mesh=None)`` draws
    φ from the seed ``key`` on ``device``, or starts from an injected
    ``phi`` (a reference φ carried over by `convert`: torch cannot
    replay `jax.random`). With ``mesh`` the state is DTensors placed as
    `launch.train.place_state` places the whole state, bitwise: a drawn
    φ is made shard by shard on each rank (`init_lm`'s ``mesh``), with
    no collective; an injected φ is placed whole (`distribute` sends
    rank 0's); the moments are zeros at the shards' shapes and the step
    count is cut locally. ``scan_clients`` and ``unroll_layers`` change
    nothing (module docstring).

    On a mesh the state and batch are DTensors placed by
    `sharding.rules` (`launch/train.place_state`); each client's rows
    take the batch layout (`sharding.dtensor.batch_layout`) and the
    kernels run on local shards through `local_map`."""
    del scan_clients, unroll_layers
    loss_fn, eval_fn = lm_loss(make_apply_fn(cfg, remat=remat))
    algo = make_algorithm(algo_name, loss_fn, eval_fn, inner_lr, inner_steps)
    optimizer = adam(outer_lr, state_dtype=as_dtype(opt_state_dtype))
    whole_phi = algo_name.startswith("meta-sgd")

    def init_state(key=0, *, phi=None, device="cuda", mesh=None):
        if mesh is not None:
            from repro_torch.sharding.rules import (distribute, param_pspecs,
                                                    place_local, state_pspecs)
        if phi is None:
            phi = algo.init_state(key, lambda k: init_lm(
                k, cfg, device=device, mesh=mesh))
        elif mesh is not None:
            spec = param_pspecs(phi["theta"], mesh)
            phi = distribute(phi, {k: spec for k in phi}, mesh)
        state = {"phi": phi, "opt": optimizer.init(phi)}
        if mesh is None:
            return state
        return place_local(state, state_pspecs(
            state, param_pspecs(phi["theta"], mesh), mesh), mesh)

    def per_group(phi, sup, qry):
        acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                       phi if whole_phi else {"theta": phi["theta"]})
        C = tree_flatten(sup)[0][0].shape[0]
        mets = []
        for c in range(C):
            g, met = algo.client_grad(
                phi, batch_layout(tree_map(lambda x: x[c], sup)),
                batch_layout(tree_map(lambda x: x[c], qry)))
            tree_map(lambda a, x: a.add_(x.float()), acc, g)
            mets.append(met)
            del g
        meta_g = tree_map(lambda x: x / C, acc)
        return meta_g, {k: torch.mean(torch.stack([m[k] for m in mets]))
                        for k in mets[0]}

    def train_step(state, batch):
        sup, qry = batch["support"], batch["query"]
        G = tree_flatten(sup)[0][0].shape[0]
        groups = [per_group(state["phi"], tree_map(lambda x: x[i], sup),
                            tree_map(lambda x: x[i], qry))
                  for i in range(G)]
        meta_g = tree_map(lambda *xs: torch.mean(torch.stack(xs), 0),
                          *[g for g, _ in groups])
        mets = {k: torch.mean(torch.stack([m[k] for _, m in groups]))
                for k in groups[0][1]}
        del groups
        phi, opt = optimizer.update(state["phi"], meta_g, state["opt"])
        return {"phi": phi, "opt": opt}, mets

    return train_step, init_state, algo, optimizer


def train_batch_layout(cfg, shape, n_pods: int):
    """(G, C, S_support, S_query, L_text, n_mod)
    (`repro/launch/steps.py:147-156`)."""
    G = n_pods
    S = shape.seqs_per_client
    C = shape.global_batch // (G * S)
    if C * G * S != shape.global_batch:
        raise ValueError(f"{shape.name}: {shape.global_batch} sequences do "
                         f"not split into {G} groups of {S}-sequence clients")
    n_mod = cfg.num_modality_tokens if cfg.modality else 0
    L_text = shape.seq_len - (n_mod if cfg.modality == "vision" else 0)
    return G, C, S // 2, S - S // 2, L_text, n_mod


# ------------------------------------------------------------ serve steps

def make_prefill_step(cfg, *, unroll_layers: bool = False):
    del unroll_layers

    def prefill_step(params, batch):
        tokens, embeds = _tokens_embeds(batch)
        logits, _, cache = lm_apply(params, cfg, tokens,
                                    modality_embeds=embeds, remat=False,
                                    collect_cache=True, logits_mode="last")
        return logits[:, 0], cache

    return prefill_step


def make_decode_step(cfg, *, unroll_layers: bool = False):
    del unroll_layers

    def decode_step(params, cache, tokens):
        logits, new_cache = lm_decode_step(params, cfg, tokens, cache)
        return logits[:, 0], new_cache

    return decode_step


# ------------------------------------------------------------ input specs

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, mesh, *, cache_seq_shard: bool = False) -> dict:
    """Meta-tensor stand-ins and partition specs for the entry point of
    ``shape`` (`repro/launch/steps.py:161-221`): {"batch", "pspec"}, and
    for a decode shape also "serving_cfg" (the batch holds "tokens" and
    the decode "cache"). ``mesh`` is a DeviceMesh or a stand-in with
    ``axis_names`` and ``devices.shape``."""
    from repro_torch.models import init_decode_cache
    from repro_torch.models.layers import as_dtype
    from repro_torch.sharding.rules import (P, batch_axes, cache_pspecs,
                                            mesh_sizes)
    sizes = mesh_sizes(mesh)
    n_pods = sizes.get("pod", 1)
    act_dtype = as_dtype(cfg.dtype)

    if shape.kind == "train":
        G, C, S_sup, S_qry, L_text, n_mod = train_batch_layout(
            cfg, shape, n_pods)
        pod = "pod" if n_pods > 1 else None

        def part(S):
            leaf = {"tokens": _meta((G, C, S, L_text), torch.int32)}
            spec = {"tokens": P(pod, None, "data", None)}
            if cfg.modality:
                leaf["embeds"] = _meta((G, C, S, n_mod, cfg.d_model),
                                       act_dtype)
                spec["embeds"] = P(pod, None, "data", None, None)
            return leaf, spec

        sup, sup_spec = part(S_sup)
        qry, qry_spec = part(S_qry)
        return {"batch": {"support": sup, "query": qry},
                "pspec": {"support": sup_spec, "query": qry_spec}}

    B = shape.global_batch
    baxes = batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= sizes[a]
    b_ax = (baxes if len(baxes) > 1 else baxes[0]) if B % bsize == 0 \
        else None

    if shape.kind == "prefill":
        n_mod = cfg.num_modality_tokens if cfg.modality else 0
        L_text = shape.seq_len - (n_mod if cfg.modality == "vision" else 0)
        batch = {"tokens": _meta((B, L_text), torch.int32)}
        spec = {"tokens": P(b_ax, None)}
        if cfg.modality:
            batch["embeds"] = _meta((B, n_mod, cfg.d_model), act_dtype)
            spec["embeds"] = P(b_ax, None, None)
        return {"batch": batch, "pspec": spec}

    # decode: one token against a seq_len cache
    serving_cfg = resolve_serving_config(cfg, shape)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _meta((B, cfg.num_modality_tokens, cfg.d_model), act_dtype)
    cache = init_decode_cache(serving_cfg, B, shape.seq_len,
                              dtype=act_dtype, enc_out=enc_out,
                              device="meta")
    cache_spec = cache_pspecs(cache, mesh, seq_shard=cache_seq_shard)
    return {"batch": {"tokens": _meta((B, 1), torch.int32), "cache": cache},
            "pspec": {"tokens": P(b_ax, None), "cache": cache_spec},
            "serving_cfg": serving_cfg}
