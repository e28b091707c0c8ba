"""Entry-point builders for the LM configs. Counterpart of
`repro/launch/steps.py`:

  train_step    FedMeta meta-training round over a task batch of clients
                (G client groups × C clients in turn × S sequences)
  prefill_step  (params, batch) -> (next-token logits, decode cache)
  decode_step   (params, cache, tokens) -> (logits, cache)

The reference's ``scan_clients`` and ``unroll_layers`` (loop-free HLO
for XLA's cost probes, which count a loop body once) and
``input_specs`` (the PartitionSpecs its dry run lowers against) join
the port with the dry-run and sharding slice; here clients and layers
run as Python loops.
"""
from __future__ import annotations

import torch

from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import lm_loss
from repro_torch.models import init_lm, lm_apply, lm_decode_step
from repro_torch.models.layers import as_dtype
from repro_torch.optim import adam
from repro_torch.utils.pytree import tree_flatten, tree_map


def _tokens_embeds(batch):
    """(tokens, embeds or None) of a batch: a token tensor, or a dict
    with "tokens" and, for the vision and audio configs, "embeds"."""
    if isinstance(batch, dict):
        return batch["tokens"], batch.get("embeds")
    return batch, None


def make_apply_fn(cfg, *, remat: bool = True):
    """apply(params, batch) -> (logits, aux); batch = tokens or dict
    (with "embeds" for the vision and audio configs). ``remat``
    checkpoints each layer-period repetition (the reference's
    default)."""

    def apply_fn(params, batch):
        tokens, embeds = _tokens_embeds(batch)
        return lm_apply(params, cfg, tokens, modality_embeds=embeds,
                        remat=remat)

    return apply_fn


# ------------------------------------------------------------- train step

def make_train_step(cfg, *, algo_name: str = "fomaml",
                    inner_lr: float = 0.01, outer_lr: float = 1e-4,
                    inner_steps: int = 1, remat: bool = True,
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
    ``init_state(key=0, *, phi=None, device="cuda")`` draws φ from the
    seed ``key`` on ``device``, or starts from an injected ``phi`` (a
    reference φ carried over by `convert`: torch cannot replay
    `jax.random`)."""
    loss_fn, eval_fn = lm_loss(make_apply_fn(cfg, remat=remat))
    algo = make_algorithm(algo_name, loss_fn, eval_fn, inner_lr, inner_steps)
    optimizer = adam(outer_lr, state_dtype=as_dtype(opt_state_dtype))
    whole_phi = algo_name.startswith("meta-sgd")

    def init_state(key=0, *, phi=None, device="cuda"):
        if phi is None:
            phi = algo.init_state(key, lambda k: init_lm(k, cfg,
                                                         device=device))
        return {"phi": phi, "opt": optimizer.init(phi)}

    def per_group(phi, sup, qry):
        acc = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device),
                       phi if whole_phi else {"theta": phi["theta"]})
        C = tree_flatten(sup)[0][0].shape[0]
        mets = []
        for c in range(C):
            g, met = algo.client_grad(phi, tree_map(lambda x: x[c], sup),
                                      tree_map(lambda x: x[c], qry))
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

def make_prefill_step(cfg):
    def prefill_step(params, batch):
        tokens, embeds = _tokens_embeds(batch)
        logits, _, cache = lm_apply(params, cfg, tokens,
                                    modality_embeds=embeds, remat=False,
                                    collect_cache=True, logits_mode="last")
        return logits[:, 0], cache

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, tokens):
        logits, new_cache = lm_decode_step(params, cfg, tokens, cache)
        return logits[:, 0], new_cache

    return decode_step
