"""Loss / metric functions (counterpart of `repro/core/losses.py`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.dtensor import batch_layout, replicated


def softmax_xent(logits, labels):
    """Mean cross entropy. logits: (..., C) f32; labels: (...) int.
    DTensor logits (a step on a mesh) take the batch layout first, the
    classes whole on every rank: DTensor's backward of the class gather
    views a slice it cannot view."""
    logits, labels = batch_layout((logits, labels))
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def _accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def accuracy(logits, labels):
    """Top-1 accuracy. DTensor logits (a step on a mesh) are gathered
    whole first: DTensor has no rule for an argmax over a sharded
    vocabulary."""
    return replicated(_accuracy, logits, labels)


def topk_accuracy(logits, labels, k: int):
    topk = torch.topk(logits, k, dim=-1).indices              # (..., k)
    hit = torch.any(topk == labels[..., None], dim=-1)
    return torch.mean(hit.float())


def classification_loss(apply_fn, topk=()):
    """-> loss_fn(params, (x, y)) and eval_fn(params, (x, y)) -> (loss,
    metrics). ``topk`` adds ``top{k}`` accuracy metrics."""

    def loss_fn(params, batch):
        x, y = batch
        return softmax_xent(apply_fn(params, x), y)

    def eval_fn(params, batch):
        x, y = batch
        logits = apply_fn(params, x)
        metrics = {"accuracy": accuracy(logits, y)}
        for k in topk:
            metrics[f"top{k}"] = topk_accuracy(logits, y, k)
        return softmax_xent(logits, y), metrics

    return loss_fn, eval_fn


def lm_loss(apply_fn):
    """Next-token LM loss over token batches.

    Batches are a (B, L) token tensor or a dict with "tokens".
    apply_fn(params, batch) -> (logits (B, L', V), aux); aux is added to
    the objective. Returns (loss_fn, eval_fn)."""

    def _tokens(batch):
        return batch["tokens"] if isinstance(batch, dict) else batch

    def loss_fn(params, batch):
        tokens = _tokens(batch)
        logits, aux = apply_fn(params, batch)
        logits = logits[:, -tokens.shape[1]:]
        return softmax_xent(logits[:, :-1], tokens[:, 1:]) + aux

    def eval_fn(params, batch):
        tokens = _tokens(batch)
        logits, aux = apply_fn(params, batch)
        logits = logits[:, -tokens.shape[1]:]
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return loss + aux, {"accuracy": accuracy(logits[:, :-1], tokens[:, 1:]),
                            "nll": loss}

    return loss_fn, eval_fn


def lm_pair_loss(apply_fn):
    """`lm_loss` behind the federated (x, y) batch convention: x is the
    (B, L) token batch, the target is the shifted sequence, y is
    ignored."""
    base_loss, base_eval = lm_loss(apply_fn)

    def loss_fn(params, batch):
        x, _ = batch
        return base_loss(params, x)

    def eval_fn(params, batch):
        x, _ = batch
        return base_eval(params, x)

    return loss_fn, eval_fn
