"""Loss / metric functions (counterpart of `repro/core/losses.py:8-77`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_xent(logits, labels):
    """Mean cross entropy. logits: (..., C) f32; labels: (...) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return -torch.mean(ll)


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


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
