"""Entry-point builders for the LM configs (serving side).

Counterpart of `repro/launch/steps.py:44-56,122-141`:

  apply_fn      (params, batch) -> (logits, aux)
  prefill_step  (params, tokens) -> (next-token logits, decode cache)
  decode_step   (params, cache, tokens) -> (logits, cache)

The training step joins with the training slice.
"""
from __future__ import annotations

from repro_torch.models import lm_apply, lm_decode_step


def make_apply_fn(cfg):
    """apply(params, batch) -> (logits, aux); batch = tokens or dict."""

    def apply_fn(params, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return lm_apply(params, cfg, tokens)

    return apply_fn


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        logits, _, cache = lm_apply(params, cfg, tokens, collect_cache=True,
                                    logits_mode="last")
        return logits[:, 0], cache

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, cache, tokens):
        logits, new_cache = lm_decode_step(params, cfg, tokens, cache)
        return logits[:, 0], new_cache

    return decode_step
