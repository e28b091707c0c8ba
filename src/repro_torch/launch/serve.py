"""Personalized serving launcher: the builders that wire an LM config
into `federated.serving.ServingEngine`, and a decode-steps CLI.
Counterpart of `repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --reduced --steps 4 --device cpu

The CLI runs on one device with no mesh. The decode cache of an
attention model is a KV ring of the shape's whole sequence: at
decode_32k (batch 128, 32,768 tokens) SmolLM-360M's is about 171 GB, more
than one card holds, so it runs only with `--reduced`. Mamba2-370M's
decode cache is a fixed-size state per layer (a conv window of
conv_width - 1 inputs and the (nh, hp, N) SSM state), about 6.5 GB at
decode_32k, so it runs at full width on one card. mixtral-8x22b's ring
is its 4,096-token window (1.1 GB a layer at decode_32k), jamba's one
attention layer in 8 holds the whole sequence (17.2 GB) and deepseek's
MLA holds the 576-wide latents (4.8 GB a layer), but their weights
(141 / 52 / 236 B parameters) need many cards at full depth: one card
runs them at a cut depth, in process through `decode_steps`.
Multi-device serving joins with the sharding slice.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, reduced_config
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import init_decode_cache, init_lm


def build_serving_fns(cfg):
    """(prefill, decode) entry points for `ServingEngine`."""
    return make_prefill_step(cfg), make_decode_step(cfg)


def build_engine(cfg, phi=None, *, algo_name: str = "fomaml",
                 inner_lr: float = 0.05, inner_steps: int = 1,
                 adapt_batch: int = 4, cache_capacity: Optional[int] = 64,
                 adapt_impl: Optional[str] = None, seed: int = 0,
                 device="cuda"):
    """Wire an LM config into a `ServingEngine`: FedMeta algorithm over
    `lm_loss`, prefill/decode steps, bounded adaptation cache. `phi`
    defaults to a fresh init from `seed` on `device`. `adapt_impl` picks
    the inner-update route ("cuda" | "torch") and is passed through to
    the engine (the reference accepts it and drops it). Adaptation runs
    without remat, as the reference's serving does.

    float32 matmuls stay in full float32 on the card
    (``allow_tf32 = False``, PyTorch's default, set here explicitly)."""
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import lm_loss
    from repro_torch.federated.serving import AdaptationCache, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    loss_fn, eval_fn = lm_loss(make_apply_fn(cfg, remat=False))
    algo = make_algorithm(algo_name, loss_fn, eval_fn, inner_lr, inner_steps)
    if phi is None:
        def model_init(k):
            return init_lm(k, cfg, device=device)
        phi = (algo.init_state(seed, model_init)
               if algo_name.startswith("meta-sgd")
               else {"theta": model_init(seed)})
    prefill, decode = build_serving_fns(cfg)
    return ServingEngine(algo, phi, adapt_batch=adapt_batch,
                         adapt_steps=inner_steps,
                         cache=AdaptationCache(cache_capacity),
                         prefill_fn=prefill, decode_fn=decode,
                         impl=adapt_impl, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    assert shape.kind == "decode", shape
    batch, seq = shape.global_batch, shape.seq_len
    if args.reduced:
        cfg = reduced_config(cfg)
        batch, seq = 2, 128
    return decode_steps(cfg, batch, seq, args.steps, device=args.device)


def decode_steps(cfg, batch: int, seq: int, steps: int, *, device="cuda",
                 params=None):
    """`steps` greedy decode steps of `batch` sequences against a cache
    of `seq` slots that already holds 64 tokens: the CLI's body. The
    weights are `params`, or a fresh init from seed 0. Returns the run's
    record."""
    decode = make_decode_step(cfg)
    if params is None:
        params = init_lm(0, cfg, device=device)
    cache = init_decode_cache(cfg, batch, seq, device=device)
    cache["length"] = min(64, seq)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    step_s, finite = [], True
    with torch.no_grad():
        for it in range(steps):
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            if tok.is_cuda:
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            finite = finite and bool(torch.isfinite(logits).all())
            print(f"decode step {it}: {step_s[-1]:.4f}s  "
                  f"logits {tuple(logits.shape)}", flush=True)
    return {"arch": cfg.name, "num_layers": cfg.num_layers, "batch": batch,
            "seq_len": seq, "logits_shape": tuple(logits.shape),
            "logits_finite": finite, "step_s": step_s}


if __name__ == "__main__":
    main()
