"""Personalized serving launcher: the builders that wire an LM config
into `federated.serving.ServingEngine`, and a decode-steps CLI.
Counterpart of `repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --steps 4

The CLI runs on one device with no mesh; the decode_32k shape at full
width needs more memory than one card holds, so it runs only with
`--reduced` today. Multi-device serving joins with the sharding slice.
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
    the engine (the reference accepts it and drops it).

    float32 matmuls stay in full float32 on the card
    (``allow_tf32 = False``, PyTorch's default, set here explicitly)."""
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import lm_loss
    from repro_torch.federated.serving import AdaptationCache, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    loss_fn, eval_fn = lm_loss(make_apply_fn(cfg))
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

    decode = make_decode_step(cfg)
    params = init_lm(0, cfg, device=args.device)
    cache = init_decode_cache(cfg, batch, seq, device=args.device)
    cache["length"] = min(64, seq)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=args.device)
    with torch.no_grad():
        for it in range(args.steps):
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            if tok.is_cuda:
                torch.cuda.synchronize()
            print(f"decode step {it}: {time.perf_counter() - t0:.4f}s  "
                  f"logits {tuple(logits.shape)}", flush=True)


if __name__ == "__main__":
    main()
