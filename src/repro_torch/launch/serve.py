"""Personalized serving launcher: the builders that wire an LM config
into `federated.serving.ServingEngine`, and a decode-steps CLI.
Counterpart of `repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --steps 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --reduced --steps 4 --device cpu

The CLI runs on a device mesh (`launch/mesh.launcher_mesh`: the
production mesh in a world of 256 or 512 ranks, the 1x1 host mesh in a
world of one): the weights, the cache and each step's tokens are
DTensors placed by the ported specs (`param_pspecs`, `input_specs`),
and K8 runs on each rank's shards through `local_map`. The decode
cache of an attention model is a KV ring of the shape's whole sequence: at
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
qwen2-vl-7b's ring at decode_32k is 8.6 GB a layer (28 layers);
seamless-m4t-medium's 17.2 GB a decoder layer (12), beside the zero
encoder output of 1,024 frames that each step cross-attends to: both
run on one card at a cut depth through `decode_steps`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, reduced_config
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step,
                                      resolve_serving_config)
from repro_torch.models import init_decode_cache, init_lm
from repro_torch.models.layers import as_dtype
from repro_torch.sharding.context import stepping_on


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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if shape.kind != "decode":
        raise ValueError(f"{args.shape} is not a decode shape")
    if args.reduced:
        cfg = reduced_config(cfg)
        shape = dataclasses.replace(shape, seq_len=128, global_batch=2)
    cfg = resolve_serving_config(cfg, shape)
    from repro_torch.launch.mesh import launcher_world
    from repro_torch.launch.train import check_device
    with launcher_world(args.multi_pod and not args.reduced,
                        check_device(args.device).type) as mesh:
        return decode_steps(cfg, shape.global_batch, shape.seq_len,
                            args.steps, device=args.device, mesh=mesh)


def decode_state(cfg, batch: int, seq: int, *, device="cuda", params=None,
                 mesh=None):
    """(params, cache) of `decode_steps`: the weights are ``params`` or a
    fresh init from seed 0, the cache ``seq`` slots of zeros marked as
    holding 64 tokens (an encoder-decoder's with a zero encoder output
    of ``num_modality_tokens`` frames). With ``mesh`` both are DTensors
    placed by `param_pspecs` and `cache_pspecs`: each rank draws its own
    shards of fresh weights (`init_lm`'s ``mesh``) and makes its shards
    of the cache's zeros, with no collective; given ``params`` are
    placed whole (`distribute`)."""
    # on a mesh the cache's shapes come from the meta device
    cache_dev = device if mesh is None else "meta"
    if params is None:
        params = init_lm(0, cfg, device=device, mesh=mesh)
    elif mesh is not None:
        from repro_torch.sharding.rules import distribute, param_pspecs
        params = distribute(params, param_pspecs(params, mesh), mesh)
    enc_out = None
    if cfg.is_encoder_decoder:
        # the reference's decode cache: a zero encoder output of
        # num_modality_tokens frames (`repro/launch/steps.py:208-213`)
        enc_out = torch.zeros((batch, cfg.num_modality_tokens, cfg.d_model),
                              dtype=as_dtype(cfg.dtype), device=cache_dev)
    cache = init_decode_cache(cfg, batch, seq, enc_out=enc_out,
                              device=cache_dev)
    cache["length"] = min(64, seq)
    if mesh is not None:
        from repro_torch.sharding.rules import cache_pspecs, zeros_placed
        cache = zeros_placed(cache, cache_pspecs(cache, mesh), mesh)
    return params, cache


def decode_steps(cfg, batch: int, seq: int, steps: int, *, device="cuda",
                 params=None, mesh=None):
    """`steps` greedy decode steps of `batch` sequences against a cache
    of `seq` slots that already holds 64 tokens: the CLI's body. The
    weights and cache are `decode_state`'s. With ``mesh`` the weights,
    the cache and each step's tokens (the batch over pod+data) are
    placed on it and it is the ambient mesh. Returns the run's
    record."""
    decode = make_decode_step(cfg)
    params, cache = decode_state(cfg, batch, seq, device=device,
                                 params=params, mesh=mesh)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    place_tok = lambda t: t                       # noqa: E731
    if mesh is not None:
        from repro_torch.sharding.dtensor import activation_spec
        from repro_torch.sharding.rules import distribute
        tspec = {"t": activation_spec(mesh, 2, batch)}
        place_tok = lambda t: distribute({"t": t}, tspec,  # noqa: E731
                                         mesh)["t"]
    step_s, finite = [], True
    with torch.no_grad():
        for it in range(steps):
            t0 = time.perf_counter()
            with stepping_on(mesh):
                logits, cache = decode(params, cache, place_tok(tok))
                if mesh is not None:
                    logits = logits.full_tensor()
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
