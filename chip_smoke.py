#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one CUDA card, from a repo checkout

Phases, each printing one JSON line:

  device   fails (nonzero exit, no result) without a CUDA card or outside
           a checkout; prints `nvidia-smi --query-gpu=name,power.limit`.
  build    builds the port's kernels (K1–K9) from kernels/csrc/ for
           sm_90a into build/torch_ext/ and prints the build time.
  kernels  holds each kernel against its plain PyTorch version on the
           card at the main paths' shapes: K1–K6 bitwise (K2–K6 at the
           full SmolLM-360M plane; K6 also on a FEMNIST block with a zero
           row and exact .5 products; K2 on the int8 block with the
           folded weights w·s, on the jittered staleness ring's
           6-row block, and as the population plane's masked mean (two
           zero-weight rows, then the division by Σw); K5 in f32 and
           bf16 with a NaN row made dead, on
           the trimmed resume cell's 4-row FEMNIST block with its ring
           row dead, on the FEMNIST block with adversarial rows and ties, on
           the degenerate rounds with their NaN and ±inf in place, and
           at m > 16; K1 in its scalar, shared and per-client α modes),
           K7 and K8 within a stated bf16 tolerance (K7 also at the LM
           round's shape and, in f32, the lm scenario's (4, 2 heads, 1 kv
           head, L 16, hd 32), at the MoE prefills' shapes — mixtral's
           sliding window over 4,608 tokens, jamba's 4,096, deepseek's
           MLA at qk dim 192 and value dim 128, timed against the SDPA
           backend that takes that (named in the row) — in f32 at hd
           192, refusing hd 256 with no launch, at qwen2-vl's prefill
           (28 heads over 4 kv heads, 4,096 tokens), at seamless-m4t's
           bidirectional encoder (1,024 frames), decoder self-attention,
           cross-attention (4,096 text queries over 1,024 frames) and
           decode-step cross-attention (128 rows of one query), and
           ragged kv_length on the card: the oracle,
           bitwise equal to impl="torch", no K7 launch; K8 also on
           mixtral's, jamba's, qwen2-vl's (G = 7) and seamless's (G = 1,
           hd 64) decode_32k caches (128 rows of 4,096 or 32,768 slots;
           the plain version row block by row block), G = 7 through
           the split combine, on a
           32K-slot cache split across blocks, ragged 4K-slot caches,
           rows with kv_length 0 against the mean of V, and a Python-int
           kv_length that launches K8 alone), K9 and its plain version
           each within a bound
           derived from f32 accumulation against a float64 evaluation
           (Mamba2-370M's prefill, adaptation, round and served-prefill
           shapes, an odd chunk, and an input whose above-diagonal
           decay overflows, where the chunked oracle gives NaN and K9
           stays finite). K7, K8 and K9 also at every folded shape the
           serve and trace phases give them (SmolLM's 16 requests'
           prefill, (16, 15, 5, 64, 64), and decode step, B 16 C 64: the
           kernels line's K8 case; its trace's 4 requests; the granite,
           qwen2.5 and mixtral serves' 2 requests; Mamba2's 16 served and
           4 traced prompts through K9), and K7, K8 and
           K9 under `torch.func.vmap` over 4 requests: one launch,
           bitwise equal to 4 kernel calls, no merge copy, and a refused
           call (K7 at bf16 hd 256) raising under vmap with no launch.
           Times kernel, plain version and one PyTorch
           library call (a yardstick the port never calls) two ways:
           `call_ms`, CUDA events around one call (median of 20 after
           warm-up; the host's wrapper time is inside the window), and
           `device_ms` / `library_device_ms`, the device activity alone
           under torch.profiler with the L2 evicted before each call
           (median of 4 blocks of 50 calls, kernel and yardstick in
           turns).
  refusals each kernel wrapper refuses, on CUDA tensors, a call its
           binding would refuse (a ValueError, no launch, no plain
           fall-back); each binding's own refused call, straight on the
           extension in a child process, prints its exit code and
           message; the C++ runtime the extension resolves.
  serve    drives the port's serving path at full SmolLM-360M width —
           `build_engine` + `ServingEngine.serve` over 16 seeded
           requests (adapt -> prefill -> decode) — with every kernel's
           launch count set to 0 just before and read just after; checks
           finite output, cache hits, a served row bitwise equal to a
           solo `adapt_packed`, and the distance to the all-plain route.
           The 16 prompts are one prompt-shape group, generated in one
           `torch.func.vmap` (`ServingEngine.generate_batch`): K8 224
           times (32 layers × 7 steps × 1 group); one generation of the
           group launches K7 once a layer and K8 once a layer a step;
           on 2 requests, tokens equal to the per-request route's
           (`generate`, kernels on) or a first difference at a top-two
           logit gap within the bf16 limit, first-step logits within
           that limit, and the plain route under vmap (K7, K8, K9 plain)
           within it too (`batched_generation`). Seconds and peak GB.
  trace    torch.profiler over a further adaptation and decode: device
           busy share, device time by kernel group, and each kernel's
           launches in the span beside its group (device µs a launch).
  train    the FedMeta training round. FEMNIST through the entry point:
           `FederatedTrainer(packed=True, client_plane=True)` runs 20
           FOMAML rounds of 4 clients with evals, then again with
           impl="torch" (history and φ must be bitwise equal), and one
           round each of MAML (order 2) and Meta-SGD; bytes per round
           must be the reference's 14,772,160; one more round is
           traced. Then 3 packed FOMAML rounds of SmolLM-360M at full
           width on the client plane (4 clients, 4 + 4 sequences of 128
           tokens each), round 1 held against the same round on the
           all-plain route, round 3 traced.
           Each path's kernel launches are counted from 0.
  train_comm  the bytes-on-the-wire round and the experiment plane,
           through `run_comparison` on the client plane: (i) the
           compression sweep (FOMAML, 30 rounds, f32 / bf16 / int8+ef /
           topk0.05+ef), bytes per round held exactly, K6 launched once
           a round under int8, and the int8 run again with impl="torch",
           bitwise equal; (ii) int8+ef with DP for 5 rounds, kernel and
           plain routes bitwise equal; (iii) the committed FEMNIST
           comparison plan (five methods; cut to 40 rounds) under
           ``REPRO_SANITIZE=1`` (no tensor in any record), bytes held
           exactly; (iv) 2 FOMAML rounds of SmolLM-360M at full width
           with int8 uploads, error feedback over 8 client rows and DP,
           round 1 held against the all-plain route.
  train_faults  the failure plane: (i) the committed FEMNIST robustness
           sweep through `launch/compare.sweep_robustness` (FOMAML, 60
           clients, 8 a round, 40 rounds, five fault scenarios × mean /
           screen / trimmed on the packed pipeline): skipped rounds
           exactly the artifact's in all 15 cells, the all-skipped cell
           bitwise at its initial state, K5 40 times in each trimmed cell
           and K2 once a round in the others; the byzantine 0.25 /
           trimmed cell again on impl="torch" (the sort), its round-1
           aggregate held against K5's at a bound derived from the
           cancellation in (total − top) − bot; (ii) SmolLM-360M at full
           width on the client plane with faults: trimmed (one
           sign-flipped row of 4) for 2 rounds, screen and mean with a
           NaN row for one round each, the mean's round skipped with φ
           and the Adam state bitwise unchanged.
  train_scenarios  the paper's other scenarios through `run_comparison`
           on the client plane, five methods each: (i) the committed
           Sent140 plan (`sent_lstm`, 8 clients a round; cut to 4
           rounds), its comm-to-target table printed beside the
           artifact's, then 5 FOMAML rounds on the kernel route and on
           impl="torch" (equal NaN masks in φ, finite entries bitwise);
           (ii) the committed recommender plan (FedMeta on the 40-way
           local head, FedAvg on the 120-way global head; cut to 10
           rounds), θ's size by method equal to the artifact's, top-4 in
           every eval record; (iii) the Shakespeare (`char_lstm`) plan
           for 4 rounds (an eval every 2) and the LM one (reduced
           SmolLM, K7 in f32) for 10 (an eval every 5). Bytes a round
           held exactly by method; K1, K2 and K3 launched in each, K7 in
           the LM's; eval accuracy and loss finite. (iv) Two FOMAML
           rounds of each LSTM at the paper's widths
           (`char_lstm(70, 256, 8)`, `sent_lstm(2000, 100, 64)`;
           52,174,208 and 17,574,528 B a round), round 1 held against
           the all-plain route, the char-LSTM's round 2 traced.
  train_async  the async round engine and crash-safe checkpoints, through
           `FederatedTrainer.run`: (i) SmolLM-360M at full width (the
           SmolLM round's settings, `make_lm_clients` dialects of 128
           tokens at the model's vocabulary), 4 rounds synchronous and
           pipelined (prefetch 2 staged on a side stream, flush every 4,
           fused blocks of 2): history equal record for record and the
           state bitwise; 2 more rounds of each traced (round wall, busy
           share, K1/K2/K3/K7 launches). (ii) The same with stragglers,
           `StalenessConfig(delay=2, fraction=0.25)` fixed and jittered,
           4 rounds on the kernel route and on impl="torch" (K1, K2, K3
           plain): φ, the Adam state and the (2, 1, N) ring bitwise
           equal; K2 launched on 4-row and 6-row blocks; the predicted
           peak (the synchronous round's, the ring twice and the
           aggregation block) checked against the card's memory first.
           (iii) Kill and resume (`tests/test_checkpoint.py`'s
           configurations: staleness; staleness + dropout + byzantine +
           trimmed, trim 1) at FEMNIST width and on the `lm` scenario's
           reduced SmolLM: 9 rounds against 6 checkpointed at 3 and 6 and
           a fresh trainer resumed to 9, prefetch 2, history and φ
           bitwise; each checkpoint's bytes, save and load seconds.
  train_population  the population plane, through the entry points:
           (i) the committed artifact's three cells through
           `launch/compare.sweep_population` (FOMAML on Sent140, a lazy
           registry of 100 clients behind a 32-client LRU and 2 pool
           workers, 8 a round: clean, failures at 0.65 with a 0.75
           deadline and over-selection ×5, the same without
           over-selection; cut from 60 rounds to 30): skipped rounds,
           arrivals, cohort fill, client updates and the comm totals
           exactly the reference's first 30 rounds, the registry's
           accesses the reference's and its peak under the cap;
           (ii) a lazily generated fleet of 10^6 Sent140 clients (and
           10^3) under the paper-width `sent_lstm(2000, 100, 64)` on the
           client plane, m = 8, failures, a deadline, over-selection, 4
           pool workers and the breaker: 6 rounds synchronous and 6
           pipelined, history and state bitwise; round 1 bitwise equal to
           impl="torch"; rounds/s, host RSS, the LRU's peak, K1–K3 a round
           and bytes per candidate and arrival; (iii) SmolLM-360M at full
           width over lazy clients, over-selection 1.0 and an arrival
           model whose rounds 1–3 see 3, 0 and 2 arrivals: K2 on the
           (4, N) block with zero-weight rows, round 1 bitwise equal to
           impl="torch", the dead round skipped with φ, m, v and the step
           bitwise unchanged, round 3 traced; (iv) kill and resume with
           the breaker at FEMNIST width, history, φ and breaker bitwise.
  serve_ssm  the serving path of Mamba2-370M at full width (bf16, random
           weights, seed 0): 16 requests of the serve phase's traffic,
           supports of 128-token sequences, prompts of 200 tokens (two
           chunks after padding), 8 new tokens; K1 and K9 launched, K7
           and K8 not; the serve phase's row, plain-route and batched
           generation checks (K9 once a layer for the group's prefill);
           the prefill -> decode handoff of one adapted row over 2 decode
           steps against `lm_apply`, in f32 and in bf16.
  trace_ssm  the trace phase over the Mamba2 engine.
  train_ssm  2 packed FOMAML rounds of Mamba2-370M at full width on the
           client plane (train_lm's settings), round 1 held against the
           all-plain route (K1, K2, K3 plain, the SSD on its chunked
           oracle) in bf16, and again in float32 (both routes then
           compute one function: meta-gradients within 1e-3 of the
           largest), K9 counted under the gradient, round 2 traced.
  decode_launcher  `repro_torch.launch.serve.main(["--arch",
           "mamba2-370m", "--steps", "4"])`: decode_32k's batch of 128
           at full width, on the 1x1 NCCL host mesh (the weights and
           cache as DTensors); finite logits, ms per step, peak memory;
           the same 4 steps with no mesh, ms per step.
  train_launcher  the LM training launcher (`launch/train.py`, the
           reference's `make_train_step`, layer remat): (i)
           `train.main(["--arch", "smollm-360m", "--reduced", "--steps",
           "2"])` (on the 1x1 host mesh); (ii) SmolLM-360M at full width and train_4k's 4,096
           tokens, cut in sequences a client and clients (`LAUNCH_CUT`):
           2 FOMAML steps and 1 MAML step through `train.train`, K1 and
           K7 launched, finite loss, φ moved, per-step ms and peak GB;
           FOMAML's step 1 against the plain route (K1, K7 plain, neither
           launched) in bf16 (the meta-gradient, Adam's first moment,
           within 1/8; φ within 2·lr plus one bf16 ulp, a sanity bound)
           and, at the small cut, in float32 (within 1e-3); the small
           cut's peak with remat on and off; (iii) MAML's and Meta-SGD's
           meta-gradients on the client plane through K7 (the `lm`
           scenario's f32 shape) and K9 (Mamba2 reduced, f32) against the
           plain route, within 1e-5 of the largest entry (the
           second-order backward through the kernels' Functions); (iv)
           granite-3-2b and qwen2.5-3b served at full width
           (`DENSE_SERVE`; adapt_batch cut to 1: a miss, then a hit),
           K1, K7 and K8 launched (K8 once a layer a step for the group
           of two), finite rows and prefill logits, adapt and decode ms,
           peak GB, the batched generation checks of the serve phase.
  serve_moe  the MoE and MLA families at full width, depth cut to one
           card (`MOE_CUTS`), one JSON line a part with its seconds and
           peak GB: (i) `moe_apply` at mixtral-8x22b's serve shape, at
           the config's capacity factor and at 0.5, forward and backward
           twice, bitwise equal, the dropped entries equal to a count
           from the router logits alone; (ii) mixtral-8x22b served at 1
           layer as `serve_dense` serves granite (K1, K7, K8; a miss, a
           hit), with torch.profiler spans over one adaptation and its
           decode; (iii) mixtral-8x22b (4 layers), jamba-v0.1-52b (one
           period of 8) and deepseek-v2-236b (the lead dense layer and
           one MoE layer): a 4,096-token prefill through
           `make_prefill_step` (K7, and K9 in jamba; deepseek's K7 at qk
           192 / value 128), the prefill -> decode handoff at capacity
           factor E/K in bf16 within twice the bf16 rounding spread (a
           4,608-token prompt past mixtral's window), and decode_32k's
           batch of 128 through `launch/serve.decode_steps` (K8 on
           mixtral's 4,096-slot ring and jamba's 32,768 slots; deepseek's
           absorbed MLA decode launches no kernel).
  serve_multimodal  the encoder-decoder and vision-prefix families at
           full width (`MM_ARCHS`), one JSON line a part with its seconds
           and peak GB: (i) seamless-m4t-medium at full depth: a
           4,096-token prefill over 1,024 frames through
           `make_prefill_step` (K7 36 times: 12 bidirectional encoder,
           12 causal and 12 cross-attention decoder layers), the
           prefill -> decode handoff of 4 tokens against the full
           forward in f32 (within 2e-3 + 2e-3·max|logits|) and bf16
           (within twice the bf16 spread); (ii) its launcher, 2 FOMAML
           steps of `launch/train.train` at train_4k's 4,096 tokens over
           1,024 frames, one client, the first of `MM_LAUNCH_SEQS`
           sequences that fits (K1 and K7 launched), one step traced;
           (iii) decode_32k through `launch/serve.decode_steps` at 3 of
           12 decoder layers (K7 at Lq = 1 and K8 once a layer a step),
           one step traced; (iv) qwen2-vl-7b at full depth: 1,024 patch
           embeddings + 3,072 text tokens prefilled (K7 28 times), the
           handoff of 4 tokens on the kernel route against the plain
           route (K7, K8 plain) within twice the bf16 spread; (v)
           decode_32k at 4 of 28 layers (K8 at G = 7).

  multi_device  the multi-device plane on the one card, in two worlds:
           (i) an NCCL world of 1 (a FileStore in a temp dir): the
           sharded FedMeta round (`client_axis="sharded"`, the packed
           client plane, FOMAML, m = 4, SmolLM-360M at full width) bitwise
           the vmap round from the same state (φ, Adam's m, v and step,
           the metrics), K1, K2 and K3 launched, one all-reduce of the
           (N,) partial and the metrics; deepseek-v2-236b's MoE layer at
           full width (160 experts of d_ff 1,536, top-6, 2 shared, bf16,
           4,096 tokens) through `ep_moe_apply` on the 1x1 mesh against
           `moe_apply` (within twice the bf16 spread; two runs bitwise;
           dropped entries against a count from the router logits); the
           training launcher (`launch/train.train`) on the 1x1 mesh with
           DTensor state, SmolLM-360M at train_4k's 4,096 tokens cut to 1
           client of 1 + 1 sequences, one FOMAML step from the state
           drawn shard by shard and one from an injected φ placed by
           `distribute`, each against the meshless step (loss, φ bitwise
           or within 2·lr plus a bf16 ulp) and the two bitwise equal, K7
           and K1 launched through `local_map` in each. (ii) Two spawned ranks on the
           one card over gloo (each rank's CUDA tensors staged through
           pinned host buffers; not an interconnect measurement): the
           sharded round at m = 5 (one zero-weight pad row) within the f32
           rule of the vmap round (meta-gradient at rtol 1e-5, φ within
           2·lr), each rank's K2 bitwise its plain version on the same
           rows, the expert-parallel layer with 80 experts a rank
           against `moe_apply`, and the launchers' shard-only init:
           SmolLM-360M's train state (`launch/train.train`) and decode
           weights and cache (`launch/serve.decode_state`) drawn shard by
           shard on 2x1 and 1x2 meshes, bitwise DTensor's own cut of the
           whole draw, then qwen2.5-3b's train state (30.86 GB whole)
           drawn shard by shard on the 2x1 mesh with each rank's peak
           allocated bytes printed against its shard and the whole state
           (at most the shard plus two of its largest unit leaf in f32);
           then, in a world on the backend `staged_gloo` (DTensor's
           collectives as `StagedGloo`, gloo on pinned host copies:
           gloo given CUDA tensors ends the process,
           `tools/probe_gloo_cuda.py`, and NCCL takes one rank a card),
           the launcher's SmolLM-360M step on the 1x2 mesh from the
           shard-only state against the meshless step (loss, φ bitwise
           or within 2·lr plus a bf16 ulp of the larger entry), K7 and
           K1 launched on each rank. Collective calls and bytes are printed.

`python3 chip_smoke.py --launch-cuts fomaml:2,fomaml:16,maml:2` runs no
phase: it builds the kernels and prints, for each cut `algo:S` (S
sequences of 4,096 tokens, half support and half query, one client),
one launcher step's ms, peak GB and launches, or that the card ran out
of memory. That is how `LAUNCH_CUT` was chosen.

Then it prints the card's name and power limit, one JSON line with every
kernel's numbers, and last `{"ok": true, "device": {...}}`. Any failed
phase exits nonzero.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # CUDA-core f32; dense bf16
L2_FLUSH_BYTES = 256 << 20       # five times the H100's 50 MB L2
L2_FLUSH_KERNEL = "bitwise_not"  # the flush's kernel, by name
_L2_FLUSH = []
REPLACES = {
    "inner_update_plane": "src/repro/kernels/meta_update/fused.py:115 "
                          "(_inner_plane_scalar_call), "
                          "src/repro/kernels/meta_update/fused.py:138 "
                          "(_inner_plane_vec_call)",
    "weighted_aggregate": "src/repro/kernels/meta_update/aggregate.py:80",
    "adam_flat": "src/repro/optim/fused_adam.py:58",
    "flash_attention": "src/repro/kernels/attention/flash_attention.py:101",
    "flash_decode": "src/repro/kernels/decode_attention/flash_decode.py:85",
    "int8_encode": "src/repro/kernels/meta_update/compress.py:157",
    "meta_update_flat": "src/repro/kernels/meta_update/fused.py:70",
    "trimmed_mean": "src/repro/kernels/meta_update/aggregate.py:271",
    "ssd_chunk": "src/repro/kernels/ssd/ssd_scan.py:62",
}
SOURCES = {
    "inner_update_plane": "src/repro_torch/kernels/csrc/inner_update.cu",
    "weighted_aggregate": "src/repro_torch/kernels/csrc/aggregate.cu",
    "adam_flat": "src/repro_torch/kernels/csrc/adam.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "int8_encode": "src/repro_torch/kernels/csrc/int8_encode.cu",
    "meta_update_flat": "src/repro_torch/kernels/csrc/inner_update.cu",
    "trimmed_mean": "src/repro_torch/kernels/csrc/trimmed_mean.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
}


class PhaseFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def time_ms(fn, torch, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush_buffer(torch):
    """The buffer `device_ms` rewrites before each timed call, made once."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                     device="cuda"))
    return _L2_FLUSH[0]


def per_call_us(prof) -> list:
    """Each call's device µs from a `device_ms` trace: the device events
    after one L2 flush, up to the next, summed. The profiler can drop
    events, which merges two calls or shortens one, so only the calls
    with the most common number of events are kept."""
    events = sorted((evt.time_range.start, evt.time_range.elapsed_us(),
                     L2_FLUSH_KERNEL in evt.name) for evt in prof.events()
                    if str(evt.device_type).endswith("CUDA"))
    calls = []                      # [events, µs] a call
    for _, us, is_flush in events:
        if is_flush:
            calls.append([0, 0.0])
        elif calls:
            calls[-1][0] += 1
            calls[-1][1] += us
    counts = [n for n, _ in calls if n > 0]
    if not counts:
        return []
    n = statistics.mode(counts)
    return [us for k, us in calls if k == n]


def device_ms(fn, torch, calls: int = 50, tries: int = 3,
              names=None) -> float:
    """Device time of one call of fn, from HBM: under torch.profiler
    recording the device only (as `_traced` does), the summed durations
    of the device activity (kernels, copies, fills) that a call launches,
    the median over `calls` calls. Host time is not in it. Before each
    call an in-place `bitwise_not_` over 256 MB evicts the 50 MB L2, so
    every call reads its operands from HBM, as `bound_ms` assumes; that
    kernel is left out by name and marks where a call starts
    (`per_call_us`). A block in which the profiler kept fewer than half
    the calls whole is traced again, up to `tries` times. `names`, a set
    if given, gets the names of the device activity traced."""
    from torch.profiler import ProfilerActivity, profile
    flush = l2_flush_buffer(torch)
    kept = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        kept = per_call_us(prof)
        if len(kept) >= calls // 2:
            if names is not None:
                names.update(evt.name[:80] for evt in prof.events()
                             if str(evt.device_type).endswith("CUDA")
                             and L2_FLUSH_KERNEL not in evt.name)
            return statistics.median(kept) / 1e3
    raise PhaseFailed(f"device_ms: {len(kept)} of {calls} calls traced "
                      f"whole in {tries} tries")


def device_times(torch, kernel, library=None, blocks: int = 4,
                 calls: int = 50) -> dict:
    """`device_ms` of the kernel and of its yardstick library call, each
    the median of `blocks` blocks of `calls` calls, timed in turns in
    this process on this card: kernel, library, library, kernel, ...
    Without a yardstick, `library_device_ms` is None. `library_kernels`
    names what the yardstick ran on the device (for SDPA, its
    backend)."""
    runs = {"device_ms": [], "library_device_ms": []}
    lib_names = set()
    for i in range(blocks):
        turn = [("device_ms", kernel), ("library_device_ms", library)]
        for key, fn in (turn if i % 2 == 0 else turn[::-1]):
            if fn is not None:
                runs[key].append(device_ms(
                    fn, torch, calls,
                    names=lib_names if key == "library_device_ms" else None))
    out = {key: statistics.median(v) if v else None
           for key, v in runs.items()}
    out["library_kernels"] = sorted(lib_names)
    return out


def library_time_ms(fn, torch):
    """Time of the yardstick library call, or None where this PyTorch
    build refuses it (the yardstick is never part of the port)."""
    try:
        return time_ms(fn, torch)
    except (RuntimeError, TypeError) as e:
        emit({"note": f"library call unavailable: {type(e).__name__}: {e}"})
        return None


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ------------------------------------------------------------------ phases

def phase_build(torch):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.get_ext()
    emit({"phase": "build", "ok": True,
          "build_s": time.perf_counter() - t0,
          "sources": [os.path.relpath(s, HERE) for s in _build.sources()],
          "cuda_flags": _build.CUDA_FLAGS})


BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
F32_ATOL = 1e-5


def closeness(out, plain, dt):
    """(max |out - plain|, the tolerance, the worst element's share of its
    limit; it passes at <= 1).

    bf16: kernel and plain version compute in f32, sum in different
    orders (a gap near 1e-6) and round to bf16, so an element may be one
    bf16 ulp of its own magnitude apart (at most 2^-7 |plain|) plus that
    f32 gap, held at 1e-4. f32: 1e-5 absolute."""
    d = (out.float() - plain.float()).abs()
    if dt == "bfloat16":
        limit = BF16_RTOL * plain.float().abs() + BF16_ATOL
        tol = f"per element: 2^-7*|plain| + {BF16_ATOL}"
    else:
        limit = F32_ATOL
        tol = f"absolute: {F32_ATOL}"
    return float(d.max()), tol, float((d / limit).max())


def check_k1(torch, n_plane: int):
    """K1 bitwise against its plain version at the full SmolLM-360M plane
    in its three α modes, each timed beside the one PyTorch call that
    computes θ − α∘g: `torch.sub(theta, g, alpha=a)` for a Python
    scalar, `torch.addcmul(theta, alpha, g, value=-1)` for a shared
    (N,) or a per-client (C, N) α."""
    from repro_torch.kernels.meta_update import fused, ref
    C, N = 4, n_plane
    gen = torch.Generator(device="cuda").manual_seed(11)
    theta = torch.randn((C, N), device="cuda", generator=gen)
    g = torch.randn((C, N), device="cuda", generator=gen)
    rows = []
    summary = None
    for mode in ("scalar", "shared", "per_client"):
        if mode == "scalar":
            alpha = 0.05
            library = lambda: torch.sub(theta, g, alpha=alpha)
            lib_name = "torch.sub(alpha=)"
        else:
            shape = (N,) if mode == "shared" else (C, N)
            alpha = torch.rand(shape, device="cuda", generator=gen) * 0.1
            library = lambda: torch.addcmul(theta, alpha, g, value=-1.0)
            lib_name = "torch.addcmul"
        out = theta.clone()
        fused.inner_update_plane(out, alpha, g)             # in place
        torch.cuda.synchronize()
        plain = ref.inner_update_plane_ref(theta, alpha, g)
        bitwise = bool(torch.equal(out, plain))
        err = float((out - plain).abs().max())
        del out, plain
        work = theta.clone()
        kernel = lambda: fused.inner_update_plane(work, alpha, g)
        ms = time_ms(kernel, torch)
        plain_ms = time_ms(lambda: ref.inner_update_plane_ref(theta, alpha, g),
                           torch)
        lib_ms = time_ms(library, torch)
        dev = device_times(torch, kernel, library)
        del work, kernel, library
        moved = nbytes(theta, g, theta) + (
            nbytes(alpha) if isinstance(alpha, torch.Tensor) else 0)
        b_ms, b_by = bound_ms(moved, 2.0 * C * N, "float32")
        row = {"name": "inner_update_plane", "case": f"C={C} N={N} alpha={mode}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "call_ms": ms, **dev, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": lib_name,
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if mode == "scalar":
            summary = row
        del alpha
        if not bitwise:
            raise PhaseFailed(f"K1 not bitwise equal to plain ({mode}): {err}")
    del theta, g
    torch.cuda.empty_cache()
    return rows, summary


def check_k2(torch, n_plane: int):
    """K2 against its plain version, bitwise: m = 4 at the full plane in
    f32 and bf16, m = 6 in f32 (the jittered staleness ring's block, m +
    delay·k), then m = 1, 7 and an int8 block at a small N, then the
    population plane's masked mean (`check_k2_masked`)."""
    from repro_torch.kernels.meta_update import aggregate
    gen = torch.Generator(device="cuda").manual_seed(12)
    small = 1 << 20
    rows, summary = [], None
    for m, N, dt in ((4, n_plane, "float32"), (4, n_plane, "bfloat16"),
                     (6, n_plane, "float32"),
                     (1, small, "float32"), (7, small, "float32"),
                     (4, small, "int8")):
        if dt == "int8":
            G = torch.randint(-127, 128, (m, N), device="cuda", generator=gen,
                              dtype=torch.int8)
        else:
            G = torch.randn((m, N), device="cuda", generator=gen).to(
                getattr(torch, dt))
        w = torch.rand((m,), device="cuda", generator=gen) + 0.1
        w = w / w.sum()
        out = aggregate.weighted_aggregate_flat(G, w)
        plain = aggregate.weighted_aggregate_ref(G, w)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(out, plain))
        err = float((out - plain).abs().max())
        del out, plain
        kernel = lambda: aggregate.weighted_aggregate_flat(G, w)
        library = None if dt == "int8" else (
            lambda: torch.mv(G.t(), w.to(G.dtype)))
        ms = time_ms(kernel, torch)
        plain_ms = time_ms(lambda: aggregate.weighted_aggregate_ref(G, w),
                           torch)
        lib_ms = None if library is None else library_time_ms(library, torch)
        dev = device_times(torch, kernel, library if lib_ms else None)
        b_ms, b_by = bound_ms(nbytes(G, w) + 4 * N, 2.0 * m * N, "float32")
        row = {"name": "weighted_aggregate", "case": f"m={m} N={N} {dt}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "call_ms": ms, **dev, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "torch.mv (cuBLAS GEMV)", "bound_ms": b_ms,
               "bound_by": b_by}
        rows.append(row)
        if summary is None:
            summary = row
        del G, w
        torch.cuda.empty_cache()
        if not bitwise:
            raise PhaseFailed(f"K2 not bitwise equal to plain: {row['case']} "
                              f"err {err}")
    rows.append(check_k2_masked(torch, n_plane, gen))
    return rows, summary


def check_k2_masked(torch, n_plane: int, gen):
    """The population plane's masked mean at the full plane: a (4, N)
    f32 block whose rows 1 and 3 carry weight 0 (clients that did not
    arrive), K2 and then the renormalization by Σw, bitwise equal to
    `masked_mean_ref` (the eager loop, then the same division)."""
    from repro_torch.kernels.meta_update import aggregate
    G = torch.randn((4, n_plane), device="cuda", generator=gen)
    # data counts of the two arrivals, unnormalized, so Σw is not 1
    w = torch.tensor([37.0, 0.0, 52.0, 0.0], device="cuda")
    out = aggregate.masked_mean_flat(G, w)
    plain = aggregate.masked_mean_ref(G, w)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, plain))
    err = float((out - plain).abs().max())
    del out, plain
    kernel = lambda: aggregate.masked_mean_flat(G, w)
    library = lambda: torch.mv(G.t(), w) / torch.sum(w)
    ms = time_ms(kernel, torch)
    plain_ms = time_ms(lambda: aggregate.masked_mean_ref(G, w), torch)
    lib_ms = library_time_ms(library, torch)
    dev = device_times(torch, kernel, library if lib_ms else None)
    b_ms, b_by = bound_ms(nbytes(G, w) + 4 * n_plane, 2.0 * 4 * n_plane
                          + n_plane, "float32")
    row = {"name": "weighted_aggregate",
           "case": f"masked mean m=4 N={n_plane} float32, rows 1 and 3 at "
                   "w = 0",
           "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
           "call_ms": ms, **dev, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "torch.mv (cuBLAS GEMV) / Σw", "bound_ms": b_ms,
           "bound_by": b_by}
    del G, w
    torch.cuda.empty_cache()
    if not bitwise:
        raise PhaseFailed(f"K2 masked mean not bitwise equal to "
                          f"masked_mean_ref: err {err}")
    return row


def check_k3(torch, n_plane: int):
    """K3 against its plain version, bitwise, at the full plane: f32 and
    bf16 moments, weight decay 0 and 0.01, at steps 1 and 1000."""
    from repro_torch.optim import fused_adam
    N = n_plane
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(13)
    phi = torch.randn((N,), device="cuda", generator=gen)
    g = torch.randn((N,), device="cuda", generator=gen)
    m32 = torch.randn((N,), device="cuda", generator=gen) * 1e-2
    v32 = torch.rand((N,), device="cuda", generator=gen) * 1e-3
    rows, summary = [], None
    for sd, wd, step in (("float32", 0.0, 1), ("float32", 0.01, 1000),
                         ("bfloat16", 0.0, 1), ("bfloat16", 0.01, 1000)):
        sdt = getattr(torch, sd)
        m, v = m32.to(sdt), v32.to(sdt)
        scales = fused_adam.adam_scales(
            torch.tensor(step, dtype=torch.int32, device="cuda"),
            hyper["b1"], hyper["b2"])
        kw = dict(hyper, wd=wd)
        p1, m1, v1 = phi.clone(), m.clone(), v.clone()
        fused_adam.adam_flat_pallas(p1, g, m1, v1, scales, **kw)
        pp, mp, vp = fused_adam.adam_flat_ref(phi, g, m, v, scales, **kw)
        mp, vp = mp.to(sdt), vp.to(sdt)
        torch.cuda.synchronize()
        bitwise = all(bool(torch.equal(a, b)) for a, b in
                      ((p1, pp), (m1, mp), (v1, vp)))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in ((p1, pp), (m1, mp), (v1, vp)))
        del pp, mp, vp
        kernel = lambda: fused_adam.adam_flat_pallas(p1, g, m1, v1, scales,
                                                     **kw)
        ms = time_ms(kernel, torch)
        plain_ms = time_ms(lambda: fused_adam.adam_flat_ref(
            phi, g, m, v, scales, **kw), torch)
        steps = [torch.tensor(float(step), device="cuda")]
        library = lambda: torch._fused_adam_(
            [p1], [g], [m1], [v1], [], steps, lr=kw["lr"], beta1=kw["b1"],
            beta2=kw["b2"], weight_decay=wd, eps=kw["eps"], amsgrad=False,
            maximize=False)
        lib_ms = library_time_ms(library, torch)
        dev = device_times(torch, kernel, library if lib_ms else None)
        itemsize = m.element_size()
        flops = (16.0 if wd > 0 else 14.0) * N
        b_ms, b_by = bound_ms(N * (4 + 4 + 2 * itemsize + 4 + 2 * itemsize),
                              flops, "float32")
        row = {"name": "adam_flat",
               "case": f"N={N} state={sd} wd={wd} step={step}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "call_ms": ms, **dev, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "torch._fused_adam_ (rounds differently)",
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if summary is None:
            summary = row
        del p1, m1, v1, m, v
        torch.cuda.empty_cache()
        if not bitwise:
            raise PhaseFailed(f"K3 not bitwise equal to plain: {row['case']} "
                              f"err {err}")
    del phi, g, m32, v32
    torch.cuda.empty_cache()
    return rows, summary


def _equal_all(torch, pairs) -> bool:
    return all(a.dtype == b.dtype and bool(torch.equal(a, b))
               for a, b in pairs)


def femnist_edge_block(torch, N: int):
    """(4, N) f32: a random row, a zero row, a row of half-integers
    (max 127, so s = 1) and the same over 32 (s = 2^-5): every product
    g·inv of rows 2 and 3 is an exact .5, which rounds half to even."""
    gen = torch.Generator(device="cuda").manual_seed(61)
    G = torch.zeros((4, N), device="cuda")
    G[0] = torch.randn((N,), device="cuda", generator=gen)
    half = torch.arange(N, device="cuda", dtype=torch.float32) % 254 - 126.5
    half[0] = 127.0
    G[2] = half
    G[3] = half / 32
    return G


def check_k6(torch, n_plane: int):
    """K6 against its plain version, bitwise (q, scales and residual):
    at the full SmolLM-360M plane (m = 4) and on a FEMNIST-width block
    with a zero row and exact .5 products; then K2 over the int8 block
    with the folded weights w·s, bitwise against its plain loop. K6's
    time is the kernel's (scales given); `wrapper_ms` adds the scales'
    row reduction."""
    from repro_torch.kernels._build import get_ext
    from repro_torch.kernels.meta_update import compress as k6
    ext = get_ext()
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows, summary, k2_rows = [], None, []
    for case, m, N in (("lm", 4, n_plane), ("femnist", 4, 461_824)):
        G = (torch.randn((m, N), device="cuda", generator=gen)
             if case == "lm" else femnist_edge_block(torch, N))
        q, s, r = k6.int8_encode_flat(G)
        qp, sp, rp = k6.int8_encode_ref(G)
        torch.cuda.synchronize()
        bitwise = _equal_all(torch, ((q, qp), (s, sp), (r, rp)))
        err = float((r - rp).abs().max())
        q_err = int((q.int() - qp.int()).abs().max())
        extra = {}
        if case == "femnist":
            want = torch.round(G[2])
            extra = {
                "zero_row_ok": bool(float(s[1]) == 0.0 and not q[1].any()
                                    and not r[1].any()),
                "half_to_even_ok": bool(
                    float(s[2]) == 1.0 and float(s[3]) == 2.0 ** -5
                    and torch.equal(q[2].float(), want)
                    and torch.equal(q[3], q[2])
                    and bool((want[1:] % 2 == 0).all()))}
        del qp, sp, rp
        kernel = lambda: ext.int8_encode(G, s, q, r)
        ms = time_ms(kernel, torch)
        dev = device_times(torch, kernel)
        plain_ms = time_ms(lambda: k6._quantize(G, s), torch)
        wrapper_ms = time_ms(lambda: k6.int8_encode_flat(G), torch)
        b_ms, b_by = bound_ms(nbytes(G, q, r, s), 5.0 * m * N, "float32")
        row = {"name": "int8_encode", "case": f"{case} m={m} N={N} f32",
               "bitwise_equal": bitwise, "max_abs_err": err,
               "max_q_diff": q_err, "tol": 0.0, "call_ms": ms, **dev,
               "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
               "library_ms": None,
               "library": "none (no single PyTorch call emits q and the "
                          "residual)",
               "bound_ms": b_ms, "bound_by": b_by, **extra}
        rows.append(row)
        if summary is None:
            summary = row
        if not bitwise or not all(extra.values()):
            raise PhaseFailed(f"K6 disagrees with plain: {row}")
        if case == "lm":
            # K2 over the int8 block, dequantization folded into w·s
            w = torch.rand((m,), device="cuda", generator=gen) + 0.1
            w = w / w.sum()
            out = k6.int8_aggregate_flat(q, s, w)
            plain = k6.int8_aggregate_ref(q, s, w)
            torch.cuda.synchronize()
            k2_bit = bool(torch.equal(out, plain))
            k2_err = float((out - plain).abs().max())
            del out, plain
            k2_kernel = lambda: k6.int8_aggregate_flat(q, s, w)
            k2_ms = time_ms(k2_kernel, torch)
            k2_dev = device_times(torch, k2_kernel)
            k2_plain = time_ms(lambda: k6.int8_aggregate_ref(q, s, w), torch)
            kb_ms, kb_by = bound_ms(nbytes(q, s, w) + 4 * N, 2.0 * m * N,
                                    "float32")
            k2_rows.append({
                "name": "weighted_aggregate",
                "case": f"int8 m={m} N={N}, weights w*s (int8 codec)",
                "bitwise_equal": k2_bit, "max_abs_err": k2_err, "tol": 0.0,
                "call_ms": k2_ms, **k2_dev, "plain_ms": k2_plain,
                "library_ms": None,
                "library": "none (int8 block)", "bound_ms": kb_ms,
                "bound_by": kb_by})
            if not k2_bit:
                raise PhaseFailed(f"K2 int8 (w*s) not bitwise: {k2_err}")
            del w
        del G, q, s, r
        torch.cuda.empty_cache()
    return rows + k2_rows, summary


def check_k4(torch, n_plane: int):
    """K4 (flat θ − α∘g, one client, (N,) α) against its plain version,
    bitwise, at the full SmolLM-360M plane."""
    from repro_torch.kernels.meta_update import fused, ref
    N = n_plane
    gen = torch.Generator(device="cuda").manual_seed(14)
    theta, g = (torch.randn((N,), device="cuda", generator=gen)
                for _ in range(2))
    alpha = torch.rand((N,), device="cuda", generator=gen) * 0.1
    out = fused.meta_update_flat(theta, alpha, g)
    plain = ref.meta_update_flat_ref(theta, alpha, g)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(out, plain))
    err = float((out - plain).abs().max())
    del out, plain
    kernel = lambda: fused.meta_update_flat(theta, alpha, g)
    library = lambda: torch.addcmul(theta, alpha, g, value=-1.0)
    ms = time_ms(kernel, torch)
    plain_ms = time_ms(lambda: ref.meta_update_flat_ref(theta, alpha, g),
                       torch)
    lib_ms = time_ms(library, torch)
    dev = device_times(torch, kernel, library)
    b_ms, b_by = bound_ms(nbytes(theta, alpha, g, theta), 2.0 * N, "float32")
    row = {"name": "meta_update_flat", "case": f"N={N} alpha=(N,) f32",
           "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
           "call_ms": ms, **dev, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "torch.addcmul", "bound_ms": b_ms, "bound_by": b_by}
    del theta, g, alpha
    torch.cuda.empty_cache()
    if not bitwise:
        raise PhaseFailed(f"K4 not bitwise equal to plain: {err}")
    return [row], row


def same_bits_or_nonfinite(torch, a, b) -> bool:
    """Bitwise equal where finite (−0 and +0 told apart), with NaN and
    ±inf at the same positions."""
    fa = torch.isfinite(a)
    return (torch.equal(fa, torch.isfinite(b))
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.where(torch.isinf(a), a, 0.0),
                            torch.where(torch.isinf(b), b, 0.0))
            and torch.equal(a[fa].view(torch.int32),
                            b[fa].view(torch.int32)))


def adversarial_block(torch, m, N, gen):
    """(m, N) f32, m >= 8: rows ×−1000 (1) and ×1000 (6), a NaN row (4)
    and row 7 a copy of row 3, for the first-index tie-break (the rows
    of the reference's tests/test_faults.py:176-200, plus the tie)."""
    G = torch.randn((m, N), device="cuda", generator=gen)
    G[1] *= -1000.0
    G[6] *= 1000.0
    G[4] = float("nan")
    G[7] = G[3]
    return G


# (m, live, trim) of the degenerate rounds: what the reference's kernel
# gives there (ROADMAP Queue 3) — the middle value, NaN and ±inf (x/0),
# the live row itself, zeros, NaN (sentinels overflow)
K5_DEGENERATE = (("one_dead", 4, (1, 1, 1, 0), 1),
                 ("two_live", 4, (1, 1, 0, 0), 1),
                 ("one_live", 4, (1, 0, 0, 0), 1),
                 ("none_live", 4, (0, 0, 0, 0), 1),
                 ("none_live_trim2", 8, (0,) * 8, 2))


def check_k5(torch, n_plane: int):
    """K5 against its plain version (`trimmed_mean_plain`), bitwise: at
    the full SmolLM-360M plane (m = 4, trim 1, a NaN row made dead by
    `row_liveness`) in f32 and bf16; on the FEMNIST block (8, 461,824),
    trim 2, with adversarial rows and a tie; on the staleness block of
    the trimmed kill-and-resume cell (4, 461,824), trim 1, its ring row
    at weight 0; on the degenerate rounds
    (bitwise where finite, NaN and ±inf in place); and at m = 20 and 17
    (the generic loop). `plain_ms` is the "torch" route, the sort-based
    `trimmed_mean_ref`; `plain_literal_ms` the plain version K5 equals."""
    from repro_torch.kernels.meta_update import aggregate as k5
    gen = torch.Generator(device="cuda").manual_seed(15)
    small = 1 << 20
    rows, summary = [], None
    cases = [("lm", 4, n_plane, "float32", 1), ("lm", 4, n_plane,
                                                "bfloat16", 1),
             ("femnist", 8, 461_824, "float32", 2),
             ("ring", 4, 461_824, "float32", 1),
             ("generic", 20, small, "float32", 3),
             ("generic", 17, small, "bfloat16", 4)]
    cases += [(f"degenerate {name}", m, 8192, "float32", trim)
              for name, m, _, trim in K5_DEGENERATE]
    degenerate = {f"degenerate {name}": live
                  for name, _, live, _ in K5_DEGENERATE}
    for case, m, N, dt, trim in cases:
        if case == "femnist":
            G = adversarial_block(torch, m, N, gen)
        else:
            G = torch.randn((m, N), device="cuda", generator=gen)
        if case == "lm":
            G[2] = float("nan")
        elif case == "generic":
            G[5] = float("nan")
            G[m - 2] = G[2]
        w = torch.ones((m,), device="cuda")
        if case == "ring":
            w[m - 1] = 0.0          # the ring's row before it arrives
        if case in degenerate:
            live = torch.tensor(degenerate[case], dtype=torch.float32,
                                device="cuda")
            G[live == 0] = float("nan")
        else:
            live = k5.row_liveness(G, w)
        G = G.to(getattr(torch, dt))
        out = k5.trimmed_mean_flat(G, live, trim=trim)
        plain = k5.trimmed_mean_plain(G, live, trim=trim)
        torch.cuda.synchronize()
        same = same_bits_or_nonfinite(torch, out, plain)
        fin = torch.isfinite(plain)
        err = float((out[fin] - plain[fin]).abs().max()) if fin.any() else 0.0
        row = {"name": "trimmed_mean", "case": f"{case} m={m} N={N} {dt} "
               f"trim={trim} live={[int(x) for x in live.tolist()]}",
               "bitwise_equal": same, "max_abs_err": err, "tol": 0.0,
               "nonfinite_share": float((~fin).float().mean()),
               "library_ms": None,
               "library": "none (no single PyTorch call computes a "
                          "coordinate-wise trimmed mean)"}
        del out, plain
        if case in ("lm", "femnist", "ring", "generic"):
            kernel = lambda: k5.trimmed_mean_flat(G, live, trim=trim)
            row["call_ms"] = time_ms(kernel, torch)
            row.update(device_times(torch, kernel))
            row["plain_ms"] = time_ms(lambda: k5.trimmed_mean_ref(
                G, live, trim=trim), torch)
            row["plain_route"] = "torch.sort + masked sum (impl='torch')"
            if case != "generic":
                row["plain_literal_ms"] = time_ms(lambda: k5.trimmed_mean_plain(
                    G, live, trim=trim), torch)
            flops = N * (m + 2.0 * trim * (m + 1) + 3)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes(G, live) + 4 * N, flops, "float32")
        rows.append(row)
        if summary is None:
            summary = row
        del G, w, live
        torch.cuda.empty_cache()
        if not same:
            raise PhaseFailed(f"K5 disagrees with plain: {row}")
    return rows, summary


def attention_pairs(Lq, Lk, causal, window, q_offset):
    qpos = [i + q_offset for i in range(Lq)]
    n = 0
    for qp in qpos:
        hi = min(Lk - 1, qp) if causal else Lk - 1
        lo = max(0, qp - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def attention_mask(torch, Lq, Lk, causal, window, q_offset):
    """(Lq, Lk) boolean mask, True where a query attends a key: the mask
    the kernel computes from absolute positions."""
    qpos = torch.arange(Lq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(Lk, device="cuda")[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def check_k7(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops as attn_ops
    cases = [  # (B, H, Kv, L, hd, hd_v, dtype, causal, window, q_offset)
        (4, 15, 5, 64, 64, 64, "bfloat16", True, None, 0),   # adapt forward
        (4, 15, 5, 128, 64, 64, "bfloat16", True, None, 0),  # the LM round
        (1, 15, 5, 64, 64, 64, "bfloat16", True, None, 0),   # prefill
        (16, 15, 5, 64, 64, 64, "bfloat16", True, None, 0),  # the serve
        # phase's prefill of 16 requests, folded into one launch
        (4, 15, 5, 100, 64, 64, "bfloat16", True, None, 0),  # ragged tile
        (4, 15, 5, 64, 64, 64, "bfloat16", True, 16, 0),     # sliding window
        (2, 6, 2, 100, 64, 32, "float32", True, None, 3),    # q_offset, hd_v
        (2, 15, 5, 1, 64, 64, "bfloat16", True, None, 0),    # one token
        (2, 8, 8, 40, 128, 128, "bfloat16", False, None, 0),  # hd 128, no mask
        (2, 8, 1, 70, 128, 64, "bfloat16", True, 20, 5),     # G = 8, hd_v < hd
        (2, 6, 2, 50, 40, 24, "bfloat16", True, None, 0),    # element staging
        (4, 2, 1, 16, 32, 32, "float32", True, None, 0),     # the lm scenario
        (LAUNCH_CUT["fomaml"][0] // 2, 15, 5, 4096, 64, 64, "bfloat16",
         True, None, 0),                         # the launcher at L=4096
        (2, 16, 2, 64, 128, 128, "bfloat16", True, None, 0),  # qwen2.5 adapt
        # and its serve's prefill of 2 requests
        (2, 32, 8, 64, 64, 64, "bfloat16", True, None, 0),  # granite's
        # serve: prefill of 2 requests, folded
        (2, 48, 8, 64, 128, 128, "bfloat16", True, 4096, 0),  # mixtral adapt
        # and its serve's prefill of 2 requests
        (1, 48, 8, 4608, 128, 128, "bfloat16", True, 4096, 0),  # mixtral
        # handoff prompt, past the window
        (1, 32, 8, 4096, 128, 128, "bfloat16", True, None, 0),  # jamba prefill
        (1, 128, 128, 4096, 192, 128, "bfloat16", True, None, 0),  # deepseek
        # MLA prefill: <192, 128>
        (2, 8, 8, 130, 192, 128, "bfloat16", False, None, 0),  # <192, 128>,
        # ragged tile, no mask
        (2, 4, 2, 100, 192, 128, "float32", True, 20, 3),  # f32 at hd 192
        (1, 28, 4, 4096, 128, 128, "bfloat16", True, None, 0),  # qwen2-vl
        # prefill: G = 7, 1,024 patches + 3,072 text tokens
        (1, 16, 16, 1024, 64, 64, "bfloat16", False, None, 0),  # seamless
        # encoder over 1,024 frames, bidirectional
        (1, 16, 16, 4096, 64, 64, "bfloat16", True, None, 0),  # seamless
        # decoder self-attention
        (1, 16, 16, 4096, 64, 64, "bfloat16", False, None, 0, 1024),  # its
        # cross-attention: 4,096 text tokens over 1,024 frames
        (128, 16, 16, 1, 64, 64, "bfloat16", False, None, 0, 1024),  # the
        # decode step's cross-attention at decode_32k's batch: Lq = 1
    ]
    rows, summary = [], None
    gen = torch.Generator(device="cuda").manual_seed(7)
    for case in cases:
        B, H, Kv, L, hd, hdv, dt, causal, window, qoff = case[:10]
        # keys: L + q_offset, or a length of their own (cross-attention)
        Lk = case[10] if len(case) > 10 else L + qoff
        dtype = getattr(torch, dt)
        q = torch.randn((B, L, H, hd), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, Lk, Kv, hd), device="cuda",
                        generator=gen).to(dtype)
        v = torch.randn((B, Lk, Kv, hdv), device="cuda",
                        generator=gen).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=qoff)
        out = attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
        plain = attn_ops.flash_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        err, tol, worst = closeness(out, plain, dt)
        kernel = lambda: attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
        ms = time_ms(kernel, torch)
        plain_ms = time_ms(lambda: attn_ops.flash_attention(
            q, k, v, impl="torch", **kw), torch)
        # SDPA's own causal flag where it means the same mask (q_offset 0,
        # no window), else the kernel's mask given explicitly
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        own_causal = causal and window is None and qoff == 0
        mask = (None if own_causal or not (causal or window)
                else attention_mask(torch, L, Lk, causal, window, qoff))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=own_causal, enable_gqa=True)
        backend = sdpa_backend(torch, sdpa) if hd > 128 else None
        library = (sdpa if backend is None
                   else lambda: backend_call(torch, backend, sdpa))
        lib_ms = library_time_ms(library, torch)
        dev = device_times(torch, kernel, library if lib_ms else None)
        pairs = attention_pairs(L, Lk, causal, window, qoff)
        flops = 2.0 * B * H * pairs * (hd + hdv)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out), flops, dt)
        lk = "" if Lk == L + qoff else f" Lk={Lk}"
        row = {"name": "flash_attention",
               "case": f"B={B} H={H} Kv={Kv} L={L}{lk} hd={hd} hd_v={hdv} "
                       f"{dt} causal={causal} window={window} "
                       f"q_offset={qoff}",
               "max_abs_err": err, "tol": tol, "worst_of_limit": worst,
               "call_ms": ms, **dev, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention"
                          + (f" ({backend})" if backend else ""),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if summary is None:
            summary = row
        del q, k, v, out, plain, qt, kt, vt
        torch.cuda.empty_cache()
        if not worst <= 1.0:
            raise PhaseFailed(f"K7 disagrees with plain: {row['case']} "
                              f"err {err}, {worst} of the limit ({tol})")
    rows += check_k7_kv_length(torch, gen)
    rows.append(check_k7_refuses(torch))
    return rows, summary


SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def backend_call(torch, name, fn):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([getattr(SDPBackend, name)]):
        return fn()


def sdpa_backend(torch, fn):
    """The first SDPA backend (in `SDPA_BACKENDS`' order) that takes
    this call, e.g. one with a value dim other than the qk dim; None if
    none does."""
    for name in SDPA_BACKENDS:
        try:
            backend_call(torch, name, fn)
            torch.cuda.synchronize()
            return name
        except RuntimeError:
            continue
    return None


def check_k7_refuses(torch):
    """On CUDA tensors K7 launches or raises: a bf16 qk dim of 256 (past
    `flash_attention_mma_kernel<192, 128>`) raises in the wrapper,
    launches nothing and never falls back to the plain version."""
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.attention import ops as attn_ops
    q = torch.zeros((1, 8, 2, 256), device="cuda", dtype=torch.bfloat16)
    before = k7.launches
    try:
        attn_ops.flash_attention(q, q, q, impl="cuda")
        raised = ""
    except ValueError as e:
        raised = str(e).splitlines()[0]
    torch.cuda.synchronize()
    row = {"name": "flash_attention", "case": "bf16 hd 256 refused",
           "raised": raised, "k7_launches": k7.launches - before}
    if not raised or row["k7_launches"]:
        raise PhaseFailed(f"K7 at hd 256: {row}")
    return row


def check_k7_kv_length(torch, gen):
    """Ragged kv_length on the card: `ops.flash_attention(impl="cuda")`
    sends it to the oracle, as the reference does under every impl, so
    it must equal impl="torch" bit for bit, launch no K7, and give 0 on
    a row with kv_length 0 (the oracle's guard)."""
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.attention import ops as attn_ops
    B, H, Kv, L, hd = 4, 15, 5, 64, 64
    q = torch.randn((B, L, H, hd), device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn((B, L, Kv, hd), device="cuda", generator=gen
                        ).bfloat16() for _ in range(2))
    rows = []
    for label, kvl in (("(B,) with a 0 row", torch.tensor(
            [0, 17, 64, 40], dtype=torch.int32, device="cuda")),
                       ("scalar", 33)):
        before = k7.launches
        out = attn_ops.flash_attention(q, k, v, causal=False, kv_length=kvl,
                                       impl="cuda")
        plain = attn_ops.flash_attention(q, k, v, causal=False,
                                         kv_length=kvl, impl="torch")
        torch.cuda.synchronize()
        row = {"name": "flash_attention",
               "case": f"kv_length {label} B={B} H={H} Kv={Kv} L={L} "
                       f"hd={hd} bfloat16 causal=False",
               "bitwise_equal": bool(torch.equal(out, plain)),
               "max_abs_err": float((out.float() - plain.float()).abs().max()),
               "k7_launches": k7.launches - before,
               "on_card": bool(out.is_cuda)}
        if label != "scalar":
            row["zero_row_is_zero"] = not bool(out[0].any())
        rows.append(row)
        if not (row["bitwise_equal"] and row["on_card"]
                and row["k7_launches"] == 0
                and row.get("zero_row_is_zero", True)):
            raise PhaseFailed(f"K7 kv_length route: {row}")
    return rows


def device_kernels_a_call(torch, fn, calls: int = 20, tries: int = 3):
    """(device events a call, {name: median device µs}) of the kernels,
    copies and fills that one call of fn launches, traced as `device_ms`
    traces: an L2 flush before each call marks where it starts, and the
    calls with the most common number of events are kept (the profiler
    can drop events); traced again if it kept none."""
    from torch.profiler import ProfilerActivity, profile
    flush = l2_flush_buffer(torch)
    per_call = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        per_call = []
        for _, name, us in sorted(
                (evt.time_range.start, evt.name, evt.time_range.elapsed_us())
                for evt in prof.events()
                if str(evt.device_type).endswith("CUDA")):
            if L2_FLUSH_KERNEL in name:
                per_call.append([])
            elif per_call:
                per_call[-1].append((name, us))
        if any(per_call):
            break
    counts = [len(c) for c in per_call if c]
    if not counts:
        return 0, {}
    n = statistics.mode(counts)
    by_name = {}
    for c in per_call:
        if len(c) == n:
            for name, us in c:
                by_name.setdefault(name, []).append(us)
    return n, {name: statistics.median(v) for name, v in by_name.items()}


def check_k8(torch):
    """K8 against its plain version at the decode step's shapes, a long
    cache split across blocks, ragged lengths, and rows with kv_length 0
    (held against the mean of V over all C slots, the reference kernel's
    answer; the plain version gives NaN there). A Python-int kv_length
    is the decode path's route: one call must launch K8 and nothing
    else. SDPA is the yardstick, with no mask where every slot is valid."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.decode_attention import ops as dec_ops
    cases = [  # (B, C, Kv, G, hd, dtype, kv_length)
        (16, 64, 5, 3, 64, "bfloat16", "int"),         # the serving decode
        # step of 16 requests, folded into one launch
        (1, 64, 5, 3, 64, "bfloat16", "int"),          # one request's step
        (16, 48, 5, 3, 64, "bfloat16", "ragged"),
        (16, 100, 5, 3, 64, "bfloat16", "ragged"),
        (4, 100, 2, 4, 64, "float32", "ragged"),
        (3, 1, 5, 3, 64, "bfloat16", "int"),           # one slot
        (4, 33, 1, 8, 128, "bfloat16", "ragged"),      # G = 8, hd 128, ragged tile
        (1, 32768, 5, 3, 64, "bfloat16", "int"),       # long cache, split
        (16, 4096, 5, 3, 64, "bfloat16", "ragged"),    # split, dead splits
        (4, 4096, 5, 3, 64, "bfloat16", "zero_row"),   # a 0 row through the combine
        (4, 100, 2, 4, 64, "float32", "zero_row"),     # a 0 row, one split
        (1, 64, 2, 8, 128, "bfloat16", "int"),         # qwen2.5's decode step
        (2, 64, 2, 8, 128, "bfloat16", "int"),         # qwen2.5's serve:
        # 2 requests folded
        (2, 64, 8, 4, 64, "bfloat16", "int"),          # granite's serve
        (2, 64, 8, 6, 128, "bfloat16", "int"),         # mixtral's serve
        (1, 64, 8, 6, 128, "bfloat16", "int"),         # mixtral's traced
        # request, a group of one
        (4, 64, 5, 3, 64, "bfloat16", "int"),          # the trace's 4
        # SmolLM requests folded
        (128, 4096, 8, 6, 128, "bfloat16", "int"),     # mixtral's ring at
        # decode_32k
        (128, 32768, 8, 4, 128, "bfloat16", "int"),    # jamba at decode_32k
        (128, 32768, 4, 7, 128, "bfloat16", "int"),    # qwen2-vl at
        # decode_32k: G = 7 on the kG = 8 kernel, one dead row
        (4, 4096, 4, 7, 128, "bfloat16", "ragged"),    # G = 7 through the
        # combine (16 splits)
        (128, 32768, 16, 1, 64, "bfloat16", "int"),    # seamless at
        # decode_32k: G = 1, hd 64 (mma.sync)
    ]
    rows, summary = [], None
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, C, Kv, G, hd, dt, lengths) in cases:
        dtype = getattr(torch, dt)
        H = Kv * G
        q = torch.randn((B, H, hd), device="cuda", generator=gen).to(dtype)
        kc = torch.randn((B, C, Kv, hd), device="cuda", generator=gen).to(dtype)
        vc = torch.randn((B, C, Kv, hd), device="cuda", generator=gen).to(dtype)
        if lengths == "int":
            kvl = C
            kvl_t = torch.full((B,), C, device="cuda", dtype=torch.int32)
        else:
            kvl = torch.randint(1, C + 1, (B,), device="cuda", generator=gen,
                                dtype=torch.int32)
            if lengths == "zero_row":
                kvl[0] = 0
            kvl_t = kvl
        # the plain version row block by row block past 2 GB of cache, so
        # its f32 copies of the caches stay small (rows are independent)
        rows_a_call = max(1, B * (2 << 30) // max(nbytes(kc), 1))
        plain_fn = lambda: torch.cat([dec_ops.decode_attention(
            q[i:i + rows_a_call], kc[i:i + rows_a_call],
            vc[i:i + rows_a_call],
            kvl if isinstance(kvl, int) else kvl[i:i + rows_a_call],
            impl="torch") for i in range(0, B, rows_a_call)])
        out = dec_ops.decode_attention(q, kc, vc, kvl, impl="cuda")
        plain = plain_fn()
        torch.cuda.synchronize()
        live = slice(1, None) if lengths == "zero_row" else slice(None)
        err, tol, worst = closeness(out[live], plain[live], dt)
        zero_row = None
        if lengths == "zero_row":
            mean_v = vc[0].float().mean(0).repeat_interleave(G, 0).to(dtype)
            z_err, _, z_worst = closeness(out[0], mean_v, dt)
            zero_row = {"max_abs_err": z_err, "worst_of_limit": z_worst,
                        "plain_finite": bool(torch.isfinite(plain[0]).all())}
            err, worst = max(err, z_err), max(worst, z_worst)
        kernel = lambda: dec_ops.decode_attention(q, kc, vc, kvl, impl="cuda")
        per_call, one_call = device_kernels_a_call(torch, kernel)
        ms = time_ms(kernel, torch)
        plain_ms = time_ms(plain_fn, torch)
        qt = q[:, :, None]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = (None if lengths == "int" else
                (torch.arange(C, device="cuda")[None, :]
                 < kvl_t[:, None])[:, None, None, :])
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_ms = library_time_ms(library, torch)
        dev = device_times(torch, kernel, library if lib_ms else None)
        # slots read: the valid ones, every slot of a 0 row
        valid = int(torch.where(kvl_t > 0, kvl_t.clamp(max=C), C).sum())
        elem = q.element_size()
        moved = (nbytes(q, out) + 2 * valid * Kv * hd * elem
                 + (0 if lengths == "int" else nbytes(kvl_t)))
        flops = 2.0 * H * valid * (hd + hd)
        b_ms, b_by = bound_ms(moved, flops, dt)
        row = {"name": "flash_decode",
               "case": f"B={B} C={C} Kv={Kv} G={G} hd={hd} {dt} "
                       f"kv_length={lengths}",
               "plain_rows_a_call": min(rows_a_call, B),
               "splits": k8.splits_for(kc, kvl),
               "max_abs_err": err, "tol": tol, "worst_of_limit": worst,
               "device_events_a_call": per_call,
               "device_us_by_kernel": one_call,
               "call_ms": ms, **dev, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention"
                          + ("" if mask is None else " (bool mask)"),
               "bound_ms": b_ms, "bound_by": b_by}
        if zero_row:
            row["zero_row_vs_mean_v"] = zero_row
        rows.append(row)
        if summary is None:
            summary = row
        del q, kc, vc, out, plain, kt, vt
        torch.cuda.empty_cache()
        if not worst <= 1.0:
            raise PhaseFailed(f"K8 disagrees with plain: {row['case']} "
                              f"err {err}, {worst} of the limit ({tol})")
        # an int kv_length launches K8 and nothing else: no fill
        if lengths == "int" and row["splits"] == 1 and not (
                per_call == 1 and all("flash_decode" in name
                                      for name in one_call)):
            raise PhaseFailed(f"K8 with an int kv_length launched {one_call} "
                              f"({per_call} device events a call), not K8 "
                              f"alone")
    return rows, summary


U32 = 2.0 ** -24                 # f32 unit roundoff


def ssd_inputs(torch, gen, B, nh, L, hp, N, dt_scale=1.0):
    """Mamba2-like SSD inputs (the reference test's draws,
    `tests/test_kernels_ssd.py:11-18`) in the models' (B, L, nh, ·)
    layout: x, dt (softplus), A < 0, Bm, Cm."""
    dev = dict(device="cuda", generator=gen)
    x = torch.randn((B, L, nh, hp), **dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, nh), **dev) * 0.5 - 1.0) * dt_scale
    A = -torch.exp(torch.randn((nh,), **dev) * 0.3)
    Bm = torch.randn((B, L, N), **dev)
    Cm = torch.randn((B, L, N), **dev)
    return x, dt, A, Bm, Cm


def ssd_f64_oracle(torch, xdt, a, Bm, Cm, chunk):
    """K9's function in float64 on the same f32 inputs, and the
    per-element bounds a float32 evaluation must meet (u = 2^-24):

      |y - y64| <= ((Q + N + 2) u + eps_D) ((|C| |B|^T ⊙ D) @ |xdt|)
      |S - S64| <= ((Q + 2) u + eps_D) ((|B| ⊙ sd)^T @ |xdt|)

    Q + N + 2: the N-term dot C·B, the product with the decay D, the
    product with xdt and the Q-term sum over j (sd's product with B is
    the second rounding of S). eps_D = expm1(((2Q + 1) |cum_last| + 2) u)
    bounds the relative error of each computed decay exp(cum_i - cum_j):
    each f32 cumsum is off by at most Q u |cum_last| in any summation
    order (every a <= 0, so no partial sum exceeds |cum_last|), the
    difference rounds once more and exp adds at most 2 ulp. The two
    relative errors compound: the limit's factor is (1 + γ)(1 + eps_D) − 1
    with γ the rounding count times u."""
    B, nh, L, hp = xdt.shape
    N = Bm.shape[-1]
    Q, nc = chunk, L // chunk
    x = xdt.double().reshape(B, nh, nc, Q, hp)
    cum = torch.cumsum(a.double().reshape(B, nh, nc, Q), dim=-1)
    Bc = Bm.double().reshape(B, 1, nc, Q, N)
    Cc = Cm.double().reshape(B, 1, nc, Q, N)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    D = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                              float("-inf")))
    sd = torch.exp(cum[..., -1:] - cum)
    y = torch.matmul(torch.matmul(Cc, Bc.transpose(-1, -2)) * D, x)
    S = torch.matmul((Bc * sd[..., None]).transpose(-1, -2), x)
    ymag = torch.matmul(torch.matmul(Cc.abs(), Bc.abs().transpose(-1, -2)) * D,
                        x.abs())
    Smag = torch.matmul((Bc.abs() * sd[..., None]).transpose(-1, -2), x.abs())
    eps_d = torch.expm1(((2 * Q + 1) * cum[..., -1].abs() + 2) * U32
                        )[..., None, None]                 # (B, nh, nc, 1, 1)
    y_lim = ((1 + (Q + N + 2) * U32) * (1 + eps_d) - 1) * ymag
    S_lim = ((1 + (Q + 2) * U32) * (1 + eps_d) - 1) * Smag
    return (y.reshape(B, nh, L, hp), S, y_lim.reshape(B, nh, L, hp), S_lim)


def ssd_library_chain(torch, Bm, Cm, xdt, chunk):
    """The yardstick: the plain version's batched matmuls alone (C Bᵀ
    once per (b, c), then the (Q, Q) @ (Q, hp) and (N, Q) @ (Q, hp)
    products per head), no cumsum, decay or mask. The port never calls
    it."""
    B, nh, L, hp = xdt.shape
    N, nc = Bm.shape[-1], L // chunk
    Bc = Bm.reshape(B, 1, nc, chunk, N)
    Cc = Cm.reshape(B, 1, nc, chunk, N)
    x = xdt.reshape(B, nh, nc, chunk, hp)

    def run():
        cb = torch.matmul(Cc, Bc.transpose(-1, -2))
        return torch.matmul(cb, x), torch.matmul(Bc.transpose(-1, -2), x)
    return run


# (name, B, nh, L, hp, N, chunk, dt_scale): Mamba2-370M's prefill at full
# width (8 chunks), the adaptation's shape, the round's (4 clients), the
# served prefill (one prompt, two chunks; the serve's 16 and the trace's
# 4 prompts folded into one launch), an odd chunk, and an input whose
# above-diagonal decay overflows f32 exp (dt·|A| ≈ 9 a step)
K9_CASES = (("prefill", 4, 32, 1024, 64, 128, 128, 1.0),
            ("adapt", 2, 32, 128, 64, 128, 128, 1.0),
            ("round", 4, 32, 128, 64, 128, 128, 1.0),
            ("served prefill", 1, 32, 256, 64, 128, 128, 1.0),
            ("served prefill, 16 requests folded", 16, 32, 256, 64, 128,
             128, 1.0),
            ("traced prefill, 4 requests folded", 4, 32, 256, 64, 128, 128,
             1.0),
            ("odd chunk", 2, 32, 200, 64, 128, 100, 1.0),
            ("overflow", 1, 32, 256, 64, 128, 128, 30.0))


def check_k9(torch):
    """K9 and its plain version (`ssd_intra_chunk_plain`), each held
    against the float64 oracle at the derived per-element bound
    (`ssd_f64_oracle`), at the paths' shapes, in the layout
    `ops.ssd_chunked` hands the kernel (transposed views of (B, L, nh, ·)
    buffers). On the overflow input the chunked oracle
    (`ssd_chunked_ref`, a product with a 0/1 mask) must give NaN and K9
    stay finite. Bound: the larger of the bytes (each operand once) over
    3.35 TB/s and the function's least work — C Bᵀ once per (b, c),
    2Q²N, plus 2Q²hp + 2QN·hp per (b, h, c) — over 67 TFLOP/s (f32);
    `bound_ms_kernel_work` counts C Bᵀ per head, as the TPU kernel
    computes it (K9 computes it once per (b, c))."""
    from repro_torch.kernels.ssd import ref, ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, summary = [], None
    for name, B, nh, L, hp, N, Q, dt_scale in K9_CASES:
        x, dt, A, Bm, Cm = ssd_inputs(torch, gen, B, nh, L, hp, N, dt_scale)
        xdt = (x * dt[..., None]).transpose(1, 2)        # (B, nh, L, hp)
        a = (dt * A[None, None, :]).transpose(1, 2)      # (B, nh, L)
        with torch.no_grad():
            y, S = ssd_scan.ssd_intra_chunk(xdt, a, Bm, Cm, chunk=Q)
            yp, Sp = ref.ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=Q)
            y64, S64, y_lim, S_lim = ssd_f64_oracle(torch, xdt, a, Bm, Cm, Q)
        torch.cuda.synchronize()

        def worst(out):
            dy = (out[0].double() - y64).abs()
            dS = (out[1].double() - S64).abs()
            return (max(float(dy.max()), float(dS.max())),
                    max(float((dy / y_lim).max()), float((dS / S_lim).max())))
        err, share = worst((y, S))
        err_p, share_p = worst((yp, Sp))
        finite = bool(torch.isfinite(y).all() and torch.isfinite(S).all())
        row = {"name": "ssd_chunk",
               "case": f"{name} B={B} nh={nh} L={L} hp={hp} N={N} Q={Q}",
               "max_abs_err": err, "worst_of_limit": share,
               "plain_max_abs_err": err_p, "plain_worst_of_limit": share_p,
               "kernel_minus_plain_max": float(torch.maximum(
                   (y - yp).abs().max(), (S - Sp).abs().max())),
               "tol": "per element vs float64: ((1+(Q+N+2)u)(1+eps_D)-1)"
                      "·((|C||B|ᵀ⊙D)@|xdt|) for y, ((1+(Q+2)u)(1+eps_D)-1)"
                      "·((|B|⊙sd)ᵀ@|xdt|) for S; u = 2^-24, eps_D = "
                      "expm1(((2Q+1)|cum_last| + 2)u)",
               "finite": finite}
        del yp, Sp, y64, S64, y_lim, S_lim
        if name == "overflow":
            oracle = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, Q)
            row["chunked_oracle_nan"] = bool(torch.isnan(oracle).any())
            del oracle
        else:
            with torch.no_grad():
                kernel = lambda: ssd_scan.ssd_intra_chunk(xdt, a, Bm, Cm,
                                                          chunk=Q)
                library = ssd_library_chain(torch, Bm, Cm, xdt.contiguous(),
                                            Q)
                row["call_ms"] = time_ms(kernel, torch)
                row["plain_ms"] = time_ms(lambda: ref.ssd_intra_chunk_plain(
                    xdt, a, Bm, Cm, chunk=Q), torch)
                row["library_ms"] = library_time_ms(library, torch)
                row.update(device_times(
                    torch, kernel, library if row["library_ms"] else None))
            row["library"] = ("torch.matmul chain: C Bᵀ, (C Bᵀ) @ xdt, Bᵀ @ "
                              "xdt, batched over (b, h, c), f32, no decay")
            nc = L // Q
            per_head = 2.0 * Q * Q * hp + 2.0 * Q * N * hp
            least = B * nc * 2.0 * Q * Q * N + B * nh * nc * per_head
            kernel_work = B * nh * nc * (2.0 * Q * Q * N + per_head)
            moved = nbytes(xdt, a, Bm, Cm, y, S)
            row["bound_ms"], row["bound_by"] = bound_ms(moved, least,
                                                        "float32")
            row["bound_ms_kernel_work"] = bound_ms(moved, kernel_work,
                                                   "float32")[0]
            row["gflop_least"], row["mbytes"] = least / 1e9, moved / 1e6
        rows.append(row)
        if summary is None:
            summary = row
        del x, dt, A, Bm, Cm, xdt, a, y, S
        torch.cuda.empty_cache()
        bad = [k for k in ("worst_of_limit", "plain_worst_of_limit")
               if not row[k] <= 1.0]
        if bad or not finite or not row.get("chunked_oracle_nan", True):
            raise PhaseFailed(f"K9 check failed ({bad}): {row}")
    return rows, summary


# one call a binding of `kernels/csrc/bindings.cpp` refuses, made straight
# on the extension (past the wrappers' checks) with CUDA tensors, as
# Python source for a child process that has `torch` and `ext`
DIRECT_REFUSALS = {
    "inner_update": "t = torch.zeros((2, 8), dtype=torch.bfloat16, "
                    "device='cuda'); ext.inner_update(t, t, "
                    "torch.empty(0), 0.1, t)",
    "flash_attention": "q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16, "
                       "device='cuda'); k = q.float(); "
                       "ext.flash_attention(q, k, k, q, False, 0, 0, 0.125)",
    "flash_decode": "q = torch.zeros((1, 16, 64), dtype=torch.bfloat16, "
                    "device='cuda'); c = torch.zeros((1, 8, 1, 64), "
                    "dtype=torch.bfloat16, device='cuda'); "
                    "ext.flash_decode(q, c, c, None, 8, q, "
                    "torch.empty(0, device='cuda'), 1, 0.125)",
    "weighted_aggregate": "g = torch.zeros((2, 8), dtype=torch.float64, "
                          "device='cuda'); ext.weighted_aggregate(g, "
                          "torch.ones(2, device='cuda'), "
                          "torch.empty(8, device='cuda'))",
    "adam_flat": "p = torch.zeros(8, dtype=torch.bfloat16, device='cuda'); "
                 "f = torch.zeros(8, device='cuda'); ext.adam_flat(p, f, f, "
                 "f, torch.ones(2, device='cuda'), 1e-3, 0.9, 0.1, 0.999, "
                 "0.001, 1e-8, 0.0)",
    "int8_encode": "g = torch.zeros((2, 8), dtype=torch.bfloat16, "
                   "device='cuda'); ext.int8_encode(g, torch.ones(2, "
                   "device='cuda'), torch.empty((2, 8), dtype=torch.int8, "
                   "device='cuda'), g)",
    "trimmed_mean": "g = torch.zeros((2, 8), device='cuda'); "
                    "ext.trimmed_mean(g, torch.ones(2, device='cuda'), "
                    "torch.empty(8, device='cuda'), 1)",
    "ssd_chunk": "x = torch.zeros((1, 1, 8, 4), dtype=torch.float64, "
                 "device='cuda'); ext.ssd_chunk(x, x[..., 0], x[:, 0], "
                 "x[:, 0], x, x, x, 8)",
}


def direct_refusal(binding, timeout=300):
    """One refused call straight into `binding` in a child process: its
    exit code (negative: the signal that ended it) and what it wrote."""
    code = ("import torch\nfrom repro_torch.kernels import _build\n"
            "ext = _build.get_ext()\n"
            "try:\n"
            f"    {DIRECT_REFUSALS[binding]}\n"
            "    torch.cuda.synchronize()\n"
            "    print('NOT REFUSED')\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', type(e).__name__, "
            "str(e).splitlines()[0])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=HERE,
                          env=dict(os.environ, PYTHONPATH=SRC))
    out = (proc.stdout + proc.stderr).strip().splitlines()
    return {"binding": binding, "exit_code": proc.returncode,
            "raised": bool(out) and out[-1].startswith("RAISED"),
            "tail": out[-2:]}


def check_refusals(torch):
    """Every wrapper refuses, in process and on CUDA tensors, a call its
    binding would refuse: a ValueError before the extension, no launch
    and no fall-back to the plain version. Then each binding's own
    refused call, straight on the extension in a child process (8 at
    once): its exit code and message, and the C++ runtime the extension
    resolves (`_build.LINK_FLAGS`)."""
    import concurrent.futures as cf
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.meta_update import aggregate, compress, fused
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.optim import fused_adam
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device="cuda")
    bf = torch.bfloat16
    refused = {   # wrapper: a call its binding refuses
        "inner_update_plane": lambda: fused.inner_update_plane(
            z(2, 6), 0.1, z(2, 6)),                          # N % 4
        "meta_update_flat": lambda: fused.meta_update_flat(
            z(6), z(6), z(6)),                               # N % 4
        "weighted_aggregate": lambda: aggregate.weighted_aggregate_flat(
            z(2, 8, dtype=torch.float64), z(2)),             # dtype
        "adam_flat": lambda: fused_adam.adam_flat_pallas(
            z(8), z(8), z(8), z(8, dtype=bf), z(2), lr=1e-3, b1=0.9,
            b2=0.999, eps=1e-8, wd=0.0),                     # m, v dtypes
        "int8_encode": lambda: compress.int8_encode_flat(z(2, 6)),  # N % 4
        "trimmed_mean": lambda: aggregate.trimmed_mean_flat(
            z(2, 8), z(2) + 1, trim=1),                      # 2 trim >= m
        "flash_attention": lambda: k7.flash_attention_bhld(
            z(1, 2, 8, 64, dtype=bf), z(1, 2, 8, 64),
            z(1, 2, 8, 64)),                                 # mixed dtypes
        "flash_decode": lambda: k8.flash_decode(
            z(1, 16, 64, dtype=bf), z(1, 8, 1, 64, dtype=bf),
            z(1, 8, 1, 64, dtype=bf), 8),                    # G = 16 > 8
        "ssd_chunk": lambda: ssd_scan.ssd_intra_chunk(
            z(1, 1, 6, 4), z(1, 1, 6), z(1, 6, 4), z(1, 6, 4),
            chunk=4),                                        # L % chunk
    }
    in_process, ok = [], True
    for name, call in refused.items():
        reset_launches()
        try:
            call()
            raised = ""
        except ValueError as e:
            raised = str(e).splitlines()[0]
        torch.cuda.synchronize()
        launched = {k: v for k, v in read_launches().items() if v}
        in_process.append({"wrapper": name, "raised": raised,
                           "launches": launched})
        ok = ok and bool(raised) and not launched
    with cf.ThreadPoolExecutor(len(DIRECT_REFUSALS)) as pool:
        direct = list(pool.map(direct_refusal, DIRECT_REFUSALS))
    ext = _build.get_ext().__file__
    ldd = subprocess.run(["ldd", ext], capture_output=True, text=True,
                         timeout=60).stdout
    runtime = [ln.strip() for ln in ldd.splitlines()
               if "libstdc++" in ln or "libgcc_s" in ln]
    all_raised = all(d["raised"] and d["exit_code"] == 0 for d in direct)
    emit({"phase": "refusals", "ok": ok and all_raised,
          "in_process": in_process, "direct": direct,
          "link_flags": _build.LINK_FLAGS, "extension_runtime": runtime})
    if not ok:
        raise PhaseFailed(f"a wrapper launched or did not refuse: "
                          f"{in_process}")
    if not all_raised:
        raise PhaseFailed(f"a refused call into the extension did not "
                          f"raise: {direct}")


def phase_kernels(torch, cfg):
    from repro_torch.models import init_lm
    from repro_torch.utils.flat import plane_for
    params = init_lm(0, cfg, device="cuda")
    n_plane = plane_for(params).n_padded
    del params
    torch.cuda.empty_cache()
    rows = []
    summaries = {}
    checks = (("inner_update_plane", lambda: check_k1(torch, n_plane)),
              ("weighted_aggregate", lambda: check_k2(torch, n_plane)),
              ("adam_flat", lambda: check_k3(torch, n_plane)),
              ("meta_update_flat", lambda: check_k4(torch, n_plane)),
              ("trimmed_mean", lambda: check_k5(torch, n_plane)),
              ("int8_encode", lambda: check_k6(torch, n_plane)),
              ("flash_attention", lambda: check_k7(torch)),
              ("flash_decode", lambda: check_k8(torch)),
              ("ssd_chunk", lambda: check_k9(torch)))
    for name, check in checks:
        r, s = check()
        rows += r
        summaries[name] = s
        torch.cuda.synchronize()
    rows += check_vmap_fold(torch)
    emit({"phase": "kernels", "ok": True, "n_plane": n_plane, "checks": rows})
    return summaries


def check_vmap_fold(torch):
    """K7, K8 and K9 under `torch.func.vmap` over R requests, on the card
    at the served shapes: one launch for the whole map (the request axis
    folded into the batch axis, `kernels/_vmap.py`), bitwise equal to R
    separate kernel calls (each batch row is computed alone), no merge
    copy; and a call the binding refuses (K7 at bf16 hd 256) raises under
    vmap too, with no launch and no plain fall-back."""
    from repro_torch.kernels import _checks, _vmap
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.ssd.ssd_scan import ssd_intra_chunk
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16

    def rand(*shape, dtype=bf):
        return torch.randn(shape, device="cuda", generator=gen).to(dtype)

    R = 4
    k9_in = (rand(R, 1, 32, 256, 64, dtype=torch.float32),
             -torch.rand((R, 1, 32, 256), device="cuda", generator=gen),
             rand(R, 1, 256, 128, dtype=torch.float32),
             rand(R, 1, 256, 128, dtype=torch.float32))
    cases = (
        ("flash_attention", "(R=4) x (1, 64, 15, 64) bf16 causal",
         lambda q, k, v: attn_ops.flash_attention(q, k, v, causal=True),
         (rand(R, 1, 64, 15, 64), rand(R, 1, 64, 5, 64),
          rand(R, 1, 64, 5, 64))),
        ("flash_decode", "(R=4) x B=1 C=64 Kv=5 G=3 bf16, int kv_length",
         lambda q, k, v: dec_ops.decode_attention(q, k, v, 64),
         (rand(R, 1, 15, 64), rand(R, 1, 64, 5, 64), rand(R, 1, 64, 5, 64))),
        ("flash_decode", "(R=4) x B=1 C=64 Kv=5 G=3 bf16, (B,) kv_length",
         lambda q, k, v, n: dec_ops.decode_attention(q, k, v, n),
         (rand(R, 1, 15, 64), rand(R, 1, 64, 5, 64), rand(R, 1, 64, 5, 64),
          torch.randint(1, 65, (R, 1), device="cuda", generator=gen,
                        dtype=torch.int32))),
        ("ssd_chunk", "(R=4) x B=1 nh=32 L=256 hp=64 N=128 chunk 128",
         lambda *t: ssd_intra_chunk(*t, chunk=128), k9_in))
    rows = []
    for name, case, fn, args in cases:
        copies = _vmap.copy_bytes
        reset_launches()
        got = torch.func.vmap(fn)(*args)
        torch.cuda.synchronize()
        launched = read_launches()[name]
        each = [fn(*(a[r] for a in args)) for r in range(R)]
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        each = [e if isinstance(e, tuple) else (e,) for e in each]
        equal = all(torch.equal(g[r], each[r][i]) for i, g in enumerate(got)
                    for r in range(R))
        row = {"name": "vmap_fold", "kernel": name, "case": case,
               "launches": launched, "bitwise_equal": equal,
               "copy_bytes": _vmap.copy_bytes - copies}
        rows.append(row)
        if launched != 1 or not equal or row["copy_bytes"]:
            raise PhaseFailed(f"vmap fold: {row}")
    reset_launches()
    q = rand(2, 1, 8, 4, 256)
    try:
        torch.func.vmap(lambda q_: attn_ops.flash_attention(q_, q_, q_))(q)
    except _checks.Refused as e:
        refused = str(e)[:120]
    else:
        raise PhaseFailed("K7 at bf16 hd 256 under vmap did not raise")
    if read_launches()["flash_attention"]:
        raise PhaseFailed("a refused K7 call under vmap launched")
    rows.append({"name": "vmap_fold", "kernel": "flash_attention",
                 "case": "(R=2) x (1, 8, 4, 256) bf16: refused",
                 "raised": refused, "launches": 0})
    return rows


def drive_serve(torch, cfg, *, sup_len, prompt_len, new_tokens, launched,
                idle, plain_route):
    """The serving path at full width: `build_engine` + `ServingEngine.
    serve` over 16 seeded requests (adapt -> prefill -> decode), every
    kernel's count set to 0 just before and read just after. Checks:
    the kernels in `launched` ran and those in `idle` did not, finite
    rows and tokens, cache hits, a served row bitwise equal to the solo
    adaptation, and the gap to the all-plain route (K1 plain, and the
    model's kernels plain inside `plain_route()`). Returns (result,
    errors, launches, (engine, mk, mp, new_tokens))."""
    from repro_torch.federated.serving import TrafficModel
    from repro_torch.launch.serve import build_engine
    from repro_torch.utils.pytree import tree_leaves

    engine = build_engine(cfg, algo_name="fomaml", inner_lr=0.05,
                          inner_steps=1, adapt_batch=4, cache_capacity=16,
                          device="cuda")

    def mk(rng, size):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                           (size, sup_len)),
                               dtype=torch.int32)

    def mp(rng):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size, (prompt_len,)),
                               dtype=torch.int32)

    traffic = TrafficModel(num_clients=8, rate=32.0, support_sizes=(2, 4),
                           think_time=0.01, seed=0)
    reqs = traffic.requests(16, mk, mp)

    # warm-up on other traffic (first-call set-up out of the numbers)
    warm = TrafficModel(num_clients=2, rate=32.0, support_sizes=(2, 4),
                        seed=99).requests(2, mk, mp)
    engine.serve(warm, max_new_tokens=2)
    engine.cache.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    report = engine.serve(reqs, max_new_tokens=new_tokens)
    launches = read_launches()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # summary() takes its adapt percentiles over every request, a hit
    # counting 0 ms, as the reference does; the misses of one flush share
    # its wall time, so these are the flushes' own walls, in order
    summary = report.summary()
    flush_ms = list(dict.fromkeys(rec["adapt_ms"] for rec in report.records
                                  if not rec["hit"]))

    errors = []
    for name in launched:
        if launches[name] <= 0:
            errors.append(f"{name} was not launched on the serving path")
    # decode launches K8 once an attention layer a step for each
    # prompt-shape group, not once a request
    groups = len({tuple(r.prompt.shape) for r in reqs})
    k8_want = generation_launches(cfg, new_tokens, groups)["flash_decode"]
    if launches["flash_decode"] != k8_want:
        errors.append(f"K8 launched {launches['flash_decode']} times, not "
                      f"{k8_want} (attention layers x (new_tokens - 1) x "
                      f"{groups} groups)")
    for name in idle:
        if launches[name] != 0:
            errors.append(f"{name} launched {launches[name]} times on a "
                          f"path that does not run it")
    for rec in report.records:
        if not bool(torch.isfinite(rec["row"]).all()):
            errors.append(f"request {rec['rid']}: non-finite adapted row")
        toks = rec.get("tokens")
        if toks is None or toks.shape != (new_tokens,) or not (
                (toks >= 0).all() and (toks < cfg.vocab_size).all()):
            errors.append(f"request {rec['rid']}: bad tokens {toks}")
    if summary["hits"] <= 0:
        errors.append("no adaptation-cache hit")

    # a served row equals the solo adaptation of that request, bit for
    # bit: as the f32 plane row (adapt_packed_batch with C = 1) and as the
    # parameter tree (adapt_packed, which unpacks that row)
    by_rid = {r.rid: r for r in reqs}
    misses = [rec for rec in report.records if not rec["hit"]]
    first = misses[0]
    sup0 = by_rid[first["rid"]].support.to("cuda")
    solo_row = engine.algo.adapt_packed_batch(engine._phi, sup0[None])[0]
    solo_tree = engine.algo.adapt_packed(engine._phi, sup0)
    served_tree = engine.unpack_row(first["row"])
    solo_equal = bool(torch.equal(solo_row, first["row"])) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(solo_tree),
                                          tree_leaves(served_tree)))
    if not solo_equal:
        errors.append("served row differs from the solo adaptation")
    del solo_row, solo_tree, served_tree

    # distance to the all-plain route on two requests, compared as f32
    # plane rows
    theta0 = engine.plane.pack(engine._phi["theta"])
    plain_cmp = []
    for rec in misses[:2]:
        sup = by_rid[rec["rid"]].support.to("cuda")
        with plain_route():
            row_t = engine.algo.adapt_packed_batch(engine._phi, sup[None],
                                                   impl="torch")[0]
        diff = float((row_t - rec["row"]).abs().max())
        step = float((row_t - theta0).abs().max())
        plain_cmp.append({"rid": rec["rid"], "max_abs_diff": diff,
                          "max_abs_step": step, "ratio": diff / step})
        del row_t
    # The two routes differ only in how the mixer's bf16 output is
    # rounded (attention: kernel vs plain order of summation; the SSD: K9
    # vs the chunked oracle, both f32 inside): at most one bf16 ulp, 2^-8
    # relative. Through the bf16 layers forward and back that moves
    # gradient entries by a few percent of the largest one, and the row
    # moves by inner_lr * g: hold the gap under 1/8 of the largest step.
    plain_tol_ratio = 0.125
    for c in plain_cmp:
        if not c["ratio"] <= plain_tol_ratio:
            errors.append(f"plain-route gap {c} above {plain_tol_ratio}")

    res = {"arch": cfg.name, "n_plane": engine.plane.n_padded,
           "requests": len(reqs), "support_len": sup_len,
           "prompt_len": prompt_len, "max_new_tokens": new_tokens,
           "summary": summary, "adapt_ms_by_flush": flush_ms,
           "prompt_shape_groups": groups, "k8_launches_expected": k8_want,
           "launches": launches,
           "launches_per_request": {k: v / len(reqs)
                                    for k, v in launches.items()},
           "peak_mem_gb": peak_gb, "solo_bitwise_equal": solo_equal,
           "plain_route": plain_cmp, "plain_tol_ratio": plain_tol_ratio}
    res["batched"] = batched_generation(
        torch, cfg, engine, reqs, {r["rid"]: r for r in report.records},
        new_tokens, errors)
    return res, errors, launches, (engine, mk, mp, new_tokens), misses


def generation_launches(cfg, new_tokens: int, groups: int = 1) -> dict:
    """What generating `groups` prompt-shape groups launches for a
    decoder-only config, each group one `torch.func.vmap`: K7 once an
    attention layer (the prefill), K8 once an attention layer a decode
    step (none for MLA, whose absorbed decode has no kernel), K9 once a
    Mamba layer (the prefill); whatever the group's size."""
    from repro_torch.models.lm import layer_groups
    lead, period, n_reps = layer_groups(cfg)

    def count(kind):
        return (sum(s[0] == kind for s in lead)
                + n_reps * sum(s[0] == kind for s in period))

    attn = count("attn")
    decode = 0 if cfg.attention == "mla" else attn * (new_tokens - 1)
    return {"flash_attention": attn * groups, "flash_decode": decode * groups,
            "ssd_chunk": count("mamba") * groups}


def stepwise_generate(torch, engine, params, prompt, new_tokens: int):
    """The per-request route: `ServingEngine.generate`'s loop on one
    request (its prefill and decode steps, in its order), keeping every
    step's logits. Returns (tokens (new_tokens,), [(V,) f32 logits])."""
    out, steps = [], []
    with torch.no_grad():
        logits, cache = engine._prefill_fn(params, prompt[None])
        for t in range(new_tokens):
            if t:
                logits, cache = engine._decode_fn(params, cache, tok[:, None])
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
            steps.append(logits[0].float())
    return torch.cat(out), steps


def batched_generation(torch, cfg, engine, reqs, records, new_tokens: int,
                       errors, n: int = 2):
    """The serving engine's batched route (`generate_batch`: one
    `torch.func.vmap` over a prompt-shape group, each request under its
    own θ_u) on the card, for the group of `reqs` (one prompt shape),
    from the rows the serve adapted (`records` by rid):

    - launches: one batched generation of the group launches K7, K8 and
      K9 as `generation_launches` says, and no other kernel;
    - against the per-request route (`stepwise_generate`), kernels on,
      on the first `n` requests: tokens equal, or, where they differ,
      the per-request route's top-two logit gap at the first differing
      step within the limit (step and gap reported); the batched
      route's first-step logits within the limit of the per-request
      route's. Per-request weights make every projection a batched
      matmul, whose bf16 rounding may differ from a single one's;
    - against the plain route under vmap (`all_plain`: K7, K8, K9 plain,
      none launched): first-step logits within the limit.

    The limit is §2's bf16 handoff limit: twice the bf16 rounding
    spread, max |logits(θ_u) − logits(θ_u cast to f32)| over the n
    requests' first steps. Also reports the group's generation seconds
    and the bytes the fold copied."""
    import numpy as np
    from repro_torch.kernels import _vmap
    from repro_torch.utils.pytree import tree_map
    group = [r for r in reqs if r.prompt is not None]
    rows = [records[r.rid]["row"] for r in group]
    prompts = torch.stack([torch.as_tensor(r.prompt, dtype=torch.int32)
                           for r in group]).to("cuda")

    def first_logits():
        with torch.no_grad():
            return torch.func.vmap(
                lambda p, x: engine._prefill_fn(p, x[None])[0][0])(
                engine.plane.unpack_rows(rows), prompts).float()

    torch.cuda.synchronize()
    copies = _vmap.copy_bytes
    reset_launches()
    t0 = time.perf_counter()
    toks = engine.generate_batch(rows, prompts, new_tokens)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches = read_launches()
    copied = _vmap.copy_bytes - copies
    want = generation_launches(cfg, new_tokens)
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        errors.append(f"{cfg.name}: one batched generation launched "
                      f"{launches}, not {want}")
    served_equal = all(np.array_equal(records[r.rid]["tokens"],
                                      toks[i].cpu().numpy())
                       for i, r in enumerate(group))
    if not served_equal:        # the same route on the same inputs
        errors.append(f"{cfg.name}: a second batched generation of the "
                      f"served group gave other tokens than the serve")
    lg_batched = first_logits()

    per, spread = [], 0.0
    for i in range(min(n, len(group))):
        params = engine.unpack_row(rows[i])
        toks_i, steps = stepwise_generate(torch, engine, params, prompts[i],
                                          new_tokens)
        params32 = tree_map(lambda x: x.float(), params)
        with torch.no_grad():
            lg32 = engine._prefill_fn(params32, prompts[i][None])[0][0]
        del params32, params
        spread = max(spread, float((steps[0] - lg32.float()).abs().max()))
        differ = (toks_i != toks[i]).nonzero()
        first = int(differ[0]) if differ.numel() else None
        gap = None
        if first is not None:
            top = torch.topk(steps[first], 2).values
            gap = float(top[0] - top[1])
        per.append({"rid": group[i].rid, "tokens_equal": first is None,
                    "first_differing_step": first, "top_two_gap": gap,
                    "first_step_logit_gap": float(
                        (lg_batched[i] - steps[0]).abs().max())})
    limit = 2.0 * spread
    for p in per:
        if not p["first_step_logit_gap"] <= limit:
            errors.append(f"{cfg.name}: batched first-step logits {p} "
                          f"beyond the bf16 limit {limit}")
        if not p["tokens_equal"] and not p["top_two_gap"] <= limit:
            errors.append(f"{cfg.name}: batched tokens differ from the "
                          f"per-request route's at a top-two gap beyond "
                          f"the bf16 limit: {p}, limit {limit}")

    reset_launches()
    with all_plain():
        lg_plain = first_logits()
        toks_plain = engine.generate_batch(rows, prompts, new_tokens)
    plain_launches = read_launches()
    plain_gap = float((lg_plain - lg_batched).abs().max())
    if not plain_gap <= limit:
        errors.append(f"{cfg.name}: plain route under vmap {plain_gap} from "
                      f"the kernel route, beyond the bf16 limit {limit}")
    if any(plain_launches[k] for k in want):
        errors.append(f"{cfg.name}: the plain route launched "
                      f"{plain_launches}")
    return {"requests": len(group), "launches": launches,
            "launches_expected": want, "generate_s": batched_s,
            "fold_copy_bytes": copied,
            "served_tokens_equal": served_equal,
            "per_request": per, "bf16_spread": spread, "limit": limit,
            "plain_first_step_gap": plain_gap,
            "plain_tokens_equal": bool(torch.equal(toks_plain, toks))}


def phase_serve(torch, cfg):
    """SmolLM-360M: supports and prompts of 64 tokens; K1, K7 and K8;
    the group of 16 generated in one vmap (`batched_generation`)."""
    from repro_torch.kernels.attention import ops as attn_ops
    _reset_peak(torch)
    t0 = time.perf_counter()
    res, errors, launches, ctx, _ = drive_serve(
        torch, cfg, sup_len=64, prompt_len=64, new_tokens=8,
        launched=("inner_update_plane", "flash_attention", "flash_decode"),
        idle=(), plain_route=lambda: attn_ops.use_impl("torch"))
    peak = _peak_gb(torch)
    if not peak < 80:
        errors.append(f"phase peak {peak} GB, not under 80")
    emit({"phase": "serve", "ok": not errors, **res,
          "phase_wall_s": time.perf_counter() - t0,
          "phase_peak_gb": peak, "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches, ctx


# (group, substrings of the device kernels' names, launch counter of
# the wrapper that launches them)
KERNEL_GROUPS = (
    ("K1 inner_update", ("inner_update_kernel",), "inner_update_plane"),
    ("K2 weighted_aggregate", ("weighted_aggregate_kernel",),
     "weighted_aggregate"),
    ("K3 adam", ("adam_kernel",), "adam_flat"),
    ("K5 trimmed_mean", ("trimmed_mean",), "trimmed_mean"),
    ("K6 int8_encode", ("int8_encode_kernel",), "int8_encode"),
    ("K7 flash_attention", ("flash_attention_mma_kernel",
                            "flash_attention_f32_kernel"), "flash_attention"),
    ("K8 flash_decode", ("flash_decode_kernel", "flash_decode_mma_kernel",
                         "flash_decode_combine_kernel"), "flash_decode"),
    ("K9 ssd_chunk", ("ssd_state_kernel", "ssd_y_kernel"),
     "ssd_chunk"),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "splitk"), None),
    ("copy/cast/fill", ("copy", "memcpy", "memset", "fill"), None))


def _traced(torch, fn):
    """(host wall s, device summary) of one traced run of fn. Only the
    device's activity is recorded: the summary reads no host events,
    and recording them too gives the same device times and counts but
    makes reading the trace several times slower. Each kernel group's
    wrapper launches in the run (read from the counters before and
    after, which are not reset) give its device µs a launch."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    after = read_launches()
    by_name, n_events, fills = {}, 0, 0
    for evt in prof.events():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        n_events += 1
        fills += "fill" in evt.name.lower()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + \
            evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    groups = {g: 0.0 for g, _, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        low = name.lower()
        for g, keys, _ in KERNEL_GROUPS:
            if any(k.lower() in low for k in keys):
                groups[g] += ms
                break
        else:
            groups["other"] += ms
    launches, us_per_launch = {}, {}
    for g, _, counter in KERNEL_GROUPS:
        n = after[counter] - before[counter] if counter else 0
        if n:
            launches[g] = n
            us_per_launch[g] = groups[g] * 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return traced_s, {
        "wall_ms_traced": traced_s * 1e3, "device_events": n_events,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (traced_s * 1e3),
        "device_ms_by_group": groups, "launches_by_group": launches,
        "device_us_per_launch": us_per_launch, "fill_launches": fills,
        "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def _device_profile(torch, fn):
    """Device summary of fn, run once untraced and once traced (the
    difference in wall time is the profiler's cost)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _, summary = _traced(torch, fn)
    return {"wall_ms_untraced": plain_s * 1e3, **summary}


def phase_trace(torch, engine, mk, mp, new_tokens, name="trace"):
    """Where the serving time goes: torch.profiler over the adaptation of
    4 fresh requests (cache cleared, no decode), then over their decode
    alone (all cache hits). Each is run once untraced and once traced, so
    the difference is the profiler's cost."""
    from repro_torch.federated.serving import TrafficModel
    reqs = TrafficModel(num_clients=4, rate=32.0, support_sizes=(2, 4),
                        think_time=0.01, seed=1).requests(4, mk, mp)

    def adapt_only():
        engine.cache.clear()
        engine.serve(reqs, max_new_tokens=0)

    adapt = _device_profile(torch, adapt_only)
    decode = _device_profile(
        torch, lambda: engine.serve(reqs, max_new_tokens=new_tokens))
    visible = adapt["device_events"] > 0 and decode["device_events"] > 0
    emit({"phase": name, "ok": True, "requests": len(reqs),
          "device_time_visible": visible, "adapt": adapt, "decode": decode})


# ------------------------------------------------------------------ train

# 4 clients x (download + upload) x 1,846,520 B of f32 φ for
# femnist_cnn(62, hidden=128): the committed comparison artifact's
# 14.77216 MB a round (results/experiments/femnist_compare.json)
FEMNIST_ROUND_BYTES = 14_772_160


def _kernel_counters():
    """kernel name -> (module, name of its launch counter)."""
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.meta_update import aggregate as k2
    from repro_torch.kernels.meta_update import compress as k6
    from repro_torch.kernels.meta_update import fused as k1
    from repro_torch.kernels.ssd import ssd_scan as k9
    from repro_torch.optim import fused_adam as k3
    return {"inner_update_plane": (k1, "launches"),
            "weighted_aggregate": (k2, "launches"),
            "adam_flat": (k3, "launches"),
            "meta_update_flat": (k1, "meta_update_launches"),
            "trimmed_mean": (k2, "trimmed_launches"),
            "int8_encode": (k6, "launches"),
            "flash_attention": (k7, "launches"),
            "flash_decode": (k8, "launches"),
            "ssd_chunk": (k9, "launches")}


def reset_launches():
    for mod, attr in _kernel_counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _kernel_counters().items()}


def phase_train_femnist(torch):
    """FedMeta on FEMNIST through `FederatedTrainer` on the packed client
    plane: the kernel route, then the all-plain route (impl="torch"),
    which must agree bit for bit, then one round each of MAML (order 2)
    and Meta-SGD."""
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.data import make_femnist
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.models.paper import femnist_cnn
    from repro_torch.optim import adam

    ROUNDS, EVAL_EVERY = 20, 10
    train, val, _ = make_femnist(num_clients=100, mean_samples=60,
                                 seed=0).split_clients(0)
    model = femnist_cnn(62, hidden=128, device="cuda")
    loss_fn, eval_fn = classification_loss(model.apply)

    def run(name, impl, rounds, eval_every=0):
        algo = make_algorithm(name, loss_fn, eval_fn, 0.05)
        tr = FederatedTrainer(algo, adam(1e-3), train, clients_per_round=4,
                              support_frac=0.2, support_size=16,
                              query_size=16, seed=0, packed=True,
                              client_plane=True, impl=impl, device="cuda")
        state = tr.init(0, model.init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.run(state, rounds, eval_every=eval_every,
                       eval_clients=val)
        torch.cuda.synchronize()
        return tr, state, time.perf_counter() - t0

    run("fomaml", "cuda", 1)            # warm-up: first-call set-up
    reset_launches()
    tr, state, wall_s = run("fomaml", "cuda", ROUNDS, EVAL_EVERY)
    launches = read_launches()
    tr_t, state_t, wall_t = run("fomaml", "torch", ROUNDS, EVAL_EVERY)

    errors = []
    for name in ("inner_update_plane", "weighted_aggregate", "adam_flat"):
        if launches[name] <= 0:
            errors.append(f"{name} was not launched on the training path")
    if tr.comm.total_bytes != ROUNDS * FEMNIST_ROUND_BYTES:
        errors.append(f"bytes {tr.comm.total_bytes} != "
                      f"{ROUNDS} x {FEMNIST_ROUND_BYTES}")
    for rec in tr.history:
        if rec["comm_MB"] != rec["rounds"] * FEMNIST_ROUND_BYTES / 1e6:
            errors.append(f"round {rec['round']}: comm_MB {rec['comm_MB']}")
    finite = bool(torch.isfinite(state["phi"]).all()) and all(
        math.isfinite(rec["query_loss"]) for rec in tr.history)
    if not finite:
        errors.append("non-finite φ or query loss")
    same_history = tr.history == tr_t.history
    same_phi = bool(torch.equal(state["phi"], state_t["phi"])) and all(
        torch.equal(state["opt"][k], state_t["opt"][k])
        for k in ("m", "v", "step"))
    if not (same_history and same_phi):
        errors.append(f"kernel and plain routes differ: history "
                      f"{same_history}, state {same_phi}")
    others = {}
    for name in ("maml", "meta-sgd"):
        o_tr, o_state, o_s = run(name, "cuda", 1)
        ok = bool(torch.isfinite(o_state["phi"]).all()) and math.isfinite(
            o_tr.history[0]["query_loss"])
        others[name] = {"query_loss": o_tr.history[0]["query_loss"],
                        "wall_s": o_s, "finite": ok}
        if not ok:
            errors.append(f"{name}: non-finite round")
    evals = [{k: rec[k] for k in ("round", "eval_acc", "eval_loss")}
             for rec in tr.history if "eval_acc" in rec]
    bytes_per_round = tr.comm.total_bytes / ROUNDS
    # where a round's time goes: one more round of the kernel run, traced
    _, trace = _traced(torch, lambda: tr.run(state, 1))
    emit({"phase": "train_femnist", "ok": not errors, "rounds": ROUNDS,
          "clients_per_round": 4, "n_real": tr._plane.n_real,
          "phi_bytes": tr.comm.phi_bytes,
          "bytes_per_round": bytes_per_round,
          "wall_s": wall_s, "wall_s_plain_route": wall_t,
          "round_ms": wall_s / ROUNDS * 1e3, "launches": launches,
          "launches_per_round": {k: v / ROUNDS for k, v in launches.items()},
          "first": {k: tr.history[0][k] for k in ("query_loss", "accuracy")},
          "last": {k: tr.history[-1][k] for k in ("query_loss", "accuracy")},
          "evals": evals, "bitwise_equal_plain_route":
              same_history and same_phi, "others": others,
          "trace_round": trace, "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches


LM_ROUND = dict(M=4, S=4, Q=4, L=128, LR=1e-3)


def lm_round_setup(torch, cfg, rounds, M=None):
    """The LM round's pieces: FOMAML (inner lr 0.05) over `lm_loss` (no
    remat: 128-token sequences fit the card without it), φ from seed 0
    on the card, Adam, the packed state, and `rounds` seeded
    batches of M clients (`LM_ROUND`'s unless given) × (S support, Q
    query) sequences of L tokens."""
    import numpy as np
    from repro_torch.core import make_algorithm
    from repro_torch.core.fedmeta import init_packed_state
    from repro_torch.core.losses import lm_loss
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.optim import adam
    from repro_torch.utils.flat import plane_for

    S, Q, L = (LM_ROUND[k] for k in "SQL")
    M = M or LM_ROUND["M"]
    algo = make_algorithm("fomaml",
                          *lm_loss(make_apply_fn(cfg, remat=False)), 0.05)
    phi = {"theta": init_lm(0, cfg, device="cuda")}
    plane = plane_for(phi)
    opt = adam(LM_ROUND["LR"])
    state = init_packed_state(opt, plane, phi)
    rng = np.random.RandomState(0)
    batches = [tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (M, n, L)),
                                     dtype=torch.int32, device="cuda")
                     for n in (S, Q)) for _ in range(rounds)]
    return algo, opt, plane, state, batches


def drive_train_lm(torch, cfg, *, rounds, phase, plain_route, launched,
                   extra=None, extra_errors=()):
    """Packed FOMAML rounds of an LM at full width on the client plane:
    m = 4 clients, 4 support and 4 query sequences of 128 tokens each,
    Adam(1e-3). Round 1 is held against the same round on the all-plain
    route (K1, K2, K3 plain, and the model's kernels plain inside
    `plain_route()`); the last round is traced. Every kernel's count
    starts at 0 before round 1 of the kernel route. `extra` and
    `extra_errors` join the phase's line."""
    from repro_torch.core.fedmeta import make_packed_meta_train_step
    from repro_torch.utils.pytree import tree_map

    M, S, Q, L, LR = (LM_ROUND[k] for k in ("M", "S", "Q", "L", "LR"))
    algo, opt, plane, state, batches = lm_round_setup(torch, cfg, rounds)
    step = make_packed_meta_train_step(algo, opt, plane, client_plane=True,
                                       impl="cuda")

    # round 1 on the all-plain route, from a copy (K3 updates in place)
    plain_step = make_packed_meta_train_step(algo, opt, plane,
                                             client_plane=True, impl="torch")
    st = {"phi": state["phi"].clone(), "opt": tree_map(torch.clone,
                                                       state["opt"])}
    with plain_route():
        st, _ = plain_step(st, *batches[0])
    phi_plain, m_plain = st["phi"], st["opt"]["m"]
    del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    walls, metrics = [], []
    for r in range(rounds - 1):
        t0 = time.perf_counter()
        state, met = step(state, *batches[r])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in met.items()})
        if r == 0:
            # Adam's first step moves each entry by lr·g/(|g| + eps), at
            # most lr, so any gradient difference moves φ by at most
            # 2·lr; the meta-gradient itself (m / (1 - b1)) is held at
            # 1/8 of its largest entry, the serve phase's tolerance for
            # the same kernel-vs-plain rounding of the mixer's bf16
            # output through the bf16 layers
            d_phi = float((state["phi"] - phi_plain).abs().max())
            moved = float(((state["phi"] - phi_plain).abs() > 1e-6)
                          .float().mean())
            d_g = float((state["opt"]["m"] - m_plain).abs().max()
                        / m_plain.abs().max())
            del phi_plain, m_plain
    box = {}

    def last():
        box["state"], box["met"] = step(state, *batches[rounds - 1])

    wall_last, trace = _traced(torch, last)
    state = box["state"]
    walls.append(wall_last)
    metrics.append({k: float(v) for k, v in box["met"].items()})
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    errors = list(extra_errors)
    for name in launched:
        if launches[name] <= 0:
            errors.append(f"{name} was not launched on the LM training path")
    if not bool(torch.isfinite(state["phi"]).all()):
        errors.append("non-finite φ")
    phi_tol = 2 * LR + 1e-6
    g_tol = 0.125
    if not (d_phi <= phi_tol and d_g <= g_tol):
        errors.append(f"round 1 vs the plain route: |dφ| {d_phi} (limit "
                      f"{phi_tol}), meta-gradient {d_g} (limit {g_tol})")
    emit({"phase": phase, "ok": not errors, "arch": cfg.name,
          "n_plane": plane.n_padded, "clients": M, "support": S, "query": Q,
          "seq_len": L, "round_wall_ms": [w * 1e3 for w in walls],
          f"round{rounds}_traced": True, "metrics": metrics,
          "peak_mem_gb": peak_gb, "launches": launches,
          "plain_route_round1": {"max_abs_dphi": d_phi, "phi_tol": phi_tol,
                                 "share_moved_1e-6": moved,
                                 "meta_grad_rel": d_g, "meta_grad_tol": g_tol},
          f"trace_round{rounds}": trace, **(extra or {}), "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches


def plain_route_gap_f32(torch, cfg, plain_route):
    """One packed FOMAML round of `cfg` in float32 (drive_train_lm's
    settings and first batch) on the kernel route and on the all-plain
    route, from one state: the meta-gradients' largest gap over their
    largest entry. In f32 the two routes compute the same function and
    differ only in summation order, so the gap is held at 1e-3 (NET's
    1e-4 for two layers, ten times over for 48); in bf16 that gap is
    amplified by rounding flips, which `drive_train_lm` holds at 1/8."""
    from repro_torch.core.fedmeta import make_packed_meta_train_step
    from repro_torch.utils.pytree import tree_map

    algo, opt, plane, state, (batch,) = lm_round_setup(
        torch, dataclasses.replace(cfg, dtype="float32"), 1)
    ms = []
    for impl in ("cuda", "torch"):
        st = {"phi": state["phi"].clone(),
              "opt": tree_map(torch.clone, state["opt"])}
        step = make_packed_meta_train_step(algo, opt, plane, client_plane=True,
                                           impl=impl)
        if impl == "torch":
            with plain_route():
                st, _ = step(st, *batch)
        else:
            st, _ = step(st, *batch)
        ms.append(st["opt"]["m"])
        del st
    rel = float((ms[0] - ms[1]).abs().max() / ms[1].abs().max())
    del ms, state, step
    gc.collect()                # the steps' closures hold f32 planes
    torch.cuda.empty_cache()
    return {"meta_grad_rel": rel, "meta_grad_tol": 1e-3}


def phase_train_lm(torch, cfg):
    """Three packed FOMAML rounds of SmolLM-360M; attention plain on the
    plain route; K1, K2, K3 and K7 launched; round 3 traced."""
    from repro_torch.kernels.attention import ops as attn_ops
    return drive_train_lm(
        torch, cfg, rounds=3, phase="train_lm",
        plain_route=lambda: attn_ops.use_impl("torch"),
        launched=("inner_update_plane", "weighted_aggregate", "adam_flat",
                  "flash_attention"))


# ------------------------------------------------------------ SSM slice

def ssd_torch_route():
    from repro_torch.kernels.ssd import ops as ssd_ops
    return ssd_ops.use_impl("torch")


def handoff_gaps(torch, cfg, params, prompt, extra, capacity=None,
                 embeds=None):
    """Prefill `prompt`, then decode the `extra` tokens one at a time:
    max |logits − lm_apply's| over the extended prompt at each step
    (the prefill's last position first), and that forward's logits.
    The prefill is `make_prefill_step`'s (a cache of the prompt's
    length), or `lm_apply`'s into a cache of `capacity` slots: an
    attention cache without room for the new tokens overwrites the
    prompt's first (the reference's serving quirk, ROADMAP Queue 3).
    `embeds` (1, n_mod, d_model) go with the prompt as the modality
    embeddings: a vision config's logits then cover [prefix | text], and
    positions are read past the prefix."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm_apply
    toks = torch.cat([prompt, extra])[None].to("cuda")
    L = prompt.numel()
    with torch.no_grad():
        full, _ = lm_apply(params, cfg, toks, modality_embeds=embeds)
        off = full.shape[1] - toks.shape[1]
        if capacity is None:
            batch = (toks[:, :L] if embeds is None
                     else {"tokens": toks[:, :L], "embeds": embeds})
            logits, cache = make_prefill_step(cfg)(params, batch)
        else:
            logits, _, cache = lm_apply(params, cfg, toks[:, :L],
                                        modality_embeds=embeds,
                                        collect_cache=True,
                                        cache_capacity=capacity,
                                        logits_mode="last")
            logits = logits[:, 0]
        gaps = [float((logits[0] - full[0, off + L - 1]).abs().max())]
        decode = make_decode_step(cfg)
        for t in range(L, L + extra.numel()):
            logits, cache = decode(params, cache, toks[:, t:t + 1])
            gaps.append(float((logits[0] - full[0, off + t]).abs().max()))
    return gaps, full[0, off + L - 1:]


def serve_handoff(torch, cfg, engine, row, prompt, errors):
    """The prefill -> decode handoff at full width for one adapted row:
    prefill the request's prompt, decode 2 more tokens, each step's
    logits against `lm_apply` over the extended prompt. In float32 (the
    row's bf16 weights cast up, so both paths compute the same function
    in f32) the gap is held at the reference's own 2e-3
    (`tests/test_arch_smoke.py:107-119`), as 2e-3 + 2e-3·max|logits|. In bf16 the decode path
    rounds at other places than the chunked forward (the conv in f32,
    the state update one token at a time): its gap is held within twice
    the distance by which bf16 rounding alone moves the full forward
    from the same forward in f32."""
    from repro_torch.utils.pytree import tree_map
    gen = torch.Generator().manual_seed(5)
    extra = torch.randint(0, cfg.vocab_size, (2,), generator=gen,
                          dtype=torch.int32)
    params = engine.unpack_row(row)
    params32 = tree_map(lambda x: x.float(), params)
    gaps_bf16, full_bf16 = handoff_gaps(torch, cfg, params, prompt, extra)
    gaps_f32, full_f32 = handoff_gaps(torch, cfg, params32, prompt, extra)
    spread = float((full_bf16 - full_f32).abs().max())
    scale = float(full_f32.abs().max())
    f32_tol = 2e-3 + 2e-3 * scale
    bf16_tol = 2.0 * spread
    del params32, full_bf16, full_f32
    if not max(gaps_f32) <= f32_tol:
        errors.append(f"f32 handoff gaps {gaps_f32} above {f32_tol}")
    if not max(gaps_bf16) <= bf16_tol:
        errors.append(f"bf16 handoff gaps {gaps_bf16} above {bf16_tol}")
    return {"prompt_len": prompt.numel(), "decoded": extra.numel(),
            "gaps_f32": gaps_f32, "f32_tol": f32_tol,
            "gaps_bf16": gaps_bf16, "bf16_rounding_spread": spread,
            "bf16_tol": bf16_tol, "max_abs_logit": scale}


def phase_serve_ssm(torch, mcfg):
    """Mamba2-370M at full width: supports of 128-token sequences (one
    chunk), prompts of 200 tokens (padded to 256: two chunks, the
    inter-chunk recurrence and the dt = 0 padding), 8 new tokens; K1 and
    K9 launched, K7 and K8 not; then the handoff at full width."""
    _reset_peak(torch)
    t0 = time.perf_counter()
    res, errors, launches, ctx, misses = drive_serve(
        torch, mcfg, sup_len=128, prompt_len=200, new_tokens=8,
        launched=("inner_update_plane", "ssd_chunk"),
        idle=("flash_attention", "flash_decode"), plain_route=ssd_torch_route)
    import numpy as np
    engine, mk, mp, _ = ctx
    prompt = mp(np.random.RandomState(3))
    res["handoff"] = serve_handoff(torch, mcfg, engine, misses[0]["row"],
                                   prompt, errors)
    peak = _peak_gb(torch)
    if not peak < 80:
        errors.append(f"phase peak {peak} GB, not under 80")
    emit({"phase": "serve_ssm", "ok": not errors, **res,
          "phase_wall_s": time.perf_counter() - t0,
          "phase_peak_gb": peak, "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches, ctx


def phase_train_ssm(torch, mcfg):
    """Two packed FOMAML rounds of Mamba2-370M; the SSD on its chunked
    oracle on the plain route; K1, K2, K3 and K9 (under the gradient:
    forward by K9, backward by recomputation) launched; round 2
    traced. First, the same round 1 in float32 on both routes
    (`plain_route_gap_f32`)."""
    f32 = plain_route_gap_f32(torch, mcfg, ssd_torch_route)
    bad = ([] if f32["meta_grad_rel"] <= f32["meta_grad_tol"] else
           [f"f32 round 1 vs the plain route: {f32}"])
    return drive_train_lm(
        torch, mcfg, rounds=2, phase="train_ssm", plain_route=ssd_torch_route,
        launched=("inner_update_plane", "weighted_aggregate", "adam_flat",
                  "ssd_chunk"),
        extra={"plain_route_round1_f32": f32}, extra_errors=bad)


def phase_decode_launcher(torch):
    """`python -m repro_torch.launch.serve --arch mamba2-370m --steps 4`
    in process: full width, decode_32k's batch of 128 against the fixed
    SSM state (48 layers × 128 × (3 × 2304 bf16 + 32 × 64 × 128 f32) ≈
    6.5 GB), on the 1x1 host mesh; then the same 4 steps with no mesh
    (`decode_steps`), for the mesh's cost a step."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = serve.main(["--arch", "mamba2-370m", "--steps", "4"])
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the CLI runs on the 1x1 mesh (DTensor weights and cache); the same
    # steps with no mesh give what the mesh's dispatch costs
    from repro_torch.configs import get_config
    meshless = serve.decode_steps(get_config("mamba2-370m"), 128, 32768, 4)
    res["ms_per_step_meshless"] = [t * 1e3 for t in meshless["step_s"]]
    errors = []
    if not res["logits_finite"]:
        errors.append("non-finite decode logits")
    if res["logits_shape"] != (128, 50280):
        errors.append(f"logits shape {res['logits_shape']}")
    emit({"phase": "decode_launcher", "ok": not errors, **res,
          "ms_per_step": [t * 1e3 for t in res["step_s"]],
          "peak_mem_gb": peak_gb, "launches": launches, "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches


# ------------------------------------------------------- train_launcher

# SmolLM-360M at full width and train_4k's 4,096 tokens, cut in sequences
# a client (support + query) and clients, never in width or length:
# (S_support + S_query, clients) for each run of the phase. train_4k has 8
# clients of 16 + 16; the clients run one after another, so only the
# sequences set the peak. `--launch-cuts` on an H100 80GB
# HBM3 at 700 W: FOMAML 13.3 / 20.1 / 34.8 / 49.6 / 64.4 GB at 1 + 1 /
# 2 + 2 / 4 + 4 / 6 + 6 / 8 + 8, MAML 42.7 / 78.7 GB at 1 + 1 / 2 + 2, of
# the card's 85 GB; MAML stays at 1 + 1 for margin
LAUNCH_CUT = {"fomaml": (16, 1), "maml": (2, 1), "small": (2, 1)}
LAUNCH_LR = dict(inner_lr=0.01, outer_lr=1e-4)    # the launcher's defaults
# granite and qwen2.5 served at full width: 2 requests of one client (a
# miss, then a cache hit), supports of 2 sequences of 64 tokens, 64-token
# prompts, 8 new tokens. adapt_batch is cut from 4 to 1: an f32 plane row
# of a 2.5 / 3.1 B model is 10.1 / 12.3 GB, and each row of the batch
# holds θ and its gradient. Granite at 2 peaked at 66.0 GB with remat and
# ran out of the card's memory without it (serving runs without remat)
DENSE_SERVE = dict(requests=2, sup_len=64, prompt_len=64, new_tokens=8,
                   adapt_batch=1)


@contextlib.contextmanager
def all_plain():
    """Attention (K7), decode attention (K8), the SSD (K9) and the tree
    meta-update (K1) on their plain versions."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.meta_update import ops as mu_ops
    with attn_ops.use_impl("torch"), dec_ops.use_impl("torch"), \
            ssd_torch_route(), mu_ops.use_impl("torch"):
        yield


def _tree_rel_gap(a, b):
    """max |a − b| over max |b|, across the leaves of two trees."""
    from repro_torch.utils.pytree import tree_leaves
    xs, ys = tree_leaves(a), tree_leaves(b)
    return (max(float((x.float() - y.float()).abs().max())
                for x, y in zip(xs, ys))
            / max(float(y.float().abs().max()) for y in ys))


def _check_plain(launches, what, errors):
    """A plain-route run launched neither K1 nor K7."""
    for name in ("inner_update_plane", "flash_attention"):
        if launches[name]:
            errors.append(f"{what}: {name} launched {launches[name]} times")


def launch_reduced(torch, errors):
    """`train.main([... "--reduced", "--steps", "2"])` on the card."""
    from repro_torch.launch import train as tl
    reset_launches()
    out = tl.main(["--arch", "smollm-360m", "--reduced", "--steps", "2"])
    launches = read_launches()
    if not all(math.isfinite(r["query_loss"]) for r in out["records"]):
        errors.append(f"reduced launcher: non-finite loss {out['records']}")
    for name in ("inner_update_plane", "flash_attention"):
        if launches[name] <= 0:
            errors.append(f"reduced launcher: {name} not launched")
    return {"records": out["records"], "launches": launches}


def _launch_run(torch, cfg, algo, cut, steps, phi, *, remat=True,
                keep_step1=False):
    """`train.train` on a cut of train_4k (L = 4,096): per-step ms, peak
    GB over what was held before, launches from 0, the final state, and
    (keep_step1) φ and the first moment after step 1."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import train as tl
    from repro_torch.utils.pytree import tree_map
    S, C = cut
    shape = tl.cut_shape(INPUT_SHAPES["train_4k"], seqs_per_client=S,
                         clients=C)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    box = {}

    def on_step(it, state, _):
        if keep_step1 and it == 0:
            box["phi"] = tree_map(torch.clone, state["phi"])
            box["m"] = tree_map(torch.clone, state["opt"]["m"])

    reset_launches()
    state, recs = tl.train(cfg, shape, algo=algo, steps=steps, remat=remat,
                           device="cuda", phi=phi, log_every=10 ** 9,
                           on_step=on_step, **LAUNCH_LR)
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    res = {"algo": algo, "seq_len": shape.seq_len, "support": S // 2,
           "query": S - S // 2, "clients": C, "remat": remat,
           "step_ms": [r["wall_s"] * 1e3 for r in recs],
           "metrics": [{k: v for k, v in r.items() if k not in
                        ("step", "wall_s")} for r in recs],
           "peak_gb": peak, "held_gb": held / 1e9, "launches": launches}
    return res, state, box


def launch_cuts(torch, cuts):
    """One launcher step of SmolLM-360M at full width (bf16, seed 0) at
    each cut `algo:S` of `cuts`: step ms, peak GB, launches, or the
    first line of the out-of-memory error. One JSON line a cut."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    cfg = get_config("smollm-360m")
    phi = {"theta": init_lm(0, cfg, device="cuda")}
    for cut in cuts.split(","):
        algo, S = cut.split(":")
        row = {"phase": "launch_cuts", "algo": algo,
               "seqs_per_client": int(S), "clients": 1}
        try:
            res, state, _ = _launch_run(torch, cfg, algo, (int(S), 1), 1,
                                        phi)
            del state
            row.update(step_ms=res["step_ms"][0], peak_gb=res["peak_gb"],
                       held_gb=res["held_gb"], launches={
                           k: v for k, v in res["launches"].items() if v})
        except torch.cuda.OutOfMemoryError as e:
            row["out_of_memory"] = str(e).splitlines()[0]
        gc.collect()
        torch.cuda.empty_cache()
        emit(row)


def launch_traced_step(torch, cfg, phi, cut=None):
    """One FOMAML step of the launcher's `make_train_step` at the FOMAML
    cut (or `cut`) under torch.profiler (device activity by kernel
    group)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import train as tl
    from repro_torch.launch.steps import make_train_step
    S, C = cut or LAUNCH_CUT["fomaml"]
    shape = tl.cut_shape(INPUT_SHAPES["train_4k"], seqs_per_client=S,
                         clients=C)
    step, init_state, _, _ = make_train_step(cfg, algo_name="fomaml",
                                             **LAUNCH_LR)
    state = init_state(phi=phi, device="cuda")
    batch = tl.task_batch(cfg, shape, 0, "cuda")
    _, trace = _traced(torch, lambda: step(state, batch))
    del state, batch
    return trace


def launch_full_width(torch, cfg, errors):
    """SmolLM-360M at full width, L = 4,096, through `train.train`: 2
    FOMAML steps and 1 MAML step (K1 and K7 launched, finite loss, φ
    moved), FOMAML's step 1 against the plain route in bf16 (φ within
    2·lr plus one bf16 ulp, the meta-gradient within 1/8 of its largest
    entry, the train phase's limits), one traced FOMAML step, one step
    in float32 on both routes at the small cut (the meta-gradient within
    1e-3), and the peak memory with remat at the small cut and without
    it."""
    from repro_torch.models import init_lm
    from repro_torch.utils.pytree import tree_leaves
    phi0 = {"theta": init_lm(0, cfg, device="cuda")}
    first0 = tree_leaves(phi0)[0].clone()
    runs = {}

    res, state, box = _launch_run(torch, cfg, "fomaml", LAUNCH_CUT["fomaml"],
                                  2, phi0, keep_step1=True)
    moved = any(not torch.equal(a, b) for a, b in
                zip(tree_leaves(state["phi"]), tree_leaves(phi0)))
    del state
    with all_plain():
        plain, pstate, _ = _launch_run(torch, cfg, "fomaml",
                                       LAUNCH_CUT["fomaml"], 1, phi0)
    _check_plain(plain["launches"], "FOMAML plain route (bf16)", errors)
    # φ is the bf16 tree: Adam's first step moves each entry by at most
    # lr, so the routes' pre-rounding values differ by at most 2·lr, and
    # rounding to bf16 adds at most one ulp, 2^-7·|φ|. This holds for
    # any gradient (a sanity bound); the first moment m is the check
    lr = LAUNCH_LR["outer_lr"]
    d_phi = phi_share = 0.0
    for a, b in zip(tree_leaves(box["phi"]), tree_leaves(pstate["phi"])):
        d = (a.float() - b.float()).abs()
        d_phi = max(d_phi, float(d.max()))
        phi_share = max(phi_share, float(
            (d / (2 * lr + 2.0 ** -7 * b.float().abs())).max()))
    d_g = _tree_rel_gap(box["m"], pstate["opt"]["m"])
    del box, pstate
    g_tol = 0.125
    res.update(moved=moved, plain_route_step1={
        "max_abs_dphi": d_phi, "phi_tol": "per entry: 2·lr + 2^-7·|φ|",
        "phi_worst_of_limit": phi_share, "meta_grad_rel": d_g,
        "meta_grad_tol": g_tol, "plain_step_ms": plain["step_ms"],
        "plain_peak_gb": plain["peak_gb"]})
    runs["fomaml"] = res
    if not moved:
        errors.append("FOMAML at L=4096: φ did not move")
    if not (phi_share <= 1.0 and d_g <= g_tol):
        errors.append(f"FOMAML step 1 vs the plain route: |dφ| {d_phi} "
                      f"({phi_share} of 2·lr + 2^-7·|φ|), meta-gradient "
                      f"{d_g} (limit {g_tol})")

    runs["fomaml_traced_step"] = launch_traced_step(torch, cfg, phi0)

    res, state, _ = _launch_run(torch, cfg, "maml", LAUNCH_CUT["maml"], 1,
                                phi0)
    res["moved"] = any(not torch.equal(a, b) for a, b in
                       zip(tree_leaves(state["phi"]), tree_leaves(phi0)))
    del state
    runs["maml"] = res
    if not res["moved"]:
        errors.append("MAML at L=4096: φ did not move")

    for remat in (True, False):
        res, state, _ = _launch_run(torch, cfg, "fomaml", LAUNCH_CUT["small"],
                                    1, phi0, remat=remat)
        del state
        runs[f"fomaml_small_remat_{'on' if remat else 'off'}"] = res

    # float32 at the small cut: both routes compute one function
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    phi32 = {"theta": init_lm(0, cfg32, device="cuda")}
    ms = []
    for plain_route in (False, True):
        with (all_plain() if plain_route else contextlib.nullcontext()):
            res, state, box = _launch_run(torch, cfg32, "fomaml",
                                          LAUNCH_CUT["small"], 1, phi32,
                                          keep_step1=True)
        if plain_route:
            _check_plain(res["launches"], "FOMAML plain route (f32)", errors)
        ms.append(box["m"])
        del state, box
    f32 = {"meta_grad_rel": _tree_rel_gap(ms[0], ms[1]),
           "meta_grad_tol": 1e-3}
    del ms, phi32
    runs["plain_route_step1_f32"] = f32
    if not f32["meta_grad_rel"] <= f32["meta_grad_tol"]:
        errors.append(f"f32 step 1 vs the plain route: {f32}")

    for name, r in runs.items():
        if "metrics" not in r:
            continue
        if not all(math.isfinite(m["query_loss"]) for m in r["metrics"]):
            errors.append(f"{name}: non-finite loss {r['metrics']}")
        for k in ("inner_update_plane", "flash_attention"):
            if r["launches"][k] <= 0:
                errors.append(f"{name}: {k} not launched")
    if not torch.equal(tree_leaves(phi0)[0], first0):
        errors.append("the launcher wrote into the initial φ")
    return runs


def second_order_checks(torch, errors):
    """The repair of K7's and K9's backward on the card: one MAML and one
    Meta-SGD meta-gradient on the client plane, kernel route against
    the plain route (impl="torch", attention or the SSD plain), within
    1e-5 of the largest entry: at the `lm` scenario's f32 shape through
    K7 (4 clients × 4 + 4 sequences of 16 tokens, the scenario's reduced
    SmolLM), and on Mamba2's reduced config in f32 through K9 (32
    tokens, two chunks), and on seamless-m4t's reduced config in f32
    through K7's bidirectional encoder and its cross-attention (4 + 4
    sequences of 16 tokens over 8 frames of f32 embeddings). Both kernels
    must launch under the kernel route. A backward that returned
    constants would drop the Hessian terms, several % of the largest
    entry."""
    import numpy as np
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import lm_loss
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.utils.flat import plane_for
    lm_cfg = dataclasses.replace(
        reduced_config(get_config("smollm-360m")), num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=64,
        dtype="float32")
    cases = (("smollm lm scenario", lm_cfg, 16, "flash_attention", 0.1),
             ("mamba2 reduced", reduced_config(get_config("mamba2-370m")),
              32, "ssd_chunk", 0.05),
             ("seamless reduced",
              reduced_config(get_config("seamless-m4t-medium")), 16,
              "flash_attention", 0.1))
    out = []
    for label, cfg, L, kernel, inner_lr in cases:
        rng = np.random.RandomState(0)
        sup, qry = (torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                                (4, 4, L)),
                                    dtype=torch.int32, device="cuda")
                    for _ in range(2))
        if cfg.modality:
            sup, qry = ({"tokens": t, "embeds": torch.as_tensor(
                rng.normal(0, 0.1, (4, 4, cfg.num_modality_tokens,
                                    cfg.d_model)),
                dtype=torch.float32, device="cuda")} for t in (sup, qry))
        for name in ("maml", "meta-sgd"):
            algo = make_algorithm(name, *lm_loss(make_apply_fn(cfg)),
                                  inner_lr)
            phi = algo.init_state(0, lambda k: init_lm(k, cfg,
                                                       device="cuda"))
            pplane, tplane = plane_for(phi), plane_for(phi["theta"])
            reset_launches()
            G, _ = algo.client_grad_chunk_packed(pplane, tplane, phi, sup,
                                                 qry, impl="cuda")
            launched = read_launches()[kernel]
            reset_launches()
            with all_plain():
                G_p, _ = algo.client_grad_chunk_packed(
                    pplane, tplane, phi, sup, qry, impl="torch")
            plain_launched = read_launches()[kernel]
            rel = float((G - G_p).abs().max() / G_p.abs().max())
            row = {"case": label, "algo": name, "kernel": kernel,
                   "launches": launched, "plain_launches": plain_launched,
                   "meta_grad_rel": rel, "tol": 1e-5}
            if name == "maml":
                fo = make_algorithm("fomaml", *lm_loss(make_apply_fn(cfg)),
                                    inner_lr)
                G_fo, _ = fo.client_grad_chunk_packed(pplane, tplane, phi,
                                                      sup, qry, impl="cuda")
                row["second_order_share"] = float(
                    (G - G_fo).abs().max() / G_p.abs().max())
            out.append(row)
            if not (rel <= 1e-5 and launched > 0 and plain_launched == 0):
                errors.append(f"second order through {kernel}: {row}")
    return out


def serve_dense(torch, arch, errors, *, layers=None, trace=False):
    """`build_engine` + `ServingEngine.serve` of a config at full width
    (bf16, random weights, seed 0; depth cut to `layers` if given): a
    warm-up request, then DENSE_SERVE's two requests with every kernel's
    count from 0; K1, K7 and K8 launched (K8 once a layer a step for the
    group of two), one miss and one hit, finite rows, tokens in range,
    finite prefill logits of the adapted row, adapt and decode ms, peak
    GB; the group's batched route against the per-request and plain
    routes (`batched_generation`). With `trace`, torch.profiler spans
    over one more request's adaptation and over its decode."""
    from repro_torch.configs import get_config
    from repro_torch.federated.serving import TrafficModel
    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.steps import make_prefill_step
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    d = DENSE_SERVE
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = build_engine(cfg, algo_name="fomaml", inner_lr=0.05,
                          adapt_batch=d["adapt_batch"],
                          cache_capacity=1, device="cuda")
    init_s = time.perf_counter() - t0

    def mk(rng, size):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                           (size, d["sup_len"])),
                               dtype=torch.int32)

    def mp(rng):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                           (d["prompt_len"],)),
                               dtype=torch.int32)

    traffic = dict(num_clients=1, rate=32.0, support_sizes=(2,))
    engine.serve(TrafficModel(seed=99, **traffic).requests(1, mk, mp),
                 max_new_tokens=2)
    engine.cache.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = TrafficModel(seed=0, **traffic).requests(d["requests"], mk, mp)
    reset_launches()
    report = engine.serve(reqs, max_new_tokens=d["new_tokens"])
    launches = read_launches()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    summary = report.summary()
    miss = next(r for r in report.records if not r["hit"])
    with torch.no_grad():
        logits, _ = make_prefill_step(cfg)(engine.unpack_row(miss["row"]),
                                           reqs[0].prompt[None].cuda())
    finite = bool(torch.isfinite(logits).all())
    for name in ("inner_update_plane", "flash_attention", "flash_decode"):
        if launches[name] <= 0:
            errors.append(f"{arch} serve: {name} not launched")
    k8_want = generation_launches(cfg, d["new_tokens"])["flash_decode"]
    if launches["flash_decode"] != k8_want:
        errors.append(f"{arch} serve: K8 launched {launches['flash_decode']} "
                      f"times, not {k8_want} (one group)")
    for rec in report.records:
        toks = rec.get("tokens")
        if not bool(torch.isfinite(rec["row"]).all()):
            errors.append(f"{arch} serve: non-finite adapted row")
        if toks is None or toks.shape != (d["new_tokens"],) or not (
                (toks >= 0).all() and (toks < cfg.vocab_size).all()):
            errors.append(f"{arch} serve: bad tokens {toks}")
    if not finite:
        errors.append(f"{arch} serve: non-finite prefill logits")
    if (summary["misses"], summary["hits"]) != (1, 1):
        errors.append(f"{arch} serve: {summary['misses']} misses and "
                      f"{summary['hits']} hits, not one of each")
    res = {"arch": arch, "num_layers": cfg.num_layers,
           "n_plane": engine.plane.n_padded,
           "init_s": init_s, **d, "summary": summary,
           "adapt_ms": miss["adapt_ms"], "decode_ms": miss["decode_ms"],
           "prefill_logits_finite": finite, "logits_shape": list(
               logits.shape), "peak_mem_gb": peak, "launches": launches}
    del miss, logits
    res["batched"] = batched_generation(
        torch, cfg, engine, reqs, {r["rid"]: r for r in report.records},
        d["new_tokens"], errors)
    res["peak_with_batched_gb"] = _peak_gb(torch)
    if not res["peak_with_batched_gb"] < 80:
        errors.append(f"{arch} serve: peak {res['peak_with_batched_gb']} GB, "
                      f"not under 80")
    del report
    if trace:
        req = TrafficModel(seed=1, **traffic).requests(1, mk, mp)

        def adapt_only():
            engine.cache.clear()
            engine.serve(req, max_new_tokens=0)

        res["trace_adapt"] = _device_profile(torch, adapt_only)
        res["trace_decode"] = _device_profile(          # a cache hit
            torch, lambda: engine.serve(req, max_new_tokens=d["new_tokens"]))
    del engine
    return res, launches


def phase_train_launcher(torch):
    """The LM training launcher on the card: one JSON line per part,
    each with its seconds."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m")
    paths, failed = {}, []
    parts = (("reduced", lambda e: launch_reduced(torch, e)),
             ("full_width", lambda e: launch_full_width(torch, cfg, e)),
             ("second_order", lambda e: second_order_checks(torch, e)),
             ("serve_granite", lambda e: serve_dense(torch, "granite-3-2b",
                                                     e)),
             ("serve_qwen", lambda e: serve_dense(torch, "qwen2.5-3b", e)))
    for part, fn in parts:
        errors = []
        t0 = time.perf_counter()
        res = fn(errors)
        if part == "full_width":
            paths["train_launcher"] = res["fomaml"]["launches"]
        elif part.startswith("serve_"):
            res, paths[part] = res
        emit({"phase": "train_launcher", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, "result": res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# --------------------------------------------------------------- serve_moe

# The MoE and MLA families at full width (every width, head count, expert
# count, vocabulary and window the configs give), depth cut to what one
# card holds (bf16 weights, GB): mixtral-8x22b served at 1 layer (2.91 B
# parameters; a row of the f32 adaptation plane is 11.6 GB) and decoded
# at 4 (10.4 B, 20.8 GB); jamba-v0.1-52b at one period of 8 layers (13.3
# B, 26.5 GB); deepseek-v2-236b at its lead dense layer and one MoE layer
# (5.0 B, 10.0 GB). Prefill prompts of 4,096 tokens (mixtral's handoff
# 4,608, past its 4,096-token window), decode at decode_32k's batch of 128
# against 32,768 slots (mixtral's ring: the window's 4,096).
MOE_CUTS = {"mixtral-8x22b": 4, "jamba-v0.1-52b": 8, "deepseek-v2-236b": 2}
MOE_PREFILL_L = 4096
MOE_HANDOFF_L = {"mixtral-8x22b": 4608, "jamba-v0.1-52b": 4096,
                 "deepseek-v2-236b": 4096}
MOE_DECODE = dict(batch=128, seq=32768, steps=4)      # decode_32k
# kernels each path must launch; a decode on a path without K8 (MLA's
# absorbed decode is plain einsums) must launch no attention kernel
MOE_LAUNCHED = {
    "mixtral-8x22b": {"prefill": ("flash_attention",),
                      "decode": ("flash_decode",)},
    "jamba-v0.1-52b": {"prefill": ("flash_attention", "ssd_chunk"),
                       "decode": ("flash_decode",)},
    "deepseek-v2-236b": {"prefill": ("flash_attention",), "decode": ()}}


def _reset_peak(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gb(torch) -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def routed_overflow(torch, logits, K, capacity):
    """Entries past capacity, counted from the router logits alone,
    without a sort: token t picks expert e iff fewer than K experts beat
    it (a larger logit, or an equal one at a lower id, `lax.top_k`'s
    order); Σ_e max(count_e − capacity, 0)."""
    T, E = logits.shape
    a, b = logits[:, :, None], logits[:, None, :]       # e, e'
    lower = (torch.arange(E, device=logits.device)[None, :]
             < torch.arange(E, device=logits.device)[:, None])  # e' < e
    beaten_by = ((b > a) | ((b == a) & lower[None])).sum(-1)
    counts = (beaten_by < K).sum(0)
    return int((counts - capacity).clamp(min=0).sum()), counts


def moe_determinism(torch, errors):
    """`moe_apply` at mixtral-8x22b's serve shape (the adaptation's
    2 x 64 support tokens, d_model 6144, 8 experts of 16,384, top-2;
    one layer's experts, random bf16 weights) at cfg.capacity_factor and
    at 0.5 (every expert overflows: the rank-0 clobber): forward and the
    backward into x and every weight run twice, bitwise equal (the
    gathers' indices hit each row once, `models/moe.py`); the dropped
    entries equal the count taken from the router logits alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import Rng
    from repro_torch.utils.pytree import tree_leaves
    cfg = get_config("mixtral-8x22b")
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    params = moe.moe_init(Rng(0, "cuda"), cfg, torch.bfloat16)
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((2, 64, cfg.d_model), device="cuda", generator=gen
                    ).bfloat16().requires_grad_(True)
    ct = torch.randn((2, 64, cfg.d_model), device="cuda", generator=gen
                     ).bfloat16()
    out = []
    for cf in (cfg.capacity_factor, 0.5):
        with torch.no_grad():
            xt = x.reshape(-1, cfg.d_model)
            route = moe.moe_route(params, cfg, xt, cf)
            cap = int(math.ceil(xt.shape[0] * K / E * cf))
            logits = (xt @ params["w_router"]).float()
            counted, counts = routed_overflow(torch, logits, K, cap)
        runs = []
        for _ in range(2):
            y, aux = moe.moe_apply(params, cfg, x, capacity_factor=cf)
            loss = (y.float() * ct.float()).sum() + aux
            runs.append([y.detach()] + list(torch.autograd.grad(
                loss, [x] + leaves)))
            torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        row = {"capacity_factor": cf, "capacity": route["capacity"],
               "capacity_check": cap,
               "counts": route["counts"].tolist(),
               "counts_from_logits": counts.tolist(),
               "dropped": moe.dropped_entries(route),
               "dropped_from_logits": counted,
               "overflowing_experts": int((route["counts"] > cap).sum()),
               "y_finite": bool(torch.isfinite(runs[0][0]).all()),
               "forward_backward_bitwise": same}
        out.append(row)
        if not (same and row["y_finite"] and cap == route["capacity"]
                and row["dropped"] == counted
                and row["counts"] == row["counts_from_logits"]):
            errors.append(f"moe_apply on the card: {row}")
        del runs, y, aux, loss
    del params, leaves, x, ct
    return {"shape": "T=128 d=6144 E=8 ff=16384 top-2 bf16",
            "deterministic_by": "gathers whose indices hit each real row "
                                "once (no use_deterministic_algorithms)",
            "runs": out}


def lm_logits_f32_by_layer(torch, cfg, params, tokens):
    """`lm_apply`'s logits in float32 from bf16 weights, each layer's
    weights cast up only while it runs (a whole f32 copy of a cut MoE
    model would not fit beside its bf16 one, nor would jamba's whole
    period of 8 layers): the forward `lm_apply` computes for the f32
    cast of the weights."""
    import torch.nn.functional as F
    from repro_torch.models.blocks import block_forward
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.lm import _reps, layer_groups
    from repro_torch.utils.pytree import tree_map
    up = lambda t: tree_map(lambda a: a.float(), t)
    lead, period, n_reps = layer_groups(cfg)
    B, L = tokens.shape
    x = F.embedding(tokens, params["embed"]).float()
    pos = torch.arange(L, dtype=torch.int32, device=tokens.device
                       ).expand(B, L)
    with torch.no_grad():
        for i, spec in enumerate(lead):
            x, _ = block_forward(up(params[f"lead_{i}"]), cfg, spec, x, pos)
        for rep in _reps(params["stack"], n_reps):
            for j, spec in enumerate(period):
                x, _ = block_forward(up(rep[f"pos{j}"]), cfg, spec, x, pos)
        x = rmsnorm(up(params["final_norm"]), x, cfg.norm_eps)
        head = (params["embed"].t() if cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.float()


def moe_handoff(torch, cfg, params, L, errors):
    """The prefill -> decode handoff at full width, B = 1: prefill L
    tokens into a cache with room for 2 more (`lm_apply(collect_cache=
    True)`; mixtral's GQA ring is its window whatever the room), decode
    2 tokens, each step's logits against `lm_apply` over the extended
    prompt, at capacity_factor E/K so that no entry drops on either path
    (drops depend on the batch, `tests/test_arch_smoke.py:145-152`). In
    bf16 held, as `serve_handoff` holds Mamba2's, within twice the
    distance by which bf16 rounding alone moves the full forward from
    the same forward in f32 (computed layer by layer)."""
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (L + 2,), generator=gen,
                         dtype=torch.int32)
    gaps, full_bf16 = handoff_gaps(torch, cfg, params, toks[:L], toks[L:],
                                   capacity=L + 2)
    full_f32 = lm_logits_f32_by_layer(torch, cfg, params,
                                      toks[None].cuda())[0, L - 1:]
    spread = float((full_bf16 - full_f32).abs().max())
    tol = 2.0 * spread
    if not max(gaps) <= tol:
        errors.append(f"{cfg.name} bf16 handoff gaps {gaps} above {tol}")
    return {"prompt_len": L, "decoded": 2, "capacity_factor":
            cfg.capacity_factor, "gaps_bf16": gaps,
            "bf16_rounding_spread": spread, "bf16_tol": tol,
            "max_abs_logit": float(full_f32.abs().max())}


def moe_model(torch, arch, errors):
    """One cut config (`MOE_CUTS`) at full width: the prefill of
    MOE_PREFILL_L tokens through `make_prefill_step` (launches of the
    path's kernels, finite next-token logits), decode_32k through
    `launch/serve.decode_steps` (the decode launcher's body) on the same
    weights, and the handoff; each with its seconds, launches and peak
    GB over the weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_lm
    from repro_torch.utils.pytree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_CUTS[arch])
    want = MOE_LAUNCHED[arch]
    _reset_peak(torch)
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device="cuda")
    res = {"arch": arch, "num_layers": cfg.num_layers,
           "init_s": time.perf_counter() - t0,
           "weights_gb": torch.cuda.memory_allocated() / 1e9,
           "init_peak_gb": _peak_gb(torch)}

    _reset_peak(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_PREFILL_L),
                         device="cuda", generator=gen, dtype=torch.int32)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, toks)
    torch.cuda.synchronize()
    launches = read_launches()
    res["prefill"] = {"L": MOE_PREFILL_L, "s": time.perf_counter() - t0,
                      "finite": bool(torch.isfinite(logits).all()),
                      "logits_shape": list(logits.shape),
                      "cache_gb": sum(
                          nbytes(t) for t in tree_leaves(cache)
                          if isinstance(t, torch.Tensor)) / 1e9,
                      "peak_gb": _peak_gb(torch), "launches": launches}
    del logits, cache
    for name in want["prefill"]:
        if launches[name] <= 0:
            errors.append(f"{arch} prefill: {name} not launched")
    if not res["prefill"]["finite"]:
        errors.append(f"{arch} prefill: non-finite logits")

    _reset_peak(torch)
    t0 = time.perf_counter()
    res["handoff"] = moe_handoff(torch, cfg, params, MOE_HANDOFF_L[arch],
                                 errors)
    res["handoff"].update(s=time.perf_counter() - t0, peak_gb=_peak_gb(torch))

    _reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    out = serve.decode_steps(cfg, MOE_DECODE["batch"], MOE_DECODE["seq"],
                             MOE_DECODE["steps"], params=params)
    launches = read_launches()
    res["decode"] = {**out, "s": time.perf_counter() - t0,
                     "ms_per_step": [t * 1e3 for t in out["step_s"]],
                     "peak_gb": _peak_gb(torch), "launches": launches}
    if not out["logits_finite"] or out["logits_shape"] != (
            MOE_DECODE["batch"], cfg.vocab_size):
        errors.append(f"{arch} decode: {out['logits_shape']}, finite "
                      f"{out['logits_finite']}")
    for name in want["decode"]:
        if launches[name] <= 0:
            errors.append(f"{arch} decode: {name} not launched")
    idle = {"flash_attention", "flash_decode"} - set(want["decode"])
    for name in sorted(idle):
        if launches[name]:
            errors.append(f"{arch} decode: {name} launched {launches[name]}"
                          f" times")
    del params
    paths = {f"{arch}_prefill": res["prefill"]["launches"],
             f"{arch}_decode": launches}
    return res, paths


def phase_serve_moe(torch):
    """The MoE and MLA families at full width, one JSON line a part."""
    paths, failed = {}, []
    parts = (("moe_apply", lambda e: (moe_determinism(torch, e), {})),
             ("serve_mixtral", lambda e: serve_dense(
                 torch, "mixtral-8x22b", e, layers=1, trace=True)),
             ("mixtral", lambda e: moe_model(torch, "mixtral-8x22b", e)),
             ("jamba", lambda e: moe_model(torch, "jamba-v0.1-52b", e)),
             ("deepseek", lambda e: moe_model(torch, "deepseek-v2-236b", e)))
    for part, fn in parts:
        errors = []
        _reset_peak(torch)
        t0 = time.perf_counter()
        res, launched = fn(errors)
        if part == "serve_mixtral":
            paths["serve_mixtral"] = launched
        else:
            paths.update(launched)
        emit({"phase": "serve_moe", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0,
              "peak_mem_gb": _peak_gb(torch), "result": res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# -------------------------------------------------------- serve_multimodal

# The encoder-decoder and vision-prefix families at full width (every
# width, head, vocabulary, frame and patch count the configs give), bf16,
# random weights (seed 0), embeddings normal(0, 0.1) from seed 0 cast to
# bf16, as the launcher draws them. seamless-m4t-medium (0.88 B
# parameters, 1.76 GB) runs at full depth (12 encoder + 12 decoder
# layers) but for decode_32k, whose KV cache is 17.18 GB a decoder layer:
# 3 of 12 layers there. Its launcher runs train_4k's 4,096 text tokens
# over 1,024 frames, cut to 1 client and to the first of MM_LAUNCH_SEQS
# sequences a client whose step fits the card. qwen2-vl-7b (7.63 B,
# 15.26 GB) prefills at full depth (28 layers) 1,024 patch embeddings +
# 3,072 text tokens (train_4k's vision layout); decode_32k's cache is 8.59
# GB a layer: 4 of 28 layers. qwen2-vl is not meta-trained on the card:
# φ, the f32 accumulator and Adam's m and v alone are 106.8 GB.
MM_ARCHS = ("seamless-m4t-medium", "qwen2-vl-7b")
MM_SEQ = 4096                                  # train_4k / the prefill
MM_LAUNCH_SEQS = (8, 4, 2)                     # tried in turn
MM_HANDOFF_EXTRA = 4                           # tokens decoded
MM_DECODE_LAYERS = {"seamless-m4t-medium": 3, "qwen2-vl-7b": 4}


def mm_embeds(torch, cfg, batch: int, seed: int = 0, device="cuda"):
    """(batch, n_mod, d_model) modality embeddings: normal(0, 0.1) from
    `seed`, cast to cfg.dtype (`launch/train.task_batch`'s draw)."""
    import numpy as np
    from repro_torch.models.layers import as_dtype
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.normal(
        0, 0.1, (batch, cfg.num_modality_tokens, cfg.d_model))).to(
        device=device, dtype=as_dtype(cfg.dtype))


def mm_prompt(torch, cfg, seed=3, device="cuda"):
    """One prompt of MM_SEQ tokens in all: the text after the patches for
    a vision config, the whole text over the frames for the encoder-
    decoder; then MM_HANDOFF_EXTRA tokens to decode."""
    n_text = MM_SEQ - (cfg.num_modality_tokens if cfg.mrope else 0)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (n_text + MM_HANDOFF_EXTRA,),
                         generator=gen, dtype=torch.int32)
    return toks[:n_text], toks[n_text:]


def mm_prefill(torch, cfg, params, prompt, embeds):
    """`make_prefill_step` on [prompt | embeds] at B = 1: seconds,
    launches, finite next-token logits, cache GB, peak GB."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.utils.pytree import tree_leaves
    _reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(
            params, {"tokens": prompt[None].to("cuda"), "embeds": embeds})
    torch.cuda.synchronize()
    res = {"text_tokens": prompt.numel(),
           "modality_tokens": embeds.shape[1],
           "s": time.perf_counter() - t0, "launches": read_launches(),
           "finite": bool(torch.isfinite(logits).all()),
           "logits_shape": list(logits.shape),
           "cache_length": int(cache["length"]),
           "cache_gb": sum(nbytes(t) for t in tree_leaves(cache)
                           if isinstance(t, torch.Tensor)) / 1e9,
           "peak_gb": _peak_gb(torch)}
    del logits, cache
    return res


def mm_decode(torch, cfg, errors):
    """decode_32k's batch of 128 against 32,768 slots at
    MM_DECODE_LAYERS's depth through `launch/serve.decode_steps` (an
    encoder-decoder's cache holds a zero encoder output of 1,024 frames,
    the reference's decode cache): K8 on the self-attention cache, and
    for seamless K7 at Lq = 1 for the cross-attention, every layer and
    step."""
    from repro_torch.launch import serve
    cut = dataclasses.replace(cfg, num_layers=MM_DECODE_LAYERS[cfg.name])
    _reset_peak(torch)
    reset_launches()
    t0 = time.perf_counter()
    out = serve.decode_steps(cut, MOE_DECODE["batch"], MOE_DECODE["seq"],
                             MOE_DECODE["steps"])
    launches = read_launches()
    res = {**out, "s": time.perf_counter() - t0,
           "ms_per_step": [t * 1e3 for t in out["step_s"]],
           "peak_gb": _peak_gb(torch), "launches": launches}
    want = cut.num_layers * MOE_DECODE["steps"]
    if not out["logits_finite"] or out["logits_shape"] != (
            MOE_DECODE["batch"], cfg.vocab_size):
        errors.append(f"{cfg.name} decode: {out['logits_shape']}, finite "
                      f"{out['logits_finite']}")
    if launches["flash_decode"] != want:
        errors.append(f"{cfg.name} decode: K8 launched "
                      f"{launches['flash_decode']} times, not {want}")
    k7 = want if cfg.is_encoder_decoder else 0
    if launches["flash_attention"] != k7:
        errors.append(f"{cfg.name} decode: K7 launched "
                      f"{launches['flash_attention']} times, not {k7}")
    if cfg.is_encoder_decoder:
        res["traced_step"] = mm_traced_decode(torch, cut)
    return res, launches


def mm_traced_decode(torch, cut):
    """One decode step of `decode_steps`' setting (weights from seed 0,
    the cache holding 64 tokens and a zero encoder output) under
    torch.profiler: device activity by kernel group."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_decode_cache, init_lm
    from repro_torch.models.layers import as_dtype
    B = MOE_DECODE["batch"]
    params = init_lm(0, cut, device="cuda")
    enc = torch.zeros((B, cut.num_modality_tokens, cut.d_model),
                      dtype=as_dtype(cut.dtype), device="cuda")
    cache = init_decode_cache(cut, B, MOE_DECODE["seq"], enc_out=enc)
    cache["length"] = 64
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    decode = make_decode_step(cut)
    with torch.no_grad():
        decode(params, cache, tok)                   # warm
        _, trace = _traced(torch, lambda: decode(params, cache, tok))
    del params, cache, enc
    return trace


def mm_launcher(torch, cfg, errors):
    """`launch/train.train` of seamless-m4t-medium at full width and
    depth: 2 FOMAML steps at train_4k's 4,096 text tokens over 1,024
    frames a sequence, one client, at the first cut of MM_LAUNCH_SEQS
    sequences (half support, half query) whose step fits the card (an
    out-of-memory cut is reported and the next one tried). K1 and K7
    launched, finite loss, φ moved; step ms and peak GB."""
    from repro_torch.models import init_lm
    from repro_torch.utils.pytree import tree_leaves
    phi0 = {"theta": init_lm(0, cfg, device="cuda")}
    tried = []
    for S in MM_LAUNCH_SEQS:
        oom = None
        try:
            res, state, _ = _launch_run(torch, cfg, "fomaml", (S, 1), 2,
                                        phi0)
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0]
        if oom is not None:
            # freed once the exception and its frames are gone
            tried.append({"seqs_per_client": S, "out_of_memory": oom})
            gc.collect()
            torch.cuda.empty_cache()
            continue
        res["moved"] = any(not torch.equal(a, b) for a, b in
                           zip(tree_leaves(state["phi"]), tree_leaves(phi0)))
        del state
        gc.collect()
        torch.cuda.empty_cache()
        res["tried"] = tried
        res["traced_step"] = launch_traced_step(torch, cfg, phi0, (S, 1))
        if not res["moved"]:
            errors.append("seamless launcher: φ did not move")
        if not all(math.isfinite(m["query_loss"]) for m in res["metrics"]):
            errors.append(f"seamless launcher: non-finite loss "
                          f"{res['metrics']}")
        for k in ("inner_update_plane", "flash_attention"):
            if res["launches"][k] <= 0:
                errors.append(f"seamless launcher: {k} not launched")
        return res, res["launches"]
    errors.append(f"seamless launcher: no cut fits: {tried}")
    return {"tried": tried}, {}


def mm_seamless(torch, cfg, errors):
    """seamless-m4t-medium at full width and depth: the 4,096-token
    prefill over 1,024 frames (K7: 12 bidirectional encoder layers, 12
    causal self- and 12 cross-attention decoder layers), and the
    prefill -> decode handoff of MM_HANDOFF_EXTRA tokens against the full
    forward: in float32 (the bf16 weights cast up, 3.5 GB) within 2e-3 +
    2e-3·max|logits|, the Mamba2 phase's limit; in bf16 within twice the
    bf16 rounding spread. The cache has room for the decoded tokens."""
    from repro_torch.models import init_lm
    from repro_torch.utils.pytree import tree_leaves, tree_map
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device="cuda")
    res = {"arch": cfg.name, "num_layers": cfg.num_layers,
           "num_encoder_layers": cfg.num_encoder_layers,
           "init_s": time.perf_counter() - t0,
           "n_params": sum(t.numel() for t in tree_leaves(params)),
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    embeds = mm_embeds(torch, cfg, 1)
    prompt, extra = mm_prompt(torch, cfg)
    res["prefill"] = pre = mm_prefill(torch, cfg, params, prompt, embeds)
    k7 = cfg.num_encoder_layers + 2 * cfg.num_layers
    if pre["launches"]["flash_attention"] != k7 or not pre["finite"]:
        errors.append(f"seamless prefill: K7 {pre['launches']} (want {k7}),"
                      f" finite {pre['finite']}")

    _reset_peak(torch)
    t0 = time.perf_counter()
    cap = prompt.numel() + extra.numel()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tree_map(lambda x: x.float(), params)
    gaps32, full32 = handoff_gaps(torch, cfg32, params32, prompt, extra,
                                  capacity=cap, embeds=embeds.float())
    del params32
    gaps16, full16 = handoff_gaps(torch, cfg, params, prompt, extra,
                                  capacity=cap, embeds=embeds)
    spread = float((full16 - full32).abs().max())
    scale = float(full32.abs().max())
    res["handoff"] = {"prompt_len": prompt.numel(), "decoded": extra.numel(),
                      "gaps_f32": gaps32, "f32_tol": 2e-3 + 2e-3 * scale,
                      "gaps_bf16": gaps16, "bf16_rounding_spread": spread,
                      "bf16_tol": 2.0 * spread, "max_abs_logit": scale,
                      "s": time.perf_counter() - t0,
                      "peak_gb": _peak_gb(torch)}
    del full16, full32, params
    h = res["handoff"]
    if not max(gaps32) <= h["f32_tol"]:
        errors.append(f"seamless f32 handoff gaps {gaps32} above "
                      f"{h['f32_tol']}")
    if not max(gaps16) <= h["bf16_tol"]:
        errors.append(f"seamless bf16 handoff gaps {gaps16} above "
                      f"{h['bf16_tol']}")
    return res, {"seamless_prefill": pre["launches"]}


def mm_qwen2_vl(torch, cfg, errors):
    """qwen2-vl-7b at full width and depth: the prefill of 1,024 patch
    embeddings and 3,072 text tokens (K7 once a layer, G = 7, M-RoPE'd q
    and k), then the prefill -> decode handoff of MM_HANDOFF_EXTRA tokens
    through `make_prefill_step` and `make_decode_step` on the kernel route
    and on the plain route (K7, K8 plain), step by step within twice the
    bf16 rounding spread (the prefill's last logits in bf16 against the
    same forward with the weights cast to f32). Not against a full
    forward: the reference decodes at position n_mod + L_text, where its
    full forward puts that token at L_text + ⌈√n_mod⌉ (ROADMAP Queue 3)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_lm, lm_apply
    from repro_torch.utils.pytree import tree_leaves, tree_map
    t0 = time.perf_counter()
    params = init_lm(0, cfg, device="cuda")
    res = {"arch": cfg.name, "num_layers": cfg.num_layers,
           "init_s": time.perf_counter() - t0,
           "n_params": sum(t.numel() for t in tree_leaves(params)),
           "weights_gb": torch.cuda.memory_allocated() / 1e9}
    embeds = mm_embeds(torch, cfg, 1)
    prompt, extra = mm_prompt(torch, cfg)
    res["prefill"] = pre = mm_prefill(torch, cfg, params, prompt, embeds)
    if pre["launches"]["flash_attention"] != cfg.num_layers or \
            not pre["finite"]:
        errors.append(f"qwen2-vl prefill: K7 {pre['launches']} (want "
                      f"{cfg.num_layers}), finite {pre['finite']}")

    _reset_peak(torch)
    t0 = time.perf_counter()
    batch = {"tokens": prompt[None].cuda(), "embeds": embeds}
    routes = {}
    for route in ("kernel", "plain"):
        reset_launches()
        with torch.no_grad(), (all_plain() if route == "plain"
                               else contextlib.nullcontext()):
            decode = make_decode_step(cfg)
            logits, cache = make_prefill_step(cfg)(params, batch)
            steps = [logits.float()]
            for t in range(extra.numel()):
                logits, cache = decode(params, cache,
                                       extra[t:t + 1][None].cuda())
                steps.append(logits.float())
        routes[route] = (steps, read_launches())
        del cache
    gaps = [float((a - b).abs().max()) for a, b in
            zip(routes["kernel"][0], routes["plain"][0])]
    with torch.no_grad():
        params32 = tree_map(lambda x: x.float(), params)
        last32, _ = lm_apply(params32, dataclasses.replace(
            cfg, dtype="float32"), batch["tokens"],
            modality_embeds=embeds.float(), logits_mode="last")
        del params32
    spread = float((routes["plain"][0][0] - last32[:, 0]).abs().max())
    res["handoff_kernel_vs_plain"] = {
        "prompt_len": prompt.numel(), "decoded": extra.numel(),
        "gaps": gaps, "bf16_rounding_spread": spread,
        "tol": 2.0 * spread,
        "kernel_launches": routes["kernel"][1],
        "plain_launches": routes["plain"][1],
        "s": time.perf_counter() - t0, "peak_gb": _peak_gb(torch)}
    h = res["handoff_kernel_vs_plain"]
    if not max(gaps) <= h["tol"]:
        errors.append(f"qwen2-vl kernel vs plain route: gaps {gaps} above "
                      f"{h['tol']}")
    for name in ("flash_attention", "flash_decode"):
        if routes["plain"][1][name]:
            errors.append(f"qwen2-vl plain route launched {name}")
        if not routes["kernel"][1][name]:
            errors.append(f"qwen2-vl kernel route: {name} not launched")
    del params, routes, last32
    return res, {"qwen2vl_prefill": pre["launches"]}


def phase_serve_multimodal(torch):
    """The encoder-decoder and vision-prefix families at full width, one
    JSON line a part with its seconds and peak GB."""
    from repro_torch.configs import get_config
    s2t, vl = (get_config(a) for a in MM_ARCHS)
    paths, failed = {}, []
    parts = (("seamless", lambda e: mm_seamless(torch, s2t, e)),
             ("seamless_launcher", lambda e: mm_launcher(torch, s2t, e)),
             ("seamless_decode", lambda e: mm_decode(torch, s2t, e)),
             ("qwen2_vl", lambda e: mm_qwen2_vl(torch, vl, e)),
             ("qwen2_vl_decode", lambda e: mm_decode(torch, vl, e)))
    for part, fn in parts:
        errors = []
        _reset_peak(torch)
        t0 = time.perf_counter()
        res, launched = fn(errors)
        if part in ("seamless_launcher", "seamless_decode",
                    "qwen2_vl_decode"):
            paths[part] = launched
        else:
            paths.update(launched)
        emit({"phase": "serve_multimodal", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0,
              "peak_mem_gb": _peak_gb(torch), "result": res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# ------------------------------------------------------------ train_comm

# bytes of one FEMNIST round at m = 4 (download + upload) by upload
# codec, and the upload leg alone: φ is 1,846,520 B (n_real 461,630);
# int8 sends n_real + 4 B a client, top-5% 23,082 × (4 + 2) B
# (results/experiments/compression_femnist.json, femnist_compare.json)
COMM_ROUND_BYTES = {"f32": 14_772_160, "bf16": 11_079_120,
                    "int8+ef": 9_232_616, "topk0.05+ef": 7_940_048}
COMM_UPLOAD_BYTES = {"f32": 4 * 1_846_520, "bf16": 4 * 923_260,
                     "int8+ef": 4 * 461_634, "topk0.05+ef": 4 * 23_082 * 6}
METASGD_ROUND_BYTES = 29_544_320         # φ = {θ, α}: twice the bytes
CHANCE = 1.0 / 62                       # 62 FEMNIST classes


def _committed(name: str) -> dict:
    with open(os.path.join(HERE, "results", "experiments", name)) as f:
        return json.load(f)


def _same_state(torch, a, b) -> bool:
    """Two train states (nested dicts of tensors) equal bit for bit."""
    if sorted(a) != sorted(b):
        return False
    return all(_same_state(torch, a[k], b[k]) if isinstance(a[k], dict)
               else bool(torch.equal(a[k], b[k])) for k in a)


def _hold_bytes(errors, tag, rec, round_bytes, upload_bytes, codec):
    """Every history record's cumulative bytes and codec exactly."""
    comm = rec["comm"]
    if comm["comm_MB"] != comm["rounds"] * round_bytes / 1e6:
        errors.append(f"{tag}: {comm['comm_MB']} MB after {comm['rounds']} "
                      f"rounds, not {round_bytes} B a round")
    for h in rec["history"]:
        if (h["comm_MB"] != h["rounds"] * round_bytes / 1e6
                or h["upload_MB"] != h["rounds"] * upload_bytes / 1e6
                or h.get("codec") != codec):
            errors.append(f"{tag} round {h['round']}: comm_MB "
                          f"{h['comm_MB']}, upload_MB {h['upload_MB']}, "
                          f"codec {h.get('codec')}")
            break


def _finite_run(torch, rec, state) -> bool:
    """φ (FedMeta) or θ (FedAvg) and every float of the history finite."""
    from repro_torch.utils.pytree import tree_leaves
    params = state["phi"] if "phi" in state else state["theta"]
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)) \
        and all(math.isfinite(v) for h in rec["history"] for v in h.values()
                if isinstance(v, float))


def comm_sweep(torch, errors, rounds=30, eval_every=2):
    """(i) the compression sweep: FOMAML on FEMNIST, four upload codecs,
    through `launch/compare.sweep_compression` on the client plane; then
    int8+ef again on the all-plain route."""
    from repro_torch.federated.experiment import (_shared_target,
                                                 comm_to_target,
                                                 run_comparison)
    from repro_torch.launch.compare import (METHOD, compression_plan,
                                            sweep_compression)
    committed = _committed("compression_femnist.json")
    states, paths, walls = {}, {}, {}

    def around(label, run):
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        paths[label] = read_launches()
        states[label] = out["states"][METHOD]
        return out

    sweep = sweep_compression(rounds=rounds, eval_every=eval_every, seed=0,
                              device="cuda", log=None, around=around)
    runs = sweep["variants"]
    for label, rec in runs.items():
        codec = label if "+ef" in label else None
        _hold_bytes(errors, f"sweep {label}", rec, COMM_ROUND_BYTES[label],
                    COMM_UPLOAD_BYTES[label], codec)
        n = paths[label]
        want_k6 = rounds if label == "int8+ef" else 0
        if not (n["int8_encode"] == want_k6 and
                n["weighted_aggregate"] == rounds and
                n["adam_flat"] == rounds and n["inner_update_plane"] > 0):
            errors.append(f"sweep {label}: launches {n} (K6 {want_k6}, K2 "
                          f"and K3 {rounds} expected)")
        if not _finite_run(torch, rec, states[label]):
            errors.append(f"sweep {label}: non-finite run")
    plan = compression_plan("int8+ef", rounds=rounds, eval_every=eval_every)
    t0 = time.perf_counter()
    out_t = run_comparison(plan, device="cuda", impl="torch")
    torch.cuda.synchronize()
    walls["int8+ef plain route"] = time.perf_counter() - t0
    same_history = out_t["methods"][METHOD]["history"] == \
        runs["int8+ef"]["history"]
    same_state = _same_state(torch, out_t["states"][METHOD],
                             states["int8+ef"])
    if not (same_history and same_state):
        errors.append(f"int8+ef: kernel and plain routes differ (history "
                      f"{same_history}, φ/Adam/EF {same_state})")
    shared = _shared_target(runs, 2)
    if shared is None or not shared > CHANCE:
        errors.append(f"sweep: shared target {shared} not above chance")
    table = {}
    for label, rec in runs.items():
        table[label] = {
            "at_0.12": rec["comm_to_target"],
            "at_shared": comm_to_target(rec["history"], shared, 2)
            if shared is not None else None,
            "committed_at_0.12": committed["variants"][label][
                "comm_to_target"],
            "bytes_per_round": round(rec["comm"]["comm_MB"] * 1e6 / rounds),
            "upload_bytes_per_round": round(rec["comm"]["upload_MB"] * 1e6
                                            / rounds),
            "test_acc": rec["test_acc"],
            "last_eval_acc": [h["eval_acc"] for h in rec["history"]
                              if "eval_acc" in h][-1],
            "wall_s": walls[label], "round_ms": walls[label] / rounds * 1e3,
            "launches": paths[label]}
    return {"rounds": rounds, "eval_every": eval_every,
            "shared_target": shared, "variants": table,
            "upload_ratio_vs_bf16_at_0.12":
                sweep["upload_to_target_ratio_vs_bf16"],
            "committed_upload_ratio_vs_bf16":
                committed["upload_to_target_ratio_vs_bf16"],
            "plain_route_wall_s": walls["int8+ef plain route"],
            "bitwise_equal_plain_route": same_history and same_state}, \
        {f"comm_sweep[{k}]": v for k, v in paths.items()}


def comm_trace_round(torch):
    """One int8+ef FEMNIST round through the trainer, traced, after two
    untraced ones."""
    from repro_torch.federated.experiment import (DATASETS, _build_views,
                                                 make_trainer)
    from repro_torch.launch.compare import compression_plan
    plan = compression_plan("int8+ef", rounds=3, eval_every=0)
    view, _ = _build_views(plan, DATASETS["femnist"], "cuda")
    tr = make_trainer(plan, "fomaml", view.loss_fn, view.eval_fn, view.train,
                      device="cuda")
    state = tr.run(tr.init(plan.seed, view.model.init), 2)
    _, trace = _traced(torch, lambda: tr.run(state, 1))
    return trace


def comm_dp(torch, errors, rounds=5):
    """(ii) int8+ef with central DP (clip 0.5, noise 0.1): the kernel and
    plain routes, one noise generator per round from (seed, round)."""
    from repro_torch.federated.experiment import run_comparison
    from repro_torch.federated.privacy import DPConfig
    from repro_torch.launch.compare import METHOD, compression_plan
    plan = dataclasses.replace(
        compression_plan("int8+ef", rounds=rounds, eval_every=rounds),
        dp=DPConfig(clip_norm=0.5, noise_multiplier=0.1))
    reset_launches()
    t0 = time.perf_counter()
    out = run_comparison(plan, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    out_t = run_comparison(plan, device="cuda", impl="torch")
    rec, rec_t = out["methods"][METHOD], out_t["methods"][METHOD]
    same = rec["history"] == rec_t["history"] and _same_state(
        torch, out["states"][METHOD], out_t["states"][METHOD])
    if not same:
        errors.append("DP: kernel and plain routes differ")
    if not _finite_run(torch, rec, out["states"][METHOD]):
        errors.append("DP: non-finite run")
    if launches["int8_encode"] != rounds:
        errors.append(f"DP: K6 launched {launches['int8_encode']} times")
    _hold_bytes(errors, "DP", rec, COMM_ROUND_BYTES["int8+ef"],
                COMM_UPLOAD_BYTES["int8+ef"], "int8+ef")
    return {"rounds": rounds, "dp": dataclasses.asdict(plan.dp),
            "wall_s": wall, "launches": launches,
            "bitwise_equal_plain_route": same,
            "last": {k: rec["history"][-1][k]
                     for k in ("query_loss", "accuracy", "eval_acc")}}, \
        {"comm_dp": launches}


# the committed FEMNIST plan's 100 rounds, cut to 40 when the
# multi_device phase joined (about 0.46 s a round of the five methods on
# an H100 80GB HBM3 at 700 W): bytes a round are held every round
COMPARE_ROUNDS = 40


@contextlib.contextmanager
def sanitizing():
    """``REPRO_SANITIZE=1`` for the duration: `run_comparison` then
    checks every method's record for tensors
    (`analysis.sanitizers.assert_no_tracers`)."""
    old = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_SANITIZE"]
        else:
            os.environ["REPRO_SANITIZE"] = old


def comm_compare(torch, errors, rounds=COMPARE_ROUNDS, eval_every=2):
    """(iii) the committed FEMNIST comparison plan on the client plane:
    FedAvg, FedAvg(Meta), MAML, FOMAML and Meta-SGD, cut to
    `COMPARE_ROUNDS`, under ``REPRO_SANITIZE=1`` (`sanitizing`)."""
    from repro_torch.federated.experiment import format_table, run_comparison
    from repro_torch.launch.compare import comparison_plan
    committed = _committed("femnist_compare.json")
    plan = comparison_plan("femnist", rounds=rounds, eval_every=eval_every)
    reset_launches()
    t0 = time.perf_counter()
    with sanitizing():
        out = run_comparison(plan, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for m, rec in out["methods"].items():
        rb = METASGD_ROUND_BYTES if m == "meta-sgd" else FEMNIST_ROUND_BYTES
        _hold_bytes(errors, f"compare {m}", rec, rb, rb // 2, None)
        if not _finite_run(torch, rec, out["states"][m]):
            errors.append(f"compare {m}: non-finite run")
    for name in ("inner_update_plane", "weighted_aggregate", "adam_flat"):
        if launches[name] <= 0:
            errors.append(f"compare: {name} not launched")
    table = {}
    for m, rec in out["methods"].items():
        row = out["comm_to_target"].get(m) or {}
        ref = committed["comm_to_target"].get(m) or {}
        table[m] = {k: row.get(k) for k in
                    ("rounds", "comm_MB", "comm_reduction_vs_fedavg")}
        table[m].update({f"committed_{k}": ref.get(k) for k in
                         ("rounds", "comm_MB", "comm_reduction_vs_fedavg")})
        table[m].update(test_acc=rec["test_acc"],
                        committed_test_acc=committed["methods"][m]["test_acc"],
                        seconds=rec["seconds"])
    print(format_table(out), flush=True)
    return {"rounds": rounds, "eval_every": eval_every, "sanitized": True,
            "target_acc": out["target_acc"],
            "committed_target_acc": committed["target_acc"],
            "wall_s": wall, "launches": launches, "table": table}, \
        {"comm_compare": launches}


def comm_lm(torch, cfg, errors):
    """(iv) 2 packed FOMAML rounds of SmolLM-360M at full width on the
    client plane with int8 uploads, error feedback over 8 client rows
    and DP (clip 1.0, noise 0.1); round 1 held against the all-plain
    route, round 2 traced."""
    import numpy as np
    from repro_torch.core import make_algorithm
    from repro_torch.core.fedmeta import (init_packed_state,
                                          make_packed_meta_train_step)
    from repro_torch.core.losses import lm_loss
    from repro_torch.federated.privacy import DPConfig, gaussian
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.meta_update.compress import CompressionConfig
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.optim import adam
    from repro_torch.utils.flat import plane_for
    from repro_torch.utils.pytree import tree_map

    M, S, Q, L, LR, CLIENTS = 4, 4, 4, 128, 1e-3, 8
    comp = CompressionConfig("int8")
    dp = DPConfig(clip_norm=1.0, noise_multiplier=0.1, seed=0)
    algo = make_algorithm("fomaml",
                          *lm_loss(make_apply_fn(cfg, remat=False)), 0.05)
    phi = {"theta": init_lm(0, cfg, device="cuda")}
    plane = plane_for(phi)
    opt = adam(LR)
    state = init_packed_state(opt, plane, phi, compression=comp,
                              num_clients=CLIENTS)
    del phi
    rng = np.random.RandomState(1)
    batches = [tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (M, n, L)),
                                     dtype=torch.int32, device="cuda")
                     for n in (S, Q)) for _ in range(2)]
    picks = [torch.tensor(p, device="cuda") for p in ([0, 2, 5, 7],
                                                      [1, 2, 4, 6])]
    kw = dict(client_plane=True, compression=comp, dp=dp)
    step = make_packed_meta_train_step(algo, opt, plane, impl="cuda", **kw)
    plain_step = make_packed_meta_train_step(algo, opt, plane, impl="torch",
                                             **kw)
    # round 1 on the all-plain route, from a copy (K3 and the EF write
    # update the state in place), with the same noise generator
    st = {"phi": state["phi"].clone(),
          "opt": tree_map(torch.clone, state["opt"]),
          "ef": state["ef"].clone()}
    with attn_ops.use_impl("torch"):
        st, _ = plain_step(st, *batches[0], None, picks[0],
                           dp.round_generator(1, "cuda"))
    phi_plain, m_plain = st["phi"], st["opt"]["m"]
    del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    state, met = step(state, *batches[0], None, picks[0],
                      dp.round_generator(1, "cuda"))
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    metrics = [{k: float(v) for k, v in met.items()}]
    d_phi = float((state["phi"] - phi_plain).abs().max())
    # Adam's m is (1 - b1)·meta-gradient after one step. Both routes add
    # the same noise (one generator seed), σ = 0.025 an entry, which
    # would set the scale of a relative gap; so the gap is taken
    # against the largest entry of the noiseless meta-gradient
    b1 = opt.hyper["b1"]
    noise = gaussian((plane.n_padded,), dp.round_generator(1, "cuda"), "cuda")
    noise[plane.n_real:] = 0
    g_scale = float((m_plain / (1 - b1) - dp.sigma(M) * noise).abs().max())
    d_g = float((state["opt"]["m"] - m_plain).abs().max()) / (1 - b1) \
        / g_scale
    del phi_plain, m_plain, noise
    box = {}

    def second():
        box["state"], box["met"] = step(state, *batches[1], None, picks[1],
                                        dp.round_generator(2, "cuda"))

    wall2, trace = _traced(torch, second)
    state = box["state"]
    walls.append(wall2)
    metrics.append({k: float(v) for k, v in box["met"].items()})
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches["int8_encode"] != 2:
        errors.append(f"LM: K6 launched {launches['int8_encode']} times in "
                      f"2 rounds")
    for name in ("inner_update_plane", "weighted_aggregate", "adam_flat",
                 "flash_attention"):
        if launches[name] <= 0:
            errors.append(f"LM: {name} not launched")
    if not bool(torch.isfinite(state["phi"]).all()):
        errors.append("LM: non-finite φ")
    touched = torch.zeros(CLIENTS, dtype=torch.bool, device="cuda")
    touched[torch.cat(picks)] = True
    live = state["ef"][:, :plane.n_real].abs().amax(dim=1) > 0
    if not (bool(torch.equal(live, touched))
            and not state["ef"][:, plane.n_real:].any()):
        errors.append(f"LM: EF rows written {live.tolist()}, picked "
                      f"{touched.tolist()}")
    # Adam's first step moves each entry of φ by at most lr, so |dφ| is
    # reported only: no route can exceed 2·lr. The meta-gradient is held
    # at train_lm's 1/8 of its largest noiseless entry (the kernel and
    # plain attention round bf16 differently through 32 layers, and the
    # int8 codes flip with it): the H100 reads 2.7e-2 here, 2.0e-2 in
    # train_lm
    g_tol = 0.125
    if not d_g <= g_tol:
        errors.append(f"LM round 1 vs the plain route: meta-gradient "
                      f"{d_g} of its largest entry (limit {g_tol})")
    out = {"arch": cfg.name, "n_plane": plane.n_padded, "clients": M,
           "ef_rows": CLIENTS, "ef_gb": state["ef"].numel() * 4 / 1e9,
           "support": S, "query": Q, "seq_len": L,
           "compression": comp.label(), "dp": dataclasses.asdict(dp),
           "round_wall_ms": [w * 1e3 for w in walls], "round2_traced": True,
           "metrics": metrics, "peak_mem_gb": peak_gb, "launches": launches,
           "plain_route_round1": {"max_abs_dphi": d_phi,
                                  "meta_grad_rel": d_g,
                                  "meta_grad_tol": g_tol},
           "trace_round2": trace}
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out, {"comm_lm": launches}


def phase_train_comm(torch, cfg):
    """The bytes-on-the-wire round and the experiment plane: one JSON
    line per part, each part's kernel launches counted from 0."""
    paths = {}
    failed = []
    for part in ("sweep", "dp", "compare", "lm"):
        errors = []
        t0 = time.perf_counter()
        if part == "sweep":
            res, p = comm_sweep(torch, errors)
            res["trace_int8_round"] = comm_trace_round(torch)
        elif part == "dp":
            res, p = comm_dp(torch, errors)
        elif part == "compare":
            res, p = comm_compare(torch, errors)
        else:
            res, p = comm_lm(torch, cfg, errors)
        paths.update(p)
        emit({"phase": "train_comm", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, **res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# ----------------------------------------------------------- train_faults

U32 = 2.0 ** -24               # unit roundoff of float32


def k5_cancellation_bound(torch, G, live, trim):
    """Per-coordinate bound on |K5 − sort route| for one block of finite
    live rows. K5 forms ((total − top) − bot) / d with d = n_live − 2·trim:
    the m ordered adds of total, the 2·(trim − 1) rounded adds of the
    extracted values (the selection itself is exact), two subtractions on
    partial results no larger than 2·S, S = Σ_u live·|g_u|, and the
    division: at most (m + 2·trim + 5)·u·S/d from the exact value. The
    sort route sums m masked values (≤ (m − 1)·u·S) and divides: at most
    m·u·S/d. Together: (2m + 2·trim + 5)·u·S/d."""
    m = G.shape[0]
    alive = live > 0
    S = torch.zeros((G.shape[1],), dtype=torch.float32, device=G.device)
    for u in range(m):
        S += torch.where(alive[u], G[u].float().abs(), 0.0)
    d = float(alive.sum()) - 2 * trim
    return (2 * m + 2 * trim + 5) * U32 * S / d


def faults_sweep(torch, errors):
    """(i) The committed robustness sweep, all 15 cells, through
    `launch/compare.sweep_robustness` from the port's own initial φ; then
    the byzantine 0.25 / trimmed cell on impl="torch"."""
    from repro_torch.federated.experiment import DATASETS
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.kernels.meta_update import aggregate as k5
    from repro_torch.kernels.meta_update import ops as mu_ops
    from repro_torch.launch import compare
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.optim import adam
    committed = _committed("robustness_femnist.json")
    want = {(c["kind"], c["fraction"], c["aggregator"]): c
            for c in committed["cells"]}
    cfg = compare.ROBUSTNESS
    rounds = cfg["rounds"]
    walls, counts, states, hists = {}, {}, {}, {}

    def around(tag, run):
        before = read_launches()
        t0 = time.perf_counter()
        tr, state = run()
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        after = read_launches()
        counts[tag] = {k: after[k] - before[k] for k in after}
        states[tag], hists[tag] = state, tr.history
        return tr, state

    reset_launches()
    t0 = time.perf_counter()
    sweep = compare.sweep_robustness(device="cuda", around=around, log=None)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    path = read_launches()

    # the initial train state every cell starts from, made anew
    model = DATASETS["femnist"]["model"]("cuda")
    algo = make_algorithm("fomaml", *classification_loss(model.apply),
                          cfg["inner_lr"])
    st0 = FederatedTrainer(algo, adam(cfg["outer_lr"]), [],
                           cfg["clients_per_round"],
                           support_frac=cfg["support_frac"],
                           support_size=cfg["support_size"],
                           query_size=cfg["query_size"], packed=True,
                           device="cuda").init(cfg["seed"], model.init)
    table = {}
    for cell in sweep["cells"]:
        key = (cell["kind"], cell["fraction"], cell["aggregator"])
        tag = " ".join(str(x) for x in key)
        n = counts[tag]
        ref = want[key]
        if cell["skipped_rounds"] != ref["skipped_rounds"]:
            errors.append(f"{tag}: skipped {cell['skipped_rounds']}, the "
                          f"artifact {ref['skipped_rounds']}")
        trimmed = cell["aggregator"] == "trimmed"
        want_k5, want_k2 = (rounds, 0) if trimmed else (0, rounds)
        if not (n["trimmed_mean"] == want_k5 and
                n["weighted_aggregate"] == want_k2 and
                n["adam_flat"] == rounds and n["inner_update_plane"] > 0):
            errors.append(f"{tag}: launches {n} (K5 {want_k5}, K2 "
                          f"{want_k2}, K3 {rounds} expected)")
        if ref["skipped_rounds"] == rounds and not _same_state(
                torch, states[tag], st0):
            errors.append(f"{tag}: every round skipped, but φ or the Adam "
                          f"state moved")
        if ref["skipped_rounds"] < rounds and not bool(
                torch.isfinite(states[tag]["phi"]).all()):
            errors.append(f"{tag}: non-finite φ")
        table[tag] = {"final_test_acc": cell["final_test_acc"],
                      "artifact_test_acc": ref["final_test_acc"],
                      "best_val_acc": cell["best_val_acc"],
                      "skipped_rounds": cell["skipped_rounds"],
                      "wall_s": walls[tag],
                      "round_ms": walls[tag] / rounds * 1e3,
                      "launches": n}
    byz = sweep["headline"]["byzantine_0.25"]
    art = committed["headline"]["byzantine_0.25"]
    headline = {"byzantine_0.25": byz, "artifact_byzantine_0.25": art,
                "trimmed_ge_2x_mean": byz["trimmed"] >= 2 * byz["mean"],
                "screen_ge_2x_mean": byz["screen"] >= 2 * byz["mean"],
                "artifact_trimmed_ge_2x_mean":
                    art["trimmed"] >= 2 * art["mean"],
                "artifact_screen_ge_2x_mean": art["screen"] >= 2 * art["mean"]}

    # the byzantine 0.25 / trimmed cell on the plain route (the sort),
    # its round-1 block captured on the way to the reduce
    captured = {}
    reduce = mu_ops.robust_aggregate

    def capture(gs, w, **kw):
        if not captured:
            captured["G"], captured["w"] = gs.clone(), w.clone()
        return reduce(gs, w, **kw)

    hist_t = {}

    def around_t(tag, run):
        tr, state = run()
        hist_t["h"] = tr.history
        return tr, state

    mu_ops.robust_aggregate = capture
    try:
        t0 = time.perf_counter()
        plain = compare.sweep_robustness(
            device="cuda", impl="torch", around=around_t, log=None,
            cells=[("byzantine", 0.25, "trimmed")])["cells"][0]
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    finally:
        mu_ops.robust_aggregate = reduce
    kern = hists["byzantine 0.25 trimmed"]
    ht = hist_t["h"]

    def train_fields(rec):
        return {k: v for k, v in rec.items() if not k.startswith("eval")}

    round1_equal = train_fields(ht[0]) == train_fields(kern[0])
    if not round1_equal:
        errors.append(f"byzantine 0.25 trimmed, round 1 (before any "
                      f"update): plain route {ht[0]}, kernel {kern[0]}")
    if plain["skipped_rounds"] != 0:
        errors.append(f"plain route: {plain['skipped_rounds']} skipped")
    G, w = captured["G"], captured["w"]
    live = k5.row_liveness(G, w)
    agg_k = k5.trimmed_mean_flat(G, live, trim=cfg["trim"])
    agg_s = k5.trimmed_mean_ref(G, live, trim=cfg["trim"])
    bound = k5_cancellation_bound(torch, G, live, cfg["trim"])
    gap = (agg_k - agg_s).abs()
    within = bool((gap <= bound).all())
    worst = float((gap / bound.clamp_min(1e-30)).max())
    if not within:
        errors.append(f"round-1 aggregate: K5 and the sort differ by up to "
                      f"{worst} of the derived bound")
    rel = [abs(a["query_loss"] - b["query_loss"]) / abs(b["query_loss"])
           for a, b in zip(ht, kern)]
    del G, w, live, agg_k, agg_s, bound, gap, captured
    return {"rounds": rounds, "cells": table, "headline": headline,
            "sweep_wall_s": sweep_wall, "path_launches": path,
            "plain_route": {
                "cell": "byzantine 0.25 trimmed", "wall_s": plain_wall,
                "round1_equal": round1_equal,
                "round1_aggregate_within_bound": within,
                "round1_aggregate_worst_of_bound": worst,
                "bound": "(2m + 2 trim + 5) u S / d",
                "final_test_acc": plain["final_test_acc"],
                "kernel_final_test_acc": table["byzantine 0.25 trimmed"][
                    "final_test_acc"],
                "max_rel_query_loss_gap": max(rel),
                "round_of_max_gap": int(rel.index(max(rel))) + 1}}, \
        {"train_faults": path}


def faults_trace_round(torch):
    """One byzantine 0.25 / trimmed FEMNIST round through the trainer,
    traced, after two untraced ones."""
    from repro_torch.launch import compare
    box = {}

    def around(tag, run):
        tr, state = run()
        box["tr"], box["state"] = tr, state
        return tr, state

    cfg = compare.ROBUSTNESS
    compare.sweep_robustness(device="cuda", around=around, log=None,
                             cells=[("byzantine", 0.25, "trimmed")],
                             rounds=2, eval_every=0)
    tr, state = box["tr"], box["state"]
    _, trace = _traced(torch, lambda: tr.run(state, 1))
    return {"clients_per_round": cfg["clients_per_round"], **trace}


def faults_lm(torch, cfg, errors):
    """(ii) SmolLM-360M at full width on the packed client plane, m = 4,
    4 + 4 sequences of 128 tokens, FOMAML, Adam(1e-3), with faults:
    trimmed (trim 1) with one sign-flipped row for 2 rounds (round 2
    traced), screen with one NaN row for a round (not skipped), mean with
    one NaN row for a round (skipped, the state bitwise unchanged)."""
    import numpy as np
    from repro_torch.core import make_algorithm
    from repro_torch.core.fedmeta import (init_packed_state,
                                          make_packed_meta_train_step)
    from repro_torch.core.losses import lm_loss
    from repro_torch.federated.faults import FaultConfig
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.optim import adam
    from repro_torch.utils.flat import plane_for
    from repro_torch.utils.pytree import tree_map

    M, S, Q, L, LR = 4, 4, 4, 128, 1e-3
    algo = make_algorithm("fomaml",
                          *lm_loss(make_apply_fn(cfg, remat=False)), 0.05)
    phi = {"theta": init_lm(0, cfg, device="cuda")}
    plane = plane_for(phi)
    opt = adam(LR)
    rng = np.random.RandomState(2)
    batches = [tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (M, n, L)),
                                     dtype=torch.int32, device="cuda")
                     for n in (S, Q)) for _ in range(4)]
    runs = (("trimmed", FaultConfig(byzantine=0.25), 2),
            ("screen", FaultConfig(nonfinite=0.25), 1),
            ("mean", FaultConfig(nonfinite=0.25), 1))
    out, paths, b = {}, {}, 0
    for aggregator, faults, rounds in runs:
        step = make_packed_meta_train_step(
            algo, opt, plane, client_plane=True, impl="cuda",
            aggregator=aggregator, trim=1, faults=faults, guard=True)
        state = init_packed_state(opt, plane, phi)
        frng = np.random.RandomState(faults.seed)
        before = {"phi": state["phi"].clone(),
                  "opt": tree_map(torch.clone, state["opt"])}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        walls, metrics, trace = [], [], None
        for r in range(rounds):
            pick = faults.pick(M, frng)
            box = {}

            def one():
                box["s"], box["m"] = step(state, *batches[b], fault=pick)

            if r == 1:
                wall, trace = _traced(torch, one)
                walls.append(wall)
            else:
                t0 = time.perf_counter()
                one()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            state = box["s"]
            metrics.append({k: float(v) for k, v in box["m"].items()})
            b = (b + 1) % len(batches)
        launches = read_launches()
        paths[f"train_faults_lm[{aggregator}]"] = launches
        skipped = [m_["skipped"] for m_ in metrics]
        tag = f"LM {aggregator} ({faults.counts(M)} dropped/NaN/byzantine)"
        if aggregator == "mean":
            frozen = _same_state(torch, state, before)
            if skipped != [1.0] or not frozen:
                errors.append(f"{tag}: skipped {skipped}, state unchanged "
                              f"{frozen}")
        else:
            frozen = None
            if skipped != [0.0] * rounds:
                errors.append(f"{tag}: skipped {skipped}")
            if not bool(torch.isfinite(state["phi"]).all()):
                errors.append(f"{tag}: non-finite φ")
        want_k5 = rounds if aggregator == "trimmed" else 0
        want_k2 = 0 if aggregator == "trimmed" else rounds
        if not (launches["trimmed_mean"] == want_k5 and
                launches["weighted_aggregate"] == want_k2 and
                launches["adam_flat"] == rounds and
                launches["inner_update_plane"] > 0 and
                launches["flash_attention"] > 0):
            errors.append(f"{tag}: launches {launches}")
        out[aggregator] = {
            "faults": dataclasses.asdict(faults), "rounds": rounds,
            "round_wall_ms": [w_ * 1e3 for w_ in walls],
            "metrics": metrics, "state_unchanged": frozen,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}
        if trace is not None:
            out[aggregator]["trace_round2"] = trace
        del state, before, step
        gc.collect()
        torch.cuda.empty_cache()
    del phi, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_plane": plane.n_padded, "clients": M,
            "support": S, "query": Q, "seq_len": L, "runs": out}, paths


def phase_train_faults(torch, cfg):
    """The failure plane: one JSON line per part, each part's kernel
    launches counted from 0."""
    paths = {}
    failed = []
    for part in ("sweep", "lm"):
        errors = []
        t0 = time.perf_counter()
        if part == "sweep":
            res, p = faults_sweep(torch, errors)
            res["trace_trimmed_round"] = faults_trace_round(torch)
        else:
            res, p = faults_lm(torch, cfg, errors)
        paths.update(p)
        emit({"phase": "train_faults", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, **res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# -------------------------------------------------------- train_scenarios

# bytes of one round (download + upload of f32 φ, m clients: 2·m·n·4 B)
# by scenario and method, the reference's: Meta-SGD ships {θ, α}; the
# recommender's FedMeta methods ship the 40-way local head (n = 11,880),
# FedAvg the 120-way global one (n = 17,080)
SCENARIO_ROUND_BYTES = {
    "sent140": {"*": 2_986_112, "meta-sgd": 5_972_224},
    "shakespeare": {"*": 3_636_608, "meta-sgd": 7_273_216},
    "recommend": {"*": 760_320, "meta-sgd": 1_520_640,
                  "fedavg": 1_093_120, "fedavg(meta)": 1_093_120},
    "lm": {"*": 2_500_608, "meta-sgd": 5_001_216},
}
# rounds and eval cadence run here. The committed plans (sent140,
# recommend) run 60 rounds with an eval every 2; the registry's
# (shakespeare, lm) 100 with an eval every 10. Cut to keep the phase near
# 130 s and the script well inside its time limit as phases are added:
# rounds are host-bound (eager dispatch), and a round of the five methods
# with its evals took 8.7 s for Sent140, 10.3 s for Shakespeare and
# 0.9 s for the recommender on an H100 80GB HBM3 at 700 W (the
# recommender cut from 20 to 10 when the multi_device phase joined).
# Each cut is printed on the part's line.
SCENARIO_RUNS = {"sent140": (4, 2), "recommend": (10, 2),
                 "shakespeare": (4, 2), "lm": (10, 5)}
# the paper's widths (the reference's defaults): LEAF's Shakespeare
# char-LSTM and the Sent140 LSTM with a learned 64-wide embedding;
# bytes of one FOMAML round of 8 clients
PAPER_WIDTHS = {
    "shakespeare": ("char_lstm", dict(vocab=70, hidden=256, embed_dim=8),
                    52_174_208),
    "sent140": ("sent_lstm", dict(vocab=2000, hidden=100, embed_dim=64),
                17_574_528),
}
FED_KERNELS = ("inner_update_plane", "weighted_aggregate", "adam_flat")


def _finite_evals(rec) -> bool:
    """Every eval record's accuracy and loss, and the test pass's, finite
    (`sent_lstm` may leave NaN entries in φ, in the reference too)."""
    vals = [rec["test_acc"], rec["test_loss"]]
    vals += [h[k] for h in rec["history"] if "eval_acc" in h
             for k in ("eval_acc", "eval_loss")]
    return all(math.isfinite(v) for v in vals)


def _nan_masks_and_finite_equal(torch, a, b):
    """(NaN masks equal, finite entries bitwise equal, largest finite
    gap) of two flat tensors."""
    na, nb = torch.isnan(a), torch.isnan(b)
    same_mask = bool(torch.equal(na, nb))
    live = ~(na | nb)
    gap = float((a[live] - b[live]).abs().max()) if bool(live.any()) else 0.0
    return same_mask, bool(torch.equal(a[live], b[live])), gap


def scenario_compare(torch, errors, dataset):
    """One scenario's comparison plan through `run_comparison` on the
    client plane: the five methods, bytes a round held exactly by method,
    K1, K2 and K3 launched (K7 too on `lm`), eval metrics finite; the
    committed artifact's comm-to-target table beside the port's."""
    from repro_torch.federated.experiment import format_table, run_comparison
    from repro_torch.launch.compare import COMMITTED_PLANS, comparison_plan
    rounds, eval_every = SCENARIO_RUNS[dataset]
    plan = comparison_plan(dataset, rounds=rounds, eval_every=eval_every)
    full = COMMITTED_PLANS.get(dataset, dict(rounds=100, eval_every=10))
    reset_launches()
    t0 = time.perf_counter()
    out = run_comparison(plan, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    committed = (_committed(f"{dataset}_compare.json")
                 if dataset in COMMITTED_PLANS else None)
    want = SCENARIO_ROUND_BYTES[dataset]
    for m, rec in out["methods"].items():
        rb = want.get(m, want["*"])
        _hold_bytes(errors, f"{dataset} {m}", rec, rb, rb // 2, None)
        if not _finite_evals(rec):
            errors.append(f"{dataset} {m}: non-finite eval accuracy or loss")
        # the recommender's artifact records θ's size by method
        ref_phi = committed and committed["methods"][m]["comm"].get(
            "phi_MB")
        if ref_phi is not None and rec["comm"]["phi_MB"] != ref_phi:
            errors.append(f"{dataset} {m}: phi_MB {rec['comm']['phi_MB']}, "
                          f"artifact {ref_phi}")
        if dataset == "recommend" and not all(
                "top4" in h for h in rec["history"] if "eval_acc" in h):
            errors.append(f"recommend {m}: an eval record without top4")
    need = FED_KERNELS + (("flash_attention",) if dataset == "lm" else ())
    for name in need:
        if launches[name] <= 0:
            errors.append(f"{dataset}: {name} not launched")
    table = {}
    for m, rec in out["methods"].items():
        row = out["comm_to_target"].get(m) or {}
        table[m] = {k: row.get(k) for k in
                    ("rounds", "comm_MB", "comm_reduction_vs_fedavg")}
        table[m].update(test_acc=rec["test_acc"], seconds=rec["seconds"],
                        bytes_per_round=round(rec["comm"]["comm_MB"] * 1e6
                                              / rounds),
                        phi_MB=rec["comm"]["phi_MB"])
        if committed:
            ref = committed["comm_to_target"].get(m) or {}
            table[m].update({f"committed_{k}": ref.get(k) for k in
                             ("rounds", "comm_MB",
                              "comm_reduction_vs_fedavg")})
            table[m]["committed_test_acc"] = \
                committed["methods"][m]["test_acc"]
    print(f"[{dataset}] port, {rounds} rounds:\n{format_table(out)}",
          flush=True)
    if committed:
        print(f"[{dataset}] committed artifact, {full['rounds']} rounds:\n"
              f"{format_table(committed)}", flush=True)
    res = {"rounds": rounds, "eval_every": eval_every,
           "cut": (None if (rounds, eval_every) == (full["rounds"],
                                                     full["eval_every"])
                   else f"{full['rounds']} rounds, eval every "
                        f"{full['eval_every']} -> {rounds}, {eval_every}"),
           "target_acc": out["target_acc"],
           "committed_target_acc": committed and committed["target_acc"],
           "wall_s": wall, "launches": launches, "table": table}
    return res, {f"train_scenarios[{dataset}]": launches}


def scenario_nan_routes(torch, errors, rounds=5):
    """Sent140 FOMAML for 5 rounds on the kernel route and on
    impl="torch": equal NaN masks in φ, its finite entries and the
    history bitwise equal."""
    from repro_torch.federated.experiment import run_comparison
    from repro_torch.launch.compare import comparison_plan
    plan = dataclasses.replace(
        comparison_plan("sent140", rounds=rounds, eval_every=rounds),
        methods=("fomaml",))
    outs = [run_comparison(plan, device="cuda", impl=impl)
            for impl in (None, "torch")]
    a, b = (o["states"]["fomaml"]["phi"] for o in outs)
    same_mask, same_finite, gap = _nan_masks_and_finite_equal(torch, a, b)
    same_history = outs[0]["methods"]["fomaml"]["history"] == \
        outs[1]["methods"]["fomaml"]["history"]
    if not (same_mask and same_finite):
        errors.append(f"sent140 kernel vs plain route: NaN masks equal "
                      f"{same_mask}, finite entries bitwise {same_finite} "
                      f"(largest gap {gap})")
    return {"rounds": rounds, "nan_entries": int(torch.isnan(a).sum()),
            "same_nan_mask": same_mask, "finite_bitwise": same_finite,
            "finite_max_gap": gap, "same_history": same_history}


def scenario_paper_width(torch, errors, dataset, trace):
    """Two FOMAML rounds of the paper-width LSTM on the scenario's
    clients, m = 8, client plane: bytes a round exactly, round 1 held
    against the all-plain route (f32: meta-gradients within 1e-3 of the
    largest, φ within Adam's 2·lr), K1–K3 launched; round 2 traced when
    ``trace``."""
    from repro_torch.federated.experiment import (DATASETS, _build_views,
                                                 make_trainer)
    from repro_torch.launch.compare import comparison_plan
    from repro_torch.models import paper
    from repro_torch.utils.pytree import tree_size
    factory, kw, round_bytes = PAPER_WIDTHS[dataset]
    plan = dataclasses.replace(
        comparison_plan(dataset, rounds=2, eval_every=0),
        methods=("fomaml",),
        model_fn=lambda device: getattr(paper, factory)(**kw, device=device))
    _, view = _build_views(plan, DATASETS[dataset], "cuda")

    def round1(impl):
        tr = make_trainer(plan, "fomaml", view.loss_fn, view.eval_fn,
                          view.train, device="cuda", impl=impl)
        t0 = time.perf_counter()
        state = tr.run(tr.init(plan.seed, view.model.init), 1)
        torch.cuda.synchronize()
        return tr, state, time.perf_counter() - t0

    _, plain, _ = round1("torch")
    reset_launches()
    tr, state, wall1 = round1(None)
    n = tree_size(tr.phi_tree(state)["theta"])
    d_phi = float((state["phi"] - plain["phi"]).abs().max())
    d_g = float((state["opt"]["m"] - plain["opt"]["m"]).abs().max()
                / plain["opt"]["m"].abs().max())
    bitwise = bool(torch.equal(state["phi"], plain["phi"]))
    del plain
    phi_tol, g_tol = 2 * plan.outer_lr + 1e-6, 1e-3
    if not (d_phi <= phi_tol and d_g <= g_tol):
        errors.append(f"{dataset} paper width round 1 vs the plain route: "
                      f"|dφ| {d_phi} (limit {phi_tol}), meta-gradient "
                      f"{d_g} (limit {g_tol})")
    box = {}

    def second():
        box["state"] = tr.run(state, 1)

    if trace:
        wall2, traced = _traced(torch, second)
    else:
        t0 = time.perf_counter()
        second()
        torch.cuda.synchronize()
        wall2, traced = time.perf_counter() - t0, None
    launches = read_launches()
    for name in FED_KERNELS:
        if launches[name] <= 0:
            errors.append(f"{dataset} paper width: {name} not launched")
    rec = {"comm": tr.comm.summary(), "history": tr.history}
    _hold_bytes(errors, f"{dataset} paper width", rec, round_bytes,
                round_bytes // 2, None)
    if not bool(torch.isfinite(box["state"]["phi"]).all()):
        errors.append(f"{dataset} paper width: non-finite φ")
    res = {"model": factory, **kw, "params": n, "clients": 8,
           "round_bytes": round(rec["comm"]["comm_MB"] * 1e6 / 2),
           "round_wall_ms": [wall1 * 1e3, wall2 * 1e3],
           "query_loss": [h["query_loss"] for h in tr.history],
           "plain_route_round1": {"max_abs_dphi": d_phi, "phi_tol": phi_tol,
                                  "meta_grad_rel": d_g, "meta_grad_tol": g_tol,
                                  "phi_bitwise": bitwise},
           "launches": launches}
    if traced:
        res["trace_round2"] = traced
    return res, {f"train_scenarios[{dataset} paper width]": launches}


def phase_train_scenarios(torch):
    """The paper's other scenarios: one JSON line per part, each part's
    kernel launches counted from 0."""
    paths = {}
    failed = []
    for part in ("sent140", "recommend", "shakespeare", "lm",
                 "paper_widths"):
        errors = []
        t0 = time.perf_counter()
        if part == "paper_widths":
            res, p = {}, {}
            for dataset in PAPER_WIDTHS:
                res[dataset], q = scenario_paper_width(
                    torch, errors, dataset, trace=(dataset == "shakespeare"))
                p.update(q)
        else:
            res, p = scenario_compare(torch, errors, part)
            if part == "sent140":
                res["nan_routes"] = scenario_nan_routes(torch, errors)
        paths.update(p)
        emit({"phase": "train_scenarios", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, **res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# ------------------------------------------------------------ train_async

ASYNC_ROUNDS = 4
ASYNC_KNOBS = {"sync": dict(prefetch_depth=0, flush_every=1, fuse_rounds=1),
               "pipelined": dict(prefetch_depth=2, flush_every=4,
                                 fuse_rounds=2)}
# k = round(0.25 · 4) = 1 straggler a round, a 2-round ring; K2's block:
# m − k + 1 rows (fixed delay), m + delay·k (jitter)
ASYNC_STALE = {"fixed": (dict(delay=2, fraction=0.25), 4),
               "jitter": (dict(delay=2, fraction=0.25, jitter=True), 6)}
ASYNC_FED = ("inner_update_plane", "weighted_aggregate", "adam_flat",
             "flash_attention")


def _same_history(a, b) -> bool:
    """Two histories equal record for record (a NaN equals a NaN)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if set(ra) != set(rb):
            return False
        for k, va in ra.items():
            vb = rb[k]
            if not (va == vb or (isinstance(va, float) and
                                 isinstance(vb, float) and
                                 math.isnan(va) and math.isnan(vb))):
                return False
    return True


def async_lm_clients(cfg):
    """8 clients of 8–15 token sequences of 128 at the model's vocabulary
    (`make_lm_clients`: a dialect of a shared order-1 chain each)."""
    from repro_torch.data import make_lm_clients
    return make_lm_clients(num_clients=8, mean_seqs=8, seq_len=128,
                           vocab=cfg.vocab_size, seed=0).clients


def async_lm_trainer(cfg, clients, **kw):
    """The SmolLM round's settings through the entry point: a packed
    FOMAML (inner lr 0.05) `FederatedTrainer` on the client plane, m = 4
    clients of 4 support + 4 query sequences, Adam(1e-3), φ from seed 0
    on the card -> (trainer, initial state)."""
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import lm_pair_loss
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.optim import adam
    algo = make_algorithm(
        "fomaml", *lm_pair_loss(make_apply_fn(cfg, remat=False)), 0.05)
    tr = FederatedTrainer(algo, adam(1e-3), clients, clients_per_round=4,
                          support_frac=0.5, support_size=4, query_size=4,
                          seed=0, packed=True, client_plane=True,
                          device="cuda", **kw)
    return tr, tr.init(0, lambda key: init_lm(key, cfg, device="cuda"))


def _opt_and_phi(state):
    keep = {"phi": state["phi"], "opt": dict(state["opt"])}
    if "stale" in state:
        keep["stale"] = dict(state["stale"])
    return keep


def async_pipeline(torch, cfg, clients, errors):
    """(i) `ASYNC_ROUNDS` rounds synchronous and pipelined (prefetch 2,
    flush every 4, fused blocks of 2) from one φ: history and state
    bitwise equal. Round 1 of each run is its warm-up, rounds 2.. are
    timed; two more rounds of each are traced (two single rounds; one
    fused block of two). Peak memory counts what the phase still holds
    from an earlier run (``held_gb``)."""
    out, paths, ends = {}, {}, {}
    for name, kw in ASYNC_KNOBS.items():
        tr, state = async_lm_trainer(cfg, clients, **kw)
        reset_launches()
        state = tr.run(state, 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = tr.run(state, ASYNC_ROUNDS, start_round=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        paths[f"train_async[{name}]"] = launches
        peak = torch.cuda.max_memory_allocated()
        box = {}

        def more():
            box["s"] = tr.run(state, ASYNC_ROUNDS + 2,
                              start_round=ASYNC_ROUNDS)

        traced_s, trace = _traced(torch, more)
        ends[name] = (list(tr.history), _opt_and_phi(box["s"]))
        for k in ASYNC_FED:
            if launches[k] <= 0:
                errors.append(f"{name}: {k} was not launched")
        if not (launches["weighted_aggregate"] == launches["adam_flat"]
                == ASYNC_ROUNDS):
            errors.append(f"{name}: K2/K3 launches {launches}")
        out[name] = {"knobs": kw,
                     "round_wall_ms": wall / (ASYNC_ROUNDS - 1) * 1e3,
                     "peak_mem_gb": peak / 1e9, "held_gb": held / 1e9,
                     "side_stream": tr._stager.side is not None,
                     "launches": {k: launches[k] for k in ASYNC_FED},
                     "traced_rounds": 2,
                     "traced_round_wall_ms": traced_s / 2 * 1e3,
                     "trace": trace, "n_plane": tr._plane.n_padded,
                     "last": {k: tr.history[-1][k]
                              for k in ("query_loss", "accuracy")}}
        del tr, state, box
        gc.collect()
        torch.cuda.empty_cache()
    (h0, s0), (h1, s1) = ends["sync"], ends["pipelined"]
    out["history_equal"] = _same_history(h0, h1)
    out["state_bitwise"] = _same_state(torch, s0, s1)
    if not (out["history_equal"] and out["state_bitwise"]):
        errors.append(f"pipelined vs sync: history {out['history_equal']}, "
                      f"state {out['state_bitwise']}")
    if not out["pipelined"]["side_stream"]:
        errors.append("the pipelined run did not stage on a side stream")
    out["finite"] = bool(torch.isfinite(s0["phi"]).all())
    if not out["finite"]:
        errors.append("non-finite φ")
    del ends, s0, s1
    gc.collect()
    torch.cuda.empty_cache()
    return out, paths


def async_staleness(torch, cfg, clients, errors, sync_peak, n_plane):
    """(ii) `ASYNC_ROUNDS` rounds with stragglers (fixed delay, then
    jitter) on the kernel route and on the all-plain route
    (impl="torch": K1, K2, K3 plain; attention on K7 in both): φ, the
    Adam state and the ring bitwise equal, K2 launched on the
    (m − k + 1, N) and (m + delay·k, N) blocks."""
    from repro_torch.federated.async_engine import StalenessConfig
    from repro_torch.kernels.meta_update import ops as mu_ops
    total = torch.cuda.get_device_properties(0).total_memory
    out, paths = {}, {}
    real_k2 = mu_ops.weighted_aggregate_flat
    for mode, (kw, rows) in ASYNC_STALE.items():
        cfg_s = StalenessConfig(**kw)
        k = cfg_s.num_stragglers(4)
        ring_b = cfg_s.delay * k * n_plane * 4
        # the synchronous round's peak, the ring twice (the old one and
        # the one the round builds) and the aggregation block beside the
        # (m, N) block
        need = sync_peak + 2 * ring_b + rows * n_plane * 4
        fits = need <= total
        ends, res = {}, {"config": kw, "stragglers": k,
                         "ring_gb": ring_b / 1e9,
                         "predicted_peak_gb": need / 1e9,
                         "device_gb": total / 1e9, "fits": fits}
        if not fits:
            errors.append(f"{mode}: {need / 1e9:.1f} GB will not fit")
            out[mode] = res
            continue
        for impl in ("cuda", "torch"):
            seen = []

            def k2(gs, w):
                seen.append(int(gs.shape[0]))
                return real_k2(gs, w)

            tr, state = async_lm_trainer(cfg, clients, staleness=cfg_s,
                                         impl=impl)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            mu_ops.weighted_aggregate_flat = k2
            reset_launches()
            try:
                t0 = time.perf_counter()
                state = tr.run(state, ASYNC_ROUNDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                mu_ops.weighted_aggregate_flat = real_k2
            launches = read_launches()
            paths[f"train_async[stale-{mode},{impl}]"] = launches
            ends[impl] = (list(tr.history), _opt_and_phi(state))
            res[impl] = {"round_wall_ms": wall / ASYNC_ROUNDS * 1e3,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9, "held_gb": held / 1e9,
                         "k2_rows_launched": seen,
                         "launches": {n: launches[n] for n in ASYNC_FED}}
            want_k2 = [rows] * ASYNC_ROUNDS if impl == "cuda" else []
            if seen != want_k2 or launches["flash_attention"] <= 0:
                errors.append(f"{mode} {impl}: K2 rows {seen} (want "
                              f"{want_k2}), launches {launches}")
            del tr, state
            gc.collect()
            torch.cuda.empty_cache()
        (h0, s0), (h1, s1) = ends["cuda"], ends["torch"]
        res["history_equal"] = _same_history(h0, h1)
        res["state_bitwise"] = _same_state(torch, s0, s1)
        res["ring_bitwise"] = _same_state(torch, s0["stale"], s1["stale"])
        res["ring_weights"] = s0["stale"]["w"].tolist()
        res["finite"] = bool(torch.isfinite(s0["phi"]).all())
        if not (res["history_equal"] and res["state_bitwise"]
                and res["finite"]):
            errors.append(f"{mode}: kernel vs plain route: history "
                          f"{res['history_equal']}, state "
                          f"{res['state_bitwise']}, finite {res['finite']}")
        out[mode] = res
        del ends, s0, s1
        gc.collect()
        torch.cuda.empty_cache()
    return out, paths


def async_resume(torch, errors):
    """(iii) kill and resume, the reference's `tests/test_checkpoint.py`
    configurations (staleness alone; staleness + dropout + byzantine +
    trimmed, trim 1): 9 rounds uninterrupted, then 6 rounds checkpointed
    at 3 and 6, a fresh trainer resumed from 6 to 9; prefetch depth 2,
    an eval every 3. The stitched history and φ bitwise equal to the
    uninterrupted run's. At FEMNIST width (`femnist_cnn(62, hidden=128)`)
    and on the `lm` scenario's reduced SmolLM."""
    import shutil
    from repro_torch.checkpoint.io import latest_step
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.federated.async_engine import StalenessConfig
    from repro_torch.federated.experiment import DATASETS
    from repro_torch.federated.faults import FaultConfig
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.optim import adam

    stale = StalenessConfig(delay=1, fraction=0.34, discount=0.5)
    configs = {"stale": dict(staleness=stale),
               "stale+faults+trimmed": dict(
                   staleness=stale,
                   faults=FaultConfig(dropout=0.25, byzantine=0.25, seed=5),
                   aggregator="trimmed", trim=1)}
    scen = {"femnist": dict(clients=100, inner_lr=0.05, outer_lr=1e-3,
                            support_frac=0.2, support_size=16,
                            query_size=16),
            "lm": dict(clients=32, inner_lr=0.1, outer_lr=3e-3,
                       support_frac=0.5, support_size=4, query_size=4)}
    root = os.path.join(HERE, "build", "train_async_ckpt")
    out, paths = {}, {}
    for dataset, sc in scen.items():
        su = DATASETS[dataset]
        train, val, _ = su["data"](sc["clients"], 0).split_clients(0)
        model = su["model"]("cuda")
        loss = (su["loss"](model) if "loss" in su
                else classification_loss(model.apply))

        def trainer(ckpt=None, **kw):
            algo = make_algorithm("fomaml", *loss, inner_lr=sc["inner_lr"])
            if ckpt is not None:
                kw.update(checkpoint_dir=ckpt, checkpoint_every=3)
            tr = FederatedTrainer(
                algo, adam(sc["outer_lr"]), train, clients_per_round=4,
                support_frac=sc["support_frac"],
                support_size=sc["support_size"],
                query_size=sc["query_size"], seed=0, packed=True,
                client_plane=True, device="cuda", prefetch_depth=2, **kw)
            return tr, tr.init(0, model.init)

        for name, kw in configs.items():
            tag = f"{dataset} {name}"
            ckpt = os.path.join(root, dataset, name.replace("+", "_"))
            shutil.rmtree(ckpt, ignore_errors=True)
            reset_launches()
            full, st = trainer(**kw)
            st = full.run(st, 9, eval_every=3, eval_clients=val)
            saves = []
            tr1, st1 = trainer(ckpt, **kw)
            real_save = tr1.save_checkpoint

            def timed_save(state, r, real_save=real_save, saves=saves,
                           ckpt=ckpt):
                t0 = time.perf_counter()
                path = real_save(state, r)
                saves.append({"round": r,
                              "save_s": time.perf_counter() - t0,
                              "bytes": sum(os.path.getsize(path + s)
                                           for s in (".npz", ".manifest"))})

            tr1.save_checkpoint = timed_save
            tr1.run(st1, 6, eval_every=3, eval_clients=val)
            tr2, _ = trainer(ckpt, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st2, start = tr2.resume()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            st2 = tr2.run(st2, 9, eval_every=3, eval_clients=val,
                          start_round=start)
            launches = read_launches()
            paths[f"train_async[resume {tag}]"] = launches
            res = {"checkpoints": saves, "latest": latest_step(ckpt),
                   "resumed_from": start, "load_s": load_s,
                   "history_equal": _same_history(tr2.history,
                                                  full.history),
                   "phi_bitwise": bool(torch.equal(st2["phi"], st["phi"])),
                   "ring_bitwise": _same_state(torch, st2["stale"],
                                               st["stale"]),
                   "skipped": [r.get("skipped", 0.0) for r in full.history],
                   "launches": {n: launches[n] for n in
                                ("inner_update_plane", "weighted_aggregate",
                                 "trimmed_mean", "adam_flat",
                                 "flash_attention")}}
            want_k5 = "trimmed" in name
            if not (res["history_equal"] and res["phi_bitwise"]
                    and res["ring_bitwise"] and start == 6
                    and [c["round"] for c in saves] == [3, 6]
                    and (launches["trimmed_mean"] > 0) == want_k5
                    and launches["adam_flat"] > 0):
                errors.append(f"{tag}: resume {res}")
            out[tag] = res
            shutil.rmtree(ckpt, ignore_errors=True)
            del full, tr1, tr2, st, st1, st2
        del train, val, model
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return out, paths


def phase_train_async(torch, cfg):
    """The async round engine and crash-safe checkpoints: one JSON line
    per part, each run's kernel launches counted from 0."""
    paths, failed, ctx = {}, [], {}
    for part in ("pipeline", "staleness", "resume"):
        errors = []
        t0 = time.perf_counter()
        if part == "pipeline":
            ctx["clients"] = async_lm_clients(cfg)
            res, p = async_pipeline(torch, cfg, ctx["clients"], errors)
            ctx["peak"] = res["sync"]["peak_mem_gb"] * 1e9
            ctx["n"] = res["sync"]["n_plane"]
        elif part == "staleness":
            res, p = async_staleness(torch, cfg, ctx["clients"], errors,
                                     ctx["peak"], ctx["n"])
        else:
            res, p = async_resume(torch, errors)
        paths.update(p)
        emit({"phase": "train_async", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, **res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# ------------------------------------------------------- train_population

# the committed artifact's three cells (results/experiments/
# population_sent140.json) cut from its 60 rounds to their first 30 (an
# eval every 3, as there): the 60 took 143 s on the H100 (host-bound
# LSTM rounds); the whole 60 are replayed by `launch.compare --sweep
# population` and held by `tools/compare_population.py`. The accounting
# of the first 30 rounds is the reference's, from two CPU runs of
#   PYTHONPATH=src python examples/population_scale.py --rounds 30 \
#       --outdir D
# which agree with each other field for field and in the registry's
# counts (hits 643, misses 306, evictions 374)
POP_ROUNDS = 30
POP_CELL_FIELDS = ("rounds", "skipped_rounds", "dead_round_frac",
                   "mean_arrived", "cohort_fill", "client_updates")
POP_COMM_FIELDS = ("selected_total", "arrived_total", "quarantined",
                   "download_MB", "upload_MB", "comm_MB", "phi_MB")
POP_CUT = {
    "clean": dict(rounds=30, skipped_rounds=0, dead_round_frac=0.0,
                  mean_arrived=8.0, cohort_fill=1.0, client_updates=240,
                  comm=dict(download_MB=44.79168, upload_MB=44.79168,
                            comm_MB=89.58336, phi_MB=0.186632)),
    "overselect": dict(rounds=30, skipped_rounds=10,
                       dead_round_frac=0.3333333333333333,
                       mean_arrived=3.066666666666667,
                       cohort_fill=0.38333333333333336, client_updates=92,
                       comm=dict(selected_total=1200, arrived_total=92,
                                 quarantined=62, download_MB=223.9584,
                                 upload_MB=17.170144, comm_MB=241.128544,
                                 phi_MB=0.186632)),
    "baseline": dict(rounds=30, skipped_rounds=17,
                     dead_round_frac=0.5666666666666667,
                     mean_arrived=0.6666666666666666,
                     cohort_fill=0.08333333333333333, client_updates=20,
                     comm=dict(selected_total=240, arrived_total=20,
                               quarantined=12, download_MB=44.79168,
                               upload_MB=3.73264, comm_MB=48.52432,
                               phi_MB=0.186632)),
}
POP_CUT_ACCESSES = 643 + 306     # the registry's hits + misses
# the deployment scale: a lazily generated Sent140 fleet at the paper's
# LSTM width, m = 8 on the client plane, the arrival model below
POP_FLEETS = (1_000_000, 1_000)
POP_SCALE_ROUNDS = 6
POP_SCALE_ARRIVALS = dict(fail_rate=0.2, chronic_frac=0.05, seed=0)
POP_SCALE_KNOBS = dict(over_select=0.5, round_deadline=1.6, pool_workers=4)
POP_SCALE_CACHE = 64
# SmolLM-360M at full width, 8 lazy clients, over_select 1.0 (all 8
# candidates every round): with this arrival model and deadline the
# first 3 rounds see 3, 0 and 2 arrivals — a partial cohort, a dead
# round, a partial cohort (found by a search over seeds with
# `population.plan_round`, printed on the part's line)
POP_LM_ARRIVALS = dict(fail_rate=0.6, seed=10)
POP_LM_DEADLINE = 1.0
POP_LM_ARRIVED = [3, 0, 2]
# `tests/test_worker_pool.py::test_population_checkpoint_resume_bit_identical`
POP_RESUME_KNOBS = dict(over_select=0.5, round_deadline=2.0,
                        breaker_threshold=2, breaker_cooldown=3)
POP_RESUME_ARRIVALS = dict(fail_rate=0.4, seed=11)


def _rss_mb() -> float:
    """This process's resident set now (`/proc/self/statm`), in MB:
    `ru_maxrss` is the whole script's peak, not the phase's."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6


def population_artifact(torch, errors):
    """(i) The committed artifact's three cells (clean, overselect,
    baseline) through `launch.compare.sweep_population` on the card:
    FOMAML on Sent140, a lazy registry of 100 clients behind a 32-client
    LRU and 2 pool workers, 8 a round, an eval every 3, packed on the
    vmap axis, cut to the first `POP_ROUNDS` rounds. Each cell's skipped
    rounds, dead round share, mean arrivals, cohort fill, client updates
    and comm totals exactly the reference's first `POP_ROUNDS` rounds
    (`POP_CUT`); the registry's accesses (hits + misses) the
    reference's and its peak under the cap; K2 and K3 once a round in
    every cell. The artifact's 60-round values are printed beside."""
    from repro_torch.launch.compare import sweep_population
    artifact = {c["cell"]: c for c in
                _committed("population_sent140.json")["cells"]}
    counts, walls = {}, {}

    def around(name, run):
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = read_launches()
        return out

    t0 = time.perf_counter()
    out = sweep_population(device="cuda", log=None, around=around,
                           rounds=POP_ROUNDS)
    wall = time.perf_counter() - t0
    res, paths = {"rounds": POP_ROUNDS, "wall_s": wall, "cells": {}}, {}
    for cell in out["cells"]:
        name, w = cell["cell"], POP_CUT[cell["cell"]]
        diff = {k: [cell[k], w[k]] for k in POP_CELL_FIELDS
                if cell[k] != w[k]}
        diff.update({f"comm.{k}": [cell["comm"].get(k), w["comm"].get(k)]
                     for k in POP_COMM_FIELDS
                     if cell["comm"].get(k) != w["comm"].get(k)})
        launches = counts[name]
        paths[f"train_population[{name}]"] = launches
        if diff:
            errors.append(f"{name}: accounting differs from the "
                          f"reference's first {POP_ROUNDS} rounds: {diff}")
        if not (launches["weighted_aggregate"] == launches["adam_flat"]
                == POP_ROUNDS):
            errors.append(f"{name}: K2/K3 launches {launches}")
        evals = [a for _, a in cell["eval_curve"]]
        if not all(math.isfinite(a) for a in evals):
            errors.append(f"{name}: non-finite eval accuracy")
        res["cells"][name] = {
            **{k: cell[k] for k in POP_CELL_FIELDS},
            "comm": cell["comm"], "accounting_equal": not diff,
            "wall_s": walls[name],
            "round_wall_ms": walls[name] / POP_ROUNDS * 1e3,
            "final_val_acc": cell["final_val_acc"],
            "final_test_acc": cell["final_test_acc"],
            "artifact_60_rounds": {
                k: artifact[name][k] for k in
                POP_CELL_FIELDS + ("final_val_acc", "final_test_acc")},
            "launches": {k: launches[k] for k in FED_KERNELS}}
    got = out["registry_cache"]
    res["registry_cache"] = {"got": got, "want_accesses": POP_CUT_ACCESSES}
    if got["hits"] + got["misses"] != POP_CUT_ACCESSES:
        errors.append(f"registry accesses {got}: want {POP_CUT_ACCESSES}")
    if got["peak_resident"] > got["cache_clients"]:
        errors.append(f"registry peak over its cap: {got}")
    return res, paths


def population_scale(torch, errors):
    """(ii) The deployment scale: `make_sent140(n, lazy=True,
    independent=True, cache_clients=64)` for n = 10^6 and 10^3, the
    paper-width `sent_lstm(2000, 100, 64)`, FOMAML on the client plane,
    m = 8, `UnreliabilityConfig(fail_rate=0.2, chronic_frac=0.05)`,
    over_select 0.5, deadline 1.6, 4 pool workers, the breaker on. At
    10^6: 6 rounds synchronous, then 6 pipelined (prefetch 2): history
    and state bitwise equal; round 1 again on impl="torch": φ bitwise.
    At 10^3: the same 6 synchronous rounds. Rounds/s, host RSS before
    and after the registry and after the rounds, the LRU's peak, K1, K2
    and K3 launches a round, and download = candidates × φ bytes,
    upload = arrivals × φ bytes."""
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.data import make_sent140
    from repro_torch.federated.population import UnreliabilityConfig
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.models.paper import sent_lstm
    from repro_torch.optim import adam
    model = sent_lstm(vocab=2000, hidden=100, embed_dim=64, device="cuda")
    loss = classification_loss(model.apply)
    rounds = POP_SCALE_ROUNDS

    def trainer(train, **kw):
        algo = make_algorithm("fomaml", *loss, inner_lr=0.01)
        tr = FederatedTrainer(
            algo, adam(1e-3), train, 8, support_frac=0.2, support_size=16,
            query_size=16, seed=0, packed=True, client_plane=True,
            device="cuda",
            unreliability=UnreliabilityConfig(**POP_SCALE_ARRIVALS),
            **POP_SCALE_KNOBS, **kw)
        return tr, tr.init(0, model.init)

    def timed(tr, state, start=0):
        t0 = time.perf_counter()
        state = tr.run(state, rounds, start_round=start)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    res, paths = {}, {}
    for n in POP_FLEETS:
        rss0 = _rss_mb()
        t0 = time.perf_counter()
        reg = make_sent140(n, lazy=True, independent=True,
                           cache_clients=POP_SCALE_CACHE)
        train, _, _ = reg.split_clients(seed=0)
        build_s = time.perf_counter() - t0
        rss1 = _rss_mb()
        tr, state = trainer(train)
        reset_launches()
        t0 = time.perf_counter()
        state = tr.run(state, 1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        phi1 = state["phi"].clone()
        state, wall = timed(tr, state, start=1)
        launches = read_launches()
        rss2 = _rss_mb()
        paths[f"train_population[sent140 {n:.0e} sync]"] = launches
        hist = tr.history
        phi_b = tr.comm.phi_bytes
        sel = sum(r["selected"] for r in hist)
        arr = sum(r["arrived"] for r in hist)
        skipped = [r.get("skipped", 0.0) for r in hist]
        bytes_ok = (tr.comm.download_bytes == sel * phi_b
                    and tr.comm.upload_bytes == arr * phi_b
                    and all(r["selected"] == 12 for r in hist))
        row = {"clients": n, "train_clients": len(train),
               "registry_build_s": build_s,
               "rss_mb": {"before_registry": rss0, "after_registry": rss1,
                          "after_rounds": rss2},
               "round1_wall_ms": wall1 * 1e3,
               "rounds_per_s": (rounds - 1) / wall,
               "arrived": [r["arrived"] for r in hist],
               "quarantined": [r["quarantined"] for r in hist],
               "skipped": skipped, "phi_bytes": phi_b,
               "download_bytes": tr.comm.download_bytes,
               "upload_bytes": tr.comm.upload_bytes,
               "bytes_equal_counts": bytes_ok,
               "launches": {k: launches[k] for k in FED_KERNELS},
               "query_loss": [r["query_loss"] for r in hist]}
        if not bytes_ok:
            errors.append(f"{n}: bytes {row}")
        if any(launches[k] != rounds for k in FED_KERNELS):
            errors.append(f"{n}: launches {launches} (want {rounds} each)")
        if n == POP_FLEETS[0]:
            sync_hist, sync_state = list(hist), state
            trp, stp = trainer(train, prefetch_depth=2)
            reset_launches()
            stp, wall_p = timed(trp, stp)
            paths[f"train_population[sent140 {n:.0e} pipelined]"] = \
                read_launches()
            row["pipelined_wall_s"] = wall_p
            row["sync_wall_s"] = wall1 + wall
            row["pipelined_side_stream"] = trp._stager.side is not None
            row["pipelined_history_equal"] = _same_history(trp.history,
                                                           sync_hist)
            row["pipelined_state_bitwise"] = _same_state(torch, stp,
                                                         sync_state)
            if not (row["pipelined_history_equal"]
                    and row["pipelined_state_bitwise"]
                    and row["pipelined_side_stream"]):
                errors.append(f"{n}: pipelined vs sync: history "
                              f"{row['pipelined_history_equal']}, state "
                              f"{row['pipelined_state_bitwise']}")
            del trp, stp
            trt, stt = trainer(train, impl="torch")
            stt = trt.run(stt, 1)
            row["round1_plain_bitwise"] = bool(torch.equal(stt["phi"],
                                                           phi1))
            if not row["round1_plain_bitwise"]:
                errors.append(f"{n}: round 1 vs impl='torch' not bitwise")
            del trt, stt
        if not bool(torch.isfinite(state["phi"]).all()):
            errors.append(f"{n}: non-finite φ")
        # after every run on this fleet (at 10^6: three runs, more
        # distinct clients than the cache holds)
        row["registry_cache"] = reg.cache_stats()
        if row["registry_cache"]["peak_resident"] > POP_SCALE_CACHE:
            errors.append(f"{n}: registry peak {row['registry_cache']}")
        res[f"{n}"] = row
        del tr, state, reg, train, phi1
        gc.collect()
        torch.cuda.empty_cache()
    return res, paths


def population_lm(torch, cfg, errors):
    """(iii) SmolLM-360M at full width on the client plane through
    `FederatedTrainer.run` with the SmolLM round's settings (m = 4, 4 + 4
    sequences of 128 tokens) over `make_lm_clients(..., lazy=True)` at
    the model's vocabulary, over_select 1.0 and `POP_LM_ARRIVALS` with
    deadline `POP_LM_DEADLINE`: rounds 1–3 see 3, 0 and 2 arrivals. K2
    runs on the (4, N) block with zero-weight rows; round 1 is bitwise
    equal to impl="torch" (K1, K2, K3 plain; K7 on both); the dead round
    2 is skipped by the guard with φ, m, v and the step bitwise
    unchanged; round 3 is traced. The predicted peak (the synchronous
    round's, plus a copy of φ, m and v for the dead-round check) is
    checked against the card's memory first."""
    from repro_torch.data import make_lm_clients
    from repro_torch.federated.population import UnreliabilityConfig
    from repro_torch.kernels.meta_update import aggregate
    clients = make_lm_clients(num_clients=8, mean_seqs=8, seq_len=128,
                              vocab=cfg.vocab_size, seed=0, lazy=True,
                              cache_clients=8)
    kw = dict(unreliability=UnreliabilityConfig(**POP_LM_ARRIVALS),
              over_select=1.0, round_deadline=POP_LM_DEADLINE)
    total = torch.cuda.get_device_properties(0).total_memory
    res = {"arrivals": {**POP_LM_ARRIVALS, "deadline": POP_LM_DEADLINE,
                        "over_select": 1.0}}

    trp, stp = async_lm_trainer(cfg, clients, impl="torch", **kw)
    n_plane = trp._plane.n_padded
    # the synchronous round's peak (15.1 GB in `train_async` on an H100
    # 80GB HBM3) and a copy of φ, m and v
    need = 15.1e9 + 3 * 4 * n_plane
    res.update(n_plane=n_plane, predicted_peak_gb=need / 1e9,
               device_gb=total / 1e9)
    if need > total:
        errors.append(f"{need / 1e9:.1f} GB will not fit")
        return res, {}
    stp = trp.run(stp, 1)
    phi_plain = stp["phi"].clone()
    del trp, stp
    gc.collect()
    torch.cuda.empty_cache()

    seen, real_k2 = [], aggregate.weighted_aggregate_flat

    def k2(gs, w):
        seen.append([int(gs.shape[0]), int((w == 0).sum())])
        return real_k2(gs, w)

    tr, state = async_lm_trainer(cfg, clients, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    aggregate.weighted_aggregate_flat = k2
    reset_launches()
    walls = []
    try:
        t0 = time.perf_counter()
        state = tr.run(state, 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        res["round1_plain_bitwise"] = bool(torch.equal(state["phi"],
                                                       phi_plain))
        del phi_plain
        before = {"phi": state["phi"].clone(),
                  "opt": {k: v.clone() for k, v in state["opt"].items()}}
        t0 = time.perf_counter()
        state = tr.run(state, 2, start_round=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        res["dead_round_state_bitwise"] = _same_state(
            torch, {"phi": state["phi"], "opt": state["opt"]}, before)
        del before
        box = {}

        def third():
            box["s"] = tr.run(state, 3, start_round=2)

        wall3, trace = _traced(torch, third)
        walls.append(wall3)
        state = box["s"]
    finally:
        aggregate.weighted_aggregate_flat = real_k2
    launches = read_launches()
    hist = tr.history
    res.update(
        arrived=[r["arrived"] for r in hist],
        skipped=[r.get("skipped", 0.0) for r in hist],
        k2_rows_zero_weight=seen, round_wall_ms=[w * 1e3 for w in walls],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        held_gb=held / 1e9, trace_round3=trace,
        launches={k: launches[k] for k in ASYNC_FED},
        query_loss=[r["query_loss"] for r in hist],
        comm=tr.comm.summary())
    if res["arrived"] != POP_LM_ARRIVED or res["skipped"] != [0.0, 1.0,
                                                               0.0]:
        errors.append(f"arrivals {res['arrived']} (want {POP_LM_ARRIVED}), "
                      f"skipped {res['skipped']}")
    # round 2's weights normalize to NaN (0 / 0), so no row reads 0
    if seen != [[4, 1], [4, 0], [4, 2]]:
        errors.append(f"K2 blocks (rows, zero-weight rows) {seen}: want "
                      "[[4, 1], [4, 0], [4, 2]]")
    if not res["round1_plain_bitwise"]:
        errors.append("round 1 vs impl='torch' not bitwise")
    if not res["dead_round_state_bitwise"]:
        errors.append("the dead round changed the state")
    if launches["flash_attention"] <= 0 or any(
            launches[k] != 3 for k in FED_KERNELS):
        errors.append(f"launches {launches}")
    if not bool(torch.isfinite(state["phi"]).all()):
        errors.append("non-finite φ")
    del tr, state, box
    gc.collect()
    torch.cuda.empty_cache()
    return res, {"train_population[smollm]": launches}


def population_resume(torch, errors):
    """(iv) Kill and resume with the breaker, the configuration of
    `tests/test_worker_pool.py::test_population_checkpoint_resume_bit_identical`
    (fail_rate 0.4, over_select 0.5, deadline 2.0, breaker 2 / 3) at
    FEMNIST width (`femnist_cnn(62, hidden=128)`, FOMAML on the client
    plane, m = 4, 2 pool workers, prefetch 2): 9 rounds uninterrupted,
    then 6 checkpointed at 3 and 6 and a fresh trainer resumed to 9; the
    stitched history, φ and the breaker's state bitwise equal to the
    uninterrupted run's."""
    import shutil
    from repro_torch.core import make_algorithm
    from repro_torch.core.losses import classification_loss
    from repro_torch.federated.experiment import DATASETS
    from repro_torch.federated.population import UnreliabilityConfig
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.optim import adam
    su = DATASETS["femnist"]
    train, val, _ = su["data"](100, 0).split_clients(0)
    model = su["model"]("cuda")
    loss = classification_loss(model.apply)
    ckpt = os.path.join(HERE, "build", "train_population_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)

    def trainer(**kw):
        algo = make_algorithm("fomaml", *loss, inner_lr=0.05)
        tr = FederatedTrainer(
            algo, adam(1e-3), train, clients_per_round=4, support_frac=0.2,
            support_size=16, query_size=16, seed=0, packed=True,
            client_plane=True, device="cuda", prefetch_depth=2,
            pool_workers=2,
            unreliability=UnreliabilityConfig(**POP_RESUME_ARRIVALS),
            **POP_RESUME_KNOBS, **kw)
        return tr, tr.init(0, model.init)

    reset_launches()
    full, st = trainer()
    st = full.run(st, 9, eval_every=3, eval_clients=val)
    tr1, st1 = trainer(checkpoint_dir=ckpt, checkpoint_every=3)
    tr1.run(st1, 6, eval_every=3, eval_clients=val)
    tr2, _ = trainer(checkpoint_dir=ckpt, checkpoint_every=3)
    st2, start = tr2.resume()
    resumed_log = len(tr2.comm.participation)
    st2 = tr2.run(st2, 9, eval_every=3, eval_clients=val, start_round=start)
    launches = read_launches()
    res = {"resumed_from": start, "participation_restored": resumed_log,
           "history_equal": _same_history(tr2.history, full.history),
           "phi_bitwise": bool(torch.equal(st2["phi"], st["phi"])),
           "breaker_equal": (tr2._breaker.state_dict()
                             == full._breaker.state_dict()),
           "breaker": full._breaker.state_dict(),
           "arrived": [r["arrived"] for r in full.history],
           "skipped": [r.get("skipped", 0.0) for r in full.history],
           "launches": {k: launches[k] for k in FED_KERNELS}}
    if not (res["history_equal"] and res["phi_bitwise"]
            and res["breaker_equal"] and start == 6 and resumed_log == 6):
        errors.append(f"resume {res}")
    shutil.rmtree(ckpt, ignore_errors=True)
    del full, tr1, tr2, st, st1, st2
    gc.collect()
    torch.cuda.empty_cache()
    return res, {"train_population[resume]": launches}


def phase_train_population(torch, cfg):
    """The population plane: one JSON line per part, each run's kernel
    launches counted from 0."""
    paths, failed = {}, []
    for part in ("artifact", "scale", "lm", "resume"):
        errors = []
        t0 = time.perf_counter()
        if part == "artifact":
            res, p = population_artifact(torch, errors)
        elif part == "scale":
            res, p = population_scale(torch, errors)
        elif part == "lm":
            res, p = population_lm(torch, cfg, errors)
        else:
            res, p = population_resume(torch, errors)
        paths.update(p)
        emit({"phase": "train_population", "part": part, "ok": not errors,
              "part_wall_s": time.perf_counter() - t0, **res,
              "errors": errors})
        failed += [f"{part}: {e}" for e in errors]
        gc.collect()
        torch.cuda.empty_cache()
    if failed:
        raise PhaseFailed("; ".join(failed))
    return paths


# ------------------------------------------------------------ multi_device

# deepseek-v2-236b's MoE layer at full width: 160 experts of d_ff 1,536,
# top-6, 2 shared experts, bf16 (7.55 GB of experts), over 4,096 tokens
EP_TOKENS = 4096
# the sharded round's client counts: m = 4 at world 1 (the LM round's),
# m = 5 at world 2 (one zero-weight pad row on rank 1)
MD_CLIENTS = {1: 4, 2: 5}
MD_CHILD_TIMEOUT_S = 300


def _md_flags(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def _state_copy(torch, state):
    from repro_torch.utils.pytree import tree_map
    return {"phi": state["phi"].clone(),
            "opt": tree_map(torch.clone, state["opt"])}


def md_sharded_round(torch, cfg, m, check_k2=False):
    """One packed FOMAML round of SmolLM-360M at full width on the
    client plane (the LM round's 4 + 4 sequences of 128 tokens), m
    clients, on the sharded client axis over the default process group
    and again on the vmap axis from the same state (the vmap round only
    where ``check_k2`` is off or on rank 0). Returns the record and, on
    rank 0 or world 1, (sharded state, vmap state, metrics of each).
    With ``check_k2`` every K2 call of the sharded round is also run on
    its plain version on the same rows and must be bitwise equal."""
    import torch.distributed as dist
    from repro_torch.core.fedmeta import make_packed_meta_train_step
    from repro_torch.kernels.meta_update import ops as mu_ops
    from repro_torch.kernels.meta_update import ref as mu_ref
    from repro_torch.sharding import collectives
    algo, opt, plane, state, (batch,) = lm_round_setup(torch, cfg, 1, M=m)
    rank = dist.get_rank()
    start = _state_copy(torch, state) if rank == 0 else None
    k2_rows, orig = [], mu_ops.weighted_aggregate

    def checked(G, w, *, impl=None):
        out = orig(G, w, impl=impl)
        k2_rows.append({"rows": int(G.shape[0]), "bitwise_plain": bool(
            torch.equal(out, mu_ref.weighted_aggregate_ref(G, w)))})
        return out

    step = make_packed_meta_train_step(algo, opt, plane, client_plane=True,
                                       client_axis="sharded", impl="cuda")
    torch.cuda.synchronize()
    reset_launches()
    collectives.reset()
    if check_k2:
        mu_ops.weighted_aggregate = checked
    try:
        t0 = time.perf_counter()
        sharded, met = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mu_ops.weighted_aggregate = orig
    rec = {"world": dist.get_world_size(), "rank": rank, "clients": m,
           "n_plane": plane.n_padded, "round_s": wall,
           "launches": read_launches(),
           "collectives": {"calls": dict(collectives.calls),
                           "bytes": dict(collectives.bytes_)},
           "metrics": {k: float(v) for k, v in met.items()}}
    if check_k2:
        rec["k2_calls"] = k2_rows
    if start is None:
        return rec, None
    del state
    vstep = make_packed_meta_train_step(algo, opt, plane, client_plane=True,
                                        impl="cuda")
    vmap, vmet = vstep(start, *batch)
    torch.cuda.synchronize()
    return rec, (sharded, vmap, met, vmet)


def md_compare_rounds(torch, rec, states, bitwise, errors):
    """Hold the sharded round against the vmap round: bitwise (φ, m, v,
    step, metrics), or within the port's f32 rule — the meta-gradient
    (Adam's m over 1 − β1) at rtol 1e-5 of its largest entry, φ within
    2·lr after Adam's first step — with the gaps recorded."""
    sharded, vmap, met, vmet = states
    same = {k: bool(torch.equal(sharded["opt"][k], vmap["opt"][k]))
            for k in ("m", "v", "step")}
    same["phi"] = bool(torch.equal(sharded["phi"], vmap["phi"]))
    same["metrics"] = all(torch.equal(met[k], vmet[k]) for k in vmet)
    g_gap = float((sharded["opt"]["m"] - vmap["opt"]["m"]).abs().max()
                  / vmap["opt"]["m"].abs().max())
    phi_gap = float((sharded["phi"] - vmap["phi"]).abs().max())
    lr = LM_ROUND["LR"]
    met_gap = max(abs(float(met[k]) - float(vmet[k])) /
                  max(abs(float(vmet[k])), 1e-30) for k in vmet)
    rec.update({"bitwise": same, "meta_grad_rel_gap": g_gap,
                "phi_max_abs_gap": phi_gap, "phi_tol": 2 * lr,
                "metrics_rel_gap": met_gap})
    tag = f"sharded round at world {rec['world']}"
    if bitwise:
        if not all(same.values()):
            errors.append(f"{tag} is not bitwise the vmap round: {same}")
    elif not (g_gap <= 1e-5 and phi_gap <= 2 * lr and met_gap <= 1e-5):
        errors.append(f"{tag}: meta-gradient gap {g_gap} (limit 1e-5), φ "
                      f"{phi_gap} (limit {2 * lr}), metrics {met_gap}")


def md_ep_inputs(torch, cfg):
    from repro_torch.models import moe
    from repro_torch.models.layers import Rng
    params = moe.moe_init(Rng(0, "cuda"), cfg, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn((1, EP_TOKENS, cfg.d_model), device="cuda",
                    generator=gen).bfloat16()
    return params, x


def md_ep_check(torch, cfg, params, x, mesh, errors, *, rank0=True):
    """`ep_moe_apply` on ``mesh`` twice (bitwise equal), against
    `moe_apply` in bf16 within twice the bf16 rounding spread (the gap
    of the bf16 layer to the same layer in f32), and its dropped entries
    against a count from the router logits alone."""
    from repro_torch.models import moe
    from repro_torch.sharding import collectives
    from repro_torch.sharding.ep_moe import ep_moe_apply
    from repro_torch.utils.pytree import tree_map
    with torch.no_grad():
        collectives.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y1 = ep_moe_apply(params, cfg, x, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls = {"calls": dict(collectives.calls),
                 "bytes": dict(collectives.bytes_)}
        y2 = ep_moe_apply(params, cfg, x, mesh)
        rec = {"ep_ms": wall * 1e3, "collectives": calls,
               "twice_bitwise": bool(torch.equal(y1, y2))}
        if not rec["twice_bitwise"]:
            errors.append("ep_moe_apply: two runs differ")
        if not rank0:
            return rec
        y_tp, _ = moe.moe_apply(params, cfg, x)
        p32 = tree_map(lambda t: t.float(), params)
        y32, _ = moe.moe_apply(p32, cfg, x.float())
        del p32
        spread = float((y_tp.float() - y32).abs().max())
        gap = float((y1.float() - y_tp.float()).abs().max())
        xt = x.reshape(-1, cfg.d_model)
        route = moe.moe_route(params, cfg, xt)
        want, _ = routed_overflow(torch, (xt @ params["w_router"]).float(),
                                  cfg.num_experts_per_tok, route["capacity"])
        rec.update({"gap_to_moe_apply": gap, "bitwise_moe_apply":
                    bool(torch.equal(y1, y_tp)), "bf16_spread": spread,
                    "tol": 2 * spread, "capacity": route["capacity"],
                    "dropped": moe.dropped_entries(route),
                    "dropped_from_logits": want})
    if gap > 2 * spread:
        errors.append(f"ep_moe_apply vs moe_apply: {gap} > 2 x {spread}")
    if rec["dropped"] != want:
        errors.append(f"dropped {rec['dropped']} != {want} from the logits")
    return rec


def same_shards(torch, a, b) -> bool:
    """Every tensor leaf of ``a`` and ``b`` a DTensor with equal
    placements, global shape, dtype and local values (bitwise); other
    leaves equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.utils.pytree import tree_flatten
    (la, ta), (lb, tb) = tree_flatten(a), tree_flatten(b)
    if ta != tb:
        return False
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
        elif not (isinstance(x, DTensor) and isinstance(y, DTensor)
                  and x.placements == y.placements and x.shape == y.shape
                  and x.dtype == y.dtype
                  and torch.equal(x.to_local(), y.to_local())):
            return False
    return True


def todays_shards(tree, specs, mesh):
    """Today's route's shards of a whole tree this rank drew: DTensor's
    own cut (`distribute_tensor` with ``src_data_rank=None``), the
    shards `distribute` sends from rank 0's identical draw, with no
    collective (gloo takes no CUDA tensor in its scatter)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import map_with_specs, placements
    return map_with_specs(lambda x, s: distribute_tensor(
        x, mesh, placements(s, mesh), src_data_rank=None), tree, specs)


def tree_nbytes(torch, tree) -> int:
    """Bytes of a tree's tensors (a DTensor's local shard)."""
    from repro_torch.utils.pytree import tree_leaves
    n = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if hasattr(x, "to_local") else x
            n += x.numel() * x.element_size()
    return n


def largest_unit_f32(torch, cfg) -> int:
    """Bytes of the largest leaf of one of `init_lm`'s draw units (a
    layer's leaf, or the embedding drawn whole) in f32."""
    from repro_torch.models.layers import Rng
    from repro_torch.models.lm import init_units
    from repro_torch.utils.pytree import tree_leaves
    return max(x.numel() * 4 for _, u, _ in init_units(Rng(0, "meta"), cfg)
               for x in tree_leaves(u))


# the decode state drawn on the two ranks: 2 sequences of 4,096 slots
MD_DECODE = dict(batch=2, seq=4096)


def md_shard_init(torch, errors):
    """The launchers' shard-only init on the two ranks. SmolLM-360M at
    full width on the 2x1 (FSDP) and 1x2 (tensor-parallel) meshes: the
    FOMAML train state through `launch/train.train(steps=0)` and the
    decode weights and cache through `launch/serve.decode_state`, each
    bitwise `todays_shards` of the whole draw. Then qwen2.5-3b's train
    state (30.86 GB whole) drawn shard by shard on the 2x1 mesh, init
    and placement only: this rank's peak allocated bytes over the init
    against its shard's bytes and the whole state's (today's route,
    which holds the whole state on each rank, is not run at this
    width)."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import serve
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding.rules import (cache_pspecs, param_pspecs,
                                            state_pspecs)
    out = {}
    cfg = get_config("smollm-360m")
    shape = tl.cut_shape(INPUT_SHAPES["train_4k"], seqs_per_client=2,
                         clients=1)
    _, init_state, _, _ = make_train_step(cfg)
    for data, model in ((2, 1), (1, 2)):
        mesh = make_host_mesh(data, model, device_type="cuda")
        t0 = time.perf_counter()
        new, _ = tl.train(cfg, shape, steps=0, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        whole = init_state(0, device="cuda")
        old = todays_shards(whole, state_pspecs(
            whole, param_pspecs(whole["phi"]["theta"], mesh), mesh), mesh)
        del whole
        train_ok = same_shards(torch, new, old)
        shard_b = tree_nbytes(torch, new)
        del new, old
        dnew = serve.decode_state(cfg, **MD_DECODE, device="cuda", mesh=mesh)
        wp, wc = serve.decode_state(cfg, **MD_DECODE, device="cuda")
        dold = (todays_shards(wp, param_pspecs(wp, mesh), mesh),
                todays_shards(wc, cache_pspecs(wc, mesh), mesh))
        del wp, wc
        decode_ok = same_shards(torch, dnew, dold)
        del dnew, dold
        tag = f"smollm_{data}x{model}"
        out[tag] = {"train_bitwise": train_ok, "decode_bitwise": decode_ok,
                    "train_state_shard_gb": shard_b / 1e9,
                    "sharded_train_init_s": init_s}
        if not (train_ok and decode_ok):
            errors.append(f"{tag}: sharded init differs from today's "
                          f"shards (train {train_ok}, decode {decode_ok})")
        gc.collect()
        torch.cuda.empty_cache()
    qcfg = get_config("qwen2.5-3b")
    mesh = make_host_mesh(2, 1, device_type="cuda")
    _, qinit, _, _ = make_train_step(qcfg)
    whole_b = tree_nbytes(torch, qinit(0, device="meta"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = qinit(0, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    shard_b = tree_nbytes(torch, state)
    unit_b = largest_unit_f32(torch, qcfg)
    del state
    out["qwen2.5-3b_2x1"] = {
        "init_peak_gb": peak / 1e9, "shard_gb": shard_b / 1e9,
        "whole_state_gb": whole_b / 1e9,
        "largest_unit_leaf_f32_gb": unit_b / 1e9,
        "peak_over_shard_gb": (peak - shard_b) / 1e9, "init_s": init_s}
    # the shard plus one unit's largest leaf in its f32 staging and its
    # cast copy (the prediction in PERF.md)
    bound = shard_b + 2 * unit_b
    out["qwen2.5-3b_2x1"]["peak_bound_gb"] = bound / 1e9
    if peak > bound:
        errors.append(f"qwen2.5-3b sharded init peaked at {peak / 1e9} GB, "
                      f"over its shard plus two unit leaves, {bound / 1e9} "
                      f"GB (the whole state is {whole_b / 1e9} GB)")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _md_child(rank, world, store, out_dir):
    """One rank of the two-rank world on the one card (gloo; its CUDA
    tensors staged through pinned host buffers by
    `sharding.collectives`): the sharded round at m = 5, the
    expert-parallel layer on a 1x2 model mesh and the launchers'
    shard-only init (`md_shard_init`); then, in a second world,
    the launcher's step on two ranks (`md_launcher_world2`). Writes its
    record to ``out_dir/rank{rank}.json``; a failure exits nonzero."""
    import torch
    import torch.distributed as dist
    errors, rec = [], {"rank": rank}
    try:
        torch.cuda.set_device(0)
        _md_flags(torch)
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_host_mesh
        _build.get_ext()
        cfg = get_config("smollm-360m")
        r, states = md_sharded_round(torch, cfg, MD_CLIENTS[2],
                                     check_k2=True)
        if states is not None:
            md_compare_rounds(torch, r, states, False, errors)
        del states
        if not all(c["bitwise_plain"] for c in r["k2_calls"]):
            errors.append(f"rank {rank}: K2 differs from its plain version")
        for name in ("inner_update_plane", "weighted_aggregate", "adam_flat"):
            if r["launches"][name] <= 0:
                errors.append(f"rank {rank}: {name} not launched")
        rec["sharded"] = r
        gc.collect()
        torch.cuda.empty_cache()
        mcfg = get_config("deepseek-v2-236b")
        mesh = make_host_mesh(1, world, device_type="cuda")
        params, x = md_ep_inputs(torch, mcfg)
        rec["ep"] = md_ep_check(torch, mcfg, params, x, mesh, errors,
                                rank0=rank == 0)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, x
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec["shard_init"] = md_shard_init(torch, errors)
        rec["shard_init_s"] = time.perf_counter() - t0
        dist.barrier()
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec["launcher"] = md_launcher_world2(torch, rank, world,
                                             store + ".staged", errors)
        rec["launcher_s"] = time.perf_counter() - t0
    except Exception as e:       # noqa: BLE001 — recorded, then exit 1
        errors.append(f"{type(e).__name__}: {e}")
        rec["trace"] = traceback.format_exc()[-3000:]
    rec["errors"] = errors
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(1 if errors else 0)


def md_two_ranks(torch, errors):
    """Spawn the two ranks (`_md_child`), wait for both within
    `MD_CHILD_TIMEOUT_S`, and read their records: a child that fails,
    hangs or writes no record fails the phase."""
    import multiprocessing as mp
    import tempfile
    out = tempfile.mkdtemp(prefix="md_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_md_child,
                         args=(r, 2, os.path.join(out, "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + MD_CHILD_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    recs = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            errors.append(f"rank {r} did not finish in {MD_CHILD_TIMEOUT_S} s")
        path = os.path.join(out, f"rank{r}.json")
        if not os.path.exists(path):
            errors.append(f"rank {r} wrote no record (exit {p.exitcode})")
            continue
        with open(path) as f:
            rec = json.load(f)
        rec["exitcode"] = p.exitcode
        errors.extend(f"rank {r}: {e}" for e in rec["errors"])
        if p.exitcode != 0 and not rec["errors"]:
            errors.append(f"rank {r} exited {p.exitcode}")
        recs.append(rec)
    return recs


def md_step_against(torch, a, r0, b, r1, name, errors, *,
                    both_ulps=False) -> dict:
    """A launcher step on a mesh (φ leaves ``b``, record ``r1``) held
    against the meshless step (``a``, ``r0``): the loss within 1e-5
    relative, and φ bitwise or within 2·lr plus one bf16 ulp of the
    mesh's entry (Adam's first step moves an entry by at most lr). With
    ``both_ulps`` the ulp is the larger entry's, since each side rounds
    its own entry: where a near-zero gradient's sign differs, the two
    steps go opposite ways and one side ends near zero."""
    lr = LAUNCH_LR["outer_lr"]
    eps = torch.finfo(torch.bfloat16).eps
    bitwise = all(torch.equal(x, y) for x, y in zip(a, b))
    over = max(float(((x.float() - y.float()).abs() - 2 * lr - eps * (
        torch.maximum(x.float().abs(), y.float().abs()) if both_ulps
        else y.float().abs())).max()) for x, y in zip(a, b))
    gap = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(a, b))
    if not bitwise and over > 0:
        errors.append(f"launcher {name}: φ gap {gap} past the limit")
    if abs(r0["query_loss"] - r1["query_loss"]) > 1e-5 * abs(
            r0["query_loss"]):
        errors.append(f"launcher {name} loss {r1['query_loss']} != "
                      f"{r0['query_loss']}")
    return {"loss": r1["query_loss"], "meshless_loss": r0["query_loss"],
            "step_s": r1["wall_s"], "phi_bitwise": bitwise,
            "phi_max_abs_gap": gap, "phi_max_over_tol": over,
            "phi_tol": "2·lr + eps(bf16)·" + (
                "max(|φ|, |φ_meshless|)" if both_ulps else "|φ|")
            + f" (lr {lr})"}


def md_launched(launches, name, errors):
    for k in ("flash_attention", "inner_update_plane"):
        if launches[k] <= 0:
            errors.append(f"{k} not launched by the launcher {name}")


def md_launcher_setup():
    """SmolLM-360M at full width, train_4k's 4,096 tokens cut to 1
    client of 1 + 1 sequences."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import train as tl
    return get_config("smollm-360m"), tl.cut_shape(
        INPUT_SHAPES["train_4k"], seqs_per_client=2, clients=1)


def md_launcher(torch, errors):
    """The training launcher on the 1x1 NCCL host mesh (`md_launcher_setup`),
    one FOMAML step with the state and batch as DTensors, twice: from
    the state drawn shard by shard (`init_state(mesh=...)`) and from an
    injected φ, the whole seed-0 draw, placed by `distribute`. Each is
    held against the same step with no mesh from the whole draw of the
    same seed (`md_step_against`), and the two mesh runs bitwise equal.
    K7 and K1 launched on the mesh in each run (through `local_map`);
    the path's counts are the shard-only run's."""
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg, shape = md_launcher_setup()
    mesh = make_host_mesh(1, 1, device_type="cuda")
    phi = make_train_step(cfg)[1](0, device="cuda")["phi"]
    runs = {}
    for name, m, inj in (("meshless", None, None), ("mesh", mesh, None),
                         ("mesh_injected", mesh, phi)):
        reset_launches()
        state, recs = tl.train(
            cfg, shape, steps=1, device="cuda", log_every=10 ** 9, mesh=m,
            phi=None if inj is None else tree_map(torch.clone, inj),
            **LAUNCH_LR)
        runs[name] = (tree_leaves(tl.full(state["phi"])), recs[0],
                      read_launches())
        del state
    del phi
    a, r0, _ = runs["meshless"]
    rec = {"seq_len": shape.seq_len, "support": 1, "query": 1,
           "meshless_step_s": r0["wall_s"]}
    for name in ("mesh", "mesh_injected"):
        b, r1, launches = runs[name]
        rec[name] = {**md_step_against(torch, a, r0, b, r1, name, errors),
                     "launches": launches}
        md_launched(launches, name, errors)
    (b, r1, _), (c, r2, _) = runs["mesh"], runs["mesh_injected"]
    rec["mesh_runs_bitwise"] = (r1["query_loss"] == r2["query_loss"] and all(
        torch.equal(x, y) for x, y in zip(b, c)))
    if not rec["mesh_runs_bitwise"]:
        errors.append("launcher: the shard-only and the injected-φ runs on "
                      "the mesh differ")
    launches = runs["mesh"][2]
    del runs, a, b, c
    return rec, launches


def md_launcher_world2(torch, rank, world, store, errors):
    """The training launcher's step on the two ranks, on a 1x2 mesh
    (tensor-parallel over model), in a world on the backend
    `staged_gloo`: DTensor's collectives run as
    `sharding.collectives.StagedGloo`, gloo on pinned host copies (gloo
    ends the process on DTensor's all-gather of a CUDA tensor:
    `tools/probe_gloo_cuda.py`). `md_launcher_setup`'s step from the
    state drawn shard by shard, against the meshless step from the
    whole draw of the same seed on rank 0 (`md_step_against`, the ulp
    of the larger entry). K7 and K1 launched on the mesh. (On the 2x1
    mesh the batch of one sequence cannot shard, so DTensor splits each
    FSDP matmul's contraction and sums bf16 partials: the loss moves by
    1.6e-5 relative, past the limit; `PERF.md` §7.)"""
    import torch.distributed as dist
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import collectives as coll
    from repro_torch.utils.pytree import tree_leaves
    dist.init_process_group(coll.register_staged_gloo(),
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    cfg, shape = md_launcher_setup()
    mesh = make_host_mesh(1, 2, device_type="cuda")
    reset_launches()
    coll.reset()
    state, recs = tl.train(cfg, shape, steps=1, device="cuda",
                           log_every=10 ** 9, mesh=mesh, **LAUNCH_LR)
    launches = read_launches()
    rec = {"mesh": "1x2", "seq_len": shape.seq_len, "launches": launches,
           "collectives": {"calls": dict(coll.calls),
                           "bytes": dict(coll.bytes_)}}
    md_launched(launches, f"on rank {rank}", errors)
    b = tree_leaves(tl.full(state["phi"]))
    r1 = recs[0]
    del state
    if rank == 0:
        state, recs = tl.train(cfg, shape, steps=1, device="cuda",
                               log_every=10 ** 9, **LAUNCH_LR)
        rec.update(md_step_against(torch, tree_leaves(state["phi"]),
                                   recs[0], b, r1, "on two ranks", errors,
                                   both_ulps=True))
        del state
    else:
        rec.update(loss=r1["query_loss"], step_s=r1["wall_s"])
    del b
    dist.barrier()
    return rec


def phase_multi_device(torch):
    """The multi-device plane on the one card: (i) the sharded FedMeta
    round at an NCCL world of 1, bitwise the vmap round; (ii) the
    expert-parallel MoE layer on the 1x1 mesh against `moe_apply`; (iii)
    the launcher on the 1x1 mesh, from the shard-only draw and from an
    injected φ, against the meshless step; (iv) two ranks over gloo on
    the one card (not an interconnect measurement): the sharded round
    at m = 5 within the f32 rule of the vmap round, each rank's K2
    bitwise its plain version, the expert-parallel layer with 80
    experts a rank, the launchers' shard-only init, and the launcher's
    step on the 1x2 mesh against the meshless step."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import ensure_world, make_host_mesh
    errors, paths, parts = [], {}, {}
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    ensure_world("cuda")
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        raise PhaseFailed("multi_device needs the NCCL world of 1")
    rec, states = md_sharded_round(torch, cfg, MD_CLIENTS[1])
    md_compare_rounds(torch, rec, states, True, errors)
    del states
    paths["multi_device_sharded"] = rec["launches"]
    for name in ("inner_update_plane", "weighted_aggregate", "adam_flat"):
        if rec["launches"][name] <= 0:
            errors.append(f"{name} not launched on the sharded round")
    parts["sharded_world1"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config("deepseek-v2-236b")
    params, x = md_ep_inputs(torch, mcfg)
    parts["ep_world1"] = md_ep_check(torch, mcfg, params, x,
                                     make_host_mesh(1, 1), errors)
    del params, x
    gc.collect()
    torch.cuda.empty_cache()
    parts["launcher_mesh"], paths["multi_device_launcher"] = md_launcher(
        torch, errors)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    parts["world2_gloo"] = md_two_ranks(torch, errors)
    w2 = next((r for r in parts["world2_gloo"] if r["rank"] == 0), None)
    if w2 is not None and "sharded" in w2:
        paths["multi_device_sharded_w2"] = w2["sharded"]["launches"]
    if w2 is not None and "launcher" in w2:
        paths["multi_device_launcher_w2"] = w2["launcher"]["launches"]
    emit({"phase": "multi_device", "ok": not errors, **parts,
          "world1_s": t1 - t0, "world2_s": time.perf_counter() - t1,
          "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch-cuts", metavar="ALGO:S,...", default=None,
                    help="only measure the launcher's step at these cuts")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        emit({"phase": "device", "ok": False,
              "error": "src/repro_torch not found: run from a repo checkout"})
        return 2
    try:
        import torch
    except ImportError:
        emit({"phase": "device", "ok": False, "error": "torch is missing"})
        return 2
    if not torch.cuda.is_available():
        emit({"phase": "device", "ok": False,
              "error": "no CUDA device: this smoke test runs on the card"})
        return 2
    sys.path.insert(0, SRC)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "ok": True, "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if args.launch_cuts:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        launch_cuts(torch, args.launch_cuts)
        return 0

    t_start = time.perf_counter()
    starts = {}

    def mark(name):
        starts[name] = time.perf_counter()
        return name

    phase = mark("build")
    summaries, paths = {}, {}
    try:
        from repro_torch.configs import get_config
        # full-f32 matmuls and convolutions, deterministic cuDNN algorithms
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        cfg = get_config("smollm-360m")
        phase_build(torch)
        phase = mark("kernels")
        summaries = phase_kernels(torch, cfg)
        phase = mark("refusals")
        check_refusals(torch)
        phase = mark("serve")
        launches, ctx = phase_serve(torch, cfg)
        paths["serve"] = launches
        phase = mark("trace")
        phase_trace(torch, *ctx)
        del ctx                     # the engine's cache holds ~20 GB
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_femnist")
        paths["train_femnist"] = phase_train_femnist(torch)
        phase = mark("train_lm")
        paths["train_lm"] = phase_train_lm(torch, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_comm")
        paths.update(phase_train_comm(torch, cfg))
        phase = mark("train_faults")
        paths.update(phase_train_faults(torch, cfg))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_scenarios")
        paths.update(phase_train_scenarios(torch))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_async")
        paths.update(phase_train_async(torch, cfg))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_population")
        paths.update(phase_train_population(torch, cfg))
        gc.collect()
        torch.cuda.empty_cache()
        mcfg = get_config("mamba2-370m")
        phase = mark("serve_ssm")
        launches, ctx = phase_serve_ssm(torch, mcfg)
        paths["serve_ssm"] = launches
        phase = mark("trace_ssm")
        phase_trace(torch, *ctx, name="trace_ssm")
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_ssm")
        paths["train_ssm"] = phase_train_ssm(torch, mcfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("decode_launcher")
        paths["decode_launcher"] = phase_decode_launcher(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("train_launcher")
        paths.update(phase_train_launcher(torch))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("serve_moe")
        paths.update(phase_serve_moe(torch))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("serve_multimodal")
        paths.update(phase_serve_multimodal(torch))
        gc.collect()
        torch.cuda.empty_cache()
        phase = mark("multi_device")
        paths.update(phase_multi_device(torch))
    except Exception as e:       # noqa: BLE001 — report, then fail
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}",
              "trace": traceback.format_exc()[-4000:]})
        return 1

    # `launches`: on the first main path that runs the kernel (serving
    # for K1, K7, K8; FEMNIST training for K2, K3; the int8 upload sweep
    # for K6; the robustness sweep for K5; the Mamba2 serve for K9), each
    # path counted from 0; every path's count beside it.
    # K4 is on no path: the reference calls it nowhere. `ms`,
    # `plain_ms` and `library_ms` are calls' times, the host's part
    # inside (each row's `call_ms`, `plain_ms`, `library_ms`);
    # `device_ms` and `library_device_ms` are device times from HBM
    # (`device_times`, in turns).
    kernels = []
    for name, s in summaries.items():
        if name == "meta_update_flat":
            first, launches = "no path", 0
        else:
            first = next(p for p in paths if paths[p].get(name, 0) > 0)
            launches = paths[first][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "launches_path": first,
            "launches_by_path": {p: paths[p].get(name, 0) for p in paths},
            "max_abs_err": s["max_abs_err"], "ms": s["call_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "device_ms": s["device_ms"],
            "library_device_ms": s["library_device_ms"],
            "case": s["case"]})
    t_done = time.perf_counter()
    ends = list(starts.values())[1:] + [t_done]
    emit({"phase": "done", "wall_s": t_done - t_start,
          "phase_wall_s": {name: end - t0 for (name, t0), end
                           in zip(starts.items(), ends)}})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
