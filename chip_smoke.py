#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one CUDA card, from a repo checkout

Phases, each printing one JSON line:

  device   fails (nonzero exit, no result) without a CUDA card or outside
           a checkout; prints `nvidia-smi --query-gpu=name,power.limit`.
  build    builds the port's kernels (K1, K2, K3, K7, K8) from
           kernels/csrc/ for sm_90a into build/torch_ext/ and prints the
           build time.
  kernels  holds each kernel against its plain PyTorch version on the
           card at the main paths' shapes: K1, K2 and K3 bitwise (K2 and
           K3 at the full SmolLM-360M plane), K7 and K8 within a stated
           bf16 tolerance. Times kernel, plain version and one PyTorch
           library call (a yardstick the port never calls) with CUDA
           events: median of 20 runs after warm-up.
  serve    drives the port's serving path at full SmolLM-360M width —
           `build_engine` + `ServingEngine.serve` over 16 seeded
           requests (adapt -> prefill -> decode) — with every kernel's
           launch count set to 0 just before and read just after; checks
           finite output, cache hits, a served row bitwise equal to a
           solo `adapt_packed`, and the distance to the all-plain route.
  trace    torch.profiler over a further adaptation and decode: device
           busy share and device time by kernel group.
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

Then it prints the card's name and power limit, one JSON line with every
kernel's numbers, and last `{"ok": true, "device": {...}}`. Any failed
phase exits nonzero.
"""
from __future__ import annotations

import argparse
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
REPLACES = {
    "inner_update_plane": "src/repro/kernels/meta_update/fused.py:115 "
                          "(_inner_plane_scalar_call), "
                          "src/repro/kernels/meta_update/fused.py:138 "
                          "(_inner_plane_vec_call)",
    "weighted_aggregate": "src/repro/kernels/meta_update/aggregate.py:80",
    "adam_flat": "src/repro/optim/fused_adam.py:58",
    "flash_attention": "src/repro/kernels/attention/flash_attention.py:101",
    "flash_decode": "src/repro/kernels/decode_attention/flash_decode.py:85",
}
SOURCES = {
    "inner_update_plane": "src/repro_torch/kernels/csrc/inner_update.cu",
    "weighted_aggregate": "src/repro_torch/kernels/csrc/aggregate.cu",
    "adam_flat": "src/repro_torch/kernels/csrc/adam.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
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
    from repro_torch.kernels.meta_update import fused, ref
    C, N = 4, n_plane
    gen = torch.Generator(device="cuda").manual_seed(11)
    theta = torch.randn((C, N), device="cuda", generator=gen)
    g = torch.randn((C, N), device="cuda", generator=gen)
    rows = []
    summary = None
    for mode in ("scalar", "per_client"):
        if mode == "scalar":
            alpha = 0.05
            alpha_lib = torch.tensor(0.05, device="cuda")
        else:
            alpha = torch.rand((C, N), device="cuda", generator=gen) * 0.1
            alpha_lib = alpha
        out = theta.clone()
        fused.inner_update_plane(out, alpha, g)             # in place
        torch.cuda.synchronize()
        plain = ref.inner_update_plane_ref(theta, alpha, g)
        bitwise = bool(torch.equal(out, plain))
        err = float((out - plain).abs().max())
        del out, plain
        work = theta.clone()
        ms = time_ms(lambda: fused.inner_update_plane(work, alpha, g), torch)
        del work
        plain_ms = time_ms(lambda: ref.inner_update_plane_ref(theta, alpha, g),
                           torch)
        lib_ms = time_ms(lambda: torch.addcmul(theta, alpha_lib, g, value=-1.0),
                         torch)
        moved = nbytes(theta, g, theta) + (
            nbytes(alpha) if isinstance(alpha, torch.Tensor) else 0)
        b_ms, b_by = bound_ms(moved, 2.0 * C * N, "float32")
        row = {"name": "inner_update_plane", "case": f"C={C} N={N} alpha={mode}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch.addcmul", "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if mode == "scalar":
            summary = row
        if isinstance(alpha, torch.Tensor):
            del alpha, alpha_lib
        if not bitwise:
            raise PhaseFailed(f"K1 not bitwise equal to plain ({mode}): {err}")
    del theta, g
    torch.cuda.empty_cache()
    return rows, summary


def check_k2(torch, n_plane: int):
    """K2 against its plain version, bitwise: m = 4 at the full plane in
    f32 and bf16, then m = 1, 7 and an int8 block at a small N."""
    from repro_torch.kernels.meta_update import aggregate
    gen = torch.Generator(device="cuda").manual_seed(12)
    small = 1 << 20
    rows, summary = [], None
    for m, N, dt in ((4, n_plane, "float32"), (4, n_plane, "bfloat16"),
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
        ms = time_ms(lambda: aggregate.weighted_aggregate_flat(G, w), torch)
        plain_ms = time_ms(lambda: aggregate.weighted_aggregate_ref(G, w),
                           torch)
        lib_ms = (None if dt == "int8" else library_time_ms(
            lambda: torch.mv(G.t(), w.to(G.dtype)), torch))
        b_ms, b_by = bound_ms(nbytes(G, w) + 4 * N, 2.0 * m * N, "float32")
        row = {"name": "weighted_aggregate", "case": f"m={m} N={N} {dt}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
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
    return rows, summary


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
        ms = time_ms(lambda: fused_adam.adam_flat_pallas(
            p1, g, m1, v1, scales, **kw), torch)
        plain_ms = time_ms(lambda: fused_adam.adam_flat_ref(
            phi, g, m, v, scales, **kw), torch)
        steps = [torch.tensor(float(step), device="cuda")]
        lib_ms = library_time_ms(lambda: torch._fused_adam_(
            [p1], [g], [m1], [v1], [], steps, lr=kw["lr"], beta1=kw["b1"],
            beta2=kw["b2"], weight_decay=wd, eps=kw["eps"], amsgrad=False,
            maximize=False), torch)
        itemsize = m.element_size()
        flops = (16.0 if wd > 0 else 14.0) * N
        b_ms, b_by = bound_ms(N * (4 + 4 + 2 * itemsize + 4 + 2 * itemsize),
                              flops, "float32")
        row = {"name": "adam_flat",
               "case": f"N={N} state={sd} wd={wd} step={step}",
               "bitwise_equal": bitwise, "max_abs_err": err, "tol": 0.0,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
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
        (1, 15, 5, 64, 64, 64, "bfloat16", True, None, 0),   # prefill
        (4, 15, 5, 100, 64, 64, "bfloat16", True, None, 0),  # ragged tile
        (4, 15, 5, 64, 64, 64, "bfloat16", True, 16, 0),     # sliding window
        (2, 6, 2, 100, 64, 32, "float32", True, None, 3),    # q_offset, hd_v
        (2, 15, 5, 1, 64, 64, "bfloat16", True, None, 0),    # one token
        (2, 8, 8, 40, 128, 128, "bfloat16", False, None, 0),  # hd 128, no mask
    ]
    rows, summary = [], None
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (B, H, Kv, L, hd, hdv, dt, causal, window, qoff) in cases:
        dtype = getattr(torch, dt)
        q = torch.randn((B, L, H, hd), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, L + qoff, Kv, hd), device="cuda",
                        generator=gen).to(dtype)
        v = torch.randn((B, L + qoff, Kv, hdv), device="cuda",
                        generator=gen).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=qoff)
        out = attn_ops.flash_attention(q, k, v, impl="cuda", **kw)
        plain = attn_ops.flash_attention(q, k, v, impl="torch", **kw)
        torch.cuda.synchronize()
        err, tol, worst = closeness(out, plain, dt)
        ms = time_ms(lambda: attn_ops.flash_attention(q, k, v, impl="cuda",
                                                      **kw), torch)
        plain_ms = time_ms(lambda: attn_ops.flash_attention(
            q, k, v, impl="torch", **kw), torch)
        # SDPA's own causal flag where it means the same mask (q_offset 0,
        # no window), else the kernel's mask given explicitly
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        own_causal = causal and window is None and qoff == 0
        mask = (None if own_causal or not (causal or window)
                else attention_mask(torch, L, L + qoff, causal, window, qoff))
        lib_ms = library_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=own_causal,
            enable_gqa=True), torch)
        pairs = attention_pairs(L, L + qoff, causal, window, qoff)
        flops = 2.0 * B * H * pairs * (hd + hdv)
        b_ms, b_by = bound_ms(nbytes(q, k, v, out), flops, dt)
        row = {"name": "flash_attention",
               "case": f"B={B} H={H} Kv={Kv} L={L} hd={hd} hd_v={hdv} {dt} "
                       f"causal={causal} window={window} q_offset={qoff}",
               "max_abs_err": err, "tol": tol, "worst_of_limit": worst,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention",
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if summary is None:
            summary = row
        if not worst <= 1.0:
            raise PhaseFailed(f"K7 disagrees with plain: {row['case']} "
                              f"err {err}, {worst} of the limit ({tol})")
    return rows, summary


def check_k8(torch):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    cases = [  # (B, C, Kv, G, hd, dtype, ragged)
        (1, 64, 5, 3, 64, "bfloat16", False),   # serving decode step
        (16, 48, 5, 3, 64, "bfloat16", True),
        (16, 100, 5, 3, 64, "bfloat16", True),
        (4, 100, 2, 4, 64, "float32", True),
        (3, 1, 5, 3, 64, "bfloat16", False),    # one slot
        (4, 33, 1, 8, 128, "bfloat16", True),   # G = 8, hd 128, ragged tile
    ]
    rows, summary = [], None
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, C, Kv, G, hd, dt, ragged) in cases:
        dtype = getattr(torch, dt)
        H = Kv * G
        q = torch.randn((B, H, hd), device="cuda", generator=gen).to(dtype)
        kc = torch.randn((B, C, Kv, hd), device="cuda", generator=gen).to(dtype)
        vc = torch.randn((B, C, Kv, hd), device="cuda", generator=gen).to(dtype)
        if ragged:
            kvl = torch.randint(1, C + 1, (B,), device="cuda", generator=gen,
                                dtype=torch.int32)
        else:
            kvl = torch.full((B,), C, device="cuda", dtype=torch.int32)
        out = dec_ops.decode_attention(q, kc, vc, kvl, impl="cuda")
        plain = dec_ops.decode_attention(q, kc, vc, kvl, impl="torch")
        torch.cuda.synchronize()
        err, tol, worst = closeness(out, plain, dt)
        ms = time_ms(lambda: dec_ops.decode_attention(q, kc, vc, kvl,
                                                      impl="cuda"), torch)
        plain_ms = time_ms(lambda: dec_ops.decode_attention(
            q, kc, vc, kvl, impl="torch"), torch)
        qt = q[:, :, None]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        mask = (torch.arange(C, device="cuda")[None, :]
                < kvl[:, None])[:, None, None, :]
        lib_ms = library_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), torch)
        valid = int(kvl.sum())
        elem = q.element_size()
        moved = nbytes(q, out, kvl) + 2 * valid * Kv * hd * elem
        flops = 2.0 * H * valid * (hd + hd)
        b_ms, b_by = bound_ms(moved, flops, dt)
        row = {"name": "flash_decode",
               "case": f"B={B} C={C} Kv={Kv} G={G} hd={hd} {dt} "
                       f"ragged={ragged}",
               "max_abs_err": err, "tol": tol, "worst_of_limit": worst,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention",
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        if summary is None:
            summary = row
        if not worst <= 1.0:
            raise PhaseFailed(f"K8 disagrees with plain: {row['case']} "
                              f"err {err}, {worst} of the limit ({tol})")
    return rows, summary


def phase_kernels(torch, cfg):
    from repro_torch.models import init_lm
    from repro_torch.utils.flat import plane_for
    params = init_lm(0, cfg, device="cuda")
    n_plane = plane_for(params).n_padded
    del params
    torch.cuda.empty_cache()
    rows = []
    summaries = {}
    for name, check in (("inner_update_plane", lambda: check_k1(torch, n_plane)),
                        ("weighted_aggregate", lambda: check_k2(torch, n_plane)),
                        ("adam_flat", lambda: check_k3(torch, n_plane)),
                        ("flash_attention", lambda: check_k7(torch)),
                        ("flash_decode", lambda: check_k8(torch))):
        r, s = check()
        rows += r
        summaries[name] = s
        torch.cuda.synchronize()
    emit({"phase": "kernels", "ok": True, "n_plane": n_plane, "checks": rows})
    return summaries


def phase_serve(torch, cfg):
    from repro_torch.federated.serving import TrafficModel
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.meta_update import fused as k1
    from repro_torch.launch.serve import build_engine
    from repro_torch.utils.pytree import tree_leaves

    L_SUP, L_PROMPT, NEW = 64, 64, 8
    engine = build_engine(cfg, algo_name="fomaml", inner_lr=0.05,
                          inner_steps=1, adapt_batch=4, cache_capacity=16,
                          device="cuda")

    def mk(rng, size):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size, (size, L_SUP)),
                               dtype=torch.int32)

    def mp(rng):
        return torch.as_tensor(rng.randint(0, cfg.vocab_size, (L_PROMPT,)),
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

    k1.launches = k7.launches = k8.launches = 0
    report = engine.serve(reqs, max_new_tokens=NEW)
    launches = {"inner_update_plane": k1.launches,
                "flash_attention": k7.launches, "flash_decode": k8.launches}
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # summary() takes its adapt percentiles over every request, a hit
    # counting 0 ms, as the reference does; the misses of one flush share
    # its wall time, so these are the flushes' own walls, in order
    summary = report.summary()
    flush_ms = list(dict.fromkeys(rec["adapt_ms"] for rec in report.records
                                  if not rec["hit"]))

    errors = []
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"{name} was not launched on the serving path")
    for rec in report.records:
        if not bool(torch.isfinite(rec["row"]).all()):
            errors.append(f"request {rec['rid']}: non-finite adapted row")
        toks = rec.get("tokens")
        if toks is None or toks.shape != (NEW,) or not (
                (toks >= 0).all() and (toks < cfg.vocab_size).all()):
            errors.append(f"request {rec['rid']}: bad tokens {toks}")
    if summary["hits"] <= 0:
        errors.append("no adaptation-cache hit")

    # a served row equals the solo adaptation of that request, bit for
    # bit: as the f32 plane row (adapt_packed_batch with C = 1) and as the
    # bf16 parameter tree (adapt_packed, which unpacks that row)
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

    # distance to the all-plain route (K1, K7 plain) on two requests,
    # compared as f32 plane rows
    theta0 = engine.plane.pack(engine._phi["theta"])
    plain_cmp = []
    for rec in misses[:2]:
        sup = by_rid[rec["rid"]].support.to("cuda")
        with attn_ops.use_impl("torch"):
            row_t = engine.algo.adapt_packed_batch(engine._phi, sup[None],
                                                   impl="torch")[0]
        diff = float((row_t - rec["row"]).abs().max())
        step = float((row_t - theta0).abs().max())
        plain_cmp.append({"rid": rec["rid"], "max_abs_diff": diff,
                          "max_abs_step": step, "ratio": diff / step})
        del row_t
    # The two routes differ only in how attention's bf16 output is rounded
    # (kernel vs plain order of summation: at most one bf16 ulp, 2^-8
    # relative). Through 32 bf16 layers forward and back that moves
    # gradient entries by a few percent of the largest one, and the row
    # moves by inner_lr * g: hold the gap under 1/8 of the largest step.
    plain_tol_ratio = 0.125
    for c in plain_cmp:
        if not c["ratio"] <= plain_tol_ratio:
            errors.append(f"plain-route gap {c} above {plain_tol_ratio}")

    emit({"phase": "serve", "ok": not errors, "arch": cfg.name,
          "n_plane": engine.plane.n_padded, "requests": len(reqs),
          "support_len": L_SUP, "prompt_len": L_PROMPT,
          "max_new_tokens": NEW, "summary": summary,
          "adapt_ms_by_flush": flush_ms, "launches": launches,
          "launches_per_request": {k: v / len(reqs)
                                   for k, v in launches.items()},
          "peak_mem_gb": peak_gb, "solo_bitwise_equal": solo_equal,
          "plain_route": plain_cmp, "plain_tol_ratio": plain_tol_ratio,
          "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches, (engine, mk, mp, NEW)


KERNEL_GROUPS = (("K1 inner_update", ("inner_update_kernel",)),
                 ("K2 weighted_aggregate", ("weighted_aggregate_kernel",)),
                 ("K3 adam", ("adam_kernel",)),
                 ("K7 flash_attention", ("flash_attention_kernel",)),
                 ("K8 flash_decode", ("flash_decode_kernel",)),
                 ("gemm", ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                           "splitk")),
                 ("copy/cast/fill", ("copy", "memcpy", "memset", "fill")))


def _traced(torch, fn):
    """(host wall s, device summary) of one traced run of fn."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    by_name, n_events = {}, 0
    for evt in prof.events():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        n_events += 1
        by_name[evt.name] = by_name.get(evt.name, 0.0) + \
            evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        low = name.lower()
        for g, keys in KERNEL_GROUPS:
            if any(k.lower() in low for k in keys):
                groups[g] += ms
                break
        else:
            groups["other"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return traced_s, {
        "wall_ms_traced": traced_s * 1e3, "device_events": n_events,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (traced_s * 1e3),
        "device_ms_by_group": groups,
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


def phase_trace(torch, engine, mk, mp, new_tokens):
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
    emit({"phase": "trace", "ok": True, "requests": len(reqs),
          "device_time_visible": visible, "adapt": adapt, "decode": decode})


# ------------------------------------------------------------------ train

# 4 clients x (download + upload) x 1,846,520 B of f32 φ for
# femnist_cnn(62, hidden=128): the committed comparison artifact's
# 14.77216 MB a round (results/experiments/femnist_compare.json)
FEMNIST_ROUND_BYTES = 14_772_160


def _kernel_modules():
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.meta_update import aggregate as k2
    from repro_torch.kernels.meta_update import fused as k1
    from repro_torch.optim import fused_adam as k3
    return {"inner_update_plane": k1, "weighted_aggregate": k2,
            "adam_flat": k3, "flash_attention": k7, "flash_decode": k8}


def reset_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


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
    # where a round's time goes: one more round of the kernel run, traced
    _, trace = _traced(torch, lambda: tr.run(state, 1))
    emit({"phase": "train_femnist", "ok": not errors, "rounds": ROUNDS,
          "clients_per_round": 4, "n_real": tr._plane.n_real,
          "phi_bytes": tr.comm.phi_bytes,
          "bytes_per_round": tr.comm.total_bytes / ROUNDS,
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


def phase_train_lm(torch, cfg):
    """Three packed FOMAML rounds of SmolLM-360M at full width on the
    client plane: m = 4 clients, 4 support and 4 query sequences of 128
    tokens each, Adam(1e-3). Round 1 is held against the same round on
    the all-plain route (K1, K2, K3 and attention plain); round 3 is
    traced."""
    import numpy as np
    from repro_torch.core import make_algorithm
    from repro_torch.core.fedmeta import (init_packed_state,
                                          make_packed_meta_train_step)
    from repro_torch.core.losses import lm_loss
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch.steps import make_apply_fn
    from repro_torch.models import init_lm
    from repro_torch.optim import adam
    from repro_torch.utils.flat import plane_for
    from repro_torch.utils.pytree import tree_map

    M, S, Q, L, LR = 4, 4, 4, 128, 1e-3
    algo = make_algorithm("fomaml", *lm_loss(make_apply_fn(cfg)), 0.05)
    phi = {"theta": init_lm(0, cfg, device="cuda")}
    plane = plane_for(phi)
    opt = adam(LR)
    state = init_packed_state(opt, plane, phi)
    del phi
    rng = np.random.RandomState(0)
    batches = [tuple(torch.as_tensor(rng.randint(0, cfg.vocab_size, (M, n, L)),
                                     dtype=torch.int32, device="cuda")
                     for n in (S, Q)) for _ in range(3)]
    step = make_packed_meta_train_step(algo, opt, plane, client_plane=True,
                                       impl="cuda")

    # round 1 on the all-plain route, from a copy (K3 updates in place)
    plain_step = make_packed_meta_train_step(algo, opt, plane,
                                             client_plane=True, impl="torch")
    st = {"phi": state["phi"].clone(), "opt": tree_map(torch.clone,
                                                       state["opt"])}
    with attn_ops.use_impl("torch"):
        st, _ = plain_step(st, *batches[0])
    phi_plain, m_plain = st["phi"], st["opt"]["m"]
    del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    walls, metrics = [], []
    for r in range(2):
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
            # the same kernel-vs-plain attention rounding through 32
            # bf16 layers
            d_phi = float((state["phi"] - phi_plain).abs().max())
            moved = float(((state["phi"] - phi_plain).abs() > 1e-6)
                          .float().mean())
            d_g = float((state["opt"]["m"] - m_plain).abs().max()
                        / m_plain.abs().max())
            del phi_plain, m_plain
    box = {}

    def third():
        box["state"], box["met"] = step(state, *batches[2])

    wall3, trace = _traced(torch, third)
    state = box["state"]
    walls.append(wall3)
    metrics.append({k: float(v) for k, v in box["met"].items()})
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    errors = []
    for name in ("inner_update_plane", "weighted_aggregate", "adam_flat",
                 "flash_attention"):
        if launches[name] <= 0:
            errors.append(f"{name} was not launched on the LM training path")
    if not bool(torch.isfinite(state["phi"]).all()):
        errors.append("non-finite φ")
    phi_tol = 2 * LR + 1e-6
    g_tol = 0.125
    if not (d_phi <= phi_tol and d_g <= g_tol):
        errors.append(f"round 1 vs the plain route: |dφ| {d_phi} (limit "
                      f"{phi_tol}), meta-gradient {d_g} (limit {g_tol})")
    emit({"phase": "train_lm", "ok": not errors, "arch": cfg.name,
          "n_plane": plane.n_padded, "clients": M, "support": S, "query": Q,
          "seq_len": L, "round_wall_ms": [w * 1e3 for w in walls],
          "round3_traced": True, "metrics": metrics, "peak_mem_gb": peak_gb,
          "launches": launches,
          "plain_route_round1": {"max_abs_dphi": d_phi, "phi_tol": phi_tol,
                                 "share_moved_1e-6": moved,
                                 "meta_grad_rel": d_g, "meta_grad_tol": g_tol},
          "trace_round3": trace, "errors": errors})
    if errors:
        raise PhaseFailed("; ".join(errors))
    return launches


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)

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

    phase = "build"
    try:
        from repro_torch.configs import get_config
        # full-f32 matmuls and convolutions, deterministic cuDNN algorithms
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        cfg = get_config("smollm-360m")
        phase_build(torch)
        phase = "kernels"
        summaries = phase_kernels(torch, cfg)
        phase = "serve"
        launches, ctx = phase_serve(torch, cfg)
        phase = "trace"
        phase_trace(torch, *ctx)
        del ctx                     # the engine's cache holds ~20 GB
        gc.collect()
        torch.cuda.empty_cache()
        phase = "train"
        paths = {"serve": launches,
                 "train_femnist": phase_train_femnist(torch),
                 "train_lm": phase_train_lm(torch, cfg)}
    except Exception as e:       # noqa: BLE001 — report, then fail
        emit({"phase": phase, "ok": False, "error": f"{type(e).__name__}: {e}",
              "trace": traceback.format_exc()[-4000:]})
        return 1

    # `launches`: on the first main path that runs the kernel (serving
    # for K1, K7, K8; FEMNIST training for K2, K3), each path counted
    # from 0; every path's count beside it
    kernels = []
    for name, s in summaries.items():
        first = next(p for p in paths if paths[p].get(name, 0) > 0)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": paths[first][name],
            "launches_path": first,
            "launches_by_path": {p: paths[p].get(name, 0) for p in paths},
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "case": s["case"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
