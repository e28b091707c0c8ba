#!/usr/bin/env python3
"""Probe K1 (inner update) and K8 (flash decode) on the card.

    python3 tools/probe_k1_k8.py [--steps checks,k8_checks,k1_variants,k8_phases,k8_layout]
                                 [--parent DIR] [--out FILE]

1. `nvcc -Xptxas -v` on `inner_update.cu` and `flash_decode.cu`: each
   kernel's registers, spills and shared memory.
2. `chip_smoke.py`'s K1, K4 and K8 checks (the kernel against its plain
   version, `device_ms` beside the library yardstick and the bound);
   `k8_checks`: K8's alone, with the vmap fold and the parent-bits
   check (`tools/kernel_bits.py`), each reported whether or not it
   passes.
3. K1's loop at the full SmolLM-360M plane in the variants of
   `VARIANTS` (block size, float4s a thread, streaming hints, one pass
   over the plane or whole waves of a grid-stride loop), each in turns
   with the library call that computes the same update under
   `chip_smoke.device_times`: `torch.sub(alpha=)` for a scalar α,
   `addcmul` for a per-client α and for K4's flat out-of-place case.
4. K8's phases in SM cycles (a copy of its two tensor-core kernels
   with clock64() at the phase ends, at `K8_PHASE_CASES`: the serving
   steps and decode_32k's steps as the paths run them); then K8 on the
   decode path's
   interleaved cache against the same cache stored head-major.
   And K8, SDPA, K1 and addcmul timed after the L2 flush `device_ms`
   uses (an in-place write) against after a read-only flush.
5. With `--parent DIR` (a tree holding the previous
   `src/repro_torch/kernels/csrc/`): the previous K1 and K8 kernels
   against the current ones at the same inputs, in turns; with the
   `k8_parent` step, K8 alone, at `K8_PARENT_CASES`, against the parent
   and every `--alt DIR` tree.

Kernels for 3–5 are built by nvcc into a shared library with a
plain C interface (`build/probe/`, gitignored) and driven by ctypes.
Prints one JSON object a step; with --out, also writes them all there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CSRC = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc")
BUILD = os.path.join(REPO, "build", "probe")
NVCC = [shutil.which("nvcc") or os.path.join(
    os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

# K1's loop at other block sizes, unroll depths and grids, with and
# without the streaming hints (variant i: VARIANTS[i])
VARIANTS = [  # (threads, float4s a thread, streaming hints, whole waves)
    (256, 4, True, False), (256, 4, False, False), (128, 2, False, False),
    (128, 2, True, False), (128, 4, False, False), (512, 2, False, False),
    (256, 2, False, False), (128, 1, False, False), (256, 4, True, True)]
VARIANTS_SRC = r"""
#include <cuda_runtime.h>
template <bool kHint> __device__ __forceinline__ float4 ld(const float4* p) {
  if (kHint) return __ldcs(p);
  return *p;
}
template <bool kHint> __device__ __forceinline__ void st(float4* p, float4 v) {
  if (kHint) __stcs(p, v); else *p = v;
}
__device__ __forceinline__ float upd(float t, float a, float g) {
  return __fsub_rn(t, __fmul_rn(a, g));
}
template <int kT, int kU, bool kHint, int kMode>
__global__ void __launch_bounds__(kT)
k1v(const float* theta, float* out, const float* __restrict__ alpha,
    float alpha_s, const float* __restrict__ g, long long rows, long long n4) {
  const float4* t4 = reinterpret_cast<const float4*>(theta);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* a4 = reinterpret_cast<const float4*>(alpha);
  float4* o4 = reinterpret_cast<float4*>(out);
  constexpr long long kChunk = (long long)kT * kU;
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < n4;
       base += (long long)gridDim.x * kChunk) {
    float4 a[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = base + u * kT;
      a[u] = make_float4(alpha_s, alpha_s, alpha_s, alpha_s);
      if (kMode == 1 && i < n4) a[u] = ld<kHint>(a4 + i);
    }
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
      const long long off = row * n4;
      float4 t[kU], gv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long i = base + u * kT;
        if (i < n4) {
          t[u] = ld<kHint>(t4 + off + i);
          gv[u] = ld<kHint>(g4 + off + i);
          if (kMode == 2) a[u] = ld<kHint>(a4 + off + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long i = base + u * kT;
        if (i < n4)
          st<kHint>(o4 + off + i,
                    make_float4(upd(t[u].x, a[u].x, gv[u].x),
                                upd(t[u].y, a[u].y, gv[u].y),
                                upd(t[u].z, a[u].z, gv[u].z),
                                upd(t[u].w, a[u].w, gv[u].w)));
      }
    }
  }
}
template <int kT, int kU, bool kHint>
int run(const float* theta, float* out, const float* alpha, float alpha_s,
        int mode, const float* g, long long C, long long N, bool waves,
        int sms, cudaStream_t s) {
  const long long n4 = N / 4, chunk = (long long)kT * kU;
  long long bx = (n4 + chunk - 1) / chunk;
  if (waves) bx = (long long)sms * (2048 / kT);
  const dim3 grid((unsigned)bx, mode == 1 ? 1u : (unsigned)C);
  if (mode == 0)
    k1v<kT, kU, kHint, 0><<<grid, kT, 0, s>>>(theta, out, alpha, alpha_s, g, C, n4);
  else if (mode == 1)
    k1v<kT, kU, kHint, 1><<<grid, kT, 0, s>>>(theta, out, alpha, alpha_s, g, C, n4);
  else
    k1v<kT, kU, kHint, 2><<<grid, kT, 0, s>>>(theta, out, alpha, alpha_s, g, C, n4);
  return (int)cudaGetLastError();
}
extern "C" int k1_variant(int v, const float* theta, float* out,
                          const float* alpha, float alpha_s, int mode,
                          const float* g, long long C, long long N, int sms,
                          cudaStream_t s) {
  switch (v) {
    case 0: return run<256, 4, true>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 1: return run<256, 4, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 2: return run<128, 2, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 3: return run<128, 2, true>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 4: return run<128, 4, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 5: return run<512, 2, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 6: return run<256, 2, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    case 7: return run<128, 1, false>(theta, out, alpha, alpha_s, mode, g, C, N, false, sms, s);
    default: return run<256, 4, true>(theta, out, alpha, alpha_s, mode, g, C, N, true, sms, s);
  }
}
"""

# the previous tree's launchers, behind a C interface
PARENT_K1_SRC = r'''
#include "inner_update.cu"
extern "C" int k1_parent(const float* theta, float* out, const float* alpha,
                         float alpha_s, int mode, const float* g, long long C,
                         long long N, cudaStream_t s) {
  return (int)launch_inner_update(theta, out, alpha, alpha_s, mode, g, C, N, s);
}
'''
PARENT_K8_SRC = r'''
#include "flash_decode.cu"
extern "C" int k8_parent(int dtype, const void* q, const void* k,
                         const void* v, int kvl_s, void* o, float* scratch,
                         const long long* strides, int B, int C, int Kv,
                         int G, int hd, int splits, float scale,
                         cudaStream_t s) {
  return (int)launch_flash_decode(dtype, q, k, v, nullptr, kvl_s, o, scratch,
                                  strides, B, C, Kv, G, hd, splits, scale, s);
}
'''
# (B, C, Kv, G, hd, kv_length) bf16 cases of parent_k8: SmolLM's serving
# step and 32K handoff; the hd-128 serving group, nemotron's serving
# step, mixtral's ring, jamba's, qwen2-vl's and nemotron's full 32K
# caches and the two decode_32k steps as their paths run them
K8_PARENT_CASES = ((1, 64, 5, 3, 64, 64), (1, 32768, 5, 3, 64, 32768),
                   (2, 64, 2, 8, 128, 64), (1, 64, 8, 12, 192, 64),
                   (128, 4096, 8, 6, 128, 4096),
                   (128, 32768, 8, 4, 128, 32768),
                   (128, 32768, 4, 7, 128, 32768),
                   (128, 32768, 8, 12, 192, 32768),
                   (128, 4096, 4, 7, 128, 68), (128, 4096, 8, 12, 192, 68))

# K8's tensor-core kernels with clock64() at their phase ends, written
# by each block's thread 0 into g_probe: staged (first tile landed),
# computed (key loop done; for the wide kernel before its warps merge),
# written (its output). Each edit must match the kernel's own text once
# (`marked`); the file-level edit declares g_probe.
K8_RECORD = (
    "  if (threadIdx.x == 0) {\n"
    "    const long long T3 = clock64();\n    unsigned long long G1;\n"
    "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G1));\n"
    "    unsigned sm;\n    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
    "    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
    " + blockIdx.x;\n"
    "    if (blk < kProbeBlocks) {\n"
    "      long long* r = g_probe + blk * 6;\n"
    "      r[0] = T1 - T0; r[1] = T2 - T1; r[2] = T3 - T2;\n"
    "      r[3] = (long long)G0; r[4] = (long long)G1; r[5] = sm;\n"
    "    }\n  }\n}\n")
K8_START = (
    "  const int gq = lane / 4, t4 = lane % 4;\n"
    "  const long long T0 = clock64();\n  long long T1 = T0;\n"
    "  unsigned long long G0;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G0));\n")
K8_GQ = "  const int gq = lane / 4, t4 = lane % 4;   // query row, key/column pair\n"
K8_END = ("    if (warp == 0 && t4 == 0) {\n"
          "      p.part_ml[row * 2] = m;\n"
          "      p.part_ml[row * 2 + 1] = l;\n    }\n  }\n")
K8_WIDE_END = ("          p.part_acc + ((bh * p.splits + split) * G + g) * hd + d)"
               " = a;\n    }\n  }\n")
# kernel: (the line that opens it, its edits)
K8_KERNELS = {
    "flash_decode_mma_kernel": (
        "flash_decode_mma_kernel(const Args p) {\n", [
            (K8_GQ, K8_START),
            ("    const bf16* Vt = Kt + kTile;\n",
             "    const bf16* Vt = Kt + kTile;\n"
             "    if (t == 0) T1 = clock64();\n"),
            ("  // row gq's sum over the quad;",
             "  const long long T2 = clock64();\n"
             "  // row gq's sum over the quad;"),
            (K8_END + "}\n", K8_END + K8_RECORD)]),
    "flash_decode_wide_kernel": (
        "flash_decode_wide_kernel(const Args p) {\n", [
            (K8_GQ, K8_START),
            ("    fetch(t + kStages - 1);\n",
             "    fetch(t + kStages - 1);\n    if (t == 0) T1 = clock64();\n"),
            ("  // merge the warps' states through the ring's memory:",
             "  const long long T2 = clock64();\n"
             "  // merge the warps' states through the ring's memory:"),
            (K8_WIDE_END + "}\n", K8_WIDE_END + K8_RECORD)]),
}
K8_FILE_MARK = (
    "namespace {\n",
    "namespace {\nconstexpr int kProbeBlocks = 4096;\n"
    "__device__ long long g_probe[kProbeBlocks * 6];\n")
# (B, C, Kv, G, hd) bf16 cases of k8_phases: SmolLM's serving step and
# 32K handoff (flash_decode_mma_kernel); qwen2.5's serving group,
# nemotron's serving step and qwen2-vl's and nemotron's decode_32k
# steps as their paths run them (flash_decode_wide_kernel); kv_length
# is C but for the last two (68)
K8_PHASE_CASES = ((1, 64, 5, 3, 64, 64), (1, 32768, 5, 3, 64, 32768),
                  (2, 64, 2, 8, 128, 64), (1, 64, 8, 12, 192, 64),
                  (128, 4096, 4, 7, 128, 68), (128, 4096, 8, 12, 192, 68))


def marked(src: str) -> str:
    """flash_decode.cu with every K8_KERNELS edit made inside its kernel."""
    for opening, edits in K8_KERNELS.values():
        head, body = src.split(opening, 1) if src.count(opening) == 1 else (
            None, None)
        if head is None:
            raise SystemExit(f"probe kernel not found once: {opening!r}")
        body, rest = body.split("\n}\n", 1)
        body += "\n}\n"
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"probe mark not found once: {old!r}")
            body = body.replace(old, new)
        src = head + opening + body + rest
    if src.count(K8_FILE_MARK[0]) != 1:
        raise SystemExit("probe file mark not found once")
    return src.replace(*K8_FILE_MARK)


K8_PROBE_API = r"""
extern "C" int k8_probe(int dtype, const void* q, const void* k,
                        const void* v, int kvl_s, void* o, float* scratch,
                        const long long* strides, int B, int C, int Kv, int G,
                        int hd, int splits, float scale, cudaStream_t s) {
  return (int)launch_flash_decode(dtype, q, k, v, nullptr, kvl_s, o, scratch,
                                  strides, B, C, Kv, G, hd, splits, scale, s);
}
extern "C" int k8_probe_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, n * sizeof(long long));
}
"""
P = ctypes.c_void_p


def emit(records, obj):
    records.append(obj)
    print(json.dumps(obj), flush=True)


def ptxas_report(records):
    for name in ("inner_update.cu", "flash_decode.cu"):
        proc = subprocess.run(
            NVCC + ["-Xptxas", "-v", "-c", "-o", os.devnull,
                    os.path.join(CSRC, name)],
            capture_output=True, text=True, cwd=CSRC)
        lines = list(dict.fromkeys(
            ln for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "error" in ln))
        emit(records, {"step": "ptxas", "source": name,
                       "rc": proc.returncode, "report": lines})
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}")


def build_lib(name, src, include_dir):
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, name + ".cu")
    so = os.path.join(BUILD, "lib" + name + ".so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run(NVCC + ["-shared", "-Xcompiler", "-fPIC", "-I",
                           include_dir, "-o", so, cu], check=True)
    return ctypes.CDLL(so)


def plane_size(torch) -> int:
    """N of the SmolLM-360M plane (the K1 checks' width)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.utils.flat import plane_for
    params = init_lm(0, get_config("smollm-360m"), device="cuda")
    n_plane = plane_for(params).n_padded
    del params
    torch.cuda.empty_cache()
    return n_plane


def smoke_checks(torch, cs, records):
    n_plane = plane_size(torch)
    for name, check in (("K8", lambda: cs.check_k8(torch)),
                        ("K1", lambda: cs.check_k1(torch, n_plane)),
                        ("K4", lambda: cs.check_k4(torch, n_plane))):
        t0 = time.perf_counter()
        rows, _ = check()
        emit(records, {"step": "check", "kernel": name,
                       "s": time.perf_counter() - t0, "rows": rows})
    return n_plane


def k8_checks(torch, cs, records):
    """`check_k8`, `check_vmap_fold` and `check_parent_bits`, each
    emitted with its seconds, or with the failure it raised."""
    for name, check in (("K8", lambda: cs.check_k8(torch)[0]),
                        ("vmap_fold", lambda: cs.check_vmap_fold(torch)),
                        ("parent_bits", lambda: cs.check_parent_bits(torch))):
        t0 = time.perf_counter()
        try:
            rows, error = check(), None
        except Exception as e:     # noqa: BLE001 — report, then go on
            rows, error = None, f"{type(e).__name__}: {e}"
        emit(records, {"step": "k8_checks", "check": name,
                       "s": time.perf_counter() - t0, "error": error,
                       "rows": rows})
        torch.cuda.empty_cache()


def k1_variants(torch, cs, n_plane, records):
    """Each VARIANTS kernel against the library call that computes the
    same update, in turns: in place with a scalar α (`torch.sub`) and a
    per-client α (`addcmul`), and K4's out-of-place flat case."""
    lib = build_lib("k1_variants", VARIANTS_SRC, CSRC)
    lib.k1_variant.argtypes = [ctypes.c_int, P, P, P, ctypes.c_float,
                               ctypes.c_int, P, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_int, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(11)
    for case in ("scalar", "per_client", "k4"):
        C, N = (1, n_plane) if case == "k4" else (4, n_plane)
        theta = torch.randn((C, N), device="cuda", generator=gen)
        g = torch.randn((C, N), device="cuda", generator=gen)
        if case == "scalar":
            alpha, mode = 0.05, 0
            library = lambda: torch.sub(theta, g, alpha=alpha)
        else:
            alpha = torch.rand((N,) if case == "k4" else (C, N),
                               device="cuda", generator=gen) * 0.1
            mode = 1 if case == "k4" else 2
            library = lambda: torch.addcmul(theta, alpha, g, value=-1.0)
        a_ptr = None if case == "scalar" else alpha.data_ptr()
        a_s = alpha if case == "scalar" else 0.0
        out = torch.empty_like(theta) if case == "k4" else theta.clone()
        for v, spec in enumerate(VARIANTS):
            src = theta if case == "k4" else out

            def kernel():
                rc = lib.k1_variant(v, src.data_ptr(), out.data_ptr(), a_ptr,
                                    a_s, mode, g.data_ptr(), C, N, sms,
                                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"k1_variant {v}: CUDA error {rc}")

            dev = cs.device_times(torch, kernel, library)
            emit(records, {"step": "k1_variant", "case": case, "C": C,
                           "N": N, "threads": spec[0], "float4s": spec[1],
                           "hints": spec[2], "waves": spec[3],
                           "device_ms": dev["device_ms"],
                           "library_device_ms": dev["library_device_ms"]})
        del theta, g, alpha, out, library
        torch.cuda.empty_cache()


def parent_kernels(torch, cs, n_plane, parent, records):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.meta_update import fused
    pdir = os.path.join(parent, "src", "repro_torch", "kernels", "csrc")
    k1 = build_lib("k1_parent", PARENT_K1_SRC, pdir)
    k1.k1_parent.argtypes = [P, P, P, ctypes.c_float, ctypes.c_int, P,
                             ctypes.c_longlong, ctypes.c_longlong, P]
    k8 = build_lib("k8_parent", PARENT_K8_SRC, pdir)
    k8.k8_parent.argtypes = [ctypes.c_int, P, P, P, P, P, P, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_float, P]
    C, N = 4, n_plane
    gen = torch.Generator(device="cuda").manual_seed(11)
    theta = torch.randn((C, N), device="cuda", generator=gen)
    g = torch.randn((C, N), device="cuda", generator=gen)
    for mode in ("scalar", "per_client"):
        alpha = 0.05 if mode == "scalar" else torch.rand(
            (C, N), device="cuda", generator=gen) * 0.1
        work = theta.clone()
        a_ptr = None if mode == "scalar" else alpha.data_ptr()
        a_s = alpha if mode == "scalar" else 0.0

        def old():
            rc = k1.k1_parent(work.data_ptr(), work.data_ptr(), a_ptr, a_s,
                              0 if mode == "scalar" else 2, g.data_ptr(), C,
                              N, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k1_parent: CUDA error {rc}")

        dev = cs.device_times(torch, lambda: fused.inner_update_plane(
            work, alpha, g), old)
        emit(records, {"step": "parent", "kernel": "K1", "mode": mode,
                       "device_ms": dev["device_ms"],
                       "parent_device_ms": dev["library_device_ms"]})
        del work, alpha
    del theta, g
    torch.cuda.empty_cache()

    parent_k8(torch, cs, [parent], records)


def parent_k8(torch, cs, trees, records):
    """K8 of each tree in `trees` (a directory holding
    `src/repro_torch/kernels/csrc/`: the parent commit unpacked, or a
    variant of this one) against this tree's, in turns on one card at
    K8_PARENT_CASES, each at the split count this tree's wrapper picks."""
    from repro_torch.kernels.decode_attention import flash_decode as k8w
    from repro_torch.kernels.decode_attention import ops as dec_ops
    libs = []
    for i, tree in enumerate(trees):
        pdir = os.path.join(tree, "src", "repro_torch", "kernels", "csrc")
        lib = build_lib(f"k8_parent{i}", PARENT_K8_SRC, pdir)
        lib.k8_parent.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int, P, P,
                                  P] + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                             P]
        libs.append((tree, lib))
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, C, Kv, G, hd, kvl) in K8_PARENT_CASES:
        q = torch.randn((B, Kv * G, hd), device="cuda",
                        generator=gen).bfloat16()
        kc, vc = (torch.randn((B, C, Kv, hd), device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        out = torch.empty_like(q)
        splits = k8w.splits_for(kc, kvl, G)
        scratch = torch.empty(max(B * Kv * splits * G * (hd + 2), 1),
                              device="cuda")
        st = (ctypes.c_longlong * 6)(*kc.stride()[:3], *vc.stride()[:3])
        new = dec_ops.decode_attention(q, kc, vc, kvl)
        for tree, lib in libs:
            def old(lib=lib):
                rc = lib.k8_parent(1, q.data_ptr(), kc.data_ptr(),
                                   vc.data_ptr(), kvl, out.data_ptr(),
                                   scratch.data_ptr(), st, B, C, Kv, G, hd,
                                   splits, 1.0 / hd ** 0.5,
                                   torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"k8_parent: CUDA error {rc}")

            old()
            torch.cuda.synchronize()
            big = C * B > 1 << 20
            dev = cs.device_times(
                torch, lambda: dec_ops.decode_attention(q, kc, vc, kvl), old,
                **({"blocks": 2, "calls": 10} if big else {}))
            emit(records, {"step": "parent", "kernel": "K8", "tree": tree,
                           "case": f"B={B} C={C} Kv={Kv} G={G} hd={hd} bf16 "
                                   f"kv_length={kvl}", "splits": splits,
                           "max_abs_diff": float((new.float() - out.float())
                                                 .abs().max()),
                           "device_ms": dev["device_ms"],
                           "parent_device_ms": dev["library_device_ms"]})
        del q, kc, vc, out, scratch, new
        torch.cuda.empty_cache()


def k8_phases(torch, cs, records):
    """K8's phases in SM clock cycles (median over blocks and calls, the
    L2 evicted before each call) at K8_PHASE_CASES: entry to its first
    tile staged, the key loop, the merge and the output written."""
    from repro_torch.kernels.decode_attention import flash_decode as k8
    with open(os.path.join(CSRC, "flash_decode.cu")) as f:
        src = marked(f.read())
    lib = build_lib("k8_phases", src + K8_PROBE_API, CSRC)
    lib.k8_probe.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int, P, P,
                             P] + [ctypes.c_int] * 6 + [ctypes.c_float, P]
    lib.k8_probe_read.argtypes = [P, ctypes.c_int]
    flush = cs.l2_flush_buffer(torch)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, C, Kv, G, hd, kvl) in K8_PHASE_CASES:
        q = torch.randn((B, Kv * G, hd), device="cuda",
                        generator=gen).bfloat16()
        kc, vc = (torch.randn((B, C, Kv, hd), device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        out = torch.empty_like(q)
        splits = k8.splits_for(kc, kvl, G)
        scratch = torch.empty(max(B * Kv * splits * G * (hd + 2), 1),
                              device="cuda")
        st = (ctypes.c_longlong * 6)(*kc.stride()[:3], *vc.stride()[:3])
        nblk = min(splits * Kv * B, 4096)
        host = (ctypes.c_longlong * (nblk * 6))()

        def call():
            rc = lib.k8_probe(1, q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                              kvl, out.data_ptr(), scratch.data_ptr(), st, B,
                              C, Kv, G, hd, splits, 1.0 / hd ** 0.5,
                              torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k8_probe: CUDA error {rc}")

        rows = []
        for _ in range(20):
            flush.bitwise_not_()
            call()
            torch.cuda.synchronize()
            if lib.k8_probe_read(ctypes.addressof(host), nblk * 6):
                raise RuntimeError("k8_probe_read failed")
            rec = list(host)
            rows += [rec[i * 6:i * 6 + 6] for i in range(nblk)]
        span = [r[4] - r[3] for r in rows]
        med = lambda xs: sorted(xs)[len(xs) // 2]   # noqa: E731
        first = min(r[3] for r in rows[-nblk:])
        emit(records, {"step": "k8_phases",
                       "case": f"B={B} C={C} Kv={Kv} G={G} hd={hd} bf16 "
                               f"kv_length={kvl}",
                       "kernel": k8.kernel_for(torch.bfloat16, G, hd),
                       "splits": splits,
                       "staged_cycles": med([r[0] for r in rows]),
                       "loop_cycles": med([r[1] for r in rows]),
                       "write_cycles": med([r[2] for r in rows]),
                       "block_ns_median": med(span),
                       "block_ns_max": max(span),
                       "last_call_span_ns": max(r[4] for r in rows[-nblk:])
                       - first,
                       "instrumented_device_ms": cs.device_ms(call, torch)})
        del q, kc, vc, out, scratch
        torch.cuda.empty_cache()


def k8_layout(torch, cs, records):
    """K8 on the (B, C, Kv, hd) cache the decode path keeps (a kv head's
    rows Kv·hd apart) against the same values stored head-major (a kv
    head's rows contiguous, as SDPA's yardstick reads them), in turns."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (B, C, Kv, G, hd) in ((1, 32768, 5, 3, 64), (16, 4096, 5, 3, 64)):
        q = torch.randn((B, Kv * G, hd), device="cuda",
                        generator=gen).bfloat16()
        kc, vc = (torch.randn((B, C, Kv, hd), device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        kh, vh = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (kc, vc))
        same = torch.equal(dec_ops.decode_attention(q, kc, vc, C),
                           dec_ops.decode_attention(q, kh, vh, C))
        dev = cs.device_times(
            torch, lambda: dec_ops.decode_attention(q, kc, vc, C),
            lambda: dec_ops.decode_attention(q, kh, vh, C))
        emit(records, {"step": "k8_layout",
                       "case": f"B={B} C={C} Kv={Kv} G={G} hd={hd} bf16",
                       "bitwise_equal": same,
                       "interleaved_device_ms": dev["device_ms"],
                       "head_major_device_ms": dev["library_device_ms"]})


def read_flush_ms(torch, cs, fn, calls: int = 50) -> float:
    """`chip_smoke.device_ms` with the L2 evicted by a read (a sum over
    256 MB, whose kernel marks the calls) instead of a write: the lines
    the kernel then evicts are clean, so it moves only its own bytes."""
    from torch.profiler import ProfilerActivity, profile
    flush = cs.l2_flush_buffer(torch).view(torch.int64)
    marker = "reduce_kernel"
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.elapsed_us(),
                         marker in e.name) for e in prof.events()
                        if str(e.device_type).endswith("CUDA"))
        per_call = []
        for _, us, is_flush in events:
            if is_flush:
                per_call.append([0, 0.0])
            elif per_call:
                per_call[-1][0] += 1
                per_call[-1][1] += us
        counts = [n for n, _ in per_call if n > 0]
        if counts:
            n = max(set(counts), key=counts.count)
            kept = sorted(us for k, us in per_call if k == n)
            if len(kept) >= calls // 2:
                return kept[len(kept) // 2] / 1e3
    raise RuntimeError("read_flush_ms: calls not traced whole")


def flush_kinds(torch, cs, records):
    """K8 and SDPA on the serving step and the long cache, and K1 with a
    per-client α against addcmul, timed after a write flush
    (`chip_smoke.device_ms`) and after a read flush, in turns."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.meta_update import fused
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for (B, C, Kv, G, hd) in ((1, 64, 5, 3, 64), (1, 32768, 5, 3, 64)):
        q = torch.randn((B, Kv * G, hd), device="cuda",
                        generator=gen).bfloat16()
        kc, vc = (torch.randn((B, C, Kv, hd), device="cuda",
                              generator=gen).bfloat16() for _ in range(2))
        qt = q[:, :, None]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
        tag = f"B={B} C={C} Kv={Kv} G={G} hd={hd} bf16"
        cases.append((f"K8 {tag}", lambda q=q, kc=kc, vc=vc, C=C:
                      dec_ops.decode_attention(q, kc, vc, C)))
        cases.append((f"SDPA {tag}", lambda qt=qt, kt=kt, vt=vt:
                      F.scaled_dot_product_attention(qt, kt, vt,
                                                     enable_gqa=True)))
    N = plane_size(torch)
    theta = torch.randn((4, N), device="cuda", generator=gen)
    g = torch.randn((4, N), device="cuda", generator=gen)
    alpha = torch.rand((4, N), device="cuda", generator=gen) * 0.1
    cases.append(("K1 C=4 per_client", lambda: fused.inner_update_plane(
        theta, alpha, g)))
    cases.append(("addcmul C=4 per_client", lambda: torch.addcmul(
        theta, alpha, g, value=-1.0)))
    for name, fn in cases:
        runs = {"write": [], "read": []}
        for i in range(4):
            order = ["write", "read"] if i % 2 == 0 else ["read", "write"]
            for kind in order:
                runs[kind].append(cs.device_ms(fn, torch) if kind == "write"
                                  else read_flush_ms(torch, cs, fn))
        emit(records, {"step": "flush_kind", "case": name,
                       "write_flush_device_ms": sorted(runs["write"])[1:3],
                       "read_flush_device_ms": sorted(runs["read"])[1:3]})
    del theta, g, alpha
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="tree holding the previous csrc/")
    ap.add_argument("--alt", action="append", default=[],
                    help="with the k8_parent step: another tree whose K8 "
                         "is timed against this one's (repeatable)")
    ap.add_argument("--out", help="also write every record here (JSON)")
    ap.add_argument("--steps",
                    default="checks,k1_variants,k8_phases,k8_layout,"
                            "flush_kinds",
                    help="comma-separated steps to run after the build")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"ok": False, "error": "no CUDA device"}))
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    records = []
    emit(records, {"step": "device", "nvidia_smi": cs.nvidia_smi(),
                   "torch": torch.__version__})
    ptxas_report(records)
    t0 = time.perf_counter()
    from repro_torch.kernels import _build
    _build.get_ext()
    emit(records, {"step": "build", "s": time.perf_counter() - t0})
    steps = args.steps.split(",")
    n_plane = None
    if "checks" in steps:
        n_plane = smoke_checks(torch, cs, records)
    if "k8_checks" in steps:
        k8_checks(torch, cs, records)
    if "k1_variants" in steps or (args.parent and "k8_parent" not in steps):
        n_plane = n_plane or plane_size(torch)
    if "k1_variants" in steps:
        k1_variants(torch, cs, n_plane, records)
    if "k8_phases" in steps:
        k8_phases(torch, cs, records)
    if "k8_layout" in steps:
        k8_layout(torch, cs, records)
    if "flush_kinds" in steps:
        flush_kinds(torch, cs, records)
    if "k8_parent" in steps:
        parent_k8(torch, cs, ([args.parent] if args.parent else [])
                  + args.alt, records)
    elif args.parent:
        parent_kernels(torch, cs, n_plane, args.parent, records)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
