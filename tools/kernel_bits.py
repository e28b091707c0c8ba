#!/usr/bin/env python3
"""Output bits of K7, K8 and K9 at every shape class the kernels took
before the nemotron-4-340b instantiations (K7 `<192, 192>`, K8 at kG =
12 and kHD = 192) and K9's grid on x were added, for holding two trees'
kernels against each other on one card. The 32 bf16 K8 cases at hd 96
and 128 (`K8_REDESIGNED`) ran the CUDA-core `flash_decode_kernel` when
`kernel_bits_parent.json` was written and run the tensor-core
`flash_decode_wide_kernel` since: their bits moved by design, and
`chip_smoke.check_parent_bits` counts them without holding them.

    python3 tools/kernel_bits.py --src DIR --out FILE.json
    python3 tools/kernel_bits.py --compare PARENT.json CHANGE.json

``--src`` is the ``src`` directory of a checkout (this one's, or a
parent commit unpacked with ``git archive`` into a gitignored directory
such as ``build/parent``); its kernels are built into that checkout's
own ``build/torch_ext``. Each case draws its inputs from a seeded numpy
stream on the host, so both trees see the same bytes, runs the kernel
through the port's public wrapper on the card and records the sha256 of
the output's bytes (NaN-safe), its shape and dtype. ``--compare``
prints each case's verdict as one JSON object and exits 1 if any case
differs or is missing.

The cases: K7 `<64, 64>`, `<128, 128>` and `<192, 128>` in bf16 (causal,
window, q_offset, G up to 8, element staging of odd strides, a ragged
tile) and its f32 kernel (hd_v <= 128 and <= 192); K8 at every G from 1
to 8 and every head dim bucket (bf16: 32, 64 on `flash_decode_mma_kernel`,
96, 128 on `flash_decode_wide_kernel<128>`; f32: 16, 32, 64, 128) over
one split with ragged lengths and a row
of kv_length 0 and over several splits with a Python-int length; K9 at
the shapes `chip_smoke.py`'s `check_k9` runs (Mamba2-370M's prefill,
adaptation, round and served prefills, an odd chunk, the overflow
input), hp 128 and Q < 64.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys

import numpy as np

# (B, H, Kv, Lq, Lk, hd, hd_v, dtype, causal, window, q_offset)
K7_CASES = (
    (2, 15, 5, 100, 100, 64, 64, "bfloat16", True, None, 0),
    (2, 15, 5, 64, 64, 64, 64, "bfloat16", True, 16, 0),
    (2, 6, 2, 50, 50, 40, 24, "bfloat16", True, None, 0),
    (2, 6, 2, 100, 103, 64, 32, "bfloat16", True, None, 3),
    (3, 15, 5, 1, 1, 64, 64, "bfloat16", True, None, 0),
    (2, 8, 8, 40, 40, 128, 128, "bfloat16", False, None, 0),
    (2, 8, 1, 70, 75, 128, 64, "bfloat16", True, 20, 5),
    (1, 28, 4, 300, 300, 128, 128, "bfloat16", True, None, 0),
    (1, 48, 8, 300, 300, 128, 128, "bfloat16", True, 128, 0),
    (2, 8, 8, 130, 130, 192, 128, "bfloat16", False, None, 0),
    (1, 16, 16, 257, 257, 192, 128, "bfloat16", True, None, 0),
    (2, 6, 2, 100, 103, 64, 32, "float32", True, None, 3),
    (4, 2, 1, 16, 16, 32, 32, "float32", True, None, 0),
    (2, 4, 2, 100, 103, 192, 128, "float32", True, 20, 3),
    (2, 4, 2, 50, 50, 192, 192, "float32", True, None, 0),
)
# K8: (dtype, head dims) over G = 1..8, each at two cache shapes
K8_DIMS = (("bfloat16", (32, 64, 96, 128)), ("float32", (16, 32, 64, 128)))
K8_SHAPES = ((3, 100, 2, "ragged0"), (1, 4096, 2, "int"))   # B, C, Kv
# the bf16 cases whose kernel was redesigned: hd 96 and 128, G 1..8
K8_REDESIGNED = tuple(
    f"K8 B={B} C={C} Kv={Kv} G={G} hd={hd} bfloat16 kv_length={lengths}"
    for hd in (96, 128) for G in range(1, 9)
    for B, C, Kv, lengths in K8_SHAPES)
# K9: (B, nh, L, hp, N, chunk, dt_scale)
K9_CASES = (
    (4, 32, 1024, 64, 128, 128, 1.0),
    (2, 32, 128, 64, 128, 128, 1.0),
    (16, 32, 256, 64, 128, 128, 1.0),
    (2, 32, 200, 64, 128, 100, 1.0),
    (1, 32, 256, 64, 128, 128, 30.0),
    (1, 4, 256, 128, 64, 64, 1.0),
    (2, 3, 74, 8, 16, 37, 1.0),
)


def toolchain(torch) -> dict:
    """What a digest depends on besides the source: the torch and CUDA
    versions, the nvcc that builds the kernels, the card."""
    from torch.utils.cpp_extension import CUDA_HOME
    try:
        nvcc = subprocess.run([f"{CUDA_HOME}/bin/nvcc", "--version"],
                              capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, TypeError, IndexError, subprocess.SubprocessError):
        nvcc = None
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "device": torch.cuda.get_device_name(0)}


def digest(t) -> dict:
    import torch
    a = t.detach().contiguous().cpu()
    raw = a.reshape(-1).view(torch.uint8).numpy().tobytes()
    return {"sha256": hashlib.sha256(raw).hexdigest(),
            "shape": list(a.shape), "dtype": str(a.dtype)}


def k7_cases(torch):
    from repro_torch.kernels.attention import ops as attn_ops
    for i, (B, H, Kv, Lq, Lk, hd, hdv, dt, causal, window, qoff) in \
            enumerate(K7_CASES):
        rng = np.random.RandomState(100 + i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                   .to("cuda", dtype)
                   for s in ((B, Lq, H, hd), (B, Lk, Kv, hd),
                             (B, Lk, Kv, hdv)))
        out = attn_ops.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=qoff, impl="cuda")
        yield (f"K7 B={B} H={H} Kv={Kv} Lq={Lq} Lk={Lk} hd={hd} hd_v={hdv} "
               f"{dt} causal={causal} window={window} q_offset={qoff}"), out


def k8_cases(torch):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    n = 0
    for dt, dims in K8_DIMS:
        dtype = getattr(torch, dt)
        for hd in dims:
            for G in range(1, 9):
                for B, C, Kv, lengths in K8_SHAPES:
                    rng = np.random.RandomState(200 + n)
                    n += 1
                    q, kc, vc = (torch.from_numpy(
                        rng.randn(*s).astype(np.float32)).to("cuda", dtype)
                        for s in ((B, Kv * G, hd), (B, C, Kv, hd),
                                  (B, C, Kv, hd)))
                    if lengths == "int":
                        kvl = C - 96
                    else:
                        kvl = torch.from_numpy(rng.randint(
                            1, C + 1, B).astype(np.int32)).cuda()
                        kvl[0] = 0
                    out = dec_ops.decode_attention(q, kc, vc, kvl,
                                                   impl="cuda")
                    yield (f"K8 B={B} C={C} Kv={Kv} G={G} hd={hd} {dt} "
                           f"kv_length={lengths}"), out


def k9_cases(torch):
    from repro_torch.kernels.ssd import ssd_scan
    for i, (B, nh, L, hp, N, Q, dt_scale) in enumerate(K9_CASES):
        rng = np.random.RandomState(300 + i)
        f = lambda *s: torch.from_numpy(                  # noqa: E731
            rng.randn(*s).astype(np.float32)).cuda()
        x, dt, A = f(B, L, nh, hp), f(B, L, nh), f(nh)
        dt = torch.nn.functional.softplus(dt * 0.5 - 1.0) * dt_scale
        A = -torch.exp(A * 0.3)
        Bm, Cm = f(B, L, N), f(B, L, N)
        xdt = (x * dt[..., None]).transpose(1, 2)
        a = (dt * A[None, None, :]).transpose(1, 2)
        with torch.no_grad():
            y, S = ssd_scan.ssd_intra_chunk(xdt, a, Bm, Cm, chunk=Q)
        name = f"K9 B={B} nh={nh} L={L} hp={hp} N={N} Q={Q} dt×{dt_scale}"
        yield name + " y", y
        yield name + " S", S


def digests(torch) -> dict:
    """Every case's output digest, on this process's kernels."""
    cases = {}
    for gen in (k7_cases, k8_cases, k9_cases):
        for name, t in gen(torch):
            torch.cuda.synchronize()
            cases[name] = digest(t)
    return cases


def run(src: str, out: str) -> int:
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import flash_attention as k7
    from repro_torch.kernels.decode_attention import flash_decode as k8
    from repro_torch.kernels.ssd import ssd_scan as k9
    _build.get_ext()
    before = (k7.launches, k8.launches, k9.launches)
    cases = digests(torch)
    launched = [a - b for a, b in zip((k7.launches, k8.launches,
                                       k9.launches), before)]
    rec = {**toolchain(torch), "src": src,
           "launches": {"K7": launched[0], "K8": launched[1],
                        "K9": launched[2]},
           "cases": cases}
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({"cases": len(cases), "launches": rec["launches"],
                      "out": out}))
    return 0


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as fh:
        a = json.load(fh)
    with open(b_path) as fh:
        b = json.load(fh)
    names = sorted(set(a["cases"]) | set(b["cases"]))
    differ = [n for n in names if a["cases"].get(n) != b["cases"].get(n)]
    print(json.dumps({"compared": len(names), "equal": len(names) - len(differ),
                      "differ": differ, "launches": [a["launches"],
                                                     b["launches"]]}))
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("PARENT", "CHANGE"))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    return run(args.src, args.out)


if __name__ == "__main__":
    sys.exit(main())
