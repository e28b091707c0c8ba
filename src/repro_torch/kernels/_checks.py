"""What each binding of `kernels/csrc/bindings.cpp` refuses, checked in
Python before the extension is reached.

A ``TORCH_CHECK`` that fails inside the extension ends the process on
the card instead of raising (`tools/probe_refusals.py`), so each
wrapper calls the function here named after its binding on the very
arguments it is about to pass, right before ``get_ext()``. Each
function repeats its binding's checks in the binding's order and raises
`Refused` at the first that fails: nothing is launched and nothing
falls back to the plain version. The C++ checks stay as a second guard.

The binding's "must be a CUDA tensor" is checked here as "on the device
of the first operand": the wrappers send CPU tensors to the plain
versions before they get here, and the CPU tests drive these checks
with CPU tensors.
"""
from __future__ import annotations

import torch

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


class Refused(ValueError, TypeError):
    """A kernel call its binding would refuse. A ValueError, and a
    TypeError too, which the wrappers raised for a wrong dtype before
    these checks existed."""


def _require(ok, binding: str, msg: str):
    if not ok:
        raise Refused(f"{binding} refuses the call: {msg}")


def _same_device(binding: str, *named):
    dev = named[0][1].device
    for name, t in named:
        _require(t.device == dev, binding,
                 f"{name} on {t.device}, not on {dev} with the others")


def _aligned16(binding: str, t, name: str):
    _require(t.data_ptr() % 16 == 0, binding, f"{name} must be 16-byte "
             "aligned")


def inner_update(theta, out, alpha, g):
    """K1 (and K4): theta, out, g (C, N) float32 contiguous; alpha empty,
    (N,) or (C, N) float32."""
    b = "inner_update"
    _same_device(b, ("theta", theta), ("out", out), ("g", g))
    _require(theta.dim() == 2, b, "theta must be (C, N)")
    _require(all(t.dtype == torch.float32 for t in (theta, g, out)), b,
             f"theta, g and out must be float32, got {theta.dtype}, "
             f"{g.dtype}, {out.dtype}")
    _require(all(t.is_contiguous() for t in (theta, g, out)), b,
             "theta, g and out must be contiguous")
    _require(g.shape == theta.shape and out.shape == theta.shape, b,
             "g and out must match theta's shape")
    C, N = theta.shape
    _require(N % 4 == 0, b, "N must be a multiple of 4")
    _require(C <= 65535, b, "at most 65535 client rows")
    for name, t in (("theta", theta), ("g", g), ("out", out)):
        _aligned16(b, t, name)
    if alpha.numel() > 0:
        _same_device(b, ("theta", theta), ("alpha", alpha))
        _require(alpha.dtype == torch.float32 and alpha.is_contiguous(), b,
                 "alpha must be contiguous float32")
        _aligned16(b, alpha, "alpha")
        if alpha.dim() == 1:
            _require(alpha.shape[0] == N, b, "shared alpha must be (N,)")
        else:
            _require(alpha.shape == theta.shape, b, "alpha must be (C, N)")


# head dims K7 takes: (largest qk dim, largest value dim)
HEAD_DIMS = {torch.bfloat16: (192, 192), torch.float32: (192, 192)}


def flash_attention(q, k, v, o, window):
    """K7: q (B, H, Lq, hd), k (B, Kv, Lk, hd), v (B, Kv, Lk, hd_v), o
    (B, H, Lq, hd_v) of one dtype, any strides; `HEAD_DIMS`."""
    b = "flash_attention"
    _same_device(b, ("q", q), ("k", k), ("v", v), ("o", o))
    _require(all(t.dim() == 4 for t in (q, k, v, o)), b,
             "q, k, v, o must be 4-D")
    _require(q.dtype in HEAD_DIMS, b,
             f"K7 takes float32 or bfloat16, got {q.dtype}")
    _require(all(t.dtype == q.dtype for t in (k, v, o)), b,
             f"q, k, v, o must share a dtype, got {q.dtype}, {k.dtype}, "
             f"{v.dtype}, {o.dtype}")
    B, H, Lq, hd = q.shape
    Kv, Lk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    _require(k.shape[0] == B and v.shape[0] == B and v.shape[1] == Kv
             and v.shape[2] == Lk and k.shape[3] == hd, b,
             "k, v shapes do not match q")
    _require(Kv > 0 and H % Kv == 0, b,
             "num heads must be a multiple of kv heads")
    _require(tuple(o.shape) == (B, H, Lq, hd_v), b,
             "o must be (B, H, Lq, hd_v)")
    most = HEAD_DIMS[q.dtype]
    _require(hd <= most[0] and hd_v <= most[1], b,
             f"K7 takes hd and hd_v <= {most[0]}, bfloat16 or float32; "
             f"got {q.dtype}, hd {hd}, hd_v {hd_v}")
    _require(B <= 65535 and H <= 65535, b, "B and H up to 65535")
    _require(window is None or window > 0, b,
             f"window must be positive, got {window}")


# K8's widest kernels: 12 query heads a kv head (Nemotron-4's 96 over 8),
# head dim 192
DECODE_MAX_G, DECODE_MAX_HD = 12, 192


def flash_decode(q, k_cache, v_cache, kvl, kvl_s, o, scratch, splits):
    """K8: q, o contiguous (B, H, hd); caches (B, C, Kv, hd) with a
    contiguous head dim and 16-byte rows; G = H / Kv <= `DECODE_MAX_G`,
    hd <= `DECODE_MAX_HD` (a multiple of 24 above 128); kvl None or (B,)
    int32; splits in [1, 512], scratch for splits > 1."""
    b = "flash_decode"
    _same_device(b, ("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                 ("o", o))
    _require(q.dtype in (torch.float32, torch.bfloat16), b,
             f"K8 takes float32 or bfloat16, got {q.dtype}")
    _require(all(t.dtype == q.dtype for t in (k_cache, v_cache, o)), b,
             "q, caches and o must share a dtype")
    _require(q.dim() == 3 and q.is_contiguous() and o.is_contiguous()
             and o.shape == q.shape, b,
             "q and o must be contiguous (B, H, hd)")
    _aligned16(b, q, "q")
    _require(k_cache.dim() == 4 and v_cache.shape == k_cache.shape, b,
             "caches must be (B, C, Kv, hd)")
    B, H, hd = q.shape
    C, Kv = k_cache.shape[1], k_cache.shape[2]
    _require(C >= 1, b, "the cache must hold at least one slot")
    _require(k_cache.shape[0] == B and k_cache.shape[3] == hd, b,
             "cache shape does not match q")
    _require(Kv > 0 and H % Kv == 0, b,
             "num heads must be a multiple of kv heads")
    G = H // Kv
    _require(G <= DECODE_MAX_G and hd <= DECODE_MAX_HD, b,
             f"at most {DECODE_MAX_G} query heads per kv head, hd <= "
             f"{DECODE_MAX_HD}; got G {G}, hd {hd}")
    _require(hd <= 128 or hd % 24 == 0, b,
             f"hd above 128 must be a multiple of 24, got {hd}")
    vec = 16 // q.element_size()
    _require(hd % vec == 0, b, f"hd must be a multiple of {vec}")
    if kvl is not None:
        _same_device(b, ("q", q), ("kv_length", kvl))
        _require(kvl.dtype == torch.int32 and kvl.is_contiguous()
                 and kvl.numel() == B, b, "kv_length must be (B,) int32")
    _require(1 <= splits <= 512, b, f"splits must be in [1, 512], got "
             f"{splits}")
    if splits > 1:
        _same_device(b, ("q", q), ("scratch", scratch))
        _require(scratch.dtype == torch.float32 and scratch.is_contiguous()
                 and scratch.numel() >= B * Kv * splits * G * (hd + 2), b,
                 "scratch must be contiguous float32 of B * Kv * splits * "
                 "G * (hd + 2) elements")
        _aligned16(b, scratch, "scratch")
    for t in (k_cache, v_cache):
        _require(t.stride(3) == 1, b, "cache head dim must be contiguous")
        _aligned16(b, t, "cache")
        _require(all(t.stride(d) % vec == 0 for d in range(3)), b,
                 "cache rows must be 16-byte aligned")
    _require(B <= 65535 and Kv <= 65535, b, "B and Kv up to 65535")
    _require(INT32_MIN <= kvl_s <= INT32_MAX, b,
             "kv_length out of the int32 range")


def weighted_aggregate(G, w, out):
    """K2: G (m, N) float32, bfloat16 or int8, contiguous; w (m,) and out
    (N,) float32."""
    b = "weighted_aggregate"
    _same_device(b, ("G", G), ("w", w), ("out", out))
    _require(G.dim() == 2 and G.is_contiguous(), b,
             "G must be contiguous (m, N)")
    _require(G.dtype in (torch.float32, torch.bfloat16, torch.int8), b,
             f"G must be float32, bfloat16 or int8, got {G.dtype}")
    m, N = G.shape
    _require(1 <= m <= 12288, b, "1 <= m <= 12288 client rows")
    _require(N % 4 == 0, b, "N must be a multiple of 4")
    _require(w.dtype == torch.float32 and w.is_contiguous() and w.dim() == 1
             and w.shape[0] == m, b, "w must be contiguous (m,) float32")
    _require(out.dtype == torch.float32 and out.is_contiguous()
             and out.dim() == 1 and out.shape[0] == N, b,
             "out must be contiguous (N,) float32")
    _aligned16(b, G, "G")
    _aligned16(b, out, "out")


def adam_flat(p, g, m, v, scales):
    """K3: p, g (N,) float32; m, v (N,) float32 or bfloat16; scales (2,)
    float32; all contiguous."""
    b = "adam_flat"
    _same_device(b, ("phi", p), ("g", g), ("m", m), ("v", v),
                 ("scales", scales))
    _require(p.dtype == torch.float32 and g.dtype == torch.float32, b,
             f"phi and g must be float32, got {p.dtype}, {g.dtype}")
    _require(m.dtype == v.dtype and m.dtype in (torch.float32,
                                                torch.bfloat16), b,
             "m and v must share a dtype, float32 or bfloat16")
    N = p.numel()
    for name, t in (("phi", p), ("g", g), ("m", m), ("v", v)):
        _require(t.dim() == 1 and t.numel() == N and t.is_contiguous(), b,
                 "phi, g, m, v must be contiguous (N,)")
        _aligned16(b, t, name)
    _require(N % 4 == 0, b, "N must be a multiple of 4")
    _require(scales.dtype == torch.float32 and scales.numel() == 2
             and scales.is_contiguous(), b,
             "scales must be contiguous (2,) float32")


def int8_encode(G, scales, q, resid):
    """K6: G, resid (m, N) float32, q (m, N) int8, scales (m,) float32;
    all contiguous."""
    b = "int8_encode"
    _same_device(b, ("G", G), ("scales", scales), ("q", q),
                 ("resid", resid))
    _require(G.dim() == 2 and G.is_contiguous()
             and G.dtype == torch.float32, b,
             "G must be contiguous (m, N) float32")
    m, N = G.shape
    _require(1 <= m <= 65535, b, "1 <= m <= 65535 client rows")
    _require(N % 4 == 0, b, "N must be a multiple of 4")
    _require(scales.dtype == torch.float32 and scales.dim() == 1
             and scales.shape[0] == m and scales.is_contiguous(), b,
             "scales must be contiguous (m,) float32")
    _require(q.dtype == torch.int8 and q.shape == G.shape
             and q.is_contiguous(), b, "q must be contiguous (m, N) int8")
    _require(resid.dtype == torch.float32 and resid.shape == G.shape
             and resid.is_contiguous(), b,
             "resid must be contiguous (m, N) float32")
    _aligned16(b, G, "G")
    _aligned16(b, resid, "resid")
    _require(q.data_ptr() % 4 == 0, b, "q must be 4-byte aligned")


def trimmed_mean(G, live, out, trim):
    """K5: G (m, N) float32 or bfloat16, contiguous; live (m,) and out
    (N,) float32; 0 <= 2 trim < m."""
    b = "trimmed_mean"
    _same_device(b, ("G", G), ("live", live), ("out", out))
    _require(G.dim() == 2 and G.is_contiguous(), b,
             "G must be contiguous (m, N)")
    _require(G.dtype in (torch.float32, torch.bfloat16), b,
             f"the trimmed-mean kernel takes float32 or bfloat16, got "
             f"{G.dtype}")
    m, N = G.shape
    _require(1 <= m <= 49152, b, "1 <= m <= 49152 client rows")
    _require(0 <= 2 * trim < m, b, f"the trimmed mean needs 0 <= 2·trim "
             f"< m, got trim={trim}, m={m}")
    _require(N % 4 == 0, b, "N must be a multiple of 4")
    _require(live.dtype == torch.float32 and live.is_contiguous()
             and live.dim() == 1 and live.shape[0] == m, b,
             "live must be contiguous (m,) float32")
    _require(out.dtype == torch.float32 and out.is_contiguous()
             and out.dim() == 1 and out.shape[0] == N, b,
             "out must be contiguous (N,) float32")
    _aligned16(b, G, "G")
    _aligned16(b, out, "out")


def ssd_chunk(xdt, a, Bm, Cm, y, S, cbuf, chunk):
    """K9: xdt, y (B, nh, L, hp); a (B, nh, L); Bm, Cm (B, L, N); all
    float32, any strides; S contiguous (B, nh, L / chunk, N, hp); cbuf
    the contiguous C Bᵀ scratch; B <= 65535, and each kernel's blocks a
    batch row (grid x) up to 2^31 - 1."""
    b = "ssd_chunk"
    named = (("xdt", xdt), ("a", a), ("Bm", Bm), ("Cm", Cm), ("y", y),
             ("S", S), ("cbuf", cbuf))
    _same_device(b, *named)
    for name, t in named:
        _require(t.dtype == torch.float32, b,
                 f"ssd_chunk operands must be float32, got {t.dtype} for "
                 f"{name}")
    _require(xdt.dim() == 4 and a.dim() == 3 and Bm.dim() == 3
             and Cm.dim() == 3 and y.dim() == 4 and S.dim() == 5, b,
             "xdt, y (B, nh, L, hp); a (B, nh, L); Bm, Cm (B, L, N); S 5-D")
    B, nh, L, hp = xdt.shape
    N = Bm.shape[2]
    _require(1 <= chunk <= 128, b, f"chunk must be in [1, 128], got {chunk}")
    _require(1 <= N <= 128 and 1 <= hp <= 128, b,
             f"state N and head dim hp must be in [1, 128], got {N} and "
             f"{hp}")
    _require(L % chunk == 0, b, f"L ({L}) must be a multiple of chunk "
             f"({chunk})")
    _require(tuple(a.shape) == (B, nh, L), b, "a must be (B, nh, L)")
    _require(Bm.shape[0] == B and Bm.shape[1] == L and Cm.shape == Bm.shape,
             b, "Bm and Cm must be (B, L, N)")
    _require(y.shape == xdt.shape, b, "y must be (B, nh, L, hp)")
    _require(S.is_contiguous() and tuple(S.shape) == (B, nh, L // chunk, N,
                                                      hp), b,
             "S must be contiguous (B, nh, L / chunk, N, hp)")
    T, nc = (chunk + 63) // 64, L // chunk
    _require(B <= 65535 and T * nc * nh <= INT32_MAX
             and nc * (T * (T + 1) // 2 + (N + 63) // 64 * nh) <= INT32_MAX,
             b, "B up to 65535, and each kernel's blocks a batch row up to "
             "2^31 - 1")
    _require(cbuf.is_contiguous() and tuple(cbuf.shape) == (
        B, L // chunk, chunk, (chunk + 3) // 4 * 4), b,
        "cbuf must be contiguous (B, L / chunk, chunk, chunk rounded up "
        "to a multiple of 4)")
    _aligned16(b, cbuf, "cbuf")
