"""Shared model primitives: init helpers, RMSNorm, MLPs, rotary
embeddings. Counterpart of `repro/models/layers.py`; params are nested
dicts of tensors with the reference's keys and shapes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name ("bfloat16")."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


class Rng:
    """Splitting helper over a `torch.Generator`, so init code does not
    thread generators by hand. The parent stream lives on the CPU, so the
    sequence of child seeds depends only on the seed; each child is a
    fresh generator on ``device`` (the draws themselves differ between
    CPU and CUDA generators, and from `jax.random`)."""

    def __init__(self, key: int, device="cuda"):
        self._gen = torch.Generator(device="cpu")
        self._gen.manual_seed(int(key))
        self.device = torch.device(device)

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    def next(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.next_seed())
        return g


def dense_init(rng: Rng, d_in: int, d_out: int, dtype, scale: float | None = None):
    """Truncated-normal (±2σ) fan-in init scaled by 1/√d_in, stored in
    `dtype`."""
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=rng.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=rng.next())
    return (w * scale).to(as_dtype(dtype))


def embed_init(rng: Rng, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), dtype=torch.float32, device=rng.device,
                    generator=rng.next()) * 0.02
    return w.to(as_dtype(dtype))


# ---------------------------------------------------------------- norms

def rmsnorm_init(d: int, dtype, device="cuda"):
    return {"scale": torch.ones((d,), dtype=as_dtype(dtype), device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """RMSNorm in f32, cast back to x's dtype (`layers.py:44-48`)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------- MLPs

def _check_act(act: str):
    if act != "swiglu":
        raise NotImplementedError(f"mlp_act {act!r} is not ported yet; it "
                                  "joins with the granite / nemotron slice")


def mlp_init(rng: Rng, d: int, d_ff: int, act: str, dtype):
    _check_act(act)
    return {"w_down": dense_init(rng, d_ff, d, dtype),
            "w_gate": dense_init(rng, d, d_ff, dtype),
            "w_up": dense_init(rng, d, d_ff, dtype)}


def mlp_apply(params, x, act: str):
    """SwiGLU MLP: (silu(x W_gate) * x W_up) W_down."""
    _check_act(act)
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------- rotary

def rope_frequencies(head_dim: int, theta: float):
    """Inverse frequencies for half the head dim (numpy, as the
    reference computes them)."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


_INV_FREQ: dict = {}


def _inv_freq(hd: int, theta: float, device) -> torch.Tensor:
    """`rope_frequencies` on `device`, copied there once: a copy from
    pageable host memory on every layer would stall the host on the
    card's queue."""
    key = (hd, float(theta), str(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = torch.as_tensor(rope_frequencies(hd, theta),
                                               device=device)
    return inv


def apply_rope(x, positions, theta: float):
    """Standard RoPE. x: (..., L, H, hd); positions: (..., L) int."""
    hd = x.shape[-1]
    inv = _inv_freq(hd, theta, x.device)
    ang = positions[..., None].float() * inv             # (..., L, hd/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., L, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
