"""Shared model primitives: init helpers, RMSNorm, MLPs, rotary
embeddings (M-RoPE included). Counterpart of `repro/models/layers.py`;
params are nested dicts of tensors with the reference's keys and shapes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.dtensor import hidden_layout


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

    def next(self) -> torch.Generator | None:
        """The next child generator; None on the meta device, whose
        tensors hold shapes only (the dry run's parameters)."""
        if self.device.type == "meta":
            self.next_seed()
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(self.next_seed())
        return g


def dense_init(rng: Rng, d_in: int, d_out: int, dtype, scale: float | None = None):
    """Truncated-normal (±2σ) fan-in init scaled by 1/√d_in, stored in
    `dtype`. The f32 draw is scaled in place (the same product, one f32
    buffer fewer: nemotron's 256,000-wide head draws 18.9 GB)."""
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=rng.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=rng.next())
    return w.mul_(scale).to(as_dtype(dtype))


def embed_init(rng: Rng, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), dtype=torch.float32, device=rng.device,
                    generator=rng.next()).mul_(0.02)
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

def mlp_init(rng: Rng, d: int, d_ff: int, act: str, dtype):
    """SwiGLU has a gate; relu2 and gelu have only w_up and w_down
    (`repro/models/layers.py:53-60`, in the reference's draw order)."""
    p = {"w_down": dense_init(rng, d_ff, d, dtype)}
    if act == "swiglu":
        p["w_gate"] = dense_init(rng, d, d_ff, dtype)
    p["w_up"] = dense_init(rng, d, d_ff, dtype)
    return p


def mlp_apply(params, x, act: str):
    """swiglu: (silu(x W_gate) * x W_up) W_down; relu2 (nemotron):
    relu(x W_up)² W_down; gelu: gelu(x W_up) W_down with the tanh
    approximation, `jax.nn.gelu`'s default."""
    def up(name):
        # on a mesh each projection takes the tensor-parallel layout
        return hidden_layout(x @ params[name])

    if act == "swiglu":
        h = F.silu(up("w_gate")) * up("w_up")
    elif act == "relu2":
        h = torch.square(F.relu(up("w_up")))
    elif act == "gelu":
        h = F.gelu(up("w_up"), approximate="tanh")
    else:
        raise ValueError(f"unknown act {act}")
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
        inv = torch.as_tensor(rope_frequencies(hd, theta), device=device)
        if type(inv) is torch.Tensor:    # not a dry run's fake tensor
            _INV_FREQ[key] = inv
    return inv


def _rotate(x, ang):
    """x (..., L, H, hd) rotated by the angles ang (..., L, hd/2), in f32,
    cast back to x's dtype."""
    cos = torch.cos(ang)[..., None, :]                   # (..., L, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Standard RoPE. x: (..., L, H, hd); positions: (..., L) int."""
    inv = _inv_freq(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * inv)


_MROPE_COMP: dict = {}


def _mrope_components(sections: tuple, device) -> torch.Tensor:
    """Which position component (0 = t, 1 = h, 2 = w) drives each rotary
    dim, on `device`, copied there once (as `_inv_freq`)."""
    key = (sections, str(device))
    comp = _MROPE_COMP.get(key)
    if comp is None:
        comp = torch.as_tensor(np.concatenate(
            [np.full(s, i) for i, s in enumerate(sections)]), device=device)
        if type(comp) is torch.Tensor:   # not a dry run's fake tensor
            _MROPE_COMP[key] = comp
    return comp


def apply_mrope(x, positions3, theta: float, sections):
    """M-RoPE (Qwen2-VL): the rotary dims split into (t, h, w) sections,
    each driven by its own position component, in f32 as `apply_rope`.

    x: (..., L, H, hd); positions3: (..., L, 3) int; sections sum to
    hd/2."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    pos = positions3.float().index_select(
        -1, _mrope_components(tuple(sections), x.device))  # (..., L, half)
    return _rotate(x, pos * _inv_freq(hd, theta, x.device))


def text_mrope_positions(positions):
    """Text tokens take identical (t, h, w) components."""
    return torch.stack([positions, positions, positions], dim=-1)
