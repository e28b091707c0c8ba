"""K7: flash-attention forward as a CUDA kernel
(`kernels/csrc/flash_attention.cu`).

Counterpart of `repro/kernels/attention/flash_attention.py`
`flash_attention_bhld`: q (B, H, Lq, hd) × k (B, Kv, Lk, hd) ×
v (B, Kv, Lk, hd_v) -> (B, H, Lq, hd_v), GQA by h // G, causal and
sliding-window masks from absolute positions with ``q_offset``, f32
math, output in q's dtype. The kernel reads every operand through its
strides, so `ops.flash_attention` hands it transposed views of the
models' (B, L, H, hd) tensors and gets back a view over a
(B, Lq, H, hd_v) buffer: no transpose copies either way.

The reference kernel has no VJP and the reference never differentiates
through it. The port's serving adaptation does (its forward runs
attention), so the kernel sits in an ``autograd.Function`` whose
backward recomputes attention with the plain version under autograd;
a backward kernel belongs to the training slice.

On a CPU tensor the wrapper runs the plain version (`ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.attention import ref

launches = 0   # kernel launches; only `_launch` adds to it


def _plain_bhld(q, k, v, causal, window, q_offset):
    out = ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            q_offset=q_offset)
    return out.transpose(1, 2)


def _launch(q, k, v, causal, window, q_offset):
    global launches
    B, H, Lq, hd = q.shape
    hd_v = v.shape[-1]
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    # (B, Lq, H, hd_v) storage, viewed as (B, H, Lq, hd_v)
    out = torch.empty((B, Lq, H, hd_v), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    get_ext().flash_attention(q, k, v, out, bool(causal),
                              0 if window is None else int(window),
                              int(q_offset), 1.0 / (hd ** 0.5))
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward by recomputation with the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, q_offset)
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, ct):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = _plain_bhld(qd, kd, vd, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), ct)
        return dq, dk, dv, None, None, None


def flash_attention_bhld(q, k, v, *, causal: bool = True, window=None,
                         q_offset: int = 0):
    """q: (B, H, Lq, hd); k: (B, Kv, Lk, hd); v: (B, Kv, Lk, hd_v), any
    strides. Returns (B, H, Lq, hd_v) — hd_v may differ from hd."""
    if not q.is_cuda:
        return _plain_bhld(q, k, v, causal, window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal, window, q_offset)
