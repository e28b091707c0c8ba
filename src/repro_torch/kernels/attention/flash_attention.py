"""K7: flash-attention forward as a CUDA kernel
(`kernels/csrc/flash_attention.cu`).

Counterpart of `repro/kernels/attention/flash_attention.py`
`flash_attention_bhld`: q (B, H, Lq, hd) × k (B, Kv, Lk, hd) ×
v (B, Kv, Lk, hd_v) -> (B, H, Lq, hd_v), GQA by h // G, causal and
sliding-window masks from absolute positions with ``q_offset``, f32
math, output in q's dtype (bf16 on the tensor cores, f32 on the CUDA
cores: the C++ launcher picks by dtype). The kernel reads every operand
through its strides, so `ops.flash_attention` hands it transposed views
of the models' (B, L, H, hd) tensors and gets back a view over a
(B, Lq, H, hd_v) buffer: no transpose copies either way.

The reference kernel has no VJP and the reference never differentiates
through it. The port's adaptation and training do (its forward runs
attention), so the kernel sits in an ``autograd.Function`` whose
backward recomputes attention with the plain version under autograd
(`kernels/_recompute.py`). That backward is itself differentiable, so
MAML's and Meta-SGD's second-order terms reach through it.

Every launch on the card goes through that Function, with or without a
gradient, so K7 is reachable under `torch.func.vmap`: its ``vmap`` rule
folds the request axis into the batch axis (`kernels/_vmap.py`) and
launches once for the whole group, as Pallas batches the reference's
`pallas_call` under `jax.vmap` (the serving engine's prefill).

On a CPU tensor the wrapper runs the plain version (`ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _checks, _vmap
from repro_torch.kernels._build import get_ext
from repro_torch.kernels._recompute import recompute_vjp
from repro_torch.kernels.attention import ref

launches = 0   # kernel launches; only `_launch` adds to it


def _plain_bhld(q, k, v, causal, window, q_offset):
    out = ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            q_offset=q_offset)
    return out.transpose(1, 2)


def _launch(q, k, v, causal, window, q_offset):
    """Launch K7, or raise `_checks.Refused` (a ValueError) before the
    extension for a call its binding would refuse."""
    global launches
    (B, H, Lq), hd, hd_v = q.shape[:3], q.shape[-1], v.shape[-1]
    # (B, Lq, H, hd_v) storage, viewed as (B, H, Lq, hd_v)
    out = torch.empty((B, Lq, H, hd_v), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    _checks.flash_attention(q, k, v, out, window)
    get_ext().flash_attention(q, k, v, out, bool(causal),
                              0 if window is None else int(window),
                              int(q_offset), 1.0 / (hd ** 0.5))
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward by recomputation with the plain version;
    under `torch.func.vmap`, one launch over the folded batch."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])
        ctx.args = inputs[3:]

    @staticmethod
    def backward(ctx, ct):
        args = ctx.args
        grads = recompute_vjp(lambda q, k, v: _plain_bhld(q, k, v, *args),
                              ctx.saved_tensors, (ct,),
                              ctx.needs_input_grad[:3])
        return (*grads, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset):
        out = _vmap.fold(
            lambda q_, k_, v_: _FlashAttention.apply(q_, k_, v_, causal,
                                                     window, q_offset),
            info.batch_size, (q, k, v), in_dims[:3])
        return out, 0


def flash_attention_bhld(q, k, v, *, causal: bool = True, window=None,
                         q_offset: int = 0):
    """q: (B, H, Lq, hd); k: (B, Kv, Lk, hd); v: (B, Kv, Lk, hd_v), any
    strides. Returns (B, H, Lq, hd_v) — hd_v may differ from hd (on the
    card `_checks.HEAD_DIMS`: both <= 192, bf16 or f32)."""
    if not q.is_cuda:
        return _plain_bhld(q, k, v, causal, window, q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
