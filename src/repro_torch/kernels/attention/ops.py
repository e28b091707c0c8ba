"""Dispatcher for full-sequence attention.

Layout contract with the models: (B, L, H, hd) activations, as in the
reference (`repro/kernels/attention/ops.py`). The kernel reads them
through transposed views; nothing is copied.

impl:
  "cuda"  — K7 for CUDA tensors, the plain version for CPU tensors
            (default)
  "torch" — the plain version everywhere
per call, or scoped with `use_impl`.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash_attention import flash_attention_bhld

_IMPLS = ("torch", "cuda")
_DEFAULT_IMPL = "cuda"


@contextlib.contextmanager
def use_impl(impl: str):
    """Scoped default-impl override (restores on exit)."""
    global _DEFAULT_IMPL
    assert impl in _IMPLS, impl
    prev, _DEFAULT_IMPL = _DEFAULT_IMPL, impl
    try:
        yield
    finally:
        _DEFAULT_IMPL = prev


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, kv_length=None,
                    impl: str | None = None):
    """q: (B, Lq, H, hd); k, v: (B, Lk, Kv, hd) -> (B, Lq, H, hd_v)."""
    impl = impl or _DEFAULT_IMPL
    assert impl in _IMPLS, impl
    if impl == "torch":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_length=kv_length)
    if kv_length is not None:
        # the reference keeps ragged kv_length on its oracle; the port has
        # no kernel for it and does not fall back on the card
        if q.is_cuda:
            raise NotImplementedError(
                "flash_attention with kv_length has no CUDA kernel; "
                "pass impl='torch'")
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_length=kv_length)
    out = flash_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, q_offset=q_offset)
    return out.transpose(1, 2)
