"""Dispatcher for full-sequence attention.

Layout contract with the models: (B, L, H, hd) activations, as in the
reference (`repro/kernels/attention/ops.py`). The kernel reads them
through transposed views; nothing is copied.

impl:
  "cuda"  — K7 for CUDA tensors, the plain version for CPU tensors
            (default)
  "torch" — the plain version everywhere
per call, or scoped with `use_impl`. A call with ``kv_length`` (ragged
valid kv slots) goes to the plain version under either impl and on
either device, as the reference's `if impl == "xla" or kv_length is not
None` does: K7 has no ragged-length input and is never attempted.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash_attention import flash_attention_bhld
from repro_torch.sharding.dtensor import is_dtensor, kernel_axes, local_call
from repro_torch.sharding.rules import P

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
    """q: (B, Lq, H, hd); k, v: (B, Lk, Kv, hd) -> (B, Lq, H, hd_v).

    DTensor q, k, v (a step on a mesh) enter through `local_map`, the
    batch over pod+data and the heads over model where they split
    evenly (`sharding.dtensor.kernel_axes`): each rank runs this
    function on its own shards."""
    impl = impl or _DEFAULT_IMPL
    assert impl in _IMPLS, impl
    if is_dtensor(q) and kv_length is None:
        b, h = kernel_axes(q, q.shape[0], q.shape[2],
                           group=q.shape[2] // k.shape[2])
        spec = P(b, None, h, None)
        return local_call(
            lambda q_, k_, v_: flash_attention(
                q_, k_, v_, causal=causal, window=window,
                q_offset=q_offset, impl=impl),
            (q, k, v), (spec, spec, spec), spec)
    if impl == "torch" or kv_length is not None:
        # ragged kv_length goes to the oracle under every impl, on any
        # device, as the reference's dispatch sends it to its own
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, kv_length=kv_length)
    out = flash_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, q_offset=q_offset)
    return out.transpose(1, 2)
