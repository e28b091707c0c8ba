"""The collectives the multi-device paths call, over an explicit
process group.

Each call adds one to ``calls[op]`` and the bytes it sends to
``bytes_[op]`` (for the smoke test's per-round record).

A gloo group cannot take CUDA tensors in every collective, so on gloo a
CUDA tensor is staged explicitly through a pinned host buffer (device
to host, the collective on the host, host to device): that is what two
ranks on one card run. NCCL takes the device tensors as they are. An
all-to-all whose input needs a gradient runs as the differentiable
functional collective instead.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

calls: dict = {}
bytes_: dict = {}


def _count(op: str, t) -> None:
    calls[op] = calls.get(op, 0) + 1
    bytes_[op] = bytes_.get(op, 0) + t.numel() * t.element_size()


def reset() -> None:
    calls.clear()
    bytes_.clear()


def _staged(t, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_sum(t, group=None):
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    _count("all_reduce", t)
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_to_all(t, group=None):
    """`all_to_all_single` with equal splits along dim 0: chunk i of
    ``t`` goes to rank i, and chunk i of the result came from rank i."""
    _count("all_to_all", t)
    t = t.contiguous()
    if t.requires_grad:
        # the differentiable functional form (its backward is the
        # reverse all-to-all), for a step that trains through it
        from torch.distributed._functional_collectives import \
            all_to_all_single_autograd
        return all_to_all_single_autograd(t, None, None, group)
    if _staged(t, group):
        h = _host(t)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out.to(t.device)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out
