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

DTensor's own collectives (a launcher step on a mesh) do not pass
through these functions. A world started with the backend
`STAGED_GLOO` (`register_staged_gloo`) runs them as `StagedGloo`, which
stages each tensor the same way; its calls count as ``staged_<op>``.
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


# ----------------------------------------------- DTensor's collectives

STAGED_GLOO = "staged_gloo"


def _done():
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(None)
    return _create_work_from_future(fut)


class StagedGloo(dist.ProcessGroup):
    """A process group that runs each collective on an inner gloo group
    over pinned host copies of its tensors (device to host, the
    collective, host to device), then returns a finished work. Gloo
    takes host tensors in every collective, but given a CUDA tensor
    DTensor's all-gather ends the process (`tools/probe_gloo_cuda.py`),
    and NCCL refuses a second rank on one card. So this is how two
    ranks on one card run a step on a mesh. The methods are those
    DTensor, the functional collectives and `torch.distributed`'s
    all-gather, all-reduce, broadcast and scatter call. Each call counts in ``calls`` under ``staged_<op>``, and the
    bytes it stages (its inputs and outputs) in ``bytes_``."""

    def __init__(self, inner, rank, size):
        super().__init__(rank, size)
        self._inner, self._name = inner, None

    def getBackendName(self):
        return STAGED_GLOO

    # a DeviceMesh reads ``group_name``, which a process group written
    # in Python must keep itself
    def _set_group_name(self, name):
        self._name = name
        super()._set_group_name(name)

    @property
    def group_name(self):
        return self._name

    def _run(self, op, inner_op, *args):
        """``inner_op`` of the inner group on host copies of the tensors
        in ``args`` (tensors or lists of them); every copy is written
        back, so the outputs land in the caller's tensors."""
        op = f"staged_{op}"
        staged = []

        def host(x):
            if isinstance(x, (list, tuple)):
                return [host(v) for v in x]
            if not isinstance(x, torch.Tensor):
                return x
            h = (_host(x) if x.is_cuda
                 else x.clone(memory_format=torch.contiguous_format))
            staged.append((x, h))
            return h

        hargs = [host(a) for a in args if a is not None]
        calls[op] = calls.get(op, 0) + 1
        bytes_[op] = bytes_.get(op, 0) + sum(
            x.numel() * x.element_size() for x, _ in staged)
        getattr(self._inner, inner_op)(*hargs).wait()
        for x, h in staged:
            x.copy_(h)
        return _done()

    def allreduce(self, tensors, opts=None):
        return self._run("all_reduce", "allreduce", tensors, opts)

    def allgather(self, outputs, inputs, opts=None):
        return self._run("all_gather", "allgather", outputs, inputs, opts)

    def all_gather_single(self, output, input, opts=None):
        return self._run("all_gather", "_allgather_base", output, input,
                         opts)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i)
        return _done()

    def reduce_scatter_single(self, output, input, opts=None):
        return self._run("reduce_scatter", "_reduce_scatter_base", output,
                         input, opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done()

    def alltoall_base(self, output, input, out_splits, in_splits,
                      opts=None):
        return self._run("all_to_all", "alltoall_base", output, input,
                         out_splits, in_splits, opts)

    def broadcast(self, tensors, opts=None):
        return self._run("broadcast", "broadcast", tensors, opts)

    def scatter(self, outputs, inputs, opts=None):
        return self._run("scatter", "scatter", outputs, inputs, opts)

    def barrier(self, opts=None):
        return self._run("barrier", "barrier", opts)


def _create_staged_gloo(store, rank, size, timeout):
    inner = dist.ProcessGroupGloo(dist.PrefixStore(STAGED_GLOO, store), rank,
                                  size, timeout)
    return StagedGloo(inner, rank, size)


def register_staged_gloo() -> str:
    """Register `StagedGloo` as the backend `STAGED_GLOO` for the CPU and
    CUDA (once a process); returns its name, for
    `dist.init_process_group`."""
    if STAGED_GLOO.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED_GLOO, _create_staged_gloo,
                                      devices=["cpu", "cuda"])
    return STAGED_GLOO
