"""Backward by recomputation for the kernels that have no backward
kernel (K7, K9): the VJP of a kernel's plain version, taken under
autograd from the inputs the kernel's ``autograd.Function`` saved.

First order (the backward runs with grad mode off, as a plain
``backward()`` or ``autograd.grad`` runs it): the VJP is computed from
detached copies of the inputs and returned as constants.

Second order (grad mode on inside the backward: the caller passed
``create_graph=True``, as MAML's and Meta-SGD's support gradient does):
the VJP must itself be differentiable in the inputs and in the incoming
gradient. It runs as ``_DifferentiableVJP``, which computes the same
VJP (the same operations, so the same bits as the first-order route)
and saves only the inputs and the incoming gradient; its own backward
recomputes the plain version and its VJP under autograd and
differentiates that. The graph that a second-order step keeps alive is
then the inputs of each call, not the plain version's intermediates:
for causal attention at 4,096 tokens those are (L × L) f32 score
tensors, about 1 GB a sequence and a head group each, in every layer.
"""
from __future__ import annotations

import torch


def _vjp(fn, ins, cts, need, create_graph):
    """VJP of ``fn(*ins)`` (a tensor or a tuple of tensors) against
    ``cts``, for the inputs flagged in ``need``; None for the others.
    With ``create_graph`` the inputs are used as given (they must be
    part of the caller's graph), otherwise as detached copies."""
    with torch.enable_grad():
        leaves = [t if create_graph else t.detach().requires_grad_(n)
                  for t, n in zip(ins, need)]
        wrt = [t for t, n in zip(leaves, need) if n]
        grads = iter(torch.autograd.grad(fn(*leaves), wrt, cts,
                                         create_graph=create_graph))
    return tuple(next(grads) if n else None for n in need)


class _DifferentiableVJP(torch.autograd.Function):
    """(ins, cts) -> the needed entries of the VJP of fn, with a
    backward of its own (the VJP's VJP, by recomputation)."""

    @staticmethod
    def forward(ctx, fn, need, n_in, *tensors):
        ctx.fn, ctx.need, ctx.n_in = fn, need, n_in
        ctx.save_for_backward(*tensors)
        grads = _vjp(fn, tensors[:n_in], tensors[n_in:], need, False)
        return tuple(g for g in grads if g is not None)

    @staticmethod
    def backward(ctx, *ggs):
        tensors = ctx.saved_tensors
        need_t = ctx.needs_input_grad[3:]
        n_in = ctx.n_in

        def firsts(*ts):
            return tuple(g for g in _vjp(ctx.fn, ts[:n_in], ts[n_in:],
                                         ctx.need, True) if g is not None)

        grads = _vjp(firsts, tensors, ggs, need_t, torch.is_grad_enabled())
        return (None, None, None, *grads)


def recompute_vjp(fn, ins, cts, need):
    """The backward of a kernel's ``autograd.Function``: the VJP of its
    plain version ``fn`` at the saved inputs ``ins`` against the
    incoming gradients ``cts``, for the inputs flagged in ``need``
    (``ctx.needs_input_grad``). Differentiable when grad mode is on."""
    need = tuple(bool(n) for n in need)
    if not torch.is_grad_enabled():
        return _vjp(fn, ins, cts, need, False)
    got = iter(_DifferentiableVJP.apply(fn, need, len(ins), *ins, *cts))
    return tuple(next(got) if n else None for n in need)
