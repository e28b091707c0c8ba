"""Dispatcher for the Mamba2 SSD scan: the K9 intra-chunk kernel plus the
inter-chunk recurrence in PyTorch, with the chunked oracle as the plain
route. Counterpart of `repro/kernels/ssd/ops.py`.

impl:
  "cuda"  — K9 for CUDA tensors, its plain version for CPU tensors
            (default); the reference's "pallas" route
  "torch" — `ref.ssd_chunked_ref` everywhere; the reference's "xla"
            route
per call, or scoped with `use_impl`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._impl import ImplSwitch
from repro_torch.kernels.ssd import ref
from repro_torch.kernels.ssd.ssd_scan import ssd_intra_chunk
from repro_torch.sharding.dtensor import (is_dtensor, kernel_axes, local_call,
                                         summed_over_batch)
from repro_torch.sharding.rules import P, placements

_IMPL = ImplSwitch()
set_default_impl, get_default_impl, use_impl = (
    _IMPL.set, _IMPL.get, _IMPL.use)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int, impl: str | None = None,
                return_final_state: bool = False):
    """SSD over (B, L, nh, hp) inputs; see `ref.py` for shapes.

    With return_final_state, also returns the (B, nh, hp, N) state after
    the last token (for prefill -> decode handoff)."""
    impl = _IMPL.resolve(impl)
    if is_dtensor(x):
        # a step on a mesh: each rank scans its own batch rows and heads;
        # A's gradient is each rank's share, summed over the batch dims
        from torch.distributed.tensor import Replicate
        b, h = kernel_axes(x, x.shape[0], x.shape[2])
        outs = ((P(b, None, h, None), P(b, h, None, None))
                if return_final_state else P(b, None, h, None))
        ins = (P(b, None, h, None), P(b, None, h), P(h), P(b, None, None),
               P(b, None, None))
        a_grad = tuple(g if isinstance(p, Replicate) else p for g, p in zip(
            summed_over_batch(x.device_mesh, b),
            placements(P(h), x.device_mesh)))
        return local_call(
            lambda *a: ssd_chunked(*a, chunk=chunk, impl=impl,
                                   return_final_state=return_final_state),
            (x, dt, A, Bm, Cm), ins, outs,
            in_grad_specs=ins[:2] + (a_grad,) + ins[3:])
    if impl == "torch":
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk,
                                   return_final_state=return_final_state)

    B, L, nh, hp = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    dtf = dt.float()
    a = dtf * A.float()[None, None, :]                        # (B,L,nh)
    xdt = x.float() * dtf[..., None]                          # (B,L,nh,hp)
    Cf = Cm.float()

    # the kernel's layout, (B, nh, L, ·), as views
    a_t = a.transpose(1, 2)                                   # (B,nh,L)
    y_intra, S = ssd_intra_chunk(xdt.transpose(1, 2), a_t, Bm.float(), Cf,
                                 chunk=chunk)                 # S (B,nh,nc,N,hp)

    # inter-chunk recurrence: a tiny state, O(nc) steps
    cum = torch.cumsum(a_t.reshape(B, nh, nc, chunk), dim=-1)
    chunk_decay = torch.exp(cum[..., -1])                     # (B,nh,nc)
    S_prev = torch.zeros((B, nh, N, hp), dtype=torch.float32, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S_prev)                                   # entering c
        S_prev = S[:, :, c] + S_prev * chunk_decay[:, :, c, None, None]
    S_in = torch.stack(S_in, 2)                               # (B,nh,nc,N,hp)

    # inter-chunk output: y_inter[i] = exp(cum_i) C_i . S_in
    y_inter = torch.einsum("bcin,bhcnp,bhci->bhcip",
                           Cf.reshape(B, nc, chunk, N), S_in, torch.exp(cum))
    y = y_intra.reshape(B, nh, nc, chunk, hp) + y_inter
    y = y.reshape(B, nh, L, hp).transpose(1, 2).to(x.dtype)
    if return_final_state:
        return y, S_prev.transpose(-1, -2)                    # (B,nh,hp,N)
    return y


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """Single-token recurrent update (plain PyTorch: the reference has no
    kernel for it).

    state: (B, nh, hp, N); x: (B, nh, hp); dt: (B, nh); Bm/Cm: (B, N).
    Returns (y (B, nh, hp), new_state)."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float()[None])
    state = (state * decay[..., None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dtf, Bm.float(), x.float()))
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    return y.to(x.dtype), state
