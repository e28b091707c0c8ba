"""K9: the Mamba2 SSD intra-chunk compute as a CUDA kernel
(`kernels/csrc/ssd_chunk.cu`).

Counterpart of `repro/kernels/ssd/ssd_scan.py` `ssd_intra_chunk_pallas`:
per (batch, head, chunk) the within-chunk output ((C Bᵀ) ⊙ decay) @ xdt
and the chunk's state contribution S = (B ⊙ exp(cum_last − cum))ᵀ @ xdt,
float32. The kernel reads xdt, a, Bm and Cm and writes y through their
strides, so `ops.ssd_chunked` hands it transposed views of the models'
(B, L, nh, ·) tensors and gets y back as a view over a (B, L, nh, hp)
buffer: no transpose copies. It runs as two kernels on the tensor cores
(3xTF32): C Bᵀ once per (batch, chunk) into a scratch the wrapper
allocates, beside the S blocks, then y, which reads the scratch.

The reference kernel has no VJP and the reference never differentiates
through it. The port's serving adaptation and training round do, so
under a gradient the kernel sits in an ``autograd.Function`` whose
backward recomputes the plain version (`ref.ssd_intra_chunk_plain`)
under autograd (`kernels/_recompute.py`), differentiable again for
the second-order meta-learners; a backward kernel is later work.
Every launch on the card goes through that Function, so under
`torch.func.vmap` (a batch of served Mamba2 prefills) its ``vmap`` rule
folds the request axis into the batch axis (`kernels/_vmap.py`): one
launch for the group.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _checks, _vmap
from repro_torch.kernels._build import get_ext
from repro_torch.kernels._recompute import recompute_vjp
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain

launches = 0   # kernel launches; only `_launch` adds to it


def _launch(xdt, a, Bm, Cm, chunk):
    global launches
    B, nh, L, hp = xdt.shape
    N = Bm.shape[-1]
    # (B, L, nh, hp) storage, viewed as (B, nh, L, hp)
    y = torch.empty((B, L, nh, hp), dtype=torch.float32,
                    device=xdt.device).transpose(1, 2)
    S = torch.empty((B, nh, L // chunk, N, hp), dtype=torch.float32,
                    device=xdt.device)
    # scratch for C Bᵀ, computed once per (b, c) and shared by the heads
    cbuf = torch.empty((B, L // chunk, chunk, (chunk + 3) // 4 * 4),
                       dtype=torch.float32, device=xdt.device)
    _checks.ssd_chunk(xdt, a, Bm, Cm, y, S, cbuf, int(chunk))
    get_ext().ssd_chunk(xdt, a, Bm, Cm, y, S, cbuf, int(chunk))
    launches += 1
    return y, S


class _SsdIntraChunk(torch.autograd.Function):
    """Kernel forward; backward by recomputation with the plain version;
    under `torch.func.vmap`, one launch over the folded batch."""

    @staticmethod
    def forward(xdt, a, Bm, Cm, chunk):
        return _launch(xdt, a, Bm, Cm, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.chunk = inputs[4]

    @staticmethod
    def backward(ctx, gy, gS):
        chunk = ctx.chunk
        grads = recompute_vjp(
            lambda *ins: ssd_intra_chunk_plain(*ins, chunk=chunk),
            ctx.saved_tensors, (gy, gS), ctx.needs_input_grad[:4])
        return (*grads, None)

    @staticmethod
    def vmap(info, in_dims, xdt, a, Bm, Cm, chunk):
        out = _vmap.fold(
            lambda *t: _SsdIntraChunk.apply(*t, chunk),
            info.batch_size, (xdt, a, Bm, Cm), in_dims[:4])
        return out, (0, 0)


def ssd_intra_chunk(xdt, a, Bm, Cm, *, chunk: int):
    """xdt (B, nh, L, hp), a (B, nh, L), Bm / Cm (B, L, N), float32, any
    strides -> y_intra (B, nh, L, hp) and S (B, nh, L // chunk, N, hp),
    float32."""
    if not xdt.is_cuda:
        return ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk)
    return _SsdIntraChunk.apply(xdt, a, Bm, Cm, chunk)
