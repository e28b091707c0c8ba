"""K3: one fused outer-Adam step over the packed φ plane as a CUDA
kernel (`kernels/csrc/adam.cu`).

Counterpart of `repro/optim/fused_adam.py`: `adam_flat_pallas` (the
Pallas kernel `_adam_kernel`), its plain version `adam_flat_ref`, and
`adam_flat_update`, which advances the step count and computes the
bias-correction scales. The step is a 0-d int32 device tensor and the
(2,) scales are computed from it on the device in f32, as the
reference does, so a round needs no host sync.

The kernel updates φ, m and v in place — the counterpart of the
reference's ``input_output_aliases={1: 0, 3: 1, 4: 2}``. It rounds as
`adam_flat_ref` does in eager PyTorch: the same operation order, (1−b1)
and (1−b2) computed in Python double, and (1−b2)·g·g left to right, so
the two agree bit for bit on the card.

On CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _checks
from repro_torch.kernels._build import get_ext

launches = 0   # kernel launches; only `_launch` adds to it


def adam_flat_ref(phi, g, m, v, scales, *, lr, b1, b2, eps, wd):
    """Plain version of the fused step: returns (φ', m', v') with f32
    moments, new tensors."""
    g = g.float()
    m = b1 * m.float() + (1.0 - b1) * g
    v = b2 * v.float() + (1.0 - b2) * g * g
    u = (m * scales[0]) / (torch.sqrt(v * scales[1]) + eps)
    if wd > 0.0:
        u = u + wd * phi.float()
    return (phi.float() - lr * u).to(phi.dtype), m, v


def adam_flat_pallas(phi, g, m, v, scales, *, lr, b1, b2, eps, wd):
    """One fused Adam step on flat (N,) buffers, φ, m and v updated in
    place and returned; scales = (2,) f32 [1/(1−b1^t), 1/(1−b2^t)]."""
    if not phi.is_cuda:
        p2, m2, v2 = adam_flat_ref(phi, g, m, v, scales, lr=lr, b1=b1,
                                   b2=b2, eps=eps, wd=wd)
        phi.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
        return phi, m, v
    return _launch(phi, g, m, v, scales, lr=lr, b1=b1, b2=b2, eps=eps, wd=wd)


def _launch(phi, g, m, v, scales, *, lr, b1, b2, eps, wd):
    """Launch K3, or raise `_checks.Refused` (a ValueError and a
    TypeError) before the extension for a call its binding would
    refuse: φ and g float32, m and v float32 or bfloat16, all (N,)
    contiguous."""
    global launches
    g, scales = g.contiguous(), scales.float().contiguous()
    _checks.adam_flat(phi, g, m, v, scales)
    get_ext().adam_flat(phi, g, m, v, scales, float(lr), float(b1),
                        1.0 - b1, float(b2), 1.0 - b2, float(eps), float(wd))
    launches += 1
    return phi, m, v


def adam_scales(step, b1, b2):
    """(2,) f32 bias-correction scales [1/(1−b1^t), 1/(1−b2^t)] from the
    0-d int step count t, computed on its device in f32."""
    t = step.float()
    return torch.stack([1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)])


def adam_flat_update(phi, g, m, v, step, *, lr, b1=0.9, b2=0.999, eps=1e-8,
                     wd=0.0, state_dtype=torch.float32, impl: str = "cuda"):
    """One outer-Adam step on the packed plane.

    step: previous step count (0-d int32 tensor on φ's device); returns
    (φ', m', v', step+1) with moments in ``state_dtype``. impl "cuda"
    runs the kernel (in place) on CUDA tensors; "torch" the plain
    version (new tensors)."""
    step = step + 1
    scales = adam_scales(step, b1, b2)
    if impl == "torch":
        phi, m, v = adam_flat_ref(phi, g, m, v, scales, lr=lr, b1=b1, b2=b2,
                                  eps=eps, wd=wd)
    else:
        phi, m, v = adam_flat_pallas(phi, g, m, v, scales, lr=lr, b1=b1,
                                     b2=b2, eps=eps, wd=wd)
    return phi, m.to(state_dtype), v.to(state_dtype), step
