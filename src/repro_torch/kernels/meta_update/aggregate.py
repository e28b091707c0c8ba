"""K2: the fused weighted aggregation of the (m, N) client-gradient
block as a CUDA kernel (`kernels/csrc/aggregate.cu`).

Counterpart of `repro/kernels/meta_update/aggregate.py`
`weighted_aggregate_flat` (the Pallas kernel `_agg_kernel`): one pass
over the block, out = Σ_u w_u·f32(gs[u]) into (N,) f32, rows summed in
order u = 0..m-1. The block may be f32, bf16 or int8. The weights are a
(m,) device tensor, normalized by the caller (`fedmeta` normalizes once
per round), so a round needs no host sync.

On a CPU tensor the wrapper runs the plain version
(`ref.weighted_aggregate_ref`); on a CUDA tensor it launches the kernel
or raises. The masked, screened and trimmed reductions (K5) join with
the failure-plane slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.meta_update.ref import weighted_aggregate_ref

__all__ = ["launches", "weighted_aggregate_flat", "weighted_aggregate_ref"]

launches = 0   # kernel launches; only `weighted_aggregate_flat` adds to it

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def weighted_aggregate_flat(gs, w):
    """gs: (m, N) packed client gradients, w: (m,) weights -> (N,) f32."""
    global launches
    if not gs.is_cuda:
        return weighted_aggregate_ref(gs, w)
    if gs.dtype not in _DTYPES:
        raise TypeError(f"the aggregation kernel takes {_DTYPES}, got "
                        f"{gs.dtype}")
    out = torch.empty((gs.shape[1],), dtype=torch.float32, device=gs.device)
    get_ext().weighted_aggregate(gs.contiguous(),
                                 w.to(device=gs.device,
                                      dtype=torch.float32).contiguous(), out)
    launches += 1
    return out
