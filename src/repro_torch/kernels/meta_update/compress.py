"""Compression codecs for the packed (m, N) client-gradient block: the
bytes-on-the-wire plane. Counterpart of
`repro/kernels/meta_update/compress.py`.

  * **int8 per-row-scaled quantization.** Row u is scaled by
    s_u = max|g_u| / 127 and rounded to int8; the wire carries N int8
    values and one f32 scale per client. K6 (`int8_encode_flat`,
    `kernels/csrc/int8_encode.cu`) emits the quantized block and the
    error-feedback residual in one pass. Dequantization folds into K2:
    the int8 block aggregates with weights w_u·s_u, so no dequantized
    f32 block is ever built.
  * **top-k sparsification.** Each row sends its k largest-magnitude
    coordinates as (int32 index, value) pairs, the values cast to the
    block dtype. The selection is plain PyTorch, as it is plain XLA
    (`lax.top_k`) in the reference: a stable descending sort of |g|,
    the first k, so ties go to the lower index as `lax.top_k` breaks
    them (`torch.topk` leaves tie order unspecified). Decode scatters
    the pairs into a dense block that K2 reduces.

With error feedback the residual e_u' = (g_u + e_u) − decode(encode(
g_u + e_u)) is carried to the client's next round, so the dequantized
uploads plus the last residual telescope to the sum of the true
gradients.

On a CPU tensor K6's wrapper runs its plain version (`int8_encode_ref`
arithmetic); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.meta_update.aggregate import weighted_aggregate_flat
from repro_torch.kernels.meta_update.ref import weighted_aggregate_ref

CODECS = ("int8", "topk")

launches = 0   # K6 launches; only `int8_encode_flat` adds to it


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Upload-compression spec for the packed pipeline.

    codec           "int8" (per-row-scaled 8-bit) or "topk" (magnitude
                    sparsification).
    topk_frac       fraction of the REAL (unpadded) parameter count each
                    client sends under "topk" (k = max(1, round(
                    topk_frac · n_real))).
    error_feedback  carry per-client residuals in the train state (on
                    by default: both codecs are biased without it).
    """
    codec: str = "int8"
    topk_frac: float = 0.05
    error_feedback: bool = True

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(f"unknown codec {self.codec!r}; expected one "
                             f"of {CODECS}")
        if not (0.0 < self.topk_frac <= 1.0):
            raise ValueError(f"topk_frac must be in (0, 1], got "
                             f"{self.topk_frac}")

    def label(self) -> str:
        """Short codec tag for comm summaries ("int8+ef", "topk0.05")."""
        base = ("int8" if self.codec == "int8"
                else f"topk{self.topk_frac:g}")
        return base + ("+ef" if self.error_feedback else "")

    def k_for(self, n_real: int) -> int:
        """Per-client transmitted coordinate count under "topk"."""
        return max(1, int(round(self.topk_frac * n_real)))

    def upload_bytes(self, n_real: int, val_itemsize: int = 4) -> int:
        """Bytes of ONE client's upload over the REAL parameter count
        (the plane's padding is never sent):

          int8: n_real × 1 B payload + 4 B (one f32 row scale)
          topk: k × (4 B int32 index + val_itemsize B value)
        """
        if self.codec == "int8":
            return n_real + 4
        return self.k_for(n_real) * (4 + int(val_itemsize))


# ---- int8 per-row-scaled quantization -----------------------------------

def int8_scales(G) -> torch.Tensor:
    """(m, N) block -> (m,) f32 scales max|g_u| / 127 (an all-zero row
    gets scale 0 and quantizes to zeros). The max-norm is one read of
    the block (a max is exact in any order); the divisor is a tensor,
    so the division is a true division as in the reference (PyTorch
    would multiply by a rounded 1/127 for a python scalar)."""
    amax = torch.linalg.vector_norm(G.float(), float("inf"), dim=1)
    return amax / torch.full_like(amax, 127.0)


def _reciprocal_scales(scales):
    return torch.where(scales > 0,
                       torch.reciprocal(torch.clamp(scales, min=1e-30)),
                       torch.zeros_like(scales))


def _quantize(g, scales):
    """Plain version of K6: the same operations, each rounded once."""
    q = torch.clamp(torch.round(g * _reciprocal_scales(scales)[:, None]),
                    -127.0, 127.0)
    return q.to(torch.int8), g - scales[:, None] * q


def int8_encode_ref(G):
    """Plain version of ``int8_encode_flat``: scale, reciprocal,
    round-half-even, clip, residual."""
    g = G.float()
    scales = int8_scales(g)
    q, resid = _quantize(g, scales)
    return q, scales, resid


def int8_encode_flat(G, *, inplace: bool = False):
    """(m, N) block -> (q int8, scales f32 (m,), resid f32 (m, N)).

    On the card K6 quantizes and forms the residual in one pass. With
    ``inplace=True`` and an f32 block the residual overwrites ``G`` —
    for callers that own the block (the packed step's EF-corrected
    block is a temporary)."""
    global launches
    g = G.float()
    scales = int8_scales(g)
    if not g.is_cuda:
        q, resid = _quantize(g, scales)
        return q, scales, resid
    if g.ndim != 2:
        raise ValueError(f"the int8 encode kernel takes an (m, N) block, "
                         f"got {tuple(g.shape)}")
    g = g.contiguous()
    q = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    resid = g if (inplace or g is not G) else torch.empty_like(g)
    get_ext().int8_encode(g, scales, q, resid)
    launches += 1
    return q, scales, resid


def int8_aggregate_flat(q, scales, w):
    """Dequantize-and-aggregate Σ_u w_u·s_u·q_u -> (N,) f32: K2 over the
    int8 block with the scale folded into each row's f32 weight."""
    return weighted_aggregate_flat(q, w.float() * scales)


def int8_aggregate_ref(q, scales, w):
    """Plain version: K2's ordered row loop with the folded f32 weights
    (bitwise equal to `int8_aggregate_flat` on the card; the
    reference's oracle is a `dot_general`, allclose to both)."""
    return weighted_aggregate_ref(q, w.float() * scales)


def int8_row_norms(q, scales) -> torch.Tensor:
    """L2 norm of each DECODED row, s_u·‖q_u‖ (the DP clip's per-row
    reduction in the codec domain)."""
    sq = torch.sum(torch.square(q.float()), dim=1)
    return scales * torch.sqrt(sq)


# ---- top-k sparsification -----------------------------------------------

def topk_encode(G, k: int, val_dtype=torch.float32):
    """(m, N) block -> ((m, k) values, (m, k) int32 indices, (m, N) f32
    residual). Per-row magnitude top-k, ties to the lower index. Values
    are cast to ``val_dtype`` BEFORE the residual is formed, so the
    residual holds the cast error too."""
    g = G.float()
    order = torch.sort(g.abs(), dim=1, descending=True, stable=True)[1]
    idx = order[:, :k]
    vals = torch.gather(g, 1, idx).to(val_dtype)
    resid = g.clone().scatter_add_(1, idx, -vals.float())
    return vals, idx.to(torch.int32), resid


def topk_densify(vals, idx, n: int):
    """Scatter (m, k) pairs back into the dense (m, n) f32 block K2
    reduces (the decode half of the codec)."""
    dense = torch.zeros((vals.shape[0], n), dtype=torch.float32,
                        device=vals.device)
    return dense.scatter_add_(1, idx.long(), vals.float())


def topk_aggregate_flat(vals, idx, w, n: int):
    """Decode-and-aggregate: densify, then K2 reduces (m, n) -> (n,)."""
    return weighted_aggregate_flat(topk_densify(vals, idx, n), w)


def topk_aggregate_ref(vals, idx, w, n: int):
    """Plain version, as the reference's oracle: a weighted scatter-add
    straight into (n,), never building the dense block. (On the card
    `index_add_` sums a coordinate's rows with atomics in no fixed
    order: allclose to the kernel route, not bitwise.)"""
    wv = w.float()[:, None] * vals.float()
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.reshape(-1).long(), wv.reshape(-1))


def topk_row_norms(vals) -> torch.Tensor:
    """L2 norm of each decoded row = ‖transmitted values‖."""
    return torch.sqrt(torch.sum(torch.square(vals.float()), dim=1))
