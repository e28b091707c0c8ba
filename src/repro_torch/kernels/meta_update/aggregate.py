"""The server reduces of the (m, N) client-gradient block: K2, the fused
weighted aggregation (`kernels/csrc/aggregate.cu`), K5, the
coordinate-wise trimmed mean (`kernels/csrc/trimmed_mean.cu`), and the
failure plane's robust reductions built on them.

Counterpart of `repro/kernels/meta_update/aggregate.py`:

  * `weighted_aggregate_flat` (K2, the Pallas `_agg_kernel`): one pass,
    out = Σ_u w_u·f32(gs[u]) into (N,) f32, rows summed in order
    u = 0..m-1. The block may be f32, bf16 or int8; the (m,) weights are
    a device tensor, normalized by the caller.
  * `masked_mean_flat`: Σ w g / Σ w through K2, so dropped (w = 0) rows
    renormalize over the arrived ones; an all-dropped round is 0/0.
  * `screened_aggregate_flat`: non-finite and dropped rows are
    rejected, rows with ‖g‖ above ``factor`` × the live-row median norm
    are clipped (a clip is a weight scale, so K2 does the reduce over
    the rejected-rows-zeroed block), and the result renormalizes over
    the unclipped live weights.
  * `trimmed_mean_flat` (K5, the Pallas `_trimmed_kernel`): per
    coordinate, the live rows' sum minus the ``trim`` largest and
    smallest values (extraction sweeps with ∓3e38 sentinels and
    first-index ties) over n_live − 2·trim. Its plain version
    `trimmed_mean_plain` does the same arithmetic in the same order, so
    the kernel is bitwise equal to it; `trimmed_mean_ref` is the
    reference's sort-based oracle, the ``"torch"`` route.

On a CPU tensor each kernel wrapper runs its plain version; on a CUDA
tensor it launches its kernel or raises. No function here syncs with
the host: liveness, screens and counts stay device tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import get_ext
from repro_torch.kernels.meta_update.ref import weighted_aggregate_ref

__all__ = ["launches", "trimmed_launches", "weighted_aggregate_flat",
           "weighted_aggregate_ref", "row_liveness", "masked_mean_ref",
           "masked_mean_flat", "screened_weights", "screened_aggregate_ref",
           "screened_aggregate_flat", "trimmed_mean_plain",
           "trimmed_mean_flat", "trimmed_mean_ref"]

launches = 0   # K2 launches; only `weighted_aggregate_flat` adds to it
trimmed_launches = 0   # K5 launches; only `trimmed_mean_flat` adds to it

# the finite sentinel of the trimmed mean's extraction sweeps and of the
# screen's masked median: larger than any real gradient coordinate, but
# finite (as an f32: 3e38 rounded to nearest)
BIG = 3.0e38

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


# ---- robust aggregation (the failure plane) --------------------------------

def row_liveness(gs, w):
    """(m,) f32 mask of aggregatable rows: weight > 0 AND all-finite.
    Finite iff the row's sum of |g| (f32) is finite, as in the
    reference; summed one row at a time, so no (m, N) f32 temporary."""
    mag = torch.stack([torch.sum(torch.abs(gs[u]), dtype=torch.float32)
                       for u in range(gs.shape[0])])
    return (torch.isfinite(mag) & (w.float() > 0)).float()


def masked_mean_ref(gs, w):
    """Dropout-masked renormalizing weighted mean: Σ w g / Σ w."""
    return weighted_aggregate_ref(gs, w) / torch.sum(w.float())


def masked_mean_flat(gs, w):
    """The masked mean through K2 plus one scalar renormalization:
    dropped rows carry w = 0, so the arrived rows keep their relative
    weights while their sum returns to 1."""
    return weighted_aggregate_flat(gs, w) / torch.sum(w.float())


def screened_weights(gs, w, *, factor: float = 3.0):
    """Norm screening as effective weights -> ``(w_num, w_den)`` with
    aggregate = Σ w_num·g / Σ w_den.

    Dead rows (zero weight or a non-finite entry) are rejected; the
    threshold is τ = factor × the lower median of the live norms (dead
    rows sort last as +BIG sentinels); rows with ‖g‖ > τ are clipped by
    τ/‖g‖ as a weight scale. The denominator keeps the unclipped live
    weights, so a clip shrinks an outlier instead of re-inflating the
    others; an all-dead round gives Σ w_den = 0, non-finite for the
    guard. The squared norms are summed one row at a time (f32), in
    another order than the reference's reduce."""
    sq = torch.stack([torch.sum(torch.square(gs[u].float()))
                      for u in range(gs.shape[0])])
    w32 = w.float()
    live = torch.isfinite(sq) & (w32 > 0)
    norms = torch.sqrt(sq)
    big = torch.tensor(BIG, dtype=torch.float32, device=gs.device)
    ranked = torch.sort(torch.where(live, norms, big)).values
    n_live = torch.sum(live)
    med = ranked.gather(0, (torch.clamp(n_live - 1, min=0) // 2).view(1))[0]
    thresh = torch.tensor(factor, dtype=torch.float32,
                          device=gs.device) * med
    one = torch.ones((), dtype=torch.float32, device=gs.device)
    clip = torch.where(norms > thresh, thresh / norms, one)
    zero = torch.zeros((), dtype=torch.float32, device=gs.device)
    return torch.where(live, w32 * clip, zero), torch.where(live, w32, zero)


def _screen_rows(gs, w_num):
    # rejected rows may be NaN and K2 multiplies (0 · NaN is NaN), so
    # they are zeroed before the reduce
    return torch.where((w_num > 0)[:, None], gs,
                       torch.zeros((), dtype=gs.dtype, device=gs.device))


def screened_aggregate_ref(gs, w, *, factor: float = 3.0):
    """Norm-screened aggregation, plain (see `screened_weights`)."""
    w_num, w_den = screened_weights(gs, w, factor=factor)
    return (weighted_aggregate_ref(_screen_rows(gs, w_num), w_num)
            / torch.sum(w_den))


def screened_aggregate_flat(gs, w, *, factor: float = 3.0):
    """Norm screening with the (m, N) reduce on K2 over the clipped
    effective weights; the screen itself is (m,)-sized work."""
    w_num, w_den = screened_weights(gs, w, factor=factor)
    return (weighted_aggregate_flat(_screen_rows(gs, w_num), w_num)
            / torch.sum(w_den))


def _check_trim(m: int, trim: int):
    if not 0 <= 2 * trim < m:
        raise ValueError(f"the trimmed mean needs 0 <= 2·trim < m, got "
                         f"trim={trim}, m={m}")


def trimmed_mean_plain(gs, live, *, trim: int = 1):
    """Plain version of K5, the arithmetic of the reference's Pallas
    kernel in its order, per coordinate:

      total = Σ_u (live_u ? g_u : 0), rows in order from 0;
      top   = ``trim`` sweeps, each taking the first strictly greater
              value from (−BIG, row 0) over the rows (dead rows −BIG),
              adding it to a sum from 0, then knocking out its row
              (even when nothing beat the sentinel);
      bot   = the same with the signs swapped (only when trim > 0);
      out   = ((total − top) − bot) / (n_live − 2·trim), n_live the f32
              sum of 1.0 and 0.0 over the rows.

    Dead rows are reached only through a select, so they may hold NaN.
    Degenerate rounds (n_live ≤ 2·trim) give what the reference's kernel
    gives: NaN and ±inf from x/0, the live row itself at n_live = 1,
    zeros, or NaN where −BIG sentinels overflow."""
    m, n = gs.shape
    _check_trim(m, trim)
    dev = gs.device
    alive = live.float() > 0
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    total = torch.zeros((n,), dtype=torch.float32, device=dev)
    for u in range(m):
        total = total + torch.where(alive[u], gs[u].float(), zero)

    def extract(sign):
        fill = -big if sign > 0 else big
        x = [torch.where(alive[u], gs[u].float(), fill) for u in range(m)]
        ext = torch.zeros((n,), dtype=torch.float32, device=dev)
        for _ in range(trim):
            bv = fill.expand(n)
            bu = torch.zeros((n,), dtype=torch.int32, device=dev)
            for u in range(m):
                better = x[u] > bv if sign > 0 else x[u] < bv
                bv = torch.where(better, x[u], bv)
                bu = torch.where(better, u, bu)
            ext = ext + bv
            x = [torch.where(bu == u, fill, x[u]) for u in range(m)]
        return ext

    top = extract(1)
    bot = extract(-1) if trim else torch.zeros_like(total)
    n_live = zero
    for u in range(m):
        n_live = n_live + torch.where(alive[u], 1.0, 0.0)
    den = (n_live - 2.0 * trim).expand(n)   # elementwise: a true division
    return ((total - top) - bot) / den


def trimmed_mean_flat(gs, live, *, trim: int = 1):
    """K5: gs (m, N) f32 or bf16, live (m,) f32 mask (`row_liveness`) ->
    (N,) f32 coordinate-wise trimmed mean over the live rows, bitwise
    equal to `trimmed_mean_plain`. Needs 0 ≤ 2·trim < m; rounds with
    n_live ≤ 2·trim are degenerate (see `trimmed_mean_plain`)."""
    global trimmed_launches
    if not gs.is_cuda:
        return trimmed_mean_plain(gs, live, trim=trim)
    if gs.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the trimmed-mean kernel takes float32 or bfloat16, "
                        f"got {gs.dtype}")
    _check_trim(gs.shape[0], trim)
    out = torch.empty((gs.shape[1],), dtype=torch.float32, device=gs.device)
    get_ext().trimmed_mean(gs.contiguous(),
                           live.to(device=gs.device,
                                   dtype=torch.float32).contiguous(),
                           out, int(trim))
    trimmed_launches += 1
    return out


_SORT_COLUMNS = 1 << 24   # columns per sort: bounds the sort's temporaries


def trimmed_mean_ref(gs, live, *, trim: int = 1):
    """The reference's sort-based oracle (the ``"torch"`` route): dead
    rows become NaN, which `torch.sort` places last, so the live values
    hold ranks [0, n_live) and the kept window is [trim, n_live − trim).
    The sort runs over column blocks (its int64 indices are dropped), so
    at LM width it never holds the whole block's indices."""
    m, n = gs.shape
    dev = gs.device
    alive = (live > 0)[:, None]
    n_live = torch.sum(live > 0)
    rank = torch.arange(m, device=dev)[:, None]
    keep = (rank >= trim) & (rank < n_live - trim)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    for c in range(0, n, _SORT_COLUMNS):
        x = torch.where(alive, gs[:, c:c + _SORT_COLUMNS].float(), nan)
        ranked = torch.sort(x, dim=0).values
        del x
        out[c:c + _SORT_COLUMNS] = torch.sum(
            torch.where(keep, ranked, zero), dim=0)
    return out / (n_live - 2 * trim)
