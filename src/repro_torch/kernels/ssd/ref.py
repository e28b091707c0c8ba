"""Plain-PyTorch versions of the Mamba2 SSD (state-space duality) scan,
all in float32. Counterpart of `repro/kernels/ssd/ref.py`, plus the
plain version of the K9 kernel.

  ssd_sequential         the exact O(L) recurrence (ground truth)
  ssd_chunked_ref        the chunked SSD algorithm (the reference's
                         "xla" route; the port's "torch" route)
  ssd_intra_chunk_plain  what K9 computes (`kernels/ssd/ssd_scan.py`),
                         in its layouts

Shapes (ngroups = 1):
  x:  (B, L, nh, hp)   per-head inputs
  dt: (B, L, nh)       softplus-activated step sizes
  A:  (nh,)            negative decay rates
  Bm: (B, L, N)        input projection (shared across heads)
  Cm: (B, L, N)        output projection
Returns y: (B, L, nh, hp)

The two decays differ above the diagonal, as the reference's do: the
chunked oracle multiplies exp(cum_i - cum_j) by a 0/1 mask, so where
that exp overflows it gives inf · 0 = NaN; the kernel and its plain
version select, and never evaluate the exp there.
"""
from __future__ import annotations

import torch


def ssd_sequential(x, dt, A, Bm, Cm):
    B, L, nh, hp = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    state = torch.zeros((B, nh, hp, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af[None])               # (B, nh)
        state = (state * decay[..., None, None]
                 + torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t],
                                xf[:, t]))
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, 1).to(x.dtype)


def ssd_chunked_ref(x, dt, A, Bm, Cm, chunk: int,
                    return_final_state: bool = False):
    B, L, nh, hp = x.shape
    N = Bm.shape[-1]
    assert L % chunk == 0, (L, chunk)
    nc = L // chunk
    xf = x.float().reshape(B, nc, chunk, nh, hp)
    dtf = dt.float().reshape(B, nc, chunk, nh)
    Bf = Bm.float().reshape(B, nc, chunk, N)
    Cf = Cm.float().reshape(B, nc, chunk, N)
    Af = A.float()

    a = dtf * Af[None, None, None]                 # (B,nc,Q,nh) log-decay
    cum = torch.cumsum(a, dim=2)                   # inclusive cumsum
    xdt = xf * dtf[..., None]

    # intra-chunk: decay(i, j) = exp(cum_i - cum_j) for j <= i, masked by
    # a product with the 0/1 lower triangle (`ref.py:66-68`)
    di = cum[:, :, :, None, :]                     # (B,nc,Q,1,nh)
    dj = cum[:, :, None, :, :]                     # (B,nc,1,Q,nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=x.device))
    dmat = torch.exp(di - dj) * tri[None, None, :, :, None]
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)   # (B,nc,Q,Q)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, dmat, xdt)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (x dt)_j
    last = cum[:, :, -1:, :]                       # (B,nc,1,nh)
    sdecay = torch.exp(last - cum)                 # (B,nc,Q,nh)
    S = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bf, sdecay, xdt)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(last[:, :, 0, :])      # (B,nc,nh)
    S_prev = torch.zeros((B, nh, hp, N), dtype=torch.float32, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S_prev)                        # state entering chunk c
        S_prev = S[:, c] + S_prev * chunk_decay[:, c, :, None, None]
    S_in = torch.stack(S_in, 1)                    # (B,nc,nh,hp,N)

    # inter-chunk output: y_inter[i] = exp(cum_i) C_i . S_in
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cf, torch.exp(cum), S_in)
    y = (y_intra + y_inter).reshape(B, L, nh, hp).to(x.dtype)
    if return_final_state:
        return y, S_prev                           # (B, nh, hp, N)
    return y


def ssd_intra_chunk_plain(xdt, a, Bm, Cm, *, chunk: int):
    """The plain version of K9, in its layouts: xdt (B, nh, L, hp), a
    (B, nh, L), Bm / Cm (B, L, N) -> y_intra (B, nh, L, hp) and the chunk
    states S (B, nh, nc, N, hp), float32. Per (b, h, c), as the
    reference's `_ssd_chunk_kernel` (`ssd_scan.py:21-44`): the inclusive
    cumsum of a over the chunk, ((C Bᵀ) ⊙ D) @ xdt with D = exp(cum_i −
    cum_j) selected where j <= i and 0 elsewhere, and S = (B ⊙
    exp(cum_last − cum))ᵀ @ xdt. The exponent is masked to −inf before
    the exp, so the forward never forms an overflowed exp above the
    diagonal and autograd through it never forms 0 · inf."""
    B, nh, L, hp = xdt.shape
    N = Bm.shape[-1]
    assert L % chunk == 0, (L, chunk)
    nc = L // chunk
    x = xdt.float().reshape(B, nh, nc, chunk, hp)
    cum = torch.cumsum(a.float().reshape(B, nh, nc, chunk), dim=-1)
    Bc = Bm.float().reshape(B, 1, nc, chunk, N)
    Cc = Cm.float().reshape(B, 1, nc, chunk, N)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xdt.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]         # (B,nh,nc,Q,Q)
    dmat = torch.exp(torch.where(tri, diff, float("-inf")))
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))          # (B,1,nc,Q,Q)
    y = torch.matmul(cb * dmat, x)                       # (B,nh,nc,Q,hp)
    sdecay = torch.exp(cum[..., -1:] - cum)              # (B,nh,nc,Q)
    S = torch.matmul((Bc * sdecay[..., None]).transpose(-1, -2), x)
    return y.reshape(B, nh, L, hp), S
