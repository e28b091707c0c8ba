"""Seeded per-round client-failure injection. Counterpart of
`repro/federated/faults.py`.

Federated populations are unreliable: clients drop out mid-round,
diverge locally and upload non-finite gradients, or are Byzantine.
``FaultConfig`` describes such a population with three independent
failure fractions; each round a seeded pick assigns *disjoint* roles to
the sampled clients:

  * **dropout** — the update never arrives: its aggregation weight is
    zeroed (renormalization is the aggregator's job);
  * **non-finite** — the client's gradient row becomes NaN;
  * **Byzantine** — the row becomes ``-scale·g`` (``"sign_flip"``) or
    ``scale·N(0, 1)`` noise (``"scaled_noise"``).

Per-round counts are static functions of m (fractions rounded, the total
capped at m − 1), so a zero-count mode is absent from the step and a
disabled ``FaultConfig`` leaves a round bitwise untouched. The pick
consumes its own ``np.random.RandomState`` draws, the same numbers as the
reference's for every seed.

The scaled-noise row is ``scale·N(0, 1)`` from
``jax.random.PRNGKey(noise_seed)`` in the reference, which torch cannot
reproduce: the port draws it from a ``torch.Generator`` seeded with
``noise_seed`` on the block's device, or takes the draw injected in
place of the seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BYZANTINE_MODES = ("sign_flip", "scaled_noise")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round client failure model; all fractions of clients-per-round.

    >>> cfg = FaultConfig(dropout=0.25, byzantine=0.25)
    >>> cfg.counts(8)
    (2, 0, 2)
    >>> keep, nan_m, byz_m, seed = cfg.pick(8, np.random.RandomState(0))
    >>> int(keep.sum()), int(nan_m.sum()), int(byz_m.sum())
    (6, 0, 2)
    """
    dropout: float = 0.0      # fraction whose update never arrives
    nonfinite: float = 0.0    # fraction uploading NaN gradients
    byzantine: float = 0.0    # fraction uploading adversarial gradients
    byzantine_mode: str = "sign_flip"   # or "scaled_noise"
    byzantine_scale: float = 10.0       # magnitude of the adversarial row
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout", "nonfinite", "byzantine"):
            f = getattr(self, name)
            if not 0.0 <= f < 1.0:
                raise ValueError(f"{name} fraction must be in [0, 1)")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"byzantine_mode must be one of "
                             f"{BYZANTINE_MODES}, got "
                             f"{self.byzantine_mode!r}")

    @property
    def enabled(self) -> bool:
        return (self.dropout > 0 or self.nonfinite > 0 or
                self.byzantine > 0)

    def counts(self, m: int) -> tuple:
        """Static per-round (dropped, nonfinite, byzantine) counts; the
        total is capped at m − 1 (at least one honest arriving client),
        shaving the overflow off byzantine, then nonfinite, then
        dropout."""
        ks = [int(round(f * m))
              for f in (self.dropout, self.nonfinite, self.byzantine)]
        over = max(0, sum(ks) - (m - 1))
        for i in (2, 1, 0):
            take = min(over, ks[i])
            ks[i] -= take
            over -= take
        return tuple(ks)

    def pick(self, m: int, rng: np.random.RandomState):
        """One round's failure assignment as host arrays: ``(keep,
        nan_mask, byz_mask, noise_seed)`` — a (m,) f32 arrival mask (0 =
        dropped), two (m,) bool masks and a uint32 seed for the
        scaled-noise draw. Roles are disjoint slices of one permutation,
        and the rng takes the same draws whichever modes are on."""
        kd, kn, kb = self.counts(m)
        perm = rng.permutation(m)
        keep = np.ones((m,), np.float32)
        keep[perm[:kd]] = 0.0
        nan_mask = np.zeros((m,), bool)
        nan_mask[perm[kd:kd + kn]] = True
        byz_mask = np.zeros((m,), bool)
        byz_mask[perm[kd + kn:kd + kn + kb]] = True
        seed = np.uint32(rng.randint(0, 2**31 - 1))
        return keep, nan_mask, byz_mask, seed


def apply_faults(cfg: FaultConfig, G, w, fault):
    """Apply one round's failure assignment to the (m, N) gradient block,
    IN PLACE, row by row (the block is the step's own temporary).

    ``fault`` is a ``cfg.pick`` tuple of host arrays; its last entry is
    the noise seed, or an injected (m, N) standard-normal draw. Returns
    ``(G, w_agg, w_rep)``: the corrupted block, the aggregation weights
    (dropped rows zeroed) and the metric weights (renormalized over the
    arrived clients, only when rows were dropped). Each transform runs
    only when its static count is nonzero. Row-wise writes give the bits
    of the reference's ``where``: the sign flip multiplies by
    ``(−scale)`` cast to the block's dtype, a NaN row is NaN in that
    dtype."""
    keep, nan_mask, byz_mask, noise = fault
    kd, kn, kb = cfg.counts(G.shape[0])
    if kb:
        rows = np.flatnonzero(np.asarray(byz_mask))
        if cfg.byzantine_mode == "sign_flip":
            s = float(torch.tensor(-cfg.byzantine_scale,
                                   dtype=torch.float32).to(G.dtype))
            for u in rows:
                G[u].mul_(s)
        else:
            scale = torch.tensor(cfg.byzantine_scale, dtype=torch.float32,
                                 device=G.device)
            gen = None
            if not isinstance(noise, torch.Tensor):
                gen = torch.Generator(device=G.device)
                gen.manual_seed(int(noise))
            for u in rows:
                z = (noise[u].to(G.device) if gen is None else torch.randn(
                    G.shape[1:], generator=gen, dtype=torch.float32,
                    device=G.device))
                G[u].copy_((scale * z).to(G.dtype))
    if kn:
        for u in np.flatnonzero(np.asarray(nan_mask)):
            G[u].fill_(float("nan"))
    if kd:
        w_agg = w * torch.as_tensor(keep, dtype=w.dtype, device=w.device)
        w_rep = w_agg / torch.sum(w_agg)
    else:
        w_agg = w_rep = w
    return G, w_agg, w_rep
