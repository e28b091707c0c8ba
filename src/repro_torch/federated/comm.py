"""Byte accounting for the federated protocol (counterpart of
`repro/federated/comm.py`).

  per round: download = m · bytes(φ), upload = m · bytes(g_u)

g_u matches φ structurally for every algorithm of Algorithm 1; when the
packed pipeline ships a reduced-precision gradient block (``block_dtype``
bf16) the upload leg counts the block's dtype, and under an upload codec
the trainer sets the codec-true bytes (payload + side information) and
the codec's label. Byte counts equal the reference's exactly. Client
FLOPs are counted by `measure_client_flops` (PyTorch's
`FlopCounterMode`: matmuls and convolutions only), where the reference
uses XLA's cost analysis, so ``client_GFLOPs`` differs between the two.

Under the population plane the trainer records each round's
participation (selected, arrived, quarantined): download then charges
every selected candidate (φ went to each), upload and client FLOPs only
the arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.utils.pytree import tree_bytes, tree_size


@dataclasses.dataclass
class CommTracker:
    phi_bytes: int
    clients_per_round: int
    flops_per_client: float = 0.0
    rounds: int = 0
    # bytes of one client's uploaded gradient; None = same as φ
    grad_bytes: Optional[int] = None
    # codec tag ("int8+ef", "topk0.05+ef") in summaries; None = a dense
    # upload (the key is then left out)
    codec: Optional[str] = None
    # population plane: one (selected, arrived, quarantined) entry a
    # round, appended when the round is staged (possibly rounds ahead of
    # `tick` under prefetching); empty = the fixed cohort (rounds · m)
    participation: list = dataclasses.field(default_factory=list)

    @classmethod
    def for_state(cls, phi, clients_per_round: int,
                  flops_per_client: float = 0.0, block_dtype=None):
        grad_bytes = None
        if block_dtype is not None:
            itemsize = torch.empty((), dtype=block_dtype).element_size()
            grad_bytes = tree_size(phi) * itemsize
        return cls(tree_bytes(phi), clients_per_round, flops_per_client,
                   grad_bytes=grad_bytes)

    def tick(self, rounds: int = 1):
        self.rounds += rounds

    def record_round(self, selected: int, arrived: int,
                     quarantined: int = 0):
        """Record one round's participation. `summary_at` reads only the
        first ``rounds`` entries, so the accounting stays a pure function
        of the round index."""
        self.participation.append((int(selected), int(arrived),
                                   int(quarantined)))

    def _counts_at(self, rounds: int):
        """(selected, arrived) client-round totals as of ``rounds``."""
        if not self.participation:
            n = rounds * self.clients_per_round
            return n, n
        k = min(rounds, len(self.participation))
        sel = sum(p[0] for p in self.participation[:k])
        arr = sum(p[1] for p in self.participation[:k])
        extra = max(0, rounds - k) * self.clients_per_round
        return sel + extra, arr + extra

    @property
    def download_bytes(self) -> int:
        return self._counts_at(self.rounds)[0] * self.phi_bytes

    @property
    def upload_bytes(self) -> int:
        per_client = (self.grad_bytes if self.grad_bytes is not None
                      else self.phi_bytes)
        return self._counts_at(self.rounds)[1] * per_client

    @property
    def total_bytes(self) -> int:
        return self.download_bytes + self.upload_bytes

    @property
    def total_flops(self) -> float:
        return self._counts_at(self.rounds)[1] * self.flops_per_client

    def summary_at(self, rounds: int) -> dict:
        """The cumulative summary as of round ``rounds`` — a pure
        function of the round index."""
        snap = self if rounds == self.rounds else dataclasses.replace(
            self, rounds=rounds)
        out = {
            "rounds": snap.rounds,
            "comm_MB": snap.total_bytes / 1e6,
            "upload_MB": snap.upload_bytes / 1e6,
            "download_MB": snap.download_bytes / 1e6,
            "client_GFLOPs": snap.total_flops / 1e9,
            "phi_MB": self.phi_bytes / 1e6,
        }
        if self.codec is not None:
            out["codec"] = self.codec
        if self.participation and rounds >= 1:
            r = min(rounds, len(self.participation)) - 1
            sel_r, arr_r, quar_r = self.participation[r]
            cum_sel, cum_arr = self._counts_at(rounds)
            # this round's participation and the running totals
            out.update(selected=sel_r, arrived=arr_r,
                       quarantined=quar_r, selected_total=cum_sel,
                       arrived_total=cum_arr)
        return out

    def summary(self) -> dict:
        return self.summary_at(self.rounds)


def measure_client_flops(fn, *args) -> float:
    """FLOPs of one call of ``fn`` as PyTorch's `FlopCounterMode` counts
    them (matmuls and convolutions, forward and backward). The
    reference counts with XLA's cost analysis, which also counts
    elementwise work, so the two differ."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
