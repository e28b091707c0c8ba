"""Byte accounting for the federated protocol (counterpart of
`repro/federated/comm.py:31-141`).

  per round: download = m · bytes(φ), upload = m · bytes(g_u)

g_u matches φ structurally for every algorithm of Algorithm 1; when the
packed pipeline ships a reduced-precision gradient block (``block_dtype``
bf16) the upload leg counts the block's dtype. Byte counts equal the
reference's exactly. Client FLOPs are not counted in the port yet
(``flops_per_client`` stays 0, so ``client_GFLOPs`` reads 0): the
reference measures them with XLA cost analysis. The population plane's
participation log and the codec label join with their slices.
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

    @property
    def download_bytes(self) -> int:
        return self.rounds * self.clients_per_round * self.phi_bytes

    @property
    def upload_bytes(self) -> int:
        per_client = (self.grad_bytes if self.grad_bytes is not None
                      else self.phi_bytes)
        return self.rounds * self.clients_per_round * per_client

    @property
    def total_bytes(self) -> int:
        return self.download_bytes + self.upload_bytes

    @property
    def total_flops(self) -> float:
        return self.rounds * self.clients_per_round * self.flops_per_client

    def summary_at(self, rounds: int) -> dict:
        """The cumulative summary as of round ``rounds`` — a pure
        function of the round index."""
        snap = self if rounds == self.rounds else dataclasses.replace(
            self, rounds=rounds)
        return {
            "rounds": snap.rounds,
            "comm_MB": snap.total_bytes / 1e6,
            "upload_MB": snap.upload_bytes / 1e6,
            "download_MB": snap.download_bytes / 1e6,
            "client_GFLOPs": snap.total_flops / 1e9,
            "phi_MB": self.phi_bytes / 1e6,
        }

    def summary(self) -> dict:
        return self.summary_at(self.rounds)
