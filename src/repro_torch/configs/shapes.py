"""Assigned input shapes (copy of `repro/configs/shapes.py`).

  decode_32k   seq_len=32,768   global_batch=128   -> decode_step (1 new
                                                      token, KV cache 32k)

The port's serve launcher reads the decode shapes; the train and
prefill shapes are listed so the names match the reference's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"
    clients_per_round: int = 0
    seqs_per_client: int = 0     # support + query per client

    def __post_init__(self):
        if self.kind == "train":
            assert self.clients_per_round * self.seqs_per_client == self.global_batch


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train",
                           clients_per_round=8, seqs_per_client=32),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
