"""The paper's experiment models (Appendix A.1): this slice ports the
FEMNIST CNN (counterpart of `repro/models/paper/models.py:21-71`).

Parameters keep the reference's dict — conv weights HWIO, ``c1``/``c2``/
``fc1``/``out`` — so a JAX φ loads through `convert.from_numpy_tree`
with no remapping. Inputs stay NHWC at the public function; `apply`
permutes to NCHW for `F.conv2d` and back before the flatten, so
``fc1``'s rows follow the reference's (7, 7, 64) order. The char and
sentence LSTMs and the recommendation models wait for the scenario
slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import Rng, as_dtype, dense_init


class Model(NamedTuple):
    init: Callable          # (key) -> params
    apply: Callable         # (params, x) -> logits
    name: str


def femnist_cnn(num_classes: int = 62, image_size: int = 28,
                hidden: int = 256, dtype=torch.float32,
                device="cuda") -> Model:
    """Two 5x5 SAME convolutions (32, 64 channels), each with ReLU and
    a 2x2 max-pool, a dense layer of ``hidden`` units and the class
    head. init(key) draws on ``device`` (torch generators: the numbers
    differ from `jax.random`'s; parity tests load the reference's φ)."""
    dtype = as_dtype(dtype)
    feat_hw = image_size // 4

    def init(key):
        rng = Rng(key, device=device)

        def conv_w(kh, kw, cin, cout):
            w = torch.empty((kh, kw, cin, cout), dtype=torch.float32,
                            device=device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=rng.next())
            return (w / np.sqrt(kh * kw * cin)).to(dtype)

        def zeros(n):
            return torch.zeros((n,), dtype=dtype, device=device)

        return {
            "c1": {"w": conv_w(5, 5, 1, 32), "b": zeros(32)},
            "c2": {"w": conv_w(5, 5, 32, 64), "b": zeros(64)},
            "fc1": {"w": dense_init(rng, feat_hw * feat_hw * 64, hidden,
                                    dtype),
                    "b": zeros(hidden)},
            "out": {"w": dense_init(rng, hidden, num_classes, dtype),
                    "b": zeros(num_classes)},
        }

    def conv_pool(x, p):
        # HWIO -> OIHW; SAME padding of a 5x5 stride-1 kernel is 2
        y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding="same")
        return F.max_pool2d(F.relu(y), 2)

    def apply(params, x):
        if x.ndim == 3:
            x = x[..., None]                      # (B, H, W, 1)
        x = x.permute(0, 3, 1, 2)                 # NHWC -> NCHW
        x = conv_pool(conv_pool(x, params["c1"]), params["c2"])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
        return x @ params["out"]["w"] + params["out"]["b"]

    return Model(init, apply, "femnist_cnn")
