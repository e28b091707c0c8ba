"""The paper's experiment models (Appendix A.1), counterpart of
`repro/models/paper/models.py`.

- FEMNIST CNN: two 5x5 conv layers (32, 64 ch) each + 2x2 maxpool, a
  dense layer and a 62-way head.
- Shakespeare: stacked 2-layer char-LSTM (paper: 256 hidden, 8-d
  embedding).
- Sent140: 2-layer LSTM (paper: 100 hidden), a learned 64-d embedding
  in place of GloVe.
- Recommendation: LR and one-hidden-layer NN (64 units), paper §4.3.

Parameters keep the reference's dicts, so a JAX φ loads through
`convert.from_numpy_tree` with no remapping. The CNN's conv weights are
HWIO and its inputs NHWC at the public function; `apply` permutes to
NCHW for `F.conv2d` and back before the flatten, so ``fc1``'s rows
follow the reference's (7, 7, 64) order. Each LSTM layer is one
``{"w": (d_in + hidden, 4·hidden), "b"}``: ``[x_t, h] @ w + b`` split
as the i, f, g, o gates, the forget gate biased by +1.0 (not
`nn.LSTM`'s layout, gate order or biases). The reference's `lax.scan`
over time is a Python loop that rebinds ``h`` and ``c`` and updates
nothing in place, so the same code runs under `torch.func.vmap` and
autograd, twice differentiated for MAML.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import Rng, as_dtype, dense_init, embed_init


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


# ----------------------------------------------------------------- LSTM

def _lstm_layer_init(rng: Rng, d_in: int, hidden: int, dtype):
    return {"w": dense_init(rng, d_in + hidden, 4 * hidden, dtype),
            "b": torch.zeros((4 * hidden,), dtype=as_dtype(dtype),
                             device=rng.device)}


def _lstm_layer(params, xs, hidden: int):
    """xs: (B, L, d_in) -> (B, L, hidden)."""
    h = xs.new_zeros((xs.shape[0], hidden))
    c = h
    hs = []
    for t in range(xs.shape[1]):
        z = torch.cat([xs[:, t], h], dim=-1) @ params["w"] + params["b"]
        i, f, g, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _stacked_lstm(vocab: int, embed_dim: int, hidden: int, num_layers: int,
                  num_classes: int, dtype, name: str, device) -> Model:
    def init(key):
        rng = Rng(key, device=device)
        p = {"embed": embed_init(rng, vocab, embed_dim, dtype)}
        d_in = embed_dim
        for l in range(num_layers):
            p[f"lstm{l}"] = _lstm_layer_init(rng, d_in, hidden, dtype)
            d_in = hidden
        p["out"] = {"w": dense_init(rng, hidden, num_classes, dtype),
                    "b": torch.zeros((num_classes,), dtype=as_dtype(dtype),
                                     device=device)}
        return p

    def apply(params, x):
        h = F.embedding(x, params["embed"])          # (B, L, e)
        for l in range(num_layers):
            h = _lstm_layer(params[f"lstm{l}"], h, hidden)
        return h[:, -1] @ params["out"]["w"] + params["out"]["b"]

    return Model(init, apply, name)


def char_lstm(vocab: int = 70, num_classes: int | None = None,
              hidden: int = 256, embed_dim: int = 8,
              dtype=torch.float32, device="cuda") -> Model:
    return _stacked_lstm(vocab, embed_dim, hidden, 2, num_classes or vocab,
                         dtype, "char_lstm", device)


def sent_lstm(vocab: int = 2000, hidden: int = 100, embed_dim: int = 64,
              dtype=torch.float32, device="cuda") -> Model:
    return _stacked_lstm(vocab, embed_dim, hidden, 2, 2, dtype, "sent_lstm",
                         device)


# -------------------------------------------------------------- rec task

def rec_lr(feat_dim: int, num_classes: int, dtype=torch.float32,
           device="cuda") -> Model:
    def init(key):
        rng = Rng(key, device=device)
        return {"w": dense_init(rng, feat_dim, num_classes, dtype),
                "b": torch.zeros((num_classes,), dtype=as_dtype(dtype),
                                 device=device)}

    def apply(params, x):
        return x @ params["w"] + params["b"]

    return Model(init, apply, "rec_lr")


def rec_nn(feat_dim: int, num_classes: int, hidden: int = 64,
           dtype=torch.float32, device="cuda") -> Model:
    def init(key):
        rng = Rng(key, device=device)
        zeros = dict(dtype=as_dtype(dtype), device=device)
        return {"w1": dense_init(rng, feat_dim, hidden, dtype),
                "b1": torch.zeros((hidden,), **zeros),
                "w2": dense_init(rng, hidden, num_classes, dtype),
                "b2": torch.zeros((num_classes,), **zeros)}

    def apply(params, x):
        h = F.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]

    return Model(init, apply, "rec_nn")
