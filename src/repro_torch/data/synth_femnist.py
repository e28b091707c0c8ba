"""Synthetic FEMNIST-like federated image dataset (numpy), the port's
own copy of `repro/data/synth_femnist.py`.

LEAF's FEMNIST partitions 62-class handwritten characters by *writer*;
statistics (paper Table 1): 1,068 clients, ~220 samples/client (σ≈90),
9–62 classes per client. This generator reproduces the structure without
the raw data (offline container):

- each class has a global prototype image (smooth random blob pattern),
- each *writer* (client) applies a personal style: a fixed affine warp +
  stroke-thickness bias + per-writer contrast, shared across all of that
  writer's samples — so per-client adaptation genuinely helps,
- per-client class subsets are skewed (Dirichlet over classes, truncated),
- samples-per-client is lognormal, matching a heavy-ish tail.

Images are (H, W) float32 in [0, 1]; default 28x28 like FEMNIST.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset


def _class_prototypes(num_classes: int, size: int, rng: np.random.RandomState):
    """Smooth random patterns: low-freq Fourier blobs per class."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    protos = np.zeros((num_classes, size, size), np.float32)
    for c in range(num_classes):
        img = np.zeros((size, size), np.float32)
        for _ in range(4):
            fx, fy = rng.uniform(1, 4, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.5, 1.0)
            img += amp * np.sin(2 * np.pi * fx * xx + px) * np.sin(2 * np.pi * fy * yy + py)
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        protos[c] = img
    return protos


def _affine_warp(img: np.ndarray, theta: float, shear: float, scale: float):
    """Nearest-neighbour affine warp about the image centre (pure numpy)."""
    size = img.shape[0]
    c = (size - 1) / 2.0
    ct, st = np.cos(theta), np.sin(theta)
    # inverse transform sampling
    a = np.array([[ct, -st + shear], [st, ct]], np.float32) / scale
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    ys = a[0, 0] * (yy - c) + a[0, 1] * (xx - c) + c
    xs = a[1, 0] * (yy - c) + a[1, 1] * (xx - c) + c
    ys = np.clip(np.round(ys).astype(int), 0, size - 1)
    xs = np.clip(np.round(xs).astype(int), 0, size - 1)
    return img[ys, xs]


def _femnist_client(protos, num_classes, image_size, mean_samples,
                    rng) -> ClientData:
    """One writer's local shard — the per-client generator body (same
    draw sequence the eager loop always made)."""
    # writer style (fixed per client)
    theta = rng.uniform(-0.5, 0.5)
    shear = rng.uniform(-0.3, 0.3)
    scale = rng.uniform(0.8, 1.2)
    contrast = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-0.1, 0.1)
    # skewed class subset: between ~15% and 100% of classes
    k = rng.randint(max(2, num_classes // 7), num_classes + 1)
    classes = rng.choice(num_classes, size=k, replace=False)
    pvals = rng.dirichlet(np.ones(k) * 0.5)
    n = int(np.clip(rng.lognormal(np.log(mean_samples), 0.4), 8, 4 * mean_samples))
    ys = classes[rng.choice(k, size=n, p=pvals)]
    xs = np.zeros((n, image_size, image_size), np.float32)
    for i, y in enumerate(ys):
        img = _affine_warp(protos[y], theta, shear, scale)
        img = np.clip(contrast * img + bias + rng.normal(0, 0.15, img.shape), 0, 1)
        xs[i] = img
    return ClientData(xs.astype(np.float32), ys.astype(np.int32))


def make_femnist(num_clients: int = 120, num_classes: int = 62,
                 image_size: int = 28, mean_samples: int = 80,
                 seed: int = 0) -> FederatedDataset:
    """Eager `FederatedDataset`; the same draws, in the same order, as
    the reference's eager generator. (Its ``lazy=`` registry waits for the
    population slice.)"""
    rng = np.random.RandomState(seed)
    protos = _class_prototypes(num_classes, image_size, rng)
    clients = [_femnist_client(protos, num_classes, image_size,
                               mean_samples, rng)
               for _ in range(num_clients)]
    return FederatedDataset(clients, num_classes, name="synth-femnist")
