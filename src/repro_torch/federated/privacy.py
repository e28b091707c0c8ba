"""Central differential privacy for the FedMeta upload path (counterpart
of `repro/federated/privacy.py:34-116`).

Clipped Gaussian DP (DP-FedAvg style, on meta-gradients): each client's
g_u is clipped to norm S, the clipped rows are averaged with the
aggregation weights, and N(0, σ²) with σ = noise_multiplier · S / m is
added to the mean. The packed step applies the clip as a weight scale
(clipping row u by c is scaling its weight by c), so the clipped
aggregate runs through the unchanged K2.

Noise: `jax.random` draws cannot be reproduced in torch, so each round's
noise comes from a `torch.Generator` seeded from ``(seed, round)`` — a
pure function of the round index, as the reference's
``fold_in(PRNGKey(seed), round)`` is. Every function that draws accepts
the draw as a tensor instead, so the parity tests hand in the
reference's own draw.

Secure aggregation (`masked_uploads`, `secure_sum`,
`repro/federated/privacy.py:121-145`) simulates the pairwise-mask
protocol: each pair of clients (lo, hi) shares a mask M, client lo
adds it and client hi subtracts it, so the masks cancel in the sum. The
masks come in as draws keyed by (lo, hi) (`pair_masks` draws them from
a torch.Generator), for the same reason as the DP noise: a test hands
in the reference's own ``_pair_mask`` draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.pytree import tree_flatten, tree_map, tree_norm, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Central-DP knob for the packed pipeline.

    σ = noise_multiplier · clip_norm / m is the uniform-mean
    Gaussian-mechanism accounting; with data-count weights the
    worst-case per-client sensitivity is max_u w_u·S, so runs that
    target a formal ε set ``weighted=False`` on the trainer."""
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")
        if self.noise_multiplier < 0:
            raise ValueError("noise_multiplier must be >= 0, got "
                             f"{self.noise_multiplier}")

    def sigma(self, num_clients: int) -> float:
        """σ_effective of the noise added to the aggregated mean."""
        return self.noise_multiplier * self.clip_norm / num_clients

    def round_seed(self, round_: int) -> int:
        """The round's generator seed, a pure function of (seed, round)."""
        return int(np.random.SeedSequence(
            (int(self.seed), int(round_))).generate_state(1, np.uint64)[0])

    def round_generator(self, round_: int, device="cuda") -> torch.Generator:
        """A fresh generator on ``device`` for the round's noise draw."""
        gen = torch.Generator(device=device)
        gen.manual_seed(self.round_seed(round_))
        return gen


def gaussian(shape, noise, device) -> torch.Tensor:
    """A standard-normal f32 draw of ``shape``: ``noise`` itself when it
    is an injected tensor, else a draw from it (a torch.Generator, or
    None for the default generator)."""
    if isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"injected noise has shape "
                             f"{tuple(noise.shape)}, expected {tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return torch.randn(shape, dtype=torch.float32, device=device,
                       generator=noise)


def dp_clip_factors(row_norms, clip_norm: float):
    """(m,) per-row L2 norms -> (m,) clip factors min(1, S/‖g_u‖).

    Scaling the aggregation weights by these factors IS the per-client
    clip (`clip_gradient`'s epsilon guard kept identical)."""
    s = torch.full_like(row_norms, float(clip_norm))
    return torch.clamp(s / (row_norms + 1e-12), max=1.0)


def clip_gradient(g, clip_norm: float):
    """Per-client L2 clip: (g * min(1, S/‖g‖), ‖g‖)."""
    norm = tree_norm(g)
    scale = torch.clamp(torch.full_like(norm, float(clip_norm))
                        / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x * scale, g), norm


def add_gaussian_noise(g, noise, noise_multiplier: float, clip_norm: float,
                       num_clients: int):
    """Central-DP Gaussian mechanism on the aggregated mean of clipped
    per-client gradients, σ = noise_multiplier · S / m. ``noise``: a
    torch.Generator (one draw per leaf, in leaf order) or a tree of
    standard-normal tensors matching ``g`` (injected draws)."""
    sigma = noise_multiplier * clip_norm / num_clients
    leaves, treedef = tree_flatten(g)
    if isinstance(noise, torch.Generator) or noise is None:
        draws = [gaussian(x.shape, noise, x.device) for x in leaves]
    else:
        draws = tree_flatten(noise)[0]
    return tree_unflatten(treedef, [x + sigma * z for x, z in
                                    zip(leaves, draws, strict=True)])


def dp_aggregate(client_grads, weights, noise, *, clip_norm: float,
                 noise_multiplier: float):
    """client_grads: tree with a leading client axis m. Returns the
    DP-protected weighted mean (``noise`` as in `add_gaussian_noise`)."""
    m = tree_flatten(client_grads)[0][0].shape[0]
    w = weights.float() / torch.sum(weights.float())
    clipped = [clip_gradient(tree_map(lambda x, i=i: x[i], client_grads),
                             clip_norm)[0] for i in range(m)]

    def mean(*xs):
        acc = w[0] * xs[0].float()
        for i in range(1, m):
            acc = acc + w[i] * xs[i].float()
        return acc

    return add_gaussian_noise(tree_map(mean, *clipped), noise,
                              noise_multiplier, clip_norm, m)


# ------------------------------------------------------- secure aggregation

def pair_masks(m: int, like, noise=None) -> dict:
    """Standard-normal f32 masks for every client pair: {(lo, hi): tree
    shaped as ``like`` (one client's gradient)}, drawn pair by pair in
    (lo, hi) order, leaf by leaf, from ``noise`` (a torch.Generator, or
    None for the default generator)."""
    leaves, treedef = tree_flatten(like)
    return {(lo, hi): tree_unflatten(treedef, [
                gaussian(x.shape, noise, x.device) for x in leaves])
            for lo in range(m) for hi in range(lo + 1, m)}


def masked_uploads(client_grads, masks) -> list:
    """Per-client uploads g_u + Σ_{v>u} M_uv − Σ_{v<u} M_vu, the masks
    added in ascending v (the reference's order); ``masks[(lo, hi)]`` is
    the pair's mask tree (`pair_masks`, or injected draws)."""
    m = tree_flatten(client_grads)[0][0].shape[0]
    uploads = []
    for u in range(m):
        masked = tree_map(lambda x: x[u].float(), client_grads)
        for v in range(m):
            if v == u:
                continue
            sign = 1.0 if u < v else -1.0
            masked = tree_map(lambda x, mk, s=sign: x + s * mk.float(),
                              masked, masks[(min(u, v), max(u, v))])
        uploads.append(masked)
    return uploads


def secure_sum(uploads):
    """The server's sum of the masked uploads: Σ_u g_u, the masks
    cancelled (up to f32 rounding)."""
    return tree_map(lambda *xs: sum(xs), *uploads)
