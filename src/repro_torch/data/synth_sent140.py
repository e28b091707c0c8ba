"""Synthetic Sent140-like federated sentiment classification (numpy),
the port's own copy of `repro/data/synth_sent140.py`.

LEAF Sent140: each twitter user is a client; 2-class sentiment over
25-token tweets (paper Table 1: 3,790 clients, ~45 samples/client).

Generator: a global vocabulary where each word has a latent sentiment
score shared across all users; a tweet's label is sign(sum of scores +
user_bias). Each client has a strong personal decision bias (one inner
step on the support set captures it), a mild topical skew over a broad
word distribution, and a small set of polarity-flipped words. A single
global model cannot represent the per-user bias; FedMeta's adapted
models can. The draws are the reference's, call for call, so a seed
gives the same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.registry import registry_from_body


def _sent140_client(word_score, base, vocab, seq_len, mean_samples,
                    rng) -> ClientData:
    """One user's tweet shard — the per-client generator body."""
    topic = 0.5 * base + 0.5 * rng.dirichlet(np.ones(vocab) * 2.0)
    user_bias = rng.normal(0, 1.2)
    flip = np.ones(vocab, np.float32)
    n_flip = rng.randint(0, vocab // 20)
    flip[rng.choice(vocab, size=n_flip, replace=False)] = -1.0
    n = int(np.clip(rng.lognormal(np.log(mean_samples), 0.6), 10,
                    6 * mean_samples))
    xs = rng.choice(vocab, size=(n, seq_len), p=topic).astype(np.int32)
    score = ((word_score[xs] * flip[xs]).sum(axis=1) / np.sqrt(seq_len)
             + user_bias)
    ys = (score > 0).astype(np.int32)
    return ClientData(xs, ys)


def make_sent140(num_clients: int = 150, seq_len: int = 25,
                 vocab: int = 2000, mean_samples: int = 45,
                 seed: int = 0, *, lazy: bool = False,
                 independent: bool = False,
                 cache_clients=None):
    """Eager `FederatedDataset` of (n, seq_len) int32 token rows and
    binary labels, or with ``lazy=True`` a `ClientRegistry` over the same
    per-client body (see `make_femnist`)."""
    rng = np.random.RandomState(seed)
    word_score = rng.normal(0, 1, size=vocab).astype(np.float32)
    base = np.ones(vocab) / vocab

    def body(r):
        return _sent140_client(word_score, base, vocab, seq_len,
                               mean_samples, r)

    if lazy:
        return registry_from_body(body, num_clients, 2, "synth-sent140",
                                  rng=rng, seed=seed,
                                  independent=independent,
                                  cache_clients=cache_clients)
    clients = [body(rng) for _ in range(num_clients)]
    return FederatedDataset(clients, 2, name="synth-sent140")
