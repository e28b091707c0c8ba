"""Synthetic Shakespeare-like federated next-character prediction
(numpy), the port's own copy of `repro/data/synth_shakespeare.py`.

LEAF Shakespeare: each speaking role is a client; next-char prediction
over a ~70-symbol vocabulary (paper Table 1 / A.1: 528 clients, ~1183
samples/client with a huge σ).

Generator: a global order-1 Markov chain over the vocabulary, peaked
(2–4 likely successors a symbol), and a per-client *role voice*: a
sparse boost of some transitions. Local adaptation captures the voice; a
global model only the average chain. Each example is (context[seq_len]
int32, next_char int32). The draws are the reference's, call for call.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.registry import registry_from_body

VOCAB = 70


def _row_normalize(m):
    return m / m.sum(axis=1, keepdims=True)


def make_shakespeare(num_clients: int = 60, seq_len: int = 40,
                     mean_samples: int = 300, vocab: int = VOCAB,
                     seed: int = 0, *, lazy: bool = False,
                     independent: bool = False,
                     cache_clients=None):
    """Eager `FederatedDataset`, or with ``lazy=True`` a `ClientRegistry`
    over the same per-client body (see `make_femnist`)."""
    rng = np.random.RandomState(seed)
    # the global language: each symbol has 2-4 likely successors with
    # ~85% of the mass
    base = rng.gamma(0.05, 1.0, size=(vocab, vocab)) + 1e-4
    for r in range(vocab):
        k = rng.randint(2, 5)
        peaks = rng.choice(vocab, size=k, replace=False)
        base[r, peaks] += rng.dirichlet(np.ones(k)) * 6.0
    base = _row_normalize(base)

    def body(r):
        return _shakespeare_client(base, vocab, seq_len, mean_samples, r)

    if lazy:
        return registry_from_body(body, num_clients, vocab,
                                  "synth-shakespeare", rng=rng, seed=seed,
                                  independent=independent,
                                  cache_clients=cache_clients)
    clients = [body(rng) for _ in range(num_clients)]
    return FederatedDataset(clients, vocab, name="synth-shakespeare")


def _shakespeare_client(base, vocab, seq_len, mean_samples,
                        rng) -> ClientData:
    """One role's line shard — the per-client generator body."""
    voice = base.copy()
    k = rng.randint(5, 20)
    rows = rng.randint(0, vocab, size=k)
    cols = rng.randint(0, vocab, size=k)
    voice[rows, cols] += rng.uniform(2.0, 6.0, size=k)
    voice = _row_normalize(voice)
    n = int(np.clip(rng.lognormal(np.log(mean_samples), 0.8), 20,
                    8 * mean_samples))
    # one long stream, then overlapping contexts
    stream = np.zeros(n + seq_len + 1, np.int32)
    stream[0] = rng.randint(vocab)
    cdf = np.cumsum(voice, axis=1)
    u = rng.random_sample(n + seq_len)
    for t in range(1, n + seq_len + 1):
        stream[t] = np.searchsorted(cdf[stream[t - 1]], u[t - 1])
    xs = np.stack([stream[i:i + seq_len] for i in range(n)])
    ys = stream[seq_len:seq_len + n]
    return ClientData(xs.astype(np.int32), ys.astype(np.int32))
