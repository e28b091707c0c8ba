"""Per-client language-model personalization tasks (numpy), the port's
own copy of `repro/data/lm_tasks.py`.

Each client is a task whose private corpus is a "dialect" of a shared
synthetic language: a client-specific permutation of a slice of the
vocabulary over an order-1 token chain. The meta-learner trains an
initialization that adapts to a new client's dialect in a few inner
steps.

  * `make_lm_task_batch` — a fixed-shape `LMTaskBatch` (support and
    query token tensors per client);
  * `make_lm_clients` — the same generator behind `FederatedDataset`, so
    LM personalization runs through `run_comparison` like any other
    scenario (with `core/losses.lm_pair_loss`).

The draws are the reference's, call for call.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.registry import registry_from_body


class LMTaskBatch(NamedTuple):
    support_tokens: np.ndarray  # (m, S, L) int32
    query_tokens: np.ndarray    # (m, Q, L) int32


def _sample_stream(rng, length, vocab, trans_sparsity=0.2):
    # cheap order-1 chain via per-token candidate jumps
    stream = np.zeros(length, np.int32)
    stream[0] = rng.randint(vocab)
    jumps = rng.randint(0, vocab, size=length)
    stay = rng.random_sample(length) < trans_sparsity
    for t in range(1, length):
        stream[t] = (stream[t - 1] + 1) % vocab if stay[t] else jumps[t]
    return stream


def _dialect_perm(rng, vocab):
    """A client dialect: permutation of a random slice of the vocab."""
    perm = np.arange(vocab)
    sl = rng.choice(vocab, size=max(2, vocab // 8), replace=False)
    perm[sl] = rng.permutation(sl)
    return perm


def make_lm_task_batch(num_clients: int, support_seqs: int, query_seqs: int,
                       seq_len: int, vocab: int, seed: int = 0) -> LMTaskBatch:
    """Fixed-shape batch of per-client token tasks."""
    rng = np.random.RandomState(seed)
    sup = np.zeros((num_clients, support_seqs, seq_len), np.int32)
    qry = np.zeros((num_clients, query_seqs, seq_len), np.int32)
    for c in range(num_clients):
        perm = _dialect_perm(rng, vocab)
        for i in range(support_seqs):
            sup[c, i] = perm[_sample_stream(rng, seq_len, vocab)]
        for i in range(query_seqs):
            qry[c, i] = perm[_sample_stream(rng, seq_len, vocab)]
    return LMTaskBatch(sup, qry)


def _lm_client(mean_seqs, seq_len, vocab, rng) -> ClientData:
    """One client's dialect corpus — the per-client generator body."""
    perm = _dialect_perm(rng, vocab)
    n = mean_seqs + rng.randint(mean_seqs)
    seqs = np.stack([perm[_sample_stream(rng, seq_len, vocab)]
                     for _ in range(n)]).astype(np.int32)
    return ClientData(seqs, seqs[:, -1].copy())


def make_lm_clients(num_clients: int = 32, mean_seqs: int = 24,
                    seq_len: int = 16, vocab: int = 64, seed: int = 0,
                    *, lazy: bool = False, independent: bool = False,
                    cache_clients=None):
    """Per-client dialect corpora as a `FederatedDataset`: ``x`` is the
    (n, seq_len) int32 token matrix, ``y`` each sequence's last token (a
    stand-in label: `lm_pair_loss` trains on the shifted sequence and
    never reads it). ``n`` is in [mean_seqs, 2·mean_seqs). ``lazy=True``
    gives a `ClientRegistry` over the same per-client body (see
    `make_femnist`)."""
    rng = np.random.RandomState(seed)

    def body(r):
        return _lm_client(mean_seqs, seq_len, vocab, r)

    if lazy:
        return registry_from_body(body, num_clients, vocab,
                                  "synth-lm-dialects", rng=rng, seed=seed,
                                  independent=independent,
                                  cache_clients=cache_clients)
    clients = [body(rng) for _ in range(num_clients)]
    return FederatedDataset(clients, vocab, name="synth-lm-dialects")
