"""Synthetic production-like federated recommendation dataset (numpy),
the port's own copy of `repro/data/synth_recommend.py`.

Paper §4.3 / Table 1: 9,369 clients, 2,400 services, each client uses
2–36 services; the task is to predict the next service (top-k, cast as
classification). The paper's FedMeta uses a 40-way local classifier
over the client's own services where FedAvg needs a global one — the
size argument behind its Table 3.

Generator (scaled): ``num_services`` global services; each client uses
a small subset with a personal context -> service preference over a
shared low-rank structure, plus a recency boost for the last service.

Feature layout (dim = ctx_dim + num_services):
  [context features | one-hot of last-used service]
Label: global service id (`localize_clients` maps it to a local head).
The draws are the reference's, call for call.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.federated import ClientData, FederatedDataset
from repro_torch.data.registry import (ClientRegistry, RegistryView,
                                       registry_from_body)


def _recommend_client(U, V, num_services, ctx_dim, mean_records, rank,
                      rng) -> ClientData:
    """One user's usage-record shard — the per-client generator body."""
    feat_dim = ctx_dim + num_services
    k = rng.randint(2, 37)  # 2..36 services per client (paper)
    services = rng.choice(num_services, size=k, replace=False)
    taste = rng.normal(0, 1, size=(rank,)).astype(np.float32)
    n = int(np.clip(rng.lognormal(np.log(mean_records), 0.5), 30,
                    10 * mean_records))
    ctx = rng.normal(0, 1, size=(n, ctx_dim)).astype(np.float32)
    logits = (ctx @ U * taste) @ V[:, services]  # (n, k)
    ys_local = np.zeros(n, np.int64)
    last = rng.randint(k)
    for i in range(n):
        l = logits[i].copy()
        l[last] += 1.0  # recency
        p = np.exp(l - l.max())
        p /= p.sum()
        ys_local[i] = rng.choice(k, p=p)
        last = ys_local[i]
    ys = services[ys_local]
    x = np.zeros((n, feat_dim), np.float32)
    x[:, :ctx_dim] = ctx
    lasts = np.concatenate([[services[rng.randint(k)]], ys[:-1]])
    x[np.arange(n), ctx_dim + lasts] = 1.0
    return ClientData(x, ys.astype(np.int32))


def make_recommend(num_clients: int = 200, num_services: int = 120,
                   ctx_dim: int = 24, mean_records: int = 160,
                   rank: int = 8, seed: int = 0, *, lazy: bool = False,
                   independent: bool = False,
                   cache_clients=None):
    """Eager `FederatedDataset` labelled with global service ids, or with
    ``lazy=True`` a `ClientRegistry` over the same per-client body (see
    `make_femnist`)."""
    rng = np.random.RandomState(seed)
    U = rng.normal(0, 1, size=(ctx_dim, rank)).astype(np.float32)
    V = rng.normal(0, 1, size=(rank, num_services)).astype(np.float32)

    def body(r):
        return _recommend_client(U, V, num_services, ctx_dim, mean_records,
                                 rank, r)

    if lazy:
        return registry_from_body(body, num_clients, num_services,
                                  "synth-recommend", rng=rng, seed=seed,
                                  independent=independent,
                                  cache_clients=cache_clients)
    clients = [body(rng) for _ in range(num_clients)]
    return FederatedDataset(clients, num_services, name="synth-recommend")


def _localize_one(c: ClientData, head_size: int) -> ClientData:
    """One client's labels remapped to local ids 0..k-1 (the rank of the
    service in the client's sorted service set); features untouched."""
    services = np.unique(c.y)
    if len(services) > head_size:
        raise ValueError(f"client uses {len(services)} services > "
                         f"head_size {head_size}")
    lut = np.full(int(c.y.max()) + 1, -1, c.y.dtype)
    lut[services] = np.arange(len(services), dtype=c.y.dtype)
    return ClientData(c.x, lut[c.y])


def localize_clients(clients, head_size: int = 40):
    """Global service labels -> per-client local-head labels (paper
    §4.3): each client's labels become local ids ``0..k-1``, a mapping
    the client can build offline from its own history, so one
    ``head_size``-way model covers every client. Client order, features
    and example counts are kept, so the seeded sampling streams are the
    global view's. Raises ValueError if a client uses more than
    ``head_size`` services.

    A list gives the localized list; a `ClientRegistry` or `RegistryView`
    gives a lazy view (the remap runs on each access, nothing
    materializes)."""
    if isinstance(clients, (ClientRegistry, RegistryView)):
        return clients.view(lambda c: _localize_one(c, head_size),
                            num_classes=head_size)
    return [_localize_one(c, head_size) for c in clients]


def localize_recommend(ds: FederatedDataset,
                       head_size: int = 40) -> FederatedDataset:
    """`localize_clients` as a whole-dataset view (num_classes becomes
    the head size), through `FederatedDataset.view`'s order/size
    contract check."""
    return ds.view(lambda c: _localize_one(c, head_size),
                   num_classes=head_size, name=ds.name + "-local")
