"""Port parity: the lazy client registry (`data/registry.py`) against the
JAX package's.

Every source draws from numpy, so the port's registries give the
reference's clients bit for bit: the sequential mode replays the eager
generator's stream (lazy == eager == the reference's lazy registry, for
all five generators, through a cache of 2), the independent mode seeds
client i from `SeedSequence((seed, i))` as the reference does, and a
shard directory written by either package loads in the other. Then the
registry's own contract, port against port: the LRU stays bounded over
a 10^5-client sweep, K racing threads synthesize a client once, index
and transform views compose under the size check, `localize_clients`
over a view is the reference's, and the validation errors are the
reference's. Tolerance: none; every comparison is exact."""
import threading

import numpy as np
import pytest

import repro.data as R
import repro_torch.data as T
from repro.data import registry as jreg
from repro_torch.data import registry as treg
from repro_torch.data.federated import ClientData, FederatedDataset

MAKERS = {
    "femnist": ("make_femnist", dict(num_clients=10, num_classes=5,
                                     image_size=8, mean_samples=12,
                                     seed=3)),
    "sent140": ("make_sent140", dict(num_clients=10, seq_len=6, vocab=50,
                                     mean_samples=12, seed=3)),
    "shakespeare": ("make_shakespeare", dict(num_clients=8, seq_len=8,
                                             mean_samples=20, seed=3)),
    "recommend": ("make_recommend", dict(num_clients=10, num_services=60,
                                         ctx_dim=4, mean_records=20,
                                         seed=3)),
    "lm": ("make_lm_clients", dict(num_clients=10, mean_seqs=8, seq_len=6,
                                   vocab=20, seed=3)),
}


def _make(pkg, case, **kw):
    name, base = MAKERS[case]
    return getattr(pkg, name)(**base, **kw)


def _same(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


def _tiny_body(rng):
    return ClientData(rng.normal(0, 1, (3, 2)).astype(np.float32),
                      np.array([0, 1, 0], np.int64))


@pytest.mark.parametrize("case", list(MAKERS))
def test_lazy_registries_bitwise_equal_to_reference(case):
    """Sequential: the port's lazy registry (cache of 2, so most reads
    replay a snapshot) equals its eager dataset and the reference's lazy
    registry, client for client, and its splits are the reference's.
    Independent: client for client the reference's, in reverse order
    (nothing depends on access order)."""
    eager = _make(T, case)
    lazy = _make(T, case, lazy=True, cache_clients=2)
    ref = _make(R, case, lazy=True, cache_clients=2)
    assert isinstance(lazy, treg.ClientRegistry)
    assert (len(lazy), lazy.num_classes, lazy.name) == \
        (len(ref), ref.num_classes, ref.name)
    for i in range(len(lazy)):
        _same(lazy[i], eager.clients[i])
        _same(lazy[i], ref[i])
    assert lazy.cache_stats()["peak_resident"] <= 2
    for tv, jv in zip(lazy.split_clients(seed=1), ref.split_clients(seed=1)):
        assert tv._indices == jv._indices
        for a, b in zip(tv, jv):
            _same(a, b)
    ind = _make(T, case, lazy=True, independent=True, cache_clients=3)
    jind = _make(R, case, lazy=True, independent=True, cache_clients=3)
    for i in reversed(range(len(ind))):
        _same(ind[i], jind[i])
    assert ind.cache_stats() == jind.cache_stats()


def test_cache_counters_match_reference():
    """One access pattern through both packages' registries: the same
    hits, misses, evictions and residency."""
    t = _make(T, "sent140", lazy=True, cache_clients=3)
    j = _make(R, "sent140", lazy=True, cache_clients=3)
    for i in (0, 9, 9, 4, 0, 7, 8, 1, 9, -1, 3, 3):
        _same(t[i], j[i])
    assert t.cache_stats() == j.cache_stats()
    assert t.stats() == j.stats()
    assert t.stats(max_clients=4) == j.stats(max_clients=4)
    snap = t.materialize()
    assert isinstance(snap, FederatedDataset)
    assert snap.stats() == R.make_sent140(**MAKERS["sent140"][1]).stats()


def test_lru_bound_under_1e5_sweep():
    """An independent registry over 10^5 clients: no construction pass,
    and a sparse sweep of the whole range and a dense window larger than
    the cache keep the resident set at the cap; client i is a pure
    function of (seed, i), the reference's."""
    def body(rng):
        y = rng.randint(0, 2, size=4).astype(np.int64)
        return ClientData(rng.normal(0, 1, (4, 2)).astype(np.float32), y)

    n = 100_000
    reg = treg.registry_from_body(body, n, 2, "pop", independent=True,
                                  seed=9, cache_clients=64)
    assert len(reg) == n
    for i in range(0, n, 997):
        assert reg[i].n == 4
    for i in range(5_000, 5_000 + 512):
        reg[i]
    st = reg.cache_stats()
    assert st["peak_resident"] == st["resident"] == 64
    assert st["evictions"] == st["misses"] - 64
    _same(reg[31_337], jreg.IndependentClientSource(body, n, 9).get(31_337))
    assert not np.array_equal(reg[31_337].x, reg[31_336].x)


def test_concurrent_access_synthesizes_once():
    """8 threads racing for the same clients synthesize each once (the
    in-flight event) and all read the same arrays."""
    calls, lock = [], threading.Lock()

    def body(rng):
        with lock:
            calls.append(1)
        return _tiny_body(rng)

    reg = treg.registry_from_body(body, 8, 2, "x", independent=True,
                                  cache_clients=8)
    results, errors = [], []

    def hit():
        try:
            for i in (5, 5, 5, 2):
                results.append((i, reg[i].x))
        except Exception as e:   # noqa: BLE001 — reported by the assert
            errors.append(e)

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(calls) == 2           # clients 5 and 2, once each
    assert len(results) == 32
    for i, x in results:
        np.testing.assert_array_equal(x, reg[i].x)


def test_failed_synthesis_releases_waiters():
    """A source that raises wakes the threads waiting on that client and
    leaves no in-flight entry, so the next read tries again."""
    state = {"fail": True}

    def body(rng):
        if state["fail"]:
            raise OSError("disk gone")
        return _tiny_body(rng)

    reg = treg.registry_from_body(body, 4, 2, "x", independent=True)
    with pytest.raises(OSError):
        reg[1]
    state["fail"] = False
    assert reg[1].n == 3
    assert reg.cache_stats()["misses"] == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shards_round_trip_across_packages(tmp_path, writer):
    """A shard directory written by either package loads in both, client
    for client, behind a bounded cache."""
    eager = _make(T, "lm")
    save = (treg if writer == "port" else jreg).save_shards
    path = save(eager.clients, str(tmp_path), eager.num_classes,
                name="lm-shards")
    assert path.endswith("index.json")
    for load in (treg.load_shard_registry, jreg.load_shard_registry):
        reg = load(str(tmp_path), cache_clients=3)
        assert (len(reg), reg.num_classes, reg.name) == \
            (len(eager.clients), eager.num_classes, "lm-shards")
        for i in range(len(reg)):
            _same(reg[i], eager.clients[i])
        assert reg.cache_stats()["peak_resident"] <= 3


def test_views_and_localize_over_a_view_match_reference():
    """Index views (slices, splits) and transform views: the port's and
    the reference's give the same clients; `localize_clients` over a lazy
    split is a lazy view equal to the reference's, and a chain of views
    composes."""
    t = _make(T, "recommend", lazy=True, cache_clients=4)
    j = _make(R, "recommend", lazy=True, cache_clients=4)
    (tt, tv, _), (jt, jv, _) = t.split_clients(0), j.split_clients(0)
    tl, jl = T.localize_clients(tt, 40), R.localize_clients(jt, 40)
    assert isinstance(tl, treg.RegistryView) and tl.num_classes == 40
    assert len(tl) == len(jl) == len(tt)
    for i in range(len(tl)):
        _same(tl[i], jl[i])
        assert tl[i].n == tt[i].n
        np.testing.assert_array_equal(tl[i].x, tt[i].x)
    _same(T.localize_clients(t, 40)[3], R.localize_clients(j, 40)[3])
    for a, b in zip(tl[1:3], jl[1:3]):
        _same(a, b)
    # the lazy view of the whole registry is the eager list's remap
    eager = T.make_recommend(**MAKERS["recommend"][1])
    for a, b in zip(T.localize_clients(t, 40),
                    T.localize_clients(eager.clients, 40)):
        _same(a, b)
    # a view of a view chains the transforms
    flip = t.view(lambda c: ClientData(c.x, c.y + 1))
    back = flip.view(lambda c: ClientData(c.x, c.y - 1))
    _same(back[5], t[5])
    assert flip.num_classes == t.num_classes and flip.name == t.name


def test_validation_matches_reference():
    """The reference's refusals, message for message: a cache of 0, a
    sequential registry without its rng, an index past the end, and a
    view that changes a client's size (also inside a chain)."""
    for pkg in (treg, jreg):
        with pytest.raises(ValueError, match="cache_clients must be >= 1"):
            pkg.registry_from_body(_tiny_body, 4, 2, "x", independent=True,
                                   cache_clients=0)
        with pytest.raises(ValueError, match="needs the generator's rng"):
            pkg.registry_from_body(_tiny_body, 4, 2, "x")
        reg = pkg.registry_from_body(_tiny_body, 4, 2, "x",
                                     independent=True)
        with pytest.raises(IndexError):
            reg[4]
        with pytest.raises(IndexError):
            reg[-5]
        sl = reg[1:3]
        assert type(sl).__name__ == "RegistryView" and len(sl) == 2
        np.testing.assert_array_equal(sl[0].x, reg[1].x)
        np.testing.assert_array_equal(reg[-1].x, reg[3].x)
        bad = reg.view(lambda c: ClientData(c.x[:1], c.y[:1]))
        with pytest.raises(ValueError, match="preserve client sizes"):
            bad[0]
        with pytest.raises(ValueError, match="preserve client sizes"):
            bad.view(lambda c: c)[0]
