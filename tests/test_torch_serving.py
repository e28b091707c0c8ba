"""Port parity: the serving plane (traffic, adaptation cache, packed
adaptation, the whole engine) against the JAX package's, on the CPU.

Rows are f32 planes through a two-layer reduced LM: held at rtol 1e-4 /
atol 1e-5 against the reference (XLA and PyTorch sum the matmuls in
different orders). Tokens must be equal. Port-vs-port contracts — the
served row equals the solo adaptation — are bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.federated.serving import TrafficModel as JaxTraffic
from repro.federated.serving import support_digest as jax_digest
from repro.kernels.meta_update import ops as jax_mu
from repro.launch.serve import build_engine as jax_build_engine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.federated.serving import (AdaptationCache, ServeRequest,
                                           ServingEngine, TrafficModel,
                                           support_digest)
from repro_torch.launch.serve import build_engine, main as serve_main
from repro_torch.utils.flat import plane_for

NET = dict(rtol=1e-4, atol=1e-5)
TRAFFIC = [dict(num_clients=8, rate=10.0, support_sizes=(2, 4), seed=5),
           dict(num_clients=3, rate=50.0, think_time=0.05, hot_skew=1.2,
                seed=9),
           dict(num_clients=8, rate=32.0, support_sizes=(2, 4),
                think_time=0.01, seed=0)]


@pytest.mark.parametrize("kw", TRAFFIC, ids=["plain", "think", "chip"])
def test_arrival_table_matches_reference(kw):
    assert TrafficModel(**kw).arrival_table(40) == \
        JaxTraffic(**kw).arrival_table(40)


def _lm_payloads(vocab, L_sup=16, L_prompt=8):
    mk = lambda r, size: r.randint(0, vocab, (size, L_sup)).astype(np.int32)
    mp = lambda r: r.randint(0, vocab, (L_prompt,)).astype(np.int32)
    return mk, mp


def test_requests_and_digests_match_reference():
    mk, mp = _lm_payloads(512)
    kw = TRAFFIC[1]
    ours = TrafficModel(**kw).requests(12, mk, mp)
    theirs = JaxTraffic(**kw).requests(12, mk, mp)
    for a, b in zip(ours, theirs):
        assert (a.rid, a.client, a.arrival) == (b.rid, b.client, b.arrival)
        np.testing.assert_array_equal(a.support, b.support)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        # same digest string from a numpy, a torch and a jax leaf
        assert support_digest(a.support) == jax_digest(b.support)
        assert support_digest(torch.from_numpy(a.support)) == \
            jax_digest(jnp.asarray(b.support))


# ---- adaptation cache -----------------------------------------------------

def test_cache_hit_miss_lru_bound():
    cache = AdaptationCache(capacity=2)
    assert cache.get("a") is None
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1                      # a is now MRU
    cache.put("c", 3)                               # evicts b
    assert cache.get("b") is None
    assert cache.get("a") == 1 and cache.get("c") == 3
    s = cache.stats()
    assert (s["evictions"], s["peak_resident"], s["resident"]) == (1, 2, 2)
    assert (s["hits"], s["misses"]) == (3, 2)


def test_cache_validation_and_clear():
    with pytest.raises(ValueError):
        AdaptationCache(0)
    cache = AdaptationCache(None)
    for i in range(50):
        cache.put(i, i)
    assert len(cache) == 50
    cache.clear()
    assert len(cache) == 0 and cache.stats()["hits"] == 0


def _mlp_engine(adapt_batch, capacity=None, name="fomaml"):
    g = torch.Generator().manual_seed(0)
    theta = {"w1": torch.randn((6, 8), generator=g) * 0.1,
             "w2": torch.randn((8, 3), generator=g) * 0.1}

    def loss_fn(p, batch):
        x, y = batch
        return torch.mean((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    algo = make_algorithm(name, loss_fn, lambda p, b: (loss_fn(p, b), {}),
                          0.05, 2)
    phi = (algo.init_state(3, lambda k: theta) if name.startswith("meta-sgd")
           else {"theta": theta})
    return ServingEngine(algo, phi, adapt_batch=adapt_batch,
                         cache=AdaptationCache(capacity), device="cpu")


def _mlp_requests(n, sizes=(4,), seed=0):
    rng = np.random.RandomState(seed)
    return [ServeRequest(rid=i, client=i, arrival=float(i), support=(
        torch.from_numpy(rng.randn(sizes[i % len(sizes)], 6).astype(np.float32)),
        torch.from_numpy(rng.randn(sizes[i % len(sizes)], 3).astype(np.float32))))
        for i in range(n)]


@pytest.mark.parametrize("name", ["fomaml", "meta-sgd"])
def test_served_rows_equal_solo_adaptation_at_any_batch(name):
    """Rows are independent: every served row equals that client's solo
    adapt_packed bit for bit, at any adapt_batch and padding."""
    reqs = _mlp_requests(7, sizes=(3, 5))
    reports = []
    for b in (1, 2, 3):
        eng = _mlp_engine(b, name=name)
        reports.append(eng.serve(reqs))
    plane = plane_for(eng._phi["theta"])
    for rec, req in zip(reports[0].records, reqs):
        solo = plane.pack(eng.algo.adapt_packed(eng._phi, req.support))
        assert torch.equal(solo, rec["row"])
        tree = plane.pack(eng.algo.adapt(eng._phi, req.support))
        torch.testing.assert_close(tree, rec["row"], rtol=1e-6, atol=1e-7)
    for other in reports[1:]:
        for a, b in zip(reports[0].records, other.records):
            assert torch.equal(a["row"], b["row"])


def test_engine_cache_bound_replay_and_publish():
    reqs = _mlp_requests(6)
    eng = _mlp_engine(2, capacity=2)
    first = eng.serve(reqs)
    assert eng.cache.stats()["peak_resident"] == 2
    assert eng.cache.stats()["evictions"] == 4
    assert all(r["hit"] for r in eng.serve(reqs[4:]).records)
    replay = eng.serve(reqs)
    for a, b in zip(first.records, replay.records):
        assert torch.equal(a["row"], b["row"])
    eng.publish_phi(eng._phi)
    assert not any(r["hit"] for r in eng.serve(reqs[4:]).records)


# ---- against the reference engine -----------------------------------------

# one support shape: each further shape costs the reference one more
# trace and compile of the LM gradient (the port's bucketing by shape is
# covered by the MLP engine tests above)
SERVE_TRAFFIC = dict(num_clients=3, rate=50.0, support_sizes=(3,), seed=6)


@pytest.fixture(scope="module")
def reference_serve():
    """One reduced serve by the reference engine, shared by the parity
    tests below (tracing the reference dominates their cost). Each flush
    is the engine's `jax.jit(adapt_packed_batch)` with the meta-update
    impl set to `pallas_interpret` (and restored); decode runs the
    flash-decode kernel in interpret mode."""
    jcfg = jax_reduced_config(jax_get_config("smollm-360m"))
    tcfg = reduced_config(get_config("smollm-360m"))
    jengine = jax_build_engine(jcfg, adapt_batch=2, seed=0,
                               decode_impl="pallas_interpret")
    tphi = {"theta": from_numpy_tree(
        jax.tree.map(np.asarray, jengine._phi["theta"]), "cpu")}
    mk, mp = _lm_payloads(jcfg.vocab_size)
    reqs = JaxTraffic(**SERVE_TRAFFIC).requests(5, mk, mp)
    prev = jax_mu.get_default_impl()
    jax_mu.set_default_impl("pallas_interpret")
    try:
        jrep = jengine.serve(reqs, max_new_tokens=3)
    finally:
        jax_mu.set_default_impl(prev)
    return tcfg, tphi, reqs, jrep


def test_adapt_packed_batch_matches_reference_pallas(reference_serve):
    """The port's `adapt_packed_batch` over the misses' supports, as one
    batch, against the rows the reference's jitted flushes produced (a
    full flush and a padded one)."""
    tcfg, tphi, reqs, jrep = reference_serve
    by_rid = {r.rid: r for r in reqs}
    misses = [rec for rec in jrep.records if not rec["hit"]]
    assert [rec["batch_fill"] for rec in misses] == [2, 2, 1]
    sups = np.stack([by_rid[rec["rid"]].support for rec in misses])
    engine = build_engine(tcfg, tphi, adapt_batch=2, device="cpu")
    trows = engine.algo.adapt_packed_batch(tphi, torch.from_numpy(sups))
    np.testing.assert_allclose(
        trows.numpy(), np.stack([np.asarray(rec["row"]) for rec in misses]),
        **NET)


def test_build_engine_serve_matches_reference_engine(reference_serve):
    """The whole reduced serve: same φ, same traffic — rows allclose and
    the generated tokens equal to the reference engine's."""
    tcfg, tphi, _, jrep = reference_serve
    mk, mp = _lm_payloads(tcfg.vocab_size)
    engine = build_engine(tcfg, tphi, adapt_batch=2, device="cpu")
    trep = engine.serve(TrafficModel(**SERVE_TRAFFIC).requests(5, mk, mp),
                        max_new_tokens=3)
    assert [r["rid"] for r in trep.records] == [r["rid"] for r in jrep.records]
    assert [r["hit"] for r in trep.records] == [r["hit"] for r in jrep.records]
    for t, j in zip(trep.records, jrep.records):
        np.testing.assert_allclose(t["row"].numpy(), np.asarray(j["row"]),
                                   **NET)
        np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))
        assert t["decode_ms"] >= 0.0
    s = trep.summary()
    assert s["requests"] == 5 and "decode_p50_ms" in s
    assert s["hits"] == jrep.summary()["hits"]


def test_build_engine_meta_sgd_state_and_adapt_impl():
    tcfg = reduced_config(get_config("smollm-360m"))
    engine = build_engine(tcfg, algo_name="meta-sgd", adapt_batch=1,
                          adapt_impl="torch", device="cpu")
    alpha = engine._phi["alpha"]["embed"]
    assert alpha.dtype == torch.float32
    assert float(alpha.min()) >= 0.5 * 0.05 and float(alpha.max()) <= 1.5 * 0.05
    mk, mp = _lm_payloads(tcfg.vocab_size)
    reqs = TrafficModel(num_clients=2, seed=3).requests(2, mk, mp)
    rep = engine.serve(reqs, max_new_tokens=2)
    assert all(torch.isfinite(r["row"]).all() for r in rep.records)
    assert all(r["tokens"].shape == (2,) for r in rep.records)


def test_launch_serve_main_reduced_cpu(capsys):
    serve_main(["--arch", "smollm-360m", "--reduced", "--steps", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decode step 0" in out and "decode step 1" in out
    assert "logits (2, 512)" in out
