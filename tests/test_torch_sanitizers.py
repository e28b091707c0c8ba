"""The port's runtime sanitizers (`repro_torch.analysis.sanitizers`), as
`tests/test_sanitizers.py` holds the reference's.

The lock sanitizer wraps the port's live `ClientRegistry` and is
exercised two ways under a K = 8 `WorkerPool`: the real registry (every
shared-state write under its leaf lock, so no violation) and a planted
unguarded write (detected, attributed to a worker thread, and fatal
under `assert_guarded`). The tensor guard that `run_comparison` runs
under ``REPRO_SANITIZE=1`` raises on a tensor planted in a record,
naming whether it is fake, functorch-wrapped or a plain tensor, and a
clean FEMNIST comparison at a dry-run size passes it; `no_tracer_leaks`
fails on a fake tensor left in the RoPE cache.

Serial time: ~10 s.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.analysis.sanitizers import (SanitizedLock, TracerLeakError,
                                             UnguardedAccessError,
                                             assert_guarded,
                                             assert_no_tracers,
                                             cross_thread_violations,
                                             guard_shared_state,
                                             no_tracer_leaks,
                                             sanitizers_enabled, tensor_kind,
                                             unguarded_writes)
from repro_torch.data.federated import ClientData
from repro_torch.data.registry import ClientRegistry, IndependentClientSource
from repro_torch.federated.async_engine import WORKER_THREAD_NAME, WorkerPool

K = 8          # worker threads
N_CLIENTS = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: under the tier-1 command's
    workers a comparison on every core runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_client(rng) -> ClientData:
    x = rng.normal(size=(6, 3)).astype(np.float32)
    y = rng.randint(0, 3, size=6)
    return ClientData(x, y)


def make_registry(cache=16) -> ClientRegistry:
    src = IndependentClientSource(tiny_client, N_CLIENTS, seed=7)
    return ClientRegistry(src, num_classes=3, cache_clients=cache)


# ---- SanitizedLock -------------------------------------------------------

def test_held_by_me_tracks_owner():
    lock = SanitizedLock()
    assert not lock.held_by_me()
    with lock:
        assert lock.held_by_me() and lock.locked()
    assert not lock.held_by_me() and not lock.locked()


def test_other_thread_is_not_owner():
    lock = SanitizedLock()
    seen = {}
    with lock:
        t = threading.Thread(
            target=lambda: seen.update(held=lock.held_by_me()))
        t.start()
        t.join()
    assert seen["held"] is False


# ---- lock-assert sanitizer under K = 8 workers --------------------------

def test_clean_registry_has_no_violations_under_k8():
    """The port's registry, hammered by K = 8 pool workers: every write
    to the cache and the counters goes through ``with self._lock:``, so
    the sanitizer records nothing."""
    reg = guard_shared_state(make_registry(cache=8))
    pool = WorkerPool(lambda i: reg[i].n, workers=K)
    try:
        ids = list(range(N_CLIENTS)) * 3    # misses, hits and evictions
        out = pool.map(ids, label="sanitizer-smoke")
    finally:
        pool.close()
    assert len(out) == len(ids)
    assert cross_thread_violations(reg) == []
    assert_guarded(reg)
    stats = reg.cache_stats()
    assert stats["hits"] + stats["misses"] >= len(ids)
    assert stats["peak_resident"] <= 8


def test_planted_unguarded_write_detected_under_k8():
    """The race the sanitizer exists for: workers write a counter
    attribute without taking the registry's lock."""
    reg = guard_shared_state(make_registry(cache=8))

    def racy(i):
        n = reg[i].n            # the lock-guarded path
        reg._hits = reg._hits   # an unguarded shared-state write
        return n

    pool = WorkerPool(racy, workers=K)
    try:
        pool.map(list(range(N_CLIENTS)), label="planted-race")
    finally:
        pool.close()
    bad = cross_thread_violations(reg)
    assert bad, "planted unguarded write was not detected"
    assert all(v.attr == "_hits" and v.cross_thread for v in bad)
    assert any(WORKER_THREAD_NAME in v.thread_name for v in bad)
    with pytest.raises(UnguardedAccessError) as ei:
        assert_guarded(reg)
    assert "_hits" in str(ei.value)


def test_owner_thread_unguarded_write_recorded_not_cross():
    reg = guard_shared_state(make_registry())
    reg._peak = 99              # unguarded, but on the owning thread
    assert unguarded_writes(reg) and not cross_thread_violations(reg)
    assert_guarded(reg)
    with pytest.raises(UnguardedAccessError):
        assert_guarded(reg, cross_thread_only=False)


def test_registry_still_correct_after_instrumentation():
    plain, wrapped = make_registry(), guard_shared_state(make_registry())
    for i in (0, 17, 63):
        np.testing.assert_array_equal(plain[i].x, wrapped[i].x)
    assert type(wrapped).__name__ == "SanitizedClientRegistry"


def test_guard_refuses_held_lock():
    reg = make_registry()
    with reg._lock:
        with pytest.raises(RuntimeError):
            guard_shared_state(reg)


# ---- tensor-leak guard ---------------------------------------------------

def _vmap_leak():
    leak = []

    def f(x):
        leak.append(x * 2)      # a BatchedTensor escapes the vmap
        return x + 1

    torch.func.vmap(f)(torch.ones(3, 2))
    return leak[0]


def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return torch.ones(3)


@pytest.mark.parametrize("kind", ["host", "wrapped", "fake"])
def test_planted_tensor_in_a_record_raises(kind):
    t = {"host": lambda: torch.tensor(0.5), "wrapped": _vmap_leak,
         "fake": _fake}[kind]()
    assert tensor_kind(t) == kind
    record = {"history": [{"round": 1, "query_loss": 0.7},
                          {"round": 2, "query_loss": t}]}
    with pytest.raises(TracerLeakError) as ei:
        assert_no_tracers(record, where="fixture record")
    assert "fixture record" in str(ei.value) and f"({kind}," in str(ei.value)


def test_host_data_passes():
    assert_no_tracers({"round": 3, "acc": 0.91,
                       "phi": [np.zeros(4), np.ones(2)], "seq": (1, 2.0)})


def test_no_tracer_leaks_fails_on_a_fake_tensor_in_the_rope_cache():
    from repro_torch.models import layers
    key = ("fixture", 0.0, "meta")
    with no_tracer_leaks():
        layers.apply_rope(torch.ones(1, 2, 1, 4), torch.arange(2)[None],
                          1e4)
    try:
        with pytest.raises(TracerLeakError, match="_INV_FREQ"):
            with no_tracer_leaks():
                layers._INV_FREQ[key] = _fake()
    finally:
        layers._INV_FREQ.pop(key, None)


def test_env_gate(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitizers_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitizers_enabled()


def _dry_plan():
    from repro_torch.launch.compare import comparison_plan
    return dataclasses.replace(
        comparison_plan("femnist", rounds=2, eval_every=1),
        num_clients=40, eval_clients_cap=4)


def test_clean_femnist_comparison_passes_the_guard(monkeypatch):
    from repro_torch.federated.experiment import run_comparison
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    out = run_comparison(_dry_plan(), device="cpu")
    assert set(out["methods"]) == set(_dry_plan().methods)


def test_record_guard_raises_under_the_gate(monkeypatch):
    """A tensor planted in a trainer's history reaches the guard in
    `run_comparison` under ``REPRO_SANITIZE=1``, and passes without the
    gate."""
    from repro_torch.federated import experiment
    plan = dataclasses.replace(_dry_plan(), methods=("fomaml",))
    orig = experiment.make_trainer

    def planted(*a, **kw):
        tr = orig(*a, **kw)
        run = tr.run

        def run_and_plant(*ra, **rk):
            state = run(*ra, **rk)
            tr.history[-1]["query_loss"] = torch.tensor(
                tr.history[-1]["query_loss"])
            return state

        tr.run = run_and_plant
        return tr

    monkeypatch.setattr(experiment, "make_trainer", planted)
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    experiment.run_comparison(plan, device="cpu")
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with pytest.raises(TracerLeakError, match="femnist/fomaml record"):
        experiment.run_comparison(plan, device="cpu")
