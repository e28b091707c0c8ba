"""Port: the worker pool and the shared retry loop
(`federated/async_engine.py`), port against port and against the JAX
package.

The reference's pool cases (`tests/test_worker_pool.py`): the retry
loop and its backoff schedule; a pool of K > 1 workers maps in order,
retries transient failures, names the item and label of a permanent one
with the worker's exception chained, times a stuck task out, refuses a
dead pool, and leaks no thread whatever fails. On the trainer: a bare
pool (``pool_workers > 0``, the population plane off) only pre-warms the
upcoming picks, so the history equals the pool-less run bitwise, under
prefetch too; a failing client surfaces as `WorkerPoolError` naming the
round and the pool is shut down. The population plane's knobs run
beside a pool (its own cases are in `tests/test_torch_population.py`)."""
import threading

import jax
import numpy as np
import pytest

from repro.core import classification_loss as jax_cls_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data.federated import ClientData as JaxClientData
from repro.federated import async_engine as jax_ae
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.federated import async_engine as ae
from repro_torch.federated.async_engine import (PREFETCH_THREAD_NAME,
                                                WORKER_THREAD_NAME,
                                                PrefetchError, WorkerPool,
                                                WorkerPoolError,
                                                call_with_retry)
from repro_torch.federated.server import FederatedTrainer
from repro_torch.optim import adam
from tests.test_torch_async_engine import (EVAL, EVAL_ARRAYS, EVAL_FN,
                                           LOSS_FN, TRAIN, TRAIN_ARRAYS,
                                           _jax_tiny_init, _TinyModel,
                                           _trainer,
                                           _one_torch_thread)  # noqa: F401


def _no_pool_threads():
    return all(not t.name.startswith((WORKER_THREAD_NAME,
                                      PREFETCH_THREAD_NAME))
               for t in threading.enumerate())


# ---- the shared retry loop ------------------------------------------------

def test_call_with_retry():
    err, out, n = call_with_retry(lambda: 42, max_retries=3, backoff=0)
    assert (err, out, n) == (None, 42, 1)

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    err, out, n = call_with_retry(flaky, max_retries=5, backoff=0)
    assert (err, out, n) == (None, "ok", 3)

    boom = RuntimeError("permanent")

    def dead():
        raise boom

    err, out, n = call_with_retry(dead, max_retries=2, backoff=0)
    assert err is boom and out is None and n == 3

    stop = threading.Event()
    stop.set()
    assert call_with_retry(lambda: 1, max_retries=0, backoff=0,
                           stop=stop) is None


def test_call_with_retry_backoff_schedule(monkeypatch):
    """backoff · 2^attempt between attempts, as the reference sleeps."""
    sleeps = []     # both modules sleep through the one `time` module
    monkeypatch.setattr(ae.time, "sleep", sleeps.append)
    assert jax_ae.time is ae.time

    def dead():
        raise OSError("x")

    call_with_retry(dead, max_retries=3, backoff=0.1)
    got = list(sleeps)
    jax_ae.call_with_retry(dead, max_retries=3, backoff=0.1)
    assert got == sleeps[3:] == pytest.approx([0.1, 0.2, 0.4])


def test_names_and_error_types_match_reference():
    assert PREFETCH_THREAD_NAME == jax_ae.PREFETCH_THREAD_NAME
    assert WORKER_THREAD_NAME == jax_ae.WORKER_THREAD_NAME
    assert issubclass(WorkerPoolError, PrefetchError)
    assert issubclass(PrefetchError, RuntimeError)


# ---- worker pool lifecycle -------------------------------------------------

def test_pool_map_in_order_k4():
    pool = WorkerPool(lambda i: i * i, workers=4)
    try:
        assert pool.map(range(20)) == [i * i for i in range(20)]
        assert pool.map([]) == []
    finally:
        pool.close()
    assert not pool.alive
    assert _no_pool_threads()


def test_pool_transient_failure_retries():
    calls, lock = {}, threading.Lock()

    def flaky(i):
        with lock:
            calls[i] = calls.get(i, 0) + 1
            if i == 2 and calls[i] < 3:
                raise OSError("transient")
        return i

    pool = WorkerPool(flaky, workers=2, max_retries=3, retry_backoff=0.0)
    try:
        assert pool.map([1, 2, 3]) == [1, 2, 3]
    finally:
        pool.close()
    assert calls[2] == 3
    assert _no_pool_threads()


def test_pool_permanent_failure_names_label_and_chains_cause():
    def dead(i):
        if i == 7:
            raise ValueError("shard corrupt")
        return i

    pool = WorkerPool(dead, workers=3, max_retries=1, retry_backoff=0.0)
    try:
        with pytest.raises(WorkerPoolError, match=r"7.*round 5") as ei:
            pool.map([1, 7, 3], label="round 5")
        assert isinstance(ei.value.__cause__, ValueError)
        assert "shard corrupt" in str(ei.value.__cause__)
        assert "2 attempt(s)" in str(ei.value)
    finally:
        pool.close()
    assert _no_pool_threads()


def test_pool_task_timeout():
    release = threading.Event()

    def stuck(i):
        if i == 1:
            release.wait(5.0)
        return i

    pool = WorkerPool(stuck, workers=2, task_timeout=0.2)
    try:
        with pytest.raises(WorkerPoolError, match="task timeout"):
            pool.map([0, 1], label="round 9")
    finally:
        release.set()
        pool.close()
    assert _no_pool_threads()


def test_pool_dead_pool_raises_instead_of_deadlocking():
    pool = WorkerPool(lambda i: i, workers=2)
    pool.close()
    with pytest.raises(WorkerPoolError):
        pool.map([1])
    assert _no_pool_threads()
    with pytest.raises(ValueError, match="workers"):
        WorkerPool(lambda i: i, workers=0)


# ---- the trainer ----------------------------------------------------------

def test_bare_pool_is_bit_identical():
    """pool_workers > 0 with the population plane off only pre-warms the
    upcoming picks: the history equals the pool-less run exactly, with
    and without prefetching."""
    def run(**kw):
        tr = _trainer(**kw)
        tr.run(tr.init(0, _TinyModel.init), 5, eval_every=0)
        return tr.history

    base = run()
    assert run(pool_workers=3) == base
    assert run(pool_workers=2, prefetch_depth=2, flush_every=2) == base
    assert _no_pool_threads()


def test_peek_picks_are_the_next_draw():
    """The pre-warm's peek returns the next task batch's client picks
    without moving the stream."""
    tr = _trainer()
    st = tr._rng.get_state()
    peek = tr._peek_picks()
    assert np.array_equal(tr._rng.get_state()[1], st[1])
    from repro_torch.data.federated import sample_task_batch
    tb = sample_task_batch(TRAIN, 4, 0.5, 8, 8, tr._rng)
    np.testing.assert_array_equal(peek, tb.client_idx)


def test_step_exception_shuts_down_pool_k3():
    """A step raising mid-run with 3 pool workers and prefetch leaks
    neither pool nor prefetch threads, and the rounds before it are
    flushed."""
    tr = _trainer(pool_workers=3, prefetch_depth=2, flush_every=0)
    state = tr.init(0, _TinyModel.init)
    real_step, calls = tr._step, []

    def boom(st, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("client exploded")
        return real_step(st, *a, **kw)

    tr._step = boom
    with pytest.raises(RuntimeError, match="client exploded"):
        tr.run(state, 8)
    assert _no_pool_threads()
    assert tr._pool is None
    assert [r["round"] for r in tr.history] == [1, 2]


def test_pool_client_failure_surfaces_at_run():
    """A client whose shard cannot be read surfaces as WorkerPoolError
    naming the round, its cause chained, and the pool shuts down."""
    class Exploding:
        def __len__(self):
            return len(TRAIN)

        def __getitem__(self, i):
            raise OSError("disk gone")

    algo = make_algorithm("fomaml", LOSS_FN, EVAL_FN, inner_lr=0.05)
    tr = FederatedTrainer(algo, adam(1e-3), Exploding(), 4,
                          support_frac=0.5, support_size=8, query_size=8,
                          seed=0, packed=True, pool_workers=2,
                          pool_retries=1, device="cpu")
    state = tr.init(0, None, phi={"theta": _TinyModel.init(0)})
    with pytest.raises(WorkerPoolError, match="round 1") as ei:
        tr.run(state, 3)
    assert isinstance(ei.value.__cause__, OSError)
    assert _no_pool_threads()


def test_bare_pool_run_matches_reference():
    """A bare-pool run with prefetching in both packages, from the
    reference's initial φ: the records at rtol 1e-5, bytes exact."""
    jalgo = jax_make_algorithm("fomaml", *jax_cls_loss(
        lambda p, x: x @ p["w"] + p["b"]), inner_lr=0.05)
    jtr = JaxTrainer(jalgo, jax_adam(1e-3),
                     [JaxClientData(x, y) for x, y in TRAIN_ARRAYS], 4,
                     support_frac=0.5, support_size=8, query_size=8, seed=0,
                     packed=True, impl="xla", pool_workers=2,
                     prefetch_depth=2)
    jstate = jtr.init(jax.random.PRNGKey(0), _jax_tiny_init)
    theta = jax.tree.map(np.asarray, jtr.phi_tree(jstate))
    jtr.run(jstate, 4, eval_every=2, eval_clients=[
        JaxClientData(x, y) for x, y in EVAL_ARRAYS])
    tr = _trainer(pool_workers=2, prefetch_depth=2)
    tr.run(tr.init(0, None, phi=from_numpy_tree(theta, "cpu")), 4,
           eval_every=2, eval_clients=EVAL)
    for a, b in zip(tr.history, jtr.history, strict=True):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "client_GFLOPs":
                continue
            if isinstance(b[k], int) or k.endswith("_MB"):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert _no_pool_threads()


@pytest.mark.parametrize("kw", [{"unreliability": "model"},
                                {"over_select": 0.5},
                                {"round_deadline": 2.0}],
                         ids=["unreliability", "over_select",
                              "round_deadline"])
def test_population_knobs_run_beside_a_pool(kw):
    """Each of the population plane's three knobs is accepted beside a
    pool, upgrades the mean to the masked mean with the guard on (as the
    reference does), and a run records every round's participation and
    leaks no thread."""
    from repro_torch.federated.population import UnreliabilityConfig
    if "unreliability" in kw:
        kw = {"unreliability": UnreliabilityConfig(fail_rate=0.3, seed=7)}
    tr = _trainer(pool_workers=2, **kw)
    assert (tr.aggregator, tr.guard) == ("masked_mean", True)
    assert tr._breaker is not None
    tr.run(tr.init(0, _TinyModel.init), 3)
    n_cand = 6 if "over_select" in kw else 4
    assert [r["selected"] for r in tr.history] == [n_cand] * 3
    assert all(0 <= r["arrived"] <= 4 for r in tr.history)
    assert tr.comm.summary()["selected_total"] == 3 * n_cand
    assert _no_pool_threads()
