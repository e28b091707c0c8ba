"""Port: the async round engine (`federated/async_engine.py`) and
staleness-aware aggregation, port against port and against the JAX
package.

Port against port, the reference's cases (`tests/test_async_engine.py`):
with staleness off, every pipelined configuration (prefetch, deferred
flushes, fused-K blocks) gives a history EQUAL record for record to the
synchronous loop's; staleness off is a bitwise no-op; jitter off is the
fixed path bitwise; the γ^s rule against hand-built aggregates; and the
prefetcher leaks no thread when either side raises.

Against the reference, from the same numpy clients and the reference's
initial φ: the straggler picks index for index (the same
`RandomState` draws), `TaskStream`/`stack_task_batches` bitwise, and a
staleness run of the tiny model (fixed and jitter, under prefetch) at
rtol 1e-5 (`tests/test_meta_step_paths.py:349-351`), bytes exact."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classification_loss as jax_cls_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data.federated import ClientData as JaxClientData
from repro.data.federated import TaskStream as JaxTaskStream
from repro.data.federated import stack_task_batches as jax_stack
from repro.federated.async_engine import StalenessConfig as JaxStaleness
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.core.fedmeta import (init_packed_state,
                                      make_packed_meta_train_step)
from repro_torch.core.losses import classification_loss
from repro_torch.data.federated import (ClientData, TaskStream,
                                        stack_task_batches)
from repro_torch.federated.async_engine import (PREFETCH_THREAD_NAME,
                                                AsyncRoundEngine,
                                                DeviceStager, Prefetcher,
                                                StalenessConfig, plan_blocks)
from repro_torch.federated.comm import CommTracker
from repro_torch.federated.fedavg import FedAvgTrainer
from repro_torch.federated.server import FederatedTrainer
from repro_torch.optim import adam, sgd
from repro_torch.utils.flat import plane_for

ALGOS = ("maml", "fomaml", "meta-sgd", "reptile")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and the tiny model's ops spread over every
    core in each of them spend most of their time waiting for each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _client_arrays(num=12, seed=0, feat=4, classes=2):
    rng = np.random.RandomState(seed)
    mu = rng.normal(0, 1, (classes, feat))
    out = []
    for _ in range(num):
        n = rng.randint(10, 24)
        y = rng.randint(0, classes, (n,))
        x = mu[y] + rng.normal(0, 0.3, (n, feat))
        out.append((x.astype(np.float32), y.astype(np.int64)))
    return out


TRAIN_ARRAYS, EVAL_ARRAYS = _client_arrays(), _client_arrays(6, seed=1)
TRAIN = [ClientData(x, y) for x, y in TRAIN_ARRAYS]
EVAL = [ClientData(x, y) for x, y in EVAL_ARRAYS]


class _TinyModel:
    """A 4 → 2 linear classifier; ``init(seed)`` draws from numpy."""

    @staticmethod
    def init(key):
        rng = np.random.RandomState(int(key) % (1 << 32))
        return {"w": torch.from_numpy(
                    (rng.normal(0, 1, (4, 2)) * 0.1).astype(np.float32)),
                "b": torch.zeros((2,))}

    @staticmethod
    def apply(params, x):
        return x @ params["w"] + params["b"]


LOSS_FN, EVAL_FN = classification_loss(_TinyModel.apply)


def _trainer(algo_name="fomaml", *, packed=True, **kw):
    algo = make_algorithm(algo_name, LOSS_FN, EVAL_FN, inner_lr=0.05)
    return FederatedTrainer(algo, adam(1e-3), TRAIN, 4, support_frac=0.5,
                            support_size=8, query_size=8, seed=0,
                            packed=packed, device="cpu", **kw)


def _fedmeta_history(algo_name, *, packed, rounds=6, eval_every=3, **kw):
    tr = _trainer(algo_name, packed=packed, **kw)
    state = tr.init(0, _TinyModel.init)
    tr.run(state, rounds, eval_every=eval_every, eval_clients=EVAL)
    return tr.history


def _no_prefetch_threads():
    return all(t.name != PREFETCH_THREAD_NAME for t in threading.enumerate())


# ---- bitwise: pipelined == synchronous ----------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["tree", "packed"])
@pytest.mark.parametrize("algo_name", ALGOS)
def test_pipelined_history_bit_identical(algo_name, packed):
    """prefetch_depth > 0 + deferred flushes == the synchronous loop,
    record for record (float equality), for all four meta-learners on
    both parameter representations."""
    sync = _fedmeta_history(algo_name, packed=packed)
    piped = _fedmeta_history(algo_name, packed=packed, prefetch_depth=2,
                             flush_every=4)
    assert piped == sync
    assert _no_prefetch_threads()


def test_fused_k_history_bit_identical():
    """Fused-K blocks == per-round stepping, with an eval round that does
    not divide the block size and a flush only at exit; φ bitwise too."""
    def run(**kw):
        tr = _trainer(**kw)
        state = tr.run(tr.init(0, _TinyModel.init), 7, eval_every=3,
                       eval_clients=EVAL)
        return tr.history, state

    (sync, s1), (fused, s2) = run(), run(fuse_rounds=3, prefetch_depth=1,
                                         flush_every=0)
    assert fused == sync
    assert torch.equal(s1["phi"], s2["phi"])
    assert torch.equal(s1["opt"]["step"], s2["opt"]["step"])


def test_fused_step_stacks_metrics_without_a_host_read(monkeypatch):
    """A fused block runs its K rounds with no `float()`/`.item()` on a
    metric: the step's metrics come back as (K,) tensors."""
    tr = _trainer(fuse_rounds=3)
    state = tr.init(0, _TinyModel.init)
    reads = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: reads.append(1) or 0.0)
    monkeypatch.setattr(torch.Tensor, "__float__",
                        lambda self: reads.append(1) or 0.0)
    stream = TaskStream(TRAIN, 4, 0.5, 8, 8, np.random.RandomState(0))
    staged, _ = tr._stage_block(stream, DeviceStager("cpu").put, 3, 1)
    _, mets = tr._fused_step(state, staged)
    assert not reads
    assert all(v.shape == (3,) for v in mets.values())


def test_fedavg_pipelined_history_bit_identical():
    def run(**kw):
        tr = FedAvgTrainer(LOSS_FN, EVAL_FN, local_lr=1e-2, local_steps=2,
                           train_clients=TRAIN, clients_per_round=4,
                           support_frac=0.5, support_size=8, query_size=8,
                           seed=0, device="cpu", **kw)
        state = tr.init(0, _TinyModel.init)
        tr.run(state, 6, eval_every=3, eval_clients=EVAL)
        return tr.history

    assert run(prefetch_depth=2, flush_every=3) == run()
    assert _no_prefetch_threads()


def test_plan_blocks():
    assert plan_blocks(5, 0, 1) == [1] * 5
    assert plan_blocks(10, 4, 3) == [3, 1, 3, 1, 2]   # eval rounds 4, 8
    assert plan_blocks(6, 2, 8) == [2, 2, 2]          # evals cap blocks
    assert plan_blocks(7, 3, 2) == [2, 1, 2, 1, 1]
    assert sum(plan_blocks(97, 10, 8)) == 97


# ---- staleness-aware aggregation -----------------------------------------

def _args(tb):
    return ((torch.from_numpy(tb.support_x), torch.from_numpy(tb.support_y)),
            (torch.from_numpy(tb.query_x), torch.from_numpy(tb.query_y)),
            torch.from_numpy(tb.weight))


def _rows(algo, plane, tb, phi_tree, m=3):
    return [plane.pack(algo.client_grad(
        phi_tree, (torch.from_numpy(tb.support_x[i]),
                   torch.from_numpy(tb.support_y[i])),
        (torch.from_numpy(tb.query_x[i]),
         torch.from_numpy(tb.query_y[i])))[0]).double().numpy()
        for i in range(m)]


def _sel(*xs):
    return tuple(np.asarray(x, np.int32) for x in xs)


def test_staleness_discount_hand_check():
    """The γ^s rule against a hand-built aggregate: round 1's straggler
    row arrives in round 2 at its ORIGINAL round-1 weight times
    discount**delay, renormalized over the aggregated rows."""
    cfg = StalenessConfig(delay=1, fraction=0.34, discount=0.5)
    assert cfg.num_stragglers(3) == 1
    algo = make_algorithm("fomaml", LOSS_FN, EVAL_FN, inner_lr=0.05)
    phi = algo.init_state(0, _TinyModel.init)
    plane = plane_for(phi)
    opt = sgd(0.1)
    step = make_packed_meta_train_step(algo, opt, plane, staleness=cfg)
    state = init_packed_state(opt, plane, phi, staleness=cfg,
                              clients_per_round=3)

    stream = TaskStream(TRAIN, 3, 0.5, 8, 8, np.random.RandomState(3))
    tb1, tb2 = stream.next(), stream.next()

    g1 = _rows(algo, plane, tb1, phi)
    w1 = tb1.weight / tb1.weight.sum()
    exp1 = (w1[0] * g1[0] + w1[2] * g1[2]) / (w1[0] + w1[2])
    flat0 = plane.pack(phi).numpy()
    state1, _ = step(state, *_args(tb1), stale=_sel([1], [0, 2]))
    np.testing.assert_allclose(state1["phi"].numpy(), flat0 - 0.1 * exp1,
                               rtol=1e-5, atol=1e-7)

    phi1 = plane.unpack(state1["phi"])
    g2 = _rows(algo, plane, tb2, phi1)
    w2 = tb2.weight / tb2.weight.sum()
    gamma = cfg.discount ** cfg.delay
    num = w2[1] * g2[1] + w2[2] * g2[2] + gamma * w1[1] * g1[1]
    exp2 = num / (w2[1] + w2[2] + gamma * w1[1])
    phi1_flat = state1["phi"].numpy().copy()
    state2, _ = step(state1, *_args(tb2), stale=_sel([0], [1, 2]))
    np.testing.assert_allclose(state2["phi"].numpy(),
                               phi1_flat - 0.1 * exp2, rtol=1e-5, atol=1e-7)
    # the new straggler (row 0 of round 2) sits in the ring
    np.testing.assert_allclose(state2["stale"]["G"][0, 0].numpy(), g2[0],
                               rtol=1e-5, atol=1e-7)
    assert np.isclose(float(state2["stale"]["w"][0, 0]), w2[0])


def test_staleness_off_is_bitwise_noop():
    """fraction=0 staleness leaves the trajectory bitwise unchanged."""
    base = _fedmeta_history("fomaml", packed=True)
    zero = _fedmeta_history(
        "fomaml", packed=True,
        staleness=StalenessConfig(delay=1, fraction=0.0, discount=0.5))
    assert zero == base


def test_staleness_jitter_off_bitwise_identical(monkeypatch):
    """jitter=False is the fixed-delay path bitwise: the same rng draws
    (no extra randint), the same step path."""
    cfg = StalenessConfig(delay=2, fraction=0.34, discount=0.5)
    assert cfg.jitter is False
    off = _fedmeta_history("fomaml", packed=True, staleness=cfg)

    def legacy_pick(self, m, rng):
        k = self.num_stragglers(m)
        perm = rng.permutation(m)
        return (np.sort(perm[:k]).astype(np.int32),
                np.sort(perm[k:]).astype(np.int32))

    monkeypatch.setattr(StalenessConfig, "pick", legacy_pick)
    assert _fedmeta_history("fomaml", packed=True, staleness=cfg) == off


def test_staleness_jitter_hand_check():
    """Jittered staleness against an independent simulator: delays
    d ∈ [0, delay], arrival at round r + d at w·γ^d (d = 0 joins its own
    round), weights renormalized over the rows aggregated — including a
    round where two earlier stragglers (d = 2 and d = 1) arrive
    together."""
    cfg = StalenessConfig(delay=2, fraction=0.34, discount=0.5, jitter=True)
    algo = make_algorithm("fomaml", LOSS_FN, EVAL_FN, inner_lr=0.05)
    phi0 = algo.init_state(0, _TinyModel.init)
    plane = plane_for(phi0)
    opt = sgd(0.1)
    step = make_packed_meta_train_step(algo, opt, plane, staleness=cfg)
    state = init_packed_state(opt, plane, phi0, staleness=cfg,
                              clients_per_round=3)
    assert set(state["stale"]) == {"G", "w", "c", "d"}
    tbs = TaskStream(TRAIN, 3, 0.5, 8, 8, np.random.RandomState(3)).take(5)
    sels = [([1], [0, 2], [1]), ([0], [1, 2], [0]), ([2], [0, 1], [2]),
            ([0], [1, 2], [1]), ([1], [0, 2], [0])]

    flat = plane.pack(phi0).double().numpy()
    pending = []   # (arrive_round, weight·γ^d, gradient row)
    for r, (tb, (strag, fresh, delays)) in enumerate(zip(tbs, sels), 1):
        g = _rows(algo, plane, tb,
                  plane.unpack(torch.from_numpy(flat.astype(np.float32))))
        w = tb.weight / tb.weight.sum()
        agg = [(w[i], g[i]) for i in fresh]
        for j, d in zip(strag, delays):
            if d == 0:
                agg.append((w[j], g[j]))
            else:
                pending.append((r + d, cfg.discount ** d * w[j], g[j]))
        agg += [(pw, pg) for (ar, pw, pg) in pending if ar == r]
        pending = [p for p in pending if p[0] != r]
        tot = sum(pw for pw, _ in agg)
        flat = flat - 0.1 * sum(pw * pg for pw, pg in agg) / tot

    for tb, sel in zip(tbs, sels):
        state, _ = step(state, *_args(tb), stale=_sel(*sel))
    np.testing.assert_allclose(state["phi"].numpy(), flat, rtol=1e-5,
                               atol=1e-7)


def test_staleness_jitter_runs_through_trainer():
    """The trainer stages the 3-tuple pick under prefetch; a jittered run
    completes and diverges from the fixed-delay run."""
    fixed = _fedmeta_history(
        "fomaml", packed=True,
        staleness=StalenessConfig(delay=2, fraction=0.34, discount=0.5))
    jit = _fedmeta_history(
        "fomaml", packed=True, prefetch_depth=2,
        staleness=StalenessConfig(delay=2, fraction=0.34, discount=0.5,
                                  jitter=True))
    assert len(jit) == len(fixed)
    assert jit != fixed
    assert _no_prefetch_threads()


def test_staleness_validation():
    algo = make_algorithm("fomaml", LOSS_FN, EVAL_FN, inner_lr=0.05)
    kw = dict(support_frac=0.5, support_size=8, query_size=8, device="cpu")
    with pytest.raises(ValueError):
        FederatedTrainer(algo, adam(1e-3), TRAIN, 4,
                         staleness=StalenessConfig(), **kw)   # needs packed
    with pytest.raises(ValueError):
        FederatedTrainer(algo, adam(1e-3), TRAIN, 4, packed=True,
                         client_axis="chunked", client_chunk=2,
                         staleness=StalenessConfig(), **kw)   # needs vmap
    with pytest.raises(ValueError):
        StalenessConfig(delay=0)
    with pytest.raises(ValueError):
        StalenessConfig(fraction=1.0)


# ---- prefetcher lifecycle -------------------------------------------------

def test_step_exception_shuts_down_prefetcher():
    """A step that raises mid-run leaks no prefetch thread, and the
    rounds completed before it are still flushed to history."""
    tr = _trainer(prefetch_depth=3, flush_every=0)
    state = tr.init(0, _TinyModel.init)
    real_step, calls = tr._step, []

    def boom(st, *a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("client exploded")
        return real_step(st, *a, **kw)

    tr._step = boom
    with pytest.raises(RuntimeError, match="client exploded"):
        tr.run(state, 10)
    assert _no_prefetch_threads()
    assert [r["round"] for r in tr.history] == [1, 2]


def test_producer_exception_propagates_and_joins():
    def produce(k):
        if produce.calls == 1:
            raise ValueError("bad sample")
        produce.calls += 1
        return k

    produce.calls = 0
    pf = Prefetcher(produce, [1, 1, 1], depth=2)
    assert pf.get() == 1
    with pytest.raises(ValueError, match="bad sample"):
        pf.get()
    pf.close()
    assert not pf.alive


def test_engine_defers_flush_to_cadence():
    """flush_every batches history materialization without changing the
    records; flush_every=0 drains only at exit."""
    comm = CommTracker(phi_bytes=1000, clients_per_round=2)
    history, seen = [], []

    def step(state, staged):
        return state + 1, {"loss": torch.tensor(float(state))}

    engine = AsyncRoundEngine(stage=lambda k: k, step=step, comm=comm,
                              history=history, flush_every=3)
    engine.run(0, 7, log=lambda rec: seen.append(rec["round"]))
    assert [r["round"] for r in history] == list(range(1, 8))
    assert [r["loss"] for r in history] == [float(i) for i in range(7)]
    assert history[-1]["comm_MB"] == comm.summary()["comm_MB"]
    assert seen == list(range(1, 8))


def test_stack_task_batches_round_axis():
    stream = TaskStream(TRAIN, 4, 0.5, 8, 8, np.random.RandomState(0))
    tbs = stream.take(3)
    stacked = stack_task_batches(tbs)
    assert stacked.support_x.shape == (3, 4, 8, 4)
    np.testing.assert_array_equal(stacked.weight[1], tbs[1].weight)


# ---- against the reference -----------------------------------------------

def test_task_stream_and_stacking_match_reference():
    """`TaskStream.take` and `stack_task_batches` give the reference's
    arrays bitwise (every field, the round axis first) and leave the
    rng where the reference's leaves it."""
    jtrain = [JaxClientData(x, y) for x, y in TRAIN_ARRAYS]
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    got = stack_task_batches(TaskStream(TRAIN, 4, 0.5, 8, 8, r1).take(3))
    want = jax_stack(JaxTaskStream(jtrain, 4, 0.5, 8, 8, r2).take(3))
    assert got._fields == want._fields
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("m", [3, 4, 8])
def test_staleness_picks_match_reference(m, jitter):
    """The straggler picks index for index (dtypes too), round after
    round, and the same draws taken."""
    for seed in range(4):
        for delay, fraction in ((1, 0.34), (2, 0.25), (3, 0.5), (2, 0.0)):
            kw = dict(delay=delay, fraction=fraction, jitter=jitter,
                      seed=seed)
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            cfg, jcfg = StalenessConfig(**kw), JaxStaleness(**kw)
            assert cfg.num_stragglers(m) == jcfg.num_stragglers(m)
            for _ in range(4):
                got, want = cfg.pick(m, r1), jcfg.pick(m, r2)
                assert len(got) == len(want) == (3 if jitter else 2)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            assert r1.randint(1 << 30) == r2.randint(1 << 30)


def _jax_tiny_init(key):
    k, _ = jax.random.split(key)
    return {"w": jax.random.normal(k, (4, 2)) * 0.1, "b": jnp.zeros((2,))}


@pytest.mark.parametrize("jitter", [False, True], ids=["fixed", "jitter"])
def test_staleness_run_matches_reference(jitter):
    """Six rounds of the tiny model with 2-round stragglers (and a
    prefetching port trainer), from the reference's initial φ: every
    history record's metrics and eval fields at rtol 1e-5, φ and the
    ring at rtol 1e-5 / atol 1e-7, bytes and round counts exact."""
    cfg = dict(delay=2, fraction=0.34, discount=0.5, jitter=jitter, seed=3)
    jalgo = jax_make_algorithm("fomaml", *jax_cls_loss(
        lambda p, x: x @ p["w"] + p["b"]), inner_lr=0.05)
    jtr = JaxTrainer(jalgo, jax_adam(1e-3),
                     [JaxClientData(x, y) for x, y in TRAIN_ARRAYS], 4,
                     support_frac=0.5, support_size=8, query_size=8, seed=0,
                     packed=True, impl="xla", staleness=JaxStaleness(**cfg))
    jstate = jtr.init(jax.random.PRNGKey(0), _jax_tiny_init)
    theta = jax.tree.map(np.asarray, jtr.phi_tree(jstate))
    jstate = jtr.run(jstate, 6, eval_every=3,
                     eval_clients=[JaxClientData(x, y)
                                   for x, y in EVAL_ARRAYS])

    tr = _trainer(staleness=StalenessConfig(**cfg), prefetch_depth=2)
    state = tr.init(0, None, phi=from_numpy_tree(theta, "cpu"))
    state = tr.run(state, 6, eval_every=3, eval_clients=EVAL)

    assert len(tr.history) == len(jtr.history) == 6
    for a, b in zip(tr.history, jtr.history):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "client_GFLOPs":
                continue
            if isinstance(b[k], int) or k.endswith("_MB"):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert tr.comm.total_bytes == jtr.comm.total_bytes
    np.testing.assert_allclose(state["phi"].numpy(),
                               np.asarray(jstate["phi"]), rtol=1e-5,
                               atol=1e-7)
    assert sorted(state["stale"]) == sorted(jstate["stale"])
    for k, v in state["stale"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate["stale"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_compare_launcher_engine_flags_keep_the_history():
    """`launch.compare --prefetch-depth 2 --fuse-rounds 2 --flush-every 0`
    reaches the plan and every trainer, and each method's history equals
    the synchronous comparison's record for record (the `lm` scenario,
    2 rounds, packed pipeline)."""
    from repro_torch.launch import compare
    base = ["--sweep", "lm", "--rounds", "2", "--eval-every", "2",
            "--device", "cpu", "--pipeline", "packed"]
    piped = compare.main(base + ["--prefetch-depth", "2", "--fuse-rounds",
                                 "2", "--flush-every", "0"])
    sync = compare.main(base)
    plan = piped["plan"]
    assert (plan["prefetch_depth"], plan["fuse_rounds"],
            plan["flush_every"]) == (2, 2, 0)
    assert list(piped["methods"]) == list(sync["methods"])
    for name, rec in sync["methods"].items():
        assert piped["methods"][name]["history"] == rec["history"], name
    assert _no_prefetch_threads()
