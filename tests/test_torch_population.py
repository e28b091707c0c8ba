"""Port parity: the population plane (`federated/population.py`, the
participation log of `federated/comm.py`, `assemble_task_batch` and the
trainer's arrival staging) against the JAX package's.

The arrival model, the round plan and the circuit breaker are numpy and
host logic, so they are held exactly: `UnreliabilityConfig.draw` on a
grid of (client, round), `plan_round` on seeded candidate sets with and
without a deadline, the breaker's states and `state_dict` after one
event sequence, the participation accounting and the partial-round
batch. The trainer runs the reference's configuration (failures, a
deadline, over-selection, the breaker, a pool) from the reference's
initial φ: every accounting field of every record exactly equal, the
losses at rtol 1e-5 (f32) and φ within the Adam 2·lr rule of
`tests/test_torch_fedmeta.py::_close_after_adam`. Port against port,
bitwise: pipelined and pooled runs equal the synchronous one, an
all-failed round is skipped with the state unchanged, and kill and
resume reproduce the uninterrupted run, the breaker included; a
checkpoint of either package resumes in the other. A reduced
``--sweep population`` holds the reference's `run_cell` accounting."""
import importlib.util
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import classification_loss as jax_cls_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data import federated as jfed
from repro.federated import comm as jcomm
from repro.federated import population as jpop
from repro.federated.async_engine import StalenessConfig as JaxStaleness
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.kernels.meta_update.compress import CompressionConfig as JaxComp
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.data import federated as tfed
from repro_torch.federated import comm as tcomm
from repro_torch.federated import population as tpop
from repro_torch.federated.async_engine import StalenessConfig
from repro_torch.federated.server import FederatedTrainer
from repro_torch.kernels.meta_update.compress import CompressionConfig
from repro_torch.optim import adam
from tests.test_torch_async_engine import (EVAL, EVAL_ARRAYS, EVAL_FN,
                                           LOSS_FN, TRAIN, TRAIN_ARRAYS,
                                           _jax_tiny_init, _TinyModel,
                                           _one_torch_thread)  # noqa: F401
from tests.test_torch_worker_pool import _no_pool_threads

HERE = os.path.dirname(os.path.abspath(__file__))
# the arrival knobs of the reference's population tests
POP = dict(over_select=0.5, round_deadline=1.6, breaker_threshold=2,
           breaker_cooldown=3)


def _unrel(pkg, **kw):
    return pkg.UnreliabilityConfig(**{"fail_rate": 0.3, "chronic_frac": 0.1,
                                      "seed": 7, **kw})


def _pop_trainer(**kw):
    algo = make_algorithm("fomaml", LOSS_FN, EVAL_FN, inner_lr=0.05)
    return FederatedTrainer(algo, adam(1e-3), TRAIN, 4, support_frac=0.5,
                            support_size=8, query_size=8, seed=0,
                            device="cpu", **{"packed": True, **kw})


def _jax_pop_trainer(**kw):
    algo = jax_make_algorithm("fomaml", *jax_cls_loss(
        lambda p, x: x @ p["w"] + p["b"]), inner_lr=0.05)
    return JaxTrainer(algo, jax_adam(1e-3),
                      [jfed.ClientData(x, y) for x, y in TRAIN_ARRAYS], 4,
                      support_frac=0.5, support_size=8, query_size=8, seed=0,
                      impl="xla", **{"packed": True, **kw})


def _same_history(a, b):
    """Record for record, a NaN equal to a NaN (a skipped round's
    metrics)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if set(ra) != set(rb):
            return False
        for k, va in ra.items():
            vb = rb[k]
            if not (va == vb or (isinstance(va, float) and np.isnan(va)
                                 and isinstance(vb, float)
                                 and np.isnan(vb))):
                return False
    return True


# ---- the arrival model, the plan, the breaker -----------------------------

@pytest.mark.parametrize("kw", [{}, {"fail_rate": 0.0, "chronic_frac": 0.3,
                                     "latency_mean": 2.0, "seed": 1},
                                {"jitter_sigma": 0.0, "latency_sigma": 1.5}],
                         ids=["default", "chronic", "no-jitter"])
def test_unreliability_draws_match_reference(kw):
    t, j = _unrel(tpop, **kw), _unrel(jpop, **kw)
    for c in range(0, 200, 7):
        assert t.client_profile(c) == j.client_profile(c)
        for r in range(6):
            assert t.draw(c, r) == j.draw(c, r)
    assert t.draw(3, 2) == t.draw(3, 2)


def test_unreliability_validation_matches_reference():
    for bad in ({"fail_rate": 1.5}, {"chronic_frac": -0.1}):
        with pytest.raises(ValueError) as je:
            jpop.UnreliabilityConfig(**bad)
        with pytest.raises(ValueError, match=re.escape(str(je.value))):
            tpop.UnreliabilityConfig(**bad)


@pytest.mark.parametrize("deadline", [None, 0.9, 1.6], ids=str)
@pytest.mark.parametrize("unrel", [False, True], ids=["no-model", "model"])
def test_plan_round_matches_reference(deadline, unrel):
    rng = np.random.RandomState(4)
    for round_ in range(1, 9):
        m = rng.randint(1, 6)
        cand = rng.choice(500, size=m + rng.randint(0, 8), replace=False)
        t = tpop.plan_round(cand, round_, _unrel(tpop) if unrel else None,
                            deadline, m)
        j = jpop.plan_round(cand, round_, _unrel(jpop) if unrel else None,
                            deadline, m)
        for f in ("candidates", "arrived", "failed", "late", "surplus",
                  "latencies"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert len(t.arrived) <= m


def test_circuit_breaker_matches_reference():
    """One seeded sequence of failures and successes over 12 clients and
    20 rounds: the states, the blocked sets and `state_dict` equal the
    reference's after every round; `load_state` round-trips."""
    t, j = tpop.CircuitBreaker(2, 3), jpop.CircuitBreaker(2, 3)
    rng = np.random.RandomState(0)
    for r in range(1, 21):
        for c in rng.choice(12, size=5, replace=False):
            c = int(c)
            if rng.random_sample() < 0.6:
                t.record_failure(c, r)
                j.record_failure(c, r)
            else:
                t.record_success(c)
                j.record_success(c)
        assert t.blocked(r + 1) == j.blocked(r + 1)
        assert [t.state(c, r + 1) for c in range(12)] == \
            [j.state(c, r + 1) for c in range(12)]
        assert t.state_dict() == j.state_dict()
    again = tpop.CircuitBreaker(2, 3)
    again.load_state(j.state_dict())
    assert again.state_dict() == t.state_dict()
    assert again.blocked(21) == t.blocked(21)
    for bad in ({"threshold": 0}, {"cooldown": 0}):
        with pytest.raises(ValueError, match="threshold and cooldown"):
            tpop.CircuitBreaker(**bad)


def test_participation_accounting_matches_reference():
    """Staged rounds ahead of the tick, then ticks past the log: the same
    summaries at every round count, ints where the reference has ints;
    download charges the selected, upload and FLOPs the arrivals."""
    t = tcomm.CommTracker(phi_bytes=100, clients_per_round=4,
                          flops_per_client=10.0)
    j = jcomm.CommTracker(phi_bytes=100, clients_per_round=4,
                          flops_per_client=10.0)
    for sel, arr, quar in ((6, 3, 0), (6, 0, 2), (6, 4, 1)):
        t.record_round(sel, arr, quar)
        j.record_round(sel, arr, quar)
    for _ in range(5):
        t.tick()
        j.tick()
        assert t.download_bytes == j.download_bytes
        assert t.upload_bytes == j.upload_bytes
        assert t.total_flops == j.total_flops
        for r in range(t.rounds + 1):
            a, b = t.summary_at(r), j.summary_at(r)
            assert a == b
            assert all(type(a[k]) is type(b[k]) for k in a)
    assert t.summary()["selected_total"] == 18 + 2 * 4
    plain = tcomm.CommTracker(phi_bytes=100, clients_per_round=4)
    plain.tick(3)
    assert plain.download_bytes == plain.upload_bytes == 1200
    assert "selected" not in plain.summary()


@pytest.mark.parametrize("case", ["partial", "full", "empty", "unweighted"])
def test_assemble_task_batch_matches_reference(case):
    arrays = [(np.random.RandomState(n).normal(0, 1, (n, 3))
               .astype(np.float32), np.arange(n) % 2) for n in (9, 20, 31,
                                                                14)]
    shards = {"partial": arrays[:3], "full": arrays, "empty": [],
              "unweighted": arrays[1:3]}[case]
    kw = dict(weighted=case != "unweighted")
    probe = arrays[3] if case == "empty" else None
    t = tfed.assemble_task_batch(
        [tfed.ClientData(*a) for a in shards], 4, 0.5, 5, 6,
        np.random.RandomState(2),
        probe=None if probe is None else tfed.ClientData(*probe), **kw)
    j = jfed.assemble_task_batch(
        [jfed.ClientData(*a) for a in shards], 4, 0.5, 5, 6,
        np.random.RandomState(2),
        probe=None if probe is None else jfed.ClientData(*probe), **kw)
    for f in ("support_x", "support_y", "query_x", "query_y", "weight",
              "query_count"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if case == "empty":
        assert not t.weight.any()
        with pytest.raises(ValueError, match="shape probe"):
            tfed.assemble_task_batch([], 4, 0.5, 5, 6,
                                     np.random.RandomState(2))
    with pytest.raises(ValueError, match="at most 4 arrived"):
        tfed.assemble_task_batch([tfed.ClientData(*arrays[0])] * 5, 4, 0.5,
                                 5, 6, np.random.RandomState(2))


# ---- the trainer against the reference -------------------------------------

def _close_after_adam(t_phi, j_phi, t_m, j_m, lr):
    """m at rtol 1e-5; φ at rtol 1e-5 where |m| > 1e-6·max|m| and within
    2·lr everywhere (Adam's first steps divide m by sqrt(v), so a
    last-bit gradient difference near zero moves φ by up to 2·lr)."""
    np.testing.assert_allclose(t_m, j_m, rtol=1e-5, atol=1e-7)
    live = np.abs(j_m) > 1e-6 * np.abs(j_m).max()
    np.testing.assert_allclose(t_phi[live], j_phi[live], rtol=1e-5,
                               atol=1e-7)
    assert np.all(np.abs(t_phi - j_phi) <= 2 * lr * (1 + 1e-5))


ACCOUNTING = ("selected", "arrived", "quarantined", "selected_total",
              "arrived_total", "rounds", "round", "skipped")


def test_population_run_matches_reference():
    """8 rounds with transient and chronic failures, a deadline,
    over-selection, the breaker and 2 pool workers, from the reference's
    initial φ: each record's accounting exactly the reference's (bytes
    included), its losses and eval fields at rtol 1e-5, φ and Adam's m
    by `_close_after_adam`."""
    jtr = _jax_pop_trainer(unreliability=_unrel(jpop), pool_workers=2,
                           **POP)
    jstate = jtr.init(jax.random.PRNGKey(0), _jax_tiny_init)
    theta = jax.tree.map(np.asarray, jtr.phi_tree(jstate))
    jstate = jtr.run(jstate, 8, eval_every=4, eval_clients=[
        jfed.ClientData(x, y) for x, y in EVAL_ARRAYS])
    tr = _pop_trainer(unreliability=_unrel(tpop), pool_workers=2, **POP)
    assert (tr.aggregator, tr.guard) == (jtr.aggregator, jtr.guard) == \
        ("masked_mean", True)
    state = tr.run(tr.init(0, None, phi=from_numpy_tree(theta, "cpu")), 8,
                   eval_every=4, eval_clients=EVAL)
    arrived = [r["arrived"] for r in jtr.history]
    assert min(arrived) < 4 and max(arrived) > 0   # partial cohorts
    assert len(tr.history) == len(jtr.history) == 8
    for a, b in zip(tr.history, jtr.history):
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ACCOUNTING or k.endswith("_MB"):
                assert a[k] == b[k] and type(a[k]) is type(b[k]), k
            elif k != "client_GFLOPs":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert tr.comm.participation == jtr.comm.participation
    assert tr._breaker.state_dict() == jtr._breaker.state_dict()
    _close_after_adam(state["phi"].numpy(), np.asarray(jstate["phi"]),
                      state["opt"]["m"].float().numpy(),
                      np.asarray(jstate["opt"]["m"]), 1e-3)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])
    assert _no_pool_threads()


def _validation_cases():
    tree = dict(packed=False)
    return [
        pytest.param(dict(over_select=0.5, **tree), {}, id="off-packed"),
        pytest.param(dict(round_deadline=1.0, client_axis="chunked",
                          client_chunk=2), {}, id="off-vmap"),
        pytest.param(dict(over_select=-0.1), {}, id="negative"),
        pytest.param(dict(over_select=0.5, fuse_rounds=2), {}, id="fused"),
        pytest.param(dict(over_select=0.5), {"staleness": True},
                     id="staleness"),
        pytest.param(dict(round_deadline=1.0), {"compression": True},
                     id="compression"),
    ]


@pytest.mark.parametrize("kw, extra", _validation_cases())
def test_population_validation_matches_reference(kw, extra):
    """Each configuration the reference refuses, the port refuses with
    the reference's message."""
    jkw, tkw = dict(kw), dict(kw)
    if extra.get("staleness"):
        jkw["staleness"], tkw["staleness"] = JaxStaleness(), StalenessConfig()
    if extra.get("compression"):
        jkw["compression"] = JaxComp("int8")
        tkw["compression"] = CompressionConfig("int8")
    with pytest.raises(ValueError) as je:
        _jax_pop_trainer(**jkw)
    with pytest.raises(ValueError) as te:
        _pop_trainer(**tkw)
    assert str(te.value) == str(je.value)


# ---- port against port, bitwise -------------------------------------------

def _run(rounds=6, **kw):
    tr = _pop_trainer(unreliability=_unrel(tpop), **POP, **kw)
    state = tr.run(tr.init(0, _TinyModel.init), rounds, eval_every=3,
                   eval_clients=EVAL)
    return tr, state


def test_population_pipelined_and_pooled_equal_sync():
    """Arrivals are pure functions of (seed, client, round) and the
    breaker advances on the staging thread in round order: a prefetched
    run and a pooled one equal the synchronous run, history and state
    bitwise."""
    sync, s0 = _run()
    for kw in (dict(prefetch_depth=2, flush_every=2), dict(pool_workers=3),
               dict(prefetch_depth=3, pool_workers=2, flush_every=0)):
        tr, st = _run(**kw)
        assert _same_history(tr.history, sync.history), kw
        assert torch.equal(st["phi"], s0["phi"]), kw
        assert all(torch.equal(st["opt"][k], s0["opt"][k])
                   for k in s0["opt"]), kw
        assert tr._breaker.state_dict() == sync._breaker.state_dict()
    assert _no_pool_threads()


def test_all_failed_rounds_are_skipped():
    """fail_rate 1: every candidate fails, the probe row carries weight
    0, the weights normalize to NaN and the guard skips every round: φ,
    m, v and the step bitwise unchanged, nothing uploaded, and the
    chronic failures open the breaker."""
    tr = _pop_trainer(unreliability=tpop.UnreliabilityConfig(fail_rate=1.0,
                                                             seed=3),
                      over_select=0.25)
    state = tr.init(0, _TinyModel.init)
    before = {k: v.clone() for k, v in
              [("phi", state["phi"])] + list(state["opt"].items())}
    out = tr.run(state, 3)
    assert [r["skipped"] for r in tr.history] == [1.0] * 3
    assert [r["arrived"] for r in tr.history] == [0] * 3
    assert tr.comm.upload_bytes == 0 and tr.comm.download_bytes > 0
    assert torch.equal(out["phi"], before["phi"])
    for k, v in out["opt"].items():
        assert torch.equal(v, before[k]), k
    assert len(tr._breaker.blocked(4)) > 0


def test_population_knobs_off_are_the_plain_trainer():
    """over_select 0, no model and no deadline is not population mode:
    the breaker is absent and the history is the plain run's."""
    tr = _pop_trainer(over_select=0.0)
    assert tr._breaker is None and tr.aggregator == "mean"
    plain = _pop_trainer()
    for t in (tr, plain):
        t.run(t.init(0, _TinyModel.init), 3)
    assert tr.history == plain.history


@pytest.mark.parametrize("prefetch", [0, 2], ids=["sync", "prefetch"])
def test_population_resume_bitwise(tmp_path, prefetch):
    """Kill and resume: 9 rounds uninterrupted, against 6 checkpointed at
    3 and 6 and a fresh trainer resumed to 9: history and φ bitwise, the
    breaker and the participation log restored with the rngs (the
    reference's `test_population_checkpoint_resume_bit_identical`
    configuration)."""
    kw = dict(unreliability=tpop.UnreliabilityConfig(fail_rate=0.4,
                                                     seed=11),
              over_select=0.5, round_deadline=2.0, breaker_threshold=2,
              breaker_cooldown=3, prefetch_depth=prefetch)
    full = _pop_trainer(**kw)
    end = full.run(full.init(0, _TinyModel.init), 9, eval_every=3,
                   eval_clients=EVAL)
    tr1 = _pop_trainer(checkpoint_dir=str(tmp_path), checkpoint_every=3,
                       **kw)
    tr1.run(tr1.init(0, _TinyModel.init), 6, eval_every=3,
            eval_clients=EVAL)
    tr2 = _pop_trainer(checkpoint_dir=str(tmp_path), checkpoint_every=3,
                       **kw)
    tr2.init(0, _TinyModel.init)
    state, start = tr2.resume()
    assert start == 6 and len(tr2.comm.participation) == 6
    assert tr2.comm.participation == full.comm.participation[:6]
    out = tr2.run(state, 9, eval_every=3, eval_clients=EVAL,
                  start_round=start)
    assert _same_history(tr2.history, full.history)
    assert torch.equal(out["phi"], end["phi"])
    assert tr2._breaker.state_dict() == full._breaker.state_dict()
    assert _no_pool_threads()


def test_population_checkpoint_loads_in_both_packages(tmp_path):
    """A port checkpoint with breaker state resumes in the reference's
    trainer, and a reference checkpoint in the port's: the same round,
    participation log, breaker state, task rng and φ."""
    kw = dict(over_select=0.5, round_deadline=2.0, breaker_threshold=2,
              breaker_cooldown=3)
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    tr = _pop_trainer(unreliability=tpop.UnreliabilityConfig(
        fail_rate=0.4, seed=11), checkpoint_dir=port_dir,
        checkpoint_every=3, **kw)
    tr.run(tr.init(0, _TinyModel.init), 3)
    jtr = _jax_pop_trainer(unreliability=jpop.UnreliabilityConfig(
        fail_rate=0.4, seed=11), checkpoint_dir=ref_dir, checkpoint_every=3,
        **kw)
    jtr.run(jtr.init(jax.random.PRNGKey(0), _jax_tiny_init), 3)
    assert tr._breaker.state_dict()["fails"] or \
        tr._breaker.state_dict()["open"]
    for writer, src in ((tr, port_dir), (jtr, ref_dir)):
        tres = _pop_trainer(unreliability=tpop.UnreliabilityConfig(
            fail_rate=0.4, seed=11), **kw)
        tres.init(0, _TinyModel.init)
        tstate, tstart = tres.resume(src)
        jres = _jax_pop_trainer(unreliability=jpop.UnreliabilityConfig(
            fail_rate=0.4, seed=11), **kw)
        jres.init(jax.random.PRNGKey(0), _jax_tiny_init)
        jstate, jstart = jres.resume(src)
        assert tstart == jstart == 3
        want = [tuple(p) for p in writer.comm.participation]
        assert tres.comm.participation == jres.comm.participation == want
        assert tres._breaker.state_dict() == jres._breaker.state_dict() \
            == writer._breaker.state_dict()
        assert np.array_equal(tres._rng.get_state()[1],
                              jres._rng.get_state()[1])
        np.testing.assert_array_equal(tstate["phi"].numpy(),
                                      np.asarray(jstate["phi"]))


# ---- the population sweep against the reference's run_cell ----------------

def _reference_run_cell():
    spec = importlib.util.spec_from_file_location(
        "population_scale",
        os.path.join(HERE, os.pardir, "examples", "population_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_cell


def test_reduced_population_sweep_matches_reference_run_cell():
    """`launch.compare.sweep_population` at a reduced size (24 clients, 6
    rounds, eval every 3, a cache of 12) against the reference's
    `examples/population_scale.run_cell` on the same configuration: each
    cell's skipped rounds, arrivals, cohort fill, client updates and comm
    block exactly equal; the registry's accesses equal and its peak
    under the cap."""
    from repro.federated.experiment import DATASETS as JD
    from repro_torch.launch.compare import POPULATION, sweep_population
    cfg = dict(POPULATION, rounds=6, eval_every=3, clients=24,
               cache_clients=12)
    out = sweep_population(device="cpu", log=None, **cfg)
    su = JD["sent140"]
    reg = su["data"](cfg["clients"], cfg["seed"], lazy=True,
                     cache_clients=cfg["cache_clients"])
    train, val, test = reg.split_clients(seed=cfg["seed"])
    args = types.SimpleNamespace(**cfg)
    run_cell = _reference_run_cell()
    unrel = jpop.UnreliabilityConfig(fail_rate=cfg["fail_rate"],
                                     seed=cfg["seed"])
    model = su["model"]()
    for got, (name, u, os_, dl) in zip(out["cells"], [
            ("clean", None, 0.0, None),
            ("overselect", unrel, cfg["over_select"], cfg["round_deadline"]),
            ("baseline", unrel, 0.0, cfg["round_deadline"])]):
        want = run_cell(name, su=su, model=model, train=train, val=val,
                        test=test, args=args, unreliability=u,
                        over_select=os_, round_deadline=dl)
        assert got["cell"] == name
        for k in ("rounds", "skipped_rounds", "dead_round_frac",
                  "mean_arrived", "cohort_fill", "client_updates",
                  "over_select", "round_deadline", "fail_rate"):
            assert got[k] == want[k], (name, k)
        assert {k: v for k, v in got["comm"].items()
                if k != "client_GFLOPs"} == \
            {k: v for k, v in want["comm"].items() if k != "client_GFLOPs"}
        assert [r for r, _ in got["eval_curve"]] == \
            [r for r, _ in want["eval_curve"]]
    gc, jc = out["registry_cache"], reg.cache_stats()
    assert gc["hits"] + gc["misses"] == jc["hits"] + jc["misses"]
    assert gc["peak_resident"] <= 12
    assert sorted(out) == ["cells", "config", "headline", "registry_cache"]
    assert out["headline"]["baseline"]["client_updates"] == \
        out["cells"][2]["client_updates"]


def test_compare_launcher_population_flags_reach_the_plan():
    """`launch.compare`'s population flags reach the plan and the FedMeta
    trainers (the `lm` scenario, lazy, 2 rounds, packed): selected,
    arrived and quarantined in every FedMeta record, none in FedAvg's;
    the lazy sequential registry leaves FedAvg's history the eager
    run's."""
    from repro_torch.launch import compare
    base = ["--sweep", "lm", "--rounds", "2", "--eval-every", "2",
            "--device", "cpu", "--pipeline", "packed"]
    pop = compare.main(base + ["--lazy-population", "--cache-clients", "8",
                               "--over-select", "0.5",
                               "--unreliable-fail-rate", "0.25",
                               "--round-deadline", "1.5",
                               "--pool-workers", "2",
                               "--eval-clients-cap", "3"])
    plan = pop["plan"]
    assert (plan["lazy_population"], plan["cache_clients"],
            plan["over_select"], plan["round_deadline"],
            plan["pool_workers"], plan["eval_clients_cap"]) == \
        (True, 8, 0.5, 1.5, 2, 3)
    assert plan["unreliability"]["fail_rate"] == 0.25
    plain = compare.main(base)
    for name, rec in pop["methods"].items():
        fedmeta = name not in ("fedavg", "fedavg(meta)")
        assert all(("selected" in r) == fedmeta for r in rec["history"])
        if fedmeta:
            assert rec["history"][-1]["selected_total"] == 2 * 6
    for a, b in zip(pop["methods"]["fedavg"]["history"],
                    plain["methods"]["fedavg"]["history"]):
        assert {k: v for k, v in a.items() if not k.startswith("eval")} \
            == {k: v for k, v in b.items() if not k.startswith("eval")}
    assert _no_pool_threads()


def test_compare_population_tool_holds_the_accounting(tmp_path):
    """`tools/compare_population.py` holds the committed artifact against
    itself (exit 0), and exits 1 naming the field when one cell's
    accounting or the registry's accesses differ; the hits/misses split
    alone does not fail it."""
    import json
    import subprocess
    import sys
    art = os.path.join(HERE, os.pardir, "results", "experiments",
                       "population_sent140.json")
    tool = os.path.join(HERE, os.pardir, "tools", "compare_population.py")

    def run(got):
        path = tmp_path / "got.json"
        path.write_text(json.dumps(got))
        proc = subprocess.run([sys.executable, tool, str(path), art],
                              capture_output=True, text=True, timeout=60)
        return proc.returncode, json.loads(proc.stdout)

    with open(art) as f:
        want = json.load(f)
    rc, out = run(want)
    assert rc == 0 and out["held"]
    assert all(c["eval_curve"]["equal"] == "20 of 20"
               for c in out["cells"].values())
    split = json.loads(json.dumps(want))
    split["registry_cache"].update(hits=1306, misses=554)
    rc, out = run(split)
    assert rc == 0 and not out["registry_cache"][
        "hits_misses_evictions_equal"]
    bad = json.loads(json.dumps(want))
    bad["cells"][1]["comm"]["arrived_total"] += 1
    rc, out = run(bad)
    assert rc == 1
    assert out["cells"]["overselect"]["differs"] == {
        "comm.arrived_total": [178, 177]}
