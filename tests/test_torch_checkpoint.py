"""Port: crash-safe checkpointing (`checkpoint/io.py`) and resumable
runs (`FederatedTrainer.save_checkpoint` / `resume` /
`run(start_round=)`), port against port and across packages.

Port against port, the reference's cases (`tests/test_checkpoint.py`):
`checkpoint/io.py` round-trips real trainer state (numpy scalars in the
manifest, bf16 tensors, nested sequences); saves are atomic (temp names
invisible to discovery) with keep-last-k retention; a killed run resumed
in a fresh trainer reproduces the uninterrupted history record for
record (plain, prefetched, staleness + faults + trimmed); the
Prefetcher retries transient staging failures and names the round of a
permanent one.

Across packages: the same tree written by either package gives the same
manifest and arrays and loads in the other; a run checkpointed by the
JAX `FederatedTrainer` at round 3 resumes in the port's (and the
reverse) with the uninterrupted reference's tail at rtol 1e-5, bytes
and rounds exact."""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_io
from repro.core import classification_loss as jax_cls_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data.federated import ClientData as JaxClientData
from repro.federated.async_engine import StalenessConfig as JaxStaleness
from repro.federated.faults import FaultConfig as JaxFaultConfig
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.optim import adam as jax_adam
from repro_torch.checkpoint import io
from repro_torch.checkpoint.io import (latest_step, load_pytree,
                                       load_server_state, save_pytree,
                                       save_server_state)
from repro_torch.convert import from_numpy_tree
from repro_torch.federated.async_engine import (PrefetchError, Prefetcher,
                                                StalenessConfig)
from repro_torch.federated.faults import FaultConfig
from repro_torch.federated.server import FederatedTrainer
from tests.test_torch_async_engine import (EVAL, EVAL_ARRAYS, TRAIN_ARRAYS,
                                           _jax_tiny_init, _no_prefetch_threads,
                                           _TinyModel, _trainer,
                                           _one_torch_thread)  # noqa: F401


def _make_trainer(tmp_path=None, **kw):
    if tmp_path is not None:
        kw.setdefault("checkpoint_dir", str(tmp_path))
        kw.setdefault("checkpoint_every", 3)
    return _trainer(**kw)


# ---- io round-trip --------------------------------------------------------

def test_numpy_scalar_manifest_roundtrip(tmp_path):
    """numpy scalars in the manifest (msgpack cannot pack them) come
    back exactly as python scalars."""
    tree = {"round": np.int64(7), "acc": np.float32(0.25),
            "flag": np.bool_(True), "n": 3, "name": "run",
            "nested": ("a", np.int32(2), [np.float64(1.5)])}
    path = str(tmp_path / "ck")
    save_pytree(path, tree)
    back = load_pytree(path)
    assert back["round"] == 7 and isinstance(back["round"], int)
    assert back["acc"] == pytest.approx(0.25)
    assert back["flag"] is True
    assert back["nested"] == ("a", 2, [1.5])


def test_real_trainer_state_roundtrip(tmp_path):
    """A real payload (train state, rng states, comm counters, a history
    with a numpy scalar) survives save/load bit for bit."""
    tr = _make_trainer(tmp_path)
    state = tr.init(0, _TinyModel.init)
    state = tr.run(state, 3, eval_every=3, eval_clients=EVAL)
    tr.history[0]["np_step"] = np.int64(1)
    path = tr.save_checkpoint(state, 3)
    assert path.endswith("step_00000003")
    payload = load_server_state(str(tmp_path))
    assert payload["round"] == 3
    assert payload["history"][0]["np_step"] == 1
    assert torch.equal(payload["state"]["phi"], state["phi"])
    assert torch.equal(payload["state"]["opt"]["m"], state["opt"]["m"])
    assert payload["state"]["opt"]["step"].dtype == torch.int32
    assert int(payload["state"]["opt"]["step"]) == 3


def test_bf16_arrays_roundtrip(tmp_path):
    x = torch.arange(8, dtype=torch.bfloat16) * 0.5
    path = str(tmp_path / "bf")
    save_pytree(path, {"x": x, "y": torch.ones((3,))})
    back = load_pytree(path)
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"], x)
    assert back["y"].dtype == torch.float32


def test_orphaned_tmp_files_invisible(tmp_path):
    """A crash mid-save leaves temp names or an orphaned npz; discovery
    sees complete checkpoints only (the manifest is written last)."""
    save_server_state(str(tmp_path), 2, {"a": torch.ones((2,))})
    (tmp_path / "step_00000005.npz").write_bytes(b"torn")
    (tmp_path / "step_00000007.tmp.manifest").write_bytes(b"half")
    (tmp_path / "step_00000007.tmp.npz").write_bytes(b"half")
    assert latest_step(str(tmp_path)) == 2
    back = load_server_state(str(tmp_path))
    assert torch.equal(back["a"], torch.ones((2,)))


def test_keep_last_k_retention(tmp_path):
    for step in range(1, 6):
        save_server_state(str(tmp_path), step,
                          {"s": torch.tensor(float(step))}, keep_last=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000004.manifest", "step_00000004.npz",
                     "step_00000005.manifest", "step_00000005.npz"]
    assert latest_step(str(tmp_path)) == 5


def test_save_is_payload_first_and_atomic(tmp_path, monkeypatch):
    """Both files go through a temp name and `os.replace`, the payload
    before the manifest, each fsynced before its rename."""
    events = []
    real_replace, real_fsync = os.replace, os.fsync
    monkeypatch.setattr(io.os, "replace", lambda a, b: (
        events.append(("replace", os.path.basename(a),
                       os.path.basename(b))), real_replace(a, b))[1])
    monkeypatch.setattr(io.os, "fsync",
                        lambda fd: (events.append(("fsync",)),
                                    real_fsync(fd))[1])
    save_pytree(str(tmp_path / "ck"), {"a": torch.ones(3)})
    assert events == [("fsync",), ("replace", "ck.tmp.npz", "ck.npz"),
                      ("fsync",),
                      ("replace", "ck.tmp.manifest", "ck.manifest")]


# ---- kill-and-resume: bitwise history ------------------------------------

CONFIGS = {
    "plain": {},
    "prefetch": dict(prefetch_depth=2, flush_every=2),
    "stale+faults": dict(
        staleness=StalenessConfig(delay=1, fraction=0.34, discount=0.5),
        faults=FaultConfig(dropout=0.25, byzantine=0.25, seed=5),
        aggregator="trimmed", trim=1),
    "jitter+prefetch": dict(
        staleness=StalenessConfig(delay=2, fraction=0.34, discount=0.5,
                                  jitter=True),
        prefetch_depth=2),
}


@pytest.mark.parametrize("cfg", CONFIGS, ids=list(CONFIGS))
def test_kill_and_resume_bit_identical(tmp_path, cfg):
    """9 rounds uninterrupted; separately 6 rounds (checkpoints at 3 and
    6), a 'crash', a resume in a FRESH trainer and on to 9. The stitched
    history equals the uninterrupted one record for record, and φ and
    the ring bitwise."""
    kw = CONFIGS[cfg]
    tr0 = _make_trainer(**kw)
    s0 = tr0.run(tr0.init(0, _TinyModel.init), 9, eval_every=3,
                 eval_clients=EVAL)

    tr1 = _make_trainer(tmp_path, **kw)
    tr1.run(tr1.init(0, _TinyModel.init), 6, eval_every=3,
            eval_clients=EVAL)
    assert latest_step(str(tmp_path)) == 6      # and the process "dies"

    tr2 = _make_trainer(tmp_path, **kw)
    tr2.init(0, _TinyModel.init)
    state2, start = tr2.resume()
    assert start == 6
    assert [r["round"] for r in tr2.history] == list(range(1, 7))
    s2 = tr2.run(state2, 9, eval_every=3, eval_clients=EVAL,
                 start_round=start)
    assert tr2.history == tr0.history
    assert torch.equal(s2["phi"], s0["phi"])
    for k in s0.get("stale", {}):
        assert torch.equal(s2["stale"][k], s0["stale"][k]), k
    assert _no_prefetch_threads()


def test_resume_from_earlier_step(tmp_path):
    """Resuming from a non-latest checkpoint replays the tail."""
    tr1 = _make_trainer(tmp_path)
    tr1.run(tr1.init(0, _TinyModel.init), 6)
    reference = list(tr1.history)

    tr2 = _make_trainer(tmp_path)
    tr2.init(0, _TinyModel.init)
    state2, start = tr2.resume(step=3)
    assert start == 3
    tr2.run(state2, 6, start_round=start)
    assert tr2.history == reference


def test_checkpoint_payload_has_partial_history(tmp_path):
    """The engine flushes pending metrics before the checkpoint hook: a
    round-3 payload of a flush_every=0 run carries rounds 1..3."""
    tr = _make_trainer(tmp_path, prefetch_depth=2, flush_every=0)
    tr.run(tr.init(0, _TinyModel.init), 4)
    payload = load_server_state(str(tmp_path), 3)
    assert [r["round"] for r in payload["history"]] == [1, 2, 3]


# ---- prefetcher retry -----------------------------------------------------

def test_prefetcher_transient_failure_retries():
    calls = []

    def produce(k):
        calls.append(k)
        if len(calls) in (2, 3):        # block 2 fails twice, then lands
            raise OSError("transient")
        return ("block", len(calls))

    pf = Prefetcher(produce, [1, 1, 1], depth=1, max_retries=2,
                    retry_backoff=0.001)
    try:
        assert pf.get() == ("block", 1)
        assert pf.get() == ("block", 4)
        assert pf.get() == ("block", 5)
    finally:
        pf.close()
    assert not pf.alive


def test_prefetcher_retries_exhausted_names_round():
    def produce(k):
        raise OSError("disk on fire")

    pf = Prefetcher(produce, [1, 1], depth=1, max_retries=1,
                    retry_backoff=0.001, first_round=7)
    with pytest.raises(PrefetchError, match=r"round 7.*max_retries=1"
                                            r".*disk on fire") as ei:
        pf.get()
    pf.close()
    assert isinstance(ei.value.__cause__, OSError)


def test_prefetcher_dead_producer_get_raises():
    """get() past what the producer staged raises, not deadlocks."""
    pf = Prefetcher(lambda k: k, [1], depth=1)
    assert pf.get() == 1
    with pytest.raises(PrefetchError, match="without staging"):
        pf.get()
    pf.close()


def test_trainer_retry_is_deterministic(monkeypatch):
    """A transient staging failure under prefetch_retries leaves the run
    bitwise equal to a clean one: staging restores the seeded streams
    around the failed attempt, so the retry draws the same tasks."""
    clean = _make_trainer(staleness=StalenessConfig(fraction=0.25))
    clean.run(clean.init(0, _TinyModel.init), 6)

    tr = _make_trainer(prefetch_depth=2, prefetch_retries=2,
                       staleness=StalenessConfig(fraction=0.25))
    orig = FederatedTrainer._stage_block
    fails = {"left": 1}

    def flaky(self, stream, put, k, round_):
        args = orig(self, stream, put, k, round_)  # draw, THEN fail: the
        if fails["left"]:                          # restore must undo it
            fails["left"] -= 1
            raise OSError("transient staging failure")
        return args

    monkeypatch.setattr(FederatedTrainer, "_stage_block", flaky)
    tr.run(tr.init(0, _TinyModel.init), 6)
    assert fails["left"] == 0
    assert tr.history == clean.history
    assert _no_prefetch_threads()


# ---- across packages ------------------------------------------------------

def _tree_pair():
    """The same tree for each package: arrays of several dtypes, a bf16
    one, scalars and nested sequences."""
    rng = np.random.RandomState(0)
    a = rng.normal(0, 1, (3, 5)).astype(np.float32)
    b16 = rng.normal(0, 1, (7,)).astype(np.float32)
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)
    keys = rng.randint(0, 2**31, 624).astype(np.uint32)
    scal = {"round": 4, "acc": 0.5, "name": "x", "flag": True}

    def tree(arr, bf):
        return {"state": {"phi": arr(a), "opt": {"step": arr(np.asarray(3, np.int32))},
                          "ring": bf(b16)},
                "rng": {"task": {"keys": keys, "alg": "MT19937"}},
                "seq": [arr(ints), ("t", 1.5)], **scal}

    jt = tree(jnp.asarray, lambda x: jnp.asarray(x, jnp.bfloat16))
    tt = tree(torch.from_numpy,
              lambda x: torch.from_numpy(x).to(torch.bfloat16))
    return jt, tt


def _read(path):
    with open(path + ".manifest", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def test_checkpoint_files_are_the_reference_format(tmp_path):
    """The same tree saved by each package: the same manifest (keys,
    scalars, bf16 list) and the same arrays, dtypes included."""
    jt, tt = _tree_pair()
    jax_io.save_pytree(str(tmp_path / "j"), jt)
    save_pytree(str(tmp_path / "t"), tt)
    (jm, ja), (tm, ta) = _read(str(tmp_path / "j")), _read(str(tmp_path / "t"))
    assert tm == jm
    assert tm["bf16"] == ["state/ring"]
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    """A checkpoint written by one package loads in the other: equal
    structure, scalars, arrays and dtypes (bf16 restored)."""
    jt, tt = _tree_pair()
    path = str(tmp_path / "ck")
    if writer == "jax":
        jax_io.save_pytree(path, jt)
    else:
        save_pytree(path, tt)
    tb, jb = load_pytree(path), jax_io.load_pytree(path)
    assert tb["state"]["ring"].dtype == torch.bfloat16
    assert jb["state"]["ring"].dtype == jnp.bfloat16
    assert tb["seq"][1] == jb["seq"][1] == ("t", 1.5)
    assert isinstance(tb["seq"], list) and isinstance(jb["seq"], list)
    for k in ("round", "acc", "name", "flag"):
        assert tb[k] == jb[k] == jt[k]
    for get in (lambda t: t["state"]["phi"], lambda t: t["state"]["ring"],
                lambda t: t["state"]["opt"]["step"], lambda t: t["seq"][0],
                lambda t: t["rng"]["task"]["keys"]):
        a, b = get(tb), np.asarray(get(jb))
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.astype(np.float32)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


JAX_CONFIGS = {
    "plain": ({}, {}),
    "stale+faults": (
        dict(staleness=JaxStaleness(delay=1, fraction=0.34, discount=0.5),
             faults=JaxFaultConfig(dropout=0.25, byzantine=0.25, seed=5),
             aggregator="trimmed", trim=1),
        dict(staleness=StalenessConfig(delay=1, fraction=0.34, discount=0.5),
             faults=FaultConfig(dropout=0.25, byzantine=0.25, seed=5),
             aggregator="trimmed", trim=1)),
}


def _jax_trainer(tmp_path=None, **kw):
    algo = jax_make_algorithm("fomaml", *jax_cls_loss(
        lambda p, x: x @ p["w"] + p["b"]), inner_lr=0.05)
    if tmp_path is not None:
        kw.update(checkpoint_dir=str(tmp_path), checkpoint_every=3)
    return JaxTrainer(algo, jax_adam(1e-3),
                      [JaxClientData(x, y) for x, y in TRAIN_ARRAYS], 4,
                      support_frac=0.5, support_size=8, query_size=8,
                      seed=0, packed=True, impl="xla", **kw)


def _hold_tail(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "client_GFLOPs":
                continue
            if isinstance(b[k], int) or k.endswith("_MB"):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
@pytest.mark.parametrize("cfg", JAX_CONFIGS, ids=list(JAX_CONFIGS))
def test_checkpoint_resumes_across_packages(tmp_path, cfg, direction):
    """One package runs 3 rounds and checkpoints; a fresh trainer of the
    other resumes and runs to 6. Its rounds 4..6 equal the uninterrupted
    reference's at rtol 1e-5 (bytes and rounds exact); rounds 1..3 come
    back from the checkpoint as written."""
    jkw, tkw = JAX_CONFIGS[cfg]
    ev = [JaxClientData(x, y) for x, y in EVAL_ARRAYS]
    full = _jax_trainer(**jkw)
    jstate = full.init(jax.random.PRNGKey(0), _jax_tiny_init)
    theta = jax.tree.map(np.asarray, full.phi_tree(jstate))
    full.run(jstate, 6, eval_every=3, eval_clients=ev)

    if direction == "jax->torch":
        w = _jax_trainer(tmp_path, **jkw)
        w.run(w.init(jax.random.PRNGKey(0), _jax_tiny_init), 3,
              eval_every=3, eval_clients=ev)
        r = _make_trainer(tmp_path, **tkw)
        r.init(0, None, phi=from_numpy_tree(theta, "cpu"))
        state, start = r.resume()
        assert state["phi"].device.type == "cpu"
        r.run(state, 6, eval_every=3, eval_clients=EVAL, start_round=start)
    else:
        w = _make_trainer(tmp_path, **tkw)
        w.run(w.init(0, None, phi=from_numpy_tree(theta, "cpu")), 3,
              eval_every=3, eval_clients=EVAL)
        r = _jax_trainer(tmp_path, **jkw)
        r.init(jax.random.PRNGKey(0), _jax_tiny_init)
        state, start = r.resume()
        r.run(state, 6, eval_every=3, eval_clients=ev, start_round=start)
    assert start == 3
    assert r.history[:3] == w.history
    _hold_tail(r.history[3:], full.history[3:])
