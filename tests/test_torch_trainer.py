"""Port parity: `FederatedTrainer` on the packed client plane against the
JAX package's trainer (kernels in Pallas interpret mode), same seeds,
same FEMNIST clients, the reference's φ carried over by `convert`.

Byte counts must be exactly equal. Per-round metrics and the eval
accuracy and loss are held at rtol 1e-4 / atol 1e-5 (the LM tests'
tolerance: convolutions and matmuls summed in different orders; three
Adam rounds from the same φ do not move a metric further)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.data.synth_femnist import make_femnist as jax_make_femnist
from repro.federated.async_engine import plan_blocks as jax_plan_blocks
from repro.federated.comm import CommTracker as JaxComm
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_femnist
from repro_torch.federated.async_engine import (Prefetcher, StalenessConfig,
                                                WorkerPool, plan_blocks)
from repro_torch.federated.comm import CommTracker
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.paper import femnist_cnn
from repro_torch.optim import adam

NET = dict(rtol=1e-4, atol=1e-5)
TRAIN = dict(clients_per_round=4, support_frac=0.2, support_size=8,
             query_size=8, seed=0, packed=True, client_plane=True)


@pytest.fixture(scope="module")
def runs():
    """Three rounds with an eval at round 2 and at the last, each side."""
    jm = jax_femnist_cnn(62, hidden=16)
    theta = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr, jval, _ = jax_make_femnist(num_clients=30, mean_samples=30,
                                    seed=0).split_clients(0)
    ttr, tval, _ = make_femnist(num_clients=30, mean_samples=30,
                                seed=0).split_clients(0)
    jt = JaxTrainer(jax_make_algorithm("fomaml", *jax_cls_loss(jm.apply),
                                       0.05), jax_adam(1e-3), jtr,
                    impl="pallas_interpret", **TRAIN)
    js = jt.run(jt.init(0, lambda k: jax.tree.map(jnp.asarray, theta)), 3,
                eval_every=2, eval_clients=jval)
    tm = femnist_cnn(62, hidden=16, device="cpu")
    tt = FederatedTrainer(make_algorithm("fomaml", *classification_loss(
        tm.apply), 0.05), adam(1e-3), ttr, impl="cuda", device="cpu",
        **TRAIN)
    ts = tt.run(tt.init(0, lambda k: from_numpy_tree(theta, "cpu")), 3,
                eval_every=2, eval_clients=tval)
    return jt, js, tt, ts, theta


def test_history_records_match_reference(runs):
    jt, _, tt, _, _ = runs
    assert len(tt.history) == len(jt.history) == 3
    for a, b in zip(tt.history, jt.history):
        assert sorted(a) == sorted(b)
        assert [k for k in a if "eval" in k] == [k for k in b if "eval" in k]
        for k in ("round", "rounds", "comm_MB", "upload_MB", "download_MB",
                  "phi_MB", "client_GFLOPs"):
            if k != "client_GFLOPs":        # XLA-measured in the reference
                assert a[k] == b[k], k
        for k in ("query_loss", "accuracy", "eval_acc", "eval_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], **NET)
    assert [r["round"] for r in tt.history if "eval_acc" in r] == [2, 3]
    assert tt.history[-1]["client_GFLOPs"] == 0.0    # FLOPs not counted


def test_byte_counts_equal_reference_exactly(runs):
    jt, js, tt, ts, _ = runs
    for k in ("phi_bytes", "clients_per_round", "rounds", "grad_bytes",
              "download_bytes", "upload_bytes", "total_bytes"):
        assert getattr(tt.comm, k) == getattr(jt.comm, k), k
    # 3 rounds × 4 clients × (download + upload) of the f32 φ
    assert tt.comm.total_bytes == 3 * 4 * 2 * tt.comm.phi_bytes
    # a bf16 client-gradient block halves the upload leg, as there
    t16 = CommTracker.for_state(tt.phi_tree(ts), 4,
                                block_dtype=torch.bfloat16)
    j16 = JaxComm.for_state(jt.phi_tree(js), 4, block_dtype=jnp.bfloat16)
    t16.tick(5)
    j16.tick(5)
    assert t16.summary() == j16.summary()


def test_phi_matches_reference(runs):
    """The first Adam moment (a running mean of the meta-gradients) at
    NET; φ within 2·lr per step, the most that a near-zero meta-gradient
    entry can move (see test_torch_fedmeta)."""
    jt, js, tt, ts, _ = runs
    np.testing.assert_allclose(
        ts["opt"]["m"].numpy(), np.asarray(js["opt"]["m"]), **NET)
    np.testing.assert_allclose(ts["phi"].numpy(), np.asarray(js["phi"]),
                               rtol=0, atol=3 * 2 * 1e-3)


@pytest.mark.parametrize("packed", [False, True])
def test_tree_and_packed_pipelines_agree_with_the_client_plane(runs, packed):
    """Two rounds of the tree pipeline, and of the packed plane without
    the client plane, from the same φ: the same records as the client
    plane's first two (rtol 1e-5 / atol 1e-6: the same math, summed in
    another order)."""
    _, _, tt, _, theta = runs
    tm = femnist_cnn(62, hidden=16, device="cpu")
    ttr, _, _ = make_femnist(num_clients=30, mean_samples=30,
                             seed=0).split_clients(0)
    algo = make_algorithm("fomaml", *classification_loss(tm.apply), 0.05)
    other = FederatedTrainer(algo, adam(1e-3), ttr, device="cpu",
                             **{**TRAIN, "packed": packed,
                                "client_plane": False})
    other.run(other.init(0, lambda k: from_numpy_tree(theta, "cpu")), 2)
    for a, b in zip(other.history, tt.history[:2], strict=True):
        assert a["comm_MB"] == b["comm_MB"]
        for k in ("query_loss", "accuracy"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


def test_plan_blocks_match_reference_and_async_classes_raise():
    """`plan_blocks` is the reference's; the async classes construct and
    run (a prefetched block, a pool map, a straggler pick) and raise the
    reference's `ValueError` on arguments it refuses."""
    for args in ((10, 4, 3), (10, 4, 3, 4), (7, 0, 1), (5, 5, 1, 5)):
        assert plan_blocks(*args) == jax_plan_blocks(*args)
    pf = Prefetcher(lambda k: k * 10, [1, 2], depth=1)
    try:
        assert (pf.get(), pf.get()) == (10, 20)
    finally:
        pf.close()
    pool = WorkerPool(lambda i: -i, workers=2)
    try:
        assert pool.map([1, 2, 3], label="round 1") == [-1, -2, -3]
    finally:
        pool.close()
    strag, fresh = StalenessConfig(fraction=0.25).pick(
        4, np.random.RandomState(0))
    assert sorted(strag.tolist() + fresh.tolist()) == [0, 1, 2, 3]
    for make in (lambda: StalenessConfig(delay=0),
                 lambda: StalenessConfig(fraction=1.0),
                 lambda: WorkerPool(lambda i: i, workers=0)):
        with pytest.raises(ValueError):
            make()


@pytest.mark.parametrize("kw", [{"unreliability": object()},
                                {"round_deadline": 2.0},
                                {"mesh": "1x1"}, {"mesh_axis": "data"},
                                {"over_select": 0.5},
                                {"client_axis": "sharded"}])
def test_trainer_knobs_of_later_slices_raise(kw, tmp_path):
    """The population plane's knobs, off the packed pipeline, raise the
    reference's ValueError naming the population plane. The sharded
    axis's knobs run: ``client_axis="sharded"`` with no process group (a
    world of one), on a 1x1 host mesh (``mesh``), or on the mesh's
    "data" axis (``mesh_axis``; a gloo group of one over a FileStore),
    gives 2 rounds whose history and φ are bitwise the vmap trainer's."""
    if {"unreliability", "round_deadline", "over_select"} & set(kw):
        algo = make_algorithm("fomaml", lambda p, b: 0,
                              lambda p, b: (0, {}), 0.1)
        with pytest.raises(ValueError, match="population plane"):
            FederatedTrainer(algo, adam(1e-3), [], device="cpu",
                             **{**TRAIN, "packed": False,
                                "client_plane": False, **kw})
        return
    import contextlib

    import torchdist
    from repro_torch.launch.mesh import make_host_mesh
    tm = femnist_cnn(62, hidden=8, device="cpu")
    clients = make_femnist(num_clients=12, mean_samples=20,
                           seed=0).split_clients(0)[0]

    def run(**extra):
        tr = FederatedTrainer(make_algorithm("fomaml", *classification_loss(
            tm.apply), 0.05), adam(1e-3), clients, impl="cuda",
            device="cpu", **{**TRAIN, **extra})
        state = tr.run(tr.init(0, tm.init), 2)
        return tr.history, tr.phi_tree(state)

    ctx = contextlib.nullcontext() if "client_axis" in kw else \
        torchdist.world(tmp_path)
    with ctx:
        extra = {"client_axis": "sharded"}
        if "mesh" in kw or "mesh_axis" in kw:
            extra["mesh"] = make_host_mesh(1, 1, device_type="cpu")
            extra["mesh_axis"] = kw.get("mesh_axis")
        h0, p0 = run(**extra)
    h1, p1 = run()
    assert h0 == h1
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(to_numpy_tree(p0)),
        jax.tree.leaves(to_numpy_tree(p1))))


def _exclusions():
    """(id, port knobs, reference knobs): configurations the reference's
    trainer refuses with a ValueError (`server.py:175-240`)."""
    from repro.federated.async_engine import StalenessConfig as JS
    from repro.federated.faults import FaultConfig as JF
    from repro.kernels.meta_update.compress import CompressionConfig as JC
    from repro_torch.federated.faults import FaultConfig
    from repro_torch.kernels.meta_update.compress import CompressionConfig
    tree = dict(packed=False, client_plane=False)
    chunked = dict(client_axis="chunked", client_chunk=2)
    both = [
        ("fuse-off-packed", dict(fuse_rounds=2, **tree)),
        ("stale-fuse", dict(fuse_rounds=2), "stale"),
        ("stale-off-packed", dict(**tree), "stale"),
        ("stale-off-vmap", dict(**chunked), "stale"),
        ("stale-compression", dict(), "stale", "int8"),
        ("faults-fuse", dict(fuse_rounds=2), "faults"),
        ("faults-off-vmap", dict(**chunked), "faults"),
        ("trimmed-2trim", dict(aggregator="trimmed", trim=2)),
        ("robust-off-packed", dict(aggregator="screen", **tree)),
        ("compression-fuse", dict(fuse_rounds=2), "int8"),
        ("compression-faults", dict(), "int8", "faults"),
        ("compression-off-vmap", dict(**chunked), "int8"),
        ("guard-off-packed", dict(guard=True, **tree)),
        ("client-plane-off-packed", dict(packed=False, client_plane=True)),
        ("unknown-aggregator", dict(aggregator="median")),
    ]
    port = {"stale": ("staleness", StalenessConfig()),
            "faults": ("faults", FaultConfig(dropout=0.25)),
            "int8": ("compression", CompressionConfig("int8"))}
    ref = {"stale": ("staleness", JS()), "faults": ("faults", JF(dropout=0.25)),
           "int8": ("compression", JC("int8"))}
    out = []
    for name, kw, *extra in both:
        out.append(pytest.param({**kw, **dict(port[e] for e in extra)},
                                {**kw, **dict(ref[e] for e in extra)},
                                id=name))
    return out


@pytest.mark.parametrize("port_kw, ref_kw", _exclusions())
def test_trainer_mutual_exclusions_match_reference(port_kw, ref_kw):
    """Each knob combination the reference refuses with a ValueError, the
    port refuses too."""
    jalgo = jax_make_algorithm("fomaml", lambda p, b: 0,
                               lambda p, b: (0, {}), 0.1)
    with pytest.raises(ValueError):
        JaxTrainer(jalgo, jax_adam(1e-3), [], **{**TRAIN, **ref_kw})
    algo = make_algorithm("fomaml", lambda p, b: 0, lambda p, b: (0, {}), 0.1)
    with pytest.raises(ValueError):
        FederatedTrainer(algo, adam(1e-3), [], device="cpu",
                         **{**TRAIN, **port_kw})
