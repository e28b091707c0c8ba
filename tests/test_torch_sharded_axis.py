"""The sharded client axis (`client_axis="sharded"`) against the JAX
package: the tree, packed and packed client-plane pipelines and all four
algorithms, m = 5 (one zero-weight pad at a world of 2) and the local
chunking case (m = 6, chunk 2).

At a world of one (no process group, and a gloo group of one) the
port's round is held against the reference's sharded round on its
one-device mesh with the "xla" kernels; at a gloo world of 2 (one
spawned world for the module) against the reference's vmap round and
against the reference's own sharded round on 2 host devices (a
subprocess with ``--xla_force_host_platform_device_count=2``; the JAX
package is not changed). The trainer runs sharded rounds at a world of
2 with every accounting field equal to a world of one's.

Tolerance (the f32 rule): the meta-gradient, as Adam's first moment, at
rtol 1e-5 / atol 1e-6 (the reference test's tolerance); φ after Adam at
the same where |m| > 1e-6·max|m| and within 2·lr elsewhere (Adam moves
an entry by at most lr); the query loss at rtol 1e-5. The all-reduce
and the two frameworks sum in different orders, so nothing here is
bitwise except the port's world-one round against its own vmap round.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedmeta as jfm
from repro.core import make_algorithm as jax_make_algorithm
from repro.optim import adam as jax_adam
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core import fedmeta as tfm
from repro_torch.core.algorithms import make_algorithm
from repro_torch.optim import adam
from repro_torch.utils.flat import plane_for

import torchdist

ALGOS = ["maml", "fomaml", "meta-sgd", "reptile"]
PIPELINES = ["tree", "packed", "packed_plane"]
F32 = dict(rtol=1e-5, atol=1e-6)
LR = 1e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases():
    """(name, pipeline, algo, m, chunk) of every round checked."""
    out = [(f"{p}-{a}", p, a, 5, None) for p in PIPELINES for a in ALGOS]
    out += [(f"chunked-{a}", "packed_plane", a, 6, 2) for a in ALGOS]
    return out


CASES = _cases()


def _inputs(m, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 1, (7,)).astype(np.float32),
            "b": rng.normal(0, 1, (3,)).astype(np.float32),
            "sup": rng.normal(0, 1, (m, 7)).astype(np.float32),
            "qry": rng.normal(0, 1, (m, 7)).astype(np.float32),
            "wts": rng.uniform(0.5, 3.0, (m,)).astype(np.float32)}


def _jax_algo(name):
    def loss(p, b):
        return (0.5 * jnp.sum(jnp.square(p["w"] - b))
                + 0.1 * jnp.sum(p["b"] * b[:3].sum()))
    return jax_make_algorithm(name, loss, lambda p, b: (
        loss(p, b), {"accuracy": jnp.zeros(())}), inner_lr=0.1,
        inner_steps=2)


def _torch_algo(name):
    def loss(p, b):
        return (0.5 * torch.sum(torch.square(p["w"] - b))
                + 0.1 * torch.sum(p["b"] * b[:3].sum()))
    return make_algorithm(name, loss, lambda p, b: (
        loss(p, b), {"accuracy": torch.zeros(())}), 0.1, 2)


def _jax_phi(algo_name, x):
    theta = {"w": jnp.asarray(x["w"]), "b": jnp.asarray(x["b"])}
    return _jax_algo(algo_name).init_state(jax.random.PRNGKey(0),
                                           lambda k: theta)


def run_jax(pipeline, algo_name, m, chunk, axis, mesh=None):
    """The reference's round -> (φ tree, m tree, query loss) as numpy."""
    x = _inputs(m)
    algo, opt = _jax_algo(algo_name), jax_adam(LR)
    phi = _jax_phi(algo_name, x)
    sup, qry, w = (jnp.asarray(x[k]) for k in ("sup", "qry", "wts"))
    kw = dict(client_axis=axis, client_chunk=chunk)
    if axis == "sharded":
        kw["mesh"] = mesh
    if pipeline == "tree":
        out, st, met = jax.jit(lambda *a: jfm.federated_meta_step(
            algo, opt, *a, **kw))(phi, opt.init(phi), sup, qry, w)
        m1 = st["m"]
    else:
        plane = jax_plane_for(phi)
        step = jfm.make_packed_meta_train_step(
            algo, opt, plane, impl="xla", donate=False,
            client_plane=pipeline == "packed_plane", **kw)
        st, met = step(jfm.init_packed_state(opt, plane, phi), sup, qry, w)
        out, m1 = plane.unpack(st["phi"]), plane.unpack(st["opt"]["m"])
    return (jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, m1),
            float(met["query_loss"]))


def run_port(pipeline, algo_name, m, chunk, mesh=None, axis="sharded"):
    """The port's round (on the default group's world unless ``mesh``)
    -> (φ tree, m tree, query loss) as numpy."""
    x = _inputs(m)
    algo, opt = _torch_algo(algo_name), adam(LR)
    phi = from_numpy_tree(_phi_np(algo_name, x), "cpu")
    sup, qry, w = (torch.from_numpy(x[k]) for k in ("sup", "qry", "wts"))
    kw = dict(client_axis=axis, client_chunk=chunk, mesh=mesh)
    if pipeline == "tree":
        out, st, met = tfm.federated_meta_step(algo, opt, phi, opt.init(phi),
                                               sup, qry, w, **kw)
        m1 = st["m"]
    else:
        plane = plane_for(phi)
        step = tfm.make_packed_meta_train_step(
            algo, opt, plane, impl="torch",
            client_plane=pipeline == "packed_plane", **kw)
        st, met = step(tfm.init_packed_state(opt, plane, phi), sup, qry, w)
        out, m1 = plane.unpack(st["phi"]), plane.unpack(st["opt"]["m"])
    return to_numpy_tree(out), to_numpy_tree(m1), float(met["query_loss"])


def _phi_np(algo_name, x):
    """φ as numpy, the reference's init (Meta-SGD's α included)."""
    return jax.tree.map(np.asarray, _jax_phi(algo_name, x))


def _hold(got, want):
    """The module's f32 rule (see the docstring)."""
    phi, m1, loss = got
    jphi, jm, jloss = want
    tm = np.concatenate([np.ravel(a) for a in jax.tree.leaves(m1)])
    wm = np.concatenate([np.ravel(a) for a in jax.tree.leaves(jm)])
    np.testing.assert_allclose(tm, wm, **F32)
    tp = np.concatenate([np.ravel(a) for a in jax.tree.leaves(phi)])
    wp = np.concatenate([np.ravel(a) for a in jax.tree.leaves(jphi)])
    live = np.abs(wm) > 1e-6 * np.abs(wm).max()
    np.testing.assert_allclose(tp[live], wp[live], **F32)
    assert np.all(np.abs(tp - wp) <= 2 * LR * (1 + 1e-5))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


@pytest.fixture(scope="module")
def ref_one_device():
    mesh = jax.make_mesh((1,), ("clients",))
    return {name: run_jax(p, a, m, c, "sharded", mesh)
            for name, p, a, m, c in CASES}


@pytest.mark.parametrize("name,pipeline,algo,m,chunk", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_world1_matches_reference(ref_one_device, name, pipeline,
                                          algo, m, chunk):
    """No process group: a world of one, nothing communicated. The round
    equals the reference's sharded round on its one-device mesh, and is
    bitwise the port's own vmap round (chunked the same way)."""
    got = run_port(pipeline, algo, m, chunk)
    _hold(got, ref_one_device[name])
    own = run_port(pipeline, algo, m, chunk,
                   axis="chunked" if chunk else "vmap")
    for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(own[:2])):
        assert np.array_equal(a, b)
    assert got[2] == own[2]


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_sharded_gloo_world1(tmp_path, ref_one_device, pipeline):
    """A gloo group of one, its all-reduce run, and a 1-D DeviceMesh
    passed explicitly: the same round as with no group."""
    from torch.distributed.device_mesh import init_device_mesh
    with torchdist.world(tmp_path):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("clients",))
        got = run_port(pipeline, "meta-sgd", 5, None, mesh=mesh)
        plain = run_port(pipeline, "meta-sgd", 5, None)
    _hold(got, ref_one_device[f"{pipeline}-meta-sgd"])
    for a, b in zip(jax.tree.leaves(got[:2]), jax.tree.leaves(plain[:2])):
        assert np.array_equal(a, b)


# ---- the gloo world of 2 -------------------------------------------------

def _trainer_clients():
    from repro_torch.data import make_femnist
    return make_femnist(num_clients=12, mean_samples=20, seed=0
                        ).split_clients(0)[0]


def _trainer(axis, ckpt=None):
    from repro_torch.core.losses import classification_loss
    from repro_torch.federated.server import FederatedTrainer
    from repro_torch.models.paper import femnist_cnn
    model = femnist_cnn(62, image_size=28, hidden=8, device="cpu")
    algo = make_algorithm("fomaml", *classification_loss(model.apply), 0.05)
    tr = FederatedTrainer(algo, adam(1e-3), _trainer_clients(),
                          clients_per_round=5, support_frac=0.2,
                          support_size=4, query_size=4, seed=0, packed=True,
                          client_plane=True, client_axis=axis,
                          device="cpu", checkpoint_every=2 if ckpt else 0,
                          checkpoint_dir=ckpt)
    state = tr.run(tr.init(0, model.init), 3)
    return tr.history, tr.phi_tree(state)


def world2_worker(rank, ckpt):
    """Every case's round on the sharded axis, and 3 sharded trainer
    rounds, on this rank of the world."""
    rounds = {name: run_port(p, a, m, c) for name, p, a, m, c in CASES}
    history, phi = _trainer("sharded", ckpt)
    return {"rounds": rounds, "history": history,
            "phi": to_numpy_tree(phi)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    ckpt = tmp / "ckpt"
    res = torchdist.spawn_world(tmp, 2, world2_worker, str(ckpt),
                                timeout=600)
    return res, ckpt


REF2_SCRIPT = """
import json, sys
import jax
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_sharded_axis as t
mesh = jax.make_mesh((2,), ("clients",))
assert jax.device_count() == 2
out = {{}}
for name, p, a, m, c in t.CASES:
    phi, m1, loss = t.run_jax(p, a, m, c, "sharded", mesh)
    out[name] = [jax.tree.map(lambda x: x.tolist(), phi),
                 jax.tree.map(lambda x: x.tolist(), m1), loss]
print("REF2" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_two_devices():
    """The reference's own sharded round on 2 forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REF2_SCRIPT.format(
            tests=os.path.join(REPO, "tests"))],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("REF2"))
    raw = json.loads(line[4:])
    return {k: (jax.tree.map(np.asarray, v[0], is_leaf=lambda x:
                             isinstance(x, list)),
                jax.tree.map(np.asarray, v[1], is_leaf=lambda x:
                             isinstance(x, list)), v[2])
            for k, v in raw.items()}


@pytest.mark.parametrize("name,pipeline,algo,m,chunk", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_world2_matches_reference(world2, ref_two_devices, name,
                                          pipeline, algo, m, chunk):
    """Both ranks' rounds are equal to each other, and within the f32
    rule of the reference's vmap round and of its own sharded round on
    2 host devices."""
    (r0, r1), _ = world2
    a, b = r0["rounds"][name], r1["rounds"][name]
    for x, y in zip(jax.tree.leaves(a[:2]), jax.tree.leaves(b[:2])):
        assert np.array_equal(x, y)
    vmap = run_jax(pipeline, algo, m, chunk,
                   "chunked" if chunk else "vmap")
    _hold(a, vmap)
    _hold(a, ref_two_devices[name])


def test_sharded_trainer_world2(world2):
    """3 sharded rounds at a world of 2: every accounting field of every
    history record equals a world of one's, the metrics and φ within
    the f32 rule; only rank 0 wrote the checkpoint."""
    (r0, r1), ckpt = world2
    history, phi = _trainer("sharded")
    for h in (r0["history"], r1["history"]):
        assert len(h) == len(history) == 3
        for got, want in zip(h, history):
            assert got.keys() == want.keys()
            for k in want:
                if isinstance(want[k], float) and k in (
                        "query_loss", "accuracy", "nll"):
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
                else:
                    assert got[k] == want[k], k
    for x, y in zip(jax.tree.leaves(r0["phi"]),
                    jax.tree.leaves(to_numpy_tree(phi))):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=2e-3 * (1 + 1e-5))
    assert sorted(os.listdir(ckpt)) == sorted(
        f for f in os.listdir(ckpt) if f.startswith("step_00000002"))
    assert any(f.startswith("step_00000002") for f in os.listdir(ckpt))
