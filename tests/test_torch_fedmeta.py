"""Port parity: the meta-learners' client gradients and the FedMeta round
step (tree and packed pipelines, vmap and chunked client axes) against
the JAX package, whose kernels run in Pallas interpret mode. The
reference's φ is carried over by `convert`; batches come from seeded
numpy streams.

Tolerance rtol 1e-4 / atol 1e-5 (the LM tests' tolerance): gradients go
through convolutions and matmuls that XLA and PyTorch sum in different
orders, and second-order gradients through them twice. After an Adam
step φ is held through `_close_after_adam`: Adam divides m by sqrt(v),
so where a meta-gradient entry is near zero a last-bit difference moves
that entry's step by up to 2·lr. Port-vs-port contracts (the guard is a
no-op on a clean round) are bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import fedmeta as jfm
from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.core.losses import lm_loss as jax_lm_loss
from repro.launch.steps import make_apply_fn as jax_apply_fn
from repro.models import init_lm as jax_init_lm
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.optim import adam as jax_adam
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core import fedmeta as tfm
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss, lm_loss
from repro_torch.launch.steps import make_apply_fn
from repro_torch.models.paper import femnist_cnn
from repro_torch.optim import adam
from repro_torch.utils.flat import plane_for

NET = dict(rtol=1e-4, atol=1e-5)
ALGOS = ["maml", "fomaml", "meta-sgd", "reptile"]
IMG, HID, INNER_LR = 12, 16, 0.05


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=NET):
    got, want = _np(to_numpy_tree(got)), _np(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(_np(tree))])


def _close_after_adam(t_phi, j_phi, t_m, j_m, lr):
    """The first moment m (a running mean of the meta-gradients) at NET;
    φ at NET where |m| > 1e-6·max|m|, within 2·lr elsewhere."""
    tm, jm = _flat(to_numpy_tree(t_m)), _flat(j_m)
    np.testing.assert_allclose(tm, jm, **NET)
    tp, jp = _flat(to_numpy_tree(t_phi)), _flat(j_phi)
    jm = jm[:tp.size]          # a packed m carries the plane's zero tail
    live = np.abs(jm) > 1e-6 * np.abs(jm).max()
    np.testing.assert_allclose(tp[live], jp[live], **NET)
    assert np.all(np.abs(tp - jp) <= 2 * lr * (1 + 1e-5))


@pytest.fixture(scope="module")
def cnn():
    jm = jax_femnist_cnn(10, image_size=IMG, hidden=HID)
    tm = femnist_cnn(10, image_size=IMG, hidden=HID, device="cpu")
    theta = _np(jm.init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    alpha = jax.tree.map(lambda p: (INNER_LR * (0.5 + rng.rand(*p.shape))
                                    ).astype(np.float32), theta)
    return jm, tm, theta, alpha


def _algos(cnn, name, steps=1):
    jm, tm, _, _ = cnn
    return (jax_make_algorithm(name, *jax_cls_loss(jm.apply), INNER_LR, steps),
            make_algorithm(name, *classification_loss(tm.apply), INNER_LR,
                           steps))


def _phi(cnn, name):
    _, _, theta, alpha = cnn
    return ({"theta": theta, "alpha": alpha} if name.startswith("meta-sgd")
            else {"theta": theta})


def _batches(seed, m, S=6, Q=5):
    rng = np.random.RandomState(seed)
    sup = (rng.rand(m, S, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, S)).astype(np.int32))
    qry = (rng.rand(m, Q, IMG, IMG).astype(np.float32),
           rng.randint(0, 10, (m, Q)).astype(np.int32))
    return sup, qry


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return from_numpy_tree(tree, "cpu")


# ---- client gradients ------------------------------------------------------

@pytest.mark.parametrize("name", ALGOS)
def test_client_grad_matches_reference(cnn, name):
    """Tree path, one client (Reptile: 2 inner steps)."""
    ja, ta = _algos(cnn, name, steps=2 if name == "reptile" else 1)
    phi = _phi(cnn, name)
    sup, qry = _batches(1, 1)
    one = lambda t: jax.tree.map(lambda x: x[0], t)    # noqa: E731
    jg, jmet = jax.jit(ja.client_grad)(_j(phi), _j(one(sup)), _j(one(qry)))
    tg, tmet = ta.client_grad(_t(phi), _t(one(sup)), _t(one(qry)))
    _close(tg, jg)
    assert sorted(tmet) == sorted(jmet)
    _close(tmet, jmet)


@pytest.mark.parametrize("name", ALGOS)
def test_client_grad_chunk_packed_matches_reference(cnn, name):
    """Client plane, a chunk of 3 clients: flat (C, N_φ) rows and
    per-client metrics (the reference's kernels in interpret mode)."""
    ja, ta = _algos(cnn, name)
    phi = _phi(cnn, name)
    sup, qry = _batches(2, 3)
    jp, jt = jax_plane_for(_j(phi)), jax_plane_for(_j(phi["theta"]))
    tphi = _t(phi)
    tp, tt = plane_for(tphi), plane_for(tphi["theta"])
    jG, jmet = jax.jit(lambda *a: ja.client_grad_chunk_packed(
        jp, jt, *a, impl="pallas_interpret"))(_j(phi), _j(sup), _j(qry))
    tG, tmet = ta.client_grad_chunk_packed(tp, tt, tphi, _t(sup), _t(qry),
                                           impl="cuda")
    assert tG.shape == (3, tp.n_padded) and tG.dtype == torch.float32
    np.testing.assert_allclose(tG.numpy(), np.asarray(jG), **NET)
    assert torch.all(tG[:, tp.n_real:] == 0)
    _close(tmet, jmet)
    # the tree path and the client plane give the same rows
    rows = [tp.pack(ta.client_grad(tphi, *(jax.tree.map(
        lambda x, c=c: x[c], (_t(sup), _t(qry)))))[0]) for c in range(3)]
    torch.testing.assert_close(torch.stack(rows), tG, rtol=1e-5, atol=1e-6)


# ---- the round step --------------------------------------------------------

STEPS = [("tree", "vmap"), ("tree", "chunked"), ("packed", "vmap"),
         ("packed", "chunked"), ("plane", "vmap"), ("plane", "chunked")]


def _steps(cnn, name, pipe, axis):
    ja, ta = _algos(cnn, name)
    kw = dict(client_axis=axis, client_chunk=2 if axis == "chunked" else None)
    phi = _phi(cnn, name)
    if pipe == "tree":
        return (jfm.make_meta_train_step(ja, jax_adam(1e-2), **kw),
                tfm.make_meta_train_step(ta, adam(1e-2), **kw),
                {"phi": _j(phi), "opt": jax_adam(1e-2).init(_j(phi))},
                {"phi": _t(phi), "opt": adam(1e-2).init(_t(phi))},
                lambda s: s["phi"], lambda s: s["phi"])
    jp, tp = jax_plane_for(_j(phi)), plane_for(_t(phi))
    kw["client_plane"] = pipe == "plane"
    js = jfm.make_packed_meta_train_step(ja, jax_adam(1e-2), jp,
                                         impl="pallas_interpret", **kw)
    ts = tfm.make_packed_meta_train_step(ta, adam(1e-2), tp, impl="cuda",
                                         **kw)
    return (js, ts, jfm.init_packed_state(jax_adam(1e-2), jp, _j(phi)),
            tfm.init_packed_state(adam(1e-2), tp, _t(phi)),
            lambda s: jp.unpack(s["phi"]), lambda s: tp.unpack(s["phi"]))


@pytest.mark.parametrize("pipe,axis", STEPS)
def test_round_step_matches_reference(cnn, pipe, axis):
    """Two FOMAML rounds of m = 5 clients with data-count weights; the
    chunked axis pads 5 clients to 3 chunks of 2 with zero weight."""
    js, ts, jstate, tstate, jphi, tphi = _steps(cnn, "fomaml", pipe, axis)
    for r in range(2):
        sup, qry = _batches(10 + r, 5)
        w = np.random.RandomState(r).randint(5, 50, 5).astype(np.float32)
        jstate, jmet = js(jstate, _j(sup), _j(qry), jnp.asarray(w / w.sum()))
        tstate, tmet = ts(tstate, _t(sup), _t(qry), torch.from_numpy(
            w / w.sum()))
        _close(tmet, jmet)
        _close_after_adam(tphi(tstate), jphi(jstate), tstate["opt"]["m"],
                          jstate["opt"]["m"], 1e-2)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 2


def test_second_order_round_on_client_plane_matches_reference(cnn):
    js, ts, jstate, tstate, jphi, tphi = _steps(cnn, "maml", "plane", "vmap")
    sup, qry = _batches(20, 3)
    jstate, jmet = js(jstate, _j(sup), _j(qry))
    tstate, tmet = ts(tstate, _t(sup), _t(qry))
    _close(tmet, jmet)
    _close_after_adam(tphi(tstate), jphi(jstate), tstate["opt"]["m"],
                      jstate["opt"]["m"], 1e-2)


def test_guard_is_a_bitwise_noop_on_a_clean_round(cnn):
    """guard=True adds skipped=0 and changes nothing else."""
    _, ta = _algos(cnn, "fomaml")
    tp = plane_for(_t(_phi(cnn, "fomaml")))
    outs = []
    for guard in (False, True):
        step = tfm.make_packed_meta_train_step(ta, adam(1e-2), tp,
                                               client_plane=True, guard=guard)
        st = tfm.init_packed_state(adam(1e-2), tp, _t(_phi(cnn, "fomaml")))
        for r in range(2):
            st, met = step(st, *map(_t, _batches(30 + r, 3)))
        outs.append((st, met))
    (s0, m0), (s1, m1) = outs
    assert float(m1.pop("skipped")) == 0.0
    assert m0.keys() == m1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert torch.equal(s0["phi"], s1["phi"])
    assert all(torch.equal(s0["opt"][k], s1["opt"][k]) for k in s0["opt"])
    # a NaN meta-gradient skips the round: φ and the step stay put
    step = tfm.make_packed_meta_train_step(ta, adam(1e-2), tp, guard=True)
    sup, qry = _batches(40, 2)
    sup[0][0, 0, 0, 0] = np.nan
    before = s1["phi"].clone()
    s2, met = step(s1, _t(sup), _t(qry))
    assert float(met["skipped"]) == 1.0
    assert torch.equal(s2["phi"], before)
    assert int(s2["opt"]["step"]) == 2


def test_later_slice_knobs_raise(cnn):
    _, ta = _algos(cnn, "fomaml")
    tp = plane_for(_t(_phi(cnn, "fomaml")))
    for kw in ({"client_axis": "sharded"}, {"staleness": object()},
               {"aggregator": "trimmed"}, {"faults": object()},
               {"compression": object()}, {"dp": object()}):
        with pytest.raises(NotImplementedError, match="slice"):
            tfm.make_packed_meta_train_step(ta, adam(1e-2), tp, **kw)


# ---- a packed round of the reduced LM ----------------------------------------

def test_reduced_lm_packed_fomaml_round_matches_reference():
    """One packed FOMAML round on the client plane of the reduced
    SmolLM-360M config (f32), 2 clients of 2 support + 2 query rows."""
    jcfg = jax_reduced_config(jax_get_config("smollm-360m"))
    tcfg = reduced_config(get_config("smollm-360m"))
    theta = _np(jax_init_lm(jax.random.PRNGKey(0), jcfg))
    ja = jax_make_algorithm("fomaml", *jax_lm_loss(jax_apply_fn(jcfg)), 0.05)
    ta = make_algorithm("fomaml", *lm_loss(make_apply_fn(tcfg)), 0.05)
    jp, tp = jax_plane_for(_j({"theta": theta})), plane_for(
        _t({"theta": theta}))
    js = jfm.make_packed_meta_train_step(ja, jax_adam(1e-3), jp,
                                         impl="pallas_interpret",
                                         client_plane=True)
    ts = tfm.make_packed_meta_train_step(ta, adam(1e-3), tp, impl="cuda",
                                         client_plane=True)
    rng = np.random.RandomState(0)
    sup, qry = (rng.randint(0, jcfg.vocab_size, (2, 2, 16)).astype(np.int32)
                for _ in range(2))
    jstate, jmet = js(jfm.init_packed_state(jax_adam(1e-3), jp,
                                            _j({"theta": theta})),
                      jnp.asarray(sup), jnp.asarray(qry))
    tstate, tmet = ts(tfm.init_packed_state(adam(1e-3), tp,
                                            _t({"theta": theta})),
                      torch.from_numpy(sup), torch.from_numpy(qry))
    _close(tmet, jmet)
    _close_after_adam(tstate["phi"], jstate["phi"], tstate["opt"]["m"],
                      jstate["opt"]["m"], 1e-3)
