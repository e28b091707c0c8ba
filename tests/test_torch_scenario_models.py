"""Port parity: the scenario models (`char_lstm`, `sent_lstm`, `rec_lr`,
`rec_nn`) against the JAX package's, at small widths, f32.

Each model runs on the reference's parameters (`convert.from_numpy_tree`,
no remapping): the forward pass, the gradient of the classification
loss (`jax.grad` against torch autograd), the per-row gradients over a
client axis (`jax.vmap(jax.grad(...))` against `torch.func.vmap(
torch.func.grad(...))`, which the LSTM's functional time loop allows),
and the client plane's meta-gradients (`client_grad_chunk_packed`) of
FOMAML, MAML (second order, through the LSTM twice) and Meta-SGD. All at
rtol 1e-5, with an absolute floor of 1e-6 of the largest entry for the
entries that cancel to near zero."""
import jax
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.models.paper import models as jm
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.models.paper import models as tm
from repro_torch.utils.flat import plane_for

RTOL = 1e-5
B, C = 6, 3

# name -> (factory name, args, kwargs, input kind, input width, classes)
MODELS = {
    "char_lstm": ("char_lstm", (20,), dict(hidden=16, embed_dim=4),
                  "tokens", 9, 20),
    "sent_lstm": ("sent_lstm", (50,), dict(hidden=12, embed_dim=8),
                  "tokens", 11, 2),
    "rec_lr": ("rec_lr", (14, 6), {}, "features", 14, 6),
    "rec_nn": ("rec_nn", (14, 6), dict(hidden=10), "features", 14, 6),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name):
    fn, args, kw = MODELS[name][:3]
    return getattr(jm, fn)(*args, **kw), \
        getattr(tm, fn)(*args, **kw, device="cpu")


def _batch(name, rng, lead=()):
    kind, width, classes = MODELS[name][3:]
    if kind == "tokens":
        vocab = MODELS[name][1][0]
        x = rng.randint(0, vocab, size=lead + (B, width)).astype(np.int32)
    else:
        x = rng.randn(*lead, B, width).astype(np.float32)
    y = rng.randint(0, classes, size=lead + (B,)).astype(np.int32)
    return x, y


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * scale)


def _close_trees(t_tree, j_tree):
    t_leaves = jax.tree.leaves(to_numpy_tree(t_tree))
    j_leaves = jax.tree.leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        _close(a, b)


def _params(name, seed=0):
    jmod, tmod = _models(name)
    p = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    return jmod, tmod, p, from_numpy_tree(p, "cpu")


@pytest.mark.parametrize("name", list(MODELS))
def test_init_layout_matches_reference(name):
    """The port's own init draws other numbers but the same dict: keys,
    shapes and dtypes (so a reference φ packs into the same plane)."""
    jmod, tmod = _models(name)
    j = jax.tree_util.tree_flatten_with_path(jmod.init(jax.random.PRNGKey(0)))
    t = to_numpy_tree(tmod.init(0))
    tl = jax.tree_util.tree_flatten_with_path(t)[0]
    assert [(p, a.shape, a.dtype) for p, a in j[0]] == \
        [(p, a.shape, a.dtype) for p, a in tl]
    assert plane_for(tmod.init(0)).n_padded == \
        jax_plane_for(jmod.init(jax.random.PRNGKey(0))).n_padded
    assert tmod.name == jmod.name


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_reference(name):
    jmod, tmod, p, tp = _params(name)
    x, _ = _batch(name, np.random.RandomState(1))
    _close(tmod.apply(tp, torch.as_tensor(x)).numpy(),
           np.asarray(jax.jit(jmod.apply)(p, x)))


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_gradient_matches_reference(name):
    jmod, tmod, p, tp = _params(name)
    x, y = _batch(name, np.random.RandomState(2))
    jloss = jax_cls_loss(jmod.apply)[0]
    tloss = classification_loss(tmod.apply)[0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(p, (x, y))
    leaves = [v.requires_grad_(True) for v in jax.tree.leaves(tp)]
    tl = tloss(tp, (torch.as_tensor(x), torch.as_tensor(y)))
    gs = torch.autograd.grad(tl, leaves)
    _close(tl.item(), float(jl))
    for a, b in zip(gs, jax.tree.leaves(jg)):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(MODELS))
def test_row_gradients_under_vmap_match_reference(name):
    """C clients, each with its own parameters and batch:
    `torch.func.vmap(torch.func.grad(loss))` row for row against
    `jax.vmap(jax.grad(loss))` (the embedding lookup indexes each row's
    own table)."""
    jmod, tmod = _models(name)
    rows = [jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(s)))
            for s in range(C)]
    P = jax.tree.map(lambda *xs: np.stack(xs), *rows)
    x, y = _batch(name, np.random.RandomState(3), lead=(C,))
    jg = jax.jit(jax.vmap(jax.grad(jax_cls_loss(jmod.apply)[0])))(P, (x, y))
    tloss = classification_loss(tmod.apply)[0]
    tg = torch.func.vmap(torch.func.grad(tloss))(
        from_numpy_tree(P, "cpu"), (torch.as_tensor(x), torch.as_tensor(y)))
    _close_trees(tg, jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("method", ["fomaml", "maml", "meta-sgd"])
@pytest.mark.parametrize("name", list(MODELS))
def test_client_plane_meta_gradients_match_reference(name, method):
    """`client_grad_chunk_packed` over C clients of the flat plane: the
    (C, N) meta-gradient block and the per-row query losses. MAML and
    Meta-SGD differentiate through the inner step (for the LSTMs, the
    time loop twice)."""
    jmod, tmod = _models(name)
    lr = 0.05
    jalgo = jax_make_algorithm(method, *jax_cls_loss(jmod.apply), lr)
    talgo = make_algorithm(method, *classification_loss(tmod.apply), lr)
    phi = jax.tree.map(np.asarray,
                       jalgo.init_state(jax.random.PRNGKey(4), jmod.init))
    rng = np.random.RandomState(5)
    sup, qry = _batch(name, rng, lead=(C,)), _batch(name, rng, lead=(C,))
    pplane, tplane = jax_plane_for(phi), jax_plane_for(phi["theta"])
    jG, jmet = jax.jit(lambda *a: jalgo.client_grad_chunk_packed(
        pplane, tplane, *a))(phi, sup, qry)
    tphi = from_numpy_tree(phi, "cpu")
    tsup = tuple(torch.as_tensor(a) for a in sup)
    tqry = tuple(torch.as_tensor(a) for a in qry)
    tG, tmet = talgo.client_grad_chunk_packed(
        plane_for(tphi), plane_for(tphi["theta"]), tphi, tsup, tqry)
    assert tuple(tG.shape) == jG.shape
    for c in range(C):
        _close(tG[c].detach().numpy(), np.asarray(jG[c]))
    _close(tmet["query_loss"].detach().numpy(),
           np.asarray(jmet["query_loss"]))
    np.testing.assert_array_equal(tmet["accuracy"].detach().numpy(),
                                  np.asarray(jmet["accuracy"]))


def test_lstm_gates_follow_the_reference_layout():
    """One hand-computed LSTM step: [x, h] @ w + b split i, f, g, o,
    the forget gate biased by +1, and h from the last step into out."""
    p = {"w": torch.randn(3 + 2, 8, generator=torch.Generator().manual_seed(0)),
         "b": torch.linspace(-1, 1, 8)}
    x = torch.randn(1, 1, 3, generator=torch.Generator().manual_seed(1))
    hs = tm._lstm_layer(p, x, 2)
    z = torch.cat([x[0, 0], torch.zeros(2)]) @ p["w"] + p["b"]
    i, f, g, o = z[:2], z[2:4], z[4:6], z[6:]
    c = torch.sigmoid(f + 1.0) * 0 + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(hs[0, 0], torch.sigmoid(o) * torch.tanh(c),
                               rtol=0, atol=0)
