"""Port parity: the FEMNIST CNN (NHWC input, HWIO convolutions) and the
classification losses, with the reference's φ carried over by
`convert`.

Tolerance rtol 1e-4 / atol 1e-5: two convolutions and two matmuls that
XLA and PyTorch sum in different orders (the LM tests' tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.losses import classification_loss as jax_cls_loss
from repro.core.losses import topk_accuracy as jax_topk
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.losses import classification_loss, topk_accuracy
from repro_torch.models.paper import femnist_cnn
from repro_torch.utils.flat import plane_for

NET = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cnn():
    jm = jax_femnist_cnn(62, image_size=28, hidden=32)
    tm = femnist_cnn(62, image_size=28, hidden=32, device="cpu")
    jphi = jm.init(jax.random.PRNGKey(0))
    tphi = from_numpy_tree(jax.tree.map(np.asarray, jphi), "cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(5, 28, 28).astype(np.float32)
    y = rng.randint(0, 62, (5,)).astype(np.int32)
    return jm, tm, jphi, tphi, x, y


def test_init_layout_matches_reference(cnn):
    jm, tm, jphi, _, _, _ = cnn
    tphi = tm.init(0)
    jp, tp = jax_plane_for(jphi), plane_for(tphi)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]
    w = tphi["c2"]["w"]            # ±2σ truncated normal / sqrt(fan-in)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(5 * 5 * 32) + 1e-6


def test_logits_loss_and_gradients_match_reference(cnn):
    jm, tm, jphi, tphi, x, y = cnn
    for xx in (x, x[..., None]):          # (B, H, W) and NHWC
        np.testing.assert_allclose(
            tm.apply(tphi, torch.from_numpy(xx)).detach().numpy(),
            np.asarray(jm.apply(jphi, jnp.asarray(xx))), **NET)
    jloss, jeval = jax_cls_loss(jm.apply, topk=(4,))
    tloss, teval = classification_loss(tm.apply, topk=(4,))
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    jl, jmet = jeval(jphi, (jnp.asarray(x), jnp.asarray(y)))
    tl, tmet = teval(tphi, batch)
    np.testing.assert_allclose(float(tl), float(jl), **NET)
    assert sorted(tmet) == sorted(jmet) == ["accuracy", "top4"]
    for k in tmet:
        assert float(tmet[k]) == float(jmet[k])
    jg = jax.grad(jloss)(jphi, (jnp.asarray(x), jnp.asarray(y)))
    leaves = jax.tree.leaves(tphi)
    req = [t.detach().requires_grad_(True) for t in leaves]
    treedef = jax.tree.structure(jphi)
    loss = tloss(jax.tree.unflatten(treedef, req), batch)
    tg = torch.autograd.grad(loss, req)
    for a, b in zip(tg, jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **NET)


def test_topk_accuracy_matches_reference():
    rng = np.random.RandomState(2)
    logits = rng.randn(40, 10).astype(np.float32)
    labels = rng.randint(0, 10, (40,)).astype(np.int32)
    for k in (1, 3):
        assert float(topk_accuracy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), k)) == \
            float(jax_topk(jnp.asarray(logits), jnp.asarray(labels), k))
