"""The `sent_lstm` NaN gotcha, replayed: `examples/quickstart.py`'s
FedMeta run (Sent140 at 60 clients, `sent_lstm(vocab=2000, hidden=32,
embed_dim=16)`, MAML at inner lr 0.01, Adam 1e-3, 4 clients a round of
16 + 16 samples) in both packages from the reference's initial φ
(`PRNGKey(0)`), one round at a time.

After every round the NaN masks of the two φ must be equal, and the
finite entries within rtol 1e-5 and an atol of 1e-5 of the largest |φ|
(the f32 rule; the gap seen is ~6.5e-7 over 120 rounds); the rounds'
query losses at rtol 1e-5.

What this pins: the reference shows no NaN φ entry within ``ROUNDS``
rounds, and neither does the port. The gotcha as written ("NaN φ
entries within a few rounds") is not reproduced by the reference on
this tree: its quickstart's full 120 rounds leave φ finite on the tree,
packed and client-plane pipelines, and with FOMAML, Meta-SGD and
Reptile too. ``ROUNDS`` is cut from the quickstart's 120 to hold the
file near 20 s serial.

Serial time: ~20 s.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import classification_loss as jax_classification_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data import make_sent140 as jax_make_sent140
from repro.federated.server import FederatedTrainer as JaxFederatedTrainer
from repro.models.paper import sent_lstm as jax_sent_lstm
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_sent140
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.paper import sent_lstm
from repro_torch.optim import adam
from repro_torch.utils.pytree import tree_leaves

ROUNDS = 40
MODEL = dict(vocab=2000, hidden=32, embed_dim=16)
TRAINER = dict(clients_per_round=4, support_frac=0.2, support_size=16,
               query_size=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(leaves):
    return np.concatenate([np.ravel(np.asarray(a)) for a in leaves])


@pytest.fixture(scope="module")
def reference():
    """The reference's initial φ, then its φ and query loss after each
    round."""
    train = jax_make_sent140(num_clients=60, seed=0).split_clients(seed=0)[0]
    model = jax_sent_lstm(**MODEL)
    loss_fn, eval_fn = jax_classification_loss(model.apply)
    tr = JaxFederatedTrainer(
        jax_make_algorithm("maml", loss_fn, eval_fn, inner_lr=0.01),
        jax_adam(1e-3), train, **TRAINER)
    state = tr.init(jax.random.PRNGKey(0), model.init)
    phi0 = jax.tree.map(np.asarray, tr.phi_tree(state))
    phis, losses = [], []
    for _ in range(ROUNDS):
        state = tr.run(state, 1)
        phis.append(_flat(jax.tree.leaves(tr.phi_tree(state))))
        losses.append(tr.history[-1]["query_loss"])
    return phi0, phis, losses


@pytest.fixture(scope="module")
def port(reference):
    phi0 = reference[0]
    train = make_sent140(num_clients=60, seed=0).split_clients(seed=0)[0]
    model = sent_lstm(**MODEL, device="cpu")
    loss_fn, eval_fn = classification_loss(model.apply)
    tr = FederatedTrainer(make_algorithm("maml", loss_fn, eval_fn,
                                         inner_lr=0.01),
                          adam(1e-3), train, device="cpu", **TRAINER)
    state = tr.init(0, model.init, phi=from_numpy_tree(phi0, "cpu"))
    phis, losses = [], []
    for _ in range(ROUNDS):
        state = tr.run(state, 1)
        phis.append(_flat([a.detach().numpy()
                           for a in tree_leaves(tr.phi_tree(state))]))
        losses.append(tr.history[-1]["query_loss"])
    return phis, losses


def test_nan_masks_and_finite_entries_every_round(reference, port):
    _, jphis, _ = reference
    tphis, _ = port
    for r, (t, j) in enumerate(zip(tphis, jphis), start=1):
        assert t.shape == j.shape
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j),
                                      err_msg=f"round {r}")
        live = ~np.isnan(j)
        np.testing.assert_allclose(
            t[live], j[live], rtol=1e-5,
            atol=1e-5 * float(np.abs(j[live]).max()), err_msg=f"round {r}")


def test_query_losses_every_round(reference, port):
    np.testing.assert_allclose(port[1], reference[2], rtol=1e-5)


def test_no_nan_phi_within_the_rounds(reference, port):
    """Pinned: the reference's quickstart run keeps φ finite here, so
    the masks compared above are empty; a NaN in either package from
    this init is a change to look at."""
    assert not any(np.isnan(j).any() for j in reference[1])
    assert not any(np.isnan(t).any() for t in port[0])
