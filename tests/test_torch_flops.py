"""Client FLOPs: a reference behaviour the port does not reproduce.

The reference's `measure_client_flops` (`repro/federated/comm.py:143`)
reads XLA's `cost_analysis()`, which counts the body of a `lax.scan`
(a while loop) ONCE, whatever its trip count. The port's
(`repro_torch/federated/comm.py`) counts with PyTorch's
`FlopCounterMode`, whose recurrences are Python loops, so every step
counts. A recurrent model's ``client_GFLOPs`` therefore reads about T
times the reference's (the Sent140 replay: 4.40 against 0.20 GFLOPs,
T = 25 tokens). The port keeps the true count; these tests pin the
cause and the band the ratio must lie in."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classification_loss as jax_cls_loss
from repro.core import make_algorithm as jax_make_algorithm
from repro.data.synth_sent140 import make_sent140 as jax_make_sent140
from repro.federated.comm import measure_client_flops as jax_flops
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.models.paper.models import sent_lstm as jax_sent_lstm
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_sent140
from repro_torch.federated.comm import measure_client_flops
from repro_torch.federated.server import FederatedTrainer
from repro_torch.models.paper import sent_lstm
from repro_torch.optim import adam

T = 25                       # Sent140's tokens a tweet
B, H = 8, 64
STEP_FLOPS = 2 * B * H * H   # one step's (8, 64) @ (64, 64)


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


def _w():
    return np.random.RandomState(0).normal(0, 0.1, (H, H)).astype(np.float32)


def _reference_recurrence(steps):
    w = jnp.asarray(_w())

    def run(h):
        def body(h, _):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, h, None, length=steps)[0]

    return jax_flops(run, jnp.ones((B, H), jnp.float32))


def _port_recurrence(steps):
    w = torch.from_numpy(_w())

    def run(h):
        for _ in range(steps):
            h = torch.tanh(h @ w)
        return h

    return measure_client_flops(run, torch.ones((B, H)))


def test_reference_counts_a_scan_body_once():
    """XLA's cost analysis of a T-step scan reports one step's flops: the
    T = 25 count is the T = 1 count within the loop's own bookkeeping."""
    one, many = _reference_recurrence(1), _reference_recurrence(T)
    assert one >= STEP_FLOPS
    assert one <= many < one + 0.01 * STEP_FLOPS


def test_port_counts_every_step():
    """The port's count of the same recurrence, a Python loop, is T
    times one step's matmul: 2·B·H·H each."""
    assert _port_recurrence(1) == STEP_FLOPS
    assert _port_recurrence(T) == T * STEP_FLOPS


def _trainers():
    """Both trainers on the Sent140 registry plan's shapes (8 clients, 16
    support and 16 query tweets of 25 tokens, `sent_lstm(2000, 32, 16)`),
    the port from the reference's φ."""
    kw = dict(clients_per_round=8, support_frac=0.2, support_size=16,
              query_size=16, seed=0, packed=True)
    jm = jax_sent_lstm(vocab=2000, hidden=32, embed_dim=16)
    jtrain, _, _ = jax_make_sent140(num_clients=20, seed=0).split_clients(0)
    jt = JaxTrainer(jax_make_algorithm("fomaml", *jax_cls_loss(jm.apply),
                                       0.01), jax_adam(1e-3), jtrain,
                    impl="xla", **kw)
    js = jt.init(jax.random.PRNGKey(0), jm.init)
    theta = jax.tree.map(np.asarray, jt.phi_tree(js)["theta"])
    tm = sent_lstm(vocab=2000, hidden=32, embed_dim=16, device="cpu")
    ttrain, _, _ = make_sent140(num_clients=20, seed=0).split_clients(0)
    tt = FederatedTrainer(make_algorithm("fomaml", *classification_loss(
        tm.apply), 0.01), adam(1e-3), ttrain, device="cpu", **kw)
    ts = tt.init(0, None, phi={"theta": from_numpy_tree(theta, "cpu")})
    return jt, js, tt, ts


def test_sent_lstm_client_flops_ratio_lies_in_the_band_of_t():
    """FOMAML's client procedure on the Sent140 LSTM: the port's count
    over the reference's lies in [T/2, T].

    Upper bound T: both count a matmul as 2·M·N·K; the port counts
    matmuls only, each recurrent one T times, while XLA counts each
    scan body (forward and backward) once with its elementwise work, and
    the non-recurrent part (the head; the embedding is a gather) once
    each. Lower bound T/2: an LSTM cell's elementwise work (O(4H) a row)
    is below its gate matmul's (2·(E + H)·4H a row), so XLA's count of a
    step is at most twice its matmuls'."""
    jt, js, tt, ts = _trainers()
    ref, port = jt.measure_flops(js), tt.measure_flops(ts)
    ratio = port / ref
    assert T / 2 <= ratio <= T, (port, ref, ratio)
    assert tt.comm.flops_per_client == port
