"""Port parity: the numpy data plane (FEMNIST generator, client split,
task sampling) is the reference's, call for call — the same seed gives
exactly the same arrays and advances a `RandomState` the same way."""
import numpy as np

from repro.data.federated import sample_task_batch as jax_sample
from repro.data.federated import stack_task_batches as jax_stack
from repro.data.synth_femnist import make_femnist as jax_make_femnist
from repro_torch.data import (TaskStream, make_femnist, sample_task_batch,
                              stack_task_batches)


def _equal_batches(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_femnist_clients_and_split_match_reference_exactly():
    ours = make_femnist(num_clients=12, mean_samples=20, seed=3)
    ref = jax_make_femnist(num_clients=12, mean_samples=20, seed=3)
    assert (ours.num_classes, ours.name) == (ref.num_classes, ref.name)
    for a, b in zip(ours.clients, ref.clients, strict=True):
        assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    def ids(ds, part):
        where = {id(c): i for i, c in enumerate(ds.clients)}
        return [where[id(c)] for c in part]

    for sa, sb in zip(ours.split_clients(0), ref.split_clients(0),
                      strict=True):
        assert ids(ours, sa) == ids(ref, sb)


def test_task_draws_match_reference_exactly():
    """Five draws from one stream each, and the streams end in the same
    state: the port advances the RandomState with the same calls."""
    clients = make_femnist(num_clients=12, mean_samples=20, seed=1).clients
    jclients = jax_make_femnist(num_clients=12, mean_samples=20,
                                seed=1).clients
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    stream = TaskStream(clients, 4, 0.2, 6, 5, r1)
    ours = stream.take(3) + [sample_task_batch(clients, 4, 0.2, 6, 5, r1)
                             for _ in range(2)]
    refs = [jax_sample(jclients, 4, 0.2, 6, 5, r2) for _ in range(5)]
    for a, b in zip(ours, refs):
        _equal_batches(a, b)
    _equal_batches(stack_task_batches(ours), jax_stack(refs))
    assert r1.randint(1 << 30) == r2.randint(1 << 30)
