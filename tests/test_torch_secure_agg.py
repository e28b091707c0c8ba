"""Secure aggregation (`federated/privacy.masked_uploads`, `secure_sum`)
against the JAX package. The pairwise masks cannot be drawn alike
(torch cannot reproduce `jax.random`), so the reference's own
``_pair_mask`` draws — ``fold_in(fold_in(key, lo), hi)`` per pair, a
normal per leaf — are handed in: each upload then equals the
reference's at f32 tolerance (rtol 1e-5 / atol 1e-6: the same adds in
the same order). `secure_sum` equals Σ_u g_u within the reference
test's atol 1e-4 (`tests/test_privacy.py`), with the reference's masks
and with the port's own (`pair_masks`); an upload alone is far from its
gradient."""
import jax
import numpy as np
import pytest
import torch

from repro.federated import privacy as jp
from repro_torch.federated import privacy as tp
from repro_torch.utils.pytree import tree_norm

TOL = dict(rtol=1e-5, atol=1e-6)


def _grads(seed, m, dims=(5, 3)):
    rng = np.random.RandomState(seed)
    return {"w": rng.normal(0, 1, (m,) + dims).astype(np.float32),
            "b": rng.normal(0, 1, (m, dims[0])).astype(np.float32)}


def _reference_masks(g, key, m):
    """The reference's mask draw for each pair, as numpy trees."""
    one = {k: v[0] for k, v in g.items()}
    out = {}
    for lo in range(m):
        for hi in range(lo + 1, m):
            pk = jax.random.fold_in(jax.random.fold_in(key, lo), hi)
            out[(lo, hi)] = {k: torch.from_numpy(np.asarray(
                jp._pair_mask(pk, jax.numpy.asarray(v)))) for k, v in
                one.items()}
    return out


@pytest.mark.parametrize("seed,m", [(0, 2), (1, 3), (7, 6)])
def test_uploads_match_the_reference_with_its_masks(seed, m):
    g = _grads(seed, m)
    key = jax.random.PRNGKey(seed)
    want = jp.masked_uploads({k: jax.numpy.asarray(v) for k, v in g.items()},
                             key)
    got = tp.masked_uploads({k: torch.from_numpy(v) for k, v in g.items()},
                            _reference_masks(g, key, m))
    assert len(got) == len(want) == m
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), **TOL)
    total = tp.secure_sum(got)
    for k, v in g.items():
        np.testing.assert_allclose(total[k].numpy(), v.sum(0), rtol=1e-4,
                                   atol=1e-4)


def test_secure_sum_cancels_the_ports_own_masks():
    m = 5
    g = {k: torch.from_numpy(v) for k, v in _grads(3, m).items()}
    masks = tp.pair_masks(m, {k: v[0] for k, v in g.items()},
                          torch.Generator().manual_seed(0))
    assert sorted(masks) == [(lo, hi) for lo in range(m)
                             for hi in range(lo + 1, m)]
    ups = tp.masked_uploads(g, masks)
    total = tp.secure_sum(ups)
    for k in g:
        np.testing.assert_allclose(total[k].numpy(), g[k].sum(0).numpy(),
                                   rtol=1e-4, atol=1e-4)
    diff = tree_norm({k: ups[0][k] - g[k][0] for k in g})
    assert float(diff) > 1.0
