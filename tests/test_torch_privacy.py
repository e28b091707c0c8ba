"""Port parity: central DP (`federated/privacy.py`) against the JAX
package. Clipping and the clipped weighted mean are held at f32
tolerance (rtol 1e-5 / atol 1e-6: the same sums in another order). The
noise cannot be drawn alike (torch cannot reproduce `jax.random`), so
the reference's own per-leaf draws are injected where parity is the
point, and the port's generator is checked by its distribution: the
sample std of 80,000 draws lies within 5 % of σ = z·S/m (the standard
error of a sample std is σ/√(2n), 0.25 % here)."""
import jax
import jax.numpy as jnp
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


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_clip_gradient_bounds_norm_and_matches_reference():
    rng = np.random.RandomState(0)
    g = {"w": rng.normal(0, 10, (50,)).astype(np.float32)}
    clipped, norm = tp.clip_gradient(_t(g), 1.0)
    assert float(tree_norm(clipped)) <= 1.0 + 1e-5
    jclipped, jnorm = jp.clip_gradient(_j(g), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), **TOL)
    np.testing.assert_allclose(clipped["w"].numpy(),
                               np.asarray(jclipped["w"]), **TOL)
    small = {"w": np.array([0.1, 0.1], np.float32)}
    same, _ = tp.clip_gradient(_t(small), 1.0)
    np.testing.assert_array_equal(same["w"].numpy(), small["w"])


def test_dp_clip_factors_match_reference():
    norms = np.array([0.0, 0.3, 0.5, 0.7, 12.0], np.float32)
    got = tp.dp_clip_factors(torch.from_numpy(norms), 0.5).numpy()
    want = np.asarray(jp.dp_clip_factors(jnp.asarray(norms), 0.5))
    np.testing.assert_allclose(got, want, **TOL)
    assert got.max() <= 1.0 and got[0] == 1.0


@pytest.mark.parametrize("clip", [1e9, 0.8])
def test_dp_aggregate_zero_noise_is_the_clipped_mean(clip):
    m = 4
    g = _grads(1, m)
    w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    out = tp.dp_aggregate(_t(g), torch.from_numpy(w), None, clip_norm=clip,
                          noise_multiplier=0.0)
    want = jp.dp_aggregate(_j(g), jnp.asarray(w), jax.random.PRNGKey(0),
                           clip_norm=clip, noise_multiplier=0.0)
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    if clip > 1e8:          # no clip: the data-count weighted mean
        for k in g:
            mean = np.tensordot(w / w.sum(), g[k], axes=1)
            np.testing.assert_allclose(out[k].numpy(), mean, **TOL)


def test_dp_aggregate_with_the_reference_noise_injected():
    """The reference splits its key into one key per leaf (leaf order);
    handing the port those draws reproduces its output."""
    m, z, S = 3, 1.5, 0.6
    g = _grads(2, m)
    w = np.array([0.2, 0.3, 0.5], np.float32)
    key = jax.random.PRNGKey(5)
    leaves, treedef = jax.tree.flatten(_j({k: v[0] for k, v in g.items()}))
    draws = [np.asarray(jax.random.normal(k, x.shape, jnp.float32))
             for x, k in zip(leaves, jax.random.split(key, len(leaves)))]
    noise = jax.tree.unflatten(treedef, [torch.tensor(d) for d in draws])
    out = tp.dp_aggregate(_t(g), torch.from_numpy(w), noise, clip_norm=S,
                          noise_multiplier=z)
    want = jp.dp_aggregate(_j(g), jnp.asarray(w), key, clip_norm=S,
                           noise_multiplier=z)
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]),
                                   **TOL)


def test_dp_noise_scale_and_sigma():
    """σ_effective = z·S/m: `DPConfig.sigma` pins the formula and the
    port's noise on zero gradients has that std (the generator route of
    `dp_aggregate`, seeded from `DPConfig.round_generator`)."""
    m, z, S = 4, 2.0, 1.0
    assert tp.DPConfig(clip_norm=S, noise_multiplier=z).sigma(m) == \
        jp.DPConfig(clip_norm=S, noise_multiplier=z).sigma(m) == z * S / m
    g = {"w": torch.zeros((m, 80_000))}
    gen = tp.DPConfig(seed=1).round_generator(1, "cpu")
    out = tp.dp_aggregate(g, torch.ones(m), gen, clip_norm=S,
                          noise_multiplier=z)["w"]
    assert abs(float(out.std()) - z * S / m) / (z * S / m) < 0.05
    assert abs(float(out.mean())) < 5 * (z * S / m) / np.sqrt(80_000)


def test_injected_noise_shape_is_checked():
    with pytest.raises(ValueError, match="shape"):
        tp.gaussian((4,), torch.zeros(5), "cpu")
