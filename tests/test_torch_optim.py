"""Port parity: the optimizers and tree utilities against the JAX
package, on seeded numpy trees.

Tolerance f32 rtol 1e-5 / atol 1e-6: both sides run the same formula op
by op (`b ** t` may differ by an ulp). bf16 moments are held to one bf16
ulp (rtol 2^-7): a last-bit difference before the cast can round the
other way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.utils import flat as jflat
from repro.utils import pytree as jtree
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.optim import optimizers as topt
from repro_torch.utils import flat as tflat
from repro_torch.utils import pytree as ttree

F32 = dict(rtol=1e-5, atol=1e-6)
BF16_STATE = dict(rtol=2.0 ** -7, atol=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": (rng.randn(5, 7) * scale).astype(np.float32),
                  "b": (rng.randn(7) * scale).astype(np.float32)},
            "z": (rng.randn(3, 2, 4) * scale).astype(np.float32)}


def _close(t_tree, j_tree, tol=F32):
    for t, j in zip(jax.tree.leaves(to_numpy_tree(t_tree)),
                    jax.tree.leaves(jax.tree.map(np.asarray, j_tree))):
        np.testing.assert_allclose(np.asarray(t, np.float32),
                                   np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adam", {"weight_decay": 0.01}),
    ("adam", {"state_dtype": "bfloat16"}),
    ("sgd", {"momentum": 0.9}), ("sgd", {})])
def test_tree_optimizer_matches_reference(name, kw):
    """Three updates of the tree optimizer from the same φ and grads."""
    sd = kw.pop("state_dtype", None)
    jo = getattr(jopt, name)(1e-2, **kw, **(
        {"state_dtype": jnp.bfloat16} if sd else {}))
    to = getattr(topt, name)(1e-2, **kw, **(
        {"state_dtype": torch.bfloat16} if sd else {}))
    jp, tp = jax.tree.map(jnp.asarray, _tree(0)), from_numpy_tree(_tree(0),
                                                                  "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _tree(10 + i, 0.5)
        jp, js = jo.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, from_numpy_tree(g, "cpu"), ts)
        _close(tp, jp)
    assert int(ts["step"]) == int(js["step"]) == 3
    if name == "adam":
        _close(ts["m"], js["m"], BF16_STATE if sd else F32)
        _close(ts["v"], js["v"], BF16_STATE if sd else F32)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_flat_adam_matches_reference_flat_adam(impl):
    """make_flat_optimizer lifts Adam onto the packed plane (K3 on the
    card, its plain version here); the step is a 0-d int32 tensor."""
    jp = jflat.plane_for(jax.tree.map(jnp.asarray, _tree(0)))
    tp = tflat.plane_for(from_numpy_tree(_tree(0), "cpu"))
    jf = jopt.make_flat_optimizer(jopt.adam(1e-3), impl="pallas_interpret")
    tf = topt.make_flat_optimizer(topt.adam(1e-3), impl=impl)
    jphi = jp.pack(jax.tree.map(jnp.asarray, _tree(0)))
    tphi = tp.pack(from_numpy_tree(_tree(0), "cpu"))
    js, ts = jf.init(jphi), tf.init(tphi)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    for i in range(2):
        g = _tree(20 + i)
        jphi, js = jf.update(jphi, jp.pack(jax.tree.map(jnp.asarray, g)), js)
        tphi, ts = tf.update(tphi, tp.pack(from_numpy_tree(g, "cpu")), ts)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), **F32)
    # SGD is itself on the plane
    assert topt.make_flat_optimizer(topt.sgd(0.1)).name.startswith("sgd")


def test_clip_by_global_norm_and_tree_utils_match_reference():
    g, h = _tree(3, 4.0), _tree(4)
    jg, tg = jax.tree.map(jnp.asarray, g), from_numpy_tree(g, "cpu")
    jh, th = jax.tree.map(jnp.asarray, h), from_numpy_tree(h, "cpu")
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    tc, tn = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **F32)
    _close(tc, jc)
    assert ttree.tree_size(tg) == jtree.tree_size(jg) == 35 + 7 + 24
    assert ttree.tree_bytes(ttree.tree_cast(tg, torch.bfloat16)) == \
        jtree.tree_bytes(jtree.tree_cast(jg, jnp.bfloat16))
    _close(ttree.tree_add(tg, th), jtree.tree_add(jg, jh))
    _close(ttree.tree_sub(tg, th), jtree.tree_sub(jg, jh))
    _close(ttree.tree_scale(tg, 0.3), jtree.tree_scale(jg, 0.3))
    _close(ttree.tree_axpy(0.5, tg, th), jtree.tree_axpy(0.5, jg, jh))
    _close(ttree.tree_zeros_like(tg), jtree.tree_zeros_like(jg))
    np.testing.assert_allclose(float(ttree.tree_norm(tg)),
                               float(jtree.tree_norm(jg)), **F32)
    assert not bool(ttree.tree_any_nan(tg))
    tg["z"][0, 0, 0] = float("nan")
    assert bool(ttree.tree_any_nan(tg))


def test_plane_zeros_and_pack_batch_match_reference():
    rows = [_tree(30 + i) for i in range(3)]
    batch = jax.tree.map(lambda *xs: np.stack(xs), *rows)
    jp = jflat.plane_for(jax.tree.map(jnp.asarray, rows[0]))
    tp = tflat.plane_for(from_numpy_tree(rows[0], "cpu"))
    want = np.asarray(jp.pack_batch(jax.tree.map(jnp.asarray, batch)))
    got = tp.pack_batch(from_numpy_tree(batch, "cpu"))
    assert got.shape == (3, tp.n_padded)
    np.testing.assert_array_equal(got.numpy(), want)
    z = tp.zeros("cpu")
    assert z.shape == (tp.n_padded,) and z.dtype == torch.float32
    np.testing.assert_array_equal(z.numpy(), np.asarray(jp.zeros()))
