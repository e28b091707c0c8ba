"""Port parity: the packed parameter plane and the weight carry-over.

The same parameters, made from a seeded numpy stream, must pack to the
same plane with the same slot offsets in the JAX package
(`repro.utils.flat`) and in the port (`repro_torch.utils.flat`), bf16
leaves included; `convert` must carry bf16 over bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import init_lm as jax_init_lm
from repro.utils.flat import FlatPlane as JaxFlatPlane
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.utils.flat import ALIGN, FlatPlane, plane_for
from repro_torch.utils.pytree import tree_leaves, tree_map


def _np_tree(dtype, seed=0):
    """Nested dict whose insertion order is NOT sorted, so the test sees
    whether both packages order leaves by sorted key."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: np.asarray(rng.randn(*s), np.float32).astype(dtype)
    return {"zeta": mk(3, 5), "alpha": {"w": mk(7), "b": mk(2, 2, 3)},
            "mid": [mk(4), {"y": mk(6), "x": mk(1)}], "scalar": mk()}


def _slots(plane):
    return [(s.offset, s.size, tuple(s.shape), s.dtype) for s in plane.slots]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_plane_layout_and_pack_match_reference(dtype):
    tree = _np_tree(dtype)
    jplane = JaxFlatPlane.from_tree(jax.tree.map(jnp.asarray, tree))
    tplane = FlatPlane.from_tree(from_numpy_tree(tree, "cpu"))
    assert _slots(tplane) == _slots(jplane)
    assert (tplane.n_real, tplane.n_padded) == (jplane.n_real, jplane.n_padded)
    assert tplane.n_padded % ALIGN == 0
    jflat = np.asarray(jplane.pack(jax.tree.map(jnp.asarray, tree)))
    tflat = tplane.pack(from_numpy_tree(tree, "cpu")).numpy()
    np.testing.assert_array_equal(tflat, jflat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_smollm_plane_matches_reference(dtype):
    cfg = dataclasses.replace(
        jax_reduced_config(jax_get_config("smollm-360m")), dtype=dtype)
    jparams = jax_init_lm(jax.random.PRNGKey(0), cfg)
    jplane = JaxFlatPlane.from_tree(jparams)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    tplane = plane_for(tparams)
    assert _slots(tplane) == _slots(jplane)
    np.testing.assert_array_equal(tplane.pack(tparams).numpy(),
                                  np.asarray(jplane.pack(jparams)))
    # unpack is the exact inverse, dtypes included
    back = to_numpy_tree(tplane.unpack(tplane.pack(tparams)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def test_full_width_smollm_plane_size():
    """SmolLM-360M at full width: 11 leaves, n_real 361,821,120 and
    n_padded 361,821,184 in both packages (shapes only, nothing
    allocated)."""
    cfg = jax_get_config("smollm-360m")
    shapes = jax.eval_shape(lambda: jax_init_lm(jax.random.PRNGKey(0), cfg))
    jplane = JaxFlatPlane.from_tree(shapes)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, dtype=torch.bfloat16,
                                              device="meta"), shapes)
    tplane = FlatPlane.from_tree(meta)
    assert len(tplane.slots) == 11
    assert (tplane.n_real, tplane.n_padded) == (361_821_120, 361_821_184)
    assert _slots(tplane) == _slots(jplane)


def test_unpack_ad_gradient_is_packed_leaf_gradient():
    tree = from_numpy_tree(_np_tree(np.float32, seed=1), "cpu")
    tree["alpha"]["w"] = tree["alpha"]["w"].to(torch.bfloat16)
    plane = plane_for(tree)
    weights = tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator(
        ).manual_seed(x.numel())).to(x.dtype), tree)
    flat = plane.pack(tree).requires_grad_(True)
    leaves = tree_leaves(plane.unpack_ad(flat))
    loss = sum((x.float() * w.float()).sum()
               for x, w in zip(leaves, tree_leaves(weights)))
    (g,) = torch.autograd.grad(loss, flat)
    expect = plane.pack(tree_map(lambda w: w.float(), weights))
    torch.testing.assert_close(g, expect, rtol=0, atol=0)
    assert g.shape == (plane.n_padded,) and g.dtype == torch.float32


def test_convert_bf16_round_trip_is_bitwise():
    a = np.asarray(jnp.asarray(
        np.random.RandomState(3).randn(5, 7), jnp.bfloat16))
    assert a.dtype == ml_dtypes.bfloat16
    t = from_numpy_tree({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    back = to_numpy_tree({"w": t})["w"]
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16), a.view(np.uint16))
