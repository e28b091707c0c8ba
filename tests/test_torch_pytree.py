"""The port's tree helpers hold no reference cycle: a leaf they were
given, or one they built, is freed with its last user, without waiting
for the garbage collector. (The recursive closures of `tree_flatten` and
`tree_unflatten` once kept every leaf alive until a collection: on the
card a cut MoE model's init held a second copy of its weights, and a
layer-by-layer f32 forward kept every layer's f32 copy.)"""
import gc
import weakref

import pytest
import torch

from repro_torch.utils.pytree import (tree_flatten, tree_leaves, tree_map,
                                      tree_unflatten)


@pytest.fixture
def no_gc():
    gc.collect()
    gc.disable()
    yield
    gc.enable()


def test_tree_map_frees_its_inputs_and_outputs(no_gc):
    x = torch.zeros(4)
    seen_in = weakref.ref(x)
    out = tree_map(lambda a: a + 1, {"a": [x, (x * 2,)], "b": None})
    seen_out = weakref.ref(out["a"][0])
    del x
    assert seen_in() is None
    del out
    assert seen_out() is None


def test_flatten_and_unflatten_free_their_leaves(no_gc):
    tree = {"w": torch.ones(3), "s": {"v": torch.ones(2)}}
    refs = [weakref.ref(t) for t in tree_leaves(tree)]
    leaves, treedef = tree_flatten(tree)
    rebuilt = tree_unflatten(treedef, [t * 0 for t in leaves])
    out_refs = [weakref.ref(t) for t in tree_leaves(rebuilt)]
    del tree, leaves, rebuilt
    assert all(r() is None for r in refs + out_refs)
