"""Weight carry-over between the JAX package and the port.

The JAX package's parameters arrive as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``); the port's are the same dict of
torch tensors, so a reference φ loads with no remapping.

bfloat16 needs care: ``np.asarray`` of a JAX bf16 array carries the
``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses. Such
leaves go through their raw 16 bits (``.view(np.uint16)``) and are
re-viewed as ``torch.bfloat16`` — bit for bit, no rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, order="C")       # keeps 0-d arrays 0-d
    if _is_bf16(a):
        t = torch.from_numpy(a.view(np.uint16).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy; bfloat16 comes back with the ``ml_dtypes``
    bfloat16 dtype (imported here only, for the tests' round trips)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def numpy_view(t) -> np.ndarray:
    """A numpy array with the same shape, dtype name and bytes as ``t``
    (tensor or array), without importing ``ml_dtypes``: bf16 tensors
    yield their raw 16-bit words. Used where only the bytes matter."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(t)


def from_numpy_tree(tree, device="cuda"):
    """JAX package parameters (numpy leaves) -> the port's tensors."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def to_numpy_tree(tree):
    """The port's tensors -> numpy leaves (for parity tests)."""
    return tree_map(tensor_to_numpy, tree)
