"""Weight carry-over between the JAX package and the port.

The JAX package's parameters arrive as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, params)``); the port's are the same dict of
torch tensors, so a reference φ loads with no remapping.
`initial_params` carries one method's initial parameters of a reference
comparison plan across (θ for FedAvg, φ for FedMeta); the
error-feedback plane needs no conversion, since it starts at zero.

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


FEDAVG_METHODS = ("fedavg", "fedavg(meta)")


def initial_params(method: str, tree, device="cuda"):
    """A reference plan's initial parameters for ``method`` -> the
    port's: the θ tree for the FedAvg methods, φ for the FedMeta ones —
    ``{"theta"}``, or ``{"theta", "alpha"}`` for Meta-SGD (the reference
    draws α with `jax.random`, which torch cannot reproduce)."""
    if method not in FEDAVG_METHODS:
        want = ({"theta", "alpha"} if method.startswith("meta-sgd")
                else {"theta"})
        if not isinstance(tree, dict) or set(tree) != want:
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{method}: initial φ must have keys "
                             f"{sorted(want)}, got {got}")
    return from_numpy_tree(tree, device)
