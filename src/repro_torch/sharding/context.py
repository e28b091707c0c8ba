"""Ambient mesh for model-internal sharding decisions. Counterpart of
`repro/sharding/context.py`.

Model code (the expert-parallel MoE, the sequence-sharded residual
stream) needs the mesh while it runs, but the model functions are pure
and config-driven. A launcher sets the ambient mesh here before it
runs a step; model code reads it. `None` (the default, as in the CPU
tests) disables every mesh-dependent path.
"""
from __future__ import annotations

import contextlib

_MESH = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


@contextlib.contextmanager
def stepping_on(mesh):
    """What a step on ``mesh`` runs under: ``mesh`` as the ambient mesh,
    and DTensor's implicit replication, so the plain tensors the model
    makes (positions, masks, zeros) join DTensor ops as replicated.
    Nothing when ``mesh`` is None."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with use_mesh(mesh), implicit_replication():
        yield
