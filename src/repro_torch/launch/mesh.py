"""Device meshes. Counterpart of `repro/launch/mesh.py`.

Functions, not module-level constants: importing this module touches no
process group and no device. A mesh is a `torch.distributed` DeviceMesh
over the default process group, whose world must hold exactly the
mesh's ranks; a launcher started with no process group runs as a world
of one (`ensure_world`).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile

import torch.distributed as dist

PRODUCTION_SHAPE = {False: ((16, 16), ("data", "model")),
                    True: ((2, 16, 16), ("pod", "data", "model"))}


def ensure_world(device_type: str = "cuda") -> int:
    """The default process group's world size. When no group is running
    it starts one (NCCL on the card, gloo on the CPU): from the
    environment a launcher such as torchrun sets (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), else a world of one
    (rank 0, a FileStore in a fresh temp dir)."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"),
                                "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1)
    return dist.get_world_size()


def launcher_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The launchers' mesh: the production mesh when ``multi_pod`` is
    set (512 ranks) or the world has the 256 ranks of one pod; the 1x1
    host mesh in a world of one. Any other world raises, naming its
    size (the reference, on a small host, builds the production mesh
    and fails; the port runs a one-rank world on the host mesh)."""
    world = ensure_world(device_type)
    if multi_pod or world == math.prod(PRODUCTION_SHAPE[False][0]):
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
    if world == 1:
        return make_host_mesh(1, 1, device_type=device_type)
    raise ValueError(f"a world of {world} ranks: the launchers run on "
                     f"1 rank (the 1x1 host mesh), 256 (one pod) or 512 "
                     f"(--multi-pod)")


def _mesh(shape, names, device_type):
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    have = ensure_world(device_type)
    if have != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh over "
                         f"{names} needs a world of {need} ranks; this "
                         f"world has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 ranks a pod named ("data", "model"); with
    ``multi_pod`` 2x16x16 = 512 named ("pod", "data", "model")."""
    shape, names = PRODUCTION_SHAPE[multi_pod]
    return _mesh(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device_type: str = "cuda"):
    """A small mesh over the current world: (data, model), or (pod,
    data, model) when ``pod`` is set."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def launcher_world(multi_pod: bool, device_type: str = "cuda"):
    """`launcher_mesh` for the duration; a process group that this call
    started (no group was running) is destroyed on exit, so a launcher
    called in process leaves none behind."""
    started = not dist.is_initialized()
    try:
        yield launcher_mesh(multi_pod=multi_pod, device_type=device_type)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
