"""Checkpointing: trees -> .npz payload + msgpack manifest.
Counterpart of `repro/checkpoint/io.py`, in the same file format.

A tree is flattened to ``/``-joined key paths (lists and tuples as
``__list<i>`` / ``__tuple<i>`` parts); tensors go into one compressed
``.npz``, structure and scalars into a msgpack manifest, so a restore
round-trips exactly (python scalars, nested sequences). bf16 tensors are
stored as f32 (a superset, exact) and listed under ``"bf16"``. A
checkpoint written by either package loads in the other.
"""
from __future__ import annotations

import os
import re
from typing import Any

import msgpack
import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{type(tree).__name__}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _set_path(root, path_parts, value):
    cur = root
    for part in path_parts[:-1]:
        if part not in cur:
            cur[part] = {}
        cur = cur[part]
    cur[path_parts[-1]] = value


_LIST_RE = re.compile(r"^__(list|tuple)(\d+)$")


def _rebuild_sequences(node):
    """{'__list0': .., '__list1': ..} dicts back into lists/tuples."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(_LIST_RE.match(k) for k in keys):
        matches = [_LIST_RE.match(k) for k in keys]
        kind = matches[0].group(1)
        items = sorted((int(m.group(2)), node[k])
                       for k, m in zip(keys, matches))
        seq = [_rebuild_sequences(v) for _, v in items]
        return tuple(seq) if kind == "tuple" else seq
    return {k: _rebuild_sequences(v) for k, v in node.items()}


def _to_packable(v):
    """msgpack cannot pack numpy scalar types; unwrap them to python
    scalars (exact)."""
    if isinstance(v, np.generic):
        return v.item()
    return v


def _host_array(v):
    """A tensor or array -> (numpy array, was it bf16)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), True
        return t.cpu().numpy(), False
    return np.asarray(v), False


def save_pytree(path: str, tree: Any) -> None:
    """Atomic: both files are written to temp names and ``os.replace``d
    into place, payload first, manifest last (each flushed and fsynced)
    — ``latest_step`` keys on manifests, so a crash mid-save leaves
    nothing visible or a complete checkpoint (at worst an orphaned
    ``.npz``), never a manifest pointing at a torn payload."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    manifest = {"keys": [], "scalars": {}, "bf16": []}
    for k, v in _flatten(tree).items():
        if isinstance(v, (torch.Tensor, np.ndarray)):
            a, bf16 = _host_array(v)
            if bf16:
                manifest["bf16"].append(k)
            arrays[k] = a
            manifest["keys"].append(k)
        else:
            manifest["scalars"][k] = _to_packable(v)
    # np.savez appends ".npz" unless the name ends with it, so the temp
    # name keeps the suffix
    tmp_npz = path + ".tmp.npz"
    with open(tmp_npz, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_npz, path + ".npz")
    tmp_man = path + ".tmp.manifest"
    with open(tmp_man, "wb") as f:
        f.write(msgpack.packb(manifest))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_man, path + ".manifest")


def load_pytree(path: str, device="cpu") -> Any:
    """The tree saved at ``path``: arrays as tensors on ``device`` in
    their saved dtype (bf16 where listed), scalars as python values."""
    with open(path + ".manifest", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    bf16 = set(manifest.get("bf16", ()))
    root: dict = {}
    with np.load(path + ".npz") as data:
        for k in manifest["keys"]:
            t = torch.from_numpy(np.array(data[k]))
            if k in bf16:
                t = t.to(torch.bfloat16)
            _set_path(root, k.split("/"), t.to(device))
    for k, v in manifest["scalars"].items():
        _set_path(root, k.split("/"), v)
    return _rebuild_sequences(root)


def save_server_state(ckpt_dir: str, step: int, state: Any,
                      keep_last: int | None = None) -> str:
    """Save ``state`` as ``step_XXXXXXXX`` under ``ckpt_dir``; with
    ``keep_last`` keep only that many checkpoints, this one included."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    save_pytree(path, state)
    if keep_last:
        steps = sorted(s for s in _all_steps(ckpt_dir) if s != step)
        for old in steps[:max(0, len(steps) - (keep_last - 1))]:
            for suffix in (".manifest", ".npz"):
                try:  # retention is best-effort; a vanished file is fine
                    os.remove(os.path.join(
                        ckpt_dir, f"step_{old:08d}{suffix}"))
                except OSError:
                    pass
    return path


def _all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        # temp names ("step_X.tmp.manifest") do not match: a crashed
        # half-write is invisible to discovery
        m = re.match(r"step_(\d+)\.manifest$", name)
        if m:
            steps.append(int(m.group(1)))
    return steps


def latest_step(ckpt_dir: str) -> int | None:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def load_server_state(ckpt_dir: str, step: int | None = None,
                      device="cpu") -> Any:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return load_pytree(os.path.join(ckpt_dir, f"step_{step:08d}"), device)
