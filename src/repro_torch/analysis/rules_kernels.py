"""Kernel contract rules (``kernel-*``). Counterpart of
`repro/analysis/rules_pallas.py`.

Every CUDA kernel of the port sits beside a plain-PyTorch oracle, and
its package's ``ops.py`` dispatches between the two (ROADMAP's kernel
packaging: ``kernels/<pkg>/{ref.py, <kernel>.py, ops.py}``). The rule
makes that layout static:

  kernel-missing-ref  every ``src/repro_torch/kernels/<pkg>/`` package
                      must ship ``ref.py`` (the oracle) and an ``ops.py``
                      dispatcher that imports it — kernel↔ref parity is
                      only testable when the oracle is registered in the
                      dispatch (the reference's ``pallas-missing-ref``).

The reference's two other Pallas rules have no counterpart here:
``pallas-grid-mismatch`` reads the ``pl.BlockSpec`` index maps at a
``pl.pallas_call`` site, and ``pallas-alias-reuse`` reads its
``input_output_aliases``. The port launches its kernels through bound
CUDA C++ (`kernels/_build.py`, ``kernels/csrc/``) and has neither
construct: its launch geometry lives in the ``.cu`` sources, and the
wrappers refuse in Python whatever a binding would refuse
(`kernels/_checks.py`, tested by ``tests/test_torch_kernel_checks.py``).
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.core import Violation, project_rule

MARKER = "repro_torch/kernels/"


def _imports_ref(ops) -> bool:
    for node in ast.walk(ops.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith(".ref") or (node.level and mod == "ref"):
                return True
            if any(a.name == "ref" for a in node.names):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name.endswith(".ref") for a in node.names):
                return True
    return False


@project_rule("kernel-missing-ref",
              "kernels/<pkg>/ without a ref.py oracle wired into ops.py")
def check_missing_ref(modules):
    out = []
    pkgs = {}
    for m in modules:
        rel = m.relpath.replace(os.sep, "/")
        if MARKER not in rel:
            continue
        tail = rel.split(MARKER, 1)[1]
        if "/" not in tail:
            continue              # kernels/__init__.py, kernels/_build.py
        pkg, fname = tail.split("/", 1)
        pkgs.setdefault(pkg, {})[fname] = m
    for pkg, files in sorted(pkgs.items()):
        anchor = files.get("__init__.py") or next(iter(files.values()))
        if "ref.py" not in files:
            out.append(Violation(
                "kernel-missing-ref", anchor.relpath, 1, 1,
                f"kernels package `{pkg}` has no ref.py — every kernel "
                f"family ships a plain-PyTorch oracle for parity tests"))
        if "ops.py" not in files:
            out.append(Violation(
                "kernel-missing-ref", anchor.relpath, 1, 1,
                f"kernels package `{pkg}` has no ops.py dispatcher"))
            continue
        if "ref.py" in files and not _imports_ref(files["ops.py"]):
            out.append(Violation(
                "kernel-missing-ref", files["ops.py"].relpath, 1, 1,
                f"kernels package `{pkg}`'s ops.py never imports its "
                f"ref module — the oracle must be registered in the "
                f"dispatch, not just sit next to it"))
    return out
