"""The port's lint CLI — the invariant plane's static gate.
Counterpart of `repro/analysis/lint.py`.

    PYTHONPATH=src python -m repro_torch.analysis.lint --strict

Lints the port (``src/repro_torch``, ``tests/test_torch_*.py`` and
``tests/torchdist.py``, or explicit paths) with the rule families:

  rng-*      seeded-streams-only randomness (numpy's and torch's
             global generators, stdlib `random`, time seeds)
  det-*      no wall-clock / unordered iteration in round-loop paths
  thread-*   lock-guarded shared state + leaf-lock ordering
  kernel-*   kernel↔oracle wiring of every kernels package

Exit status: 0 clean, 1 violations (or, under ``--strict``, a
non-empty baseline), 2 usage errors. Suppressions are inline
``# repro-lint: disable=<rule> (<reason>)`` comments — the reason is
mandatory — or entries of the repo's shared baseline file;
``--strict`` accepts only the inline, reasoned kind.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.analysis import core
from repro_torch.analysis.core import RULE_DOCS, lint_paths

DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "tests/torchdist.py")
DEFAULT_BASELINE = ".repro-lint-baseline.json"


def _find_root(start: str) -> str:
    """Walk up to the repo root (the dir holding src/repro_torch) so the
    CLI works from any cwd inside the tree."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, "src", "repro_torch")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def default_paths(root: str) -> list:
    """`DEFAULT_PATHS` under ``root``, the patterns expanded."""
    out = []
    for p in DEFAULT_PATHS:
        out.extend(sorted(glob.glob(os.path.join(root, p))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo-specific static analysis of the port "
                    "(invariant plane)")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)} under the repo root)")
    ap.add_argument("--strict", action="store_true",
                    help="CI mode: non-empty baseline is an error")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE} "
                         f"at the repo root)")
    ap.add_argument("--rule", action="append", dest="rules",
                    help="run only this rule id (repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable violation list on stdout")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        core.load_rules()
        for rid in sorted(set(core.RULES) | set(core.PROJECT_RULES)):
            print(f"{rid:24s} {RULE_DOCS.get(rid, '')}")
        return 0

    root = _find_root(os.getcwd())
    paths = args.paths or default_paths(root)
    missing = [p for p in paths if not os.path.exists(p)]
    if missing or not paths:
        print(f"repro-lint: no such path(s): {missing or DEFAULT_PATHS}",
              file=sys.stderr)
        return 2
    baseline = args.baseline
    if baseline is None:
        cand = os.path.join(root, DEFAULT_BASELINE)
        baseline = cand if os.path.exists(cand) else None

    report = lint_paths(paths, root=root, baseline=baseline,
                        strict=args.strict, rules=args.rules)
    if args.as_json:
        print(json.dumps([v.__dict__ for v in report.violations],
                         indent=2))
    else:
        print(report.format())
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
