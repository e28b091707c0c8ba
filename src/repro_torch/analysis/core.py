"""Lint engine: file walking, disable comments, baseline, rule registry.
Counterpart of `repro/analysis/core.py`, scoped to the port.

A rule is a function ``check(module: ModuleInfo) -> list[Violation]``
registered under a kebab-case id via :func:`rule`. Project-level rules
(``project_rule``) run once over the whole file set instead of per
module — the kernel ``ref.py``-counterpart check is one.

Suppression has exactly two mechanisms, both deliberately loud:

  * an inline ``# repro-lint: disable=<rule> (<reason>)`` comment on
    the offending line (or the line above). The parenthesized reason
    is REQUIRED — a bare disable is itself a violation
    (``lint-bad-disable``), so every waiver carries its justification
    in the diff.
  * a JSON baseline file (a list of ``{"rule", "path", "line"}``
    entries) for grandfathered debt. ``--strict`` refuses a non-empty
    baseline, and the repo ships it empty — the gate holds at zero
    suppressions.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

#: relpath prefixes (or exact files) whose host-side code feeds the
#: bit-identical round history — the determinism rules apply here (the
#: port's counterparts of the reference's five paths).
DET_CRITICAL = (
    "src/repro_torch/federated/",
    "src/repro_torch/core/",
    "src/repro_torch/checkpoint/",
    "src/repro_torch/data/registry.py",
    "src/repro_torch/data/federated.py",
)

_DISABLE_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,-]+)\s*(\(([^)]*)\))?")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: " \
               f"[{self.rule}] {self.message}"


class ModuleInfo:
    """One parsed source file plus its per-line disable directives."""

    def __init__(self, path: str, source: str, relpath: str = None):
        self.path = path
        self.relpath = (relpath if relpath is not None else path)
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.lines = source.splitlines()
        # line -> set of disabled rule ids; a disable on its own line
        # also covers the next line (the statement it precedes)
        self.disables: Dict[int, set] = {}
        self.disable_errors: List[Violation] = []
        self._parse_disables()
        self._parents: Optional[dict] = None

    def _parse_disables(self):
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(3) or "").strip()
            if not reason:
                self.disable_errors.append(Violation(
                    "lint-bad-disable", self.relpath, i, m.start() + 1,
                    "disable comment without a reason — write "
                    "'# repro-lint: disable=<rule> (<why>)'"))
                continue
            self.disables.setdefault(i, set()).update(rules)
            if text[:m.start()].strip() == "":   # standalone comment line
                self.disables.setdefault(i + 1, set()).update(rules)

    def disabled(self, rule: str, line: int) -> bool:
        return rule in self.disables.get(line, ())

    @property
    def det_critical(self) -> bool:
        rel = self.relpath.replace(os.sep, "/")
        return any(rel.endswith(p) or (p.endswith("/") and p in rel)
                   for p in DET_CRITICAL)

    def parents(self) -> dict:
        """child AST node -> parent map (built lazily, cached)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents


RULES: Dict[str, Callable] = {}
PROJECT_RULES: Dict[str, Callable] = {}
RULE_DOCS: Dict[str, str] = {}


def rule(rule_id: str, doc: str):
    """Register a per-module rule: ``check(module) -> [Violation]``."""
    def deco(fn):
        RULES[rule_id] = fn
        RULE_DOCS[rule_id] = doc
        return fn
    return deco


def project_rule(rule_id: str, doc: str):
    """Register a whole-tree rule: ``check(modules) -> [Violation]``."""
    def deco(fn):
        PROJECT_RULES[rule_id] = fn
        RULE_DOCS[rule_id] = doc
        return fn
    return deco


# ---- shared AST helpers (used by several rule modules) ------------------

def attr_chain(node) -> Optional[str]:
    """Dotted-name string for Name/Attribute chains, else None.
    ``np.random.RandomState`` -> "np.random.RandomState"."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def base_name(node) -> Optional[str]:
    """Leftmost Name of an expression: ``phi.reshape(x)`` -> "phi"."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, (ast.Subscript, ast.Starred)):
            node = node.value
        else:
            return None


def numpy_aliases(tree) -> dict:
    """{"np": {"np"}, "np.random": {...}} — names bound to the numpy
    module and to numpy.random by the file's imports."""
    mods, rand = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    mods.add(a.asname or "numpy")
                elif a.name == "numpy.random":
                    rand.add(a.asname or "numpy")   # numpy.random usable
        elif isinstance(node, ast.ImportFrom):
            if node.module == "numpy":
                for a in node.names:
                    if a.name == "random":
                        rand.add(a.asname or "random")
    return {"module": mods, "random": rand}


def enclosing_function(module: ModuleInfo, node):
    """Nearest FunctionDef/AsyncFunctionDef ancestor, or None."""
    parents = module.parents()
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def containing_stmt(fn, node) -> Optional[int]:
    """Index into ``fn.body`` of the top-level statement holding
    ``node`` (statements inside nested defs don't count)."""
    for i, stmt in enumerate(fn.body):
        for sub in ast.walk(stmt):
            if sub is node:
                return i
    return None


# ---- driver -------------------------------------------------------------

@dataclasses.dataclass
class LintReport:
    violations: List[Violation]
    files: int
    baseline_entries: int = 0
    baseline_suppressed: int = 0

    @property
    def clean(self) -> bool:
        return not self.violations

    def format(self) -> str:
        out = [v.format() for v in self.violations]
        tail = (f"{len(self.violations)} violation(s) in "
                f"{self.files} file(s)")
        if self.baseline_suppressed:
            tail += f" ({self.baseline_suppressed} baseline-suppressed)"
        out.append(tail)
        return "\n".join(out)


def load_rules():
    """Import the rule modules, which register themselves."""
    from repro_torch.analysis import (rules_determinism,  # noqa: F401
                                      rules_kernels, rules_rng,
                                      rules_threading)


def iter_py_files(paths: Sequence[str]) -> List[str]:
    files = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
    return files


def load_baseline(path: Optional[str]) -> list:
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"baseline {path}: expected a JSON list")
    return entries


def _lint_module(module: ModuleInfo,
                 rules: Optional[Sequence[str]] = None) -> List[Violation]:
    out = list(module.disable_errors)
    for rule_id, check in RULES.items():
        if rules is not None and rule_id not in rules:
            continue
        for v in check(module):
            if not module.disabled(v.rule, v.line):
                out.append(v)
    return out


def lint_source(source: str, path: str = "<fixture>",
                relpath: str = None,
                rules: Optional[Sequence[str]] = None) -> List[Violation]:
    """Lint one source string — the fixture/test entry point."""
    return _lint_module(ModuleInfo(path, source, relpath=relpath),
                        rules=rules)


def lint_paths(paths: Sequence[str], *, root: str = ".",
               baseline: Optional[str] = None,
               strict: bool = False,
               rules: Optional[Sequence[str]] = None) -> LintReport:
    """Lint every ``.py`` under ``paths`` (files or directories).

    ``baseline`` entries suppress matching violations unless
    ``strict``, in which case a non-empty baseline is itself reported.
    """
    # rule modules register on import; import here so `lint_paths` is
    # usable without importing repro_torch.analysis.lint (the CLI)
    load_rules()

    files = iter_py_files(paths)
    modules, violations = [], []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            src = f.read()
        try:
            module = ModuleInfo(path, src, relpath=rel)
        except SyntaxError as e:
            violations.append(Violation(
                "lint-parse-error", rel, e.lineno or 1, 1, str(e)))
            continue
        modules.append(module)
        violations.extend(_lint_module(module, rules=rules))
    for rule_id, check in PROJECT_RULES.items():
        if rules is not None and rule_id not in rules:
            continue
        for v in check(modules):
            continue_ = False
            for m in modules:
                if m.relpath == v.path and m.disabled(v.rule, v.line):
                    continue_ = True
            if not continue_:
                violations.append(v)

    entries = load_baseline(baseline)
    suppressed = 0
    if entries and strict:
        violations.append(Violation(
            "lint-baseline-nonempty", baseline or "<baseline>", 1, 1,
            f"strict mode forbids baseline entries ({len(entries)} "
            f"found) — fix or inline-disable with a reason instead"))
    elif entries:
        keyed = {(e["rule"], e["path"], int(e["line"])) for e in entries}
        kept = []
        for v in violations:
            if (v.rule, v.path, v.line) in keyed:
                suppressed += 1
            else:
                kept.append(v)
        violations = kept

    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return LintReport(violations=violations, files=len(files),
                      baseline_entries=len(entries),
                      baseline_suppressed=suppressed)
