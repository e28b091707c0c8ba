"""Determinism rules (``det-*``) — scoped to the round-loop and
registry paths (`core.DET_CRITICAL`). Counterpart of
`repro/analysis/rules_determinism.py`, with its rule ids and semantics.

The async engine's contract is *bit-identical history* across
prefetch depth, fused-K blocking and resume (DESIGN.md §12, §14). Two
host-side hazards can silently break it:

  det-wallclock       ``time.time()`` / ``datetime.now()`` in a
                      determinism-critical module. Epoch wall-clock
                      reads leak non-reproducible values into whatever
                      consumes them; interval timing belongs to
                      ``time.perf_counter``/``time.monotonic`` (which
                      stay legal — timeouts and benchmarks need them).
  det-unordered-iter  iterating a ``set`` (or dict ``.keys/.values/
                      .items``) into numeric accumulation (``sum`` over
                      it, or a loop body with augmented assignment).
                      Set order is hash-randomized across processes and
                      dict order is insertion order — thread-schedule-
                      dependent when workers fill the dict — so the
                      accumulated float depends on the run, not the
                      data. Wrap the iterable in ``sorted(...)``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (ModuleInfo, Violation, attr_chain,
                                 enclosing_function, rule)

_WALLCLOCK = frozenset({"time.time", "time.time_ns"})
_WALLCLOCK_ATTRS = frozenset({"now", "utcnow", "today"})


@rule("det-wallclock",
      "wall-clock read in a determinism-critical path")
def check_wallclock(module: ModuleInfo):
    if not module.det_critical:
        return []
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if chain is None:
            continue
        head, _, tail = chain.rpartition(".")
        if chain in _WALLCLOCK or (
                tail in _WALLCLOCK_ATTRS and
                ("datetime" in head or head in ("date", "dt"))):
            out.append(Violation(
                "det-wallclock", module.relpath, node.lineno,
                node.col_offset + 1,
                f"`{chain}()` in a determinism-critical module — use "
                f"`time.perf_counter()` for intervals, or thread the "
                f"timestamp in from the caller"))
    return out


def _unordered(node):
    """The syntactically-unordered iterables we can prove: set displays,
    set()/frozenset() calls, set comprehensions, dict view methods."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set"
    if isinstance(node, ast.Call):
        chain = attr_chain(node.func) or ""
        if chain in ("set", "frozenset"):
            return chain
        tail = chain.rpartition(".")[2]
        if tail in ("keys", "values", "items") and not node.args:
            return f".{tail}()"
    return None


def _accumulates(body) -> bool:
    for stmt in body:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.AugAssign) and isinstance(
                    sub.op, (ast.Add, ast.Sub, ast.Mult)):
                return True
    return False


@rule("det-unordered-iter",
      "dict/set iteration feeding numeric accumulation")
def check_unordered_iter(module: ModuleInfo):
    if not module.det_critical:
        return []
    out = []

    def flag(node, kind, how):
        out.append(Violation(
            "det-unordered-iter", module.relpath, node.lineno,
            node.col_offset + 1,
            f"iteration over {kind} feeds numeric accumulation "
            f"({how}) — order is not reproducible; wrap the iterable "
            f"in sorted(...)"))

    for node in ast.walk(module.tree):
        if isinstance(node, ast.For):
            kind = _unordered(node.iter)
            if kind and _accumulates(node.body):
                flag(node, kind, "augmented assignment in the loop body")
        elif isinstance(node, ast.Call):
            chain = attr_chain(node.func) or ""
            if chain.rpartition(".")[2] != "sum" and chain != "sum":
                continue
            for arg in node.args:
                gens = (arg.generators if isinstance(
                    arg, (ast.GeneratorExp, ast.ListComp)) else [])
                iters = [g.iter for g in gens] or [arg]
                for it in iters:
                    kind = _unordered(it)
                    if kind:
                        flag(node, kind, f"`{chain}(...)` over it")
    # an unordered iterable wrapped in sorted() never reaches the
    # checks above: sorted(...) is a Call that is not itself unordered,
    # so the For/sum sees an ordered expression — nothing to exempt.
    _ = enclosing_function   # imported for rule modules' shared surface
    return out
