"""Thread-safety rules (``thread-*``) — a two-pass AST check over
``with self._lock:`` scopes. Counterpart of
`repro/analysis/rules_threading.py`, with its rule ids and semantics.

The concurrent plane is three classes: `WorkerPool` / `Prefetcher`
(worker threads writing results the consumer reads) and
`ClientRegistry` (an LRU cache hammered by K workers). Their invariant
(DESIGN.md §15) is that every write to shared instance state happens
under the class's lock. These rules encode it:

  thread-unguarded-write  Pass 1 collects, per class: the lock
                          attribute(s) (``self.X = threading.Lock()``),
                          the worker-entry methods (any method passed as
                          ``threading.Thread(target=self.m)``), and —
                          when the class has a lock — every method that
                          touches a locked attribute. Pass 2 flags any
                          write to a ``self.`` attribute in those
                          methods that is not lexically inside
                          ``with self.<lock>:`` (``__init__`` /
                          ``__post_init__`` run single-threaded and are
                          exempt). A worker-entry method in a class with
                          NO lock flags every ``self.`` write.
  thread-lock-order       Stub of the acquired-order contract
                          (async_engine docstrings): instance locks are
                          LEAF locks — never block while holding one.
                          Flags, inside a ``with self.<lock>:`` scope:
                          a nested ``with`` on another lock-like
                          attribute, or a call to ``.wait()`` /
                          ``.join()`` / ``.acquire()`` / ``.map()``
                          (the blocking calls that park a thread while
                          the lock starves every other worker — the
                          WorkerPool-gather vs registry-in-flight-Event
                          deadlock shape).
"""
from __future__ import annotations

import ast
from typing import Optional

from repro_torch.analysis.core import ModuleInfo, Violation, attr_chain, rule

_EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})
_BLOCKING_CALLS = frozenset({"wait", "join", "acquire", "map"})


def _lock_attrs(cls: ast.ClassDef) -> set:
    """Attributes assigned a Lock()/RLock()-like object anywhere in the
    class body (``self.X = threading.Lock()`` et al.)."""
    locks = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        chain = attr_chain(node.value.func) or ""
        if not chain.rpartition(".")[2].endswith("Lock"):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                locks.add(t.attr)
    return locks


def _worker_methods(cls: ast.ClassDef) -> set:
    """Methods handed to ``threading.Thread(target=self.m, ...)`` —
    code that runs on a thread the class itself spawned."""
    targets = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func) or ""
        if chain.rpartition(".")[2] != "Thread":
            continue
        for kw in node.keywords:
            if kw.arg == "target" and isinstance(kw.value, ast.Attribute) \
                    and isinstance(kw.value.value, ast.Name) \
                    and kw.value.value.id == "self":
                targets.add(kw.value.attr)
    return targets


def _self_attr(node) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _write_targets(stmt):
    """(attr, node) pairs for self-attribute writes in one statement:
    assignment, augmented assignment, subscript store, delete."""
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = stmt.targets
    else:
        return
    for t in targets:
        if isinstance(t, (ast.Subscript, ast.Starred)):
            t = t.value
        attr = _self_attr(t)
        if attr is not None:
            yield attr, stmt


def _is_lock_with(item, locks: set) -> bool:
    attr = _self_attr(item.context_expr)
    return attr is not None and attr in locks


def _walk_method(method, locks, under_lock, visit):
    """Recursive walk tracking `with self.<lock>:` containment.
    ``visit(stmt, under_lock)`` sees every statement once."""
    for stmt in method if isinstance(method, list) else method.body:
        visit(stmt, under_lock)
        inner = under_lock
        if isinstance(stmt, ast.With):
            inner = under_lock or any(
                _is_lock_with(it, locks) for it in stmt.items)
            _walk_method(stmt.body, locks, inner, visit)
        elif isinstance(stmt, (ast.If, ast.For, ast.While)):
            _walk_method(stmt.body, locks, under_lock, visit)
            _walk_method(stmt.orelse, locks, under_lock, visit)
        elif isinstance(stmt, ast.Try):
            for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                _walk_method(blk, locks, under_lock, visit)
            for h in stmt.handlers:
                _walk_method(h.body, locks, under_lock, visit)
        # nested function defs get a fresh thread context — skipped


def _guarded_methods(cls, locks) -> set:
    """Methods that touch any attribute some OTHER site writes under
    the lock — the class's shared-state surface."""
    locked_attrs = set()

    for method in cls.body:
        if not isinstance(method, ast.FunctionDef):
            continue

        def note(stmt, under_lock):
            if under_lock:
                for attr, _ in _write_targets(stmt):
                    locked_attrs.add(attr)

        _walk_method(method, locks, False, note)

    touches = set()
    for method in cls.body:
        if not isinstance(method, ast.FunctionDef) or \
                method.name in _EXEMPT_METHODS:
            continue
        for node in ast.walk(method):
            attr = _self_attr(node)
            if attr in locked_attrs:
                touches.add(method.name)
                break
    return touches


@rule("thread-unguarded-write",
      "shared-state write outside `with self._lock:`")
def check_unguarded_write(module: ModuleInfo):
    out = []
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        workers = _worker_methods(cls)
        if not locks and not workers:
            continue
        checked = set(workers)
        if locks:
            checked |= _guarded_methods(cls, locks)
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue
            if method.name in _EXEMPT_METHODS or \
                    method.name not in checked:
                continue

            def visit(stmt, under_lock, method=method):
                if under_lock:
                    return
                for attr, node in _write_targets(stmt):
                    if attr in locks:
                        continue
                    why = ("with no lock attribute on the class"
                           if not locks else
                           f"outside `with self.{sorted(locks)[0]}:`")
                    out.append(Violation(
                        "thread-unguarded-write", module.relpath,
                        node.lineno, node.col_offset + 1,
                        f"`{cls.name}.{method.name}` writes "
                        f"`self.{attr}` {why} — worker threads and "
                        f"cache paths must write shared state under "
                        f"the class's lock"))

            _walk_method(method, locks, False, visit)
    return out


@rule("thread-lock-order",
      "blocking call / nested lock inside a leaf-lock scope (stub)")
def check_lock_order(module: ModuleInfo):
    out = []
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _lock_attrs(cls)
        if not locks:
            continue
        for method in cls.body:
            if not isinstance(method, ast.FunctionDef):
                continue

            def visit(stmt, under_lock):
                if not under_lock:
                    return
                if isinstance(stmt, ast.With):
                    for it in stmt.items:
                        attr = attr_chain(it.context_expr)
                        if attr and "lock" in attr.lower() and \
                                not _is_lock_with(it, locks):
                            out.append(Violation(
                                "thread-lock-order", module.relpath,
                                stmt.lineno, stmt.col_offset + 1,
                                f"`{cls.name}` acquires `{attr}` while "
                                f"holding its own lock — instance locks "
                                f"are leaf locks (async_engine lock-"
                                f"order contract); acquire in "
                                f"pool/event → registry order, never "
                                f"nested the other way"))
                # compound statements are visited per child by
                # _walk_method; only walk the leaves here, so nested
                # calls are reported exactly once
                if isinstance(stmt, (ast.With, ast.If, ast.For,
                                     ast.While, ast.Try)):
                    return
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        tail = (attr_chain(node.func) or
                                "").rpartition(".")[2]
                        if tail in _BLOCKING_CALLS:
                            out.append(Violation(
                                "thread-lock-order", module.relpath,
                                node.lineno, node.col_offset + 1,
                                f"`.{tail}()` while holding "
                                f"`{cls.name}`'s lock can park this "
                                f"thread with the lock held (deadlock "
                                f"shape: pool gather vs registry "
                                f"in-flight Events) — release the "
                                f"lock before blocking"))

            _walk_method(method, locks, False, visit)
    return out
