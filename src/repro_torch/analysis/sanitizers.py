"""Runtime sanitizers — the dynamic half of the port's invariant plane.
Counterpart of `repro/analysis/sanitizers.py`: the lock sanitizer is
the reference's, verbatim in behaviour; the tracer guard keeps its
names and takes the port's meaning.

The lint rules prove lock discipline *lexically*; these sanitizers
prove it *at runtime*, catching what static analysis structurally
cannot (writes through helpers, monkeypatched methods, attribute
access from code the linter never saw):

  * :func:`guard_shared_state` — swaps an object's lock for a
    `SanitizedLock` (same blocking semantics, plus owner tracking) and
    its class for a recording subclass whose ``__setattr__`` logs every
    guarded-attribute write performed without holding the lock.
    :func:`cross_thread_violations` then returns the unguarded writes
    made off the owning thread — the data races. Overhead is one dict
    lookup per attribute write; strictly opt-in (tests, debug runs).
  * :func:`assert_no_tracers` / :func:`no_tracer_leaks` — the
    experiment plane's tensor-leak guard. History records and artifact
    payloads must hold host floats, never tensors: a tensor in a record
    keeps device memory (or a transform's wrapper) alive past its step
    and turns every later ``float()`` into a device sync. The guard
    names what it found: a fake tensor (a dry run's stand-in, which
    holds no data), a functorch-wrapped tensor (a ``vmap``'s
    BatchedTensor, or a ``grad`` transform's wrapper, escaped from its
    transform) or a tensor on the card. The context manager checks the
    models' module caches (the RoPE caches of `models.layers`) at exit:
    a fake or wrapped tensor left there would poison every later call
    that reads it.

Opt-in wiring: ``REPRO_SANITIZE=1`` makes the experiment plane run the
tensor guard on every record it keeps (see
``federated/experiment.py``); the lock sanitizer is constructed
explicitly by tests and tools (see ``tests/test_torch_sanitizers.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import traceback
from typing import List, Optional


def sanitizers_enabled() -> bool:
    """True when ``REPRO_SANITIZE=1`` — the opt-in env gate."""
    return os.environ.get("REPRO_SANITIZE", "") == "1"


class UnguardedAccessError(AssertionError):
    """Shared state was written without the class's lock held."""


class TracerLeakError(AssertionError):
    """A tensor escaped into host-side state, or a fake or
    transform-wrapped tensor into a module cache."""


class SanitizedLock:
    """`threading.Lock` work-alike that records its owning thread.

    ``held_by_me()`` answers the question a plain Lock cannot:
    *does the current thread hold this lock* (``locked()`` only says
    somebody does). Context-manager and acquire/release compatible with
    the ``with self._lock:`` sites it replaces.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self):
        self._owner = None
        self._lock.release()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


@dataclasses.dataclass(frozen=True)
class UnguardedWrite:
    attr: str
    thread_id: int
    thread_name: str
    owner_thread: int
    where: str            # "file:line in func" of the writing frame

    @property
    def cross_thread(self) -> bool:
        return self.thread_id != self.owner_thread


_RECORDS_ATTR = "__repro_sanitizer_records__"
_LOCK_ATTR = "__repro_sanitizer_lock_attr__"
_OWNER_ATTR = "__repro_sanitizer_owner__"


def guard_shared_state(obj, lock_attr: str = "_lock",
                       guarded=None):
    """Instrument ``obj`` so unguarded writes to shared state are
    recorded (not blocked — the sanitizer observes, the test asserts).

    The object's ``lock_attr`` is replaced with a `SanitizedLock` (it
    must not be held during the swap) and its class with a one-off
    recording subclass. ``guarded`` selects the attributes under
    contract; None means every underscore-prefixed attribute except the
    lock itself. Returns ``obj``. Example::

        reg = ClientRegistry(src, 10, cache_clients=8)
        guard_shared_state(reg)
        pool.map(range(64))                  # hammer it from K threads
        assert not cross_thread_violations(reg)
    """
    lock = getattr(obj, lock_attr, None)
    if lock is not None and getattr(lock, "locked", lambda: False)():
        raise RuntimeError("cannot instrument while the lock is held")
    records: List[UnguardedWrite] = []
    base = type(obj)
    guarded_set = None if guarded is None else frozenset(guarded)

    def _guarded(name: str) -> bool:
        if name.startswith("__repro_sanitizer"):
            return False
        if name == lock_attr:
            return False
        if guarded_set is not None:
            return name in guarded_set
        return name.startswith("_")

    class Guarded(base):
        def __setattr__(self, name, value):
            if _guarded(name):
                sl = self.__dict__.get(lock_attr)
                if isinstance(sl, SanitizedLock) and not sl.held_by_me():
                    frame = traceback.extract_stack(limit=3)[0]
                    records.append(UnguardedWrite(
                        attr=name,
                        thread_id=threading.get_ident(),
                        thread_name=threading.current_thread().name,
                        owner_thread=getattr(
                            self, _OWNER_ATTR, threading.get_ident()),
                        where=f"{frame.filename}:{frame.lineno} "
                              f"in {frame.name}"))
            object.__setattr__(self, name, value)

    Guarded.__name__ = f"Sanitized{base.__name__}"
    Guarded.__qualname__ = Guarded.__name__
    object.__setattr__(obj, _OWNER_ATTR, threading.get_ident())
    object.__setattr__(obj, _RECORDS_ATTR, records)
    object.__setattr__(obj, _LOCK_ATTR, lock_attr)
    object.__setattr__(obj, lock_attr, SanitizedLock())
    obj.__class__ = Guarded
    return obj


def unguarded_writes(obj) -> List[UnguardedWrite]:
    """Every recorded unguarded write (any thread)."""
    return list(getattr(obj, _RECORDS_ATTR, []))


def cross_thread_violations(obj) -> List[UnguardedWrite]:
    """Unguarded writes made off the owning thread — the races the
    thread-safety invariant (DESIGN.md §15/§16) forbids."""
    return [r for r in unguarded_writes(obj) if r.cross_thread]


def assert_guarded(obj, *, cross_thread_only: bool = True):
    """Raise `UnguardedAccessError` listing every recorded violation."""
    bad = (cross_thread_violations(obj) if cross_thread_only
           else unguarded_writes(obj))
    if bad:
        lines = [f"  {r.attr!r} by {r.thread_name} at {r.where}"
                 for r in bad[:20]]
        raise UnguardedAccessError(
            f"{len(bad)} unguarded shared-state write(s) on "
            f"{type(obj).__name__}:\n" + "\n".join(lines))


# ---- tensor-leak guard (experiment plane) -------------------------------

def _leaves(tree):
    """Leaves of nested dicts, lists and tuples (a dict's values)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tensor_kind(x) -> str:
    """What a tensor is, for a leak's message: "fake", "wrapped" (by a
    functorch transform: vmap's BatchedTensor, grad's wrapper), "cuda"
    or "host"."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(x, FakeTensor):
        return "fake"
    if torch._C._functorch.is_functorch_wrapped_tensor(x):
        return "wrapped"
    return "cuda" if x.is_cuda else "host"


_KIND_WHY = {
    "fake": "a fake tensor (a dry run's stand-in, no data) escaped its "
            "trace",
    "wrapped": "a functorch-wrapped tensor (vmap's BatchedTensor or a "
               "grad transform's wrapper) escaped its transform",
    "cuda": "a tensor on the card: records hold host floats",
    "host": "a host tensor: records hold host floats",
}


def assert_no_tracers(tree, where: str = "") -> None:
    """Raise `TracerLeakError` if any leaf of ``tree`` (nested dicts,
    lists and tuples: a history record, a results dict, a checkpoint
    payload) is a `torch.Tensor`, naming what kind it is."""
    import torch
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            kind = tensor_kind(leaf)
            raise TracerLeakError(
                f"tensor leaked into host-side state"
                f"{f' ({where})' if where else ''}: {_KIND_WHY[kind]} "
                f"({kind}, shape {tuple(leaf.shape)}, {leaf.dtype})")


@contextlib.contextmanager
def no_tracer_leaks():
    """Fail at exit if a fake or functorch-wrapped tensor was left in
    the models' module-level tensor caches (the RoPE caches of
    `models.layers`)."""
    from repro_torch.models import layers
    yield
    for name, cache in (("layers._INV_FREQ", layers._INV_FREQ),
                        ("layers._MROPE_COMP", layers._MROPE_COMP)):
        for key, t in list(cache.items()):
            kind = tensor_kind(t)
            if kind in ("fake", "wrapped"):
                raise TracerLeakError(
                    f"{name}[{key!r}] holds {_KIND_WHY[kind]}")
