"""The default implementation of an ops module: "torch" (the plain
version) or "cuda" (the hand-written kernel).

Each ops module keeps one `ImplSwitch` and binds its methods under the
reference's names: `set_default_impl` and `get_default_impl` set and
read the module's default, as `repro/kernels/*/ops.py` do, and
`use_impl` is the port's scoped form, restored on exit."""
from __future__ import annotations

import contextlib

IMPLS = ("torch", "cuda")


class ImplSwitch:
    def __init__(self, default: str = "cuda"):
        self.set(default)

    def set(self, impl: str) -> None:
        assert impl in IMPLS, impl
        self.impl = impl

    def get(self) -> str:
        return self.impl

    def resolve(self, impl: str | None) -> str:
        """`impl` where given, else the default."""
        impl = impl or self.impl
        assert impl in IMPLS, impl
        return impl

    @contextlib.contextmanager
    def use(self, impl: str):
        prev = self.impl
        self.set(impl)
        try:
            yield
        finally:
            self.impl = prev
