"""Build and load the port's CUDA kernels (K1–K9) at first use.

One `torch.utils.cpp_extension.load` call compiles every source under
``kernels/csrc/`` for Hopper (``sm_90a``) into ``build/torch_ext/`` at
the repository root (gitignored) and loads the result. Only
``bindings.cpp`` includes the PyTorch headers; the ``.cu`` files expose
plain C++ launchers, which keeps nvcc's part of the build to seconds.

Nothing is compiled or imported at module import: the CPU tests import
every module of the port, and the build needs nvcc and a card.
"""
from __future__ import annotations

import os
import pathlib
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
EXT_NAME = "repro_torch_kernels"
CUDA_FLAGS = ["-O3", "-std=c++17",
              "-gencode=arch=compute_90a,code=sm_90a"]
# Link the C++ runtime's shared library, by its file name, ahead of the
# libraries the compiler driver adds. A driver whose own library
# directory holds only libstdc++.a (the card machine's ``c++``,
# /opt/gcc/bin/g++) links a second, static copy of it into the
# extension, and a failing TORCH_CHECK whose message formats a number
# then ends the process with a segmentation fault instead of raising;
# a plain -lstdc++ finds the same archive (`tools/probe_refusals.py`).
LINK_FLAGS = ["-l:libstdc++.so.6"]

_EXT = None
_LOCK = threading.Lock()


def sources() -> list:
    return [str(CSRC / "bindings.cpp")] + sorted(
        str(p) for p in CSRC.glob("*.cu"))


def get_ext():
    """The loaded extension, built on first call. Set
    ``REPRO_TORCH_BUILD_VERBOSE=1`` to see the compiler's output."""
    global _EXT
    with _LOCK:
        if _EXT is None:
            from torch.utils.cpp_extension import load
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _EXT = load(name=EXT_NAME, sources=sources(),
                        build_directory=str(BUILD_DIR),
                        extra_cflags=["-O2", "-std=c++17"],
                        extra_cuda_cflags=list(CUDA_FLAGS),
                        extra_ldflags=list(LINK_FLAGS),
                        extra_include_paths=[str(CSRC)],
                        verbose=bool(
                            os.environ.get("REPRO_TORCH_BUILD_VERBOSE")))
        return _EXT
