#!/usr/bin/env python3
"""Probe what a refused call into the kernels' extension does on the card.

    python3 tools/probe_refusals.py [--variants NAME,...] [--out FILE]

1. The toolchain: the compiler `torch.utils.cpp_extension.load` runs
   (``$CXX``, else ``c++`` on the PATH), its version and, where it is a
   script, the script; the compiler
   PyTorch was built with (`torch.__config__.show()`), and the
   ``libstdc++`` and ``libgcc_s`` that the built extension and
   PyTorch's ``libc10.so`` resolve (``ldd``).
2. One refused call straight into each of the eight bindings of
   `kernels/csrc/bindings.cpp` (past the Python wrappers' checks), each
   in a child process: its exit code and the last lines it wrote.
   And the link line the compiler driver runs for a shared library
   (``-###``).
3. A one-function extension whose only line is a failing
   ``TORCH_CHECK`` (and one that throws ``std::runtime_error``), built
   with the extension's own flags under each compiler and link variant
   of `VARIANTS`, each called in a child process: which variant, if
   any, raises a Python ``RuntimeError`` instead of ending the process,
   and the C++ runtime each build resolves.

Prints one JSON object a step; with --out, also writes them all there.
The builds go under ``build/probe_refusals/`` (gitignored).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
BUILD = os.path.join(REPO, "build", "probe_refusals")

sys.path.insert(0, REPO)
from chip_smoke import DIRECT_REFUSALS as REFUSED  # noqa: E402
from chip_smoke import direct_refusal  # noqa: E402

PROBE_CPP = r"""
#include <torch/extension.h>
#include <stdexcept>
void refuse(torch::Tensor t) {
  TORCH_CHECK(t.dim() == 99, "refused on purpose: dim ", t.dim());
}
void throw_std() { throw std::runtime_error("std::runtime_error on purpose"); }
PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("refuse", &refuse);
  m.def("throw_std", &throw_std);
}
"""

# (name, $CXX or None for load's default, extra link flags)
VARIANTS = [("default", None, []),
            ("system_gxx", "/usr/bin/g++", []),
            ("static_libgcc_libstdcxx", None,
             ["-static-libgcc", "-static-libstdc++"]),
            ("lstdcxx", None, ["-lstdc++"]),
            ("no_as_needed_lstdcxx", None,
             ["-Wl,--no-as-needed", "-lstdc++"]),
            ("nodefaultlibs", None,
             ["-nodefaultlibs", "-lstdc++", "-lm", "-lc", "-lgcc_s",
              "-lgcc"]),
            ("shared_by_name", None, ["-l:libstdc++.so.6"])]


def emit(obj, out):
    out.append(obj)
    print(json.dumps(obj), flush=True)


def sh(cmd) -> str:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                           shell=isinstance(cmd, str))
        return (p.stdout + p.stderr).strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{type(e).__name__}: {e}"


def ldd_runtime(path) -> list:
    return [ln.strip() for ln in sh(["ldd", path]).splitlines()
            if "libstdc++" in ln or "libgcc_s" in ln]


def child(code, env_extra=None, timeout=600):
    """Run `code` in a fresh interpreter: (exit code, last lines, and the
    ``ldd`` runtime of a library it names on a line "SO <path>")."""
    env = dict(os.environ, PYTHONPATH=SRC)
    env.update(env_extra or {})
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    lines = (p.stdout + p.stderr).strip().splitlines()
    out = {"exit_code": p.returncode, "tail": lines[-4:],
           "s": time.perf_counter() - t0}
    so = [ln[3:] for ln in p.stdout.splitlines() if ln.startswith("SO ")]
    if so:
        out["ldd"] = ldd_runtime(so[0])
    return out


def toolchain(out):
    import torch
    from repro_torch.kernels import _build
    ext = _build.get_ext()
    cxx = os.environ.get("CXX", "c++")
    lib_c10 = os.path.join(os.path.dirname(torch.__file__), "lib",
                           "libc10.so")
    config = [ln.strip() for ln in torch.__config__.show().splitlines()
              if "ompiler" in ln or "GCC" in ln or "CXX" in ln][:6]
    driver = shutil.which(cxx)
    script = ""
    if driver:
        with open(driver, "rb") as f:
            head = f.read(4096)
        script = ("(binary)" if b"\0" in head
                  else head.decode(errors="replace"))
    emit({"step": "toolchain", "torch": torch.__version__,
          "cuda": torch.version.cuda, "cxx": cxx,
          "cxx_path": shutil.which(cxx), "cxx_version":
              sh([cxx, "--version"]).splitlines()[:1],
          "system_gxx": sh(["/usr/bin/g++", "--version"]).splitlines()[:1],
          "cxx_script": script,
          "cxx_link_line": sh(f"{cxx} -### -shared -x c++ /dev/null -o "
                              "/dev/null 2>&1 | tail -n 2"),
          "torch_config": config,
          "extension": ext.__file__, "extension_ldd": ldd_runtime(ext.__file__),
          "libc10_ldd": ldd_runtime(lib_c10)}, out)


def bindings(out):
    for name in REFUSED:
        emit({"step": "binding", **direct_refusal(name)}, out)


def variants(out, names=None):
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "refuse_probe.cpp")
    with open(src, "w") as f:
        f.write(PROBE_CPP)
    procs = []
    for name, cxx, ldflags in VARIANTS:
        if names is not None and name not in names:
            continue
        if cxx and not os.path.exists(cxx):
            emit({"step": "variant", "variant": name, "skipped":
                  f"{cxx} not found"}, out)
            continue
        bdir = os.path.join(BUILD, name)
        os.makedirs(bdir, exist_ok=True)
        code = (
            "import torch\nfrom torch.utils.cpp_extension import load\n"
            f"ext = load(name='refuse_probe_{name}', sources=[{src!r}], "
            f"build_directory={bdir!r}, extra_cflags=['-O2', '-std=c++17'], "
            f"extra_ldflags={ldflags!r}, verbose=False)\n"
            "print('SO', ext.__file__, flush=True)\n"
            "for fn in ('refuse', 'throw_std'):\n"
            "    try:\n"
            "        getattr(ext, fn)(*((torch.zeros(2),) if fn == 'refuse' "
            "else ()))\n"
            "        print(fn, 'NOT RAISED', flush=True)\n"
            "    except Exception as e:\n"
            "        print(fn, 'RAISED', type(e).__name__, flush=True)\n")
        env = {"CXX": cxx} if cxx else {}
        procs.append((name, cxx, ldflags, code, env))
    # built and called one child each, all at once
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(len(procs) or 1) as pool:
        futs = {pool.submit(child, code, env): (name, cxx, ldflags)
                for name, cxx, ldflags, code, env in procs}
        for fut in cf.as_completed(futs):
            name, cxx, ldflags = futs[fut]
            emit({"step": "variant", "variant": name, "cxx": cxx or "default",
                  "extra_ldflags": ldflags, **fut.result()}, out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of VARIANTS to build "
                         "(default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    out = []
    toolchain(out)
    bindings(out)
    variants(out, args.variants.split(",") if args.variants else None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
