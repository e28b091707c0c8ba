"""The port's kernel layout holds together (the port-side counterpart of
the reference's `pallas-missing-ref` lint, whose path match never sees
`src/repro_torch/kernels/`):

- every `kernels/<pkg>/ops.py` imports its package's `ref.py`, the
  plain versions the kernels are held against;
- every `kernels/csrc/*.cu` exports a launcher that `bindings.cpp`
  declares and calls, so no kernel source is built without a binding;
- every `kernels/csrc/*.cu` is named in `chip_smoke.py`'s `SOURCES`,
  with a `REPLACES` entry for each kernel, so the card's check and its
  kernels line cover every source."""
import ast
import pathlib
import re
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
KERNELS = REPO / "src" / "repro_torch" / "kernels"
CSRC = KERNELS / "csrc"
PKGS = sorted(p.parent.name for p in KERNELS.glob("*/ops.py"))
CU = sorted(p.name for p in CSRC.glob("*.cu"))


def test_layout_is_not_empty():
    assert PKGS == ["attention", "decode_attention", "meta_update", "ssd"]
    assert len(CU) >= 8


@pytest.mark.parametrize("pkg", PKGS)
def test_every_ops_imports_its_ref(pkg):
    assert (KERNELS / pkg / "ref.py").is_file()
    tree = ast.parse((KERNELS / pkg / "ops.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            imported |= {f"{node.module}.{a.name}" for a in node.names}
            imported.add(node.module)
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    assert f"repro_torch.kernels.{pkg}.ref" in imported, sorted(imported)


def _exported_launchers(src: str):
    """Launchers defined after the last anonymous namespace closes: the
    plain C++ entry points a .cu file offers the binding."""
    tail = src[src.rfind("}  // namespace"):] if "}  // namespace" in src \
        else src
    return set(re.findall(r"^cudaError_t (launch_\w+)\(", tail, re.M))


@pytest.mark.parametrize("cu", CU)
def test_every_cu_is_bound(cu):
    bindings = (CSRC / "bindings.cpp").read_text()
    launchers = _exported_launchers((CSRC / cu).read_text())
    assert launchers, f"{cu} exports no launch_* function"
    for name in launchers:
        declared = re.search(rf"^cudaError_t {name}\(", bindings, re.M)
        called = len(re.findall(rf"\b{name}\(", bindings)) >= 2
        assert declared and called, (cu, name)


@pytest.mark.parametrize("cu", CU)
def test_every_cu_is_checked_by_chip_smoke(cu):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert set(chip_smoke.SOURCES) == set(chip_smoke.REPLACES)
    named = {pathlib.Path(p).name for p in chip_smoke.SOURCES.values()}
    assert cu in named, (cu, sorted(named))
    for name, path in chip_smoke.SOURCES.items():
        assert (REPO / path).is_file(), (name, path)
        assert chip_smoke.REPLACES[name].startswith("src/repro/"), name
