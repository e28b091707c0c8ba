"""The port stands alone: `repro_torch` and `chip_smoke.py` import no jax
and nothing of the JAX package (`repro`), and the smoke test refuses to
run without a card or outside a checkout."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _run(code, cwd=REPO, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("JAX_PLATFORMS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax_or_repro():
    """Every module imports in a fresh interpreter with no jax, nothing
    of `repro` and no kernel build (there is no nvcc here)."""
    mods = _modules()
    assert len(mods) > 20
    assert {"repro_torch.configs.qwen2_vl_7b",
            "repro_torch.configs.seamless_m4t_medium",
            "repro_torch.kernels._checks",
            "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.sharding", "repro_torch.sharding.collectives",
            "repro_torch.sharding.context", "repro_torch.sharding.dtensor",
            "repro_torch.sharding.ep_moe",
            "repro_torch.sharding.rules"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, {!r})\n".format(str(REPO)) +
        "import chip_smoke\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._EXT is None, 'a kernel was built at import'\n"
        "assert 'triton' not in sys.modules\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_names_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, name)


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=300, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_every_kernel_has_a_source_a_counter_and_a_plain_version():
    """K1, K2, K3, K7 and K8: a CUDA source under kernels/csrc/ built by
    `_build`, a module-level launch count, and a plain version beside the
    wrapper."""
    import importlib
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build
    srcs = {pathlib.Path(s).name for s in _build.sources()}
    for mod, src, plain in (
            ("kernels.meta_update.fused", "inner_update.cu",
             "ref.inner_update_plane_ref"),
            ("kernels.meta_update.aggregate", "aggregate.cu",
             "weighted_aggregate_ref"),
            ("optim.fused_adam", "adam.cu", "adam_flat_ref"),
            ("kernels.attention.flash_attention", "flash_attention.cu",
             "ref.mha_reference"),
            ("kernels.decode_attention.flash_decode", "flash_decode.cu",
             "ref.decode_attention_ref")):
        m = importlib.import_module("repro_torch." + mod)
        assert src in srcs, src
        assert isinstance(m.launches, int)
        obj = m
        for part in plain.split("."):
            obj = getattr(obj, part)
        assert callable(obj), (mod, plain)


def test_compare_population_reads_json_only():
    """`tools/compare_population.py` imports neither package (nor torch,
    numpy or jax): it reads JSON records."""
    names = {n.split(".")[0] for n in
             _imports(REPO / "tools" / "compare_population.py")}
    assert not names & {"jax", "jaxlib", "repro", "repro_torch", "torch",
                        "numpy"}, names
