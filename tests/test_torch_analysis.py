"""The port's lint (`repro_torch.analysis`): each rule against planted
snippets (positive and negative), the disable-comment policy, the
baseline contract, and the gate itself — the port lints clean in
``--strict`` over its default paths. The cases mirror
`tests/test_repro_lint.py` where they apply, plus the torch cases of
``rng-bare`` (draws without ``generator=``, global seeding) and
``rng-time-seed`` through ``manual_seed``.

Snippets are source strings fed to `lint_source`; ``relpath`` selects
the scope (the determinism rules fire only in the port's
determinism-critical modules).

Serial time: ~5 s.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import core, lint_paths, lint_source
from repro_torch.analysis.lint import DEFAULT_PATHS, default_paths

core.load_rules()

REPO = Path(__file__).resolve().parents[1]
DET_PATH = "src/repro_torch/federated/fixture.py"   # determinism-critical
PLAIN_PATH = "src/repro_torch/fixture.py"           # not det-critical


def lint(src, relpath=PLAIN_PATH, rules=None):
    return lint_source(textwrap.dedent(src), relpath=relpath, rules=rules)


def rule_ids(violations):
    return {v.rule for v in violations}


# ---- RNG discipline: the reference's cases ------------------------------

class TestRngRules:
    def test_bare_numpy_draw_flagged(self):
        vs = lint("""
            import numpy as np
            def sample():
                return np.random.permutation(10)
        """, rules=["rng-bare"])
        assert rule_ids(vs) == {"rng-bare"}

    def test_seeded_stream_clean(self):
        vs = lint("""
            import numpy as np
            def sample(seed):
                rng = np.random.RandomState(seed)
                return rng.permutation(10), rng.normal(0, 1, 3)
        """, rules=["rng-bare", "rng-unseeded"])
        assert not vs

    def test_stdlib_random_flagged(self):
        assert rule_ids(lint("import random\n")) == {"rng-stdlib"}
        assert rule_ids(lint("from random import shuffle\n")) \
            == {"rng-stdlib"}

    def test_numpy_random_import_not_confused_with_stdlib(self):
        assert not lint("import numpy.random\n", rules=["rng-stdlib"])

    def test_unseeded_constructors_flagged(self):
        vs = lint("""
            import numpy as np
            a = np.random.RandomState()
            b = np.random.default_rng()
        """, rules=["rng-unseeded"])
        assert len(vs) == 2 and rule_ids(vs) == {"rng-unseeded"}

    def test_time_derived_seed_flagged(self):
        vs = lint("""
            import time
            import numpy as np
            rng = np.random.RandomState(int(time.time()))
        """, rules=["rng-time-seed"])
        assert rule_ids(vs) == {"rng-time-seed"}

    def test_seed_assignment_from_wallclock_flagged(self):
        vs = lint("""
            import time
            base_seed = int(time.time_ns())
        """, rules=["rng-time-seed"])
        assert rule_ids(vs) == {"rng-time-seed"}

    def test_explicit_seed_clean(self):
        vs = lint("""
            import numpy as np
            rng = np.random.RandomState(1234)
            gen = np.random.default_rng(np.random.SeedSequence(7))
        """, rules=["rng-bare", "rng-unseeded", "rng-time-seed"])
        assert not vs


# ---- RNG discipline: torch's global generator ---------------------------

TORCH_BARE = {
    "module_draw": "x = torch.randn(3, 4)",
    "like_draw": "x = torch.rand_like(y)",
    "randint": "i = torch.randint(0, 10, (4,))",
    "randperm": "p = torch.randperm(8, device='cuda')",
    "normal": "z = torch.normal(0.0, 1.0, (3,))",
    "inplace_method": "w.uniform_(-1.0, 1.0)",
    "inplace_on_call": "w = torch.empty(3).normal_()",
    "nn_init": "torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0)",
    "global_seed": "torch.manual_seed(0)",
    "cuda_seed": "torch.cuda.manual_seed_all(0)",
    "global_reseed": "torch.seed()",
    "from_import": "from torch import randn\nx = randn(3)",
    "aliased": "import torch as th\nx = th.rand(3)",
}

TORCH_SEEDED = {
    "module_draw": "x = torch.randn(3, 4, generator=g)",
    "inplace_method": "w.uniform_(-1.0, 1.0, generator=g)",
    "nn_init": "torch.nn.init.trunc_normal_(w, 0, 1, -2, 2, generator=g)",
    "generator_seed": "g = torch.Generator(device='cpu')\ng.manual_seed(7)",
    "generator_chain": "g = torch.Generator().manual_seed(7)",
    "numpy_stream": "import numpy as np\n"
                    "r = np.random.RandomState(0)\nz = r.normal(0, 1, 3)",
    "non_draw": "x = torch.zeros(3)\ny = torch.randn_like",
}


@pytest.mark.parametrize("case", sorted(TORCH_BARE))
def test_torch_global_generator_flagged(case):
    vs = lint("import torch\n" + TORCH_BARE[case], rules=["rng-bare"])
    assert rule_ids(vs) == {"rng-bare"}, case
    assert "generator" in vs[0].message


@pytest.mark.parametrize("case", sorted(TORCH_SEEDED))
def test_torch_seeded_generator_clean(case):
    assert not lint("import torch\n" + TORCH_SEEDED[case],
                    rules=["rng-bare"]), case


def test_manual_seed_from_wallclock_flagged():
    vs = lint("""
        import time
        import torch
        g = torch.Generator()
        g.manual_seed(int(time.time()))
    """, rules=["rng-time-seed"])
    assert rule_ids(vs) == {"rng-time-seed"}


# ---- Determinism ---------------------------------------------------------

class TestDeterminismRules:
    def test_wallclock_in_critical_module_flagged(self):
        vs = lint("""
            import time
            def stamp():
                return time.time()
        """, relpath=DET_PATH, rules=["det-wallclock"])
        assert rule_ids(vs) == {"det-wallclock"}

    def test_interval_timers_stay_legal(self):
        vs = lint("""
            import time
            def elapsed(t0):
                return time.perf_counter() - t0
            def deadline():
                return time.monotonic() + 5.0
        """, relpath=DET_PATH, rules=["det-wallclock"])
        assert not vs

    def test_wallclock_outside_critical_scope_ignored(self):
        for rel in ("benchmarks/bench_fixture.py", PLAIN_PATH,
                    "src/repro_torch/launch/train.py"):
            assert not lint("import time\nt = time.time()\n", relpath=rel,
                            rules=["det-wallclock"])

    @pytest.mark.parametrize("rel", [
        "src/repro_torch/federated/serving.py",
        "src/repro_torch/core/fedmeta.py",
        "src/repro_torch/checkpoint/io.py",
        "src/repro_torch/data/registry.py",
        "src/repro_torch/data/federated.py"])
    def test_port_paths_are_det_critical(self, rel):
        vs = lint("import time\nt = time.time()\n", relpath=rel,
                  rules=["det-wallclock"])
        assert rule_ids(vs) == {"det-wallclock"}
        assert (REPO / rel).exists()

    def test_reference_paths_are_not_the_ports_scope(self):
        assert not lint("import time\nt = time.time()\n",
                        relpath="src/repro/federated/serving.py",
                        rules=["det-wallclock"])

    def test_set_iteration_into_accumulator_flagged(self):
        vs = lint("""
            def total(weights):
                acc = 0.0
                for w in set(weights):
                    acc += w
                return acc
        """, relpath=DET_PATH, rules=["det-unordered-iter"])
        assert rule_ids(vs) == {"det-unordered-iter"}

    def test_sum_over_dict_values_flagged(self):
        vs = lint("""
            def total(per_client):
                return sum(per_client.values())
        """, relpath=DET_PATH, rules=["det-unordered-iter"])
        assert rule_ids(vs) == {"det-unordered-iter"}

    def test_sorted_wrapper_clean(self):
        vs = lint("""
            def total(per_client):
                acc = 0.0
                for k in sorted(per_client.keys()):
                    acc += per_client[k]
                return acc + sum(sorted(per_client.values()))
        """, relpath=DET_PATH, rules=["det-unordered-iter"])
        assert not vs


# ---- Thread safety -------------------------------------------------------

_POOL_FIXTURE = """
    import threading

    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self._done = 0
            self._t = threading.Thread(target=self._work)

        def _work(self):
            {write}
"""


class TestThreadRules:
    def test_unguarded_worker_write_flagged(self):
        vs = lint(_POOL_FIXTURE.format(write="self._done = 1"),
                  rules=["thread-unguarded-write"])
        assert rule_ids(vs) == {"thread-unguarded-write"}

    def test_locked_worker_write_clean(self):
        write = "with self._lock:\n                self._done = 1"
        vs = lint(_POOL_FIXTURE.format(write=write),
                  rules=["thread-unguarded-write"])
        assert not vs

    def test_worker_class_without_lock_flagged(self):
        vs = lint("""
            import threading
            class P:
                def start(self):
                    threading.Thread(target=self._run).start()
                def _run(self):
                    self._err = ValueError("x")
        """, rules=["thread-unguarded-write"])
        assert rule_ids(vs) == {"thread-unguarded-write"}
        assert "no lock attribute" in vs[0].message

    def test_init_is_exempt(self):
        vs = lint("""
            import threading
            class P:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._n = 0
                    self._t = threading.Thread(target=self._work)
                def _work(self):
                    with self._lock:
                        self._n += 1
        """, rules=["thread-unguarded-write"])
        assert not vs

    def test_blocking_call_under_lock_flagged(self):
        vs = lint("""
            import threading
            class R:
                def __init__(self):
                    self._lock = threading.Lock()
                def get(self, ev):
                    with self._lock:
                        ev.wait()
        """, rules=["thread-lock-order"])
        assert rule_ids(vs) == {"thread-lock-order"}

    def test_nested_foreign_lock_flagged(self):
        vs = lint("""
            import threading
            class R:
                def __init__(self):
                    self._lock = threading.Lock()
                def swap(self, other):
                    with self._lock:
                        with other._lock:
                            pass
        """, rules=["thread-lock-order"])
        assert rule_ids(vs) == {"thread-lock-order"}

    def test_wait_outside_lock_clean(self):
        vs = lint("""
            import threading
            class R:
                def __init__(self):
                    self._lock = threading.Lock()
                def get(self, ev):
                    with self._lock:
                        hit = True
                    ev.wait()
                    return hit
        """, rules=["thread-lock-order"])
        assert not vs


# ---- Kernel packaging ----------------------------------------------------

def _kernel_pkg(tmp_path, files):
    pkg = tmp_path / "src" / "repro_torch" / "kernels" / "foo"
    pkg.mkdir(parents=True)
    (pkg.parent / "_build.py").write_text("")
    for name, text in files.items():
        (pkg / name).write_text(text)
    return lint_paths([str(tmp_path)], root=str(tmp_path),
                      rules=["kernel-missing-ref"])


class TestKernelRules:
    def test_missing_ref_oracle_flagged(self, tmp_path):
        report = _kernel_pkg(tmp_path, {"__init__.py": "",
                                        "ops.py": "def op(x):\n    return x\n"})
        assert rule_ids(report.violations) == {"kernel-missing-ref"}
        assert "no ref.py" in report.violations[0].message

    def test_missing_ops_flagged(self, tmp_path):
        report = _kernel_pkg(tmp_path, {"__init__.py": "",
                                        "ref.py": "def op_ref(x):\n"
                                                  "    return x\n"})
        assert rule_ids(report.violations) == {"kernel-missing-ref"}

    def test_ref_not_imported_by_ops_flagged(self, tmp_path):
        report = _kernel_pkg(tmp_path, {"__init__.py": "",
                                        "ref.py": "", "ops.py": "X = 1\n"})
        assert "never imports" in report.violations[0].message

    def test_ref_wired_into_ops_clean(self, tmp_path):
        report = _kernel_pkg(tmp_path, {
            "__init__.py": "", "ref.py": "def op_ref(x):\n    return x\n",
            "ops.py": "from repro_torch.kernels.foo import ref\n"})
        assert report.clean

    def test_the_ports_kernel_packages_are_checked(self):
        pkgs = sorted(p.name for p in (REPO / "src/repro_torch/kernels")
                      .iterdir() if (p / "__init__.py").exists())
        assert pkgs == ["attention", "decode_attention", "meta_update",
                        "ssd"]
        report = lint_paths([str(REPO / "src/repro_torch/kernels")],
                            root=str(REPO), rules=["kernel-missing-ref"])
        assert report.clean and report.files > 4


# ---- Disable comments & baseline ----------------------------------------

class TestDisablePolicy:
    def test_reasoned_disable_suppresses(self):
        vs = lint("import random"
                  "  # repro-lint: disable=rng-stdlib (fixture)\n")
        assert not vs

    def test_standalone_disable_covers_next_line(self):
        vs = lint("# repro-lint: disable=rng-bare (fixture)\n"
                  "import torch\nx = torch.randn(3)\n")
        assert rule_ids(vs) == {"rng-bare"}
        vs = lint("import torch\n# repro-lint: disable=rng-bare (fixture)\n"
                  "x = torch.randn(3)\n")
        assert not vs

    def test_bare_disable_is_itself_a_violation(self):
        # the string is split so that this file's own line does not
        # match the directive when the gates lint the tests
        vs = lint("import random  # repro-lint: "
                  "disable=rng-stdlib\n")
        assert rule_ids(vs) == {"lint-bad-disable", "rng-stdlib"}

    def test_disable_scoped_to_named_rule(self):
        vs = lint("""
            import random  # repro-lint: disable=rng-bare (wrong rule)
        """)
        assert rule_ids(vs) == {"rng-stdlib"}


class TestBaselineAndGate:
    def test_baseline_suppresses_only_outside_strict(self, tmp_path):
        src = tmp_path / "mod.py"
        src.write_text("import torch\nx = torch.rand(2)\n")
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps(
            [{"rule": "rng-bare", "path": "mod.py", "line": 2}]))
        lax = lint_paths([str(src)], root=str(tmp_path), baseline=str(bl))
        assert lax.clean and lax.baseline_suppressed == 1
        strict = lint_paths([str(src)], root=str(tmp_path),
                            baseline=str(bl), strict=True)
        assert not strict.clean
        assert "lint-baseline-nonempty" in rule_ids(strict.violations)

    def test_syntax_error_reported_not_raised(self, tmp_path):
        src = tmp_path / "broken.py"
        src.write_text("def f(:\n")
        report = lint_paths([str(src)], root=str(tmp_path))
        assert rule_ids(report.violations) == {"lint-parse-error"}

    def test_default_paths_are_the_ports(self):
        paths = default_paths(str(REPO))
        assert str(REPO / "src/repro_torch") in paths
        assert str(REPO / "tests/torchdist.py") in paths
        assert str(REPO / "tests/test_torch_analysis.py") in paths
        assert not any(Path(p).name == "test_repro_lint.py" for p in paths)
        assert DEFAULT_PATHS[0] == "src/repro_torch"

    def test_port_lints_clean_strict(self):
        """The gate: the port's default paths, strict mode, the shipped
        (empty) baseline."""
        report = lint_paths(default_paths(str(REPO)), root=str(REPO),
                            baseline=str(REPO / ".repro-lint-baseline.json"),
                            strict=True)
        assert report.clean, "\n".join(
            v.format() for v in report.violations)
        assert report.files > 100

    def test_cli_entrypoint(self):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", "--strict"],
            cwd=str(REPO / "tests"), env=env, capture_output=True,
            text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 violation(s)" in proc.stdout
        rules = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint",
             "--list-rules"], cwd=str(REPO), env=env, capture_output=True,
            text=True).stdout
        ids = {line.split()[0] for line in rules.splitlines()}
        assert ids == {"rng-bare", "rng-stdlib", "rng-unseeded",
                       "rng-time-seed", "det-wallclock", "det-unordered-iter",
                       "thread-unguarded-write", "thread-lock-order",
                       "kernel-missing-ref"}

    def test_planted_violation_fails_the_cli(self, tmp_path):
        bad = tmp_path / "mod.py"
        bad.write_text("import torch\ntorch.manual_seed(0)\n")
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.lint", "--strict",
             str(bad)], cwd=str(REPO), env=env, capture_output=True,
            text=True)
        assert proc.returncode == 1 and "[rng-bare]" in proc.stdout
