"""The kernel wrappers refuse, before the extension, every call their
binding in `kernels/csrc/bindings.cpp` would refuse.

A failing ``TORCH_CHECK`` inside the extension ends the process on the
card instead of raising (`tools/probe_refusals.py`), so each wrapper
runs `kernels/_checks.py`'s function named after its binding on the
arguments it is about to pass. Here each wrapper's launch function is
driven with CPU tensors and a fake extension that records calls: one
refused input per check its binding makes must raise ValueError with no
call recorded and no launch counted, and one good input must reach the
fake extension once and count one launch. A layout test holds that
every binding has a wrapper that checks first."""
import ast
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import _checks
from repro_torch.kernels.attention import flash_attention as k7
from repro_torch.kernels.decode_attention import flash_decode as k8
from repro_torch.kernels.meta_update import aggregate as k25
from repro_torch.kernels.meta_update import compress as k6
from repro_torch.kernels.meta_update import fused as k14
from repro_torch.kernels.ssd import ssd_scan as k9
from repro_torch.optim import fused_adam as k3

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
BINDINGS = (PKG / "kernels" / "csrc" / "bindings.cpp").read_text()
BOUND = re.findall(r'm\.def\("(\w+)"', BINDINGS)
MODULES = (k7, k8, k25, k6, k14, k9, k3)
COUNTERS = ((k14, "launches"), (k14, "meta_update_launches"),
            (k25, "launches"), (k25, "trimmed_launches"), (k3, "launches"),
            (k6, "launches"), (k7, "launches"), (k8, "launches"),
            (k9, "launches"))


class FakeExt:
    """Records each binding called; computes nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in BOUND:
            raise AttributeError(name)
        return lambda *args: self.calls.append(name)


@pytest.fixture
def ext(monkeypatch):
    # the launch counters go back to their values after the test: a
    # later test in this process reads them as its own path's counts
    for mod, name in COUNTERS:
        monkeypatch.setattr(mod, name, getattr(mod, name))
    fake = FakeExt()
    for mod in MODULES:
        monkeypatch.setattr(mod, "get_ext", lambda: fake)
    monkeypatch.setattr(k8, "_sm_count", lambda device: 132)
    return fake


def _counts():
    return [getattr(mod, name) for mod, name in COUNTERS]


def z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def misaligned(*shape, dtype=torch.float32):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def strided(*shape):
    """A non-contiguous (rows, cols) view."""
    return torch.zeros(tuple(reversed(shape))).t()


def meta(*shape):
    return torch.empty(shape, device="meta")


def k1(theta, alpha, g, out=None):
    return k14._launch(theta, alpha, g, theta if out is None else out)


def k2(gs, w):
    return k25._launch(gs, w)


def k3_step(p, g, m, v, scales=None):
    return k3._launch(p, g, m, v, z(2) if scales is None else scales,
                      lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.0)


def k4(theta, alpha, g):
    return k14._launch_flat(theta, alpha, g)


def k5(gs, live, trim=1):
    return k25._launch_trimmed(gs, live, trim)


def k6_encode(g, scales=None):
    return k6._launch(g, g, z(g.shape[0]) if scales is None else scales,
                      False)


def k7_call(q, k, v, window=None):
    return k7._launch(q, k, v, True, window, 0)


def k8_call(q, kc, vc=None, kvl=8):
    return k8._launch(q, kc, kc if vc is None else vc, kvl)


def k9_call(xdt, a, Bm, Cm, chunk=4):
    return k9._launch(xdt, a, Bm, Cm, chunk)


def ssd_grid(nh, L, hp, N, B=1):
    """K9 operands of a long sequence as stride-0 views (K9 takes any
    strides), so only the wrapper's outputs take memory."""
    one = torch.zeros(1)
    return (one.expand(B, nh, L, hp), one.expand(B, nh, L),
            one.expand(B, L, N), one.expand(B, L, N))


BF = torch.bfloat16
GOOD = {  # case: (binding, call)
    "K1 scalar alpha": ("inner_update", lambda: k1(z(2, 8), 0.1, z(2, 8))),
    "K1 per-client alpha": ("inner_update",
                            lambda: k1(z(2, 8), z(2, 8), z(2, 8))),
    "K4": ("inner_update", lambda: k4(z(8), z(8), z(8))),
    "K2": ("weighted_aggregate", lambda: k2(z(2, 8), z(2))),
    "K2 int8": ("weighted_aggregate",
                lambda: k2(z(2, 8, dtype=torch.int8), z(2))),
    "K3 bf16 moments": ("adam_flat", lambda: k3_step(
        z(8), z(8), z(8, dtype=BF), z(8, dtype=BF))),
    "K6": ("int8_encode", lambda: k6_encode(z(2, 8))),
    "K5 bf16": ("trimmed_mean", lambda: k5(z(3, 8, dtype=BF), z(3))),
    "K7": ("flash_attention", lambda: k7_call(z(1, 4, 8, 64, dtype=BF),
                                              z(1, 2, 8, 64, dtype=BF),
                                              z(1, 2, 8, 64, dtype=BF))),
    "K7 mla": ("flash_attention", lambda: k7_call(
        z(1, 2, 8, 192, dtype=BF), z(1, 2, 8, 192, dtype=BF),
        z(1, 2, 8, 128, dtype=BF))),
    "K7 cross, Lq 1": ("flash_attention", lambda: k7_call(
        z(1, 2, 1, 64, dtype=BF), z(1, 2, 8, 64, dtype=BF),
        z(1, 2, 8, 64, dtype=BF))),
    "K8 G 7": ("flash_decode", lambda: k8_call(z(2, 28, 128, dtype=BF),
                                              z(2, 16, 4, 128, dtype=BF))),
    "K8 ragged": ("flash_decode", lambda: k8_call(
        z(2, 6, 64), z(2, 16, 2, 64), kvl=torch.tensor([3, 16]))),
    "K9": ("ssd_chunk", lambda: k9_call(z(1, 2, 8, 4), z(1, 2, 8),
                                        z(1, 8, 4), z(1, 8, 4))),
    "K9 grid at 65,535 head-chunks": ("ssd_chunk", lambda: k9_call(
        *ssd_grid(nh=5, L=13107 * 128, hp=1, N=1), chunk=128)),
    "K9 grid at prefill_32k, jamba's 128 heads": ("ssd_chunk", lambda: k9_call(
        *ssd_grid(nh=128, L=32768, hp=1, N=1), chunk=128)),
    # the y kernel's heads x chunks sit on gridDim.x (up to 2^31 - 1):
    # jamba's 128 heads at 65,536 tokens (512 chunks of 128) make 65,536
    "K9 grid past 65,535 head-chunks": ("ssd_chunk", lambda: k9_call(
        *ssd_grid(nh=128, L=65536, hp=1, N=1), chunk=128)),
}

REFUSED = {
    # K1 (inner_update)
    "K1 dtype": lambda: k1(z(2, 8, dtype=BF), 0.1, z(2, 8, dtype=BF)),
    "K1 g dtype": lambda: k1(z(2, 8), 0.1, z(2, 8, dtype=torch.float64)),
    "K1 rank": lambda: k1(z(8), 0.1, z(8)),
    "K1 contiguity": lambda: k1(strided(2, 8), 0.1, z(2, 8)),
    "K1 g shape": lambda: k1(z(2, 8), 0.1, z(2, 12)),
    "K1 out shape": lambda: k1(z(2, 8), 0.1, z(2, 8), z(3, 8)),
    "K1 N % 4": lambda: k1(z(2, 6), 0.1, z(2, 6)),
    "K1 alignment": lambda: k1(misaligned(2, 8), 0.1, z(2, 8)),
    "K1 out alignment": lambda: k1(z(2, 8), 0.1, z(2, 8), misaligned(2, 8)),
    "K1 shared alpha shape": lambda: k1(z(2, 8), z(12), z(2, 8)),
    "K1 per-client alpha shape": lambda: k1(z(2, 8), z(3, 8), z(2, 8)),
    "K1 alpha alignment": lambda: k1(z(2, 8), misaligned(8), z(2, 8)),
    "K1 device": lambda: k1(z(2, 8), 0.1, meta(2, 8)),
    # K4 (inner_update at C = 1)
    "K4 N % 4": lambda: k4(z(6), z(6), z(6)),
    "K4 alignment": lambda: k4(misaligned(8), z(8), z(8)),
    "K4 alpha alignment": lambda: k4(z(8), misaligned(8), z(8)),
    # K2 (weighted_aggregate)
    "K2 dtype": lambda: k2(z(2, 8, dtype=torch.float64), z(2)),
    "K2 rank": lambda: k2(z(2, 2, 8), z(2)),
    "K2 rows": lambda: k2(z(12289, 4), z(12289)),
    "K2 N % 4": lambda: k2(z(2, 6), z(2)),
    "K2 w shape": lambda: k2(z(2, 8), z(3)),
    "K2 alignment": lambda: k2(misaligned(2, 8), z(2)),
    # K3 (adam_flat)
    "K3 dtype": lambda: k3_step(z(8, dtype=BF), z(8), z(8), z(8)),
    "K3 g dtype": lambda: k3_step(z(8), z(8, dtype=BF), z(8), z(8)),
    "K3 moment dtypes": lambda: k3_step(z(8), z(8), z(8), z(8, dtype=BF)),
    "K3 moment dtype": lambda: k3_step(z(8), z(8), z(8, dtype=torch.int8),
                                       z(8, dtype=torch.int8)),
    "K3 shape": lambda: k3_step(z(8), z(8), z(12), z(8)),
    "K3 contiguity": lambda: k3_step(z(16)[::2], z(8), z(8), z(8)),
    "K3 N % 4": lambda: k3_step(z(6), z(6), z(6), z(6)),
    "K3 alignment": lambda: k3_step(z(8), z(8), misaligned(8), z(8)),
    "K3 scales": lambda: k3_step(z(8), z(8), z(8), z(8), z(3)),
    # K6 (int8_encode)
    "K6 rank": lambda: k6_encode(z(8)),
    "K6 N % 4": lambda: k6_encode(z(2, 6)),
    "K6 scales shape": lambda: k6_encode(z(2, 8), z(3)),
    "K6 alignment": lambda: k6_encode(misaligned(2, 8)),
    # K5 (trimmed_mean)
    "K5 dtype": lambda: k5(z(3, 8, dtype=torch.int8), z(3)),
    "K5 trim": lambda: k5(z(2, 8), z(2), trim=1),
    "K5 N % 4": lambda: k5(z(3, 6), z(3)),
    "K5 live shape": lambda: k5(z(3, 8), z(2)),
    "K5 alignment": lambda: k5(misaligned(3, 8), z(3)),
    # K7 (flash_attention)
    "K7 mixed dtypes": lambda: k7_call(z(1, 2, 8, 64, dtype=BF),
                                       z(1, 2, 8, 64), z(1, 2, 8, 64)),
    "K7 dtype": lambda: k7_call(*(z(1, 2, 8, 64, dtype=torch.float16)
                                  for _ in range(3))),
    "K7 rank": lambda: k7_call(z(2, 8, 64), z(2, 8, 64), z(2, 8, 64)),
    "K7 k shape": lambda: k7_call(z(1, 2, 8, 64), z(1, 2, 8, 32),
                                  z(1, 2, 8, 64)),
    "K7 v shape": lambda: k7_call(z(1, 2, 8, 64), z(1, 2, 8, 64),
                                  z(1, 2, 9, 64)),
    "K7 heads": lambda: k7_call(z(1, 3, 8, 64), z(1, 2, 8, 64),
                                z(1, 2, 8, 64)),
    "K7 head dim": lambda: k7_call(*(z(1, 2, 8, 256, dtype=BF)
                                     for _ in range(3))),
    "K7 value dim": lambda: k7_call(z(1, 2, 8, 128, dtype=BF),
                                    z(1, 2, 8, 128, dtype=BF),
                                    z(1, 2, 8, 256, dtype=BF)),
    "K7 window": lambda: k7_call(*(z(1, 2, 8, 64) for _ in range(3)),
                                 window=0),
    "K7 device": lambda: k7_call(z(1, 2, 8, 64), meta(1, 2, 8, 64),
                                 z(1, 2, 8, 64)),
    # K8 (flash_decode)
    "K8 G <= 12": lambda: k8_call(z(1, 16, 64, dtype=BF),
                                  z(1, 16, 1, 64, dtype=BF)),
    "K8 hd <= 192": lambda: k8_call(z(1, 2, 256), z(1, 16, 2, 256)),
    "K8 dtype": lambda: k8_call(z(1, 2, 64, dtype=torch.float64),
                                z(1, 16, 2, 64, dtype=torch.float64)),
    "K8 mixed dtypes": lambda: k8_call(z(1, 2, 64, dtype=BF),
                                       z(1, 16, 2, 64)),
    "K8 rank": lambda: k8_call(z(2, 64), z(1, 16, 2, 64)),
    "K8 cache shapes": lambda: k8_call(z(1, 2, 64), z(1, 16, 2, 64),
                                       z(1, 12, 2, 64)),
    "K8 cache batch": lambda: k8_call(z(1, 2, 64), z(2, 16, 2, 64)),
    "K8 heads": lambda: k8_call(z(1, 3, 64), z(1, 16, 2, 64)),
    "K8 hd % vec": lambda: k8_call(z(1, 2, 6), z(1, 16, 2, 6)),
    "K8 hd above 128 % 24": lambda: k8_call(z(1, 2, 136), z(1, 16, 2, 136)),
    "K8 q alignment": lambda: k8_call(misaligned(1, 2, 64),
                                      z(1, 16, 2, 64)),
    "K8 head dim contiguity": lambda: k8_call(
        z(1, 2, 64), z(1, 16, 64, 2).transpose(2, 3)),
    "K8 cache alignment": lambda: k8_call(z(1, 2, 64),
                                          misaligned(1, 16, 2, 64)),
    "K8 kv_length shape": lambda: k8_call(z(2, 2, 64), z(2, 16, 2, 64),
                                          kvl=torch.tensor([3, 4, 5])),
    "K8 kv_length range": lambda: k8_call(z(1, 2, 64), z(1, 16, 2, 64),
                                          kvl=2 ** 31),
    "K8 device": lambda: k8_call(z(1, 2, 64), meta(1, 16, 2, 64)),
    # K9 (ssd_chunk)
    "K9 dtype": lambda: k9_call(z(1, 2, 8, 4, dtype=torch.float64),
                                z(1, 2, 8), z(1, 8, 4), z(1, 8, 4)),
    "K9 rank": lambda: k9_call(z(1, 2, 8, 4), z(1, 2, 8, 1), z(1, 8, 4),
                               z(1, 8, 4)),
    "K9 chunk": lambda: k9_call(z(1, 2, 256, 4), z(1, 2, 256),
                                z(1, 256, 4), z(1, 256, 4), chunk=256),
    "K9 state": lambda: k9_call(z(1, 2, 8, 4), z(1, 2, 8), z(1, 8, 130),
                                z(1, 8, 130)),
    "K9 L % chunk": lambda: k9_call(z(1, 2, 6, 4), z(1, 2, 6), z(1, 6, 4),
                                    z(1, 6, 4)),
    "K9 a shape": lambda: k9_call(z(1, 2, 8, 4), z(1, 3, 8), z(1, 8, 4),
                                  z(1, 8, 4)),
    "K9 C shape": lambda: k9_call(z(1, 2, 8, 4), z(1, 2, 8), z(1, 8, 4),
                                  z(1, 8, 8)),
    "K9 device": lambda: k9_call(z(1, 2, 8, 4), z(1, 2, 8), meta(1, 8, 4),
                                 meta(1, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_call_raises_before_the_extension(ext, case):
    before = _counts()
    with pytest.raises(ValueError, match="refuses the call"):
        REFUSED[case]()
    assert ext.calls == [] and _counts() == before


@pytest.mark.parametrize("case", sorted(GOOD))
def test_good_call_reaches_the_extension_once(ext, case):
    binding, call = GOOD[case]
    before = _counts()
    call()
    assert ext.calls == [binding]
    assert sum(_counts()) == sum(before) + 1


def test_refused_is_a_value_error_and_a_type_error():
    """Callers that caught the wrappers' old TypeError on a wrong dtype
    still catch it."""
    assert issubclass(_checks.Refused, ValueError)
    assert issubclass(_checks.Refused, TypeError)


def _calls_in(func):
    """(line, 'get_ext' or '_checks', binding) for each call in func."""
    out = []
    for node in ast.walk(func):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        owner = node.func.value
        if (isinstance(owner, ast.Call) and isinstance(owner.func, ast.Name)
                and owner.func.id == "get_ext"):
            out.append((node.lineno, "get_ext", node.func.attr))
        elif isinstance(owner, ast.Name) and owner.id == "_checks":
            out.append((node.lineno, "_checks", node.func.attr))
    return out


def test_every_binding_has_a_wrapper_that_checks_first():
    """Each `m.def` of bindings.cpp has a function of the same name in
    `_checks`, and every ``get_ext().<binding>(...)`` in the port runs
    after ``_checks.<binding>(...)`` in the same function."""
    assert len(BOUND) == 8
    launched = set()
    for path in sorted(PKG.rglob("*.py")):
        for func in ast.walk(ast.parse(path.read_text())):
            if not isinstance(func, ast.FunctionDef):
                continue
            calls = _calls_in(func)
            for line, kind, name in calls:
                if kind != "get_ext":
                    continue
                launched.add(name)
                checked = [ln for ln, kd, nm in calls
                           if kd == "_checks" and nm == name and ln < line]
                assert checked, (f"{path.relative_to(REPO)}:{line} calls "
                                 f"get_ext().{name} unchecked")
    assert launched == set(BOUND)
    for name in BOUND:
        assert callable(getattr(_checks, name)), name
