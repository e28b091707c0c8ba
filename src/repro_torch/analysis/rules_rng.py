"""RNG discipline rules (``rng-*``). Counterpart of
`repro/analysis/rules_rng.py`, with its rule ids and semantics, and
torch's global generator added.

The paper's headline numbers (2.82–4.33× less communication than
FedAvg) are only meaningful when every method sees *identical sampling
streams* — the experiment plane's whole design (DESIGN.md §8). One
bare ``np.random.*`` call, one unseeded ``RandomState`` or one
time-derived seed anywhere in a data/round path silently detaches a
run from its stream. Policy: seeded streams (``RandomState(seed)``,
``default_rng(seed)``, a ``torch.Generator`` passed as
``generator=``) or ``SeedSequence`` entropy only.

  rng-bare       module-level numpy RNG calls (``np.random.<draw>``) —
                 global-state draws, unseedable per stream. torch has
                 a global generator that JAX lacks, so this also flags
                 torch's random ops called without ``generator=``
                 (``torch.rand``/``randn``/``randint``/``randperm``/
                 ``normal``/``bernoulli``/``multinomial``/``poisson``,
                 the ``*_like`` draws, the in-place ``.uniform_()``-style
                 methods and the ``torch.nn.init`` draws) and every
                 seeding of the global generator (``torch.manual_seed``,
                 ``torch.seed``, ``torch.cuda.manual_seed[_all]``,
                 ``torch.cuda.seed[_all]``, ``torch.random.*``)
  rng-stdlib     any ``import random`` — the stdlib global RNG has no
                 place in this repo
  rng-unseeded   ``RandomState()`` / ``default_rng()`` with no
                 arguments — seeded from the OS, never reproducible
  rng-time-seed  a seed derived from wall-clock (``time.time``,
                 ``datetime.now``, ``os.urandom``, ``uuid4``), also
                 through ``manual_seed(<time>)``
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (ModuleInfo, Violation, attr_chain,
                                       numpy_aliases, rule)

#: numpy.random attributes that are stream constructors / entropy
#: plumbing — everything else on the module is a global-state draw.
ALLOWED_RANDOM_ATTRS = frozenset({
    "RandomState", "Generator", "default_rng", "BitGenerator",
    "MT19937", "SeedSequence", "Philox", "PCG64", "PCG64DXSM", "SFC64",
})

_RNG_CONSTRUCTORS = frozenset({"RandomState", "default_rng", "PRNGKey",
                               "SeedSequence", "Generator", "MT19937",
                               "manual_seed", "manual_seed_all"})

#: torch draws that take ``generator=`` (module functions, in-place
#: tensor methods, `torch.nn.init` initializers)
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson"})
TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "geometric_", "cauchy_", "log_normal_"})
TORCH_INIT_DRAWS = frozenset({
    "uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
    "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
    "orthogonal_", "sparse_"})
#: seeding torch's global generators
TORCH_GLOBAL_SEEDS = frozenset({"manual_seed", "seed", "manual_seed_all",
                                "seed_all"})
_TIME_SOURCES = frozenset({"time.time", "time.time_ns", "datetime.now",
                           "datetime.datetime.now", "datetime.utcnow",
                           "datetime.datetime.utcnow", "os.urandom",
                           "uuid.uuid4", "uuid.uuid1"})


def _is_np_random(chain: str, aliases: dict) -> bool:
    if chain is None:
        return False
    head, _, _ = chain.rpartition(".")
    return (head in {f"{m}.random" for m in aliases["module"]}
            or head in aliases["random"])


def _bare_numpy(module: ModuleInfo):
    aliases = numpy_aliases(module.tree)
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Attribute):
            continue
        chain = attr_chain(node)
        if not _is_np_random(chain, aliases):
            continue
        if node.attr in ALLOWED_RANDOM_ATTRS:
            continue
        out.append(Violation(
            "rng-bare", module.relpath, node.lineno, node.col_offset + 1,
            f"`{chain}` draws from numpy's global RNG — use a seeded "
            f"`RandomState`/`default_rng` stream instead"))
    return out


def torch_aliases(tree) -> tuple:
    """(names bound to the torch module, names imported from it) by the
    file's imports."""
    mods, names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.asname or "torch" for a in node.names
                        if a.name == "torch")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            names.update(a.asname or a.name for a in node.names
                         if a.name in TORCH_DRAWS | TORCH_GLOBAL_SEEDS)
    return mods, names


def _bare_torch(node: ast.Call, mods: set, names: set):
    """How ``node`` draws from or seeds torch's global generator, or
    None."""
    has_gen = any(k.arg == "generator" for k in node.keywords)
    chain = attr_chain(node.func)
    if chain is None:
        # ``torch.empty(...).uniform_()``: a method on a call's result
        if isinstance(node.func, ast.Attribute) and not has_gen and \
                node.func.attr in TORCH_INPLACE_DRAWS:
            return f"`.{node.func.attr}()` draws"
        return None
    head, _, tail = chain.rpartition(".")
    root = chain.split(".", 1)[0]
    seeders = {f"{m}{sub}" for m in mods for sub in ("", ".cuda", ".random")}
    if tail in TORCH_GLOBAL_SEEDS and (head in seeders or
                                       (not head and chain in names)):
        return f"`{chain}` seeds"
    if has_gen:
        return None
    if tail in TORCH_DRAWS and (head in mods or (not head and chain in names)):
        return f"`{chain}` draws"
    if tail in TORCH_INIT_DRAWS and (head.endswith("nn.init") or
                                     head == "init"):
        return f"`{chain}` draws"
    if tail in TORCH_INPLACE_DRAWS and head and root not in mods:
        return f"`{chain}` draws"
    return None


@rule("rng-bare",
      "module-level numpy RNG draw, torch RNG draw without generator= "
      "or global torch seeding (unseedable global state)")
def check_bare(module: ModuleInfo):
    out = _bare_numpy(module)
    mods, names = torch_aliases(module.tree)
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        how = _bare_torch(node, mods, names)
        if how is not None:
            out.append(Violation(
                "rng-bare", module.relpath, node.lineno, node.col_offset + 1,
                f"{how} from torch's global generator — pass a seeded "
                f"`torch.Generator` as generator="))
    return out


@rule("rng-stdlib", "stdlib `random` import (global, unseeded per stream)")
def check_stdlib_random(module: ModuleInfo):
    out = []
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        if "random" in names:
            out.append(Violation(
                "rng-stdlib", module.relpath, node.lineno,
                node.col_offset + 1,
                "stdlib `random` is banned — every stream in this repo "
                "is an explicitly seeded numpy/jax stream"))
    return out


@rule("rng-unseeded", "RandomState()/default_rng() with no seed")
def check_unseeded(module: ModuleInfo):
    out = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) or node.args or node.keywords:
            continue
        chain = attr_chain(node.func) or ""
        tail = chain.rpartition(".")[2]
        if tail in ("RandomState", "default_rng"):
            out.append(Violation(
                "rng-unseeded", module.relpath, node.lineno,
                node.col_offset + 1,
                f"`{chain}()` seeds from the OS — pass an explicit "
                f"seed (or a SeedSequence-derived bit generator)"))
    return out


def _time_calls(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and (chain in _TIME_SOURCES or
                          chain.rpartition(".")[2] in ("urandom", "uuid4")):
                yield sub, chain


@rule("rng-time-seed", "seed derived from wall-clock / OS entropy")
def check_time_seed(module: ModuleInfo):
    out = []
    for node in ast.walk(module.tree):
        hits = []
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func) or ""
            is_ctor = chain.rpartition(".")[2] in _RNG_CONSTRUCTORS
            for arg in list(node.args) + [k.value for k in node.keywords]:
                for _, src in _time_calls(arg):
                    kw_seed = any(k.arg and "seed" in k.arg.lower()
                                  and any(_time_calls(k.value))
                                  for k in node.keywords)
                    if is_ctor or kw_seed:
                        hits.append(src)
        elif isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if any("seed" in t.lower() for t in targets):
                hits.extend(src for _, src in _time_calls(node.value))
        for src in hits:
            out.append(Violation(
                "rng-time-seed", module.relpath, node.lineno,
                node.col_offset + 1,
                f"seed derived from `{src}` — wall-clock/OS entropy "
                f"seeds are unreproducible; thread an explicit seed"))
    return out
