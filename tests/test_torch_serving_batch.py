"""Request-batched generation, on the CPU: the serving engine maps
`generate` over a prompt-shape group with one `torch.func.vmap`, as the
reference's `jax.jit(jax.vmap(gen_one))` does, and K7, K8 and K9 fold
the request axis into their batch axis (`kernels/_vmap.py`).

- The fold on the three kernels' plain versions equals the stacked
  per-request calls bit for bit: batched and unbatched operands, vmap
  dims not at 0, int and tensor kv_length, GQA, causal, window and
  q_offset, a two-chunk SSD.
- The kernels' Functions under `torch.func.vmap` (their launch routed
  to the plain version, as on the card it would launch the kernel):
  one launch for the whole group, the same bits as the stacked calls.
- `moe_route` under vmap equals each row's own routing bit for bit,
  with the rank-0 clobber (every entry on the same experts) and
  `w_router = 0` ties.
- The vmapped `generate` of the five reduced families equals the
  per-request loop (tokens equal, first-step logits at rtol 1e-5 in
  f32), launches each kernel once a layer (and step) for the group with
  no merge copying, writes the decode caches in place and keeps the
  cache's length a Python int; and, for mamba2, mixtral, jamba and
  deepseek-v2, equals the reference engine's `_generate_fn(n)(rows,
  prompts)` from the same weights (tokens equal; SmolLM's engine is
  held against the reference's in `test_torch_serving.py`).
- The kernel packages export every name the reference's do."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.serve import build_engine as jax_build_engine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import _vmap
from repro_torch.kernels.attention import flash_attention as k7
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.decode_attention import flash_decode as k8
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd_scan as k9
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
from repro_torch.launch.serve import build_engine
from repro_torch.models.lm import layer_groups
from repro_torch.models.moe import moe_route
from repro_torch.utils.pytree import tree_leaves

ARCHS = ("smollm-360m", "mamba2-370m", "mixtral-8x22b", "jamba-v0.1-52b",
         "deepseek-v2-236b")
R, PROMPT, NEW = 3, 16, 5
LOGITS = dict(rtol=1e-5, atol=1e-6)
# cache entries are O(1) projections of the mapped activations; a batched
# matmul sums them in another order than the per-request one (up to
# about 2e-6 seen here)
CACHE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _at(t, dim):
    """A stacked (R, …) tensor with its request axis moved to ``dim``,
    as `torch.func.vmap` may hand it to a rule."""
    return t if dim is None else t.movedim(0, dim)


def _per_request(t, dim, r):
    return t if dim is None else t[r]


# ---- the fold on the plain versions -------------------------------------

K7_CASES = [dict(causal=True, window=None, q_offset=0),
            dict(causal=True, window=5, q_offset=0),
            dict(causal=False, window=None, q_offset=0),
            dict(causal=True, window=4, q_offset=3)]


@pytest.mark.parametrize("dims", [(0, 0, 0), (1, None, 2), (None, 3, 1)],
                         ids=["at0", "mixed", "q_unbatched"])
@pytest.mark.parametrize("case", K7_CASES,
                         ids=["causal", "window", "full", "offset"])
def test_fold_k7_plain_equals_stacked(dims, case):
    rng = np.random.RandomState(0)
    B, H, Kv, Lq, Lk, hd = 2, 4, 2, 5, 8, 8
    q = _t(rng, R, B, H, Lq, hd)
    k = _t(rng, R, B, Kv, Lk, hd)
    v = _t(rng, R, B, Kv, Lk, hd)
    if dims[0] is None:
        q = q[0]
    if dims[1] is None:
        k = k[0]
    args = [_at(t, d) if d is not None else t for t, d in zip((q, k, v), dims)]

    def plain(q_, k_, v_):
        return k7._plain_bhld(q_, k_, v_, case["causal"], case["window"],
                              case["q_offset"])

    got = _vmap.fold(plain, R, args, dims)
    want = torch.stack([plain(*(_per_request(t, None if d is None else 0, r)
                                for t, d in zip((q, k, v), dims)))
                        for r in range(R)])
    assert got.shape == (R, B, H, Lq, hd)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kvl", ["int", "unbatched", "batched"])
def test_fold_k8_plain_equals_stacked(kvl):
    rng = np.random.RandomState(1)
    B, H, Kv, C, hd = 2, 6, 2, 9, 16
    q = _t(rng, R, B, H, hd)
    kc = _t(rng, R, B, C, Kv, hd)
    vc = _t(rng, B, C, Kv, hd)                       # one cache for all
    lens = {"int": 7,
            "unbatched": torch.tensor([4, 9], dtype=torch.int32),
            "batched": torch.tensor([[1, 9], [5, 3], [9, 2]],
                                    dtype=torch.int32)}[kvl]
    ldim = 1 if kvl == "batched" else None
    largs = lens.T if kvl == "batched" else lens     # request axis at 1
    dims = (2, 0, None, ldim)
    got = _vmap.fold(decode_attention_ref, R,
                     (q.movedim(0, 2), kc, vc, largs), dims)
    want = torch.stack([decode_attention_ref(
        q[r], kc[r], vc, lens[r] if kvl == "batched" else lens)
        for r in range(R)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dims", [(0, 0, 0, 0), (2, 1, None, 1)],
                         ids=["at0", "mixed"])
def test_fold_k9_plain_two_chunks_equals_stacked(dims):
    rng = np.random.RandomState(2)
    B, nh, L, hp, N, Q = 2, 3, 16, 4, 5, 8
    xdt = _t(rng, R, B, nh, L, hp)
    a = -0.1 * torch.abs(_t(rng, R, B, nh, L))
    Bm = _t(rng, R, B, L, N)
    Cm = _t(rng, R, B, L, N)
    if dims[2] is None:
        Bm = Bm[0]
    ops_ = (xdt, a, Bm, Cm)
    args = [_at(t, d) for t, d in zip(ops_, dims)]

    def plain(*t):
        return ssd_intra_chunk_plain(*t, chunk=Q)

    y, S = _vmap.fold(plain, R, args, dims)
    want = [plain(*(t if d is None else t[r] for t, d in zip(ops_, dims)))
            for r in range(R)]
    assert S.shape == (R, B, nh, L // Q, N, hp)
    assert torch.equal(y, torch.stack([w[0] for w in want]))
    assert torch.equal(S, torch.stack([w[1] for w in want]))


def test_fold_counts_copied_bytes_only():
    rng = np.random.RandomState(3)
    x = _t(rng, R, 2, 4)
    before = _vmap.copy_bytes
    m = _vmap.merge(x, 0, R)                         # a view
    assert m.data_ptr() == x.data_ptr() and _vmap.copy_bytes == before
    _vmap.merge(x[0], None, R)                       # expanded: a copy
    assert _vmap.copy_bytes == before + R * 2 * 4 * 4
    s = _vmap.split(m, R)
    assert s.shape == x.shape and s.data_ptr() == x.data_ptr()


# ---- the Functions under torch.func.vmap ---------------------------------

@pytest.fixture
def launches(monkeypatch):
    """K7, K8 and K9 launches routed to their plain versions and counted;
    the dispatchers call the Functions on CPU tensors too, as they do on
    the card."""
    n = {"k7": 0, "k8": 0, "k9": 0}

    def k7_launch(*a):
        n["k7"] += 1
        return k7._plain_bhld(*a)

    def k8_launch(q, kc, vc, kvl):
        assert isinstance(kvl, (int, torch.Tensor))
        n["k8"] += 1
        return decode_attention_ref(q, kc, vc, kvl)

    def k9_launch(xdt, a, Bm, Cm, chunk):
        n["k9"] += 1
        return ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk)

    monkeypatch.setattr(k7, "_launch", k7_launch)
    monkeypatch.setattr(k8, "_launch", k8_launch)
    monkeypatch.setattr(k9, "_launch", k9_launch)
    monkeypatch.setattr(
        attn_ops, "flash_attention_bhld",
        lambda q, k, v, *, causal=True, window=None, q_offset=0:
        k7._FlashAttention.apply(q, k, v, causal, window, q_offset))
    monkeypatch.setattr(dec_ops, "flash_decode", k8._FlashDecode.apply)
    monkeypatch.setattr(
        ssd_ops, "ssd_intra_chunk",
        lambda xdt, a, Bm, Cm, *, chunk:
        k9._SsdIntraChunk.apply(xdt, a, Bm, Cm, chunk))
    return n


def test_functions_launch_once_under_vmap(launches):
    rng = np.random.RandomState(4)
    q, k, v = (_t(rng, R, 2, 4, 6, 8), _t(rng, R, 2, 2, 6, 8),
               _t(rng, R, 2, 2, 6, 8))
    got = torch.func.vmap(lambda *t: k7._FlashAttention.apply(
        *t, True, 3, 0), in_dims=(0, 0, 0))(q, k, v)
    assert launches["k7"] == 1
    assert torch.equal(got, torch.stack([k7._plain_bhld(
        q[r], k[r], v[r], True, 3, 0) for r in range(R)]))

    qd, kc = _t(rng, R, 2, 4, 8), _t(rng, R, 2, 7, 2, 8)
    for kvl in (5, torch.tensor([3, 7], dtype=torch.int32)):
        got = torch.func.vmap(k8._FlashDecode.apply,
                              in_dims=(0, 0, 0, None))(qd, kc, kc, kvl)
        assert torch.equal(got, torch.stack([decode_attention_ref(
            qd[r], kc[r], kc[r], kvl) for r in range(R)]))
    assert launches["k8"] == 2

    x, a = _t(rng, R, 2, 3, 16, 4), -torch.abs(_t(rng, R, 2, 3, 16))
    Bm, Cm = _t(rng, R, 2, 16, 5), _t(rng, R, 2, 16, 5)
    y, S = torch.func.vmap(lambda *t: k9._SsdIntraChunk.apply(*t, 8))(
        x, a, Bm, Cm)
    assert launches["k9"] == 1
    for r in range(R):
        yr, Sr = ssd_intra_chunk_plain(x[r], a[r], Bm[r], Cm[r], chunk=8)
        assert torch.equal(y[r], yr) and torch.equal(S[r], Sr)


def test_k7_function_under_vmap_keeps_the_output_layout(launches):
    """The split output is a view over (R, B, Lq, H, hd_v) storage, so
    the dispatcher's transpose back gives the models a contiguous
    (B, Lq, H, hd_v) activation per request, as without vmap."""
    rng = np.random.RandomState(5)
    q, k = _t(rng, R, 2, 6, 4, 8), _t(rng, R, 2, 6, 2, 8)

    def f(q_, k_):
        o = attn_ops.flash_attention(q_, k_, k_, causal=True)
        return o
    out = torch.func.vmap(f)(q, k)
    assert out.shape == (R, 2, 6, 4, 8) and out.is_contiguous()
    for r in range(R):
        assert torch.equal(out[r], attn_ops.flash_attention(
            q[r], k[r], k[r], causal=True, impl="torch"))


# ---- moe_route under vmap -------------------------------------------------

def _route_fields(route):
    return {k: v for k, v in route.items() if k != "capacity"}


@pytest.mark.parametrize("router", ["random", "all_overflow", "zero_ties"])
def test_moe_route_under_vmap_is_bitwise_per_row(router):
    cfg = reduced_config(get_config("mixtral-8x22b"))
    E, T, d = cfg.num_experts, 12, cfg.d_model
    rng = np.random.RandomState(6)
    x = _t(rng, R, T, d)
    w = 0.1 * _t(rng, R, d, E)
    if router == "all_overflow":
        # every token on the same two experts: both overflow, and the
        # rank-0 clobber empties their first slot
        w = torch.zeros((R, d, E))
        w[:, :, 1], w[:, :, 3] = 2.0, 1.0
        x = torch.abs(x)
    elif router == "zero_ties":
        w = torch.zeros((R, d, E))
    cf = 0.5

    def route(w_, x_):
        return _route_fields(moe_route({"w_router": w_}, cfg, x_, cf))

    got = torch.func.vmap(route)(w, x)
    for r in range(R):
        want = route(w[r], x[r])
        for key, val in want.items():
            assert torch.equal(got[key][r], val), (router, key)
    cap = moe_route({"w_router": w[0]}, cfg, x[0], cf)["capacity"]
    if router != "random":
        assert bool((got["counts"] > cap).any())
        clobbered = got["slot_src"].view(R, E, cap)[:, :, 0]
        over = got["counts"] > cap
        assert bool((clobbered[over] == T * cfg.num_experts_per_tok).all())


# ---- the vmapped generate ---------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced config per arch: the reference's engine (φ from seed
    0) and the port's engine on the same φ, R rows (φ plus seeded noise,
    so every request has its own θ_u) and R prompts of PROMPT tokens."""
    arch = request.param
    jcfg = jax_reduced_config(jax_get_config(arch))
    tcfg = reduced_config(get_config(arch))
    jengine = jax_build_engine(jcfg, adapt_batch=1, seed=0)
    theta = jax.tree.map(np.asarray, jengine._phi["theta"])
    engine = build_engine(tcfg, {"theta": from_numpy_tree(theta, "cpu")},
                          adapt_batch=1, device="cpu")
    rng = np.random.RandomState(7)
    row0 = np.asarray(jengine.plane.pack(jengine._phi["theta"]))
    rows = np.stack([row0 + rng.normal(0, 0.02, row0.shape).astype(
        np.float32) * (row0 != 0) for _ in range(R)])
    prompts = rng.randint(0, tcfg.vocab_size, (R, PROMPT)).astype(np.int32)
    return arch, tcfg, jengine, engine, rows, prompts


def _trows(rows):
    return [torch.from_numpy(r.copy()) for r in rows]


def test_unpack_rows_equals_stacked_unpack(served):
    _, _, _, engine, rows, _ = served
    got = tree_leaves(engine.plane.unpack_rows(_trows(rows)))
    each = [tree_leaves(engine.plane.unpack(r)) for r in _trows(rows)]
    for i, leaf in enumerate(got):
        assert leaf.dtype == each[0][i].dtype
        assert torch.equal(leaf, torch.stack([e[i] for e in each]))


def test_vmapped_generate_equals_loop(served):
    _, _, _, engine, rows, prompts = served
    trows, tp = _trows(rows), torch.from_numpy(prompts)
    got = engine.generate_batch(trows, tp, NEW)
    loop = torch.stack([engine.generate(r, p, NEW)
                        for r, p in zip(trows, tp)])
    assert got.dtype == torch.int32 and got.shape == (R, NEW)
    assert torch.equal(got, loop)
    # first-step logits: the vmapped prefill against each request's own
    with torch.no_grad():
        lg = torch.func.vmap(
            lambda p, x: engine._prefill_fn(p, x[None])[0])(
            engine.plane.unpack_rows(trows), tp)
        for r in range(R):
            want, _ = engine._prefill_fn(engine.plane.unpack(trows[r]),
                                         tp[r][None])
            np.testing.assert_allclose(lg[r].numpy(), want.numpy(),
                                       **LOGITS)


@pytest.mark.parametrize("served", ARCHS[1:], indirect=True)
def test_vmapped_generate_matches_reference_engine(served):
    _, _, jengine, engine, rows, prompts = served
    want = np.asarray(jengine._generate_fn(NEW)(jnp.asarray(rows),
                                                jnp.asarray(prompts)))
    got = engine.generate_batch(_trows(rows), torch.from_numpy(prompts),
                                NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def _attn_layers(cfg):
    lead, period, n_reps = layer_groups(cfg)
    return (sum(s[0] == "attn" for s in lead)
            + n_reps * sum(s[0] == "attn" for s in period))


def _mamba_layers(cfg):
    lead, period, n_reps = layer_groups(cfg)
    return (sum(s[0] == "mamba" for s in lead)
            + n_reps * sum(s[0] == "mamba" for s in period))


def test_vmapped_generate_launches_once_per_group(served, launches):
    """Through the Functions, one group of R requests launches K7 once
    an attention layer (prefill), K8 once an attention layer and decode
    step, K9 once a Mamba layer (prefill), and no merge copies: every
    operand's request axis is outermost in memory. deepseek's absorbed
    MLA decode has no kernel, so its K8 count is 0; its prefill runs K7
    in both MLA layers."""
    arch, cfg, _, engine, rows, prompts = served
    trows, tp = _trows(rows), torch.from_numpy(prompts)
    before = _vmap.copy_bytes
    got = engine.generate_batch(trows, tp, NEW)
    assert _vmap.copy_bytes == before
    attn = _attn_layers(cfg)
    decode = 0 if cfg.attention == "mla" else attn * (NEW - 1)
    assert launches == {"k7": attn, "k8": decode, "k9": _mamba_layers(cfg)}
    loop = torch.stack([engine.generate(r, p, NEW)
                        for r, p in zip(trows, tp)])
    assert torch.equal(got, loop)


@pytest.mark.parametrize("served", ARCHS[:3], indirect=True)
def test_group_of_one_runs_unmapped(served, launches, monkeypatch):
    """A group of one request is `generate` itself, with no map: the
    same tokens, shape (1, NEW), and the kernels launched as for one
    request."""
    arch, cfg, _, engine, rows, prompts = served
    trows, tp = _trows(rows), torch.from_numpy(prompts)

    def no_vmap(*a, **k):
        raise AssertionError("a group of one was mapped")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    got = engine.generate_batch(trows[:1], tp[:1], NEW)
    attn = _attn_layers(cfg)
    assert launches == {"k7": attn, "k8": attn * (NEW - 1),
                        "k9": _mamba_layers(cfg)}
    assert got.dtype == torch.int32 and got.shape == (1, NEW)
    assert torch.equal(got[0], engine.generate(trows[0], tp[0], NEW))


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b",
                                  "mamba2-370m"], ids=["gqa", "mla", "mamba"])
def test_decode_writes_the_vmapped_cache_in_place(arch):
    """The prefill under vmap builds batched cache tensors, and a decode
    step writes its slot (GQA, MLA) or its conv window and state (Mamba)
    into them in place: the tensor the prefill returned is the one the
    step updated, and it holds what each request's own prefill and step
    write (`CACHE`: the mapped projections are batched matmuls, which
    may round differently from the per-request ones). The cache's length
    stays a Python int."""
    cfg = reduced_config(get_config(arch))
    engine = build_engine(cfg, device="cpu")
    row = engine.plane.pack(engine._phi["theta"])
    rng = np.random.RandomState(8)
    trows = [row + torch.from_numpy(rng.normal(0, 0.02, row.shape).astype(
        np.float32)) for _ in range(R)]
    tp = torch.from_numpy(rng.randint(0, cfg.vocab_size, (R, PROMPT))
                          .astype(np.int32))
    lengths = []

    def step(params, prompt):
        logits, cache = engine._prefill_fn(params, prompt[None])
        first = tree_leaves(cache["stack"])
        tok = torch.argmax(logits, -1).to(torch.int32)
        _, new = engine._decode_fn(params, cache, tok[:, None])
        lengths.extend([cache["length"], new["length"]])
        return first, tree_leaves(new["stack"])

    with torch.no_grad():
        before, after = torch.func.vmap(step)(engine.plane.unpack_rows(trows),
                                              tp)
        for b, a in zip(before, after):
            assert b.data_ptr() == a.data_ptr() and torch.equal(b, a)
        for r in range(R):
            want_before, want_after = step(engine.plane.unpack(trows[r]),
                                           tp[r])
            for b, a in zip(after, want_after):
                np.testing.assert_allclose(b[r].numpy(), a.numpy(),
                                           **CACHE)
    assert lengths[:2] == [PROMPT, PROMPT + 1]
    assert all(type(n) is int for n in lengths)


# ---- kernel API parity -----------------------------------------------------

REF_KERNELS = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro" / "kernels"


def _exported(pkg):
    tree = ast.parse((REF_KERNELS / pkg / "__init__.py").read_text())
    return sorted(a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("pkg", ["attention", "decode_attention",
                                 "meta_update", "ssd"])
def test_kernel_packages_export_the_references_names(pkg):
    """Every name a reference kernel package exports exists in the
    port's package, and is its `ops` function. The one exception is the
    attention package's ``flash_attention``, which stays bound to the
    K7 module (the port reads ``k7.launches`` through that name); its
    dispatcher is `ops.flash_attention`."""
    import importlib
    port = importlib.import_module(f"repro_torch.kernels.{pkg}")
    ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    names = _exported(pkg)
    assert names
    for name in names:
        assert hasattr(port, name), (pkg, name)
        if (pkg, name) == ("attention", "flash_attention"):
            assert getattr(port, name) is k7 and callable(ops.flash_attention)
            continue
        assert getattr(port, name) is getattr(ops, name), (pkg, name)


@pytest.mark.parametrize("pkg", ["attention", "decode_attention",
                                 "meta_update", "ssd"])
def test_set_default_impl(pkg):
    """The reference's setter and getter and the port's scoped
    `use_impl` act on one default (`kernels._impl.ImplSwitch`)."""
    import importlib
    ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
    prev = ops.get_default_impl()
    try:
        ops.set_default_impl("torch")
        assert ops.get_default_impl() == "torch"
        with ops.use_impl("cuda"):
            assert ops.get_default_impl() == "cuda"
        assert ops.get_default_impl() == "torch"
        with pytest.raises(AssertionError):
            ops.set_default_impl("pallas")
    finally:
        ops.set_default_impl(prev)
    assert ops.get_default_impl() == prev
