"""Layer remat and second-order gradients through the kernels'
autograd Functions, on the CPU.

- `lm_apply(remat=True)` checkpoints each layer-period repetition: its
  logits, gradient and MAML meta-gradient must equal `remat=False`'s
  bit for bit (the recomputed forward runs the same operations).
- K7's and K9's Functions (`_FlashAttention`, `_SsdIntraChunk`) run a
  kernel forward and a backward by recomputation through the plain
  version. On the CPU the wrappers never reach them, so here the
  kernel launch is routed to the plain version (monkeypatch) and the
  Function is called as the card would call it. A Hessian-vector
  product through it must then equal the plain path's bit for bit, and
  MAML's and Meta-SGD's meta-gradients through the LM must equal the
  plain path's within 1e-6 of their largest entry (the autograd engine
  accumulates the Function's input gradients in another order: the gap
  is about 4e-8). A backward that returned constants would drop the
  second-order terms, which are 7–14 % of the largest entry here.
- K1's Function (`_InnerUpdatePlane`) and `_UnpackAD` carry MAML's
  support gradient on every device; the tree meta-update through them
  ("cuda", which runs them on CPU tensors) must give the meta-gradient
  of the plain tree update ("torch")."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import lm_loss, softmax_xent
from repro_torch.kernels.attention import flash_attention as k7
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.meta_update import ops as mu_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd_scan as k9
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_plain
from repro_torch.launch.steps import make_apply_fn
from repro_torch.models import init_lm, lm_apply
from repro_torch.utils.pytree import tree_flatten, tree_leaves, tree_unflatten

ARCHS = ("smollm-360m", "mamba2-370m")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(arch, L=16):
    cfg = reduced_config(get_config(arch))
    params = init_lm(0, cfg, device="cpu")
    rng = np.random.RandomState(0)
    sup, qry = (torch.as_tensor(rng.randint(0, cfg.vocab_size, (2, L)),
                                dtype=torch.int32) for _ in range(2))
    return cfg, params, sup, qry


def _meta_grad(cfg, params, sup, qry, algo="maml", remat=True):
    a = make_algorithm(algo, *lm_loss(make_apply_fn(cfg, remat=remat)), 0.05)
    phi = ({"theta": params} if algo == "maml"
           else a.init_state(0, lambda k: params))
    g, met = a.client_grad(phi, sup, qry)
    return tree_leaves(g), float(met["query_loss"])


def _rel_gap(xs, ys):
    """max |x − y| over max |y|, across the leaves."""
    return (max(float((x - y).abs().max()) for x, y in zip(xs, ys))
            / max(float(y.abs().max()) for y in ys))


def _equal(xs, ys):
    return len(xs) == len(ys) and all(torch.equal(x, y)
                                      for x, y in zip(xs, ys))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_equal_to_no_remat(arch):
    cfg, params, sup, _ = _setup(arch)
    leaves, treedef = tree_flatten(params)
    outs = []
    for remat in (True, False):
        req = [p.detach().requires_grad_(True) for p in leaves]
        logits, _ = lm_apply(tree_unflatten(treedef, req), cfg, sup,
                             remat=remat)
        loss = softmax_xent(logits[:, :-1], sup[:, 1:])
        outs.append((logits.detach(), torch.autograd.grad(loss, req)))
    (l1, g1), (l0, g0) = outs
    assert torch.equal(l1, l0) and _equal(g1, g0)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_maml_meta_gradient_is_bitwise_equal(arch):
    cfg, params, sup, qry = _setup(arch)
    g1, l1 = _meta_grad(cfg, params, sup, qry, remat=True)
    g0, l0 = _meta_grad(cfg, params, sup, qry, remat=False)
    assert l1 == l0 and _equal(g1, g0)


def test_remat_checkpoints_each_repetition():
    """Under remat the forward saves for the backward only what each
    checkpoint keeps, less than half of what the plain forward saves."""
    cfg, params, sup, _ = _setup("smollm-360m", L=32)
    leaves, treedef = tree_flatten(params)
    saved = {}
    for remat in (False, True):
        req = tree_unflatten(treedef, [p.detach().requires_grad_(True)
                                       for p in leaves])
        sizes = []

        def pack(t):
            sizes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lm_apply(req, cfg, sup, remat=remat)
        saved[remat] = sum(sizes)
    assert saved[True] < saved[False] / 2, saved


# ---------------------------------------------------- second order, K7 / K9

def _k7_via_function(monkeypatch):
    """Route the LM's attention through `_FlashAttention` on the CPU,
    its 'kernel' launch the plain version."""
    monkeypatch.setattr(k7, "_launch", k7._plain_bhld)

    def bhld(q, k, v, *, causal=True, window=None, q_offset=0):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return k7._FlashAttention.apply(q, k, v, causal, window,
                                            q_offset)
        return k7._launch(q, k, v, causal, window, q_offset)

    monkeypatch.setattr(attn_ops, "flash_attention_bhld", bhld)


def _k9_via_function(monkeypatch):
    monkeypatch.setattr(k9, "_launch", lambda xdt, a, Bm, Cm, chunk:
                        ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk))

    def intra(xdt, a, Bm, Cm, *, chunk):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (xdt, a, Bm, Cm)):
            return k9._SsdIntraChunk.apply(xdt, a, Bm, Cm, chunk)
        return k9._launch(xdt, a, Bm, Cm, chunk)

    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk", intra)


def _hvp(fn, ins, w, u):
    """(∇⟨fn(ins), w⟩, ∇⟨∇⟨fn(ins), w⟩, u⟩), both w.r.t. ins."""
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    g = torch.autograd.grad(sum((o * wi).sum() for o, wi in zip(outs, w)),
                            ins, create_graph=True)
    h = torch.autograd.grad(sum((gi * ui).sum() for gi, ui in zip(g, u)),
                            ins)
    return [x.detach() for x in g], list(h)


def test_flash_attention_function_is_twice_differentiable(monkeypatch):
    monkeypatch.setattr(k7, "_launch", k7._plain_bhld)
    gen = torch.Generator().manual_seed(0)
    B, H, Kv, L, hd = 2, 4, 2, 12, 16
    ins = [torch.randn((B, h, L, hd), dtype=torch.float64, generator=gen
                       ).requires_grad_(True) for h in (H, Kv, Kv)]
    w = [torch.randn((B, H, L, hd), dtype=torch.float64, generator=gen)]
    u = [torch.randn(t.shape, dtype=torch.float64, generator=gen)
         for t in ins]
    for causal, window, qoff in ((True, None, 0), (True, 5, 0),
                                 (False, None, 0)):
        args = (causal, window, qoff)
        g_k, h_k = _hvp(lambda q, k, v: k7._FlashAttention.apply(
            q, k, v, *args), ins, w, u)
        g_p, h_p = _hvp(lambda q, k, v: k7._plain_bhld(q, k, v, *args),
                        ins, w, u)
        assert _equal(g_k, g_p) and _equal(h_k, h_p), args
        assert all(float(h.abs().max()) > 0 for h in h_k)


def test_ssd_intra_chunk_function_is_twice_differentiable(monkeypatch):
    monkeypatch.setattr(k9, "_launch", lambda xdt, a, Bm, Cm, chunk:
                        ssd_intra_chunk_plain(xdt, a, Bm, Cm, chunk=chunk))
    gen = torch.Generator().manual_seed(1)
    B, nh, L, hp, N, Q = 2, 3, 16, 8, 4, 8
    xdt = torch.randn((B, nh, L, hp), generator=gen)
    a = -torch.rand((B, nh, L), generator=gen) * 0.3
    Bm, Cm = (torch.randn((B, L, N), generator=gen) for _ in range(2))
    ins = [t.double().requires_grad_(True) for t in (xdt, a, Bm, Cm)]
    w = [torch.randn((B, nh, L, hp), dtype=torch.float64, generator=gen),
         torch.randn((B, nh, L // Q, N, hp), dtype=torch.float64,
                     generator=gen)]
    u = [torch.randn(t.shape, dtype=torch.float64, generator=gen)
         for t in ins]
    g_k, h_k = _hvp(lambda *t: k9._SsdIntraChunk.apply(*t, Q), ins, w, u)
    g_p, h_p = _hvp(lambda *t: ssd_intra_chunk_plain(*t, chunk=Q), ins, w, u)
    assert _equal(g_k, g_p) and _equal(h_k, h_p)
    assert all(float(h.abs().max()) > 0 for h in h_k)


@pytest.mark.parametrize("algo", ["maml", "meta-sgd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_gradient_through_the_kernel_function_equals_plain(
        monkeypatch, arch, algo):
    cfg, params, sup, qry = _setup(arch)
    g_plain, l_plain = _meta_grad(cfg, params, sup, qry, algo)
    route = {"smollm-360m": _k7_via_function,
             "mamba2-370m": _k9_via_function}[arch]
    route(monkeypatch)
    before = (k7.launches, k9.launches)
    g_fn, l_fn = _meta_grad(cfg, params, sup, qry, algo)
    assert (k7.launches, k9.launches) == before   # the plain 'kernel'
    assert l_fn == l_plain
    assert _rel_gap(g_fn, g_plain) <= 1e-6
    if algo == "maml":      # the second-order term is several % of it
        g_fo, _ = _meta_grad(cfg, params, sup, qry, "fomaml")
        assert _rel_gap(g_fo, g_plain) > 1e-2


def test_inner_update_function_carries_the_second_order_term():
    """MAML's support gradient through K1's Function and `_UnpackAD`
    ("cuda" on CPU tensors) against the plain tree update ("torch")."""
    cfg, params, sup, qry = _setup("smollm-360m")
    g_fn, l_fn = _meta_grad(cfg, params, sup, qry)
    with mu_ops.use_impl("torch"):
        g_plain, l_plain = _meta_grad(cfg, params, sup, qry)
    np.testing.assert_allclose(l_fn, l_plain, rtol=1e-6)
    for a, b in zip(g_fn, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    # the second-order term is there: FOMAML's gradient differs
    g_fo, _ = _meta_grad(cfg, params, sup, qry, "fomaml")
    assert not _equal(g_fo, g_fn)
