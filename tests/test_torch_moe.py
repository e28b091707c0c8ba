"""Port parity: the MoE FFN (`models/moe.py`) against the JAX package's.

The reference's parameters are carried over by `convert`; inputs come
from seeded numpy streams. Both sides run in float32.

Tolerance: y at rtol 1e-5 / atol 1e-5 (two 256-wide matmuls and a
512-wide one per expert, summed in other orders by XLA and PyTorch),
the aux loss at rtol 1e-6 (one softmax and a mean), gradients at rtol
1e-4 / atol 1e-5 (`test_torch_lm.py`'s network tolerance). Routing is
exact: the same f32 logits pick the same experts on both sides, so the
dropped entries and the rank-0 clobber (`moe.py`'s docstring) must
agree entry for entry; a clobber left out moves y by O(1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import moe as jax_moe
from repro.models.layers import Rng as JaxRng
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models import moe
from repro_torch.models.layers import Rng

Y = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **changes):
    j = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                            **changes)
    t = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    return j, t


def _params(jcfg, seed=0):
    jp = _np(jax_moe.moe_init(JaxRng(jax.random.PRNGKey(seed)), jcfg,
                              jnp.float32))
    return jp, from_numpy_tree(jp, "cpu")


def _x(jcfg, B=2, L=16, seed=1, skew=0.0, jp=None):
    """Tokens (B, L, d); `skew` adds that many router-column norms along
    expert 0's router column, so expert 0 overflows first."""
    x = np.random.RandomState(seed).randn(B, L, jcfg.d_model)
    if skew:
        w = jp["w_router"][:, 0]
        x = x + skew * w / np.sum(w * w)
    return x.astype(np.float32)


def _both(jcfg, tcfg, jp, tp, x, cf):
    jy, ja = jax.jit(lambda p, x: jax_moe.moe_apply(
        p, jcfg, x, capacity_factor=cf))(jp, jnp.asarray(x))
    with torch.no_grad():
        ty, ta = moe.moe_apply(tp, tcfg, torch.from_numpy(x),
                               capacity_factor=cf)
    return (np.asarray(jy), float(ja)), (ty.numpy(), float(ta))


def _route(tcfg, tp, x, cf):
    with torch.no_grad():
        return moe.moe_route(tp, tcfg, torch.from_numpy(x).reshape(
            -1, tcfg.d_model), cf)


CF_CASES = {   # capacity factor, skew, what the routing must show
    "default_drops": (1.25, 4.0, "some"),     # cfg.capacity_factor
    "all_overflow": (0.5, 0.0, "all"),        # every expert overflows
    "no_drops": (None, 0.0, "none"),          # E / K
}


@pytest.mark.parametrize("case", sorted(CF_CASES))
def test_moe_apply_matches_reference(case, monkeypatch):
    cf, skew, drops = CF_CASES[case]
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    E, K = tcfg.num_experts, tcfg.num_experts_per_tok
    cf = cf if cf is not None else E / K
    jp, tp = _params(jcfg)
    x = _x(jcfg, skew=skew, jp=jp)
    (jy, ja), (ty, ta) = _both(jcfg, tcfg, jp, tp, x, cf)
    np.testing.assert_allclose(ty, jy, **Y)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    r = _route(tcfg, tp, x, cf)
    over = (r["counts"] > r["capacity"]).numpy()
    dropped = moe.dropped_entries(r)
    assert dropped == int(np.maximum(r["counts"].numpy() - r["capacity"],
                                     0).sum())
    assert {"some": 0 < over.sum() < E, "all": over.all(),
            "none": dropped == 0}[drops], (r["counts"], r["capacity"])
    if drops != "none":
        # without the rank-0 clobber the port would miss the reference
        # by O(1): the clobbered tokens keep their experts' outputs
        r2 = dict(r, slot_src=r["slot_src"].clone())
        T = x.shape[0] * x.shape[1]
        sorted_e, order = torch.sort(r["expert_ids"].reshape(-1), stable=True)
        start = torch.cumsum(r["counts"], 0) - r["counts"]
        for e in np.nonzero(over)[0]:
            r2["slot_src"][e * r["capacity"]] = order[start[e]]
        monkeypatch.setattr(moe, "moe_route", lambda *a: r2)
        with torch.no_grad():
            ty2, _ = moe.moe_apply(tp, tcfg, torch.from_numpy(x),
                                   capacity_factor=cf)
        assert float(np.abs(ty2.numpy() - jy).max()) > 1e-2
        assert int((r["slot_src"] == T * K).sum()) >= over.sum()


def test_exact_router_ties_go_to_the_lower_experts():
    """w_router = 0: every logit ties, so every token picks experts 0..K-1
    with equal gates (`lax.top_k`'s order), expert 0 and 1 overflow and
    the others stay empty."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    K = tcfg.num_experts_per_tok
    jp, _ = _params(jcfg)
    jp = dict(jp, w_router=np.zeros_like(jp["w_router"]))
    tp = from_numpy_tree(jp, "cpu")
    x = _x(jcfg)
    (jy, ja), (ty, ta) = _both(jcfg, tcfg, jp, tp, x, 1.25)
    np.testing.assert_allclose(ty, jy, **Y)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    r = _route(tcfg, tp, x, 1.25)
    T = x.shape[0] * x.shape[1]
    assert torch.equal(r["expert_ids"], torch.arange(K).expand(T, K))
    assert torch.equal(r["gates"], torch.full((T, K), 1.0 / K))
    assert r["counts"].tolist() == [T] * K + [0] * (tcfg.num_experts - K)


def test_top_k_breaks_ties_like_lax_top_k():
    rng = np.random.RandomState(3)
    logits = rng.randint(0, 3, (64, 9)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 4)
    tv, ti = moe.top_k_lower_ties(torch.from_numpy(logits), 4)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("T,K,E,cf", [(16, 2, 4, 1.25), (128, 2, 8, 1.25),
                                      (4096, 6, 160, 1.25), (7, 6, 160, 0.5),
                                      (4608, 2, 8, 4.0), (33, 2, 16, 1.1),
                                      (1, 2, 8, 1.25)])
def test_capacity_is_the_references(T, K, E, cf):
    assert moe.capacity_of(T, K, E, cf) == int(np.ceil(T * K / E * cf))


@pytest.mark.parametrize("arch,act", [("deepseek-v2-236b", "swiglu"),
                                      ("mixtral-8x22b", "relu2"),
                                      ("mixtral-8x22b", "gelu")])
def test_shared_and_activation_variants_match_reference(arch, act):
    """deepseek's shared experts (reduced: one of width d_ff), and the
    relu2 and gelu experts (no gate leaf), at cfg.capacity_factor."""
    jcfg, tcfg = _cfgs(arch, mlp_act=act)
    jp, tp = _params(jcfg, seed=2)
    ref_keys = sorted(_np(jax_moe.moe_init(
        JaxRng(jax.random.PRNGKey(2)), jcfg, jnp.float32)))
    ours = moe.moe_init(Rng(2, "cpu"), tcfg, torch.float32)
    assert sorted(ours) == ref_keys
    for k in jp:
        got = ours[k]
        if isinstance(got, dict):
            assert {a: tuple(b.shape) for a, b in got.items()} == \
                {a: b.shape for a, b in jp[k].items()}
        else:
            assert tuple(got.shape) == jp[k].shape
    assert ("shared" in jp) == (tcfg.num_shared_experts > 0)
    assert ("w_gate" in jp) == (act == "swiglu")
    x = _x(jcfg, skew=4.0, jp=jp)
    (jy, ja), (ty, ta) = _both(jcfg, tcfg, jp, tp, x, tcfg.capacity_factor)
    np.testing.assert_allclose(ty, jy, **Y)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_support_loss_gradient_matches_jax_grad(cf):
    """The adaptation's gradient through the router, the gates, the
    dispatch, the experts and the combine (a weighted sum of y plus the
    aux loss), against jax.grad, with drops and the clobber in play."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b")
    jp, tp = _params(jcfg, seed=4)
    x = _x(jcfg, skew=4.0, jp=jp)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jax_moe.moe_apply(p, jcfg, x, capacity_factor=cf)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = {k: (v.requires_grad_(True) if isinstance(v, torch.Tensor) else
              {a: b.requires_grad_(True) for a, b in v.items()})
          for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tp, tcfg, tx, capacity_factor=cf)
    loss = (y * torch.from_numpy(w)).sum() + aux
    leaves = [tp[k] if isinstance(tp[k], torch.Tensor) else tp[k][a]
              for k in sorted(tp) for a in ([None] if isinstance(
                  tp[k], torch.Tensor) else sorted(tp[k]))]
    grads = torch.autograd.grad(loss, leaves + [tx])
    want = [jg_p[k] if a is None else jg_p[k][a] for k in sorted(tp)
            for a in ([None] if isinstance(tp[k], torch.Tensor)
                      else sorted(tp[k]))]
    for g, jg in zip(grads, want + [jg_x]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)


@pytest.mark.parametrize("cf", [1.25, 0.5, 2.0])
def test_dispatch_and_combine_indices_hit_each_row_once(cf):
    """The determinism argument of `moe.py`: every real row of the
    (T·K, d) entries is read by at most one slot, every real slot by at
    most one entry (the spare rows T·K and E·cap take the rest), so the
    backward's scatter-adds add one value into each row."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    jp, tp = _params(jcfg)
    r = _route(tcfg, tp, _x(jcfg, skew=4.0, jp=jp), cf)
    T, K = r["expert_ids"].shape
    E, cap = tcfg.num_experts, r["capacity"]
    src = r["slot_src"][r["slot_src"] < T * K]
    assert src.unique().numel() == src.numel()
    slots = r["tok_slot"][r["tok_slot"] < E * cap]
    assert slots.unique().numel() == slots.numel()
    assert int(r["keep"].sum()) == slots.numel()
