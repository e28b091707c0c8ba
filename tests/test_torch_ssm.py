"""Port parity: the Mamba2 model family (config, `models/ssm.py`, the
("mamba", "none") block, the LM, its FOMAML gradient and a reduced
personalized serve) against the JAX package, on the reduced
Mamba2-370M config in f32, with the reference's parameters carried over
by `convert`.

Tolerance: rtol 1e-4 (atol 1e-4 for one block, as the reference's own
SSD tests; atol 1e-5 for the LM's logits, gradients and served rows,
the LM tests' NET): the block sums its matmuls and the SSD's chunked
products in other orders than XLA. The prefill -> decode handoff inside
the port is held at the reference's own 2e-3
(`tests/test_arch_smoke.py:107-119`), over two decode steps so a stale
SSM state would show. Served tokens must be equal.

The JAX model reaches its SSD kernel only when its default SSD impl is
set to "pallas_interpret" (`repro/kernels/ssd/ops.py:17`); the tests
that compare the port's kernel route against it set that default with
monkeypatch, which restores it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import lm_loss as jax_lm_loss
from repro.federated.serving import TrafficModel as JaxTraffic
from repro.kernels.ssd import ops as jax_ssd_ops
from repro.launch.serve import build_engine as jax_build_engine
from repro.launch.steps import make_apply_fn as jax_apply_fn
from repro.models import init_lm as jax_init_lm
from repro.models import ssm as jax_ssm
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import lm_loss
from repro_torch.federated.serving import TrafficModel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.serve import build_engine, main as serve_main
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import init_lm, lm_apply, ssm
from repro_torch.utils.flat import plane_for
from repro_torch.utils.pytree import tree_map

BLOCK = dict(rtol=1e-4, atol=1e-4)
NET = dict(rtol=1e-4, atol=1e-5)
HANDOFF = dict(rtol=2e-3, atol=2e-3)
ARCH = "mamba2-370m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree["stack"]["pos0"]["mixer"])


def _tlayer0(tree):
    return tree_map(lambda x: x[0], tree["stack"]["pos0"]["mixer"])


def _x(seed, B, L, d):
    return np.random.RandomState(seed).normal(0, 1, (B, L, d)).astype(
        np.float32)


# ---- config and parameters ---------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced):
    assert ARCH in list_archs()
    j, t = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = jax_reduced_config(j), reduced_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_leaf_dtypes_round_trip(setup, dtype):
    """The port's init has the reference's plane layout (offsets, sizes,
    shapes, dtypes): in a bf16 model `A_log`, `D` and `dt_bias` stay f32
    leaves, and the plane's pack -> unpack gives every leaf back bit for
    bit in its own dtype."""
    jcfg, tcfg, _, _ = setup
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    tparams = init_lm(0, tcfg, device="cpu")
    jp = jax_plane_for(jax.eval_shape(lambda: jax_init_lm(
        jax.random.PRNGKey(0), jcfg)))
    tp = plane_for(tparams)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]
    mixer = tparams["stack"]["pos0"]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32
    for name in ("w_in", "conv_w", "conv_b", "w_out"):
        assert mixer[name].dtype == getattr(torch, dtype)
    back = tp.unpack(tp.pack(tparams))
    for a, b in zip(jax.tree.leaves(to_numpy_tree(back)),
                    jax.tree.leaves(to_numpy_tree(tparams))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---- one Mamba2 block --------------------------------------------------------

ROUTES = [("cuda", "pallas_interpret"), ("torch", "xla")]


@pytest.mark.parametrize("L", [37, 16, 10])
@pytest.mark.parametrize("impl,jimpl", ROUTES, ids=["cuda", "torch"])
def test_mamba_forward_and_decode_match_reference(setup, impl, jimpl, L):
    """L = 37 pads to 48 with dt = 0 (three chunks of 16), L = 16 is one
    chunk, L = 10 runs a chunk of 10. Then three decode steps from the
    prefill cache, outputs and caches against the reference's."""
    jcfg, tcfg, jparams, tparams = setup
    jp, tp = _layer0(jparams), _tlayer0(tparams)
    x = _x(L, 2, L + 3, jcfg.d_model)
    jfwd = jax.jit(lambda p, v: jax_ssm.mamba_forward(p, jcfg, v,
                                                      ssd_impl=jimpl))
    jpre = jax.jit(lambda p, v: jax_ssm.mamba_forward(
        p, jcfg, v, ssd_impl=jimpl, return_cache=True))
    jdec = jax.jit(lambda p, v, c: jax_ssm.mamba_decode(p, jcfg, v, c))
    ty = ssm.mamba_forward(tp, tcfg, torch.from_numpy(x[:, :L]), ssd_impl=impl)
    np.testing.assert_allclose(ty.detach().numpy(),
                               np.asarray(jfwd(jp, x[:, :L])), **BLOCK)
    jy, jc = jpre(jp, x[:, :L])
    with torch.no_grad():
        ty, tc = ssm.mamba_forward(tp, tcfg, torch.from_numpy(x[:, :L]),
                                   ssd_impl=impl, return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BLOCK)
    assert tc["conv"].shape == (2, jcfg.conv_width - 1,
                                jcfg.ssm_expand * jcfg.d_model
                                + 2 * jcfg.ssm_state)
    for k in ("conv", "state"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **BLOCK)
    tc = {k: v.contiguous() for k, v in tc.items()}
    state_buf = tc["state"]
    for t in range(L, L + 3):
        jo, jc = jdec(jp, x[:, t:t + 1], jc)
        with torch.no_grad():
            to, tc = ssm.mamba_decode(tp, tcfg, torch.from_numpy(
                x[:, t:t + 1]), tc)
        assert tc["state"] is state_buf          # written in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **BLOCK)
        for k in ("conv", "state"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       **BLOCK)


# ---- the LM ------------------------------------------------------------------

@pytest.mark.parametrize("impl,jimpl", ROUTES, ids=["cuda", "torch"])
def test_lm_logits_match_reference(setup, monkeypatch, impl, jimpl):
    jcfg, tcfg, jparams, tparams = setup
    monkeypatch.setattr(jax_ssd_ops, "_DEFAULT_IMPL", jimpl)
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    jlog, _ = jax.jit(jax_apply_fn(jcfg, remat=False))(jparams,
                                                        jnp.asarray(tokens))
    with ssd_ops.use_impl(impl), torch.no_grad():
        tlog, aux = make_apply_fn(tcfg)(tparams, torch.from_numpy(tokens))
    assert tlog.shape == (2, 40, jcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_prefill_decode_handoff_two_steps(setup, impl):
    """Prefill L tokens, then decode two: each step's logits against the
    full forward over the longer prompt. The second step reads the state
    the first one wrote into the stacked cache in place."""
    _, tcfg, _, tparams = setup
    L = 37
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (2, L + 2)).astype(np.int32))
    with ssd_ops.use_impl(impl), torch.no_grad():
        full, _ = lm_apply(tparams, tcfg, tokens)
        last, cache = make_prefill_step(tcfg)(tparams, tokens[:, :L])
        np.testing.assert_allclose(last.numpy(), full[:, L - 1].numpy(),
                                   **HANDOFF)
        state = cache["stack"]["pos0"]["state"]
        before = state.clone()
        decode = make_decode_step(tcfg)
        for t in (L, L + 1):
            logits, cache = decode(tparams, cache, tokens[:, t:t + 1])
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       **HANDOFF)
            assert cache["stack"]["pos0"]["state"] is state
        assert cache["length"] == L + 2
        assert not torch.equal(state, before)


# ---- the FOMAML gradient -----------------------------------------------------

def test_fomaml_client_grad_matches_reference(setup):
    jcfg, tcfg, jparams, tparams = setup
    ja = jax_make_algorithm("fomaml", *jax_lm_loss(jax_apply_fn(
        jcfg, remat=False)), 0.05)
    ta = make_algorithm("fomaml", *lm_loss(make_apply_fn(tcfg)), 0.05)
    rng = np.random.RandomState(2)
    sup, qry = (rng.randint(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
                for _ in range(2))
    jg, jmet = jax.jit(ja.client_grad)({"theta": jparams}, jnp.asarray(sup),
                                       jnp.asarray(qry))
    tg, tmet = ta.client_grad({"theta": tparams}, torch.from_numpy(sup),
                              torch.from_numpy(qry))
    jflat, tflat = jax.tree.leaves(jg), jax.tree.leaves(to_numpy_tree(tg))
    assert len(jflat) == len(tflat)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a, np.asarray(b), **NET)
    assert sorted(tmet) == sorted(jmet)
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **NET)


# ---- a reduced personalized serve --------------------------------------------

SERVE_TRAFFIC = dict(num_clients=3, rate=50.0, support_sizes=(2,), seed=6)


def test_build_engine_serve_matches_reference_engine():
    """The whole reduced serve on the same φ and traffic: rows allclose,
    tokens equal. Supports of 20 tokens (a chunk of 16 and a padded one),
    prompts of 9 (a chunk of 9)."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    jengine = jax_build_engine(jcfg, adapt_batch=2, seed=0)
    tphi = {"theta": from_numpy_tree(
        jax.tree.map(np.asarray, jengine._phi["theta"]), "cpu")}
    mk = lambda r, size: r.randint(0, jcfg.vocab_size, (size, 20)).astype(
        np.int32)                                            # noqa: E731
    mp = lambda r: r.randint(0, jcfg.vocab_size, (9,)).astype(
        np.int32)                                            # noqa: E731
    jrep = jengine.serve(JaxTraffic(**SERVE_TRAFFIC).requests(5, mk, mp),
                         max_new_tokens=3)
    engine = build_engine(tcfg, tphi, adapt_batch=2, device="cpu")
    trep = engine.serve(TrafficModel(**SERVE_TRAFFIC).requests(5, mk, mp),
                        max_new_tokens=3)
    assert [r["rid"] for r in trep.records] == [r["rid"] for r in jrep.records]
    assert [r["hit"] for r in trep.records] == [r["hit"] for r in jrep.records]
    assert trep.summary()["hits"] == jrep.summary()["hits"] > 0
    for t, j in zip(trep.records, jrep.records):
        np.testing.assert_allclose(t["row"].numpy(), np.asarray(j["row"]),
                                   **NET)
        np.testing.assert_array_equal(t["tokens"], np.asarray(j["tokens"]))


def test_launch_serve_main_reduced_cpu(capsys):
    res = serve_main(["--arch", ARCH, "--reduced", "--steps", "2",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "decode step 0" in out and "decode step 1" in out
    assert res["logits_shape"] == (2, 512) and res["logits_finite"]
    assert len(res["step_s"]) == 2
