"""Port parity: the dense configs granite-3-2b, qwen2.5-3b and
nemotron-4-340b, and the relu2 / gelu MLPs, against the JAX package.

Configs: every field equal to the reference's, at full size and
reduced. Models: the reduced configs (float32) with the reference's
parameters carried over by `convert`; the forward's logits and one
prefill + decode step against the reference's at rtol 1e-4 / atol 1e-5
(two 256-wide layers whose matmuls XLA and PyTorch sum in other orders,
as in `test_torch_lm.py`); the MLPs alone at rtol 1e-5 / atol 1e-6. The
port's counterpart of `tests/test_arch_smoke.py::
test_prefill_decode_consistency` holds its prefill and decode against
its own full forward at the reference test's 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.launch.steps import make_apply_fn as jax_apply_fn
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import init_lm as jax_init_lm
from repro.models.layers import Rng as JaxRng
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.layers import mlp_init as jax_mlp_init
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import init_lm, lm_apply, lm_decode_step
from repro_torch.models.layers import mlp_apply, mlp_init, Rng
from repro_torch.utils.flat import plane_for

F32 = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("granite-3-2b", "qwen2.5-3b", "nemotron-4-340b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jax_reduced_config(jax_get_config(request.param))
    tcfg = reduced_config(get_config(request.param))
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(_np(jparams), "cpu")
    tokens = np.random.RandomState(0).randint(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    assert arch in list_archs()
    j, t = jax_get_config(arch), get_config(arch)
    if reduced:
        j, t = jax_reduced_config(j), reduced_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("act", ["relu2", "gelu", "swiglu"])
def test_mlp_matches_reference(act):
    d, d_ff = 24, 40
    jp = _np(jax_mlp_init(JaxRng(jax.random.PRNGKey(1)), d, d_ff, act,
                          jnp.float32))
    tp = mlp_init(Rng(1, "cpu"), d, d_ff, act, torch.float32)
    assert sorted(tp) == sorted(jp)
    assert all(tuple(tp[k].shape) == jp[k].shape for k in jp)
    x = np.random.RandomState(2).randn(3, 5, d).astype(np.float32)
    want = np.asarray(jax_mlp_apply(jax.tree.map(jnp.asarray, jp),
                                    jnp.asarray(x), act))
    got = mlp_apply(from_numpy_tree(jp, "cpu"), torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    with pytest.raises(ValueError, match="unknown act"):
        mlp_apply(tp, torch.from_numpy(x), "tanh")


def test_init_layout_matches_reference(setup):
    jcfg, tcfg, jparams, _, _ = setup
    tparams = init_lm(0, tcfg, device="cpu")
    jp, tp = jax_plane_for(jparams), plane_for(tparams)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]


def test_logits_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jlog, _ = jax_apply_fn(jcfg)(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tlog, aux = make_apply_fn(tcfg)(tparams, torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)


def test_prefill_and_decode_step_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jl, jc = jax.jit(jax_prefill_step(jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, jc = jax.jit(jax_decode_step(jcfg))(jparams, jc, jnp.asarray(tok))
    with torch.no_grad():
        tl, tc = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    assert tc["length"] == int(jc["length"]) == tokens.shape[1] + 1


def test_prefill_decode_consistency_granite():
    """Prefill-then-decode equals the full forward at the next position
    (granite reduced, full precision): the port's counterpart of the
    reference's `test_prefill_decode_consistency`."""
    cfg = reduced_config(get_config("granite-3-2b"))
    params = init_lm(0, cfg, device="cpu")
    rng = np.random.RandomState(0)
    B, L = 1, 24
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, (B, L + 1)),
                             dtype=torch.int32)
    with torch.no_grad():
        full, _ = lm_apply(params, cfg, tokens, remat=False)
        pre, _, cache = lm_apply(params, cfg, tokens[:, :L], remat=False,
                                 collect_cache=True, logits_mode="last",
                                 cache_capacity=L + 4)
        np.testing.assert_allclose(pre[:, 0].numpy(), full[:, L - 1].numpy(),
                                   rtol=1e-4, atol=1e-4)
        dec, _ = lm_decode_step(params, cfg, tokens[:, L:L + 1], cache)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, L].numpy(),
                               rtol=1e-4, atol=1e-4)
