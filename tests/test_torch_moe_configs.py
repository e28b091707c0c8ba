"""Port parity: the MoE and MLA configs — mixtral-8x22b (MoE with a
sliding window), jamba-v0.1-52b (the Mamba / attention / MoE period)
and deepseek-v2-236b (MLA, a lead dense layer, shared experts) —
against the JAX package, on their reduced configs in float32 with the
reference's parameters carried over by `convert`.

Tolerance: logits, aux, prefill and decode at rtol 1e-4 / atol 1e-5
(`test_torch_dense_configs.py`: layers of 256-wide matmuls summed in
other orders by XLA and PyTorch); the router's f32 logits pick the
same experts on both sides. The handoff checks (the port's prefill
then decode against its own full forward) are held at the reference's
own 2e-3 (`tests/test_arch_smoke.py:145-168`), at capacity_factor E/K
so that no entry drops on either path (drops depend on the batch). The
FOMAML step as in `test_torch_train_step.py`."""
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
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import init_lm as jax_init_lm
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import init_lm, lm_apply, lm_decode_step
from repro_torch.models.lm import layer_groups
from repro_torch.utils.flat import plane_for
from test_torch_train_step import (INNER_LR, MET, OUTER_LR, _batches,
                                   _close_after_adam, _jax_batch,
                                   _torch_batch)

NET = dict(rtol=1e-4, atol=1e-5)
HANDOFF = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("mixtral-8x22b", "jamba-v0.1-52b", "deepseek-v2-236b")


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


@pytest.mark.parametrize("arch,lead,period", [
    ("mixtral-8x22b", [], [("attn", "moe")]),
    ("jamba-v0.1-52b", [], [("mamba", "mlp"), ("mamba", "moe")] * 2
     + [("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
        ("mamba", "moe")]),
    ("deepseek-v2-236b", [("attn", "mlp")], [("attn", "moe")])])
def test_layer_groups_at_full_size(arch, lead, period):
    """Jamba's period of 8 (mamba ×4, attn, mamba ×3) with MoE at odd
    positions is lcm(8, 2) = 8 layers; deepseek's lead dense layer
    stands alone."""
    cfg = get_config(arch)
    got_lead, got_period, n_reps = layer_groups(cfg)
    assert (got_lead, got_period) == (lead, period)
    assert n_reps * len(period) + len(lead) == cfg.num_layers


def test_init_layout_matches_reference(setup):
    jcfg, tcfg, jparams, _, _ = setup
    tparams = init_lm(0, tcfg, device="cpu")
    jp, tp = jax_plane_for(jparams), plane_for(tparams)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]


def test_logits_and_aux_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jlog, jaux = jax.jit(jax_apply_fn(jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tlog, taux = make_apply_fn(tcfg)(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_prefill_and_decode_step_match_reference(setup):
    jcfg, tcfg, jparams, tparams, tokens = setup
    jl, jc = jax.jit(jax_prefill_step(jcfg))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    jleaves = jax.tree.leaves({k: v for k, v in jc.items() if k != "length"})
    tleaves = jax.tree.leaves({k: v for k, v in tc.items() if k != "length"})
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jl, jc = jax.jit(jax_decode_step(jcfg))(jparams, jc, jnp.asarray(tok))
    with torch.no_grad():
        tl, tc = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    assert tc["length"] == int(jc["length"]) == tokens.shape[1] + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_handoff(arch):
    """Prefill then decode equals the port's own full forward at the
    next position, at capacity_factor E/K, with room in the cache for
    the decoded token (capacity L + 4, as the reference's
    `test_prefill_decode_consistency`). For mixtral the prompt (96) is
    longer than the reduced window (64), so the GQA ring holds the
    window's 64 slots and decode reads it: the port of
    `tests/test_arch_smoke.py::test_sliding_window_ring_decode`."""
    cfg = reduced_config(get_config(arch))
    cfg = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    params = init_lm(0, cfg, device="cpu")
    B, L = 1, 96
    tokens = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, L + 1)), dtype=torch.int32)
    with torch.no_grad():
        full, _ = lm_apply(params, cfg, tokens, remat=False)
        pre, _, cache = lm_apply(params, cfg, tokens[:, :L], remat=False,
                                 collect_cache=True, logits_mode="last",
                                 cache_capacity=L + 4)
        if cfg.sliding_window:
            assert cfg.sliding_window == 64
            assert cache["stack"]["pos0"]["k"].shape[2] == 64
        np.testing.assert_allclose(pre[:, 0].numpy(), full[:, L - 1].numpy(),
                                   **HANDOFF)
        dec, _ = lm_decode_step(params, cfg, tokens[:, L:L + 1], cache)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, L].numpy(),
                               **HANDOFF)


@pytest.fixture
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ARCHS)
def test_fomaml_train_step_matches_reference(arch, _one_thread):
    """One FOMAML `make_train_step` step from the reference's φ: the
    metrics, the meta-gradient (through Adam's first moment) and φ."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    tcfg = reduced_config(get_config(arch))
    kw = dict(algo_name="fomaml", inner_lr=INNER_LR, outer_lr=OUTER_LR)
    jstep, jinit, _, _ = jax_make_train_step(jcfg, **kw)
    tstep, tinit, _, _ = make_train_step(tcfg, **kw)
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = tinit(phi=from_numpy_tree(_np(jstate["phi"]), "cpu"),
                   device="cpu")
    (sup, qry), = _batches(jcfg.vocab_size, 1, 1)
    jstate, jmet = jax.jit(jstep)(jstate, _jax_batch(sup, qry))
    tstate, tmet = tstep(tstate, _torch_batch(sup, qry))
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **MET,
                                   err_msg=k)
    _close_after_adam(tstate["phi"], _np(jstate["phi"]), tstate["opt"]["m"],
                      _np(jstate["opt"]["m"]), OUTER_LR, 1e-6)
