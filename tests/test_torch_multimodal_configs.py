"""Port parity: the vision-prefix and encoder-decoder configs —
qwen2-vl-7b (M-RoPE over [patches | text], QKV bias) and
seamless-m4t-medium (a bidirectional encoder over frames, cross-
attention in every decoder block, gelu) — against the JAX package, on
their reduced configs in float32 with the reference's parameters
carried over by `convert`, and the modality embeddings entering through
the entry points (`make_apply_fn`, `make_prefill_step`,
`make_train_step`, the launcher's `task_batch`).

Tolerances as `test_torch_moe_configs.py`: logits, prefill and decode
at rtol 1e-4 / atol 1e-5; the FOMAML step's metrics at rtol 1e-5 and
its meta-gradient (Adam's first moment) and φ as
`test_torch_train_step._close_after_adam`. The launcher's embeddings are
the same numpy draws cast the same way: bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs import reduced_config as jax_reduced_config
from repro.data.lm_tasks import make_lm_task_batch
from repro.launch.steps import make_apply_fn as jax_apply_fn
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.steps import train_batch_layout as jax_layout
from repro.models import init_lm as jax_init_lm
from repro.utils.flat import plane_for as jax_plane_for
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs import reduced_config
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.launch.steps import (make_apply_fn, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import init_lm
from repro_torch.utils.flat import plane_for
from test_torch_train_step import (INNER_LR, MET, OUTER_LR, _close_after_adam)

NET = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("qwen2-vl-7b", "seamless-m4t-medium")
C, S_SUP, S_QRY, L = 2, 2, 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jax_reduced_config(jax_get_config(request.param))
    tcfg = reduced_config(get_config(request.param))
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_numpy_tree(_np(jparams), "cpu")
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, jcfg.vocab_size, (2, 16)).astype(
        np.int32),
             "embeds": rng.normal(0, 0.1, (2, jcfg.num_modality_tokens,
                                           jcfg.d_model)).astype(np.float32)}
    return jcfg, tcfg, jparams, tparams, batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_registry_holds_every_reference_arch():
    assert list_archs() == jax_list_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    j, t = jax_get_config(arch), get_config(arch)
    if reduced:
        j, t = jax_reduced_config(j), reduced_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_init_layout_matches_reference(setup):
    """Keys, shapes and dtypes of the init tree, slot by slot of the
    packed plane (the reference's sorted leaf order): ``mod_proj``,
    qwen2-vl's q/k/v biases, seamless's ``cross`` and ``encoder``."""
    jcfg, tcfg, jparams, _, _ = setup
    tparams = init_lm(0, tcfg, device="cpu")
    jp, tp = jax_plane_for(jparams), plane_for(tparams)
    assert [(s.offset, s.size, s.shape, s.dtype) for s in tp.slots] == \
        [(s.offset, s.size, s.shape, s.dtype) for s in jp.slots]
    assert "mod_proj" in tparams
    if tcfg.mrope:
        assert {"bq", "bk", "bv"} <= set(tparams["stack"]["pos0"]["mixer"])
    else:
        assert "encoder" in tparams and "cross" in tparams["stack"]["pos0"]


def test_logits_match_reference(setup):
    """Logits from the converted parameters: qwen2-vl's over [prefix |
    text] (L = n_mod + 16), seamless's over the text."""
    jcfg, tcfg, jparams, tparams, batch = setup
    jlog, _ = jax.jit(jax_apply_fn(jcfg))(jparams, _jax(batch))
    with torch.no_grad():
        tlog, _ = make_apply_fn(tcfg)(tparams, _torch(batch))
    n_mod = jcfg.num_modality_tokens if jcfg.mrope else 0
    assert tlog.shape == (2, n_mod + 16, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **NET)


def test_prefill_and_decode_step_match_reference(setup):
    jcfg, tcfg, jparams, tparams, batch = setup
    jl, jc = jax.jit(jax_prefill_step(jcfg))(jparams, _jax(batch))
    with torch.no_grad():
        tl, tc = make_prefill_step(tcfg)(tparams, _torch(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
    jleaves = jax.tree.leaves({k: v for k, v in jc.items() if k != "length"})
    tleaves = jax.tree.leaves({k: v for k, v in tc.items() if k != "length"})
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for _ in range(2):
        jl, jc = jax.jit(jax_decode_step(jcfg))(jparams, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = make_decode_step(tcfg)(tparams, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **NET)
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    assert tc["length"] == int(jc["length"])


@pytest.fixture
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train_batch(cfg, seed):
    """(G=1, C, S, L) tokens and (G, C, S, n_mod, d) embeds, numpy."""
    t = make_lm_task_batch(C, S_SUP, S_QRY, L, cfg.vocab_size, seed=seed)
    rng = np.random.RandomState(seed)
    out = {}
    for name, toks, S in (("support", t.support_tokens, S_SUP),
                          ("query", t.query_tokens, S_QRY)):
        out[name] = {"tokens": toks.reshape(1, C, S, L),
                     "embeds": rng.normal(0, 0.1, (
                         1, C, S, cfg.num_modality_tokens,
                         cfg.d_model)).astype(np.float32)}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fomaml_train_step_with_embeds_matches_reference(arch, _one_thread):
    """One FOMAML `make_train_step` step from the reference's φ with the
    modality embeddings in the support and query batches: the metrics,
    the meta-gradient (through Adam's first moment) and φ."""
    jcfg = jax_reduced_config(jax_get_config(arch))
    tcfg = reduced_config(get_config(arch))
    kw = dict(algo_name="fomaml", inner_lr=INNER_LR, outer_lr=OUTER_LR)
    jstep, jinit, _, _ = jax_make_train_step(jcfg, **kw)
    tstep, tinit, _, _ = make_train_step(tcfg, **kw)
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = tinit(phi=from_numpy_tree(_np(jstate["phi"]), "cpu"),
                   device="cpu")
    batch = _train_batch(jcfg, 0)
    jstate, jmet = jax.jit(jstep)(jstate, jax.tree.map(jnp.asarray, batch))
    tstate, tmet = tstep(tstate, {k: _torch(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **MET,
                                   err_msg=k)
    _close_after_adam(tstate["phi"], _np(jstate["phi"]), tstate["opt"]["m"],
                      _np(jstate["opt"]["m"]), OUTER_LR, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_task_batch_embeds_equal_reference_draw(arch, dtype):
    """The launcher's step-``it`` batch: the reference's
    `make_lm_task_batch` tokens and its embeddings,
    ``RandomState(it).normal(0, 0.1, (G, C, S, n_mod, d))`` for support
    then query, cast to ``cfg.dtype`` (`repro/launch/train.py:86-91`),
    bit for bit, in the reduced shape's layout (qwen2-vl's text is
    seq_len − n_mod tokens)."""
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    jshape = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=64,
                                 global_batch=4, clients_per_round=2,
                                 seqs_per_client=2)
    shape = train_launcher.reduced_shape(INPUT_SHAPES["train_4k"])
    G, Cc, S_sup, S_qry, L_text, n_mod = jax_layout(jcfg, jshape, 1)
    for it in (0, 3):
        got = train_launcher.task_batch(tcfg, shape, it, "cpu")
        tasks = make_lm_task_batch(G * Cc, S_sup, S_qry, L_text,
                                   jcfg.vocab_size, seed=it)
        rngd = np.random.RandomState(it)
        for part, S, toks in (("support", S_sup, tasks.support_tokens),
                              ("query", S_qry, tasks.query_tokens)):
            want = jnp.asarray(rngd.normal(0, 0.1, (G, Cc, S, n_mod,
                                                    jcfg.d_model)),
                               jnp.dtype(dtype))
            emb = got[part]["embeds"]
            assert emb.dtype == getattr(torch, dtype)
            assert tuple(emb.shape) == want.shape
            np.testing.assert_array_equal(
                emb.float().numpy(), np.asarray(want.astype(jnp.float32)))
            np.testing.assert_array_equal(
                got[part]["tokens"].numpy(), toks.reshape(G, Cc, S, L_text))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_main_reduced_on_the_cpu(arch, _one_thread):
    out = train_launcher.main(["--arch", arch, "--reduced", "--steps", "2",
                               "--device", "cpu", "--log-every", "100"])
    assert len(out["records"]) == 2
    assert all(np.isfinite(r["query_loss"]) for r in out["records"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_on_the_cpu(arch):
    """The decode CLI's body on the reduced config: seamless's cache
    holds a zero encoder output of num_modality_tokens frames."""
    cfg = reduced_config(get_config(arch))
    out = serve.decode_steps(cfg, 2, 32, 2, device="cpu")
    assert out["logits_shape"] == (2, cfg.vocab_size)
    assert out["logits_finite"] and len(out["step_s"]) == 2
