"""Port parity: the LM training step (`launch/steps.make_train_step`) and
the training launcher (`launch/train.py`) against the JAX package's, on
the reduced configs (float32) of the dense archs and Mamba2.

Both packages start from the reference's φ (carried over by `convert`:
torch cannot replay `jax.random`) and take the same
`make_lm_task_batch` draws, laid out (G, C, S, L). Two steps are run at
G = 1 and G = 2 client groups of C = 2 clients.

Tolerance: the step's metrics at rtol 1e-5 (a loss and an accuracy over
the query tokens). After the first Adam step φ and the first moment are
held as in `test_torch_fedmeta._close_after_adam`: m at rtol 1e-4 /
atol 1e-5 (gradients through two 256-wide layers, summed in other
orders by XLA and PyTorch), φ there too where |m| is above a floor, and
everywhere within 2·lr, since Adam's first step moves an entry by
lr·g/(|g| + eps), so an entry whose meta-gradient is within its own
rounding error of zero can land anywhere in ±lr. The floor is 1e-6 of
the largest |m|; for Reptile it is 1e-3, since its meta-gradient
θ − θ_k is a difference of two nearby f32 values whose error is an ulp
of θ, not of the difference. After the second step each φ entry is
within 2·lr a step of the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_server_state as jax_load_server_state
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data.lm_tasks import make_lm_task_batch
from repro.launch.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.launch import train as train_launcher
from repro_torch.launch.steps import make_train_step

MET = dict(rtol=1e-5, atol=1e-6)
NET = dict(rtol=1e-4, atol=1e-5)
INNER_LR, OUTER_LR = 0.05, 1e-3
C, S_SUP, S_QRY, L = 2, 2, 2, 16

CASES = ([("smollm-360m", a) for a in ("fomaml", "maml", "meta-sgd",
                                        "reptile")]
         + [(arch, "fomaml") for arch in ("mamba2-370m", "granite-3-2b",
                                          "qwen2.5-3b", "nemotron-4-340b")])


def _batches(vocab, G, steps):
    out = []
    for it in range(steps):
        t = make_lm_task_batch(G * C, S_SUP, S_QRY, L, vocab, seed=it)
        out.append((t.support_tokens.reshape(G, C, S_SUP, L),
                    t.query_tokens.reshape(G, C, S_QRY, L)))
    return out


def _jax_batch(sup, qry):
    return {"support": {"tokens": jnp.asarray(sup)},
            "query": {"tokens": jnp.asarray(qry)}}


def _torch_batch(sup, qry):
    return {"support": {"tokens": torch.from_numpy(sup)},
            "query": {"tokens": torch.from_numpy(qry)}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _close_after_adam(t_phi, j_phi, t_m, j_m, lr, floor):
    tm, jm = _flat(to_numpy_tree(t_m)), _flat(j_m)
    np.testing.assert_allclose(tm, jm, **NET)
    tp, jp = _flat(to_numpy_tree(t_phi)), _flat(j_phi)
    live = np.abs(jm) > floor * np.abs(jm).max()
    np.testing.assert_allclose(tp[live], jp[live], **NET)
    assert np.all(np.abs(tp - jp) <= 2 * lr * (1 + 1e-5))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch,algo", CASES)
def test_train_step_matches_reference(arch, algo, G):
    jcfg = jax_reduced_config(jax_get_config(arch))
    tcfg = reduced_config(get_config(arch))
    kw = dict(algo_name=algo, inner_lr=INNER_LR, outer_lr=OUTER_LR)
    jstep, jinit, _, _ = jax_make_train_step(jcfg, **kw)
    tstep, tinit, _, _ = make_train_step(tcfg, **kw)
    jstate = jinit(jax.random.PRNGKey(0))
    tstate = tinit(phi=from_numpy_tree(_np(jstate["phi"]), "cpu"),
                   device="cpu")
    jstep = jax.jit(jstep)
    for it, (sup, qry) in enumerate(_batches(jcfg.vocab_size, G, 2)):
        jstate, jmet = jstep(jstate, _jax_batch(sup, qry))
        tstate, tmet = tstep(tstate, _torch_batch(sup, qry))
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **MET,
                                       err_msg=f"step {it + 1} {k}")
        if it == 0:
            _close_after_adam(tstate["phi"], _np(jstate["phi"]),
                              tstate["opt"]["m"], _np(jstate["opt"]["m"]),
                              OUTER_LR, 1e-3 if algo == "reptile" else 1e-6)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
    tp, jp = _flat(to_numpy_tree(tstate["phi"])), _flat(_np(jstate["phi"]))
    assert np.all(np.abs(tp - jp) <= 2 * 2 * OUTER_LR * (1 + 1e-5))
    assert np.all(np.isfinite(tp))


def test_launcher_reduced_runs_and_reference_loads_its_checkpoint(tmp_path):
    """The CLI runs on the 1x1 host mesh with the state as DTensors; its
    checkpoint (gathered to plain tensors) loads in the reference's
    `load_server_state` and equals the meshless in-process run's bit for
    bit."""
    out = train_launcher.main(["--arch", "smollm-360m", "--reduced",
                               "--steps", "2", "--device", "cpu",
                               "--ckpt", str(tmp_path)])
    assert out["mesh"] == {"data": 1, "model": 1}
    assert [r["step"] for r in out["records"]] == [1, 2]
    assert all(np.isfinite(r["query_loss"]) for r in out["records"])
    assert out["shape"]["seq_len"] == 64
    assert out["shape"]["clients_per_round"] == 2
    # the same two steps from the same seed, in process
    cfg = reduced_config(get_config("smollm-360m"))
    shape = train_launcher.reduced_shape(
        train_launcher.INPUT_SHAPES["train_4k"])
    state, _ = train_launcher.train(cfg, shape, steps=2, device="cpu")
    ref = jax_load_server_state(str(tmp_path))
    assert jax.tree.structure(_np(ref)) == \
        jax.tree.structure(to_numpy_tree(state))
    for a, b in zip(jax.tree.leaves(_np(ref)),
                    jax.tree.leaves(to_numpy_tree(state))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert int(ref["opt"]["step"]) == 2


def test_launcher_refuses_what_it_cannot_run():
    """--multi-pod in a world of one raises naming the 512 ranks its
    mesh needs, and leaves no process group behind; an inference shape
    and a card that is not there raise."""
    with pytest.raises(ValueError, match="512 ranks"):
        train_launcher.main(["--arch", "smollm-360m", "--multi-pod",
                             "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="serve"):
        train_launcher.train(
            reduced_config(get_config("smollm-360m")),
            train_launcher.INPUT_SHAPES["decode_32k"], steps=1,
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_launcher.main(["--arch", "smollm-360m", "--reduced",
                                 "--steps", "1"])
