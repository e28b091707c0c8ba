"""Port parity: fault injection (`federated/faults.py`), the trainer's
failure-plane knobs and the robustness sweep of `launch/compare.py`,
against the JAX package.

`FaultConfig.counts` and `pick` take numpy `RandomState` draws, so they
are held equal to the reference's exactly; `apply_faults` bitwise on f32
and bf16 blocks, with the scaled-noise draw injected from the
reference's own `jax.random.normal` (the port's own draw, from a
`torch.Generator`, is held to its distribution). A few rounds of the
robustness sweep's `byzantine 0.25 / trimmed` cell (reduced clients and
model width) run in both trainers from the reference's initial φ:
``skipped`` exactly, round 1 and its meta-gradient at rtol 1e-4 / atol
1e-5 (the network tolerance of the other trainer tests), the later rounds
as `test_robustness_cell_matches_reference_trainer` derives."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import make_algorithm as jax_make_algorithm
from repro.core.losses import classification_loss as jax_cls_loss
from repro.data.synth_femnist import make_femnist as jax_make_femnist
from repro.federated.faults import FaultConfig as JaxFaultConfig
from repro.federated.faults import apply_faults as jax_apply_faults
from repro.federated.server import FederatedTrainer as JaxTrainer
from repro.models.paper.models import femnist_cnn as jax_femnist_cnn
from repro.optim import adam as jax_adam
from repro_torch.convert import from_numpy_tree
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.losses import classification_loss
from repro_torch.data import make_femnist
from repro_torch.federated.faults import FaultConfig, apply_faults
from repro_torch.federated.server import FederatedTrainer
from repro_torch.launch import compare
from repro_torch.models.paper import femnist_cnn
from repro_torch.optim import adam

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and small CPU convolutions spread over
    every core in each of them spend most of their time waiting for
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NET = dict(rtol=1e-4, atol=1e-5)
FRACTIONS = (0.0, 0.1, 0.125, 0.25, 0.375, 0.5, 0.9)
MODES = {"dropout": dict(dropout=0.25), "nonfinite": dict(nonfinite=0.125),
         "sign_flip": dict(byzantine=0.25, byzantine_scale=3.3),
         "scaled_noise": dict(byzantine=0.25, byzantine_mode="scaled_noise",
                              byzantine_scale=5.0),
         "all": dict(dropout=0.25, nonfinite=0.125, byzantine=0.25)}


# ---- FaultConfig ---------------------------------------------------------------

def test_counts_match_reference():
    for m in range(1, 13):
        for d in FRACTIONS:
            for n in FRACTIONS:
                for b in FRACTIONS:
                    kw = dict(dropout=d, nonfinite=n, byzantine=b)
                    assert FaultConfig(**kw).counts(m) == \
                        JaxFaultConfig(**kw).counts(m), (m, kw)


@pytest.mark.parametrize("m", [1, 4, 8, 13])
def test_pick_matches_reference(m):
    """The same (keep, nan_mask, byz_mask, noise_seed), dtypes included,
    and the same draws taken, for every seed and mode."""
    for seed in range(6):
        for kw in MODES.values():
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            for _ in range(3):                  # consecutive rounds
                got = FaultConfig(**kw, seed=seed).pick(m, r1)
                want = JaxFaultConfig(**kw, seed=seed).pick(m, r2)
                for a, b in zip(got, want):
                    assert np.asarray(a).dtype == np.asarray(b).dtype
                    np.testing.assert_array_equal(a, b)
            assert r1.randint(1 << 30) == r2.randint(1 << 30)


def test_fault_validation_matches_reference():
    for kw in (dict(dropout=1.0), dict(nonfinite=-0.1),
               dict(byzantine_mode="zeroed")):
        for cls in (FaultConfig, JaxFaultConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    assert not FaultConfig().enabled and FaultConfig(dropout=0.1).enabled


def _block(m=8, n=2048, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (m, n)).astype(np.float32),
            rng.uniform(0.5, 2.0, (m,)).astype(np.float32))


def _np(x):
    x = x.detach().cpu()
    return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
            else x.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_apply_faults_matches_reference(mode, dtype):
    """Corrupted block bitwise equal (NaN rows included) and the weights
    at rtol 1e-6, with the reference's noise draw injected."""
    cfg, jcfg = FaultConfig(**MODES[mode]), JaxFaultConfig(**MODES[mode])
    gs, w = _block()
    pick = cfg.pick(8, np.random.RandomState(1))
    jG = jnp.asarray(gs).astype(getattr(jnp, dtype))
    jG2, jw_agg, jw_rep = jax_apply_faults(jcfg, jG, jnp.asarray(w),
                                           tuple(map(jnp.asarray, pick)))
    draw = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(pick[3]), gs.shape, jnp.float32)))
    G = torch.from_numpy(gs).to(getattr(torch, dtype))
    G2, w_agg, w_rep = apply_faults(cfg, G, torch.from_numpy(w),
                                    pick[:3] + (draw,))
    assert G2 is G                                # rewritten in place
    want = np.asarray(jG2)
    want = want.view(np.int16) if dtype == "bfloat16" else want
    np.testing.assert_array_equal(_np(G2), want)
    np.testing.assert_allclose(w_agg.numpy(), np.asarray(jw_agg), rtol=1e-6)
    np.testing.assert_allclose(w_rep.numpy(), np.asarray(jw_rep), rtol=1e-6)
    if cfg.counts(8)[0]:
        assert np.isclose(float(w_rep.sum()), 1.0)


def test_zero_fraction_faults_are_bitwise_identity():
    """A disabled config returns the block and weights themselves,
    untouched."""
    gs, w = _block()
    G, tw = torch.from_numpy(gs.copy()), torch.from_numpy(w)
    cfg = FaultConfig()
    G2, w_agg, w_rep = apply_faults(cfg, G, tw,
                                    cfg.pick(8, np.random.RandomState(0)))
    assert G2 is G and w_agg is tw and w_rep is tw
    np.testing.assert_array_equal(G.numpy(), gs)


def test_own_scaled_noise_draw_is_scale_times_standard_normal():
    """Without an injected draw the Byzantine rows are scale·N(0, 1) from
    a generator seeded with the pick's seed: the same rows for the same
    seed, mean ≈ 0 and standard deviation ≈ scale (hand check at 5σ of
    the estimators over 2048 entries), honest rows untouched."""
    cfg = FaultConfig(**MODES["scaled_noise"])
    gs, w = _block()
    pick = cfg.pick(8, np.random.RandomState(2))
    rows = np.flatnonzero(pick[2])
    outs = []
    for _ in range(2):
        G = torch.from_numpy(gs.copy())
        apply_faults(cfg, G, torch.from_numpy(w), pick)
        outs.append(G.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    honest = np.setdiff1d(np.arange(8), rows)
    np.testing.assert_array_equal(outs[0][honest], gs[honest])
    n = gs.shape[1]
    for u in rows:
        x = outs[0][u] / cfg.byzantine_scale
        assert abs(x.mean()) <= 5 / np.sqrt(n)
        assert abs(x.std() - 1.0) <= 5 / np.sqrt(2 * n)
    other = cfg.pick(8, np.random.RandomState(3))
    G = torch.from_numpy(gs.copy())
    apply_faults(cfg, G, torch.from_numpy(w), pick[:3] + other[3:])
    assert not np.array_equal(G.numpy()[rows], outs[0][rows])


# ---- the trainer ---------------------------------------------------------------

def _algo():
    return make_algorithm("fomaml", lambda p, b: 0, lambda p, b: (0, {}),
                          0.05)


KW = dict(train_clients=[], clients_per_round=4, support_frac=0.5,
          support_size=8, query_size=8, device="cpu")


def test_trainer_validation_matches_reference():
    """The reference's refusals (tests/test_faults.py): faults off the
    packed plane, an unknown aggregator, 2·trim ≥ clients per round,
    faults with fused rounds; robust aggregation off the vmap axis."""
    for kw in (dict(faults=FaultConfig(dropout=0.25)),
               dict(packed=True, aggregator="median"),
               dict(packed=True, aggregator="trimmed", trim=2),
               dict(packed=True, faults=FaultConfig(dropout=0.25),
                    fuse_rounds=2),
               dict(packed=True, aggregator="screen",
                    client_axis="chunked")):
        with pytest.raises(ValueError):
            FederatedTrainer(_algo(), adam(1e-3), **{**KW, **kw})
    FederatedTrainer(_algo(), adam(1e-3), packed=True, aggregator="trimmed",
                     trim=1, **KW)


def test_guard_is_auto_with_any_failure_knob():
    """guard=None turns on with faults or a robust aggregator and stays
    off without; an explicit value is kept."""
    for kw, want in ((dict(), False), (dict(aggregator="masked_mean"), True),
                     (dict(aggregator="screen"), True),
                     (dict(faults=FaultConfig()), True),
                     (dict(faults=FaultConfig(byzantine=0.25)), True),
                     (dict(aggregator="trimmed", guard=False), False),
                     (dict(guard=True), True)):
        tr = FederatedTrainer(_algo(), adam(1e-3), packed=True, **KW, **kw)
        assert tr.guard is want, kw


CELL = dict(clients_per_round=8, support_frac=0.2, support_size=8,
            query_size=8, seed=0, packed=True, aggregator="trimmed", trim=2,
            screen_factor=3.0)


@pytest.fixture(scope="module")
def cell_runs():
    """The `byzantine 0.25 / trimmed` cell, reduced: 30 clients, a
    16-wide CNN, in both packages from the reference's φ, on both routes:
    one round (its state kept), then two more with an eval at the last.
    -> {port impl: (reference trainer, its round-1 state, port trainer,
    its round-1 state)}."""
    jm = jax_femnist_cnn(62, hidden=16)
    theta = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jtr, jval, _ = jax_make_femnist(num_clients=30, mean_samples=30,
                                    seed=0).split_clients(0)
    ttr, tval, _ = make_femnist(num_clients=30, mean_samples=30,
                                seed=0).split_clients(0)
    tm = femnist_cnn(62, hidden=16, device="cpu")
    runs = {}
    # each port route against its counterpart: K5's plain version against
    # the reference's kernel (interpret mode), the sort against the sort
    for impl, jimpl in (("cuda", "pallas_interpret"), ("torch", "xla")):
        jt = JaxTrainer(jax_make_algorithm("fomaml", *jax_cls_loss(
            jm.apply), 0.05), jax_adam(1e-3), jtr,
            faults=JaxFaultConfig(byzantine=0.25), impl=jimpl, **CELL)
        js = jt.run(jt.init(0, lambda k: jax.tree.map(jnp.asarray, theta)),
                    1)
        j1 = jax.tree.map(np.array, js)
        jt.run(js, 2, eval_every=2, eval_clients=jval)
        tt = FederatedTrainer(make_algorithm("fomaml", *classification_loss(
            tm.apply), 0.05), adam(1e-3), ttr, impl=impl, device="cpu",
            faults=FaultConfig(byzantine=0.25), **CELL)
        ts = tt.run(tt.init(0, lambda k: from_numpy_tree(theta, "cpu")), 1)
        t1 = {"phi": ts["phi"].clone(), "m": ts["opt"]["m"].clone()}
        tt.run(ts, 2, eval_every=2, eval_clients=tval)
        runs[impl] = (jt, j1, tt, t1)
    return runs


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_robustness_cell_matches_reference_trainer(cell_runs, impl):
    """Round 1's metrics (taken before any update) and meta-gradient
    (Adam's m/(1−b1)) at NET, φ after it within 2·lr, ``skipped``
    exactly in every round. Later rounds' numbers are held looser: the
    trimmed mean of this cell has many near-zero coordinates, where
    Adam's first step lr·g/(|g| + eps) turns a last-bit difference into
    up to 2·lr — the reference's own xla and interpret routes then move
    φ apart by 7.5e-4 in one round and its next query loss by 2.8e-3
    relative. So losses at rtol 1e-2, accuracies within 2/64 (two of a
    round's 64 query predictions)."""
    jt, j1, tt, t1 = cell_runs[impl]
    assert tt.guard and jt.guard
    assert len(tt.history) == len(jt.history) == 3
    lr = 1e-3
    np.testing.assert_allclose(t1["m"].numpy() / 0.1,
                               np.asarray(j1["opt"]["m"]) / 0.1, **NET)
    assert np.all(np.abs(t1["phi"].numpy() - np.asarray(j1["phi"]))
                  <= 2 * lr * (1 + 1e-5))
    for r, (a, b) in enumerate(zip(tt.history, jt.history)):
        assert sorted(a) == sorted(b)
        assert a["skipped"] == b["skipped"] == 0.0
        for k in b:
            if k == "round" or r == 0 or "MB" in k or k == "rounds":
                np.testing.assert_allclose(a[k], b[k], **NET, err_msg=k)
            elif "acc" in k:
                assert abs(a[k] - b[k]) <= 2 / 64 + 1e-6, (r, k)
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-2,
                                           err_msg=k)


def test_robustness_sweep_dry_run(tmp_path):
    """`launch.compare --sweep robustness` at a dry-run size (24 clients,
    2 rounds, an eval a round) writes the committed artifact's JSON
    shape: the same config keys, the five scenarios' headline, the 15
    cells with the same fields; the all-NaN-mean cell skips every round
    and the clean mean cell runs without the guard."""
    out = compare.main(["--sweep", "robustness", "--device", "cpu",
                        "--rounds", "2", "--eval-every", "1", "--clients",
                        "24", "--outdir", str(tmp_path)])
    with open(tmp_path / "robustness_femnist.json") as f:
        written = json.load(f)
    with open(os.path.join(os.path.dirname(__file__), "..", "results",
                           "experiments", "robustness_femnist.json")) as f:
        committed = json.load(f)
    assert sorted(written) == sorted(committed) == ["cells", "config",
                                                    "headline"]
    assert list(written["config"]) == list(committed["config"])
    assert {k: v for k, v in written["config"].items()
            if k not in ("rounds", "eval_every", "clients", "regen")} == \
        {k: v for k, v in committed["config"].items()
         if k not in ("rounds", "eval_every", "clients", "regen")}
    assert list(written["headline"]) == list(committed["headline"])
    for key, row in written["headline"].items():
        assert list(row) == list(committed["headline"][key])
    assert len(written["cells"]) == len(committed["cells"]) == 15
    for got, want in zip(written["cells"], committed["cells"]):
        assert sorted(got) == sorted(want)
        assert (got["kind"], got["fraction"], got["aggregator"]) == \
            (want["kind"], want["fraction"], want["aggregator"])
        assert got["rounds"] == 2 and len(got["eval_curve"]) == 2
        assert np.isfinite(got["final_test_acc"])
        poisoned = (got["kind"], got["aggregator"]) == ("nonfinite", "mean")
        assert got["skipped_rounds"] == (2 if poisoned else 0)
    assert out["cells"] == written["cells"]
