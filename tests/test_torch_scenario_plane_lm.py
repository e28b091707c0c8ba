"""Port parity: `run_comparison` on the two language-modelling
scenarios against the JAX package's — Shakespeare's next-character
`char_lstm` and LM personalization on a reduced SmolLM (per-client
dialect corpora through `lm_pair_loss`, K7's plain version on the CPU).

The reduced plan, the reference's initial parameters and the holds are
`test_torch_scenario_plane`'s; this file holds the scenarios whose
reference runs take longest, so each file stays near a minute alone."""
import pytest
import torch

from test_torch_scenario_plane import ROUND_BYTES, compare, hold_records

METHODS = {"shakespeare": ("fedavg", "fomaml", "maml"),
           "lm": ("fedavg", "fomaml")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dataset", list(METHODS))
def test_scenario_records_match_reference(dataset):
    jout, tout, _ = compare(dataset, METHODS[dataset])
    hold_records(jout, tout, ROUND_BYTES[dataset])
    if dataset == "lm":
        # next-token metrics under lm_pair_loss: the reference's keys
        for m in METHODS[dataset]:
            for h in tout["methods"][m]["history"]:
                assert {"accuracy", "nll", "eval_acc", "eval_loss"} <= set(h)


@pytest.mark.parametrize("dataset", ["femnist", "sent140", "recommend"])
def test_committed_plans_match_artifacts(dataset):
    """`launch/compare.comparison_plan` gives each committed artifact's
    plan: the fields it records agree (the artifacts predate some plan
    fields, and were made on the tree pipeline)."""
    import json
    import os
    from repro_torch.launch.compare import comparison_plan
    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "experiments", f"{dataset}_compare.json")
    with open(path) as f:
        want = json.load(f)["plan"]
    got = comparison_plan(dataset, pipeline="tree").to_json()
    assert {k: got[k] for k in want} == want


def test_scenario_sweep_writes_only_under_outdir(tmp_path, monkeypatch):
    """``--sweep recommend`` on the CPU: the five methods, bytes a round
    by view, and its JSON only where ``--outdir`` says."""
    from repro_torch.launch import compare
    monkeypatch.chdir(tmp_path)
    out = compare.main(["--sweep", "recommend", "--device", "cpu",
                        "--rounds", "1", "--eval-every", "1",
                        "--outdir", "out"])
    assert list(out["methods"]) == ["fedavg", "fedavg(meta)", "maml",
                                    "fomaml", "meta-sgd"]
    for m, rec in out["methods"].items():
        assert round(rec["comm"]["comm_MB"] * 1e6) == \
            {"fedavg": 1_093_120, "fedavg(meta)": 1_093_120,
             "meta-sgd": 1_520_640}.get(m, 760_320)
    assert [p.name for p in tmp_path.iterdir()] == ["out"]
    assert [p.name for p in (tmp_path / "out").iterdir()] == \
        ["recommend_compare.json"]


def test_compare_artifacts_tool_on_a_committed_artifact():
    """`tools/compare_artifacts.py` (the replay check against a committed
    artifact): an artifact against itself is equal everywhere, and a
    moved eval accuracy and test accuracy are reported."""
    import copy
    import importlib.util
    import json
    import os
    root = os.path.join(os.path.dirname(__file__), "..")
    spec = importlib.util.spec_from_file_location(
        "compare_artifacts", os.path.join(root, "tools",
                                          "compare_artifacts.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(root, "results", "experiments",
                           "recommend_compare.json")) as f:
        want = json.load(f)
    same = tool.compare(want, want)
    assert same["target_equal"] and same["comm_to_target_equal"]
    for rec in same["methods"].values():
        assert rec["test_acc_equal"] and rec["eval_acc_equal"] == "30 of 30"
        assert not any(rec["worst_rel_gap"].values())
    got = copy.deepcopy(want)
    got["methods"]["maml"]["test_acc"] += 0.01
    got["methods"]["maml"]["history"][1]["eval_acc"] += 0.01
    got["methods"]["maml"]["history"][0]["query_loss"] *= 1.5
    moved = tool.compare(got, want)["methods"]["maml"]
    assert not moved["test_acc_equal"] and moved["eval_acc_equal"] == \
        "29 of 30"
    assert abs(moved["worst_rel_gap"]["query_loss"] - 0.5) < 1e-12
