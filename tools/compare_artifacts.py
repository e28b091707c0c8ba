#!/usr/bin/env python3
"""Hold a comparison record (`run_comparison`'s JSON, as
`python -m repro_torch.launch.compare --sweep D --outdir O` writes it)
against a committed artifact under `results/experiments/`:

    python3 tools/compare_artifacts.py O/sent140_compare.json \\
        results/experiments/sent140_compare.json

Prints, for each method, whether the test accuracy is equal, how many
eval accuracies are equal, and the largest relative gap of every other
float field of the history records; then whether the shared target and
the comm-to-target rows are equal (rows compared without
`client_GFLOPs`, which each package counts its own way). Reads JSON
only; imports neither package.
"""
import argparse
import json


def compare(got: dict, want: dict) -> dict:
    out = {"target_equal": got["target_acc"] == want["target_acc"],
           "methods": {}}
    for m, w in want["methods"].items():
        g = got["methods"][m]
        evals = [(a["eval_acc"], b["eval_acc"])
                 for a, b in zip(g["history"], w["history"])
                 if "eval_acc" in b]
        worst = {}
        for a, b in zip(g["history"], w["history"]):
            for k, v in b.items():
                if isinstance(v, float) and k in a and k != "client_GFLOPs" \
                        and k != "eval_acc":
                    gap = abs(a[k] - v) / max(abs(v), 1e-12)
                    worst[k] = max(worst.get(k, 0.0), gap)
        out["methods"][m] = {
            "test_acc_equal": g["test_acc"] == w["test_acc"],
            "eval_acc_equal": f"{sum(x == y for x, y in evals)} of "
                              f"{len(evals)}",
            "worst_rel_gap": worst}

    def strip(rows):
        return {m: None if r is None else
                {k: v for k, v in r.items() if k != "client_GFLOPs"}
                for m, r in (rows or {}).items()}

    out["comm_to_target_equal"] = \
        strip(got["comm_to_target"]) == strip(want["comm_to_target"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("got")
    ap.add_argument("want")
    args = ap.parse_args(argv)
    with open(args.got) as f:
        got = json.load(f)
    with open(args.want) as f:
        want = json.load(f)
    print(json.dumps(compare(got, want), indent=1))


if __name__ == "__main__":
    main()
