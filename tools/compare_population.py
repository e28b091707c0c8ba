#!/usr/bin/env python3
"""Hold a population sweep record (`python -m repro_torch.launch.compare
--sweep population --outdir O` writes it) against the committed
`results/experiments/population_sent140.json`:

    python3 tools/compare_population.py O/population_sent140.json \\
        results/experiments/population_sent140.json

For each cell: whether the accounting is equal (skipped rounds, dead
round share, mean arrivals, cohort fill, client updates, and the comm
block's selected and arrived totals, quarantine count and MB fields),
then the eval and loss curves side by side: how many points are equal
and the largest gap. For the registry cache: whether hits + misses
(the accesses) are equal, whether hits, misses and evictions are, and
whether the peak stayed under the cap. With two pool workers racing, the
LRU's order (and so the split between hits and misses) may differ from
run to run; the number of accesses may not. Exits 1 if any accounting
field, the access count or the cap does not hold. Reads JSON only;
imports neither package.
"""
import argparse
import json
import sys

CELL_FIELDS = ("rounds", "skipped_rounds", "dead_round_frac",
               "mean_arrived", "cohort_fill", "client_updates")
COMM_FIELDS = ("rounds", "selected_total", "arrived_total", "quarantined",
               "selected", "arrived", "download_MB", "upload_MB", "comm_MB",
               "phi_MB")


def curves(got, want):
    """Two [[round, value], ...] curves side by side -> their points
    (round, got, want), how many are equal and the largest gap."""
    g, w = dict(map(tuple, got)), dict(map(tuple, want))
    pts = [(r, g.get(r), w[r]) for r in sorted(w)]
    gaps = [abs(a - b) for _, a, b in pts if a is not None]
    return {"equal": f"{sum(a == b for _, a, b in pts)} of {len(pts)}",
            "max_gap": max(gaps, default=None), "points": pts}


def compare(got: dict, want: dict) -> dict:
    cells, held = {}, True
    wcells = {c["cell"]: c for c in want["cells"]}
    for g in got["cells"]:
        w = wcells[g["cell"]]
        diff = {k: [g[k], w[k]] for k in CELL_FIELDS if g[k] != w[k]}
        diff.update({f"comm.{k}": [g["comm"].get(k), w["comm"].get(k)]
                     for k in COMM_FIELDS
                     if g["comm"].get(k) != w["comm"].get(k)})
        held &= not diff
        cells[g["cell"]] = {
            "accounting_equal": not diff, "differs": diff,
            "eval_curve": curves(g["eval_curve"], w["eval_curve"]),
            "loss_curve": curves(g["loss_curve"], w["loss_curve"]),
            "final_test_acc": [g["final_test_acc"], w["final_test_acc"]]}
    gc, wc = got["registry_cache"], want["registry_cache"]
    cache = {
        "accesses_equal": gc["hits"] + gc["misses"]
        == wc["hits"] + wc["misses"],
        "hits_misses_evictions_equal": all(
            gc[k] == wc[k] for k in ("hits", "misses", "evictions")),
        "peak_under_cap": gc["peak_resident"] <= gc["cache_clients"],
        "got": gc, "want": wc}
    held &= cache["accesses_equal"] and cache["peak_under_cap"]
    return {"held": held, "cells": cells, "registry_cache": cache}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("got")
    ap.add_argument("want")
    ap.add_argument("--points", action="store_true",
                    help="print every curve point, not only the summary")
    args = ap.parse_args(argv)
    with open(args.got) as f:
        got = json.load(f)
    with open(args.want) as f:
        want = json.load(f)
    out = compare(got, want)
    if not args.points:
        for cell in out["cells"].values():
            for key in ("eval_curve", "loss_curve"):
                cell[key].pop("points")
    print(json.dumps(out, indent=1))
    return 0 if out["held"] else 1


if __name__ == "__main__":
    sys.exit(main())
