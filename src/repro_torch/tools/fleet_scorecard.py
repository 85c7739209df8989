"""Replay the labeled scenario library and score every detector.

Runs `repro_torch.scenarios.run_scorecard` over the scenario library
(or a subset) on the device (the card unless `--device` names another;
the histogram kernel ingests every replayed grid there), prints one
BENCH line per (scenario, detector) with precision / recall /
time-to-detect, merges the cases into `BENCH_fleet.json` (alongside the
engine benchmark's cases — merge is by case name, so the two suites
coexist), and writes the full scorecard document:

    python -m repro_torch.tools.fleet_scorecard
    python -m repro_torch.tools.fleet_scorecard \
        --scenario gloo_regression_2p5x --json card.json --device cpu

`--engine` takes the reference's engine names; the port has one engine,
the torch engine, which every name runs (the faults are post-hoc, so
the ground truth is the same on all of them).

`--self-check` is the gate: run the whole library and fail (exit 1)
when any pinned precision / recall / time-to-detect floor in
`repro_torch.scenarios.scorecard.FLOORS` regresses.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch._device import resolve_device
from repro_torch.benchmarks.common import merge_bench_json
from repro_torch.scenarios import (FLOORS, check_floors, run_scorecard,
                                   scenario_names)

#: the reference's engine names; each runs the port's torch engine
ENGINES = ("fused", "vector", "scalar", "jax", "torch")


def _bench_cases(doc: dict) -> list:
    """Flatten the scorecard into BENCH_fleet.json case rows — one per
    (scenario, detector), named `scorecard/<scenario>/<detector>`."""
    cases = []
    for scen, entry in sorted(doc["scenarios"].items()):
        for det, s in sorted(entry["detectors"].items()):
            metrics = {"precision": s["precision"], "recall": s["recall"],
                       "ttd_s": s["ttd_s"], "n_alerts": s["n_alerts"],
                       "n_labels": s["n_labels"]}
            cases.append({"name": f"scorecard/{scen}/{det}",
                          "median": s["precision"], "units": "precision",
                          "metrics": metrics})
    return cases


def _merge_bench_json(cases: list) -> str:
    """Merge scorecard cases into BENCH_fleet.json by case name, keeping
    any cases other suites already wrote."""
    return merge_bench_json(cases)


def run(names, *, device=None, json_path=None, write_bench=True) -> int:
    doc = run_scorecard(names, engine="torch", device=resolve_device(device))
    cases = _bench_cases(doc)
    for c in cases:
        print("BENCH " + json.dumps({"name": c["name"], **c["metrics"]}))
    if write_bench:
        path = _merge_bench_json(cases)
        print(f"BENCH-JSON {path} cases={len(cases)}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"scorecard written to {json_path}")
    # a partial run (--scenario) checks only the floors it measured; the
    # full sweep keeps the "missing from scorecard" guard
    floors = FLOORS if names is None else {
        k: v for k, v in FLOORS.items() if k[0] in doc["scenarios"]}
    bad = check_floors(doc, floors)
    for v in bad:
        print(f"FLOOR VIOLATION: {v}", file=sys.stderr)
    n = sum(len(e["detectors"]) for e in doc["scenarios"].values())
    print(f"scorecard: {len(doc['scenarios'])} scenarios, {n} "
          f"(scenario, detector) cells, {len(bad)} floor violations")
    return 1 if bad else 0


def self_check(device=None) -> int:
    """The gate: the whole library must hold every pinned floor."""
    print(f"self-check: {len(scenario_names())} scenarios, "
          f"{len(FLOORS)} pinned floors")
    return run(None, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", choices=scenario_names(),
                    help="score only this scenario (repeatable; "
                         "default: all)")
    ap.add_argument("--engine", default="fused", choices=ENGINES,
                    help="simulation backend: every name runs the torch "
                         "engine (faults are post-hoc, so ground truth "
                         "is identical on all of them)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full scorecard document here")
    ap.add_argument("--no-bench-json", action="store_true",
                    help="skip merging cases into BENCH_fleet.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulation and ingest; "
                         "the card when omitted")
    ap.add_argument("--self-check", action="store_true",
                    help="the gate: full library, fail on any floor "
                         "violation")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check(args.device)
    return run(args.scenario, device=args.device, json_path=args.json,
               write_bench=not args.no_bench_json)


if __name__ == "__main__":
    sys.exit(main())
