"""Readings that set a cell's limits: the program's, the control's and
the planted faults', each against the f32 reference, seed by seed.

    python3 bench/control.py --workload <name> --seeds 11 12 13 [--out f]

Run on the card at the cell's own size; not part of the benchmark's
runs.  Each driver's `readings` gives the numbers of each role; one
JSON line a seed on standard output (and appended to --out): each
role's numbers as [value, where], and under "fails" those over the
cell's limits.

  training  "program": the program's set-up steps; "control": the
            reference computed with fp8 matrix products in the program's
            place; "half_batch": the reference with the loss's mean
            taken over half the batch (half the positions at B 1).  A
            state left unchanged reads change_gap 1 by definition and
            needs no run.
  serving   the cell's own comparison: blocks of requests served by the
            program, as many as a run scores, sampled as a run samples
            them; "program": the gap of its served tokens; "control":
            the gap of the tokens that fp8 products put first at the
            same last positions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import compare
import harness
import run
from reference import ops


def _roles(cell, numbers: dict) -> dict:
    return {k: {"numbers": {n: list(v) for n, v in nums.items()},
                "fails": sorted(n for n, c in compare.checks(
                    nums, cell.limits).items() if not c["ok"])}
            for k, nums in numbers.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 3
    run._environment()
    dev = torch.device("cuda", 0)
    ops.strict_f32()
    cell = harness.load_cell(run.ROOT, args.workload)
    cfg = harness.model_config(cell)
    drv = harness.driver(run.ROOT, cell.mix["kind"])
    for seed in args.seeds:
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                **_roles(cell, drv.readings(cell, cfg, seed, dev)),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
