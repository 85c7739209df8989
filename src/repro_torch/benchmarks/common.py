"""Shared benchmark plumbing: each benchmark module exposes
run(device=None) -> rows, where a row is (name, us_per_call, derived) —
us_per_call times the core operation, derived carries the
paper-comparable numbers.

Suites that publish machine-readable results share `BENCH_fleet.json`
(one file, merged BY CASE NAME so whichever suite runs second never
clobbers the other's rows): record cases with `bench_case` and flush
with `merge_bench_json`.

A timed function that touches the card calls `sync` before it returns,
so `timed` reads the work and not only its launches."""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Row:
    name: str
    us_per_call: float
    derived: str

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.2f},{self.derived}"


def timed(fn, *args, repeat: int = 3, **kw):
    """(result, us_per_call) for the fastest of `repeat` calls."""
    best = float("inf")
    out = None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        best = min(best, time.perf_counter() - t0)
    return out, best * 1e6


def sync(device) -> None:
    """Wait for the work queued on `device` (a no-op off the card)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host(x) -> np.ndarray:
    """A tensor's values as a host NumPy array (arrays pass through)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def bench_case(cases: list, name: str, median: float, units: str,
               **metrics) -> None:
    """Record one benchmark case: print the BENCH json line (the driver
    greps for it) and append the structured row to `cases` for
    `merge_bench_json`."""
    print("BENCH " + json.dumps({"name": name, **metrics}))
    cases.append({"name": name, "median": median, "units": units,
                  "metrics": metrics})


def merge_bench_json(cases: list, *, suite: str = "fleet_engine") -> str:
    """Merge `cases` into BENCH_fleet.json BY NAME (path overridable via
    the BENCH_FLEET_JSON env var).  Several suites share the file —
    fleet_engine and production_correlation — and whichever runs second
    must not clobber the others' rows."""
    path = os.environ.get("BENCH_FLEET_JSON", "BENCH_fleet.json")
    doc = {"schema": 1, "suite": suite, "cases": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev.get("cases"), list):
                doc = prev
        except (json.JSONDecodeError, OSError):
            pass                 # corrupt file: rewrite from scratch
    fresh = {c["name"] for c in cases}
    doc["cases"] = [c for c in doc["cases"]
                    if c.get("name") not in fresh] + cases
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return path
