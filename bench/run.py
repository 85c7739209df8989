"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Makes the weights and inputs from the
seed on the card, warms up the cell's shapes, measures for the given
seconds, compares what the timed path produced with the plain reference
(`bench/reference/`), and prints one JSON line last on standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number compared
beside its limit, also the last lines on standard error.

Exits non-zero without a result when there is no CUDA device, fewer
than the cell's chips, when the program under test cannot be imported,
or when a forbidden module (JAX, or the JAX package) was imported.
Every build and compile cache lies in fixed folders under `build/`.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    for lib in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[lib] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def _device(wl: dict):
    """The card a cell runs on, or None, the reason on standard error."""
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return None
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['chips']} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return None
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    import harness
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    dev = _device(wl)
    if dev is None:
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test does not import: {e}",
              file=sys.stderr)
        return 4
    torch.set_num_threads(min(4, torch.get_num_threads()))
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), dev, T0)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules were imported: {bad}", file=sys.stderr)
        return 5
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}"
              + (f" at {v['where']}" if v.get("where") else ""),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
