"""Benchmark orchestrator — one module per paper table/figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run [module] [--device DEV]

Prints ``name,us_per_call,derived`` CSV.  Every module runs on the card
unless --device names another (``--device cpu`` runs the kernels' plain
versions); the Fig. 3, Table I and Table II modules are host NumPy
throughout.  Modules:
  tile_quantization      Fig. 1   (tile/block-policy FLOP overhead)
  precision_scaling      Fig. 3   (speedup over baseline precision)
  clock_sampling         Table I  (scrape-interval noise)
  prediction_accuracy    Table II / Fig. 4 (OFU vs Adjusted OFU accuracy)
  production_correlation Fig. 5 / Table III / SecV-C (608-job fleet)
  operational            Fig. 6 / Fig. 7 / SecVI-C (case studies)
  fleet_engine           engine, ingest, collector, trace store, serve
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch._device import resolve_device


def modules() -> list:
    from repro_torch.benchmarks import (clock_sampling, fleet_engine,
                                        operational, precision_scaling,
                                        prediction_accuracy,
                                        production_correlation,
                                        tile_quantization)
    return [tile_quantization, precision_scaling, clock_sampling,
            prediction_accuracy, production_correlation, operational,
            fleet_engine]


def main(argv=None) -> dict:
    """Run the modules (all, or the one named) on the device; print the
    CSV; return {module: (rows, wall seconds)}.  Exits non-zero after the
    rest have run if any module raised."""
    ap = argparse.ArgumentParser()
    ap.add_argument("module", nargs="?", default=None,
                    help="run only this module")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("name,us_per_call,derived")
    failures = 0
    out = {}
    for mod in modules():
        name = mod.__name__.split(".")[-1]
        if args.module and args.module != name:
            continue
        t0 = time.perf_counter()
        try:
            rows = mod.run(device=device)
            for row in rows:
                print(row.csv())
            out[name] = (rows, time.perf_counter() - t0)
        except Exception as e:
            failures += 1
            print(f"{name},0,ERROR:{type(e).__name__}:{e}")
            traceback.print_exc(file=sys.stderr)
    if failures:
        raise SystemExit(f"{failures} benchmark modules failed")
    return out


if __name__ == '__main__':
    main()
