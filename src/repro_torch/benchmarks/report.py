"""The dry-run and roofline tables of the port's dry-run records, in
Markdown.  Usage:
  PYTHONPATH=src python -m repro_torch.benchmarks.report [dir]

The roofline is against the H100 SXM data sheet's peaks
(`roofline.H100_SXM`); the records' FLOPs and bytes are counts from a
fake trace (`repro_torch.launch.dryrun`)."""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.benchmarks.roofline import H100_SXM, roofline_terms


def load(d: str) -> dict:
    recs = {}
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs[os.path.basename(p)[:-5]] = json.load(f)
    return recs


def dryrun_table(recs) -> str:
    out = ["| cell | mesh | compile | peak mem/dev | HLO FLOPs/dev | "
           "coll bytes/dev | AG/AR/RS/A2A/CP count |",
           "|---|---|---|---|---|---|---|"]
    for tag, r in recs.items():
        if r.get("skipped"):
            out.append(f"| {r['arch']} {r['shape']} | "
                       f"{'2x16x16' if tag.endswith('multi') else '16x16'} | "
                       "— | — | — | — | skipped (sub-quadratic rule) |")
            continue
        c = r["hlo"]["collective_counts"]
        out.append(
            f"| {r['arch']} {r['shape']} | {r['mesh']} | "
            f"{r['compile_s']:.0f}s | "
            f"{r['memory']['peak_bytes'] / 2**30:.1f} GiB | "
            f"{r['hlo']['flops']:.2e} | "
            f"{sum(r['hlo']['collective_bytes'].values()):.2e} | "
            f"{c['all-gather']:.0f}/{c['all-reduce']:.0f}/"
            f"{c['reduce-scatter']:.0f}/{c['all-to-all']:.0f}/"
            f"{c['collective-permute']:.0f} |")
    return "\n".join(out)


def roofline_table(recs, mesh_suffix="_single",
                   peaks: tuple = H100_SXM) -> str:
    out = ["| cell | compute | memory | collective | dominant | "
           "6ND/HLO | roofline frac | mem/dev |",
           "|---|---|---|---|---|---|---|---|"]
    for tag, r in recs.items():
        if not tag.endswith(mesh_suffix):
            continue
        name = f"{r['arch']} {r['shape']}"
        if r.get("skipped"):
            out.append(f"| {name} | — | — | — | skipped | — | — | — |")
            continue
        t = roofline_terms(r, peaks)
        out.append(
            f"| {name} | {t['compute_s'] * 1e3:.1f} ms | "
            f"{t['memory_s'] * 1e3:.1f} ms | "
            f"{t['collective_s'] * 1e3:.1f} ms | "
            f"{t['dominant'].replace('_s', '')} | "
            f"{t['useful_ratio'] * 100:.0f}% | "
            f"{t['roofline_fraction'] * 100:.1f}% | "
            f"{t['peak_mem_gib']:.1f} GiB |")
    return "\n".join(out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "experiments/dryrun_torch"
    recs = load(d)
    print("### Dry-run table (one device; counts from a fake trace)\n")
    print(dryrun_table(recs))
    print("\n### Roofline table (against the H100 SXM data sheet's peaks)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
