"""Roofline analysis per (arch × shape) from the dry run's records.

Three terms per cell, for one device:
  compute    = traced FLOPs / peak FLOP/s
  memory     = traced HBM traffic bytes / HBM bytes/s
  collective = collective wire bytes / link bytes/s

The records (`repro_torch.launch.dryrun`) describe one H100 of the
production mesh (its FLOPs, bytes and collective wire bytes), or one
card alone, so `run` reads them against the H100 SXM data sheet's peaks
(`H100_SXM`: dense bf16 tensor-core rate, HBM rate, NVLink each way);
`roofline_terms` takes any peaks.  Their FLOPs and bytes are counts from
a fake trace, and the bounds are the data sheet's, not a measurement.
The mesh is the reference's: its 16-wide model axis spans two 8-GPU
NVLink domains on H100s, and every collective is still read at the one
NVLink rate.  Also reported:
MODEL_FLOPS = 6·N_active·D and its ratio to the traced FLOPs
(remat/redundancy visibility), and what would move the dominant term.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.benchmarks.common import Row

#: H100 SXM data sheet (dense, no sparsity; at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: f32 outside the tensor cores (what true-f32 work can use)
FP32_FLOP_PER_S = 67e12
#: peaks by input type: dense tensor-core bf16 and int8, f32 SIMT
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": FP32_FLOP_PER_S, "int8": 1979e12}
#: NVLink to the other cards of the host, each way
NVLINK_BYTES_PER_S = 450e9
#: (peak FLOP/s, HBM bytes/s, link bytes/s) of one H100 SXM in bf16
H100_SXM = (PEAK_OPS_PER_S["bf16"], HBM_BYTES_PER_S, NVLINK_BYTES_PER_S)

DRYRUN_DIR = os.environ.get("DRYRUN_DIR", "experiments/dryrun_torch")


def roofline_terms(rec: dict, peaks: tuple = H100_SXM) -> dict:
    """Compute, memory and collective times of one record, against
    `peaks` = (FLOP/s, HBM bytes/s, link bytes/s)."""
    peak, hbm, link = peaks
    chips = rec["devices"]
    flops_dev = rec["hlo"]["flops"]
    bytes_dev = rec["hlo"]["traffic_bytes"]
    coll_dev = sum(rec["hlo"]["collective_bytes"].values())

    compute_s = flops_dev / peak
    memory_s = bytes_dev / hbm
    coll_s = coll_dev / link
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, coll_s)

    model_flops = rec["model_flops_6nd"]
    # useful fraction: model FLOPs per device vs traced FLOPs per device
    useful = (model_flops / chips) / flops_dev if flops_dev else 0.0
    # roofline fraction: time the useful math needs at peak / bound time
    frac = ((model_flops / chips) / peak) / bound if bound else 0.0
    return {**terms, "dominant": dom, "bound_s": bound,
            "model_flops": model_flops, "useful_ratio": useful,
            "roofline_fraction": frac,
            "peak_mem_gib": rec["memory"]["peak_bytes"] / 2 ** 30}


_ADVICE = {
    "compute_s": "lower executed FLOPs: cut remat recompute / padded tiles",
    "memory_s": "cut HBM traffic: fuse casts, shrink fp32 intermediates, "
                "bigger microbatch reuse",
    "collective_s": "restructure sharding: fewer/overlapped all-gathers, "
                    "reduce-scatter grads, SP boundary placement",
}


def run(device=None) -> list[Row]:
    """One row a record in DRYRUN_DIR, against the H100 SXM's peaks.
    Reads files only: `device` is taken for the suite's signature."""
    rows = []
    cells = sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json")))
    if not cells:
        return [Row("roofline.missing", 0.0,
                    f"no dry-run artifacts in {DRYRUN_DIR}; run "
                    "python -m repro_torch.launch.dryrun --all")]
    for path in cells:
        with open(path) as f:
            rec = json.load(f)
        tag = os.path.basename(path)[:-5]
        if rec.get("skipped"):
            rows.append(Row(f"roofline.{tag}", 0.0, "skipped (sub-quadratic "
                            "rule, DESIGN.md)"))
            continue
        t = roofline_terms(rec)
        rows.append(Row(
            f"roofline.{tag}", 0.0,
            f"compute={t['compute_s'] * 1e3:.2f}ms "
            f"memory={t['memory_s'] * 1e3:.2f}ms "
            f"collective={t['collective_s'] * 1e3:.2f}ms "
            f"dominant={t['dominant'].replace('_s', '')} "
            f"roofline_frac={t['roofline_fraction'] * 100:.1f}% "
            f"useful={t['useful_ratio'] * 100:.1f}% "
            f"mem={t['peak_mem_gib']:.1f}GiB | "
            f"{_ADVICE[t['dominant']]}"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
