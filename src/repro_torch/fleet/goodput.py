"""Fleet-wide goodput rollup (paper §II: the efficiency-review vantage).

Aggregates chip-hour-weighted OFU across all jobs, reports coverage (the
80%-of-GPU-hours-invisible problem app-level MFU has, vs OFU's 100%), and
ranks the largest recoverable-waste pools.

Two input domains, one report shape:

  * `rollup(jobs)` — batch, over simulated/observed `JobTelemetry`;
    weights are true chip-hours.
  * `from_rollup(roll)` — streaming, over a `StreamingRollup` (plain,
    windowed, or tree-reduced from many hosts); weights are the rollup's
    chip-weighted sample mass.  Because the underlying histograms merge
    associatively, this view is MERGE-CONSISTENT: goodput over a
    tree-reduced fleet equals goodput over single-process ingest
    (property-tested in tests/test_goodput.py).

`scan_goodput` is the third detector the scorecard scores: a fleet-level
OFU-drop scan (Google's ML Productivity Goodput decomposition collapses
to "chip-hours not converted to useful flops" here), reusing the
regression change detector over the fleet-wide bucket series.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fleet.regression import detect_regressions


@dataclass
class FleetRollup:
    chip_hours: float
    weighted_ofu: float
    app_mfu_coverage: float       # fraction of chip-hours with app MFU
    ofu_coverage: float           # always 1.0 — the paper's point
    waste_ranking: list           # [(job_id, wasted_chip_hours), ...]

    def summary(self) -> str:
        top = ", ".join(f"{j}:{w:.0f}ch" for j, w in self.waste_ranking[:3])
        return (f"fleet chip_hours={self.chip_hours:.0f} "
                f"ofu={self.weighted_ofu * 100:.1f}% "
                f"app_mfu_coverage={self.app_mfu_coverage * 100:.0f}% "
                f"ofu_coverage=100% top_waste=[{top}]")


def rollup(jobs, *, healthy_ofu: float = 0.40,
           has_app_mfu=lambda j: j.spec.flops_variant != "none") -> FleetRollup:
    """jobs: iterable of JobTelemetry."""
    chip_hours = 0.0
    ofu_weighted = 0.0
    covered = 0.0
    waste = []
    for j in jobs:
        ch = j.spec.chips * j.spec.duration_s / 3600.0
        chip_hours += ch
        ofu = j.ofu
        ofu_weighted += ofu * ch
        if has_app_mfu(j):
            covered += ch
        waste.append((j.spec.job_id, max(0.0, healthy_ofu - ofu)
                      / healthy_ofu * ch))
    waste.sort(key=lambda t: -t[1])
    return FleetRollup(
        chip_hours=chip_hours,
        weighted_ofu=ofu_weighted / max(chip_hours, 1e-9),
        app_mfu_coverage=covered / max(chip_hours, 1e-9),
        ofu_coverage=1.0,
        waste_ranking=waste,
    )


def from_rollup(roll, *, healthy_ofu: float = 0.40) -> FleetRollup:
    """The same goodput report off a `StreamingRollup`/`WindowedRollup`.

    Weights are the rollup's chip-weighted sample mass (all-time totals
    for windowed rollups, so eviction never shrinks a job's footprint);
    app-MFU coverage comes from the metadata registered at ingest.
    Jobs whose scope holds no samples yet contribute nothing — an empty
    or all-idle rollup reports weighted_ofu 0.0 with zero weight rather
    than NaN.
    """
    if not np.isfinite(healthy_ofu) or healthy_ofu <= 0:
        raise ValueError(f"healthy_ofu={healthy_ofu} must be a positive "
                         "finite number")
    windowed = getattr(roll, "retain", None) is not None
    total_w = covered_w = ofu_w = 0.0
    waste = []
    for jid in sorted(roll.jobs):
        if windowed:
            at = roll.job_alltime(jid, qs=())
            w, mean = float(at["weight"]), float(at["mean"])
        else:
            s = roll.job_stats(jid, qs=())
            w = float(np.nansum(s.weight))
            mean = float(np.nansum(s.mean * s.weight) / w) if w > 0 \
                else float("nan")
        if w <= 0 or not np.isfinite(mean):
            continue
        total_w += w
        ofu_w += mean * w
        if roll.job_meta(jid) is not None:
            covered_w += w
        waste.append((jid, max(0.0, healthy_ofu - mean) / healthy_ofu * w))
    waste.sort(key=lambda t: -t[1])
    return FleetRollup(
        chip_hours=total_w,
        weighted_ofu=ofu_w / total_w if total_w > 0 else 0.0,
        app_mfu_coverage=covered_w / total_w if total_w > 0 else 0.0,
        ofu_coverage=1.0,
        waste_ranking=waste,
    )


#: package-level alias (`repro_torch.fleet.goodput_from_rollup`) — "from_rollup"
#: alone is too generic a name to hoist out of this module
goodput_from_rollup = from_rollup


# ---------------------------------------------------------------------------
# Goodput drop detection (the scorecard's third detector)
# ---------------------------------------------------------------------------
@dataclass
class GoodputEvent:
    """A sustained fleet-wide OFU drop: chip-hours burning without the
    matrix pipes converting them — the goodput decomposition's 'lost
    productivity' term surfacing in counters."""

    start_idx: int
    end_idx: int | None             # None = ongoing
    drop_frac: float                # 1 - low/ref (fraction of OFU lost)
    ref_ofu: float
    low_ofu: float


def scan_goodput(roll, *, drop_threshold: float = 0.25, window: int = 4,
                 min_duration: int = 2) -> list[GoodputEvent]:
    """Scan the FLEET-wide bucket series for sustained OFU drops.

    A drop of more than `drop_threshold` (fractional) versus the trailing
    healthy fleet level, sustained `min_duration` buckets, is an event.
    Runs the shared `detect_regressions` change detector under the hood
    (a relative drop of d is a regression factor of 1/(1-d)), so the
    goodput detector inherits its drift tracking and recovery semantics.
    Indices are rollup-relative; add `roll.bucket0` for absolute buckets.
    """
    if not 0.0 < drop_threshold < 1.0:
        raise ValueError(f"drop_threshold={drop_threshold} must be in "
                         "(0, 1)")
    series = roll.fleet_ofu()
    if not len(series) or not np.isfinite(series).any():
        return []
    regs = detect_regressions(series, window=window,
                              factor_threshold=1.0 / (1.0 - drop_threshold),
                              min_duration=min_duration)
    return [GoodputEvent(r.start_idx, r.end_idx,
                         drop_frac=1.0 - r.low_ofu / max(r.ref_ofu, 1e-9),
                         ref_ofu=r.ref_ofu, low_ofu=r.low_ofu)
            for r in regs]
