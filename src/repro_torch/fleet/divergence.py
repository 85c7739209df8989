"""MFU-vs-OFU divergence triage (paper §V-B/§V-C).

Given a population of jobs with both app-reported MFU and counter-derived
OFU, compute the correlation table, flag jobs whose divergence exceeds a
threshold (the FLOPs-miscalculation signature), and report the correlation
with/without the flagged set — the paper's r = 0.53 -> 0.78 move.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.ofu import mae, pearson_r


@dataclass
class JobPoint:
    job_id: str
    arch: str
    chips: int
    mfu: float      # fraction
    ofu: float      # fraction
    flops_variant: str = "exact"

    @property
    def abs_err(self) -> float:
        return abs(self.mfu - self.ofu)

    @property
    def rel_err(self) -> float:
        return abs(self.mfu - self.ofu) / max(self.ofu, 1e-6)


@dataclass
class DivergenceReport:
    r_all: float
    r_clean: float
    mae_all: float
    flagged: list
    frac_within_10pp: float
    frac_over_20pp: float
    by_scale: dict

    def summary(self) -> str:
        lines = [
            f"jobs_r_all={self.r_all:.3f} r_after_exclusion={self.r_clean:.3f}",
            f"mae={self.mae_all * 100:.1f}pp "
            f"within10pp={self.frac_within_10pp * 100:.1f}% "
            f"over20pp={self.frac_over_20pp * 100:.1f}% "
            f"flagged={len(self.flagged)}",
        ]
        for chips, (n, m, e) in sorted(self.by_scale.items()):
            lines.append(f"  chips={chips:>5d} jobs={n:>4d} "
                         f"mfu={m * 100:5.1f}% abs_err={e * 100:5.1f}pp")
        return "\n".join(lines)


#: Jobs whose OFU sits below this fraction are too idle to triage: the
#: rel_err denominator is numerically meaningless there (a parked job
#: with OFU=1e-4 and any nonzero reported MFU looks like a 1000x
#: miscalculation).  Sub-floor jobs still count toward the correlation
#: and error statistics — they are only exempt from FLAGGING.
DEFAULT_OFU_FLOOR = 0.02


def _empty_report() -> DivergenceReport:
    """NaN-free placeholder for an empty population — every field a
    strict-JSON serializer can pass through unchanged."""
    return DivergenceReport(r_all=0.0, r_clean=0.0, mae_all=0.0,
                            flagged=[], frac_within_10pp=1.0,
                            frac_over_20pp=0.0, by_scale={})


def analyze(jobs: list, *, flag_rel_err: float = 0.30,
            ofu_floor: float = DEFAULT_OFU_FLOOR) -> DivergenceReport:
    """Flag jobs with relative divergence > flag_rel_err (miscalc signature).

    Jobs with OFU below `ofu_floor` are never flagged (their rel_err is
    dominated by the denominator floor, not by miscalculation), and
    degenerate populations (empty, single job, zero variance) yield
    finite zero-correlation defaults rather than NaN — the report must
    survive `json.dumps(allow_nan=False)` on the serve path.
    """
    if not jobs:
        return _empty_report()
    mfu = np.array([j.mfu for j in jobs])
    ofu = np.array([j.ofu for j in jobs])
    err = np.abs(mfu - ofu)

    flagged = [j for j in jobs
               if j.ofu >= ofu_floor and j.rel_err > flag_rel_err]
    flagged_ids = {j.job_id for j in flagged}
    clean = [j for j in jobs if j.job_id not in flagged_ids]

    by_scale: dict = {}
    for chips in sorted({j.chips for j in jobs}):
        grp = [j for j in jobs if j.chips == chips]
        by_scale[chips] = (len(grp),
                           float(np.mean([j.mfu for j in grp])),
                           float(np.mean([j.abs_err for j in grp])))

    # pearson_r already returns 0.0 on a zero-variance denominator; the
    # len guards keep the <2-sample mean subtraction from warning/NaN-ing
    return DivergenceReport(
        r_all=pearson_r(mfu, ofu) if len(jobs) >= 2 else 0.0,
        r_clean=pearson_r([j.mfu for j in clean], [j.ofu for j in clean])
        if len(clean) >= 2 else 0.0,
        mae_all=float(err.mean()),
        flagged=flagged,
        frac_within_10pp=float(np.mean(err <= 0.10)),
        frac_over_20pp=float(np.mean(err > 0.20)),
        by_scale=by_scale,
    )


def analyze_rollup(roll, *, flag_rel_err: float = 0.30,
                   ofu_floor: float = DEFAULT_OFU_FLOOR,
                   empty_ok: bool = False) -> Optional[DivergenceReport]:
    """Triage straight off a StreamingRollup (simulated, replayed, or
    tree-reduced): uses the rollup's per-job OFU plus the app-reported MFU
    registered at ingest (add_job, or add_grid(app_mfu=...) for traces).

    empty_ok=True returns None instead of raising when no job carries MFU
    metadata — the continuous-collector case, where triage runs every
    round whether or not MFU-reporting jobs have appeared yet."""
    pts = roll.to_job_points()
    if not pts:
        if empty_ok:
            return None
        raise ValueError(
            "rollup has no jobs with app-MFU metadata; ingest via add_job "
            "or add_grid(app_mfu=...) before divergence triage")
    return analyze(pts, flag_rel_err=flag_rel_err, ofu_floor=ofu_floor)
