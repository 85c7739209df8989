"""OFU regression detection (paper §VI-A: the 2.5× Gloo-debug case).

A rolling-window change detector over a job's OFU time series: flags
sustained collapses (ratio of reference window to current window above a
threshold) and recoveries, and quantifies the regression factor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Regression:
    start_idx: int
    end_idx: Optional[int]          # None = ongoing
    factor: float                   # reference_ofu / regressed_ofu
    ref_ofu: float
    low_ofu: float


def detect_regressions(ofu: np.ndarray, *, window: int = 10,
                       factor_threshold: float = 1.5,
                       min_duration: int = 5) -> list[Regression]:
    """Scan an OFU series for sustained drops vs the trailing healthy mean."""
    ofu = np.asarray(ofu, float)
    out: list[Regression] = []
    ref = None
    in_reg = None
    lows: list[float] = []
    for i in range(len(ofu)):
        w = ofu[max(0, i - window):i + 1]
        cur = float(np.mean(w[-min(len(w), min_duration):]))
        if ref is None and i >= window:
            ref = float(np.mean(ofu[:window]))
        if ref is None:
            continue
        if in_reg is None:
            if cur < ref / factor_threshold:
                in_reg = i - min_duration + 1
                lows = [cur]
            else:
                ref = 0.9 * ref + 0.1 * cur  # track slow drift
        else:
            lows.append(cur)
            if cur > ref / factor_threshold:
                low = float(np.mean(lows[:-1])) if len(lows) > 1 else lows[0]
                out.append(Regression(in_reg, i, ref / max(low, 1e-9),
                                      ref, low))
                in_reg = None
    if in_reg is not None:
        low = float(np.mean(lows))
        out.append(Regression(in_reg, None, ref / max(low, 1e-9), ref, low))
    return out


def scan_rollup(roll, *, jobs=None, **detector_kw) -> dict[str, list[Regression]]:
    """Run the detector over every job series in a rollup (simulated,
    replayed, windowed, or tree-reduced from many hosts — the detector
    never knows).

    Returns {job_id: regressions} for jobs with at least one detection —
    the sweep a fleet dashboard performs after each reduction round.
    `jobs` restricts the sweep (a continuous collector scans only streams
    that are still live).  Detection indices are relative to the rollup's
    stored buckets; add `roll.bucket0` for absolute bucket indices when
    scanning a windowed rollup.
    """
    out = {}
    for jid in (roll.jobs if jobs is None else jobs):
        regs = detect_regressions(roll.job_ofu(jid), **detector_kw)
        if regs:
            out[jid] = regs
    return out
