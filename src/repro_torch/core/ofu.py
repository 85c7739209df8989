"""Overall FLOP Utilization (OFU) — the paper's core metric, Eq. 1/8/9/12.

OFU consumes ONLY hardware-counter streams (matrix-pipe duty cycle + clock
point samples); it never sees model architecture.  Everything model-aware
(App MFU, FLOPs counters) lives in repro_torch.flops — keeping the paper's trust
boundary between the two estimators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec


# ---------------------------------------------------------------------------
# Eq. 1: OFU = TPA × f / f_max
# ---------------------------------------------------------------------------
def ofu_point(tpa: float, clock_mhz: float,
              chip: ChipSpec = DEFAULT_CHIP) -> float:
    """One OFU reading from one (TPA, clock) counter pair, in [0, 1]."""
    return float(tpa) * float(clock_mhz) / chip.f_max_mhz


def ofu_series(tpa, clock_mhz, chip: ChipSpec = DEFAULT_CHIP):
    """Eq. 11: element-wise OFU over aligned counter series, in float64.

    Torch tensors stay on their device (a CUDA grid is never copied to
    the host); anything else goes through NumPy."""
    if isinstance(tpa, torch.Tensor):
        return tpa.double() * clock_mhz.double() / chip.f_max_mhz
    return np.asarray(tpa, float) * np.asarray(clock_mhz, float) / chip.f_max_mhz


def ofu_mean(tpa, clock_mhz, chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Job-level OFU: mean over all devices × time samples (paper Eq. 11),
    reduced on the counters' own device."""
    ofu = ofu_series(tpa, clock_mhz, chip)
    if isinstance(ofu, torch.Tensor):
        return float(ofu.mean())
    return float(np.mean(ofu))


# ---------------------------------------------------------------------------
# Eq. 8: tile-quantization-adjusted OFU
# ---------------------------------------------------------------------------
def adjusted_ofu(ofu: float, theoretical_flops: float,
                 profiled_flops: float) -> float:
    """OFU_adj = OFU × FLOPs_theoretical / FLOPs_profiled."""
    if profiled_flops <= 0:
        return ofu
    return ofu * theoretical_flops / profiled_flops


# ---------------------------------------------------------------------------
# Eq. 12: effective peak for mixed precision (FLOPs-weighted harmonic mean)
# ---------------------------------------------------------------------------
def effective_peak(flops_by_precision: dict[str, float],
                   chip: ChipSpec = DEFAULT_CHIP) -> float:
    """P_eff = Σ F_i / Σ (F_i / P_i) in TFLOP/s."""
    num = sum(flops_by_precision.values())
    den = sum(f / chip.peak_tflops(p)
              for p, f in flops_by_precision.items() if f > 0)
    return num / den if den else chip.peak_tflops()


def mfu_from_throughput(tflops_per_chip: float, peak_tflops: float) -> float:
    """Eq. 10 (normalized to one chip): achieved / peak."""
    return tflops_per_chip / peak_tflops


# ---------------------------------------------------------------------------
# Eq. 9 + §V-A accuracy statistics
# ---------------------------------------------------------------------------
def mae(estimates: Sequence[float], truth: Sequence[float]) -> float:
    e, t = np.asarray(estimates, float), np.asarray(truth, float)
    return float(np.mean(np.abs(e - t)))


def pct_within(estimates: Sequence[float], truth: Sequence[float],
               bound_pp: float) -> float:
    """Fraction of samples with |error| <= bound (same units as inputs)."""
    e, t = np.asarray(estimates, float), np.asarray(truth, float)
    return float(np.mean(np.abs(e - t) <= bound_pp))


def hist_percentile(edges: np.ndarray, counts: np.ndarray,
                    q: float) -> float:
    """Percentile q (0–100) from a weighted histogram, by linear
    interpolation within the containing bin.

    This is the streaming-rollup primitive: fleet-scale OFU percentiles are
    maintained as fixed-size per-bucket histograms (O(1) memory per time
    bucket regardless of device count), and read out through this function.
    Returns NaN for an empty histogram.
    """
    counts = np.asarray(counts, float)
    edges = np.asarray(edges, float)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    cum = np.cumsum(counts)
    target = total * min(max(q, 0.0), 100.0) / 100.0
    i = int(np.searchsorted(cum, target))
    i = min(i, len(counts) - 1)
    prev = cum[i - 1] if i > 0 else 0.0
    frac = (target - prev) / counts[i] if counts[i] > 0 else 0.0
    return float(edges[i] + frac * (edges[i + 1] - edges[i]))


def hist_percentile_grid(edges: np.ndarray, counts: np.ndarray,
                         qs: Sequence[float]) -> np.ndarray:
    """Vectorized `hist_percentile` over a stack of histograms.

    counts: (B, bins) weighted histograms (one row per time bucket);
    qs: percentiles (0–100).  Returns (len(qs), B) — every bucket's
    percentile read out in one cumulative-sum pass, NaN where a bucket is
    empty.  Semantics match the scalar readout exactly (linear
    interpolation within the containing bin).
    """
    counts = np.asarray(counts, float)
    edges = np.asarray(edges, float)
    B, bins = counts.shape
    qs_arr = np.clip(np.asarray(qs, float), 0.0, 100.0)
    if B == 0 or len(qs_arr) == 0:
        return np.empty((len(qs_arr), B))
    cum = np.cumsum(counts, axis=1)                      # (B, bins)
    total = cum[:, -1]
    target = total[None, :] * qs_arr[:, None] / 100.0    # (Q, B)
    # first bin with cum >= target (per-row searchsorted, side='left')
    i = np.minimum((cum[None, :, :] < target[:, :, None]).sum(axis=2),
                   bins - 1)                             # (Q, B)
    rows = np.arange(B)[None, :]
    prev = np.where(i > 0, cum[rows, np.maximum(i - 1, 0)], 0.0)
    c = counts[rows, i]
    frac = np.where(c > 0, (target - prev) / np.where(c > 0, c, 1.0), 0.0)
    out = edges[i] + frac * (edges[i + 1] - edges[i])
    out[:, total <= 0] = np.nan
    return out


def pearson_r(a: Sequence[float], b: Sequence[float]) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    a = a - a.mean()
    b = b - b.mean()
    den = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / den) if den else 0.0


@dataclass
class AccuracyReport:
    """Summary row of paper Table II."""

    estimator: str
    mae_pp: float
    within_2pp: float
    within_5pp: float

    @classmethod
    def build(cls, name: str, est_pct: Sequence[float],
              truth_pct: Sequence[float]) -> "AccuracyReport":
        return cls(name, mae(est_pct, truth_pct),
                   pct_within(est_pct, truth_pct, 2.0),
                   pct_within(est_pct, truth_pct, 5.0))
