"""Prometheus-style scraper over counter backends (paper §V-B telemetry).

Enforces the §IV-C rule: scrape interval must be ≤ the hardware averaging
window (30 s), otherwise readings become averages-of-averages.

Also home of the two aligned-counter containers the whole pipeline speaks:
`ScrapeSeries` (one device) and `DeviceGrid` (a batched device group, the
return type of every `TelemetrySource`).  Rollups and detectors consume
these and never learn where the samples came from.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.telemetry.counters import CounterBackend, check_scrape_interval


@dataclass
class ScrapeSeries:
    """Aligned counter series for one device."""

    interval_s: float
    tpa: np.ndarray
    clock_mhz: np.ndarray
    t0_s: float = 0.0            # absolute start of the first window

    def subsample(self, factor: int) -> "ScrapeSeries":
        """Coarser scrape (Table I methodology): keep every factor-th point."""
        return ScrapeSeries(self.interval_s * factor,
                            self.tpa[factor - 1::factor],
                            self.clock_mhz[factor - 1::factor],
                            t0_s=self.t0_s)


@dataclass
class DeviceGrid:
    """Batched scrape result: row d is device d's aligned counter series."""

    interval_s: float
    tpa: np.ndarray              # (n_devices, n_samples)
    clock_mhz: np.ndarray        # (n_devices, n_samples)
    #: absolute start of the first collection window — nonzero when the
    #: grid is a slice of a longer run (e.g. a replayed mid-run trace), so
    #: rollup buckets land at the recorded times, not rebased to zero
    t0_s: float = 0.0

    @property
    def n_devices(self) -> int:
        return self.tpa.shape[0]

    @property
    def times_s(self) -> np.ndarray:
        """Poll instants (window ends) shared by every device."""
        return self.t0_s + (np.arange(self.tpa.shape[1]) + 1) \
            * self.interval_s

    def series(self, d: int) -> ScrapeSeries:
        return ScrapeSeries(self.interval_s, self.tpa[d], self.clock_mhz[d],
                            t0_s=self.t0_s)

    def to_series_list(self) -> list:
        return [self.series(d) for d in range(self.n_devices)]

    @classmethod
    def from_series(cls, series: Sequence[ScrapeSeries]) -> "DeviceGrid":
        """Stack per-device series (must be aligned: same interval/length)."""
        if not series:
            return cls(0.0, np.empty((0, 0)), np.empty((0, 0)))
        iv = series[0].interval_s
        n = len(series[0].tpa)
        t0 = series[0].t0_s
        if any(s.interval_s != iv or len(s.tpa) != n or s.t0_s != t0
               for s in series):
            raise ValueError("cannot stack misaligned ScrapeSeries "
                             "(intervals/lengths/offsets differ)")
        return cls(iv, np.stack([s.tpa for s in series]),
                   np.stack([s.clock_mhz for s in series]), t0_s=t0)


def scrape(backend: CounterBackend, duration_s: float, interval_s: float,
           *, strict: bool = True) -> ScrapeSeries:
    """Collect (TPA, clock) at a fixed interval for duration_s."""
    check_scrape_interval(interval_s, strict=strict)
    n = int(duration_s / interval_s)
    tpa = np.empty(n)
    clk = np.empty(n)
    for i in range(n):
        tpa[i], clk[i] = backend.poll(interval_s)
    return ScrapeSeries(interval_s, tpa, clk)
