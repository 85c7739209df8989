"""Paper Table I: OFU error vs clock scrape interval.

1 s baseline over 3000 s of sustained matmul at three steady sizes plus an
alternating workload; subsample at 5/10/20/30 s and report σ and the 95%
CI of the OFU deviation (in percentage points).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import Row, timed
from repro_torch.core.peaks import TPU_V5E
from repro_torch.telemetry.counters import (Event, SimulatedDeviceBackend,
                                            StepProfile)
from repro_torch.telemetry.scrape import scrape

DURATION_S = 3000.0
INTERVALS = (5, 10, 20, 30)


def _workloads():
    out = {}
    for n in (4096, 8192, 16384):
        # larger matmuls sustain higher duty
        duty = {4096: 0.50, 8192: 0.55, 16384: 0.58}[n]
        out[f"N={n}"] = SimulatedDeviceBackend(
            StepProfile(mxu_time_s=duty * 1.2, step_time_s=1.2),
            seed=n)
    # alternating 16384 <-> 4096 every 10 s
    events = [Event(start_s=t, end_s=t + 10, slowdown=1.18)
              for t in range(10, int(DURATION_S), 20)]
    out["Alt"] = SimulatedDeviceBackend(
        StepProfile(mxu_time_s=0.58 * 1.2, step_time_s=1.2),
        events=events, seed=7)
    return out


def run(device=None) -> list[Row]:
    """Host NumPy throughout; `device` is the runner's uniform argument."""
    rows = []
    for name, be in _workloads().items():
        (base,), us = timed(lambda: (scrape(be, DURATION_S, 1.0),), repeat=1)
        ofu1 = base.tpa * base.clock_mhz / TPU_V5E.f_max_mhz
        for iv in INTERVALS:
            sub = base.subsample(iv)
            ofu_iv = sub.tpa * sub.clock_mhz / TPU_V5E.f_max_mhz
            # windowed deviation: compare window means at matching coverage
            n = min(len(ofu_iv), len(ofu1) // iv)
            dev = []
            for w in range(0, n, max(1, n // 20)):
                a = ofu_iv[w:w + n // 20 or 1].mean()
                b = ofu1[w * iv:(w + (n // 20 or 1)) * iv].mean()
                dev.append((a - b) * 100)
            dev = np.array(dev)
            ci95 = 1.96 * dev.std() / np.sqrt(max(len(dev), 1))
            rows.append(Row(
                f"table1.{name}.interval={iv}s", us / len(ofu1),
                f"sigma={dev.std():.3f}pp ci95=+-{abs(ci95):.3f}pp"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
