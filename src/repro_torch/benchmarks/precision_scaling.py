"""Paper Fig. 3: throughput speedup over the baseline precision vs size.

TPU mapping: fp32 plays TF32's role as the 1x baseline; bf16 = 2x... on
v5e the ladder is fp32(0.25x) : bf16(1x) : int8/fp8(2x) relative to bf16 —
we report speedups over fp32 so the theoretical multipliers are 4x / 8x.
Block-scale bookkeeping (AQT-style int8 scales) erodes small-size speedup,
recovering with K — the paper's NVFP4 SF-overhead effect.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import Row
from repro_torch.core.ofu import ofu_point
from repro_torch.core.peaks import TPU_V5E
from repro_torch.core.tile_quant import (overhead, pick_policy,
                                         scale_factor_overhead)
from repro_torch.telemetry.counters import SimulatedDeviceBackend, StepProfile

SIZES = (512, 1024, 2048, 4096, 8192, 16384)


def _efficiency(n: int, prec: str) -> float:
    """Achieved/peak for a sustained n^3 matmul at precision prec."""
    oh = overhead(n, n, n, pick_policy(n, n, n, prec))
    sf = scale_factor_overhead(n, n, n, prec)
    # theoretical-FLOPs throughput: padded work + SF handling are waste
    return 1.0 / ((1 + oh) * (1 + sf))


def _step_model(n: int, prec: str):
    """(step_time, tpa) for a sustained n^3 matmul at precision prec.

    executed = theoretical x (1+tile_oh); mxu_busy = executed/peak;
    non-MXU time = SF bookkeeping (VPU) + 5% fixed launch overhead.
    """
    oh = overhead(n, n, n, pick_policy(n, n, n, prec))
    sf = scale_factor_overhead(n, n, n, prec)
    theo = 2.0 * n ** 3
    busy = theo * (1 + oh) / (TPU_V5E.peak_tflops(prec) * 1e12)
    step = busy * (1 + sf) / 0.95
    return step, busy / step


def _ofu_of(n: int, prec: str) -> float:
    step, tpa_true = _step_model(n, prec)
    prof = StepProfile(mxu_time_s=tpa_true * step, step_time_s=step)
    be = SimulatedDeviceBackend(prof, seed=n)
    tpa, clk = be.poll(30.0)
    return ofu_point(tpa, clk)


def run(device=None) -> list[Row]:
    """Host NumPy throughout; `device` is the runner's uniform argument."""
    rows = []
    base = "fp32"
    for prec in ("bf16", "int8"):
        meas, ofu_derived = [], []
        for n in SIZES:
            # measured speedup: theoretical-FLOPs throughput ratio
            meas.append(_step_model(n, base)[0] / _step_model(n, prec)[0])
            # OFU-derived: (OFU_p x Peak_p) / (OFU_base x Peak_base)
            ofu_derived.append(
                (_ofu_of(n, prec) * TPU_V5E.peak_tflops(prec))
                / (_ofu_of(n, base) * TPU_V5E.peak_tflops(base)))
        theo = TPU_V5E.peak_tflops(prec) / TPU_V5E.peak_tflops(base)
        rows.append(Row(
            f"fig3.speedup_over_fp32.{prec}", 0.0,
            f"theoretical={theo:.1f}x "
            f"measured@{SIZES[0]}={meas[0]:.2f}x "
            f"measured@{SIZES[-1]}={meas[-1]:.2f}x "
            f"ofu_derived@{SIZES[-1]}={ofu_derived[-1]:.2f}x "
            f"agreement={abs(ofu_derived[-1] - meas[-1]) / meas[-1] * 100:.1f}%"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
