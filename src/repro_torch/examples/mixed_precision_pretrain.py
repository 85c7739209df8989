"""Mixed-precision pretraining telemetry (paper §VI-B, Fig. 7).

A hybrid Mamba-Transformer pretrain alternates between mixed precision
(bf16+int8) and bf16-only debugging periods.  Observed TFLOP/s stays
constant, so the app-reported MFU jumps whenever the effective peak
(Eq. 12 harmonic mean) drops — and OFU, which never sees the numeric
format, tracks the same jump from the hardware side.

  PYTHONPATH=src python -m repro_torch.examples.mixed_precision_pretrain \\
      [--device cpu]

The job's counters are simulated on the card unless --device names
another device.
"""
from __future__ import annotations

import argparse

from repro_torch.core.ofu import effective_peak, ofu_series, pearson_r
from repro_torch.fleet.jobs import JobSpec, simulate_job

MODES = {"mixed (bf16+int8)": {"bf16": 0.4, "int8": 0.6},
         "bf16-only (debug)": {"bf16": 1.0}}
TPUT = 52.0  # constant achieved TFLOP/s per chip across both modes


def main(argv=None) -> float:
    """Print each mode's MFU and OFU; return the pointwise r."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args(argv)
    print(f"constant observed throughput: {TPUT:.0f} TFLOP/s/chip "
          f"on 6,144 chips\n")
    series_m, series_o = [], []
    for name, mix in MODES.items():
        peff = effective_peak(mix)
        mfu = TPUT / peff
        tel = simulate_job(JobSpec(name, "zamba2-7b", chips=6144,
                                   precisions=mix, true_duty=mfu,
                                   duration_s=900), max_devices=2,
                           device=args.device)
        print(f"{name:20s} P_eff={peff:6.1f} TF/s  "
              f"app_mfu={mfu * 100:5.1f}%  ofu={tel.ofu * 100:5.1f}%  "
              f"gap={(abs(tel.ofu - mfu)) * 100:.2f}pp")
        s = tel.device_series[0]
        series_o.extend(ofu_series(s.tpa, s.clock_mhz).cpu().numpy())
        series_m.extend([mfu] * len(s.tpa))

    r = pearson_r(series_m, series_o)
    print(f"\nOFU tracks the precision-mode MFU shift with no knowledge of "
          f"the numeric format (pointwise r={r:.3f}).")
    return r


if __name__ == "__main__":
    main()
