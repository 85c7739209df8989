"""Paper §VI (Figs. 6/7): operational case studies.

A. Embodied-agent regression: injected host-sync serialization (the Gloo
   debug-flag case) -> OFU collapse detected by the recovery service,
   2.5x improvement after the fix.
B. Mixed-precision pretraining at 6,144 chips: effective-peak (Eq. 12)
   MFU vs OFU across precision-mode switches; point vs per-job correlation.
C. World-model remat accounting: 3F-billed vs 4F-executed divergence and
   the corrected counter.

Each job's counters are simulated on the device; the per-sample OFU
series come to the host for the detectors and correlations.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.benchmarks.common import Row, host, sync, timed
from repro_torch.core.ofu import effective_peak, ofu_series, pearson_r
from repro_torch.fleet.jobs import JobSpec, build_profile, simulate_job
from repro_torch.fleet.recovery import RecoveryService
from repro_torch.telemetry.counters import Event


def _ofu(tel) -> np.ndarray:
    """The first sampled device's OFU series, on the host."""
    s = tel.device_series[0]
    return host(ofu_series(s.tpa, s.clock_mhz))


def case_a(device) -> list[Row]:
    spec = JobSpec("embodied", "phi-3-vision-4.2b", chips=256,
                   true_duty=0.42, duration_s=3600, scrape_interval_s=30,
                   events=[Event(start_s=0, end_s=2400, slowdown=2.5,
                                 kind="host_sync_debug_flag")])

    def _sim():
        tel = simulate_job(spec, max_devices=2, device=device)
        sync(device)
        return (tel,)

    (tel,), us = timed(_sim, repeat=1)
    ofu = _ofu(tel)
    before = ofu[:80].mean()     # during the debug-flag period
    after = ofu[80:].mean()      # after removing the flag
    svc = RecoveryService(factor_threshold=1.8, sustain_samples=3,
                          cooldown_samples=1000)
    detected_at = None
    # replay as if the healthy period came first, then the regression,
    # mirroring the production timeline (fix deployed -> regression later)
    timeline = np.concatenate([ofu[80:], ofu[:80]])
    for i, v in enumerate(timeline):
        if svc.observe("embodied", float(v)) is not None:
            detected_at = i
            break
    return [Row("fig6.embodied_agent_regression", us,
                f"ofu_during_bug={before * 100:.1f}% "
                f"ofu_after_fix={after * 100:.1f}% "
                f"improvement={after / before:.2f}x "
                f"detected_after_samples={detected_at}")]


def case_b(device) -> list[Row]:
    rng = np.random.default_rng(5)
    n_jobs = 174
    mixed = {"bf16": 0.3, "fp8": 0.5, "int8": 0.2}
    bf16_only = {"bf16": 1.0}
    point_m, point_o = [], []
    job_m, job_o = [], []
    tput = 55.0  # constant TFLOP/s/chip across modes (the paper's probe)
    for j in range(n_jobs):
        mode = mixed if j % 4 else bf16_only
        peff = effective_peak(mode)
        mfu_true = tput / peff
        spec = JobSpec(f"mp{j}", "zamba2-7b", chips=6144,
                       precisions=dict(mode), true_duty=mfu_true,
                       duration_s=600, seed=j)
        ofu = _ofu(simulate_job(spec, max_devices=1, device=device))
        # per-timestep app MFU with measurement noise (90 s emission)
        mfu_pts = mfu_true * (1 + rng.normal(0, 0.06, len(ofu)))
        point_m.extend(mfu_pts)
        point_o.extend(ofu)
        job_m.append(float(np.mean(mfu_pts)))
        job_o.append(float(np.mean(ofu)))
    r_point = pearson_r(point_m, point_o)
    r_job = pearson_r(job_m, job_o)
    # BF16-only vs mixed agreement (paper: within ~1 pp)
    bf_idx = [j for j in range(n_jobs) if j % 4 == 0]
    mx_idx = [j for j in range(n_jobs) if j % 4]
    gap_bf = np.mean([abs(job_m[j] - job_o[j]) for j in bf_idx]) * 100
    gap_mx = np.mean([abs(job_m[j] - job_o[j]) for j in mx_idx]) * 100
    return [Row("fig7.mixed_precision_6144", 0.0,
                f"r_pointwise={r_point:.3f} r_per_job={r_job:.3f} "
                f"bf16_mfu={np.mean([job_m[j] for j in bf_idx]) * 100:.1f}% "
                f"mixed_mfu={np.mean([job_m[j] for j in mx_idx]) * 100:.1f}% "
                f"agreement_bf16={gap_bf:.2f}pp agreement_mixed={gap_mx:.2f}pp")]


def case_c(device) -> list[Row]:
    bad = simulate_job(JobSpec("wfm", "phi-3-vision-4.2b", chips=256,
                               true_duty=0.36, duration_s=600, remat=True),
                       max_devices=1, device=device)
    # corrected counter: bills 4F when full activation checkpointing is on
    prof, app, _ = build_profile(
        JobSpec("wfm_fix", "phi-3-vision-4.2b", chips=256, true_duty=0.36,
                duration_s=600, remat=True))
    corrected = app * 4 / 3
    return [Row("sec6c.remat_accounting", 0.0,
                f"reported_mfu={bad.app_mfu * 100:.1f}% ofu={bad.ofu * 100:.1f}% "
                f"corrected_mfu={corrected * 100:.1f}% "
                f"gap_after_fix={abs(corrected - bad.ofu) * 100:.1f}pp")]


def run(device=None) -> list[Row]:
    device = resolve_device(device)
    return case_a(device) + case_b(device) + case_c(device)


if __name__ == "__main__":
    for r in run():
        print(r.csv())
