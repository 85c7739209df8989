"""The paper's Table III / Fig. 5 / §V-C fleet as a reusable fixture.

608 production jobs at the paper's exact scale mix, with the two FLOPs
miscalculation populations baked in: every 288-GPU job runs the
DeepSeek-style MoE with the buggy `naive_moe` counter (§V-C case 1,
~3x inflation) and 17 of the 256-GPU jobs run the hybrid with
`naive_hybrid` (case 2, ~1.8x inflation) — 82 affected jobs total.

One fixture, two paths, bucketwise-identical numbers (`chip_smoke.py`
runs both on the card at every GPU of the fleet):

  * the OFFLINE path: batch rollups via `offline_rollups` +
    `divergence.analyze` / `correlation.analyze_correlation`;
  * the LIVE path: the same jobs replayed round-for-round through
    `Collector` streams (`to_streams`).

The scenario library's miscalculation scenario is a small slice of it.

Identity between the paths is by construction, not by tolerance hunting:
both ingest the same `DeviceGrid`s and the same reported-MFU sample
series through the same right-closed bucketing (`ROUND_S == BUCKET_S`,
so each collector poll lands exactly one bucket, in the same order the
batch path folds it).

The app's reported MFU is modelled per SAMPLE (one log line every
`INTERVAL_S`), not per job: noise in the application's timing path is
i.i.d. across step-time measurements plus a small per-job calibration
bias, so per-job bucket means tighten with averaging and the healthy
population separates cleanly from the ~2-3x miscalculated one.  The
per-sample sigma shrinks with scale like the paper's Table III absolute
errors (small jobs are the noisy ones).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fleet.correlation import MfuRollup
from repro_torch.fleet.jobs import JobSpec, JobTelemetry, simulate_fleet
from repro_torch.fleet.streaming import StreamingRollup

#: Table III scale mix: (gpus, jobs) — 608 rows total
SCALE_MIX = [(8, 6), (16, 48), (64, 52), (128, 48), (256, 76), (288, 65),
             (512, 144), (736, 11), (768, 57), (1024, 49), (1536, 10),
             (2944, 33), (5888, 9)]

HEALTHY_ARCHS = ["qwen3-4b", "granite-3-2b", "llama3.2-3b", "mamba2-780m",
                 "phi-3-vision-4.2b", "deepseek-moe-16b"]

#: §V-C populations: every job at MOE_CHIPS is case 1; the first
#: HYBRID_BUGS jobs at HYBRID_CHIPS are case 2 (65 + 17 = 82 affected)
MOE_CHIPS = 288
HYBRID_CHIPS = 256
HYBRID_BUGS = 17

#: the paper's Fig. 5 exclusion threshold — at this rel-err the flagged
#: set is exactly the miscalculated population (verified by the bench
#: and the CLI self-check)
FLAG_REL_ERR = 0.45

#: replay geometry: ROUND_S == BUCKET_S means one collector poll fills
#: exactly one bucket, making the live path's per-bucket accumulation
#: order identical to batch ingestion
INTERVAL_S = 30.0
BUCKET_S = 300.0
ROUND_S = BUCKET_S
DURATION_S = 1200.0              # 4 buckets, 40 MFU samples per job

#: reported-MFU noise model: per-sample sigma at the smallest scales
#: (shrinks ~1/sqrt(chips/64)) plus a per-job calibration bias
MFU_SAMPLE_SIGMA = 0.12
MFU_JOB_SIGMA = 0.02


@dataclass(frozen=True)
class Table3Job:
    """One fixture job: its spec, simulated counters, and the reported
    MFU sample series its application would have logged."""

    spec: JobSpec
    telemetry: JobTelemetry
    mfu_t: np.ndarray            # sample times (s), one per log line
    mfu_v: np.ndarray            # reported MFU at each sample

    @property
    def job_id(self) -> str:
        return self.spec.job_id


def build_specs(seed: int = 0) -> list[JobSpec]:
    """The 608 JobSpecs (deterministic in `seed`)."""
    rng = np.random.default_rng(seed)
    specs = []
    hybrid_bugs = HYBRID_BUGS
    for chips, njobs in SCALE_MIX:
        for j in range(njobs):
            jid = f"{chips}g_{j}"
            duty = float(np.clip(rng.normal(0.28, 0.10), 0.08, 0.55))
            if chips == MOE_CHIPS:            # §V-C case 1
                arch, variant = "deepseek-v3-671b", "naive_moe"
                # the affected MoE jobs ran at low true efficiency; with
                # the ~3x counter inflation they REPORTED ~40% MFU
                duty = float(np.clip(rng.normal(0.13, 0.03), 0.06, 0.25))
            elif chips == HYBRID_CHIPS and hybrid_bugs > 0:   # case 2
                arch, variant = "zamba2-7b", "naive_hybrid"
                hybrid_bugs -= 1
            else:
                arch = HEALTHY_ARCHS[int(rng.integers(len(HEALTHY_ARCHS)))]
                variant = "exact"
            specs.append(JobSpec(jid, arch, chips=chips,
                                 flops_variant=variant, true_duty=duty,
                                 duration_s=DURATION_S,
                                 scrape_interval_s=INTERVAL_S,
                                 seed=int(rng.integers(2 ** 31))))
    return specs


def _mfu_samples(spec: JobSpec, app_mfu: float, seed: int,
                 idx: int) -> tuple[np.ndarray, np.ndarray]:
    """The job's reported-MFU log stream: one sample per scrape tick,
    per-sample timing noise (scale-dependent) on a per-job bias.  Drawn
    from a child stream keyed on (seed, idx) so the series is a pure
    function of the fixture seed, independent of the simulation engine."""
    rng = np.random.default_rng([seed, 7919, idx])
    t = np.arange(INTERVAL_S, spec.duration_s + 1e-9, INTERVAL_S)
    sigma = MFU_SAMPLE_SIGMA / np.sqrt(max(spec.chips / 64.0, 1.0))
    bias = 1.0 + MFU_JOB_SIGMA * float(rng.standard_normal())
    v = app_mfu * bias * (1.0 + sigma * rng.standard_normal(t.size))
    return t, np.maximum(v, 1e-3)


def build_jobs(seed: int = 0, *, engine: str = "torch",
               max_devices: int = 1, device=None) -> list[Table3Job]:
    """Simulate the whole fixture fleet (counters + MFU log streams) on
    `device` (the current CUDA device when None).  `max_devices` caps
    the devices sampled a job: 1 is the fixture's width; 5,888 (the
    largest job) samples every GPU of the fleet."""
    specs = build_specs(seed)
    tels = simulate_fleet(specs, max_devices=max_devices, engine=engine,
                          device=device)
    jobs = []
    for idx, (spec, tel) in enumerate(zip(specs, tels)):
        t, v = _mfu_samples(spec, tel.app_mfu, seed, idx)
        jobs.append(Table3Job(spec, tel, t, v))
    return jobs


def offline_rollups(jobs, *, bucket_s: float = BUCKET_S):
    """Batch-ingest the fixture: (StreamingRollup, MfuRollup) — the
    offline twin of replaying `to_streams` through a Collector.  The
    job's divergence metadata carries the reported-MFU running mean,
    exactly what the live path's last round registers."""
    roll = StreamingRollup(bucket_s)
    mfu = MfuRollup(bucket_s)
    for job in jobs:
        spec = job.spec
        mfu.observe_series(spec.job_id, job.mfu_t, job.mfu_v)
        roll.add_grid(spec.job_id, job.telemetry.grid, chips=spec.chips,
                      app_mfu=mfu.job_mean(spec.job_id), arch=spec.arch,
                      flops_variant=spec.flops_variant)
    return roll, mfu


def build_fleet(seed: int = 0, *, engine: str = "torch", device=None):
    """Offline `JobPoint`s for `divergence.analyze` (the Fig. 5 sweep)."""
    roll, _ = offline_rollups(build_jobs(seed, engine=engine,
                                         device=device))
    return roll.to_job_points()


def to_streams(jobs) -> list:
    """Live `JobStream`s: counter replay + app-MFU reporter replay, for
    driving the fixture through a `Collector` round-for-round."""
    from repro_torch.fleet.collector import JobStream
    from repro_torch.telemetry.mfu import MfuReplaySource
    from repro_torch.telemetry.source import GridSource

    return [JobStream(job.spec.job_id, GridSource(job.telemetry.grid),
                      chips=job.spec.chips, arch=job.spec.arch,
                      flops_variant=job.spec.flops_variant,
                      mfu_source=MfuReplaySource(job.mfu_t, job.mfu_v))
            for job in jobs]


def affected_ids(jobs) -> dict:
    """Ground truth: flops_variant -> set of job_ids (the §V-C sets the
    detectors must flag exactly)."""
    out: dict = {}
    for job in jobs:
        if job.spec.flops_variant != "exact":
            out.setdefault(job.spec.flops_variant, set()).add(job.job_id)
    return out
