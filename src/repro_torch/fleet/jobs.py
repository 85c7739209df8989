"""Fleet job model: ties a (config, shape) workload to telemetry + app MFU.

A `JobSpec` describes one production job the way the fleet sees it: chips,
architecture, which FLOPs counter its framework uses (including the buggy
variants of paper §V-C), precision mix, and its *true* efficiency (duty
cycle) — which the fleet does NOT observe directly.  `simulate_job` produces
what the fleet DOES observe: hardware-counter scrapes per device, and the
application-reported MFU computed from the (possibly wrong) FLOPs counter.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Sequence

import numpy as np

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.ofu import effective_peak, ofu_mean
from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.core.tile_quant import pick_policy, profiled_flops, theoretical_flops
from repro_torch.fleet.engine import JobSlot, apply_faults
from repro_torch.fleet.engine_torch import simulate_jobs_torch
from repro_torch.flops.accounting import step_flops
from repro_torch.telemetry.counters import (Event, StepProfile,
                                            check_scrape_interval)
from repro_torch.telemetry.scrape import DeviceGrid


@dataclass
class JobSpec:
    job_id: str
    arch: str
    shape: str = "train_4k"
    chips: int = 256
    user: str = "researcher"
    flops_variant: str = "exact"     # exact | naive_moe | naive_hybrid | ...
    precisions: dict = field(default_factory=lambda: {"bf16": 1.0})
    true_duty: float = 0.35          # ground-truth MXU duty cycle
    duration_s: float = 600.0
    scrape_interval_s: float = 30.0
    events: Sequence[Event] = ()
    straggler_sigma: float = 0.0     # per-device step-time spread
    #: post-hoc counter perturbations (`fleet.engine.CounterFault`) —
    #: the scenario library's ground-truth injection point.  Unlike
    #: `events`, faults never reach the generative model: they apply to
    #: the finished grid via `apply_faults`, identically on every engine.
    faults: Sequence = ()
    seed: int = 0
    chip: ChipSpec = DEFAULT_CHIP
    # remat=True is the §VI-C world-model case (hardware executes 4F while
    # the app counter bills 3F); the default fleet job runs without it.
    remat: bool = False


@dataclass
class JobTelemetry:
    spec: JobSpec
    grid: DeviceGrid                   # sampled devices' aligned counters
    app_mfu: float                     # what the framework reports (Eq. 10)
    app_mfu_exact: float               # with a correct FLOPs counter
    step_time_s: float
    executed_tflops_per_step: float

    @cached_property
    def device_series(self) -> list:
        """Per sampled device: ScrapeSeries (materialized lazily from the
        grid — fleet sweeps that stay on the batched path never pay for
        per-device objects)."""
        return self.grid.to_series_list()

    @property
    def ofu(self) -> float:
        """Job-level OFU per Eq. 11 (mean over devices × samples)."""
        return ofu_mean(self.grid.tpa, self.grid.clock_mhz, self.spec.chip)


def _tile_quant_factor(cfg, chip: ChipSpec) -> float:
    """Mean executed/theoretical FLOPs ratio for the job's dominant GEMMs,
    under `chip`'s tile policies (`pick_policy`)."""
    d = cfg.d_model
    shapes = [(4096, d, d), (4096, cfg.d_ff or d, d)]
    f = [profiled_flops(m, n, k, pick_policy(m, n, k, chip=chip))
         / theoretical_flops(m, n, k) for m, n, k in shapes]
    return float(np.mean(f))


#: (workload fields) -> (StepProfile, app_mfu, app_mfu_exact).  The
#: derivation is deterministic, and a 600-job fleet sweep reuses a few
#: dozen distinct workloads — memoizing keeps profile math off the
#: fused path's critical path.
_PROFILE_CACHE: dict = {}
_CACHE_CAP = 65536


def _cache_put(cache: dict, key, val):
    """Insert with FIFO eviction — long-lived collector processes must
    not grow memoization state without bound."""
    if len(cache) >= _CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[key] = val
    return val


def build_profile(spec: JobSpec) -> tuple[StepProfile, float, float]:
    """Derive the per-device step profile + app-reported MFUs for a job.

    Memoized on the spec's workload fields (arch/shape/chips/FLOPs
    variant/precisions/duty/chip); each call returns a FRESH StepProfile
    so callers may tweak theirs without poisoning the cache.
    """
    chip = spec.chip
    key = (spec.arch, spec.shape, spec.chips, spec.flops_variant,
           spec.remat, spec.true_duty,
           # every ChipSpec field the profile math reads — name alone
           # would alias customized chips onto the stock entry
           chip.name, chip.num_mxu, chip.mxu_rows, chip.mxu_cols,
           chip.flops_per_macc, chip.f_max_mhz,
           tuple(sorted(chip.precision_mult.items())),
           tuple(sorted(spec.precisions.items())))
    hit = _PROFILE_CACHE.get(key)
    if hit is None:
        hit = _cache_put(_PROFILE_CACHE, key, _build_profile_uncached(spec))
    prof, app, app_exact = hit
    return (StepProfile(prof.mxu_time_s, prof.step_time_s,
                        dict(prof.flops_by_precision), prof.jitter),
            app, app_exact)


def _build_profile_uncached(spec: JobSpec) -> tuple[StepProfile, float, float]:
    cfg = get_config(spec.arch)
    shape = SHAPES[spec.shape]
    chip = spec.chip

    exact = step_flops(cfg, shape, variant="exact", executed=False,
                       remat=spec.remat)
    executed = step_flops(cfg, shape, variant="exact", executed=True,
                          remat=spec.remat)
    reported = step_flops(cfg, shape, variant=spec.flops_variant,
                          executed=False, remat=spec.remat)

    tq = _tile_quant_factor(cfg, chip)
    executed_mxu = executed.total_mxu * tq

    peak_eff = effective_peak(spec.precisions, chip)      # TFLOP/s per chip
    fleet_peak = peak_eff * 1e12 * spec.chips
    mxu_time = executed_mxu / fleet_peak                  # at full clock
    step_time = mxu_time / max(spec.true_duty, 1e-3)

    # App MFU (Eq. 10): reported FLOPs / (step_time × chips × peak).
    # NOTE the counter convention: app counters bill 3F (no remat term) —
    # exactly the §VI-C miscount when remat is on, unless the variant fixes it.
    app = reported.total_mxu / (step_time * fleet_peak)
    app_exact = exact.total_mxu / (step_time * fleet_peak)
    prof = StepProfile(mxu_time_s=mxu_time, step_time_s=step_time,
                       flops_by_precision={
                           p: executed_mxu * f
                           for p, f in spec.precisions.items()})
    return prof, float(app), float(app_exact)


#: (seed, straggler_sigma, n_dev) -> (stragglers, seed vector): the draws
#: are a pure function of the spec, so repeated sweeps over the same specs
#: skip thousands of Generator constructions.
_DRAW_CACHE: dict = {}


def _job_draws(seed: int, sigma: float, n_dev: int):
    key = (seed, sigma, n_dev)
    hit = _DRAW_CACHE.get(key)
    if hit is None:
        rng = np.random.default_rng(seed)
        stragglers = np.exp(rng.standard_normal(n_dev) * sigma)
        # seeds[0] feeds the fused engine; the n_dev per-device seeds
        # after it (the reference's scalar backend) keep the stream equal
        seeds = rng.integers(0, 2 ** 31, size=n_dev + 1)
        hit = _cache_put(_DRAW_CACHE, key, (stragglers, seeds))
    return hit


def _prep_job(spec: JobSpec, max_devices: int):
    """Per-spec setup shared by every engine: §IV-C check, profile math,
    and the job's straggler/seed draws (same RNG stream on every path)."""
    # same §IV-C policy scrape() enforces — every path must reject
    # average-of-averages configs identically
    check_scrape_interval(spec.scrape_interval_s)
    prof, app, app_exact = build_profile(spec)
    n_dev = min(spec.chips, max_devices)
    stragglers, seeds = _job_draws(spec.seed, spec.straggler_sigma, n_dev)
    return prof, app, app_exact, stragglers, seeds


def _telemetry(spec: JobSpec, prof: StepProfile, app: float,
               app_exact: float, grid: DeviceGrid) -> JobTelemetry:
    if spec.faults:
        # post-hoc by design: every engine produces the same unperturbed
        # grid (up to its usual equivalence), so the injected fault is
        # EXACTLY the declared perturbation on all of them
        grid = apply_faults(grid, spec.faults)
    executed_tflops = sum(prof.flops_by_precision.values()) / 1e12
    return JobTelemetry(spec, grid, app, app_exact, prof.step_time_s,
                        executed_tflops)


def simulate_job(spec: JobSpec, max_devices: int = 4, *,
                 engine: str = "torch", device=None) -> JobTelemetry:
    """Simulate the job's observable counter streams on `device` (the
    current CUDA device when None).

    engine: 'torch', the only engine of the port — the fused device pass
    of `repro_torch.fleet.engine_torch` over this one job, seeded from the
    job's own stream.
    """
    _check_engine(engine)
    prof, app, app_exact, stragglers, seeds = _prep_job(spec, max_devices)
    grid = simulate_jobs_torch(
        [JobSlot(prof, spec.duration_s, spec.scrape_interval_s,
                 events=spec.events, stragglers=stragglers,
                 chip=spec.chip)], seed=int(seeds[0]), device=device)[0]
    return _telemetry(spec, prof, app, app_exact, grid)


def simulate_fleet(specs: Sequence[JobSpec], *, max_devices: int = 4,
                   engine: str = "torch", device=None) -> list[JobTelemetry]:
    """Simulate a whole fleet of jobs on `device` (the current CUDA device
    when None).

    engine: 'torch' stacks EVERY job into padded (total_devices, S_max)
    multi-job grids on the device — shared RNG streams, one duty
    evaluation and one OU recurrence per (interval, clock-model) group —
    and returns grids whose tensors stay there, so
    `StreamingRollup.add_grid` reduces them with the histogram kernel.

    Reproducibility semantics: the fused grid's jitter/clock noise comes
    from ONE stream seeded by the whole sweep, so a job's exact counter
    realization is deterministic given (specs, order, device type) but
    not a pure function of its own JobSpec.seed.
    """
    _check_engine(engine)
    slots, meta, entropy = [], [], []
    for spec in specs:
        prof, app, app_exact, stragglers, seeds = _prep_job(spec, max_devices)
        slots.append(JobSlot(prof, spec.duration_s, spec.scrape_interval_s,
                             events=spec.events, stragglers=stragglers,
                             chip=spec.chip))
        meta.append((spec, prof, app, app_exact))
        entropy.append(int(seeds[0]))
    # one master seed for the fused grid's shared RNG streams, derived
    # deterministically from every job's own stream
    seed = int(np.random.default_rng(entropy or [0]).integers(0, 2 ** 31))
    grids = simulate_jobs_torch(slots, seed=seed, device=device)
    return [_telemetry(spec, prof, app, app_exact, g)
            for (spec, prof, app, app_exact), g in zip(meta, grids)]


def _check_engine(engine: str) -> None:
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (expected 'torch')")
