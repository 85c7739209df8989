"""Host half of the fused fleet engine: the engine-level job view, the
(interval, clock-model) grouping, and the post-hoc counter-fault layer.

`fleet.engine_torch` simulates each group on the device; this module
holds what every backend shares and never touches a device itself,
except that `apply_faults` multiplies a grid by its masks on the grid's
own device, and `simulate_devices` hands one job to `engine_torch`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.telemetry.clock import ClockModel
from repro_torch.telemetry.counters import Event, StepProfile
from repro_torch.telemetry.scrape import DeviceGrid


@dataclass
class EngineParams:
    """Fidelity knobs for the fused path.

    There is no clock sub-step knob: the OU drive (duty at window ends) is
    piecewise-constant within a scrape interval, so the exact
    discretization takes ONE step per scrape sample.
    """

    n_sub_max: int = 64          # duty sub-samples per averaging window


@dataclass
class JobSlot:
    """One job's slot in a fused multi-job grid (the engine-level view:
    no configs, no FLOPs — just the step profile and its timeline)."""

    profile: StepProfile
    duration_s: float
    interval_s: float
    events: Sequence[Event] = ()
    stragglers: Optional[np.ndarray] = None   # (n_devices,); default: [1.0]
    chip: ChipSpec = DEFAULT_CHIP
    clock_model: Optional[ClockModel] = None


# ---------------------------------------------------------------------------
# Fault injection: post-hoc counter perturbation (scenario ground truth)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CounterFault:
    """A declarative counter-stream perturbation with a known timeline.

    `Event` feeds the GENERATIVE model (it changes what the simulated
    hardware does, sample statistics and OU drive included).  A
    CounterFault instead perturbs the OBSERVED counters after the engine
    pass — multiplicative masks over the (device, sample) grid — which is
    what the scenario library needs for ground-truth labels: the
    perturbation applies identically on every backend, so a detector scorecard measures the detector, never
    engine-equivalence noise.

    Timeline: active on samples with start_s <= t < end_s.  period_s > 0
    gates that window into repeating bursts (active for the first
    `active_frac` of each period — preemption waves, MoE imbalance
    bursts).  diurnal_amp adds a sinusoidal duty modulation with period
    diurnal_period_s (multi-tenant inference load shapes).

    Scope: all devices by default; `devices` pins an explicit row subset,
    else `device_frac` takes the leading ceil(frac × D) rows (stable and
    seed-free — straggler-host scenarios stay reproducible).
    """

    start_s: float = 0.0
    end_s: float = float("inf")
    duty_scale: float = 1.0          # multiplies tpa while active
    clock_scale: float = 1.0         # multiplies clock_mhz while active
    device_frac: float = 1.0
    devices: Optional[tuple] = None  # explicit device rows (wins over frac)
    period_s: float = 0.0
    active_frac: float = 1.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 86400.0
    kind: str = "fault"

    def __post_init__(self):
        if self.end_s < self.start_s:
            raise ValueError(f"fault window [{self.start_s}, {self.end_s}) "
                             "is reversed")
        if not 0.0 < self.device_frac <= 1.0:
            raise ValueError(f"device_frac={self.device_frac} must be in "
                             "(0, 1]")
        if self.period_s < 0 or not 0.0 < self.active_frac <= 1.0:
            raise ValueError(f"need period_s >= 0 (got {self.period_s}) "
                             f"and active_frac in (0, 1] "
                             f"(got {self.active_frac})")
        if abs(self.diurnal_amp) > 1.0:
            raise ValueError(f"diurnal_amp={self.diurnal_amp} must stay "
                             "within ±1 (duty cannot go negative)")


def fault_factors(faults: Sequence[CounterFault], times_s: np.ndarray,
                  n_devices: int) -> tuple[np.ndarray, np.ndarray]:
    """(duty, clock) multiplicative factor grids, shape (D, S) float32.

    Later faults compound multiplicatively with earlier ones on samples
    where both are active (a throttled straggler is both slow AND hot).
    """
    t = np.asarray(times_s, float).ravel()
    duty = np.ones((n_devices, t.size), dtype=np.float32)
    clock = np.ones((n_devices, t.size), dtype=np.float32)
    for f in faults:
        on = (f.start_s <= t) & (t < f.end_s)
        if f.period_s > 0:
            phase = np.mod(t - f.start_s, f.period_s)
            on &= phase < f.active_frac * f.period_s
        if not on.any():
            continue
        if f.devices is not None:
            rows = np.asarray(f.devices, int)
            if rows.size and (rows.min() < 0 or rows.max() >= n_devices):
                raise ValueError(f"fault devices {list(rows)} out of range "
                                 f"for {n_devices} device(s)")
        else:
            rows = np.arange(int(np.ceil(f.device_frac * n_devices)))
        d = np.full(t.size, 1.0, dtype=np.float32)
        d[on] = f.duty_scale
        if f.diurnal_amp:
            wave = 1.0 + f.diurnal_amp * np.sin(
                2.0 * np.pi * t / f.diurnal_period_s)
            d[on] = (d * wave.astype(np.float32))[on]
        duty[rows] *= d[None, :]
        if f.clock_scale != 1.0:
            c = np.full(t.size, 1.0, dtype=np.float32)
            c[on] = f.clock_scale
            clock[rows] *= c[None, :]
    return duty, clock


def apply_faults(grid: DeviceGrid,
                 faults: Sequence[CounterFault]) -> DeviceGrid:
    """Perturb a simulated grid's counters per the fault timeline.

    Pure post-processing: multiplies tpa/clock by `fault_factors` masks
    (duty clipped back into [0, 1]) and returns a NEW DeviceGrid with the
    same interval/t0.  Works on host numpy grids and torch grids alike:
    the masks move to a tensor grid's device and the arithmetic goes
    through the grid arrays' own operators, so a CUDA grid stays on the
    card.
    """
    if not faults:
        return grid
    if math.prod(grid.tpa.shape) == 0:
        return DeviceGrid(grid.interval_s, grid.tpa, grid.clock_mhz,
                          t0_s=grid.t0_s)
    duty_f, clock_f = fault_factors(faults, grid.times_s, grid.n_devices)
    if isinstance(grid.tpa, torch.Tensor):
        duty_f = torch.from_numpy(duty_f).to(grid.tpa.device)
        clock_f = torch.from_numpy(clock_f).to(grid.clock_mhz.device)
    tpa = (grid.tpa * duty_f).clip(0.0, 1.0)
    clk = (grid.clock_mhz * clock_f).clip(0.0, None)
    return DeviceGrid(grid.interval_s, tpa, clk, t0_s=grid.t0_s)


def simulate_devices(profile: StepProfile, *, duration_s: float,
                     interval_s: float,
                     chip: ChipSpec = DEFAULT_CHIP,
                     clock_model: Optional[ClockModel] = None,
                     events: Sequence[Event] = (),
                     stragglers=None, n_devices: Optional[int] = None,
                     seed: int = 0,
                     params: Optional[EngineParams] = None,
                     device=None) -> DeviceGrid:
    """Simulate a whole device group's counter streams in one shot, on
    `device` (the current CUDA device when None).

    stragglers: optional (n_devices,) per-device step-time multipliers;
    defaults to 1.0 everywhere.  All devices share the step profile and
    event timeline; straggler spread is the per-device degree of
    freedom.  n_devices defaults to len(stragglers) (or 1); passing BOTH
    requires them to agree.

    A single-slot pass of `engine_torch.simulate_jobs_torch`: the grid's
    tpa/clock are (n_devices, n_samples) float32 tensors on `device`.
    """
    from repro_torch.fleet.engine_torch import simulate_jobs_torch
    if stragglers is None:
        stragglers = np.ones(1 if n_devices is None else n_devices)
    stragglers = np.asarray(stragglers, float)
    if n_devices is not None and n_devices != len(stragglers):
        raise ValueError(f"n_devices={n_devices} conflicts with "
                         f"len(stragglers)={len(stragglers)}")
    slot = JobSlot(profile, duration_s, interval_s, events=events,
                   stragglers=stragglers, chip=chip, clock_model=clock_model)
    return simulate_jobs_torch([slot], seed=seed, params=params,
                               device=device)[0]


def group_slots(slots: Sequence[JobSlot]) -> dict:
    """Group slots by (scrape interval, clock-model constants) — the
    fusion key of the fused engine (`engine_torch`), so each group gets
    one time grid and one OU recurrence.  Values are [(slot index, slot, resolved ClockModel), ...]."""
    groups: dict = {}
    for i, sl in enumerate(slots):
        cm = sl.clock_model or ClockModel(chip=sl.chip)
        key = (float(sl.interval_s), cm.theta, cm.sigma_mhz,
               cm.throttle_frac, cm.f_min_frac, cm.chip.f_max_mhz)
        groups.setdefault(key, []).append((i, sl, cm))
    return groups
