"""Counter backends: the interface OFU consumes, with two implementations.

`CounterBackend` exposes exactly the two signals the paper's metric uses:
  * matrix-pipe duty cycle, HARDWARE-AVERAGED over the collection window
    (the DCGM PIPE_TENSOR_ACTIVE semantics, max 30 s averaging window), and
  * the pipeline clock as an INSTANTANEOUS point sample
    (the DCGM_FI_DEV_SM_CLOCK semantics).

`SimulatedDeviceBackend` generates both from a step profile (MXU-busy time
per step + step period, derivable from a compiled dry-run) plus injected
inefficiency events — so every downstream fleet component runs unchanged
against real counters.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.telemetry.clock import ClockModel

#: DCGM averages tensor-pipe activity over at most this window (paper §IV-C);
#: scraping slower than this produces an average-of-averages.
MAX_HW_AVG_WINDOW_S = 30.0


def check_scrape_interval(interval_s: float, *, strict: bool = True,
                          stacklevel: int = 3) -> float:
    """Enforce the §IV-C rule shared by every scrape path (scalar scrape
    loop, vectorized engine, fused fleet grid).

    Returns the effective hardware averaging window.  strict=True raises
    on intervals beyond MAX_HW_AVG_WINDOW_S; strict=False degrades with a
    RuntimeWarning — each reading then only reflects the trailing window.
    """
    if interval_s > MAX_HW_AVG_WINDOW_S:
        msg = (f"scrape interval {interval_s}s exceeds the "
               f"{MAX_HW_AVG_WINDOW_S}s hardware averaging window "
               "(average-of-averages, paper §IV-C)")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg + "; readings only cover the trailing "
                      f"{MAX_HW_AVG_WINDOW_S}s of each interval",
                      RuntimeWarning, stacklevel=stacklevel)
    return min(interval_s, MAX_HW_AVG_WINDOW_S)


@dataclass
class Event:
    """An injected inefficiency: between [start_s, end_s) every step is
    stretched by `slowdown` while MXU-busy time stays constant (host-sync
    serialization à la the paper's Gloo case), and/or MXU work is scaled."""

    start_s: float
    end_s: float
    slowdown: float = 1.0
    mxu_scale: float = 1.0
    kind: str = "host_sync"


@dataclass
class StepProfile:
    """What one training/serving step looks like on one device."""

    mxu_time_s: float            # time the matrix pipe is busy per step
    step_time_s: float           # wall-clock per step (>= mxu_time_s)
    flops_by_precision: dict = field(default_factory=dict)
    jitter: float = 0.03         # per-step lognormal wall-time jitter

    @property
    def duty(self) -> float:
        return min(1.0, self.mxu_time_s / self.step_time_s)


# ---------------------------------------------------------------------------
# Vectorized counter path (the fleet-engine hot loop)
# ---------------------------------------------------------------------------
def event_factors(events: Sequence[Event],
                  ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-time (slowdown, mxu_scale) arrays for a time grid of any shape.

    Vectorized replacement for the linear per-sample event scan: iterating
    the (few) events over the (many) samples instead of the reverse.  When
    events overlap, the FIRST event by start time wins — matching the
    scalar backend's scan order — hence the reversed assignment loop.
    """
    ts = np.asarray(ts, float)
    slow = np.ones_like(ts)
    scale = np.ones_like(ts)
    # reversed stable ascending sort: on equal start times the FIRST-listed
    # event is assigned last, i.e. wins — exactly the scan's tie-break
    for e in reversed(sorted(events, key=lambda e: e.start_s)):
        m = (e.start_s <= ts) & (ts < e.end_s)
        slow[m] = e.slowdown
        scale[m] = e.mxu_scale
    return slow, scale


def duty_grid(profile: StepProfile, ts: np.ndarray, *,
              straggler=1.0, events: Sequence[Event] = ()) -> np.ndarray:
    """Deterministic duty cycle evaluated on a whole time grid at once.

    ts may be any shape; `straggler` may be a scalar or an array that
    broadcasts against ts (e.g. (n_devices, 1, 1) against (S, n_sub) for a
    full fleet grid).  Semantics match SimulatedDeviceBackend._duty_at.
    """
    slow, scale = event_factors(events, ts)
    step = profile.step_time_s * np.asarray(straggler, float) * slow
    mxu = profile.mxu_time_s * scale
    return np.minimum(1.0, mxu / step)


class CounterBackend:
    """Interface: poll(window_s) -> (tpa_avg, clock_mhz_sample)."""

    def poll(self, window_s: float) -> tuple[float, float]:
        raise NotImplementedError


class SimulatedDeviceBackend(CounterBackend):
    """First-principles device simulator emitting counter streams.

    Time advances only via poll(); the device integrates MXU-busy time at
    sub-step resolution (hardware averaging), while the clock is sampled
    as a point value at the poll instant (the paper's noise source).
    """

    def __init__(self, profile: StepProfile, *,
                 chip: ChipSpec = DEFAULT_CHIP,
                 clock_model: Optional[ClockModel] = None,
                 events: Sequence[Event] = (),
                 straggler_factor: float = 1.0,
                 seed: int = 0):
        self.profile = profile
        self.chip = chip
        self.clock_model = clock_model or ClockModel(chip=chip)
        self.events = sorted(events, key=lambda e: e.start_s)
        self.straggler = straggler_factor
        self.rng = np.random.default_rng(seed)
        self.now_s = 0.0
        self._clock = self.clock_model.mean_clock(profile.duty)
        self._seed = seed

    # -- internals ----------------------------------------------------------
    def _duty_at(self, t: float) -> float:
        """Mean duty cycle around time t (deterministic component)."""
        return float(duty_grid(self.profile, np.asarray([t]),
                               straggler=self.straggler,
                               events=self.events)[0])

    # -- CounterBackend -----------------------------------------------------
    def poll(self, window_s: float) -> tuple[float, float]:
        """Advance time by window_s; return (hw-averaged TPA, clock sample).

        The hardware averages duty cycle over at most MAX_HW_AVG_WINDOW_S;
        longer scrape intervals therefore return the average of the LAST
        30 s only (average-of-averages hazard, paper §IV-C).
        """
        t0, t1 = self.now_s, self.now_s + window_s
        self.now_s = t1
        avg_w = min(window_s, MAX_HW_AVG_WINDOW_S)
        # integrate duty over the averaging window at sub-step resolution
        n = max(8, int(avg_w / max(self.profile.step_time_s / 4, 1e-3)))
        n = min(n, 4096)
        ts = np.linspace(t1 - avg_w, t1, n, endpoint=False)
        duties = duty_grid(self.profile, ts, straggler=self.straggler,
                           events=self.events)
        # per-step jitter -> duty wobble (hardware-averaged, so mild)
        duties = duties * np.exp(self.rng.standard_normal(n)
                                 * self.profile.jitter / np.sqrt(n))
        tpa = float(np.clip(duties.mean(), 0.0, 1.0))

        # clock: evolve the OU process across the full window, keep ONLY the
        # final instantaneous sample (point-sample semantics)
        steps = max(4, min(int(window_s * 10), 600))
        traj = self.clock_model.simulate(
            np.full(steps, self._duty_at(t1 - 1e-6)),
            dt_s=window_s / steps,
            seed=int(self.rng.integers(0, 2 ** 31)))
        self._clock = float(traj[-1])
        return tpa, self._clock

    # convenience: a dense 1 Hz reference trace (for Table I baselines)
    def trace(self, duration_s: float, interval_s: float = 1.0):
        out = []
        while self.now_s < duration_s:
            out.append(self.poll(interval_s))
        tpa, clk = np.array(out).T
        return tpa, clk
