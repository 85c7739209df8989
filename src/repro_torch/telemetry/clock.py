"""Power/thermal clock-frequency process (paper §IV-C).

The SM/TensorCore clock under power management is a mean-reverting noisy
process: during a sustained 16384³ BF16 GEMM the paper measures the H100
clock fluctuating 1,201–1,558 MHz (mean 1,352, σ 32) at 1 kHz.  We model it
as an Ornstein–Uhlenbeck process whose mean depends on load (duty cycle):
heavier sustained matrix work pulls the clock down from boost.  The OFU
pipeline only ever sees *point samples* of this process — reproducing the
instantaneous-sample-vs-hardware-average asymmetry that drives Table I.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec


@dataclass
class ClockModel:
    """OU process: df = θ(μ(load) − f)dt + σ dW, clipped to [f_min, f_max]."""

    chip: ChipSpec = DEFAULT_CHIP
    theta: float = 2.0           # mean reversion rate (1/s)
    sigma_mhz: float = 32.0      # matches the paper's observed σ
    throttle_frac: float = 0.115  # full-load mean = (1-θf)·f_max
    f_min_frac: float = 0.60

    def mean_clock(self, duty):
        """Load-dependent OU mean; accepts a scalar or an ndarray duty."""
        return self.chip.f_max_mhz * (1.0 - self.throttle_frac * duty)

    def ou_step_constants(self, dt_s: float) -> tuple[float, float]:
        """(a, sd) of the exact one-step OU discretization at step dt_s:
        f' = μ + (f − μ)·a + sd·N(0,1), with a = e^{−θ·dt} and
        sd = σ·sqrt(1 − a²).  The ONE definition shared by the scalar
        loop, the batched NumPy recurrence, and the torch engine's
        recurrence — backends may not drift apart on the discretization.
        """
        a = float(np.exp(-self.theta * dt_s))
        sd = float(self.sigma_mhz * np.sqrt(max(1e-12, 1 - a * a)))
        return a, sd

    def simulate(self, duty: np.ndarray, dt_s: float,
                 seed: int = 0) -> np.ndarray:
        """Per-interval clock trajectory given a duty-cycle trajectory.

        duty: (T,) MXU duty cycle in [0,1] per dt_s interval.
        Returns (T,) instantaneous clock samples (MHz) at interval ends.
        """
        rng = np.random.default_rng(seed)
        T = len(duty)
        f = np.empty(T)
        cur = self.mean_clock(float(duty[0]))
        a, sd = self.ou_step_constants(dt_s)   # exact OU discretization
        noise = rng.standard_normal(T)
        f_min = self.chip.f_max_mhz * self.f_min_frac
        for t in range(T):
            mu = self.mean_clock(float(duty[t]))
            cur = mu + (cur - mu) * a + sd * noise[t]
            cur = min(max(cur, f_min), self.chip.f_max_mhz)
            f[t] = cur
        return f

    def simulate_batch(self, duty: np.ndarray, dt_s: float, seed: int = 0,
                       f0: np.ndarray | None = None) -> np.ndarray:
        """Batched OU trajectories: one clock process per device.

        duty: (n_devices, T) MXU duty cycle in [0,1] per dt_s interval.
        f0:   optional (n_devices,) initial clocks; defaults to the
              load-dependent mean at t=0 (same convention as simulate()).
        Returns (n_devices, T) instantaneous clock samples (MHz).  The
        recurrence is over T only; all device math is vectorized, which is
        what makes fleet-scale simulation tractable.
        """
        duty = np.asarray(duty)
        if duty.dtype != np.float32:      # clock resolution: f32 ≈ 1e-4 MHz
            duty = duty.astype(float, copy=False)  # fleet grids pass f32;
        dt = duty.dtype                   # scalar callers keep f64
        D, T = duty.shape
        rng = np.random.default_rng(seed)
        a, sd = self.ou_step_constants(dt_s)
        # time-major layout so every recurrence step touches contiguous
        # memory, with the non-recurrent terms (μ(1−a) + σ·dW) folded into
        # one precomputed drive array — the loop is 3 in-place ops per step.
        # μ·(1−a) expands to c1 − c2·duty, built transposed in two passes.
        drive = np.empty((T, D), dtype=dt)
        np.multiply(duty.T, -self.chip.f_max_mhz * self.throttle_frac
                    * (1.0 - a), out=drive)
        cur = self.mean_clock(duty[:, 0].copy()) if f0 is None else \
            np.broadcast_to(np.asarray(f0, dt), (D,)).astype(dt)
        drive += self.chip.f_max_mhz * (1.0 - a)
        # float32 N(0,1) draws: σ·dW granularity ~1e-5 MHz, far below the
        # 32 MHz noise floor, and generation is ~2× faster at fleet scale
        drive += sd * rng.standard_normal((T, D), dtype=np.float32)
        f_min = self.chip.f_max_mhz * self.f_min_frac
        f = np.empty((T, D), dtype=dt)
        for t in range(T):
            cur *= a
            cur += drive[t]
            np.clip(cur, f_min, self.chip.f_max_mhz, out=cur)
            f[t] = cur
        return np.ascontiguousarray(f.T)
