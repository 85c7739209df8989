"""Fault-tolerant trainer loop with OFU-driven recovery.

Closes the paper's §VI loop end-to-end:
  train step -> step timing -> telemetry (simulated counter backend here)
  -> scrape -> job OFU -> RecoveryService -> on sustained collapse,
  restart from the latest atomic checkpoint.

Also handles straight crash-recovery (resume from checkpoint + deterministic
data stream) and supports fault injection for the integration tests.  The
step runs on `TrainConfig.device` (the card unless the caller names
another); its time is the host clock around a synchronized step.  The
simulated telemetry is derived from `TrainConfig.chip` (TPU v5e by
default, as in the reference): it is the chip the fleet simulation
models, not a reading of the card.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.ofu import ofu_point
from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.data.pipeline import synthetic_batch, to_device
from repro_torch.fleet.recovery import RecoveryService, StragglerMonitor
from repro_torch.models import api as models
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import make_train_step


@dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20            # 0: never checkpoint
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    chip: ChipSpec = DEFAULT_CHIP
    # OFU monitoring
    monitor: bool = True
    scrape_every_steps: int = 5
    # resilience
    max_restarts: int = 3
    # where the step runs: the card when None
    device: Optional[str] = None


@dataclass
class StepTelemetry:
    """What the (real or simulated) counters say about recent steps.

    Carries its chip: the reference's `ofu` divides by the default chip's
    f_max whatever `TrainConfig.chip` says."""

    step: int
    step_time_s: float
    tpa: float
    clock_mhz: float
    chip: ChipSpec = DEFAULT_CHIP

    @property
    def ofu(self) -> float:
        return ofu_point(self.tpa, self.clock_mhz, self.chip)


class Trainer:
    """`params_fn`, when given, returns the initial parameters in place
    of a draw from `TrainConfig.seed` (called wherever the reference
    draws them: at start and on a restart)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 opt_cfg: Optional[adamw.OptConfig] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 flops_per_step: Optional[float] = None, *,
                 accum_steps: int = 1,
                 params_fn: Optional[Callable[[], dict]] = None):
        self.cfg = cfg
        self.shape = shape
        self.opt_cfg = opt_cfg or adamw.OptConfig(warmup_steps=10,
                                                  decay_steps=1000)
        self.tc = train_cfg or TrainConfig()
        self.device = resolve_device(self.tc.device)
        self.fault_hook = fault_hook
        self.flops_per_step = flops_per_step
        self.params_fn = params_fn
        self.step_fn = make_train_step(cfg, self.opt_cfg,
                                       accum_steps=accum_steps)
        self.recovery = RecoveryService(factor_threshold=2.0,
                                        sustain_samples=3,
                                        cooldown_samples=6)
        self.stragglers = StragglerMonitor()
        self.history: list[StepTelemetry] = []
        self.restarts = 0

    # ------------------------------------------------------------------
    def _init_state(self):
        if self.params_fn is not None:
            params = self.params_fn()
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tc.seed)
            params = models.init_params(self.cfg, gen, device=self.device)
        opt_state = adamw.init(self.opt_cfg, params)
        return params, opt_state

    def _restore(self, latest: int):
        params, opt_state = self._init_state()
        return (ckpt.restore(self.tc.ckpt_dir, params, latest),
                ckpt.restore(self.tc.ckpt_dir + "/opt", opt_state, latest))

    def _telemetry(self, step: int, dt: float) -> StepTelemetry:
        """Derive counter readings from the measured step time: the duty
        cycle `TrainConfig.chip` WOULD show, mxu_time = flops/peak."""
        if self.flops_per_step:
            mxu_t = self.flops_per_step / (self.tc.chip.peak_tflops() * 1e12)
        else:
            mxu_t = 0.35 * dt
        tpa = min(1.0, mxu_t / max(dt, 1e-9))
        clock = self.tc.chip.f_max_mhz * (1 - 0.115 * tpa)
        return StepTelemetry(step, dt, tpa, clock, self.tc.chip)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> dict:
        tc = self.tc
        step = 0
        latest = ckpt.latest_step(tc.ckpt_dir)
        if start_step is None and latest is not None:
            params, opt_state = self._restore(latest)
            step = latest
        else:
            params, opt_state = self._init_state()
            if start_step:
                step = start_step

        metrics_log = []
        while step < tc.total_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = to_device(self.cfg, synthetic_batch(
                    self.cfg, self.shape, step, seed=tc.seed), self.device)
                self._sync()
                t0 = time.perf_counter()
                params, opt_state, m = self.step_fn(params, opt_state, batch)
                self._sync()
                dt = time.perf_counter() - t0
                step += 1

                tel = self._telemetry(step, dt)
                self.history.append(tel)
                if tc.monitor and step % tc.scrape_every_steps == 0:
                    action = self.recovery.observe("train", tel.ofu)
                    if action is not None:
                        raise _RecoveryRestart(action.reason)
                if step % tc.log_every == 0:
                    metrics_log.append(
                        {"step": step,
                         "loss": float(m["loss"]),
                         "ofu": tel.ofu,
                         "step_time_s": dt})
                if tc.ckpt_every and (step % tc.ckpt_every == 0
                                      or step == tc.total_steps):
                    ckpt.save(tc.ckpt_dir, step, params, keep=tc.keep)
                    ckpt.save(tc.ckpt_dir + "/opt", step, opt_state,
                              keep=tc.keep)
            except _RecoveryRestart as e:
                self.restarts += 1
                if self.restarts > tc.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                latest = ckpt.latest_step(tc.ckpt_dir)
                if latest is not None:
                    params, opt_state = self._restore(latest)
                    step = latest
                else:
                    params, opt_state = self._init_state()
                    step = 0

        return {"final_step": step, "metrics": metrics_log,
                "restarts": self.restarts,
                "final_loss": metrics_log[-1]["loss"] if metrics_log
                else None}


class _RecoveryRestart(Exception):
    pass
