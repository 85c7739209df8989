"""Autonomous job recovery service (paper §VI-B: Mission Control analogue).

Consumes per-job OFU streams; on a sustained collapse below an absolute
floor or a relative regression, issues a recovery action.  A trainer
registers a callback so the action actually restarts from the latest
checkpoint — closing the loop the paper describes.

Two feeding modes:

  * `observe(job_id, ofu)` — raw per-scrape OFU samples; the service runs
    its own sustained-collapse policy (absolute floor, relative
    regression, cooldown).
  * `consume_alerts(alerts)` — downstream of a `fleet.collector.Collector`:
    the collector's deduper has already turned detector findings into
    per-episode alerts, so each REGRESSION alert maps to at most one
    recovery action (idempotent under re-feeding the collector's
    append-only alert log, e.g. once per poll round).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.fleet.regression import detect_regressions


@dataclass
class RecoveryAction:
    job_id: str
    reason: str
    at_sample: int
    factor: float


@dataclass
class RecoveryService:
    """Policy: restart when OFU collapses by `factor_threshold` for
    `sustain_samples` consecutive scrapes, or drops below `abs_floor`."""

    factor_threshold: float = 2.0
    abs_floor: float = 0.02
    sustain_samples: int = 5
    cooldown_samples: int = 20
    on_recover: Optional[Callable[[RecoveryAction], None]] = None
    #: only restart on regressions at least this severe when consuming
    #: collector alerts (alerts carry the detector's factor)
    min_alert_factor: float = 2.0
    _history: dict = field(default_factory=dict)
    _last_action: dict = field(default_factory=dict)
    _seen_alerts: set = field(default_factory=set)
    actions: list = field(default_factory=list)

    def observe(self, job_id: str, ofu: float) -> Optional[RecoveryAction]:
        h = self._history.setdefault(job_id, [])
        h.append(float(ofu))
        i = len(h) - 1
        if i - self._last_action.get(job_id, -10 ** 9) < self.cooldown_samples:
            return None
        if len(h) < 2 * self.sustain_samples:
            return None
        recent = h[-self.sustain_samples:]
        action = None
        if all(v < self.abs_floor for v in recent):
            action = RecoveryAction(job_id, "ofu_below_floor", i,
                                    factor=float("inf"))
        else:
            regs = detect_regressions(
                np.array(h), factor_threshold=self.factor_threshold,
                min_duration=self.sustain_samples)
            if regs and regs[-1].end_idx is None:
                action = RecoveryAction(job_id, "sustained_regression", i,
                                        factor=regs[-1].factor)
        if action is not None:
            self._fire(action, job_id, i)
        return action

    def _fire(self, action: RecoveryAction, job_id: str, at: int) -> None:
        self._last_action[job_id] = at
        self.actions.append(action)
        if self.on_recover is not None:
            self.on_recover(action)

    def consume_alerts(self, alerts) -> list[RecoveryAction]:
        """Turn collector REGRESSION alert episodes into recovery actions.

        `alerts` is any iterable of `fleet.collector.Alert` (the
        collector's append-only `alerts` log, or one round's
        `RoundReport.alerts`).  Each episode fires AT MOST once — the
        call is idempotent under overlapping/refed logs — and only when
        the detected factor reaches `min_alert_factor` (an ongoing 1.6×
        wobble should page a human, not bounce the job).  Returns the
        actions fired by THIS call.
        """
        fired = []
        for a in alerts:
            if a.kind != "regression":
                continue
            key = (a.job_id, a.round_idx, a.t_s, a.message)
            if key in self._seen_alerts:
                continue
            self._seen_alerts.add(key)
            factor = float(a.factor)
            if not np.isfinite(factor) or factor < self.min_alert_factor:
                continue
            action = RecoveryAction(a.job_id, "collector_regression",
                                    at_sample=a.round_idx, factor=factor)
            self._fire(action, a.job_id, a.round_idx)
            fired.append(action)
        return fired


@dataclass
class StragglerMonitor:
    """Per-device duty-cycle spread -> straggler flags (fleet resilience).

    A device whose duty cycle sits `sigma_threshold` robust-σ below the job
    median is flagged — the restart/replace decision input at 1000+ nodes.
    """

    sigma_threshold: float = 4.0

    def flag(self, per_device_tpa: np.ndarray) -> list[int]:
        x = np.asarray(per_device_tpa, float)
        med = np.median(x)
        mad = np.median(np.abs(x - med)) + 1e-9
        z = (x - med) / (1.4826 * mad)
        return [int(i) for i in np.nonzero(z < -self.sigma_threshold)[0]]
