"""Detector scorecard: replay labeled scenarios, score the alerts.

`run_scenario` simulates a scenario's fleet once on the torch engine, on
the card unless the caller passes `device="cpu"` (the faults are
post-hoc, so every draw carries identical ground truth),
replays the perturbed grids through a LIVE `Collector` via `GridSource`
(round-for-round, same code path production would run), and collects
every alert the detectors fire.

`score_alerts` matches alerts against the scenario's `GroundTruthEvent`
labels with tolerance windows:

  * an alert MATCHES a label when job ids agree, the alert kind equals
    the label's detector, and the alert fires inside
    ``[onset_s, end_s + tolerance_s]`` (end_s = end of run for
    open-ended labels);
  * **precision**  = matched alerts / fired alerts (1.0 when silent);
  * **recall**     = matched labels / labels (1.0 when nothing to find);
  * **time-to-detect** = first matching alert's collector clock minus
    the label's onset, averaged over detected labels (None if none).

`run_scorecard` sweeps the whole library into one JSON document
(schema ``fleet-scorecard-v1``), and `check_floors` enforces the pinned
per-(scenario, detector) floors — the CI contract that a detector
refactor may tighten but never silently regress.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.fleet.collector import (Collector, CollectorConfig, JobStream)
from repro_torch.fleet.jobs import simulate_fleet
from repro_torch.fleet.streaming import precision_label
from repro_torch.scenarios.library import Scenario, build, scenario_names
from repro_torch.telemetry.mfu import MfuReplaySource
from repro_torch.telemetry.source import GridSource

SCHEMA = "fleet-scorecard-v1"


@dataclass
class ScenarioRun:
    """One replayed scenario: the collector's full alert log + handles
    for deeper inspection (recovery integration, debugging)."""

    scenario: Scenario
    alerts: list                 # every Alert the collector fired
    collector: object            # the Collector, post-run
    telemetry: list              # JobTelemetry per spec


@dataclass
class DetectorScore:
    """Precision / recall / time-to-detect for one (scenario, detector)."""

    scenario: str
    detector: str
    precision: float
    recall: float
    ttd_s: Optional[float]       # None = nothing detected (or no labels)
    n_alerts: int
    n_matched_alerts: int
    n_labels: int
    n_matched_labels: int

    def as_dict(self) -> dict:
        return {"precision": self.precision, "recall": self.recall,
                "ttd_s": self.ttd_s, "n_alerts": self.n_alerts,
                "matched_alerts": self.n_matched_alerts,
                "n_labels": self.n_labels,
                "matched_labels": self.n_matched_labels}


def run_scenario(sc: Scenario, *, engine: str = "torch",
                 max_devices: int = 4, device=None) -> ScenarioRun:
    """Simulate + replay one scenario through a live Collector (grids on
    `device`, the current CUDA device when None)."""
    tels = simulate_fleet(sc.specs, max_devices=max_devices, engine=engine,
                          device=device)
    streams = []
    for spec, tel in zip(sc.specs, tels):
        app_mfu = sc.app_mfu.get(spec.job_id, tel.app_mfu)
        mfu_src = None
        if spec.job_id in sc.mfu_stream:
            # the job reports MFU LIVE through the app-reporter path:
            # a constant sample stream at the scrape cadence, at the
            # job's (possibly miscalculated) reported level — the
            # collector's MfuRollup + divergence metadata both follow
            # the reporter instead of a static scalar
            level = sc.mfu_stream[spec.job_id]
            mfu_src = MfuReplaySource.constant(
                tel.app_mfu if level is None else float(level),
                duration_s=spec.duration_s,
                interval_s=spec.scrape_interval_s)
            app_mfu = None
        streams.append(JobStream(
            spec.job_id, GridSource(tel.grid), chips=spec.chips,
            group=precision_label(spec.precisions), app_mfu=app_mfu,
            arch=spec.arch, flops_variant=spec.flops_variant,
            chip=spec.chip, mfu_source=mfu_src))
    col = Collector(streams, CollectorConfig(
        round_s=sc.round_s, bucket_s=sc.bucket_s, retain=sc.retain,
        detector=dict(sc.detector_kw),
        goodput=dict(sc.goodput_kw) if sc.goodput_kw is not None else None,
        flag_rel_err=sc.flag_rel_err,
        miscalc=dict(sc.miscalc_kw) if sc.miscalc_kw is not None
        else None))
    col.run()                    # GridSources are bounded: runs to the end
    return ScenarioRun(sc, list(col.alerts), col, tels)


def _label_window(sc: Scenario, lbl) -> tuple:
    end = lbl.end_s if lbl.end_s is not None else sc.duration_s
    return lbl.onset_s, end + sc.tolerance_s


def _matches(sc: Scenario, alert, lbl) -> bool:
    if alert.job_id != lbl.job_id or alert.kind != lbl.detector:
        return False
    lo, hi = _label_window(sc, lbl)
    return lo <= alert.t_s <= hi


def score_alerts(sc: Scenario, alerts: Sequence) -> dict:
    """Score one scenario's alert log: {detector: DetectorScore}."""
    out = {}
    for det in sc.detectors:
        fired = [a for a in alerts if a.kind == det]
        labels = [l for l in sc.labels if l.detector == det]
        matched_alerts = [a for a in fired
                          if any(_matches(sc, a, l) for l in labels)]
        ttds = []
        n_matched_labels = 0
        for lbl in labels:
            hits = sorted(a.t_s for a in fired if _matches(sc, a, lbl))
            if hits:
                n_matched_labels += 1
                ttds.append(hits[0] - lbl.onset_s)
        out[det] = DetectorScore(
            scenario=sc.name, detector=det,
            precision=len(matched_alerts) / len(fired) if fired else 1.0,
            recall=n_matched_labels / len(labels) if labels else 1.0,
            ttd_s=sum(ttds) / len(ttds) if ttds else None,
            n_alerts=len(fired), n_matched_alerts=len(matched_alerts),
            n_labels=len(labels), n_matched_labels=n_matched_labels)
    return out


def run_scorecard(names: Optional[Sequence[str]] = None, *,
                  engine: str = "torch", max_devices: int = 4,
                  device=None) -> dict:
    """Replay + score scenarios into the frozen JSON document shape."""
    doc = {"schema": SCHEMA, "engine": engine, "scenarios": {}}
    for name in (names if names is not None else scenario_names()):
        sc = build(name)
        run = run_scenario(sc, engine=engine, max_devices=max_devices,
                           device=device)
        scores = score_alerts(sc, run.alerts)
        doc["scenarios"][name] = {
            "description": sc.description,
            "n_jobs": len(sc.specs),
            "duration_s": sc.duration_s,
            "n_alerts": len(run.alerts),
            "detectors": {det: s.as_dict() for det, s in scores.items()},
        }
    return doc


# ---------------------------------------------------------------------------
# pinned floors — the CI contract
# ---------------------------------------------------------------------------
#: (scenario, detector) -> {"precision": min, "recall": min,
#: "ttd_s": max}.  Keys may pin any subset.  Values were set from the
#: measured scorecard with slack for engine-to-engine jitter; a detector
#: change may BEAT them, never regress them (tools/fleet_scorecard.py
#: --self-check fails CI on any violation).
FLOORS = {
    ("gloo_regression_2p5x", "regression"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("gloo_regression_2p5x", "divergence"): {"precision": 1.0},
    ("gloo_regression_2p5x", "goodput"): {"precision": 1.0},
    ("mixed_precision_transition", "regression"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("mixed_precision_transition", "divergence"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 2400.0},
    ("straggler_hosts", "regression"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("straggler_hosts", "divergence"): {"precision": 1.0},
    ("thermal_throttle", "regression"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("preemption_wave", "regression"):
        {"precision": 1.0, "recall": 0.85, "ttd_s": 1200.0},
    ("preemption_wave", "goodput"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("moe_expert_imbalance", "regression"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("diurnal_inference", "regression"): {"precision": 1.0},
    ("diurnal_inference", "divergence"): {"precision": 1.0},
    ("diurnal_inference", "goodput"): {"precision": 1.0},
    ("diurnal_inference", "miscalc"): {"precision": 1.0},
    ("flops_miscalculation", "miscalc"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 600.0},
    ("flops_miscalculation", "divergence"):
        {"precision": 1.0, "recall": 1.0, "ttd_s": 1200.0},
    ("flops_miscalculation", "regression"): {"precision": 1.0},
    ("flops_miscalculation", "goodput"): {"precision": 1.0},
}


def check_floors(doc: dict, floors: Optional[dict] = None) -> list:
    """Return human-readable floor violations (empty = scorecard holds).

    Precision/recall floors are minimums, ttd_s a maximum; a floored
    ttd_s also requires a detection (ttd None = undetected = violation).
    """
    floors = FLOORS if floors is None else floors
    bad = []
    for (scen, det), floor in sorted(floors.items()):
        entry = doc.get("scenarios", {}).get(scen, {}) \
                   .get("detectors", {}).get(det)
        if entry is None:
            bad.append(f"{scen}/{det}: missing from scorecard")
            continue
        for key in ("precision", "recall"):
            if key in floor and entry[key] < floor[key] - 1e-9:
                bad.append(f"{scen}/{det}: {key} {entry[key]:.3f} "
                           f"< floor {floor[key]:.3f}")
        if "ttd_s" in floor:
            ttd = entry.get("ttd_s")
            if ttd is None:
                bad.append(f"{scen}/{det}: no detection "
                           f"(ttd floor {floor['ttd_s']:.0f}s)")
            elif ttd > floor["ttd_s"] + 1e-9:
                bad.append(f"{scen}/{det}: ttd {ttd:.0f}s "
                           f"> floor {floor['ttd_s']:.0f}s")
    return bad
