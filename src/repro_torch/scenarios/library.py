"""Labeled fleet scenarios: ground-truth fault injection for detector scoring.

Each scenario is a declarative bundle: a small fleet of `JobSpec`s whose
`faults` field carries post-hoc `CounterFault` perturbations (fault type,
onset, affected jobs/devices, magnitude), plus `GroundTruthEvent` labels
saying what a perfect detector would report.  Because faults apply to the
FINISHED counter grid (`fleet.engine.apply_faults`), the injected ground
truth is exactly the declared perturbation whatever the engine drew —
the port's torch engine replays the same labeled incident on the card
and on the host.

The library pins the paper's headline incidents and the fleet folklore
around them:

  * ``gloo_regression_2p5x``     — §VI's 2.5x collective-library collapse
  * ``mixed_precision_transition`` — FP8<->BF16 switch: OFU halves while the
    app's FLOPs counter keeps billing BF16 (the §V-C divergence story)
  * ``straggler_hosts``          — half the hosts limp, job mean sags
  * ``thermal_throttle``         — a clock-domain drop that later recovers
  * ``preemption_wave``          — two preemption-and-recovery waves across
    the fleet (drives `fleet.recovery` + the goodput detector)
  * ``moe_expert_imbalance``     — periodic expert-routing hot spots
  * ``diurnal_inference``        — benign multi-tenant load swings: ZERO
    labels, so every alert fired is a false positive (precision probe)
  * ``flops_miscalculation``     — §V-C live: the DeepSeek-style MoE's
    `naive_moe` counter (~3x) and the hybrid's `naive_hybrid` (~1.8x)
    stream inflated MFU through the app-reporter path; the correlation
    tier's OFU/MFU-ratio detector must flag exactly those two jobs

`scenarios.scorecard` replays these through the live `Collector` and
scores each detector's precision / recall / time-to-detect against the
labels.  Everything is seeded: `build(name)` is deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.fleet.collector import FLEET_SCOPE
from repro_torch.fleet.engine import CounterFault
from repro_torch.fleet.jobs import JobSpec

#: detectors the scorecard knows how to score
DETECTORS = ("regression", "divergence", "goodput", "miscalc")

#: shared scenario geometry — 2 h of 30 s scrapes, 5 min buckets/rounds:
#: long enough for a 4-bucket detector baseline on both sides of a
#: mid-run onset, small enough that the whole suite replays in CI
INTERVAL_S = 30.0
DURATION_S = 7200.0
BUCKET_S = 300.0


@dataclass(frozen=True)
class GroundTruthEvent:
    """One labeled incident: what a perfect detector would report."""

    job_id: str                  # FLEET_SCOPE for fleet-wide (goodput)
    detector: str                # 'regression' | 'divergence' | 'goodput'
    onset_s: float
    end_s: Optional[float] = None   # None = persists through end of run
    magnitude: float = 0.0          # regression factor / rel err / drop
    note: str = ""

    def __post_init__(self):
        if self.detector not in DETECTORS:
            raise ValueError(f"unknown detector {self.detector!r} "
                             f"(expected one of {DETECTORS})")
        if self.end_s is not None and self.end_s <= self.onset_s:
            raise ValueError(f"label window [{self.onset_s}, {self.end_s}] "
                             "is empty")


@dataclass
class Scenario:
    """A reproducible labeled fleet: specs with injected faults + the
    ground truth, plus the collector geometry the scorecard replays
    it under."""

    name: str
    description: str
    specs: list                  # JobSpec, faults attached
    labels: list                 # GroundTruthEvent
    detectors: Sequence[str] = DETECTORS   # which detectors are scored
    round_s: float = BUCKET_S
    bucket_s: float = BUCKET_S
    retain: int = 24
    detector_kw: dict = field(
        default_factory=lambda: {"window": 4, "min_duration": 2})
    goodput_kw: Optional[dict] = field(
        default_factory=lambda: {"drop_threshold": 0.25, "window": 4,
                                 "min_duration": 2})
    flag_rel_err: float = 0.30
    #: slack appended to each label window when matching alerts — covers
    #: detector sustain (min_duration buckets) + round quantization
    tolerance_s: float = 900.0
    #: job_id -> app-MFU override for the collector stream (None = the
    #: app's reporting follows the hardware, so divergence triage skips
    #: the job; absent = use the simulated app MFU as-is)
    app_mfu: dict = field(default_factory=dict)
    #: job_id -> reported-MFU stream for the collector's app-reporter
    #: path: jobs listed here replay a `MfuReplaySource.constant` series
    #: through `JobStream.mfu_source` (the live correlation tier) instead
    #: of carrying a static `app_mfu` scalar.  None = stream the job's
    #: simulated app MFU; a float = stream that level.
    mfu_stream: dict = field(default_factory=dict)
    #: kwargs for the collector's `CorrelationConfig` ({} = stock
    #: thresholds; None disables the miscalc detector)
    miscalc_kw: Optional[dict] = field(default_factory=dict)

    def __post_init__(self):
        ids = [s.job_id for s in self.specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate job_ids in scenario: {ids}")
        for jid in self.mfu_stream:
            if jid not in ids:
                raise ValueError(f"mfu_stream names unknown job {jid!r} "
                                 f"(have {sorted(ids)})")
        known = set(ids) | {FLEET_SCOPE}
        for lbl in self.labels:
            if lbl.job_id not in known:
                raise ValueError(f"label {lbl} names unknown job "
                                 f"(have {sorted(known)})")
            if lbl.detector not in self.detectors:
                raise ValueError(f"label {lbl} uses unscored detector "
                                 f"{lbl.detector!r}")

    @property
    def duration_s(self) -> float:
        return max(s.duration_s for s in self.specs)


def _job(job_id: str, arch: str, seed: int, **kw) -> JobSpec:
    kw.setdefault("shape", "train_4k")
    kw.setdefault("chips", 64)
    kw.setdefault("true_duty", 0.35)
    kw.setdefault("duration_s", DURATION_S)
    kw.setdefault("scrape_interval_s", INTERVAL_S)
    return JobSpec(job_id, arch, seed=seed, **kw)


def _healthy(n: int = 3, prefix: str = "healthy") -> list:
    """Background jobs every scenario carries — the precision side of the
    scorecard (alerts on these are false positives)."""
    archs = ["llama3.2-3b", "qwen3-4b", "granite-3-2b", "zamba2-7b"]
    return [_job(f"{prefix}-{k}", archs[k % len(archs)], seed=100 + k)
            for k in range(n)]


# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------
def gloo_regression_2p5x() -> Scenario:
    """The paper's §VI headline: a collective-library upgrade quietly
    drops one job's duty cycle 2.5x mid-run and never recovers."""
    onset = 3600.0
    bad = _job("allreduce-7b", "llama3.2-3b", seed=7,
               faults=[CounterFault(start_s=onset, duty_scale=0.4,
                                    kind="gloo_regression")])
    return Scenario(
        name="gloo_regression_2p5x",
        description="2.5x sustained OFU collapse on one job "
                    "(collective-library regression, no recovery)",
        specs=[bad] + _healthy(3),
        labels=[GroundTruthEvent("allreduce-7b", "regression", onset,
                                 magnitude=2.5, note="duty 0.4x")],
        # a hardware slowdown drags app MFU down with it — no divergence
        # story here, so the app side of the faulted job goes unreported
        app_mfu={"allreduce-7b": None},
    )


def mixed_precision_transition() -> Scenario:
    """FP8<->BF16 switch: the MXU finishes the same work in ~55% of the
    cycles, but the framework's FLOPs counter keeps billing the BF16
    recipe — reported MFU holds while OFU steps down (divergence), and
    the step itself reads as a 1.8x regression."""
    onset = 3600.0
    bad = _job("fp8-pilot-13b", "qwen3-4b", seed=13,
               faults=[CounterFault(start_s=onset, duty_scale=0.55,
                                    kind="precision_transition")])
    return Scenario(
        name="mixed_precision_transition",
        description="BF16->FP8 cutover: OFU steps to 0.55x while app MFU "
                    "reports the stale BF16 accounting",
        specs=[bad] + _healthy(3),
        labels=[
            GroundTruthEvent("fp8-pilot-13b", "regression", onset,
                             magnitude=1.0 / 0.55, note="duty 0.55x"),
            GroundTruthEvent("fp8-pilot-13b", "divergence", onset,
                             magnitude=0.8,
                             note="stale BF16 FLOPs accounting"),
        ],
        # tighter retention so window eviction sheds the healthy prefix
        # and the divergence mean converges inside the run
        retain=12,
        tolerance_s=1800.0,
    )


def straggler_hosts() -> Scenario:
    """Half the job's hosts degrade to 20% duty (NIC flaps, a bad rack):
    the job mean sags to 0.6x — a 1.67x regression."""
    onset = 3600.0
    bad = _job("dense-32b", "granite-3-2b", seed=32,
               faults=[CounterFault(start_s=onset, duty_scale=0.2,
                                    device_frac=0.5, kind="straggler")])
    return Scenario(
        name="straggler_hosts",
        description="half the hosts limp at 0.2x duty; job mean drops "
                    "to 0.6x (1.67x regression)",
        specs=[bad] + _healthy(3),
        labels=[GroundTruthEvent("dense-32b", "regression", onset,
                                 magnitude=1.0 / 0.6,
                                 note="device_frac=0.5 at duty 0.2x")],
        app_mfu={"dense-32b": None},
    )


def thermal_throttle() -> Scenario:
    """A clock-domain drop: SMs throttle to 0.6x f_max for 40 minutes,
    then the cooling loop catches up — a RECOVERED regression."""
    onset, end = 2400.0, 4800.0
    bad = _job("prefill-70b", "zamba2-7b", seed=70, shape="prefill_32k",
               faults=[CounterFault(start_s=onset, end_s=end,
                                    clock_scale=0.6, kind="thermal")])
    return Scenario(
        name="thermal_throttle",
        description="clock throttles to 0.6x for 40 min, then recovers",
        specs=[bad] + _healthy(3),
        labels=[GroundTruthEvent("prefill-70b", "regression", onset,
                                 end_s=end, magnitude=1.0 / 0.6,
                                 note="clock 0.6x, bounded")],
        app_mfu={"prefill-70b": None},
    )


def preemption_wave() -> Scenario:
    """Two preemption-and-recovery waves roll the fleet: jobs park at 5%
    duty for 15 minutes, then resume.  Per-job recovered regressions plus
    two fleet-wide goodput drops — the scenario `fleet.recovery` feeds on."""
    w1, w1e = 3000.0, 3900.0
    w2, w2e = 5100.0, 6000.0
    f1 = CounterFault(start_s=w1, end_s=w1e, duty_scale=0.05,
                      kind="preemption")
    f2 = CounterFault(start_s=w2, end_s=w2e, duty_scale=0.05,
                      kind="preemption")
    archs = ["llama3.2-3b", "qwen3-4b", "granite-3-2b", "zamba2-7b",
             "phi-3-vision-4.2b"]
    waves = [(f1,), (f1, f2), (f1, f2), (f2,), (f2,)]
    specs = [_job(f"tenant-{k}", archs[k], seed=200 + k, faults=list(fs))
             for k, fs in enumerate(waves)]
    labels = []
    for k, fs in enumerate(waves):
        for f in fs:
            labels.append(GroundTruthEvent(
                f"tenant-{k}", "regression", f.start_s, end_s=f.end_s,
                magnitude=20.0, note="preempted to 0.05x duty"))
    labels += [
        GroundTruthEvent(FLEET_SCOPE, "goodput", w1, end_s=w1e,
                         magnitude=0.57, note="wave 1: 3/5 jobs parked"),
        GroundTruthEvent(FLEET_SCOPE, "goodput", w2, end_s=w2e,
                         magnitude=0.57, note="wave 2: 4/5 jobs parked"),
    ]
    return Scenario(
        name="preemption_wave",
        description="two preemption waves park 3-4 of 5 jobs at 0.05x "
                    "duty for 15 min each",
        specs=specs,
        labels=labels,
        app_mfu={s.job_id: None for s in specs},
    )


def moe_expert_imbalance() -> Scenario:
    """Expert-routing hot spots: every 30 minutes a 10-minute burst
    starves 3 of 4 sampled devices (duty 0.3x) while the hot expert's
    device stays busy — repeated short recovered regressions."""
    onset = 3600.0
    bad = _job("moe-16b", "deepseek-moe-16b", seed=16,
               flops_variant="exact",
               faults=[CounterFault(start_s=onset, duty_scale=0.3,
                                    device_frac=0.75, period_s=1800.0,
                                    active_frac=1.0 / 3.0,
                                    kind="expert_imbalance")])
    return Scenario(
        name="moe_expert_imbalance",
        description="periodic expert-imbalance bursts: 10 min at ~0.48x "
                    "job mean every 30 min",
        specs=[bad] + _healthy(3),
        # one label spanning the burst train — any burst detection is a
        # true positive; the deduper may page each burst separately
        labels=[GroundTruthEvent("moe-16b", "regression", onset,
                                 magnitude=1.0 / 0.475,
                                 note="periodic bursts, 3/4 devices")],
        app_mfu={"moe-16b": None},
    )


def diurnal_inference() -> Scenario:
    """Benign multi-tenant inference load: every job breathes ±20% on a
    shared diurnal cycle.  NO labels — every alert any detector fires
    here is a false positive, so this scenario is the precision probe."""
    shapes = ["decode_32k", "prefill_32k", "decode_32k", "prefill_32k"]
    archs = ["llama3.2-3b", "qwen3-4b", "phi-3-vision-4.2b", "granite-3-2b"]
    specs = [
        _job(f"serve-{k}", archs[k], seed=300 + k, shape=shapes[k],
             faults=[CounterFault(diurnal_amp=0.2,
                                  diurnal_period_s=DURATION_S,
                                  kind="diurnal_load")])
        for k in range(4)]
    return Scenario(
        name="diurnal_inference",
        description="benign ±20% diurnal load swings on 4 inference "
                    "tenants; zero labels (false-positive probe)",
        specs=specs,
        labels=[],
    )


def flops_miscalculation() -> Scenario:
    """§V-C replayed live: two jobs stream MFU computed from BUGGY FLOPs
    counters through the app-reporter path — the DeepSeek-style MoE
    bills dense FLOPs for sparse experts (`naive_moe`, ~3x inflation at
    671B/288 GPUs) and the hybrid bills attention math for its Mamba
    blocks (`naive_hybrid`, ~1.8x at 7B/256 GPUs).  The hardware is
    perfectly healthy: only the correlation tier's OFU/MFU-ratio scan
    (and divergence triage, once the reporter mean lands in the
    metadata) can see the books are cooked.  Three healthy jobs stream
    truthful MFU as the precision probe."""
    moe = _job("naive-moe-671b", "deepseek-v3-671b", seed=671, chips=288,
               flops_variant="naive_moe", true_duty=0.13)
    hyb = _job("naive-hybrid-7b", "zamba2-7b", seed=72, chips=256,
               flops_variant="naive_hybrid", true_duty=0.20)
    healthy = _healthy(3)
    specs = [moe, hyb] + healthy
    return Scenario(
        name="flops_miscalculation",
        description="two jobs report MFU from miscalculated FLOPs "
                    "counters (naive_moe ~3x, naive_hybrid ~1.8x); "
                    "counters are healthy — only the OFU<->MFU join "
                    "catches it",
        specs=specs,
        labels=[
            GroundTruthEvent("naive-moe-671b", "miscalc", 0.0,
                             magnitude=3.0,
                             note="dense-billed sparse experts"),
            GroundTruthEvent("naive-hybrid-7b", "miscalc", 0.0,
                             magnitude=1.8,
                             note="attention-billed Mamba blocks"),
            GroundTruthEvent("naive-moe-671b", "divergence", 0.0,
                             magnitude=1.9, note="rel err ~190%"),
            GroundTruthEvent("naive-hybrid-7b", "divergence", 0.0,
                             magnitude=0.85, note="rel err ~85%"),
        ],
        # every job streams its (possibly cooked) reported MFU live
        mfu_stream={s.job_id: None for s in specs},
    )


#: name -> builder; `build` is the public constructor
SCENARIOS = {
    "gloo_regression_2p5x": gloo_regression_2p5x,
    "mixed_precision_transition": mixed_precision_transition,
    "straggler_hosts": straggler_hosts,
    "thermal_throttle": thermal_throttle,
    "preemption_wave": preemption_wave,
    "moe_expert_imbalance": moe_expert_imbalance,
    "diurnal_inference": diurnal_inference,
    "flops_miscalculation": flops_miscalculation,
}


def scenario_names() -> list:
    return sorted(SCENARIOS)


def build(name: str) -> Scenario:
    """Construct a scenario by name (deterministic: same name, same
    scenario, same counter realization under a given engine)."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have {scenario_names()})") from None
    return builder()
