"""Continuous collector daemon: the paper's §VI operational loop.

The batch pipeline (source → rollup → detector) answers "what happened";
the paper's deployed story is *continuous* visibility — OFU dashboards
that caught the 2.5× Gloo regression live.  This module closes that loop:

  * `Collector` drives repeated `TelemetrySource.poll()` rounds into one
    incremental `WindowedRollup` (bounded memory: full per-bucket detail
    for the retention window, all-time totals beyond it) and fires
    `regression.scan_rollup` + `divergence.analyze_rollup` after every
    round, with per-episode alert deduplication and clear-side hysteresis
    so a sustained collapse pages once, not once per round.
  * `AdaptiveScrapeController` implements the Table I noise-vs-interval
    tradeoff as a controller: when a job's per-round OFU dispersion spikes
    (something is happening — an event boundary, a straggler, clock
    throttling), tighten its scrape interval for resolution; when it has
    been quiet, relax it back toward the cheap cadence.  Every retiming
    goes through the shared §IV-C `check_scrape_interval` policy.
  * `FleetCollector` runs per-host collectors and periodically
    `tree_reduce`s their windowed snapshots into one fleet rollup — raw
    scrapes never leave their host, dashboards update every round.

See docs/ARCHITECTURE.md for where this sits in the pipeline and how a
live DCGM/libtpu `BackendSource` slots under it unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.fleet.correlation import (CorrelationConfig, MfuRollup,
                                     scan_miscalc)
from repro_torch.fleet.distributed import tree_reduce
from repro_torch.fleet.divergence import DEFAULT_OFU_FLOOR, analyze_rollup
from repro_torch.fleet.goodput import scan_goodput
from repro_torch.fleet.regression import scan_rollup

#: the fleet-scope pseudo job id goodput alerts carry (no single job
#: owns a fleet-wide OFU drop)
FLEET_SCOPE = "__fleet__"
from repro_torch.fleet.streaming import WindowedRollup
from repro_torch.telemetry.counters import (MAX_HW_AVG_WINDOW_S,
                                      check_scrape_interval)
from repro_torch.telemetry.source import TelemetrySource


@dataclass
class JobStream:
    """One monitored job: a telemetry source plus its rollup metadata."""

    job_id: str
    source: TelemetrySource
    chips: Optional[int] = None      # true device count (chip-weighting)
    group: str = "unknown"           # precision mix / cohort label
    app_mfu: Optional[float] = None  # app-reported MFU, enables divergence
    arch: str = "unknown"
    flops_variant: str = "exact"
    chip: ChipSpec = DEFAULT_CHIP
    #: live app-MFU sample stream (`telemetry.mfu.MfuReplaySource`, or a
    #: `MfuReporter.to_source()` snapshot): polled every round alongside
    #: the counter source into the collector's `MfuRollup`.  When set and
    #: `app_mfu` is None, the job's divergence metadata tracks the
    #: reporter's running mean instead of a static scalar.
    mfu_source: Optional[object] = None


# ---------------------------------------------------------------------------
# Adaptive scrape scheduling (Table I noise-vs-interval tradeoff)
# ---------------------------------------------------------------------------
@dataclass
class AdaptiveConfig:
    """Knobs for `AdaptiveScrapeController`.

    The controller trades scrape cost against temporal resolution: Table I
    shows short intervals buy per-bucket noise averaging (more samples per
    bucket) at higher collection cost.  Dispersion is cheap to watch, so
    we pay for resolution only when a job's samples start disagreeing.
    """

    min_interval_s: float = 5.0
    max_interval_s: float = MAX_HW_AVG_WINDOW_S   # §IV-C hard ceiling
    tighten: float = 0.5         # interval multiplier on a dispersion spike
    relax: float = 2.0           # interval multiplier after quiet_rounds
    spike_ratio: float = 2.0     # round std vs EMA baseline => spike
    quiet_rounds: int = 3        # consecutive calm rounds before relaxing
    ema: float = 0.2             # baseline update rate
    episode_aware: bool = True   # pin a job hot while an alert is open

    def __post_init__(self):
        if not 0 < self.min_interval_s <= self.max_interval_s:
            raise ValueError(f"need 0 < min_interval_s "
                             f"({self.min_interval_s}) <= max_interval_s "
                             f"({self.max_interval_s})")
        # the ceiling itself must satisfy §IV-C, or relaxing would push a
        # source into average-of-averages territory
        check_scrape_interval(self.max_interval_s)


class AdaptiveScrapeController:
    """Per-job scrape-interval controller.

    `update(job_id, ofu_samples, interval_s)` returns the interval the
    NEXT round should use: tightened (× cfg.tighten, floored at
    min_interval_s) when the round's OFU standard deviation exceeds
    `spike_ratio` × the job's EMA baseline, relaxed (× cfg.relax, capped
    at max_interval_s) after `quiet_rounds` consecutive calm rounds, and
    unchanged otherwise.  Every returned interval passes
    `check_scrape_interval` by construction of the bounds.

    DETECTOR-AWARE scheduling: `episode_open=True` (the collector passes
    it while the job has an open regression/divergence alert episode)
    overrides the dispersion signal — the interval tightens toward
    min_interval_s and HOLDS there for as long as the episode stays open,
    because an active incident wants maximum temporal resolution even
    when the regressed level itself is quiet.  Once the episode clears,
    the normal quiet-rounds relaxation takes the interval back up.
    """

    def __init__(self, cfg: Optional[AdaptiveConfig] = None):
        self.cfg = cfg or AdaptiveConfig()
        self._baseline: dict = {}    # job_id -> EMA of round std
        self._quiet: dict = {}       # job_id -> consecutive calm rounds

    def update(self, job_id: str, ofu_samples: np.ndarray,
               interval_s: float, *, episode_open: bool = False) -> float:
        cfg = self.cfg
        n, std = _count_std(ofu_samples)
        if episode_open and cfg.episode_aware:
            # an open alert episode pins the job hot: step toward the
            # floor and never bank quiet rounds while the incident lasts
            # (the dispersion branch below handles pre-detection spikes)
            self._quiet[job_id] = 0
            if n >= 2:
                base = self._baseline.get(job_id)
                # absorb the episode's dispersion so post-clear rounds
                # compare against the regime they actually live in
                self._baseline[job_id] = std if base is None \
                    else (1 - cfg.ema) * base + cfg.ema * std
            new = min(cfg.max_interval_s,
                      max(cfg.min_interval_s, interval_s * cfg.tighten))
            if new != interval_s:
                check_scrape_interval(new)
            return new
        if n < 2:
            return interval_s
        base = self._baseline.get(job_id)
        new = interval_s
        if base is not None and std > cfg.spike_ratio * max(base, 1e-4):
            # clamp into [min, max] — a degraded source may START beyond
            # max_interval_s, and a half-step from there can still
            # overshoot the §IV-C ceiling
            new = min(cfg.max_interval_s,
                      max(cfg.min_interval_s, interval_s * cfg.tighten))
            self._quiet[job_id] = 0
            # bounded staleness: absorb the spike level at a CAPPED rate,
            # so a one-round transient barely moves the baseline (the next
            # quiet round still looks quiet against the pre-spike level)
            # but a PERMANENT dispersion shift re-baselines within ~a
            # dozen rounds instead of pinning the interval at min forever
            self._baseline[job_id] = (1 - cfg.ema) * base + cfg.ema \
                * min(std, cfg.spike_ratio * max(base, 1e-4))
        else:
            quiet = self._quiet.get(job_id, 0) + 1
            self._quiet[job_id] = quiet
            if quiet >= cfg.quiet_rounds and interval_s < cfg.max_interval_s:
                new = min(cfg.max_interval_s, interval_s * cfg.relax)
                self._quiet[job_id] = 0
            self._baseline[job_id] = std if base is None \
                else (1 - cfg.ema) * base + cfg.ema * std
        if new != interval_s:
            # §IV-C on every RETIMING; an unchanged interval is the
            # source's own pre-existing policy (a degraded strict=False
            # source may legitimately sit beyond the averaging window —
            # the first tighten pulls it into the compliant band and the
            # relax ceiling keeps it there)
            check_scrape_interval(new)
        return new


def _count_std(ofu_samples) -> tuple:
    """(count, population std) of one round's OFU samples; std is nan
    below two samples.  A tensor is reduced on its own device in float64
    and only the two scalars reach the host: the (D, S) OFU grid of a
    card-resident round never crosses."""
    if isinstance(ofu_samples, torch.Tensor):
        n = ofu_samples.numel()
        if n < 2:
            return n, float("nan")
        return n, float(ofu_samples.double().std(correction=0))
    samples = np.asarray(ofu_samples, float).ravel()
    if samples.size < 2:
        return samples.size, float("nan")
    return samples.size, float(np.std(samples))


# ---------------------------------------------------------------------------
# Alert deduplication + hysteresis
# ---------------------------------------------------------------------------
@dataclass
class Alert:
    """One fired alert (an episode fires once; see AlertDeduper)."""

    round_idx: int
    t_s: float                   # collector clock when fired
    job_id: str
    kind: str                    # 'regression'|'divergence'|'goodput'|'miscalc'
    message: str
    factor: float = float("nan")  # regression factor / divergence rel err

    def summary(self) -> str:
        return (f"[round {self.round_idx} t={self.t_s:.0f}s] "
                f"{self.kind.upper()} {self.job_id}: {self.message}")


class AlertDeduper:
    """Per-episode dedup with clear-side hysteresis and anchor tracking.

    A detector finding is keyed (job, kind) plus an optional EPISODE
    ANCHOR (the regression's absolute start bucket).  A sighting matches
    an active episode when its anchor is within `anchor_tolerance` of the
    episode's — matching refreshes the stored anchor, so the gradual
    drift that window eviction induces (it erodes the detector's
    reference baseline, shifting the detected start index of one and the
    same collapse) is tracked, not re-paged.  A sighting with no nearby
    active episode is a NEW episode and fires — a second, distinct
    collapse pages even while an older dip still sits in the retained
    window.  Episodes retire after `clear_rounds` consecutive rounds
    unseen (hysteresis against threshold flicker), re-arming the slot.
    """

    def __init__(self, clear_rounds: int = 2, *, anchor_tolerance: int = 0):
        if clear_rounds < 1:
            raise ValueError(f"clear_rounds={clear_rounds} must be >= 1")
        self.clear_rounds = int(clear_rounds)
        self.anchor_tolerance = int(anchor_tolerance)
        self._active: dict = {}    # key -> list of [anchor, quiet_rounds]

    def offer(self, key, anchor: Optional[int] = None) -> bool:
        """Register a sighting; True if an alert should fire."""
        episodes = self._active.setdefault(key, [])
        for ep in episodes:
            if (anchor is None) == (ep[0] is None) and (
                    anchor is None
                    or abs(anchor - ep[0]) <= self.anchor_tolerance):
                ep[0] = anchor       # track drift
                ep[1] = -1           # seen this round (tick() sets to 0)
                return False
        episodes.append([anchor, -1])
        return True

    def tick(self) -> None:
        """End of round: age episodes, retire those quiet long enough."""
        for key, episodes in list(self._active.items()):
            kept = []
            for ep in episodes:
                ep[1] += 1
                if ep[1] < self.clear_rounds:
                    kept.append(ep)
            if kept:
                self._active[key] = kept
            else:
                del self._active[key]

    @property
    def active(self) -> list:
        return sorted(self._active, key=repr)

    @property
    def active_jobs(self) -> set:
        """Jobs with at least one open episode of any kind — what the
        detector-aware adaptive scheduler keys its tighten/hold on."""
        return {key[0] for key in self._active}


# ---------------------------------------------------------------------------
# The collector daemon
# ---------------------------------------------------------------------------
@dataclass
class CollectorConfig:
    round_s: float = 300.0       # wall-time collected per round
    bucket_s: float = 300.0
    retain: int = 24             # window buckets kept in full detail
    bins: int = 128
    detector: dict = field(      # kwargs for regression.scan_rollup
        default_factory=lambda: {"window": 4, "min_duration": 2})
    flag_rel_err: float = 0.30   # divergence threshold
    ofu_floor: float = DEFAULT_OFU_FLOOR   # idle jobs exempt from flagging
    clear_rounds: int = 2        # alert hysteresis
    adaptive: Optional[AdaptiveConfig] = None   # None = fixed intervals
    #: kwargs for `goodput.scan_goodput` (e.g. {"drop_threshold": 0.25,
    #: "window": 4, "min_duration": 2}); None disables the fleet-wide
    #: goodput drop detector (the default — fleet scans are opt-in)
    goodput: Optional[dict] = None
    #: kwargs for `correlation.CorrelationConfig` (e.g.
    #: {"ratio_high": 1.5}); the default {} enables the OFU/MFU-ratio
    #: miscalculation detector with stock thresholds — it is a no-op
    #: until some stream carries an `mfu_source`.  None disables it.
    miscalc: Optional[dict] = field(default_factory=dict)

    def __post_init__(self):
        if self.round_s <= 0:
            raise ValueError(f"round_s={self.round_s} must be positive")
        if self.adaptive and self.adaptive.max_interval_s > self.round_s:
            # relaxing beyond the round length would starve poll() of a
            # full sample; clamp the controller's ceiling to the cadence
            raise ValueError(
                f"adaptive max_interval_s={self.adaptive.max_interval_s} "
                f"exceeds round_s={self.round_s}; a round must fit at "
                "least one scrape")


@dataclass
class RoundReport:
    """What one collection round did — the dashboard's refresh record."""

    round_idx: int
    t_s: float                   # collector clock after the round
    samples: int                 # counter samples ingested this round
    alerts: list
    intervals: dict              # job_id -> interval_s after retiming
    rollup_summary: str

    def summary(self) -> str:
        lines = [f"round {self.round_idx} t={self.t_s:.0f}s "
                 f"samples={self.samples} alerts={len(self.alerts)} | "
                 f"{self.rollup_summary}"]
        lines += [f"  {a.summary()}" for a in self.alerts]
        return "\n".join(lines)


def _require_bounded(streams: Sequence[JobStream]) -> None:
    """Reject run(n_rounds=None) over streams that can never exhaust."""
    unbounded = [st.job_id for st in streams if not st.source.bounded]
    if unbounded:
        raise ValueError(
            f"n_rounds is required when any stream is unbounded "
            f"(no finite duration_s / bounded override): {unbounded}")


class Collector:
    """Long-lived collection loop over a set of job streams.

    Each `poll_round()`:
      1. polls every non-exhausted stream for the next `round_s` seconds
         of counters and folds the grids into the windowed rollup;
      2. lets the adaptive controller retime retimable sources from the
         round's OFU dispersion;
      3. scans the retained window with the regression detector and the
         divergence triage, routing findings through the alert deduper.

    The rollup is a `WindowedRollup`, so a collector that runs for a week
    holds the same memory as one that ran for an hour; `snapshot()` ships
    the windowed state to a reducer (see `FleetCollector`).
    """

    def __init__(self, streams: Sequence[JobStream],
                 config: Optional[CollectorConfig] = None, *,
                 rollup: Optional[WindowedRollup] = None,
                 clock_s: float = 0.0, round_idx: int = 0,
                 on_grid=None):
        """`rollup`/`clock_s`/`round_idx` restore a collector from a
        `snapshot()` across a process restart: pass
        `WindowedRollup.from_bytes(snap)` plus the old collector's clock
        and round count, and `seek()` each replay source to where its
        predecessor's cursor stood — polling resumes mid-trace with the
        retained window intact.  The rollup snapshot does NOT carry the
        alert log or episode hysteresis; restore those separately via
        `restore_alert_state(alert_state())` (as `ServiceDaemon`
        persistence does), or an episode still open across the restart
        re-fires once.

        `on_grid(stream, grid)` is the per-poll round hook: called with
        every non-empty polled DeviceGrid BEFORE rollup ingestion — the
        recording-mode tee point (`repro_torch.serve.ServiceDaemon` routes
        grids into per-job `TraceWriter`s through it)."""
        self.streams = list(streams)
        ids = [st.job_id for st in self.streams]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate job_ids in streams: {ids}")
        self.config = config or CollectorConfig()
        cfg = self.config
        if rollup is not None and (rollup.bucket_s != cfg.bucket_s
                                   or rollup.retain != cfg.retain
                                   or rollup.bins != cfg.bins):
            raise ValueError(
                f"restored rollup (bucket_s={rollup.bucket_s}, "
                f"retain={rollup.retain}, bins={rollup.bins}) does not "
                f"match config (bucket_s={cfg.bucket_s}, "
                f"retain={cfg.retain}, bins={cfg.bins})")
        self.rollup = rollup if rollup is not None else WindowedRollup(
            cfg.bucket_s, retain=cfg.retain, bins=cfg.bins)
        self.controller = (AdaptiveScrapeController(cfg.adaptive)
                           if cfg.adaptive else None)
        #: app-reported MFU samples bucketed on the SAME grid as the
        #: rollup — the correlation tier's other half
        self.mfu = MfuRollup(cfg.bucket_s)
        self._miscalc_cfg = None if cfg.miscalc is None else \
            CorrelationConfig(**{"ofu_floor": cfg.ofu_floor,
                                 **cfg.miscalc})
        # eviction drifts a detection's start index by at most the
        # detector's reference window per round; anchors within that
        # tolerance are the same episode
        self.deduper = AlertDeduper(
            cfg.clear_rounds,
            anchor_tolerance=cfg.detector.get("window", 10))
        self.round_idx = int(round_idx)
        self.clock_s = float(clock_s)
        self.alerts: list = []       # every alert ever fired, in order
        self.on_grid = on_grid

    @property
    def done(self) -> bool:
        return all(st.source.exhausted for st in self.streams)

    # -- stream churn (a long-lived daemon's jobs come and go) ----------
    def add_stream(self, stream: JobStream) -> None:
        """Attach a stream mid-run; it joins the NEXT poll round.  Its
        grids carry their own absolute t0_s, so a late joiner lands in
        the right buckets (samples older than the retention horizon fold
        into the all-time totals, exactly as batch ingestion would)."""
        if any(st.job_id == stream.job_id for st in self.streams):
            raise ValueError(f"duplicate job_id {stream.job_id!r}")
        self.streams.append(stream)

    def remove_stream(self, job_id: str) -> JobStream:
        """Detach a stream and return it.  Already-ingested buckets stay
        in the rollup (history is history); the regression sweep stops
        scanning the job next round, and any open alert episode retires
        after `clear_rounds` quiet rounds like a recovery would."""
        for k, st in enumerate(self.streams):
            if st.job_id == job_id:
                return self.streams.pop(k)
        raise KeyError(f"no stream with job_id {job_id!r} "
                       f"(have {[s.job_id for s in self.streams]})")

    def snapshot(self) -> bytes:
        """The windowed rollup's wire-format state (kilobytes)."""
        return self.rollup.to_bytes()

    # -- alert history + episode hysteresis (restart persistence) -------
    def alert_state(self) -> dict:
        """JSON-safe snapshot of the alert log AND the deduper's open
        episodes — what `ServiceDaemon.persist` writes so a restarted
        daemon neither forgets fired alerts nor re-pages episodes it
        already surfaced."""
        return {
            "alerts": [{"round_idx": a.round_idx, "t_s": a.t_s,
                        "job_id": a.job_id, "kind": a.kind,
                        "message": a.message,
                        "factor": float(a.factor)
                        if np.isfinite(a.factor) else None}
                       for a in self.alerts],
            "episodes": [[list(key), ep[0], ep[1]]
                         for key, eps in self.deduper._active.items()
                         for ep in eps],
        }

    def restore_alert_state(self, state: dict) -> None:
        """Rebuild the alert log and open-episode hysteresis from
        `alert_state()` output (the `ServiceDaemon.restore` path).  An
        episode that was open at persist time is re-armed as open here,
        so the detector re-seeing the same collapse next round refreshes
        it silently instead of paging a duplicate."""
        self.alerts = [
            Alert(int(a["round_idx"]), float(a["t_s"]), a["job_id"],
                  a["kind"], a["message"],
                  factor=float("nan") if a.get("factor") is None
                  else float(a["factor"]))
            for a in state.get("alerts", ())]
        active: dict = {}
        for key, anchor, quiet in state.get("episodes", ()):
            active.setdefault(tuple(key), []).append(
                [None if anchor is None else int(anchor), int(quiet)])
        self.deduper._active = active

    # -- one round ------------------------------------------------------
    def _collect(self) -> int:
        cfg = self.config
        n_samples = 0
        # last round's open episodes drive detector-aware retiming (the
        # detectors for THIS round haven't run yet when we poll)
        hot = self.deduper.active_jobs if self.controller else ()
        for st in self.streams:
            # the app reporter's samples land first, so this round's
            # divergence metadata already reflects them
            if st.mfu_source is not None and not st.mfu_source.exhausted:
                t_s, mfu = st.mfu_source.poll(cfg.round_s)
                if len(t_s):
                    self.mfu.observe_series(st.job_id, t_s, mfu)
            src = st.source
            if src.exhausted:
                continue
            grid = src.poll(cfg.round_s)
            # a count that holds for NumPy arrays and tensors alike (a
            # tensor's .size is a method)
            n_grid = math.prod(grid.tpa.shape)
            if n_grid == 0:
                continue
            if self.on_grid is not None:
                self.on_grid(st, grid)
            app_mfu = st.app_mfu
            if app_mfu is None and st.mfu_source is not None:
                app_mfu = self.mfu.job_mean(st.job_id)
            ofu = self.rollup.add_grid(
                st.job_id, grid, chip=st.chip, group=st.group,
                chips=st.chips, app_mfu=app_mfu, arch=st.arch,
                flops_variant=st.flops_variant)
            n_samples += n_grid
            if self.controller is not None and src.retimable:
                new = self.controller.update(st.job_id, ofu,
                                             src.interval_s,
                                             episode_open=st.job_id in hot)
                if new != src.interval_s:
                    src.set_interval(new)
        return n_samples

    def _detect(self) -> list:
        cfg = self.config
        fired = []
        live = [st.job_id for st in self.streams]
        for jid, regs in scan_rollup(self.rollup, jobs=live,
                                     **cfg.detector).items():
            for r in regs:
                # each detection is an episode anchored at its ABSOLUTE
                # start bucket; the deduper tracks anchor drift and
                # swallows repeats, so one collapse pages once while a
                # later, distinct collapse still pages
                anchor = self.rollup.bucket0 + r.start_idx
                if self.deduper.offer((jid, "regression"), anchor=anchor):
                    state = "ongoing" if r.end_idx is None else "recovered"
                    fired.append(Alert(
                        self.round_idx, self.clock_s, jid, "regression",
                        f"{r.factor:.2f}x OFU collapse "
                        f"({r.ref_ofu * 100:.1f}% -> {r.low_ofu * 100:.1f}%"
                        f", {state})", factor=r.factor))
        if cfg.goodput is not None:
            for ev in scan_goodput(self.rollup, **cfg.goodput):
                anchor = self.rollup.bucket0 + ev.start_idx
                if self.deduper.offer((FLEET_SCOPE, "goodput"),
                                      anchor=anchor):
                    state = "ongoing" if ev.end_idx is None else "recovered"
                    fired.append(Alert(
                        self.round_idx, self.clock_s, FLEET_SCOPE,
                        "goodput",
                        f"fleet OFU down {ev.drop_frac * 100:.0f}% "
                        f"({ev.ref_ofu * 100:.1f}% -> "
                        f"{ev.low_ofu * 100:.1f}%, {state})",
                        factor=ev.drop_frac))
        if self._miscalc_cfg is not None:
            # like divergence, a miscalculated counter is a property of
            # the whole joined population, not a window event — episodes
            # are unanchored and stay open while the ratio stays out
            for f in scan_miscalc(self.mfu, self.rollup,
                                  config=self._miscalc_cfg):
                if self.deduper.offer((f.job_id, "miscalc")):
                    fired.append(Alert(
                        self.round_idx, self.clock_s, f.job_id,
                        "miscalc",
                        f"reported MFU {f.mfu * 100:.1f}% is "
                        f"{f.ratio:.2f}x adjusted OFU "
                        f"{f.ofu_adj * 100:.1f}% over {f.n_buckets} "
                        f"buckets ({f.direction}) — FLOPs accounting "
                        "suspect", factor=f.ratio))
        rep = analyze_rollup(self.rollup, flag_rel_err=cfg.flag_rel_err,
                             ofu_floor=cfg.ofu_floor, empty_ok=True)
        if rep is not None:
            for p in rep.flagged:
                if self.deduper.offer((p.job_id, "divergence")):
                    fired.append(Alert(
                        self.round_idx, self.clock_s, p.job_id,
                        "divergence",
                        f"app MFU {p.mfu * 100:.1f}% vs OFU "
                        f"{p.ofu * 100:.1f}% (rel err "
                        f"{p.rel_err * 100:.0f}%) — audit the FLOPs "
                        "counter", factor=p.rel_err))
        self.deduper.tick()
        return fired

    def poll_round(self) -> RoundReport:
        """Collect one round, run the detectors, return the report."""
        cfg = self.config
        n_samples = self._collect()
        self.clock_s += cfg.round_s
        self.round_idx += 1
        fired = self._detect()
        self.alerts.extend(fired)
        return RoundReport(
            self.round_idx, self.clock_s, n_samples, fired,
            {st.job_id: getattr(st.source, "interval_s", None)
             for st in self.streams},
            self.rollup.summary())

    def run(self, n_rounds: Optional[int] = None) -> list:
        """Round loop: until every stream is exhausted, or n_rounds."""
        if n_rounds is None:
            _require_bounded(self.streams)
        reports = []
        while (n_rounds is None or len(reports) < n_rounds) \
                and not self.done:
            reports.append(self.poll_round())
        return reports


class FleetCollector:
    """Per-host collectors + periodic tree_reduce rounds.

    Each host's `Collector` sees only its own streams; every
    `reduce_every` rounds the hosts' windowed snapshots tree-reduce into
    `self.fleet` — the continuously-refreshing fleet dashboard state.
    Host-level alerts keep firing locally; `scan()` runs the regression
    sweep over the reduced fleet view.
    """

    def __init__(self, collectors: Sequence[Collector], *, fanin: int = 2,
                 reduce_every: int = 1):
        if not collectors:
            raise ValueError("FleetCollector needs at least one Collector")
        if reduce_every < 1:
            raise ValueError(f"reduce_every={reduce_every} must be >= 1")
        self.collectors = list(collectors)
        self.fanin = int(fanin)
        self.reduce_every = int(reduce_every)
        self.fleet: Optional[WindowedRollup] = None
        self.rounds = 0

    @property
    def done(self) -> bool:
        return all(c.done for c in self.collectors)

    def poll_round(self) -> list:
        """Drive every host one round; reduce snapshots when due."""
        reports = [c.poll_round() for c in self.collectors]
        self.rounds += 1
        if self.rounds % self.reduce_every == 0:
            self.fleet = tree_reduce(
                [c.snapshot() for c in self.collectors], fanin=self.fanin)
        return reports

    def run(self, n_rounds: Optional[int] = None) -> list:
        if n_rounds is None:
            _require_bounded([st for c in self.collectors
                              for st in c.streams])
        reports = []
        while (n_rounds is None or len(reports) < n_rounds) \
                and not self.done:
            reports.append(self.poll_round())
        return reports

    def scan(self, **detector_kw) -> dict:
        """Regression sweep over the latest reduced fleet rollup."""
        if self.fleet is None:
            return {}
        kw = detector_kw or {"window": 4, "min_duration": 2}
        return scan_rollup(self.fleet, **kw)
