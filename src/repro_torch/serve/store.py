"""`FleetStore`: the queryable read side of the serving subsystem.

The collector pipeline produces state (a `WindowedRollup`, a stream of
alerts); the paper's deployed story (§VI) needs that state *askable* —
per-job OFU time series, fleet percentiles, "what regressed hardest this
week", open incidents, goodput summaries — by many dashboard pollers at
once, cheaply.  `FleetStore` is that index:

  * `update()` / `update_from(collector)` publishes a new GENERATION of
    fleet state.  The rollup is copied on publish (`spawn_empty().merge`,
    pure array adds), so readers never observe a half-ingested round and
    the collector keeps mutating its own rollup freely.
  * Every query is answered from the published generation and CACHED
    keyed on (query, params): repeating a query between rounds is a dict
    hit, and `generation` rides along in every payload so the HTTP layer
    can turn "nothing changed" into an ETag 304 without recomputing
    anything.
  * Payloads are plain JSON-ready dicts (`BucketStats.payload` shapes
    the series; NaN never leaks into the wire format) — the same objects
    `repro_torch.serve.http` serializes and `repro_torch.serve.client` returns.

Thread-safe: one lock serializes publish and query; queries are
O(result) array readouts, so holding it is cheap.
"""
from __future__ import annotations

import os
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.fleet.correlation import (CorrelationConfig, MfuRollup,
                                     analyze_correlation)
from repro_torch.fleet.divergence import DEFAULT_OFU_FLOOR, analyze_rollup
from repro_torch.fleet.regression import scan_rollup
from repro_torch.fleet.streaming import (StreamingRollup, _json_list,
                                   weighted_mean)


def _finite(x) -> Optional[float]:
    x = float(x)
    return x if np.isfinite(x) else None


def alert_payload(alert) -> dict:
    """JSON-ready dict for a `fleet.collector.Alert` (idempotent on
    dicts, so restored/forwarded alerts re-publish unchanged)."""
    if isinstance(alert, dict):
        return dict(alert)
    return {"round_idx": alert.round_idx, "t_s": alert.t_s,
            "job_id": alert.job_id, "kind": alert.kind,
            "message": alert.message, "factor": _finite(alert.factor)}


class FleetStore:
    """Generation-versioned index over collector state.

    Writers call `update*()` once per round; readers call the query
    methods.  Every payload carries the `generation` it was computed at.
    """

    #: cached answers kept per generation; param-cycling pollers cannot
    #: grow memory past this (the cache resets, correctness unaffected)
    max_cache_entries = 256

    def __init__(self):
        self._lock = threading.RLock()
        self._rollup: Optional[StreamingRollup] = None
        self._mfu: Optional[MfuRollup] = None    # app-reported half
        self._alerts: list = []          # alert payload dicts, in order
        self._alerts_raw: list = []      # the objects they came from
        self._active: list = []          # open episode keys [job, kind]
        self.generation = 0
        #: per-instance nonce: distinguishes this store's generations
        #: from a previous process's (the HTTP ETag includes it)
        self.boot = os.urandom(4).hex()
        self.round_idx = 0
        self.clock_s = 0.0
        self._cache: dict = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # -- publish --------------------------------------------------------
    def update(self, rollup: Optional[StreamingRollup], *,
               alerts: Sequence = (), active: Sequence = (),
               mfu: Optional[MfuRollup] = None,
               round_idx: int = 0, clock_s: float = 0.0,
               copy: bool = True) -> int:
        """Publish a new generation of fleet state; returns it.

        `copy=True` (default) stores an isolated merge-copy of the
        rollup (and of `mfu`, the app-reported bucket store backing
        correlation queries), so the caller may keep mutating the
        originals between publishes — the contract a live collector
        needs.
        """
        if copy and rollup is not None:
            rollup = rollup.spawn_empty().merge(rollup)
        if copy and mfu is not None:
            mfu = mfu.copy()
        alerts = list(alerts)
        with self._lock:
            # a collector's alert log is append-only and republished
            # every round; convert only the new tail (identity-checked
            # prefix) so per-round publish cost is O(new alerts), not
            # O(every alert the daemon ever fired)
            n_prev = len(self._alerts_raw)
            if n_prev and len(alerts) >= n_prev and all(
                    a is b for a, b in zip(self._alerts_raw, alerts)):
                payloads = self._alerts[:n_prev] \
                    + [alert_payload(a) for a in alerts[n_prev:]]
            else:
                payloads = [alert_payload(a) for a in alerts]
            self._alerts_raw = alerts
            self._rollup = rollup
            self._mfu = mfu
            self._alerts = payloads
            self._active = [list(k) for k in active]
            self.round_idx = int(round_idx)
            self.clock_s = float(clock_s)
            self._cache.clear()
            self.generation += 1
            return self.generation

    def update_from(self, collector, *, copy: bool = True) -> int:
        """Publish straight from a `Collector` or `FleetCollector` after
        a poll round (the `ServiceDaemon` path)."""
        from repro_torch.fleet.collector import Collector, FleetCollector
        if isinstance(collector, FleetCollector):
            hosts = collector.collectors
            alerts = sorted((a for c in hosts for a in c.alerts),
                            key=lambda a: (a.round_idx, a.job_id, a.kind))
            active = sorted({k for c in hosts for k in c.deduper.active},
                            key=repr)
            # MFU streams are per-host too: reduce them the same way the
            # counter rollups tree-reduce (merge is assoc + commutative)
            mfu = None
            for c in hosts:
                part = getattr(c, "mfu", None)
                if part is not None and part.jobs:
                    mfu = part.copy() if mfu is None else mfu.merge(part)
            return self.update(
                collector.fleet, alerts=alerts, active=active, mfu=mfu,
                round_idx=collector.rounds,
                clock_s=max((c.clock_s for c in hosts), default=0.0),
                copy=copy)
        if not isinstance(collector, Collector):
            raise TypeError(f"update_from wants a Collector or "
                            f"FleetCollector, got {type(collector).__name__}")
        return self.update(
            collector.rollup, alerts=collector.alerts,
            active=collector.deduper.active, mfu=collector.mfu,
            round_idx=collector.round_idx,
            clock_s=collector.clock_s, copy=copy)

    # -- query plumbing -------------------------------------------------
    def _query(self, key: tuple, fn) -> dict:
        """Answer from the generation cache or compute-and-remember.
        Returned dicts are shared across callers: treat as read-only."""
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self.cache_hits += 1
                return hit
            self.cache_misses += 1
            out = fn()
            out["generation"] = self.generation
            out["round_idx"] = self.round_idx
            out["clock_s"] = self.clock_s
            if len(self._cache) >= self.max_cache_entries:
                self._cache.clear()
            self._cache[key] = out
            return out

    @property
    def _roll(self) -> Optional[StreamingRollup]:
        return self._rollup

    def _window_info(self, roll) -> Optional[dict]:
        if getattr(roll, "retain", None) is None:
            return None
        return {"bucket0": roll.bucket0, "end_bucket": roll.end_bucket,
                "retain": roll.retain}

    def _alltime(self, raw: dict) -> dict:
        return {"mean": _finite(raw["mean"]), "weight": raw["weight"],
                "percentiles": {f"{q:g}": _finite(v)
                                for q, v in raw["percentiles"].items()}}

    def _series_payload(self, scope: str, name: Optional[str],
                        qs: tuple) -> dict:
        roll = self._roll
        out = {"scope": scope, "id": name}
        if roll is None:
            out.update({"bucket_s": None, "t0_s": 0.0, "t_s": [],
                        "mean": [], "weight": [], "percentiles": {},
                        "weighted_ofu": None})
            return out
        if scope == "fleet":
            stats = roll.fleet_stats(qs)
        elif scope == "job":
            if name not in roll.jobs:
                raise KeyError(f"unknown job {name!r}")
            stats = roll.job_stats(name, qs)
        elif scope == "group":
            if name not in roll.groups:
                raise KeyError(f"unknown group {name!r}")
            stats = roll.group_stats(name, qs)
        else:
            raise ValueError(f"unknown scope {scope!r} "
                             "(want fleet, job, or group)")
        out.update(stats.payload())
        # null, not 0.0, when no samples have landed: a dashboard must
        # show "no data yet", never a phantom total outage
        out["weighted_ofu"] = _finite(weighted_mean(stats)) \
            if float(np.nansum(stats.weight)) > 0 else None
        win = self._window_info(roll)
        if win is not None:
            out["window"] = win
            if scope == "fleet":
                out["alltime"] = self._alltime(roll.fleet_alltime(qs))
            elif scope == "job":
                out["alltime"] = self._alltime(roll.job_alltime(name, qs))
        if scope == "job":
            out["meta"] = roll.job_meta(name)
        return out

    # -- queries --------------------------------------------------------
    def fleet_series(self, qs: Sequence = (10, 50, 90)) -> dict:
        """Fleet-wide OFU time series: bucket means, weights, histogram
        percentiles, the weighted-OFU headline, all-time view."""
        qs = tuple(qs)
        return self._query(("series", "fleet", None, qs),
                           lambda: self._series_payload("fleet", None, qs))

    def job_series(self, job_id: str, qs: Sequence = (10, 50, 90)) -> dict:
        """One job's OFU time series + ingest metadata.  KeyError for a
        job the rollup has never seen (HTTP maps it to 404)."""
        qs = tuple(qs)
        return self._query(("series", "job", job_id, qs),
                           lambda: self._series_payload("job", job_id, qs))

    def group_series(self, group: str, qs: Sequence = (10, 50, 90)) -> dict:
        qs = tuple(qs)
        return self._query(("series", "group", group, qs),
                           lambda: self._series_payload("group", group, qs))

    def jobs(self) -> dict:
        """The monitored population: job ids and precision groups."""
        def build():
            roll = self._roll
            return {"jobs": sorted(roll.jobs) if roll else [],
                    "groups": sorted(roll.groups) if roll else []}
        return self._query(("jobs",), build)

    def top_regressions(self, k: int = 5, **detector_kw) -> dict:
        """The k hardest-regressed jobs right now, by detector factor —
        the dashboard's 'what should I look at first' panel.  Bucket
        indices are ABSOLUTE (windowed `bucket0` already applied)."""
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        key = ("topreg", k, tuple(sorted(detector_kw.items())))

        def build():
            roll = self._roll
            found = []
            if roll is not None:
                kw = detector_kw or {"window": 4, "min_duration": 2}
                for jid, regs in scan_rollup(roll, **kw).items():
                    for r in regs:
                        found.append({
                            "job_id": jid,
                            "factor": _finite(r.factor),
                            "start_bucket": roll.bucket0 + r.start_idx,
                            "end_bucket": None if r.end_idx is None
                            else roll.bucket0 + r.end_idx,
                            "ongoing": r.end_idx is None,
                            "ref_ofu": _finite(r.ref_ofu),
                            "low_ofu": _finite(r.low_ofu)})
            found.sort(key=lambda d: -(d["factor"] or 0.0))
            return {"total": len(found), "k": k,
                    "regressions": found[:k]}
        return self._query(key, build)

    def alerts(self, *, limit: Optional[int] = None) -> dict:
        """Every alert fired (newest last) plus the OPEN episode keys —
        what a pager integration tails.  `limit` keeps only the newest N
        (must be >= 1: limit=0 would silently mean 'all' via slicing)."""
        if limit is not None and limit < 1:
            raise ValueError(f"limit={limit} must be >= 1")
        key = ("alerts", limit)

        def build():
            fired = self._alerts if limit is None else self._alerts[-limit:]
            return {"alerts": list(fired),
                    "active_episodes": [list(k) for k in self._active],
                    "total": len(self._alerts)}
        return self._query(key, build)

    def goodput(self, healthy_ofu: float = 0.40) -> dict:
        """Chip-weighted fleet goodput off the rollup (the §II review
        vantage): weighted OFU, app-MFU coverage vs OFU's 100%, and the
        largest recoverable-waste pools ranked — `fleet.goodput.rollup`
        semantics with the rollup's chip-weighted sample mass standing
        in for chip-hours."""
        if not np.isfinite(healthy_ofu) or healthy_ofu <= 0:
            raise ValueError(f"healthy_ofu={healthy_ofu} must be a "
                             "positive finite number")
        key = ("goodput", healthy_ofu)

        def build():
            roll = self._roll
            jobs = []
            total_w = covered_w = ofu_w = 0.0
            if roll is not None:
                windowed = getattr(roll, "retain", None) is not None
                for jid in sorted(roll.jobs):
                    if windowed:
                        at = roll.job_alltime(jid, qs=())
                        w, mean = float(at["weight"]), float(at["mean"])
                    else:
                        s = roll.job_stats(jid, qs=())
                        w, mean = float(np.nansum(s.weight)), \
                            weighted_mean(s)
                    if w <= 0:
                        continue
                    waste = max(0.0, healthy_ofu - mean) / healthy_ofu * w
                    jobs.append({"job_id": jid, "ofu": _finite(mean),
                                 "weight": w, "waste": waste,
                                 "has_app_mfu":
                                 roll.job_meta(jid) is not None})
                    total_w += w
                    ofu_w += mean * w
                    if roll.job_meta(jid) is not None:
                        covered_w += w
            jobs.sort(key=lambda d: -d["waste"])
            return {"healthy_ofu": healthy_ofu,
                    "weight": total_w,
                    "weighted_ofu": _finite(ofu_w / total_w)
                    if total_w > 0 else None,
                    "app_mfu_coverage": covered_w / total_w
                    if total_w > 0 else 0.0,
                    "ofu_coverage": 1.0,
                    "jobs": jobs}
        return self._query(key, build)

    def divergence(self, flag_rel_err: float = 0.30,
                   ofu_floor: float = DEFAULT_OFU_FLOOR) -> dict:
        """MFU-vs-OFU triage over jobs that registered an app MFU (§V-C);
        empty when none have.  Jobs with OFU below `ofu_floor` are never
        flagged (an idle denominator proves nothing)."""
        if not np.isfinite(flag_rel_err) or flag_rel_err <= 0:
            raise ValueError(f"flag_rel_err={flag_rel_err} must be a "
                             "positive finite number")
        if not np.isfinite(ofu_floor) or ofu_floor < 0:
            raise ValueError(f"ofu_floor={ofu_floor} must be a "
                             "non-negative finite number")
        key = ("divergence", flag_rel_err, ofu_floor)

        def build():
            roll = self._roll
            rep = None if roll is None else analyze_rollup(
                roll, flag_rel_err=flag_rel_err, ofu_floor=ofu_floor,
                empty_ok=True)
            if rep is None:
                return {"flag_rel_err": flag_rel_err, "flagged": []}
            return {"flag_rel_err": flag_rel_err,
                    "r_all": _finite(rep.r_all),
                    "r_clean": _finite(rep.r_clean),
                    "mae": _finite(rep.mae_all),
                    "flagged": [{"job_id": p.job_id,
                                 "mfu": _finite(p.mfu),
                                 "ofu": _finite(p.ofu),
                                 "rel_err": _finite(p.rel_err)}
                                for p in rep.flagged]}
        return self._query(key, build)

    def correlation(self, *, ratio_high: float = 1.5,
                    ratio_low: Optional[float] = None,
                    min_buckets: int = 1,
                    ofu_floor: float = DEFAULT_OFU_FLOOR,
                    window: int = 8) -> dict:
        """The OFU<->MFU join over the published generation: fleet r
        with/without the miscalculation set, tile-quantization-corrected
        MAE, the per-scale error table (Table III live), per-job rows,
        and the flagged findings.  Empty-safe: without MFU samples the
        report is all zeros and no flags."""
        cfg = CorrelationConfig(ratio_high=ratio_high,
                                ratio_low=ratio_low,
                                min_buckets=min_buckets,
                                ofu_floor=ofu_floor, window=window)
        key = ("correlation", cfg.ratio_high, cfg.ratio_low,
               cfg.min_buckets, cfg.ofu_floor, cfg.window)

        def build():
            roll, mfu = self._roll, self._mfu
            if roll is None or mfu is None:
                return {"config": {"ratio_high": cfg.ratio_high,
                                   "ratio_low": cfg.ratio_low,
                                   "min_buckets": cfg.min_buckets,
                                   "ofu_floor": cfg.ofu_floor,
                                   "window": cfg.window},
                        "n_jobs": 0, "r_all": 0.0, "r_clean": 0.0,
                        "mae": 0.0, "flagged": [], "by_scale": {},
                        "jobs": []}
            rep = analyze_correlation(mfu, roll, config=cfg)
            out = rep.to_payload()
            out["config"] = {"ratio_high": cfg.ratio_high,
                             "ratio_low": cfg.ratio_low,
                             "min_buckets": cfg.min_buckets,
                             "ofu_floor": cfg.ofu_floor,
                             "window": cfg.window}
            return out
        return self._query(key, build)
