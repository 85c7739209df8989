"""Streaming OFU rollups: per-job / per-precision / fleet-wide percentiles
over time buckets (the paper's §II efficiency-review dashboards at §V-B
fleet scale).

State per (scope, time-bucket) is a fixed-size weighted histogram, so
memory is O(buckets × scopes), independent of device count or scrape rate
— a 5,888-GPU job streams through the same few kilobytes a 8-GPU job does.
Readouts go through `core.ofu.hist_percentile_grid`; per-job bucket means
feed the existing `regression.detect_regressions` detector unchanged, and
`to_job_points` bridges into `divergence.analyze`.

Rollups are distributed-ready monoid elements: per-bucket histograms and
weighted sums ADD, so `merge()` is associative and commutative by
construction, and `to_bytes()`/`from_bytes()` ship a host's rollup to a
reducer (`fleet.distributed.tree_reduce`) without moving raw scrapes.
"""
from __future__ import annotations

import io
import json
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.ofu import hist_percentile, hist_percentile_grid, ofu_series
from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.fleet import wire
from repro_torch.kernels.fleet_hist import ofu_bucket_hist

_FLEET = "__fleet__"


def _is_device_array(x) -> bool:
    """True for torch tensors — the signal that `add_grid` should reduce
    on the tensor's device via the fused histogram kernel."""
    return isinstance(x, torch.Tensor)


def precision_label(precisions: dict) -> str:
    """Canonical group label for a job's precision mix, e.g. 'bf16+fp8'."""
    return "+".join(sorted(p for p, f in precisions.items() if f > 0)) \
        or "unknown"


def weighted_mean(stats: "BucketStats") -> float:
    """Weight-weighted mean OFU over a readout (0.0 when empty) — the one
    scalar a dashboard headline shows; shared by `summary()`,
    `to_job_points`, and the serving layer's goodput rollup."""
    w = float(np.nansum(stats.weight))
    return float(np.nansum(stats.mean * stats.weight) / max(w, 1e-12))


@dataclass
class BucketStats:
    """One scope's readout: aligned per-bucket arrays."""

    bucket_s: float
    mean: np.ndarray                     # NaN where a bucket saw no samples
    weight: np.ndarray
    percentiles: dict = field(default_factory=dict)   # q -> (B,) array
    #: absolute start of bucket 0 — nonzero for windowed rollups, whose
    #: retained rows begin at the retention horizon, not at t=0
    t0_s: float = 0.0

    @property
    def centers_s(self) -> np.ndarray:
        return self.t0_s + (np.arange(len(self.mean)) + 0.5) * self.bucket_s

    def payload(self) -> dict:
        """JSON-ready readout (arrays → lists, NaN → null): the wire shape
        the serving layer returns for time-series queries."""
        return {"bucket_s": self.bucket_s, "t0_s": self.t0_s,
                "t_s": _json_list(self.centers_s),
                "mean": _json_list(self.mean),
                "weight": _json_list(self.weight),
                "percentiles": {f"{q:g}": _json_list(v)
                                for q, v in self.percentiles.items()}}


def _json_list(a) -> list:
    """Array → JSON-safe list (NaN/inf become null, not bare tokens)."""
    return [float(x) if np.isfinite(x) else None
            for x in np.asarray(a, float).ravel()]


def _ffill(mean: np.ndarray) -> np.ndarray:
    """Forward-fill NaN gaps (leading NaNs take the first real value) —
    the shared detector-input conditioning for per-bucket mean series."""
    if len(mean):
        good = ~np.isnan(mean)
        if good.any():
            idx = np.maximum.accumulate(
                np.where(good, np.arange(len(mean)), -1))
            first = int(np.argmax(good))
            idx[idx < 0] = first
            mean = mean[idx]
    return mean


class StreamingRollup:
    """Incremental fleet OFU aggregator over fixed time buckets.

    observe() takes raw aligned counter-derived OFU samples (any shape) and
    folds them into per-job, per-group (precision mix by default), and
    fleet-wide histograms; readouts are percentile/mean time series.
    """

    #: absolute index of the first stored bucket row; always 0 here — the
    #: windowed subclass advances it as old buckets are evicted
    bucket0 = 0

    def __init__(self, bucket_s: float = 300.0, *, bins: int = 128,
                 lo: float = 0.0, hi: float = 1.1):
        self.bucket_s = float(bucket_s)
        self.bins = int(bins)
        self.edges = np.linspace(lo, hi, bins + 1)
        self._hists: dict = {}      # scope -> (B, bins) weights, grown lazily
        self._sums: dict = {}       # scope -> (B,) weighted value sums
        self._job_meta: dict = {}   # job_id -> dict (app_mfu, chips, ...)
        self.n_buckets = 0
        #: monotone mutation counter: bumps once per ingest/merge, and
        #: `_touched[scope][row]` remembers the generation that last
        #: changed each bucket row — what `delta_bytes(since)` cuts on
        self.generation = 0
        self._touched: dict = {}    # scope -> (B,) int64 generation stamps

    def spawn_empty(self) -> "StreamingRollup":
        """A fresh rollup with this one's bucketing (reduction identity)."""
        return type(self)(self.bucket_s, bins=self.bins,
                          lo=float(self.edges[0]), hi=float(self.edges[-1]))

    # -- ingest -------------------------------------------------------------
    def _scope_arrays(self, scope: str, b_needed: int):
        if b_needed > self.n_buckets:
            self.n_buckets = b_needed
        h = self._hists.get(scope)
        if h is None or h.shape[0] < self.n_buckets:
            nh = np.zeros((self.n_buckets, self.bins))
            ns = np.zeros(self.n_buckets)
            nt = np.zeros(self.n_buckets, dtype=np.int64)
            if h is not None:
                nh[:h.shape[0]] = h
                ns[:h.shape[0]] = self._sums[scope]
                nt[:h.shape[0]] = self._touched[scope]
            self._hists[scope], self._sums[scope] = nh, ns
            self._touched[scope] = nt
        return self._hists[scope], self._sums[scope]

    def _bucketize(self, t_s, ofu):
        """(values, bucket indices, histogram bin indices) for raw samples.

        Right-closed buckets: a scrape at t covers (t - interval, t], so a
        boundary sample (t == k·bucket_s) belongs to bucket k-1, not k —
        otherwise every run grows a spurious one-sample trailing bucket.
        The ONE bucketing rule for plain and windowed rollups; it is what
        makes their retained-span readouts bucketwise identical.
        """
        t_s = np.asarray(t_s, float).ravel()
        v = np.asarray(ofu, float).ravel()
        b = np.maximum(np.ceil(t_s / self.bucket_s).astype(int) - 1, 0)
        k = np.clip(np.digitize(v, self.edges) - 1, 0, self.bins - 1)
        return v, b, k

    def observe(self, job_id: str, t_s: np.ndarray, ofu: np.ndarray, *,
                group: str = "unknown", weight: float = 1.0) -> None:
        """Fold OFU samples at times t_s into every scope this job hits."""
        v, b, k = self._bucketize(t_s, ofu)
        if not v.size:
            return
        self.generation += 1
        b_needed = int(b.max()) + 1
        for scope in (("job", job_id), ("group", group), ("group", _FLEET)):
            h, s = self._scope_arrays(scope, b_needed)
            np.add.at(h, (b, k), weight)
            np.add.at(s, b, v * weight)
            self._touched[scope][b] = self.generation

    def add_job(self, tel, *, group: str | None = None) -> np.ndarray:
        """Ingest a JobTelemetry: every sampled device's OFU series,
        chip-weighted so each job contributes its full fleet footprint.
        (A thin wrapper over the source-agnostic add_grid.)"""
        spec = tel.spec
        return self.add_grid(
            spec.job_id, tel.grid, chip=spec.chip,
            group=group or precision_label(spec.precisions),
            chips=spec.chips, app_mfu=tel.app_mfu, arch=spec.arch,
            flops_variant=spec.flops_variant)

    def add_grid(self, job_id: str, grid, *, chip: ChipSpec = DEFAULT_CHIP,
                 group: str = "unknown", chips: int | None = None,
                 app_mfu: float | None = None, arch: str = "unknown",
                 flops_variant: str = "exact") -> np.ndarray:
        """Ingest a DeviceGrid from ANY TelemetrySource — the
        source-agnostic twin of add_job, used when counters come from a
        replayed trace or a live poller instead of a simulated JobSpec.

        chips: the job's true device count for chip-weighting (defaults to
        the grid's sampled device count); app_mfu (with arch /
        flops_variant) registers the metadata `to_job_points` needs for
        divergence triage.  Returns the grid's OFU series so callers that
        need the raw samples (the collector's adaptive controller) don't
        recompute it.

        A grid holding torch tensors (the `engine_torch` backend's
        output) is reduced ON ITS DEVICE: `repro_torch.kernels.fleet_hist`
        fuses ofu_series + bucketize + bin-scatter, and only the few-KB
        (bucket, bin) histogram crosses to host.
        """
        chips = grid.n_devices if chips is None else chips
        if app_mfu is not None:
            self._job_meta[job_id] = {
                "chips": chips, "app_mfu": float(app_mfu), "arch": arch,
                "flops_variant": flops_variant}
        weight = chips / max(grid.n_devices, 1)
        if _is_device_array(grid.tpa):
            return self._ingest_device_grid(job_id, grid, chip, group,
                                            weight)
        ofu = ofu_series(grid.tpa, grid.clock_mhz, chip)
        self.observe(job_id, np.broadcast_to(grid.times_s, ofu.shape), ofu,
                     group=group, weight=weight)
        return ofu

    def _ingest_device_grid(self, job_id, grid, chip, group, weight):
        """Tensor-grid ingest: per-device OFU never reaches the host — the
        fused kernel reduces the grid to per-bucket histograms on the
        GPU and the result folds through `observe_hist`.  Time
        bucketing follows `_bucketize`'s right-closed rule exactly (the
        column->bucket map is computed here with the same formula); bin
        edges are compared in f32, the telemetry dtype.  Returns the
        OFU tensor on the grid's device for callers that want raw
        samples.
        """
        t_s = grid.times_s
        inv_fmax = 1.0 / chip.f_max_mhz
        if t_s.size == 0 or grid.n_devices == 0:
            return grid.tpa * grid.clock_mhz * inv_fmax
        b_abs = np.maximum(
            np.ceil(t_s / self.bucket_s).astype(int) - 1, 0)
        b0 = int(b_abs[0])
        # a replayed slice (`GridSource.poll`) is a strided view; the
        # kernel reads whole rows
        hist, sums = ofu_bucket_hist(
            grid.tpa.contiguous(), grid.clock_mhz.contiguous(),
            inv_fmax=inv_fmax, edges=self.edges,
            col_bucket=b_abs - b0, n_buckets=int(b_abs[-1]) - b0 + 1)
        self.observe_hist(job_id, hist.cpu().numpy().astype(float),
                          sums.cpu().numpy(), b0=b0, group=group,
                          weight=weight)
        return grid.tpa * grid.clock_mhz * inv_fmax

    def observe_hist(self, job_id: str, hist: np.ndarray,
                     sums: np.ndarray, *, b0: int = 0,
                     group: str = "unknown", weight: float = 1.0) -> None:
        """Fold PRE-BINNED per-bucket histogram rows into every scope —
        the histogram-domain twin of observe(), fed by the device-side
        fused ingest.  hist: (B, bins) counts; sums: (B,) value sums;
        b0: the ABSOLUTE bucket index of row 0.  Rows must use this
        rollup's bin edges (hist widths add only in a shared basis).
        """
        hist = np.asarray(hist)
        if hist.shape[0] == 0:
            return
        if hist.shape[1] != self.bins:
            raise ValueError(f"histogram has {hist.shape[1]} bins, "
                             f"rollup has {self.bins}")
        self.generation += 1
        b_needed = b0 + hist.shape[0]
        for scope in (("job", job_id), ("group", group), ("group", _FLEET)):
            h, s = self._scope_arrays(scope, b_needed)
            h[b0:b_needed] += hist * weight
            s[b0:b_needed] += np.asarray(sums) * weight
            self._touched[scope][b0:b_needed] = self.generation

    # -- distribution: merge + wire format ----------------------------------
    def merge(self, other: "StreamingRollup") -> "StreamingRollup":
        """Fold another rollup into this one (in place; returns self).

        Per-bucket histogram weights and value sums ADD, so merge is
        associative and commutative by construction — any reduction tree
        over per-host rollups yields the same fleet state as single-
        process ingestion.
        """
        if (self.bucket_s != other.bucket_s or self.bins != other.bins
                or not np.array_equal(self.edges, other.edges)):
            raise ValueError("cannot merge rollups with different "
                             "bucketing (bucket_s/bins/edges must match)")
        if getattr(other, "retain", None) is not None:
            raise ValueError("cannot merge a WindowedRollup into a plain "
                             "StreamingRollup (retention/eviction state "
                             "would be lost); merge the other way around")
        self.generation += 1
        n = max(self.n_buckets, other.n_buckets)
        for scope, oh in other._hists.items():
            h, s = self._scope_arrays(scope, n)
            h[:oh.shape[0]] += oh
            s[:oh.shape[0]] += other._sums[scope]
            self._touched[scope][:oh.shape[0]] = self.generation
        for jid, m in other._job_meta.items():
            self._job_meta.setdefault(jid, dict(m))
        return self

    def merge_many(self, others) -> "StreamingRollup":
        """Fold MANY rollups in at once (in place; returns self) —
        equivalent to a pairwise `merge` fold, but per scope the aligned
        per-bucket arrays are stacked and reduced with one
        `np.add.reduce` instead of N separate adds, and every scope is
        grown to its final size exactly once instead of once per input.
        The k-way reduction step `tree_reduce` and the ingest aggregator
        stand on.

        Windowed rollups (self or any input) fall back to the pairwise
        loop — eviction alignment is inherently sequential.
        """
        others = [o for o in others if o is not None]
        if not others:
            return self
        if getattr(self, "retain", None) is not None or any(
                getattr(o, "retain", None) is not None for o in others):
            for o in others:
                self.merge(o)
            return self
        for o in others:
            if (self.bucket_s != o.bucket_s or self.bins != o.bins
                    or not np.array_equal(self.edges, o.edges)):
                raise ValueError("cannot merge rollups with different "
                                 "bucketing (bucket_s/bins/edges must "
                                 "match)")
        self.generation += 1
        n = max([self.n_buckets] + [o.n_buckets for o in others])
        # per scope: group inputs by row count so each group stacks into
        # one contiguous reduction; chunked to bound the stack's memory
        chunk = 512
        per_scope: dict = {}
        for o in others:
            for scope, oh in o._hists.items():
                per_scope.setdefault(scope, {}).setdefault(
                    oh.shape[0], []).append((oh, o._sums[scope]))
        for scope, by_rows in per_scope.items():
            h, s = self._scope_arrays(scope, n)
            for rows, parts in by_rows.items():
                if len(parts) == 1:
                    h[:rows] += parts[0][0]
                    s[:rows] += parts[0][1]
                else:
                    for i in range(0, len(parts), chunk):
                        blk = parts[i:i + chunk]
                        h[:rows] += np.add.reduce(
                            np.stack([p[0] for p in blk]))
                        s[:rows] += np.add.reduce(
                            np.stack([p[1] for p in blk]))
            self._touched[scope][:max(by_rows)] = self.generation
        for o in others:
            for jid, m in o._job_meta.items():
                self._job_meta.setdefault(jid, dict(m))
        return self

    def _snapshot_extra(self, meta: dict, arrays: dict) -> None:
        """Hook for subclasses to extend the wire format (no-op here)."""

    def to_bytes(self) -> bytes:
        """Self-contained snapshot (compressed npz): what a host ships to
        the tree reducer instead of its raw scrapes.  The format is
        self-describing — `from_bytes` restores a plain or windowed rollup
        according to what was serialized."""
        meta = {"bucket_s": self.bucket_s, "bins": self.bins,
                "n_buckets": self.n_buckets,
                "scopes": [list(k) for k in self._hists],
                "job_meta": self._job_meta}
        arrays = {"edges": self.edges}
        for idx, scope in enumerate(self._hists):
            arrays[f"h{idx}"] = self._hists[scope]
            arrays[f"s{idx}"] = self._sums[scope]
        self._snapshot_extra(meta, arrays)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta, default=lambda o: o.item()).encode(),
            dtype=np.uint8)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        return buf.getvalue()

    # -- wire format v2: delta snapshots --------------------------------
    def to_bytes_v2(self) -> bytes:
        """Full snapshot on the zero-copy v2 wire (`fleet.wire`): raw
        little-endian header + contiguous columns, decoded by
        `np.frombuffer` views — no zip framing, no zlib.  `from_bytes`
        accepts it (dispatch on magic); npz `to_bytes` remains the
        self-describing compatibility format and the only one carrying
        windowed retention state."""
        return wire.encode(self, 0)

    def delta_bytes(self, since_generation: int = 0) -> bytes:
        """Ship only the bucket rows touched after `since_generation` —
        O(new buckets) per round instead of O(history).

        The blob carries `seq = self.generation`; rows hold the scope's
        full CUMULATIVE histogram for that bucket (replace semantics),
        so a receiver holding a mirror of the state at
        `since_generation` applies it idempotently: duplicates are
        detected by `seq`, retries need no dedup log.  `since=0` is a
        full snapshot."""
        return wire.encode(self, since_generation)

    def apply_delta(self, blob) -> bool:
        """Apply a v2 delta to this MIRROR of the sender's rollup.

        Returns True when applied, False for a duplicate (the blob's
        `seq` is not ahead of this mirror — at-least-once redelivery is
        a no-op).  Raises ValueError on a sequence GAP (`since` ahead of
        this mirror: a delta in between was lost; the sender must
        re-encode from this mirror's generation) or a bucketing
        mismatch."""
        return self.apply_snapshot(wire.decode(blob))

    def apply_snapshot(self, snap) -> bool:
        """`apply_delta` after decode — the aggregator's entry point
        (decode once outside the shard lock, apply under it)."""
        if getattr(self, "retain", None) is not None:
            raise ValueError("delta snapshots apply to plain "
                             "StreamingRollup mirrors; windowed state "
                             "travels via the npz format")
        if snap.seq <= self.generation:
            return False                       # duplicate delivery
        if snap.since > self.generation:
            raise ValueError(
                f"delta gap: blob covers generations ({snap.since}, "
                f"{snap.seq}] but this mirror is at {self.generation}; "
                f"re-encode with delta_bytes({self.generation})")
        if (self.bucket_s != snap.bucket_s or self.bins != snap.bins
                or not np.array_equal(self.edges, snap.edges)):
            raise ValueError("cannot apply a snapshot with different "
                             "bucketing (bucket_s/bins/edges must match)")
        if snap.n_buckets > self.n_buckets:
            self.n_buckets = snap.n_buckets
        for scope, idx, hist, sums in snap.scopes:
            h, s = self._scope_arrays(scope, snap.n_buckets)
            h[idx] = hist                     # REPLACE: rows carry the
            s[idx] = sums                     # sender's cumulative state
            self._touched[scope][idx] = snap.seq
        for jid, m in snap.job_meta.items():
            self._job_meta[jid] = dict(m)
        self.generation = snap.seq
        return True

    @classmethod
    def from_bytes(cls, blob: bytes) -> "StreamingRollup":
        """Restore a snapshot; dispatches on the leading magic (v2 raw
        vs npz zip) and on the serialized kind, so a reducer
        deserializes plain, windowed, and v2 snapshots through the one
        entry point `tree_reduce` uses."""
        if wire.is_v2(blob):
            return wire.restore(blob)
        with np.load(io.BytesIO(blob)) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            edges = z["edges"]
            lo, hi = float(edges[0]), float(edges[-1])
            if meta.get("kind") == "windowed":
                roll: StreamingRollup = WindowedRollup(
                    meta["bucket_s"], retain=meta["retain"],
                    bins=meta["bins"], lo=lo, hi=hi)
                roll.bucket0 = int(meta["bucket0"])
                for idx, key in enumerate(meta["escopes"]):
                    scope = tuple(key)
                    roll._ev_hist[scope] = z[f"e{idx}"].copy()
                    roll._ev_sum[scope] = float(z["esums"][idx])
            else:
                roll = StreamingRollup(meta["bucket_s"], bins=meta["bins"],
                                       lo=lo, hi=hi)
            roll.edges = edges.copy()
            roll.n_buckets = int(meta["n_buckets"])
            # npz blobs predate generation stamps: every restored row
            # counts as touched at generation 1, so a later
            # delta_bytes(0) still ships the full restored state
            roll.generation = 1
            for idx, key in enumerate(meta["scopes"]):
                scope = tuple(key)
                roll._hists[scope] = z[f"h{idx}"].copy()
                roll._sums[scope] = z[f"s{idx}"].copy()
                roll._touched[scope] = np.ones(
                    roll._hists[scope].shape[0], dtype=np.int64)
            roll._job_meta = meta["job_meta"]
        return roll

    # -- readout ------------------------------------------------------------
    def _stats(self, scope, qs=(10, 50, 90)) -> BucketStats:
        t0 = self.bucket0 * self.bucket_s
        h = self._hists.get(scope)
        if h is None:
            empty = np.empty(0)
            return BucketStats(self.bucket_s, empty, empty, t0_s=t0)
        s = self._sums[scope]
        if h.shape[0] < self.n_buckets:            # pad lazily-grown scopes
            # ...LOCALLY: readouts run concurrently on published rollup
            # copies (one FleetStore snapshot, many HTTP reader threads),
            # so _stats must never resize/reassign the shared arrays —
            # a racing reader could see a torn _scope_arrays reassignment
            pad = self.n_buckets - h.shape[0]
            h = np.concatenate([h, np.zeros((pad, self.bins))])
            s = np.concatenate([s, np.zeros(pad)])
        w = h.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = np.where(w > 0, s / np.maximum(w, 1e-12), np.nan)
        # all buckets × all percentiles in one cumulative-sum readout
        grid = hist_percentile_grid(self.edges, h, tuple(qs))
        pct = {q: grid[k] for k, q in enumerate(qs)}
        return BucketStats(self.bucket_s, mean, w, pct, t0_s=t0)

    def job_stats(self, job_id: str, qs=(10, 50, 90)) -> BucketStats:
        return self._stats(("job", job_id), qs)

    def group_stats(self, group: str, qs=(10, 50, 90)) -> BucketStats:
        return self._stats(("group", group), qs)

    def fleet_stats(self, qs=(10, 50, 90)) -> BucketStats:
        return self._stats(("group", _FLEET), qs)

    @property
    def jobs(self) -> list:
        return [k[1] for k in self._hists if k[0] == "job"]

    @property
    def groups(self) -> list:
        return [k[1] for k in self._hists
                if k[0] == "group" and k[1] != _FLEET]

    def job_meta(self, job_id: str):
        """Copy of the metadata registered for a job at ingest (chips /
        app_mfu / arch / flops_variant), or None if the job never reported
        an app MFU — what the serving layer attaches to job queries."""
        m = self._job_meta.get(job_id)
        return dict(m) if m is not None else None

    def job_ofu(self, job_id: str, *, fill: bool = True) -> np.ndarray:
        """Per-bucket mean OFU series — detector-ready input for
        `regression.detect_regressions`.  fill=True forward-fills empty
        buckets so the detector never sees NaN gaps."""
        mean = self.job_stats(job_id, qs=()).mean.copy()
        return _ffill(mean) if fill else mean

    def fleet_ofu(self, *, fill: bool = True) -> np.ndarray:
        """Fleet-wide per-bucket mean OFU series (chip-weighted across
        every job), detector-ready like `job_ofu` — what the goodput
        drop detector (`fleet.goodput.scan_goodput`) consumes."""
        mean = self.fleet_stats(qs=()).mean.copy()
        return _ffill(mean) if fill else mean

    def to_job_points(self):
        """Bridge to `divergence.analyze`: one JobPoint per ingested job
        (requires app MFU captured via add_job)."""
        from repro_torch.fleet.divergence import JobPoint
        out = []
        for jid in self.jobs:
            m = self._job_meta.get(jid)
            if m is None:
                continue
            ofu = weighted_mean(self.job_stats(jid, qs=()))
            out.append(JobPoint(jid, m["arch"], m["chips"], m["app_mfu"],
                                ofu, m["flops_variant"]))
        return out

    def summary(self) -> str:
        f = self.fleet_stats()
        mean = weighted_mean(f)
        last = f.percentiles.get(50, np.array([np.nan]))[-1] \
            if self.n_buckets else float("nan")
        return (f"fleet_rollup buckets={self.n_buckets} "
                f"jobs={len(self.jobs)} groups={len(self.groups)} "
                f"weighted_ofu={mean * 100:.1f}% "
                f"last_bucket_p50={last * 100:.1f}%")


class WindowedRollup(StreamingRollup):
    """Ring-buffer rollup: full per-bucket detail for the LAST `retain`
    buckets, plus all-time totals for everything already evicted.

    A long-lived collector cannot let per-bucket state grow with uptime;
    this bounds it.  Retained buckets carry the same histograms a plain
    `StreamingRollup` would, so detector readouts over the retained span
    (`job_ofu`, `*_stats`) are bucketwise IDENTICAL to a fresh rollup fed
    the same samples — eviction only ever removes buckets older than the
    horizon, folding their mass into per-scope all-time histograms
    (`job_alltime` / `fleet_alltime` keep lifetime mean/percentiles
    readable after the detail is gone).

    The windowed state stays a monoid: retained rows align by ABSOLUTE
    bucket index and add, eviction transfers are additive and depend only
    on the union's newest bucket, so `merge()` remains associative and
    commutative and `tree_reduce` works unchanged over windowed snapshots.
    The one order-dependent edge: a sample already older than the horizon
    AT INGEST TIME folds straight into the all-time totals (it has no row
    to land in).

    Readout indices are window-relative; `bucket0` is the absolute index
    of row 0 (and `BucketStats.t0_s`/`centers_s` report absolute time), so
    alert keys can be pinned to absolute buckets across evictions.
    """

    def __init__(self, bucket_s: float = 300.0, *, retain: int = 24,
                 bins: int = 128, lo: float = 0.0, hi: float = 1.1):
        if retain < 1:
            raise ValueError(f"retain={retain} must be >= 1 bucket")
        super().__init__(bucket_s, bins=bins, lo=lo, hi=hi)
        self.retain = int(retain)
        self.bucket0 = 0
        self._ev_hist: dict = {}    # scope -> (bins,) evicted histogram
        self._ev_sum: dict = {}     # scope -> evicted weighted value sum

    def spawn_empty(self) -> "WindowedRollup":
        return WindowedRollup(self.bucket_s, retain=self.retain,
                              bins=self.bins, lo=float(self.edges[0]),
                              hi=float(self.edges[-1]))

    @property
    def end_bucket(self) -> int:
        """Absolute index one past the newest stored bucket."""
        return self.bucket0 + self.n_buckets

    # -- eviction -----------------------------------------------------------
    def _ev_arrays(self, scope) -> np.ndarray:
        h = self._ev_hist.get(scope)
        if h is None:
            h = self._ev_hist[scope] = np.zeros(self.bins)
            self._ev_sum[scope] = 0.0
        return h

    def _evict(self, rows: int) -> None:
        """Fold the oldest `rows` window rows into the all-time totals."""
        for scope in list(self._hists):
            h, s = self._hists[scope], self._sums[scope]
            drop = min(rows, h.shape[0])
            if drop and h[:drop].any():
                self._ev_arrays(scope)
                self._ev_hist[scope] += h[:drop].sum(axis=0)
                self._ev_sum[scope] += float(s[:drop].sum())
            self._hists[scope] = h[drop:].copy()
            self._sums[scope] = s[drop:].copy()
            self._touched[scope] = self._touched[scope][drop:].copy()
        self.bucket0 += rows
        self.n_buckets = max(self.n_buckets - rows, 0)

    def _advance_to(self, end_abs: int) -> None:
        """Evict until the window can hold absolute bucket end_abs - 1."""
        over = end_abs - (self.bucket0 + self.retain)
        if over > 0:
            self._evict(over)

    # -- ingest ---------------------------------------------------------
    def observe(self, job_id: str, t_s: np.ndarray, ofu: np.ndarray, *,
                group: str = "unknown", weight: float = 1.0) -> None:
        v, b_abs, k = self._bucketize(t_s, ofu)
        if not v.size:
            return
        self.generation += 1
        self._advance_to(int(b_abs.max()) + 1)
        live = b_abs >= self.bucket0
        rel = b_abs[live] - self.bucket0
        b_needed = int(rel.max()) + 1 if rel.size else 0
        for scope in (("job", job_id), ("group", group), ("group", _FLEET)):
            h, s = self._scope_arrays(scope, b_needed)
            if rel.size:
                np.add.at(h, (rel, k[live]), weight)
                np.add.at(s, rel, v[live] * weight)
                self._touched[scope][rel] = self.generation
            if not live.all():       # already past the horizon at ingest
                self._ev_arrays(scope)
                np.add.at(self._ev_hist[scope], k[~live], weight)
                self._ev_sum[scope] += float(v[~live].sum() * weight)

    def observe_hist(self, job_id: str, hist: np.ndarray,
                     sums: np.ndarray, *, b0: int = 0,
                     group: str = "unknown", weight: float = 1.0) -> None:
        """Pre-binned ingest with the window semantics of observe():
        advance the horizon to cover the newest row, land live rows in
        the window, and fold rows already past the horizon straight into
        the all-time totals (same edge `observe` documents)."""
        hist = np.asarray(hist)
        B = hist.shape[0]
        if B == 0:
            return
        if hist.shape[1] != self.bins:
            raise ValueError(f"histogram has {hist.shape[1]} bins, "
                             f"rollup has {self.bins}")
        sums = np.asarray(sums)
        self.generation += 1
        self._advance_to(b0 + B)
        cut = min(max(self.bucket0 - b0, 0), B)     # rows past the horizon
        live = B - cut
        rel0 = b0 + cut - self.bucket0
        for scope in (("job", job_id), ("group", group), ("group", _FLEET)):
            if cut and hist[:cut].any():
                self._ev_arrays(scope)
                self._ev_hist[scope] += hist[:cut].sum(axis=0) * weight
                self._ev_sum[scope] += float(sums[:cut].sum()) * weight
            h, s = self._scope_arrays(scope, rel0 + live if live else 0)
            if live:
                h[rel0:rel0 + live] += hist[cut:] * weight
                s[rel0:rel0 + live] += sums[cut:] * weight
                self._touched[scope][rel0:rel0 + live] = self.generation

    # -- distribution ---------------------------------------------------
    def merge(self, other: StreamingRollup) -> "WindowedRollup":
        """Fold another rollup in, aligning by ABSOLUTE bucket index.

        `other` may be windowed (same retain) or plain (treated as a
        window starting at bucket 0).  Rows older than the merged window's
        horizon fold into the all-time totals — exactly what eviction
        would have done had the data been ingested here.
        """
        if (self.bucket_s != other.bucket_s or self.bins != other.bins
                or not np.array_equal(self.edges, other.edges)):
            raise ValueError("cannot merge rollups with different "
                             "bucketing (bucket_s/bins/edges must match)")
        o_retain = getattr(other, "retain", None)
        if o_retain is not None and o_retain != self.retain:
            raise ValueError(f"cannot merge windowed rollups with "
                             f"different retention ({self.retain} vs "
                             f"{o_retain} buckets)")
        ob0 = other.bucket0
        self.generation += 1
        self._advance_to(max(self.end_bucket, ob0 + other.n_buckets))
        for scope, oh in other._hists.items():
            osum = other._sums[scope]
            cut = min(max(self.bucket0 - ob0, 0), oh.shape[0])
            if cut and oh[:cut].any():
                self._ev_arrays(scope)
                self._ev_hist[scope] += oh[:cut].sum(axis=0)
                self._ev_sum[scope] += float(osum[:cut].sum())
            live = oh.shape[0] - cut
            rel0 = ob0 + cut - self.bucket0
            h, s = self._scope_arrays(scope, rel0 + live if live > 0 else 0)
            if live > 0:
                h[rel0:rel0 + live] += oh[cut:]
                s[rel0:rel0 + live] += osum[cut:]
                self._touched[scope][rel0:rel0 + live] = self.generation
        for scope, eh in getattr(other, "_ev_hist", {}).items():
            self._ev_arrays(scope)
            self._ev_hist[scope] += eh
            self._ev_sum[scope] += other._ev_sum[scope]
        for jid, m in other._job_meta.items():
            self._job_meta.setdefault(jid, dict(m))
        return self

    def _snapshot_extra(self, meta: dict, arrays: dict) -> None:
        meta["kind"] = "windowed"
        meta["retain"] = self.retain
        meta["bucket0"] = self.bucket0
        meta["escopes"] = [list(k) for k in self._ev_hist]
        for idx, scope in enumerate(self._ev_hist):
            arrays[f"e{idx}"] = self._ev_hist[scope]
        arrays["esums"] = np.array([self._ev_sum[k] for k in self._ev_hist])

    # -- all-time readout (evicted + retained) ----------------------------
    def _alltime(self, scope, qs=(10, 50, 90)) -> dict:
        hist = np.zeros(self.bins)
        total = 0.0
        h = self._hists.get(scope)
        if h is not None:
            hist += h.sum(axis=0)
            total += float(self._sums[scope].sum())
        eh = self._ev_hist.get(scope)
        if eh is not None:
            hist += eh
            total += self._ev_sum[scope]
        w = float(hist.sum())
        return {"mean": total / w if w > 0 else float("nan"),
                "weight": w,
                "percentiles": {q: hist_percentile(self.edges, hist, q)
                                for q in qs}}

    def job_alltime(self, job_id: str, qs=(10, 50, 90)) -> dict:
        """Lifetime mean/weight/percentiles for a job — survives eviction."""
        return self._alltime(("job", job_id), qs)

    def fleet_alltime(self, qs=(10, 50, 90)) -> dict:
        return self._alltime(("group", _FLEET), qs)

    def summary(self) -> str:
        at = self.fleet_alltime(qs=())
        return (super().summary()
                + f" window=[{self.bucket0},{self.end_bucket}) "
                  f"retain={self.retain} "
                  f"alltime_ofu={at['mean'] * 100:.1f}%")
