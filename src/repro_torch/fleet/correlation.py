"""OFU<->MFU correlation tier: join, rolling r, and the §V-C
miscalculation detector.

`MfuRollup` holds the app-reported half: per-job, time-bucketed MFU
samples (fed by `telemetry.mfu.MfuReporter` / `MfuReplaySource`, or
POSTed through the serve tier).  It uses the SAME right-closed bucket
rule as `StreamingRollup` — a scrape at t covers (t - interval, t], so
bucket k-1 owns a boundary sample — which is what makes (job, bucket)
keys join exactly against the counter-derived OFU rollup.

On the joined series this module computes:

  * rolling Pearson r over trailing bucket windows (`rolling_pearson`);
  * tile-quantization-corrected residuals — OFU is adjusted by the
    arch's dominant-GEMM padding factor (Eq. 8) before comparison, so
    the residual reflects accounting, not tiling;
  * the miscalculation signature (`scan_miscalc`): a job whose
    MFU / adjusted-OFU ratio sits persistently outside
    [ratio_low, ratio_high] is reporting FLOPs it did not execute
    (`naive_moe`, `naive_hybrid`) or under-billing them.  Jobs below
    `ofu_floor` are exempt — an idle denominator proves nothing.

`analyze_correlation` wraps the lot into one report (fleet r with and
without the flagged set, MAE, per-scale error table) — the live-path
counterpart of `divergence.analyze`, consumed by
`serve.store.FleetStore.correlation` and `/v1/query?kind=correlation`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.ofu import pearson_r
from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.fleet.divergence import DEFAULT_OFU_FLOOR

_TQ_CACHE: dict = {}


def tile_quant_factor(arch: str, chip: ChipSpec = DEFAULT_CHIP) -> float:
    """Mean executed/theoretical FLOPs ratio for the arch's dominant
    GEMMs (Eq. 8's correction denominator); 1.0 for unknown archs so
    the correction degrades to identity instead of failing the scan."""
    key = (arch, chip.name)
    hit = _TQ_CACHE.get(key)
    if hit is None:
        try:
            from repro_torch.configs.base import get_config
            from repro_torch.fleet.jobs import _tile_quant_factor
            hit = float(_tile_quant_factor(get_config(arch), chip))
        except (KeyError, ValueError, ImportError):
            hit = 1.0
        _TQ_CACHE[key] = hit
    return hit


class MfuRollup:
    """Per-job bucketed MFU accumulator — sparse (dict-of-buckets per
    job), mergeable, and cheap to copy: app reporters are per-job log
    streams, orders of magnitude lighter than device counter grids."""

    __slots__ = ("bucket_s", "_acc", "generation")

    def __init__(self, bucket_s: float = 300.0):
        if bucket_s <= 0:
            raise ValueError(f"bucket_s={bucket_s} must be positive")
        self.bucket_s = float(bucket_s)
        self._acc: dict = {}    # job_id -> {bucket_idx: [w_sum, wv_sum]}
        self.generation = 0

    def _bucket(self, t_s: float) -> int:
        # the ONE bucketing rule, scalar form of StreamingRollup's
        return max(int(np.ceil(t_s / self.bucket_s)) - 1, 0)

    # -- ingest ---------------------------------------------------------
    def observe(self, job_id: str, t_s: float, mfu: float,
                weight: float = 1.0) -> None:
        if not job_id:
            raise ValueError("job_id must be non-empty")
        if weight <= 0:
            raise ValueError(f"weight={weight} must be positive")
        buckets = self._acc.setdefault(job_id, {})
        acc = buckets.setdefault(self._bucket(float(t_s)), [0.0, 0.0])
        acc[0] += float(weight)
        acc[1] += float(weight) * float(mfu)
        self.generation += 1

    def observe_series(self, job_id: str, t_s, mfu) -> None:
        """Bulk ingest aligned (t_s, mfu) arrays (one reporter poll)."""
        t = np.asarray(t_s, float).ravel()
        v = np.asarray(mfu, float).ravel()
        if t.shape != v.shape:
            raise ValueError(
                f"t_s {t.shape} and mfu {v.shape} must align")
        if not t.size:
            return
        if not job_id:
            raise ValueError("job_id must be non-empty")
        b = np.maximum(np.ceil(t / self.bucket_s).astype(int) - 1, 0)
        buckets = self._acc.setdefault(job_id, {})
        for idx in np.unique(b):
            sel = b == idx
            acc = buckets.setdefault(int(idx), [0.0, 0.0])
            acc[0] += float(np.count_nonzero(sel))
            acc[1] += float(v[sel].sum())
        self.generation += 1

    def merge(self, other: "MfuRollup") -> "MfuRollup":
        """Element-wise accumulate (associative + commutative, like
        `StreamingRollup.merge` — host shards reduce the same way)."""
        if abs(other.bucket_s - self.bucket_s) > 1e-9:
            raise ValueError(
                f"bucket_s mismatch: {self.bucket_s} vs {other.bucket_s}")
        for jid, buckets in other._acc.items():
            mine = self._acc.setdefault(jid, {})
            for idx, (w, wv) in buckets.items():
                acc = mine.setdefault(idx, [0.0, 0.0])
                acc[0] += w
                acc[1] += wv
        self.generation += 1
        return self

    def copy(self) -> "MfuRollup":
        out = MfuRollup(self.bucket_s)
        out._acc = {jid: {idx: list(acc) for idx, acc in buckets.items()}
                    for jid, buckets in self._acc.items()}
        out.generation = self.generation
        return out

    # -- readout --------------------------------------------------------
    @property
    def jobs(self) -> list:
        return list(self._acc)

    def job_buckets(self, job_id: str) -> np.ndarray:
        """Sorted absolute bucket indices holding samples for a job."""
        return np.array(sorted(self._acc.get(job_id, {})), dtype=int)

    def job_series(self, job_id: str):
        """(bucket_idx, per-bucket weighted-mean MFU) aligned arrays."""
        buckets = self._acc.get(job_id, {})
        idx = np.array(sorted(buckets), dtype=int)
        mean = np.array([buckets[i][1] / buckets[i][0] for i in idx],
                        dtype=float)
        return idx, mean

    def job_mean(self, job_id: str) -> Optional[float]:
        """Weight-weighted all-time MFU, or None if the job never
        reported — the value collector rounds feed into job metadata."""
        buckets = self._acc.get(job_id)
        if not buckets:
            return None
        w = sum(acc[0] for acc in buckets.values())
        wv = sum(acc[1] for acc in buckets.values())
        return wv / w

    def n_samples(self, job_id: str) -> float:
        return sum(acc[0] for acc in self._acc.get(job_id, {}).values())

    # -- wire (the POST /v1/mfu body) -----------------------------------
    def to_payload(self) -> dict:
        """JSON-ready dump: {"bucket_s", "jobs": {id: [[bucket, w, wv]]}}."""
        return {"bucket_s": self.bucket_s,
                "jobs": {jid: [[int(i), acc[0], acc[1]]
                               for i, acc in sorted(buckets.items())]
                         for jid, buckets in self._acc.items()}}

    def apply_payload(self, payload: dict) -> int:
        """Accumulate a `to_payload` dump (or a raw-sample body:
        {"job_id", "samples": [[t_s, mfu], ...]}).  Returns the number
        of rows applied; raises ValueError on a malformed body."""
        if not isinstance(payload, dict):
            raise ValueError("payload must be a JSON object")
        if "samples" in payload:
            jid = payload.get("job_id")
            samples = payload["samples"]
            if not jid or not isinstance(samples, list):
                raise ValueError(
                    'raw body needs "job_id" and "samples": [[t_s, mfu]]')
            try:
                pairs = [(float(t), float(v)) for t, v in samples]
            except (TypeError, ValueError):
                raise ValueError(
                    "samples must be [t_s, mfu] number pairs") from None
            if pairs:
                t, v = zip(*pairs)
                self.observe_series(jid, t, v)
            return len(pairs)
        jobs = payload.get("jobs")
        if not isinstance(jobs, dict):
            raise ValueError('payload needs "jobs" or "samples"')
        b = payload.get("bucket_s", self.bucket_s)
        if abs(float(b) - self.bucket_s) > 1e-9:
            raise ValueError(
                f"bucket_s mismatch: store has {self.bucket_s}, "
                f"payload has {b}")
        n = 0
        for jid, rows in jobs.items():
            if not jid or not isinstance(rows, list):
                raise ValueError("jobs must map id -> [[bucket, w, wv]]")
            mine = self._acc.setdefault(jid, {})
            for row in rows:
                try:
                    idx, w, wv = int(row[0]), float(row[1]), float(row[2])
                except (TypeError, ValueError, IndexError):
                    raise ValueError(
                        "rows must be [bucket, weight, weighted_sum] "
                        "triples") from None
                if w <= 0:
                    raise ValueError(f"row weight {w} must be positive")
                acc = mine.setdefault(idx, [0.0, 0.0])
                acc[0] += w
                acc[1] += wv
                n += 1
        if n:
            self.generation += 1
        return n


# ---------------------------------------------------------------------------
# join + statistics
# ---------------------------------------------------------------------------
def joined_series(mfu_roll: MfuRollup, roll, job_id: str):
    """Align one job's MFU and OFU bucket series by ABSOLUTE bucket
    index; returns (bucket_idx, mfu, ofu) over the intersection (empty
    arrays when either side lacks the job).  `roll` is a Streaming- or
    WindowedRollup (`bucket0` anchors window rows to absolute buckets).
    """
    if abs(mfu_roll.bucket_s - roll.bucket_s) > 1e-9:
        raise ValueError(f"bucket_s mismatch: MFU {mfu_roll.bucket_s} "
                         f"vs OFU {roll.bucket_s}")
    midx, mval = mfu_roll.job_series(job_id)
    stats = roll.job_stats(job_id, qs=())
    empty = np.empty(0)
    if not midx.size or not stats.mean.size:
        return empty.astype(int), empty, empty
    rows = np.nonzero(stats.weight > 0)[0]
    oidx = rows + roll.bucket0
    common, mi, oi = np.intersect1d(midx, oidx, return_indices=True)
    return common, mval[mi], stats.mean[rows][oi]


def rolling_pearson(x, y, window: int = 8) -> np.ndarray:
    """Trailing-window Pearson r at every index (0.0 until two points
    are in the window or while variance is degenerate) — the dashboard
    sparkline for "is this job's app report tracking its counters"."""
    if window < 2:
        raise ValueError(f"window={window} must be >= 2")
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if x.shape != y.shape or x.ndim != 1:
        raise ValueError("x and y must be equal-length 1-D")
    out = np.zeros(x.size)
    for i in range(x.size):
        lo = max(0, i - window + 1)
        if i - lo >= 1:
            out[i] = pearson_r(x[lo:i + 1], y[lo:i + 1])
    return out


@dataclass(frozen=True)
class MiscalcFinding:
    """One job flagged by the OFU/MFU-ratio detector."""

    job_id: str
    ratio: float            # mean MFU / mean adjusted OFU
    mfu: float
    ofu: float              # raw (uncorrected) joined-bucket mean
    ofu_adj: float          # tile-quantization-corrected (Eq. 8)
    tq_factor: float
    n_buckets: int
    first_bucket: int       # absolute bucket of the first joined sample
    direction: str          # 'inflated' | 'deflated'

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "ratio": self.ratio,
                "mfu": self.mfu, "ofu": self.ofu,
                "ofu_adj": self.ofu_adj, "tq_factor": self.tq_factor,
                "n_buckets": self.n_buckets,
                "first_bucket": self.first_bucket,
                "direction": self.direction}


@dataclass
class CorrelationConfig:
    """Knobs for the miscalculation scan (defaults match §V-C: the
    naive counters inflate reported FLOPs ~1.8-3x, healthy reporting
    noise stays well inside +-50%)."""

    ratio_high: float = 1.5
    ratio_low: Optional[float] = None    # default: 1 / ratio_high
    min_buckets: int = 1
    ofu_floor: float = DEFAULT_OFU_FLOOR
    window: int = 8
    #: the joined jobs' chip, whose tile policies Eq. 8's correction
    #: takes (`tile_quant_factor`)
    chip: ChipSpec = DEFAULT_CHIP

    def __post_init__(self):
        if self.ratio_high <= 1.0:
            raise ValueError(
                f"ratio_high={self.ratio_high} must be > 1")
        if self.ratio_low is None:
            self.ratio_low = 1.0 / self.ratio_high
        if not 0 < self.ratio_low < 1.0:
            raise ValueError(
                f"ratio_low={self.ratio_low} must be in (0, 1)")
        if self.min_buckets < 1:
            raise ValueError(
                f"min_buckets={self.min_buckets} must be >= 1")
        if self.window < 2:
            raise ValueError(f"window={self.window} must be >= 2")


def _job_join_stats(mfu_roll, roll, job_id, cfg):
    """Per-job joined aggregates, or None when the join is too thin to
    judge (no overlap, too few buckets, sub-floor OFU)."""
    idx, mval, oval = joined_series(mfu_roll, roll, job_id)
    if idx.size < cfg.min_buckets:
        return None
    meta = roll.job_meta(job_id) or {}
    tq = tile_quant_factor(meta.get("arch", "unknown"), cfg.chip)
    mfu = float(mval.mean())
    ofu = float(oval.mean())
    ofu_adj = ofu / tq
    return {"job_id": job_id, "idx": idx, "mfu": mfu, "ofu": ofu,
            "ofu_adj": ofu_adj, "tq": tq, "meta": meta,
            "r_rolling": float(rolling_pearson(
                mval, oval, cfg.window)[-1]) if idx.size >= 2 else 0.0}


def _joined_rows(mfu_roll, roll, cfg) -> list:
    rows = []
    for jid in sorted(set(mfu_roll.jobs) & set(roll.jobs)):
        s = _job_join_stats(mfu_roll, roll, jid, cfg)
        if s is not None:
            rows.append(s)
    return rows


def _scan_rows(rows: list, cfg: CorrelationConfig) -> list:
    findings = []
    for s in rows:
        if s["ofu_adj"] < cfg.ofu_floor:
            continue
        ratio = s["mfu"] / s["ofu_adj"]
        if cfg.ratio_low <= ratio <= cfg.ratio_high:
            continue
        findings.append(MiscalcFinding(
            job_id=s["job_id"], ratio=ratio, mfu=s["mfu"], ofu=s["ofu"],
            ofu_adj=s["ofu_adj"], tq_factor=s["tq"],
            n_buckets=int(s["idx"].size),
            first_bucket=int(s["idx"][0]),
            direction="inflated" if ratio > 1.0 else "deflated"))
    findings.sort(key=lambda f: abs(np.log(max(f.ratio, 1e-12))),
                  reverse=True)
    return findings


def scan_miscalc(mfu_roll: MfuRollup, roll, *,
                 config: Optional[CorrelationConfig] = None) -> list:
    """Flag every joined job whose MFU / adjusted-OFU ratio falls
    outside [ratio_low, ratio_high] — the §V-C miscalculation
    signature.  Returns `MiscalcFinding`s sorted by |log ratio| desc
    (worst offender first)."""
    cfg = config or CorrelationConfig()
    return _scan_rows(_joined_rows(mfu_roll, roll, cfg), cfg)


@dataclass
class CorrelationReport:
    """Fleet-level join summary: the live-path Table III."""

    n_jobs: int                  # jobs with a usable join
    r_all: float                 # per-job mean MFU vs adjusted OFU
    r_clean: float               # same, flagged jobs excluded
    mae: float                   # mean |MFU - adjusted OFU|
    flagged: list = field(default_factory=list)   # MiscalcFinding
    by_scale: dict = field(default_factory=dict)  # chips -> (n, mfu, ae)
    jobs: list = field(default_factory=list)      # per-job rows (dict)

    def to_payload(self) -> dict:
        """Strict-JSON dict (finite floats only) for the serve tier."""
        def _f(x):
            return float(x) if np.isfinite(x) else None
        return {
            "n_jobs": self.n_jobs,
            "r_all": _f(self.r_all), "r_clean": _f(self.r_clean),
            "mae": _f(self.mae),
            "flagged": [f.to_dict() for f in self.flagged],
            "by_scale": {str(c): {"jobs": n, "mfu": _f(m),
                                  "abs_err": _f(e)}
                         for c, (n, m, e) in sorted(self.by_scale.items())},
            "jobs": self.jobs,
        }

    def summary(self) -> str:
        lines = [f"joined_jobs={self.n_jobs} r_all={self.r_all:.3f} "
                 f"r_after_exclusion={self.r_clean:.3f} "
                 f"mae={self.mae * 100:.1f}pp "
                 f"flagged={len(self.flagged)}"]
        for chips, (n, m, e) in sorted(self.by_scale.items()):
            lines.append(f"  chips={chips:>5d} jobs={n:>4d} "
                         f"mfu={m * 100:5.1f}% abs_err={e * 100:5.1f}pp")
        return "\n".join(lines)


def analyze_correlation(mfu_roll: MfuRollup, roll, *,
                        config: Optional[CorrelationConfig] = None
                        ) -> CorrelationReport:
    """Join every reporting job against its OFU rollup and build the
    fleet report: correlation with/without the miscalculation set, MAE
    of tile-quantization-corrected residuals, per-scale error table.

    Degenerate populations (no joins, one job, zero variance) yield
    finite zeros, never NaN — the payload must survive strict JSON.
    """
    cfg = config or CorrelationConfig()
    rows = _joined_rows(mfu_roll, roll, cfg)
    flagged = _scan_rows(rows, cfg)
    flagged_ids = {f.job_id for f in flagged}

    if not rows:
        return CorrelationReport(n_jobs=0, r_all=0.0, r_clean=0.0,
                                 mae=0.0, flagged=flagged)
    mfu = np.array([s["mfu"] for s in rows])
    adj = np.array([s["ofu_adj"] for s in rows])
    err = np.abs(mfu - adj)
    clean = [i for i, s in enumerate(rows)
             if s["job_id"] not in flagged_ids]

    by_scale: dict = {}
    scale = np.array([int(s["meta"].get("chips") or 0) for s in rows])
    for chips in sorted(set(scale.tolist())):
        sel = scale == chips
        by_scale[chips] = (int(sel.sum()), float(mfu[sel].mean()),
                           float(err[sel].mean()))

    job_rows = [{"job_id": s["job_id"],
                 "arch": s["meta"].get("arch", "unknown"),
                 "chips": int(s["meta"].get("chips") or 0),
                 "n_buckets": int(s["idx"].size),
                 "mfu": s["mfu"], "ofu": s["ofu"],
                 "ofu_adj": s["ofu_adj"], "tq_factor": s["tq"],
                 "residual": s["mfu"] - s["ofu_adj"],
                 "r_rolling": s["r_rolling"],
                 "flagged": s["job_id"] in flagged_ids}
                for s in rows]

    return CorrelationReport(
        n_jobs=len(rows),
        r_all=pearson_r(mfu, adj) if len(rows) >= 2 else 0.0,
        r_clean=pearson_r(mfu[clean], adj[clean])
        if len(clean) >= 2 else 0.0,
        mae=float(err.mean()),
        flagged=flagged,
        by_scale=by_scale,
        jobs=job_rows,
    )
