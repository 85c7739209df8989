"""Application-side MFU reporting: the app half of the OFU<->MFU join.

Training frameworks already log their achieved model-FLOPs throughput —
Megatron-style progress lines carry ``throughput per GPU (TFLOP/s/GPU)``
and ``elapsed time per iteration (ms)`` fields.  This module turns that
stream into per-job, time-stamped MFU samples the correlation tier
(`repro_torch.fleet.correlation`) can bucket against counter-derived OFU:

  * `extract_tflops_from_log` / `compute_mfu` — stateless log-line
    extraction and throughput -> MFU conversion (Eq. 10);
  * `MfuReporter` — a stateful line feeder that keeps the job clock
    (from the log's own elapsed-ms field when present), accumulates
    `MfuSample`s, and hands them off as a pollable source;
  * `MfuReplaySource` — poll/cursor semantics over an in-memory sample
    series, the MFU mirror of `telemetry.source.GridSource`: a
    `Collector` round polls `(cursor, cursor + duration]` and the
    cursor advances even through gaps;
  * `reported_tflops_per_gpu` — the analytic side: what a framework's
    FLOPs counter (exact or one of the buggy §V-C variants) would
    report for an arch at a measured step time, via
    `flops.accounting.step_flops`.

The reported number is whatever the framework BELIEVES it executed —
a miscalculated counter (``naive_moe``, ``naive_hybrid``) inflates it,
which is exactly the signature the correlation tier detects.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Optional, Union

import numpy as np

from repro_torch.core.ofu import effective_peak, mfu_from_throughput
from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec

# Megatron-LM-style progress-line fields (tohtana's log-bench format)
ITERATION_RE = re.compile(r"iteration\s+(\d+)")
TFLOPS_RE = re.compile(
    r"throughput per GPU \(TFLOP/s/GPU\):\s*([0-9]*\.?[0-9]+)")
ELAPSED_MS_RE = re.compile(
    r"elapsed time per iteration \(ms\):\s*([0-9]*\.?[0-9]+)")
#: leading wall-clock stamp Megatron/torchrun prepend, e.g.
#: ``[2026-08-09 13:04:55]`` or ``2026-08-09 13:04:55,123`` — date and
#: time with optional fractional seconds
TIMESTAMP_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})[ T](\d{2}):(\d{2}):(\d{2})(?:[.,](\d+))?")


def extract_wall_time(line: str) -> Optional[float]:
    """Wall-clock seconds (arbitrary absolute epoch) from a log line's
    timestamp, or None.  Only DIFFERENCES between lines are meaningful
    — the reporter anchors its relative clock to them."""
    m = TIMESTAMP_RE.search(line)
    if m is None:
        return None
    import datetime
    y, mo, d, h, mi, s = (int(g) for g in m.groups()[:6])
    frac = m.group(7)
    us = int(round(float("0." + frac) * 1e6)) if frac else 0
    try:
        dt = datetime.datetime(y, mo, d, h, mi, s, us)
    except ValueError:            # e.g. month 13: not a real timestamp
        return None
    return dt.timestamp()


def compute_mfu(tflops_per_gpu: float, peak_tflops: float) -> float:
    """Reported throughput -> MFU fraction (Eq. 10, one-chip form)."""
    if peak_tflops <= 0:
        raise ValueError(f"peak_tflops={peak_tflops} must be positive")
    return mfu_from_throughput(tflops_per_gpu, peak_tflops)


def extract_tflops_from_log(
        lines: Union[str, Iterable[str]]) -> list[dict]:
    """Pull (iteration, tflops_per_gpu, elapsed_ms) records out of a
    training log.  Lines without a throughput field are skipped; the
    iteration and elapsed-ms fields are optional per line."""
    if isinstance(lines, str):
        lines = lines.splitlines()
    records = []
    for line in lines:
        m = TFLOPS_RE.search(line)
        if m is None:
            continue
        it = ITERATION_RE.search(line)
        ms = ELAPSED_MS_RE.search(line)
        records.append({
            "iteration": int(it.group(1)) if it else None,
            "tflops_per_gpu": float(m.group(1)),
            "elapsed_ms": float(ms.group(1)) if ms else None,
        })
    return records


@dataclass(frozen=True)
class MfuSample:
    """One app-reported efficiency observation."""

    t_s: float                 # job-relative seconds
    mfu: float                 # fraction of effective peak
    tflops_per_gpu: float
    iteration: Optional[int] = None


@dataclass
class MfuReporter:
    """Feed training-log lines, collect time-stamped MFU samples.

    The clock starts at `t0_s` and advances by each line's own
    elapsed-ms field when present, else by `default_interval_s` — so a
    log with no absolute timestamps still yields a monotone sample
    series aligned with the job's relative clock (the same clock the
    simulator's scrape grid uses).

    WALL-CLOCK ANCHORING: when lines carry real timestamps (Megatron
    prepends ``[YYYY-MM-DD HH:MM:SS]``), sample times anchor to them
    instead of the elapsed-ms accumulator — the first timestamped line
    pins (wall time ↔ job clock) and every later timestamped sample
    lands at `anchor + (wall - wall0)`.  Elapsed-ms only measures the
    iteration itself, so checkpoint stalls, evals and dataloader hangs
    silently DESYNC the accumulator from real time; the wall anchor is
    what lets a live reporter's samples join counter buckets on
    absolute time (the OFU↔MFU correlation join).  Untimestamped lines
    fall back to the accumulator, re-synced at each timestamped one.
    """

    job_id: str
    peak_tflops: float
    t0_s: float = 0.0
    default_interval_s: float = 30.0
    samples: list = field(default_factory=list)

    def __post_init__(self):
        if self.peak_tflops <= 0:
            raise ValueError(
                f"peak_tflops={self.peak_tflops} must be positive")
        self._clock_s = float(self.t0_s)
        self._wall0: Optional[float] = None    # first line's wall time
        self._anchor_s = 0.0                   # job clock at that line

    @classmethod
    def for_chip(cls, job_id: str, *, chip: ChipSpec = DEFAULT_CHIP,
                 precisions: Optional[dict] = None, **kw) -> "MfuReporter":
        """Reporter with the peak derived from a chip's effective peak
        over the job's precision mix (defaults to pure bf16)."""
        peak = effective_peak(precisions or {"bf16": 1.0}, chip)
        return cls(job_id, peak, **kw)

    def feed(self, line: str,
             t_s: Optional[float] = None) -> Optional[MfuSample]:
        """Parse one log line; returns the new sample or None.

        An explicit `t_s` pins the sample's timestamp (and resets the
        internal clock); otherwise the clock advances per the line.
        """
        recs = extract_tflops_from_log([line])
        if not recs:
            return None
        rec = recs[0]
        dt = (rec["elapsed_ms"] / 1e3 if rec["elapsed_ms"] is not None
              else self.default_interval_s)
        wall = extract_wall_time(line)
        if t_s is not None:
            self._clock_s = float(t_s)
            if wall is not None:       # explicit pin re-anchors the wall
                self._wall0, self._anchor_s = wall, self._clock_s
        elif wall is not None:
            if self._wall0 is None:
                # first timestamped line: accept the accumulator's
                # position once, then pin wall time to it
                self._clock_s += dt
                self._wall0, self._anchor_s = wall, self._clock_s
            else:
                self._clock_s = self._anchor_s + (wall - self._wall0)
        else:
            self._clock_s += dt
        sample = MfuSample(
            t_s=self._clock_s,
            mfu=compute_mfu(rec["tflops_per_gpu"], self.peak_tflops),
            tflops_per_gpu=rec["tflops_per_gpu"],
            iteration=rec["iteration"])
        self.samples.append(sample)
        return sample

    def feed_log(self, lines: Union[str, Iterable[str]]) -> list:
        """Feed a whole log (string or line iterable); returns the
        samples it produced."""
        if isinstance(lines, str):
            lines = lines.splitlines()
        return [s for s in (self.feed(ln) for ln in lines)
                if s is not None]

    def to_source(self) -> "MfuReplaySource":
        """Snapshot the accumulated samples as a pollable source."""
        return MfuReplaySource(
            np.array([s.t_s for s in self.samples], dtype=float),
            np.array([s.mfu for s in self.samples], dtype=float))


class MfuReplaySource:
    """Replays an in-memory MFU sample series with poll/cursor
    semantics — the MFU counterpart of `source.GridSource`.

    `poll(duration_s)` returns the `(t_s, mfu)` arrays with
    `cursor < t <= cursor + duration` and advances the cursor by the
    full duration (gaps advance time, like an empty scrape round).
    """

    def __init__(self, t_s, mfu):
        t = np.asarray(t_s, dtype=float)
        v = np.asarray(mfu, dtype=float)
        if t.ndim != 1 or t.shape != v.shape:
            raise ValueError(
                f"t_s {t.shape} and mfu {v.shape} must be equal-length "
                "1-D arrays")
        if t.size and np.any(np.diff(t) < 0):
            raise ValueError("sample times must be non-decreasing")
        self.t_s = t
        self.mfu = v
        self._cursor_s = 0.0

    @classmethod
    def constant(cls, mfu: float, *, duration_s: float,
                 interval_s: float = 30.0) -> "MfuReplaySource":
        """A steady reporter: one sample per interval at a fixed MFU
        (the scenario library's shape for always-on app reporting)."""
        n = int(round(duration_s / interval_s))
        t = (np.arange(n, dtype=float) + 1.0) * interval_s
        return cls(t, np.full(n, float(mfu)))

    @property
    def cursor_s(self) -> float:
        return self._cursor_s

    @property
    def exhausted(self) -> bool:
        return (not self.t_s.size
                or self._cursor_s >= float(self.t_s[-1]) - 1e-9)

    def seek(self, t_s: float) -> None:
        """Reposition the replay cursor (collector snapshot restore)."""
        if t_s < 0:
            raise ValueError(f"seek target {t_s}s must be >= 0")
        self._cursor_s = float(t_s)

    def poll(self, duration_s: float):
        if duration_s <= 0:
            raise ValueError(
                f"poll duration {duration_s}s must be positive")
        c = self._cursor_s
        i0, i1 = np.searchsorted(self.t_s,
                                 [c + 1e-9, c + duration_s + 1e-9])
        self._cursor_s = c + duration_s
        return self.t_s[i0:i1], self.mfu[i0:i1]


def reported_tflops_per_gpu(arch: str, step_time_s: float, chips: int, *,
                            shape: str = "train_4k",
                            variant: str = "exact",
                            remat: bool = False) -> float:
    """What an app's FLOPs counter would log per GPU for this arch at a
    measured step time — exact, or one of the §V-C buggy variants."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.flops.accounting import step_flops
    if step_time_s <= 0:
        raise ValueError(f"step_time_s={step_time_s} must be positive")
    if chips < 1:
        raise ValueError(f"chips={chips} must be >= 1")
    bd = step_flops(get_config(arch), SHAPES[shape], variant=variant,
                    executed=False, remat=remat)
    return bd.total_mxu / step_time_s / chips / 1e12
