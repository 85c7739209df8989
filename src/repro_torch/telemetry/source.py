"""Telemetry sources: one interface over simulated, replayed, and live
counter streams (the source-agnostic pipeline behind the paper's §V-B
fleet dashboards).

Every source answers `scrapes() -> DeviceGrid`; everything downstream —
`StreamingRollup`, `detect_regressions`, `divergence.analyze` — consumes
that grid and never learns whether the samples came from the vectorized
engine (`SimulatorSource`), a per-poll `CounterBackend` loop
(`BackendSource`, the adapter point for live DCGM/libtpu pollers), or a
recorded trace (`TraceReplaySource`).  Deploying against real hardware
telemetry means adding one more source, not touching the pipeline.

Trace formats:

- CSV (with header) / JSONL — one record per line, the interchange path:

      t_s,device,tpa,clock_mhz
      30.0,0,0.412,1328.5

  `write_trace`/`read_trace` round-trip a `DeviceGrid` exactly (floats
  are serialized at full repr precision).

- Columnar chunked archive (`telemetry/tracestore.py`) — a directory of
  compressed npz column chunks plus a JSON manifest; ~6× smaller than
  CSV and the only format `TraceReplaySource` can STREAM: `poll()` over
  an archive decodes O(chunk) samples, never the whole trace, so a
  multi-week archive replays in constant memory.  `write_trace` /
  `read_trace` dispatch to it for `.ctr` paths (and `fmt="columnar"`);
  `tools/trace_convert.py` converts between all three.

Sources are also RESUMABLE: `poll(duration_s)` scrapes the next chunk of
wall-time from a per-source cursor (grids come back with the right
absolute `t0_s`), which is what the long-lived `fleet.collector.Collector`
drives round after round — and `set_interval` retimes a live source under
the shared §IV-C `check_scrape_interval` policy (the adaptive controller's
actuator).  `scrapes()` remains the stateless one-shot batch view.

See docs/ARCHITECTURE.md for the module-by-module pipeline walkthrough,
including where a real DCGM/libtpu backend plugs in.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.peaks import DEFAULT_CHIP, ChipSpec
from repro_torch.telemetry import tracestore
from repro_torch.telemetry.counters import (CounterBackend, Event, StepProfile,
                                      check_scrape_interval)
from repro_torch.telemetry.scrape import DeviceGrid, scrape


class TelemetrySource:
    """Interface: scrapes() -> DeviceGrid (aligned counter series), plus a
    stateful cursor for incremental collection.

    `scrapes()` is the one-shot batch view.  `poll(duration_s)` scrapes
    only the next `duration_s` seconds, advancing `cursor_s`; returned
    grids carry absolute `t0_s`, so incremental rounds land in the same
    rollup buckets batch ingestion would use.  `exhausted` reports when a
    finite source (fixed-duration simulation, recorded trace) has nothing
    left; `set_interval` retimes future polls where the cadence is ours to
    choose (`retimable` is False for replay — the recorded cadence is
    fixed).
    """

    #: whether set_interval may change this source's scrape cadence
    retimable = True

    def scrapes(self) -> DeviceGrid:
        raise NotImplementedError

    @property
    def cursor_s(self) -> float:
        """Absolute time up to which this source has been polled."""
        return getattr(self, "_cursor_s", 0.0)

    @property
    def exhausted(self) -> bool:
        """True when poll() can no longer produce a sample."""
        return False

    @property
    def bounded(self) -> bool:
        """True if poll() is guaranteed to exhaust eventually.

        Guards `Collector.run(n_rounds=None)` against spinning forever:
        the conservative default treats a source as unbounded unless it
        carries a finite `duration_s` (a custom live poller without one
        is exactly the case that never exhausts); replay overrides this —
        a recorded trace always runs out.
        """
        return bool(np.isfinite(getattr(self, "duration_s", np.inf)))

    def poll(self, duration_s: float) -> DeviceGrid:
        """Scrape the next duration_s seconds; advance the cursor."""
        raise NotImplementedError

    def set_interval(self, interval_s: float) -> None:
        """Retime future polls (§IV-C-checked) — the adaptive-controller
        actuator."""
        if not self.retimable:
            raise ValueError(f"{type(self).__name__} cadence is fixed and "
                             "cannot be retimed")
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be positive")
        # honor the source's own §IV-C policy: a strict=False source that
        # already runs degraded may be retimed within that same policy
        check_scrape_interval(interval_s,
                              strict=getattr(self, "strict", True))
        self.interval_s = float(interval_s)

    def _take(self, duration_s: float) -> int:
        """Whole samples in the next duration_s at the current interval."""
        iv = self.interval_s
        if duration_s < iv:
            raise ValueError(f"poll duration {duration_s}s is shorter than "
                             f"the scrape interval {iv}s — no sample fits")
        return int(duration_s / iv)

    def _chunk_budget(self, duration_s: float) -> int:
        """`_take` clamped to what remains before `duration_s` runs out —
        the shared poll() front half; 0 means 'emit an empty grid'."""
        n = self._take(duration_s)
        total = getattr(self, "duration_s", np.inf)
        if np.isfinite(total):
            n = min(n, int((total - self.cursor_s) / self.interval_s + 1e-9))
        return n

    def _empty_grid(self) -> DeviceGrid:
        return DeviceGrid(self.interval_s, np.empty((0, 0)),
                          np.empty((0, 0)), t0_s=self.cursor_s)


@dataclass
class SimulatorSource(TelemetrySource):
    """Generative source: one fused engine pass (`engine_torch`) per call,
    whose grids are float32 tensors on `device` (the current CUDA device
    when None; `device="cpu"` runs it on the host)."""

    profile: StepProfile
    duration_s: float
    interval_s: float
    chip: ChipSpec = DEFAULT_CHIP
    events: Sequence[Event] = ()
    stragglers: Optional[np.ndarray] = None
    n_devices: int = 1
    seed: int = 0
    strict: bool = True          # same §IV-C policy as BackendSource
    device: Optional[object] = None

    def scrapes(self) -> DeviceGrid:
        # sources are interchangeable, so they enforce §IV-C identically:
        # strict=True rejects average-of-averages intervals up front
        # (strict=False leaves the engine's own degraded-mode warning)
        if self.strict:
            check_scrape_interval(self.interval_s)
        # the engine sits a layer above telemetry; import at call time so
        # replay/live deployments never load the simulator
        from repro_torch.fleet.engine import simulate_devices
        return simulate_devices(
            self.profile, duration_s=self.duration_s,
            interval_s=self.interval_s, chip=self.chip, events=self.events,
            stragglers=self.stragglers, n_devices=self.n_devices,
            seed=self.seed, device=self.device)

    @property
    def exhausted(self) -> bool:
        return self.cursor_s + self.interval_s > self.duration_s + 1e-9

    def poll(self, duration_s: float) -> DeviceGrid:
        """Simulate only the next chunk of the run (cursor-relative).

        Events keep their ABSOLUTE timeline (shifted into chunk-local
        time), and the chunk seed derives deterministically from
        (seed, poll count), so an incremental collection is reproducible
        run-to-run.  Chunks draw independent jitter/clock streams, so a
        chunked collection is statistically — not bit-for-bit — the
        continuation of `scrapes()`.
        """
        if self.strict:
            check_scrape_interval(self.interval_s)
        c = self.cursor_s
        n = self._chunk_budget(duration_s)
        if n <= 0:
            return self._empty_grid()
        rounds = getattr(self, "_polls", 0)
        from repro_torch.fleet.engine import simulate_devices
        shifted = [Event(e.start_s - c, e.end_s - c, slowdown=e.slowdown,
                         mxu_scale=e.mxu_scale, kind=e.kind)
                   for e in self.events]
        chunk_seed = int(np.random.default_rng(
            [self.seed, rounds]).integers(0, 2 ** 31))
        grid = simulate_devices(
            self.profile, duration_s=n * self.interval_s,
            interval_s=self.interval_s, chip=self.chip, events=shifted,
            stragglers=self.stragglers, n_devices=self.n_devices,
            seed=chunk_seed, device=self.device)
        grid.t0_s = c
        self._cursor_s = c + n * self.interval_s
        self._polls = rounds + 1
        return grid


@dataclass
class BackendSource(TelemetrySource):
    """Adapter over scalar `CounterBackend`s: one poll loop per device.

    This is the shape a live poller takes — hand it N DCGM/libtpu-backed
    backends and the rest of the pipeline runs unchanged.
    """

    backends: Sequence[CounterBackend]
    duration_s: float            # may be float('inf') for poll-only use
    interval_s: float
    strict: bool = True

    def scrapes(self) -> DeviceGrid:
        return DeviceGrid.from_series(
            [scrape(be, self.duration_s, self.interval_s, strict=self.strict)
             for be in self.backends])

    @property
    def exhausted(self) -> bool:
        return self.cursor_s + self.interval_s > self.duration_s + 1e-9

    def poll(self, duration_s: float) -> DeviceGrid:
        """Poll every backend for the next chunk; backends keep their own
        clock state (a live DCGM/libtpu poller is naturally resumable)."""
        check_scrape_interval(self.interval_s, strict=self.strict)
        c = self.cursor_s
        n = self._chunk_budget(duration_s)
        if n <= 0:
            return self._empty_grid()
        tpa = np.empty((len(self.backends), n))
        clk = np.empty((len(self.backends), n))
        for d, be in enumerate(self.backends):
            for i in range(n):
                tpa[d, i], clk[d, i] = be.poll(self.interval_s)
        self._cursor_s = c + n * self.interval_s
        return DeviceGrid(self.interval_s, tpa, clk, t0_s=c)


@dataclass
class GridSource(TelemetrySource):
    """Replays an in-memory `DeviceGrid` with poll/cursor semantics.

    The scenario scorecard's source: a fault-injected grid simulated up
    front (`simulate_fleet` + `apply_faults`) replays through a live
    `Collector` round-for-round, deterministically — same contract as
    `TraceReplaySource` without a file.  Not retimable: the grid's
    cadence is fixed.
    """

    grid: DeviceGrid

    retimable = False
    bounded = True               # a finite grid always runs out

    @property
    def interval_s(self) -> float:
        return self.grid.interval_s

    @property
    def exhausted(self) -> bool:
        times = self.grid.times_s
        return not times.size or self.cursor_s >= float(times[-1]) - 1e-9

    def seek(self, t_s: float) -> None:
        """Reposition the replay cursor (collector snapshot restore)."""
        if t_s < 0:
            raise ValueError(f"seek target {t_s}s must be >= 0")
        self._cursor_s = float(t_s)

    def poll(self, duration_s: float) -> DeviceGrid:
        if duration_s <= 0:
            raise ValueError(f"poll duration {duration_s}s must be positive")
        c = self.cursor_s
        times = self.grid.times_s
        i0, i1 = np.searchsorted(times, [c + 1e-9, c + duration_s + 1e-9])
        sub = DeviceGrid(self.grid.interval_s, self.grid.tpa[:, i0:i1],
                         self.grid.clock_mhz[:, i0:i1],
                         t0_s=float(times[i0]) - self.grid.interval_s
                         if i1 > i0 else c)
        self._cursor_s = c + duration_s
        return sub


class DeviceSource:
    """Any source whose grids are handed on as float32 tensors on
    `device`, or as host NumPy arrays when `device` is None: a
    `Collector` then ingests a card's grids through the histogram kernel
    (a CPU tensor's through its plain version, a NumPy grid by the host
    path).  Everything else (cursor, cadence, `exhausted`, `seek`) is
    the wrapped source's."""

    def __init__(self, source, device=None):
        self.source = source
        self.device = device

    def __getattr__(self, name):
        return getattr(self.source, name)

    def poll(self, duration_s: float) -> DeviceGrid:
        g = self.source.poll(duration_s)
        if self.device is None:
            def move(a):
                return a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        else:
            def move(a):
                return torch.as_tensor(a, dtype=torch.float32,
                                       device=self.device)
        return DeviceGrid(g.interval_s, move(g.tpa), move(g.clock_mhz),
                          t0_s=g.t0_s)


@dataclass
class TraceReplaySource(TelemetrySource):
    """Replays recorded (t_s, device, tpa, clock_mhz) scrapes from disk.

    Not retimable: the cadence is whatever the recorder used.  `poll`
    slices the trace by the recorded timestamps, so a collector replays
    an archive round-for-round exactly as it would watch a live fleet
    (polls before the trace's first sample return empty grids).

    Row formats (CSV/JSONL) are materialized once and sliced; a COLUMNAR
    archive (`tracestore.TraceReader`) streams instead — each poll
    decodes only the chunks spanning it, so peak memory is O(chunk) even
    for a multi-week trace, and `exhausted` comes from the manifest
    without touching a single chunk.  `seek(t_s)` repositions the cursor
    (the restart path: resume replay where a snapshotted collector left
    off).
    """

    path: str
    fmt: str = "auto"        # 'csv' | 'jsonl' | 'columnar' | 'auto'
    interval_s: Optional[float] = None   # required for 1-sample row traces

    retimable = False

    bounded = True               # a recorded trace always runs out

    def scrapes(self) -> DeviceGrid:
        return read_trace(self.path, fmt=self.fmt,
                          interval_s=self.interval_s)

    @property
    def reader(self) -> Optional[tracestore.TraceReader]:
        """The archive reader behind a columnar source (None for row
        formats) — exposes the streaming instrumentation."""
        rd = getattr(self, "_reader", None)
        if rd is None and not getattr(self, "_row_fmt", False):
            if _resolve_fmt(self.path, self.fmt) == "columnar":
                rd = self._reader = tracestore.TraceReader(self.path)
            else:
                self._row_fmt = True     # don't re-stat on every poll
        return rd

    def _cached(self) -> DeviceGrid:
        grid = getattr(self, "_grid", None)
        if grid is None:
            grid = self._grid = self.scrapes()
        return grid

    def _span(self) -> tuple:
        """(t0_s, interval_s, n_samples) without materializing an
        archive; row traces still load once here."""
        rd = self.reader
        if rd is not None:
            return rd.t0_s, rd.interval_s, rd.n_samples
        grid = self._cached()
        return grid.t0_s, grid.interval_s, grid.tpa.shape[1]

    @property
    def exhausted(self) -> bool:
        t0, iv, n = self._span()
        return not n or self.cursor_s >= tracestore.sample_time(
            t0, iv, n - 1) - 1e-9

    def seek(self, t_s: float) -> None:
        """Reposition the replay cursor (absolute trace time) — the next
        poll() resumes there, e.g. after a collector snapshot restore."""
        if t_s < 0:
            raise ValueError(f"seek target {t_s}s must be >= 0")
        self._cursor_s = float(t_s)

    def poll(self, duration_s: float) -> DeviceGrid:
        if duration_s <= 0:
            raise ValueError(f"poll duration {duration_s}s must be positive")
        c = self.cursor_s
        rd = self.reader
        if rd is not None:
            # stream: manifest index -> sample range -> spanning chunks
            i0 = rd.searchsorted(c + 1e-9)
            i1 = rd.searchsorted(c + duration_s + 1e-9)
            tpa, clk = rd.read_samples(i0, i1)
            t0 = tracestore.sample_time(rd.t0_s, rd.interval_s, i0) \
                - rd.interval_s if i1 > i0 else c
            sub = DeviceGrid(rd.interval_s, tpa, clk, t0_s=t0)
        else:
            grid = self._cached()
            times = grid.times_s
            i0, i1 = np.searchsorted(times,
                                     [c + 1e-9, c + duration_s + 1e-9])
            sub = DeviceGrid(grid.interval_s, grid.tpa[:, i0:i1],
                             grid.clock_mhz[:, i0:i1],
                             t0_s=float(times[i0]) - grid.interval_s
                             if i1 > i0 else c)
        self._cursor_s = c + duration_s   # wall clock advances regardless
        return sub


_FIELDS = ("t_s", "device", "tpa", "clock_mhz")


def _resolve_fmt(path: str, fmt: str) -> str:
    if fmt != "auto":
        if fmt not in ("csv", "jsonl", "columnar"):
            raise ValueError(f"unknown trace format {fmt!r}")
        return fmt
    path = str(path)
    if os.path.isdir(path):
        if tracestore.is_archive(path):
            return "columnar"
        raise ValueError(
            f"{path!r} is a directory but not a columnar trace archive "
            f"(no {tracestore.MANIFEST_NAME}); pass fmt explicitly if "
            "this is intentional")
    low = path.lower()
    if low.endswith((tracestore.COLUMNAR_SUFFIX, tracestore.V2_SUFFIX)):
        return "columnar"
    if os.path.isfile(path) and tracestore.is_v2_archive(path):
        return "columnar"        # suffix-less ctr-v2 file: sniff the magic
    if low.endswith(".csv"):
        return "csv"
    if low.endswith((".jsonl", ".ndjson", ".json")):
        return "jsonl"
    raise ValueError(f"cannot infer trace format from {path!r}; "
                     "pass fmt='csv', 'jsonl', or 'columnar'")


def write_trace(grid: DeviceGrid, path: str, *, fmt: str = "auto",
                chunk_samples: int = tracestore.DEFAULT_CHUNK_SAMPLES,
                codec: Optional[str] = None) -> None:
    """Record a DeviceGrid as a replayable scrape trace (CSV, JSONL, or
    a chunked columnar archive for `.ctr`/`.ctr2`/fmt='columnar' paths —
    `chunk_samples` applies only there, and `codec` only to `.ctr2`)."""
    fmt = _resolve_fmt(path, fmt)
    if fmt == "columnar":
        tracestore.write_archive(grid, path, chunk_samples=chunk_samples,
                                 codec=codec)
        return
    if codec is not None:
        raise ValueError(f"codec={codec!r} applies only to columnar "
                         "ctr-v2 archives, not row formats")
    # bulk-convert once (tolist yields Python floats, repr-exact) instead
    # of a per-cell numpy-scalar conversion — fleet grids are millions of
    # samples and the trace writer must not dwarf the ~ms simulation
    tpa = grid.tpa.astype(float).tolist()
    clk = grid.clock_mhz.astype(float).tolist()
    with open(path, "w", newline="") as fh:
        if fmt == "csv":
            times = [repr(t) for t in grid.times_s.tolist()]
            w = csv.writer(fh)
            w.writerow(_FIELDS)
            w.writerows((t, d, repr(a), repr(c))
                        for d in range(grid.n_devices)
                        for t, a, c in zip(times, tpa[d], clk[d]))
        else:
            times_f = grid.times_s.tolist()
            fh.writelines(
                json.dumps({"t_s": t, "device": d, "tpa": a,
                            "clock_mhz": c}) + "\n"
                for d in range(grid.n_devices)
                for t, a, c in zip(times_f, tpa[d], clk[d]))


def _is_float(cell: str) -> bool:
    try:
        float(cell)
        return True
    except (TypeError, ValueError):
        return False


def _parse_csv(path: str, fh) -> list:
    rd = csv.reader(fh)
    header = next(rd, None)
    if header is None:
        return []
    col = {name.strip(): k for k, name in enumerate(header)}
    missing = [f for f in _FIELDS if f not in col]
    if missing:
        # distinguish "wrong columns" from "no header at all": a first
        # row of four numbers is DATA — silently skipping it used to
        # drop one poll per device and shift the inferred t0
        if len(header) >= len(_FIELDS) \
                and all(_is_float(c) for c in header[:len(_FIELDS)]):
            raise ValueError(
                f"trace {path!r} has no header row (first line parses as "
                f"data: {','.join(header)!r}); expected columns "
                f"{','.join(_FIELDS)}")
        raise ValueError(f"trace {path!r} header is missing "
                         f"column(s) {missing}")
    idx = [col[f] for f in _FIELDS]
    need = max(idx) + 1
    recs = []
    for ln, row in enumerate(rd, start=2):
        if not row:
            continue
        if len(row) < need:
            raise ValueError(
                f"trace {path!r} line {ln}: truncated row has "
                f"{len(row)} field(s), header promises >= {need}")
        try:
            recs.append((float(row[idx[0]]), int(row[idx[1]]),
                         float(row[idx[2]]), float(row[idx[3]])))
        except ValueError as e:
            raise ValueError(f"trace {path!r} line {ln}: malformed "
                             f"value in {row!r} ({e})") from None
    return recs


def _parse_jsonl(path: str, fh) -> list:
    recs = []
    for ln, line in enumerate(fh, start=1):
        if not line.strip():
            continue
        try:
            r = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"trace {path!r} line {ln}: invalid JSON "
                             f"({e})") from None
        if not isinstance(r, dict):
            raise ValueError(
                f"trace {path!r} line {ln}: record is {type(r).__name__}, "
                "expected one JSON object per line (a whole-file JSON "
                "array is not a JSONL trace)")
        missing = [f for f in _FIELDS if f not in r]
        if missing:
            raise ValueError(f"trace {path!r} line {ln}: record is "
                             f"missing key(s) {missing}")
        try:
            recs.append((float(r["t_s"]), int(r["device"]),
                         float(r["tpa"]), float(r["clock_mhz"])))
        except (TypeError, ValueError) as e:
            raise ValueError(f"trace {path!r} line {ln}: malformed "
                             f"value ({e})") from None
    return recs


def read_trace(path: str, *, fmt: str = "auto",
               interval_s: Optional[float] = None) -> DeviceGrid:
    """Load a scrape trace back into an aligned DeviceGrid.

    Row formats require a rectangular trace: every device sampled the
    same number of times (what any fixed-interval scraper produces;
    per-device timestamp jitter is fine — samples align by poll rank).
    The scrape interval is inferred from the poll-instant spacing unless
    given explicitly; a single-poll trace cannot be inferred and needs
    interval_s.  Malformed input (missing/implied header, truncated rows,
    non-object JSONL records, unparseable values) is REJECTED with the
    offending line, never silently mis-parsed.  Columnar archives are
    validated by `tracestore.TraceReader` and carry their own interval.
    """
    fmt = _resolve_fmt(path, fmt)
    if fmt == "columnar":
        return tracestore.read_archive(path, interval_s=interval_s)
    with open(path, newline="") as fh:
        recs = _parse_csv(path, fh) if fmt == "csv" \
            else _parse_jsonl(path, fh)
    if not recs:
        return DeviceGrid(0.0, np.empty((0, 0)), np.empty((0, 0)))
    # align samples by per-device time RANK, not exact timestamp equality:
    # real pollers jitter a few ms between devices, but a fixed-interval
    # scraper still yields one sample per device per poll round
    by_dev: dict = {}
    for t, d, a, c in recs:
        by_dev.setdefault(d, []).append((t, a, c))
    devices = sorted(by_dev)
    counts = {len(by_dev[d]) for d in devices}
    if len(counts) != 1:
        raise ValueError(f"ragged trace {path!r}: devices have differing "
                         f"sample counts {sorted(counts)}")
    for d in devices:
        by_dev[d].sort(key=lambda r: r[0])
    times = np.array([r[0] for r in by_dev[devices[0]]])
    if interval_s is not None:
        interval = float(interval_s)
    elif len(times) > 1:
        interval = float(np.median(np.diff(times)))
    else:
        raise ValueError(
            f"trace {path!r} has a single poll instant; the scrape "
            "interval cannot be inferred — pass interval_s explicitly")
    tpa = np.array([[r[1] for r in by_dev[d]] for d in devices])
    clk = np.array([[r[2] for r in by_dev[d]] for d in devices])
    # preserve the recorded clock: a mid-run trace (first poll at t≫0)
    # must land in the rollup buckets of the times it was captured at
    return DeviceGrid(interval, tpa, clk, t0_s=float(times[0]) - interval)
