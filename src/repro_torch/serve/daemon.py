"""`ServiceDaemon`: the wall-clock deployment mode of the collector.

`Collector.poll_round()` advances *simulated* time; a deployed daemon
(paper §VI — the thing that watched the fleet live) needs the missing
operational half, and this module is it:

  * REAL PACING — rounds fire on a wall-clock cadence with drift
    correction: the k-th round's deadline is `origin + k·round_s`, so a
    slow round eats its own slack instead of shifting every later round
    (an overrun skips the sleep and is counted, never "caught up" by
    polling faster).  The clock and sleep are injectable (`SimClock`)
    so tests and self-checks run the same loop in microseconds.
  * PUBLISHING — after every round the collector's state is published
    into a `FleetStore` generation, which `repro_torch.serve.http` serves to
    dashboard pollers.
  * STREAM CHURN — `request_add_stream` / `request_remove_stream` queue
    changes from any thread; the daemon applies them between rounds, so
    jobs join and leave a live fleet without a restart.
  * PERSISTENCE — every `persist_every` rounds the windowed rollup,
    collector clock, per-stream cursors, alert history, and open
    alert-episode hysteresis are written atomically to `state_dir`;
    `ServiceDaemon.restore()` rebuilds the daemon after a process
    restart, replay sources `seek()` back to their cursors, and an
    episode that was open at the last persist does NOT re-page.
  * RECORDING TEE — with `tee_dir` set, every polled grid also appends
    to a per-job columnar `TraceWriter` (`<tee_dir>/<job_id>.ctr`),
    via the collector's `on_grid` round hook.  Tee manifests flush at
    every persistence point, so a kill -9 leaves REPLAYABLE archives
    covering everything up to the last persist; on restore the tee
    reopens in append mode and skips any overlap a mid-flight chunk
    flush already archived.  Archives are uniform-cadence, so the tee
    cannot be combined with adaptive retiming (rejected up front).

Clean shutdown is `close()` (or the context manager): final persist,
tee flush, writer close.  A crash skips all of that by definition —
which is exactly what the persistence points are for.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import torch

from repro_torch.fleet.collector import (Collector, FleetCollector,
                                         _require_bounded)
from repro_torch.fleet.streaming import StreamingRollup
from repro_torch.serve.store import FleetStore
from repro_torch.telemetry import tracestore
from repro_torch.telemetry.scrape import DeviceGrid
from repro_torch.telemetry.tracestore import TraceWriter

STATE_NAME = "daemon_state.json"
ROLLUP_NAME = "rollup.snapshot"
STATE_FORMAT = "fleet-serve-state-v1"


def _host(x):
    """Counter columns as host NumPy: archives are NumPy files, so a
    tensor slice (a card-resident grid) is copied to the host here, the
    one place the tee writes it."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class SimClock:
    """Deterministic (clock, sleep) pair for tests and self-checks:
    `sleep()` advances the clock instantly and records the request, so a
    paced daemon run finishes in microseconds while exercising the exact
    deadline arithmetic a real deployment uses."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)
        self.sleeps: list = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"sleep({dt}) is negative")
        self.sleeps.append(float(dt))
        self.t += dt

    def advance(self, dt: float) -> None:
        """Model work taking `dt` seconds of wall time."""
        self.t += float(dt)


class ServiceDaemon:
    """Runs a `Collector` (or `FleetCollector`) on a wall-clock cadence,
    publishing every round into a `FleetStore`.

    Persistence and the recording tee require a plain `Collector` (a
    `FleetCollector`'s per-host state lives with its hosts); serving and
    pacing work for both.
    """

    def __init__(self, collector, *, store: Optional[FleetStore] = None,
                 state_dir: Optional[str] = None, persist_every: int = 0,
                 tee_dir: Optional[str] = None,
                 tee_chunk_samples: int = 1024,
                 clock=time.monotonic, sleep=None, pace: bool = True,
                 on_round=None):
        """`clock`/`sleep` inject a time source (see `SimClock`).  The
        default real-clock sleep waits on the stop event, so `stop()`
        (e.g. wired to SIGTERM) interrupts an inter-round sleep
        immediately instead of after up to `round_s` seconds.

        on_round: optional callback invoked with each round's report
        AFTER that round's store generation is published (and persisted,
        when due) but before pacing — the synchronization point for
        anything downstream of the publish: tests gate round advancement
        on pollers having observed the new generation (a SimClock-paced
        run costs no wall time, so free-running readers would otherwise
        race the whole run), deployments emit per-round metrics.  May be
        reassigned on a live daemon; takes effect next round."""
        if persist_every < 0:
            raise ValueError(f"persist_every={persist_every} must be >= 0")
        if persist_every and not state_dir:
            raise ValueError("persist_every needs a state_dir")
        is_fleet = isinstance(collector, FleetCollector)
        if is_fleet and (state_dir or tee_dir):
            raise ValueError(
                "snapshot persistence and the recording tee need a plain "
                "Collector; a FleetCollector's state lives with its hosts")
        self.collector = collector
        self.store = store if store is not None else FleetStore()
        self.state_dir = state_dir
        self.persist_every = int(persist_every)
        self.tee_dir = tee_dir
        self.tee_chunk_samples = int(tee_chunk_samples)
        self._clock = clock
        self._sleep = sleep
        self.pace = bool(pace)
        self.on_round = on_round
        self._is_fleet = is_fleet
        self._churn_lock = threading.Lock()
        self._churn: list = []
        self._stop = threading.Event()
        self._writers: dict = {}       # job_id -> TraceWriter
        self._closed = False
        self.rounds = 0                # rounds THIS process has run
        self.overruns = 0              # rounds that blew their deadline
        if tee_dir:
            if collector.on_grid is not None:
                raise ValueError("collector already has an on_grid hook; "
                                 "the tee needs it")
            if collector.config.adaptive is not None:
                # archives are uniform-cadence: the first retiming would
                # make the next grid unappendable and crash the loop —
                # reject the combination up front instead
                raise ValueError(
                    "recording tee and adaptive scrape retiming cannot "
                    "be combined: a retimed source changes interval "
                    "mid-archive; record with fixed intervals (drop "
                    "CollectorConfig.adaptive) or drop tee_dir")
            os.makedirs(tee_dir, exist_ok=True)
            collector.on_grid = self._tee
        # publish generation 1 up front so the HTTP API answers (with
        # whatever restored/empty state we have) before the first round
        self.store.update_from(collector)

    # -- cadence --------------------------------------------------------
    @property
    def round_s(self) -> float:
        if self._is_fleet:
            return max(c.config.round_s for c in self.collector.collectors)
        return self.collector.config.round_s

    @property
    def done(self) -> bool:
        return self.collector.done

    # -- stream churn ---------------------------------------------------
    def request_add_stream(self, stream) -> None:
        """Queue a stream to join before the next round (thread-safe)."""
        self._require_plain("stream churn")
        with self._churn_lock:
            self._churn.append(("add", stream))

    def request_remove_stream(self, job_id: str) -> None:
        """Queue a stream to leave before the next round (thread-safe)."""
        self._require_plain("stream churn")
        with self._churn_lock:
            self._churn.append(("remove", job_id))

    def _apply_churn(self) -> None:
        with self._churn_lock:
            ops, self._churn = self._churn, []
        for op, arg in ops:
            if op == "add":
                self.collector.add_stream(arg)
            else:
                st = self.collector.remove_stream(arg)
                w = self._writers.pop(st.job_id, None)
                if w is not None:
                    w.close()

    def _require_plain(self, what: str) -> None:
        if self._is_fleet:
            raise ValueError(f"{what} needs a plain Collector "
                             "(FleetCollector hosts own their streams)")

    # -- recording tee --------------------------------------------------
    def _tee(self, stream, grid) -> None:
        w = self._writers.get(stream.job_id)
        if w is None:
            path = os.path.join(self.tee_dir, f"{stream.job_id}.ctr")
            if tracestore.is_archive(path):
                # restart: continue the pre-crash archive.  Anything a
                # mid-flight chunk flush already persisted beyond the
                # restored cursor will be re-polled by the resumed
                # deterministic replay — skip the overlap, don't re-append
                w = TraceWriter(path, grid.interval_s, grid.n_devices,
                                chunk_samples=self.tee_chunk_samples,
                                append=True)
            else:
                w = TraceWriter(path, grid.interval_s, grid.n_devices,
                                chunk_samples=self.tee_chunk_samples,
                                t0_s=grid.t0_s)
            self._writers[stream.job_id] = w
        overlap_s = w.end_s - grid.t0_s
        if w.total_samples and overlap_s > 1e-6 * w.interval_s:
            skip = int(round(overlap_s / w.interval_s))
            if skip >= grid.tpa.shape[1]:
                return                      # whole grid already archived
            w.append(_host(grid.tpa[:, skip:]),
                     _host(grid.clock_mhz[:, skip:]))
        else:
            w.append_grid(DeviceGrid(grid.interval_s, _host(grid.tpa),
                                     _host(grid.clock_mhz), t0_s=grid.t0_s))

    # -- persistence ----------------------------------------------------
    def persist(self) -> None:
        """Atomically write restart state; also the tee crash-safety
        point (every writer's manifest flushes here, buffered tail
        included)."""
        self._require_plain("snapshot persistence")
        if not self.state_dir:
            raise ValueError("no state_dir configured")
        os.makedirs(self.state_dir, exist_ok=True)
        for w in self._writers.values():
            w.flush(partial=True)
        blob = self.collector.snapshot()
        roll_path = os.path.join(self.state_dir, ROLLUP_NAME)
        tmp = roll_path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, roll_path)
        state = {
            "format": STATE_FORMAT,
            "round_idx": self.collector.round_idx,
            "clock_s": self.collector.clock_s,
            "cursors": {st.job_id: st.source.cursor_s
                        for st in self.collector.streams},
            "rollup_file": ROLLUP_NAME,
            "alerts": self.collector.alert_state(),
        }
        # rollup first, manifest last: state.json always points at a
        # complete snapshot, whatever instant the process dies
        tmp = os.path.join(self.state_dir, STATE_NAME + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(state, fh, indent=1)
            fh.write("\n")
        os.replace(tmp, os.path.join(self.state_dir, STATE_NAME))

    @classmethod
    def restore(cls, state_dir: str, streams, config=None,
                **daemon_kw) -> "ServiceDaemon":
        """Rebuild a daemon from `persist()` output: restored windowed
        rollup + collector clock/round, and every stream whose persisted
        cursor is nonzero `seek()`ed back to it.  Pass fresh `streams`
        (same job_ids) and the same `CollectorConfig`.  The alert log
        and open-episode hysteresis restore too: the resumed collector
        remembers every alert it already fired, and a collapse that was
        being tracked at persist time refreshes its episode silently
        instead of paging a duplicate on the first post-restart round.
        (State persisted by a pre-alert-state daemon restores with an
        empty log — the old re-fire-once behavior.)"""
        mf = os.path.join(state_dir, STATE_NAME)
        if not os.path.isfile(mf):
            raise ValueError(f"{state_dir!r} holds no daemon state "
                             f"(no {STATE_NAME})")
        with open(mf) as fh:
            state = json.load(fh)
        if state.get("format") != STATE_FORMAT:
            raise ValueError(f"unknown daemon state format "
                             f"{state.get('format')!r} in {state_dir!r}")
        with open(os.path.join(state_dir,
                               state.get("rollup_file", ROLLUP_NAME)),
                  "rb") as fh:
            roll = StreamingRollup.from_bytes(fh.read())
        cursors = state.get("cursors", {})
        unseekable = []
        for st in streams:
            cur = float(cursors.get(st.job_id, 0.0))
            if cur <= 0.0:
                continue
            if hasattr(st.source, "seek"):
                st.source.seek(cur)
            else:
                unseekable.append(st.job_id)
        if unseekable:
            raise ValueError(
                f"streams {unseekable} had nonzero persisted cursors but "
                "their sources cannot seek(); a mid-stream restore needs "
                "replayable sources")
        col = Collector(streams, config, rollup=roll,
                        clock_s=float(state["clock_s"]),
                        round_idx=int(state["round_idx"]))
        col.restore_alert_state(state.get("alerts", {}))
        daemon_kw.setdefault("state_dir", state_dir)
        return cls(col, **daemon_kw)

    # -- the loop -------------------------------------------------------
    def stop(self) -> None:
        """Ask a running `run()` loop (any thread) to exit: interrupts a
        default-clock pacing sleep immediately, then exits after the
        round in flight — wire this to SIGTERM for clean shutdown."""
        self._stop.set()

    def run(self, n_rounds: Optional[int] = None) -> list:
        """Paced round loop; returns the collected round reports.

        Exits when every stream is exhausted, `n_rounds` rounds have
        run, or `stop()` is called.  Does NOT close the daemon — the
        tee's buffered tail and a final persist happen in `close()`
        (or at the next persistence point), so a crash-kill test can
        observe exactly the crash-safe on-disk state.
        """
        if self._closed:
            raise ValueError("ServiceDaemon is closed")
        if n_rounds is None:
            streams = (self.collector.streams if not self._is_fleet else
                       [st for c in self.collector.collectors
                        for st in c.streams])
            _require_bounded(streams)
        self._stop.clear()
        origin = self._clock()
        start_round = self.rounds
        reports = []
        while not self._stop.is_set() \
                and (n_rounds is None or len(reports) < n_rounds):
            self._apply_churn()
            if self.collector.done:
                break
            reports.append(self.collector.poll_round())
            self.rounds += 1
            self.store.update_from(self.collector)
            if self.persist_every \
                    and self.rounds % self.persist_every == 0:
                self.persist()
            if self.on_round is not None:
                self.on_round(reports[-1])
            if self.pace and not self.collector.done:
                deadline = origin \
                    + (self.rounds - start_round) * self.round_s
                now = self._clock()
                if now < deadline - 1e-9:
                    if self._sleep is None:       # real clock: stoppable
                        self._stop.wait(deadline - now)
                    else:
                        self._sleep(deadline - now)
                else:
                    self.overruns += 1
        return reports

    # -- shutdown -------------------------------------------------------
    def close(self) -> None:
        """Clean shutdown: final persist (when configured), tee flush +
        close.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.state_dir and not self._is_fleet:
            self.persist()
        for w in self._writers.values():
            w.close()
        self._writers.clear()

    def __enter__(self) -> "ServiceDaemon":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
