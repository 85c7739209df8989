"""The transport seam: how a counter backend reaches real hardware.

A `FieldTransport` answers exactly one question — "what are these DCGM
field values for this GPU right now" — and owns nothing else: no
retry, no staleness policy, no window enforcement (those live in
`DcgmFieldBackend`, identically for every transport).  That keeps the
hardware surface small enough to fake deterministically
(`fake.FakeDcgmTransport`) and to swap between `dcgmi` subprocess and
NVML bindings without touching the pipeline.

Transports signal EVERY failure mode as `TransportError` — a dead
daemon, an unparsable snapshot, a missing GPU — so the backend has one
thing to catch and one recovery path (close → backoff → connect).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

#: the two DCGM field ids OFU consumes (paper §IV) — SM clock is an
#: instantaneous point sample, tensor-pipe activity a hardware average
#: over at most `MAX_HW_AVG_WINDOW_S`.  The ids are DCGM's own
#: (`dcgm_fields.h`): 1004 is DCGM_FI_PROF_PIPE_TENSOR_ACTIVE; 1002 is
#: DCGM_FI_PROF_SM_ACTIVE, the SM activity the paper's §IV warns against
#: reading as tensor activity.
DCGM_FI_DEV_SM_CLOCK = 100
DCGM_FI_PROF_PIPE_TENSOR_ACTIVE = 1004


class TransportError(RuntimeError):
    """Any transport-level failure (daemon down, parse failure, missing
    device/field).  The backend's retry/reconnect loop catches exactly
    this."""


@dataclass(frozen=True)
class FieldSample:
    """One field reading: the value plus the TRANSPORT's timestamp for
    it (monotonic seconds; the staleness detector compares successive
    timestamps per field, so the epoch does not matter)."""

    value: float
    t_s: float


class FieldTransport:
    """Interface a DCGM-shaped transport implements.

    Lifecycle: `connect()` may be called repeatedly (it is the
    reconnect path), `close()` is always safe.  `read()` must either
    return a sample for EVERY requested field id or raise
    `TransportError` — partial snapshots are a transport failure, not a
    backend policy decision.
    """

    def connect(self) -> None:
        """Establish (or re-establish) the underlying channel."""

    def close(self) -> None:
        """Tear the channel down (idempotent)."""

    @property
    def n_devices(self) -> int:
        """Devices visible through this transport."""
        raise NotImplementedError

    def read(self, gpu: int,
             field_ids: Sequence[int]) -> Dict[int, FieldSample]:
        """Current samples for `field_ids` on device `gpu`."""
        raise NotImplementedError

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ResilientBackendMixin:
    """Shared resilience policy for backends polling a transport: retry
    with exponential backoff and reconnect-between-attempts, plus
    per-field staleness tracking.

    Identical for DCGM and TPU backends by design — the recovery story
    ("close, back off, connect, re-read") is a property of polling a
    flaky channel, not of any particular hardware.  Subclasses call
    `_with_retries(fn)` around their read closure and `_note_freshness`
    per field inside it; `sleep` is injectable so tests exercise the
    backoff schedule without waiting it out.
    """

    def _init_resilience(self, transport: FieldTransport, *,
                         max_retries: int = 3, backoff_s: float = 0.05,
                         backoff_mult: float = 2.0,
                         max_stale_polls: int = 3, sleep=None) -> None:
        import time
        self.transport = transport
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_mult = float(backoff_mult)
        self.max_stale_polls = int(max_stale_polls)
        self._sleep = sleep if sleep is not None else time.sleep
        self._started = False
        self._last_error: Exception | None = None
        #: health/ops counters a daemon can export
        self.polls = 0
        self.retries = 0
        self.reconnects = 0
        self.stale_reads = 0
        self._last_t: dict = {}      # field key -> newest timestamp seen
        self._stale_streak: dict = {}

    @property
    def healthy(self) -> bool:
        """True once polling has succeeded and the channel is currently
        clean (no unrecovered error, no field past its stale budget)."""
        return (self._started and self._last_error is None
                and all(s <= self.max_stale_polls
                        for s in self._stale_streak.values()))

    def _ensure_connected(self) -> None:
        if not self._started:
            self.transport.connect()
            self._started = True

    def _note_freshness(self, key, t_s: float) -> None:
        """Track per-field timestamps; a field whose timestamp stops
        advancing is stale.  A handful of stale polls is tolerated (the
        value is simply reused — DCGM legitimately repeats a sample
        when polled faster than its update cadence); a streak past
        `max_stale_polls` means the channel is wedged and escalates to
        the reconnect path."""
        last = self._last_t.get(key)
        if last is not None and t_s <= last:
            self.stale_reads += 1
            streak = self._stale_streak.get(key, 0) + 1
            self._stale_streak[key] = streak
            if streak > self.max_stale_polls:
                raise TransportError(
                    f"field {key} has been stale for {streak} consecutive "
                    f"polls (timestamp stuck at {last:.3f}s)")
        else:
            self._stale_streak[key] = 0
            self._last_t[key] = t_s

    def _with_retries(self, fn):
        """Run `fn` (a transport read closure), recovering from
        `TransportError` by close → backoff → connect, up to
        `max_retries` times."""
        delay = self.backoff_s
        last: Exception | None = None
        for attempt in range(self.max_retries + 1):
            try:
                self._ensure_connected()
                out = fn()
                self._last_error = None
                return out
            except TransportError as e:
                last = e
                self._last_error = e
                if attempt == self.max_retries:
                    break
                self.retries += 1
                try:
                    self.transport.close()
                except Exception:
                    pass
                self._started = False
                self._sleep(delay)
                delay *= self.backoff_mult
                self.reconnects += 1
        raise TransportError(
            f"{type(self).__name__} gave up after {self.max_retries} "
            f"reconnect attempts: {last}")
