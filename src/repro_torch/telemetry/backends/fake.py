"""Deterministic engine-driven transport: the stand-in for DCGM on a
machine whose counters are simulated.

`FakeDcgmTransport` speaks the exact `FieldTransport` protocol the real
transports speak, but its field values come from the simulator engine —
and crucially it chunk-seeds IDENTICALLY to `SimulatorSource` (same
internal source, same poll cadence), so a live pipeline polled through
FakeDcgmTransport → `DcgmFieldBackend` → `BackendSource` produces
bit-identical samples to `SimulatorSource` on the same seed.  That is
what lets a self-check assert the whole acquisition tier end-to-end:
rollup buckets from the "live" path must equal the simulation path's,
bucket for bucket.  The engine's chunks are float32 tensors on
`device` (the card when None); each is copied to host float64 once, so
the backends read plain floats and the live grid is host NumPy.

Failure injection (`fail_every`) raises a `TransportError` on a
deterministic schedule WITHOUT consuming the sample, so the backend's
retry/reconnect loop can be exercised in tests and the recovered stream
still matches the clean one exactly.

`quantize=True` serves DCGM-wire precision (tensor activity rounded to
3 decimals, clock to whole MHz — what `dcgmi`/NVML actually deliver)
instead of full-precision engine floats; the codec benchmarks record
against that fixture because it is what a live recorder stores.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.telemetry.backends.transport import (
    DCGM_FI_DEV_SM_CLOCK, DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, FieldSample,
    FieldTransport, TransportError,
)
from repro_torch.telemetry.counters import Event, StepProfile

_KNOWN_FIELDS = (DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, DCGM_FI_DEV_SM_CLOCK)


def quantize_wire(tpa: np.ndarray,
                  clock_mhz: np.ndarray) -> tuple:
    """Round counters to DCGM wire precision: activity at 3 decimals,
    clock in whole MHz (NVML reports an integer)."""
    return np.round(tpa, 3), np.round(clock_mhz, 0)


class FakeDcgmTransport(FieldTransport):
    """`FieldTransport` over the simulator engine, per-GPU cursors.

    `BackendSource` polls device-major (every sample for GPU 0, then
    GPU 1, ...), so each GPU keeps its own cursor into a shared buffer
    of engine chunks; the buffer refills one `chunk_s` engine poll at a
    time and compacts once every cursor has moved past a chunk, keeping
    residency O(chunk) however long the run.  Chunks come from an
    internal `SimulatorSource` with the caller's seed — the identity
    anchor for the live-vs-sim self-check (poll the comparison
    `SimulatorSource` with the same `chunk_s` cadence).
    """

    def __init__(self, profile: StepProfile, *, duration_s: float,
                 interval_s: float, n_devices: int = 1,
                 chunk_s: float = 300.0, chip=None,
                 events: Sequence[Event] = (),
                 stragglers: Optional[np.ndarray] = None, seed: int = 0,
                 quantize: bool = False,
                 fail_every: Optional[int] = None, device=None):
        if not np.isfinite(duration_s):
            raise ValueError("FakeDcgmTransport needs a finite duration_s "
                             "(the engine simulates a bounded run)")
        # the engine sits a layer above telemetry; import here so live
        # deployments importing the backends package never load it
        from repro_torch.core.peaks import DEFAULT_CHIP
        from repro_torch.telemetry.source import SimulatorSource
        self._src = SimulatorSource(
            profile=profile, duration_s=float(duration_s),
            interval_s=float(interval_s), chip=chip or DEFAULT_CHIP,
            events=list(events), stragglers=stragglers,
            n_devices=int(n_devices), seed=int(seed), device=device)
        self.chunk_s = float(chunk_s)
        self.quantize = bool(quantize)
        self.fail_every = fail_every
        self._n = int(n_devices)
        self._connected = False
        self._reads = 0              # includes injected failures
        self._base = 0               # global sample index of buffer[0]
        self._cursor = np.zeros(self._n, dtype=int)
        self._tpa = np.empty((self._n, 0))
        self._clk = np.empty((self._n, 0))
        self._times = np.empty(0)

    # -- FieldTransport -------------------------------------------------
    def connect(self) -> None:
        self._connected = True

    def close(self) -> None:
        self._connected = False

    @property
    def n_devices(self) -> int:
        return self._n

    @property
    def exhausted(self) -> bool:
        """True when the simulated run is fully consumed by every GPU."""
        return self._src.exhausted \
            and int(self._cursor.min()) - self._base >= self._tpa.shape[1]

    def read(self, gpu: int,
             field_ids: Sequence[int]) -> Dict[int, FieldSample]:
        if not self._connected:
            raise TransportError("fake DCGM transport is not connected "
                                 "(call connect() first)")
        if not 0 <= gpu < self._n:
            raise TransportError(f"no such GPU {gpu} "
                                 f"(transport sees {self._n})")
        bad = [f for f in field_ids if f not in _KNOWN_FIELDS]
        if bad:
            raise TransportError(f"unsupported DCGM field ids {bad} "
                                 f"(fake serves {list(_KNOWN_FIELDS)})")
        self._reads += 1
        if self.fail_every and self._reads % self.fail_every == 0:
            # deterministic flakiness: the sample is NOT consumed, so a
            # retried read returns exactly what this one would have
            raise TransportError(
                f"injected fault (read #{self._reads})")
        idx = int(self._cursor[gpu]) - self._base
        while idx >= self._tpa.shape[1]:
            self._refill()
            idx = int(self._cursor[gpu]) - self._base
        tpa, clk = float(self._tpa[gpu, idx]), float(self._clk[gpu, idx])
        if self.quantize:
            tpa, clk = round(tpa, 3), round(clk, 0)
        t_s = float(self._times[idx])
        self._cursor[gpu] += 1
        self._compact()
        return {f: FieldSample(
            tpa if f == DCGM_FI_PROF_PIPE_TENSOR_ACTIVE else clk, t_s)
            for f in field_ids}

    # -- engine feed ----------------------------------------------------
    def _refill(self) -> None:
        grid = self._src.poll(self.chunk_s)
        if grid.tpa.shape[1] == 0:
            raise TransportError(
                f"simulated run exhausted at "
                f"{self._src.cursor_s:g}s / {self._src.duration_s:g}s")
        # one host copy a chunk, not one device read a sample
        tpa = grid.tpa.cpu().numpy().astype(np.float64)
        clk = grid.clock_mhz.cpu().numpy().astype(np.float64)
        self._tpa = np.concatenate([self._tpa, tpa], axis=1)
        self._clk = np.concatenate([self._clk, clk], axis=1)
        self._times = np.concatenate([self._times, grid.times_s])

    def _compact(self) -> None:
        done = int(self._cursor.min()) - self._base
        if done > 0 and done >= self._tpa.shape[1]:
            # every GPU consumed the whole buffer: drop it outright
            self._base += done
            self._tpa = self._tpa[:, done:]
            self._clk = self._clk[:, done:]
            self._times = self._times[done:]

