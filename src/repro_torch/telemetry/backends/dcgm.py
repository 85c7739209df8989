"""DCGM-side acquisition: `DcgmFieldBackend` plus the real transports.

`DcgmFieldBackend` is a `CounterBackend` — `poll(window_s)` returns the
paper's two signals `(tensor-pipe activity avg, SM clock sample)` — so
N of them under a `BackendSource` make the whole pipeline (collector,
detectors, serve tier) run against live hardware unchanged.  It owns
every policy the transports don't:

  * §IV-C window enforcement via the shared `check_scrape_interval`
    (polling slower than the 30 s hardware averaging window silently
    degrades to average-of-averages; strict mode refuses).
  * Per-field staleness detection: DCGM keeps serving the LAST value
    when a channel wedges — the value looks plausible, only the
    timestamp betrays it.  A few repeats are tolerated (fast polls
    legitimately straddle an update), a streak escalates.
  * Reconnect-with-backoff around every read, so one dropped `nv-hostengine`
    doesn't take down the recorder.

Transports:

  * `DcgmiTransport` — one `dcgmi dmon -e <fields> -c 1` subprocess
    snapshot per poll ROUND (all GPUs in one invocation; per-GPU reads
    consume from the snapshot and the next round's first read refreshes
    it).  The text parser (`parse_dmon`) is a standalone function so CI
    tests feed it captured output without the binary.
  * `PynvmlTransport` — NVML bindings when the `pynvml` module is
    installed (gated import; clear `TransportError` otherwise).
    SM clock maps to `nvmlDeviceGetClockInfo(NVML_CLOCK_SM)`; tensor
    activity to the profiling field when the driver exposes it, else
    NVML's GPM tensor metric, else documented fallback to coarse GPU
    utilization, and the transport records which (`tpa_source`).
"""
from __future__ import annotations

import shutil
import subprocess
import time
from typing import Dict, Optional, Sequence

from repro_torch.telemetry.backends.transport import (
    DCGM_FI_DEV_SM_CLOCK, DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, FieldSample,
    FieldTransport, ResilientBackendMixin, TransportError,
)
from repro_torch.telemetry.counters import CounterBackend, check_scrape_interval

#: tensor activity arrives in [0, 1]; SM clock in MHz.  Readings outside
#: sane bounds are transport corruption, not data.
_TPA_RANGE = (0.0, 1.0)
_CLK_RANGE_MHZ = (0.0, 10_000.0)


class DcgmFieldBackend(ResilientBackendMixin, CounterBackend):
    """Polls PIPE_TENSOR_ACTIVE + SM_CLOCK for one GPU through any
    `FieldTransport`.

    One backend per device, all sharing one transport — the shape
    `BackendSource` expects.  The first poll connects lazily (a
    constructor that probes hardware would make fleet wiring fragile);
    `healthy` plus the `polls/retries/reconnects/stale_reads` counters
    are the health-check surface a daemon exports.
    """

    def __init__(self, gpu: int, transport: FieldTransport, *,
                 strict: bool = True, max_retries: int = 3,
                 backoff_s: float = 0.05, backoff_mult: float = 2.0,
                 max_stale_polls: int = 3, sleep=None):
        self.gpu = int(gpu)
        self.strict = bool(strict)
        self._init_resilience(transport, max_retries=max_retries,
                              backoff_s=backoff_s,
                              backoff_mult=backoff_mult,
                              max_stale_polls=max_stale_polls, sleep=sleep)

    def _read_once(self) -> Dict[int, FieldSample]:
        fields = (DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, DCGM_FI_DEV_SM_CLOCK)
        samples = self.transport.read(self.gpu, fields)
        missing = [f for f in fields if f not in samples]
        if missing:
            raise TransportError(
                f"transport returned no sample for field(s) {missing} "
                f"on GPU {self.gpu}")
        tpa = samples[DCGM_FI_PROF_PIPE_TENSOR_ACTIVE]
        clk = samples[DCGM_FI_DEV_SM_CLOCK]
        if not _TPA_RANGE[0] <= tpa.value <= _TPA_RANGE[1]:
            raise TransportError(
                f"tensor activity {tpa.value!r} outside {_TPA_RANGE} "
                f"on GPU {self.gpu}")
        if not _CLK_RANGE_MHZ[0] <= clk.value <= _CLK_RANGE_MHZ[1]:
            raise TransportError(
                f"SM clock {clk.value!r} MHz outside sane range "
                f"on GPU {self.gpu}")
        self._note_freshness(("tpa", self.gpu), tpa.t_s)
        self._note_freshness(("clk", self.gpu), clk.t_s)
        return samples

    # -- CounterBackend -------------------------------------------------
    def poll(self, window_s: float) -> tuple:
        """(hardware-averaged tensor activity, instantaneous SM clock)
        for the next window, enforcing §IV-C on the interval."""
        check_scrape_interval(window_s, strict=self.strict)
        samples = self._with_retries(self._read_once)
        self.polls += 1
        return (samples[DCGM_FI_PROF_PIPE_TENSOR_ACTIVE].value,
                samples[DCGM_FI_DEV_SM_CLOCK].value)


def make_dcgm_backends(transport: FieldTransport,
                       n_devices: Optional[int] = None,
                       **kw) -> list:
    """One `DcgmFieldBackend` per visible device over a shared
    transport — the list `BackendSource(backends=...)` wants."""
    if n_devices is None:
        with_connect = getattr(transport, "_connected", None)
        if with_connect is False:
            transport.connect()
        n_devices = transport.n_devices
    return [DcgmFieldBackend(gpu, transport, **kw)
            for gpu in range(int(n_devices))]


# ---------------------------------------------------------------------------
# dcgmi subprocess transport
# ---------------------------------------------------------------------------
def parse_dmon(text: str, field_ids: Sequence[int]) -> Dict[int, dict]:
    """Parse `dcgmi dmon` tabular output into {gpu: {field_id: value}}.

    Columns map positionally to `field_ids` (the `-e` request order).
    Tolerates the two row shapes dcgmi emits ("GPU 0  ..." and a bare
    leading entity id), skips `#` headers and blank lines, and treats
    `N/A` as a missing field (the backend decides whether that is
    fatal).  Unparsable rows raise `TransportError` — a half-garbled
    snapshot must not pass as data.
    """
    out: Dict[int, dict] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if toks[0].upper() in ("GPU", "TPU", "ENTITY") and len(toks) > 1:
            ent, vals = toks[1], toks[2:]
        else:
            ent, vals = toks[0], toks[1:]
        try:
            gpu = int(ent)
        except ValueError as e:
            raise TransportError(
                f"unparsable dmon row (bad entity id): {line!r}") from e
        if len(vals) < len(field_ids):
            raise TransportError(
                f"dmon row has {len(vals)} values for "
                f"{len(field_ids)} requested fields: {line!r}")
        fields = {}
        for fid, v in zip(field_ids, vals):
            if v.upper() in ("N/A", "NA", "-"):
                continue
            try:
                fields[fid] = float(v)
            except ValueError as e:
                raise TransportError(
                    f"unparsable dmon value {v!r} in row: {line!r}") from e
        out[gpu] = fields
    return out


class DcgmiTransport(FieldTransport):
    """Field transport over the `dcgmi` CLI (no bindings needed —
    present wherever DCGM is installed).

    One `dcgmi dmon -e <fields> -c 1` invocation snapshots EVERY GPU;
    per-GPU `read()`s consume from that snapshot and the first read of
    the next round (a GPU asking twice) refreshes it — so a
    `BackendSource` round costs one subprocess, not one per device.

    `runner` is injectable (a callable `cmd_list -> stdout_str`) so
    tests drive the full parse/snapshot path on captured output without
    the binary; the default runner shells out with a timeout.
    """

    def __init__(self, *, binary: str = "dcgmi",
                 field_ids: Sequence[int] = (
                     DCGM_FI_PROF_PIPE_TENSOR_ACTIVE,
                     DCGM_FI_DEV_SM_CLOCK),
                 timeout_s: float = 10.0, clock=time.monotonic,
                 runner=None):
        self.binary = binary
        self.field_ids = tuple(int(f) for f in field_ids)
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._run = runner if runner is not None else self._run_subprocess
        self._snapshot: Optional[Dict[int, dict]] = None
        self._snapshot_t = 0.0
        self._consumed: set = set()
        self._connected = False

    def _run_subprocess(self, cmd: list) -> str:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=self.timeout_s)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise TransportError(f"{cmd[0]} failed to run: {e}") from e
        if proc.returncode != 0:
            raise TransportError(
                f"{' '.join(cmd)} exited {proc.returncode}: "
                f"{proc.stderr.strip()[:200]}")
        return proc.stdout

    # -- FieldTransport -------------------------------------------------
    def connect(self) -> None:
        """Health check: the binary must exist and answer (the DCGM
        host engine being down surfaces here, not mid-recording)."""
        if shutil.which(self.binary) is None and self._run \
                == self._run_subprocess:
            raise TransportError(
                f"{self.binary!r} not found on PATH — is DCGM installed? "
                "(use --transport fake for hardware-less runs)")
        self._run([self.binary, "--version"])
        self._connected = True
        self._snapshot = None
        self._consumed = set()

    def close(self) -> None:
        self._connected = False
        self._snapshot = None

    def _refresh(self) -> None:
        cmd = [self.binary, "dmon",
               "-e", ",".join(str(f) for f in self.field_ids), "-c", "1"]
        snap = parse_dmon(self._run(cmd), self.field_ids)
        if not snap:
            raise TransportError(f"{' '.join(cmd)} returned no GPU rows")
        self._snapshot = snap
        self._snapshot_t = float(self._clock())
        self._consumed = set()

    @property
    def n_devices(self) -> int:
        if self._snapshot is None:
            self._refresh()
        return len(self._snapshot)

    def read(self, gpu: int,
             field_ids: Sequence[int]) -> Dict[int, FieldSample]:
        if not self._connected:
            raise TransportError("dcgmi transport is not connected")
        if self._snapshot is None or gpu in self._consumed:
            self._refresh()
        row = self._snapshot.get(gpu)
        if row is None:
            raise TransportError(
                f"GPU {gpu} absent from dmon snapshot "
                f"(saw {sorted(self._snapshot)})")
        self._consumed.add(gpu)
        out = {}
        for f in field_ids:
            if f not in row:
                raise TransportError(
                    f"field {f} is N/A for GPU {gpu} (profiling fields "
                    "need a profiling-capable driver/DCGM)")
            value = row[f]
            if f == DCGM_FI_PROF_PIPE_TENSOR_ACTIVE and value > 1.0:
                value /= 100.0       # some dcgmi builds report percent
            out[f] = FieldSample(value, self._snapshot_t)
        return out


# ---------------------------------------------------------------------------
# NVML bindings transport
# ---------------------------------------------------------------------------
class PynvmlTransport(FieldTransport):
    """Field transport over the `pynvml` NVML bindings.

    Gated on the module being importable — `connect()` raises a clear
    `TransportError` otherwise, which `tools/fleet_live.py` turns into
    actionable CLI output.  The SM clock is
    `nvmlDeviceGetClockInfo(NVML_CLOCK_SM)`.  Tensor activity comes from
    the first of these sources that answers on each GPU at `connect()`:

      * ``field``: the bindings' `NVML_FI_PROF_PIPE_TENSOR_ACTIVE`
        through `nvmlDeviceGetFieldValues`, where they define it;
      * ``gpm``: NVML's GPM metric `NVML_GPM_METRIC_ANY_TENSOR_UTIL`,
        NVML's tensor-activity profiling metric, a percentage
        averaged over the interval between two samples (DCGM's window
        semantics): the transport keeps each GPU's last sample, takes
        one at `connect()`, and a read returns the metric / 100 over the
        interval since the previous read;
      * ``utilization``: `nvmlDeviceGetUtilizationRates().gpu` / 100,
        the share of time any kernel ran — coarse "GPU busy", NOT tensor
        activity (the paper's §IV point about why PIPE_TENSOR_ACTIVE is
        the right field).

    `tpa_sources` holds each GPU's source, `tpa_source` their one name
    (names joined by "," if the GPUs differ), and `refused` why each
    source above it did not answer.  Every NVML error raises
    `TransportError`.
    """

    def __init__(self, *, clock=time.monotonic):
        self._clock = clock
        self._nv = None
        self._handles: list = []
        self.tpa_sources: list = []
        self.refused: dict = {}
        self._gpm_prev: dict = {}        # gpu -> its last GPM sample

    def connect(self) -> None:
        try:
            import pynvml
        except ImportError as e:
            raise TransportError(
                "the 'pynvml' module is not installed; install "
                "nvidia-ml-py or use --transport dcgmi/fake") from e
        self.close()
        try:
            pynvml.nvmlInit()
            count = pynvml.nvmlDeviceGetCount()
            self._handles = [pynvml.nvmlDeviceGetHandleByIndex(i)
                             for i in range(count)]
        except pynvml.NVMLError as e:
            raise TransportError(f"NVML init failed: {e}") from e
        self._nv = pynvml
        self.refused = {}
        self.tpa_sources = [self._pick_source(gpu)
                            for gpu in range(len(self._handles))]

    def _pick_source(self, gpu: int) -> str:
        """The first tensor-activity source that answers on `gpu` (a GPM
        source keeps the sample it took)."""
        nv, h = self._nv, self._handles[gpu]
        fid = getattr(nv, "NVML_FI_PROF_PIPE_TENSOR_ACTIVE", None)
        if fid is None:
            self.refused["field"] = ("the bindings define no "
                                     "NVML_FI_PROF_PIPE_TENSOR_ACTIVE")
        else:
            try:
                self._field(h, fid)
                return "field"
            except (nv.NVMLError, TransportError) as e:
                self.refused["field"] = f"{type(e).__name__}: {e}"
        if not hasattr(nv, "nvmlGpmSampleGet"):
            self.refused["gpm"] = "the bindings have no GPM functions"
            return "utilization"
        try:
            if not nv.nvmlGpmQueryDeviceSupport(h).isSupportedDevice:
                self.refused["gpm"] = "nvmlGpmQueryDeviceSupport: " \
                    "not a GPM device"
                return "utilization"
            self._gpm_prev[gpu] = self._gpm_sample(h)
            return "gpm"
        except nv.NVMLError as e:
            self.refused["gpm"] = f"{type(e).__name__}: {e}"
            return "utilization"

    @property
    def tpa_source(self) -> str:
        """Where tensor activity is read: "field", "gpm" or
        "utilization", or the GPUs' sources joined by "," where they
        differ."""
        return ",".join(sorted(set(self.tpa_sources)))

    def _field(self, h, fid) -> float:
        (val,) = self._nv.nvmlDeviceGetFieldValues(h, [fid])
        if val.nvmlReturn != 0:
            raise TransportError(f"NVML field {fid} returned "
                                 f"{val.nvmlReturn}")
        return float(val.value.dVal)

    def _gpm_sample(self, h):
        nv = self._nv
        sample = nv.nvmlGpmSampleAlloc()
        try:
            nv.nvmlGpmSampleGet(h, sample)
        except nv.NVMLError:
            nv.nvmlGpmSampleFree(sample)
            raise
        return sample

    def _gpm_tensor_util(self, gpu: int, h) -> float:
        """ANY_TENSOR_UTIL / 100 over the interval since `gpu`'s last
        sample, which this read's sample replaces."""
        nv = self._nv
        sample = self._gpm_sample(h)
        prev, self._gpm_prev[gpu] = self._gpm_prev[gpu], sample
        try:
            get = nv.c_nvmlGpmMetricsGet_t()
            get.version = nv.NVML_GPM_METRICS_GET_VERSION
            get.numMetrics = 1
            get.sample1, get.sample2 = prev, sample
            get.metrics[0].metricId = nv.NVML_GPM_METRIC_ANY_TENSOR_UTIL
            nv.nvmlGpmMetricsGet(get)
        finally:
            nv.nvmlGpmSampleFree(prev)
        metric = get.metrics[0]
        if metric.nvmlReturn != 0:
            raise TransportError(f"NVML GPM tensor metric returned "
                                 f"{metric.nvmlReturn}")
        return float(metric.value) / 100.0

    def close(self) -> None:
        nv, self._nv = self._nv, None
        if nv is not None:
            for sample in self._gpm_prev.values():
                try:
                    nv.nvmlGpmSampleFree(sample)
                except nv.NVMLError:
                    pass
            try:
                nv.nvmlShutdown()
            except nv.NVMLError:
                pass
        self._gpm_prev = {}
        self._handles = []

    @property
    def n_devices(self) -> int:
        return len(self._handles)

    def read(self, gpu: int,
             field_ids: Sequence[int]) -> Dict[int, FieldSample]:
        nv = self._nv
        if nv is None:
            raise TransportError("pynvml transport is not connected")
        if not 0 <= gpu < len(self._handles):
            raise TransportError(f"no such GPU {gpu} "
                                 f"(NVML sees {len(self._handles)})")
        h = self._handles[gpu]
        t_s = float(self._clock())
        out = {}
        try:
            for f in field_ids:
                if f == DCGM_FI_DEV_SM_CLOCK:
                    value = float(nv.nvmlDeviceGetClockInfo(
                        h, nv.NVML_CLOCK_SM))
                elif f == DCGM_FI_PROF_PIPE_TENSOR_ACTIVE:
                    src = self.tpa_sources[gpu]
                    if src == "field":
                        value = self._field(
                            h, nv.NVML_FI_PROF_PIPE_TENSOR_ACTIVE)
                    elif src == "gpm":
                        value = self._gpm_tensor_util(gpu, h)
                    else:
                        value = float(
                            nv.nvmlDeviceGetUtilizationRates(h).gpu) / 100.0
                else:
                    raise TransportError(
                        f"unsupported field id {f} for NVML transport")
                out[f] = FieldSample(value, t_s)
        except nv.NVMLError as e:
            raise TransportError(f"NVML read failed on GPU {gpu}: "
                                 f"{e}") from e
        return out
