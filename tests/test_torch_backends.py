"""The port's acquisition tier (`repro_torch.telemetry.backends`: the
transport seam, `DcgmFieldBackend`, the `dcgmi`/NVML transports and the
engine-driven `FakeDcgmTransport`) against the JAX package's.

The CPU half of the reference's `test_backends.py` (its TPU cases stay
with the reference: the port has no libtpu backend) and of
`test_codecs.py`'s `dbz` case over `quantize_wire`, run on the port with
the engine on the CPU; then parity cases: the parser and the backend
policy give the reference's answers on the same input, and the live
path (fake transport → backends → `BackendSource` → `Collector` →
`ServiceDaemon` → HTTP) serves exactly what a `GridSource` replay of the
simulator's host-copied chunks serves.  The `gpu` case runs the same
with the engine on the card and holds the card-ingest comparison.
"""
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.telemetry.backends as R_backends  # noqa: E402
from repro_torch.fleet.collector import (Collector, CollectorConfig,  # noqa: E402
                                         JobStream)
from repro_torch.serve import (FleetAPIServer, FleetClient,  # noqa: E402
                               ServiceDaemon, SimClock)
from repro_torch.telemetry import tracestore as ts  # noqa: E402
from repro_torch.telemetry.backends import (  # noqa: E402
    DCGM_FI_DEV_SM_CLOCK, DCGM_FI_PROF_PIPE_TENSOR_ACTIVE,
    DcgmFieldBackend, DcgmiTransport, FieldSample, PynvmlTransport,
    TransportError, make_dcgm_backends, parse_dmon,
)
from repro_torch.telemetry.backends.fake import FakeDcgmTransport  # noqa: E402
from repro_torch.telemetry.backends.fake import quantize_wire  # noqa: E402
from repro_torch.telemetry.counters import Event, StepProfile  # noqa: E402
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402
from repro_torch.telemetry.source import BackendSource  # noqa: E402
from repro_torch.telemetry.source import GridSource  # noqa: E402
from repro_torch.telemetry.source import SimulatorSource as _SimulatorSource  # noqa: E402

PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
TPA, CLK = DCGM_FI_PROF_PIPE_TENSOR_ACTIVE, DCGM_FI_DEV_SM_CLOCK


def SimulatorSource(**kw):
    """The port's source on the CPU (it defaults to the card)."""
    kw.setdefault("device", "cpu")
    return _SimulatorSource(**kw)


def _fake(**kw):
    kw.setdefault("duration_s", 600.0)
    kw.setdefault("interval_s", 30.0)
    kw.setdefault("n_devices", 2)
    kw.setdefault("seed", 3)
    kw.setdefault("device", "cpu")
    t = FakeDcgmTransport(PROFILE, **kw)
    t.connect()
    return t


# ---------------------------------------------------------------------------
# parse_dmon
# ---------------------------------------------------------------------------
DMON = """\
# Entity  TENSO  SMCLK
# Id
GPU 0     0.412  1410
GPU 1     0.000  210
2         0.985  1980

"""


def test_parse_dmon_both_row_shapes_and_headers():
    out = parse_dmon(DMON, (TPA, CLK))
    assert out == {0: {TPA: 0.412, CLK: 1410.0},
                   1: {TPA: 0.0, CLK: 210.0},
                   2: {TPA: 0.985, CLK: 1980.0}}


def test_parse_dmon_na_is_missing_not_zero():
    out = parse_dmon("GPU 0  N/A  1410\n", (TPA, CLK))
    assert out == {0: {CLK: 1410.0}}        # TPA absent, not 0.0


@pytest.mark.parametrize("row", [
    "GPU zero 0.4 1410",            # bad entity id
    "GPU 0 0.4",                    # too few values
    "0 0.4 fast",                   # unparsable value
])
def test_parse_dmon_garbage_raises(row):
    with pytest.raises(TransportError):
        parse_dmon(row, (TPA, CLK))


@pytest.mark.parametrize("text", [DMON, "GPU 0  N/A  1410\n",
                                  "GPU 0  41.2  1410\n", "# nothing\n"])
def test_parse_dmon_equals_the_reference(text):
    assert parse_dmon(text, (TPA, CLK)) \
        == R_backends.parse_dmon(text, (TPA, CLK))


# ---------------------------------------------------------------------------
# DcgmiTransport with an injected runner
# ---------------------------------------------------------------------------
class _Runner:
    """Scripted dcgmi: answers --version, serves dmon snapshots in
    sequence (last one repeats), counts invocations."""

    def __init__(self, snapshots):
        self.snapshots = list(snapshots)
        self.dmon_calls = 0
        self.version_calls = 0

    def __call__(self, cmd):
        if "--version" in cmd:
            self.version_calls += 1
            return "dcgmi version 3.0\n"
        assert cmd[1] == "dmon" and "-e" in cmd
        self.dmon_calls += 1
        k = min(self.dmon_calls - 1, len(self.snapshots) - 1)
        return self.snapshots[k]


def test_dcgmi_snapshot_per_round_batching():
    """One dmon invocation covers every GPU; a GPU reading twice marks
    the new round and refreshes the snapshot."""
    r = _Runner(["GPU 0  0.10  1000\nGPU 1  0.20  1100\n",
                 "GPU 0  0.30  1200\nGPU 1  0.40  1300\n"])
    t = DcgmiTransport(runner=r)
    t.connect()
    assert r.version_calls == 1
    assert t.n_devices == 2 and r.dmon_calls == 1
    s0 = t.read(0, (TPA, CLK))
    s1 = t.read(1, (TPA, CLK))
    assert r.dmon_calls == 1                 # same snapshot served both
    assert s0[TPA].value == 0.10 and s1[TPA].value == 0.20
    assert t.read(0, (TPA, CLK))[TPA].value == 0.30   # round 2 refresh
    assert r.dmon_calls == 2
    assert t.read(1, (TPA, CLK))[CLK].value == 1300.0
    assert r.dmon_calls == 2


def test_dcgmi_percent_scale_and_error_paths():
    r = _Runner(["GPU 0  41.2  1410\n"])     # percent-reporting build
    t = DcgmiTransport(runner=r)
    t.connect()
    assert t.read(0, (TPA, CLK))[TPA].value == pytest.approx(0.412)
    with pytest.raises(TransportError, match="absent from dmon"):
        t.read(7, (TPA, CLK))
    t.close()
    with pytest.raises(TransportError, match="not connected"):
        t.read(0, (TPA, CLK))
    t2 = DcgmiTransport(runner=_Runner(["GPU 0  N/A  1410\n"]))
    t2.connect()
    with pytest.raises(TransportError, match="N/A for GPU 0"):
        t2.read(0, (TPA, CLK))
    t3 = DcgmiTransport(runner=_Runner(["# nothing\n"]))
    t3.connect()
    with pytest.raises(TransportError, match="no GPU rows"):
        t3.read(0, (TPA, CLK))


def test_dcgmi_connect_requires_binary_on_path():
    t = DcgmiTransport(binary="definitely-not-a-real-dcgmi-binary")
    with pytest.raises(TransportError, match="not found on PATH"):
        t.connect()


def test_pynvml_connect_is_gated_on_module():
    try:
        import pynvml  # noqa: F401
        pytest.skip("pynvml installed; gating path not reachable")
    except ImportError:
        pass
    with pytest.raises(TransportError, match="pynvml"):
        PynvmlTransport().connect()


def test_tensor_active_is_dcgms_field_1004_in_the_dmon_request():
    """`dcgm_fields.h`: DCGM_FI_PROF_PIPE_TENSOR_ACTIVE is 1004 (1002 is
    DCGM_FI_PROF_SM_ACTIVE); `dcgmi dmon -e` asks for it first."""
    assert DCGM_FI_PROF_PIPE_TENSOR_ACTIVE == 1004
    assert DCGM_FI_DEV_SM_CLOCK == 100
    r = _Runner(["GPU 0  0.5  1500\n"])
    seen = []
    t = DcgmiTransport(runner=lambda cmd: seen.append(cmd) or r(cmd))
    t.connect()
    assert t.read(0, (TPA, CLK))[TPA].value == 0.5
    (dmon,) = [c for c in seen if "dmon" in c]
    assert dmon[dmon.index("-e") + 1] == "1004,100"


# ---------------------------------------------------------------------------
# PynvmlTransport against a fake `pynvml` module
# ---------------------------------------------------------------------------
class _NVMLError(Exception):
    def __init__(self, value):
        super().__init__(f"NVML error {value}")
        self.value = value


class _MetricsGet:
    """`c_nvmlGpmMetricsGet_t`'s fields."""

    def __init__(self):
        self.version = self.numMetrics = 0
        self.sample1 = self.sample2 = None
        self.metrics = [types.SimpleNamespace(metricId=0, nvmlReturn=0,
                                              value=0.0) for _ in range(4)]


def _fake_nvml(*, field=None, gpm=None, gpm_supported=True, util=(37,),
               clock=(1755,), fail=()):
    """A `pynvml` stand-in for one GPU.  `field`: the profiling field's
    (nvmlReturn, value), or None for bindings without it; `gpm`: the
    cumulative (seconds, tensor-busy seconds) each GPM sample takes in
    turn, or None for bindings without GPM (a string: the NVML error
    every sample raises); `util` / `clock`: successive readings; `fail`:
    the calls that raise `NVMLError`."""
    nv = types.ModuleType("pynvml")
    nv.NVMLError = _NVMLError
    nv.NVML_CLOCK_SM = 1
    nv.calls = {"init": 0, "shutdown": 0, "alloc": 0, "free": 0}
    reads = {"util": list(util), "clock": list(clock)}

    def maybe_fail(name):
        if name in fail:
            raise _NVMLError(999)

    def init():
        maybe_fail("init")
        nv.calls["init"] += 1

    def shutdown():
        nv.calls["shutdown"] += 1

    def next_of(key):
        vals = reads[key]
        return vals.pop(0) if len(vals) > 1 else vals[0]

    def clock_info(h, which):
        maybe_fail("clock")
        assert which == nv.NVML_CLOCK_SM
        return next_of("clock")

    def utilization(h):
        maybe_fail("util")
        return types.SimpleNamespace(gpu=next_of("util"), memory=0)

    nv.nvmlInit, nv.nvmlShutdown = init, shutdown
    nv.nvmlDeviceGetCount = lambda: 1
    nv.nvmlDeviceGetHandleByIndex = lambda i: ("gpu", i)
    nv.nvmlDeviceGetClockInfo = clock_info
    nv.nvmlDeviceGetUtilizationRates = utilization
    if field is not None:
        nv.NVML_FI_PROF_PIPE_TENSOR_ACTIVE = 200

        def field_values(h, ids):
            maybe_fail("field")
            assert ids == [200]
            ret, value = field
            return [types.SimpleNamespace(
                nvmlReturn=ret, value=types.SimpleNamespace(dVal=value))]
        nv.nvmlDeviceGetFieldValues = field_values
    if gpm is not None:
        stamps = list(gpm) if not isinstance(gpm, str) else []
        nv.NVML_GPM_METRICS_GET_VERSION = 1
        nv.NVML_GPM_METRIC_ANY_TENSOR_UTIL = 5
        nv.c_nvmlGpmMetricsGet_t = _MetricsGet

        def alloc():
            nv.calls["alloc"] += 1
            return types.SimpleNamespace(stamp=None, freed=False)

        def sample_get(h, sample):
            if isinstance(gpm, str):
                raise _NVMLError(gpm)
            sample.stamp = stamps.pop(0)

        def sample_free(sample):
            assert not sample.freed
            sample.freed = True
            nv.calls["free"] += 1

        def metrics_get(get):
            maybe_fail("metrics")
            assert get.version == 1 and get.numMetrics == 1
            assert get.metrics[0].metricId == 5
            (t1, b1), (t2, b2) = get.sample1.stamp, get.sample2.stamp
            get.metrics[0].value = 100.0 * (b2 - b1) / (t2 - t1)
            return get
        nv.nvmlGpmQueryDeviceSupport = lambda h: types.SimpleNamespace(
            isSupportedDevice=int(gpm_supported))
        nv.nvmlGpmSampleAlloc = alloc
        nv.nvmlGpmSampleGet = sample_get
        nv.nvmlGpmSampleFree = sample_free
        nv.nvmlGpmMetricsGet = metrics_get
    return nv


@pytest.fixture
def nvml(monkeypatch):
    """Puts a `_fake_nvml(**kw)` in `sys.modules` as `pynvml`."""
    def put(**kw):
        nv = _fake_nvml(**kw)
        monkeypatch.setitem(sys.modules, "pynvml", nv)
        return nv
    return put


def test_pynvml_reads_the_profiling_field(nvml):
    nvml(field=(0, 0.625), gpm=[(0.0, 0.0)], clock=(1830,))
    t = PynvmlTransport(clock=lambda: 5.0)
    t.connect()
    assert (t.tpa_source, t.tpa_sources, t.refused) == ("field", ["field"],
                                                        {})
    got = t.read(0, (TPA, CLK))
    assert got == {TPA: FieldSample(0.625, 5.0), CLK: FieldSample(1830.0, 5.0)}


def test_pynvml_reads_gpm_as_an_interval_average(nvml):
    """A field that answers with an error gives way to GPM: one sample at
    connect, then each read the tensor-busy share of the interval since
    the previous read, / 100; every sample is freed."""
    nv = nvml(field=(3, 0.0), gpm=[(0.0, 0.0), (10.0, 4.0), (12.0, 5.8)])
    t = PynvmlTransport()
    t.connect()
    assert t.tpa_source == "gpm" and "field" in t.refused
    assert nv.calls["alloc"] == 1
    assert t.read(0, (TPA,))[TPA].value == pytest.approx(0.4)
    assert t.read(0, (TPA, CLK))[TPA].value == pytest.approx(0.9)
    assert nv.calls["alloc"] - nv.calls["free"] == 1     # the last sample
    t.close()
    assert nv.calls["alloc"] == nv.calls["free"] == 3
    assert nv.calls["init"] == nv.calls["shutdown"] == 1


@pytest.mark.parametrize("kw,why", [
    ({}, "no NVML_FI_PROF_PIPE_TENSOR_ACTIVE"),
    ({"gpm": "unknown"}, "NVML error unknown"),        # the H100 here
    ({"gpm": [(0.0, 0.0)], "gpm_supported": False}, "not a GPM device"),
])
def test_pynvml_falls_back_to_utilization_and_says_so(nvml, kw, why):
    nv = nvml(util=(37, 100), **kw)
    t = PynvmlTransport()
    t.connect()
    assert t.tpa_source == "utilization"
    assert why in " ".join(t.refused.values())
    assert [t.read(0, (TPA,))[TPA].value for _ in range(2)] == [0.37, 1.0]
    t.close()
    assert nv.calls["alloc"] == nv.calls["free"]


@pytest.mark.parametrize("kw,fail", [
    ({}, "clock"), ({}, "util"), ({"field": (0, 0.5)}, "field"),
    ({"gpm": [(0.0, 0.0), (1.0, 0.5)]}, "metrics")])
def test_pynvml_errors_raise_transport_error(nvml, kw, fail):
    nv = nvml(fail=(), **kw)
    t = PynvmlTransport()
    t.connect()
    nv_fail = _fake_nvml(fail=(fail,), **kw)
    for name in ("nvmlDeviceGetClockInfo", "nvmlDeviceGetUtilizationRates",
                 "nvmlDeviceGetFieldValues", "nvmlGpmMetricsGet"):
        if hasattr(nv_fail, name):
            setattr(nv, name, getattr(nv_fail, name))
    with pytest.raises(TransportError, match="NVML read failed on GPU 0"):
        t.read(0, (TPA, CLK))
    with pytest.raises(TransportError, match="no such GPU"):
        t.read(3, (TPA, CLK))


def test_pynvml_init_error_raises_and_backend_polls(nvml):
    nvml(fail=("init",))
    with pytest.raises(TransportError, match="NVML init failed"):
        PynvmlTransport().connect()
    nvml(util=(50,), clock=(1980,))
    be = DcgmFieldBackend(0, PynvmlTransport(), strict=True)
    assert be.poll(0.2) == (0.5, 1980.0)
    assert be.healthy and be.transport.tpa_source == "utilization"


# ---------------------------------------------------------------------------
# DcgmFieldBackend policy: ranges, staleness, retry/backoff
# ---------------------------------------------------------------------------
class _ScriptedTransport:
    """Serves a scripted list of (tpa, clk, t_s) triples, under the field
    ids the backend asks for (tensor activity first, the SM clock
    second); entries that are exceptions raise instead."""

    sample = FieldSample

    def __init__(self, script):
        self.script = list(script)
        self.i = 0
        self.connects = 0
        self.closes = 0

    def connect(self):
        self.connects += 1

    def close(self):
        self.closes += 1

    @property
    def n_devices(self):
        return 1

    def read(self, gpu, field_ids):
        item = self.script[min(self.i, len(self.script) - 1)]
        self.i += 1
        if isinstance(item, Exception):
            raise item
        tpa, clk, t_s = item
        f_tpa, f_clk = field_ids
        return {f_tpa: self.sample(tpa, t_s), f_clk: self.sample(clk, t_s)}


def test_backend_rejects_out_of_range_readings():
    for bad in [(1.7, 1400.0, 1.0), (-0.1, 1400.0, 1.0),
                (0.5, -3.0, 1.0), (0.5, 99_999.0, 1.0)]:
        be = DcgmFieldBackend(0, _ScriptedTransport([bad]),
                              max_retries=0, sleep=lambda s: None)
        with pytest.raises(TransportError, match="outside"):
            be.poll(30.0)
        assert not be.healthy


def test_backend_staleness_tolerates_then_escalates():
    frozen = [(0.4, 1400.0, 5.0)] * 10      # t_s never advances
    be = DcgmFieldBackend(0, _ScriptedTransport(frozen), max_retries=0,
                          max_stale_polls=3, sleep=lambda s: None)
    assert be.poll(30.0) == (0.4, 1400.0)   # first: fresh
    for _ in range(3):                      # tolerated repeats
        assert be.poll(30.0) == (0.4, 1400.0)
    assert be.healthy
    with pytest.raises(TransportError, match="stale for 4 consecutive"):
        be.poll(30.0)
    assert be.stale_reads == 7 and not be.healthy


def test_backend_retry_backoff_schedule_and_reconnect():
    t = _ScriptedTransport([TransportError("boom 1"),
                            TransportError("boom 2"),
                            (0.4, 1400.0, 1.0)])
    naps = []
    be = DcgmFieldBackend(0, t, max_retries=3, backoff_s=0.05,
                          backoff_mult=2.0, sleep=naps.append)
    assert be.poll(30.0) == (0.4, 1400.0)
    assert naps == [0.05, 0.1]              # exponential schedule
    assert be.retries == 2 and be.reconnects == 2
    assert t.closes == 2 and t.connects == 3   # close -> backoff -> connect
    assert be.healthy and be.polls == 1


def test_backend_gives_up_after_max_retries():
    t = _ScriptedTransport([TransportError("dead daemon")] * 10)
    be = DcgmFieldBackend(0, t, max_retries=2, sleep=lambda s: None)
    with pytest.raises(TransportError, match="gave up after 2"):
        be.poll(30.0)
    assert not be.healthy and be.retries == 2


def test_backend_enforces_scrape_window():
    be = DcgmFieldBackend(0, _ScriptedTransport([(0.4, 1400.0, 1.0)]))
    with pytest.raises(ValueError, match="30"):
        be.poll(45.0)                        # §IV-C: > hardware window
    lax = DcgmFieldBackend(0, _ScriptedTransport([(0.4, 1400.0, 1.0)]),
                           strict=False)
    with pytest.warns(RuntimeWarning):
        lax.poll(45.0)


SCRIPTS = {
    "clean": [(0.1 * k, 1000.0 + k, float(k)) for k in range(1, 9)],
    "flaky": [(0.4, 1400.0, 1.0), "err", "err", (0.5, 1410.0, 2.0),
              (0.5, 1410.0, 2.0), (0.6, 1420.0, 3.0)],
    "stale": [(0.4, 1400.0, 5.0)] * 8,
    "range": [(0.4, 1400.0, 1.0), (1.4, 1400.0, 2.0)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_backend_policy_equals_the_reference_on_one_script(name):
    """Both packages' backends over the same scripted transport: the
    same readings or the same error, after the same counters."""
    def run(backend_cls, error_cls, sample_cls):
        script = [error_cls("boom") if x == "err" else x
                  for x in SCRIPTS[name]]
        tr = _ScriptedTransport(script)
        tr.sample = sample_cls
        be = backend_cls(0, tr, max_retries=2, max_stale_polls=2,
                         sleep=lambda s: None)
        out = []
        for _ in range(5):
            try:
                out.append(be.poll(30.0))
            except error_cls as e:
                out.append(str(e))
                break
        return out, (be.polls, be.retries, be.reconnects, be.stale_reads,
                     be.healthy, tr.connects, tr.closes)

    assert run(DcgmFieldBackend, TransportError, FieldSample) \
        == run(R_backends.DcgmFieldBackend, R_backends.TransportError,
               R_backends.FieldSample)


# ---------------------------------------------------------------------------
# the fake + make_dcgm_backends + BackendSource integration
# ---------------------------------------------------------------------------
def test_fake_transport_matches_simulator_bitwise():
    t = _fake(chunk_s=300.0)
    # chunk seeds derive from the poll COUNT, so the comparison source
    # must be polled at the fake's chunk_s cadence
    sim = SimulatorSource(profile=PROFILE, duration_s=600.0,
                          interval_s=30.0, n_devices=2, seed=3)
    want = np.concatenate([sim.poll(300.0).tpa.numpy(),
                           sim.poll(300.0).tpa.numpy()], axis=1)
    got = np.empty(want.shape)
    # device-major like BackendSource: exercises the per-GPU cursors
    for d in range(2):
        for i in range(20):
            got[d, i] = t.read(d, (TPA,))[TPA].value
    np.testing.assert_array_equal(got, want)
    assert t.exhausted
    with pytest.raises(TransportError, match="exhausted"):
        t.read(0, (TPA,))


def test_fake_transport_validation_and_quantize():
    t = _fake(quantize=True)
    s = t.read(0, (TPA, CLK))
    assert s[TPA].value == round(s[TPA].value, 3)
    assert s[CLK].value == round(s[CLK].value, 0)
    with pytest.raises(TransportError, match="no such GPU"):
        t.read(9, (TPA,))
    with pytest.raises(TransportError, match="unsupported DCGM field"):
        t.read(0, (123,))
    t.close()
    with pytest.raises(TransportError, match="not connected"):
        t.read(0, (TPA,))
    with pytest.raises(ValueError, match="finite duration"):
        FakeDcgmTransport(PROFILE, duration_s=float("inf"),
                          interval_s=30.0, device="cpu")


def test_quantize_wire_shapes():
    tpa, clk = quantize_wire(np.array([0.123456, 0.5]),
                             np.array([1410.7, 899.2]))
    np.testing.assert_array_equal(tpa, [0.123, 0.5])
    np.testing.assert_array_equal(clk, [1411.0, 899.0])
    r_tpa, r_clk = R_backends.fake.quantize_wire(
        np.array([0.123456, 0.5]), np.array([1410.7, 899.2]))
    assert tpa.tobytes() == r_tpa.tobytes()
    assert clk.tobytes() == r_clk.tobytes()


def test_make_dcgm_backends_and_source_roundtrip():
    t = _fake(chunk_s=300.0)
    backends = make_dcgm_backends(t, sleep=lambda s: None)
    assert len(backends) == 2
    assert [b.gpu for b in backends] == [0, 1]
    src = BackendSource(backends=backends, duration_s=600.0,
                        interval_s=30.0)
    sim = SimulatorSource(profile=PROFILE, duration_s=600.0,
                          interval_s=30.0, n_devices=2, seed=3)
    # poll both at the fake's chunk cadence: chunk seeds match poll
    # count, so the grids must be bit-identical round by round
    for _ in range(2):
        grid = src.poll(300.0)
        want = sim.poll(300.0)
        assert isinstance(grid.tpa, np.ndarray) and grid.tpa.dtype == float
        np.testing.assert_array_equal(grid.tpa, want.tpa.numpy())
        np.testing.assert_array_equal(grid.clock_mhz, want.clock_mhz.numpy())
    assert all(b.healthy and b.polls == 20 for b in backends)


def test_fault_injection_is_sample_transparent():
    clean = _fake(chunk_s=300.0)
    flaky = _fake(chunk_s=300.0, fail_every=13)
    b_clean = make_dcgm_backends(clean, 2, sleep=lambda s: None)
    b_flaky = make_dcgm_backends(flaky, 2, sleep=lambda s: None)
    g1 = BackendSource(backends=b_clean, duration_s=600.0,
                       interval_s=30.0).poll(600.0)
    g2 = BackendSource(backends=b_flaky, duration_s=600.0,
                       interval_s=30.0).poll(600.0)
    np.testing.assert_array_equal(g1.tpa, g2.tpa)
    assert sum(b.retries for b in b_flaky) > 0
    assert all(b.healthy for b in b_flaky)


def test_dbz_beats_zlib_on_wire_precision_counters(tmp_path):
    """On DCGM-wire-precision counters the delta+bitshuffle transform
    must beat plain DEFLATE, and both must beat raw."""
    src = SimulatorSource(profile=PROFILE, duration_s=6 * 3600.0,
                          interval_s=30.0, n_devices=4, seed=11)
    grid = src.poll(6 * 3600.0)
    tpa, clk = quantize_wire(grid.tpa.numpy().astype(np.float64),
                             grid.clock_mhz.numpy().astype(np.float64))
    wire = DeviceGrid(30.0, tpa.astype(np.float32),
                      clk.astype(np.float32))
    sizes = {}
    for name in ("raw", "zlib", "dbz-zlib"):
        p = str(tmp_path / f"{name}.ctr2")
        ts.write_archive(wire, p, chunk_samples=512, codec=name)
        sizes[name] = os.path.getsize(p)
        back = ts.read_archive(p)
        assert back.tpa.tobytes() == wire.tpa.tobytes()
    assert sizes["dbz-zlib"] < sizes["zlib"] < sizes["raw"], sizes


# ---------------------------------------------------------------------------
# the live path against a host replay of the simulator's chunks
# ---------------------------------------------------------------------------
LIVE = dict(n_devices=4, interval_s=30.0, duration_s=3600.0, round_s=300.0,
            seed=7, events=[Event(1800, 3600, slowdown=2.5)])
LIVE_CFG = dict(round_s=300.0, bucket_s=300.0, retain=12,
                detector={"window": 3, "min_duration": 1})


def _serve(source, job_id="live"):
    """One SimClock-paced daemon + HTTP server over `source`: the fleet
    series, the job's bucket series and the alerts, as served."""
    clk = SimClock()
    daemon = ServiceDaemon(Collector([JobStream(job_id, source)],
                                     CollectorConfig(**LIVE_CFG)),
                           clock=clk.monotonic, sleep=clk.sleep)
    with daemon, FleetAPIServer(daemon.store) as server:
        daemon.run()
        client = FleetClient(server.url)
        return client.fleet(), client.job(job_id), client.alerts()


def _live_source(device, fail_every=None, n_devices=LIVE["n_devices"]):
    transport = FakeDcgmTransport(
        PROFILE, duration_s=LIVE["duration_s"],
        interval_s=LIVE["interval_s"], n_devices=n_devices,
        chunk_s=LIVE["round_s"], events=LIVE["events"], seed=LIVE["seed"],
        fail_every=fail_every, device=device)
    backends = make_dcgm_backends(transport, n_devices, sleep=lambda s: None)
    return backends, BackendSource(backends=backends,
                                   duration_s=LIVE["duration_s"],
                                   interval_s=LIVE["interval_s"])


def _sim(device, n_devices=LIVE["n_devices"]):
    return _SimulatorSource(
        profile=PROFILE, duration_s=LIVE["duration_s"],
        interval_s=LIVE["interval_s"], n_devices=n_devices,
        seed=LIVE["seed"], events=LIVE["events"], device=device)


def _host_replay(device, n_devices=LIVE["n_devices"]):
    """The simulator's chunks at the live path's cadence, copied to host
    float64 once and replayed through a `GridSource`."""
    sim = _sim(device, n_devices)
    chunks = [sim.poll(LIVE["round_s"]) for _ in
              range(int(LIVE["duration_s"] // LIVE["round_s"]))]
    tpa, clk = (np.concatenate([getattr(c, k).cpu().numpy().astype(
        np.float64) for c in chunks], axis=1) for k in ("tpa", "clock_mhz"))
    return GridSource(DeviceGrid(LIVE["interval_s"], tpa, clk))


@pytest.fixture(scope="module")
def live_cpu():
    backends, src = _live_source("cpu")
    served = _serve(src)
    return backends, served


def test_live_path_serves_what_a_host_replay_serves(live_cpu):
    backends, (fleet, job, alerts) = live_cpu
    assert all(b.healthy for b in backends)
    assert sum(b.polls for b in backends) \
        == LIVE["n_devices"] * LIVE["duration_s"] / LIVE["interval_s"]
    want_fleet, want_job, want_alerts = _serve(_host_replay("cpu"))
    assert fleet == want_fleet and job == want_job
    assert alerts == want_alerts
    assert len(fleet["t_s"]) == LIVE["duration_s"] / LIVE["round_s"]
    assert any(a["kind"] == "regression" for a in alerts["alerts"]), alerts


def test_live_path_is_sample_transparent_under_transport_faults(live_cpu):
    _, (fleet, job, _) = live_cpu
    flaky, src = _live_source("cpu", fail_every=97)
    got_fleet, got_job, _ = _serve(src)
    assert sum(b.retries for b in flaky) > 0
    assert all(b.healthy for b in flaky)
    assert got_fleet == fleet and got_job == job


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_live_path_on_the_card_against_its_host_replay(cuda):
    """The fake transport over the card's engine serves exactly what the
    card simulator's host-copied chunks serve; the simulator's card
    grids ingested by the histogram kernel fire the same alerts, with
    series within rtol 1e-5."""
    backends, src = _live_source(None, n_devices=8)
    fleet, job, alerts = _serve(src)
    assert all(b.healthy for b in backends)
    assert (fleet, job, alerts) == _serve(_host_replay(None, n_devices=8))
    c_fleet, c_job, c_alerts = _serve(_sim(None, n_devices=8))
    keys = ("round_idx", "t_s", "job_id", "kind")
    assert [[a[k] for k in keys] for a in c_alerts["alerts"]] \
        == [[a[k] for k in keys] for a in alerts["alerts"]]
    np.testing.assert_allclose([a["factor"] for a in c_alerts["alerts"]],
                               [a["factor"] for a in alerts["alerts"]],
                               rtol=1e-5)
    assert c_fleet["t_s"] == fleet["t_s"]
    np.testing.assert_allclose(c_fleet["mean"], fleet["mean"], rtol=1e-5)
    np.testing.assert_allclose(c_job["mean"], job["mean"], rtol=1e-5)
