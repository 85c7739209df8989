"""Slice 1 of the port end to end on the CPU, against the JAX package on
the same values: rollup ingest of torch grids, the rollup wire formats
across the two packages, `simulate_fleet(engine="torch")` against
`engine="jax"` through the regression detector, the fault layer, and
the no-silent-CPU rule of the entry points."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.fleet.streaming as R_stream  # noqa: E402
import repro_torch.fleet.streaming as T_stream  # noqa: E402
from repro.core.ofu import ofu_mean as R_ofu_mean  # noqa: E402
from repro.fleet.engine import CounterFault as R_Fault  # noqa: E402
from repro.fleet.engine import apply_faults as R_apply_faults  # noqa: E402
from repro.fleet.jobs import JobSpec as R_JobSpec  # noqa: E402
from repro.fleet.jobs import simulate_fleet as R_simulate_fleet  # noqa: E402
from repro.fleet.regression import scan_rollup as R_scan  # noqa: E402
from repro.telemetry.counters import Event as R_Event  # noqa: E402
from repro.telemetry.scrape import DeviceGrid as R_Grid  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.core.ofu import ofu_mean, ofu_series  # noqa: E402
from repro_torch.fleet.engine import CounterFault, JobSlot, apply_faults  # noqa: E402
from repro_torch.fleet.engine_torch import simulate_jobs_torch  # noqa: E402
from repro_torch.fleet.jobs import JobSpec, simulate_fleet, simulate_job  # noqa: E402
from repro_torch.fleet.regression import scan_rollup  # noqa: E402
from repro_torch.telemetry.counters import Event, StepProfile  # noqa: E402
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402


def _grid(duty=0.42, dur=3600.0, n_dev=8, events=(), seed=3):
    slot = JobSlot(StepProfile(duty * 2.0, 2.0), dur, 30.0,
                   events=[Event(*e) for e in events],
                   stragglers=np.ones(n_dev))
    return simulate_jobs_torch([slot], seed=seed, device="cpu")[0]


def _host(g):
    """The same values as a port host grid and a reference grid."""
    tpa, clk = g.tpa.numpy(), g.clock_mhz.numpy()
    return DeviceGrid(g.interval_s, tpa, clk), R_Grid(g.interval_s, tpa, clk)


def _scope_state_equal(a, b):
    """Bucketwise identity: same scopes, identical histogram counts,
    value sums equal to f32-accumulation tolerance."""
    assert set(a._hists) == set(b._hists)
    for scope in b._hists:
        np.testing.assert_array_equal(a._hists[scope], b._hists[scope],
                                      err_msg=str(scope))
        np.testing.assert_allclose(a._sums[scope], b._sums[scope],
                                   rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# rollup ingest of torch grids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n_dev,dur", [(3, 8, 3600.0), (5, 3, 1290.0),
                                            (11, 12, 600.0)])
def test_tensor_ingest_matches_host_and_reference_bucketwise(seed, n_dev,
                                                             dur):
    g = _grid(dur=dur, n_dev=n_dev, events=[(dur / 3, dur, 2.5)],
              seed=seed)
    host, ref = _host(g)
    r_dev, r_host = T_stream.StreamingRollup(300), T_stream.StreamingRollup(300)
    r_ref, r_jax = R_stream.StreamingRollup(300), R_stream.StreamingRollup(300)
    kw = dict(chips=16 * n_dev, group="bf16", app_mfu=0.4)
    ofu_dev = r_dev.add_grid("j", g, **kw)
    ofu_host = r_host.add_grid("j", host, **kw)
    r_ref.add_grid("j", ref, **kw)
    r_jax.add_grid("j", R_Grid(g.interval_s, jnp.asarray(host.tpa),
                               jnp.asarray(host.clock_mhz)), **kw)
    for other in (r_host, r_ref, r_jax):
        _scope_state_equal(r_dev, other)
    sd, sr = r_dev.job_stats("j"), r_ref.job_stats("j")
    np.testing.assert_array_equal(sd.weight, sr.weight)
    for q in (10, 50, 90):
        np.testing.assert_array_equal(sd.percentiles[q], sr.percentiles[q])
    assert r_dev.job_meta("j") == r_ref.job_meta("j")
    # the returned OFU series stays a tensor with the host's values
    assert isinstance(ofu_dev, torch.Tensor)
    np.testing.assert_allclose(ofu_dev.numpy(), ofu_host, rtol=1e-6)


def test_tensor_ingest_windowed_with_eviction():
    """A grid longer than the window folds its oldest buckets into the
    all-time totals identically on the tensor, host and reference paths."""
    g = _grid(dur=3600.0, n_dev=4, seed=5)
    host, ref = _host(g)
    w_dev = T_stream.WindowedRollup(bucket_s=300, retain=6)
    w_host = T_stream.WindowedRollup(bucket_s=300, retain=6)
    w_ref = R_stream.WindowedRollup(bucket_s=300, retain=6)
    w_dev.add_grid("j", g, chips=32, group="bf16")
    w_host.add_grid("j", host, chips=32, group="bf16")
    w_ref.add_grid("j", ref, chips=32, group="bf16")
    assert w_dev.bucket0 == w_host.bucket0 == w_ref.bucket0 == 6
    for other in (w_host, w_ref):
        _scope_state_equal(w_dev, other)
        for scope in other._ev_hist:
            np.testing.assert_array_equal(w_dev._ev_hist[scope],
                                          other._ev_hist[scope])
            assert w_dev._ev_sum[scope] == pytest.approx(
                other._ev_sum[scope], rel=1e-5)
        assert w_dev.job_alltime("j")["weight"] \
            == other.job_alltime("j")["weight"]


def test_empty_tensor_grid_ingest_is_a_noop():
    roll = T_stream.StreamingRollup(300)
    g = DeviceGrid(30.0, torch.empty((2, 0)), torch.empty((2, 0)))
    out = roll.add_grid("j", g)
    assert out.shape == (2, 0) and roll.n_buckets == 0


# ---------------------------------------------------------------------------
# the rollup wire formats carry state across the two packages
# ---------------------------------------------------------------------------
def _filled(pkg, windowed):
    roll = pkg.WindowedRollup(300, retain=4) if windowed \
        else pkg.StreamingRollup(300)
    for i, seed in enumerate((1, 2)):
        g = _grid(dur=2400.0, n_dev=3, seed=seed)
        grid = DeviceGrid if pkg is T_stream else R_Grid
        roll.add_grid(f"j{i}", grid(30.0, g.tpa.numpy(), g.clock_mhz.numpy()),
                      chips=24, group="bf16", app_mfu=0.3 + i / 10)
    return roll


def _same_state(a, b):
    assert type(a).__name__ == type(b).__name__
    assert (a.bucket_s, a.bins, a.n_buckets, a.bucket0) \
        == (b.bucket_s, b.bins, b.n_buckets, b.bucket0)
    np.testing.assert_array_equal(a.edges, b.edges)
    assert set(a._hists) == set(b._hists)
    for scope in a._hists:
        np.testing.assert_array_equal(a._hists[scope], b._hists[scope])
        np.testing.assert_array_equal(a._sums[scope], b._sums[scope])
    assert a._job_meta == b._job_meta
    for scope in getattr(a, "_ev_hist", {}):
        np.testing.assert_array_equal(a._ev_hist[scope], b._ev_hist[scope])
        assert a._ev_sum[scope] == b._ev_sum[scope]


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("src,dst", [(R_stream, T_stream),
                                     (T_stream, R_stream)])
def test_npz_snapshot_crosses_packages(src, dst, windowed):
    roll = _filled(src, windowed)
    back = dst.StreamingRollup.from_bytes(roll.to_bytes())
    _same_state(back, roll)
    assert back.summary() == roll.summary()


@pytest.mark.parametrize("src,dst", [(R_stream, T_stream),
                                     (T_stream, R_stream)])
def test_v2_wire_and_deltas_cross_packages(src, dst):
    roll = _filled(src, False)
    _same_state(dst.StreamingRollup.from_bytes(roll.to_bytes_v2()), roll)
    mirror = dst.StreamingRollup(300)
    assert mirror.apply_delta(roll.delta_bytes(0))
    since = roll.generation
    g = _grid(dur=3000.0, n_dev=2, seed=9)
    grid = DeviceGrid if src is T_stream else R_Grid
    roll.add_grid("j9", grid(30.0, g.tpa.numpy(), g.clock_mhz.numpy()))
    assert mirror.apply_delta(roll.delta_bytes(since))
    assert not mirror.apply_delta(roll.delta_bytes(since))   # duplicate
    for scope in roll._hists:
        np.testing.assert_array_equal(mirror._hists[scope],
                                      roll._hists[scope])


# ---------------------------------------------------------------------------
# the whole slice: simulate_fleet -> rollup -> regression detector
# ---------------------------------------------------------------------------
def _fleets(slow_job=None, faults=(), dur=600.0):
    """(port specs, reference specs) of one small mixed fleet."""
    rows = [("a", "granite-3-2b", 0.35, 1), ("b", "llama3.2-3b", 0.5, 2),
            ("c", "granite-3-2b", 0.45, 3)]
    out = []
    for Spec, Ev, Fault in ((JobSpec, Event, CounterFault),
                            (R_JobSpec, R_Event, R_Fault)):
        out.append([Spec(jid, arch, chips=16, true_duty=duty,
                         duration_s=dur, seed=seed,
                         events=[Ev(dur / 2, dur, slowdown=2.5)]
                         if jid == slow_job else (),
                         faults=[Fault(**f) for f in faults]
                         if jid == "a" else ())
                    for jid, arch, duty, seed in rows])
    return out


def test_simulate_fleet_torch_matches_jax_engine():
    port, ref = _fleets()
    tt = simulate_fleet(port, max_devices=4, device="cpu")
    tj = R_simulate_fleet(ref, max_devices=4, engine="jax")
    for a, b in zip(tt, tj):
        assert a.app_mfu == b.app_mfu and a.app_mfu_exact == b.app_mfu_exact
        assert a.step_time_s == b.step_time_s
        assert tuple(a.grid.tpa.shape) == np.asarray(b.grid.tpa).shape
        assert isinstance(a.ofu, float)
        assert a.ofu == pytest.approx(float(b.ofu), abs=0.015)
        assert len(a.device_series) == 4
    with pytest.raises(ValueError, match="unknown engine"):
        simulate_fleet(port, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        simulate_job(port[0], engine="fused", device="cpu")


def test_simulate_job_torch_matches_jax_engine():
    port, ref = _fleets()
    a = simulate_job(port[1], max_devices=8, device="cpu")
    from repro.fleet.jobs import simulate_job as R_simulate_job
    b = R_simulate_job(ref[1], max_devices=8, engine="jax")
    assert a.app_mfu == b.app_mfu
    assert a.ofu == pytest.approx(float(b.ofu), abs=0.015)


def test_slowdown_flags_the_same_job_in_both_pipelines():
    port, ref = _fleets(slow_job="b", dur=6 * 3600.0)
    r_port, r_ref = T_stream.StreamingRollup(300), R_stream.StreamingRollup(300)
    for tel in simulate_fleet(port, max_devices=8, device="cpu"):
        r_port.add_job(tel)                   # tensor grids: fused ingest
    for tel in R_simulate_fleet(ref, max_devices=8, engine="jax"):
        r_ref.add_job(tel)
    flagged_port, flagged_ref = scan_rollup(r_port), R_scan(r_ref)
    assert set(flagged_port) == set(flagged_ref) == {"b"}
    (reg,) = flagged_port["b"]
    assert reg.factor == pytest.approx(flagged_ref["b"][0].factor, rel=0.1)


FAULTS = [dict(start_s=300.0, duty_scale=0.4, clock_scale=0.9),
          dict(start_s=60.0, end_s=420.0, duty_scale=1.7, device_frac=0.5,
               period_s=120.0, active_frac=0.5, diurnal_amp=0.2)]


def test_apply_faults_on_tensor_grids_equals_reference():
    g = _grid(dur=600.0, n_dev=6, seed=2)
    host, ref = _host(g)
    for f in FAULTS:
        got = apply_faults(g, [CounterFault(**f)])
        want = R_apply_faults(ref, [R_Fault(**f)])
        assert isinstance(got.tpa, torch.Tensor)
        np.testing.assert_array_equal(got.tpa.numpy(), want.tpa)
        np.testing.assert_array_equal(got.clock_mhz.numpy(), want.clock_mhz)
        host_got = apply_faults(host, [CounterFault(**f)])
        np.testing.assert_array_equal(host_got.tpa, want.tpa)
    empty = DeviceGrid(30.0, torch.empty((2, 0)), torch.empty((2, 0)))
    assert apply_faults(empty, [CounterFault()]).tpa.shape == (2, 0)


def test_faults_are_post_hoc_on_the_torch_engine():
    """A faulted fleet equals the plain fleet with the faults applied
    after the fact, bit for bit; the other jobs are untouched."""
    port, _ = _fleets()
    port_f, _ = _fleets(faults=FAULTS[:1])
    plain = simulate_fleet(port, device="cpu")
    faulted = simulate_fleet(port_f, device="cpu")
    want = apply_faults(plain[0].grid, [CounterFault(**FAULTS[0])])
    assert torch.equal(faulted[0].grid.tpa, want.tpa)
    assert torch.equal(faulted[0].grid.clock_mhz, want.clock_mhz)
    assert torch.equal(faulted[1].grid.tpa, plain[1].grid.tpa)
    assert faulted[0].app_mfu == plain[0].app_mfu


def test_ofu_on_tensors_matches_numpy():
    g = _grid(dur=900.0, n_dev=5, seed=4)
    tpa, clk = g.tpa.numpy(), g.clock_mhz.numpy()
    assert ofu_mean(g.tpa, g.clock_mhz) == pytest.approx(
        R_ofu_mean(tpa, clk), rel=1e-12)
    series = ofu_series(g.tpa, g.clock_mhz)
    assert isinstance(series, torch.Tensor) and series.dtype == torch.float64
    np.testing.assert_allclose(series.numpy(), ofu_series(tpa, clk),
                               rtol=1e-15)


# ---------------------------------------------------------------------------
# entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------
def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port, _ = _fleets()
    slot = JobSlot(StepProfile(0.8, 2.0), 600.0, 30.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_fleet(port)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_job(port[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_jobs_torch([slot])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert simulate_jobs_torch([slot], device="cpu")[0].tpa.device.type \
        == "cpu"
