"""The port's fleet engine host half, `simulate_devices`,
`simulate_job`/`simulate_fleet` and the streaming rollup against the JAX
package's.

The reference's `test_fleet_engine.py`, run on the port on the CPU.  Its
engine-equivalence cases compared the vectorized engine with the
per-device scalar backend, and the fused multi-job grid with the
per-job loop; the port has one engine (`engine_torch`), so here the
port's engine is held against the reference's scalar backend on the
same seeds (statistically: Philox draws, not NumPy's), and one
`simulate_fleet` call against a `simulate_job` loop of the port's own,
as `test_torch_scenarios.py` did for the scenario cases.  The profile
math, the percentile readout, the precision labels and the rollup's
bookkeeping are held equal to the reference's.
"""
import dataclasses
import inspect
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fleet.jobs as R_jobs  # noqa: E402
import repro.fleet.streaming as R_streaming  # noqa: E402
from repro.telemetry import Event as R_Event  # noqa: E402
from repro.telemetry import SimulatedDeviceBackend as R_Backend  # noqa: E402
from repro.telemetry import StepProfile as R_Profile  # noqa: E402
from repro.telemetry import scrape as R_scrape  # noqa: E402
import repro.core.ofu as R_ofu  # noqa: E402
from repro_torch.core.ofu import (hist_percentile,  # noqa: E402
                                  hist_percentile_grid, ofu_series)
from repro_torch.core.peaks import TPU_V6E_LIKE  # noqa: E402
from repro_torch.fleet import (JobSpec, StreamingRollup,  # noqa: E402
                               simulate_fleet, simulate_job)
from repro_torch.fleet.engine import (EngineParams, JobSlot,  # noqa: E402
                                      simulate_devices)
from repro_torch.fleet.engine_torch import simulate_jobs_torch  # noqa: E402
from repro_torch.fleet.regression import detect_regressions  # noqa: E402
from repro_torch.fleet.streaming import precision_label  # noqa: E402
from repro_torch.telemetry import Event, StepProfile  # noqa: E402


def _profile(duty=0.4, step_s=2.0):
    return StepProfile(mxu_time_s=duty * step_s, step_time_s=step_s)


def _sim(profile, **kw):
    """The port's `simulate_devices` on the CPU, as host NumPy."""
    g = simulate_devices(profile, device="cpu", **kw)
    return g.tpa.numpy(), g.clock_mhz.numpy()


def _scalar_grid(duty, step_s, *, duration_s, interval_s, events=(),
                 stragglers=(1.0,), seed=0):
    """The reference's scalar backend: one SimulatedDeviceBackend per
    device, polled serially."""
    rng = np.random.default_rng(seed)
    tpa, clk = [], []
    for s in stragglers:
        be = R_Backend(R_Profile(duty * step_s, step_s),
                       events=[R_Event(*e) for e in events],
                       straggler_factor=float(s),
                       seed=int(rng.integers(0, 2 ** 31)))
        series = R_scrape(be, duration_s, interval_s)
        tpa.append(series.tpa)
        clk.append(series.clock_mhz)
    return np.array(tpa), np.array(clk)


def _specs(pkg_spec, pkg_event, rows):
    return [pkg_spec(jid, arch, chips=chips, true_duty=duty,
                     duration_s=dur, seed=seed,
                     events=[pkg_event(*e) for e in events],
                     straggler_sigma=sigma, **kw)
            for jid, arch, chips, duty, dur, seed, events, sigma, kw in rows]


# ---------------------------------------------------------------------------
# equivalence: the torch engine vs the reference's scalar backend
# ---------------------------------------------------------------------------
def test_steady_state_tpa_and_clock_statistics_match():
    n_dev, dur, iv = 16, 1800.0, 30.0
    tpa, clk = _sim(_profile(0.42), duration_s=dur, interval_s=iv,
                    n_devices=n_dev, seed=0)
    s_tpa, s_clk = _scalar_grid(0.42, 2.0, duration_s=dur, interval_s=iv,
                                stragglers=np.ones(n_dev), seed=0)
    assert tpa.shape == s_tpa.shape == (n_dev, 60)
    assert tpa.mean() == pytest.approx(s_tpa.mean(), abs=0.005)
    assert clk.mean() == pytest.approx(s_clk.mean(), abs=15.0)
    assert clk.std() == pytest.approx(s_clk.std(), rel=0.5)
    assert ofu_series(tpa, clk).mean() == pytest.approx(
        ofu_series(s_tpa, s_clk).mean(), abs=0.005)


def test_event_injection_statistics_match():
    """The 2.5x host-sync collapse must look identical through both
    paths, window by window."""
    ev = [(300, 900, 2.5)]
    tpa, _ = _sim(_profile(0.45), duration_s=900, interval_s=30.0,
                  events=[Event(*e) for e in ev], n_devices=8, seed=3)
    s_tpa, _ = _scalar_grid(0.45, 2.0, duration_s=900, interval_s=30.0,
                            events=ev, stragglers=np.ones(8), seed=3)
    v_before, v_during = tpa[:, :10].mean(), tpa[:, 10:].mean()
    r_before, r_during = s_tpa[:, :10].mean(), s_tpa[:, 10:].mean()
    assert v_before == pytest.approx(r_before, abs=0.01)
    assert v_during == pytest.approx(r_during, abs=0.01)
    assert v_before / v_during == pytest.approx(2.5, rel=0.05)


def test_mxu_scale_event_and_straggler_equivalence():
    ev = (120, 360, 1.0, 0.5, "shrunk_gemm")
    stragglers = np.array([1.0, 1.0, 2.0, 1.3])
    tpa, _ = _sim(_profile(0.5, step_s=1.0), duration_s=600,
                  interval_s=30.0, events=[Event(*ev)],
                  stragglers=stragglers, seed=11)
    s_tpa, _ = _scalar_grid(0.5, 1.0, duration_s=600, interval_s=30.0,
                            events=[ev], stragglers=stragglers, seed=11)
    np.testing.assert_allclose(tpa.mean(axis=1), s_tpa.mean(axis=1),
                               atol=0.01)
    assert tpa[2].mean() == pytest.approx(tpa[0].mean() / 2, rel=0.05)


def test_simulate_job_matches_reference_scalar_engine():
    spec = JobSpec("eq", "granite-3-2b", chips=32, true_duty=0.35,
                   duration_s=600, seed=5)
    port = simulate_job(spec, max_devices=8, device="cpu")
    ref = R_jobs.simulate_job(R_jobs.JobSpec("eq", "granite-3-2b", chips=32,
                                             true_duty=0.35, duration_s=600,
                                             seed=5),
                              max_devices=8, engine="scalar")
    assert port.app_mfu == ref.app_mfu          # profile math is the same
    assert port.app_mfu_exact == ref.app_mfu_exact
    assert port.step_time_s == ref.step_time_s
    assert port.ofu == pytest.approx(ref.ofu, abs=0.01)
    assert len(port.device_series) == len(ref.device_series) == 8
    for engine in ("warp", "vector", "scalar", "fused"):
        with pytest.raises(ValueError):
            simulate_job(spec, engine=engine, device="cpu")


# ---------------------------------------------------------------------------
# one padded grid for the fleet vs the per-job loop (both torch)
# ---------------------------------------------------------------------------
def _sweep(pkg_spec=JobSpec, pkg_event=Event, n=24):
    """Ragged sweep: mixed durations/duties, an evented job, a straggler."""
    return _specs(pkg_spec, pkg_event, [
        (f"j{i}", "granite-3-2b", 16, 0.2 + 0.03 * (i % 8),
         300.0 + 150.0 * (i % 4), i,
         [(120, 360, 2.5)] if i % 7 == 0 else (),
         0.2 if i % 5 == 0 else 0.0, {}) for i in range(n)])


def test_fleet_grid_matches_per_job_loop_and_reference():
    """Same-seed tolerance test: one `simulate_fleet` call must be
    statistically indistinguishable from the per-job loop and from the
    reference's fused fleet."""
    fleet = simulate_fleet(_sweep(), max_devices=4, device="cpu")
    perjob = [simulate_job(s, max_devices=4, device="cpu") for s in _sweep()]
    ref = R_jobs.simulate_fleet(_sweep(R_jobs.JobSpec, R_Event),
                                max_devices=4, engine="fused")
    for f, p, r in zip(fleet, perjob, ref):
        assert f.app_mfu == p.app_mfu == r.app_mfu
        assert f.ofu == pytest.approx(p.ofu, abs=0.01)
        assert f.ofu == pytest.approx(r.ofu, abs=0.01)
        assert len(f.device_series) == len(p.device_series) \
            == len(r.device_series)
        assert tuple(f.grid.tpa.shape) == r.grid.tpa.shape   # ragged S
        for sf, sp in zip(f.device_series, p.device_series):
            assert sf.tpa.shape == sp.tpa.shape
            assert sf.interval_s == sp.interval_s


def test_fleet_engine_is_the_default_and_deterministic():
    a = simulate_fleet(_sweep(n=6), device="cpu")
    b = simulate_fleet(_sweep(n=6), engine="torch", device="cpu")
    for ta, tb in zip(a, b):
        assert torch.equal(ta.grid.tpa, tb.grid.tpa)
        assert torch.equal(ta.grid.clock_mhz, tb.grid.clock_mhz)
    with pytest.raises(ValueError, match="unknown engine"):
        simulate_fleet(_sweep(n=2), engine="fused", device="cpu")


def test_fleet_event_collapse_window_by_window():
    """The 2.5x host-sync signature must appear in the fleet grid exactly
    where the reference's fused grid puts it."""
    rows = [("quiet", "granite-3-2b", 8, 0.4, 900, 1, (), 0.0, {}),
            ("gloo", "granite-3-2b", 8, 0.45, 900, 2, [(300, 900, 2.5)],
             0.0, {})]
    quiet, gloo = simulate_fleet(_specs(JobSpec, Event, rows),
                                 max_devices=8, device="cpu")
    _, r_gloo = R_jobs.simulate_fleet(_specs(R_jobs.JobSpec, R_Event, rows),
                                      max_devices=8, engine="fused")
    g = gloo.grid.tpa.numpy()
    assert g[:, :10].mean() / g[:, 10:].mean() == pytest.approx(2.5,
                                                                rel=0.05)
    assert g[:, 10:].mean() == pytest.approx(r_gloo.grid.tpa[:, 10:].mean(),
                                             abs=0.01)
    q = quiet.grid.tpa.numpy()
    assert q[:, :10].mean() == pytest.approx(q[:, 10:].mean(), abs=0.01)


def test_fleet_groups_heterogeneous_intervals_and_chips():
    """Jobs that cannot share a grid (different scrape interval or clock
    domain) land in separate groups but one call still serves all."""
    slots = [JobSlot(StepProfile(0.8, 2.0), 600, 30.0,
                     stragglers=np.ones(3)),
             JobSlot(StepProfile(0.8, 2.0), 600, 15.0,
                     stragglers=np.ones(2)),
             JobSlot(StepProfile(0.9, 2.0), 450, 30.0,
                     chip=TPU_V6E_LIKE, stragglers=np.ones(4)),
             JobSlot(StepProfile(0.5, 2.0), 10.0, 30.0)]   # S == 0
    grids = simulate_jobs_torch(slots, seed=0, device="cpu")
    assert [tuple(g.tpa.shape) for g in grids] == [(3, 20), (2, 40),
                                                   (4, 15), (1, 0)]
    assert grids[1].interval_s == 15.0
    # each job's clock lives in its own chip's domain
    assert grids[0].clock_mhz.max() <= 1500.0
    assert grids[2].clock_mhz.mean() > 1500.0


def test_fleet_straggler_scaling():
    slot = JobSlot(StepProfile(1.0, 2.0), 600, 30.0,
                   stragglers=np.array([1.0, 2.0]))
    (grid,) = simulate_jobs_torch([slot], seed=4, device="cpu")
    assert float(grid.tpa[1].mean()) == pytest.approx(
        float(grid.tpa[0].mean()) / 2, rel=0.05)


def test_simulate_job_profile_cache_not_chip_aliased():
    spec = JobSpec("one", "granite-3-2b", chips=8, true_duty=0.35,
                   duration_s=300, seed=3)
    job = simulate_job(spec, max_devices=4, device="cpu")
    again = simulate_job(spec, max_devices=4, device="cpu")
    assert torch.equal(job.grid.tpa, again.grid.tpa)
    # a customized chip must not alias the stock entry in the profile
    # cache (same .name, different physics)
    slow = dataclasses.replace(spec.chip, f_max_mhz=spec.chip.f_max_mhz / 2)
    halved = simulate_job(dataclasses.replace(spec, chip=slow),
                          max_devices=4, device="cpu")
    assert halved.step_time_s == pytest.approx(job.step_time_s * 2)


def test_engine_params_default_not_shared():
    """Each call constructs its own EngineParams, and an explicit params
    object is honored."""
    sig = inspect.signature(simulate_devices)
    assert sig.parameters["params"].default is None
    tpa, _ = _sim(StepProfile(0.8, 2.0), duration_s=300, interval_s=30.0,
                  n_devices=2, seed=0, params=EngineParams(n_sub_max=8))
    assert tpa.shape == (2, 10)


def test_simulate_devices_rejects_device_count_mismatch():
    prof = StepProfile(0.8, 2.0)
    with pytest.raises(ValueError,
                       match=r"n_devices=1 conflicts .*stragglers\)=5"):
        _sim(prof, duration_s=300, interval_s=30.0, n_devices=1,
             stragglers=np.ones(5))
    for kw, shape in ((dict(stragglers=np.full(5, 1.2)), (5, 10)),
                      (dict(n_devices=3), (3, 10)),
                      (dict(n_devices=2, stragglers=np.ones(2)), (2, 10))):
        assert _sim(prof, duration_s=300, interval_s=30.0, seed=0,
                    **kw)[0].shape == shape


# ---------------------------------------------------------------------------
# streaming rollup: buckets, percentiles, detector feeds
# ---------------------------------------------------------------------------
def test_hist_percentile_grid_matches_scalar_readout():
    """The vectorized per-bucket percentile readout agrees with the
    scalar hist_percentile loop bucket for bucket, and both with the
    reference's."""
    rng = np.random.default_rng(0)
    edges = np.linspace(0.0, 1.1, 129)
    h = rng.integers(0, 20, size=(12, 128)).astype(float) \
        * rng.uniform(0.5, 64, size=(12, 1))
    h[3] = 0.0                                   # an empty bucket row
    h[7, :64] = 0.0
    qs = (0, 10, 50, 90, 100)
    grid = hist_percentile_grid(edges, h, qs)
    assert grid.shape == (5, 12)
    np.testing.assert_array_equal(grid, R_ofu.hist_percentile_grid(edges, h,
                                                                   qs))
    for k, q in enumerate(qs):
        ref = [hist_percentile(edges, h[b], q) for b in range(12)]
        np.testing.assert_allclose(grid[k], ref, atol=1e-12, equal_nan=True)
        assert ref == pytest.approx(
            [R_ofu.hist_percentile(edges, h[b], q) for b in range(12)],
            nan_ok=True)
    assert hist_percentile_grid(edges, np.empty((0, 128)), qs).shape == (5, 0)


def test_rollup_percentiles_and_groups():
    rows = [("lo", "granite-3-2b", 64, 0.2, 1200, 1, (), 0.0, {}),
            ("hi", "granite-3-2b", 64, 0.5, 1200, 2, (), 0.0, {}),
            ("fp8", "granite-3-2b", 64, 0.35, 1200, 3, (), 0.0,
             {"precisions": {"bf16": 0.4, "fp8": 0.6}})]
    specs = _specs(JobSpec, Event, rows)
    roll = StreamingRollup(bucket_s=300)
    for t in simulate_fleet(specs, max_devices=4, device="cpu"):
        roll.add_job(t)                       # tensor grids: device ingest
    assert set(roll.groups) == {"bf16", "bf16+fp8"}
    for mix in ({"bf16": 0.4, "fp8": 0.6}, {"int8": 1.0},
                {"fp8": 0.2, "bf16": 0.3, "int8": 0.5}):
        assert precision_label(mix) == R_streaming.precision_label(mix)
    f = roll.fleet_stats()
    assert f.percentiles[10][1] < 0.3 < f.percentiles[90][1]
    assert np.all(f.percentiles[10][:4] <= f.percentiles[50][:4] + 1e-9)
    assert np.all(f.percentiles[50][:4] <= f.percentiles[90][:4] + 1e-9)
    assert roll.job_ofu("lo").mean() == pytest.approx(0.2, abs=0.03)
    assert roll.job_ofu("hi").mean() == pytest.approx(0.48, abs=0.04)
    assert np.nansum(f.weight) == pytest.approx(3 * 64 * 40)
    # the reference's fused fleet through its rollup: the same bands
    ref = R_streaming.StreamingRollup(bucket_s=300)
    for t in R_jobs.simulate_fleet(_specs(R_jobs.JobSpec, R_Event, rows),
                                   max_devices=4, engine="fused"):
        ref.add_job(t)
    rf = ref.fleet_stats()
    np.testing.assert_array_equal(f.weight, rf.weight)
    np.testing.assert_allclose(f.mean, rf.mean, atol=0.01)


def test_rollup_feeds_regression_detector_at_fleet_scale():
    """Paper SecVI-A at scale: a 512-chip job collapses 2.5x mid-run; the
    bucketed rollup series must trip the existing detector."""
    spec = JobSpec("gloo", "granite-3-2b", chips=512, true_duty=0.45,
                   duration_s=7200, seed=7,
                   events=[Event(start_s=3600, end_s=7200, slowdown=2.5)])
    (tel,) = simulate_fleet([spec], max_devices=64, device="cpu")
    roll = StreamingRollup(bucket_s=120)
    roll.add_job(tel)
    series = roll.job_ofu("gloo")
    assert len(series) >= 60
    assert not np.isnan(series).any()
    regs = detect_regressions(series, factor_threshold=1.5)
    assert len(regs) == 1
    assert series[:29].mean() / series[32:].mean() == pytest.approx(
        2.42, rel=0.05)
    assert 2.0 < regs[0].factor < 2.6
    pts = roll.to_job_points()
    assert len(pts) == 1 and pts[0].job_id == "gloo"
    assert pts[0].ofu == pytest.approx(tel.ofu, abs=0.02)


def test_rollup_forward_fill_and_empty_scopes():
    out = []
    for pkg in (StreamingRollup, R_streaming.StreamingRollup):
        roll = pkg(bucket_s=10)
        roll.observe("a", np.array([5.0, 25.0]), np.array([0.4, 0.2]),
                     group="bf16")
        filled = roll.job_ofu("a")
        assert filled == pytest.approx([0.4, 0.4, 0.2])   # gap filled
        raw = roll.job_stats("a", qs=()).mean
        assert np.isnan(raw[1]) and raw[0] == pytest.approx(0.4)
        assert len(roll.job_stats("missing").mean) == 0
        out.append((filled, roll.to_bytes_v2()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


# ---------------------------------------------------------------------------
# the fleet-scale operating point
# ---------------------------------------------------------------------------
def test_thousand_devices_one_hour_under_ten_seconds():
    spec = JobSpec("fleet", "granite-3-2b", chips=1000, true_duty=0.35,
                   duration_s=3600, scrape_interval_s=30, seed=0)
    t0 = time.perf_counter()
    (tel,) = simulate_fleet([spec], max_devices=1000, device="cpu")
    elapsed = time.perf_counter() - t0
    assert elapsed < 10.0, f"fleet sim took {elapsed:.1f}s"
    assert len(tel.device_series) == 1000
    assert len(tel.device_series[0].tpa) == 120
    assert tel.ofu == pytest.approx(0.35 * 0.96, abs=0.03)
