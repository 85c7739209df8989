"""The port's Table III / Fig. 5 fixture (`repro_torch.fleet.table3`)
against the JAX package's.

  * on shared grids — the reference's `build_jobs()` counters as port
    `DeviceGrid`s over NumPy — the port's `offline_rollups`, `analyze`
    and `analyze_correlation` give the reference's r_all, r_clean and
    MAE within 1e-12, and the same flagged sets;
  * on the torch engine (CPU), whose draws are its own: exactly the 82
    miscalculated jobs flagged, r after exclusion at least 0.75 (the
    reference's CLI floor), r_all within 0.05 of the reference's, and
    the reported-MFU streams bitwise the reference's (they are
    NumPy-seeded in both packages);
  * the live replay (`to_streams` through a `Collector`) equals the
    offline rollups bucket for bucket, and its miscalc alerts name the
    same 82 jobs (the reference CLI's self-check, without its HTTP half).

The `gpu` case runs the fixture on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fleet.correlation import analyze_correlation as R_corr  # noqa: E402
from repro.fleet.divergence import analyze as R_analyze  # noqa: E402
from repro_torch.fleet import table3 as T  # noqa: E402
from repro_torch.fleet.collector import Collector, CollectorConfig  # noqa: E402
from repro_torch.fleet.correlation import analyze_correlation  # noqa: E402
from repro_torch.fleet.divergence import analyze  # noqa: E402
from repro_torch.fleet.jobs import JobTelemetry  # noqa: E402
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402


def _reference_table3():
    """The reference's fixture, imported where a CPU case needs it: its
    engine imports jax, which a machine that runs only the `gpu` case
    may not have."""
    from repro.fleet import table3
    return table3


SPEC_KEYS = ("job_id", "arch", "chips", "flops_variant", "true_duty",
             "duration_s", "scrape_interval_s", "seed")


def _summary(roll, mfu):
    rep = analyze(roll.to_job_points(), flag_rel_err=T.FLAG_REL_ERR)
    crep = analyze_correlation(mfu, roll)
    return rep, crep


@pytest.fixture(scope="module")
def ref():
    R = _reference_table3()
    jobs = R.build_jobs()
    roll, mfu = R.offline_rollups(jobs)
    rep = R_analyze(roll.to_job_points(), flag_rel_err=R.FLAG_REL_ERR)
    return jobs, rep, R_corr(mfu, roll)


@pytest.fixture(scope="module")
def port_cpu():
    jobs = T.build_jobs(device="cpu")
    roll, mfu = T.offline_rollups(jobs)
    return jobs, roll, mfu


def test_fixture_constants_and_specs_are_the_references():
    R = _reference_table3()
    assert T.SCALE_MIX == R.SCALE_MIX and T.HEALTHY_ARCHS == R.HEALTHY_ARCHS
    assert (T.MOE_CHIPS, T.HYBRID_CHIPS, T.HYBRID_BUGS, T.FLAG_REL_ERR) \
        == (R.MOE_CHIPS, R.HYBRID_CHIPS, R.HYBRID_BUGS, R.FLAG_REL_ERR)
    assert (T.INTERVAL_S, T.BUCKET_S, T.ROUND_S, T.DURATION_S) \
        == (R.INTERVAL_S, R.BUCKET_S, R.ROUND_S, R.DURATION_S)
    for seed in (0, 3):
        port, ref = T.build_specs(seed), R.build_specs(seed)
        assert len(port) == len(ref) == 608
        for ps, rs in zip(port, ref):
            assert [getattr(ps, k) for k in SPEC_KEYS] \
                == [getattr(rs, k) for k in SPEC_KEYS]


def test_shared_grids_give_the_references_numbers(ref):
    """The reference's own grids through the port's rollup and analyses:
    r_all, r_clean and MAE within 1e-12, flagged sets equal."""
    rjobs, rrep, rcrep = ref
    jobs = [T.Table3Job(spec, JobTelemetry(
        spec, DeviceGrid(j.telemetry.grid.interval_s, j.telemetry.grid.tpa,
                         j.telemetry.grid.clock_mhz,
                         t0_s=j.telemetry.grid.t0_s),
        j.telemetry.app_mfu, j.telemetry.app_mfu_exact,
        j.telemetry.step_time_s, j.telemetry.executed_tflops_per_step),
        j.mfu_t, j.mfu_v) for spec, j in zip(T.build_specs(0), rjobs)]
    rep, crep = _summary(*T.offline_rollups(jobs))
    for got, want in [(rep.r_all, rrep.r_all), (rep.r_clean, rrep.r_clean),
                      (rep.mae_all, rrep.mae_all), (crep.r_all, rcrep.r_all),
                      (crep.r_clean, rcrep.r_clean), (crep.mae, rcrep.mae)]:
        assert abs(got - want) <= 1e-12, (got, want)
    assert {p.job_id for p in rep.flagged} == {p.job_id for p in rrep.flagged}
    assert {f.job_id for f in crep.flagged} \
        == {f.job_id for f in rcrep.flagged}
    assert rep.by_scale == rrep.by_scale


def test_torch_engine_flags_exactly_the_82_affected_jobs(ref, port_cpu):
    jobs, roll, mfu = port_cpu
    _, rrep, _ = ref
    truth = T.affected_ids(jobs)
    affected = set().union(*truth.values())
    assert {k: len(v) for k, v in truth.items()} \
        == {"naive_moe": 65, "naive_hybrid": 17}
    rep, crep = _summary(roll, mfu)
    assert {p.job_id for p in rep.flagged} == affected
    assert {f.job_id for f in crep.flagged} == affected
    assert rep.r_clean >= 0.75 and crep.r_clean >= 0.75
    assert abs(rep.r_all - rrep.r_all) <= 0.05


def test_torch_engine_mfu_streams_are_the_references(ref, port_cpu):
    rjobs, _, _ = ref
    jobs, _, _ = port_cpu
    assert [j.job_id for j in jobs] == [j.job_id for j in rjobs]
    for pj, rj in zip(jobs, rjobs):
        assert pj.mfu_t.tobytes() == rj.mfu_t.tobytes()
        assert pj.mfu_v.tobytes() == rj.mfu_v.tobytes()


def test_default_width_samples_one_device_a_job(port_cpu):
    jobs, _, _ = port_cpu
    assert all(j.telemetry.grid.n_devices == 1 for j in jobs)
    assert all(j.telemetry.grid.tpa.shape[1] == 40 for j in jobs)
    assert isinstance(jobs[0].telemetry.grid.tpa, torch.Tensor)


def test_max_devices_widens_the_sample_and_keeps_the_flag_set():
    jobs = T.build_jobs(device="cpu", max_devices=16)
    want = sum(min(chips, 16) * n for chips, n in T.SCALE_MIX)
    assert sum(j.telemetry.grid.n_devices for j in jobs) == want
    rep, crep = _summary(*T.offline_rollups(jobs))
    affected = set().union(*T.affected_ids(jobs).values())
    assert {p.job_id for p in rep.flagged} == affected
    assert {f.job_id for f in crep.flagged} == affected
    assert crep.r_clean >= 0.75


def test_build_fleet_gives_the_offline_job_points(port_cpu):
    _, roll, _ = port_cpu
    points = T.build_fleet(device="cpu")
    assert [p.job_id for p in points] \
        == [p.job_id for p in roll.to_job_points()]
    assert len(points) == 608


def test_live_replay_equals_the_offline_rollups_bucketwise(port_cpu):
    jobs, roll, mfu = port_cpu
    affected = set().union(*T.affected_ids(jobs).values())
    col = Collector(T.to_streams(jobs),
                    CollectorConfig(round_s=T.ROUND_S, bucket_s=T.BUCKET_S,
                                    flag_rel_err=T.FLAG_REL_ERR))
    reports = col.run()
    assert len(reports) == 4
    assert {a.job_id for a in col.alerts if a.kind == "miscalc"} == affected
    for job in jobs:
        so = roll.job_stats(job.job_id, qs=())
        sl = col.rollup.job_stats(job.job_id, qs=())
        np.testing.assert_array_equal(so.mean[~np.isnan(so.mean)],
                                      sl.mean[~np.isnan(sl.mean)])
        io_, vo = mfu.job_series(job.job_id)
        il, vl = col.mfu.job_series(job.job_id)
        assert np.array_equal(io_, il) and np.array_equal(vo, vl)
    rep, crep = _summary(roll, mfu)
    live = analyze_correlation(col.mfu, col.rollup)
    assert abs(live.r_clean - crep.r_clean) < 1e-9
    assert {f.job_id for f in live.flagged} == affected


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_table3_on_the_card_flags_exactly_the_affected_jobs(cuda):
    """The fixture on the card, ingested by the histogram kernel (one
    launch a job): the exact 82-job flag set on both detectors."""
    from repro_torch.kernels import fleet_hist
    jobs = T.build_jobs()
    assert jobs[0].telemetry.grid.tpa.is_cuda
    n0 = fleet_hist.ofu_bucket_hist.launches
    roll, mfu = T.offline_rollups(jobs)
    assert fleet_hist.ofu_bucket_hist.launches - n0 == 608
    affected = set().union(*T.affected_ids(jobs).values())
    rep, crep = _summary(roll, mfu)
    assert {p.job_id for p in rep.flagged} == affected
    assert {f.job_id for f in crep.flagged} == affected
    assert crep.r_clean >= 0.75
