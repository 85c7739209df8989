"""The port's collector tier (`repro_torch.fleet`: collector, goodput,
distributed, correlation) against the JAX package's.

The CPU half of the reference's `test_collector.py`, `test_goodput.py`,
`test_fleet_distributed.py` and `test_correlation.py`, run on the port
(sources and `simulate_fleet` with `device="cpu"`: grids are CPU
tensors, so the collector ingests them through the histogram kernel's
plain version), then parity cases: one seeded grid through
`GridSource` into both packages' collectors gives equal alerts field by
field and byte-equal snapshots; the same grid as CPU tensors through the
port's tensor path gives equal counts and alerts by (round, job, kind);
a reference snapshot restores into the port's collector and continues
as the reference's does.
"""
import json
from dataclasses import dataclass
import urllib.error
import urllib.request

import numpy as np
import pytest

from _propcheck import given, settings, st

torch = pytest.importorskip("torch")

import repro.fleet.collector as R_collector  # noqa: E402
import repro.fleet.streaming as R_streaming  # noqa: E402
import repro.telemetry as R_telemetry  # noqa: E402
import repro_torch.fleet.collector as T_collector  # noqa: E402
from repro_torch.core.peaks import DEFAULT_CHIP  # noqa: E402
from repro_torch.fleet.collector import (AdaptiveConfig,  # noqa: E402
                                         AdaptiveScrapeController,
                                         AlertDeduper, Collector,
                                         CollectorConfig, FleetCollector,
                                         JobStream, _count_std)
from repro_torch.fleet.correlation import (CorrelationConfig,  # noqa: E402
                                           MfuRollup, analyze_correlation,
                                           joined_series, rolling_pearson,
                                           scan_miscalc, tile_quant_factor)
from repro_torch.fleet.distributed import host_partition, tree_reduce  # noqa: E402
from repro_torch.fleet.divergence import (DEFAULT_OFU_FLOOR,  # noqa: E402
                                          JobPoint, analyze, analyze_rollup)
from repro_torch.fleet.engine import simulate_devices as _simulate_devices  # noqa: E402
from repro_torch.fleet.goodput import (FleetRollup, from_rollup,  # noqa: E402
                                       goodput_from_rollup, rollup,
                                       scan_goodput)
from repro_torch.fleet.jobs import JobSpec  # noqa: E402
from repro_torch.fleet.jobs import simulate_fleet as _simulate_fleet  # noqa: E402
from repro_torch.fleet.regression import detect_regressions  # noqa: E402
from repro_torch.fleet.streaming import StreamingRollup, WindowedRollup  # noqa: E402
from repro_torch.serve import (FleetAPIError, FleetAPIServer,  # noqa: E402
                               FleetClient, FleetStore, IngestAggregator)
from repro_torch.telemetry import Event, StepProfile  # noqa: E402
from repro_torch.telemetry.counters import MAX_HW_AVG_WINDOW_S  # noqa: E402
from repro_torch.telemetry.mfu import (MfuReplaySource, MfuReporter,  # noqa: E402
                                       MfuSample, compute_mfu,
                                       extract_tflops_from_log,
                                       reported_tflops_per_gpu)
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402
from repro_torch.telemetry.source import GridSource  # noqa: E402
from repro_torch.telemetry.source import SimulatorSource as _SimulatorSource  # noqa: E402


@dataclass
class SimulatorSource(_SimulatorSource):
    """The port's source on the CPU (it defaults to the card)."""

    device: object = "cpu"


def simulate_devices(*args, **kw):
    """The port's engine on the CPU, its grid copied to host NumPy (the
    reference tests use it to make data for traces and grid sources)."""
    kw.setdefault("device", "cpu")
    g = _simulate_devices(*args, **kw)
    return DeviceGrid(g.interval_s, g.tpa.numpy(), g.clock_mhz.numpy(),
                      t0_s=g.t0_s)


def simulate_fleet(*args, **kw):
    kw.setdefault("device", "cpu")
    return _simulate_fleet(*args, **kw)


# ===========================================================================
# test_collector.py: Collector daemon + windowed rollup coverage:
# ===========================================================================
COL_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)


def _dense_series(seed, n_buckets=30, bucket_s=60.0, per_bucket=8):
    """(t, v) samples hitting every bucket (regression-shaped: collapse)."""
    rng = np.random.default_rng(seed)
    t = np.concatenate([(b + rng.uniform(0.05, 0.95, per_bucket)) * bucket_s
                        for b in range(n_buckets)])
    level = np.where(np.arange(n_buckets) < n_buckets // 2, 0.42, 0.17)
    v = np.concatenate([level[b] + rng.normal(0, 0.01, per_bucket)
                        for b in range(n_buckets)])
    return t, np.clip(v, 0, 1.05)


# ---------------------------------------------------------------------------
# WindowedRollup: eviction transparency, merge laws, wire format
# ---------------------------------------------------------------------------
def test_windowed_matches_fresh_rollup_over_retained_span():
    win = WindowedRollup(bucket_s=60, retain=8)
    fresh = StreamingRollup(bucket_s=60)
    for seed, jid in ((1, "a"), (2, "b")):
        t, v = _dense_series(seed)
        win.observe(jid, t, v, group="bf16", weight=3.0)
        fresh.observe(jid, t, v, group="bf16", weight=3.0)
    b0 = win.bucket0
    assert b0 == 30 - 8 and win.n_buckets == 8
    for jid in ("a", "b"):
        sw, sf = win.job_stats(jid), fresh.job_stats(jid)
        np.testing.assert_array_equal(sw.mean, sf.mean[b0:])
        np.testing.assert_array_equal(sw.weight, sf.weight[b0:])
        for q in (10, 50, 90):
            np.testing.assert_array_equal(sw.percentiles[q],
                                          sf.percentiles[q][b0:])
        np.testing.assert_allclose(sw.centers_s, sf.centers_s[b0:])
        # detector output over the retained span is identical
        regs_w = detect_regressions(win.job_ofu(jid), window=3,
                                    min_duration=1)
        regs_f = detect_regressions(fresh.job_ofu(jid)[b0:], window=3,
                                    min_duration=1)
        assert [(r.start_idx, r.end_idx, r.factor) for r in regs_w] \
            == [(r.start_idx, r.end_idx, r.factor) for r in regs_f]


def test_windowed_alltime_conserves_evicted_mass():
    win = WindowedRollup(bucket_s=60, retain=5)
    fresh = StreamingRollup(bucket_s=60)
    t, v = _dense_series(3)
    win.observe("j", t, v, weight=2.0)
    fresh.observe("j", t, v, weight=2.0)
    at = win.fleet_alltime(qs=(50,))
    f = fresh.fleet_stats(qs=())
    w_total = float(np.nansum(f.weight))
    assert np.isclose(at["weight"], w_total)
    assert np.isclose(at["mean"],
                      float(np.nansum(f.mean * f.weight)) / w_total)
    assert np.isfinite(at["percentiles"][50])
    # job-level lifetime view survives full eviction of early buckets
    assert np.isclose(win.job_alltime("j")["weight"], w_total)


def _windowed(seed, retain=6):
    rng = np.random.default_rng(seed)
    roll = WindowedRollup(bucket_s=60, retain=retain)
    for _ in range(12):
        t = rng.uniform(1, rng.uniform(300, 1800), size=10)
        v = rng.uniform(0, 1.05, size=10)
        roll.observe(f"job{rng.integers(3)}", t, v,
                     group=("bf16", "fp8")[int(rng.integers(2))],
                     weight=float(rng.integers(1, 8)))
    return roll


def _assert_same_windowed(a: WindowedRollup, b: WindowedRollup):
    assert (a.bucket0, a.n_buckets, a.retain) \
        == (b.bucket0, b.n_buckets, b.retain)
    assert set(a._hists) == set(b._hists)
    for scope in a._hists:
        pad_a = np.pad(a._hists[scope],
                       ((0, a.n_buckets - a._hists[scope].shape[0]), (0, 0)))
        pad_b = np.pad(b._hists[scope],
                       ((0, b.n_buckets - b._hists[scope].shape[0]), (0, 0)))
        np.testing.assert_allclose(pad_a, pad_b, atol=1e-12)
    assert set(a._ev_hist) == set(b._ev_hist)
    for scope in a._ev_hist:
        np.testing.assert_allclose(a._ev_hist[scope], b._ev_hist[scope],
                                   atol=1e-12)
        assert np.isclose(a._ev_sum[scope], b._ev_sum[scope])


def test_windowed_merge_commutative_associative():
    def m(*seeds):
        out = WindowedRollup(bucket_s=60, retain=6)
        for s in seeds:
            out.merge(_windowed(s))
        return out

    _assert_same_windowed(m(1, 2), m(2, 1))
    left = m(1, 2).merge(_windowed(3))
    right = m(1).merge(m(2, 3))
    _assert_same_windowed(left, right)
    # tree_reduce over snapshots agrees too, any fanin
    red2 = tree_reduce([_windowed(s).to_bytes() for s in (1, 2, 3)], fanin=2)
    red3 = tree_reduce([_windowed(s) for s in (1, 2, 3)], fanin=3)
    assert isinstance(red2, WindowedRollup)
    _assert_same_windowed(left, red2)
    _assert_same_windowed(red2, red3)


def test_tree_reduce_mixed_plain_windowed_is_order_independent():
    plain = StreamingRollup(bucket_s=60)
    win = WindowedRollup(bucket_s=60, retain=5)
    rng = np.random.default_rng(0)
    t, v = rng.uniform(1, 900, 50), rng.uniform(0, 1.05, 50)
    plain.observe("a", t, v)
    win.observe("b", t, v)
    r1 = tree_reduce([plain.to_bytes(), win.to_bytes()])
    r2 = tree_reduce([win.to_bytes(), plain.to_bytes()])
    # the windowed element wins the accumulator regardless of host order
    assert isinstance(r1, WindowedRollup) and isinstance(r2, WindowedRollup)
    _assert_same_windowed(r1, r2)


def test_windowed_merge_guards():
    with pytest.raises(ValueError, match="retention"):
        WindowedRollup(bucket_s=60, retain=6).merge(
            WindowedRollup(bucket_s=60, retain=8))
    with pytest.raises(ValueError, match="WindowedRollup into a plain"):
        StreamingRollup(bucket_s=60).merge(WindowedRollup(bucket_s=60))
    # plain INTO windowed is fine: treated as a window starting at bucket 0
    plain = StreamingRollup(bucket_s=60)
    t, v = _dense_series(4)
    plain.observe("j", t, v)
    win = WindowedRollup(bucket_s=60, retain=5).merge(plain)
    assert win.bucket0 == plain.n_buckets - 5
    np.testing.assert_array_equal(win.job_stats("j").mean,
                                  plain.job_stats("j").mean[win.bucket0:])


def test_windowed_serialization_roundtrip():
    roll = _windowed(9)
    back = StreamingRollup.from_bytes(roll.to_bytes())   # self-describing
    assert isinstance(back, WindowedRollup)
    _assert_same_windowed(roll, back)
    assert back._job_meta == roll._job_meta
    a, b = roll.fleet_alltime(), back.fleet_alltime()
    assert np.isclose(a["mean"], b["mean"]) and a["weight"] == b["weight"]


# ---------------------------------------------------------------------------
# Adaptive scrape scheduling
# ---------------------------------------------------------------------------
def test_adaptive_tightens_on_spike_and_relaxes_when_quiet():
    cfg = AdaptiveConfig(min_interval_s=5.0, max_interval_s=30.0,
                         quiet_rounds=2)
    ctl = AdaptiveScrapeController(cfg)
    rng = np.random.default_rng(0)
    quiet = lambda: 0.4 + rng.normal(0, 0.005, 64)         # noqa: E731
    spiky = lambda: rng.choice([0.4, 0.15], 64)            # noqa: E731
    iv = 30.0
    iv = ctl.update("j", quiet(), iv)                      # builds baseline
    assert iv == 30.0
    iv = ctl.update("j", spiky(), iv)                      # variance spike
    assert iv == 15.0
    iv = ctl.update("j", spiky(), iv)                      # still spiking
    assert iv == 7.5
    history = [iv]
    for _ in range(6):                                     # quiet again
        iv = ctl.update("j", quiet(), iv)
        history.append(iv)
    assert history[-1] == 30.0                             # relaxed back
    assert all(cfg.min_interval_s <= h <= cfg.max_interval_s
               for h in history)


def test_adaptive_respects_interval_policy_bounds():
    ctl = AdaptiveScrapeController(AdaptiveConfig(min_interval_s=10.0,
                                                  max_interval_s=20.0,
                                                  quiet_rounds=1))
    rng = np.random.default_rng(1)
    iv = 20.0
    for k in range(20):   # alternate spiky/quiet; never leaves the bounds
        samples = rng.choice([0.4, 0.1], 64) if k % 2 \
            else 0.4 + rng.normal(0, 0.003, 64)
        iv = ctl.update("j", samples, iv)
        assert 10.0 <= iv <= 20.0 <= MAX_HW_AVG_WINDOW_S
    with pytest.raises(ValueError, match="averaging window"):
        AdaptiveConfig(max_interval_s=45.0)    # §IV-C ceiling is enforced


def test_collector_adaptive_retimes_source_on_event_boundary():
    streams = [JobStream("reg", SimulatorSource(
        COL_PROFILE, duration_s=4800, interval_s=30, n_devices=4, seed=2,
        events=[Event(2550, 4800, slowdown=2.5)]))]
    cfg = CollectorConfig(round_s=300, bucket_s=300, retain=8,
                          adaptive=AdaptiveConfig(min_interval_s=5.0,
                                                  episode_aware=False))
    col = Collector(streams, cfg)
    reports = col.run()
    ivs = [r.intervals["reg"] for r in reports]
    assert min(ivs) < 30.0          # tightened on the dispersion spike
    assert ivs[-1] == 30.0          # relaxed once the new level is quiet
    assert all(5.0 <= i <= MAX_HW_AVG_WINDOW_S for i in ivs)


def test_collector_episode_aware_holds_interval_while_alert_open():
    # same collapse, episode-aware (the default): once the regression
    # episode opens, the interval pins to the floor and HOLDS until the
    # run ends (the collapse never recovers), instead of relaxing the
    # moment the regressed level goes quiet
    streams = [JobStream("reg", SimulatorSource(
        COL_PROFILE, duration_s=4800, interval_s=30, n_devices=4, seed=2,
        events=[Event(2550, 4800, slowdown=2.5)]))]
    cfg = CollectorConfig(round_s=300, bucket_s=300, retain=8,
                          detector={"window": 3, "min_duration": 1},
                          adaptive=AdaptiveConfig(min_interval_s=5.0))
    col = Collector(streams, cfg)
    reports = col.run()
    ivs = [r.intervals["reg"] for r in reports]
    first_alert = next(r.round_idx for r in reports if r.alerts)
    assert "reg" in col.deduper.active_jobs       # still open at the end
    assert ivs[-1] == 5.0                         # pinned hot
    # every round after the episode opened ran at/below the pre-episode
    # cadence, stepping down to the floor and never relaxing
    tail = ivs[first_alert:]
    assert all(b <= a for a, b in zip(tail, tail[1:]))
    assert all(5.0 <= i <= MAX_HW_AVG_WINDOW_S for i in ivs)


# ---------------------------------------------------------------------------
# Collector: batch equivalence, alerts, fleet reduction
# ---------------------------------------------------------------------------
class _RecordingSource(SimulatorSource):
    """Captures every polled grid so the test can batch-ingest the same."""

    def poll(self, duration_s):
        grid = super().poll(duration_s)
        self.__dict__.setdefault("polled", []).append(grid)
        return grid


def test_collector_incremental_matches_batch_ingestion():
    src = _RecordingSource(COL_PROFILE, duration_s=3600, interval_s=30,
                           n_devices=3, seed=5,
                           events=[Event(1800, 3600, slowdown=2.5)])
    cfg = CollectorConfig(round_s=300, bucket_s=300, retain=12)
    col = Collector([JobStream("j", src, chips=96, group="bf16",
                               app_mfu=0.35)], cfg)
    col.run()
    batch = WindowedRollup(bucket_s=300, retain=12)
    for grid in src.polled:
        batch.add_grid("j", grid, group="bf16", chips=96, app_mfu=0.35)
    assert col.rollup.bucket0 == batch.bucket0
    np.testing.assert_array_equal(col.rollup.job_ofu("j"),
                                  batch.job_ofu("j"))
    np.testing.assert_array_equal(col.rollup.fleet_stats().mean,
                                  batch.fleet_stats().mean)
    regs_c = detect_regressions(col.rollup.job_ofu("j"), window=4,
                                min_duration=2)
    regs_b = detect_regressions(batch.job_ofu("j"), window=4, min_duration=2)
    assert [(r.start_idx, r.factor) for r in regs_c] \
        == [(r.start_idx, r.factor) for r in regs_b]


def test_collector_alert_fires_once_per_episode():
    streams = [JobStream("reg", SimulatorSource(
        COL_PROFILE, duration_s=7200, interval_s=30, n_devices=4, seed=2,
        events=[Event(3600, 7200, slowdown=2.5)]), chips=128)]
    col = Collector(streams, CollectorConfig(round_s=300, retain=24))
    col.run()
    regression_alerts = [a for a in col.alerts if a.kind == "regression"]
    assert len(regression_alerts) == 1         # dedup across ~12 hot rounds
    assert regression_alerts[0].factor > 1.8
    assert "reg" == regression_alerts[0].job_id


def test_collector_divergence_alert_and_dedup():
    # app reports 40% MFU but true duty is ~17%: miscalc signature
    src = SimulatorSource(StepProfile(mxu_time_s=0.34, step_time_s=2.0),
                          duration_s=1800, interval_s=30, n_devices=4, seed=3)
    col = Collector([JobStream("liar", src, chips=64, app_mfu=0.40)],
                    CollectorConfig(round_s=300))
    col.run()
    div = [a for a in col.alerts if a.kind == "divergence"]
    assert len(div) == 1 and div[0].job_id == "liar"


def test_alert_deduper_rearms_after_clear_rounds():
    key = ("j", "regression")
    d = AlertDeduper(clear_rounds=2)
    assert d.offer(key) is True                 # round 1: fires
    d.tick()
    assert d.offer(key) is False                # round 2: still active
    d.tick()
    d.tick()                                    # round 3: quiet #1
    assert key in d._active                     # not yet re-armed
    d.tick()                                    # round 4: quiet #2 -> retired
    assert d.offer(key) is True                 # round 5: fresh episode


def test_alert_deduper_tracks_drift_but_fires_distinct_episodes():
    d = AlertDeduper(clear_rounds=2, anchor_tolerance=4)
    assert d.offer(("j", "regression"), anchor=10) is True
    d.tick()
    # window eviction drifts the detected start a little: same episode
    assert d.offer(("j", "regression"), anchor=12) is False
    # a second, distant collapse fires while the first is still active
    assert d.offer(("j", "regression"), anchor=30) is True
    d.tick()
    assert d.offer(("j", "regression"), anchor=13) is False
    assert d.offer(("j", "regression"), anchor=29) is False


def test_collector_pages_second_distinct_collapse():
    # two separate dips: recover in between, collapse again much later —
    # the second episode must page even though the first is still in the
    # retained window (and is re-detected by every round's scan)
    streams = [JobStream("twice", SimulatorSource(
        COL_PROFILE, duration_s=9600, interval_s=30, n_devices=4, seed=4,
        events=[Event(1200, 2100, slowdown=2.5),
                Event(5400, 9600, slowdown=3.0)]), chips=64)]
    col = Collector(streams, CollectorConfig(round_s=300, retain=32))
    col.run()
    regs = [a for a in col.alerts if a.kind == "regression"]
    assert len(regs) == 2
    assert regs[0].round_idx < regs[1].round_idx


def test_adaptive_rebaselines_after_sustained_regime_change():
    ctl = AdaptiveScrapeController(AdaptiveConfig(min_interval_s=5.0,
                                                  quiet_rounds=2))
    rng = np.random.default_rng(2)
    iv = ctl.update("j", 0.4 + rng.normal(0, 0.005, 64), 30.0)
    # dispersion steps PERMANENTLY ~10x: must tighten, then re-baseline
    # and relax instead of pinning the interval at min forever
    ivs = []
    for _ in range(40):
        iv = ctl.update("j", rng.choice([0.45, 0.25], 64), iv)
        ivs.append(iv)
    assert min(ivs) == 5.0          # reacted hard to the shift
    assert ivs[-1] == 30.0          # absorbed the new regime, relaxed back


def test_adaptive_episode_driven_tighten_hold_relax_cycle():
    # the detector-aware satellite, at the controller level: an OPEN
    # episode tightens to the floor and holds even though dispersion is
    # perfectly calm; CLEARing re-enters the normal quiet-rounds relax
    cfg = AdaptiveConfig(min_interval_s=5.0, max_interval_s=30.0,
                         quiet_rounds=2)
    ctl = AdaptiveScrapeController(cfg)
    rng = np.random.default_rng(0)
    quiet = lambda: 0.4 + rng.normal(0, 0.003, 64)         # noqa: E731
    iv = ctl.update("j", quiet(), 30.0)                    # baseline
    assert iv == 30.0
    for want in (15.0, 7.5, 5.0, 5.0, 5.0):                # open episode
        iv = ctl.update("j", quiet(), iv, episode_open=True)
        assert iv == want                                  # tighten, hold
        check_ok = cfg.min_interval_s <= iv <= cfg.max_interval_s
        assert check_ok
    history = [iv]
    for _ in range(8):                                     # episode clear
        iv = ctl.update("j", quiet(), iv, episode_open=False)
        history.append(iv)
    assert history[-1] == 30.0                             # relaxed back
    # relaxation steps the quiet_rounds ladder: 5 -> 10 -> 20 -> 30
    from itertools import groupby
    assert [k for k, _ in groupby(history)] == [5.0, 10.0, 20.0, 30.0]
    # an episode mid-relax re-pins immediately
    iv = ctl.update("j", quiet(), 30.0, episode_open=True)
    assert iv == 15.0
    # episode_aware=False ignores the episode signal entirely
    off = AdaptiveScrapeController(AdaptiveConfig(episode_aware=False))
    off.update("k", quiet(), 30.0)
    assert off.update("k", quiet(), 30.0, episode_open=True) == 30.0


def test_deduper_active_jobs_tracks_open_episodes():
    d = AlertDeduper(clear_rounds=1)
    assert d.active_jobs == set()
    d.offer(("a", "regression"))
    d.offer(("b", "divergence"))
    d.tick()                       # end of the round that saw them
    assert d.active_jobs == {"a", "b"}
    d.tick()                       # clear_rounds=1: both retire unseen
    assert d.active_jobs == set()


def test_adaptive_tighten_clamps_degraded_interval_into_policy():
    # a degraded source at 120 s spikes: one half-step lands at 60 s,
    # still past the §IV-C ceiling — the tighten must clamp, not crash
    ctl = AdaptiveScrapeController(AdaptiveConfig())
    rng = np.random.default_rng(3)
    ctl.update("j", 0.4 + rng.normal(0, 0.003, 64), 120.0)   # baseline
    new = ctl.update("j", rng.choice([0.45, 0.1], 64), 120.0)
    assert new == MAX_HW_AVG_WINDOW_S


def test_adaptive_collector_tolerates_degraded_source_interval():
    # a strict=False source legitimately sits beyond the 30 s averaging
    # window; the controller must not crash it while leaving it untouched
    src = SimulatorSource(COL_PROFILE, duration_s=1800, interval_s=45.0,
                          n_devices=2, seed=0, strict=False)
    col = Collector([JobStream("degraded", src)],
                    CollectorConfig(round_s=300, adaptive=AdaptiveConfig()))
    with pytest.warns(RuntimeWarning, match="averaging window"):
        reports = col.run()
    assert all(r.intervals["degraded"] == 45.0 for r in reports)


def test_fleet_collector_rejects_unbounded_run():
    from repro_torch.telemetry.counters import SimulatedDeviceBackend
    from repro_torch.telemetry.source import BackendSource
    live = BackendSource([SimulatedDeviceBackend(COL_PROFILE)],
                         duration_s=float("inf"), interval_s=30.0)
    fc = FleetCollector([Collector([JobStream("live", live)],
                                   CollectorConfig(round_s=300))])
    with pytest.raises(ValueError, match="unbounded"):
        fc.run()
    assert len(fc.run(n_rounds=2)) == 2


def test_run_requires_n_rounds_for_custom_unbounded_source():
    class LivePoller(SimulatorSource):      # no finite duration_s
        pass

    src = LivePoller(COL_PROFILE, duration_s=float("inf"), interval_s=30.0)
    assert not src.bounded
    with pytest.raises(ValueError, match="unbounded.*live"):
        Collector([JobStream("live", src)]).run()
    # bounded run still works with an explicit budget
    reps = Collector([JobStream("live", src)],
                     CollectorConfig(round_s=300)).run(n_rounds=2)
    assert len(reps) == 2


def test_fleet_collector_reduces_to_single_process_state():
    def host(jid, seed):
        src = SimulatorSource(COL_PROFILE, duration_s=1800, interval_s=30,
                              n_devices=2, seed=seed)
        return Collector([JobStream(jid, src, chips=32)],
                         CollectorConfig(round_s=300, retain=6))

    fc = FleetCollector([host("a", 1), host("b", 2)], reduce_every=1)
    fc.run()
    assert fc.fleet is not None and set(fc.fleet.jobs) == {"a", "b"}
    # reduced fleet state == merging the hosts' rollups directly
    direct = fc.collectors[0].rollup.spawn_empty()
    for c in fc.collectors:
        direct.merge(c.rollup)
    np.testing.assert_allclose(fc.fleet.fleet_stats().mean,
                               direct.fleet_stats().mean, equal_nan=True)
    assert fc.scan() == {}                         # nothing regressed


def test_collector_config_guards():
    with pytest.raises(ValueError, match="round_s"):
        CollectorConfig(round_s=0)
    with pytest.raises(ValueError, match="at.*least one scrape"):
        CollectorConfig(round_s=20.0,
                        adaptive=AdaptiveConfig(max_interval_s=30.0))
    with pytest.raises(ValueError, match="duplicate"):
        src = SimulatorSource(COL_PROFILE, duration_s=60, interval_s=30)
        Collector([JobStream("x", src), JobStream("x", src)])
    with pytest.raises(ValueError, match="n_rounds"):
        from repro_torch.telemetry.counters import SimulatedDeviceBackend
        from repro_torch.telemetry.source import BackendSource
        be = BackendSource([SimulatedDeviceBackend(COL_PROFILE)],
                           duration_s=float("inf"), interval_s=30)
        Collector([JobStream("live", be)]).run()


# ---------------------------------------------------------------------------
# Chunked trace replay under the collector: poll rounds cross
# chunk boundaries exactly, and a snapshot restore resumes mid-trace
# ---------------------------------------------------------------------------
def _regressed_trace(tmp_path, fmt_suffix, chunk_samples=40):
    """A 1-hour 4-device trace with a 2.5x collapse at t=1800, recorded
    to disk (chunk span 1200 s deliberately misaligned with the 300 s
    collector round)."""
    from repro_torch.telemetry.source import write_trace
    grid = simulate_devices(COL_PROFILE, duration_s=3600, interval_s=30.0,
                            events=[Event(1800, 3600, slowdown=2.5)],
                            n_devices=4, seed=21)
    path = str(tmp_path / f"trace{fmt_suffix}")
    write_trace(grid, path, chunk_samples=chunk_samples)
    return path


def _replay_collector(path, **collector_kw):
    from repro_torch.telemetry.source import TraceReplaySource
    streams = [JobStream("traced", TraceReplaySource(path), chips=128,
                         group="bf16", app_mfu=0.38)]
    cfg = CollectorConfig(round_s=300, bucket_s=300, retain=6,
                          detector={"window": 3, "min_duration": 1})
    return Collector(streams, cfg, **collector_kw)


def _alert_keys(alerts):
    return [(a.round_idx, a.job_id, a.kind) for a in alerts]


def test_collector_chunked_replay_matches_inmemory_replay(tmp_path):
    """The same trace through a chunked columnar archive and through a
    fully-materialized CSV produces the same rounds, the same alert
    episodes, and the same final windowed state — while the archive path
    never holds more than O(chunk) samples."""
    ctr = _regressed_trace(tmp_path, ".ctr")
    csv = _regressed_trace(tmp_path, ".csv")
    col_c, col_m = _replay_collector(ctr), _replay_collector(csv)
    reps_c, reps_m = col_c.run(), col_m.run()

    assert [r.samples for r in reps_c] == [r.samples for r in reps_m]
    assert _alert_keys(col_c.alerts) == _alert_keys(col_m.alerts)
    assert any(a.kind == "regression" for a in col_c.alerts)
    np.testing.assert_allclose([a.factor for a in col_c.alerts],
                               [a.factor for a in col_m.alerts], atol=1e-9)
    fc, fm = col_c.rollup.fleet_stats(), col_m.rollup.fleet_stats()
    np.testing.assert_array_equal(fc.weight, fm.weight)
    np.testing.assert_allclose(fc.mean, fm.mean, atol=1e-12)
    np.testing.assert_array_equal(fc.percentiles[50], fm.percentiles[50])

    rd = col_c.streams[0].source.reader
    total = 4 * 120
    assert rd.peak_resident_samples < total / 2   # O(chunk), not O(trace)


def test_collector_resumes_after_snapshot_restore(tmp_path):
    """Kill the collector mid-trace, restore from its snapshot() in a
    fresh Collector, seek a fresh source to the old cursor: the resumed
    run fires the same alert episodes and converges to the same windowed
    state as the uninterrupted run."""
    from repro_torch.fleet.streaming import WindowedRollup
    from repro_torch.telemetry.source import TraceReplaySource

    ctr = _regressed_trace(tmp_path, ".ctr")
    straight = _replay_collector(ctr)
    straight_reports = straight.run()

    first = _replay_collector(ctr)
    for _ in range(4):                       # die after round 4 (t=1200)
        first.poll_round()
    snap = first.snapshot()
    cursor = first.streams[0].source.cursor_s
    assert not first.alerts                  # collapse starts at t=1800

    resumed_src = TraceReplaySource(ctr)     # fresh process, same archive
    resumed_src.seek(cursor)
    resumed = _replay_collector(
        ctr, rollup=WindowedRollup.from_bytes(snap),
        clock_s=first.clock_s, round_idx=first.round_idx)
    resumed.streams[0].source.seek(cursor)
    resumed_reports = resumed.run()

    assert resumed_reports[0].round_idx == 5
    assert [r.samples for r in resumed_reports] \
        == [r.samples for r in straight_reports[4:]]
    # the collapse pages once, in the same round, on both runs
    assert _alert_keys(resumed.alerts) == _alert_keys(straight.alerts)
    fs, fr = straight.rollup.fleet_stats(), resumed.rollup.fleet_stats()
    np.testing.assert_array_equal(fs.weight, fr.weight)
    np.testing.assert_allclose(fs.mean, fr.mean, atol=1e-12)
    np.testing.assert_array_equal(fs.percentiles[50], fr.percentiles[50])
    assert straight.rollup.bucket0 == resumed.rollup.bucket0


def test_collector_rejects_mismatched_restored_rollup(tmp_path):
    from repro_torch.fleet.streaming import WindowedRollup
    ctr = _regressed_trace(tmp_path, ".ctr")
    with pytest.raises(ValueError, match="does not match config"):
        _replay_collector(ctr, rollup=WindowedRollup(bucket_s=60,
                                                     retain=6))


# ===========================================================================
# test_goodput.py: `fleet.goodput` coverage: the streaming
# ===========================================================================
F_MAX = DEFAULT_CHIP.f_max_mhz


def _good_grid(tpa_rows, interval=60.0, t0=0.0, clock=None):
    tpa = np.asarray(tpa_rows, float)
    clk = np.full_like(tpa, F_MAX) if clock is None \
        else np.asarray(clock, float)
    return DeviceGrid(interval, tpa, clk, t0_s=t0)


# ---------------------------------------------------------------------------
# merge consistency: tree_reduce of per-host rollups == one-shot ingest
# ---------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(st.integers(1, 3), st.integers(2, 5), st.integers(2, 12),
       st.integers(0, 10 ** 6), st.booleans())
def test_from_rollup_is_merge_consistent(n_jobs, n_hosts, n_samples, seed,
                                         windowed):
    rng = np.random.default_rng(seed)
    make = (lambda: WindowedRollup(60.0, retain=8, bins=32)) if windowed \
        else (lambda: StreamingRollup(60.0, bins=32))
    single = make()
    hosts = [make() for _ in range(n_hosts)]
    for j in range(n_jobs):
        n_dev = n_hosts * int(rng.integers(1, 3))
        tpa = rng.uniform(0.0, 1.0, size=(n_dev, n_samples))
        clock = rng.uniform(0.6, 1.0, size=(n_dev, n_samples)) * F_MAX
        grid = _good_grid(tpa, clock=clock)
        app_mfu = float(rng.uniform(0.1, 0.5)) if j % 2 == 0 else None
        kw = dict(app_mfu=app_mfu, arch="a", group="bf16")
        chips = 8 * (j + 1)
        single.add_grid(f"job-{j}", grid, chips=chips, **kw)
        # shard the DEVICE rows over hosts, as a per-host collector
        # would; each host claims its share of the job's chip footprint
        # (per-sample weight chips/n_dev on both sides)
        per_dev = chips / n_dev
        for h, rows in enumerate(host_partition(list(range(n_dev)),
                                                n_hosts)):
            if not rows:
                continue
            sub = _good_grid(tpa[rows], clock=clock[rows])
            hosts[h].add_grid(f"job-{j}", sub,
                              chips=per_dev * len(rows), **kw)
    reduced = tree_reduce([h.to_bytes() for h in hosts])
    a = from_rollup(single)
    b = from_rollup(reduced)
    assert a.chip_hours == pytest.approx(b.chip_hours, rel=1e-9)
    assert a.weighted_ofu == pytest.approx(b.weighted_ofu, rel=1e-6)
    assert a.app_mfu_coverage == pytest.approx(b.app_mfu_coverage,
                                               rel=1e-9)
    assert [j for j, _ in a.waste_ranking] \
        == [j for j, _ in b.waste_ranking]
    for (_, wa), (_, wb) in zip(a.waste_ranking, b.waste_ranking):
        assert wa == pytest.approx(wb, rel=1e-6, abs=1e-9)


# ---------------------------------------------------------------------------
# degenerate inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda: StreamingRollup(60.0), lambda: WindowedRollup(60.0, retain=4)])
def test_from_rollup_empty_is_zero_not_nan(make):
    fr = from_rollup(make())
    assert fr.chip_hours == 0.0
    assert fr.weighted_ofu == 0.0 and np.isfinite(fr.weighted_ofu)
    assert fr.app_mfu_coverage == 0.0
    assert fr.ofu_coverage == 1.0 and fr.waste_ranking == []


def test_from_rollup_all_idle_buckets():
    roll = WindowedRollup(60.0, retain=8)
    roll.add_grid("idle", _good_grid(np.zeros((2, 6))), chips=4)
    fr = from_rollup(roll, healthy_ofu=0.4)
    assert fr.chip_hours > 0
    assert fr.weighted_ofu == 0.0
    # a fully idle job is 100% recoverable waste
    (jid, waste) = fr.waste_ranking[0]
    assert jid == "idle" and waste == pytest.approx(fr.chip_hours)


def test_from_rollup_validates_healthy_ofu():
    roll = StreamingRollup(60.0)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="healthy_ofu"):
            from_rollup(roll, healthy_ofu=bad)


def test_batch_rollup_empty_fleet():
    fr = rollup([])
    assert isinstance(fr, FleetRollup)
    assert fr.chip_hours == 0.0 and fr.weighted_ofu == 0.0


def test_goodput_from_rollup_is_the_package_alias():
    assert goodput_from_rollup is from_rollup
    import repro_torch.fleet as fleet
    assert fleet.goodput_from_rollup is from_rollup


# ---------------------------------------------------------------------------
# scan_goodput: the fleet-wide drop detector
# ---------------------------------------------------------------------------
def _fleet_roll(levels, per_bucket=4, interval=60.0, bucket_s=240.0):
    """One job whose per-bucket OFU follows `levels` (clock at f_max so
    OFU == tpa)."""
    roll = WindowedRollup(bucket_s, retain=len(levels))
    tpa = np.repeat(np.asarray(levels, float),
                    per_bucket)[None, :]
    roll.add_grid("j", _good_grid(tpa, interval=interval))
    return roll


def test_scan_goodput_detects_a_sustained_drop():
    roll = _fleet_roll([0.5] * 8 + [0.2] * 4)
    (ev,) = scan_goodput(roll, drop_threshold=0.25, window=4,
                         min_duration=2)
    # detector convention: start = trigger - min_duration + 1, and the
    # reported low averages the sustain window (first point straddles)
    assert ev.start_idx in (7, 8) and ev.end_idx is None
    assert ev.drop_frac == pytest.approx(0.55, abs=0.1)
    assert ev.ref_ofu == pytest.approx(0.5, abs=0.02)
    assert 0.15 < ev.low_ofu < 0.3


def test_scan_goodput_recovered_drop_has_end():
    roll = _fleet_roll([0.5] * 6 + [0.1] * 3 + [0.5] * 3)
    (ev,) = scan_goodput(roll, drop_threshold=0.25, window=4,
                         min_duration=2)
    assert ev.start_idx in (5, 6) and ev.end_idx is not None


def test_scan_goodput_silent_on_healthy_and_empty():
    assert scan_goodput(_fleet_roll([0.5] * 12)) == []
    # a drop smaller than the threshold stays silent too
    assert scan_goodput(_fleet_roll([0.5] * 8 + [0.45] * 4),
                        drop_threshold=0.25) == []
    assert scan_goodput(WindowedRollup(240.0, retain=8)) == []


def test_scan_goodput_validates_threshold():
    roll = _fleet_roll([0.5] * 8)
    for bad in (0.0, 1.0, -0.5, 2.0):
        with pytest.raises(ValueError, match="drop_threshold"):
            scan_goodput(roll, drop_threshold=bad)


def test_fleet_ofu_forward_fills_gap_buckets():
    roll = WindowedRollup(60.0, retain=12)
    # two grids with a 3-bucket silence between them
    roll.add_grid("j", _good_grid(np.full((1, 4), 0.5), interval=60.0, t0=0.0))
    roll.add_grid("j", _good_grid(np.full((1, 2), 0.3), interval=60.0,
                             t0=7 * 60.0))
    filled = roll.fleet_ofu()
    assert not np.isnan(filled).any()
    np.testing.assert_allclose(filled[4:7], 0.5)      # held, not NaN
    raw = roll.fleet_ofu(fill=False)
    assert np.isnan(raw[4:7]).all()


# ===========================================================================
# test_fleet_distributed.py: Distributed rollups: merge is associative/commutative, the wire format
# ===========================================================================
def _random_rollup(seed, n_obs=5, bucket_s=60.0):
    rng = np.random.default_rng(seed)
    roll = StreamingRollup(bucket_s=bucket_s)
    for k in range(n_obs):
        t = rng.uniform(1, 900, size=rng.integers(3, 40))
        v = rng.uniform(0, 1.05, size=len(t))
        roll.observe(f"job{rng.integers(4)}", t, v,
                     group=("bf16", "fp8")[int(rng.integers(2))],
                     weight=float(rng.integers(1, 64)))
    return roll


def _assert_same_state(a: StreamingRollup, b: StreamingRollup,
                       atol=1e-12) -> None:
    assert set(a._hists) == set(b._hists)
    assert a.n_buckets == b.n_buckets
    for scope in a._hists:
        ha, hb = a._hists[scope], b._hists[scope]
        np.testing.assert_allclose(np.pad(ha, ((0, a.n_buckets - ha.shape[0]),
                                               (0, 0))),
                                   np.pad(hb, ((0, b.n_buckets - hb.shape[0]),
                                               (0, 0))), atol=atol)
        np.testing.assert_allclose(np.pad(a._sums[scope],
                                          (0, a.n_buckets - len(a._sums[scope]))),
                                   np.pad(b._sums[scope],
                                          (0, b.n_buckets - len(b._sums[scope]))),
                                   atol=atol)


def _merged(*rolls):
    out = StreamingRollup.from_bytes(rolls[0].to_bytes())
    for r in rolls[1:]:
        out.merge(r)
    return out


def test_merge_commutative():
    a, b = _random_rollup(1), _random_rollup(2)
    _assert_same_state(_merged(a, b), _merged(b, a))


def test_merge_associative():
    a, b, c = (_random_rollup(s) for s in (3, 4, 5))
    left = _merged(_merged(a, b), c)
    right = _merged(a, _merged(b, c))
    _assert_same_state(left, right)
    # inputs untouched by the copies
    _assert_same_state(a, _random_rollup(3))


def test_merge_rejects_mismatched_bucketing():
    a = StreamingRollup(bucket_s=60)
    with pytest.raises(ValueError, match="bucketing"):
        a.merge(StreamingRollup(bucket_s=300))
    with pytest.raises(ValueError, match="bucketing"):
        a.merge(StreamingRollup(bucket_s=60, bins=64))


def test_serialization_roundtrip():
    roll = _random_rollup(9)
    roll._job_meta["job1"] = {"chips": 64, "app_mfu": 0.4, "arch": "dense",
                              "flops_variant": "exact"}
    back = StreamingRollup.from_bytes(roll.to_bytes())
    _assert_same_state(roll, back, atol=0.0)      # wire format is lossless
    assert back._job_meta == roll._job_meta
    assert back.bucket_s == roll.bucket_s and back.bins == roll.bins
    np.testing.assert_array_equal(back.edges, roll.edges)
    f0, f1 = roll.fleet_stats(), back.fleet_stats()
    np.testing.assert_array_equal(f0.mean, f1.mean)
    np.testing.assert_array_equal(f0.percentiles[50], f1.percentiles[50])


def test_tree_reduce_matches_single_process_ingestion():
    """The acceptance property: per-host rollups reduced tree-wise give
    the same fleet dashboard as ingesting every job on one process."""
    specs = [JobSpec(f"j{i}", "granite-3-2b", chips=32,
                     true_duty=0.2 + 0.03 * (i % 8),
                     duration_s=600 + 300 * (i % 3), seed=i,
                     events=[Event(300, 600, slowdown=2.0)] if i == 5 else ())
             for i in range(12)]
    tels = simulate_fleet(specs, max_devices=4)
    single = StreamingRollup(bucket_s=120)
    for t in tels:
        single.add_job(t)
    hosts = host_partition(tels, 5)
    assert [len(h) for h in hosts] == [3, 3, 2, 2, 2]
    blobs = []
    for host_tels in hosts:
        local = StreamingRollup(bucket_s=120)
        for t in host_tels:
            local.add_job(t)
        blobs.append(local.to_bytes())            # ship kilobytes, not scrapes
    for fanin in (2, 3, 16):
        fleet = tree_reduce(blobs, fanin=fanin)
        _assert_same_state(single, fleet)
        assert sorted(fleet.jobs) == sorted(single.jobs)
        fs, ss = fleet.fleet_stats(), single.fleet_stats()
        np.testing.assert_allclose(fs.mean, ss.mean, atol=1e-12)
        for q in (10, 50, 90):
            np.testing.assert_allclose(fs.percentiles[q], ss.percentiles[q],
                                       atol=1e-12)
        # the reduced dashboard still answers per-job queries
        np.testing.assert_allclose(fleet.job_ofu("j5"), single.job_ofu("j5"),
                                   atol=1e-12)


def test_analyze_rollup_requires_app_mfu_metadata():
    from repro_torch.fleet.divergence import analyze_rollup

    roll = _random_rollup(11)                 # observed without metadata
    with pytest.raises(ValueError, match="app-MFU metadata"):
        analyze_rollup(roll)


def test_tree_reduce_edge_cases():
    a = _random_rollup(7)
    lone = tree_reduce([a])
    _assert_same_state(a, lone)
    assert lone is not a                          # inputs never mutated
    with pytest.raises(ValueError, match="at least one"):
        tree_reduce([])
    with pytest.raises(ValueError, match="fanin"):
        tree_reduce([a], fanin=1)
    with pytest.raises(ValueError, match="n_hosts"):
        host_partition([1, 2], 0)


# ===========================================================================
# test_correlation.py: OFU<->MFU correlation tier: the app-reporter ->
# ===========================================================================
CORR_PROFILE = StepProfile(mxu_time_s=0.84, step_time_s=2.0)
IDLE_PROFILE = StepProfile(mxu_time_s=0.002, step_time_s=2.0)


def _corr_grid(profile=CORR_PROFILE, seed=7, duration_s=1800.0, events=()):
    return simulate_devices(profile, duration_s=duration_s,
                            interval_s=30.0, events=list(events),
                            n_devices=2, seed=seed)


def _mfu_roll(series, bucket_s=300.0):
    """MfuRollup from {job_id: (t_s, mfu)} arrays."""
    roll = MfuRollup(bucket_s)
    for jid, (t, v) in series.items():
        roll.observe_series(jid, t, v)
    return roll


# ---------------------------------------------------------------------------
# MfuRollup: bucket rule, merge laws, wire round-trip
# ---------------------------------------------------------------------------
def test_mfu_bucket_rule_matches_counter_rollup():
    """Right-closed buckets, the ONE rule both rollups share: a sample
    AT a boundary belongs to the earlier bucket."""
    mfu = MfuRollup(bucket_s=300.0)
    ctr = StreamingRollup(bucket_s=300.0)
    for t in (0.0, 1.0, 299.9, 300.0, 300.1, 900.0):
        mfu.observe("j", t, 0.4)
        ctr.observe("j", np.array([t]), np.array([0.4]))
    idx, _ = mfu.job_series("j")
    rows = np.nonzero(ctr.job_stats("j", qs=()).weight > 0)[0]
    np.testing.assert_array_equal(idx, rows)     # [0, 1, 2]
    assert idx.tolist() == [0, 1, 2]


def test_observe_series_equals_repeated_observe():
    t = np.array([30.0, 60.0, 330.0, 610.0])
    v = np.array([0.3, 0.5, 0.4, 0.2])
    bulk, loop = MfuRollup(300.0), MfuRollup(300.0)
    bulk.observe_series("j", t, v)
    for ti, vi in zip(t, v):
        loop.observe("j", ti, vi)
    for roll in (bulk, loop):
        idx, mean = roll.job_series("j")
        assert idx.tolist() == [0, 1, 2]
        np.testing.assert_allclose(mean, [0.4, 0.4, 0.2])
    assert bulk.job_mean("j") == pytest.approx(loop.job_mean("j"))
    assert bulk.n_samples("j") == 4


def test_merge_is_commutative_and_payload_round_trips():
    a = _mfu_roll({"x": (np.array([30.0, 330.0]), np.array([0.3, 0.5]))})
    b = _mfu_roll({"x": (np.array([40.0]), np.array([0.7])),
                   "y": (np.array([630.0]), np.array([0.2]))})
    ab = a.copy().merge(b)
    ba = b.copy().merge(a)
    assert ab.to_payload() == ba.to_payload()
    # merge accumulated, operands untouched
    assert ab.job_mean("x") == pytest.approx((0.3 + 0.5 + 0.7) / 3)
    assert a.job_mean("x") == pytest.approx(0.4)
    # wire round-trip: apply_payload rebuilds the exact accumulator
    back = MfuRollup(300.0)
    assert back.apply_payload(ab.to_payload()) == 3   # bucket rows
    assert back.to_payload() == ab.to_payload()
    # raw-sample body (the POST /v1/mfu shape)
    raw = MfuRollup(300.0)
    n = raw.apply_payload(
        {"job_id": "j", "samples": [[30.0, 0.4], [90.0, 0.6]]})
    assert n == 2 and raw.job_mean("j") == pytest.approx(0.5)


@pytest.mark.parametrize("payload", [
    "not a dict",
    {"samples": [[0, 0.4]]},                       # missing job_id
    {"job_id": "j", "samples": [[1.0]]},           # not pairs
    {"job_id": "j", "samples": [["x", "y"]]},      # not numbers
    {"jobs": "nope"},                              # jobs not a dict
    {"jobs": {"j": [[0, -1.0, 0.4]]}},             # non-positive weight
    {"jobs": {"j": [[0, 1.0]]}},                   # not triples
    {"bucket_s": 60.0, "jobs": {"j": [[0, 1.0, 0.4]]}},  # bucket clash
])
def test_apply_payload_rejects_malformed(payload):
    with pytest.raises(ValueError):
        MfuRollup(300.0).apply_payload(payload)


def test_mfu_rollup_validation():
    with pytest.raises(ValueError):
        MfuRollup(0.0)
    roll = MfuRollup(300.0)
    with pytest.raises(ValueError):
        roll.observe("", 30.0, 0.4)
    with pytest.raises(ValueError):
        roll.observe("j", 30.0, 0.4, weight=0.0)
    with pytest.raises(ValueError):
        roll.observe_series("j", [1.0, 2.0], [0.4])
    with pytest.raises(ValueError):
        roll.merge(MfuRollup(60.0))
    assert roll.job_mean("absent") is None


# ---------------------------------------------------------------------------
# join + rolling r
# ---------------------------------------------------------------------------
def test_joined_series_intersects_on_absolute_buckets():
    ctr = StreamingRollup(bucket_s=300.0)
    # OFU in buckets 0..3
    t = np.arange(30.0, 1200.0 + 1e-9, 30.0)
    ctr.observe("j", t, np.full(t.size, 0.4))
    # MFU only in buckets 1, 2, and 9 (no counter data there)
    mfu = _mfu_roll({"j": (np.array([330.0, 630.0, 2730.0]),
                           np.array([0.41, 0.42, 0.9]))})
    idx, mval, oval = joined_series(mfu, ctr, "j")
    assert idx.tolist() == [1, 2]
    np.testing.assert_allclose(mval, [0.41, 0.42])
    np.testing.assert_allclose(oval, [0.4, 0.4])
    # either side missing the job -> empty join, not an error
    empty = joined_series(mfu, ctr, "ghost")
    assert all(arr.size == 0 for arr in empty)
    with pytest.raises(ValueError):
        joined_series(MfuRollup(60.0), ctr, "j")


def test_rolling_pearson_tracks_and_degrades_to_zero():
    x = np.linspace(0.1, 0.5, 12)
    r = rolling_pearson(x, 2.0 * x + 0.05, window=4)
    assert r[0] == 0.0                       # one point: undefined -> 0
    np.testing.assert_allclose(r[1:], 1.0, atol=1e-12)
    flat = rolling_pearson(np.full(6, 0.3), x[:6], window=4)
    assert np.all(flat == 0.0)               # zero variance, never NaN
    with pytest.raises(ValueError):
        rolling_pearson(x, x, window=1)
    with pytest.raises(ValueError):
        rolling_pearson(x, x[:-1])


# ---------------------------------------------------------------------------
# the miscalculation scan
# ---------------------------------------------------------------------------
def _ctr(series, bucket_s=300.0):
    roll = StreamingRollup(bucket_s=bucket_s)
    for jid, level in series.items():
        t = np.arange(30.0, 1800.0 + 1e-9, 30.0)
        roll.observe(jid, t, np.full(t.size, level))
    return roll


def test_scan_miscalc_flags_ratio_band_violations():
    ctr = _ctr({"ok": 0.40, "hot": 0.40, "cold": 0.40, "idle": 0.005})
    t = np.arange(30.0, 1800.0 + 1e-9, 30.0)
    mfu = _mfu_roll({
        "ok": (t, np.full(t.size, 0.42)),     # ratio 1.05: healthy
        "hot": (t, np.full(t.size, 1.20)),    # ratio 3.0: inflated
        "cold": (t, np.full(t.size, 0.10)),   # ratio 0.25: deflated
        "idle": (t, np.full(t.size, 0.40)),   # sub-floor OFU: exempt
    })
    found = {f.job_id: f for f in scan_miscalc(mfu, ctr)}
    assert set(found) == {"hot", "cold"}
    assert found["hot"].direction == "inflated"
    assert found["hot"].ratio == pytest.approx(3.0)
    assert found["hot"].tq_factor == 1.0      # unknown arch: identity
    assert found["cold"].direction == "deflated"
    # worst |log ratio| first
    assert [f.job_id for f in scan_miscalc(mfu, ctr)] == ["cold", "hot"]
    # the idle exemption is the floor's doing: floor 0 flags it too
    cfg = CorrelationConfig(ofu_floor=0.0)
    assert "idle" in {f.job_id for f in scan_miscalc(mfu, ctr, config=cfg)}
    # min_buckets guards thin joins
    thin = _mfu_roll({"hot": (np.array([330.0]), np.array([1.2]))})
    cfg = CorrelationConfig(min_buckets=2)
    assert scan_miscalc(thin, ctr, config=cfg) == []


def test_correlation_config_validation():
    assert CorrelationConfig().ratio_low == pytest.approx(1 / 1.5)
    for kw in ({"ratio_high": 1.0}, {"ratio_low": 1.2},
               {"min_buckets": 0}, {"window": 1}):
        with pytest.raises(ValueError):
            CorrelationConfig(**kw)


def test_tile_quant_factor_identity_for_unknown_arch():
    assert tile_quant_factor("no-such-arch") == 1.0
    tq = tile_quant_factor("llama3.2-3b")
    assert 0.5 < tq <= 1.0


def test_analyze_correlation_degenerate_populations_stay_finite():
    # empty: all zeros, strict-JSON clean
    rep = analyze_correlation(MfuRollup(300.0), _ctr({}))
    assert (rep.n_jobs, rep.r_all, rep.r_clean, rep.mae) == (0, 0, 0, 0)
    json.dumps(rep.to_payload(), allow_nan=False)
    # one job / zero-variance population: r guards to 0.0, never NaN
    ctr = _ctr({"only": 0.40})
    t = np.arange(30.0, 1800.0 + 1e-9, 30.0)
    rep = analyze_correlation(
        _mfu_roll({"only": (t, np.full(t.size, 0.42))}), ctr)
    assert rep.n_jobs == 1 and rep.r_all == 0.0 and rep.r_clean == 0.0
    assert rep.mae == pytest.approx(0.02)
    json.dumps(rep.to_payload(), allow_nan=False)


# ---------------------------------------------------------------------------
# divergence bugfixes: idle-job floor, degenerate r
# ---------------------------------------------------------------------------
def test_divergence_idle_job_exempt_below_ofu_floor():
    """A parked job (OFU ~0.1%) with any reported MFU used to dominate
    the flag list through the rel_err denominator; the floor exempts it
    from flagging without dropping it from the statistics."""
    pts = [JobPoint("busy", "llama3.2-3b", 64, mfu=0.41, ofu=0.40),
           JobPoint("busy2", "llama3.2-3b", 64, mfu=0.30, ofu=0.29),
           JobPoint("idle", "llama3.2-3b", 8, mfu=0.05, ofu=0.001)]
    rep = analyze(pts, flag_rel_err=0.30)
    assert [p.job_id for p in rep.flagged] == []
    # still counted in the population statistics
    assert 8 in rep.by_scale
    # floor 0 restores the old (buggy) behaviour on demand
    rep0 = analyze(pts, flag_rel_err=0.30, ofu_floor=0.0)
    assert [p.job_id for p in rep0.flagged] == ["idle"]
    assert DEFAULT_OFU_FLOOR == pytest.approx(0.02)


def test_divergence_degenerate_population_is_nan_free():
    one = analyze([JobPoint("a", "x", 8, mfu=0.4, ofu=0.4)])
    assert one.r_all == 0.0 and one.r_clean == 0.0
    assert np.isfinite(one.mae_all)
    empty = analyze_rollup(StreamingRollup(300.0), empty_ok=True)
    assert empty is None
    with pytest.raises(ValueError):
        analyze_rollup(StreamingRollup(300.0))


# ---------------------------------------------------------------------------
# live collector: MFU streams feed the rollup, miscalc alerts fire
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def miscalc_collector():
    """Two healthy jobs + one whose reporter claims ~3x its OFU."""
    grids = {name: _corr_grid(seed=s) for name, s in
             (("ok-a", 11), ("ok-b", 12), ("bad", 13))}
    ofu_level = {}
    for name, grid in grids.items():
        probe = StreamingRollup(bucket_s=300.0)
        probe.add_grid(name, grid)
        st = probe.job_stats(name, qs=())
        ofu_level[name] = float(np.nansum(st.mean * st.weight)
                                / np.nansum(st.weight))
    factor = {"ok-a": 1.03, "ok-b": 0.98, "bad": 3.0}
    streams = [JobStream(
        name, GridSource(grid), chips=64,
        mfu_source=MfuReplaySource.constant(
            factor[name] * ofu_level[name], duration_s=1800.0,
            interval_s=30.0))
        for name, grid in grids.items()]
    col = Collector(streams, CollectorConfig(round_s=300.0,
                                             bucket_s=300.0))
    col.run()
    return col, ofu_level, factor


def test_collector_streams_mfu_and_flags_miscalc(miscalc_collector):
    col, ofu_level, factor = miscalc_collector
    # every stream's samples landed in the collector's MfuRollup
    for name, lvl in ofu_level.items():
        assert col.mfu.n_samples(name) == 60            # 1800 / 30
        assert col.mfu.job_mean(name) == pytest.approx(factor[name] * lvl)
        # divergence metadata follows the reporter, not a static scalar
        meta = col.rollup.job_meta(name)
        assert meta["app_mfu"] == pytest.approx(factor[name] * lvl)
    flagged = {a.job_id for a in col.alerts if a.kind == "miscalc"}
    assert flagged == {"bad"}
    # unanchored population-level episode: fires once, stays active
    alerts = [a for a in col.alerts if a.kind == "miscalc"]
    assert len(alerts) == 1 and ("bad", "miscalc") in col.deduper.active


def test_collector_miscalc_none_disables_detector():
    grid = _corr_grid(seed=13)
    streams = [JobStream("bad", GridSource(grid), chips=64,
                         mfu_source=MfuReplaySource.constant(
                             1.5, duration_s=1800.0, interval_s=30.0))]
    col = Collector(streams, CollectorConfig(round_s=300.0, bucket_s=300.0,
                                             miscalc=None))
    col.run()
    assert not [a for a in col.alerts if a.kind == "miscalc"]


# ---------------------------------------------------------------------------
# serve path: /v1/query kinds, POST /v1/mfu, client surface
# ---------------------------------------------------------------------------
def test_correlation_through_live_serve(miscalc_collector):
    col, ofu_level, factor = miscalc_collector
    store = FleetStore()
    store.update_from(col)
    agg = IngestAggregator(n_shards=1)
    with FleetAPIServer(store, aggregator=agg) as server:
        client = FleetClient(server.url)
        corr = client.correlation()
        assert corr["n_jobs"] == 3
        assert {f["job_id"] for f in corr["flagged"]} == {"bad"}
        f = next(f for f in corr["flagged"] if f["job_id"] == "bad")
        assert f["ratio"] == pytest.approx(3.0, rel=0.05)
        assert f["direction"] == "inflated"
        by_job = {row["job_id"]: row for row in corr["jobs"]}
        assert by_job["bad"]["flagged"] and not by_job["ok-a"]["flagged"]
        # parameter plumbing: a wide-open band flags nothing
        assert client.correlation(ratio_high=10.0)["flagged"] == []
        # identical query rides the generation cache (same dict)
        assert client.correlation() == corr
        json.dumps(corr, allow_nan=False)

        # POST /v1/mfu -> aggregator -> publish -> visible in the store
        t = np.arange(30.0, 1800.0 + 1e-9, 30.0)
        out = client.post_mfu(
            "posted", [[float(ti), 0.35] for ti in t])
        assert out["applied"] == t.size
        agg.publish(store, clock_s=col.clock_s)
        stats = client._get("/v1/ingest")
        assert stats["mfu_jobs"] == 1 and stats["mfu_rows"] == t.size

        # malformed body is a JSON 400, not a traceback
        req = urllib.request.Request(
            server.url + "/v1/mfu", data=b"{not json",
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read().decode())
        with pytest.raises(FleetAPIError) as ce:
            client.post_mfu("", [[30.0, 0.4]])
        assert ce.value.status == 400


def test_post_mfu_without_aggregator_is_404():
    store = FleetStore()
    with FleetAPIServer(store) as server:
        with pytest.raises(FleetAPIError) as ei:
            FleetClient(server.url).post_mfu("j", [[30.0, 0.4]])
        assert ei.value.status == 404


def test_divergence_floor_and_degenerate_through_query():
    """The two bugfixes, regression-tested end to end over HTTP."""
    roll = StreamingRollup(bucket_s=300.0)
    roll.add_grid("healthy", _corr_grid(seed=31), chips=64, app_mfu=0.38)
    roll.add_grid("healthy2", _corr_grid(
        CORR_PROFILE, seed=32,
        events=[Event(0.0, 1800.0, slowdown=1.4)]), chips=64, app_mfu=0.28)
    roll.add_grid("idle", _corr_grid(IDLE_PROFILE, seed=33), chips=8,
                  app_mfu=0.05)
    store = FleetStore()
    store.update(roll)
    with FleetAPIServer(store) as server:
        client = FleetClient(server.url)
        div = client.divergence()
        assert "idle" not in {f["job_id"] for f in div["flagged"]}
        div0 = client.divergence(ofu_floor=0.0)
        assert "idle" in {f["job_id"] for f in div0["flagged"]}
        json.dumps(div, allow_nan=False)

    # degenerate population (one reporting job): finite zeros over HTTP
    lone = StreamingRollup(bucket_s=300.0)
    lone.add_grid("only", _corr_grid(seed=34), chips=64, app_mfu=0.40)
    store2 = FleetStore()
    store2.update(lone)
    with FleetAPIServer(store2) as server:
        div = FleetClient(server.url).divergence()
        assert div["r_all"] == 0.0 and div["r_clean"] == 0.0
        json.dumps(div, allow_nan=False)
        corr = FleetClient(server.url).correlation()
        assert corr["n_jobs"] == 0 and corr["flagged"] == []


# ---------------------------------------------------------------------------
# the reporter: log lines -> samples -> sources
# ---------------------------------------------------------------------------
MEGATRON_LINE = (" iteration {it}/ 1000 | consumed samples: 4096 | "
                 "elapsed time per iteration (ms): {ms} | "
                 "throughput per GPU (TFLOP/s/GPU): {tfl} | "
                 "learning rate: 3.0E-04 |")


def test_extract_tflops_parses_megatron_lines():
    lines = [MEGATRON_LINE.format(it=10, ms="2100.5", tfl="412.3"),
             "saving checkpoint at iteration 10",
             MEGATRON_LINE.format(it=20, ms="2050.0", tfl="430.1")]
    recs = extract_tflops_from_log("\n".join(lines))
    assert [r["iteration"] for r in recs] == [10, 20]
    assert recs[0]["tflops_per_gpu"] == pytest.approx(412.3)
    assert recs[1]["elapsed_ms"] == pytest.approx(2050.0)


def test_reporter_clock_follows_elapsed_ms():
    rep = MfuReporter("j", peak_tflops=1000.0)
    out = rep.feed_log([
        MEGATRON_LINE.format(it=1, ms="2000.0", tfl="400.0"),
        "noise line",
        MEGATRON_LINE.format(it=2, ms="3000.0", tfl="500.0")])
    assert [s.t_s for s in out] == [2.0, 5.0]
    assert out[0].mfu == pytest.approx(0.4)
    assert out[1].iteration == 2
    # explicit t_s pins and resets the clock
    s = rep.feed(MEGATRON_LINE.format(it=3, ms="2000.0", tfl="600.0"),
                 t_s=100.0)
    assert s.t_s == 100.0 and rep.samples[-1].mfu == pytest.approx(0.6)
    # to_source round-trips through poll semantics
    src = rep.to_source()
    t, v = src.poll(10.0)
    assert t.tolist() == [2.0, 5.0]
    assert not src.exhausted
    t, v = src.poll(1000.0)
    assert t.tolist() == [100.0] and src.exhausted


def test_reporter_anchors_to_log_wall_clock():
    """Timestamped Megatron lines pin sample times to REAL wall time:
    a checkpoint stall between iterations (elapsed-ms never sees it)
    must not desync the samples from absolute time."""
    stamped = "[2026-08-09 {hms}] " + MEGATRON_LINE
    rep = MfuReporter("j", peak_tflops=1000.0)
    out = rep.feed_log([
        # first stamped line: accumulator position accepted, wall pinned
        stamped.format(hms="13:00:02", it=1, ms="2000.0", tfl="400.0"),
        # 58 wall seconds later — a stall ate ~55s the elapsed-ms field
        # (3000ms) never recorded
        stamped.format(hms="13:01:00", it=2, ms="3000.0", tfl="500.0")])
    assert [s.t_s for s in out] == [2.0, 60.0]   # wall delta, not 2+3
    # untimestamped lines fall back to the accumulator FROM the anchor
    s3 = rep.feed(MEGATRON_LINE.format(it=3, ms="2500.0", tfl="450.0"))
    assert s3.t_s == pytest.approx(62.5)
    # the next stamped line re-syncs onto the wall anchor
    s4 = rep.feed("2026-08-09 13:01:30,500 " + MEGATRON_LINE.format(
        it=4, ms="2000.0", tfl="480.0"))
    assert s4.t_s == pytest.approx(2.0 + 88.5)
    # a garbage almost-timestamp is not a timestamp
    from repro_torch.telemetry.mfu import extract_wall_time
    assert extract_wall_time("2026-13-40 99:99:99 oops") is None
    # an un-stamped log behaves exactly as before (accumulator only)
    plain = MfuReporter("j", peak_tflops=1000.0)
    outs = plain.feed_log([
        MEGATRON_LINE.format(it=1, ms="2000.0", tfl="400.0"),
        MEGATRON_LINE.format(it=2, ms="3000.0", tfl="500.0")])
    assert [s.t_s for s in outs] == [2.0, 5.0]


def test_replay_source_poll_contract():
    src = MfuReplaySource.constant(0.4, duration_s=300.0, interval_s=30.0)
    assert src.t_s.size == 10 and src.t_s[0] == 30.0
    t1, _ = src.poll(150.0)      # (0, 150]
    assert t1.tolist() == [30.0, 60.0, 90.0, 120.0, 150.0]
    t2, _ = src.poll(150.0)      # (150, 300]
    assert t2.size == 5 and src.exhausted
    src.seek(0.0)
    assert not src.exhausted
    with pytest.raises(ValueError):
        src.poll(0.0)
    with pytest.raises(ValueError):
        src.seek(-1.0)
    with pytest.raises(ValueError):
        MfuReplaySource([2.0, 1.0], [0.1, 0.2])    # non-monotone


def test_reported_tflops_reflects_miscalculated_counters():
    exact = reported_tflops_per_gpu("deepseek-v3-671b", 2.0, 288)
    naive = reported_tflops_per_gpu("deepseek-v3-671b", 2.0, 288,
                                    variant="naive_moe")
    assert naive / exact == pytest.approx(3.186, rel=1e-3)
    assert compute_mfu(400.0, 1000.0) == pytest.approx(0.4)
    with pytest.raises(ValueError):
        compute_mfu(400.0, 0.0)
    with pytest.raises(ValueError):
        reported_tflops_per_gpu("llama3.2-3b", 0.0, 64)


def test_client_post_mfu_accepts_sample_objects(miscalc_collector):
    col, _, _ = miscalc_collector
    store = FleetStore()
    store.update_from(col)
    agg = IngestAggregator(n_shards=1)
    samples = [MfuSample(t_s=30.0 * (k + 1), mfu=0.35,
                         tflops_per_gpu=350.0) for k in range(4)]
    with FleetAPIServer(store, aggregator=agg) as server:
        out = FleetClient(server.url).post_mfu("obj-job", samples)
    assert out["applied"] == 4
    stats = agg.stats()
    assert stats["mfu_rows"] == 4 and stats["mfu_jobs"] == 1
    # publishing folds the posted rows into the store's MFU generation
    probe = FleetStore()
    agg.publish(probe)
    assert probe._mfu is not None
    assert probe._mfu.job_mean("obj-job") == pytest.approx(0.35)


# ===========================================================================
# parity: the same seeded grids through both packages' collectors
# ===========================================================================
PARITY_CFG = dict(round_s=1800.0, bucket_s=300.0, retain=12, bins=128,
                  detector={"window": 4, "min_duration": 2},
                  goodput={"drop_threshold": 0.2, "window": 4,
                           "min_duration": 2})
#: job -> (base duty, collapse from sample, app MFU); chips = 4 x rows,
#: so every sample weighs exactly 4
PARITY_JOBS = {"steady": (0.45, None, 0.41), "slow": (0.42, 240, 0.40),
               "liar": (0.40, None, 0.75), "late": (0.38, 400, None)}


def _parity_grids(seed, n_dev=6, n_samples=480):
    """One seeded (tpa, clock) float32 pair per job: 4 h of 30 s scrapes,
    `slow` collapsing 2.5x at 2 h, `late` at 3 h 20 min."""
    rng = np.random.default_rng(seed)
    out = {}
    for jid, (duty, cut, _) in PARITY_JOBS.items():
        tpa = duty + 0.03 * rng.standard_normal((n_dev, n_samples))
        if cut is not None:
            tpa[:, cut:] /= 2.5
        clk = 1500.0 - 60.0 * rng.random((n_dev, n_samples))
        out[jid] = (np.clip(tpa, 0, 1).astype(np.float32),
                    clk.astype(np.float32))
    return out


def _collector(pkg, grids, *, as_tensor=False, **kw):
    """A collector of package `pkg` ('port' or 'ref') over GridSources of
    `grids`; the port's optionally over CPU tensors."""
    if pkg == "ref":
        C, src, G = R_collector, R_telemetry.GridSource, \
            R_telemetry.DeviceGrid
    else:
        C, src, G = T_collector, GridSource, DeviceGrid
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    streams = [C.JobStream(jid, src(G(30.0, wrap(t), wrap(c))),
                           chips=4 * t.shape[0], group="bf16",
                           app_mfu=PARITY_JOBS[jid][2], arch="llama3.2-3b")
               for jid, (t, c) in grids.items()]
    return C.Collector(streams, C.CollectorConfig(**PARITY_CFG), **kw)


def _alerts(col):
    return col.alert_state()["alerts"]


def _keys(col):
    return [(a.round_idx, a.job_id, a.kind) for a in col.alerts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_through_both_collectors_is_identical(seed):
    grids = _parity_grids(seed)
    mine, ref = _collector("port", grids), _collector("ref", grids)
    reps_m, reps_r = mine.run(), ref.run()
    assert [r.samples for r in reps_m] == [r.samples for r in reps_r]
    assert [r.rollup_summary for r in reps_m] \
        == [r.rollup_summary for r in reps_r]
    assert _alerts(mine) == _alerts(ref)
    kinds = {(a.job_id, a.kind) for a in mine.alerts}
    assert ("slow", "regression") in kinds and ("liar", "divergence") in kinds
    assert mine.snapshot() == ref.snapshot()
    assert mine.alert_state() == ref.alert_state()


def _assert_counts_equal(a, b):
    """Histogram counts bitwise (every sample weighs 4), sums to f32
    precision: the tensor path sums f32 OFU, the host path f64."""
    assert set(a._hists) == set(b._hists)
    for scope in a._hists:
        np.testing.assert_array_equal(a._hists[scope], b._hists[scope])
        np.testing.assert_allclose(a._sums[scope], b._sums[scope],
                                   rtol=1e-6)
    for scope in a._ev_hist:
        np.testing.assert_array_equal(a._ev_hist[scope], b._ev_hist[scope])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tensor_grids_match_the_host_path(seed):
    """The same grids as CPU tensors go through the port's tensor ingest
    (the histogram kernel's plain version): counts equal the NumPy
    path's, and the alerts agree by (round, job, kind)."""
    grids = _parity_grids(seed)
    host, dev = _collector("port", grids), \
        _collector("port", grids, as_tensor=True)
    assert [r.samples for r in host.run()] == [r.samples for r in dev.run()]
    _assert_counts_equal(dev.rollup, host.rollup)
    assert _keys(dev) == _keys(host) and _keys(host)
    assert dev.rollup.bucket0 == host.rollup.bucket0


def test_tensor_round_counts_samples_of_a_tensor_grid():
    """`grid.tpa.size` is a method on a tensor: the round's sample count
    and the empty-grid test must not use it."""
    grids = _parity_grids(3)
    col = _collector("port", grids, as_tensor=True)
    rep = col.poll_round()
    assert rep.samples == 4 * 6 * 60
    empty = JobStream("empty", GridSource(DeviceGrid(
        30.0, torch.empty((2, 0)), torch.empty((2, 0)))))
    col.add_stream(empty)
    assert col.poll_round().samples == 4 * 6 * 60


@pytest.mark.parametrize("cut_round", [2, 5])
def test_reference_snapshot_restores_into_the_port(cut_round):
    """A snapshot the reference's collector wrote, restored into the
    port's (`WindowedRollup.from_bytes`, clock, round and alert state),
    continues exactly as the reference's own restore does."""
    grids = _parity_grids(4)
    ref = _collector("ref", grids)
    ref.run(n_rounds=cut_round)
    snap, state = ref.snapshot(), ref.alert_state()
    cursors = {st.job_id: st.source.cursor_s for st in ref.streams}

    def resume(pkg, W):
        col = _collector(pkg, grids, rollup=W.from_bytes(snap),
                         clock_s=ref.clock_s, round_idx=ref.round_idx)
        col.restore_alert_state(state)
        for st in col.streams:
            st.source.seek(cursors[st.job_id])
        col.run()
        return col

    mine = resume("port", WindowedRollup)
    theirs = resume("ref", R_streaming.WindowedRollup)
    assert mine.round_idx == theirs.round_idx > cut_round
    assert _alerts(mine) == _alerts(theirs)
    assert mine.snapshot() == theirs.snapshot()
    # and the restored run ends where an uninterrupted one does
    whole = _collector("ref", grids)
    whole.run()
    assert _alerts(mine) == _alerts(whole)


@pytest.mark.parametrize("shape", [(1,), (2,), (6, 60), (0, 5)])
def test_count_std_tensor_matches_numpy(shape):
    x = np.random.default_rng(5).random(shape).astype(np.float32)
    n_t, s_t = _count_std(torch.from_numpy(x))
    n_h, s_h = _count_std(x)
    assert n_t == n_h == x.size
    if x.size < 2:
        assert np.isnan(s_t) and np.isnan(s_h)
    else:
        assert s_t == pytest.approx(float(np.std(x.astype(float))),
                                    rel=1e-12)
        assert s_h == pytest.approx(s_t, rel=1e-12)


def test_adaptive_controller_on_tensors_retimes_as_on_arrays():
    """The controller fed a round's OFU as a tensor (what the tensor
    ingest returns) retimes exactly as when fed the same values as an
    array."""
    rng = np.random.default_rng(6)
    ctl_t, ctl_h = AdaptiveScrapeController(), AdaptiveScrapeController()
    iv_t = iv_h = 30.0
    for r in range(12):
        spread = 0.2 if r in (5, 6) else 0.02
        x = (0.4 + spread * rng.standard_normal((4, 20))).astype(np.float32)
        iv_t = ctl_t.update("j", torch.from_numpy(x), iv_t,
                            episode_open=r == 9)
        iv_h = ctl_h.update("j", x, iv_h, episode_open=r == 9)
        assert iv_t == iv_h
    assert ctl_t._baseline["j"] == pytest.approx(ctl_h._baseline["j"],
                                                 rel=1e-9)


def test_adaptive_collector_on_a_cpu_simulator_source():
    """A retimable source simulating on the CPU (tensor grids): the
    controller reduces each round's OFU tensor and retimes the source."""
    src = SimulatorSource(COL_PROFILE, duration_s=3600, interval_s=30.0,
                          n_devices=4, seed=3,
                          events=[Event(1800, 3600, slowdown=2.5)])
    cfg = CollectorConfig(round_s=300.0, bucket_s=300.0, retain=24,
                          detector={"window": 3, "min_duration": 1},
                          adaptive=AdaptiveConfig(min_interval_s=10.0,
                                                  max_interval_s=30.0))
    col = Collector([JobStream("j", src, chips=32)], cfg)
    reps = col.run()
    assert sum(r.samples for r in reps) > 0
    assert {r.intervals["j"] for r in reps} - {30.0}
    assert [a.kind for a in col.alerts] == ["regression"]


@pytest.mark.gpu
def test_collector_on_card_grids_matches_their_host_copies():
    """A collector over grids on the card (the histogram kernel ingests
    them) against one over their host copies: counts equal, alerts by
    (round, job, kind) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    grids = _parity_grids(7)
    streams = [JobStream(jid, GridSource(DeviceGrid(
        30.0, torch.from_numpy(t).cuda(), torch.from_numpy(c).cuda())),
        chips=4 * t.shape[0], group="bf16", app_mfu=PARITY_JOBS[jid][2])
        for jid, (t, c) in grids.items()]
    from repro_torch.kernels import fleet_hist
    n0 = fleet_hist.ofu_bucket_hist.launches
    dev = Collector(streams, CollectorConfig(**PARITY_CFG))
    dev.run()
    assert fleet_hist.ofu_bucket_hist.launches - n0 == 4 * 8
    host = _collector("port", grids)
    host.run()
    _assert_counts_equal(dev.rollup, host.rollup)
    assert _keys(dev) == _keys(host) and _keys(host)
