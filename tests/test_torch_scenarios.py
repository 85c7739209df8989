"""The port's scenario library, detector scorecard and recovery service
(`repro_torch.scenarios`, `repro_torch.fleet.recovery`) against the JAX
package's.

The CPU half of the reference's `test_scenarios.py`, `test_scorecard.py`
and `test_recovery.py`, run on the port with `device="cpu"` (the
reference's engine-parametrised cases collapse to the torch engine),
then parity cases:

  * the reference's fused-engine grids, handed to the port's
    `run_scorecard` through its `simulate_fleet`, give the committed
    `tests/data/golden_scorecard.json` exactly (all but `"engine"`);
  * the port's own torch-engine scorecard holds every pinned floor (its
    draws are not the reference's, so the golden document does not
    apply to it);
  * `golden_scenario.ctr` reads bitwise equal to the port's fault layer;
  * `preemption_wave`'s alerts map to the same recovery actions in both
    packages on the same grids.

The `gpu` case runs the scorecard on the card and skips without CUDA.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fleet.recovery as R_recovery  # noqa: E402
import repro_torch.scenarios.scorecard as T_scorecard  # noqa: E402
from repro_torch.fleet.collector import Alert  # noqa: E402
from repro_torch.fleet.engine import (CounterFault, apply_faults,  # noqa: E402
                                      fault_factors)
from repro_torch.fleet.jobs import JobSpec, JobTelemetry  # noqa: E402
from repro_torch.fleet.jobs import simulate_fleet as _simulate_fleet  # noqa: E402
from repro_torch.fleet.jobs import simulate_job as _simulate_job  # noqa: E402
from repro_torch.fleet.recovery import (RecoveryService,  # noqa: E402
                                        StragglerMonitor)
from repro_torch.scenarios import (FLOORS, SCENARIOS, SCHEMA,  # noqa: E402
                                   GroundTruthEvent, Scenario, build,
                                   check_floors, run_scenario, run_scorecard,
                                   scenario_names, score_alerts)
from repro_torch.telemetry import read_trace  # noqa: E402
from repro_torch.telemetry.scrape import DeviceGrid  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


def _reference():
    """The reference's scenario package and job module, imported where a
    CPU case needs them: their engine imports jax, which a machine that
    runs only the `gpu` case may not have."""
    import repro.fleet.jobs
    import repro.scenarios
    return repro.scenarios, repro.fleet.jobs


def simulate_fleet(specs, **kw):
    """The port's engine on the CPU (it defaults to the card)."""
    kw.setdefault("device", "cpu")
    return _simulate_fleet(specs, **kw)


def simulate_job(spec, **kw):
    kw.setdefault("device", "cpu")
    return _simulate_job(spec, **kw)


def _times(n, interval=30.0):
    return interval + interval * np.arange(n)


# ---------------------------------------------------------------------------
# fault_factors: the (duty, clock) mask algebra
# ---------------------------------------------------------------------------
def test_fault_window_masks_time_and_all_devices():
    t = _times(10)
    duty, clock = fault_factors(
        [CounterFault(start_s=120.0, end_s=240.0, duty_scale=0.4,
                      clock_scale=0.7)], t, 3)
    on = (t >= 120.0) & (t < 240.0)
    assert duty.shape == clock.shape == (3, 10)
    np.testing.assert_allclose(duty[:, on], 0.4)
    np.testing.assert_allclose(duty[:, ~on], 1.0)
    np.testing.assert_allclose(clock[:, on], 0.7)
    np.testing.assert_allclose(clock[:, ~on], 1.0)


def test_fault_device_subsets():
    t = _times(4)
    duty, _ = fault_factors([CounterFault(duty_scale=0.5, devices=(0, 2))],
                            t, 4)
    np.testing.assert_allclose(duty[[0, 2]], 0.5)
    np.testing.assert_allclose(duty[[1, 3]], 1.0)
    # fractional: ceil(0.5 * 4) = first 2 rows
    duty, _ = fault_factors([CounterFault(duty_scale=0.5,
                                          device_frac=0.5)], t, 4)
    np.testing.assert_allclose(duty[:2], 0.5)
    np.testing.assert_allclose(duty[2:], 1.0)
    with pytest.raises(ValueError, match="device"):
        fault_factors([CounterFault(devices=(5,))], t, 4)


def test_fault_periodic_gating():
    t = _times(12, interval=10.0)          # 10..120
    duty, _ = fault_factors(
        [CounterFault(start_s=10.0, duty_scale=0.2, period_s=40.0,
                      active_frac=0.5)], t, 1)
    on = np.mod(t - 10.0, 40.0) < 20.0
    on &= t >= 10.0
    np.testing.assert_allclose(duty[0, on], 0.2)
    np.testing.assert_allclose(duty[0, ~on], 1.0)


def test_fault_diurnal_wave():
    t = _times(8, interval=100.0)
    duty, _ = fault_factors(
        [CounterFault(diurnal_amp=0.25, diurnal_period_s=800.0)], t, 2)
    want = 1.0 + 0.25 * np.sin(2 * np.pi * t / 800.0)
    np.testing.assert_allclose(duty[0], want, rtol=1e-6)
    np.testing.assert_allclose(duty[1], want, rtol=1e-6)


def test_faults_compound_multiplicatively():
    t = _times(6)
    f1 = CounterFault(duty_scale=0.5)
    f2 = CounterFault(start_s=90.0, duty_scale=0.4, clock_scale=0.8)
    duty, clock = fault_factors([f1, f2], t, 1)
    on = t >= 90.0
    np.testing.assert_allclose(duty[0, on], 0.2)
    np.testing.assert_allclose(duty[0, ~on], 0.5)
    np.testing.assert_allclose(clock[0, on], 0.8)


def test_fault_validation():
    with pytest.raises(ValueError):
        CounterFault(start_s=100.0, end_s=50.0)
    with pytest.raises(ValueError):
        CounterFault(device_frac=0.0)
    with pytest.raises(ValueError):
        CounterFault(device_frac=1.5)
    with pytest.raises(ValueError):
        CounterFault(period_s=100.0, active_frac=0.0)
    with pytest.raises(ValueError):
        CounterFault(diurnal_amp=1.5)


# ---------------------------------------------------------------------------
# apply_faults: grid semantics, host and tensor grids
# ---------------------------------------------------------------------------
def _grid(n_dev=2, n_s=6, tpa=0.5, clock=1200.0, tensor=False):
    t, c = np.full((n_dev, n_s), tpa), np.full((n_dev, n_s), clock)
    if tensor:
        t, c = torch.from_numpy(t).float(), torch.from_numpy(c).float()
    return DeviceGrid(30.0, t, c, t0_s=0.0)


@pytest.mark.parametrize("tensor", [False, True])
def test_apply_faults_empty_is_noop(tensor):
    g = _grid(tensor=tensor)
    out = apply_faults(g, [])
    np.testing.assert_array_equal(np.asarray(out.tpa), np.asarray(g.tpa))
    np.testing.assert_array_equal(np.asarray(out.clock_mhz),
                                  np.asarray(g.clock_mhz))
    assert out.interval_s == g.interval_s and out.t0_s == g.t0_s


@pytest.mark.parametrize("tensor", [False, True])
def test_apply_faults_scales_and_clips(tensor):
    g = _grid(tpa=0.8, clock=1000.0, tensor=tensor)
    out = apply_faults(g, [CounterFault(duty_scale=1.5, clock_scale=0.5)])
    assert isinstance(out.tpa, torch.Tensor) == tensor
    np.testing.assert_allclose(np.asarray(out.tpa), 1.0)     # clipped at 1
    np.testing.assert_allclose(np.asarray(out.clock_mhz), 500.0)
    assert out.t0_s == g.t0_s and out.interval_s == g.interval_s
    # and the input grid is untouched
    np.testing.assert_allclose(np.asarray(g.tpa), 0.8, rtol=1e-7)


# ---------------------------------------------------------------------------
# The post-hoc guarantee on the torch engine
# ---------------------------------------------------------------------------
FAULTS = [CounterFault(start_s=300.0, duty_scale=0.4, clock_scale=0.9)]


def _spec(faults=(), **kw):
    kw.setdefault("duration_s", 600.0)
    kw.setdefault("chips", 8)
    return JobSpec("posthoc", "llama3.2-3b", seed=3, faults=list(faults),
                   **kw)


def test_posthoc_equals_apply_after_the_fact():
    base = simulate_job(_spec())
    faulted = simulate_job(_spec(FAULTS))
    want = apply_faults(base.grid, FAULTS)
    assert torch.equal(faulted.grid.tpa, want.tpa)
    assert torch.equal(faulted.grid.clock_mhz, want.clock_mhz)
    # app-side numbers are untouched: the app doesn't know it regressed
    assert faulted.app_mfu == base.app_mfu
    assert faulted.step_time_s == base.step_time_s


def test_posthoc_fleet_faults_only_hit_their_job():
    bystander = dict(job_id="bystander", arch="qwen3-4b", seed=4,
                     duration_s=600.0, chips=8)
    plain = simulate_fleet([_spec(), JobSpec(**bystander)])
    faulted = simulate_fleet([_spec(FAULTS), JobSpec(**bystander)])
    want = apply_faults(plain[0].grid, FAULTS)
    assert torch.equal(faulted[0].grid.tpa, want.tpa)
    # the unfaulted job's realization is bit-identical
    assert torch.equal(faulted[1].grid.tpa, plain[1].grid.tpa)


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------
def test_library_has_the_required_scenarios():
    names = set(SCENARIOS)
    assert len(names) >= 6
    assert {"gloo_regression_2p5x", "mixed_precision_transition",
            "straggler_hosts", "thermal_throttle", "preemption_wave",
            "moe_expert_imbalance", "diurnal_inference"} <= names


def test_build_is_deterministic():
    a, b = build("gloo_regression_2p5x"), build("gloo_regression_2p5x")
    assert [s.job_id for s in a.specs] == [s.job_id for s in b.specs]
    assert a.labels == b.labels
    for ta, tb in zip(simulate_fleet(a.specs), simulate_fleet(b.specs)):
        assert torch.equal(ta.grid.tpa, tb.grid.tpa)
        assert torch.equal(ta.grid.clock_mhz, tb.grid.clock_mhz)


def test_build_unknown_name():
    with pytest.raises(KeyError, match="unknown scenario"):
        build("nope")


def test_paper_scenario_carries_the_2p5x_ground_truth():
    sc = build("gloo_regression_2p5x")
    (lbl,) = sc.labels
    assert lbl.detector == "regression"
    assert lbl.magnitude == pytest.approx(2.5)
    (bad,) = [s for s in sc.specs if s.faults]
    assert bad.job_id == lbl.job_id
    assert bad.faults[0].duty_scale == pytest.approx(0.4)   # 1/2.5


def test_diurnal_scenario_is_the_false_positive_probe():
    sc = build("diurnal_inference")
    assert sc.labels == []
    assert all(s.faults for s in sc.specs)      # benign faults everywhere


def test_scenario_label_hygiene():
    spec = JobSpec("a", "llama3.2-3b")
    with pytest.raises(ValueError, match="unknown job"):
        Scenario("x", "d", [spec],
                 [GroundTruthEvent("ghost", "regression", 10.0)])
    with pytest.raises(ValueError, match="unknown detector"):
        GroundTruthEvent("a", "oracle", 10.0)
    with pytest.raises(ValueError, match="empty"):
        GroundTruthEvent("a", "regression", 10.0, end_s=5.0)
    with pytest.raises(ValueError, match="duplicate"):
        Scenario("x", "d", [spec, JobSpec("a", "qwen3-4b")], [])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_library_matches_the_reference_field_by_field(name):
    """Every scenario is the reference's: specs (faults included),
    labels and collector geometry."""
    R_scenarios, _ = _reference()
    port, ref = build(name), R_scenarios.build(name)
    assert len(port.specs) == len(ref.specs)
    for ps, rs in zip(port.specs, ref.specs):
        for key in ("job_id", "arch", "shape", "chips", "flops_variant",
                    "true_duty", "duration_s", "scrape_interval_s", "seed"):
            assert getattr(ps, key) == getattr(rs, key), (name, key)
        assert [vars(f) for f in ps.faults] == [vars(f) for f in rs.faults]
    assert [vars(lb) for lb in port.labels] == [vars(lb) for lb in ref.labels]
    for key in ("detectors", "round_s", "bucket_s", "retain", "detector_kw",
                "goodput_kw", "flag_rel_err", "tolerance_s", "app_mfu",
                "mfu_stream", "miscalc_kw", "description"):
        assert getattr(port, key) == getattr(ref, key), (name, key)


# ---------------------------------------------------------------------------
# scoring semantics (synthetic alerts, no simulation)
# ---------------------------------------------------------------------------
def _toy_scenario(labels, tolerance_s=100.0):
    return Scenario("toy", "toy", [JobSpec("a", "llama3.2-3b",
                                           duration_s=1000.0),
                                   JobSpec("b", "qwen3-4b",
                                           duration_s=1000.0)],
                    labels, tolerance_s=tolerance_s)


def _alert(job_id, kind, t_s, round_idx=1):
    return Alert(round_idx, t_s, job_id, kind, "msg", factor=2.0)


def test_score_matching_precision_recall_ttd():
    sc = _toy_scenario([
        GroundTruthEvent("a", "regression", 200.0, end_s=400.0),
        GroundTruthEvent("b", "regression", 600.0),
    ])
    alerts = [
        _alert("a", "regression", 300.0),     # matches label 1, ttd 100
        _alert("a", "regression", 950.0),     # outside a's window: FP
        _alert("b", "divergence", 700.0),     # wrong kind for the label
    ]
    s = score_alerts(sc, alerts)["regression"]
    assert s.n_alerts == 2 and s.n_matched_alerts == 1
    assert s.precision == pytest.approx(0.5)
    assert s.n_labels == 2 and s.n_matched_labels == 1
    assert s.recall == pytest.approx(0.5)
    assert s.ttd_s == pytest.approx(100.0)
    d = score_alerts(sc, alerts)["divergence"]
    assert d.precision == 0.0 and d.recall == 1.0 and d.n_labels == 0


def test_score_tolerance_window_extends_label_end():
    sc = _toy_scenario([GroundTruthEvent("a", "regression", 200.0,
                                         end_s=400.0)], tolerance_s=150.0)
    assert score_alerts(sc, [_alert("a", "regression", 540.0)]) \
        ["regression"].recall == 1.0
    assert score_alerts(sc, [_alert("a", "regression", 560.0)]) \
        ["regression"].recall == 0.0
    # an alert BEFORE onset never matches (detection cannot precede cause)
    assert score_alerts(sc, [_alert("a", "regression", 150.0)]) \
        ["regression"].precision == 0.0


def test_score_silent_and_unlabeled_edge_cases():
    sc = _toy_scenario([])
    s = score_alerts(sc, [])["regression"]
    assert s.precision == 1.0 and s.recall == 1.0 and s.ttd_s is None


# ---------------------------------------------------------------------------
# the torch engine's scorecard (its own draws: floors, not the golden)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card():
    """One full-library scorecard on the torch engine, on the CPU."""
    return run_scorecard(device="cpu")


def test_paper_2p5x_scenario_scores_perfectly():
    sc = build("gloo_regression_2p5x")
    run = run_scenario(sc, device="cpu")
    s = score_alerts(sc, run.alerts)["regression"]
    assert s.precision == 1.0 and s.recall == 1.0
    assert s.ttd_s is not None and s.ttd_s <= 1200.0
    # the alert carries (roughly) the injected 2.5x magnitude
    (a,) = [a for a in run.alerts if a.kind == "regression"]
    assert a.factor == pytest.approx(2.5, rel=0.2)


def test_scorecard_covers_all_detectors_on_all_scenarios(card):
    assert card["schema"] == SCHEMA and card["engine"] == "torch"
    assert list(card["scenarios"]) == scenario_names()
    for entry in card["scenarios"].values():
        assert set(entry["detectors"]) \
            == {"regression", "divergence", "goodput", "miscalc"}


def test_torch_engine_scorecard_holds_every_pinned_floor(card):
    assert check_floors(card) == []


def test_check_floors_flags_doctored_results(card):
    doc = json.loads(json.dumps(card))
    cell = doc["scenarios"]["gloo_regression_2p5x"] \
              ["detectors"]["regression"]
    cell["precision"] = 0.5
    cell["ttd_s"] = 99999.0
    bad = check_floors(doc)
    assert any("precision 0.500" in v for v in bad)
    assert any("ttd 99999s" in v for v in bad)
    cell["ttd_s"] = None
    del doc["scenarios"]["thermal_throttle"]
    bad = check_floors(doc)
    assert any("no detection" in v for v in bad)
    assert any("thermal_throttle/regression: missing" in v for v in bad)
    for scen, det in FLOORS:
        assert det in card["scenarios"][scen]["detectors"], (scen, det)


def test_floors_and_schema_are_the_references():
    R_scenarios, _ = _reference()
    assert FLOORS == R_scenarios.FLOORS and len(FLOORS) == 19
    assert SCHEMA == R_scenarios.SCHEMA


def test_check_floors_agrees_with_the_reference_on_any_document(card):
    R_scenarios, _ = _reference()
    doc = json.loads(json.dumps(card))
    doc["scenarios"]["straggler_hosts"]["detectors"]["regression"][
        "recall"] = 0.0
    del doc["scenarios"]["diurnal_inference"]
    assert check_floors(doc) == R_scenarios.check_floors(doc)
    assert check_floors(card) == R_scenarios.check_floors(card)


# ---------------------------------------------------------------------------
# parity on shared grids: the reference's fused-engine draws
# ---------------------------------------------------------------------------
def _shared_simulate_fleet(specs, *, max_devices=4, engine="torch",
                           device=None):
    """Stand-in for the port's `simulate_fleet`: the reference's fused
    engine simulates the same scenario, and each grid comes back as a
    port `DeviceGrid` over the same NumPy arrays."""
    R_scenarios, R_jobs = _reference()
    ids = [s.job_id for s in specs]
    (name,) = [n for n in R_scenarios.scenario_names()
               if [s.job_id for s in R_scenarios.build(n).specs] == ids]
    ref = R_jobs.simulate_fleet(R_scenarios.build(name).specs,
                                max_devices=max_devices, engine="fused")
    return [JobTelemetry(spec, DeviceGrid(t.grid.interval_s, t.grid.tpa,
                                          t.grid.clock_mhz,
                                          t0_s=t.grid.t0_s),
                         t.app_mfu, t.app_mfu_exact, t.step_time_s,
                         t.executed_tflops_per_step)
            for spec, t in zip(specs, ref)]


@pytest.fixture(scope="module")
def shared():
    """The port's scorecard and preemption_wave run on the reference's
    grids, with the reference's own runs of the same."""
    R_scenarios, _ = _reference()
    mp = pytest.MonkeyPatch()
    mp.setattr(T_scorecard, "simulate_fleet", _shared_simulate_fleet)
    try:
        doc = run_scorecard()
        wave = run_scenario(build("preemption_wave"))
    finally:
        mp.undo()
    ref_wave = R_scenarios.run_scenario(R_scenarios.build("preemption_wave"))
    return doc, wave, ref_wave


def test_scorecard_on_shared_grids_equals_the_golden_document(shared):
    """Exact equality, the reference's own (`test_scorecard_document_is
    _frozen`): every score, count and description, all but `"engine"`
    ('fused' there, 'torch' here)."""
    doc, _, _ = shared
    with open(os.path.join(DATA, "golden_scorecard.json")) as fh:
        golden = json.load(fh)
    assert golden["engine"] == "fused" and doc["engine"] == "torch"
    assert dict(doc, engine=None) == dict(golden, engine=None)
    assert check_floors(doc) == []


def test_shared_grid_alerts_equal_the_references(shared):
    _, wave, ref_wave = shared
    assert [vars(a) for a in wave.alerts] == [vars(a) for a in ref_wave.alerts]
    assert any(a.kind == "goodput" for a in wave.alerts)


# ---------------------------------------------------------------------------
# golden fault-injected archive
# ---------------------------------------------------------------------------
def _golden_base_grid():
    d, s = 3, 20
    iv, t0 = 30.0, 300.0
    tpa = 0.3 + 0.15 * np.sin(2 * np.pi * np.arange(d)[:, None] / 3.0
                              + np.arange(s) / 7.0)
    clk = 1300.0 - 50.0 * np.cos(np.arange(s) / 5.0) \
        + 10.0 * np.arange(d)[:, None]
    return DeviceGrid(iv, tpa, clk, t0_s=t0)


GOLDEN_FAULTS = [
    CounterFault(start_s=600.0, duty_scale=0.4, kind="gloo_regression"),
    CounterFault(start_s=450.0, end_s=750.0, clock_scale=0.7,
                 devices=(1,), kind="thermal"),
]


def test_golden_scenario_archive_is_exact():
    """`golden_scenario.ctr` reads bitwise equal to the port's fault
    layer on the test's float64 base grid."""
    want = apply_faults(_golden_base_grid(), GOLDEN_FAULTS)
    got = read_trace(os.path.join(DATA, "golden_scenario.ctr"))
    assert got.interval_s == want.interval_s
    assert got.t0_s == want.t0_s
    np.testing.assert_array_equal(got.tpa, want.tpa)
    np.testing.assert_array_equal(got.clock_mhz, want.clock_mhz)


def test_golden_scenario_on_a_tensor_grid_holds_at_f32_rounding():
    """The same faults on a float32 CPU tensor of the base grid multiply
    in f32: each value is the golden's rounded to f32 and scaled there,
    so it lies within 2 f32 ulps (2^-22 relative) of the golden."""
    base = _golden_base_grid()
    g = DeviceGrid(base.interval_s, torch.from_numpy(base.tpa).float(),
                   torch.from_numpy(base.clock_mhz).float(), t0_s=base.t0_s)
    got = apply_faults(g, GOLDEN_FAULTS)
    want = read_trace(os.path.join(DATA, "golden_scenario.ctr"))
    assert got.tpa.dtype == torch.float32
    np.testing.assert_allclose(got.tpa.numpy(), want.tpa, rtol=2.0 ** -22,
                               atol=0)
    np.testing.assert_allclose(got.clock_mhz.numpy(), want.clock_mhz,
                               rtol=2.0 ** -22, atol=0)


# ---------------------------------------------------------------------------
# recovery: observe() policy and consume_alerts()
# ---------------------------------------------------------------------------
def _feed(svc, job, values):
    return [svc.observe(job, v) for v in values]


def test_observe_fires_on_absolute_floor():
    svc = RecoveryService(abs_floor=0.02, sustain_samples=3)
    out = _feed(svc, "j", [0.4] * 6 + [0.01] * 3)
    fired = [a for a in out if a is not None]
    assert len(fired) == 1
    assert fired[0].reason == "ofu_below_floor"
    assert fired[0].factor == float("inf")


def test_observe_fires_on_sustained_regression_not_blips():
    svc = RecoveryService(factor_threshold=2.0, sustain_samples=3,
                          cooldown_samples=100)
    out = _feed(svc, "j", [0.4] * 8 + [0.1] + [0.4] * 4)
    assert all(a is None for a in out)
    out = _feed(svc, "k", [0.4] * 8 + [0.1] * 5)
    fired = [a for a in out if a is not None]
    assert len(fired) == 1
    assert fired[0].reason == "sustained_regression"
    assert fired[0].factor == pytest.approx(4.0, rel=0.25)


def test_observe_cooldown_then_rearm():
    svc = RecoveryService(abs_floor=0.05, sustain_samples=2,
                          cooldown_samples=6)
    out = _feed(svc, "j", [0.4] * 4 + [0.01] * 12)
    idx = [i for i, a in enumerate(out) if a is not None]
    assert len(idx) >= 2                       # re-fires after cooldown
    assert idx[1] - idx[0] >= 6                # but never inside it


def test_observe_callback_fires_exactly_once_per_action():
    calls = []
    svc = RecoveryService(abs_floor=0.05, sustain_samples=2,
                          cooldown_samples=10 ** 6,
                          on_recover=calls.append)
    _feed(svc, "j", [0.4] * 4 + [0.01] * 10)
    assert len(calls) == 1
    assert calls[0] is svc.actions[0]


def _ralert(job="j", factor=2.5, kind="regression", round_idx=3,
            t_s=900.0, msg="2.50x OFU collapse"):
    return Alert(round_idx, t_s, job, kind, msg, factor=factor)


def test_consume_alerts_is_idempotent_under_refeed():
    svc = RecoveryService()
    log = [_ralert()]
    assert len(svc.consume_alerts(log)) == 1
    log.append(_ralert(round_idx=7, t_s=2100.0))
    again = svc.consume_alerts(log)
    assert len(again) == 1 and again[0].at_sample == 7
    assert len(svc.actions) == 2


def test_consume_alerts_filters_kind_and_factor():
    svc = RecoveryService(min_alert_factor=2.0)
    actions = svc.consume_alerts([
        _ralert(kind="divergence"),             # not a regression
        _ralert(job="wobble", factor=1.6),      # below min_alert_factor
        _ralert(job="nanjob", factor=float("nan")),
        _ralert(job="dead", factor=3.0),
    ])
    assert [a.job_id for a in actions] == ["dead"]
    assert actions[0].reason == "collector_regression"


def test_consume_alerts_fires_callback_once_per_episode():
    calls = []
    svc = RecoveryService(on_recover=calls.append)
    log = [_ralert()]
    svc.consume_alerts(log)
    svc.consume_alerts(log)
    svc.consume_alerts(log)
    assert len(calls) == 1


def test_recovery_closes_the_loop_on_the_paper_scenario():
    """The 2.5x scenario on the torch engine: exactly one restart of
    exactly the faulted job, idempotent per round."""
    sc = build("gloo_regression_2p5x")
    run = run_scenario(sc, device="cpu")
    restarts = []
    svc = RecoveryService(min_alert_factor=2.0,
                          on_recover=lambda a: restarts.append(a.job_id))
    for _ in range(3):                         # one call per "round"
        svc.consume_alerts(run.alerts)
    assert restarts == ["allreduce-7b"]
    assert svc.actions[0].factor == pytest.approx(2.5, rel=0.2)


def test_straggler_monitor_flags_the_outlier():
    rng = np.random.default_rng(0)
    tpa = 0.42 + 0.01 * rng.standard_normal(16)   # healthy spread
    tpa[11] = 0.02
    assert StragglerMonitor().flag(tpa) == [11]
    assert StragglerMonitor().flag(tpa) \
        == R_recovery.StragglerMonitor().flag(tpa)


def _actions(actions):
    return [(a.job_id, a.reason, a.at_sample, a.factor) for a in actions]


def test_preemption_wave_recovery_matches_the_reference_on_shared_grids(
        shared):
    """Each regression episode of `preemption_wave` maps to one action,
    the same in both packages on the same grids."""
    _, wave, ref_wave = shared
    port, ref = RecoveryService(), R_recovery.RecoveryService()
    got = port.consume_alerts(wave.alerts)
    want = ref.consume_alerts(ref_wave.alerts)
    assert _actions(got) == _actions(want) and got
    assert port.consume_alerts(wave.alerts) == []      # idempotent
    episodes = [a for a in wave.alerts if a.kind == "regression"
                and a.factor >= port.min_alert_factor]
    assert len(got) == len(episodes)


def test_preemption_wave_recovery_on_the_torch_engine():
    """On the torch engine's own draws: one action per regression episode
    at or past `min_alert_factor`, every one a tenant the waves parked."""
    run = run_scenario(build("preemption_wave"), device="cpu")
    svc = RecoveryService()
    got = svc.consume_alerts(run.alerts)
    episodes = [a for a in run.alerts if a.kind == "regression"
                and a.factor >= svc.min_alert_factor]
    assert [(a.job_id, a.at_sample) for a in got] \
        == [(a.job_id, a.round_idx) for a in episodes]
    assert got and {a.job_id for a in got} <= {f"tenant-{k}"
                                               for k in range(5)}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_scorecard_on_the_card_holds_every_floor(cuda):
    """The scorecard with the histogram kernel ingesting every replayed
    grid: every floor holds, and the kernel launched once a non-empty
    (job, round) grid."""
    from repro_torch.kernels import fleet_hist
    n0 = fleet_hist.ofu_bucket_hist.launches
    doc = run_scorecard()
    assert check_floors(doc) == []
    want = sum(len(build(n).specs) * int(build(n).duration_s
                                         // build(n).round_s)
               for n in scenario_names())
    assert fleet_hist.ofu_bucket_hist.launches - n0 == want
