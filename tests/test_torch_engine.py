"""The port's fused fleet engine (`repro_torch.fleet.engine_torch`)
against the JAX package's.

* The device half, fed the reference's own normal draws, reproduces the
  reference's `_group_device_sim` to ulp level: tpa to rtol 1e-6, the
  clock to atol 1e-2 MHz (one f32 ulp at 1,500 MHz is 1.2e-4 MHz; the OU
  map contracts, so ulp differences from exp/clip do not grow).
* The whole engine, with its own Philox draws, matches
  `simulate_jobs_fused` and `simulate_jobs_jax` statistically at the
  tolerances of the reference's own jax-vs-NumPy suite.
"""
import numpy as np
import pytest

from _propcheck import given, settings, st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core.peaks as R_peaks  # noqa: E402
import repro.fleet.engine as R_engine  # noqa: E402
import repro.telemetry.counters as R_counters  # noqa: E402
import repro_torch.core.peaks as T_peaks  # noqa: E402
import repro_torch.fleet.engine as T_engine  # noqa: E402
import repro_torch.telemetry.counters as T_counters  # noqa: E402
from repro.fleet.engine_jax import _group_device_sim as jax_device_sim  # noqa: E402
from repro.fleet.engine_jax import simulate_jobs_jax  # noqa: E402
from repro_torch.fleet.engine_torch import (_group_device_sim,  # noqa: E402
                                            _group_inputs,
                                            simulate_jobs_torch)


def _slot(pkg_engine, pkg_counters, pkg_peaks, mxu_s, step_s, dur,
          interval=30.0, events=(), stragglers=None, chip="TPU_V5E"):
    """One JobSlot built from plain numbers, in either package."""
    return pkg_engine.JobSlot(
        pkg_counters.StepProfile(mxu_s, step_s), dur, interval,
        events=[pkg_counters.Event(*e) for e in events],
        stragglers=None if stragglers is None else np.asarray(stragglers),
        chip=getattr(pkg_peaks, chip))


def _pair(*specs):
    """(reference slots, port slots) for the same job specs."""
    ref = [_slot(R_engine, R_counters, R_peaks, *a, **kw) for a, kw in specs]
    port = [_slot(T_engine, T_counters, T_peaks, *a, **kw)
            for a, kw in specs]
    return ref, port


def _job(duty=0.4, step_s=2.0, dur=1800.0, **kw):
    return (duty * step_s, step_s, dur), kw


def _np(g):
    return g.tpa.numpy(), g.clock_mhz.numpy()


# ---------------------------------------------------------------------------
# device half, fed the reference's own draws
# ---------------------------------------------------------------------------
DEVICE_CASES = {
    "steady": [_job(0.42, dur=600.0, stragglers=np.ones(6))],
    "events_and_stragglers": [_job(
        0.45, dur=1500.0, events=[(300, 900, 2.5), (1000, 1200, 1.0, 0.5)],
        stragglers=[1.0, 1.3, 2.0, 0.9, 1.1, 1.0])],
    "multi_job_one_evented": [
        _job(0.35, dur=900.0, stragglers=np.ones(3)),
        _job(0.5, step_s=1.0, dur=600.0, events=[(120, 360, 2.0)],
             stragglers=[1.0, 1.5]),
        _job(0.9, dur=450.0)],
}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_half_matches_reference_on_its_draws(case):
    _, port = _pair(*DEVICE_CASES[case])
    (members,) = T_engine.group_slots(port).values()
    inp = _group_inputs(members, T_engine.EngineParams())
    D, S = len(inp.strag), inp.base_end.shape[1]
    k_jit, k_clk = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    tpa_j, clk_j = jax_device_sim(
        *(jnp.asarray(x) for x in (
            inp.ratio, inp.strag, inp.dev_job, inp.sig, inp.ev_base,
            inp.ev_rows, inp.ev_job_of_row, inp.strag[inp.ev_rows],
            inp.base_end)),
        k_jit, k_clk, S=S, n_sub=inp.n_sub, consts=inp.consts, mesh=None)
    z = np.array(jax.random.normal(k_jit, (D, S), dtype=jnp.float32))
    dw = np.array(jax.random.normal(k_clk, (S, D), dtype=jnp.float32))
    tpa_t, clk_t = _group_device_sim(
        *inp.tensors("cpu"), torch.from_numpy(z), torch.from_numpy(dw),
        n_sub=inp.n_sub, consts=inp.consts)
    assert tpa_t.shape == clk_t.shape == (D, S)
    assert tpa_t.dtype == clk_t.dtype == torch.float32
    np.testing.assert_allclose(tpa_t.numpy(), np.asarray(tpa_j), rtol=1e-6)
    np.testing.assert_allclose(clk_t.numpy(), np.asarray(clk_j), atol=1e-2)


def test_group_inputs_none_without_samples():
    _, port = _pair(_job(dur=10.0))
    (members,) = T_engine.group_slots(port).values()
    assert _group_inputs(members, T_engine.EngineParams()) is None


# ---------------------------------------------------------------------------
# whole engine: statistical parity with the fused NumPy and jax engines
# ---------------------------------------------------------------------------
def _run_all(specs, seed):
    ref, port = _pair(*specs)
    fused = R_engine.simulate_jobs_fused(ref, seed=seed)
    jx = simulate_jobs_jax(ref, seed=seed, mesh=None, materialize=True)
    tch = simulate_jobs_torch(port, seed=seed, device="cpu")
    return fused, jx, tch


def test_steady_state_statistics_match_reference():
    fused, jx, tch = _run_all([_job(0.42, stragglers=np.ones(16))], 0)
    tpa, clk = _np(tch[0])
    assert tpa.shape == (16, 60)
    for ref in (fused[0], jx[0]):
        assert tpa.mean() == pytest.approx(ref.tpa.mean(), abs=0.005)
        assert clk.mean() == pytest.approx(ref.clock_mhz.mean(), abs=15.0)
        assert clk.std() == pytest.approx(ref.clock_mhz.std(), rel=0.5)
        assert (tpa * clk / 1558.0).mean() == pytest.approx(
            (ref.tpa * ref.clock_mhz / 1558.0).mean(), abs=0.005)


def test_event_collapse_window_by_window():
    """The 2.5x host-sync collapse lands in the same windows."""
    fused, jx, tch = _run_all(
        [_job(0.45, dur=900.0, events=[(300, 900, 2.5)],
              stragglers=np.ones(8))], 3)
    tpa, _ = _np(tch[0])
    for ref in (fused[0], jx[0]):
        assert tpa[:, :10].mean() == pytest.approx(ref.tpa[:, :10].mean(),
                                                   abs=0.01)
        assert tpa[:, 10:].mean() == pytest.approx(ref.tpa[:, 10:].mean(),
                                                   abs=0.01)
    assert tpa[:, :10].mean() / tpa[:, 10:].mean() \
        == pytest.approx(2.5, rel=0.05)


def test_straggler_and_mxu_scale_event_equivalence():
    fused, jx, tch = _run_all(
        [_job(0.5, step_s=1.0, dur=600.0,
              events=[(120, 360, 1.0, 0.5, "shrunk_gemm")],
              stragglers=[1.0, 1.0, 2.0, 1.3])], 11)
    tpa, _ = _np(tch[0])
    for ref in (fused[0], jx[0]):
        np.testing.assert_allclose(tpa.mean(axis=1), ref.tpa.mean(axis=1),
                                   atol=0.01)
    assert tpa[2].mean() == pytest.approx(tpa[0].mean() / 2, rel=0.05)


def test_multi_job_grouping_and_ragged_slices_match_reference_layout():
    """Heterogeneous slots land in the same groups with the same output
    shapes and clock domains as the reference (incl. the S == 0 slot)."""
    specs = [((0.8, 2.0, 600), dict(stragglers=np.ones(3))),
             ((0.8, 2.0, 600), dict(interval=15.0, stragglers=np.ones(2))),
             ((0.9, 2.0, 450), dict(chip="TPU_V6E_LIKE",
                                    stragglers=np.ones(4))),
             ((0.5, 2.0, 10.0), {})]
    fused, jx, tch = _run_all(specs, 0)
    shapes = [(3, 20), (2, 40), (4, 15), (1, 0)]
    assert [tuple(g.tpa.shape) for g in tch] == shapes
    assert [g.tpa.shape for g in fused] == [g.tpa.shape for g in jx] == shapes
    assert [g.interval_s for g in tch] == [g.interval_s for g in fused]
    assert all(g.tpa.is_contiguous() and g.clock_mhz.is_contiguous()
               for g in tch)
    assert float(tch[0].clock_mhz.max()) <= 1500.0
    assert float(tch[2].clock_mhz.mean()) > 1500.0
    for t, f in zip(tch[:3], fused[:3]):
        assert float(t.tpa.mean()) == pytest.approx(f.tpa.mean(), abs=0.01)


@settings(max_examples=10, derandomize=True, deadline=None)
@given(duty=st.floats(0.15, 0.6), n_dev=st.integers(1, 12),
       n_samp=st.integers(1, 80), sigma=st.floats(0.0, 0.3),
       evented=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_property_torch_matches_reference_statistics(
        duty, n_dev, n_samp, sigma, evented, seed):
    """Same-seed property sweep: over random jobs the torch engine matches
    the fused NumPy and jax engines within sample-count-scaled
    tolerances."""
    dur = n_samp * 30.0
    strag = np.exp(np.random.default_rng(seed).standard_normal(n_dev)
                   * sigma)
    events = [(dur / 4, 3 * dur / 4, 2.0)] if evented else ()
    fused, jx, tch = _run_all(
        [_job(duty, dur=dur, events=events, stragglers=strag)], seed)
    tpa, clk = _np(tch[0])
    n = max(n_dev * n_samp, 1)
    for ref in (fused[0], jx[0]):
        assert tpa.shape == ref.tpa.shape == (n_dev, n_samp)
        assert tpa.mean() == pytest.approx(ref.tpa.mean(), abs=0.01)
        assert clk.mean() == pytest.approx(
            ref.clock_mhz.mean(), abs=15.0 + 110.0 / np.sqrt(n))
        assert (tpa * clk / 1558.0).mean() == pytest.approx(
            (ref.tpa * ref.clock_mhz / 1558.0).mean(),
            abs=0.005 + 0.06 / np.sqrt(n))


def test_seeded_runs_are_reproducible():
    _, port = _pair(_job(0.4, dur=900.0, events=[(300, 600, 2.0)],
                         stragglers=np.ones(5)))
    (a,), (b,) = (simulate_jobs_torch(port, seed=4, device="cpu")
                  for _ in range(2))
    assert torch.equal(a.tpa, b.tpa) and torch.equal(a.clock_mhz,
                                                     b.clock_mhz)
