"""The port's OFU core (`repro_torch.core.ofu`) and tile quantization
(`repro_torch.core.tile_quant`, with `kernels.gemm.grid_flops`) against
the JAX package's.

The reference's `test_ofu_core.py` and `test_tile_quant.py`, run on the
port, each property also holding the port's value equal to the
reference's on the same draw.  The reference's fine-bins property bounds
`hist_percentile` against `np.percentile` by one bin width, a bound both
packages' identical readouts break now and then at a bin edge; here the
port's readout is held equal to the reference's on the property's draws,
which is the port's contract.
"""
import numpy as np
import pytest

from _propcheck import given, settings, st

pytest.importorskip("torch")

import repro.core.ofu as R  # noqa: E402
import repro.core.tile_quant as R_tq  # noqa: E402
from repro.kernels.gemm import grid_flops as R_grid_flops  # noqa: E402
from repro_torch.core import (TPU_V5E, AccuracyReport, adjusted_ofu,  # noqa: E402
                              effective_peak, hist_percentile, mae,
                              mfu_from_throughput, ofu_mean, ofu_point,
                              ofu_series, pct_within, pearson_r)
from repro_torch.core.ofu import hist_percentile_grid  # noqa: E402
from repro_torch.core.tile_quant import (TilePolicy, correction_factor,  # noqa: E402
                                         effective_dims, overhead,
                                         pick_policy, profiled_flops,
                                         scale_factor_overhead,
                                         theoretical_flops)
from repro_torch.kernels.gemm import grid_flops  # noqa: E402


# ===========================================================================
# test_ofu_core.py: the OFU metric core (paper Eq. 1, 5, 8, 9, 12)
# ===========================================================================
def test_peak_derivation_matches_published():
    # Eq. 5 audit: 4 MXUs x 128x128 x 2 x 1500 MHz = 196.6 TF/s (~197 pub.)
    assert TPU_V5E.peak_tflops("bf16") == pytest.approx(196.608)
    assert TPU_V5E.peak_tflops("int8") == pytest.approx(393.216)
    assert TPU_V5E.peak_tflops("fp32") == pytest.approx(196.608 / 4)


def test_ofu_point_eq1():
    # full duty at full clock = 1.0; clock throttle scales linearly
    assert ofu_point(1.0, TPU_V5E.f_max_mhz) == pytest.approx(1.0)
    assert ofu_point(0.5, TPU_V5E.f_max_mhz * 0.9) == pytest.approx(0.45)


@given(st.floats(0, 1), st.floats(0.5, 1.0))
@settings(max_examples=50, deadline=None)
def test_ofu_bounded(tpa, clock_frac):
    v = ofu_point(tpa, TPU_V5E.f_max_mhz * clock_frac)
    assert 0.0 <= v <= 1.0 + 1e-9
    assert v == R.ofu_point(tpa, TPU_V5E.f_max_mhz * clock_frac)


def test_adjusted_ofu_eq8():
    # hardware executed 10% extra FLOPs -> OFU_adj shrinks by that factor
    assert adjusted_ofu(0.55, 100.0, 110.0) == pytest.approx(0.5)
    assert adjusted_ofu(0.55, 100.0, 0.0) == 0.55  # degenerate guard


def test_effective_peak_harmonic_mean_eq12():
    # all bf16 -> bf16 peak; all int8 -> int8 peak
    assert effective_peak({"bf16": 1e12}) == pytest.approx(196.608)
    assert effective_peak({"int8": 1e12}) == pytest.approx(393.216)
    # 50/50 FLOPs split -> harmonic mean
    p = effective_peak({"bf16": 1.0, "int8": 1.0})
    expect = 2 / (1 / 196.608 + 1 / 393.216)
    assert p == pytest.approx(expect)
    # mixed peak sits strictly between the two
    assert 196.608 < p < 393.216


def test_effective_peak_bf16_only_raises_mfu():
    """Paper §VI-B: constant throughput, BF16-only -> lower peak -> higher
    MFU.  The effective-peak denominator must reproduce that."""
    tflops_per_chip = 80.0
    p_mixed = effective_peak({"bf16": 0.4, "fp8": 0.6})
    p_bf16 = effective_peak({"bf16": 1.0})
    assert mfu_from_throughput(tflops_per_chip, p_bf16) > \
        mfu_from_throughput(tflops_per_chip, p_mixed)
    assert p_mixed == R.effective_peak({"bf16": 0.4, "fp8": 0.6})
    assert mfu_from_throughput(tflops_per_chip, p_bf16) \
        == R.mfu_from_throughput(tflops_per_chip, p_bf16)


_PRECS = ["bf16", "int8", "fp8", "fp32"]


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 64))
@settings(max_examples=25, deadline=None)
def test_ofu_series_matches_pointwise(seed, n):
    """Eq. 11 must be exactly the element-wise map of Eq. 1."""
    rng = np.random.default_rng(seed)
    tpa = rng.uniform(0, 1, n)
    clk = rng.uniform(0.6, 1.0, n) * TPU_V5E.f_max_mhz
    series = ofu_series(tpa, clk)
    assert series.shape == (n,)
    for i in range(n):
        assert series[i] == pytest.approx(ofu_point(tpa[i], clk[i]))
    assert ofu_mean(tpa, clk) == pytest.approx(float(series.mean()))
    np.testing.assert_array_equal(series, R.ofu_series(tpa, clk))
    assert ofu_mean(tpa, clk) == R.ofu_mean(tpa, clk)


@given(st.lists(st.tuples(st.sampled_from(_PRECS),
                          st.floats(1e6, 1e15)),
                min_size=1, max_size=4))
@settings(max_examples=50, deadline=None)
def test_effective_peak_bounded_by_component_peaks(mix):
    """Eq. 12: the harmonic mean can never leave [min, max] of the
    per-precision peaks present in the mix."""
    flops = {}
    for p, f in mix:
        flops[p] = flops.get(p, 0.0) + f
    peaks = [TPU_V5E.peak_tflops(p) for p in flops]
    eff = effective_peak(flops, TPU_V5E)
    assert min(peaks) - 1e-9 <= eff <= max(peaks) + 1e-9
    assert eff == R.effective_peak(flops)


@given(st.floats(0.01, 1.0), st.floats(1.0, 1e12),
       st.floats(1.0, 2.0), st.floats(1.0, 2.0))
@settings(max_examples=50, deadline=None)
def test_adjusted_ofu_monotonicity(ofu, th, k_prof, k_th):
    """Eq. 8: OFU_adj grows with theoretical FLOPs, shrinks as the
    hardware executes more padding, and never exceeds raw OFU when
    profiled >= theoretical (padding can only inflate the raw metric)."""
    prof = th * k_prof                     # profiled >= theoretical
    base = adjusted_ofu(ofu, th, prof)
    assert base <= ofu + 1e-12
    assert adjusted_ofu(ofu, th * k_th, prof) >= base - 1e-12
    assert adjusted_ofu(ofu, th, prof * k_th) <= base + 1e-12
    assert base == R.adjusted_ofu(ofu, th, prof)


@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 100))
@settings(max_examples=50, deadline=None)
def test_pearson_r_bounded(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n) * rng.uniform(0.1, 100)
    b = rng.normal(size=n) * rng.uniform(0.1, 100)
    assert -1.0 - 1e-9 <= pearson_r(a, b) <= 1.0 + 1e-9
    assert pearson_r(a, b) == R.pearson_r(a, b)
    # degenerate series: zero variance must not divide by zero
    assert pearson_r(np.full(n, 3.0), b) == 0.0
    # perfect (anti-)correlation hits the bounds
    assert pearson_r(a, 2 * a + 1) == pytest.approx(1.0)
    assert pearson_r(a, -3 * a) == pytest.approx(-1.0)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=25, deadline=None)
def test_hist_percentile_equals_reference_on_fine_bins(seed):
    """The fine-bins property's draws: the port's readout is the
    reference's, exactly, at every quantile it reads, and an empty
    histogram reads NaN."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 1, 500)
    edges = np.linspace(0, 1.1, 129)
    counts, _ = np.histogram(vals, edges)
    for q in (0, 10, 50, 90, 100):
        est = hist_percentile(edges, counts, q)
        assert est == R.hist_percentile(edges, counts, q)
    assert np.isnan(hist_percentile(edges, np.zeros(128), 50))


@pytest.mark.parametrize("seed,off", [(8479, -0.008953),
                                      (21439, -0.008648)])
def test_hist_percentile_equals_reference_at_the_failing_seeds(seed, off):
    """Seeds where the fine-bins property fails: both packages read the
    same value, further below np.percentile at q = 10 than one bin
    width (0.008594)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 1, 500)
    edges = np.linspace(0, 1.1, 129)
    counts, _ = np.histogram(vals, edges)
    est = hist_percentile(edges, counts, 10)
    assert est == R.hist_percentile(edges, counts, 10)
    assert est - np.percentile(vals, 10) == pytest.approx(off, abs=1e-6)


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 16))
@settings(max_examples=25, deadline=None)
def test_hist_percentile_grid_equals_reference(seed, n_buckets):
    rng = np.random.default_rng(seed)
    edges = np.linspace(0.0, 1.1, 129)
    h = rng.integers(0, 20, size=(n_buckets, 128)).astype(float) \
        * rng.uniform(0.5, 64, size=(n_buckets, 1))
    h[rng.integers(n_buckets)] = 0.0             # an empty bucket row
    qs = (0, 10, 50, 90, 100)
    np.testing.assert_array_equal(hist_percentile_grid(edges, h, qs),
                                  R.hist_percentile_grid(edges, h, qs))


def test_accuracy_stats():
    est = [10.0, 12.0, 20.0]
    tru = [11.0, 12.0, 15.0]
    assert mae(est, tru) == pytest.approx(2.0)
    assert pct_within(est, tru, 2.0) == pytest.approx(2 / 3)
    r = pearson_r([1, 2, 3, 4], [2, 4, 6, 8])
    assert r == pytest.approx(1.0)
    rep = AccuracyReport.build("ofu", est, tru)
    assert rep.within_5pp == 1.0


@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 200))
@settings(max_examples=25, deadline=None)
def test_accuracy_report_equals_reference(seed, n):
    rng = np.random.default_rng(seed)
    tru = rng.uniform(5, 60, n)
    est = tru + rng.normal(0, rng.uniform(0.1, 8), n)
    rep = AccuracyReport.build("AdjOFU", est, tru)
    ref = R.AccuracyReport.build("AdjOFU", est, tru)
    assert vars(rep) == vars(ref)
    assert mae(est, tru) == R.mae(est, tru)
    assert pct_within(est, tru, 2.0) == R.pct_within(est, tru, 2.0)


# ===========================================================================
# test_tile_quant.py: closed form (Eq. 3/4) == the kernel grid, exactly
# ===========================================================================
dims = st.integers(min_value=1, max_value=5000)
tiles = st.sampled_from([128, 256, 512])
clusters = st.sampled_from([1, 2, 4])


@given(dims, dims, dims, tiles, tiles, tiles, clusters, clusters)
@settings(max_examples=200, deadline=None)
def test_closed_form_equals_kernel_grid(M, N, K, tm, tn, tk, cm, cn):
    pol = TilePolicy(tm, tn, tk, cm, cn)
    assert profiled_flops(M, N, K, pol) == grid_flops(M, N, K, pol)
    ref = R_tq.TilePolicy(tm, tn, tk, cm, cn)
    assert profiled_flops(M, N, K, pol) == R_tq.profiled_flops(M, N, K, ref)
    assert grid_flops(M, N, K, pol) == R_grid_flops(M, N, K, ref)


@given(dims, dims, dims, st.sampled_from(["bf16", "int8", "fp32"]))
@settings(max_examples=100, deadline=None)
def test_overhead_nonnegative_and_bounded(M, N, K, prec):
    pol = pick_policy(M, N, K, prec)
    oh = overhead(M, N, K, pol)
    assert oh >= 0.0
    # worst case: every dim rounds nearly a full tile*cluster up
    me, ne, ke = effective_dims(M, N, K, pol)
    assert me >= M and ne >= N and ke >= K
    assert me < M + pol.tm * pol.cm
    assert ne < N + pol.tn * pol.cn
    assert ke < K + pol.tk
    ref = R_tq.pick_policy(M, N, K, prec)
    assert vars(pol) == vars(ref)
    assert oh == R_tq.overhead(M, N, K, ref)
    assert correction_factor(M, N, K, pol) \
        == R_tq.correction_factor(M, N, K, ref)
    assert scale_factor_overhead(M, N, K, prec) \
        == R_tq.scale_factor_overhead(M, N, K, prec)


def test_paper_patterns():
    """Fig. 1 qualitative patterns: overhead decreases with size; aligned
    sizes at N>=4096 stay under ~9-12%; tiny sizes can exceed 50%."""
    pol = lambda n: pick_policy(n, n, n)  # noqa: E731
    big_aligned = [overhead(n, n, n, pol(n)) for n in range(4096, 16385, 128)]
    assert max(big_aligned) <= 0.12
    small = overhead(200, 200, 200, pol(200))
    assert small > 0.5
    # monotone-ish decrease in the mean across UNALIGNED size bands
    lo = np.mean([overhead(n, n, n, pol(n)) for n in range(515, 1024, 97)])
    hi = np.mean([overhead(n, n, n, pol(n)) for n in range(8195, 9216, 97)])
    assert hi < lo


def test_two_level_ceiling_eq4():
    """A matrix fitting exactly into tiles can still pad at cluster level."""
    pol = TilePolicy(512, 512, 512, cm=2, cn=1)
    # M = 3 tiles -> cluster rounds to 4 tiles
    me, _, _ = effective_dims(3 * 512, 512, 512, pol)
    assert me == 4 * 512


def test_correction_factor_inverts_overhead():
    pol = pick_policy(1000, 1000, 1000)
    cf = correction_factor(1000, 1000, 1000, pol)
    assert cf == pytest.approx(
        theoretical_flops(1000, 1000, 1000)
        / profiled_flops(1000, 1000, 1000, pol))
    assert cf <= 1.0
    assert cf == R_tq.correction_factor(1000, 1000, 1000,
                                        R_tq.pick_policy(1000, 1000, 1000))


def test_scale_factor_overhead_shrinks_with_k():
    a = scale_factor_overhead(4096, 4096, 512, "int8")
    b = scale_factor_overhead(4096, 4096, 8192, "int8")
    assert a > b > 0
    assert scale_factor_overhead(4096, 4096, 512, "bf16") == 0.0
