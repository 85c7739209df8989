"""The port's H100 facts against the TPU facts the reference keeps.

  * `core.peaks.H100_SXM`: Eq. 6 gives the data sheet's 989.4 TFLOP/s
    dense bf16, its precision multipliers name what each type runs on,
    and `benchmarks/roofline.py`'s data-sheet constants agree with it;
    `DEFAULT_CHIP` stays the simulated fleet's TPU v5e;
  * `core.tile_quant.pick_policy` with no chip, or a TPU, is the
    reference's own choice; with the H100 it pads to the tiles the card's
    GEMM walks (`kernels/gemm.py` `WGMMA_TILES`, `wgmma_tile_n`, the
    SIMT kernel's 128 x 128 x 16), and `ops.matmul` under it computes
    the reference's product on the CPU;
  * the job profile's and the correlation tier's tile correction take
    the chip: bitwise the reference's for `TPU_V5E`, the H100's tiles
    for the H100.
"""
import dataclasses

import numpy as np
import pytest

from _propcheck import given, settings, st

torch = pytest.importorskip("torch")

import repro.core.tile_quant as R_tq  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.ofu import adjusted_ofu  # noqa: E402
from repro_torch.core.peaks import (CHIPS, DEFAULT_CHIP, H100_SXM,  # noqa: E402
                                    TPU_V5E, TPU_V6E_LIKE)
from repro_torch.core.tile_quant import (correction_factor,  # noqa: E402
                                         effective_dims, pick_policy,
                                         profiled_flops, theoretical_flops)
from repro_torch.fleet import correlation  # noqa: E402
from repro_torch.fleet.jobs import _tile_quant_factor  # noqa: E402
from repro_torch.kernels import gemm, ops  # noqa: E402

PRECS = ["bf16", "int8", "fp32"]
dims = st.integers(min_value=1, max_value=20000)


# ---------------------------------------------------------------------------
# the H100's ChipSpec
# ---------------------------------------------------------------------------
def test_h100_eq6_gives_the_data_sheets_bf16_peak():
    """528 tensor cores x 1,024 dense bf16 FLOPs a clock x 1,830 MHz."""
    h = H100_SXM
    assert h.num_mxu == 132 * 4
    assert h.mxu_rows * h.mxu_cols * h.flops_per_macc == 1024
    assert (h.f_max_mhz, h.f_sm_max_mhz) == (1830.0, 1980.0)
    assert h.peak_tflops("bf16") == pytest.approx(989.4, rel=1e-3)
    assert h.peak_tflops("bf16") == 528 * 1024 * 1830e6 / 1e12
    assert (h.hbm_gbps, h.hbm_gib) == (3350.0, 80.0)
    assert h.ici_links * h.ici_gbps == 450.0           # NVLink 4, each way
    assert CHIPS["h100-sxm"] is h
    assert DEFAULT_CHIP is TPU_V5E


def test_h100_precision_multipliers():
    """fp16 at the bf16 rate, int8 and fp8 twice it, TF32 half; true f32
    on 132 SMs x 128 FP32 lanes x 2 FLOPs at the 1,980 MHz SM clock."""
    m = H100_SXM.precision_mult
    assert (m["bf16"], m["fp16"], m["int8"], m["fp8"], m["tf32"]) \
        == (1.0, 1.0, 2.0, 2.0, 0.5)
    assert m["fp32"] == pytest.approx(132 * 128 * 2 * 1980e6 / 989.42976e12,
                                      rel=1e-12)
    assert m["fp32"] == pytest.approx(0.0676, abs=1e-4)
    assert H100_SXM.peak_tflops("fp32") == pytest.approx(66.908, abs=1e-3)


def test_roofline_data_sheet_constants_agree_with_the_spec():
    """The roofline keeps the data sheet's printed rates.  bf16, int8,
    HBM and NVLink lie within 0.1 % of the spec; the data sheet prints
    whole TFLOP/s, and every peak is the spec's rounded to them (true
    f32: 66.9 -> 67, 0.14 % apart)."""
    h = H100_SXM
    for kind in ("bf16", "int8"):
        assert roofline.PEAK_OPS_PER_S[kind] == pytest.approx(
            h.peak_tflops(kind) * 1e12, rel=1e-3)
    for kind, rate in roofline.PEAK_OPS_PER_S.items():
        assert rate == round(h.peak_tflops(kind)) * 1e12
    assert roofline.FP32_FLOP_PER_S == roofline.PEAK_OPS_PER_S["fp32"]
    assert roofline.HBM_BYTES_PER_S == pytest.approx(h.hbm_gbps * 1e9,
                                                     rel=1e-3)
    assert roofline.NVLINK_BYTES_PER_S == pytest.approx(
        h.ici_links * h.ici_gbps * 1e9, rel=1e-3)


# ---------------------------------------------------------------------------
# tile policies
# ---------------------------------------------------------------------------
@given(dims, dims, dims, st.sampled_from(["bf16", "int8", "fp8", "fp32"]),
       st.sampled_from([None, "tpu-v5e", "tpu-v6e-like"]))
@settings(max_examples=200, deadline=None)
def test_pick_policy_without_the_h100_is_the_references(M, N, K, prec,
                                                        chip):
    chip = CHIPS.get(chip)
    pol = pick_policy(M, N, K, prec, chip)
    ref = R_tq.pick_policy(M, N, K, prec)
    assert vars(pol) == vars(ref)
    assert correction_factor(M, N, K, dtype=prec, chip=chip) \
        == R_tq.correction_factor(M, N, K, dtype=prec)


def test_tpu_chips_take_the_mxu_policies():
    for chip in (TPU_V5E, TPU_V6E_LIKE):
        assert pick_policy(1000, 1000, 1000, chip=chip).name.startswith("mxu")


@given(dims, dims, dims, st.sampled_from(PRECS))
@settings(max_examples=300, deadline=None)
def test_h100_policies_pad_to_the_kernels_tiles(M, N, K, prec):
    pol = pick_policy(M, N, K, prec, H100_SXM)
    assert (pol.cm, pol.cn) == (1, 1)                  # no clusters
    me, ne, ke = effective_dims(M, N, K, pol)
    if prec == "fp32":
        assert (pol.tm, pol.tn, pol.tk) == (128, 128, 16)
    else:
        dtype = torch.bfloat16 if prec == "bf16" else torch.int8
        tm, tn, tk = gemm.WGMMA_TILES[dtype]
        assert me % tm == 0 and ne % tn == 0 and ke % tk == 0
        bn = gemm.wgmma_tile_n(me, ne, ke, dtype)
        assert ne % bn == 0
        if prec == "bf16":                  # the policy names the tile
            assert (pol.tm, pol.tn, pol.tk) == (128, bn, 64)
        else:
            assert (pol.tm, pol.tn, pol.tk) == (128, 128, 128)
    # the padded grid is the executed work, counted both ways
    assert profiled_flops(M, N, K, pol) == gemm.grid_flops(M, N, K, pol) \
        == 2 * me * ne * ke
    assert R_tq.profiled_flops(M, N, K, R_tq.TilePolicy(
        pol.tm, pol.tn, pol.tk, pol.cm, pol.cn)) == 2 * me * ne * ke
    # bf16 pads N to 128 whichever tile it walks
    if prec == "bf16":
        assert ne == -(-N // 128) * 128


def test_h100_has_no_fp8_path():
    with pytest.raises(ValueError, match="no 'fp8' path"):
        pick_policy(128, 128, 128, "fp8", H100_SXM)


@pytest.mark.parametrize("M,N,K,prec", [
    (129, 257, 513, "bf16"), (300, 150, 200, "fp32"), (200, 300, 100, "int8"),
    (128, 512, 64, "bf16"), (1, 3, 5, "fp32")])
def test_h100_matmul_on_the_cpu_is_the_references_product(M, N, K, prec):
    import jax.numpy as jnp

    from repro.kernels.ref import ref_matmul as jref_matmul
    rng = np.random.default_rng(M + N + K)
    if prec == "int8":
        a = rng.integers(-100, 100, (M, K))
        b = rng.integers(-100, 100, (K, N))
        jd, td = jnp.int8, torch.int8
    else:
        a, b = rng.standard_normal((M, K)), rng.standard_normal((K, N))
        jd, td = ((jnp.bfloat16, torch.bfloat16) if prec == "bf16"
                  else (jnp.float32, torch.float32))
    xt = torch.from_numpy(a.astype(np.float32)).to(td)
    yt = torch.from_numpy(b.astype(np.float32)).to(td)
    want = np.asarray(jref_matmul(jnp.asarray(a.astype(np.float32)).astype(jd),
                                  jnp.asarray(b.astype(np.float32)).astype(jd)),
                      np.float64)
    out, prof = ops.matmul(xt, yt, chip=H100_SXM)
    assert prof.policy == pick_policy(M, N, K, prec, H100_SXM)
    assert prof.theoretical_flops == theoretical_flops(M, N, K)
    assert prof.profiled_flops == profiled_flops(M, N, K, prof.policy)
    assert out.shape == (M, N)
    if prec == "int8":
        np.testing.assert_array_equal(out.numpy(), want)
    else:
        tol = 1e-4 if prec == "fp32" else 2e-2
        np.testing.assert_allclose(out.float().numpy(), want,
                                   rtol=tol * 10, atol=tol)


# ---------------------------------------------------------------------------
# the chip-aware tile correction
# ---------------------------------------------------------------------------
#: a config whose dominant GEMMs are ragged on both chips' tiles
RAGGED = dataclasses.replace(get_config("granite-3-2b"), name="ragged",
                             d_model=1300, d_ff=4500)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small",
                                  "zamba2-7b", "mamba2-780m"])
def test_tile_quant_factor_is_the_references_on_the_tpu(arch):
    from repro.configs import get_config as R_get
    from repro.fleet.jobs import _tile_quant_factor as R_factor
    assert _tile_quant_factor(get_config(arch), TPU_V5E) \
        == R_factor(R_get(arch), TPU_V5E)
    assert _tile_quant_factor(RAGGED, TPU_V5E) == R_factor(
        dataclasses.replace(R_get("granite-3-2b"), name="ragged",
                            d_model=1300, d_ff=4500), TPU_V5E)


def test_tile_quant_factor_takes_the_h100s_tiles():
    shapes = [(4096, 1300, 1300), (4096, 4500, 1300)]
    want = float(np.mean([profiled_flops(m, n, k, pick_policy(
        m, n, k, chip=H100_SXM)) / theoretical_flops(m, n, k)
        for m, n, k in shapes]))
    got = _tile_quant_factor(RAGGED, H100_SXM)
    assert got == want
    assert got != _tile_quant_factor(RAGGED, TPU_V5E)
    assert 1.0 < got < _tile_quant_factor(RAGGED, TPU_V5E)


def test_correlation_corrects_by_the_configured_chip(monkeypatch):
    """`CorrelationConfig.chip` reaches the Eq. 8 correction of every
    joined job: the same rollups give each chip's tile factor."""
    from repro_torch.configs import base
    from repro_torch.fleet.streaming import StreamingRollup
    from repro_torch.telemetry.scrape import DeviceGrid
    monkeypatch.setattr(correlation, "_TQ_CACHE", {})
    get = base.get_config
    monkeypatch.setattr(base, "get_config",
                        lambda a: RAGGED if a == "ragged" else get(a))
    roll, mfu = StreamingRollup(bucket_s=300.0), \
        correlation.MfuRollup(300.0)
    t = np.arange(1, 21) * 30.0
    grid = DeviceGrid(30.0, np.full((2, 20), 0.4), np.full((2, 20), 1500.0))
    roll.add_grid("j", grid, app_mfu=0.4, arch="ragged", chips=2)
    mfu.observe_series("j", t, np.full(20, 0.4))
    rows = {}
    for chip in (TPU_V5E, H100_SXM):
        cfg = correlation.CorrelationConfig(ofu_floor=0.0, chip=chip)
        (row,) = correlation.analyze_correlation(mfu, roll, config=cfg).jobs
        assert row["tq_factor"] == _tile_quant_factor(RAGGED, chip)
        assert row["ofu_adj"] == pytest.approx(row["ofu"] / row["tq_factor"])
        rows[chip.name] = row
    assert rows["h100-sxm"]["ofu_adj"] != rows["tpu-v5e"]["ofu_adj"]
    assert correlation.CorrelationConfig().chip is DEFAULT_CHIP


def test_adjusted_ofu_under_the_h100_policy():
    """Eq. 8 on one ragged GEMM: OFU x theoretical / executed FLOPs."""
    pol = pick_policy(7000, 9000, 5000, "bf16", H100_SXM)
    cf = correction_factor(7000, 9000, 5000, pol)
    assert cf == correction_factor(7000, 9000, 5000, chip=H100_SXM)
    assert adjusted_ofu(0.8, theoretical_flops(7000, 9000, 5000),
                        profiled_flops(7000, 9000, 5000, pol)) \
        == pytest.approx(0.8 * cf)
