"""The port's kernel API (`repro_torch.kernels.ops`, `gemm`, `ssd_scan`,
`flash_attention`) against the JAX package's on the same numpy-seeded
inputs, at the tolerances of `tests/test_kernels.py`: on the CPU each
wrapper runs its kernel's plain version, the JAX side runs its Pallas
kernels in interpret mode.  GemmProfile fields and executed FLOPs are
held equal exactly, int8 products bitwise.

The CUDA kernels are held to their plain versions on the card by the
`gpu` tests at the end, which import nothing of JAX:
`pytest -m gpu tests/test_torch_kernels.py`."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _propcheck import given, settings, st  # noqa: E402

from repro_torch.core.tile_quant import TilePolicy  # noqa: E402
from repro_torch.core.tile_quant import pick_policy  # noqa: E402
from repro_torch.core.tile_quant import profiled_flops  # noqa: E402
from repro_torch.examples.gemm_characterization import (  # noqa: E402
    SHAPES as CHARACTERIZATION_SHAPES)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gemm, ops, ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_kernel)
from repro_torch.kernels.ref import (ref_attention, ref_matmul,  # noqa: E402
                                     ref_ssd_intra)
from repro_torch.kernels.ssd_scan import ssd_intra_kernel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEMM_SHAPES = [(128, 128, 128), (256, 512, 384), (300, 150, 200),
               (1, 128, 128), (129, 257, 513)]
FLASH_SHAPES = [(2, 128, 128, 8, 8, 32, True), (2, 128, 128, 8, 2, 32, True),
                (1, 64, 128, 4, 4, 16, False), (2, 256, 256, 4, 1, 64, True)]
SSD_SHAPES = [(4, 16, 4, 16, 8, 2), (2, 32, 8, 8, 16, 4), (1, 64, 2, 32, 4, 2)]


def _jnp():
    return pytest.importorskip("jax").numpy


def _pair(a: np.ndarray, jdtype, tdtype):
    """One numpy array as a jax array of jdtype and the torch tensor of
    the very same values (bf16 rounded once, by jax)."""
    jnp = _jnp()
    j = jnp.asarray(a, jdtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdtype)


def _same_profile(pt, pj):
    assert (pt.M, pt.N, pt.K, pt.theoretical_flops, pt.profiled_flops) == \
        (pj.M, pj.N, pj.K, pj.theoretical_flops, pj.profiled_flops)
    assert dataclasses.astuple(pt.policy) == dataclasses.astuple(pj.policy)
    assert pt.overhead == pj.overhead


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_reference(M, N, K, dtype):
    jnp = _jnp()
    from repro.core.tile_quant import TilePolicy as JTilePolicy
    from repro.kernels import ops as jops
    from repro.kernels.ref import ref_matmul as jref_matmul
    rng = np.random.default_rng(M * 7 + N * 3 + K)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _pair(rng.standard_normal((M, K)), jd, td)
    yj, yt = _pair(rng.standard_normal((K, N)), jd, td)
    out, prof = ops.matmul(xt, yt, policy=TilePolicy(128, 128, 128))
    jout, jprof = jops.matmul(xj, yj, policy=JTilePolicy(128, 128, 128))
    assert out.shape == (M, N) and out.dtype == td
    tol = 1e-4 if dtype == "float32" else 2e-2
    for want in (jout, jref_matmul(xj, yj)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol * 10, atol=tol)
    _same_profile(prof, jprof)
    assert prof.profiled_flops >= prof.theoretical_flops


def test_gemm_int8_is_exact():
    jnp = _jnp()
    from repro.core.tile_quant import TilePolicy as JTilePolicy
    from repro.kernels import ops as jops
    rng = np.random.default_rng(42)
    xj, xt = _pair(rng.integers(-100, 100, (200, 300)), jnp.int8, torch.int8)
    yj, yt = _pair(rng.integers(-100, 100, (300, 100)), jnp.int8, torch.int8)
    out, prof = ops.matmul(xt, yt, policy=TilePolicy(128, 128, 128))
    jout, jprof = jops.matmul(xj, yj, policy=JTilePolicy(128, 128, 128))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.numpy(), ref_matmul(xt, yt).numpy())
    _same_profile(prof, jprof)


@pytest.mark.parametrize("M,N,K,dtype", [(300, 150, 200, "float32"),
                                         (129, 257, 513, "bfloat16")])
def test_gemm_cluster_policy_matches_reference(M, N, K, dtype):
    """cm = cn = 2 pads M and N to whole 2-tile clusters (Eq. 4)."""
    jnp = _jnp()
    from repro.core.tile_quant import TilePolicy as JTilePolicy
    from repro.kernels import ops as jops
    rng = np.random.default_rng(1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _pair(rng.standard_normal((M, K)), jd, td)
    yj, yt = _pair(rng.standard_normal((K, N)), jd, td)
    out, prof = ops.matmul(xt, yt, policy=TilePolicy(128, 128, 128, cm=2,
                                                     cn=2))
    jout, jprof = jops.matmul(xj, yj, policy=JTilePolicy(128, 128, 128,
                                                         cm=2, cn=2))
    _same_profile(prof, jprof)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=tol * 10, atol=tol)
    me, ne = -(-M // 256) * 256, -(-N // 256) * 256
    assert prof.profiled_flops == 2 * me * ne * (-(-K // 128) * 128)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 5000), st.integers(1, 5000), st.integers(1, 5000),
       st.sampled_from([128, 256, 512]), st.sampled_from([128, 256, 512]),
       st.sampled_from([128, 256, 512]), st.integers(1, 2),
       st.integers(1, 2))
def test_grid_flops_equals_reference_and_closed_form(M, N, K, tm, tn, tk,
                                                     cm, cn):
    from repro.core.tile_quant import TilePolicy as JTilePolicy
    from repro.kernels.gemm import grid_flops as jgrid_flops
    pt = TilePolicy(tm, tn, tk, cm=cm, cn=cn)
    got = gemm.grid_flops(M, N, K, pt)
    assert got == jgrid_flops(M, N, K, JTilePolicy(tm, tn, tk, cm=cm, cn=cn))
    assert got == profiled_flops(M, N, K, pt)
    assert got >= 2 * M * N * K


def test_gemm_padded_rejects_what_it_does_not_take():
    pol = TilePolicy(128, 128, 128)
    with pytest.raises(ValueError, match="not padded"):
        gemm.gemm_padded(torch.ones((100, 128)), torch.ones((128, 128)), pol)
    with pytest.raises(ValueError, match="do not chain"):
        gemm.gemm_padded(torch.ones((128, 128)), torch.ones((256, 128)), pol)
    with pytest.raises(ValueError, match="one dtype"):
        gemm.gemm_padded(torch.ones((128, 128)),
                         torch.ones((128, 128), dtype=torch.float64), pol)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma_bf16"),
                                        (torch.float32, "simt"),
                                        (torch.int8, "wgmma_s8")])
def test_gemm_variant_is_chosen_by_dtype(dtype, want):
    assert gemm.variant(dtype) == want


@pytest.mark.parametrize("M,N,K,bn", [(128, 128, 64, 128), (128, 256, 64, 256),
                                      (256, 384, 640, 128),
                                      (4096, 8192, 3072, 256),
                                      (1536, 768, 768, 256)])
def test_wgmma_tile_n_takes_256_where_it_divides(M, N, K, bn):
    assert gemm.wgmma_tile_n(M, N, K) == bn


@pytest.mark.parametrize("M,N,K", [(100, 128, 64), (64, 128, 64),
                                   (128, 192, 64), (128, 128, 96),
                                   (128, 128, 32)])
def test_wgmma_tile_n_rejects_what_is_not_a_whole_tile(M, N, K):
    with pytest.raises(ValueError, match=r"\(128, 128, 64\) tiles"):
        gemm.wgmma_tile_n(M, N, K)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 5000), st.integers(1, 5000), st.integers(1, 5000))
def test_every_bf16_policy_pads_to_whole_wgmma_tiles(M, N, K):
    """`pick_policy`'s bf16 choices all have tm, tn, tk >= 128, so the
    operands `ops.matmul` pads for them always suit the wgmma path."""
    pol = pick_policy(M, N, K, "bf16")
    me = -(-M // (pol.tm * pol.cm)) * pol.tm * pol.cm
    ne = -(-N // (pol.tn * pol.cn)) * pol.tn * pol.cn
    ke = -(-K // pol.tk) * pol.tk
    assert gemm.wgmma_tile_n(me, ne, ke) in (128, 256)


#: the fleet models' dominant GEMMs (granite-3-2b, llama3.2-3b at 4,096
#: tokens)
FLEET_GEMMS = [(4096, 2048, 2048), (4096, 8192, 2048), (4096, 3072, 3072),
               (4096, 8192, 3072)]


@pytest.mark.parametrize("M,N,K", FLEET_GEMMS + CHARACTERIZATION_SHAPES
                         + GEMM_SHAPES + [(1500, 768, 768), (1, 1, 1),
                                          (4097, 8193, 3073)])
def test_every_int8_policy_pads_to_whole_wgmma_tiles(M, N, K):
    """`pick_policy`'s int8 choices (mxu_128/256/512, mxu_256_k512) all
    have tm, tn, tk >= 128, so the operands `ops.matmul` pads for them
    always suit the int8 wgmma path's (128, 128, 128) tiles."""
    pol = pick_policy(M, N, K, "int8")
    me = -(-M // (pol.tm * pol.cm)) * pol.tm * pol.cm
    ne = -(-N // (pol.tn * pol.cn)) * pol.tn * pol.cn
    ke = -(-K // pol.tk) * pol.tk
    assert gemm.wgmma_tile_n(me, ne, ke, torch.int8) in (128, 256)


@pytest.mark.parametrize("M,N,K,bn", [(128, 128, 128, 128),
                                      (128, 256, 128, 256),
                                      (256, 384, 640, 128),
                                      (4096, 8192, 3072, 256)])
def test_int8_wgmma_tile_n_takes_256_where_it_divides(M, N, K, bn):
    assert gemm.wgmma_tile_n(M, N, K, torch.int8) == bn


@pytest.mark.parametrize("M,N,K", [(64, 64, 64), (128, 128, 64),
                                   (100, 128, 128), (128, 192, 128),
                                   (128, 128, 192)])
def test_int8_wgmma_tile_n_rejects_what_is_not_a_whole_tile(M, N, K):
    """int8 stages are 128 values deep: K_eff 64 or 192, which the bf16
    path takes, is no whole int8 tile."""
    with pytest.raises(ValueError, match=r"int8 .* \(128, 128, 128\) tiles"):
        gemm.wgmma_tile_n(M, N, K, torch.int8)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
def _ssd_inputs(rng, BC, Q, nh, hd, ds):
    x = rng.standard_normal((BC, Q, nh, hd)) * 0.5
    dt = rng.uniform(0.001, 0.1, (BC, Q, nh))
    A = -rng.uniform(0.5, 2.0, (nh,))
    dacs = np.cumsum(dt.astype(np.float32) * A.astype(np.float32), axis=1)
    b = rng.standard_normal((BC, Q, nh, ds)) * 0.3
    c = rng.standard_normal((BC, Q, nh, ds)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, dacs, b, c)]


@pytest.mark.parametrize("BC,Q,nh,hd,ds,hb", SSD_SHAPES)
def test_ssd_intra_matches_reference(BC, Q, nh, hd, ds, hb):
    jnp = _jnp()
    from repro.kernels.ref import ref_ssd_intra as jref_ssd_intra
    from repro.kernels.ssd_scan import ssd_intra_kernel as jssd_intra
    arrs = _ssd_inputs(np.random.default_rng(BC * Q + nh), BC, Q, nh, hd, ds)
    out = ssd_intra_kernel(*map(torch.from_numpy, arrs), head_block=hb)
    jin = [jnp.asarray(a) for a in arrs]
    for want in (jssd_intra(*jin, head_block=hb, interpret=True),
                 jref_ssd_intra(*jin)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)


def test_ssd_intra_rejects_head_block_and_shapes():
    arrs = [torch.from_numpy(a)
            for a in _ssd_inputs(np.random.default_rng(0), 1, 8, 6, 4, 4)]
    with pytest.raises(ValueError, match="head_block"):
        ssd_intra_kernel(*arrs, head_block=4)
    with pytest.raises(ValueError, match="expected x"):
        ssd_intra_kernel(arrs[0], arrs[1][:, :4], *arrs[2:])


@pytest.mark.parametrize("B,S,nh,hd,g,ds,Q,dtype", [
    (2, 64, 4, 16, 2, 8, 16, "float32"),      # test_kernels.py's case
    (1, 96, 6, 8, 3, 4, 32, "float32"),       # three chunks, 2 heads a group
    (1, 64, 4, 16, 1, 16, 64, "bfloat16"),    # one chunk, the model's dtype
])
def test_ssd_full_path_matches_reference(B, S, nh, hd, g, ds, Q, dtype):
    jnp = _jnp()
    from repro.kernels import ops as jops
    rng = np.random.default_rng(S + nh)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    xj, xt = _pair(rng.standard_normal((B, S, nh, hd)) * 0.5, jd, td)
    dtj, dtt = _pair(rng.uniform(0.001, 0.1, (B, S, nh)), jnp.float32,
                     torch.float32)
    Aj, At = _pair(-rng.uniform(0.5, 2.0, (nh,)), jnp.float32, torch.float32)
    Bj, Bt = _pair(rng.standard_normal((B, S, g, ds)) * 0.3, jd, td)
    Cj, Ct = _pair(rng.standard_normal((B, S, g, ds)) * 0.3, jd, td)
    yt = ops.ssd(xt, dtt, At, Bt, Ct, chunk=Q)
    yj = jops.ssd(xj, dtj, Aj, Bj, Cj, chunk=Q)
    assert yt.shape == (B, S, nh, hd) and yt.dtype == td
    tol = 1e-3 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ssd_intra_inputs_are_what_the_kernel_takes(g):
    """The kernel's inputs: contiguous, f32 dt/dacs, B/C in their groups
    with no copy a head, dacs the within-chunk cumsum of dt·A."""
    B, S, nh, hd, ds, Q = 2, 32, 4, 8, 4, 16
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.standard_normal((B, S, nh, hd))).float()
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, S, nh))).float()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (nh,))).float()
    Bm = torch.from_numpy(rng.standard_normal((B, S, g, ds))).bfloat16()
    xk, dtk, dacs, b, c = ops.ssd_intra_inputs(x, dt, A, Bm, Bm, chunk=Q)
    assert all(t.is_contiguous() for t in (xk, dtk, dacs, b, c))
    assert dtk.dtype == dacs.dtype == torch.float32
    assert b.dtype == torch.bfloat16 and b.shape == (B * S // Q, Q, g, ds)
    assert torch.equal(b, Bm.reshape(-1, Q, g, ds))
    torch.testing.assert_close(dacs, torch.cumsum(dtk * A, dim=1))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_ssd_intra_group_layout_is_the_per_head_broadcast(g):
    """B/C in g groups give what the reference gives on its per-head
    layout with head h holding group h // (nh / g)."""
    jnp = _jnp()
    from repro.kernels.ref import ref_ssd_intra as jref_ssd_intra
    BC, Q, nh, hd, ds = 2, 16, 4, 8, 4
    x, dt, dacs, b, c = _ssd_inputs(np.random.default_rng(g), BC, Q, nh, hd,
                                    ds)
    bg, cg = b[:, :, :g], c[:, :, :g]
    heads = np.arange(nh) // (nh // g)
    out = ssd_intra_kernel(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (x, dt, dacs, bg, cg)))
    want = jref_ssd_intra(*(jnp.asarray(a) for a in
                            (x, dt, dacs, bg[:, :, heads], cg[:, :, heads])))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)


def test_ssd_rejects_ragged_chunks():
    x = torch.zeros((1, 48, 2, 4))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, torch.zeros((1, 48, 2)), torch.zeros(2),
                torch.zeros((1, 48, 1, 4)), torch.zeros((1, 48, 1, 4)),
                chunk=32)


@pytest.mark.parametrize("dtype,Q,hd,ds,want", [
    (torch.bfloat16, 256, 64, 128, "wgmma_bf16"),   # mamba2-780m
    (torch.bfloat16, 256, 64, 64, "wgmma_bf16"),    # zamba2-7b
    (torch.bfloat16, 256, 128, 256, "wgmma_bf16"),
    (torch.bfloat16, 64, 64, 128, "wgmma_bf16"),
    (torch.bfloat16, 48, 64, 128, "simt"),          # Q not a multiple of 64
    (torch.bfloat16, 256, 96, 128, "simt"),         # hd not 64 or 128
    (torch.bfloat16, 256, 64, 32, "simt"),          # ds under a 64-wide box
    (torch.bfloat16, 256, 64, 320, "simt"),         # ds past 256
    (torch.bfloat16, 2048, 64, 128, "simt"),        # Q past 1,024
    (torch.float32, 256, 64, 128, "simt"),
    (torch.float32, 64, 128, 64, "simt")])
def test_ssd_variant_is_chosen_by_dtype_and_shape(dtype, Q, hd, ds, want):
    assert ssd_scan.variant(dtype, Q, hd, ds) == want


@pytest.mark.parametrize("hd,nh,g,want", [
    (64, 48, 1, 2),          # mamba2-780m: 48 heads share one group
    (64, 112, 2, 2),         # zamba2-7b: 56 heads a group
    (64, 6, 2, 1),           # 3 heads a group: only one head a block divides
    (64, 6, 6, 1),           # one head a group
    (128, 8, 1, 1)])         # hd 128: one head's Y fills the registers
def test_ssd_wgmma_heads_divide_each_group(hd, nh, g, want):
    hb = ssd_scan.wgmma_heads(hd, nh, g)
    assert hb == want and (nh // g) % hb == 0


@pytest.mark.parametrize("hd,want", [
    (8, 16), (16, 16), (32, 16),         # Y: hd_pad registers a head
    (64, 4), (96, 4), (128, 4)])         # in each of 4 quarters
def test_ssd_simt_heads_fill_at_most_128_registers(hd, want):
    hd_pad = next(p for p in (16, 32, 64, 128) if hd <= p)
    assert ssd_scan.simt_heads(hd) == want
    assert want % 4 == 0 and want // 4 * hd_pad <= 128


@pytest.mark.parametrize("dtype,Q,hd,ds", [
    (torch.bfloat16, 64, 64, 64),        # a shape of the wgmma kernel
    (torch.float32, 16, 8, 4)])
def test_ssd_cpu_dispatch_counts_no_variant(dtype, Q, hd, ds):
    x, dt, dacs, b, c = (torch.from_numpy(a) for a in _ssd_inputs(
        np.random.default_rng(Q), 1, Q, 2, hd, ds))
    x, b, c = (t.to(dtype) for t in (x, b, c))
    before = (ssd_intra_kernel.launches, dict(ssd_intra_kernel.launches_by))
    out = ssd_intra_kernel(x, dt, dacs, b, c)
    assert out.dtype == dtype and out.shape == x.shape
    assert before == (ssd_intra_kernel.launches,
                      ssd_intra_kernel.launches_by)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def _qkv(seed, B, Sq, Sk, H, KV, hd, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s), jdtype, tdtype)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", FLASH_SHAPES + [
    (2, 128, 200, 8, 2, 32, True),     # ragged Sk: the reference falls back
    (2, 100, 100, 4, 2, 32, True),     # ragged Sq: the reference pads q
    (1, 100, 200, 4, 4, 16, False),    # both ragged, cross-shaped
    (2, 128, 128, 4, 4, 96, True),     # phi-3-vision's head dim
    (1, 128, 128, 8, 2, 112, True),    # zamba2's, GQA
    (1, 128, 128, 8, 2, 192, True),    # nemotron-4-340b's, GQA
    (1, 64, 200, 4, 2, 192, False),    # hd 192, ragged Sk
])
def test_flash_matches_reference(B, Sq, Sk, H, KV, hd, causal):
    jnp = _jnp()
    from repro.kernels import ops as jops
    from repro.kernels.ref import ref_attention as jref_attention
    (qj, qt), (kj, kt), (vj, vt) = _qkv(Sq + Sk + H, B, Sq, Sk, H, KV, hd,
                                        jnp.float32, torch.float32)
    out = ops.flash(qt, kt, vt, causal=causal)
    assert out.shape == (B, Sq, H, hd)
    for want in (jops.flash(qj, kj, vj, causal=causal, bq=64, bkv=64),
                 jref_attention(qj, kj, vj, causal=causal)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)


def test_flash_bf16_matches_reference():
    jnp = _jnp()
    from repro.kernels import ops as jops
    (qj, qt), (kj, kt), (vj, vt) = _qkv(3, 2, 128, 128, 4, 4, 32,
                                        jnp.bfloat16, torch.bfloat16)
    out = ops.flash(qt, kt, vt, causal=True)
    want = jops.flash(qj, kj, vj, causal=True, bq=64, bkv=64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("hd", [96, 192])
def test_flash_bf16_matches_reference_at_wide_heads(hd):
    """bf16 at the head dims the tensor-core kernel pads (96) or tiles
    in three boxes (192), at the bf16 test's 5e-2."""
    jnp = _jnp()
    from repro.kernels import ops as jops
    (qj, qt), (kj, kt), (vj, vt) = _qkv(hd, 1, 128, 128, 8, 2, hd,
                                        jnp.bfloat16, torch.bfloat16)
    out = ops.flash(qt, kt, vt, causal=True)
    want = jops.flash(qj, kj, vj, causal=True, bq=64, bkv=64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_flash_rejects_bad_shapes():
    q = torch.zeros((1, 8, 6, 16))
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention_kernel(q, torch.zeros((1, 8, 4, 16)),
                               torch.zeros((1, 8, 4, 16)), causal=True)
    with pytest.raises(ValueError, match="alike"):
        flash_attention_kernel(q, torch.zeros((1, 8, 2, 8)),
                               torch.zeros((1, 8, 2, 8)), causal=True)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma_bf16"), (torch.bfloat16, 128, "wgmma_bf16"),
    (torch.bfloat16, 96, "wgmma_bf16"),  # phi-3-vision's head dim
    (torch.bfloat16, 112, "wgmma_bf16"),  # zamba2's
    (torch.bfloat16, 192, "wgmma_bf16"),  # nemotron-4-340b's
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 256, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 192, "simt")])
def test_flash_variant_is_chosen_by_dtype_and_head_dim(dtype, hd, want):
    assert fa.variant(dtype, hd) == want


def test_cpu_dispatch_never_counts_a_launch():
    before = (gemm.gemm_padded.launches, gemm.gemm_padded.launched_flops,
              ssd_intra_kernel.launches, flash_attention_kernel.launches,
              dict(gemm.gemm_padded.launches_by),
              dict(flash_attention_kernel.launches_by))
    ops.matmul(torch.ones((3, 5)), torch.ones((5, 2)))
    ops.matmul(torch.ones((3, 5), dtype=torch.bfloat16),
               torch.ones((5, 2), dtype=torch.bfloat16))
    ops.flash(torch.ones((1, 4, 2, 8)), torch.ones((1, 4, 2, 8)),
              torch.ones((1, 4, 2, 8)), causal=True)
    ops.flash(*(torch.ones((1, 4, 2, 64), dtype=torch.bfloat16)
                for _ in range(3)), causal=True)
    ssd_intra_kernel(*[torch.from_numpy(a) for a in
                       _ssd_inputs(np.random.default_rng(0), 1, 8, 2, 4, 4)])
    assert before == (gemm.gemm_padded.launches,
                      gemm.gemm_padded.launched_flops,
                      ssd_intra_kernel.launches,
                      flash_attention_kernel.launches,
                      gemm.gemm_padded.launches_by,
                      flash_attention_kernel.launches_by)


# ---------------------------------------------------------------------------
# the characterization entry point
# ---------------------------------------------------------------------------
def test_characterization_matches_reference_example(capsys):
    _jnp()                                   # the example imports jax
    spec = importlib.util.spec_from_file_location(
        "jax_gemm_characterization", ROOT / "examples" /
        "gemm_characterization.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    jex.main()
    jlines = capsys.readouterr().out.strip().splitlines()
    from repro_torch.examples import gemm_characterization as tex
    results = tex.main(device="cpu")
    tlines = capsys.readouterr().out.strip().splitlines()
    assert tex.SHAPES == jex.SHAPES
    n = 1 + len(tex.SHAPES)                  # header and one row a shape
    assert tlines[:n] == jlines[:n]
    from repro.kernels import ops as jops
    jnp = _jnp()
    rng = np.random.default_rng(0)
    for (M, N, K), (out, prof) in zip(tex.SHAPES, results):
        x = jnp.asarray(rng.standard_normal((M, K)), jnp.float32)
        y = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
        jout, jprof = jops.matmul(x, y)
        _same_profile(prof, jprof)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-3, atol=1e-4)


def test_characterization_needs_a_card_unless_told():
    from repro_torch.examples import gemm_characterization as tex
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.main()


# ---------------------------------------------------------------------------
# the CUDA kernels themselves: only on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gemm_kernel_matches_plain_version(cuda, M, N, K, dtype):
    gen = torch.Generator().manual_seed(M + N + K)
    if dtype == "int8":
        x = torch.randint(-100, 100, (M, K), generator=gen, dtype=torch.int8)
        y = torch.randint(-100, 100, (K, N), generator=gen, dtype=torch.int8)
        x, y = x.to(cuda), y.to(cuda)
    else:
        x = _randn(gen, (M, K), getattr(torch, dtype), cuda)
        y = _randn(gen, (K, N), getattr(torch, dtype), cuda)
    n0, f0 = gemm.gemm_padded.launches, gemm.gemm_padded.launched_flops
    out, prof = ops.matmul(x, y, policy=TilePolicy(128, 128, 128))
    torch.cuda.synchronize()
    assert gemm.gemm_padded.launches == n0 + 1
    assert gemm.gemm_padded.launched_flops - f0 == prof.profiled_flops
    want = ref_matmul(x, y)
    if dtype == "int8":
        assert torch.equal(out, want)
    else:
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(out.float(), want.float(), rtol=tol * 10,
                                   atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,nh,hd,ds,hb", SSD_SHAPES + [
    (2, 256, 8, 64, 128, 8)])          # a chunk of mamba2-780m's widths
def test_ssd_kernel_matches_plain_version(cuda, BC, Q, nh, hd, ds, hb):
    arrs = [torch.from_numpy(a).to(cuda) for a in
            _ssd_inputs(np.random.default_rng(Q), BC, Q, nh, hd, ds)]
    n0 = ssd_intra_kernel.launches
    by = dict(ssd_intra_kernel.launches_by)
    out = ssd_intra_kernel(*arrs, head_block=hb)
    torch.cuda.synchronize()
    assert ssd_intra_kernel.launches == n0 + 1
    assert ssd_intra_kernel.launches_by == {**by, "simt": by["simt"] + 1}
    torch.testing.assert_close(out, ref_ssd_intra(*arrs), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", FLASH_SHAPES + [
    (2, 128, 200, 8, 2, 32, True), (2, 100, 100, 4, 2, 32, True),
    (1, 300, 300, 6, 2, 128, True), (1, 300, 300, 6, 2, 192, True),
    (1, 130, 200, 4, 2, 256, False)])
def test_flash_kernel_matches_plain_version(cuda, B, Sq, Sk, H, KV, hd,
                                            causal):
    gen = torch.Generator().manual_seed(Sq + Sk)
    q = _randn(gen, (B, Sq, H, hd), torch.float32, cuda)
    k = _randn(gen, (B, Sk, KV, hd), torch.float32, cuda)
    v = _randn(gen, (B, Sk, KV, hd), torch.float32, cuda)
    n0 = flash_attention_kernel.launches
    out = ops.flash(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    torch.testing.assert_close(out, ref_attention(q, k, v, causal=causal),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 192),
                                      (torch.float32, 256),
                                      (torch.bfloat16, 256)])
def test_flash_simt_takes_head_dims_up_to_256(cuda, dtype, hd):
    """Head dims past 128 (nemotron-4-340b's 192 and up to 256) run the
    SIMT kernel's 8-dims-a-lane class, with its key and value tiles in
    dynamic shared memory (64 KB at hd 256); f32 at 1e-3, bf16 at 5e-2."""
    gen = torch.Generator().manual_seed(hd)
    q = _randn(gen, (1, 200, 8, hd), dtype, cuda)
    k = _randn(gen, (1, 230, 2, hd), dtype, cuda)
    v = _randn(gen, (1, 230, 2, hd), dtype, cuda)
    by = dict(flash_attention_kernel.launches_by)
    out = ops.flash(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches_by == {**by,
                                                  "simt": by["simt"] + 1}
    tol = 1e-3 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref_attention(
        q, k, v, causal=True).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [
    (torch.float32, 16), (torch.float32, 96), (torch.float32, 192),
    (torch.float32, 256), (torch.bfloat16, 32), (torch.bfloat16, 256),
    (torch.float32, 18)])                # rows not 16-byte multiples
@pytest.mark.parametrize("Sq,Sk", [(130, 200), (200, 130)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_simt_tiles_hold_at_their_edges(cuda, dtype, hd, Sq, Sk, G,
                                              causal):
    """The SIMT kernel's 128-row (64 past hd 128) by 64-key tiles at
    edges they do not divide, Sq < Sk and Sq > Sk, GQA groups of 1 and 4,
    causal and full, and rows its 16-byte copies cannot take; f32 at
    1e-3, bf16 at 5e-2, one `simt` launch."""
    assert fa.variant(dtype, hd) == "simt"
    gen = torch.Generator().manual_seed(hd + Sq + 7 * G + causal)
    q = _randn(gen, (2, Sq, 2 * G, hd), dtype, cuda)
    k = _randn(gen, (2, Sk, 2, hd), dtype, cuda)
    v = _randn(gen, (2, Sk, 2, hd), dtype, cuda)
    by = dict(flash_attention_kernel.launches_by)
    out = flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches_by == {**by,
                                                  "simt": by["simt"] + 1}
    tol = 1e-3 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), ref_attention(
        q, k, v, causal=causal).float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,nh,hd,g,ds", [
    (2, 64, 14, 64, 1, 128),     # 14 heads a group: blocks of 4 and 2
    (2, 256, 12, 64, 2, 128),    # 6 heads a group: blocks of 4 and 2
    (2, 256, 6, 16, 6, 16),      # g = nh: one head a block
    (3, 64, 18, 16, 1, 256),     # hd 16: 18 heads, blocks of 16 and 2
    (1, 256, 10, 128, 1, 256),   # hd 128: blocks of 4, 4, 2; ds 256
    (2, 256, 20, 128, 2, 16),    # hd 128, ds 16: 10 heads a group
    (2, 100, 6, 64, 2, 128),     # Q past one strip, not a multiple of 64
    (1, 80, 4, 100, 1, 200),     # hd 100, ds 200: ragged X tile and chunk
    (2, 64, 4, 18, 2, 10)])      # rows not 16-byte multiples: plain loads
def test_ssd_simt_head_blocks_hold_at_their_edges(cuda, BC, Q, nh, hd, g,
                                                  ds):
    """The SIMT kernel's head blocks (`simt_heads`: 16 up to hd 32, 4 past
    it) where a group's heads do not fill them, one group, two and one a
    head, state in one chunk of 128 and in two; f32 at 1e-3, one `simt`
    launch."""
    assert ssd_scan.variant(torch.float32, Q, hd, ds) == "simt"
    x, dt, dacs, b, c = (torch.from_numpy(a).to(cuda) for a in _ssd_inputs(
        np.random.default_rng(BC * Q + nh + hd + ds), BC, Q, nh, hd, ds))
    bg, cg = b[:, :, :g].contiguous(), c[:, :, :g].contiguous()
    by = dict(ssd_intra_kernel.launches_by)
    # (head_block is the reference's blocking, which the card ignores)
    out = ssd_intra_kernel(x, dt, dacs, bg, cg, head_block=1)
    torch.cuda.synchronize()
    assert ssd_intra_kernel.launches_by == {**by, "simt": by["simt"] + 1}
    torch.testing.assert_close(out, ref_ssd_intra(x, dt, dacs, bg, cg),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_ssd_simt_takes_bf16_at_other_head_dims(cuda):
    """bf16 at hd 96, which the tensor-core kernel does not take, with
    Mamba2's dt and A, at chip_smoke.py's full-width limit."""
    BC, Q, nh, hd, g, ds = 2, 128, 6, 96, 2, 128
    assert ssd_scan.variant(torch.bfloat16, Q, hd, ds) == "simt"
    gen = torch.Generator().manual_seed(96)
    x = _randn(gen, (BC, Q, nh, hd), torch.bfloat16, cuda, 0.5)
    dt = torch.exp(torch.empty((BC, Q, nh)).uniform_(
        np.log(1e-3), np.log(1e-1), generator=gen))
    A = -torch.empty(nh).uniform_(1.0, 16.0, generator=gen)
    dt, dacs = dt.to(cuda), torch.cumsum(dt * A, dim=1).to(cuda)
    b = _randn(gen, (BC, Q, g, ds), torch.bfloat16, cuda, 0.3)
    c = _randn(gen, (BC, Q, g, ds), torch.bfloat16, cuda, 0.3)
    by = dict(ssd_intra_kernel.launches_by)
    out = ssd_intra_kernel(x, dt, dacs, b, c)
    torch.cuda.synchronize()
    assert ssd_intra_kernel.launches_by == {**by, "simt": by["simt"] + 1}
    _close_rows(out, ref_ssd_intra(x, dt, dacs, b, c))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_kernel_group_layout_matches_plain_version(cuda, g):
    BC, Q, nh, hd, ds = 2, 256, 8, 64, 128
    x, dt, dacs, b, c = (torch.from_numpy(a).to(cuda) for a in _ssd_inputs(
        np.random.default_rng(g), BC, Q, nh, hd, ds))
    bg, cg = b[:, :, :g].contiguous(), c[:, :, :g].contiguous()
    out = ssd_intra_kernel(x, dt, dacs, bg, cg)
    torch.testing.assert_close(out, ref_ssd_intra(x, dt, dacs, bg, cg),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("g,dtype", [(1, torch.bfloat16), (2, torch.float32)])
def test_ssd_path_on_the_card_matches_its_cpu_path(cuda, g, dtype):
    """`ops.ssd` end to end, B/C in one group and in two, read in place
    by the kernel; bf16 at the flash bf16 test's 5e-2, f32 at 1e-3."""
    B, S, nh, hd, ds, Q = 1, 512, 8, 64, 128, 256
    gen = torch.Generator().manual_seed(g)
    args = [_randn(gen, (B, S, nh, hd), dtype, "cpu", 0.5),
            torch.rand((B, S, nh), generator=gen) * 0.1 + 1e-3,
            -(torch.rand(nh, generator=gen) * 15 + 1),
            _randn(gen, (B, S, g, ds), dtype, "cpu", 0.3),
            _randn(gen, (B, S, g, ds), dtype, "cpu", 0.3)]
    n0 = ssd_intra_kernel.launches
    got = ops.ssd(*(a.to(cuda) for a in args), chunk=Q)
    torch.cuda.synchronize()
    assert ssd_intra_kernel.launches == n0 + 1
    tol = 1e-3 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.cpu().float(),
                               ops.ssd(*args, chunk=Q).float(), rtol=tol,
                               atol=tol)


def _close_rows(got, want):
    """chip_smoke.py's full-width bf16 limit: |got - want| <= 2^-6·|want|
    + 2^-5 of the RMS of want's row along hd."""
    w = want.double()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    bad = (got.double() - w).abs() > 2 ** -6 * w.abs() + 2 ** -5 * rms
    assert int(bad.sum()) == 0, f"{int(bad.sum())} of {w.numel()} elements"


@pytest.mark.gpu
@pytest.mark.parametrize("BC,Q,nh,hd,g,ds", [
    (1, 64, 2, 64, 1, 64),       # one strip, one warpgroup with rows
    (3, 128, 4, 64, 2, 128),     # BC 3, two groups of two heads
    (2, 256, 8, 64, 1, 128),     # mamba2-780m's chunk, head and state
    (1, 256, 4, 64, 2, 64),      # zamba2-7b's
    (2, 256, 6, 64, 6, 64),      # g = nh: one head an item
    (1, 256, 4, 128, 1, 128),    # hd 128
    (1, 320, 2, 128, 2, 256),    # hd 128, ds 256: 1 C buffer, 1 stage
    (2, 128, 4, 64, 1, 256),     # hd 64, ds 256, 2 heads: the same
    (1, 320, 3, 64, 1, 256),     # 3 heads a group: 1 head; 2 C buffers
    # more items than SMs, so that a block runs several through its rings
    (40, 256, 8, 64, 1, 128),    # 2 C buffers, 2 stages
    (50, 192, 6, 64, 2, 192),    # 1 C buffer; strips of 64 rows idle a
    (70, 128, 4, 64, 1, 256)])   # warpgroup; 1 C buffer, 1 stage
def test_ssd_bf16_runs_the_wgmma_kernel(cuda, BC, Q, nh, hd, g, ds):
    """bf16 SSD through TMA + wgmma, C·Bᵀ shared by the heads of a block,
    against the plain version at chip_smoke.py's full-width limit, with
    Mamba2's dt (log-uniform 1e-3..1e-1) and A (-U(1, 16)), so dacs falls
    to about -400 in a chunk of 256; exactly one `wgmma_bf16` launch."""
    assert ssd_scan.variant(torch.bfloat16, Q, hd, ds) == "wgmma_bf16"
    gen = torch.Generator().manual_seed(BC * Q + nh * hd + g + ds)
    x = _randn(gen, (BC, Q, nh, hd), torch.bfloat16, cuda, 0.5)
    dt = torch.exp(torch.empty((BC, Q, nh)).uniform_(
        np.log(1e-3), np.log(1e-1), generator=gen))
    A = -torch.empty(nh).uniform_(1.0, 16.0, generator=gen)
    dt, dacs = dt.to(cuda), torch.cumsum(dt * A, dim=1).to(cuda)
    b = _randn(gen, (BC, Q, g, ds), torch.bfloat16, cuda, 0.3)
    c = _randn(gen, (BC, Q, g, ds), torch.bfloat16, cuda, 0.3)
    by = dict(ssd_intra_kernel.launches_by)
    out = ssd_intra_kernel(x, dt, dacs, b, c)
    torch.cuda.synchronize()
    assert ssd_intra_kernel.launches_by == {
        "wgmma_bf16": by["wgmma_bf16"] + 1, "simt": by["simt"]}
    assert out.dtype == torch.bfloat16
    _close_rows(out, ref_ssd_intra(x, dt, dacs, b, c))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_bf16_matches_plain_version(cuda, causal):
    gen = torch.Generator().manual_seed(int(causal))
    q = _randn(gen, (1, 520, 12, 128), torch.bfloat16, cuda)
    k = _randn(gen, (1, 520, 4, 128), torch.bfloat16, cuda)
    v = _randn(gen, (1, 520, 4, 128), torch.bfloat16, cuda)
    out = flash_attention_kernel(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_attention(
        q, k, v, causal=causal).float(), rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,tiles,bn", [
    ((128, 128, 64, (128, 128, 64), 128)),     # one stage: the ring unfilled
    ((128, 256, 64, (128, 128, 64), 256)),
    ((200, 384, 100, (128, 128, 128), 128)),   # two stages, padded M and K
    ((256, 256, 300, (128, 128, 64), 256)),    # five: the ring wraps once
    ((256, 512, 3072, (128, 128, 128), 256)),  # 48 stages
    ((300, 384, 3000, (128, 128, 128), 128))])
def test_gemm_bf16_runs_the_wgmma_path(cuda, M, N, K, tiles, bn):
    """bf16 through TMA + wgmma at K_eff from 64 to 3,072 and N tiles of
    128 and 256, against the plain version at the JAX test's tolerance."""
    gen = torch.Generator().manual_seed(M + K)
    x = _randn(gen, (M, K), torch.bfloat16, cuda)
    y = _randn(gen, (K, N), torch.bfloat16, cuda)
    pol = TilePolicy(*tiles)
    me, ne = -(-M // pol.tm) * pol.tm, -(-N // pol.tn) * pol.tn
    assert gemm.wgmma_tile_n(me, ne, -(-K // pol.tk) * pol.tk) == bn
    by = dict(gemm.gemm_padded.launches_by)
    out, prof = ops.matmul(x, y, policy=pol)
    torch.cuda.synchronize()
    assert gemm.gemm_padded.launches_by == {**by,
                                            "wgmma_bf16": by["wgmma_bf16"] + 1}
    torch.testing.assert_close(out.float(), ref_matmul(x, y).float(),
                               rtol=0.2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,tiles,bn", [
    ((128, 128, 128, (128, 128, 128), 128)),    # K_eff 128: one stage
    ((100, 256, 100, (128, 128, 128), 256)),    # padded M and K, one stage
    ((200, 384, 512, (128, 128, 128), 128)),    # 4 stages: the ring full
    ((256, 512, 600, (128, 128, 128), 256)),    # K_eff 640: the ring wraps
    ((300, 250, 3072, (128, 128, 128), 256)),   # 24 stages, padded M and N
    ((256, 384, 6144, (128, 128, 128), 128)),   # 48 stages
    ((500, 600, 3000, (256, 256, 512), 256))])  # mxu_256_k512's tiles
def test_gemm_int8_runs_the_wgmma_path(cuda, M, N, K, tiles, bn):
    """int8 through the transpose and TMA + wgmma s8 at K_eff from 128
    to 6,144 and N tiles of 128 and 256, bitwise equal to the plain
    version; exactly one launch, of `wgmma_s8`."""
    gen = torch.Generator().manual_seed(M + N + K)
    x = torch.randint(-128, 128, (M, K), generator=gen, dtype=torch.int8)
    y = torch.randint(-128, 128, (K, N), generator=gen, dtype=torch.int8)
    x, y = x.to(cuda), y.to(cuda)
    pol = TilePolicy(*tiles)
    me, ne = -(-M // pol.tm) * pol.tm, -(-N // pol.tn) * pol.tn
    assert gemm.wgmma_tile_n(me, ne, -(-K // pol.tk) * pol.tk,
                             torch.int8) == bn
    by = dict(gemm.gemm_padded.launches_by)
    out, prof = ops.matmul(x, y, policy=pol)
    torch.cuda.synchronize()
    assert gemm.gemm_padded.launches_by == {**by,
                                            "wgmma_s8": by["wgmma_s8"] + 1}
    assert out.dtype == torch.int32 and torch.equal(out, ref_matmul(x, y))


@pytest.mark.gpu
def test_gemm_int8_sums_the_extremes_exactly(cuda):
    """All -128 by all -128 at K_eff 3,072: every output is 3,072 · 2^14
    = 50,331,648, so the transpose and the s32 sums are exact at the
    largest products int8 has."""
    x = torch.full((256, 3072), -128, dtype=torch.int8, device=cuda)
    y = torch.full((3072, 384), -128, dtype=torch.int8, device=cuda)
    out, _ = ops.matmul(x, y, policy=TilePolicy(128, 128, 128))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(out, 50_331_648))
    assert torch.equal(out, ref_matmul(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", GEMM_SHAPES + [
    (128, 128, 16), (256, 256, 48),        # one and three slabs: short of
    (200, 136, 100), (384, 256, 3072),     # the 4-stage ring; 7 and 192
    (1, 3, 5)])
def test_gemm_f32_runs_the_pipelined_simt_path(cuda, M, N, K):
    """f32 straight into the kernel at unpadded shapes, so that its zero
    fill past M, N and K and its 4-byte copies (K or N not a multiple of
    4) run, and at K from one 16-deep slab to 192 of them; the JAX test's
    rtol 1e-3 with its atol 1e-4 grown in K / 128, as the worst-case
    rounding of an f32 sum grows."""
    gen = torch.Generator().manual_seed(M * N + K)
    x = _randn(gen, (M, K), torch.float32, cuda)
    y = _randn(gen, (K, N), torch.float32, cuda)
    by = dict(gemm.gemm_padded.launches_by)
    out = gemm.gemm_padded(x, y, TilePolicy(1, 1, 1))
    torch.cuda.synchronize()
    assert gemm.gemm_padded.launches_by == {**by, "simt": by["simt"] + 1}
    torch.testing.assert_close(out, ref_matmul(x, y), rtol=1e-3,
                               atol=1e-4 * max(1.0, K / 128))


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (128, 200), (300, 300)])
@pytest.mark.parametrize("G", [1, 3, 4])
@pytest.mark.parametrize("hd", [64, 96, 112, 128, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_runs_the_wgmma_kernel(cuda, Sq, Sk, G, hd, causal):
    """bf16 flash through TMA + wgmma at every head dim it takes (96 and
    112 in boxes zero-filled past hd, 192 in three boxes with 64-key
    tiles), GQA groups of 1, 3 and 4, ragged Sq and Sk, against the
    plain version at 5e-2."""
    gen = torch.Generator().manual_seed(Sq + Sk + G + hd)
    B, KV = 2, 2
    q = _randn(gen, (B, Sq, KV * G, hd), torch.bfloat16, cuda)
    k = _randn(gen, (B, Sk, KV, hd), torch.bfloat16, cuda)
    v = _randn(gen, (B, Sk, KV, hd), torch.bfloat16, cuda)
    by = dict(flash_attention_kernel.launches_by)
    out = ops.flash(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches_by == {
        "wgmma_bf16": by["wgmma_bf16"] + 1, "simt": by["simt"]}
    torch.testing.assert_close(out.float(), ref_attention(
        q, k, v, causal=causal).float(), rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
def test_bf16_paths_reject_what_their_tiles_do_not_cover(cuda):
    x = torch.ones((64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(128, 128, 64\) tiles"):
        gemm.gemm_padded(x, x, TilePolicy(64, 64, 64))
    buf = torch.ones(1 + 8 * 2 * 64, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 2, 64)            # 2 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_kernel(q, q, q, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [96, 112, 192])
def test_flash_bf16_rejects_misaligned_wide_heads(cuda, hd):
    """The head dims new to the tensor-core path keep its 16-byte
    alignment check for the TMA loads, as hd 64 does."""
    buf = torch.ones(1 + 8 * 2 * hd, device=cuda, dtype=torch.bfloat16)
    q = buf[1:].view(1, 8, 2, hd)            # 2 bytes past an aligned start
    assert fa.variant(q.dtype, hd) == "wgmma_bf16"
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention_kernel(q, q, q, causal=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_refuses_head_dims_past_256(cuda, dtype):
    q = torch.ones((1, 4, 2, 257), device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="hd <= 256"):
        flash_attention_kernel(q, q, q, causal=True)


@pytest.mark.gpu
def test_ssd_bf16_path_rejects_misaligned_inputs(cuda):
    BC, Q, nh, hd, g, ds = 1, 64, 2, 64, 1, 64
    buf = torch.zeros(1 + BC * Q * nh * hd, device=cuda, dtype=torch.bfloat16)
    x = buf[1:].view(BC, Q, nh, hd)          # 2 bytes past an aligned start
    dt = torch.full((BC, Q, nh), 0.01, device=cuda)
    b = torch.zeros((BC, Q, g, ds), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ssd_intra_kernel(x, dt, dt, b, b)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.ones((128, 128), device=cuda)
    with pytest.raises(TypeError, match="float32, bfloat16 or int8"):
        gemm.gemm_padded(x.double(), x.double(), TilePolicy(128, 128, 128))
    with pytest.raises(ValueError, match="contiguous"):
        gemm.gemm_padded(x.t(), x[:, :128], TilePolicy(128, 128, 64))
    xi = torch.ones((64, 64), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"int8 .* \(128, 128, 128\) tiles"):
        gemm.gemm_padded(xi, xi, TilePolicy(64, 64, 64))
    q = torch.ones((1, 4, 2, 257), device=cuda)
    with pytest.raises(ValueError, match="hd <= 256"):
        flash_attention_kernel(q, q, q, causal=True)
    arrs = [torch.from_numpy(a).to(cuda) for a in
            _ssd_inputs(np.random.default_rng(0), 1, 8, 2, 4, 4)]
    with pytest.raises(TypeError, match="float32 dt"):
        ssd_intra_kernel(arrs[0], arrs[1].double(), *arrs[2:])


@pytest.mark.parametrize("source,variants", [
    ("ssd_scan", "SSD_VARIANTS"), ("ssd_scan", "SIMT_SSD_VARIANTS"),
    ("fleet_hist", "HIST_VARIANTS"), ("flash_attention", "FLASH_VARIANTS")])
def test_ablation_variants_find_their_text(source, variants):
    """Every part `kernels.ablation` removes or changes is still in the
    source it edits, so the card's run builds every variant."""
    from repro_torch.kernels import _build, ablation
    text = (_build.CSRC / f"{source}.cu").read_text()
    for what, pairs in getattr(ablation, variants).items():
        for old, _ in pairs:
            assert old in text, f"{source}.cu {what!r}"
