"""Tile quantization (paper Eq. 2–4).

GEMM grids pad (M, N, K) up to tile multiples (first ceiling) and the tile
grid is again rounded up to a whole number of core clusters (second
ceiling), exactly Eq. 4's two-level hierarchy.  Because the port's GEMM
(`kernels/gemm.py`) walks exactly the padded grid, `profiled_flops()` here
is EXACT for it (the closed-form-vs-grid test asserts 0-FLOP error, cf. the
paper's <1000-FLOP nvJet match).

The block-shape policy below plays the role of cuBLAS kernel selection: an
intermediate library layer, invisible to the application, that materially
changes executed FLOPs (paper §IV-A).  `pick_policy` chooses among the
chip's policies: the H100's are the CTA tiles the port's kernel walks on
the card; every other chip, and no chip, takes the MXU block policies of
the simulated TPU fleet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class TilePolicy:
    """BlockSpec tile dims + core-cluster grouping (Eq. 4's (C_M, C_N))."""

    tm: int
    tn: int
    tk: int
    cm: int = 1
    cn: int = 1
    name: str = "custom"


def _ceil_to(x: int, t: int) -> int:
    return -(-x // t) * t


def effective_dims(M: int, N: int, K: int,
                   policy: TilePolicy) -> tuple[int, int, int]:
    """Eq. 3 + Eq. 4: two successive ceilings (tiles, then core clusters)."""
    m_tiles = -(-M // policy.tm)
    n_tiles = -(-N // policy.tn)
    m_eff = _ceil_to(m_tiles, policy.cm) * policy.tm
    n_eff = _ceil_to(n_tiles, policy.cn) * policy.tn
    k_eff = _ceil_to(K, policy.tk)
    return m_eff, n_eff, k_eff


def profiled_flops(M: int, N: int, K: int, policy: TilePolicy) -> int:
    """FLOPs the hardware executes: 2·M_eff·N_eff·K_eff ≥ 2MNK."""
    me, ne, ke = effective_dims(M, N, K, policy)
    return 2 * me * ne * ke


def theoretical_flops(M: int, N: int, K: int) -> int:
    return 2 * M * N * K


def overhead(M: int, N: int, K: int, policy: TilePolicy) -> float:
    """Eq. 2: (FLOPs_profiled − 2MNK) / 2MNK."""
    th = theoretical_flops(M, N, K)
    return (profiled_flops(M, N, K, policy) - th) / th


# ---------------------------------------------------------------------------
# the MXU block-shape policies of the simulated TPU fleet — our
# nvMatmulHeuristics analogue
# ---------------------------------------------------------------------------
# VMEM budget: ~128 KiB per buffer slot is a comfortable v5e working set for
# a double-buffered 3-operand GEMM tile; MXU wants dims in multiples of 128
# (8 sublanes × 128 lanes; 128×128 systolic tiles).
_POLICIES = {
    # large well-aligned shapes: big tiles, megacore-style 2-cluster M split
    "mxu_512": TilePolicy(512, 512, 512, cm=2, cn=1, name="mxu_512"),
    # default for medium shapes
    "mxu_256": TilePolicy(256, 256, 256, cm=1, cn=1, name="mxu_256"),
    # small / poorly aligned shapes (CUTLASS-2-analogue)
    "mxu_128": TilePolicy(128, 128, 128, cm=1, cn=1, name="mxu_128"),
    # int8 doubles the K appetite (same bytes per tile)
    "mxu_256_k512": TilePolicy(256, 256, 512, cm=1, cn=1, name="mxu_256_k512"),
    # fp32 runs smaller tiles (3-pass emulation triples the VMEM footprint)
    "mxu_128_fp32": TilePolicy(128, 128, 128, cm=1, cn=1, name="mxu_128_fp32"),
}


# larger tiles amortize pipeline setup / raise MXU occupancy: model that as
# a per-tile-size efficiency penalty so the picker trades padding vs
# efficiency the way nvMatmulHeuristics does.
_TILE_PENALTY = {128: 1.08, 256: 1.02, 512: 1.00}


# ---------------------------------------------------------------------------
# the H100's policies: the CTA tiles of the port's GEMM on the card
# ---------------------------------------------------------------------------
# `kernels/gemm.py` `WGMMA_TILES` and `wgmma_tile_n`: bf16 blocks of 128
# rows by 128 or 256 columns with 64-deep (128-byte) K stages, int8 128 x
# 128 with 128-deep stages; f32 the SIMT kernel's 128 x 128 blocks of
# 16-deep K slabs (`csrc/gemm.cu` kFM, kFN, kFK), which it zero-fills past
# the edges, so a grid padded to them is exactly what it executes.  The
# kernel launches no thread-block clusters, so Eq. 4's (C_M, C_N) is
# (1, 1).  Wave quantization over the 132 SMs costs time but executes no
# FLOPs, so it stays out of `profiled_flops`.
_H100_POLICIES = {
    "wgmma_bf16_128": TilePolicy(128, 128, 64, name="wgmma_bf16_128"),
    "wgmma_bf16_256": TilePolicy(128, 256, 64, name="wgmma_bf16_256"),
    "wgmma_s8_128": TilePolicy(128, 128, 128, name="wgmma_s8_128"),
    "simt_f32_128": TilePolicy(128, 128, 16, name="simt_f32_128"),
}


def _pick_h100(M: int, N: int, K: int, dtype: str) -> TilePolicy:
    """The tile the H100 kernel walks for `dtype`: int8 and f32 have one;
    bf16 takes 256 columns where N padded to 128 divides by 256 (what
    `wgmma_tile_n` picks), else 128, so both pad N to 128."""
    if dtype == "int8":
        return _H100_POLICIES["wgmma_s8_128"]
    if dtype == "fp32":
        return _H100_POLICIES["simt_f32_128"]
    if dtype != "bf16":
        raise ValueError(f"the H100's GEMM has no {dtype!r} path "
                         "(bf16, int8, fp32)")
    wide = _ceil_to(N, 128) % 256 == 0
    return _H100_POLICIES["wgmma_bf16_256" if wide else "wgmma_bf16_128"]


def pick_policy(M: int, N: int, K: int, dtype: str = "bf16",
                chip=None) -> TilePolicy:
    """Shape/precision-driven policy choice (the library layer of §IV-A).

    With `chip` the H100 (`core.peaks.H100_SXM`): the tile its kernel
    walks (`_pick_h100`).  Otherwise the MXU policies: evaluates the
    candidate BlockSpec set and picks the minimum of (executed FLOPs ×
    tile-efficiency penalty) — bigger tiles for big aligned problems,
    smaller tiles when edge padding would dominate, precision-dependent
    candidate sets (fp32 runs 3-pass emulation and is capped at 128³
    tiles; int8 gets a deeper-K candidate).
    """
    if chip is not None and chip.name == "h100-sxm":
        return _pick_h100(M, N, K, dtype)
    if dtype == "fp32":
        return _POLICIES["mxu_128_fp32"]
    cands = ["mxu_128", "mxu_256", "mxu_512"]
    if dtype in ("int8", "fp8"):
        cands.append("mxu_256_k512")

    def cost(name: str) -> float:
        p = _POLICIES[name]
        return (profiled_flops(M, N, K, p)
                * _TILE_PENALTY[p.tm]
                * (1.0 + scale_factor_overhead(M, N, K, dtype)
                   * (128.0 / p.tk)))

    return _POLICIES[min(cands, key=cost)]


def correction_factor(M: int, N: int, K: int,
                      policy: TilePolicy | None = None,
                      dtype: str = "bf16", chip=None) -> float:
    """FLOPs_theoretical / FLOPs_profiled — the Eq. 8 adjustment term,
    under `policy` or else `chip`'s pick (`pick_policy`)."""
    policy = policy or pick_policy(M, N, K, dtype, chip)
    return theoretical_flops(M, N, K) / profiled_flops(M, N, K, policy)


# ---------------------------------------------------------------------------
# block-scale bookkeeping overhead for quantized formats (paper §IV-B)
# ---------------------------------------------------------------------------
def scale_factor_overhead(M: int, N: int, K: int, dtype: str) -> float:
    """Fractional throughput overhead from per-tile scale-factor handling.

    The paper: FP8 keeps one SF block per 128×128 input tile; NVFP4 one per
    128×64 — quadrupling SF traffic.  TPU int8 (AQT-style) keeps one fp32
    scale per 128×128 quantization tile; modeled as extra VPU cycles per
    MXU tile that shrink with K (amortized over the contraction).
    """
    if dtype not in ("int8", "fp8"):
        return 0.0
    blocks_per_tile = {"int8": 3, "fp8": 3}[dtype]
    # SF handling cost ~ blocks × (setup cycles) / (MACC cycles per tile)
    macc_cycles = max(K, 1)  # K-deep accumulation per 128×128 output tile
    return blocks_per_tile * 96.0 / macc_cycles
