"""Theoretical peak FLOP/s derivation (paper Eq. 5–7), TPU-native.

The paper's point in §IV-D is that the *denominator* of any utilization
metric must be derived from the physical pipeline: units × FLOPs/cycle ×
the clock domain that pipeline actually runs at.  We reproduce that audit
for TPU v5e (the deploy target): 4 MXUs × (128×128 MACC = 2 FLOPs each)
× 1,500 MHz = 196.6 TFLOP/s bf16 — matching the published 197 TFLOP/s,
exactly as Eq. 6 recovers H100's published 989 TFLOP/s.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ChipSpec:
    """One accelerator generation."""

    name: str
    num_mxu: int
    mxu_rows: int
    mxu_cols: int
    flops_per_macc: int
    f_max_mhz: float            # matrix-pipeline max clock (Eq. 6 subtlety)
    f_sm_max_mhz: float         # scalar/SM boost clock (may differ!)
    hbm_gbps: float             # HBM bandwidth, GB/s
    ici_gbps: float             # per-link interconnect bandwidth, GB/s
    ici_links: int              # links per chip
    hbm_gib: float              # HBM capacity
    # precision multipliers relative to the base (bf16) matrix pipeline
    precision_mult: dict = field(default_factory=dict)

    def peak_tflops(self, dtype: str = "bf16") -> float:
        """Eq. 5: SMs × FLOPs/cycle/SM × f_max / 1e12 (TPU: MXUs)."""
        base = (self.num_mxu * self.mxu_rows * self.mxu_cols
                * self.flops_per_macc * self.f_max_mhz * 1e6) / 1e12
        return base * self.precision_mult.get(dtype, 1.0)


# TPU v5e: 197 TFLOP/s bf16, 394 TOPS int8 (published); 819 GB/s HBM;
# ~50 GB/s/link ICI (per the assignment's hardware constants).
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    num_mxu=4, mxu_rows=128, mxu_cols=128, flops_per_macc=2,
    f_max_mhz=1500.0,           # matrix pipeline clock -> 196.6 TF/s bf16
    f_sm_max_mhz=1740.0,        # scalar-core clock domain (≠ matrix clock,
                                # mirroring the H100 1980-vs-1830 split)
    hbm_gbps=819.0,
    ici_gbps=50.0,
    ici_links=4,
    hbm_gib=16.0,
    precision_mult={
        "bf16": 1.0,
        "int8": 2.0,            # 394 TOPS
        "fp8": 2.0,             # (v5e proxy for the paper's FP8 axis)
        "fp32": 0.25,           # bf16x3-pass emulation + fp32 accumulate
    },
)

# A next-gen point for the cross-generation claims (paper: H100 vs GB200).
TPU_V6E_LIKE = ChipSpec(
    name="tpu-v6e-like",
    num_mxu=4, mxu_rows=256, mxu_cols=256, flops_per_macc=2,
    f_max_mhz=1750.0,           # -> 917.5 TF/s bf16 (published ~918)
    f_sm_max_mhz=1850.0,
    hbm_gbps=1640.0,
    ici_gbps=100.0,
    ici_links=4,
    hbm_gib=32.0,
    precision_mult={"bf16": 1.0, "int8": 2.0, "fp8": 2.0, "fp32": 0.25},
)

CHIPS = {c.name: c for c in (TPU_V5E, TPU_V6E_LIKE)}
DEFAULT_CHIP = TPU_V5E
