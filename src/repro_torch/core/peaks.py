"""Theoretical peak FLOP/s derivation (paper Eq. 5–7).

The paper's point in §IV-D is that the *denominator* of any utilization
metric must be derived from the physical pipeline: units × FLOPs/cycle ×
the clock domain that pipeline actually runs at.  `H100_SXM` is that
audit for the card the port runs on, Eq. 6 itself: 528 tensor cores ×
1,024 dense bf16 FLOPs a clock × 1,830 MHz = 989.4 TFLOP/s.  The TPU
specs are the simulated fleet's chips (`DEFAULT_CHIP`): 4 MXUs × (128×128
MACC = 2 FLOPs each) × 1,500 MHz = 196.6 TFLOP/s bf16 for a v5e.
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

#: one H100 SXM5 80 GB, the card the port runs on.  Sources: NVIDIA's
#: H100 Tensor Core GPU data sheet (SXM column) and the NVIDIA H100 Tensor
#: Core GPU Architecture whitepaper (Hopper).
_H100_SMS = 132                 # whitepaper: SMs of the SXM5 part
_H100_SM_FP32_LANES = 128       # whitepaper: FP32 cores an SM
H100_SXM = ChipSpec(
    name="h100-sxm",
    # whitepaper: 4 fourth-generation tensor cores an SM, each 512 dense
    # bf16 FMAs (1,024 FLOPs) a clock, here as a 16 x 32 MACC array
    num_mxu=4 * _H100_SMS, mxu_rows=16, mxu_cols=32, flops_per_macc=2,
    f_max_mhz=1830.0,           # the clock the data sheet's 989.4 TFLOP/s
                                # dense bf16 takes (paper Eq. 6)
    f_sm_max_mhz=1980.0,        # SM boost clock, what NVML's SM clock reads
    hbm_gbps=3350.0,            # data sheet: HBM3 3.35 TB/s
    ici_gbps=25.0,              # NVLink 4: 18 links, 900 GB/s both ways
    ici_links=18,               # together (data sheet), 25 GB/s a link
                                # each way
    hbm_gib=80.0,               # data sheet: 80 GB
    precision_mult={
        "bf16": 1.0,
        "fp16": 1.0,
        "int8": 2.0,            # data sheet: 1,979 TOP/s dense
        "fp8": 2.0,             # data sheet: 1,979 TFLOP/s dense
        "tf32": 0.5,            # data sheet: 494.7 TFLOP/s dense
        # true f32 on the SMs' FP32 lanes at the SM clock (the data
        # sheet's 67 TFLOP/s): what B2's f32 path and the SIMT kernels
        # run.  It sends nothing to the tensor pipe, so a true-f32 job's
        # TPA is ~0 (the paper's undercount of non-tensor work).
        "fp32": (_H100_SMS * _H100_SM_FP32_LANES * 2 * 1980.0)
                / (4 * _H100_SMS * 16 * 32 * 2 * 1830.0),
    },
)

CHIPS = {c.name: c for c in (TPU_V5E, TPU_V6E_LIKE, H100_SXM)}
DEFAULT_CHIP = TPU_V5E
