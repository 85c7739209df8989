"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates,
at its 700 W limit)."""

#: bf16 / fp16 tensor-core operations a second
BF16_FLOP_PER_S = 989e12
#: float32 outside the tensor cores
FP32_FLOP_PER_S = 67e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12
#: operations a second by input type
PEAK_OPS_PER_S = {"bf16": BF16_FLOP_PER_S, "fp32": FP32_FLOP_PER_S}
