"""OFU — the paper's primary contribution: a hardware-counter-derived,
precision-agnostic FLOP-utilization metric with characterized error terms."""
from repro_torch.core.ofu import (  # noqa: F401
    AccuracyReport, adjusted_ofu, effective_peak, hist_percentile, mae,
    mfu_from_throughput, ofu_mean, ofu_point, ofu_series, pct_within,
    pearson_r,
)
from repro_torch.core.peaks import CHIPS, DEFAULT_CHIP, TPU_V5E, ChipSpec  # noqa: F401
from repro_torch.core.tile_quant import (  # noqa: F401
    TilePolicy, correction_factor, effective_dims, overhead, pick_policy,
    profiled_flops, scale_factor_overhead, theoretical_flops,
)
