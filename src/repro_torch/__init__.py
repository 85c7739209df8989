"""PyTorch + CUDA port of the fleet-OFU system in `src/repro`.

The fleet path runs on one NVIDIA GPU: the fused engine simulates the
fleet's counter grids on the device (`fleet.engine_torch`), a hand-written
CUDA kernel reduces OFU = TPA·f/f_max into per-(time-bucket, bin)
histograms (`kernels.fleet_hist`), and the rollup and detectors
(`fleet.streaming`, `fleet.regression`) consume the few kilobytes that
leave the card.  Module paths mirror the JAX package's.
"""
from repro_torch._device import resolve_device  # noqa: F401
