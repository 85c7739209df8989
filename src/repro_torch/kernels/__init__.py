"""Hand-written CUDA kernels of the port (sources under `csrc/`), each
beside its plain PyTorch version.

gemm             — tiled GEMM; padded grid = exact FLOPs_profiled oracle
flash_attention  — online-softmax attention (train/prefill fast path)
ssd_scan         — Mamba2 SSD intra-chunk block
fleet_hist       — fused OFU histogram-accumulate (rollup device ingest)
ops              — public wrappers (padding, GemmProfile metadata)
ref              — plain PyTorch versions, the kernels' oracles
"""
from repro_torch.kernels import ops, ref  # noqa: F401
