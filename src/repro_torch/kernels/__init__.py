"""Hand-written CUDA kernels of the port (sources under `csrc/`), each
beside its plain PyTorch version."""
