"""Controlled-GEMM characterization (paper §IV) against the live GEMM
kernel: tile quantization, block-policy selection, and the adjusted-OFU
pipeline, executed for real on the card.

  PYTHONPATH=src python -m repro_torch.examples.gemm_characterization

Runs on the CUDA device; `main(device="cpu")` runs the kernel's plain
version on the CPU instead.  Same shapes, inputs and table as the JAX
package's `examples/gemm_characterization.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ofu import adjusted_ofu
from repro_torch.kernels import ops

SHAPES = [(300, 200, 150), (512, 512, 512), (640, 1000, 480),
          (1100, 900, 700)]


def main(device=None) -> list:
    """Print the characterization table; return each shape's
    (output, GemmProfile)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    print(f"{'M,N,K':>16s} {'policy':>12s} {'FLOPs 2MNK':>12s} "
          f"{'executed':>12s} {'overhead':>9s} {'OFU':>6s} {'adjOFU':>7s}")
    results = []
    for M, N, K in SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
        out, prof = ops.matmul(x.to(device), y.to(device))
        results.append((out, prof))
        # pretend the device reported 60% duty at 97% clock while running
        # this shape: raw OFU includes padded-tile work; Eq. 8 removes it
        raw_ofu = 0.60 * 0.97 * 100
        adj = adjusted_ofu(raw_ofu, prof.theoretical_flops,
                           prof.profiled_flops)
        print(f"{f'{M},{N},{K}':>16s} {prof.policy.name:>12s} "
              f"{prof.theoretical_flops:>12,d} {prof.profiled_flops:>12,d} "
              f"{prof.overhead * 100:>8.2f}% {raw_ofu:>5.1f}% {adj:>6.1f}%")
    print(f"\nexecuted FLOPs are exact on {device}: the kernel runs the "
          "padded grid (closed form == grid, 0-FLOP error; cf. paper's "
          "<1000-FLOP nvJet match).")
    return results


if __name__ == "__main__":
    main()
