"""Paper Fig. 1: FLOP overhead vs matrix size, aligned + random shapes,
per precision and block policy.

The closed-form sweep is exact for the port's GEMM (static grid ==
executed FLOPs — asserted per-call against live executions at the small
end of the sweep: on the card the GEMM kernel, whose launched FLOPs must
equal the profile's, on the CPU its plain version).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.benchmarks.common import Row, sync, timed
from repro_torch.core.tile_quant import overhead, pick_policy, profiled_flops
from repro_torch.kernels import gemm, ops

PRECISIONS = ("bf16", "int8", "fp32")
#: the live kernel check's shapes (none tile-aligned)
KERNEL_SHAPES = ((300, 200, 150), (129, 257, 513), (512, 384, 640))


def _band(vals):
    return (f"mean={np.mean(vals) * 100:.2f}% max={np.max(vals) * 100:.2f}%")


def _matmul(x, y):
    out = ops.matmul(x, y)
    sync(x.device)
    return out


def run(device=None, verify_kernel: bool = True) -> list[Row]:
    rows = []
    rng = np.random.default_rng(0)

    for prec in PRECISIONS:
        # aligned sweep (multiples of 128), N = 512 .. 16384
        big = [overhead(n, n, n, pick_policy(n, n, n, prec))
               for n in range(4096, 16385, 128)]
        small = [overhead(n, n, n, pick_policy(n, n, n, prec))
                 for n in range(128, 512, 128)]
        rows.append(Row(f"fig1.aligned.{prec}.N>=4096", 0.0, _band(big)))
        rows.append(Row(f"fig1.aligned.{prec}.N<512", 0.0, _band(small)))

        # random (not 128-aligned) shapes
        rand = []
        for _ in range(300):
            m, n, k = rng.integers(256, 12288, 3)
            rand.append(overhead(int(m), int(n), int(k),
                                 pick_policy(int(m), int(n), int(k), prec)))
        ge4096 = []
        for _ in range(300):
            m, n, k = rng.integers(4096, 12288, 3)
            ge4096.append(overhead(int(m), int(n), int(k),
                                   pick_policy(int(m), int(n), int(k), prec)))
        rows.append(Row(f"fig1.random.{prec}.all", 0.0, _band(rand)))
        rows.append(Row(f"fig1.random.{prec}.N>=4096", 0.0, _band(ge4096)))

    if verify_kernel:
        # live kernel executions: the profile must match the closed form,
        # and on the card the FLOPs the kernel launched must match both
        dev = resolve_device(device)
        us = 0.0
        checked = 0
        for m, n, k in KERNEL_SHAPES:
            x = torch.from_numpy(
                rng.standard_normal((m, k)).astype(np.float32)).to(dev)
            y = torch.from_numpy(
                rng.standard_normal((k, n)).astype(np.float32)).to(dev)
            launched = gemm.gemm_padded.launched_flops
            (out, prof), t = timed(_matmul, x, y, repeat=1)
            assert prof.profiled_flops == profiled_flops(m, n, k, prof.policy)
            if dev.type == "cuda":
                assert (gemm.gemm_padded.launched_flops - launched
                        == prof.profiled_flops)
            us += t
            checked += 1
        rows.append(Row("fig1.kernel_grid_vs_closed_form", us / checked,
                        f"exact_match_on={checked} shapes (0 FLOP error)"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r.csv())
