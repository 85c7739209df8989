"""Public wrappers around the kernels: the kernel API.

`matmul` does the tile-quantization padding (Eq. 3: operands are
zero-padded up to tile multiples and the padded tiles are really
computed) and records the executed-FLOPs metadata the OFU pipeline
consumes; `flash` and `ssd` are the attention and Mamba2 entry points.
Each runs the CUDA kernel for tensors on the card and the kernel's plain
version for tensors on the CPU (the kernel modules pick by device).
`flash` and `ssd` are differentiable: with grad mode on and an input
that requires grad they go through `kernels.grad`'s autograd Functions
(the same kernel forward, an explicit backward); otherwise, as on the
serving path, they call the kernels' wrappers directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.tile_quant import TilePolicy, pick_policy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm as gemm_mod
from repro_torch.kernels import grad, ssd_scan
from repro_torch.kernels.ref import compute_dtype

_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "fp32",
                torch.int8: "int8"}


@dataclass(frozen=True)
class GemmProfile:
    """The per-GEMM record an NCU-style profile would give (paper §IV-A)."""

    M: int
    N: int
    K: int
    policy: TilePolicy
    theoretical_flops: int
    profiled_flops: int

    @property
    def overhead(self) -> float:
        return (self.profiled_flops - self.theoretical_flops) \
            / self.theoretical_flops


def _pad_to(x: torch.Tensor, m0: int, m1: int) -> torch.Tensor:
    p0 = -x.shape[0] % m0
    p1 = -x.shape[1] % m1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           policy: Optional[TilePolicy] = None,
           dtype_name: Optional[str] = None, chip=None
           ) -> tuple[torch.Tensor, GemmProfile]:
    """C = x @ y through the tiled GEMM, with tile-quantization padding.

    The tiles are `policy`'s, else `pick_policy`'s for `chip` (a
    `core.peaks.ChipSpec`; the H100's are the tiles the card's kernel
    walks, none the simulated fleet's MXU blocks).  Returns (C,
    GemmProfile); profile.profiled_flops is exact: it is the work the
    kernel executes on the padded operands.
    """
    M, K = x.shape
    _, N = y.shape
    dtype_name = dtype_name or _DTYPE_NAMES.get(x.dtype, "bf16")
    policy = policy or pick_policy(M, N, K, dtype_name, chip)

    xp = _pad_to(x, policy.tm * policy.cm, policy.tk).contiguous()
    yp = _pad_to(y, policy.tk, policy.tn * policy.cn).contiguous()
    out = gemm_mod.gemm_padded(xp, yp, policy)
    prof = GemmProfile(M, N, K, policy, 2 * M * N * K,
                       gemm_mod.grid_flops(M, N, K, policy))
    return out[:M, :N], prof


def flash(q, k, v, *, causal: bool, scale=None) -> torch.Tensor:
    """Flash attention, any Sq and Sk.

    Where the reference pads q to its query block and sends an Sk that
    is not a multiple of its key block to its plain version, the card's
    kernel masks both ragged edges itself and always runs.
    """
    if grad.needs_grad(q, k, v):
        return grad.FlashAttention.apply(q, k, v, causal, scale)
    return fa.flash_attention_kernel(q, k, v, causal=causal, scale=scale)


def ssd_intra_inputs(x, dt, A, Bm, Cm, *, chunk: int) -> tuple:
    """The intra-chunk kernel's inputs for `ssd`'s arguments: x
    (B·nc, Q, nh, hd), f32 dt and within-chunk cumsum of dt·A
    (B·nc, Q, nh), and B/C in their groups (B·nc, Q, g, ds).  The
    reference broadcasts B/C to one copy a head; the kernel reads head
    h's group in place instead."""
    Bsz, S, nh, hd = x.shape
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"S = {S} is not a multiple of chunk {Q}")
    ct = compute_dtype(x.dtype)
    dtc = dt.reshape(Bsz * nc, Q, nh).to(ct)
    dacs = torch.cumsum(dtc * A.to(ct), dim=1)
    return tuple(t.reshape(Bsz * nc, Q, *t.shape[2:]).contiguous()
                 for t in (x, dtc, dacs, Bm, Cm))


def ssd_intra(x, dt, dacs, b, c) -> torch.Tensor:
    """The intra-chunk term on `ssd_intra_inputs`' tensors: the kernel,
    through `grad.SSDIntra` when a gradient must pass it."""
    if grad.needs_grad(x, dt, dacs, b, c):
        return grad.SSDIntra.apply(x, dt, dacs, b, c)
    return ssd_scan.ssd_intra_kernel(x, dt, dacs, b, c)


def ssd(x, dt, A, Bm, Cm, *, chunk: int) -> torch.Tensor:
    """Full chunked SSD: the intra-chunk kernel + the plain recurrence.

    x: (B, S, nh, hd); dt: (B, S, nh); A: (nh,); Bm/Cm: (B, S, g, ds).
    Same contract as the reference's `models.ssm.ssd_chunked`.
    """
    Bsz, S, nh, hd = x.shape
    g, ds = Bm.shape[2], Bm.shape[3]
    hpg = nh // g
    inputs = ssd_intra_inputs(x, dt, A, Bm, Cm, chunk=chunk)
    Q = inputs[0].shape[1]
    nc = S // Q
    f32 = compute_dtype(x.dtype)
    dtc = inputs[1].reshape(Bsz, nc, Q, nh)
    dacs = inputs[2].reshape(Bsz, nc, Q, nh)
    y_intra = ssd_intra(*inputs)
    y_intra = y_intra.reshape(Bsz, nc, Q, nh, hd).to(f32)

    # ---- inter-chunk recurrence + contribution (plain PyTorch) ----
    Bc = Bm.reshape(Bsz, nc, Q, g, ds).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, g, ds).to(f32)
    xc = x.reshape(Bsz, nc, Q, g, hpg, hd).to(f32)
    decay_to_end = torch.exp(dacs[:, :, -1:, :] - dacs)
    w = (dtc * decay_to_end).reshape(Bsz, nc, Q, g, hpg)
    states = torch.einsum("bcqgd,bcqgh,bcqghp->bcghpd", Bc, w, xc)
    chunk_decay = torch.exp(dacs[:, :, -1, :])

    h = torch.zeros((Bsz, nh, hd, ds), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = (h * chunk_decay[:, c, :, None, None]
             + states[:, c].reshape(Bsz, nh, hd, ds))
    h_prevs = torch.stack(h_prevs, dim=1)
    y_inter = torch.einsum(
        "bcqgd,bcqgh,bcghpd->bcqghp",
        Cc, torch.exp(dacs).reshape(Bsz, nc, Q, g, hpg),
        h_prevs.reshape(Bsz, nc, g, hpg, hd, ds))
    y = y_intra + y_inter.reshape(Bsz, nc, Q, nh, hd)
    return y.reshape(Bsz, S, nh, hd).to(x.dtype)
