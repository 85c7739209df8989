"""Tiled GEMM: the controlled workload of paper §IV.

`gemm_padded` computes C = A @ B on operands that `ops.matmul` has
already zero-padded to the tile policy's multiples (Eq. 3), so the
padded tiles are really computed: a CUDA tensor launches
`csrc/gemm.cu` (the counterpart of the TPU kernel
`repro/kernels/gemm.py::_gemm_kernel`; its source notes its design and
bound), which executes exactly 2·M_eff·N_eff·K_eff operations, and
`grid_flops` is the closed form of that count.  bf16 operands take the
kernel's TMA + wgmma path; int8 a hand-written transpose of B into a
scratch Bᵀ, then TMA + wgmma on s8 (8-bit operands go to the tensor
cores only K-major); f32 a pipelined SIMT path of true f32 FMAs
(`variant`).  A CPU tensor takes the plain version, `ref.ref_matmul`.

Block shapes come from `repro_torch.core.tile_quant.TilePolicy`, the
library-layer policy of the paper's §IV-A.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.tile_quant import TilePolicy
from repro_torch.kernels.ref import ref_matmul

#: working type -> (dtype code of csrc/common.cuh, output dtype)
_KINDS = {torch.float32: (0, torch.float32),
          torch.bfloat16: (1, torch.bfloat16),
          torch.int8: (2, torch.int32)}
_GRID_Y_MAX = 65535 * 128            # rows: 128 a block along grid.y
#: the wgmma kernels' blocks by working type: 128 rows, N tiles of 128 or
#: 256, K stages of 128 bytes (64 bf16 or 128 int8 values)
WGMMA_TILES = {torch.bfloat16: (128, 128, 64), torch.int8: (128, 128, 128)}
_VARIANTS = {torch.bfloat16: "wgmma_bf16", torch.int8: "wgmma_s8"}


def variant(dtype: torch.dtype) -> str:
    """Which of the kernel's paths a working type takes: bf16 and int8
    their TMA + wgmma tensor-core paths, f32 the SIMT path."""
    return _VARIANTS.get(dtype, "simt")


def wgmma_tile_n(M: int, N: int, K: int,
                 dtype: torch.dtype = torch.bfloat16) -> int:
    """The N tile of `dtype`'s wgmma path (bf16 or int8) for padded
    operands (M, N, K): 256 where N divides by 256, else 128.  Raises
    ValueError unless (M, N, K) are multiples of its `WGMMA_TILES`: the
    kernel walks exactly the tiles of the padded grid and has no edge."""
    tm, tn, tk = WGMMA_TILES[dtype]
    if M % tm or N % tn or K % tk:
        name = "bf16" if dtype == torch.bfloat16 else "int8"
        raise ValueError(f"{name} ({M}, {N}, {K}) is not a multiple of the "
                         f"wgmma kernel's ({tm}, {tn}, {tk}) tiles")
    return 256 if N % 256 == 0 else 128


def grid_flops(M: int, N: int, K: int, policy: TilePolicy) -> int:
    """Executed FLOPs implied by the static grid (the closed-form oracle)."""
    tm, tn, tk = policy.tm, policy.tn, policy.tk
    m_tiles = -(-M // tm)
    n_tiles = -(-N // tn)
    me = -(-m_tiles // policy.cm) * policy.cm * tm
    ne = -(-n_tiles // policy.cn) * policy.cn * tn
    ke = -(-K // tk) * tk
    return 2 * me * ne * ke


def _kernel():
    from repro_torch.kernels import _build
    fn = _build.load("gemm").gemm
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, p, p, p, p, i32, i32, i32, i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on validated CUDA operands; no count.
    int8 launches the transpose of y into a scratch Bᵀ first, on the same
    stream."""
    (M, K), N = x.shape, y.shape[1]
    code, out_dtype = _KINDS[x.dtype]
    bn = wgmma_tile_n(M, N, K, x.dtype) if x.dtype in WGMMA_TILES else 0
    bt = (torch.empty((N, K), dtype=torch.int8, device=x.device)
          if x.dtype == torch.int8 else None)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = _kernel()(code, x.data_ptr(), y.data_ptr(),
                    None if bt is None else bt.data_ptr(), out.data_ptr(), M,
                    N, K, bn, x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {err}")
    return out


def gemm_padded(x: torch.Tensor, y: torch.Tensor,
                policy: TilePolicy) -> torch.Tensor:
    """GEMM on tile-aligned operands.  x: (M_eff, K_eff); y: (K_eff, N_eff).

    Shapes MUST already be multiples of (tm, tk) / (tk, tn): `ops.matmul`
    does the Eq. 3 padding and records the executed-FLOPs metadata.  The
    output is int32 for int8 operands, else their dtype.  On a CUDA
    device the kernel runs and `gemm_padded.launched_flops` grows by the
    2·M_eff·N_eff·K_eff it executes; on the CPU the plain version runs.
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"operands {tuple(x.shape)} and {tuple(y.shape)} "
                         "do not chain as (M, K) @ (K, N)")
    (M, K), N = x.shape, y.shape[1]
    tm, tn, tk = policy.tm, policy.tn, policy.tk
    if M % tm or N % tn or K % tk:
        raise ValueError(f"({M}, {N}, {K}) is not padded to the policy's "
                         f"({tm}, {tn}, {tk}) tiles")
    if x.dtype != y.dtype or x.device != y.device:
        raise ValueError("x and y must share one dtype and one device")
    if x.device.type != "cuda":
        return ref_matmul(x, y)
    if x.dtype not in _KINDS:
        raise TypeError(f"the kernel takes float32, bfloat16 or int8, not "
                        f"{x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    if M > _GRID_Y_MAX or max(N, K) >= 2 ** 31:
        raise ValueError(f"({M}, {N}, {K}) exceeds the kernel's grid")
    if x.dtype in WGMMA_TILES:
        wgmma_tile_n(M, N, K, x.dtype)
        if x.data_ptr() % 16 or y.data_ptr() % 16:
            raise ValueError("the wgmma paths' loads need 16-byte-aligned "
                             "operands")
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=_KINDS[x.dtype][1], device=x.device)
    out = _launch(x, y)
    gemm_padded.launches += 1
    gemm_padded.launches_by[variant(x.dtype)] += 1
    gemm_padded.launched_flops += 2 * M * N * K
    return out


#: kernel launches, the FLOPs they executed and the launches of each path
#: (`variant`), since last set to 0
gemm_padded.launches = 0
gemm_padded.launched_flops = 0
gemm_padded.launches_by = {"wgmma_bf16": 0, "wgmma_s8": 0, "simt": 0}
