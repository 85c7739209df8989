"""Flash attention (the fast path for train/prefill attention).

Online softmax over tiles of keys, with the (m, l, acc) carry in f32 and
GQA by query-head groups that share one kv head.  A CUDA tensor launches
`csrc/flash_attention.cu` (the counterpart of the TPU kernel
`repro/kernels/flash_attention.py::_flash_kernel`; its source notes its
design and bound), which masks the ragged edges of Sq and Sk itself, so
it takes any sequence lengths; a CPU tensor takes the plain version,
`ref.ref_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import ref_attention

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 128                        # dims a warp holds: 4 a lane


def _kernel():
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i32, p, p, p, p, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One launch of the kernel on validated CUDA inputs; no count."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty_like(q)
    err = _kernel()(_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, Sq, Sk, H, KV, hd, scale, int(causal),
                    q.device.index,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, scale=None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd), H % KV == 0.

    Causal attention is top-left aligned (query i sees keys j <= i), as
    in the reference.  Any Sq and Sk >= 1: nothing needs padding.
    """
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} are not (B, S, heads, hd) alike")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if KV < 1 or H % KV or Sk < 1:
        raise ValueError(f"H = {H} must be a multiple of KV = {KV}, Sk >= 1")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different devices")
    scale = hd ** -0.5 if scale is None else scale
    if q.device.type != "cuda":
        return ref_attention(q, k, v, causal=causal, scale=scale)
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the kernel takes q, k and v of one dtype, float32 "
                        "or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    if hd > _MAX_HD or B * KV > 65535:
        raise ValueError(f"hd = {hd}, B·KV = {B * KV}: the kernel takes "
                         f"hd <= {_MAX_HD}, B·KV <= 65535")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = _launch(q, k, v, causal, float(scale))
    flash_attention_kernel.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention_kernel.launches = 0
