"""Flash attention (the fast path for train/prefill attention).

Online softmax over tiles of keys, with the (m, l, acc) carry in f32 and
GQA by query-head groups that share one kv head.  A CUDA tensor launches
`csrc/flash_attention.cu` (the counterpart of the TPU kernel
`repro/kernels/flash_attention.py::_flash_kernel`; its source notes its
design and bound), which masks the ragged edges of Sq and Sk itself, so
it takes any sequence lengths and any hd up to 256.  bf16 with hd 64,
96, 112, 128 or 192 runs its TMA + wgmma kernel, everything else its
SIMT kernel (`variant`).  A CPU tensor takes the plain version,
`ref.ref_attention`.  A CUDA call whose inputs require grad, with grad
mode on, raises: the launch is invisible to autograd, and
`kernels.ops.flash` carries the gradient through `kernels.grad`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import ref_attention

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 256                        # dims a warp holds: 8 a lane
#: head dims of the tensor-core path: whole 64-column boxes, or 96 and
#: 112 (phi-3-vision's, zamba2's) in two boxes zero-filled past hd
_WGMMA_HD = (64, 96, 112, 128, 192)


def variant(dtype: torch.dtype, hd: int) -> str:
    """Which kernel (q's dtype, head dim) takes: bf16 with hd 64, 96,
    112, 128 or 192 the TMA + wgmma kernel, everything else (f32; bf16
    with another hd <= 256) the SIMT one."""
    return "wgmma_bf16" if dtype == torch.bfloat16 and hd in _WGMMA_HD \
        else "simt"


def _kernel(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        head = [i32] if name == "flash_attention" else []
        fn.argtypes = head + [p, p, p, p, i32, i32, i32, i32, i32, i32,
                              ctypes.c_float, i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """One launch of `variant`'s kernel on validated CUDA inputs; no
    count."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, scale, int(causal), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if variant(q.dtype, hd) == "wgmma_bf16":
        err = _kernel("flash_attention_bf16_wgmma")(*args)
    else:
        err = _kernel("flash_attention")(_CODES[q.dtype], *args)
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the flash kernel's output carries no gradient: "
                           "call kernels.ops.flash, which routes inputs that "
                           "require grad through grad.FlashAttention")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("the kernel takes q, k and v of one dtype, float32 "
                        "or bfloat16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    if hd > _MAX_HD or B * KV > 65535:
        raise ValueError(f"hd = {hd}, B·KV = {B * KV}: the kernel takes "
                         f"hd <= {_MAX_HD}, B·KV <= 65535")
    path = variant(q.dtype, hd)
    if path == "wgmma_bf16" and (H > 65535 or any(
            t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("the bf16 path takes H <= 65535 and, for its TMA "
                         "loads, 16-byte-aligned q, k and v")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = _launch(q, k, v, causal, float(scale))
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by[path] += 1
    return out


#: kernel launches, and those of each kernel (`variant`), since the counts
#: were last set to 0
flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by = {"wgmma_bf16": 0, "simt": 0}
