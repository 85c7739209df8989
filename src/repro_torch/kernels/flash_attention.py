"""Flash attention (the fast path for train/prefill attention).

Online softmax over tiles of keys, with the (m, l, acc) carry in f32 and
GQA by query-head groups that share one kv head.  A CUDA tensor launches
`csrc/flash_attention.cu` (the counterpart of the TPU kernel
`repro/kernels/flash_attention.py::_flash_kernel`; its source notes its
design and bound), which masks the ragged edges of Sq and Sk itself, so
it takes any sequence lengths and any hd up to 256.  bf16 with hd 64,
96, 112, 128 or 192 runs its TMA + wgmma kernel, everything else its
SIMT kernel (`variant`).  A CPU tensor takes the plain version,
`ref.ref_attention`; a meta tensor, which stands for a card tensor in a
shape-only trace, takes the op's fake version.  A CUDA call whose
inputs require grad, with grad mode on, raises: the launch is invisible
to autograd, and `kernels.ops.flash` carries the gradient through
`kernels.grad`.

The launch is the op `torch.ops.repro_torch.flash_attention`, so a
trace on fake CUDA tensors (`launch.hlo_analysis.analyze_step`, the dry
run) passes through it: its fake version (also its meta kernel)
allocates the output the launch allocates, and its FLOP formula counts
the (query, key) pairs the kernel's tiling computes (`flash_flops`).  A
fake call launches nothing and counts nothing.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ref import ref_attention

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 256                        # the SIMT kernel's widest plan
#: head dims of the tensor-core path: whole 64-column boxes, or 96 and
#: 112 (phi-3-vision's, zamba2's) in two boxes zero-filled past hd
_WGMMA_HD = (64, 96, 112, 128, 192)
#: query rows of a wgmma block; keys of a SIMT tile
_WGMMA_ROWS, _SIMT_KEYS = 128, 64


def simt_rows(hd: int) -> int:
    """Query rows of a SIMT block: 128, or 64 past hd 128, where Q, K, V
    and P must still fit one block's shared memory."""
    return 64 if hd > 128 else 128


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


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: float, path: str) -> torch.Tensor:
    """One launch of `path`'s kernel (`variant`) on validated CUDA inputs,
    as an op; no count.  The TMA loads' alignment is checked here, where
    the tensors have addresses (a fake tensor has none)."""
    if path == "wgmma_bf16" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 path takes, for its TMA loads, "
                         "16-byte-aligned q, k and v")
    return _launch(q, k, v, causal, scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, scale, path):
    return torch.empty_like(q)


def flash_flops(q_shape, k_shape, causal: bool, path: str) -> int:
    """FLOPs the kernel `path` executes: 4·hd a (query, key) pair it
    computes, for each head.  Both kernels compute whole tiles of a
    block's query rows by a tile's keys, under `causal` up to the tile
    that holds the block's last row's diagonal: the wgmma kernel 128 rows
    by 128 keys (64 past hd 128), the SIMT kernel 128 rows (64 past hd
    128, `simt_rows`) by 64 keys."""
    B, Sq, H, hd = q_shape
    Sk = k_shape[1]
    if path == "wgmma_bf16":
        rows, kv = _WGMMA_ROWS, 64 if hd > 128 else 128
    else:
        rows, kv = simt_rows(hd), _SIMT_KEYS
    ends = ([min(Sk, q0 + rows) for q0 in range(0, Sq, rows)] if causal
            else [Sk] * math.ceil(Sq / rows))
    pairs = rows * kv * sum(math.ceil(e / kv) for e in ends)
    return 4 * hd * B * H * pairs


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, scale, path, *args,
           **kwargs) -> int:
    return flash_flops(q_shape, k_shape, causal, path)


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
    if q.device.type == "cpu":
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
    if path == "wgmma_bf16" and H > 65535:
        raise ValueError("the bf16 path takes H <= 65535")
    if q.numel() == 0:
        return torch.empty_like(q)
    out = flash_attention_op(q, k, v, causal, float(scale), path)
    if is_fake(out) or out.is_meta:
        return out
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by[path] += 1
    return out


#: kernel launches, and those of each kernel (`variant`), since the counts
#: were last set to 0
flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by = {"wgmma_bf16": 0, "simt": 0}
