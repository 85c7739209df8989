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

The backward (`kernels.grad.flash_bwd`) routes by what its inputs show
(`bwd_route`): card tensors in bf16 with hd 64 or 128 and v shaped like
k launch `csrc/flash_bwd.cu`'s three kernels (the log-sum-exp and D,
then dK and dV, then dQ; no atomics, so repeatable bitwise) through the
op `torch.ops.repro_torch.flash_attention_bwd`, whose fake allocates
dq, dk, dv and the kernels' f32 scratch and whose FLOP formula counts
the tiles they run (`flash_bwd_flops`); everything else takes the plain
backward, `grad.flash_bwd_plain`.

The launch is the op `torch.ops.repro_torch.flash_attention`, so a
trace on fake CUDA tensors (`launch.hlo_analysis.analyze_step`, the dry
run) passes through it: its fake version (also its meta kernel)
allocates the output the launch allocates, and its FLOP formula counts
the (query, key) pairs the kernel's tiling computes (`flash_flops`).  A
fake call launches nothing and counts nothing.  DTensor inputs (a device
mesh) always take the op, through its sharding rule (`_sharding_rule`:
batch or heads), which launches it on each device's shards; on CPU
shards the op runs the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import sharding
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


@flash_attention_op.register_kernel("cpu")
def _(q, k, v, causal, scale, path):
    # a DTensor's CPU shards (a `gloo` mesh): the plain version on them
    return ref_attention(q, k, v, causal=causal, scale=scale).contiguous()


def _sharding_rule(q, k, v, causal, scale, path):
    """DTensor placements the op takes, one mesh dimension at a time:
    everything replicated; q, k, v and the output split alike over the
    batch; or over the heads, q's H with k's and v's KV, where both split
    evenly over a mesh dimension, so each device holds whole GQA groups.
    """
    from torch.distributed.tensor import Replicate, Shard
    rest = [None, None, None]
    out = [([r], [r, r, r] + rest) for r in (Replicate(), Shard(0))]
    sizes = sharding.mesh_sizes(q)
    if sharding.divides_each(q.shape[2], sizes) and \
            sharding.divides_each(k.shape[2], sizes):
        out.append(([Shard(2)], [Shard(2)] * 3 + rest))
    return out


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
    dtensor = sharding.is_dtensor(q)
    if q.device.type == "cpu" and not dtensor:
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
    if dtensor:
        sharding.ensure(torch.ops.repro_torch.flash_attention.default,
                        _sharding_rule)
    out = flash_attention_op(q, k, v, causal, float(scale), path)
    sharding.check_split(out, 2, H, KV)
    if not sharding.launched(out):
        return out
    flash_attention_kernel.launches += 1
    flash_attention_kernel.launches_by[path] += 1
    return out


#: kernel launches, and those of each kernel (`variant`), since the counts
#: were last set to 0
flash_attention_kernel.launches = 0
flash_attention_kernel.launches_by = {"wgmma_bf16": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the backward: csrc/flash_bwd.cu
# ---------------------------------------------------------------------------
#: head dims of the backward's kernels
_BWD_HD = (64, 128)
#: rows of a backward block (queries of the log-sum-exp and dq kernels,
#: keys of the dkdv kernel) and of the other side's tile
_BWD_ROWS, _BWD_TILE = 128, 64


def bwd_route(device_type: str, dtype: torch.dtype, q_shape, k_shape,
              v_shape) -> str:
    """Which backward an attention call takes, from what its inputs show:
    "kernel" (`csrc/flash_bwd.cu`) for card tensors (CUDA, or meta ones
    that stand for them in a shape-only trace) in bf16 with hd 64 or 128
    and v shaped like k; "plain" (`grad.flash_bwd_plain`) for everything
    else: CPU tensors, f32 and f64, other head dims, a narrower V."""
    hd = q_shape[-1]
    return "kernel" if (device_type in ("cuda", "meta")
                        and dtype == torch.bfloat16 and hd in _BWD_HD
                        and k_shape[-1] == hd
                        and tuple(v_shape) == tuple(k_shape)) else "plain"


def bwd_stats_rows(Sq: int) -> int:
    """Query rows of each (batch, head) of the backward's f32 scratch of
    log-sum-exps and D: Sq rounded up to a whole tile."""
    return -(-Sq // _BWD_TILE) * _BWD_TILE


def _bwd_kernel():
    from repro_torch.kernels import _build
    fn = _build.load("flash_bwd").flash_attention_bwd_bf16
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i32] * 6 + [ctypes.c_float, i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor, causal: bool,
                           scale: float) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, stats): the three launches of `csrc/flash_bwd.cu` on
    validated contiguous bf16 CUDA inputs, as an op; no count.  `stats`
    is the kernels' f32 scratch (2, B, H, `bwd_stats_rows(Sq)`): each
    query row's log-sum-exp and D = rowsum(dO ∘ O)."""
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("the backward's TMA loads take 16-byte-aligned q, "
                         "k, v, o and dO")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, B, H, bwd_stats_rows(Sq)), dtype=torch.float32,
                        device=q.device)
    err = _bwd_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), B, Sq,
        Sk, H, KV, hd, scale, int(causal), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dq, dk, dv, stats


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, do, causal, scale):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            q.new_empty((2, B, H, bwd_stats_rows(Sq)), dtype=torch.float32))


def flash_bwd_flops(q_shape, k_shape, causal: bool) -> int:
    """FLOPs the backward's kernels execute: 2·hd a (query, key) pair of
    a whole tile they compute, for each product and head.  The
    log-sum-exp (1 product) and dq (3: S, dP, dS·K) kernels run 128
    query rows by 64-key tiles, under `causal` up to the tile that holds
    the block's last row's diagonal; the dkdv kernel (4: Sᵀ, dPᵀ, Pᵀ·dO,
    dSᵀ·Q) 128 keys by 64-row query tiles, under `causal` from the tile
    that holds the block's first key's diagonal on."""
    B, Sq, H, hd = q_shape
    Sk = k_shape[1]
    rows, tile = _BWD_ROWS, _BWD_TILE
    n_q = math.ceil(Sq / tile)
    by_rows = sum(math.ceil((min(Sk, q0 + rows) if causal else Sk) / tile)
                  for q0 in range(0, Sq, rows))
    by_keys = sum(n_q - (min(k0 // tile, n_q) if causal else 0)
                  for k0 in range(0, Sk, rows))
    return 2 * hd * rows * tile * 4 * B * H * (by_rows + by_keys)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, causal, scale,
               *args, **kwargs) -> int:
    return flash_bwd_flops(q_shape, k_shape, causal)


def flash_attention_bwd_kernel(q, k, v, o, do, *, causal: bool,
                               scale: float):
    """(dq, dk, dv) of `flash_attention_kernel`'s attention through the
    backward's kernels, for inputs `bwd_route` sends there: q, o, do (B,
    Sq, H, hd) and k, v (B, Sk, KV, hd) in bf16, hd 64 or 128, on the card
    (or meta tensors, which take the op's fake version).  Gradients in
    bf16; two calls on the same inputs give bitwise equal ones.  Counts
    the three launches of a call on the card (a fake or meta call
    launches nothing and counts nothing)."""
    if bwd_route(q.device.type, q.dtype, q.shape, k.shape,
                 v.shape) != "kernel":
        raise ValueError(f"the backward's kernels take card bf16 q, k, v "
                         f"with hd in {_BWD_HD} and v shaped like k: "
                         f"{q.device.type} {q.dtype}, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if (k.shape[0] != B or KV < 1 or H % KV or Sk < 1 or Sq < 1
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, o "
                         f"{tuple(o.shape)} and dO {tuple(do.shape)} are "
                         f"not attention's (B, S, heads, hd) alike")
    if any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError("the backward takes q, k, v, o and dO of one dtype")
    if (math.ceil(Sq / _BWD_ROWS) > 65535
            or math.ceil(Sk / _BWD_ROWS) > 65535):
        raise ValueError("the backward takes Sq, Sk <= 65535 x 128")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    dq, dk, dv, _ = flash_attention_bwd_op(q, k, v, o, do, causal,
                                           float(scale))
    if not sharding.launched(dq):
        return dq, dk, dv
    flash_attention_bwd_kernel.launches += 3
    for name in flash_attention_bwd_kernel.launches_by:
        flash_attention_bwd_kernel.launches_by[name] += 1
    return dq, dk, dv


#: kernel launches, and those of each of the three kernels (one each a
#: call), since the counts were last set to 0
flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.launches_by = {"lse_d": 0, "dkdv": 0, "dq": 0}
