"""Mamba2 SSD intra-chunk block (the model's matrix-heavy hot spot).

Per (batch·chunk, head) it computes the quadratic within-chunk term
Y = ((C·Bᵀ) ∘ L(dA) ∘ dt) @ X, where L is the causal decay matrix from
the within-chunk cumsum of dA.  A CUDA tensor launches `csrc/ssd_scan.cu`
(the counterpart of the TPU kernel `repro/kernels/ssd_scan.py::_ssd_kernel`;
its source notes its design and bound): bf16 at the shapes `variant`
names runs its TMA + wgmma kernel, which computes C·Bᵀ once for
`wgmma_heads` heads of one group, everything else its register-tiled
SIMT kernels, which compute it once a (chunk, group) into a scratch
tensor (`simt_scratch`) and then serve `simt_heads` heads a block.  A
CPU tensor takes the plain version, `ref.ref_ssd_intra`; a meta tensor,
which stands for a card tensor in a shape-only trace, takes the op's
fake version.  A CUDA call whose inputs require grad, with grad mode
on, raises: `kernels.ops.ssd` carries the gradient through
`kernels.grad`.  The linear inter-chunk recurrence stays in plain
PyTorch (`ops.ssd`).

The launch is the op `torch.ops.repro_torch.ssd_intra`, so a trace on
fake CUDA tensors (`launch.hlo_analysis.analyze_step`, the dry run)
passes through it: the op returns the output and the scratch the launch
wrote (empty on the tensor-core path), so its fake version (also its
meta kernel), which allocates both, shows a trace every byte the launch
allocates; its FLOP formula counts the causal pairs of each chunk and
head (`ssd_flops`).  A fake call launches nothing and counts nothing.
DTensor inputs (a device mesh) always take the op, through its sharding
rule (`_sharding_rule`: batch·chunks, or heads with their B/C groups),
which launches it on each device's shards; on CPU shards the op runs
the plain version.

The backward (`kernels.grad.ssd_intra_bwd`) routes by what its inputs
show (`bwd_route`): card tensors in bf16 with hd 64, ds a multiple of 64
up to 256 and Q a multiple of 64 up to 1,024 launch `csrc/ssd_bwd.cu`'s
three kernels (dG with d dacs's row part, then dX, d dt and d dacs, then
dC and dB; no atomics, so repeatable bitwise) through the op
`torch.ops.repro_torch.ssd_intra_bwd`, whose fake allocates the five
gradients and the kernels' f32 dG scratch and whose FLOP formula counts
the tiles they run (`ssd_bwd_flops`); everything else takes the plain
backward, `grad.ssd_intra_bwd_plain`.

B/C arrive in their groups: head h reads group h // (nh / g), where the
reference takes them broadcast to one copy a head (g = nh here).
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import sharding
from repro_torch.kernels.ref import ref_ssd_intra

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD, _MAX_DS = 128, 256          # what one block's shared memory holds
_WGMMA_HD = (64, 128)                # head dims of the tensor-core kernel
_WGMMA_MAX_Q = 1024                  # its column data in shared memory
#: rows of a SIMT strip, and columns of each of its tiles
_SIMT_ROWS = 64


def variant(dtype: torch.dtype, Q: int, hd: int, ds: int) -> str:
    """Which kernel (x's dtype, chunk Q, head dim, state dim) takes: bf16
    with hd 64 or 128, ds a multiple of 64 up to 256 and Q a multiple of
    64 up to 1,024 the TMA + wgmma kernel (its 64-column boxes and
    64-row warpgroups tile them whole), everything else the SIMT one."""
    return "wgmma_bf16" if (dtype == torch.bfloat16 and hd in _WGMMA_HD
                            and ds % 64 == 0 and 64 <= ds <= _MAX_DS
                            and Q % 64 == 0 and 64 <= Q <= _WGMMA_MAX_Q) \
        else "simt"


def wgmma_heads(hd: int, nh: int, g: int) -> int:
    """Heads a work item of the tensor-core kernel serves from one C·Bᵀ:
    2 at hd 64 where the heads of a group (nh / g) are even, else 1 (each
    head's f32 Y takes hd / 2 registers a thread beside C·Bᵀ's 64)."""
    return 2 if hd == 64 and (nh // g) % 2 == 0 else 1


def simt_heads(hd: int) -> int:
    """Heads a work item of the SIMT kernel serves from one C·Bᵀ: 4 heads'
    Y to each of its 4 quarters up to hd 32 (hd_pad, hd rounded up to 16
    or 32, registers a thread a head), one past it (64 or 128 registers).
    A group whose heads it does not divide ends in a shorter block."""
    return 16 if hd <= 32 else 4


def _kernel(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("ssd_scan"), name)
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "ssd_intra":
            fn.argtypes = [i32, p, p, p, p, p, p, p, i32, i32, i32, i32,
                           i32, i32, i32, i32, p]
        else:
            fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, i32, i32,
                           i32, i32, p]
        fn.restype = ctypes.c_int
    return fn


def simt_scratch(BC: int, Q: int, g: int) -> int:
    """f32 values of the SIMT kernel's C·Bᵀ scratch: a 64 x 64 tile for
    each (chunk, group, strip, column tile at or below the strip)."""
    n = -(-Q // _SIMT_ROWS)
    return BC * g * n * (n + 1) // 2 * _SIMT_ROWS * _SIMT_ROWS


def _kernel_call(x, dt, dacs, b, c, y):
    """The C function of `variant`'s kernel, its arguments, writing y, for
    validated CUDA inputs, and the scratch they name (the SIMT kernel's
    C·Bᵀ tiles; 0 values for the tensor-core kernel), which must outlive
    every launch with them."""
    BC, Q, nh, hd = x.shape
    _, _, g, ds = b.shape
    ptrs = (x.data_ptr(), dt.data_ptr(), dacs.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr())
    tail = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if variant(x.dtype, Q, hd, ds) == "wgmma_bf16":
        return _kernel("ssd_intra_bf16_wgmma"), (
            *ptrs, BC, Q, nh, hd, g, ds, wgmma_heads(hd, nh, g), *tail), \
            x.new_empty(0, dtype=torch.float32)
    cb = torch.empty(simt_scratch(BC, Q, g), dtype=torch.float32,
                     device=x.device)
    return _kernel("ssd_intra"), (_CODES[x.dtype], *ptrs, cb.data_ptr(), BC,
                                  Q, nh, hd, g, ds, simt_heads(hd), *tail), cb


def _launch_with_scratch(x, dt, dacs, b, c) -> tuple:
    """One launch of `variant`'s kernel on validated CUDA inputs, no
    count: its output and the scratch it wrote (`_kernel_call`)."""
    y = torch.empty_like(x)
    fn, args, scratch = _kernel_call(x, dt, dacs, b, c, y)
    err = fn(*args)
    if err:
        raise RuntimeError(f"ssd_intra kernel launch failed: CUDA error {err}")
    return y, scratch


def _launch(x, dt, dacs, b, c) -> torch.Tensor:
    """One launch of `variant`'s kernel on validated CUDA inputs; no
    count."""
    return _launch_with_scratch(x, dt, dacs, b, c)[0]


@torch.library.custom_op("repro_torch::ssd_intra", mutates_args=())
def ssd_intra_op(x: torch.Tensor, dt: torch.Tensor, dacs: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 path: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of `path`'s kernel (`variant`) on validated CUDA inputs,
    as an op; no count: (output, scratch) as `_launch_with_scratch`.  The
    TMA loads' alignment is checked here, where the tensors have
    addresses (a fake tensor has none)."""
    if path == "wgmma_bf16" and any(t.data_ptr() % 16 for t in (x, b, c)):
        raise ValueError("the bf16 path takes, for its TMA loads, "
                         "16-byte-aligned x, b and c")
    return _launch_with_scratch(x, dt, dacs, b, c)


@ssd_intra_op.register_fake
def _(x, dt, dacs, b, c, path):
    BC, Q = x.shape[:2]
    n = 0 if path == "wgmma_bf16" else simt_scratch(BC, Q, b.shape[2])
    return torch.empty_like(x), x.new_empty(n, dtype=torch.float32)


@ssd_intra_op.register_kernel("cpu")
def _(x, dt, dacs, b, c, path):
    # a DTensor's CPU shards (a `gloo` mesh): the plain version on them
    return (ref_ssd_intra(x, dt, dacs, b, c).contiguous(),
            x.new_empty(0, dtype=torch.float32))


def _sharding_rule(x, dt, dacs, b, c, path):
    """DTensor placements the op takes, one mesh dimension at a time:
    everything replicated; every input split alike over batch·chunks; or
    over the heads, x's, dt's and dacs's nh with b's and c's g, where g
    splits evenly over a mesh dimension, so each device holds whole
    groups of its heads.  The scratch (C·Bᵀ tiles a (chunk, group), flat)
    splits with the chunks or the groups."""
    from torch.distributed.tensor import Replicate, Shard
    out = [([Replicate()] * 2, [Replicate()] * 5 + [None]),
           ([Shard(0)] * 2, [Shard(0)] * 5 + [None])]
    if sharding.divides_each(b.shape[2], sharding.mesh_sizes(x)):
        out.append(([Shard(2), Shard(0)], [Shard(2)] * 5 + [None]))
    return out


def ssd_flops(x_shape, b_shape) -> int:
    """FLOPs of the intra-chunk term, as the kernels' bounds count them:
    C·B and M·X over the causal pairs of each chunk, and M's decay and
    scale, 2·(ds + hd) + 4 a pair, for each head (both kernels compute
    C·Bᵀ once a block of `wgmma_heads` heads, the SIMT kernels once a
    group, so this overstates their work)."""
    BC, Q, nh, hd = x_shape
    ds = b_shape[-1]
    return BC * nh * Q * (Q + 1) // 2 * (2 * (ds + hd) + 4)


@register_flop_formula(torch.ops.repro_torch.ssd_intra)
def _flops(x_shape, dt_shape, dacs_shape, b_shape, c_shape, path, *args,
           **kwargs) -> int:
    return ssd_flops(x_shape, b_shape)


def ssd_intra_kernel(x, dt, dacs, b, c, *, head_block: int = 8):
    """x: (BC, Q, nh, hd); dt/dacs: (BC, Q, nh); b/c: (BC, Q, g, ds).

    BC = batch·chunks; nh % g == 0 and head h reads group h // (nh / g)
    (g = nh: the reference's per-head layout).  Returns the intra-chunk
    output (BC, Q, nh, hd) in x's dtype.  `head_block` is the reference's
    head blocking: nh must be a multiple of min(head_block, nh), as
    there; the card's kernels group heads by their own rule
    (`wgmma_heads`, `simt_heads`) whatever it is.
    """
    BC, Q, nh, hd = x.shape
    g, ds = b.shape[-2:]
    hb = min(head_block, nh)
    if hb < 1 or nh % hb:
        raise ValueError(f"nh = {nh} is not a multiple of head_block {hb}")
    if (tuple(dt.shape) != (BC, Q, nh) or dacs.shape != dt.shape
            or tuple(b.shape) != (BC, Q, g, ds) or c.shape != b.shape
            or g < 1 or nh % g):
        raise ValueError("expected x (BC, Q, nh, hd), dt/dacs (BC, Q, nh), "
                         "b/c (BC, Q, g, ds) with nh % g == 0")
    if len({t.device for t in (x, dt, dacs, b, c)}) != 1:
        raise ValueError("inputs lie on different devices")
    dtensor = sharding.is_dtensor(x)
    if x.device.type == "cpu" and not dtensor:
        return ref_ssd_intra(x, dt, dacs, b, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, dacs, b, c)):
        raise RuntimeError("the SSD kernel's output carries no gradient: "
                           "call kernels.ops.ssd, which routes inputs that "
                           "require grad through grad.SSDIntra")
    if x.dtype not in _CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("the kernel takes x, b and c of one dtype, float32 "
                        "or bfloat16")
    if dt.dtype != torch.float32 or dacs.dtype != torch.float32:
        raise TypeError("the kernel takes float32 dt and dacs")
    if not all(t.is_contiguous() for t in (x, dt, dacs, b, c)):
        raise ValueError("the kernel takes contiguous inputs")
    if hd > _MAX_HD or ds > _MAX_DS or nh > 65535:
        raise ValueError(f"hd = {hd}, ds = {ds}, nh = {nh}: the kernel "
                         f"takes hd <= {_MAX_HD}, ds <= {_MAX_DS}, "
                         "nh <= 65535")
    path = variant(x.dtype, Q, hd, ds)
    if x.numel() == 0:
        return torch.empty_like(x)
    if dtensor:
        sharding.ensure(torch.ops.repro_torch.ssd_intra.default,
                        _sharding_rule)
    y, _scratch = ssd_intra_op(x, dt, dacs, b, c, path)
    sharding.check_split(y, 2, nh, g)
    if not sharding.launched(y):
        return y
    ssd_intra_kernel.launches += 1
    ssd_intra_kernel.launches_by[path] += 1
    return y


#: kernel launches, and those of each kernel (`variant`), since the counts
#: were last set to 0
ssd_intra_kernel.launches = 0
ssd_intra_kernel.launches_by = {"wgmma_bf16": 0, "simt": 0}


# ---------------------------------------------------------------------------
# the backward: csrc/ssd_bwd.cu
# ---------------------------------------------------------------------------
#: the head dim of the backward's kernels
_BWD_HD = 64
#: rows and columns of the tiles the backward's products run
_BWD_TILE = 64


def bwd_route(device_type: str, dtype: torch.dtype, Q: int, hd: int, ds: int,
              nh: int, g: int) -> str:
    """Which backward an SSD call takes, from what its inputs show:
    "kernel" (`csrc/ssd_bwd.cu`) for card tensors (CUDA, or meta ones that
    stand for them in a shape-only trace) in bf16 with hd 64, ds a
    multiple of 64 up to 256 and Q a multiple of 64 up to 1,024 (the
    tensor-core forward's shapes at hd 64); "plain"
    (`grad.ssd_intra_bwd_plain`) for everything else: CPU tensors, f32 and
    f64, other shapes."""
    return "kernel" if (device_type in ("cuda", "meta")
                        and dtype == torch.bfloat16 and hd == _BWD_HD
                        and ds % 64 == 0 and 64 <= ds <= _MAX_DS
                        and Q % 64 == 0 and 64 <= Q <= _WGMMA_MAX_Q
                        and g >= 1 and nh % g == 0) else "plain"


def _bwd_kernel():
    from repro_torch.kernels import _build
    fn = _build.load("ssd_bwd").ssd_intra_bwd_bf16
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i32] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op("repro_torch::ssd_intra_bwd", mutates_args=())
def ssd_intra_bwd_op(x: torch.Tensor, dt: torch.Tensor, dacs: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, ddt, ddacs, db, dc, dg): the three launches of
    `csrc/ssd_bwd.cu` on validated contiguous CUDA inputs, as an op; no
    count.  `dg` is the kernels' f32 scratch (BC, g, Q, Q) of dG summed
    over each group's heads (tiles above the diagonal left unwritten)."""
    if any(t.data_ptr() % 16 for t in (x, b, c, dy)):
        raise ValueError("the backward's TMA loads take 16-byte-aligned x, "
                         "b, c and dy")
    BC, Q, nh, hd = x.shape
    g, ds = b.shape[-2:]
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    ddt, ddacs = torch.empty_like(dt), torch.empty_like(dacs)
    dg = torch.empty((BC, g, Q, Q), dtype=torch.float32, device=x.device)
    err = _bwd_kernel()(
        x.data_ptr(), dt.data_ptr(), dacs.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        ddacs.data_ptr(), db.data_ptr(), dc.data_ptr(), dg.data_ptr(), BC, Q,
        nh, hd, g, ds, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_intra_bwd kernel launch failed: CUDA error "
                           f"{err}")
    return dx, ddt, ddacs, db, dc, dg


@ssd_intra_bwd_op.register_fake
def _(x, dt, dacs, b, c, dy):
    BC, Q = x.shape[:2]
    return (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(dacs),
            torch.empty_like(b), torch.empty_like(c),
            x.new_empty((BC, b.shape[2], Q, Q), dtype=torch.float32))


def ssd_bwd_flops(x_shape, b_shape) -> int:
    """FLOPs the backward's products execute: 2·64·64·K a 64 x 64 tile
    pair (i >= j) of a chunk and product of depth K (or of width ds
    over K = 64).  Over a chunk's n(n + 1)/2 such pairs (n = Q / 64):
    S = C·Bᵀ once a group (`ssd_bwd_dg`) and once a head (`ssd_bwd_dx`),
    dM twice and dX a head, dC and dB a group (on the f32 cores)."""
    BC, Q, nh, hd = x_shape
    g, ds = b_shape[-2:]
    n = Q // _BWD_TILE
    pairs = BC * n * (n + 1) // 2
    return 2 * _BWD_TILE * _BWD_TILE * pairs * (3 * g * ds
                                                 + nh * (ds + 3 * hd))


@register_flop_formula(torch.ops.repro_torch.ssd_intra_bwd)
def _bwd_flops(x_shape, dt_shape, dacs_shape, b_shape, c_shape, dy_shape,
               *args, **kwargs) -> int:
    return ssd_bwd_flops(x_shape, b_shape)


def ssd_intra_bwd_kernel(x, dt, dacs, b, c, dy):
    """(dx, ddt, ddacs, db, dc) of `ssd_intra_kernel`'s intra-chunk term
    through the backward's kernels, for inputs `bwd_route` sends there:
    x, dy (BC, Q, nh, 64) and b, c (BC, Q, g, ds) in bf16, dt, dacs (BC,
    Q, nh) in f32, on the card (or meta tensors, which take the op's fake
    version).  Gradients in the inputs' dtypes; two calls on the same
    inputs give bitwise equal ones.  Counts the three launches of a call
    on the card (a fake or meta call launches nothing and counts
    nothing)."""
    BC, Q, nh, hd = x.shape
    g, ds = b.shape[-2:]
    if bwd_route(x.device.type, x.dtype, Q, hd, ds, nh, g) != "kernel":
        raise ValueError(f"the backward's kernels take card bf16 x with hd "
                         f"{_BWD_HD}, ds a multiple of 64 up to {_MAX_DS} and "
                         f"Q a multiple of 64 up to {_WGMMA_MAX_Q}: "
                         f"{x.device.type} {x.dtype}, x {tuple(x.shape)}, "
                         f"b {tuple(b.shape)}")
    if (tuple(dt.shape) != (BC, Q, nh) or dacs.shape != dt.shape
            or tuple(b.shape) != (BC, Q, g, ds) or c.shape != b.shape
            or dy.shape != x.shape):
        raise ValueError("expected x, dy (BC, Q, nh, hd), dt/dacs (BC, Q, "
                         "nh), b/c (BC, Q, g, ds)")
    if b.dtype != x.dtype or c.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError("the backward takes x, b, c and dy of one dtype")
    if dt.dtype != torch.float32 or dacs.dtype != torch.float32:
        raise TypeError("the backward takes float32 dt and dacs")
    if x.numel() == 0:                  # no chunk or no head: nothing flows
        return tuple(torch.zeros_like(t) for t in (x, dt, dacs, b, c))
    x, dt, dacs, b, c, dy = (t.contiguous() for t in (x, dt, dacs, b, c, dy))
    dx, ddt, ddacs, db, dc, _ = ssd_intra_bwd_op(x, dt, dacs, b, c, dy)
    if not sharding.launched(dx):
        return dx, ddt, ddacs, db, dc
    ssd_intra_bwd_kernel.launches += 3
    for name in ssd_intra_bwd_kernel.launches_by:
        ssd_intra_bwd_kernel.launches_by[name] += 1
    return dx, ddt, ddacs, db, dc


#: kernel launches, and those of each of the three kernels (one each a
#: call), since the counts were last set to 0
ssd_intra_bwd_kernel.launches = 0
ssd_intra_bwd_kernel.launches_by = {"dg": 0, "dx": 0, "dbdc": 0}
