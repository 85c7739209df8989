"""Fused OFU histogram-accumulate: the device side of rollup ingest.

`StreamingRollup.add_grid` over a host grid computes per-device OFU on
the host and scatter-adds it into per-bucket histograms.  For a grid that
lives on the GPU that round trip is the bottleneck: a 1M-device day of
30 s scrapes is ~23 GB of per-device OFU that exists only to be reduced
into a few kilobytes of (bucket, bin) counts.  This module keeps the
reduction on the device:

    ofu = tpa * clock * inv_fmax       (Eq. 1, elementwise, f32)
    k   = bucketize(ofu, edges)        (comparison-based, as searchsorted)
    hist[b, k] += 1 ; sums[b] += ofu   (per time-bucket accumulate)

Two implementations of the one function:

  * `csrc/fleet_hist.cu`, a CUDA kernel for Hopper (the counterpart of
    the TPU kernel `repro/kernels/fleet_hist.py::_hist_kernel`; its
    source notes its design and bound).  Counts are exact int32, sums
    float64 accumulated from per-block f32 partial sums.  Each block
    privatises its counts by (bucket, bin) through a `plan` of the
    column->bucket map made here.
  * `bucket_hist_torch`, the plain PyTorch version (searchsorted +
    bincount, int64 counts, float64 sums), for CPU tensors and as
    the kernel's check.

`ofu_bucket_hist` picks by the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes the plain version.  Bins are
found by comparison against f32 edges, never by arithmetic on the value:
a `floor((v - lo) * inv_width)` chain flips samples one ulp from an edge.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

#: SMs on the card the row split is sized for (H100 SXM), and the blocks
#: of the kernel an SM holds at once; more blocks than a few waves only
#: cost flushes, fewer leave SMs idle
_SMS, _BLOCKS_PER_SM, _WAVES = 132, 8, 4
_COLS = 128                          # columns of a block's tile


def _edges_f32(edges) -> np.ndarray:
    """Edge grid in the comparison dtype (f32, matching the engine's
    telemetry); must be strictly increasing."""
    edges = np.asarray(edges, np.float32)
    if edges.ndim != 1 or len(edges) < 2 or not (np.diff(edges) > 0).all():
        raise ValueError("edges must be a 1-D strictly-increasing grid")
    return edges


def bucket_hist_torch(tpa: torch.Tensor, clock: torch.Tensor, *,
                      inv_fmax: float, edges, col_bucket, n_buckets: int):
    """Plain PyTorch version: (hist (B, bins) int64, sums (B,) float64)
    on the inputs' device, with the kernel's f32 OFU arithmetic
    (searchsorted + bincount + `index_add_`)."""
    edges_t = torch.from_numpy(_edges_f32(edges)).to(tpa.device)
    bins = edges_t.numel() - 1
    col = torch.as_tensor(col_bucket, device=tpa.device).long()
    ofu = (tpa.float() * clock.float()).mul_(float(np.float32(inv_fmax)))
    k = (torch.searchsorted(edges_t, ofu.reshape(-1), right=True) - 1) \
        .clamp_(0, bins - 1)
    seg = col.expand(ofu.shape).reshape(-1)
    hist = torch.bincount(seg * bins + k, minlength=n_buckets * bins)
    sums = torch.zeros(n_buckets, dtype=torch.float64, device=tpa.device)
    sums.index_add_(0, seg, ofu.reshape(-1).double())
    return hist.reshape(n_buckets, bins), sums


def rows_per_block(n_rows: int, n_cols: int) -> int:
    """Row split of the kernel's grid: enough (column tile, row tile)
    blocks for a few waves of the card, at least 64 rows each."""
    col_tiles = -(-n_cols // _COLS)
    target = _WAVES * _SMS * _BLOCKS_PER_SM
    row_tiles = max(1, min(-(-target // col_tiles), n_rows // 64))
    return -(-n_rows // row_tiles)


def plan(col_bucket, n_buckets: int) -> tuple:
    """The kernel's view of a column->bucket map: each tile of 128
    columns numbers the distinct buckets of its columns 0, 1, ... (their
    slots, in bucket order).  Returns (int32 array of each column's slot
    followed by each tile's slot->bucket table, -1 where a tile has fewer
    slots, n_slots: the most slots a tile has)."""
    col = np.asarray(col_bucket, np.int64)
    tile = np.arange(col.size) // _COLS
    n_tiles = int(tile[-1]) + 1
    uniq, inv = np.unique(tile * n_buckets + col, return_inverse=True)
    first = np.searchsorted(uniq, np.arange(n_tiles) * n_buckets)
    n_slots = int(np.diff(np.append(first, uniq.size)).max())
    table = np.full((n_tiles, n_slots), -1, np.int64)
    utile = uniq // n_buckets
    table[utile, np.arange(uniq.size) - first[utile]] = uniq % n_buckets
    return (np.concatenate([inv.reshape(-1) - first[tile],
                            table.reshape(-1)]).astype(np.int32), n_slots)


def _kernel():
    from repro_torch.kernels import _build
    fn = _build.load("fleet_hist").fleet_hist
    if fn.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, i64, i64, i64, p, i32, p, i32, ctypes.c_float,
                       p, p, i32, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(tpa, clock, edges, plan_t, n_slots, inv_fmax, hist, sums):
    """One launch into zeroed hist (B, bins) int32 and sums (B,) float64
    on validated CUDA inputs (edges f32 and `plan`'s array on the card);
    no count."""
    D, S = tpa.shape
    err = _kernel()(
        tpa.data_ptr(), clock.data_ptr(), D, S, rows_per_block(D, S),
        plan_t.data_ptr(), n_slots, edges.data_ptr(), edges.numel() - 1,
        float(np.float32(inv_fmax)), hist.data_ptr(), sums.data_ptr(),
        tpa.device.index, torch.cuda.current_stream(tpa.device).cuda_stream)
    if err:
        raise RuntimeError(f"fleet_hist kernel launch failed: CUDA error "
                           f"{err}")


def ofu_bucket_hist(tpa: torch.Tensor, clock: torch.Tensor, *,
                    inv_fmax: float, edges, col_bucket, n_buckets: int):
    """Device-side fused ingest: (hist (B, bins), sums (B,)) tensors on
    the grid's device.

    tpa, clock: (D, S) float32 tensors on one device.  col_bucket: (S,)
    host array, the 0-based LOCAL bucket row of each scrape column, any
    map into [0, n_buckets) (the caller rebases absolute bucket indices).  On a
    CUDA device the kernel runs (int32 counts); on the CPU the plain
    version does (int64 counts).  Sums are float64 on both.
    """
    edges = _edges_f32(edges)
    if not (isinstance(tpa, torch.Tensor) and isinstance(clock, torch.Tensor)):
        raise TypeError("tpa and clock must be torch tensors")
    if tpa.shape != clock.shape or tpa.dim() != 2:
        raise ValueError(f"tpa {tuple(tpa.shape)} and clock "
                         f"{tuple(clock.shape)} must be one (D, S) shape")
    if tpa.device != clock.device:
        raise ValueError("tpa and clock lie on different devices")
    col = np.asarray(col_bucket, np.int32)
    if col.shape != (tpa.shape[1],):
        raise ValueError(f"col_bucket has shape {col.shape}, expected "
                         f"({tpa.shape[1]},)")
    if col.size and (col.min() < 0 or col.max() >= n_buckets):
        raise ValueError(f"col_bucket values must lie in [0, {n_buckets})")
    if tpa.device.type != "cuda":
        return bucket_hist_torch(tpa, clock, inv_fmax=inv_fmax, edges=edges,
                                 col_bucket=torch.from_numpy(col),
                                 n_buckets=n_buckets)
    if tpa.dtype != torch.float32 or clock.dtype != torch.float32:
        raise TypeError("the kernel takes float32 tpa and clock")
    if not (tpa.is_contiguous() and clock.is_contiguous()):
        raise ValueError("the kernel takes contiguous tpa and clock")
    bins = len(edges) - 1
    hist = torch.zeros((n_buckets, bins), dtype=torch.int32,
                       device=tpa.device)
    sums = torch.zeros(n_buckets, dtype=torch.float64, device=tpa.device)
    if tpa.numel() == 0:
        return hist, sums
    plan_np, n_slots = plan(col, n_buckets)
    _launch(tpa, clock, torch.from_numpy(edges).to(tpa.device),
            torch.from_numpy(plan_np).to(tpa.device), n_slots, inv_fmax,
            hist, sums)
    ofu_bucket_hist.launches += 1
    return hist, sums


#: kernel launches since the count was last set to 0
ofu_bucket_hist.launches = 0
