// The backward of the bf16 Mamba2 SSD intra-chunk block for Hopper
// (sm_90a), hd 64.
//
// Replaces no TPU kernel: the reference's Pallas SSD kernel
// (repro/kernels/ssd_scan.py::_ssd_kernel) has no custom_vjp, so XLA
// differentiates the reference's jnp scan.  This is the backward of
// csrc/ssd_scan.cu's tensor-core forward, per chunk z and head h of x
// (BC, Q, nh, hd), dt/dacs (BC, Q, nh) f32 and b/c (BC, Q, g, ds), head h
// reading group h / (nh / g):
//
//     S = C.B^T (the group's), L_ij = exp(dacs_i - dacs_j) for i >= j,
//     else 0; M = S * L * dt_j (f32)
//     dM = dY.X^T;  dX = round(M)^T.dY
//     d dt_j = sum_i dM S L;  W = dM * M = dM S L dt_j
//     d dacs_i = sum_j W_ij - sum_i W_ji = sum_j W_ij - dt_i d dt_i
//     dG = sum over the group's heads of dM * L * dt_j (f32)
//     dC = dG.B;  dB = dG^T.C
//
// with every product of bf16 values summed in f32, M rounded to bf16
// only as the A operand of dX's product (where the forward rounds it),
// and d dt, both sums of W and dG f32 sums of f32 registers.  Three
// kernels, in this order on one stream, none with atomics, so two calls
// give bitwise equal gradients:
//
//   * ssd_bwd_dg: a work item is (chunk z, group, a strip of 128 rows i);
//     it walks the 64-column tiles j at or below the strip's diagonal and,
//     for each, the group's heads: S = C_i.B_j^T once a tile, dM =
//     dY_i.X_j^T a head, then dG += dM * L * dt_j and each head's row sums
//     of W in f32 registers.  dG (f32) goes to a scratch (BC, g, Q, Q),
//     tiles wholly above the diagonal never written, and the row part of
//     d dacs to d dacs itself: each (chunk, row, head) is owned by one
//     thread of one item, which adds its tile's sum to it in turn.
//   * ssd_bwd_dx: a work item is (chunk z, a strip of 128 rows j, head h),
//     as flash_bwd.cu's dK/dV kernel: B_j and X_j stay in shared memory
//     while the 64-row tiles i from the diagonal on stream through a ring:
//     S^T = B_j.C_i^T and dM^T = X_j.dY_i^T (both operands from shared
//     memory), M^T on the accumulator registers, rounded into the A operand
//     of dX += M^T.dY_i (dY_i read in place through the transpose bit),
//     and d dt_j = sum_i dM^T S^T L^T per row.  It writes dX and d dt once
//     and d dacs_j = (the row part ssd_bwd_dg left) - dt_j d dt_j.
//   * ssd_bwd_dbdc: register-tiled on the f32 cores, a block a (chunk,
//     group, 64-row tile, dC or dB, 64 state columns): dC_i = sum_j dG_ij
//     B_j over the tiles j <= i and dB_j = sum_i dG_ij C_i over i >= j,
//     from the f32 scratch.
//
// ssd_bwd_dg and ssd_bwd_dx have the forward's shape: a persistent grid of
// one block an SM walks the work items in turn, longest first; one
// producer thread keeps the TMA loads (128-byte-swizzled 64-column boxes
// of 4-D tensor maps (width, heads or groups, Q, BC), zero-filled past Q)
// in flight on mbarrier rings, the next item's beside this one's products;
// a producer warp writes each step's decays (dacs * log2 e, and dt_j) to
// shared memory; two consumer warpgroups of 64 rows run the wgmma products
// and the elementwise work on their accumulators.  Tiles wholly above the
// diagonal are skipped, not masked; the diagonal tiles mask j > i.  Every
// consumer warp releases each ring slot itself (8 arrivals): the warps of
// a warpgroup meet only at its products, so across tiles it skips one warp
// can fall behind another, and a slot released for the warpgroup by one
// warp could be refilled, and its next use land, before a late warp's
// parity wait on it, which would then wait a phase too far and never
// return.
//
// Bound: bytes.  At zamba2-7b-instruct's layer (BC 32 chunks of Q 256, nh
// 112 heads of 64, g 2, ds 64) x, dY and dX are 3 x 117 MB, b, c, dt, dacs
// and their gradients ~15 MB, the scratch 16.8 MB written and read: ~400
// MB, 0.12 ms at 3.35 TB/s.  The products over the 64 x 64 tiles at or
// below the diagonal (S twice, dM twice, dX, dC, dB) are 76 GFLOP, 0.077 ms
// at 989 TFLOP/s; the exps 2 x 147 M on the SFU.

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;          // rows of a strip
constexpr int kTile = 64;           // rows or columns of a tile
constexpr int kHd = 64;             // the head dim the kernels take
constexpr int kThreads = 384;       // 2 consumer warpgroups + producer
constexpr int kRowBox = kRows * 128;   // bytes of a 128-row box
constexpr int kTileBox = kTile * 128;  // of a 64-row box
constexpr int kSmemMax = 232448;    // a block's shared memory (227 KB)
constexpr int kConsumerWarps = 8;    // each releases what it has read
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

// Byte offsets from the 1024-aligned base: `nrow` buffers of each item's
// strip data, `nb` buffers of a tile's data (ssd_bwd_dg's B_j), `stages`
// ring stages, each stage's decays (`col` floats), then barriers.  The
// largest (nrow, stages) of (2, 4), (2, 3), (2, 2), (1, 4), (1, 3), (1, 2)
// that fits 227 KB.
struct Plan {
  int nrow, stages, row, tile, stage, col, tiles, stage0, cols, bars, bytes;
};

__host__ __device__ inline Plan make_plan(int row, int tile, int nb,
                                          int stage, int col) {
  Plan p;
  p.row = row, p.tile = tile, p.stage = stage, p.col = col;
  for (int pick = 0; pick < 6; ++pick) {
    p.nrow = pick < 3 ? 2 : 1;
    p.stages = 4 - pick % 3;
    p.tiles = p.nrow * row;
    p.stage0 = p.tiles + nb * tile;
    p.cols = p.stage0 + p.stages * stage;
    p.bars = p.cols + p.stages * col * 4;
    p.bytes = 1024 + p.bars + 16 * 8;
    if (p.bytes <= kSmemMax) break;
  }
  return p;
}

// ssd_bwd_dg: C_i (128 rows x ds) a strip; B_j (64 x ds) a tile, two
// buffers; a stage dY_i (128 x 64) and X_j (64 x 64), with a_i (128), a_j
// and dt_j (64 each).
__host__ __device__ inline Plan dg_plan(int ds) {
  return make_plan(ds / 64 * kRowBox, ds / 64 * kTileBox, 2,
                   kRowBox + kTileBox, 256);
}

// ssd_bwd_dx: B_j (128 x ds) and X_j (128 x 64) a strip; a stage C_i
// (64 x ds) and dY_i (64 x 64), with a_i (64).
__host__ __device__ inline Plan dx_plan(int ds) {
  return make_plan((ds / 64 + 1) * kRowBox, 0, 0, (ds / 64 + 1) * kTileBox,
                   64);
}

// D (64 x 64, f32) = A (64 rows, K-major, 64-column boxes `abox` bytes
// apart) . B (64 rows, K-major, boxes 8 KB apart)^T over K = 16·nk.
__device__ __forceinline__ void mma_rows(float (&d)[32], const uint8_t* a,
                                         int abox, const uint8_t* b,
                                         int nk) {
  for (int kk = 0; kk < nk; ++kk) {
    const int col = 32 * (kk % 4);
    wgmma_ss_n64<0>(d, smem_desc(a + (kk / 4) * abox + col, 16, 1024),
                    smem_desc(b + (kk / 4) * kTileBox + col, 16, 1024),
                    kk > 0);
  }
}

// A work item of ssd_bwd_dg, strips longest first: (chunk, group, strip).
struct DgItem {
  int z, grp, strip, n_jt;
};

__device__ __forceinline__ DgItem dg_item(int item, int BC, int g, int Q) {
  const int ns = (Q + kRows - 1) / kRows;
  DgItem it;
  it.strip = ns - 1 - item / (BC * g);
  it.grp = item % (BC * g) / BC;
  it.z = item % BC;
  it.n_jt = min(2 * it.strip + 2, Q / kTile);
  return it;
}

// ---- 1. dG and d dacs's row part ----------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dg(const __grid_constant__ CUtensorMap tc_rows,
           const __grid_constant__ CUtensorMap tb_tile,
           const __grid_constant__ CUtensorMap tdy_rows,
           const __grid_constant__ CUtensorMap tx_tile,
           const float* __restrict__ dt, const float* __restrict__ dacs,
           float* __restrict__ ddacs, float* __restrict__ dg, int BC, int Q,
           int nh, int g, int ds) {
  extern __shared__ uint8_t smem_raw[];
  const Plan P = dg_plan(ds);
  uint8_t* base = align_1024(smem_raw);
  float* cols = reinterpret_cast<float*>(base + P.cols);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P.bars);
  uint64_t* row_full = bars;             // [nrow]
  uint64_t* row_empty = bars + 2;        // [nrow]
  uint64_t* b_full = bars + 4;           // [2]
  uint64_t* b_empty = bars + 6;          // [2]
  uint64_t* full = bars + 8;             // [stages]
  uint64_t* empty = bars + 12;           // [stages]
  const int hpg = nh / g;
  const int n_items = BC * g * ((Q + kRows - 1) / kRows);
  const int kst = P.stages;
  if (threadIdx.x == 0) {
    for (int r = 0; r < 2; ++r) {
      mbar_init(&row_full[r], 1);
      mbar_init(&row_empty[r], kConsumerWarps);
      mbar_init(&b_full[r], 1);
      mbar_init(&b_empty[r], kConsumerWarps);
    }
    for (int s = 0; s < kst; ++s) {
      mbar_init(&full[s], 1 + 32);       // TMA and the decays' warp
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer warpgroup
    regs_dealloc<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {                       // TMA
      int step = 0, jstep = 0, n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const DgItem it = dg_item(item, BC, g, Q);
        const int rb = n % P.nrow;
        if (n >= P.nrow) mbar_wait(&row_empty[rb], ((n / P.nrow) + 1) & 1);
        mbar_expect_tx(&row_full[rb], P.row);
        for (int c = 0; c < ds / 64; ++c)
          tma_load_4d(base + rb * P.row + c * kRowBox, &tc_rows,
                      &row_full[rb], 64 * c, it.grp, it.strip * kRows, it.z);
        for (int jt = 0; jt < it.n_jt; ++jt, ++jstep) {
          const int bb = jstep % 2;
          if (jstep >= 2) mbar_wait(&b_empty[bb], ((jstep / 2) + 1) & 1);
          mbar_expect_tx(&b_full[bb], P.tile);
          for (int c = 0; c < ds / 64; ++c)
            tma_load_4d(base + P.tiles + bb * P.tile + c * kTileBox,
                        &tb_tile, &b_full[bb], 64 * c, it.grp, jt * kTile,
                        it.z);
          for (int hh = 0; hh < hpg; ++hh, ++step) {
            const int s = step % kst;
            const int h = it.grp * hpg + hh;
            if (step >= kst) mbar_wait(&empty[s], ((step / kst) + 1) & 1);
            uint8_t* st = base + P.stage0 + s * P.stage;
            mbar_expect_tx(&full[s], P.stage);
            tma_load_4d(st, &tdy_rows, &full[s], 0, h, it.strip * kRows,
                        it.z);
            tma_load_4d(st + kRowBox, &tx_tile, &full[s], 0, h, jt * kTile,
                        it.z);
          }
        }
      }
    } else if (pt >= 32 && pt < 64) {    // a warp: each step's decays
      const int lane = pt - 32;
      int step = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const DgItem it = dg_item(item, BC, g, Q);
        const long long zq = static_cast<long long>(it.z) * Q;
        for (int jt = 0; jt < it.n_jt; ++jt) {
          for (int hh = 0; hh < hpg; ++hh, ++step) {
            const int s = step % kst;
            const int h = it.grp * hpg + hh;
            if (step >= kst) mbar_wait(&empty[s], ((step / kst) + 1) & 1);
            float* cd = cols + s * 256;   // a_i [128], a_j [64], dt_j [64]
#pragma unroll
            for (int e = lane; e < 256; e += 32) {
              const int r = e < 128 ? it.strip * kRows + e
                                    : jt * kTile + (e - 128) % 64;
              float v = 0.f;
              if (r < Q) {
                const long long at = (zq + r) * nh + h;
                v = e < 192 ? dacs[at] * kLog2e : dt[at];
              }
              cd[e] = v;
            }
            mbar_arrive(&full[s]);        // releases this lane's stores
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows i0 + 64·wg of each strip
  regs_alloc<232>();
  const int t = threadIdx.x % 128;
  const int rloc = wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and + 8
  int step = 0, jstep = 0, n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const DgItem it = dg_item(item, BC, g, Q);
    const int rb = n % P.nrow;
    const int i0 = it.strip * kRows;
    const int row = i0 + rloc;
    // Q is a multiple of 64: a warpgroup's rows lie all below Q or all past
    const bool live = i0 + 64 * wg < Q;
    const uint8_t* ca = base + rb * P.row + wg * 64 * 128;
    float* dgz = dg + (static_cast<long long>(it.z) * g + it.grp) * Q * Q;
    mbar_wait(&row_full[rb], (n / P.nrow) & 1);
    for (int jt = 0; jt < it.n_jt; ++jt, ++jstep) {
      const int bb = jstep % 2;
      const int j0 = jt * kTile;
      // the warpgroup's rows reach the tile; it crosses their diagonal
      const bool on = live && j0 <= i0 + 64 * wg + 63;
      const bool diag = j0 + 63 > i0 + 64 * wg;
      float sacc[32], dga[32];
      mbar_wait(&b_full[bb], (jstep / 2) & 1);
      if (on) {
        fence_regs(sacc);
        wgmma_fence();
        mma_rows(sacc, ca, kRowBox, base + P.tiles + bb * P.tile, ds / 16);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
      }
      if (t % 32 == 0) mbar_arrive(&b_empty[bb]);   // B_j is read
#pragma unroll
      for (int k = 0; k < 32; ++k) dga[k] = 0.f;
      for (int hh = 0; hh < hpg; ++hh, ++step) {
        const int s = step % kst;
        mbar_wait(&full[s], (step / kst) & 1);
        if (on) {
          const uint8_t* st = base + P.stage0 + s * P.stage;
          float dm[32];
          fence_regs(dm);
          wgmma_fence();
          mma_rows(dm, st + wg * 64 * 128, kRowBox, st + kRowBox, kHd / 16);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dm);
          const float* cd = cols + s * 256;
          const float ai[2] = {cd[rloc], cd[rloc + 8]};
          float w[2] = {0.f, 0.f};
#pragma unroll
          for (int k = 0; k < 32; k += 2) {
            const int e = (k / 2) % 2;
            const int r = row + 8 * e;
            const int c = 8 * (k / 4) + 2 * (t % 4);
            const float2 aj = *reinterpret_cast<const float2*>(cd + 128 + c);
            const float2 dj = *reinterpret_cast<const float2*>(cd + 192 + c);
            float l0 = ex2_sfu(ai[e] - aj.x), l1 = ex2_sfu(ai[e] - aj.y);
            if (diag) {
              if (j0 + c > r) l0 = 0.f;
              if (j0 + c + 1 > r) l1 = 0.f;
            }
            const float t0 = dm[k] * l0 * dj.x, t1 = dm[k + 1] * l1 * dj.y;
            dga[k] += t0;
            dga[k + 1] += t1;
            w[e] = fmaf(t0, sacc[k], w[e]);
            w[e] = fmaf(t1, sacc[k + 1], w[e]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            w[e] += __shfl_xor_sync(kAll, w[e], 1);
            w[e] += __shfl_xor_sync(kAll, w[e], 2);
          }
          if (t % 4 == 0) {
            const int h = it.grp * hpg + hh;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* at = ddacs + (static_cast<long long>(it.z) * Q + row
                                   + 8 * e) * nh + h;
              *at = jt == 0 ? w[e] : *at + w[e];
            }
          }
        }
        if (t % 32 == 0) mbar_arrive(&empty[s]);
      }
      if (on) {
#pragma unroll
        for (int k = 0; k < 32; k += 2) {
          const int r = row + 8 * ((k / 2) % 2);
          const int c = j0 + 8 * (k / 4) + 2 * (t % 4);
          *reinterpret_cast<float2*>(dgz + static_cast<long long>(r) * Q
                                     + c) = make_float2(dga[k], dga[k + 1]);
        }
      }
    }
    if (t % 32 == 0) mbar_arrive(&row_empty[rb]);   // C_i is read
  }
}

// ---- 2. dX, d dt and d dacs ---------------------------------------------
// A work item of ssd_bwd_dx, strips longest first: (chunk, strip, head).
struct DxItem {
  int z, strip, h;
};

__device__ __forceinline__ DxItem dx_item(int item, int BC, int nh) {
  DxItem it;
  it.strip = item / (BC * nh);
  it.h = item % (BC * nh) / BC;
  it.z = item % BC;
  return it;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dx(const __grid_constant__ CUtensorMap tb_rows,
           const __grid_constant__ CUtensorMap tx_rows,
           const __grid_constant__ CUtensorMap tc_tile,
           const __grid_constant__ CUtensorMap tdy_tile,
           const float* __restrict__ dt, const float* __restrict__ dacs,
           __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
           float* __restrict__ ddacs, int BC, int Q, int nh, int g, int ds) {
  extern __shared__ uint8_t smem_raw[];
  const Plan P = dx_plan(ds);
  uint8_t* base = align_1024(smem_raw);
  float* cols = reinterpret_cast<float*>(base + P.cols);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + P.bars);
  uint64_t* row_full = bars;             // [nrow]
  uint64_t* row_empty = bars + 2;        // [nrow]
  uint64_t* full = bars + 8;             // [stages]
  uint64_t* empty = bars + 12;           // [stages]
  const int hpg = nh / g;
  const int n_it = Q / kTile;
  const int n_items = BC * nh * ((Q + kRows - 1) / kRows);
  const int kst = P.stages;
  const int boxes = ds / 64;
  if (threadIdx.x == 0) {
    for (int r = 0; r < 2; ++r) {
      mbar_init(&row_full[r], 1);
      mbar_init(&row_empty[r], kConsumerWarps);
    }
    for (int s = 0; s < kst; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer warpgroup
    regs_dealloc<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {                       // TMA
      int step = 0, n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const DxItem it = dx_item(item, BC, nh);
        const int grp = it.h / hpg;
        const int rb = n % P.nrow;
        uint8_t* rd = base + rb * P.row;
        if (n >= P.nrow) mbar_wait(&row_empty[rb], ((n / P.nrow) + 1) & 1);
        mbar_expect_tx(&row_full[rb], P.row);
        for (int c = 0; c < boxes; ++c)
          tma_load_4d(rd + c * kRowBox, &tb_rows, &row_full[rb], 64 * c, grp,
                      it.strip * kRows, it.z);
        tma_load_4d(rd + boxes * kRowBox, &tx_rows, &row_full[rb], 0, it.h,
                    it.strip * kRows, it.z);
        for (int i = 2 * it.strip; i < n_it; ++i, ++step) {
          const int s = step % kst;
          if (step >= kst) mbar_wait(&empty[s], ((step / kst) + 1) & 1);
          uint8_t* st = base + P.stage0 + s * P.stage;
          mbar_expect_tx(&full[s], P.stage);
          for (int c = 0; c < boxes; ++c)
            tma_load_4d(st + c * kTileBox, &tc_tile, &full[s], 64 * c, grp,
                        i * kTile, it.z);
          tma_load_4d(st + boxes * kTileBox, &tdy_tile, &full[s], 0, it.h,
                      i * kTile, it.z);
        }
      }
    } else if (pt >= 32 && pt < 64) {    // a warp: each tile's a_i
      const int lane = pt - 32;
      int step = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const DxItem it = dx_item(item, BC, nh);
        for (int i = 2 * it.strip; i < n_it; ++i, ++step) {
          const int s = step % kst;
          if (step >= kst) mbar_wait(&empty[s], ((step / kst) + 1) & 1);
#pragma unroll
          for (int e = lane; e < kTile; e += 32)
            cols[s * kTile + e] =
                dacs[(static_cast<long long>(it.z) * Q + i * kTile + e) * nh
                     + it.h] * kLog2e;
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows j0 + 64·wg of each strip
  regs_alloc<232>();
  const int t = threadIdx.x % 128;
  int step = 0, n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const DxItem it = dx_item(item, BC, nh);
    const int rb = n % P.nrow;
    const int j0 = it.strip * kRows;
    const int jw = j0 + 64 * wg;         // the warpgroup's first row
    const int row = jw + 16 * (t / 32) + (t % 32) / 4;   // and + 8
    const bool live = jw < Q;
    float aj[2] = {0.f, 0.f}, dtj[2] = {0.f, 0.f};
    if (live) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long at =
            (static_cast<long long>(it.z) * Q + row + 8 * e) * nh + it.h;
        aj[e] = dacs[at] * kLog2e;
        dtj[e] = dt[at];
      }
    }
    float acc[32], dd[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.f;
    const uint8_t* ba = base + rb * P.row + wg * 64 * 128;
    const uint8_t* xa = ba + boxes * kRowBox;
    mbar_wait(&row_full[rb], (n / P.nrow) & 1);
    for (int i = 2 * it.strip; i < n_it; ++i, ++step) {
      const int s = step % kst;
      const int i0 = i * kTile;
      mbar_wait(&full[s], (step / kst) & 1);
      if (live && i0 + 63 >= jw) {       // some i >= some j of the rows
        const uint8_t* cs = base + P.stage0 + s * P.stage;
        const uint8_t* dys = cs + boxes * kTileBox;
        float st[32], dm[32];
        fence_regs(st);
        fence_regs(dm);
        wgmma_fence();
        mma_rows(st, ba, kRowBox, cs, ds / 16);          // S^T = B_j.C_i^T
        mma_rows(dm, xa, kRowBox, dys, kHd / 16);        // dM^T = X_j.dY_i^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dm);
        const float* ai = cols + s * kTile;
        const bool diag = i0 < jw + 64;  // some i < some j of the rows
        uint32_t pa[4][4];
#pragma unroll
        for (int k = 0; k < 32; k += 2) {
          const int e = (k / 2) % 2;
          const int r = row + 8 * e;
          const int c = 8 * (k / 4) + 2 * (t % 4);
          const float2 av = *reinterpret_cast<const float2*>(ai + c);
          float l0 = ex2_sfu(av.x - aj[e]), l1 = ex2_sfu(av.y - aj[e]);
          if (diag) {
            if (i0 + c < r) l0 = 0.f;
            if (i0 + c + 1 < r) l1 = 0.f;
          }
          const float s0 = st[k] * l0, s1 = st[k + 1] * l1;
          dd[e] = fmaf(dm[k], s0, dd[e]);
          dd[e] = fmaf(dm[k + 1], s1, dd[e]);
          pa[k / 8][(k % 8) / 2] = pack_bf16(s0 * dtj[e], s1 * dtj[e]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)         // dX += M^T.dY_i
          wgmma_rs_n64(acc, pa[kk], smem_desc(dys + 2048 * kk, kTileBox,
                                              1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (t % 32 == 0) mbar_arrive(&empty[s]);
    }
    if (t % 32 == 0) mbar_arrive(&row_empty[rb]);   // B_j and X_j are read
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dd[e] += __shfl_xor_sync(kAll, dd[e], 1);
      dd[e] += __shfl_xor_sync(kAll, dd[e], 2);
    }
    if (!live) continue;
    const long long x_row = static_cast<long long>(nh) * kHd;
    __nv_bfloat16* dxz = dx + static_cast<long long>(it.z) * Q * x_row
                         + static_cast<long long>(it.h) * kHd;
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int r = row + 8 * ((k / 2) % 2);
      const int c = 8 * (k / 4) + 2 * (t % 4);
      *reinterpret_cast<uint32_t*>(dxz + r * x_row + c) =
          pack_bf16(acc[k], acc[k + 1]);
    }
    if (t % 4 == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long at =
            (static_cast<long long>(it.z) * Q + row + 8 * e) * nh + it.h;
        ddt[at] = dd[e];
        ddacs[at] -= dtj[e] * dd[e];
      }
    }
  }
}

// ---- 3. dC and dB from dG -----------------------------------------------
// A block of 256 threads a (chunk z, group, 64-row tile rt, dC or dB,
// state columns 64·cc): thread (ty, tx) sums rows 4·ty and columns 4·tx
// (4 x 4) over the causal 64-tiles of the other index, the tile of dG
// (transposed for dC, so that both read a row of the tile) and of B or C
// (widened to f32) in shared memory.
__global__ void __launch_bounds__(256)
ssd_bwd_dbdc(const float* __restrict__ dg,
             const __nv_bfloat16* __restrict__ b,
             const __nv_bfloat16* __restrict__ c,
             __nv_bfloat16* __restrict__ db, __nv_bfloat16* __restrict__ dc,
             int BC, int Q, int g, int ds) {
  __shared__ float sa[kTile][kTile + 1];  // [k][out row]
  __shared__ __align__(16) float sb[kTile][kTile];   // [k][out column]
  const int n_t = Q / kTile, n_c = ds / 64;
  int id = blockIdx.x;
  const int cc = id % n_c;
  id /= n_c;
  const int rt = id % n_t;
  id /= n_t;
  const bool is_dc = id % 2 == 0;
  const int zg = id / 2, z = zg / g, grp = zg % g;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* dgz = dg + static_cast<long long>(zg) * Q * Q;
  const long long row_len = static_cast<long long>(g) * ds;
  const long long zbase = static_cast<long long>(z) * Q * row_len
                          + static_cast<long long>(grp) * ds + cc * 64;
  const __nv_bfloat16* op = is_dc ? b : c;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
  const int k_first = is_dc ? 0 : rt, k_end = is_dc ? rt + 1 : n_t;
  for (int kt = k_first; kt < k_end; ++kt) {
    __syncthreads();                     // the last tiles are consumed
    for (int e = tid; e < kTile * kTile; e += 256) {
      const int gr = e / kTile, gc = e % kTile;
      if (is_dc)   // dG rows i of tile rt, columns j of tile kt
        sa[gc][gr] = dgz[static_cast<long long>(rt * kTile + gr) * Q
                         + kt * kTile + gc];
      else         // dG rows i of tile kt, columns j of tile rt
        sa[gr][gc] = dgz[static_cast<long long>(kt * kTile + gr) * Q
                         + rt * kTile + gc];
      sb[gr][gc] = __bfloat162float(
          op[zbase + static_cast<long long>(kt * kTile + gr) * row_len + gc]);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      float a[4], v4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = sa[k][4 * ty + u];
      const float4 bv = *reinterpret_cast<const float4*>(&sb[k][4 * tx]);
      v4[0] = bv.x, v4[1] = bv.y, v4[2] = bv.z, v4[3] = bv.w;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], v4[v], acc[u][v]);
    }
  }
  __nv_bfloat16* out = is_dc ? dc : db;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    __nv_bfloat16* o = out + zbase
                       + static_cast<long long>(rt * kTile + 4 * ty + u)
                             * row_len + 4 * tx;
    *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[u][0], acc[u][1]);
    *reinterpret_cast<uint32_t*>(o + 2) = pack_bf16(acc[u][2], acc[u][3]);
  }
}

// A 4-D tensor map of a contiguous (BC, Q, heads, width) bf16 tensor,
// boxes of 64 columns by `rows` rows of one head or group.
int map4(CUtensorMap* map, const void* p, int width, int heads, int Q,
         int BC, int rows) {
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(Q),
                              static_cast<cuuint64_t>(BC)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(width) * 2,
      static_cast<cuuint64_t>(heads) * width * 2,
      static_cast<cuuint64_t>(Q) * heads * width * 2};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 4, dims,
                           strides, box);
}

}  // namespace

// (dx, ddt, ddacs, db, dc) of the bf16 intra-chunk SSD with hd 64: x, dy
// (BC, Q, nh, 64) and b, c (BC, Q, g, ds) bf16, dt, dacs (BC, Q, nh) f32,
// all contiguous, x/dy/b/c 16-byte aligned; Q a multiple of 64 up to
// 1,024, ds a multiple of 64 up to 256, nh % g == 0.  The gradients take
// their inputs' shapes and types; `dg` is an f32 scratch of BC x g x Q x
// Q (ssd_bwd_dg's dG).  Three launches on `stream`; returns the first
// failing launch's cudaError_t (0 on success), or hopper.cuh's codes when
// a tensor map cannot be encoded.
extern "C" int ssd_intra_bwd_bf16(const void* x, const float* dt,
                                  const float* dacs, const void* b,
                                  const void* c, const void* dy, void* dx,
                                  float* ddt, float* ddacs, void* db,
                                  void* dc, float* dg, int BC, int Q, int nh,
                                  int hd, int g, int ds, int device,
                                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (BC < 1 || hd != kHd || Q < 64 || Q % 64 || Q > 1024 || ds < 64
      || ds % 64 || ds > 256 || g < 1 || nh % g
      || static_cast<long long>(BC) * nh * ((Q + kRows - 1) / kRows)
             > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap c_rows, b_tile, dy_rows, x_tile, b_rows, x_rows, c_tile,
      dy_tile;
  int err = map4(&c_rows, c, ds, g, Q, BC, kRows);
  if (!err) err = map4(&b_tile, b, ds, g, Q, BC, kTile);
  if (!err) err = map4(&dy_rows, dy, kHd, nh, Q, BC, kRows);
  if (!err) err = map4(&x_tile, x, kHd, nh, Q, BC, kTile);
  if (!err) err = map4(&b_rows, b, ds, g, Q, BC, kRows);
  if (!err) err = map4(&x_rows, x, kHd, nh, Q, BC, kRows);
  if (!err) err = map4(&c_tile, c, ds, g, Q, BC, kTile);
  if (!err) err = map4(&dy_tile, dy, kHd, nh, Q, BC, kTile);
  if (err) return err;
  const Plan pg = dg_plan(ds), px = dx_plan(ds);
  if (pg.bytes > kSmemMax || px.bytes > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sms = 0;
  e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_dg,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pg.bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_dx,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             px.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ns = (Q + kRows - 1) / kRows;
  const int dg_items = BC * g * ns, dx_items = BC * nh * ns;
  ssd_bwd_dg<<<dg_items < n_sms ? dg_items : n_sms, kThreads, pg.bytes, s>>>(
      c_rows, b_tile, dy_rows, x_tile, dt, dacs, ddacs, dg, BC, Q, nh, g, ds);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dx<<<dx_items < n_sms ? dx_items : n_sms, kThreads, px.bytes, s>>>(
      b_rows, x_rows, c_tile, dy_tile, dt, dacs,
      static_cast<__nv_bfloat16*>(dx), ddt, ddacs, BC, Q, nh, g, ds);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_bwd_dbdc<<<BC * g * 2 * (Q / kTile) * (ds / 64), 256, 0, s>>>(
      dg, static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<__nv_bfloat16*>(db),
      static_cast<__nv_bfloat16*>(dc), BC, Q, g, ds);
  return static_cast<int>(cudaGetLastError());
}
