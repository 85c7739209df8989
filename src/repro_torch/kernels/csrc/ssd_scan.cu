// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan.py::_ssd_kernel.
// Same function, per (batch-chunk z, head h) of x (BC, Q, nh, hd),
// dt/dacs (BC, Q, nh) f32 and b/c (BC, Q, g, ds), head h reading group
// h / (nh / g):
//
//     M[i, j] = (C_i . B_j) * exp(dacs_i - dacs_j) * dt_j   for i >= j
//     M[i, j] = 0                                           for i <  j
//     Y[i, :] = sum_j round(M[i, j]) * X[j, :]
//
// with the products of C.B and M.X summed in f32, M rounded to x's type
// before the second product (as the TPU kernel's m.astype(x.dtype)),
// and Y cast once to x's type.  Above the diagonal the TPU kernel takes
// exp(-1e30) = 0; these kernels write the 0 without computing it.  The
// exp is taken of the difference, per element: dacs falls to about -400
// in a chunk, so exp(dacs_i) * exp(-dacs_j) would overflow.
//
// Two kernels, chosen by the wrapper by dtype and shape:
//
//   * bf16 with hd 64 or 128, ds a multiple of 64 up to 256 and Q a
//     multiple of 64 up to 1,024 (ssd_bf16_wgmma): the work items are
//     (chunk z, a strip of 128 rows i, a block of HB heads of one group),
//     and a persistent grid of one block an SM walks them in turn.  A
//     block has two consumer warpgroups (64 rows each) and a producer
//     warpgroup: three warps write each item's column data (dacs_j, dt_j
//     of its heads) to shared memory, one thread loads the strip's C
//     once and, per 128-column tile j at or below the strip's diagonal,
//     the tile of B and each head's 128-row tile of X, by TMA into
//     mbarrier rings (tiles wholly above the diagonal are never loaded),
//     the next item's while this one's products run.  The consumers compute
//     S = C.B^T once a tile on the tensor cores (m64n128k16, K = ds,
//     f32), and then for each head of the block, on the accumulator
//     registers, M = S * exp(dacs_i - dacs_j) * dt_j (0 above the
//     diagonal), round it to bf16 into the A operand of Y_h += M.X_h
//     (m64nHDk16, X read in place MN-major through the transpose bit),
//     one head's M computed while the tensor cores add the previous
//     head's product.  C.B^T is so computed once per head block instead
//     of once per head: at mamba2-780m (g = 1) the TPU kernel repeats it
//     for each of the 48.
//     HB: 2 at hd 64 where nh / g is even, else 1 (registers, of the
//     232 a consumer thread takes by setmaxnreg from the producer
//     warpgroup: S takes 64, each head's Y 32 at hd 64 and 64 at hd 128,
//     M's two A-operand buffers 64).  Stages:
//     2 where C, two stages of (B, HB X tiles) and the column data fit
//     227 KB, else 1; C and column data double-buffered where they fit
//     (mamba2-780m: 2 stages, 2 buffers, 201 KB; ds 256: 1 stage).
//   * everything else (f32; bf16 at other shapes, hd <= 128, ds <= 256)
//     (ssd_cb_kernel, ssd_intra_kernel): register-tiled on the SM's f32
//     cores (f32 stays true f32), in two passes.  The first computes
//     S = C.B^T once a (chunk, group) for every 64 x 64 tile at or below
//     the diagonal into an f32 scratch, 4 x 4 values a thread.  In the
//     second a block of 256 threads owns a work item (chunk z, a strip of
//     64 rows i, a block of up to 16 heads of one group up to hd 32, else
//     4) and walks the tiles j <= i: each quarter of the block takes a
//     quarter of the heads, forms each one's M for its own rows from the
//     tile's S and adds M.X_h to that head's Y, 8 x 8 values a thread in
//     registers, so that each 16-byte load of M or X feeds 16 FMAs.  Column
//     tiles wholly above the strip's diagonal are skipped; X tiles arrive
//     by cp.async three steps ahead of their product.
//
// Where the TPU kernel takes B and C broadcast to one copy a head, both
// kernels read each head's group in place (g = nh is the TPU layout).
//
// Bound: bytes.  At mamba2-780m width (BC = 16 chunks of Q = 256,
// nh = 48, hd = 64, g = 1, ds = 128, bf16) the inputs and output are
// ~54 MB: 0.016 ms at 3.35 TB/s.  The tensor work is ~4.8 GFLOP of C.B^T
// a head block and ~4.8 GFLOP of M.X over whole 128 x 128 tiles (0.010
// ms at 989 TFLOP/s bf16), and 25 M exps over the causal pairs.  In f32
// the bound is operations: C.B^T once a (chunk, group) over the causal
// pairs (0.135 GFLOP) and M and M.X a head (3.335 GFLOP), 0.0518 ms at 67
// TFLOP/s, against 106 MB (0.032 ms).

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxHd = 128;

// ---- bf16, hd 64 or 128: TMA + wgmma ---------------------------------
constexpr int kTcRows = 128;            // rows of a strip, columns of a tile
constexpr int kTcThreads = 384;         // 2 consumer warpgroups + producer
constexpr int kColThreads = 96;         // producer threads on column data
constexpr int kBoxBytes = kTcRows * 128;   // one 64-column box of 128 rows
constexpr int kSmemMax = 232448;        // a block's shared memory (227 KB)
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx, |rel err| < 2^-22; results under 2^-126
// flush to 0, far below what M's bf16 rounding keeps).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the A operand of an in-flight wgmma in its registers (their
// values live and unmoved) until the wait this follows.
__device__ __forceinline__ void hold_regs(uint32_t (&a)[kTcRows / 16][4]) {
#pragma unroll
  for (int k = 0; k < kTcRows / 16; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[k][q])::"memory");
}

// One head's M = S * 2^(a_i - a_j) * dt_j (a = dacs·log2 e) for the
// 64 x 128 accumulator tile S of this thread's rows (row, row + 8),
// rounded to bf16 pairs in the A-operand layout of the M.X product; on
// the diagonal tile (DIAG) 0 where j > i.  ci: the tile's column data.
template <bool DIAG>
__device__ __forceinline__ void make_m(uint32_t (&pa)[kTcRows / 16][4],
                                       const float (&sacc)[kTcRows / 2],
                                       const float2* ci, float a0, float a1,
                                       int t, int row, int j0) {
#pragma unroll
  for (int i = 0; i < kTcRows / 2; i += 2) {
    const int e = (i / 2) % 2, r = row + 8 * e;
    const float ai = e ? a1 : a0;
    const int jl = 8 * (i / 4) + 2 * (t % 4);
    const float4 cj = *reinterpret_cast<const float4*>(ci + jl);
    float m0 = sacc[i] * exp2_ftz(ai - cj.x) * cj.y;
    float m1 = sacc[i + 1] * exp2_ftz(ai - cj.z) * cj.w;
    if (DIAG) {
      if (j0 + jl > r) m0 = 0.f;
      if (j0 + jl + 1 > r) m1 = 0.f;
    }
    pa[i / 8][(i % 8) / 2] = pack_bf16(m0, m1);
  }
}

// Byte offsets of the tensor-core kernel's shared memory from its
// 1024-aligned base: `nc` buffers of C (128 x ds), `stages` stages of
// (B 128 x ds, HB X tiles 128 x HD), `nc` buffers of each head's column
// data (float2 {dacs_j·log2 e, dt_j} for j < Q rounded up to whole tiles,
// 0 past Q), then barriers.  The largest of (nc, stages) = (2, 2),
// (1, 2), (2, 1), (1, 1) that fits 227 KB.
struct TcSmem {
  int nc, stages, stage, colinfo, ystage, bars, bytes;
};

// A consumer warp's 16 rows of one head's Y, bf16, rows padded by 16
// bytes so that both the fragment writes and the row reads are free of
// bank conflicts.
template <int HD>
__host__ __device__ constexpr int ystage_row_bytes() { return HD * 2 + 16; }

template <int HD, int HB>
__host__ __device__ inline TcSmem tc_smem(int ds, int Q) {
  TcSmem s;
  const int c_bytes = kTcRows * ds * 2;
  const int q_pad = (Q + kTcRows - 1) / kTcRows * kTcRows;
  s.stage = kTcRows * ds * 2 + HB * kTcRows * HD * 2;
  for (int pick = 0; pick < 4; ++pick) {
    s.nc = pick % 2 ? 1 : 2;
    s.stages = pick < 2 ? 2 : 1;
    s.colinfo = s.nc * c_bytes + s.stages * s.stage;
    s.ystage = s.colinfo + s.nc * HB * q_pad * 8;
    s.bars = s.ystage + 8 * 16 * ystage_row_bytes<HD>();
    s.bytes = 1024 + s.bars + 12 * 8;
    if (s.bytes <= kSmemMax) break;
  }
  return s;
}

// One work item: (chunk z, strip of 128 rows, block of HB heads); items
// are numbered longest strips first.
struct TcItem {
  int z, strip, h0, grp;
};

__device__ __forceinline__ TcItem tc_item(int item, int BC, int n_strips,
                                          int HB, int nh, int g) {
  const int per_strip = BC * (nh / HB);
  const int rest = item % per_strip;
  TcItem it;
  it.strip = n_strips - 1 - item / per_strip;
  it.h0 = rest / BC * HB;
  it.z = rest % BC;
  it.grp = it.h0 / (nh / g);
  return it;
}

// A persistent grid of one block an SM walks the work items in turn, so
// that the next item's loads run under this one's products.  Per block:
// 2 consumer warpgroups (64 rows each; one idles on a strip with 64 rows
// below Q) and a producer warpgroup: one thread loads each item's C, then
// its B and X tiles, by TMA, through rings of `nc` C buffers and `stages`
// (B, X) stages, while three warps write its column data, so that those
// scattered, latency-bound loads run beside the TMA loads, not before
// them.  Each consumer warp writes its rows of Y through 16 rows of
// shared memory, so that stores write whole 16-byte pieces of rows, not
// the fragments' 4-byte pieces of 8 rows a store.  4-D tensor maps (64-column,
// 128-row boxes): x (hd, nh, Q, BC), b and c (ds, g, Q, BC), so a box past
// Q is zero-filled, never read from the next chunk.
template <int HD, int HB>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_bf16_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc,
               const float* __restrict__ dt, const float* __restrict__ dacs,
               __nv_bfloat16* __restrict__ y, int BC, int Q, int nh, int g,
               int ds) {
  extern __shared__ uint8_t smem_raw[];
  const TcSmem L = tc_smem<HD, HB>(ds, Q);
  const int c_bytes = kTcRows * ds * 2;
  uint8_t* sc = align_1024(smem_raw);    // [nc] C
  uint8_t* stage0 = sc + L.nc * c_bytes;
  float2* colinfo = reinterpret_cast<float2*>(sc + L.colinfo);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sc + L.bars);
  uint64_t* c_full = bars;               // [nc]: C and column data
  uint64_t* c_empty = bars + 2;          // [nc]
  uint64_t* b_full = bars + 4;           // [stages]
  uint64_t* x_full = bars + 6;           // [stages]
  uint64_t* empty = bars + 8;            // [stages]

  const int n_strips = (Q + kTcRows - 1) / kTcRows;
  const int q_pad = n_strips * kTcRows;
  const int n_items = n_strips * BC * (nh / HB);
  if (threadIdx.x == 0) {
    for (int b = 0; b < L.nc; ++b) {
      mbar_init(&c_full[b], 1 + kColThreads);  // TMA and column data
      mbar_init(&c_empty[b], 2);         // one arrive a consumer
    }
    for (int b = 0; b < L.stages; ++b) {
      mbar_init(&b_full[b], 1);
      mbar_init(&x_full[b], 1);
      mbar_init(&empty[b], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer warpgroup
    regs_dealloc<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {                       // TMA: each item's C, B and X
      int step = 0, n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const TcItem it = tc_item(item, BC, n_strips, HB, nh, g);
        const int cb = n % L.nc;
        if (n >= L.nc) mbar_wait(&c_empty[cb], ((n / L.nc) + 1) & 1);
        mbar_expect_tx(&c_full[cb], c_bytes);
        for (int c = 0; c < ds / 64; ++c)
          tma_load_4d(sc + cb * c_bytes + c * kBoxBytes, &tc, &c_full[cb],
                      64 * c, it.grp, it.strip * kTcRows, it.z);
        for (int jt = 0; jt <= it.strip; ++jt, ++step) {
          const int s = step % L.stages;
          if (step >= L.stages)
            mbar_wait(&empty[s], ((step / L.stages) + 1) & 1);
          uint8_t* sb = stage0 + s * L.stage;
          uint8_t* sx = sb + c_bytes;
          mbar_expect_tx(&b_full[s], c_bytes);
          for (int c = 0; c < ds / 64; ++c)
            tma_load_4d(sb + c * kBoxBytes, &tb, &b_full[s], 64 * c, it.grp,
                        jt * kTcRows, it.z);
          mbar_expect_tx(&x_full[s], HB * kTcRows * HD * 2);
#pragma unroll
          for (int hh = 0; hh < HB; ++hh)
#pragma unroll
            for (int c = 0; c < HD / 64; ++c)
              tma_load_4d(sx + (hh * (HD / 64) + c) * kBoxBytes, &tx,
                          &x_full[s], 64 * c, it.h0 + hh, jt * kTcRows,
                          it.z);
        }
      }
    } else if (pt >= 32) {               // 3 warps: each item's column data
      const int ct = pt - 32;
      int n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const TcItem it = tc_item(item, BC, n_strips, HB, nh, g);
        const int cb = n % L.nc;
        if (n >= L.nc) mbar_wait(&c_empty[cb], ((n / L.nc) + 1) & 1);
        float2* ci = colinfo + cb * HB * q_pad;
#pragma unroll 4
        for (int e = ct; e < HB * q_pad; e += kColThreads) {
          const int j = e / HB, hh = e % HB;
          float2 v = make_float2(0.f, 0.f);
          if (j < Q) {
            const long long at =
                (static_cast<long long>(it.z) * Q + j) * nh + it.h0 + hh;
            v = make_float2(dacs[at] * kLog2e, dt[at]);
          }
          ci[hh * q_pad + j] = v;
        }
        mbar_arrive(&c_full[cb]);        // releases this thread's stores
      }
    }
    return;
  }

  // consumers
  regs_alloc<232>();
  const int t = threadIdx.x % 128;
  int step = 0, n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const TcItem it = tc_item(item, BC, n_strips, HB, nh, g);
    const int i0 = it.strip * kTcRows;
    const int cb = n % L.nc;
    mbar_wait(&c_full[cb], (n / L.nc) & 1);
    if (Q - i0 <= 64 * wg) {             // no rows of this warpgroup below Q
      for (int jt = 0; jt <= it.strip; ++jt, ++step) {
        const int s = step % L.stages;
        mbar_wait(&b_full[s], (step / L.stages) & 1);
        mbar_wait(&x_full[s], (step / L.stages) & 1);
        if (t == 0) mbar_arrive(&empty[s]);
      }
      if (t == 0) mbar_arrive(&c_empty[cb]);
      continue;
    }
    const int row = i0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and +8
    const float2* ci = colinfo + cb * HB * q_pad;
    float yacc[HB][HD / 2];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) yacc[hh][i] = 0.f;
    const uint8_t* ca = sc + cb * c_bytes + wg * 64 * 128;

    for (int jt = 0; jt <= it.strip; ++jt, ++step) {
      const int s = step % L.stages;
      const uint32_t ph = (step / L.stages) & 1;
      const uint8_t* sb = stage0 + s * L.stage;
      const uint8_t* sx = sb + c_bytes;
      const int j0 = jt * kTcRows;
      float sacc[kTcRows / 2];
      mbar_wait(&b_full[s], ph);
      fence_regs(sacc);
      wgmma_fence();
      for (int kk = 0; kk < ds / 16; ++kk) {
        const int off = (kk / 4) * kBoxBytes + 32 * (kk % 4);
        wgmma_ss_n128<0>(sacc, smem_desc(ca + off, 16, 1024),
                         smem_desc(sb + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // per head: M on the CUDA cores into one of two A-operand buffers
      // while the tensor cores add the previous head's M.X
      const bool diag = jt == it.strip;  // only it reaches above i = j
      mbar_wait(&x_full[s], ph);
      uint32_t pa[2][kTcRows / 16][4];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        const float2* ch = ci + hh * q_pad;
        const float a0 = ch[row].x, a1 = ch[row + 8].x;
        if (diag) make_m<true>(pa[hh % 2], sacc, ch + j0, a0, a1, t, row, j0);
        else make_m<false>(pa[hh % 2], sacc, ch + j0, a0, a1, t, row, j0);
        fence_regs(yacc[hh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTcRows / 16; ++kk) {
          const uint64_t dx = smem_desc(
              sx + hh * (HD / 64) * kBoxBytes + 2048 * kk, kBoxBytes, 1024);
          if constexpr (HD == 128) wgmma_rs_n128(yacc[hh], pa[hh % 2][kk], dx);
          else wgmma_rs_n64(yacc[hh], pa[hh % 2][kk], dx);
        }
        wgmma_commit();
        if (hh > 0) {                    // head hh - 1's product is done
          wgmma_wait<1>();
          hold_regs(pa[(hh - 1) % 2]);
        }
      }
      wgmma_wait<0>();
      hold_regs(pa[(HB - 1) % 2]);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) fence_regs(yacc[hh]);
      if (t == 0) mbar_arrive(&empty[s]);
    }
    if (t == 0) mbar_arrive(&c_empty[cb]);  // C and column data are read

    // Y through this warp's 16 rows of shared memory, so that each
    // store writes whole 16-byte pieces of rows (all rows lie below Q)
    constexpr int kRowB = ystage_row_bytes<HD>();
    uint8_t* ys = sc + L.ystage + (threadIdx.x / 32) * 16 * kRowB;
    const int lane = t % 32;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
#pragma unroll
      for (int i = 0; i < HD / 2; i += 2) {
        const int rr = lane / 4 + 8 * ((i / 2) % 2);
        const int d = 8 * (i / 4) + 2 * (t % 4);
        *reinterpret_cast<uint32_t*>(ys + rr * kRowB + 2 * d) =
            pack_bf16(yacc[hh][i], yacc[hh][i + 1]);
      }
      __syncwarp();
      const int r0 = i0 + wg * 64 + 16 * ((t / 32) % 4);
#pragma unroll
      for (int k = 0; k < 16 * HD / 8 / 32; ++k) {   // 16-byte pieces a lane
        const int piece = k * 32 + lane;
        const int rr = piece / (HD / 8), cpos = piece % (HD / 8);
        const uint4 v = *reinterpret_cast<const uint4*>(ys + rr * kRowB
                                                        + 16 * cpos);
        *reinterpret_cast<uint4*>(
            y + ((static_cast<long long>(it.z) * Q + r0 + rr) * nh + it.h0
                 + hh) * HD + 8 * cpos) = v;
      }
      __syncwarp();
    }
  }
}

template <int HD, int HB>
int launch_tc(const void* x, const float* dt, const float* dacs,
              const void* b, const void* c, void* y, int BC, int Q, int nh,
              int g, int ds, int device, cudaStream_t stream) {
  // contiguous (BC, Q, heads or groups, width): dims innermost first,
  // byte strides
  CUtensorMap tx, tb, tc;
  const cuuint32_t box[4] = {64, 1, kTcRows, 1};
  const cuuint64_t dx[4] = {HD, static_cast<cuuint64_t>(nh),
                            static_cast<cuuint64_t>(Q),
                            static_cast<cuuint64_t>(BC)};
  const cuuint64_t sx[3] = {HD * 2, static_cast<cuuint64_t>(nh) * HD * 2,
                            static_cast<cuuint64_t>(Q) * nh * HD * 2};
  const cuuint64_t dbc[4] = {static_cast<cuuint64_t>(ds),
                             static_cast<cuuint64_t>(g),
                             static_cast<cuuint64_t>(Q),
                             static_cast<cuuint64_t>(BC)};
  const cuuint64_t sbc[3] = {static_cast<cuuint64_t>(ds) * 2,
                             static_cast<cuuint64_t>(g) * ds * 2,
                             static_cast<cuuint64_t>(Q) * g * ds * 2};
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_tensor_map(&tx, bf16, x, 4, dx, sx, box);
  if (!err) err = encode_tensor_map(&tb, bf16, b, 4, dbc, sbc, box);
  if (!err) err = encode_tensor_map(&tc, bf16, c, 4, dbc, sbc, box);
  if (err) return err;
  const TcSmem L = tc_smem<HD, HB>(ds, Q);
  if (L.bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int n_sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &n_sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ssd_bf16_wgmma<HD, HB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_items =
      static_cast<long long>((Q + kTcRows - 1) / kTcRows) * BC * (nh / HB);
  const int grid = static_cast<int>(n_items < n_sms ? n_items : n_sms);
  ssd_bf16_wgmma<HD, HB><<<grid, kTcThreads, L.bytes, stream>>>(
      tx, tb, tc, dt, dacs, static_cast<__nv_bfloat16*>(y), BC, Q, nh, g,
      ds);
  return static_cast<int>(cudaGetLastError());
}

// ---- everything else: the register-tiled SIMT kernels ----------------
constexpr int kSimtRows = 64;     // rows i of a strip, columns j of a tile
constexpr int kSimtThreads = 256; // 4 quarters of 64 threads
constexpr int kSimtDs = 128;      // state columns of a C or B chunk
constexpr int kHalf = kSimtRows / 2;   // columns j of an M·X step
constexpr int kLs = kSimtRows + 4;     // a row of S in shared memory, f32
constexpr int kLh = kHalf + 4;         // a row of an M half, f32
constexpr int kTile = kSimtRows * kSimtRows;   // floats of an S tile

// (strip s, tile t <= s) of pair p = s (s + 1) / 2 + t
__device__ __forceinline__ int2 tile_pair(int p) {
  int s = 0;
  while ((s + 1) * (s + 2) / 2 <= p) ++s;
  return make_int2(s, p - s * (s + 1) / 2);
}

// Pass 1: S = C·Bᵀ of one (chunk z, group, strip s, tile t <= s), once
// for all the group's heads, into its 64 x 64 f32 tile of the scratch
// `cb` ((group, chunk, pair) order).  Thread (rg, cg) computes rows
// rg + 16i and columns cg + 16j (4 x 4) over the state in chunks of 128,
// C and B rows in shared memory padded by 16 bytes (so that the rows a
// warp reads at one column lie in distinct banks), read as 4-wide
// vectors along the state.
template <typename T>
__global__ void __launch_bounds__(kSimtThreads)
ssd_cb_kernel(const T* __restrict__ b, const T* __restrict__ c,
              float* __restrict__ cb, int BC, int Q, int g, int ds,
              int vec) {
  constexpr int kLd = kSimtDs + 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) uint8_t cb_raw[];
  T* Cs = reinterpret_cast<T*>(cb_raw);                     // [64][kLd]
  T* Bs = Cs + kSimtRows * kLd;                             // [64][kLd]
  const int n_strips = (Q + kSimtRows - 1) / kSimtRows;
  const int n_pairs = n_strips * (n_strips + 1) / 2;
  const int zg = blockIdx.x / n_pairs;
  const int z = zg % BC, grp = zg / BC;
  const int2 st = tile_pair(blockIdx.x % n_pairs);
  const int i0 = st.x * kSimtRows, j0 = st.y * kSimtRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = (warp / 2) * 4 + lane / 8, cg = (warp % 2) * 8 + lane % 8;
  const long long stride = static_cast<long long>(g) * ds;
  const long long base = static_cast<long long>(z) * Q * stride
                         + static_cast<long long>(grp) * ds;

  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
  for (int ch = 0; ch * kSimtDs < ds; ++ch) {
    if (ch > 0) __syncthreads();         // the last chunk is consumed
    const int w = min(kSimtDs, ds - ch * kSimtDs), w4 = (w + 3) / 4 * 4;
    load_rows(Cs, kLd, c + base + i0 * stride + ch * kSimtDs, stride,
              kSimtRows, Q - i0, w, vec, tid, kSimtThreads);
    load_rows(Bs, kLd, b + base + j0 * stride + ch * kSimtDs, stride,
              kSimtRows, Q - j0, w, vec, tid, kSimtThreads);
    // the state columns past ds, up to a multiple of 4: zeros
    for (int e = tid; e < 2 * kSimtRows * (w4 - w); e += kSimtThreads)
      Cs[e / (w4 - w) * kLd + w + e % (w4 - w)] = T(0.f);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();                     // the chunk landed
#pragma unroll 2
    for (int d = 0; d < w4; d += 4) {
      float br[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ld_vec(br[jj], Bs + (cg + 16 * jj) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cr[4];
        ld_vec(cr, Cs + (rg + 16 * i) * kLd + d);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s[i][jj] = fmaf(cr[u], br[jj][u], s[i][jj]);
      }
    }
  }
  float* out = cb + static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      out[(rg + 16 * i) * kSimtRows + cg + 16 * jj] = s[i][jj];
}

// The plan of a padded head dim DP = 16·DW (hd rounded up to 16, 32, 64
// or 128; x's columns past hd reach only Y's, which are never stored).
// Each quarter of the block serves kHQ heads of the block's 4·kHQ, one
// after the other; its thread (qr, qc) owns rows qr + 8i (i < 8) of each
// one's Y and columns 64·xs + kVW·qc + 8·kVW·v + w (an X tile is kXW
// columns wide; kNXS of them a head): DP values a head, kHQ·DP <= 128
// registers.  Past DP 32 one head a quarter: at DP 64 two heads' Y took
// all 255 registers and spilled.
template <typename T, int DW>
struct SimtSsd {
  static constexpr int kDP = 16 * DW;
  static constexpr int kHQ = kDP > 32 ? 1 : 4;
  static constexpr int kHB = 4 * kHQ;
  static constexpr int kXW = kDP < 64 ? kDP : 64;
  static constexpr int kNXS = kDP / kXW;
  static constexpr int kVW = kXW / 8 < 4 ? kXW / 8 : 4;
  static constexpr int kNV = kXW / (8 * kVW);
  // shared memory in bytes: two S tiles (f32, rows padded by 16 bytes),
  // then each quarter's ring of kRing X tiles (32 rows j x kXW) and its
  // M half, two buffers of a tile's column data ({dacs_j} and {dt_j}, a
  // row a head), the strip's dacs_i
  static constexpr int kRing = 4;
  static constexpr int kXTile = kHalf * kXW * static_cast<int>(sizeof(T));
  static constexpr int kQuarter = kRing * kXTile + kSimtRows * kLh * 4;
  static constexpr int kQ0 = 2 * kSimtRows * kLs * 4;
  static constexpr int kCol = kQ0 + 4 * kQuarter;
  static constexpr int kColFloats = 2 * kHB * kSimtRows;
  static constexpr int kRow = kCol + 2 * kColFloats * 4;
  static constexpr int kSmem = kRow + kHB * kSimtRows * 4;
  static_assert(kSmem <= kSmemMax, "the SIMT plan overflows shared memory");
};

// Pass 2: one block owns a work item (chunk z, a strip of 64 rows i, a
// block of `hb` heads of one group, hb <= kHB; a group whose heads hb
// does not divide ends in a shorter block), strips longest first, and
// walks the 64-column tiles j at or below the strip's diagonal, reading
// each tile's S = C·Bᵀ from pass 1.  For each of its heads and each half
// of the tile's columns, a quarter of the block forms M = S ∘ exp(dacs_i
// − dacs_j) ∘ dt_j (0 above the diagonal and past Q), rounded to x's
// type, for its own rows (so a warp reads back only what it wrote), and
// adds M·X_h to the head's Y, 8 x 8 (or 8 x DP / 8) a thread in
// registers, each 16-byte load of M or X feeding 16 FMAs.  X tiles come
// by cp.async into each quarter's ring, kRing − 1 steps ahead of its
// M·X; the next tile's S and column data during this tile's first step.
// The quarters meet only at each tile's block barrier; within a tile
// each waits at its own named barrier.
template <typename T, int DW>
__global__ void __launch_bounds__(kSimtThreads, 1)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dacs, const float* __restrict__ cb,
                 T* __restrict__ y, int BC, int Q, int nh, int hd, int g,
                 int hb, int vec) {
  using Pl = SimtSsd<T, DW>;
  constexpr int kHQ = Pl::kHQ, kHB = Pl::kHB, kXW = Pl::kXW;
  constexpr int kNXS = Pl::kNXS, kVW = Pl::kVW, kNV = Pl::kNV;
  constexpr int kRing = Pl::kRing;
  extern __shared__ __align__(16) uint8_t simt_raw[];
  float* Ss = reinterpret_cast<float*>(simt_raw);           // [2][64][kLs]
  float* cols = reinterpret_cast<float*>(simt_raw + Pl::kCol);
  float* rowA = reinterpret_cast<float*>(simt_raw + Pl::kRow);  // [kHB][64]

  // the work item, longest strips first
  const int n_strips = (Q + kSimtRows - 1) / kSimtRows;
  const int hpg = nh / g, n_hblk = (hpg + hb - 1) / hb;
  const int per_strip = BC * g * n_hblk;
  const int strip = n_strips - 1 - blockIdx.x / per_strip;
  const int rest = blockIdx.x % per_strip;
  const int z = rest % BC, grp = rest / BC / n_hblk;
  const int h0 = grp * hpg + (rest / BC % n_hblk) * hb;
  const int nbh = min(hb, grp * hpg + hpg - h0);     // heads of this block
  const int i0 = strip * kSimtRows;
  const int rows = min(kSimtRows, Q - i0);
  // this strip's S tiles in pass 1's scratch
  const float* cbs = cb + (static_cast<long long>(grp * BC + z)
                           * (n_strips * (n_strips + 1) / 2)
                           + strip * (strip + 1) / 2) * kTile;

  const int tid = threadIdx.x, warp = tid / 32;
  // quarter qd, its thread (qr, qc)
  const int qd = warp / 2, qt = tid % 64, qr = qt / 8, qc = qt % 8;
  // the quarter's heads: qd, qd + 4, ... below nbh
  const int n_q = nbh > qd ? (nbh - qd + 3) / 4 : 0;
  uint8_t* quarter = simt_raw + Pl::kQ0 + qd * Pl::kQuarter;
  T* Xq = reinterpret_cast<T*>(quarter);              // [kRing][32][kXW]
  float* Mq =                                         // [64][kLh]
      reinterpret_cast<float*>(quarter + kRing * Pl::kXTile);

  const long long x_stride = static_cast<long long>(nh) * hd;
  const T* xz = x + static_cast<long long>(z) * Q * x_stride;
  const long long cd0 = static_cast<long long>(z) * Q * nh;   // dt, dacs

  // tile t's S and column data into buffer t % 2 (column data of heads
  // past nbh and columns past Q: 0)
  auto load_tile = [&](int t) {
    load_rows(Ss + (t % 2) * kSimtRows * kLs, kLs, cbs + t * kTile,
              kSimtRows, kSimtRows, kSimtRows, kSimtRows, true, tid,
              kSimtThreads);
    float* cl = cols + (t % 2) * Pl::kColFloats;
    const int j0 = t * kSimtRows;
    for (int e = tid; e < kHB * kSimtRows; e += kSimtThreads) {
      const int hh = e / kSimtRows, jj = e % kSimtRows;
      const bool in = hh < nbh && j0 + jj < Q;
      const long long at = cd0 + static_cast<long long>(j0 + jj) * nh + h0 + hh;
      cp_async4(cl + e, in ? dacs + at : dacs, in ? 4 : 0);
      cp_async4(cl + kHB * kSimtRows + e, in ? dt + at : dt, in ? 4 : 0);
    }
  };
  // step n of the quarter (tile, its k-th head, column half, X tile xs):
  // its X tile into ring slot n % kRing, by the quarter's 64 threads
  const int steps_a_tile = n_q * 2 * kNXS;
  auto load_x = [&](int n) {
    if (n >= (strip + 1) * steps_a_tile) return;
    const int t = n / steps_a_tile, r = n % steps_a_tile;
    const int k = r / (2 * kNXS), half = r / kNXS % 2, xs = r % kNXS;
    const int j0 = t * kSimtRows + half * kHalf;
    // (a half past Q reads nothing: its rows are zeros)
    const T* src = j0 < Q ? xz + static_cast<long long>(j0) * x_stride
                                + static_cast<long long>(h0 + qd + 4 * k) * hd
                                + xs * 64
                          : x;
    load_rows(Xq + (n % kRing) * kHalf * kXW, kXW, src, x_stride, kHalf,
              Q - j0, min(kXW, hd - xs * 64), vec, qt, 64);
  };

  for (int e = tid; e < kHB * kSimtRows; e += kSimtThreads) {
    const int hh = e / kSimtRows, r = e % kSimtRows;
    const bool in = hh < nbh && r < rows;
    cp_async4(rowA + e,
              in ? dacs + cd0 + static_cast<long long>(i0 + r) * nh + h0 + hh
                 : dacs,
              in ? 4 : 0);
  }
  load_tile(0);
  for (int n = 0; n < kRing - 1; ++n) {  // the ring's first steps
    if (n_q > 0) load_x(n);
    cp_async_commit();
  }

  float acc[kHQ][8][kNXS][kNV][kVW];
#pragma unroll
  for (int k = 0; k < kHQ; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int xs = 0; xs < kNXS; ++xs)
#pragma unroll
        for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
          for (int w = 0; w < kVW; ++w) acc[k][i][xs][nv][w] = 0.f;

  int n = 0;                             // the quarter's steps so far
  for (int t = 0; t <= strip; ++t) {
    const int j0 = t * kSimtRows;
    const bool diag = t == strip;        // only it reaches above i = j
    cp_async_wait<0>();
    __syncthreads();                     // S and column data of t landed
    // the next tile's, under this tile's first M·X step (the quarters
    // without a head start them now)
    bool next_pending = t < strip;
    if (n_q == 0 && next_pending) {
      load_tile(t + 1);
      cp_async_commit();
    }
    const float* St = Ss + (t % 2) * kSimtRows * kLs;
    const float* cl = cols + (t % 2) * Pl::kColFloats;
#pragma unroll
    for (int k = 0; k < kHQ; ++k) {
      if (k >= n_q) break;               // uniform over the quarter
      const int hh = qd + 4 * k;
      const float* ca = cl + hh * kSimtRows;
      const float* cdt = cl + (kHB + hh) * kSimtRows;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // M of head hh for the half's 32 columns, on the thread's rows
        __syncwarp();                    // the warp's last M·X is done
        const int c0 = half * kHalf + 4 * qc;   // the thread's 4 columns
        float aj[4], dtj[4];
        ld_vec(aj, ca + c0);
        ld_vec(dtj, cdt + c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = qr + 8 * i;
          const float ai = rowA[hh * kSimtRows + r];
          float sv[4];
          ld_vec(sv, St + r * kLs + c0);
          float mv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            mv[u] = 0.f;
            if (!(diag && c0 + u > r) && j0 + c0 + u < Q)
              mv[u] = round_to<T>(sv[u] * ex2_sfu((ai - aj[u]) * kLog2e)
                                  * dtj[u]);
          }
          *reinterpret_cast<float4*>(Mq + r * kLh + 4 * qc) =
              make_float4(mv[0], mv[1], mv[2], mv[3]);
        }
        __syncwarp();                    // the warp's M rows are whole
#pragma unroll
        for (int xs = 0; xs < kNXS; ++xs, ++n) {
          cp_async_wait<kRing - 2>();    // step n's group; later ones pend
          named_barrier(1 + qd, 64);     // X of step n landed; slot free
          load_x(n + kRing - 1);
          if (next_pending) {
            load_tile(t + 1);
            next_pending = false;
          }
          cp_async_commit();
          const T* xt = Xq + (n % kRing) * kHalf * kXW;
#pragma unroll 1
          for (int jj = 0; jj < kHalf; jj += 4) {
            float mr[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              ld_vec(mr[i], Mq + (qr + 8 * i) * kLh + jj);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              float xr[kNV][kVW];
#pragma unroll
              for (int nv = 0; nv < kNV; ++nv)
                ld_vec(xr[nv], xt + (jj + u) * kXW + kVW * qc + 8 * kVW * nv);
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
                  for (int w = 0; w < kVW; ++w)
                    acc[k][i][xs][nv][w] = fmaf(mr[i][u], xr[nv][w],
                                                acc[k][i][xs][nv][w]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();                    // no copy outlives the block

#pragma unroll
  for (int k = 0; k < kHQ; ++k) {
    if (k >= n_q) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = qr + 8 * i;
      if (r >= rows) continue;
      T* yrow = y + (static_cast<long long>(z) * Q + i0 + r) * x_stride
                + static_cast<long long>(h0 + qd + 4 * k) * hd;
#pragma unroll
      for (int xs = 0; xs < kNXS; ++xs)
#pragma unroll
        for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
          for (int w = 0; w < kVW; ++w) {
            const int d = 64 * xs + kVW * qc + 8 * kVW * nv + w;
            if (d < hd) yrow[d] = from_float<T>(acc[k][i][xs][nv][w]);
          }
    }
  }
}

template <typename T, int DW>
int launch_simt_dw(const void* x, const float* dt, const float* dacs,
                   const void* b, const void* c, void* y, float* cb, int BC,
                   int Q, int nh, int hd, int g, int ds, int hb,
                   cudaStream_t stream) {
  using Pl = SimtSsd<T, DW>;
  if (hb < 1 || hb > Pl::kHB) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kCbSmem =
      2 * kSimtRows * (kSimtDs + 16 / static_cast<int>(sizeof(T)))
      * static_cast<int>(sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kCbSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_intra_kernel<T, DW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Pl::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies where every row of x, b and c starts 16-byte aligned
  // (the scratch's tiles always do)
  const bool vec_x = (hd * sizeof(T)) % 16 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_bc = (ds * sizeof(T)) % 16 == 0
                      && (reinterpret_cast<uintptr_t>(b)
                          | reinterpret_cast<uintptr_t>(c)) % 16 == 0;
  const long long n_strips = (Q + kSimtRows - 1) / kSimtRows;
  const long long n_tiles = BC * g * (n_strips * (n_strips + 1) / 2);
  const long long n_items = n_strips * BC * g * ((nh / g + hb - 1) / hb);
  if (n_tiles > 0x7fffffffLL || n_items > 0x7fffffffLL
      || reinterpret_cast<uintptr_t>(cb) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_cb_kernel<T><<<static_cast<unsigned>(n_tiles), kSimtThreads, kCbSmem,
                     stream>>>(static_cast<const T*>(b),
                               static_cast<const T*>(c), cb, BC, Q, g, ds,
                               vec_bc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_intra_kernel<T, DW><<<static_cast<unsigned>(n_items), kSimtThreads,
                            Pl::kSmem, stream>>>(
      static_cast<const T*>(x), dt, dacs, cb, static_cast<T*>(y), BC, Q, nh,
      hd, g, hb, vec_x);
  return static_cast<int>(cudaGetLastError());
}

// The SIMT kernels of x's head-dim class: hd rounded up to 16, 32, 64 or
// 128.
template <typename T>
int launch_simt(const void* x, const float* dt, const float* dacs,
                const void* b, const void* c, void* y, float* cb, int BC,
                int Q, int nh, int hd, int g, int ds, int hb,
                cudaStream_t stream) {
  if (hd <= 16)
    return launch_simt_dw<T, 1>(x, dt, dacs, b, c, y, cb, BC, Q, nh, hd, g,
                                ds, hb, stream);
  if (hd <= 32)
    return launch_simt_dw<T, 2>(x, dt, dacs, b, c, y, cb, BC, Q, nh, hd, g,
                                ds, hb, stream);
  if (hd <= 64)
    return launch_simt_dw<T, 4>(x, dt, dacs, b, c, y, cb, BC, Q, nh, hd, g,
                                ds, hb, stream);
  return launch_simt_dw<T, 8>(x, dt, dacs, b, c, y, cb, BC, Q, nh, hd, g, ds,
                              hb, stream);
}

}  // namespace

// y = intra-chunk SSD of x/b/c of working type `dtype` (DType: f32 or
// bf16; y has x's type) and f32 dt/dacs, all contiguous in the layouts
// above on CUDA device `device`; nh % g == 0, hd <= 128 and ds <= 256,
// by the SIMT kernels: `cb` is their f32 scratch of C·Bᵀ tiles, BC·g·
// n(n + 1)/2 tiles of 64 x 64 for n = ceil(Q / 64) strips, 16-byte
// aligned, and `hb` the heads of a work item (`simt_heads`: 1 to 16 up
// to hd 32, to 4 past it).  Launches both passes on `stream` and returns
// the launches' cudaError_t (0 on success).
extern "C" int ssd_intra(int dtype, const void* x, const float* dt,
                         const float* dacs, const void* b, const void* c,
                         void* y, float* cb, int BC, int Q, int nh, int hd,
                         int g, int ds, int hb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC < 1 || Q < 1 || hd < 1 || hd > kMaxHd || ds < 1 || ds > 256
      || g < 1 || nh % g)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_simt<float>(x, dt, dacs, b, c, y, cb, BC, Q, nh, hd, g,
                                ds, hb, s);
    case kBF16:
      return launch_simt<__nv_bfloat16>(x, dt, dacs, b, c, y, cb, BC, Q, nh,
                                        hd, g, ds, hb, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same intra-chunk SSD for bf16 x/b/c through the TMA + wgmma kernel:
// hd 64 or 128, ds a multiple of 64 up to 256, Q a multiple of 64 up to
// 1,024, `hb` heads an item (1 or 2 at hd 64, 1 at hd 128) dividing
// nh / g, x/b/c 16-byte aligned.  Returns the launch's
// cudaError_t, or hopper.cuh's codes when a tensor map cannot be encoded.
extern "C" int ssd_intra_bf16_wgmma(const void* x, const float* dt,
                                    const float* dacs, const void* b,
                                    const void* c, void* y, int BC, int Q,
                                    int nh, int hd, int g, int ds, int hb,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BC < 1 || Q < 64 || Q % 64 || Q > 1024 || ds < 64 || ds % 64
      || ds > 256 || g < 1 || nh % g || hb < 1 || (nh / g) % hb)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64 && hb == 1)
    return launch_tc<64, 1>(x, dt, dacs, b, c, y, BC, Q, nh, g, ds, device,
                            s);
  if (hd == 64 && hb == 2)
    return launch_tc<64, 2>(x, dt, dacs, b, c, y, BC, Q, nh, g, ds, device,
                            s);
  if (hd == 128 && hb == 1)
    return launch_tc<128, 1>(x, dt, dacs, b, c, y, BC, Q, nh, g, ds,
                             device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
