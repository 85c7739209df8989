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
//     (ssd_intra_kernel): its (head-block, Q, Q) f32 tile (Q = 256:
//     256 KiB a head) does not fit a block's shared memory, so a block
//     owns one strip of 64 rows i of one (z, h) and walks the columns
//     j <= i in steps of 64: it computes the 64 x 64 tile of M into
//     shared memory, then adds M.X into per-thread f32 accumulators, on
//     the SM's cores.  Column steps wholly above the strip's diagonal
//     are skipped.
//
// Where the TPU kernel takes B and C broadcast to one copy a head, both
// kernels read each head's group in place (g = nh is the TPU layout).
//
// Bound: bytes.  At mamba2-780m width (BC = 16 chunks of Q = 256,
// nh = 48, hd = 64, g = 1, ds = 128, bf16) the inputs and output are
// ~54 MB: 0.016 ms at 3.35 TB/s.  The tensor work is ~4.8 GFLOP of C.B^T
// a head block and ~4.8 GFLOP of M.X over whole 128 x 128 tiles (0.010
// ms at 989 TFLOP/s bf16), and 25 M exps over the causal pairs.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;        // rows i of a block's strip
constexpr int kCols = 64;        // columns j of one step
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr int kMaxOut = kRows * kMaxHd / kThreads;   // accumulators a thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dacs, const T* __restrict__ b,
                 const T* __restrict__ c, T* __restrict__ y, int Q, int nh,
                 int hd, int g, int ds) {
  extern __shared__ float smem[];
  const int lds = ds | 1;                  // odd stride: lanes hit distinct banks
  float* Cs = smem;                        // [kRows][lds]
  float* Bs = Cs + kRows * lds;            // [kCols][lds]
  float* Xs = Bs + kCols * lds;            // [kCols][hd]
  float* Ms = Xs + kCols * hd;             // [kRows][kCols + 1]
  float* dacs_i = Ms + kRows * (kCols + 1);  // [kRows]
  float* dacs_j = dacs_i + kRows;          // [kCols]
  float* dt_j = dacs_j + kCols;            // [kCols]

  const long long z = blockIdx.x;
  const int h = blockIdx.y;
  const int i0 = blockIdx.z * kRows;
  const int rows = min(kRows, Q - i0);
  // element (z, q, h) of a (BC, Q, nh[, w]) tensor
  auto at = [&](int q, int w) { return ((z * Q + q) * nh + h) * w; };
  // row (z, q) of head h's group in a (BC, Q, g, ds) tensor
  const int grp = h / (nh / g);
  auto at_grp = [&](int q) { return ((z * Q + q) * g + grp) * ds; };

  for (int e = threadIdx.x; e < kRows * ds; e += kThreads) {
    const int r = e / ds, d = e % ds;
    Cs[r * lds + d] = r < rows ? to_float(c[at_grp(i0 + r) + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    dacs_i[r] = r < rows ? dacs[at(i0 + r, 1)] : 0.f;

  float acc[kMaxOut];
#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) acc[o] = 0.f;

  const int j_end = i0 + rows;             // causal: j <= the strip's last i
  for (int j0 = 0; j0 < j_end; j0 += kCols) {
    const int cols = min(kCols, Q - j0);
    __syncthreads();                       // the last step is done with the tiles
    for (int e = threadIdx.x; e < kCols * ds; e += kThreads) {
      const int r = e / ds, d = e % ds;
      Bs[r * lds + d] = r < cols ? to_float(b[at_grp(j0 + r) + d]) : 0.f;
    }
    for (int e = threadIdx.x; e < kCols * hd; e += kThreads) {
      const int r = e / hd;
      Xs[e] = r < cols ? to_float(x[at(j0 + r, hd) + e % hd]) : 0.f;
    }
    for (int r = threadIdx.x; r < kCols; r += kThreads) {
      dacs_j[r] = r < cols ? dacs[at(j0 + r, 1)] : 0.f;
      dt_j[r] = r < cols ? dt[at(j0 + r, 1)] : 0.f;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, cc = e % kCols;
      float m = 0.f;
      if (r < rows && cc < cols && i0 + r >= j0 + cc) {
        const float* cr = Cs + r * lds;
        const float* br = Bs + cc * lds;
        float cb = 0.f;
        for (int d = 0; d < ds; ++d) cb += cr[d] * br[d];
        m = round_to<T>(cb * expf(dacs_i[r] - dacs_j[cc]) * dt_j[cc]);
      }
      Ms[r * (kCols + 1) + cc] = m;
    }
    __syncthreads();

#pragma unroll
    for (int o = 0; o < kMaxOut; ++o) {
      const int e = threadIdx.x + o * kThreads;
      if (e < kRows * hd) {
        const float* mr = Ms + (e / hd) * (kCols + 1);
        const float* xc = Xs + e % hd;
        float s = 0.f;
        for (int cc = 0; cc < kCols; ++cc) s += mr[cc] * xc[cc * hd];
        acc[o] += s;
      }
    }
  }

#pragma unroll
  for (int o = 0; o < kMaxOut; ++o) {
    const int e = threadIdx.x + o * kThreads;
    if (e < kRows * hd && e / hd < rows)
      y[at(i0 + e / hd, hd) + e % hd] = from_float<T>(acc[o]);
  }
}

size_t smem_bytes(int hd, int ds) {
  const int lds = ds | 1;
  return sizeof(float) * (static_cast<size_t>(kRows + kCols) * lds
                          + kCols * hd + kRows * (kCols + 1) + kRows
                          + 2 * kCols);
}

template <typename T>
int launch(const void* x, const float* dt, const float* dacs, const void* b,
           const void* c, void* y, int BC, int Q, int nh, int hd, int g,
           int ds, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BC, nh, (Q + kRows - 1) / kRows);
  ssd_intra_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, dacs, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), Q, nh, hd, g, ds);
  return static_cast<int>(cudaGetLastError());
}

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

}  // namespace

// y = intra-chunk SSD of x/b/c of working type `dtype` (DType: f32 or
// bf16; y has x's type) and f32 dt/dacs, all contiguous in the layouts
// above on CUDA device `device`; nh % g == 0, hd <= 128 and ds <= 256
// (181 KB of shared memory at most).  Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
extern "C" int ssd_intra(int dtype, const void* x, const float* dt,
                         const float* dacs, const void* b, const void* c,
                         void* y, int BC, int Q, int nh, int hd, int g,
                         int ds, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd > kMaxHd || g < 1 || nh % g)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(x, dt, dacs, b, c, y, BC, Q, nh, hd, g, ds, s);
    case kBF16:
      return launch<__nv_bfloat16>(x, dt, dacs, b, c, y, BC, Q, nh, hd, g,
                                   ds, s);
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
