// Fused OFU histogram-accumulate for Hopper (sm_90a): the device side of
// rollup ingest.
//
// Replaces the TPU Pallas kernel repro/kernels/fleet_hist.py::_hist_kernel.
// Same function, per sample of a (D, S) counter grid:
//
//     ofu = (tpa * clock) * inv_fmax             (f32, round-to-nearest)
//     k   = #(edges <= ofu) - 1, clipped to [0, bins - 1]
//     hist[col_bucket[s], k] += 1 ; sums[col_bucket[s]] += ofu
//
// Bins are decided by COMPARISON against the f32 edges, never by
// arithmetic on the value, which would flip samples one ulp from an edge:
// p = #(edges e with !(ofu < e)) (searchsorted with side="right") is
// guessed from the uniform-grid formula, then taken one step down or up
// where the two edges around it say so, and where they still disagree
// found by a binary search in shared memory.  The guess only saves
// comparisons: any strictly increasing edges give the same bins.  A NaN
// counts every edge, as in searchsorted, and lands in the last bin.  The
// products use __fmul_rn so the compiler cannot contract them; build
// without --use_fast_math.
//
// What differs from the TPU kernel:
//   * a column's bucket comes from a plan the wrapper makes from
//     col_bucket: each 128-column tile of the block numbers the distinct
//     buckets of its columns 0..n_slots-1 (the column's slot) and lists
//     the bucket of each slot, so any column->bucket map, ragged or not,
//     needs no fallback path;
//   * counts are int32, privatised per block in shared memory by
//     (slot, bin) -- the ~13 buckets of a tile at 10 scrapes a bucket,
//     not one row a column -- and added to the global histogram once per
//     block and non-empty cell; the TPU kernel counts in f32, exact only
//     to 2^24.  Each sample adds 1 by a shared atomic: combining the
//     lanes that hit one cell first (__match_any_sync) costs more than
//     the atomics it saves (tools/kernel_ablation.py);
//   * each thread sums its 4 columns' OFU in f32 registers, the block
//     adds them per column in shared memory and per slot in f64, and one
//     double atomic per slot and block adds them to the global per-bucket
//     sums.  Atomics land in no fixed order, so sums agree with a
//     sequential sum to rounding (rtol 1e-5) while counts are exact.
//
// Bound: memory.  Every sample reads 8 bytes (tpa + clock) and the output
// is a few KB, so at 100,000 x 2,880 samples the kernel must move 2.3 GB:
// about 0.69 ms at the H100 SXM's 3.35 TB/s data-sheet bandwidth.  A warp
// reads 512 contiguous bytes of a row in 16-byte loads (4 columns a lane;
// 4-byte loads where S is not a multiple of 4 or a grid is not 16-byte
// aligned), each thread keeps 4 rows of loads in flight before it bins
// them, and the wrapper sizes the row split so one job's grid and a whole
// fleet in one call both fill the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 128;                  // columns per block: 4 a lane
constexpr int kWarps = 8;                   // warps per block stride over rows
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsAhead = 4;               // rows loaded before binning

// k of v: the bin the edges e[0..bins] give it by comparison, starting
// from the guess p of #(edges not above v).
__device__ __forceinline__ int find_bin(float v, const float* e, int bins,
                                        float e0, float inv_w) {
  int p = static_cast<int>(
      fminf(fmaxf((v - e0) * inv_w + 1.f, 0.f), static_cast<float>(bins + 1)));
  bool ok = true;
  if (p > 0 && v < e[p - 1]) {              // e[p - 1] is above v
    --p;
    ok = p == 0 || !(v < e[p - 1]);
  } else if (p <= bins && !(v < e[p])) {    // e[p] is not above v
    ++p;
    ok = p > bins || v < e[p];
  }
  if (!ok) {                                // first edge above v
    int lo = 0, hi = bins + 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (v < e[mid]) hi = mid; else lo = mid + 1;
    }
    p = lo;
  }
  return min(max(p - 1, 0), bins - 1);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fleet_hist_kernel(const float* __restrict__ tpa,
                  const float* __restrict__ clock, long long n_rows,
                  long long n_cols, long long rows_per_block,
                  const int* __restrict__ plan, int n_slots,
                  const float* __restrict__ edges, int bins, float inv_fmax,
                  int* __restrict__ hist, double* __restrict__ sums) {
  extern __shared__ double smem[];
  const int ld = bins | 1;                  // odd stride: distinct banks
  double* s_ssum = smem;                                    // [n_slots]
  float* s_csum = reinterpret_cast<float*>(s_ssum + n_slots);  // [kCols]
  int* s_cslot = reinterpret_cast<int*>(s_csum + kCols);    // [kCols]
  float* s_edges = reinterpret_cast<float*>(s_cslot + kCols);  // [bins + 1]
  int* s_hist = reinterpret_cast<int*>(s_edges + bins + 1); // [n_slots][ld]

  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  for (int i = threadIdx.x; i < n_slots * ld; i += kThreads) s_hist[i] = 0;
  for (int i = threadIdx.x; i <= bins; i += kThreads) s_edges[i] = edges[i];
  for (int q = threadIdx.x; q < n_slots; q += kThreads) s_ssum[q] = 0.0;
  if (threadIdx.x < kCols) {
    s_csum[threadIdx.x] = 0.f;
    s_cslot[threadIdx.x] =
        col0 + threadIdx.x < n_cols ? plan[col0 + threadIdx.x] : -1;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float e0 = s_edges[0];
  const float inv_w = static_cast<float>(bins) / (s_edges[bins] - e0);
  const long long c0 = col0 + 4 * lane;     // this thread's 4 columns
  int key0[4];                              // slot * ld, -1 past S
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = s_cslot[4 * lane + u];
    key0[u] = q < 0 ? -1 : q * ld;
  }
  const long long row0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long row1 = min(row0 + rows_per_block, n_rows);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r = row0 + warp; r < row1; r += kWarps * kRowsAhead) {
    float v[kRowsAhead][4];
#pragma unroll
    for (int a = 0; a < kRowsAhead; ++a) {
      const long long ra = r + static_cast<long long>(a) * kWarps;
      float t[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
      if (ra < row1) {
        const long long i = ra * n_cols + c0;
        if constexpr (kVec) {               // n_cols % 4 == 0: all 4 or none
          if (c0 < n_cols) {
            const float4 t4 =
                __ldcs(reinterpret_cast<const float4*>(tpa + i));
            const float4 c4 =
                __ldcs(reinterpret_cast<const float4*>(clock + i));
            t[0] = t4.x; t[1] = t4.y; t[2] = t4.z; t[3] = t4.w;
            c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (c0 + u < n_cols) {
              t[u] = __ldcs(tpa + i + u);
              c[u] = __ldcs(clock + i + u);
            }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[a][u] = __fmul_rn(__fmul_rn(t[u], c[u]), inv_fmax);
    }
#pragma unroll
    for (int a = 0; a < kRowsAhead; ++a) {
      // warp-uniform
      if (r + static_cast<long long>(a) * kWarps >= row1) break;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (key0[u] >= 0) {
          const int k = find_bin(v[a][u], s_edges, bins, e0, inv_w);
          atomicAdd(&s_hist[key0[u] + k], 1);
          acc[u] += v[a][u];
        }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (key0[u] >= 0) atomicAdd(&s_csum[4 * lane + u], acc[u]);
  __syncthreads();

  // one f64 sum a slot, then one global add per non-empty (slot, bin)
  // cell and per slot
  const int* slot_bucket =
      plan + n_cols + static_cast<long long>(blockIdx.x) * n_slots;
  if (threadIdx.x < kCols && s_cslot[threadIdx.x] >= 0)
    atomicAdd(&s_ssum[s_cslot[threadIdx.x]],
              static_cast<double>(s_csum[threadIdx.x]));
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots * bins; i += kThreads) {
    const int q = i / bins, k = i - q * bins;
    const int n = s_hist[q * ld + k];
    if (n)
      atomicAdd(&hist[static_cast<long long>(slot_bucket[q]) * bins + k], n);
  }
  for (int q = threadIdx.x; q < n_slots; q += kThreads)
    if (slot_bucket[q] >= 0) atomicAdd(&sums[slot_bucket[q]], s_ssum[q]);
}

}  // namespace

// hist (n_buckets, bins) int32 and sums (n_buckets,) float64 must be zeroed
// by the caller; every pointer is memory of CUDA device `device`.  plan
// holds n_cols column slots, then n_slots bucket rows (-1: none) for each
// 128-column tile.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int fleet_hist(const float* tpa, const float* clock,
                          long long n_rows, long long n_cols,
                          long long rows_per_block, const int* plan,
                          int n_slots, const float* edges, int bins,
                          float inv_fmax, int* hist, double* sums,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots < 1 || n_slots > kCols || bins < 1 || rows_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ld = bins | 1;
  const size_t smem = sizeof(double) * n_slots
                      + sizeof(float) * (2 * kCols + bins + 1)
                      + sizeof(int) * static_cast<size_t>(n_slots) * ld;
  const bool vec = n_cols % 4 == 0
                   && reinterpret_cast<uintptr_t>(tpa) % 16 == 0
                   && reinterpret_cast<uintptr_t>(clock) % 16 == 0;
  auto kernel = vec ? fleet_hist_kernel<true> : fleet_hist_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n_cols + kCols - 1) / kCols),
                  static_cast<unsigned>((n_rows + rows_per_block - 1)
                                        / rows_per_block));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tpa, clock, n_rows, n_cols, rows_per_block, plan, n_slots, edges,
      bins, inv_fmax, hist, sums);
  return static_cast<int>(cudaGetLastError());
}
