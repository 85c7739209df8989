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
// Bins are found by COMPARISON against the f32 edges (a binary search in
// shared memory for the first edge e with ofu < e, i.e. searchsorted with
// side="right"), never by arithmetic on the value, which would flip
// samples one ulp from an edge.  A NaN counts every edge, as in
// searchsorted, and lands in the last bin.  The products use __fmul_rn so
// the compiler cannot contract them; build without --use_fast_math.
//
// What differs from the TPU kernel:
//   * each column reads its own col_bucket[s], so a ragged column->bucket
//     map needs no fallback path;
//   * counts are int32, privatised per block in shared memory (one
//     histogram row per column of the block's tile, padded to an odd
//     stride against bank conflicts) and added to the global histogram
//     once per block; the TPU kernel counts in f32, exact only to 2^24;
//   * each thread sums its column's OFU in a f32 register, the block adds
//     its per-column sums in shared memory, and one double atomic per
//     column and block adds them to the global per-bucket sums.  Atomics
//     land in no fixed order, so sums agree with a sequential sum to
//     rounding (rtol 1e-5) while counts are exact.
//
// Bound: memory.  Every sample reads 8 bytes (tpa + clock) and the output
// is a few KB, so at 100,000 x 2,880 samples the kernel must move 2.3 GB:
// about 0.69 ms at the H100 SXM's 3.35 TB/s data-sheet bandwidth.  The
// design keeps one warp on 32 neighbouring columns of a row (128-byte
// loads) and loads a few rows ahead of the binning in each thread.
// Making it reach that bound is later work; this version is simple and
// exact.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                   // columns per block: one per lane
constexpr int kWarps = 8;                   // warps per block stride over rows
constexpr int kThreads = kCols * kWarps;
constexpr int kRowsAhead = 4;               // rows loaded before binning

__global__ void __launch_bounds__(kThreads)
fleet_hist_kernel(const float* __restrict__ tpa,
                  const float* __restrict__ clock, long long n_rows,
                  long long n_cols, long long rows_per_block,
                  const int* __restrict__ col_bucket,
                  const float* __restrict__ edges, int bins, float inv_fmax,
                  int* __restrict__ hist, double* __restrict__ sums) {
  extern __shared__ unsigned char smem[];
  const int ld = bins | 1;                  // odd stride: lanes hit distinct banks
  int* s_hist = reinterpret_cast<int*>(smem);              // [kCols][ld]
  float* s_edges = reinterpret_cast<float*>(s_hist + kCols * ld);  // [bins + 1]
  float* s_sum = s_edges + bins + 1;                        // [kCols]

  for (int i = threadIdx.x; i < kCols * ld; i += kThreads) s_hist[i] = 0;
  for (int i = threadIdx.x; i <= bins; i += kThreads) s_edges[i] = edges[i];
  if (threadIdx.x < kCols) s_sum[threadIdx.x] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x % kCols;
  const int warp = threadIdx.x / kCols;
  const long long col = static_cast<long long>(blockIdx.x) * kCols + lane;
  const long long row0 = static_cast<long long>(blockIdx.y) * rows_per_block;
  const long long row1 = min(row0 + rows_per_block, n_rows);
  float acc = 0.f;
  if (col < n_cols) {
    int* my_hist = s_hist + lane * ld;
    for (long long r = row0 + warp; r < row1; r += kWarps * kRowsAhead) {
      float v[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const long long ru = r + static_cast<long long>(u) * kWarps;
        v[u] = 0.f;
        if (ru < row1) {
          const long long i = ru * n_cols + col;
          v[u] = __fmul_rn(__fmul_rn(tpa[i], clock[i]), inv_fmax);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        if (r + static_cast<long long>(u) * kWarps >= row1) break;
        int lo = 0, hi = bins + 1;          // first edge with v < edge
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (v[u] < s_edges[mid]) hi = mid; else lo = mid + 1;
        }
        const int k = min(max(lo - 1, 0), bins - 1);
        atomicAdd(&my_hist[k], 1);
        acc += v[u];
      }
    }
  }
  atomicAdd(&s_sum[lane], acc);
  __syncthreads();

  // one global add per non-empty (column, bin) cell and per column sum
  const long long col0 = static_cast<long long>(blockIdx.x) * kCols;
  for (int i = threadIdx.x; i < kCols * bins; i += kThreads) {
    const int c = i / bins, k = i - c * bins;
    const int n = s_hist[c * ld + k];
    if (n) atomicAdd(&hist[static_cast<long long>(col_bucket[col0 + c]) * bins + k], n);
  }
  if (threadIdx.x < kCols && col0 + threadIdx.x < n_cols) {
    atomicAdd(&sums[col_bucket[col0 + threadIdx.x]],
              static_cast<double>(s_sum[threadIdx.x]));
  }
}

}  // namespace

// hist (n_buckets, bins) int32 and sums (n_buckets,) float64 must be zeroed
// by the caller; every pointer is memory of CUDA device `device`.  Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int fleet_hist(const float* tpa, const float* clock,
                          long long n_rows, long long n_cols,
                          long long rows_per_block, const int* col_bucket,
                          const float* edges, int bins, float inv_fmax,
                          int* hist, double* sums, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ld = bins | 1;
  const size_t smem = sizeof(int) * kCols * ld
                      + sizeof(float) * (bins + 1 + kCols);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        fleet_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((n_cols + kCols - 1) / kCols),
                  static_cast<unsigned>((n_rows + rows_per_block - 1)
                                        / rows_per_block));
  fleet_hist_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      tpa, clock, n_rows, n_cols, rows_per_block, col_bucket, edges, bins,
      inv_fmax, hist, sums);
  return static_cast<int>(cudaGetLastError());
}
