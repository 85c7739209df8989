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
// exp(-1e30) = 0; this kernel writes the 0 without computing it.
//
// What differs from the TPU kernel: its (head-block, Q, Q) f32 tile
// (Q = 256: 256 KiB a head) does not fit a block's shared memory, so a
// block owns one strip of 64 rows i of one (z, h) and walks the columns
// j <= i in steps of 64: it computes the 64 x 64 tile of M into shared
// memory, then adds M.X into per-thread f32 accumulators.  Column steps
// wholly above the strip's diagonal are skipped.  The head blocking of
// the TPU grid is not kept: every (z, h) is its own blocks.  Where the
// TPU kernel takes B and C broadcast to one copy a head, this kernel
// reads each head's group in place (g = nh is the TPU layout).
//
// Bound: bytes.  At mamba2-780m width (BC = 16 chunks of Q = 256,
// nh = 48, hd = 64, g = 1, ds = 128, bf16) the inputs and output are
// ~52 MB: 0.016 ms at 3.35 TB/s, against ~9.7 GFLOP (0.01 ms at 989
// TFLOP/s bf16).  This version computes in
// f32 on the SM's cores from shared memory and is far from that bound.

#include <cstdint>

#include "common.cuh"

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
