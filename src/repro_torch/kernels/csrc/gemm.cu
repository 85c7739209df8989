// Tiled GEMM for Hopper (sm_90a): the controlled workload of the paper's
// §IV, C = A · B on operands already zero-padded to the tile policy.
//
// Replaces the TPU Pallas kernel repro/kernels/gemm.py::_gemm_kernel.
// Same function: A (M, K) and B (K, N), row-major; products summed in
// f32 (bf16, f32 inputs) or exactly in int32 (int8 inputs), cast once
// to the output (bf16 -> bf16, f32 -> f32, int8 -> int32).
//
// What differs from the TPU kernel: a TPU policy tile (up to 512 x 512 x
// 512 with a two-core split) is far larger than one block can hold (a
// 512^2 f32 accumulator is 1 MiB), so each block here owns a 128 x 128
// output tile and walks the whole K_eff in slabs staged in shared memory;
// the blocks cover the policy's grid exactly.  The wrapper hands over the
// padded operands, so every K step runs over the zero padding too and
// the kernel executes exactly 2 * M_eff * N_eff * K_eff operations: tile
// quantization stays literal.
//
//   * bf16: warp-level tensor-core products (wmma 16x16x16, f32
//     accumulators), eight warps of 32 x 64 outputs each, K slabs of 32;
//   * f32: true f32 FMAs on the SM's cores (no TF32: its 10-bit mantissa
//     would miss the reference's rtol 1e-3 near zero), 8 x 8 outputs a
//     thread, K slabs of 8;
//   * int8: the same tile with int32 multiply-adds, exact.
//
// Bound: operations.  At the main path's largest shape (4096 x 8192 x
// 3072) the operands move ~0.15 GB (0.05 ms at 3.35 TB/s) against 206
// GFLOP: 0.21 ms at 989 TFLOP/s bf16, 3.1 ms at 67 TFLOP/s f32, 0.10 ms
// at 1979 TOP/s int8.  This version loads each slab with plain loads
// and no pipelining; a TMA-fed wgmma mainloop is the later fast path.

#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

// ---- f32 and int8: SIMT tile -----------------------------------------
constexpr int kTile = 128;            // output rows and columns of a block
constexpr int kSlab = 8;              // K depth staged per step
constexpr int kSimtThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each

template <typename T, typename Acc>
__global__ void __launch_bounds__(kSimtThreads)
gemm_simt(const T* __restrict__ a, const T* __restrict__ b,
          Acc* __restrict__ c, int M, int N, int K) {
  __shared__ Acc As[kSlab][kTile];    // A slab, transposed: As[k][m]
  __shared__ Acc Bs[kSlab][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  Acc acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += kSlab) {
    for (int e = threadIdx.x; e < kTile * kSlab; e += kSimtThreads) {
      const int r = e / kSlab, kk = e % kSlab;
      const int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K)
                      ? Acc(a[static_cast<long long>(gm) * K + gk]) : Acc(0);
    }
    for (int e = threadIdx.x; e < kSlab * kTile; e += kSimtThreads) {
      const int kk = e / kTile, col = e % kTile;
      const int gk = k0 + kk, gn = n0 + col;
      Bs[kk][col] = (gk < K && gn < N)
                        ? Acc(b[static_cast<long long>(gk) * N + gn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; ++kk) {
      Acc ar[8], br[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ar[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) br[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) c[static_cast<long long>(gm) * N + gn] = acc[i][j];
    }
  }
}

// ---- bf16: wmma tensor-core tile --------------------------------------
namespace wmma = nvcuda::wmma;
constexpr int kWSlab = 32;                 // K depth staged per step
constexpr int kWThreads = 256;             // 8 warps: 4 (rows) x 2 (cols)
constexpr int kALd = kWSlab + 8;           // padded strides, multiples of 8
constexpr int kBLd = kTile + 8;

__global__ void __launch_bounds__(kWThreads)
gemm_bf16_wmma(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b,
               __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[kTile * kALd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kWSlab * kBLd];
  __shared__ __align__(128) float Cw[kWThreads / 32][16 * 16];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp's 32 x 64 output patch
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kWSlab) {
    for (int e = threadIdx.x; e < kTile * kWSlab; e += kWThreads) {
      const int r = e / kWSlab, kk = e % kWSlab;
      const int gm = m0 + r, gk = k0 + kk;
      As[r * kALd + kk] = (gm < M && gk < K)
                              ? a[static_cast<long long>(gm) * K + gk] : zero;
    }
    for (int e = threadIdx.x; e < kWSlab * kTile; e += kWThreads) {
      const int kk = e / kTile, col = e % kTile;
      const int gk = k0 + kk, gn = n0 + col;
      Bs[kk * kBLd + col] = (gk < K && gn < N)
                                ? b[static_cast<long long>(gk) * N + gn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWSlab; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kALd + kk,
                               kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kBLd + wn * 64 + j * 16,
                               kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // one rounding to bf16, through a per-warp 16 x 16 staging tile
  float* cw = Cw[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int gm = m0 + wm * 32 + i * 16 + e / 16;
        const int gn = n0 + wn * 64 + j * 16 + e % 16;
        if (gm < M && gn < N)
          c[static_cast<long long>(gm) * N + gn] = __float2bfloat16(cw[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C = A · B for row-major A (M, K), B (K, N) and C (M, N) of the working
// type `dtype` (DType; the output is int32 for int8), all memory of CUDA
// device `device`.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int gemm(int dtype, const void* a, const void* b, void* c, int M,
                    int N, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      gemm_simt<float, float><<<grid, kSimtThreads, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), M, N, K);
      break;
    case kBF16:
      gemm_bf16_wmma<<<grid, kWThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b),
          static_cast<__nv_bfloat16*>(c), M, N, K);
      break;
    case kI8:
      gemm_simt<int8_t, int><<<grid, kSimtThreads, 0, s>>>(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
          static_cast<int*>(c), M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
