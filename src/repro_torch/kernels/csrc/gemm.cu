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
// 512^2 f32 accumulator is 1 MiB), so each block here owns one output
// tile and walks the whole K_eff; the blocks cover the policy's grid
// exactly.  The wrapper hands over the padded operands, so every K step
// runs over the zero padding too and the kernel executes exactly
// 2 * M_eff * N_eff * K_eff operations: tile quantization stays literal.
//
// Bound: operations.  At the main path's largest shape (4096 x 8192 x
// 3072) the operands move ~0.15 GB (0.05 ms at 3.35 TB/s) against 206
// GFLOP: 0.21 ms at 989 TFLOP/s bf16, 3.1 ms at 67 TFLOP/s f32, 0.10 ms
// at 1979 TOP/s int8.
//
//   * bf16 (gemm_bf16_wgmma): 128 x BN output blocks, BN 256 where N_eff
//     divides by it, else 128, taken in groups of 16 row tiles for L2
//     reuse; the padded grid is always whole tiles, since every bf16
//     policy has tm, tn, tk >= 128.  Loads are issued by
//     one producer thread as TMA boxes into a 4-stage mbarrier ring, so
//     no consumer thread spends an instruction on a load and up to three
//     stages are in flight while one is multiplied; products are
//     warpgroup wgmma m64nBNk16 straight from the swizzled tiles, the
//     only instruction that reaches the tensor cores' full rate (the
//     wmma 16x16x16 it replaces is Hopper's legacy mma.sync path).  B
//     is read in its (K, N) layout through the transpose bit: no copy.
//   * f32 (gemm_simt): true f32 FMAs on the SM's cores, 128 x 128 blocks
//     of 8 x 8 outputs a thread, K slabs of 8.  The tensor cores take f32
//     only as TF32, whose 10-bit mantissa would miss the reference's
//     rtol 1e-3 near zero.
//   * int8 (gemm_simt): the same tile with int32 multiply-adds, exact.
//     wgmma takes s8 only with B K-major, so a tensor-core int8 path
//     needs B transposed first; it is the next one to redesign.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16: TMA + wgmma, warp-specialised ------------------------------
constexpr int kBM = 128;                  // output rows of a block
constexpr int kBK = 64;                   // K depth of a stage: one 128 B row
constexpr int kStages = 4;                // ring of (A, B) stages
constexpr int kWgThreads = 384;           // 2 consumer warpgroups + producer
constexpr int kABytes = kBM * kBK * 2;    // 16 KB: one 128-row box
// Blocks run in groups of kGroupM row tiles that sweep all N tiles, so a
// wave of 132 blocks shares ~16 A and ~8 B panels in L2; in plain row
// order each wave read all of B, which at the FFN shape (50 MB of B)
// does not stay in the 50 MB L2.
constexpr int kGroupM = 16;

template <int BN>
constexpr int gemm_smem_bytes() {
  return kStages * (kABytes + BN * kBK * 2) + 2 * kStages * 8 + 1024;
}

// One block owns a 128 x BN output tile, in kGroupM's grouped order.
// Warpgroup 2 is the producer: one thread keeps up to kStages (A 128 x
// 64, B 64 x BN) stages in flight by TMA, each stage with a full and an
// empty mbarrier.
// Warpgroups 0 and 1 each own 64 rows: per stage four m64nBNk16 wgmmas
// (A K-major, B MN-major through the transpose bit), f32 accumulators in
// registers, the stage released once the next stage's products are
// issued and the previous ones retired.  One rounding to bf16 at the end.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
gemm_bf16_wgmma(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                __nv_bfloat16* __restrict__ c, int N, int K) {
  constexpr int kBBytes = BN * kBK * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sa = smem;                              // kStages x 16 KB
  uint8_t* sb = smem + kStages * kABytes;          // kStages x kBBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int n_m = gridDim.y, n_n = gridDim.x;
  const int id = blockIdx.y * n_n + blockIdx.x;
  const int first = id / (kGroupM * n_n) * kGroupM;   // the group's row tile
  const int rows = min(n_m - first, kGroupM);
  const int m0 = (first + id % (kGroupM * n_n) % rows) * kBM;
  const int n0 = id % (kGroupM * n_n) / rows * BN;
  const int n_k = K / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);                     // one arrive a consumer
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                                   // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], kABytes + kBBytes);
        tma_load_2d(sa + s * kABytes, &ta, &full[s], kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(sb + s * kBBytes + j * 8192, &tb, &full[s],
                      n0 + 64 * j, kt * kBK);
      }
    }
  } else {                                         // consumers
    regs_alloc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint8_t* a = sa + s * kABytes + wg * 64 * 128;
      const uint8_t* b = sb + s * kBBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = smem_desc(a + 32 * kk, 16, 1024);
        const uint64_t db = smem_desc(b + 2048 * kk, 8192, 1024);
        if constexpr (BN == 256) wgmma_ss_n256<1>(acc, da, db, 1);
        else wgmma_ss_n128<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();                             // the previous stage's
      fence_regs(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt + kStages - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int t = threadIdx.x % 128;
    const int row = m0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const long long r = row + 8 * ((i / 2) % 2);
      *reinterpret_cast<uint32_t*>(c + r * N + col + 8 * (i / 4)) =
          pack_bf16(acc[i], acc[i + 1]);
    }
  }
}

template <int BN>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t stream) {
  // A (M, K) and B (K, N), row-major: innermost dimension first
  CUtensorMap ta, tb;
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t stride_a[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box_a[2] = {kBK, kBM};
  const cuuint64_t dims_b[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K)};
  const cuuint64_t stride_b[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box_b[2] = {64, kBK};
  int err = encode_bf16_map(&ta, a, 2, dims_a, stride_a, box_a);
  if (!err) err = encode_bf16_map(&tb, b, 2, dims_b, stride_b, box_b);
  if (err) return err;
  constexpr int smem = gemm_smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      gemm_bf16_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / BN, M / kBM);
  gemm_bf16_wgmma<BN><<<grid, kWgThreads, smem, stream>>>(
      ta, tb, static_cast<__nv_bfloat16*>(c), N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A · B for row-major A (M, K), B (K, N) and C (M, N) of the working
// type `dtype` (DType; the output is int32 for int8), all memory of CUDA
// device `device`.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int gemm(int dtype, const void* a, const void* b, void* c, int M,
                    int N, int K, int bn, int device, void* stream) {
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
      // the wgmma path's tiles: M % 128, K % 64, N % bn, bn 128 or 256
      if (M % kBM || K % kBK || (bn != 128 && bn != 256) || N % bn)
        return static_cast<int>(cudaErrorInvalidValue);
      return bn == 256 ? launch_bf16<256>(a, b, c, M, N, K, s)
                       : launch_bf16<128>(a, b, c, M, N, K, s);
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
