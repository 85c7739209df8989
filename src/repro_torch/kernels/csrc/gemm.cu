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
// at 1979 TOP/s int8.  One kernel a working type, blocks taken in groups
// of kGroupM row tiles for L2 reuse:
//
//   * bf16 (gemm_bf16_wgmma): 128 x BN output blocks, BN 256 where N_eff
//     divides by it, else 128; the padded grid is always whole tiles,
//     since every bf16 policy has tm, tn, tk >= 128.  Loads are issued by
//     one producer thread as TMA boxes into a 4-stage mbarrier ring, so
//     no consumer thread spends an instruction on a load and up to three
//     stages are in flight while one is multiplied; products are
//     warpgroup wgmma m64nBNk16 straight from the swizzled tiles, the
//     only instruction that reaches the tensor cores' full rate.  B is
//     read in its (K, N) layout through the transpose bit: no copy.
//   * int8 (transpose_s8, then gemm_s8_wgmma): the bf16 kernel's design
//     with both operands K-major, since wgmma takes 8-bit operands only
//     so.  A hand-written pre-pass on the same stream turns B (K, N) into
//     Bt (N, K) in a scratch buffer the wrapper allocates (at the FFN
//     shape 25 MB read and written, ~15 us at 3.35 TB/s).  A 128-byte
//     stage row holds 128 int8 values, so the ring has the bf16 ring's
//     byte geometry (A 128 x 128 B, Bt BN x 128 B) with twice the K a
//     stage, multiplied by four m64nBNk32 s8 wgmmas; the int32 sums are
//     exact (|a·b| <= 2^14, so K_eff up to 2^17) and stored as they are.
//     The tiles must be whole: M_eff, N_eff, K_eff multiples of 128.
//   * f32 (gemm_f32_simt): true f32 FMAs on the SM's cores, since the
//     tensor cores take f32 only as TF32, whose 10-bit mantissa misses
//     the reference's rtol 1e-3 near zero.  128 x 128 blocks of 8 x 8
//     outputs a thread, K slabs of 16 copied by cp.async into a 4-stage
//     ring (the next three slabs load while one is multiplied, one
//     barrier a slab), fragments read as 16-byte shared loads free of
//     bank conflicts, 16 FMAs a load.  It zero-fills past M, N and K, so
//     it takes any shape; 16-byte copies and float4 stores where K and N
//     divide by 4, 4-byte ones elsewhere.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Blocks run in groups of kGroupM row tiles that sweep all N tiles, so a
// wave of 132 blocks shares ~16 A and ~8 B panels in L2; in plain row
// order each wave read all of B, which at the FFN shape (50 MB of B)
// does not stay in the 50 MB L2.
constexpr int kGroupM = 16;

// The (row tile, column tile) of this block in kGroupM's grouped order,
// for a grid of (column tiles, row tiles).
__device__ __forceinline__ int2 grouped_tile() {
  const int n_m = gridDim.y, n_n = gridDim.x;
  const int id = blockIdx.y * n_n + blockIdx.x;
  const int first = id / (kGroupM * n_n) * kGroupM;   // the group's row tile
  const int rows = min(n_m - first, kGroupM);
  const int in_group = id % (kGroupM * n_n);
  return make_int2(first + in_group % rows, in_group / rows);
}

// ---- f32: pipelined SIMT ---------------------------------------------
constexpr int kFM = 128;              // output rows of a block
constexpr int kFN = 128;              // output columns of a block
constexpr int kFK = 16;               // K depth of a slab
constexpr int kFAS = kFK + 4;         // A row in shared memory, padded
constexpr int kFStages = 4;           // ring of (A, B) slabs
constexpr int kFThreads = 256;        // 16 x 16 threads
constexpr int kFCols = kFN / 16;      // outputs a thread along N
constexpr int kFSmem = kFStages * (kFM * kFAS + kFK * kFN) * 4;

// Copies slab k0 of A (128 x 16, rows as in global memory, padded to 20)
// and B (16 x kFN) into one stage by cp.async, zero-filling past M, N and
// K.  kVec: K and N divide by 4 and the operands are 16-byte aligned, so
// each 4-value chunk lies wholly inside or outside and moves as one
// 16-byte copy; else value by value.
template <bool kVec>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           const float* base, int in) {
  if constexpr (kVec) {
    cp_async16(dst, in > 0 ? src : base, in > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cp_async4(dst + e, e < in ? src + e : base, e < in ? 4 : 0);
  }
}

template <bool kVec>
__device__ __forceinline__ void load_f32_slab(float* as, float* bs,
                                              const float* a,
                                              const float* b, int m0,
                                              int n0, int k0, int M, int N,
                                              int K) {
#pragma unroll
  for (int j = 0; j < kFM * kFK / 4 / kFThreads; ++j) {
    const int c = threadIdx.x + j * kFThreads;
    const int r = c / 4, gk = k0 + 4 * (c % 4);     // A: row, first k
    const int in = m0 + r < M ? K - gk : 0;         // values inside
    copy_chunk<kVec>(as + r * kFAS + 4 * (c % 4),
                     a + static_cast<long long>(m0 + r) * K + gk, a, in);
  }
#pragma unroll
  for (int j = 0; j < kFK * kFN / 4 / kFThreads; ++j) {
    const int c = threadIdx.x + j * kFThreads;
    const int r = c / (kFN / 4), gn = n0 + 4 * (c % (kFN / 4));
    const int in = k0 + r < K ? N - gn : 0;         // B: k row, first col
    copy_chunk<kVec>(bs + r * kFN + 4 * (c % (kFN / 4)),
                     b + static_cast<long long>(k0 + r) * N + gn, b, in);
  }
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block owns a 128 x kFN output tile, in kGroupM's grouped order.
// Thread (tx, ty) owns rows ty + 16i (i < 8) and columns 64h + 4tx..
// 64h + 4tx + 3.  A warp is 8 x 4 threads: each quarter-warp (8 lanes)
// shares one A address (a broadcast) and reads 8 consecutive float4 of a
// B row (128 bytes); the warp's 4 A rows are consecutive, and the padded
// A row (20 floats) puts them on 4 disjoint groups of 4 banks.  Per 4 k,
// 8 A loads (4 k of a row each) and kFCols B loads feed 32·kFCols FMAs:
// 16 FMAs a load at kFN = 128.
template <bool kVec>
__global__ void __launch_bounds__(kFThreads, 1)
gemm_f32_simt(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int M, int N, int K) {
  extern __shared__ __align__(16) float f32_smem[];
  float* as = f32_smem;                            // [stage][m][kFAS]
  float* bs = f32_smem + kFStages * kFM * kFAS;    // [stage][k][n]
  const int2 tile = grouped_tile();
  const int m0 = tile.x * kFM, n0 = tile.y * kFN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = warp % 2 * 8 + lane % 8, ty = warp / 2 * 4 + lane / 8;
  float acc[8][kFCols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kFCols; ++j) acc[i][j] = 0.f;

  const int n_k = (K + kFK - 1) / kFK;
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < n_k)
      load_f32_slab<kVec>(as + s * kFM * kFAS, bs + s * kFK * kFN, a, b, m0,
                          n0, s * kFK, M, N, K);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kFStages - 2>();    // this thread's copies of slab kt
    __syncthreads();                  // everyone's; slab kt - 1 is done
    const int nt = kt + kFStages - 1;     // into the stage kt - 1 used
    if (nt < n_k)
      load_f32_slab<kVec>(as + nt % kFStages * kFM * kFAS,
                          bs + nt % kFStages * kFK * kFN, a, b, m0, n0,
                          nt * kFK, M, N, K);
    cp_async_commit();
    const float* sa = as + kt % kFStages * kFM * kFAS;
    const float* sb = bs + kt % kFStages * kFK * kFN;
#pragma unroll
    for (int g = 0; g < kFK / 4; ++g) {
      float4 ar[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ar[i] = *reinterpret_cast<const float4*>(
            sa + (ty + 16 * i) * kFAS + 4 * g);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* row = sb + (4 * g + kk) * kFN + 4 * tx;
        float br[kFCols];
#pragma unroll
        for (int h = 0; h < kFCols / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(row + 64 * h);
          br[4 * h] = v.x, br[4 * h + 1] = v.y, br[4 * h + 2] = v.z,
          br[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = part(ar[i], kk);
#pragma unroll
          for (int j = 0; j < kFCols; ++j)
            acc[i][j] = fmaf(av, br[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    float* out = c + static_cast<long long>(gm) * N;
#pragma unroll
    for (int h = 0; h < kFCols / 4; ++h) {
      const int gn = n0 + 64 * h + 4 * tx;
      if constexpr (kVec) {
        if (gn < N)
          *reinterpret_cast<float4*>(out + gn) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gn + e < N) out[gn + e] = acc[i][4 * h + e];
      }
    }
  }
}

// ---- TMA + wgmma: the bf16 and int8 paths -----------------------------
constexpr int kBM = 128;                  // output rows of a block
constexpr int kBK = 64;                   // K depth of a bf16 stage: 128 B
constexpr int kS8BK = 128;                // K depth of an int8 stage: 128 B
constexpr int kStages = 4;                // ring of (A, B) stages
constexpr int kWgThreads = 384;           // 2 consumer warpgroups + producer
constexpr int kABytes = kBM * 128;        // 16 KB: one 128-row box

// A stage is A 128 x 128 B and B 128 B x BN (bf16 B 64 rows of BN
// values; int8 Bt BN rows of 128 values), so both paths share one size.
template <int BN>
constexpr int gemm_smem_bytes() {
  return kStages * (kABytes + BN * 128) + 2 * kStages * 8 + 1024;
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
  const int2 tile = grouped_tile();
  const int m0 = tile.x * kBM, n0 = tile.y * BN;
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

// Bt = Bᵀ for row-major int8 B (K, N), K and N multiples of 128: one
// block a 128 x 128-byte tile, numbered along N first.  Rows of B come in
// as 16-byte loads and go to shared memory as 16-byte stores; each thread
// then reads a 16 (k) x 4 (n) byte block as 16 words down a column of
// words, turns each 4 x 4 byte square with byte permutes, and writes 4
// rows of Bt 16 bytes each (a quarter-warp writes one 128-byte run).
// Padding cannot keep those column reads off one another's banks: the
// threads of a warp read rows 16 apart, and 16 row strides of any padded
// width fall on at most two bank offsets.  So the 16-byte chunks of row k
// are XOR-swizzled by k / 16 instead of padded, and both the row stores
// and the column reads are free of bank conflicts.
constexpr int kTT = 128;                  // transpose tile, bytes a side

__device__ __forceinline__ void transpose_4x4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

__global__ void __launch_bounds__(256)
transpose_s8(const int8_t* __restrict__ b, int8_t* __restrict__ bt, int K,
             int N) {
  __shared__ __align__(16) uint32_t tile[kTT][kTT / 4];   // [k][n / 4]
  const int n_tiles = N / kTT;
  const long long k0 = blockIdx.x / n_tiles * kTT;
  const long long n0 = blockIdx.x % n_tiles * kTT;
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = t / 8 + 32 * r, q = t % 8;       // bytes 16q..16q+15
    *reinterpret_cast<uint4*>(&tile[k][4 * (q ^ (k / 16))]) =
        *reinterpret_cast<const uint4*>(b + (k0 + k) * N + n0 + 16 * q);
  }
  __syncthreads();
  const int c = t % 8, w = t / 8;        // k 16c..16c+15, n 4w..4w+3
  uint32_t out[4][4];                    // [n - 4w][k / 4 - 4c]
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t sq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sq[i] = tile[16 * c + 4 * g + i][4 * ((w / 4) ^ c) + w % 4];
    transpose_4x4(sq);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j][g] = sq[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint4*>(bt + (n0 + 4 * w + j) * K + k0 + 16 * c) =
        make_uint4(out[j][0], out[j][1], out[j][2], out[j][3]);
}

// The bf16 kernel's ring and warpgroups on int8: a stage is A 128 x 128
// and Bt BN x 128 values, both one TMA box, multiplied by four m64nBNk32
// s8 wgmmas with both descriptors K-major (32 bytes a step, SBO 1024);
// s32 accumulators, whose fragment is the f32 one, stored as int32 pairs
// (8-byte writes) straight from the registers.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
gemm_s8_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tbt, int* __restrict__ c,
              int N, int K) {
  constexpr int kBBytes = BN * kS8BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* sa = smem;                              // kStages x 16 KB
  uint8_t* sb = smem + kStages * kABytes;          // kStages x kBBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kBBytes);
  uint64_t* empty = full + kStages;
  const int2 tile = grouped_tile();
  const int m0 = tile.x * kBM, n0 = tile.y * BN;
  const int n_k = K / kS8BK;
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
        tma_load_2d(sa + s * kABytes, &ta, &full[s], kt * kS8BK, m0);
        tma_load_2d(sb + s * kBBytes, &tbt, &full[s], kt * kS8BK, n0);
      }
    }
  } else {                                         // consumers
    regs_alloc<232>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint8_t* a = sa + s * kABytes + wg * 64 * 128;
      const uint8_t* b = sb + s * kBBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kS8BK / 32; ++kk) {
        const uint64_t da = smem_desc(a + 32 * kk, 16, 1024);
        const uint64_t db = smem_desc(b + 32 * kk, 16, 1024);
        if constexpr (BN == 256) wgmma_s8_n256(acc, da, db, 1);
        else wgmma_s8_n128(acc, da, db, 1);
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
      *reinterpret_cast<int2*>(c + r * N + col + 8 * (i / 4)) =
          make_int2(acc[i], acc[i + 1]);
    }
  }
}

template <bool kVec>
int launch_f32(const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      gemm_f32_simt<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  gemm_f32_simt<kVec><<<grid, kFThreads, kFSmem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
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
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_tensor_map(&ta, bf16, a, 2, dims_a, stride_a, box_a);
  if (!err) err = encode_tensor_map(&tb, bf16, b, 2, dims_b, stride_b, box_b);
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

int launch_transpose(const void* b, void* bt, int K, int N,
                     cudaStream_t stream) {
  transpose_s8<<<(K / kTT) * (N / kTT), 256, 0, stream>>>(
      static_cast<const int8_t*>(b), static_cast<int8_t*>(bt), K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_s8(const void* a, const void* b, void* bt, void* c, int M, int N,
              int K, cudaStream_t stream) {
  int err = launch_transpose(b, bt, K, N, stream);
  if (err) return err;
  // A (M, K) and Bt (N, K), row-major: innermost dimension first
  CUtensorMap ta, tbt;
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint64_t dims_a[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t dims_bt[2] = {static_cast<cuuint64_t>(K),
                                 static_cast<cuuint64_t>(N)};
  const cuuint32_t box_a[2] = {kS8BK, kBM};
  const cuuint32_t box_bt[2] = {kS8BK, BN};
  constexpr CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  err = encode_tensor_map(&ta, u8, a, 2, dims_a, stride, box_a);
  if (!err) err = encode_tensor_map(&tbt, u8, bt, 2, dims_bt, stride, box_bt);
  if (err) return err;
  constexpr int smem = gemm_smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      gemm_s8_wgmma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(N / BN, M / kBM);
  gemm_s8_wgmma<BN><<<grid, kWgThreads, smem, stream>>>(
      ta, tbt, static_cast<int*>(c), N, K);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// C = A · B for row-major A (M, K), B (K, N) and C (M, N) of the working
// type `dtype` (DType; the output is int32 for int8), all memory of CUDA
// device `device`.  `bn` is the wgmma paths' N tile (128 or 256); `bt`
// the int8 path's scratch for Bᵀ (N, K), else unused.  Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int gemm(int dtype, const void* a, const void* b, void* bt,
                    void* c, int M, int N, int K, int bn, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole_bn = (bn == 128 || bn == 256) && N % bn == 0;
  switch (dtype) {
    case kF32:
      return K % 4 == 0 && N % 4 == 0 && aligned16(a) && aligned16(b) &&
                     aligned16(c)
                 ? launch_f32<true>(a, b, c, M, N, K, s)
                 : launch_f32<false>(a, b, c, M, N, K, s);
    case kBF16:
      // the bf16 tiles: M % 128, K % 64, N % bn
      if (M % kBM || K % kBK || !whole_bn)
        return static_cast<int>(cudaErrorInvalidValue);
      return bn == 256 ? launch_bf16<256>(a, b, c, M, N, K, s)
                       : launch_bf16<128>(a, b, c, M, N, K, s);
    case kI8:
      // the int8 tiles: M % 128, K % 128, N % bn (and N % 128 for Bt)
      if (M % kBM || K % kS8BK || !whole_bn || bt == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      return bn == 256 ? launch_s8<256>(a, b, bt, c, M, N, K, s)
                       : launch_s8<128>(a, b, bt, c, M, N, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bt = Bᵀ alone for row-major int8 B (K, N), K and N multiples of 128:
// the int8 path's pre-pass, so that its time can be read apart from the
// GEMM's.  Same conventions as gemm().
extern "C" int gemm_transpose_s8(const void* b, void* bt, int K, int N,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K % kTT || N % kTT) return static_cast<int>(cudaErrorInvalidValue);
  return launch_transpose(b, bt, K, N, static_cast<cudaStream_t>(stream));
}
