// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// repro/kernels/flash_attention.py::_flash_kernel.  Same function, for q
// (B, Sq, H, hd) and k/v (B, Sk, KV, hd) with H = KV * G (query head h
// reads kv head h / G):
//
//     s_ij = (q_i . k_j) * scale, in f32; -1e30 where masked
//     per tile of keys: m' = max(m, max_j s_ij); p_ij = exp(s_ij - m');
//     l = l * exp(m - m') + sum_j p_ij;
//     acc = acc * exp(m - m') + sum_j round(p_ij) * v_j      (f32)
//     out_i = acc / max(l, 1e-30), cast to q's type
//
// with p rounded to v's type before the PV product, as the TPU kernel's
// p.astype(v.dtype).  The causal mask is top-left aligned on global
// indices (query i sees keys j <= i).
//
// Two kernels, chosen by the wrapper by dtype and head dim:
//
//   * bf16 with hd 64, 96, 112, 128 or 192 (flash_bf16_wgmma): one
//     block of three warpgroups a (128 query rows, head, batch).  One
//     producer thread loads Q once and a ring of K and V tiles by TMA
//     into mbarrier stages, so loads cost the consumers no instruction
//     and the next tile arrives while this one is used; S = Q·Kᵀ and
//     O += P·V are warpgroup wgmma products on the tensor cores (P from
//     registers, V read in place through the transpose bit), with the
//     online softmax on the accumulator registers between them.  Keys
//     past Sk and above the diagonal are masked to -1e30 in registers;
//     tiles wholly above it are never loaded.  Tiles are 64-column
//     boxes: hd 96 and 112 (phi-3-vision's and zamba2's heads) take two,
//     the second read past hd, where TMA fills zeros, so S runs only
//     hd / 16 k-steps and P·V writes zero columns that are never
//     stored; hd 192 (nemotron-4-340b's) takes three, with tiles of 64
//     keys so that the ring fits the block's shared memory.
//   * everything else (f32; bf16 with another hd <= 256) (flash_kernel):
//     register-tiled on the SM's f32 cores (f32 stays true f32).  A block
//     of 256 threads owns 128 query rows of one head (64 past hd 128) and
//     walks 64-key tiles with Q, one K and one V tile in shared memory;
//     a thread computes an 8 x 4 (4 x 4) piece of S = Q·Kᵀ and keeps an
//     8 (4) row piece of O in registers, every product reading 4-wide
//     vectors along its sum, so that a load feeds 4 FMAs a row or key it
//     meets; a row's max over a tile takes 4 shuffles among its 16
//     threads.  cp.async brings V_t while S is computed and K_t+1 while
//     the softmax and P·V_t run.  Head dims are planned in classes of
//     32 (hd rounded up; the columns past hd are zeros).
//
// Both mask keys past Sk (the ragged tail that the JAX wrapper sends to
// its reference instead) like any other masked score, so any Sk runs
// here, and skip the tiles wholly above a row's diagonal, which the TPU
// kernel visits to no effect: p = exp(-1e30 - m) = 0 and the correction
// exp(m - m) = 1 there.
//
// Bound: operations.  At llama3.2-3b width (S = 4,096, H = 24, KV = 8,
// hd = 128, causal, bf16) the kernel must do 103 GFLOP, 0.104 ms at 989
// TFLOP/s, against 67 MB of q, k, v and out (0.020 ms at 3.35 TB/s); at
// nemotron-4-340b's (H = 96, KV = 8, hd = 192) 619 GFLOP, 0.626 ms,
// against 327 MB.  The padded columns of hd 96 and 112 cost P·V a third
// and a seventh more tensor work than the bound counts.  In f32 at
// phi-3-vision-4.2b width (H = KV = 32, hd = 96) the SIMT kernel must do
// 103 GFLOP, 1.539 ms at 67 TFLOP/s on the SM's f32 cores.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

// ---- bf16, hd 64, 96, 112, 128 or 192: TMA + wgmma ---------------------
constexpr int kRows = 128;              // query rows of a block
constexpr int kTcThreads = 384;         // 2 consumer warpgroups + producer
constexpr float kLog2e = 1.4426950408889634f;
// stages of the hd-192 ring: 3 take 192 KB of shared memory, 2 144 KB
constexpr int kStages192 = 3;

// The tile plan of a head dim: hd rounded up to whole 64-column boxes
// (TMA fills the columns past hd with zeros), keys a tile and stages of
// the (K, V) ring.  hd 192 takes 64-key tiles: Q and two stages of
// 128-key tiles would need 240 KB, over the 227 KB a block may have.
template <int HD>
struct TcPlan {
  static constexpr int kBoxes = (HD + 63) / 64;
  static constexpr int kPad = 64 * kBoxes;          // columns of a tile
  static constexpr int kKv = HD > 128 ? 64 : 128;   // keys of a tile
  static constexpr int kStages = HD > 128 ? kStages192 : 2;
  static constexpr int kQBox = kRows * 128;         // bytes of a Q box
  static constexpr int kKvBox = kKv * 128;          // of a K or V box
  static constexpr int kQTile = kBoxes * kQBox;
  static constexpr int kKvTile = kBoxes * kKvBox;
  static constexpr int kSmem =                      // Q, the ring, barriers
      kQTile + 2 * kStages * kKvTile + (1 + 3 * kStages) * 8 + 1024;
};

// One block owns 128 query rows of one head h of one batch b; warpgroups
// 0 and 1 own 64 rows each, warpgroup 2 is the producer: one thread
// loads Q once and keeps the stages of (K, V) tiles of kv head h / G in
// flight, all by TMA through 4-D tensor maps (hd, heads, S, B), so a box
// past Sq, Sk or hd is zero-filled rather than read from the next row,
// head or batch.  Per tile a consumer computes S = Q·Kᵀ (m64nKVk16, both
// K-major, over the hd / 16 k-steps that hold data), masks and scales it
// in registers (log2 domain), updates its rows' max and sum through the
// 4 threads that share a row, rounds p = exp(s - m') to bf16 into the A
// operand of O += P·V (m64nPADk16, A from registers, V MN-major through
// the transpose bit), and releases the stage.  Causal query tiles run in
// reverse order, longest first.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bf16_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                 int KV, float scale_log2, int causal) {
  using P = TcPlan<HD>;
  constexpr int kKv = P::kKv, kSt = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* sk = sq + P::kQTile;          // kSt stages
  uint8_t* sv = sk + kSt * P::kKvTile;   // kSt stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kSt * P::kKvTile);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;           // [kSt]
  uint64_t* v_full = bars + 1 + kSt;     // [kSt]
  uint64_t* empty = bars + 1 + 2 * kSt;  // [kSt]

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int kv_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_kt = (kv_end + kKv - 1) / kKv;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);           // one arrive a consumer
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, P::kQTile);
#pragma unroll
      for (int c = 0; c < P::kBoxes; ++c)
        tma_load_4d(sq + c * P::kQBox, &tq, q_full, 64 * c, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kSt;
        if (kt >= kSt) mbar_wait(&empty[s], ((kt / kSt) + 1) & 1);
        mbar_expect_tx(&k_full[s], P::kKvTile);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load_4d(sk + s * P::kKvTile + c * P::kKvBox, &tk, &k_full[s],
                      64 * c, kvh, kt * kKv, b);
        mbar_expect_tx(&v_full[s], P::kKvTile);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load_4d(sv + s * P::kKvTile + c * P::kKvBox, &tv, &v_full[s],
                      64 * c, kvh, kt * kKv, b);
      }
    }
  } else {                               // consumers
    regs_alloc<232>();
    const int t = threadIdx.x % 128;
    const int row = q0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and +8
    float o[P::kPad / 2];
#pragma unroll
    for (int i = 0; i < P::kPad / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    const uint8_t* qa = sq + wg * 64 * 128;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kSt;
      const uint32_t ph = (kt / kSt) & 1;
      const int k0 = kt * kKv;
      const uint8_t* ks = sk + s * P::kKvTile;
      float sc[kKv / 2];
      mbar_wait(&k_full[s], ph);
      fence_regs(sc);
      wgmma_fence();
      // the k-steps past hd would multiply zeros: skipped
#pragma unroll
      for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
        const int col = 32 * (kk % 4);   // bytes into the box's rows
        const uint64_t da =
            smem_desc(qa + (kk / 4) * P::kQBox + col, 16, 1024);
        const uint64_t db =
            smem_desc(ks + (kk / 4) * P::kKvBox + col, 16, 1024);
        if constexpr (kKv == 128) wgmma_ss_n128<0>(sc, da, db, kk > 0);
        else wgmma_ss_n64<0>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale into the log2 domain; mask keys past Sk and above the
      // diagonal (only the tiles that reach either need the test)
      const bool edge = k0 + kKv > Sk || (causal && k0 + kKv - 1 > q0);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kKv / 2; ++i) {
        const int j = k0 + 8 * (i / 4) + 2 * (t % 4) + i % 2;
        const int r = row + 8 * ((i / 2) % 2);
        float v = sc[i] * scale_log2;
        if (edge && (j >= Sk || (causal && j > r))) v = kNegInf;
        sc[i] = v;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
      }
      float corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kAll, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kAll, mx[e], 2));
        corr[e] = exp2f(m_run[e] - mx[e]);
        m_run[e] = mx[e];
        l_run[e] *= corr[e];
      }
      uint32_t pa[kKv / 16][4];
#pragma unroll
      for (int i = 0; i < kKv / 2; i += 2) {
        const int e = (i / 2) % 2;
        const float p0 = exp2f(sc[i] - mx[e]);
        const float p1 = exp2f(sc[i + 1] - mx[e]);
        l_run[e] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
      // the columns past hd hold zeros: nothing to rescale
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];

      mbar_wait(&v_full[s], ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        const uint64_t dv =
            smem_desc(sv + s * P::kKvTile + 2048 * kk, P::kKvBox, 1024);
        if constexpr (P::kPad == 64) wgmma_rs_n64(o, pa[kk], dv);
        else if constexpr (P::kPad == 128) wgmma_rs_n128(o, pa[kk], dv);
        else wgmma_rs_n192(o, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (t == 0) mbar_arrive(&empty[s]);
    }

    // the row sums over the 4 threads of a row, then one rounding
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[e] += __shfl_xor_sync(kAll, l_run[e], 1);
      l_run[e] += __shfl_xor_sync(kAll, l_run[e], 2);
      l_run[e] = 1.f / fmaxf(l_run[e], 1e-30f);
    }
    // o[i] for i < HD / 2 holds exactly the columns d < hd; d and hd are
    // even, so each 4-byte pair lies whole inside the row
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int e = (i / 2) % 2, r = row + 8 * e;
      if (r < Sq) {
        const int d = 8 * (i / 4) + 2 * (t % 4);
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<long long>(b) * Sq + r) * H + h) * HD + d) =
            pack_bf16(o[i] * l_run[e], o[i + 1] * l_run[e]);
      }
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, float scale, int causal,
              cudaStream_t stream) {
  using P = TcPlan<HD>;
  // (B, S, heads, hd) contiguous: dims innermost first, byte strides;
  // the true hd as dim 0, so that boxes past it read zeros
  CUtensorMap tq, tk, tv;
  const cuuint32_t qbox[4] = {64, 1, kRows, 1};
  const cuuint32_t kvbox[4] = {64, 1, P::kKv, 1};
  const cuuint64_t dq[4] = {HD, static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(Sq),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t sq[3] = {HD * 2, static_cast<cuuint64_t>(H) * HD * 2,
                            static_cast<cuuint64_t>(Sq) * H * HD * 2};
  const cuuint64_t dkv[4] = {HD, static_cast<cuuint64_t>(KV),
                             static_cast<cuuint64_t>(Sk),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t skv[3] = {HD * 2, static_cast<cuuint64_t>(KV) * HD * 2,
                             static_cast<cuuint64_t>(Sk) * KV * HD * 2};
  constexpr CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode_tensor_map(&tq, bf16, q, 4, dq, sq, qbox);
  if (!err) err = encode_tensor_map(&tk, bf16, k, 4, dkv, skv, kvbox);
  if (!err) err = encode_tensor_map(&tv, bf16, v, 4, dkv, skv, kvbox);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_bf16_wgmma<HD><<<grid, kTcThreads, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---- everything else: the register-tiled SIMT kernel -----------------
constexpr int kSimtThreads = 256;      // 16 x 16 threads
constexpr int kSimtKeys = 64;          // keys of a tile

// The tile plan of a padded head dim DP (hd rounded up to 32; the columns
// past hd are zeros in shared memory): query rows of a block (a thread
// owns kRT of them), the width and count of the column vectors of O a
// thread owns, and the rows of the Q, K and V tiles in shared memory in
// T (f32 or bf16), each padded by 16 bytes so that the rows a warp reads
// at one column lie in distinct banks.  Past DP 128, 64 rows, so that Q,
// K, V and P fit 227 KB and O 64 registers a thread.
template <typename T, int DP>
struct SimtPlan {
  static constexpr int kRows = DP > 128 ? 64 : 128;
  static constexpr int kRT = kRows / 16;
  static constexpr int kVW = DP % 64 == 0 ? 4 : 2;
  static constexpr int kNV = DP / (16 * kVW);
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kLp = kSimtKeys + 4;         // P, f32
  static constexpr int kSmem =
      (kRows + 2 * kSimtKeys) * kLd * static_cast<int>(sizeof(T))
      + kRows * kLp * 4;
};

// One block owns kRows query rows of one head h of one batch b and walks
// the 64-key tiles of kv head h / G up to its last row's diagonal (all of
// them when not causal), with Q, one K tile and one V tile in shared
// memory: V_t arrives by cp.async while S = Q·K_tᵀ is computed, K_t+1
// while the softmax and O += P·V_t are.  Thread (ty, tx) owns rows
// ty + 16i (i < kRT) and, of S, keys tx + 16c (c < 4), of O, columns
// kVW·tx + 16·kVW·v + w: both products read 4-wide vectors along their
// sum (Q and K rows along d, P rows along the keys, V rows along d), so
// each vector feeds 4 FMAs a row or key it meets.  The 16 threads of a
// row are 16 lanes of one warp: its max over a tile takes 4 shuffles,
// its sum only at the end.  Scores in the log2 domain; keys past Sk and
// above the diagonal -1e30 in registers, on the tiles that reach them.
template <typename T, int DP>
__global__ void __launch_bounds__(kSimtThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int hd, float scale_log2, int causal, int vec) {
  using P = SimtPlan<T, DP>;
  constexpr int kRows = P::kRows, kRT = P::kRT, kVW = P::kVW, kNV = P::kNV;
  constexpr int kLd = P::kLd, kLp = P::kLp;
  extern __shared__ __align__(16) uint8_t simt_smem[];
  T* Qs = reinterpret_cast<T*>(simt_smem);             // [kRows][kLd]
  T* Ks = Qs + kRows * kLd;                            // [64][kLd]
  T* Vs = Ks + kSimtKeys * kLd;                        // [64][kLd]
  float* Ps = reinterpret_cast<float*>(Vs + kSimtKeys * kLd);  // [kRows][kLp]

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int qi = blockIdx.x / H, h = blockIdx.x % H;
  const int qt = causal ? n_qt - 1 - qi : qi;          // longest first
  const int b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int n_keys = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_kt = (n_keys + kSimtKeys - 1) / kSimtKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = warp * 2 + lane / 16, tx = lane % 16;
  const int hd4 = (hd + 3) / 4 * 4;

  const long long q_stride = static_cast<long long>(H) * hd;
  const long long kv_stride = static_cast<long long>(KV) * hd;
  const T* qg = q + (static_cast<long long>(b) * Sq + q0) * q_stride
                + static_cast<long long>(h) * hd;
  const long long kv0 = static_cast<long long>(b) * Sk * kv_stride
                        + static_cast<long long>(kvh) * hd;

  // the columns past hd of every Q, K and V row stay zero
  for (int e = threadIdx.x; e < (kRows + 2 * kSimtKeys) * (DP - hd);
       e += kSimtThreads) {
    const int r = e / (DP - hd);
    Qs[r * kLd + hd + e % (DP - hd)] = T(0.f);
  }
  load_rows(Qs, kLd, qg, q_stride, kRows, Sq - q0, hd, vec, threadIdx.x,
            kSimtThreads);
  load_rows(Ks, kLd, k + kv0, kv_stride, kSimtKeys, Sk, hd, vec, threadIdx.x,
            kSimtThreads);
  cp_async_commit();

  float o[kRT][kNV][kVW];
  float m_run[kRT], l_run[kRT];
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
      for (int w = 0; w < kVW; ++w) o[i][nv][w] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int j0 = t * kSimtKeys;
    cp_async_wait<0>();
    __syncthreads();                   // K_t landed; V and P are free
    load_rows(Vs, kLd, v + kv0 + j0 * kv_stride, kv_stride, kSimtKeys,
              Sk - j0, hd, vec, threadIdx.x, kSimtThreads);
    cp_async_commit();

    float s[kRT][4];
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd4; d += 4) {   // the zero columns past hd4 add 0
      float kr[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) ld_vec(kr[c], Ks + (tx + 16 * c) * kLd + d);
#pragma unroll
      for (int i = 0; i < kRT; ++i) {
        float qr[4];
        ld_vec(qr, Qs + (ty + 16 * i) * kLd + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) s[i][c] = fmaf(qr[u], kr[c][u], s[i][c]);
      }
    }
    __syncthreads();                   // K_t is consumed
    if (t + 1 < n_kt)
      load_rows(Ks, kLd, k + kv0 + (j0 + kSimtKeys) * kv_stride, kv_stride,
                kSimtKeys, Sk - j0 - kSimtKeys, hd, vec, threadIdx.x,
                kSimtThreads);
    cp_async_commit();

    // only the tiles that reach past Sk or above a row's diagonal mask
    const bool edge = j0 + kSimtKeys > Sk
                      || (causal && j0 + kSimtKeys - 1 > q0);
#pragma unroll
    for (int i = 0; i < kRT; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = m_run[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 16 * c;
        float x = s[i][c] * scale_log2;
        if (edge && (j >= Sk || (causal && j > r))) x = kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
      const float corr = ex2_sfu(m_run[i] - mx);
      m_run[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ex2_sfu(s[i][c] - mx);
        sum += p;
        Ps[(ty + 16 * i) * kLp + tx + 16 * c] = round_to<T>(p);
      }
      l_run[i] = l_run[i] * corr + sum;
#pragma unroll
      for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
        for (int w = 0; w < kVW; ++w) o[i][nv][w] *= corr;
    }
    cp_async_wait<1>();
    __syncthreads();                   // V_t landed; P is whole

#pragma unroll 2
    for (int jj = 0; jj < kSimtKeys; jj += 4) {
      float pr[kRT][4];
#pragma unroll
      for (int i = 0; i < kRT; ++i)
        ld_vec(pr[i], Ps + (ty + 16 * i) * kLp + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vr[kNV][kVW];
#pragma unroll
        for (int nv = 0; nv < kNV; ++nv)
          ld_vec(vr[nv], Vs + (jj + u) * kLd + kVW * tx + 16 * kVW * nv);
#pragma unroll
        for (int i = 0; i < kRT; ++i)
#pragma unroll
          for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
            for (int w = 0; w < kVW; ++w)
              o[i][nv][w] = fmaf(pr[i][u], vr[nv][w], o[i][nv][w]);
      }
    }
  }

  // the row sums over the 16 threads of a row, then one rounding
#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l += __shfl_xor_sync(kAll, l, off);
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<long long>(b) * Sq + r) * q_stride
              + static_cast<long long>(h) * hd;
#pragma unroll
    for (int nv = 0; nv < kNV; ++nv)
#pragma unroll
      for (int w = 0; w < kVW; ++w) {
        const int d = kVW * tx + 16 * kVW * nv + w;
        if (d < hd) orow[d] = from_float<T>(o[i][nv][w] * inv);
      }
  }
}

template <typename T, int DP>
int launch_simt_dp(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int hd, float scale,
                   int causal, cudaStream_t stream) {
  using P = SimtPlan<T, DP>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 16-byte copies where every row of q, k and v starts 16-byte aligned
  const bool vec = (hd * sizeof(T)) % 16 == 0
                   && (reinterpret_cast<uintptr_t>(q)
                       | reinterpret_cast<uintptr_t>(k)
                       | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const long long n_x = static_cast<long long>((Sq + P::kRows - 1) / P::kRows)
                        * H;
  if (n_x > 0x7fffffffLL || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_x), B);
  flash_kernel<T, DP><<<grid, kSimtThreads, P::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, hd,
      scale * kLog2e, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// The SIMT kernel of q's head-dim class: hd rounded up to 32.
template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int KV, int hd, float scale,
                int causal, cudaStream_t stream) {
#define FLASH_SIMT_DP(DP)                                                 \
  case DP:                                                                \
    return launch_simt_dp<T, DP>(q, k, v, out, B, Sq, Sk, H, KV, hd,      \
                                 scale, causal, stream);
  switch ((hd + 31) / 32 * 32) {
    FLASH_SIMT_DP(32)
    FLASH_SIMT_DP(64)
    FLASH_SIMT_DP(96)
    FLASH_SIMT_DP(128)
    FLASH_SIMT_DP(160)
    FLASH_SIMT_DP(192)
    FLASH_SIMT_DP(224)
    FLASH_SIMT_DP(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_SIMT_DP
}

}  // namespace

// out = attention of q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all
// contiguous of working type `dtype` (DType: f32 or bf16) on CUDA device
// `device`; H % KV == 0, 1 <= hd <= 256, Sk >= 1.  Launches on `stream`
// and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int H, int KV, int hd, float scale,
                               int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd < 1 || hd > kMaxHd || KV <= 0 || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_simt<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale,
                                causal, s);
    case kBF16:
      return launch_simt<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                        scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same attention for bf16 q, k, v with hd 64, 96, 112, 128 or 192,
// through the TMA + wgmma kernel; B, H <= 65535, every pointer 16-byte
// aligned.  Returns the launch's cudaError_t, or hopper.cuh's codes when
// a tensor map cannot be encoded.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Sq, int Sk, int H, int KV,
                                          int hd, float scale, int causal,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV <= 0 || H % KV || Sk < 1 || Sq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_tc<64>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, s);
    case 96:
      return launch_tc<96>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, s);
    case 112:
      return launch_tc<112>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            s);
    case 128:
      return launch_tc<128>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            s);
    case 192:
      return launch_tc<192>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
