// The backward of bf16 flash attention for Hopper (sm_90a), hd 64 or 128.
//
// Replaces no TPU kernel: the reference's Pallas flash kernel
// (repro/kernels/flash_attention.py::_flash_kernel) has no custom_vjp, so
// XLA differentiates the reference's blockwise jnp attention.  This is the
// backward of csrc/flash_attention.cu's forward, for q, o, dO (B, Sq, H,
// hd) and k/v (B, Sk, KV, hd) with H = KV * G (query head h reads kv head
// h / G), causal top-left aligned (query i sees keys j <= i):
//
//     s_ij = (q_i . k_j) * scale; P = softmax_j(s) (f32);
//     D_i = sum_d dO_id O_id; dP = dO . Vᵀ; dS = P ∘ (dP - D)  (f32)
//     dV = round(P)ᵀ . dO; dK = scale · round(dS)ᵀ . Q;
//     dQ = scale · round(dS) . K
//
// with P and dS rounded to bf16 before the products that take them (the
// forward rounds P so before P·V) and every sum in f32.  Three kernels, in
// this order on one stream, none with atomics, so two calls give bitwise
// equal gradients:
//
//   * flash_bwd_lse_d: a block a (128 query rows, head, batch) runs the
//     forward's S = Q·Kᵀ over the key tiles up to the diagonal with an
//     online max and sum, and writes each row's log-sum-exp (log2 domain,
//     of s·scale·log2 e) and D = rowsum(dO ∘ O) as f32 into `stats`
//     (2, B, H, Sq rounded up to 64; the rows past Sq hold 0).
//   * flash_bwd_dkdv: a block a (128 keys, kv head, batch), longest causal
//     tiles first, keeps K and V in shared memory and walks the G query
//     heads of its group and their 64-row query tiles from the diagonal
//     on (tiles wholly above it are skipped, not masked); per tile Sᵀ =
//     K·Qᵀ and dPᵀ = V·dOᵀ (both operands from shared memory), Pᵀ =
//     exp2(Sᵀ·scale·log2 e − LSE) and dSᵀ = Pᵀ ∘ (dPᵀ − D) in registers,
//     which are the A operands of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q
//     read in place through the transpose bit).  dK and dV sum over the
//     whole group in f32 and are written once.  At hd 128, where dK and
//     dV take 128 registers a thread, dPᵀ is computed while dV's product
//     runs, so that Sᵀ and dPᵀ are not held at once beside them.
//   * flash_bwd_dq: a block a (128 query rows, head, batch), longest
//     first, keeps Q and dO and walks the 64-key tiles up to the
//     diagonal: S and dP as above, then dQ += dS·K, written once.
//
// Each has the forward's shape: one producer thread keeps a ring of TMA
// tiles (128-byte-swizzled 64-column boxes of 4-D tensor maps (hd, heads,
// S, B), zero-filled past Sq, Sk) in flight on mbarriers; two consumer
// warpgroups of 64 rows each run the wgmma products and the elementwise
// work on their accumulators.  The dkdv ring also carries each query
// tile's 64 log-sum-exps and D values (a 256-byte bulk copy each).  The
// kernels mask the ragged edges of Sq and Sk and the diagonal themselves,
// on the tiles that reach them.  Split so, the backward runs 8 product
// passes over the causal pairs (1 for the log-sum-exp, 4 for dK and dV,
// 3 for dQ) against FlashAttention-2's 6, for gradients that need no
// atomics.
//
// Exponentials run on the SFU (ex2.approx, in the log2 domain): every
// kernel takes one a (query, key) pair, 3 a pair in all, which at 16 a
// clock an SM is ~1.8 ms of granite's layer below.
//
// Bound: operations.  At granite-3-2b's layer (B 8, S 4,096, H 32, KV 8,
// hd 64, causal) the 5 products a backward needs are 1.37 TFLOP, 1.39 ms
// at 989 TFLOP/s (the 8 passes here 2.20 TFLOP, 2.22 ms), against 671 MB
// of q, k, v, o, dO, dq, dk and dv (0.20 ms at 3.35 TB/s).  Measured on
// an H100 SXM at 700 W: 7.33 ms (log-sum-exp 1.64, dkdv 2.84, dq 2.10),
// 1.9x SDPA's backward (3.81 ms); at llama3.2-3b's (B 1, H 24, KV 8, hd
// 128) 1.16 ms, 1.25x SDPA's (0.93 ms).

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;          // rows of a block: queries, or keys
constexpr int kTile = 64;           // the other side's tile: keys, queries
constexpr int kThreads = 384;       // 2 consumer warpgroups + producer
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

// The tile plan of a head dim (64 or 128): whole 64-column boxes; a block
// holds two 128-row tiles (Q and dO, or K and V) and a ring of kStages
// pairs of 64-row tiles of the other side.
template <int HD>
struct BwdPlan {
  static constexpr int kBoxes = HD / 64;
  static constexpr int kRowBox = kRows * 128;       // bytes of a 128-row box
  static constexpr int kTileBox = kTile * 128;      // of a 64-row box
  static constexpr int kRowTile = kBoxes * kRowBox;
  static constexpr int kTileTile = kBoxes * kTileBox;
  static constexpr int kStages = HD == 64 ? 4 : 3;
  static constexpr int kStats = kTile * 4;          // 64 f32 a tile
  // lse_d: Q and a ring of K tiles
  static constexpr int kSmemLse =
      kRowTile + kStages * kTileTile + (1 + 2 * kStages) * 8 + 1024;
  // dq: Q, dO and a ring of (K, V); dkdv: K, V and a ring of (Q, dO,
  // their log-sum-exps and D)
  static constexpr int kSmemDq =
      2 * kRowTile + 2 * kStages * kTileTile + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kSmemDkdv =
      2 * kRowTile + kStages * (2 * kTileTile + 2 * kStats)
      + (1 + 2 * kStages) * 8 + 1024;
};

// S (64 x 64, f32) = A (64 rows of a 128-row tile, K-major) · B (a 64-row
// tile, K-major)ᵀ over hd: the k-th step of 16 columns lies in box k / 4,
// 32·(k % 4) bytes into its rows.
template <int HD>
__device__ __forceinline__ void mma_rows_by_tile(float (&d)[32],
                                                 const uint8_t* a,
                                                 const uint8_t* b) {
  using P = BwdPlan<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int col = 32 * (kk % 4);
    wgmma_ss_n64<0>(d, smem_desc(a + (kk / 4) * P::kRowBox + col, 16, 1024),
                    smem_desc(b + (kk / 4) * P::kTileBox + col, 16, 1024),
                    kk > 0);
  }
}

// D (64 x HD, f32) += A (64 x 64, bf16 pairs in registers) · B (a 64-row
// tile read MN-major: its rows are the sum's index, its columns hd).
template <int HD>
__device__ __forceinline__ void mma_regs_by_tile(float (&d)[HD / 2],
                                                 const uint32_t (&a)[4][4],
                                                 const uint8_t* b) {
  using P = BwdPlan<HD>;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint64_t db = smem_desc(b + 2048 * kk, P::kTileBox, 1024);
    if constexpr (HD == 64) wgmma_rs_n64(d, a[kk], db);
    else wgmma_rs_n128(d, a[kk], db);
  }
}

// Rows of (B, S, heads, HD) bf16 written from an m64nHD accumulator: the
// thread's rows r and r + 8 of `rows` (those < n), times `mul`.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&d)[HD / 2], int row,
                                           int n, long long base,
                                           long long stride, float mul,
                                           int t) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int r = row + 8 * ((i / 2) % 2);
    if (r < n) {
      const int c = 8 * (i / 4) + 2 * (t % 4);
      *reinterpret_cast<uint32_t*>(out + base + r * stride + c) =
          pack_bf16(d[i] * mul, d[i + 1] * mul);
    }
  }
}

// ---- 1. log-sum-exp and D ------------------------------------------------
// One block owns 128 query rows of head h of batch b (as the forward's):
// the consumers first compute D of the block's rows from O and dO (two
// threads a row, 16-byte loads), then S = Q·Kᵀ per 64-key tile with the
// online max and sum of the forward, and write lse = m + log2(l).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_lse_d(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ stats, int Sq, int Sk, int sq_pad, int H,
                int KV, int B, float scale_log2, int causal) {
  using P = BwdPlan<HD>;
  constexpr int kSt = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* sk = sq + P::kRowTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sk + kSt * P::kTileTile);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;           // [kSt]
  uint64_t* empty = bars + 1 + kSt;      // [kSt]

  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int kv_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_kt = (kv_end + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, P::kRowTile);
#pragma unroll
      for (int c = 0; c < P::kBoxes; ++c)
        tma_load_4d(sq + c * P::kRowBox, &tq, q_full, 64 * c, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kSt;
        if (kt >= kSt) mbar_wait(&empty[s], ((kt / kSt) + 1) & 1);
        mbar_expect_tx(&k_full[s], P::kTileTile);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load_4d(sk + s * P::kTileTile + c * P::kTileBox, &tk,
                      &k_full[s], 64 * c, kvh, kt * kTile, b);
      }
    }
  } else {                               // consumers
    regs_alloc<232>();
    float* lse_out = stats + static_cast<long long>(bh) * sq_pad;
    float* d_out = stats + (static_cast<long long>(B) * H + bh) * sq_pad;
    {
      // D: thread pair (2r, 2r + 1) sums row q0 + r, half a row each
      const int r = q0 + threadIdx.x / 2;
      const int half = threadIdx.x % 2;
      float acc = 0.f;
      if (r < Sq) {
        const long long off =
            (static_cast<long long>(b) * Sq + r) * H * HD +
            static_cast<long long>(h) * HD + half * (HD / 2);
        const uint4* po = reinterpret_cast<const uint4*>(o + off);
        const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
        for (int v = 0; v < HD / 16; ++v) {
          const uint4 a = po[v], g = pd[v];
          const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
          const uint32_t gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            acc = fmaf(__uint_as_float(aw[w] << 16),
                       __uint_as_float(gw[w] << 16), acc);
            acc = fmaf(__uint_as_float(aw[w] & 0xffff0000u),
                       __uint_as_float(gw[w] & 0xffff0000u), acc);
          }
        }
      }
      acc += __shfl_xor_sync(kAll, acc, 1);
      if (half == 0 && r < sq_pad) d_out[r] = acc;
    }

    const int t = threadIdx.x % 128;
    const int row = q0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and +8
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    const uint8_t* qa = sq + wg * 64 * 128;
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kSt;
      const int k0 = kt * kTile;
      float sc[32];
      mbar_wait(&k_full[s], (kt / kSt) & 1);
      fence_regs(sc);
      wgmma_fence();
      mma_rows_by_tile<HD>(sc, qa, sk + s * P::kTileTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (t == 0) mbar_arrive(&empty[s]);
      const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int j = k0 + 8 * (i / 4) + 2 * (t % 4) + i % 2;
        const int r = row + 8 * ((i / 2) % 2);
        float v = sc[i] * scale_log2;
        if (edge && (j >= Sk || (causal && j > r))) v = kNegInf;
        sc[i] = v;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kAll, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kAll, mx[e], 2));
        l_run[e] *= ex2_sfu(m_run[e] - mx[e]);
        m_run[e] = mx[e];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        l_run[(i / 2) % 2] += ex2_sfu(sc[i] - mx[(i / 2) % 2]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_run[e] += __shfl_xor_sync(kAll, l_run[e], 1);
      l_run[e] += __shfl_xor_sync(kAll, l_run[e], 2);
      const int r = row + 8 * e;
      if (t % 4 == 0 && r < sq_pad)
        lse_out[r] = r < Sq ? m_run[e] + log2f(l_run[e]) : 0.f;
    }
  }
}

// ---- 2. dK and dV -------------------------------------------------------
// One block owns 128 keys (kt = blockIdx.y, so the longest causal tiles
// launch first) of kv head kvh of batch b; warpgroup w of the consumers
// 64 of them.  The producer loads K and V once, then for each query head
// g of the group and each 64-row query tile from the diagonal on, Q, dO
// and the tile's log-sum-exps and D into the ring.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int sq_pad,
               int H, int KV, int B, float scale, float scale_log2,
               int causal) {
  using P = BwdPlan<HD>;
  constexpr int kSt = P::kStages;
  // past hd 64, dK and dV take 128 registers a thread: S and dP are then
  // not held at once (dV's product runs while dP is computed), which
  // keeps the consumers within their 232 registers
  constexpr bool kSplit = HD > 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align_1024(smem_raw);
  uint8_t* sv = sk + P::kRowTile;
  uint8_t* sq = sv + P::kRowTile;                  // kSt stages
  uint8_t* sdo = sq + kSt * P::kTileTile;          // kSt stages
  float* slse = reinterpret_cast<float*>(sdo + kSt * P::kTileTile);
  float* sdd = slse + kSt * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdd + kSt * kTile);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;             // [kSt]
  uint64_t* empty = bars + 1 + kSt;      // [kSt]

  const int G = H / KV;
  const int kt = blockIdx.y;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = kt * kRows;
  const int n_qt_all = (Sq + kTile - 1) / kTile;
  const int qt_first = causal ? min(k0 / kTile, n_qt_all) : 0;
  const int n_qt = n_qt_all - qt_first;
  const int n_it = G * n_qt;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * P::kRowTile);
#pragma unroll
      for (int c = 0; c < P::kBoxes; ++c) {
        tma_load_4d(sk + c * P::kRowBox, &tk, kv_full, 64 * c, kvh, k0, b);
        tma_load_4d(sv + c * P::kRowBox, &tv, kv_full, 64 * c, kvh, k0, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kSt;
        const int h = kvh * G + it / n_qt;
        const int q0 = (qt_first + it % n_qt) * kTile;
        if (it >= kSt) mbar_wait(&empty[s], ((it / kSt) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * P::kTileTile + 2 * P::kStats);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c) {
          tma_load_4d(sq + s * P::kTileTile + c * P::kTileBox, &tq, &full[s],
                      64 * c, h, q0, b);
          tma_load_4d(sdo + s * P::kTileTile + c * P::kTileBox, &tdo,
                      &full[s], 64 * c, h, q0, b);
        }
        const long long row0 =
            (static_cast<long long>(b) * H + h) * sq_pad + q0;
        bulk_load(slse + s * kTile, stats + row0, P::kStats, &full[s]);
        bulk_load(sdd + s * kTile,
                  stats + static_cast<long long>(B) * H * sq_pad + row0,
                  P::kStats, &full[s]);
      }
    }
  } else {                               // consumers
    regs_alloc<232>();
    const int t = threadIdx.x % 128;
    const int key = k0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and +8
    float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    const uint8_t* ka = sk + wg * 64 * 128;
    const uint8_t* va = sv + wg * 64 * 128;
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kSt;
      const int q0 = (qt_first + it % n_qt) * kTile;
      const uint8_t* qs = sq + s * P::kTileTile;
      const uint8_t* dos = sdo + s * P::kTileTile;
      float st[32], dpt[32];
      mbar_wait(&full[s], (it / kSt) & 1);
      fence_regs(st);
      if constexpr (!kSplit) fence_regs(dpt);
      wgmma_fence();
      mma_rows_by_tile<HD>(st, ka, qs);          // Sᵀ = K·Qᵀ
      if constexpr (!kSplit) mma_rows_by_tile<HD>(dpt, va, dos);  // dPᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      if constexpr (!kSplit) fence_regs(dpt);

      // Pᵀ (kept in st, f32): rows are keys, columns this tile's
      // queries; 0 past Sq, past Sk and above the diagonal, on the tiles
      // that reach any of them
      const bool edge = q0 + kTile > Sq || k0 + kRows > Sk ||
                        (causal && k0 + kRows - 1 > q0);
      const float* ls = slse + s * kTile;
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i / 4) + 2 * (t % 4) + i % 2;
        float p = ex2_sfu(st[i] * scale_log2 - ls[c]);
        if (edge) {
          const int q = q0 + c, j = key + 8 * ((i / 2) % 2);
          if (q >= Sq || j >= Sk || (causal && j > q)) p = 0.f;
        }
        st[i] = p;
        if (i % 2) pa[i / 8][(i % 8) / 2] = pack_bf16(st[i - 1], p);
      }
      if constexpr (kSplit) {
        // dV += Pᵀ·dO while dPᵀ = V·dOᵀ
        fence_regs(acc_v);
        fence_regs(dpt);
        wgmma_fence();
        mma_regs_by_tile<HD>(acc_v, pa, dos);
        mma_rows_by_tile<HD>(dpt, va, dos);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(dpt);
      }

      const float* ds = sdd + s * kTile;
      uint32_t pd[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i / 4) + 2 * (t % 4);
        pd[i / 8][(i % 8) / 2] =
            pack_bf16(st[i] * (dpt[i] - ds[c]),
                      st[i + 1] * (dpt[i + 1] - ds[c + 1]));
      }
      fence_regs(acc_k);
      if constexpr (!kSplit) fence_regs(acc_v);
      wgmma_fence();
      if constexpr (!kSplit) mma_regs_by_tile<HD>(acc_v, pa, dos);  // dV
      mma_regs_by_tile<HD>(acc_k, pd, qs);       // dK += dSᵀ·Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_k);
      if constexpr (!kSplit) fence_regs(acc_v);
      if (t == 0) mbar_arrive(&empty[s]);
    }
    const long long base =
        static_cast<long long>(b) * Sk * KV * HD +
        static_cast<long long>(kvh) * HD;
    const long long stride = static_cast<long long>(KV) * HD;
    store_rows<HD>(dk, acc_k, key, Sk, base, stride, scale, t);
    store_rows<HD>(dv, acc_v, key, Sk, base, stride, 1.f, t);
  }
}

// ---- 3. dQ --------------------------------------------------------------
// One block owns 128 query rows of head h of batch b (longest causal
// first); the producer loads Q and dO once and a ring of (K, V) 64-key
// tiles up to the diagonal.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
             int Sq, int Sk, int sq_pad, int H, int KV, int B, float scale,
             float scale_log2, int causal) {
  using P = BwdPlan<HD>;
  constexpr int kSt = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* sdo = sq + P::kRowTile;
  uint8_t* sk = sdo + P::kRowTile;                 // kSt stages
  uint8_t* sv = sk + kSt * P::kTileTile;           // kSt stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kSt * P::kTileTile);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;             // [kSt]
  uint64_t* empty = bars + 1 + kSt;      // [kSt]

  const int n_qt = gridDim.y;
  const int qt = causal ? n_qt - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int kv_end = causal ? min(Sk, q0 + kRows) : Sk;
  const int n_kt = (kv_end + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {                         // producer
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qdo_full, 2 * P::kRowTile);
#pragma unroll
      for (int c = 0; c < P::kBoxes; ++c) {
        tma_load_4d(sq + c * P::kRowBox, &tq, qdo_full, 64 * c, h, q0, b);
        tma_load_4d(sdo + c * P::kRowBox, &tdo, qdo_full, 64 * c, h, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kSt;
        if (kt >= kSt) mbar_wait(&empty[s], ((kt / kSt) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * P::kTileTile);
#pragma unroll
        for (int c = 0; c < P::kBoxes; ++c) {
          tma_load_4d(sk + s * P::kTileTile + c * P::kTileBox, &tk, &full[s],
                      64 * c, kvh, kt * kTile, b);
          tma_load_4d(sv + s * P::kTileTile + c * P::kTileBox, &tv, &full[s],
                      64 * c, kvh, kt * kTile, b);
        }
      }
    }
  } else {                               // consumers
    regs_alloc<232>();
    const int t = threadIdx.x % 128;
    const int row = q0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // and +8
    float lse[2], dd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      const long long at = static_cast<long long>(bh) * sq_pad + r;
      lse[e] = r < Sq ? stats[at] : 0.f;
      dd[e] = r < Sq ? stats[static_cast<long long>(B) * H * sq_pad + at]
                     : 0.f;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint8_t* qa = sq + wg * 64 * 128;
    const uint8_t* doa = sdo + wg * 64 * 128;
    mbar_wait(qdo_full, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kSt;
      const int k0 = kt * kTile;
      const uint8_t* ks = sk + s * P::kTileTile;
      float sc[32], dp[32];
      mbar_wait(&full[s], (kt / kSt) & 1);
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
      mma_rows_by_tile<HD>(sc, qa, ks);                       // S = Q·Kᵀ
      mma_rows_by_tile<HD>(dp, doa, sv + s * P::kTileTile);   // dP = dO·Vᵀ
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0);
      uint32_t pd[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int e = (i / 2) % 2;
        const int j = k0 + 8 * (i / 4) + 2 * (t % 4);
        const int r = row + 8 * e;
        float p0 = ex2_sfu(sc[i] * scale_log2 - lse[e]);
        float p1 = ex2_sfu(sc[i + 1] * scale_log2 - lse[e]);
        if (edge) {
          if (j >= Sk || (causal && j > r)) p0 = 0.f;
          if (j + 1 >= Sk || (causal && j + 1 > r)) p1 = 0.f;
        }
        pd[i / 8][(i % 8) / 2] =
            pack_bf16(p0 * (dp[i] - dd[e]), p1 * (dp[i + 1] - dd[e]));
      }

      fence_regs(acc);
      wgmma_fence();
      mma_regs_by_tile<HD>(acc, pd, ks);         // dQ += dS·K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[s]);
    }
    store_rows<HD>(dq, acc, row, Sq,
                   static_cast<long long>(b) * Sq * H * HD +
                       static_cast<long long>(h) * HD,
                   static_cast<long long>(H) * HD, scale, t);
  }
}

// A 4-D tensor map of a contiguous (B, S, heads, HD) bf16 tensor, boxes of
// 64 columns by `rows` positions of one head.
template <int HD>
int seq_map(CUtensorMap* map, const void* base, int B, int S, int heads,
            int rows) {
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      HD * 2, static_cast<cuuint64_t>(heads) * HD * 2,
      static_cast<cuuint64_t>(S) * heads * HD * 2};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4,
                           dims, strides, box);
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* stats,
               int B, int Sq, int Sk, int H, int KV, float scale, int causal,
               cudaStream_t stream) {
  using P = BwdPlan<HD>;
  const int sq_pad = (Sq + kTile - 1) / kTile * kTile;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int n_kt = (Sk + kRows - 1) / kRows;
  if (n_qt > 65535 || n_kt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_rows, do_rows, k_tile, v_tile, k_rows, v_rows, q_tile,
      do_tile;
  int err = seq_map<HD>(&q_rows, q, B, Sq, H, kRows);
  if (!err) err = seq_map<HD>(&do_rows, dout, B, Sq, H, kRows);
  if (!err) err = seq_map<HD>(&q_tile, q, B, Sq, H, kTile);
  if (!err) err = seq_map<HD>(&do_tile, dout, B, Sq, H, kTile);
  if (!err) err = seq_map<HD>(&k_rows, k, B, Sk, KV, kRows);
  if (!err) err = seq_map<HD>(&v_rows, v, B, Sk, KV, kRows);
  if (!err) err = seq_map<HD>(&k_tile, k, B, Sk, KV, kTile);
  if (!err) err = seq_map<HD>(&v_tile, v, B, Sk, KV, kTile);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_lse_d<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmemLse);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmemDkdv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmemDq);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  const auto* o_ = static_cast<const __nv_bfloat16*>(o);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  flash_bwd_lse_d<HD><<<dim3(B * H, n_qt), kThreads, P::kSmemLse, stream>>>(
      q_rows, k_tile, o_, do_, stats, Sq, Sk, sq_pad, H, KV, B, scale_log2,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkdv<HD><<<dim3(B * KV, n_kt), kThreads, P::kSmemDkdv, stream>>>(
      q_tile, do_tile, k_rows, v_rows, stats,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, sq_pad, H, KV, B, scale, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq<HD><<<dim3(B * H, n_qt), kThreads, P::kSmemDq, stream>>>(
      q_rows, do_rows, k_tile, v_tile, stats,
      static_cast<__nv_bfloat16*>(dq), Sq, Sk, sq_pad, H, KV, B, scale,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (dq, dk, dv) of bf16 attention with hd 64 or 128: q, o, dout (B, Sq, H,
// hd) and k, v (B, Sk, KV, hd), all contiguous and 16-byte aligned; dq,
// dk, dv of the same shapes; `stats` an f32 scratch of 2 x B x H x (Sq
// rounded up to 64), which the first kernel fills.  Three launches on
// `stream`; returns the first failing launch's cudaError_t (0 on success),
// or hopper.cuh's codes when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, void* dq, void* dk,
                                        void* dv, float* stats, int B, int Sq,
                                        int Sk, int H, int KV, int hd,
                                        float scale, int causal, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (KV <= 0 || H % KV || Sk < 1 || Sq < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                            H, KV, scale, causal, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Sk,
                             H, KV, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
