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
// What differs from the TPU kernel: one warp owns one (query i, head h)
// row with its m, l and acc (hd / 32 dims a lane) in registers; the
// warps of a block share one kv head, stage tiles of 32 keys and values
// in shared memory, and score one key per lane.  Keys past Sk (the
// ragged tail that the JAX wrapper sends to its reference instead) are
// masked with -1e30 like any other masked score, so any Sk runs here.
// For causal attention a row skips the tiles wholly above its diagonal,
// which the TPU kernel visits to no effect: p = exp(-1e30 - m) = 0 and
// the correction exp(m - m) = 1 there.
//
// Bound: operations.  At llama3.2-3b width (S = 4,096, H = 24, KV = 8,
// hd = 128, causal, bf16) the kernel must do 103 GFLOP, 0.104 ms at 989
// TFLOP/s, against 67 MB of q, k, v and out (0.020 ms at 3.35 TB/s).
// This version does its products on the SM's cores in f32, with one warp
// reduction a key, and is far from that bound.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;             // (query, head) rows of a block
constexpr int kKeys = 32;              // keys of a tile: one a lane
constexpr int kMaxHd = 128;
constexpr int kDims = kMaxHd / 32;     // dims a lane holds
constexpr float kNegInf = -1e30f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// grid: x over blocks of kWarps rows (row = i * G + g), y over B * KV
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int hd, float scale, int causal) {
  __shared__ float Ks[kKeys * kMaxHd];
  __shared__ float Vs[kKeys * kMaxHd];
  const int G = H / KV;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n_rows = static_cast<long long>(Sq) * G;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const bool active = row < n_rows;
  const int i = static_cast<int>(row / G);
  const int h = kvh * G + static_cast<int>(row % G);

  float qr[kDims], acc[kDims];
#pragma unroll
  for (int t = 0; t < kDims; ++t) {
    const int d = lane + 32 * t;
    qr[t] = (active && d < hd)
                ? to_float(q[((static_cast<long long>(b) * Sq + i) * H + h) * hd + d])
                : 0.f;
    acc[t] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys the block needs: all of them, or up to its last row's diagonal
  const long long last = min(n_rows, static_cast<long long>(blockIdx.x + 1) * kWarps) - 1;
  const int n_keys = causal ? min(Sk, static_cast<int>(last / G) + 1) : Sk;
  for (int j0 = 0; j0 < n_keys; j0 += kKeys) {
    __syncthreads();                   // the last tile is consumed
    for (int e = threadIdx.x; e < kKeys * hd; e += kWarps * 32) {
      const int j = j0 + e / hd;
      const long long src = ((static_cast<long long>(b) * Sk + j) * KV + kvh) * hd + e % hd;
      Ks[e] = j < Sk ? to_float(k[src]) : 0.f;
      Vs[e] = j < Sk ? to_float(v[src]) : 0.f;
    }
    __syncthreads();
    if (!active || (causal && j0 > i)) continue;   // warp-uniform

    float s = kNegInf;                 // lane jj's score: key j0 + jj
#pragma unroll 4
    for (int jj = 0; jj < kKeys; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < kDims; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) part += qr[t] * Ks[jj * hd + d];
      }
      part = warp_sum(part);
      if (lane == jj) s = part * scale;
    }
    const int j = j0 + lane;
    if (j >= Sk || (causal && j > i)) s = kNegInf;

    const float m_new = fmaxf(m, warp_max(s));
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    const float pv = round_to<T>(p);
#pragma unroll
    for (int t = 0; t < kDims; ++t) acc[t] *= corr;
#pragma unroll 4
    for (int jj = 0; jj < kKeys; ++jj) {
      const float pj = __shfl_sync(kAll, pv, jj);
#pragma unroll
      for (int t = 0; t < kDims; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) acc[t] += pj * Vs[jj * hd + d];
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int t = 0; t < kDims; ++t) {
    const int d = lane + 32 * t;
    if (d < hd)
      out[((static_cast<long long>(b) * Sq + i) * H + h) * hd + d] =
          from_float<T>(acc[t] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
           cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(Sq) * (H / KV);
  const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps),
                  B * KV);
  flash_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, hd,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = attention of q (B, Sq, H, hd), k/v (B, Sk, KV, hd), all
// contiguous of working type `dtype` (DType: f32 or bf16) on CUDA device
// `device`; H % KV == 0, hd <= 128, Sk >= 1.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int B, int Sq,
                               int Sk, int H, int KV, int hd, float scale,
                               int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd > kMaxHd || KV <= 0 || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale,
                           causal, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                   scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
