// Element conversions shared by the kernels of the kernel API: every
// kernel loads its working type (f32 or bf16), computes in f32 and
// rounds once where the JAX package's kernel casts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision (round to nearest even) and widened back.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// Working types the wrappers pass by code.
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
