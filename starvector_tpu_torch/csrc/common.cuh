// Helpers shared by the kernels: fp32 <-> storage-type conversion, vector
// loads and warp reductions. Every kernel keeps its scores, softmax
// statistics and accumulators in fp32 whatever the storage type (fp32, bf16,
// or int8 codes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sv {

// Masked scores use the same finite sentinel as the Pallas kernels
// (starvector_tpu/ops/flash_attention.py: NEG_INF = -1e30).
constexpr float kNegInf = -1e30f;

// Storage type codes passed across the C interface.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Loads N consecutive elements as fp32 with the widest vector access that
// N * sizeof(T) allows (up to 16 bytes). The caller guarantees that p is
// aligned to min(16, N * sizeof(T)) bytes.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x;
      o[i + 1] = x.y;
      o[i + 2] = x.z;
      o[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x;
    o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        o[i + 2 * j] = f.x;
        o[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    o[0] = f0.x;
    o[1] = f0.y;
    o[2] = f1.x;
    o[3] = f1.y;
  } else if constexpr (N == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = f.x;
    o[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// int8 codes as fp32 (exact): N consecutive codes, 16 bytes a load for N a
// multiple of 16 (p then 16-byte aligned), else one 8- or 4-byte load for
// N = 8 or 4 (p aligned to N bytes).
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* o) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 16; ++j) o[i + j] = static_cast<float>(b[j]);
    }
  } else if constexpr (N == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = static_cast<float>(b[j]);
  } else if constexpr (N == 4) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = static_cast<float>(b[j]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = static_cast<float>(p[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace sv
