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

// Whether query position qpos sees key position t under the causal and
// sliding-window masks (window <= 0: none).
__device__ __forceinline__ bool visible(int t, int qpos, int causal, int window) {
  return (!causal || t <= qpos) && (window <= 0 || t > qpos - window);
}

// Keys [t_begin, t_end) that the query tile of TILE rows at r0 can see
// (t_begin a tile multiple): up to the causal bound of its last row, from
// the window edge of its first row. Args: an attention kernel's arguments
// (S, T, q_offset, causal, window).
template <int TILE, class Args>
__device__ __forceinline__ void key_range(const Args& a, int r0, int& t_begin, int& t_end) {
  const int rows = min(TILE, a.S - r0);
  const int first_q = a.q_offset + r0;
  const int last_q = first_q + rows - 1;
  t_end = a.causal ? min(a.T, last_q + 1) : a.T;
  t_begin = a.window > 0 ? max(0, first_q - a.window + 1) : 0;
  t_begin -= t_begin % TILE;
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

// ---------------------------------------------------------------------------
// mma.sync building blocks (warp-level tensor-core products, sm_80 and up)
// ---------------------------------------------------------------------------

// c += a b for one m16n8k16 bf16 product with fp32 sums. Per thread (g =
// lane / 4, t = lane % 4): a[0..3] hold A's bf16 pairs (row g, cols 2t, 2t+1),
// (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8); b[0..1] B's pairs (rows 2t, 2t+1
// and 2t + 8, 2t + 9; col g); c[0..3] rows g, g, g + 8, g + 8 at cols 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 contiguous bytes); r[i] receives matrix i's
// pair (row lane / 4, cols 2 (lane % 4), + 1), or with .trans its pair
// (rows 2 (lane % 4), + 1; col lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace sv
