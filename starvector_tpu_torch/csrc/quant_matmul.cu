// Weight-only int8 matrix product for Hopper (sm_90a):
//   out[m, n] = round(sum_k x[m, k] * q[k, n] * scale[n] + bias[n])
// with x (M, K) bf16 or fp32, q (K, N) int8 row-major, scale (N,) fp32, bias
// (N,) fp32 or bf16 or absent, and out bf16 or fp32. The sum is taken in fp32
// (int8 -> bf16/fp32 is exact), multiplied by the column's scale in fp32, the
// bias added in fp32, and the result rounded once to the output type.
//
// Replaces the Pallas TPU kernel starvector_tpu/ops/quantization.py::
// quant_matmul -> _qmm_kernel (:117, call :169), whose function is
// (sum_k x * q) * scale in fp32; the bias add and the one rounding are the
// port's dense_quantized epilogue, fused here so a dense layer is one call.
//
// Three code paths, chosen by the launcher from M and x's type:
//
// * M <= 16 (decode rows): qmm_gemv_kernel. What bounds it on the H100 is
//   reading q: K * N bytes over 3.35 TB/s (c_fc of StarVector-1B, 16.8 MB,
//   about 5 us), so the design is about streaming q at the HBM rate. Each
//   lane reads 16 int8 codes (16 bytes) of one row of q; a warp covers 4 rows
//   x 128 contiguous columns (128-byte segments, coalesced), a block of 8
//   warps 32 rows x 128 columns per step, with up to 4 x rows staged in
//   shared memory as fp32. At N = 2048 there are only 16 column blocks, so K
//   is split across blocks as well (one wave of up to 2 blocks per SM); the
//   codes become fp32 by a byte permute and a subtraction. Each block writes
//   its partial sums to a workspace, and qmm_finish_kernel adds the splits in
//   a fixed order and applies the epilogue. No atomics: the sum order does
//   not change from run to run.
// * M > 16, bf16 x (prefill rows): qmm_mma_kernel, a 64 x 64 output tile per
//   block of 4 warps stepping through K by 64. The x tile is copied into
//   shared memory with 16-byte loads; the int8 tile of q is converted to bf16
//   as it lands there, transposed to n-major so that each tensor-core B
//   fragment is two 32-bit shared loads. Products are mma.sync.m16n8k16 bf16
//   with fp32 accumulators (each warp 32 x 32 of the tile), 4 k16 steps
//   between barriers. Bound at these shapes by the tensor cores (M = 1040:
//   about 8.7 to 35 GFLOP a call); this first version has no multi-stage
//   pipeline or wgmma.
// * M > 16, fp32 x (the fp32 checks): qmm_f32_kernel, a 64 x 64 tile on the
//   fp32 CUDA cores, 4 x 4 outputs a thread.

#include <stdint.h>

#include "common.cuh"

namespace sv {
namespace {

// ---------------------------------------------------------------------------
// epilogue shared by the paths: acc * scale, + bias, in fp32 (no fused
// multiply-add, so the plain version's two roundings are the kernel's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float qmm_epilogue(float acc, const float* scale, const void* bias,
                                              int bias_dtype, int n) {
  float y = __fmul_rn(acc, scale[n]);
  if (bias != nullptr) {
    const float b = bias_dtype == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n])
                                            : static_cast<const float*>(bias)[n];
    y = __fadd_rn(y, b);
  }
  return y;
}

// 16 int8 codes as fp32, exactly, without the conversion unit (whose 16
// results a clock per SM would cap the GEMV below the HBM rate): flipping
// the sign bit gives b + 128 as a byte, which a byte permute places in the
// mantissa of 2^23, so the float is 2^23 + 128 + b; one subtraction leaves b.
__device__ __forceinline__ void unpack_int8x16(const uint4& raw, float* o) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - 8388736.f;
    }
  }
}

// ---------------------------------------------------------------------------
// M <= 16: split-K GEMV into a workspace, then a fixed-order finish
// ---------------------------------------------------------------------------

constexpr int kGemvThreads = 256;  // 8 warps
constexpr int kGemvCols = 128;     // columns per block: 8 lanes x 16 codes
constexpr int kGemvMaxKc = 1024;   // k rows per block (the x chunk in shared memory)

template <typename T, int MR>
__global__ void __launch_bounds__(kGemvThreads) qmm_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q, float* __restrict__ ws,
    int M, int K, int N, long long x_sm, int kc) {
  __shared__ float xs[MR][kGemvMaxKc];
  __shared__ float red[kGemvThreads / 32][MR][kGemvCols];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int n0 = blockIdx.x * kGemvCols;
  const int k0 = blockIdx.y * kc;
  const int m0 = blockIdx.z * MR;
  const int kend = min(k0 + kc, K);
  const int rows = min(MR, M - m0);

  for (int e = tid; e < MR * kc; e += kGemvThreads) {
    const int m = e / kc, k = e - m * kc;
    xs[m][k] = (m < rows && k0 + k < K) ? to_f(x[(long long)(m0 + m) * x_sm + k0 + k]) : 0.f;
  }
  __syncthreads();

  const int cg = lane & 7;              // 16-column group of the block
  const int kr = w * 4 + (lane >> 3);   // this lane's row in each 32-row step
  const int n = n0 + cg * 16;
  float acc[MR][16];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  if (n < N) {  // N % 16 == 0: a group is wholly inside or outside
#pragma unroll 4
    for (int k = k0 + kr; k < kend; k += 32) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(q + (long long)k * N + n));
      float wf[16];
      unpack_int8x16(raw, wf);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = xs[m][k - k0];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
      }
    }
  }

  // the warp's 4 rows hold the same columns in lanes l, l^8, l^16, l^24
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[w][m][cg * 16 + j] = acc[m][j];
  }
  __syncthreads();
  for (int e = tid; e < MR * kGemvCols; e += kGemvThreads) {
    const int m = e / kGemvCols, c = e - m * kGemvCols;
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kGemvThreads / 32; ++u) s += red[u][m][c];
    if (m < rows && n0 + c < N) ws[((long long)blockIdx.y * M + m0 + m) * N + n0 + c] = s;
  }
}

template <typename TO>
__global__ void __launch_bounds__(256) qmm_finish_kernel(
    const float* __restrict__ ws, int splits, const float* __restrict__ scale,
    const void* bias, int bias_dtype, TO* __restrict__ out, int M, int N, long long out_sm) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= (long long)M * N) return;
  const int m = (int)(e / N), n = (int)(e - (long long)m * N);
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[((long long)s * M + m) * N + n];
  out[(long long)m * out_sm + n] = from_f<TO>(qmm_epilogue(acc, scale, bias, bias_dtype, n));
}

// ---------------------------------------------------------------------------
// M > 16, bf16 x: tensor-core tile
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 64, kPad = 8;
constexpr int kTileThreads = 128;  // 4 warps, 2 x 2, each 32 x 32

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__global__ void __launch_bounds__(kTileThreads) qmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const void* bias, int bias_dtype, TO* __restrict__ out,
    int M, int K, int N, long long x_sm, long long out_sm) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM][kBK + kPad];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kBK + kPad];  // [n][k]: q transposed
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = w >> 1, wn = w & 1;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kt = 0; kt < K; kt += kBK) {
    // x tile: 64 rows x 64 columns, 8 bf16 (16 bytes) a load; K % 8 == 0
#pragma unroll
    for (int v = tid; v < kBM * kBK / 8; v += kTileThreads) {
      const int r = v >> 3, c = (v & 7) * 8;
      const int gm = m0 + r, gk = kt + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K) val = *reinterpret_cast<const uint4*>(x + (long long)gm * x_sm + gk);
      *reinterpret_cast<uint4*>(&As[r][c]) = val;
    }
    // q tile: 64 rows x 64 columns; a thread takes 16 codes (one 16-byte
    // load) of each of two adjacent rows, converts them to bf16 (exact) and
    // stores each column's pair of rows as one 32-bit word, n-major
    {
      const int r = (tid >> 2) * 2, c = (tid & 3) * 16;
      const int gn = n0 + c;
      float w0[16], w1[16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* wf = h ? w1 : w0;
        const int gk = kt + r + h;
        if (gk < K && gn < N) {
          unpack_int8x16(__ldg(reinterpret_cast<const uint4*>(q + (long long)gk * N + gn)), wf);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) wf[j] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(&Bs[c + j][r]) = __floats2bfloat162_rn(w0[j], w1[j]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = wm * 32 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[row][ks + 2 * t + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[row + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * t]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&Bs[col][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * 32 + i * 16 + g;
      const int col = n0 + wn * 32 + j * 8 + 2 * t;  // col + 1 < N when col < N (N even)
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = row + 8 * h;
        if (rr >= M) continue;
        TO* o = out + (long long)rr * out_sm + col;
        o[0] = from_f<TO>(qmm_epilogue(acc[i][j][2 * h], scale, bias, bias_dtype, col));
        o[1] = from_f<TO>(qmm_epilogue(acc[i][j][2 * h + 1], scale, bias, bias_dtype, col + 1));
      }
    }
}

// ---------------------------------------------------------------------------
// M > 16, fp32 x: CUDA-core tile
// ---------------------------------------------------------------------------

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <typename TO>
__global__ void __launch_bounds__(256) qmm_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
    const void* bias, int bias_dtype, TO* __restrict__ out, int M, int K, int N,
    long long x_sm, long long out_sm) {
  __shared__ float As[kFBK][kFBM + 4];  // [k][m]
  __shared__ float Bs[kFBK][kFBN];      // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < K; kt += kFBK) {
#pragma unroll
    for (int e = tid; e < kFBM * kFBK; e += 256) {
      const int m = e / kFBK, k = e - m * kFBK;
      const int gm = m0 + m, gk = kt + k;
      As[k][m] = (gm < M && gk < K) ? x[(long long)gm * x_sm + gk] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < kFBK * kFBN; e += 256) {
      const int k = e / kFBN, n = e - k * kFBN;
      const int gk = kt + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? static_cast<float>(q[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) {
        out[(long long)gm * out_sm + gn] =
            from_f<TO>(qmm_epilogue(acc[i][j], scale, bias, bias_dtype, gn));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kGemvMaxM = 16;

template <typename T, typename TO>
int launch_qmm(const void* x, const int8_t* q, const float* scale, const void* bias,
               int bias_dtype, void* out, float* ws, int M, int K, int N, long long x_sm,
               long long out_sm, int splits, int kc, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  TO* o = static_cast<TO*>(out);
  if (M <= kGemvMaxM) {
    if (ws == nullptr || splits < 1 || kc < 1 || kc > kGemvMaxKc || kc % 32 != 0 ||
        (long long)splits * kc < K) {
      return (int)cudaErrorInvalidValue;
    }
    const int col_blocks = (N + kGemvCols - 1) / kGemvCols;
    if (M == 1) {
      qmm_gemv_kernel<T, 1><<<dim3(col_blocks, splits, 1), kGemvThreads, 0, st>>>(
          xt, q, ws, M, K, N, x_sm, kc);
    } else {
      qmm_gemv_kernel<T, 4><<<dim3(col_blocks, splits, (M + 3) / 4), kGemvThreads, 0, st>>>(
          xt, q, ws, M, K, N, x_sm, kc);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)M * N;
    qmm_finish_kernel<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        ws, splits, scale, bias, bias_dtype, o, M, N, out_sm);
    return (int)cudaGetLastError();
  }
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  if constexpr (sizeof(T) == 2) {
    qmm_mma_kernel<TO><<<grid, kTileThreads, 0, st>>>(xt, q, scale, bias, bias_dtype, o, M, K,
                                                      N, x_sm, out_sm);
  } else {
    qmm_f32_kernel<TO><<<grid, 256, 0, st>>>(xt, q, scale, bias, bias_dtype, o, M, K, N, x_sm,
                                             out_sm);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for types or shapes the kernels do not take. x is
// (M, K) with row stride x_sm (unit column stride), bf16 or fp32; q (K, N)
// int8 contiguous with N % 16 == 0 and 16-byte alignment; scale (N,) fp32;
// bias (N,) of bias_dtype or null; out (M, N) with row stride out_sm. For
// M <= 16, ws holds splits * M * N fp32 partial sums, kc rows of K each
// (a multiple of 32, at most 1024, splits * kc >= K); for M > 16 with bf16
// x, K % 8 == 0 and x is 16-byte aligned.
extern "C" int sv_quant_matmul(int x_dtype, int out_dtype, int bias_dtype, const void* x,
                               const void* q, const float* scale, const void* bias, void* out,
                               void* ws, int M, int K, int N, long long x_sm, long long out_sm,
                               int splits, int kc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  float* w = static_cast<float*>(ws);
  if (M < 1 || K < 1 || N < 16 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != sv::kFloat32 && bias_dtype != sv::kBFloat16) {
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == sv::kBFloat16) {
    if (M > sv::kGemvMaxM && K % 8 != 0) return (int)cudaErrorInvalidValue;
    if (out_dtype == sv::kBFloat16) {
      return sv::launch_qmm<__nv_bfloat16, __nv_bfloat16>(x, qq, scale, bias, bias_dtype, out, w,
                                                          M, K, N, x_sm, out_sm, splits, kc, st);
    }
    if (out_dtype == sv::kFloat32) {
      return sv::launch_qmm<__nv_bfloat16, float>(x, qq, scale, bias, bias_dtype, out, w, M, K,
                                                  N, x_sm, out_sm, splits, kc, st);
    }
  } else if (x_dtype == sv::kFloat32) {
    if (out_dtype == sv::kFloat32) {
      return sv::launch_qmm<float, float>(x, qq, scale, bias, bias_dtype, out, w, M, K, N, x_sm,
                                          out_sm, splits, kc, st);
    }
    if (out_dtype == sv::kBFloat16) {
      return sv::launch_qmm<float, __nv_bfloat16>(x, qq, scale, bias, bias_dtype, out, w, M, K,
                                                  N, x_sm, out_sm, splits, kc, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
