// Causal flash-attention prefill for Hopper (sm_90a), optionally with the
// per-row logsumexp that the training backward needs.
//
// Replaces the Pallas TPU kernels of starvector_tpu/ops/flash_attention.py:
//   * flash_prefill -> _flash_kernel / _flash_fwd_cell (inference prefill);
//   * flash_prefill_with_lse -> _flash_lse_kernel (rectangular grid) and
//     _flash_lse_tri_kernel (triangular grid, S == T, q_offset 0): the same
//     math plus lse = m + log(max(l, 1e-30)) per row. The k loop below stops
//     at the causal bound of each query tile, so it visits only the live
//     lower triangle that the TPU's triangular grid enumerates: one kernel
//     serves both.
// Online-softmax attention of q (B,S,H,D) over k, v (B,T,Hkv,D) with a key
// mask (B,T), an absolute query offset (the cache index of query row 0),
// causal and sliding-window masks, and MQA/GQA grouping (query head h reads
// KV head h / (H/Hkv)).
//
// What bounds it on the H100: at the StarVector-1B prefill (S ~ 261, D = 128,
// one KV head) the attention is a few GFLOP, so the kernel is bound by its
// own instruction issue: this first version runs its products on the fp32
// CUDA cores (no mma/wgmma), so it sits far below both the 989 TFLOP/s bf16
// tensor-core roof and the 3.35 TB/s memory roof.
// What the design does about it: one block per (batch, head, 64-row query
// tile); the k/v tiles of 64 keys are staged once in shared memory (fp32,
// K rows padded by one float so lane-per-key reads are conflict-free) and
// reused by all 64 query rows; the loop over k tiles stops at the causal
// bound, so the unwritten tail of a preallocated cache is never read; the
// ragged S and T edges are masked in the kernel instead of padded.
// Tensor-core products, TMA and tuning are later work.
//
// Layout contract: q, k, v are read through their strides (last dim
// contiguous), in the JAX package's (B, S, H, D) / (B, T, Hkv, D) layout;
// kv_mask is (B, T) int32 with unit stride along T; out is a contiguous
// (B, S, H, D) tensor of q's type; lse, when not null, a contiguous
// (B, H, S) fp32 tensor (the plain layout, not the TPU's 8-lane one). Rows
// that see no key produce zeros and lse = -1e30 + log(1e-30), so that the
// backward's exp(s - lse) is never taken for them (every key is masked).

#include <stdint.h>

#include "common.cuh"

namespace sv {
namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile (two per lane)
constexpr int kWarps = 4;            // each warp owns kBQ / kWarps query rows
constexpr int kRows = kBQ / kWarps;  // 16
constexpr int kThreads = kWarps * 32;

struct PrefillArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;
  void* out;
  float* lse;  // (B, H, S) or null
  int B, S, T, H, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long m_sb;
  int q_offset, causal, window;
  float scale;
};

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D + kWarps * kRows * kBK) +
         sizeof(int) * kBK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(const PrefillArgs a) {
  constexpr int DC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;          // padded row stride of the K tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][D]
  float* Ks = Qs + kBQ * D;          // [kBK][KS]
  float* Vs = Ks + kBK * KS;         // [kBK][D]
  float* Ps = Vs + kBK * D;          // [kWarps][kRows][kBK]
  int* Ms = reinterpret_cast<int*>(Ps + kWarps * kRows * kBK);  // [kBK]

  const int i0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[e] = (i0 + r < a.S) ? to_f(q[(long long)(i0 + r) * a.q_ss + d]) : 0.f;
  }

  // Keys this tile of queries can see: up to the causal bound of its last
  // row, from the window edge of its first row.
  const int rows = min(kBQ, a.S - i0);
  const int first_q = a.q_offset + i0;
  const int last_q = first_q + rows - 1;
  const int t_end = a.causal ? min(a.T, last_q + 1) : a.T;
  int t_begin = a.window > 0 ? max(0, first_q - a.window + 1) : 0;
  t_begin -= t_begin % kBK;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const float* qw = Qs + w * kRows * D;
  float* pw = Ps + w * kRows * kBK;

  for (int t0 = t_begin; t0 < t_end; t0 += kBK) {
    __syncthreads();  // Q is staged / the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int t = t0 + r;
      const bool in = t < a.T;
      Ks[r * KS + d] = in ? to_f(k[(long long)t * a.k_st + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(v[(long long)t * a.v_st + d]) : 0.f;
    }
    for (int r = tid; r < kBK; r += kThreads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;
    __syncthreads();

    // scores: lane owns keys t0 + lane and t0 + lane + 32 for the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
    const float* k0p = Ks + lane * KS;
    const float* k1p = Ks + (lane + 32) * KS;
    for (int d = 0; d < D; d += 4) {
      const float ka[4] = {k0p[d], k0p[d + 1], k0p[d + 2], k0p[d + 3]};
      const float kb[4] = {k1p[d], k1p[d + 1], k1p[d + 2], k1p[d + 3]};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * D + d);
        s0[r] = fmaf(qv.x, ka[0], fmaf(qv.y, ka[1], fmaf(qv.z, ka[2], fmaf(qv.w, ka[3], s0[r]))));
        s1[r] = fmaf(qv.x, kb[0], fmaf(qv.y, kb[1], fmaf(qv.z, kb[2], fmaf(qv.w, kb[3], s1[r]))));
      }
    }

    // online softmax, one row at a time across the warp
    const int ta = t0 + lane, tb = t0 + lane + 32;
    const bool ma = Ms[lane] != 0, mb = Ms[lane + 32] != 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = i0 + w * kRows + r;
      const int qpos = a.q_offset + row;
      bool va = ma && row < a.S, vb = mb && row < a.S;
      if (a.causal) {
        va = va && ta <= qpos;
        vb = vb && tb <= qpos;
      }
      if (a.window > 0) {
        va = va && ta > qpos - a.window;
        vb = vb && tb > qpos - a.window;
      }
      const float xa = va ? s0[r] * a.scale : kNegInf;
      const float xb = vb ? s1[r] * a.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(xa, xb)));
      const float corr = expf(m[r] - m_new);
      const float pa = va ? expf(xa - m_new) : 0.f;
      const float pb = vb ? expf(xb - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
      pw[r * kBK + lane] = pa;
      pw[r * kBK + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P V: lane owns output columns lane + 32 c
    for (int j = 0; j < kBK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = i0 + w * kRows + r;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.H + h) * a.S + row] = m[r] + logf(denom);
    T* o = out + (((long long)b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = from_f<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_prefill(const PrefillArgs& a, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The one head size instantiated: StarVector-1B's 128. Another is another
// instantiation, added with the model that needs it and a check of it on
// the card.
constexpr int kPrefillD = 128;

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype / head size the kernel does not take
// (it takes D = 128). lse may be null (inference).
extern "C" int sv_flash_prefill(
    int dtype, int D, const void* q, const void* k, const void* v, const int* mask, void* out,
    float* lse, int B, int S, int T, int H, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long m_sb, int q_offset, int causal, int window, float scale, void* stream) {
  const sv::PrefillArgs a{q, k, v, mask, out, lse, B, S, T, H, H / Hkv,
                          q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          m_sb, q_offset, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != sv::kPrefillD) return (int)cudaErrorInvalidValue;
  if (dtype == sv::kFloat32) return sv::launch_prefill<float, sv::kPrefillD>(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_prefill<__nv_bfloat16, sv::kPrefillD>(a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
