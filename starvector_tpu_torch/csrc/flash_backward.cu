// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of the causal
// MQA/GQA attention that flash_prefill.cu computes, with the probabilities
// recomputed from the forward's per-row logsumexp, so nothing of size S x T
// is ever stored.
//
// Replaces the Pallas TPU backward kernels of
// starvector_tpu/ops/flash_attention.py::flash_backward. They are one math
// in several grid shapes, each shaped by the TPU's VMEM budget: the fused
// single-k-block kernel _flash_dqdkv_fused_kernel (T <= 2048, the 1B
// training step at T = 769), the one-pass kernels _flash_bwd_onepass_tri_
// kernel / _flash_bwd_onepass_kernel (the 8k context), the dq-partials
// kernel _flash_bwd_dqp_kernel, and the split FA2 pair _flash_dq(_tri)_kernel
// / _flash_dkv(_tri)_kernel. On Hopper one design serves every length:
//
//   flash_bwd_dkdv: one block per (batch, KV head, 64-key tile). K and V of
//     the tile stay in shared memory and the fp32 dK, dV sums in registers.
//     The block loops over the G query heads of its KV head and over the
//     64-row query tiles that can see the tile (from the causal bound to S,
//     cut by the window). For each it stages Q, dO, lse and delta, recomputes
//     S = Q K^T * scale and P = exp(S - lse) under the key, causal and window
//     masks, and adds dV += P^T dO, dP = dO V^T, dS = P (dP - delta) * scale,
//     dK += dS^T Q. dK and dV are written once, rounded once from fp32: the
//     G heads are summed in fp32 in one block, with no atomics, as the TPU
//     kernels sum them in scratch.
//   flash_bwd_dq: one block per (batch, query head, 64-row query tile). It
//     loops over the key tiles up to the causal bound (from the window edge)
//     and writes dQ = sum of dS K once.
//
// delta = rowsum(dO * O) in fp32 from the rounded forward output is computed
// by the caller, as the JAX package computes it outside its Pallas kernels.
//
// Rounding: the JAX kernels cast P to dO's type before the dV product and dS
// to q's type before the dK and dQ products. These kernels keep P and dS in
// fp32 (as flash_prefill.cu keeps P): with bf16 inputs they are held to the
// bf16 tolerance against the plain version, which rounds where JAX does.
//
// What bounds it on the H100: this first version runs every product on the
// fp32 CUDA cores (no mma/wgmma), so it is bound by instruction issue, far
// below the 989 TFLOP/s bf16 tensor-core roof. flash_bwd_dkdv has only
// B * ceil(T/64) * Hkv blocks (52 at the 1B step's B = 4, T = 769, Hkv = 1,
// on 132 SMs), and the block of the first key tile does the most work: it
// sees every query tile. Tensor-core products, TMA, and splitting the G heads
// or the query range across blocks are later work.
//
// Layout contract: q (B,S,H,D), k and v (B,T,Hkv,D) and dO (B,S,H,D) are read
// through their strides (last dim contiguous); lse and delta are contiguous
// (B,H,S) fp32; kv_mask is (B,T) int32 with unit stride along T; dq is a
// contiguous (B,S,H,D) tensor of q's type, dk and dv contiguous (B,T,Hkv,D)
// of k's type. A query row that sees no key contributes nothing and gets
// dq = 0; a key that no query sees gets dk = dv = 0.

#include <stdint.h>

#include "common.cuh"

namespace sv {
namespace {

constexpr int kTile = 64;                   // query rows and keys per tile
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kWarpRows = kTile / kBwdWarps;  // 8 rows (or keys) per warp

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* mask;
  void* out0;  // dq, or dk
  void* out1;  // dv (flash_bwd_dkdv only)
  int B, S, T, H, Hkv, G;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  int q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(int t, int qpos, int causal, int window) {
  return (!causal || t <= qpos) && (window <= 0 || t > qpos - window);
}

// Stages rows [r0, r0 + kTile) of a (.., rows, .., D) operand as fp32 into
// dst[kTile][stride], zeros past `n` rows.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const T* src,
                                           long long row_stride, int r0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kBwdThreads) {
    const int r = e / D, d = e % D;
    dst[r * stride + d] = (r0 + r < n) ? to_f(src[(long long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// For the warp's kWarpRows query rows (rows of qs/os, stride D) against the
// tile's keys `lane` and `lane + 32` (rows of ks/vs, stride D + 1):
// s = q . k and dp = dO . v, accumulated in fp32.
template <int D>
__device__ __forceinline__ void scores_and_dp(const float* qs, const float* os, const float* ks,
                                              const float* vs, int lane, float (&s0)[kWarpRows],
                                              float (&s1)[kWarpRows], float (&dp0)[kWarpRows],
                                              float (&dp1)[kWarpRows]) {
  constexpr int KS = D + 1;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) s0[r] = s1[r] = dp0[r] = dp1[r] = 0.f;
  const float* k0 = ks + lane * KS;
  const float* k1 = ks + (lane + 32) * KS;
  const float* v0 = vs + lane * KS;
  const float* v1 = vs + (lane + 32) * KS;
  for (int d = 0; d < D; d += 4) {
    const float ka[4] = {k0[d], k0[d + 1], k0[d + 2], k0[d + 3]};
    const float kb[4] = {k1[d], k1[d + 1], k1[d + 2], k1[d + 3]};
    const float va[4] = {v0[d], v0[d + 1], v0[d + 2], v0[d + 3]};
    const float vb[4] = {v1[d], v1[d + 1], v1[d + 2], v1[d + 3]};
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + d);
      const float4 ov = *reinterpret_cast<const float4*>(os + r * D + d);
      s0[r] = fmaf(qv.x, ka[0], fmaf(qv.y, ka[1], fmaf(qv.z, ka[2], fmaf(qv.w, ka[3], s0[r]))));
      s1[r] = fmaf(qv.x, kb[0], fmaf(qv.y, kb[1], fmaf(qv.z, kb[2], fmaf(qv.w, kb[3], s1[r]))));
      dp0[r] = fmaf(ov.x, va[0], fmaf(ov.y, va[1], fmaf(ov.z, va[2], fmaf(ov.w, va[3], dp0[r]))));
      dp1[r] = fmaf(ov.x, vb[0], fmaf(ov.y, vb[1], fmaf(ov.z, vb[2], fmaf(ov.w, vb[3], dp1[r]))));
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V tiles (padded rows), Q, dO tiles, P and dS (query-major), lse, delta, key mask
  return sizeof(float) * (2 * kTile * (D + 1) + 2 * kTile * D + 2 * kTile * kTile + 2 * kTile) +
         sizeof(int) * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkdv_kernel(const BwdArgs a) {
  constexpr int KS = D + 1;
  constexpr int DC = D / 32;  // dK/dV columns per lane
  extern __shared__ float smem[];
  float* Ks = smem;                  // [kTile][KS]
  float* Vs = Ks + kTile * KS;       // [kTile][KS]
  float* Qs = Vs + kTile * KS;       // [kTile][D]
  float* Os = Qs + kTile * D;        // [kTile][D]
  float* Ps = Os + kTile * D;        // [kTile q][kTile keys]
  float* dSs = Ps + kTile * kTile;   // [kTile q][kTile keys]
  float* lse_s = dSs + kTile * kTile;
  float* delta_s = lse_s + kTile;
  int* Ms = reinterpret_cast<int*>(delta_s + kTile);

  const int t0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  for (int e = tid; e < kTile * D; e += kBwdThreads) {
    const int r = e / D, d = e % D;
    const bool in = t0 + r < a.T;
    Ks[r * KS + d] = in ? to_f(k[(long long)(t0 + r) * a.k_st + d]) : 0.f;
    Vs[r * KS + d] = in ? to_f(v[(long long)(t0 + r) * a.v_st + d]) : 0.f;
  }
  for (int r = tid; r < kTile; r += kBwdThreads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;

  // Query rows that can see a key of this tile: from the causal bound of its
  // first key, up to the window edge of its last key.
  const int t_last = min(t0 + kTile, a.T) - 1;
  int r_lo = a.causal ? max(0, t0 - a.q_offset) : 0;
  int r_hi = a.S;
  if (a.window > 0) r_hi = min(r_hi, t_last + a.window - a.q_offset);
  const int i_lo = r_lo / kTile;
  const int i_hi = r_hi > r_lo ? (r_hi + kTile - 1) / kTile : i_lo;

  float dk_acc[kWarpRows][DC], dv_acc[kWarpRows][DC];
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  const int ta = t0 + lane, tb = t0 + lane + 32;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
    const float* delta = a.delta + ((long long)b * a.H + h) * a.S;
    for (int i = i_lo; i < i_hi; ++i) {
      const int r0 = i * kTile;
      __syncthreads();  // K/V are staged / the previous q tile is consumed
      stage_rows<T, D>(Qs, D, q, a.q_ss, r0, a.S);
      stage_rows<T, D>(Os, D, dout, a.o_ss, r0, a.S);
      for (int r = tid; r < kTile; r += kBwdThreads) {
        lse_s[r] = r0 + r < a.S ? lse[r0 + r] : 0.f;
        delta_s[r] = r0 + r < a.S ? delta[r0 + r] : 0.f;
      }
      __syncthreads();

      // P and dS for the warp's rows against keys lane, lane + 32
      float s0[kWarpRows], s1[kWarpRows], dp0[kWarpRows], dp1[kWarpRows];
      scores_and_dp<D>(Qs + w * kWarpRows * D, Os + w * kWarpRows * D, Ks, Vs, lane, s0, s1, dp0,
                       dp1);
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const int lr = w * kWarpRows + r;
        const int row = r0 + lr;
        const int qpos = a.q_offset + row;
        const bool va = row < a.S && Ms[lane] != 0 && visible(ta, qpos, a.causal, a.window);
        const bool vb = row < a.S && Ms[lane + 32] != 0 && visible(tb, qpos, a.causal, a.window);
        const float pa = va ? expf(s0[r] * a.scale - lse_s[lr]) : 0.f;
        const float pb = vb ? expf(s1[r] * a.scale - lse_s[lr]) : 0.f;
        Ps[lr * kTile + lane] = pa;
        Ps[lr * kTile + lane + 32] = pb;
        dSs[lr * kTile + lane] = pa * (dp0[r] - delta_s[lr]) * a.scale;
        dSs[lr * kTile + lane + 32] = pb * (dp1[r] - delta_s[lr]) * a.scale;
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: warp owns keys w*8.., lane columns lane + 32c
      for (int qr = 0; qr < kTile; ++qr) {
        const float4 p_lo = *reinterpret_cast<const float4*>(Ps + qr * kTile + w * kWarpRows);
        const float4 p_hi = *reinterpret_cast<const float4*>(Ps + qr * kTile + w * kWarpRows + 4);
        const float4 s_lo = *reinterpret_cast<const float4*>(dSs + qr * kTile + w * kWarpRows);
        const float4 s_hi = *reinterpret_cast<const float4*>(dSs + qr * kTile + w * kWarpRows + 4);
        const float pv[kWarpRows] = {p_lo.x, p_lo.y, p_lo.z, p_lo.w,
                                     p_hi.x, p_hi.y, p_hi.z, p_hi.w};
        const float dsv[kWarpRows] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w,
                                      s_hi.x, s_hi.y, s_hi.z, s_hi.w};
        float ov[DC], qv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = Os[qr * D + lane + 32 * c];
          qv[c] = Qs[qr * D + lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[j][c] = fmaf(pv[j], ov[c], dv_acc[j][c]);
            dk_acc[j][c] = fmaf(dsv[j], qv[c], dk_acc[j][c]);
          }
      }
    }
  }

  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j) {
    const int t = t0 + w * kWarpRows + j;
    if (t >= a.T) continue;
    const long long base = (((long long)b * a.T + t) * a.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[base + lane + 32 * c] = from_f<T>(dk_acc[j][c]);
      dv[base + lane + 32 * c] = from_f<T>(dv_acc[j][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO tiles, K, V tiles (padded rows), dS per warp, lse, delta, key mask
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) + kTile * kTile + 2 * kTile) +
         sizeof(int) * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int KS = D + 1;
  constexpr int DC = D / 32;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kTile][D]
  float* Os = Qs + kTile * D;        // [kTile][D]
  float* Ks = Os + kTile * D;        // [kTile][KS]
  float* Vs = Ks + kTile * KS;       // [kTile][KS]
  float* dSs = Vs + kTile * KS;      // [kTile q][kTile keys], each warp its own rows
  float* lse_s = dSs + kTile * kTile;
  float* delta_s = lse_s + kTile;
  int* Ms = reinterpret_cast<int*>(delta_s + kTile);

  const int r0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
  const float* delta = a.delta + ((long long)b * a.H + h) * a.S;
  stage_rows<T, D>(Qs, D, q, a.q_ss, r0, a.S);
  stage_rows<T, D>(Os, D, dout, a.o_ss, r0, a.S);
  for (int r = tid; r < kTile; r += kBwdThreads) {
    lse_s[r] = r0 + r < a.S ? lse[r0 + r] : 0.f;
    delta_s[r] = r0 + r < a.S ? delta[r0 + r] : 0.f;
  }

  // Keys this tile of queries can see: up to the causal bound of its last
  // row, from the window edge of its first row.
  const int rows = min(kTile, a.S - r0);
  const int first_q = a.q_offset + r0;
  const int last_q = first_q + rows - 1;
  const int t_end = a.causal ? min(a.T, last_q + 1) : a.T;
  int t_begin = a.window > 0 ? max(0, first_q - a.window + 1) : 0;
  t_begin -= t_begin % kTile;

  float acc[kWarpRows][DC];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  const float* qw = Qs + w * kWarpRows * D;
  const float* ow = Os + w * kWarpRows * D;
  float* dsw = dSs + w * kWarpRows * kTile;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    __syncthreads();  // Q/dO are staged / the previous key tile is consumed
    for (int e = tid; e < kTile * D; e += kBwdThreads) {
      const int r = e / D, d = e % D;
      const bool in = t0 + r < a.T;
      Ks[r * KS + d] = in ? to_f(k[(long long)(t0 + r) * a.k_st + d]) : 0.f;
      Vs[r * KS + d] = in ? to_f(v[(long long)(t0 + r) * a.v_st + d]) : 0.f;
    }
    for (int r = tid; r < kTile; r += kBwdThreads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;
    __syncthreads();

    float s0[kWarpRows], s1[kWarpRows], dp0[kWarpRows], dp1[kWarpRows];
    scores_and_dp<D>(qw, ow, Ks, Vs, lane, s0, s1, dp0, dp1);
    const int ta = t0 + lane, tb = t0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const int lr = w * kWarpRows + r;
      const int row = r0 + lr;
      const int qpos = a.q_offset + row;
      const bool va = row < a.S && Ms[lane] != 0 && visible(ta, qpos, a.causal, a.window);
      const bool vb = row < a.S && Ms[lane + 32] != 0 && visible(tb, qpos, a.causal, a.window);
      const float pa = va ? expf(s0[r] * a.scale - lse_s[lr]) : 0.f;
      const float pb = vb ? expf(s1[r] * a.scale - lse_s[lr]) : 0.f;
      dsw[r * kTile + lane] = pa * (dp0[r] - delta_s[lr]) * a.scale;
      dsw[r * kTile + lane + 32] = pb * (dp1[r] - delta_s[lr]) * a.scale;
    }
    __syncwarp();

    // dQ += dS K: lane owns columns lane + 32c of the warp's rows
    for (int j = 0; j < kTile; j += 4) {
      float kv[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DC; ++c) kv[jj][c] = Ks[(j + jj) * KS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
        const float4 ds = *reinterpret_cast<const float4*>(dsw + r * kTile + j);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          acc[r][c] = fmaf(ds.x, kv[0][c], fmaf(ds.y, kv[1][c],
                      fmaf(ds.z, kv[2][c], fmaf(ds.w, kv[3][c], acc[r][c]))));
      }
    }
  }

  T* dq = static_cast<T*>(a.out0);
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = r0 + w * kWarpRows + r;
    if (row >= a.S) continue;
    T* o = dq + (((long long)b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[lane + 32 * c] = from_f<T>(acc[r][c]);
  }
}

template <typename T, int D>
int launch_dkdv(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.T + kTile - 1) / kTile, a.Hkv, a.B);
  flash_bwd_dkdv_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The one head size instantiated, as in flash_prefill.cu: StarVector-1B's 128.
constexpr int kBwdD = 128;

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const int* mask, void* out0, void* out1,
                  int B, int S, int T, int H, int Hkv, const long long* st, long long m_sb,
                  int q_offset, int causal, int window, float scale) {
  return BwdArgs{q, k, v, dout, lse, delta, mask, out0, out1, B, S, T, H, Hkv, H / Hkv,
                 st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                 st[9], st[10], st[11], m_sb, q_offset, causal, window, scale};
}

}  // namespace
}  // namespace sv

// Both entry points return cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a dtype / head size the kernels do
// not take (they take D = 128). `strides` holds 12 values: q's (b, s, h),
// k's (b, t, h), v's (b, t, h) and dO's (b, s, h).
extern "C" int sv_flash_bwd_dkdv(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* mask, void* dk, void* dv,
    int B, int S, int T, int H, int Hkv, const long long* strides, long long m_sb,
    int q_offset, int causal, int window, float scale, void* stream) {
  const sv::BwdArgs a = sv::make_args(q, k, v, dout, lse, delta, mask, dk, dv, B, S, T, H, Hkv,
                                      strides, m_sb, q_offset, causal, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != sv::kBwdD) return (int)cudaErrorInvalidValue;
  if (dtype == sv::kFloat32) return sv::launch_dkdv<float, sv::kBwdD>(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_dkdv<__nv_bfloat16, sv::kBwdD>(a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sv_flash_bwd_dq(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* mask, void* dq,
    int B, int S, int T, int H, int Hkv, const long long* strides, long long m_sb,
    int q_offset, int causal, int window, float scale, void* stream) {
  const sv::BwdArgs a = sv::make_args(q, k, v, dout, lse, delta, mask, dq, nullptr, B, S, T, H,
                                      Hkv, strides, m_sb, q_offset, causal, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != sv::kBwdD) return (int)cudaErrorInvalidValue;
  if (dtype == sv::kFloat32) return sv::launch_dq<float, sv::kBwdD>(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_dq<__nv_bfloat16, sv::kBwdD>(a, st);
  return (int)cudaErrorInvalidValue;
}
