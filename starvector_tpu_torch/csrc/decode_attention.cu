// Decode attention for Hopper (sm_90a): one new query token per row against
// the KV cache, with the new token's own key and value optionally merged into
// the same softmax.
//
// Replaces the Pallas TPU kernel starvector_tpu/ops/flash_attention.py::
// mqa_decode_batched -> _decode_all_kernel (and, through gqa_decode_batched,
// mqa_decode and gqa_decode, _decode_kernel, which computes the same), and
// the XLA attention of starvector_tpu/models/decode_common.py::
// merged_decode_attention, which the JAX decoder runs once per layer for
// every generated token.
//
// Contract: q is (B, Hkv, G, D), the G query heads that share one KV head;
// the cache k, v is (B, T, Hkv, D); kv_mask is (B, T) int32. Key t is
// visible when t_begin <= t < t_end and kv_mask[b, t] != 0 (the Pallas
// kernel's window start, valid length and key mask). When k_new and v_new
// (B, Hkv, D) are given, the new token's self-score joins the same softmax:
// the cache does not hold the new token yet, and the caller writes it once
// after all layers. out is a contiguous (B, Hkv, G, D) tensor of q's type.
// All tensors are read through their strides (last dim contiguous).
//
// What bounds it on the H100: the kernel reads the visible cache once,
// 2 * T * D elements per (row, KV head): at the StarVector-1B decode
// (Hkv = 1, D = 128, T ~ 400, bf16) about 200 KB per row, a fraction of a
// microsecond of HBM time. So it is bound by latency and by how few blocks
// there are: one per (row, KV head), 4 blocks on 132 SMs at B = 4.
// What the design does about it: the block's 8 warps share the keys out in
// tiles of 32, one key per lane, each warp with its own online softmax over
// all G query heads, so 8 tiles of K and V are in flight per block; a tile
// whose keys are all masked is not read, nor is a masked key's row. The
// per-warp states are merged in shared memory at the end, together with the
// self token. Splitting the keys across blocks (split-KV) and tensor-core
// products are later work.

#include <stdint.h>

#include "common.cuh"

namespace sv {
namespace {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_new;  // null: no self token
  const void* v_new;
  const int* mask;
  void* out;
  int B, Hkv;
  long long q_sb, q_sh, q_sg;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long kn_sb, kn_sh, vn_sb, vn_sh;
  long long m_sb;
  int t_begin, t_end;
  float scale;
};

template <int G, int D>
constexpr size_t decode_smem_bytes() {
  return sizeof(float) *
         (G * D + kDecWarps * G * 32 + kDecWarps * G * D + 2 * kDecWarps * G + G);
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(kDecThreads) decode_attention_kernel(const DecodeArgs a) {
  constexpr int DC = D / 32;  // output columns per lane, contiguous
  extern __shared__ float smem[];
  float* Qs = smem;                      // [G][D] query
  float* Ps = Qs + G * D;                // [warps][G][32] probabilities of a tile
  float* Acc = Ps + kDecWarps * G * 32;  // [warps][G][D] per-warp numerators
  float* Ms = Acc + kDecWarps * G * D;   // [warps][G] per-warp running max
  float* Ls = Ms + kDecWarps * G;        // [warps][G] per-warp denominators
  float* Ss = Ls + kDecWarps * G;        // [G] self scores

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const bool has_new = a.k_new != nullptr;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hk * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;

  for (int e = tid; e < G * D; e += kDecThreads) {
    Qs[e] = to_f(q[(e / D) * a.q_sg + e % D]);
  }
  __syncthreads();

  if (has_new) {
    const T* kn = static_cast<const T*>(a.k_new) + b * a.kn_sb + hk * a.kn_sh;
    for (int g = w; g < G; g += kDecWarps) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(Qs[g * D + d], to_f(kn[d]), s);
      s = warp_sum(s);
      if (lane == 0) Ss[g] = s * a.scale;
    }
  }

  float m[G], l[G], acc[G][DC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }
  float* pw = Ps + w * G * 32;

  for (int t0 = (a.t_begin / 32) * 32 + w * 32; t0 < a.t_end; t0 += kDecWarps * 32) {
    const int t = t0 + lane;
    const bool valid = t >= a.t_begin && t < a.t_end && mask[t] != 0;
    const unsigned live = __ballot_sync(0xffffffffu, valid);
    if (live == 0u) continue;  // the whole tile is masked

    // scores: lane owns key t, for all G heads
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = k + (long long)t * a.k_st;
#pragma unroll 2
      for (int d = 0; d < D; d += 8) {
        float kf[8];
        load_vec<8>(kr + d, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(Qs + g * D + d);
          const float4 qb = *reinterpret_cast<const float4*>(Qs + g * D + d + 4);
          float x = s[g];
          x = fmaf(qa.x, kf[0], x);
          x = fmaf(qa.y, kf[1], x);
          x = fmaf(qa.z, kf[2], x);
          x = fmaf(qa.w, kf[3], x);
          x = fmaf(qb.x, kf[4], x);
          x = fmaf(qb.y, kf[5], x);
          x = fmaf(qb.z, kf[6], x);
          x = fmaf(qb.w, kf[7], x);
          s[g] = x;
        }
      }
    }

    // online softmax per head across the warp's 32 keys
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = valid ? s[g] * a.scale : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float corr = expf(m[g] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[g][c] *= corr;
      pw[g * 32 + lane] = p;
    }
    __syncwarp();

    // acc += P V over the live keys of the tile
    unsigned rest = live;
    while (rest != 0u) {
      const int j = __ffs(rest) - 1;
      rest &= rest - 1u;
      float vv[DC];
      load_vec<DC>(v + (long long)(t0 + j) * a.v_st + lane * DC, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = pw[g * 32 + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      Ms[w * G + g] = m[g];
      Ls[w * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) Acc[(w * G + g) * D + lane * DC + c] = acc[g][c];
  }
  __syncthreads();

  // merge the warps' partial softmaxes and the self token
  const T* vn = has_new ? static_cast<const T*>(a.v_new) + b * a.vn_sb + hk * a.vn_sh : nullptr;
  T* out = static_cast<T*>(a.out) + ((long long)b * a.Hkv + hk) * G * D;
  for (int e = tid; e < G * D; e += kDecThreads) {
    const int g = e / D, d = e % D;
    float M = has_new ? Ss[g] : kNegInf;
#pragma unroll
    for (int u = 0; u < kDecWarps; ++u) M = fmaxf(M, Ms[u * G + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int u = 0; u < kDecWarps; ++u) {
      const float c = expf(Ms[u * G + g] - M);
      L = fmaf(Ls[u * G + g], c, L);
      O = fmaf(Acc[(u * G + g) * D + d], c, O);
    }
    if (has_new) {
      const float ps = expf(Ss[g] - M);
      L += ps;
      O = fmaf(ps, to_f(vn[d]), O);
    }
    out[e] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int G, int D>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<G, D>();
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(a.Hkv, a.B);
  decode_attention_kernel<T, G, D><<<grid, kDecThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The one shape instantiated: StarVector-1B's, 16 query heads per KV head
// and head size 128. Another group or head size is another instantiation,
// added with the model that needs it and a check of it on the card.
constexpr int kDecG = 16;
constexpr int kDecD = 128;

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype, group size or head size the kernel
// does not take (it takes G = 16, D = 128). k_new and v_new are both null
// or both set.
extern "C" int sv_decode_attention(
    int dtype, int G, int D, const void* q, const void* k, const void* v,
    const void* k_new, const void* v_new, const int* mask, void* out,
    int B, int Hkv,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long kn_sb, long long kn_sh, long long vn_sb, long long vn_sh,
    long long m_sb, int t_begin, int t_end, float scale, void* stream) {
  const sv::DecodeArgs a{q, k, v, k_new, v_new, mask, out, B, Hkv,
                         q_sb, q_sh, q_sg, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                         kn_sb, kn_sh, vn_sb, vn_sh, m_sb, t_begin, t_end, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G != sv::kDecG || D != sv::kDecD) return (int)cudaErrorInvalidValue;
  if (dtype == sv::kFloat32) return sv::launch_decode<float, sv::kDecG, sv::kDecD>(a, st);
  if (dtype == sv::kBFloat16) {
    return sv::launch_decode<__nv_bfloat16, sv::kDecG, sv::kDecD>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
