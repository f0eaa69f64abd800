// Decode attention for Hopper (sm_90a): one new query token per row against
// the KV cache, with the new token's own key and value optionally merged into
// the same softmax.
//
// Replaces the Pallas TPU kernels starvector_tpu/ops/flash_attention.py::
// mqa_decode_batched -> _decode_all_kernel (:2049, call :2076) and
// mqa_decode -> _decode_kernel (:2202, call :2229), which compute the same,
// and the XLA attention of starvector_tpu/models/decode_common.py::
// merged_decode_attention (:186-234), which the JAX decoder runs once per
// layer for every generated token.
//
// Contract: q is (B, Hkv, G, D), the G query heads that share one KV head;
// the cache k, v is (B, T, Hkv, D); kv_mask is (B, T) int32. Key t is
// visible when t_begin <= t < t_end and kv_mask[b, t] != 0 (the Pallas
// kernel's window start, valid length and key mask). When k_new and v_new
// (B, Hkv, D) are given, the new token's self-score joins the same softmax:
// the cache does not hold the new token yet, and the caller writes it once
// after all layers. out is a contiguous (B, Hkv, G, D) tensor of q's type.
// All tensors are read through their strides (last dim contiguous). An int8
// cache (the JAX package's init_cache(dtype=int8)) holds codes with fp32
// scales k_scale, v_scale (B, T, Hkv).
//
// Key bounds from the device: where `bounds` is given (an int32 [t_begin,
// t_end] on the card), every block reads it at entry, and the host's t_end
// is only a cap, t_cap >= t_end (the keys the grid was planned for). So one
// launch serves every step of a decode loop captured in a CUDA graph: the
// write index moves on the device, the launch's arguments stay the same.
// t_lo is then t_begin rounded down to the 128-key tile, computed in the
// kernel; a split whose chunk starts at or past t_end writes an empty
// partial (m = -1e30, l = 0), which the merge weighs by exp(-1e30 - M) = 0.
//
// What bounds it on the H100: the visible cache, read once: 2 * B * T * Hkv
// * D elements (bf16: 0.67 MB at the 1B decode, B = 4, T = 325: 0.2 us of
// HBM time; 5.4 MB at B = 8, T = 1285: 1.6 us). The arithmetic is 4 G D
// operations a key, far below the tensor cores' rate. So the kernel is bound
// by latency and by how many blocks share the work: one block per (row, KV
// head) gave 4 blocks on 132 SMs at B = 4, each walking all T keys.
//
// What the design does about it:
// * Split-KV grid (splits, Hkv, B). The keys [t_lo, t_end) (t_lo = t_begin
//   rounded down to the 128-key tile) are cut into `splits` chunks of
//   `chunk` keys (128 or 256, chosen on the host by ops/flash_attention.py::
//   decode_splits for about one wave of the card's SMs); each block takes
//   one chunk and writes its partial softmax state (m, l, acc[G][D], fp32)
//   to a workspace.
// * Merge in the same launch, in a fixed order. After its partial is
//   written (and a block barrier), each block takes a ticket: one thread's
//   atomic add, with release and acquire semantics at device scope, on a
//   per-(row, KV head) counter; the block that draws the last ticket reads every
//   partial back through L2 (__ldcg) and merges them with the self token
//   in split order (every block computed the self token's scores and staged
//   v_new at its start, beside its copies), divides and writes out, then
//   resets the counter to 0.
//   The counters are zeroed once by the host and left at zero by every
//   launch, so the kernel replays correctly inside a CUDA graph. Nothing is
//   summed with atomics: two launches give the same bits.
// * bf16 queries (bf16 cache, or int8 codes converted to bf16, which is
//   exact as JAX's k_cached.astype(dt) is) run decode_attention_bf16_kernel
//   on the tensor cores with mma.sync.m16n8k16 (fp32 sums): the G query
//   heads are the product's 16 rows of M (at G = 9, rows 9-15 of Q are zero:
//   each row's softmax is its own, and those rows' states are never
//   written), so S = Q K^T is (16 x 128)(128 x keys) and O += P V is
//   (16 x keys)(keys x 128). Each of 8 warps owns 16 keys of every 128-key
//   tile with its own online softmax; the S accumulators of two adjacent n8
//   key tiles are already the A operand of the P V product (no shared
//   memory trip for P); K and V fragments come from shared memory through
//   ldmatrix (V transposed). wgmma would need 64 query rows and waste three
//   quarters of them. Each warp copies its keys' K and V rows with cp.async
//   (16 bytes a piece) into a two-slot ring, the next 16 keys in flight
//   while the current ones are computed; a 16-key group whose keys are all
//   invisible is neither read nor computed, an invisible key's row is
//   zero-filled, not read.
// * fp32 queries (over an fp32 cache or int8 codes) run
//   decode_attention_f32_kernel on the CUDA cores, with the same split grid,
//   workspace and merge: 8 warps each take 32 keys a step, one key a lane.
//
// Numerics, as the JAX function computes them: s = (q . k in fp32) * scale,
// then * k_scale[t] for an int8 cache; p = exp(s - m); the P V operand is p
// rounded to bf16, or p * v_scale[t] rounded for an int8 cache (fp32 queries:
// not rounded); the denominator sums the unrounded p; the self token's score
// and P V term stay in fp32 from its unquantized k_new / v_new; the final
// division guards with max(l, 1e-30). p is rounded relative to the running
// max of the warp that owns the key (at most 16 keys a step), as the Pallas
// _decode_all_kernel rounds it relative to its block's running max
// (flash_attention.py:2025-2032); XLA's merged function rounds relative to
// the global max; the two differ by less than one bf16 step of p. Masked
// scores never reach exp: p is 0 by selection, the running max starts at
// the finite -1e30, so a chunk or warp that sees no key keeps m = -1e30,
// l = 0 and merges with weight exp(-1e30 - M), 0 or 1 times zeros.
//
// The ops/flash_attention.py grid plan for device bounds: decode_splits at
// t_cap keys from slot 0, so splits x chunk >= t_cap >= t_end - t_lo
// whatever t_begin the device holds.

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"  // cp_async_16, cp_async_commit, cp_async_wait, smem_u32

namespace sv {
namespace {

// The shapes instantiated: head size 128 and G query heads per KV head,
// G = 16 (StarVector-1B, multi-query), G = 9 (StarVector-8B, 36 query
// heads over 4 KV heads, whole or on a tensor-4 rank), G = 5 and 4 (the
// 8B's tensor-8 ranks: each KV head's 9 query heads split 5 + 4) and G = 8,
// 4 and 2 (the 1B's tensor-2, -4 and -8 ranks: 16 / tp query heads over its
// one KV head), each over a cache of q's type or of int8 codes
// (launch_group). Another group or
// head size is another instantiation, added with the model that needs it
// and a check of it on the card.
constexpr int kDecD = 128;
constexpr int kKeyTile = 128;  // chunks are multiples of it (decode_splits)

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// fp32 elements of one split's partial in the workspace, acc[G][D], m[G],
// l[G], padded to whole float4s (ops/flash_attention.py::decode_partial_floats)
__host__ __device__ constexpr int partial_floats(int G, int D) { return round4(G * D + 2 * G); }

// shared fp32 elements of the self token: its scores Ss[G], padded so that
// v_new Vn[D] after them starts on a float4
__host__ __device__ constexpr int self_floats(int G, int D) { return round4(G) + D; }

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* k_new;  // null: no self token
  const void* v_new;
  const int* mask;
  const int* bounds;     // null, or [t_begin, t_end] on the device (t_end below is then its cap)
  const float* k_scale;  // int8 cache only
  const float* v_scale;
  void* out;
  float* ws;     // [B * Hkv][splits][partial_floats(G, D)] fp32 partials (acc, m, l)
  int* tickets;  // [B * Hkv], zero before and after every launch
  int B, Hkv;
  long long q_sb, q_sh, q_sg;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long kn_sb, kn_sh, vn_sb, vn_sh;
  long long ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh;
  long long m_sb;
  int t_begin, t_end;
  int t_lo, chunk, splits;  // split s takes keys [t_lo + s chunk, t_lo + (s + 1) chunk)
  float scale;
};

// The keys a launch sees: [begin, end), its splits counted from lo. From
// the arguments, or read from `bounds` on the device: begin clamped to
// [0, end], end to the host's cap, lo begin rounded down to the key tile.
struct KeyRange {
  int begin, end, lo;
};

__device__ __forceinline__ KeyRange key_range(const DecodeArgs& a) {
  if (a.bounds == nullptr) return {a.t_begin, a.t_end, a.t_lo};
  const int end = max(min(__ldg(a.bounds + 1), a.t_end), 0);
  const int begin = min(max(__ldg(a.bounds), 0), end);
  return {begin, end, begin - begin % kKeyTile};
}

// ---------------------------------------------------------------------------
// what both kernels share: the self token, the block's partial, the ticket,
// the merge
// ---------------------------------------------------------------------------

// Every block, at its start: the self token's scores (fp32 dot products of
// q with the unquantized k_new, times scale) into Ss[G] and v_new as fp32
// into Vn[D] (Ss + round4(G): float4-aligned), so that the block that merges
// last finds them in shared memory. T is q's type.
template <typename T, int G, int D, int NT>
__device__ __forceinline__ void load_self(const DecodeArgs& a, int b, int hk, float* Ss,
                                          float* Vn) {
  if (a.k_new == nullptr) return;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hk * a.q_sh;
  const T* kn = static_cast<const T*>(a.k_new) + b * a.kn_sb + hk * a.kn_sh;
  const T* vn = static_cast<const T*>(a.v_new) + b * a.vn_sb + hk * a.vn_sh;
  for (int d = tid; d < D; d += NT) Vn[d] = to_f(vn[d]);
  for (int g = w; g < G; g += NT / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(to_f(q[g * a.q_sg + d]), to_f(kn[d]), s);
    s = warp_sum(s);
    if (lane == 0) Ss[g] = s * a.scale;
  }
}

// The block's W warps have left their softmax states in shared memory:
// Ms[w][g], Ls[w][g] (running max, denominator) and Acc[w][g][d]
// (numerator). Merges them in warp order into the block's partial, writes it
// to the workspace, takes a ticket, and if it is the last block of its
// (row, KV head), merges the self token (Ss, Vn from load_self) and all
// partials in split order and writes out. T is q's (and out's) type.
template <typename T, int G, int D, int W, int NT>
__device__ __forceinline__ void decode_finish(const DecodeArgs& a, int b, int hk, int split,
                                              const float* Ms, const float* Ls,
                                              const float* Acc, const float* Ss,
                                              const float* Vn, int* last) {
  constexpr int P = partial_floats(G, D);  // floats of one partial
  constexpr int V4 = G * D / 4;             // float4s of one numerator
  constexpr int IT = (V4 + NT - 1) / NT;    // of which each thread takes at most
  static_assert(D % 4 == 0, "a numerator row is whole float4s");
  const int tid = threadIdx.x;
  const long long bh = (long long)b * a.Hkv + hk;
  float* part = a.ws + (bh * a.splits + split) * P;

  // 1. the block's partial: its warps' states merged in warp order
  for (int e = tid; e < V4; e += NT) {
    const int g = 4 * e / D;
    float M = kNegInf;
#pragma unroll
    for (int u = 0; u < W; ++u) M = fmaxf(M, Ms[u * G + g]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const float c = expf(Ms[u * G + g] - M);
      const float4 x = reinterpret_cast<const float4*>(Acc + u * G * D)[e];
      o.x = fmaf(x.x, c, o.x);
      o.y = fmaf(x.y, c, o.y);
      o.z = fmaf(x.z, c, o.z);
      o.w = fmaf(x.w, c, o.w);
    }
    reinterpret_cast<float4*>(part)[e] = o;
  }
  if (tid < G) {
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int u = 0; u < W; ++u) M = fmaxf(M, Ms[u * G + tid]);
#pragma unroll
    for (int u = 0; u < W; ++u) L = fmaf(Ls[u * G + tid], expf(Ms[u * G + tid] - M), L);
    part[G * D + tid] = M;
    part[G * D + G + tid] = L;
  }

  // 2. the ticket: the last block of this (row, KV head) to finish merges.
  // The barrier orders the block's writes before thread 0's ticket, an
  // atomic add with release and acquire semantics at device scope: it
  // publishes this block's partial and, for the last block, makes every
  // other block's visible to the merge's reads after the second barrier.
  __syncthreads();
  if (tid == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.tickets + bh) : "memory");
    *last = prev == (unsigned)a.splits - 1u;
  }
  __syncthreads();
  if (*last == 0) return;

  // 3. the merge: the max over the self score and the splits' maxima, then
  // the self token and the partials in split order, each weighted by
  // exp(m_s - max) (no chain of exponentials from one split to the next)
  const bool has_new = a.k_new != nullptr;
  const float* base = a.ws + bh * a.splits * P;
  float M[IT], L[IT];
  float4 o[IT];
  // a thread's i-th float4 is e = tid + i NT, of row g; where G D / 4 is
  // not a multiple of the threads, the last e of some threads lie past the
  // numerator: they compute row G - 1's weights, read nothing and write nothing
  auto row = [&](int i) { return min(4 * (tid + i * NT) / D, G - 1); };
#pragma unroll
  for (int i = 0; i < IT; ++i) M[i] = has_new ? Ss[row(i)] : kNegInf;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
#pragma unroll
    for (int i = 0; i < IT; ++i) M[i] = fmaxf(M[i], __ldcg(base + s * P + G * D + row(i)));
  }
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = tid + i * NT, g = row(i);
    const float ps = has_new ? expf(Ss[g] - M[i]) : 0.f;
    const float4 vn = has_new ? reinterpret_cast<const float4*>(Vn)[e % (D / 4)]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    L[i] = ps;
    o[i] = make_float4(ps * vn.x, ps * vn.y, ps * vn.z, ps * vn.w);
  }
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const float* ps = base + s * P;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int e = tid + i * NT, g = row(i);
      const float c = expf(__ldcg(ps + G * D + g) - M[i]);
      const float4 x = e < V4 ? __ldcg(reinterpret_cast<const float4*>(ps) + e)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      L[i] = fmaf(__ldcg(ps + G * D + G + g), c, L[i]);
      o[i].x = fmaf(x.x, c, o[i].x);
      o[i].y = fmaf(x.y, c, o[i].y);
      o[i].z = fmaf(x.z, c, o[i].z);
      o[i].w = fmaf(x.w, c, o[i].w);
    }
  }
  T* out = static_cast<T*>(a.out) + bh * G * D;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int e = tid + i * NT;
    if (e >= V4) break;
    const float l = fmaxf(L[i], 1e-30f);
    out[4 * e + 0] = from_f<T>(o[i].x / l);
    out[4 * e + 1] = from_f<T>(o[i].y / l);
    out[4 * e + 2] = from_f<T>(o[i].z / l);
    out[4 * e + 3] = from_f<T>(o[i].w / l);
  }
  if (tid == 0) a.tickets[bh] = 0;  // ready for the next launch (and graph replay)
}

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores (mma.sync), bf16 or int8 cache
// ---------------------------------------------------------------------------

constexpr int kSub = 16;                    // keys a warp step
constexpr int kMmaRows = 16;                // the product's M: G query rows, zeros below them
constexpr int kMmaWarps = kKeyTile / kSub;  // 8
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kLd = kDecD + 8;              // bf16 elements a shared row (ldmatrix without bank conflicts)
constexpr int kLdQ = kDecD + 16;            // bytes a shared row of int8 codes

// bytes of shared memory a warp's ring takes: two slots of K and V rows
// (bf16, or int8 codes and one bf16 slot they are converted into)
template <typename C>
__host__ __device__ constexpr int mma_warp_bytes() {
  return sizeof(C) == 1 ? 2 * 2 * kSub * kLdQ + 2 * kSub * kLd * 2 : 2 * 2 * kSub * kLd * 2;
}

template <typename C, int G>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  constexpr size_t ring = (size_t)kMmaWarps * mma_warp_bytes<C>();
  constexpr size_t merge = sizeof(float) * (kMmaWarps * G * kDecD + 2 * kMmaWarps * G + 1);
  return kMmaRows * kLd * 2 + sizeof(float) * self_floats(G, kDecD) +
         (ring > merge ? ring : merge);
}

template <typename C, int G>
__global__ void __launch_bounds__(kMmaThreads) decode_attention_bf16_kernel(const DecodeArgs a) {
  constexpr int D = kDecD;
  static_assert(G <= kMmaRows, "the query heads of a KV head fill at most the product's 16 rows");
  constexpr bool kQuant = sizeof(C) == 1;
  constexpr int kPieces = D * (int)sizeof(C) / 16;  // 16-byte pieces of a K or V row
  constexpr int kRowBytes = kQuant ? kLdQ : kLd * 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);     // [kMmaRows][kLd]
  float* Ss = reinterpret_cast<float*>(smem_raw + kMmaRows * kLd * 2);  // [G] self scores
  float* Vn = Ss + round4(G);                                           // [D] v_new
  uint8_t* rings = reinterpret_cast<uint8_t*>(Vn + D);

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  const C* k = static_cast<const C*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const C* v = static_cast<const C*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  const float* ksc = kQuant ? a.k_scale + b * a.ks_sb + hk * a.ks_sh : nullptr;
  const float* vsc = kQuant ? a.v_scale + b * a.vs_sb + hk * a.vs_sh : nullptr;

  // this block's keys, and this warp's 16-key groups in them: c0 + (w + 8 i) 16
  const KeyRange kr = key_range(a);
  const int c0 = kr.lo + split * a.chunk;
  const int c1 = min(c0 + a.chunk, kr.end);
  const int first = c0 + w * kSub;
  const int n_sub = first < c1 ? (c1 - first + kKeyTile - 1) / kKeyTile : 0;
  uint8_t* ring = rings + w * mma_warp_bytes<C>();  // [slot][K, V][kSub][row]
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(ring + 2 * 2 * kSub * kLdQ);  // int8: [K, V][kSub][kLd]

  // copies group i's visible K and V rows into ring slot i % 2 (zeros for
  // invisible keys) and commits one group; returns the visible keys' bits
  auto issue = [&](int i) -> unsigned {
    const int t0 = first + i * kKeyTile;
    const int t = t0 + (lane & (kSub - 1));
    const bool vis = t >= kr.begin && t < kr.end && mask[t] != 0;
    const unsigned live = __ballot_sync(0xffffffffu, vis) & 0xffffu;
    if (live != 0u) {
      uint8_t* slot = ring + (i & 1) * 2 * kSub * kRowBytes;
#pragma unroll
      for (int p = lane; p < kSub * kPieces; p += 32) {
        const int r = p / kPieces, c = p % kPieces;
        const bool in = (live >> r) & 1u;
        const long long row = in ? t0 + r : 0;
        const int off = c * 16 / (int)sizeof(C);
        cp_async_16(smem_u32(slot + r * kRowBytes + c * 16), k + row * a.k_st + off, in);
        cp_async_16(smem_u32(slot + (kSub + r) * kRowBytes + c * 16), v + row * a.v_st + off, in);
      }
    }
    cp_async_commit();
    return live;
  };

  unsigned live_cur = n_sub > 0 ? issue(0) : 0u;

  // Q as bf16 into shared memory, rows G to 15 zero (with G < 16 their
  // scores, partials and outputs are computed and never read), then its A
  // fragments into registers
  {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + hk * a.q_sh;
    for (int e = tid; e < kMmaRows * D; e += kMmaThreads) {
      const int r = e / D, c = e % D;
      Qs[r * kLd + c] = r < G ? q[r * a.q_sg + c] : __float2bfloat16(0.f);
    }
  }
  load_self<__nv_bfloat16, G, D, kMmaThreads>(a, b, hk, Ss, Vn);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    qa[s][0] = *reinterpret_cast<const uint32_t*>(Qs + g * kLd + 16 * s + 2 * t4);
    qa[s][1] = *reinterpret_cast<const uint32_t*>(Qs + (g + 8) * kLd + 16 * s + 2 * t4);
    qa[s][2] = *reinterpret_cast<const uint32_t*>(Qs + g * kLd + 16 * s + 2 * t4 + 8);
    qa[s][3] = *reinterpret_cast<const uint32_t*>(Qs + (g + 8) * kLd + 16 * s + 2 * t4 + 8);
  }

  // per thread: rows g and g + 8, their running max, this thread's share of
  // their denominators, and acc[n] for output columns 8 n + 2 t4, + 1
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  const int k_row = (mi >> 1) * 8 + mr, k_col = (mi & 1) * 8;  // K: keys 0-7 / 8-15 x d +0 / +8
  const int v_row = (mi & 1) * 8 + mr, v_col = (mi >> 1) * 8;  // V^T: keys 0-7 / 8-15, d +0 / +8

  for (int i = 0; i < n_sub; ++i) {
    const unsigned live_next = i + 1 < n_sub ? issue(i + 1) : (cp_async_commit(), 0u);
    cp_async_wait<1>();
    __syncwarp();
    if (live_cur != 0u) {
      const int t0 = first + i * kKeyTile;
      const uint8_t* slot = ring + (i & 1) * 2 * kSub * kRowBytes;
      const __nv_bfloat16* Ks;
      const __nv_bfloat16* Vs;
      float ksv = 1.f, vsv = 1.f;  // int8: lane's key (lane % 16) scales
      if constexpr (kQuant) {
        const int t = t0 + (lane & (kSub - 1));
        if ((live_cur >> (lane & (kSub - 1))) & 1u) {
          ksv = ksc[(long long)t * a.ks_st];
          vsv = vsc[(long long)t * a.vs_st];
        }
        // int8 codes -> bf16 (exact), K and V rows into the conversion slot
#pragma unroll
        for (int p = lane; p < 2 * kSub * kPieces; p += 32) {
          const int r = p / kPieces, c = p % kPieces;
          const uint4 raw = *reinterpret_cast<const uint4*>(slot + r * kLdQ + c * 16);
          const int8_t* cb = reinterpret_cast<const int8_t*>(&raw);
          uint32_t h[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) h[j] = pack_bf16x2((float)cb[2 * j], (float)cb[2 * j + 1]);
          uint4* dst = reinterpret_cast<uint4*>(conv + r * kLd + c * 16);
          dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
          dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
        }
        __syncwarp();
        Ks = conv;
        Vs = conv + kSub * kLd;
      } else {
        Ks = reinterpret_cast<const __nv_bfloat16*>(slot);
        Vs = Ks + kSub * kLd;
      }

      // S = Q K^T for the 16 keys: two n8 tiles (keys 0-7, 8-15)
      float sacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(Ks + k_row * kLd + 16 * s + k_col));
        mma_bf16_16816(sacc[0], qa[s], kb);
        mma_bf16_16816(sacc[1], qa[s], kb + 2);
      }

      // scores of this thread's keys 8 j + 2 t4 + e; invisible keys -1e30
      float x[2][4], kss[2][2], vss[2][2];
      bool vis[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t4 + e;
          vis[j][e] = (live_cur >> key) & 1u;
          kss[j][e] = kQuant ? __shfl_sync(0xffffffffu, ksv, key) : 1.f;
          vss[j][e] = kQuant ? __shfl_sync(0xffffffffu, vsv, key) : 1.f;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float s = sacc[j][r] * a.scale;
          if constexpr (kQuant) s *= kss[j][r & 1];
          x[j][r] = vis[j][r & 1] ? s : kNegInf;
        }
      // online softmax of rows g (r = 0, 1) and g + 8 (r = 2, 3) over the quad
      float mx0 = fmaxf(fmaxf(x[0][0], x[0][1]), fmaxf(x[1][0], x[1][1]));
      float mx1 = fmaxf(fmaxf(x[0][2], x[0][3]), fmaxf(x[1][2], x[1][3]));
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[j][r] = vis[j][r & 1] ? expf(x[j][r] - (r < 2 ? mn0 : mn1)) : 0.f;
      l0 = l0 * corr0 + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
      l1 = l1 * corr1 + ((p[0][2] + p[0][3]) + (p[1][2] + p[1][3]));
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= corr0;
        acc[n][1] *= corr0;
        acc[n][2] *= corr1;
        acc[n][3] *= corr1;
      }
      // the P V operand: p (times v_scale for an int8 cache) rounded to bf16,
      // the S accumulators of keys 0-7 and 8-15 as the A fragment
      uint32_t pa[4];
      pa[0] = pack_bf16x2(p[0][0] * vss[0][0], p[0][1] * vss[0][1]);
      pa[1] = pack_bf16x2(p[0][2] * vss[0][0], p[0][3] * vss[0][1]);
      pa[2] = pack_bf16x2(p[1][0] * vss[1][0], p[1][1] * vss[1][1]);
      pa[3] = pack_bf16x2(p[1][2] * vss[1][0], p[1][3] * vss[1][1]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(Vs + v_row * kLd + 16 * n + v_col));
        mma_bf16_16816(acc[2 * n], pa, vb);
        mma_bf16_16816(acc[2 * n + 1], pa, vb + 2);
      }
    }
    __syncwarp();  // the slot is read before issue(i + 2) refills it
    live_cur = live_next;
  }
  cp_async_wait<0>();

  // the warps' states into shared memory (over the rings), then the tail
  __syncthreads();
  float* Acc = reinterpret_cast<float*>(rings);  // [W][G][D]
  float* Ms = Acc + kMmaWarps * G * D;           // [W][G]
  float* Ls = Ms + kMmaWarps * G;                // [W][G]
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  // rows g and g + 8 of the product; only the G query rows are kept
  const bool keep0 = g < G, keep1 = g + 8 < G;
  if (t4 == 0) {
    if (keep0) {
      Ms[w * G + g] = m0;
      Ls[w * G + g] = l0;
    }
    if (keep1) {
      Ms[w * G + g + 8] = m1;
      Ls[w * G + g + 8] = l1;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* row0 = Acc + (w * G + g) * D + 8 * n + 2 * t4;
    float* row1 = row0 + 8 * D;
    if (keep0) *reinterpret_cast<float2*>(row0) = make_float2(acc[n][0], acc[n][1]);
    if (keep1) *reinterpret_cast<float2*>(row1) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  decode_finish<__nv_bfloat16, G, D, kMmaWarps, kMmaThreads>(
      a, b, hk, split, Ms, Ls, Acc, Ss, Vn, reinterpret_cast<int*>(Ls + kMmaWarps * G));
}

// ---------------------------------------------------------------------------
// fp32 queries: CUDA cores, fp32 or int8 cache
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;

template <int G>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  constexpr int D = kDecD;
  return sizeof(float) * (G * D + kF32Warps * G * 32 + kF32Warps * G * D + 2 * kF32Warps * G +
                          self_floats(G, D) + 1);
}

template <typename C, int G>
__global__ void __launch_bounds__(kF32Threads) decode_attention_f32_kernel(const DecodeArgs a) {
  constexpr int D = kDecD;
  static_assert(kF32Warps * G % 2 == 0, "Ss (after 2 W G floats of Ms and Ls) on a float4");
  constexpr int DC = D / 32;  // output columns per lane, contiguous
  constexpr bool kQuant = sizeof(C) == 1;
  constexpr int KV = kQuant ? 16 : 4;  // key elements a load (16 bytes)
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [G][D] query
  float* Ps = Qs + G * D;                // [warps][G][32] probabilities of a tile
  float* Acc = Ps + kF32Warps * G * 32;  // [warps][G][D] per-warp numerators
  float* Ms = Acc + kF32Warps * G * D;   // [warps][G] per-warp running max
  float* Ls = Ms + kF32Warps * G;        // [warps][G] per-warp denominators
  float* Ss = Ls + kF32Warps * G;        // [G] self scores
  float* Vn = Ss + round4(G);            // [D] v_new

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + hk * a.q_sh;
  const C* k = static_cast<const C*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const C* v = static_cast<const C*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  const float* ksc = kQuant ? a.k_scale + b * a.ks_sb + hk * a.ks_sh : nullptr;
  const float* vsc = kQuant ? a.v_scale + b * a.vs_sb + hk * a.vs_sh : nullptr;

  for (int e = tid; e < G * D; e += kF32Threads) Qs[e] = q[(e / D) * a.q_sg + e % D];
  load_self<float, G, D, kF32Threads>(a, b, hk, Ss, Vn);
  __syncthreads();

  float m[G], l[G], acc[G][DC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[g][c] = 0.f;
  }
  float* pw = Ps + w * G * 32;

  // this block's keys [c0, c1), 32 a warp step, one a lane
  const KeyRange kr = key_range(a);
  const int c0 = kr.lo + split * a.chunk;
  const int c1 = min(c0 + a.chunk, kr.end);
  for (int t0 = c0 + w * 32; t0 < c1; t0 += kF32Warps * 32) {
    const int t = t0 + lane;
    const bool valid = t >= kr.begin && t < c1 && mask[t] != 0;
    const unsigned live = __ballot_sync(0xffffffffu, valid);
    if (live == 0u) continue;  // the whole tile is masked

    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const C* kr = k + (long long)t * a.k_st;
#pragma unroll 2
      for (int d = 0; d < D; d += KV) {
        float kf[KV];
        load_vec<KV>(kr + d, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float x = s[g];
#pragma unroll
          for (int u = 0; u < KV; u += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(Qs + g * D + d + u);
            x = fmaf(qa.x, kf[u + 0], x);
            x = fmaf(qa.y, kf[u + 1], x);
            x = fmaf(qa.z, kf[u + 2], x);
            x = fmaf(qa.w, kf[u + 3], x);
          }
          s[g] = x;
        }
      }
    }
    float k_s = 1.f, v_s = 1.f;  // this lane's key's scales (int8 cache)
    if constexpr (kQuant) {
      if (valid) {
        k_s = ksc[(long long)t * a.ks_st];
        v_s = vsc[(long long)t * a.vs_st];
      }
    }

    // online softmax per head across the warp's 32 keys
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = kNegInf;
      if (valid) x = kQuant ? s[g] * a.scale * k_s : s[g] * a.scale;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float corr = expf(m[g] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[g][c] *= corr;
      pw[g * 32 + lane] = p * v_s;  // fp32 queries: the P V operand is not rounded
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
  decode_finish<float, G, D, kF32Warps, kF32Threads>(a, b, hk, split, Ms, Ls, Acc, Ss, Vn,
                                                     reinterpret_cast<int*>(Vn + D));
}

// launches one kernel (Kernel: an instantiation, so each opts in to its
// shared memory once) on the (splits, Hkv, B) grid
template <auto Kernel>
int launch(int threads, size_t smem, const DecodeArgs& a, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  Kernel<<<dim3(a.splits, a.Hkv, a.B), threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// one instantiation: bf16 queries (T = __nv_bfloat16) on the tensor cores,
// fp32 queries on the CUDA cores; C is the cache's element type (T's, or
// int8 codes), G the query heads a KV head
template <typename T, typename C, int G>
int launch_decode(const DecodeArgs& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    return launch<decode_attention_bf16_kernel<C, G>>(kMmaThreads, mma_smem_bytes<C, G>(), a, st);
  } else {
    return launch<decode_attention_f32_kernel<C, G>>(kF32Threads, f32_smem_bytes<G>(), a, st);
  }
}

// the groups instantiated (ops/flash_attention.py::DECODE_GROUPS)
template <typename T, typename C>
int launch_group(int G, const DecodeArgs& a, cudaStream_t st) {
  switch (G) {
    case 2: return launch_decode<T, C, 2>(a, st);
    case 4: return launch_decode<T, C, 4>(a, st);
    case 5: return launch_decode<T, C, 5>(a, st);
    case 8: return launch_decode<T, C, 8>(a, st);
    case 9: return launch_decode<T, C, 9>(a, st);
    case 16: return launch_decode<T, C, 16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype, group size, head size or split the
// kernels do not take (G = 2, 4, 5, 8, 9 or 16, D = 128; chunk a multiple of 128,
// splits >= 1, covering [t_lo, t_end)). k_new and
// v_new are both null or both set. cache_dtype is dtype, or int8 with
// k_scale and v_scale set (they are ignored otherwise). ws holds B * Hkv *
// splits * partial_floats(G, D) floats; tickets B * Hkv ints, zero on
// entry, left zero on exit. bf16 q, k and v need 16-byte aligned rows.
// bounds: null, or an int32 [t_begin, t_end] on the device that the kernel
// reads (t_begin and t_lo are then unused, t_end is their cap and t_lo 0).
extern "C" int sv_decode_attention(
    int dtype, int cache_dtype, int G, int D, const void* q, const void* k, const void* v,
    const void* k_new, const void* v_new, const int* mask, const int* bounds,
    const float* k_scale,
    const float* v_scale, void* out, float* ws, int* tickets, int B, int Hkv,
    long long q_sb, long long q_sh, long long q_sg,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long kn_sb, long long kn_sh, long long vn_sb, long long vn_sh,
    long long ks_sb, long long ks_st, long long ks_sh,
    long long vs_sb, long long vs_st, long long vs_sh,
    long long m_sb, int t_begin, int t_end, int t_lo, int chunk, int splits, float scale,
    void* stream) {
  const sv::DecodeArgs a{q, k, v, k_new, v_new, mask, bounds, k_scale, v_scale, out, ws, tickets,
                         B, Hkv,
                         q_sb, q_sh, q_sg, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                         kn_sb, kn_sh, vn_sb, vn_sh, ks_sb, ks_st, ks_sh, vs_sb, vs_st, vs_sh,
                         m_sb, t_begin, t_end, t_lo, chunk, splits, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != sv::kDecD || ws == nullptr || tickets == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits < 1 || chunk < sv::kKeyTile || chunk % sv::kKeyTile != 0 || t_lo % sv::kKeyTile != 0 ||
      (long long)t_lo + (long long)splits * chunk < t_end || (bounds != nullptr && t_lo != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool quant = cache_dtype == sv::kInt8;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return (int)cudaErrorInvalidValue;
  if (!quant && cache_dtype != dtype) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (dtype == sv::kBFloat16) {
    return quant ? sv::launch_group<bf16, int8_t>(G, a, st) : sv::launch_group<bf16, bf16>(G, a, st);
  }
  if (dtype == sv::kFloat32) {
    return quant ? sv::launch_group<float, int8_t>(G, a, st)
                 : sv::launch_group<float, float>(G, a, st);
  }
  return (int)cudaErrorInvalidValue;
}
