// Causal flash-attention forward for Hopper (sm_90a), optionally with the
// per-row logsumexp that the training backward needs.
//
// Replaces the Pallas TPU kernels of starvector_tpu/ops/flash_attention.py
// (FA below):
//   * flash_prefill -> _flash_kernel (FA:133, call :254) with its cell
//     _flash_fwd_cell (FA:90): the inference prefill;
//   * flash_prefill_with_lse -> _flash_lse_kernel (FA:307, call :512,
//     rectangular grid) and _flash_lse_tri_kernel (FA:330, call :455,
//     triangular grid, S == T, q_offset 0): the same math plus
//     lse = m + log(max(l, 1e-30)) per row. The k loop below stops at the
//     causal bound of each query tile, so it visits only the live lower
//     triangle that the TPU's triangular grid enumerates: one kernel serves
//     all three.
// Online-softmax attention of q (B,S,H,D) over k, v (B,T,Hkv,D) with a key
// mask (B,T), an absolute query offset (the cache index of query row 0),
// causal and sliding-window masks, and MQA/GQA grouping (query head h reads
// KV head h / (H/Hkv)).
//
// What bounds it on the H100: at the train shapes, operations: 4 D flops
// per visible (query, key) pair, 9.69 GFLOP at B=4 S=T=769 H=16 and 292
// GFLOP at the 8k triangle (0.0098 and 0.296 ms at 989 TFLOP/s). At the 1B
// prefill (B=4 S=261, 1.12 GFLOP, 9.1 MB of q, out and the visible K/V) the
// bound is bytes (2.7 us), and the work is small enough that launch latency
// and the tail of one wave of blocks set the time.
//
// bf16 (every path the model runs): tensor cores, wgmma.m64n64k16 with fp32
// sums (wgmma.cuh). One warpgroup (128 threads) a block owns 64 query rows of
// one (batch, head); the grid is one dimension with the query tile slowest
// and the last tiles (under the causal mask the ones that see the most keys)
// first, so the heaviest blocks start in the first wave; the heads of one KV
// head are neighbours and read the same K/V tiles through L2. Q is staged
// once; K and V tiles of 64 keys (and the tile's key-mask ints) are copied by
// cp.async into a two-slot ring each, one tile ahead: K of tile n + 2 and V
// of tile n + 1 are in flight while tile n is computed (80 KB of shared
// memory, two blocks an SM). Step n issues tile n's O += P V (P as bf16 A
// fragments in registers, V read MN-major, 2 x 64 output columns) and tile
// n + 1's S = Q K^T (8 k16 products from shared memory, both K-major), waits
// for the scores only, and runs tile n + 1's softmax in their registers
// while the tensor cores compute P V (a thread holds rows 16w + g and
// 16w + g + 8; row max and sum across the quad by two shuffles); then it
// waits for P V, rescales O and rounds the new P. No register that an
// unfinished product uses is written, so ptxas keeps the products
// asynchronous. The scores are scaled in fp32 after the product, as the JAX
// cell does; the positional masks apply only on tiles that cross the causal
// diagonal or the window edge, the key mask only on tiles that hold a masked
// key (or keys past T: their mask is zero-filled), decided by one block
// vote, as the Pallas kernel skips the compare work on its interior cells.
//
// Rounding: the unnormalised P is rounded to bf16 before the P V product,
// exactly where the JAX cell rounds it (p.astype(v.dtype), FA:125-128); l
// sums the fp32 p; O is divided by max(l, 1e-30) once at the end and rounded
// once. Masked scores are -inf before the exponential (exp2 gives exactly
// 0); the running max starts at the finite -1e30 of the Pallas kernels, so
// a row that has seen no key yet never takes exp of (-1e30) - (-1e30).
//
// fp32 (the fp32 checks and steps): the tensor cores have no fp32 route that
// meets the 1e-4 tolerance (TF32 keeps about 3 digits), so fp32 keeps the
// CUDA-core kernel: the same blocks, K/V tiles staged as fp32 in shared
// memory and reused by all 64 query rows, products as fmaf loops.
//
// Layout contract: q, k, v are read through their strides (last dim
// contiguous; bf16 rows 16-byte aligned), in the JAX package's (B, S, H, D)
// / (B, T, Hkv, D) layout; kv_mask is (B, T) int32 with unit stride along T;
// out is a contiguous (B, S, H, D) tensor of q's type; lse, when not null, a
// contiguous (B, H, S) fp32 tensor (the plain layout, not the TPU's 8-lane
// one). The loop over key tiles stops at the causal bound, so the unwritten
// tail of a preallocated cache is never read; the ragged S and T edges are
// masked in the kernel instead of padded. Rows that see no key produce zeros
// and lse = -1e30 + log(1e-30), so that the backward's exp(s - lse) is never
// taken for them (every key is masked). Each output is written once, with no
// atomics: two launches give the same bits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace sv {
namespace {

constexpr int kTile = 64;  // query rows and keys per tile

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;                // one warpgroup
constexpr int kHead = 128;                     // head size of the bf16 kernel
constexpr int kTileBytes = kTile * kHead * 2;  // a 64 x 128 bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

// Q, two K slots, two V slots, the key mask [2][64]; plus slack to align the
// base to 1024 bytes.
constexpr int kQs = 0, kKs = kTileBytes, kVs = 3 * kTileBytes, kMs = 5 * kTileBytes;
constexpr int kSmem = kMs + 2 * kTile * 4 + 1024;

// One block's fixed coordinates.
struct Tile {
  uint32_t base;  // shared address of the aligned layout
  int* kmask;     // [2][64]
  int b, hk, r0, steps, t_begin, first_q, last_q;
};

// K and the key mask of key tile t0 into slot `slot` (zeros past T).
__device__ __forceinline__ void load_k(const PrefillArgs& a, const Tile& tl, int slot, int t0) {
  stage_tile<kTile, kHead, kWgThreads>(
      tl.base + kKs + slot * kTileBytes,
      static_cast<const __nv_bfloat16*>(a.k) + tl.b * a.k_sb + tl.hk * a.k_sh, a.k_st, t0, a.T);
  const int tid = threadIdx.x;
  if (tid < kTile) {
    const bool in = t0 + tid < a.T;
    cp_async_4(smem_u32(tl.kmask + slot * kTile + tid),
               a.mask + tl.b * a.m_sb + (in ? t0 + tid : 0), in);
  }
}

// V of key tile t0 into slot `slot` (zeros past T).
__device__ __forceinline__ void load_v(const PrefillArgs& a, const Tile& tl, int slot, int t0) {
  stage_tile<kTile, kHead, kWgThreads>(
      tl.base + kVs + slot * kTileBytes,
      static_cast<const __nv_bfloat16*>(a.v) + tl.b * a.v_sb + tl.hk * a.v_sh, a.v_st, t0, a.T);
}

// Whether key tile t0 crosses the causal diagonal or the window edge of the
// block's query rows (the positional masks can bite).
__device__ __forceinline__ bool crosses(const PrefillArgs& a, const Tile& tl, int t0) {
  return (a.causal && t0 + kTile - 1 > tl.first_q) || (a.window > 0 && t0 <= tl.last_q - a.window);
}

// A vote of the block (a barrier): every key of the tile in mask slot
// `slot` is unmasked (keys past T have a zero-filled mask). Each of the
// first 64 threads reads the int it copied itself.
__device__ __forceinline__ bool all_keys_in(const Tile& tl, int slot) {
  const int tid = threadIdx.x;
  return __syncthreads_and(tid >= kTile || tl.kmask[slot * kTile + tid] != 0) != 0;
}

// S = Q K^T for the key tile in slot `slot`: queries x keys, contraction
// over D; committed as one group.
__device__ __forceinline__ void issue_scores(float (&s)[32], const Tile& tl, int slot) {
#pragma unroll
  for (int k = 0; k < kHead / 16; ++k)
    wgmma_ss(s, desc_k_major(tl.base + kQs, kTile, k),
             desc_k_major(tl.base + kKs + slot * kTileBytes, kTile, k), k > 0);
  wgmma_commit();
}

// O += P V for the key tile in slot `slot`: contraction over its 64 keys, P
// (bf16 A fragments) from registers, V read MN-major; committed as one
// group.
__device__ __forceinline__ void issue_pv(float (&o)[2][32], const uint32_t (&pa)[4][4],
                                         const Tile& tl, int slot) {
  const uint32_t vt = tl.base + kVs + slot * kTileBytes;
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(o[cb], pa[k], desc_mn_major(vt, kTile, cb, k), 1);
  wgmma_commit();
}

// The online-softmax update of key tile t0 in the scores' registers (a
// thread's accumulator rows are query positions qpos0 and qpos0 + 8):
// masks where `masked`, the new row max m, corr = exp(m_old - m), l = l corr
// + the fp32 sum of p; s becomes the unnormalised p.
__device__ __forceinline__ void softmax_tile(const PrefillArgs& a, float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], const int* km,
                                             int t0, int qpos0, bool masked, int t4) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * t4 + e;
        const bool key_in = km[kc] != 0;  // zero past T
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          if (!(key_in && visible(t0 + kc, qpos0 + 8 * hh, a.causal, a.window))) s[i] = -INFINITY;
        }
      }
  }
  // element i of s is row (i >> 1) & 1 of the thread's two
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh] * a.scale);  // -inf * scale: no key yet
    corr[hh] = exp2f((m[hh] - m_new) * kLog2e);
    m[hh] = m_new;
    ms[hh] = m_new * kLog2e;
  }
  // p = exp(s * scale - m) as exp2 of one fma
  const float c = a.scale * kLog2e;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2f(fmaf(s[i], c, -ms[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    l[hh] = l[hh] * corr[hh] + sum[hh];
  }
}

// O rescaled to the new row max, and P rounded to bf16 as the next P V
// product's A fragments.
__device__ __forceinline__ void rescale_and_round(float (&o)[2][32], const float (&corr)[2],
                                                  const float (&s)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc_to_a(s, k, pa[k]);
}

__global__ void __launch_bounds__(kWgThreads, 2) flash_prefill_bf16_kernel(const PrefillArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);

  // block -> (query tile, batch, head), the last query tiles first
  const int n_tiles = (a.S + kTile - 1) / kTile;
  Tile tl;
  tl.base = smem_u32(sm);
  tl.kmask = reinterpret_cast<int*>(sm + kMs);
  tl.r0 = (n_tiles - 1 - (int)(blockIdx.x / (a.B * a.H))) * kTile;
  const int h = blockIdx.x % a.H;
  tl.b = (blockIdx.x / a.H) % a.B;
  tl.hk = h / a.G;
  int t_end;
  key_range<kTile>(a, tl.r0, tl.t_begin, t_end);
  tl.steps = t_end > tl.t_begin ? (t_end - tl.t_begin + kTile - 1) / kTile : 0;
  tl.first_q = a.q_offset + tl.r0;
  tl.last_q = tl.first_q + min(kTile, a.S - tl.r0) - 1;

  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;
  const int qpos0 = tl.first_q + 16 * (tid >> 5) + (lane >> 2);  // rows 16w + g (+ 8)
  float o[2][32], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[0][i] = o[1][i] = s[i] = 0.f;

  // Tile n's P V product, tile n + 1's scores and softmax, one step: the
  // softmax runs on the CUDA cores while the tensor cores compute P V. The
  // ring: at the top of step n, K (and mask) of tile n + 2 and V of tile
  // n + 1 go into the slots that tiles n and n - 1 left.
  if (tl.steps > 0) {
    stage_tile<kTile, kHead, kWgThreads>(
        tl.base + kQs, static_cast<const bf16*>(a.q) + tl.b * a.q_sb + h * a.q_sh, a.q_ss, tl.r0,
        a.S);
    load_k(a, tl, 0, tl.t_begin);
    cp_async_commit();
    load_v(a, tl, 0, tl.t_begin);
    if (tl.steps > 1) load_k(a, tl, 1, tl.t_begin + kTile);
    cp_async_commit();
    cp_async_wait<1>();  // Q, K and mask of tile 0
    const bool full = all_keys_in(tl, 0);
    wgmma_fence();
    issue_scores(s, tl, 0);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile(a, s, m, l, corr, tl.kmask, tl.t_begin, qpos0,
                 !full || crosses(a, tl, tl.t_begin), t4);
    rescale_and_round(o, corr, s, pa);
  }
  // every step but the last has a next tile; the last is peeled off, so
  // that each product group retires at a wait that ptxas can match to it
  for (int n = 0; n + 1 < tl.steps; ++n) {
    const int slot = n & 1;
    const int t1 = tl.t_begin + (n + 1) * kTile;  // the next tile
    cp_async_wait<0>();  // V of tile n, K and mask of tile n + 1
    // the vote is the barrier after which every thread's copies are visible
    // and every product of step n - 1 is done, so K slot `slot` and V slot
    // slot ^ 1 are free
    const bool full = all_keys_in(tl, slot ^ 1);
    if (n + 2 < tl.steps) load_k(a, tl, slot, t1 + kTile);
    load_v(a, tl, slot ^ 1, t1);
    cp_async_commit();
    wgmma_fence();
    issue_scores(s, tl, slot ^ 1);
    issue_pv(o, pa, tl, slot);
    wgmma_wait<1>();  // the scores; P V still runs
    fence_regs(s);
    softmax_tile(a, s, m, l, corr, tl.kmask + (slot ^ 1) * kTile, t1, qpos0,
                 !full || crosses(a, tl, t1), t4);
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
    fence_regs(s);
    rescale_and_round(o, corr, s, pa);
  }
  if (tl.steps > 0) {  // the last tile's P V
    cp_async_wait<0>();
    __syncthreads();
    wgmma_fence();
    issue_pv(o, pa, tl, (tl.steps - 1) & 1);
    wgmma_wait<0>();
    fence_regs(o[0]);
    fence_regs(o[1]);
  }

  // rows r0 + 16w + g (+ 8), columns 64cb + 8j + 2t4 (+ 1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = tl.r0 + 16 * (tid >> 5) + (lane >> 2) + 8 * hh;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    if (a.lse != nullptr && t4 == 0)
      a.lse[((long long)tl.b * a.H + h) * a.S + row] = m[hh] + logf(denom);
    bf16* out = static_cast<bf16*>(a.out) + (((long long)tl.b * a.S + row) * a.H + h) * kHead;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(out + 64 * cb + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(o[cb][i] / denom, o[cb][i + 1] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;             // each warp owns kTile / kWarps query rows
constexpr int kRows = kTile / kWarps;  // 16
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr size_t prefill_f32_smem_bytes() {
  return sizeof(float) * (kTile * D + kTile * (D + 1) + kTile * D + kWarps * kRows * kTile) +
         sizeof(int) * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_f32_kernel(const PrefillArgs a) {
  constexpr int DC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;          // padded row stride of the K tile
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kTile][D]
  float* Ks = Qs + kTile * D;        // [kTile][KS]
  float* Vs = Ks + kTile * KS;       // [kTile][D]
  float* Ps = Vs + kTile * D;        // [kWarps][kRows][kTile]
  int* Ms = reinterpret_cast<int*>(Ps + kWarps * kRows * kTile);  // [kTile]

  const int i0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[e] = (i0 + r < a.S) ? q[(long long)(i0 + r) * a.q_ss + d] : 0.f;
  }

  int t_begin, t_end;
  key_range<kTile>(a, i0, t_begin, t_end);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  const float* qw = Qs + w * kRows * D;
  float* pw = Ps + w * kRows * kTile;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    __syncthreads();  // Q is staged / the previous tile is consumed
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int t = t0 + r;
      const bool in = t < a.T;
      Ks[r * KS + d] = in ? k[(long long)t * a.k_st + d] : 0.f;
      Vs[r * D + d] = in ? v[(long long)t * a.v_st + d] : 0.f;
    }
    for (int r = tid; r < kTile; r += kThreads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;
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
      const bool va = ma && row < a.S && visible(ta, qpos, a.causal, a.window);
      const bool vb = mb && row < a.S && visible(tb, qpos, a.causal, a.window);
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
      pw[r * kTile + lane] = pa;
      pw[r * kTile + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P V: lane owns output columns lane + 32 c
    for (int j = 0; j < kTile; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kTile + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = i0 + w * kRows + r;
    if (row >= a.S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.H + h) * a.S + row] = m[r] + logf(denom);
    float* o = out + (((long long)b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) o[d] = acc[r][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The one head size instantiated: StarVector-1B's 128. Another is another
// instantiation, added with the model that needs it and a check of it on
// the card.
constexpr int kPrefillD = 128;
static_assert(kPrefillD == kHead, "the bf16 kernel is written for D = 128");

int launch_prefill_f32(const PrefillArgs& a, cudaStream_t stream) {
  constexpr size_t smem = prefill_f32_smem_bytes<kPrefillD>();
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_f32_kernel<kPrefillD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  flash_prefill_f32_kernel<kPrefillD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_prefill_bf16(const PrefillArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((a.S + kTile - 1) / kTile) * a.B * a.H;
  flash_prefill_bf16_kernel<<<(unsigned)blocks, kWgThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype / head size the kernels do not take
// (they take D = 128). The kernel is chosen by dtype: bf16 runs the
// tensor-core kernel, fp32 the CUDA-core one. lse may be null (inference).
extern "C" int sv_flash_prefill(
    int dtype, int D, const void* q, const void* k, const void* v, const int* mask, void* out,
    float* lse, int B, int S, int T, int H, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long m_sb, int q_offset, int causal, int window, float scale, void* stream) {
  if (D != sv::kPrefillD || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const sv::PrefillArgs a{q, k, v, mask, out, lse, B, S, T, H, H / Hkv,
                          q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                          m_sb, q_offset, causal, window, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sv::kFloat32) return sv::launch_prefill_f32(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_prefill_bf16(a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
