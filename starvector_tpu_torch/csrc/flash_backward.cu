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
// / _flash_dkv(_tri)_kernel. On Hopper one pair of kernels serves every
// length; dK/dV and dQ are separate kernels because Hopper blocks run in no
// order, so each kernel owns its output tile and loops inside the block up
// to the causal bound.
//
// bf16 (the train step's type): tensor cores, wgmma.m64n64k16 with fp32
// sums (wgmma.cuh). One warpgroup (128 threads) a block.
//
//   flash_bwd_dkdv: a block owns 64 keys of one (batch, KV head) and G /
//     head_split of its query heads. K and V stay in shared memory; the
//     block walks (head, 64-row query tile) steps from the causal bound to S
//     (cut by the window), the next step's Q, dO, lse and delta copied by
//     cp.async into the other half of a two-stage ring while the current one
//     is computed. Key-major, as the JAX fused kernel: S^T = K Q^T and
//     dP^T = V dO^T (both operands from shared memory, K-major), then
//     P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta) * scale
//     under the key, causal and window masks, in the accumulators' own
//     registers; P^T and dS^T are rounded to bf16 and feed dV += P^T dO and
//     dK += dS^T Q straight from registers (B = dO, Q read MN-major from the
//     same tiles). dK, dV stay in fp32 registers (2 x 64 a thread).
//     With head_split = 1 the block rounds them once into dk, dv; otherwise
//     it writes its fp32 partial sums into a workspace (2, head_split, B, T,
//     Hkv, D), and flash_bwd_dkdv_finish_kernel adds the splits in a fixed
//     order and rounds once: no atomics, the same bits every run. The grid
//     is one dimension with the key tile slowest, so under the causal mask
//     the tiles that see the most query tiles start in the first wave.
//   flash_bwd_dq: a block owns 64 query rows of one (batch, query head). Q
//     and dO stay in shared memory; the block walks the key tiles up to the
//     causal bound (from the window edge), the next K, V and key mask in
//     flight in the other stage. Query-major: S = Q K^T, dP = dO V^T, then
//     dS as above, rounded to bf16 in registers, and dQ += dS K (K read
//     MN-major). Last query tiles (the most key tiles) first. A block takes
//     one head: at the 1B step that is 13 x 16 x 4 = 832 blocks, several
//     waves on 132 SMs, and the heads of one KV head read the same K/V
//     tiles through L2, so folding several heads into a block would buy
//     shared-memory reuse at the cost of balance; not done.
//
// Rounding: P is rounded to dO's type before the dV product and dS to q's
// type before the dK and dQ products, exactly where the JAX kernels round
// (flash_attention.py:1012, :1020) and the port's plain version does; the
// sums stay fp32 and each output is rounded once.
//
// fp32 (the fp32 checks and steps): the tensor cores have no fp32 route that
// meets the 1e-4 tolerance (TF32 keeps about 3 digits), so fp32 keeps the
// CUDA-core kernels: the same grid of work and the same head_split, products
// as fp32 fmaf loops over tiles staged as fp32 in shared memory.
//
// What bounds it on the H100: the tensor-core products, 8 D flops per
// visible (query, key) pair for dkdv and 6 D for dq (19.4 and 14.5 GFLOP at
// the 1B step; a bound of 0.020 and 0.015 ms at 989 TFLOP/s). This version
// issues the products of a step back to back and waits for them: the
// exponentials and masks of a step do not overlap its products, and one
// warpgroup a block (two blocks an SM) keeps the tensor cores from their
// peak. Warp-specialised producer/consumer warpgroups (TMA, setmaxnreg) are
// later work; the bf16 pair's times are in PERF.md.
//
// Layout contract: q (B,S,H,D), k and v (B,T,Hkv,D) and dO (B,S,H,D) are read
// through their strides (last dim contiguous; bf16 rows 16-byte aligned);
// lse and delta are contiguous (B,H,S) fp32; kv_mask is (B,T) int32 with
// unit stride along T; dq is a contiguous (B,S,H,D) tensor of q's type, dk
// and dv contiguous (B,T,Hkv,D) of k's type. A query row that sees no key
// contributes nothing and gets dq = 0; a key that no query sees gets
// dk = dv = 0.

#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace sv {
namespace {

constexpr int kTile = 64;  // query rows and keys per tile

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
  float* ws;   // (2, head_split, B, T, Hkv, D) fp32 partial dk, dv; head_split > 1 only
  int B, S, T, H, Hkv, G, head_split;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  long long m_sb;
  int q_offset, causal, window;
  float scale;
};

// Query tiles [i_lo, i_hi) that can see a key of the tile at t0: from the
// causal bound of its first key, up to the window edge of its last key.
__device__ __forceinline__ void query_tiles(const BwdArgs& a, int t0, int& i_lo, int& i_hi) {
  const int t_last = min(t0 + kTile, a.T) - 1;
  const int r_lo = a.causal ? max(0, t0 - a.q_offset) : 0;
  int r_hi = a.S;
  if (a.window > 0) r_hi = min(r_hi, t_last + a.window - a.q_offset);
  i_lo = r_lo / kTile;
  i_hi = r_hi > r_lo ? (r_hi + kTile - 1) / kTile : i_lo;
}

// Offset of the fp32 partial of (split, b, t, hk, d = 0) in the workspace
// half of dk (dv's half follows it).
__device__ __forceinline__ long long ws_offset(const BwdArgs& a, int split, int b, int t, int hk,
                                               int D) {
  return ((((long long)split * a.B + b) * a.T + t) * a.Hkv + hk) * D;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;              // one warpgroup
constexpr int kHead = 128;                   // head size of the bf16 kernels
constexpr int kTileBytes = kTile * kHead * 2;  // a 64 x 128 bf16 tile

// flash_bwd_dkdv: K, V, two stages of (Q, dO), lse[2][64], delta[2][64],
// the key mask; plus slack to align the base to 1024 bytes.
constexpr int kDkK = 0, kDkV = kTileBytes, kDkRing = 2 * kTileBytes;
constexpr int kDkStats = 6 * kTileBytes;
constexpr int kDkMask = kDkStats + 4 * kTile * 4;
constexpr int kDkSmem = kDkMask + kTile * 4 + 1024;

// flash_bwd_dq: Q, dO, two stages of (K, V), mask[2][64]; plus slack.
constexpr int kDqQ = 0, kDqO = kTileBytes, kDqRing = 2 * kTileBytes;
constexpr int kDqMask = 6 * kTileBytes;
constexpr int kDqSmem = kDqMask + 2 * kTile * 4 + 1024;

// Copies one (head, query tile) step of flash_bwd_dkdv into ring stage
// `stage`: Q and dO rows [r0, r0 + 64) of head h, and their lse and delta.
__device__ __forceinline__ void dkdv_issue(const BwdArgs& a, uint32_t ring, float* stats, int stage,
                                           int b, int h, int r0) {
  using bf16 = __nv_bfloat16;
  const uint32_t qt = ring + stage * 2 * kTileBytes;
  stage_tile<kTile, kHead, kWgThreads>(
      qt, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, r0, a.S);
  stage_tile<kTile, kHead, kWgThreads>(
      qt + kTileBytes, static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh, a.o_ss, r0, a.S);
  const int tid = threadIdx.x;
  const int r = tid & (kTile - 1);
  const float* src = (tid < kTile ? a.lse : a.delta) + ((long long)b * a.H + h) * a.S;
  const bool in = r0 + r < a.S;
  cp_async_4(smem_u32(stats + (tid < kTile ? 0 : 2 * kTile) + stage * kTile + r),
             src + (in ? r0 + r : 0), in);
}

__global__ void __launch_bounds__(kWgThreads, 2) flash_bwd_dkdv_bf16_kernel(const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  float* stats = reinterpret_cast<float*>(sm + kDkStats);  // lse[2][64], then delta[2][64]
  int* kmask = reinterpret_cast<int*>(sm + kDkMask);

  // block -> (key tile, batch, KV head, head split), key tile slowest
  const int per_tile = a.B * a.Hkv * a.head_split;
  const int t0 = (blockIdx.x / per_tile) * kTile;
  int rest = blockIdx.x % per_tile;
  const int split = rest % a.head_split;
  rest /= a.head_split;
  const int hk = rest % a.Hkv;
  const int b = rest / a.Hkv;
  const int heads = a.G / a.head_split;
  const int h0 = hk * a.G + split * heads;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  int i_lo, i_hi;
  query_tiles(a, t0, i_lo, i_hi);
  const int nq = i_hi - i_lo;
  const int steps = heads * nq;

  if (steps > 0) {
    stage_tile<kTile, kHead, kWgThreads>(
        base + kDkK, static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_st, t0, a.T);
    stage_tile<kTile, kHead, kWgThreads>(
        base + kDkV, static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_st, t0, a.T);
    dkdv_issue(a, base + kDkRing, stats, 0, b, h0, i_lo * kTile);
    cp_async_commit();
  }
  if (tid < kTile) kmask[tid] = t0 + tid < a.T ? a.mask[b * a.m_sb + t0 + tid] : 0;

  float dk[2][32], dv[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  // this thread's accumulator rows are keys 16w + g and 16w + g + 8
  const int kr0 = 16 * w + g;
  for (int n = 0; n < steps; ++n) {
    const int stage = n & 1;
    cp_async_wait<0>();
    __syncthreads();  // step n landed for every thread; stage ^ 1 (step n - 1) is free
    if (n + 1 < steps) {
      dkdv_issue(a, base + kDkRing, stats, stage ^ 1, b, h0 + (n + 1) / nq,
                 (i_lo + (n + 1) % nq) * kTile);
      cp_async_commit();
    }
    const int r0 = (i_lo + n % nq) * kTile;
    const uint32_t qt = base + kDkRing + stage * 2 * kTileBytes, ot = qt + kTileBytes;

    // S^T = K Q^T, dP^T = V dO^T: keys x queries, contraction over D
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHead / 16; ++k)
      wgmma_ss(s, desc_k_major(base + kDkK, kTile, k), desc_k_major(qt, kTile, k), k > 0);
#pragma unroll
    for (int k = 0; k < kHead / 16; ++k)
      wgmma_ss(dp, desc_k_major(base + kDkV, kTile, k), desc_k_major(ot, kTile, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place; column 8j + 2t4 + e is query row r0 + that
    const float* lse = stats + stage * kTile;
    const float* delta = stats + 2 * kTile + stage * kTile;
    bool key_in[2];
    int key[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      key[hh] = t0 + kr0 + 8 * hh;
      key_in[hh] = key[hh] < a.T && kmask[kr0 + 8 * hh] != 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * j + 2 * t4 + e;
        const int qpos = a.q_offset + r0 + qc;
        const bool row_in = r0 + qc < a.S;
        const float l = lse[qc], d = delta[qc];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const bool vis = row_in && key_in[hh] && visible(key[hh], qpos, a.causal, a.window);
          const float p = vis ? expf(s[i] * a.scale - l) : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - d) * a.scale;
        }
      }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc_to_a(s, k, pa[k]);
      acc_to_a(dp, k, da[k]);
    }

    // dV += P^T dO, dK += dS^T Q: contraction over the 64 query rows
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(dv[c], pa[k], desc_mn_major(ot, kTile, c, k), 1);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(dk[c], da[k], desc_mn_major(qt, kTile, c, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fence_regs(dk[c]);
      fence_regs(dv[c]);
    }
  }

  // rows kr0 (+ 8), columns 64c + 8j + 2t4 (+ 1)
  const long long half = (long long)a.head_split * a.B * a.T * a.Hkv * kHead;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = t0 + kr0 + 8 * hh;
    if (t >= a.T) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t4, i = 4 * j + 2 * hh;
        if (a.head_split == 1) {
          const long long o = (((long long)b * a.T + t) * a.Hkv + hk) * kHead + col;
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out0) + o) =
              __floats2bfloat162_rn(dk[c][i], dk[c][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out1) + o) =
              __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
        } else {
          const long long o = ws_offset(a, split, b, t, hk, kHead) + col;
          *reinterpret_cast<float2*>(a.ws + o) = make_float2(dk[c][i], dk[c][i + 1]);
          *reinterpret_cast<float2*>(a.ws + half + o) = make_float2(dv[c][i], dv[c][i + 1]);
        }
      }
  }
}

// Copies key tile [t0, t0 + 64) of flash_bwd_dq into ring stage `stage`:
// K, V and the key mask (zeros past T).
__device__ __forceinline__ void dq_issue(const BwdArgs& a, uint32_t ring, int* kmask, int stage,
                                         int b, int hk, int t0) {
  using bf16 = __nv_bfloat16;
  const uint32_t kt = ring + stage * 2 * kTileBytes;
  stage_tile<kTile, kHead, kWgThreads>(
      kt, static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_st, t0, a.T);
  stage_tile<kTile, kHead, kWgThreads>(
      kt + kTileBytes, static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_st, t0, a.T);
  const int tid = threadIdx.x;
  if (tid < kTile) {
    const bool in = t0 + tid < a.T;
    cp_async_4(smem_u32(kmask + stage * kTile + tid), a.mask + b * a.m_sb + (in ? t0 + tid : 0),
               in);
  }
}

__global__ void __launch_bounds__(kWgThreads, 2) flash_bwd_dq_bf16_kernel(const BwdArgs a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  const uint32_t base = smem_u32(sm);
  int* kmask = reinterpret_cast<int*>(sm + kDqMask);  // [2][64]

  // block -> (query tile, batch, head), the last query tiles first
  const int n_tiles = (a.S + kTile - 1) / kTile;
  const int r0 = (n_tiles - 1 - (int)(blockIdx.x / (a.B * a.H))) * kTile;
  const int h = blockIdx.x % a.H;
  const int b = (blockIdx.x / a.H) % a.B;
  const int hk = h / a.G;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  int t_begin, t_end;
  key_range<kTile>(a, r0, t_begin, t_end);
  const int steps = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile : 0;

  // this thread's accumulator rows are query rows r0 + 16w + g (+ 8)
  const int qr0 = 16 * w + g;
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + qr0 + 8 * hh;
    const long long o = ((long long)b * a.H + h) * a.S + row;
    lse[hh] = row < a.S ? a.lse[o] : 0.f;
    delta[hh] = row < a.S ? a.delta[o] : 0.f;
  }
  if (steps > 0) {
    stage_tile<kTile, kHead, kWgThreads>(
        base + kDqQ, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss, r0, a.S);
    stage_tile<kTile, kHead, kWgThreads>(
        base + kDqO, static_cast<const bf16*>(a.dout) + b * a.o_sb + h * a.o_sh, a.o_ss, r0, a.S);
    dq_issue(a, base + kDqRing, kmask, 0, b, hk, t_begin);
    cp_async_commit();
  }

  float dq[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  for (int n = 0; n < steps; ++n) {
    const int stage = n & 1;
    const int t0 = t_begin + n * kTile;
    cp_async_wait<0>();
    __syncthreads();  // tile n landed for every thread; stage ^ 1 (tile n - 1) is free
    if (n + 1 < steps) {
      dq_issue(a, base + kDqRing, kmask, stage ^ 1, b, hk, t0 + kTile);
      cp_async_commit();
    }
    const uint32_t kt = base + kDqRing + stage * 2 * kTileBytes, vt = kt + kTileBytes;

    // S = Q K^T, dP = dO V^T: queries x keys, contraction over D
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kHead / 16; ++k)
      wgmma_ss(s, desc_k_major(base + kDqQ, kTile, k), desc_k_major(kt, kTile, k), k > 0);
#pragma unroll
    for (int k = 0; k < kHead / 16; ++k)
      wgmma_ss(dp, desc_k_major(base + kDqO, kTile, k), desc_k_major(vt, kTile, k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place; column 8j + 2t4 + e is key t0 + that
    const int* km = kmask + stage * kTile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = 8 * j + 2 * t4 + e;
        const bool key_in = km[kc] != 0;  // zero past T
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * j + 2 * hh + e;
          const int row = r0 + qr0 + 8 * hh;
          const bool vis = key_in && row < a.S &&
                           visible(t0 + kc, a.q_offset + row, a.causal, a.window);
          const float p = vis ? expf(s[i] * a.scale - lse[hh]) : 0.f;
          dp[i] = p * (dp[i] - delta[hh]) * a.scale;
        }
      }
    uint32_t da[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_to_a(dp, k, da[k]);

    // dQ += dS K: contraction over the 64 keys
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(dq[c], da[k], desc_mn_major(kt, kTile, c, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq[0]);
    fence_regs(dq[1]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + qr0 + 8 * hh;
    if (row >= a.S) continue;
    bf16* o = static_cast<bf16*>(a.out0) + (((long long)b * a.S + row) * a.H + h) * kHead;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(o + 64 * c + 8 * j + 2 * t4) =
            __floats2bfloat162_rn(dq[c][i], dq[c][i + 1]);
      }
  }
}

// dk, dv = the sum of the head splits' fp32 partials, in split order,
// rounded once; 4 elements a thread (n, the elements of dk, is a multiple
// of 4).
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_dkdv_finish_kernel(const float* __restrict__ ws,
                                                                    int splits, long long n,
                                                                    T* __restrict__ dk,
                                                                    T* __restrict__ dv) {
  const long long e = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= 2 * n) return;
  const int which = e >= n;  // 0: dk, 1: dv
  const long long o = e - which * n;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + ((long long)which * splits + s) * n + o);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  T* out = (which ? dv : dk) + o;
  out[0] = from_f<T>(acc.x);
  out[1] = from_f<T>(acc.y);
  out[2] = from_f<T>(acc.z);
  out[3] = from_f<T>(acc.w);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Threads = kF32Warps * 32;
constexpr int kWarpRows = kTile / kF32Warps;  // 8 rows (or keys) per warp

// Stages rows [r0, r0 + kTile) of a (.., rows, .., D) fp32 operand into
// dst[kTile][stride], zeros past `n` rows.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src,
                                           long long row_stride, int r0, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kF32Threads) {
    const int r = e / D, d = e % D;
    dst[r * stride + d] = (r0 + r < n) ? src[(long long)(r0 + r) * row_stride + d] : 0.f;
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
constexpr size_t dkdv_f32_smem_bytes() {
  // K, V tiles (padded rows), Q, dO tiles, P and dS (query-major), lse, delta, key mask
  return sizeof(float) * (2 * kTile * (D + 1) + 2 * kTile * D + 2 * kTile * kTile + 2 * kTile) +
         sizeof(int) * kTile;
}

// One block per (64-key tile, KV head x head split, batch): the fp32 fmaf
// version of flash_bwd_dkdv_bf16_kernel's loop.
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_bwd_dkdv_f32_kernel(const BwdArgs a) {
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
  const int hk = blockIdx.y / a.head_split;
  const int split = blockIdx.y % a.head_split;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  for (int e = tid; e < kTile * D; e += kF32Threads) {
    const int r = e / D, d = e % D;
    const bool in = t0 + r < a.T;
    Ks[r * KS + d] = in ? k[(long long)(t0 + r) * a.k_st + d] : 0.f;
    Vs[r * KS + d] = in ? v[(long long)(t0 + r) * a.v_st + d] : 0.f;
  }
  for (int r = tid; r < kTile; r += kF32Threads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;

  int i_lo, i_hi;
  query_tiles(a, t0, i_lo, i_hi);

  float dk_acc[kWarpRows][DC], dv_acc[kWarpRows][DC];
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[j][c] = dv_acc[j][c] = 0.f;

  const int heads = a.G / a.head_split;
  const int ta = t0 + lane, tb = t0 + lane + 32;
  for (int g = split * heads; g < (split + 1) * heads; ++g) {
    const int h = hk * a.G + g;
    const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* dout = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;
    const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
    const float* delta = a.delta + ((long long)b * a.H + h) * a.S;
    for (int i = i_lo; i < i_hi; ++i) {
      const int r0 = i * kTile;
      __syncthreads();  // K/V are staged / the previous q tile is consumed
      stage_rows<D>(Qs, D, q, a.q_ss, r0, a.S);
      stage_rows<D>(Os, D, dout, a.o_ss, r0, a.S);
      for (int r = tid; r < kTile; r += kF32Threads) {
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

  const long long half = (long long)a.head_split * a.B * a.T * a.Hkv * D;
#pragma unroll
  for (int j = 0; j < kWarpRows; ++j) {
    const int t = t0 + w * kWarpRows + j;
    if (t >= a.T) continue;
    const long long o = a.head_split == 1 ? (((long long)b * a.T + t) * a.Hkv + hk) * D
                                          : ws_offset(a, split, b, t, hk, D);
    float* dk = (a.head_split == 1 ? static_cast<float*>(a.out0) : a.ws) + o;
    float* dv = (a.head_split == 1 ? static_cast<float*>(a.out1) : a.ws + half) + o;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[lane + 32 * c] = dk_acc[j][c];
      dv[lane + 32 * c] = dv_acc[j][c];
    }
  }
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // Q, dO tiles, K, V tiles (padded rows), dS per warp, lse, delta, key mask
  return sizeof(float) * (2 * kTile * D + 2 * kTile * (D + 1) + kTile * kTile + 2 * kTile) +
         sizeof(int) * kTile;
}

// One block per (64-row query tile, head, batch).
template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) flash_bwd_dq_f32_kernel(const BwdArgs a) {
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

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* dout = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* mask = a.mask + b * a.m_sb;
  const float* lse = a.lse + ((long long)b * a.H + h) * a.S;
  const float* delta = a.delta + ((long long)b * a.H + h) * a.S;
  stage_rows<D>(Qs, D, q, a.q_ss, r0, a.S);
  stage_rows<D>(Os, D, dout, a.o_ss, r0, a.S);
  for (int r = tid; r < kTile; r += kF32Threads) {
    lse_s[r] = r0 + r < a.S ? lse[r0 + r] : 0.f;
    delta_s[r] = r0 + r < a.S ? delta[r0 + r] : 0.f;
  }

  int t_begin, t_end;
  key_range<kTile>(a, r0, t_begin, t_end);

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
    for (int e = tid; e < kTile * D; e += kF32Threads) {
      const int r = e / D, d = e % D;
      const bool in = t0 + r < a.T;
      Ks[r * KS + d] = in ? k[(long long)(t0 + r) * a.k_st + d] : 0.f;
      Vs[r * KS + d] = in ? v[(long long)(t0 + r) * a.v_st + d] : 0.f;
    }
    for (int r = tid; r < kTile; r += kF32Threads) Ms[r] = (t0 + r < a.T) ? mask[t0 + r] : 0;
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

  float* dq = static_cast<float*>(a.out0);
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = r0 + w * kWarpRows + r;
    if (row >= a.S) continue;
    float* o = dq + (((long long)b * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[lane + 32 * c] = acc[r][c];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The one head size instantiated, as in flash_prefill.cu: StarVector-1B's 128.
constexpr int kBwdD = 128;
static_assert(kBwdD == kHead, "the bf16 kernels are written for D = 128");

template <typename T>
int launch_finish(const BwdArgs& a, cudaStream_t stream) {
  if (a.head_split == 1) return (int)cudaSuccess;
  const long long n = (long long)a.B * a.T * a.Hkv * kBwdD;
  const long long blocks = (2 * n / 4 + 255) / 256;
  flash_bwd_dkdv_finish_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      a.ws, a.head_split, n, static_cast<T*>(a.out0), static_cast<T*>(a.out1));
  return (int)cudaGetLastError();
}

int launch_dkdv_f32(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_f32_smem_bytes<kBwdD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<kBwdD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.T + kTile - 1) / kTile, a.Hkv * a.head_split, a.B);
  flash_bwd_dkdv_f32_kernel<kBwdD><<<grid, kF32Threads, smem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_finish<float>(a, stream);
}

int launch_dkdv_bf16(const BwdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((a.T + kTile - 1) / kTile) * a.B * a.Hkv * a.head_split;
  flash_bwd_dkdv_bf16_kernel<<<(unsigned)blocks, kWgThreads, kDkSmem, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? (int)err : launch_finish<__nv_bfloat16>(a, stream);
}

int launch_dq_f32(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = dq_f32_smem_bytes<kBwdD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<kBwdD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
  flash_bwd_dq_f32_kernel<kBwdD><<<grid, kF32Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_dq_bf16(const BwdArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((a.S + kTile - 1) / kTile) * a.B * a.H;
  flash_bwd_dq_bf16_kernel<<<(unsigned)blocks, kWgThreads, kDqSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, const int* mask, void* out0, void* out1,
                  float* ws, int head_split, int B, int S, int T, int H, int Hkv,
                  const long long* st, long long m_sb, int q_offset, int causal, int window,
                  float scale) {
  return BwdArgs{q, k, v, dout, lse, delta, mask, out0, out1, ws, B, S, T, H, Hkv, H / Hkv,
                 head_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                 st[9], st[10], st[11], m_sb, q_offset, causal, window, scale};
}

}  // namespace
}  // namespace sv

// Both entry points return cudaGetLastError() after the launches (0 =
// launched), or cudaErrorInvalidValue for a dtype / head size / split the
// kernels do not take (they take D = 128). The kernel is chosen by dtype:
// bf16 runs the tensor-core kernels, fp32 the CUDA-core ones. `strides`
// holds 12 values: q's (b, s, h), k's (b, t, h), v's (b, t, h) and dO's
// (b, s, h). flash_bwd_dkdv splits each KV head's G query heads across
// head_split blocks (it must divide G); for head_split > 1, ws holds
// 2 * head_split * B * T * Hkv * D fp32 partial sums.
extern "C" int sv_flash_bwd_dkdv(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* mask, void* dk, void* dv, void* ws,
    int head_split, int B, int S, int T, int H, int Hkv, const long long* strides, long long m_sb,
    int q_offset, int causal, int window, float scale, void* stream) {
  if (D != sv::kBwdD || Hkv < 1 || H % Hkv != 0 || head_split < 1 || (H / Hkv) % head_split != 0 ||
      (head_split > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const sv::BwdArgs a = sv::make_args(q, k, v, dout, lse, delta, mask, dk, dv,
                                      static_cast<float*>(ws), head_split, B, S, T, H, Hkv,
                                      strides, m_sb, q_offset, causal, window, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sv::kFloat32) return sv::launch_dkdv_f32(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_dkdv_bf16(a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int sv_flash_bwd_dq(
    int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* mask, void* dq,
    int B, int S, int T, int H, int Hkv, const long long* strides, long long m_sb,
    int q_offset, int causal, int window, float scale, void* stream) {
  if (D != sv::kBwdD || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const sv::BwdArgs a = sv::make_args(q, k, v, dout, lse, delta, mask, dq, nullptr, nullptr, 1,
                                      B, S, T, H, Hkv, strides, m_sb, q_offset, causal, window,
                                      scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sv::kFloat32) return sv::launch_dq_f32(a, st);
  if (dtype == sv::kBFloat16) return sv::launch_dq_bf16(a, st);
  return (int)cudaErrorInvalidValue;
}
