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
// Four code paths, chosen from M and x's type (ops/quantization.py):
//
// * M <= 16 (decode rows), bf16 x: qmm_gemv_tc_kernel, the tensor-core
//   GEMV (sv_quant_gemv). What bounds it on the H100 is reading q: K * N
//   bytes over 3.35 TB/s (the 8B's c_fc, 85 MB, 25 us; the 1B's, 16.8 MB,
//   5 us); the x rows, scales and output are a few kB. So the design is
//   about streaming q at the HBM rate, with nothing else in the way:
//   - the products run on the tensor cores, out^T = q^T x^T as the tile
//     computes it: codes staged in shared memory are the A operand,
//     ldmatrix.trans and int8x2_to_bf16x2 make two of them an exact bf16
//     pair in about one instruction, and x's rows (one or two n8 tiles of
//     mma.sync.m16n8k16, zero rows past M) are the B operand, so a code
//     costs the CUDA cores neither a conversion nor M multiply-adds;
//   - every code is read once whatever M is: all of x's rows are one
//     block's B operand (no grid axis over groups of rows);
//   - one producer thread streams the codes by TMA (boxes of 64 or 256
//     k rows x 128 columns, with their x boxes) into a ring of stages
//     guarded by a full and an empty mbarrier each, a few stages in flight
//     a block (more in flight measured slower: queues, not latency, then
//     bound the stream); eight consumer warps own 16 columns each;
//   - the grid is one block on each SM (the plan of ops/quantization.py::
//     gemv_plan, cached per shape): the blocks first take waves of whole
//     column tiles, side by side on the same rows of q, then share the
//     units of the tiles left in runs that differ by one unit at most, so
//     that they all end together; K is no longer cut to fit x in shared
//     memory;
//   - one launch, the same bits every launch: a run that is a whole column
//     tile goes through the epilogue to out; a part of one goes to a
//     workspace, and at the block's end the tile's ticket (an atomic add,
//     release and acquire at device scope) tells the last of its blocks to
//     add the parts in k order and reset the ticket, so the tickets are
//     zero before and after every launch (graph replay) and no sum is an
//     atomic. The workspace and tickets are kept per device.
// * M <= 16, fp32 x, and the shape classes where it measured faster
//   (ops/quantization.py::gemv_path): the CUDA-core pair,
//   qmm_gemv_kernel then qmm_finish_kernel. Each lane reads 16 codes of
//   one row of q; a warp covers 4 rows x 128 contiguous columns, a block of
//   8 warps 32 rows x 128 columns per step, with up to 4 x rows staged in
//   shared memory as fp32, so its fp32 sums keep x unrounded (the fp32
//   greedy checks). K is split across blocks (gemv_split); each block
//   writes its partial sums to a workspace, and qmm_finish_kernel adds the
//   splits in a fixed order and applies the epilogue. No atomics.
// * M > 16, bf16 x (prefill rows): qmm_wgmma_kernel. What bounds it at
//   the prefill shapes is the tensor cores' rate: M = 260 and 1040 do 2.2
//   to 35 GFLOP a call against 2 to 17 MB to move (c_fc at M = 1040: 35
//   us at 989 TFLOP/s, 7 us at 3.35 TB/s). The block computes out^T = q^T
//   x^T on wgmma: two warpgroups (256 threads) own 128 columns of q, 64
//   each, by tile_x = 136 or 256 rows of x (the product's N: 136 covers
//   260 and 1040 rows in 2 and 8 blocks with 4.6% to spare), and step
//   through K by 64 (two 136-row blocks share an SM; a 256-row one has it
//   alone). A ring of 4 or 5 stages in dynamic shared memory takes each
//   step's x tile and its raw int8 tile of q by TMA (thread 0 issues both
//   boxes, the 128-byte swizzle, zeros past M, N and K, one mbarrier a
//   stage), up to kStages - 1 steps ahead. The codes are the A
//   operand and are made bf16 in registers: q's rows are the contraction,
//   so ldmatrix.trans over the byte pairs of 8 staged rows hands each
//   thread the two k values of an A fragment for two q columns at once,
//   and int8x2_to_bf16x2 makes a pair exact with two masks and one bf16
//   fma (no conversion instruction). x is the B operand, K-major from
//   shared memory (m64n136k16 or m64n256k16, fp32 sums, four a step). Step
//   k issues its products; while they run, the threads wait for step k -
//   1's products, meet at one barrier (the slot that step read is then
//   free, and thread 0 refills it), wait for step k + 1's copies and make
//   its codes A fragments in the second register set. No thread writes
//   shared memory, so no proxy fence is needed; the products are issued
//   unconditionally and their registers written only after the wait that
//   retires them, so ptxas keeps them asynchronous. The height, and a
//   split of K across blocks, come from the shapes by the fixed rule of
//   ops/quantization.py::tile_plan (cached per shape); the tensor maps are
//   cached by pointer and shape. With more than one split each block
//   writes its fp32 sums to the workspace and qmm_finish_kernel adds them
//   in split order: no atomics, the same bits from launch to launch. The
//   epilogue stores q-column pairs (bf16x2 or float2), masked at the
//   ragged M and N edges.
// * M > 16, fp32 x (the fp32 checks): qmm_f32_kernel, a 64 x 64 tile on the
//   fp32 CUDA cores, 4 x 4 outputs a thread.

#include <cuda.h>
#include <stdint.h>

#include <mutex>

#include "common.cuh"
#include "wgmma.cuh"

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
// M > 16, bf16 x: the wgmma tile
// ---------------------------------------------------------------------------

constexpr int kTileQ = 128;                // q columns a block: two warpgroups of 64
constexpr int kTileK = 64;                 // k rows a step
constexpr int kTileThreads = 256;
constexpr int kSmemMax = 232448;           // a block's shared memory on the H100
constexpr int kSmemSm = 233472;            // an SM's, 1 KB of it reserved a block

// Shared memory of a block with BX rows of x: a ring of kStages stages,
// each an x tile (BX rows x 64 k) and a tile of codes (64 rows of q's 128
// columns), both as TMA writes them with the 128-byte swizzle (the x tile
// is then the K-major layout of wgmma.cuh); then one full barrier a stage.
// Where the registers allow two blocks an SM (the 136-row tile: 126 a
// thread), the ring is cut to fit two, so that one block's products run
// while the other waits on its barrier or converts its codes.
template <int BX>
struct TileSmem {
  static constexpr int kBlocksPerSm = BX <= 136 ? 2 : 1;
  static constexpr int kX = BX * kTileK * 2;
  static constexpr int kRaw = kTileK * kTileQ;
  static constexpr int kStageBytes = kX + kRaw;
  static constexpr int kBudget = (kBlocksPerSm == 1 ? kSmemMax : kSmemSm / kBlocksPerSm - 1024);
  static constexpr int kStages = (kBudget - 1024 - 8 * 8) / kStageBytes;
  static constexpr int kRawOff = kStages * kX;
  static constexpr int kBarOff = kRawOff + kStages * kRaw;
  static constexpr int kBytes = kBarOff + 8 * kStages + 1024;  // + slack to align the base
  static_assert(kX % 1024 == 0, "swizzled tiles start on 1024-byte steps");
  static_assert(kStages >= 3, "the ring keeps two stages in flight");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of TMA writes to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase with parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// A 2-D box of `map` at coordinates (c0 inner, c1 outer) into shared memory
// at dst, completing on the barrier at bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Two int8 codes, the low bytes of w's 16-bit lanes (the high bytes are not
// read), as a bf16 pair, exactly and with no conversion instruction: a
// code's low 7 bits in the mantissa of 128 give 128 + (b & 127); its sign
// bit, on the lowest exponent bit of -128 (0xC300), makes -256 (0xC380);
// one bf16 fma adds the two, which leaves b.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t w) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"((w & 0x007F007Fu) | 0x43004300u), "r"(0x3F803F80u),
        "r"((w & 0x00800080u) | 0xC300C300u));
  return d;
}

// The A operand of the four k16 steps of a stage for this warp's 16 q
// columns (16-byte chunk `chunk` of the staged rows of codes), from its
// codes: ldmatrix.trans reads the codes as 8 x 8 tiles of byte pairs, k
// rows 8i..8i+7 for tile i (row r's chunk sits at chunk ^ r % 8, so the 8
// rows of a tile fall on 8 different bank groups), and hands thread (g, t)
// the pairs of rows 2t and 2t + 1 at columns 2g and 2g + 1: one register
// holds both k values of an A fragment for two q columns. The even column
// becomes fragment row g, the odd one row g + 8 (the epilogue maps them
// back).
__device__ __forceinline__ void qmm_codes_to_a(uint32_t raw, int chunk, uint32_t (&a)[4][4]) {
  const int lane = threadIdx.x & 31;
  const uint32_t at = ((chunk ^ (lane & 7)) << 4) + lane * kTileQ;
  uint32_t r[8];
  ldmatrix_x4_trans(r, raw + at);
  ldmatrix_x4_trans(r + 4, raw + at + 32 * kTileQ);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = int8x2_to_bf16x2(r[2 * s]);
    a[s][1] = int8x2_to_bf16x2(r[2 * s] >> 8);
    a[s][2] = int8x2_to_bf16x2(r[2 * s + 1]);
    a[s][3] = int8x2_to_bf16x2(r[2 * s + 1] >> 8);
  }
}

template <typename TO>
__device__ __forceinline__ void store_pair(TO* o, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

// The arguments of one tile launch.
struct TileArgs {
  const float* scale;
  const void* bias;
  void* out;
  float* ws;  // null: one split, the epilogue writes out
  int bias_dtype, M, K, N, kc;
  long long out_sm;
};

// Where step j of the ring stands: its slot and the parity of its slot's
// barrier phase, advanced one step at a time (no division in the loop).
struct RingPos {
  int slot;
  uint32_t phase;
};

template <int S>
__device__ __forceinline__ RingPos ring_next(RingPos p) {
  return p.slot + 1 == S ? RingPos{0, p.phase ^ 1u} : RingPos{p.slot + 1, p.phase};
}

// Thread 0: the TMA copies of step j (k rows k0..k0+63) into `slot`.
template <int BX>
__device__ __forceinline__ void qmm_issue_stage(uint32_t base, int slot, const CUtensorMap* xmap,
                                                const CUtensorMap* qmap, int m0, int n0, int k0) {
  using S = TileSmem<BX>;
  const uint32_t bar = base + S::kBarOff + 8 * slot;
  mbar_expect_tx(bar, S::kStageBytes);
  tma_load_2d(base + slot * S::kX, xmap, k0, m0, bar);
  tma_load_2d(base + S::kRawOff + slot * S::kRaw, qmap, n0, k0, bar);
}

// Step kt of the k loop: the products of step kt (A fragments `cur`, its
// x tile in slot `now`), then, while they run, the wait for step kt - 1's
// products (which frees `next` and the slot that step read), one barrier,
// thread 0's copies of step kt + kStages - 1 into that slot (`ahead`,
// where `issue`), and, where there is a step kt + 1 (`more`), its codes
// (slot `soon`, once its copies have landed) made A fragments in `next`.
// The products are issued unconditionally and the registers they use are
// written only after the wait that retires them, so ptxas keeps them
// asynchronous.
template <int BX>
__device__ __forceinline__ void qmm_tile_step(uint32_t base, float (&acc)[BX / 2],
                                              const uint32_t (&cur)[4][4], uint32_t (&next)[4][4],
                                              RingPos now, RingPos soon, RingPos ahead, bool issue,
                                              bool more, const CUtensorMap* xmap,
                                              const CUtensorMap* qmap, int m0, int n0, int k_ahead,
                                              int chunk) {
  using S = TileSmem<BX>;
  const uint32_t xs = base + now.slot * S::kX;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kTileK / 16; ++s) wgmma_rs(acc, cur[s], desc_k_major(xs, BX, s), 1);
  wgmma_commit();
  wgmma_wait<1>();
  __syncthreads();
  if (issue) qmm_issue_stage<BX>(base, ahead.slot, xmap, qmap, m0, n0, k_ahead);
  if (more) {
    mbar_wait(base + S::kBarOff + 8 * soon.slot, soon.phase);
    qmm_codes_to_a(base + S::kRawOff + soon.slot * S::kRaw, chunk, next);
  }
}

// One block: q columns n0..n0+127 (warpgroup wg takes 64; its warp w the 16
// from n0 + 64 wg + 16 w) by x rows m0..m0+BX-1, over k rows [z kc,
// min((z + 1) kc, K)) for split z = blockIdx.z (kc a multiple of 128, so
// every split but the last has an even count of 64-row steps). It computes
// out^T = q^T x^T: the codes are the A operand, made bf16 in registers, x
// the B operand (K-major in shared memory), so the accumulator's rows are q
// columns and its columns rows of x. TMA zero-fills past M, N and K. With
// one split it applies the epilogue and writes out; otherwise it writes its
// fp32 sums to ws[z] for qmm_finish_kernel.
template <typename TO, int BX>
__global__ void __launch_bounds__(kTileThreads, TileSmem<BX>::kBlocksPerSm) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const TileArgs a) {
  using S = TileSmem<BX>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(align_1024(smem_raw));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * kTileQ, m0 = blockIdx.y * BX;
  const int kbeg = blockIdx.z * a.kc, kend = min(kbeg + a.kc, a.K);
  // an even count of steps, for the loop's two register sets: the last
  // split's extra step lies past K, where TMA reads zeros
  const int nk = ((kend - kbeg + kTileK - 1) / kTileK + 1) & ~1;
  const int chunk = 4 * wg + ((tid >> 5) & 3);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::kStages; ++i) mbar_init(base + S::kBarOff + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < S::kStages - 1; ++j)
      if (j < nk) qmm_issue_stage<BX>(base, j, &xmap, &qmap, m0, n0, kbeg + j * kTileK);
  }

  float acc[BX / 2];
#pragma unroll
  for (int i = 0; i < BX / 2; ++i) acc[i] = 0.f;
  uint32_t a0[4][4], a1[4][4];
  mbar_wait(base + S::kBarOff, 0);
  qmm_codes_to_a(base + S::kRawOff, chunk, a0);

  // ring positions of steps kt, kt + 1 and kt + kStages - 1
  RingPos now{0, 0u}, soon{1, 0u}, ahead{S::kStages - 1, 0u};
  for (int kt = 0; kt < nk; kt += 2) {
    int j = kt + S::kStages - 1;
    qmm_tile_step<BX>(base, acc, a0, a1, now, soon, ahead, tid == 0 && j < nk, true, &xmap,
                      &qmap, m0, n0, kbeg + j * kTileK, chunk);
    now = soon;
    soon = ring_next<S::kStages>(soon);
    ahead = ring_next<S::kStages>(ahead);
    ++j;
    qmm_tile_step<BX>(base, acc, a1, a0, now, soon, ahead, tid == 0 && j < nk, kt + 2 < nk,
                      &xmap, &qmap, m0, n0, kbeg + j * kTileK, chunk);
    now = soon;
    soon = ring_next<S::kStages>(soon);
    ahead = ring_next<S::kStages>(ahead);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + e] is q column n, acc[4j + 2 + e] column n + 1, both at x row
  // m0 + 8j + 2t + e; N is even, so the pair is wholly inside or outside
  const int lane = tid & 31, t = lane & 3;
  const int n = n0 + 16 * chunk + 2 * (lane >> 2);
  if (n >= a.N) return;
#pragma unroll
  for (int j = 0; j < BX / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= a.M) continue;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (a.ws != nullptr) {
        *reinterpret_cast<float2*>(a.ws + ((long long)blockIdx.z * a.M + m) * a.N + n) =
            make_float2(v0, v1);
      } else {
        store_pair<TO>(static_cast<TO*>(a.out) + (long long)m * a.out_sm + n,
                       qmm_epilogue(v0, a.scale, a.bias, a.bias_dtype, n),
                       qmm_epilogue(v1, a.scale, a.bias, a.bias_dtype, n + 1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// M <= 16, bf16 x: the tensor-core GEMV (one launch over a TMA ring)
// ---------------------------------------------------------------------------

constexpr int kGvCols = 128;                     // q columns of a unit: a 128-byte TMA box row
constexpr int kGvK = 64;                         // k rows of an x box and of an A fragment set
constexpr int kGvWarps = 8;                      // consumer warps, 16 columns each
constexpr int kGvThreads = 32 * kGvWarps + 32;   // and one producer warp
constexpr int kGvPartial = 16 * kGvCols;         // floats of a block's part of a column tile

// Shared memory of a block whose x tiles have 8 NT rows and whose units are
// 64 KU k rows: a ring of kRing stages, each a unit's KU x tiles (8 NT rows
// x 64 k, bf16) and its codes (64 KU k rows x 128 columns), as TMA writes
// them with the 128-byte swizzle; a full and an empty barrier a stage; the
// last-block flags. The ring keeps 48 kB (KU 1) or 96 kB (KU 4) of codes
// in flight, the fastest measured (more in flight queued, not hid, the
// latency); the block takes the SM's whole shared memory, so that each of
// the grid's blocks has an SM to itself.
template <int NT, int KU>
struct GvSmem {
  static constexpr int kRing = KU == 1 ? 6 : 3;
  static constexpr int kXBox = 8 * NT * kGvK * 2;
  static constexpr int kX = KU * kXBox;
  static constexpr int kRaw = KU * kGvK * kGvCols;
  static constexpr int kStageBytes = kX + kRaw;
  static constexpr int kRawOff = kRing * kX;
  static constexpr int kFullOff = kRawOff + kRing * kRaw;
  static constexpr int kEmptyOff = kFullOff + 8 * kRing;
  static constexpr int kFlagOff = kEmptyOff + 8 * kRing;
  static constexpr int kBytes = kSmemMax;
  static_assert(kXBox % 1024 == 0, "swizzled tiles start on 1024-byte steps");
  static_assert(kFlagOff + 16 + 1024 <= kBytes, "the ring fits (+ slack to align the base)");
};

// The arguments of one GEMV launch. The work is column tiles of k_units
// units (64 KU k rows x 128 columns). Block b of G first takes the whole
// tiles b, b + G, ..., one a wave for dp_waves waves; the units of the
// tiles left (sk_units, tile by tile) are then shared: block b takes
// [sk_units b / G, sk_units (b + 1) / G).
struct GemvArgs {
  const float* scale;
  const void* bias;
  void* out;
  float* ws;           // [G][2][16][128] partial sums: a block's first and last shared tile
  unsigned* tickets;   // [tiles], zero before and after every launch
  int bias_dtype, M, N, k_units, dp_waves;
  long long out_sm, sk_units;
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The 256 consumer threads meet (the producer warp takes no part).
__device__ __forceinline__ void gv_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kGvWarps) : "memory");
}

// The block whose range holds shared unit u: the largest b with
// units b / G <= u.
__device__ __forceinline__ int gv_owner(long long units, long long u, int G) {
  return (int)(((u + 1) * G + units - 1) / units - 1);
}

// Where the ring stands: the slot of the next stage and the parity of its
// barriers' phase.
template <int R>
struct GvRing {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == R) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The producer (one thread): unit kt of column tile c into the next slot,
// once the consumers have freed it.
template <int NT, int KU>
__device__ __forceinline__ void gv_issue(uint32_t base, GvRing<GvSmem<NT, KU>::kRing>& r,
                                         const CUtensorMap* xmap, const CUtensorMap* qmap, int c,
                                         int kt) {
  using S = GvSmem<NT, KU>;
  const uint32_t bar = base + S::kFullOff + 8 * r.slot;
  mbar_wait(base + S::kEmptyOff + 8 * r.slot, r.phase ^ 1u);  // the first round passes at once
  mbar_expect_tx(bar, S::kStageBytes);
#pragma unroll
  for (int i = 0; i < KU; ++i) {
    tma_load_2d(base + r.slot * S::kX + i * S::kXBox, xmap, (kt * KU + i) * kGvK, 0, bar);
  }
  tma_load_2d(base + S::kRawOff + r.slot * S::kRaw, qmap, c * kGvCols, kt * KU * kGvK, bar);
  r.next();
}

// A consumer warp: the next n units into acc (its 16 columns of each).
// ldmatrix.trans and int8x2_to_bf16x2 make the codes the A fragments of
// four k16 steps (qmm_codes_to_a, as the tile does); x, staged K-major, is
// the B operand of mma.sync m16n8k16, its fragments by ldmatrix (x row
// 8j + lane % 8, 16-byte chunk 4h + lane / 8, which sits at chunk ^ row % 8
// of its row).
template <int NT, int KU>
__device__ __forceinline__ void gv_consume(uint32_t base, GvRing<GvSmem<NT, KU>::kRing>& r, int n,
                                           float (&acc)[4 * NT], int warp, int lane) {
  using S = GvSmem<NT, KU>;
  for (int i = 0; i < n; ++i) {
    mbar_wait(base + S::kFullOff + 8 * r.slot, r.phase);
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const uint32_t xs = base + r.slot * S::kX + u * S::kXBox;
      uint32_t bf[NT][4][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 8 * j + (lane & 7), chunk = 4 * h + (lane >> 3);
          uint32_t q4[4];
          ldmatrix_x4(q4, xs + row * 128 + ((chunk ^ (row & 7)) << 4));
          bf[j][2 * h][0] = q4[0];
          bf[j][2 * h][1] = q4[1];
          bf[j][2 * h + 1][0] = q4[2];
          bf[j][2 * h + 1][1] = q4[3];
        }
      uint32_t af[4][4];
      qmm_codes_to_a(base + S::kRawOff + r.slot * S::kRaw + u * kGvK * kGvCols, warp, af);
#pragma unroll
      for (int s = 0; s < kGvK / 16; ++s)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16_16816(acc + 4 * j, af[s], bf[j][s]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(base + S::kEmptyOff + 8 * r.slot);
    r.next();
  }
}

// This thread's outputs, acc[4j + e] at q column n and acc[4j + 2 + e] at
// n + 1, both at x row 8j + 2t + e, through the epilogue into out.
template <typename TO, int NT>
__device__ __forceinline__ void gv_store(const GemvArgs& a, const float (&acc)[4 * NT], int n,
                                         int t) {
  if (n >= a.N) return;  // N % 16 == 0: n + 1 is inside with n
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * j + 2 * t + e;
      if (m < a.M) {
        store_pair<TO>(static_cast<TO*>(a.out) + (long long)m * a.out_sm + n,
                       qmm_epilogue(acc[4 * j + e], a.scale, a.bias, a.bias_dtype, n),
                       qmm_epilogue(acc[4 * j + 2 + e], a.scale, a.bias, a.bias_dtype, n + 1));
      }
    }
}

// out^T = q^T x^T for M <= 16 rows of bf16 x (NT = 1: M <= 8, one n8 tile
// of x; 2: two), units of 64 KU k rows, one block an SM. The producer
// warp's lane 0 walks the block's units (its whole tiles, then its shared
// range) and copies each one's x (8 NT rows x its 64 KU k) and codes into
// the ring by TMA (an empty barrier a stage, one arrival a consumer warp,
// says the slot is free); consumer warp w owns the 16 columns from 16 w of
// every unit (gv_consume). A whole tile, and a shared run that is one, goes
// through the epilogue to out; a part of a shared tile goes to ws, and at
// the block's end the tile's ticket (an atomic add with release and acquire
// semantics at device scope, after a barrier of the consumers) tells the
// last of its blocks to add the parts in block order, which is k order,
// apply the epilogue and reset the ticket.
template <typename TO, int NT, int KU>
__global__ void __launch_bounds__(kGvThreads, 1) qmm_gemv_tc_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
    const GemvArgs a) {
  using S = GvSmem<NT, KU>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, b = blockIdx.x, k_units = a.k_units;
  const long long u0 = a.sk_units * b / G, u1 = a.sk_units * (b + 1) / G;
  const int sk_tile0 = a.dp_waves * G;  // the first shared tile

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
#pragma unroll
    for (int i = 0; i < S::kRing; ++i) {
      mbar_init(base + S::kFullOff + 8 * i, 1);
      mbar_init(base + S::kEmptyOff + 8 * i, kGvWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  GvRing<S::kRing> r;
  if (warp == kGvWarps) {  // the producer
    if (lane == 0) {
      for (int w = 0; w < a.dp_waves; ++w)
        for (int kt = 0; kt < k_units; ++kt) gv_issue<NT, KU>(base, r, &xmap, &qmap, b + w * G, kt);
      for (long long u = u0; u < u1; ++u) {
        const int c = (int)(u / k_units);
        gv_issue<NT, KU>(base, r, &xmap, &qmap, sk_tile0 + c, (int)(u - (long long)c * k_units));
      }
    }
    return;
  }

  const int t = lane & 3;
  const int col = 16 * warp + 2 * (lane >> 2);  // the even one of this thread's two columns
  float acc[4 * NT];
  for (int w = 0; w < a.dp_waves; ++w) {
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
    gv_consume<NT, KU>(base, r, k_units, acc, warp, lane);
    gv_store<TO, NT>(a, acc, (b + w * G) * kGvCols + col, t);
  }

  // the shared runs: a whole tile goes to out; a part of one goes to this
  // block's slot for it in ws (0: its first tile, 1: its last), and its
  // ticket waits for the block's end, so that no merge stalls the stream
  volatile int* last_flag = reinterpret_cast<volatile int*>(smem + S::kFlagOff);
  const long long first_tile = u0 / k_units;
  int parts[2];
  int n_parts = 0;
  long long u = u0;
  while (u < u1) {
    const int c = (int)(u / k_units);
    const long long tile_end = (long long)(c + 1) * k_units;
    const bool whole = u == (long long)c * k_units && u1 >= tile_end;
    const long long run_end = u1 < tile_end ? u1 : tile_end;
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
    gv_consume<NT, KU>(base, r, (int)(run_end - u), acc, warp, lane);
    u = run_end;
    if (whole) {
      gv_store<TO, NT>(a, acc, (sk_tile0 + c) * kGvCols + col, t);
      continue;
    }
    float* part = a.ws + ((long long)b * 2 + (c == first_tile ? 0 : 1)) * kGvPartial;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<float2*>(part + (8 * j + 2 * t + e) * kGvCols + col) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
    parts[n_parts++] = c;
  }
  if (n_parts == 0) return;

  // the tickets of the tiles whose parts this block wrote. The barrier
  // orders the consumers' writes before thread 0's tickets, atomic adds with
  // release and acquire semantics at device scope: they publish this
  // block's parts and, for the last block of a tile, make the others'
  // visible to the reads after the second barrier.
  gv_consumers_sync();
  if (tid == 0) {
    for (int i = 0; i < n_parts; ++i) {
      const long long c0 = (long long)parts[i] * k_units;
      const unsigned expected = gv_owner(a.sk_units, c0 + k_units - 1, G) -
                                gv_owner(a.sk_units, c0, G) + 1;
      unsigned prev;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(a.tickets + sk_tile0 + parts[i])
                   : "memory");
      const int is_last = prev == expected - 1u;
      // every part is in: ready for the next launch
      if (is_last) a.tickets[sk_tile0 + parts[i]] = 0;
      last_flag[i] = is_last;
    }
  }
  gv_consumers_sync();
  for (int i = 0; i < n_parts; ++i) {
    if (last_flag[i] == 0) continue;
    // the parts in block order, 8 at a time: their reads in flight
    // together, their sums in order
    const int c = parts[i];
    const long long c0 = (long long)c * k_units;
    const int b_first = gv_owner(a.sk_units, c0, G);
    const int b_last = gv_owner(a.sk_units, c0 + k_units - 1, G);
    float sum[4 * NT];
#pragma unroll
    for (int k = 0; k < 4 * NT; ++k) sum[k] = 0.f;
    for (int b8 = b_first; b8 <= b_last; b8 += 8) {
      float2 val[8][2 * NT];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int bb = b8 + k;
        if (bb > b_last) break;
        const bool first = c == a.sk_units * bb / G / k_units;
        const float* pp = a.ws + ((long long)bb * 2 + (first ? 0 : 1)) * kGvPartial + col;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            val[k][2 * j + e] =
                __ldcg(reinterpret_cast<const float2*>(pp + (8 * j + 2 * t + e) * kGvCols));
          }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (b8 + k > b_last) break;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sum[4 * j + e] += val[k][2 * j + e].x;
            sum[4 * j + 2 + e] += val[k][2 * j + e].y;
          }
      }
    }
    gv_store<TO, NT>(a, sum, (sk_tile0 + c) * kGvCols + col, t);
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

// M <= 16: the split-K GEMV and its finish kernel. splits, kc: the split
// of K (gemv_split).
template <typename T, typename TO>
int launch_gemv(const T* x, const int8_t* q, const float* scale, const void* bias, int bias_dtype,
                TO* out, float* ws, int M, int K, int N, long long x_sm, long long out_sm,
                int splits, int kc, cudaStream_t st) {
  if (ws == nullptr || splits < 1 || kc < 1 || kc > kGemvMaxKc || kc % 32 != 0 ||
      (long long)splits * kc < K) {
    return (int)cudaErrorInvalidValue;
  }
  const int col_blocks = (N + kGemvCols - 1) / kGemvCols;
  if (M == 1) {
    qmm_gemv_kernel<T, 1><<<dim3(col_blocks, splits, 1), kGemvThreads, 0, st>>>(
        x, q, ws, M, K, N, x_sm, kc);
  } else {
    qmm_gemv_kernel<T, 4><<<dim3(col_blocks, splits, (M + 3) / 4), kGemvThreads, 0, st>>>(
        x, q, ws, M, K, N, x_sm, kc);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)M * N;
  qmm_finish_kernel<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ws, splits, scale, bias, bias_dtype, out, M, N, out_sm);
  return (int)cudaGetLastError();
}

// The driver's cuTensorMapEncodeTiled, reached through the runtime (the
// library links no driver API), or null where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a row-major 2-D tensor (`inner` elements a row of
// `row_bytes`, `outer` rows) read in boxes of box_inner x box_outer with the
// 128-byte swizzle, zeros outside it. Maps are cached by everything they
// encode (a weight's map is made once; activations reuse a few addresses),
// in a small table guarded by a lock.
struct MapKey {
  const void* ptr;
  unsigned long long inner, outer, row_bytes;
  unsigned box_inner, box_outer;
  int type;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && inner == o.inner && outer == o.outer && row_bytes == o.row_bytes &&
           box_inner == o.box_inner && box_outer == o.box_outer && type == o.type;
  }
};

int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               unsigned long long inner, unsigned long long outer, unsigned long long row_bytes,
               unsigned box_inner, unsigned box_outer) {
  constexpr int kSlots = 1024;
  struct Entry {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static Entry table[kSlots];
  static std::mutex lock;
  const MapKey key{ptr, inner, outer, row_bytes, box_inner, box_outer, (int)type};
  const size_t h = (reinterpret_cast<uintptr_t>(ptr) >> 8) ^ (inner * 31 + outer) ^ box_outer;
  Entry& e = table[h % kSlots];
  std::lock_guard<std::mutex> guard(lock);
  if (e.used && e.key == key) {
    *map = e.map;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  e = Entry{key, *map, true};
  return 0;
}

// M > 16, bf16 x: the wgmma tile, tile_x rows of x a block, K in `splits`
// ranges of kc rows (tile_plan); more than one split sums in ws and
// finishes in qmm_finish_kernel, in split order.
template <typename TO, int BX>
int launch_tile_bx(const __nv_bfloat16* x, const int8_t* q, long long x_sm, const TileArgs& a,
                   int splits, cudaStream_t st) {
  CUtensorMap xmap, qmap;
  int err = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, a.K, a.M, x_sm * 2, kTileK, BX);
  if (err == 0) {
    err = tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.N, a.K, a.N, kTileQ, kTileK);
  }
  if (err != 0) return err;
  // above 48 KB of dynamic shared memory a kernel has to opt in, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_wgmma_kernel<TO, BX>, cudaFuncAttributeMaxDynamicSharedMemorySize, TileSmem<BX>::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.N + kTileQ - 1) / kTileQ, (a.M + BX - 1) / BX, splits);
  qmm_wgmma_kernel<TO, BX><<<grid, kTileThreads, TileSmem<BX>::kBytes, st>>>(xmap, qmap, a);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return (int)launched;
  const long long total = (long long)a.M * a.N;
  qmm_finish_kernel<TO><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.ws, splits, a.scale, a.bias, a.bias_dtype, static_cast<TO*>(a.out), a.M, a.N, a.out_sm);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_tile(const __nv_bfloat16* x, const int8_t* q, const float* scale, const void* bias,
                int bias_dtype, TO* out, float* ws, int M, int K, int N, long long x_sm,
                long long out_sm, int tile_x, int splits, int kc, cudaStream_t st) {
  if (K % 8 != 0 || x_sm % 8 != 0 || out_sm % 2 != 0 || splits < 1 || kc < 2 * kTileK ||
      kc % (2 * kTileK) != 0 || (long long)(splits - 1) * kc >= K || (long long)splits * kc < K ||
      (splits > 1 && ws == nullptr) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const TileArgs a{scale, bias, out, splits > 1 ? ws : nullptr, bias_dtype, M, K, N, kc, out_sm};
  if (tile_x == 136) return launch_tile_bx<TO, 136>(x, q, x_sm, a, splits, st);
  if (tile_x == 256) return launch_tile_bx<TO, 256>(x, q, x_sm, a, splits, st);
  return (int)cudaErrorInvalidValue;
}

// M <= 16, bf16 x: the tensor-core GEMV on `blocks` blocks, units of 64 KU
// k rows.
template <typename TO, int NT, int KU>
int launch_gemv_tc_nt(const __nv_bfloat16* x, const int8_t* q, long long x_sm, int K,
                      const GemvArgs& a, int blocks, cudaStream_t st) {
  using S = GvSmem<NT, KU>;
  CUtensorMap xmap, qmap;
  int err = tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, a.M, x_sm * 2, kGvK, 8 * NT);
  if (err == 0) {
    err = tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.N, K, a.N, kGvCols, KU * kGvK);
  }
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      qmm_gemv_tc_kernel<TO, NT, KU>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (attr != cudaSuccess) return (int)attr;
  qmm_gemv_tc_kernel<TO, NT, KU><<<blocks, kGvThreads, S::kBytes, st>>>(xmap, qmap, a);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_gemv_tc(const __nv_bfloat16* x, const int8_t* q, long long x_sm, int K,
                   const GemvArgs& a, int blocks, int ku, cudaStream_t st) {
  if (a.M <= 8) {
    return ku == 1 ? launch_gemv_tc_nt<TO, 1, 1>(x, q, x_sm, K, a, blocks, st)
                   : launch_gemv_tc_nt<TO, 1, 4>(x, q, x_sm, K, a, blocks, st);
  }
  return ku == 1 ? launch_gemv_tc_nt<TO, 2, 1>(x, q, x_sm, K, a, blocks, st)
                 : launch_gemv_tc_nt<TO, 2, 4>(x, q, x_sm, K, a, blocks, st);
}

template <typename T, typename TO>
int launch_qmm(const void* x, const int8_t* q, const float* scale, const void* bias,
               int bias_dtype, void* out, float* ws, int M, int K, int N, long long x_sm,
               long long out_sm, int tile_x, int splits, int kc, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  TO* o = static_cast<TO*>(out);
  if (M <= kGemvMaxM) {
    return launch_gemv<T, TO>(xt, q, scale, bias, bias_dtype, o, ws, M, K, N, x_sm, out_sm,
                              splits, kc, st);
  }
  if constexpr (sizeof(T) == 2) {
    return launch_tile<TO>(xt, q, scale, bias, bias_dtype, o, ws, M, K, N, x_sm, out_sm, tile_x,
                           splits, kc, st);
  } else {
    const dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM);
    qmm_f32_kernel<TO><<<grid, 256, 0, st>>>(xt, q, scale, bias, bias_dtype, o, M, K, N, x_sm,
                                             out_sm);
    return (int)cudaGetLastError();
  }
}

}  // namespace
}  // namespace sv

// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for types or shapes the kernels do not take. x is
// (M, K) with row stride x_sm (unit column stride), bf16 or fp32; q (K, N)
// int8 contiguous with N % 16 == 0 and 16-byte alignment; scale (N,) fp32;
// bias (N,) of bias_dtype or null; out (M, N) with row stride out_sm. For
// M <= 16, ws holds splits * M * N fp32 partial sums, kc rows of K each
// (a multiple of 32, at most 1024, splits * kc >= K); tile_x is not read.
// For M > 16 with bf16 x: K % 8 == 0, x 16-byte aligned with x_sm % 8 == 0,
// out_sm even; tile_x is 136 or 256, and K is cut into `splits` ranges of
// kc rows (a multiple of 128, none empty), with ws holding splits * M * N
// fp32 sums when splits > 1. fp32 x with M > 16 reads none of the four.
extern "C" int sv_quant_matmul(int x_dtype, int out_dtype, int bias_dtype, const void* x,
                               const void* q, const float* scale, const void* bias, void* out,
                               void* ws, int M, int K, int N, long long x_sm, long long out_sm,
                               int tile_x, int splits, int kc, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qq = static_cast<const int8_t*>(q);
  float* w = static_cast<float*>(ws);
  if (M < 1 || K < 1 || N < 16 || N % 16 != 0) return (int)cudaErrorInvalidValue;
  if (bias != nullptr && bias_dtype != sv::kFloat32 && bias_dtype != sv::kBFloat16) {
    return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == sv::kBFloat16) {
    if (out_dtype == sv::kBFloat16) {
      return sv::launch_qmm<__nv_bfloat16, __nv_bfloat16>(x, qq, scale, bias, bias_dtype, out, w,
                                                          M, K, N, x_sm, out_sm, tile_x, splits,
                                                          kc, st);
    }
    if (out_dtype == sv::kFloat32) {
      return sv::launch_qmm<__nv_bfloat16, float>(x, qq, scale, bias, bias_dtype, out, w, M, K,
                                                  N, x_sm, out_sm, tile_x, splits, kc, st);
    }
  } else if (x_dtype == sv::kFloat32) {
    if (out_dtype == sv::kFloat32) {
      return sv::launch_qmm<float, float>(x, qq, scale, bias, bias_dtype, out, w, M, K, N, x_sm,
                                          out_sm, tile_x, splits, kc, st);
    }
    if (out_dtype == sv::kBFloat16) {
      return sv::launch_qmm<float, __nv_bfloat16>(x, qq, scale, bias, bias_dtype, out, w, M, K,
                                                  N, x_sm, out_sm, tile_x, splits, kc, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core GEMV: out (M, N) = round(x q * scale + bias), M <= 16,
// x (M, K) bf16 with row stride x_sm (a multiple of 8 where M > 1; unit
// column stride), 16-byte aligned, K % 8 == 0; q, scale, bias and out as
// sv_quant_matmul's (out_sm even). The work is ceil(N / 128) column tiles of
// ceil(K / (64 ku)) units (ku 1 or 4); `blocks` blocks first take dp_waves
// waves of whole tiles, one each a wave, and then share the units of the
// tiles left: none, or at least one a block. ws holds blocks * 2 * 16 * 128
// floats, tickets ceil(N / 128) counters that are zero before the launch
// and are zero after it.
extern "C" int sv_quant_gemv(int out_dtype, int bias_dtype, const void* x, const void* q,
                             const float* scale, const void* bias, void* out, void* ws,
                             void* tickets, int M, int K, int N, long long x_sm, long long out_sm,
                             int blocks, int dp_waves, int ku, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_units = (K + ku * sv::kGvK - 1) / (ku * sv::kGvK);
  const long long tiles = (N + sv::kGvCols - 1) / sv::kGvCols;
  const long long sk_units = (tiles - (long long)dp_waves * blocks) * k_units;
  if (M < 1 || M > 16 || K < 1 || K % 8 != 0 || N < 16 || N % 16 != 0 || out_sm % 2 != 0 ||
      (M > 1 && x_sm % 8 != 0) || (ku != 1 && ku != 4) || blocks < 1 || dp_waves < 0 ||
      sk_units < 0 || (sk_units > 0 && sk_units < blocks) || ws == nullptr ||
      tickets == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (bias != nullptr && bias_dtype != sv::kFloat32 && bias_dtype != sv::kBFloat16) {
    return (int)cudaErrorInvalidValue;
  }
  const sv::GemvArgs a{scale, bias, out, static_cast<float*>(ws), static_cast<unsigned*>(tickets),
                       bias_dtype, M, N, k_units, dp_waves, out_sm, sk_units};
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const long long xs = M > 1 ? x_sm : ((K + 7) / 8) * 8;  // one row: any stride TMA takes
  if (out_dtype == sv::kBFloat16) {
    return sv::launch_gemv_tc<__nv_bfloat16>(xb, qq, xs, K, a, blocks, ku, st);
  }
  if (out_dtype == sv::kFloat32) return sv::launch_gemv_tc<float>(xb, qq, xs, K, a, blocks, ku, st);
  return (int)cudaErrorInvalidValue;
}
