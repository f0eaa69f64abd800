// Hopper tensor-core building blocks (sm_90a): a 128-byte-swizzled
// shared-memory layout for bf16 tiles, cp.async staging into it, and the
// warpgroup products wgmma.m64n64k16 (fp32 sums) with A from shared memory
// or from registers, and m64n136k16 / m64n256k16 with A from registers and
// B K-major.
//
// Tile layout. A tile of R rows x C bf16 columns (C a multiple of 64) is
// stored as C / 64 column blocks of R rows x 128 bytes; block c starts at
// c * R * 128 bytes. Inside a block, the 16-byte chunk k (8 columns) of row r
// sits at chunk k ^ (r % 8) of the row: the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and that a wgmma descriptor of layout
// type 1 reads. Every block starts on a 1024-byte boundary, so the swizzle
// is a function of the absolute address and a descriptor may start at any
// 16-byte step inside it.
//
// One layout serves both ways a product can read a tile:
//   K-major (the tile's columns are the contraction): a k16 step at column
//     16 s starts at block s / 4, byte 32 (s % 4); 8-row groups are 1024
//     bytes apart (the descriptor's stride byte offset).
//   MN-major (the tile's rows are the contraction, its columns the output's
//     N, "transposed"): a k16 step at row 16 s starts at byte 2048 s of a
//     64-column block; the two 8-row groups of the step are 1024 bytes apart
//     (stride byte offset), 64-column blocks R * 128 bytes apart (leading
//     byte offset; an n64 product reads one block).
//
// Accumulator of an m64nN product, per thread (warp w of the warpgroup,
// g = lane / 4, t = lane % 4): d[4j + e] is row 16w + g, column 8j + 2t + e,
// and d[4j + 2 + e] row 16w + g + 8, for n8 block j = 0..N/8 - 1 and e = 0, 1
// (N / 2 floats: 32 for n64, 68 for n136, 128 for n256).
// The A operand from registers for a k16 step s is the bf16 pairs of the
// accumulator's columns 16s..16s+15 (acc_to_a), the layout in which the
// accumulator of one product feeds the next with no shared-memory trip.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sv {

constexpr int kSwizzleRowBytes = 128;  // one row of a 64-column block
constexpr int kSwizzleAtomBytes = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the dynamic shared memory base
// is only 16-byte aligned; kernels allocate 1024 bytes of slack for this).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Byte offset of the 16-byte chunk `chunk` (8 columns) of row r in a
// swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled_chunk(int rows, int r, int chunk) {
  return (chunk >> 3) * rows * kSwizzleRowBytes + r * kSwizzleRowBytes +
         (((chunk & 7) ^ (r & 7)) << 4);
}

// 16 bytes from global to shared memory, asynchronous; zeros when !valid
// (the source is then not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronous; zeros when !valid.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are pending, then
// makes the landed copies visible to the tensor cores' (async proxy) reads;
// a __syncthreads() must follow before another thread's copies are read.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages rows [r0, r0 + ROWS) of a row-major bf16 operand with COLS
// contiguous columns (row stride `ld` elements, 16-byte aligned rows) into a
// swizzled tile at shared address `dst`, zeros past row n. All THREADS
// threads of the block call it.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                           int r0, int n) {
  constexpr int kChunks = COLS / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < n;
    const __nv_bfloat16* p = src + (long long)(in ? r0 + r : 0) * ld + c * 8;
    cp_async_16(dst + swizzled_chunk(ROWS, r, c), p, in);
  }
}

// A shared-memory matrix descriptor, 128-byte swizzle (layout type 1);
// offsets in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The k16 step s of a K-major operand (a tile of `rows` rows).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows, int s) {
  return wgmma_desc(tile + (s >> 2) * rows * kSwizzleRowBytes + (s & 3) * 32, 16,
                    kSwizzleAtomBytes);
}

// The k16 step s (rows 16s..16s+15) of an MN-major operand, 64-column block
// `cb` (a tile of `rows` rows).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows, int cb, int s) {
  return wgmma_desc(tile + cb * rows * kSwizzleRowBytes + s * 16 * kSwizzleRowBytes,
                    rows * kSwizzleRowBytes, kSwizzleAtomBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed product groups are
// pending (groups retire in commit order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SV_WGMMA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SV_WGMMA_D32_OUT(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),        \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),     \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, fp32) = A B (+ d when accumulate): A (64 x 16) and B (16 x
// 64) from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SV_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SV_WGMMA_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) = A B (+ d when accumulate): A (64 x 16) from
// registers (acc_to_a's layout), B (16 x 64) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SV_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SV_WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#define SV_WGMMA_D68                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                               \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                      \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                      \
  "%60, %61, %62, %63, %64, %65, %66, %67}"
#define SV_WGMMA_D128                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                               \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "                      \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "                      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                      \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "                      \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "                      \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                      \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "              \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "          \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define SV_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SV_F16(d, i) SV_F4(d, i), SV_F4(d, i + 4), SV_F4(d, i + 8), SV_F4(d, i + 12)
#define SV_F64(d, i) SV_F16(d, i), SV_F16(d, i + 16), SV_F16(d, i + 32), SV_F16(d, i + 48)

// d (64 x 136, fp32) = A B (+ d when accumulate): A (64 x 16) from
// registers (acc_to_a's layout), B (16 x 136) from shared memory, K-major
// (desc_k_major of a tile of 136 rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[68], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 " SV_WGMMA_D68
      ", {%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
      : SV_F64(d, 0), SV_F4(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same with B (16 x 256).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SV_WGMMA_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : SV_F64(d, 0), SV_F64(d, 64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef SV_WGMMA_D32
#undef SV_WGMMA_D32_OUT
#undef SV_WGMMA_D68
#undef SV_WGMMA_D128
#undef SV_F4
#undef SV_F16
#undef SV_F64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of k16 step s from an m64n64 accumulator's columns
// 16s..16s+15, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], int s, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * s + 0], d[8 * s + 1]);
  a[1] = pack_bf16(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack_bf16(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack_bf16(d[8 * s + 6], d[8 * s + 7]);
}

}  // namespace sv
