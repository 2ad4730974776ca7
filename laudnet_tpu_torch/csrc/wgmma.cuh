// Hopper warpgroup products (sm_90a): shared-memory matrix descriptors in
// the non-swizzled core-matrix layout, wgmma m64n64k16 bf16 -> f32 with both
// operands in shared memory or A in registers, and the fences around them.
//
// The core-matrix layout of a tile of 64 rows x 64 bf16 columns: an 8 x 8
// block of elements (8 rows of 16 bytes) is one core matrix, 128 contiguous
// bytes; core matrix (row / 8, column / 8) sits at ((row / 8) * 8 +
// column / 8) * 128 bytes. Element (r, c) is at byte
//   ((r >> 3) * 8 + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2,
// so a 16-byte chunk of a row is one cp.async and chunk i of the tile (in
// the order of `core_chunk`) lands at byte 16 * i.
//
// The same tile serves both operand majors:
//   K-major (the product contracts over the tile's columns, as Q and K in
//   Q.K^T): core matrices adjacent along K are 128 bytes apart (leading
//   byte offset), along M / N 1024 bytes apart (stride byte offset); a
//   k16 step moves the start address by 256 bytes;
//   MN-major (the product contracts over the tile's rows, as V in P.V,
//   read with the transpose flag): adjacent along K (rows) 1024 bytes,
//   along N (columns) 128; a k16 step moves the start by 2048 bytes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t KMAJOR_LBO = 128, KMAJOR_SBO = 1024, KMAJOR_STEP = 256;
constexpr uint32_t MNMAJOR_LBO = 1024, MNMAJOR_SBO = 128, MNMAJOR_STEP = 2048;

// (row, 16-byte chunk) of chunk i of a 64 x 64 bf16 core-matrix tile.
__device__ __forceinline__ void core_chunk(int i, int& row, int& chunk) {
    row = ((i >> 6) << 3) + (i & 7);
    chunk = (i >> 3) & 7;
}

__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
    return smem_desc(tile, KMAJOR_LBO, KMAJOR_SBO);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) {
    return smem_desc(tile, MNMAJOR_LBO, MNMAJOR_SBO);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64n64 (f32): warp w of the warpgroup holds rows
// 16w..16w+15; with g = lane / 4 and t = lane % 4, d[4j + e] is row
// 16w + g + 8 * (e >> 1), column 8j + 2t + (e & 1). The A-register layout
// of a k16 step kk is the m16n8k16 one, taken from the accumulator columns
// 16kk..16kk+15: {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4],
// d[8kk+5]}, {d[8kk+6], d[8kk+7]}, each pair packed to bf16x2.

#define LT_WG_D32                                                                              \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
        "+f"(d[31])
#define LT_WG_DREGS                                                                            \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
    "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A . B^T-as-stored: A (64 x 16) and B (64 x 16) from shared memory,
// both K-major. ``accumulate`` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LT_WG_DREGS
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : LT_WG_D32
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B: A (64 x 16) from registers (the layout above), B (16 x 64)
// from shared memory, MN-major (read transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LT_WG_DREGS
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : LT_WG_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef LT_WG_D32
#undef LT_WG_DREGS

}  // namespace
