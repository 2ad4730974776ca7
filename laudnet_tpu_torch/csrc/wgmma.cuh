// Hopper warpgroup products (sm_90a): shared-memory matrix descriptors in
// the non-swizzled core-matrix layout, wgmma m64n64k16 bf16 -> f32 with both
// operands in shared memory or A in registers, and the fences around them;
// for the GEMM core (gemm_sm90.cuh) the 128-byte-swizzled K-major
// descriptor, the wide m64nN forms (bf16 k16 -> f32, s8 k32 -> s32), the
// mbarrier and TMA primitives (multicast too), the thread-block cluster's
// (distributed shared memory) and setmaxnreg.
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

#include <cuda.h>
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
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// ---------------------------------------------------------------------------
// The 128-byte-swizzled K-major layout that TMA writes under
// CU_TENSOR_MAP_SWIZZLE_128B: a tile row is 128 bytes of K (64 bf16 or 128
// s8), rows follow each other at 128 bytes, and within each 1024-byte atom
// of 8 rows the 16-byte chunk c of row r sits at chunk c ^ r. The
// descriptor: stride byte offset 1024 (from one 8-row atom to the next
// along M / N), leading byte offset unused for a swizzled K-major operand
// (1), layout type 1 (128B swizzle) in bits 62-63. The tile must start on
// a 1024-byte boundary (base offset 0). A k-step of 32 bytes (k16 bf16,
// k32 s8) moves the start address by 32 bytes inside the row: the hardware
// applies the XOR to the address it forms, so the advanced descriptor reads
// the same swizzled atoms. Four k-steps cover a 128-byte row.
// ---------------------------------------------------------------------------
constexpr uint32_t SW128_ROW = 128, SW128_ATOM = 1024, SW128_KSTEP = 32;

__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(SW128_ATOM >> 4) << 32) | (1ull << 62);
}

// d (+)= A . B^T-as-stored over one k-step: A (64 rows) and B (N rows) in
// shared memory, both K-major, 128B-swizzled. The accumulator layout of
// m64nN is that of m64n64 above, extended: d[4j + e] is row 16w + g +
// 8 * (e >> 1), column 8j + 2t + (e & 1), j < N / 8. bf16: m64nNk16, f32
// sums; s8: m64nNk32, exact s32 sums (s8 takes K-major operands only).
// ``accumulate`` = 0 overwrites d.
#define LT_O8(c, i)                                                                            \
    c(d[i]), c(d[(i) + 1]), c(d[(i) + 2]), c(d[(i) + 3]), c(d[(i) + 4]), c(d[(i) + 5]),       \
        c(d[(i) + 6]), c(d[(i) + 7])
#define LT_O32(c, i) LT_O8(c, i), LT_O8(c, (i) + 8), LT_O8(c, (i) + 16), LT_O8(c, (i) + 24)
#define LT_O96(c) LT_O32(c, 0), LT_O32(c, 32), LT_O32(c, 64)
#define LT_O112(c) LT_O96(c), LT_O8(c, 96), LT_O8(c, 104)
#define LT_O128(c) LT_O96(c), LT_O32(c, 96)
#define LT_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define LT_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define LT_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define LT_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define LT_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define LT_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define LT_R6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
              "%110, %111"
#define LT_R7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "   \
              "%125, %126, %127"
#define LT_R96 "{" LT_R0 ", " LT_R1 ", " LT_R2 ", " LT_R3 ", " LT_R4 ", " LT_R5 "}"
#define LT_R112 "{" LT_R0 ", " LT_R1 ", " LT_R2 ", " LT_R3 ", " LT_R4 ", " LT_R5 ", " LT_R6 "}"
#define LT_R128 \
    "{" LT_R0 ", " LT_R1 ", " LT_R2 ", " LT_R3 ", " LT_R4 ", " LT_R5 ", " LT_R6 ", " LT_R7 "}"

// REGS: accumulator registers (N / 2); A, B, P: the operand numbers of the
// two descriptors and the accumulate flag.
#define LT_WGMMA_BF16(N, REGS, A, B, P)                                                        \
    __device__ __forceinline__ void wgmma_sw(float (&d)[N / 2], uint64_t da, uint64_t db,      \
                                             int accumulate) {                                 \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                         \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " LT_R##REGS   \
                     ", %" #A ", %" #B ", p, 1, 1, 0, 0;\n}\n"                                 \
                     : LT_O##REGS("+f")                                                        \
                     : "l"(da), "l"(db), "r"(accumulate));                                     \
    }
#define LT_WGMMA_S8(N, REGS, A, B, P)                                                          \
    __device__ __forceinline__ void wgmma_sw(int (&d)[N / 2], uint64_t da, uint64_t db,        \
                                             int accumulate) {                                 \
        asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                         \
                     "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 " LT_R##REGS       \
                     ", %" #A ", %" #B ", p;\n}\n"                                             \
                     : LT_O##REGS("+r")                                                        \
                     : "l"(da), "l"(db), "r"(accumulate));                                     \
    }
LT_WGMMA_BF16(192, 96, 96, 97, 98)
LT_WGMMA_BF16(224, 112, 112, 113, 114)
LT_WGMMA_S8(192, 96, 96, 97, 98)
LT_WGMMA_S8(224, 112, 112, 113, 114)
LT_WGMMA_S8(256, 128, 128, 129, 130)
#undef LT_WGMMA_BF16
#undef LT_WGMMA_S8
#undef LT_O8
#undef LT_O32
#undef LT_O96
#undef LT_O112
#undef LT_O128
#undef LT_R0
#undef LT_R1
#undef LT_R2
#undef LT_R3
#undef LT_R4
#undef LT_R5
#undef LT_R6
#undef LT_R7
#undef LT_R96
#undef LT_R112
#undef LT_R128

// --- mbarriers, TMA and register reallocation -------------------------------

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_u32(bar)), "r"(count)
                 : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_u32(bar)) : "memory");
}
// One arrival that also announces ``bytes`` of TMA transactions to come.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     shared_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}
// Waits for the completion of the barrier's phase of parity ``parity`` (a
// fresh barrier is in phase 0: waiting on parity 1 returns at once). A
// wait that lasts MBAR_TIMEOUT_NS traps: a wrong parity or a lost TMA
// transaction then fails the launch with an error instead of hanging the
// card.
constexpr uint64_t MBAR_TIMEOUT_NS = 4000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const uint32_t addr = shared_u32(bar);
    if (mbar_try(addr, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try(addr, parity))
        if (global_ns() - t0 > MBAR_TIMEOUT_NS) __trap();
}

// TMA: the 2-D box of ``map`` at (c0 along the inner dimension, c1 along
// the outer) into shared memory at ``dst``, completing ``bar``'s
// transactions; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(shared_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}
__device__ __forceinline__ void tma_prefetch_desc(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --- thread-block clusters ----------------------------------------------------
// A cluster's blocks sit on neighbouring SMs and address each other's shared
// memory (distributed shared memory): mapa turns a variable's shared address
// into the address of the same variable in block ``rank`` of the cluster.

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
    return r;
}
// Every thread of every block of the cluster; orders the barriers'
// initialisation before any block uses another's.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(shared_u32(p)), "r"(rank));
    return r;
}
// Four bytes into the shared memory of a block of the cluster (``addr``
// from cluster_addr), completed on that block's barrier ``bar`` (also from
// cluster_addr) as 4 transaction bytes: the value is there when the
// barrier's phase completes, with no fence on either side.
__device__ __forceinline__ void st_async_cluster(uint32_t addr, float v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
                     addr),
                 "f"(v), "r"(bar)
                 : "memory");
}
// One arrival on a barrier of any block of the cluster (``bar`` from
// cluster_addr).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// tma_load_2d into the same shared offset of every block in ``mask`` (bit
// r: cluster rank r), completing each one's barrier at that offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(shared_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
        : "memory");
}

// Moves registers between the warpgroups of a warp-specialised block: the
// whole warpgroup executes it; the counts are multiples of 8 in [24, 256].
template <int R>
__device__ __forceinline__ void regs_release() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_claim() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace
