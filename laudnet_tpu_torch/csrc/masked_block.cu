// Block-sparse bottleneck tail (kernel B3) for Hopper (sm_90a): the cell
// selection and the tail, two launches a call, bf16 on the tensor cores
// (wgmma) and f32 on the CUDA cores (FFMA).
//
// Replaces the TPU kernel `laudnet_tpu/ops/pallas/masked_block.py::
// masked_bottleneck_tail` (body `_kernel`, pallas_call at :265). For every
// selected cell of the spatial mask it computes, on the cell's patch x patch
// pixels,
//
//   conv2 (3x3 over the haloed window, zero outside the image), f32 sums
//     -> * a2, + b2 (each rounded) -> ReLU -> round to the working type
//     -> conv3 (1x1), f32 sums -> * a3 + b3 -> round
//     -> relu(identity + that), the add rounded to the working type,
//
// and every other cell of the output is relu(identity). The selected cells
// are the first ``capacity`` active cells of each image in raster order
// (the order of the TPU kernel's lax.top_k). The TPU kernel pads channels
// to 128 lanes, DMAs haloed windows and scatters into a zero buffer; none of
// that carries over.
//
// What bounds it on the H100 (one block of 128 images of the flagship,
// mask density 0.5; `chip_smoke.py`'s `tail_bound`):
//   stage 1 (56^2, 64 -> 256, patch 4)   bytes, 0.134 ms: identity and the
//     output whole (205 MB each way), x1 around the selected cells;
//   stage 2 (28^2, 128 -> 512, patch 4)  bytes, 0.067 ms;
//   stage 3 (14^2, 256 -> 1024, patch 2) bytes, 0.035 ms;
//   stage 4 (7^2, 512 -> 2048, patch 1)  operations, 0.021 ms (3,089 rows);
//   the JAX bench (B = 16, 28^2, 1024 -> 2048, patch 7) operations, 0.119
//     ms (117.6 GFLOP at capacity 8).
// The old form (three launches: an identity pass and two mma.sync GEMMs
// through a device-memory intermediate, behind ~15 host operations for the
// selection and the weights' repacking) read 0.22-0.77 ms of device time
// at these shapes, 3.5-13x the bounds, and below ~0.6 ms a call was bound
// by the host. Measured first (a diagnostic run that dropped one part at a
// time, on the H100), the device time went to the stage handshakes and
// the loads, not the products, and at stage 1 to the epilogue's and the
// fill's memory traffic. So the design:
//
// * Two launches a call, and nothing else on the card. (1) `select_kernel`,
//   one block: turns the mask and the capacity into the compacted list of
//   selected cells (image-major, raster order within an image), their count
//   and a flag per cell. The count stays on the card: the host never reads
//   it, and no grid depends on it. (2) The tail: a persistent kernel, one
//   block per SM, whose blocks walk units of work over the live pixels
//   (their number read from the count) and then write relu(identity) on
//   the cells that were not selected. Every output element is written
//   once; no zero buffer, no padded x1, no repacked weight exists.
// * conv2 is ONE implicit GEMM with K = 9 C; its A rows are the pixels of
//   the selected cells, 128 to a tile. Warp specialisation as in the GEMM
//   core (gemm_sm90.cuh): a producer warpgroup (setmaxnreg 56) fills a ring
//   of 3-4 stages of 64 K, two consumer warpgroups (224 registers) of 64
//   rows each run wgmma m64nNk16. A is gathered, not copied: each 16-byte
//   chunk of a row is fetched straight from x1 at the tap's offset with
//   cp.async, zero-filled where the halo leaves the image, into the
//   non-swizzled core-matrix layout read K-major (a quarter-warp writes one
//   core matrix; a warp reads 64 contiguous bytes of each of 8 rows). Each
//   producer thread completes its chunks on the stage's full mbarrier
//   (cp.async.mbarrier.arrive.noinc). The weights are read where they lie:
//   HWIO w2 is the (9 C, C) matrix K x N with N contiguous, w3 the (C, Co)
//   one; TMA brings each stage's B as 128-byte-swizzled boxes of 64 rows x
//   64 columns, read MN-major with the transpose flag (boxes of 8 columns,
//   a 16-byte request a row, were far slower). The consumers release a
//   stage on its empty barrier when the wgmma group that read it has
//   completed.
// * N = 64, 128 or 256 for conv2 (the smallest that holds C up to 256), so
//   stage 1's conv2 runs a 64-wide tile; conv3 runs 256-wide tiles.
// * conv3 is fused where its input fits in shared memory (C <= 256: stages
//   1-3, 16-64 KB a block): a unit of work is a row tile. The conv2
//   epilogue (affine, ReLU, rounding) writes the 128 x C bf16 tile from the
//   accumulators straight into shared memory in the layout conv3's A
//   descriptor reads, and conv3 streams w3 over Co from it. Nothing of the
//   intermediate touches device memory.
// * Above C = 256 (stage 4 at 512, the bench at 1024) the tile's
//   intermediate (128-256 KB) does not fit beside the ring, and a row tile
//   holds too much work for the few tiles there are: 25 at stage 4 and 40
//   at the bench shape, for 132 SMs. So the work is split: first the conv2
//   N-tiles of every row tile, each storing its columns of the
//   intermediate to a scratch in device memory (it stays in L2) and
//   counting itself in its row tile's counter; then the conv3 N-tiles,
//   each waiting (an acquire load) until its row tile's counter is full.
//   Every block takes units b, b + grid, ... and all its conv2 units come
//   before its conv3 units, and every block is resident (one a SM), so a
//   wait only ever waits for a unit that is running. The conv2 units are
//   256 wide where the most rows the capacity allows give at least one a
//   SM (the bench shape at capacity 8: 0.51 ms against 0.64 at 128 wide),
//   else 128 wide (stage 4: 0.167 against 0.186). The counters are zeroed
//   by the selection launch.
// * The epilogues read what they need before their first store (a store
//   might alias a later load): conv3's adds the identity pairs in groups of
//   16 column pairs, a3 and b3 staged per warpgroup in shared memory while
//   the products run. The fill takes runs of consecutive pixels a warp,
//   their flags read at once, 8 pixels' 16-byte chunks in flight.
// * f32 inputs run `tail_f32_kernel`: one unit per 64-row tile, 64 x 64
//   tiles of 4 x 4 outputs a thread, full f32 sums (no TF32), the
//   intermediate through the same block's scratch; bound by operations at
//   the card's 67 TFLOP/s of f32.
//
// Channel counts are multiples of 8 here (the wrapper pads ragged widths to
// one, and slices the output back); any patch that tiles H and W, any
// capacity from 1 to the cells of an image.

#include <cuda_fp16.h>

#include "gemm_sm90.cuh"
#include "mma_common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// Selection
// ---------------------------------------------------------------------------
constexpr int SEL_THREADS = 1024, SEL_WARPS = SEL_THREADS / 32;

// mask types: 0 f32, 1 bf16, 2 f16
__device__ __forceinline__ bool cell_active(const void* mask, int type, size_t i) {
    float v;
    if (type == 0) v = static_cast<const float*>(mask)[i];
    else if (type == 1) v = __bfloat162float(static_cast<const bf16*>(mask)[i]);
    else v = __half2float(static_cast<const __half*>(mask)[i]);
    return v > 0.5f;
}

// One block. counts[0] = the number of selected cells; counts[1 + i] =
// where image i's cells start in ``slots``. slots[j] = image * n_cells +
// cell of the j-th selected cell, -1 past the count; selected[image *
// n_cells + cell] = 1 for a selected cell. Also zeroes the tail's n_done
// per-row-tile counters.
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const void* __restrict__ mask, int mask_type, int b, int n_cells, int capacity,
              int* __restrict__ slots, int* __restrict__ counts,
              unsigned char* __restrict__ selected, int* __restrict__ done, int n_done) {
    __shared__ int warp_total[SEL_WARPS];
    __shared__ int carry;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const unsigned below = (1u << lane) - 1u;
    int* offsets = counts + 1;
    // each image's selected count: its active cells, at most ``capacity``
    for (int img = warp; img < b; img += SEL_WARPS) {
        int n = 0;
        for (int c0 = 0; c0 < n_cells; c0 += 32) {
            const int c = c0 + lane;
            n += __popc(__ballot_sync(~0u, c < n_cells &&
                                               cell_active(mask, mask_type,
                                                           (size_t)img * n_cells + c)));
        }
        if (lane == 0) offsets[img] = min(n, capacity);
    }
    if (tid == 0) carry = 0;
    __syncthreads();
    // exclusive scan of the counts, 1024 images at a time
    for (int base = 0; base < b; base += SEL_THREADS) {
        const int i = base + tid;
        const int v = i < b ? offsets[i] : 0;
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(~0u, incl, o);
            if (lane >= o) incl += u;
        }
        if (lane == 31) warp_total[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int w = warp_total[lane];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int u = __shfl_up_sync(~0u, w, o);
                if (lane >= o) w += u;
            }
            warp_total[lane] = w;
        }
        __syncthreads();
        if (i < b) offsets[i] = carry + (warp ? warp_total[warp - 1] : 0) + incl - v;
        __syncthreads();
        if (tid == 0) carry += warp_total[SEL_WARPS - 1];
        __syncthreads();
    }
    const int n_valid = carry;
    if (tid == 0) counts[0] = n_valid;
    // the flags and the compacted list
    for (int img = warp; img < b; img += SEL_WARPS) {
        const int off = offsets[img];
        int rank = 0;
        for (int c0 = 0; c0 < n_cells; c0 += 32) {
            const int c = c0 + lane;
            const size_t flat = (size_t)img * n_cells + c;
            const bool a = c < n_cells && cell_active(mask, mask_type, flat);
            const unsigned ballot = __ballot_sync(~0u, a);
            const int r = rank + __popc(ballot & below);
            const bool sel = a && r < capacity;
            if (c < n_cells) selected[flat] = sel;
            if (sel) slots[off + r] = static_cast<int>(flat);
            rank += __popc(ballot);
        }
    }
    const int max_slots = b * capacity;
    for (int i = n_valid + tid; i < max_slots; i += SEL_THREADS) slots[i] = -1;
    for (int i = tid; i < n_done; i += SEL_THREADS) done[i] = 0;
}

// ---------------------------------------------------------------------------
// What both tails share
// ---------------------------------------------------------------------------
struct TailArgs {
    const void* x1;        // (b, H, W, C)
    const void* identity;  // (b, H, W, Co)
    const void* w2;        // (3, 3, C, C) HWIO = (9 C, C)
    const void* w3;        // (C, Co)
    const float *a2, *b2, *a3, *b3;
    const int* slots;
    const int* counts;  // [0]: live cells
    const unsigned char* selected;
    int* done;  // per row tile: conv2 N-tiles stored to mid (split schedule)
    void* mid;  // the intermediate where it goes through device memory
    void* out;  // (b, H, W, Co)
    int b, H, W, C, Co, patch, cells_w, n_cells, Cp, capacity;
};

// Row ``gm`` of the compacted pixel list: {pixel index (image * H + y) *
// W + x, y, x, 1}; past the live rows {0, far outside, far outside, 0}, so
// that every tap of it is out of the image.
__device__ __forceinline__ int4 row_entry(const TailArgs& g, int gm, int M) {
    if (gm >= M) return make_int4(0, -8, -8, 0);
    const int pp = g.patch * g.patch;
    const int slot = gm / pp, p = gm - slot * pp;
    const int flat = g.slots[slot];
    const int img = flat / g.n_cells, cell = flat - img * g.n_cells;
    const int cy = cell / g.cells_w, cx = cell - cy * g.cells_w;
    const int py = p / g.patch;
    const int y = cy * g.patch + py, x = cx * g.patch + (p - py * g.patch);
    return make_int4((img * g.H + y) * g.W + x, y, x, 1);
}

__device__ __forceinline__ uint4 relu16(uint4 v, bf16) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __hmax2_nan(p[e], zero);
    return v;
}
__device__ __forceinline__ uint4 relu16(uint4 v, float) {
    float* p = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = fmaxf(p[e], 0.f);
    return v;
}

// out = relu(identity) on every pixel of a cell that was not selected. A
// warp takes a run of consecutive pixels (32 at 32 chunks of 16 bytes a
// pixel, fewer for wider rows, so that every warp has work), its lanes
// read the run's flags at once, then it copies the unselected pixels U at
// a time, its lanes over their 16-byte chunks, U loads in flight (U = 4
// in warps whose registers are few).
template <typename T, int U = 8>
__device__ __forceinline__ void fill_unselected(const TailArgs& g) {
    const int per_pixel = static_cast<int>(g.Co * sizeof(T) / 16);
    const int run = per_pixel >= 1024 ? 1 : per_pixel <= 32 ? 32 : 1024 / per_pixel;
    const int pixels = g.b * g.H * g.W;
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (blockDim.x >> 5);
    const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const uint4* src = static_cast<const uint4*>(g.identity);
    uint4* dst = static_cast<uint4*>(g.out);
    for (int base = run * warp; base < pixels; base += run * warps) {
        const int pixel = base + lane;
        bool take = false;
        if (lane < run && pixel < pixels) {
            const int x = pixel % g.W, rest = pixel / g.W;
            const int y = rest % g.H, img = rest / g.H;
            take = !g.selected[img * g.n_cells + (y / g.patch) * g.cells_w + x / g.patch];
        }
        unsigned left = __ballot_sync(~0u, take);
        while (left) {
            int pix[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                pix[u] = -1;
                if (left) {
                    pix[u] = base + __ffs(left) - 1;
                    left &= left - 1;
                }
            }
            for (int c = lane; c < per_pixel; c += 32) {
                uint4 v[U];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (pix[u] >= 0) v[u] = src[(size_t)pix[u] * per_pixel + c];
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (pix[u] >= 0) dst[(size_t)pix[u] * per_pixel + c] = relu16(v[u], T());
            }
        }
    }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// One arrival on ``bar`` when every cp.async this thread has issued so far
// has landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(shared_u32(bar))
                 : "memory");
}

// Waits until *flag >= target (acquire at GPU scope: what the writer
// stored before its release is visible after); traps after
// MBAR_TIMEOUT_NS instead of hanging the card.
__device__ __forceinline__ void wait_count(const int* flag, int target) {
    auto load = [&] {
        int v;
        asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
        return v;
    };
    if (load() >= target) return;
    const uint64_t t0 = global_ns();
    while (load() < target) {
        __nanosleep(256);
        if (global_ns() - t0 > MBAR_TIMEOUT_NS) __trap();
    }
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma tail
// ---------------------------------------------------------------------------
// d (+)= A . B over one k16 step, m64nNk16, f32 sums: A K-major, B MN-major
// (read transposed). ``accumulate`` = 0 overwrites d.
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void wgmma_mn(float* d, uint64_t da, uint64_t db, int accumulate) {
    if constexpr (N == 64) wgmma_n64(d, da, db, accumulate);
    else if constexpr (N == 128) wgmma_n128(d, da, db, accumulate);
    else wgmma_n256(d, da, db, accumulate);
}

constexpr int TBM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int TBK = 64;   // K of a stage: 128 bytes of bf16 a row
constexpr int T_THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int T_SMEM_LIMIT = 232448;
constexpr int T_PRODUCER_REGS = 56, T_CONSUMER_REGS = 224;
constexpr int A_STAGE = TBM * TBK * 2;  // 16 KB: A's 128 rows x 64 K
constexpr int A_WG = 64 * TBK * 2;      // one warpgroup's 64 rows of it
constexpr int FUSED_MAX_C = 256;        // conv3 fused (intermediate in shared memory)
// named barriers (0 is __syncthreads): the producer's row table; the
// consumers' columns of the intermediate stored (split schedule); each
// consumer warpgroup's intermediate tile in shared memory (fused)
constexpr int BAR_TABLE = 1, BAR_MID = 2, BAR_WG = 3;

// Shared memory: the ring (each stage A's 128 x 64 rows and B's 64 x BNMAX),
// the intermediate tile (fused: 128 rows x BN2), the producer's row table,
// the 2 * STAGES barriers.
template <int BN2, int BN3, bool FUSE>
struct TailShape {
    static constexpr int BNMAX = BN2 > BN3 ? BN2 : BN3;
    static constexpr int STAGE = A_STAGE + TBK * BNMAX * 2;
    static constexpr int H_BYTES = FUSE ? TBM * BN2 * 2 : 0;
    static constexpr int TABLE = TBM * 16;
    static constexpr int AB = 2 * 2 * BN3 * 4;  // each warpgroup's a3, b3 of an N-tile
    static constexpr int FIT = (T_SMEM_LIMIT - 1024 - H_BYTES - TABLE - AB - 64) / STAGE;
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static constexpr int SMEM = STAGES * STAGE + H_BYTES + TABLE + AB + 2 * STAGES * 8 + 1024;
    static_assert(STAGES >= 2 && SMEM <= T_SMEM_LIMIT, "ring does not fit");
};

// Byte offset of element (r, c) in a non-swizzled core-matrix tile whose
// rows hold ``width`` elements: core matrix (r / 8, c / 8) of 8 rows x 16
// bytes at ((r / 8) * (width / 8) + c / 8) * 128. Read K-major when c runs
// along K (LBO 128, SBO width * 16), MN-major when r runs along K (LBO
// width * 16, SBO 128).
__device__ __forceinline__ int core_off(int r, int c, int width) {
    return ((r >> 3) * (width >> 3) + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// B of a stage: rows k0 .. k0 + 63 (K) and columns n0 .. n0 + BN - 1 (N)
// of a row-major weight, by TMA: one 128-byte-swizzled box of 64 rows x 64
// columns (8 KB) for each 64-column atom c, at c * 8192. Each K row of an
// atom is 128 bytes with its 16-byte chunks XOR-ed by the row (TMA's
// SWIZZLE_128B, the layout gemm_sm90.cuh reads K-major), so B is read
// MN-major: 128B swizzle, LBO 8192 (the next atom along N), SBO 1024 (the
// next 8 rows along K), a k16 step 2048 bytes. Rows and columns past the
// weight arrive as zeros. Producer thread 0 announces the bytes and issues
// the boxes.
constexpr uint32_t B_ATOM = 8192;

template <int BN>
__device__ __forceinline__ void tma_b(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                      int k0, int n0, int p) {
    if (p == 0) {
        mbar_arrive_tx(bar, BN * TBK * 2);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) tma_load_2d(dst + c * B_ATOM, map, bar, n0 + 64 * c, k0);
    }
}

__device__ __forceinline__ uint64_t desc_b(const void* tile) {
    return smem_desc(tile, B_ATOM, 1024) | (1ull << 62);
}

// A's descriptor of K-block kb: the ring stage's A (this warpgroup's 64
// rows), or the fused intermediate tile (64 rows x width of K).
struct RingDesc {
    int wg_off;
    __device__ __forceinline__ uint64_t operator()(int, const unsigned char* st) const {
        return smem_desc(st + wg_off, 128, TBK * 16);
    }
};
struct TileDesc {
    const unsigned char* tile;
    int width;
    __device__ __forceinline__ uint64_t operator()(int kb, const unsigned char*) const {
        return smem_desc(tile + kb * TBK * 16, 128, width * 16);
    }
};

// One K loop of N-wide products of a consumer warpgroup into d over
// ``kblocks`` stages of the ring: each stage waited for on its full
// barrier, one wgmma group kept in flight, a stage released (one arrival
// per warp) as soon as the group that read it has completed.
template <int N, int STAGES, int STAGE, int R, class ADesc>
__device__ __forceinline__ void k_loop(float (&d)[R], int kblocks, const ADesc& a_desc,
                                       unsigned char* smem, uint64_t* full, uint64_t* empty,
                                       int& stage, unsigned& phase, int lane) {
    static_assert(R >= N / 2, "accumulator too small");
    int held = 0;
    for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        fence_proxy_async();  // the producer's cp.async bytes, to wgmma's proxy
        const unsigned char* st = smem + stage * STAGE;
        const uint64_t da = a_desc(kb, st);
        const uint64_t db = desc_b(st + A_STAGE);
        fence_regs(d);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < TBK / 16; ++ks)
            wgmma_mn<N>(d, da + ks * (256 >> 4), db + ks * (2048 >> 4), (kb | ks) != 0);
        wg_commit();
        wg_wait<1>();  // the previous K-block's group has read its stage
        if (kb > 0 && lane == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }
    wg_wait<0>();
    fence_regs(d);
    if (lane == 0) mbar_arrive(&empty[held]);
}

// The schedule. FUSE (C <= FUSED_MAX_C): a unit is a row tile, conv2 and
// the fused conv3. Split (above): units are the conv2 N-tiles of every row
// tile, then the conv3 N-tiles of every row tile; a conv2 unit stores its
// columns of the intermediate and counts itself in done[tile], a conv3
// unit waits for all n2 of its tile. Block b takes units b, b + grid, ...;
// all its conv2 units come before any conv3 unit and every block is
// resident (one a SM), so every awaited unit is running or done.
template <int BN2, int BN3, bool FUSE>
__global__ void __launch_bounds__(T_THREADS, 1)
tail_bf16_kernel(const TailArgs g, const __grid_constant__ CUtensorMap tw2,
                 const __grid_constant__ CUtensorMap tw3) {
    using S = TailShape<BN2, BN3, FUSE>;
    extern __shared__ unsigned char tail_raw[];
    // the swizzled B atoms repeat every 1024 bytes: align to them
    unsigned char* smem = tail_raw + ((1024 - (shared_u32(tail_raw) & 1023)) & 1023);
    unsigned char* hbuf = smem + S::STAGES * S::STAGE;
    int4* table = reinterpret_cast<int4*>(hbuf + S::H_BYTES);
    float* abuf = reinterpret_cast<float*>(table + TBM);
    uint64_t* full = reinterpret_cast<uint64_t*>(abuf + 4 * BN3);
    uint64_t* empty = full + S::STAGES;
    const int tid = threadIdx.x, wg = tid >> 7;
    if (tid == 0) {
        for (int s = 0; s < S::STAGES; ++s) {
            // one cp.async arrival per producer thread, and B's TMA bytes
            mbar_init(&full[s], 129);
            mbar_init(&empty[s], 8);   // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int M = g.counts[0] * g.patch * g.patch;
    const int tiles = (M + TBM - 1) / TBM;
    const int K2 = 9 * g.C;
    const int n2 = (g.C + BN2 - 1) / BN2, k2 = (K2 + TBK - 1) / TBK;
    const int n3 = (g.Co + BN3 - 1) / BN3, k3 = g.Cp / TBK;
    const int units = FUSE ? tiles : tiles * (n2 + n3), units2 = FUSE ? tiles : tiles * n2;
    const bf16* x1 = static_cast<const bf16*>(g.x1);
    bf16* mid = static_cast<bf16*>(g.mid);

    if (wg == 2) {
        // --- producer: 128 threads fill the ring with cp.async -------------
        regs_release<T_PRODUCER_REGS>();
        const int p = tid - 256, pw = p >> 5, lane = p & 31;
        const int rr = lane & 7, jh = lane >> 3;  // row in a core matrix, chunk quad
        int stage = 0;
        unsigned phase = 0;
        auto acquire = [&]() {
            mbar_wait(&empty[stage], phase ^ 1);  // passes at once on the first lap
            return smem + stage * S::STAGE;
        };
        auto issue = [&]() {
            cp_async_arrive(&full[stage]);
            if (++stage == S::STAGES) {
                stage = 0;
                phase ^= 1;
            }
        };
        // conv2's stages of N-tile nt of the tile whose rows are in table[].
        // A: warp pw takes row groups 4 pw .. 4 pw + 3, each lane row rr of
        // the group and chunks jh and jh + 4: two K positions a thread,
        // each one tap and channel, stepped by 64 a stage.
        auto conv2 = [&](int nt) {
            int tap[2], ch[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int k = 8 * (jh + 4 * half);
                tap[half] = k / g.C;
                ch[half] = k - tap[half] * g.C;
            }
            int4 ent[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) ent[q] = table[(pw * 4 + q) * 8 + rr];
            for (int kb = 0; kb < k2; ++kb) {
                unsigned char* st = acquire();
                tma_b<BN2>(st + A_STAGE, &tw2, &full[stage], kb * TBK, nt * BN2, p);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int j = jh + 4 * half;
                    const bool in_k = tap[half] < 9;
                    const int dy = tap[half] / 3 - 1, dx = tap[half] % 3 - 1;
                    const bf16* base = x1 + (ptrdiff_t)(dy * g.W + dx) * g.C + ch[half];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int r = (pw * 4 + q) * 8 + rr;
                        const int yy = ent[q].y + dy, xx = ent[q].z + dx;
                        const bool ok =
                            in_k && ent[q].w && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
                        cp_async16(st + core_off(r, 8 * j, TBK),
                                   ok ? base + (size_t)ent[q].x * g.C : x1, ok);
                    }
                    ch[half] += TBK;
                    while (ch[half] >= g.C) {
                        ch[half] -= g.C;
                        ++tap[half];
                    }
                }
                issue();
            }
        };
        // conv3's stages of N-tile nt; split: A from the intermediate's rows
        auto conv3 = [&](int m0, int nt) {
            for (int kb = 0; kb < k3; ++kb) {
                unsigned char* st = acquire();
                if constexpr (!FUSE) {
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int j = jh + 4 * half;
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            const int r = (pw * 4 + q) * 8 + rr;
                            const bool ok = m0 + r < M;
                            cp_async16(st + core_off(r, 8 * j, TBK),
                                       ok ? mid + (size_t)(m0 + r) * g.Cp + kb * TBK + 8 * j
                                          : mid,
                                       ok);
                        }
                    }
                }
                tma_b<BN3>(st + A_STAGE, &tw3, &full[stage], kb * TBK, nt * BN3, p);
                issue();
            }
        };
        auto fill_table = [&](int m0) {
            bar_sync(BAR_TABLE, 128);  // the last unit's reads of the table are done
            table[p] = row_entry(g, m0 + p, M);
            bar_sync(BAR_TABLE, 128);
        };
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            if constexpr (FUSE) {
                fill_table(u * TBM);
                conv2(0);
                for (int nt = 0; nt < n3; ++nt) conv3(u * TBM, nt);
            } else if (u < units2) {
                fill_table(u / n2 * TBM);
                conv2(u % n2);
            } else {
                const int tile = (u - units2) / n3;
                if (p == 0) wait_count(&g.done[tile], n2);  // the tile's intermediate
                bar_sync(BAR_TABLE, 128);
                conv3(tile * TBM, (u - units2) % n3);
            }
        }
        fill_unselected<bf16, 4>(g);  // then the cells not selected
    } else {
        // --- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----------
        regs_claim<T_CONSUMER_REGS>();
        const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, t = lane & 3;
        const bf16* identity = static_cast<const bf16*>(g.identity);
        bf16* out = static_cast<bf16*>(g.out);
        unsigned char* hmine = hbuf + wg * 64 * BN2 * 2;  // fused: this warpgroup's rows
        const int lr0 = warp * 16 + gq;  // this thread's rows lr0, lr0 + 8 of the 64
        float d[S::BNMAX / 2];
#pragma unroll
        for (int i = 0; i < S::BNMAX / 2; ++i) d[i] = 0.f;
        int stage = 0;
        unsigned phase = 0;
        const RingDesc ring_a{wg * A_WG};
        // conv2 of N-tile nt: affine, ReLU, bf16 -> the intermediate
        // (shared memory, fused; device memory rows gm, split)
        auto conv2 = [&](int m0, int nt) {
            k_loop<BN2, S::STAGES, S::STAGE>(d, k2, ring_a, smem, full, empty, stage, phase,
                                             lane);
            if constexpr (FUSE) bar_sync(BAR_WG + wg, 128);  // the last tile's conv3 is done
            // in groups of 8 column pairs: every load of a group is issued
            // before its first store (a store might alias a later load)
#pragma unroll
            for (int j0 = 0; j0 < BN2 / 8; j0 += 8) {
                float2 av[8], bv[8];
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const int n = nt * BN2 + 8 * (j0 + jj) + 2 * t;
                    const bool ok = n < g.C;
                    av[jj] = ok ? __ldg(reinterpret_cast<const float2*>(g.a2 + n)) : make_float2(0.f, 0.f);
                    bv[jj] = ok ? __ldg(reinterpret_cast<const float2*>(g.b2 + n)) : make_float2(0.f, 0.f);
                }
#pragma unroll
                for (int jj = 0; jj < 8; ++jj) {
                    const int j = j0 + jj;
                    const int n = nt * BN2 + 8 * j + 2 * t;
                    if (n >= g.Cp) continue;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float v0 =
                            fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h], av[jj].x), bv[jj].x), 0.f);
                        const float v1 =
                            fmaxf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1], av[jj].y), bv[jj].y), 0.f);
                        const unsigned pair = pack_bf16(v0, v1);
                        const int gm = m0 + wg * 64 + lr0 + 8 * h;
                        if constexpr (FUSE) {
                            *reinterpret_cast<unsigned*>(hmine + core_off(lr0 + 8 * h, n, g.Cp)) =
                                pair;
                        } else if (gm < M) {
                            *reinterpret_cast<unsigned*>(mid + (size_t)gm * g.Cp + n) = pair;
                        }
                    }
                }
            }
        };
        // conv3 of N-tile nt: affine, round, + identity, ReLU -> out. The
        // warpgroup stages the tile's a3 and b3 in shared memory while the
        // products run, so the epilogue's registers go to identity loads.
        auto conv3 = [&](int m0, int nt) {
            float* ab = abuf + wg * 2 * BN3;  // a3, then b3, of the N-tile's columns
            bar_sync(BAR_WG + wg, 128);       // the last N-tile's reads of ab are done
            for (int i = tid & 127; i < BN3; i += 128) {
                const int n = nt * BN3 + i;
                ab[i] = n < g.Co ? g.a3[n] : 0.f;
                ab[BN3 + i] = n < g.Co ? g.b3[n] : 0.f;
            }
            int gm[2], pix[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                gm[h] = m0 + wg * 64 + lr0 + 8 * h;
                pix[h] = row_entry(g, gm[h], M).x;
            }
            if constexpr (FUSE)
                k_loop<BN3, S::STAGES, S::STAGE>(d, k3, TileDesc{hmine, g.Cp}, smem, full, empty,
                                                 stage, phase, lane);
            else
                k_loop<BN3, S::STAGES, S::STAGE>(d, k3, ring_a, smem, full, empty, stage, phase,
                                                 lane);
            bar_sync(BAR_WG + wg, 128);  // ab stored
            // in groups of up to 16 column pairs, every identity load of a
            // group issued before its first store (a store might alias a
            // later load)
            constexpr int G = BN3 / 8 < 16 ? BN3 / 8 : 16;
#pragma unroll
            for (int j0 = 0; j0 < BN3 / 8; j0 += G) {
                unsigned id[G][2];
#pragma unroll
                for (int jj = 0; jj < G; ++jj) {
                    const int n = nt * BN3 + 8 * (j0 + jj) + 2 * t;
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        id[jj][h] = n < g.Co && gm[h] < M ? *reinterpret_cast<const unsigned*>(
                                                                identity + (size_t)pix[h] * g.Co + n)
                                                          : 0u;
                }
#pragma unroll
                for (int jj = 0; jj < G; ++jj) {
                    const int j = j0 + jj, c = 8 * j + 2 * t, n = nt * BN3 + c;
                    if (n >= g.Co) continue;
                    const float2 av = *reinterpret_cast<const float2*>(ab + c);
                    const float2 bv = *reinterpret_cast<const float2*>(ab + BN3 + c);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        if (gm[h] >= M) continue;
                        const float2 idf =
                            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&id[jj][h]));
                        const float y0 = round_bf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h], av.x), bv.x));
                        const float y1 =
                            round_bf(__fadd_rn(__fmul_rn(d[4 * j + 2 * h + 1], av.y), bv.y));
                        *reinterpret_cast<unsigned*>(out + (size_t)pix[h] * g.Co + n) =
                            pack_bf16(fmaxf(round_bf(__fadd_rn(idf.x, y0)), 0.f),
                                      fmaxf(round_bf(__fadd_rn(idf.y, y1)), 0.f));
                    }
                }
            }
        };
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
            if constexpr (FUSE) {
                conv2(u * TBM, 0);
                fence_proxy_async();  // the tile's st.shared, to wgmma's proxy
                bar_sync(BAR_WG + wg, 128);
                for (int nt = 0; nt < n3; ++nt) conv3(u * TBM, nt);
            } else if (u < units2) {
                const int tile = u / n2;
                conv2(tile * TBM, u % n2);
                __threadfence();  // the stored columns, before the count
                bar_sync(BAR_MID, 256);
                if (tid == 0) atomicAdd(&g.done[tile], 1);
            } else {
                conv3((u - units2) / n3 * TBM, (u - units2) % n3);
            }
        }
        fill_unselected<bf16>(g);
    }
}

// ---------------------------------------------------------------------------
// f32: the same schedule on FFMA
// ---------------------------------------------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16, F_THREADS = 256;

// acc (4 x 4 of a 64 x 64 tile: rows 4 ty.., columns 4 tx..) = the product
// over K, each FBK-deep step of A and B staged in shared memory by every
// thread: load_a(k) gives this thread's four A values of its row ``ar``
// at K k .. k + 3, load_b(k) its four B values of K row k.
template <class LoadA, class LoadB>
__device__ __forceinline__ void f32_product(float (&acc)[4][4], int K, const LoadA& load_a,
                                            const LoadB& load_b, float (*As)[FBM + 4],
                                            float (*Bs)[FBN + 4], int tid) {
    const int tx = tid & 15, ty = tid >> 4;
    const int ar = tid >> 2, aq = (tid & 3) * 4;   // A: row, first K of 4
    const int bk = tid >> 4, bn = (tid & 15) * 4;  // B: K row, first column of 4
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += FBK) {
        const float4 va = load_a(k0 + aq);
        As[aq][ar] = va.x;
        As[aq + 1][ar] = va.y;
        As[aq + 2][ar] = va.z;
        As[aq + 3][ar] = va.w;
        *reinterpret_cast<float4*>(&Bs[bk][bn]) = load_b(k0 + bk);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(F_THREADS) tail_f32_kernel(const TailArgs g) {
    __shared__ __align__(16) float As[FBK][FBM + 4];  // K-major: As[k][row]
    __shared__ __align__(16) float Bs[FBK][FBN + 4];
    __shared__ int4 rows[FBM];
    const float* x1 = static_cast<const float*>(g.x1);
    const float* identity = static_cast<const float*>(g.identity);
    const float* w2 = static_cast<const float*>(g.w2);
    const float* w3 = static_cast<const float*>(g.w3);
    float* mid = static_cast<float*>(g.mid);
    float* out = static_cast<float*>(g.out);
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int ar = tid >> 2, bn = (tid & 15) * 4;  // this thread's A row, B columns
    const int M = g.counts[0] * g.patch * g.patch;
    const int tiles = (M + FBM - 1) / FBM;
    const int K2 = 9 * g.C;

    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile * FBM;
        if (tid < FBM) rows[tid] = row_entry(g, m0 + tid, M);
        __syncthreads();
        const int4 e = rows[ar];
        float acc[4][4];
        for (int n0 = 0; n0 < g.C; n0 += FBN) {
            f32_product(
                acc, K2,
                [&](int k) {
                    if (k >= K2 || !e.w) return zero4;
                    const int tap = k / g.C, c = k - tap * g.C;
                    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
                    const int yy = e.y + dy, xx = e.z + dx;
                    if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W) return zero4;
                    return *reinterpret_cast<const float4*>(
                        x1 + (size_t)(e.x + dy * g.W + dx) * g.C + c);
                },
                [&](int k) {
                    const int n = n0 + bn;
                    if (k >= K2 || n >= g.C) return zero4;
                    return *reinterpret_cast<const float4*>(w2 + (size_t)k * g.C + n);
                },
                As, Bs, tid);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int gm = m0 + ty * 4 + i;
                if (gm >= M) continue;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = n0 + tx * 4 + j;
                    if (n < g.C)
                        mid[(size_t)gm * g.C + n] =
                            fmaxf(__fadd_rn(__fmul_rn(acc[i][j], g.a2[n]), g.b2[n]), 0.f);
                }
            }
        }
        __syncthreads();  // the tile's intermediate, to every thread of the block
        for (int n0 = 0; n0 < g.Co; n0 += FBN) {
            f32_product(
                acc, g.C,
                [&](int k) {
                    if (k >= g.C || m0 + ar >= M) return zero4;
                    return *reinterpret_cast<const float4*>(mid + (size_t)(m0 + ar) * g.C + k);
                },
                [&](int k) {
                    const int n = n0 + bn;
                    if (k >= g.C || n >= g.Co) return zero4;
                    return *reinterpret_cast<const float4*>(w3 + (size_t)k * g.Co + n);
                },
                As, Bs, tid);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                if (m0 + r >= M) continue;
                const size_t base = (size_t)rows[r].x * g.Co;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = n0 + tx * 4 + j;
                    if (n < g.Co) {
                        const float y = __fadd_rn(__fmul_rn(acc[i][j], g.a3[n]), g.b3[n]);
                        out[base + n] = fmaxf(__fadd_rn(identity[base + n], y), 0.f);
                    }
                }
            }
        }
        __syncthreads();  // rows[] and the intermediate, free for the next tile
    }
    fill_unselected<float>(g);
}

// The TMA descriptor of a row-major (rows, cols) bf16 weight read in
// 128B-swizzled boxes of 64 rows x 64 columns (`tma_b`), zeros out of
// bounds.
cudaError_t encode_chunks(CUtensorMap* map, const void* base, int rows, int cols) {
    const TensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 8 != 0) return cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {64, TBK};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN2, int BN3, bool FUSE>
cudaError_t launch_bf16(const TailArgs& g, cudaStream_t s) {
    using S = TailShape<BN2, BN3, FUSE>;
    auto kernel = tail_bf16_kernel<BN2, BN3, FUSE>;
    static bool ready = false;  // once per instantiation: the attribute costs host time
    if (!ready) {
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        ready = true;
    }
    CUtensorMap tw2, tw3;
    cudaError_t err = encode_chunks(&tw2, g.w2, 9 * g.C, g.C);
    if (err == cudaSuccess) err = encode_chunks(&tw3, g.w3, g.C, g.Co);
    if (err != cudaSuccess) return err;
    kernel<<<sm_count(), T_THREADS, S::SMEM, s>>>(g, tw2, tw3);
    return cudaGetLastError();
}

// conv3 always in N-tiles of 256 (narrower Co runs zero columns): five
// instantiations keep the build short.
cudaError_t launch_bf16_any(const TailArgs& g, cudaStream_t s) {
    if (g.C > FUSED_MAX_C) {
        // split: conv2 units 256 wide where the most rows the selection can
        // keep give enough of them to fill the card, else 128 wide
        const size_t tiles = ((size_t)g.b * g.capacity * g.patch * g.patch + TBM - 1) / TBM;
        if (tiles * ((g.C + 255) / 256) >= (size_t)sm_count())
            return launch_bf16<256, 256, false>(g, s);
        return launch_bf16<128, 256, false>(g, s);
    }
    return g.C <= 64    ? launch_bf16<64, 256, true>(g, s)
           : g.C <= 128 ? launch_bf16<128, 256, true>(g, s)
                        : launch_bf16<256, 256, true>(g, s);
}

cudaError_t launch_select(const void* mask, int mask_type, void* slots, void* counts,
                          void* selected, int* done, int n_done, int b, int n_cells, int capacity,
                          cudaStream_t s) {
    if (b < 1 || n_cells < 1 || capacity < 1 || capacity > n_cells || mask_type < 0 ||
        mask_type > 2)
        return cudaErrorInvalidValue;
    select_kernel<<<1, SEL_THREADS, 0, s>>>(mask, mask_type, b, n_cells, capacity,
                                            static_cast<int*>(slots), static_cast<int*>(counts),
                                            static_cast<unsigned char*>(selected), done, n_done);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// mask (b, n_cells) of type mask_type (0 f32, 1 bf16, 2 f16); slots (b *
// capacity,) and counts (1 + b,) int32, selected (b * n_cells,) uint8.
int lt_select_cells(const void* mask, int mask_type, void* slots, void* counts, void* selected,
                    int b, int n_cells, int capacity, void* stream) {
    return static_cast<int>(launch_select(mask, mask_type, slots, counts, selected, nullptr, 0,
                                          b, n_cells, capacity,
                                          static_cast<cudaStream_t>(stream)));
}

// x1 (b, H, W, C), identity and out (b, H, W, Co), bf16 or (f32 != 0) f32,
// C and Co multiples of 8; mask (b, H / patch, W / patch) of type
// mask_type (0 f32, 1 bf16, 2 f16); w2 (3, 3, C, C) HWIO and w3 (C, Co) in
// the working type, a2, b2 (C,) and a3, b3 (Co,) f32, all contiguous.
// Scratch: slots (b * capacity,) int32; counts (1 + b + row tiles,) int32,
// row tiles = ceil(b * capacity * patch^2 / 128); selected (b * n_cells,)
// uint8; mid (b * capacity * patch^2 rows): f32 x C for f32, bf16 x
// roundup(C, 64) for bf16 above C = 256, unused otherwise. Two launches:
// the selection and the tail.
int lt_masked_tail(const void* x1, const void* identity, const void* mask, int mask_type,
                   const void* w2, const void* a2, const void* b2, const void* w3, const void* a3,
                   const void* b3, void* slots, void* counts, void* selected, void* mid, void* out,
                   int f32, int b, int H, int W, int C, int Co, int patch, int capacity,
                   void* stream) {
    if (C < 8 || C % 8 != 0 || Co < 8 || Co % 8 != 0 || patch < 1 || H % patch != 0 ||
        W % patch != 0 || b < 1 ||
        (size_t)b * H * W >= (1ull << 31) ||
        (!f32 && C > FUSED_MAX_C && mid == nullptr) || (f32 && mid == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const int cells_w = W / patch, n_cells = (H / patch) * cells_w;
    const int row_tiles = (int)(((size_t)b * capacity * patch * patch + TBM - 1) / TBM);
    int* done = static_cast<int*>(counts) + 1 + b;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_select(mask, mask_type, slots, counts, selected, done, row_tiles, b,
                                  n_cells, capacity, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    TailArgs g{x1, identity, w2, w3,
               static_cast<const float*>(a2), static_cast<const float*>(b2),
               static_cast<const float*>(a3), static_cast<const float*>(b3),
               static_cast<const int*>(slots), static_cast<const int*>(counts),
               static_cast<const unsigned char*>(selected), done, mid, out,
               b, H, W, C, Co, patch, cells_w, n_cells, (C + TBK - 1) / TBK * TBK, capacity};
    if (f32) {
        tail_f32_kernel<<<4 * sm_count(), F_THREADS, 0, s>>>(g);
        return static_cast<int>(cudaGetLastError());
    }
    e = launch_bf16_any(g, s);
    return static_cast<int>(e);
}

}  // extern "C"
