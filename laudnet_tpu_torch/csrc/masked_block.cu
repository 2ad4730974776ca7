// Block-sparse bottleneck tail (kernel B3) for sm_90a.
//
// Replaces the TPU kernel `laudnet_tpu/ops/pallas/masked_block.py::
// masked_bottleneck_tail` (body `_kernel`). For every selected cell of the
// spatial mask it computes, on the cell's patch x patch pixels,
//
//   conv2 (3x3 over the haloed window, zero outside the image), f32 sums
//     -> * a2 + b2 -> ReLU -> round to bf16
//     -> conv3 (1x1), f32 sums -> * a3 + b3 -> round to bf16
//     -> relu(identity + that), the add rounded to bf16,
//
// and every other cell of the output is relu(identity).
//
// What bounds it on the H100: operations. At the widths it is used at
// (C = 64..1024, 9 C^2 + C Co multiply-adds a pixel) the two products need
// 300 to 10,000 operations for every byte of x1, identity and output, well
// above the card's 295 operations a byte, so the design keeps the tensor
// cores fed and lets the bytes follow:
//
// * The 3x3 convolution is ONE implicit GEMM with K = 9 C: the rows of its
//   A operand are the pixels of the selected cells, and each 16-byte chunk
//   of a row is fetched straight from x1 at the tap's offset with cp.async,
//   zero-filled where the halo leaves the image. No padded copy of x1, no
//   gathered window buffer and no per-tap pass exist in device memory.
// * Selected cells are compacted first (the wrapper sorts them to the front
//   and keeps their count on the device), so the M dimension holds only
//   live rows: a tile past the count returns at once, and the last tile
//   masks its ragged rows. The host never waits for the count.
// * Both GEMMs share one 128x128x32 tile, a four-stage cp.async ring and
//   mma.sync m16n8k16 (the primitives of mma_common.cuh); the affine, ReLU
//   and rounding run on the accumulators. The second GEMM's epilogue adds
//   the identity and writes straight to the cell's pixels of the output.
// * Cells that were not selected are filled by a third, bandwidth-bound
//   pass that reads identity and writes relu(identity) for those cells
//   only: no zero buffer of the output's size is written and read back, and
//   no output element is written twice.
//
// The (rows, C) bf16 intermediate between the two products does go through
// device memory (it stays in the 50 MB L2 at these sizes); keeping it in
// shared memory needs one block to own all C columns of its rows and is the
// next design.

#include "mma_common.cuh"

namespace {

constexpr int TBM = 128, TBN = 128, TBK = 32, TLD = TBK + 8, TSTAGES = 4, TTHREADS = 256;
constexpr int TSTAGE = (TBM + TBN) * TLD;  // elements per stage
constexpr int TSMEM = TSTAGES * TSTAGE * 2;

struct Geometry {
    int H, W, C, Co, patch, cells_w, n_cells;
};

// Row ``gm`` of the compacted pixel list: slot gm / patch^2 is a selected
// cell (flat index image * n_cells + cell), gm % patch^2 the pixel in it.
__device__ __forceinline__ void row_pixel(const int* __restrict__ slots, const Geometry& g, int gm,
                                          int& img, int& y, int& x) {
    const int gg = g.patch * g.patch;
    const int slot = gm / gg, p = gm - slot * gg;
    const int flat = slots[slot];
    img = flat / g.n_cells;
    const int cell = flat - img * g.n_cells;
    const int cy = cell / g.cells_w, cx = cell - cy * g.cells_w;
    const int py = p / g.patch, px = p - py * g.patch;
    y = cy * g.patch + py;
    x = cx * g.patch + px;
}

// One 128x128 tile of  acc[m, n] = sum_k A[m, k] Wt[n, k].
// CONV = true:  A is gathered from x1: k = tap * C + c, tap = 3 ky + kx,
//               A[m, k] = x1[img, y + ky - 1, x + kx - 1, c] or 0 outside;
//               out = mid (M, C) bf16 = relu(acc * a + b).
// CONV = false: A = mid (M, C); out = the output image, at the row's pixel:
//               relu(bf16(identity + bf16(acc * a + b))).
// Wt is (N, K) row-major. N and K are multiples of 8; neither needs to be
// a multiple of the tile: chunks past K and rows past M or N are zero-filled.
template <bool CONV>
__global__ void __launch_bounds__(TTHREADS, 2)
tail_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Wt,
                 const float* __restrict__ sa, const float* __restrict__ sb,
                 const int* __restrict__ slots, const int* __restrict__ n_valid, Geometry g,
                 const bf16* __restrict__ identity, bf16* __restrict__ out) {
    const int M = n_valid[0] * g.patch * g.patch;
    const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;
    if (m0 >= M) return;
    const int N = CONV ? g.C : g.Co;
    const int K = CONV ? 9 * g.C : g.C;

    extern __shared__ __align__(128) unsigned char tail_smem[];
    bf16* sm = reinterpret_cast<bf16*>(tail_smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each

    // The two A rows and two W rows this thread copies in every stage.
    const int col = (tid & 3) * 8;
    int r_img[2], r_y[2], r_x[2];
    bool r_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int gm = m0 + (tid >> 2) + i * 64;
        r_ok[i] = gm < M;
        r_img[i] = r_y[i] = r_x[i] = 0;
        if (CONV && r_ok[i]) row_pixel(slots, g, gm, r_img[i], r_y[i], r_x[i]);
    }

    auto load_stage = [&](int st, int k0) {
        bf16* as = sm + st * TSTAGE;
        bf16* bs = as + TBM * TLD;
        const int kk = k0 + col;
        const bool in_k = kk < K;
        int ky = 0, kx = 0, c = kk;
        if (CONV) {
            const int tap = kk / g.C;
            c = kk - tap * g.C;
            ky = tap / 3;
            kx = tap - ky * 3;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = (tid >> 2) + i * 64;
            bool ok = r_ok[i] && in_k;
            const bf16* src = A;
            if (CONV) {
                const int yy = r_y[i] + ky - 1, xx = r_x[i] + kx - 1;
                ok = ok && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
                if (ok) src = A + (((size_t)r_img[i] * g.H + yy) * g.W + xx) * g.C + c;
            } else if (ok) {
                src = A + (size_t)(m0 + r) * K + kk;
            }
            cp_async16(as + r * TLD + col, src, ok);
            const int gn = n0 + r;
            const bool okb = gn < N && in_k;
            cp_async16(bs + r * TLD + col, okb ? Wt + (size_t)gn * K + kk : Wt, okb);
        }
    };

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int KT = (K + TBK - 1) / TBK;
#pragma unroll
    for (int s = 0; s < TSTAGES - 1; ++s) {
        if (s < KT) load_stage(s, s * TBK);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<TSTAGES - 2>();
        __syncthreads();  // stage kt landed; stage kt-1 is free to refill
        const int nk = kt + TSTAGES - 1;
        if (nk < KT) load_stage(nk % TSTAGES, nk * TBK);
        cp_async_commit();
        const bf16* as = sm + (kt % TSTAGES) * TSTAGE;
        const bf16* bs = as + TBM * TLD;
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk) {
            unsigned a[4][4], b[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * TLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                ldsm_x4(b[j], bs + (wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * TLD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
        }
    }
    cp_async_wait<0>();

    // Epilogue from the accumulators: each thread owns column pairs. The
    // affine is a separately rounded multiply and add, as the plain version.
    const int q = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int gm = m0 + wm * 64 + i * 16 + q + h * 8;
            if (gm >= M) continue;
            size_t row_off;
            if (CONV) {
                row_off = (size_t)gm * N;
            } else {
                int img, y, x;
                row_pixel(slots, g, gm, img, y, x);
                row_off = (((size_t)img * g.H + y) * g.W + x) * N;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int gn = n0 + wn * 32 + j * 8 + t * 2;
                if (gn >= N) continue;
                float v0 = __fadd_rn(__fmul_rn(acc[i][j][h * 2], sa[gn]), sb[gn]);
                float v1 = __fadd_rn(__fmul_rn(acc[i][j][h * 2 + 1], sa[gn + 1]), sb[gn + 1]);
                if (CONV) {
                    v0 = fmaxf(v0, 0.f);
                    v1 = fmaxf(v1, 0.f);
                } else {
                    const float2 id = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(identity + row_off + gn));
                    v0 = fmaxf(round_bf(__fadd_rn(id.x, round_bf(v0))), 0.f);
                    v1 = fmaxf(round_bf(__fadd_rn(id.y, round_bf(v1))), 0.f);
                }
                *reinterpret_cast<unsigned*>(out + row_off + gn) = pack_bf16(v0, v1);
            }
        }
    }
}

// out = relu(identity) on the pixels of every cell that was NOT selected;
// selected cells are left to the second GEMM. One thread per 16 bytes.
__global__ void __launch_bounds__(256)
tail_identity_kernel(const bf16* __restrict__ identity, const unsigned char* __restrict__ selected,
                     bf16* __restrict__ out, Geometry g, size_t n_chunks) {
    const size_t chunk = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (chunk >= n_chunks) return;
    const int per_pixel = g.Co / 8;
    const size_t pixel = chunk / per_pixel;
    const int x = static_cast<int>(pixel % g.W);
    const size_t rest = pixel / g.W;
    const int y = static_cast<int>(rest % g.H);
    const size_t img = rest / g.H;
    const int cell = (y / g.patch) * g.cells_w + x / g.patch;
    if (selected[img * g.n_cells + cell]) return;
    uint4 v = reinterpret_cast<const uint4*>(identity)[chunk];
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __hmax2_nan(p[e], zero);
    reinterpret_cast<uint4*>(out)[chunk] = v;
}

}  // namespace

extern "C" {

// x1 (b, H, W, C), identity and out (b, H, W, Co) bf16; slots (max_slots,)
// int32: the selected cells first (image * n_cells + cell); n_valid (1,)
// int32 on the device: how many of them are live; selected (b * n_cells,)
// uint8; w2t (C, 9 C) and w3t (Co, C) bf16, K-major; a2, b2 (C,) and a3, b3
// (Co,) f32; mid: scratch of max_slots * patch^2 * C bf16.
int lt_masked_tail(const void* x1, const void* identity, const void* slots, const void* n_valid,
                   const void* selected, const void* w2t, const void* a2, const void* b2,
                   const void* w3t, const void* a3, const void* b3, void* mid, void* out, int b,
                   int H, int W, int C, int Co, int patch, int max_slots, void* stream) {
    if (C % 8 != 0 || Co % 8 != 0 || patch < 1 || H % patch != 0 || W % patch != 0 ||
        max_slots < 1 || b < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Geometry g{H, W, C, Co, patch, W / patch, (H / patch) * (W / patch)};
    cudaError_t err = cudaFuncSetAttribute(tail_gemm_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(tail_gemm_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t n_chunks = (size_t)b * H * W * (Co / 8);
    tail_identity_kernel<<<static_cast<unsigned>((n_chunks + 255) / 256), 256, 0, s>>>(
        static_cast<const bf16*>(identity), static_cast<const unsigned char*>(selected),
        static_cast<bf16*>(out), g, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const int m_tiles = (max_slots * patch * patch + TBM - 1) / TBM;
    tail_gemm_kernel<true><<<dim3(m_tiles, (C + TBN - 1) / TBN), TTHREADS, TSMEM, s>>>(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(w2t),
        static_cast<const float*>(a2), static_cast<const float*>(b2),
        static_cast<const int*>(slots), static_cast<const int*>(n_valid), g, nullptr,
        static_cast<bf16*>(mid));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    tail_gemm_kernel<false><<<dim3(m_tiles, (Co + TBN - 1) / TBN), TTHREADS, TSMEM, s>>>(
        static_cast<const bf16*>(mid), static_cast<const bf16*>(w3t),
        static_cast<const float*>(a3), static_cast<const float*>(b3),
        static_cast<const int*>(slots), static_cast<const int*>(n_valid), g,
        static_cast<const bf16*>(identity), static_cast<bf16*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
