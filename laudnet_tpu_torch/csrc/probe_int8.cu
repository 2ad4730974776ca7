// s8 x s8 -> s32 GEMM for Hopper (sm_90a): C[m, n] = sum_k A[m, k] B[n, k],
// exact 32-bit integer sums, stored raw (no dequantisation, no epilogue).
//
// Replaces the TPU kernel tools/probe_int8.py::rate_pallas_s8 (P2), the
// probe that asks whether an s8 dot runs at the s8 rate inside a kernel
// of one's own. Its 512 x 512 VMEM blocks have no counterpart here: this is
// the tile of B6's products (csrc/vit_block.cu): a 128 x 128 block tile of
// 8 warps (64 x 32 each), mma.sync m16n8k32 from ldmatrix fragments (per
// byte the s8 fragments are laid out as bf16 fragments of m16n8k16, so K is
// addressed in 2-byte units), and a four-stage cp.async ring of 64 bytes of
// K per stage. The probe's question on this card: does B6's GEMM core reach
// the s8 rate at a large K, or is B6 slow only at its small K (384-1536)?
//
// A is (M, K) row-major, B is (N, K) row-major (the (K, N) operand stored
// column-major), C is (M, N) row-major int32. M and N are any; rows past
// them are zero-filled on load and not stored. K % 16 == 0 (a cp.async
// chunk is 16 bytes); chunks past K are zero-filled. Exact: |sum| <=
// 127^2 * K < 2^31 for K < 133,000.

#include "mma_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK2 = 32, LD = BK2 + 8, STAGES = 4, THREADS = 256;
constexpr int STAGE = (BM + BN) * LD;  // 2-byte units per stage
constexpr int SMEM = STAGES * STAGE * 2;

__global__ void __launch_bounds__(THREADS, 2)
s8_gemm_s32(const bf16* __restrict__ A, const bf16* __restrict__ B, int* __restrict__ C,
            int M, int N, int K2) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* sm = reinterpret_cast<bf16*>(smem_raw);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    auto load_stage = [&](int st, int k0) {
        bf16* as = sm + st * STAGE;
        bf16* bs = as + BM * LD;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * THREADS;
            const int r = c >> 2, col = (c & 3) * 8;
            const int gm = m0 + r, gn = n0 + r, gk = k0 + col;
            const bool kin = gk < K2;
            cp_async16(as + r * LD + col, A + (size_t)(gm < M ? gm : 0) * K2 + (kin ? gk : 0),
                       gm < M && kin);
            cp_async16(bs + r * LD + col, B + (size_t)(gn < N ? gn : 0) * K2 + (kin ? gk : 0),
                       gn < N && kin);
        }
    };

    int acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    const int KT = (K2 + BK2 - 1) / BK2;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) load_stage(s, s * BK2);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt landed; stage kt-1 is free to refill
        const int nk = kt + STAGES - 1;
        if (nk < KT) load_stage(nk % STAGES, nk * BK2);
        cp_async_commit();
        const bf16* as = sm + (kt % STAGES) * STAGE;
        const bf16* bs = as + BM * LD;
#pragma unroll
        for (int kk = 0; kk < BK2 / 16; ++kk) {
            unsigned a[4][4], b[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                ldsm_x4(b[j], bs + (wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
        }
    }
    cp_async_wait<0>();

    // raw accumulators: row g (e = 0, 1) and g + 8 (e = 2, 3), columns 2t, 2t+1
    const int g = lane >> 2, t = lane & 3;
    const bool pairs = (N & 1) == 0;  // 8-byte stores stay aligned
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int gm = m0 + wm * 64 + i * 16 + g + h * 8;
            if (gm >= M) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int gn = n0 + wn * 32 + j * 8 + t * 2;
                int* dst = C + (size_t)gm * N + gn;
                if (pairs && gn + 1 < N) {
                    *reinterpret_cast<int2*>(dst) = make_int2(acc[i][j][h * 2], acc[i][j][h * 2 + 1]);
                } else {
                    if (gn < N) dst[0] = acc[i][j][h * 2];
                    if (gn + 1 < N) dst[1] = acc[i][j][h * 2 + 1];
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// a (m, k) and b (n, k) int8 codes, row-major; c (m, n) int32. k % 16 == 0.
int lt_s8_gemm(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
    if (k % 16 != 0 || m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        cudaFuncSetAttribute(s8_gemm_s32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM), block(THREADS);
    s8_gemm_s32<<<grid, block, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<int*>(c), m, n,
        k / 2);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
