// The port's one GEMM core for Hopper (sm_90a): C = A . W^T with an
// epilogue applied from the accumulator registers, A (M, K) and W (N, K)
// both row-major (K-major, W in torch.nn.Linear layout), in bf16 (f32 sums)
// or s8 (exact s32 sums).
//
// It serves the TPU kernels
//   laudnet_tpu/ops/pallas/vit_block.py:303 fused_vit_block       (B1)
//   laudnet_tpu/ops/pallas/vit_block.py:472 fused_vit_segment     (B2)
//   laudnet_tpu/ops/pallas/vit_block.py:175 fused_vit_block_int8  (B6)
//   tools/probe_block_budget.py:190 build_block                   (P1)
//   tools/probe_int8.py:61 rate_pallas_s8                         (P2)
// through csrc/vit_block.cu (the layer's four weight products, qkv, proj,
// fc1 and fc2, with their epilogues) and csrc/probe_int8.cu (a raw int32
// product). The TPU kernels hold a whole layer's weights in VMEM and run
// each product as one MXU dot per grid step; here each product is its own
// launch.
//
// What bounds it on the H100. At DeiT-S bs128 (M = 25,216 rows) the bf16
// products do 22-45 GFLOP against 58-97 MB each: qkv and fc1 sit near the
// ridge (~295 FLOP a byte), proj and fc2 are bound by their f32 bytes (the
// residual stream x2), so a product is fast only if the tensor cores are
// fed at their rate AND the epilogue's stores overlap the next tile's
// loads. The s8 products do the same work at twice the peak and are bound
// by bytes. What the design does about it:
//   - TMA (cp.async.bulk.tensor) brings 128-byte-swizzled tiles of A and W
//     into a ring of STAGES stages in shared memory, one K-block of 128
//     bytes (64 bf16 or 128 s8) per stage: one shared-memory geometry for
//     both types. A full / empty mbarrier pair per stage hands a stage from
//     the producer to the consumers and back. TMA zero-fills what lies past
//     M, N or K, so the edges need no predicated loads.
//   - Warp specialisation: one producer warp (of a third warpgroup, which
//     gives up its registers with setmaxnreg) issues the loads; two
//     consumer warpgroups, 64 rows each, run wgmma.mma_async straight from
//     shared memory, m64nNk16 bf16 or m64nNk32 s8, N the whole tile width
//     (a k-step reads A once for all N columns: 83 of the SM's 128 bytes a
//     cycle at BN = 192). One wgmma group stays in flight; a stage is
//     released as soon as the group that read it has completed.
//   - Persistent blocks: one block per SM walks the tiles in N-fastest
//     order (the blocks in flight share the rows of A they read from L2),
//     and the producer runs ahead into the next tile while the consumers
//     apply the epilogue, so a tile's stores overlap the next tile's loads.
//   - The tile is 128 x BN. BN is a template parameter chosen by the
//     caller: 192 divides all of DeiT-S's widths (384, 1152, 1536) and
//     T2T-ViT-19's 1344, 224 its 448, 256 P2's n = 4096. Waves at M =
//     25,216 (197 row tiles) on 132 SMs: DeiT-S qkv 1,182 tiles (8.95
//     waves), proj and fc2 394 (2.98), fc1 1,576 (11.94); T2T qkv and fc1
//     1,379 (10.45), proj and fc2 394; B2's L = 98 segments (99 row tiles)
//     half of each. P2 at n = 4096: 512 tiles (3.88 waves).
//   - Epilogues are applied from the accumulators: each thread holds
//     column pairs of two rows (wgmma's accumulator fragment), so an
//     epilogue reads its residual pair (4 bytes of bf16, 8 of f32) where it
//     needs it. All of a tile's loads (bias, scales, residual) are issued
//     before its first store, so they overlap one another instead of each
//     waiting behind a store it might alias. The outputs leave through
//     shared memory: each warp stages one 128-byte line of each of its 16
//     rows at a time and writes it back as full lines, 16 bytes a thread
//     (the fragment's own pairs would be 8 rows x 16 bytes a store, a
//     quarter of each line).
//
// Shared memory per stage: (128 + BN) x 128 bytes; with the staging buffers
// (36-40 KB) STAGES = 4 at BN = 192 (160 KB) and 224 (176 KB), 3 at 256
// (144 KB). One block of 384 threads
// per SM: the producer warpgroup drops to 40 registers, the consumers rise
// to 232 (accumulators: BN / 2 registers a thread).
//
// Requirements (checked by the callers): K * sizeof(T) % 16 == 0 (TMA's
// global stride), operands 16-byte aligned, any M and N.

#pragma once

#include <cuda.h>

#include "mma_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int GEMM_BM = 128;             // two consumer warpgroups of 64 rows
constexpr int GEMM_THREADS = 384;        // consumers: warpgroups 0, 1; producer: 2
constexpr int GEMM_SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int GEMM_PRODUCER_REGS = 40, GEMM_CONSUMER_REGS = 232;

template <typename T>
struct GemmType;
template <>
struct GemmType<bf16> {
    using Acc = float;
    static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct GemmType<int8_t> {
    using Acc = int;
    static constexpr CUtensorMapDataType tma = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// An f32 epilogue result kept in an accumulator slot of either type.
__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(int v) { return __int_as_float(v); }
__device__ __forceinline__ void set_float(float& slot, float v) { slot = v; }
__device__ __forceinline__ void set_float(int& slot, float v) { slot = __float_as_int(v); }

// Shared memory of a block: the ring of STAGES stages (A's 128 rows and W's
// BN rows of one 128-byte K-block each), then each consumer warp's two
// staging buffers of 16 output rows x one 128-byte line (padded so that
// neither the fragment-layout writes nor the row reads conflict on banks),
// then the 2 * STAGES barriers, and room to align the base to an atom.
template <int BN, int OUT_BYTES>
struct GemmShape {
    static constexpr int A_BYTES = GEMM_BM * SW128_ROW, STAGE = (GEMM_BM + BN) * SW128_ROW;
    static constexpr int PITCH = 128 + 8 * OUT_BYTES, BUF = 16 * PITCH;
    static constexpr int STAGING = 8 * 2 * BUF;
    static constexpr int FIT = (GEMM_SMEM_LIMIT - SW128_ATOM - 80 - STAGING) / STAGE;
    static constexpr int STAGES = FIT < 5 ? FIT : 5;
    static constexpr int SMEM = STAGES * STAGE + STAGING + 2 * STAGES * 8 + SW128_ATOM;
    static_assert(STAGES >= 2 && SMEM <= GEMM_SMEM_LIMIT, "tile too wide for the ring");
};

// Epi: a copyable struct with
//   OUT_BYTES                                       bytes of an output value
//   Row row(int gm) const                           per-row values (mask, scale)
//   void apply(const Row&, int gm, int gn, Acc& v0, Acc& v1) const
//   void stage(void* dst, Acc v0, Acc v1) const     the pair's output bytes
//   void store16(int gm, int gn, uint4 v) const     16 bytes of row gm from gn
// apply is called for columns gn, gn + 1 of row gm, for every gm < M and
// gn < N; it reads what the epilogue needs and leaves its results in v0,
// v1 (as_float / set_float carry an f32 result in an s32 slot). stage
// writes the pair's output values to shared memory, store16 sends 16
// staged bytes (16 / OUT_BYTES columns, gn < N) to row gm of the output.
template <typename T, int BN, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw, int M,
          int N, int kblocks, const Epi epi) {
    using Acc = typename GemmType<T>::Acc;
    using S = GemmShape<BN, Epi::OUT_BYTES>;
    extern __shared__ unsigned char gemm_smem_raw[];
    // the swizzle repeats every 1024 bytes of the shared window: align to it
    unsigned char* smem =
        gemm_smem_raw + ((SW128_ATOM - (shared_u32(gemm_smem_raw) & (SW128_ATOM - 1))) &
                         (SW128_ATOM - 1));
    unsigned char* staging = smem + S::STAGES * S::STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(staging + S::STAGING);
    uint64_t* empty = full + S::STAGES;
    const int tid = threadIdx.x, wg = tid >> 7;
    if (tid == 0) {
        for (int s = 0; s < S::STAGES; ++s) {
            mbar_init(&full[s], 1);   // the producer's arrival + the TMA bytes
            mbar_init(&empty[s], 8);  // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int ntiles = (N + BN - 1) / BN, tiles = (M + GEMM_BM - 1) / GEMM_BM * ntiles;
    constexpr int KSTEP = SW128_ROW / sizeof(T);  // elements of K per stage

    if (wg == 2) {
        // --- producer: one thread keeps the ring full ---------------------------
        regs_release<GEMM_PRODUCER_REGS>();
        if (tid == 256) {
            tma_prefetch_desc(&ta);
            tma_prefetch_desc(&tw);
            int stage = 0;
            unsigned phase = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int m0 = tile / ntiles * GEMM_BM, n0 = tile % ntiles * BN;
                for (int kb = 0; kb < kblocks; ++kb) {
                    mbar_wait(&empty[stage], phase ^ 1);  // passes at once on the first lap
                    unsigned char* st = smem + stage * S::STAGE;
                    mbar_arrive_tx(&full[stage], S::STAGE);
                    tma_load_2d(st, &ta, &full[stage], kb * KSTEP, m0);
                    tma_load_2d(st + S::A_BYTES, &tw, &full[stage], kb * KSTEP, n0);
                    if (++stage == S::STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // --- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ------
        regs_claim<GEMM_CONSUMER_REGS>();
        const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
        Acc d[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) d[i] = Acc(0);
        int stage = 0;
        unsigned phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = tile / ntiles * GEMM_BM, n0 = tile % ntiles * BN;
            int held = 0;
            for (int kb = 0; kb < kblocks; ++kb) {
                mbar_wait(&full[stage], phase);
                const unsigned char* st = smem + stage * S::STAGE;
                const uint64_t da = desc_sw128(st + wg * 64 * SW128_ROW);
                const uint64_t dw = desc_sw128(st + S::A_BYTES);
                fence_regs(d);
                wg_fence();
#pragma unroll
                for (int k = 0; k < int(SW128_ROW / SW128_KSTEP); ++k)
                    wgmma_sw(d, da + k * (SW128_KSTEP >> 4), dw + k * (SW128_KSTEP >> 4),
                             (kb | k) != 0);
                wg_commit();
                wg_wait<1>();  // the previous K-block's group has read its stage
                if (kb > 0 && lane == 0) mbar_arrive(&empty[held]);
                held = stage;
                if (++stage == S::STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            wg_wait<0>();
            fence_regs(d);
            if (lane == 0) mbar_arrive(&empty[held]);

            // the epilogue: first every load and all arithmetic of this
            // thread's pairs (results kept in d), so that the loads overlap;
            // then the outputs go out through the warp's staging buffers,
            // one 128-byte line of each of the warp's 16 rows per pass, as
            // full-line 16-byte stores
            typename Epi::Row rows[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gm = m0 + wg * 64 + warp * 16 + g + h * 8;
                if (gm < M) {
                    rows[h] = epi.row(gm);
#pragma unroll
                    for (int j = 0; j < BN / 8; ++j) {
                        const int gn = n0 + j * 8 + t * 2;
                        if (gn < N) epi.apply(rows[h], gm, gn, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
                    }
                }
            }
            constexpr int OB = Epi::OUT_BYTES, PASS_COLS = 128 / OB;
            unsigned char* mine = staging + (wg * 4 + warp) * 2 * S::BUF;
            const int row0 = m0 + wg * 64 + warp * 16;
            __syncwarp();  // the previous tile's reads of the buffers are done
#pragma unroll
            for (int ps = 0; ps < (BN + PASS_COLS - 1) / PASS_COLS; ++ps) {
                unsigned char* buf = mine + (ps & 1) * S::BUF;
#pragma unroll
                for (int jj = 0; jj < PASS_COLS / 8; ++jj) {
                    const int j = ps * (PASS_COLS / 8) + jj;
                    if (j < BN / 8) {
#pragma unroll
                        for (int h = 0; h < 2; ++h)
                            epi.stage(buf + (g + 8 * h) * S::PITCH + (jj * 8 + t * 2) * OB,
                                      d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
                    }
                }
                __syncwarp();
                // a pass that runs past BN (224 bf16 columns: 3.5 lines) is
                // cut to the tile's last columns
                const int left = BN - ps * PASS_COLS;  // constant once unrolled
                const int chunks = (left < PASS_COLS ? left : PASS_COLS) * OB / 16;
#pragma unroll
                for (int c = lane; c < 16 * chunks; c += 32) {
                    const int r = c / chunks, ch = c % chunks;
                    const int gm = row0 + r, gn = n0 + ps * PASS_COLS + ch * (16 / OB);
                    if (gm < M && gn < N)
                        epi.store16(gm, gn, *reinterpret_cast<const uint4*>(buf + r * S::PITCH + ch * 16));
                }
                // the next pass writes the other buffer; the one after it
                // follows the next __syncwarp, past every lane's reads here
            }
        }
    }
}

// --- host side ---------------------------------------------------------------

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*,
                                          const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle,
                                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime's entry
// point query (no -lcuda at link time); null where libcuda lacks it.
inline TensorMapEncodeTiled tensor_map_encoder() {
    static const TensorMapEncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<TensorMapEncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// The TMA descriptor of a row-major (rows, k) operand read in boxes of
// (box_rows, one 128-byte K-block), 128B-swizzled, zeros out of bounds.
template <typename T>
cudaError_t encode_kmajor(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
    const TensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (k * sizeof(T)) % 16 != 0)
        return cudaErrorInvalidValue;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(T)};
    const cuuint32_t box[2] = {SW128_ROW / sizeof(T), static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t step[2] = {1, 1};
    const CUresult r = encode(map, GemmType<T>::tma, 2, const_cast<void*>(base), dims, strides,
                              box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 132;
    return n;
}

// C = a (m, k) . w (n, k)^T through ``epi`` on ``stream``: two descriptors
// encoded, one persistent launch of min(tiles, SMs) blocks.
template <typename T, int BN, class Epi>
cudaError_t launch_gemm_sm90(const void* a, const void* w, int m, int n, int k, const Epi& epi,
                             cudaStream_t stream) {
    using S = GemmShape<BN, Epi::OUT_BYTES>;
    if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
    CUtensorMap ta, tw;
    cudaError_t err = encode_kmajor<T>(&ta, a, m, k, GEMM_BM);
    if (err == cudaSuccess) err = encode_kmajor<T>(&tw, w, n, k, BN);
    if (err != cudaSuccess) return err;
    auto kernel = gemm_sm90<T, BN, Epi>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return err;
    const int tiles = (m + GEMM_BM - 1) / GEMM_BM * ((n + BN - 1) / BN);
    const int kblocks = static_cast<int>((static_cast<size_t>(k) * sizeof(T) + SW128_ROW - 1) /
                                         SW128_ROW);
    const int grid = tiles < sm_count() ? tiles : sm_count();
    kernel<<<grid, GEMM_THREADS, S::SMEM, stream>>>(ta, tw, m, n, kblocks, epi);
    return cudaGetLastError();
}

}  // namespace
