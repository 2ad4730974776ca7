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
//   - The cluster form (template parameter CN > 1, N == CN * BN): a
//     thread-block cluster of CN blocks on neighbouring SMs holds whole
//     rows, so an epilogue can run a row pass that needs the whole row
//     (LayerNorm, a token gate, a row quantiser: csrc/vit_block.cu's
//     RowEpilogue) without another trip through device memory. The
//     persistent grid is clusters: each walks 128-row blocks, block r of a
//     cluster takes N-tile r. Block 0 loads each K-block of A once and
//     multicasts it (TMA .multicast::cluster) to all CN blocks, so A's
//     reads from L2 drop by CN; each block loads its own W tile. A row's
//     statistics cross the blocks through distributed shared memory: each
//     consumer warp writes its rows' partial sums into the exchange
//     buffer of the warp that holds the same rows in every block of the
//     cluster with st.async, whose bytes complete on that warp's mbarrier
//     (no fence: a release at cluster scope would wait for the tile's
//     global stores), and adds the CN partials in rank order, so every
//     block holds the same totals. The grid is min(row blocks,
//     cudaOccupancyMaxActiveClusters): the card places a cluster inside
//     one GPC. Waves at DeiT-S bs128 (197 row blocks): the card fits 66
//     clusters of 2 for proj and fc2 (2.98 waves; B2's L = 98 segments: 98
//     row blocks, 1.48), but only 15 of 8 (and 15 of 7) for the s8 fc1:
//     13.1 waves on 120 SMs against 11.94 on 132 for the product alone
//     (17 of 6 at BN = 256, slower still: vit_block_rows.cu).
//   - No wait can hang the card: every mbarrier wait traps after 4 s, and
//     the one cluster barrier (after the barriers' initialisation, before
//     any block touches another's) is reached by every thread at once. A
//     block leaves only when nothing of the cluster can still reach its
//     shared memory: each block waits for every exchange it receives, and
//     block 0's producer, whose empty barriers the other blocks' consumers
//     arrive on, waits for the last release of every stage before it ends.
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
// then the row-exchange buffers of a cluster epilogue (XBYTES, 0 without
// one), then the 2 * STAGES + 16 barriers, and room to align the base to
// an atom.
// A staged row: 128 bytes and a pad of 8 bytes a value (16 for s8 codes:
// the rows are read back 16 bytes at a time, so the pitch is a multiple of
// 16).
__host__ __device__ constexpr int gemm_pitch(int out_bytes) {
    return 128 + (out_bytes < 2 ? 16 : 8 * out_bytes);
}

template <int BN, int OUT_BYTES, int XBYTES = 0>
struct GemmShape {
    static constexpr int A_BYTES = GEMM_BM * SW128_ROW, STAGE = (GEMM_BM + BN) * SW128_ROW;
    static constexpr int PITCH = gemm_pitch(OUT_BYTES), BUF = 16 * PITCH;
    static constexpr int STAGING = 8 * 2 * BUF;
    static constexpr int FIT = (GEMM_SMEM_LIMIT - SW128_ATOM - 208 - STAGING - XBYTES) / STAGE;
    static constexpr int STAGES = FIT < 5 ? FIT : 5;
    static constexpr int SMEM = STAGES * STAGE + STAGING + XBYTES + (2 * STAGES + 16) * 8 + SW128_ATOM;
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
// OUT_BYTES = 0: no output at this point.
//
// A row epilogue (ROUNDS > 0 or OUT2_BYTES > 0) goes on, after the first
// output is stored, with statistics of whole rows and a second output:
//   ROUNDS, NSTAT                                   rounds, values a round
//   bool is_max(int round)                          max (else sum) round
//   void stat(int round, const Row&, int gn, Acc v0, Acc v1, float (&part)[NSTAT])
//   void fold(int round, Row&, const float (&total)[NSTAT])
//   bool transforms(int round), transform(const Row&, int gn, Acc&, Acc&)
//                                                   rewrite the pairs after
//                                                   that round's fold
//   OUT2_BYTES, stage2(void*, const Row&, int gn, Acc, Acc), store2_16(gm, gn, uint4)
//   void row_done(const Row&, int gm)               once per row, rank 0
// Round r: stat adds a pair's terms to the thread's partials (or takes
// their max), the four lanes of a quad combine theirs, then the CN blocks
// of the cluster exchange theirs through distributed shared memory, and
// every block combines the CN partials in rank order, so all of them hold
// the same totals; fold turns them into row state (a mean, a scale). A
// row's BN columns of a block all sit in one warp (wgmma's fragment), so
// no exchange between the warps of a block is needed. N must be CN * BN.
template <class Epi, class = void>
struct RowPass {
    static constexpr int ROUNDS = 0, NSTAT = 1, OUT2_BYTES = 0;
};
template <class Epi>
struct RowPass<Epi, decltype(void(Epi::ROUNDS))> {
    static constexpr int ROUNDS = Epi::ROUNDS, NSTAT = Epi::NSTAT, OUT2_BYTES = Epi::OUT2_BYTES;
};

template <int A, int B>
__host__ __device__ constexpr int cmax() { return A > B ? A : B; }

// The exchange buffers of a cluster of CN: two slots (a round's and the
// next's) of CN senders x 128 rows x NSTAT f32.
template <class Epi, int CN>
__host__ __device__ constexpr int xbytes() {
    return RowPass<Epi>::ROUNDS > 0 && CN > 1 ? 2 * CN * GEMM_BM * RowPass<Epi>::NSTAT * 4 : 0;
}

// One of a warp's outputs (WHICH 1: stage / store16, 2: stage2 /
// store2_16) through its two staging buffers: one 128-byte line of each
// of the warp's 16 rows per pass, written back as full-line 16-byte
// stores.
template <int WHICH, int BN, int OB, int PITCH, int BUF, class Epi, typename Acc, class Row>
__device__ __forceinline__ void store_rows(const Epi& epi, const Acc (&d)[BN / 2],
                                           const Row (&rows)[2], unsigned char* mine, int g,
                                           int t, int lane, int row0, int n0, int M, int N) {
    constexpr int PASS_COLS = 128 / OB;
    __syncwarp();  // the previous output's reads of the buffers are done
#pragma unroll
    for (int ps = 0; ps < (BN + PASS_COLS - 1) / PASS_COLS; ++ps) {
        unsigned char* buf = mine + (ps & 1) * BUF;
#pragma unroll
        for (int jj = 0; jj < PASS_COLS / 8; ++jj) {
            const int j = ps * (PASS_COLS / 8) + jj;
            if (j < BN / 8) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    void* dst = buf + (g + 8 * h) * PITCH + (jj * 8 + t * 2) * OB;
                    if constexpr (WHICH == 1)
                        epi.stage(dst, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
                    else
                        epi.stage2(dst, rows[h], n0 + j * 8 + t * 2, d[4 * j + 2 * h],
                                   d[4 * j + 2 * h + 1]);
                }
            }
        }
        __syncwarp();
        // a pass that runs past BN (224 bf16 columns: 3.5 lines) is cut to
        // the tile's last columns
        const int left = BN - ps * PASS_COLS;  // constant once unrolled
        const int chunks = (left < PASS_COLS ? left : PASS_COLS) * OB / 16;
#pragma unroll
        for (int c = lane; c < 16 * chunks; c += 32) {
            const int r = c / chunks, ch = c % chunks;
            const int gm = row0 + r, gn = n0 + ps * PASS_COLS + ch * (16 / OB);
            if (gm < M && gn < N) {
                const uint4 v = *reinterpret_cast<const uint4*>(buf + r * PITCH + ch * 16);
                if constexpr (WHICH == 1) epi.store16(gm, gn, v);
                else epi.store2_16(gm, gn, v);
            }
        }
        // the next pass writes the other buffer; the one after it follows
        // the next __syncwarp, past every lane's reads here
    }
}

// CN = 1: persistent blocks walk the 128 x BN tiles. CN > 1 (a cluster of
// CN blocks along N, N == CN * BN): each cluster walks 128-row blocks, and
// its block of rank r takes the block's N-tile r, so a cluster holds whole
// rows. Block 0 of the cluster loads each K-block of A once and multicasts
// it to all CN (A's reads from L2 drop by CN); every block loads its own W
// tile. A stage of block 0 is refilled only when the consumers of every
// block of the cluster have released it: block 0's empty barriers count
// the arrivals of all 8 * CN consumer warps, the others' their own 8.
template <typename T, int BN, int CN, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw, int M,
          int N, int kblocks, const Epi epi) {
    using Acc = typename GemmType<T>::Acc;
    using RP = RowPass<Epi>;
    constexpr int OB1 = Epi::OUT_BYTES, OB2 = RP::OUT2_BYTES, NS = RP::NSTAT;
    constexpr int XBYTES = xbytes<Epi, CN>();
    using S = GemmShape<BN, cmax<OB1, OB2>(), XBYTES>;
    extern __shared__ unsigned char gemm_smem_raw[];
    // the swizzle repeats every 1024 bytes of the shared window: align to it
    unsigned char* smem =
        gemm_smem_raw + ((SW128_ATOM - (shared_u32(gemm_smem_raw) & (SW128_ATOM - 1))) &
                         (SW128_ATOM - 1));
    unsigned char* staging = smem + S::STAGES * S::STAGE;
    float* xbuf = reinterpret_cast<float*>(staging + S::STAGING);
    uint64_t* full = reinterpret_cast<uint64_t*>(staging + S::STAGING + XBYTES);
    uint64_t* empty = full + S::STAGES;
    uint64_t* xbar = empty + S::STAGES;  // 8 consumer warps x 2 slots
    const int tid = threadIdx.x, wg = tid >> 7;
    const int rank = CN > 1 ? static_cast<int>(cluster_rank()) : 0;
    if (tid == 0) {
        for (int s = 0; s < S::STAGES; ++s) {
            mbar_init(&full[s], 1);  // the producer's arrival + the TMA bytes
            // one arrival per consumer warp (of the whole cluster at block 0)
            mbar_init(&empty[s], rank == 0 ? 8 * CN : 8);
        }
        // the row exchange, two slots for each consumer warp: the warp's
        // own arrival with the bytes it expects from the cluster
        for (int s = 0; s < 16; ++s) mbar_init(&xbar[s], 1);
        mbar_init_fence();
    }
    if constexpr (CN > 1) cluster_sync();  // no block touches another's barriers before
    else __syncthreads();
    const int ntiles = (N + BN - 1) / BN, mtiles = (M + GEMM_BM - 1) / GEMM_BM;
    const int units = CN > 1 ? mtiles : mtiles * ntiles;
    const int first = CN > 1 ? static_cast<int>(cluster_index()) : blockIdx.x;
    const int step = CN > 1 ? static_cast<int>(cluster_count()) : gridDim.x;
    constexpr int KSTEP = SW128_ROW / sizeof(T);  // elements of K per stage

    if (wg == 2) {
        // --- producer: one thread keeps the ring full ---------------------------
        regs_release<GEMM_PRODUCER_REGS>();
        if (tid == 256) {
            tma_prefetch_desc(&ta);
            tma_prefetch_desc(&tw);
            int stage = 0;
            unsigned phase = 0;
            for (int u = first; u < units; u += step) {
                const int m0 = (CN > 1 ? u : u / ntiles) * GEMM_BM;
                const int n0 = (CN > 1 ? rank : u % ntiles) * BN;
                for (int kb = 0; kb < kblocks; ++kb) {
                    mbar_wait(&empty[stage], phase ^ 1);  // passes at once on the first lap
                    unsigned char* st = smem + stage * S::STAGE;
                    mbar_arrive_tx(&full[stage], S::STAGE);
                    if constexpr (CN > 1) {
                        if (rank == 0)
                            tma_load_2d_multicast(st, &ta, &full[stage], kb * KSTEP, m0,
                                                  static_cast<uint16_t>((1u << CN) - 1));
                    } else {
                        tma_load_2d(st, &ta, &full[stage], kb * KSTEP, m0);
                    }
                    tma_load_2d(st + S::A_BYTES, &tw, &full[stage], kb * KSTEP, n0);
                    if (++stage == S::STAGES) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
            if constexpr (CN > 1) {
                // block 0 stays until every consumer of the cluster has
                // released every stage: their arrivals land in its shared
                // memory, which must outlive them
                if (rank == 0) {
                    for (int s = 0; s < S::STAGES; ++s) {
                        mbar_wait(&empty[stage], phase ^ 1);
                        if (++stage == S::STAGES) {
                            stage = 0;
                            phase ^= 1;
                        }
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
        int stage = 0, xk = 0;
        unsigned phase = 0;
        // releases a stage: to this block's barrier and, in a cluster, to
        // block 0's, whose producer multicasts A into every block's stage
        auto release = [&](int s) {
            if (lane == 0) {
                mbar_arrive(&empty[s]);
                if constexpr (CN > 1) {
                    if (rank != 0) mbar_arrive_cluster(cluster_addr(&empty[s], 0));
                }
            }
        };
        for (int u = first; u < units; u += step) {
            const int m0 = (CN > 1 ? u : u / ntiles) * GEMM_BM;
            const int n0 = (CN > 1 ? rank : u % ntiles) * BN;
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
                if (kb > 0) release(held);
                held = stage;
                if (++stage == S::STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            wg_wait<0>();
            fence_regs(d);
            release(held);

            // the epilogue: first every load and all arithmetic of this
            // thread's pairs (results kept in d), so that the loads overlap;
            // then the outputs go out through the warp's staging buffers
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
            unsigned char* mine = staging + (wg * 4 + warp) * 2 * S::BUF;
            const int row0 = m0 + wg * 64 + warp * 16;
            if constexpr (OB1 > 0)
                store_rows<1, BN, OB1, gemm_pitch(OB1), S::BUF>(epi, d, rows, mine, g, t, lane,
                                                              row0, n0, M, N);
            if constexpr (RP::ROUNDS > 0) {
#pragma unroll
                for (int r = 0; r < RP::ROUNDS; ++r) {
                    const bool mx = Epi::is_max(r);
                    float part[2][NS], total[2][NS];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int s = 0; s < NS; ++s) part[h][s] = 0.f;
                        if (row0 + g + 8 * h < M) {
#pragma unroll
                            for (int j = 0; j < BN / 8; ++j)
                                epi.stat(r, rows[h], n0 + j * 8 + t * 2, d[4 * j + 2 * h],
                                         d[4 * j + 2 * h + 1], part[h]);
                        }
#pragma unroll
                        for (int s = 0; s < NS; ++s) {
#pragma unroll
                            for (int o = 1; o <= 2; o <<= 1) {
                                const float v = __shfl_xor_sync(0xffffffffu, part[h][s], o);
                                part[h][s] = mx ? fmaxf(part[h][s], v) : part[h][s] + v;
                            }
                        }
                    }
                    if constexpr (CN == 1) {
#pragma unroll
                        for (int h = 0; h < 2; ++h)
#pragma unroll
                            for (int s = 0; s < NS; ++s) total[h][s] = part[h][s];
                    } else {
                        // slot xk & 1 of this warp's rows in every block of
                        // the cluster gets this block's partials of the
                        // quad's two rows, each store completing on that
                        // warp's barrier there (st.async): the warps of a
                        // block exchange independently, each with the
                        // warps of the same rows in the other blocks, and
                        // a warp's barrier completes when it has arrived
                        // (expecting the bytes of all CN blocks) and the
                        // bytes have landed. A slot is written again two
                        // rounds later, only after each of those warps
                        // has sent the round between, which it does after
                        // reading this one (past the warp-wide shuffles
                        // of that round).
                        const int slot = xk & 1;
                        const unsigned parity = (xk >> 1) & 1;
                        ++xk;
                        float* xs = xbuf + slot * CN * GEMM_BM * NS;
                        uint64_t* bar = &xbar[(wg * 4 + warp) * 2 + slot];
                        const int lr = wg * 64 + warp * 16 + g;  // the quad's first row
                        if (lane == 0) mbar_arrive_tx(bar, CN * 16 * NS * 4);
                        if (t == 0) {
#pragma unroll
                            for (int c = 0; c < CN; ++c) {
                                const uint32_t rbar = cluster_addr(bar, c);
#pragma unroll
                                for (int h = 0; h < 2; ++h)
#pragma unroll
                                    for (int s = 0; s < NS; ++s)
                                        st_async_cluster(
                                            cluster_addr(xs + (rank * GEMM_BM + lr + 8 * h) * NS + s, c),
                                            part[h][s], rbar);
                            }
                        }
                        mbar_wait(bar, parity);
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
#pragma unroll
                            for (int s = 0; s < NS; ++s) {
                                float v = xs[(lr + 8 * h) * NS + s];
#pragma unroll
                                for (int c = 1; c < CN; ++c) {
                                    const float w = xs[(c * GEMM_BM + lr + 8 * h) * NS + s];
                                    v = mx ? fmaxf(v, w) : v + w;
                                }
                                total[h][s] = v;
                            }
                        }
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) epi.fold(r, rows[h], total[h]);
                    if (Epi::transforms(r)) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            if (row0 + g + 8 * h < M) {
#pragma unroll
                                for (int j = 0; j < BN / 8; ++j)
                                    epi.transform(rows[h], n0 + j * 8 + t * 2, d[4 * j + 2 * h],
                                                  d[4 * j + 2 * h + 1]);
                            }
                        }
                    }
                }
            }
            if constexpr (OB2 > 0) {
                store_rows<2, BN, OB2, gemm_pitch(OB2), S::BUF>(epi, d, rows, mine, g, t, lane,
                                                              row0, n0, M, N);
                if (rank == 0 && t == 0) {
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        if (row0 + g + 8 * h < M) epi.row_done(rows[h], row0 + g + 8 * h);
                }
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

template <typename T, int BN, class Epi, int CN>
using GemmShapeOf = GemmShape<BN, cmax<Epi::OUT_BYTES, RowPass<Epi>::OUT2_BYTES>(), xbytes<Epi, CN>()>;

// A launch of gemm_sm90<T, BN, CN, Epi> in clusters of CN along x.
template <int CN>
struct ClusterLaunch {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    ClusterLaunch(int blocks, int smem, cudaStream_t stream) : cfg{} {
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = CN;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(blocks);
        cfg.blockDim = dim3(GEMM_THREADS);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
};

// The clusters of CN blocks of gemm_sm90<T, BN, CN, Epi> that fit on the
// card at once (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
// The card places a cluster within one GPC, so this can be below SMs / CN.
template <typename T, int BN, int CN, class Epi>
int gemm_clusters_that_fit() {
    using S = GemmShapeOf<T, BN, Epi, CN>;
    auto kernel = gemm_sm90<T, BN, CN, Epi>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return -static_cast<int>(err);
    ClusterLaunch<CN> launch(CN * (sm_count() / CN), S::SMEM, nullptr);
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &launch.cfg);
    return err == cudaSuccess ? fit : -static_cast<int>(err);
}

// C = a (m, k) . w (n, k)^T through ``epi`` on ``stream``: two descriptors
// encoded, one persistent launch of min(tiles, SMs) blocks; with CN > 1
// (n must be CN * BN), of min(row blocks, gemm_clusters_that_fit) clusters.
template <typename T, int BN, int CN = 1, class Epi>
cudaError_t launch_gemm_sm90(const void* a, const void* w, int m, int n, int k, const Epi& epi,
                             cudaStream_t stream) {
    static_assert(CN >= 1 && CN <= 8, "a portable cluster holds at most 8 blocks");
    using S = GemmShapeOf<T, BN, Epi, CN>;
    if (m <= 0 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
    if ((CN > 1 || RowPass<Epi>::ROUNDS > 0) && n != CN * BN) return cudaErrorInvalidValue;
    CUtensorMap ta, tw;
    cudaError_t err = encode_kmajor<T>(&ta, a, m, k, GEMM_BM);
    if (err == cudaSuccess) err = encode_kmajor<T>(&tw, w, n, k, BN);
    if (err != cudaSuccess) return err;
    auto kernel = gemm_sm90<T, BN, CN, Epi>;
    const int mtiles = (m + GEMM_BM - 1) / GEMM_BM;
    const int kblocks = static_cast<int>((static_cast<size_t>(k) * sizeof(T) + SW128_ROW - 1) /
                                         SW128_ROW);
    if constexpr (CN == 1) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
        if (err != cudaSuccess) return err;
        const int tiles = mtiles * ((n + BN - 1) / BN);
        const int grid = tiles < sm_count() ? tiles : sm_count();
        kernel<<<grid, GEMM_THREADS, S::SMEM, stream>>>(ta, tw, m, n, kblocks, epi);
    } else {
        static int fit = 0;  // once per instantiation: the query costs host time
        if (fit <= 0) {
            fit = gemm_clusters_that_fit<T, BN, CN, Epi>();
            if (fit < 0) return static_cast<cudaError_t>(-fit);
            if (fit == 0) return cudaErrorInvalidConfiguration;
        }
        ClusterLaunch<CN> launch(CN * (mtiles < fit ? mtiles : fit), S::SMEM, stream);
        err = cudaLaunchKernelEx(&launch.cfg, kernel, ta, tw, m, n, kblocks, epi);
        if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
}

}  // namespace
