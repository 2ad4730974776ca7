// Masked multi-head attention over a packed (B, L, 3D) qkv projection for
// Hopper (sm_90a), heads of 64, any L, with an optional (B, H) head gate:
// the forward (B4a/B4) and the backward (B5), bf16 on the tensor cores
// (wgmma) and f32 on the CUDA cores (FFMA).
//
// Replaces the TPU kernels
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_fwd        (B4a)
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_fwd_strips (B4)
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_bwd_strips (B5)
// The TPU kernels take a head pair per grid step so that a strip is 128
// lanes wide, mask each half of the pair and pad a zero head for odd head
// counts, and hold a whole (L, L) score tile in VMEM. None of that carries
// over: a block here takes 64 or 128 query (or key) rows of one (image,
// head) and streams the other side in tiles of 64.
//
// What bounds it on the H100: bytes. At DeiT-S bs128 (L = 197) the forward
// reads qkv (58 MB) and writes the output (19 MB) against 7.6 GFLOP, the
// backward reads qkv and dO and writes dqkv (135 MB) against ~25 GFLOP:
// both far below the bf16 ridge (~295 FLOP a byte). So scores never leave
// the SM, and each block reads its own rows once and streams the other
// side's tiles of 64 rows from L2 (the blocks of one head are neighbours in
// launch order and read the same K and V). Each step waits on little: the
// next tile's cp.async (and that of its per-row values: key mask, row
// statistics) is in flight while the current one is multiplied, a
// three-stage ring needs one barrier a step, and the blocks are small
// enough for several to share an SM (forward: two warpgroups of 64 query
// rows sharing each key and value tile, two blocks an SM; backward: one
// warpgroup, three). The exponentials are the fast ex2 form and the
// softmax divides by the row sum through its reciprocal: both move p by an
// f32 ulp or two, far below its bf16 rounding. The second Q.K^T of the
// exact softmax is nearly free for a kernel bound by bytes.
//
// Forward, per query tile: sweep 1 over the key tiles keeps the running
// row max m and row sum l = sum exp(s - m) (s = q.k * scale, -1e9 added at
// masked keys, -inf past L); sweep 2 recomputes s and accumulates O += P.V
// with, exactly, p = bf16(exp(s - m) / l) (the rounding points of the JAX
// strip kernel: p rounded, the gate multiplying the f32 output, one
// rounding of the output) or, deferred (the block engine's fast_math at
// L > 256), p = bf16(exp(s - m)) and O / l after P.V. When autograd needs
// them the forward also writes m and l, f32 (B, H, 2, L): the JAX kernel
// saves only qkv and recomputes; this residual (0.8 MB at DeiT-S bs128) is
// the port's own choice, so that the backward never recomputes S only to
// find the statistics.
//
// Backward, with P = exp(s - m) / l from those statistics:
//   dO_eff = bf16(dO * gate)            (dO without a gate)
//   delta  = rowsum(dP o P),  dP = dO_eff . V^T      (f32, P unrounded)
//   dS     = P o (dP - delta)
//   dQ = bf16(dS) . K * scale,  dK = bf16(dS)^T . Q * scale,
//   dV = bf16(P)^T . dO_eff,    dgate = sum (bf16(P) . V) o dO (ungated dO)
// in two kernels, with no float atomics, deterministic: (a) per query tile,
// sweep 1 over the key tiles for delta (and, gated, bf16(P).V for this
// tile's share of dgate), sweep 2 for dS and dQ; (b) per key tile, one
// sweep over the query tiles, computing the scores transposed (S^T = K.Q^T,
// dP^T = V.dO^T) so that P^T and dS^T are accumulator registers and go to
// the tensor cores as the A operand of dV += bf16(P^T).dO_eff and
// dK += bf16(dS^T).Q without a transpose. Kernel (b)'s blocks of key tile
// 0 sum kernel (a)'s dgate shares in a fixed order.
//
// bf16 products: each warpgroup owns 64 rows and runs wgmma m64n64k16
// (wgmma.cuh): S = Q.K^T and dP = dO.V^T with both operands in shared
// memory, P.V, dS.K, P^T.dO and dS^T.Q with the A operand in registers and
// B read transposed from the same row-major tiles (so no product needs a
// transposed register operand and none stays on mma.sync). Tiles sit in
// shared memory in the core-matrix layout, filled by cp.async.
// f32 products: the same grid, sweeps and statistics on FFMA, each thread
// a 4 x 8 block of a 64 x 64 product, full f32 sums (no TF32).
//
// Keys past L carry -inf (p = 0); query rows past L are zero in Q and dO,
// their p is 0 in kernel (b) (1 / l = 0 there), and nothing past L is
// stored.

#include "mma_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int DH = 64, TILE = 64, WG = 128;
constexpr int TILE_ELEMS = TILE * DH;
// Three stages: the tile a step refills was read two steps before, and
// every thread has passed the barrier that ends that read, so no barrier
// closes a step.
constexpr int STAGES = 3;

__host__ __device__ __forceinline__ int ntiles(int l) { return (l + TILE - 1) / TILE; }

// bf16x2 * gate, rounded once
__device__ __forceinline__ unsigned scale_bf16x2(unsigned raw, float gate) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    return pack_bf16(v.x * gate, v.y * gate);
}

// Rows [r0, r0 + 64) of one head's 64 columns into a core-matrix tile
// (``src``: row 0, column 0 of the head; ``stride``: elements between
// rows); rows at or past ``nrows`` are zero-filled. Thread ``tid`` of NT
// copies the chunks tid, tid + NT, ...
template <int NT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int stride, int r0,
                                          int nrows, int tid) {
#pragma unroll
    for (int k = 0; k < TILE_ELEMS / 8 / NT; ++k) {
        const int i = tid + k * NT;
        int r, c;
        core_chunk(i, r, c);
        const int row = r0 + r;
        const bool ok = row < nrows;
        cp_async16(reinterpret_cast<char*>(tile) + i * 16,
                   src + (size_t)(ok ? row : 0) * stride + c * 8, ok);
    }
}

// One f32 by cp.async (zero-filled when not ``valid``): the per-row values
// (key mask, row statistics) arrive with the tiles instead of stalling the
// warp that loads them.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem), "r"(valid ? 4 : 0));
}

// dO * gate rounded to bf16, in place, on the chunks this thread copied.
__device__ __forceinline__ void gate_own_chunks(bf16* tile, float gate, int tid) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        uint4* p = reinterpret_cast<uint4*>(reinterpret_cast<char*>(tile) + (tid + k * WG) * 16);
        uint4 v = *p;
        v.x = scale_bf16x2(v.x, gate);
        v.y = scale_bf16x2(v.y, gate);
        v.z = scale_bf16x2(v.z, gate);
        v.w = scale_bf16x2(v.w, gate);
        *p = v;
    }
}

__device__ __forceinline__ float key_neg(const float* km, int key, int L) {
    return key < L ? (1.f - km[key]) * NEG : -INFINITY;
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// (64 x 64) = A (64 x 64) . B^T (64 x 64) over dh = 64: four k16 steps,
// both operands K-major.
__device__ __forceinline__ void product_ss(float (&d)[32], const bf16* a, const bf16* b) {
    const uint64_t da = desc_kmajor(a), db = desc_kmajor(b);
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
        wgmma_ss(d, da + ks * (KMAJOR_STEP >> 4), db + ks * (KMAJOR_STEP >> 4), ks > 0);
}

// d += A . B: A (64 x 64) from the packed registers, B MN-major.
__device__ __forceinline__ void product_rs(float (&d)[32], const unsigned (&a)[4][4],
                                           const bf16* b) {
    const uint64_t db = desc_mnmajor(b);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a[kk], db + kk * (MNMAJOR_STEP >> 4), 1);
}

// The A-operand registers of a 64 x 64 accumulator, rounded to bf16.
__device__ __forceinline__ void pack_a(unsigned (&a)[4][4], const float (&d)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scores of this thread (columns 8j + 2t + (e & 1)) scaled, plus the
// additive key mask of their columns.
__device__ __forceinline__ void scale_mask(float (&s)[32], const float* ng, int tq,
                                           float sm_scale) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float2 n2 = *reinterpret_cast<const float2*>(ng + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) s[e] = s[e] * sm_scale + (e & 1 ? n2.y : n2.x);
    }
}

// ---------------------------------------------------------------------------
// Forward, bf16. Grid (tiles of 128 queries, H, B): two warpgroups, each
// 64 query rows, share the streamed key and value tiles.
// ---------------------------------------------------------------------------
constexpr int FWD_WGS = 2, FWD_THREADS = FWD_WGS * WG, FWD_ROWS = FWD_WGS * TILE;
constexpr size_t FWD_SMEM = (size_t)(FWD_WGS + 2 * STAGES) * TILE_ELEMS * sizeof(bf16) +
                            (size_t)STAGES * TILE * sizeof(float);

// One key tile of the forward: ``stats`` (sweep 1) folds its scores into
// the running row max m and per-thread row sum l; otherwise (sweep 2,
// ``inv`` = 1 / l) it adds P.V to o.
template <bool DEFERRED>
__device__ __forceinline__ void fwd_tile(bool stats, const bf16* Qw, const bf16* Kt,
                                         const bf16* Vt, const float* ng, int tq,
                                         float sm_scale, float (&m)[2], float (&l)[2],
                                         const float (&inv)[2], float (&o)[32]) {
    float s[32];
    zero(s);
    wg_fence();
    product_ss(s, Qw, Kt);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    scale_mask(s, ng, tq, sm_scale);
    if (stats) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], quad_max(mx[r]));
            l[r] *= __expf(m[r] - mn);
            m[r] = mn;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) l[(e >> 1) & 1] += __expf(s[e] - m[(e >> 1) & 1]);
    } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            const int r = (e >> 1) & 1;
            s[e] = DEFERRED ? __expf(s[e] - m[r]) : __expf(s[e] - m[r]) * inv[r];
        }
        unsigned a[4][4];
        pack_a(a, s);
        wg_fence();
        product_rs(o, a, Vt);
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
    }
}

template <bool DEFERRED>
__global__ void __launch_bounds__(FWD_THREADS, 2)
attn_fwd_bf16(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
              const float* __restrict__ head_gate, bf16* __restrict__ out,
              float* __restrict__ stats, int L, int H, float sm_scale) {
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + FWD_WGS * TILE_ELEMS;
    bf16* Vs = Ks + STAGES * TILE_ELEMS;
    float* negs = reinterpret_cast<float*>(Vs + STAGES * TILE_ELEMS);

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, wg = tid / WG, warp = (tid / 32) % 4, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const bf16* base = qkv + (size_t)b * L * row3 + h * DH;
    const float* km = key_mask + (size_t)b * L;
    const int nkt = ntiles(L), steps = 2 * nkt;
    const bf16* Qw = Qs + wg * TILE_ELEMS;

    // step t < nkt: key tile t for the statistics; t >= nkt: key and value
    // tile t - nkt for P.V
    auto issue = [&](int t) {
        const int j = t < nkt ? t : t - nkt, st = t % STAGES;
        load_tile<FWD_THREADS>(Ks + st * TILE_ELEMS, base + D, row3, j * TILE, L, tid);
        if (t >= nkt)
            load_tile<FWD_THREADS>(Vs + st * TILE_ELEMS, base + 2 * D, row3, j * TILE, L, tid);
        if (tid < TILE) {
            const int key = j * TILE + tid;
            cp_async4(negs + st * TILE + tid, km + (key < L ? key : 0), key < L);
        }
    };

    load_tile<WG>(Qs + wg * TILE_ELEMS, base, row3, qt * FWD_ROWS + wg * TILE, L, tid % WG);
    issue(0);
    cp_async_commit();

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
    float o[32];
    zero(o);
    for (int t = 0; t < steps; ++t) {
        if (t + 1 < steps) issue(t + 1);
        cp_async_commit();
        cp_async_wait<1>();  // step t's tiles are in; t + 1's are in flight
        const int st = t % STAGES, j = t < nkt ? t : t - nkt;
        if (tid < TILE) {  // this thread's key-mask value into the additive mask
            const int key = j * TILE + tid;
            float* v = negs + st * TILE + tid;
            *v = key < L ? (1.f - *v) * NEG : -INFINITY;
        }
        fence_proxy_async();
        __syncthreads();
        if (t == nkt) {  // the statistics are complete: the row sums
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] = quad_sum(l[r]);
                inv[r] = 1.f / l[r];
            }
        }
        const bf16 *Kt = Ks + st * TILE_ELEMS, *Vt = Vs + st * TILE_ELEMS;
        const float* ng = negs + st * TILE;
        fwd_tile<DEFERRED>(t < nkt, Qw, Kt, Vt, ng, tq, sm_scale, m, l, inv, o);
    }

    const float gate = head_gate != nullptr ? head_gate[(size_t)b * H + h] : 1.f;
    const size_t srow = (size_t)(b * H + h) * 2 * L;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = qt * FWD_ROWS + wg * TILE + warp * 16 + g + 8 * r;
        if (q >= L) continue;
        bf16* dst = out + ((size_t)b * L + q) * D + h * DH + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float v0 = o[4 * j + 2 * r], v1 = o[4 * j + 2 * r + 1];
            if (DEFERRED) {
                v0 = v0 / l[r];
                v1 = v1 / l[r];
            }
            *reinterpret_cast<unsigned*>(dst + 8 * j) = pack_bf16(v0 * gate, v1 * gate);
        }
        if (stats != nullptr && tq == 0) {
            stats[srow + q] = m[r];
            stats[srow + L + q] = l[r];
        }
    }
}

// ---------------------------------------------------------------------------
// Backward (a), bf16: per query tile, delta, the tile's dgate share and dQ.
// ---------------------------------------------------------------------------
constexpr size_t BWD_Q_SMEM = (size_t)(2 + 2 * STAGES) * TILE_ELEMS * sizeof(bf16) +
                              (size_t)STAGES * TILE * sizeof(float) + 4 * sizeof(float);

// One key tile of backward (a): P from the row statistics and dP; in
// sweep 1 (``delta_sweep``) the per-thread delta and, gated, bf16(P).V
// into acc; in sweep 2 dS and dQ += bf16(dS).K into acc.
template <bool GATED>
__device__ __forceinline__ void bwd_q_tile(bool delta_sweep, const bf16* Qs, const bf16* dOs,
                                           const bf16* Kt, const bf16* Vt, const float* ng,
                                           int tq, float sm_scale, const float (&m)[2],
                                           const float (&inv)[2], float (&delta)[2],
                                           float (&acc)[32]) {
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    product_ss(s, Qs, Kt);
    product_ss(dp, dOs, Vt);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    scale_mask(s, ng, tq, sm_scale);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = __expf(s[e] - m[r]) * inv[r];
    }
    unsigned a[4][4];
    if (delta_sweep) {
#pragma unroll
        for (int e = 0; e < 32; ++e) delta[(e >> 1) & 1] += s[e] * dp[e];
        if (!GATED) return;
        pack_a(a, s);
        wg_fence();
        product_rs(acc, a, Vt);
    } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - delta[(e >> 1) & 1]);
        pack_a(a, dp);
        wg_fence();
        product_rs(acc, a, Kt);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
}

template <bool GATED>
__global__ void __launch_bounds__(WG, 3)
attn_bwd_q_bf16(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
                const float* __restrict__ head_gate, const bf16* __restrict__ dout,
                const float* __restrict__ stats, bf16* __restrict__ dqkv,
                float* __restrict__ delta_out, float* __restrict__ dgate_part, int L, int H,
                float sm_scale) {
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* dOs = Qs + TILE_ELEMS;
    bf16* Ks = dOs + TILE_ELEMS;
    bf16* Vs = Ks + STAGES * TILE_ELEMS;
    float* negs = reinterpret_cast<float*>(Vs + STAGES * TILE_ELEMS);
    float* red = negs + STAGES * TILE;

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const bf16* base = qkv + (size_t)b * L * row3 + h * DH;
    const bf16* dbase = dout + (size_t)b * L * D + h * DH;
    const float* km = key_mask + (size_t)b * L;
    const int bh = b * H + h, nkt = ntiles(L), steps = 2 * nkt;
    const float gate = GATED ? head_gate[bh] : 1.f;

    auto issue = [&](int t) {
        const int j = t < nkt ? t : t - nkt, st = t % STAGES;
        load_tile<WG>(Ks + st * TILE_ELEMS, base + D, row3, j * TILE, L, tid);
        load_tile<WG>(Vs + st * TILE_ELEMS, base + 2 * D, row3, j * TILE, L, tid);
        if (tid < TILE) {
            const int key = j * TILE + tid;
            cp_async4(negs + st * TILE + tid, km + (key < L ? key : 0), key < L);
        }
    };

    load_tile<WG>(Qs, base, row3, qt * TILE, L, tid);
    load_tile<WG>(dOs, dbase, D, qt * TILE, L, tid);
    issue(0);
    cp_async_commit();

    int rows[2];
    float m[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        rows[r] = qt * TILE + warp * 16 + g + 8 * r;
        const bool ok = rows[r] < L;
        m[r] = ok ? stats[(size_t)bh * 2 * L + rows[r]] : 0.f;
        inv[r] = ok ? 1.f / stats[((size_t)bh * 2 + 1) * L + rows[r]] : 0.f;
    }
    float delta[2] = {0.f, 0.f};
    float acc[32];  // bf16(P).V in sweep 1 (gated), then dQ in sweep 2
    zero(acc);
    for (int t = 0; t < steps; ++t) {
        if (t + 1 < steps) issue(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
        const int st = t % STAGES, j = t < nkt ? t : t - nkt;
        if (GATED && t == 0) gate_own_chunks(dOs, gate, tid);
        if (tid < TILE) {  // this thread's key-mask value into the additive mask
            const int key = j * TILE + tid;
            float* v = negs + st * TILE + tid;
            *v = key < L ? (1.f - *v) * NEG : -INFINITY;
        }
        fence_proxy_async();
        __syncthreads();
        if (t == nkt) {  // sweep 1 is done: delta, and this tile's dgate share
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                delta[r] = quad_sum(delta[r]);
                if (tq == 0 && rows[r] < L) delta_out[(size_t)bh * L + rows[r]] = delta[r];
            }
            if (GATED) {  // against the ungated dO
                float dg = 0.f;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    if (rows[r] >= L) continue;
                    const bf16* src = dbase + (size_t)rows[r] * D + 2 * tq;
#pragma unroll
                    for (int jj = 0; jj < 8; ++jj) {
                        const float2 d2 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(src + 8 * jj));
                        dg += acc[4 * jj + 2 * r] * d2.x + acc[4 * jj + 2 * r + 1] * d2.y;
                    }
                }
                dg = warp_sum(dg);
                if (lane == 0) red[warp] = dg;
                __syncthreads();
                if (tid == 0)
                    dgate_part[(size_t)bh * gridDim.x + qt] = (red[0] + red[1]) + (red[2] + red[3]);
            }
            zero(acc);
        }
        bwd_q_tile<GATED>(t < nkt, Qs, dOs, Ks + st * TILE_ELEMS, Vs + st * TILE_ELEMS,
                          negs + st * TILE, tq, sm_scale, m, inv, delta, acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (rows[r] >= L) continue;
        bf16* dst = dqkv + ((size_t)b * L + rows[r]) * row3 + h * DH + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            *reinterpret_cast<unsigned*>(dst + 8 * j) =
                pack_bf16(acc[4 * j + 2 * r] * sm_scale, acc[4 * j + 2 * r + 1] * sm_scale);
    }
}

// ---------------------------------------------------------------------------
// Backward (b), bf16: per key tile, dK and dV (and dgate from the shares).
// ---------------------------------------------------------------------------
constexpr size_t BWD_KV_SMEM = (size_t)(2 + 2 * STAGES) * TILE_ELEMS * sizeof(bf16) +
                               (size_t)STAGES * 3 * TILE * sizeof(float);

// One query tile of backward (b), scores transposed (rows keys, columns
// queries): P^T from the statistics (``rs``: m, 1 / l and delta of the
// tile's queries; 1 / l = 0 past L), dS^T, dV += bf16(P^T).dO and
// dK += bf16(dS^T).Q.
__device__ __forceinline__ void bwd_kv_tile(const bf16* Ks, const bf16* Vs, const bf16* Qt,
                                            const bf16* dOt, const float* rs, int tq,
                                            float sm_scale, const float (&negk)[2],
                                            float (&dk)[32], float (&dv)[32]) {
    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    wg_fence();
    product_ss(st, Ks, Qt);   // S^T
    product_ss(dpt, Vs, dOt);  // dP^T
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 m2 = *reinterpret_cast<const float2*>(rs + c);
        const float2 i2 = *reinterpret_cast<const float2*>(rs + TILE + c);
        const float2 d2 = *reinterpret_cast<const float2*>(rs + 2 * TILE + c);
#pragma unroll
        for (int e = 4 * j; e < 4 * j + 4; ++e) {
            const float p = __expf(st[e] * sm_scale + negk[(e >> 1) & 1] - (e & 1 ? m2.y : m2.x)) *
                            (e & 1 ? i2.y : i2.x);
            st[e] = p;
            dpt[e] = p * (dpt[e] - (e & 1 ? d2.y : d2.x));
        }
    }
    unsigned pa[4][4], da[4][4];
    pack_a(pa, st);
    pack_a(da, dpt);
    wg_fence();
    product_rs(dv, pa, dOt);
    product_rs(dk, da, Qt);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
}

template <bool GATED>
__global__ void __launch_bounds__(WG, 3)
attn_bwd_kv_bf16(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
                 const float* __restrict__ head_gate, const bf16* __restrict__ dout,
                 const float* __restrict__ stats, const float* __restrict__ delta_in,
                 const float* __restrict__ dgate_part, bf16* __restrict__ dqkv,
                 float* __restrict__ dhead, int L, int H, float sm_scale) {
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + TILE_ELEMS;
    bf16* Qs = Vs + TILE_ELEMS;
    bf16* dOs = Qs + STAGES * TILE_ELEMS;
    float* rowst = reinterpret_cast<float*>(dOs + STAGES * TILE_ELEMS);  // m, l, delta

    const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const bf16* base = qkv + (size_t)b * L * row3 + h * DH;
    const bf16* dbase = dout + (size_t)b * L * D + h * DH;
    const int bh = b * H + h, nqt = ntiles(L);
    const float gate = GATED ? head_gate[bh] : 1.f;

    if (GATED && kt == 0 && tid == 0) {  // kernel (a)'s shares, in order
        float total = 0.f;
        for (int i = 0; i < nqt; ++i) total += dgate_part[(size_t)bh * nqt + i];
        dhead[bh] = total;
    }

    auto issue = [&](int t) {
        const int st = t % STAGES;
        load_tile<WG>(Qs + st * TILE_ELEMS, base, row3, t * TILE, L, tid);
        load_tile<WG>(dOs + st * TILE_ELEMS, dbase, D, t * TILE, L, tid);
        if (tid < TILE) {
            const int q = t * TILE + tid, qc = q < L ? q : 0;
            float* rs = rowst + st * 3 * TILE;
            cp_async4(rs + tid, stats + (size_t)bh * 2 * L + qc, q < L);
            cp_async4(rs + TILE + tid, stats + ((size_t)bh * 2 + 1) * L + qc, q < L);
            cp_async4(rs + 2 * TILE + tid, delta_in + (size_t)bh * L + qc, q < L);
        }
    };

    load_tile<WG>(Ks, base + D, row3, kt * TILE, L, tid);
    load_tile<WG>(Vs, base + 2 * D, row3, kt * TILE, L, tid);
    issue(0);
    cp_async_commit();

    int keys[2];
    float negk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        keys[r] = kt * TILE + warp * 16 + g + 8 * r;
        negk[r] = key_neg(key_mask + (size_t)b * L, keys[r], L);
    }
    float dk[32], dv[32];
    zero(dk);
    zero(dv);
    for (int t = 0; t < nqt; ++t) {
        if (t + 1 < nqt) issue(t + 1);
        cp_async_commit();
        cp_async_wait<1>();
        const int st = t % STAGES;
        bf16* dOt = dOs + st * TILE_ELEMS;
        if (GATED) gate_own_chunks(dOt, gate, tid);
        if (tid < TILE) {  // this thread's row sum into its reciprocal
            float* li = rowst + st * 3 * TILE + TILE + tid;
            *li = t * TILE + tid < L ? 1.f / *li : 0.f;
        }
        fence_proxy_async();
        __syncthreads();
        // query rows past L have m = 0 and 1 / l = 0: p and dS are 0
        bwd_kv_tile(Ks, Vs, Qs + st * TILE_ELEMS, dOt, rowst + st * 3 * TILE, tq, sm_scale,
                    negk, dk, dv);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (keys[r] >= L) continue;
        bf16* dst = dqkv + ((size_t)b * L + keys[r]) * row3 + D + h * DH + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<unsigned*>(dst + 8 * j) =
                pack_bf16(dk[4 * j + 2 * r] * sm_scale, dk[4 * j + 2 * r + 1] * sm_scale);
            *reinterpret_cast<unsigned*>(dst + D + 8 * j) =
                pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
        }
    }
}

// ---------------------------------------------------------------------------
// f32 on FFMA. Tiles are 64 x 64 floats in shared memory with rows padded
// to 65 (conflict-free columns). Thread t owns rows 4 * (t / 8) + i
// (i < 4) and columns t % 8 + 8c (c < 8) of every 64 x 64 product; the 8
// threads of a row group are neighbouring lanes.
// ---------------------------------------------------------------------------
constexpr int FLD = DH + 1;
constexpr int FTILE = TILE * FLD;

__device__ __forceinline__ void load_tile_f32(float* tile, const float* src, int stride, int r0,
                                              int nrows, int tid) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int i = tid + k * WG, r = i >> 4, c4 = (i & 15) * 4, row = r0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < nrows) v = *reinterpret_cast<const float4*>(src + (size_t)row * stride + c4);
        float* d = tile + r * FLD + c4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    }
}

// acc[i][c] (+)= sum_d A[row i][d] * B[col c][d]   (A . B^T)
__device__ __forceinline__ void ffma_nt(float (&acc)[4][8], const float* A, const float* B,
                                        int rt, int ct) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = A[(4 * rt + i) * FLD + d];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = B[(ct + 8 * c) * FLD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
}

// acc[i][c] += sum_k P[row i][k] * X[k][col c]   (P . X)
__device__ __forceinline__ void ffma_nn(float (&acc)[4][8], const float* P, const float* X,
                                        int rt, int ct) {
#pragma unroll 4
    for (int k = 0; k < TILE; ++k) {
        float pv[4], xv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = P[(4 * rt + i) * FLD + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) xv[c] = X[k * FLD + ct + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
    }
}

__device__ __forceinline__ float oct_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float oct_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

constexpr size_t FWD_F32_SMEM = (size_t)4 * FTILE * sizeof(float) + TILE * sizeof(float);

__global__ void __launch_bounds__(WG)
attn_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ key_mask,
             const float* __restrict__ head_gate, float* __restrict__ out,
             float* __restrict__ stats, int L, int H, float sm_scale) {
    extern __shared__ __align__(16) float fsm[];
    float* Qs = fsm;
    float* Ks = Qs + FTILE;
    float* Vs = Ks + FTILE;
    float* Ps = Vs + FTILE;
    float* negs = Ps + FTILE;

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, rt = tid >> 3, ct = tid & 7;
    const float* base = qkv + (size_t)b * L * row3 + h * DH;
    const float* km = key_mask + (size_t)b * L;
    const int nkt = ntiles(L);

    load_tile_f32(Qs, base, row3, qt * TILE, L, tid);
    float m[4], l[4], s[4][8], o[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
    }
    for (int t = 0; t < 2 * nkt; ++t) {
        const int j = t < nkt ? t : t - nkt;
        __syncthreads();  // the previous step is done with the tiles
        load_tile_f32(Ks, base + D, row3, j * TILE, L, tid);
        if (t >= nkt) load_tile_f32(Vs, base + 2 * D, row3, j * TILE, L, tid);
        if (tid < TILE) negs[tid] = key_neg(km, j * TILE + tid, L);
        __syncthreads();
        ffma_nt(s, Qs, Ks, rt, ct);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) s[i][c] = s[i][c] * sm_scale + negs[ct + 8 * c];
        if (t < nkt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float mx = -INFINITY;
#pragma unroll
                for (int c = 0; c < 8; ++c) mx = fmaxf(mx, s[i][c]);
                const float mn = fmaxf(m[i], oct_max(mx));
                l[i] *= expf(m[i] - mn);
                m[i] = mn;
#pragma unroll
                for (int c = 0; c < 8; ++c) l[i] += expf(s[i][c] - mn);
            }
        } else {
            if (t == nkt) {
#pragma unroll
                for (int i = 0; i < 4; ++i) l[i] = oct_sum(l[i]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    Ps[(4 * rt + i) * FLD + ct + 8 * c] = expf(s[i][c] - m[i]) / l[i];
            __syncthreads();
            ffma_nn(o, Ps, Vs, rt, ct);
        }
    }

    const float gate = head_gate != nullptr ? head_gate[(size_t)b * H + h] : 1.f;
    const size_t srow = (size_t)(b * H + h) * 2 * L;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = qt * TILE + 4 * rt + i;
        if (q >= L) continue;
        float* dst = out + ((size_t)b * L + q) * D + h * DH + ct;
#pragma unroll
        for (int c = 0; c < 8; ++c) dst[8 * c] = o[i][c] * gate;
        if (stats != nullptr && ct == 0) {
            stats[srow + q] = m[i];
            stats[srow + L + q] = l[i];
        }
    }
}

constexpr size_t BWD_Q_F32_SMEM =
    (size_t)5 * FTILE * sizeof(float) + (size_t)(TILE + 4) * sizeof(float);

__global__ void __launch_bounds__(WG)
attn_bwd_q_f32(const float* __restrict__ qkv, const float* __restrict__ key_mask,
               const float* __restrict__ head_gate, const float* __restrict__ dout,
               const float* __restrict__ stats, float* __restrict__ dqkv,
               float* __restrict__ delta_out, float* __restrict__ dgate_part, int L, int H,
               float sm_scale) {
    extern __shared__ __align__(16) float fsm[];
    float* Qs = fsm;
    float* dOs = Qs + FTILE;
    float* Ks = dOs + FTILE;
    float* Vs = Ks + FTILE;
    float* Ps = Vs + FTILE;
    float* negs = Ps + FTILE;
    float* red = negs + TILE;

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, rt = tid >> 3, ct = tid & 7;
    const float* base = qkv + (size_t)b * L * row3 + h * DH;
    const float* dbase = dout + (size_t)b * L * D + h * DH;
    const float* km = key_mask + (size_t)b * L;
    const int bh = b * H + h, nkt = ntiles(L);
    const bool gated = head_gate != nullptr;
    const float gate = gated ? head_gate[bh] : 1.f;

    load_tile_f32(Qs, base, row3, qt * TILE, L, tid);
    load_tile_f32(dOs, dbase, D, qt * TILE, L, tid);
    __syncthreads();
    if (gated)
        for (int i = tid; i < TILE * DH; i += WG) dOs[(i >> 6) * FLD + (i & 63)] *= gate;

    float m[4], l[4], delta[4], s[4][8], dp[4][8], acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = qt * TILE + 4 * rt + i;
        m[i] = q < L ? stats[(size_t)bh * 2 * L + q] : 0.f;
        l[i] = q < L ? stats[((size_t)bh * 2 + 1) * L + q] : 1.f;
        delta[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    }
    for (int t = 0; t < 2 * nkt; ++t) {
        const int j = t < nkt ? t : t - nkt;
        __syncthreads();
        load_tile_f32(Ks, base + D, row3, j * TILE, L, tid);
        load_tile_f32(Vs, base + 2 * D, row3, j * TILE, L, tid);
        if (tid < TILE) negs[tid] = key_neg(km, j * TILE + tid, L);
        __syncthreads();
        ffma_nt(s, Qs, Ks, rt, ct);
        ffma_nt(dp, dOs, Vs, rt, ct);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c)
                s[i][c] = expf(s[i][c] * sm_scale + negs[ct + 8 * c] - m[i]) / l[i];
        if (t < nkt) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 8; ++c) delta[i] += s[i][c] * dp[i][c];
            if (gated) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 8; ++c) Ps[(4 * rt + i) * FLD + ct + 8 * c] = s[i][c];
                __syncthreads();
                ffma_nn(acc, Ps, Vs, rt, ct);
            }
            if (t == nkt - 1) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    delta[i] = oct_sum(delta[i]);
                    const int q = qt * TILE + 4 * rt + i;
                    if (ct == 0 && q < L) delta_out[(size_t)bh * L + q] = delta[i];
                }
                if (gated) {
                    float dg = 0.f;
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int q = qt * TILE + 4 * rt + i;
                        if (q >= L) continue;
#pragma unroll
                        for (int c = 0; c < 8; ++c)
                            dg += acc[i][c] * dbase[(size_t)q * D + ct + 8 * c];
                    }
                    dg = warp_sum(dg);
                    if ((tid & 31) == 0) red[tid >> 5] = dg;
                    __syncthreads();
                    if (tid == 0)
                        dgate_part[(size_t)bh * gridDim.x + qt] =
                            (red[0] + red[1]) + (red[2] + red[3]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
            }
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    Ps[(4 * rt + i) * FLD + ct + 8 * c] = s[i][c] * (dp[i][c] - delta[i]);
            __syncthreads();
            ffma_nn(acc, Ps, Ks, rt, ct);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = qt * TILE + 4 * rt + i;
        if (q >= L) continue;
        float* dst = dqkv + ((size_t)b * L + q) * row3 + h * DH + ct;
#pragma unroll
        for (int c = 0; c < 8; ++c) dst[8 * c] = acc[i][c] * sm_scale;
    }
}

constexpr size_t BWD_KV_F32_SMEM =
    (size_t)6 * FTILE * sizeof(float) + (size_t)3 * TILE * sizeof(float);

__global__ void __launch_bounds__(WG)
attn_bwd_kv_f32(const float* __restrict__ qkv, const float* __restrict__ key_mask,
                const float* __restrict__ head_gate, const float* __restrict__ dout,
                const float* __restrict__ stats, const float* __restrict__ delta_in,
                const float* __restrict__ dgate_part, float* __restrict__ dqkv,
                float* __restrict__ dhead, int L, int H, float sm_scale) {
    extern __shared__ __align__(16) float fsm[];
    float* Ks = fsm;
    float* Vs = Ks + FTILE;
    float* Qs = Vs + FTILE;
    float* dOs = Qs + FTILE;
    float* Ps = dOs + FTILE;
    float* Ds = Ps + FTILE;
    float* rs = Ds + FTILE;  // m, l, delta of the query tile

    const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, rt = tid >> 3, ct = tid & 7;
    const float* base = qkv + (size_t)b * L * row3 + h * DH;
    const float* dbase = dout + (size_t)b * L * D + h * DH;
    const int bh = b * H + h, nqt = ntiles(L);
    const bool gated = head_gate != nullptr;
    const float gate = gated ? head_gate[bh] : 1.f;

    if (gated && kt == 0 && tid == 0) {
        float total = 0.f;
        for (int i = 0; i < nqt; ++i) total += dgate_part[(size_t)bh * nqt + i];
        dhead[bh] = total;
    }
    load_tile_f32(Ks, base + D, row3, kt * TILE, L, tid);
    load_tile_f32(Vs, base + 2 * D, row3, kt * TILE, L, tid);
    float negk[4], st[4][8], dpt[4][8], dk[4][8], dv[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        negk[i] = key_neg(key_mask + (size_t)b * L, kt * TILE + 4 * rt + i, L);
#pragma unroll
        for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.f;
    }
    for (int t = 0; t < nqt; ++t) {
        __syncthreads();
        load_tile_f32(Qs, base, row3, t * TILE, L, tid);
        load_tile_f32(dOs, dbase, D, t * TILE, L, tid);
        if (tid < TILE) {
            const int q = t * TILE + tid;
            const bool ok = q < L;
            rs[tid] = ok ? stats[(size_t)bh * 2 * L + q] : 0.f;
            rs[TILE + tid] = ok ? stats[((size_t)bh * 2 + 1) * L + q] : 1.f;
            rs[2 * TILE + tid] = ok ? delta_in[(size_t)bh * L + q] : 0.f;
        }
        __syncthreads();
        if (gated) {
            for (int i = tid; i < TILE * DH; i += WG) dOs[(i >> 6) * FLD + (i & 63)] *= gate;
            __syncthreads();
        }
        ffma_nt(st, Ks, Qs, rt, ct);
        ffma_nt(dpt, Vs, dOs, rt, ct);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int qc = ct + 8 * c;
                const float p = t * TILE + qc < L
                                    ? expf(st[i][c] * sm_scale + negk[i] - rs[qc]) / rs[TILE + qc]
                                    : 0.f;
                Ps[(4 * rt + i) * FLD + qc] = p;
                Ds[(4 * rt + i) * FLD + qc] = p * (dpt[i][c] - rs[2 * TILE + qc]);
            }
        __syncthreads();
        ffma_nn(dv, Ps, dOs, rt, ct);
        ffma_nn(dk, Ds, Qs, rt, ct);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = kt * TILE + 4 * rt + i;
        if (k >= L) continue;
        float* dst = dqkv + ((size_t)b * L + k) * row3 + D + h * DH + ct;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            dst[8 * c] = dk[i][c] * sm_scale;
            dst[D + 8 * c] = dv[i][c];
        }
    }
}

template <typename K>
cudaError_t smem_limit(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// The forward. ``qkv``: (b, l, 3 * num_heads * 64), bf16 (f32 = 0) or f32,
// contiguous; ``key_mask``: (b, l) f32; ``head_gate``: (b, num_heads) f32 or
// null; ``out``: (b, l, num_heads * 64) in qkv's type; ``stats``: f32
// (b, num_heads, 2, l) row max and row sum, or null. ``deferred``: the
// fast_math softmax (bf16 only).
int lt_attn_fwd(const void* qkv, const void* key_mask, const void* head_gate, void* out,
                void* stats, int b, int l, int num_heads, float sm_scale, int deferred, int f32,
                void* stream) {
    if (l <= 0 || (f32 && deferred)) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(ntiles(l), num_heads, b), block(WG);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* KM = static_cast<const float*>(key_mask);
    const float* HG = static_cast<const float*>(head_gate);
    float* ST = static_cast<float*>(stats);
    cudaError_t err;
    if (f32) {
        if ((err = smem_limit(attn_fwd_f32, FWD_F32_SMEM)) != cudaSuccess) return err;
        attn_fwd_f32<<<grid, block, FWD_F32_SMEM, s>>>(static_cast<const float*>(qkv), KM, HG,
                                                       static_cast<float*>(out), ST, l,
                                                       num_heads, sm_scale);
    } else {
        auto kernel = deferred ? attn_fwd_bf16<true> : attn_fwd_bf16<false>;
        if ((err = smem_limit(kernel, FWD_SMEM)) != cudaSuccess) return err;
        const dim3 grid2((l + FWD_ROWS - 1) / FWD_ROWS, num_heads, b);
        kernel<<<grid2, FWD_THREADS, FWD_SMEM, s>>>(static_cast<const bf16*>(qkv), KM, HG,
                                                    static_cast<bf16*>(out), ST, l, num_heads,
                                                    sm_scale);
    }
    return static_cast<int>(cudaGetLastError());
}

// The backward: kernel (a) then kernel (b) on ``stream``. ``dout``: (b, l,
// num_heads * 64) in qkv's type, contiguous; ``stats``: the forward's;
// ``dqkv`` like qkv; ``dhead``: (b, num_heads) f32, written only with a
// gate. Scratch from the caller: ``delta`` f32 (b, num_heads, l) and, with
// a gate, ``dgate_part`` f32 (b, num_heads, ceil(l / 64)).
int lt_attn_bwd(const void* qkv, const void* key_mask, const void* head_gate, const void* dout,
                const void* stats, void* dqkv, void* dhead, void* delta, void* dgate_part, int b,
                int l, int num_heads, float sm_scale, int f32, void* stream) {
    if (l <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(ntiles(l), num_heads, b), block(WG);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* KM = static_cast<const float*>(key_mask);
    const float* HG = static_cast<const float*>(head_gate);
    const float* ST = static_cast<const float*>(stats);
    float* DL = static_cast<float*>(delta);
    float* DG = static_cast<float*>(dgate_part);
    float* DHD = static_cast<float*>(dhead);
    cudaError_t err;
    if (f32) {
        const float* Q = static_cast<const float*>(qkv);
        const float* DO = static_cast<const float*>(dout);
        float* DQ = static_cast<float*>(dqkv);
        if ((err = smem_limit(attn_bwd_q_f32, BWD_Q_F32_SMEM)) != cudaSuccess) return err;
        if ((err = smem_limit(attn_bwd_kv_f32, BWD_KV_F32_SMEM)) != cudaSuccess) return err;
        attn_bwd_q_f32<<<grid, block, BWD_Q_F32_SMEM, s>>>(Q, KM, HG, DO, ST, DQ, DL, DG, l,
                                                           num_heads, sm_scale);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        attn_bwd_kv_f32<<<grid, block, BWD_KV_F32_SMEM, s>>>(Q, KM, HG, DO, ST, DL, DG, DQ,
                                                             DHD, l, num_heads, sm_scale);
    } else {
        const bf16* Q = static_cast<const bf16*>(qkv);
        const bf16* DO = static_cast<const bf16*>(dout);
        bf16* DQ = static_cast<bf16*>(dqkv);
        auto ka = HG != nullptr ? attn_bwd_q_bf16<true> : attn_bwd_q_bf16<false>;
        auto kb = HG != nullptr ? attn_bwd_kv_bf16<true> : attn_bwd_kv_bf16<false>;
        if ((err = smem_limit(ka, BWD_Q_SMEM)) != cudaSuccess) return err;
        if ((err = smem_limit(kb, BWD_KV_SMEM)) != cudaSuccess) return err;
        ka<<<grid, block, BWD_Q_SMEM, s>>>(Q, KM, HG, DO, ST, DQ, DL, DG, l, num_heads, sm_scale);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        kb<<<grid, block, BWD_KV_SMEM, s>>>(Q, KM, HG, DO, ST, DL, DG, DQ, DHD, l, num_heads,
                                            sm_scale);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
