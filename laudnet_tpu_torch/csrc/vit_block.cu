// Pre-norm ViT block kernels for Hopper (sm_90a): row LayerNorm (with the
// fused eval token gate), bf16 GEMM with f32 accumulation and the block's
// four epilogues, masked multi-head attention with dh = 64 and an optional
// per-head output gate, and the W8A8 forms of the same layer (LayerNorm and
// row passes that emit s8 codes, s8 x s8 -> s32 GEMM with rank-1 dequant).
//
// Replaces the TPU kernels
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_block       (B1)
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_segment     (B2)
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_block_int8  (B6)
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_fwd        (B4a)
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_fwd_strips (B4)
// The TPU kernel runs a whole layer per grid step with the layer's weights
// resident in VMEM. One DeiT-S layer holds ~3.5 MB of bf16 weights against
// 227 KB of shared memory per H100 block, so that shape does not transfer:
// a layer here is seven launches (LN1[+gate], qkv, attention, proj, LN2,
// fc1, fc2) whose intermediates make one trip through device memory each.
//
// What bounds it on the H100: the four weight products carry ~92% of the
// layer's FLOPs (DeiT-S, L=197: ~0.70 of ~0.76 GFLOP per image). At bs128
// each is one GEMM with M = 25,216 rows and ~290-310 FLOP per byte moved,
// right at the bf16 ridge (~295), so they are bound by how well the GEMM
// feeds the tensor cores. This version issues mma.sync m16n8k16 from
// ldmatrix fragments with a four-stage cp.async ring and applies each
// epilogue straight from the accumulator registers; wgmma/TMA (the only
// way to the card's 989 TFLOP/s) are for later. LayerNorm is bound by
// device-memory bytes (one read, one write per row). Attention keeps all
// keys and values of one (image, head) in shared memory (L <= 197 at
// DeiT-S: ~60 KB bf16) and each warp's 16 score rows in registers, so
// scores never leave the SM.
//
// Rounding points follow the TPU kernel (vit_block.py:421-436, 589-617):
//   h1 = bf16(LN(x)); qkv = bf16(h1 @ W + b); attention output bf16 per
//   head; x2 = f32(x) + (attn @ Wp + bp) * rmask kept in f32;
//   h2 = bf16(LN(bf16(x2))); u = bf16(GELU(h2 @ W1 + b1)) with GELU in f32;
//   out = bf16(x2 + (u @ W2 + b2) * rmask).
// fast_math (vit_block.py:133-143): one-pass LN, tanh GELU, and softmax
// normalised after P.V with p = exp(s - max) rounded to bf16 for P.V and
// the divide by the unrounded f32 row sum.
// Token gate (vit_block.py:589-594): logits = bf16(x . w) then bf16(+ b),
// keep if logit0 >= logit1, class token pinned, composed into the mask.
//
// B4a/B4 (the attention forward on its own) is this file's attention kernel
// in its exact form with the (B, H) head gate: the TPU's whole-block and
// strip variants differ only in how heads map to 128-lane pairs, which has
// no counterpart here. It rounds where the strip kernel does
// (vit_attention.py:261-275): p = bf16(softmax(s)) before P.V, the gate
// multiplied into the f32 output, one rounding to bf16. It is bound by
// bytes (one read of qkv, one write of the output: ~78 MB at DeiT-S bs128
// against 7.6 GFLOP), so K, V and Q are staged once per block with cp.async
// and scores never leave the SM.
//
// B6 keeps B1's launch structure and attention (exact form) and swaps the
// four products for s8 x s8 -> s32 mma.sync m16n8k32 with the same cp.async
// ring: per byte the s8 fragments of m16n8k32 are laid out exactly as the
// bf16 fragments of m16n8k16, so one GEMM template serves both with K
// counted in 2-byte units. It is bound by operations (the products run
// against the card's 1,979 TOP/s s8 peak). Rounding points where B6 differs
// from B1 (vit_block.py:272-287): LN1's output stays f32 into the quantiser
// (B1 rounds it to bf16); LN2 reads the f32 x2 unrounded (B1 rounds it to
// bf16 first); LayerNorm is always two-pass and GELU always the erf form;
// the proj input is the bf16 attention output, upcast; GELU's f32 result is
// quantised from f32. Rows quantise as vit_block.py::_qrows does:
// s = max(|x|max, 1e-6) * (1/127), q = clip(rint(x / s), -127, 127), with a
// true divide and round-half-to-even.
//
// Weights are in torch.nn.Linear layout (out, in), row-major, so the GEMM
// computes C[m, n] = sum_k A[m, k] * W[n, k]: both operands are contiguous
// along k. Every C entry point returns cudaGetLastError().

#include "mma_common.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// Row LayerNorm, one warp per row, f32 math, bf16 out. The input is the
// bf16 token stream (LN1) or the f32 x2 rounded to bf16 first (LN2,
// vit_block.py:436). With a token policy (tp_w != nullptr) the row's eval
// gate is computed from the same input and multiplied into mask[row].
// ---------------------------------------------------------------------------
constexpr int LN_ROWS = 4;   // warps (rows) per block
constexpr int LN_MAXV = 32;  // values per lane: d <= 1024

template <bool IN_F32>
__global__ void __launch_bounds__(LN_ROWS * 32)
layernorm_kernel(const void* __restrict__ xin, bf16* __restrict__ out,
                 const bf16* __restrict__ w, const bf16* __restrict__ b,
                 int rows, int d, float eps, int one_pass,
                 const bf16* __restrict__ tp_w, const bf16* __restrict__ tp_b,
                 float* __restrict__ mask, int seq_len) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
    if (row >= rows) return;
    const size_t base = (size_t)row * d;
    float v[LN_MAXV];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < LN_MAXV; ++t) {
        const int c = t * 32 + lane;
        v[t] = 0.f;
        if (c < d) {
            v[t] = IN_F32 ? round_bf(static_cast<const float*>(xin)[base + c])
                          : bf(static_cast<const bf16*>(xin)[base + c]);
        }
        sum += v[t];
    }
    if (tp_w != nullptr) {
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int t = 0; t < LN_MAXV; ++t) {
            const int c = t * 32 + lane;
            if (c < d) {
                l0 += v[t] * bf(tp_w[c]);
                l1 += v[t] * bf(tp_w[d + c]);
            }
        }
        // logits round to bf16 BEFORE the bias add and the compare
        // (vit_block.py:589-594, fused_vit.py:224-227)
        l0 = round_bf(round_bf(warp_sum(l0)) + bf(tp_b[0]));
        l1 = round_bf(round_bf(warp_sum(l1)) + bf(tp_b[1]));
        const bool keep = (l0 >= l1) || (row % seq_len == 0);
        if (lane == 0) mask[row] = mask[row] * (keep ? 1.f : 0.f);
    }
    const float mu = warp_sum(sum) / d;
    float var;
    if (one_pass) {
        float sq = 0.f;
#pragma unroll
        for (int t = 0; t < LN_MAXV; ++t) sq += v[t] * v[t];
        var = fmaxf(warp_sum(sq) / d - mu * mu, 0.f);
    } else {
        float sq = 0.f;
#pragma unroll
        for (int t = 0; t < LN_MAXV; ++t) {
            const float c = (t * 32 + lane < d) ? v[t] - mu : 0.f;
            sq += c * c;
        }
        var = warp_sum(sq) / d;
    }
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int t = 0; t < LN_MAXV; ++t) {
        const int c = t * 32 + lane;
        if (c < d) out[base + c] = tobf((v[t] - mu) * rs * bf(w[c]) + bf(b[c]));
    }
}

// ---------------------------------------------------------------------------
// W8A8 row passes, one warp per row. Symmetric per-row s8 exactly as
// vit_block.py::_qrows: a = max|y|, s = max(a, 1e-6) * (1/127),
// q = clip(rint(y / s), -127, 127); the divide is a true divide and rintf
// rounds half to even, as jnp.round does. Codes go to q (rows, d) and the
// f32 scale to scale[row].
//
// Both kernels are bound by bytes, so a lane loads its share of the row
// once, four values (8 or 16 bytes) at a time, keeps it in registers, and
// stores four codes at a time: d % 4 == 0.
//
// layernorm_quant_kernel: two-pass LayerNorm in f32 of the bf16 token
// stream (LN1) or of the UNROUNDED f32 x2 (LN2), quantised from f32
// (vit_block.py:272-273, 284); d <= 1024. The products and sums are rounded
// one by one, as the plain version computes them, so that a code differs
// from the plain version's only through the order of the row sums.
// rowquant_kernel: quantises rows of the bf16 attention output (upcast,
// vit_block.py:280) or of the f32 GELU output (155 MB at DeiT-S bs128);
// d <= 4096.
// ---------------------------------------------------------------------------
constexpr float QEPS = 1e-6f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ int8_t quant_code(float y, float s) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

// Four values of a bf16 or f32 row, 8 or 16 bytes at once.
template <bool IN_F32>
__device__ __forceinline__ float4 load4(const void* p, size_t group) {
    if (IN_F32) return reinterpret_cast<const float4*>(p)[group];
    const uint2 raw = reinterpret_cast<const uint2*>(p)[group];
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float amax4(float a, float4 v) {
    return fmaxf(fmaxf(a, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ void store_codes4(int8_t* q, size_t group, float4 v, float s) {
    char4 c;
    c.x = quant_code(v.x, s);
    c.y = quant_code(v.y, s);
    c.z = quant_code(v.z, s);
    c.w = quant_code(v.w, s);
    reinterpret_cast<char4*>(q)[group] = c;
}

constexpr int LNQ_MAXV = LN_MAXV / 4;  // groups of 4 values per lane: d <= 1024

template <bool IN_F32>
__global__ void __launch_bounds__(LN_ROWS * 32)
layernorm_quant_kernel(const void* __restrict__ xin, int8_t* __restrict__ q,
                       float* __restrict__ scale, const bf16* __restrict__ w,
                       const bf16* __restrict__ b, int rows, int d, float eps) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int groups = d / 4;
    const void* xrow = IN_F32 ? static_cast<const void*>(static_cast<const float*>(xin) + (size_t)row * d)
                              : static_cast<const void*>(static_cast<const bf16*>(xin) + (size_t)row * d);
    float4 v[LNQ_MAXV];
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < LNQ_MAXV; ++t) {
        const int gidx = t * 32 + lane;
        v[t] = gidx < groups ? load4<IN_F32>(xrow, gidx) : make_float4(0.f, 0.f, 0.f, 0.f);
        sum += (v[t].x + v[t].y) + (v[t].z + v[t].w);
    }
    const float mu = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int t = 0; t < LNQ_MAXV; ++t) {
        if (t * 32 + lane < groups) {
            v[t] = make_float4(v[t].x - mu, v[t].y - mu, v[t].z - mu, v[t].w - mu);
            sq += __fmul_rn(v[t].x, v[t].x) + __fmul_rn(v[t].y, v[t].y) +
                  __fmul_rn(v[t].z, v[t].z) + __fmul_rn(v[t].w, v[t].w);
        }
    }
    const float rs = rsqrtf(warp_sum(sq) / d + eps);
    float amax = 0.f;
#pragma unroll
    for (int t = 0; t < LNQ_MAXV; ++t) {
        const int gidx = t * 32 + lane;
        if (gidx < groups) {
            const float4 wv = load4<false>(w, gidx), bv = load4<false>(b, gidx);
            v[t].x = __fadd_rn(__fmul_rn(__fmul_rn(v[t].x, rs), wv.x), bv.x);
            v[t].y = __fadd_rn(__fmul_rn(__fmul_rn(v[t].y, rs), wv.y), bv.y);
            v[t].z = __fadd_rn(__fmul_rn(__fmul_rn(v[t].z, rs), wv.z), bv.z);
            v[t].w = __fadd_rn(__fmul_rn(__fmul_rn(v[t].w, rs), wv.w), bv.w);
            amax = amax4(amax, v[t]);
        }
    }
    const float s = __fmul_rn(fmaxf(warp_max(amax), QEPS), INV127);
    if (lane == 0) scale[row] = s;
    int8_t* qrow = q + (size_t)row * d;
#pragma unroll
    for (int t = 0; t < LNQ_MAXV; ++t) {
        const int gidx = t * 32 + lane;
        if (gidx < groups) store_codes4(qrow, gidx, v[t], s);
    }
}

constexpr int RQ_MAXV = 32;  // groups of 4 values per lane: d <= 4096

// MAXV: groups of 4 values a lane holds, the smallest of 4, 8, 16, 32 that
// covers the row (fewer registers keep more rows in flight).
template <bool IN_F32, int MAXV>
__global__ void __launch_bounds__(LN_ROWS * 32)
rowquant_kernel(const void* __restrict__ xin, int8_t* __restrict__ q,
                float* __restrict__ scale, int rows, int d) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int groups = d / 4;
    const void* xrow = IN_F32 ? static_cast<const void*>(static_cast<const float*>(xin) + (size_t)row * d)
                              : static_cast<const void*>(static_cast<const bf16*>(xin) + (size_t)row * d);
    float4 v[MAXV];
    float amax = 0.f;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
        const int gidx = t * 32 + lane;
        v[t] = gidx < groups ? load4<IN_F32>(xrow, gidx) : make_float4(0.f, 0.f, 0.f, 0.f);
        amax = amax4(amax, v[t]);
    }
    const float s = __fmul_rn(fmaxf(warp_max(amax), QEPS), INV127);
    if (lane == 0) scale[row] = s;
    int8_t* qrow = q + (size_t)row * d;
#pragma unroll
    for (int t = 0; t < MAXV; ++t) {
        const int gidx = t * 32 + lane;
        if (gidx < groups) store_codes4(qrow, gidx, v[t], s);
    }
}

// ---------------------------------------------------------------------------
// GEMM: C[m, n] = sum_k A[m, k] W[n, k] + bias[n], followed by one of the
// block's epilogues. 128x128 block tile, 8 warps of 64x32, four-stage
// cp.async ring (80 KB of dynamic shared memory: two blocks per SM). Rows
// are padded by 16 bytes so ldmatrix reads are free of bank conflicts. Rows
// past M and N are zero-filled on load and not stored (N need not be a
// multiple of the tile: 448 and 1344 are not); N must be a multiple of 8.
//
// Acc = float: bf16 operands, f32 accumulate, a stage holds 32 values of K
// (K % 32 == 0). Acc = int: s8 operands, s32 accumulate (exact: 127^2 * K
// < 2^31 up to K = 133,000), a stage holds 64 values of K (K % 64 == 0);
// the operands are addressed in 2-byte units, K2 = K / 2 of them per row.
// The s8 epilogue dequantises first, acc * xs[m] * ws[n] + bias[n], with
// separately rounded multiplies and add as the plain version computes it.
// ---------------------------------------------------------------------------
enum Epilogue {
    EPI_QKV = 0,   // bf16(acc + b)
    EPI_PROJ = 1,  // f32: x + (acc + b) * rmask      (resid = bf16 x)
    EPI_FC1 = 2,   // bf16(GELU(acc + b)); s8 form: f32 erf GELU, unrounded
    EPI_FC2 = 3,   // bf16(x2 + (acc + b) * rmask)    (resid = f32 x2)
};

constexpr int GBM = 128, GBN = 128, GBK = 32, GLD = GBK + 8, GSTAGES = 4, GTHREADS = 256;
constexpr int GSTAGE = (GBM + GBN) * GLD;  // elements per stage
constexpr int GSMEM = GSTAGES * GSTAGE * 2;

__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}
__device__ __forceinline__ float gelu_tanh(float x) {
    return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

template <int EPI, typename Acc>
__global__ void __launch_bounds__(GTHREADS, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, int M, int N, int K,
            const void* __restrict__ resid, const float* __restrict__ rmask,
            int fast_gelu, void* __restrict__ out,
            const float* __restrict__ xs, const float* __restrict__ ws) {
    constexpr bool S8 = std::is_same<Acc, int>::value;
    extern __shared__ __align__(128) unsigned char gemm_smem[];
    bf16* sm = reinterpret_cast<bf16*>(gemm_smem);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 each
    const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

    auto load_stage = [&](int st, int k0) {
        bf16* as = sm + st * GSTAGE;
        bf16* bs = as + GBM * GLD;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * GTHREADS;
            const int r = c >> 2, col = (c & 3) * 8;
            const int gm = m0 + r, gn = n0 + r;
            cp_async16(as + r * GLD + col, A + (size_t)(gm < M ? gm : 0) * K + k0 + col, gm < M);
            cp_async16(bs + r * GLD + col, W + (size_t)(gn < N ? gn : 0) * K + k0 + col, gn < N);
        }
    };

    Acc acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

    const int KT = K / GBK;
#pragma unroll
    for (int s = 0; s < GSTAGES - 1; ++s) {
        if (s < KT) load_stage(s, s * GBK);
        cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        cp_async_wait<GSTAGES - 2>();
        __syncthreads();  // stage kt landed; stage kt-1 is free to refill
        const int nk = kt + GSTAGES - 1;
        if (nk < KT) load_stage(nk % GSTAGES, nk * GBK);
        cp_async_commit();
        const bf16* as = sm + (kt % GSTAGES) * GSTAGE;
        const bf16* bs = as + GBM * GLD;
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {
            unsigned a[4][4], b[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * GLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                ldsm_x4(b[j], bs + (wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * GLD +
                                  kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mma16816(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
        }
    }
    cp_async_wait<0>();

    // Epilogue from the accumulators: each thread owns column pairs.
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int gm = m0 + wm * 64 + i * 16 + g + h * 8;
            if (gm >= M) continue;
            const float rm = (EPI == EPI_PROJ || EPI == EPI_FC2) ? rmask[gm] : 1.f;
            float rs = 1.f;
            if constexpr (S8) rs = xs[gm];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int gn = n0 + wn * 32 + j * 8 + t * 2;
                if (gn >= N) continue;
                const size_t o = (size_t)gm * N + gn;
                float v0 = static_cast<float>(acc[i][j][h * 2]);
                float v1 = static_cast<float>(acc[i][j][h * 2 + 1]);
                if constexpr (S8) {
                    v0 = __fmul_rn(__fmul_rn(v0, rs), ws[gn]);
                    v1 = __fmul_rn(__fmul_rn(v1, rs), ws[gn + 1]);
                }
                v0 = __fadd_rn(v0, bf(bias[gn]));
                v1 = __fadd_rn(v1, bf(bias[gn + 1]));
                if (EPI == EPI_FC1 && S8) {
                    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                        make_float2(gelu_erf(v0), gelu_erf(v1));
                } else if (EPI == EPI_QKV) {
                    *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
                } else if (EPI == EPI_PROJ) {
                    const float2 x = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(resid) + o));
                    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
                        make_float2(x.x + v0 * rm, x.y + v1 * rm);
                } else if (EPI == EPI_FC1) {
                    *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + o) =
                        fast_gelu ? pack_bf16(gelu_tanh(v0), gelu_tanh(v1))
                                  : pack_bf16(gelu_erf(v0), gelu_erf(v1));
                } else {
                    const float2 x2 = *reinterpret_cast<const float2*>(static_cast<const float*>(resid) + o);
                    *reinterpret_cast<unsigned*>(static_cast<bf16*>(out) + o) =
                        pack_bf16(x2.x + v0 * rm, x2.y + v1 * rm);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Masked attention, dh = 64. One block per (query tile of 64, head, image),
// 4 warps of 16 query rows. K and V of all L keys and the query tile live
// in shared memory (rows padded to 72 elements for conflict-free ldmatrix);
// each warp keeps its 16 x L scores in registers (mma.sync accumulators),
// so L is bounded by the template's key tiles: KT16 tiles of 16 keys.
// Scores and softmax are f32 with the additive -1e9 key mask added after
// the scale; keys past L (tile padding) are excluded. The accumulator
// layout of S is the A-operand layout of P.V, so P goes to the tensor
// cores from registers. An optional (B, H) head gate multiplies the f32
// output before its one rounding (0/1 gates: the same value as gating the
// rounded output, vit_block.py:277-278). Output merged into (B, L, D) bf16.
// ---------------------------------------------------------------------------
constexpr int DH = 64, AQT = 64, AWARPS = 4, KLD = DH + 8;
constexpr int ATT_MAX_L = 256;

__host__ __device__ __forceinline__ int att_lp(int l) { return (l + 15) / 16 * 16; }
__host__ __forceinline__ size_t att_smem_bytes(int l) {
    return ((size_t)2 * att_lp(l) + AQT) * KLD * sizeof(bf16) + (size_t)att_lp(l) * sizeof(float);
}

template <int KT16>
__global__ void __launch_bounds__(AWARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
                 const float* __restrict__ head_gate, bf16* __restrict__ out, int L, int H,
                 float sm_scale, int fast) {
    extern __shared__ __align__(128) unsigned char att_smem[];
    const int lp = att_lp(L);
    bf16* Ks = reinterpret_cast<bf16*>(att_smem);
    bf16* Vs = Ks + lp * KLD;
    bf16* Qs = Vs + lp * KLD;
    float* negs = reinterpret_cast<float*>(Qs + AQT * KLD);

    const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const bf16* base = qkv + (size_t)b * L * row3;

    // K, V rows [0, lp) and the query tile; rows past L are zero.
    for (int c = tid; c < lp * 8; c += AWARPS * 32) {
        const int r = c >> 3, col = (c & 7) * 8;
        const bool ok = r < L;
        const size_t src = (size_t)(ok ? r : 0) * row3 + h * DH + col;
        cp_async16(Ks + r * KLD + col, base + src + D, ok);
        cp_async16(Vs + r * KLD + col, base + src + 2 * D, ok);
    }
    for (int c = tid; c < AQT * 8; c += AWARPS * 32) {
        const int r = c >> 3, col = (c & 7) * 8, q = qt * AQT + r;
        const bool ok = q < L;
        cp_async16(Qs + r * KLD + col, base + (size_t)(ok ? q : 0) * row3 + h * DH + col, ok);
    }
    cp_async_commit();
    for (int c = tid; c < lp; c += AWARPS * 32)
        negs[c] = c < L ? (1.f - key_mask[(size_t)b * L + c]) * NEG : -INFINITY;
    cp_async_wait<0>();
    __syncthreads();

    const int q0 = qt * AQT + warp * 16;
    if (q0 >= L) return;  // no block-wide barrier follows
    const int nkt = lp / 16;
    const int g = lane >> 2, t = lane & 3;

    // S = Q K^T (f32 accumulate), 16 rows x (2 * KT16) tiles of 8 keys
    unsigned qf[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
    float s[2 * KT16][4];
#pragma unroll
    for (int j = 0; j < KT16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
        if (j < nkt) {
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
                unsigned kf[4];
                ldsm_x4(kf, Ks + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
                mma16816(s[2 * j], qf[kk], kf[0], kf[1]);
                mma16816(s[2 * j + 1], qf[kk], kf[2], kf[3]);
            }
        }
    }

    // Row softmax in f32: this thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3); the four threads of a quad share a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * KT16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = n * 8 + t * 2 + (e & 1);
            s[n][e] = key < lp ? s[n][e] * sm_scale + negs[key] : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < 2 * KT16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            s[n][e] = expf(s[n][e] - mx[e >> 1]);  // exp(-inf) = 0 for padded keys
            sum[e >> 1] += s[n][e];
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    // exact: p = e / sum, rounded to bf16; fast_math: p = bf16(e), and
    // the output is divided by the unrounded f32 sum afterwards.

    // O = P V (f32 accumulate), P from the score registers
    float o[DH / 8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KT16; ++j) {
        if (j < nkt) {
            unsigned pf[4];
            if (fast) {
                pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
                pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
                pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
                pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
            } else {
                pf[0] = pack_bf16(s[2 * j][0] / sum[0], s[2 * j][1] / sum[0]);
                pf[1] = pack_bf16(s[2 * j][2] / sum[1], s[2 * j][3] / sum[1]);
                pf[2] = pack_bf16(s[2 * j + 1][0] / sum[0], s[2 * j + 1][1] / sum[0]);
                pf[3] = pack_bf16(s[2 * j + 1][2] / sum[1], s[2 * j + 1][3] / sum[1]);
            }
#pragma unroll
            for (int n = 0; n < DH / 16; ++n) {
                unsigned vf[4];
                ldsm_x4_trans(vf, Vs + (j * 16 + (lane & 15)) * KLD + n * 16 + (lane >> 4) * 8);
                mma16816(o[2 * n], pf, vf[0], vf[1]);
                mma16816(o[2 * n + 1], pf, vf[2], vf[3]);
            }
        }
    }

    const float gate = head_gate != nullptr ? head_gate[(size_t)b * H + h] : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = q0 + g + r * 8;
        if (q >= L) continue;
        bf16* dst = out + ((size_t)b * L + q) * D + h * DH + t * 2;
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
            float v0 = o[n][r * 2], v1 = o[n][r * 2 + 1];
            if (fast) {
                v0 = v0 / sum[r];
                v1 = v1 / sum[r];
            }
            *reinterpret_cast<unsigned*>(dst + n * 8) = pack_bf16(v0 * gate, v1 * gate);
        }
    }
}

template <int KT16>
cudaError_t launch_attention(const bf16* qkv, const float* key_mask, const float* head_gate,
                             bf16* out, int b, int l, int num_heads, float sm_scale, int fast,
                             cudaStream_t stream) {
    const size_t smem = att_smem_bytes(l);
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<KT16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((l + AQT - 1) / AQT, num_heads, b), block(AWARPS * 32);
    attention_kernel<KT16><<<grid, block, smem, stream>>>(qkv, key_mask, head_gate, out, l,
                                                          num_heads, sm_scale, fast);
    return cudaGetLastError();
}

// ``k2``: K in 2-byte units (K for bf16 operands, K / 2 for s8).
template <int EPI, typename Acc>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias, int m, int n, int k2,
                        const void* resid, const void* rmask, int fast_gelu, void* out,
                        const void* xs, const void* ws, cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<EPI, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + GBN - 1) / GBN, (m + GBM - 1) / GBM), block(GTHREADS);
    gemm_kernel<EPI, Acc><<<grid, block, GSMEM, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
        m, n, k2, resid, static_cast<const float*>(rmask), fast_gelu, out,
        static_cast<const float*>(xs), static_cast<const float*>(ws));
    return cudaGetLastError();
}

template <typename Acc>
cudaError_t dispatch_gemm(int epilogue, const void* a, const void* w, const void* bias, int m,
                          int n, int k2, const void* resid, const void* rmask, int fast_gelu,
                          void* out, const void* xs, const void* ws, cudaStream_t s) {
    switch (epilogue) {
        case EPI_QKV: return launch_gemm<EPI_QKV, Acc>(a, w, bias, m, n, k2, resid, rmask, fast_gelu, out, xs, ws, s);
        case EPI_PROJ: return launch_gemm<EPI_PROJ, Acc>(a, w, bias, m, n, k2, resid, rmask, fast_gelu, out, xs, ws, s);
        case EPI_FC1: return launch_gemm<EPI_FC1, Acc>(a, w, bias, m, n, k2, resid, rmask, fast_gelu, out, xs, ws, s);
        case EPI_FC2: return launch_gemm<EPI_FC2, Acc>(a, w, bias, m, n, k2, resid, rmask, fast_gelu, out, xs, ws, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes). Each returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" {

const char* lt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int lt_layernorm(const void* x, int x_f32, void* out, const void* w, const void* b, int rows,
                 int d, float eps, int one_pass, const void* tp_w, const void* tp_b, void* mask,
                 int seq_len, void* stream) {
    const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_f32) {
        layernorm_kernel<true><<<grid, block, 0, s>>>(
            x, static_cast<bf16*>(out), static_cast<const bf16*>(w),
            static_cast<const bf16*>(b), rows, d, eps, one_pass,
            static_cast<const bf16*>(tp_w), static_cast<const bf16*>(tp_b),
            static_cast<float*>(mask), seq_len);
    } else {
        layernorm_kernel<false><<<grid, block, 0, s>>>(
            x, static_cast<bf16*>(out), static_cast<const bf16*>(w),
            static_cast<const bf16*>(b), rows, d, eps, one_pass,
            static_cast<const bf16*>(tp_w), static_cast<const bf16*>(tp_b),
            static_cast<float*>(mask), seq_len);
    }
    return static_cast<int>(cudaGetLastError());
}

int lt_gemm(const void* a, const void* w, const void* bias, int m, int n, int k, int epilogue,
            const void* resid, const void* rmask, int fast_gelu, void* out, void* stream) {
    if (k % GBK != 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_gemm<float>(epilogue, a, w, bias, m, n, k, resid, rmask,
                                                 fast_gelu, out, nullptr, nullptr,
                                                 static_cast<cudaStream_t>(stream)));
}

// s8 operands: a (m, k) and w (n, k) codes, xs (m,) and ws (n,) f32 scales,
// bias bf16. Outputs as the epilogues above; fc1's is f32.
int lt_gemm_s8(const void* a, const void* xs, const void* w, const void* ws, const void* bias,
               int m, int n, int k, int epilogue, const void* resid, const void* rmask,
               void* out, void* stream) {
    if (k % (2 * GBK) != 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_gemm<int>(epilogue, a, w, bias, m, n, k / 2, resid, rmask,
                                               0, out, xs, ws,
                                               static_cast<cudaStream_t>(stream)));
}

// ``head_gate``: (b, num_heads) f32 0/1 output gate, or null.
int lt_attention(const void* qkv, const void* key_mask, const void* head_gate, void* out, int b,
                 int l, int num_heads, float sm_scale, int fast, void* stream) {
    const bf16* Q = static_cast<const bf16*>(qkv);
    const float* KM = static_cast<const float*>(key_mask);
    const float* HG = static_cast<const float*>(head_gate);
    bf16* O = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // register-resident score rows: pick the smallest key-tile count that
    // covers L (DeiT-S selection lengths 96..197 land on 7, 9 and 13)
    const int kt = att_lp(l) / 16;
    cudaError_t err;
    if (kt <= 4) err = launch_attention<4>(Q, KM, HG, O, b, l, num_heads, sm_scale, fast, s);
    else if (kt <= 7) err = launch_attention<7>(Q, KM, HG, O, b, l, num_heads, sm_scale, fast, s);
    else if (kt <= 9) err = launch_attention<9>(Q, KM, HG, O, b, l, num_heads, sm_scale, fast, s);
    else if (kt <= 13) err = launch_attention<13>(Q, KM, HG, O, b, l, num_heads, sm_scale, fast, s);
    else if (l <= ATT_MAX_L) err = launch_attention<16>(Q, KM, HG, O, b, l, num_heads, sm_scale, fast, s);
    else err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

// LayerNorm of bf16 (x_f32 = 0) or unrounded f32 rows, quantised to s8.
int lt_layernorm_quant(const void* x, int x_f32, void* q, void* scale, const void* w,
                       const void* b, int rows, int d, float eps, void* stream) {
    if (d % 4 != 0 || d > LN_MAXV * 32) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_f32) {
        layernorm_quant_kernel<true><<<grid, block, 0, s>>>(
            x, static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<const bf16*>(w),
            static_cast<const bf16*>(b), rows, d, eps);
    } else {
        layernorm_quant_kernel<false><<<grid, block, 0, s>>>(
            x, static_cast<int8_t*>(q), static_cast<float*>(scale), static_cast<const bf16*>(w),
            static_cast<const bf16*>(b), rows, d, eps);
    }
    return static_cast<int>(cudaGetLastError());
}

// Per-row s8 codes and scales of bf16 (x_f32 = 0) or f32 rows.
int lt_rowquant(const void* x, int x_f32, void* q, void* scale, int rows, int d, void* stream) {
    if (d % 4 != 0 || d > RQ_MAXV * 128) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int8_t* Q = static_cast<int8_t*>(q);
    float* S = static_cast<float*>(scale);
    const int maxv = (d + 127) / 128;
#define LT_ROWQUANT(F32, MAXV) rowquant_kernel<F32, MAXV><<<grid, block, 0, s>>>(x, Q, S, rows, d)
    if (x_f32) {
        if (maxv <= 4) LT_ROWQUANT(true, 4);
        else if (maxv <= 8) LT_ROWQUANT(true, 8);
        else if (maxv <= 16) LT_ROWQUANT(true, 16);
        else LT_ROWQUANT(true, RQ_MAXV);
    } else {
        if (maxv <= 4) LT_ROWQUANT(false, 4);
        else if (maxv <= 8) LT_ROWQUANT(false, 8);
        else if (maxv <= 16) LT_ROWQUANT(false, 16);
        else LT_ROWQUANT(false, RQ_MAXV);
    }
#undef LT_ROWQUANT
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
