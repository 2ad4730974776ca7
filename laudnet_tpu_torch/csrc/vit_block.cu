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
// (the attention forward on its own, B4a/B4, and its backward B5 are
// attention.cu's).
// The TPU kernel runs a whole layer per grid step with the layer's weights
// resident in VMEM. One DeiT-S layer holds ~3.5 MB of bf16 weights against
// 227 KB of shared memory per H100 block, so that shape does not transfer:
// a layer here is six launches (LN1[+gate], qkv, attention, proj with LN2
// in its epilogue, fc1, fc2) whose intermediates make one trip through
// device memory each; inside a segment (B2) fc2's epilogue also computes
// the next layer's token gate and LN1, so a segment of n layers is 1 + 5n
// launches. The row passes in the epilogues (vit_block_epi.cuh's
// RowEpilogue, launched from vit_block_rows.cu) need a whole row: they
// run on the GEMM core's cluster form, CN blocks along N exchanging row
// statistics in distributed shared memory, at the widths where N is CN
// tiles (ops/vit_block.py::row_cluster: DeiT-S and T2T-ViT-19); any other
// width runs the row pass as a launch of its own (seven a layer, the
// parent's structure).
//
// What bounds it on the H100: the four weight products carry ~92% of the
// layer's FLOPs (DeiT-S, L=197: ~0.70 of ~0.76 GFLOP per image). At bs128
// each is one GEMM with M = 25,216 rows and ~290-310 FLOP per byte moved,
// right at the bf16 ridge (~295), so they are bound by how well the GEMM
// feeds the tensor cores and hides its epilogue's bytes. They run on the
// GEMM core of gemm_sm90.cuh (TMA ring, warp-specialised wgmma, persistent
// tiles), each epilogue applied straight from the accumulator registers.
// LayerNorm is bound by device-memory bytes (one read, one write per row).
// Attention keeps all keys and values of one (image, head) in shared memory
// (L <= 197 at DeiT-S: ~60 KB bf16) and each warp's 16 score rows in
// registers, so scores never leave the SM.
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
// The layer's attention launch (lt_attention) runs this file's
// register-resident attention_kernel for short rows and attention.cu's
// forward, which streams the keys in tiles, for long ones, in the exact or
// the deferred form with the same head gate: the split (ATT_ROUTE_EXACT,
// ATT_ROUTE_DEFERRED) is where the two kernels measured level.
//
// B6 keeps B1's attention (exact form) and swaps the four products for the
// core's s8 form (s8 x s8 -> s32, wgmma k32), bound by bytes at twice the
// bf16 peak: seven launches, LN1 + row quantise, qkv, attention, row
// quantise, proj with LN2 and its quantiser in the epilogue, fc1 with erf
// GELU and its quantiser in the epilogue (the f32 u, 155 MB at DeiT-S
// bs128, is never stored), fc2. Rounding points where B6 differs
// from B1 (vit_block.py:272-287): LN1's output stays f32 into the quantiser
// (B1 rounds it to bf16); LN2 reads the f32 x2 unrounded (B1 rounds it to
// bf16 first); LayerNorm is always two-pass and GELU always the erf form;
// the proj input is the bf16 attention output, upcast; GELU's f32 result is
// quantised from f32. Rows quantise as vit_block.py::_qrows does:
// s = max(|x|max, 1e-6) * (1/127), q = clip(rint(x / s), -127, 127), with a
// true divide and round-half-to-even.
//
// P1 (tools/probe_block_budget.py::build_block, the TPU block-budget probe)
// is B1 with one stage of the body ablated or replaced, to attribute the
// layer's time. The stages are template parameters of the same kernels, not
// runtime branches: the LayerNorm form (two-pass, one-pass, or x * scale),
// the fc1 activation (erf GELU, tanh GELU, x * sigmoid(1.702 x), or none),
// the softmax (exact, normalised after P.V, p = s * 1e-4 unnormalised, or
// exp(s) without the row max, normalised after P.V), the row mask of the
// proj and fc2 epilogues (on or off), and the proj residual (f32, or
// rounded to bf16). The production layer is the instantiation with the
// row mask on, the residual in f32 and the (two-pass, erf, exact) or
// (one-pass, tanh, deferred) stages of fast_math off or on.
//
// Weights are in torch.nn.Linear layout (out, in), row-major, so the GEMM
// computes C[m, n] = sum_k A[m, k] * W[n, k]: both operands are contiguous
// along k. Every C entry point returns cudaGetLastError().

#include "gemm_sm90.cuh"
#include "mma_common.cuh"
#include "vit_block_epi.cuh"

namespace {

// ---------------------------------------------------------------------------
// Row LayerNorm, one warp per row, f32 math, bf16 out. The input is the
// bf16 token stream (LN1) or the f32 x2 rounded to bf16 first (LN2,
// vit_block.py:436). With a token policy (tp_w != nullptr) the row's eval
// gate is computed from the same input and multiplied into mask[row].
// ---------------------------------------------------------------------------
constexpr int LN_ROWS = 4;   // warps (rows) per block
constexpr int LN_MAXV = 32;  // values per lane: d <= 1024

template <bool IN_F32, int LNF>
__global__ void __launch_bounds__(LN_ROWS * 32)
layernorm_kernel(const void* __restrict__ xin, bf16* __restrict__ out,
                 const bf16* __restrict__ w, const bf16* __restrict__ b,
                 int rows, int d, float eps,
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
    if constexpr (LNF == LN_SCALE) {
        // the probe's "no LayerNorm": x * scale, no statistics, no bias
#pragma unroll
        for (int t = 0; t < LN_MAXV; ++t) {
            const int c = t * 32 + lane;
            if (c < d) out[base + c] = tobf(v[t] * bf(w[c]));
        }
        return;
    }
    const float mu = warp_sum(sum) / d;
    float var;
    if constexpr (LNF == LN_ONEPASS) {
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
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
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
// lt_attention's split between attention_kernel and attention.cu's
// streaming forward (attn_fwd_bf16): the exact form streams from
// ATT_ROUTE_EXACT keys on, the deferred (fast_math) form from
// ATT_ROUTE_DEFERRED on. Measured in turns at DeiT-S bs128 (chip_smoke.py
// kernels, H100 80GB HBM3, 700 W; the head gate moves neither by more
// than 3%), ms streaming / resident:
//   L    exact            deferred
//   98   0.0358 / 0.0368  0.0365 / 0.0317
//   128  0.0421 / 0.0416  0.0434 / 0.0392
//   137  0.0855 / 0.0961  0.0865 / 0.0524
//   197  0.1125 / 0.1255  0.1112 / 0.1213
// The resident kernel's deferred form is fastest up to 144 keys (nine
// 16-key tiles in registers); past that its thirteen tiles lose to the
// streaming one. Its exact form divides every p before P.V and is no
// faster anywhere: streaming past 128 keys (at 98 and 128 the two are
// within 3%, the resident one kept).
constexpr int ATT_ROUTE_EXACT = 129, ATT_ROUTE_DEFERRED = 145;

__host__ __device__ __forceinline__ int att_lp(int l) { return (l + 15) / 16 * 16; }
__host__ __forceinline__ size_t att_smem_bytes(int l) {
    return ((size_t)2 * att_lp(l) + AQT) * KLD * sizeof(bf16) + (size_t)att_lp(l) * sizeof(float);
}

template <int KT16, int SM>
__global__ void __launch_bounds__(AWARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
                 const float* __restrict__ head_gate, bf16* __restrict__ out, int L, int H,
                 float sm_scale) {
    // SM_DEFERRED and SM_NOMAX divide the P.V output by the row sum;
    // SM_LINEAR (the probe's "no softmax", p = s * 1e-4) never normalises
    constexpr bool fast = SM == SM_DEFERRED || SM == SM_NOMAX;
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
    if constexpr (SM == SM_EXACT || SM == SM_DEFERRED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
    } else {
        mx[0] = mx[1] = 0.f;  // the row max is never subtracted
    }
#pragma unroll
    for (int n = 0; n < 2 * KT16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if constexpr (SM == SM_LINEAR) {
                s[n][e] = s[n][e] == -INFINITY ? 0.f : s[n][e] * 1e-4f;  // padded keys: 0
            } else {
                s[n][e] = expf(s[n][e] - mx[e >> 1]);  // exp(-inf) = 0 for padded keys
                sum[e >> 1] += s[n][e];
            }
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
            if constexpr (SM != SM_EXACT) {
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
            if constexpr (fast) {
                v0 = v0 / sum[r];
                v1 = v1 / sum[r];
            }
            *reinterpret_cast<unsigned*>(dst + n * 8) = pack_bf16(v0 * gate, v1 * gate);
        }
    }
}

template <int KT16, int SM>
cudaError_t launch_attention_sm(const bf16* qkv, const float* key_mask, const float* head_gate,
                                bf16* out, int b, int l, int num_heads, float sm_scale,
                                cudaStream_t stream) {
    const size_t smem = att_smem_bytes(l);
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<KT16, SM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((l + AQT - 1) / AQT, num_heads, b), block(AWARPS * 32);
    attention_kernel<KT16, SM><<<grid, block, smem, stream>>>(qkv, key_mask, head_gate, out, l,
                                                              num_heads, sm_scale);
    return cudaGetLastError();
}

template <int KT16>
cudaError_t launch_attention(const bf16* qkv, const float* key_mask, const float* head_gate,
                             bf16* out, int b, int l, int num_heads, float sm_scale, int softmax,
                             cudaStream_t stream) {
    switch (softmax) {
        case SM_EXACT: return launch_attention_sm<KT16, SM_EXACT>(qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, stream);
        case SM_DEFERRED: return launch_attention_sm<KT16, SM_DEFERRED>(qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, stream);
        case SM_LINEAR: return launch_attention_sm<KT16, SM_LINEAR>(qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, stream);
        case SM_NOMAX: return launch_attention_sm<KT16, SM_NOMAX>(qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The tile width: 224 for widths that 224 divides and 192 does not
// (T2T-ViT-19's 448), else 192 (DeiT's widths and T2T's 1344; any other N
// runs with a ragged last tile). WIDE = false keeps a body variant of the probe
// (P1, DeiT-S widths only) at 192, one instantiation instead of two.
template <typename T, class Epi, bool WIDE = true>
cudaError_t launch_block_gemm(const void* a, const void* w, int m, int n, int k, const Epi& epi,
                              cudaStream_t s) {
    if (WIDE && n % 224 == 0 && n % 192 != 0) return launch_gemm_sm90<T, 224>(a, w, m, n, k, epi, s);
    return launch_gemm_sm90<T, 192>(a, w, m, n, k, epi, s);
}

// bf16 operands: the epilogue's variant (see VAR_*) picks the instantiation;
// the production bodies (row mask on, f32 residual, erf or tanh GELU) take
// both tile widths, the probe's ablations 192.
cudaError_t dispatch_gemm_bf16(int epilogue, int variant, const void* a, const void* w,
                               const void* bias, int m, int n, int k, const void* resid,
                               const void* rmask, void* out, cudaStream_t s) {
    const bool rowmask = !(variant & VAR_NO_ROWMASK), bf16res = variant & VAR_BF16_RES;
    const EpiArgs p{static_cast<const bf16*>(bias), resid, static_cast<const float*>(rmask), out,
                    nullptr, nullptr, n};
#define LT_GEMM(WIDE, ...) \
    launch_block_gemm<bf16, BlockEpilogue<__VA_ARGS__>, WIDE>(a, w, m, n, k, BlockEpilogue<__VA_ARGS__>{p}, s)
    switch (epilogue) {
        case EPI_QKV: return LT_GEMM(true, EPI_QKV, false);
        case EPI_PROJ:
            if (bf16res) return rowmask ? LT_GEMM(false, EPI_PROJ, false, ACT_ERF, true, true)
                                        : cudaErrorInvalidValue;
            return rowmask ? LT_GEMM(true, EPI_PROJ, false)
                           : LT_GEMM(false, EPI_PROJ, false, ACT_ERF, false);
        case EPI_FC1:
            switch (variant & 3) {
                case ACT_ERF: return LT_GEMM(true, EPI_FC1, false, ACT_ERF);
                case ACT_TANH: return LT_GEMM(true, EPI_FC1, false, ACT_TANH);
                case ACT_SILU: return LT_GEMM(false, EPI_FC1, false, ACT_SILU);
                default: return LT_GEMM(false, EPI_FC1, false, ACT_NONE);
            }
        case EPI_FC2:
            return rowmask ? LT_GEMM(true, EPI_FC2, false)
                           : LT_GEMM(false, EPI_FC2, false, ACT_ERF, false);
        default: return cudaErrorInvalidValue;
    }
#undef LT_GEMM
}

cudaError_t dispatch_gemm_s8(int epilogue, const void* a, const void* w, const void* bias, int m,
                             int n, int k, const void* resid, const void* rmask, void* out,
                             const void* xs, const void* ws, cudaStream_t s) {
    const EpiArgs p{static_cast<const bf16*>(bias), resid, static_cast<const float*>(rmask), out,
                    static_cast<const float*>(xs), static_cast<const float*>(ws), n};
#define LT_GEMM(EPI) launch_block_gemm<int8_t>(a, w, m, n, k, BlockEpilogue<EPI, true>{p}, s)
    switch (epilogue) {
        case EPI_QKV: return LT_GEMM(EPI_QKV);
        case EPI_PROJ: return LT_GEMM(EPI_PROJ);
        case EPI_FC1: return LT_GEMM(EPI_FC1);
        case EPI_FC2: return LT_GEMM(EPI_FC2);
        default: return cudaErrorInvalidValue;
    }
#undef LT_GEMM
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (bound with ctypes). Each returns cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" {

const char* lt_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// ``ln_form``: LN_TWOPASS, LN_ONEPASS or LN_SCALE.
int lt_layernorm(const void* x, int x_f32, void* out, const void* w, const void* b, int rows,
                 int d, float eps, int ln_form, const void* tp_w, const void* tp_b, void* mask,
                 int seq_len, void* stream) {
    const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LT_LN(F32, LNF)                                                                  \
    layernorm_kernel<F32, LNF><<<grid, block, 0, s>>>(                                   \
        x, static_cast<bf16*>(out), static_cast<const bf16*>(w),                        \
        static_cast<const bf16*>(b), rows, d, eps, static_cast<const bf16*>(tp_w),      \
        static_cast<const bf16*>(tp_b), static_cast<float*>(mask), seq_len)
    switch (ln_form * 2 + (x_f32 ? 1 : 0)) {
        case 0: LT_LN(false, LN_TWOPASS); break;
        case 1: LT_LN(true, LN_TWOPASS); break;
        case 2: LT_LN(false, LN_ONEPASS); break;
        case 3: LT_LN(true, LN_ONEPASS); break;
        case 4: LT_LN(false, LN_SCALE); break;
        case 5: LT_LN(true, LN_SCALE); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LT_LN
    return static_cast<int>(cudaGetLastError());
}

// ``variant``: the fc1 activation and the epilogue flags (VAR_*).
int lt_gemm(const void* a, const void* w, const void* bias, int m, int n, int k, int epilogue,
            const void* resid, const void* rmask, int variant, void* out, void* stream) {
    if (k % 8 != 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_gemm_bf16(epilogue, variant, a, w, bias, m, n, k, resid,
                                               rmask, out, static_cast<cudaStream_t>(stream)));
}

// s8 operands: a (m, k) and w (n, k) codes, xs (m,) and ws (n,) f32 scales,
// bias bf16. Outputs as the epilogues above; fc1's is f32.
int lt_gemm_s8(const void* a, const void* xs, const void* w, const void* ws, const void* bias,
               int m, int n, int k, int epilogue, const void* resid, const void* rmask,
               void* out, void* stream) {
    if (k % 16 != 0 || n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_gemm_s8(epilogue, a, w, bias, m, n, k, resid, rmask, out,
                                             xs, ws, static_cast<cudaStream_t>(stream)));
}

int lt_attn_fwd(const void* qkv, const void* key_mask, const void* head_gate, void* out,
                void* stats, int b, int l, int num_heads, float sm_scale, int deferred, int f32,
                void* stream);  // attention.cu

// This file's register-resident attention_kernel alone (l <= ATT_MAX_L):
// the ablated softmaxes' only form, and the exact and deferred ones' below
// ATT_ROUTE_EXACT / ATT_ROUTE_DEFERRED keys.
int lt_attention_resident(const void* qkv, const void* key_mask, const void* head_gate,
                          void* out, int b, int l, int num_heads, float sm_scale, int softmax,
                          void* stream) {
    const bf16* Q = static_cast<const bf16*>(qkv);
    const float* KM = static_cast<const float*>(key_mask);
    const float* HG = static_cast<const float*>(head_gate);
    bf16* O = static_cast<bf16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // register-resident score rows: pick the smallest key-tile count that
    // covers L (DeiT-S selection lengths 96..197 land on 7, 9 and 13)
    const int kt = att_lp(l) / 16;
    cudaError_t err;
    if (kt <= 4) err = launch_attention<4>(Q, KM, HG, O, b, l, num_heads, sm_scale, softmax, s);
    else if (kt <= 7) err = launch_attention<7>(Q, KM, HG, O, b, l, num_heads, sm_scale, softmax, s);
    else if (kt <= 9) err = launch_attention<9>(Q, KM, HG, O, b, l, num_heads, sm_scale, softmax, s);
    else if (kt <= 13) err = launch_attention<13>(Q, KM, HG, O, b, l, num_heads, sm_scale, softmax, s);
    else if (l <= ATT_MAX_L) err = launch_attention<16>(Q, KM, HG, O, b, l, num_heads, sm_scale, softmax, s);
    else err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

// ``head_gate``: (b, num_heads) f32 0/1 output gate, or null. ``softmax``:
// SM_EXACT, SM_DEFERRED (fast_math), SM_LINEAR or SM_NOMAX. The exact and
// deferred forms go to attention.cu's forward, which streams the keys,
// from ATT_ROUTE_EXACT / ATT_ROUTE_DEFERRED keys on, and to
// attention_kernel below; the ablations have no form there.
int lt_attention(const void* qkv, const void* key_mask, const void* head_gate, void* out, int b,
                 int l, int num_heads, float sm_scale, int softmax, void* stream) {
    static_assert(ATT_ROUTE_EXACT <= ATT_MAX_L + 1 && ATT_ROUTE_DEFERRED <= ATT_MAX_L + 1,
                  "attention_kernel takes L <= ATT_MAX_L");
    if ((softmax == SM_EXACT && l >= ATT_ROUTE_EXACT) ||
        (softmax == SM_DEFERRED && l >= ATT_ROUTE_DEFERRED))
        return lt_attn_fwd(qkv, key_mask, head_gate, out, nullptr, b, l, num_heads, sm_scale,
                           softmax == SM_DEFERRED, 0, stream);
    return lt_attention_resident(qkv, key_mask, head_gate, out, b, l, num_heads, sm_scale,
                                 softmax, stream);
}

int lt_gemm_rows(const void* a, const void* w, const void* bias, int m, int n, int k,
                 int epilogue, const void* resid, const void* rmask, int variant, void* out,
                 int ln_form, const void* ln_w, const void* ln_b, float eps, void* out2,
                 const void* tp_w, const void* tp_b, void* mask, int seq_len,
                 void* stream);  // vit_block_rows.cu

// One bf16 layer of B1 or B2 in one host call: the launches
// ops/vit_block.py::_layer_cuda lists, in its order, on ``stream``.
// ``params``: the layer's 12 tensors in LAYER_KEYS order (ln1, qkv, proj,
// ln2, fc1, fc2; weight then bias). ``h1``: this layer's LN1 output when
// the fc2 before it computed it, else null, and LN1 runs here with the
// token policy ``tp_w``/``tp_b`` (or null) composing its gate into
// ``kmask``. ``proj_rows``: proj runs with LN2 in its epilogue, else as a
// product and a LayerNorm launch. ``nxt_ln_w`` non-null: fc2 runs with the
// next layer's LN1 (and its token policy ``nxt_tp_w``/``nxt_tp_b``, or
// null) in its epilogue and writes that layer's h1 to ``h1_out``. The
// scratch buffers ``ws_h1``, ``ws_qkv``, ``ws_attn``, ``ws_x2`` (f32),
// ``ws_h2`` and ``ws_u`` hold (M, D), (M, 3D), (M, D), (M, D), (M, D) and
// (M, hidden) each. Returns the first launch's error, or 0.
int lt_vit_layer(const void* x, void* kmask, const void* rmask, const void* head_gate,
                 const void* h1, const void* const* params, const void* tp_w,
                 const void* tp_b, const void* nxt_ln_w, const void* nxt_ln_b,
                 const void* nxt_tp_w, const void* nxt_tp_b, int b, int l, int d, int hidden,
                 int num_heads, float sm_scale, float eps, int ln_form, int gemm_var,
                 int softmax, int proj_rows, void* ws_h1, void* ws_qkv, void* ws_attn,
                 void* ws_x2, void* ws_h2, void* ws_u, void* out, void* h1_out, void* stream) {
    const int m = b * l;
    const void *ln1_w = params[0], *ln1_b = params[1], *qkv_w = params[2],
               *qkv_b = params[3], *proj_w = params[4], *proj_b = params[5],
               *ln2_w = params[6], *ln2_b = params[7], *fc1_w = params[8],
               *fc1_b = params[9], *fc2_w = params[10], *fc2_b = params[11];
    int err = 0;
    if (h1 == nullptr) {
        err = lt_layernorm(x, 0, ws_h1, ln1_w, ln1_b, m, d, eps, ln_form, tp_w, tp_b,
                           tp_w != nullptr ? kmask : nullptr, l, stream);
        if (err) return err;
        h1 = ws_h1;
    }
    err = lt_gemm(h1, qkv_w, qkv_b, m, 3 * d, d, EPI_QKV, nullptr, rmask, gemm_var, ws_qkv,
                  stream);
    if (err) return err;
    err = lt_attention(ws_qkv, kmask, head_gate, ws_attn, b, l, num_heads, sm_scale, softmax,
                       stream);
    if (err) return err;
    if (proj_rows) {
        err = lt_gemm_rows(ws_attn, proj_w, proj_b, m, d, d, EPI_PROJ, x, rmask, gemm_var,
                           ws_x2, ln_form, ln2_w, ln2_b, eps, ws_h2, nullptr, nullptr,
                           nullptr, 1, stream);
    } else {
        err = lt_gemm(ws_attn, proj_w, proj_b, m, d, d, EPI_PROJ, x, rmask, gemm_var, ws_x2,
                      stream);
        if (err) return err;
        err = lt_layernorm(ws_x2, 1, ws_h2, ln2_w, ln2_b, m, d, eps, ln_form, nullptr, nullptr,
                           nullptr, l, stream);
    }
    if (err) return err;
    err = lt_gemm(ws_h2, fc1_w, fc1_b, m, hidden, d, EPI_FC1, nullptr, rmask, gemm_var, ws_u,
                  stream);
    if (err) return err;
    if (nxt_ln_w != nullptr)
        return lt_gemm_rows(ws_u, fc2_w, fc2_b, m, d, hidden, EPI_FC2, ws_x2, rmask, gemm_var,
                            out, ln_form, nxt_ln_w, nxt_ln_b, eps, h1_out, nxt_tp_w, nxt_tp_b,
                            kmask, l, stream);
    return lt_gemm(ws_u, fc2_w, fc2_b, m, d, hidden, EPI_FC2, ws_x2, rmask, gemm_var, out,
                   stream);
}

// A B2 segment of ``n`` layers in one host call: lt_vit_layer for each,
// ``mask`` (B, L) f32 both masks, layer i + 1 taking layer i's output and,
// with ``fc2_rows``, the h1 its fc2 computed with that layer's LN1 and
// token policy. ``params``: 12 pointers a layer as lt_vit_layer takes
// them; ``policies``: a layer's token policy (weight, bias) or two nulls.
// ``ws`` holds lt_vit_layer's six scratch buffers, then two (M, D) bf16
// buffers the layers' outputs alternate in and two their h1s alternate
// in; the last layer writes ``out``.
int lt_vit_segment(const void* x, void* mask, int n, const void* const* params,
                   const void* const* policies, int b, int l, int d, int hidden,
                   int num_heads, float sm_scale, float eps, int ln_form, int gemm_var,
                   int softmax, int proj_rows, int fc2_rows, void* const* ws, void* out,
                   void* stream) {
    const void* in = x;
    void* h1 = nullptr;
    for (int i = 0; i < n; ++i) {
        const bool fused = fc2_rows && i + 1 < n;
        const void* const* nxt = params + 12 * (i + 1);
        const void* const* ntp = policies + 2 * (i + 1);
        void* o = i + 1 < n ? ws[6 + (i & 1)] : out;
        void* h1_out = fused ? ws[8 + ((i + 1) & 1)] : nullptr;
        const int err = lt_vit_layer(
            in, mask, mask, nullptr, h1, params + 12 * i, policies[2 * i], policies[2 * i + 1],
            fused ? nxt[0] : nullptr, fused ? nxt[1] : nullptr, fused ? ntp[0] : nullptr,
            fused ? ntp[1] : nullptr, b, l, d, hidden, num_heads, sm_scale, eps, ln_form,
            gemm_var, softmax, proj_rows, ws[0], ws[1], ws[2], ws[3], ws[4], ws[5], o, h1_out,
            stream);
        if (err) return err;
        in = o;
        h1 = h1_out;
    }
    return 0;
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
