// The epilogues of the ViT block's weight products on the GEMM core
// (gemm_sm90.cuh), shared by csrc/vit_block.cu (the products alone:
// BlockEpilogue) and csrc/vit_block_rows.cu (the products with the row pass
// that follows them: RowEpilogue, on the core's cluster form), and the body
// variants and s8 row quantiser they use. See vit_block.cu for the layer.

#pragma once

#include "gemm_sm90.cuh"
#include "mma_common.cuh"

namespace {

// Body variants (template parameters; the production layer instantiates
// LN_TWOPASS / LN_ONEPASS, ACT_ERF / ACT_TANH, SM_EXACT / SM_DEFERRED with
// the row mask on and the residual in f32). The others are the ablations of
// the block-budget probe (tools/probe_block_budget.py, kernel P1).
enum LnForm { LN_TWOPASS = 0, LN_ONEPASS = 1, LN_SCALE = 2 };
enum Act { ACT_ERF = 0, ACT_TANH = 1, ACT_SILU = 2, ACT_NONE = 3 };
enum Softmax { SM_EXACT = 0, SM_DEFERRED = 1, SM_LINEAR = 2, SM_NOMAX = 3 };
// lt_gemm's ``variant``: bits 0-1 the fc1 activation, bit 2 drops the row
// mask from the proj and fc2 epilogues, bit 3 rounds the proj residual to
// bf16 (x2 = bf16(x + bf16((acc + b) * rmask))).
constexpr int VAR_NO_ROWMASK = 4, VAR_BF16_RES = 8;

constexpr float QEPS = 1e-6f;
constexpr float INV127 = static_cast<float>(1.0 / 127.0);

__device__ __forceinline__ int8_t quant_code(float y, float s) {
    return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f));
}

// quant_code with the divide as a multiply by inv = 1 / s where that gives
// the same code: |y / s| <= 127, so y * inv lies within 2e-5 of the true
// quotient, and rounds to the same integer as the correctly rounded divide
// unless it sits within 1e-4 of a half; those few take the divide. Bit for
// bit quant_code, at a fraction of its instructions (the GEMM epilogues
// run it while the tensor cores wait).
__device__ __forceinline__ int8_t quant_code_inv(float y, float s, float inv) {
    const float z = y * inv, q = rintf(z);
    const float c = fabsf(z - q) < 0.4999f ? q : rintf(__fdiv_rn(y, s));
    return static_cast<int8_t>(fminf(fmaxf(c, -127.f), 127.f));
}

// ---------------------------------------------------------------------------
// The layer's four weight products: C[m, n] = sum_k A[m, k] W[n, k] + bias[n]
// through one of the block's epilogues, on the GEMM core of gemm_sm90.cuh
// (TMA ring, warp-specialised wgmma, persistent tiles of 128 x BN). Rows
// past M and columns past N are zero-filled on load and not stored; N % 8
// == 0 (column pairs).
//
// bf16 operands: f32 sums, K % 8 == 0. s8 operands: exact s32 sums (127^2 *
// K < 2^31 up to K = 133,000), K % 16 == 0; the epilogue dequantises first,
// acc * xs[m] * ws[n] + bias[n], with separately rounded multiplies and add
// as the plain version computes it. Keep the epilogues' arithmetic and its
// order: tools/compare_b1_build.py holds B6's launches bit for bit to
// earlier builds.
// ---------------------------------------------------------------------------
enum Epilogue {
    EPI_QKV = 0,   // bf16(acc + b)
    EPI_PROJ = 1,  // f32: x + (acc + b) * rmask      (resid = bf16 x)
    EPI_FC1 = 2,   // bf16(GELU(acc + b)); s8 form: f32 erf GELU, unrounded
    EPI_FC2 = 3,   // bf16(x2 + (acc + b) * rmask)    (resid = f32 x2)
};

__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}
// fast_math's GELU, the tanh form with the hardware's tanh (tanh.approx,
// relative error <= 2^-10.9, below the bf16 rounding of u that follows): a
// single instruction where libdevice's tanhf takes about twenty, and fc1's
// epilogue, run while the tensor cores wait, is bound by its instruction
// count (PERF.md).
__device__ __forceinline__ float tanh_approx(float y) {
    float r;
    asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(y));
    return r;
}
__device__ __forceinline__ float gelu_tanh(float x) {
    return 0.5f * x * (1.f + tanh_approx(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu_gelu(float x) {
    return x / (1.f + expf(-1.702f * x));
}

template <int ACT>
__device__ __forceinline__ float act_fn(float x) {
    if constexpr (ACT == ACT_ERF) return gelu_erf(x);
    else if constexpr (ACT == ACT_TANH) return gelu_tanh(x);
    else if constexpr (ACT == ACT_SILU) return silu_gelu(x);
    else return x;
}

struct EpiArgs {
    const bf16* bias;
    const void* resid;
    const float* rmask;
    void* out;
    const float* xs;  // s8: per-row activation scales
    const float* ws;  // s8: per-column weight scales
    int n;            // row stride of resid and out
    // the row epilogues (RowEpilogue): the LayerNorm that follows, the
    // second output (bf16 rows or s8 codes) and its row scales, the next
    // layer's token policy and the mask it composes into
    const bf16* ln_w = nullptr;
    const bf16* ln_b = nullptr;
    float eps = 0.f;
    void* out2 = nullptr;
    float* scale = nullptr;
    const bf16* tp_w = nullptr;
    const bf16* tp_b = nullptr;
    float* mask = nullptr;
    int seq_len = 1;
};

template <int EPI, bool S8, int ACT = ACT_ERF, bool ROWMASK = true, bool BF16RES = false>
struct BlockEpilogue {
    EpiArgs p;
    struct Row {
        float rm, rs;
    };
    __device__ __forceinline__ Row row(int gm) const {
        Row r{1.f, 1.f};
        if constexpr ((EPI == EPI_PROJ || EPI == EPI_FC2) && ROWMASK) r.rm = p.rmask[gm];
        if constexpr (S8) r.rs = p.xs[gm];
        return r;
    }
    // f32 results (bf16 outputs are rounded by the store), the arithmetic
    // and its order as the plain version's
    template <typename Acc>
    __device__ __forceinline__ void apply(const Row& r, int gm, int gn, Acc& a0, Acc& a1) const {
        const size_t o = (size_t)gm * p.n + gn;
        const float rm = r.rm;
        float v0 = static_cast<float>(a0);
        float v1 = static_cast<float>(a1);
        if constexpr (S8) {
            const float2 w = *reinterpret_cast<const float2*>(p.ws + gn);
            v0 = __fmul_rn(__fmul_rn(v0, r.rs), w.x);
            v1 = __fmul_rn(__fmul_rn(v1, r.rs), w.y);
        }
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + gn));
        v0 = __fadd_rn(v0, b.x);
        v1 = __fadd_rn(v1, b.y);
        float2 y;
        if constexpr (EPI == EPI_FC1 && S8) {
            y = make_float2(gelu_erf(v0), gelu_erf(v1));
        } else if constexpr (EPI == EPI_QKV) {
            y = make_float2(v0, v1);
        } else if constexpr (EPI == EPI_PROJ) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.resid) + o));
            if constexpr (BF16RES) {
                y = make_float2(round_bf(x.x + round_bf(v0 * rm)), round_bf(x.y + round_bf(v1 * rm)));
            } else if constexpr (ROWMASK) {
                y = make_float2(x.x + v0 * rm, x.y + v1 * rm);
            } else {
                y = make_float2(x.x + v0, x.y + v1);
            }
        } else if constexpr (EPI == EPI_FC1) {
            y = make_float2(act_fn<ACT>(v0), act_fn<ACT>(v1));
        } else {
            const float2 x2 = *reinterpret_cast<const float2*>(static_cast<const float*>(p.resid) + o);
            y = ROWMASK ? make_float2(x2.x + v0 * rm, x2.y + v1 * rm) : make_float2(x2.x + v0, x2.y + v1);
        }
        set_float(a0, y.x);
        set_float(a1, y.y);
    }
    // f32 out for proj (x2) and the s8 fc1, bf16 (rounded here) otherwise
    static constexpr bool F32_OUT = EPI == EPI_PROJ || (EPI == EPI_FC1 && S8);
    static constexpr int OUT_BYTES = F32_OUT ? 4 : 2;
    template <typename Acc>
    __device__ __forceinline__ void stage(void* dst, Acc a0, Acc a1) const {
        if constexpr (F32_OUT) {
            *reinterpret_cast<float2*>(dst) = make_float2(as_float(a0), as_float(a1));
        } else {
            *reinterpret_cast<unsigned*>(dst) = pack_bf16(as_float(a0), as_float(a1));
        }
    }
    __device__ __forceinline__ void store16(int gm, int gn, uint4 v) const {
        *reinterpret_cast<uint4*>(static_cast<char*>(p.out) + ((size_t)gm * p.n + gn) * OUT_BYTES) = v;
    }
};

// ---------------------------------------------------------------------------
// The row epilogues: a product whose epilogue also runs the row pass that
// followed it as a launch of its own, on the GEMM core's cluster form (a
// cluster of CN = N / BN blocks holds whole rows and exchanges row
// statistics in distributed shared memory, gemm_sm90.cuh):
//   ROW_PROJ_LN   bf16 proj: x2 (f32) as EPI_PROJ, then h2 = bf16(LN2(bf16(x2)))
//   ROW_FC2_LN    bf16 fc2 inside a segment: out = bf16(x2 + (acc + b) * rmask)
//                 as EPI_FC2, then from that bf16 out the next layer's token
//                 gate (composed into mask[row] after this layer's row mask
//                 was read from it) and h1 = bf16(LN1(out))
//   ROW_PROJ_LNQ  s8 proj: x2 (f32) as EPI_PROJ, then LN2 of the unrounded x2
//                 quantised: s8 codes and the f32 row scale
//   ROW_FC1_Q     s8 fc1: u = erf GELU in f32 as EPI_FC1, quantised (u itself
//                 is never stored)
// The arithmetic is that of the launches they replace (layernorm_kernel,
// layernorm_quant_kernel, rowquant_kernel); only the order of the row sums
// differs (fragment order, then the quad, then the blocks in rank order).
// A max does not depend on order, so ROW_FC1_Q's codes and scales are
// those of EPI_FC1 followed by rowquant_kernel, bit for bit.
// ---------------------------------------------------------------------------
enum RowKind { ROW_PROJ_LN = 0, ROW_FC2_LN = 1, ROW_PROJ_LNQ = 2, ROW_FC1_Q = 3 };

template <int KIND, int LNF = LN_TWOPASS, bool ROWMASK = true, bool BF16RES = false>
struct RowEpilogue {
    static constexpr bool S8 = KIND == ROW_PROJ_LNQ || KIND == ROW_FC1_Q;
    static constexpr int EPI = KIND == ROW_FC2_LN ? EPI_FC2 : KIND == ROW_FC1_Q ? EPI_FC1 : EPI_PROJ;
    using Base = BlockEpilogue<EPI, S8, ACT_ERF, ROWMASK, BF16RES>;
    static_assert(KIND != ROW_FC2_LN || LNF != LN_SCALE, "a segment's LN1 has statistics");
    Base base;
    struct Row {
        typename Base::Row b;
        int gm;
        float mu, rs, qs, inv, keep;
    };
    // rounds: LayerNorm's mean, then (two-pass) the centred sum of
    // squares; the quantisers' max |y| last. The gate's two logits ride on
    // the first round of ROW_FC2_LN.
    static constexpr int LN_ROUNDS = LNF == LN_TWOPASS ? 2 : LNF == LN_ONEPASS ? 1 : 0;
    static constexpr int ROUNDS = KIND == ROW_FC1_Q ? 1 : KIND == ROW_PROJ_LNQ ? 3 : LN_ROUNDS;
    static constexpr int GATE = 1 + (LNF == LN_ONEPASS);  // the logits' slots
    static constexpr int NSTAT = KIND == ROW_FC2_LN ? GATE + 2 : LNF == LN_ONEPASS ? 2 : 1;
    static constexpr int OUT_BYTES = KIND == ROW_FC1_Q ? 0 : Base::OUT_BYTES;
    static constexpr int OUT2_BYTES = S8 ? 1 : 2;
    __host__ __device__ static constexpr bool is_max(int r) {
        return KIND == ROW_FC1_Q || (KIND == ROW_PROJ_LNQ && r == 2);
    }
    // B6's LN2 replaces x2 in the registers once its statistics are known
    // (x2 itself has been stored): the max and the codes then read it
    __host__ __device__ static constexpr bool transforms(int r) {
        return KIND == ROW_PROJ_LNQ && r == 1;
    }

    __device__ __forceinline__ Row row(int gm) const {
        Row r;
        r.b = base.row(gm);
        r.gm = gm;
        r.keep = 1.f;
        return r;
    }
    template <typename Acc>
    __device__ __forceinline__ void apply(const Row& r, int gm, int gn, Acc& a0, Acc& a1) const {
        base.apply(r.b, gm, gn, a0, a1);
    }
    template <typename Acc>
    __device__ __forceinline__ void stage(void* dst, Acc a0, Acc a1) const {
        base.stage(dst, a0, a1);
    }
    __device__ __forceinline__ void store16(int gm, int gn, uint4 v) const { base.store16(gm, gn, v); }

    // the value the row pass reads: the bf16 LayerNorm input (B1 rounds x2
    // first, vit_block.py:436; fc2's out is stored as bf16), or the
    // unrounded f32 (B6)
    template <typename Acc>
    __device__ __forceinline__ static float value(Acc a) {
        return S8 ? as_float(a) : round_bf(as_float(a));
    }
    template <typename Acc>
    __device__ __forceinline__ void transform(const Row& r, int gn, Acc& a0, Acc& a1) const {
        const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base.p.ln_w + gn));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base.p.ln_b + gn));
        set_float(a0, __fadd_rn(__fmul_rn(__fmul_rn(as_float(a0) - r.mu, r.rs), w.x), b.x));
        set_float(a1, __fadd_rn(__fmul_rn(__fmul_rn(as_float(a1) - r.mu, r.rs), w.y), b.y));
    }
    template <typename Acc>
    __device__ __forceinline__ void stat(int round, const Row& r, int gn, Acc a0, Acc a1,
                                         float (&part)[NSTAT]) const {
        const float v[2] = {value(a0), value(a1)};
        float2 g0 = make_float2(0.f, 0.f), g1 = g0;  // the gate's weights
        if constexpr (KIND == ROW_FC2_LN) {
            if (round == 0 && base.p.tp_w != nullptr) {
                g0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base.p.tp_w + gn));
                g1 = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(base.p.tp_w + base.p.n + gn));
            }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if constexpr (KIND == ROW_FC1_Q) {
                part[0] = fmaxf(part[0], fabsf(v[e]));
            } else if constexpr (KIND == ROW_PROJ_LNQ) {
                if (round == 0) {
                    part[0] += v[e];
                } else if (round == 1) {
                    const float c = v[e] - r.mu;
                    part[0] += __fmul_rn(c, c);
                } else {
                    part[0] = fmaxf(part[0], fabsf(v[e]));  // LN2, in place
                }
            } else {
                if (round == 0) {
                    part[0] += v[e];
                    if constexpr (LNF == LN_ONEPASS) part[1] += v[e] * v[e];
                    if constexpr (KIND == ROW_FC2_LN) {
                        if (base.p.tp_w != nullptr) {
                            part[GATE] += v[e] * (e ? g0.y : g0.x);
                            part[GATE + 1] += v[e] * (e ? g1.y : g1.x);
                        }
                    }
                } else {
                    const float c = v[e] - r.mu;
                    part[0] += c * c;
                }
            }
        }
    }
    __device__ __forceinline__ void fold(int round, Row& r, const float (&total)[NSTAT]) const {
        const int d = base.p.n;
        if constexpr (S8) {
            if (KIND == ROW_FC1_Q || round == 2) {
                r.qs = __fmul_rn(fmaxf(total[0], QEPS), INV127);
                r.inv = 1.f / r.qs;
            } else if (round == 0) {
                r.mu = total[0] / d;
            } else {
                r.rs = rsqrtf(total[0] / d + base.p.eps);
            }
        } else if (round == 0) {
            r.mu = total[0] / d;
            if constexpr (LNF == LN_ONEPASS)
                r.rs = rsqrtf(fmaxf(total[1] / d - r.mu * r.mu, 0.f) + base.p.eps);
            if constexpr (KIND == ROW_FC2_LN) {
                if (base.p.tp_w != nullptr) {
                    // logits round to bf16 BEFORE the bias add and the
                    // compare (vit_block.py:589-594), as layernorm_kernel
                    const float l0 = round_bf(round_bf(total[GATE]) + bf(base.p.tp_b[0]));
                    const float l1 = round_bf(round_bf(total[GATE + 1]) + bf(base.p.tp_b[1]));
                    r.keep = (l0 >= l1) || (r.gm % base.p.seq_len == 0) ? 1.f : 0.f;
                }
            }
        } else {
            r.rs = rsqrtf(total[0] / d + base.p.eps);
        }
    }
    template <typename Acc>
    __device__ __forceinline__ void stage2(void* dst, const Row& r, int gn, Acc a0, Acc a1) const {
        const float v0 = value(a0), v1 = value(a1);
        if constexpr (S8) {  // u, or LN2 of x2 in place
            *reinterpret_cast<char2*>(dst) =
                make_char2(quant_code_inv(v0, r.qs, r.inv), quant_code_inv(v1, r.qs, r.inv));
        } else {
            const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base.p.ln_w + gn));
            float h0, h1;
            if constexpr (LNF == LN_SCALE) {
                h0 = v0 * w.x;
                h1 = v1 * w.y;
            } else {
                const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base.p.ln_b + gn));
                h0 = (v0 - r.mu) * r.rs * w.x + b.x;
                h1 = (v1 - r.mu) * r.rs * w.y + b.y;
            }
            *reinterpret_cast<unsigned*>(dst) = pack_bf16(h0, h1);
        }
    }
    __device__ __forceinline__ void store2_16(int gm, int gn, uint4 v) const {
        *reinterpret_cast<uint4*>(static_cast<char*>(base.p.out2) +
                                  ((size_t)gm * base.p.n + gn) * OUT2_BYTES) = v;
    }
    __device__ __forceinline__ void row_done(const Row& r, int gm) const {
        if constexpr (S8) base.p.scale[gm] = r.qs;
        if constexpr (KIND == ROW_FC2_LN) {
            if (base.p.tp_w != nullptr) base.p.mask[gm] = base.p.mask[gm] * r.keep;
        }
    }
};

}  // namespace
