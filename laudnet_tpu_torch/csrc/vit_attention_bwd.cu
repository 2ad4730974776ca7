// Backward of the masked multi-head attention over a packed qkv projection
// for Hopper (sm_90a), dh = 64, L <= 256, bf16.
//
// Replaces the TPU kernel
//   laudnet_tpu/ops/pallas/vit_attention.py::_fused_bwd_strips   (B5)
// (reached through _fused_bwd and _vjp_bwd). The TPU kernel takes a head
// PAIR per grid step so that its strips are 128 lanes wide, masks each half
// of the pair, and pads a zero head when the head count is odd; none of
// that has a counterpart here: one block takes one (image, head) whatever
// the head count.
//
// What it computes, per image and head, with P the forward's softmax
// recomputed in f32 (scores scaled, -1e9 added at masked keys, exact form):
//   dO_eff = bf16(dO * gate)            (dO when there is no gate)
//   dV = bf16(P)^T . dO_eff
//   dP = dO_eff . V^T
//   dS = P o (dP - rowsum(dP o P))      (f32, P unrounded)
//   dQ = bf16(dS) . K * scale
//   dK = bf16(dS)^T . Q * scale
//   dgate[b, h] = sum_rows sum_dh (bf16(P) . V) o dO       (UNGATED dO)
// The key mask gets no gradient.
//
// What bounds it on the H100: bytes. At DeiT-S bs128 (L = 197) it reads qkv
// (58 MB) and dO (19 MB) and writes dqkv (58 MB) against ~23 GFLOP in five
// or six products, far below the bf16 ridge. So every (L, L) intermediate
// stays on the SM: Q, K, V and dO_eff of one head live in shared memory
// (4 x 208 x 72 x 2 B = 120 KB at L = 197), loaded once.
//
// Design: two passes in one block of 8 warps, no atomics, deterministic.
//   Pass 1, a warp per tile of 16 query rows: S and P for all keys in
//   registers exactly as the forward kernel computes them (same sum order,
//   so the same bits), the row max and sum kept in shared memory; with a
//   gate, O = bf16(P) . V and the warp's share of dgate against the ungated
//   dO read from device memory; then two sweeps over the key tiles, the
//   first for delta = rowsum(dP o P), the second recomputing dP for
//   dS and dQ += bf16(dS) . K.
//   Pass 2, a warp per tile of 16 keys: for each chunk of 16 queries it
//   recomputes S^T = K Q^T, P^T from the stored row statistics, dP^T =
//   V dO_eff^T and dS^T, and accumulates dV += bf16(P^T) . dO_eff and
//   dK += bf16(dS^T) . Q. The accumulator layout of a 16 x 16 tile is the
//   A-operand layout of the next product, so P and dS go to the tensor
//   cores from registers.
// Keys past L (tile padding) carry -inf, so their p and dS are exactly 0 and
// their dK, dV rows are not stored; query rows past L are zero in Q and dO,
// and their p and dS are forced to 0 in pass 2.

#include "mma_common.cuh"

namespace {

constexpr int DH = 64, KLD = DH + 8, BWARPS = 8;
constexpr int ATT_MAX_L = 256;

__host__ __device__ __forceinline__ int att_lp(int l) { return (l + 15) / 16 * 16; }
__host__ __forceinline__ size_t bwd_smem_bytes(int l) {
    return (size_t)4 * att_lp(l) * KLD * sizeof(bf16) + (size_t)4 * att_lp(l) * sizeof(float) +
           BWARPS * sizeof(float);
}

// bf16x2 * gate, rounded once
__device__ __forceinline__ unsigned scale_bf16x2(unsigned raw, float gate) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    return pack_bf16(v.x * gate, v.y * gate);
}

template <int KT16>
__global__ void __launch_bounds__(BWARPS * 32)
attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_mask,
                     const float* __restrict__ head_gate, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, float* __restrict__ dhead, int L, int H,
                     float sm_scale) {
    extern __shared__ __align__(128) unsigned char bwd_smem[];
    const int lp = att_lp(L);
    bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
    bf16* Ks = Qs + lp * KLD;
    bf16* Vs = Ks + lp * KLD;
    bf16* dOs = Vs + lp * KLD;
    float* negs = reinterpret_cast<float*>(dOs + lp * KLD);
    float* rowm = negs + lp;
    float* rowsum = rowm + lp;
    float* rowdelta = rowsum + lp;
    float* wpart = rowdelta + lp;

    const int h = blockIdx.x, b = blockIdx.y;
    const int D = H * DH, row3 = 3 * D;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bf16* base = qkv + (size_t)b * L * row3;
    const bf16* dobase = dout + (size_t)b * L * D + h * DH;
    const bool gated = head_gate != nullptr;
    const float gate = gated ? head_gate[(size_t)b * H + h] : 1.f;

    // Q, K, V and dO_eff rows [0, lp); rows past L are zero.
    for (int c = tid; c < lp * 8; c += BWARPS * 32) {
        const int r = c >> 3, col = (c & 7) * 8;
        const bool ok = r < L;
        const size_t src = (size_t)(ok ? r : 0) * row3 + h * DH + col;
        cp_async16(Qs + r * KLD + col, base + src, ok);
        cp_async16(Ks + r * KLD + col, base + src + D, ok);
        cp_async16(Vs + r * KLD + col, base + src + 2 * D, ok);
        if (!gated) {
            cp_async16(dOs + r * KLD + col, dobase + (size_t)(ok ? r : 0) * D + col, ok);
        } else {
            uint4 raw = make_uint4(0u, 0u, 0u, 0u);
            if (ok) {
                raw = *reinterpret_cast<const uint4*>(dobase + (size_t)r * D + col);
                raw.x = scale_bf16x2(raw.x, gate);
                raw.y = scale_bf16x2(raw.y, gate);
                raw.z = scale_bf16x2(raw.z, gate);
                raw.w = scale_bf16x2(raw.w, gate);
            }
            *reinterpret_cast<uint4*>(dOs + r * KLD + col) = raw;
        }
    }
    cp_async_commit();
    for (int c = tid; c < lp; c += BWARPS * 32)
        negs[c] = c < L ? (1.f - key_mask[(size_t)b * L + c]) * NEG : -INFINITY;
    cp_async_wait<0>();
    __syncthreads();

    const int nkt = lp / 16;

    // ---------------- pass 1: query tiles -> stats, dgate, dQ ----------------
    float dg = 0.f;
    for (int qt = warp; qt < nkt; qt += BWARPS) {
        const int q0 = qt * 16;
        // S = Q K^T, the forward kernel's code: the same sums in the same order
        float s[2 * KT16][4];
        {
            unsigned qf[DH / 16][4];
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk)
                ldsm_x4(qf[kk], Qs + (q0 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < KT16; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
                if (j < nkt) {
#pragma unroll
                    for (int kk = 0; kk < DH / 16; ++kk) {
                        unsigned kf[4];
                        ldsm_x4(kf, Ks + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD +
                                        kk * 16 + ((lane >> 3) & 1) * 8);
                        mma16816(s[2 * j], qf[kk], kf[0], kf[1]);
                        mma16816(s[2 * j + 1], qf[kk], kf[2], kf[3]);
                    }
                }
            }
        }
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
                s[n][e] = expf(s[n][e] - mx[e >> 1]);
                sum[e >> 1] += s[n][e];
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
            sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        }
#pragma unroll
        for (int n = 0; n < 2 * KT16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / sum[e >> 1];  // p, f32
        if (t == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                rowm[q0 + g + r * 8] = mx[r];
                rowsum[q0 + g + r * 8] = sum[r];
            }
        }

        // acc: first O = bf16(P) V for dgate, then dQ
        float acc[DH / 8][4];
        if (gated) {
#pragma unroll
            for (int n = 0; n < DH / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
            for (int j = 0; j < KT16; ++j) {
                if (j < nkt) {
                    unsigned pf[4];
                    pf[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
                    pf[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
                    pf[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
                    pf[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
                    for (int n = 0; n < DH / 16; ++n) {
                        unsigned vf[4];
                        ldsm_x4_trans(vf, Vs + (j * 16 + (lane & 15)) * KLD + n * 16 +
                                              (lane >> 4) * 8);
                        mma16816(acc[2 * n], pf, vf[0], vf[1]);
                        mma16816(acc[2 * n + 1], pf, vf[2], vf[3]);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int q = q0 + g + r * 8;
                if (q >= L) continue;
                const bf16* src = dobase + (size_t)q * D + t * 2;
#pragma unroll
                for (int n = 0; n < DH / 8; ++n) {
                    const float2 d2 = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(src + n * 8));
                    dg += acc[n][r * 2] * d2.x + acc[n][r * 2 + 1] * d2.y;
                }
            }
        }

        unsigned dof[DH / 16][4];
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
            ldsm_x4(dof[kk], dOs + (q0 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);

        // sweep 1: delta = rowsum(dP o P)
        float delta[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KT16; ++j) {
            if (j < nkt) {
                float dp0[4] = {0.f, 0.f, 0.f, 0.f}, dp1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk) {
                    unsigned vf[4];
                    ldsm_x4(vf, Vs + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
                    mma16816(dp0, dof[kk], vf[0], vf[1]);
                    mma16816(dp1, dof[kk], vf[2], vf[3]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    delta[e >> 1] += dp0[e] * s[2 * j][e] + dp1[e] * s[2 * j + 1][e];
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
            delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
        }
        if (t == 0) {
            rowdelta[q0 + g] = delta[0];
            rowdelta[q0 + g + 8] = delta[1];
        }

        // sweep 2: dS = P o (dP - delta), dQ += bf16(dS) K
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < KT16; ++j) {
            if (j < nkt) {
                float dp0[4] = {0.f, 0.f, 0.f, 0.f}, dp1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk) {
                    unsigned vf[4];
                    ldsm_x4(vf, Vs + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
                    mma16816(dp0, dof[kk], vf[0], vf[1]);
                    mma16816(dp1, dof[kk], vf[2], vf[3]);
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    dp0[e] = s[2 * j][e] * (dp0[e] - delta[e >> 1]);
                    dp1[e] = s[2 * j + 1][e] * (dp1[e] - delta[e >> 1]);
                }
                unsigned dsf[4];
                dsf[0] = pack_bf16(dp0[0], dp0[1]);
                dsf[1] = pack_bf16(dp0[2], dp0[3]);
                dsf[2] = pack_bf16(dp1[0], dp1[1]);
                dsf[3] = pack_bf16(dp1[2], dp1[3]);
#pragma unroll
                for (int n = 0; n < DH / 16; ++n) {
                    unsigned kf[4];
                    ldsm_x4_trans(kf, Ks + (j * 16 + (lane & 15)) * KLD + n * 16 +
                                          (lane >> 4) * 8);
                    mma16816(acc[2 * n], dsf, kf[0], kf[1]);
                    mma16816(acc[2 * n + 1], dsf, kf[2], kf[3]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int q = q0 + g + r * 8;
            if (q >= L) continue;
            bf16* dst = dqkv + ((size_t)b * L + q) * row3 + h * DH + t * 2;
#pragma unroll
            for (int n = 0; n < DH / 8; ++n)
                *reinterpret_cast<unsigned*>(dst + n * 8) =
                    pack_bf16(acc[n][r * 2] * sm_scale, acc[n][r * 2 + 1] * sm_scale);
        }
    }
    if (gated) {
        dg = warp_sum(dg);
        if (lane == 0) wpart[warp] = dg;
    }
    __syncthreads();  // row statistics and dgate shares are in shared memory
    if (gated && tid == 0) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < BWARPS; ++w) total += wpart[w];
        dhead[(size_t)b * H + h] = total;
    }

    // ---------------- pass 2: key tiles -> dK, dV ----------------------------
    for (int kt = warp; kt < nkt; kt += BWARPS) {
        const int k0 = kt * 16;
        unsigned kf[DH / 16][4], vf[DH / 16][4];
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            ldsm_x4(kf[kk], Ks + (k0 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
            ldsm_x4(vf[kk], Vs + (k0 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
        }
        const float negk[2] = {negs[k0 + g], negs[k0 + g + 8]};
        float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
        for (int n = 0; n < DH / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

        for (int c = 0; c < nkt; ++c) {
            float st[2][4], dpt[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
                unsigned qf[4], df[4];
                const int off = (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD + kk * 16 +
                                ((lane >> 3) & 1) * 8;
                ldsm_x4(qf, Qs + off);
                ldsm_x4(df, dOs + off);
                mma16816(st[0], kf[kk], qf[0], qf[1]);
                mma16816(st[1], kf[kk], qf[2], qf[3]);
                mma16816(dpt[0], vf[kk], df[0], df[1]);
                mma16816(dpt[1], vf[kk], df[2], df[3]);
            }
            // rows are keys (g, g + 8), columns queries
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int q = c * 16 + nt * 8 + t * 2 + (e & 1);
                    float p = 0.f;
                    if (q < L)
                        p = expf(st[nt][e] * sm_scale + negk[e >> 1] - rowm[q]) / rowsum[q];
                    st[nt][e] = p;
                    dpt[nt][e] = p * (dpt[nt][e] - rowdelta[q]);
                }
            unsigned pf[4], dsf[4];
            pf[0] = pack_bf16(st[0][0], st[0][1]);
            pf[1] = pack_bf16(st[0][2], st[0][3]);
            pf[2] = pack_bf16(st[1][0], st[1][1]);
            pf[3] = pack_bf16(st[1][2], st[1][3]);
            dsf[0] = pack_bf16(dpt[0][0], dpt[0][1]);
            dsf[1] = pack_bf16(dpt[0][2], dpt[0][3]);
            dsf[2] = pack_bf16(dpt[1][0], dpt[1][1]);
            dsf[3] = pack_bf16(dpt[1][2], dpt[1][3]);
#pragma unroll
            for (int n = 0; n < DH / 16; ++n) {
                unsigned qf[4], df[4];
                const int off = (c * 16 + (lane & 15)) * KLD + n * 16 + (lane >> 4) * 8;
                ldsm_x4_trans(df, dOs + off);
                ldsm_x4_trans(qf, Qs + off);
                mma16816(dv[2 * n], pf, df[0], df[1]);
                mma16816(dv[2 * n + 1], pf, df[2], df[3]);
                mma16816(dk[2 * n], dsf, qf[0], qf[1]);
                mma16816(dk[2 * n + 1], dsf, qf[2], qf[3]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int key = k0 + g + r * 8;
            if (key >= L) continue;
            bf16* dst = dqkv + ((size_t)b * L + key) * row3 + D + h * DH + t * 2;
#pragma unroll
            for (int n = 0; n < DH / 8; ++n) {
                *reinterpret_cast<unsigned*>(dst + n * 8) =
                    pack_bf16(dk[n][r * 2] * sm_scale, dk[n][r * 2 + 1] * sm_scale);
                *reinterpret_cast<unsigned*>(dst + D + n * 8) =
                    pack_bf16(dv[n][r * 2], dv[n][r * 2 + 1]);
            }
        }
    }
}

template <int KT16>
cudaError_t launch_attention_bwd(const bf16* qkv, const float* key_mask, const float* head_gate,
                                 const bf16* dout, bf16* dqkv, float* dhead, int b, int l,
                                 int num_heads, float sm_scale, cudaStream_t stream) {
    const size_t smem = bwd_smem_bytes(l);
    const cudaError_t err =
        cudaFuncSetAttribute(attention_bwd_kernel<KT16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(num_heads, b), block(BWARPS * 32);
    attention_bwd_kernel<KT16><<<grid, block, smem, stream>>>(qkv, key_mask, head_gate, dout, dqkv,
                                                              dhead, l, num_heads, sm_scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// ``head_gate``: (b, num_heads) f32 gate or null; ``dhead``: (b, num_heads)
// f32, written only with a gate. ``dout``: (b, l, D) bf16, contiguous.
int lt_attention_bwd(const void* qkv, const void* key_mask, const void* head_gate,
                     const void* dout, void* dqkv, void* dhead, int b, int l, int num_heads,
                     float sm_scale, void* stream) {
    const bf16* Q = static_cast<const bf16*>(qkv);
    const float* KM = static_cast<const float*>(key_mask);
    const float* HG = static_cast<const float*>(head_gate);
    const bf16* DO = static_cast<const bf16*>(dout);
    bf16* DQ = static_cast<bf16*>(dqkv);
    float* DH_ = static_cast<float*>(dhead);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int kt = att_lp(l) / 16;
    cudaError_t err;
    if (kt <= 4) err = launch_attention_bwd<4>(Q, KM, HG, DO, DQ, DH_, b, l, num_heads, sm_scale, s);
    else if (kt <= 7) err = launch_attention_bwd<7>(Q, KM, HG, DO, DQ, DH_, b, l, num_heads, sm_scale, s);
    else if (kt <= 9) err = launch_attention_bwd<9>(Q, KM, HG, DO, DQ, DH_, b, l, num_heads, sm_scale, s);
    else if (kt <= 13) err = launch_attention_bwd<13>(Q, KM, HG, DO, DQ, DH_, b, l, num_heads, sm_scale, s);
    else if (l <= ATT_MAX_L) err = launch_attention_bwd<16>(Q, KM, HG, DO, DQ, DH_, b, l, num_heads, sm_scale, s);
    else err = cudaErrorInvalidValue;
    return static_cast<int>(err);
}

}  // extern "C"
