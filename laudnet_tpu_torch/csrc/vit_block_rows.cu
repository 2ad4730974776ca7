// The ViT block's products with the row pass that follows them in their
// epilogue (vit_block_epi.cuh::RowEpilogue) on the GEMM core's cluster
// form (gemm_sm90.cuh): proj with LN2 (bf16; s8 with LN2's quantiser), a
// segment's fc2 with the next layer's token gate and LN1, the s8 fc1 with
// its row quantiser. A source of its own so that its instantiations
// compile beside vit_block.cu's, not after them. Replaces, with
// vit_block.cu, the TPU kernels
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_block       (B1)
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_segment     (B2)
//   laudnet_tpu/ops/pallas/vit_block.py::fused_vit_block_int8  (B6)
// Every C entry point returns cudaGetLastError() or the launch's error.

#include "vit_block_epi.cuh"

namespace {

// The row epilogues' launches. A cluster holds whole rows: N = CN * BN.
// The products D wide take the tile width of launch_block_gemm and CN = 2
// (DeiT-S's 384 = 2 x 192, T2T-ViT-19's 448 = 2 x 224; P1's ablated bodies
// at 192 only). The s8 fc1 takes BN = 192 and CN = 2, 7 or 8 (hidden 384,
// T2T-ViT-19's 1344, DeiT-S's 1536). The card fits 15 clusters of 8 (and
// of 7): 120 of its 132 SMs, 13.1 waves of DeiT-S's 197 row blocks
// against 11.94 for the product alone. Six tiles of 256 fit 17 clusters
// (102 SMs) and ran the DeiT-S fc1 at 0.3525 ms against 0.2253 for eight
// of 192 (PERF.md). Any other width is refused here
// (cudaErrorInvalidValue); the caller runs it as separate launches, the
// product (lt_gemm, lt_gemm_s8) and then the row pass (lt_layernorm,
// lt_layernorm_quant, lt_rowquant), by the same rule
// (ops/vit_block.py::row_cluster).
int row_cluster(int n, bool wide, bool fc1) {
    if (fc1) {
        const int cn = n % 192 == 0 ? n / 192 : 0;
        return cn == 2 || cn == 7 || cn == 8 ? cn : 0;
    }
    const int bn = wide && n % 224 == 0 && n % 192 != 0 ? 224 : 192;
    return n == 2 * bn ? 2 : 0;
}

cudaError_t dispatch_gemm_rows(int epilogue, int variant, int ln_form, const void* a,
                               const void* w, int m, int n, int k, const EpiArgs& p,
                               cudaStream_t s) {
    const bool rowmask = !(variant & VAR_NO_ROWMASK), bf16res = variant & VAR_BF16_RES;
    const bool wide = rowmask && !bf16res && ln_form != LN_SCALE;
    if (row_cluster(n, wide, false) != 2 || (bf16res && !rowmask)) return cudaErrorInvalidValue;
    const bool w224 = n == 448 && wide;
#define LT_ROWS(BN, ...) \
    launch_gemm_sm90<bf16, BN, 2>(a, w, m, n, k, RowEpilogue<__VA_ARGS__>{{p}}, s)
#define LT_ROWS_WIDE(...) (w224 ? LT_ROWS(224, __VA_ARGS__) : LT_ROWS(192, __VA_ARGS__))
    if (epilogue == EPI_FC2) {
        if (!rowmask || bf16res) return cudaErrorInvalidValue;
        if (ln_form == LN_TWOPASS) return LT_ROWS_WIDE(ROW_FC2_LN, LN_TWOPASS);
        if (ln_form == LN_ONEPASS) return LT_ROWS_WIDE(ROW_FC2_LN, LN_ONEPASS);
        return cudaErrorInvalidValue;
    }
    if (epilogue != EPI_PROJ) return cudaErrorInvalidValue;
    switch (ln_form * 3 + (bf16res ? 2 : rowmask ? 0 : 1)) {
        case LN_TWOPASS * 3: return LT_ROWS_WIDE(ROW_PROJ_LN, LN_TWOPASS);
        case LN_ONEPASS * 3: return LT_ROWS_WIDE(ROW_PROJ_LN, LN_ONEPASS);
        case LN_SCALE * 3: return LT_ROWS(192, ROW_PROJ_LN, LN_SCALE);
        case LN_TWOPASS * 3 + 1: return LT_ROWS(192, ROW_PROJ_LN, LN_TWOPASS, false);
        case LN_ONEPASS * 3 + 1: return LT_ROWS(192, ROW_PROJ_LN, LN_ONEPASS, false);
        case LN_SCALE * 3 + 1: return LT_ROWS(192, ROW_PROJ_LN, LN_SCALE, false);
        case LN_TWOPASS * 3 + 2: return LT_ROWS(192, ROW_PROJ_LN, LN_TWOPASS, true, true);
        case LN_ONEPASS * 3 + 2: return LT_ROWS(192, ROW_PROJ_LN, LN_ONEPASS, true, true);
        case LN_SCALE * 3 + 2: return LT_ROWS(192, ROW_PROJ_LN, LN_SCALE, true, true);
        default: return cudaErrorInvalidValue;
    }
#undef LT_ROWS_WIDE
#undef LT_ROWS
}

cudaError_t dispatch_gemm_s8_rows(int epilogue, const void* a, const void* w, int m, int n,
                                  int k, const EpiArgs& p, cudaStream_t s) {
#define LT_ROWS(BN, CN, KIND) \
    launch_gemm_sm90<int8_t, BN, CN>(a, w, m, n, k, RowEpilogue<KIND>{{p}}, s)
    if (epilogue == EPI_PROJ) {
        if (row_cluster(n, true, false) != 2) return cudaErrorInvalidValue;
        return n == 448 ? LT_ROWS(224, 2, ROW_PROJ_LNQ) : LT_ROWS(192, 2, ROW_PROJ_LNQ);
    }
    if (epilogue != EPI_FC1) return cudaErrorInvalidValue;
    switch (row_cluster(n, false, true)) {
        case 2: return LT_ROWS(192, 2, ROW_FC1_Q);
        case 7: return LT_ROWS(192, 7, ROW_FC1_Q);
        case 8: return LT_ROWS(192, 8, ROW_FC1_Q);
        default: return cudaErrorInvalidValue;
    }
#undef LT_ROWS
}

}  // namespace

extern "C" {

// A product with its row pass (bf16): ``epilogue`` EPI_PROJ writes x2 to
// ``out`` and h2 = bf16(LN2(bf16(x2))) (``ln_w``, ``ln_b``, ``ln_form``) to
// ``out2``; EPI_FC2 writes out (bf16) and h1 = bf16(LN1(out)) of the next
// layer, and with a token policy (``tp_w`` (2, n), ``tp_b`` (2,), else
// null) multiplies that layer's gate into ``mask`` (row % seq_len == 0
// kept). Only the widths of row_cluster; others return
// cudaErrorInvalidValue.
int lt_gemm_rows(const void* a, const void* w, const void* bias, int m, int n, int k,
                 int epilogue, const void* resid, const void* rmask, int variant, void* out,
                 int ln_form, const void* ln_w, const void* ln_b, float eps, void* out2,
                 const void* tp_w, const void* tp_b, void* mask, int seq_len, void* stream) {
    if (k % 8 != 0 || seq_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
    EpiArgs p{static_cast<const bf16*>(bias), resid, static_cast<const float*>(rmask), out,
              nullptr, nullptr, n};
    p.ln_w = static_cast<const bf16*>(ln_w);
    p.ln_b = static_cast<const bf16*>(ln_b);
    p.eps = eps;
    p.out2 = out2;
    p.tp_w = static_cast<const bf16*>(tp_w);
    p.tp_b = static_cast<const bf16*>(tp_b);
    p.mask = static_cast<float*>(mask);
    p.seq_len = seq_len;
    return static_cast<int>(dispatch_gemm_rows(epilogue, variant, ln_form, a, w, m, n, k, p,
                                               static_cast<cudaStream_t>(stream)));
}

// An s8 product with its row pass: EPI_PROJ writes x2 (f32) to ``out`` and
// the s8 codes of LN2(x2) (unrounded, two-pass) to ``q``, their f32 row
// scales to ``scale``; EPI_FC1 writes only the codes and scales of its
// erf GELU output. Only the widths of row_cluster.
int lt_gemm_s8_rows(const void* a, const void* xs, const void* w, const void* ws,
                    const void* bias, int m, int n, int k, int epilogue, const void* resid,
                    const void* rmask, void* out, const void* ln_w, const void* ln_b, float eps,
                    void* q, void* scale, void* stream) {
    if (k % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    EpiArgs p{static_cast<const bf16*>(bias), resid, static_cast<const float*>(rmask), out,
              static_cast<const float*>(xs), static_cast<const float*>(ws), n};
    p.ln_w = static_cast<const bf16*>(ln_w);
    p.ln_b = static_cast<const bf16*>(ln_b);
    p.eps = eps;
    p.out2 = q;
    p.scale = static_cast<float*>(scale);
    return static_cast<int>(dispatch_gemm_s8_rows(epilogue, a, w, m, n, k, p,
                                                  static_cast<cudaStream_t>(stream)));
}

// What cudaOccupancyMaxActiveClusters returns for the row epilogue
// ``kind`` (RowKind, the production body) at width n: the persistent grid
// of its launches, in clusters (a negative CUDA error, or 0 where row_cluster
// refuses n).
int lt_gemm_clusters(int kind, int n) {
    const bool w224 = n == 448;
    switch (kind) {
        case ROW_PROJ_LN:
            if (row_cluster(n, true, false) != 2) return 0;
            return w224 ? gemm_clusters_that_fit<bf16, 224, 2, RowEpilogue<ROW_PROJ_LN>>()
                        : gemm_clusters_that_fit<bf16, 192, 2, RowEpilogue<ROW_PROJ_LN>>();
        case ROW_FC2_LN:
            if (row_cluster(n, true, false) != 2) return 0;
            return w224 ? gemm_clusters_that_fit<bf16, 224, 2, RowEpilogue<ROW_FC2_LN>>()
                        : gemm_clusters_that_fit<bf16, 192, 2, RowEpilogue<ROW_FC2_LN>>();
        case ROW_PROJ_LNQ:
            if (row_cluster(n, true, false) != 2) return 0;
            return w224 ? gemm_clusters_that_fit<int8_t, 224, 2, RowEpilogue<ROW_PROJ_LNQ>>()
                        : gemm_clusters_that_fit<int8_t, 192, 2, RowEpilogue<ROW_PROJ_LNQ>>();
        case ROW_FC1_Q:
            switch (row_cluster(n, false, true)) {
                case 2: return gemm_clusters_that_fit<int8_t, 192, 2, RowEpilogue<ROW_FC1_Q>>();
                case 7: return gemm_clusters_that_fit<int8_t, 192, 7, RowEpilogue<ROW_FC1_Q>>();
                case 8: return gemm_clusters_that_fit<int8_t, 192, 8, RowEpilogue<ROW_FC1_Q>>();
                default: return 0;
            }
        default: return 0;
    }
}

}  // extern "C"
