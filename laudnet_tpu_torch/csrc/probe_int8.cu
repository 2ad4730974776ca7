// s8 x s8 -> s32 GEMM for Hopper (sm_90a): C[m, n] = sum_k A[m, k] B[n, k],
// exact 32-bit integer sums, stored raw (no dequantisation, no epilogue).
//
// Replaces the TPU kernel tools/probe_int8.py::rate_pallas_s8 (P2), the
// probe that asks whether an s8 dot runs at the s8 rate inside a kernel
// of one's own. Its 512 x 512 VMEM blocks have no counterpart here: this is
// the s8 form of the port's one GEMM core (gemm_sm90.cuh, the core of B6's
// products), TMA ring, warp-specialised wgmma m64nNk32, persistent tiles of
// 128 x 256 (n = 4096: 512 tiles, 3.88 waves on 132 SMs), with a raw int32
// store as its epilogue. The probe's question on this card: does the core
// reach the s8 rate at a large K, or is B6 slow only at its small K
// (384-1536)? At n = 4096 it is bound by operations (137 GOP against 100
// MB; 0.069 ms at the 1,979 TOP/s peak).
//
// A is (M, K) row-major, B is (N, K) row-major (the (K, N) operand stored
// column-major), C is (M, N) row-major int32. M and N are any; rows past
// them are zero-filled on load and not stored. K % 16 == 0 (TMA's 16-byte
// global stride); K past a 128-byte block is zero-filled. Exact: |sum| <=
// 127^2 * K < 2^31 for K < 133,000. N % 4 != 0: the int32 values are
// stored one by one (a 16-byte store needs a row stride of 4 values).

#include "gemm_sm90.cuh"

namespace {

struct RawS32 {
    int* c;
    int n;
    static constexpr int OUT_BYTES = 4;
    struct Row {};
    __device__ __forceinline__ Row row(int) const { return {}; }
    __device__ __forceinline__ void apply(const Row&, int, int, int&, int&) const {}
    __device__ __forceinline__ void stage(void* dst, int v0, int v1) const {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
    }
    // four columns at once where the row stride keeps 16-byte alignment
    // and all four lie inside N; one by one otherwise
    __device__ __forceinline__ void store16(int gm, int gn, uint4 v) const {
        int* dst = c + (size_t)gm * n + gn;
        if ((n & 3) == 0 && gn + 4 <= n) {
            *reinterpret_cast<uint4*>(dst) = v;
        } else {
            const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (gn + i < n) dst[i] = static_cast<int>(w[i]);
        }
    }
};

}  // namespace

extern "C" {

// a (m, k) and b (n, k) int8 codes, row-major; c (m, n) int32. k % 16 == 0.
int lt_s8_gemm(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
    if (k % 16 != 0 || m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_gemm_sm90<int8_t, 256>(a, b, m, n, k,
                                                          RawS32{static_cast<int*>(c), n},
                                                          static_cast<cudaStream_t>(stream)));
}

// The host's cost of a launch's descriptors: encodes ``reps`` TMA
// descriptors of a bf16 (rows, k) operand at ``base`` (tools/probe_host.py
// times the call). Returns the first error, or 0.
int lt_tma_encode(const void* base, int rows, int k, int reps) {
    CUtensorMap map;
    for (int i = 0; i < reps; ++i) {
        const cudaError_t err = encode_kmajor<bf16>(&map, base, rows, k, GEMM_BM);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // extern "C"
