// b_txq: the B step's TU coding with the table RDOQ and the skip/code drop.
//
// Replaces: tpuhevc/codec/inter_b.py:181-194, `code_blocks` (a closure of
// `_b_step` that XLA compiled for the TPU), over the int32 JAX transforms
// of tpuhevc/ops/transforms.py:144-198, `rdoq_est_xp` (:317-422) and
// `ResidualBitEst.tu_bits` (tpuhevc/entropy/bitest.py:286-378), 8-bit.
//
// What it computes, per TU of size S (4..16):
//   r = cur - pred; c = forward DCT-II (tx_common.cuh);
//   lvl = the float32 table RDOQ of c (rdoq_common.cuh) with the B-slice
//         estimator's tables and the full lambda;
//   rsd = inverse DCT of the dequantised levels;
//   rec = nz ? clip(pred + rsd, 0, 255) : pred, nz = any(lvl != 0);
//   bits = the table bit estimate of lvl (tu_bits_common.cuh, float32);
//   drop = (float)(sse(cur, pred) - sse(cur, rec)) <= lam * bits, the
//          SSEs int32 as in JAX, the product rounded on its own
//          (-fmad=false);
//   dropped: lvl = 0, rec = pred.
//
// What bounds it: the transform's 4 S^3 multiply-adds and ~60 float
// operations per coefficient of the RDOQ, all on shared memory; device
// memory sees cur and pred once and writes lvl and rec once.
// Design: one block per TU, the whole chain in one launch with no
// intermediate in device memory; warp 0 prices the levels in shared
// memory while the other warps wait at the barrier.

#include "rdoq_common.cuh"
#include "tu_bits_common.cuh"
#include "tx_common.cuh"

namespace {

__global__ void b_txq_kernel(const int* __restrict__ cur,
                             const int* __restrict__ pred,
                             const int* __restrict__ itab,
                             const float* __restrict__ ftab,
                             int* __restrict__ lvl_out,
                             int* __restrict__ rec_out, int log2,
                             int dqscale, int dqshift, Rdoq rq) {
    extern __shared__ int smem[];
    __shared__ int scratch[32];
    __shared__ int cg_rice[kMaxCg];
    __shared__ int cg_keep[kMaxCg];
    __shared__ int t_csbf[kMaxCg], t_nsig[kMaxCg], t_ngt1[kMaxCg];
    __shared__ int t_gt2[kMaxCg], t_rice[kMaxCg];
    __shared__ float s_bits;
    const int n2 = 1 << (2 * log2);
    int* T = smem;                 // S x S matrix
    int* A = T + n2;               // residual, coefficients, dequant, recon
    int* B = A + n2;               // transform scratch
    int* L = B + n2;               // levels
    int* P = L + n2;               // the prediction
    int* C = P + n2;               // the source block
    float* F1 = (float*)(C + n2);  // RDOQ scratch
    float* F2 = F1 + n2;
    float* F3 = F2 + n2;
    float* F4 = F3 + n2;

    const int n = blockIdx.x;
    const int* cb = cur + (size_t)n * n2;
    const int* pb = pred + (size_t)n * n2;
    tx_load_matrix(T, log2, false);
    int d_skip = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int c = cb[e], p = pb[e];
        C[e] = c;
        P[e] = p;
        A[e] = c - p;
        d_skip += (c - p) * (c - p);
    }
    __syncthreads();
    tx_forward(A, B, T, log2);
    rdoq_levels(A, L, F1, F2, F3, F4, cg_rice, cg_keep, log2, ftab, rq);
    __syncthreads();

    int nz = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        A[e] = tx_dequant(L[e], dqscale, dqshift);
        nz |= L[e] != 0;
    }
    nz = block_sum(nz, scratch);  // barrier: A complete
    tx_inverse(A, B, T, log2);

    int d_coded = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int rec = nz ? min(max(P[e] + A[e], 0), 255) : P[e];
        A[e] = rec;
        d_coded += (C[e] - rec) * (C[e] - rec);
    }
    d_skip = block_sum(d_skip, scratch);
    d_coded = block_sum(d_coded, scratch);
    if (threadIdx.x < 32) {
        const float bits = tu_bits_warp(L, itab, ftab, log2, t_csbf, t_nsig,
                                        t_ngt1, t_gt2, t_rice, false);
        if (threadIdx.x == 0) s_bits = bits;
    }
    __syncthreads();
    const float rate = rq.lam * s_bits;
    const bool drop = (float)(d_skip - d_coded) <= rate;
    int* lo = lvl_out + (size_t)n * n2;
    int* ro = rec_out + (size_t)n * n2;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        lo[e] = drop ? 0 : L[e];
        ro[e] = drop ? P[e] : A[e];
    }
}

}  // namespace

// Copies the 32x32 HEVC DCT (int32, host memory) to this file's constant
// memory on the current device. Call once per device before tpuhevc_b_txq.
extern "C" int tpuhevc_b_txq_init(const int* host_t32) {
    cudaMemcpyToSymbol(c_dct32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// cur, pred (n, S, S) int32 on the device, S = 1 << log2 in 4..16; itab /
// ftab: the estimator's tables (entropy/bitest.py EstTables) -> lvl, rec
// (n, S, S) int32. dqscale / dqshift as tpuhevc_torch/ops/transforms.py
// dequant_params; scale .. inv_den as rdoq_consts; lam the full lambda,
// lc0 = lam * csbf[0][0], lc1 = lam * csbf[0][1], rounded to float32.
extern "C" int tpuhevc_b_txq(const int* cur, const int* pred, const int* itab,
                             const float* ftab, int* lvl, int* rec, int n,
                             int log2, int dqscale, int dqshift, float scale,
                             float qdiv, float inv_qdiv, float inv_den,
                             float lam, float lc0, float lc1, void* stream) {
    const int n2 = 1 << (2 * log2);
    const int threads = n2 >= 256 ? 256 : (n2 < 32 ? 32 : n2);
    const size_t smem = (size_t)10 * n2 * sizeof(int);
    const Rdoq rq = {scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1};
    b_txq_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        cur, pred, itab, ftab, lvl, rec, log2, dqscale, dqshift, rq);
    return (int)cudaGetLastError();
}
