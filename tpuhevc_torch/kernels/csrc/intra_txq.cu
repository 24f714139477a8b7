// intra_txq: the TU rate-distortion trial of the open-loop intra decision.
//
// Replaces: tpuhevc/codec/intra_decide_jax.py:86-98 (`txq`) with the
// candidate gather of :136-137 / :189-190 / :224-225 and the uncoded
// distortion of :139-140 / :194-195 / :227-228 (closures of `_build` that
// XLA compiled for the TPU), over tpuhevc/ops/transforms.py:144-198
// (DCT-II / DST-VII, intra quantiser) and :317-422 (`rdoq_est_xp`).
//
// What it computes, per TU (m, k): r = org[rows[m]] - preds[rows[m]]
// [modes[m][k]]; c = forward transform (DST at 4x4 luma); levels =
// the intra quantiser (rounding 171) or, with rdoq, the table RDOQ in
// float32 (per coefficient the cheapest of {ceil, ceil-1, 0} by squared
// error plus lambda times the table bits, then per 4x4 CG the all-zero
// trial against the coded-sub-block flag); then dequantise, inverse
// transform, and dist = sum (r - rec)^2, d0 = sum r^2 (int32, rounded
// once to float32).
// Float32 semantics are the PyTorch version's, op by op: the divisions by
// constants as products with their float32 reciprocals (as XLA takes
// them), the division by 2^rice an IEEE division, no contraction (built
// with -fmad=false), the CG sums sequential in raster order inside the
// CG. The Rice parameter and the escape length are exact integer
// formulas (no log2f).
//
// What bounds it: the transform's 4 S^3 multiply-adds per TU and, with
// rdoq, ~60 float operations per coefficient, all on shared memory;
// device memory sees each TU's org and prediction once (the prediction is
// read by its mode index in place, no gathered copy) and writes its
// levels once. Launch-bound at the small classes (49,920 4x4 TUs at
// 416x240 are cheap blocks of 32 threads).
// Design: one block per (m, k) TU, one launch per class for all its
// candidates; the transform core of tx_common.cuh and the table RDOQ of
// rdoq_common.cuh (per-CG steps, Rice parameter and zero trial, by one
// thread per CG between barriers).

#include "rdoq_common.cuh"
#include "tx_common.cuh"

namespace {

__global__ void intra_txq_kernel(const int* __restrict__ org,
                                 const int* __restrict__ preds,
                                 const int* __restrict__ rows,
                                 const int* __restrict__ modes,
                                 const float* __restrict__ ftab,
                                 float* __restrict__ dist_out,
                                 float* __restrict__ d0_out,
                                 int* __restrict__ lvl_out,
                                 int K, int log2, int dst, int qscale,
                                 int qadd, int qbits, int dqscale,
                                 int dqshift, int rdoq, Rdoq rq) {
    extern __shared__ int smem[];
    __shared__ int scratch[32];
    __shared__ int cg_rice[64];
    __shared__ int cg_keep[64];
    const int S = 1 << log2, n2 = S * S;
    int* T = smem;             // S x S matrix
    int* A = T + n2;           // residual -> coefficients -> dequant -> rec
    int* B = A + n2;           // transform scratch
    int* R = B + n2;           // the residual, kept for dist
    int* L = R + n2;           // levels
    float* F1 = (float*)(L + n2);  // ac
    float* F2 = F1 + n2;           // lmax, then the chosen level
    float* F3 = F2 + n2;           // per-coefficient CG-keep cost
    float* F4 = F3 + n2;           // per-coefficient CG-zero cost

    const int tu = blockIdx.x;
    const int m = tu / K;
    const int row = rows[m];
    const int mode = modes[tu];
    const int* ob = org + (size_t)row * n2;
    const int* pb = preds + ((size_t)row * 35 + mode) * n2;

    tx_load_matrix(T, log2, dst != 0);
    int d0 = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int r = ob[e] - pb[e];
        A[e] = r;
        R[e] = r;
        d0 += r * r;
    }
    __syncthreads();
    tx_forward(A, B, T, log2);

    if (!rdoq) {
        for (int e = threadIdx.x; e < n2; e += blockDim.x) {
            L[e] = tx_quant(A[e], qscale, qadd, qbits);
        }
    } else {
        rdoq_levels(A, L, F1, F2, F3, F4, cg_rice, cg_keep, log2, ftab, rq);
    }
    __syncthreads();

    int* lo = lvl_out + (size_t)tu * n2;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int lev = L[e];
        lo[e] = lev;
        A[e] = tx_dequant(lev, dqscale, dqshift);
    }
    __syncthreads();
    tx_inverse(A, B, T, log2);

    int dist = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int d = R[e] - A[e];
        dist += d * d;
    }
    dist = block_sum(dist, scratch);
    d0 = block_sum(d0, scratch);
    if (threadIdx.x == 0) {
        dist_out[tu] = (float)dist;
        d0_out[tu] = (float)d0;
    }
}

}  // namespace

// Copies the 32x32 HEVC DCT and the 4x4 DST matrices (int32, host memory)
// to constant memory of the current device. Call once per device before
// tpuhevc_intra_txq.
extern "C" int tpuhevc_intra_txq_init(const int* host_t32,
                                      const int* host_dst4) {
    cudaMemcpyToSymbol(c_dct32, host_t32, sizeof(int) * 32 * 32);
    cudaMemcpyToSymbol(c_dst4, host_dst4, sizeof(int) * 4 * 4);
    return (int)cudaGetLastError();
}

// org (R, S, S), preds (R, 35, S, S), rows (m,), modes (m, K) int32 on the
// device, S = 1 << log2 -> dist, d0 (m, K) float32, lvl (m, K, S, S)
// int32. ftab: the TU size's float32 bit tables (read only with rdoq).
// Quantiser constants as tpuhevc_torch/ops/transforms.py quant_params /
// dequant_params / rdoq_consts give them; lam, lc0 = lam * csbf[0][0],
// lc1 = lam * csbf[0][1] rounded to float32.
extern "C" int tpuhevc_intra_txq(const int* org, const int* preds,
                                 const int* rows, const int* modes,
                                 const float* ftab, float* dist, float* d0,
                                 int* lvl, int m, int K, int log2, int dst,
                                 int qscale, int qadd, int qbits, int dqscale,
                                 int dqshift, int rdoq, float scale,
                                 float qdiv, float inv_qdiv, float inv_den,
                                 float lam, float lc0, float lc1,
                                 void* stream) {
    const int n2 = 1 << (2 * log2);
    const int threads = n2 >= 256 ? 256 : (n2 < 32 ? 32 : n2);
    const size_t smem = (size_t)9 * n2 * sizeof(int);
    const Rdoq rq = {scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1};
    intra_txq_kernel<<<m * K, threads, smem, (cudaStream_t)stream>>>(
        org, preds, rows, modes, ftab, dist, d0, lvl, K, log2, dst, qscale,
        qadd, qbits, dqscale, dqshift, rdoq, rq);
    return (int)cudaGetLastError();
}
