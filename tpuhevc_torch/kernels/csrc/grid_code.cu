// grid_code: the grid step's residual coding of one TU size.
//
// Replaces: tpuhevc/codec/inter_grid.py:1718-1750 `_txq_luma` and the
// `_txq_chroma` closure of `class_code` (:1822-1851), with the coding of
// `intra16_code` (:2205-2258), over the plane transforms of :342-383
// (`fwd_tx`, `quant_plane`, `deq_plane`, `inv_tx`), the grid's RDOQ and
// sign-bit hiding (`rdoq_plane`, `sbh_plane`, :399-631, in
// grid_rdoq.cuh) and the table bit estimate of
// tpuhevc/entropy/bitest.py:286-378 (`ResidualBitEst.tu_bits` with the
// live tables), 8-bit.
//
// What it computes, per T x T TU of an (h, w) plane (T = 4..32):
//   r = orig - pred; c = forward DCT (tx_common.cuh);
//   lvl = clip(sign(c) ((|c| scale + add) >> qbits), -lim, lim), or with
//         rdoq the grid's RDOQ (grid_rdoq.cuh); with sbh, sign-bit hiding
//         per 4x4 CG;
//   rsd = inverse DCT of clip16(dequant(lvl));
//   rec = nz ? clip(pred + rsd, 0, 255) : pred, nz = #(lvl != 0);
//   d_skip, d_coded = int32 SSE of orig - pred and orig - rec, as float;
//   bits = tu_bits (tu_bits_common.cuh; one sign fewer per hiding CG with
//          sbh);
//   drop = d_skip + lam cbf0 <= d_coded + lam (bits + cbf1), float32,
//          every product rounded on its own (-fmad=false), as XLA;
//   out: dropped ? (lvl 0, rec pred, d d_skip, b cbf0, cbf 0)
//                : (lvl, rec, d d_coded, b bits + cbf1, cbf nz); d0 = d_skip.
//
// What bounds it: the transform's 4 T^3 multiply-adds per TU pair of
// stages on shared memory, and with RDOQ its walk-back's dependent adds;
// device memory sees orig and pred once and writes lvl and rec once.
// Design: one block per TU, the whole chain in one launch (b_txq.cu's
// structure), RDOQ and SBH between the quantiser and the dequantiser on
// the same shared memory, warp 0 prices the levels while the others wait
// at the barrier.

#include "grid_rdoq.cuh"
#include "tu_bits_common.cuh"
#include "tx_common.cuh"

namespace {

struct Quant {
    int scale, add, qbits, dqscale, dqshift, lim, rdoq, sbh;
    float lam, cbf0, cbf1;
};

__global__ void grid_code_kernel(const int* __restrict__ orig,
                                 const int* __restrict__ pred,
                                 const int* __restrict__ itab,
                                 const float* __restrict__ ftab,
                                 int* __restrict__ lvl_out,
                                 int* __restrict__ rec_out,
                                 float* __restrict__ d_out,
                                 float* __restrict__ b_out,
                                 int* __restrict__ cbf_out,
                                 float* __restrict__ d0_out, int h, int w,
                                 int log2, Quant q) {
    extern __shared__ int smem[];
    __shared__ int scratch[32];
    __shared__ int t_csbf[kMaxCg], t_nsig[kMaxCg], t_ngt1[kMaxCg];
    __shared__ int t_gt2[kMaxCg], t_rice[kMaxCg];
    __shared__ float s_bits;
    __shared__ RdoqShared rsh;
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    int* T = smem;       // S x S matrix
    int* A = T + n2;     // residual, coefficients, dequant, recon
    int* B = A + n2;     // transform scratch (a float array of the RDOQ)
    int* L = B + n2;     // levels
    int* P = L + n2;     // prediction
    int* C = P + n2;     // source
    float* F = reinterpret_cast<float*>(C + n2);  // RDOQ: 5 n2 floats
    const int ntw = w >> log2;
    const int tu = blockIdx.x;
    const int ty = tu / ntw, tx = tu - ty * ntw;
    const size_t base = (size_t)(ty * S) * w + tx * S;
    tx_load_matrix(T, log2, false);
    int d_skip = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const size_t o = base + (size_t)(e >> log2) * w + (e & mask);
        const int c = orig[o], p = pred[o];
        C[e] = c;
        P[e] = p;
        A[e] = c - p;
        d_skip += (c - p) * (c - p);
    }
    __syncthreads();
    tx_forward(A, B, T, log2);
    const float q2 = (float)(1 << q.qbits);
    if (q.rdoq) {
        const RdoqQ rq{q2, (float)(q.scale << (7 - log2)), (float)q.scale,
                       q.lam, q.lim};
        grid_rdoq_block(A, L, F, F + n2, F + 2 * n2, F + 3 * n2, F + 4 * n2,
                        reinterpret_cast<float*>(B), log2, itab, ftab, rq,
                        &rsh);
    } else {
        for (int e = threadIdx.x; e < n2; e += blockDim.x) {
            const int c = A[e];
            int l = (abs(c) * q.scale + q.add) >> q.qbits;
            l = c < 0 ? -l : (c > 0 ? l : 0);
            L[e] = min(max(l, -q.lim), q.lim);
        }
        __syncthreads();
    }
    if (q.sbh) {
        const int ncg = 1 << (2 * log2 - 4);
        for (int g = threadIdx.x; g < ncg; g += blockDim.x)
            grid_sbh_cg(L, A, g, log2, (float)q.scale, q2, q.lim);
        __syncthreads();
    }
    int nz = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int l = L[e];
        nz += l != 0;
        A[e] = tx_dequant(l, q.dqscale, q.dqshift);
    }
    nz = block_sum(nz, scratch);  // barrier: A, L complete
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
                                        t_ngt1, t_gt2, t_rice, q.sbh != 0);
        if (threadIdx.x == 0) s_bits = bits;
    }
    __syncthreads();
    const float ds = (float)d_skip, dc = (float)d_coded;
    const float bc = s_bits + q.cbf1;
    const bool drop = ds + q.lam * q.cbf0 <= dc + q.lam * bc;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const size_t o = base + (size_t)(e >> log2) * w + (e & mask);
        lvl_out[o] = drop ? 0 : L[e];
        rec_out[o] = drop ? P[e] : A[e];
    }
    if (threadIdx.x == 0) {
        d_out[tu] = drop ? ds : dc;
        b_out[tu] = drop ? q.cbf0 : bc;
        cbf_out[tu] = drop ? 0 : nz;
        d0_out[tu] = ds;
    }
}

}  // namespace

// Copies the 32x32 HEVC DCT (int32, host memory) to this file's constant
// memory on the current device. Call once per device before
// tpuhevc_grid_code.
extern "C" int tpuhevc_grid_code_init(const int* host_t32) {
    cudaMemcpyToSymbol(c_dct32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// orig, pred (h, w) int32 on the device, T = 1 << log2 dividing both; itab
// / ftab the estimator's tables (entropy/bitest.py EstTables) -> lvl, rec
// (h, w) int32; d, b, d0 (h/T, w/T) float32; cbf (h/T, w/T) int32.
// scale / add / qbits and dqscale / dqshift as
// tpuhevc_torch/ops/transforms.py quant_params (inter rounding) and
// dequant_params; lim 127 or 32767; rdoq / sbh 0 or 1.
extern "C" int tpuhevc_grid_code(const int* orig, const int* pred,
                                 const int* itab, const float* ftab,
                                 int* lvl, int* rec, float* d, float* b,
                                 int* cbf, float* d0, int h, int w, int log2,
                                 int scale, int add, int qbits, int dqscale,
                                 int dqshift, int lim, int rdoq, int sbh,
                                 float lam, float cbf0, float cbf1,
                                 void* stream) {
    const int n2 = 1 << (2 * log2);
    const int threads = n2 >= 256 ? 256 : (n2 < 32 ? 32 : n2);
    const size_t smem = (size_t)(rdoq ? 11 : 6) * n2 * sizeof(int);
    const int ntu = (h >> log2) * (w >> log2);
    const Quant q = {scale, add, qbits, dqscale, dqshift, lim, rdoq, sbh,
                     lam, cbf0, cbf1};
    if (ntu == 0) return 0;
    static bool big_smem = false;  // 45 KB dynamic at T = 32 with RDOQ
    if (!big_smem) {
        const cudaError_t e = cudaFuncSetAttribute(
            grid_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            64 * 1024);
        if (e != cudaSuccess) return (int)e;
        big_smem = true;
    }
    grid_code_kernel<<<ntu, threads, smem, (cudaStream_t)stream>>>(
        orig, pred, itab, ftab, lvl, rec, d, b, cbf, d0, h, w, log2, q);
    return (int)cudaGetLastError();
}
