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
// once to float32). The bit depth BD (8 or 10) sets the transforms'
// shifts (tu_team.cuh) and, on the host, the quantiser's constants; the
// 10-bit variant is the 8-bit code with those shifts compiled in.
// Float32 semantics are the PyTorch version's, op by op: the divisions by
// constants as products with their float32 reciprocals (as XLA takes
// them), the division by 2^rice a product with 2^-rice (exact), no
// contraction (built with -fmad=false), the CG sums sequential in raster
// order inside the CG. The Rice parameter and the escape length are
// exact integer formulas (no log2f).
//
// What bounds it: the transform's 4 S^3 multiply-adds per TU and, with
// rdoq, ~60 float operations per coefficient; device memory sees each
// TU's org and prediction once (the prediction is read by its mode index
// in place, no gathered copy) and writes its levels once. At 416x240 the
// decision of one picture is ~100,000 TUs, 49,920 of them 4x4.
// Design: the TU size compiled in (a template on log2), a team of lanes a
// TU and blocks of 256 threads that hold as many TUs as fit: 4x4 16 lanes
// a TU (two a warp, 16 a block), 8x8 a warp (2 coefficients a lane),
// 16x16 two warps (4 a lane), 32x32 the block (8 warps, 4 a thread). A
// team inside one warp meets by __syncwarp, a larger one by barriers. The
// matrix is staged once a block, and the transform stages are the team's
// of tu_team.cuh (shared with b_txq.cu): a lane's outputs of the row
// stages share one matrix row (forward) or column (inverse), and of the
// column stages one data column, which it keeps in registers, and reads
// the rows it shares with other lanes 16 bytes a load. The RDOQ takes a
// CG a 16-lane group (`rdoq_level_lanes`): the Rice stand-in and the
// keep / zero sums by shuffles, the sums in the serial order; the SSEs by
// shuffles (integers: exact in any order). One launch a class for all
// its candidates.

#include "rdoq_common.cuh"
#include "tu_team.cuh"

namespace {

template <int LOG2, int BD>
__global__ void __launch_bounds__(kTuBlock)
intra_txq_tus(const int* __restrict__ org, const int* __restrict__ preds,
              const int* __restrict__ rows, const int* __restrict__ modes,
              const float* __restrict__ ftab, float* __restrict__ dist_out,
              float* __restrict__ d0_out, int* __restrict__ lvl_out, int ntu,
              int K, int dst, int qscale, int qadd, int qbits, int dqscale,
              int dqshift, int rdoq, Rdoq rq) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, N2 = L::N2, TEAM = L::TEAM, CPL = L::CPL;
    constexpr int CGW = S > 4 ? S / 4 : 1;
    __shared__ TxMats<LOG2> s_m;
    __shared__ __align__(16) int s_X[L::TUS][N2];  // residual, coefficients,
                                                   // levels, dequantised
    __shared__ __align__(16) int s_Y[L::TUS][N2];  // the first stages
    __shared__ int s_red[2][kTuBlock / 32];
    const int slot = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
    const int tu0 = blockIdx.x * L::TUS + slot;
    const bool live = tu0 < ntu;
    const int tu = live ? tu0 : ntu - 1;  // a spare team repeats the last
    int* X = s_X[slot];
    int* Y = s_Y[slot];
    const int row = rows[tu / K];
    const int* ob = org + (size_t)row * N2;
    const int* pb = preds + ((size_t)row * 35 + modes[tu]) * N2;

    tx_stage_mats<LOG2>(s_m, dst);
    int r[CPL], d0 = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int e = t + TEAM * j;
        r[j] = ob[e] - pb[e];
        X[e] = r[j];
        d0 += r[j] * r[j];
    }
    __syncthreads();
    team_forward<LOG2, BD>(X, Y, s_m, t);
    if (rdoq) {  // a CG a 16-lane group: coefficient i of CG g at c
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int c = t + TEAM * j, g = c >> 4, i = c & 15;
            const int e = ((g / CGW) * 4 + (i >> 2)) * S + (g % CGW) * 4
                          + (i & 3);
            X[e] = rdoq_level_lanes(X[e], e, LOG2, ftab, rq);
        }
    } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j)
            X[t + TEAM * j] = tx_quant(X[t + TEAM * j], qscale, qadd, qbits);
    }
    team_sync<TEAM>();
    int* lo = lvl_out + (size_t)tu * N2;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int e = t + TEAM * j;
        const int lev = X[e];
        if (live) lo[e] = lev;
        X[e] = tx_dequant(lev, dqscale, dqshift);
    }
    team_sync<TEAM>();
    team_inv_cols<LOG2>(X, Y, s_m, t);
    team_sync<TEAM>();
    int dist = 0;
    {  // inverse rows, each output against the residual
        int tc[S];
        tx_matrix_col<LOG2>(s_m, t & (S - 1), tc);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int d = r[j] - tx_inv_row_at<LOG2, BD>(
                                     Y, tc, (t + TEAM * j) >> LOG2);
            dist += d * d;
        }
    }
    dist = team_sum<TEAM>(dist, s_red[0]);
    d0 = team_sum<TEAM>(d0, s_red[1]);
    if (t == 0 && live) {
        dist_out[tu] = (float)dist;
        d0_out[tu] = (float)d0;
    }
}

template <int LOG2, int BD>
int launch_tus(const int* org, const int* preds, const int* rows,
               const int* modes, const float* ftab, float* dist, float* d0,
               int* lvl, int ntu, int K, int dst, int qscale, int qadd,
               int qbits, int dqscale, int dqshift, int rdoq, Rdoq rq,
               cudaStream_t st) {
    constexpr int TUS = TuTeam<LOG2>::TUS;
    intra_txq_tus<LOG2, BD><<<(ntu + TUS - 1) / TUS, kTuBlock, 0, st>>>(
        org, preds, rows, modes, ftab, dist, d0, lvl, ntu, K, dst, qscale,
        qadd, qbits, dqscale, dqshift, rdoq, rq);
    return (int)cudaGetLastError();
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
// dequant_params / rdoq_consts give them at bit_depth (8 or 10); lam,
// lc0 = lam * csbf[0][0], lc1 = lam * csbf[0][1] rounded to float32.
extern "C" int tpuhevc_intra_txq(const int* org, const int* preds,
                                 const int* rows, const int* modes,
                                 const float* ftab, float* dist, float* d0,
                                 int* lvl, int m, int K, int log2, int dst,
                                 int qscale, int qadd, int qbits, int dqscale,
                                 int dqshift, int rdoq, float scale,
                                 float qdiv, float inv_qdiv, float inv_den,
                                 float lam, float lc0, float lc1,
                                 int bit_depth, void* stream) {
    const Rdoq rq = {scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1};
    const int ntu = m * K;
    if (bit_depth != 8 && bit_depth != 10) return (int)cudaErrorInvalidValue;
    if (ntu == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define TPUHEVC_TUS(LG, BD)                                                 \
    launch_tus<LG, BD>(org, preds, rows, modes, ftab, dist, d0, lvl, ntu,  \
                       K, dst, qscale, qadd, qbits, dqscale, dqshift, rdoq, \
                       rq, st)
    const bool ten = bit_depth == 10;
    switch (log2) {
        case 2: return ten ? TPUHEVC_TUS(2, 10) : TPUHEVC_TUS(2, 8);
        case 3: return ten ? TPUHEVC_TUS(3, 10) : TPUHEVC_TUS(3, 8);
        case 4: return ten ? TPUHEVC_TUS(4, 10) : TPUHEVC_TUS(4, 8);
        case 5: return ten ? TPUHEVC_TUS(5, 10) : TPUHEVC_TUS(5, 8);
        default: return (int)cudaErrorInvalidValue;
    }
#undef TPUHEVC_TUS
}
