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
// matrix is staged once a block, its rows padded so that lanes reading
// down a column hit distinct banks; a lane's outputs of the row stages
// share one matrix row (forward) or column (inverse), and of the column
// stages one data column, which it keeps in registers, and reads the
// rows it shares with other lanes 16 bytes a load. The RDOQ takes a
// CG a 16-lane group (`rdoq_level_lanes`): the Rice stand-in and the
// keep / zero sums by shuffles, the sums in the serial order; the SSEs by
// shuffles (integers: exact in any order). One launch a class for all
// its candidates.

#include "rdoq_common.cuh"
#include "tx_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// A TU of S x S = 1 << LOG2: TEAM lanes, CPL coefficients a lane, TUS TUs
// a block of kThreads.
template <int LOG2>
struct TuTeam {
    static constexpr int S = 1 << LOG2, N2 = S * S;
    static constexpr int TEAM =
        LOG2 == 5 ? kThreads : (LOG2 == 4 ? 64 : (N2 < 32 ? N2 : 32));
    static constexpr int CPL = N2 / TEAM, TUS = kThreads / TEAM;
};

template <int TEAM>
__device__ __forceinline__ void team_sync() {
    if (TEAM > 32)
        __syncthreads();
    else
        __syncwarp();
}

// v summed over the team (every lane of the team gets it); red: one int
// a warp of the block
template <int TEAM>
__device__ __forceinline__ int team_sum(int v, int* red) {
#pragma unroll
    for (int off = (TEAM < 32 ? TEAM : 32) / 2; off; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
    if (TEAM > 32) {
        constexpr int W = TEAM / 32;  // the team's warps
        if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
        __syncthreads();
        const int w0 = threadIdx.x / TEAM * W;
        v = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) v += red[w0 + w];
    }
    return v;
}

// sum over x < S of p[x] * r[x], p 16-byte aligned in shared memory and
// shared by the lanes that read it (16 bytes a load); integer products
// below 2^31, their sum exact in any order
template <int S>
__device__ __forceinline__ int dot_row(const int* p, const int (&r)[S]) {
    int acc = 0;
#pragma unroll
    for (int x = 0; x < S; x += 4) {
        const int4 v = *reinterpret_cast<const int4*>(p + x);
        acc += v.x * r[x] + v.y * r[x + 1] + v.z * r[x + 2] + v.w * r[x + 3];
    }
    return acc;
}

template <int LOG2>
__global__ void __launch_bounds__(kThreads)
intra_txq_tus(const int* __restrict__ org, const int* __restrict__ preds,
              const int* __restrict__ rows, const int* __restrict__ modes,
              const float* __restrict__ ftab, float* __restrict__ dist_out,
              float* __restrict__ d0_out, int* __restrict__ lvl_out, int ntu,
              int K, int dst, int qscale, int qadd, int qbits, int dqscale,
              int dqshift, int rdoq, Rdoq rq) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, N2 = L::N2, TEAM = L::TEAM, CPL = L::CPL;
    constexpr int MASK = S - 1, CGW = S > 4 ? S / 4 : 1;
    constexpr int TP = S + 1;  // the padded copy's row pitch
    // the matrix, once a block: T padded (a lane's own row or column, read
    // down a column by distinct lanes, hits distinct banks), T and its
    // transpose aligned (rows that lanes share, read 16 bytes a load)
    __shared__ int s_Tp[S * TP];
    __shared__ __align__(16) int s_Ta[N2];
    __shared__ __align__(16) int s_Tt[N2];
    __shared__ __align__(16) int s_X[L::TUS][N2];  // residual, coefficients,
                                                   // levels, dequantised
    __shared__ __align__(16) int s_Y[L::TUS][N2];  // the first stages
    __shared__ int s_red[2][kThreads / 32];
    const int slot = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
    const int tu0 = blockIdx.x * L::TUS + slot;
    const bool live = tu0 < ntu;
    const int tu = live ? tu0 : ntu - 1;  // a spare team repeats the last
    int* X = s_X[slot];
    int* Y = s_Y[slot];
    const int row = rows[tu / K];
    const int* ob = org + (size_t)row * N2;
    const int* pb = preds + ((size_t)row * 35 + modes[tu]) * N2;

    for (int e = threadIdx.x; e < N2; e += kThreads) {
        const int k = e >> LOG2, x = e & MASK;
        const int v = dst ? c_dst4[e] : c_dct32[(k << (5 - LOG2)) * 32 + x];
        s_Tp[k * TP + x] = v;
        s_Ta[e] = v;
        s_Tt[x * S + k] = v;
    }
    int r[CPL], d0 = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int e = t + TEAM * j;
        r[j] = ob[e] - pb[e];
        X[e] = r[j];
        d0 += r[j] * r[j];
    }
    __syncthreads();
    // a lane's outputs e = t + TEAM j share the column e & MASK
    const int col = t & MASK;
    {  // forward rows: Y[y][k] = (sum_x X[y][x] T[k][x] + r1) >> s1
        constexpr int s1 = LOG2 - 1;
        int tk[S];
#pragma unroll
        for (int x = 0; x < S; ++x) tk[x] = s_Tp[col * TP + x];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int y = (t + TEAM * j) >> LOG2;
            Y[t + TEAM * j] = (dot_row<S>(X + y * S, tk) + (1 << (s1 - 1)))
                              >> s1;
        }
    }
    team_sync<TEAM>();
    {  // forward columns: X[k][j] = (sum_y T[k][y] Y[y][j] + r2) >> s2
        constexpr int s2 = LOG2 + 6;
        int yc[S];
#pragma unroll
        for (int y = 0; y < S; ++y) yc[y] = Y[y * S + col];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int k = (t + TEAM * j) >> LOG2;
            X[t + TEAM * j] = (dot_row<S>(s_Ta + k * S, yc) + (1 << (s2 - 1)))
                              >> s2;
        }
    }
    team_sync<TEAM>();
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
    {  // inverse columns: Y[y][j] = clip16((sum_k T[k][y] X[k][j] + 64) >> 7)
        int xc[S];
#pragma unroll
        for (int k = 0; k < S; ++k) xc[k] = X[k * S + col];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int y = (t + TEAM * j) >> LOG2;
            Y[t + TEAM * j] = clip16((dot_row<S>(s_Tt + y * S, xc) + 64) >> 7);
        }
    }
    team_sync<TEAM>();
    int dist = 0;
    {  // inverse rows: rec[y][x] = clip16((sum_k Y[y][k] T[k][x] + 2^11)
       // >> 12)
        int tc[S];
#pragma unroll
        for (int k = 0; k < S; ++k) tc[k] = s_Tp[k * TP + col];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int y = (t + TEAM * j) >> LOG2;
            const int d = r[j] - clip16((dot_row<S>(Y + y * S, tc) + 2048)
                                        >> 12);
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

template <int LOG2>
int launch_tus(const int* org, const int* preds, const int* rows,
               const int* modes, const float* ftab, float* dist, float* d0,
               int* lvl, int ntu, int K, int dst, int qscale, int qadd,
               int qbits, int dqscale, int dqshift, int rdoq, Rdoq rq,
               cudaStream_t st) {
    constexpr int TUS = TuTeam<LOG2>::TUS;
    intra_txq_tus<LOG2><<<(ntu + TUS - 1) / TUS, kThreads, 0, st>>>(
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
    const Rdoq rq = {scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1};
    const int ntu = m * K;
    if (ntu == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define TPUHEVC_TUS(LG)                                                     \
    launch_tus<LG>(org, preds, rows, modes, ftab, dist, d0, lvl, ntu, K,   \
                   dst, qscale, qadd, qbits, dqscale, dqshift, rdoq, rq, st)
    switch (log2) {
        case 2: return TPUHEVC_TUS(2);
        case 3: return TPUHEVC_TUS(3);
        case 4: return TPUHEVC_TUS(4);
        case 5: return TPUHEVC_TUS(5);
        default: return (int)cudaErrorInvalidValue;
    }
#undef TPUHEVC_TUS
}
