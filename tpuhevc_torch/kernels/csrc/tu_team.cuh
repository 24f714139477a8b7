// A team of lanes a TU: the transform stages of tx_common.cuh spread over
// the team, shared by the TU kernels that give a TU a warp or part of one
// (intra_txq.cu, b_txq.cu).
//
// What it computes: the forward and inverse HEVC transforms of
// tx_common.cuh (the same integer stages, the same int32 sums), for an
// S x S TU (S = 1 << LOG2 in 4..32) held in the team's shared slice, at
// the bit depth BD (a template argument, 8 unless given: it sets the
// forward rows' shift, LOG2 + BD - 9, and the inverse rows', 20 - BD).
//
// Layout: TuTeam<LOG2> gives the team TEAM lanes and CPL coefficients a
// lane, and a block of kTuBlock threads TUS TUs: 4x4 16 lanes a TU (two a
// warp, 16 a block), 8x8 a warp (2 coefficients a lane), 16x16 two warps
// (4 a lane), 32x32 the block (8 warps, 4 a thread). A team inside one
// warp meets by __syncwarp, a larger one by block barriers (every team of
// the block takes the same steps). Lane t's outputs are e = t + TEAM j
// (j < CPL), all in the column t & (S - 1). The matrix is staged once a
// block (TxMats: tx_stage_mats from constant memory, or entry by entry
// with tx_put_mats), its rows padded so that lanes reading down a column
// hit distinct banks; a lane's outputs of the row stages share one matrix
// row (forward) or column (inverse), and of the column stages one data
// column, which it keeps in registers, and reads the rows it shares with
// other lanes 16 bytes a load (dot_row).

#pragma once

#include "tx_common.cuh"

namespace {

constexpr int kTuBlock = 256;  // threads a block of TU teams
constexpr unsigned kFull = 0xffffffffu;

// A TU of S x S = 1 << LOG2: TEAM lanes, CPL coefficients a lane, TUS TUs
// a block of kTuBlock.
template <int LOG2>
struct TuTeam {
    static constexpr int S = 1 << LOG2, N2 = S * S;
    static constexpr int TEAM =
        LOG2 == 5 ? kTuBlock : (LOG2 == 4 ? 64 : (N2 < 32 ? N2 : 32));
    static constexpr int CPL = N2 / TEAM, TUS = kTuBlock / TEAM;
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

// The S x S matrix, once a block: T padded (a lane's own row or column,
// read down a column by distinct lanes, hits distinct banks), T and its
// transpose aligned (rows that lanes share, read 16 bytes a load).
template <int LOG2>
struct TxMats {
    static constexpr int S = 1 << LOG2, TP = S + 1;  // the padded pitch
    int Tp[S * TP];
    alignas(16) int Ta[S * S];
    alignas(16) int Tt[S * S];
};

// entry e = k S + x of the S x S matrix into the three copies
template <int LOG2>
__device__ __forceinline__ void tx_put_mats(TxMats<LOG2>& m, int e, int v) {
    constexpr int S = 1 << LOG2;
    const int k = e >> LOG2, x = e & (S - 1);
    m.Tp[k * (S + 1) + x] = v;
    m.Ta[e] = v;
    m.Tt[x * S + k] = v;
}

// entry e of the S x S DCT: row e >> LOG2 of the 32-point rows 32 / S
// apart, column e & (S - 1)
template <int LOG2>
__device__ __forceinline__ int tx_dct_index(int e) {
    return ((e >> LOG2) << (5 - LOG2)) * 32 + (e & ((1 << LOG2) - 1));
}

// Every thread of the block calls it; the caller synchronises.
template <int LOG2>
__device__ __forceinline__ void tx_stage_mats(TxMats<LOG2>& m, int dst) {
    constexpr int N2 = 1 << (2 * LOG2);
    for (int e = threadIdx.x; e < N2; e += kTuBlock)
        tx_put_mats<LOG2>(m, e,
                          dst ? c_dst4[e] : c_dct32[tx_dct_index<LOG2>(e)]);
}

// X: the team's residual (complete, visible to the team) -> X: its
// coefficients; Y holds the rows stage. Ends with a team barrier.
template <int LOG2, int BD = 8>
__device__ __forceinline__ void team_forward(int* X, int* Y,
                                             const TxMats<LOG2>& m, int t) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, TEAM = L::TEAM, CPL = L::CPL, TP = S + 1;
    const int col = t & (S - 1);
    {  // forward rows: Y[y][k] = (sum_x X[y][x] T[k][x] + r1) >> s1
        constexpr int s1 = LOG2 + BD - 9;
        int tk[S];
#pragma unroll
        for (int x = 0; x < S; ++x) tk[x] = m.Tp[col * TP + x];
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
            X[t + TEAM * j] = (dot_row<S>(m.Ta + k * S, yc) + (1 << (s2 - 1)))
                              >> s2;
        }
    }
    team_sync<TEAM>();
}

// inverse columns: Y[y][j] = clip16((sum_k T[k][y] X[k][j] + 64) >> 7),
// X the dequantised coefficients (complete); no barrier
template <int LOG2>
__device__ __forceinline__ void team_inv_cols(const int* X, int* Y,
                                              const TxMats<LOG2>& m, int t) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, TEAM = L::TEAM, CPL = L::CPL;
    const int col = t & (S - 1);
    int xc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) xc[k] = X[k * S + col];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int y = (t + TEAM * j) >> LOG2;
        Y[t + TEAM * j] = clip16((dot_row<S>(m.Tt + y * S, xc) + 64) >> 7);
    }
}

// The inverse rows: tc = column col of T (the lane's outputs' column),
// then the output at row y: clip16((sum_k Y[y][k] T[k][col] + 2^(s3-1))
// >> s3), s3 = 20 - BD, Y the inverse columns' output (complete)
template <int LOG2>
__device__ __forceinline__ void tx_matrix_col(const TxMats<LOG2>& m, int col,
                                              int (&tc)[1 << LOG2]) {
    constexpr int S = 1 << LOG2, TP = S + 1;
#pragma unroll
    for (int k = 0; k < S; ++k) tc[k] = m.Tp[k * TP + col];
}

template <int LOG2, int BD = 8>
__device__ __forceinline__ int tx_inv_row_at(const int* Y,
                                             const int (&tc)[1 << LOG2],
                                             int y) {
    constexpr int S = 1 << LOG2, s3 = 20 - BD;
    return clip16((dot_row<S>(Y + y * S, tc) + (1 << (s3 - 1))) >> s3);
}

}  // namespace
