// The HEVC core transform and the flat quantiser on shared memory,
// shared by the TU kernels (txq.cu, intra_txq.cu, b_txq.cu, grid_code.cu,
// intra_wave.cu).
//
// What it computes, for an S x S block (S = 1 << log2 in 4..32) of
// bit depth BD (a template argument, 8 unless given):
//   forward:  h = (r T^T + 2^(s1-1)) >> s1, s1 = log2 + BD - 9;
//             c = (T h + 2^(s2-1)) >> s2,   s2 = log2 + 6
//   inverse:  g = clip16((T^T d + 64) >> 7);
//             r = clip16((g T + 2^(s3-1)) >> s3), s3 = 20 - BD
//   quantise: sign(c) * ((|c| * scale + add) >> qbits), clip16
//   dequantise: lvl * dqscale, a rounded >> dqshift (or << -dqshift), clip16
// with T the S-point DCT-II (rows 32/S apart of the 32-point matrix) or
// the 4x4 DST-VII, as tpuhevc/ops/transforms.py:144-198. Every sum is
// int32 exactly as under JAX (stage sums stay below 2^28).
//
// The matrices sit in constant memory (each including file has its own
// copy and its own init entry point); `tx_load_matrix` stages the S x S
// matrix into shared memory so that threads of a warp reading different
// rows do not serialise. Each stage is one output per call
// (`tx_fwd_rows` .. `tx_inv_rows`), so that a kernel can spread the
// outputs of many blocks over its threads; `tx_forward` / `tx_inverse`
// run one block's stages with the whole thread block, one thread per
// output, a barrier after each stage.

#pragma once

#include <cuda_runtime.h>

namespace {

__constant__ int c_dct32[32 * 32];
__constant__ int c_dst4[4 * 4];

__device__ __forceinline__ int clip16(int v) {
    return min(max(v, -32768), 32767);
}

// T[k][x] of the S x S transform; the caller synchronises.
__device__ __forceinline__ void tx_load_matrix(int* T, int log2, bool dst) {
    const int n2 = 1 << (2 * log2), mask = (1 << log2) - 1;
    const int step = 5 - log2;
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        T[e] = dst ? c_dst4[e]
                   : c_dct32[((e >> log2) << step) * 32 + (e & mask)];
}

// Output e of each stage of an S x S block: forward rows (A residual ->
// B), forward columns (B -> coefficients), inverse columns (A dequantised
// -> B), inverse rows (B -> residual).
template <int BD = 8>
__device__ __forceinline__ int tx_fwd_rows(const int* A, const int* T,
                                           int log2, int e) {
    const int S = 1 << log2, y = e >> log2, k = e & (S - 1);
    const int s1 = log2 + BD - 9;
    int acc = 0;
    for (int x = 0; x < S; ++x) acc += A[y * S + x] * T[k * S + x];
    return (acc + (1 << (s1 - 1))) >> s1;
}

__device__ __forceinline__ int tx_fwd_cols(const int* B, const int* T,
                                           int log2, int e) {
    const int S = 1 << log2, k = e >> log2, j = e & (S - 1);
    const int s2 = log2 + 6;
    int acc = 0;
    for (int y = 0; y < S; ++y) acc += T[k * S + y] * B[y * S + j];
    return (acc + (1 << (s2 - 1))) >> s2;
}

__device__ __forceinline__ int tx_inv_cols(const int* A, const int* T,
                                           int log2, int e) {
    const int S = 1 << log2, y = e >> log2, j = e & (S - 1);
    int acc = 0;
    for (int k = 0; k < S; ++k) acc += T[k * S + y] * A[k * S + j];
    return clip16((acc + 64) >> 7);
}

template <int BD = 8>
__device__ __forceinline__ int tx_inv_rows(const int* B, const int* T,
                                           int log2, int e) {
    const int S = 1 << log2, y = e >> log2, x = e & (S - 1);
    constexpr int s3 = 20 - BD;
    int acc = 0;
    for (int k = 0; k < S; ++k) acc += B[y * S + k] * T[k * S + x];
    return clip16((acc + (1 << (s3 - 1))) >> s3);
}

// the flat quantiser and the dequantiser, as quant_params /
// dequant_params of tpuhevc_torch/ops/transforms.py give their constants
__device__ __forceinline__ int tx_quant(int c, int scale, int add,
                                        int qbits) {
    const int level = (abs(c) * scale + add) >> qbits;
    return clip16(c < 0 ? -level : level);
}

__device__ __forceinline__ int tx_dequant(int lev, int dqscale,
                                          int dqshift) {
    const int x = lev * dqscale;
    return clip16(dqshift > 0 ? (x + (1 << (dqshift - 1))) >> dqshift
                              : x * (1 << -dqshift));
}

// A (residual [y][x]) -> A (coefficients [k][j]); B is scratch. Both
// stages end with a barrier; A must be complete on entry.
__device__ __forceinline__ void tx_forward(int* A, int* B, const int* T,
                                           int log2) {
    const int n2 = 1 << (2 * log2);
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        B[e] = tx_fwd_rows(A, T, log2, e);
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        A[e] = tx_fwd_cols(B, T, log2, e);
    __syncthreads();
}

// A (dequantised coefficients) -> A (residual); B is scratch.
__device__ __forceinline__ void tx_inverse(int* A, int* B, const int* T,
                                           int log2) {
    const int n2 = 1 << (2 * log2);
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        B[e] = tx_inv_cols(A, T, log2, e);
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        A[e] = tx_inv_rows(B, T, log2, e);
    __syncthreads();
}

// sum of v over the block; every thread gets the total
__device__ int block_sum(int v, int* scratch) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
    __syncthreads();
    return total;
}

}  // namespace
