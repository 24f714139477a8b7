// The HEVC core transform on shared memory, shared by the TU kernels
// (txq.cu, intra_txq.cu).
//
// What it computes, for an S x S block (S = 1 << log2 in 4..32, 8-bit):
//   forward:  h = (r T^T + 2^(s1-1)) >> s1, s1 = log2 - 1;
//             c = (T h + 2^(s2-1)) >> s2,   s2 = log2 + 6
//   inverse:  g = clip16((T^T d + 64) >> 7); r = clip16((g T + 2048) >> 12)
// with T the S-point DCT-II (rows 32/S apart of the 32-point matrix) or
// the 4x4 DST-VII, as tpuhevc/ops/transforms.py:144-167. Every sum is
// int32 exactly as under JAX (stage sums stay below 2^28).
//
// The matrices sit in constant memory (each including file has its own
// copy and its own init entry point); `tx_load_matrix` stages the S x S
// matrix into shared memory so that threads of a warp reading different
// rows do not serialise. Each stage is one pass over the S x S outputs,
// one thread per output, followed by a barrier.

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

// A (residual [y][x]) -> A (coefficients [k][j]); B is scratch. Both
// stages end with a barrier; A must be complete on entry.
__device__ __forceinline__ void tx_forward(int* A, int* B, const int* T,
                                           int log2) {
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    const int s1 = log2 - 1, s2 = log2 + 6;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, k = e & mask;
        int acc = 0;
        for (int x = 0; x < S; ++x) acc += A[y * S + x] * T[k * S + x];
        B[e] = (acc + (1 << (s1 - 1))) >> s1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int k = e >> log2, j = e & mask;
        int acc = 0;
        for (int y = 0; y < S; ++y) acc += T[k * S + y] * B[y * S + j];
        A[e] = (acc + (1 << (s2 - 1))) >> s2;
    }
    __syncthreads();
}

// A (dequantised coefficients) -> A (residual); B is scratch.
__device__ __forceinline__ void tx_inverse(int* A, int* B, const int* T,
                                           int log2) {
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, j = e & mask;
        int acc = 0;
        for (int k = 0; k < S; ++k) acc += T[k * S + y] * A[k * S + j];
        B[e] = clip16((acc + 64) >> 7);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, x = e & mask;
        int acc = 0;
        for (int k = 0; k < S; ++k) acc += B[y * S + k] * T[k * S + x];
        A[e] = clip16((acc + 2048) >> 12);
    }
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
