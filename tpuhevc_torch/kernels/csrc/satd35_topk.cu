// satd35_topk: Hadamard SATD of the 35-mode intra bank and the top-nc.
//
// Replaces: tpuhevc/codec/intra_decide_jax.py:75-84 (`satd35`) and the
// `lax.top_k(-sat, nc)` at :130 (a closure of `_build` that XLA compiled
// for the TPU).
//
// What it computes, per block n and mode m, d = org[n] - preds[n][m]:
//   S >= 8: sum over the 8x8 tiles of (sum |H8 d H8^T| + 2) >> 2;
//   S = 4:  (sum |H4 d H4^T| + 1) >> 1;
// then the nc modes of least SATD in ascending order, the lower mode
// first among equals (what top_k of the negated costs returns). Integer
// and exact: JAX's float32 products are exact here (an 8x8 sum stays
// below 2^24), so the values equal JAX's bit for bit.
//
// What bounds it: reads of 35 S^2 predictions per block (the only large
// input) and 2 x 24 add/subs per 8x8 row pass; memory- and
// latency-bound.
// Design: one block per target block; the original block in shared
// memory; each thread takes (mode, tile) tasks, holds the tile in
// registers for an in-place butterfly (the Sylvester ordering gives the
// same sum of magnitudes as any Hadamard ordering) and adds its rounded
// tile sum to the mode's total with an integer shared atomic (order
// free). One thread then selects the top-nc by repeated first-minimum.
// The butterfly is hadamard.cuh's.

#include "hadamard.cuh"

namespace {

constexpr int kThreads = 128;

template <int T>
__device__ __forceinline__ int tile_satd(const int* org, const int* pred,
                                         int S, int ty, int tx) {
    int v[T * T];
#pragma unroll
    for (int i = 0; i < T * T; ++i) {
        const int e = (ty * T + i / T) * S + tx * T + i % T;
        v[i] = org[e] - pred[e];
    }
    const int s = hadamard_abs_sum<T>(v);
    return T == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
}

__global__ void satd35_topk_kernel(const int* __restrict__ org,
                                   const int* __restrict__ preds,
                                   int* __restrict__ sat_out,
                                   int* __restrict__ topk_out,
                                   int log2, int nc) {
    extern __shared__ int s_org[];
    __shared__ int s_sat[35];
    const int S = 1 << log2, n2 = S * S;
    const int n = blockIdx.x;
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        s_org[e] = org[(size_t)n * n2 + e];
    for (int m = threadIdx.x; m < 35; m += blockDim.x) s_sat[m] = 0;
    __syncthreads();

    const int tw = S >= 8 ? S >> 3 : 1;  // tiles per row
    const int ntiles = tw * tw;
    const int* pb = preds + (size_t)n * 35 * n2;
    for (int task = threadIdx.x; task < 35 * ntiles; task += blockDim.x) {
        const int m = task / ntiles, tile = task - m * ntiles;
        const int ty = tile / tw, tx = tile - ty * tw;
        const int v = S >= 8 ? tile_satd<8>(s_org, pb + (size_t)m * n2, S, ty, tx)
                             : tile_satd<4>(s_org, pb + (size_t)m * n2, S, 0, 0);
        atomicAdd(&s_sat[m], v);
    }
    __syncthreads();

    for (int m = threadIdx.x; m < 35; m += blockDim.x)
        sat_out[(size_t)n * 35 + m] = s_sat[m];
    if (threadIdx.x == 0) {
        unsigned long long taken = 0ull;
        for (int k = 0; k < nc; ++k) {
            int best = -1;
            for (int m = 0; m < 35; ++m) {
                if ((taken >> m) & 1ull) continue;
                if (best < 0 || s_sat[m] < s_sat[best]) best = m;
            }
            taken |= 1ull << best;
            topk_out[(size_t)n * nc + k] = best;
        }
    }
}

}  // namespace

// org (n, S, S), preds (n, 35, S, S) int32 on the device, S = 1 << log2
// in 4..32, 1 <= nc <= 35 -> sat (n, 35), topk (n, nc) int32.
extern "C" int tpuhevc_satd35_topk(const int* org, const int* preds,
                                   int* sat, int* topk, int n, int log2,
                                   int nc, void* stream) {
    const size_t smem = sizeof(int) << (2 * log2);
    satd35_topk_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        org, preds, sat, topk, log2, nc);
    return (int)cudaGetLastError();
}
