// The T x T Hadamard magnitude sum of a tile spread over T lanes, a row
// each, shared by the SATD kernels (satd35_topk.cu at T = 4 and 8;
// grid_pred.cu and grid_intra.cu at T = 8; intra_wave.cu and
// stripe_prescreen.cu at T = 8 through the variant whose column stages
// multiply by the lane's sign).
//
// What it computes: sum |H d H^T| over the tile d (T = 4 or 8), H the
// Sylvester Hadamard matrix: an in-place butterfly over each lane's row in
// registers, then the column butterflies across the lanes by shuffles.
// Any ordering of the Hadamard rows gives the same sum of magnitudes, so
// this equals HM's butterflies (TComRdCost::xCalcHADs8x8 / 4x4) and
// tpuhevc's H d H^T products. Integer and exact. The caller rounds:
// (s + 2) >> 2 at 8x8, (s + 1) >> 1 at 4x4.

#pragma once

#include <cuda_runtime.h>

namespace {

// sum |H d H^T| of a T x T tile held by T consecutive lanes (the group
// aligned to T), lane r holding row r in v (r = lane & (T - 1)): the
// magnitudes summed over the T lanes. Every lane of the warp must call
// it; each lane of the group gets the tile's sum.
template <int T>
__device__ __forceinline__ int hadamard_lanes_abs_sum(int (&v)[T], int r) {
#pragma unroll
    for (int h = 1; h < T; h <<= 1) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
            if (i & h) continue;
            const int a = v[i], b = v[i + h];
            v[i] = a + b;
            v[i + h] = a - b;
        }
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
        for (int h = 1; h < T; h <<= 1) {
            const int o = __shfl_xor_sync(0xffffffffu, v[i], h);
            v[i] = (r & h) ? o - v[i] : v[i] + o;
        }
        s += abs(v[i]);
    }
#pragma unroll
    for (int h = 1; h < T; h <<= 1) s += __shfl_xor_sync(0xffffffffu, s, h);
    return s;
}

__device__ __forceinline__ int hadamard8_lanes_abs_sum(int (&v)[8], int r) {
    return hadamard_lanes_abs_sum<8>(v, r);
}

// hadamard8_lanes_abs_sum with each column stage one shuffle and one
// multiply-add by the lane's sign (a select there); the same integers
__device__ __forceinline__ int hadamard8_lanes_abs_sum_signed(int (&v)[8],
                                                              int r) {
#pragma unroll
    for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            if (i & h) continue;
            const int a = v[i], b = v[i + h];
            v[i] = a + b;
            v[i + h] = a - b;
        }
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 1; h < 8; h <<= 1) {
            const int o = __shfl_xor_sync(0xffffffffu, v[i], h);
            v[i] = o + ((r & h) ? -1 : 1) * v[i];
        }
        s += abs(v[i]);
    }
#pragma unroll
    for (int h = 1; h < 8; h <<= 1) s += __shfl_xor_sync(0xffffffffu, s, h);
    return s;
}

}  // namespace
