// The T x T Hadamard magnitude sum of a tile, shared by the SATD kernels
// (satd35_topk.cu: a tile in one thread's registers; intra_wave.cu: an
// 8x8 tile spread over 8 lanes, a row each).
//
// What it computes: sum |H d H^T| over the tile d (T = 4 or 8), H the
// Sylvester Hadamard matrix, with an in-place butterfly over the rows and
// then the columns. Any ordering of the Hadamard rows gives the same sum
// of magnitudes, so this equals HM's 3-stage butterflies
// (TComRdCost::xCalcHADs8x8) and tpuhevc's H d H^T products. Integer and
// exact. The caller rounds: (s + 2) >> 2 at 8x8, (s + 1) >> 1 at 4x4.

#pragma once

#include <cuda_runtime.h>

namespace {

template <int T>
__device__ __forceinline__ int hadamard_abs_sum(int (&v)[T * T]) {
#pragma unroll
    for (int r = 0; r < T; ++r) {
#pragma unroll
        for (int h = 1; h < T; h <<= 1) {
#pragma unroll
            for (int i = 0; i < T; ++i) {
                if (i & h) continue;
                const int a = v[r * T + i], b = v[r * T + i + h];
                v[r * T + i] = a + b;
                v[r * T + i + h] = a - b;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < T; ++c) {
#pragma unroll
        for (int h = 1; h < T; h <<= 1) {
#pragma unroll
            for (int i = 0; i < T; ++i) {
                if (i & h) continue;
                const int a = v[i * T + c], b = v[(i + h) * T + c];
                v[i * T + c] = a + b;
                v[(i + h) * T + c] = a - b;
            }
        }
    }
    int s = 0;
#pragma unroll
    for (int i = 0; i < T * T; ++i) s += abs(v[i]);
    return s;
}

// sum |H d H^T| of an 8x8 tile held by 8 consecutive lanes, lane r
// holding row r in v (r = lane & 7): the row butterfly in registers, the
// column butterflies across the lanes by shuffles, the magnitudes summed
// over the 8 lanes. Every lane of the warp must call it; each lane of the
// group gets the tile's sum.
__device__ __forceinline__ int hadamard8_lanes_abs_sum(int (&v)[8], int r) {
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
            v[i] = (r & h) ? o - v[i] : v[i] + o;
        }
        s += abs(v[i]);
    }
#pragma unroll
    for (int h = 1; h < 8; h <<= 1) s += __shfl_xor_sync(0xffffffffu, s, h);
    return s;
}

}  // namespace
