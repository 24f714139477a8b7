// The DCT-IF block interpolation on shared memory, shared by the MC
// kernels (mc_blk.cu, b_pred.cu).
//
// What it computes, for one S x S block at (x, y) with MV (mvx, mvy):
// the integer position (x + (mv >> FS) - OFF, y + (mv >> FS) - OFF) and
// the phase (mv & FM), with >> and & on signed ints (floor, as in JAX);
// the (S + NT - 1)^2 window clamped at the plane edge; the horizontal
// pass h[r][c] = sum_i win[r][c + i] * taps[fx][i] and the vertical pass
// v[r][c] = (sum_i h[r + i][c] * taps[fy][i]) >> 6, the 14-bit
// intermediate of tpuhevc/ops/interp.py `mc14` at 8 bits, all in int32
// (the sums stay below 2^22). Luma: NT 8, OFF 3, quarter pel (FS 2,
// FM 3); chroma: NT 4, OFF 1, eighth pel (FS 3, FM 7).
//
// All threads of the block call mc_filter; it hands every output to
// store(e, v) (e = r * S + c) and ends with a barrier.

#pragma once

#include <cuda_runtime.h>

namespace {

template <int NT, int OFF, int FS, int FM, typename Store>
__device__ __forceinline__ void mc_filter(const int* __restrict__ plane,
                                          int H, int W, int x, int y,
                                          int mvx, int mvy,
                                          const int* __restrict__ taps,
                                          int size, int* s_win, int* s_h,
                                          Store store) {
    const int win = size + NT - 1;
    const int ix = x + (mvx >> FS) - OFF;
    const int iy = y + (mvy >> FS) - OFF;
    const int fx = mvx & FM, fy = mvy & FM;
    int th[NT], tv[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        th[i] = taps[fx * NT + i];
        tv[i] = taps[fy * NT + i];
    }
    for (int e = threadIdx.x; e < win * win; e += blockDim.x) {
        const int r = e / win, c = e - (e / win) * win;
        const int yy = min(max(iy + r, 0), H - 1);
        const int xx = min(max(ix + c, 0), W - 1);
        s_win[e] = plane[(size_t)yy * W + xx];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < win * size; e += blockDim.x) {
        const int r = e / size, c = e - (e / size) * size;
        const int* src = s_win + r * win + c;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc += src[i] * th[i];
        s_h[e] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < size * size; e += blockDim.x) {
        const int r = e / size, c = e - (e / size) * size;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc += s_h[(r + i) * size + c] * tv[i];
        store(e, acc >> 6);
    }
    __syncthreads();
}

}  // namespace
