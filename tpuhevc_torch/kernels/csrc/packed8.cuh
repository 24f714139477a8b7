// 8-bit samples packed four to a word: the staging of the SAD kernels
// that read int32 planes of 8-bit video (b_me.cu, sad_search.cu), whose
// abs-diffs then run four samples an instruction (__vsadu4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// four 8-bit samples (0..255) packed into a word, the first lowest
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
    return (unsigned)a | ((unsigned)b << 8) | ((unsigned)c << 16)
           | ((unsigned)d << 24);
}

// NS (8 or 16) samples p[clamp(x + i, 0, W - 1)] as NS / 4 packed words:
// 16-byte loads where the run lies inside the row and is aligned
template <int NS>
__device__ __forceinline__ void pack_run(const int* __restrict__ p, int x,
                                         int W, unsigned* out) {
    int s[NS];
    if (x >= 0 && x + NS <= W && (((uintptr_t)(p + x)) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < NS / 4; ++q) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(p + x) + q);
            s[4 * q] = v.x;
            s[4 * q + 1] = v.y;
            s[4 * q + 2] = v.z;
            s[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < NS; ++i)
            s[i] = __ldg(p + min(max(x + i, 0), W - 1));
    }
#pragma unroll
    for (int q = 0; q < NS / 4; ++q)
        out[q] = pack4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
}

__device__ __forceinline__ uint4 run16(const int* p, int x, int W) {
    unsigned o[4];
    pack_run<16>(p, x, W, o);
    return make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace
