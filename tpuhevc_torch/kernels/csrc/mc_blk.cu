// K3: DCT-IF motion-compensated prediction of whole blocks.
//
// Replaces: tpuhevc/codec/inter_batch.py:166, `mc_blk` (a closure of
// build_ldp_scan that XLA compiled for the TPU); same semantics as
// tpuhevc/ops/interp.py:141 `mc` at 8 bits.
//
// What it computes, per PU n: the integer position (x + (mv >> FS),
// y + (mv >> FS)) and the phase (mv & FM), with >> and & on signed ints
// (floor, as in JAX); the (S + NT - 1)^2 window clamped at the plane edge;
// acc_h[r][c] = sum_i win[r][c + i] * taps[fx][i]; acc[r][c] =
// (sum_i acc_h[r + i][c] * taps[fy][i]) >> 6; out = clip((acc + 32) >> 6,
// 0, 255). Luma: 8 taps, quarter pel (FS 2, FM 3); chroma: 4 taps, eighth
// pel (FS 3, FM 7).
//
// What bounds it: the gather of the window from the reference plane
// (~6 KB per 32x32 luma PU, mostly L2 hits, since neighbouring PUs
// overlap); the arithmetic is ~2 x 8 MACs per output sample.
// Design: one block per PU. The block gathers its clamped window into
// shared memory once (neighbouring threads on neighbouring columns), runs
// the horizontal pass into a second shared array, then the vertical pass
// to the output, all in int32 (the sums stay below 2^22); the filter is
// mc_common.cuh's, shared with b_pred.cu.

#include "mc_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int NT, int OFF, int FS, int FM>
__global__ void mc_blk_kernel(const int* __restrict__ plane, int H, int W,
                              const int* __restrict__ xs,
                              const int* __restrict__ ys,
                              const int* __restrict__ mvq,
                              const int* __restrict__ taps,
                              int* __restrict__ out, int size) {
    extern __shared__ int smem[];
    int* s_win = smem;                                // win * win
    int* s_h = s_win + (size + NT - 1) * (size + NT - 1);  // win x size
    const int n = blockIdx.x;
    int* dst = out + (size_t)n * size * size;
    mc_filter<NT, OFF, FS, FM>(
        plane, H, W, xs[n], ys[n], mvq[2 * n], mvq[2 * n + 1], taps, size,
        s_win, s_h,
        [&](int e, int v) { dst[e] = min(max((v + 32) >> 6, 0), 255); });
}

}  // namespace

// plane (H, W), xs/ys (n,), mvq (n, 2), taps (phases, NT): int32 on the
// device. Writes out (n, size, size). is_luma selects 8-tap quarter-pel
// (taps 4 x 8) or 4-tap eighth-pel (taps 8 x 4).
extern "C" int tpuhevc_mc_blk(const int* plane, const int* xs, const int* ys,
                              const int* mvq, const int* taps, int* out, int n,
                              int H, int W, int size, int is_luma,
                              void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (is_luma) {
        const int win = size + 7;
        const size_t smem = (size_t)(win * win + win * size) * sizeof(int);
        mc_blk_kernel<8, 3, 2, 3><<<n, kThreads, smem, st>>>(
            plane, H, W, xs, ys, mvq, taps, out, size);
    } else {
        const int win = size + 3;
        const size_t smem = (size_t)(win * win + win * size) * sizeof(int);
        mc_blk_kernel<4, 1, 3, 7><<<n, kThreads, smem, st>>>(
            plane, H, W, xs, ys, mvq, taps, out, size);
    }
    return (int)cudaGetLastError();
}
