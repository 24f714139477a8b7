// b_pred: the B step's two-list prediction and uni/bi arbitration.
//
// Replaces: tpuhevc/codec/inter_b.py:196-222 (luma) and 225-232 (chroma),
// the prediction part of `step` in `_b_step` that XLA compiled for the
// TPU, over tpuhevc/ops/interp.py:141-211 (`mc`, `mc14`, `bi_average`),
// 8-bit.
//
// What it computes, per block n and list l: the integer position
// (x + (mv >> FS), y + (mv >> FS)) and the phase (mv & FM), with >> and &
// on signed ints (floor, as in JAX); the (S + NT - 1)^2 window clamped at
// the plane edge; the separable DCT-IF filter to the 14-bit intermediate
// p_l = (sum_i (sum_j win * th[j]) * tv[i]) >> 6; the uni predictions
// u_l = clip((p_l + 32) >> 6, 0, 255) and the bi-average
// clip((p_0 + p_1 + 64) >> 7, 0, 255). For luma (decide = 1) the int32
// SSEs of the three against cur, rounded once to float32, and the costs
//   cost_l  = sse_l  + lam * (b_l + 2)
//   cost_bi = sse_bi + lam * (b_0 + b_1 + 2),  b_l = (|mvx| + |mvy|) / 4 + 4
// each product rounded on its own (built with -fmad=false, as JAX
// evaluates them); inter_dir = 3 if cost_bi <= min(cost_0, cost_1), else
// 1 if cost_0 <= cost_1, else 2. Chroma (decide = 0) reads the luma
// inter_dir. The output is the prediction inter_dir selects.
//
// What bounds it: the two window gathers from the reference planes
// (23x23 per 16x16 luma block, mostly L2 hits) and ~2 x 2 x 8 MACs per
// output sample; latency-bound at 390 blocks.
// Design: one block per 16x16 block (one per 8x8 chroma block), the two
// lists in turn through one window and one horizontal buffer in shared
// memory (the filter of mc_common.cuh, shared with K3's mc_blk.cu), both
// 14-bit predictions kept in shared memory; the three SSEs are block
// reductions and thread 0 arbitrates.

#include "mc_common.cuh"

namespace {

__device__ __forceinline__ int block_sum(int v, int* scratch) {
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

__device__ __forceinline__ int clip8(int v) { return min(max(v, 0), 255); }

template <int NT, int OFF, int FS, int FM>
__global__ void b_pred_kernel(const int* __restrict__ cur,
                              const int* __restrict__ ref0,
                              const int* __restrict__ ref1,
                              const int* __restrict__ xs,
                              const int* __restrict__ ys,
                              const int* __restrict__ mvq0,
                              const int* __restrict__ mvq1,
                              const int* __restrict__ taps,
                              int* __restrict__ pred,
                              int* __restrict__ inter_dir, int H, int W,
                              int size, int decide, float lam) {
    extern __shared__ int smem[];
    __shared__ int scratch[32];
    __shared__ int s_dir;
    const int win = size + NT - 1, n2 = size * size;
    int* s_win = smem;              // win * win
    int* s_h = s_win + win * win;   // win rows x size cols
    int* s_p = s_h + win * size;    // 2 x n2: the 14-bit predictions
    const int n = blockIdx.x;

    for (int l = 0; l < 2; ++l) {
        const int* mvq = l ? mvq1 : mvq0;
        int* dst = s_p + l * n2;
        mc_filter<NT, OFF, FS, FM>(
            l ? ref1 : ref0, H, W, xs[n], ys[n], mvq[2 * n], mvq[2 * n + 1],
            taps, size, s_win, s_h, [&](int e, int v) { dst[e] = v; });
    }

    const int* p0 = s_p;
    const int* p1 = s_p + n2;
    if (decide) {
        const int* cb = cur + (size_t)n * n2;
        int s0 = 0, s1 = 0, sb = 0;
        for (int e = threadIdx.x; e < n2; e += blockDim.x) {
            const int c = cb[e];
            const int d0 = c - clip8((p0[e] + 32) >> 6);
            const int d1 = c - clip8((p1[e] + 32) >> 6);
            const int db = c - clip8((p0[e] + p1[e] + 64) >> 7);
            s0 += d0 * d0;
            s1 += d1 * d1;
            sb += db * db;
        }
        s0 = block_sum(s0, scratch);
        s1 = block_sum(s1, scratch);
        sb = block_sum(sb, scratch);
        if (threadIdx.x == 0) {
            const float b0 =
                (float)((abs(mvq0[2 * n]) + abs(mvq0[2 * n + 1])) / 4 + 4);
            const float b1 =
                (float)((abs(mvq1[2 * n]) + abs(mvq1[2 * n + 1])) / 4 + 4);
            const float r0 = lam * (b0 + 2.0f);
            const float r1 = lam * (b1 + 2.0f);
            const float rb = lam * ((b0 + b1) + 2.0f);
            const float cost0 = (float)s0 + r0;
            const float cost1 = (float)s1 + r1;
            const float cost_bi = (float)sb + rb;
            const int dir = cost_bi <= fminf(cost0, cost1)
                                ? 3 : (cost0 <= cost1 ? 1 : 2);
            inter_dir[n] = dir;
            s_dir = dir;
        }
    } else if (threadIdx.x == 0) {
        s_dir = inter_dir[n];
    }
    __syncthreads();
    const int dir = s_dir;
    int* out = pred + (size_t)n * n2;
    for (int e = threadIdx.x; e < n2; e += blockDim.x)
        out[e] = dir == 1 ? clip8((p0[e] + 32) >> 6)
               : dir == 2 ? clip8((p1[e] + 32) >> 6)
                          : clip8((p0[e] + p1[e] + 64) >> 7);
}

}  // namespace

// cur (n, S, S) (read only with decide), ref0 / ref1 (H, W), xs / ys (n,),
// mvq0 / mvq1 (n, 2), taps (phases, NT): int32 on the device. Writes pred
// (n, S, S) and, with decide, inter_dir (n,); without, reads inter_dir.
// is_luma selects 8-tap quarter-pel (taps 4 x 8) or 4-tap eighth-pel
// (taps 8 x 4); lam is the full lambda rounded to float32.
extern "C" int tpuhevc_b_pred(const int* cur, const int* ref0,
                              const int* ref1, const int* xs, const int* ys,
                              const int* mvq0, const int* mvq1,
                              const int* taps, int* pred, int* inter_dir,
                              int n, int H, int W, int size, int is_luma,
                              int decide, float lam, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = size * size >= 256 ? 256 : 64;
    if (is_luma) {
        const int win = size + 7;
        const size_t smem =
            (size_t)(win * win + win * size + 2 * size * size) * sizeof(int);
        b_pred_kernel<8, 3, 2, 3><<<n, threads, smem, st>>>(
            cur, ref0, ref1, xs, ys, mvq0, mvq1, taps, pred, inter_dir, H, W,
            size, decide, lam);
    } else {
        const int win = size + 3;
        const size_t smem =
            (size_t)(win * win + win * size + 2 * size * size) * sizeof(int);
        b_pred_kernel<4, 1, 3, 7><<<n, threads, smem, st>>>(
            cur, ref0, ref1, xs, ys, mvq0, mvq1, taps, pred, inter_dir, H, W,
            size, decide, lam);
    }
    return (int)cudaGetLastError();
}
