// b_me: the B step's two-list dense full-pel motion search.
//
// Replaces: tpuhevc/codec/inter_b.py:142-163, `dense_me` (a closure of
// `_b_step` that XLA compiled for the TPU), run once per reference list.
//
// What it computes, per 16x16 block n (raster order over the picture) and
// list l: SAD(dy, dx) = sum |ref_l[clamp(y - sr + dy)][clamp(x - sr + dx)]
// - org[y][x]| over the block for every (dy, dx) in [0, 2sr]^2 (the
// edge-padded reference of the reference); the float32 cost
// (float)SAD + lam_me * mvb[dy * side + dx], the product rounded on its
// own (built with -fmad=false, as JAX evaluates it); the argmin over the
// WHOLE window, first flat index winning ties as in jnp.argmin; mv =
// (bi % side - sr, bi / side - sr); and sad9[k] = SAD at the flat index
// clamp(bi + (k / 3 - 1) * side + (k % 3 - 1), 0, side^2 - 1), so that at
// the window's left or right edge a neighbour wraps into the adjacent row
// exactly as the reference reads it.
//
// What bounds it: integer work, 2 x 1089 x 256 abs-diffs per block at
// sr = 16 (0.2 G at 416x240), all on shared memory; device memory sees
// each window (48x48) and block once per list.
// Design: one block per (16x16 block, list). The clamped window and the
// block go to shared memory; threads split the candidates (neighbouring
// threads on neighbouring dx, conflict-free window reads) and keep their
// first minimum in increasing index order; the (cost, index) reduction
// is lexicographic, so the first minimum of the whole window wins.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 16;

__device__ __forceinline__ bool better(float c, int i, float bc, int bi) {
    return c < bc || (c == bc && i < bi);
}

__global__ void b_me_kernel(const int* __restrict__ org,
                            const int* __restrict__ ref0,
                            const int* __restrict__ ref1,
                            const float* __restrict__ mvb,
                            int* __restrict__ mv, int* __restrict__ sad9,
                            int H, int W, int sr, float lam_me) {
    extern __shared__ int smem[];
    const int side = 2 * sr + 1, win = kBlk + 2 * sr, nw = W / kBlk;
    int* s_wnd = smem;                     // win * win
    int* s_cur = s_wnd + win * win;        // 16 x 16
    int* s_sad = s_cur + kBlk * kBlk;      // side * side
    __shared__ float w_cost[kThreads / 32];
    __shared__ int w_idx[kThreads / 32];

    const int n = blockIdx.x, list = blockIdx.y;
    const int* ref = list ? ref1 : ref0;
    const int y0 = (n / nw) * kBlk, x0 = (n - (n / nw) * nw) * kBlk;
    for (int e = threadIdx.x; e < win * win; e += blockDim.x) {
        const int r = e / win, c = e - (e / win) * win;
        const int yy = min(max(y0 - sr + r, 0), H - 1);
        const int xx = min(max(x0 - sr + c, 0), W - 1);
        s_wnd[e] = ref[(size_t)yy * W + xx];
    }
    for (int e = threadIdx.x; e < kBlk * kBlk; e += blockDim.x)
        s_cur[e] = org[(size_t)(y0 + (e >> 4)) * W + x0 + (e & 15)];
    __syncthreads();

    float bc = FLT_MAX;
    int bi = INT_MAX;
    for (int k = threadIdx.x; k < side * side; k += blockDim.x) {
        const int dy = k / side, dx = k - (k / side) * side;
        int acc = 0;
        for (int r = 0; r < kBlk; ++r) {
            const int* wr = s_wnd + (dy + r) * win + dx;
            const int* cr = s_cur + r * kBlk;
#pragma unroll
            for (int c = 0; c < kBlk; ++c) acc += abs(wr[c] - cr[c]);
        }
        s_sad[k] = acc;
        const float rate = lam_me * mvb[k];
        const float cost = (float)acc + rate;
        if (cost < bc) { bc = cost; bi = k; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float oc = __shfl_down_sync(0xffffffffu, bc, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(oc, oi, bc, bi)) { bc = oc; bi = oi; }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) { w_cost[warp] = bc; w_idx[warp] = bi; }
    __syncthreads();  // also completes s_sad
    if (threadIdx.x == 0) {
        bc = w_cost[0];
        bi = w_idx[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            if (better(w_cost[w], w_idx[w], bc, bi)) {
                bc = w_cost[w];
                bi = w_idx[w];
            }
        const size_t o = (size_t)list * gridDim.x + n;
        mv[2 * o] = bi % side - sr;
        mv[2 * o + 1] = bi / side - sr;
        for (int k = 0; k < 9; ++k) {
            const int j = bi + (k / 3 - 1) * side + (k % 3 - 1);
            sad9[9 * o + k] = s_sad[min(max(j, 0), side * side - 1)];
        }
    }
}

}  // namespace

// org, ref0, ref1 (H, W) int32 planes on the device, H and W multiples of
// 16; mvb (side * side) float32, side = 2 sr + 1. Writes mv (2, n, 2) and
// sad9 (2, n, 9) int32, n = (H / 16) * (W / 16), list 0 first.
extern "C" int tpuhevc_b_me(const int* org, const int* ref0, const int* ref1,
                            const float* mvb, int* mv, int* sad9, int H,
                            int W, int sr, float lam_me, void* stream) {
    const int side = 2 * sr + 1, win = kBlk + 2 * sr;
    const int n = (H / kBlk) * (W / kBlk);
    const size_t smem =
        (size_t)(win * win + kBlk * kBlk + side * side) * sizeof(int);
    b_me_kernel<<<dim3(n, 2), kThreads, smem, (cudaStream_t)stream>>>(
        org, ref0, ref1, mvb, mv, sad9, H, W, sr, lam_me);
    return (int)cudaGetLastError();
}
