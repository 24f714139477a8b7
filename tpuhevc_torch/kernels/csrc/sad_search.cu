// K1: dense full-pel SAD search with the NN-FME 3x3 SAD surface.
//
// Replaces: tpuhevc/codec/inter_batch.py:139, `sad_search` (a closure of
// build_ldp_scan that XLA compiled for the TPU), and, with subsample 0,
// tpuhevc/ops/me.py:123 `integer_me` (the per-frame P stage's search).
//
// What it computes, per PU n: SAD(dy, dx) over the clipped search window
// for every (dy, dx) in [0, 2sr]^2, with subsample rows 0,2,4,... only
// and the sum <<1 when size > 8; cost = SAD + ((bits[dy][dx] * lam_me) >> 8) in int32; the
// argmin over the inner (2sr-1)^2 square in row-major order with the first
// index winning ties; mv = (bx - sr, by - sr) and the 3x3 raw SADs around
// the winner.
//
// What bounds it: integer work, ~0.5 M abs-diffs per 32x32 PU (1089
// candidates x 512 samples), all on data that fits in shared memory; the
// window is read from device memory once.
// Design: one block per PU. The clipped window (<= 64x64 int32 at S=32,
// sr=16) and the PU go to shared memory; the block's threads split the
// candidates, each summing one SAD with neighbouring threads on
// neighbouring offsets (conflict-free shared reads). The argmin is a
// (cost, index) reduction, lexicographic, so the first minimum wins as in
// jnp.argmin.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(int c, int i, int bc, int bi) {
    return c < bc || (c == bc && i < bi);
}

__global__ void sad_search_kernel(const int* __restrict__ wnd,
                                  const int* __restrict__ cur,
                                  const int* __restrict__ bits,
                                  int* __restrict__ mv,
                                  int* __restrict__ sad9,
                                  int size, int sr, int lam_me,
                                  int subsample) {
    extern __shared__ int smem[];
    const int m = 2 * sr + 1;
    const int win = size + 2 * sr;
    int* s_wnd = smem;                    // win * win
    int* s_cur = s_wnd + win * win;       // size * size
    int* s_sad = s_cur + size * size;     // m * m
    __shared__ int w_cost[kThreads / 32];
    __shared__ int w_idx[kThreads / 32];

    const int n = blockIdx.x;
    const int* gw = wnd + (size_t)n * win * win;
    const int* gc = cur + (size_t)n * size * size;
    for (int e = threadIdx.x; e < win * win; e += blockDim.x) s_wnd[e] = gw[e];
    for (int e = threadIdx.x; e < size * size; e += blockDim.x) s_cur[e] = gc[e];
    __syncthreads();

    const int sub = subsample && size > 8 ? 1 : 0;
    const int rstep = 1 << sub;
    for (int k = threadIdx.x; k < m * m; k += blockDim.x) {
        const int dy = k / m, dx = k - (k / m) * m;
        int acc = 0;
        for (int r = 0; r < size; r += rstep) {
            const int* wr = s_wnd + (dy + r) * win + dx;
            const int* cr = s_cur + r * size;
            for (int c = 0; c < size; ++c) acc += abs(wr[c] - cr[c]);
        }
        s_sad[k] = acc << sub;
    }
    __syncthreads();

    // argmin over the inner square; each thread walks increasing indices
    // and keeps its first minimum, the reduction keeps the smallest index
    const int mi = m - 2;
    int bc = INT_MAX, bi = INT_MAX;
    for (int i = threadIdx.x; i < mi * mi; i += blockDim.x) {
        const int y = i / mi + 1, x = i - (i / mi) * mi + 1;
        const int cost = s_sad[y * m + x] + ((bits[y * m + x] * lam_me) >> 8);
        if (cost < bc) { bc = cost; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const int oc = __shfl_down_sync(0xffffffffu, bc, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(oc, oi, bc, bi)) { bc = oc; bi = oi; }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) { w_cost[warp] = bc; w_idx[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
        bc = w_cost[0];
        bi = w_idx[0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
            if (better(w_cost[w], w_idx[w], bc, bi)) { bc = w_cost[w]; bi = w_idx[w]; }
        const int by = bi / mi + 1, bx = bi - (bi / mi) * mi + 1;
        mv[2 * n] = bx - sr;
        mv[2 * n + 1] = by - sr;
        for (int k = 0; k < 9; ++k)
            sad9[9 * n + k] = s_sad[(by + k / 3 - 1) * m + bx + k % 3 - 1];
    }
}

}  // namespace

// wnd (n, S+2sr, S+2sr), cur (n, S, S), bits (2sr+1, 2sr+1): int32,
// contiguous, on the device. Writes mv (n, 2) and sad9 (n, 9). subsample:
// the 2:1 row rule for size > 8 (0 searches every row).
extern "C" int tpuhevc_sad_search(const int* wnd, const int* cur,
                                  const int* bits, int* mv, int* sad9, int n,
                                  int size, int sr, int lam_me, int subsample,
                                  void* stream) {
    const int m = 2 * sr + 1, win = size + 2 * sr;
    const size_t smem = (size_t)(win * win + size * size + m * m) * sizeof(int);
    sad_search_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
        wnd, cur, bits, mv, sad9, size, sr, lam_me, subsample);
    return (int)cudaGetLastError();
}
