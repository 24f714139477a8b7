// stripe_prescreen: the open-loop 35-mode intra prescreen of one row
// stripe of a luma plane.
//
// Replaces: tpuhevc/parallel/mesh.py:32-103 `tile_prescreen`, its
// per-device `local` (56-96), which XLA compiled for each TPU of a mesh
// under shard_map; the halo row came over ICI by ppermute (here the caller
// copies it, ops/stripe_prescreen.py and parallel/mesh.py).
//
// What it computes, for every 8x8 block (by, bx) of the stripe (hl, W),
// with `padded` = [halo row; stripe] (hl + 1 rows; the halo of the first
// stripe is mid-grey, 1 << (bd - 1)):
//   top[i]  = padded[by][clip(bx - 1 + i, 0, W - 1)],         i = 0..16,
//   left[i] = padded[min(by + i, hl)][clip(bx - 1, 0, W - 1)], i = 0..16,
//             all mid-grey where bx == 0;
// the 35 predictions of intra_pred.cuh from (top, left) at 8x8 luma (the
// [1 2 1] filtering of the modes that take it, the DC and VER/HOR
// boundary filters), each mode's cost (sum |H d H^T| + 2) >> 2 over the
// residual d = block - prediction (hadamard.cuh), and the first mode of
// least cost with that cost. Integer and exact.
//
// What bounds it: the plane is read once (four bytes a sample), and each
// sample costs 35 predictions and 35 Hadamard terms: about 1,000 integer
// operations an 8-byte output pair, so operations bound it on paper; at
// these sizes (1,560 blocks at 416x240) a launch's latency does.
// Design: one CUDA block per 8x8 block, 36 groups of 8 lanes (9 warps); a
// group takes one mode (the 36th repeats mode 34 and writes nothing), a
// lane one row: the row's 8 predictions and residuals in registers, the
// row butterflies in registers and the column butterflies by warp
// shuffles (hadamard8_lanes_abs_sum); the references, their filtered
// copies and the 35 costs in shared memory; one thread takes the argmin
// in mode order.

#include "hadamard.cuh"
#include "intra_pred.cuh"

namespace {

constexpr int kGroups = 36;
constexpr int kThreads = kGroups * 8;

__global__ void stripe_prescreen_kernel(const int* __restrict__ plane,
                                        const int* __restrict__ halo,
                                        int* __restrict__ mode_out,
                                        int* __restrict__ cost_out, int hl,
                                        int w, int bd) {
    __shared__ int t[17], l[17], ft[17], fl[17], org[64];
    __shared__ int s_dc;
    __shared__ int s_cost[35];
    const int nbw = w >> 3;
    const int b = blockIdx.x;
    const int by = (b / nbw) * 8, bx = (b % nbw) * 8;
    const int mid = 1 << (bd - 1);
    const int tid = threadIdx.x;
    // padded row y: 0 the halo, else stripe row y - 1
    if (tid < 17) {
        const int x = min(max(bx - 1 + tid, 0), w - 1);
        t[tid] = by == 0 ? halo[x] : plane[(size_t)(by - 1) * w + x];
    } else if (tid < 34) {
        const int i = tid - 17;
        const int y = min(by + i, hl);
        const int x = max(bx - 1, 0);
        l[i] = bx == 0 ? mid
                       : (y == 0 ? halo[x] : plane[(size_t)(y - 1) * w + x]);
    } else if (tid >= 64 && tid < 128) {
        const int e = tid - 64;
        org[e] = plane[(size_t)(by + (e >> 3)) * w + bx + (e & 7)];
    }
    __syncthreads();
    if (tid < 17) intra_smooth_at(t, l, tid, 16, false, &ft[tid], &fl[tid]);
    if (tid == 32) s_dc = intra_dc(t, l, 3);
    __syncthreads();
    const int g = tid >> 3, r = tid & 7;
    const int mode = min(g, 34);
    const int maxv = (1 << bd) - 1;
    int v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
        v[c] = org[r * 8 + c] - intra_pred_sample(t, l, ft, fl, s_dc, mode,
                                                  r, c, 3, true, true, maxv);
    const int sum = hadamard8_lanes_abs_sum(v, r);
    if (r == 0 && g < 35) s_cost[g] = (sum + 2) >> 2;
    __syncthreads();
    if (tid == 0) {
        int bi = 0;
        for (int m = 1; m < 35; ++m)
            if (s_cost[m] < s_cost[bi]) bi = m;
        mode_out[b] = bi;
        cost_out[b] = s_cost[bi];
    }
}

}  // namespace

// Copies per-mode angles, inverse angles (modes 11..25, else 0) and the
// filter flags [log2 - 2][mode] (int32, host memory) to constant memory
// of the current device. Call once per device before
// tpuhevc_stripe_prescreen.
extern "C" int tpuhevc_stripe_prescreen_init(const int* angle, const int* inv,
                                             const int* filter) {
    return intra_pred_load_tables(angle, inv, filter);
}

// plane (hl, w) int32, halo (w) int32 (the row above the stripe) on the
// device, hl and w multiples of 8 -> mode, cost (hl / 8, w / 8) int32.
extern "C" int tpuhevc_stripe_prescreen(const int* plane, const int* halo,
                                        int* mode, int* cost, int hl, int w,
                                        int bd, void* stream) {
    const int n = (hl / 8) * (w / 8);
    if (n == 0) return 0;
    stripe_prescreen_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        plane, halo, mode, cost, hl, w, bd);
    return (int)cudaGetLastError();
}
