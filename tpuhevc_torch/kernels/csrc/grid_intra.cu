// grid_intra: the grid step's intra-16 candidate in P pictures.
//
// Replaces: tpuhevc/codec/inter_grid.py:2038-2203 — `cell_refs`,
// `_smooth121`, `intra_preds` (IMODES = planar, DC, H, V, 2, 18, 34 at
// :2005), `satd_cells` and the decision and predictions of
// `intra16_class`, 8-bit.
//
// What it computes, per 16x16 cell (one block of 256 threads):
//   - the 4S + 1 boundary samples of the luma plane (left bottom-up with
//     the bottom-left segment, the corner, the top with the top-right
//     segment) read at clamped coordinates, their availability (left and
//     top inside the picture, the z-scan availability `avtr` / `avbl` of
//     the top-right and bottom-left 16-segments, those inside the
//     picture), and the substitution of §8.4.4.2.2: each unavailable
//     sample takes the last available one before it, the leading ones
//     the first available one, all 128 when none is;
//   - the [1 2 1] smoothed copy, used by the modes whose filter_flag is
//     set at 16x16 (planar, 2, 18, 34);
//   - with `cur`: the seven predictions, the 8x8 Hadamard SATD of
//     cur - pred over the four 8x8 blocks ((sum |H r H^T| + 2) >> 2 each)
//     and the first-index argmin; else the mode given;
//   - the chosen mode's luma prediction (DC, V and H with their edge
//     filters) and its DM chroma prediction on both halves of the packed
//     [U | V] plane (8x8, each half's own references, no smoothing, no
//     edge filters).
// Integer throughout, as the reference.
// Row origin y0: the reference planes hold y0 rows above the cells' row
// 0 (a row stripe with the last row of the stripe above it: y0 = 1; the
// whole picture or its first stripe: y0 = 0). The top and top-right
// samples of a cell row are available where a row lies above it in the
// planes; `cur` and the predictions hold the cells' rows only.
//
// What bounds it: 7 x 256 predicted samples and 7 x 4 Hadamards per
// cell, a few thousand integer operations, and the planes read once
// around each cell: latency, not bytes or operations (0.0004 ms of bound
// a picture). Its design keeps every step parallel: warps 0-2 fetch the
// luma, U and V boundaries one lane a sample, find the available ones by
// __ballot_sync and substitute by bit scans of the ballots (the last set
// bit at or below k, else the first set bit, else 128); warp 0 smooths,
// a lane a sample; then warp m (of 7) predicts mode m a row of 8 samples a
// lane and takes its four 8x8 SATDs by the butterflies of hadamard.cuh
// across 8 lanes (integer: exact in any order), the four tiles' rounded
// sums added by shuffles; one thread picks the first-index minimum; the
// chosen mode is written a sample a thread.

#include <cuda_runtime.h>

#include "hadamard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
__constant__ int kModes[7] = {0, 1, 10, 26, 2, 18, 34};

// The boundary of the S x S cell at (bx, by) of `plane` (hp x wp, row
// stride wp) with the cell grid starting at column ox, xmax bounding the
// reads and the top-right segment, by one warp: lane k's sample, its
// availability by ballot, the substitution by bit scans -> t[0..2S],
// l[0..2S] (corner at 0); raw: 4S + 1 ints of scratch. Every lane of the
// warp must call it.
__device__ void cell_refs(const int* __restrict__ plane, int hp, int wp,
                          int S, int ox, int xmax, int bx, int by, bool tr,
                          bool bl, int* raw, int* t, int* l) {
    const int n = 4 * S + 1, lane = threadIdx.x & 31;
    const bool left_ok = bx - ox > 0, top_ok = by > 0;
    unsigned m[3] = {0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const int k = lane + 32 * r;
        bool av = false;
        if (k < n) {
            int y, x;
            if (k < 2 * S) {
                y = by + 2 * S - 1 - k;
                x = bx - 1;
                av = k < S ? (bl && left_ok && y < hp) : left_ok;
            } else if (k == 2 * S) {
                y = by - 1;
                x = bx - 1;
                av = left_ok && top_ok;
            } else {
                y = by - 1;
                x = bx + k - (2 * S + 1);
                av = k <= 3 * S ? top_ok : (tr && top_ok && x < xmax);
            }
            const int yc = min(max(y, 0), hp - 1);
            const int xc = min(max(x, 0), xmax - 1);
            raw[k] = plane[(size_t)yc * wp + xc];
        }
        m[r] = __ballot_sync(kFull, av);
    }
    __syncwarp();
    const bool any = (m[0] | m[1] | m[2]) != 0u;
    const int first = m[0] ? __ffs(m[0]) - 1
                      : m[1] ? 31 + __ffs(m[1]) : 63 + __ffs(m[2]);
    int vals[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const int k = lane + 32 * r;
        // the last available sample at or before k
        int f = -1;
#pragma unroll
        for (int rr = r; rr >= 0 && f < 0; --rr) {
            const unsigned mm = rr == r ? m[rr] & ((2u << lane) - 1u) : m[rr];
            if (mm) f = 32 * rr + 31 - __clz(mm);
        }
        vals[r] = (k < n) ? (!any ? 128 : raw[f >= 0 ? f : first]) : 0;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const int k = lane + 32 * r;
        if (k >= n) continue;
        if (k == 2 * S) {
            t[0] = l[0] = vals[r];
        } else if (k > 2 * S) {
            t[k - 2 * S] = vals[r];
        } else {
            l[2 * S - k] = vals[r];
        }
    }
    __syncwarp();
}

// (sum of t[1..S] and l[1..S] + S) >> (log2 + 1), by one warp
__device__ __forceinline__ int dc_of(const int* t, const int* l, int S,
                                     int log2) {
    const int lane = threadIdx.x & 31;
    int s = lane < S ? t[1 + lane] + l[1 + lane] : 0;
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    return (s + S) >> (log2 + 1);
}

__device__ __forceinline__ int clip8(int v) { return min(max(v, 0), 255); }

// sample (y, x) of mode m on refs t, l (S = 1 << log2), dc the refs' DC;
// fil: whether the DC / V / H edge filters apply (luma below 32)
__device__ __forceinline__ int predict(int m, const int* t, const int* l,
                                       int S, int log2, int dc, int y, int x,
                                       bool fil) {
    switch (m) {
        case 0:
            return ((S - 1 - x) * l[1 + y] + (x + 1) * t[S + 1]
                    + (S - 1 - y) * t[1 + x] + (y + 1) * l[S + 1] + S)
                   >> (log2 + 1);
        case 1:
            if (!fil) return dc;
            if (y == 0 && x == 0) return (l[1] + 2 * dc + t[1] + 2) >> 2;
            if (y == 0) return (t[x + 1] + 3 * dc + 2) >> 2;
            if (x == 0) return (l[y + 1] + 3 * dc + 2) >> 2;
            return dc;
        case 26:
            if (fil && x == 0) return clip8(t[1] + ((l[1 + y] - l[0]) >> 1));
            return t[1 + x];
        case 10:
            if (fil && y == 0) return clip8(l[1] + ((t[1 + x] - t[0]) >> 1));
            return l[1 + y];
        case 2:
            return l[2 + x + y];
        case 34:
            return t[2 + x + y];
        default:  // 18
            return x >= y ? t[x - y] : l[y - x];
    }
}

__device__ __forceinline__ bool smoothed(int m) {
    return m == 0 || m == 2 || m == 18 || m == 34;
}

__global__ void __launch_bounds__(256)
intra16_kernel(const int* __restrict__ ref_y, const int* __restrict__ ref_uv,
               const bool* __restrict__ avtr, const bool* __restrict__ avbl,
               const int* __restrict__ cur, const int* __restrict__ modes_in,
               int* __restrict__ modes_out, int* __restrict__ pred_y,
               int* __restrict__ pred_uv, int H, int Hc, int W, int nw,
               int y0) {
    __shared__ int raw[3][68];
    __shared__ int t[33], l[33], ft[33], fl[33];
    __shared__ int tc[2][17], lc[2][17];
    __shared__ int dc[3];
    __shared__ int sat[7];
    __shared__ int s_mode;
    const int cell = blockIdx.x;
    const int cy = cell / nw, cx = cell - cy * nw;
    const bool tr = avtr[cell], bl = avbl[cell];
    const int Wc = W / 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
        cell_refs(ref_y, H, W, 16, 0, W, cx * 16, cy * 16 + y0, tr, bl,
                  raw[0], t, l);
        // the [1 2 1] smoothing, a lane a sample (corner at 0)
        const int c = (l[1] + 2 * t[0] + t[1] + 2) >> 2;
        if (lane == 0) {
            ft[0] = fl[0] = c;
            ft[32] = t[32];
            fl[32] = l[32];
        } else {
            ft[lane] = (t[lane - 1] + 2 * t[lane] + t[lane + 1] + 2) >> 2;
            fl[lane] = (l[lane - 1] + 2 * l[lane] + l[lane + 1] + 2) >> 2;
        }
        const int d = dc_of(t, l, 16, 4);
        if (lane == 0) dc[0] = d;
    } else if (warp <= 2) {
        const int h = warp - 1;
        cell_refs(ref_uv, Hc, W, 8, h * Wc, W, cx * 8 + h * Wc, cy * 8 + y0,
                  tr, bl, raw[warp], tc[h], lc[h]);
        const int d = dc_of(tc[h], lc[h], 8, 3);
        if (lane == 0) dc[warp] = d;
    }
    __syncthreads();
    if (cur != nullptr) {
        if (warp < 7) {
            // warp = mode; lanes 8q..8q+7 the rows of 8x8 block q
            const int m = kModes[warp], q = lane >> 3, r = lane & 7;
            const int y = (q >> 1) * 8 + r, x0 = (q & 1) * 8;
            const int* tt = smoothed(m) ? ft : t;
            const int* ll = smoothed(m) ? fl : l;
            const int4* cp = reinterpret_cast<const int4*>(
                cur + (size_t)(cy * 16 + y) * W + cx * 16 + x0);
            const int4 a = cp[0], b = cp[1];
            const int cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            int v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                v[j] = cv[j] - predict(m, tt, ll, 16, 4, dc[0], y, x0 + j,
                                       true);
            int s = (hadamard8_lanes_abs_sum(v, r) + 2) >> 2;
            s += __shfl_xor_sync(kFull, s, 8);
            s += __shfl_xor_sync(kFull, s, 16);
            if (lane == 0) sat[warp] = s;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int best = sat[0], bm = 0;
            for (int mi = 1; mi < 7; ++mi)
                if (sat[mi] < best) {
                    best = sat[mi];
                    bm = mi;
                }
            s_mode = bm;
            modes_out[cell] = bm;
        }
    } else if (threadIdx.x == 0) {
        s_mode = modes_in[cell];
    }
    __syncthreads();
    const int m = kModes[s_mode];
    const bool sm = smoothed(m);
    {
        const int y = threadIdx.x >> 4, x = threadIdx.x & 15;
        pred_y[(size_t)(cy * 16 + y) * W + cx * 16 + x] =
            predict(m, sm ? ft : t, sm ? fl : l, 16, 4, dc[0], y, x, true);
    }
    if (threadIdx.x < 128) {
        const int h = threadIdx.x >> 6, p = threadIdx.x & 63;
        const int y = p >> 3, x = p & 7;
        pred_uv[(size_t)(cy * 8 + y) * W + h * Wc + cx * 8 + x] =
            predict(m, tc[h], lc[h], 8, 3, dc[1 + h], y, x, false);
    }
}

}  // namespace

// ref_y (H, W), ref_uv ((H - y0) / 2 + y0, W) packed [U | V] int32, each
// with y0 rows above the cells; avtr, avbl (nh nw) bool; cur (16 nh, W)
// int32 to decide (modes_in null), or modes_in (nh nw) int32 (cur null)
// -> modes_out (when deciding), pred_y (16 nh, 16 nw), pred_uv (8 nh,
// 16 nw) int32, the row strides W.
extern "C" int tpuhevc_grid_intra16(const int* ref_y, const int* ref_uv,
                                    const bool* avtr, const bool* avbl,
                                    const int* cur, const int* modes_in,
                                    int* modes_out, int* pred_y, int* pred_uv,
                                    int H, int W, int nh, int nw, int y0,
                                    void* stream) {
    if (nh * nw == 0) return 0;
    if (nw * 16 != W || y0 < 0 || nh * 16 + y0 > H)
        return (int)cudaErrorInvalidValue;
    intra16_kernel<<<nh * nw, 256, 0, (cudaStream_t)stream>>>(
        ref_y, ref_uv, avtr, avbl, cur, modes_in, modes_out, pred_y, pred_uv,
        H, (H - y0) / 2 + y0, W, nw, y0);
    return (int)cudaGetLastError();
}
