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
// cell, all in shared memory; the planes are read once around each cell.

#include <cuda_runtime.h>

namespace {

__constant__ int c_had[64];
__constant__ int kModes[7] = {0, 1, 10, 26, 2, 18, 34};

// boundary of the S x S cell at (bx, by) of `plane` (hp x wp, row
// stride wp) with the cell grid starting at column ox; xmax bounds the
// columns of this half. Writes t[0..2S], l[0..2S] (corner at 0).
__device__ void cell_refs(const int* __restrict__ plane, int hp, int wp,
                          int S, int ox, int xmax, int bx, int by, bool tr,
                          bool bl, int* v, int* t, int* l) {
    const int n = 4 * S + 1;
    const bool left_ok = bx - ox > 0, top_ok = by > 0;
    int first = -1, last = -1;
    // one thread walks the boundary (4S + 1 <= 65 samples)
    for (int k = 0; k < n; ++k) {
        int y, x;
        bool av;
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
        const int yc = min(max(y, 0), hp - 1), xc = min(max(x, 0), xmax - 1);
        v[k] = plane[(size_t)yc * wp + xc];
        if (av) {
            if (first < 0) first = k;
            last = k;
        }
        v[n + k] = av ? k : last;  // forward fill index
    }
    for (int k = 0; k < n; ++k) {
        const int f = v[n + k];
        v[2 * n + k] = first < 0 ? 128 : (f >= 0 ? v[f] : v[first]);
    }
    const int* filled = v + 2 * n;
    t[0] = l[0] = filled[2 * S];
    for (int i = 1; i <= 2 * S; ++i) {
        t[i] = filled[2 * S + i];
        l[i] = filled[2 * S - i];
    }
}

__device__ __forceinline__ int clip8(int v) { return min(max(v, 0), 255); }

// sample (y, x) of mode m on refs t, l (S = 1 << log2); fil: whether the
// DC / V / H edge filters apply (luma below 32)
__device__ int predict(int m, const int* t, const int* l, int S, int log2,
                       int y, int x, bool fil) {
    switch (m) {
        case 0:
            return ((S - 1 - x) * l[1 + y] + (x + 1) * t[S + 1]
                    + (S - 1 - y) * t[1 + x] + (y + 1) * l[S + 1] + S)
                   >> (log2 + 1);
        case 1: {
            int s = S;
            for (int i = 1; i <= S; ++i) s += t[i] + l[i];
            const int dc = s >> (log2 + 1);
            if (!fil) return dc;
            if (y == 0 && x == 0) return (l[1] + 2 * dc + t[1] + 2) >> 2;
            if (y == 0) return (t[x + 1] + 3 * dc + 2) >> 2;
            if (x == 0) return (l[y + 1] + 3 * dc + 2) >> 2;
            return dc;
        }
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

__global__ void intra16_kernel(const int* __restrict__ ref_y,
                               const int* __restrict__ ref_uv,
                               const bool* __restrict__ avtr,
                               const bool* __restrict__ avbl,
                               const int* __restrict__ cur,
                               const int* __restrict__ modes_in,
                               int* __restrict__ modes_out,
                               int* __restrict__ pred_y,
                               int* __restrict__ pred_uv, int H, int Hc,
                               int W, int nw, int y0) {
    __shared__ int v[3 * 65];
    __shared__ int t[33], l[33], ft[33], fl[33];
    __shared__ int tc[2][17], lc[2][17];
    __shared__ int res[7 * 256];
    __shared__ int sat[7 * 4];
    __shared__ int s_mode;
    const int cell = blockIdx.x;
    const int cy = cell / nw, cx = cell - cy * nw;
    const bool tr = avtr[cell], bl = avbl[cell];
    const int Wc = W / 2;
    if (threadIdx.x == 0) {
        cell_refs(ref_y, H, W, 16, 0, W, cx * 16, cy * 16 + y0, tr, bl, v, t,
                  l);
        const int c = (l[1] + 2 * t[0] + t[1] + 2) >> 2;
        ft[0] = fl[0] = c;
        for (int k = 1; k < 32; ++k) {
            ft[k] = (t[k - 1] + 2 * t[k] + t[k + 1] + 2) >> 2;
            fl[k] = (l[k - 1] + 2 * l[k] + l[k + 1] + 2) >> 2;
        }
        ft[32] = t[32];
        fl[32] = l[32];
        for (int h = 0; h < 2; ++h)
            cell_refs(ref_uv, Hc, W, 8, h * Wc, W, cx * 8 + h * Wc,
                      cy * 8 + y0, tr, bl, v, tc[h], lc[h]);
    }
    if (threadIdx.x < 28) sat[threadIdx.x] = 0;
    __syncthreads();
    if (cur != nullptr) {
        for (int e = threadIdx.x; e < 7 * 256; e += blockDim.x) {
            const int mi = e >> 8, p = e & 255, y = p >> 4, x = p & 15;
            const int m = kModes[mi];
            const bool sm = m == 0 || m == 2 || m == 18 || m == 34;
            res[e] = cur[(size_t)(cy * 16 + y) * W + cx * 16 + x]
                     - predict(m, sm ? ft : t, sm ? fl : l, 16, 4, y, x, true);
        }
        __syncthreads();
        // (mode, 8x8 block) pairs x 64 coefficients; a warp holds half a
        // pair, its lane 0 adds the partial |.| sum into the pair's total
        for (int e = threadIdx.x; e < 28 * 64; e += blockDim.x) {
            const int pair = e >> 6, k = (e >> 3) & 7, j = e & 7;
            const int mi = pair >> 2, q = pair & 3;
            const int* r = res + mi * 256 + (q >> 1) * 128 + (q & 1) * 8;
            int acc = 0;
            for (int a = 0; a < 8; ++a) {
                int row = 0;
                for (int bb = 0; bb < 8; ++bb)
                    row += r[a * 16 + bb] * c_had[j * 8 + bb];
                acc += c_had[k * 8 + a] * row;
            }
            int s = abs(acc);
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_down_sync(0xffffffffu, s, off);
            if ((threadIdx.x & 31) == 0) atomicAdd(&sat[pair], s);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int best = 0, bm = 0;
            for (int mi = 0; mi < 7; ++mi) {
                int s = 0;
                for (int q = 0; q < 4; ++q) s += (sat[mi * 4 + q] + 2) >> 2;
                if (mi == 0 || s < best) {
                    best = s;
                    bm = mi;
                }
            }
            s_mode = bm;
            modes_out[cell] = bm;
        }
    } else if (threadIdx.x == 0) {
        s_mode = modes_in[cell];
    }
    __syncthreads();
    const int mi = s_mode, m = kModes[mi];
    const bool sm = m == 0 || m == 2 || m == 18 || m == 34;
    {
        const int y = threadIdx.x >> 4, x = threadIdx.x & 15;
        pred_y[(size_t)(cy * 16 + y) * W + cx * 16 + x] =
            predict(m, sm ? ft : t, sm ? fl : l, 16, 4, y, x, true);
    }
    if (threadIdx.x < 128) {
        const int h = threadIdx.x >> 6, p = threadIdx.x & 63;
        const int y = p >> 3, x = p & 7;
        pred_uv[(size_t)(cy * 8 + y) * W + h * Wc + cx * 8 + x] =
            predict(m, tc[h], lc[h], 8, 3, y, x, false);
    }
}

}  // namespace

// Copies the 8x8 Hadamard matrix to this file's constant memory on the
// current device. Call once per device first.
extern "C" int tpuhevc_grid_intra_init(const int* had8) {
    cudaMemcpyToSymbol(c_had, had8, sizeof(int) * 64);
    return (int)cudaGetLastError();
}

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
