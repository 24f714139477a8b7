// grid_deblock: the grid step's in-loop deblocking of a P picture.
//
// Replaces: tpuhevc/codec/inter_grid.py:1217-1256 `deblock_device` with
// `_tb_cbf_cells`, `_bs_dir`, `_deblock_luma_vert` and
// `_deblock_chroma_vert` (:1040-1215), jnp code that XLA compiled for the
// TPU inside the grid step; the device twin of the host filter
// tpuhevc_torch/ops/deblock.py `deblock_frame` for the grid's P slices.
//
// What it computes, for one edge direction (one launch each: vertical
// edges over the whole picture first, then horizontal edges on that
// result), per 8x8 cell:
//   tu = min(CU log2, 5) - RQT depth; tb = any luma cbf over the cell's
//   aligned 2^(tu-3) x 2^(tu-3) group of cells;
//   bs of the edge at the cell's left (top) side: 0 on the picture's
//   border; 2 where either side is intra at a TU edge (the cell's
//   coordinate a multiple of 2^(tu-3)); else 1 where either tb is set at
//   a TU edge, or at any 8-aligned edge where the motion differs (a
//   component by 4 quarter-pels or more, or another reference); else 0.
//   Luma, one thread per 4-line segment of an edge with bs > 0: HM's
//   decisions (dE from the second derivatives of lines 0 and 3 against
//   beta, the strong filter where both lines pass dSam, dEp / dEq for the
//   second samples) and the strong or the normal filter, tc from bs.
//   Chroma, one thread per 4-line segment of an 8-aligned chroma edge
//   (the 16-luma grid) with bs 2: the 2-tap filter at the chroma QP.
// Integer only; edges 8 samples apart change at most 3 samples on each
// side and read at most 4, so the threads of one pass never touch a
// sample that another writes: each pass runs in place.
//
// What bounds it: one read and at most one write of the samples near
// the edges, a few dozen integer operations per line; launch-bound at
// these sizes. Design: one thread per segment over the luma and both
// chroma halves in the same launch, the bs computed by each thread from
// the per-cell maps.

#include <cuda_runtime.h>

namespace {

struct Maps {
    const int *log2, *mv, *ref, *cbf, *intra, *tsplit;
    int h8, w8;
    __device__ int tu(int y, int x) const {
        const int i = y * w8 + x;
        return min(log2[i], 5) - tsplit[i];
    }
    __device__ bool tb_cbf(int y, int x) const {
        const int f = 1 << (tu(y, x) - 3);
        const int y0 = y / f * f, x0 = x / f * f;
        bool any = false;
        for (int yy = y0; yy < min(y0 + f, h8); ++yy)
            for (int xx = x0; xx < min(x0 + f, w8); ++xx)
                any |= cbf[yy * w8 + xx] != 0;
        return any;
    }
    // bs of the edge at the left (vertical) or top side of cell (y, x)
    __device__ int bs(int y, int x, bool vertical) const {
        const int c = vertical ? x : y;
        if (c == 0) return 0;
        const int py = vertical ? y : y - 1, px = vertical ? x - 1 : x;
        const int q = y * w8 + x, p = py * w8 + px;
        const bool edge = (c & ((1 << (tu(y, x) - 3)) - 1)) == 0;
        if ((intra[q] || intra[p]) && edge) return 2;
        const bool mv_far = abs(mv[2 * q] - mv[2 * p]) >= 4
                            || abs(mv[2 * q + 1] - mv[2 * p + 1]) >= 4
                            || ref[q] != ref[p];
        return ((tb_cbf(y, x) || tb_cbf(py, px)) && edge) || mv_far;
    }
};

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// One 4-line luma segment; q0 of line l at pl[q0 + l * ls], p_k at
// -(k + 1) * xs, q_k at +k * xs.
__device__ void luma_segment(int* pl, int q0, int ls, int xs, int bs,
                             int beta, int tc) {
    int p[4][4], q[4][4];
    for (int l = 0; l < 4; ++l)
        for (int k = 0; k < 4; ++k) {
            p[l][k] = pl[q0 + l * ls - (k + 1) * xs];
            q[l][k] = pl[q0 + l * ls + k * xs];
        }
    const int dp0 = abs(p[0][2] - 2 * p[0][1] + p[0][0]);
    const int dp3 = abs(p[3][2] - 2 * p[3][1] + p[3][0]);
    const int dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0]);
    const int dq3 = abs(q[3][2] - 2 * q[3][1] + q[3][0]);
    const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3;
    if (!(dpq0 + dpq3 < beta && bs > 0)) return;
    auto dsam = [&](int l, int dpq) {
        return 2 * dpq < (beta >> 2)
               && abs(p[l][3] - p[l][0]) + abs(q[l][0] - q[l][3]) < (beta >> 3)
               && abs(p[l][0] - q[l][0]) < ((5 * tc + 1) >> 1);
    };
    const bool strong = dsam(0, dpq0) && dsam(3, dpq3);
    const int side = (beta + (beta >> 1)) >> 3;
    const bool dep = dp0 + dp3 < side, deq = dq0 + dq3 < side;
    for (int l = 0; l < 4; ++l) {
        const int* P = p[l];
        const int* Q = q[l];
        int np[3] = {P[0], P[1], P[2]}, nq[3] = {Q[0], Q[1], Q[2]};
        if (strong) {
            np[0] = clip3((P[2] + 2 * P[1] + 2 * P[0] + 2 * Q[0] + Q[1] + 4)
                          >> 3, P[0] - 2 * tc, P[0] + 2 * tc);
            np[1] = clip3((P[2] + P[1] + P[0] + Q[0] + 2) >> 2,
                          P[1] - 2 * tc, P[1] + 2 * tc);
            np[2] = clip3((2 * P[3] + 3 * P[2] + P[1] + P[0] + Q[0] + 4) >> 3,
                          P[2] - 2 * tc, P[2] + 2 * tc);
            nq[0] = clip3((Q[2] + 2 * Q[1] + 2 * Q[0] + 2 * P[0] + P[1] + 4)
                          >> 3, Q[0] - 2 * tc, Q[0] + 2 * tc);
            nq[1] = clip3((Q[2] + Q[1] + Q[0] + P[0] + 2) >> 2,
                          Q[1] - 2 * tc, Q[1] + 2 * tc);
            nq[2] = clip3((2 * Q[3] + 3 * Q[2] + Q[1] + Q[0] + P[0] + 4) >> 3,
                          Q[2] - 2 * tc, Q[2] + 2 * tc);
        } else {
            const int delta = (9 * (Q[0] - P[0]) - 3 * (Q[1] - P[1]) + 8) >> 4;
            if (abs(delta) >= 10 * tc) continue;
            const int d = clip3(delta, -tc, tc);
            np[0] = clip3(P[0] + d, 0, 255);
            nq[0] = clip3(Q[0] - d, 0, 255);
            const int tch = tc >> 1;
            if (dep)
                np[1] = clip3(P[1] + clip3((((P[2] + P[0] + 1) >> 1) - P[1]
                                            + d) >> 1, -tch, tch), 0, 255);
            if (deq)
                nq[1] = clip3(Q[1] + clip3((((Q[2] + Q[0] + 1) >> 1) - Q[1]
                                            - d) >> 1, -tch, tch), 0, 255);
        }
        for (int k = 0; k < 3; ++k) {
            pl[q0 + l * ls - (k + 1) * xs] = np[k];
            pl[q0 + l * ls + k * xs] = nq[k];
        }
    }
}

__global__ void grid_deblock_kernel(int* __restrict__ y, int* __restrict__ uv,
                                    Maps m, int H, int W, int beta, int tc1,
                                    int tc2, int tcc, int vertical) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int h8 = m.h8, w8 = m.w8;
    // luma: (H / 4) x w8 vertical or (W / 4) x h8 horizontal segments
    const int nseg = vertical ? H >> 2 : W >> 2;
    const int nl = nseg * (vertical ? w8 : h8);
    if (t < nl) {
        const int s = t / (vertical ? w8 : h8);
        const int e = t - s * (vertical ? w8 : h8);
        const int cy = vertical ? s >> 1 : e, cx = vertical ? e : s >> 1;
        const int bs = m.bs(cy, cx, vertical != 0);
        if (bs == 0) return;
        const int tc = bs == 2 ? tc2 : tc1;
        if (vertical)
            luma_segment(y, (4 * s) * W + 8 * e, W, 1, bs, beta, tc);
        else
            luma_segment(y, (8 * e) * W + 4 * s, 1, W, bs, beta, tc);
        return;
    }
    // chroma, both halves: h8 x (w8 / 2) vertical or w8 x (h8 / 2)
    // horizontal segments each; edge k >= 1 on the 16-luma grid
    const int ne = vertical ? w8 >> 1 : h8 >> 1;
    const int nseg_c = vertical ? h8 : w8;
    const int tcn = t - nl;
    if (tcn >= 2 * nseg_c * ne) return;
    const int half = tcn / (nseg_c * ne);
    const int r = tcn - half * nseg_c * ne;
    const int s = r / ne, k = r - s * ne;
    if (k == 0) return;
    const int cy = vertical ? s : 2 * k, cx = vertical ? 2 * k : s;
    if (m.bs(cy, cx, vertical != 0) != 2) return;
    const int wc = W >> 1;
    const int q0 = vertical ? (4 * s) * W + half * wc + 8 * k
                            : (8 * k) * W + half * wc + 4 * s;
    const int ls = vertical ? W : 1, xs = vertical ? 1 : W;
    for (int l = 0; l < 4; ++l) {
        const int o = q0 + l * ls;
        const int p1 = uv[o - 2 * xs], p0 = uv[o - xs];
        const int qa = uv[o], q1 = uv[o + xs];
        const int d = clip3((((qa - p0) * 4) + p1 - q1 + 4) >> 3, -tcc, tcc);
        uv[o - xs] = clip3(p0 + d, 0, 255);
        uv[o] = clip3(qa - d, 0, 255);
    }
}

}  // namespace

// y (H, W), uv (H/2, W) packed [U | V] int32 on the device, filtered in
// place; the per-8x8-cell maps int32: log2 (CU), mv (h8, w8, 2)
// quarter-pel, ref, cbf (luma), intra, tsplit (RQT depth); beta, tc1 /
// tc2 (luma tc at bs 1 / 2), tcc (chroma tc) at the slice QP; vertical 1
// for the vertical edges, 0 for the horizontal ones.
extern "C" int tpuhevc_grid_deblock(int* y, int* uv, const int* log2,
                                    const int* mv, const int* ref,
                                    const int* cbf, const int* intra,
                                    const int* tsplit, int H, int W, int beta,
                                    int tc1, int tc2, int tcc, int vertical,
                                    void* stream) {
    const Maps m{log2, mv, ref, cbf, intra, tsplit, H >> 3, W >> 3};
    const int nl = vertical ? (H >> 2) * m.w8 : (W >> 2) * m.h8;
    const int nc = vertical ? 2 * m.h8 * (m.w8 >> 1)
                            : 2 * m.w8 * (m.h8 >> 1);
    const int n = nl + nc;
    if (n == 0) return 0;
    grid_deblock_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        y, uv, m, H, W, beta, tc1, tc2, tcc, vertical);
    return (int)cudaGetLastError();
}
