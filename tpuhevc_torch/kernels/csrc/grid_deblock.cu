// grid_deblock: the grid step's in-loop deblocking of a P picture.
//
// Replaces: tpuhevc/codec/inter_grid.py:1217-1256 `deblock_device` with
// `_tb_cbf_cells`, `_bs_dir`, `_deblock_luma_vert` and
// `_deblock_chroma_vert` (:1040-1215), jnp code that XLA compiled for the
// TPU inside the grid step; the device twin of the host filter
// tpuhevc_torch/ops/deblock.py `deblock_frame` for the grid's P slices.
//
// What it computes (vertical edges over the whole picture first, then
// horizontal edges on that result), per 8x8 cell:
//   tu = min(CU log2, 5) - RQT depth; tb = any luma cbf over the cell's
//   aligned 2^(tu-3) x 2^(tu-3) group of cells;
//   bs of the edge at the cell's left (top) side: 0 on the picture's
//   border; 2 where either side is intra at a TU edge (the cell's
//   coordinate a multiple of 2^(tu-3)); else 1 where either tb is set at
//   a TU edge, or at any 8-aligned edge where the motion differs (a
//   component by 4 quarter-pels or more, or another reference); else 0.
//   Luma, per 4-line segment of an edge with bs > 0: HM's decisions (dE
//   from the second derivatives of lines 0 and 3 against beta, the strong
//   filter where both lines pass dSam, dEp / dEq for the second samples)
//   and, per line, the strong or the normal filter, tc from bs. Chroma, per line of
//   an 8-aligned chroma edge (the 16-luma grid) with bs 2: the 2-tap
//   filter at the chroma QP.
// Integer only.
//
// What bounds it: one read and one write of every sample (1.2 MB at
// 416x240: 0.00036 ms at 3.35 TB/s) and a few dozen integer operations a
// filtered line; at these sizes the launch.
// Design: one launch a picture over owned tiles. Luma edges are 8 samples
// apart, and a filter reads at most 4 samples and writes at most 3 on
// each side, so a CTA owns the output window of 32 x 32 luma samples
// shifted back by 4 in both directions (rows [R0-4, R0+28) x columns
// [C0-4, C0+28), R0 and C0 multiples of 32; the last tile of a row or
// column runs to the plane's edge): it holds every sample that the
// tile's own edges (R0, R0+8, ... and C0, C0+8, ...) read or write and
// none that another tile's edges write. A row's vertical filtering
// depends on that row alone and the horizontal pass reads only those
// results, so each CTA (256 threads) reads its window once into shared
// memory (int16, 16-byte loads, every global load of the CTA issued
// before its first shared store: one round trip), runs the vertical then
// the horizontal pass there, and writes the window once to a separate
// output: nothing is read twice, no halo, no second launch. In a pass a
// thread takes one line (a luma segment's decisions from its lines 0 and
// 3 are taken again by each of its four lines' threads, which keeps each
// thread's chain short: the passes are most of the kernel's time), and
// every line's result is taken before any is written. Chroma the same at its edge spacing (edges 8
// chroma samples apart, 2 read and 1 written a side; the window shifted
// by 4 chroma samples), U and V as two planes inside the packed [U | V]
// rows, never across the halves. The bs of each cell and direction is
// computed once, into shared memory, from a staged window of the cell
// maps that covers the aligned TB groups (up to 4 x 4 cells) of the
// tile's cells and of their left and top neighbours; the byte maps (CU
// log2, RQT depth, luma cbf, intra) are read as the grid gives them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;           // luma tile side: kT / 8 edges a direction
constexpr int kC = kT / 8;       // cells a tile side
constexpr int kLW = kT + 4;      // luma window side, at most (a last tile)
constexpr int kCW = kT / 2 + 4;  // chroma window side, at most
// shared row pitches (int16), multiples of 4: a window's 16-byte vector
// is one 8-byte short4 in shared memory
constexpr int kLP = kLW + 4;
constexpr int kCP = kCW + 4;
constexpr int kSet = kC + 1;     // cells of the window: the tile's + 1 before
constexpr int kGrp = kC + 4;     // cbf window: their aligned TB groups
constexpr int kThreads = 256;
static_assert(kC % 4 == 0, "a tile holds whole TB groups of 4 cells");
static_assert(kLW / 4 * kC * 4 + 2 * kCW * (kC / 2) <= kThreads,
              "a thread a line of a pass");

struct Args {
    const int* y;        // (H, W) int32
    const int* uv;       // (H/2, W) int32, [U | V]
    int* y_out;
    int* uv_out;
    const int8_t* log2;  // (h8, w8) CU log2
    const int8_t* tsplit;  // RQT depth
    const uint8_t* cbf;  // luma cbf, bool
    const uint8_t* intra;
    const int* mv;       // (h8, w8, 2) quarter-pel, strides below
    const int* ref;      // (h8, w8)
    int mv_sy, mv_sx, mv_sc;
    int H, W, beta, tc1, tc2, tcc;
};

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// Line l of a 4-line luma segment in shared memory (q0 of line 0 at
// pl[q0], of line l at pl[q0 + l * ls], p_k at -(k + 1) * xs, q_k at
// +k * xs): the segment's decisions from lines 0 and 3, then line l's
// filter. -> v = p2, p1, p0, q0, q1, q2 of the line; false where the line
// stays as it is.
__device__ bool luma_line(const int16_t* pl, int q0, int ls, int xs, int l,
                          int beta, int tc, int (&v)[6]) {
    int p[3][4], q[3][4];  // lines 0, 3 and l
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        p[0][k] = pl[q0 - (k + 1) * xs];
        q[0][k] = pl[q0 + k * xs];
        p[1][k] = pl[q0 + 3 * ls - (k + 1) * xs];
        q[1][k] = pl[q0 + 3 * ls + k * xs];
        p[2][k] = pl[q0 + l * ls - (k + 1) * xs];
        q[2][k] = pl[q0 + l * ls + k * xs];
    }
    const int dp0 = abs(p[0][2] - 2 * p[0][1] + p[0][0]);
    const int dp3 = abs(p[1][2] - 2 * p[1][1] + p[1][0]);
    const int dq0 = abs(q[0][2] - 2 * q[0][1] + q[0][0]);
    const int dq3 = abs(q[1][2] - 2 * q[1][1] + q[1][0]);
    const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3;
    if (!(dpq0 + dpq3 < beta)) return false;
    auto dsam = [&](int i, int dpq) {
        return 2 * dpq < (beta >> 2)
               && abs(p[i][3] - p[i][0]) + abs(q[i][0] - q[i][3]) < (beta >> 3)
               && abs(p[i][0] - q[i][0]) < ((5 * tc + 1) >> 1);
    };
    const bool strong = dsam(0, dpq0) && dsam(1, dpq3);
    const int side = (beta + (beta >> 1)) >> 3;
    const bool dep = dp0 + dp3 < side, deq = dq0 + dq3 < side;
    const int* P = p[2];
    const int* Q = q[2];
    int np[3] = {P[0], P[1], P[2]}, nq[3] = {Q[0], Q[1], Q[2]};
    if (strong) {
        np[0] = clip3((P[2] + 2 * P[1] + 2 * P[0] + 2 * Q[0] + Q[1] + 4) >> 3,
                      P[0] - 2 * tc, P[0] + 2 * tc);
        np[1] = clip3((P[2] + P[1] + P[0] + Q[0] + 2) >> 2,
                      P[1] - 2 * tc, P[1] + 2 * tc);
        np[2] = clip3((2 * P[3] + 3 * P[2] + P[1] + P[0] + Q[0] + 4) >> 3,
                      P[2] - 2 * tc, P[2] + 2 * tc);
        nq[0] = clip3((Q[2] + 2 * Q[1] + 2 * Q[0] + 2 * P[0] + P[1] + 4) >> 3,
                      Q[0] - 2 * tc, Q[0] + 2 * tc);
        nq[1] = clip3((Q[2] + Q[1] + Q[0] + P[0] + 2) >> 2,
                      Q[1] - 2 * tc, Q[1] + 2 * tc);
        nq[2] = clip3((2 * Q[3] + 3 * Q[2] + Q[1] + Q[0] + P[0] + 4) >> 3,
                      Q[2] - 2 * tc, Q[2] + 2 * tc);
    } else {
        const int delta = (9 * (Q[0] - P[0]) - 3 * (Q[1] - P[1]) + 8) >> 4;
        if (abs(delta) >= 10 * tc) return false;
        const int d = clip3(delta, -tc, tc);
        np[0] = clip3(P[0] + d, 0, 255);
        nq[0] = clip3(Q[0] - d, 0, 255);
        const int tch = tc >> 1;
        if (dep)
            np[1] = clip3(P[1] + clip3((((P[2] + P[0] + 1) >> 1) - P[1] + d)
                                       >> 1, -tch, tch), 0, 255);
        if (deq)
            nq[1] = clip3(Q[1] + clip3((((Q[2] + Q[0] + 1) >> 1) - Q[1] - d)
                                       >> 1, -tch, tch), 0, 255);
    }
    v[0] = np[2]; v[1] = np[1]; v[2] = np[0];
    v[3] = nq[0]; v[4] = nq[1]; v[5] = nq[2];
    return true;
}

// The chroma 2-tap filter of one line across an edge (q0 at pl[o]) -> v
// = p0, q0.
__device__ __forceinline__ void chroma_line(const int16_t* pl, int o, int xs,
                                            int tcc, int (&v)[6]) {
    const int p1 = pl[o - 2 * xs], p0 = pl[o - xs];
    const int qa = pl[o], q1 = pl[o + xs];
    const int d = clip3((((qa - p0) * 4) + p1 - q1 + 4) >> 3, -tcc, tcc);
    v[0] = clip3(p0 + d, 0, 255);
    v[1] = clip3(qa - d, 0, 255);
}

// The windows' 16-byte vectors, luma then U then V, each window a fixed
// kLW x kLW (kCW x kCW) frame from (R0 - 4, C0 - 4) ((R0/2 - 4, C0/2 - 4))
// of which the vectors inside the tile's window are live: vector i's
// offset in its plane (luma or packed chroma) and in shared memory.
constexpr int kLV = kLW / 4, kCV = kCW / 4;  // vectors a window row
constexpr int kItems = kLW * kLV + 2 * kCW * kCV;
constexpr int kPer = (kItems + kThreads - 1) / kThreads;

struct Win {
    int R0, C0, ry0, ry1, rx0, rx1, cy0, cy1, cx0, cx1;
    __device__ bool item(int i, int W, bool& luma, int& off, int& so) const {
        if (i < kLW * kLV) {
            const int r = i / kLV, v = i % kLV;
            const int y = R0 - 4 + r, x = C0 - 4 + 4 * v;
            luma = true;
            off = y * W + x;
            so = r * kLP + 4 * v;
            return y >= ry0 && y < ry1 && x >= rx0 && x < rx1;
        }
        const int j = i - kLW * kLV, h = j / (kCW * kCV);
        const int r = j % (kCW * kCV) / kCV, v = j % kCV;
        const int y = R0 / 2 - 4 + r, x = C0 / 2 - 4 + 4 * v;
        luma = false;
        off = y * W + h * (W >> 1) + x;
        so = h * kCW * kCP + r * kCP + 4 * v;
        return i < kItems && y >= cy0 && y < cy1 && x >= cx0 && x < cx1;
    }
};

__global__ void __launch_bounds__(kThreads) grid_deblock_kernel(const Args a) {
    __shared__ __align__(16) int16_t s_y[kLW * kLP];
    __shared__ __align__(16) int16_t s_c[2 * kCW * kCP];  // U then V
    __shared__ uint8_t s_cbf[kGrp][kGrp];
    __shared__ int8_t s_tu[kSet][kSet];
    __shared__ uint8_t s_in[kSet][kSet];
    __shared__ int s_mv[kSet][kSet][2], s_ref[kSet][kSet];
    __shared__ int8_t s_bs[2][kSet][kSet];  // [0] left edge, [1] top edge

    const int H = a.H, W = a.W, Hc = H >> 1, Wc = W >> 1;
    const int h8 = H >> 3, w8 = W >> 3;
    const bool last_r = blockIdx.y == gridDim.y - 1;
    const bool last_c = blockIdx.x == gridDim.x - 1;
    const int R0 = blockIdx.y * kT, C0 = blockIdx.x * kT;
    // the windows: luma, chroma (each half)
    const Win w{R0, C0,
                max(R0 - 4, 0), last_r ? H : R0 + kT - 4,
                max(C0 - 4, 0), last_c ? W : C0 + kT - 4,
                max(R0 / 2 - 4, 0), last_r ? Hc : R0 / 2 + kT / 2 - 4,
                max(C0 / 2 - 4, 0), last_c ? Wc : C0 / 2 + kT / 2 - 4};
    // cells: the set from (R0/8 - 1, C0/8 - 1), the cbf window from -4
    const int sr = R0 / 8 - 1, sc = C0 / 8 - 1;
    const int gr = R0 / 8 - 4, gc = C0 / 8 - 4;
    const int t = threadIdx.x;

    // every global load of the CTA is issued before the first store to
    // shared memory: one round trip
    int4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        bool luma;
        int off, so;
        if (w.item(t + k * kThreads, W, luma, off, so))
            v[k] = __ldg(reinterpret_cast<const int4*>((luma ? a.y : a.uv) + off));
    }
    int cbf = 0, tu = 0, in = 0, mv0 = 0, mv1 = 0, ref = 0;
    bool map_ok = false;
    if (t < kGrp * kGrp) {
        const int y = gr + t / kGrp, x = gc + t % kGrp;
        if (y >= 0 && y < h8 && x >= 0 && x < w8) cbf = a.cbf[y * w8 + x] != 0;
    } else if (t < kGrp * kGrp + kSet * kSet) {
        const int i = t - kGrp * kGrp;
        const int y = sr + i / kSet, x = sc + i % kSet;
        map_ok = y >= 0 && y < h8 && x >= 0 && x < w8;
        if (map_ok) {
            const int c = y * w8 + x;
            tu = min((int)a.log2[c], 5) - a.tsplit[c];
            in = a.intra[c] != 0;
            const int* mv = a.mv + (size_t)y * a.mv_sy + (size_t)x * a.mv_sx;
            mv0 = mv[0];
            mv1 = mv[a.mv_sc];
            ref = a.ref[c];
        }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        bool luma;
        int off, so;
        if (w.item(t + k * kThreads, W, luma, off, so))
            *reinterpret_cast<short4*>((luma ? s_y : s_c) + so) = make_short4(
                (short)v[k].x, (short)v[k].y, (short)v[k].z, (short)v[k].w);
    }
    if (t < kGrp * kGrp) {
        s_cbf[t / kGrp][t % kGrp] = (uint8_t)cbf;
    } else if (map_ok) {
        const int i = t - kGrp * kGrp, iy = i / kSet, ix = i % kSet;
        s_tu[iy][ix] = (int8_t)tu;
        s_in[iy][ix] = (uint8_t)in;
        s_mv[iy][ix][0] = mv0;
        s_mv[iy][ix][1] = mv1;
        s_ref[iy][ix] = ref;
    }
    __syncthreads();

    // bs of each cell's left (d 0) and top (d 1) edge that the tile owns;
    // tb: any cbf over the cell's aligned TB group (inside the cbf window)
    if (t < 2 * kSet * kSet) {
        const int d = t / (kSet * kSet), i = t % (kSet * kSet);
        const int iy = i / kSet, ix = i % kSet;
        const int y = sr + iy, x = sc + ix;
        const int own = d == 0 ? ix : iy;  // 0: the cell before the tile
        const int c = d == 0 ? x : y;
        int bs = 0;
        if (own > 0 && c > 0 && y >= 0 && y < h8 && x >= 0 && x < w8) {
            const int py = d == 0 ? iy : iy - 1, px = d == 0 ? ix - 1 : ix;
            const bool edge = (c & ((1 << (s_tu[iy][ix] - 3)) - 1)) == 0;
            auto tb = [&](int jy, int jx) {
                const int yc = sr + jy, xc = sc + jx;
                const int f = 1 << (s_tu[jy][jx] - 3);
                const int y0 = yc / f * f, x0 = xc / f * f;
                bool any = false;
                for (int yy = y0; yy < min(y0 + f, h8); ++yy)
                    for (int xx = x0; xx < min(x0 + f, w8); ++xx)
                        any |= s_cbf[yy - gr][xx - gc] != 0;
                return any;
            };
            if ((s_in[iy][ix] || s_in[py][px]) && edge) {
                bs = 2;
            } else {
                const bool mv_far =
                    abs(s_mv[iy][ix][0] - s_mv[py][px][0]) >= 4
                    || abs(s_mv[iy][ix][1] - s_mv[py][px][1]) >= 4
                    || s_ref[iy][ix] != s_ref[py][px];
                bs = mv_far || (edge && (tb(iy, ix) || tb(py, px)));
            }
        }
        s_bs[d][iy][ix] = (int8_t)bs;
    }
    __syncthreads();

    // the two passes, vertical edges first: a thread a luma line of a
    // 4-line segment or a chroma line of an edge; every line's result is
    // taken before any is written
    for (int dir = 0; dir < 2; ++dir) {
        int vals[6];
        int16_t* wb = nullptr;  // the first sample written, then every ws
        int ws = 0, wn = 0;
        const int r0 = dir == 0 ? w.ry0 : w.rx0, r1 = dir == 0 ? w.ry1 : w.rx1;
        const int c0 = dir == 0 ? w.cy0 : w.cx0, c1 = dir == 0 ? w.cy1 : w.cx1;
        const int nl = ((r1 - r0) >> 2) * kC * 4;  // luma lines
        const int ncl = c1 - c0, nc = 2 * ncl * (kC / 2);
        if (t < nl) {
            const int l = t & 3, sg = (t >> 2) / kC, j = (t >> 2) % kC;
            const int along = r0 + 4 * sg, e = (dir == 0 ? C0 : R0) + 8 * j;
            const int bs = dir == 0 ? s_bs[0][along / 8 - sr][j + 1]
                                    : s_bs[1][j + 1][along / 8 - sc];
            if (e < (dir == 0 ? W : H) && bs > 0) {
                const int ls = dir == 0 ? kLP : 1, xs = dir == 0 ? 1 : kLP;
                const int q0 = dir == 0 ? (along - R0 + 4) * kLP + 8 * j + 4
                                        : (8 * j + 4) * kLP + along - C0 + 4;
                if (luma_line(s_y, q0, ls, xs, l, a.beta,
                              bs == 2 ? a.tc2 : a.tc1, vals)) {
                    wb = s_y + q0 + l * ls - 3 * xs;
                    ws = xs;
                    wn = 6;
                }
            }
        } else if (t < nl + nc) {
            const int u = t - nl, h = u / (ncl * (kC / 2));
            const int q = u % (ncl * (kC / 2));
            const int along = c0 + q / (kC / 2), e2 = q % (kC / 2);
            const int e = (dir == 0 ? C0 : R0) / 2 + 8 * e2;
            const bool on = e > 0 && e < (dir == 0 ? Wc : Hc)
                && (dir == 0 ? s_bs[0][along / 4 - sr][2 * e2 + 1]
                             : s_bs[1][2 * e2 + 1][along / 4 - sc]) == 2;
            if (on) {
                int16_t* pl = s_c + h * kCW * kCP;
                const int o = dir == 0 ? (along - R0 / 2 + 4) * kCP + 8 * e2 + 4
                                       : (8 * e2 + 4) * kCP + along - C0 / 2 + 4;
                const int xs = dir == 0 ? 1 : kCP;
                chroma_line(pl, o, xs, a.tcc, vals);
                wb = pl + o - xs;
                ws = xs;
                wn = 2;
            }
        }
        __syncthreads();
        for (int k = 0; k < wn; ++k) wb[k * ws] = (int16_t)vals[k];
        __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        bool luma;
        int off, so;
        if (w.item(t + k * kThreads, W, luma, off, so)) {
            const short4 d =
                *reinterpret_cast<const short4*>((luma ? s_y : s_c) + so);
            *reinterpret_cast<int4*>((luma ? a.y_out : a.uv_out) + off) =
                make_int4(d.x, d.y, d.z, d.w);
        }
    }
}

}  // namespace

// y (H, W), uv (H/2, W) packed [U | V] int32 on the device, 8-bit samples,
// 16-byte aligned, H and W multiples of 16 -> y_out, uv_out (every sample
// written); the per-8x8-cell maps: log2 (CU) and tsplit (RQT depth) int8,
// cbf (luma) and intra bool, ref int32 contiguous (h8, w8); mv (h8, w8, 2)
// int32 quarter-pel at element strides (mv_sy, mv_sx, mv_sc); beta, tc1 /
// tc2 (luma tc at bs 1 / 2), tcc (chroma tc) at the slice QP. One launch.
extern "C" int tpuhevc_grid_deblock(const int* y, const int* uv, int* y_out,
                                    int* uv_out, const void* log2,
                                    const int* mv, const int* ref,
                                    const void* cbf, const void* intra,
                                    const void* tsplit, int mv_sy, int mv_sx,
                                    int mv_sc, int H, int W, int beta,
                                    int tc1, int tc2, int tcc, void* stream) {
    if (H <= 0 || W <= 0) return 0;
    const Args a{y, uv, y_out, uv_out, (const int8_t*)log2,
                 (const int8_t*)tsplit, (const uint8_t*)cbf,
                 (const uint8_t*)intra, mv, ref, mv_sy, mv_sx, mv_sc, H, W,
                 beta, tc1, tc2, tcc};
    const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT);
    grid_deblock_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
