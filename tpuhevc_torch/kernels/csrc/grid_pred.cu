// grid_pred: the grid step's motion compensation, four entry points.
//
// tpuhevc_grid_planes replaces tpuhevc/codec/inter_grid.py:862-910
// `luma_planes_all` / `chroma_planes_all`, with and without explicit
// weighted prediction (`wpy` / `wpc`): every
// fractional phase of n reference planes, edge-padded by `pad`, through
// the separable DCT-IF filter (the taps of tpuhevc_torch/ops/interp.py,
// as mc_blk.cu filters blocks; luma 8 taps and 4x4 phases, chroma
// 4 taps and 8x8 phases):
//   h(yy, x) = sum_i taps[fx][i] rp[yy][x + i + 1]     (8-bit: no shift)
//   v(y, x)  = sum_j taps[fy][j] h(y + j + 1, x)
//   out[r][fy][fx][y][x] = clip(((v >> 6) + 32) >> 6, 0, 255)   (int16)
// with rp[yy][xx] = ref[clamp(y0 + yy - pad)][clamp(xx - pad)] (y0 the
// window's first row in the padded plane: a row stripe's origin in its
// halo'd reference, 0 for the whole picture); with weights
// w[r], o[r] and the denominator d, the weighting folded into the
// rounding of the 14-bit intermediate p14 = v >> 6 (weightUnidir):
//   out = clip(((p14 * w[r] + (1 << (d + 6) >> 1)) >> (d + 6)) + o[r])
// which identity weights (w = 1 << d, o = 0) reduce to the line above bit
// for bit; p14 * w stays below 2^23 in int32.
// What bounds it: the output, ~80 MB a 416x240 picture (luma and chroma)
// written once, against ~14 MB of int32 reference read. The design is a
// tiled separable filter: one block per (plane, 32 x 64 output tile)
// stages the tile's clamped source rows once in shared memory as int16,
// runs the horizontal pass once per fx phase into shared memory (|h| <
// 2^15 for both tap sets, so int16 holds it exactly), and shares it
// between the P vertical phases; each thread then forms 8 (or 4)
// adjacent outputs of one (fy, fx, row) from nt 16-byte (8-byte) shared
// loads and writes them with one vector store. Index math is 32-bit: the
// tile's origin comes from blockIdx, the loops divide by constants.
//
// tpuhevc_grid_satd replaces the gathers of :912-930 `pred_luma` /
// `pred_chroma` for one class coding, in one launch: with the MV (1/4
// pel) and reference of each 8x8 luma cell, pred_y[y][x] =
// planes_y[ref][fy][fx][iy][ix] with f = mv & 3, i = (mv >> 2) +
// position + look, and the 4x4 chroma cells' U and V from the chroma
// planes at the same MV in 1/8 pel (V's planes R on), packed [U | V].
// One thread per sample, its row and plane from blockIdx (no division).
//
// tpuhevc_grid_satd_cost replaces :951 `satd8_plane` with :983
// `pred_satd_z` and `batch_satd`'s (:1597) float part: up to kMaxFields
// fields of CUs, each CU of size S (8..64) at one MV and reference; per
// 8x8 block of r = oy - pred (pred gathered from the luma phase planes
// at the CU's MV) the Hadamard SATD m8 = (sum |H r H^T| + 2) >> 2 and the
// residual sum s8; then one float32 per CU, the DC-aware cost (mode z):
//   dc8 = (|s8| + 2) >> 2, ac8 = m8 - dc8, dcc = lam * 12 + c_S,
//   S = 8: ac8 + min(dc8, dcc)
//   S > 8: (sum ac8 + 0.5 max(sum dc8 - cu_dc, 0)) + min(cu_dc, dcc),
//          cu_dc = (|sum s8| + 2) >> 2
// or the sum of m8 over the CU (mode plain: the rectangular trial's
// half-CU cells, whose MV may be the first or second cell of its pair).
// The integer sums are below 2^24 (exact in float32, in any order); the
// float operations run in the order above, each rounded on its own
// (__fmul_rn / __fadd_rn, no FMA), as the PyTorch composition does. lam
// is read on the card. One block of 128 threads: 16 groups of 8 lanes,
// an 8x8 block a group with a row in each lane's registers, the Hadamard
// by butterflies (the columns across the lanes by shuffles,
// hadamard.cuh); a block holds 16 CUs of 8, 4 of 16, one of 32 or one of
// 64 (four rounds); a CU's sums through shared memory.
//
// tpuhevc_grid_subpel replaces :1012-1035 `subpel_refine` (FmeMode
// dctif) for up to three classes of CUs (the grid's 16x16, 8x8 and 32x32)
// in one launch: per CU of size S, from the full-pel MV (times 4), a
// 9-point half-pel square (offsets +-2 quarter-pel), then a 9-point
// quarter-pel square (+-1) around the winner; each point scored as
// `pred_satd` (:969-981) scores it: the prediction gathered from the
// phase planes as above, per 8x8 block of oy - pred the Hadamard SATD
// (sum |H r H^T| + 2) >> 2, summed over the CU; the first index among
// equal minima, as jnp.argmin. The costs are exact integers (the
// reference casts to float32 after the integer sum, far below 2^24), so
// no float order is involved. The caller keeps |mv| <= look - 1 (the
// refine's clamp to sr_full + 3 with look = sr_full + 4), so every read
// lies inside the planes (asserted in the plain version).
// What bounds it: 18 SATD evaluations per pixel and class, ~12 integer
// operations a sample (operations; the planes' gathered samples and oy
// read once are less). The design: a team of 8 lanes an 8x8 block of a
// CU (lane r its row r), oy's row loaded once into registers (two 16-byte
// loads) and scored against the nine points of a round, each point's
// prediction row gathered from its phase plane and its SATD by the
// butterflies of hadamard.cuh; S compiled in: a block of 128 threads
// holds 16 CUs of 8 (a team a CU: no reduction), 4 of 16 (a warp a CU:
// the nine sums by two xor-shuffles) or one of 32 (the warps' sums
// through shared memory, one barrier a round); every lane of a CU then
// holds its nine costs and takes the least key (cost << 4) | point, so
// the first point among equal costs wins. The quarter-pel round starts
// from the winner at once and reuses its cost as its centre's (the same
// integer). The CU's row and column come from a multiply-high (no
// division on the path); the 32x32 class's blocks come first in the grid.

// What bounds the others: a SATD cost call reads the current picture and
// one gathered sample per pixel and field.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hadamard.cuh"

namespace {

__constant__ int c_luma_taps[32];    // (4 phases, 8 taps)
__constant__ int c_chroma_taps[32];  // (8 phases, 4 taps)

// the planes kernel's output tile and block
constexpr int kTileH = 32, kTileW = 64, kPlanesThreads = 256;

// VEC int16 moved as one load or store
template <int VEC>
union Pack;
template <>
union Pack<8> {
    int4 v;
    int16_t s[8];
};
template <>
union Pack<4> {
    int2 v;
    int16_t s[4];
};
template <>
union Pack<1> {
    int16_t v;
    int16_t s[1];
};

// one block per (plane r = blockIdx.z, tile of kTileH x kTileW outputs of
// the (hm, wm) window); P phases a axis, NT taps, VEC outputs a store
template <int P, int NT, int VEC>
__global__ void __launch_bounds__(kPlanesThreads)
planes_kernel(const int* __restrict__ ref, const int* __restrict__ wpw,
              const int* __restrict__ wpo, int16_t* __restrict__ out, int h,
              int w, int pad, int y0, int hm, int wm, int wpd) {
    constexpr int SR = kTileH + NT - 1;  // source rows of a tile
    constexpr int SC = kTileW + NT - 1;  // source columns
    constexpr int G = kTileW / VEC;      // stores a tile row
    __shared__ int16_t src[SR][SC];
    __shared__ __align__(16) int16_t hs[P][SR][kTileW];
    const int* taps = NT == 8 ? c_luma_taps : c_chroma_taps;
    const int r = blockIdx.z;
    const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
    const int* base = ref + (size_t)r * h * w;
    // src[yy][xx] = rp[ty0 + yy + 1][tx0 + xx + 1], clamped as padded
    for (int k = threadIdx.x; k < SR * SC; k += kPlanesThreads) {
        const int yy = k / SC, xx = k - yy * SC;
        const int sy = min(max(y0 + ty0 + yy + 1 - pad, 0), h - 1);
        const int sx = min(max(tx0 + xx + 1 - pad, 0), w - 1);
        src[yy][xx] = (int16_t)__ldg(base + sy * w + sx);
    }
    __syncthreads();
    // hs[fx][yy][x] = h(ty0 + yy + 1, tx0 + x): once for all fy
    for (int k = threadIdx.x; k < P * SR * kTileW; k += kPlanesThreads) {
        const int x = k % kTileW, q = k / kTileW;
        const int yy = q % SR, fx = q / SR;
        const int* t = taps + fx * NT;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc += t[i] * src[yy][x + i];
        hs[fx][yy][x] = (int16_t)acc;
    }
    __syncthreads();
    int wr = 0, orr = 0, sh = 0, rnd = 0;
    if (wpw) {
        wr = wpw[r];
        orr = wpo[r];
        sh = wpd + 6;
        rnd = (1 << sh) >> 1;
    }
    for (int k = threadIdx.x; k < P * P * kTileH * G; k += kPlanesThreads) {
        const int g = k % G;
        int q = k / G;
        const int y = q % kTileH;
        q /= kTileH;
        const int fx = q % P, fy = q / P;
        const int oy = ty0 + y, ox = tx0 + g * VEC;
        if (oy >= hm || ox >= wm) continue;
        const int* t = taps + fy * NT;
        int v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = 0;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            Pack<VEC> hv;
            hv.v = *reinterpret_cast<const decltype(hv.v)*>(
                &hs[fx][y + j][g * VEC]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] += t[j] * hv.s[e];
        }
        Pack<VEC> o;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            const int p14 = v[e] >> 6;
            const int s = wpw ? ((p14 * wr + rnd) >> sh) + orr
                              : (p14 + 32) >> 6;
            o.s[e] = (int16_t)min(max(s, 0), 255);
        }
        *reinterpret_cast<decltype(o.v)*>(
            out + ((size_t)(r * P + fy) * P + fx) * hm * wm + (size_t)oy * wm
            + ox) = o.v;
    }
}

// one thread per sample: x from blockIdx.x, row y = blockIdx.y; plane
// blockIdx.z: 0 luma (8x8 cells of hc x wc), 1 U, 2 V (4x4 cells)
__global__ void gather_kernel(const int16_t* __restrict__ planes_y,
                              const int16_t* __restrict__ planes_c,
                              const int* __restrict__ mv,
                              const int* __restrict__ ref,
                              int* __restrict__ pred_y,
                              int* __restrict__ pred_uv, int R, int hmy,
                              int wmy, int hmc, int wmc, int hc, int wc,
                              int look, int lookc) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
    const int z = blockIdx.z;
    if (z == 0) {
        if (x >= wc * 8) return;
        const int ci = (y >> 3) * wc + (x >> 3);
        const int mx = mv[2 * ci], my = mv[2 * ci + 1], r = ref[ci];
        const int plane = (r * 4 + (my & 3)) * 4 + (mx & 3);
        pred_y[y * wc * 8 + x] =
            planes_y[(plane * hmy + (my >> 2) + y + look) * wmy + (mx >> 2)
                     + x + look];
        return;
    }
    if (x >= wc * 4 || y >= hc * 4) return;
    const int ci = (y >> 2) * wc + (x >> 2);
    const int mx = mv[2 * ci], my = mv[2 * ci + 1];
    const int r = ref[ci] + (z - 1) * R;
    const int plane = (r * 8 + (my & 7)) * 8 + (mx & 7);
    pred_uv[y * wc * 8 + (z - 1) * wc * 4 + x] =
        planes_c[(plane * hmc + (my >> 3) + y + lookc) * wmc + (mx >> 3) + x
                 + lookc];
}

constexpr int kMaxFields = 8;
constexpr int kCostThreads = 128;  // 16 groups of 8 lanes

struct CostField {
    const int* mv;   // (>= rows', ld, 2) per source cell
    const int* ref;  // (>= rows', ld)
    float* out;      // (rows, cols)
    int ld, rows, cols;
    int lf;    // log2(S / 8)
    int pair;  // 0; 1 / 2 the first / second cell of x pairs; 3 / 4 of y
    int cta0;  // the field's first block
    float dc;  // c_S (mode z)
};

struct CostArgs {
    CostField f[kMaxFields];
    const int16_t* planes;  // (R, 4, 4, hm, wm) luma phase planes
    const int* oy;          // stride wo
    const float* lam;       // lambda_me (mode z)
    int nf, plain, hm, wm, wo, look;
};

__global__ void __launch_bounds__(kCostThreads)
satd_cost_kernel(const CostArgs a) {
    __shared__ int part[3][16];
    int k = 0;
    while (k + 1 < a.nf && (int)blockIdx.x >= a.f[k + 1].cta0) ++k;
    const CostField& F = a.f[k];
    const int lane = threadIdx.x & 7, g = threadIdx.x >> 3;
    const int lf = F.lf, nb = 1 << (2 * lf), S = 8 << lf;
    const int per = nb >= 16 ? 1 : 16 >> (2 * lf);  // CUs a block
    const int rounds = nb > 16 ? nb >> 4 : 1;
    const int cu0 = ((int)blockIdx.x - F.cta0) * per;
    const int cu = cu0 + (nb >= 16 ? 0 : g >> (2 * lf));
    const bool live = cu < F.rows * F.cols;
    const int cy = live ? cu / F.cols : 0, cx = live ? cu - cy * F.cols : 0;
    int sy = cy, sx = cx;
    if (F.pair == 1 || F.pair == 2) sx = (cx & ~1) | (F.pair - 1);
    if (F.pair == 3 || F.pair == 4) sy = (cy & ~1) | (F.pair - 3);
    const int si = sy * F.ld + sx;
    const int mx = live ? F.mv[2 * si] : 0, my = live ? F.mv[2 * si + 1] : 0;
    const int rf = live ? F.ref[si] : 0;
    const int16_t* pl = a.planes
                        + (size_t)((rf * 4 + (my & 3)) * 4 + (mx & 3))
                              * a.hm * a.wm
                        + (size_t)((my >> 2) + a.look) * a.wm + (mx >> 2)
                        + a.look;
    int am = 0, adc = 0, as = 0;  // the group's m8 (plain) or ac8, dc8, s8
    for (int rd = 0; rd < rounds; ++rd) {
        const int blk = nb >= 16 ? rd * 16 + g : g & (nb - 1);
        const int y = cy * S + (blk >> lf) * 8 + lane;
        const int x = cx * S + (blk & ((1 << lf) - 1)) * 8;
        int v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            v[e] = live ? a.oy[y * a.wo + x + e] - pl[y * a.wm + x + e] : 0;
        const int sa = hadamard8_lanes_abs_sum(v, lane);
        // the DC coefficient, lane 0's first: the residual sum
        const int s8 = __shfl_sync(0xffffffffu, v[0], threadIdx.x & 24);
        const int m8 = (sa + 2) >> 2, dc8 = (abs(s8) + 2) >> 2;
        am += a.plain ? m8 : m8 - dc8;
        adc += dc8;
        as += s8;
    }
    const float dcc = a.plain ? 0.f
                              : __fadd_rn(__fmul_rn(__ldg(a.lam), 12.0f), F.dc);
    if (nb == 1) {
        if (live && lane == 0)
            F.out[cu] = a.plain ? (float)am
                                : __fadd_rn((float)am, fminf((float)adc, dcc));
        return;
    }
    if (lane == 0) {
        part[0][g] = am;
        part[1][g] = adc;
        part[2][g] = as;
    }
    __syncthreads();
    const int ng = nb >= 16 ? 16 : nb;  // groups a CU
    const int t = threadIdx.x;
    if (t >= per || cu0 + t >= F.rows * F.cols) return;
    int sm = 0, sd = 0, ss = 0;
    for (int i = t * ng; i < (t + 1) * ng; ++i) {
        sm += part[0][i];
        sd += part[1][i];
        ss += part[2][i];
    }
    float c;
    if (a.plain) {
        c = (float)sm;
    } else {
        const float cu_dc = (float)((abs(ss) + 2) >> 2);
        const float dcvar = fmaxf(__fsub_rn((float)sd, cu_dc), 0.0f);
        c = __fadd_rn(__fadd_rn((float)sm, __fmul_rn(0.5f, dcvar)),
                      fminf(cu_dc, dcc));
    }
    F.out[cu0 + t] = c;
}

constexpr int kSubpelClasses = 3;
constexpr int kSubpelThreads = 128;  // 16 teams of 8 lanes

struct SubpelClass {
    const int* mv;   // (ncu, 2) full-pel
    const int* ref;  // (ncu,)
    int* out;        // (ncu, 2) quarter-pel
    unsigned long long mag;  // ceil(2^32 / nbw): cu / nbw by a multiply
    int ncu, nbw, lf;        // CUs, CUs a row, log2(S / 8)
    int cta0;                // the class's first block
};

struct SubpelArgs {
    SubpelClass c[kSubpelClasses];
    const int16_t* planes;  // (R, 4, 4, hm, wm) luma phase planes
    const int* oy;          // stride wo
    int nc, hw, wm, wo, look, vec;  // vec: oy's rows in 16-byte loads
};

// the SATD (sum |H r H^T| + 2) >> 2 of the team's 8x8 block against the
// prediction at quarter-pel (qx, qy) of the reference's phase planes
// pl; lane r holds oy's row r in o, (y, x0) its first sample
__device__ __forceinline__ int point_satd(const int (&o)[8],
                                          const int16_t* pl, int hw, int wm,
                                          int look, int qx, int qy, int y,
                                          int x0, int lane) {
    const int16_t* p = pl + ((qy & 3) * 4 + (qx & 3)) * hw
                       + ((qy >> 2) + y + look) * wm + (qx >> 2) + x0 + look;
    int v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = o[e] - __ldg(p + e);
    return (hadamard8_lanes_abs_sum(v, lane) + 2) >> 2;
}

// the CU's nine costs in every lane of its team(s): S = 8 a team's own;
// S = 16 the warp's four teams by xor-shuffles; S = 32 the four warps'
// sums through part (one barrier)
template <int LF>
__device__ __forceinline__ void cu_costs(int (&c)[9], int (*part)[9]) {
    if constexpr (LF > 0) {
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            c[k] += __shfl_xor_sync(0xffffffffu, c[k], 8);
            c[k] += __shfl_xor_sync(0xffffffffu, c[k], 16);
        }
    }
    if constexpr (LF == 2) {
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
            for (int k = 0; k < 9; ++k) part[threadIdx.x >> 5][k] = c[k];
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 9; ++k)
            c[k] = part[0][k] + part[1][k] + part[2][k] + part[3][k];
    }
}

// the least key (cost << 4) | point: the first point among equal costs
// (costs < 2^27: 16 blocks of at most 261,120 at S = 32)
__device__ __forceinline__ int least_key(const int (&c)[9]) {
    int key = c[0] << 4;
#pragma unroll
    for (int k = 1; k < 9; ++k) key = min(key, (c[k] << 4) | k);
    return key;
}

// point k of a square: (k % 3 - 1, k / 3 - 1) without a division
__device__ __forceinline__ void point_offset(int k, int& dx, int& dy) {
    dy = (k >= 3) + (k >= 6) - 1;
    dx = k - 3 * (dy + 1) - 1;
}

// block b of a class of CUs of size 8 << LF
template <int LF>
__device__ __forceinline__ void subpel_class(const SubpelArgs& a,
                                             const SubpelClass& C, int b,
                                             int (*part)[4][9]) {
    constexpr int S = 8 << LF;
    const int lane = threadIdx.x & 7, team = threadIdx.x >> 3;
    // S = 8: a team a CU; 16: a warp a CU, a team a quadrant; 32: the
    // block a CU, a team one of its 16 blocks
    const int cu = LF == 0 ? b * 16 + team : LF == 1 ? b * 4 + (team >> 2)
                                                     : b;
    const int sb = LF == 0 ? 0 : LF == 1 ? (team & 3) : team;
    const bool live = cu < C.ncu;
    const int cuc = live ? cu : 0;  // a dead team scores CU 0, unwritten
    const int cy = (int)(((unsigned long long)cuc * C.mag) >> 32);
    const int cx = cuc - cy * C.nbw;
    const int y = cy * S + (sb >> LF) * 8 + lane;
    const int x0 = cx * S + (sb & ((1 << LF) - 1)) * 8;
    int o[8];
    const int* orow = a.oy + y * a.wo + x0;
    if (a.vec) {
        const int4 p = __ldg(reinterpret_cast<const int4*>(orow));
        const int4 q = __ldg(reinterpret_cast<const int4*>(orow) + 1);
        o[0] = p.x; o[1] = p.y; o[2] = p.z; o[3] = p.w;
        o[4] = q.x; o[5] = q.y; o[6] = q.z; o[7] = q.w;
    } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __ldg(orow + e);
    }
    int mx = __ldg(C.mv + 2 * cuc) * 4, my = __ldg(C.mv + 2 * cuc + 1) * 4;
    const int16_t* pl = a.planes + __ldg(C.ref + cuc) * 16 * a.hw;
    int c[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)  // the half-pel square
        c[k] = point_satd(o, pl, a.hw, a.wm, a.look, mx + (k % 3 - 1) * 2,
                          my + (k / 3 - 1) * 2, y, x0, lane);
    cu_costs<LF>(c, part[0]);
    const int k1 = least_key(c);
    int dx, dy;
    point_offset(k1 & 15, dx, dy);
    mx += 2 * dx;
    my += 2 * dy;
#pragma unroll
    for (int k = 0; k < 9; ++k)  // the quarter-pel square, its centre known
        c[k] = k == 4 ? 0
                      : point_satd(o, pl, a.hw, a.wm, a.look,
                                   mx + (k % 3 - 1), my + (k / 3 - 1), y, x0,
                                   lane);
    cu_costs<LF>(c, part[1]);
    c[4] = k1 >> 4;
    point_offset(least_key(c) & 15, dx, dy);
    const bool first = LF == 0 ? lane == 0 : LF == 1 ? (threadIdx.x & 31) == 0
                                                     : threadIdx.x == 0;
    if (live && first)
        reinterpret_cast<int2*>(C.out)[cu] = make_int2(mx + dx, my + dy);
}

__global__ void __launch_bounds__(kSubpelThreads)
subpel_kernel(const SubpelArgs a) {
    __shared__ int part[2][4][9];
    int k = 0;
    while (k + 1 < a.nc && (int)blockIdx.x >= a.c[k + 1].cta0) ++k;
    const SubpelClass& C = a.c[k];
    const int b = (int)blockIdx.x - C.cta0;
    if (C.lf == 0)
        subpel_class<0>(a, C, b, part);
    else if (C.lf == 1)
        subpel_class<1>(a, C, b, part);
    else
        subpel_class<2>(a, C, b, part);
}

}  // namespace

// Copies the DCT-IF taps to this file's constant memory on the current
// device. Call once per device first.
extern "C" int tpuhevc_grid_pred_init(const int* luma_taps,
                                      const int* chroma_taps) {
    cudaMemcpyToSymbol(c_luma_taps, luma_taps, sizeof(int) * 32);
    cudaMemcpyToSymbol(c_chroma_taps, chroma_taps, sizeof(int) * 32);
    return (int)cudaGetLastError();
}

namespace {

template <int P, int NT, int VEC>
int launch_planes(const int* ref, const int* wpw, const int* wpo,
                  int16_t* out, int n, int h, int w, int pad, int y0, int hm,
                  int wm, int wpd, cudaStream_t stream) {
    const dim3 grid((wm + kTileW - 1) / kTileW, (hm + kTileH - 1) / kTileH,
                    n);
    planes_kernel<P, NT, VEC><<<grid, kPlanesThreads, 0, stream>>>(
        ref, wpw, wpo, out, h, w, pad, y0, hm, wm, wpd);
    return (int)cudaGetLastError();
}

template <int P, int NT>
int planes_by_width(const int* ref, const int* wpw, const int* wpo,
                    int16_t* out, int n, int h, int w, int pad, int y0,
                    int hm, int wm, int wpd, cudaStream_t stream) {
    // the widest store that the rows' alignment allows
    const bool al16 = ((uintptr_t)out & 15) == 0;
    if (al16 && wm % 8 == 0)
        return launch_planes<P, NT, 8>(ref, wpw, wpo, out, n, h, w, pad, y0,
                                       hm, wm, wpd, stream);
    if (al16 && wm % 4 == 0)
        return launch_planes<P, NT, 4>(ref, wpw, wpo, out, n, h, w, pad, y0,
                                       hm, wm, wpd, stream);
    return launch_planes<P, NT, 1>(ref, wpw, wpo, out, n, h, w, pad, y0, hm,
                                   wm, wpd, stream);
}

}  // namespace

// ref (n, h, w) int32 -> out (n, P, P, hm, wm) int16, the window from row
// y0 of the padded plane; wpw, wpo (n,) int32 and the denominator wpd, or
// null for the default rounding.
extern "C" int tpuhevc_grid_planes(const int* ref, const int* wpw,
                                   const int* wpo, int16_t* out, int n,
                                   int h, int w, int luma, int pad, int y0,
                                   int hm, int wm, int wpd, void* stream) {
    const int P = luma ? 4 : 8;
    if (n < 1 || n > 65535 || (long long)n * h * w >= (1LL << 31)
        || (long long)n * P * P * hm * wm >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    return luma ? planes_by_width<4, 8>(ref, wpw, wpo, out, n, h, w, pad, y0,
                                        hm, wm, wpd, st)
                : planes_by_width<8, 4>(ref, wpw, wpo, out, n, h, w, pad, y0,
                                        hm, wm, wpd, st);
}

// One class coding's predictions. ptrs: planes_y (R, 4, 4, hmy, wmy) and
// planes_c (2R, 8, 8, hmc, wmc) int16 (U's references, then V's); mv
// (hc, wc, 2), ref (hc, wc) int32 per 8x8 luma cell -> pred_y (8 hc, 8
// wc), pred_uv (4 hc, 8 wc) int32, [U | V]. ints: R, hmy, wmy, hmc, wmc,
// hc, wc, look, lookc. Both arrays are host memory, read before the
// launch returns.
extern "C" int tpuhevc_grid_satd(const void* const* ptrs, const int* ints,
                                 void* stream) {
    const int R = ints[0], hmy = ints[1], wmy = ints[2], hmc = ints[3];
    const int wmc = ints[4], hc = ints[5], wc = ints[6];
    if (hc < 1 || wc < 1 || hc > 8191
        || (long long)R * 16 * hmy * wmy >= (1LL << 31)
        || (long long)R * 128 * hmc * wmc >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const dim3 grid((wc * 8 + threads - 1) / threads, hc * 8, 3);
    gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int16_t*)ptrs[0], (const int16_t*)ptrs[1],
        (const int*)ptrs[2], (const int*)ptrs[3], (int*)ptrs[4],
        (int*)ptrs[5], R, hmy, wmy, hmc, wmc, hc, wc, ints[7], ints[8]);
    return (int)cudaGetLastError();
}

// The SATD costs of nf (1..kMaxFields) fields in one launch. ptrs:
// planes (R, 4, 4, hm, wm) int16 luma phase planes, oy (stride wo)
// int32, lam (1,) float32 on the card (null with plain), then 3 a field:
// mv (rows' x ld x 2), ref (rows' x ld) int32 per source cell and out
// (rows, cols) float32. ints: nf, plain (1: the sum of m8 a CU; 0: the
// DC-aware cost), R, hm, wm, wo, look, then 5 a field: ld, rows, cols,
// log2(S / 8) (0..3), pair (0..4). dcs: c_S a field (mode z). The three
// arrays are host memory, read before the launch returns.
extern "C" int tpuhevc_grid_satd_cost(const void* const* ptrs,
                                      const int* ints, const float* dcs,
                                      void* stream) {
    const int nf = ints[0], plain = ints[1], R = ints[2];
    CostArgs a;
    a.nf = nf;
    a.planes = (const int16_t*)ptrs[0];
    a.oy = (const int*)ptrs[1];
    a.lam = (const float*)ptrs[2];
    a.plain = plain;
    a.hm = ints[3];
    a.wm = ints[4];
    a.wo = ints[5];
    a.look = ints[6];
    if (nf < 1 || nf > kMaxFields || (!plain && a.lam == nullptr)
        || (long long)R * 16 * a.hm * a.wm >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    int blocks = 0;
    for (int k = 0; k < nf; ++k) {
        const int* v = ints + 7 + 5 * k;
        const void* const* p = ptrs + 3 + 3 * k;
        CostField& f = a.f[k];
        f.mv = (const int*)p[0];
        f.ref = (const int*)p[1];
        f.out = (float*)p[2];
        f.ld = v[0];
        f.rows = v[1];
        f.cols = v[2];
        f.lf = v[3];
        f.pair = v[4];
        f.dc = dcs[k];
        f.cta0 = blocks;
        if (f.lf < 0 || f.lf > 3 || f.pair < 0 || f.pair > 4 || f.rows < 0
            || f.cols < 0 || f.cols > f.ld)
            return (int)cudaErrorInvalidValue;
        const int ncu = f.rows * f.cols, nb = 1 << (2 * f.lf);
        const int per = nb >= 16 ? 1 : 16 / nb;
        blocks += (ncu + per - 1) / per;
    }
    if (blocks == 0) return 0;
    satd_cost_kernel<<<blocks, kCostThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// The subpel search of nc (1..3) classes of CUs in one launch. ptrs:
// planes (R, 4, 4, hm, wm) int16 luma phase planes, oy (stride wo)
// int32, then 3 a class: mv (ncu, 2) full-pel and ref (ncu,) int32 ->
// out (ncu, 2) quarter-pel int32. ints: nc, R, hm, wm, wo, look, then 4 a
// class: ncu, nbh, nbw, log2(S / 8) (0..2), the CUs on an nbh x nbw grid
// of S x S blocks of oy. Both arrays are host memory, read before the
// launch returns.
extern "C" int tpuhevc_grid_subpel(const void* const* ptrs, const int* ints,
                                   void* stream) {
    const int nc = ints[0], R = ints[1], hm = ints[2], wm = ints[3];
    SubpelArgs a;
    a.planes = (const int16_t*)ptrs[0];
    a.oy = (const int*)ptrs[1];
    a.hw = hm * wm;
    a.wm = wm;
    a.wo = ints[4];
    a.look = ints[5];
    a.vec = ((uintptr_t)a.oy & 15) == 0 && a.wo % 4 == 0;
    if (nc < 1 || nc > kSubpelClasses
        || (long long)R * 16 * hm * wm >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    // the 32x32 class's blocks first: they take the longest
    int order[kSubpelClasses], n = 0;
    for (int lf = 2; lf >= 0; --lf)
        for (int k = 0; k < nc; ++k)
            if (ints[6 + 4 * k + 3] == lf) order[n++] = k;
    if (n != nc) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    a.nc = 0;
    for (int i = 0; i < nc; ++i) {
        const int k = order[i];
        const int* v = ints + 6 + 4 * k;
        const int ncu = v[0], nbh = v[1], nbw = v[2], lf = v[3];
        if (ncu != nbh * nbw || ncu < 0 || nbw < 1 || ncu >= (1 << 20)
            || (long long)ncu * nbw >= (1LL << 32))
            return (int)cudaErrorInvalidValue;
        if (ncu == 0) continue;
        SubpelClass& C = a.c[a.nc++];
        C.mv = (const int*)ptrs[2 + 3 * k];
        C.ref = (const int*)ptrs[3 + 3 * k];
        C.out = (int*)ptrs[4 + 3 * k];
        C.mag = ((1ULL << 32) + nbw - 1) / nbw;
        C.ncu = ncu;
        C.nbw = nbw;
        C.lf = lf;
        C.cta0 = blocks;
        const int per = lf == 0 ? 16 : lf == 1 ? 4 : 1;  // CUs a block
        blocks += (ncu + per - 1) / per;
    }
    if (blocks == 0) return 0;
    subpel_kernel<<<blocks, kSubpelThreads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
