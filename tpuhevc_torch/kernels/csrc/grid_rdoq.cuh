// The grid step's RDOQ and sign-bit hiding of one TU by one group of
// threads (a warp or the block: grid_code.cu's Group), for grid_code.cu.
//
// Replaces: tpuhevc/codec/inter_grid.py:399-559 (`_rdoq_tiles`,
// `_lastpos_geom`, `rdoq_plane`) and :561-631 (`ideal_plane`,
// `_to_cg_scan`, `_from_cg_scan`, `sbh_plane`), jnp code that XLA compiled
// for the TPU inside the grid step.
//
// grid_rdoq_group, per coefficient c of the S x S TU (S = 1 << log2):
//   ac = |c| scale, lmax = ceil(ac / 2^qbits) (float32);
//   rice per 4x4 CG from the CG's max lmax (largest k <= 4 with
//     3 2^k <= max, 0 unless max > 6);
//   cost(l) = d^2 + lam bits(l), d = (ac - l 2^qbits) / (scale 2^tshift),
//     bits(0) = sig0, bits(l) = sig1 + 1 + gt1/gt2 bins + the Rice length
//     (prev_csbf 0 significance costs, the CG0 or later gt1/gt2 sets);
//   best = the cheaper of ceil and ceil-1 (ties to ceil), then 0 unless it
//     beats 0 (ties to the level);
//   per CG: keep it unless sum(d0^2) + lam csbf0 < sum(cost(best)) + lam
//     csbf1 (ties keep);
//   the last-position walk-back over diagonal scan positions k: cost(k) =
//     prefix of the coded costs before k + cost(k) - lam sig1(k) + lam
//     (last_x + last_y bits of k) + the zero distortion after k; the first
//     k of least cost among nonzero levels is the last one kept;
//   level = clip(sign(c) best, -lim, lim).
// The float32 arithmetic is the reference's, operation by operation
// (compiled with -fmad=false, IEEE division), and its sums are added in
// the order XLA's CPU backend adds them: a CG sum in raster order; a
// cumulative sum in blocks of 16 (each block left to right, the blocks'
// totals scanned likewise, recursively, each block's exclusive prefix
// added); a whole-TU sum in chunks of 32, each left to right, then the
// chunks. The scan permutation is a gather through the estimator's scan
// tables (the reference multiplies by a 0/1 float matrix, which is the
// same permutation).
//
// grid_sbh_cg, one thread per 4x4 CG: in the CG's diagonal scan order,
// where the first and last nonzero levels lie 4 or more apart and the
// parity of the CG's absolute sum differs from the first level's sign,
// one level changes by +-1: the first least |a +- 1 - |ideal|| over the
// +1 candidates then the -1 candidates (in the span; +1 up to lim; -1 not
// at a zero, nor at the first level when it is 1), ideal = c scale /
// 2^qbits in float32; the sign of a level that is 0 is the ideal's.
//
// What bounds it: the latency of its dependent steps (measured per launch
// on the H100: a launch's time does not grow with the TUs it codes), not
// its few hundred float operations a coefficient. So the order-bound
// serial sums that do not depend on each other run side by side on
// different threads (the two cumulative sums and the zero-distortion
// chunks), and SBH divides each coefficient once. All state is in the
// group's shared memory.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kSbhInf = 1e30f;
// scan position -> raster index in a 4x4 diagonal scan
__constant__ int c_diag4[16] = {0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10,
                                7, 14, 11, 15};

// A group's RDOQ scratch: MaxCg CGs (= 16-blocks of the cumulative sums),
// Warps warps.
template <int MaxCg, int Warps>
struct RdoqSh {
    int rice[MaxCg];
    int keep[MaxCg];
    float tot[2][MaxCg], otot[2][MaxCg], o2[2][4];
    float chunk[MaxCg > 2 ? MaxCg / 2 : 1];
    float best_c[Warps];
    int best_k[Warps];
    float totcz;
    int pbest;
};

// The estimator's float tables (entropy/bitest.py `_foffsets`).
struct EstF {
    const float* ftab;
    int n2;
    __device__ float sig(int y, int x, int S, int bin) const {
        return ftab[(y * S + x) * 2 + bin];  // prev_csbf 0
    }
    __device__ float csbf(int bin) const { return ftab[8 * n2 + bin]; }
    __device__ float g1(int i, bool cg0) const {
        return ftab[8 * n2 + (cg0 ? 6 : 4) + i];
    }
    __device__ float g2(int i, bool cg0) const {
        return ftab[8 * n2 + (cg0 ? 10 : 8) + i];
    }
    __device__ float lastx(int i) const { return ftab[8 * n2 + 12 + i]; }
    __device__ float lasty(int i) const { return ftab[8 * n2 + 28 + i]; }
};

struct RdoqQ {
    float q2, err_den, scale, lam;
    int lim;
};

__device__ __forceinline__ float rdoq_lvl_bits(float level, int rice,
                                               float s1, bool cg0,
                                               const EstF& e) {
    const int r = (int)fmaxf(level - 3.0f, 0.0f);
    const int three = 3 << rice;
    const int rl = r < three
        ? (r >> rice) + 1 + rice
        : 4 + rice + 2 * (31 - __clz(((r - three) >> rice) + 1));
    const float gt1_0 = e.g1(0, cg0), gt1_1 = e.g1(1, cg0);
    const float gt2_0 = e.g2(0, cg0), gt2_1 = e.g2(1, cg0);
    const float w2 = level > 2.0f ? (gt2_1 - gt2_0) + (float)rl : 0.0f;
    const float w1 = level > 1.0f ? ((gt1_1 - gt1_0) + gt2_0) + w2 : 0.0f;
    return ((s1 + 1.0f) + gt1_0) + w1;
}

__device__ __forceinline__ float rdoq_cost(float ac, float level, float s0,
                                           float s1, int rice, bool cg0,
                                           const EstF& e, const RdoqQ& q) {
    const float d = (ac - level * q.q2) / q.err_den;
    const float bits =
        level > 0.0f ? rdoq_lvl_bits(level, rice, s1, cg0, e) : s0;
    return d * d + q.lam * bits;
}

// Step 1 of XLA CPU's cumulative sum of x[0..n) into out (n = 16, 64, 256
// or 1024) for block b (< n / 16, or 0 when n = 16): the block scanned
// left to right, its total into tot[b].
__device__ __forceinline__ void cumsum_block(const float* x, float* out,
                                             int b, float* tot) {
    float acc = x[b * 16];
    out[b * 16] = acc;
    for (int i = 1; i < 16; ++i) {
        acc = acc + x[b * 16 + i];
        out[b * 16 + i] = acc;
    }
    tot[b] = acc;
}

// Step 2: the totals of nb = n / 16 blocks (4, 16 or 64), scanned in
// blocks of 16 (or of nb), the j-th's running sums into otot, its total
// into o2[j].
__device__ __forceinline__ void cumsum_totals(const float* tot, float* otot,
                                              float* o2, int nb, int j) {
    const int len = nb > 16 ? 16 : nb;
    float acc = tot[j * len];
    otot[j * len] = acc;
    for (int i = 1; i < len; ++i) {
        acc = acc + tot[j * len + i];
        otot[j * len + i] = acc;
    }
    o2[j] = acc;
}

// The whole-TU zero distortion of CZS (scan order, n2 entries): chunk c
// of Len (32, or the whole n2 <= 32) left to right.
template <int Len>
__device__ __forceinline__ float chunk_sum(const float* czs, int c) {
    float v[Len];
#pragma unroll
    for (int i = 0; i < Len; ++i) v[i] = czs[c * Len + i];
    float acc = v[0];
#pragma unroll
    for (int i = 1; i < Len; ++i) acc = acc + v[i];
    return acc;
}

// RDOQ of the TU's coefficients A (raster) into levels L (raster), T =
// 1 << LOG2. AC, BEST (raster) and CCS, CZS, ICC, ICZ (scan order) are n2
// floats of the group's shared memory each; the whole group calls.
template <int LOG2, class G, class Sh>
__device__ void grid_rdoq_group(const G& g, const int* A, int* L, float* AC,
                                float* BEST, float* CCS, float* CZS,
                                float* ICC, float* ICZ,
                                const int* __restrict__ itab,
                                const float* __restrict__ ftab,
                                const RdoqQ& q, Sh* sh) {
    constexpr int log2 = LOG2, S = 1 << log2, n2 = S * S, mask = S - 1;
    constexpr int cgw = S >> 2, ncg = cgw * cgw;
    const int* scan_pos = itab;
    const int* scan_x = itab + n2;
    const int* scan_y = itab + 2 * n2;
    const int* group_idx = itab + 3 * n2 + ncg;
    const EstF e{ftab, n2};
    // the ceiling levels, then each CG's rice parameter from their max
    for (int i = g.rank; i < n2; i += G::kSize) {
        const float ac = (float)abs(A[i]) * q.scale;
        AC[i] = ac;
        BEST[i] = ceilf(ac / q.q2);
    }
    g.sync();
    for (int c = g.rank; c < ncg; c += G::kSize) {
        const int cy = c / cgw, cx = c - cy * cgw;
        float mx = 0.0f;
        for (int i = 0; i < 16; ++i)
            mx = fmaxf(mx, BEST[(cy * 4 + (i >> 2)) * S + cx * 4 + (i & 3)]);
        int k = 0;
        for (int j = 1; j <= 4; ++j) k += mx >= (float)(3 << j);
        sh->rice[c] = mx > 6.0f ? k : 0;
    }
    g.sync();
    // per coefficient: ceil, ceil - 1 or 0; the CG trial's coded cost
    for (int i = g.rank; i < n2; i += G::kSize) {
        const int y = i >> log2, x = i & mask;
        const bool cg0 = y < 4 && x < 4;
        const int rice = sh->rice[(y >> 2) * cgw + (x >> 2)];
        const float s0 = e.sig(y, x, S, 0), s1 = e.sig(y, x, S, 1);
        const float ac = AC[i], lmax = BEST[i];
        const float l1 = fmaxf(lmax, 0.0f), l2 = fmaxf(lmax - 1.0f, 0.0f);
        const float c1 = rdoq_cost(ac, l1, s0, s1, rice, cg0, e, q);
        const float c2 = rdoq_cost(ac, l2, s0, s1, rice, cg0, e, q);
        float best = c1 <= c2 ? l1 : l2;
        const float cb = c1 <= c2 ? c1 : c2;
        if (!(cb <= rdoq_cost(ac, 0.0f, s0, s1, rice, cg0, e, q)))
            best = 0.0f;
        BEST[i] = best;
        // (the cost of `best` again: the reference recomputes it)
        CCS[i] = rdoq_cost(ac, best, s0, s1, rice, cg0, e, q);
        const float acn = ac / q.err_den;
        CZS[i] = acn * acn;
    }
    g.sync();
    const float lc1 = q.lam * e.csbf(1), lc0 = q.lam * e.csbf(0);
    for (int c = g.rank; c < ncg; c += G::kSize) {
        const int cy = c / cgw, cx = c - cy * cgw;
        const int o = cy * 4 * S + cx * 4;
        float ck = CCS[o], cz = CZS[o];
        for (int i = 1; i < 16; ++i) {
            ck = ck + CCS[o + (i >> 2) * S + (i & 3)];
            cz = cz + CZS[o + (i >> 2) * S + (i & 3)];
        }
        sh->keep[c] = ck + lc1 <= cz + lc0;
    }
    g.sync();
    // the walk-back's per-position costs, in scan order
    const float c16_1 = e.csbf(1) / 16.0f, lc16_0 = lc0 / 16.0f;
    for (int i = g.rank; i < n2; i += G::kSize) {
        const int y = i >> log2, x = i & mask;
        const int c = (y >> 2) * cgw + (x >> 2);
        const float ac = AC[i];
        const float acn = ac / q.err_den;
        const float czp = acn * acn;
        float cc;
        if (sh->keep[c]) {
            const float best = BEST[i];
            const float d = (ac - best * q.q2) / q.err_den;
            const float bits = best > 0.0f
                ? rdoq_lvl_bits(best, sh->rice[c], e.sig(y, x, S, 1),
                                y < 4 && x < 4, e)
                : e.sig(y, x, S, 0);
            cc = d * d + q.lam * (bits + c16_1);
        } else {
            BEST[i] = 0.0f;
            cc = czp + lc16_0;
        }
        const int k = scan_pos[i];
        CCS[k] = cc;
        CZS[k] = czp;
    }
    g.sync();
    // side by side: the blocks of both cumulative sums (CCS -> ICC, CZS ->
    // ICZ) and the whole-TU zero distortion's chunks
    constexpr int nb = n2 >> 4;  // 16-blocks (1, 4, 16, 64)
    constexpr int nch = n2 > 32 ? n2 >> 5 : 1, clen = n2 > 32 ? 32 : n2;
    for (int t = g.rank; t < 2 * nb + nch; t += G::kSize) {
        if (t < nb)
            cumsum_block(CCS, ICC, t, sh->tot[0]);
        else if (t < 2 * nb)
            cumsum_block(CZS, ICZ, t - nb, sh->tot[1]);
        else
            sh->chunk[t - 2 * nb] = chunk_sum<clen>(CZS, t - 2 * nb);
    }
    g.sync();
    // the blocks' totals scanned (n2 > 16), and the chunks added
    constexpr int nb1 = nb > 16 ? nb >> 4 : 1;
    for (int t = g.rank; t < 2 * nb1 + 1; t += G::kSize) {
        if (t < 2 * nb1) {
            const int a = t < nb1 ? 0 : 1;
            if (n2 > 16)
                cumsum_totals(sh->tot[a], sh->otot[a], sh->o2[a], nb,
                              t - a * nb1);
        } else {
            float acc = sh->chunk[0];
            for (int c = 1; c < nch; ++c) acc = acc + sh->chunk[c];
            sh->totcz = acc;
        }
    }
    g.sync();
    if (nb > 16) {  // nb = 64: four blocks of totals a sum
        if (g.rank < 2) {
            float* o2 = sh->o2[g.rank];
            float acc = o2[0];
            for (int i = 1; i < nb1; ++i) {
                acc = acc + o2[i];
                o2[i] = acc;
            }
        }
        g.sync();
        for (int t = g.rank; t < 2 * nb; t += G::kSize) {
            const int a = t < nb ? 0 : 1, b = t - a * nb;
            if (b >= 16) sh->otot[a][b] = sh->otot[a][b] + sh->o2[a][(b >> 4) - 1];
        }
        g.sync();
    }
    if (n2 > 16) {
        for (int t = g.rank; t < 2 * n2; t += G::kSize) {
            const int a = t < n2 ? 0 : 1, i = t - a * n2;
            float* out = a ? ICZ : ICC;
            if (i >= 16) out[i] = out[i] + sh->otot[a][(i >> 4) - 1];
        }
        g.sync();
    }
    // first least cost over scan positions with a nonzero level
    float bc = __int_as_float(0x7f800000);  // +inf
    int bk = n2;
    for (int k = g.rank; k < n2; k += G::kSize) {
        const int sx = scan_x[k], sy = scan_y[k];
        if (BEST[sy * S + sx] <= 0.0f) continue;
        const float ccs = CCS[k];
        const float pref = ICC[k] - ccs;
        const float suf = sh->totcz - ICZ[k];
        const float lbv = q.lam * e.lastx(group_idx[sx])
                          + q.lam * e.lasty(group_idx[sy]);
        const float cost = (((pref + ccs) - q.lam * e.sig(sy, sx, S, 1))
                            + lbv) + suf;
        if (cost < bc) {
            bc = cost;
            bk = k;
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float oc = __shfl_down_sync(0xffffffffu, bc, off);
        const int ok = __shfl_down_sync(0xffffffffu, bk, off);
        if (oc < bc || (oc == bc && ok < bk)) {
            bc = oc;
            bk = ok;
        }
    }
    const int lane = g.rank & 31, warp = g.rank >> 5;
    if (lane == 0) {
        sh->best_c[warp] = bc;
        sh->best_k[warp] = bk;
    }
    g.sync();
    if (g.rank == 0) {
        float c = sh->best_c[0];
        int k = sh->best_k[0];
        for (int w = 1; w < G::kWarps; ++w)
            if (sh->best_c[w] < c
                || (sh->best_c[w] == c && sh->best_k[w] < k)) {
                c = sh->best_c[w];
                k = sh->best_k[w];
            }
        // no nonzero level: the reference's argmin of all-inf is 0
        sh->pbest = k < n2 ? k : 0;
    }
    g.sync();
    for (int i = g.rank; i < n2; i += G::kSize) {
        const int best = scan_pos[i] <= sh->pbest ? (int)BEST[i] : 0;
        const int c = A[i];
        const int l = c < 0 ? -best : (c > 0 ? best : 0);
        L[i] = min(max(l, -q.lim), q.lim);
    }
    g.sync();
}

// Sign-bit hiding of CG c (raster index in the T x T TU, T = 1 << LOG2)
// of the levels L, with the coefficients A; one thread. Each
// coefficient's ideal level is divided once.
template <int LOG2>
__device__ void grid_sbh_cg(int* L, const int* A, int c, float scale,
                            float q2, int lim) {
    constexpr int S = 1 << LOG2, cgw = S >> 2;
    const int cy = c / cgw, cx = c - cy * cgw;
    int idx[16], lv[16];
    int first = 16, last = -1, asum = 0;
    for (int p = 0; p < 16; ++p) {
        const int r = c_diag4[p];
        idx[p] = (cy * 4 + (r >> 2)) * S + cx * 4 + (r & 3);
        lv[p] = L[idx[p]];
        if (lv[p] != 0) {
            first = min(first, p);
            last = p;
        }
        asum += abs(lv[p]);
    }
    if (last - first < 4) return;
    const bool want = lv[min(first, 15)] < 0;
    if (((asum & 1) != 0) == want) return;
    float iv[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) iv[p] = ((float)A[idx[p]] * scale) / q2;
    float bc = kSbhInf;
    int bi = 0;
    for (int j = 0; j < 32; ++j) {
        const int p = j & 15;
        const int a = abs(lv[p]);
        const float ia = fabsf(iv[p]);
        float err = kSbhInf;
        if (p >= first && p <= last) {
            if (j < 16) {
                if (a + 1 <= lim) err = fabsf((float)(a + 1) - ia);
            } else if (!(a == 0 || (p == first && a == 1))) {
                err = fabsf((float)(a - 1) - ia);
            }
        }
        if (err < bc) {
            bc = err;
            bi = j;
        }
    }
    const int p = bi & 15;
    const int dabs = bi < 16 ? 1 : -1;
    int sgn;
    if (lv[p] != 0)
        sgn = lv[p] > 0 ? 1 : -1;
    else
        sgn = iv[p] >= 0.0f ? 1 : -1;
    L[idx[p]] = lv[p] + sgn * dabs;
}

}  // namespace
