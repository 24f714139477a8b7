// grid_code: the grid step's residual coding, of up to kMaxSeg planes
// (each one TU size) in one launch.
//
// Replaces: tpuhevc/codec/inter_grid.py:1718-1750 `_txq_luma` and the
// `_txq_chroma` closure of `class_code` (:1822-1851), with the coding of
// `intra16_code` (:2205-2258), over the plane transforms of :342-383
// (`fwd_tx`, `quant_plane`, `deq_plane`, `inv_tx`), the grid's RDOQ and
// sign-bit hiding (`rdoq_plane`, `sbh_plane`, :399-631, in
// grid_rdoq.cuh) and the table bit estimate of
// tpuhevc/entropy/bitest.py:286-378 (`ResidualBitEst.tu_bits` with the
// live tables), 8-bit.
//
// What it computes, per T x T TU of each segment's (h, w) plane (T =
// 4..32):
//   r = orig - pred; c = forward DCT (tx_common.cuh's stages);
//   lvl = clip(sign(c) ((|c| scale + add) >> qbits), -lim, lim), or with
//         rdoq the grid's RDOQ (grid_rdoq.cuh); with sbh, sign-bit hiding
//         per 4x4 CG;
//   rsd = inverse DCT of clip16(dequant(lvl));
//   rec = nz ? clip(pred + rsd, 0, 255) : pred, nz = #(lvl != 0);
//   d_skip, d_coded = int32 SSE of orig - pred and orig - rec, as float;
//   bits = the table bit estimate (tu_bits_group below: its fractional
//          sums in double; one sign fewer per hiding CG with sbh);
//   drop = d_skip + lam cbf0 <= d_coded + lam (bits + cbf1), float32,
//          every product rounded on its own (-fmad=false), as XLA; lam
//          and cbf0, cbf1 read from the device (no host sync a call);
//   out: dropped ? (lvl 0, rec pred, d d_skip, b cbf0, cbf 0)
//                : (lvl, rec, d d_coded, b bits + cbf1, cbf nz); d0 = d_skip.
//
// What bounds it: the latency of one TU's chain of dependent steps. On the
// H100 a launch of one plane took the same time whatever its TU count
// (12-13 us for 52 to 780 8x8 TUs), 0.85 ms for one anchor P picture's
// 40 launches against a bound of 0.01 ms: the card sat nearly idle while
// each TU walked its ~40 barriers, serial sums and table lookups. Design:
// (1) the class coding's planes (luma and chroma at each RQT depth) go in
// one launch, their chains side by side, the largest TUs' blocks first;
// (2) a TU's chain is shortened where the order of its sums allows: the
// TU size is a template parameter (the loops unroll, the index arithmetic
// folds), the forward rows read a transposed copy of the matrix (no
// 32-way bank conflict at T = 32), the matrix comes from global memory
// (coalesced, not a constant-cache walk), the bit estimate's per-CG and
// per-coefficient passes run on every thread of the TU's group, the
// RDOQ's independent serial sums side by side (grid_rdoq.cuh); (3) at most
// 85 registers a thread, three blocks an SM, so a launch runs in fewer
// waves. A TU of T <= 8 is one warp's, eight TUs to a block of 256
// threads; a larger TU is the block's. Sums keep their order: the float
// sums as before, the integer and double ones exact in any order. Each
// step was measured on the H100 against the last (PERF.md, Findings).

#include "grid_rdoq.cuh"
#include "tx_common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxSeg = 8;
// three blocks an SM: at most 85 registers a thread (~115 uncapped), so
// that a launch of several planes runs in fewer waves
constexpr int kMinBlocks = 3;
// threads a TU: a warp for 4x4 and 8x8, the block for 16x16 and 32x32
__host__ __device__ constexpr int group_size(int log2) {
    return log2 <= 3 ? 32 : kThreads;
}

// the 32x32 HEVC DCT in global memory (coalesced loads into shared)
__device__ int g_dct32[32 * 32];

// One TU's Size threads: a warp (T <= 8) or the block (T >= 16).
template <int Size>
struct Group {
    static constexpr int kSize = Size, kWarps = Size / 32;
    static constexpr int kMaxCg = Size == kThreads ? 64 : 4;
    int rank;
    __device__ void sync() const {
        if (Size == 32)
            __syncwarp();
        else
            __syncthreads();
    }
};

// A plane of one TU size: its tensors and its quantiser's constants.
struct Seg {
    const int* orig;
    const int* pred;
    const int* itab;
    const float* ftab;
    const float* lam;
    const float* cbf;
    int* lvl;
    int* rec;
    float* d;
    float* b;
    int* nz;
    float* d0;
    int h, w, log2, scale, add, qbits, dqscale, dqshift;
    int block0, ntu;  // the segment's first block, its TUs
};

struct Batch {
    Seg seg[kMaxSeg];
    int nseg, lim, rdoq, sbh;
};

// The table bit estimate's per-CG scratch of a group.
template <int MaxCg>
struct TuSh {
    int csbf[MaxCg], nsig[MaxCg], ngt1[MaxCg], gt2[MaxCg], rice[MaxCg];
    int last, nhide;
};

template <class G>
struct GroupSh {
    RdoqSh<G::kMaxCg, G::kWarps> rdoq;
    TuSh<G::kMaxCg> tu;
    int isum[2][G::kWarps];
    double dsum[3][G::kWarps];
    float bits;
};

// Shared words of one group's slab at log2 (A, B, L, P, C; the RDOQ's five
// float arrays; GroupSh).
__host__ __device__ constexpr int slab_words(int log2, bool rdoq) {
    return (1 << (2 * log2)) * (rdoq ? 10 : 5)
           + (int)(group_size(log2) == 32 ? sizeof(GroupSh<Group<32>>)
                                           : sizeof(GroupSh<Group<kThreads>>))
                 / 4 + 2;
}

// Sum of two ints over the group; every thread gets both totals.
template <class G>
__device__ __forceinline__ int2 group_sum2(const G& g, int a, int b,
                                           GroupSh<G>* sh) {
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (G::kWarps == 1)
        return make_int2(__shfl_sync(0xffffffffu, a, 0),
                         __shfl_sync(0xffffffffu, b, 0));
    const int lane = g.rank & 31, warp = g.rank >> 5;
    if (lane == 0) {
        sh->isum[0][warp] = a;
        sh->isum[1][warp] = b;
    }
    g.sync();
    int2 t = make_int2(0, 0);
    for (int w = 0; w < G::kWarps; ++w) {
        t.x += sh->isum[0][w];
        t.y += sh->isum[1][w];
    }
    g.sync();
    return t;
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;  // lane 0
}

// The table bit estimate (entropy/bitest.py's) over a group (a warp or
// the block): the per-CG passes a thread a CG, the per-coefficient pass
// over every thread; the last position and the counts by shared atomics
// (integers: exact in any order), the three fractional sums in double
// (exact in any order: every table value is a multiple of 2^-15) reduced
// over the group, each rounded once to float32, then added in float32 in
// the reference's order. The result is valid on every thread.
template <int LOG2, class G>
__device__ float tu_bits_group(const G& g, const int* lv,
                               const int* __restrict__ itab,
                               const float* __restrict__ ftab,
                               GroupSh<G>* gs, bool sbh) {
    auto* t = &gs->tu;
    constexpr int log2 = LOG2, S = 1 << log2, n2 = S * S, mask = S - 1;
    constexpr int cgw = S >> 2, ncg = cgw * cgw;
    const int* scan_pos = itab;
    const int* scan_x = itab + n2;
    const int* scan_y = itab + 2 * n2;
    const int* cg_scan = itab + 3 * n2;
    const int* group_idx = cg_scan + ncg;
    const float* sig = ftab;
    const float* csbf_bits = ftab + 8 * n2;
    const float* g1 = csbf_bits + 4;
    const float* g10 = csbf_bits + 6;
    const float* g2 = csbf_bits + 8;
    const float* g20 = csbf_bits + 10;
    const float* lastx = csbf_bits + 12;
    const float* lasty = csbf_bits + 28;
    if (g.rank == 0) {
        t->last = -1;
        t->nhide = 0;
    }
    g.sync();
    // pass 1: per-CG statistics, the last position, the hiding CGs
    for (int c = g.rank; c < ncg; c += G::kSize) {
        const int cy = c / cgw, cx = c - cy * cgw;
        int ns = 0, n1 = 0, any2 = 0, mx = 0, lo = 16, hi = -1, last = -1;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            const int e = (cy * 4 + (i >> 2)) * S + cx * 4 + (i & 3);
            const int a = abs(lv[e]);
            const int sp = scan_pos[e];
            ns += a > 0;
            n1 += a > 1;
            any2 |= a > 2;
            mx = max(mx, a);
            if (a > 0) {
                last = max(last, sp);
                lo = min(lo, sp & 15);
                hi = max(hi, sp & 15);
            }
        }
        if (sbh && ns > 0 && hi - lo >= 4) atomicAdd(&t->nhide, 1);
        if (last >= 0) atomicMax(&t->last, last);
        t->csbf[c] = ns > 0;
        t->nsig[c] = ns;
        t->ngt1[c] = n1;
        t->gt2[c] = any2;
        int k = 0;
        for (int j = 1; j <= 4; ++j) k += mx >= (3 << j);
        t->rice[c] = mx > 6 ? k : 0;
    }
    g.sync();
    const int last = t->last;
    const int lastc = max(last, 0);
    const int last_cg = lastc >> 4;
    // pass 2: CG flags, gt1/gt2 bins, signs
    double csbf_sum = 0.0, b12_sum = 0.0, sig_sum = 0.0;
    int nsign = 0, rice_sum = 0;
    for (int c = g.rank; c < ncg; c += G::kSize) {
        const int cy = c / cgw, cx = c - cy * cgw;
        const int right = cx + 1 < cgw ? t->csbf[c + 1] : 0;
        const int below = cy + 1 < cgw ? t->csbf[c + cgw] : 0;
        const int cgs = cg_scan[c];
        if (cgs > 0 && cgs < last_cg)
            csbf_sum += (double)csbf_bits[(right | below) * 2 + t->csbf[c]];
        const bool cg0 = cgs == 0;
        const int bins1 = min(t->nsig[c], 8);
        const int ones1 = min(t->ngt1[c], bins1);
        const float b1 = (cg0 ? g10[1] : g1[1]) * (float)ones1
                         + (cg0 ? g10[0] : g1[0]) * (float)(bins1 - ones1);
        const float b2 = t->ngt1[c] > 0
            ? (cg0 ? (t->gt2[c] ? g20[1] : g20[0])
                   : (t->gt2[c] ? g2[1] : g2[0]))
            : 0.0f;
        b12_sum += (double)(b1 + b2);
        nsign += t->nsig[c];
    }
    // pass 3: significance flags and remainders
    for (int e = g.rank; e < n2; e += G::kSize) {
        const int y = e >> log2, x = e & mask;
        const int c = (y >> 2) * cgw + (x >> 2);
        const int cy = y >> 2, cx = x >> 2;
        const int a = abs(lv[e]);
        const int cgs = cg_scan[c];
        const bool on = t->csbf[c] || cgs == 0 || cgs == last_cg;
        if (scan_pos[e] < last && on) {
            const int right = cx + 1 < cgw ? t->csbf[c + 1] : 0;
            const int below = cy + 1 < cgw ? t->csbf[c + cgw] : 0;
            const int prev = right + 2 * below;
            sig_sum += (double)sig[((prev * S + y) * S + x) * 2 + (a > 0)];
        }
        const int rem = a - 2;
        if (rem > 0) {
            const int k = t->rice[c];
            const int three = 3 << k;
            if (rem < three) {
                rice_sum += (rem >> k) + 1 + k;
            } else {
                const int ext = 31 - __clz(((rem - three) >> k) + 1);
                rice_sum += 4 + 2 * ext + k;
            }
        }
    }
    csbf_sum = warp_sum(csbf_sum);
    b12_sum = warp_sum(b12_sum);
    sig_sum = warp_sum(sig_sum);
    const int lane = g.rank & 31, warp = g.rank >> 5;
    if (lane == 0) {
        gs->dsum[0][warp] = csbf_sum;
        gs->dsum[1][warp] = sig_sum;
        gs->dsum[2][warp] = b12_sum;
    }
    const int2 ints = group_sum2(g, rice_sum, nsign, gs);  // (syncs)
    if (g.rank == 0) {
        double cs = 0.0, ss = 0.0, bs = 0.0;
        for (int w = 0; w < G::kWarps; ++w) {
            cs += gs->dsum[0][w];
            ss += gs->dsum[1][w];
            bs += gs->dsum[2][w];
        }
        float bits = lastx[group_idx[scan_x[lastc]]]
                     + lasty[group_idx[scan_y[lastc]]];
        bits = bits + (float)cs;
        bits = bits + (float)ss;
        bits = bits + (float)bs;
        bits = bits + (float)ints.x;
        bits = bits + (float)(ints.y - t->nhide);
        gs->bits = last >= 0 ? bits : 0.0f;
    }
    g.sync();
    return gs->bits;
}


// One T x T TU (T = 1 << LOG2; tu of the segment) by group g: its slab
// of shared memory, the block's matrix Tm and its transpose Tt. The TU
// size is a compile-time constant: its loops unroll.
template <int LOG2, class G>
__device__ void code_tu(const G& g, const Seg& s, int tu, int lim,
                        bool rdoq, bool sbh, const int* Tm, const int* Tt,
                        int* slab) {
    constexpr int log2 = LOG2, S = 1 << log2, n2 = S * S, mask = S - 1;
    int* A = slab;    // residual, coefficients, dequant, recon
    int* B = A + n2;  // transform scratch (a float array of the RDOQ)
    int* L = B + n2;  // levels
    int* P = L + n2;  // prediction
    int* C = P + n2;  // source
    float* F = reinterpret_cast<float*>(C + n2);  // RDOQ: 5 n2 floats
    GroupSh<G>* sh = reinterpret_cast<GroupSh<G>*>(
        slab + n2 * (rdoq ? 10 : 5));
    const float lam = *s.lam, cbf0 = s.cbf[0], cbf1 = s.cbf[1];
    const int ntw = s.w >> log2;
    const int ty = tu / ntw, tx = tu - ty * ntw;
    const size_t base = (size_t)(ty * S) * s.w + tx * S;
    int d_skip = 0;
    for (int e = g.rank; e < n2; e += G::kSize) {
        const size_t o = base + (size_t)(e >> log2) * s.w + (e & mask);
        const int c = s.orig[o], p = s.pred[o];
        C[e] = c;
        P[e] = p;
        A[e] = c - p;
        d_skip += (c - p) * (c - p);
    }
    g.sync();
    // forward: rows through the transposed matrix (lane k reads column
    // k: no bank conflict), then columns
    constexpr int s1 = log2 - 1;
    for (int e = g.rank; e < n2; e += G::kSize) {
        const int y = e >> log2, k = e & mask;
        int acc = 0;
        for (int x = 0; x < S; ++x) acc += A[y * S + x] * Tt[x * S + k];
        B[e] = (acc + (1 << (s1 - 1))) >> s1;
    }
    g.sync();
    for (int e = g.rank; e < n2; e += G::kSize)
        A[e] = tx_fwd_cols(B, Tm, log2, e);
    g.sync();
    const float q2 = (float)(1 << s.qbits);
    if (rdoq) {
        const RdoqQ rq{q2, (float)(s.scale << (7 - log2)), (float)s.scale,
                       lam, lim};
        grid_rdoq_group<LOG2>(g, A, L, F, F + n2, F + 2 * n2, F + 3 * n2,
                              F + 4 * n2, reinterpret_cast<float*>(B),
                              s.itab, s.ftab, rq, &sh->rdoq);
    } else {
        for (int e = g.rank; e < n2; e += G::kSize) {
            const int c = A[e];
            int l = (abs(c) * s.scale + s.add) >> s.qbits;
            l = c < 0 ? -l : (c > 0 ? l : 0);
            L[e] = min(max(l, -lim), lim);
        }
        g.sync();
    }
    if (sbh) {
        constexpr int ncg = 1 << (2 * log2 - 4);
        for (int c = g.rank; c < ncg; c += G::kSize)
            grid_sbh_cg<LOG2>(L, A, c, (float)s.scale, q2, lim);
        g.sync();
    }
    int nz = 0;
    for (int e = g.rank; e < n2; e += G::kSize) {
        const int l = L[e];
        nz += l != 0;
        A[e] = tx_dequant(l, s.dqscale, s.dqshift);
    }
    const int2 sums = group_sum2(g, nz, d_skip, sh);  // syncs: A, L complete
    nz = sums.x;
    d_skip = sums.y;
    if (G::kWarps == 1) g.sync();
    for (int e = g.rank; e < n2; e += G::kSize)
        B[e] = tx_inv_cols(A, Tm, log2, e);
    g.sync();
    for (int e = g.rank; e < n2; e += G::kSize)
        A[e] = tx_inv_rows(B, Tm, log2, e);
    g.sync();
    int d_coded = 0;
    for (int e = g.rank; e < n2; e += G::kSize) {
        const int rec = nz ? min(max(P[e] + A[e], 0), 255) : P[e];
        A[e] = rec;
        d_coded += (C[e] - rec) * (C[e] - rec);
    }
    d_coded = group_sum2(g, d_coded, 0, sh).x;
    const float bits = tu_bits_group<LOG2>(g, L, s.itab, s.ftab, sh, sbh);
    const float ds = (float)d_skip, dc = (float)d_coded;
    const float bc = bits + cbf1;
    const bool drop = ds + lam * cbf0 <= dc + lam * bc;
    for (int e = g.rank; e < n2; e += G::kSize) {
        const size_t o = base + (size_t)(e >> log2) * s.w + (e & mask);
        s.lvl[o] = drop ? 0 : L[e];
        s.rec[o] = drop ? P[e] : A[e];
    }
    if (g.rank == 0) {
        s.d[tu] = drop ? ds : dc;
        s.b[tu] = drop ? cbf0 : bc;
        s.nz[tu] = drop ? 0 : nz;
        s.d0[tu] = ds;
    }
}

// Block blk of segment s (T = 1 << LOG2): its kThreads / G::kSize
// groups, a TU each.
template <int LOG2>
__device__ __forceinline__ void run_group(const Seg& s, int blk, int lim,
                                          bool rdoq, bool sbh, const int* Tm,
                                          const int* Tt, int* slabs) {
    using G = Group<group_size(LOG2)>;
    const int grp = threadIdx.x / G::kSize;
    const int tu = blk * (kThreads / G::kSize) + grp;
    if (tu < s.ntu)
        code_tu<LOG2>(G{(int)threadIdx.x % G::kSize}, s, tu, lim, rdoq, sbh,
                      Tm, Tt, slabs + grp * slab_words(LOG2, rdoq));
}

// A block of segment s: one TU of T >= 16, or eight of T <= 8 (a warp
// each). The block first stages the S x S matrix and its transpose.
__global__ void __launch_bounds__(kThreads, kMinBlocks) grid_code_kernel(
        const __grid_constant__ Batch bt) {
    extern __shared__ int smem[];
    int si = 0;
    while (si + 1 < bt.nseg && (int)blockIdx.x >= bt.seg[si + 1].block0) ++si;
    const Seg& s = bt.seg[si];
    const int log2 = s.log2, S = 1 << log2, n2 = S * S, mask = S - 1;
    int* Tm = smem;
    int* Tt = smem + n2;
    const int step = 5 - log2;
    for (int e = threadIdx.x; e < n2; e += kThreads) {
        const int v = g_dct32[((e >> log2) << step) * 32 + (e & mask)];
        Tm[e] = v;
        Tt[(e & mask) * S + (e >> log2)] = v;
    }
    __syncthreads();
    const int blk = (int)blockIdx.x - s.block0;
    const bool rdoq = bt.rdoq != 0, sbh = bt.sbh != 0;
    int* slabs = smem + 2 * n2;
    switch (log2) {
        case 2: run_group<2>(s, blk, bt.lim, rdoq, sbh, Tm, Tt, slabs); break;
        case 3: run_group<3>(s, blk, bt.lim, rdoq, sbh, Tm, Tt, slabs); break;
        case 4: run_group<4>(s, blk, bt.lim, rdoq, sbh, Tm, Tt, slabs); break;
        default: run_group<5>(s, blk, bt.lim, rdoq, sbh, Tm, Tt, slabs);
    }
}

// Dynamic shared memory of a block of log2 (words).
int block_words(int log2, bool rdoq) {
    const int n2 = 1 << (2 * log2);
    return 2 * n2 + kThreads / group_size(log2) * slab_words(log2, rdoq);
}

}  // namespace

// Copies the 32x32 HEVC DCT (int32, host memory) to this file's device
// memory on the current device. Call once per device before
// tpuhevc_grid_code.
extern "C" int tpuhevc_grid_code_init(const int* host_t32) {
    cudaMemcpyToSymbol(g_dct32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// nseg (1..kMaxSeg) planes in one launch. ptrs: 12 a segment, in the order
// orig, pred (h, w) int32; itab, ftab (the estimator's tables,
// entropy/bitest.py EstTables); lam (1,), cbf (2,: cbf0, cbf1) float32 ->
// lvl, rec (h, w) int32; d, b (h/T, w/T) float32; nz (h/T, w/T) int32;
// d0 (h/T, w/T) float32, all on the device. ints: 8 a segment, h, w,
// log2 (T = 1 << log2 dividing h and w), scale, add, qbits (as
// tpuhevc_torch/ops/transforms.py quant_params, inter rounding), dqscale,
// dqshift (dequant_params). lim 127 or 32767; rdoq / sbh 0 or 1. Both
// arrays are host memory, read before the launch returns.
extern "C" int tpuhevc_grid_code(const void* const* ptrs, const int* ints,
                                 int nseg, int lim, int rdoq, int sbh,
                                 void* stream) {
    if (nseg < 1 || nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
    Batch bt;
    bt.nseg = 0;
    bt.lim = lim;
    bt.rdoq = rdoq;
    bt.sbh = sbh;
    // the largest TUs (the longest chains) first
    int blocks = 0, words = 0;
    for (int log2 = 5; log2 >= 2; --log2) {
        for (int k = 0; k < nseg; ++k) {
            const int* v = ints + 8 * k;
            if (v[2] != log2) continue;
            if (v[2] < 2 || v[2] > 5 || v[0] % (1 << v[2]) || v[1] % (1 << v[2]))
                return (int)cudaErrorInvalidValue;
            const void* const* p = ptrs + 12 * k;
            Seg& s = bt.seg[bt.nseg++];
            s.orig = (const int*)p[0];
            s.pred = (const int*)p[1];
            s.itab = (const int*)p[2];
            s.ftab = (const float*)p[3];
            s.lam = (const float*)p[4];
            s.cbf = (const float*)p[5];
            s.lvl = (int*)p[6];
            s.rec = (int*)p[7];
            s.d = (float*)p[8];
            s.b = (float*)p[9];
            s.nz = (int*)p[10];
            s.d0 = (float*)p[11];
            s.h = v[0];
            s.w = v[1];
            s.log2 = v[2];
            s.scale = v[3];
            s.add = v[4];
            s.qbits = v[5];
            s.dqscale = v[6];
            s.dqshift = v[7];
            s.ntu = (v[0] >> v[2]) * (v[1] >> v[2]);
            s.block0 = blocks;
            const int per = kThreads / group_size(log2);
            blocks += (s.ntu + per - 1) / per;
            const int w = block_words(log2, rdoq != 0);
            words = w > words ? w : words;
        }
    }
    if (bt.nseg != nseg) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    // The opt-in holds for the current device only, so it is made before
    // every launch that needs it, as each card of a mesh needs its own.
    const size_t shm = (size_t)words * sizeof(int);
    if (shm > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            grid_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shm);
        if (e != cudaSuccess) return (int)e;
    }
    grid_code_kernel<<<blocks, kThreads, shm, (cudaStream_t)stream>>>(bt);
    return (int)cudaGetLastError();
}
