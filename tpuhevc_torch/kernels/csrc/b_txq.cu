// b_txq: the B step's TU coding with the table RDOQ and the skip/code drop,
// a B picture's three planes in one launch.
//
// Replaces: tpuhevc/codec/inter_b.py:181-194, `code_blocks` (a closure of
// `_b_step` that XLA compiled for the TPU), over the int32 JAX transforms
// of tpuhevc/ops/transforms.py:144-198, `rdoq_est_xp` (:317-422) and
// `ResidualBitEst.tu_bits` (tpuhevc/entropy/bitest.py:286-378), at bit
// depth BD (8 or 10, a template argument: the 10-bit variant is the 8-bit
// code with the transforms' shifts (tu_team.cuh) and the clip compiled
// in, one launch one depth; the quantiser's, dequantiser's and RDOQ's
// constants come from the host at that depth).
//
// What it computes, per TU of size S (4..16) of each class (a plane's
// TUs, with its QP's constants and its estimator's tables):
//   r = cur - pred; c = forward DCT-II at BD (tx_common.cuh);
//   lvl = the float32 table RDOQ of c (rdoq_common.cuh) with the B-slice
//         estimator's tables and the full lambda;
//   with sign-bit hiding (the SBH variant): per 4x4 CG whose first and
//         last nonzero lie 4 or more apart in the CG's diagonal scan and
//         whose absolute sum's parity differs from the first level's sign,
//         one level in that span moves by +-1, at the first least
//         |new 2^qbits - |c| scale| over the positions in scan order, +1
//         before -1 at each (-1 not at 0, nor to 0 at the first), a level
//         that was 0 taking c's sign: tpuhevc's host rule
//         (entropy/residual.py apply_sign_bit_hiding against
//         ops/transforms.py ideal_levels_np, whose float64 errors are
//         exact, so the int64 ones order as they do);
//   rsd = inverse DCT of the dequantised levels at BD;
//   rec = clip(pred + rsd, 0, 2^BD - 1) (the reference takes pred where
//         every level is 0; rsd is then 0 and pred lies in 0..2^BD - 1,
//         so the clip gives pred: no nz test is needed);
//   bits = the table bit estimate of lvl (tu_bits_team.cuh, float32; the
//          SBH variant counts one sign fewer a hiding CG);
//   drop = (float)(sse(cur, pred) - sse(cur, rec)) <= lam * bits, the
//          SSEs int32 as in JAX (at 10 bits a 16x16 TU's reaches ~2.7e8,
//          above 2^24 but below 2^31), their difference converted once
//          with round-to-nearest as JAX's astype does, the product
//          rounded on its own (-fmad=false);
//   dropped: lvl = 0, rec = pred.
//
// What bounds it: the transform's 4 S^3 multiply-adds and ~60 float
// operations per coefficient of the RDOQ; device memory sees cur and pred
// once and writes lvl and rec once (~0.0007 ms of bytes for a 416x240 B
// picture's three planes): the chain of dependent steps a TU sets the
// time.
// Design: one launch for the classes of a B picture (luma 16x16, U and V
// 8x8; the one-plane entry is the same kernel with one class), each
// class's pointers and constants by value in the launch's parameters and
// its blocks in turn, the 16x16 class first. The TU size is compiled in
// (a template on log2), a team of lanes a TU as intra_txq.cu has it
// (tu_team.cuh: 16x16 two warps, 8x8 a warp, 4x4 16 lanes; as many TUs a
// block of 256 as fit), the matrix staged once a block from a copy in
// device memory (constant memory would serialise the lanes' distinct
// addresses), each entry loaded before any shared store. A lane
// of the bit team (S^2 / 4 lanes, tu_bits_team.cuh; a smaller TU's team
// repeats it in its other lanes) holds one 16-byte vector of a CG row: it
// loads that vector of cur and pred before any shared store, stores the
// residual, prices the levels there, and writes lvl and rec there in
// 16-byte stores. The transforms follow intra_txq's lane layout; the
// RDOQ is a CG a 16-lane group (`rdoq_level_group`: the Rice stand-in by
// shuffles, the CG-keep and CG-zero sums in the serial order from the
// group's costs in shared memory, not a chain of 30 shuffles); the bits
// are the lane teams' int32 sums in units of 2^-15 (exact, so equal to
// the double sums of the reference's port); the SSEs by shuffles
// (integers). A team inside one warp meets by __syncwarp; the 16x16
// class's two warps by block barriers, the same steps in every team of
// the block. Sign hiding is a variant compiled in (a template on SBH): the
// RDOQ step keeps the coefficients in Y, then one lane a CG hides its sign
// in shared memory (a TU's 1, 4 or 16 CGs); without SBH the code is the
// kernel as it was.

#include "rdoq_common.cuh"
#include "tu_bits_team.cuh"
#include "tu_team.cuh"

namespace {

constexpr int kMaxClasses = 3;

// One class: a plane's TUs (n of S x S = 1 << log2), its first block.
struct TxqClass {
    const int* cur;
    const int* pred;
    const int* itab;
    const float* ftab;
    int* lvl;
    int* rec;
    int n, log2, block0, dqscale, dqshift, qscale, qbits;
    Rdoq rq;
};

struct TxqJob {
    TxqClass c[kMaxClasses];
    int ncls;
};

template <int LOG2>
struct TxqSmem {
    static constexpr int TUS = TuTeam<LOG2>::TUS, N2 = 1 << (2 * LOG2);
    static constexpr int WPB = kTuBlock / 32;  // warps a block
    TxMats<LOG2> m;
    alignas(16) int X[TUS][N2];  // residual, coefficients, levels, the
                                 // inverse columns
    alignas(16) int Y[TUS][N2];  // forward rows, dequantised, residual
    alignas(16) float KZ[TUS][2 * N2];  // the RDOQ's CG costs, a group's 32
    int red[2][WPB];
    unsigned map[WPB];  // the bit teams' CG flags, keys and sums
    int key[WPB];
    int acc[WPB][5];
};

union BTxqSmem {
    TxqSmem<4> s16;
    TxqSmem<3> s8;
    TxqSmem<2> s4;
};

// a sample clipped to 0..2^BD - 1
template <int BD>
__device__ __forceinline__ int clip_bd(int v) {
    return min(max(v, 0), (1 << BD) - 1);
}

// scan position -> raster index in a 4x4 diagonal scan
__constant__ int c_diag4[16] = {0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10,
                                7, 14, 11, 15};

// Sign-bit hiding of CG c (raster index in the S x S TU) of the levels L
// against the coefficients C, by one lane.
template <int LOG2>
__device__ __forceinline__ void sbh_cg(int* L, const int* C, int c,
                                       int qscale, int qbits) {
    constexpr int S = 1 << LOG2, CGW = S >> 2;
    const int cy = c / CGW, cx = c - cy * CGW;
    int idx[16], lv[16];
    int first = 16, last = -1, asum = 0;
#pragma unroll
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
    int lead = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) lead = p == first ? lv[p] : lead;
    if ((asum & 1) == (lead < 0 ? 1 : 0)) return;
    long long best = 0x7fffffffffffffffLL;
    int bp = 0, bna = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
        if (p < first || p > last) continue;
        const int a = abs(lv[p]);
        const long long ia = (long long)abs(C[idx[p]]) * qscale;
        const long long eu = llabs(((long long)(a + 1) << qbits) - ia);
        if (eu < best) {
            best = eu;
            bp = p;
            bna = a + 1;
        }
        if (a >= 1 && !(p == first && a == 1)) {
            const long long ed = llabs(((long long)(a - 1) << qbits) - ia);
            if (ed < best) {
                best = ed;
                bp = p;
                bna = a - 1;
            }
        }
    }
    int l0 = 0, e0 = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
        if (p == bp) {
            l0 = lv[p];
            e0 = idx[p];
        }
    }
    const int sgn = l0 != 0 ? (l0 > 0 ? 1 : -1) : (C[e0] >= 0 ? 1 : -1);
    L[e0] = sgn * bna;
}

// the 32-point DCT in device memory (the matrix staged from it, 16-byte
// runs a row, where constant memory would serialise the lanes' reads)
__device__ int g_t32[32 * 32];

// The blocks of one class: block blk of it codes TUs blk * TUS + slot.
template <int LOG2, bool SBH, int BD>
__device__ __forceinline__ void txq_tus(const TxqClass& k, int blk,
                                        TxqSmem<LOG2>& sm) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, N2 = L::N2, TEAM = L::TEAM, CPL = L::CPL;
    constexpr int CGW = S > 4 ? S / 4 : 1;
    constexpr int BL = BitsTeam<S>::kLanes;
    const int slot = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
    const int tu0 = blk * L::TUS + slot;
    const bool live = tu0 < k.n;
    const int tu = live ? tu0 : k.n - 1;  // a spare team repeats the last
    int* X = sm.X[slot];
    int* Y = sm.Y[slot];

    // the lanes t < BL own a vector each; the rest of the team repeats
    // the bit team on the same levels. Every load that does not wait for
    // another goes first: the vectors, the matrix entry, then the lane's
    // tables (the last-position bits wait for the group index)
    const bool lead = t < BL;
    const size_t base = (size_t)tu * N2 + bits_e0<S>(t % BL);
    int4 c4 = make_int4(0, 0, 0, 0), p4 = c4;
    if (lead) {
        c4 = __ldg(reinterpret_cast<const int4*>(k.cur + base));
        p4 = __ldg(reinterpret_cast<const int4*>(k.pred + base));
    }
    const int tm = threadIdx.x < N2
                       ? __ldg(g_t32 + tx_dct_index<LOG2>(threadIdx.x)) : 0;
    const BitsLane<S> bl = bits_lane<S>(t % BL, k.itab, k.ftab);
    if (threadIdx.x < N2) tx_put_mats<LOG2>(sm.m, threadIdx.x, tm);
    int d_skip = 0;
    if (lead) {
        const int4 r4 = make_int4(c4.x - p4.x, c4.y - p4.y, c4.z - p4.z,
                                  c4.w - p4.w);
        *reinterpret_cast<int4*>(X + bl.e0) = r4;
        d_skip = r4.x * r4.x + r4.y * r4.y + r4.z * r4.z + r4.w * r4.w;
    }
    __syncthreads();
    team_forward<LOG2, BD>(X, Y, sm.m, t);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {  // coefficient i of CG g at c
        const int c = t + TEAM * j, g = c >> 4, i = c & 15;
        const int e = ((g / CGW) * 4 + (i >> 2)) * S + (g % CGW) * 4 + (i & 3);
        const int cf = X[e];
        if constexpr (SBH) Y[e] = cf;  // the coefficient, for the hiding
        X[e] = rdoq_level_group(cf, LOG2, rdoq_tabs(e, LOG2, k.ftab), k.rq,
                                sm.KZ[slot] + 2 * (c & ~15));
    }
    team_sync<TEAM>();
    if constexpr (SBH) {
        if (t < CGW * CGW) sbh_cg<LOG2>(X, Y, t, k.qscale, k.qbits);
        team_sync<TEAM>();
    }
    const int4 lv = *reinterpret_cast<const int4*>(X + bl.e0);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int e = t + TEAM * j;
        Y[e] = tx_dequant(X[e], k.dqscale, k.dqshift);
    }
    // the bit team's first warp in the block: its scratch
    const int w0 = (threadIdx.x >> 5) - bl.wt;
    const float bits = tu_bits_lanes<S, SBH>(bl, lv, k.ftab, sm.map + w0,
                                             sm.key + w0, sm.acc + w0);
    team_sync<TEAM>();
    team_inv_cols<LOG2>(Y, X, sm.m, t);
    team_sync<TEAM>();
    {
        int tc[S];
        tx_matrix_col<LOG2>(sm.m, t & (S - 1), tc);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            const int e = t + TEAM * j;
            Y[e] = tx_inv_row_at<LOG2, BD>(X, tc, e >> LOG2);
        }
    }
    team_sync<TEAM>();
    int4 r4 = p4;
    int d_coded = 0;
    if (lead) {
        const int4 rs = *reinterpret_cast<const int4*>(Y + bl.e0);
        r4 = make_int4(clip_bd<BD>(p4.x + rs.x), clip_bd<BD>(p4.y + rs.y),
                       clip_bd<BD>(p4.z + rs.z), clip_bd<BD>(p4.w + rs.w));
        const int dx = c4.x - r4.x, dy = c4.y - r4.y, dz = c4.z - r4.z,
                  dw = c4.w - r4.w;
        d_coded = dx * dx + dy * dy + dz * dz + dw * dw;
    }
    d_skip = team_sum<TEAM>(d_skip, sm.red[0]);
    d_coded = team_sum<TEAM>(d_coded, sm.red[1]);
    // (float) of an int rounds to nearest (cvt.rn), as JAX's astype does
    const bool drop = (float)(d_skip - d_coded) <= k.rq.lam * bits;
    if (lead && live) {
        *reinterpret_cast<int4*>(k.lvl + base) =
            drop ? make_int4(0, 0, 0, 0) : lv;
        *reinterpret_cast<int4*>(k.rec + base) = drop ? p4 : r4;
    }
}

template <bool SBH, int BD>
__global__ void __launch_bounds__(kTuBlock)
b_txq_kernel(const __grid_constant__ TxqJob job) {
    __shared__ BTxqSmem sm;
    const int b = blockIdx.x;
    int k = 0;  // this block's class
    while (k + 1 < job.ncls && b >= job.c[k + 1].block0) ++k;
    const TxqClass& c = job.c[k];
    switch (c.log2) {
        case 4: txq_tus<4, SBH, BD>(c, b - c.block0, sm.s16); break;
        case 3: txq_tus<3, SBH, BD>(c, b - c.block0, sm.s8); break;
        default: txq_tus<2, SBH, BD>(c, b - c.block0, sm.s4); break;
    }
}

int tus_a_block(int log2) {
    return log2 == 4 ? TuTeam<4>::TUS
                     : (log2 == 3 ? TuTeam<3>::TUS : TuTeam<2>::TUS);
}

}  // namespace

// Copies the 32x32 HEVC DCT (int32, host memory) to this file's constant
// memory on the current device. Call once per device before tpuhevc_b_txq.
extern "C" int tpuhevc_b_txq_init(const int* host_t32) {
    cudaMemcpyToSymbol(g_t32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// ncls classes (1..3) in one launch, in the order given (the caller puts
// the largest TUs first); sbh != 0 takes the sign-hiding variant, and
// bit_depth (8 or 10) the variant of that depth. Class i: ptrs[6 i ..] =
// cur, pred (n, S, S) int32 (samples of bit_depth, pred in 0..2^bit_depth
// - 1), itab, ftab (its estimator's tables: entropy/bitest.py
// EstTables), lvl, rec (n, S, S) int32 out, all on the device and 16-byte
// aligned; ints[6 i ..] = n, log2 (S = 1 << log2 in 4..16), dqscale,
// dqshift (tpuhevc_torch/ops/transforms.py dequant_params), qscale, qbits
// (its quant_params: the quantiser's scale and shift), all at bit_depth;
// flts[7 i ..] = scale, qdiv, inv_qdiv, inv_den (rdoq_consts at
// bit_depth), lam (the full lambda),
// lc0 = lam * csbf[0][0], lc1 = lam * csbf[0][1], rounded to float32.
// The arrays lie in host memory and go by value into the launch.
extern "C" int tpuhevc_b_txq(int ncls, int sbh, void* const* ptrs,
                             const int* ints, const float* flts,
                             int bit_depth, void* stream) {
    if (ncls < 1 || ncls > kMaxClasses || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    TxqJob job = {};
    job.ncls = ncls;
    int blocks = 0;
    for (int i = 0; i < ncls; ++i) {
        TxqClass& c = job.c[i];
        c.cur = (const int*)ptrs[6 * i];
        c.pred = (const int*)ptrs[6 * i + 1];
        c.itab = (const int*)ptrs[6 * i + 2];
        c.ftab = (const float*)ptrs[6 * i + 3];
        c.lvl = (int*)ptrs[6 * i + 4];
        c.rec = (int*)ptrs[6 * i + 5];
        c.n = ints[6 * i];
        c.log2 = ints[6 * i + 1];
        c.dqscale = ints[6 * i + 2];
        c.dqshift = ints[6 * i + 3];
        c.qscale = ints[6 * i + 4];
        c.qbits = ints[6 * i + 5];
        const float* f = flts + 7 * i;
        c.rq = {f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
        if (c.n < 1 || c.log2 < 2 || c.log2 > 4)
            return (int)cudaErrorInvalidValue;
        c.block0 = blocks;
        const int tus = tus_a_block(c.log2);
        blocks += (c.n + tus - 1) / tus;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (bit_depth == 8) {
        if (sbh)
            b_txq_kernel<true, 8><<<blocks, kTuBlock, 0, st>>>(job);
        else
            b_txq_kernel<false, 8><<<blocks, kTuBlock, 0, st>>>(job);
    } else {
        if (sbh)
            b_txq_kernel<true, 10><<<blocks, kTuBlock, 0, st>>>(job);
        else
            b_txq_kernel<false, 10><<<blocks, kTuBlock, 0, st>>>(job);
    }
    return (int)cudaGetLastError();
}
