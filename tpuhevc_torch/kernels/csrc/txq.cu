// K4: fused inter TU coding with the skip/code decision, every class's
// three planes of a P picture in one launch.
//
// Replaces: tpuhevc/codec/inter_batch.py:193-211 (`coded_plane`,
// `bits_est`, `sse`) and the drop rule at 231-236 / 246-252 (closures of
// build_ldp_scan that XLA compiled for the TPU), over the int32 JAX
// transforms of tpuhevc/ops/transforms.py:144-198.
//
// What it computes, per TU of size S (4..32) of each job (a plane of a
// class: its TUs, its QP's constants), at bit depth BD (8 or 10, one
// launch one depth; the constants from the host at that depth):
//   r = cur - pred
//   h = (r T^T + 2^(s1-1)) >> s1, s1 = log2 + BD - 9;  c = (T h + 2^(s2-1)) >> s2, s2 = log2 + 6
//   lvl = sign(c) * ((|c| * qscale + qadd) >> qbits), clipped to int16
//   deq = lvl * dqscale, then a rounded >> dqshift (or << -dqshift), int16
//   g = clip16((T^T deq + 64) >> 7);  rsd = clip16((g T + 2^(s3-1)) >> s3), s3 = 20 - BD
//   rec = nz ? clip(pred + rsd, 0, 2^BD - 1) : pred, nz = any(lvl != 0)
//   bits = sum(2 * min(15, bitlen|lvl|) + (lvl != 0))
//   drop = (sse(cur, pred) - sse(cur, rec)) <= (lam_full * bits) >> 8,
//          the product wrapping in int32 as under JAX
//   dropped: lvl = 0, rec = pred, d = sse(cur, pred), bits = 0;
//   else d = sse(cur, rec).
// Every sum is int32 exactly as in JAX (stage sums stay below 2^28; a
// 32x32 TU's SSE at 10 bits below 2^30).
// Where every level is 0, rsd is 0 and pred lies in 0..2^BD - 1, so the
// clip gives pred: rec = clip(pred + rsd) needs no nz test. The 10-bit
// variant is the 8-bit code with BD's shifts and clip compiled in.
//
// What bounds it: the bytes: device memory sees cur and pred once and
// writes lvl and rec once (16 bytes a sample, ~0.0014 ms for the 416x240
// P picture's 289,536 samples); the transform's 4 S^3 multiply-adds a TU
// come second.
// Design: one launch for the jobs (a P picture's classes, Y, U and V
// each, up to 12), each job's pointers and constants by value in a
// `__grid_constant__` table and its blocks in turn, the 32x32 TUs first.
// The TU size is compiled in (a template on log2), a team of lanes a TU
// (tu_team.cuh: 32x32 the block, 16x16 two warps, 8x8 a warp, 4x4 16
// lanes; as many TUs a block of 256 as fit), the matrix staged once a
// block from a copy in device memory (constant memory would serialise the
// lanes' distinct addresses). Lane t < S^2 / 4 of a team holds the 16-byte
// vector 4t..4t+3 of cur, pred, lvl and rec (one load or store each); the
// transform stages are the team's of tu_team.cuh; each lane quantises its
// own coefficients of the last forward stage; the bit proxy and both SSEs
// are team sums (team_sum: shuffles, and a barrier for a team of several
// warps), so that the drop is known in every lane.

#include "tu_team.cuh"

namespace {

constexpr int kMaxJobs = 12;

// One job: a plane's TUs (n of S x S = 1 << log2), its first block.
struct TxqJob {
    const int* cur;
    const int* pred;
    int* lvl;
    int* rec;
    int* d;
    int* bits;
    int n, log2, block0, qscale, qadd, qbits, dqscale, dqshift;
};

struct TxqJobs {
    TxqJob j[kMaxJobs];
    int njobs, lam_full;
};

template <int LOG2>
struct TxqSmem {
    static constexpr int TUS = TuTeam<LOG2>::TUS, N2 = 1 << (2 * LOG2);
    TxMats<LOG2> m;
    alignas(16) int X[TUS][N2];  // residual, coefficients, levels, the
                                 // inverse columns
    alignas(16) int Y[TUS][N2];  // forward rows, dequantised, residual
    int red[3][kTuBlock / 32];
};

union TxqSmemAll {
    TxqSmem<5> s32;
    TxqSmem<4> s16;
    TxqSmem<3> s8;
    TxqSmem<2> s4;
};

// a sample clipped to 0..2^BD - 1
template <int BD>
__device__ __forceinline__ int clip_bd(int v) {
    return min(max(v, 0), (1 << BD) - 1);
}

// the 32-point DCT in device memory, staged from there once a block
__device__ int g_t32[32 * 32];

// The blocks of one job: block blk of it codes TUs blk * TUS + slot.
template <int LOG2, int BD>
__device__ __forceinline__ void txq_tus(const TxqJob& k, int blk,
                                        int lam_full, TxqSmem<LOG2>& sm) {
    using L = TuTeam<LOG2>;
    constexpr int S = L::S, N2 = L::N2, TEAM = L::TEAM, CPL = L::CPL;
    constexpr int NV = N2 / 4;  // lanes with a vector
    constexpr int MPT = (N2 + kTuBlock - 1) / kTuBlock;  // matrix entries
    const int slot = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
    const int tu0 = blk * L::TUS + slot;
    const bool live = tu0 < k.n;
    const int tu = live ? tu0 : k.n - 1;  // a spare team repeats the last
    int* X = sm.X[slot];
    int* Y = sm.Y[slot];

    // every load that does not wait for another goes first: the vectors,
    // then the matrix entries
    const bool lead = t < NV;
    const size_t base = (size_t)tu * N2 + 4 * t;
    int4 c4 = make_int4(0, 0, 0, 0), p4 = c4;
    if (lead) {
        c4 = __ldg(reinterpret_cast<const int4*>(k.cur + base));
        p4 = __ldg(reinterpret_cast<const int4*>(k.pred + base));
    }
    int tm[MPT];
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
        const int e = threadIdx.x + kTuBlock * i;
        tm[i] = e < N2 ? __ldg(g_t32 + tx_dct_index<LOG2>(e)) : 0;
    }
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
        const int e = threadIdx.x + kTuBlock * i;
        if (e < N2) tx_put_mats<LOG2>(sm.m, e, tm[i]);
    }
    int d_skip = 0;
    if (lead) {
        const int4 r4 = make_int4(c4.x - p4.x, c4.y - p4.y, c4.z - p4.z,
                                  c4.w - p4.w);
        *reinterpret_cast<int4*>(X + 4 * t) = r4;
        d_skip = r4.x * r4.x + r4.y * r4.y + r4.z * r4.z + r4.w * r4.w;
    }
    __syncthreads();
    team_forward<LOG2, BD>(X, Y, sm.m, t);
    // quantise the lane's coefficients, count their bits, dequantise
    int bits = 0;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
        const int e = t + TEAM * j;
        const int lev = tx_quant(X[e], k.qscale, k.qadd, k.qbits);
        const int a = abs(lev);
        bits += 2 * min(15, 32 - __clz(a)) + (a != 0);
        X[e] = lev;
        Y[e] = tx_dequant(lev, k.dqscale, k.dqshift);
    }
    team_sync<TEAM>();
    const int4 lv = lead ? *reinterpret_cast<const int4*>(X + 4 * t)
                         : make_int4(0, 0, 0, 0);
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
        const int4 rs = *reinterpret_cast<const int4*>(Y + 4 * t);
        r4 = make_int4(clip_bd<BD>(p4.x + rs.x), clip_bd<BD>(p4.y + rs.y),
                       clip_bd<BD>(p4.z + rs.z), clip_bd<BD>(p4.w + rs.w));
        const int dx = c4.x - r4.x, dy = c4.y - r4.y, dz = c4.z - r4.z,
                  dw = c4.w - r4.w;
        d_coded = dx * dx + dy * dy + dz * dz + dw * dw;
    }
    d_skip = team_sum<TEAM>(d_skip, sm.red[0]);
    d_coded = team_sum<TEAM>(d_coded, sm.red[1]);
    bits = team_sum<TEAM>(bits, sm.red[2]);
    const int rate = (int)((unsigned)lam_full * (unsigned)bits) >> 8;
    const bool drop = d_skip - d_coded <= rate;
    if (lead && live) {
        *reinterpret_cast<int4*>(k.lvl + base) =
            drop ? make_int4(0, 0, 0, 0) : lv;
        *reinterpret_cast<int4*>(k.rec + base) = drop ? p4 : r4;
    }
    if (t == 0 && live) {
        k.d[tu] = drop ? d_skip : d_coded;
        k.bits[tu] = drop ? 0 : bits;
    }
}

template <int BD>
__global__ void __launch_bounds__(kTuBlock)
txq_kernel(const __grid_constant__ TxqJobs jobs) {
    __shared__ TxqSmemAll sm;
    const int b = blockIdx.x;
    int k = 0;  // this block's job
    while (k + 1 < jobs.njobs && b >= jobs.j[k + 1].block0) ++k;
    const TxqJob& j = jobs.j[k];
    switch (j.log2) {
        case 5: txq_tus<5, BD>(j, b - j.block0, jobs.lam_full, sm.s32); break;
        case 4: txq_tus<4, BD>(j, b - j.block0, jobs.lam_full, sm.s16); break;
        case 3: txq_tus<3, BD>(j, b - j.block0, jobs.lam_full, sm.s8); break;
        default: txq_tus<2, BD>(j, b - j.block0, jobs.lam_full, sm.s4); break;
    }
}

int tus_a_block(int log2) {
    switch (log2) {
        case 5: return TuTeam<5>::TUS;
        case 4: return TuTeam<4>::TUS;
        case 3: return TuTeam<3>::TUS;
        default: return TuTeam<2>::TUS;
    }
}

}  // namespace

// Copies the 32x32 HEVC DCT matrix (int32, host memory) to this file's
// copy in device memory on the current device. Call once per device
// before tpuhevc_txq.
extern "C" int tpuhevc_txq_init(const int* host_t32) {
    cudaMemcpyToSymbol(g_t32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// njobs jobs (1..12) in one launch, in the order given (the caller puts
// the largest TUs first). Job i: ptrs[6 i ..] = cur, pred (n, S, S) int32
// (samples of bit_depth 8 or 10, pred in 0..2^bit_depth - 1), lvl, rec
// (n, S, S), d, bits (n,) int32 out, all on the device, cur, pred, lvl and
// rec 16-byte aligned; ints[7 i ..] = n >= 1, log2 (S = 1 << log2 in
// 4..32), qscale, qadd, qbits, dqscale, dqshift
// (tpuhevc_torch/ops/transforms.py quant_params / dequant_params at that
// depth). The arrays lie in host memory and go by value into the launch.
extern "C" int tpuhevc_txq(int njobs, void* const* ptrs, const int* ints,
                           int lam_full, int bit_depth, void* stream) {
    if (njobs < 1 || njobs > kMaxJobs || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    TxqJobs jobs = {};
    jobs.njobs = njobs;
    jobs.lam_full = lam_full;
    int blocks = 0;
    for (int i = 0; i < njobs; ++i) {
        TxqJob& j = jobs.j[i];
        j.cur = (const int*)ptrs[6 * i];
        j.pred = (const int*)ptrs[6 * i + 1];
        j.lvl = (int*)ptrs[6 * i + 2];
        j.rec = (int*)ptrs[6 * i + 3];
        j.d = (int*)ptrs[6 * i + 4];
        j.bits = (int*)ptrs[6 * i + 5];
        const int* v = ints + 7 * i;
        j.n = v[0];
        j.log2 = v[1];
        j.qscale = v[2];
        j.qadd = v[3];
        j.qbits = v[4];
        j.dqscale = v[5];
        j.dqshift = v[6];
        if (j.n < 1 || j.log2 < 2 || j.log2 > 5)
            return (int)cudaErrorInvalidValue;
        j.block0 = blocks;
        const int tus = tus_a_block(j.log2);
        blocks += (j.n + tus - 1) / tus;
    }
    if (bit_depth == 8)
        txq_kernel<8><<<blocks, kTuBlock, 0, (cudaStream_t)stream>>>(jobs);
    else
        txq_kernel<10><<<blocks, kTuBlock, 0, (cudaStream_t)stream>>>(jobs);
    return (int)cudaGetLastError();
}
