// tu_bits: the table bit estimate of residual TUs.
//
// Replaces: tpuhevc/entropy/bitest.py:286-378 (`ResidualBitEst.tu_bits`,
// sbh off: the intra decision prices no sign-bit hiding) and :398-408
// (`_rice_bits_xp`), jnp code that XLA compiled for the TPU inside the
// intra decision.
//
// What it computes, per TU of levels (S x S, S = 1 << log2 in 4..32):
//   last = the largest diagonal-scan position of a nonzero level;
//   bits = lastx[group(x_last)] + lasty[group(y_last)]
//        + sum over CGs 0 < cg_scan < last_cg of csbf_bits[right|below][csbf]
//        + sum over coded positions (scan < last, CG coded or first/last)
//              of sig_bits[right + 2 below][y][x][nz]
//        + per CG: gt1 bins (at most 8, CG0 or later context set) and the
//              gt2 bin, by the counts of |l| > 0, > 1, > 2
//        + the Golomb-Rice length of every |l| - 2 > 0, Rice parameter
//              from the CG max (largest k <= 4 with 3 * 2^k <= max, 0 unless
//              max > 6), the escape's floor(log2) by count-leading-zeros
//        + one sign bit per nonzero level;  0 for an all-zero TU.
// Sums: every table value the sums take is one ENTROPY_BITS entry, a
// multiple of 2^-15 (entropy/bitest.py checks at import that S^2 = 1024 of
// the largest stay below 2^31 units), so each is taken as an integer in
// units of 2^-15 as it is read, and the csbf, sig and gt1/gt2 sums as
// int32: exact in any order, each rounded once to float32 (the float value
// of the exact sum, as the PyTorch version's double sums rounded once),
// then the partial sums added in float32 in the reference's order; the
// Rice and sign counts in int32. So the result equals the PyTorch version
// bit for bit.
//
// What bounds it: one read of the S^2 int32 levels a TU; a few dozen
// integer operations a level. Latency-bound at the decision's sizes (the
// whole IDR reads ~2 MB a pass).
// Design: the TU size is compiled in. A lane owns one 16-byte vector of 4
// levels of one CG row, loaded once with an int4 load, the four rows of a
// CG in adjacent lanes (lane 4 cg + row), so a CG's counts and maximum
// take two xor-shuffles, and the coded-sub-block flags of the whole TU
// come from one ballot (through shared memory where a TU spans several
// warps) as a bitmap in which each CG finds its right and lower
// neighbours. A team of S^2 / 4 lanes works a TU: 4 lanes at S = 4 (8 TUs
// a warp), 16 at S = 8; at S = 16 and 32 a block of 64 or 256 lanes,
// whose warps meet once in shared memory for the CG flags and the key and
// once for the sums (a warp a TU with 2 or 8 vectors a lane was slower at
// both sizes: PERF.md row 17). A CG's own terms are added by its row-0
// lane. The last position, with its x and y, is one 32-bit key ((scan <<
// 10) | (y << 5) | x) reduced by the team's maximum. A lane's scan
// positions sit in registers for the block's whole grid-stride loop. The
// tables, the same for every TU, are read through the L1 cache: a lane's
// significance bits (its four positions, both bin values) are two 16-byte
// loads at its CG's neighbour pattern, and the small tables (last-position
// bits by x and y, csbf, gt1, gt2) sit a value a lane and are read back by
// shuffles. (Staging the tables once a block in shared memory, 8 KB at
// S = 16 and 32 KB at S = 32, cost more than the TUs' own reads; so did
// loading a lane's significance bits at all four neighbour patterns before
// its levels.)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kUnit = 1.0f / 32768.0f;  // 2^-15

// lanes a TU, threads a block, TUs a block and round
template <int S> struct Team {
    static constexpr int kLanes = S * S / 4;
    static constexpr int kThreads = kLanes > 32 ? kLanes : 256;
    static constexpr int kTus = kThreads / kLanes;
    static constexpr int kWarpLanes = kLanes < 32 ? kLanes : 32;
    static constexpr int kWarps = kLanes > 32 ? kLanes / 32 : 1;  // a TU
};

__device__ __forceinline__ int fix(float v) { return __float2int_rn(v * 32768.0f); }

// bit 4i of b -> bit i (i < 8): the CG flags of a ballot in which the four
// rows of a CG sit in adjacent lanes
__device__ __forceinline__ unsigned cg_bits(unsigned b) {
    b &= 0x11111111u;
    b = (b | (b >> 3)) & 0x03030303u;
    b = (b | (b >> 6)) & 0x000f000fu;
    return (b | (b >> 12)) & 0xffu;
}

template <int W> __device__ __forceinline__ int team_sum(int v) {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

template <int S>
__global__ void __launch_bounds__(Team<S>::kThreads)
tu_bits_teams(const int* __restrict__ tiles, const int* __restrict__ itab,
              const float* __restrict__ ftab, float* __restrict__ out, int n) {
    using TM = Team<S>;
    constexpr int N2 = S * S, CGW = S / 4;
    constexpr int T = TM::kLanes, TW = TM::kWarpLanes, TPB = TM::kTus;
    constexpr int WPT = TM::kWarps;
    constexpr unsigned TMASK = TW == 32 ? kFull : (1u << TW) - 1;
    const float* csbf_bits = ftab + 8 * N2;  // (2, 2), then gt1, gt1 of
    const float* last_bits = csbf_bits + 12;  // CG 0, gt2, gt2 of CG 0
    const int* group_idx = itab + 3 * N2 + CGW * CGW;
    // a TU over several warps: each warp's CG flags, key and sums
    __shared__ unsigned s_map[WPT];
    __shared__ int s_key[WPT];
    __shared__ int s_acc[WPT][5];

    // this lane's vector: lane t_in is row t_in & 3 of CG t_in >> 2
    const int tid = threadIdx.x, lane = tid & 31;
    const int t_in = tid % T, team = tid / T, wt = t_in >> 5;
    const int tbase = lane & ~(TW - 1);  // the team's first lane in the warp
    const int cg = t_in >> 2, cx = cg % CGW, cy = cg / CGW;
    const int e0 = (cy * 4 + (t_in & 3)) * S + cx * 4;
    const int yx = ((e0 / S) << 5) | (e0 % S);
    const int4 sp = __ldg(reinterpret_cast<const int4*>(itab + e0));  // scan positions
    const int s[4] = {sp.x, sp.y, sp.z, sp.w};
    const int cgs = sp.x >> 4;  // the CG's scan index
    // the tables' small parts, a value a lane, read back by shuffles: the
    // last-position bits lastx[group(x)] and lasty[group(y)] of x = y =
    // lane; lanes 0-11 csbf (2, 2), gt1, gt1 of CG 0, gt2, gt2 of CG 0 in
    // units of 2^-15
    const int gl = __ldg(group_idx + lane);
    const float lbx = __ldg(last_bits + gl), lby = __ldg(last_bits + 16 + gl);
    const int small = lane < 12 ? fix(__ldg(csbf_bits + lane)) : 0;

    for (int t0 = blockIdx.x * TPB; t0 < n; t0 += gridDim.x * TPB) {
        const int tu = t0 + team;
        const bool live = tu < n;
        const int4 lv = live ? __ldg(reinterpret_cast<const int4*>(tiles + (size_t)tu * N2) +
                                     (e0 >> 2))
                             : make_int4(0, 0, 0, 0);
        const int a[4] = {abs(lv.x), abs(lv.y), abs(lv.z), abs(lv.w)};

        // pass 1: a CG's counts (|l| > 0 low byte, > 1 next) and maximum by
        // two xor-shuffles; the CG flags by ballot; the last position's key
        int c = 0, mx = 0, key = -1;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            c += (a[k] > 0) + ((a[k] > 1) << 8);
            mx = max(mx, a[k]);
            if (a[k] > 0) key = max(key, (s[k] << 10) | (yx + k));
        }
        int nsign = c & 0xff;
        c += __shfl_xor_sync(kFull, c, 1);
        c += __shfl_xor_sync(kFull, c, 2);
        mx = max(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = max(mx, __shfl_xor_sync(kFull, mx, 2));
        unsigned long long map =
            cg_bits((__ballot_sync(kFull, (c & 0xff) > 0) >> tbase) & TMASK);
#pragma unroll
        for (int off = TW / 2; off > 0; off >>= 1)
            key = max(key, __shfl_xor_sync(kFull, key, off));
        if (WPT > 1) {  // warp wt holds CGs 8 wt .. 8 wt + 7
            if (lane == 0) {
                s_map[wt] = (unsigned)map;
                s_key[wt] = key;
            }
            __syncthreads();
            map = 0;
#pragma unroll
            for (int w = 0; w < WPT; ++w) {
                map |= (unsigned long long)s_map[w] << (8 * w);
                key = max(key, s_key[w]);
            }
        }
        const int last = key >= 0 ? key >> 10 : -1;
        const int last_cg = max(last, 0) >> 4;

        // pass 2: the CG's flag terms (its row-0 lane), the significance
        // flags (the lane's 4 positions' bits, both bin values, in two
        // 16-byte loads of the table at the CG's neighbour pattern) and the
        // remainders
        const int cs = (int)(map >> cg) & 1;
        const int right = cx + 1 < CGW ? (int)(map >> (cg + 1)) & 1 : 0;
        const int below = cy + 1 < CGW ? (int)(map >> (cg + CGW)) & 1 : 0;
        const float4* st =
            reinterpret_cast<const float4*>(ftab + ((right + 2 * below) * N2 + e0) * 2);
        const float4 s01 = __ldg(st), s23 = __ldg(st + 1);
        const float sv[8] = {s01.x, s01.y, s01.z, s01.w, s23.x, s23.y, s23.z, s23.w};
        const bool on = cs || cgs == 0 || cgs == last_cg;
        int kr = 0;
#pragma unroll
        for (int i = 1; i <= 4; ++i) kr += mx >= (3 << i);
        kr = mx > 6 ? kr : 0;
        const int three = 3 << kr;
        int csbf = 0, sig = 0, b12 = 0, rice = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (on && s[k] < last) sig += fix(a[k] > 0 ? sv[2 * k + 1] : sv[2 * k]);
            const int rem = a[k] - 2;
            if (rem > 0)
                rice += rem < three ? (rem >> kr) + 1 + kr
                                    : 4 + 2 * (31 - __clz(((rem - three) >> kr) + 1)) + kr;
        }
        // the CG's terms from its row-0 lane (every lane shuffles)
        const int g1 = cgs == 0 ? 6 : 4;
        const int c_csbf = __shfl_sync(kFull, small, (right | below) * 2 + cs);
        const int c_g10 = __shfl_sync(kFull, small, g1);
        const int c_g11 = __shfl_sync(kFull, small, g1 + 1);
        const int c_g2 = __shfl_sync(kFull, small, g1 + 4 + (mx > 2));
        if ((t_in & 3) == 0) {
            const int ns = c & 0xff, n1 = c >> 8;
            if (cgs > 0 && cgs < last_cg) csbf = c_csbf;
            const int bins1 = min(ns, 8), ones1 = min(n1, bins1);
            b12 = c_g11 * ones1 + c_g10 * (bins1 - ones1) + (n1 > 0 ? c_g2 : 0);
        }
        csbf = team_sum<TW>(csbf);
        sig = team_sum<TW>(sig);
        b12 = team_sum<TW>(b12);
        rice = team_sum<TW>(rice);
        nsign = team_sum<TW>(nsign);
        if (WPT > 1) {
            if (lane == 0) {
                s_acc[wt][0] = csbf;
                s_acc[wt][1] = sig;
                s_acc[wt][2] = b12;
                s_acc[wt][3] = rice;
                s_acc[wt][4] = nsign;
            }
            __syncthreads();
            if (t_in == 0) {
                for (int w = 1; w < WPT; ++w) {
                    csbf += s_acc[w][0];
                    sig += s_acc[w][1];
                    b12 += s_acc[w][2];
                    rice += s_acc[w][3];
                    nsign += s_acc[w][4];
                }
            }
        }
        const float lx = __shfl_sync(kFull, lbx, key & 31);
        const float ly = __shfl_sync(kFull, lby, (key >> 5) & 31);
        if (t_in == 0 && live) {
            float bits = lx + ly;
            bits = bits + __int2float_rn(csbf) * kUnit;
            bits = bits + __int2float_rn(sig) * kUnit;
            bits = bits + __int2float_rn(b12) * kUnit;
            bits = bits + (float)rice;
            bits = bits + (float)nsign;
            out[tu] = last >= 0 ? bits : 0.0f;
        }
    }
}

template <int S>
int launch(const int* tiles, const int* itab, const float* ftab, float* out,
           int n, int sms, cudaStream_t stream) {
    using TM = Team<S>;
    // enough blocks to fill the card; more TUs loop, so that a lane's scan
    // positions serve several rounds
    const int per_sm = TM::kThreads >= 64 ? 2048 / TM::kThreads : 32;
    const int want = (n + TM::kTus - 1) / TM::kTus;
    const int grid = want < sms * per_sm ? want : sms * per_sm;
    tu_bits_teams<S><<<grid, TM::kThreads, 0, stream>>>(tiles, itab, ftab, out, n);
    return (int)cudaGetLastError();
}

}  // namespace

// tiles (n, S, S) int32 levels on the device, 16-byte aligned, S = 1 <<
// log2 in 4..32, n >= 1; itab / ftab: the estimator's tables
// (entropy/bitest.py EstTables, packed at `_ioffsets` / `_foffsets`);
// sms: the card's multiprocessors -> out (n,) float32 bits.
extern "C" int tpuhevc_tu_bits(const int* tiles, const int* itab,
                               const float* ftab, float* out, int n,
                               int log2, int sms, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log2) {
        case 2: return launch<4>(tiles, itab, ftab, out, n, sms, s);
        case 3: return launch<8>(tiles, itab, ftab, out, n, sms, s);
        case 4: return launch<16>(tiles, itab, ftab, out, n, sms, s);
        case 5: return launch<32>(tiles, itab, ftab, out, n, sms, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
