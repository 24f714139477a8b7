// The table bit estimate of one residual TU by a team of lanes, shared by
// the kernels that price levels with it (tu_bits.cu, b_txq.cu).
//
// What it computes: tu_bits.cu's estimate (`tpuhevc/entropy/bitest.py:
// 286-378`; sbh off, or on in tu_bits_lanes<S, true>: one sign fewer for
// each CG whose first and last nonzero lie 4 or more apart in its scan),
// as that file's header sets out: the csbf, sig and
// gt1/gt2 sums as int32 in units of 2^-15 (exact in any order), each
// rounded once to float32, then the partial sums added in float32 in the
// reference's order; the Rice and sign counts in int32.
//
// Layout: a team of S^2 / 4 lanes a TU (BitsTeam<S>), lane t_in one
// 16-byte vector of 4 levels of one CG row, the four rows of a CG in
// adjacent lanes (lane 4 cg + row), so a CG's counts and maximum take two
// xor-shuffles and the coded-sub-block flags of the TU come from one
// ballot (through shared memory where a team spans several warps) as a
// bitmap in which each CG finds its right and lower neighbours. What a
// lane needs of its position and of the tables, the same for every TU, is
// read once (bits_lane); tu_bits_lanes then prices one TU, and every lane
// of the team gets the result.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float kUnit = 1.0f / 32768.0f;  // 2^-15

// lanes a TU, the team's lanes inside one warp, its warps
template <int S> struct BitsTeam {
    static constexpr int kLanes = S * S / 4;
    static constexpr int kWarpLanes = kLanes < 32 ? kLanes : 32;
    static constexpr int kWarps = kLanes > 32 ? kLanes / 32 : 1;
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

template <int W> __device__ __forceinline__ int lane_sum(int v) {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// A lane's position in its TU and its part of the tables.
template <int S> struct BitsLane {
    int t_in, wt, tbase;  // lane in the team, the team's warp, its first
                          // lane in the warp
    int cg, cx, cy, e0, yx, cgs;  // CG, the vector's first level, y << 5 | x
    int s[4];                     // the vector's scan positions
    int small;                    // csbf, gt1, gt2 bits (lanes 0-11)
    float lbx, lby;               // last-position bits at x = y = lane
};

// The first level of lane t_in's vector (row t_in & 3 of CG t_in >> 2).
template <int S>
__device__ __forceinline__ int bits_e0(int t_in) {
    constexpr int CGW = S / 4;
    const int cg = t_in >> 2;
    return ((cg / CGW) * 4 + (t_in & 3)) * S + (cg % CGW) * 4;
}

// The lane t_in of a team (every lane of the warp calls it).
template <int S>
__device__ __forceinline__ BitsLane<S> bits_lane(
    int t_in, const int* __restrict__ itab, const float* __restrict__ ftab) {
    using TM = BitsTeam<S>;
    constexpr int N2 = S * S, CGW = S / 4, TW = TM::kWarpLanes;
    const float* csbf_bits = ftab + 8 * N2;  // (2, 2), then gt1, gt1 of
    const float* last_bits = csbf_bits + 12;  // CG 0, gt2, gt2 of CG 0
    const int* group_idx = itab + 3 * N2 + CGW * CGW;
    const int lane = threadIdx.x & 31;
    BitsLane<S> L;
    L.t_in = t_in;
    L.wt = t_in >> 5;
    L.tbase = lane & ~(TW - 1);
    L.cg = t_in >> 2;
    L.cx = L.cg % CGW;
    L.cy = L.cg / CGW;
    L.e0 = bits_e0<S>(t_in);
    L.yx = ((L.e0 / S) << 5) | (L.e0 % S);
    const int4 sp = __ldg(reinterpret_cast<const int4*>(itab + L.e0));
    L.s[0] = sp.x;
    L.s[1] = sp.y;
    L.s[2] = sp.z;
    L.s[3] = sp.w;
    L.cgs = sp.x >> 4;  // the CG's scan index
    // the tables' small parts, a value a lane, read back by shuffles: the
    // last-position bits lastx[group(x)] and lasty[group(y)] of x = y =
    // lane; lanes 0-11 csbf (2, 2), gt1, gt1 of CG 0, gt2, gt2 of CG 0 in
    // units of 2^-15
    const int gl = __ldg(group_idx + lane);
    L.lbx = __ldg(last_bits + gl);
    L.lby = __ldg(last_bits + 16 + gl);
    L.small = lane < 12 ? fix(__ldg(csbf_bits + lane)) : 0;
    return L;
}

// The bits of the TU whose levels at L.e0 are lv; 0 for an all-zero TU.
// Every lane of the warp calls it; with a team over several warps every
// thread of the block (a barrier inside), s_map, s_key and s_acc the
// team's kWarps entries of shared scratch (unread otherwise). Every lane
// of the team gets the result.
template <int S, bool SBH = false>
__device__ __forceinline__ float tu_bits_lanes(const BitsLane<S>& L, int4 lv,
                                               const float* __restrict__ ftab,
                                               unsigned* s_map, int* s_key,
                                               int (*s_acc)[5]) {
    using TM = BitsTeam<S>;
    constexpr unsigned kAll = 0xffffffffu;
    constexpr int N2 = S * S, CGW = S / 4;
    constexpr int TW = TM::kWarpLanes, WPT = TM::kWarps;
    constexpr unsigned TMASK = TW == 32 ? kAll : (1u << TW) - 1;
    const int lane = threadIdx.x & 31;
    const int a[4] = {abs(lv.x), abs(lv.y), abs(lv.z), abs(lv.w)};

    // pass 1: a CG's counts (|l| > 0 low byte, > 1 next) and maximum by
    // two xor-shuffles; the CG flags by ballot; the last position's key
    int c = 0, mx = 0, key = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        c += (a[k] > 0) + ((a[k] > 1) << 8);
        mx = max(mx, a[k]);
        if (a[k] > 0) key = max(key, (L.s[k] << 10) | (L.yx + k));
    }
    int nsign = c & 0xff;
    // with SBH: the CG's first and last nonzero in-CG scan positions
    int pmin = 16, pmax = -1;
    if constexpr (SBH) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (a[k] > 0) {
                pmin = min(pmin, L.s[k] & 15);
                pmax = max(pmax, L.s[k] & 15);
            }
        }
        pmin = min(pmin, __shfl_xor_sync(kAll, pmin, 1));
        pmin = min(pmin, __shfl_xor_sync(kAll, pmin, 2));
        pmax = max(pmax, __shfl_xor_sync(kAll, pmax, 1));
        pmax = max(pmax, __shfl_xor_sync(kAll, pmax, 2));
    }
    c += __shfl_xor_sync(kAll, c, 1);
    c += __shfl_xor_sync(kAll, c, 2);
    mx = max(mx, __shfl_xor_sync(kAll, mx, 1));
    mx = max(mx, __shfl_xor_sync(kAll, mx, 2));
    unsigned long long map =
        cg_bits((__ballot_sync(kAll, (c & 0xff) > 0) >> L.tbase) & TMASK);
#pragma unroll
    for (int off = TW / 2; off > 0; off >>= 1)
        key = max(key, __shfl_xor_sync(kAll, key, off));
    if (WPT > 1) {  // warp wt holds CGs 8 wt .. 8 wt + 7
        if (lane == 0) {
            s_map[L.wt] = (unsigned)map;
            s_key[L.wt] = key;
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
    const int cs = (int)(map >> L.cg) & 1;
    const int right = L.cx + 1 < CGW ? (int)(map >> (L.cg + 1)) & 1 : 0;
    const int below = L.cy + 1 < CGW ? (int)(map >> (L.cg + CGW)) & 1 : 0;
    const float4* st = reinterpret_cast<const float4*>(
        ftab + ((right + 2 * below) * N2 + L.e0) * 2);
    const float4 s01 = __ldg(st), s23 = __ldg(st + 1);
    const float sv[8] = {s01.x, s01.y, s01.z, s01.w,
                         s23.x, s23.y, s23.z, s23.w};
    const bool on = cs || L.cgs == 0 || L.cgs == last_cg;
    int kr = 0;
#pragma unroll
    for (int i = 1; i <= 4; ++i) kr += mx >= (3 << i);
    kr = mx > 6 ? kr : 0;
    const int three = 3 << kr;
    int csbf = 0, sig = 0, b12 = 0, rice = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (on && L.s[k] < last)
            sig += fix(a[k] > 0 ? sv[2 * k + 1] : sv[2 * k]);
        const int rem = a[k] - 2;
        if (rem > 0)
            rice += rem < three
                ? (rem >> kr) + 1 + kr
                : 4 + 2 * (31 - __clz(((rem - three) >> kr) + 1)) + kr;
    }
    // the CG's terms from its row-0 lane (every lane shuffles)
    const int g1 = L.cgs == 0 ? 6 : 4;
    const int c_csbf = __shfl_sync(kAll, L.small, (right | below) * 2 + cs);
    const int c_g10 = __shfl_sync(kAll, L.small, g1);
    const int c_g11 = __shfl_sync(kAll, L.small, g1 + 1);
    const int c_g2 = __shfl_sync(kAll, L.small, g1 + 4 + (mx > 2));
    if ((L.t_in & 3) == 0) {
        const int ns = c & 0xff, n1 = c >> 8;
        if (L.cgs > 0 && L.cgs < last_cg) csbf = c_csbf;
        const int bins1 = min(ns, 8), ones1 = min(n1, bins1);
        b12 = c_g11 * ones1 + c_g10 * (bins1 - ones1) + (n1 > 0 ? c_g2 : 0);
        if (SBH && ns > 0 && pmax - pmin >= 4) nsign -= 1;  // a hidden sign
    }
    csbf = lane_sum<TW>(csbf);
    sig = lane_sum<TW>(sig);
    b12 = lane_sum<TW>(b12);
    rice = lane_sum<TW>(rice);
    nsign = lane_sum<TW>(nsign);
    if (WPT > 1) {  // each warp's sums, added by every lane (integers:
                    // exact in any order)
        if (lane == 0) {
            s_acc[L.wt][0] = csbf;
            s_acc[L.wt][1] = sig;
            s_acc[L.wt][2] = b12;
            s_acc[L.wt][3] = rice;
            s_acc[L.wt][4] = nsign;
        }
        __syncthreads();
        csbf = sig = b12 = rice = nsign = 0;
#pragma unroll
        for (int w = 0; w < WPT; ++w) {
            csbf += s_acc[w][0];
            sig += s_acc[w][1];
            b12 += s_acc[w][2];
            rice += s_acc[w][3];
            nsign += s_acc[w][4];
        }
    }
    const float lx = __shfl_sync(kAll, L.lbx, key & 31);
    const float ly = __shfl_sync(kAll, L.lby, (key >> 5) & 31);
    float bits = lx + ly;
    bits = bits + __int2float_rn(csbf) * kUnit;
    bits = bits + __int2float_rn(sig) * kUnit;
    bits = bits + __int2float_rn(b12) * kUnit;
    bits = bits + (float)rice;
    bits = bits + (float)nsign;
    return last >= 0 ? bits : 0.0f;
}

}  // namespace
