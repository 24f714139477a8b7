// The table bit estimate of one residual TU by one warp, shared by the
// kernels that price levels with it (tu_bits.cu, b_txq.cu).
//
// What it computes: `tpuhevc/entropy/bitest.py:286-378`
// (`ResidualBitEst.tu_bits`) as tu_bits.cu's header sets out: the last
// position, the coded-sub-block flags, the significance flags, the
// gt1/gt2 bins, the Golomb-Rice remainders and the signs; with `sbh`, one
// sign bit fewer per CG whose first and last nonzero in-CG scan positions
// lie 4 or more apart (the reference's sbh branch, :367-376). The three
// fractional sums are taken in double (exact in any order: every table
// value is a multiple of 2^-15) and rounded once to float32, then the
// partial sums are added in float32 in the reference's order.
//
// tu_bits_warp is called by all 32 lanes of one warp (lv may lie in
// shared or device memory); the result is valid on lane 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCg = 64;

__device__ __forceinline__ int warp_max(int v) {
    for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_down_sync(0xffffffffu, v, off));
    return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;  // lane 0
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;  // lane 0
}

// lv: the S x S levels; itab / ftab: the estimator's tables
// (entropy/bitest.py `_ioffsets` / `_foffsets`); csbf .. rice: this
// warp's kMaxCg ints each of shared scratch; sbh: price sign-bit hiding.
__device__ float tu_bits_warp(const int* lv, const int* __restrict__ itab,
                              const float* __restrict__ ftab, int log2,
                              int* csbf, int* nsig, int* ngt1, int* gt2,
                              int* rice, bool sbh) {
    const int lane = threadIdx.x & 31;
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    const int cgw = S > 4 ? S >> 2 : 1, ncg = cgw * cgw;
    // integer tables
    const int* scan_pos = itab;
    const int* scan_x = itab + n2;
    const int* scan_y = itab + 2 * n2;
    const int* cg_scan = itab + 3 * n2;
    const int* group_idx = cg_scan + ncg;
    // float tables
    const float* sig = ftab;  // (4, S, S, 2)
    const float* csbf_bits = ftab + 8 * n2;  // (2, 2)
    const float* g1 = csbf_bits + 4;
    const float* g10 = csbf_bits + 6;
    const float* g2 = csbf_bits + 8;
    const float* g20 = csbf_bits + 10;
    const float* lastx = csbf_bits + 12;
    const float* lasty = csbf_bits + 28;

    // pass 1: per-CG statistics, the last position, the hiding CGs
    int last = -1, nhide = 0;
    for (int g = lane; g < ncg; g += 32) {
        const int cy = g / cgw, cx = g - cy * cgw;
        int ns = 0, n1 = 0, any2 = 0, mx = 0, lo = 16, hi = -1;
        for (int i = 0; i < 16; ++i) {
            const int e = (cy * 4 + (i >> 2)) * S + cx * 4 + (i & 3);
            const int a = abs(lv[e]);
            ns += a > 0;
            n1 += a > 1;
            any2 |= a > 2;
            mx = max(mx, a);
            if (a > 0) {
                last = max(last, scan_pos[e]);
                lo = min(lo, scan_pos[e] & 15);
                hi = max(hi, scan_pos[e] & 15);
            }
        }
        nhide += sbh && ns > 0 && hi - lo >= 4;
        csbf[g] = ns > 0;
        nsig[g] = ns;
        ngt1[g] = n1;
        gt2[g] = any2;
        int k = 0;
        for (int j = 1; j <= 4; ++j) k += mx >= (3 << j);
        rice[g] = mx > 6 ? k : 0;
    }
    last = warp_max(last);
    __syncwarp();
    const int lastc = max(last, 0);
    const int last_cg = lastc >> 4;

    // pass 2: CG flags, gt1/gt2 bins, signs
    double csbf_sum = 0.0, b12_sum = 0.0;
    int nsign = 0;
    for (int g = lane; g < ncg; g += 32) {
        const int cy = g / cgw, cx = g - cy * cgw;
        const int right = cx + 1 < cgw ? csbf[g + 1] : 0;
        const int below = cy + 1 < cgw ? csbf[g + cgw] : 0;
        const int cgs = cg_scan[g];
        if (cgs > 0 && cgs < last_cg)
            csbf_sum += (double)csbf_bits[(right | below) * 2 + csbf[g]];
        const bool cg0 = cgs == 0;
        const int bins1 = min(nsig[g], 8);
        const int ones1 = min(ngt1[g], bins1);
        const float b1 = (cg0 ? g10[1] : g1[1]) * (float)ones1
                         + (cg0 ? g10[0] : g1[0]) * (float)(bins1 - ones1);
        const float b2 = ngt1[g] > 0
            ? (cg0 ? (gt2[g] ? g20[1] : g20[0]) : (gt2[g] ? g2[1] : g2[0]))
            : 0.0f;
        b12_sum += (double)(b1 + b2);
        nsign += nsig[g];
    }

    // pass 3: significance flags and remainders
    double sig_sum = 0.0;
    int rice_sum = 0;
    for (int e = lane; e < n2; e += 32) {
        const int y = e >> log2, x = e & mask;
        const int g = (y >> 2) * cgw + (x >> 2);
        const int cy = y >> 2, cx = x >> 2;
        const int a = abs(lv[e]);
        const int cgs = cg_scan[g];
        const bool on = csbf[g] || cgs == 0 || cgs == last_cg;
        if (scan_pos[e] < last && on) {
            const int right = cx + 1 < cgw ? csbf[g + 1] : 0;
            const int below = cy + 1 < cgw ? csbf[g + cgw] : 0;
            const int prev = right + 2 * below;
            sig_sum += (double)sig[((prev * S + y) * S + x) * 2 + (a > 0)];
        }
        const int rem = a - 2;
        if (rem > 0) {
            const int k = rice[g];
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
    rice_sum = warp_sum(rice_sum);
    nsign = warp_sum(nsign) - warp_sum(nhide);
    float bits = lastx[group_idx[scan_x[lastc]]]
                 + lasty[group_idx[scan_y[lastc]]];
    bits = bits + (float)csbf_sum;
    bits = bits + (float)sig_sum;
    bits = bits + (float)b12_sum;
    bits = bits + (float)rice_sum;
    bits = bits + (float)nsign;
    return last >= 0 ? bits : 0.0f;
}

}  // namespace
