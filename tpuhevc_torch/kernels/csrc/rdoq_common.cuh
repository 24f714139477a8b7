// The table RDOQ of one TU on shared memory, shared by the TU kernels
// that quantise with it (intra_txq.cu, b_txq.cu).
//
// What it computes: the float32 table RDOQ of tpuhevc/ops/transforms.py:
// 317-422 (`rdoq_est_xp`, jnp branch) as the PyTorch version
// `tpuhevc_torch/ops/transforms.py:rdoq_est` takes it: per coefficient
// the cheapest of {ceil, ceil-1, 0} by squared error plus lambda times
// the table bits, then per 4x4 CG the all-zero trial against the
// coded-sub-block flag. The divisions by constants are products with
// their float32 reciprocals (as XLA takes them), the division by 2^rice
// an IEEE division, no contraction (the including file is built with
// -fmad=false), the CG sums sequential in raster order inside the CG. The
// Rice parameter and the escape length are exact integer formulas.
//
// All threads of the block call rdoq_levels; it ends with the levels in L
// and no trailing barrier.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Rdoq {
    float scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1;
};

// float32 tables of entropy/bitest.py (`_foffsets`)
__device__ __forceinline__ int f_csbf(int S) { return 8 * S * S; }

// A: the S x S coefficients (complete on entry); L: the levels out;
// F1..F4: S x S float scratch; cg_rice, cg_keep: one int per CG (<= 64).
// ftab: the TU size's float tables (entropy/bitest.py `_foffsets`).
__device__ void rdoq_levels(const int* A, int* L, float* F1, float* F2,
                            float* F3, float* F4, int* cg_rice,
                            int* cg_keep, int log2,
                            const float* __restrict__ ftab, Rdoq rq) {
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    const int cgw = S > 4 ? S >> 2 : 1, ncg = cgw * cgw;
    const float* sig = ftab;  // sig_bits[0]: (S, S, 2), prev CSBF 0
    const float* csb = ftab + f_csbf(S);
    const float g1[2] = {csb[4], csb[5]}, g10[2] = {csb[6], csb[7]};
    const float g2[2] = {csb[8], csb[9]}, g20[2] = {csb[10], csb[11]};
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const float ac = (float)abs(A[e]) * rq.scale;
        F1[e] = ac;
        F2[e] = ceilf(ac * rq.inv_qdiv);
    }
    __syncthreads();
    // per-CG Rice stand-in: largest k <= 4 with 3 * 2^k <= cg_max,
    // 0 unless cg_max > 6
    for (int g = threadIdx.x; g < ncg; g += blockDim.x) {
        const int cy = g / cgw, cx = g - cy * cgw;
        float mx = F2[(cy * 4) * S + cx * 4];
        for (int i = 1; i < 16; ++i)
            mx = fmaxf(mx, F2[(cy * 4 + (i >> 2)) * S + cx * 4 + (i & 3)]);
        int k = 0;
        for (int j = 1; j <= 4; ++j) k += mx >= (float)(3 << j);
        cg_rice[g] = mx > 6.0f ? k : 0;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, x = e & mask;
        const int g = (y >> 2) * cgw + (x >> 2);
        const bool cg0 = y < 4 && x < 4;
        const float s0 = sig[e * 2], s1 = sig[e * 2 + 1];
        const float gt1_0 = cg0 ? g10[0] : g1[0];
        const float gt1_1 = cg0 ? g10[1] : g1[1];
        const float gt2_0 = cg0 ? g20[0] : g2[0];
        const float gt2_1 = cg0 ? g20[1] : g2[1];
        const int rice = cg_rice[g];
        const float ricef = (float)(1 << rice), rice_f = (float)rice;
        const float ac = F1[e];
        auto lvl_bits = [&](float level) {
            const float rem = fmaxf(level - 3.0f, 0.0f);
            const float three = 3.0f * ricef;
            float rl;
            if (rem < three) {
                rl = (floorf(rem / ricef) + 1.0f) + rice_f;
            } else {
                const int q = (int)(rem - three);
                const int ext = 31 - __clz((q >> rice) + 1);
                rl = (4.0f + rice_f) + 2.0f * (float)ext;
            }
            const float inner = level > 2.0f ? (gt2_1 - gt2_0) + rl : 0.0f;
            const float outer =
                level > 1.0f ? ((gt1_1 - gt1_0) + gt2_0) + inner : 0.0f;
            return ((s1 + 1.0f) + gt1_0) + outer;
        };
        auto cost = [&](float level) {
            const float d = (ac - level * rq.qdiv) * rq.inv_den;
            const float bits = level > 0.0f ? lvl_bits(level) : s0;
            return d * d + rq.lam * bits;
        };
        const float lmax = F2[e];
        const float l1 = fmaxf(lmax, 0.0f), l2 = fmaxf(lmax - 1.0f, 0.0f);
        float best = cost(l1) <= cost(l2) ? l1 : l2;
        best = cost(best) <= cost(0.0f) ? best : 0.0f;
        F2[e] = best;
        if (S > 4) {
            const float dz = (ac - best * rq.qdiv) * rq.inv_den;
            const float kb = best > 0.0f ? lvl_bits(best) : s0;
            F3[e] = dz * dz + rq.lam * kb;
            const float acn = ac * rq.inv_den;
            F4[e] = acn * acn;
        }
    }
    __syncthreads();
    if (S > 4) {
        for (int g = threadIdx.x; g < ncg; g += blockDim.x) {
            const int cy = g / cgw, cx = g - cy * cgw;
            const int base = (cy * 4) * S + cx * 4;
            float ck = F3[base], cz = F4[base];
            for (int i = 1; i < 16; ++i) {
                const int e = base + (i >> 2) * S + (i & 3);
                ck = ck + F3[e];
                cz = cz + F4[e];
            }
            cg_keep[g] = (ck + rq.lc1) <= (cz + rq.lc0);
        }
        __syncthreads();
    }
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, x = e & mask;
        const bool keep = S == 4 || cg_keep[(y >> 2) * cgw + (x >> 2)];
        const float best = keep ? F2[e] : 0.0f;
        const int c = A[e];
        const float sgn = c > 0 ? 1.0f : (c < 0 ? -1.0f : 0.0f);
        L[e] = (int)fminf(fmaxf(sgn * best, -32767.0f), 32767.0f);
    }
}

}  // namespace
