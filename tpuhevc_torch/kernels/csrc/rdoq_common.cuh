// The table RDOQ of one TU, shared by the TU kernels that quantise with
// it: a block's threads on shared memory (rdoq_levels, b_txq.cu) or a
// CG a 16-lane group (rdoq_level_lanes, intra_txq.cu).
//
// What it computes: the float32 table RDOQ of tpuhevc/ops/transforms.py:
// 317-422 (`rdoq_est_xp`, jnp branch) as the PyTorch version
// `tpuhevc_torch/ops/transforms.py:rdoq_est` takes it: per coefficient
// the cheapest of {ceil, ceil-1, 0} by squared error plus lambda times
// the table bits, then per 4x4 CG the all-zero trial against the
// coded-sub-block flag. The divisions by constants are products with
// their float32 reciprocals (as XLA takes them), the division by 2^rice
// a product with 2^-rice (exact, as the IEEE division is), no
// contraction (the including file is built with
// -fmad=false), the CG sums sequential in raster order inside the CG. The
// Rice parameter and the escape length are exact integer formulas.
//
// All threads of the block call rdoq_levels; it ends with the levels in L
// and no trailing barrier. rdoq_level_lanes is the same RDOQ a CG of 16
// lanes, for kernels that give a TU a warp or part of one.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Rdoq {
    float scale, qdiv, inv_qdiv, inv_den, lam, lc0, lc1;
};

// float32 tables of entropy/bitest.py (`_foffsets`)
__device__ __forceinline__ int f_csbf(int S) { return 8 * S * S; }

// The CG's Rice stand-in from the largest lmax in it: the largest k <= 4
// with 3 * 2^k <= max, 0 unless max > 6.
__device__ __forceinline__ int rdoq_rice(float mx) {
    int k = 0;
    for (int j = 1; j <= 4; ++j) k += mx >= (float)(3 << j);
    return mx > 6.0f ? k : 0;
}

// The per-coefficient step at raster position e of an S x S TU: from ac
// = |c| * scale, lmax = ceil(ac * inv_qdiv) and its CG's Rice stand-in,
// the cheapest of {lmax, lmax - 1, 0} by squared error plus lambda times
// the table bits; with cg_terms (S > 4) also the coefficient's CG-keep
// cost *kc and CG-zero cost *zc. cost(level) is one pure float
// expression, so each level's cost is taken once and the chosen one's
// reused: the CG-keep cost of the chosen level is its cost.
__device__ __forceinline__ float rdoq_best(float ac, float lmax, int rice,
                                           int e, int log2,
                                           const float* __restrict__ ftab,
                                           Rdoq rq, bool cg_terms, float* kc,
                                           float* zc) {
    const int S = 1 << log2;
    const float* sig = ftab;  // sig_bits[0]: (S, S, 2), prev CSBF 0
    const float* csb = ftab + f_csbf(S);
    const int y = e >> log2, x = e & (S - 1);
    const bool cg0 = y < 4 && x < 4;
    const float s0 = sig[e * 2], s1 = sig[e * 2 + 1];
    const float gt1_0 = cg0 ? csb[6] : csb[4];
    const float gt1_1 = cg0 ? csb[7] : csb[5];
    const float gt2_0 = cg0 ? csb[10] : csb[8];
    const float gt2_1 = cg0 ? csb[11] : csb[9];
    // rem / 2^rice, exact as a product with 2^-rice
    const float inv_rice = __int_as_float((127 - rice) << 23);
    const float ricef = (float)(1 << rice), rice_f = (float)rice;
    auto lvl_bits = [&](float level) {
        const float rem = fmaxf(level - 3.0f, 0.0f);
        const float three = 3.0f * ricef;
        float rl;
        if (rem < three) {
            rl = (floorf(rem * inv_rice) + 1.0f) + rice_f;
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
    const float l1 = fmaxf(lmax, 0.0f), l2 = fmaxf(lmax - 1.0f, 0.0f);
    const float c1 = cost(l1), c2 = cost(l2), c0 = cost(0.0f);
    const bool one = c1 <= c2;
    const float cb = one ? c1 : c2;
    const bool keep = cb <= c0;
    if (cg_terms) {
        *kc = keep ? cb : c0;
        const float acn = ac * rq.inv_den;
        *zc = acn * acn;
    }
    return keep ? (one ? l1 : l2) : 0.0f;
}

// The level of a coefficient c from its chosen magnitude, clipped to
// +-32767.
__device__ __forceinline__ int rdoq_level(int c, float best) {
    const float sgn = c > 0 ? 1.0f : (c < 0 ? -1.0f : 0.0f);
    return (int)fminf(fmaxf(sgn * best, -32767.0f), 32767.0f);
}

// A: the S x S coefficients (complete on entry); L: the levels out;
// F1..F4: S x S float scratch; cg_rice, cg_keep: one int per CG (<= 64).
// ftab: the TU size's float tables (entropy/bitest.py `_foffsets`).
// All threads of the block call it, one coefficient or CG a thread.
__device__ void rdoq_levels(const int* A, int* L, float* F1, float* F2,
                            float* F3, float* F4, int* cg_rice,
                            int* cg_keep, int log2,
                            const float* __restrict__ ftab, Rdoq rq) {
    const int S = 1 << log2, n2 = S * S, mask = S - 1;
    const int cgw = S > 4 ? S >> 2 : 1, ncg = cgw * cgw;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const float ac = (float)abs(A[e]) * rq.scale;
        F1[e] = ac;
        F2[e] = ceilf(ac * rq.inv_qdiv);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < ncg; g += blockDim.x) {
        const int cy = g / cgw, cx = g - cy * cgw;
        float mx = F2[(cy * 4) * S + cx * 4];
        for (int i = 1; i < 16; ++i)
            mx = fmaxf(mx, F2[(cy * 4 + (i >> 2)) * S + cx * 4 + (i & 3)]);
        cg_rice[g] = rdoq_rice(mx);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int y = e >> log2, x = e & mask;
        const int g = (y >> 2) * cgw + (x >> 2);
        F2[e] = rdoq_best(F1[e], F2[e], cg_rice[g], e, log2, ftab, rq, S > 4,
                          F3 + e, F4 + e);
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
        L[e] = rdoq_level(A[e], keep ? F2[e] : 0.0f);
    }
}

// The same RDOQ with the CGs in lanes: a group of 16 lanes of one warp
// holds one CG, lane i its coefficient i in raster order inside the CG
// (every lane of the warp calls it together, its coefficient c at raster
// position e of an S x S TU; the group's CG is CG-major: 16-lane groups
// in a TU's CG order). The Rice stand-in is the group's largest lmax by
// shuffles (a max: exact in any order); every lane of the group adds the
// group's 16 CG-keep and CG-zero costs, gathered by shuffles, in raster
// order inside the CG, so each takes the keep / zero decision itself.
// Returns the level.
__device__ __forceinline__ int rdoq_level_lanes(int c, int e, int log2,
                                                const float* __restrict__ ftab,
                                                Rdoq rq) {
    const int S = 1 << log2;
    const float ac = (float)abs(c) * rq.scale;
    const float lmax = ceilf(ac * rq.inv_qdiv);
    float mx = lmax;
#pragma unroll
    for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float kc = 0.0f, zc = 0.0f;
    float best = rdoq_best(ac, lmax, rdoq_rice(mx), e, log2, ftab, rq, S > 4,
                           &kc, &zc);
    if (S > 4) {
        const int g0 = threadIdx.x & 16;  // the group's first lane
        float ck = __shfl_sync(0xffffffffu, kc, g0);
        float cz = __shfl_sync(0xffffffffu, zc, g0);
#pragma unroll
        for (int i = 1; i < 16; ++i) {
            ck = ck + __shfl_sync(0xffffffffu, kc, g0 + i);
            cz = cz + __shfl_sync(0xffffffffu, zc, g0 + i);
        }
        if (!((ck + rq.lc1) <= (cz + rq.lc0))) best = 0.0f;
    }
    return rdoq_level(c, best);
}

}  // namespace
