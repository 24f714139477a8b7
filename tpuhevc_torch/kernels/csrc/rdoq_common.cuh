// The table RDOQ of one TU, a CG a 16-lane group, shared by the TU
// kernels that quantise with it (intra_txq.cu: rdoq_level_lanes, b_txq.cu:
// rdoq_level_group).
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
// rdoq_level_lanes and rdoq_level_group are called by every lane of a
// warp, for kernels that give a TU a warp or part of one.

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

// The table bits a coefficient's step reads: its significance bits
// (prev CSBF 0) and its CG's gt1 / gt2 bits.
struct RdoqTabs {
    float s0, s1, gt1_0, gt1_1, gt2_0, gt2_1;
};

// The tables of raster position e of an S x S TU (ftab: its float tables).
__device__ __forceinline__ RdoqTabs rdoq_tabs(int e, int log2,
                                              const float* __restrict__ ftab) {
    const int S = 1 << log2;
    const float* sig = ftab;  // sig_bits[0]: (S, S, 2), prev CSBF 0
    const float* csb = ftab + f_csbf(S);
    const int y = e >> log2, x = e & (S - 1);
    const bool cg0 = y < 4 && x < 4;
    return {sig[e * 2], sig[e * 2 + 1], cg0 ? csb[6] : csb[4],
            cg0 ? csb[7] : csb[5], cg0 ? csb[10] : csb[8],
            cg0 ? csb[11] : csb[9]};
}

// The per-coefficient step with tables tb: from ac = |c| * scale, lmax =
// ceil(ac * inv_qdiv) and its CG's Rice stand-in, the cheapest of {lmax,
// lmax - 1, 0} by squared error plus lambda times the table bits; with
// cg_terms (S > 4) also the coefficient's CG-keep cost *kc and CG-zero
// cost *zc. cost(level) is one pure float expression, so each level's
// cost is taken once and the chosen one's reused: the CG-keep cost of
// the chosen level is its cost.
__device__ __forceinline__ float rdoq_best(float ac, float lmax, int rice,
                                           const RdoqTabs& tb, Rdoq rq,
                                           bool cg_terms, float* kc,
                                           float* zc) {
    const float s0 = tb.s0, s1 = tb.s1, gt1_0 = tb.gt1_0, gt1_1 = tb.gt1_1;
    const float gt2_0 = tb.gt2_0, gt2_1 = tb.gt2_1;
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

// The RDOQ with the CGs in lanes: a group of 16 lanes of one warp
// holds one CG, lane i its coefficient i in raster order inside the CG
// (every lane of the warp calls it together, its coefficient c at raster
// position e of an S x S TU; the group's CG is CG-major: 16-lane groups
// in a TU's CG order). The Rice stand-in is the group's largest lmax by
// shuffles (a max: exact in any order); every lane of the group adds the
// group's 16 CG-keep and CG-zero costs, gathered by shuffles, in raster
// order inside the CG, so each takes the keep / zero decision itself.
// Returns the level.
__device__ __forceinline__ float rdoq_lane_best(int c, int log2,
                                                const RdoqTabs& tb, Rdoq rq,
                                                float* kc, float* zc) {
    const float ac = (float)abs(c) * rq.scale;
    const float lmax = ceilf(ac * rq.inv_qdiv);
    float mx = lmax;
#pragma unroll
    for (int off = 8; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    return rdoq_best(ac, lmax, rdoq_rice(mx), tb, rq, log2 > 2, kc, zc);
}

__device__ __forceinline__ int rdoq_level_lanes(int c, int e, int log2,
                                                const float* __restrict__ ftab,
                                                Rdoq rq) {
    float kc = 0.0f, zc = 0.0f;
    float best = rdoq_lane_best(c, log2, rdoq_tabs(e, log2, ftab), rq, &kc,
                                &zc);
    if (log2 > 2) {
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

// The same with the coefficient's tables given (rdoq_tabs, read ahead by
// the caller) and the group's 16 CG-keep and CG-zero costs passed through
// shared memory (kz: 32 floats of the group's own scratch, 16-byte
// aligned; the costs read back 16 bytes a load, each lane of the group
// adding them in the same serial order): no shuffle chain where many
// groups share an SM.
__device__ __forceinline__ int rdoq_level_group(int c, int log2,
                                                const RdoqTabs& tb, Rdoq rq,
                                                float* kz) {
    float kc = 0.0f, zc = 0.0f;
    float best = rdoq_lane_best(c, log2, tb, rq, &kc, &zc);
    if (log2 > 2) {
        const int i = threadIdx.x & 15;
        kz[i] = kc;
        kz[16 + i] = zc;
        __syncwarp();
        float k[16], z[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float4 a = reinterpret_cast<const float4*>(kz)[q];
            const float4 b = reinterpret_cast<const float4*>(kz + 16)[q];
            k[4 * q] = a.x, k[4 * q + 1] = a.y, k[4 * q + 2] = a.z;
            k[4 * q + 3] = a.w;
            z[4 * q] = b.x, z[4 * q + 1] = b.y, z[4 * q + 2] = b.z;
            z[4 * q + 3] = b.w;
        }
        float ck = k[0], cz = z[0];
#pragma unroll
        for (int q = 1; q < 16; ++q) {
            ck = ck + k[q];
            cz = cz + z[q];
        }
        if (!((ck + rq.lc1) <= (cz + rq.lc0))) best = 0.0f;
    }
    return rdoq_level(c, best);
}

}  // namespace
