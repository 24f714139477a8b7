// The HEVC intra predictor of one sample, shared by the intra kernels
// (intra_bank.cu, intra_wave.cu).
//
// What it computes, from a block's top/left reference arrays t, l (2S+1
// samples each, corner at index 0), S = 1 << log2, for mode 0..34 the
// prediction [r][c]:
//   refs: for luma with S >= 8, modes whose filter flag is set read the
//     [1 2 1]-smoothed arrays (corner from l[1], t[0], t[1]; the last
//     sample unfiltered), or at 32x32 with strong smoothing enabled and
//     a flat block (|t0 + t2S - 2 tS| and |l0 + l2S - 2 lS| < 2^(bd-5))
//     the bilinear ones ((2S-i) t0 + i t2S + 32) >> 6;
//   planar ((S-1-x) l[1+y] + (x+1) t[S+1] + (S-1-y) t[1+x] + (y+1) l[S+1]
//     + S) >> (log2+1); DC (sum t[1..S] + sum l[1..S] + S) >> (log2+1);
//   angular: main = t for modes >= 18 (l and transposed below 18),
//     pos = (y+1) angle, i = (pos >> 5) + x + 1, f = pos & 31,
//     ((32-f) ref(i) + f ref(i+1) + 16) >> 5 with ref(i) = main[min(i,2S)]
//     for i >= 0 and side[(i inv + 128) >> 8] (the projected side sample)
//     for i < 0;
//   luma S < 32: the DC edge filter and the VER/HOR gradient filters from
//     the unfiltered arrays, clipped to (1 << bd) - 1.
// Integer and exact. Negative angles floor in Python: `>>` on signed int
// is an arithmetic shift here and `& 31` a two's-complement mask, never
// `/` or `%`, as tpuhevc/ops/intra.py:197-347.
//
// Angles, inverse angles and filter flags by log2 size sit in constant
// memory; each including file has its own copy, filled by its init entry
// point through `intra_pred_load_tables`.

#pragma once

#include <cuda_runtime.h>

namespace {

__constant__ int c_angle[35];
__constant__ int c_inv[35];
__constant__ int c_filter[4 * 35];  // [log2 - 2][mode]

// per-mode angles, inverse angles (modes 11..25, else 0) and the filter
// flags [log2 - 2][mode] (int32, host memory) -> constant memory of the
// current device
inline int intra_pred_load_tables(const int* angle, const int* inv,
                                  const int* filter) {
    cudaMemcpyToSymbol(c_angle, angle, sizeof(int) * 35);
    cudaMemcpyToSymbol(c_inv, inv, sizeof(int) * 35);
    cudaMemcpyToSymbol(c_filter, filter, sizeof(int) * 4 * 35);
    return (int)cudaGetLastError();
}

// whether a luma block's references take the bilinear strong smoothing
__device__ __forceinline__ bool intra_use_strong(const int* t, const int* l,
                                                 int log2, int strong,
                                                 int bd) {
    const int S = 1 << log2, s2 = 2 * S, thr = 1 << (bd - 5);
    return log2 == 5 && strong && abs(t[0] + t[s2] - 2 * t[S]) < thr &&
           abs(l[0] + l[s2] - 2 * l[S]) < thr;
}

// sample i of the filtered top (*a) and left (*b) arrays, s2 = 2S
__device__ __forceinline__ void intra_smooth_at(const int* t, const int* l,
                                                int i, int s2,
                                                bool use_strong, int* a,
                                                int* b) {
    if (i == 0) {
        *a = *b = use_strong ? t[0] : (l[1] + 2 * t[0] + t[1] + 2) >> 2;
    } else if (i == s2) {
        *a = t[s2];
        *b = l[s2];
    } else if (use_strong) {
        *a = ((s2 - i) * t[0] + i * t[s2] + 32) >> 6;
        *b = ((s2 - i) * t[0] + i * l[s2] + 32) >> 6;
    } else {
        *a = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
        *b = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
    }
}

// the DC value (unfiltered references)
__device__ __forceinline__ int intra_dc(const int* t, const int* l,
                                        int log2) {
    const int S = 1 << log2;
    int s = S;
    for (int i = 1; i <= S; ++i) s += t[i] + l[i];
    return s >> (log2 + 1);
}

// prediction [r][c] of `mode`; ft, fl the filtered arrays (read where
// `filt` and the mode's flag are set), dc from intra_dc, post: the luma
// boundary filters (luma S < 32)
__device__ __forceinline__ int intra_pred_sample(const int* t, const int* l,
                                                 const int* ft,
                                                 const int* fl, int dc,
                                                 int mode, int r, int c,
                                                 int log2, bool filt,
                                                 bool post, int maxv) {
    const int S = 1 << log2, s2 = 2 * S;
    const bool use_f = filt && c_filter[(log2 - 2) * 35 + mode];
    const int* tt = use_f ? ft : t;
    const int* ll = use_f ? fl : l;
    if (mode == 0)
        return ((S - 1 - c) * ll[1 + r] + (c + 1) * tt[S + 1]
                + (S - 1 - r) * tt[1 + c] + (r + 1) * ll[S + 1] + S)
               >> (log2 + 1);
    if (mode == 1) {
        if (post) {
            if (r == 0 && c == 0) return (l[1] + 2 * dc + t[1] + 2) >> 2;
            if (r == 0) return (t[c + 1] + 3 * dc + 2) >> 2;
            if (c == 0) return (l[r + 1] + 3 * dc + 2) >> 2;
        }
        return dc;
    }
    const int angle = c_angle[mode];
    const bool vert = mode >= 18;
    const int* main_ = vert ? tt : ll;
    const int* side = vert ? ll : tt;
    const int yy = vert ? r : c, xx = vert ? c : r;
    const int pos = (yy + 1) * angle;
    const int i = (pos >> 5) + xx + 1;
    const int f = pos & 31;
    const int inv = c_inv[mode];
    const int a = i >= 0 ? main_[min(i, s2)] : side[(i * inv + 128) >> 8];
    const int b = i + 1 >= 0 ? main_[min(i + 1, s2)]
                             : side[((i + 1) * inv + 128) >> 8];
    int v = ((32 - f) * a + f * b + 16) >> 5;
    if (post && mode == 26 && c == 0)
        v = min(max(t[1] + ((l[r + 1] - l[0]) >> 1), 0), maxv);
    else if (post && mode == 10 && r == 0)
        v = min(max(l[1] + ((t[c + 1] - t[0]) >> 1), 0), maxv);
    return v;
}

}  // namespace
