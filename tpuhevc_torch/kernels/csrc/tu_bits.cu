// tu_bits: the table bit estimate of residual TUs.
//
// Replaces: tpuhevc/entropy/bitest.py:286-378 (`ResidualBitEst.tu_bits`,
// sbh off: the intra decision prices no sign-bit hiding) and :398-408 (`_rice_bits_xp`), jnp code that XLA compiled
// for the TPU inside the intra decision (and, later, the grid step).
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
// Sums: the three fractional sums in double, exact in any order (every
// table value is a multiple of 2^-15), rounded once to float32, then the
// partial sums added in float32 in the reference's order; the integer
// sums in int32. So the result does not depend on the reduction order
// and equals the PyTorch version bit for bit.
//
// What bounds it: reads of S^2 levels and table gathers per TU (a few
// bytes per coefficient); latency-bound at these sizes.
// Design: one warp per TU (four per block), the warp's walk in
// tu_bits_common.cuh. Lanes first walk the CGs (stats into shared
// memory), then the coefficients; warp shuffles reduce. The tables come
// from device memory (`itab`, `ftab`, packed as entropy/bitest.py
// `_ioffsets` / `_foffsets` lay them out), so live tables can be passed in
// as well.

#include "tu_bits_common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void tu_bits_kernel(const int* __restrict__ tiles,
                               const int* __restrict__ itab,
                               const float* __restrict__ ftab,
                               float* __restrict__ out, int n, int log2) {
    __shared__ int s_csbf[kWarps][kMaxCg];
    __shared__ int s_nsig[kWarps][kMaxCg];
    __shared__ int s_ngt1[kWarps][kMaxCg];
    __shared__ int s_gt2[kWarps][kMaxCg];
    __shared__ int s_rice[kWarps][kMaxCg];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = blockIdx.x * kWarps + warp;
    if (t >= n) return;  // whole warps only: no block barrier below
    const int* lv = tiles + ((size_t)t << (2 * log2));
    const float bits = tu_bits_warp(lv, itab, ftab, log2, s_csbf[warp],
                                    s_nsig[warp], s_ngt1[warp], s_gt2[warp],
                                    s_rice[warp], false);
    if (lane == 0) out[t] = bits;
}

}  // namespace

// tiles (n, S, S) int32 levels on the device, S = 1 << log2 in 4..32;
// itab / ftab: the estimator's tables (entropy/bitest.py EstTables) ->
// out (n,) float32 bits.
extern "C" int tpuhevc_tu_bits(const int* tiles, const int* itab,
                               const float* ftab, float* out, int n,
                               int log2, void* stream) {
    const int blocks = (n + kWarps - 1) / kWarps;
    tu_bits_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        tiles, itab, ftab, out, n, log2);
    return (int)cudaGetLastError();
}
