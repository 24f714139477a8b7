// intra_bank: the 35-mode intra prediction bank of the open-loop decision.
//
// Replaces: tpuhevc/ops/intra.py:197-347 (`predict_all_modes` with
// `_smooth_refs_jnp`, `_strong_refs_jnp`, `_strong_ok_jnp`,
// `_predict_one_jnp`, `_post_filter_jnp`), called from
// tpuhevc/codec/intra_decide_jax.py:126 / :212 inside `_build`, which XLA
// compiled for the TPU.
//
// What it computes, per target block n from its top/left reference arrays
// t, l (2S+1 samples each, corner at index 0), for every mode 0..34, the
// S x S prediction [y][x] of intra_pred.cuh (filtered and strong-smoothed
// references, planar, DC, the 33 angles, the luma boundary filters).
// Integer and exact.
//
// What bounds it: writing 35 S^2 int32 predictions a block (14 MB for the
// 4x4 luma class at 416x240, 123 MB over the two decision passes of LD-P's
// IDR); a few integer operations a sample. Memory-bound; at the
// decision's sizes each launch is a single wave, so the time to load the
// references before the first store is what the card waits on.
// Design: the TU size is compiled in. A thread makes 4 adjacent samples of
// one (block, mode, row) and writes them with one 16-byte store, a warp's
// lanes on one mode (8 blocks x 4 rows at S = 4, 2 blocks x 16 vectors at
// S = 8, a part of one block's mode at 16 and 32), so that angle, inverse
// angle and filter flag are warp-uniform. The CTA (7 warps) shape fills
// the card: a CTA takes 16 target blocks and 7 modes at S = 4 (5 CTAs a
// group of blocks), 2 blocks and all 35 modes at S = 8, one block and 7
// modes at S = 16 and 32 (5 CTAs a block: S = 32's 91 blocks are 455
// CTAs); the other shapes tried were slower over LD-P's IDR (PERF.md row
// 23). Before its one barrier a CTA fills, straight from device memory
// (a thread's items unrolled, their loads in flight together), its
// blocks' references t, l and the filtered (or strong-smoothed) ft, fl,
// each with its last sample repeated at 2S + 1, the DC (a warp
// reduction), and for each mode of negative angle (11..25) the extended
// reference of HM's xPredIntraAng, ext[k] = k >= 0 ? main[k] :
// side[(k inv + 128) >> 8] for k from the least the mode reads to S; for
// every other angular mode ext[k] is main[min(k, 2S)], the array itself.
// So a sample is two shared-memory reads and the interpolation, with no
// branch a sample; the post-filters run only in the branches for row 0
// and column 0.

#include "intra_pred.cuh"

namespace {

constexpr int kThreads = 224;  // 7 warps
constexpr int kNegFirst = 11, kNegLast = 25;  // the modes of negative angle

// target blocks a CTA, modes a CTA
template <int S> struct Shape;
template <> struct Shape<4> { static constexpr int kBlocks = 16, kModes = 7; };
template <> struct Shape<8> { static constexpr int kBlocks = 2, kModes = 35; };
template <> struct Shape<16> { static constexpr int kBlocks = 1, kModes = 7; };
template <> struct Shape<32> { static constexpr int kBlocks = 1, kModes = 7; };

template <int LOG2>
__global__ void __launch_bounds__(kThreads)
intra_bank_rows(const int* __restrict__ tops, const int* __restrict__ lefts,
                int* __restrict__ out, int n, int is_luma, int bd, int strong) {
    constexpr int S = 1 << LOG2, S2 = 2 * S, R = S2 + 1, L = S2 + 2;
    constexpr int NB = Shape<S>::kBlocks, G = Shape<S>::kModes, MG = 35 / G;
    constexpr int GN = G < 15 ? G : 15;  // negative-angle modes a CTA, at most
    constexpr int VM = S * S / 4;        // 16-byte vectors a mode
    // a block's t, l and filtered ft, fl, each with its last sample again
    // at 2S + 1 (the ext of a mode whose angle is not negative)
    __shared__ int s_ref[NB][4][L];
    __shared__ int s_dc[NB];
    // the ext of each negative-angle mode, k in [-S + 1, S] at k + S - 1
    __shared__ int s_ext[NB][GN][S2];
    const int b0 = (blockIdx.x / MG) * NB, m0 = (blockIdx.x % MG) * G;
    const int nb = min(NB, n - b0);
    const int neg0 = max(m0, kNegFirst);
    const int nneg = max(min(m0 + G - 1, kNegLast) - neg0 + 1, 0);
    const bool filt = is_luma && LOG2 >= 3;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    // one pass straight from device memory, then one barrier: the arrays,
    // each negative-angle mode's ext (its side samples projected) and the
    // DC (a warp a block). A thread's items are unrolled, so that their
    // loads are in flight together.
#pragma unroll
    for (int j = 0; j < (NB * L + kThreads - 1) / kThreads; ++j) {
        const int e = tid + j * kThreads, b = e / L, ii = e - b * L, i = min(ii, S2);
        if (e < nb * L) {
            const int* t = tops + (size_t)(b0 + b) * R;
            const int* l = lefts + (size_t)(b0 + b) * R;
            s_ref[b][0][ii] = __ldg(t + i);
            s_ref[b][1][ii] = __ldg(l + i);
            if (filt)
                intra_smooth_at(t, l, i, S2, intra_use_strong(t, l, LOG2, strong, bd),
                                &s_ref[b][2][ii], &s_ref[b][3][ii]);
        }
    }
#pragma unroll
    for (int j = 0; j < (NB * GN * S2 + kThreads - 1) / kThreads; ++j) {
        const int x = tid + j * kThreads, b = x / (GN * S2);
        const int g = (x / S2) % GN, kk = x % S2, k = kk - S + 1;
        const int mode = min(neg0 + g, 34);
        // the k below what the mode reads stay unset
        if (x < nb * GN * S2 && g < nneg && k > (S * c_angle[mode]) >> 5) {
            const int* t = tops + (size_t)(b0 + b) * R;
            const int* l = lefts + (size_t)(b0 + b) * R;
            const bool top = (mode >= 18) == (k >= 0);  // t (ft), else l (fl)
            const int i = k >= 0 ? k : (k * c_inv[mode] + 128) >> 8;
            int v;
            if (filt && c_filter[(LOG2 - 2) * 35 + mode]) {
                int a, c;
                intra_smooth_at(t, l, i, S2, intra_use_strong(t, l, LOG2, strong, bd), &a, &c);
                v = top ? a : c;
            } else {
                v = __ldg((top ? t : l) + i);
            }
            s_ext[b][g][kk] = v;
        }
    }
    for (int b = warp; b < nb; b += kThreads / 32) {
        const size_t o = (size_t)(b0 + b) * R + 1 + lane;
        int s = lane < S ? __ldg(tops + o) + __ldg(lefts + o) : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) s_dc[b] = (s + S) >> (LOG2 + 1);
    }
    __syncthreads();

    const int maxv = (1 << bd) - 1;
    const bool post = is_luma && S < 32;
    for (int it = tid; it < NB * G * VM; it += kThreads) {
        const int v = it % VM, b = (it / VM) % NB, gm = it / (VM * NB);
        if (b >= nb) continue;
        const int mode = m0 + gm;
        const int r = v / (S / 4), c0 = (v % (S / 4)) * 4;
        const int* t = s_ref[b][0];
        const int* l = s_ref[b][1];
        int o[4];
        if (mode == 0) {  // planar
            const bool f = filt && c_filter[(LOG2 - 2) * 35];
            const int* tt = s_ref[b][f ? 2 : 0];
            const int* ll = s_ref[b][f ? 3 : 1];
            const int base = (r + 1) * ll[S + 1] + S;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int c = c0 + q;
                o[q] = ((S - 1 - c) * ll[1 + r] + (c + 1) * tt[S + 1]
                        + (S - 1 - r) * tt[1 + c] + base) >> (LOG2 + 1);
            }
        } else if (mode == 1) {  // DC
            const int dc = s_dc[b];
#pragma unroll
            for (int q = 0; q < 4; ++q) o[q] = dc;
            if (post && r == 0) {
#pragma unroll
                for (int q = 0; q < 4; ++q) o[q] = (t[c0 + q + 1] + 3 * dc + 2) >> 2;
                if (c0 == 0) o[0] = (l[1] + 2 * dc + t[1] + 2) >> 2;
            } else if (post && c0 == 0) {
                o[0] = (l[r + 1] + 3 * dc + 2) >> 2;
            }
        } else {
            const int angle = c_angle[mode];
            const bool vert = mode >= 18;
            const int* ext;  // ext[0] of the mode
            if (mode >= kNegFirst && mode <= kNegLast)
                ext = s_ext[b][mode - neg0] + S - 1;
            else
                ext = s_ref[b][(filt && c_filter[(LOG2 - 2) * 35 + mode] ? 2 : 0) + !vert];
            if (vert) {  // a row: one angle position, 5 samples read
                const int pos = (r + 1) * angle, f = pos & 31;
                const int* p = ext + (pos >> 5) + c0 + 1;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    o[q] = ((32 - f) * p[q] + f * p[q + 1] + 16) >> 5;
                if (post && mode == 26 && c0 == 0)
                    o[0] = min(max(t[1] + ((l[r + 1] - l[0]) >> 1), 0), maxv);
            } else {  // transposed: a position a sample
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int pos = (c0 + q + 1) * angle, f = pos & 31;
                    const int* p = ext + (pos >> 5) + r + 1;
                    o[q] = ((32 - f) * p[0] + f * p[1] + 16) >> 5;
                }
                if (post && mode == 10 && r == 0) {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        o[q] = min(max(l[1] + ((t[c0 + q + 1] - t[0]) >> 1), 0), maxv);
                }
            }
        }
        *reinterpret_cast<int4*>(out + (((size_t)(b0 + b) * 35 + mode) * S + r) * S
                                 + c0) = make_int4(o[0], o[1], o[2], o[3]);
    }
}

template <int LOG2>
int launch(const int* tops, const int* lefts, int* out, int n, int is_luma,
           int bd, int strong, cudaStream_t stream) {
    constexpr int S = 1 << LOG2;
    const int grid = (n + Shape<S>::kBlocks - 1) / Shape<S>::kBlocks
                     * (35 / Shape<S>::kModes);
    intra_bank_rows<LOG2><<<grid, kThreads, 0, stream>>>(tops, lefts, out, n,
                                                         is_luma, bd, strong);
    return (int)cudaGetLastError();
}

}  // namespace

// Copies per-mode angles, inverse angles (modes 11..25, else 0) and the
// filter flags [log2 - 2][mode] (int32, host memory) to constant memory
// of the current device. Call once per device before tpuhevc_intra_bank.
extern "C" int tpuhevc_intra_bank_init(const int* angle, const int* inv,
                                       const int* filter) {
    return intra_pred_load_tables(angle, inv, filter);
}

// tops, lefts (n, 2S+1) int32 on the device, S = 1 << log2 in 4..32, n >= 1
// -> out (n, 35, S, S) int32, 16-byte aligned. is_luma: filters and
// post-filters; strong: the SPS strong_intra_smoothing flag.
extern "C" int tpuhevc_intra_bank(const int* tops, const int* lefts,
                                  int* out, int n, int log2, int is_luma,
                                  int bd, int strong, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log2) {
        case 2: return launch<2>(tops, lefts, out, n, is_luma, bd, strong, s);
        case 3: return launch<3>(tops, lefts, out, n, is_luma, bd, strong, s);
        case 4: return launch<4>(tops, lefts, out, n, is_luma, bd, strong, s);
        case 5: return launch<5>(tops, lefts, out, n, is_luma, bd, strong, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
