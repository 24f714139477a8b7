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
// S x S prediction [y][x]:
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
// `/` or `%`.
//
// What bounds it: writing 35 S^2 int32 predictions per block (14 MB for
// the 4x4 luma class at 416x240); the arithmetic is a few integer ops per
// sample. Memory-bound.
// Design: one block per target block; the plain, filtered (or strong) and
// the DC value in shared memory; one thread per (mode, sample) with
// neighbouring threads on neighbouring output addresses (coalesced
// stores). Angles, inverse angles and filter flags by log2 size sit in
// constant memory, copied from tpuhevc's tables by the init entry point.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__constant__ int c_angle[35];
__constant__ int c_inv[35];
__constant__ int c_filter[4 * 35];  // [log2 - 2][mode]

__global__ void intra_bank_kernel(const int* __restrict__ tops,
                                  const int* __restrict__ lefts,
                                  int* __restrict__ out, int log2,
                                  int is_luma, int bd, int strong) {
    __shared__ int t[65], l[65], ft[65], fl[65];
    __shared__ int s_dc;
    const int S = 1 << log2, n2 = S * S, s2 = 2 * S, mask = S - 1;
    const int n = blockIdx.x;
    for (int i = threadIdx.x; i <= s2; i += blockDim.x) {
        t[i] = tops[(size_t)n * (s2 + 1) + i];
        l[i] = lefts[(size_t)n * (s2 + 1) + i];
    }
    __syncthreads();
    const bool filt = is_luma && log2 >= 3;
    if (filt) {
        const int thr = 1 << (bd - 5);
        const bool use_strong =
            log2 == 5 && strong && abs(t[0] + t[s2] - 2 * t[S]) < thr &&
            abs(l[0] + l[s2] - 2 * l[S]) < thr;
        for (int i = threadIdx.x; i <= s2; i += blockDim.x) {
            int a, b;
            if (i == 0) {
                a = b = use_strong ? t[0] : (l[1] + 2 * t[0] + t[1] + 2) >> 2;
            } else if (i == s2) {
                a = t[s2];
                b = l[s2];
            } else if (use_strong) {
                a = ((s2 - i) * t[0] + i * t[s2] + 32) >> 6;
                b = ((s2 - i) * t[0] + i * l[s2] + 32) >> 6;
            } else {
                a = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
                b = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
            }
            ft[i] = a;
            fl[i] = b;
        }
    }
    if (threadIdx.x == 0) {
        int s = S;
        for (int i = 1; i <= S; ++i) s += t[i] + l[i];
        s_dc = s >> (log2 + 1);
    }
    __syncthreads();

    const int maxv = (1 << bd) - 1;
    const bool post = is_luma && S < 32;
    int* ob = out + (size_t)n * 35 * n2;
    for (int o = threadIdx.x; o < 35 * n2; o += blockDim.x) {
        const int mode = o >> (2 * log2);
        const int e = o & (n2 - 1);
        const int r = e >> log2, c = e & mask;
        const bool use_f = filt && c_filter[(log2 - 2) * 35 + mode];
        const int* tt = use_f ? ft : t;
        const int* ll = use_f ? fl : l;
        int v;
        if (mode == 0) {
            v = ((S - 1 - c) * ll[1 + r] + (c + 1) * tt[S + 1]
                 + (S - 1 - r) * tt[1 + c] + (r + 1) * ll[S + 1] + S)
                >> (log2 + 1);
        } else if (mode == 1) {
            v = s_dc;
            if (post) {
                if (r == 0 && c == 0)
                    v = (l[1] + 2 * s_dc + t[1] + 2) >> 2;
                else if (r == 0)
                    v = (t[c + 1] + 3 * s_dc + 2) >> 2;
                else if (c == 0)
                    v = (l[r + 1] + 3 * s_dc + 2) >> 2;
            }
        } else {
            const int angle = c_angle[mode];
            const bool vert = mode >= 18;
            const int* main_ = vert ? tt : ll;
            const int* side = vert ? ll : tt;
            const int yy = vert ? r : c, xx = vert ? c : r;
            const int pos = (yy + 1) * angle;
            const int i = (pos >> 5) + xx + 1;
            const int f = pos & 31;
            const int inv = c_inv[mode];
            const int a = i >= 0 ? main_[min(i, s2)]
                                 : side[(i * inv + 128) >> 8];
            const int b = i + 1 >= 0 ? main_[min(i + 1, s2)]
                                     : side[((i + 1) * inv + 128) >> 8];
            v = ((32 - f) * a + f * b + 16) >> 5;
            if (post && mode == 26 && c == 0)
                v = min(max(t[1] + ((l[r + 1] - l[0]) >> 1), 0), maxv);
            else if (post && mode == 10 && r == 0)
                v = min(max(l[1] + ((t[c + 1] - t[0]) >> 1), 0), maxv);
        }
        ob[o] = v;
    }
}

}  // namespace

// Copies per-mode angles, inverse angles (modes 11..25, else 0) and the
// filter flags [log2 - 2][mode] (int32, host memory) to constant memory
// of the current device. Call once per device before tpuhevc_intra_bank.
extern "C" int tpuhevc_intra_bank_init(const int* angle, const int* inv,
                                       const int* filter) {
    cudaMemcpyToSymbol(c_angle, angle, sizeof(int) * 35);
    cudaMemcpyToSymbol(c_inv, inv, sizeof(int) * 35);
    cudaMemcpyToSymbol(c_filter, filter, sizeof(int) * 4 * 35);
    return (int)cudaGetLastError();
}

// tops, lefts (n, 2S+1) int32 on the device, S = 1 << log2 in 4..32 ->
// out (n, 35, S, S) int32. is_luma: filters and post-filters; strong: the
// SPS strong_intra_smoothing flag.
extern "C" int tpuhevc_intra_bank(const int* tops, const int* lefts,
                                  int* out, int n, int log2, int is_luma,
                                  int bd, int strong, void* stream) {
    intra_bank_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        tops, lefts, out, log2, is_luma, bd, strong);
    return (int)cudaGetLastError();
}
