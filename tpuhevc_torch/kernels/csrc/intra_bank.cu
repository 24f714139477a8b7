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
// What bounds it: writing 35 S^2 int32 predictions per block (14 MB for
// the 4x4 luma class at 416x240); the arithmetic is a few integer ops per
// sample. Memory-bound.
// Design: one block per target block; the plain, filtered (or strong) and
// the DC value in shared memory; one thread per (mode, sample) with
// neighbouring threads on neighbouring output addresses (coalesced
// stores). The per-sample predictor and its tables are intra_pred.cuh's.

#include "intra_pred.cuh"

namespace {

constexpr int kThreads = 256;

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
        const bool use_strong = intra_use_strong(t, l, log2, strong, bd);
        for (int i = threadIdx.x; i <= s2; i += blockDim.x)
            intra_smooth_at(t, l, i, s2, use_strong, &ft[i], &fl[i]);
    }
    if (threadIdx.x == 0) s_dc = intra_dc(t, l, log2);
    __syncthreads();

    const int maxv = (1 << bd) - 1;
    const bool post = is_luma && S < 32;
    int* ob = out + (size_t)n * 35 * n2;
    for (int o = threadIdx.x; o < 35 * n2; o += blockDim.x) {
        const int mode = o >> (2 * log2);
        const int e = o & (n2 - 1);
        ob[o] = intra_pred_sample(t, l, ft, fl, s_dc, mode, e >> log2,
                                  e & mask, log2, filt, post, maxv);
    }
}

}  // namespace

// Copies per-mode angles, inverse angles (modes 11..25, else 0) and the
// filter flags [log2 - 2][mode] (int32, host memory) to constant memory
// of the current device. Call once per device before tpuhevc_intra_bank.
extern "C" int tpuhevc_intra_bank_init(const int* angle, const int* inv,
                                       const int* filter) {
    return intra_pred_load_tables(angle, inv, filter);
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
