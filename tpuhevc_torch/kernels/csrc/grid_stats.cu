// grid_stats: the grid step's picture statistics when the recon stays on
// the device (no recon fetch).
//
// tpuhevc_grid_stats replaces the `fetch_recon` off branch of the packing
// tail, tpuhevc/codec/inter_grid.py:3170-3185 (`_xor_mask` :86-91): per
// plane of the composed, filtered recon (Y, then U and V, the two halves
// of the packed [U | V] chroma plane)
//   cks = sum ((rec & 0xFF) ^ mask(x, y))                       (int32)
//   mask(x, y) = (x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)
// the picture checksum of the decoded-picture-hash SEI (D.3.19; x, y in
// the plane's own coordinates), and
//   sse = sum (orig - rec)^2                                    (float32)
// The mask is computed from (x, y), not uploaded. The checksum is an exact
// int32 sum in any order (it wraps as XLA's int32 sum does; a plane of
// 8-bit samples stays far below 2^31 up to 1080p). The SSE is the exact
// integer sum (int64) rounded once to float32: XLA adds float32 squares,
// which equals this wherever the total is below 2^24 (every test clip);
// above it the two may differ in the last place. Only PSNR reads it.
//
// Row stripes: the kernel writes the exact int64 sums (the checksum before
// its int32 wrap, the SSE before its rounding) of the rows it is given,
// with y0 the first row's row in the picture (y0 / 2 in chroma) for the
// mask; the caller adds the stripes' sums and then wraps and rounds once
// (ops/grid_stats.py stats_finish), so the stripes give the picture's
// values bit for bit.
//
// One launch a picture (a stripe): one block per plane, each thread
// striding over the plane, a block reduction. What bounds it: the bytes, two int32 planes
// read once (orig and recon), 8 bytes a sample; 3 x 4 + 3 x 4 bytes out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void stats_kernel(const int* __restrict__ oy,
                             const int* __restrict__ ouv,
                             const int* __restrict__ ry,
                             const int* __restrict__ ruv, int h, int w,
                             int y0, long long* __restrict__ cks,
                             long long* __restrict__ sse) {
    __shared__ long long s_ck[kThreads / 32];
    __shared__ long long s_se[kThreads / 32];
    const int p = blockIdx.x;  // 0: Y, 1: U, 2: V
    const int ph = p == 0 ? h : h / 2;
    const int pw = p == 0 ? w : w / 2;
    const int x0 = p == 2 ? w / 2 : 0;
    const int* o = p == 0 ? oy : ouv;
    const int* r = p == 0 ? ry : ruv;
    const int py0 = p == 0 ? y0 : y0 / 2;
    long long ck = 0, se = 0;
    const int n = ph * pw;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int y = i / pw, x = i - y * pw, gy = py0 + y;
        const size_t at = (size_t)y * w + x0 + x;  // both planes: rows of w
        const int v = r[at];
        const int m = (x & 0xFF) ^ (gy & 0xFF) ^ (x >> 8) ^ (gy >> 8);
        ck += (v & 0xFF) ^ m;
        const long long d = (long long)(o[at] - v);
        se += d * d;
    }
    for (int off = 16; off > 0; off >>= 1) {
        ck += __shfl_down_sync(0xffffffffu, ck, off);
        se += __shfl_down_sync(0xffffffffu, se, off);
    }
    if ((threadIdx.x & 31) == 0) {
        s_ck[threadIdx.x >> 5] = ck;
        s_se[threadIdx.x >> 5] = se;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long a = 0, b = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
            a += s_ck[k];
            b += s_se[k];
        }
        cks[p] = a;
        sse[p] = b;
    }
}

}  // namespace

// oy, ry (h, w) int32; ouv, ruv (h / 2, w) int32 packed [U | V], the rows
// from picture row y0 (even) -> cks (3,), sse (3,) int64 exact sums, in
// the order Y, U, V.
extern "C" int tpuhevc_grid_stats(const int* oy, const int* ouv,
                                  const int* ry, const int* ruv, int h, int w,
                                  int y0, long long* cks, long long* sse,
                                  void* stream) {
    stats_kernel<<<3, kThreads, 0, (cudaStream_t)stream>>>(
        oy, ouv, ry, ruv, h, w, y0, cks, sse);
    return (int)cudaGetLastError();
}
