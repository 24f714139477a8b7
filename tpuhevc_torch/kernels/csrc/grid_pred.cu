// grid_pred: the grid step's motion compensation, two entry points.
//
// tpuhevc_grid_planes replaces tpuhevc/codec/inter_grid.py:862-910
// `luma_planes_all` / `chroma_planes_all` (no weighted prediction): every
// fractional phase of n reference planes, edge-padded by `pad`, through
// the separable DCT-IF filter (the taps of tpuhevc_torch/ops/interp.py,
// as mc_common.cuh filters blocks; luma 8 taps and 4x4 phases, chroma
// 4 taps and 8x8 phases):
//   h(yy, x) = sum_i taps[fx][i] rp[yy][x + i + 1]     (8-bit: no shift)
//   v(y, x)  = sum_j taps[fy][j] h(y + j + 1, x)
//   out[r][fy][fx][y][x] = clip(((v >> 6) + 32) >> 6, 0, 255)   (int16)
// with rp[yy][xx] = ref[clamp(yy - pad)][clamp(xx - pad)]. One thread per
// output sample, the nt x nt products in int32 as in JAX.
//
// tpuhevc_grid_satd replaces the gathers of :912-930 `pred_luma` /
// `pred_chroma` (`batch_satd` :1597) and the Hadamard of :951
// `satd8_plane`: for C fields given per cell x cell block (mv in 1/P pel,
// reference index), pred[c][y][x] = planes[ref][fy][fx][iy][ix] with
// f = mv & (P - 1), i = (mv >> log2 P) + position + look; with `oy`, per
// 8x8 block of r = oy - pred the Hadamard SATD (sum |H r H^T| + 2) >> 2
// and the residual sum, int32. Gather-only calls (chroma) take one thread
// per sample; SATD calls one 64-thread block per 8x8 block.
//
// What bounds it: the planes are ~R x 16 x (H + 2 look) x (W + 2 look)
// int16 samples written once (64 MACs each); a SATD call reads the
// current picture and one gathered sample per pixel and field.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_luma_taps[32];    // (4 phases, 8 taps)
__constant__ int c_chroma_taps[32];  // (8 phases, 4 taps)
__constant__ int c_had8[64];

__global__ void planes_kernel(const int* __restrict__ ref,
                              int16_t* __restrict__ out, int n, int h, int w,
                              int luma, int pad, int hm, int wm) {
    const int P = luma ? 4 : 8, nt = luma ? 8 : 4;
    const long long total = (long long)n * P * P * hm * wm;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int x = (int)(t % wm);
    long long q = t / wm;
    const int y = (int)(q % hm);
    q /= hm;
    const int fx = (int)(q % P);
    q /= P;
    const int fy = (int)(q % P);
    const int r = (int)(q / P);
    const int* tx = luma ? &c_luma_taps[fx * 8] : &c_chroma_taps[fx * 4];
    const int* ty = luma ? &c_luma_taps[fy * 8] : &c_chroma_taps[fy * 4];
    const int* base = ref + (size_t)r * h * w;
    int v = 0;
    for (int j = 0; j < nt; ++j) {
        const int yy = min(max(y + j + 1 - pad, 0), h - 1);
        const int* row = base + (size_t)yy * w;
        int hs = 0;
        for (int i = 0; i < nt; ++i) {
            const int xx = min(max(x + i + 1 - pad, 0), w - 1);
            hs += tx[i] * row[xx];
        }
        v += ty[j] * hs;
    }
    out[t] = (int16_t)min(max(((v >> 6) + 32) >> 6, 0), 255);
}

__device__ __forceinline__ int gather(const int16_t* __restrict__ planes,
                                      const int* __restrict__ mv,
                                      const int* __restrict__ ref, int c,
                                      int y, int x, int P, int hm, int wm,
                                      int hc, int wc, int cell, int look) {
    const int fb = P == 4 ? 2 : 3;
    const size_t ci = ((size_t)c * hc + y / cell) * wc + x / cell;
    const int mx = mv[2 * ci], my = mv[2 * ci + 1], r = ref[ci];
    const int ix = (mx >> fb) + x + look, iy = (my >> fb) + y + look;
    const size_t plane = (size_t)r * P * P + (my & (P - 1)) * P + (mx & (P - 1));
    return planes[(plane * hm + iy) * wm + ix];
}

__global__ void gather_kernel(const int16_t* __restrict__ planes,
                              const int* __restrict__ mv,
                              const int* __restrict__ ref,
                              int* __restrict__ pred, int P, int hm, int wm,
                              int C, int hc, int wc, int cell, int look) {
    const int h = hc * cell, w = wc * cell;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)C * h * w) return;
    const int x = (int)(t % w);
    const int y = (int)((t / w) % h);
    const int c = (int)(t / ((long long)w * h));
    pred[t] = gather(planes, mv, ref, c, y, x, P, hm, wm, hc, wc, cell, look);
}

// one 64-thread block per (field, 8x8 block)
__global__ void satd_kernel(const int16_t* __restrict__ planes,
                            const int* __restrict__ mv,
                            const int* __restrict__ ref,
                            const int* __restrict__ oy,
                            int* __restrict__ pred, int* __restrict__ m8,
                            int* __restrict__ s8, int P, int hm, int wm,
                            int hc, int wc, int cell, int look, int wo) {
    __shared__ int r[64];
    __shared__ int part[2][2];
    const int h = hc * cell, w = wc * cell;
    const int nbw = w >> 3, nbh = h >> 3;
    const int b = blockIdx.x;
    const int c = b / (nbh * nbw);
    const int rem = b - c * nbh * nbw;
    const int by = rem / nbw, bx = rem - by * nbw;
    const int i = threadIdx.x >> 3, j = threadIdx.x & 7;
    const int y = by * 8 + i, x = bx * 8 + j;
    const int p = gather(planes, mv, ref, c, y, x, P, hm, wm, hc, wc, cell,
                         look);
    if (pred) pred[((size_t)c * h + y) * w + x] = p;
    const int e = oy[(size_t)y * wo + x] - p;
    r[threadIdx.x] = e;
    __syncthreads();
    // thread (k, l): |(H r H^T)[k][l]|
    int acc = 0;
    for (int a = 0; a < 8; ++a) {
        int row = 0;
        for (int bb = 0; bb < 8; ++bb) row += r[a * 8 + bb] * c_had8[j * 8 + bb];
        acc += c_had8[i * 8 + a] * row;
    }
    int sa = abs(acc), se = e;
    for (int off = 16; off > 0; off >>= 1) {
        sa += __shfl_down_sync(0xffffffffu, sa, off);
        se += __shfl_down_sync(0xffffffffu, se, off);
    }
    if ((threadIdx.x & 31) == 0) {
        part[threadIdx.x >> 5][0] = sa;
        part[threadIdx.x >> 5][1] = se;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        m8[b] = (part[0][0] + part[1][0] + 2) >> 2;
        s8[b] = part[0][1] + part[1][1];
    }
}

}  // namespace

// Copies the DCT-IF taps and the 8x8 Hadamard matrix to this file's
// constant memory on the current device. Call once per device first.
extern "C" int tpuhevc_grid_pred_init(const int* luma_taps,
                                      const int* chroma_taps,
                                      const int* had8) {
    cudaMemcpyToSymbol(c_luma_taps, luma_taps, sizeof(int) * 32);
    cudaMemcpyToSymbol(c_chroma_taps, chroma_taps, sizeof(int) * 32);
    cudaMemcpyToSymbol(c_had8, had8, sizeof(int) * 64);
    return (int)cudaGetLastError();
}

// ref (n, h, w) int32 -> out (n, P, P, hm, wm) int16.
extern "C" int tpuhevc_grid_planes(const int* ref, int16_t* out, int n,
                                   int h, int w, int luma, int pad, int hm,
                                   int wm, void* stream) {
    const int P = luma ? 4 : 8;
    const long long total = (long long)n * P * P * hm * wm;
    const int threads = 256;
    planes_kernel<<<(int)((total + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(ref, out, n, h, w, luma, pad, hm,
                                            wm);
    return (int)cudaGetLastError();
}

// planes (R, P, P, hm, wm) int16; mv (C, hc, wc, 2), ref (C, hc, wc)
// int32 per cell; oy (>= h rows, stride wo) int32 or null -> pred
// (C, hc cell, wc cell) int32 (may be null when oy is given); m8, s8
// (C, h / 8, w / 8) int32 when oy is given.
extern "C" int tpuhevc_grid_satd(const int16_t* planes, const int* mv,
                                 const int* ref, const int* oy, int* pred,
                                 int* m8, int* s8, int R, int P, int hm,
                                 int wm, int C, int hc, int wc, int cell,
                                 int look, int wo, void* stream) {
    (void)R;
    const int h = hc * cell, w = wc * cell;
    if (oy == nullptr) {
        const long long total = (long long)C * h * w;
        const int threads = 256;
        gather_kernel<<<(int)((total + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(planes, mv, ref, pred, P, hm,
                                                wm, C, hc, wc, cell, look);
    } else {
        satd_kernel<<<C * (h >> 3) * (w >> 3), 64, 0,
                      (cudaStream_t)stream>>>(planes, mv, ref, oy, pred, m8,
                                              s8, P, hm, wm, hc, wc, cell,
                                              look, wo);
    }
    return (int)cudaGetLastError();
}
