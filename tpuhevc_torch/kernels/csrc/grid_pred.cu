// grid_pred: the grid step's motion compensation, three entry points.
//
// tpuhevc_grid_planes replaces tpuhevc/codec/inter_grid.py:862-910
// `luma_planes_all` / `chroma_planes_all`, with and without explicit
// weighted prediction (`wpy` / `wpc`): every
// fractional phase of n reference planes, edge-padded by `pad`, through
// the separable DCT-IF filter (the taps of tpuhevc_torch/ops/interp.py,
// as mc_common.cuh filters blocks; luma 8 taps and 4x4 phases, chroma
// 4 taps and 8x8 phases):
//   h(yy, x) = sum_i taps[fx][i] rp[yy][x + i + 1]     (8-bit: no shift)
//   v(y, x)  = sum_j taps[fy][j] h(y + j + 1, x)
//   out[r][fy][fx][y][x] = clip(((v >> 6) + 32) >> 6, 0, 255)   (int16)
// with rp[yy][xx] = ref[clamp(y0 + yy - pad)][clamp(xx - pad)] (y0 the
// window's first row in the padded plane: a row stripe's origin in its
// halo'd reference, 0 for the whole picture); with weights
// w[r], o[r] and the denominator d, the weighting folded into the
// rounding of the 14-bit intermediate p14 = v >> 6 (weightUnidir):
//   out = clip(((p14 * w[r] + (1 << (d + 6) >> 1)) >> (d + 6)) + o[r])
// which identity weights (w = 1 << d, o = 0) reduce to the line above bit
// for bit; p14 * w stays below 2^23 in int32. One thread per output
// sample, the nt x nt products in int32 as in JAX.
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
// tpuhevc_grid_subpel replaces :1012-1035 `subpel_refine` (FmeMode
// dctif): per CU of size S, from the full-pel MV (times 4), a 9-point
// half-pel square (offsets +-2 quarter-pel), then a 9-point quarter-pel
// square (+-1) around the winner; each point scored as `pred_satd`
// (:969-981) scores it: the prediction gathered from the phase planes as
// above, per 8x8 block of oy - pred the Hadamard SATD (sum |H r H^T| + 2)
// >> 2, summed over the CU; the first index among equal minima, as
// jnp.argmin. The costs are exact integers (the reference casts to
// float32 after the integer sum, far below 2^24), so no float order is
// involved. The caller keeps |mv| <= look - 1 (the refine's clamp to
// sr_full + 3 with look = sr_full + 4), so every read lies inside the
// planes (asserted in the plain version). One CUDA block per CU, one
// 64-thread group per point: 2 rounds x (S / 8)^2 sub-blocks of the
// same gather and Hadamard as the SATD calls.
//
// What bounds it: the planes are ~R x 16 x (H + 2 look) x (W + 2 look)
// int16 samples written once (64 MACs each); a SATD call reads the
// current picture and one gathered sample per pixel and field; the
// subpel refinement does 18 SATD evaluations per pixel, ~40 integer
// operations each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_luma_taps[32];    // (4 phases, 8 taps)
__constant__ int c_chroma_taps[32];  // (8 phases, 4 taps)
__constant__ int c_had8[64];

__global__ void planes_kernel(const int* __restrict__ ref,
                              const int* __restrict__ wpw,
                              const int* __restrict__ wpo,
                              int16_t* __restrict__ out, int n, int h, int w,
                              int luma, int pad, int y0, int hm, int wm,
                              int wpd) {
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
        const int yy = min(max(y0 + y + j + 1 - pad, 0), h - 1);
        const int* row = base + (size_t)yy * w;
        int hs = 0;
        for (int i = 0; i < nt; ++i) {
            const int xx = min(max(x + i + 1 - pad, 0), w - 1);
            hs += tx[i] * row[xx];
        }
        v += ty[j] * hs;
    }
    const int p14 = v >> 6;
    int s;
    if (wpw) {
        const int sh = wpd + 6;
        s = ((p14 * wpw[r] + ((1 << sh) >> 1)) >> sh) + wpo[r];
    } else {
        s = (p14 + 32) >> 6;
    }
    out[t] = (int16_t)min(max(s, 0), 255);
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

// |(H r H^T)[i][j]| for the 8x8 block r (row-major), thread (i, j)
__device__ __forceinline__ int had_abs(const int* r, int i, int j) {
    int acc = 0;
    for (int a = 0; a < 8; ++a) {
        int row = 0;
        for (int bb = 0; bb < 8; ++bb) row += r[a * 8 + bb] * c_had8[j * 8 + bb];
        acc += c_had8[i * 8 + a] * row;
    }
    return abs(acc);
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
    int sa = had_abs(r, i, j), se = e;
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

// one block per CU, nine 64-thread groups (one per point of the square)
constexpr int kSubpelThreads = 9 * 64;

__global__ void subpel_kernel(const int16_t* __restrict__ planes,
                              const int* __restrict__ oy,
                              const int* __restrict__ mv,
                              const int* __restrict__ ref,
                              int* __restrict__ out, int hm, int wm, int nbw,
                              int S, int look, int wo) {
    __shared__ int r[9][64];
    __shared__ int part[18];
    __shared__ int cost[9];
    __shared__ int best[2];
    const int cu = blockIdx.x;
    const int by = cu / nbw, bx = cu - by * nbw;
    const int g = threadIdx.x >> 6, lt = threadIdx.x & 63;
    const int i = lt >> 3, j = lt & 7;
    const int nsb = S >> 3;
    const int rf = ref[cu];
    int mx = mv[2 * cu] * 4, my = mv[2 * cu + 1] * 4;
    for (int step = 2; step >= 1; step >>= 1) {
        const int qx = mx + (g % 3 - 1) * step, qy = my + (g / 3 - 1) * step;
        const size_t plane = (size_t)rf * 16 + (qy & 3) * 4 + (qx & 3);
        const int16_t* pl = planes + plane * hm * wm;
        int total = 0;  // meaningful in thread lt == 0 of each group
        for (int sb = 0; sb < nsb * nsb; ++sb) {
            const int y = by * S + (sb / nsb) * 8 + i;
            const int x = bx * S + (sb % nsb) * 8 + j;
            const int iy = (qy >> 2) + y + look, ix = (qx >> 2) + x + look;
            r[g][lt] = oy[(size_t)y * wo + x] - pl[(size_t)iy * wm + ix];
            __syncthreads();
            int sa = had_abs(r[g], i, j);
            for (int off = 16; off > 0; off >>= 1)
                sa += __shfl_down_sync(0xffffffffu, sa, off);
            if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = sa;
            __syncthreads();
            if (lt == 0) total += (part[2 * g] + part[2 * g + 1] + 2) >> 2;
        }
        if (lt == 0) cost[g] = total;
        __syncthreads();
        if (threadIdx.x == 0) {
            int bi = 0;
            for (int k = 1; k < 9; ++k)
                if (cost[k] < cost[bi]) bi = k;  // first index among equals
            best[0] = mx + (bi % 3 - 1) * step;
            best[1] = my + (bi / 3 - 1) * step;
        }
        __syncthreads();
        mx = best[0];
        my = best[1];
    }
    if (threadIdx.x == 0) {
        out[2 * cu] = mx;
        out[2 * cu + 1] = my;
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

// ref (n, h, w) int32 -> out (n, P, P, hm, wm) int16, the window from row
// y0 of the padded plane; wpw, wpo (n,) int32 and the denominator wpd, or
// null for the default rounding.
extern "C" int tpuhevc_grid_planes(const int* ref, const int* wpw,
                                   const int* wpo, int16_t* out, int n,
                                   int h, int w, int luma, int pad, int y0,
                                   int hm, int wm, int wpd, void* stream) {
    const int P = luma ? 4 : 8;
    const long long total = (long long)n * P * P * hm * wm;
    const int threads = 256;
    planes_kernel<<<(int)((total + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(ref, wpw, wpo, out, n, h, w, luma,
                                            pad, y0, hm, wm, wpd);
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

// planes (R, 4, 4, hm, wm) int16 luma phase planes; oy (>= nbh S rows,
// stride wo) int32; mv (nbh nbw, 2) full-pel, ref (nbh nbw,) int32 ->
// out (nbh nbw, 2) quarter-pel int32.
extern "C" int tpuhevc_grid_subpel(const int16_t* planes, const int* oy,
                                   const int* mv, const int* ref, int* out,
                                   int hm, int wm, int nbh, int nbw, int S,
                                   int look, int wo, void* stream) {
    if (S != 8 && S != 16 && S != 32) return (int)cudaErrorInvalidValue;
    subpel_kernel<<<nbh * nbw, kSubpelThreads, 0, (cudaStream_t)stream>>>(
        planes, oy, mv, ref, out, hm, wm, nbw, S, look, wo);
    return (int)cudaGetLastError();
}
