// grid_sao: the grid step's sample adaptive offset of a P picture, its two
// per-sample passes.
//
// Replaces: tpuhevc/codec/inter_grid.py:1427-1494 `sao_device`, its
// statistics (`_eo_cat`, `_ctu_sum`, `_cls_hist`, `_sao_stats`,
// :1258-1321) and its apply (`_sao_apply_plane`, :1396-1425), jnp code
// that XLA compiled for the TPU inside the grid step. The per-CTU
// decision between them stays torch glue (tpuhevc_torch/ops/grid_sao.py).
//
// Stats, per CTU of each component (luma CTUs of `ctu` samples, chroma of
// ctu / 2 in each half of the packed [U | V] plane), on the deblocked
// picture: for each EO class k (0: horizontal, 1: vertical, 2: 135
// degrees, 3: 45 degrees; ops/sao.py EO_NEIGHBORS), the category
// c = {1, 2, 0, 3, 4}[sign(r - n0) + sign(r - n1) + 2] of each sample whose
// two neighbours lie inside the picture; the count and the sum of
// org - rec of each category 1-4 (index 4 k + c - 1) and of each band
// rec >> 3 (index 16 + band). int32 sums: exact, as the reference's
// float32 sums are (|sum| <= 64 * 64 * 255 < 2^24).
// Apply, per sample: type 0-3 adds {0, o0, o1, -o2, -o3}[category] of
// that class where the category is valid, type 4 adds o[i] at band
// aux + i (i < 4), type -1 nothing; the category and band from the
// unfiltered input; the result clipped to 0..255.
//
// What bounds it: one read of org and rec per sample (stats), one read and
// one write per sample (apply); launch-bound at these sizes. Design: stats
// one block per CTU and component, the 48 histograms in shared memory
// (integer atomics: the sums do not depend on the order); apply one thread
// per sample of the three components.

#include <cuda_runtime.h>

namespace {

constexpr int kStat = 48;
__constant__ int c_eo_nb[4][4] = {{0, -1, 0, 1},     // (dy0, dx0, dy1, dx1)
                                  {-1, 0, 1, 0},
                                  {-1, -1, 1, 1},
                                  {-1, 1, 1, -1}};
__constant__ int c_cat[5] = {1, 2, 0, 3, 4};

struct Plane {
    const int* p;
    int stride, h, w;
    __device__ int at(int y, int x) const { return p[y * stride + x]; }
};

// EO category of (y, x) for class k, or -1 where a neighbour is outside.
__device__ __forceinline__ int eo_cat(const Plane& r, int y, int x, int k) {
    const int y0 = y + c_eo_nb[k][0], x0 = x + c_eo_nb[k][1];
    const int y1 = y + c_eo_nb[k][2], x1 = x + c_eo_nb[k][3];
    if (y0 < 0 || y0 >= r.h || x0 < 0 || x0 >= r.w || y1 < 0 || y1 >= r.h
        || x1 < 0 || x1 >= r.w)
        return -1;
    const int v = r.at(y, x);
    const int a = r.at(y0, x0), b = r.at(y1, x1);
    const int et = (v > a) - (v < a) + (v > b) - (v < b);
    return c_cat[et + 2];
}

// component c of the picture: 0 luma, 1 / 2 the halves of the packed plane
__device__ __forceinline__ Plane comp(const int* y, const int* uv, int c,
                                      int H, int W) {
    const int wc = W >> 1;
    return c == 0 ? Plane{y, W, H, W}
                  : Plane{uv + (c - 1) * wc, W, H >> 1, wc};
}

__global__ void sao_stats_kernel(const int* __restrict__ oy,
                                 const int* __restrict__ ouv,
                                 const int* __restrict__ ry,
                                 const int* __restrict__ ruv,
                                 int* __restrict__ cnt_out,
                                 int* __restrict__ sum_out, int H, int W,
                                 int ctu, int nx) {
    __shared__ int cnt[kStat], sm[kStat];
    const int c = blockIdx.y, n = blockIdx.x;
    const Plane o = comp(oy, ouv, c, H, W), r = comp(ry, ruv, c, H, W);
    const int cs = c == 0 ? ctu : ctu >> 1;
    const int y0 = (n / nx) * cs, x0 = (n % nx) * cs;
    const int hh = min(cs, r.h - y0), ww = min(cs, r.w - x0);
    for (int i = threadIdx.x; i < kStat; i += blockDim.x) {
        cnt[i] = 0;
        sm[i] = 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < hh * ww; i += blockDim.x) {
        const int y = y0 + i / ww, x = x0 + i % ww;
        const int v = r.at(y, x), d = o.at(y, x) - v;
        for (int k = 0; k < 4; ++k) {
            const int cat = eo_cat(r, y, x, k);
            if (cat > 0) {
                atomicAdd(&cnt[4 * k + cat - 1], 1);
                atomicAdd(&sm[4 * k + cat - 1], d);
            }
        }
        atomicAdd(&cnt[16 + (v >> 3)], 1);
        atomicAdd(&sm[16 + (v >> 3)], d);
    }
    __syncthreads();
    const size_t base = ((size_t)c * gridDim.x + n) * kStat;
    for (int i = threadIdx.x; i < kStat; i += blockDim.x) {
        cnt_out[base + i] = cnt[i];
        sum_out[base + i] = sm[i];
    }
}

__global__ void sao_apply_kernel(const int* __restrict__ ry,
                                 const int* __restrict__ ruv,
                                 const int* __restrict__ par,
                                 int* __restrict__ out_y,
                                 int* __restrict__ out_uv, int H, int W,
                                 int ctu, int ny, int nx) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int nl = H * W, nc = (H >> 1) * (W >> 1);
    if (t >= nl + 2 * nc) return;
    const int c = t < nl ? 0 : 1 + (t - nl) / nc;
    const int i = c == 0 ? t : (t - nl) % nc;
    const Plane r = comp(ry, ruv, c, H, W);
    const int y = i / r.w, x = i % r.w;
    const int cs = c == 0 ? ctu : ctu >> 1;
    const int nctu = ny * nx;
    const int ci = min(y / cs, ny - 1) * nx + min(x / cs, nx - 1);
    const int* p = par + (size_t)c * 6 * nctu;  // type, aux, off4 rows
    const int type = p[ci], aux = p[nctu + ci];
    const int* off = p + 2 * nctu + 4 * ci;
    const int v = r.at(y, x);
    int add = 0;
    if (type >= 0 && type < 4) {
        const int cat = eo_cat(r, y, x, type);
        if (cat > 0) add = cat <= 2 ? off[cat - 1] : -off[cat - 1];
    } else if (type == 4) {
        const int rel = ((v >> 3) - aux) & 31;
        if (rel < 4) add = off[rel];
    }
    const int o = min(max(v + add, 0), 255);
    if (c == 0)
        out_y[y * W + x] = o;
    else
        out_uv[y * W + (c - 1) * (W >> 1) + x] = o;
}

}  // namespace

// oy, ry (H, W), ouv, ruv (H/2, W) packed [U | V] int32 on the device ->
// cnt, sum (3, ny * nx, 48) int32: per component and CTU (raster) the EO
// category (4 k + c - 1) and band (16 + band) counts and org - rec sums.
extern "C" int tpuhevc_grid_sao_stats(const int* oy, const int* ouv,
                                      const int* ry, const int* ruv, int* cnt,
                                      int* sum, int H, int W, int ctu,
                                      void* stream) {
    const int ny = (H + ctu - 1) / ctu, nx = (W + ctu - 1) / ctu;
    if (ny * nx == 0) return 0;
    sao_stats_kernel<<<dim3(ny * nx, 3), 256, 0, (cudaStream_t)stream>>>(
        oy, ouv, ry, ruv, cnt, sum, H, W, ctu, nx);
    return (int)cudaGetLastError();
}

// ry (H, W), ruv (H/2, W) int32; par (3, 6 ny nx) int32: per component the
// CTUs' types (ny nx), aux (ny nx) and offsets (ny nx, 4) -> out_y, out_uv
// of the same shapes as ry, ruv.
extern "C" int tpuhevc_grid_sao_apply(const int* ry, const int* ruv,
                                      const int* par, int* out_y, int* out_uv,
                                      int H, int W, int ctu, void* stream) {
    const int ny = (H + ctu - 1) / ctu, nx = (W + ctu - 1) / ctu;
    const int n = H * W + 2 * (H >> 1) * (W >> 1);
    if (n == 0) return 0;
    sao_apply_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        ry, ruv, par, out_y, out_uv, H, W, ctu, ny, nx);
    return (int)cudaGetLastError();
}
