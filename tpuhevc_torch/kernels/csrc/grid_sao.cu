// grid_sao: the grid step's sample adaptive offset of a P picture: its
// statistics, its rate-distortion decision and its apply, three launches.
//
// Replaces: tpuhevc/codec/inter_grid.py:1427-1494 `sao_device`, its
// statistics (`_eo_cat`, `_ctu_sum`, `_cls_hist`, `_sao_stats`,
// :1258-1321), its decision (`_best_eo`, `_eval_eo_all`, `_eval_bo`,
// `_sao_decide_plane`, :1323-1394, and the chroma joint type and the
// picture-level on/off of `sao_device`) and its apply (`_sao_apply_plane`,
// :1396-1425), jnp code that XLA compiled for the TPU inside the grid step.
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
// Decide, float32 in the reference's operation order (built with
// -fmad=false; rintf rounds half to even as jnp.round; IEEE division):
// per CTU and component the best offsets 0-7 of each EO category and its
// cost, the best band offsets and the least of the 29 four-band windows;
// luma picks among OFF, EO0-3 and BO (type bits 2 lambda), chroma one
// type for Cb and Cr by their joint cost at lambda / wch; then the
// picture-level choice among {off, Y, C, Y + C} by the summed costs (in
// XLA CPU's order, ops/grid_sao.py xla_sum2d) plus lambda times the
// merge-flag count. First index among equal minima everywhere. Lambda is
// read through its device pointer: no host sync.
// Apply, per sample: type 0-3 adds {0, o0, o1, -o2, -o3}[category] of
// that class where the category is valid, type 4 adds o[i] at band
// aux + i (i < 4), type -1 nothing; the category and band from the
// unfiltered input; the result clipped to 0..255.
// Row stripes: stats and apply take the deblocked planes of a stripe
// with `top` rows above it and `bot` rows below (0 or 1 each, per plane:
// the neighbouring stripes' edge rows, none at the picture's edges); the
// EO neighbours are valid inside those rows, the CTUs and the outputs are
// the stripe's own rows. top = bot = 0 is the whole picture.
//
// What bounds it: one read of org and rec per sample (stats), one read and
// one write per sample (apply); the decision reads 2 x 3 x 48 ints a CTU;
// launch-bound at these sizes. Design: stats one block per CTU and
// component, the 48 histograms in shared memory (integer atomics: the sums
// do not depend on the order); decide one block, one thread per CTU (the
// picture-level sums by one thread, in order); apply one thread per sample
// of the three components.

#include <cuda_runtime.h>

namespace {

constexpr int kStat = 48;
__constant__ int c_eo_nb[4][4] = {{0, -1, 0, 1},     // (dy0, dx0, dy1, dx1)
                                  {-1, 0, 1, 0},
                                  {-1, -1, 1, 1},
                                  {-1, 1, 1, -1}};
__constant__ int c_cat[5] = {1, 2, 0, 3, 4};

// h own rows; rows lo..hi - 1 readable (lo <= 0, hi >= h: halo rows)
struct Plane {
    const int* p;
    int stride, h, w, lo, hi;
    __device__ int at(int y, int x) const { return p[y * stride + x]; }
};

// EO category of (y, x) for class k, or -1 where a neighbour is outside.
__device__ __forceinline__ int eo_cat(const Plane& r, int y, int x, int k) {
    const int y0 = y + c_eo_nb[k][0], x0 = x + c_eo_nb[k][1];
    const int y1 = y + c_eo_nb[k][2], x1 = x + c_eo_nb[k][3];
    if (y0 < r.lo || y0 >= r.hi || x0 < 0 || x0 >= r.w || y1 < r.lo
        || y1 >= r.hi || x1 < 0 || x1 >= r.w)
        return -1;
    const int v = r.at(y, x);
    const int a = r.at(y0, x0), b = r.at(y1, x1);
    const int et = (v > a) - (v < a) + (v > b) - (v < b);
    return c_cat[et + 2];
}

// component c of the stripe (H own luma rows, `top` / `bot` halo rows of
// each plane): 0 luma, 1 / 2 the halves of the packed plane
__device__ __forceinline__ Plane comp(const int* y, const int* uv, int c,
                                      int H, int W, int top = 0,
                                      int bot = 0) {
    const int wc = W >> 1, hc = H >> 1;
    return c == 0 ? Plane{y + top * W, W, H, W, -top, H + bot}
                  : Plane{uv + top * W + (c - 1) * wc, W, hc, wc, -top,
                          hc + bot};
}

__global__ void sao_stats_kernel(const int* __restrict__ oy,
                                 const int* __restrict__ ouv,
                                 const int* __restrict__ ry,
                                 const int* __restrict__ ruv,
                                 int* __restrict__ cnt_out,
                                 int* __restrict__ sum_out, int H, int W,
                                 int ctu, int nx, int top, int bot) {
    __shared__ int cnt[kStat], sm[kStat];
    const int c = blockIdx.y, n = blockIdx.x;
    const Plane o = comp(oy, ouv, c, H, W);
    const Plane r = comp(ry, ruv, c, H, W, top, bot);
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
                                 int ctu, int ny, int nx, int top, int bot) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int nl = H * W, nc = (H >> 1) * (W >> 1);
    if (t >= nl + 2 * nc) return;
    const int c = t < nl ? 0 : 1 + (t - nl) / nc;
    const int i = c == 0 ? t : (t - nl) % nc;
    const Plane r = comp(ry, ruv, c, H, W, top, bot);
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

constexpr float kSaoInf = 1e18f;
// the most CTUs one decide launch takes: 2 float costs a CTU in the 227
// KiB of shared memory a Hopper block may opt into, less the static s_cfg
constexpr int kSaoDecideMaxCtus = (227 * 1024 - 16) / 8;  // the cost of an offset out of reach

// one EO category: offset 0..start (start = round(sign s / max(c, 1))
// clipped to 0..7) of least c o^2 - 2 o (sign s) + lam (o + 1)
__device__ void best_eo(float c, float s, float lam, float sign, int* off,
                        float* cost) {
    const float ss = sign * s;
    const float start = fminf(fmaxf(rintf(ss / fmaxf(c, 1.0f)), 0.0f), 7.0f);
    int bi = 0;
    float best = 0.0f;
    for (int o = 0; o < 8; ++o) {
        const float ob = (float)o;
        const float d = c * ob * ob - 2.0f * ob * ss;
        const float v = (float)o <= start ? d + lam * (ob + 1.0f) : kSaoInf;
        if (o == 0 || v < best) {
            best = v;
            bi = o;
        }
    }
    *off = bi;
    *cost = best;
}

struct PlaneEval {
    int eo_off[4][4];
    float eo_cost[4];
    int bo_off[4];
    int bo_pos;
    float bo_cost;
};

// one component of one CTU: cnt, sm its 48 statistics
__device__ void eval_plane(const int* cnt, const int* sm, float lam,
                           PlaneEval* e) {
    for (int k = 0; k < 4; ++k) {
        float cs[4];
        for (int cat = 0; cat < 4; ++cat)
            best_eo((float)cnt[4 * k + cat], (float)sm[4 * k + cat], lam,
                    cat < 2 ? 1.0f : -1.0f, &e->eo_off[k][cat], &cs[cat]);
        e->eo_cost[k] = (((cs[0] + cs[1]) + cs[2]) + cs[3]) + lam * 2.0f;
    }
    int bo[32];
    float bc[32];
    for (int b = 0; b < 32; ++b) {
        const float c = (float)cnt[16 + b], s = (float)sm[16 + b];
        const float start = fminf(fmaxf(rintf(s / fmaxf(c, 1.0f)), -7.0f),
                                  7.0f);
        const float sgn = start >= 0.0f ? 1.0f : -1.0f;
        int bi = 0;
        float best = 0.0f;
        for (int m = 0; m < 8; ++m) {
            const float mf = (float)m, o = sgn * mf;
            const float d = c * o * o - 2.0f * o * s;
            float v = mf <= fabsf(start) ? d + lam * (mf + 2.0f) : kSaoInf;
            if (m == 0) v = lam;
            if (m == 0 || v < best) {
                best = v;
                bi = m;
            }
        }
        bo[b] = (int)(sgn * (float)bi);
        bc[b] = best;
    }
    int pos = 0;
    float wbest = 0.0f;
    for (int p = 0; p < 29; ++p) {
        const float w = ((bc[p] + bc[p + 1]) + bc[p + 2]) + bc[p + 3];
        if (p == 0 || w < wbest) {
            wbest = w;
            pos = p;
        }
    }
    for (int i = 0; i < 4; ++i) e->bo_off[i] = bo[pos + i];
    e->bo_pos = pos;
    e->bo_cost = wbest + lam * 5.0f;
}

// first index of the least of n costs
__device__ __forceinline__ int argmin_first(const float* v, int n) {
    int bi = 0;
    for (int i = 1; i < n; ++i)
        if (v[i] < v[bi]) bi = i;
    return bi;
}

// candidate bi (0 off, 1-4 EO class, 5 BO) -> type, aux, offsets
__device__ void select_cand(int bi, const PlaneEval& e, int* type, int* aux,
                            int* off) {
    *type = bi == 0 ? -1 : (bi <= 4 ? bi - 1 : 4);
    *aux = bi == 5 ? e.bo_pos : 0;
    for (int i = 0; i < 4; ++i)
        off[i] = bi == 0 ? 0 : (bi <= 4 ? e.eo_off[bi - 1][i] : e.bo_off[i]);
}

// jnp.sum of the (ny, nx) costs in XLA CPU's order (ops/grid_sao.py
// xla_sum2d): four rows as ((r0 + r2) + (r1 + r3)), one or two rows as
// the row sums in order, else every element in raster order
__device__ float xla_sum2d(const float* v, int ny, int nx) {
    if (ny == 4 || ny <= 2) {
        float r[4];
        for (int y = 0; y < ny; ++y) {
            float acc = v[y * nx];
            for (int x = 1; x < nx; ++x) acc = acc + v[y * nx + x];
            r[y] = acc;
        }
        if (ny == 4) return (r[0] + r[2]) + (r[1] + r[3]);
        return ny == 1 ? r[0] : r[0] + r[1];
    }
    float acc = v[0];
    for (int i = 1; i < ny * nx; ++i) acc = acc + v[i];
    return acc;
}

// write one CTU's row entries: par (3, 6 n) [type | aux | off4] per
// component, prm (17 n) int8 (type_y, aux_y, off_y, type_c, aux_cb,
// off_cb, aux_cr, off_cr)
__global__ void sao_decide_kernel(const int* __restrict__ cnt,
                                  const int* __restrict__ sm,
                                  const float* __restrict__ lam_p, float wch,
                                  int ny, int nx, int* __restrict__ par,
                                  signed char* __restrict__ prm) {
    // the per-CTU costs of the chosen luma and chroma candidates (2 n)
    extern __shared__ float cost[];
    __shared__ int s_cfg;
    const int n = ny * nx;
    const float lam = *lam_p;
    const float lam_c = lam / wch;
    const float lam_c2 = 2.0f * lam_c;
    int* py = par;
    int* pcb = par + 6 * n;
    int* pcr = par + 12 * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        PlaneEval e;
        eval_plane(cnt + (size_t)i * 48, sm + (size_t)i * 48, lam, &e);
        const float tb = 2.0f * lam;
        float cy[6] = {lam, e.eo_cost[0] + tb, e.eo_cost[1] + tb,
                       e.eo_cost[2] + tb, e.eo_cost[3] + tb, e.bo_cost + tb};
        const int by = argmin_first(cy, 6);
        int ty, ay, oy[4];
        select_cand(by, e, &ty, &ay, oy);
        PlaneEval cb, cr;
        eval_plane(cnt + ((size_t)n + i) * 48, sm + ((size_t)n + i) * 48,
                   lam_c, &cb);
        eval_plane(cnt + ((size_t)2 * n + i) * 48,
                   sm + ((size_t)2 * n + i) * 48, lam_c, &cr);
        float cj[6];
        cj[0] = lam_c;
        for (int k = 0; k < 4; ++k)
            cj[1 + k] = ((cb.eo_cost[k] + cr.eo_cost[k]) - lam_c2) + lam_c2;
        cj[5] = (cb.bo_cost + cr.bo_cost) + lam_c2;
        const int bc = argmin_first(cj, 6);
        int tc, acb, ocb[4], acr, ocr[4];
        select_cand(bc, cb, &tc, &acb, ocb);
        select_cand(bc, cr, &tc, &acr, ocr);
        cost[i] = cy[by];
        cost[n + i] = cj[bc];
        py[i] = ty;
        py[n + i] = ay;
        pcb[i] = pcr[i] = tc;
        pcb[n + i] = acb;
        pcr[n + i] = acr;
        for (int j = 0; j < 4; ++j) {
            py[2 * n + 4 * i + j] = oy[j];
            pcb[2 * n + 4 * i + j] = ocb[j];
            pcr[2 * n + 4 * i + j] = ocr[j];
            prm[2 * n + 4 * i + j] = (signed char)oy[j];
            prm[8 * n + 4 * i + j] = (signed char)ocb[j];
            prm[13 * n + 4 * i + j] = (signed char)ocr[j];
        }
        prm[n + i] = (signed char)ay;
        prm[7 * n + i] = (signed char)acb;
        prm[12 * n + i] = (signed char)acr;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const float sum_y = xla_sum2d(cost, ny, nx);
        const float sum_c = xla_sum2d(cost + n, ny, nx);
        const float floor = lam * (float)(ny * (nx - 1) + (ny - 1) * nx);
        const float cfgs[4] = {0.0f, sum_y + floor, sum_c + floor,
                               (sum_y + sum_c) + floor};
        s_cfg = argmin_first(cfgs, 4);
    }
    __syncthreads();
    const bool luma_on = s_cfg == 1 || s_cfg == 3;
    const bool chroma_on = s_cfg == 2 || s_cfg == 3;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ty = luma_on ? py[i] : -1;
        const int tc = chroma_on ? pcb[i] : -1;
        py[i] = ty;
        pcb[i] = pcr[i] = tc;
        prm[i] = (signed char)ty;
        prm[6 * n + i] = (signed char)tc;
    }
}

}  // namespace

// oy (H, W), ouv (H/2, W) packed [U | V] int32 on the device; ry
// (top + H + bot, W), ruv (top + H/2 + bot, W): the deblocked stripe with
// its halo rows -> cnt, sum (3, ny * nx, 48) int32: per component and
// CTU (raster) of the stripe the EO category (4 k + c - 1) and band
// (16 + band) counts and org - rec sums.
extern "C" int tpuhevc_grid_sao_stats(const int* oy, const int* ouv,
                                      const int* ry, const int* ruv, int* cnt,
                                      int* sum, int H, int W, int ctu,
                                      int top, int bot, void* stream) {
    const int ny = (H + ctu - 1) / ctu, nx = (W + ctu - 1) / ctu;
    if (ny * nx == 0) return 0;
    sao_stats_kernel<<<dim3(ny * nx, 3), 256, 0, (cudaStream_t)stream>>>(
        oy, ouv, ry, ruv, cnt, sum, H, W, ctu, nx, top, bot);
    return (int)cudaGetLastError();
}

// ry (top + H + bot, W), ruv (top + H/2 + bot, W) int32; par (3, 6 ny nx)
// int32: per component the stripe's CTUs' types (ny nx), aux (ny nx) and
// offsets (ny nx, 4) -> out_y (H, W), out_uv (H/2, W): the stripe's rows.
extern "C" int tpuhevc_grid_sao_apply(const int* ry, const int* ruv,
                                      const int* par, int* out_y, int* out_uv,
                                      int H, int W, int ctu, int top, int bot,
                                      void* stream) {
    const int ny = (H + ctu - 1) / ctu, nx = (W + ctu - 1) / ctu;
    const int n = H * W + 2 * (H >> 1) * (W >> 1);
    if (n == 0) return 0;
    sao_apply_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        ry, ruv, par, out_y, out_uv, H, W, ctu, ny, nx, top, bot);
    return (int)cudaGetLastError();
}

// cnt, sum (3, ny nx, 48) int32 from tpuhevc_grid_sao_stats; lam the frame
// lambda (one float32 on the device); wch the chroma weight
// 2^((qp - qpc) / 3) (float32) -> par (3, 6 ny nx) int32 as tpuhevc_grid_sao_apply reads it, prm (17 ny nx)
// int8 parameter rows (type_y, aux_y, off_y, type_c, aux_cb, off_cb,
// aux_cr, off_cr), types -1 where the picture-level choice turned a
// component off. One block; its 2 ny nx float costs live in shared
// memory, so ny nx is at most kSaoDecideMaxCtus.
extern "C" int tpuhevc_grid_sao_decide(const int* cnt, const int* sum,
                                       const float* lam, int* par,
                                       signed char* prm, float wch, int ny,
                                       int nx, void* stream) {
    const int n = ny * nx;
    if (n == 0) return 0;
    if (n > kSaoDecideMaxCtus) return (int)cudaErrorInvalidValue;
    const size_t shm = 2 * (size_t)n * sizeof(float);
    if (shm > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            sao_decide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)shm);
        if (err != cudaSuccess) return (int)err;
    }
    sao_decide_kernel<<<1, 256, shm, (cudaStream_t)stream>>>(
        cnt, sum, lam, wch, ny, nx, par, prm);
    return (int)cudaGetLastError();
}
