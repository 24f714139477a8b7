// grid_me: the grid step's motion search, three entry points.
//
// tpuhevc_grid_coarse replaces tpuhevc/codec/inter_grid.py:650
// `coarse_stack` (the +-16 SAD stack on the 2x-pooled level) and the SAD
// half of :2395-2416 `ps_row` (the +-64 prestage on the 4x-pooled level):
// for every offset k = dy * n + dx of the padded pooled reference and
// every tile x tile block of the pooled picture,
//   sad[k][b] = (sum |refp[y + dy][x + dx] - cur[y][x]|) << shift,
//   sum[k][b] =  sum (refp[y + dy][x + dx] - cur[y][x])      (optional).
// One thread per (offset, block), int32 sums as in JAX.
//
// tpuhevc_grid_refine replaces :681-776 `_refine_grid` + `_pick_grids`
// (no MV-rate anchor): per block of size S and each of G start points,
// the 7x7 raw SADs and residual sums of the windows read at clamped
// coordinates (reference row = block row + ry_y0, where `ry` carries
// ry_y0 halo rows above the blocks' first row: a row stripe; stripe_refine
// of tpuhevc/parallel/mesh.py:158-223 reads its halos so, :681-693), the
// DC-aware cost zc(sad, sum, dcc) + ((bits * lam) >> 8) on the inner 5x5
// (the outer ring costs 2^30), the first-index argmin over the G x 49
// candidates in start order, the winner's MV clipped to +-lim, its 3x3 raw-SAD surface and its cost; with quads (S = 16) the
// same pick per 8x8 quadrant from the quadrant partial sums (cost with
// dcc8), written after the nb main rows in 8-grid order.
// bits(mv) = 2 bl(2|4 mvx|) + 2 bl(2|4 mvy|) + 2, bl = bit length, which
// equals the reference's 2 ceil(log2(2a + 1)) on integers.
//
// tpuhevc_grid_wp_me replaces :2352-2362, the weighted full-pel search
// references of explicit weighted prediction (luma): per reference r,
//   out[r][y][x] = clip(((ref[r][y][x] * w[r] + rnd) >> d) + o[r], 0, 255)
// with rnd = (1 << d) >> 1 exactly as the reference rounds it (the
// full-pel special case of weightUnidir, xCalcSADvalueWPOptionalClip).
// One thread per sample, int32 as in JAX; bound by its bytes (a plane
// stack read and written once).
//
// What bounds it: the coarse stack is (2R + 1)^2 tile sums per block, a
// few hundred thousand threads of 16-64 pixels each; the refine reads
// each block's windows from L1/L2 once per candidate. One CUDA block per
// picture block, one thread per (start, point) candidate over the S x S
// pixels, the picks by one thread from shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxG = 8;

__global__ void coarse_kernel(const int* __restrict__ cur,
                              const int* __restrict__ refp,
                              int* __restrict__ sad, int* __restrict__ sum,
                              int h, int w, int n, int tile, int shift) {
    const int nbh = h / tile, nbw = w / tile, nb = nbh * nbw;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)nb * n * n) return;
    const int k = (int)(t / nb), b = (int)(t - (long long)k * nb);
    const int dy = k / n, dx = k - dy * n;
    const int by = b / nbw, bx = b - by * nbw;
    const int wp = w + n - 1;
    int s = 0, d = 0;
    for (int i = 0; i < tile; ++i) {
        const int y = by * tile + i;
        const int* c = cur + (size_t)y * w + bx * tile;
        const int* r = refp + (size_t)(y + dy) * wp + bx * tile + dx;
        for (int j = 0; j < tile; ++j) {
            const int e = r[j] - c[j];
            s += abs(e);
            d += e;
        }
    }
    sad[t] = s << shift;
    if (sum) sum[t] = d;
}

__device__ __forceinline__ int bitlen(int v) {
    return v ? 32 - __clz(v) : 0;
}

__device__ __forceinline__ int zc(int sad, int sdc, int dcc) {
    const int a = abs(sdc);
    return sad - a + min(a, dcc);
}

// sel: per-candidate selection costs, cand: per-candidate raw SADs
// (stride 1), both over G*49 entries -> out rows
__device__ void pick(const int* cost, const int* sad, const int* mvx,
                     const int* mvy, int n, int lim, int* mv_out,
                     int* sad9_out, int* cost_out) {
    int bi = 0, best = cost[0];
    for (int i = 1; i < n; ++i)
        if (cost[i] < best) {
            best = cost[i];
            bi = i;
        }
    const int base = (bi / 49) * 49, k = bi - base;
    const int bdy = k / 7, bdx = k - bdy * 7;
    for (int q = 0; q < 9; ++q)
        sad9_out[q] = sad[base + (bdy + q / 3 - 1) * 7 + bdx + q % 3 - 1];
    mv_out[0] = min(max(mvx[bi], -lim), lim);
    mv_out[1] = min(max(mvy[bi], -lim), lim);
    *cost_out = best;
}

__global__ void refine_kernel(const int* __restrict__ ry,
                              const int* __restrict__ oy,
                              const int* __restrict__ starts,
                              int* __restrict__ mv_out,
                              int* __restrict__ sad9_out,
                              int* __restrict__ cost_out, int hr, int wr,
                              int wo, int S, int nbh, int nbw, int G,
                              int quads, int dcc, int dcc8, int lam, int lim,
                              int ry_y0) {
    extern __shared__ int sm[];
    const int nb = nbh * nbw, nc = G * 49, nq = quads ? 4 : 0;
    int* cur = sm;                  // S x S
    int* s_sad = cur + S * S;       // nc
    int* s_cost = s_sad + nc;       // nc
    int* s_mvx = s_cost + nc;       // nc
    int* s_mvy = s_mvx + nc;        // nc
    int* q_sad = s_mvy + nc;        // 4 x nc
    int* q_cost = q_sad + 4 * nc;   // 4 x nc
    const int b = blockIdx.x;
    const int by = b / nbw, bx = b - by * nbw;
    const int y0 = by * S, x0 = bx * S;
    for (int e = threadIdx.x; e < S * S; e += blockDim.x)
        cur[e] = oy[(size_t)(y0 + e / S) * wo + x0 + e % S];
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += blockDim.x) {
        const int g = c / 49, k = c - g * 49;
        const int dy = k / 7, dx = k - dy * 7;
        const int cx = starts[((size_t)g * nb + b) * 2];
        const int cy = starts[((size_t)g * nb + b) * 2 + 1];
        int qs[4] = {0, 0, 0, 0}, qd[4] = {0, 0, 0, 0};
        for (int i = 0; i < S; ++i) {
            const int yy = min(max(y0 + cy - 3 + dy + i + ry_y0, 0),
                               hr - 1);
            const int* row = ry + (size_t)yy * wr;
            const int qy = (i >> 3) & 1;
            for (int j = 0; j < S; ++j) {
                const int xx = min(max(x0 + cx - 3 + dx + j, 0), wr - 1);
                const int e = row[xx] - cur[i * S + j];
                const int q = quads ? qy * 2 + ((j >> 3) & 1) : 0;
                qs[q] += abs(e);
                qd[q] += e;
            }
        }
        const int sad = qs[0] + qs[1] + qs[2] + qs[3];
        const int sdc = qd[0] + qd[1] + qd[2] + qd[3];
        const int mvx = cx + dx - 3, mvy = cy + dy - 3;
        const int rate = ((2 * bitlen(2 * abs(4 * mvx))
                           + 2 * bitlen(2 * abs(4 * mvy)) + 2) * lam) >> 8;
        const bool inner = abs(dx - 3) <= 2 && abs(dy - 3) <= 2;
        s_sad[c] = sad;
        s_cost[c] = inner ? zc(sad, sdc, dcc) + rate : kBig;
        s_mvx[c] = mvx;
        s_mvy[c] = mvy;
        for (int q = 0; q < nq; ++q) {
            q_sad[q * nc + c] = qs[q];
            q_cost[q * nc + c] = inner ? zc(qs[q], qd[q], dcc8) + rate : kBig;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        pick(s_cost, s_sad, s_mvx, s_mvy, nc, lim, mv_out + 2 * b,
             sad9_out + 9 * b, cost_out + b);
    } else if (threadIdx.x <= nq) {
        const int q = threadIdx.x - 1;
        const int row = nb + (2 * by + (q >> 1)) * (2 * nbw) + 2 * bx
                        + (q & 1);
        pick(q_cost + q * nc, q_sad + q * nc, s_mvx, s_mvy, nc, lim,
             mv_out + 2 * row, sad9_out + 9 * row, cost_out + row);
    }
}

}  // namespace

// cur (h, w), refp (h + n - 1, w + n - 1) int32 on the device -> sad,
// sum (optional, may be null) (n * n, h / tile, w / tile) int32.
extern "C" int tpuhevc_grid_coarse(const int* cur, const int* refp, int* sad,
                                   int* sum, int h, int w, int n, int tile,
                                   int shift, void* stream) {
    const long long total = (long long)n * n * (h / tile) * (w / tile);
    const int threads = 256;
    const int blocks = (int)((total + threads - 1) / threads);
    coarse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        cur, refp, sad, sum, h, w, n, tile, shift);
    return (int)cudaGetLastError();
}

// ry (hr, wr), oy (>= nbh S, row stride wo) int32; starts (G, nb, 2)
// int32 full-pel centres; ry_y0 the row of ry that lies level with oy's
// row 0 -> mv (nb (+4 nb), 2), sad9 (nb (+4 nb), 9), cost (nb (+4 nb))
// int32; the quadrant rows (quads, S = 16) follow the nb main rows in
// 8-grid order.
extern "C" int tpuhevc_grid_refine(const int* ry, const int* oy,
                                   const int* starts, int* mv, int* sad9,
                                   int* cost, int hr, int wr, int wo, int S,
                                   int nbh, int nbw, int G, int quads,
                                   int dcc, int dcc8, int lam, int lim,
                                   int ry_y0, void* stream) {
    if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
    const int nc = G * 49;
    const size_t smem = sizeof(int) * ((size_t)S * S + 12 * nc);
    refine_kernel<<<nbh * nbw, 256, smem, (cudaStream_t)stream>>>(
        ry, oy, starts, mv, sad9, cost, hr, wr, wo, S, nbh, nbw, G, quads,
        dcc, dcc8, lam, lim, ry_y0);
    return (int)cudaGetLastError();
}

namespace {

__global__ void wp_me_kernel(const int* __restrict__ ref,
                             const int* __restrict__ w,
                             const int* __restrict__ o, int* __restrict__ out,
                             int n, int hw, int d) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * hw) return;
    const int r = (int)(t / hw);
    const int rnd = (1 << d) >> 1;
    out[t] = min(max(((ref[t] * w[r] + rnd) >> d) + o[r], 0), 255);
}

}  // namespace

// ref (n, h, w) int32, w and o (n,) int32, 0 <= d < 31 -> out (n, h, w)
// int32.
extern "C" int tpuhevc_grid_wp_me(const int* ref, const int* w, const int* o,
                                  int* out, int n, int h, int wd, int d,
                                  void* stream) {
    const long long total = (long long)n * h * wd;
    const int threads = 256;
    wp_me_kernel<<<(int)((total + threads - 1) / threads), threads, 0,
                   (cudaStream_t)stream>>>(ref, w, o, out, n, h * wd, d);
    return (int)cudaGetLastError();
}
