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
// What bounds it: one read of org and rec per sample (stats: 1,198,080
// bytes at 416x240, 0.00036 ms at 3.35 TB/s), one read and one write per
// sample (apply); the decision reads 2 x 3 x 48 ints a CTU; launch-bound
// at these sizes. Design: stats a cluster of blocks a CTU (Hopper's thread
// block clusters), so that every SM takes one (168 blocks at 416x240, CTU
// 64): at CTU 64 four blocks of 16 luma rows each, one for Cb, one for Cr;
// at CTU 32 and 16 one each. A block stages its tile of the deblocked
// plane (at most 1,024 samples) with its one-sample halo ring in shared
// memory as int16, once; a thread takes a run of 4 samples of one row (one
// 16-byte load of org and of rec; rows and columns from the thread index,
// no division a sample), reads its 3 x 6 window of the staged tile, and
// finds each neighbour's validity from the tile's position and the
// stripe's readable rows. No atomics: a sample's count and org - rec sum
// go packed into one int ((count << 16) + sum; a thread's 4 samples keep
// |sum| <= 1,020), the 16 EO bins in registers, the 32 bands in a column
// of shared memory of the thread's own (conflict-free, whatever the
// content: a flat picture whose samples all fall in one band costs what
// noise does); the block unpacks and sums them by warp reductions. The
// luma bands of a CTU meet through distributed shared memory (each writes
// its 96 values into the first block's, one cluster barrier, the first
// block adds them), so that every bin of every CTU is written once, by one
// launch. Apply: a thread a run of 4 samples of a row (a 2-D grid over
// the W-wide luma rows, then the packed [U | V] rows), its run, the runs
// above and below and the six edge samples loaded with its CTU's type,
// aux and offsets in one round (the CTU by shifts), one 16-byte store; no
// division a sample. Decide: a
// warp a (CTU, component), a few CTUs a block (so that a picture's CTUs
// spread over the SMs): lanes 0-15 the 16 EO (class,
// category) pairs, lane b band b, lane p < 29 window p from shuffles in
// the serial sum's order, the first-index argmins as warp reductions of
// (cost, index); a CTU's three warps meet in shared memory for the joint
// chroma cost and its type; the chosen costs go to a global scratch, and
// the last block to finish (a ticket, left at zero) takes the picture's
// sums (rows in parallel where XLA's order allows) and its choice, and
// turns the types of the components it leaves off to -1: one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kStat = 48;
constexpr unsigned kFull = 0xffffffffu;
// h own rows; rows lo..hi - 1 readable (lo <= 0, hi >= h: halo rows)
struct Plane {
    const int* p;
    int stride, h, w, lo, hi;
    __device__ int at(int y, int x) const { return p[y * stride + x]; }
};

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

constexpr int kStatThreads = 256;  // a stats block: a tile of <= 1,024
constexpr int kPitch = 68;  // staged row: <= 64 samples and the 2 halo
constexpr int kStageRows = 34;  // staged rows: <= 32 and the 2 halo

// the tile's sample (y, x) of plane r, or 0 outside its readable rows and
// columns (where no category that reads it is valid)
__device__ __forceinline__ short halo_at(const Plane& r, int y, int x) {
    return (y >= r.lo && y < r.hi && x >= 0 && x < r.w) ? (short)r.at(y, x)
                                                          : (short)0;
}

// one EO class at one sample: e[c - 1] += pk for its category c (1..4)
// where ok (both neighbours a, b inside), in registers (e constant-indexed)
__device__ __forceinline__ void add_eo(int* e, int v, int a, int b, bool ok,
                                       int pk) {
    const int et = (v > a) - (v < a) + (v > b) - (v < b);
    const int add = ok ? pk : 0;
    e[0] += et == -2 ? add : 0;  // category 1
    e[1] += et == -1 ? add : 0;  // 2
    e[2] += et == 1 ? add : 0;   // 3
    e[3] += et == 2 ? add : 0;   // 4
}

// a packed (count << 16) + sum -> (count, sum); |sum| < 2^15
__device__ __forceinline__ int2 unpack(int pk) {
    const int s = (short)(pk & 0xFFFF);
    return make_int2((pk - s) >> 16, s);
}

// Cluster (lb + 2 blocks) = one CTU of the stripe: blocks 0..lb-1 its
// luma rows in bands of ctu / lb, block lb its Cb, lb + 1 its Cr.
__global__ void __launch_bounds__(kStatThreads)
    sao_stats_kernel(const int* __restrict__ oy, const int* __restrict__ ouv,
                     const int* __restrict__ ry, const int* __restrict__ ruv,
                     int* __restrict__ cnt_out, int* __restrict__ sum_out,
                     int H, int W, int ctu, int lb, int top, int bot) {
    __shared__ short s_rec[kStageRows * kPitch];
    __shared__ int s_band[32 * kStatThreads];  // a column a thread
    __shared__ int s_eo[kStatThreads / 32][32];
    __shared__ int s_res[2 * kStat];  // the block's 48 counts, 48 sums
    __shared__ int s_part[4][2 * kStat];  // block 0: the luma bands' s_res
    cg::cluster_group cl = cg::this_cluster();
    const int rank = blockIdx.x, cx = blockIdx.y, cy = blockIdx.z;
    const int c = rank < lb ? 0 : rank - lb + 1;
    const Plane o = comp(oy, ouv, c, H, W);
    const Plane r = comp(ry, ruv, c, H, W, top, bot);
    const int cs = c == 0 ? ctu : ctu >> 1;
    const int bh = c == 0 ? ctu / lb : cs;  // the block's rows
    const int y0 = cy * cs + (c == 0 ? rank * bh : 0), x0 = cx * cs;
    const int th = min(bh, r.h - y0), ww = min(cs, r.w - x0);
    // thread t: the run of 4 samples at column 4 q of the tile's row rr
    const int lsh = __ffs(cs) - 3;  // log2 of the runs a CTU row, cs / 4
    const int t = threadIdx.x, q = t & ((1 << lsh) - 1), rr = t >> lsh;
    const bool act = rr < th && 4 * q < ww;
    const int y = y0 + rr, x = x0 + 4 * q;
#pragma unroll
    for (int b = 0; b < 32; ++b) s_band[b * kStatThreads + t] = 0;
    int4 ov = make_int4(0, 0, 0, 0);
    if (act) {
        ov = __ldg(reinterpret_cast<const int4*>(o.p + y * o.stride + x));
        const int4 rv =
            __ldg(reinterpret_cast<const int4*>(r.p + y * r.stride + x));
        short* sr = s_rec + (rr + 1) * kPitch + 4 * q + 1;
        sr[0] = (short)rv.x;
        sr[1] = (short)rv.y;
        sr[2] = (short)rv.z;
        sr[3] = (short)rv.w;
    }
    if (th > 0) {  // the one-sample ring around the tile
        if (t < ww + 2) {
            s_rec[t] = halo_at(r, y0 - 1, x0 - 1 + t);
            s_rec[(th + 1) * kPitch + t] = halo_at(r, y0 + th, x0 - 1 + t);
        }
        if (t < th) {
            s_rec[(t + 1) * kPitch] = halo_at(r, y0 + t, x0 - 1);
            s_rec[(t + 1) * kPitch + ww + 1] = halo_at(r, y0 + t, x0 + ww);
        }
    }
    __syncthreads();
    // EO (class k, category c) at 4 k + c - 1: packed counts and sums
    int eo[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) eo[i] = 0;
    if (act) {
        int wn[3][6];  // rows y - 1..y + 1, columns x - 1..x + 4
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j)
                wn[i][j] = s_rec[(rr + i) * kPitch + 4 * q + j];
        // the neighbours' validity, from the tile's position: rows lo..hi-1
        // and columns 0..w-1 readable
        const bool vv = y > r.lo && y < r.hi - 1;
        const int od[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int v = wn[1][j + 1];
            const int pk = 65536 + od[j] - v;
            s_band[((v >> 3) & 31) * kStatThreads + t] += pk;
            const bool hv = x + j > 0 && x + j < r.w - 1;
            add_eo(eo, v, wn[1][j], wn[1][j + 2], hv, pk);
            add_eo(eo + 4, v, wn[0][j + 1], wn[2][j + 1], vv, pk);
            add_eo(eo + 8, v, wn[0][j], wn[2][j + 2], hv && vv, pk);
            add_eo(eo + 12, v, wn[0][j + 2], wn[2][j], hv && vv, pk);
        }
    }
    __syncthreads();
    const int lane = t & 31, warp = t >> 5;
    // the bands: warp w sums bands 4 w..4 w + 3 over the threads' columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int b = 4 * warp + i;
        int2 a = make_int2(0, 0);
#pragma unroll
        for (int k = 0; k < kStatThreads / 32; ++k) {
            const int2 u = unpack(s_band[b * kStatThreads + lane + 32 * k]);
            a.x += u.x;
            a.y += u.y;
        }
        a.x = __reduce_add_sync(kFull, a.x);
        a.y = __reduce_add_sync(kFull, a.y);
        if (lane == 0) {
            s_res[16 + b] = a.x;
            s_res[kStat + 16 + b] = a.y;
        }
    }
    // the EO bins: each warp's, then the block's
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const int2 u = unpack(eo[i]);
        const int n = __reduce_add_sync(kFull, u.x);
        const int sm = __reduce_add_sync(kFull, u.y);
        if (lane == 0) {
            s_eo[warp][i] = n;
            s_eo[warp][16 + i] = sm;
        }
    }
    __syncthreads();
    if (t < 32) {
        int a = 0;
#pragma unroll
        for (int k = 0; k < kStatThreads / 32; ++k) a += s_eo[k][t];
        s_res[t < 16 ? t : kStat + t - 16] = a;
    }
    __syncthreads();
    // the CTU's luma bands meet in block 0: each writes its 96 values into
    // block 0's shared memory (distributed shared memory), one cluster
    // barrier, block 0 adds them; Cb and Cr write their own
    const size_t base = ((size_t)c * gridDim.y * gridDim.z
                         + (size_t)cy * gridDim.y + cx) * kStat;
    if (c == 0) {
        int* dst = cl.map_shared_rank(&s_part[0][0], 0);
        if (t < 2 * kStat) dst[rank * 2 * kStat + t] = s_res[t];
    } else if (t < kStat) {
        cnt_out[base + t] = s_res[t];
    } else if (t < 2 * kStat) {
        sum_out[base + t - kStat] = s_res[t];
    }
    cl.sync();
    if (rank == 0 && t < 2 * kStat) {
        int v = 0;
        for (int k = 0; k < lb; ++k) v += s_part[k][t];
        if (t < kStat)
            cnt_out[base + t] = v;
        else
            sum_out[base + t - kStat] = v;
    }
}

constexpr int kApplyX = 16, kApplyY = 8;  // an apply block: runs x rows

// the offset of a sample v between neighbours a and b (EO) where ok
__device__ __forceinline__ int eo_add(int v, int a, int b, bool ok,
                                      int4 off) {
    const int et = (v > a) - (v < a) + (v > b) - (v < b);
    const int add = et == -2 ? off.x : et == -1 ? off.y
                  : et == 1 ? -off.z : et == 2 ? -off.w : 0;
    return ok ? add : 0;
}

// A thread a run of 4 samples of one row: luma rows 0..H-1, then the
// packed chroma rows (a run never straddles U and V: W / 2 is a multiple
// of 8); the run, the runs above and below and the six edge samples are
// loaded with the CTU's type, aux and offsets in one round, one 16-byte
// store.
__global__ void __launch_bounds__(kApplyX* kApplyY)
    sao_apply_kernel(const int* __restrict__ ry, const int* __restrict__ ruv,
                     const int* __restrict__ par, int* __restrict__ out_y,
                     int* __restrict__ out_uv, int H, int W, int lc, int nx,
                     int nctu, int top, int bot) {
    const int X = 4 * (blockIdx.x * kApplyX + threadIdx.x);
    const int yy = blockIdx.y * kApplyY + threadIdx.y;
    const int hc = H >> 1, wc = W >> 1;
    if (X >= W || yy >= H + hc) return;
    const bool luma = yy < H;
    const int y = luma ? yy : yy - H;
    const int c = luma ? 0 : X < wc ? 1 : 2;
    const int x = c == 2 ? X - wc : X;  // the column in the component
    const int cw = luma ? W : wc, lo = -top, hi = (luma ? H : hc) + bot;
    const int* row = (luma ? ry : ruv) + (top + y) * W + X;
    const int* ra = row - (y > lo ? W : 0);
    const int* rb = row + (y < hi - 1 ? W : 0);
    const int dl = x > 0 ? -1 : 0, dr = x + 4 < cw ? 4 : 3;
    const int l = luma ? lc : lc - 1;
    const int* p = par + c * 6 * nctu;
    const int ci = (y >> l) * nx + (x >> l);
    const int4 v = __ldg(reinterpret_cast<const int4*>(row));
    const int4 va = __ldg(reinterpret_cast<const int4*>(ra));
    const int4 vb = __ldg(reinterpret_cast<const int4*>(rb));
    const int cl = __ldg(row + dl), cr = __ldg(row + dr);
    const int al = __ldg(ra + dl), ar = __ldg(ra + dr);
    const int bl = __ldg(rb + dl), br = __ldg(rb + dr);
    const int type = __ldg(p + ci), aux = __ldg(p + nctu + ci);
    const int* po = p + 2 * nctu + 4 * ci;
    const int4 off = make_int4(__ldg(po), __ldg(po + 1), __ldg(po + 2),
                               __ldg(po + 3));
    // rows y - 1, y, y + 1 at columns x - 1 .. x + 4
    const int C[6] = {cl, v.x, v.y, v.z, v.w, cr};
    const int A[6] = {al, va.x, va.y, va.z, va.w, ar};
    const int Bw[6] = {bl, vb.x, vb.y, vb.z, vb.w, br};
    const bool vv = y > lo && y < hi - 1;
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int s = C[j + 1];
        const bool hv = x + j > 0 && x + j < cw - 1;
        int add = 0;
        if (type == 0)
            add = eo_add(s, C[j], C[j + 2], hv, off);
        else if (type == 1)
            add = eo_add(s, A[j + 1], Bw[j + 1], vv, off);
        else if (type == 2)
            add = eo_add(s, A[j], Bw[j + 2], hv && vv, off);
        else if (type == 3)
            add = eo_add(s, A[j + 2], Bw[j], hv && vv, off);
        else if (type == 4) {
            const int rel = ((s >> 3) - aux) & 31;
            add = rel == 0 ? off.x : rel == 1 ? off.y : rel == 2 ? off.z
                : rel == 3 ? off.w : 0;
        }
        o[j] = min(max(s + add, 0), 255);
    }
    *reinterpret_cast<int4*>((luma ? out_y : out_uv) + y * W + X) =
        make_int4(o[0], o[1], o[2], o[3]);
}

constexpr float kSaoInf = 1e18f;  // the cost of an offset out of reach
// the most CTUs a decide block takes (three warps each); the costs the
// last block stages in shared memory at a time (Y and chroma, half each)
constexpr int kDecideCtus = 8, kStage = 2048;

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

// one band of 32: offset sign m, m = 0..|start| (start = round(s / max(c,
// 1)) clipped to -7..7), of least c o^2 - 2 o s + lam (m + 2); lam at 0
__device__ void best_bo(float c, float s, float lam, int* off, float* cost) {
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
    *off = (int)(sgn * (float)bi);
    *cost = best;
}

// the first index of the least of (v, i) over the warp (every lane gets it)
__device__ __forceinline__ int warp_argmin(float v, int i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oi = __shfl_xor_sync(kFull, i, o);
        if (ov < v || (ov == v && oi < i)) {
            v = ov;
            i = oi;
        }
    }
    return i;
}

// first index of the least of n costs
__device__ __forceinline__ int argmin_first(const float* v, int n) {
    int bi = 0;
    for (int i = 1; i < n; ++i)
        if (v[i] < v[bi]) bi = i;
    return bi;
}

// one component of one CTU, by one warp (every lane must call it): cnt,
// sm its 48 statistics -> every lane holds its EO class costs eo[4] and
// the band cost; lane l < 16 its EO offset (class l / 4, category l % 4),
// lane b its band's offset; pos the least four-band window
struct WarpEval {
    float eo[4], bo_cost;
    int eo_off, bo_off, pos;
};

__device__ WarpEval eval_warp(const int* cnt, const int* sm, float lam,
                              int lane) {
    WarpEval e;
    float ec = 0.0f;
    e.eo_off = 0;
    if (lane < 16)
        best_eo((float)cnt[lane], (float)sm[lane], lam,
                (lane & 3) < 2 ? 1.0f : -1.0f, &e.eo_off, &ec);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float c0 = __shfl_sync(kFull, ec, 4 * k),
                    c1 = __shfl_sync(kFull, ec, 4 * k + 1),
                    c2 = __shfl_sync(kFull, ec, 4 * k + 2),
                    c3 = __shfl_sync(kFull, ec, 4 * k + 3);
        e.eo[k] = (((c0 + c1) + c2) + c3) + lam * 2.0f;
    }
    float bc;
    best_bo((float)cnt[16 + lane], (float)sm[16 + lane], lam, &e.bo_off,
            &bc);
    // window p: bands p..p + 3, summed left to right
    const float b1 = __shfl_down_sync(kFull, bc, 1),
                b2 = __shfl_down_sync(kFull, bc, 2),
                b3 = __shfl_down_sync(kFull, bc, 3);
    const float win = lane < 29 ? ((bc + b1) + b2) + b3 : INFINITY;
    e.pos = warp_argmin(win, lane);
    e.bo_cost = __shfl_sync(kFull, win, e.pos) + lam * 5.0f;
    return e;
}

// lane j < 4's offset j of candidate bi (0 off, 1-4 EO class, 5 BO)
__device__ __forceinline__ int cand_off(const WarpEval& e, int bi,
                                        int lane) {
    const int j = lane & 3;
    const int eo = __shfl_sync(kFull, e.eo_off, (4 * (bi - 1) + j) & 31);
    const int bo = __shfl_sync(kFull, e.bo_off, (e.pos + j) & 31);
    return bi == 0 ? 0 : (bi <= 4 ? eo : bo);
}

// Per CTU (cpb a block, three warps each: Y, Cb, Cr) the component's best
// EO and BO offsets and costs; the luma type by the luma warp, the chroma
// type by both chroma warps from the joint cost; par (3, 6 n) [type | aux
// | off4] per component and prm (17 n) int8 (type_y, aux_y, off_y,
// type_c, aux_cb, off_cb, aux_cr, off_cr) written, the chosen costs into
// cost (2 n). The last block (a ticket, left at zero) sums the costs in
// xla_sum2d's order, picks among {off, Y, C, Y + C} and turns the types
// of the components it leaves off to -1.
__global__ void sao_decide_kernel(const int* __restrict__ cnt,
                                  const int* __restrict__ sm,
                                  const float* __restrict__ lam_p, float wch,
                                  int ny, int nx, int cpb,
                                  int* __restrict__ par,
                                  signed char* __restrict__ prm,
                                  float* __restrict__ cost,
                                  int* __restrict__ ticket) {
    // the chroma warps' EO class and band costs, per CTU of the block
    __shared__ float s_c[kDecideCtus][2][5];
    __shared__ float s_cost[kStage];
    __shared__ float s_rows[2][4];
    __shared__ int s_cfg, s_last;
    const int n = ny * nx;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int slot = warp / 3, comp = warp % 3;
    const int i = blockIdx.x * cpb + slot;
    const bool live = i < n;
    const float lam = *lam_p;
    const float lam_c = lam / wch;
    const float lam_c2 = 2.0f * lam_c;
    WarpEval e;
    if (live) {
        const size_t base = ((size_t)comp * n + i) * 48;
        e = eval_warp(cnt + base, sm + base, comp ? lam_c : lam, lane);
        if (comp && lane == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) s_c[slot][comp - 1][k] = e.eo[k];
            s_c[slot][comp - 1][4] = e.bo_cost;
        }
    }
    __syncthreads();
    if (live) {
        int* p = par + (size_t)comp * 6 * n;
        int bi;
        if (comp == 0) {
            const float tb = 2.0f * lam;
            const float cy[6] = {lam, e.eo[0] + tb, e.eo[1] + tb,
                                 e.eo[2] + tb, e.eo[3] + tb,
                                 e.bo_cost + tb};
            bi = argmin_first(cy, 6);
            if (lane == 0) cost[i] = cy[bi];
        } else {
            const float* cb = s_c[slot][0];
            const float* cr = s_c[slot][1];
            float cj[6];
            cj[0] = lam_c;
            for (int k = 0; k < 4; ++k)
                cj[1 + k] = ((cb[k] + cr[k]) - lam_c2) + lam_c2;
            cj[5] = (cb[4] + cr[4]) + lam_c2;
            bi = argmin_first(cj, 6);
            if (lane == 0 && comp == 1) cost[n + i] = cj[bi];
        }
        const int type = bi == 0 ? -1 : (bi <= 4 ? bi - 1 : 4);
        const int aux = bi == 5 ? e.pos : 0;
        const int off = cand_off(e, bi, lane);
        // prm rows of this component: type, aux, offsets (Cr: no type)
        const int r_type = comp == 0 ? 0 : 6, r_aux = comp == 0 ? 1
                                              : (comp == 1 ? 7 : 12);
        const int r_off = comp == 0 ? 2 : (comp == 1 ? 8 : 13);
        if (lane < 4) {
            p[2 * n + 4 * i + lane] = off;
            prm[(size_t)r_off * n + 4 * i + lane] = (signed char)off;
        }
        if (lane == 0) {
            p[i] = type;
            p[n + i] = aux;
            prm[(size_t)r_aux * n + i] = (signed char)aux;
            if (comp < 2) prm[(size_t)r_type * n + i] = (signed char)type;
        }
    }
    // the picture's choice: in the last block to finish
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
        if (s_last) *ticket = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the chosen costs, staged through shared memory a chunk at a time,
    // summed as jnp.sum sums an (ny, nx) array on XLA's CPU (ops/grid_sao.py
    // xla_sum2d): ny = 4 as ((r0 + r2) + (r1 + r3)), ny <= 2 as the row
    // sums in order (a thread a row), else in raster order (a thread each
    // for Y and chroma); each summing thread adds its range in index order
    const bool by_rows = ny == 4 || ny <= 2;
    const int t = threadIdx.x;
    int c = 0, lo = 0, hi = 0;
    if (by_rows && t < 2 * ny) {
        c = t / ny;
        lo = (t % ny) * nx;
        hi = lo + nx;
    } else if (!by_rows && (t == 0 || t == 32)) {
        c = t >> 5;
        hi = n;
    }
    float acc = 0.0f;
    for (int base = 0; base < n; base += kStage / 2) {
        const int len = min(kStage / 2, n - base);
        for (int j = t; j < 2 * len; j += blockDim.x) {
            const int cc = j >= len;
            s_cost[cc * (kStage / 2) + j - cc * len] =
                __ldcg(&cost[cc * n + base + j - cc * len]);
        }
        __syncthreads();
        for (int k = max(lo, base); k < min(hi, base + len); ++k) {
            const float v = s_cost[c * (kStage / 2) + k - base];
            acc = k == lo ? v : acc + v;
        }
        __syncthreads();
    }
    if (hi > lo) s_rows[c][by_rows ? t % ny : 0] = acc;
    __syncthreads();
    if (t == 0) {
        float sum[2];
        for (int q = 0; q < 2; ++q) {
            const float* r = s_rows[q];
            sum[q] = ny == 4 ? (r[0] + r[2]) + (r[1] + r[3])
                             : (ny == 2 ? r[0] + r[1] : r[0]);
        }
        const float floor = lam * (float)(ny * (nx - 1) + (ny - 1) * nx);
        const float cfgs[4] = {0.0f, sum[0] + floor, sum[1] + floor,
                               (sum[0] + sum[1]) + floor};
        s_cfg = argmin_first(cfgs, 4);
    }
    __syncthreads();
    const bool luma_on = s_cfg == 1 || s_cfg == 3;
    const bool chroma_on = s_cfg == 2 || s_cfg == 3;
    if (luma_on && chroma_on) return;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        if (!luma_on) {
            par[j] = -1;
            prm[j] = -1;
        }
        if (!chroma_on) {
            par[6 * n + j] = par[12 * n + j] = -1;
            prm[6 * n + j] = -1;
        }
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
    if (ctu != 16 && ctu != 32 && ctu != 64) return (int)cudaErrorInvalidValue;
    const int lb = ctu == 64 ? 4 : 1;  // luma blocks a CTU
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(lb + 2, nx, ny);
    cfg.blockDim = dim3(kStatThreads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = lb + 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, sao_stats_kernel, oy, ouv, ry, ruv, cnt, sum, H, W, ctu, lb,
        top, bot);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// ry (top + H + bot, W), ruv (top + H/2 + bot, W) int32, 16-byte aligned,
// H and W multiples of 16; par (3, 6 ny nx) int32: per component the
// stripe's CTUs' types (ny nx), aux (ny nx) and offsets (ny nx, 4) ->
// out_y (H, W), out_uv (H/2, W) (16-byte aligned): the stripe's rows.
extern "C" int tpuhevc_grid_sao_apply(const int* ry, const int* ruv,
                                      const int* par, int* out_y, int* out_uv,
                                      int H, int W, int ctu, int top, int bot,
                                      void* stream) {
    if (H * W == 0) return 0;
    if ((ctu != 16 && ctu != 32 && ctu != 64) || H % 16 || W % 16)
        return (int)cudaErrorInvalidValue;
    const int ny = (H + ctu - 1) / ctu, nx = (W + ctu - 1) / ctu;
    const int lc = ctu == 16 ? 4 : ctu == 32 ? 5 : 6;
    const dim3 grid((W / 4 + kApplyX - 1) / kApplyX,
                    (H + H / 2 + kApplyY - 1) / kApplyY);
    sao_apply_kernel<<<grid, dim3(kApplyX, kApplyY), 0,
                       (cudaStream_t)stream>>>(ry, ruv, par, out_y, out_uv,
                                               H, W, lc, nx, ny * nx, top,
                                               bot);
    return (int)cudaGetLastError();
}

// cnt, sum (3, ny nx, 48) int32 from tpuhevc_grid_sao_stats; lam the frame
// lambda (one float32 on the device); wch the chroma weight
// 2^((qp - qpc) / 3) (float32) -> par (3, 6 ny nx) int32 as
// tpuhevc_grid_sao_apply reads it, prm (17 ny nx) int8 parameter rows
// (type_y, aux_y, off_y, type_c, aux_cb, off_cb, aux_cr, off_cr), types -1
// where the picture-level choice turned a component off. cost: scratch
// of 2 ny nx float32; ticket: one int32, zero (left zero); cpb: CTUs a
// block (1..kDecideCtus).
extern "C" int tpuhevc_grid_sao_decide(const int* cnt, const int* sum,
                                       const float* lam, int* par,
                                       signed char* prm, float* cost,
                                       int* ticket, float wch, int ny,
                                       int nx, int cpb, void* stream) {
    const int n = ny * nx;
    if (n == 0) return 0;
    if (cpb < 1 || cpb > kDecideCtus) return (int)cudaErrorInvalidValue;
    sao_decide_kernel<<<(n + cpb - 1) / cpb, 96 * cpb, 0,
                        (cudaStream_t)stream>>>(cnt, sum, lam, wch, ny, nx,
                                                cpb, par, prm, cost, ticket);
    return (int)cudaGetLastError();
}
