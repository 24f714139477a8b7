// grid_me: the grid step's motion search, four entry points.
//
// tpuhevc_grid_coarse replaces tpuhevc/codec/inter_grid.py:650
// `coarse_stack` (the +-16 SAD stack on the 2x-pooled level): for every
// offset k = dy * n + dx of the padded pooled reference and every tile x
// tile block of the pooled picture,
//   sad[k][b] = (sum |refp[y + dy][x + dx] - cur[y][x]|) << shift,
//   sum[k][b] =  sum (refp[y + dy][x + dx] - cur[y][x])      (optional).
// tpuhevc_grid_prestage replaces :2395-2416 `ps_row` (the +-64 prestage
// on the 4x-pooled level) with its pick: per block the first index over k
// of (sad[k][b] << shift) + ((bits[k] * lam) >> 8), the stack never
// written. `ps_row` keeps a strict-less running best over k in order,
// which is that first index.
// Both stage what a CUDA block reads in shared memory once, as int32: the
// stack a strip of 8 tiles of one tile row and a band of offset rows dy,
// the prestage one tile and every dy (its pick needs them all); that is
// the block's current tiles and the reference window their offsets reach.
// A thread takes one tile and a run of DXG offsets dx of one dy, so that
// one reference row segment of tile + DXG - 1 samples, in registers,
// serves all of them (__sad, and the signed sum as a sliding sum of the
// segment less the tile row's). The stack's stores are coalesced over the
// strip's tiles. In the prestage each thread keeps the least (cost << 32
// | k) over its offsets and the block's threads meet by shuffles and in
// shared memory, so the first index wins a tie exactly. Integer sums:
// exact in any order.
//
// tpuhevc_grid_refine replaces :681-776 `_refine_grid` + `_pick_grids`
// (no MV-rate anchor) together with the reference loop `ref_body` and its
// `merge_acc` (:2468-2512) and `acc_init` (:2453-2456): per block of size
// S and each of G start points, each start with its reference index
// sref[g] into the stack `ry` (reference-major: reference 0's starts,
// then one scaled coarse start for each further reference), the 7x7 raw
// SADs and residual sums of the windows read at clamped coordinates
// (reference row = block row + ry_y0, where `ry` carries ry_y0 halo rows
// above the blocks' first row: a row stripe; stripe_refine of
// tpuhevc/parallel/mesh.py:158-223 reads its halos so, :681-693), the
// DC-aware cost zc(sad, sum, dcc) + ((bits * lam) >> 8) on the inner 5x5
// (the outer ring costs 2^30), and the winner: the first index over the
// G x 49 candidates in start order of cost + ((rbits[sref[g]] * lam) >> 8)
// (no reference bits where rbits is null: one reference), its MV clipped
// to +-lim, its 3x3 raw-SAD surface, its cost and its reference index;
// with quads (S = 16) the same pick per 8x8 quadrant from the quadrant
// partial sums (cost with dcc8), written after the nb main rows in 8-grid
// order.
// That pick equals the reference's: `_pick_grids` takes the first index
// over one reference's starts, and `merge_acc` replaces the running winner
// only where the next reference's cost plus its bits is strictly less.
// Within a reference the bits are one constant, so its first-index winner
// is the same with them added; across references strict-less keeps the
// earlier reference on a tie, which is the first index over the
// reference-major order. `acc_init` adds reference 0's bits where the cfg
// has more than one reference: the caller passes rbits null otherwise.
// bits(mv) = 2 bl(2|4 mvx|) + 2 bl(2|4 mvy|) + 2, bl = bit length, which
// equals the reference's 2 ceil(log2(2a + 1)) on integers.
//
// tpuhevc_grid_wp_me replaces :2352-2362, the weighted full-pel search
// references of explicit weighted prediction (luma): per reference r,
//   out[r][y][x] = clip(((ref[r][y][x] * w[r] + rnd) >> d) + o[r], 0, 255)
// with rnd = (1 << d) >> 1 exactly as the reference rounds it (the
// full-pel special case of weightUnidir, xCalcSADvalueWPOptionalClip).
// int32 as in JAX; bound by its bytes (a plane stack read and written
// once: ~0.001 ms at four 416x240 references, under a launch's ~0.002),
// so it moves 16-byte runs on a (chunk, reference) grid of about one
// wave, a thread's loads issued before its stores, the reference's
// constants once a block and no division a sample.
//
// What bounds it: the coarse stack and the prestage are operations (sub,
// abs and add a sample and offset, an add more for the sum: 28.9 M and
// 21.7 M an anchor P picture at 416x240), the stack's 0.9 MB of stores
// close behind; the prestage's stack, which it no longer writes, was 1.7
// MB. The refine is operations: G x 49 x S^2 absolute differences a
// block (302,661,632 operations an anchor P picture at 416x240, counting
// sub, abs and two adds a pixel and candidate), on data that fits in
// shared memory. Its
// design: one CUDA block a (picture block, chunk of starts), chunks sized
// so that at least two blocks an SM are in flight (the S = 32 launch has
// 91 picture blocks at 416x240); each (start) window of (S + 6)^2 samples
// and the current block staged once as int16 in shared memory, clamped
// while staging (ry_y0 enters only there), rows padded to 16 bytes so a
// lane reads 8 samples a load; one warp a window row offset dy, a lane an
// 8-sample row segment of the block (its 14 reference samples in
// registers across the 7 dx), the SADs by __sad, the residual sums from a
// sliding sum of the reference segment less the block segment's sum; the
// 7 dx values of 8 lanes summed by a halving butterfly (7 shuffles for 8
// values; at S <= 16 the SAD and the signed sum packed in one word, both
// below 2^15 over 64 samples), then across the quadrants; the candidates'
// SADs and costs in shared memory (one chunk) or in a global scratch, the
// last chunk's block of each picture block (a ticket) doing the 1 + 4
// picks, a warp each, by a warp minimum over (cost, index) packed in 64
// bits, so the first-index rule holds exactly. Every sum is an integer:
// exact in any order.

#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxG = 16;

// offsets dx a thread of the coarse entries (T = 8 the stack's, 4 the
// prestage's): one reference row segment of T + DXG - 1 samples serves
// them (n = 17 at T = 8 is three runs, n = 33 at T = 4 three)
template <int T>
struct CoarseRun {
    static constexpr int DXG = T == 4 ? 11 : 6;
    static constexpr int SEG = T + DXG - 1;
};

// One CUDA block a (strip blockIdx.x of STRIP tiles, tile row blockIdx.y,
// band blockIdx.z of bdy offset rows). PICK: the prestage (bdy = n, bits
// and barg), else the stack (sad, sum).
template <int T, bool PICK, int THREADS, int STRIP,
          int UNROLL = PICK ? 8 : 1>
__global__ void __launch_bounds__(THREADS)
coarse_stage_kernel(const int* __restrict__ cur, const int* __restrict__ refp,
                    int* __restrict__ sad, int* __restrict__ sum,
                    const int* __restrict__ bits, int* __restrict__ barg,
                    int h, int w, int n, int bdy, int shift, int lam) {
    constexpr int DXG = CoarseRun<T>::DXG, SEG = CoarseRun<T>::SEG;
    constexpr int SW = STRIP * T;         // the strip's width in samples
    constexpr int PER = THREADS / STRIP;  // items a pass
    extern __shared__ int s_coarse[];
    const int nbw = w / T, nb = (h / T) * nbw;
    const int ng = (n + DXG - 1) / DXG;  // runs of dx a row dy
    const int wr = SW + ng * DXG - 1;    // staged reference row width
    const int by = blockIdx.y, t0 = blockIdx.x * STRIP;
    const int ns = min(STRIP, nbw - t0);
    const int dy0 = blockIdx.z * bdy, ndy = min(bdy, n - dy0);
    const int hr = T + ndy - 1;
    int* s_cur = s_coarse;         // T x SW
    int* s_ref = s_cur + T * SW;   // hr x wr
    const int x0 = t0 * T, y0 = by * T, wp = w + n - 1;
    const int wv = ns * T + n - 1;  // reference columns the strip reads
    const int tid = threadIdx.x;
    // the prestage unrolled, so that a thread's loads are in flight
    // together (the stack, with more blocks an SM, does better without)
#pragma unroll UNROLL
    for (int e = tid; e < T * SW; e += THREADS) {
        const int i = e / SW, j = e - i * SW;
        s_cur[e] = j < ns * T ? cur[(size_t)(y0 + i) * w + x0 + j] : 0;
    }
#pragma unroll UNROLL
    for (int e = tid; e < hr * wr; e += THREADS) {
        const int i = e / wr, j = e - i * wr;
        s_ref[e] = j < wv ? refp[(size_t)(y0 + dy0 + i) * wp + x0 + j] : 0;
    }
    __syncthreads();
    const int ti = tid % STRIP;
    unsigned long long best = ~0ull;
    for (int c = tid / STRIP; c < ndy * ng; c += PER) {
        const int dyl = c / ng, dx0 = (c - dyl * ng) * DXG;
        int sa[DXG], sm[DXG];
#pragma unroll
        for (int d = 0; d < DXG; ++d) sa[d] = sm[d] = 0;
#pragma unroll
        for (int i = 0; i < T; ++i) {
            int cv[T], rv[SEG];
            const int* cp = s_cur + i * SW + ti * T;
            const int* rp = s_ref + (i + dyl) * wr + ti * T + dx0;
            int csum = 0, rs = 0;
#pragma unroll
            for (int j = 0; j < T; ++j) {
                cv[j] = cp[j];
                csum += cv[j];
            }
#pragma unroll
            for (int j = 0; j < SEG; ++j) rv[j] = rp[j];
#pragma unroll
            for (int j = 0; j < T; ++j) rs += rv[j];
#pragma unroll
            for (int d = 0; d < DXG; ++d) {
                unsigned s = 0;
#pragma unroll
                for (int j = 0; j < T; ++j) s = __sad(rv[j + d], cv[j], s);
                sa[d] += (int)s;
                if (!PICK) {
                    sm[d] += rs - csum;
                    if (d + 1 < DXG) rs += rv[d + T] - rv[d];
                }
            }
        }
        if (ti >= ns) continue;
        const int dy = dy0 + dyl;
#pragma unroll
        for (int d = 0; d < DXG; ++d) {
            const int dx = dx0 + d;
            if (dx >= n) break;
            const int k = dy * n + dx;
            if (PICK) {
                const int rate =
                    (int)(((long long)__ldg(bits + k) * lam) >> 8);
                const unsigned long long key =
                    ((unsigned long long)(unsigned)((sa[d] << shift) + rate)
                     << 32) | (unsigned)k;
                best = key < best ? key : best;
            } else {
                const size_t o = (size_t)k * nb + (size_t)by * nbw + t0 + ti;
                sad[o] = sa[d] << shift;
                if (sum) sum[o] = sm[d];
            }
        }
    }
    if (!PICK) return;
    // the strip's tile ti: lanes ti, ti + STRIP, ... of each warp
    __shared__ unsigned long long s_best[THREADS / 32][STRIP];
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int off = STRIP; off < 32; off <<= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
        best = o < best ? o : best;
    }
    if (lane < STRIP) s_best[warp][lane] = best;
    __syncthreads();
    if (tid < ns) {
        unsigned long long b = s_best[0][tid];
        for (int q = 1; q < THREADS / 32; ++q)
            b = s_best[q][tid] < b ? s_best[q][tid] : b;
        barg[(size_t)by * nbw + t0 + tid] = (int)(b & 0xffffffffu);
    }
}

// The launch: the prestage's blocks take every dy; the stack's a band of
// about THREADS / (runs x STRIP) rows dy, so that a thread has about one
// (tile, run) item.
template <int T, bool PICK, int THREADS, int STRIP>
int coarse_launch(const int* cur, const int* refp, int* sad, int* sum,
                  const int* bits, int* barg, int h, int w, int n, int shift,
                  int lam, cudaStream_t st) {
    constexpr int DXG = CoarseRun<T>::DXG;
    const int ng = (n + DXG - 1) / DXG;
    int bdy = n;
    if (!PICK) {
        const int per = THREADS / (ng * STRIP) > 1 ? THREADS / (ng * STRIP)
                                                   : 1;
        const int bands = (n + per - 1) / per;
        bdy = (n + bands - 1) / bands;
    }
    const size_t smem =
        sizeof(int) * ((size_t)T * STRIP * T
                       + (size_t)(T + bdy - 1) * (STRIP * T + ng * DXG - 1));
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((w / T + STRIP - 1) / STRIP, h / T,
                    (n + bdy - 1) / bdy);
    coarse_stage_kernel<T, PICK, THREADS, STRIP><<<grid, THREADS, smem, st>>>(
        cur, refp, sad, sum, bits, barg, h, w, n, bdy, shift, lam);
    return (int)cudaGetLastError();
}

// the stack: 128 threads a strip of 8 tiles; the prestage: 128 threads a
// tile (its n x ng items in about one pass)
constexpr int kStackThreads = 128, kStackStrip = 8;
constexpr int kPickThreads = 128, kPickStrip = 1;

__device__ __forceinline__ int bitlen(int v) {
    return v ? 32 - __clz(v) : 0;
}

__device__ __forceinline__ int zc(int sad, int sdc, int dcc) {
    const int a = abs(sdc);
    return sad - a + min(a, dcc);
}

constexpr int kWarps = 7;  // one warp a window row offset dy
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int rate_of(int mvx, int mvy, int lam) {
    return ((2 * bitlen(8 * abs(mvx)) + 2 * bitlen(8 * abs(mvy)) + 2) * lam)
           >> 8;
}

// v[d] (d < 8) of the 8 lanes that share lane bits 3-4, summed over them
// by a halving butterfly: lane l returns the sum of v[l & 7] (7 shuffles).
template <typename T>
__device__ __forceinline__ T halve8(T (&v)[8], int lane) {
#pragma unroll
    for (int h = 4; h; h >>= 1) {
        const bool up = lane & h;
#pragma unroll
        for (int j = 0; j < h; ++j) {
            const T send = up ? v[j] : v[j + h];
            const T keep = up ? v[j + h] : v[j];
            v[j] = keep + __shfl_xor_sync(kFull, send, h);
        }
    }
    return v[0];
}

// 8 int16 samples at p (16-byte aligned) -> v[0..7]
__device__ __forceinline__ void load8(const short* p, int* v) {
    const int4 w = *reinterpret_cast<const int4*>(p);
    const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        v[2 * q] = (int)(short)ws[q];
        v[2 * q + 1] = ws[q] >> 16;
    }
}

// One CUDA block a (picture block b = blockIdx.x, chunk of gpb starts
// blockIdx.y). Candidate fields (G x 49 each, start-major): 0 the raw SAD,
// 1 the cost, 2-5 the quadrants' raw SADs, 6-9 their costs.
template <int S>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const int* __restrict__ ry, const int* __restrict__ oy,
              const int* __restrict__ starts, const int* __restrict__ sref,
              const int* __restrict__ rbits, int* __restrict__ mv_out,
              int* __restrict__ sad9_out, int* __restrict__ cost_out,
              int* __restrict__ ref_out, int* __restrict__ cand_g,
              int* __restrict__ tickets, int hr, int wr, int wo, int nbh,
              int nbw, int G, int gpb, int quads, int dcc, int dcc8, int lam,
              int lim, int ry_y0) {
    constexpr int WIN = S + 6;        // a window's side
    constexpr int PITCH = S + 8;      // int16 row pitch: 16-byte rows
    constexpr int WSZ = WIN * PITCH;  // int16 a window
    constexpr int SEG = S / 8;        // 8-sample segments a row
    constexpr int UNITS = S * SEG;    // (row, segment) units a candidate
    constexpr int K = (UNITS + 31) / 32;
    extern __shared__ int4 smem4[];
    short* s_cur = reinterpret_cast<short*>(smem4);  // S x PITCH
    short* s_win = s_cur + S * PITCH;                // gpb x WSZ
    int* s_cand = reinterpret_cast<int*>(s_win + gpb * WSZ);
    __shared__ int s_radd[kMaxG];
    __shared__ int s_last;
    const int nb = nbh * nbw, NC = G * 49;
    const int b = blockIdx.x, nchunk = gridDim.y;
    const int g0 = blockIdx.y * gpb, ng = min(G - g0, gpb);
    const int by = b / nbw, bx = b - by * nbw;
    const int y0 = by * S, x0 = bx * S;
    const int tid = threadIdx.x;
    for (int e = tid; e < S * S; e += kThreads) {
        const int i = e / S, j = e - i * S;
        s_cur[i * PITCH + j] = (short)oy[(size_t)(y0 + i) * wo + x0 + j];
    }
    // each window clamped once, here
    for (int e = tid; e < ng * WIN * WIN; e += kThreads) {
        const int gl = e / (WIN * WIN), r = e - gl * (WIN * WIN);
        const int i = r / WIN, j = r - i * WIN, g = g0 + gl;
        const int cx = starts[((size_t)g * nb + b) * 2];
        const int cy = starts[((size_t)g * nb + b) * 2 + 1];
        const int* plane = ry + (size_t)(sref ? sref[g] : 0) * hr * wr;
        const int yy = min(max(y0 + cy - 3 + ry_y0 + i, 0), hr - 1);
        const int xx = min(max(x0 + cx - 3 + j, 0), wr - 1);
        s_win[gl * WSZ + i * PITCH + j] = (short)plane[(size_t)yy * wr + xx];
    }
    __syncthreads();
    int* base;  // field f of candidate c at base[f * fs + c]
    size_t fs;
    if (nchunk == 1) {
        base = s_cand;
        fs = NC;
    } else {
        base = cand_g + (size_t)b * NC;
        fs = (size_t)nb * NC;
    }
    const int warp = tid >> 5, lane = tid & 31, dy = warp;
    for (int gl = 0; gl < ng; ++gl) {
        const int g = g0 + gl;
        const short* wnd = s_win + gl * WSZ;
        int sad[8], sdc[8];
#pragma unroll
        for (int d = 0; d < 8; ++d) sad[d] = sdc[d] = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int u = lane + 32 * k;
            if (UNITS % 32 == 0 || u < UNITS) {
                // unit u: row i, segment c; at S = 16 lane bits 0-2 are
                // the row within the quadrant, bits 3-4 the quadrant
                const int c = (u >> 3) % SEG;
                const int i = (u & 7) + 8 * ((u >> 3) / SEG);
                int cv[8], rv[16];
                load8(s_cur + i * PITCH + 8 * c, cv);
                load8(wnd + (i + dy) * PITCH + 8 * c, rv);
                load8(wnd + (i + dy) * PITCH + 8 * c + 8, rv + 8);
                int csum = 0, rs = 0;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    csum += cv[j];
                    rs += rv[j];
                }
#pragma unroll
                for (int dx = 0; dx < 7; ++dx) {
                    unsigned s = 0;
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        s = __sad(rv[j + dx], cv[j], s);
                    sad[dx] += (int)s;
                    sdc[dx] += rs - csum;
                    if (dx < 6) rs += rv[dx + 8] - rv[dx];
                }
            }
        }
        // lane l: dx = l & 7 (7 is no candidate); q the quadrant's sums,
        // t the block's
        int qs, qd, ts, td;
        if (S <= 16) {  // |sad|, |sum| < 2^15 over a quadrant: packed
            unsigned pk[8];
#pragma unroll
            for (int d = 0; d < 8; ++d)
                pk[d] = (unsigned)sad[d] + ((unsigned)sdc[d] << 16);
            const unsigned v = halve8(pk, lane);
            qs = (int)(v & 0xffffu);
            qd = (int)(v - (unsigned)qs) >> 16;
            ts = qs;
            td = qd;
            if (S == 16) {
                ts += __shfl_xor_sync(kFull, ts, 8);
                td += __shfl_xor_sync(kFull, td, 8);
                ts += __shfl_xor_sync(kFull, ts, 16);
                td += __shfl_xor_sync(kFull, td, 16);
            }
        } else {
            ts = halve8(sad, lane);
            td = halve8(sdc, lane);
            ts += __shfl_xor_sync(kFull, ts, 8);
            td += __shfl_xor_sync(kFull, td, 8);
            ts += __shfl_xor_sync(kFull, ts, 16);
            td += __shfl_xor_sync(kFull, td, 16);
            qs = qd = 0;
        }
        const int dx = lane & 7;
        if (dx < 7) {
            const int c = g * 49 + dy * 7 + dx;
            const int mvx = starts[((size_t)g * nb + b) * 2] + dx - 3;
            const int mvy = starts[((size_t)g * nb + b) * 2 + 1] + dy - 3;
            const int rate = rate_of(mvx, mvy, lam);
            const bool inner = dx >= 1 && dx <= 5 && dy >= 1 && dy <= 5;
            if (quads) {
                const int q = lane >> 3;
                base[(2 + q) * fs + c] = qs;
                base[(6 + q) * fs + c] = inner ? zc(qs, qd, dcc8) + rate
                                               : kBig;
            }
            if (lane < 8) {
                base[c] = ts;
                base[fs + c] = inner ? zc(ts, td, dcc) + rate : kBig;
            }
        }
    }
    // the picks: in the last block of the picture block's chunks
    if (nchunk > 1) {
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            s_last = atomicAdd(&tickets[b], 1) == nchunk - 1;
            if (s_last) tickets[b] = 0;  // ready for the next launch
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
    }
    if (tid < G)
        s_radd[tid] = rbits ? (rbits[sref ? sref[tid] : 0] * lam) >> 8 : 0;
    __syncthreads();
    if (warp >= (quads ? 5 : 1)) return;
    const volatile int* vsad = base + (warp ? 1 + warp : 0) * fs;
    const volatile int* vcost = base + (warp ? 5 + warp : 1) * fs;
    unsigned long long best = ~0ull;
    for (int c = lane; c < NC; c += 32) {
        const unsigned long long key =
            ((unsigned long long)(unsigned)(vcost[c] + s_radd[c / 49]) << 32)
            | (unsigned)c;
        best = key < best ? key : best;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, best, off);
        best = o < best ? o : best;
    }
    if (lane) return;
    const int bi = (int)(best & 0xffffffffu);
    const int g = bi / 49, k = bi - g * 49, bdy = k / 7, bdx = k - bdy * 7;
    const int q = warp - 1;
    const int row = warp ? nb + (2 * by + (q >> 1)) * (2 * nbw) + 2 * bx
                               + (q & 1)
                         : b;
    for (int n = 0; n < 9; ++n)
        sad9_out[9 * row + n] =
            vsad[g * 49 + (bdy + n / 3 - 1) * 7 + bdx + n % 3 - 1];
    const int cx = starts[((size_t)g * nb + b) * 2];
    const int cy = starts[((size_t)g * nb + b) * 2 + 1];
    mv_out[2 * row] = min(max(cx + bdx - 3, -lim), lim);
    mv_out[2 * row + 1] = min(max(cy + bdy - 3, -lim), lim);
    cost_out[row] = (int)(best >> 32);
    if (ref_out) ref_out[row] = sref ? sref[g] : 0;
}

}  // namespace

// cur (h, w), refp (h + n - 1, w + n - 1) int32 on the device, tile 8
// dividing h and w -> sad, sum (optional, may be null) (n * n, h / tile,
// w / tile) int32.
extern "C" int tpuhevc_grid_coarse(const int* cur, const int* refp, int* sad,
                                   int* sum, int h, int w, int n, int tile,
                                   int shift, void* stream) {
    if (n < 1 || h % tile || w % tile) return (int)cudaErrorInvalidValue;
    if (h == 0 || w == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 8: return coarse_launch<8, false, kStackThreads, kStackStrip>(
            cur, refp, sad, sum, nullptr, nullptr, h, w, n, shift, 0, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// cur, refp as tpuhevc_grid_coarse but tile 4; bits (n * n) int32,
// lam >= 0 -> barg
// (h / tile, w / tile) int32: per block the first k minimising
// (sad[k] << shift) + ((bits[k] * lam) >> 8) (each below 2^31).
extern "C" int tpuhevc_grid_prestage(const int* cur, const int* refp,
                                     const int* bits, int* barg, int h,
                                     int w, int n, int tile, int shift,
                                     int lam, void* stream) {
    if (n < 1 || h % tile || w % tile) return (int)cudaErrorInvalidValue;
    if (h == 0 || w == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    switch (tile) {
        case 4: return coarse_launch<4, true, kPickThreads, kPickStrip>(
            cur, refp, nullptr, nullptr, bits, barg, h, w, n, shift, lam, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ry (R', hr, wr) a reference stack, oy (>= nbh S, row stride wo) int32;
// starts (G, nb, 2) int32 full-pel centres, reference-major; sref (G,)
// int32 each start's plane of ry (null: plane 0 for all); rbits (R,)
// int32 the reference bits (null: none added); ry_y0 the row of ry that
// lies level with oy's row 0; gpb starts a CUDA block: with G > gpb the
// picture block's chunks meet in cand (10 nb G 49 int32 with quads, else
// 2 nb G 49) and tickets (nb int32, zero; left zero) -> mv (nb (+4 nb),
// 2), sad9 (nb (+4 nb), 9), cost (nb (+4 nb)) and ref (the same rows;
// may be null) int32; the quadrant rows (quads, S = 16) follow the nb
// main rows in 8-grid order.
extern "C" int tpuhevc_grid_refine(const int* ry, const int* oy,
                                   const int* starts, const int* sref,
                                   const int* rbits, int* mv, int* sad9,
                                   int* cost, int* ref, int* cand,
                                   int* tickets, int hr, int wr, int wo,
                                   int S, int nbh, int nbw, int G, int gpb,
                                   int quads, int dcc, int dcc8, int lam,
                                   int lim, int ry_y0, void* stream) {
    if (G < 1 || G > kMaxG || gpb < 1 || gpb > G || (quads && S != 16))
        return (int)cudaErrorInvalidValue;
    if (nbh * nbw == 0) return 0;
    const int nchunk = (G + gpb - 1) / gpb;
    size_t smem = 2 * ((size_t)S * (S + 8) + (size_t)gpb * (S + 6) * (S + 8));
    if (nchunk == 1) smem += sizeof(int) * (quads ? 10 : 2) * (size_t)G * 49;
    if (smem > 48 * 1024 || (nchunk > 1 && (!cand || !tickets)))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(nbh * nbw, nchunk);
    cudaStream_t st = (cudaStream_t)stream;
#define TPUHEVC_REFINE(SS)                                                  \
    refine_kernel<SS><<<grid, kThreads, smem, st>>>(                        \
        ry, oy, starts, sref, rbits, mv, sad9, cost, ref, cand, tickets, hr, \
        wr, wo, nbh, nbw, G, gpb, quads, dcc, dcc8, lam, lim, ry_y0)
    switch (S) {
        case 8: TPUHEVC_REFINE(8); break;
        case 16: TPUHEVC_REFINE(16); break;
        case 32: TPUHEVC_REFINE(32); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef TPUHEVC_REFINE
    return (int)cudaGetLastError();
}

namespace {

constexpr int kWpThreads = 256;
constexpr int kWpVecs = 2;  // 16-byte vectors a thread
constexpr int kWpChunk = kWpThreads * kWpVecs;  // vectors a block

// Block (chunk, r): kWpChunk vectors of reference r, thread t the vectors
// chunk * kWpChunk + t + q * kWpThreads; both loads before either store.
__global__ void __launch_bounds__(kWpThreads)
wp_me_runs(const int4* __restrict__ ref, const int* __restrict__ w,
           const int* __restrict__ o, int4* __restrict__ out, int nv,
           int d) {
    const int r = blockIdx.y;
    const int wr = __ldg(w + r), orr = __ldg(o + r);
    const int rnd = (1 << d) >> 1;
    const int4* src = ref + (size_t)r * nv;
    int4* dst = out + (size_t)r * nv;
    const int i0 = blockIdx.x * kWpChunk + threadIdx.x;
    int4 v[kWpVecs];
#pragma unroll
    for (int q = 0; q < kWpVecs; ++q) {
        const int i = i0 + q * kWpThreads;
        if (i < nv) v[q] = __ldg(src + i);
    }
    auto wp = [&](int x) {
        return min(max(((x * wr + rnd) >> d) + orr, 0), 255);
    };
#pragma unroll
    for (int q = 0; q < kWpVecs; ++q) {
        const int i = i0 + q * kWpThreads;
        if (i < nv)
            dst[i] = make_int4(wp(v[q].x), wp(v[q].y), wp(v[q].z), wp(v[q].w));
    }
}

}  // namespace

// ref (n, h, w) int32 with h * w a multiple of 4, ref and out 16-byte
// aligned; w and o (n,) int32, 0 <= d < 31 -> out (n, h, w) int32.
// A block a (chunk of 2,048 samples, reference): the reference from
// blockIdx.y, its weight, offset and rounding loaded once; a thread two
// 16-byte vectors, no division a sample.
extern "C" int tpuhevc_grid_wp_me(const int* ref, const int* w, const int* o,
                                  int* out, int n, int h, int wd, int d,
                                  void* stream) {
    const long long hw = (long long)h * wd;
    if (n < 1 || hw < 1 || hw % 4 || hw / 4 > 0x7fffffff || d < 0 ||
        d > 30 || (((size_t)ref) & 15) || (((size_t)out) & 15))
        return (int)cudaErrorInvalidValue;
    const int nv = (int)(hw / 4);
    const dim3 grid((nv + kWpChunk - 1) / kWpChunk, n);
    wp_me_runs<<<grid, kWpThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const int4*>(ref), w, o,
        reinterpret_cast<int4*>(out), nv, d);
    return (int)cudaGetLastError();
}
