// K1: dense full-pel SAD search with the NN-FME 3x3 SAD surface, 8-bit
// or 10-bit video, the CU classes of a P picture in one launch.
//
// Replaces: tpuhevc/codec/inter_batch.py:139, `sad_search` (a closure of
// build_ldp_scan that XLA compiled for the TPU), with the window gather
// `jnp.take(ref_flat, t["win"])` of :141, and, with subsample 0,
// tpuhevc/ops/me.py:123 `integer_me` (the per-frame P stage's search).
//
// What it computes, per PU n of each class (N PUs of S x S, S = 8, 16 or
// 32, at (xs[n], ys[n])): SAD(dy, dx) = sum |ref[clamp(y - sr + dy + r)]
// [clamp(x - sr + dx + c)] - cur[n][r][c]| for every (dy, dx) in
// [0, 2sr]^2, the row and column clamped to the plane (the window of
// `_win_idx`), with subsample rows r = 0, 2, 4, ... only and the sum << 1
// after it is complete where S > 8; cost = SAD + ((bits[dy][dx] * lam_me)
// >> 8) in int32 (the product wrapping, the shift arithmetic); the argmin
// over the inner (2sr-1)^2 square in row-major order, the first index
// winning ties as in jnp.argmin; mv = (bx - sr, by - sr) and the 3x3 raw
// (shifted) SADs around the winner. Samples are 8-bit (0..255 in the
// int32 planes), packed four to a word on the card, or 10-bit (0..1023,
// the caller's explicit bit_depth picks the variant, never the data); a
// 32x32 SAD at 10 bits is at most 1,047,552, so int32 sums are exact.
//
// What bounds it: integer work, 3 operations an abs-diff: 1089 offsets x
// S^2 samples (half the rows with subsample) a PU at sr 16, 0.63 G
// operations for the 416x240 P picture of random access (0.0094 ms at
// 67 T/s); device memory sees the plane and the PUs once (1.2 MB as
// int32).
// Design: one launch for the classes, the largest PUs first, each class's
// pointers in a `__grid_constant__` table. A block stages its clamped
// window and its PU as bytes four to a word (packed8.cuh, shared with
// b_me.cu; a thread a run of 16 samples), straight from the reference
// plane. A 16-wide unit (a 16x16 PU, or a quadrant of a 32x32 one) keeps
// the PU's 16 rows in registers (64 words); each thread owns one dx and
// a band of kBand dy (from its index by a multiply-high): it loads each
// window row of its band once (five words, aligned to its dx by funnel
// shifts) and adds its abs-diffs, four samples an instruction
// (__vsadu4), into the accumulators of the band's offsets that meet that
// row, so a shared load serves up to kBand x 4 abs-diffs (b_me.cu's
// layout). Two 8x8 PUs share a block (a team of half its threads each,
// kBand8 dy a thread). A 32x32 PU is a cluster of 4
// blocks, block r the 16x16 quadrant r over every offset (the unit
// above), whose partial surfaces rank 0 adds through distributed shared
// memory before the pick (measured faster than a split of the dy into
// four bands over the whole PU with its rows in shared memory, which
// reads the PU from shared memory where a quadrant keeps it in
// registers). The pick is the least 64-bit key (cost's order bits << 32 |
// flat index, which orders the inner square as its row-major index does)
// by warp shuffles and a shared atomicMin; nine lanes read sad9. Offsets
// and indices come from multiply-highs: no division per candidate.
// The 10-bit variant is plain: a block a PU of any size, its clamped
// window and the PU staged in shared memory as 16-bit samples, a thread
// an offset at a time summing |window - PU| over the PU's rows in int32,
// then the same pick (it bounds nothing yet: a simple kernel first).

#include <cooperative_groups.h>

#include "packed8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSr = 16;
constexpr int kMaxSide = 2 * kMaxSr + 1;  // 33
constexpr int kMaxClasses = 4;
constexpr int kMaxThreads = 256;
constexpr int kCluster = 4;  // blocks a 32x32 PU
constexpr int kBand = 5;     // dy a thread: 16-wide units
constexpr int kBand8 = 11;   // dy a thread: 8x8 PUs
// window rows staged: a band past the last dy reads up to its band - 1
// rows beyond the window (zeros)
constexpr int kRows16 = 16 + 2 * kMaxSr + kBand;
constexpr int kRows8 = 8 + 2 * kMaxSr + kBand8;

struct SadClass {
    const int* cur;  // (n, S, S)
    const int* xs;   // (n,) the PUs' origins
    const int* ys;
    int* mv;    // (n, 2) out
    int* sad9;  // (n, 9) out
    int n, size, block0;
};

struct SadJob {
    SadClass c[kMaxClasses];
    int ncls;
    const int* ref;  // (H, W)
    const int* bits;  // (side, side)
    int H, W, sr, lam_me;
    unsigned long long mag;  // ceil(2^32 / side): k / side by a multiply-high
};

struct Sm16 {  // a 16-wide unit
    alignas(16) unsigned wnd[kRows16][16];
    alignas(16) unsigned cur[16][4];
    int sad[kMaxSide * kMaxSide];
    unsigned long long best;
};

struct Sm8 {  // two 8x8 PUs
    alignas(16) unsigned wnd[2][kRows8][12];
    alignas(16) unsigned cur[2][8][2];
    int sad[2][kMaxSide * kMaxSide];
    unsigned long long best[2];
};

union SadSmem {
    Sm16 a;
    Sm8 b;
};

// window row r of a PU (or quadrant) at y0: plane row clamp(y0 - sr + r)
__device__ __forceinline__ const int* ref_row(const SadJob& j, int y0,
                                              int r) {
    return j.ref + (size_t)min(max(y0 - j.sr + r, 0), j.H - 1) * j.W;
}

__device__ __forceinline__ int div_side(const SadJob& j, int k) {
    return (int)(((unsigned long long)k * j.mag) >> 32);
}

// The pick of one PU from its complete surface `sad` (unshifted sums,
// visible to the team): the team (threads [t0, t0 + tn) of the block,
// whole warps; t = threadIdx.x - t0) takes the least key over the inner
// square into *best (~0 before), then writes mv and sad9 (<< shift) of
// PU n where `live`. Every thread of the block calls it (a barrier).
__device__ __forceinline__ void pick(const SadJob& j, const int* sad, int t,
                                     int tn, unsigned long long* best,
                                     const SadClass& c, int n, bool live,
                                     int shift) {
    const int side = 2 * j.sr + 1;
    unsigned long long key = ~0ull;
    for (int k = t; k < side * side; k += tn) {
        const int dy = div_side(j, k), dx = k - dy * side;
        if (dy < 1 || dy > side - 2 || dx < 1 || dx > side - 2) continue;
        const int rate =
            (int)((unsigned)__ldg(j.bits + k) * (unsigned)j.lam_me) >> 8;
        const unsigned cost = ((unsigned)sad[k] << shift) + (unsigned)rate;
        key = min(key, ((unsigned long long)(cost ^ 0x80000000u) << 32)
                           | (unsigned)k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
    if ((threadIdx.x & 31) == 0) atomicMin(best, key);
    __syncthreads();
    if (live && t < 9) {
        const int bi = (int)(*best & 0xffffffffu);
        const int by = div_side(j, bi), bx = bi - by * side;
        const int ky = (t >= 3) + (t >= 6);
        c.sad9[9 * n + t] =
            sad[(by + ky - 1) * side + bx + t - 3 * ky - 1] << shift;
        if (t == 0) {
            c.mv[2 * n] = bx - j.sr;
            c.mv[2 * n + 1] = by - j.sr;
        }
    }
}

// The unshifted SAD surface of a 16x16 block (cur rows `pitch` apart) at
// plane position (x0, y0) over every offset into sm.sad: a 16x16 PU, or a
// quadrant of a 32x32 one. Rows 0, 2, ... only where SUB. The caller
// synchronises before reading sm.sad.
template <bool SUB>
__device__ __forceinline__ void surface16(const SadJob& j, const int* cur,
                                          int pitch, int x0, int y0,
                                          Sm16& sm) {
    const int side = 2 * j.sr + 1, win = 16 + 2 * j.sr;
    const int tid = threadIdx.x;
    // stage: task e = (row e >> 2, run e & 3 of 16 samples); runs and rows
    // past the window zero
    for (int e = tid; e < kRows16 * 4; e += blockDim.x) {
        const int r = e >> 2, q = e & 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < win && q * 16 < win)
            v = run16(ref_row(j, y0, r), x0 - j.sr + q * 16, j.W);
        *reinterpret_cast<uint4*>(&sm.wnd[r][q * 4]) = v;
    }
    if (tid < 16)
        *reinterpret_cast<uint4*>(sm.cur[tid]) =
            run16(cur + (size_t)tid * pitch, 0, 16);
    if (tid == 0) sm.best = ~0ull;
    __syncthreads();

    const int band = div_side(j, tid);
    const int dx = tid - band * side, dy0 = band * kBand;
    const bool owner = dy0 < side;
    unsigned blk[16][4];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(sm.cur[r]);
        blk[r][0] = v.x;
        blk[r][1] = v.y;
        blk[r][2] = v.z;
        blk[r][3] = v.w;
    }
    unsigned acc[kBand];
#pragma unroll
    for (int b = 0; b < kBand; ++b) acc[b] = 0;
    // a thread past the owners reads row 0 (its sums unused)
    const int c0 = dx >> 2, sh = (dx & 3) * 8, r0 = owner ? dy0 : 0;
#pragma unroll
    for (int t = 0; t < kBand + 15; ++t) {
        // window row dy0 + t, samples [dx, dx + 16)
        const unsigned* wr = sm.wnd[r0 + t] + c0;
        unsigned w[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) w[i] = wr[i];
        unsigned a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = __funnelshift_r(w[i], w[i + 1], sh);
#pragma unroll
        for (int b = 0; b < kBand; ++b) {
            const int br = t - b;  // the block row it meets at dy0 + b
            if (br < 0 || br >= 16 || (SUB && (br & 1))) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[b] += __vsadu4(a[i], blk[br][i]);
        }
    }
#pragma unroll
    for (int b = 0; b < kBand; ++b) {
        if (!owner || dy0 + b >= side) break;
        sm.sad[(dy0 + b) * side + dx] = (int)acc[b];
    }
}

// A 32x32 PU: its cluster of kCluster blocks, block r the quadrant r;
// rank 0 adds the four partial surfaces through distributed shared
// memory and picks.
template <bool SUB>
__device__ __forceinline__ void pu32(const SadJob& j, const SadClass& c,
                                     int blk, Sm16& sm) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank(), n = blk / kCluster;
    const int qy = rank >> 1, qx = rank & 1;
    surface16<SUB>(j, c.cur + (size_t)n * 1024 + qy * 16 * 32 + qx * 16, 32,
                   __ldg(c.xs + n) + 16 * qx, __ldg(c.ys + n) + 16 * qy, sm);
    int* sad = sm.sad;
    cl.sync();  // every part complete
    const int side = 2 * j.sr + 1;
    if (rank == 0) {
        const int* p1 = cl.map_shared_rank(sad, 1);
        const int* p2 = cl.map_shared_rank(sad, 2);
        const int* p3 = cl.map_shared_rank(sad, 3);
        for (int k = threadIdx.x; k < side * side; k += blockDim.x)
            sad[k] += p1[k] + p2[k] + p3[k];
    }
    cl.sync();  // the other blocks' shared memory is read: they may leave
    if (rank != 0) return;
    pick(j, sad, threadIdx.x, blockDim.x, &sm.best, c, n, true, SUB ? 1 : 0);
}

template <bool SUB>
__device__ __forceinline__ void pu16(const SadJob& j, const SadClass& c,
                                     int n, Sm16& sm) {
    const int x0 = __ldg(c.xs + n), y0 = __ldg(c.ys + n);
    surface16<SUB>(j, c.cur + (size_t)n * 256, 16, x0, y0, sm);
    __syncthreads();
    pick(j, sm.sad, threadIdx.x, blockDim.x, &sm.best, c, n, true,
         SUB ? 1 : 0);
}

// Two 8x8 PUs (2 blk, 2 blk + 1), a team of half the block each (a spare
// team repeats the last PU and writes nothing); every row is read.
__device__ __forceinline__ void pus8(const SadJob& j, const SadClass& c,
                                     int blk, Sm8& sm) {
    const int team = blockDim.x >> 1, p = threadIdx.x >= team;
    const int t = threadIdx.x - p * team;
    const int n0 = 2 * blk + p;
    const bool live = n0 < c.n;
    const int n = live ? n0 : c.n - 1;
    const int side = 2 * j.sr + 1, win = 8 + 2 * j.sr;
    const int x0 = __ldg(c.xs + n), y0 = __ldg(c.ys + n);
    // task e = (row e >> 2, run e & 3 of 16 samples; runs 0..2 a row)
    for (int e = t; e < kRows8 * 4; e += team) {
        const int r = e >> 2, q = e & 3;
        if (q == 3) continue;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < win && q * 16 < win)
            v = run16(ref_row(j, y0, r), x0 - j.sr + q * 16, j.W);
        *reinterpret_cast<uint4*>(&sm.wnd[p][r][q * 4]) = v;
    }
    if (t < 8) {
        unsigned o[2];
        pack_run<8>(c.cur + (size_t)n * 64 + t * 8, 0, 8, o);
        *reinterpret_cast<uint2*>(sm.cur[p][t]) = make_uint2(o[0], o[1]);
    }
    if (t == 0) sm.best[p] = ~0ull;
    __syncthreads();

    const int band = div_side(j, t);
    const int dx = t - band * side, dy0 = band * kBand8;
    const bool owner = dy0 < side;
    unsigned blk8[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(sm.cur[p][r]);
        blk8[r][0] = v.x;
        blk8[r][1] = v.y;
    }
    unsigned acc[kBand8];
#pragma unroll
    for (int b = 0; b < kBand8; ++b) acc[b] = 0;
    const int c0 = dx >> 2, sh = (dx & 3) * 8, r0 = owner ? dy0 : 0;
#pragma unroll
    for (int tt = 0; tt < kBand8 + 7; ++tt) {
        const unsigned* wr = sm.wnd[p][r0 + tt] + c0;
        const unsigned w0 = wr[0], w1 = wr[1], w2 = wr[2];
        const unsigned a0 = __funnelshift_r(w0, w1, sh);
        const unsigned a1 = __funnelshift_r(w1, w2, sh);
#pragma unroll
        for (int b = 0; b < kBand8; ++b) {
            const int br = tt - b;
            if (br < 0 || br >= 8) continue;
            acc[b] += __vsadu4(a0, blk8[br][0]) + __vsadu4(a1, blk8[br][1]);
        }
    }
#pragma unroll
    for (int b = 0; b < kBand8; ++b) {
        if (!owner || dy0 + b >= side) break;
        sm.sad[p][(dy0 + b) * side + dx] = (int)acc[b];
    }
    __syncthreads();
    pick(j, sm.sad[p], t, team, &sm.best[p], c, n, live, 0);
}

// --- 10-bit: a block a PU ---------------------------------------------------

constexpr int kThreads10 = 256;
constexpr int kWin10 = 32 + 2 * kMaxSr;  // the widest window: 64

struct Sm10 {
    unsigned short wnd[kWin10 * kWin10];  // the clamped window, win pitch
    unsigned short cur[32 * 32];          // the PU, S pitch
    int sad[kMaxSide * kMaxSide];
    unsigned long long best;
};

// PU blk of class c (S x S): its unshifted surface over every offset
// (rows 0, 2, ... where SUB and S > 8), then the pick.
template <int S, bool SUB>
__device__ __forceinline__ void pu10(const SadJob& j, const SadClass& c,
                                     int n, Sm10& sm) {
    constexpr bool sub = SUB && S > 8;
    const int side = 2 * j.sr + 1, win = S + 2 * j.sr;
    const int x0 = __ldg(c.xs + n), y0 = __ldg(c.ys + n);
    for (int r = threadIdx.y; r < win; r += blockDim.y) {
        const int* row = ref_row(j, y0, r);
        for (int q = threadIdx.x; q < win; q += blockDim.x)
            sm.wnd[r * win + q] = (unsigned short)__ldg(
                row + min(max(x0 - j.sr + q, 0), j.W - 1));
    }
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int* cp = c.cur + (size_t)n * S * S;
    for (int e = tid; e < S * S; e += kThreads10)
        sm.cur[e] = (unsigned short)__ldg(cp + e);
    if (tid == 0) sm.best = ~0ull;
    __syncthreads();
    for (int k = tid; k < side * side; k += kThreads10) {
        const int dy = div_side(j, k), dx = k - dy * side;
        int acc = 0;
        for (int r = 0; r < S; r += sub ? 2 : 1) {
            const unsigned short* w = sm.wnd + (dy + r) * win + dx;
            const unsigned short* p = sm.cur + r * S;
#pragma unroll 8
            for (int q = 0; q < S; ++q) acc += abs((int)w[q] - (int)p[q]);
        }
        sm.sad[k] = acc;
    }
    __syncthreads();
    pick(j, sm.sad, tid, kThreads10, &sm.best, c, n, true, sub ? 1 : 0);
}

template <bool SUB>
__global__ void __launch_bounds__(kThreads10)
sad_search10_kernel(const __grid_constant__ SadJob job) {
    __shared__ Sm10 sm;
    const int b = blockIdx.x;
    int k = 0;  // this block's class
    while (k + 1 < job.ncls && b >= job.c[k + 1].block0) ++k;
    const SadClass& c = job.c[k];
    const int n = b - c.block0;
    switch (c.size) {
        case 32: pu10<32, SUB>(job, c, n, sm); break;
        case 16: pu10<16, SUB>(job, c, n, sm); break;
        default: pu10<8, SUB>(job, c, n, sm); break;
    }
}

// blocks of class c: S = 32 kCluster a PU, S = 16 one a PU, S = 8 one for
// two PUs
__host__ __device__ __forceinline__ int class_blocks(int n, int size) {
    return size == 32 ? kCluster * n : (size == 16 ? n : (n + 1) / 2);
}

template <bool SUB>
__global__ void __launch_bounds__(kMaxThreads)
sad_search_kernel(const __grid_constant__ SadJob job) {
    __shared__ SadSmem sm;
    const int b = blockIdx.x;
    int k = 0;  // this block's class
    while (k + 1 < job.ncls && b >= job.c[k + 1].block0) ++k;
    const SadClass& c = job.c[k];
    const int blk = b - c.block0;
    // the blocks past the last class (a cluster's padding) leave
    if (blk >= class_blocks(c.n, c.size)) return;
    switch (c.size) {
        case 32: pu32<SUB>(job, c, blk, sm.a); break;
        case 16: pu16<SUB>(job, c, blk, sm.a); break;
        default: pus8(job, c, blk, sm.b); break;
    }
}

}  // namespace

// ncls classes (1..4) in one launch, in the order given: the caller puts
// the largest PUs first (a 32x32 class's clusters start at a block index
// that is a multiple of 4). Class i: ptrs[5 i ..] = cur (n, S, S), xs, ys
// (n,) int32, mv (n, 2), sad9 (n, 9) int32 out; ints[2 i ..] = n >= 1, S
// in {8, 16, 32}. ref (H, W) int32 plane of samples of bit_depth (8:
// 0..255, the packed variant; 10: 0..1023, a block a PU), cur of the same
// depth, bits (2sr+1, 2sr+1) int32, all on the device, cur 16-byte
// aligned; sr 1..16. subsample: the 2:1 row rule for S > 8 (0 searches
// every row). The arrays lie in host memory and go by value into the
// launch.
extern "C" int tpuhevc_sad_search(int ncls, void* const* ptrs, const int* ints,
                                  const int* ref, int H, int W,
                                  const int* bits, int sr, int lam_me,
                                  int subsample, int bit_depth,
                                  void* stream) {
    if (ncls < 1 || ncls > kMaxClasses || sr < 1 || sr > kMaxSr
        || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    SadJob job = {};
    job.ncls = ncls;
    job.ref = ref;
    job.bits = bits;
    job.H = H;
    job.W = W;
    job.sr = sr;
    job.lam_me = lam_me;
    const int side = 2 * sr + 1;
    job.mag = ((1ULL << 32) + side - 1) / side;
    int blocks = 0, cluster = 1;
    for (int i = 0; i < ncls; ++i) {
        SadClass& c = job.c[i];
        c.cur = (const int*)ptrs[5 * i];
        c.xs = (const int*)ptrs[5 * i + 1];
        c.ys = (const int*)ptrs[5 * i + 2];
        c.mv = (int*)ptrs[5 * i + 3];
        c.sad9 = (int*)ptrs[5 * i + 4];
        c.n = ints[2 * i];
        c.size = ints[2 * i + 1];
        if (c.n < 1 || (c.size != 8 && c.size != 16 && c.size != 32)
            || (bit_depth == 8 && c.size == 32 && blocks % kCluster))
            return (int)cudaErrorInvalidValue;
        if (c.size == 32) cluster = kCluster;
        c.block0 = blocks;
        blocks += bit_depth == 10 ? c.n : class_blocks(c.n, c.size);
    }
    if (bit_depth == 10) {
        const dim3 threads(32, kThreads10 / 32);
        if (subsample)
            sad_search10_kernel<true><<<blocks, threads, 0,
                                        (cudaStream_t)stream>>>(job);
        else
            sad_search10_kernel<false><<<blocks, threads, 0,
                                         (cudaStream_t)stream>>>(job);
        return (int)cudaGetLastError();
    }
    blocks = (blocks + cluster - 1) / cluster * cluster;
    // threads: the owners of a 16-wide unit and of two 8x8 PUs, in whole
    // pairs of warps
    const int owners = side * ((side + kBand - 1) / kBand);
    const int owners8 = 2 * side * ((side + kBand8 - 1) / kBand8);
    const int threads = (max(owners, owners8) + 63) / 64 * 64;
    using Kernel = void (*)(SadJob);
    const Kernel kernel =
        subsample ? sad_search_kernel<true> : sad_search_kernel<false>;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, job);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
