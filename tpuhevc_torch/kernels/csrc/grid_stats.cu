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
// What bounds it: the bytes, two int32 planes read once (orig and recon),
// 8 bytes a sample (1,198,080 bytes at 416x240: 0.00036 ms at 3.35 TB/s);
// 3 x 8 + 3 x 8 bytes out. At the grid's sizes the launch sets the pace.
//
// Design: one launch a picture (a stripe) of many blocks, so that every SM
// takes one (180 at 416x240). A block is a tile of one plane, 8 rows of 32
// 16-byte vectors (128 samples a row); the planes' tiles in turn (luma,
// then U, then V) along a 1-D grid, the plane and tile found once a block.
// Thread (tx, ty) takes row ty of the tile and its vector tx (a warp's
// loads are 512 contiguous bytes), a run of 4 consecutive samples of one
// row: x and y come from the block and thread indices, no division or
// modulo a sample. Samples are 8-bit (0..255; the recon and the original
// of the grid step), so a term of the checksum is at most 255 and of the
// SSE at most 65,025: a thread keeps both sums in 32 bits, which holds
// while its samples (4) times 65,025 stay below 2^31. The
// sums widen to 64 bits for the warp shuffles and the block's sum. The
// blocks join in the same launch: each adds its two sums into its plane's
// accumulators of a scratch (64-bit integer atomics: any order gives the
// same bits), then takes a ticket; the last block reads the accumulators
// (plain loads from L2: they cost one round trip where six atomic
// exchanges cost more) into cks and sse and leaves them, and the ticket,
// at zero for the next launch. The scratch is the caller's, one per
// (device, stream) (ops/grid_stats.py), so that two launches in flight
// never share one.
// Where a plane's rows are not 16-byte aligned (a width not a multiple of
// 8, or a view's offset), the runs are read sample by sample; the ragged
// tail of a row is read sample by sample either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32, kRows = 8;  // a block: 32 x 8 threads
constexpr int kTileVecs = kLanes;  // 16-byte runs a tile row, one a thread

typedef unsigned long long u64;

// one plane of the stripe (org and recon from its first column): ph rows
// of pw samples, rows w int32 apart; row 0 is row y0 of the picture's plane
struct Plane {
    const int* o;
    const int* r;
    int ph, pw, y0;
};

__device__ __forceinline__ void add_sample(int o, int r, int x, int ym,
                                           unsigned& ck, unsigned& se) {
    ck += (unsigned)((r & 0xFF) ^ (x & 0xFF) ^ (x >> 8) ^ ym);
    const int d = o - r;
    se += (unsigned)(d * d);
}

__global__ void __launch_bounds__(kLanes * kRows)
    stats_kernel(const int* __restrict__ oy, const int* __restrict__ ouv,
                 const int* __restrict__ ry, const int* __restrict__ ruv,
                 int h, int w, int y0, int vec, int ntx_l, int ntx_c,
                 int nb_l, int nb_c, long long* __restrict__ cks,
                 long long* __restrict__ sse, u64* __restrict__ acc) {
    __shared__ u64 s_ck[kRows], s_se[kRows];
    // the plane and the tile of this block
    int b = blockIdx.x, p = 0, ntx = ntx_l;
    if (b >= nb_l) {
        b -= nb_l;
        p = 1 + (b >= nb_c);
        b -= b >= nb_c ? nb_c : 0;
        ntx = ntx_c;
    }
    const int wc = w >> 1;
    const int xo = p == 2 ? wc : 0;
    const Plane pl{(p == 0 ? oy : ouv) + xo, (p == 0 ? ry : ruv) + xo,
                   p == 0 ? h : h >> 1, p == 0 ? w : wc,
                   p == 0 ? y0 : y0 >> 1};
    unsigned ck = 0, se = 0;
    if (ntx > 0) {
        const int band = b / ntx;  // once a block
        const int y = band * kRows + threadIdx.y;
        const int x = 4 * ((b - band * ntx) * kTileVecs + threadIdx.x);
        if (y < pl.ph && x < pl.pw) {
            const int gy = pl.y0 + y;
            const int ym = (gy & 0xFF) ^ (gy >> 8);
            const int* o = pl.o + (size_t)y * w + x;
            const int* r = pl.r + (size_t)y * w + x;
            if (vec && x + 4 <= pl.pw) {
                const int4 ov = __ldg(reinterpret_cast<const int4*>(o));
                const int4 rv = __ldg(reinterpret_cast<const int4*>(r));
                add_sample(ov.x, rv.x, x, ym, ck, se);
                add_sample(ov.y, rv.y, x + 1, ym, ck, se);
                add_sample(ov.z, rv.z, x + 2, ym, ck, se);
                add_sample(ov.w, rv.w, x + 3, ym, ck, se);
            } else {
                for (int j = 0; j < 4 && x + j < pl.pw; ++j)
                    add_sample(__ldg(o + j), __ldg(r + j), x + j, ym, ck, se);
            }
        }
    }
    u64 c64 = ck, s64 = se;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        c64 += __shfl_down_sync(0xffffffffu, c64, off);
        s64 += __shfl_down_sync(0xffffffffu, s64, off);
    }
    if (threadIdx.x == 0) {
        s_ck[threadIdx.y] = c64;
        s_se[threadIdx.y] = s64;
    }
    __syncthreads();
    if (threadIdx.x != 0 || threadIdx.y != 0) return;
    u64 a = 0, e = 0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        a += s_ck[k];
        e += s_se[k];
    }
    atomicAdd(&acc[p], a);
    atomicAdd(&acc[3 + p], e);
    __threadfence();
    if (atomicAdd(&acc[6], 1ull) != (u64)gridDim.x - 1) return;
    // the last block: every other block's sums are in (in L2: read past
    // L1, all six at once)
    __threadfence();
    u64 v[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = __ldcg(&acc[q]);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        cks[q] = (long long)v[q];
        sse[q] = (long long)v[3 + q];
    }
#pragma unroll
    for (int q = 0; q < 7; ++q) acc[q] = 0ull;  // ready for the next launch
}

}  // namespace

// oy, ry (h, w) int32; ouv, ruv (h / 2, w) int32 packed [U | V], 8-bit
// samples, the rows from picture row y0 (even) -> cks (3,), sse (3,) int64
// exact sums, in the order Y, U, V. acc: the scratch, 7 int64 at zero
// (the checksums' and SSEs' sums of Y, U, V, the ticket; left at zero).
// vec: every row of the four planes starts 16-byte aligned (w a multiple
// of 8, the pointers 16-byte aligned).
extern "C" int tpuhevc_grid_stats(const int* oy, const int* ouv,
                                  const int* ry, const int* ruv, int h, int w,
                                  int y0, long long* cks, long long* sse,
                                  long long* acc, int vec, void* stream) {
    if (acc == nullptr) return (int)cudaErrorInvalidValue;
    // tiles a row: the plane's runs of 4 (the last one ragged), 64 a tile
    const int ntx_l = ((w + 3) / 4 + kTileVecs - 1) / kTileVecs;
    const int ntx_c = ((w / 2 + 3) / 4 + kTileVecs - 1) / kTileVecs;
    const int nb_l = ntx_l * ((h + kRows - 1) / kRows);
    const int nb_c = ntx_c * ((h / 2 + kRows - 1) / kRows);
    // an empty stripe still takes one block, which writes the zero sums
    const int blocks = nb_l + 2 * nb_c > 0 ? nb_l + 2 * nb_c : 1;
    stats_kernel<<<blocks, dim3(kLanes, kRows), 0, (cudaStream_t)stream>>>(
        oy, ouv, ry, ruv, h, w, y0, vec, ntx_l, ntx_c, nb_l, nb_c, cks, sse,
        reinterpret_cast<u64*>(acc));
    return (int)cudaGetLastError();
}
