// b_me: the B step's two-list dense full-pel motion search, 8-bit or
// 10-bit video.
//
// Replaces: tpuhevc/codec/inter_b.py:142-163, `dense_me` (a closure of
// `_b_step` that XLA compiled for the TPU), run once per reference list.
//
// What it computes, per 16x16 block n (raster order over the picture) and
// list l: SAD(dy, dx) = sum |ref_l[clamp(y - sr + dy)][clamp(x - sr + dx)]
// - org[y][x]| over the block for every (dy, dx) in [0, 2sr]^2 (the
// edge-padded reference of the reference); the float32 cost
// (float)SAD + lam_me * mvb[dy * side + dx], the product rounded on its
// own (built with -fmad=false, as JAX evaluates it); the argmin over the
// WHOLE window, first flat index winning ties as in jnp.argmin; mv =
// (bi % side - sr, bi / side - sr); and sad9[k] = SAD at the flat index
// clamp(bi + (k / 3 - 1) * side + (k % 3 - 1), 0, side^2 - 1), so that at
// the window's left or right edge a neighbour wraps into the adjacent row
// exactly as the reference reads it.
//
// What bounds it: integer work, 2 x 1089 x 256 abs-diffs per block at
// sr = 16 (0.2 G at 416x240); device memory sees each window (48x48) and
// block once per list.
// Design: one block per (16x16 block, list). The clamped window and the
// block are staged once as 8-bit samples, four to a word (a thread a
// row's run of 16 samples, its row and run by shifts); each thread keeps
// the block's 16 rows in registers (64 words) and owns one dx and a band
// of kBand dy (from its index by a multiply-high): it loads each window row
// of its band once (five words, aligned to its dx by funnel shifts) and
// adds its abs-diffs, four samples an instruction (__vsadu4), into the
// accumulators of the band's offsets that meet that row, so a shared load
// serves up to kBand x 4 abs-diffs. The SAD surface stays in shared
// memory for sad9; the pick is the least 64-bit key (cost's order-keeping
// bits << 32 | flat index) by warp shuffles and a shared atomicMin, so
// the first flat index wins among equal costs; nine lanes read sad9.
// The packing is packed8.cuh's, shared with sad_search.cu.
// The 10-bit variant (`b_me10_kernel`, the caller's explicit bit_depth
// picks it, never the data) is the same design with 16-bit samples two
// to a word: a staged window row is 28 words (16-byte runs of 8
// samples), a thread aligns its 9 words to its dx by a halfword funnel
// shift and adds its abs-diffs two samples a call (__vsadu2) against
// the block's row, read from shared memory as two 16-byte broadcasts
// (the block's 128 words do not fit in registers). sm_90 has no
// instruction for __vsadu2 (it has one for __vsadu4): nvcc emulates it
// with byte permutes and IABS, about 3 instructions a sample against
// the 8-bit kernel's 0.4, and that bounds the variant. A 16x16 SAD at
// 10 bits is at most 261,888 (below 2^24), so its float32 cost is exact
// as at 8 bits.

#include "packed8.cuh"

namespace {

constexpr int kBlk = 16;
constexpr int kMaxSr = 16;
constexpr int kMaxWin = kBlk + 2 * kMaxSr;  // 48
constexpr int kMaxSide = 2 * kMaxSr + 1;    // 33
constexpr int kBand = 5;                    // dy a thread
constexpr int kPitch = 16;                  // words a staged window row
// window rows: a band past the last dy reads up to kBand - 1 rows beyond
constexpr int kWinRows = kMaxWin + kBand;

// the float cost's bits, made monotone as unsigned: the larger float, the
// larger key (negative costs included; -0 cannot occur: SAD + product)
__device__ __forceinline__ unsigned order_bits(float c) {
    const unsigned u = __float_as_uint(c);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// one block per (n, list) of 32 * ceil(side * bands / 32) threads, bands
// = ceil(side / kBand): thread tid < side * bands owns dx = tid % side
// and the band tid / side (a multiply-high by mag = ceil(2^32 / side));
// the rest only stage and reduce
__global__ void b_me_kernel(const int* __restrict__ org,
                            const int* __restrict__ ref0,
                            const int* __restrict__ ref1,
                            const float* __restrict__ mvb,
                            int* __restrict__ mv, int* __restrict__ sad9,
                            int H, int W, int sr, unsigned long long mag,
                            float lam_me) {
    __shared__ __align__(16) unsigned s_wnd[kWinRows][kPitch];
    __shared__ __align__(16) unsigned s_cur[kBlk][4];
    __shared__ int s_sad[kMaxSide * kMaxSide];
    __shared__ unsigned long long s_best;

    const int side = 2 * sr + 1, win = kBlk + 2 * sr, nw = W / kBlk;
    const int n = blockIdx.x, list = blockIdx.y;
    const int* ref = list ? ref1 : ref0;
    const int by = n / nw;  // once a block
    const int y0 = by * kBlk, x0 = (n - by * nw) * kBlk;
    const int tid = threadIdx.x;
    // stage: task t = (row t >> 2, run t & 3 of 16 samples); runs and rows
    // past the window zero
    for (int t = tid; t < kWinRows * 4; t += blockDim.x) {
        const int r = t >> 2, c = t & 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < win && c * 16 < win)
            v = run16(ref + (size_t)min(max(y0 - sr + r, 0), H - 1) * W,
                      x0 - sr + c * 16, W);
        *reinterpret_cast<uint4*>(&s_wnd[r][c * 4]) = v;
    }
    if (tid < kBlk)
        *reinterpret_cast<uint4*>(s_cur[tid]) =
            run16(org + (size_t)(y0 + tid) * W, x0, W);
    if (tid == 0) s_best = ~0ull;
    __syncthreads();

    const int band = (int)(((unsigned long long)tid * mag) >> 32);
    const int dx = tid - band * side, dy0 = band * kBand;
    const bool owner = dy0 < side;
    unsigned blk[kBlk][4];
#pragma unroll
    for (int r = 0; r < kBlk; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_cur[r]);
        blk[r][0] = v.x;
        blk[r][1] = v.y;
        blk[r][2] = v.z;
        blk[r][3] = v.w;
    }
    unsigned acc[kBand];
#pragma unroll
    for (int j = 0; j < kBand; ++j) acc[j] = 0;
    // a thread past the owners reads row 0 (its sums unused)
    const int c0 = dx >> 2, sh = (dx & 3) * 8, r0 = owner ? dy0 : 0;
#pragma unroll
    for (int t = 0; t < kBand + kBlk - 1; ++t) {
        // window row dy0 + t, samples [dx, dx + 16)
        const unsigned* wr = s_wnd[r0 + t] + c0;
        unsigned w[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) w[i] = wr[i];
        unsigned a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = __funnelshift_r(w[i], w[i + 1], sh);
#pragma unroll
        for (int j = 0; j < kBand; ++j) {
            const int br = t - j;  // the block row it meets at dy0 + j
            if (br < 0 || br >= kBlk) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j] += __vsadu4(a[i], blk[br][i]);
        }
    }
    unsigned long long best = ~0ull;
#pragma unroll
    for (int j = 0; j < kBand; ++j) {
        if (!owner || dy0 + j >= side) break;
        const int k = (dy0 + j) * side + dx;
        s_sad[k] = (int)acc[j];
        const float cost = (float)acc[j] + lam_me * __ldg(mvb + k);
        const unsigned long long key =
            ((unsigned long long)order_bits(cost) << 32) | (unsigned)k;
        best = min(best, key);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if ((tid & 31) == 0) atomicMin(&s_best, best);
    __syncthreads();  // also completes s_sad
    if (tid < 9) {
        const int bi = (int)(s_best & 0xffffffffu);
        const int ky = (tid >= 3) + (tid >= 6);
        const int j = bi + (ky - 1) * side + (tid - 3 * ky - 1);
        const size_t o = (size_t)list * gridDim.x + n;
        sad9[9 * o + tid] = s_sad[min(max(j, 0), side * side - 1)];
        if (tid == 0) {
            const int bdy = bi / side;  // once a block
            mv[2 * o] = bi - bdy * side - sr;
            mv[2 * o + 1] = bdy - sr;
        }
    }
}

// --- 10-bit: 16-bit samples two to a word -----------------------------------

constexpr int kPitch10 = 28;  // words a staged 10-bit window row: 7 runs

// two 16-bit samples (0..1023) packed into a word, the first lowest
__device__ __forceinline__ unsigned pack2(int a, int b) {
    return (unsigned)a | ((unsigned)b << 16);
}

// 8 samples p[clamp(x + i, 0, W - 1)] as 4 packed words: 16-byte loads
// where the run lies inside the row and is aligned
__device__ __forceinline__ uint4 run8x16(const int* __restrict__ p, int x,
                                         int W) {
    int s[8];
    if (x >= 0 && x + 8 <= W && (((uintptr_t)(p + x)) & 15) == 0) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(p + x));
        const int4 b = __ldg(reinterpret_cast<const int4*>(p + x) + 1);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = __ldg(p + min(max(x + i, 0), W - 1));
    }
    return make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]),
                      pack2(s[4], s[5]), pack2(s[6], s[7]));
}

// the launch of b_me_kernel at 10 bits: the same blocks, threads, owners
// and outputs
__global__ void b_me10_kernel(const int* __restrict__ org,
                              const int* __restrict__ ref0,
                              const int* __restrict__ ref1,
                              const float* __restrict__ mvb,
                              int* __restrict__ mv, int* __restrict__ sad9,
                              int H, int W, int sr, unsigned long long mag,
                              float lam_me) {
    __shared__ __align__(16) unsigned s_wnd[kWinRows][kPitch10];
    __shared__ __align__(16) unsigned s_cur[kBlk][8];
    __shared__ int s_sad[kMaxSide * kMaxSide];
    __shared__ unsigned long long s_best;

    const int side = 2 * sr + 1, win = kBlk + 2 * sr, nw = W / kBlk;
    const int n = blockIdx.x, list = blockIdx.y;
    const int* ref = list ? ref1 : ref0;
    const int by = n / nw;  // once a block
    const int y0 = by * kBlk, x0 = (n - by * nw) * kBlk;
    const int tid = threadIdx.x;
    // stage: task t = (row t / 7, run t % 7 of 8 samples); runs and rows
    // past the window zero
    for (int t = tid; t < kWinRows * 7; t += blockDim.x) {
        const int r = t / 7, c = t - r * 7;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < win && c * 8 < win)
            v = run8x16(ref + (size_t)min(max(y0 - sr + r, 0), H - 1) * W,
                        x0 - sr + c * 8, W);
        *reinterpret_cast<uint4*>(&s_wnd[r][c * 4]) = v;
    }
    if (tid < 2 * kBlk)
        *reinterpret_cast<uint4*>(&s_cur[tid >> 1][(tid & 1) * 4]) =
            run8x16(org + (size_t)(y0 + (tid >> 1)) * W, x0 + (tid & 1) * 8,
                    W);
    if (tid == 0) s_best = ~0ull;
    __syncthreads();

    const int band = (int)(((unsigned long long)tid * mag) >> 32);
    const int dx = tid - band * side, dy0 = band * kBand;
    const bool owner = dy0 < side;
    unsigned acc[kBand];
#pragma unroll
    for (int j = 0; j < kBand; ++j) acc[j] = 0;
    // a thread past the owners reads row 0 (its sums unused)
    const int c0 = dx >> 1, sh = (dx & 1) * 16, r0 = owner ? dy0 : 0;
#pragma unroll
    for (int t = 0; t < kBand + kBlk - 1; ++t) {
        // window row dy0 + t, samples [dx, dx + 16)
        const unsigned* wr = s_wnd[r0 + t] + c0;
        unsigned w[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) w[i] = wr[i];
        unsigned a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = __funnelshift_r(w[i], w[i + 1], sh);
#pragma unroll
        for (int j = 0; j < kBand; ++j) {
            const int br = t - j;  // the block row it meets at dy0 + j
            if (br < 0 || br >= kBlk) continue;
            const uint4 b0 = *reinterpret_cast<const uint4*>(&s_cur[br][0]);
            const uint4 b1 = *reinterpret_cast<const uint4*>(&s_cur[br][4]);
            acc[j] += __vsadu2(a[0], b0.x) + __vsadu2(a[1], b0.y)
                      + __vsadu2(a[2], b0.z) + __vsadu2(a[3], b0.w)
                      + __vsadu2(a[4], b1.x) + __vsadu2(a[5], b1.y)
                      + __vsadu2(a[6], b1.z) + __vsadu2(a[7], b1.w);
        }
    }
    unsigned long long best = ~0ull;
#pragma unroll
    for (int j = 0; j < kBand; ++j) {
        if (!owner || dy0 + j >= side) break;
        const int k = (dy0 + j) * side + dx;
        s_sad[k] = (int)acc[j];
        const float cost = __int2float_rn((int)acc[j]) + lam_me * __ldg(mvb + k);
        const unsigned long long key =
            ((unsigned long long)order_bits(cost) << 32) | (unsigned)k;
        best = min(best, key);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
    if ((tid & 31) == 0) atomicMin(&s_best, best);
    __syncthreads();  // also completes s_sad
    if (tid < 9) {
        const int bi = (int)(s_best & 0xffffffffu);
        const int ky = (tid >= 3) + (tid >= 6);
        const int j = bi + (ky - 1) * side + (tid - 3 * ky - 1);
        const size_t o = (size_t)list * gridDim.x + n;
        sad9[9 * o + tid] = s_sad[min(max(j, 0), side * side - 1)];
        if (tid == 0) {
            const int bdy = bi / side;  // once a block
            mv[2 * o] = bi - bdy * side - sr;
            mv[2 * o + 1] = bdy - sr;
        }
    }
}

}  // namespace

// org, ref0, ref1 (H, W) int32 planes of samples of bit_depth (8: 0..255,
// packed four to a word; 10: 0..1023, two to a word) on the device, H and
// W multiples of 16; sr 1..16; mvb (side * side) float32, side = 2 sr + 1.
// Writes mv (2, n, 2) and sad9 (2, n, 9) int32, n = (H / 16) * (W / 16),
// list 0 first.
extern "C" int tpuhevc_b_me(const int* org, const int* ref0, const int* ref1,
                            const float* mvb, int* mv, int* sad9, int H,
                            int W, int sr, float lam_me, int bit_depth,
                            void* stream) {
    if (sr < 1 || sr > kMaxSr || H % kBlk || W % kBlk
        || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    const int side = 2 * sr + 1;
    const int n = (H / kBlk) * (W / kBlk);
    const int owners = side * ((side + kBand - 1) / kBand);
    const unsigned long long mag = ((1ULL << 32) + side - 1) / side;
    if (bit_depth == 10)
        b_me10_kernel<<<dim3(n, 2), (owners + 31) / 32 * 32, 0,
                        (cudaStream_t)stream>>>(org, ref0, ref1, mvb, mv,
                                                sad9, H, W, sr, mag, lam_me);
    else
        b_me_kernel<<<dim3(n, 2), (owners + 31) / 32 * 32, 0,
                      (cudaStream_t)stream>>>(org, ref0, ref1, mvb, mv, sad9,
                                              H, W, sr, mag, lam_me);
    return (int)cudaGetLastError();
}
