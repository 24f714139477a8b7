// b_me: the B step's two-list dense full-pel motion search, 8-bit video.
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

}  // namespace

// org, ref0, ref1 (H, W) int32 planes of 8-bit samples (0..255) on the
// device, H and W multiples of 16; sr 1..16; mvb (side * side) float32,
// side = 2 sr + 1. Writes mv (2, n, 2) and sad9 (2, n, 9) int32, n = (H /
// 16) * (W / 16), list 0 first.
extern "C" int tpuhevc_b_me(const int* org, const int* ref0, const int* ref1,
                            const float* mvb, int* mv, int* sad9, int H,
                            int W, int sr, float lam_me, void* stream) {
    if (sr < 1 || sr > kMaxSr || H % kBlk || W % kBlk)
        return (int)cudaErrorInvalidValue;
    const int side = 2 * sr + 1;
    const int n = (H / kBlk) * (W / kBlk);
    const int owners = side * ((side + kBand - 1) / kBand);
    const unsigned long long mag = ((1ULL << 32) + side - 1) / side;
    b_me_kernel<<<dim3(n, 2), (owners + 31) / 32 * 32, 0,
                  (cudaStream_t)stream>>>(org, ref0, ref1, mvb, mv, sad9, H,
                                          W, sr, mag, lam_me);
    return (int)cudaGetLastError();
}
