// b_pred: the B step's two-list prediction and uni/bi arbitration on luma,
// then the chroma planes' prediction from the chosen lists, a B picture in
// one launch.
//
// Replaces: tpuhevc/codec/inter_b.py:196-222 (luma) and 225-232 (chroma),
// the prediction part of `step` in `_b_step` that XLA compiled for the
// TPU, over tpuhevc/ops/interp.py:141-211 (`mc`, `mc14`, `bi_average`),
// at bit depth BD (8 or 10, a template argument: the 10-bit variant is the
// 8-bit code with its shifts and clip compiled in, one launch one depth).
//
// What it computes, per 16x16 block n and list l: the integer position
// (x + (mv >> FS), y + (mv >> FS)) and the phase (mv & FM), with >> and &
// on signed ints (floor, as in JAX); the (S + NT - 1)^2 window clamped at
// the plane edge, sample by sample; the separable DCT-IF filter to the
// 14-bit intermediate p_l = (sum_i ((sum_j win * th[j]) >> (BD - 8)) *
// tv[i]) >> 6; the uni predictions u_l = clip((p_l + 2^(13 - BD)) >>
// (14 - BD), 0, 2^BD - 1) and the bi-average clip((p_0 + p_1 +
// 2^(14 - BD)) >> (15 - BD), 0, 2^BD - 1). On luma (8 taps, quarter pel:
// NT 8, FS 2, FM 3) the int32 SSEs of the three against cur (exact: at 10
// bits a 16x16 SSE reaches ~2.7e8, above 2^24 but below 2^31), each
// converted once to float32 with round-to-nearest as JAX's astype does,
// and the costs
//   cost_l  = sse_l  + lam * (b_l + 2)
//   cost_bi = sse_bi + lam * (b_0 + b_1 + 2),  b_l = (|mvx| + |mvy|) / 4 + 4
// each product rounded on its own (built with -fmad=false, as JAX
// evaluates them); inter_dir = 3 if cost_bi <= min(cost_0, cost_1), else
// 1 if cost_0 <= cost_1, else 2; the luma prediction inter_dir selects.
// Then U and V (8x8 at (x / 2, y / 2), 4 taps, eighth pel of the chroma
// grid: NT 4, FS 3, FM 7, the same MVs): the prediction inter_dir
// selects, filtering only the list or lists it uses (the same output as
// filtering both and selecting). The one-plane entries are the same
// kernel: luma alone (deciding), or one chroma plane with inter_dir given.
//
// What bounds it: the window gathers from the reference planes (23x23 a
// list a 16x16 luma block, 11x11 a used list a chroma block, mostly L2
// hits) and ~2 x 8 MACs per 14-bit luma sample; ~0.0006 ms of bytes a
// 416x240 B picture, so the chain of dependent steps a block sets the
// time.
// Design: a warp a 16x16 block (a block of 32 threads) for all three
// planes, no block barrier and no single-thread step. Luma: a half-warp
// a list, lane c on output column c; the lane loads columns c and c + 16
// of its list's window into the warp's shared slice (the two lists 16
// banks apart), then filters its column in registers: the horizontal
// pass of its 23 rows, the vertical pass of its 16 outputs. A shuffle
// across the halves hands each lane both lists at its column for 8 rows
// (half l takes rows 8 l .. 8 l + 7), so the three SSEs are a lane's 8
// rows and xor-shuffles over the warp, and every lane works out
// inter_dir. Chroma: lane (plane, sub, column) of 2 x 2 x 8; with both
// lists a lane filters list sub's 8 rows and takes the other list's from
// lane ^ 8, with one list it filters rows 4 sub .. 4 sub + 3 of that
// list. The taps are compiled in; window rows and columns come from the
// lane index and shifts, with no division.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// H.265 Tables 8-12 (luma, a quarter-pel phase a row) and 8-13 (chroma, an
// eighth-pel phase a row): equal to tpuhevc_torch/ops/interp.py LUMA_TAPS
// and CHROMA_TAPS (`tpuhevc_b_pred_taps` hands them out for the check)
__constant__ int c_luma_taps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int c_chroma_taps[8][4] = {
    {0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

constexpr int kWin = 23;    // a luma list's window side, 16 + 8 - 1
constexpr int kPitch = 24;  // its rows' pitch in shared memory
// a list's slice; list 1 starts 16 banks after list 0
constexpr int kListWords = kWin * kPitch + 8;

struct BPredJob {
    const int* cur;    // (n, 16, 16) luma originals (luma only)
    const int* ry0;    // luma planes (H, W) of lists 0 and 1
    const int* ry1;
    const int* rc0a;   // chroma plane a (Hc, Wc) of lists 0 and 1
    const int* rc1a;
    const int* rc0b;   // chroma plane b
    const int* rc1b;
    int* pred_y;       // (n, 16, 16)
    int* pred_a;       // (n, 8, 8) a plane
    int* pred_b;
    const int* xs;     // (n,) block positions (luma samples; chroma
    const int* ys;     // samples where luma = 0)
    const int* mvq0;   // (n, 2) quarter-pel MVs of each list
    const int* mvq1;
    int* inter_dir;    // (n,): written with luma, read without
    int H, W, Hc, Wc;
    int luma;     // 1: luma, deciding inter_dir
    int nchroma;  // chroma planes, 0..2
    int cshift;   // a chroma position: the block's position >> cshift
    float lam;    // the full lambda, rounded to float32
};

// a sample clipped to 0..2^BD - 1
template <int BD>
__device__ __forceinline__ int clip_bd(int v) {
    return min(max(v, 0), (1 << BD) - 1);
}


__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// Luma of block n: the two lists, the three costs, inter_dir (returned in
// every lane) and the chosen prediction.
template <int BD>
__device__ __forceinline__ int luma_block(const BPredJob& job, int n, int x,
                                          int y, int2 m0, int2 m1,
                                          int* s_win) {
    const int lane = threadIdx.x, l = lane >> 4, c = lane & 15;
    const int2 mv = l ? m1 : m0;
    const int* ref = l ? job.ry1 : job.ry0;
    const int H = job.H, W = job.W;
    // the originals this lane scores: column c of rows 8 l .. 8 l + 7
    int org[8];
    const int* cb = job.cur + (size_t)n * 256 + 128 * l + c;
#pragma unroll
    for (int r = 0; r < 8; ++r) org[r] = __ldg(cb + 16 * r);
    // the list's window: lane c loads columns c and c + 16 of each row
    const int ix = x + (mv.x >> 2) - 3, iy = y + (mv.y >> 2) - 3;
    const int xa = min(max(ix + c, 0), W - 1);
    const int xb = min(max(ix + c + 16, 0), W - 1);
    int* win = s_win + l * kListWords;
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
        const int* row = ref + (size_t)min(max(iy + r, 0), H - 1) * W;
        win[r * kPitch + c] = __ldg(row + xa);
        if (c < kWin - 16) win[r * kPitch + c + 16] = __ldg(row + xb);
    }
    __syncwarp();
    // column c filtered: the horizontal pass of 23 rows, the vertical of 16
    const int fx = mv.x & 3, fy = mv.y & 3;
    int th[8], tv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        th[i] = c_luma_taps[fx][i];
        tv[i] = c_luma_taps[fy][i];
    }
    int h[kWin];
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
        const int* s = win + r * kPitch + c;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += s[i] * th[i];
        h[r] = acc >> (BD - 8);
    }
    int p[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc += h[r + i] * tv[i];
        p[r] = acc >> 6;
    }
    // rows 8 l + r of both lists at column c: the lane keeps its own
    // list's and takes the other's from lane c of the other half
    int u0[8], u1[8], ub[8];
    int s0 = 0, s1 = 0, sb = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
        const int got = __shfl_xor_sync(kFull, l ? p[r] : p[8 + r], 16);
        const int q0 = l ? got : p[r];
        const int q1 = l ? p[8 + r] : got;
        u0[r] = clip_bd<BD>((q0 + (1 << (13 - BD))) >> (14 - BD));
        u1[r] = clip_bd<BD>((q1 + (1 << (13 - BD))) >> (14 - BD));
        ub[r] = clip_bd<BD>((q0 + q1 + (1 << (14 - BD))) >> (15 - BD));
        const int d0 = org[r] - u0[r], d1 = org[r] - u1[r];
        const int db = org[r] - ub[r];
        s0 += d0 * d0;
        s1 += d1 * d1;
        sb += db * db;
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    sb = warp_sum(sb);
    const float b0 = (float)((abs(m0.x) + abs(m0.y)) / 4 + 4);
    const float b1 = (float)((abs(m1.x) + abs(m1.y)) / 4 + 4);
    const float r0 = job.lam * (b0 + 2.0f);
    const float r1 = job.lam * (b1 + 2.0f);
    const float rb = job.lam * ((b0 + b1) + 2.0f);
    const float cost0 = __int2float_rn(s0) + r0;
    const float cost1 = __int2float_rn(s1) + r1;
    const float cost_bi = __int2float_rn(sb) + rb;
    const int dir = cost_bi <= fminf(cost0, cost1) ? 3
                  : (cost0 <= cost1 ? 1 : 2);
    if (lane == 0) job.inter_dir[n] = dir;
    int* out = job.pred_y + (size_t)n * 256 + 128 * l + c;
#pragma unroll
    for (int r = 0; r < 8; ++r)
        out[16 * r] = dir == 1 ? u0[r] : (dir == 2 ? u1[r] : ub[r]);
    return dir;
}

// ROWS 14-bit chroma outputs of column c from window row 0 at (ix, iy):
// the horizontal pass of ROWS + 3 rows, read through L1, then the
// vertical pass
template <int ROWS, int BD>
__device__ __forceinline__ void chroma_rows(const int* plane, int Hc, int Wc,
                                            int ix, int iy, int fx, int fy,
                                            int c, int (&v)[ROWS]) {
    int th[4], tv[4], xx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        th[i] = c_chroma_taps[fx][i];
        tv[i] = c_chroma_taps[fy][i];
        xx[i] = min(max(ix + c + i, 0), Wc - 1);
    }
    int h[ROWS + 3];
#pragma unroll
    for (int r = 0; r < ROWS + 3; ++r) {
        const int* row = plane + (size_t)min(max(iy + r, 0), Hc - 1) * Wc;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc += __ldg(row + xx[i]) * th[i];
        h[r] = acc >> (BD - 8);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc += h[r + i] * tv[i];
        v[r] = acc >> 6;
    }
}

// The chroma planes of block n at (cx, cy), from the lists dir uses.
template <int BD>
__device__ __forceinline__ void chroma_block(const BPredJob& job, int n,
                                             int cx, int cy, int2 m0,
                                             int2 m1, int dir) {
    const int lane = threadIdx.x;
    const int pl = lane >> 4, sub = (lane >> 3) & 1, c = lane & 7;
    const bool on = pl < job.nchroma;
    int* out = (pl ? job.pred_b : job.pred_a) + (size_t)n * 64 + c;
    if (dir == 3) {  // lane sub filters list sub; rows 4 sub .. of the sum
        const int2 mv = sub ? m1 : m0;
        const int* plane = pl ? (sub ? job.rc1b : job.rc0b)
                              : (sub ? job.rc1a : job.rc0a);
        int v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (on)
            chroma_rows<8, BD>(plane, job.Hc, job.Wc, cx + (mv.x >> 3) - 1,
                           cy + (mv.y >> 3) - 1, mv.x & 7, mv.y & 7, c, v);
        int o[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) o[r] = __shfl_xor_sync(kFull, v[r], 8);
        if (on) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int s = sub ? v[4 + k] + o[4 + k] : v[k] + o[k];
                out[8 * (4 * sub + k)] =
                    clip_bd<BD>((s + (1 << (14 - BD))) >> (15 - BD));
            }
        }
    } else if (on) {  // one list: lane sub filters its rows 4 sub .. + 3
        const int2 mv = dir == 1 ? m0 : m1;
        const int* plane = pl ? (dir == 1 ? job.rc0b : job.rc1b)
                              : (dir == 1 ? job.rc0a : job.rc1a);
        int v[4];
        chroma_rows<4, BD>(plane, job.Hc, job.Wc, cx + (mv.x >> 3) - 1,
                       cy + (mv.y >> 3) - 1 + 4 * sub, mv.x & 7, mv.y & 7, c,
                       v);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            out[8 * (4 * sub + k)] =
                clip_bd<BD>((v[k] + (1 << (13 - BD))) >> (14 - BD));
    }
}

template <int BD>
__global__ void __launch_bounds__(32)
b_pred_kernel(const __grid_constant__ BPredJob job) {
    __shared__ int s_win[2 * kListWords];
    const int n = blockIdx.x;
    const int x = __ldg(job.xs + n), y = __ldg(job.ys + n);
    const int2 m0 = __ldg(reinterpret_cast<const int2*>(job.mvq0) + n);
    const int2 m1 = __ldg(reinterpret_cast<const int2*>(job.mvq1) + n);
    const int dir = job.luma ? luma_block<BD>(job, n, x, y, m0, m1, s_win)
                             : __ldg(job.inter_dir + n);
    if (job.nchroma)
        chroma_block<BD>(job, n, x >> job.cshift, y >> job.cshift, m0, m1, dir);
}

}  // namespace

// ptrs (host memory, 15): cur (n, 16, 16), luma planes of lists 0 and 1
// (H, W), chroma plane a of lists 0 and 1, plane b of lists 0 and 1 (Hc,
// Wc), pred_y (n, 16, 16), pred_a, pred_b (n, 8, 8), xs, ys (n,), mvq0,
// mvq1 (n, 2; 8-byte aligned), inter_dir (n,): int32 on the device, the
// unused ones null. ints (8): n, H, W, Hc, Wc, luma (1: luma deciding
// inter_dir, 0: inter_dir given), nchroma (0..2), cshift (a chroma
// position is xs, ys >> cshift). lam: the full lambda rounded to float32.
// The planes hold samples of bit_depth 8 or 10.
extern "C" int tpuhevc_b_pred(void* const* ptrs, const int* ints, float lam,
                              int bit_depth, void* stream) {
    BPredJob job;
    job.cur = (const int*)ptrs[0];
    job.ry0 = (const int*)ptrs[1];
    job.ry1 = (const int*)ptrs[2];
    job.rc0a = (const int*)ptrs[3];
    job.rc1a = (const int*)ptrs[4];
    job.rc0b = (const int*)ptrs[5];
    job.rc1b = (const int*)ptrs[6];
    job.pred_y = (int*)ptrs[7];
    job.pred_a = (int*)ptrs[8];
    job.pred_b = (int*)ptrs[9];
    job.xs = (const int*)ptrs[10];
    job.ys = (const int*)ptrs[11];
    job.mvq0 = (const int*)ptrs[12];
    job.mvq1 = (const int*)ptrs[13];
    job.inter_dir = (int*)ptrs[14];
    const int n = ints[0];
    job.H = ints[1];
    job.W = ints[2];
    job.Hc = ints[3];
    job.Wc = ints[4];
    job.luma = ints[5];
    job.nchroma = ints[6];
    job.cshift = ints[7];
    job.lam = lam;
    if (n < 1 || job.nchroma < 0 || job.nchroma > 2
        || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    if (bit_depth == 8)
        b_pred_kernel<8><<<n, 32, 0, (cudaStream_t)stream>>>(job);
    else
        b_pred_kernel<10><<<n, 32, 0, (cudaStream_t)stream>>>(job);
    return (int)cudaGetLastError();
}

// The compiled-in taps (4 x 8 luma, then 8 x 4 chroma) into host memory.
extern "C" int tpuhevc_b_pred_taps(int* luma, int* chroma) {
    cudaMemcpyFromSymbol(luma, c_luma_taps, sizeof(int) * 32);
    cudaMemcpyFromSymbol(chroma, c_chroma_taps, sizeof(int) * 32);
    return (int)cudaGetLastError();
}
