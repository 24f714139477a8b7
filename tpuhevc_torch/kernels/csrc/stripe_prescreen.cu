// stripe_prescreen: the open-loop 35-mode intra prescreen of the row
// stripes of a luma plane that sit on one device, in one launch.
//
// Replaces: tpuhevc/parallel/mesh.py:32-103 `tile_prescreen`, its
// per-device `local` (56-96), which XLA compiled for each TPU of a mesh
// under shard_map; the halo row came over ICI by ppermute (here the caller
// copies the row above a device's first stripe, parallel/mesh.py).
//
// What it computes, for k consecutive stripes of hl rows (`rows`, k hl x
// W) and every 8x8 block (by, bx) of a stripe, with `padded` = [the row
// above the stripe; the stripe] (hl + 1 rows; above stripe 0 the `halo`
// row, mid-grey 1 << (bd - 1) where there is none, the picture's first
// stripe; above stripe j > 0 the last row of stripe j - 1, read in place):
//   top[i]  = padded[by][clip(bx - 1 + i, 0, W - 1)],         i = 0..16,
//   left[i] = padded[min(by + i, hl)][clip(bx - 1, 0, W - 1)], i = 0..16,
//             all mid-grey where bx == 0 (the left clamp is each stripe's
//             own last row: the advisory below-left samples stay in the
//             stripe);
// the 35 predictions of intra_pred.cuh from (top, left) at 8x8 luma (the
// [1 2 1] filtering of the modes that take it, the DC and VER/HOR
// boundary filters from the unfiltered arrays), each mode's cost
// (sum |H d H^T| + 2) >> 2 over the residual d = block - prediction (H
// the 8x8 Hadamard), and the first mode of least cost with that cost,
// into the group's (k hl / 8, W / 8) maps. Integer and exact.
//
// What bounds it: the plane is read once (four bytes a sample), and each
// sample costs 35 predictions and 35 Hadamard terms: about 1,000 integer
// operations an 8-byte output pair, so operations bound it on paper; at
// the path's sizes (1,560 blocks at 416x240) the launch, the first loads
// and the instructions of a round per SM do.
// Design: one launch a device over all its stripes, a CTA of 7 warps a
// run of 4 adjacent 8x8 blocks of a block row (the grid (runs, block rows
// of a stripe, stripes), so positions and each stripe's last row come
// from blockIdx with no division); a team of 8 lanes a block, lane r its
// row r. Every load from device memory is issued first, with no branch:
// a lane's 8 samples as two 16-byte loads, kept in registers, and a
// thread a sample of t or l with the samples its [1 2 1] filtering reads.
// After a barrier, from shared memory: the DC (an 8-lane shuffle sum),
// each lane's column of its block, and for each mode of negative angle
// (11..25) the extended reference of HM's xPredIntraAng, ext[k] = k >= 0
// ? main[k] : side[(k inv + 128) >> 8] (a block's ext arrays padded so
// that the 4 teams read other banks). After a second barrier a warp takes
// one mode a round over five rounds (mode = 7 round + warp), so the
// angle, inverse angle, filter flag and the planar / DC / angular branch
// are warp-uniform. A horizontal mode (2..17) is computed as its
// transpose, the vertical form with t and l swapped, against the block's
// columns (the SATD of a transposed residual is the same), so every
// angular lane has one angle position and a sample is two shared reads
// and the interpolation, with no branch. The Hadamard runs in registers
// (hadamard.cuh's signed variant: the row butterflies, then each column
// stage a shuffle and a multiply-add by the lane's sign). A team keeps
// the least key (cost << 6) | mode (cost < 2^22 at bd 12), the 7 warps'
// keys meet in a shared atomicMin (the first mode of least cost) and one
// lane a block writes its mode and cost. On an H100 the first design
// (one barrier, every derived array computed from device memory, the
// horizontal modes row by row) was slower, and 9, 12, 14 and 18 warps a
// CTA, the rounds unrolled or not, and the Hadamard's columns through
// shared memory were no faster (PERF.md row 29a).

#include <climits>

#include "hadamard.cuh"
#include "intra_pred.cuh"

namespace {

constexpr int kWarps = 7, kThreads = kWarps * 32;
constexpr int kRun = 4;    // 8x8 blocks a CTA
constexpr int kRounds = 35 / kWarps;  // a mode a warp a round
static_assert(kRounds * kWarps == 35, "every warp takes kRounds modes");
constexpr int kL = 18;     // a reference array, its last sample again at 17
constexpr int kNegFirst = 11, kNeg = 15;  // the modes of negative angle
constexpr int kExt = 16;   // ext[k], k in [-7, 8], at k + 7
// a block's ext arrays, 8 words of padding after them: the 4 blocks'
// arrays start 0, 24, 16 and 8 banks along
constexpr int kExtBlock = kNeg * kExt + 8;
constexpr int kOrg = 72;   // a block's 8x8 samples, blocks 72 words apart
constexpr unsigned kFull = 0xffffffffu;

// the samples of one block's references, read from device memory with
// no branch: every address valid (the mid-grey samples read the row
// itself, then replaced), so that a thread's loads are in flight together
struct Refs {
    const int* top;   // the row above the block, or any row
    const int* left;  // the column left of the block, row 0 (a stride w)
    const int* halo;  // the row above the group, or any row
    int w, bx, y0, last, mid;  // y0 the block's group row, last its stripe's
    bool top_mid, halo_mid;    // no row above: mid-grey

    __device__ __forceinline__ int t(int i) const {
        const int v = __ldg(top + min(max(bx - 1 + i, 0), w - 1));
        return top_mid ? mid : v;
    }
    __device__ __forceinline__ int l(int i) const {
        const int g = min(y0 - 1 + i, last);  // the group row, -1: the halo
        const int v = __ldg(g >= 0 ? left + (size_t)g * w
                                   : halo + max(bx - 1, 0));
        return bx == 0 || (g < 0 && halo_mid) ? mid : v;
    }
    __device__ __forceinline__ int at(int side, int i) const {
        return side ? l(i) : t(i);
    }
};

// the key (cost << 6) | m of a team's block less the prediction p: its
// row r, or with `col` its column r (p a horizontal mode's)
__device__ __forceinline__ int cost_key(const int (&row)[8],
                                        const int (&col)[8], bool use_col,
                                        const int (&p)[8], int r, int m) {
    int v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = (use_col ? col[c] : row[c]) - p[c];
    return (((hadamard8_lanes_abs_sum_signed(v, r) + 2) >> 2) << 6) | m;
}

// angular mode m (2..34) at lane r of a team: row r of its prediction
// for modes 18..34 and column r for modes 2..17 (a horizontal mode's
// block is the transpose of the vertical one's with t and l swapped, and
// its SATD that of the transposed residual), from the block's arrays
// ref (t, l, ft, fl) and its negative-angle modes' ext: one angle
// position a lane, no branch a sample; the VER / HOR boundary filter
// (modes 26 and 10) on the first sample
__device__ __forceinline__ void angular(int (&p)[8], int m,
                                        const int (&ref)[4][kL],
                                        const int* ext, int r,
                                        int maxv) {
    const bool vert = m >= 18;
    const int* e =  // e[0] of the mode: main[0], or its ext's
        m >= kNegFirst && m < kNegFirst + kNeg
            ? ext + (m - kNegFirst) * kExt + 7
            : ref[(c_filter[35 + m] ? 2 : 0) + !vert];
    const int pos = (r + 1) * c_angle[m], f = pos & 31;
    const int* q = e + (pos >> 5) + 1;
#pragma unroll
    for (int c = 0; c < 8; ++c)
        p[c] = ((32 - f) * q[c] + f * q[c + 1] + 16) >> 5;
    if (m == 26 || m == 10) {
        const int* a = ref[!vert];  // the unfiltered main array, then side
        const int* b = ref[vert];
        p[0] = min(max(a[1] + ((b[r + 1] - b[0]) >> 1), 0), maxv);
    }
}

__global__ void __launch_bounds__(kThreads)
stripe_prescreen_runs(const int* __restrict__ rows,
                      const int* __restrict__ halo, int* __restrict__ mode_out,
                      int* __restrict__ cost_out, int hl, int w, int bd) {
    // a block's t, l, ft, fl; its negative-angle modes' ext; its samples;
    // its DC and key
    __shared__ int s_ref[kRun][4][kL];
    __shared__ int s_ext[kRun][kExtBlock];
    __shared__ __align__(16) int s_org[kRun * kOrg];
    __shared__ int s_dc[kRun];
    __shared__ int s_key[kRun];
    const int nbw = w >> 3;
    const int b0 = blockIdx.x * kRun;  // the run's first block column
    const int nb = min(kRun, nbw - b0);
    const int brow = blockIdx.z * (hl >> 3) + blockIdx.y;  // in the group
    const int y0 = brow << 3, last = (blockIdx.z + 1) * hl - 1;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // a team of 8 lanes a block (the blocks past the row's end repeat its
    // last: computed, not written), lane r its row r
    const int team = lane >> 3, r = lane & 7;
    const int bt = min(team, nb - 1);

    // every load from device memory first: a lane's row of its team's
    // block (two 16-byte loads), and a thread a sample of a reference
    // array with what its [1 2 1] filtering reads (the corner from l[1],
    // t[0], t[1]; the last sample unfiltered, again at 17)
    int orow[8];
    {
        const int4* p = reinterpret_cast<const int4*>(
            rows + (size_t)(y0 + r) * w + ((b0 + bt) << 3));
        const int4 a = __ldg(p), c = __ldg(p + 1);
        orow[0] = a.x; orow[1] = a.y; orow[2] = a.z; orow[3] = a.w;
        orow[4] = c.x; orow[5] = c.y; orow[6] = c.z; orow[7] = c.w;
        if (warp == 0) {  // the blocks' samples, for the columns
            int4* o = reinterpret_cast<int4*>(s_org + team * kOrg + r * 8);
            o[0] = a;
            o[1] = c;
        }
    }
    if (tid < kRun * 2 * kL) {
        const int b = tid / (2 * kL), side = (tid / kL) & 1;
        const int i = min(tid % kL, 16);
        const int bx = (b0 + min(b, nb - 1)) << 3;
        const Refs R{y0 > 0 ? rows + (size_t)(y0 - 1) * w : halo ? halo : rows,
                     rows + max(bx - 1, 0), halo ? halo : rows, w, bx, y0,
                     last, 1 << (bd - 1), y0 == 0 && !halo, !halo};
        const int v = R.at(side, i), a = R.at(side, max(i - 1, 0));
        const int c = R.at(side, min(i + 1, 16));
        const int corner = (R.l(1) + 2 * R.t(0) + R.t(1) + 2) >> 2;
        const int f = i == 0 ? corner : i == 16 ? v : (a + 2 * v + c + 2) >> 2;
        s_ref[b][side][tid % kL] = v;
        s_ref[b][2 + side][tid % kL] = f;
    }
    if (tid < kRun) s_key[tid] = INT_MAX;
    __syncthreads();

    // from shared memory: the DC, each negative-angle mode's ext (k from
    // the least the mode reads to 8; below that unset) and a lane's
    // column of its block
    if (warp == kWarps - 1) {  // a team a block, a lane a sample pair
        int s = s_ref[team][0][1 + r] + s_ref[team][1][1 + r];
#pragma unroll
        for (int h = 1; h < 8; h <<= 1) s += __shfl_xor_sync(kFull, s, h);
        if (r == 0) s_dc[team] = (s + 8) >> 4;
    }
#pragma unroll
    for (int j = 0; j < (kRun * kNeg * kExt + kThreads - 1) / kThreads; ++j) {
        const int x = tid + j * kThreads;
        const int b = x / (kNeg * kExt), g = (x / kExt) % kNeg;
        const int k = x % kExt - 7, m = kNegFirst + g;
        if (x < kRun * kNeg * kExt && k > (8 * c_angle[m]) >> 5) {
            const bool top = (m >= 18) == (k >= 0);  // t (ft), else l (fl)
            const int i = k >= 0 ? k : (k * c_inv[m] + 128) >> 8;
            s_ext[b][g * kExt + k + 7] =
                s_ref[b][(c_filter[35 + m] ? 2 : 0) + !top][i];
        }
    }
    int ocol[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) ocol[c] = s_org[team * kOrg + c * 8 + r];
    __syncthreads();

    const int* t = s_ref[bt][0];
    const int* l = s_ref[bt][1];
    const int maxv = (1 << bd) - 1;
    int key;
    {  // the warp's first mode: planar, DC or angular
        const int m = warp;
        int p[8];
        if (m == 0) {  // planar
            const bool filt = c_filter[35];
            const int* tt = s_ref[bt][filt ? 2 : 0];
            const int* ll = s_ref[bt][filt ? 3 : 1];
            const int a = ll[1 + r], b = tt[9], base = (r + 1) * ll[9] + 8;
#pragma unroll
            for (int c = 0; c < 8; ++c)
                p[c] = ((7 - c) * a + (c + 1) * b + (7 - r) * tt[1 + c]
                        + base) >> 4;
        } else if (m == 1) {  // DC, its edge filter
            const int dc = s_dc[bt];
#pragma unroll
            for (int c = 0; c < 8; ++c)
                p[c] = r == 0 ? (t[c + 1] + 3 * dc + 2) >> 2 : dc;
            p[0] = r == 0 ? (l[1] + 2 * dc + t[1] + 2) >> 2
                          : (l[r + 1] + 3 * dc + 2) >> 2;
        } else {
            angular(p, m, s_ref[bt], s_ext[bt], r, maxv);
        }
        key = cost_key(orow, ocol, m > 1 && m < 18, p, r, m);
    }
    // the later modes, all angular
#pragma unroll
    for (int round = 1; round < kRounds; ++round) {
        const int m = round * kWarps + warp;  // warp-uniform
        int p[8];
        angular(p, m, s_ref[bt], s_ext[bt], r, maxv);
        key = min(key, cost_key(orow, ocol, m < 18, p, r, m));
    }
    if (r == 0 && team < nb) atomicMin(&s_key[team], key);
    __syncthreads();
    if (tid < nb) {
        const int o = brow * nbw + b0 + tid, k = s_key[tid];
        mode_out[o] = k & 63;
        cost_out[o] = k >> 6;
    }
}

}  // namespace

// Copies per-mode angles, inverse angles (modes 11..25, else 0) and the
// filter flags [log2 - 2][mode] (int32, host memory) to constant memory
// of the current device. Call once per device before
// tpuhevc_stripe_prescreen_rows.
extern "C" int tpuhevc_stripe_prescreen_init(const int* angle, const int* inv,
                                             const int* filter) {
    return intra_pred_load_tables(angle, inv, filter);
}

// rows (k hl, w) int32 on the device, 16-byte aligned: k stripes of hl
// rows, hl and w multiples of 8; halo (w) int32 the row above the first
// stripe, or null (mid-grey) -> mode, cost (k hl / 8, w / 8) int32.
extern "C" int tpuhevc_stripe_prescreen_rows(const int* rows, const int* halo,
                                             int* mode, int* cost, int k,
                                             int hl, int w, int bd,
                                             void* stream) {
    if (k <= 0 || hl <= 0 || w <= 0) return 0;
    if (hl % 8 || w % 8 || k > 65535 || hl / 8 > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((w / 8 + kRun - 1) / kRun, hl / 8, k);
    stripe_prescreen_runs<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        rows, halo, mode, cost, hl, w, bd);
    return (int)cudaGetLastError();
}
