// K3: DCT-IF motion-compensated prediction of whole blocks, every CU
// class's Y, U and V of a P picture in one launch.
//
// Replaces: tpuhevc/codec/inter_batch.py:166, `mc_blk` (a closure of
// build_ldp_scan that XLA compiled for the TPU); same semantics as
// tpuhevc/ops/interp.py:141 `mc` at 8 bits; at 10 bits `mc` (and the
// numpy `mc_np`) with their bit-depth shifts, which the scan's closure
// does not take (it keeps the 8-bit shifts at any depth).
//
// What it computes, per PU n of a job (a plane of a class: its PUs of
// size S, luma or chroma): the integer position (x + (mv >> FS),
// y + (mv >> FS)) and the phase (mv & FM), with >> and & on signed ints
// (floor, as in JAX); the (S + NT - 1)^2 window clamped at the plane edge;
// h[r][c] = (sum_i win[r][c + i] * taps[fx][i]) >> (BD - 8); v[r][c] =
// (sum_i h[r + i][c] * taps[fy][i]) >> 6 (the 14-bit intermediate, all in
// int32: the sums stay below 2^22); out = clip((v + 2^(13 - BD)) >>
// (14 - BD), 0, 2^BD - 1), BD the bit depth (8 or 10, a template
// argument: the 10-bit variant is the 8-bit code with its shifts and clip
// compiled in, one launch one depth).
// Luma: 8 taps, quarter pel (FS 2, FM 3, window offset 3); chroma: 4
// taps, eighth pel (FS 3, FM 7, offset 1).
//
// What bounds it: the bytes: the windows' union over the plane read once
// and the predictions written once (~0.0005 ms a 416x240 P picture), far
// below the ~0.002 ms a launch costs; the arithmetic is ~2 x 8
// multiply-adds an output sample. So the chain of dependent steps a warp
// and the number of launches set the time.
// Design: one launch for the jobs (up to 12: four classes, three planes
// each), each job's pointers and sizes by value in a `__grid_constant__`
// table and its blocks in turn, the largest PUs first. The PU size and
// the filter are compiled in (a template on S and luma); the taps are
// constant tables. A unit is R = min(S, 8) output rows of a PU, taken by
// a team of S lanes, lane c on column c (so a 32x32 PU is four warps, a
// warp holds two 16-wide units, four 8-wide or eight 4-wide); a unit's
// row and PU come from the lane index by shifts, with no division. The
// lane loads columns c and c + S (where inside the window) of the unit's
// R + NT - 1 clamped window rows, every load before the first shared
// store, into the team's slice of the warp's shared memory (each team's
// slice starts S banks after the last, so a warp's reads and writes
// meet no bank conflict); then filters its column in registers: the
// horizontal pass of its R + NT - 1 rows, the vertical pass of its R
// outputs; the outputs go back through the slice so that each lane
// stores R / 4 16-byte vectors of the unit's contiguous rows. A warp
// synchronises only itself; blocks are 4 independent warps.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxJobs = 12;
constexpr int kWarps = 4;  // independent warps a block

// H.265 Tables 8-12 (luma, a quarter-pel phase a row) and 8-13 (chroma, an
// eighth-pel phase a row): equal to tpuhevc_torch/ops/interp.py LUMA_TAPS
// and CHROMA_TAPS
__constant__ int c_luma_taps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};
__constant__ int c_chroma_taps[8][4] = {
    {0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// One job: a plane's PUs (n of size S), its first block.
struct McJob {
    const int* plane;  // (H, W)
    const int* xs;     // (n,) PU positions in this plane's samples
    const int* ys;
    const int* mvq;    // (n, 2) luma quarter pels / chroma eighth pels
    int* out;          // (n, S, S), 16-byte aligned
    int n, H, W, size, luma, block0;
};

struct McJobs {
    McJob j[kMaxJobs];
    int njobs;
};

// The shapes of one (S, luma) case.
template <int S, bool LUMA>
struct McShape {
    static constexpr int NT = LUMA ? 8 : 4;       // taps
    static constexpr int OFF = LUMA ? 3 : 1;      // window offset
    static constexpr int FS = LUMA ? 2 : 3;       // MV fraction bits
    static constexpr int FM = (1 << FS) - 1;
    static constexpr int R = S < 8 ? S : 8;       // output rows a unit
    static constexpr int RG = S / R;              // units a PU
    static constexpr int LOG_RG = RG == 4 ? 2 : (RG == 2 ? 1 : 0);
    static constexpr int WR = R + NT - 1;         // window rows a unit
    static constexpr int WIN = S + NT - 1;        // window columns
    static constexpr int PITCH = (WIN + 3) & ~3;  // a window row's words
    static constexpr int G = 32 / S;              // teams a warp
    static constexpr int LOG_S = S == 32 ? 5 : (S == 16 ? 4 : (S == 8 ? 3 : 2));
    // a team's slice: its window, rounded to whole bank rows, plus S
    // words, so that team g starts g * S banks along
    static constexpr int SLICE = ((WR * PITCH + 31) & ~31) + S;
    static_assert(R * S <= WR * PITCH, "the outputs fit the window slice");
    static_assert(NT - 1 <= S, "two loads a window row and lane");
};

// the most words a warp's teams take, over the six cases
constexpr int warp_words() {
    constexpr int w[6] = {
        McShape<32, true>::SLICE * McShape<32, true>::G,
        McShape<16, true>::SLICE * McShape<16, true>::G,
        McShape<8, true>::SLICE * McShape<8, true>::G,
        McShape<16, false>::SLICE * McShape<16, false>::G,
        McShape<8, false>::SLICE * McShape<8, false>::G,
        McShape<4, false>::SLICE * McShape<4, false>::G};
    int m = 0;
    for (int i = 0; i < 6; ++i) m = w[i] > m ? w[i] : m;
    return m;
}
constexpr int kWarpWords = warp_words();

// a sample clipped to 0..2^BD - 1
template <int BD>
__device__ __forceinline__ int clip_bd(int v) {
    return min(max(v, 0), (1 << BD) - 1);
}

// The warp's units of job k: warp `wid` of the job takes units wid * G ..
// wid * G + G - 1, a team each.
template <int S, bool LUMA, int BD>
__device__ __forceinline__ void mc_units(const McJob& k, int wid,
                                         int* s_warp) {
    using M = McShape<S, LUMA>;
    constexpr int NT = M::NT, R = M::R, WR = M::WR, PITCH = M::PITCH;
    const int lane = threadIdx.x & 31;
    const int g = lane >> M::LOG_S, c = lane & (S - 1);
    const int units = k.n << M::LOG_RG;
    const int u0 = wid * M::G + g;
    const bool live = u0 < units;
    const int u = live ? u0 : units - 1;  // a spare team repeats the last
    const int n = u >> M::LOG_RG, rg = u & (M::RG - 1);
    int* s = s_warp + g * M::SLICE;

    const int x = __ldg(k.xs + n), y = __ldg(k.ys + n);
    const int mvx = __ldg(k.mvq + 2 * n), mvy = __ldg(k.mvq + 2 * n + 1);
    const int ix = x + (mvx >> M::FS) - M::OFF;
    const int iy = y + (mvy >> M::FS) - M::OFF + rg * R;
    const int xa = min(max(ix + c, 0), k.W - 1);
    const int xb = min(max(ix + c + S, 0), k.W - 1);
    const bool second = c < NT - 1;  // column c + S lies in the window
    // every load of the unit's window before the first shared store
    int va[WR], vb[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
        const int* row = k.plane + (size_t)min(max(iy + r, 0), k.H - 1) * k.W;
        va[r] = __ldg(row + xa);
        vb[r] = second ? __ldg(row + xb) : 0;
    }
    const int fx = mvx & M::FM, fy = mvy & M::FM;
    int th[NT], tv[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
        if constexpr (LUMA) {
            th[i] = c_luma_taps[fx][i];
            tv[i] = c_luma_taps[fy][i];
        } else {
            th[i] = c_chroma_taps[fx][i];
            tv[i] = c_chroma_taps[fy][i];
        }
    }
#pragma unroll
    for (int r = 0; r < WR; ++r) {
        s[r * PITCH + c] = va[r];
        if (second) s[r * PITCH + c + S] = vb[r];
    }
    __syncwarp();
    // column c: the horizontal pass of WR rows, the vertical of R
    int h[WR];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
        const int* w = s + r * PITCH + c;
        int acc = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc += w[i] * th[i];
        h[r] = acc >> (BD - 8);
    }
    int o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        int acc = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) acc += h[r + i] * tv[i];
        o[r] = clip_bd<BD>(((acc >> 6) + (1 << (13 - BD))) >> (14 - BD));
    }
    // the unit's R x S outputs through the slice, out as 16-byte vectors
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) s[r * S + c] = o[r];
    __syncwarp();
    if (live) {
        int4* dst = reinterpret_cast<int4*>(k.out + (size_t)n * S * S
                                            + rg * R * S);
        const int4* src = reinterpret_cast<const int4*>(s);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) dst[c + q * S] = src[c + q * S];
    }
}

template <int BD>
__global__ void __launch_bounds__(kWarps * 32)
mc_blk_jobs(const __grid_constant__ McJobs jobs) {
    __shared__ __align__(16) int s_mem[kWarps][kWarpWords];
    const int b = blockIdx.x;
    int k = 0;  // this block's job
    while (k + 1 < jobs.njobs && b >= jobs.j[k + 1].block0) ++k;
    const McJob& j = jobs.j[k];
    const int warp = threadIdx.x >> 5;
    const int wid = (b - j.block0) * kWarps + warp;
    int* s = s_mem[warp];
    if (j.luma) {
        switch (j.size) {
            case 32: mc_units<32, true, BD>(j, wid, s); break;
            case 16: mc_units<16, true, BD>(j, wid, s); break;
            default: mc_units<8, true, BD>(j, wid, s); break;
        }
    } else {
        switch (j.size) {
            case 16: mc_units<16, false, BD>(j, wid, s); break;
            case 8: mc_units<8, false, BD>(j, wid, s); break;
            default: mc_units<4, false, BD>(j, wid, s); break;
        }
    }
}

// the warps a job of n PUs of size S takes
int job_warps(int n, int size) {
    const int units = n * (size / (size < 8 ? size : 8));
    const int teams = 32 / size;
    return (units + teams - 1) / teams;
}

}  // namespace

// njobs jobs (1..12) in one launch, in the order given (the caller puts
// the largest PUs first). Job i: ptrs[5 i ..] = plane (H, W), xs, ys
// (n,), mvq (n, 2) int32 in, out (n, S, S) int32 (16-byte aligned), all
// on the device; ints[5 i ..] = n >= 1, H, W, S, luma (1: luma, S in 8,
// 16, 32, quarter-pel MVs; 0: chroma, S in 4, 8, 16, eighth-pel MVs).
// The planes hold samples of bit_depth 8 or 10. The arrays lie in host
// memory and go by value into the launch.
extern "C" int tpuhevc_mc_blk(int njobs, void* const* ptrs, const int* ints,
                              int bit_depth, void* stream) {
    if (njobs < 1 || njobs > kMaxJobs || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    McJobs jobs = {};
    jobs.njobs = njobs;
    int blocks = 0;
    for (int i = 0; i < njobs; ++i) {
        McJob& j = jobs.j[i];
        j.plane = (const int*)ptrs[5 * i];
        j.xs = (const int*)ptrs[5 * i + 1];
        j.ys = (const int*)ptrs[5 * i + 2];
        j.mvq = (const int*)ptrs[5 * i + 3];
        j.out = (int*)ptrs[5 * i + 4];
        const int* v = ints + 5 * i;
        j.n = v[0];
        j.H = v[1];
        j.W = v[2];
        j.size = v[3];
        j.luma = v[4];
        const bool ok = j.luma ? (j.size == 8 || j.size == 16 || j.size == 32)
                               : (j.size == 4 || j.size == 8 || j.size == 16);
        if (j.n < 1 || j.H < 1 || j.W < 1 || !ok ||
            (((size_t)j.out) & 15))
            return (int)cudaErrorInvalidValue;
        j.block0 = blocks;
        blocks += (job_warps(j.n, j.size) + kWarps - 1) / kWarps;
    }
    if (bit_depth == 8)
        mc_blk_jobs<8><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(jobs);
    else
        mc_blk_jobs<10><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(jobs);
    return (int)cudaGetLastError();
}
