// intra_wave: fixed-8x8 intra coding of whole pictures, wave by wave.
//
// Replaces: tpuhevc/codec/intra_jax.py:182-314 (`build_frame_encoder`, the
// `lax.scan` of `step` 205-281 over the dependency wavefronts of 8x8
// cells) and its vmap over frames in `encode_frames_intra_jax_batch`
// (317-369), which XLA compiled for the TPU.
//
// What it computes, per frame f and wave s, for every cell of the wave
// (the schedule's slot word: x8, y8 and the flags; -1 marks an empty slot,
// and the cells fill the first slots), from the recon of the earlier waves:
//   refs: the 33 luma samples [lb(8), l(8), corner, t(8), tr(8)] around
//     the 8x8 block (left segments bottom-first; positions clamped to the
//     picture), substituted at segment granularity (section 8.4.4.2.2): an
//     unavailable segment takes the last sample of the nearest available
//     segment before it, else the first sample of the first available
//     one, else 1 << (BD - 1); chroma the same with 4x4 blocks (17
//     samples) on each half-size plane;
//   decision: for each of the 35 luma modes (intra_pred.cuh, the 8x8
//     reference filtering and boundary filters) cost = (sum |H d H^T| + 2)
//     >> 2 of d = org - pred + ((bits * sqlam_fp) >> 8),
//     bits 2 inside the three MPM candidates of the left and above modes
//     (1 where the neighbour is outside, the above one also at a CTU's
//     top row) and 6 outside; the first mode of least cost;
//   coding: residual, the 8x8 DCT, the flat intra quantiser, dequantiser
//     and inverse DCT (tx_common.cuh), rec = clip(pred + r) where any
//     level is non-zero, else pred; chroma the same at 4x4 (DCT) with the
//     luma mode (DM) at the chroma QP.
// The bit depth BD (8 or 10, a template argument) sets the reference with
// no source, the clips at (1 << BD) - 1 and the transform's shifts; the
// quantiser's constants come from the host at that depth; the SATD is not
// scaled by it (as tpuhevc's). Integer and exact: equal to the plain
// version and to JAX bit for bit.
//
// What bounds it: the dependency depth. A wave needs the recon of the
// one before, so a picture is `steps` rounds (238 at 416x240, 112 at
// 192x128) of a few thousand integer operations on at most a few dozen
// cells; the bytes (each plane once) and operations over the whole card
// take about 0.003 ms.
// Design: a thread block cluster of kCluster blocks of 1,024 threads a
// frame walks the waves in order, three phases a wave:
//   1. two warps a cell: the 33 luma references with the substitution
//      (each sample's source read from a table of the 32 availability
//      patterns, made once a launch by bit scans), the filtered
//      references and the DC value by a warp sum; the 2 x 17 chroma
//      references, their DC values and the MPM list; the warps also
//      start cp.async copies of the next wave's original blocks and of
//      the slot words two waves ahead, so no wave waits on device memory
//      for its inputs;
//   2. nine warp tasks a cell, split among the cluster's blocks, 4 modes
//      a warp (grouped by the predictor's path: positive angles,
//      negative angles), a lane a row of a mode (a column of a
//      horizontal mode, whose block is a vertical one's transpose: the
//      same SATD): the 8 predictions from the lane's 9 references, the
//      row butterfly in registers, the column butterflies by shuffles
//      (hadamard.cuh's, a multiply-add by the lane's sign a stage), the
//      cost packed as (cost << 6) | mode and the first least mode found
//      as the warp's minimum and an atomicMin a warp into every block's
//      key (distributed shared memory; a ring of three keys a cell, so
//      that a block a wave ahead never meets one being reset); then a
//      cluster barrier (a block barrier where kCluster is 1);
//   3. every block, a warp a (cell, luma) or (cell, chroma pair):
//      prediction, residual, the transform stages (tx_common.cuh's,
//      with 16-byte operand rows) meeting by __syncwarp, the levels
//      stored to device memory as they are made (by block 0), the
//      inverse only where a level is non-zero, the recon written
//      straight to the block's planes.
// Kernel<BD, true, C> keeps the recon planes on chip as 8-bit samples
// (16-bit at BD 10) and the mode map as bytes for the whole launch (1.5 w
// h + w h / 64 bytes at 8 bits: 151,320 at 416x240; 3 w h + w h / 64 at
// 10 bits, which fits at 192x128 but not at 416x240), each block its own
// copy, and writes them out once at the end with 16-byte stores;
// kernel<BD, false, 1>, for pictures whose planes do not fit, keeps them
// in the output tensors in device memory (the barrier makes a wave's
// writes visible to the next). Task indices come from the
// thread index and the slot words: no division on the per-task path.
// The cluster barrier costs ~0.6 us a wave, so four blocks a frame pay
// where a wave has many cells (416x240: 6.6 on average, 1.17 ms a launch
// of 3 frames against 1.35 with one block, profile_wave on an H100 80GB
// HBM3 at 700 W) and one block where it has few (192x128: 3.4, 0.51 ms
// against 0.52); the wrapper picks by the mean. A wave with the recon in
// device memory (832x480) takes about 1.6 times one with it on chip.

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "hadamard.cuh"
#include "intra_pred.cuh"
#include "tx_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "a warp a pattern of the substitution tables");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffc0u;  // the largest cost, mode 0
constexpr int kMaxSmem = 232448;
// shared words: the 8x8 and 4x4 DCT matrices and their transposes and the
// substitution tables (32 x (33 + 17) bytes), then per slot the org
// double buffer (2 x 96), luma refs t, l, ft, fl (4 x 17), chroma t, l of
// each plane (2 x 18), dc_y, dc_u, dc_v, MPM and a ring of 3 keys (8),
// transform scratch (192) and the slot ring (3)
constexpr int kFixedWords = 160 + 400;
constexpr int kOrg = 96, kRef = 68, kCRef = 36, kMisc = 8, kTx = 192;
constexpr int kCellWords = 2 * kOrg + kRef + kCRef + kMisc + kTx + 3;

// phase 2's mode of slot 4 g + m (g the group, a warp's 4 modes): the
// positive-angle modes, planar and DC with two of them, the negative-angle
// modes, then an empty slot (35), so that a warp's lanes take one path of
// the predictor where they can
__constant__ unsigned char c_slot_mode[36] = {
    2, 3, 4, 5, 6, 7, 8, 9, 10, 26, 27, 28, 29, 30, 31, 32, 0, 1,
    33, 34, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 35};

struct Quant {
    int scale, add, qbits, dqscale, dqshift;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// first sample of segment j (0..5) of the [lb, l, c, t, tr] run of an
// S x S block
template <int S>
__device__ __forceinline__ int seg_start(int j) {
    return j <= 2 ? j * S : (j - 1) * S + 1;
}

// The source of sample i (0..4S) of the substituted reference run [lb, l,
// c, t, tr] of an S x S block whose segments' availability is avail (bits
// 0-4): i itself where its segment is available, else the last sample of
// the nearest available segment before it, else the first sample of the
// first available one; 255 where none is (the sample takes 1 << (BD -
// 1)). Tabled
// once a launch for every avail.
template <int S>
__device__ __forceinline__ int ref_src(int i, int avail) {
    const int k = i < S ? 0 : i < 2 * S ? 1 : i == 2 * S ? 2
                : i <= 3 * S ? 3 : 4;
    if ((avail >> k) & 1) return i;
    const int below = avail & ((1 << k) - 1);
    if (below) return seg_start<S>(32 - __clz(below)) - 1;
    const int above = avail >> (k + 1);
    return above ? seg_start<S>(k + __ffs(above)) : 255;
}

// Sample src (ref_src's) of the reference run of the S x S block at (x0,
// y0) of a pw x ph plane of bit depth BD: positions clamped to the plane.
template <int S, int BD, typename T>
__device__ __forceinline__ int ref_at(const T* plane, int pw, int ph, int x0,
                                      int y0, int src) {
    const bool left = src < 2 * S;
    const int x = min(max(left ? x0 - 1 : x0 + src - 2 * S - 1, 0), pw - 1);
    const int y = min(max(left ? y0 + 2 * S - 1 - src : y0 - 1, 0), ph - 1);
    const int v = plane[y * pw + x];
    return src == 255 ? 1 << (BD - 1) : v;
}

__device__ __forceinline__ int4 ld4(const int* p) {
    return *reinterpret_cast<const int4*>(p);
}

// sum a[i] b[i] of two contiguous S-vectors (16-byte aligned)
template <int S>
__device__ __forceinline__ int dot_rows(const int* a, const int* b) {
    int acc = 0;
#pragma unroll
    for (int i = 0; i < S; i += 4) {
        const int4 x = ld4(a + i), y = ld4(b + i);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
    return acc;
}

// sum a[i] c[i S] of a contiguous S-vector and a column of stride S
template <int S>
__device__ __forceinline__ int dot_col(const int* a, const int* c) {
    int acc = 0;
#pragma unroll
    for (int i = 0; i < S; i += 4) {
        const int4 x = ld4(a + i);
        acc += x.x * c[i * S] + x.y * c[(i + 1) * S] + x.z * c[(i + 2) * S]
             + x.w * c[(i + 3) * S];
    }
    return acc;
}

// Output e of each stage of tx_common.cuh at S = 1 << L2 and bit depth
// BD (forward rows, forward columns, inverse columns, inverse rows), with
// T and its transpose TT in shared memory so that every operand row is a
// 16-byte vector; the same integer sums and shifts.
template <int L2, int BD>
__device__ __forceinline__ int fwd_rows(const int* A, const int* T, int e) {
    constexpr int S = 1 << L2, s1 = L2 + BD - 9;
    return (dot_rows<S>(A + (e >> L2) * S, T + (e & (S - 1)) * S)
            + (1 << (s1 - 1))) >> s1;
}

template <int L2>
__device__ __forceinline__ int fwd_cols(const int* B, const int* T, int e) {
    constexpr int S = 1 << L2;
    return (dot_col<S>(T + (e >> L2) * S, B + (e & (S - 1)))
            + (1 << (L2 + 5))) >> (L2 + 6);
}

template <int L2>
__device__ __forceinline__ int inv_cols(const int* A, const int* TT, int e) {
    constexpr int S = 1 << L2;
    return clip16((dot_col<S>(TT + (e >> L2) * S, A + (e & (S - 1))) + 64)
                  >> 7);
}

template <int L2, int BD>
__device__ __forceinline__ int inv_rows(const int* B, const int* TT, int e) {
    constexpr int S = 1 << L2, s3 = 20 - BD;
    return clip16((dot_rows<S>(B + (e >> L2) * S, TT + (e & (S - 1)) * S)
                   + (1 << (s3 - 1))) >> s3);
}

// The 8 luma predictions of lane q of mode m (8x8, the filtered
// references where the mode's flag is set, the boundary filters): row q
// for planar, DC and modes 18-34, column q for modes 2-17 (a horizontal
// mode's block is the transpose of the vertical one's with t and l
// swapped), the gradient filters clipped at maxv. The per-mode
// and per-lane terms are taken once, the 9 references a lane reads once;
// bit-exact to intra_pred_sample.
__device__ __forceinline__ void pred_lane8(const int* t, const int* l,
                                           const int* ft, const int* fl,
                                           int dc, int m, int q,
                                           int (&p)[8], int maxv) {
    const bool uf = c_filter[35 + m];
    const int* tt = uf ? ft : t;
    const int* ll = uf ? fl : l;
    if (m == 0) {
        const int a = ll[1 + q], b = tt[9], c = (q + 1) * ll[9] + 8;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            p[j] = ((7 - j) * a + (j + 1) * b + (7 - q) * tt[1 + j] + c) >> 4;
    } else if (m == 1) {
#pragma unroll
        for (int j = 1; j < 8; ++j)
            p[j] = q == 0 ? (t[j + 1] + 3 * dc + 2) >> 2 : dc;
        p[0] = q == 0 ? (l[1] + 2 * dc + t[1] + 2) >> 2
                      : (l[q + 1] + 3 * dc + 2) >> 2;
    } else {
        const bool vert = m >= 18;
        const int* mn = vert ? tt : ll;
        const int* sd = vert ? ll : tt;
        const int pos = (q + 1) * c_angle[m];
        const int i0 = (pos >> 5) + 1, f = pos & 31, iv = c_inv[m];
        int R[9];
        if (pos >= 0) {  // i0 >= 1: the main array alone, clamped at 2S
#pragma unroll
            for (int k = 0; k < 9; ++k) R[k] = mn[min(i0 + k, 16)];
        } else {  // i0 <= 0, i <= 8: the projected side below 0
#pragma unroll
            for (int k = 0; k < 9; ++k) {
                const int i = i0 + k;
                R[k] = i >= 0 ? mn[i] : sd[(i * iv + 128) >> 8];
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
            p[j] = ((32 - f) * R[j] + f * R[j + 1] + 16) >> 5;
        if (m == 26 || m == 10) {
            const int* m0 = vert ? t : l;
            const int* s0 = vert ? l : t;
            p[0] = min(max(m0[1] + ((s0[q + 1] - s0[0]) >> 1), 0), maxv);
        }
    }
}

template <int BD, bool kOnChip, int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
intra_wave_kernel(const int* __restrict__ oy, const int* __restrict__ ou,
                  const int* __restrict__ ov, const int* __restrict__ slots,
                  int* ry, int* ru, int* rv, int* modes,
                  int* __restrict__ cy, int* __restrict__ cb,
                  int* __restrict__ cr, int w, int h, int steps, int B,
                  Quant qy, Quant qc, int sqlam_fp) {
    // on chip: the planes' samples in 8 or 16 bits, the mode map in 8
    using Pel = typename std::conditional<
        kOnChip, typename std::conditional<BD == 8, uint8_t, uint16_t>::type,
        int>::type;
    using Mode = typename std::conditional<kOnChip, uint8_t, int>::type;
    constexpr int kMaxV = (1 << BD) - 1;
    extern __shared__ __align__(16) int smem[];
    int* s_T8 = smem;                  // 8x8 DCT
    int* s_T4 = smem + 64;             // 4x4 DCT
    int* s_T8t = smem + 80;            // their transposes
    int* s_T4t = smem + 144;
    uint8_t* s_sub8 = reinterpret_cast<uint8_t*>(smem + 160);  // [32][33]
    uint8_t* s_sub4 = s_sub8 + 32 * 33;                        // [32][17]
    int* s_org = smem + kFixedWords;   // [2][B][96] luma 64, cb 16, cr 16
    int* s_ref = s_org + 2 * kOrg * B;  // [B][68] t, l, ft, fl
    int* s_cref = s_ref + kRef * B;    // [B][2][18] t (9), l (9)
    int* s_misc = s_cref + kCRef * B;  // [B][8] dc y, u, v, MPM, 3 keys
    int* s_tx = s_misc + kMisc * B;    // [B][192] luma A, B; chroma A, B
    int* s_slot = s_tx + kTx * B;      // [3][B] the slot ring

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // kCluster blocks a frame: each keeps its own copy of the planes and
    // runs phases 1 and 3 for every cell; phase 2's tasks are split
    // among them, the keys sent to every block of the cluster
    const int rank = kCluster > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const int f = blockIdx.x / kCluster;
    const int cw = w >> 1, ch = h >> 1, w8 = w >> 3;
    const size_t ny = (size_t)w * h, nc = ny >> 2, nm = ny >> 6;
    oy += f * ny;
    ry += f * ny;
    cy += f * ny;
    ou += f * nc;
    ov += f * nc;
    ru += f * nc;
    rv += f * nc;
    cb += f * nc;
    cr += f * nc;
    modes += f * nm;
    Pel *Y, *U, *V;
    Mode* M;
    if constexpr (kOnChip) {
        Y = reinterpret_cast<Pel*>(s_slot + 3 * B);
        U = Y + ny;
        V = U + nc;
        M = reinterpret_cast<Mode*>(V + nc);
    } else {
        Y = ry;
        U = ru;
        V = rv;
        M = modes;
    }

    // the originals of the wave whose slots are sl into buffer org: a
    // warp a cell, lanes 0-15 the 8 luma rows' halves, 16-23 the chroma
    // rows, one 16-byte copy each
    auto prefetch_org = [&](const int* sl, int* org) {
        for (int b = warp; b < B; b += kWarps) {
            const int v = sl[b];
            if (v < 0) break;
            if (lane < 24) {
                const int x8 = v & 0xfff, y8 = (v >> 12) & 0xfff;
                const int* src;
                if (lane < 16) {
                    src = oy + (y8 * 8 + (lane >> 1)) * w + x8 * 8
                        + 4 * (lane & 1);
                } else {
                    const int q = lane - 16;
                    src = ((q & 4) ? ov : ou) + (y8 * 4 + (q & 3)) * cw
                        + x8 * 4;
                }
                cp_async16(org + b * kOrg + 4 * lane, src);
            }
        }
    };
    // the slot words of wave s into the ring's row sl
    auto prefetch_slots = [&](int s, int* sl) {
        for (int b = tid; b < B; b += kThreads) {
            if (s < steps)
                cp_async4(sl + b, slots + s * B + b);
            else
                sl[b] = -1;
        }
    };

    for (int e = tid; e < 80; e += kThreads) {  // T[k][x], TT[x][k]
        const int L2 = e < 64 ? 3 : 2, i = e < 64 ? e : e - 64;
        const int hi = i >> L2, lo = i & ((1 << L2) - 1);
        s_T8[e] = c_dct32[(hi << (5 - L2)) * 32 + lo];
        s_T8t[e] = c_dct32[(lo << (5 - L2)) * 32 + hi];
    }
    for (int i = lane; i < 50; i += 32) {  // warp a: avail pattern a
        if (i < 33)
            s_sub8[warp * 33 + i] = (uint8_t)ref_src<8>(i, warp);
        else
            s_sub4[warp * 17 + i - 33] = (uint8_t)ref_src<4>(i - 33, warp);
    }
    for (int b = tid; b < B; b += kThreads) {
        s_slot[b] = slots[b];
        s_slot[B + b] = steps > 1 ? slots[B + b] : -1;
        s_misc[b * kMisc + 4] = s_misc[b * kMisc + 5] = (int)kNoKey;
    }
    __syncthreads();
    prefetch_org(s_slot, s_org);
    cp_async_wait_all();
    if constexpr (kCluster > 1)  // every block's keys set before any sends
        cg::this_cluster().sync();
    else
        __syncthreads();

    // the first phase-2 task of this warp: cell b2, mode group g2 (9 a
    // cell), of tasks 32 kCluster apart
    const int gw = rank * kWarps + warp, b2 = gw / 9, g2 = gw - 9 * b2;
    constexpr int kStep = kWarps * kCluster;
    int r0 = 0;  // ring row of the current wave
    int k0 = 0;  // its keys' ring slot
    for (int s = 0; s < steps; ++s) {
        const int r1 = r0 == 2 ? 0 : r0 + 1, r2 = r1 == 2 ? 0 : r1 + 1;
        const int* slot = s_slot + r0 * B;
        int* org = s_org + (s & 1) * kOrg * B;
        prefetch_slots(s + 2, s_slot + r2 * B);
        prefetch_org(s_slot + r1 * B, s_org + ((s + 1) & 1) * kOrg * B);
        int n = 0;  // the wave's cells
        for (int i0 = 0; i0 < B; i0 += 32) {
            const int i = i0 + lane;
            n += __popc(__ballot_sync(kFull, i < B && slot[i] >= 0));
        }

        // phase 1: references, filtered references, DC values, MPM list;
        // even tasks a cell's luma, odd tasks its chroma
        for (int task = warp; task < 2 * n; task += kWarps) {
            const int b = task >> 1;
            const int v = slot[b];
            const int x8 = v & 0xfff, y8 = (v >> 12) & 0xfff, fl = v >> 24;
            int* m = s_misc + b * kMisc;
            if (!(task & 1)) {
                int* t = s_ref + b * kRef;
                int* l = t + 17;
                for (int k = lane; k < 33; k += 32) {
                    const int r = ref_at<8, BD>(Y, w, h, x8 * 8, y8 * 8,
                                            s_sub8[(fl & 31) * 33 + k]);
                    if (k >= 16) t[k - 16] = r;
                    if (k <= 16) l[16 - k] = r;
                }
                __syncwarp();
                if (lane < 17)
                    intra_smooth_at(t, l, lane, 16, false, t + 34 + lane,
                                    t + 51 + lane);
                const int dy = __reduce_add_sync(
                    kFull, lane < 8 ? t[1 + lane] + l[1 + lane] : 0);
                if (lane == 0) m[0] = (dy + 8) >> 4;
            } else {  // lanes 0-16 Cb, 17-33 Cr (lanes 0-1 twice)
                int* ct = s_cref + b * kCRef;
                for (int k = lane; k < 34; k += 32) {
                    const int p = k >= 17, i = k - 17 * p;
                    const int r = ref_at<4, BD>(p ? V : U, cw, ch, x8 * 4,
                                            y8 * 4,
                                            s_sub4[(fl & 31) * 17 + i]);
                    if (i >= 8) ct[18 * p + i - 8] = r;
                    if (i <= 8) ct[18 * p + 9 + 8 - i] = r;
                }
                __syncwarp();
                const int j = lane & 3;  // the DC sums of Cb, Cr
                const int du = __reduce_add_sync(
                    kFull, lane < 4 ? ct[1 + j] + ct[10 + j] : 0);
                const int dv = __reduce_add_sync(
                    kFull, (lane >> 2) == 1 ? ct[19 + j] + ct[28 + j] : 0);
                if (lane == 0) {  // the chroma DC values and the MPM list
                    m[1] = (du + 4) >> 3;
                    m[2] = (dv + 4) >> 3;
                    const int cell = y8 * w8 + x8;
                    const int a = (fl & 32) ? (int)M[cell - 1] : 1;
                    const int c = (fl & 64) ? (int)M[cell - w8] : 1;
                    int m0, m1, m2;
                    if (a == c) {
                        if (a < 2) {
                            m0 = 0;
                            m1 = 1;
                            m2 = 26;
                        } else {
                            m0 = a;
                            m1 = 2 + ((a + 29) & 31);
                            m2 = 2 + ((a - 1) & 31);
                        }
                    } else {
                        m0 = a;
                        m1 = c;
                        m2 = (a != 0 && c != 0) ? 0
                           : (a != 1 && c != 1) ? 1 : 26;
                    }
                    m[3] = m0 | (m1 << 8) | (m2 << 16);
                }
            }
        }
        // end of phase 1
        __syncthreads();

        // phase 2: the 35 costs of every cell and its first least mode
        for (int b = b2, g = g2; b < n;) {
            const int mode = c_slot_mode[4 * g + (lane >> 3)];
            const int r = lane & 7;
            const bool on = mode < 35;
            const int* t = s_ref + b * kRef;
            const int* mi = s_misc + b * kMisc;
            int v[8];
            if (on) {
                int p[8];
                pred_lane8(t, t + 17, t + 34, t + 51, mi[0], mode, r, p,
                           kMaxV);
                // row r, or column r of the horizontal modes
                if (mode >= 2 && mode < 18) {
                    const int* o = org + b * kOrg + r;
#pragma unroll
                    for (int c = 0; c < 8; ++c) v[c] = o[8 * c] - p[c];
                } else {
                    const int4 oa = ld4(org + b * kOrg + 8 * r);
                    const int4 ob = ld4(org + b * kOrg + 8 * r + 4);
                    const int o[8] = {oa.x, oa.y, oa.z, oa.w,
                                      ob.x, ob.y, ob.z, ob.w};
#pragma unroll
                    for (int c = 0; c < 8; ++c) v[c] = o[c] - p[c];
                }
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c) v[c] = 0;
            }
            const int sum = hadamard8_lanes_abs_sum_signed(v, r);
            unsigned key = kFull;
            if (on) {
                const int mp = mi[3];
                const bool in = mode == (mp & 255)
                             || mode == ((mp >> 8) & 255) || mode == mp >> 16;
                const int cost = ((sum + 2) >> 2)
                               + (((in ? 2 : 6) * sqlam_fp) >> 8);
                key = ((unsigned)cost << 6) | (unsigned)mode;
            }
            key = __reduce_min_sync(kFull, key);
            if (lane < kCluster) {  // wave s's key in ring slot s % 3
                unsigned* k = reinterpret_cast<unsigned*>(s_misc)
                            + b * kMisc + 4 + k0;
                if constexpr (kCluster > 1)
                    k = cg::this_cluster().map_shared_rank(k, lane);
                atomicMin(k, key);
            }
            // the next task, kStep on
            g += kStep % 9;
            b += kStep / 9;
            if (g >= 9) {
                g -= 9;
                ++b;
            }
        }
        // end of phase 2
        if constexpr (kCluster > 1)
            cg::this_cluster().sync();
        else
            __syncthreads();

        // phase 3: the chosen prediction, the transform stages, the levels
        // and the recon: even tasks luma, odd tasks both chroma planes
        for (int task = warp; task < 2 * n; task += kWarps) {
            const int b = task >> 1;
            const int v = slot[b];
            const int x8 = v & 0xfff, y8 = (v >> 12) & 0xfff;
            const int* mi = s_misc + b * kMisc;
            const int mode = mi[4 + k0] & 63;
            const int* o = org + b * kOrg;
            int* A = s_tx + b * kTx;
            if (!(task & 1)) {
                const int* t = s_ref + b * kRef;
                int* Bt = A + 64;
                if (lane == 0) M[y8 * w8 + x8] = (Mode)mode;
                int pv[2], lev[2];
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int e = lane + 32 * u;
                    pv[u] = intra_pred_sample(t, t + 17, t + 34, t + 51,
                                              mi[0], mode, e >> 3, e & 7, 3,
                                              true, true, kMaxV);
                    A[e] = o[e] - pv[u];
                }
                __syncwarp();
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int e = lane + 32 * u;
                    Bt[e] = fwd_rows<3, BD>(A, s_T8, e);
                }
                __syncwarp();
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int e = lane + 32 * u;
                    lev[u] = tx_quant(fwd_cols<3>(Bt, s_T8, e), qy.scale,
                                      qy.add, qy.qbits);
                    if (rank == 0)
                        cy[(y8 * 8 + (e >> 3)) * w + x8 * 8 + (e & 7)] =
                            lev[u];
                    A[e] = tx_dequant(lev[u], qy.dqscale, qy.dqshift);
                }
                int rec[2] = {pv[0], pv[1]};
                if (__any_sync(kFull, lev[0] | lev[1])) {
                    __syncwarp();
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int e = lane + 32 * u;
                        Bt[e] = inv_cols<3>(A, s_T8t, e);
                    }
                    __syncwarp();
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        const int e = lane + 32 * u;
                        rec[u] = min(max(pv[u] + inv_rows<3, BD>(Bt, s_T8t,
                                                                 e),
                                         0), kMaxV);
                    }
                }
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int e = lane + 32 * u;
                    Y[(y8 * 8 + (e >> 3)) * w + x8 * 8 + (e & 7)] =
                        (Pel)rec[u];
                }
            } else {  // lanes 0-15 Cb, 16-31 Cr
                const int p = lane >> 4, e = lane & 15;
                const int* ct = s_cref + b * kCRef + 18 * p;
                int* Ac = A + 128 + 32 * p;
                int* Bc = Ac + 16;
                const int pv = intra_pred_sample(ct, ct + 9, ct, ct + 9,
                                                 mi[1 + p], mode, e >> 2,
                                                 e & 3, 2, false, false,
                                                 kMaxV);
                Ac[e] = o[64 + 16 * p + e] - pv;
                __syncwarp();
                Bc[e] = fwd_rows<2, BD>(Ac, s_T4, e);
                __syncwarp();
                const int lv = tx_quant(fwd_cols<2>(Bc, s_T4, e),
                                        qc.scale, qc.add, qc.qbits);
                const int at = (y8 * 4 + (e >> 2)) * cw + x8 * 4 + (e & 3);
                if (rank == 0) (p ? cr : cb)[at] = lv;
                Ac[e] = tx_dequant(lv, qc.dqscale, qc.dqshift);
                const unsigned nz = __ballot_sync(kFull, lv != 0);
                int rec = pv;
                if (nz) {
                    __syncwarp();
                    Bc[e] = inv_cols<2>(Ac, s_T4t, e);
                    __syncwarp();
                    const int r = inv_rows<2, BD>(Bc, s_T4t, e);
                    if ((nz >> (16 * p)) & 0xffffu)
                        rec = min(max(pv + r, 0), kMaxV);
                }
                (p ? V : U)[at] = (Pel)rec;
            }
        }
        for (int b = tid; b < B; b += kThreads)  // wave s + 2's keys
            s_misc[b * kMisc + 4 + (k0 == 0 ? 2 : k0 - 1)] = (int)kNoKey;
        // end of phase 3
        cp_async_wait_all();
        __syncthreads();
        r0 = r1;
        k0 = k0 == 2 ? 0 : k0 + 1;
    }

    if constexpr (kOnChip) {  // the planes out, 4 samples a 16-byte store
        for (int i = rank * kThreads + tid; i < (int)((ny + 2 * nc) >> 2);
             i += kThreads * kCluster) {
            int4 o4;
            if constexpr (BD == 8) {
                const uchar4 q = reinterpret_cast<const uchar4*>(Y)[i];
                o4 = make_int4(q.x, q.y, q.z, q.w);
            } else {  // two 4-byte loads: the planes start 4-byte aligned
                const ushort2* src = reinterpret_cast<const ushort2*>(Y);
                const ushort2 a = src[2 * i], b = src[2 * i + 1];
                o4 = make_int4(a.x, a.y, b.x, b.y);
            }
            const int j = 4 * i;
            int* dst = j < (int)ny ? ry + j
                     : j < (int)(ny + nc) ? ru + (j - ny) : rv + (j - ny - nc);
            *reinterpret_cast<int4*>(dst) = o4;
        }
        for (int i = rank * kThreads + tid; i < (int)nm;
             i += kThreads * kCluster)
            modes[i] = M[i];
    }
}

}  // namespace

// Shared memory of one block (bytes) for w x h pictures and waves of bmax
// slots; on_chip: the recon planes (a byte a sample at bit depth 8, two at
// 10) and the mode map (a byte a cell) kept there.
extern "C" int tpuhevc_intra_wave_smem(int w, int h, int bmax, int on_chip,
                                       int bit_depth) {
    const long long words = kFixedWords + (long long)kCellWords * bmax;
    const long long pel = bit_depth > 8 ? 2 : 1;
    const long long planes = on_chip ? pel * 3 * w * h / 2
                                           + (long long)(w / 8) * (h / 8)
                                     : 0;
    const long long bytes = 4 * words + planes;
    return bytes > 0x7fffffff ? 0x7fffffff : (int)bytes;
}

// Copies the intra tables (as tpuhevc_intra_bank_init) and the 32x32 HEVC
// DCT matrix (int32, host memory) to constant memory of the current
// device. Call once per device before tpuhevc_intra_wave.
extern "C" int tpuhevc_intra_wave_init(const int* angle, const int* inv,
                                       const int* filter,
                                       const int* host_t32) {
    const int err = intra_pred_load_tables(angle, inv, filter);
    if (err) return err;
    cudaMemcpyToSymbol(c_dct32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// oy (F, h, w), ou, ov (F, h/2, w/2) int32 on the device, 16-byte
// aligned, w and h multiples of 8, samples 0..(1 << bit_depth) - 1
// (bit_depth 8 or 10, else cudaErrorInvalidValue); slots (steps, bmax)
// int32 (the wave schedule: x8 | y8 << 12 | flags << 24 or -1, a wave's
// cells in its first slots; flags bits 0-4 availability of [lb, l, c, t,
// tr], bit 5 the left MPM neighbour, bit 6 the above one) -> ry, cy (F, h,
// w), ru, rv, cb, cr (F, h/2, w/2), modes (F, h/8, w/8) int32. Every cell
// must appear once in the schedule. on_chip picks the kernel that keeps
// the recon in shared memory (tpuhevc_intra_wave_smem says what it needs);
// cluster (1, or 4 where on_chip) the blocks a frame, a thread block
// cluster that splits each wave's 35-mode costs.
// Quantiser constants (luma 8x8 at QP, chroma 4x4 at the chroma QP) as
// tpuhevc_torch/ops/transforms.py quant_params / dequant_params give them
// at bit_depth.
extern "C" int tpuhevc_intra_wave(
    const int* oy, const int* ou, const int* ov, const int* slots, int* ry,
    int* ru, int* rv, int* modes, int* cy, int* cb, int* cr, int nframes,
    int w, int h, int steps, int bmax, int on_chip, int cluster,
    int qy_scale, int qy_add, int qy_bits, int qy_dqscale, int qy_dqshift,
    int qc_scale, int qc_add, int qc_bits, int qc_dqscale, int qc_dqshift,
    int sqlam_fp, int bit_depth, void* stream) {
    const int smem = tpuhevc_intra_wave_smem(w, h, bmax, on_chip, bit_depth);
    if (smem > kMaxSmem || bmax < 1 || w % 8 || h % 8
        || (cluster != 1 && (!on_chip || cluster != 4))
        || (bit_depth != 8 && bit_depth != 10))
        return (int)cudaErrorInvalidValue;
    using Kernel = void (*)(const int*, const int*, const int*, const int*,
                            int*, int*, int*, int*, int*, int*, int*, int,
                            int, int, int, Quant, Quant, int);
    const bool ten = bit_depth == 10;
    const Kernel kernel =
        !on_chip ? (ten ? intra_wave_kernel<10, false, 1>
                        : intra_wave_kernel<8, false, 1>)
        : cluster == 1 ? (ten ? intra_wave_kernel<10, true, 1>
                              : intra_wave_kernel<8, true, 1>)
                       : (ten ? intra_wave_kernel<10, true, 4>
                              : intra_wave_kernel<8, true, 4>);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const Quant qy = {qy_scale, qy_add, qy_bits, qy_dqscale, qy_dqshift};
    const Quant qc = {qc_scale, qc_add, qc_bits, qc_dqscale, qc_dqshift};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nframes * cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, oy, ou, ov, slots, ry, ru, rv, modes, cy, cb, cr, w, h,
        steps, bmax, qy, qc, sqlam_fp);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
