// satd35_topk: Hadamard SATD of the 35-mode intra bank and the top-nc.
//
// Replaces: tpuhevc/codec/intra_decide_jax.py:75-84 (`satd35`) and the
// `lax.top_k(-sat, nc)` at :130 (a closure of `_build` that XLA compiled
// for the TPU).
//
// What it computes, per block n and mode m, d = org[n] - preds[n][m]:
//   S >= 8: sum over the 8x8 tiles of (sum |H8 d H8^T| + 2) >> 2;
//   S = 4:  (sum |H4 d H4^T| + 1) >> 1;
// then the nc modes of least SATD in ascending order, the lower mode
// first among equals (what top_k of the negated costs returns). Integer
// and exact: JAX's float32 products are exact here (an 8x8 sum stays
// below 2^24), so the values equal JAX's bit for bit.
//
// What bounds it: one read of the 35 S^2 int32 predictions a block (14 MB
// a launch at 416x240, 0.0042 ms at 3.35 TB/s) and the original blocks;
// a few dozen integer operations a sample. Memory-bound: what matters is
// bytes in flight.
// Design: the TU size is compiled in, with the target blocks a CTA and
// the CTA size chosen per size so that every launch fills the card
// (several blocks a CTA at S = 4 and 8; 1,024 threads a block at S = 32).
// A team of T lanes works one T x T tile, a lane a row: each row is one
// (T = 4) or two (T = 8) 16-byte loads from the predictions, the original
// rows come from the CTA's blocks staged once in shared memory. A thread
// issues the loads of all its tiles (two at a time at 1,024 threads a
// CTA, for registers), and of its share of the originals, before its
// first store to shared memory. The row
// butterfly runs in registers, the column butterflies across the team by
// shuffles (hadamard.cuh). Consecutive teams take adjacent tiles, so a
// warp reads contiguous runs. A tile's rounded sum goes into its mode's
// total by an integer shared atomic (order free). Then a warp a target
// block takes the top-nc: each lane holds up to two (SATD, mode) keys in
// 64 bits (SATD high, mode low), nc rounds of a warp minimum by shuffles,
// the winner marked taken; least SATD first, the lower mode among equals.

#include <stdint.h>

#include "hadamard.cuh"

namespace {

// target blocks a CTA, threads a CTA
template <int S> struct Shape;
template <> struct Shape<4> { static constexpr int kBlocks = 8, kThreads = 256; };
template <> struct Shape<8> { static constexpr int kBlocks = 4, kThreads = 256; };
template <> struct Shape<16> { static constexpr int kBlocks = 1, kThreads = 256; };
template <> struct Shape<32> { static constexpr int kBlocks = 1, kThreads = 1024; };

constexpr unsigned long long kTaken = ~0ull;

template <int S>
__global__ void __launch_bounds__(Shape<S>::kThreads)
satd35_topk_kernel(const int* __restrict__ org, const int* __restrict__ preds,
                   int* __restrict__ sat_out, int* __restrict__ topk_out,
                   int n, int nc) {
    constexpr int T = S >= 8 ? 8 : 4;  // tile side, lanes a team
    constexpr int TW = S / T;          // tiles a row
    constexpr int NT = TW * TW;        // tiles a mode
    constexpr int N2 = S * S;
    constexpr int B = Shape<S>::kBlocks, NTH = Shape<S>::kThreads;
    constexpr int TEAMS = NTH / T, TILES = B * 35 * NT;
    constexpr int ITER = (TILES + TEAMS - 1) / TEAMS;  // tiles a team
    // tiles a team keeps in flight: all of them, but at 1,024 threads (64
    // registers a thread) two at a time
    constexpr int CH = NTH >= 1024 ? 2 : ITER;
    constexpr int NO = (B * N2 / 4 + NTH - 1) / NTH;  // org vectors a thread
    __shared__ __align__(16) int s_org[B * N2];
    __shared__ int s_sat[B * 35];
    const int b0 = blockIdx.x * B;
    const int nb = min(B, n - b0);
    const int team = threadIdx.x / T, r = threadIdx.x % T;

    // tile g of the CTA: (block, mode, tile of the mode); row r's offset
    auto tile = [&](int g, int& b, int& m, int& off) {
        b = g / (35 * NT);
        const int rem = g - b * (35 * NT);
        m = rem / NT;
        const int k = rem - m * NT;
        off = ((k / TW) * T + r) * S + (k % TW) * T;
        return g < TILES && b < nb;
    };
    int4 pv[CH][T / 4];
    auto load = [&](int c0) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            int b, m, off;
            if (c0 + c < ITER && tile((c0 + c) * TEAMS + team, b, m, off)) {
                const int4* p = reinterpret_cast<const int4*>(
                    preds + ((size_t)(b0 + b) * 35 + m) * N2 + off);
#pragma unroll
                for (int q = 0; q < T / 4; ++q) pv[c][q] = __ldg(p + q);
            }
        }
    };

    // the originals and the first tiles' loads are all issued before the
    // first store to shared memory: one round trip
    const int4* o4 = reinterpret_cast<const int4*>(org + (size_t)b0 * N2);
    int4 ov[NO];
#pragma unroll
    for (int q = 0; q < NO; ++q) {
        const int e = threadIdx.x + q * NTH;
        if (e < nb * N2 / 4) ov[q] = __ldg(o4 + e);
    }
    load(0);
#pragma unroll
    for (int q = 0; q < NO; ++q) {
        const int e = threadIdx.x + q * NTH;
        if (e < nb * N2 / 4) reinterpret_cast<int4*>(s_org)[e] = ov[q];
    }
    for (int e = threadIdx.x; e < B * 35; e += NTH) s_sat[e] = 0;
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < ITER; c0 += CH) {
        if (c0 > 0) load(c0);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            if (c0 + c >= ITER) break;
            int b, m, off;
            const bool live = tile((c0 + c) * TEAMS + team, b, m, off);
            int v[T];
            if (live) {
                const int4* o = reinterpret_cast<const int4*>(s_org + b * N2 + off);
#pragma unroll
                for (int q = 0; q < T / 4; ++q) {
                    const int4 ow = o[q], pw = pv[c][q];
                    v[4 * q] = ow.x - pw.x;
                    v[4 * q + 1] = ow.y - pw.y;
                    v[4 * q + 2] = ow.z - pw.z;
                    v[4 * q + 3] = ow.w - pw.w;
                }
            } else {
#pragma unroll
                for (int q = 0; q < T; ++q) v[q] = 0;
            }
            const int sa = hadamard_lanes_abs_sum<T>(v, r);
            if (live && r == 0)
                atomicAdd(&s_sat[b * 35 + m], T == 8 ? (sa + 2) >> 2 : (sa + 1) >> 1);
        }
    }
    __syncthreads();

    // the top-nc, a warp a target block
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int b = warp; b < nb; b += NTH / 32) {
        const int* st = s_sat + b * 35;
        const int m1 = lane + 32;
        int* so = sat_out + (size_t)(b0 + b) * 35;
        so[lane] = st[lane];
        if (m1 < 35) so[m1] = st[m1];
        unsigned long long k0 =
            ((unsigned long long)(unsigned)st[lane] << 32) | (unsigned)lane;
        unsigned long long k1 =
            m1 < 35 ? ((unsigned long long)(unsigned)st[m1] << 32) | (unsigned)m1
                    : kTaken;
        int out0 = 0, out1 = 0;
        for (int k = 0; k < nc; ++k) {
            unsigned long long best = k0 < k1 ? k0 : k1;
#pragma unroll
            for (int h = 16; h > 0; h >>= 1) {
                const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, h);
                best = o < best ? o : best;
            }
            if (k0 == best) k0 = kTaken;
            if (k1 == best) k1 = kTaken;
            if (lane == (k & 31)) {
                if (k < 32) out0 = (int)(unsigned)best;
                else out1 = (int)(unsigned)best;
            }
        }
        int* to = topk_out + (size_t)(b0 + b) * nc;
        if (lane < nc) to[lane] = out0;
        if (m1 < nc) to[m1] = out1;
    }
}

template <int S>
int launch(const int* org, const int* preds, int* sat, int* topk, int n,
           int nc, cudaStream_t stream) {
    const int grid = (n + Shape<S>::kBlocks - 1) / Shape<S>::kBlocks;
    satd35_topk_kernel<S><<<grid, Shape<S>::kThreads, 0, stream>>>(
        org, preds, sat, topk, n, nc);
    return (int)cudaGetLastError();
}

}  // namespace

// org (n, S, S), preds (n, 35, S, S) int32 on the device, 16-byte
// aligned, S = 1 << log2 in 4..32, 1 <= nc <= 35, n >= 1 -> sat (n, 35),
// topk (n, nc) int32.
extern "C" int tpuhevc_satd35_topk(const int* org, const int* preds,
                                   int* sat, int* topk, int n, int log2,
                                   int nc, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log2) {
        case 2: return launch<4>(org, preds, sat, topk, n, nc, s);
        case 3: return launch<8>(org, preds, sat, topk, n, nc, s);
        case 4: return launch<16>(org, preds, sat, topk, n, nc, s);
        case 5: return launch<32>(org, preds, sat, topk, n, nc, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
