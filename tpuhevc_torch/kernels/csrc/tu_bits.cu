// tu_bits: the table bit estimate of residual TUs.
//
// Replaces: tpuhevc/entropy/bitest.py:286-378 (`ResidualBitEst.tu_bits`,
// sbh off: the intra decision prices no sign-bit hiding) and :398-408
// (`_rice_bits_xp`), jnp code that XLA compiled for the TPU inside the
// intra decision.
//
// What it computes, per TU of levels (S x S, S = 1 << log2 in 4..32):
//   last = the largest diagonal-scan position of a nonzero level;
//   bits = lastx[group(x_last)] + lasty[group(y_last)]
//        + sum over CGs 0 < cg_scan < last_cg of csbf_bits[right|below][csbf]
//        + sum over coded positions (scan < last, CG coded or first/last)
//              of sig_bits[right + 2 below][y][x][nz]
//        + per CG: gt1 bins (at most 8, CG0 or later context set) and the
//              gt2 bin, by the counts of |l| > 0, > 1, > 2
//        + the Golomb-Rice length of every |l| - 2 > 0, Rice parameter
//              from the CG max (largest k <= 4 with 3 * 2^k <= max, 0 unless
//              max > 6), the escape's floor(log2) by count-leading-zeros
//        + one sign bit per nonzero level;  0 for an all-zero TU.
// Sums: every table value the sums take is one ENTROPY_BITS entry, a
// multiple of 2^-15 (entropy/bitest.py checks at import that S^2 = 1024 of
// the largest stay below 2^31 units), so each is taken as an integer in
// units of 2^-15 as it is read, and the csbf, sig and gt1/gt2 sums as
// int32: exact in any order, each rounded once to float32 (the float value
// of the exact sum, as the PyTorch version's double sums rounded once),
// then the partial sums added in float32 in the reference's order; the
// Rice and sign counts in int32. So the result equals the PyTorch version
// bit for bit.
//
// What bounds it: one read of the S^2 int32 levels a TU; a few dozen
// integer operations a level. Latency-bound at the decision's sizes (the
// whole IDR reads ~2 MB a pass).
// Design: the TU size is compiled in; a team's code is tu_bits_team.cuh's
// (shared with b_txq.cu). A lane owns one 16-byte vector of 4
// levels of one CG row, loaded once with an int4 load, the four rows of a
// CG in adjacent lanes (lane 4 cg + row), so a CG's counts and maximum
// take two xor-shuffles, and the coded-sub-block flags of the whole TU
// come from one ballot (through shared memory where a TU spans several
// warps) as a bitmap in which each CG finds its right and lower
// neighbours. A team of S^2 / 4 lanes works a TU: 4 lanes at S = 4 (8 TUs
// a warp), 16 at S = 8; at S = 16 and 32 a block of 64 or 256 lanes,
// whose warps meet once in shared memory for the CG flags and the key and
// once for the sums (a warp a TU with 2 or 8 vectors a lane was slower at
// both sizes: PERF.md row 17). A CG's own terms are added by its row-0
// lane. The last position, with its x and y, is one 32-bit key ((scan <<
// 10) | (y << 5) | x) reduced by the team's maximum. A lane's scan
// positions sit in registers for the block's whole grid-stride loop. The
// tables, the same for every TU, are read through the L1 cache: a lane's
// significance bits (its four positions, both bin values) are two 16-byte
// loads at its CG's neighbour pattern, and the small tables (last-position
// bits by x and y, csbf, gt1, gt2) sit a value a lane and are read back by
// shuffles. (Staging the tables once a block in shared memory, 8 KB at
// S = 16 and 32 KB at S = 32, cost more than the TUs' own reads; so did
// loading a lane's significance bits at all four neighbour patterns before
// its levels.)

#include "tu_bits_team.cuh"

namespace {

// threads a block and TUs a block and round
template <int S> struct Team {
    static constexpr int kLanes = BitsTeam<S>::kLanes;
    static constexpr int kThreads = kLanes > 32 ? kLanes : 256;
    static constexpr int kTus = kThreads / kLanes;
};

template <int S>
__global__ void __launch_bounds__(Team<S>::kThreads)
tu_bits_teams(const int* __restrict__ tiles, const int* __restrict__ itab,
              const float* __restrict__ ftab, float* __restrict__ out, int n) {
    using TM = Team<S>;
    constexpr int N2 = S * S, T = TM::kLanes, TPB = TM::kTus;
    constexpr int WPT = BitsTeam<S>::kWarps;
    // a TU over several warps: each warp's CG flags, key and sums
    __shared__ unsigned s_map[WPT];
    __shared__ int s_key[WPT];
    __shared__ int s_acc[WPT][5];
    const int tid = threadIdx.x, team = tid / T;
    // this lane's vector, scan positions and table parts
    const BitsLane<S> L = bits_lane<S>(tid % T, itab, ftab);

    for (int t0 = blockIdx.x * TPB; t0 < n; t0 += gridDim.x * TPB) {
        const int tu = t0 + team;
        const bool live = tu < n;
        const int4 lv = live ? __ldg(reinterpret_cast<const int4*>(tiles + (size_t)tu * N2) +
                                     (L.e0 >> 2))
                             : make_int4(0, 0, 0, 0);
        const float bits = tu_bits_lanes<S>(L, lv, ftab, s_map, s_key, s_acc);
        if (L.t_in == 0 && live) out[tu] = bits;
    }
}

template <int S>
int launch(const int* tiles, const int* itab, const float* ftab, float* out,
           int n, int sms, cudaStream_t stream) {
    using TM = Team<S>;
    // enough blocks to fill the card; more TUs loop, so that a lane's scan
    // positions serve several rounds
    const int per_sm = TM::kThreads >= 64 ? 2048 / TM::kThreads : 32;
    const int want = (n + TM::kTus - 1) / TM::kTus;
    const int grid = want < sms * per_sm ? want : sms * per_sm;
    tu_bits_teams<S><<<grid, TM::kThreads, 0, stream>>>(tiles, itab, ftab, out, n);
    return (int)cudaGetLastError();
}

}  // namespace

// tiles (n, S, S) int32 levels on the device, 16-byte aligned, S = 1 <<
// log2 in 4..32, n >= 1; itab / ftab: the estimator's tables
// (entropy/bitest.py EstTables, packed at `_ioffsets` / `_foffsets`);
// sms: the card's multiprocessors -> out (n,) float32 bits.
extern "C" int tpuhevc_tu_bits(const int* tiles, const int* itab,
                               const float* ftab, float* out, int n,
                               int log2, int sms, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (log2) {
        case 2: return launch<4>(tiles, itab, ftab, out, n, sms, s);
        case 3: return launch<8>(tiles, itab, ftab, out, n, sms, s);
        case 4: return launch<16>(tiles, itab, ftab, out, n, sms, s);
        case 5: return launch<32>(tiles, itab, ftab, out, n, sms, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
