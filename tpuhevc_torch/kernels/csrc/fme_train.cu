// The NN-FME train step: the live-BatchNorm forward with its loss
// (fme_train_fwd), the backward (fme_train_bwd) and the Adam update
// (fme_adam).
//
// Replaces: tpuhevc/models/nnfme.py:361-368, the jitted `step` of
// `train_fme`: jax.value_and_grad of `loss_fn` (355-359, over
// `train_forward` 245-287 in training mode and optax's softmax
// cross-entropy) and the optax.adam update (352, 366-368).
//
// What it computes. Forward, per sample b of a batch gathered through
// idx: x = data[idx[b]] (9 mapper-normalised SADs); the input BN with the
// batch's mean and biased variance and no bias; the input row [emb0[hcat]
// (4), emb1[wcat] (4), x_bn (9)]; h1 = BN1(relu(W1 in + b1)) (22), the
// dropout mask (u >= p) / (1 - p); h2 = BN2(relu(W2 h1 + b2)) (20) and its
// mask; logits = Wout h2 + bout (49); loss_b = logsumexp - logit[label].
// It writes the logits, the mean loss, each BN's batch mean and variance,
// the running-statistics update (1 - m) r + m batch, and what the backward
// reads (the rows of `kSaved`). Backward: dlogits = g (softmax - onehot)
// / B, back through each Linear, ReLU, dropout and BN with batch
// statistics (dx = (dxh - mean(dxh) - xh mean(dxh xh)) / sqrt(var + eps),
// the terms through the batch mean and variance), every weight's gradient
// summed over the batch, the embeddings' into their 8 rows. Adam: optax
// 0.2.6's scale_by_adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
// correction 1 - b^count, the count starting at 1), then -lr, then p + u.
//
// What bounds it: nothing on this card at the slice's sizes. A step is
// ~25 MFLOP and ~1 MB (B = 1,024); launch latency and serial depth
// dominate. Design: the forward and the backward are each one cooperative
// launch over the card (B <= 1,024; see the comment above
// fme_train_fwd_kernel): a warp a sample, then a warp a batch sum, joined
// by grid syncs. Adam is one thread an element over as many blocks as it
// takes. The 2,042 weights are staged in each block's shared memory.
// Activations go to global scratch laid out feature by feature (row r of
// sample b at r * B + b: contiguous per reduction). Every sum over the
// batch (the BN statistics, the BN and weight gradients, the loss) is one
// warp's: lane l sums samples l, l + 32, ... in order, then a fixed
// shuffle tree whose lane-0 result is used. No float atomics, so two runs
// give the same bits. Built with -fmad=false, so each product rounds on
// its own as in the plain version; the remaining differences to it are
// sum orders (and expf/logf/powf's last bits).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// offsets into the flat trained arrays, models/nnfme.py TRAIN_KEYS order
constexpr int kEmb0 = 0, kEmb1 = 32, kW1 = 64, kB1 = 438, kW2 = 460,
              kB2 = 900, kWout = 920, kBout = 1900, kBnIn = 1949,
              kBn1W = 1958, kBn1B = 1980, kBn2W = 2002, kBn2B = 2022,
              kFlat = 2042;
constexpr int kIn = 17, kX = 9, kH1 = 22, kH2 = 20, kOut = 49;
// offsets into the running statistics (and the batch statistics):
// in_mu, in_var, bn1_mu, bn1_var, bn2_mu, bn2_var
constexpr int kStIn = 0, kSt1 = 18, kSt2 = 62;
constexpr int kUnif = 42;  // dropout uniforms a sample: 22 for BN1, 20 for BN2
constexpr float kEps = 1e-5f;

// saved rows (the forward's scratch), each B long
constexpr int kXin = 0;                 // the input BN's xhat
constexpr int kInp = kXin + kX;         // the input row (17)
constexpr int kA1 = kInp + kIn;         // relu(W1 in + b1)
constexpr int kXh1 = kA1 + kH1;         // BN1's xhat
constexpr int kD1 = kXh1 + kH1;         // BN1 out after dropout
constexpr int kA2 = kD1 + kH1;
constexpr int kXh2 = kA2 + kH2;
constexpr int kD2 = kXh2 + kH2;
constexpr int kLogit = kD2 + kH2;
constexpr int kLoss = kLogit + kOut;    // per-sample loss
constexpr int kSaved = kLoss + 1;       // 202 rows
// the backward's scratch rows
constexpr int kDl = 0;
constexpr int kDy2 = kDl + kOut;        // d(BN2 out)
constexpr int kDz2 = kDy2 + kH2;        // d(W2 h1 + b2)
constexpr int kDy1 = kDz2 + kH2;
constexpr int kDz1 = kDy1 + kH1;
constexpr int kDinp = kDz1 + kH1;       // d(input row) (17)
constexpr int kWork = kDinp + kIn;      // 150 rows
// the weight-gradient entries the final pass sums (the BN scales and
// shifts of BN1/BN2 come out of their backward reductions)
constexpr int kEWout = 0, kEBout = kEWout + kOut * kH2,
              kEW2 = kEBout + kOut, kEB2 = kEW2 + kH2 * kH1,
              kEW1 = kEB2 + kH2, kEB1 = kEW1 + kH1 * kIn,
              kEBnIn = kEB1 + kH1, kEEmb = kEBnIn + kX,
              kEntries = kEEmb + 64;  // 1958

constexpr int kMaxBatch = 1024;
static_assert(kSaved == 202 && kWork == 150 && kEntries == 1958,
              "ops/fme_train.py's SAVED_ROWS and WORK_ROWS");

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Sum over a warp in a fixed tree; lane 0's result, broadcast.
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return __shfl_sync(0xffffffffu, v, 0);
}

// The forward and the backward spread over the card: a cooperative grid
// of blocks of kFwdThreads / kBwdThreads, every warp of the grid a sample
// in the per-sample phases (lanes over output features, each feature's
// product summed in the order of the one-thread-a-sample kernels that
// came before) and a batch sum in the reduction phases, the phases joined
// by grid syncs. Every batch sum stays one warp's, lane l taking samples
// l, l + 32, ... in order, then warp_sum's tree; only which warp of which
// block owns a row or an entry depends on the grid. So the outputs do not
// depend on the launch geometry, and equal the one-block kernels' bit for
// bit. Data written by another block in this launch (the saved rows, the
// statistics, the BN sums in grad) is read through L2 (__ldcg), after a
// grid sync.
constexpr int kFwdThreads = 256, kFwdWarps = kFwdThreads / 32;
constexpr int kMaxPerLane = kMaxBatch / 32;  // samples a lane of a row

// The batch statistics of F rows, a warp of the grid a row (gw of ngw):
// the mean, the biased variance (two passes, as jnp.var), the statistics
// and the running update at offset `off` (mu at off, var at off + F).
// Row f's value of sample b is at(f, b); lane l holds its samples l,
// l + 32, ... in registers between the passes.
template <class At>
__device__ void bn_stats(At at, int F, int B, int gw, int ngw, int lane,
                         const float* state_in, float* stats,
                         float* state_out, int off, float mom, float omm) {
    for (int f = gw; f < F; f += ngw) {
        float v[kMaxPerLane];
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
            const int b = lane + 32 * i;
            v[i] = b < B ? at(f, b) : 0.0f;
        }
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i)
            if (lane + 32 * i < B) s += v[i];
        const float mu = warp_sum(s) / (float)B;
        float q = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
            if (lane + 32 * i < B) {
                const float d = v[i] - mu;
                q += d * d;
            }
        }
        const float var = warp_sum(q) / (float)B;
        if (lane == 0) {
            stats[off + f] = mu;
            stats[off + F + f] = var;
            // state_out may alias state_in: read, then write, one thread
            state_out[off + f] = omm * state_in[off + f] + mom * mu;
            state_out[off + F + f] = omm * state_in[off + F + f] + mom * var;
        }
    }
}

// A block's copy of F features' batch mean and sqrt(var + eps) from
// stats (written by other blocks before the last grid sync).
__device__ __forceinline__ void load_stats(const float* stats, int off,
                                           int F, float* mu_s, float* sd_s) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        mu_s[f] = __ldcg(stats + off + f);
        sd_s[f] = sqrtf(__ldcg(stats + off + F + f) + kEps);
    }
    __syncthreads();
}

// Phases: (1) the input BN's statistics, a warp a row, x gathered through
// idx; (2) a warp a sample: the input row, a1 = relu(W1 in + b1); (3)
// BN1's statistics; (4) a warp a sample: BN1, dropout, a2 = relu(W2 d1 +
// b2); (5) BN2's statistics; (6) a warp a sample: BN2, dropout, the
// logits, logsumexp (the max in a tree: exact in any order; the 49
// exponentials added in order by each lane), the loss; (7) the mean loss,
// one warp. The weight matrices sit transposed in shared memory (lane j
// reads column j: no bank conflicts); the products are the same.
__global__ void __launch_bounds__(kFwdThreads) fme_train_fwd_kernel(
        const float* __restrict__ flat, const float* state_in,
        const float* __restrict__ x_all, const int* __restrict__ cat_all,
        const int* __restrict__ y_all, const int* __restrict__ idx,
        const float* __restrict__ unif, int B, float p1, float keep1,
        float p2, float keep2, float mom, float omm,
        float* __restrict__ logits, float* __restrict__ loss,
        float* stats, float* state_out, float* S) {
    namespace cg = cooperative_groups;
    cg::grid_group grid = cg::this_grid();
    __shared__ float w[kFlat];
    __shared__ float w1t[kIn * kH1], w2t[kH1 * kH2], wot[kH2 * kOut];
    __shared__ float mu_s[kH1], sd_s[kH1];
    __shared__ float row[kFwdWarps][kOut + 1];  // a warp's sample row
    for (int e = threadIdx.x; e < kFlat; e += blockDim.x) w[e] = flat[e];
    for (int e = threadIdx.x; e < kH1 * kIn; e += blockDim.x)
        w1t[(e % kIn) * kH1 + e / kIn] = flat[kW1 + e];
    for (int e = threadIdx.x; e < kH2 * kH1; e += blockDim.x)
        w2t[(e % kH1) * kH2 + e / kH1] = flat[kW2 + e];
    for (int e = threadIdx.x; e < kOut * kH2; e += blockDim.x)
        wot[(e % kH2) * kOut + e / kH2] = flat[kWout + e];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gw = blockIdx.x * kFwdWarps + warp;  // the grid's warp
    const int ngw = gridDim.x * kFwdWarps;
    float* r = row[warp];
    const bool hi = lane + 32 < kOut;  // lane holds logits lane, lane + 32

    // 1. the input BN's statistics
    bn_stats([&](int f, int b) { return x_all[kX * idx[b] + f]; }, kX, B,
             gw, ngw, lane, state_in, stats, state_out, kStIn, mom, omm);
    grid.sync();

    // 2. per sample: the input row, relu(W1 in + b1)
    load_stats(stats, kStIn, kX, mu_s, sd_s);
    for (int b = gw; b < B; b += ngw) {
        const int rw = idx[b];
        if (lane < 8) {
            r[lane] = lane < 4 ? w[kEmb0 + 4 * cat_all[2 * rw] + lane]
                               : w[kEmb1 + 4 * cat_all[2 * rw + 1] + lane - 4];
        } else if (lane < kIn) {
            const int k = lane - 8;
            const float xh = (x_all[kX * rw + k] - mu_s[k]) / sd_s[k];
            S[(kXin + k) * B + b] = xh;
            r[lane] = xh * w[kBnIn + k];
        }
        if (lane < kIn) S[(kInp + lane) * B + b] = r[lane];
        __syncwarp();
        if (lane < kH1) {
            float acc = 0.0f;
            for (int k = 0; k < kIn; ++k) acc = acc + r[k] * w1t[k * kH1 + lane];
            acc = acc + w[kB1 + lane];
            S[(kA1 + lane) * B + b] = fmaxf(acc, 0.0f);
        }
        __syncwarp();
    }
    grid.sync();

    // 3. BN1's statistics
    bn_stats([&](int f, int b) { return __ldcg(S + (kA1 + f) * B + b); },
             kH1, B, gw, ngw, lane, state_in, stats, state_out, kSt1, mom,
             omm);
    grid.sync();

    // 4. per sample: BN1, the dropout, relu(W2 d1 + b2)
    load_stats(stats, kSt1, kH1, mu_s, sd_s);
    for (int b = gw; b < B; b += ngw) {
        if (lane < kH1) {
            const int j = lane;
            const float xh = (__ldcg(S + (kA1 + j) * B + b) - mu_s[j]) / sd_s[j];
            S[(kXh1 + j) * B + b] = xh;
            const float yv = xh * w[kBn1W + j] + w[kBn1B + j];
            const float keep = unif[kUnif * b + j] >= p1 ? 1.0f : 0.0f;
            const float d1 = (yv * keep) / keep1;
            S[(kD1 + j) * B + b] = d1;
            r[j] = d1;
        }
        __syncwarp();
        if (lane < kH2) {
            float acc = 0.0f;
            for (int k = 0; k < kH1; ++k) acc = acc + r[k] * w2t[k * kH2 + lane];
            acc = acc + w[kB2 + lane];
            S[(kA2 + lane) * B + b] = fmaxf(acc, 0.0f);
        }
        __syncwarp();
    }
    grid.sync();

    // 5. BN2's statistics
    bn_stats([&](int f, int b) { return __ldcg(S + (kA2 + f) * B + b); },
             kH2, B, gw, ngw, lane, state_in, stats, state_out, kSt2, mom,
             omm);
    grid.sync();

    // 6. per sample: BN2, the dropout, the logits and the loss
    load_stats(stats, kSt2, kH2, mu_s, sd_s);
    for (int b = gw; b < B; b += ngw) {
        const int y = y_all[idx[b]];
        if (lane < kH2) {
            const int j = lane;
            const float xh = (__ldcg(S + (kA2 + j) * B + b) - mu_s[j]) / sd_s[j];
            S[(kXh2 + j) * B + b] = xh;
            const float yv = xh * w[kBn2W + j] + w[kBn2B + j];
            const float keep = unif[kUnif * b + kH1 + j] >= p2 ? 1.0f : 0.0f;
            const float d2 = (yv * keep) / keep2;
            S[(kD2 + j) * B + b] = d2;
            r[j] = d2;
        }
        __syncwarp();
        float l0 = 0.0f, l1 = neg_inf();
        for (int k = 0; k < kH2; ++k) l0 = l0 + r[k] * wot[k * kOut + lane];
        l0 = l0 + w[kBout + lane];
        if (hi) {
            const int j = lane + 32;
            l1 = 0.0f;
            for (int k = 0; k < kH2; ++k) l1 = l1 + r[k] * wot[k * kOut + j];
            l1 = l1 + w[kBout + j];
        }
        logits[(size_t)kOut * b + lane] = l0;
        S[(kLogit + lane) * B + b] = l0;
        if (hi) {
            logits[(size_t)kOut * b + lane + 32] = l1;
            S[(kLogit + lane + 32) * B + b] = l1;
        }
        // the max is exact: any order gives it (-inf first, as the chain
        // of fmaxf the one-thread kernel took)
        float mx = fmaxf(fmaxf(neg_inf(), l0), l1);
        for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float ly = __shfl_sync(0xffffffffu, y < 32 ? l0 : l1, y & 31);
        __syncwarp();
        r[lane] = expf(l0 - mx);
        if (hi) r[lane + 32] = expf(l1 - mx);
        __syncwarp();
        if (lane == 0) {
            float se = 0.0f;
            for (int j = 0; j < kOut; ++j) se = se + r[j];
            S[kLoss * B + b] = (logf(se) + mx) - ly;
        }
        __syncwarp();
    }
    grid.sync();

    // 7. the mean loss
    if (gw == 0) {
        float s = 0.0f;
        for (int b = lane; b < B; b += 32) s += __ldcg(S + kLoss * B + b);
        s = warp_sum(s);
        if (lane == 0) *loss = s / (float)B;
    }
}

// The backward: a grid as the forward's (see the comment above
// fme_train_fwd_kernel), with blocks of kBwdThreads.
constexpr int kBwdThreads = 256, kBwdWarps = kBwdThreads / 32;
// one warp an entry of the gradient pass: more blocks would idle there
constexpr int kBwdGridMax = (kEntries + kBwdWarps - 1) / kBwdWarps;

// A warp's sum of a[t] * c[t] (c null: of a[t]) over t = lane, lane + 32,
// ... < B, in that order; eight products loaded ahead of their adds.
__device__ __forceinline__ float dot_rows(const float* a, const float* c,
                                          int B, int lane) {
    float s = 0.0f;
    int t = lane;
    for (; t + 32 * 7 < B; t += 32 * 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
            v[u] = c ? __ldcg(a + t + 32 * u) * c[t + 32 * u]
                     : __ldcg(a + t + 32 * u);
#pragma unroll
        for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; t < B; t += 32) s += c ? __ldcg(a + t) * c[t] : __ldcg(a + t);
    return warp_sum(s);
}

// A BN layer's backward reductions, a warp a row: the shift's gradient
// s1 = sum dy and the scale's s2 = sum dy xh, into grad.
__device__ void bn_grad_rows(const float* dy, const float* xh, int F, int B,
                             int gw, int ngw, int lane, float* g_shift,
                             float* g_scale) {
    for (int f = gw; f < F; f += ngw) {
        const float* d = dy + (size_t)f * B;
        const float* x = xh + (size_t)f * B;
        float a = 0.0f, c = 0.0f;
        int t = lane;
        for (; t + 32 * 7 < B; t += 32 * 8) {
            float dv[8], xv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                dv[u] = __ldcg(d + t + 32 * u);
                xv[u] = x[t + 32 * u];
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                a += dv[u];
                c += dv[u] * xv[u];
            }
        }
        for (; t < B; t += 32) {
            const float dv = __ldcg(d + t);
            a += dv;
            c += dv * x[t];
        }
        a = warp_sum(a);
        c = warp_sum(c);
        if (lane == 0) {
            g_shift[f] = a;
            g_scale[f] = c;
        }
    }
}

// A block's copy of one BN layer's sums (from grad, written by other
// blocks before the last grid sync) and sqrt(var + eps).
__device__ __forceinline__ void load_bn(const float* grad, int shift,
                                        int scale, const float* var, int F,
                                        float* s1, float* s2, float* sd_s) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        s1[f] = __ldcg(grad + shift + f);
        s2[f] = __ldcg(grad + scale + f);
        sd_s[f] = sqrtf(var[f] + kEps);
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kBwdThreads) fme_train_bwd_kernel(
        const float* __restrict__ flat, const int* __restrict__ cat_all,
        const int* __restrict__ y_all, const int* __restrict__ idx,
        const float* __restrict__ unif, const float* __restrict__ S, int B,
        float p1, float keep1, float p2, float keep2,
        const float* __restrict__ stats, const float* __restrict__ gscale,
        float* grad, float* Wk) {
    namespace cg = cooperative_groups;
    cg::grid_group grid = cg::this_grid();
    __shared__ float w[kFlat];
    __shared__ float s1[kH1], s2[kH1], sd_s[kH1];
    __shared__ float row[kBwdWarps][kOut + 1];  // a warp's sample row
    for (int e = threadIdx.x; e < kFlat; e += blockDim.x) w[e] = flat[e];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int gw = blockIdx.x * kBwdWarps + warp;  // the grid's warp
    const int ngw = gridDim.x * kBwdWarps;
    const float fB = (float)B;
    float* r = row[warp];
    const bool hi = lane + 32 < kOut;  // lane holds logits lane, lane + 32
    __syncthreads();

    // 1. per sample: the mean's transpose, then logsumexp's and the
    // label's (dlogits); d(BN2 out) through Wout^T and the dropout
    const float c = *gscale / fB;
    for (int b = gw; b < B; b += ngw) {
        const int y = y_all[idx[b]];
        const float l0 = S[(kLogit + lane) * B + b];
        const float l1 = hi ? S[(kLogit + lane + 32) * B + b] : neg_inf();
        float mx = fmaxf(l0, l1);  // max is exact: any order gives it
        for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float e0 = expf(l0 - mx);
        const float e1 = hi ? expf(l1 - mx) : 0.0f;
        r[lane] = e0;
        if (hi) r[lane + 32] = e1;
        __syncwarp();
        float se = 0.0f;
        for (int j = 0; j < kOut; ++j) se = se + r[j];
        const float cs = c / se;
        float dl0 = cs * e0, dl1 = cs * e1;
        if (lane == y) dl0 = dl0 - c;
        if (lane + 32 == y) dl1 = dl1 - c;
        Wk[(kDl + lane) * B + b] = dl0;
        if (hi) Wk[(kDl + lane + 32) * B + b] = dl1;
        __syncwarp();
        r[lane] = dl0;
        if (hi) r[lane + 32] = dl1;
        __syncwarp();
        if (lane < kH2) {
            float dd = 0.0f;
            for (int j = 0; j < kOut; ++j) dd = dd + r[j] * w[kWout + j * kH2 + lane];
            const float keep = unif[kUnif * b + kH1 + lane] >= p2 ? 1.0f : 0.0f;
            Wk[(kDy2 + lane) * B + b] = (dd / keep2) * keep;
        }
        __syncwarp();
    }
    grid.sync();
    bn_grad_rows(Wk + kDy2 * B, S + kXh2 * B, kH2, B, gw, ngw, lane,
                 grad + kBn2B, grad + kBn2W);
    grid.sync();

    // 2. per sample: BN2's backward with batch statistics, ReLU; d(BN1
    // out) through W2^T and the dropout
    load_bn(grad, kBn2B, kBn2W, stats + kSt2 + kH2, kH2, s1, s2, sd_s);
    for (int b = gw; b < B; b += ngw) {
        if (lane < kH2) {
            const int k = lane;
            const float g = w[kBn2W + k];
            const float dxh = __ldcg(Wk + (kDy2 + k) * B + b) * g;
            const float da = (dxh - (g * s1[k]) / fB
                              - S[(kXh2 + k) * B + b] * ((g * s2[k]) / fB))
                             / sd_s[k];
            const float dz = S[(kA2 + k) * B + b] > 0.0f ? da : 0.0f;
            Wk[(kDz2 + k) * B + b] = dz;
            r[k] = dz;
        }
        __syncwarp();
        if (lane < kH1) {
            float dd = 0.0f;
            for (int k = 0; k < kH2; ++k) dd = dd + r[k] * w[kW2 + k * kH1 + lane];
            const float keep = unif[kUnif * b + lane] >= p1 ? 1.0f : 0.0f;
            Wk[(kDy1 + lane) * B + b] = (dd / keep1) * keep;
        }
        __syncwarp();
    }
    grid.sync();
    bn_grad_rows(Wk + kDy1 * B, S + kXh1 * B, kH1, B, gw, ngw, lane,
                 grad + kBn1B, grad + kBn1W);
    grid.sync();

    // 3. per sample: BN1's backward, ReLU; d(input row) through W1^T
    load_bn(grad, kBn1B, kBn1W, stats + kSt1 + kH1, kH1, s1, s2, sd_s);
    for (int b = gw; b < B; b += ngw) {
        if (lane < kH1) {
            const int j = lane;
            const float g = w[kBn1W + j];
            const float dxh = __ldcg(Wk + (kDy1 + j) * B + b) * g;
            const float da = (dxh - (g * s1[j]) / fB
                              - S[(kXh1 + j) * B + b] * ((g * s2[j]) / fB))
                             / sd_s[j];
            const float dz = S[(kA1 + j) * B + b] > 0.0f ? da : 0.0f;
            Wk[(kDz1 + j) * B + b] = dz;
            r[j] = dz;
        }
        __syncwarp();
        if (lane < kIn) {
            float acc = 0.0f;
            for (int j = 0; j < kH1; ++j) acc = acc + r[j] * w[kW1 + j * kIn + lane];
            Wk[(kDinp + lane) * B + b] = acc;
        }
        __syncwarp();
    }
    grid.sync();

    // 4. every other gradient: a warp of the grid an entry, the batch in
    // a fixed order
    for (int e = gw; e < kEntries; e += ngw) {
        float s;
        int dst;
        if (e < kEBout) {
            s = dot_rows(Wk + (kDl + e / kH2) * B, S + (kD2 + e % kH2) * B, B,
                         lane);
            dst = kWout + e;
        } else if (e < kEW2) {
            s = dot_rows(Wk + (kDl + e - kEBout) * B, nullptr, B, lane);
            dst = kBout + e - kEBout;
        } else if (e < kEB2) {
            const int q = e - kEW2;
            s = dot_rows(Wk + (kDz2 + q / kH1) * B, S + (kD1 + q % kH1) * B,
                         B, lane);
            dst = kW2 + q;
        } else if (e < kEW1) {
            s = dot_rows(Wk + (kDz2 + e - kEB2) * B, nullptr, B, lane);
            dst = kB2 + e - kEB2;
        } else if (e < kEB1) {
            const int q = e - kEW1;
            s = dot_rows(Wk + (kDz1 + q / kIn) * B, S + (kInp + q % kIn) * B,
                         B, lane);
            dst = kW1 + q;
        } else if (e < kEBnIn) {
            s = dot_rows(Wk + (kDz1 + e - kEB1) * B, nullptr, B, lane);
            dst = kB1 + e - kEB1;
        } else if (e < kEEmb) {
            const int k = e - kEBnIn;
            s = dot_rows(Wk + (kDinp + 8 + k) * B, S + (kXin + k) * B, B,
                         lane);
            dst = kBnIn + k;
        } else {
            // emb0 rows 0-7 then emb1 rows 0-7, 4 columns each: the rows
            // of the samples whose category is that row
            const int q = e - kEEmb, tab = q / 32, rr = (q % 32) / 4,
                      col = q % 4;
            const float* a = Wk + (kDinp + 4 * tab + col) * B;
            s = 0.0f;
            for (int t = lane; t < B; t += 32)
                if (cat_all[2 * idx[t] + tab] == rr) s += __ldcg(a + t);
            s = warp_sum(s);
            dst = kEmb0 + q;  // emb1 follows emb0 in the flat layout
        }
        if (lane == 0) grad[dst] = s;
    }
}

// optax.adam's python floats, each rounded once to float32 (as the plain
// version's _adam_consts).
constexpr float kAdamB1 = (float)0.9, kAdamOmB1 = (float)(1.0 - 0.9),
                kAdamB2 = (float)0.999, kAdamOmB2 = (float)(1.0 - 0.999),
                kAdamEps = (float)1e-8;
constexpr int kAdamThreads = 256;

// One element a thread over ceil(n / 256) blocks. Every block reads the
// count before it takes a ticket; the block that takes the last ticket
// (so every block has read the count) writes count + 1 and resets the
// ticket for the next launch.
__global__ void __launch_bounds__(kAdamThreads) fme_adam_kernel(
        float* __restrict__ p, const float* __restrict__ g,
        float* __restrict__ m, float* __restrict__ v, int* count,
        unsigned* ticket, int n, float neg_lr) {
    __shared__ int c_s;
    if (threadIdx.x == 0) c_s = *count + 1;
    __syncthreads();
    const int c = c_s;
    const int i = blockIdx.x * kAdamThreads + threadIdx.x;
    if (i < n) {
        const float bc1 = 1.0f - powf(kAdamB1, (float)c);
        const float bc2 = 1.0f - powf(kAdamB2, (float)c);
        const float gi = g[i];
        const float mi = kAdamOmB1 * gi + kAdamB1 * m[i];
        const float vi = kAdamOmB2 * (gi * gi) + kAdamB2 * v[i];
        const float u = (mi / bc1) / (sqrtf(vi / bc2) + kAdamEps);
        p[i] = p[i] + u * neg_lr;
        m[i] = mi;
        v[i] = vi;
    }
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
            *count = c;
            *ticket = 0u;
        }
    }
}

// The largest grid of `kernel` (blocks of `threads`) that can be resident
// at once on the current device (a cooperative launch's limit), cached
// per device in `cached`.
cudaError_t resident_blocks(const void* kernel, int threads, int* cached,
                            int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && cached[dev] > 0) {
        *out = cached[dev];
        return cudaSuccess;
    }
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) cached[dev] = per_sm * sms;
    *out = per_sm * sms;
    return cudaSuccess;
}

// The backward's grid: as many blocks as the gradient pass has warps'
// work for, at most what can be resident at once.
cudaError_t bwd_grid(int* grid) {
    static int cached[64];
    int g = 0;
    const cudaError_t err = resident_blocks(
        (const void*)fme_train_bwd_kernel, kBwdThreads, cached, &g);
    if (err != cudaSuccess) return err;
    *grid = g < kBwdGridMax ? g : kBwdGridMax;
    return cudaSuccess;
}

// The forward's grid for a batch of B: a warp a sample, at most what can
// be resident at once.
cudaError_t fwd_grid(int B, int* grid) {
    static int cached[64];
    int g = 0;
    const cudaError_t err = resident_blocks(
        (const void*)fme_train_fwd_kernel, kFwdThreads, cached, &g);
    if (err != cudaSuccess) return err;
    const int want = (B + kFwdWarps - 1) / kFwdWarps;
    *grid = want < g ? want : g;
    return cudaSuccess;
}

}  // namespace

// flat (2042,), state (102,) fp32; x (N, 9) fp32, cat (N, 2) int32, y (N,)
// int32, idx (B,) int32 rows, unif (B, 42) fp32 -> logits (B, 49), loss
// (1,), stats (102,), state_out (102,; may alias state), saved (202 B,).
// One cooperative launch on fwd_grid's grid.
extern "C" int tpuhevc_fme_train_fwd(const float* flat, const float* state,
                                     const float* x, const int* cat,
                                     const int* y, const int* idx,
                                     const float* unif, int B, float p1,
                                     float keep1, float p2, float keep2,
                                     float mom, float omm, float* logits,
                                     float* loss, float* stats,
                                     float* state_out, float* saved,
                                     void* stream) {
    if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
    int grid = 0;
    cudaError_t err = fwd_grid(B, &grid);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&flat, (void*)&state, (void*)&x, (void*)&cat,
                    (void*)&y, (void*)&idx, (void*)&unif, (void*)&B,
                    (void*)&p1, (void*)&keep1, (void*)&p2, (void*)&keep2,
                    (void*)&mom, (void*)&omm, (void*)&logits, (void*)&loss,
                    (void*)&stats, (void*)&state_out, (void*)&saved};
    err = cudaLaunchCooperativeKernel((const void*)fme_train_fwd_kernel,
                                      dim3(grid), dim3(kFwdThreads), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The forward's launch geometry for a batch of B on the current device:
// blocks, threads a block, and 1 (a cooperative launch).
extern "C" int tpuhevc_fme_train_fwd_geometry(int B, int* grid, int* block,
                                              int* cooperative) {
    if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
    *block = kFwdThreads;
    *cooperative = 1;
    return (int)fwd_grid(B, grid);
}

// The forward's saved (202 B,) and stats (102,), the upstream gradient
// gscale (1,) -> grad (2042,); work (150 B,) is scratch. One cooperative
// launch on bwd_grid's grid.
extern "C" int tpuhevc_fme_train_bwd(const float* flat, const int* cat,
                                     const int* y, const int* idx,
                                     const float* unif, const float* saved,
                                     int B, float p1, float keep1, float p2,
                                     float keep2, const float* stats,
                                     const float* gscale, float* grad,
                                     float* work, void* stream) {
    if (B < 1 || B > kMaxBatch) return (int)cudaErrorInvalidValue;
    int grid = 0;
    cudaError_t err = bwd_grid(&grid);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&flat, (void*)&cat, (void*)&y, (void*)&idx,
                    (void*)&unif, (void*)&saved, (void*)&B, (void*)&p1,
                    (void*)&keep1, (void*)&p2, (void*)&keep2, (void*)&stats,
                    (void*)&gscale, (void*)&grad, (void*)&work};
    err = cudaLaunchCooperativeKernel((const void*)fme_train_bwd_kernel,
                                      dim3(grid), dim3(kBwdThreads), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The backward's launch geometry on the current device: blocks, threads
// a block, and 1 (a cooperative launch).
extern "C" int tpuhevc_fme_train_bwd_geometry(int* grid, int* block,
                                              int* cooperative) {
    *block = kBwdThreads;
    *cooperative = 1;
    return (int)bwd_grid(grid);
}

// In place on p, m, v (n,) and count (1,) int32, with g (n,); ticket (1,)
// is zero between launches; neg_lr is float32(-lr).
extern "C" int tpuhevc_fme_adam(float* p, const float* g, float* m, float* v,
                                int* count, unsigned* ticket, int n,
                                float neg_lr, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    fme_adam_kernel<<<(n + kAdamThreads - 1) / kAdamThreads, kAdamThreads, 0,
                      (cudaStream_t)stream>>>(p, g, m, v, count, ticket, n,
                                              neg_lr);
    return (int)cudaGetLastError();
}
