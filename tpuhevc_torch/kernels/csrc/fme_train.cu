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
// ~25 MFLOP and ~1 MB (B = 1,024); launch latency and one block's serial
// depth (three barriers' worth of batch reductions each way) dominate.
// Design: one block of up to 1,024 threads, one thread a sample (B <=
// 1,024); the 2,042 weights staged in shared memory (a broadcast: a warp
// reads one weight at a time). Activations go to global scratch laid out
// feature by feature (row r of sample b at r * B + b: coalesced per
// thread and contiguous per reduction). Every sum over the batch (the BN
// statistics, the BN and weight gradients, the loss) is one warp's: lane
// l sums samples l, l + 32, ... in order, then a fixed shuffle tree whose
// lane-0 result is used. No float atomics, so two runs give the same
// bits. Built with -fmad=false, so each product rounds on its own as in
// the plain version; the remaining differences to it are sum orders
// (and expf/logf/powf's last bits).

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
constexpr int kXin = 0;                 // raw x, then its input-BN xhat
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

constexpr int kMaxThreads = 1024;
static_assert(kSaved == 202 && kWork == 150 && kEntries == 1958,
              "ops/fme_train.py's SAVED_ROWS and WORK_ROWS");

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Sum over a warp in a fixed tree; lane 0's result, broadcast.
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return __shfl_sync(0xffffffffu, v, 0);
}

// A warp's sum of row[0..B), lane l taking l, l + 32, ... in order.
__device__ __forceinline__ float row_sum(const float* row, int B, int lane) {
    float s = 0.0f;
    for (int b = lane; b < B; b += 32) s += row[b];
    return warp_sum(s);
}

// The batch statistics of F rows (one warp a row): the mean, the biased
// variance (two passes, as jnp.var), sqrt(var + eps) into sd_s, the
// statistics and the running update at offset `off` (mu at off, var at
// off + F).
__device__ void bn_stats(const float* rows, int F, int B, int warp,
                         int nwarps, int lane, float* mu_s, float* sd_s,
                         const float* state_in, float* stats,
                         float* state_out, int off, float mom, float omm) {
    for (int f = warp; f < F; f += nwarps) {
        const float* r = rows + (size_t)f * B;
        const float mu = row_sum(r, B, lane) / (float)B;
        float q = 0.0f;
        for (int b = lane; b < B; b += 32) {
            const float d = r[b] - mu;
            q += d * d;
        }
        const float var = warp_sum(q) / (float)B;
        if (lane == 0) {
            mu_s[f] = mu;
            sd_s[f] = sqrtf(var + kEps);
            stats[off + f] = mu;
            stats[off + F + f] = var;
            state_out[off + f] = omm * state_in[off + f] + mom * mu;
            state_out[off + F + f] = omm * state_in[off + F + f] + mom * var;
        }
    }
}

// A BN layer's backward reductions (one warp a row): s1 = sum dy (the
// shift's gradient), s2 = sum dy xh (the scale's).
__device__ void bn_grad(const float* dy, const float* xh, int F, int B,
                        int warp, int nwarps, int lane, float* s1, float* s2,
                        float* g_shift, float* g_scale) {
    for (int f = warp; f < F; f += nwarps) {
        const float* d = dy + (size_t)f * B;
        const float* x = xh + (size_t)f * B;
        float a = 0.0f, c = 0.0f;
        for (int b = lane; b < B; b += 32) {
            a += d[b];
            c += d[b] * x[b];
        }
        a = warp_sum(a);
        c = warp_sum(c);
        if (lane == 0) {
            s1[f] = a;
            s2[f] = c;
            g_shift[f] = a;
            g_scale[f] = c;
        }
    }
}

__global__ void __launch_bounds__(kMaxThreads) fme_train_fwd_kernel(
        const float* __restrict__ flat, const float* state_in,
        const float* __restrict__ x_all, const int* __restrict__ cat_all,
        const int* __restrict__ y_all, const int* __restrict__ idx,
        const float* __restrict__ unif, int B, float p1, float keep1,
        float p2, float keep2, float mom, float omm,
        float* __restrict__ logits, float* __restrict__ loss,
        float* __restrict__ stats, float* state_out,
        float* __restrict__ S) {
    __shared__ float w[kFlat];
    __shared__ float mu_s[kH1], sd_s[kH1];
    for (int e = threadIdx.x; e < kFlat; e += blockDim.x) w[e] = flat[e];
    const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
    const int nwarps = blockDim.x >> 5;
    const bool live = b < B;
    int hc = 0, wc = 0, y = 0;
    if (live) {
        const int row = idx[b];
        hc = cat_all[2 * row];
        wc = cat_all[2 * row + 1];
        y = y_all[row];
        for (int k = 0; k < kX; ++k)
            S[(kXin + k) * B + b] = x_all[kX * row + k];
    }
    __syncthreads();
    bn_stats(S + kXin * B, kX, B, warp, nwarps, lane, mu_s, sd_s, state_in,
             stats, state_out, kStIn, mom, omm);
    __syncthreads();
    if (live) {
        float in[kIn];
        for (int k = 0; k < 4; ++k) {
            in[k] = w[kEmb0 + 4 * hc + k];
            in[4 + k] = w[kEmb1 + 4 * wc + k];
        }
        for (int k = 0; k < kX; ++k) {
            const float xh = (S[(kXin + k) * B + b] - mu_s[k]) / sd_s[k];
            S[(kXin + k) * B + b] = xh;
            in[8 + k] = xh * w[kBnIn + k];
        }
        for (int k = 0; k < kIn; ++k) S[(kInp + k) * B + b] = in[k];
        for (int j = 0; j < kH1; ++j) {
            float acc = 0.0f;
            for (int k = 0; k < kIn; ++k) acc = acc + in[k] * w[kW1 + j * kIn + k];
            acc = acc + w[kB1 + j];
            S[(kA1 + j) * B + b] = fmaxf(acc, 0.0f);
        }
    }
    __syncthreads();
    bn_stats(S + kA1 * B, kH1, B, warp, nwarps, lane, mu_s, sd_s, state_in,
             stats, state_out, kSt1, mom, omm);
    __syncthreads();
    if (live) {
        float d1[kH1];
        for (int j = 0; j < kH1; ++j) {
            const float xh = (S[(kA1 + j) * B + b] - mu_s[j]) / sd_s[j];
            S[(kXh1 + j) * B + b] = xh;
            const float yv = xh * w[kBn1W + j] + w[kBn1B + j];
            const float keep = unif[kUnif * b + j] >= p1 ? 1.0f : 0.0f;
            d1[j] = (yv * keep) / keep1;
            S[(kD1 + j) * B + b] = d1[j];
        }
        for (int j = 0; j < kH2; ++j) {
            float acc = 0.0f;
            for (int k = 0; k < kH1; ++k) acc = acc + d1[k] * w[kW2 + j * kH1 + k];
            acc = acc + w[kB2 + j];
            S[(kA2 + j) * B + b] = fmaxf(acc, 0.0f);
        }
    }
    __syncthreads();
    bn_stats(S + kA2 * B, kH2, B, warp, nwarps, lane, mu_s, sd_s, state_in,
             stats, state_out, kSt2, mom, omm);
    __syncthreads();
    if (live) {
        float d2[kH2];
        for (int j = 0; j < kH2; ++j) {
            const float xh = (S[(kA2 + j) * B + b] - mu_s[j]) / sd_s[j];
            S[(kXh2 + j) * B + b] = xh;
            const float yv = xh * w[kBn2W + j] + w[kBn2B + j];
            const float keep = unif[kUnif * b + kH1 + j] >= p2 ? 1.0f : 0.0f;
            d2[j] = (yv * keep) / keep2;
            S[(kD2 + j) * B + b] = d2[j];
        }
        float mx = neg_inf();
        for (int j = 0; j < kOut; ++j) {
            float acc = 0.0f;
            for (int k = 0; k < kH2; ++k) acc = acc + d2[k] * w[kWout + j * kH2 + k];
            acc = acc + w[kBout + j];
            logits[(size_t)kOut * b + j] = acc;
            S[(kLogit + j) * B + b] = acc;
            mx = fmaxf(mx, acc);
        }
        float se = 0.0f;
        for (int j = 0; j < kOut; ++j) se = se + expf(S[(kLogit + j) * B + b] - mx);
        S[kLoss * B + b] = (logf(se) + mx) - S[(kLogit + y) * B + b];
    }
    __syncthreads();
    if (warp == 0) {
        const float s = row_sum(S + kLoss * B, B, lane);
        if (lane == 0) *loss = s / (float)B;
    }
}

__global__ void __launch_bounds__(kMaxThreads) fme_train_bwd_kernel(
        const float* __restrict__ flat, const int* __restrict__ cat_all,
        const int* __restrict__ y_all, const int* __restrict__ idx,
        const float* __restrict__ unif, const float* __restrict__ S, int B,
        float p1, float keep1, float p2, float keep2,
        const float* __restrict__ stats, const float* __restrict__ gscale,
        float* __restrict__ grad, float* __restrict__ Wk) {
    __shared__ float w[kFlat];
    __shared__ float s1[kH1], s2[kH1], sd_s[kH1];
    for (int e = threadIdx.x; e < kFlat; e += blockDim.x) w[e] = flat[e];
    const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
    const int nwarps = blockDim.x >> 5;
    const bool live = b < B;
    const float fB = (float)B;
    if (b < kH2) sd_s[b] = sqrtf(stats[kSt2 + kH2 + b] + kEps);
    __syncthreads();
    if (live) {
        // the mean's transpose, then logsumexp's and the label's
        const int y = y_all[idx[b]];
        const float c = *gscale / fB;
        float mx = neg_inf();
        for (int j = 0; j < kOut; ++j) mx = fmaxf(mx, S[(kLogit + j) * B + b]);
        float se = 0.0f;
        for (int j = 0; j < kOut; ++j) se = se + expf(S[(kLogit + j) * B + b] - mx);
        const float cs = c / se;
        float dd2[kH2];
        for (int k = 0; k < kH2; ++k) dd2[k] = 0.0f;
        for (int j = 0; j < kOut; ++j) {
            float dl = cs * expf(S[(kLogit + j) * B + b] - mx);
            if (j == y) dl = dl - c;
            Wk[(kDl + j) * B + b] = dl;
            for (int k = 0; k < kH2; ++k) dd2[k] = dd2[k] + dl * w[kWout + j * kH2 + k];
        }
        for (int k = 0; k < kH2; ++k) {
            const float keep = unif[kUnif * b + kH1 + k] >= p2 ? 1.0f : 0.0f;
            Wk[(kDy2 + k) * B + b] = (dd2[k] / keep2) * keep;
        }
    }
    __syncthreads();
    bn_grad(Wk + kDy2 * B, S + kXh2 * B, kH2, B, warp, nwarps, lane, s1, s2,
            grad + kBn2B, grad + kBn2W);
    __syncthreads();
    if (live) {
        float dz2[kH2];
        for (int k = 0; k < kH2; ++k) {
            const float g = w[kBn2W + k];
            const float dxh = Wk[(kDy2 + k) * B + b] * g;
            const float da = (dxh - (g * s1[k]) / fB
                              - S[(kXh2 + k) * B + b] * ((g * s2[k]) / fB))
                             / sd_s[k];
            dz2[k] = S[(kA2 + k) * B + b] > 0.0f ? da : 0.0f;
            Wk[(kDz2 + k) * B + b] = dz2[k];
        }
        float dd1[kH1];
        for (int j = 0; j < kH1; ++j) dd1[j] = 0.0f;
        for (int k = 0; k < kH2; ++k)
            for (int j = 0; j < kH1; ++j) dd1[j] = dd1[j] + dz2[k] * w[kW2 + k * kH1 + j];
        for (int j = 0; j < kH1; ++j) {
            const float keep = unif[kUnif * b + j] >= p1 ? 1.0f : 0.0f;
            Wk[(kDy1 + j) * B + b] = (dd1[j] / keep1) * keep;
        }
    }
    __syncthreads();
    if (b < kH1) sd_s[b] = sqrtf(stats[kSt1 + kH1 + b] + kEps);
    bn_grad(Wk + kDy1 * B, S + kXh1 * B, kH1, B, warp, nwarps, lane, s1, s2,
            grad + kBn1B, grad + kBn1W);
    __syncthreads();
    if (live) {
        float dz1[kH1];
        for (int j = 0; j < kH1; ++j) {
            const float g = w[kBn1W + j];
            const float dxh = Wk[(kDy1 + j) * B + b] * g;
            const float da = (dxh - (g * s1[j]) / fB
                              - S[(kXh1 + j) * B + b] * ((g * s2[j]) / fB))
                             / sd_s[j];
            dz1[j] = S[(kA1 + j) * B + b] > 0.0f ? da : 0.0f;
            Wk[(kDz1 + j) * B + b] = dz1[j];
        }
        for (int k = 0; k < kIn; ++k) {
            float acc = 0.0f;
            for (int j = 0; j < kH1; ++j) acc = acc + dz1[j] * w[kW1 + j * kIn + k];
            Wk[(kDinp + k) * B + b] = acc;
        }
    }
    __syncthreads();
    // every other gradient: one warp an entry, the batch in a fixed order
    for (int e = warp; e < kEntries; e += nwarps) {
        float s = 0.0f;
        int dst;
        if (e < kEBout) {
            const float* a = Wk + (kDl + e / kH2) * B;
            const float* c = S + (kD2 + e % kH2) * B;
            for (int t = lane; t < B; t += 32) s += a[t] * c[t];
            dst = kWout + e;
        } else if (e < kEW2) {
            const float* a = Wk + (kDl + e - kEBout) * B;
            for (int t = lane; t < B; t += 32) s += a[t];
            dst = kBout + e - kEBout;
        } else if (e < kEB2) {
            const int q = e - kEW2;
            const float* a = Wk + (kDz2 + q / kH1) * B;
            const float* c = S + (kD1 + q % kH1) * B;
            for (int t = lane; t < B; t += 32) s += a[t] * c[t];
            dst = kW2 + q;
        } else if (e < kEW1) {
            const float* a = Wk + (kDz2 + e - kEB2) * B;
            for (int t = lane; t < B; t += 32) s += a[t];
            dst = kB2 + e - kEB2;
        } else if (e < kEB1) {
            const int q = e - kEW1;
            const float* a = Wk + (kDz1 + q / kIn) * B;
            const float* c = S + (kInp + q % kIn) * B;
            for (int t = lane; t < B; t += 32) s += a[t] * c[t];
            dst = kW1 + q;
        } else if (e < kEBnIn) {
            const float* a = Wk + (kDz1 + e - kEB1) * B;
            for (int t = lane; t < B; t += 32) s += a[t];
            dst = kB1 + e - kEB1;
        } else if (e < kEEmb) {
            const int k = e - kEBnIn;
            const float* a = Wk + (kDinp + 8 + k) * B;
            const float* c = S + (kXin + k) * B;
            for (int t = lane; t < B; t += 32) s += a[t] * c[t];
            dst = kBnIn + k;
        } else {
            // emb0 rows 0-7 then emb1 rows 0-7, 4 columns each: the rows
            // of the samples whose category is that row
            const int q = e - kEEmb, tab = q / 32, r = (q % 32) / 4, col = q % 4;
            const float* a = Wk + (kDinp + 4 * tab + col) * B;
            for (int t = lane; t < B; t += 32)
                if (cat_all[2 * idx[t] + tab] == r) s += a[t];
            dst = kEmb0 + q;  // emb1 follows emb0 in the flat layout
        }
        s = warp_sum(s);
        if (lane == 0) grad[dst] = s;
    }
}

// optax.adam's python floats, each rounded once to float32 (as the plain
// version's _adam_consts).
constexpr float kAdamB1 = (float)0.9, kAdamOmB1 = (float)(1.0 - 0.9),
                kAdamB2 = (float)0.999, kAdamOmB2 = (float)(1.0 - 0.999),
                kAdamEps = (float)1e-8;

__global__ void __launch_bounds__(kMaxThreads) fme_adam_kernel(
        float* __restrict__ p, const float* __restrict__ g,
        float* __restrict__ m, float* __restrict__ v, int* __restrict__ count,
        int n, float neg_lr) {
    __shared__ int c_s;
    if (threadIdx.x == 0) c_s = *count + 1;
    __syncthreads();
    const int c = c_s;
    const float bc1 = 1.0f - powf(kAdamB1, (float)c);
    const float bc2 = 1.0f - powf(kAdamB2, (float)c);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float gi = g[i];
        const float mi = kAdamOmB1 * gi + kAdamB1 * m[i];
        const float vi = kAdamOmB2 * (gi * gi) + kAdamB2 * v[i];
        const float u = (mi / bc1) / (sqrtf(vi / bc2) + kAdamEps);
        p[i] = p[i] + u * neg_lr;
        m[i] = mi;
        v[i] = vi;
    }
    if (threadIdx.x == 0) *count = c;
}

int block_for(int B) { return ((B + 31) / 32) * 32; }

}  // namespace

// flat (2042,), state (102,) fp32; x (N, 9) fp32, cat (N, 2) int32, y (N,)
// int32, idx (B,) int32 rows, unif (B, 42) fp32 -> logits (B, 49), loss
// (1,), stats (102,), state_out (102,; may alias state), saved (202 B,).
extern "C" int tpuhevc_fme_train_fwd(const float* flat, const float* state,
                                     const float* x, const int* cat,
                                     const int* y, const int* idx,
                                     const float* unif, int B, float p1,
                                     float keep1, float p2, float keep2,
                                     float mom, float omm, float* logits,
                                     float* loss, float* stats,
                                     float* state_out, float* saved,
                                     void* stream) {
    if (B < 1 || B > kMaxThreads) return (int)cudaErrorInvalidValue;
    fme_train_fwd_kernel<<<1, block_for(B), 0, (cudaStream_t)stream>>>(
        flat, state, x, cat, y, idx, unif, B, p1, keep1, p2, keep2, mom, omm,
        logits, loss, stats, state_out, saved);
    return (int)cudaGetLastError();
}

// The forward's saved (202 B,) and stats (102,), the upstream gradient
// gscale (1,) -> grad (2042,); work (150 B,) is scratch.
extern "C" int tpuhevc_fme_train_bwd(const float* flat, const int* cat,
                                     const int* y, const int* idx,
                                     const float* unif, const float* saved,
                                     int B, float p1, float keep1, float p2,
                                     float keep2, const float* stats,
                                     const float* gscale, float* grad,
                                     float* work, void* stream) {
    if (B < 1 || B > kMaxThreads) return (int)cudaErrorInvalidValue;
    fme_train_bwd_kernel<<<1, block_for(B), 0, (cudaStream_t)stream>>>(
        flat, cat, y, idx, unif, saved, B, p1, keep1, p2, keep2, stats,
        gscale, grad, work);
    return (int)cudaGetLastError();
}

// In place on p, m, v (n,) and count (1,) int32, with g (n,); neg_lr is
// float32(-lr).
extern "C" int tpuhevc_fme_adam(float* p, const float* g, float* m, float* v,
                                int* count, int n, float neg_lr,
                                void* stream) {
    fme_adam_kernel<<<1, kMaxThreads, 0, (cudaStream_t)stream>>>(
        p, g, m, v, count, n, neg_lr);
    return (int)cudaGetLastError();
}
