// K2: the NN-FME MLP with its argmax and quarter-pel offset.
//
// Replaces: tpuhevc/models/nnfme.py:176, `forward`, and the argmax ->
// CLASS_TO_QMV step at tpuhevc/codec/inter_batch.py:222-228.
//
// What it computes, per PU: x = ((sad9 - mean) / std) * bn_in; the input
// row [emb0[hcat] (4), emb1[wcat] (4), x (9)]; h1 = relu(W1 in + b1) *
// bn1_w + bn1_b (22); h2 = relu(W2 h1 + b2) * bn2_w + bn2_b (20); logits
// = Wout h2 + bout (49, fp32); the first maximal class; and the offset
// ((c % 7) - 3, (c / 7) - 3) in quarter pels.
//
// What bounds it: nothing on this card at the slice's sizes (a few
// hundred rows x ~1.8 k multiply-adds); launch latency dominates.
// Design: one thread per PU, the 2060 weights staged once per block in
// shared memory (all threads of a warp read the same weight at the same
// time, a broadcast). Sums run in input order with IEEE division; the file
// is built with -fmad=false, so each product rounds on its own as on the
// CPU. The remaining difference to the reference is the summation order
// of its matrix products (tests hold logits to atol 1e-4).

#include <cuda_runtime.h>

namespace {

// offsets into the packed weights, PARAM_KEYS order
constexpr int kEmb0 = 0, kEmb1 = 32, kW1 = 64, kB1 = 438, kW2 = 460,
              kB2 = 900, kWout = 920, kBout = 1900, kBnIn = 1949,
              kBn1W = 1958, kBn1B = 1980, kBn2W = 2002, kBn2B = 2022,
              kMean = 2042, kStd = 2051, kPacked = 2060;
constexpr int kIn = 17, kH1 = 22, kH2 = 20, kOut = 49;
constexpr int kThreads = 128;

__global__ void nnfme_mlp_kernel(const int* __restrict__ sad9,
                                 const float* __restrict__ packed,
                                 float* __restrict__ logits,
                                 int* __restrict__ cls,
                                 int* __restrict__ qoff,
                                 int n, int hcat, int wcat) {
    __shared__ float w[kPacked];
    for (int e = threadIdx.x; e < kPacked; e += blockDim.x) w[e] = packed[e];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float in[kIn];
    for (int k = 0; k < 4; ++k) {
        in[k] = w[kEmb0 + hcat * 4 + k];
        in[4 + k] = w[kEmb1 + wcat * 4 + k];
    }
    for (int k = 0; k < 9; ++k) {
        const float x = ((float)sad9[9 * i + k] - w[kMean + k]) / w[kStd + k];
        in[8 + k] = x * w[kBnIn + k];
    }
    float h1[kH1];
    for (int j = 0; j < kH1; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < kIn; ++k) acc = acc + in[k] * w[kW1 + j * kIn + k];
        acc = acc + w[kB1 + j];
        h1[j] = fmaxf(acc, 0.0f) * w[kBn1W + j] + w[kBn1B + j];
    }
    float h2[kH2];
    for (int j = 0; j < kH2; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < kH1; ++k) acc = acc + h1[k] * w[kW2 + j * kH1 + k];
        acc = acc + w[kB2 + j];
        h2[j] = fmaxf(acc, 0.0f) * w[kBn2W + j] + w[kBn2B + j];
    }
    float best = 0.0f;
    int bc = 0;
    for (int j = 0; j < kOut; ++j) {
        float acc = 0.0f;
        for (int k = 0; k < kH2; ++k) acc = acc + h2[k] * w[kWout + j * kH2 + k];
        acc = acc + w[kBout + j];
        logits[(size_t)kOut * i + j] = acc;
        if (j == 0 || acc > best) { best = acc; bc = j; }  // first max wins
    }
    cls[i] = bc;
    qoff[2 * i] = bc % 7 - 3;
    qoff[2 * i + 1] = bc / 7 - 3;
}

}  // namespace

// sad9 (n, 9) int32, packed (2060,) fp32 -> logits (n, 49) fp32, cls (n,)
// int32, qoff (n, 2) int32. hcat/wcat: embedding rows (0..7) of the class.
extern "C" int tpuhevc_nnfme_mlp(const int* sad9, const float* packed,
                                 float* logits, int* cls, int* qoff, int n,
                                 int hcat, int wcat, void* stream) {
    const int blocks = (n + kThreads - 1) / kThreads;
    nnfme_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        sad9, packed, logits, cls, qoff, n, hcat, wcat);
    return (int)cudaGetLastError();
}
