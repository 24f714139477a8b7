// K2: the NN-FME MLP with its argmax and quarter-pel offset, over up to
// three classes of PUs (segments) in one launch.
//
// Replaces: tpuhevc/models/nnfme.py:176, `forward`, and the argmax ->
// CLASS_TO_QMV step at tpuhevc/codec/inter_batch.py:222-228 (the grid
// step's `nn_refine`, tpuhevc/codec/inter_grid.py:932-940, per class).
//
// What it computes, per PU: x = ((sad9 - mean) / std) * bn_in; the input
// row [emb0[hcat] (4), emb1[wcat] (4), x (9)]; h1 = relu(W1 in + b1) *
// bn1_w + bn1_b (22); h2 = relu(W2 h1 + b2) * bn2_w + bn2_b (20); logits
// = Wout h2 + bout (49, fp32); the first maximal class; and the offset
// ((c % 7) - 3, (c / 7) - 3) in quarter pels. Each segment has its own
// SADs, categories and outputs; logits and classes are written only
// where the segment has somewhere to put them.
//
// What bounds it: ~1.8 k multiply-adds a PU, a few thousand PUs a
// picture: latency and launches, not bytes (0.00004 ms of bound a call)
// nor operations. Design: a warp a PU, its lanes across output neurons.
// Lanes 0-8 normalise the nine SADs and lanes 0-7 hold the embedding
// values; lane j < 22 forms h1[j], reading the 17 inputs by shuffles in
// input order; lane j < 20 forms h2[j]; lane j forms logit j and, for
// j < 17, logit j + 32. Each lane keeps its weight rows and biases in
// registers (~90 floats), loaded once a warp: warps stride over the PUs
// of every segment, so no block stages the weights. The argmax is a
// shuffle reduction of (value, class): the larger value wins, an equal
// value the lower class (the first maximum, as the one-thread loop's
// `acc > best` and jnp.argmax). Every value is formed in the one-thread
// kernel's operation order (each sum from k = 0 in order, then the bias;
// fmaxf(., 0) * bn_w + bn_b; IEEE division) and the file is built with
// -fmad=false, so the logits equal that kernel's bit for bit; against the
// plain version the difference is its matrix products' summation order
// (tests hold logits to atol 1e-4).

#include <cuda_runtime.h>

namespace {

// offsets into the packed weights, PARAM_KEYS order
constexpr int kEmb0 = 0, kEmb1 = 32, kW1 = 64, kB1 = 438, kW2 = 460,
              kB2 = 900, kWout = 920, kBout = 1900, kBnIn = 1949,
              kBn1W = 1958, kBn1B = 1980, kBn2W = 2002, kBn2B = 2022,
              kMean = 2042, kStd = 2051;
constexpr int kIn = 17, kH1 = 22, kH2 = 20, kOut = 49;
constexpr int kThreads = 128, kWarps = kThreads / 32, kMaxSegs = 3;
constexpr unsigned kFull = 0xffffffffu;

// one class of PUs: its SADs (n, 9), outputs (qoff (n, 2); logits (n, 49)
// and cls (n,) or null), embedding rows, and its first PU in the launch
struct Seg {
    const int* sad9;
    int* qoff;
    float* logits;
    int* cls;
    int n, hcat, wcat, start;
};
struct Segs {
    Seg s[kMaxSegs];
    int total;
};

// no cap on registers below 255: the weight rows stay out of local memory
__global__ void __launch_bounds__(kThreads)
nnfme_mlp_kernel(const float* __restrict__ w, const Segs segs) {
    const int lane = threadIdx.x & 31;
    const int nwarp = gridDim.x * kWarps;
    // this lane's weight rows, in registers for every PU the warp takes
    const int j1 = min(lane, kH1 - 1), j2 = min(lane, kH2 - 1);
    const int jo = lane, jo2 = min(lane + 32, kOut - 1);
    float w1[kIn], w2[kH1], wo[kH2], wo2[kH2];
#pragma unroll
    for (int k = 0; k < kIn; ++k) w1[k] = __ldg(&w[kW1 + j1 * kIn + k]);
#pragma unroll
    for (int k = 0; k < kH1; ++k) w2[k] = __ldg(&w[kW2 + j2 * kH1 + k]);
#pragma unroll
    for (int k = 0; k < kH2; ++k) {
        wo[k] = __ldg(&w[kWout + jo * kH2 + k]);
        wo2[k] = __ldg(&w[kWout + jo2 * kH2 + k]);
    }
    const float b1 = __ldg(&w[kB1 + j1]), s1 = __ldg(&w[kBn1W + j1]),
                t1 = __ldg(&w[kBn1B + j1]);
    const float b2 = __ldg(&w[kB2 + j2]), s2 = __ldg(&w[kBn2W + j2]),
                t2 = __ldg(&w[kBn2B + j2]);
    const float bo = __ldg(&w[kBout + jo]), bo2 = __ldg(&w[kBout + jo2]);
    const int ki = min(lane, 8);
    const float mean = __ldg(&w[kMean + ki]), sd = __ldg(&w[kStd + ki]),
                bnin = __ldg(&w[kBnIn + ki]);

    for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < segs.total;
         g += nwarp) {
        // the segment of PU g (warp-uniform; the starts past the last
        // segment are the total), its fields selected, not indexed
        const int s = (g >= segs.s[1].start) + (g >= segs.s[2].start);
        const Seg sg = s == 0 ? segs.s[0] : s == 1 ? segs.s[1] : segs.s[2];
        const int i = g - sg.start;
        // lanes 0-8: x[lane]; lanes 0-7: the embedding values in[lane]
        const int sv = lane < 9 ? __ldg(&sg.sad9[9 * i + lane]) : 0;
        const float x = ((float)sv - mean) / sd * bnin;
        const float e = lane < 4 ? __ldg(&w[kEmb0 + sg.hcat * 4 + lane])
                                 : __ldg(&w[kEmb1 + sg.wcat * 4 + (lane & 3)]);
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kIn; ++k) {
            const float v = k < 8 ? __shfl_sync(kFull, e, k)
                                  : __shfl_sync(kFull, x, k - 8);
            acc = acc + v * w1[k];
        }
        acc = acc + b1;
        const float h1 = fmaxf(acc, 0.0f) * s1 + t1;
        acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kH1; ++k)
            acc = acc + __shfl_sync(kFull, h1, k) * w2[k];
        acc = acc + b2;
        const float h2 = fmaxf(acc, 0.0f) * s2 + t2;
        float lo = 0.0f, hi = 0.0f;
#pragma unroll
        for (int k = 0; k < kH2; ++k) {
            const float v = __shfl_sync(kFull, h2, k);
            lo = lo + v * wo[k];
            hi = hi + v * wo2[k];
        }
        lo = lo + bo;
        hi = hi + bo2;
        const bool two = lane + 32 < kOut;
        if (sg.logits) {
            sg.logits[(size_t)kOut * i + lane] = lo;
            if (two) sg.logits[(size_t)kOut * i + 32 + lane] = hi;
        }
        // the first maximum: lane-local (class j before j + 32), then
        // across lanes, the lower class on equal values
        float best = lo;
        int bc = lane;
        if (two && hi > best) {
            best = hi;
            bc = lane + 32;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(kFull, best, o);
            const int oc = __shfl_xor_sync(kFull, bc, o);
            if (ov > best || (ov == best && oc < bc)) {
                best = ov;
                bc = oc;
            }
        }
        if (lane < 2) sg.qoff[2 * i + lane] = lane ? bc / 7 - 3 : bc % 7 - 3;
        if (lane == 0 && sg.cls) sg.cls[i] = bc;
    }
}

}  // namespace

// packed (2060,) fp32 weights; per segment k < nseg: sad9 (n, 9) int32 ->
// qoff (n, 2) int32, and where not null logits (n, 49) fp32 and cls (n,)
// int32; hcat/wcat its embedding rows (0..7); the segments from nseg on
// are ignored. max_blocks: the most blocks of kThreads the launch takes
// (warps stride over the rest; tpuhevc_nnfme_mlp_blocks gives the
// card's resident count).
extern "C" int tpuhevc_nnfme_mlp(
    const float* packed, const int* sad0, int* qoff0, float* logits0,
    int* cls0, int n0, int hcat0, int wcat0, const int* sad1, int* qoff1,
    float* logits1, int* cls1, int n1, int hcat1, int wcat1,
    const int* sad2, int* qoff2, float* logits2, int* cls2, int n2,
    int hcat2, int wcat2, int nseg, int max_blocks, void* stream) {
    if (nseg < 1 || nseg > kMaxSegs || max_blocks < 1)
        return (int)cudaErrorInvalidValue;
    Segs segs;
    const Seg all[kMaxSegs] = {
        {sad0, qoff0, logits0, cls0, n0, hcat0, wcat0, 0},
        {sad1, qoff1, logits1, cls1, n1, hcat1, wcat1, 0},
        {sad2, qoff2, logits2, cls2, n2, hcat2, wcat2, 0}};
    int total = 0;
    for (int k = 0; k < kMaxSegs; ++k) {
        segs.s[k] = all[k];
        segs.s[k].start = total;
        if (k < nseg) total += all[k].n;
    }
    segs.total = total;
    if (total == 0) return 0;
    // two PUs a warp where the card has room, else warps stride further
    const int blocks = min((total + 2 * kWarps - 1) / (2 * kWarps),
                           max_blocks);
    nnfme_mlp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(packed,
                                                                   segs);
    return (int)cudaGetLastError();
}

// the blocks of the kernel that the current card holds at once (its SMs
// times the blocks an SM fits), or a negative CUDA error
extern "C" int tpuhevc_nnfme_mlp_blocks() {
    int dev = 0, sms = 0, per = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, nnfme_mlp_kernel, kThreads, 0);
    return err == cudaSuccess ? sms * per : -(int)err;
}
