// K4: fused inter TU coding with the skip/code decision.
//
// Replaces: tpuhevc/codec/inter_batch.py:193-211 (`coded_plane`,
// `bits_est`, `sse`) and the drop rule at 231-236 / 246-252 (closures of
// build_ldp_scan that XLA compiled for the TPU), over the int32 JAX
// transforms of tpuhevc/ops/transforms.py:144-198.
//
// What it computes, per TU of size S (4..32), 8-bit:
//   r = cur - pred
//   h = (r T^T + 2^(s1-1)) >> s1, s1 = log2 - 1;  c = (T h + 2^(s2-1)) >> s2, s2 = log2 + 6
//   lvl = sign(c) * ((|c| * qscale + qadd) >> qbits), clipped to int16
//   deq = lvl * dqscale, then a rounded >> dqshift (or << -dqshift), int16
//   g = clip16((T^T deq + 64) >> 7);  rsd = clip16((g T + 2048) >> 12)
//   rec = nz ? clip(pred + rsd, 0, 255) : pred, nz = any(lvl != 0)
//   bits = sum(2 * min(15, bitlen|lvl|) + (lvl != 0))
//   drop = (sse(cur, pred) - sse(cur, rec)) <= (lam_full * bits) >> 8,
//          the product wrapping in int32 as under JAX
//   dropped: lvl = 0, rec = pred, d = sse(cur, pred), bits = 0;
//   else d = sse(cur, rec).
// Every sum is int32 exactly as in JAX (stage sums stay below 2^28).
//
// What bounds it: integer multiply-adds, 4 S^3 per TU (~131 k at S=32),
// all on shared memory; device memory sees cur and pred once and lvl/rec
// once.
// Design: one block per TU, the whole chain in one launch with no
// intermediate in device memory. The transform core is the shared one of
// tx_common.cuh (the HEVC matrix in constant memory, staged per block
// into shared memory; one pass per stage, thread per output, barriers
// between); the four sums (nz, bits, both SSEs) are block reductions.

#include "tx_common.cuh"

namespace {

__global__ void txq_kernel(const int* __restrict__ cur,
                           const int* __restrict__ pred,
                           int* __restrict__ lvl_out,
                           int* __restrict__ rec_out,
                           int* __restrict__ d_out,
                           int* __restrict__ bits_out,
                           int log2, int qscale, int qadd, int qbits,
                           int dqscale, int dqshift, int lam_full) {
    extern __shared__ int smem[];
    __shared__ int scratch[32];
    const int S = 1 << log2, n2 = S * S;
    int* T = smem;          // S x S matrix
    int* A = T + n2;        // residual, coefficients, dequantised, recon
    int* B = A + n2;        // transform scratch
    int* L = B + n2;        // levels
    const int n = blockIdx.x;
    const int* cb = cur + (size_t)n * n2;
    const int* pb = pred + (size_t)n * n2;

    tx_load_matrix(T, log2, false);
    int sse_skip = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int r = cb[e] - pb[e];
        A[e] = r;
        sse_skip += r * r;
    }
    __syncthreads();
    tx_forward(A, B, T, log2);

    // quantise, count, dequantise
    int nz = 0, bits = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int lev = tx_quant(A[e], qscale, qadd, qbits);
        L[e] = lev;
        const int a = abs(lev);
        nz += a != 0;
        bits += 2 * min(15, 32 - __clz(a)) + (a != 0);
        A[e] = tx_dequant(lev, dqscale, dqshift);
    }
    nz = block_sum(nz, scratch);  // its barriers also complete A
    bits = block_sum(bits, scratch);
    tx_inverse(A, B, T, log2);

    // recon
    int sse_coded = 0;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        const int p = pb[e];
        const int rec = nz ? min(max(p + A[e], 0), 255) : p;
        A[e] = rec;
        const int dd = cb[e] - rec;
        sse_coded += dd * dd;
    }
    sse_skip = block_sum(sse_skip, scratch);
    sse_coded = block_sum(sse_coded, scratch);

    const int rate = (int)((unsigned)lam_full * (unsigned)bits) >> 8;
    const bool drop = (sse_skip - sse_coded) <= rate;
    int* lo = lvl_out + (size_t)n * n2;
    int* ro = rec_out + (size_t)n * n2;
    for (int e = threadIdx.x; e < n2; e += blockDim.x) {
        lo[e] = drop ? 0 : L[e];
        ro[e] = drop ? pb[e] : A[e];
    }
    if (threadIdx.x == 0) {
        d_out[n] = drop ? sse_skip : sse_coded;
        bits_out[n] = drop ? 0 : bits;
    }
}

}  // namespace

// Copies the 32x32 HEVC DCT matrix (int32, host memory) to constant memory
// of the current device. Call once per device before tpuhevc_txq.
extern "C" int tpuhevc_txq_init(const int* host_t32) {
    cudaMemcpyToSymbol(c_dct32, host_t32, sizeof(int) * 32 * 32);
    return (int)cudaGetLastError();
}

// cur, pred (n, S, S) int32 on the device, S = 1 << log2 in 4..32 ->
// lvl, rec (n, S, S), d, bits (n,). Quantiser constants as
// tpuhevc_torch/ops/transforms.py quant_params / dequant_params give them.
extern "C" int tpuhevc_txq(const int* cur, const int* pred, int* lvl,
                           int* rec, int* d, int* bits, int n, int log2,
                           int qscale, int qadd, int qbits, int dqscale,
                           int dqshift, int lam_full, void* stream) {
    const int n2 = 1 << (2 * log2);
    const int threads = n2 >= 256 ? 256 : (n2 < 32 ? 32 : n2);
    const size_t smem = (size_t)4 * n2 * sizeof(int);
    txq_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
        cur, pred, lvl, rec, d, bits, log2, qscale, qadd, qbits, dqscale,
        dqshift, lam_full);
    return (int)cudaGetLastError();
}
