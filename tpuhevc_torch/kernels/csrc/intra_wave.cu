// intra_wave: fixed-8x8 intra coding of whole pictures, wave by wave.
//
// Replaces: tpuhevc/codec/intra_jax.py:182-314 (`build_frame_encoder`, the
// `lax.scan` of `step` 205-281 over the dependency wavefronts of 8x8
// cells) and its vmap over frames in `encode_frames_intra_jax_batch`
// (317-369), which XLA compiled for the TPU.
//
// What it computes, per frame f and wave s, for every cell of the wave
// (the geometry's `cells` row; -1 marks an empty slot, which is skipped
// and writes nothing), from the recon planes of the earlier waves:
//   refs: the 33 luma samples [lb(8), l(8), corner, t(8), tr(8)] around
//     the 8x8 block (left segments bottom-first; positions clamped to the
//     picture), substituted at segment granularity (section 8.4.4.2.2): an
//     unavailable segment takes the last sample of the nearest available
//     segment before it, else the first sample of the first available
//     one, else 1 << (bd - 1); chroma the same with 4x4 blocks (17
//     samples) on each half-size plane;
//   decision: for each of the 35 luma modes (intra_pred.cuh, the 8x8
//     reference filtering and boundary filters) cost = (sum |H d H^T| + 2)
//     >> 2 of d = org - pred (hadamard.cuh) + ((bits * sqlam_fp) >> 8),
//     bits 2 inside the three MPM candidates of the left and above modes
//     (1 where the neighbour is outside, the above one also at a CTU's
//     top row) and 6 outside; the first mode of least cost;
//   coding: residual, the 8x8 DCT, the flat intra quantiser, dequantiser
//     and inverse DCT (tx_common.cuh), rec = clip(pred + r) where any
//     level is non-zero, else pred; the levels and recon scattered into
//     the planes; chroma the same at 4x4 (DCT) with the luma mode (DM) at
//     the chroma QP.
// Integer and exact: equal to the plain version and to JAX bit for bit.
//
// What bounds it: the dependency depth. A wave needs the recon of the
// one before, so a picture is `steps` rounds (238 at 416x240, 112 at
// 192x128) of a few thousand integer operations on at most a few dozen
// cells; the bytes (each plane once) and operations over the whole card
// take about 0.001 ms.
// Design: one thread block per frame (the reference's vmap over frames);
// the block walks the waves in order, with barriers between the steps of
// a wave. Each step spreads its tasks over the block's 1,024 threads: the
// reference gathers (cell, sample); the 35-mode costs (cell, mode, row),
// eight lanes a mode, each predicting its row and taking the row
// butterfly in registers, the column butterflies across the lanes by warp
// shuffles (hadamard.cuh); the argmin one thread per cell in mode order
// (the first minimum, as jnp.argmin); the transform stages (cell, output)
// for luma and both chroma planes together. Per-cell work lives in shared
// memory; the recon, level and mode planes live in device memory, written
// and read back by the same block (the barrier makes a wave's writes
// visible to the next). One whole 8x8 prediction and Hadamard per thread
// (64 inlined predictor copies, 100 registers, 512 threads) took 2.6x as
// long. One block per frame leaves most SMs idle for a single picture:
// the next step is several blocks (or a cluster) per frame.

#include "hadamard.cuh"
#include "intra_pred.cuh"
#include "tx_common.cuh"

namespace {

constexpr int kThreads = 1024;

struct Quant {
    int scale, add, qbits, dqscale, dqshift;
};

// Sample i (0..4s) of the substituted reference run [lb, l, c, t, tr] of
// the s x s block at (x0, y0) of a pw x ph plane; avail: bits 0-4 for the
// five segments.
__device__ __forceinline__ int ref_sample(const int* plane, int pw, int ph,
                                          int x0, int y0, int s, int i,
                                          int avail, int mid) {
    const int bound[6] = {0, s, 2 * s, 2 * s + 1, 3 * s + 1, 4 * s + 1};
    const int k = i < s ? 0 : i < 2 * s ? 1 : i == 2 * s ? 2
                : i <= 3 * s ? 3 : 4;
    int src = i;
    if (!((avail >> k) & 1)) {
        int j = k - 1;
        while (j >= 0 && !((avail >> j) & 1)) --j;
        if (j >= 0) {
            src = bound[j + 1] - 1;  // the last sample before the gap
        } else {
            int k2 = k + 1;
            while (k2 < 5 && !((avail >> k2) & 1)) ++k2;
            if (k2 == 5) return mid;
            src = bound[k2];  // the first available sample
        }
    }
    int x, y;
    if (src < 2 * s) {
        x = x0 - 1;
        y = y0 + 2 * s - 1 - src;
    } else {
        x = x0 + src - 2 * s - 1;
        y = y0 - 1;
    }
    x = min(max(x, 0), pw - 1);
    y = min(max(y, 0), ph - 1);
    return plane[y * pw + x];
}

__global__ void __launch_bounds__(kThreads)
intra_wave_kernel(const int* __restrict__ oy, const int* __restrict__ ou,
                  const int* __restrict__ ov, const int* __restrict__ cells,
                  const int* __restrict__ flags, int* ry, int* ru, int* rv,
                  int* modes, int* cy, int* cb, int* cr, int w, int h,
                  int steps, int bmax, Quant qy, Quant qc, int sqlam_fp,
                  int bd, int strong) {
    extern __shared__ int smem[];
    const int B = bmax;
    int* s_cell = smem;             // [B] cell index or -1
    int* s_flag = s_cell + B;       // [B] availability and MPM bits
    int* s_mode = s_flag + B;       // [B] chosen mode
    int* s_dc = s_mode + B;         // [B] luma DC value
    int* s_nz = s_dc + B;           // [3][B] any level non-zero (Y, U, V)
    int* s_mpm = s_nz + 3 * B;      // [B][3] MPM candidates
    int* s_t = s_mpm + 3 * B;       // [B][17] luma top, corner first
    int* s_l = s_t + 17 * B;        // [B][17] luma left
    int* s_ft = s_l + 17 * B;       // [B][17] filtered
    int* s_fl = s_ft + 17 * B;      // [B][17]
    int* s_cost = s_fl + 17 * B;    // [B][35]
    int* s_org = s_cost + 35 * B;   // [B][64]
    int* s_pred = s_org + 64 * B;   // [B][64] luma, then [2][B][16] chroma
    int* s_A = s_pred + 96 * B;     // [B][64] luma, then [2][B][16] chroma
    int* s_B = s_A + 96 * B;        // transform scratch, same layout
    int* s_ct = s_B + 96 * B;       // [2][B][9] chroma top
    int* s_cl = s_ct + 18 * B;      // [2][B][9] chroma left
    int* s_T8 = s_cl + 18 * B;      // 8x8 DCT
    int* s_T4 = s_T8 + 64;          // 4x4 DCT

    const int tid = threadIdx.x;
    const int f = blockIdx.x;
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
    const int mid = 1 << (bd - 1), maxv = (1 << bd) - 1;

    tx_load_matrix(s_T8, 3, false);
    tx_load_matrix(s_T4, 2, false);

    for (int s = 0; s < steps; ++s) {
        // 1. the wave's slots
        for (int b = tid; b < B; b += kThreads) {
            s_cell[b] = cells[s * B + b];
            s_flag[b] = flags[s * B + b];
            s_nz[b] = s_nz[B + b] = s_nz[2 * B + b] = 0;
        }
        __syncthreads();

        // 2. references (luma 33, chroma 2 x 17), the original block, MPM
        for (int task = tid; task < B * 132; task += kThreads) {
            const int b = task / 132, k = task - b * 132;
            const int cell = s_cell[b];
            if (cell < 0) continue;
            const int x8 = cell % w8, y8 = cell / w8, fl = s_flag[b];
            if (k < 33) {
                const int v = ref_sample(ry, w, h, x8 * 8, y8 * 8, 8, k,
                                         fl & 31, mid);
                if (k >= 16) s_t[b * 17 + k - 16] = v;
                if (k <= 16) s_l[b * 17 + 16 - k] = v;
            } else if (k < 67) {
                const int p = (k - 33) / 17, i = (k - 33) - p * 17;
                const int v = ref_sample(p ? rv : ru, cw, ch, x8 * 4, y8 * 4,
                                         4, i, fl & 31, mid);
                if (i >= 8) s_ct[(p * B + b) * 9 + i - 8] = v;
                if (i <= 8) s_cl[(p * B + b) * 9 + 8 - i] = v;
            } else if (k < 131) {
                const int e = k - 67;
                s_org[b * 64 + e] =
                    oy[(y8 * 8 + (e >> 3)) * w + x8 * 8 + (e & 7)];
            } else {
                const int a = (fl & 32) ? modes[cell - 1] : 1;
                const int c = (fl & 64) ? modes[cell - w8] : 1;
                int* m = s_mpm + b * 3;
                if (a == c) {
                    if (a < 2) {
                        m[0] = 0;
                        m[1] = 1;
                        m[2] = 26;
                    } else {
                        m[0] = a;
                        m[1] = 2 + ((a + 29) % 32);
                        m[2] = 2 + ((a - 2 + 1) % 32);
                    }
                } else {
                    m[0] = a;
                    m[1] = c;
                    m[2] = (a != 0 && c != 0) ? 0
                         : (a != 1 && c != 1) ? 1 : 26;
                }
            }
        }
        __syncthreads();

        // 3. the filtered luma references and the DC value
        for (int task = tid; task < B * 18; task += kThreads) {
            const int b = task / 18, i = task - b * 18;
            if (s_cell[b] < 0) continue;
            const int* t = s_t + b * 17;
            const int* l = s_l + b * 17;
            if (i < 17)
                intra_smooth_at(t, l, i, 16, false, &s_ft[b * 17 + i],
                                &s_fl[b * 17 + i]);
            else
                s_dc[b] = intra_dc(t, l, 3);
        }
        __syncthreads();

        // 4. the cost of every (cell, mode): 8 lanes a pair, lane r the
        // prediction and row butterfly of row r, the column butterflies
        // across the 8 lanes (every lane of a warp takes part)
        for (int base = 0; base < B * 35 * 8; base += kThreads) {
            const int task = base + tid;
            const int pair = task >> 3, r = task & 7;
            const int b = pair / 35, mode = pair - b * 35;
            const bool on = task < B * 35 * 8 && s_cell[b] >= 0;
            int v[8];
            if (on) {
                const int *t = s_t + b * 17, *l = s_l + b * 17;
                const int *ft = s_ft + b * 17, *fl = s_fl + b * 17;
                const int* org = s_org + b * 64 + r * 8;
                const int dc = s_dc[b];
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    v[c] = org[c] - intra_pred_sample(t, l, ft, fl, dc, mode,
                                                      r, c, 3, true, true,
                                                      maxv);
            } else {
#pragma unroll
                for (int c = 0; c < 8; ++c) v[c] = 0;
            }
            const int sum = hadamard8_lanes_abs_sum(v, r);
            if (on && r == 0) {
                const int* m = s_mpm + b * 3;
                const int bits =
                    (mode == m[0] || mode == m[1] || mode == m[2]) ? 2 : 6;
                s_cost[b * 35 + mode] =
                    ((sum + 2) >> 2) + ((bits * sqlam_fp) >> 8);
            }
        }
        __syncthreads();

        // 5. the first mode of least cost
        for (int b = tid; b < B; b += kThreads) {
            const int cell = s_cell[b];
            if (cell < 0) continue;
            const int* c = s_cost + b * 35;
            int best = 0;
            for (int m = 1; m < 35; ++m)
                if (c[m] < c[best]) best = m;
            s_mode[b] = best;
            modes[cell] = best;
        }
        __syncthreads();

        // 6. the chosen predictions and the residuals: luma (b, e < 64),
        // then chroma (p, b, e < 16)
        for (int task = tid; task < B * 96; task += kThreads) {
            int b, p, e;
            if (task < B * 64) {
                b = task >> 6;
                e = task & 63;
                p = -1;
            } else {
                const int u = task - B * 64;
                p = u / (B * 16);
                b = (u >> 4) - p * B;
                e = u & 15;
            }
            const int cell = s_cell[b];
            if (cell < 0) continue;
            const int mode = s_mode[b];
            if (p < 0) {
                const int pv = intra_pred_sample(
                    s_t + b * 17, s_l + b * 17, s_ft + b * 17, s_fl + b * 17,
                    s_dc[b], mode, e >> 3, e & 7, 3, true, true, maxv);
                s_pred[task] = pv;
                s_A[task] = s_org[task] - pv;
            } else {
                const int* t = s_ct + (p * B + b) * 9;
                const int* l = s_cl + (p * B + b) * 9;
                const int dc = intra_dc(t, l, 2);
                const int pv = intra_pred_sample(t, l, t, l, dc, mode,
                                                 e >> 2, e & 3, 2, false,
                                                 false, maxv);
                const int x8 = cell % w8, y8 = cell / w8;
                const int o = (p ? ov : ou)[(y8 * 4 + (e >> 2)) * cw
                                            + x8 * 4 + (e & 3)];
                s_pred[task] = pv;
                s_A[task] = o - pv;
            }
        }
        __syncthreads();

        // 7. forward transform, rows
        for (int task = tid; task < B * 96; task += kThreads) {
            const bool luma = task < B * 64;
            const int b = luma ? task >> 6 : ((task - B * 64) >> 4) % B;
            if (s_cell[b] < 0) continue;
            const int base = luma ? task & ~63 : task & ~15;
            s_B[task] = tx_fwd_rows(s_A + base, luma ? s_T8 : s_T4,
                                    luma ? 3 : 2, task - base);
        }
        __syncthreads();

        // 8. forward transform, columns; quantise, write the levels,
        // dequantise
        for (int task = tid; task < B * 96; task += kThreads) {
            const bool luma = task < B * 64;
            int b, p, e;
            if (luma) {
                b = task >> 6;
                e = task & 63;
                p = 0;
            } else {
                const int u = task - B * 64;
                p = 1 + u / (B * 16);
                b = (u >> 4) - (p - 1) * B;
                e = u & 15;
            }
            const int cell = s_cell[b];
            if (cell < 0) continue;
            const int base = task - e;
            const Quant& q = luma ? qy : qc;
            const int lev = tx_quant(
                tx_fwd_cols(s_B + base, luma ? s_T8 : s_T4, luma ? 3 : 2, e),
                q.scale, q.add, q.qbits);
            const int x8 = cell % w8, y8 = cell / w8;
            if (luma)
                cy[(y8 * 8 + (e >> 3)) * w + x8 * 8 + (e & 7)] = lev;
            else
                (p == 1 ? cb : cr)[(y8 * 4 + (e >> 2)) * cw + x8 * 4
                                   + (e & 3)] = lev;
            if (lev != 0) s_nz[p * B + b] = 1;
            s_A[task] = tx_dequant(lev, q.dqscale, q.dqshift);
        }
        __syncthreads();

        // 9. inverse transform, columns
        for (int task = tid; task < B * 96; task += kThreads) {
            const bool luma = task < B * 64;
            const int b = luma ? task >> 6 : ((task - B * 64) >> 4) % B;
            if (s_cell[b] < 0) continue;
            const int base = luma ? task & ~63 : task & ~15;
            s_B[task] = tx_inv_cols(s_A + base, luma ? s_T8 : s_T4,
                                    luma ? 3 : 2, task - base);
        }
        __syncthreads();

        // 10. inverse transform, rows; the recon
        for (int task = tid; task < B * 96; task += kThreads) {
            const bool luma = task < B * 64;
            int b, p, e;
            if (luma) {
                b = task >> 6;
                e = task & 63;
                p = 0;
            } else {
                const int u = task - B * 64;
                p = 1 + u / (B * 16);
                b = (u >> 4) - (p - 1) * B;
                e = u & 15;
            }
            const int cell = s_cell[b];
            if (cell < 0) continue;
            const int base = task - e;
            const int pv = s_pred[task];
            int rec = pv;
            if (s_nz[p * B + b]) {
                const int r = tx_inv_rows(s_B + base, luma ? s_T8 : s_T4,
                                          luma ? 3 : 2, e);
                rec = min(max(pv + r, 0), maxv);
            }
            const int x8 = cell % w8, y8 = cell / w8;
            if (luma)
                ry[(y8 * 8 + (e >> 3)) * w + x8 * 8 + (e & 7)] = rec;
            else
                (p == 1 ? ru : rv)[(y8 * 4 + (e >> 2)) * cw + x8 * 4
                                   + (e & 3)] = rec;
        }
        __syncthreads();
    }
}

}  // namespace

// Shared memory of one block (bytes) for waves of bmax slots.
extern "C" int tpuhevc_intra_wave_smem(int bmax) {
    return (int)(sizeof(int) * ((size_t)bmax * (10 + 17 * 4 + 35 + 64
                                                 + 96 * 3 + 36) + 80));
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

// oy (F, h, w), ou, ov (F, h/2, w/2) int32 on the device, w and h
// multiples of 8; cells, flags (steps, bmax) int32 (the wave schedule:
// cell index y8 * (w / 8) + x8 or -1; bits 0-4 availability of [lb, l, c,
// t, tr], bit 5 the left MPM neighbour, bit 6 the above one) -> ry, cy
// (F, h, w), ru, rv, cb, cr (F, h/2, w/2), modes (F, h/8, w/8) int32.
// Every cell must appear once in the schedule. Quantiser constants (luma
// 8x8 at QP, chroma 4x4 at the chroma QP) as
// tpuhevc_torch/ops/transforms.py quant_params / dequant_params give them.
extern "C" int tpuhevc_intra_wave(
    const int* oy, const int* ou, const int* ov, const int* cells,
    const int* flags, int* ry, int* ru, int* rv, int* modes, int* cy,
    int* cb, int* cr, int nframes, int w, int h, int steps, int bmax,
    int qy_scale, int qy_add, int qy_bits, int qy_dqscale, int qy_dqshift,
    int qc_scale, int qc_add, int qc_bits, int qc_dqscale, int qc_dqshift,
    int sqlam_fp, int bd, int strong, void* stream) {
    const int smem = tpuhevc_intra_wave_smem(bmax);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            intra_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    const Quant qy = {qy_scale, qy_add, qy_bits, qy_dqscale, qy_dqshift};
    const Quant qc = {qc_scale, qc_add, qc_bits, qc_dqscale, qc_dqshift};
    intra_wave_kernel<<<nframes, kThreads, smem, (cudaStream_t)stream>>>(
        oy, ou, ov, cells, flags, ry, ru, rv, modes, cy, cb, cr, w, h, steps,
        bmax, qy, qc, sqlam_fp, bd, strong);
    return (int)cudaGetLastError();
}
