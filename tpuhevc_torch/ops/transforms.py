"""HEVC core transforms, scalar quantiser and table RDOQ on torch tensors.

Twin of `tpuhevc/ops/transforms.py:144-198` (`forward_transform`,
`inverse_transform` with the 4x4 DST-VII, `quantize`, `dequantize`): the
same shifts, rounding and clips, on (..., S, S) int32 tensors; and of
`rdoq_est_xp` (`transforms.py:317-422`) in float32, as its jnp branch. The products are taken in int64
as broadcast-multiply-sum, which is exact on the CPU and on CUDA alike
(torch has no integer matmul on CUDA, and fp32/TF32 would round the
second stage); every stage sum stays below 2^28, so the int32 results
equal the JAX variant's int32 arithmetic. These are the plain versions
that the fused TU kernels (`ops/txq.py`, `ops/intra_txq.py`) are held
against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tables import (
    DST4,
    INV_QUANT_SCALES,
    MAX_TR_DYNAMIC_RANGE,
    QUANT_SCALES,
    dct_matrix,
)

from ..entropy.bitest import bit_length_minus1, rice_param, up4

_MATS: dict = {}


def matrix(size: int, device, is_dst: bool = False) -> torch.Tensor:
    """The size x size HEVC DCT-II matrix (or the 4x4 DST-VII) as an int64
    tensor on `device`."""
    key = (size, str(device), is_dst)
    t = _MATS.get(key)
    if t is None:
        t = torch.as_tensor(DST4 if is_dst else dct_matrix(size),
                            dtype=torch.int64, device=device)
        _MATS[key] = t
    return t


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b over the last two dims (int64)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def forward_transform(resi: torch.Tensor, bit_depth: int = 8,
                      is_dst: bool = False) -> torch.Tensor:
    """(..., S, S) residual -> coefficients [y][x] (int32)."""
    s = resi.shape[-1]
    log2 = s.bit_length() - 1
    t = matrix(s, resi.device, is_dst)
    s1 = log2 + bit_depth - 9
    s2 = log2 + 6
    h = (_mm(resi.long(), t.T) + (1 << (s1 - 1))) >> s1
    c = (_mm(t, h) + (1 << (s2 - 1))) >> s2
    return c.int()


def inverse_transform(coeff: torch.Tensor, bit_depth: int = 8,
                      is_dst: bool = False) -> torch.Tensor:
    """Normative inverse (§8.6.4.2): coefficients -> residual (int32)."""
    s = coeff.shape[-1]
    t = matrix(s, coeff.device, is_dst)
    g = ((_mm(t.T, coeff.long()) + 64) >> 7).clamp(-32768, 32767)
    s2 = 20 - bit_depth
    r = (_mm(g, t) + (1 << (s2 - 1))) >> s2
    return r.clamp(-32768, 32767).int()


def quant_params(qp: int, log2_size: int, bit_depth: int = 8,
                 is_intra_slice: bool = True) -> tuple[int, int, int]:
    """(scale, add, qbits) of HM's quantiser (xQuant, flat scaling)."""
    qp = qp + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    qbits = 14 + per + MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    return int(QUANT_SCALES[rem]), add, qbits


def dequant_params(qp: int, log2_size: int, bit_depth: int = 8
                   ) -> tuple[int, int]:
    """(scale, shift) of the int32 dequantiser: shift > 0 is a rounded
    right shift, shift <= 0 a left shift by -shift (`transforms.py:193`)."""
    qp = qp + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    bdshift = bit_depth + log2_size - 5
    return 16 * int(INV_QUANT_SCALES[rem]), bdshift - per


def quantize(coeff: torch.Tensor, qp: int, log2_size: int, bit_depth: int = 8,
             is_intra_slice: bool = True) -> torch.Tensor:
    scale, add, qbits = quant_params(qp, log2_size, bit_depth, is_intra_slice)
    c = coeff.long()
    level = (c.abs() * scale + add) >> qbits
    return (torch.sign(c) * level).clamp(-32768, 32767).int()


def dequantize(level: torch.Tensor, qp: int, log2_size: int,
               bit_depth: int = 8) -> torch.Tensor:
    scale, sh = dequant_params(qp, log2_size, bit_depth)
    x = level.long() * scale
    d = (x + (1 << (sh - 1))) >> sh if sh > 0 else x << -sh
    return d.clamp(-32768, 32767).int()


def rdoq_consts(qp: int, log2_size: int, bit_depth: int = 8) -> dict:
    """The scalars of `rdoq_est`: the float scale, 2^qbits, its reciprocal,
    and the float32 reciprocal of the residual-domain error denominator
    scale * 2^tshift."""
    qpe = qp + 6 * (bit_depth - 8)
    per, rem = qpe // 6, qpe % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = 14 + per + tshift
    scale = float(QUANT_SCALES[rem])
    err_den = scale * (1 << tshift)
    return dict(scale=scale, qdiv=float(1 << qbits), inv_qdiv=2.0 ** -qbits,
                inv_den=float(np.float32(1.0) / np.float32(err_den)))


def _sum_cg(x: torch.Tensor, cgw: int) -> torch.Tensor:
    """(N, S, S) float32 -> (N, cgw, cgw) per-CG sums, taken in raster
    order inside the CG one add at a time (the kernel's order)."""
    g = x.reshape(x.shape[0], cgw, 4, cgw, 4)
    acc = g[:, :, 0, :, 0]
    for e in range(1, 16):
        acc = acc + g[:, :, e >> 2, :, e & 3]
    return acc


def rdoq_est(coeff: torch.Tensor, qp: int, log2_size: int, bit_depth: int,
             lam: float, est) -> torch.Tensor:
    """Table-cost RDOQ (`rdoq_est_xp` with jnp): (N, S, S) int32
    coefficients -> int32 levels, in float32. `est` is an
    `entropy.bitest.EstTables`; `lam` the full lambda (a Python float,
    rounded to float32 where it meets a tensor, as JAX does).

    Every elementwise float32 operation is the reference's, in its order,
    with the divisions by constants taken as XLA takes them: products with
    the float32 reciprocal (exact for 2^qbits). The per-CG sums are
    sequential in raster order inside the CG. XLA also contracts
    `d * d + lam * b` into an FMA, which the port does not, so a level can
    differ from JAX's where two costs lie within an ulp."""
    k = rdoq_consts(qp, log2_size, bit_depth)
    qdiv, inv_den = k["qdiv"], k["inv_den"]
    S = 1 << log2_size
    cgw = max(1, S >> 2)
    n = coeff.shape[0]
    ac = coeff.abs().float() * k["scale"]
    lmax = torch.ceil(ac * k["inv_qdiv"])
    s0 = est.sig_bits[0, :, :, 0][None]
    s1 = est.sig_bits[0, :, :, 1][None]
    cg0 = torch.zeros((1, S, S), dtype=torch.bool, device=coeff.device)
    cg0[:, :4, :4] = True
    g1, g10 = est.gt1_bits, est.gt1_bits0
    g2, g20 = est.gt2_bits, est.gt2_bits0
    gt1_0 = torch.where(cg0, g10[0], g1[0])
    gt1_1 = torch.where(cg0, g10[1], g1[1])
    gt2_0 = torch.where(cg0, g20[0], g2[0])
    gt2_1 = torch.where(cg0, g20[1], g2[1])
    cg_max = lmax.reshape(n, cgw, 4, cgw, 4).amax(dim=4).amax(dim=2)
    rice_i = up4(rice_param(cg_max))
    rice = rice_i.float()
    ricef = (1 << rice_i).float()
    zero = torch.zeros((), dtype=torch.float32, device=coeff.device)

    def lvl_bits(level):
        rem_ = torch.clamp(level - 3.0, min=0.0)
        three = 3 * ricef
        q = torch.clamp(rem_ - three, min=0.0).long()
        ext = bit_length_minus1((q >> rice_i) + 1).float()
        rl = torch.where(rem_ < three,
                         torch.floor(rem_ / ricef) + 1.0 + rice,
                         4.0 + rice + 2.0 * ext)
        inner = torch.where(level > 2.0, gt2_1 - gt2_0 + rl, zero)
        return s1 + 1.0 + gt1_0 + torch.where(level > 1.0,
                                              gt1_1 - gt1_0 + gt2_0 + inner,
                                              zero)

    def cost(level):
        d = (ac - level * qdiv) * inv_den
        bits = torch.where(level > 0, lvl_bits(level), s0 + 0.0 * level)
        return d * d + lam * bits

    l1 = torch.clamp(lmax, min=0.0)
    l2 = torch.clamp(lmax - 1.0, min=0.0)
    best = torch.where(cost(l1) <= cost(l2), l1, l2)
    best = torch.where(cost(best) <= cost(torch.zeros_like(best)), best, zero)
    if S > 4:
        dz = (ac - best * qdiv) * inv_den
        keep_bits = torch.where(best > 0, lvl_bits(best), s0 + 0.0 * best)
        ck = _sum_cg(dz * dz + lam * keep_bits, cgw)
        acn = ac * inv_den
        cz = _sum_cg(acn * acn, cgw)
        csbf = est.csbf_host
        keep = (ck + lam * float(csbf[0, 1])
                <= cz + lam * float(csbf[0, 0]))
        best = torch.where(up4(keep), best, zero)
    lvl = torch.sign(coeff).float() * best
    return lvl.clamp(-32767, 32767).int()



# --- numpy host core (the coding walks, the decoder) -----------------------
# Copied from the reference's numpy branches; the host side stays numpy.

def _matrix(size: int, is_dst: bool) -> np.ndarray:
    return DST4 if is_dst else dct_matrix(size)


# --- numpy exact core ------------------------------------------------------

def forward_transform_np(resi: np.ndarray, bit_depth: int = 8, is_dst: bool = False) -> np.ndarray:
    """(N, S, S) residual -> (N, S, S) transform coefficients [y][x]."""
    n, s, _ = resi.shape
    log2 = s.bit_length() - 1
    t = _matrix(s, is_dst).astype(np.int64)
    s1 = log2 + bit_depth - 9
    s2 = log2 + 6
    r = resi.astype(np.int64)
    h = (r @ t.T + (1 << (s1 - 1))) >> s1          # horizontal stage
    c = (t @ h + (1 << (s2 - 1))) >> s2            # vertical stage
    return c.astype(np.int32)


def inverse_transform_np(coeff: np.ndarray, bit_depth: int = 8, is_dst: bool = False) -> np.ndarray:
    """Normative inverse (§8.6.4.2): (N, S, S) coeffs -> residual."""
    n, s, _ = coeff.shape
    t = _matrix(s, is_dst).astype(np.int64)
    c = coeff.astype(np.int64)
    g = (t.T @ c + 64) >> 7                        # vertical inverse
    g = np.clip(g, -32768, 32767)
    s2 = 20 - bit_depth
    r = (g @ t + (1 << (s2 - 1))) >> s2            # horizontal inverse
    return np.clip(r, -32768, 32767).astype(np.int32)


def quantize_np(
    coeff: np.ndarray, qp: int, log2_size: int, bit_depth: int = 8,
    is_intra_slice: bool = True, m: np.ndarray | None = None,
) -> np.ndarray:
    """HM's scalar quantizer with its rounding offsets (non-normative side).
    qp is the display-range QP; Qp' = qp + QpBdOffset is applied here.
    m: (S, S) scaling-list factors (TComTrQuant::xSetScalingListEnc:
    quantcoeff = (quantScales << 4) / m; flat m = 16 reduces exactly)."""
    qp = qp + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = 14 + per + tshift
    add = (171 if is_intra_slice else 85) << (qbits - 9)
    c = coeff.astype(np.int64)
    if m is None:
        scale = int(QUANT_SCALES[rem])
        level = (np.abs(c) * scale + add) >> qbits
    else:
        qc = (int(QUANT_SCALES[rem]) << 4) // m.astype(np.int64)
        level = (np.abs(c) * qc + add) >> qbits
    return np.clip(np.sign(c) * level, -32768, 32767).astype(np.int32)


def dequantize_np(level: np.ndarray, qp: int, log2_size: int, bit_depth: int = 8,
                  m: np.ndarray | None = None) -> np.ndarray:
    """Normative scaling process (§8.6.3). m: (S, S) scaling-list factors
    (None = flat 16). qp is the display-range QP; Qp' = qp + QpBdOffset
    is applied here."""
    qp = qp + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    bdshift = bit_depth + log2_size - 5
    if m is None:
        scale = (16 * int(INV_QUANT_SCALES[rem])) << per
        d = (level.astype(np.int64) * scale
             + (1 << (bdshift - 1))) >> bdshift
    else:
        scale = (m.astype(np.int64) * int(INV_QUANT_SCALES[rem])) << per
        d = (level.astype(np.int64) * scale
             + (1 << (bdshift - 1))) >> bdshift
    return np.clip(d, -32768, 32767).astype(np.int32)


# --- scaling lists (§7.4.5 Table 7-5/7-6; TComScalingList defaults) ---------

_SL_8x8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32).reshape(8, 8)

_SL_8x8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32).reshape(8, 8)


def default_scaling_matrix(log2_size: int, is_intra: bool) -> np.ndarray:
    """Default scaling-list factors m (S, S) (§7.4.5: 4x4 flat 16; 8x8
    from Table 7-6; 16/32 by 2x/4x nearest upsampling with the DC
    coefficient replaced by the default scaling_list_dc = 16)."""
    if log2_size == 2:
        return np.full((4, 4), 16, np.int32)
    base = _SL_8x8_INTRA if is_intra else _SL_8x8_INTER
    f = 1 << (log2_size - 3)
    m = np.repeat(np.repeat(base, f, 0), f, 1)
    if f > 1:
        m[0, 0] = 16  # scaling_list_dc_coef default
    return m


def ideal_levels_np(coeff: np.ndarray, qp: int, log2_size: int,
                    bit_depth: int = 8) -> np.ndarray:
    """Real-valued SIGNED coef*scale/2^qbits (the quantizer's
    pre-rounding value) — the reference point for SBH's minimal-damage
    adjustment (magnitude) and the sign of newly created coefficients."""
    qp = qp + 6 * (bit_depth - 8)
    per, rem = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = 14 + per + tshift
    return coeff.astype(np.float64) * int(QUANT_SCALES[rem]) / (1 << qbits)


def rdoq_np(coeff: np.ndarray, qp: int, log2_size: int, bit_depth: int = 8,
            lam_fp256: int = 256, is_intra_slice: bool = False,
            scan: np.ndarray | None = None) -> np.ndarray:
    """Rate-distortion optimized quantization, vectorized approximation of
    TComTrQuant::xRateDistOptQuant (TComTrQuant.cpp:2129, SURVEY.md §A.1):

    - per-coefficient level choice among {ceil, ceil-1, 0} by
      distortion + lambda*bits with the quantizer's true error scale
      (running CABAC context state replaced by a Golomb-ish bit proxy,
      which keeps the decision vectorizable over whole batches);
    - per-4x4-CG all-zero trial (the dominant tail-trimming effect of the
      reference's CG loop + last-position search).

    coeff: (..., S, S). lam_fp256: lambda in 8.8 fixed point.
    Returns int32 levels.
    """
    qpe = qp + 6 * (bit_depth - 8)
    per, rem = qpe // 6, qpe % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = 14 + per + tshift
    scale = float(QUANT_SCALES[rem])
    # 1.5x: the Golomb-ish proxy underestimates context-coded bits
    lam = 1.5 * lam_fp256 / 256.0  # FULL lambda (not the sqrt ME one)
    c = coeff.astype(np.float64)
    ac = np.abs(c) * scale  # lLevelDouble
    lmax = np.ceil(ac / (1 << qbits)).astype(np.int64)
    # residual-domain error of level l: (ac - l*2^qbits) / (scale*2^tshift)
    err_den = scale * (1 << tshift)

    def cost(l):
        d = (ac - l * float(1 << qbits)) / err_den
        bits = np.where(l > 0, 2 * np.floor(np.log2(np.maximum(l, 1)))
                        + 3 + 1, 0.0)  # golomb-ish + sign
        return d * d + lam * bits

    l1 = np.maximum(lmax, 0)
    l2 = np.maximum(lmax - 1, 0)
    best = np.where(cost(l1) <= cost(l2), l1, l2)
    best = np.where(cost(best) <= cost(np.zeros_like(best)), best, 0)

    # per-CG zero trial
    s = 1 << log2_size
    shp = best.shape
    b4 = best.reshape(-1, s // 4, 4, s // 4, 4)
    c4 = (ac / err_den).reshape(-1, s // 4, 4, s // 4, 4)
    dz = (ac - best * float(1 << qbits)) / err_den
    dz2 = (dz * dz).reshape(-1, s // 4, 4, s // 4, 4).sum((2, 4))
    z2 = (c4 * c4).sum((2, 4))  # distortion of all-zero CG
    bits_cg = np.where(
        b4 > 0, 2 * np.floor(np.log2(np.maximum(b4, 1))) + 4, 0.0
    ).sum((2, 4)) + 4.0  # + sig-CG flag-ish overhead
    keep = dz2 + lam * bits_cg <= z2 + lam * 1.0
    best = np.where(np.repeat(np.repeat(keep, 4, 1), 4, 2)
                    .reshape(-1, s, s).reshape(shp), best, 0)
    lvl = np.sign(c) * best
    return np.clip(lvl, -32768, 32767).astype(np.int32)


def rdoq_est_np(coeff, qp: int, log2_size: int, bit_depth: int,
                lam: float, est):
    """Table-cost RDOQ on (N, S, S) coefficient tiles in float64: the
    numpy branch of the reference's `rdoq_est_xp`, which the native C++
    walk (native/intra_walk.cpp quantTB) mirrors exactly.

    The per-coefficient level choice among {ceil, ceil-1, 0} uses the
    quantizer's true error scale plus estBitsSbac-style FRACTIONAL-BIT
    TABLE costs (TComTrQuant::xGetCodedLevel + getSigCtxInc semantics,
    reference TComTrQuant.cpp:2129-2510): position-dependent significance
    contexts, gt1/gt2 with the CG0 vs later context sets, Golomb-Rice
    remainder with the per-CG Rice stand-in, and the sign bit. Then the
    per-4x4-CG all-zero trial against the coded-sub-block flag. The
    running c1/c2 walk is approximated by the c1=1 states and the
    last-position walk-back is left to the caller's whole-TU compare --
    the same approximation the device inter path (codec/inter_grid.py
    rdoq_plane) uses, lifted here so the intra paths share it instead of
    the Golomb-proxy + 1.5x fudge of rdoq_np.

    est: entropy.bitest.ResidualBitEst for (slice init row, qp', log2).
    lam: FULL lambda (float). Returns int32 levels shaped like coeff.
    """
    qpe = qp + 6 * (bit_depth - 8)
    per, rem = qpe // 6, qpe % 6
    tshift = MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qbits = 14 + per + tshift
    scale = float(QUANT_SCALES[rem])
    fdt = np.float64
    ac = np.abs(coeff).astype(fdt) * scale
    lmax = np.ceil(ac / (1 << qbits)).astype(fdt)
    err_den = scale * (1 << tshift)
    S = 1 << log2_size
    cgw = max(1, S >> 2)

    s_tab = est.sig_bits[0]                      # (S, S, 2), prev csbf 0
    s0 = s_tab[:, :, 0][None]
    s1 = s_tab[:, :, 1][None]
    is_cg0 = np.zeros((1, cgw, cgw), np.float64)
    is_cg0[0, 0, 0] = 1.0
    if S <= 4:
        is_cg0 = np.ones((1, 1, 1), is_cg0.dtype)

    def cg_up(m):                                # (N,cgw,cgw)->(N,S,S)
        return np.repeat(np.repeat(m, 4, axis=1), 4, axis=2) \
            if S > 4 else m

    g1, g10 = est.gt1_bits, est.gt1_bits0
    g2, g20 = est.gt2_bits, est.gt2_bits0
    cg0p = cg_up(is_cg0)
    gt1_0 = np.where(cg0p > 0, float(g10[0]), float(g1[0]))
    gt1_1 = np.where(cg0p > 0, float(g10[1]), float(g1[1]))
    gt2_0 = np.where(cg0p > 0, float(g20[0]), float(g2[0]))
    gt2_1 = np.where(cg0p > 0, float(g20[1]), float(g2[1]))
    # per-CG Rice parameter from the ceiling levels (stand-in for the
    # running adaptation, identical to the device inter path)
    if S > 4:
        cg_max = cg_up(np.max(lmax.reshape(-1, cgw, 4, cgw, 4),
                              axis=(2, 4)))
    else:
        cg_max = np.max(lmax, axis=(1, 2), keepdims=True)
    rice = np.clip(np.where(cg_max > 6.0,
                            np.log2(np.maximum(cg_max, 1.0) / 3.0), 0.0),
                   0, 4).astype(np.int32)
    ricef = np.exp2(rice.astype(fdt))

    def lvl_bits(level):
        rem_ = np.maximum(level - 3.0, 0.0)
        three = (3 * ricef)
        rl = np.where(rem_ < three, np.floor(rem_ / ricef) + 1.0
                      + rice.astype(fdt),
                      4.0 + rice.astype(fdt) + 2.0 * np.floor(
                          np.log2(np.maximum(rem_ - three, 0.0)
                                  / ricef + 1.0)))
        return (s1 + 1.0 + gt1_0
                + np.where(level > 1.0,
                           gt1_1 - gt1_0 + gt2_0
                           + np.where(level > 2.0,
                                      gt2_1 - gt2_0 + rl, 0.0), 0.0))

    def cost(level):
        d = (ac - level * float(1 << qbits)) / err_den
        bits = np.where(level > 0, lvl_bits(level), s0 + 0.0 * level)
        return d * d + lam * bits

    l1 = np.maximum(lmax, 0.0)
    l2 = np.maximum(lmax - 1.0, 0.0)
    best = np.where(cost(l1) <= cost(l2), l1, l2)
    best = np.where(cost(best) <= cost(np.zeros_like(best)), best, 0.0)

    # per-CG all-zero trial vs the coded-sub-block flag
    csbf = est.csbf_bits
    dz = (ac - best * float(1 << qbits)) / err_den
    keep_bits = np.where(best > 0, lvl_bits(best), s0 + 0.0 * best)
    if S > 4:
        ck = (dz * dz + lam * keep_bits).reshape(
            -1, cgw, 4, cgw, 4).sum((2, 4))
        acn = ac / err_den
        cz = (acn * acn).reshape(-1, cgw, 4, cgw, 4).sum((2, 4))
        keep = (ck + lam * float(csbf[0, 1])
                <= cz + lam * float(csbf[0, 0]))
        best = np.where(cg_up(keep), best, 0.0)
    lim = 32767
    return np.clip(np.sign(coeff).astype(fdt) * best,
                   -lim, lim).astype(np.int32)
