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

from tpuhevc.utils.tables import (
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

