"""HEVC core transform and scalar quantiser on torch tensors.

Twin of `tpuhevc/ops/transforms.py:144-198` (`forward_transform`,
`inverse_transform`, `quantize`, `dequantize`): the same shifts, rounding
and clips, on (..., S, S) int32 tensors. The products are taken in int64
as broadcast-multiply-sum, which is exact on the CPU and on CUDA alike
(torch has no integer matmul on CUDA, and fp32/TF32 would round the
second stage); every stage sum stays below 2^28, so the int32 results
equal the JAX variant's int32 arithmetic. These are the plain versions
that the fused TU kernel (`ops/txq.py`) is held against.
"""

from __future__ import annotations

import torch

from tpuhevc.utils.tables import (
    INV_QUANT_SCALES,
    MAX_TR_DYNAMIC_RANGE,
    QUANT_SCALES,
    dct_matrix,
)

_MATS: dict = {}


def matrix(size: int, device) -> torch.Tensor:
    """The size x size HEVC DCT-II matrix as an int64 tensor on `device`."""
    key = (size, str(device))
    t = _MATS.get(key)
    if t is None:
        t = torch.as_tensor(dct_matrix(size), dtype=torch.int64, device=device)
        _MATS[key] = t
    return t


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b over the last two dims (int64)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def forward_transform(resi: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """(..., S, S) residual -> coefficients [y][x] (int32)."""
    s = resi.shape[-1]
    log2 = s.bit_length() - 1
    t = matrix(s, resi.device)
    s1 = log2 + bit_depth - 9
    s2 = log2 + 6
    h = (_mm(resi.long(), t.T) + (1 << (s1 - 1))) >> s1
    c = (_mm(t, h) + (1 << (s2 - 1))) >> s2
    return c.int()


def inverse_transform(coeff: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """Normative inverse (§8.6.4.2): coefficients -> residual (int32)."""
    s = coeff.shape[-1]
    t = matrix(s, coeff.device)
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
