"""Table bit estimate of residual TUs (kernel `tu_bits`).

Twin of `tpuhevc/entropy/bitest.py:286-378` (`ResidualBitEst.tu_bits`,
sbh=False) and of `_rice_bits_xp` (`bitest.py:398-408`): per TU of
levels, the last-position bits, the coded-sub-block flags with their
right/below context, the significance flags by prev-CSBF pattern, the
gt1/gt2 bins of each CG, the Golomb-Rice remainders with the CG-max Rice
stand-in, and one sign bit per nonzero level.

The estimator's tables come in as tensors (`EstTables`), built from the
fields of a `tpuhevc.entropy.bitest.ResidualBitEst`; the kernel reads
them from device memory, so live tables (an `EstView`) can take the same
entry point.

Numbers: each of the five partial sums is taken exactly (float64; every
table value is a multiple of 2^-15, so the sums are exact in any order)
and rounded to float32 once, then added in float32 in the reference's
order. JAX sums in float32, which is exact too while a partial sum stays
below 2^9 bits; above that the two differ by a few ulps. The Rice
parameter and the escape length are exact integer formulas (XLA's float
log2 rounds below 13 and 15 at 2^13 and 2^15, where JAX and the port
differ; levels that large do not occur at the QPs the decision runs at).

`tu_bits_plain` is the PyTorch version; `tu_bits` launches the CUDA
kernel (`kernels/csrc/tu_bits.cu`) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuhevc.entropy.bitest import ResidualBitEst

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

_TABLES: dict = {}


def _ioffsets(S: int) -> dict:
    """Offsets (int32 words) of the integer tables in `EstTables.itab`."""
    n = S * S
    cgw = max(1, S >> 2)
    return dict(scan_pos=0, scan_x=n, scan_y=2 * n, cg_scan=3 * n,
                group_idx=3 * n + cgw * cgw, end=3 * n + cgw * cgw + 32)


def _foffsets(S: int) -> dict:
    """Offsets (float32 words) of the cost tables in `EstTables.ftab`."""
    n = 8 * S * S
    return dict(sig_bits=0, csbf_bits=n, gt1_bits=n + 4, gt1_bits0=n + 6,
                gt2_bits=n + 8, gt2_bits0=n + 10, lastx_bits=n + 12,
                lasty_bits=n + 28, end=n + 44)


class EstTables:
    """A ResidualBitEst's tables on one device: `itab` (int32: scan
    positions, last-position gather, CG scan grid, group index) and
    `ftab` (float32: the COST_FIELDS), packed at `_ioffsets` /
    `_foffsets`, plus views of both for the plain version."""

    def __init__(self, est, device):
        S = est.S
        self.S, self.log2, self.is_luma = S, est.log2, est.is_luma
        self.cgw = max(1, S >> 2)
        io, fo = _ioffsets(S), _foffsets(S)
        itab = np.zeros(io["end"], np.int32)
        for k in ("scan_pos", "scan_x", "scan_y", "cg_scan", "group_idx"):
            v = np.asarray(getattr(est, k), np.int32).ravel()
            itab[io[k] : io[k] + v.size] = v
        ftab = np.zeros(fo["end"], np.float32)
        for k in ResidualBitEst.COST_FIELDS:
            v = np.asarray(getattr(est, k), np.float32).ravel()
            ftab[fo[k] : fo[k] + v.size] = v
        self.csbf_host = np.asarray(est.csbf_bits, np.float32).reshape(2, 2)
        self.itab = torch.as_tensor(itab, device=device)
        self.ftab = torch.as_tensor(ftab, device=device)
        i, f = self.itab.long(), self.ftab
        n, cgw = S * S, self.cgw
        self.scan_pos = i[: n].reshape(S, S)
        self.scan_x = i[n : 2 * n]
        self.scan_y = i[2 * n : 3 * n]
        self.cg_scan = i[io["cg_scan"] : io["cg_scan"] + cgw * cgw].reshape(
            cgw, cgw)
        self.group_idx = i[io["group_idx"] : io["group_idx"] + 32]
        self.sig_bits = f[: 8 * n].reshape(4, S, S, 2)
        self.csbf_bits = f[fo["csbf_bits"] : fo["csbf_bits"] + 4].reshape(2, 2)
        for k in ("gt1_bits", "gt1_bits0", "gt2_bits", "gt2_bits0"):
            setattr(self, k, f[fo[k] : fo[k] + 2])
        self.lastx_bits = f[fo["lastx_bits"] : fo["lastx_bits"] + 16]
        self.lasty_bits = f[fo["lasty_bits"] : fo["lasty_bits"] + 16]


def est_tables(fb, log2: int, is_luma: bool, device) -> EstTables:
    """EstTables of `ResidualBitEst(fb, log2, is_luma)` on `device`
    (cached per estimator and device)."""
    est = ResidualBitEst(fb, log2, is_luma)
    key = (id(est), str(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not est:
        hit = (est, EstTables(est, device))
        _TABLES[key] = hit
    return hit[1]


def up4(m: torch.Tensor) -> torch.Tensor:
    """(N, cgw, cgw) per-CG values -> (N, 4 cgw, 4 cgw) per coefficient."""
    return m.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)


def bit_length_minus1(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) of an integer tensor v in [1, 2^17), exactly."""
    out = torch.zeros_like(v)
    for j in range(1, 17):
        out = out + (v >= (1 << j)).to(v.dtype)
    return out


def rice_param(cg_max: torch.Tensor) -> torch.Tensor:
    """The per-CG Rice stand-in clip(log2(cg_max / 3), 0, 4) (0 unless
    cg_max > 6), as the largest k <= 4 with 3 * 2^k <= cg_max. cg_max is
    integer-valued (an int or float tensor); returns int64."""
    c = cg_max.to(torch.float64)
    k = torch.zeros(c.shape, dtype=torch.int64, device=c.device)
    for j in range(1, 5):
        k = k + (c >= float(3 << j)).long()
    return torch.where(c > 6.0, k, torch.zeros_like(k))


def rice_bits(rem: torch.Tensor, rice: torch.Tensor) -> torch.Tensor:
    """`_rice_bits_xp`: Golomb-Rice length of rem >= 0 with parameter rice
    (int64 in, int64 out; the escape's floor(log2) exact)."""
    rem = rem.long()
    three = 3 << rice
    len_small = (rem >> rice) + 1 + rice
    r2 = (rem - three).clamp(min=0)
    ext = bit_length_minus1((r2 >> rice) + 1)
    return torch.where(rem < three, len_small, 4 + 2 * ext + rice)


def _xsum(t: torch.Tensor) -> torch.Tensor:
    """(N, a, b) float32 -> (N,) exact sum rounded once to float32."""
    return t.double().sum(dim=(1, 2)).float()


def tu_bits_plain(est: EstTables, tiles: torch.Tensor) -> torch.Tensor:
    """tiles (N, S, S) int levels -> (N,) float32 bits; all-zero tiles 0."""
    S, cgw = est.S, est.cgw
    n = tiles.shape[0]
    dev = tiles.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    a = tiles.long().abs()
    nz = a > 0
    sp = est.scan_pos
    last = torch.where(nz, sp[None], torch.full_like(a, -1)).reshape(
        n, -1).amax(dim=1)
    has = last >= 0
    lastc = last.clamp(min=0)
    gi = est.group_idx
    bits = (est.lastx_bits[gi[est.scan_x[lastc]]]
            + est.lasty_bits[gi[est.scan_y[lastc]]])

    acg = a.reshape(n, cgw, 4, cgw, 4)
    csbf = acg.sum(dim=(2, 4)) > 0
    cgs = est.cg_scan[None]
    last_cg = (lastc >> 4)[:, None, None]
    csbf_coded = (cgs > 0) & (cgs < last_cg)
    right = torch.zeros_like(csbf)
    right[:, :, :-1] = csbf[:, :, 1:]
    below = torch.zeros_like(csbf)
    below[:, :-1, :] = csbf[:, 1:, :]
    nb = (right | below).long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cb = est.csbf_bits[nb, csbf.long()]
    bits = bits + _xsum(torch.where(csbf_coded, cb, zero))

    cg_sig_on = csbf | (cgs == 0) | (cgs == last_cg)
    coded = (sp[None] < last[:, None, None]) & up4(cg_sig_on)
    prev_pix = up4(right.long() + 2 * below.long())
    yy = torch.arange(S, device=dev)[None, :, None]
    xx = torch.arange(S, device=dev)[None, None, :]
    sb = est.sig_bits[prev_pix, yy, xx, nz.long()]
    bits = bits + _xsum(torch.where(coded, sb, zero))

    n_sig = nz.reshape(n, cgw, 4, cgw, 4).sum(dim=(2, 4))
    n_gt1 = (a > 1).reshape(n, cgw, 4, cgw, 4).sum(dim=(2, 4))
    any_gt2 = (a > 2).reshape(n, cgw, 4, cgw, 4).any(dim=4).any(dim=2)
    bins1 = n_sig.clamp(max=8)
    ones1 = torch.minimum(n_gt1, bins1)
    is_cg0 = cgs == 0
    g1, g10 = est.gt1_bits, est.gt1_bits0
    g2, g20 = est.gt2_bits, est.gt2_bits0
    b1 = (torch.where(is_cg0, g10[1], g1[1]) * ones1.float()
          + torch.where(is_cg0, g10[0], g1[0]) * (bins1 - ones1).float())
    b2 = torch.where(n_gt1 > 0,
                     torch.where(is_cg0, torch.where(any_gt2, g20[1], g20[0]),
                                 torch.where(any_gt2, g2[1], g2[0])), zero)
    bits = bits + _xsum(b1 + b2)

    rice = up4(rice_param(acg.amax(dim=4).amax(dim=2)))
    rem = (a - 2).clamp(min=0)
    rb = torch.where(rem > 0, rice_bits(rem, rice), torch.zeros_like(rem))
    bits = bits + rb.sum(dim=(1, 2)).float()
    bits = bits + n_sig.sum(dim=(1, 2)).float()
    return torch.where(has, bits, zero)


def tu_bits(est: EstTables, tiles: torch.Tensor) -> torch.Tensor:
    """Kernel `tu_bits`. CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if tiles.device.type == "cpu":
        return tu_bits_plain(est, tiles)
    if tiles.device.type != "cuda":
        raise ValueError(f"tu_bits: unsupported device {tiles.device}")
    dev = tiles.device
    check_tensor(tiles, "tiles", torch.int32, 3, dev)
    check_tensor(est.itab, "est.itab", torch.int32, 1, dev)
    check_tensor(est.ftab, "est.ftab", torch.float32, 1, dev)
    n, S = tiles.shape[0], est.S
    if tuple(tiles.shape[1:]) != (S, S):
        raise ValueError(f"tu_bits: tiles {tuple(tiles.shape)} for a "
                         f"{S}x{S} estimator")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = kbuild.function("tu_bits", "tpuhevc_tu_bits",
                         [kbuild.P] * 4 + [kbuild.I] * 2 + [kbuild.P])
    err = fn(tiles.data_ptr(), est.itab.data_ptr(), est.ftab.data_ptr(),
             out.data_ptr(), n, est.log2,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "tu_bits")
    LAUNCHES["tu_bits"] += 1
    return out
