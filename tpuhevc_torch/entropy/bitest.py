"""Table bit estimate of residual TUs (kernel `tu_bits`).

Twin of `tpuhevc/entropy/bitest.py:286-378` (`ResidualBitEst.tu_bits`,
sbh=False) and of `_rice_bits_xp` (`bitest.py:398-408`): per TU of
levels, the last-position bits, the coded-sub-block flags with their
right/below context, the significance flags by prev-CSBF pattern, the
gt1/gt2 bins of each CG, the Golomb-Rice remainders with the CG-max Rice
stand-in, and one sign bit per nonzero level.

The estimator's tables come in as tensors (`EstTables`), built from the
fields of a `ResidualBitEst` (the host estimator, a copy of the
reference's, in the first half of this module); the kernel reads them
from device memory, so tables built from live context states take the
same entry point.

Numbers: each of the five partial sums is taken exactly and rounded to
float32 once, then added in float32 in the reference's order. Every
table value the sums take is one ENTROPY_BITS entry, a multiple of
2^-15, so the sums are exact in any order: float64 here, int32 in units
of 2^-15 in the kernel (checked at import below). JAX sums in float32,
which is exact too while a partial sum stays below 2^9 bits; above that
the two differ by a few ulps. The Rice parameter and the escape length
are exact integer formulas (XLA's float log2 rounds below 13 and 15 at
2^13 and 2^15, where JAX and the port differ; levels that large do not
occur at the QPs the decision runs at).

`tu_bits_plain` is the PyTorch version; `tu_bits` launches the CUDA
kernel (`kernels/csrc/tu_bits.cu`) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import GROUP_IDX, SCAN_DIAG, SIG_CTX_MAP_4x4, scan_order
from .cabac import CTX_OFFSET, ContextSet
from .ctx_tables import ENTROPY_BITS

# --- host estimator tables (numpy; copied from the reference) ---------------

_B = ENTROPY_BITS.astype(np.float64) / 32768.0  # bits per (state ^ bin)

# The kernel sums a TU's csbf, sig and gt1/gt2 costs, each one entry of
# _B, as int32 in units of 2^-15: exact while 32 x 32 of the largest stay
# below 2^31 (the worst case is one sig bin a position of a 32x32 TU).
if 1024 * int(ENTROPY_BITS.max()) >= 1 << 31:
    raise ImportError("ENTROPY_BITS: tu_bits' int32 sums could overflow")

_SIG_IDX_CACHE: dict = {}  # (log2, is_luma) -> sig ctx index map


def _eg_bits(u: np.ndarray, k: int) -> np.ndarray:
    """Exp-Golomb order-k code length of u >= 0 (vectorized, float)."""
    q = np.floor(np.log2((u.astype(np.float64) / (1 << k)) + 1.0))
    return 2.0 * q + 1.0 + k


# Golomb-Rice + escape length as coded by _encode_remaining
# (entropy/residual.py:250, TComTrQuant xWriteCoefRemainExGolomb parity)
def _rice_bits(rem: np.ndarray, rice: np.ndarray) -> np.ndarray:
    rem = rem.astype(np.int64)
    small = rem < (3 << rice)
    len_small = (rem >> np.maximum(rice, 0)) + 1 + rice
    # escape: prefix (3) + unary length extension + suffix
    r2 = np.maximum(rem - (3 << rice), 0)
    ln = np.maximum(rice, 0).astype(np.int64)
    # find length: smallest L >= rice with sum_{k=rice}^{L-1} 2^k > r2 - ...
    # equivalently L from the escape loop; closed form via log2
    v = r2.astype(np.float64) / np.exp2(rice.astype(np.float64)) + 1.0
    ext = np.floor(np.log2(v)).astype(np.int64)
    length = ln + ext
    len_esc = (3 + (length - ln) + 1) + length
    return np.where(small, len_small, len_esc).astype(np.float64)


def _warm_states(ctx: ContextSet, init_row: int, qp: int) -> None:
    """Advance the context states from their init values to a typical
    steady state by coding a small deterministic synthetic corpus
    (quantized-Gaussian residual tiles + mixed mvds) through the exact
    adaptive counter. Init states alone overestimate steady-state costs
    (most visibly sparse significance maps); HM sidesteps this by loading
    live coder states into its estimator per CU (TEncCu RD snapshots) —
    a static warm snapshot is the table-only equivalent."""
    from ..ops import transforms as tx
    from .cabac import CabacBitEstimator
    from .residual import encode_residual
    from .syntax import _enc_mvd

    enc = CabacBitEstimator(ctx)
    rng = np.random.default_rng(12345)
    if init_row != 2:  # inter-slice statistics
        for _ in range(2):
            mvds = rng.integers(-24, 25, (24, 2))
            mvds[rng.random(24) < 0.5] = 0
            for d in mvds:
                _enc_mvd(enc, (int(d[0]), int(d[1])))
    amps = (4, 14) if init_row != 2 else (10, 25)
    for S, n in ((8, 12), (16, 8), (32, 4)):
        res = np.concatenate([
            np.clip(np.round(rng.normal(0, amp, (n, S, S))), -255,
                    255).astype(np.int32) for amp in amps])
        lvl = tx.quantize_np(tx.forward_transform_np(res, 8), qp,
                             S.bit_length() - 1, 8, False)
        for t in lvl:
            if t.any():
                encode_residual(enc, t, S.bit_length() - 1, True, SCAN_DIAG)
        # chroma at the same scale but sparser
        resc = np.clip(np.round(rng.normal(0, amps[0] * 0.6,
                                           (n // 2, S, S))),
                       -255, 255).astype(np.int32)
        lvlc = tx.quantize_np(tx.forward_transform_np(resc, 8), qp,
                              S.bit_length() - 1, 8, False)
        for t in lvlc:
            if t.any():
                encode_residual(enc, t, S.bit_length() - 1, False,
                                SCAN_DIAG)


class FracBits:
    """Per-(slice-type-row, QP) fractional-bit tables. bits[c, b] = bits
    to code bin value b in context c at its (warmed) initial state."""

    _cache: dict = {}

    def __new__(cls, init_row: int, qp: int):
        key = (init_row, qp)
        hit = cls._cache.get(key)
        if hit is not None:
            return hit
        self = super().__new__(cls)
        self._build(init_row, qp)
        cls._cache[key] = self
        return self

    @classmethod
    def from_states(cls, init_row: int, qp: int, states) -> "FracBits":
        """Tables at an explicit context-state vector (the end-of-slice
        snapshot of the written stream) instead of the warmed init
        states; not cached, as each snapshot is fresh."""
        self = super().__new__(cls)
        self.init_row, self.qp = init_row, qp
        self.adaptive = True
        self._bind(np.asarray(states, dtype=np.int64))
        return self

    def _build(self, init_row: int, qp: int) -> None:
        self.init_row, self.qp = init_row, qp
        ctx = ContextSet(init_row, qp)
        _warm_states(ctx, init_row, qp)
        self._bind(np.asarray(ctx.states, dtype=np.int64))

    def _bind(self, states: np.ndarray) -> None:
        self.bin_bits = np.stack([_B[states ^ 0], _B[states ^ 1]], axis=1)
        # mvd component bits: abs_mvd_greater0/1 flags (ctx 0/1) + EG1 + sign
        g0, g1 = (self.bin_bits[CTX_OFFSET["abs_mvd_greater_flag"] + i]
                  for i in (0, 1))
        v = np.arange(4096)
        t = np.where(
            v == 0, g0[0],
            np.where(v == 1, g0[1] + g1[0] + 1.0,
                     g0[1] + g1[1] + _eg_bits(np.maximum(v - 2, 0), 1) + 1.0))
        self.mvd_lut = t.astype(np.float32)  # per |component|
        # merge_idx bits for idx 0..4 at max_merge = m
        mi = self.bin_bits[CTX_OFFSET["merge_idx"]]

        def merge_idx_bits(idx: int, max_merge: int) -> float:
            if max_merge <= 1:
                return 0.0
            if idx == 0:
                return float(mi[0])
            b = float(mi[1]) + (idx - 1)  # bypass unary ones
            if idx < max_merge - 1:
                b += 1.0  # terminating bypass zero
            return b

        self.merge_idx_bits = merge_idx_bits
        self.b = lambda name, i, v: float(
            self.bin_bits[CTX_OFFSET[name] + i, v])

    def ref_idx_bits(self, ref: int, num_ref: int) -> float:
        """ref_idx_lX binarization: first two bins ctx-coded, rest bypass."""
        if num_ref <= 1:
            return 0.0
        b = self.b("ref_idx", 0, 1 if ref > 0 else 0)
        if ref > 0 and num_ref > 2 or ref == 1 and num_ref == 2:
            pass
        if ref == 0:
            return b
        if num_ref > 2:
            b += self.b("ref_idx", 1, 1 if ref > 1 else 0)
        if ref > 1:
            b += max(0, ref - 2) + (1.0 if ref < num_ref - 1 else 0.0)
        return b

    def mvd_bits(self, mvd: np.ndarray) -> np.ndarray:
        """(..., 2) quarter-pel mvd -> (...) bits (both components)."""
        a = np.minimum(np.abs(mvd), 4095)
        return self.mvd_lut[a[..., 0]] + self.mvd_lut[a[..., 1]]


class ResidualBitEst:
    """Whole-plane residual-coding bit estimate for square TUs of one
    size, diagonal scan (the inter path's layout). Mirrors
    encode_residual (entropy/residual.py) term by term with init-state
    context costs; the in-CG gt1 context walk and rice adaptation are
    approximated (validated in tests/test_bitest.py)."""

    _cache: dict = {}

    def __new__(cls, fb: FracBits, log2: int, is_luma: bool):
        key = (fb.init_row, fb.qp, log2, is_luma)
        if getattr(fb, "adaptive", False):
            self = super().__new__(cls)
            self._build(fb, log2, is_luma)
            return self
        hit = cls._cache.get(key)
        if hit is not None:
            return hit
        self = super().__new__(cls)
        self._build(fb, log2, is_luma)
        cls._cache[key] = self
        return self

    COST_FIELDS = ("sig_bits", "csbf_bits", "gt1_bits", "gt1_bits0",
                   "gt2_bits", "gt2_bits0", "lastx_bits", "lasty_bits")

    def _build(self, fb: FracBits, log2: int, is_luma: bool) -> None:
        S = 1 << log2
        self.S, self.log2, self.is_luma = S, log2, is_luma
        scan = scan_order(log2, SCAN_DIAG)  # scan pos -> raster
        sp = np.empty(S * S, np.int32)
        sp[scan] = np.arange(S * S, dtype=np.int32)
        self.scan_pos = sp.reshape(S, S)  # raster (y, x) -> scan pos
        self.scan = scan

        # last-position bits per (gx) incl. suffix, x and y banks
        off = (3 * (log2 - 2) + ((log2 - 1) >> 2)) if is_luma else 15
        shift = ((log2 + 1) >> 2) if is_luma else (log2 - 2)
        base = CTX_OFFSET["last_sig_xy"]
        cmax = (log2 << 1) - 1
        lx, ly = [], []
        for bank, out in ((0, lx), (30, ly)):
            for g in range(cmax + 1):
                b = sum(fb.bin_bits[base + bank + off + (k >> shift), 1]
                        for k in range(g))
                if g < cmax:
                    b += fb.bin_bits[base + bank + off + (g >> shift), 0]
                if g > 3:
                    b += (g - 2) >> 1  # bypass suffix
                out.append(b)
        self.lastx_bits = np.asarray(lx, np.float32)
        self.lasty_bits = np.asarray(ly, np.float32)
        # raster pos of each scan pos -> (x, y) for the last-pos gather
        self.scan_x = (scan % S).astype(np.int32)
        self.scan_y = (scan // S).astype(np.int32)
        self.group_idx = np.asarray(GROUP_IDX, np.int32)

        # sig ctx bit maps per prev_csbf pattern (0..3): (4, S, S, 2)
        m = _SIG_IDX_CACHE.get((log2, is_luma))
        if m is None:
            sig_base = CTX_OFFSET["sig_coeff_flag"] + (0 if is_luma else 28)
            m = np.zeros((4, S, S), np.int32)
            for p in range(4):
                for y in range(S):
                    for x in range(S):
                        m[p, y, x] = sig_base + _sig_ctx_np(
                            x, y, p, log2, is_luma)
            _SIG_IDX_CACHE[(log2, is_luma)] = m
        self.sig_bits = fb.bin_bits[m].astype(np.float32)  # (4, S, S, 2)

        cs = CTX_OFFSET["sig_cg_flag"] + (0 if is_luma else 2)
        self.csbf_bits = fb.bin_bits[cs : cs + 2].astype(np.float32)
        # gt1 at ctx set 0/2 (first/later CGs), c1=1; gt2 at same sets
        g1 = CTX_OFFSET["coeff_gt1"] + (0 if is_luma else 16)
        g2 = CTX_OFFSET["coeff_gt2"] + (0 if is_luma else 4)
        cset = 2 if is_luma else 0
        self.gt1_bits = fb.bin_bits[g1 + 4 * cset + 1].astype(np.float32)
        self.gt1_bits0 = fb.bin_bits[g1 + 1].astype(np.float32)  # CG0 set
        self.gt2_bits = fb.bin_bits[g2 + cset].astype(np.float32)
        self.gt2_bits0 = fb.bin_bits[g2].astype(np.float32)
        ncg = max(1, (S * S) >> 4)
        # CG scan index grid: raster CG (yc, xc) -> CG scan order index
        cgw = max(1, S >> 2)
        cgm = np.empty((cgw, cgw), np.int32)
        for cg in range(ncg):
            r = int(scan[cg * 16])
            cgm[(r // S) >> 2, (r % S) >> 2] = cg
        self.cg_scan = cgm
        self.cg_w = cgw

    def tu_bits_np(self, tiles, sbh: bool = False):
        """tiles: (N, S, S) int levels -> (N,) float32 estimated bits.
        All-zero tiles return 0 (the cbf flag itself is the caller's)."""
        S = self.S
        N = tiles.shape[0]
        a = np.abs(tiles)
        nz = a > 0
        sp = np.asarray(self.scan_pos)[None]  # (1, S, S)
        last = np.max(np.where(nz, sp, -1), axis=(1, 2))  # (N,)
        has = last >= 0
        lastc = np.maximum(last, 0)
        # last position bits
        lx = np.asarray(self.scan_x)[lastc]
        ly = np.asarray(self.scan_y)[lastc]
        gi = np.asarray(self.group_idx)
        bits = (np.asarray(self.lastx_bits)[gi[lx]]
                + np.asarray(self.lasty_bits)[gi[ly]])

        # CG layout
        cgw = self.cg_w
        acg = a.reshape(N, cgw, 4, cgw, 4)
        csbf = (acg.sum((2, 4)) > 0)  # (N, cgw, cgw) raster CG grid
        cgs = np.asarray(self.cg_scan)[None]  # CG scan index
        last_cg = lastc >> 4
        # csbf flags coded for 0 < cg_scan < last_cg
        csbf_coded = (cgs > 0) & (cgs < last_cg[:, None, None])
        # neighbor context: right/below csbf
        z = np.zeros((N, cgw, 1), dtype=csbf.dtype)
        zr = np.zeros((N, 1, cgw), dtype=csbf.dtype)
        right = np.concatenate([csbf[:, :, 1:], z], axis=2)
        below = np.concatenate([csbf[:, 1:, :], zr], axis=1)
        cbt = np.asarray(self.csbf_bits)  # (2, 2)
        nb = (right | below).astype(np.int32)
        bits = bits + np.sum(
            np.where(csbf_coded,
                     cbt[nb, csbf.astype(np.int32)], 0.0), axis=(1, 2))

        # significance flags: coded positions in CGs that code sigs
        cg_sig_on = csbf | (cgs == 0) | (cgs == last_cg[:, None, None])
        cg_on_pix = np.repeat(np.repeat(cg_sig_on, 4, axis=1), 4, axis=2)
        coded = (sp < last[:, None, None]) & cg_on_pix
        prev = (right.astype(np.int32)
                + 2 * below.astype(np.int32))  # (N, cgw, cgw)
        prev_pix = np.repeat(np.repeat(prev, 4, axis=1), 4, axis=2)
        sigt = np.asarray(self.sig_bits)  # (4, S, S, 2)
        yy = np.arange(S)[None, :, None]
        xx = np.arange(S)[None, None, :]
        sb = sigt[prev_pix, yy, xx, nz.astype(np.int32)]
        bits = bits + np.sum(np.where(coded, sb, 0.0), axis=(1, 2))

        # per-CG level coding: gt1 (<=8 bins), gt2 (<=1), remainders, signs
        n_sig = nz.reshape(N, cgw, 4, cgw, 4).sum((2, 4))  # (N, cgw, cgw)
        n_gt1 = (a > 1).reshape(N, cgw, 4, cgw, 4).sum((2, 4))
        any_gt2 = (a > 2).reshape(N, cgw, 4, cgw, 4).any((2, 4))
        bins1 = np.minimum(n_sig, 8)
        ones1 = np.minimum(n_gt1, bins1)
        g1t = np.asarray(self.gt1_bits)
        g1t0 = np.asarray(self.gt1_bits0)
        is_cg0 = cgs == 0
        b1 = np.where(is_cg0, g1t0[1], g1t[1]) * ones1 \
            + np.where(is_cg0, g1t0[0], g1t[0]) * (bins1 - ones1)
        g2t = np.asarray(self.gt2_bits)
        g2t0 = np.asarray(self.gt2_bits0)
        b2 = np.where(n_gt1 > 0,
                      np.where(is_cg0,
                               np.where(any_gt2, g2t0[1], g2t0[0]),
                               np.where(any_gt2, g2t[1], g2t[0])), 0.0)
        bits = bits + np.sum(b1 + b2, axis=(1, 2))

        # remainders: base 2 within the first-8 window (3 for the gt2
        # coeff, 1 beyond 8 — approximated by base 2, rice from the CG max)
        cg_max = a.reshape(N, cgw, 4, cgw, 4).max((2, 4))
        rice = np.clip(
            np.where(cg_max > 6, np.log2(np.maximum(cg_max, 1)
                                         .astype(np.float32) / 3.0), 0.0),
            0, 4).astype(np.int32)
        rice_pix = np.repeat(np.repeat(rice, 4, axis=1), 4, axis=2)
        rem = np.maximum(a - 2, 0)
        rb = _rice_bits_np(rem, rice_pix)
        bits = bits + np.sum(np.where(rem > 0, rb, 0.0), axis=(1, 2))

        # signs (SBH hides one per qualifying CG)
        nsign = np.sum(n_sig, axis=(1, 2)).astype(np.float32)
        if sbh:
            # span test per CG: first/last nonzero in-CG scan distance >= 4
            inpos = sp % 16
            big = np.where(nz, inpos, -1).reshape(N, cgw, 4, cgw, 4)
            small = np.where(nz, inpos, 99).reshape(N, cgw, 4, cgw, 4)
            span = big.max((2, 4)) - small.min((2, 4))
            nsign = nsign - np.sum((span >= 4) & (n_sig > 0),
                                   axis=(1, 2)).astype(np.float32)
        bits = bits + nsign
        return np.where(has, bits, 0.0).astype(np.float32)


def _rice_bits_np(rem, rice):
    """float32 twin of _rice_bits (int inputs, float32 out), the numpy
    branch of the reference's `_rice_bits_xp`."""
    rem = rem.astype(np.int32)
    three = 3 << rice
    small = rem < three
    len_small = (rem >> rice) + 1 + rice
    r2 = np.maximum(rem - three, 0)
    v = r2.astype(np.float32) / np.exp2(rice.astype(np.float32)) + 1.0
    ext = np.floor(np.log2(v)).astype(np.int32)
    len_esc = 4 + ext + rice + ext
    return np.where(small, len_small, len_esc).astype(np.float32)


def _sig_ctx_np(x: int, y: int, prev_csbf: int, log2: int,
                is_luma: bool) -> int:
    """Scalar mirror of residual._sig_ctx for diagonal scan."""
    if log2 == 2:
        return int(SIG_CTX_MAP_4x4[(y << 2) + x])
    if x == 0 and y == 0:
        return 0
    xp_, yp_ = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp_ + yp_ == 0 else (1 if xp_ + yp_ < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp_ == 0 else (1 if yp_ == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp_ == 0 else (1 if xp_ == 1 else 0)
    else:
        s = 2
    if is_luma:
        if (x >> 2) or (y >> 2):
            s += 3
        s += 9 if log2 == 3 else 21
    else:
        s += 9 if log2 == 3 else 12
    return s


# --- device tables and the tu_bits kernel -------------------------------------

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


def tu_bits_plain(est: EstTables, tiles: torch.Tensor,
                  sbh: bool = False) -> torch.Tensor:
    """tiles (N, S, S) int levels -> (N,) float32 bits; all-zero tiles 0.
    sbh: one sign bit fewer per CG whose first and last nonzero in-CG scan
    positions lie 4 or more apart (sign-bit hiding)."""
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
    nsign = n_sig.sum(dim=(1, 2))
    if sbh:
        inpos = (sp % 16)[None].expand(n, S, S)
        big = torch.where(nz, inpos, -1).reshape(n, cgw, 4, cgw, 4)
        small = torch.where(nz, inpos, 99).reshape(n, cgw, 4, cgw, 4)
        span = (big.amax(dim=4).amax(dim=2)
                - small.amin(dim=4).amin(dim=2))
        nsign = nsign - ((span >= 4) & (n_sig > 0)).sum(dim=(1, 2))
    bits = bits + nsign.float()
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
    if any(t.data_ptr() % 16 for t in (tiles, est.itab, est.ftab)):
        raise ValueError("tu_bits: tiles and tables must be 16-byte aligned")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    fn = kbuild.function("tu_bits", "tpuhevc_tu_bits",
                         [kbuild.P] * 4 + [kbuild.I] * 3 + [kbuild.P])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = fn(tiles.data_ptr(), est.itab.data_ptr(), est.ftab.data_ptr(),
             out.data_ptr(), n, est.log2, sms,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "tu_bits")
    LAUNCHES["tu_bits"] += 1
    return out
