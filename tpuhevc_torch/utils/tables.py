"""Normative constant tables + derivations shared by encoder and decoder.

Covers what the reference keeps in TComRom.{h,cpp} (SURVEY.md §2.1 "ROM
tables"): transform matrices, scan orders, quant scales, chroma QP mapping,
intra angle tables, coefficient-group maps. All constants are ITU-T H.265
mandated; generation code is original (the DCT matrices are produced from
their quarter-wave symmetry rather than 32x32 literals).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

MAX_TR_DYNAMIC_RANGE = 15  # Main profile (extended_precision off)

# --- transform matrices ----------------------------------------------------
# Hand-tuned integer DCT-II approximations (H.265 §8.6.4.2). The full 32x32
# matrix is T[k][n] = V[(k*(2n+1)) mod 128] for k>0 with row 0 = 64, where V
# is the quarter-wave value table below (hand-tuned, NOT pure rounding: e.g.
# 83 where round(90.51*cos(pi/8)) = 84).

_ODD32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
_ODD16 = [90, 87, 80, 70, 57, 43, 25, 9]
_ODD8 = [89, 75, 50, 18]
_ODD4 = [83, 36]


def _quarter_wave() -> np.ndarray:
    """V[j] ~ hand-tuned 90.51*cos(j*pi/64) for j in [0, 128)."""
    v = np.zeros(129, dtype=np.int64)
    for i, j in enumerate(range(1, 32, 2)):
        v[j] = _ODD32[i]
    for i, j in enumerate(range(2, 32, 4)):
        v[j] = _ODD16[i]
    for i, j in enumerate(range(4, 32, 8)):
        v[j] = _ODD8[i]
    v[8], v[24] = _ODD4
    v[16] = 64
    v[32] = 0
    for j in range(33, 65):
        v[j] = -v[64 - j]
    for j in range(65, 128):
        v[j] = v[128 - j]
    return v[:128]


@lru_cache(maxsize=None)
def dct_matrix(size: int) -> np.ndarray:
    """The size x size HEVC core transform matrix (int32)."""
    assert size in (4, 8, 16, 32)
    v = _quarter_wave()
    step = 32 // size
    t = np.zeros((size, size), dtype=np.int32)
    t[0, :] = 64
    for k in range(1, size):
        kk = k * step
        for n in range(size):
            t[k, n] = v[(kk * (2 * n + 1)) % 128]
    return t


DST4 = np.array(
    [[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55], [55, -84, 74, -29]],
    dtype=np.int32,
)

# --- quantization ----------------------------------------------------------
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], dtype=np.int64)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)

# chroma QP mapping for 4:2:0 (H.265 Table 8-10), index = clipped qPi 0..57
CHROMA_QP_TABLE_420 = np.array(
    list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]
    + list(range(38, 52)),
    dtype=np.int32,
)


def chroma_qp(qp_y: int, qp_offset: int = 0, chroma_format: int = 1) -> int:
    qpi = min(max(qp_y + qp_offset, 0), 57)
    if chroma_format == 1:
        return int(CHROMA_QP_TABLE_420[qpi])
    return min(qpi, 51)


# --- scan orders (H.265 §6.5.3) -------------------------------------------
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


def _diag_scan(size: int) -> list[tuple[int, int]]:
    """Up-right diagonal scan: (x, y) pairs in scan order."""
    out = []
    for d in range(2 * size - 1):
        y = min(d, size - 1)
        while y >= 0 and d - y < size:
            out.append((d - y, y))
            y -= 1
    return out


@lru_cache(maxsize=None)
def scan_order(log2_size: int, scan_idx: int) -> np.ndarray:
    """Raster indices in scan order, 4x4 coefficient-group grouped for
    sizes >= 8 (matches TComRom initROM's grouped scans)."""
    size = 1 << log2_size
    if scan_idx == SCAN_DIAG:
        inner = _diag_scan(4)
    elif scan_idx == SCAN_HOR:
        inner = [(x, y) for y in range(4) for x in range(4)]
    else:
        inner = [(x, y) for x in range(4) for y in range(4)]
    if size == 4:
        return np.array([y * 4 + x for x, y in inner], dtype=np.int32)
    ngroups = size >> 2
    if scan_idx == SCAN_DIAG:
        groups = _diag_scan(ngroups)
    elif scan_idx == SCAN_HOR:
        groups = [(x, y) for y in range(ngroups) for x in range(ngroups)]
    else:
        groups = [(x, y) for x in range(ngroups) for y in range(ngroups)]
    out = []
    for gx, gy in groups:
        for x, y in inner:
            out.append((gy * 4 + y) * size + gx * 4 + x)
    return np.array(out, dtype=np.int32)


# last_sig_coeff position binarization tables (§9.3.3.7)
GROUP_IDX = np.array(
    [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
     8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9],
    dtype=np.int32,
)
MIN_IN_GROUP = np.array([0, 1, 2, 3, 4, 6, 8, 12, 16, 24], dtype=np.int32)

# sig_coeff_flag context map for 4x4 TBs (§9.3.4.2.5)
SIG_CTX_MAP_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8], dtype=np.int32
)

# --- intra prediction tables (§8.4.4.2.6) ---------------------------------
# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)
# invAngle for modes 11..25 (angle -2..-32..-2)
INTRA_INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32,
)

PLANAR_IDX, DC_IDX = 0, 1
HOR_IDX, VER_IDX = 10, 26


def intra_scan_idx(mode: int, log2_size: int, is_luma: bool) -> int:
    """Mode-dependent scan for 4x4/8x8 intra TBs (§7.4.9.11)."""
    if log2_size == 2 or (log2_size == 3 and is_luma):
        if 6 <= mode <= 14:
            return SCAN_VER
        if 22 <= mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG


# --- QP -> lambda (encoder-side, non-normative; TEncSlice.cpp:295-310) ----

def qp_to_lambda(qp: int, qp_factor: float = 0.57, frame_type_scale: float = 1.0) -> float:
    qp_temp = qp - 12
    return qp_factor * frame_type_scale * (2.0 ** (qp_temp / 3.0))


def gop_depth(poc_in_gop: int, gop_size: int) -> int:
    """Hierarchy depth of a GOP position (TEncSlice::initEncSlice
    TEncSlice.cpp:166-199): 0 for the key picture, else the dyadic level.
    GOP4: {0:0, 1:2, 2:1, 3:2}."""
    if poc_in_gop == 0 or gop_size <= 1:
        return 0
    step = gop_size
    depth = 0
    i = step >> 1
    while i >= 1:
        for j in range(i, gop_size, step):
            if j == poc_in_gop:
                # HM increments depth once more after the matching level
                # (the i=0 break still falls through step>>=1; depth++)
                return depth + 1
        step >>= 1
        depth += 1
        i >>= 1
    return depth


def slice_lambda(frame_qp: int, qp_factor: float, depth: int,
                 gop_size: int = 4, is_intra: bool = False,
                 had_me: bool = True) -> float:
    """The full HM picture-lambda model (TEncSlice.cpp:283-325):
    lambda = QPfactor * 2^((qp-12)/3), with the I-slice factor
    0.57*(1 - clip(0.05*(GOPSize-1), 0, 0.5)) and the non-key-picture
    multiplier clip(qp_temp/6, 2, 4) for depth > 0. This multiplier is
    what makes HM code hierarchy-leaf pictures cheaply."""
    qp_temp = frame_qp - 12
    if is_intra:
        scale = 1.0 - min(0.5, max(0.0, 0.05 * (gop_size - 1)))
        qp_factor = 0.57 * scale
    lam = qp_factor * (2.0 ** (qp_temp / 3.0))
    if not is_intra and depth > 0:
        lam *= min(4.0, max(2.0, qp_temp / 6.0))
    if not is_intra and not had_me:
        lam *= 0.95
    return lam


# --- MPM derivation (§8.4.2) ----------------------------------------------

def intra_mpm_list(left_mode: int, above_mode: int) -> list[int]:
    """candModeList from neighbor modes (already availability-resolved to DC
    when missing/not-intra/other-CTU-row)."""
    a, b = left_mode, above_mode
    if a == b:
        if a < 2:
            return [PLANAR_IDX, DC_IDX, VER_IDX]
        return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
    lst = [a, b]
    for c in (PLANAR_IDX, DC_IDX, VER_IDX):
        if c not in lst:
            lst.append(c)
            break
    return lst
