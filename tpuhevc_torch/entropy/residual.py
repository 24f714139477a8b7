"""residual_coding() syntax: transform-coefficient entropy coding/parsing.

Counterpart of the reference's TEncSbac::codeCoeffNxN / TDecSbac::
parseCoeffNxN (SURVEY.md §2.2/§2.3); process per H.265 §7.3.8.11 with the
context derivations of §9.3.4.2.5-2.7. Both directions here, fuzz-tested for
roundtrip + context-state equality; spec conformance validated e2e against
the reference decoder oracle.
"""

from __future__ import annotations

import numpy as np

from ..utils.tables import (
    GROUP_IDX,
    MIN_IN_GROUP,
    SCAN_DIAG,
    SCAN_VER,
    SIG_CTX_MAP_4x4,
    scan_order,
)
from .cabac import CTX_OFFSET, CabacDecoder, CabacEncoder

C1FLAG_NUMBER = 8
SBH_THRESHOLD = 4

_CTX_LAST = CTX_OFFSET["last_sig_xy"]
_CTX_CSBF = CTX_OFFSET["sig_cg_flag"]
_CTX_SIG = CTX_OFFSET["sig_coeff_flag"]
_CTX_GT1 = CTX_OFFSET["coeff_gt1"]
_CTX_GT2 = CTX_OFFSET["coeff_gt2"]

# last-position x/y use separate context banks in HM's layout? No: HM uses
# one set for x and the same-init separate models for y. The spec has
# distinct ctx variables for x and y; HM's ContextTables INIT_LAST is shared
# between the two 15-entry halves... HM allocates NUM_CTX_LAST_FLAG_SETS * 15
# per direction (m_cCuCtxLastX and m_cCuCtxLastY are two banks of 30).
# We mirror that: last_x at _CTX_LAST, last_y at a second bank.


def _last_ctx_params(log2: int, is_luma: bool) -> tuple[int, int]:
    if is_luma:
        return 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
    return 15, log2 - 2


def _sig_ctx(x: int, y: int, prev_csbf: int, log2: int, is_luma: bool,
             scan_idx: int) -> int:
    if log2 == 2:
        return int(SIG_CTX_MAP_4x4[(y << 2) + x])
    if x == 0 and y == 0:
        return 0
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if is_luma:
        if (x >> 2) or (y >> 2):
            s += 3
        s += (9 if scan_idx == SCAN_DIAG else 15) if log2 == 3 else 21
    else:
        s += 9 if log2 == 3 else 12
    return s


def _sig_base(is_luma: bool) -> int:
    return _CTX_SIG + (0 if is_luma else 28)


class _Grid:
    """Per-call geometry: scan tables and CG layout."""

    def __init__(self, log2: int, scan_idx: int):
        self.size = 1 << log2
        self.scan = scan_order(log2, scan_idx)  # scan pos -> raster
        self.num_cgs = max(1, (self.size * self.size) >> 4)
        self.cg_w = max(1, self.size >> 2)


def encode_residual(enc: CabacEncoder, coeffs: np.ndarray, log2: int,
                    is_luma: bool, scan_idx: int,
                    sign_hiding: bool = False) -> None:
    """coeffs: (S, S) int array [y][x] with at least one nonzero."""
    g = _Grid(log2, scan_idx)
    flat = coeffs.reshape(-1)
    scan = g.scan
    svals = flat[scan]
    nz = np.nonzero(svals)[0]
    assert len(nz), "encode_residual requires a nonzero block (cbf=1)"
    last_scan = int(nz[-1])

    # --- last significant position ---
    last_raster = int(scan[last_scan])
    lx, ly = last_raster % g.size, last_raster // g.size
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx
    _encode_last_pos(enc, lx, ly, log2, is_luma)

    # --- per-CG flags ---
    csbf = np.zeros(g.num_cgs, dtype=np.int32)
    for i in range(g.num_cgs):
        if svals[i * 16 : (i + 1) * 16].any():
            csbf[i] = 1
    last_cg = last_scan >> 4
    csbf[0] = 1  # inferred 1 on both sides; an all-zero CG0 codes 16 zero sigs

    # CG coordinates in scan order: raster pos of first coeff of CG
    def cg_xy(cg_idx: int) -> tuple[int, int]:
        r = int(scan[cg_idx * 16])
        return (r % g.size) >> 2, (r // g.size) >> 2

    c1 = 1
    for cg in range(last_cg, -1, -1):
        xs, ys = cg_xy(cg)
        csbf_right = int(csbf_at(csbf, scan, g, xs + 1, ys))
        csbf_below = int(csbf_at(csbf, scan, g, xs, ys + 1))
        infer_sb_dc = False
        if cg < last_cg and cg > 0:
            ctx = _CTX_CSBF + (0 if is_luma else 2) + (1 if (csbf_right or csbf_below) else 0)
            enc.encode_bin(int(csbf[cg]), ctx)
            infer_sb_dc = bool(csbf[cg])
        if not csbf[cg]:
            continue
        prev_csbf = csbf_right + 2 * csbf_below
        # --- sig flags ---
        first_pos = cg * 16
        start = last_scan - first_pos if cg == last_cg else 15
        sig_base = _sig_base(is_luma)
        sig_found = False
        levels = []  # (scan_pos, abs, sign) in coding order (reverse scan)
        if cg == last_cg:
            levels.append(last_scan)
            sig_found = True
            start -= 1
        for n in range(start, -1, -1):
            pos = first_pos + n
            v = int(svals[pos])
            if n == 0 and infer_sb_dc and not sig_found:
                levels.append(pos)  # inferred significant
                continue
            r = int(scan[pos])
            x, y = r % g.size, r // g.size
            ctx = sig_base + _sig_ctx(x, y, prev_csbf, log2, is_luma, scan_idx)
            enc.encode_bin(1 if v else 0, ctx)
            if v:
                levels.append(pos)
                sig_found = True
        # --- levels --- (an empty subset leaves c1 untouched, §9.3.4.2.6)
        if levels:
            c1 = _encode_cg_levels(enc, svals, levels, c1, cg, is_luma, sign_hiding)


def csbf_at(csbf, scan, g, xs, ys):
    if xs >= g.cg_w or ys >= g.cg_w:
        return 0
    # CG scan index from coordinates: find cg whose first coeff raster is in
    # that CG. Precompute mapping raster-CG -> scan-CG once per grid.
    key = (id(scan), g.size)
    m = _cg_map_cache.get(key)
    if m is None:
        m = np.empty(g.cg_w * g.cg_w, dtype=np.int32)
        for cg in range(g.num_cgs):
            r = int(scan[cg * 16])
            m[((r // g.size) >> 2) * g.cg_w + ((r % g.size) >> 2)] = cg
        _cg_map_cache[key] = m
    return csbf[int(m[ys * g.cg_w + xs])]


_cg_map_cache: dict = {}


def _encode_last_pos(enc: CabacEncoder, lx: int, ly: int, log2: int, is_luma: bool) -> None:
    gx, gy = int(GROUP_IDX[lx]), int(GROUP_IDX[ly])
    off, shift = _last_ctx_params(log2, is_luma)
    cmax = (log2 << 1) - 1
    # x prefix
    for b in range(gx):
        enc.encode_bin(1, _CTX_LAST + off + (b >> shift))
    if gx < cmax:
        enc.encode_bin(0, _CTX_LAST + off + (gx >> shift))
    # y prefix (second bank of 30 contexts)
    for b in range(gy):
        enc.encode_bin(1, _CTX_LAST + 30 + off + (b >> shift))
    if gy < cmax:
        enc.encode_bin(0, _CTX_LAST + 30 + off + (gy >> shift))
    if gx > 3:
        nbits = (gx - 2) >> 1
        enc.encode_bins_ep(lx - int(MIN_IN_GROUP[gx]), nbits)
    if gy > 3:
        nbits = (gy - 2) >> 1
        enc.encode_bins_ep(ly - int(MIN_IN_GROUP[gy]), nbits)


def _encode_cg_levels(enc, svals, levels, c1, cg_idx, is_luma, sign_hiding) -> int:
    """levels: scan positions of significant coeffs in coding order.
    Returns updated persistent c1."""
    abs_vals = [abs(int(svals[p])) for p in levels]
    signs = [1 if int(svals[p]) < 0 else 0 for p in levels]
    n = len(abs_vals)
    ctx_set = 2 if (cg_idx > 0 and is_luma) else 0
    if c1 == 0:
        ctx_set += 1
    c1 = 1
    gt1_base = _CTX_GT1 + (0 if is_luma else 16) + 4 * ctx_set
    num_c1 = min(n, C1FLAG_NUMBER)
    first_c2 = -1
    for i in range(num_c1):
        sym = 1 if abs_vals[i] > 1 else 0
        enc.encode_bin(sym, gt1_base + c1)
        if sym:
            c1 = 0
            if first_c2 == -1:
                first_c2 = i
        elif 0 < c1 < 3:
            c1 += 1
    if c1 == 0 and first_c2 != -1:
        gt2_ctx = _CTX_GT2 + (0 if is_luma else 4) + ctx_set
        enc.encode_bin(1 if abs_vals[first_c2] > 2 else 0, gt2_ctx)
    # signs (sign hiding: last sign in coding order = first in scan omitted)
    hide = False
    if sign_hiding and n > 1:
        # positions are descending scan order; coding-order last = smallest
        first_nz_scan = levels[-1] & 15
        last_nz_scan = levels[0] & 15
        hide = (last_nz_scan - first_nz_scan) >= SBH_THRESHOLD
    nsigns = n - 1 if hide else n
    if nsigns > 0:
        val = 0
        for s in signs[:nsigns]:
            val = (val << 1) | s
        enc.encode_bins_ep(val, nsigns)
    # remaining levels
    rice = 0
    for i in range(n):
        base = 1
        if i < C1FLAG_NUMBER:
            base = 2 + (1 if i == first_c2 else 0)
        if abs_vals[i] >= base:
            _encode_remaining(enc, abs_vals[i] - base, rice)
            if abs_vals[i] > (3 << rice):
                rice = min(rice + 1, 4)
    return c1


def _encode_remaining(enc, symbol: int, rice: int) -> None:
    if symbol < (3 << rice):
        length = symbol >> rice
        enc.encode_bins_ep((1 << (length + 1)) - 2, length + 1)
        enc.encode_bins_ep(symbol & ((1 << rice) - 1), rice)
    else:
        length = rice
        symbol -= 3 << rice
        while symbol >= (1 << length):
            symbol -= 1 << length
            length += 1
        enc.encode_bins_ep((1 << (3 + length + 1 - rice)) - 2, 3 + length + 1 - rice)
        enc.encode_bins_ep(symbol, length)


# --- decoding --------------------------------------------------------------

def decode_residual(dec: CabacDecoder, log2: int, is_luma: bool,
                    scan_idx: int, sign_hiding: bool = False) -> np.ndarray:
    g = _Grid(log2, scan_idx)
    scan = g.scan
    svals = np.zeros(g.size * g.size, dtype=np.int32)

    lx, ly = _decode_last_pos(dec, log2, is_luma)
    if scan_idx == SCAN_VER:
        lx, ly = ly, lx
    last_raster = ly * g.size + lx
    last_scan = int(np.nonzero(scan == last_raster)[0][0])

    csbf = np.zeros(g.num_cgs, dtype=np.int32)
    last_cg = last_scan >> 4
    csbf[last_cg] = 1
    csbf[0] = 1

    def cg_xy(cg_idx: int) -> tuple[int, int]:
        r = int(scan[cg_idx * 16])
        return (r % g.size) >> 2, (r // g.size) >> 2

    c1 = 1
    for cg in range(last_cg, -1, -1):
        xs, ys = cg_xy(cg)
        csbf_right = int(csbf_at(csbf, scan, g, xs + 1, ys))
        csbf_below = int(csbf_at(csbf, scan, g, xs, ys + 1))
        infer_sb_dc = False
        if cg < last_cg and cg > 0:
            ctx = _CTX_CSBF + (0 if is_luma else 2) + (1 if (csbf_right or csbf_below) else 0)
            csbf[cg] = dec.decode_bin(ctx)
            infer_sb_dc = bool(csbf[cg])
        if not csbf[cg]:
            continue
        prev_csbf = csbf_right + 2 * csbf_below
        first_pos = cg * 16
        start = last_scan - first_pos if cg == last_cg else 15
        sig_base = _sig_base(is_luma)
        sig_found = False
        levels = []
        if cg == last_cg:
            levels.append(last_scan)
            sig_found = True
            start -= 1
        for n in range(start, -1, -1):
            pos = first_pos + n
            if n == 0 and infer_sb_dc and not sig_found:
                levels.append(pos)
                continue
            r = int(scan[pos])
            x, y = r % g.size, r // g.size
            ctx = sig_base + _sig_ctx(x, y, prev_csbf, log2, is_luma, scan_idx)
            if dec.decode_bin(ctx):
                levels.append(pos)
                sig_found = True
        if levels:
            c1 = _decode_cg_levels(dec, svals, levels, c1, cg, is_luma, sign_hiding)

    out = np.zeros(g.size * g.size, dtype=np.int32)
    out[scan] = svals
    return out.reshape(g.size, g.size)


def _decode_last_pos(dec, log2, is_luma) -> tuple[int, int]:
    off, shift = _last_ctx_params(log2, is_luma)
    cmax = (log2 << 1) - 1
    gx = 0
    while gx < cmax and dec.decode_bin(_CTX_LAST + off + (gx >> shift)):
        gx += 1
    gy = 0
    while gy < cmax and dec.decode_bin(_CTX_LAST + 30 + off + (gy >> shift)):
        gy += 1
    lx = int(MIN_IN_GROUP[gx])
    ly = int(MIN_IN_GROUP[gy])
    if gx > 3:
        lx += dec.decode_bins_ep((gx - 2) >> 1)
    if gy > 3:
        ly += dec.decode_bins_ep((gy - 2) >> 1)
    return lx, ly


def _decode_cg_levels(dec, svals, levels, c1, cg_idx, is_luma, sign_hiding) -> int:
    n = len(levels)
    ctx_set = 2 if (cg_idx > 0 and is_luma) else 0
    if c1 == 0:
        ctx_set += 1
    c1 = 1
    gt1_base = _CTX_GT1 + (0 if is_luma else 16) + 4 * ctx_set
    num_c1 = min(n, C1FLAG_NUMBER)
    abs_vals = [1] * n
    first_c2 = -1
    for i in range(num_c1):
        if dec.decode_bin(gt1_base + c1):
            abs_vals[i] = 2
            if first_c2 == -1:
                first_c2 = i
            c1 = 0
        elif 0 < c1 < 3:
            c1 += 1
    if c1 == 0 and first_c2 != -1:
        gt2_ctx = _CTX_GT2 + (0 if is_luma else 4) + ctx_set
        if dec.decode_bin(gt2_ctx):
            abs_vals[first_c2] = 3
    hide = False
    if sign_hiding and n > 1:
        first_nz_scan = levels[-1] & 15
        last_nz_scan = levels[0] & 15
        hide = (last_nz_scan - first_nz_scan) >= SBH_THRESHOLD
    nsigns = n - 1 if hide else n
    signs = []
    if nsigns > 0:
        val = dec.decode_bins_ep(nsigns)
        signs = [(val >> (nsigns - 1 - i)) & 1 for i in range(nsigns)]
    rice = 0
    total = 0
    for i in range(n):
        base = 1
        if i < C1FLAG_NUMBER:
            base = 2 + (1 if i == first_c2 else 0)
        if abs_vals[i] == base:
            abs_vals[i] += _decode_remaining(dec, rice)
        if abs_vals[i] > (3 << rice):
            rice = min(rice + 1, 4)
        total += abs_vals[i]
    if hide:
        signs.append(total & 1)
    for i, pos in enumerate(levels):
        v = abs_vals[i]
        svals[pos] = -v if signs[i] else v
    return c1


def _decode_remaining(dec, rice: int) -> int:
    prefix = 0
    while prefix < 3 and dec.decode_bin_ep():
        prefix += 1
    if prefix < 3:
        suffix = dec.decode_bins_ep(rice) if rice else 0
        return (prefix << rice) + suffix
    # escape
    length = 0
    while dec.decode_bin_ep():
        length += 1
    length += rice
    suffix = dec.decode_bins_ep(length) if length else 0
    return (3 << rice) + _esc_base(length, rice) + suffix


def _esc_base(length: int, rice: int) -> int:
    base = 0
    for k in range(rice, length):
        base += 1 << k
    return base


def apply_sign_bit_hiding(levels: np.ndarray, log2: int, scan_idx: int,
                          ideal: np.ndarray | None = None) -> np.ndarray:
    """Encoder-side SBH quantizer post-pass (signBitHidingHDQ,
    TComTrQuant.cpp:991): per 4x4 coefficient group where the span between
    first and last nonzero scan position >= SBH_THRESHOLD, adjust one
    level's magnitude by one so the CG's abs-level-sum parity encodes the
    sign of the first-in-scan coefficient (which the decoder then infers).

    levels: (..., S, S). ideal (same shape): the real-valued unclamped
    quantization |coef|*scale/2^qbits, used to pick the adjustment with
    the smallest requantization error (HM's deltaU criterion); without it
    a magnitude heuristic is used. Returns the adjusted copy.
    """
    g = _Grid(log2, scan_idx)
    out = np.array(levels, copy=True)
    blocks = out.reshape(-1, g.size, g.size)
    iblocks = ideal.reshape(-1, g.size, g.size) if ideal is not None else None
    for b in range(blocks.shape[0]):
        flat = blocks[b].reshape(-1)
        svals = flat[g.scan]
        ivals = (iblocks[b].reshape(-1)[g.scan]
                 if iblocks is not None else None)
        for cg in range(g.num_cgs):
            seg = svals[cg * 16 : (cg + 1) * 16]
            nz = np.nonzero(seg)[0]
            if len(nz) == 0:
                continue
            first, last = int(nz[0]), int(nz[-1])
            if last - first < SBH_THRESHOLD:
                continue
            abs_sum = int(np.abs(seg).sum())
            want = 1 if seg[first] < 0 else 0
            if (abs_sum & 1) == want:
                continue
            if ivals is not None:
                iseg = ivals[cg * 16 : (cg + 1) * 16]
                best = None  # (err, pos, new_abs)
                for p in range(first, last + 1):
                    la = abs(int(seg[p]))
                    for na in (la + 1, la - 1):
                        if na < 0 or (p == first and na == 0):
                            continue
                        err = abs(na - abs(float(iseg[p])))
                        if best is None or err < best[0]:
                            best = (err, p, na)
                _, p, na = best
                sgn = np.sign(seg[p]) if seg[p] else (
                    1 if iseg[p] >= 0 else -1)
                seg[p] = int(sgn) * na
            else:
                big = nz[np.abs(seg[nz]) >= 2]
                if len(big):
                    p = int(big[0])
                    seg[p] -= np.sign(seg[p])
                else:
                    seg[last] += np.sign(seg[last])
            svals[cg * 16 : (cg + 1) * 16] = seg
        flat[g.scan] = svals
        blocks[b] = flat.reshape(g.size, g.size)
    return out
