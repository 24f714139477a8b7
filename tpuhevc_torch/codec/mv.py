"""Motion-vector prediction: merge and AMVP candidate derivation.

Counterpart of TComDataCU's getInterMergeCandidates / fillMvpCand
(SURVEY.md §2.1 "CU data model"), per H.265 §8.5.3.2.3/.2.6, for P slices
with one list (L0) and multiple short-term references, no TMVP. Shared
verbatim by the encoder's decision pass, the syntax coder, and the
decoder, so derivation cannot diverge.

Merge candidates carry (mvx, mvy, ref_idx) and are used as-is (no
scaling). AMVP candidates scale a different-ref neighbor MV by POC
distance (§8.5.3.2.8 temporal scaling formula, all short-term).

MV field granularity: one (MV, ref) per 8x8 cell (the minimum PU this
framework emits); a CU spanning k cells replicates into each.
"""

from __future__ import annotations

import numpy as np

from .refsamples import BlockOrder


def scale_mv(mv: tuple[int, int], tb: int, td: int) -> tuple[int, int]:
    """§8.5.3.2.8: scale mv by POC distances tb (target) / td (neighbor)."""
    if tb == td:
        return mv
    tb = max(-128, min(127, tb))
    td = max(-128, min(127, td))
    tx = (16384 + (abs(td) >> 1)) // td
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def s(v):
        p = dsf * v
        out = (abs(p) + 127) >> 8
        out = -out if p < 0 else out
        return max(-32768, min(32767, out))

    return (s(mv[0]), s(mv[1]))


class MvField:
    def __init__(self, w8: int, h8: int, cell: int = 8):
        # grid of `cell`-sample cells; (w8, h8) counts are in 8-sample
        # units for backward compatibility, scaled up for finer cells
        f = 8 // cell
        self.cell = cell
        self.w8 = w8 * f
        self.h8 = h8 * f
        self.mv = np.zeros((self.h8, self.w8, 2), dtype=np.int32)
        self.ref = np.zeros((self.h8, self.w8), dtype=np.int32)
        self.valid = np.zeros((self.h8, self.w8), dtype=bool)

    def set_cu(self, x0: int, y0: int, size: int, mv, ref: int = 0) -> None:
        self.set_pu(x0, y0, size, size, mv, ref)

    def set_pu(self, x0: int, y0: int, w: int, h: int, mv,
               ref: int = 0) -> None:
        c = self.cell
        xc, yc = x0 // c, y0 // c
        self.mv[yc : yc + h // c, xc : xc + w // c] = mv
        self.ref[yc : yc + h // c, xc : xc + w // c] = ref
        self.valid[yc : yc + h // c, xc : xc + w // c] = True

    def at(self, xc: int, yc: int):
        """(mvx, mvy, ref) at cell coords, or None."""
        if 0 <= xc < self.w8 and 0 <= yc < self.h8 and self.valid[yc, xc]:
            return (int(self.mv[yc, xc, 0]), int(self.mv[yc, xc, 1]),
                    int(self.ref[yc, xc]))
        return None


class ColMotion:
    """Collocated-picture motion for TMVP (§8.5.3.2.7): per-16x16
    compressed (MV, ref-POC) + validity, with the col picture's POC.
    Built by the decoder from each reconstructed P frame's MV field."""

    def __init__(self, fs, ref_pocs_abs: list[int], poc: int):
        self.poc = poc
        mv = fs.mv[::2, ::2]                       # motion compression:
        ref = fs.ref_idx[::2, ::2]                 # top-left of each 16x16
        inter = fs.inter_dir[::2, ::2] != 0
        self.mv16 = mv.copy()
        self.refpoc16 = np.asarray(
            [[ref_pocs_abs[min(int(r), len(ref_pocs_abs) - 1)]
              for r in row] for row in ref], dtype=np.int64)
        self.valid16 = inter.copy()

    def at(self, x: int, y: int):
        """(mvx, mvy, refpoc) at luma sample (x, y), or None."""
        x16, y16 = (x >> 4), (y >> 4)
        if (0 <= y16 < self.valid16.shape[0]
                and 0 <= x16 < self.valid16.shape[1]
                and self.valid16[y16, x16]):
            return (int(self.mv16[y16, x16, 0]),
                    int(self.mv16[y16, x16, 1]),
                    int(self.refpoc16[y16, x16]))
        return None


def temporal_candidate(col: ColMotion, x0: int, y0: int, size: int,
                       target_poc: int, cur_poc: int, pic_w: int,
                       pic_h: int, log2_ctu: int, pu_h: int | None = None):
    """§8.5.3.2.7: bottom-right col PU first (same CTU row + inside the
    picture), else the center; §8.5.3.2.8 POC scaling to target_poc."""
    nh = pu_h if pu_h is not None else size
    cand = None
    xbr, ybr = x0 + size, y0 + nh
    if (ybr >> log2_ctu) == (y0 >> log2_ctu) and ybr < pic_h \
            and xbr < pic_w:
        cand = col.at(xbr, ybr)
    if cand is None:
        cand = col.at(x0 + size // 2, y0 + nh // 2)
    if cand is None:
        return None
    tb = cur_poc - target_poc
    td = col.poc - cand[2]
    if td == 0:
        return None
    return scale_mv((cand[0], cand[1]), tb, td)


def _neighbor(field: MvField, order: BlockOrder, cur_cell, px: int, py: int):
    """(mv, ref) of the PU covering sample (px, py), if decoded.

    Availability = the field's progressive `valid` flag, which is set
    exactly when a PU's motion has been decoded. A z-scan `precedes`
    test is WRONG here: for an Nx2N CU the first PU's bottom-left cells
    have a LATER z-address than the second PU's origin, yet PU0 is
    decoded and must serve as PU1's AMVP candA (HM getPULeft has no
    z-check; the merge-specific exclusions are handled by `excl`)."""
    if px < 0 or py < 0:
        return None
    c = field.cell
    return field.at(px // c, py // c)


def merge_candidates(field: MvField, order: BlockOrder, x0: int, y0: int,
                     size: int, max_cand: int = 5, num_ref: int = 1,
                     col: "ColMotion | None" = None,
                     ref_pocs: list[int] | None = None, cur_poc: int = 0,
                     pic_w: int = 0, pic_h: int = 0,
                     log2_ctu: int = 6, pu_h: int | None = None,
                     excl: str | None = None) -> list[tuple[int, int, int]]:
    """Merge list (§8.5.3.2.3): spatial + temporal (when a collocated
    picture is given) + zero fill; entries (mvx, mvy, ref). P, L0 only.
    pu_h: PU height when rectangular (width = size). excl: 'A1' for the
    second PU of vertical splits, 'B1' for horizontal (availability step
    2 — a merge equal to PU0 would re-create 2Nx2N)."""
    cur = (x0 // field.cell, y0 // field.cell)
    n = size
    nh = pu_h if pu_h is not None else size
    a1 = _neighbor(field, order, cur, x0 - 1, y0 + nh - 1)
    b1 = _neighbor(field, order, cur, x0 + n - 1, y0 - 1)
    b0 = _neighbor(field, order, cur, x0 + n, y0 - 1)
    a0 = _neighbor(field, order, cur, x0 - 1, y0 + nh)
    b2 = _neighbor(field, order, cur, x0 - 1, y0 - 1)
    if excl == "A1":
        a1 = None
    elif excl == "B1":
        b1 = None
    out: list[tuple[int, int, int]] = []
    if a1 is not None:
        out.append(a1)
    if b1 is not None and b1 != a1:
        out.append(b1)
    if b0 is not None and b0 != b1:
        out.append(b0)
    if a0 is not None and a0 != a1:
        out.append(a0)
    if len(out) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        out.append(b2)
    if col is not None and len(out) < max_cand:
        tpoc = ref_pocs[0] if ref_pocs else cur_poc - 1
        t = temporal_candidate(col, x0, y0, size, tpoc, cur_poc,
                               pic_w, pic_h, log2_ctu, pu_h=nh)
        if t is not None:  # temporal is not pruned against spatial
            out.append((t[0], t[1], 0))
    # zero candidates with increasing ref, then ref 0 (HM's zero-mv fill)
    zero_i = 0
    while len(out) < max_cand:
        out.append((0, 0, zero_i if zero_i < num_ref else 0))
        zero_i += 1
    return out[:max_cand]


def amvp_candidates(field: MvField, order: BlockOrder, x0: int, y0: int,
                    size: int, target_ref: int = 0,
                    ref_pocs: list[int] | None = None,
                    cur_poc: int = 0, col: "ColMotion | None" = None,
                    pic_w: int = 0, pic_h: int = 0,
                    log2_ctu: int = 6,
                    pu_h: int | None = None) -> list[tuple[int, int]]:
    """AMVP list (§8.5.3.2.6) for target_ref: candA from {A0, A1}, candB
    from {B0, B1, B2}; same-ref MVs preferred, otherwise POC-scaled;
    dedup; zero-fill to 2. ref_pocs: POC of each L0 entry (None = single
    ref, no scaling)."""
    cur = (x0 // field.cell, y0 // field.cell)
    n = size
    nh = pu_h if pu_h is not None else size

    def poc_of(r):
        return ref_pocs[r] if ref_pocs is not None else cur_poc - 1

    nb_a = [_neighbor(field, order, cur, x0 - 1, y0 + nh),      # A0
            _neighbor(field, order, cur, x0 - 1, y0 + nh - 1)]  # A1
    nb_b = [_neighbor(field, order, cur, x0 + n, y0 - 1),      # B0
            _neighbor(field, order, cur, x0 + n - 1, y0 - 1),  # B1
            _neighbor(field, order, cur, x0 - 1, y0 - 1)]      # B2
    # isScaledFlagLX (TComDataCU::fillMvpCand:2630): A0 or A1 coded inter
    is_scaled = any(nb is not None for nb in nb_a)

    def unscaled(nbs):
        for nb in nbs:
            if nb is not None and poc_of(nb[2]) == poc_of(target_ref):
                return (nb[0], nb[1])
        return None

    def scaled(nbs):
        for nb in nbs:
            if nb is not None:
                tb = cur_poc - poc_of(target_ref)
                td = cur_poc - poc_of(nb[2])
                return scale_mv((nb[0], nb[1]), tb, td)
        return None

    out = []
    if is_scaled:  # left predictor (unscaled then scaled over A0, A1)
        c = unscaled(nb_a)
        if c is None:
            c = scaled(nb_a)
        if c is not None:
            out.append(c)
    c = unscaled(nb_b)  # above predictor, unscaled pass (always)
    if c is not None:
        out.append(c)
    if not is_scaled:  # scaled above pass appends independently
        c = scaled(nb_b)
        if c is not None:
            out.append(c)
    if len(out) == 2 and out[0] == out[1]:
        out = out[:1]
    if len(out) < 2 and col is not None:
        t = temporal_candidate(col, x0, y0, size, poc_of(target_ref),
                               cur_poc, pic_w, pic_h, log2_ctu, pu_h=nh)
        if t is not None:  # col candidate is not pruned against A/B
            out.append(t)
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]
