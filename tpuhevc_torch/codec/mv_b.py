"""Two-list (B slice) motion field + merge/AMVP derivation.

Generalizes codec/mv.py to bi-prediction per H.265 §8.5.3.2.3 (merge,
inheriting inter_pred_idc + both lists, incl. the temporal and combined
bi-predictive candidates) and §8.5.3.2.6/.2.7 (AMVP for a target
(list, refIdx) with cross-list neighbor usage, POC scaling and TMVP).
Counterpart of TComDataCU::getInterMergeCandidates / fillMvpCand /
xGetColMVP (TComDataCU.cpp:2990). Shared by the B-frame encoder walk,
the syntax coder, and the decoder, so derivation cannot diverge.

Candidate tuples: (inter_dir, mv0x, mv0y, ref0, mv1x, mv1y, ref1) with
inter_dir 1 = L0, 2 = L1, 3 = BI; unused-list fields are (0, 0, -1).
"""

from __future__ import annotations

import numpy as np

from .mv import scale_mv
from .refsamples import BlockOrder  # noqa: F401 (API compat)


class MvFieldB:
    """Two-list motion field at `cell`-sample granularity (cell 4 covers
    every partition the spec allows; availability = the progressive
    `valid` flag, set exactly when a PU's motion has been decoded —
    see mv._neighbor for why a z-scan test is wrong)."""

    def __init__(self, w8: int, h8: int, cell: int = 8):
        f = 8 // cell
        self.cell = cell
        self.w8 = w8 * f
        self.h8 = h8 * f
        self.mv = np.zeros((self.h8, self.w8, 2, 2), dtype=np.int32)
        self.ref = np.full((self.h8, self.w8, 2), -1, dtype=np.int32)
        self.inter_dir = np.zeros((self.h8, self.w8), dtype=np.int32)
        self.valid = np.zeros((self.h8, self.w8), dtype=bool)

    def set_cu(self, x0, y0, size, inter_dir, mv0, ref0, mv1, ref1):
        self.set_pu(x0, y0, size, size, inter_dir, mv0, ref0, mv1, ref1)

    def set_pu(self, x0, y0, w, h, inter_dir, mv0, ref0, mv1, ref1):
        c = self.cell
        xc, yc = x0 // c, y0 // c
        sl = (slice(yc, yc + h // c), slice(xc, xc + w // c))
        self.inter_dir[sl] = inter_dir
        self.mv[sl + (0,)] = mv0
        self.mv[sl + (1,)] = mv1
        self.ref[sl + (0,)] = ref0 if inter_dir & 1 else -1
        self.ref[sl + (1,)] = ref1 if inter_dir & 2 else -1
        self.valid[sl] = True

    def at(self, xc, yc):
        if not (0 <= xc < self.w8 and 0 <= yc < self.h8
                and self.valid[yc, xc]):
            return None
        d = int(self.inter_dir[yc, xc])
        if d == 0:
            return None
        return (d,
                int(self.mv[yc, xc, 0, 0]), int(self.mv[yc, xc, 0, 1]),
                int(self.ref[yc, xc, 0]),
                int(self.mv[yc, xc, 1, 0]), int(self.mv[yc, xc, 1, 1]),
                int(self.ref[yc, xc, 1]))


class ColMotionB:
    """Collocated-picture motion for TMVP with BOTH lists (16x16
    compression; HM reads the top-left 4x4's motion of each 16x16).
    Built from a decoded frame's legacy 8-cell maps, whose [::2, ::2]
    equals mv4[::4, ::4] (the 8-cell maps carry each cell's top-left
    4-cell motion)."""

    def __init__(self, fs, l0_pocs_abs, l1_pocs_abs, poc):
        self.poc = poc
        inter = fs.inter_dir[::2, ::2]
        self.dir16 = np.where(inter < 0, 0, inter).astype(np.int32)
        self.mv16 = [fs.mv[::2, ::2].copy()]
        self.refpoc16 = [_refpoc_map(fs.ref_idx[::2, ::2], l0_pocs_abs)]
        if fs.mv_l1 is not None and l1_pocs_abs:
            self.mv16.append(fs.mv_l1[::2, ::2].copy())
            self.refpoc16.append(
                _refpoc_map(fs.ref_idx_l1[::2, ::2], l1_pocs_abs))
        else:
            self.mv16.append(np.zeros_like(self.mv16[0]))
            self.refpoc16.append(np.full_like(self.refpoc16[0], -(10 ** 9)))
            self.dir16 = np.where(self.dir16 == 0, 0, 1)

    def at_list(self, x, y, lst):
        """(mvx, mvy, refpoc) of list `lst` at luma sample (x, y), or
        None when outside / intra / that list unused."""
        x16, y16 = x >> 4, y >> 4
        if not (0 <= y16 < self.dir16.shape[0]
                and 0 <= x16 < self.dir16.shape[1]):
            return None
        d = int(self.dir16[y16, x16])
        if d == 0 or not (d & (1 << lst)):
            return None
        return (int(self.mv16[lst][y16, x16, 0]),
                int(self.mv16[lst][y16, x16, 1]),
                int(self.refpoc16[lst][y16, x16]))


def _refpoc_map(ref, pocs):
    out = np.full(ref.shape, -(10 ** 9), dtype=np.int64)
    for r, p in enumerate(pocs):
        out[ref == r] = p
    n = len(pocs)
    if n:
        out[ref >= n] = pocs[-1]
    return out


def col_mvp_b(col: ColMotionB, x: int, y: int, target_list: int,
              target_poc: int, cur_poc: int, col_from_l0: bool,
              check_ldc: bool):
    """xGetColMVP (TComDataCU.cpp:2990): pick the col PU's list per the
    LDC rule, fall back to the other list, scale by POC distances."""
    lst = target_list if check_ldc else (1 if col_from_l0 else 0)
    cand = col.at_list(x, y, lst)
    if cand is None:
        cand = col.at_list(x, y, 1 - lst)
        if cand is None:
            return None
    td = col.poc - cand[2]
    if td == 0:
        return cand[:2]
    return scale_mv((cand[0], cand[1]), cur_poc - target_poc, td)


def temporal_candidate_b(col: ColMotionB, x0, y0, pw, ph, target_list,
                         target_poc, cur_poc, pic_w, pic_h, log2_ctu,
                         col_from_l0, check_ldc):
    """§8.5.3.2.7 position rule: bottom-right col PU (same CTU row,
    inside the picture) first, else center — per list independently."""
    xbr, ybr = x0 + pw, y0 + ph
    cand = None
    if (ybr >> log2_ctu) == (y0 >> log2_ctu) and ybr < pic_h \
            and xbr < pic_w:
        cand = col_mvp_b(col, xbr, ybr, target_list, target_poc, cur_poc,
                         col_from_l0, check_ldc)
    if cand is None:
        cand = col_mvp_b(col, x0 + pw // 2, y0 + ph // 2, target_list,
                         target_poc, cur_poc, col_from_l0, check_ldc)
    return cand


def _nb(field: MvFieldB, px: int, py: int):
    if px < 0 or py < 0:
        return None
    c = field.cell
    return field.at(px // c, py // c)


# §8.5.3.2.4 combined-bi pair order (l0CandIdx, l1CandIdx)
_L0_IDX = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
_L1_IDX = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)


def merge_candidates_b(field: MvFieldB, order, x0, y0, size,
                       max_cand, num_ref0, num_ref1, l0_pocs=None,
                       l1_pocs=None, pu_w=None, pu_h=None,
                       excl=None, col: ColMotionB | None = None,
                       cur_poc: int = 0, pic_w: int = 0, pic_h: int = 0,
                       log2_ctu: int = 6, col_from_l0: bool = True,
                       check_ldc: bool = False):
    """Merge list for B slices (§8.5.3.2.3): spatial A1,B1,B0,A0,(B2) +
    temporal (both lists, refIdx 0) + combined bi + zero fill. excl:
    'A1' for PU1 of vertical splits, 'B1' for PU1 of horizontal."""
    n = pu_w if pu_w is not None else size
    nh = pu_h if pu_h is not None else size
    a1 = _nb(field, x0 - 1, y0 + nh - 1)
    b1 = _nb(field, x0 + n - 1, y0 - 1)
    b0 = _nb(field, x0 + n, y0 - 1)
    a0 = _nb(field, x0 - 1, y0 + nh)
    b2 = _nb(field, x0 - 1, y0 - 1)
    if excl == "A1":
        a1 = None
    elif excl == "B1":
        b1 = None
    out = []
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
        tpoc0 = l0_pocs[0] if l0_pocs else cur_poc - 1
        t0 = temporal_candidate_b(col, x0, y0, n, nh, 0, tpoc0, cur_poc,
                                  pic_w, pic_h, log2_ctu, col_from_l0,
                                  check_ldc)
        t1 = None
        if num_ref1 > 0 and l1_pocs:
            t1 = temporal_candidate_b(col, x0, y0, n, nh, 1, l1_pocs[0],
                                      cur_poc, pic_w, pic_h, log2_ctu,
                                      col_from_l0, check_ldc)
        d = (1 if t0 is not None else 0) + (2 if t1 is not None else 0)
        if d:  # temporal candidate is not pruned against spatial
            out.append((d,
                        t0[0] if t0 else 0, t0[1] if t0 else 0,
                        0 if t0 else -1,
                        t1[0] if t1 else 0, t1[1] if t1 else 0,
                        0 if t1 else -1))
    # combined bi-predictive candidates (§8.5.3.2.4)
    if num_ref1 > 0 and len(out) > 1:
        norig = len(out)
        k = 0
        while len(out) < max_cand and k < norig * (norig - 1) \
                and k < len(_L0_IDX):
            i0, i1 = _L0_IDX[k], _L1_IDX[k]
            k += 1
            if i0 >= norig or i1 >= norig:
                continue
            c0, c1 = out[i0], out[i1]
            if not (c0[0] & 1) or not (c1[0] & 2):
                continue
            if l0_pocs is not None and l1_pocs is not None \
                    and l0_pocs[c0[3]] == l1_pocs[c1[6]] \
                    and (c0[1], c0[2]) == (c1[4], c1[5]):
                continue
            out.append((3, c0[1], c0[2], c0[3], c1[4], c1[5], c1[6]))
    zero_i = 0
    nmin = min(num_ref0, num_ref1) if num_ref1 > 0 else num_ref0
    while len(out) < max_cand:
        r = zero_i if zero_i < nmin else 0
        if num_ref1 > 0:
            out.append((3, 0, 0, r, 0, 0, r))
        else:
            out.append((1, 0, 0, r, 0, 0, -1))
        zero_i += 1
    return out[:max_cand]


def amvp_candidates_b(field: MvFieldB, order, x0, y0, size,
                      target_list: int, target_ref: int,
                      list_pocs, cur_poc: int, pu_w=None, pu_h=None,
                      col: ColMotionB | None = None, pic_w: int = 0,
                      pic_h: int = 0, log2_ctu: int = 6,
                      col_from_l0: bool = True, check_ldc: bool = False):
    """AMVP for (target_list, target_ref) per fillMvpCand: left pass
    gated on A-PU existence, above unscaled pass, scaled-above appended
    when no A PU; cross-list neighbor usage (same-POC check tries the
    target list then the other, scaling takes the first coded list in
    that order); dedup; TMVP; zero-fill to 2."""
    n = pu_w if pu_w is not None else size
    nh = pu_h if pu_h is not None else size
    tpoc = list_pocs[target_list][target_ref]

    nb_a = [_nb(field, x0 - 1, y0 + nh),        # A0
            _nb(field, x0 - 1, y0 + nh - 1)]    # A1
    nb_b = [_nb(field, x0 + n, y0 - 1),         # B0
            _nb(field, x0 + n - 1, y0 - 1),     # B1
            _nb(field, x0 - 1, y0 - 1)]         # B2
    is_scaled = any(nb is not None for nb in nb_a)

    def parts(nb):
        res = []
        for lx in (target_list, 1 - target_list):
            if nb[0] & (1 << lx) and nb[3 + 3 * lx] >= 0 \
                    and lx < len(list_pocs) and list_pocs[lx]:
                mv = (nb[1 + 3 * lx], nb[2 + 3 * lx])
                ref = min(nb[3 + 3 * lx], len(list_pocs[lx]) - 1)
                res.append((mv, list_pocs[lx][ref]))
        return res

    def unscaled(nbs):
        for nb in nbs:
            if nb is None:
                continue
            for mv, poc in parts(nb):
                if poc == tpoc:
                    return mv
        return None

    def scaled(nbs):
        for nb in nbs:
            if nb is None:
                continue
            ps = parts(nb)
            if ps:
                mv, poc = ps[0]
                return scale_mv(mv, cur_poc - tpoc, cur_poc - poc)
        return None

    out = []
    if is_scaled:
        c = unscaled(nb_a)
        if c is None:
            c = scaled(nb_a)
        if c is not None:
            out.append(c)
    c = unscaled(nb_b)
    if c is not None:
        out.append(c)
    if not is_scaled:
        c = scaled(nb_b)
        if c is not None:
            out.append(c)
    if len(out) == 2 and out[0] == out[1]:
        out = out[:1]
    if len(out) < 2 and col is not None:
        t = temporal_candidate_b(col, x0, y0, n, nh, target_list, tpoc,
                                 cur_poc, pic_w, pic_h, log2_ctu,
                                 col_from_l0, check_ldc)
        if t is not None:
            out.append(t)
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]
