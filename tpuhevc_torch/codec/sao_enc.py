"""SAO encoder: per-CTU statistics -> RD-optimal type/offset decision with
merge-left/up evaluation.

Counterpart of TEncSampleAdaptiveOffset.{h,cpp} (getBlkStats :334,
deriveModeNewRDO :601, decideBlkParams :798 — SURVEY.md §2.2). The
distortion model is HM's estSaoDist: dD = count*h^2 - 2*h*diffSum (exact
for an added offset h), lambda-weighted against an estimated bit count.

Decisions are made in raster CTU order so merge-left/up candidates are the
already-decided params, exactly like the decoder's reconstruction order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import sao as sao_ops
from ..ops.sao import SAO_BO, SAO_OFF


@dataclass
class SaoPicParams:
    """Per-CTU coded SAO decisions for one picture."""

    ny: int
    nx: int
    luma_on: bool = True
    chroma_on: bool = True
    # coded representation
    merge: np.ndarray = None       # (ny, nx) 0=new/off, 1=left, 2=up
    type_y: np.ndarray = None      # (ny, nx) SAO_OFF / 0..3 EO / 4 BO
    aux_y: np.ndarray = None       # band position (BO) per CTU
    off_y: np.ndarray = None       # (ny, nx, 4) coded offsets
    type_c: np.ndarray = None      # shared Cb/Cr type
    aux_cb: np.ndarray = None
    aux_cr: np.ndarray = None
    off_cb: np.ndarray = None
    off_cr: np.ndarray = None

    def __post_init__(self):
        z = lambda *s: np.zeros(s, np.int32)  # noqa: E731
        if self.merge is None:
            self.merge = z(self.ny, self.nx)
        for f, v in (("type_y", SAO_OFF), ("type_c", SAO_OFF)):
            if getattr(self, f) is None:
                setattr(self, f, np.full((self.ny, self.nx), v, np.int32))
        for f in ("aux_y", "aux_cb", "aux_cr"):
            if getattr(self, f) is None:
                setattr(self, f, z(self.ny, self.nx))
        for f in ("off_y", "off_cb", "off_cr"):
            if getattr(self, f) is None:
                setattr(self, f, z(self.ny, self.nx, 4))

    def resolve(self):
        """Merge-resolved per-CTU params (what apply_sao_plane consumes).
        Shared by encoder and decoder (reconstructBlkSAOParam
        TComSampleAdaptiveOffset.cpp:248)."""
        ty = self.type_y.copy()
        ay = self.aux_y.copy()
        oy = self.off_y.copy()
        tc = self.type_c.copy()
        acb, acr = self.aux_cb.copy(), self.aux_cr.copy()
        ocb, ocr = self.off_cb.copy(), self.off_cr.copy()
        for y in range(self.ny):
            for x in range(self.nx):
                m = int(self.merge[y, x])
                if m == 0:
                    continue
                sy, sx = (y, x - 1) if m == 1 else (y - 1, x)
                ty[y, x], ay[y, x], oy[y, x] = ty[sy, sx], ay[sy, sx], oy[sy, sx]
                tc[y, x] = tc[sy, sx]
                acb[y, x], ocb[y, x] = acb[sy, sx], ocb[sy, sx]
                acr[y, x], ocr[y, x] = acr[sy, sx], ocr[sy, sx]
        if not self.luma_on:
            ty = np.full_like(ty, SAO_OFF)
        if not self.chroma_on:
            tc = np.full_like(tc, SAO_OFF)
        return dict(type_y=ty, aux_y=ay, off_y=oy, type_c=tc,
                    aux_cb=acb, off_cb=ocb, aux_cr=acr, off_cr=ocr)


def _best_offset(count, s, lam_fp, max_off=7, sign=1):
    """RD-best offset magnitude in [0, max_off] for one class.
    count/s: pixel count and sum(org-rec); sign: +1 classes add, -1
    subtract. Returns (offset_magnitude, rd_cost_fp8) where cost is
    dD*256 + lam_fp*bits."""
    if count == 0:
        return 0, lam_fp
    start = int(min(max_off, max(0, round(sign * s / count))))
    best_o, best_c = 0, lam_fp  # o = 0 still costs one TR bin
    for o in range(start, 0, -1):
        h = sign * o
        d = count * h * h - 2 * h * s  # estSaoDist
        bits = o + 1  # TR-code-ish length estimate
        c = d * 256 + lam_fp * bits
        if c < best_c:
            best_o, best_c = o, c
    return best_o, best_c


def _eval_eo(stats, ty, tx, klass, lam_fp):
    offs = np.zeros(4, np.int32)
    cost = 0
    for cat in range(4):
        sign = 1 if cat < 2 else -1
        o, c = _best_offset(int(stats["eo_count"][ty, tx, klass, cat]),
                            int(stats["eo_sum"][ty, tx, klass, cat]),
                            lam_fp, sign=sign)
        offs[cat] = o
        cost += c
    return offs, cost + lam_fp * 2  # eo_class bits


def _eval_bo(stats, ty, tx, lam_fp):
    cnt = stats["bo_count"][ty, tx]
    sm = stats["bo_sum"][ty, tx]
    per_band = []
    for b in range(32):
        c, n = int(cnt[b]), int(sm[b])
        bo, bc = 0, lam_fp  # o = 0 still costs one TR bin
        if c:
            start = int(np.clip(round(n / c), -7, 7))
            sgn = 1 if start > 0 else -1
            for m in range(abs(start), 0, -1):
                o = sgn * m
                d = c * o * o - 2 * o * n
                bits = m + 2  # TR bins + sign bin
                cc = d * 256 + lam_fp * bits
                if cc < bc:
                    bo, bc = o, cc
        per_band.append((bo, bc))
    best_pos, best_off = 0, np.zeros(4, np.int32)
    best_cost = 1 << 62
    for pos in range(29):  # HM searches 0..28 (no wrap)
        cost = sum(per_band[pos + i][1] for i in range(4))
        if cost < best_cost:
            best_cost = cost
            best_pos = pos
            best_off = np.array([per_band[pos + i][0] for i in range(4)],
                                np.int32)
    return best_off, best_pos, best_cost + lam_fp * 5  # band_position bits


def _dist_with(stats, ty, tx, t, aux, off4):
    """Exact estimated dD of applying params (t, aux, off4) on this CTU."""
    if t == SAO_OFF:
        return 0
    d = 0
    if t == SAO_BO:
        for i in range(4):
            b = (aux + i) % 32
            h = int(off4[i])
            d += (int(stats["bo_count"][ty, tx, b]) * h * h
                  - 2 * h * int(stats["bo_sum"][ty, tx, b]))
    else:
        for cat in range(4):
            h = int(off4[cat]) * (1 if cat < 2 else -1)
            d += (int(stats["eo_count"][ty, tx, t, cat]) * h * h
                  - 2 * h * int(stats["eo_sum"][ty, tx, t, cat]))
    return d


def decide_sao_params(org, rec, ctu: int, qp: int, bit_depth: int = 8,
                      lam: float | None = None) -> SaoPicParams:
    """org/rec: (y, u, v) planes (rec = post-deblock). Returns coded
    per-CTU decisions."""
    from ..utils.tables import qp_to_lambda

    if lam is None:
        lam = qp_to_lambda(qp, 0.4624)
    lam_fp = int(round(lam * 256))
    h, w = rec[0].shape
    ny = (h + ctu - 1) // ctu
    nx = (w + ctu - 1) // ctu
    st = [sao_ops.collect_stats(org[i], rec[i], ctu if i == 0 else ctu // 2,
                                bit_depth) for i in range(3)]
    pp = SaoPicParams(ny, nx)

    def new_mode(stats, ty, tx, type_bits_fp):
        """Best (type, aux, off4, cost) among OFF / EO0-3 / BO."""
        best = (SAO_OFF, 0, np.zeros(4, np.int32))
        best_cost = lam_fp  # OFF: ~1 bit for type
        for klass in range(4):
            offs, c = _eval_eo(stats, ty, tx, klass, lam_fp)
            c += type_bits_fp
            if c < best_cost:
                best_cost = c
                best = (klass, 0, offs)
        offs, pos, c = _eval_bo(stats, ty, tx, lam_fp)
        c += type_bits_fp
        if c < best_cost:
            best_cost = c
            best = (SAO_BO, pos, offs)
        return best, best_cost

    for ty in range(ny):
        for tx in range(nx):
            # new-mode RD per component (chroma shares the type)
            (t_y, aux_y, off_yv), cost_y = new_mode(st[0], ty, tx, 2 * lam_fp)
            # chroma: pick the shared type minimizing joint cost
            best_c = (SAO_OFF, 0, np.zeros(4, np.int32),
                      0, np.zeros(4, np.int32))
            best_c_cost = lam_fp
            for klass in range(4):
                ob, cb = _eval_eo(st[1], ty, tx, klass, lam_fp)
                orr, cr = _eval_eo(st[2], ty, tx, klass, lam_fp)
                c = cb + cr - lam_fp * 2 + 2 * lam_fp  # one eo_class coded
                if c < best_c_cost:
                    best_c_cost = c
                    best_c = (klass, 0, ob, 0, orr)
            ob, pb, cb = _eval_bo(st[1], ty, tx, lam_fp)
            orr, pr, cr = _eval_bo(st[2], ty, tx, lam_fp)
            c = cb + cr + 2 * lam_fp
            if c < best_c_cost:
                best_c_cost = c
                best_c = (SAO_BO, pb, ob, pr, orr)
            new_cost = cost_y + best_c_cost

            # merge candidates: cost of reusing the already-decided params
            res = pp.resolve()  # small grids; fine to recompute
            cands = []
            if tx > 0:
                cands.append((1, ty, tx - 1))
            if ty > 0:
                cands.append((2, ty - 1, tx))
            merge_best = None
            for mcode, sy, sx in cands:
                d = (_dist_with(st[0], ty, tx, int(res["type_y"][sy, sx]),
                                int(res["aux_y"][sy, sx]), res["off_y"][sy, sx])
                     + _dist_with(st[1], ty, tx, int(res["type_c"][sy, sx]),
                                  int(res["aux_cb"][sy, sx]),
                                  res["off_cb"][sy, sx])
                     + _dist_with(st[2], ty, tx, int(res["type_c"][sy, sx]),
                                  int(res["aux_cr"][sy, sx]),
                                  res["off_cr"][sy, sx]))
                c = d * 256 + lam_fp  # one merge flag
                if merge_best is None or c < merge_best[0]:
                    merge_best = (c, mcode)
            if merge_best is not None and merge_best[0] < new_cost:
                pp.merge[ty, tx] = merge_best[1]
            else:
                pp.merge[ty, tx] = 0
                pp.type_y[ty, tx] = t_y
                pp.aux_y[ty, tx] = aux_y
                pp.off_y[ty, tx] = off_yv
                pp.type_c[ty, tx] = best_c[0]
                pp.aux_cb[ty, tx] = best_c[1]
                pp.off_cb[ty, tx] = best_c[2]
                pp.aux_cr[ty, tx] = best_c[3]
                pp.off_cr[ty, tx] = best_c[4]
    return pp


def apply_sao_picture(rec, pp: SaoPicParams, ctu: int, bit_depth: int = 8):
    """rec: (y, u, v) post-deblock planes -> post-SAO planes."""
    res = pp.resolve()
    y = sao_ops.apply_sao_plane(rec[0], res["type_y"], res["aux_y"],
                                res["off_y"], ctu, bit_depth)
    u = sao_ops.apply_sao_plane(rec[1], res["type_c"], res["aux_cb"],
                                res["off_cb"], ctu // 2, bit_depth)
    v = sao_ops.apply_sao_plane(rec[2], res["type_c"], res["aux_cr"],
                                res["off_cr"], ctu // 2, bit_depth)
    return y, u, v
