"""Sample Adaptive Offset: classification, statistics, and application.

Counterpart of TComSampleAdaptiveOffset.{h,cpp} (offsetBlock
TComSampleAdaptiveOffset.cpp:313, offsetCTU :554, SAOProcess :614 —
SURVEY.md §2.1 "SAO (common)") per H.265 §8.7.3. TPU-first restructuring:
classification runs on the whole plane at once (one vectorized pass per EO
class) and per-CTU statistics fall out as masked tile reductions, instead
of HM's per-CTU line loops.

Boundary semantics: with one slice and loop filtering across boundaries,
every interior CTU edge is available; only PICTURE border pixels are
excluded from EO (the first/last row/column of the frame for the classes
whose neighbor would fall outside), matching offsetBlock's startX/endX
logic in that configuration.

Conventions (match the bitstream): EO offsets arrive as the coded 4-tuple
[o_valley, o_half_valley, o_half_peak, o_full_peak]; categories 1/2 add,
3/4 subtract (TDecSbac.cpp:1818-1823). BO: offsets apply to 4 consecutive
bands from band_pos (mod 32), signed as coded.
"""

from __future__ import annotations

import numpy as np

SAO_OFF = -1
SAO_EO_0 = 0   # horizontal
SAO_EO_90 = 1  # vertical
SAO_EO_135 = 2
SAO_EO_45 = 3
SAO_BO = 4

# neighbor offsets (dy, dx) per EO class
EO_NEIGHBORS = {
    SAO_EO_0: ((0, -1), (0, 1)),
    SAO_EO_90: ((-1, 0), (1, 0)),
    SAO_EO_135: ((-1, -1), (1, 1)),
    SAO_EO_45: ((-1, 1), (1, -1)),
}


def eo_category(plane: np.ndarray, eo_class: int):
    """(category map (H, W) int in 0..4, valid mask). Category 0 = plain
    (no offset); 1=full valley, 2=half valley, 3=half peak, 4=full peak."""
    p = plane.astype(np.int32)
    h, w = p.shape
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[eo_class]

    def shifted(dy, dx):
        return np.pad(p, ((max(dy, 0), max(-dy, 0)),
                          (max(dx, 0), max(-dx, 0))),
                      mode="edge")[max(-dy, 0) : max(-dy, 0) + h,
                                   max(-dx, 0) : max(-dx, 0) + w]

    # shifted(dy,dx) gives neighbor at (y-dy, x-dx); we need (y+dy, x+dx)
    n0 = shifted(-dy0, -dx0)
    n1 = shifted(-dy1, -dx1)
    et = np.sign(p - n0) + np.sign(p - n1)  # [-2, 2]
    cat = np.array([1, 2, 0, 3, 4], dtype=np.int8)[et + 2]
    valid = np.ones((h, w), dtype=bool)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dx < 0:
            valid[:, 0] = False
        if dx > 0:
            valid[:, -1] = False
        if dy < 0:
            valid[0, :] = False
        if dy > 0:
            valid[-1, :] = False
    return cat, valid


def bo_band(plane: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    return (plane.astype(np.int32) >> (bit_depth - 5))


def collect_stats(org: np.ndarray, rec: np.ndarray, ctu: int,
                  bit_depth: int = 8):
    """Per-CTU SAO statistics on one component plane.

    Returns dict with:
      eo_count, eo_sum: (nctu_y, nctu_x, 4 classes, 4 categories)
      bo_count, bo_sum: (nctu_y, nctu_x, 32 bands)
    where sum is sum(org - rec) over the pixels in that bin (the offset
    that would zero the mean error), count the pixel count.
    """
    h, w = rec.shape
    ny = (h + ctu - 1) // ctu
    nx = (w + ctu - 1) // ctu
    diff = org.astype(np.int64) - rec.astype(np.int64)
    cy = np.minimum(np.arange(h) // ctu, ny - 1)
    cx = np.minimum(np.arange(w) // ctu, nx - 1)
    ctu_idx = (cy[:, None] * nx + cx[None, :]).ravel()
    eo_count = np.zeros((ny * nx, 4, 4), np.int64)
    eo_sum = np.zeros((ny * nx, 4, 4), np.int64)
    for klass in range(4):
        cat, valid = eo_category(rec, klass)
        for c in range(1, 5):
            m = ((cat == c) & valid).ravel()
            eo_count[:, klass, c - 1] = np.bincount(
                ctu_idx[m], minlength=ny * nx)
            eo_sum[:, klass, c - 1] = np.bincount(
                ctu_idx[m], weights=diff.ravel()[m], minlength=ny * nx)
    band = bo_band(rec, bit_depth).ravel()
    bo_count = np.zeros((ny * nx, 32), np.int64)
    bo_sum = np.zeros((ny * nx, 32), np.int64)
    comb = ctu_idx * 32 + band
    bo_count.reshape(-1)[:] = np.bincount(comb, minlength=ny * nx * 32)
    bo_sum.reshape(-1)[:] = np.bincount(comb, weights=diff.ravel(),
                                        minlength=ny * nx * 32)
    return dict(eo_count=eo_count.reshape(ny, nx, 4, 4),
                eo_sum=eo_sum.reshape(ny, nx, 4, 4),
                bo_count=bo_count.reshape(ny, nx, 32),
                bo_sum=bo_sum.reshape(ny, nx, 32))


def apply_sao_plane(rec: np.ndarray, types, aux, offsets, ctu: int,
                    bit_depth: int = 8) -> np.ndarray:
    """Apply per-CTU SAO params to one plane.

    types: (ny, nx) int, SAO_OFF / EO class 0..3 / SAO_BO
    aux:   (ny, nx) int, band_position for BO (ignored for EO)
    offsets: (ny, nx, 4) int, coded-order offsets
    """
    h, w = rec.shape
    maxv = (1 << bit_depth) - 1
    out = rec.copy()
    types = np.asarray(types)
    ny, nx = types.shape
    # full-plane category maps once per EO class that is actually used
    cat_maps = {}
    for klass in range(4):
        if (types == klass).any():
            cat_maps[klass] = eo_category(rec, klass)
    band_map = bo_band(rec, bit_depth) if (types == SAO_BO).any() else None
    for ty in range(ny):
        for tx in range(nx):
            t = int(types[ty, tx])
            if t == SAO_OFF:
                continue
            y0, x0 = ty * ctu, tx * ctu
            y1, x1 = min(y0 + ctu, h), min(x0 + ctu, w)
            off4 = offsets[ty, tx]
            blk = rec[y0:y1, x0:x1].astype(np.int32)
            if t == SAO_BO:
                lut = np.zeros(32, np.int32)
                for i in range(4):
                    lut[(int(aux[ty, tx]) + i) % 32] = off4[i]
                res = blk + lut[band_map[y0:y1, x0:x1]]
            else:
                cat, valid = cat_maps[t]
                lut = np.array([0, off4[0], off4[1], -off4[2], -off4[3]],
                               np.int32)
                add = np.where(valid[y0:y1, x0:x1],
                               lut[cat[y0:y1, x0:x1]], 0)
                res = blk + add
            out[y0:y1, x0:x1] = np.clip(res, 0, maxv)
    return out
