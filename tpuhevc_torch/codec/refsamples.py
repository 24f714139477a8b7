"""Intra reference-sample gathering with availability + substitution.

Counterpart of TComPattern::fillReferenceSamples (TComPattern.cpp:51),
implementing H.265 §8.4.4.2.2. Availability follows decode order (CTU
raster, z-order of 8x8 cells within a CTU) — shared by the encoder's
closed-loop reconstruction and the decoder so the two cannot diverge.
"""

from __future__ import annotations

import numpy as np


def morton(cx: int, cy: int, bits: int = 3) -> int:
    """Z-order index of an 8x8 cell within a 64x64 CTU."""
    m = 0
    for b in range(bits - 1, -1, -1):
        m = (m << 2) | (((cy >> b) & 1) << 1) | ((cx >> b) & 1)
    return m


class BlockOrder:
    """Decode-order indexing of the cell grid of a frame (cells of
    2^cell_log2 luma samples; 8 for the encoder's TB grid, 4 for the
    general decoder's PU/TU granularity)."""

    def __init__(self, width: int, height: int, log2_ctu: int = 6,
                 cell_log2: int = 3, ctu_rank=None, slice_min=None):
        """ctu_rank: per-raster-CTU coding-order rank (tile scan); default
        raster order. slice_min: per-cell first-rank of the cell's slice
        segment — availability additionally requires the neighbor's rank
        to reach the CURRENT cell's slice start (tiles / multi-slice)."""
        c = cell_log2
        self.w8 = width >> c
        self.h8 = height >> c
        self.log2_ctu = log2_ctu
        self.cells_per_ctu_side = 1 << (log2_ctu - c)
        self.wctu = (width + (1 << log2_ctu) - 1) >> log2_ctu
        order = np.empty((self.h8, self.w8), dtype=np.int64)
        per_ctu = self.cells_per_ctu_side ** 2
        for y8 in range(self.h8):
            for x8 in range(self.w8):
                ctu = (y8 // self.cells_per_ctu_side) * self.wctu + (
                    x8 // self.cells_per_ctu_side
                )
                if ctu_rank is not None:
                    ctu = int(ctu_rank[ctu])
                z = morton(x8 % self.cells_per_ctu_side,
                           y8 % self.cells_per_ctu_side,
                           log2_ctu - c)
                order[y8, x8] = ctu * per_ctu + z
        self.order = order
        self.slice_min = slice_min  # (h8, w8) int64 ranks, or None

    def precedes(self, x8: int, y8: int, cur_x8: int, cur_y8: int) -> bool:
        if x8 < 0 or y8 < 0 or x8 >= self.w8 or y8 >= self.h8:
            return False
        if self.order[y8, x8] >= self.order[cur_y8, cur_x8]:
            return False
        if self.slice_min is not None and (
                self.order[y8, x8] < self.slice_min[cur_y8, cur_x8]):
            return False
        return True


def gather_refs(plane: np.ndarray, x0: int, y0: int, size: int,
                cell: tuple[int, int], order: BlockOrder,
                bit_depth: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Build (top, left) reference arrays of length 2S+1 (corner at index 0)
    for a TB at (x0, y0) in `plane`, with availability + substitution.

    cell = (x8, y8) of the containing 8x8 luma cell; neighbor availability is
    evaluated in 8x8-cell decode order (the TB grid this framework emits).
    Segment granularity: `size`-sample runs each lying in one neighbor cell.
    """
    s = size
    h, w = plane.shape
    x8, y8 = cell
    p = plane.astype(np.int32)

    # segment availability, in substitution scan order:
    # [left-below, left, corner, top, top-right]
    # NOTE: valid while each run lies in ONE neighbor cell (true for the
    # 8x8-luma / 4x4-chroma TB grid); larger TBs need per-8-sample runs.
    av_lb = order.precedes(x8 - 1, y8 + 1, x8, y8)
    av_l = order.precedes(x8 - 1, y8, x8, y8)
    av_c = order.precedes(x8 - 1, y8 - 1, x8, y8)
    av_t = order.precedes(x8, y8 - 1, x8, y8)
    av_tr = order.precedes(x8 + 1, y8 - 1, x8, y8)

    # sample values (clamped reads; masked by availability afterwards)
    def col(px, py, n):
        py = min(py, h - 1)
        end = min(py + n, h)
        out = np.empty(n, dtype=np.int32)
        m = end - py
        out[:m] = p[py:end, px] if m > 0 else 0
        if m < n:
            out[m:] = out[m - 1] if m > 0 else 0
        return out

    def row(px, py, n):
        end = min(px + n, w)
        out = np.empty(n, dtype=np.int32)
        m = end - px
        out[:m] = p[py, px:end] if m > 0 else 0
        if m < n:
            out[m:] = out[m - 1] if m > 0 else 0
        return out

    # left-below samples beyond the picture bottom are unavailable
    if y0 + 2 * s > h:
        av_lb = False
    if x0 + 2 * s > w:
        av_tr = False

    segs = []
    segs.append((av_lb, col(x0 - 1, y0 + s, s)[::-1] if av_lb else None))   # bottom-most first
    segs.append((av_l, col(x0 - 1, y0, s)[::-1] if av_l else None))
    segs.append((av_c, np.array([p[y0 - 1, x0 - 1]], dtype=np.int32) if av_c else None))
    segs.append((av_t, row(x0, y0 - 1, s) if av_t else None))
    segs.append((av_tr, row(x0 + s, y0 - 1, s) if av_tr else None))

    if not any(a for a, _ in segs):
        fill = 1 << (bit_depth - 1)
        top = np.full(2 * s + 1, fill, dtype=np.int32)
        left = np.full(2 * s + 1, fill, dtype=np.int32)
        return top, left

    # substitution scan (bottom-left -> corner -> top-right)
    lengths = [s, s, 1, s, s]
    vals = []
    for (a, v), ln in zip(segs, lengths):
        vals.append(v if a else np.full(ln, -1, dtype=np.int32))
    arr = np.concatenate(vals)
    # forward fill; leading unavailable take first available
    first_av = np.argmax(arr >= 0)
    if arr[0] < 0:
        arr[:first_av] = arr[first_av]
    for i in range(1, len(arr)):
        if arr[i] < 0:
            arr[i] = arr[i - 1]

    # unpack: arr = [left reversed (2s), corner, top (2s)]
    left_rev = arr[: 2 * s]
    corner = arr[2 * s]
    toprow = arr[2 * s + 1 :]
    top = np.concatenate([[corner], toprow])
    left = np.concatenate([[corner], left_rev[::-1]])
    return top, left


def gather_refs_qt(plane: np.ndarray, x0: int, y0: int, size: int,
                   order: BlockOrder, bit_depth: int = 8,
                   cell_px: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """General (top, left) reference build for a TB of any size at
    (x0, y0): availability evaluated per cell-sized sub-run, the full
    §8.4.4.2.2 substitution scan over 4s+1 samples. `cell_px` = samples
    per availability cell in this plane (8 luma, 4 chroma for 4:2:0 —
    both map to the same 8x8-luma decode-order grid).

    For size == cell_px this reduces exactly to gather_refs.
    """
    s = size
    h, w = plane.shape
    p = plane
    cx8, cy8 = x0 // cell_px, y0 // cell_px  # top-left cell of this TB
    nrun = s // cell_px

    def prec(nx8, ny8):
        return order.precedes(nx8, ny8, cx8, cy8)

    def col(px, py, n):
        py2 = min(py, h - 1)
        end = min(py2 + n, h)
        out = np.empty(n, dtype=np.int32)
        m = end - py2
        if m > 0:
            out[:m] = p[py2:end, px]
        if m < n:
            out[m:] = out[m - 1] if m > 0 else 0
        return out

    def row(px, py, n):
        end = min(px + n, w)
        out = np.empty(n, dtype=np.int32)
        m = end - px
        if m > 0:
            out[:m] = p[py, px:end]
        if m < n:
            out[m:] = out[m - 1] if m > 0 else 0
        return out

    # subruns in substitution scan order (bottom-left upward, corner,
    # top rightward), each of cell_px samples
    subs: list[tuple[bool, np.ndarray | None, int]] = []
    # left-below: rows y0+s .. y0+2s-1, bottom-most cell first
    for j in range(nrun - 1, -1, -1):
        ny8 = cy8 + (s // cell_px) + j
        a = prec(cx8 - 1, ny8) and (y0 + s + j * cell_px) < h
        subs.append((a, col(x0 - 1, y0 + s + j * cell_px,
                            cell_px)[::-1] if a else None, cell_px))
    # left: rows y0 .. y0+s-1, bottom cell first (reversed layout)
    for j in range(nrun - 1, -1, -1):
        a = prec(cx8 - 1, cy8 + j)
        subs.append((a, col(x0 - 1, y0 + j * cell_px,
                            cell_px)[::-1] if a else None, cell_px))
    # corner
    a = prec(cx8 - 1, cy8 - 1)
    subs.append((a, np.array([p[y0 - 1, x0 - 1]], dtype=np.int32)
                 if a else None, 1))
    # top: cols x0 .. x0+s-1
    for j in range(nrun):
        a = prec(cx8 + j, cy8 - 1)
        subs.append((a, row(x0 + j * cell_px, y0 - 1,
                            cell_px) if a else None, cell_px))
    # top-right: cols x0+s .. x0+2s-1
    for j in range(nrun):
        nx8 = cx8 + nrun + j
        a = prec(nx8, cy8 - 1) and (x0 + s + j * cell_px) < w
        subs.append((a, row(x0 + s + j * cell_px, y0 - 1,
                            cell_px) if a else None, cell_px))

    if not any(a for a, _, _ in subs):
        fill = 1 << (bit_depth - 1)
        top = np.full(2 * s + 1, fill, dtype=np.int32)
        left = np.full(2 * s + 1, fill, dtype=np.int32)
        return top, left

    vals = [v if a else np.full(ln, -1, dtype=np.int32)
            for a, v, ln in subs]
    arr = np.concatenate(vals)
    first_av = int(np.argmax(arr >= 0))
    if arr[0] < 0:
        arr[:first_av] = arr[first_av]
    for i in range(1, len(arr)):
        if arr[i] < 0:
            arr[i] = arr[i - 1]

    left_rev = arr[: 2 * s]
    corner = arr[2 * s]
    toprow = arr[2 * s + 1 :]
    top = np.concatenate([[corner], toprow])
    left = np.concatenate([[corner], left_rev[::-1]])
    return top, left
