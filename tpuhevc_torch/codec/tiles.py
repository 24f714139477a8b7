"""Tile geometry (§6.5.1) + slice-segment spans: uniform-spacing tile
grid, the tile-scan CTU coding order, and the CTU spans of a picture's
independent slice segments (one per tile, or fixed-CTU-count slices).

Counterpart of the reference's TComPicSym tile maps
(TComPicSym.cpp:501 initTiles / CtuTsToRsAddrMap) and TEncSlice's
slice boundary determination (TEncSlice.cpp:650): boundaries follow
the (i * size) / n uniform split, CTUs are coded raster-inside-tile
with tiles in raster order.
"""

from __future__ import annotations

import numpy as np


def tile_bounds(n_ctus: int, n_tiles: int) -> list[int]:
    """Uniform boundaries: [0, ..., n_ctus] with n_tiles spans."""
    return [(i * n_ctus) // n_tiles for i in range(n_tiles + 1)]


def tile_layout(sps, pps):
    """Returns (order, tile_of, spans):
    - order: CTU raster-scan addresses in tile-scan coding order
    - tile_of: per-CTU (raster index) tile id
    - spans: per tile, the list of its CTU raster addresses (in coding
      order) — one slice segment per tile uses spans directly."""
    wc, hc = sps.pic_width_in_ctus, sps.pic_height_in_ctus
    nc = pps.num_tile_columns if pps.tiles_enabled else 1
    nr = pps.num_tile_rows if pps.tiles_enabled else 1
    col_bd = tile_bounds(wc, nc)
    row_bd = tile_bounds(hc, nr)
    order = []
    tile_of = np.zeros(wc * hc, np.int32)
    spans = []
    tid = 0
    for tr in range(nr):
        for tc in range(nc):
            span = []
            for cy in range(row_bd[tr], row_bd[tr + 1]):
                for cx in range(col_bd[tc], col_bd[tc + 1]):
                    rs = cy * wc + cx
                    order.append(rs)
                    tile_of[rs] = tid
                    span.append(rs)
            spans.append(span)
            tid += 1
    return order, tile_of, spans


def segment_spans(sps, pps, slice_ctus: int = 0):
    """CTU spans (raster addresses, in coding order) of the picture's
    independent slice segments. Tiles on -> one segment per tile
    (tile-scan inside). Else slice_ctus > 0 -> fixed-size raster chunks
    (HM SliceMode=1 / SliceArgument). Else one whole-picture segment."""
    if pps.tiles_enabled:
        _, _, spans = tile_layout(sps, pps)
        return spans
    nctu = sps.pic_width_in_ctus * sps.pic_height_in_ctus
    if slice_ctus and slice_ctus > 0:
        return [list(range(s, min(s + slice_ctus, nctu)))
                for s in range(0, nctu, slice_ctus)]
    return [list(range(nctu))]


def seg_of_ctu(sps, spans) -> np.ndarray:
    """Per-raster-CTU segment id."""
    nctu = sps.pic_width_in_ctus * sps.pic_height_in_ctus
    seg = np.zeros(nctu, np.int32)
    for sid, span in enumerate(spans):
        for rs in span:
            seg[rs] = sid
    return seg


def spans_block_order(sps, spans, cell_log2: int = 3):
    """BlockOrder for a picture partitioned into independent slice
    segments `spans` (each a list of raster CTU addresses, concatenated
    = the coding order): per-cell slice_min ranks gate reference/
    candidate availability at segment boundaries (§6.4.1 — a neighbor
    in a different slice segment or tile is unavailable)."""
    from .refsamples import BlockOrder

    w, h = sps.coded_width, sps.coded_height
    if len(spans) == 1 and spans[0] == list(range(len(spans[0]))):
        return BlockOrder(w, h, sps.log2_ctu, cell_log2)
    nctu = sum(len(s) for s in spans)
    ctu_rank = np.empty(nctu, np.int64)
    first_rank = np.empty(nctu, np.int64)  # per raster CTU: its
    rank = 0                               # segment's first coding rank
    for span in spans:
        start = rank
        for rs in span:
            ctu_rank[rs] = rank
            first_rank[rs] = start
            rank += 1
    c = cell_log2
    per_ctu = (1 << (sps.log2_ctu - c)) ** 2
    w8, h8 = w >> c, h >> c
    cells_side = 1 << (sps.log2_ctu - c)
    wc = sps.pic_width_in_ctus
    slice_min = np.empty((h8, w8), np.int64)
    for y8 in range(h8):
        rs_row = (y8 // cells_side) * wc
        for x8 in range(w8):
            slice_min[y8, x8] = first_rank[rs_row + x8 // cells_side] \
                * per_ctu
    return BlockOrder(w, h, sps.log2_ctu, c, ctu_rank=ctu_rank,
                      slice_min=slice_min)


def block_order_for(sps, pps, cell_log2: int = 3, slice_ctus: int = 0):
    """BlockOrder following the picture's slice-segment structure (one
    segment per tile with tiles, fixed-CTU-count slices otherwise)."""
    return spans_block_order(sps, segment_spans(sps, pps, slice_ctus),
                             cell_log2)
