"""Decoder-side reconstruction of 8x8-grid intra pictures and of the
intra CUs of inter pictures, and `_pad_to`.

The decode-order walk over the uniform 8x8-luma / 4x4-chroma TB grid:
per block, gather references (refsamples), predict (ops.intra numpy
core), dequantise and inverse transform (ops.transforms), reconstruct.
Counterpart of the reference's TDecCu::xReconIntraQT (TDecCu.cpp:417,657).
The port encodes no such picture (fixed 8x8 intra and intra CUs in P
pictures are refused by `encoder.check_slice`); its decoder reads them.
"""

from __future__ import annotations

import numpy as np

from ..ops import transforms as tx
from ..ops.intra import predict_block_np
from ..utils.tables import chroma_qp
from .params import SeqParams
from .refsamples import BlockOrder, gather_refs


def _decode_order_cells(w8: int, h8: int, order: BlockOrder):
    cells = [(x8, y8) for y8 in range(h8) for x8 in range(w8)]
    cells.sort(key=lambda c: order.order[c[1], c[0]])
    return cells


def _recon_block(plane, coeff, x0, y0, size, mode, cell, order, qp, is_luma,
                 bit_depth, strong_smoothing, is_dst):
    top, left = gather_refs(plane, x0, y0, size, cell, order, bit_depth)
    pred = predict_block_np(top, left, mode, size, is_luma, bit_depth,
                            strong_smoothing)
    blk = coeff[y0 : y0 + size, x0 : x0 + size]
    if blk.any():
        log2 = size.bit_length() - 1
        d = tx.dequantize_np(blk[None], qp, log2, bit_depth)[0]
        r = tx.inverse_transform_np(d[None], bit_depth, is_dst=is_dst)[0]
        rec = np.clip(pred + r, 0, (1 << bit_depth) - 1)
    else:
        rec = pred
    plane[y0 : y0 + size, x0 : x0 + size] = rec


def reconstruct_frame(fs, sps: SeqParams, qp: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FrameSyntax -> (y, u, v) reconstruction (decoder side)."""
    w, h = fs.width, fs.height
    bd = sps.bit_depth
    y = np.zeros((h, w), dtype=np.int32)
    u = np.zeros((h // 2, w // 2), dtype=np.int32)
    v = np.zeros((h // 2, w // 2), dtype=np.int32)
    order = (getattr(fs, "tile_order8", None)
             or BlockOrder(w, h, sps.log2_ctu))
    qpc = chroma_qp(qp)
    sc_chroma = _chroma_mode_resolver(fs)
    for x8, y8 in _decode_order_cells(w // 8, h // 8, order):
        mode = int(fs.luma_mode[y8, x8])
        _recon_block(y, fs.coeff_y, x8 * 8, y8 * 8, 8, mode, (x8, y8), order,
                     qp, True, bd, sps.strong_intra_smoothing, False)
        cmode = sc_chroma(x8, y8)
        _recon_block(u, fs.coeff_cb, x8 * 4, y8 * 4, 4, cmode, (x8, y8),
                     order, qpc, False, bd, False, False)
        _recon_block(v, fs.coeff_cr, x8 * 4, y8 * 4, 4, cmode, (x8, y8),
                     order, qpc, False, bd, False, False)
    return y, u, v


def _chroma_mode_resolver(fs):
    def resolve(x8, y8):
        cm = int(fs.chroma_mode[y8, x8])
        lm = int(fs.luma_mode[y8, x8])
        if cm == 4:
            return lm
        m = (0, 26, 10, 1)[cm]
        return 34 if m == lm else m

    return resolve


def _pad_to(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = plane.shape
    if ph == h and pw == w:
        return plane.astype(np.int32)
    out = np.empty((h, w), dtype=np.int32)
    out[:ph, :pw] = plane
    if pw < w:
        out[:ph, pw:] = plane[:, -1:]
    if ph < h:
        out[ph:, :] = out[ph - 1 : ph, :]
    return out


def reconstruct_intra_cus_inter_frame(fs, sps, qp: int, planes) -> None:
    """Second reconstruction pass for inter frames: intra CUs
    (fs.inter_dir == 0) reconstructed in decode order in-place on the
    already-inter-filled planes (availability still follows decode order,
    so later-in-order samples are never referenced). 8x8 TB granularity
    (what the encoder's intra-in-inter fallback emits)."""
    w, h = fs.width, fs.height
    bd = sps.bit_depth
    order = (getattr(fs, "tile_order8", None)
             or BlockOrder(w, h, sps.log2_ctu))
    qp_ctu = getattr(fs, "qp_ctu", None)
    qp_base, qpc = qp, chroma_qp(qp)
    y, u, v = planes
    resolve = _chroma_mode_resolver(fs)
    for x8, y8 in _decode_order_cells(w // 8, h // 8, order):
        if int(fs.inter_dir[y8, x8]) != 0:
            continue
        if qp_ctu is not None:  # cu_qp_delta: dequant at the CTU's QpY
            qp = int(qp_ctu[(y8 * 8) >> sps.log2_ctu,
                            (x8 * 8) >> sps.log2_ctu])
            qpc = chroma_qp(qp)
        mode = int(fs.luma_mode[y8, x8])
        _recon_block(y, fs.coeff_y, x8 * 8, y8 * 8, 8, mode, (x8, y8),
                     order, qp, True, bd, sps.strong_intra_smoothing, False)
        cmode = resolve(x8, y8)
        _recon_block(u, fs.coeff_cb, x8 * 4, y8 * 4, 4, cmode, (x8, y8),
                     order, qpc, False, bd, False, False)
        _recon_block(v, fs.coeff_cr, x8 * 4, y8 * 4, 4, cmode, (x8, y8),
                     order, qpc, False, bd, False, False)
