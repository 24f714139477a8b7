"""Reconstruction of 8x8-grid intra pictures and of the intra CUs of
inter pictures, the host closed-loop encode of fixed-8x8 intra pictures,
and `_pad_to`.

The decode-order walk over the uniform 8x8-luma / 4x4-chroma TB grid:
per block, gather references (refsamples), predict (ops.intra numpy
core), (transform and quantise,) dequantise and inverse transform
(ops.transforms), reconstruct. Counterpart of the reference's
TDecCu::xReconIntraQT (TDecCu.cpp:417,657) and of
`tpuhevc/codec/recon.py` (`encode_frame_intra`, 84-188, copied without
its tiles branch: `encoder.check_slice` refuses tiles). The encoder takes
`encode_frame_intra` for fixed-8x8 intra pictures with sign hiding on;
with it off, the device path (`codec/intra_frame.py`) gives the same
decisions, levels and recon.
"""

from __future__ import annotations

import numpy as np

from ..entropy.residual import apply_sign_bit_hiding
from ..ops import transforms as tx
from ..ops.cost import satd_np
from ..ops.intra import predict_block_np
from ..utils.tables import chroma_qp, intra_mpm_list, intra_scan_idx, qp_to_lambda
from .params import EncoderConfig, SeqParams
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


def encode_frame_intra(orig_y, orig_u, orig_v, cfg: EncoderConfig):
    """Closed-loop all-intra encode of one frame on the 8x8 grid.

    Returns (FrameSyntax, (rec_y, rec_u, rec_v)). Mode decision: full
    35-mode SATD on reconstructed references + MPM-aware mode bits
    (the reference's xRecurIntraCodingLumaQT prescreen collapsed to one
    level, SURVEY.md §A.3).
    """
    from ..entropy.syntax import FrameSyntax

    sps, qp = cfg.sps, cfg.qp
    bd = sps.bit_depth
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(orig_y, h, w)
    ou = _pad_to(orig_u, h // 2, w // 2)
    ov = _pad_to(orig_v, h // 2, w // 2)

    fs = FrameSyntax(w, h)
    rec_y = np.zeros((h, w), dtype=np.int32)
    rec_u = np.zeros((h // 2, w // 2), dtype=np.int32)
    rec_v = np.zeros((h // 2, w // 2), dtype=np.int32)
    order = BlockOrder(w, h, sps.log2_ctu)
    qpc = chroma_qp(qp)
    # integer fixed-point mode cost (8.8) so the device path matches
    # bit-exactly
    sqlam_fp = int(round(np.sqrt(qp_to_lambda(qp, cfg.lambda_qp_factor)) * 256))

    for x8, y8 in _decode_order_cells(w // 8, h // 8, order):
        x0, y0 = x8 * 8, y8 * 8
        top, left = gather_refs(rec_y, x0, y0, 8, (x8, y8), order, bd)
        oblk = oy[y0 : y0 + 8, x0 : x0 + 8].astype(np.int32)
        # mode decision: SATD + sqrt(lambda) * mode bits
        left_m = int(fs.luma_mode[y8, x8 - 1]) if x8 > 0 else 1
        above_ok = y8 > 0 and (y0 % sps.ctu_size) != 0
        above_m = int(fs.luma_mode[y8 - 1, x8]) if above_ok else 1
        cand = intra_mpm_list(left_m, above_m)
        best_cost, best_mode = None, 1
        preds = {}
        for mode in range(35):
            pred = predict_block_np(top, left, mode, 8, True, bd,
                                    sps.strong_intra_smoothing)
            preds[mode] = pred
            bits = (2 if mode in cand else 6)
            cost = int(satd_np(oblk, pred)) + ((bits * sqlam_fp) >> 8)
            if best_cost is None or cost < best_cost:
                best_cost, best_mode = cost, mode
        mode = best_mode
        fs.luma_mode[y8, x8] = mode
        fs.chroma_mode[y8, x8] = 4  # DM
        # luma transform/quant/recon
        resi = oblk - preds[mode]
        c = tx.forward_transform_np(resi[None], bd)[0]
        lvl = tx.quantize_np(c[None], qp, 3, bd, True)[0]
        if cfg.pps.sign_data_hiding:
            lvl = apply_sign_bit_hiding(lvl, 3, intra_scan_idx(mode, 3, True),
                                        tx.ideal_levels_np(c, qp, 3, bd))
        fs.coeff_y[y0 : y0 + 8, x0 : x0 + 8] = lvl
        if lvl.any():
            d = tx.dequantize_np(lvl[None], qp, 3, bd)[0]
            r = tx.inverse_transform_np(d[None], bd)[0]
            rec = np.clip(preds[mode] + r, 0, (1 << bd) - 1)
        else:
            rec = preds[mode]
        rec_y[y0 : y0 + 8, x0 : x0 + 8] = rec
        # chroma (DM mode), 4x4 TBs
        for plane, oplane, coeff in ((rec_u, ou, fs.coeff_cb), (rec_v, ov, fs.coeff_cr)):
            cx, cy = x8 * 4, y8 * 4
            ctop, cleft = gather_refs(plane, cx, cy, 4, (x8, y8), order, bd)
            cpred = predict_block_np(ctop, cleft, mode, 4, False, bd, False)
            cresi = oplane[cy : cy + 4, cx : cx + 4].astype(np.int32) - cpred
            cc = tx.forward_transform_np(cresi[None], bd)[0]
            clvl = tx.quantize_np(cc[None], qpc, 2, bd, True)[0]
            if cfg.pps.sign_data_hiding:
                clvl = apply_sign_bit_hiding(
                    clvl, 2, intra_scan_idx(mode, 2, False),
                    tx.ideal_levels_np(cc, qpc, 2, bd))
            coeff[cy : cy + 4, cx : cx + 4] = clvl
            if clvl.any():
                cd = tx.dequantize_np(clvl[None], qpc, 2, bd)[0]
                cr = tx.inverse_transform_np(cd[None], bd)[0]
                crec = np.clip(cpred + cr, 0, (1 << bd) - 1)
            else:
                crec = cpred
            plane[cy : cy + 4, cx : cx + 4] = crec
    return fs, (rec_y, rec_u, rec_v)


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
