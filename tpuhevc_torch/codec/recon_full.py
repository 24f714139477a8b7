"""General-stream reconstruction: decodes pictures using the full parsed
feature set (TU quadtree below the CU, NxN intra PUs, 64 intra CUs,
transform skip) rather than this encoder's TU = CU subset.

Counterpart of the reference's TDecCu::xReconIntraQT (TDecCu.cpp:417,657)
walking the recorded fs.tu_log2 / fs.luma_mode4 maps in decode order.
Availability is evaluated at 4x4 luma granularity (the spec's minimum
block grid), so TBs inside a CU see earlier TBs' reconstruction.
"""

from __future__ import annotations

import numpy as np

from ..ops import transforms as tx
from ..ops.intra import predict_block_np
from ..utils.tables import chroma_qp, intra_scan_idx  # noqa: F401
from .refsamples import BlockOrder, gather_refs_qt


def _inv_ts(d: np.ndarray, bd: int) -> np.ndarray:
    """Transform-skip inverse (§8.6.4.2): r = (d << 7 + rnd) >> bdShift."""
    bdshift = 20 - bd
    return ((d.astype(np.int64) << 7) + (1 << (bdshift - 1))) >> bdshift


def _recon_tb(plane, coeff_pl, x0, y0, size, mode, order, qp, is_luma,
              bd, strong, cell_px, is_dst, ts, m=None):
    top, left = gather_refs_qt(plane, x0, y0, size, order, bd, cell_px)
    pred = predict_block_np(top, left, mode, size, is_luma, bd, strong)
    blk = coeff_pl[y0 : y0 + size, x0 : x0 + size]
    if blk.any():
        log2 = size.bit_length() - 1
        d = tx.dequantize_np(blk[None], qp, log2, bd, m=m)[0]
        if ts:
            r = _inv_ts(d, bd)
        else:
            r = tx.inverse_transform_np(d[None], bd, is_dst=is_dst)[0]
        rec = np.clip(pred + r, 0, (1 << bd) - 1)
    else:
        rec = pred
    plane[y0 : y0 + size, x0 : x0 + size] = rec


def reconstruct_frame_full(fs, sps, qp: int):
    """I-slice reconstruction honoring fs.tu_log2/luma_mode4/ts maps."""
    w, h = fs.width, fs.height
    bd = sps.bit_depth
    y = np.zeros((h, w), np.int32)
    u = np.zeros((h // 2, w // 2), np.int32)
    v = np.zeros((h // 2, w // 2), np.int32)
    order4 = (getattr(fs, "tile_order4", None)
              or BlockOrder(w, h, sps.log2_ctu, cell_log2=2))
    order8 = (getattr(fs, "tile_order8", None)
              or BlockOrder(w, h, sps.log2_ctu))  # chroma 4-sample cells
    qpc = chroma_qp(qp)
    sl_on = getattr(sps, "scaling_list_enabled", False)

    def m_of(log2, intra):
        return (tx.default_scaling_matrix(log2, intra) if sl_on else None)

    from .intra_qt import _cu_roots

    resolve = _chroma_resolver(fs)

    def luma_tb(x0, y0, log2):
        mode = int(fs.luma_mode4[y0 // 4, x0 // 4])
        ts = log2 == 2 and bool(fs.ts_y[y0 // 4, x0 // 4])
        _recon_tb(y, fs.coeff_y, x0, y0, 1 << log2, mode, order4, qp,
                  True, bd, sps.strong_intra_smoothing, 4,
                  is_dst=(log2 == 2), ts=ts, m=m_of(log2, True))

    def chroma_tb(x0, y0, clog2, cmode_actual):
        cs = 1 << clog2
        cx, cy = x0 // 2, y0 // 2
        for pl, cf, tsm in ((u, fs.coeff_cb, fs.ts_cb),
                            (v, fs.coeff_cr, fs.ts_cr)):
            ts = clog2 == 2 and bool(tsm[cy // 4, cx // 4])
            _recon_tb(pl, cf, cx, cy, cs, cmode_actual, order8, qpc,
                      False, bd, False, 4, is_dst=False, ts=ts,
                      m=m_of(clog2, True))

    def walk_tu(x0, y0, log2, cmode_actual):
        leaf = int(fs.tu_log2[y0 // 4, x0 // 4])
        if leaf >= 0 and leaf < log2:
            half = 1 << (log2 - 1)
            for sy in (0, half):
                for sx in (0, half):
                    walk_tu(x0 + sx, y0 + sy, log2 - 1, cmode_actual)
            if log2 == 3:
                chroma_tb(x0, y0, 2, cmode_actual)
            return
        luma_tb(x0, y0, log2)
        if log2 > 2:
            chroma_tb(x0, y0, log2 - 1, cmode_actual)

    for x8, y8 in _cu_roots(fs.cu_log2, order8):
        log2 = int(fs.cu_log2[y8, x8])
        x0, y0 = x8 * 8, y8 * 8
        if _paste_pcm(fs, (y, u, v), x8, y8, log2):
            continue
        cmode_actual = resolve(x8, y8)
        walk_tu(x0, y0, log2, cmode_actual)
    return y, u, v


def _paste_pcm(fs, planes, x8, y8, log2) -> bool:
    """I_PCM reconstruction: the decoded samples ARE the reconstruction
    (§8.4.1 note; TDecCu::xReconPCM) — paste in decode order so later
    CUs' intra references see them."""
    pcm = fs.pcm_blocks.get((x8, y8)) if fs.pcm_blocks else None
    if pcm is None:
        return False
    size = 1 << log2
    x0, y0 = x8 * 8, y8 * 8
    planes[0][y0 : y0 + size, x0 : x0 + size] = pcm[0]
    cs = size >> 1
    planes[1][y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = pcm[1]
    planes[2][y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = pcm[2]
    return True


def _chroma_resolver(fs):
    def resolve(x8, y8):
        cm = int(fs.chroma_mode[y8, x8])
        lm = int(fs.luma_mode4[y8 * 2, x8 * 2])  # PU0's mode (§8.4.3)
        if cm == 4:
            return lm
        m = (0, 26, 10, 1)[cm]
        return 34 if m == lm else m

    return resolve


def reconstruct_frame_p_full(fs, sps, qp: int, ref_recon, l1_recon=None,
                             wp_l0=None, wp_l1=None):
    """P/B-frame reconstruction honoring rectangular partitions (mv4/ref4
    at 4-sample granularity, two lists via dir4/mv4_l1), the parsed TU
    tree, transform skip, and intra CUs (full feature set) —
    TDecCu::xReconInter counterpart for foreign streams. MC is per 4x4
    cell: block partitioning does not change per-sample interpolation, so
    this equals per-PU MC; bi-prediction averages the two 14-bit
    intermediates (§8.5.3.3.3)."""
    from ..ops.interp import bi_average_np, mc_np, mc_np14

    bd = sps.bit_depth
    w, h = fs.width, fs.height

    def as_list(r):
        if r is None:
            return []
        if isinstance(r, tuple) or (isinstance(r, list) and len(r) == 3
                                    and hasattr(r[0], "shape")):
            r = [r]
        return [tuple(p.astype(np.int32) for p in x) for x in r]

    refs = as_list(ref_recon)
    refs1 = as_list(l1_recon)
    qpc = chroma_qp(qp)
    h4, w4 = h // 4, w // 4
    ys4, xs4 = np.mgrid[0:h4, 0:w4]
    xs4 = (xs4 * 4).reshape(-1)
    ys4 = (ys4 * 4).reshape(-1)
    mv4 = fs.mv4.reshape(-1, 2)
    ref4 = np.minimum(fs.ref4.reshape(-1), len(refs) - 1)
    intra4 = np.repeat(np.repeat(fs.inter_dir == 0, 2, 0), 2, 1).reshape(-1)
    if refs1:
        dir4 = fs.dir4.reshape(-1)
        mv4b = fs.mv4_l1.reshape(-1, 2)
        ref4b = np.minimum(fs.ref4_l1.reshape(-1), len(refs1) - 1)
    else:
        dir4 = np.ones(h4 * w4, np.int32)
        mv4b = ref4b = None

    rec_y = np.zeros((h, w), np.int32)
    rec_u = np.zeros((h // 2, w // 2), np.int32)
    rec_v = np.zeros((h // 2, w // 2), np.int32)

    def paste_uni(m, rlist, ridx, mvs, wp):
        from .wp import weight_uni_np

        for r in range(len(rlist)):
            mm = m & (ridx == r)
            if not mm.any():
                continue
            ry, ru, rv = rlist[r]
            weighted = wp is not None and r < len(wp.flags) and (
                wp.flags[r][0] or wp.flags[r][1])
            if weighted:
                # explicit WP on the 14-bit intermediates
                # (TComWeightPrediction.cpp:52 weightUnidir); identity
                # components reduce to default rounding bit-exactly
                p = weight_uni_np(
                    mc_np14(ry, xs4[mm], ys4[mm], mvs[mm], 4, True, bd),
                    wp.weights[r][0], wp.offsets[r][0], wp.denom_y, bd)
                pu = weight_uni_np(
                    mc_np14(ru, xs4[mm] // 2, ys4[mm] // 2, mvs[mm], 2,
                            False, bd),
                    wp.weights[r][1], wp.offsets[r][1], wp.denom_c, bd)
                pv = weight_uni_np(
                    mc_np14(rv, xs4[mm] // 2, ys4[mm] // 2, mvs[mm], 2,
                            False, bd),
                    wp.weights[r][2], wp.offsets[r][2], wp.denom_c, bd)
            else:
                p = mc_np(ry, xs4[mm], ys4[mm], mvs[mm], 4, True, bd)
                pu = mc_np(ru, xs4[mm] // 2, ys4[mm] // 2, mvs[mm], 2,
                           False, bd)
                pv = mc_np(rv, xs4[mm] // 2, ys4[mm] // 2, mvs[mm], 2,
                           False, bd)
            for i, (bx, by) in enumerate(zip(xs4[mm], ys4[mm])):
                rec_y[by : by + 4, bx : bx + 4] = p[i]
            for i, (bx, by) in enumerate(zip(xs4[mm] // 2, ys4[mm] // 2)):
                rec_u[by : by + 2, bx : bx + 2] = pu[i]
                rec_v[by : by + 2, bx : bx + 2] = pv[i]

    paste_uni((dir4 == 1) & ~intra4, refs, ref4, mv4, wp_l0)
    if refs1:
        from .wp import weight_bi_np

        paste_uni((dir4 == 2) & ~intra4, refs1, ref4b, mv4b, wp_l1)
        bi = (dir4 == 3) & ~intra4
        wp_bi = (wp_l0 is not None and wp_l1 is not None)
        for r0 in range(len(refs)):
            for r1 in range(len(refs1)):
                mm = bi & (ref4 == r0) & (ref4b == r1)
                if not mm.any():
                    continue
                w_rr = wp_bi and (
                    (r0 < len(wp_l0.flags)
                     and (wp_l0.flags[r0][0] or wp_l0.flags[r0][1]))
                    or (r1 < len(wp_l1.flags)
                        and (wp_l1.flags[r1][0] or wp_l1.flags[r1][1])))
                for ci, (sz, lum, out) in enumerate(
                        ((4, True, rec_y), (2, False, rec_u),
                         (2, False, rec_v))):
                    f = 1 if lum else 2
                    a = mc_np14(refs[r0][ci], xs4[mm] // f, ys4[mm] // f,
                                mv4[mm], sz, lum, bd)
                    b = mc_np14(refs1[r1][ci], xs4[mm] // f, ys4[mm] // f,
                                mv4b[mm], sz, lum, bd)
                    if w_rr:
                        dn = wp_l0.denom_y if lum else wp_l0.denom_c
                        p = weight_bi_np(a, b, wp_l0.weights[r0][ci],
                                         wp_l0.offsets[r0][ci],
                                         wp_l1.weights[r1][ci],
                                         wp_l1.offsets[r1][ci], dn, bd)
                    else:
                        p = bi_average_np(a, b, bd)
                    for i, (bx, by) in enumerate(zip(xs4[mm] // f,
                                                     ys4[mm] // f)):
                        out[by : by + sz, bx : bx + sz] = p[i]

    # residual per TU leaf (inter CUs; DCT, diag scan, optional TS)
    sl_on = getattr(sps, "scaling_list_enabled", False)

    def add_resi(plane, coeff_pl, x0, y0, size, cqp, tsf):
        blk = coeff_pl[y0 : y0 + size, x0 : x0 + size]
        if not blk.any():
            return
        log2 = size.bit_length() - 1
        m = tx.default_scaling_matrix(log2, False) if sl_on else None
        d = tx.dequantize_np(blk[None], cqp, log2, bd, m=m)[0]
        if tsf:
            r_ = _inv_ts(d, bd)
        else:
            r_ = tx.inverse_transform_np(d[None], bd)[0]
        plane[y0 : y0 + size, x0 : x0 + size] = np.clip(
            plane[y0 : y0 + size, x0 : x0 + size] + r_, 0, (1 << bd) - 1)

    order8 = (getattr(fs, "tile_order8", None)
              or BlockOrder(w, h, sps.log2_ctu))
    from .intra_qt import _cu_roots

    def walk_tu_p(x0, y0, log2):
        leaf = int(fs.tu_log2[y0 // 4, x0 // 4])
        if leaf >= 0 and leaf < log2:
            half = 1 << (log2 - 1)
            for sy in (0, half):
                for sx in (0, half):
                    walk_tu_p(x0 + sx, y0 + sy, log2 - 1)
            if log2 == 3:
                add_resi(rec_u, fs.coeff_cb, x0 // 2, y0 // 2, 4, qpc,
                         bool(fs.ts_cb[y0 // 8, x0 // 8]))
                add_resi(rec_v, fs.coeff_cr, x0 // 2, y0 // 2, 4, qpc,
                         bool(fs.ts_cr[y0 // 8, x0 // 8]))
            return
        sz = 1 << log2
        add_resi(rec_y, fs.coeff_y, x0, y0, sz, qp,
                 log2 == 2 and bool(fs.ts_y[y0 // 4, x0 // 4]))
        if log2 > 2:
            cs = sz // 2
            add_resi(rec_u, fs.coeff_cb, x0 // 2, y0 // 2, cs, qpc,
                     cs == 4 and bool(fs.ts_cb[y0 // 8, x0 // 8]))
            add_resi(rec_v, fs.coeff_cr, x0 // 2, y0 // 2, cs, qpc,
                     cs == 4 and bool(fs.ts_cr[y0 // 8, x0 // 8]))

    intra_roots = []
    for x8, y8 in _cu_roots(fs.cu_log2, order8):
        if int(fs.inter_dir[y8, x8]) == 0:
            intra_roots.append((x8, y8))
            continue
        log2 = int(fs.cu_log2[y8, x8])
        walk_tu_p(x8 * 8, y8 * 8, log2)

    # intra CUs last, in decode order (their refs precede in decode
    # order, and inter recon does not depend on intra neighbors)
    if intra_roots:
        order4 = (getattr(fs, "tile_order4", None)
                  or BlockOrder(w, h, sps.log2_ctu, cell_log2=2))
        resolve = _chroma_resolver(fs)

        def luma_tb(x0, y0, log2):
            mode = int(fs.luma_mode4[y0 // 4, x0 // 4])
            ts = log2 == 2 and bool(fs.ts_y[y0 // 4, x0 // 4])
            _recon_tb(rec_y, fs.coeff_y, x0, y0, 1 << log2, mode, order4,
                      qp, True, bd, sps.strong_intra_smoothing, 4,
                      is_dst=(log2 == 2), ts=ts,
                      m=(tx.default_scaling_matrix(log2, True)
                         if sl_on else None))

        def chroma_tb(x0, y0, clog2, cmode_actual):
            cs = 1 << clog2
            cx, cy = x0 // 2, y0 // 2
            for pl, cf, tsm in ((rec_u, fs.coeff_cb, fs.ts_cb),
                                (rec_v, fs.coeff_cr, fs.ts_cr)):
                ts = clog2 == 2 and bool(tsm[cy // 4, cx // 4])
                _recon_tb(pl, cf, cx, cy, cs, cmode_actual, order8, qpc,
                          False, bd, False, 4, is_dst=False, ts=ts,
                          m=(tx.default_scaling_matrix(clog2, True)
                             if sl_on else None))

        def walk_tu_i(x0, y0, log2, cmode_actual):
            leaf = int(fs.tu_log2[y0 // 4, x0 // 4])
            if leaf >= 0 and leaf < log2:
                half = 1 << (log2 - 1)
                for sy in (0, half):
                    for sx in (0, half):
                        walk_tu_i(x0 + sx, y0 + sy, log2 - 1, cmode_actual)
                if log2 == 3:
                    chroma_tb(x0, y0, 2, cmode_actual)
                return
            luma_tb(x0, y0, log2)
            if log2 > 2:
                chroma_tb(x0, y0, log2 - 1, cmode_actual)

        for x8, y8 in intra_roots:
            log2 = int(fs.cu_log2[y8, x8])
            if _paste_pcm(fs, (rec_y, rec_u, rec_v), x8, y8, log2):
                continue
            walk_tu_i(x8 * 8, y8 * 8, log2, resolve(x8, y8))
    return rec_y, rec_u, rec_v
