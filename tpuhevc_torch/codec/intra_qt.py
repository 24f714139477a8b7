"""Quadtree intra picture encode: the decision on the device, the coding
walk on the host.

Twin of `tpuhevc/codec/intra_qt.py:770-836` (`encode_frame_intra_qt`) on
its device branch: pad the picture to the coded size, decide the maps
with the port's `decide_intra_qt`, bind them (`_apply_maps`) and run the
closed-loop coding walk (`_walk`, native or Python); with
`intra_two_pass`, decide again from the pass-1 recon and walk again.

The host half (`_mode_bits_tab`, the coding walk `_walk` with `_code_tb`,
`_cu_roots`, `_has_real_tusplit`, `_apply_maps`, and the decoder's
`reconstruct_frame_qt`) is the port's numpy copy of the reference's
(`tpuhevc/codec/intra_qt.py:74-78,446-767,839-846`).
"""

from __future__ import annotations

import functools

import numpy as np

from ..entropy.bitest import FracBits, ResidualBitEst
from ..entropy.syntax import FrameSyntax
from ..ops import transforms as tx
from ..ops.intra import predict_block_np
from ..utils.tables import chroma_qp, intra_scan_idx
from .params import EncoderConfig, i_frame_lambda
from .recon import _pad_to
from .refsamples import BlockOrder, gather_refs_qt

I_ROW = 2  # I-slice context init row


def _mode_bits_tab(fb: FracBits):
    """(mpm_idx0, mpm_idx12, non-mpm) luma mode bits."""
    f1 = fb.b("prev_intra_luma_pred_flag", 0, 1)
    f0 = fb.b("prev_intra_luma_pred_flag", 0, 0)
    return (f1 + 1.0, f1 + 2.0, f0 + 5.0)


def encode_frame_intra_qt(orig_y, orig_u, orig_v, cfg: EncoderConfig,
                          device="cuda"):
    """Quadtree all-intra encode of one picture -> (FrameSyntax,
    (y, u, v)), the contract of `recon.encode_frame_intra`."""
    from .intra_decide import decide_intra_qt  # imports this module

    sps, qp = cfg.sps, cfg.qp
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(orig_y, h, w)
    ou = _pad_to(orig_u, h // 2, w // 2)
    ov = _pad_to(orig_v, h // 2, w // 2)
    use_nxn = cfg.intra_nxn
    if use_nxn is None:
        use_nxn = cfg.intra_period == 1  # auto (see params.intra_nxn)

    def _decide(ref_planes=None):
        cu_log2, lm8, cm8, nxn, lm4, tsp8 = decide_intra_qt(
            oy, ou, ov, cfg, qp, ref_planes=ref_planes, device=device)
        if not use_nxn:
            nxn = np.zeros_like(nxn)
            tsp8 = np.zeros_like(tsp8)
            lm4 = np.repeat(np.repeat(lm8, 2, 0), 2, 1)
        return cu_log2, lm8, cm8, nxn, lm4, tsp8

    fs = FrameSyntax(w, h)
    _apply_maps(fs, *_decide())
    y = np.zeros((h, w), np.int32)
    u = np.zeros((h // 2, w // 2), np.int32)
    v = np.zeros((h // 2, w // 2), np.int32)
    lam_fp = int(round(i_frame_lambda(cfg, qp) * 256))
    walk = functools.partial(_walk, fs, sps, qp, (y, u, v), (oy, ou, ov),
                             cfg.pps.sign_data_hiding, cfg.rdoq, lam_fp, True)
    walk()
    if cfg.intra_two_pass:
        # pass 2: re-decide with the pass-1 recon as the open-loop
        # reference source, then code again from scratch
        _apply_maps(fs, *_decide(ref_planes=(y, u, v)))
        y[:], u[:], v[:] = 0, 0, 0
        fs.coeff_y[:] = 0
        fs.coeff_cb[:] = 0
        fs.coeff_cr[:] = 0
        walk()
    return fs, (y, u, v)


# --- closed-loop coding / reconstruction walk -------------------------------

def _cu_roots(cu_log2: np.ndarray, order: BlockOrder):
    """CU top-left cells in decode order."""
    h8, w8 = cu_log2.shape
    roots = []
    for y8 in range(h8):
        for x8 in range(w8):
            n = 1 << (int(cu_log2[y8, x8]) - 3)
            if x8 % n == 0 and y8 % n == 0:
                roots.append((x8, y8))
    roots.sort(key=lambda c: order.order[c[1], c[0]])
    return roots


def _code_tb(plane, coeff_pl, orig_pl, x0, y0, size, mode, order, qp,
             is_luma, bd, strong, sdh, rdoq, lam_fp, cell_px, encode,
             sl=False, est=None, lam_scale=1.0):
    """Shared per-TB walk step: predict from recon refs; encoder mode
    (encode=True) quantizes orig-pred into coeff_pl, decoder mode reads
    coeff_pl; both reconstruct identically. sl: default scaling lists
    (quant/dequant per-position m; the RDOQ proxy stays flat-list so
    plain quant is used instead)."""
    top, left = gather_refs_qt(plane, x0, y0, size, order, bd, cell_px)
    pred = predict_block_np(top, left, mode, size, is_luma, bd, strong)
    log2 = size.bit_length() - 1
    is_dst = is_luma and size == 4  # 4x4 intra luma: DST-VII (§8.6.4.1)
    m = tx.default_scaling_matrix(log2, True) if sl else None
    if encode:
        oblk = orig_pl[y0 : y0 + size, x0 : x0 + size].astype(np.int32)
        c = tx.forward_transform_np((oblk - pred)[None], bd, is_dst)[0]
        if rdoq and m is None:
            if est is not None:
                lvl = tx.rdoq_est_np(c[None], qp, log2, bd,
                                     (lam_fp / 256.0) * lam_scale,
                                     est)[0]
            else:
                lvl = tx.rdoq_np(c[None], qp, log2, bd, lam_fp,
                                 is_intra_slice=True)[0]
        else:
            lvl = tx.quantize_np(c[None], qp, log2, bd, True, m=m)[0]
        if sdh:
            from ..entropy.residual import apply_sign_bit_hiding

            lvl = apply_sign_bit_hiding(
                lvl, log2, intra_scan_idx(mode, log2, is_luma),
                tx.ideal_levels_np(c, qp, log2, bd))
        coeff_pl[y0 : y0 + size, x0 : x0 + size] = lvl
    else:
        lvl = coeff_pl[y0 : y0 + size, x0 : x0 + size]
    if lvl.any():
        d = tx.dequantize_np(lvl[None], qp, log2, bd, m=m)[0]
        r = tx.inverse_transform_np(d[None], bd, is_dst)[0]
        rec = np.clip(pred + r, 0, (1 << bd) - 1)
    else:
        rec = pred
    plane[y0 : y0 + size, x0 : x0 + size] = rec


def _walk(fs, sps, qp, planes, origs, sdh, rdoq, lam_fp, encode):
    bd = sps.bit_depth
    order = (getattr(fs, "tile_order8", None)
             or BlockOrder(fs.width, fs.height, sps.log2_ctu))
    from .native_intra import intra_walk_native

    # general features (NxN PUs / TU splits / the PCM candidate) take
    # the generalized walk; the native fast path covers the TU = CU,
    # 2Nx2N subset
    pcm_on = bool(encode and sps.pcm_enabled)
    sl = bool(getattr(sps, "scaling_list_enabled", False))
    general = pcm_on or sl or bool(fs.nxn.any()) or bool(
        (fs.tu_log2 >= 0).any() and _has_real_tusplit(fs))
    if not general:
        intra_walk_native(fs, sps, qp, planes, origs if encode else None,
                          sdh, rdoq, lam_fp, order)
        return
    qpc = chroma_qp(qp)
    y, u, v = planes
    oy, ou, ov = origs if origs else (None, None, None)
    from .recon import _chroma_mode_resolver

    resolve = _chroma_mode_resolver(fs)
    order4 = None
    if general:
        order4 = (getattr(fs, "tile_order4", None)
                  or BlockOrder(fs.width, fs.height, sps.log2_ctu,
                                cell_log2=2))
    est_by = {}
    wch = 2.0 ** ((qp - qpc) / 3.0)
    if encode:
        fb_arb = FracBits(I_ROW, qp)
        lam_arb = lam_fp / 256.0

        def _est(l2, luma):
            key = (l2, luma)
            if key not in est_by:
                est_by[key] = ResidualBitEst(fb_arb, l2, luma)
            return est_by[key]
    else:
        def _est(l2, luma):
            return None

    def _e(sz, luma):
        return _est(sz.bit_length() - 1, luma) if encode else None

    def code_cu(x8, y8, log2, split, measure=False):
        """Code one CU (in place). With measure=True returns the real
        RD cost: SSE vs orig (chroma HM-weighted) + lambda * estimator
        bits of the coded levels (the closed-loop arbiter's metric)."""
        s = 1 << log2
        x0, y0 = x8 * 8, y8 * 8
        mode = int(fs.luma_mode[y8, x8])
        cmode = resolve(x8, y8)
        nxn = split and bool(fs.nxn[y8, x8]) and log2 == sps.log2_min_cu
        bits = 0.0
        if not split:
            _code_tb(y, fs.coeff_y, oy, x0, y0, s, mode, order, qp,
                     True, bd, sps.strong_intra_smoothing, sdh, rdoq,
                     lam_fp, 8, encode, sl, est=_e(s, True))
            if measure:
                lv = fs.coeff_y[y0 : y0 + s, x0 : x0 + s]
                bits += float(_est(log2, True).tu_bits_np(lv[None])[0]) \
                    if lv.any() else 0.0
            cs = max(4, s // 2)
            for pl, opl, cf in ((u, ou, fs.coeff_cb), (v, ov, fs.coeff_cr)):
                _code_tb(pl, cf, opl, x8 * 4, y8 * 4, cs, cmode, order,
                         qpc, False, bd, False, sdh, rdoq, lam_fp, 4,
                         encode, sl, est=_e(cs, False),
                         lam_scale=1.0 / wch)
                if measure:
                    lv = cf[y8 * 4 : y8 * 4 + cs, x8 * 4 : x8 * 4 + cs]
                    if lv.any():
                        bits += float(_est(cs.bit_length() - 1, False)
                                      .tu_bits_np(lv[None])[0])
            return bits
        # one-level split (NxN IntraSplit or explicit TU split): 4 luma
        # sub-TBs in z-order, then the chroma TBs (planes independent)
        half = s // 2
        offs = ((0, 0), (half, 0), (0, half), (half, half))
        for dx, dy in offs:
            m = (int(fs.luma_mode4[(y0 + dy) // 4, (x0 + dx) // 4])
                 if nxn else mode)
            lorder, lcell = (order4, 4) if half == 4 else (order, 8)
            _code_tb(y, fs.coeff_y, oy, x0 + dx, y0 + dy, half, m,
                     lorder, qp, True, bd, sps.strong_intra_smoothing,
                     sdh, rdoq, lam_fp, lcell, encode, sl,
                     est=_e(half, True))
            if measure:
                lv = fs.coeff_y[y0 + dy : y0 + dy + half,
                                x0 + dx : x0 + dx + half]
                if lv.any():
                    bits += float(_est(half.bit_length() - 1, True)
                                  .tu_bits_np(lv[None])[0])
        # resolve() already maps DM -> fs.luma_mode (PU0's mode for NxN)
        amode = cmode
        if s == 8:
            # chroma stays one 4x4 TB at the CU level (§7.3.8.8)
            for pl, opl, cf in ((u, ou, fs.coeff_cb), (v, ov, fs.coeff_cr)):
                _code_tb(pl, cf, opl, x8 * 4, y8 * 4, 4, amode, order,
                         qpc, False, bd, False, sdh, rdoq, lam_fp, 4,
                         encode, sl, est=_e(4, False),
                         lam_scale=1.0 / wch)
                if measure:
                    lv = cf[y8 * 4 : y8 * 4 + 4, x8 * 4 : x8 * 4 + 4]
                    if lv.any():
                        bits += float(_est(2, False)
                                      .tu_bits_np(lv[None])[0])
        else:
            chalf = half // 2
            for dx, dy in offs:
                for pl, opl, cf in ((u, ou, fs.coeff_cb),
                                    (v, ov, fs.coeff_cr)):
                    _code_tb(pl, cf, opl, x0 // 2 + dx // 2,
                             y0 // 2 + dy // 2, chalf, amode, order, qpc,
                             False, bd, False, sdh, rdoq, lam_fp, 4,
                             encode, sl, est=_e(chalf, False),
                             lam_scale=1.0 / wch)
                    if measure:
                        cy0, cx0 = y0 // 2 + dy // 2, x0 // 2 + dx // 2
                        lv = cf[cy0 : cy0 + chalf, cx0 : cx0 + chalf]
                        if lv.any():
                            bits += float(
                                _est(chalf.bit_length() - 1, False)
                                .tu_bits_np(lv[None])[0])
        return bits

    def try_pcm(x8, y8, log2, cost_coded):
        """PCM candidate (TEncCu::xCheckIntraPCM, TEncCu.cpp:1410): raw
        samples beat the coded CU when lambda * raw bits < its RD cost.
        Returns True when PCM was taken (planes/maps updated)."""
        if not (pcm_on and sps.pcm_log2_min <= log2 <= sps.pcm_log2_max):
            return False
        s = 1 << log2
        x0, y0 = x8 * 8, y8 * 8
        cs = s // 2
        pbd = sps.pcm_bit_depth
        sh = bd - pbd
        raw_bits = pbd * (s * s + 2 * cs * cs) + 8.0  # + flag/align
        oy_b = oy[y0 : y0 + s, x0 : x0 + s].astype(np.int32)
        ou_b = ou[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] \
            .astype(np.int32)
        ov_b = ov[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] \
            .astype(np.int32)
        ry_ = (oy_b >> sh) << sh
        ru_ = (ou_b >> sh) << sh
        rv_ = (ov_b >> sh) << sh
        d = (float(((oy_b - ry_).astype(np.float64) ** 2).sum())
             + wch * (float(((ou_b - ru_).astype(np.float64) ** 2).sum())
                      + float(((ov_b - rv_).astype(np.float64) ** 2)
                              .sum())))
        if d + lam_arb * raw_bits >= cost_coded:
            return False
        y[y0 : y0 + s, x0 : x0 + s] = ry_
        u[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = ru_
        v[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = rv_
        fs.coeff_y[y0 : y0 + s, x0 : x0 + s] = 0
        fs.coeff_cb[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = 0
        fs.coeff_cr[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = 0
        fs.pcm_blocks[(x8, y8)] = (ry_, ru_, rv_)
        s4 = s // 4
        fs.tu_log2[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = -1
        if log2 == sps.log2_min_cu:
            fs.nxn[y8, x8] = 0
        return True

    for x8, y8 in _cu_roots(fs.cu_log2, order):
        log2 = int(fs.cu_log2[y8, x8])
        s = 1 << log2
        x0, y0 = x8 * 8, y8 * 8
        nxn = bool(fs.nxn[y8, x8]) and log2 == sps.log2_min_cu
        want = int(fs.tu_log2[y8 * 2, x8 * 2])
        split = nxn or (0 <= want < log2)
        if not (encode and split):
            if pcm_on and encode:
                cs2 = s // 2
                yx = np.s_[y0 : y0 + s, x0 : x0 + s]
                cyx = np.s_[y0 // 2 : y0 // 2 + cs2,
                            x0 // 2 : x0 // 2 + cs2]
                b_c = code_cu(x8, y8, log2, split, measure=True)
                dy_ = float(((y[yx] - oy[yx]).astype(np.float64)
                             ** 2).sum())
                du_ = float(((u[cyx] - ou[cyx]).astype(np.float64)
                             ** 2).sum())
                dv_ = float(((v[cyx] - ov[cyx]).astype(np.float64)
                             ** 2).sum())
                try_pcm(x8, y8, log2,
                        dy_ + wch * (du_ + dv_) + lam_arb * b_c)
            else:
                code_cu(x8, y8, log2, split)
            continue
        # closed-loop arbitration: the open-loop pass flagged a split
        # variant (NxN / one-level RQT); code BOTH against the real
        # reconstruction refs and keep the measured-RD winner (counters
        # the small-TB bias of original-pixel references)
        cs2 = s // 2
        yx = np.s_[y0 : y0 + s, x0 : x0 + s]
        cyx = np.s_[y0 // 2 : y0 // 2 + cs2, x0 // 2 : x0 // 2 + cs2]
        snap = (y[yx].copy(), u[cyx].copy(), v[cyx].copy(),
                fs.coeff_y[yx].copy(), fs.coeff_cb[cyx].copy(),
                fs.coeff_cr[cyx].copy())

        def cu_cost(bits, nflags):
            dy_ = float(((y[yx] - oy[yx]).astype(np.float64) ** 2).sum())
            du_ = float(((u[cyx] - ou[cyx]).astype(np.float64) ** 2).sum())
            dv_ = float(((v[cyx] - ov[cyx]).astype(np.float64) ** 2).sum())
            return dy_ + wch * (du_ + dv_) + lam_arb * (bits + nflags)

        cbf1 = fb_arb.b("qt_cbf", 1, 1)
        cbf0s = fb_arb.b("qt_cbf", 0, 1)
        b_a = code_cu(x8, y8, log2, False, measure=True)
        cost_a = cu_cost(b_a, cbf1)  # one depth-0 luma cbf
        plain = (y[yx].copy(), u[cyx].copy(), v[cyx].copy(),
                 fs.coeff_y[yx].copy(), fs.coeff_cb[cyx].copy(),
                 fs.coeff_cr[cyx].copy())
        # restore and code the split variant
        (y[yx], u[cyx], v[cyx], fs.coeff_y[yx], fs.coeff_cb[cyx],
         fs.coeff_cr[cyx]) = snap
        # syntax-overhead estimate of the split variant: NxN pays 3 more
        # luma-mode payloads (~4 bits each); the RQT split pays its flag
        extra = 12.0 if nxn else 1.0
        b_b = code_cu(x8, y8, log2, True, measure=True)
        cost_b = cu_cost(b_b, 4 * cbf0s + extra)
        if cost_a <= cost_b:
            # plain wins: restore its result + clear the split flags
            (y[yx], u[cyx], v[cyx], fs.coeff_y[yx], fs.coeff_cb[cyx],
             fs.coeff_cr[cyx]) = plain
            s4 = s // 4
            y4, x4 = y0 // 4, x0 // 4
            fs.tu_log2[y4 : y4 + s4, x4 : x4 + s4] = -1
            if nxn:
                fs.nxn[y8, x8] = 0
                fs.luma_mode4[y4 : y4 + s4, x4 : x4 + s4] = \
                    fs.luma_mode[y8, x8]
        try_pcm(x8, y8, log2, min(cost_a, cost_b))


def _has_real_tusplit(fs) -> bool:
    """True if any CU's recorded leaf TB is smaller than the CU."""
    h8, w8 = fs.cu_log2.shape
    t = fs.tu_log2[: h8 * 2 : 2, : w8 * 2 : 2]
    return bool(((t >= 0) & (t < fs.cu_log2)).any())


def _apply_maps(fs, cu_log2, lm8, cm8, nxn, lm4, tsp8):
    """Bind decided partition/mode maps onto a FrameSyntax."""
    cu_log2 = np.asarray(cu_log2)
    fs.cu_log2 = cu_log2.astype(np.int8)
    fs.luma_mode = np.asarray(lm8).astype(np.int8)
    fs.chroma_mode = np.asarray(cm8).astype(np.int8)
    if nxn is not None:
        nxn = np.asarray(nxn)
        tsp8 = np.asarray(tsp8)
        fs.nxn = nxn.astype(np.int8)
        fs.luma_mode4 = np.asarray(lm4).astype(np.int8)
        # leaf TB log2 per 4-cell: -1 = TU = CU; split CUs one level
        # down; NxN = 4x4 TBs (IntraSplit)
        rep = np.repeat(np.repeat(cu_log2, 2, 0), 2, 1).astype(np.int8)
        t4 = np.where(np.repeat(np.repeat(tsp8, 2, 0), 2, 1),
                      rep - 1, np.int8(-1))
        t4 = np.where(np.repeat(np.repeat(nxn > 0, 2, 0), 2, 1),
                      np.int8(2), t4)
        fs.tu_log2 = t4.astype(np.int8)


def reconstruct_frame_qt(fs, sps, qp: int):
    """Decoder-side reconstruction for quadtree intra frames (exact
    mirror of the coding walk)."""
    y = np.zeros((fs.height, fs.width), np.int32)
    u = np.zeros((fs.height // 2, fs.width // 2), np.int32)
    v = np.zeros((fs.height // 2, fs.width // 2), np.int32)
    _walk(fs, sps, qp, (y, u, v), None, False, False, 256, False)
    return y, u, v
