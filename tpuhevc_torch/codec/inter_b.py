"""B pictures: the device B step and its host half.

Twin of `tpuhevc/codec/inter_b.py`: the jitted B step `_b_step` (83-241)
and the jax branch of `encode_frame_b` (244-274). For every 16x16 block of
the picture at once, per reference list: the dense +-sr search (`b_me`),
NN-FME (K2, both lists in one launch), then the two lists' predictions,
their bi-average and the uni/bi arbitration (`b_pred_yuv`: luma decides
`inter_dir`, chroma follows it; the three planes in one launch), and the
table-RDOQ coding with the skip/code drop (`b_txq_planes`: luma and both
chroma planes in one launch; with SignHideFlag on, sign-bit hiding after
the RDOQ, which the reference's step omits while its writer hides a sign).
At bit depth 10 (Main10) the three kernels take their 10-bit variants,
as the reference's step takes `bd` in its `mc`, `mc14`, `bi_average`,
transforms and RDOQ.

The host half is the port's numpy copy of the reference's (`_grid16`,
the decode-order merge/skip/AMVP walk `assemble_frame_b`, and the
decoder's `reconstruct_frame_b`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..entropy.bitest import FracBits, est_tables
from ..models.nnfme import NNFME, height_category, nn_refine, width_category
from ..ops import transforms as tx
from ..ops.interp import b_pred_yuv, bi_average_np, mc_np, mc_np14
from ..ops.me import b_me
from ..ops.txq import b_txq_planes
from ..utils.tables import chroma_qp
from .inter_enc import _full_lambda_fp
from .mv_b import MvFieldB, amvp_candidates_b, merge_candidates_b
from .params import EncoderConfig
from .recon import _pad_to
from .refsamples import BlockOrder


def _grid16(w, h):
    xs, ys = [], []
    for y0 in range(0, h, 16):
        for x0 in range(0, w, 16):
            xs.append(x0)
            ys.append(y0)
    return np.array(xs), np.array(ys)


_B_STEP_CACHE: dict = {}


def build_b_step(cfg: EncoderConfig, qp: int, nn_params, device):
    """The B step on `device` (twin of `_b_step`), cached per (w, h, bd,
    qp, sr, weights, device) as the reference caches its jitted step.
    Returns fn(oy, ou, ov, r0y, r0u, r0v, r1y, r1u, r1v) (int32 planes on
    the device) -> (mvq0, mvq1, inter_dir, lvl_y, rec_y, lvl_u, rec_u,
    lvl_v, rec_v), the blocks (N, 16, 16) / (N, 8, 8) in raster order.
    The lambdas come from the configuration's base QP (`_full_lambda_fp`
    of `cfg` as given), as in the reference; the levels are sign-hidden
    where the PPS's SignHideFlag is on. Bit depth 8 or 10 (the kernels'
    variant of the SPS's depth); coded sizes in whole 16x16 blocks."""
    dev = resolve(device)
    sps = cfg.sps
    w, h, bd = sps.coded_width, sps.coded_height, sps.bit_depth
    sr = max(4, min(cfg.search_range, 16))
    sbh = cfg.pps.sign_data_hiding
    key = (w, h, bd, qp, sr, sbh, id(nn_params) if nn_params else None,
           str(dev))
    hit = _B_STEP_CACHE.get(key)
    if hit is not None and hit[1] is nn_params:
        return hit[0]
    if w % 16 or h % 16:
        raise NotImplementedError(
            f"not yet ported: the B step at {w}x{h} (not whole 16x16 "
            "blocks)")
    nh, nw = h // 16, w // 16
    n = nh * nw
    xs_np, ys_np = _grid16(w, h)
    lam_full = _full_lambda_fp(cfg) / 256.0
    lam_me = float(np.sqrt(lam_full))
    qpc = chroma_qp(qp)
    fb = FracBits(0, qp)  # B-slice init row
    est_y = est_tables(fb, 4, True, dev)
    est_c = est_tables(fb, 3, False, dev)
    nn_m = NNFME.from_numpy(nn_params, dev) if nn_params else None
    hc, wc = height_category(16), width_category(16)
    xs = torch.as_tensor(xs_np, dtype=torch.int32, device=dev)
    ys = torch.as_tensor(ys_np, dtype=torch.int32, device=dev)

    def tile(p, s):
        return (p.reshape(nh, s, nw, s).permute(0, 2, 1, 3)
                .reshape(n, s, s).contiguous())

    def step(oy, ou, ov, r0y, r0u, r0v, r1y, r1u, r1v):
        mv_int, sad9 = b_me(oy, r0y, r1y, lam_me, sr, bit_depth=bd)
        mvq = mv_int * 4
        if nn_m is not None:
            _, _, qoff = nn_refine(nn_m, sad9.reshape(2 * n, 9), hc, wc)
            mvq = mvq + qoff.reshape(2, n, 2)
        mvq0, mvq1 = mvq[0].contiguous(), mvq[1].contiguous()
        cur = tile(oy, 16)
        pred_y, inter_dir, pred_u, pred_v = b_pred_yuv(
            cur, (r0y, r1y), (r0u, r1u), (r0v, r1v), xs, ys, mvq0, mvq1,
            lam_full, bit_depth=bd)
        (lvl_y, rec_y), (lvl_u, rec_u), (lvl_v, rec_v) = b_txq_planes(
            [(cur, pred_y, qp, est_y), (tile(ou, 8), pred_u, qpc, est_c),
             (tile(ov, 8), pred_v, qpc, est_c)], lam_full, sbh=sbh,
            bit_depth=bd)
        return (mvq0, mvq1, inter_dir, lvl_y, rec_y, lvl_u, rec_u, lvl_v,
                rec_v)

    _B_STEP_CACHE[key] = (step, nn_params)
    return step


def encode_frame_b(orig, ref_l0, ref_l1, cfg: EncoderConfig, qp: int,
                   l0_pocs, l1_pocs, cur_poc: int, nn_params=None,
                   device="cuda"):
    """orig: (y, u, v); ref_l0/ref_l1: one (y, u, v) recon each.
    Returns (FrameSyntax, recon): the B step on `device`, its blocks
    fetched and walked on the host."""
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(np.asarray(orig[0]), h, w)
    ou = _pad_to(np.asarray(orig[1]), h // 2, w // 2)
    ov = _pad_to(np.asarray(orig[2]), h // 2, w // 2)
    dev = resolve(device)
    fn = build_b_step(cfg, qp, nn_params, dev)
    out = fn(*(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
               .to(dev) for a in (oy, ou, ov, *ref_l0, *ref_l1)))
    (mvq0, mvq1, inter_dir, lvl_y, rec_y, lvl_u, rec_u,
     lvl_v, rec_v) = (a.cpu().numpy() for a in out)
    xs, ys = _grid16(w, h)
    return assemble_frame_b(cfg, dict(
        xs=xs, ys=ys, inter_dir=inter_dir, mvq0=mvq0, mvq1=mvq1,
        lvl_y=lvl_y, rec_y=rec_y, lvl_u=lvl_u, rec_u=rec_u,
        lvl_v=lvl_v, rec_v=rec_v), l0_pocs, l1_pocs, cur_poc)


def assemble_frame_b(cfg, blocks, l0_pocs, l1_pocs, cur_poc):
    """Decode-order merge/skip/AMVP walk for B frames (16x16 CUs, one
    slice)."""
    from ..entropy.syntax import FrameSyntax

    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    fs = FrameSyntax(w, h)
    rec_y = np.zeros((h, w), np.int32)
    rec_u = np.zeros((h // 2, w // 2), np.int32)
    rec_v = np.zeros((h // 2, w // 2), np.int32)
    order = BlockOrder(w, h, sps.log2_ctu)
    field = MvFieldB(w // 8, h // 8)
    # relative pocs for the shared derivation (walk == decoder)
    l0_rel = [p - cur_poc for p in l0_pocs]
    l1_rel = [p - cur_poc for p in l1_pocs]
    list_pocs = [l0_rel, l1_rel]
    xs, ys = blocks["xs"], blocks["ys"]
    cells = sorted(range(len(xs)),
                   key=lambda i: order.order[ys[i] // 8, xs[i] // 8])
    mm = cfg.max_num_merge_cand
    for i in cells:
        x0, y0 = int(xs[i]), int(ys[i])
        d = int(blocks["inter_dir"][i])
        mv0 = tuple(int(v) for v in blocks["mvq0"][i]) if d & 1 else (0, 0)
        mv1 = tuple(int(v) for v in blocks["mvq1"][i]) if d & 2 else (0, 0)
        ref0 = 0 if d & 1 else -1
        ref1 = 0 if d & 2 else -1
        cbf = bool(blocks["lvl_y"][i].any() or blocks["lvl_u"][i].any()
                   or blocks["lvl_v"][i].any())
        me = (d, mv0[0], mv0[1], ref0, mv1[0], mv1[1], ref1)
        cands = merge_candidates_b(field, order, x0, y0, 16, mm, 1, 1,
                                   l0_rel, l1_rel)
        merge_i = next((k for k, c in enumerate(cands) if c == me), -1)
        y8, x8 = y0 // 8, x0 // 8
        fs.cu_log2[y8 : y8 + 2, x8 : x8 + 2] = 4
        fs.inter_dir[y8 : y8 + 2, x8 : x8 + 2] = d
        fs.mv[y8 : y8 + 2, x8 : x8 + 2] = mv0
        fs.ref_idx[y8 : y8 + 2, x8 : x8 + 2] = max(ref0, 0)
        fs.mv_l1[y8 : y8 + 2, x8 : x8 + 2] = mv1
        fs.ref_idx_l1[y8 : y8 + 2, x8 : x8 + 2] = max(ref1, 0)
        if merge_i >= 0 and not cbf:
            fs.skip[y8 : y8 + 2, x8 : x8 + 2] = 1
            fs.merge_flag[y8 : y8 + 2, x8 : x8 + 2] = 1
            fs.merge_idx[y8 : y8 + 2, x8 : x8 + 2] = merge_i
        elif merge_i >= 0:
            fs.merge_flag[y8 : y8 + 2, x8 : x8 + 2] = 1
            fs.merge_idx[y8 : y8 + 2, x8 : x8 + 2] = merge_i
        else:
            for lx, mv, used in ((0, mv0, d & 1), (1, mv1, d & 2)):
                if not used:
                    continue
                ac = amvp_candidates_b(field, order, x0, y0, 16, lx, 0,
                                       list_pocs, 0)
                costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1]) for c in ac]
                mvp = int(np.argmin(costs))
                mvd = (mv[0] - ac[mvp][0], mv[1] - ac[mvp][1])
                if lx == 0:
                    fs.mvp_flag[y8 : y8 + 2, x8 : x8 + 2] = mvp
                    fs.mvd[y8 : y8 + 2, x8 : x8 + 2] = mvd
                else:
                    fs.mvp_flag_l1[y8 : y8 + 2, x8 : x8 + 2] = mvp
                    fs.mvd_l1[y8 : y8 + 2, x8 : x8 + 2] = mvd
        field.set_cu(x0, y0, 16, d, mv0, max(ref0, 0), mv1, max(ref1, 0))
        if cbf:
            fs.coeff_y[y0 : y0 + 16, x0 : x0 + 16] = blocks["lvl_y"][i]
            fs.coeff_cb[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8] = \
                blocks["lvl_u"][i]
            fs.coeff_cr[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8] = \
                blocks["lvl_v"][i]
        rec_y[y0 : y0 + 16, x0 : x0 + 16] = blocks["rec_y"][i]
        rec_u[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8] = \
            blocks["rec_u"][i]
        rec_v[y0 // 2 : y0 // 2 + 8, x0 // 2 : x0 // 2 + 8] = \
            blocks["rec_v"][i]
    return fs, (rec_y, rec_u, rec_v)


def reconstruct_frame_b(fs, sps, qp: int, l0_refs, l1_refs):
    """Decoder-side B reconstruction. l0_refs/l1_refs: lists of (y,u,v)."""
    bd = sps.bit_depth
    w, h = fs.width, fs.height
    qpc = chroma_qp(qp)
    rec_y = np.zeros((h, w), np.int32)
    rec_u = np.zeros((h // 2, w // 2), np.int32)
    rec_v = np.zeros((h // 2, w // 2), np.int32)
    seen = np.zeros((h // 8, w // 8), dtype=bool)
    for y8 in range(h // 8):
        for x8 in range(w // 8):
            if seen[y8, x8]:
                continue
            log2 = int(fs.cu_log2[y8, x8])
            size = 1 << log2
            s8 = size // 8
            seen[y8 : y8 + s8, x8 : x8 + s8] = True
            x0, y0 = x8 * 8, y8 * 8
            d = int(fs.inter_dir[y8, x8])
            mv0 = fs.mv[y8, x8][None]
            mv1 = fs.mv_l1[y8, x8][None]
            r0 = l0_refs[min(int(fs.ref_idx[y8, x8]), len(l0_refs) - 1)] \
                if d & 1 else None
            r1 = l1_refs[min(int(fs.ref_idx_l1[y8, x8]), len(l1_refs) - 1)] \
                if d & 2 else None
            planes = ((rec_y, 0, fs.coeff_y, qp, size, log2, True),
                      (rec_u, 1, fs.coeff_cb, qpc, size // 2, log2 - 1, False),
                      (rec_v, 2, fs.coeff_cr, qpc, size // 2, log2 - 1, False))
            for out, ci, coeff, q, s, lg, lum in planes:
                px = (x0 if lum else x0 // 2)
                py = (y0 if lum else y0 // 2)
                if d == 3:
                    a = mc_np14(r0[ci], np.array([px]), np.array([py]),
                                mv0, s, lum, bd)[0]
                    b = mc_np14(r1[ci], np.array([px]), np.array([py]),
                                mv1, s, lum, bd)[0]
                    pred = bi_average_np(a[None], b[None], bd)[0]
                else:
                    rr, mv = (r0, mv0) if d == 1 else (r1, mv1)
                    pred = mc_np(rr[ci], np.array([px]), np.array([py]),
                                 mv, s, lum, bd)[0]
                blk = coeff[py : py + s, px : px + s]
                if blk.any():
                    dq = tx.dequantize_np(blk[None], q, lg, bd)
                    r = tx.inverse_transform_np(dq, bd)[0]
                    pred = np.clip(pred + r, 0, (1 << bd) - 1)
                out[py : py + s, px : px + s] = pred
    return rec_y, rec_u, rec_v
