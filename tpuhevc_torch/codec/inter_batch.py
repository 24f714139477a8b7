"""Multi-frame LD-P device stage: a chunk of P frames per call, the recon
chained on the device from frame to frame.

Twin of `tpuhevc/codec/inter_batch.py:90-359` (`build_ldp_scan`). Per frame
and per CU class (c32, c16, cf, c8 from `inter_batch._positions`) the
class pipeline runs four kernels:

  K1 `ops.me.sad_search`        dense +-sr full-pel SAD, argmin, 3x3 surface
  K2 `models.nnfme.nn_refine`   NN-FME MLP -> quarter-pel offset
  K3 `ops.interp.mc_blk`        DCT-IF MC, luma and both chroma planes
  K4 `ops.txq.txq`              transform, quantiser, recon, skip/code drop

The glue is plain torch: the block and window gathers use the index tables
of `inter_batch._blk_idx` / `_win_idx`; the 32-vs-16 choice; the scatter
into whole-frame planes with a dump slot for masked entries; and the
packing of each frame into the byte row that
`tpuhevc.codec.inter_batch.collect_frame` parses. The `lax.scan` over GOPs
becomes a Python loop; launches are asynchronous, so the loop only
enqueues work.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuhevc.codec.inter_batch import _blk_idx, _positions, _win_idx
from tpuhevc.codec.params import EncoderConfig, p_frame_lambda
from tpuhevc.utils.tables import chroma_qp

from ..device import resolve
from ..models.nnfme import NNFME, height_category, nn_refine, width_category
from ..ops.interp import mc_blk
from ..ops.me import bits_table, sad_search
from ..ops.txq import txq, wrap_int32

_OVH = 16  # flat per-CU syntax overhead of the 32-vs-16 choice


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of a tensor, flattened (jax bitcast to uint8)."""
    return x.contiguous().view(torch.uint8).reshape(-1)


def _tables(cfg, classes, sr: int, dev: torch.device) -> dict:
    w, h = cfg.sps.coded_width, cfg.sps.coded_height
    tabs = {}
    for tag, poss, size in classes:
        xs = np.array([p[0] for p in poss], np.int32)
        ys = np.array([p[1] for p in poss], np.int32)
        n = len(poss)
        tabs[tag] = dict(
            blk=torch.as_tensor(_blk_idx(poss, size, w), device=dev).long(),
            blk_c=torch.as_tensor(_blk_idx(poss, size // 2, w // 2, 2),
                                  device=dev).long(),
            win=torch.as_tensor(_win_idx(poss, size, sr, w, h),
                                device=dev).long(),
            xs=torch.as_tensor(xs, device=dev),
            ys=torch.as_tensor(ys, device=dev),
            xs_c=torch.as_tensor(xs // 2, device=dev),
            ys_c=torch.as_tensor(ys // 2, device=dev),
            n=n,
        )
    return tabs


def build_ldp_scan(cfg: EncoderConfig, nn_by_qp: dict, n_gops: int, device):
    """Returns (fn, grids, qps) where fn(frames_u8 (n_gops, G, fsz) uint8,
    ry, ru, rv int32 planes) -> (packed (n_gops*G, B) uint8, ry, ru, rv),
    all on `device`. qps[g] is the QP of GOP position g (offsets applied).
    nn_by_qp maps a QP to NN-FME weights in `tpuhevc.models.nnfme`'s numpy
    layout (or None: integer-pel MVs, as the reference)."""
    dev = resolve(device)
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    if sps.bit_depth != 8:
        raise NotImplementedError("not yet ported: bit depth != 8")
    sr = min(cfg.search_range, 16)
    offs = tuple(cfg.gop_qp_offsets) or (0,)
    G = len(offs)
    qps = tuple(min(max(cfg.qp + o, 0), 51) for o in offs)
    grids, classes = _positions(cfg)
    n32 = len(grids[0])
    bits = bits_table(sr, dev)
    tabs = _tables(cfg, classes, sr, dev)
    nn_dev = {}
    if cfg.fme_mode == "nn":
        for qp in set(qps):
            p = nn_by_qp.get(qp)
            if p is not None:
                nn_dev[qp] = NNFME.from_numpy(p, dev)

    def class_pipeline(orig, ref, t, size, qp, lam_full, nn_m):
        oy, ou, ov = orig
        ry, ru, rv = ref
        qpc = chroma_qp(qp)
        lam_me = int(round(np.sqrt(lam_full / 256.0) * 256))
        cur = oy.reshape(-1)[t["blk"]]
        wnd = ry.reshape(-1)[t["win"]]
        mv_int, sad9 = sad_search(wnd, cur, bits, lam_me, sr)
        mvq = mv_int * 4
        if nn_m is not None:
            _, _, qoff = nn_refine(nn_m, sad9, height_category(size),
                                   width_category(size))
            mvq = mvq + qoff
        pred = mc_blk(ry, t["xs"], t["ys"], mvq, size, True)
        lvl, rec, d_total, bits_total = txq(cur, pred, qp, lam_full)
        out = dict(mvq=mvq, sad9=sad9, mv_int=mv_int, lvl=lvl, rec=rec)
        cs = size // 2
        # chroma eighth-pel on the chroma grid == the same quarter-pel ints
        for tag, plane, refp in (("u", ou, ru), ("v", ov, rv)):
            cur_c = plane.reshape(-1)[t["blk_c"]]
            pred_c = mc_blk(refp, t["xs_c"], t["ys_c"], mvq, cs, False)
            clvl, crec, dc, bc = txq(cur_c, pred_c, qpc, lam_full)
            d_total = d_total + dc
            bits_total = bits_total + bc
            out["lvl_" + tag] = clvl
            out["rec_" + tag] = crec
        out["d"] = d_total
        out["bits"] = bits_total
        return out

    def rd_cost(d, b, lam_full):
        """int32 d + ((lam_full * (b + OVH)) >> 8), wrapping as JAX does."""
        rate = wrap_int32(lam_full * (b.long() + _OVH)) >> 8
        return wrap_int32(d.long() + rate)

    def frame_step(ref, fu8, gpos):
        qp = qps[gpos]
        lam_full = int(round(p_frame_lambda(cfg, gpos, qp) * 256))
        nn_m = nn_dev.get(qp)
        oy = fu8[: w * h].reshape(h, w).int()
        ou = fu8[w * h : w * h * 5 // 4].reshape(h // 2, w // 2).int()
        ov = fu8[w * h * 5 // 4 :].reshape(h // 2, w // 2).int()
        orig = (oy, ou, ov)
        arrs = {tag: class_pipeline(orig, ref, tabs[tag], size, qp, lam_full,
                                    nn_m)
                for tag, _, size in classes}
        use32 = None
        if n32:
            cost16 = wrap_int32(rd_cost(arrs["c16"]["d"].reshape(-1, 4),
                                        arrs["c16"]["bits"].reshape(-1, 4),
                                        lam_full).sum(dim=1))
            cost32 = rd_cost(arrs["c32"]["d"], arrs["c32"]["bits"], lam_full)
            use32 = cost32 <= cost16

        # scatter into whole-frame planes; masked entries go to the dump
        # slot (index h*w, or h*w/4 for chroma) that is cut off afterwards
        planes = {k: torch.zeros(h * w // (1 if k.endswith("y") else 4) + 1,
                                 dtype=torch.int32, device=dev)
                  for k in ("lvl_y", "lvl_u", "lvl_v", "rec_y", "rec_u",
                            "rec_v")}

        def scat(tag, mask):
            a = arrs[tag]
            t = tabs[tag]
            yi = t["blk"].reshape(t["n"], -1)
            ci = t["blk_c"].reshape(t["n"], -1)
            if mask is not None:
                yi = torch.where(mask[:, None], yi, h * w)
                ci = torch.where(mask[:, None], ci, h * w // 4)
            yi = yi.reshape(-1)
            ci = ci.reshape(-1)
            planes["lvl_y"][yi] = a["lvl"].reshape(-1)
            planes["lvl_u"][ci] = a["lvl_u"].reshape(-1)
            planes["lvl_v"][ci] = a["lvl_v"].reshape(-1)
            planes["rec_y"][yi] = a["rec"].reshape(-1)
            planes["rec_u"][ci] = a["rec_u"].reshape(-1)
            planes["rec_v"][ci] = a["rec_v"].reshape(-1)

        for tag, _, _ in classes:
            if tag == "c32":
                continue
            scat(tag, torch.repeat_interleave(~use32, 4) if tag == "c16"
                 else None)
        if n32:
            scat("c32", use32)

        ry2 = planes["rec_y"][:-1].reshape(h, w)
        ru2 = planes["rec_u"][:-1].reshape(h // 2, w // 2)
        rv2 = planes["rec_v"][:-1].reshape(h // 2, w // 2)
        parts = [_u8(planes["lvl_y"][:-1].to(torch.int16)),
                 _u8(planes["lvl_u"][:-1].to(torch.int16)),
                 _u8(planes["lvl_v"][:-1].to(torch.int16)),
                 ry2.to(torch.uint8).reshape(-1),
                 ru2.to(torch.uint8).reshape(-1),
                 rv2.to(torch.uint8).reshape(-1)]
        for tag, poss, _ in classes:
            a = arrs[tag]
            n = len(poss)
            cbf = ((a["lvl"] != 0).reshape(n, -1).any(dim=1)
                   | (a["lvl_u"] != 0).reshape(n, -1).any(dim=1)
                   | (a["lvl_v"] != 0).reshape(n, -1).any(dim=1))
            parts += [_u8(a["mvq"].to(torch.int16)),
                      _u8(a["mv_int"].to(torch.int16)),
                      _u8(a["sad9"].to(torch.int32)),
                      cbf.to(torch.uint8)]
        if n32:
            parts.append(use32.to(torch.uint8))
        return (ry2, ru2, rv2), torch.cat(parts)

    def run(frames_u8, ry, ru, rv):
        ref = (ry, ru, rv)
        rows = []
        for gi in range(n_gops):
            for g in range(G):
                ref, pk = frame_step(ref, frames_u8[gi, g], g)
                rows.append(pk)
        return (torch.stack(rows), *ref)

    return run, grids, qps
