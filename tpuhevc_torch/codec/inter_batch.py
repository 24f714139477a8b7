"""Multi-frame LD-P device stage: a chunk of P frames per call, the recon
chained on the device from frame to frame.

Twin of `tpuhevc/codec/inter_batch.py:90-359` (`build_ldp_scan`). Per frame
the CU classes (c32, c16, cf, c8 from `inter_batch._positions`) go
through four kernels (`picture_pipeline`):

  K1 `ops.me.sad_search_classes`  dense +-sr full-pel SAD, argmin, 3x3
                                  surface: every class in one launch
  K2 `models.nnfme.nn_refine_classes`  NN-FME MLP -> quarter-pel
                                  offset: up to three classes a launch
  K3 `ops.interp.mc_blk_planes`   DCT-IF MC: every class's luma and both
                                  chroma planes in one launch
  K4 `ops.txq.txq_planes`         transform, quantiser, recon, skip/code
                                  drop: every class's Y, U, V in one launch

The glue is plain torch: the block gathers use the index tables of
`_blk_idx` (K1 reads each search window from the reference plane
itself); the 32-vs-16 choice; the scatter into whole-frame planes with a
dump slot for masked entries; and the packing of each frame into the
byte row that `collect_frame` parses (the host half: `_positions`,
`_blk_idx` and `collect_frame` are the port's numpy copies of the
reference's, `inter_batch.py:36-71,362-421`). The `lax.scan` over GOPs
becomes a Python loop; launches are asynchronous, so the loop only
enqueues work. `picture_pipeline`, `choose32` and `scatter_planes` serve
the per-frame P stage (`inter_enc.build_stage`) as well.

Main10: at bit depth 10 the kernels take their 10-bit variants, the
source frames come as 16-bit samples and the row carries the recon as
16-bit little-endian samples (`recon_dtype`). The reference cuts its
10-bit recon to bytes in the row (`inter_batch.py:327-329`), and its
closure `mc_blk` keeps the 8-bit interpolation shifts at 10 bits; the
port does neither. At 8 bits the row is the reference's byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.nnfme import (K2_SEGS, NNFME, height_category,
                            nn_refine_classes, width_category)
from ..ops.interp import mc_blk_planes
from ..ops.me import bits_table, sad_search_classes
from ..ops.txq import txq_planes, wrap_int32
from ..utils.tables import chroma_qp
from .inter_enc import _grid_hier
from .params import EncoderConfig, p_frame_lambda

_OVH = 16  # flat per-CU syntax overhead of the 32-vs-16 choice


def _positions(cfg):
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    pos32, sub16, pos16_free, pos8 = _grid_hier(w, h)
    classes = []
    if pos32:
        classes.append(("c32", pos32, 32))
        classes.append(("c16", sub16, 16))
    if pos16_free:
        classes.append(("cf", pos16_free, 16))
    if pos8:
        classes.append(("c8", pos8, 8))
    return (pos32, sub16, pos16_free, pos8), classes


def _blk_idx(poss, size, stride, cdiv=1):
    """(N, size, size) flat plane indices for each block."""
    n = len(poss)
    idx = np.empty((n, size, size), np.int32)
    ar = np.arange(size)
    for i, (x, y) in enumerate(poss):
        idx[i] = ((y // cdiv + ar)[:, None] * stride + (x // cdiv + ar)[None, :])
    return idx


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of a tensor, flattened (jax bitcast to uint8)."""
    return x.contiguous().view(torch.uint8).reshape(-1)


def recon_dtype(bit_depth: int) -> np.dtype:
    """The recon samples' type in a packed row: a byte at 8 bits, 16-bit
    little-endian above."""
    return np.dtype(np.uint8 if bit_depth == 8 else "<i2")


def pack_recon(x: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Recon samples as the row's bytes (`recon_dtype`)."""
    if bit_depth == 8:
        return x.to(torch.uint8).reshape(-1)
    return _u8(x.to(torch.int16))


def _tables(cfg, classes, dev: torch.device) -> dict:
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
            xs=torch.as_tensor(xs, device=dev),
            ys=torch.as_tensor(ys, device=dev),
            xs_c=torch.as_tensor(xs // 2, device=dev),
            ys_c=torch.as_tensor(ys // 2, device=dev),
            n=n,
        )
    return tabs


def picture_pipeline(orig, ref, tabs: dict, classes, qp: int, lam_full: int,
                     lam_me: int, nn_m, bits: torch.Tensor, sr: int,
                     subsample: bool, bit_depth: int) -> dict:
    """ME, FME, MC and TU coding of a P picture's CU classes: the class
    pipeline of the LD-P scan (`inter_batch.py:212-254`, subsample on) and
    of the per-frame P stage (`inter_enc.py:137-276` on the jax backend,
    subsample off). K1 searches every class in one launch; K2 refines up
    to K2_SEGS classes a launch; K3 predicts and K4 codes every class's
    Y, U and V in one launch each, at bit_depth (8 or 10).
    orig / ref: (y, u, v) int32 planes; tabs: the classes' gather tables
    (`_tables`). Returns {tag: the class's arrays}, d and bits int32
    after the drop, summed over its three planes."""
    oy, ou, ov = orig
    ry, ru, rv = ref
    qpc = chroma_qp(qp)
    curs = [oy.reshape(-1)[tabs[tag]["blk"]] for tag, _, _ in classes]
    found = sad_search_classes(
        ry, [(cur, tabs[tag]["xs"], tabs[tag]["ys"])
             for cur, (tag, _, _) in zip(curs, classes)],
        bits, lam_me, sr, subsample, bit_depth=bit_depth)
    mvqs = [mv_int * 4 for mv_int, _ in found]
    if nn_m is not None:  # K2: up to K2_SEGS classes a launch
        parts = [(sad9, height_category(size), width_category(size))
                 for (_, sad9), (_, _, size) in zip(found, classes)]
        offs = [off for k in range(0, len(parts), K2_SEGS)
                for off in nn_refine_classes(nn_m, parts[k : k + K2_SEGS])]
        mvqs = [mvq + off for mvq, off in zip(mvqs, offs)]
    # K3: every class's luma and both chroma planes (chroma eighth-pel on
    # the chroma grid == the same quarter-pel ints)
    mc_jobs = []
    for mvq, (tag, _, size) in zip(mvqs, classes):
        t = tabs[tag]
        mc_jobs += [(ry, t["xs"], t["ys"], mvq, size, True),
                    (ru, t["xs_c"], t["ys_c"], mvq, size // 2, False),
                    (rv, t["xs_c"], t["ys_c"], mvq, size // 2, False)]
    preds = mc_blk_planes(mc_jobs, bit_depth)
    arrs, jobs = {}, []
    for i, (cur, mvq, (mv_int, sad9), (tag, _, _)) in enumerate(
            zip(curs, mvqs, found, classes)):
        blk_c = tabs[tag]["blk_c"]
        jobs += [(cur, preds[3 * i], qp),
                 (ou.reshape(-1)[blk_c], preds[3 * i + 1], qpc),
                 (ov.reshape(-1)[blk_c], preds[3 * i + 2], qpc)]
        arrs[tag] = dict(mvq=mvq, sad9=sad9, mv_int=mv_int)
    coded = txq_planes(jobs, lam_full, bit_depth)
    for i, (tag, _, _) in enumerate(classes):
        y, u, v = coded[3 * i : 3 * i + 3]  # each (lvl, rec, d, bits)
        arrs[tag].update(lvl=y[0], rec=y[1], lvl_u=u[0], rec_u=u[1],
                         lvl_v=v[0], rec_v=v[1], d=y[2] + u[2] + v[2],
                         bits=y[3] + u[3] + v[3])
    return arrs


def rd_cost(d: torch.Tensor, b: torch.Tensor, lam_full: int) -> torch.Tensor:
    """int32 d + ((lam_full * (b + OVH)) >> 8), wrapping as JAX does."""
    rate = wrap_int32(lam_full * (b.long() + _OVH)) >> 8
    return wrap_int32(d.long() + rate)


def choose32(arrs: dict, lam_full: int) -> torch.Tensor:
    """The 32-vs-16 RD choice per aligned 32-region (`_choose32`): the
    c32 cost against the sum of its four c16 costs, in wrapping int32."""
    cost16 = wrap_int32(rd_cost(arrs["c16"]["d"].reshape(-1, 4),
                                arrs["c16"]["bits"].reshape(-1, 4),
                                lam_full).sum(dim=1))
    cost32 = rd_cost(arrs["c32"]["d"], arrs["c32"]["bits"], lam_full)
    return cost32 <= cost16


def scatter_planes(arrs: dict, tabs: dict, classes, use32, h: int, w: int,
                   kinds=("rec",)) -> dict:
    """The per-class blocks of each kind ("lvl", "rec") scattered into
    whole (y, u, v) int32 planes: c16 where ~use32, c32 where use32, the
    other classes everywhere. Masked entries go to a dump slot past the
    plane's end (index h*w, or h*w/4 for chroma) that is cut off."""
    dev = tabs[classes[0][0]]["blk"].device
    flat = {k: [torch.zeros(h * w // d + 1, dtype=torch.int32, device=dev)
                for d in (1, 4, 4)] for k in kinds}
    for tag, _, _ in classes:
        mask = (use32 if tag == "c32" else
                torch.repeat_interleave(~use32, 4) if tag == "c16" else None)
        a, t = arrs[tag], tabs[tag]
        yi = t["blk"].reshape(t["n"], -1)
        ci = t["blk_c"].reshape(t["n"], -1)
        if mask is not None:
            yi = torch.where(mask[:, None], yi, h * w)
            ci = torch.where(mask[:, None], ci, h * w // 4)
        yi, ci = yi.reshape(-1), ci.reshape(-1)
        for k in kinds:
            flat[k][0][yi] = a[k].reshape(-1)
            flat[k][1][ci] = a[k + "_u"].reshape(-1)
            flat[k][2][ci] = a[k + "_v"].reshape(-1)
    return {k: (p[0][:-1].reshape(h, w), p[1][:-1].reshape(h // 2, w // 2),
                p[2][:-1].reshape(h // 2, w // 2)) for k, p in flat.items()}


def build_ldp_scan(cfg: EncoderConfig, nn_by_qp: dict, n_gops: int, device):
    """Returns (fn, grids, qps) where fn(frames (n_gops, G, fsz) uint8, or
    int16 at 10 bits, ry, ru, rv int32 planes) -> (packed (n_gops*G, B)
    uint8, ry, ru, rv), all on `device`. qps[g] is the QP of GOP position
    g (offsets applied).
    nn_by_qp maps a QP to NN-FME weights (a dict of numpy arrays, as
    `models.nnfme.load_npz` gives them; or None: integer-pel MVs, as the
    reference)."""
    dev = resolve(device)
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    bd = sps.bit_depth
    if bd not in (8, 10):
        raise NotImplementedError(f"not yet ported: bit depth {bd}")
    sr = min(cfg.search_range, 16)
    offs = tuple(cfg.gop_qp_offsets) or (0,)
    G = len(offs)
    qps = tuple(min(max(cfg.qp + o, 0), 51) for o in offs)
    grids, classes = _positions(cfg)
    n32 = len(grids[0])
    bits = bits_table(sr, dev)
    tabs = _tables(cfg, classes, dev)
    nn_dev = {}
    if cfg.fme_mode == "nn":
        for qp in set(qps):
            p = nn_by_qp.get(qp)
            if p is not None:
                nn_dev[qp] = NNFME.from_numpy(p, dev)

    def frame_step(ref, fu8, gpos):
        qp = qps[gpos]
        lam_full = int(round(p_frame_lambda(cfg, gpos, qp) * 256))
        nn_m = nn_dev.get(qp)
        oy = fu8[: w * h].reshape(h, w).int()
        ou = fu8[w * h : w * h * 5 // 4].reshape(h // 2, w // 2).int()
        ov = fu8[w * h * 5 // 4 :].reshape(h // 2, w // 2).int()
        orig = (oy, ou, ov)
        lam_me = int(round(np.sqrt(lam_full / 256.0) * 256))
        arrs = picture_pipeline(orig, ref, tabs, classes, qp, lam_full,
                                lam_me, nn_m, bits, sr, True, bd)
        use32 = choose32(arrs, lam_full) if n32 else None

        planes = scatter_planes(arrs, tabs, classes, use32, h, w,
                                ("lvl", "rec"))

        ry2, ru2, rv2 = planes["rec"]
        parts = [_u8(planes["lvl"][0].to(torch.int16)),
                 _u8(planes["lvl"][1].to(torch.int16)),
                 _u8(planes["lvl"][2].to(torch.int16)),
                 pack_recon(ry2, bd), pack_recon(ru2, bd),
                 pack_recon(rv2, bd)]
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


def collect_frame(cfg, buf: np.ndarray):
    """One frame's fetched bytes -> per_cu dict (numpy views into the
    fetched planes; compatible with inter_enc.assemble_frame_p)."""
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    grids, classes = _positions(cfg)
    rdt = recon_dtype(sps.bit_depth)
    rs = rdt.itemsize
    off = 0

    def take(nbytes, dtype, shape):
        nonlocal off
        out = np.frombuffer(buf[off : off + nbytes].tobytes(), dtype=dtype)
        off += nbytes
        return out.reshape(shape)

    lvl_y = take(w * h * 2, np.int16, (h, w))
    lvl_u = take(w * h // 2, np.int16, (h // 2, w // 2))
    lvl_v = take(w * h // 2, np.int16, (h // 2, w // 2))
    rec_y = take(w * h * rs, rdt, (h, w))
    rec_u = take(w * h // 4 * rs, rdt, (h // 2, w // 2))
    rec_v = take(w * h // 4 * rs, rdt, (h // 2, w // 2))
    meta = {}
    for tag, poss, size in classes:
        n = len(poss)
        meta[tag] = dict(
            mvq=take(n * 4, np.int16, (n, 2)),
            mv_int=take(n * 4, np.int16, (n, 2)),
            sad9=take(n * 36, np.int32, (n, 9)),
            cbf=take(n, np.uint8, (n,)).astype(bool),
        )
    n32 = len(grids[0])
    use32 = take(n32, np.uint8, (n32,)).astype(bool) if n32 else None

    per_cu = {}

    def emit(poss, size, md, i, x0, y0):
        cs = size // 2
        cx, cy = x0 // 2, y0 // 2
        per_cu[(x0, y0)] = dict(
            size=size,
            mv=md["mvq"][i].astype(np.int32),
            mv_int=md["mv_int"][i].astype(np.int32),
            sad9=md["sad9"][i],
            lvl=lvl_y[y0 : y0 + size, x0 : x0 + size].astype(np.int32),
            rec=rec_y[y0 : y0 + size, x0 : x0 + size].astype(np.int32),
            lvl_u=lvl_u[cy : cy + cs, cx : cx + cs].astype(np.int32),
            rec_u=rec_u[cy : cy + cs, cx : cx + cs].astype(np.int32),
            lvl_v=lvl_v[cy : cy + cs, cx : cx + cs].astype(np.int32),
            rec_v=rec_v[cy : cy + cs, cx : cx + cs].astype(np.int32),
        )

    pos32, sub16, pos16_free, pos8 = grids
    for tag, poss, size in classes:
        md = meta[tag]
        for i, (x0, y0) in enumerate(poss):
            if tag == "c32" and not use32[i]:
                continue
            if tag == "c16" and use32[i // 4]:
                continue
            emit(poss, size, md, i, x0, y0)
    return per_cu
