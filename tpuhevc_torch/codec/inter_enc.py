"""P pictures one at a time: the per-frame device stage and its host half.

Twin of `tpuhevc/codec/inter_enc.py`'s jax backend: the stage
`_stage_fn` (403-504) with `_class_pipeline` (137-276) and
`_compute_stage_jax` (544-552), and `encode_frame_p` (555-576). The
device stage is `build_stage`: over the CU classes (aligned 32s with
their four 16s, free 16s, 8s at borders) the four kernels of the LD-P
scan (`inter_batch.picture_pipeline`), K1 `ops.me.sad_search_classes`
without row subsampling (the reference's `integer_me`; every class in one
launch), K2 `models.nnfme.nn_refine_classes` (up to three classes a
launch), K3 `ops.interp.mc_blk_planes` and K4 `ops.txq.txq_planes`
(every class's three planes in one launch each), then
the 32-vs-16 choice (`_choose32`), the scatter of
the recon planes and the byte packing that `_stage_collect` reads.

The host half is the port's numpy copy of the reference's (`_cu_grid`,
`_grid_hier`, `_choose32`, `_build_per_cu`, `_stage_collect`,
`_merge_static_cus`, the decision walk `assemble_frame_p`, and the
decoder's `reconstruct_frame_p`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.nnfme import NNFME
from ..ops import transforms as tx
from ..ops.me import bits_table
from ..ops.interp import mc_np
from ..utils.tables import chroma_qp, qp_to_lambda
from .mv import MvField, amvp_candidates, merge_candidates
from .params import EncoderConfig
from .recon import _pad_to
from .refsamples import BlockOrder

def _cu_grid(w: int, h: int):
    """(positions16, positions8): 16x16 CUs where aligned+inside, 8x8 rest."""
    pos16, pos8 = [], []
    for y0 in range(0, h, 8):
        for x0 in range(0, w, 8):
            ax, ay = x0 - x0 % 16, y0 - y0 % 16
            if ax + 16 <= w and ay + 16 <= h:
                if x0 == ax and y0 == ay:
                    pos16.append((x0, y0))
            else:
                pos8.append((x0, y0))
    return pos16, pos8


def _full_lambda_fp(cfg) -> int:
    """Picture lambda in 8.8 fixed point (full, not sqrt). Uses the
    encoder-set per-frame lambda (HM model incl. hierarchy multiplier,
    params.p_frame_lambda) when present."""
    lam = cfg.frame_lambda or qp_to_lambda(cfg.qp, 0.4624)
    return int(round(lam * 256))


def _grid_hier(w: int, h: int):
    """Hierarchical CU grid: aligned 32-regions (each with its 4 16-sub-CUs,
    RD-selected), free 16s, and 8s at non-16-aligned borders."""
    pos16_all, pos8 = _cu_grid(w, h)
    pos32 = [(x, y) for (x, y) in pos16_all
             if x % 32 == 0 and y % 32 == 0 and x + 32 <= w and y + 32 <= h]
    covered = set()
    sub16 = []
    for x, y in pos32:
        for dy in (0, 16):
            for dx in (0, 16):
                covered.add((x + dx, y + dy))
                sub16.append((x + dx, y + dy))
    pos16_free = [p for p in pos16_all if p not in covered]
    return pos32, sub16, pos16_free, pos8


_OVH_BITS = 16  # flat per-CU syntax overhead estimate for the size choice


def _choose32(c32, c16, lam):
    """Integer RD choice per 32-region. c16 arrays ordered 4 subs/region
    (TL, TR, BL, BR)."""
    d16 = c16["d"].reshape(-1, 4)
    b16 = c16["bits"].reshape(-1, 4)
    cost16 = (d16 + ((lam * (b16 + _OVH_BITS)) >> 8)).sum(axis=1)
    cost32 = c32["d"] + ((lam * (c32["bits"] + _OVH_BITS)) >> 8)
    return cost32 <= cost16


def _build_per_cu(cfg, grids, arrs, use32) -> dict:
    """Assemble the per-CU dict from per-class arrays + the 32-choice."""
    pos32, sub16, pos16_free, pos8 = grids
    per_cu = {}

    def emit(poss, a, mask=None):
        for i, (x0, y0) in enumerate(poss):
            if mask is not None and not mask[i]:
                continue
            per_cu[(x0, y0)] = dict(
                size=a["size"], mv=np.asarray(a["mvq"][i]),
                lvl=np.asarray(a["lvl"][i], dtype=np.int32),
                rec=np.asarray(a["rec"][i], dtype=np.int32),
                lvl_u=np.asarray(a["lvl_u"][i], dtype=np.int32),
                rec_u=np.asarray(a["rec_u"][i], dtype=np.int32),
                lvl_v=np.asarray(a["lvl_v"][i], dtype=np.int32),
                rec_v=np.asarray(a["rec_v"][i], dtype=np.int32),
                sad9=np.asarray(a["sad9"][i]), mv_int=np.asarray(a["mv_int"][i]),
            )

    if pos32:
        m32 = np.asarray(use32)
        emit(pos32, arrs["c32"], m32)
        m16 = np.repeat(~m32, 4)
        emit(sub16, arrs["c16"], m16)
    if pos16_free:
        emit(pos16_free, arrs["cf"])
    if pos8:
        emit(pos8, arrs["c8"])
    return per_cu


def _stage_collect(cfg, buf: np.ndarray, grids) -> dict:
    """Fetched uint8 buffer -> per-CU dict (mirrors _stage_fn packing)."""
    pos32, sub16, pos16_free, pos8 = grids
    off = 0

    def take(nbytes, dtype, shape):
        nonlocal off
        out = np.frombuffer(buf[off : off + nbytes].tobytes(), dtype=dtype)
        off += nbytes
        return out.reshape(shape)

    arrs = {}
    for tag, poss, size in (("c32", pos32, 32), ("c16", sub16, 16),
                            ("cf", pos16_free, 16), ("c8", pos8, 8)):
        if not poss:
            continue
        n = len(poss)
        cs = size // 2
        arrs[tag] = dict(
            size=size,
            mvq=take(n * 8, np.int32, (n, 2)),
            sad9=take(n * 36, np.int32, (n, 9)),
            mv_int=take(n * 8, np.int32, (n, 2)),
            lvl=take(n * size * size * 2, np.int16, (n, size, size)),
            rec=take(n * size * size, np.uint8, (n, size, size)),
            lvl_u=take(n * cs * cs * 2, np.int16, (n, cs, cs)),
            rec_u=take(n * cs * cs, np.uint8, (n, cs, cs)),
            lvl_v=take(n * cs * cs * 2, np.int16, (n, cs, cs)),
            rec_v=take(n * cs * cs, np.uint8, (n, cs, cs)),
        )
        arrs[tag]["mv"] = arrs[tag]["mvq"]
    use32 = None
    if pos32:
        use32 = take(len(pos32) * 4, np.int32, (len(pos32),)).astype(bool)
    return _build_per_cu(cfg, grids, arrs, use32)


# --- the device stage ------------------------------------------------------------

_STAGE_CACHE: dict = {}


def build_stage(cfg: EncoderConfig, nn_params, lambda_fp: int, device):
    """The per-frame P stage on `device` (twin of `_stage_fn`). Returns
    (fn, grids): fn(oy, ou, ov, ry, ru, rv) (int32 planes on the device)
    -> (packed uint8 row in `_stage_collect`'s layout, rec_y, rec_u,
    rec_v); grids as `_grid_hier`. Cached per configuration, weights and
    device, as the reference caches its jitted stage."""
    from .inter_batch import (_positions, _tables, _u8, choose32,
                              picture_pipeline, scatter_planes)

    dev = resolve(device)
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    sr = min(cfg.search_range, 16)
    use_nn = nn_params is not None and cfg.fme_mode == "nn"
    key = (cfg.fme_mode, cfg.qp, sps.bit_depth, sr, lambda_fp, w, h,
           id(nn_params) if use_nn else None, str(dev))
    hit = _STAGE_CACHE.get(key)
    if hit is not None and (not use_nn or hit[2] is nn_params):
        return hit[0], hit[1]
    grids, classes = _positions(cfg)
    tabs = _tables(cfg, classes, dev)
    bits = bits_table(sr, dev)
    lam = _full_lambda_fp(cfg)
    qp = cfg.qp
    nn_m = NNFME.from_numpy(nn_params, dev) if use_nn else None

    def run(oy, ou, ov, ry, ru, rv):
        arrs = picture_pipeline((oy, ou, ov), (ry, ru, rv), tabs, classes,
                                qp, lam, lambda_fp, nn_m, bits, sr, False)
        use32 = choose32(arrs, lam) if grids[0] else None
        rec_y, rec_u, rec_v = scatter_planes(arrs, tabs, classes, use32, h,
                                             w)["rec"]
        parts = []
        for tag, _, _ in classes:
            a = arrs[tag]
            parts += [_u8(a["mvq"]), _u8(a["sad9"]), _u8(a["mv_int"]),
                      _u8(a["lvl"].to(torch.int16)),
                      a["rec"].to(torch.uint8).reshape(-1),
                      _u8(a["lvl_u"].to(torch.int16)),
                      a["rec_u"].to(torch.uint8).reshape(-1),
                      _u8(a["lvl_v"].to(torch.int16)),
                      a["rec_v"].to(torch.uint8).reshape(-1)]
        if use32 is not None:
            parts.append(_u8(use32.to(torch.int32)))
        return torch.cat(parts), rec_y, rec_u, rec_v

    _STAGE_CACHE[key] = (run, grids, nn_params)
    return run, grids


def encode_frame_p(orig, ref_recon, cfg: EncoderConfig, nn_params=None,
                   device="cuda"):
    """orig: (y, u, v) arrays; ref_recon: the reference's recon planes.
    Returns (FrameSyntax, recon): the device stage on `device`, its packed
    row fetched and walked on the host (`encode_frame_p` with the jax
    backend; RDOQ, sign hiding and DCT-IF, which send the reference to its
    host numpy stage, are refused by `encoder.check_slice`)."""
    sps, qp = cfg.sps, cfg.qp
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(np.asarray(orig[0]), h, w)
    ou = _pad_to(np.asarray(orig[1]), h // 2, w // 2)
    ov = _pad_to(np.asarray(orig[2]), h // 2, w // 2)
    lambda_fp = int(round(np.sqrt(cfg.frame_lambda
                                  or qp_to_lambda(qp, 0.4624)) * 256))
    dev = resolve(device)
    fn, grids = build_stage(cfg, nn_params, lambda_fp, dev)
    buf, _, _, _ = fn(*(torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).to(dev) for a in (oy, ou, ov, *ref_recon)))
    per_cu = _stage_collect(cfg, buf.cpu().numpy(), grids)
    return assemble_frame_p(cfg, per_cu)


def _merge_static_cus(per_cu: dict, w: int, h: int) -> dict:
    """Bottom-up CU agglomeration: an aligned 32x32 (then 64x64) region
    whose sub-CUs share one MV and have zero residual collapses into a
    single CU (one skip flag instead of 4/16 CU syntax sets). MC is
    position-independent, so recon/coeffs are unchanged — only syntax
    granularity improves. Counterpart of the RD quadtree preferring large
    SKIP CUs in static areas (TEncCu xCheckRDCostMerge2Nx2N)."""
    for size in (32, 64):
        half = size // 2
        for y0 in range(0, h - size + 1, size):
            for x0 in range(0, w - size + 1, size):
                subs = [per_cu.get((x0 + dx, y0 + dy))
                        for dy in (0, half) for dx in (0, half)]
                if any(s is None or s["size"] != half for s in subs):
                    continue
                mv0 = subs[0]["mv"]
                ref0 = subs[0].get("ref", 0)
                if not all((s["mv"] == mv0).all()
                           and s.get("ref", 0) == ref0 for s in subs):
                    continue
                if any(s["lvl"].any() or s["lvl_u"].any() or s["lvl_v"].any()
                       for s in subs):
                    continue
                rec = np.zeros((size, size), dtype=subs[0]["rec"].dtype)
                cs = half // 2
                rec_u = np.zeros((size // 2, size // 2), dtype=rec.dtype)
                rec_v = np.zeros_like(rec_u)
                ch = half // 2
                for dy, dx in ((0, 0), (0, half), (half, 0), (half, half)):
                    s = per_cu.pop((x0 + dx, y0 + dy))
                    rec[dy : dy + half, dx : dx + half] = s["rec"]
                    rec_u[dy // 2 : dy // 2 + ch, dx // 2 : dx // 2 + ch] = s["rec_u"]
                    rec_v[dy // 2 : dy // 2 + ch, dx // 2 : dx // 2 + ch] = s["rec_v"]
                per_cu[(x0, y0)] = dict(
                    size=size, mv=mv0, ref=ref0,
                    lvl=np.zeros((size, size), np.int32), rec=rec,
                    lvl_u=np.zeros((size // 2, size // 2), np.int32),
                    rec_u=rec_u,
                    lvl_v=np.zeros((size // 2, size // 2), np.int32),
                    rec_v=rec_v,
                )
    return per_cu


def assemble_frame_p(cfg: EncoderConfig, per_cu: dict):
    """Decode-order decision walk (merge/skip/AMVP) + dense-array assembly
    of a one-reference P picture, after the bottom-up agglomeration of
    static CUs. Shared by the LD-P scan and the per-frame stage."""
    from ..entropy.syntax import FrameSyntax

    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    num_ref, ref_pocs = 1, [-1]
    fs = FrameSyntax(w, h)
    rec_y = np.zeros((h, w), dtype=np.int32)
    rec_u = np.zeros((h // 2, w // 2), dtype=np.int32)
    rec_v = np.zeros((h // 2, w // 2), dtype=np.int32)
    order = BlockOrder(w, h, sps.log2_ctu)
    field = MvField(w // 8, h // 8)
    per_cu = _merge_static_cus(per_cu, w, h)

    # --- decision walk in decode order (merge/skip/AMVP + store) ---------
    cells = sorted(per_cu.keys(), key=lambda p: order.order[p[1] // 8, p[0] // 8])
    for x0, y0 in cells:
        cu = per_cu[(x0, y0)]
        size = cu["size"]
        log2 = size.bit_length() - 1
        mv = tuple(int(v) for v in cu["mv"])
        ref = int(cu.get("ref", 0))
        cbf = bool(cu["lvl"].any() or cu["lvl_u"].any() or cu["lvl_v"].any())
        mcands = merge_candidates(field, order, x0, y0, size,
                                  cfg.max_num_merge_cand, num_ref)
        mvr = (mv[0], mv[1], ref)
        merge_i = next((k for k, c in enumerate(mcands) if c == mvr), -1)
        y8, x8 = y0 // 8, x0 // 8
        s8 = size // 8
        fs.cu_log2[y8 : y8 + s8, x8 : x8 + s8] = log2
        fs.mv[y8 : y8 + s8, x8 : x8 + s8] = mv
        fs.ref_idx[y8 : y8 + s8, x8 : x8 + s8] = ref
        if merge_i >= 0 and not cbf:
            fs.skip[y8 : y8 + s8, x8 : x8 + s8] = 1
            fs.merge_flag[y8 : y8 + s8, x8 : x8 + s8] = 1
            fs.merge_idx[y8 : y8 + s8, x8 : x8 + s8] = merge_i
        elif merge_i >= 0:
            fs.merge_flag[y8 : y8 + s8, x8 : x8 + s8] = 1
            fs.merge_idx[y8 : y8 + s8, x8 : x8 + s8] = merge_i
        else:
            acands = amvp_candidates(field, order, x0, y0, size, ref,
                                     ref_pocs, 0)
            costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1]) for c in acands]
            mvp = int(np.argmin(costs))
            fs.mvp_flag[y8 : y8 + s8, x8 : x8 + s8] = mvp
            fs.mvd[y8 : y8 + s8, x8 : x8 + s8] = (
                mv[0] - acands[mvp][0], mv[1] - acands[mvp][1])
        field.set_cu(x0, y0, size, mv, ref)
        # store coeffs + recon
        if cbf:
            fs.coeff_y[y0 : y0 + size, x0 : x0 + size] = cu["lvl"]
            cs = size // 2
            fs.coeff_cb[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = cu["lvl_u"]
            fs.coeff_cr[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = cu["lvl_v"]
        rec_y[y0 : y0 + size, x0 : x0 + size] = cu["rec"]
        cs = size // 2
        rec_u[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = cu["rec_u"]
        rec_v[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs] = cu["rec_v"]
    return fs, (rec_y, rec_u, rec_v)


def _add_residual_tiled(pred, blk, qp, bd, T=None):
    """Inverse transform + add, tiling TUs at T (default min(size, 32):
    a 64 CU is coded as a forced RQT split into 4 32x32 luma TUs with
    16x16 chroma TUs)."""
    size = blk.shape[0]
    T = T or min(size, 32)
    log2t = T.bit_length() - 1
    out = pred
    for ty in range(0, size, T):
        for tx_ in range(0, size, T):
            t = blk[ty : ty + T, tx_ : tx_ + T]
            if not t.any():
                continue
            d = tx.dequantize_np(t[None], qp, log2t, bd)[0]
            r = tx.inverse_transform_np(d[None], bd)[0]
            out = out.copy() if out is pred else out
            out[ty : ty + T, tx_ : tx_ + T] = np.clip(
                out[ty : ty + T, tx_ : tx_ + T] + r, 0, (1 << bd) - 1)
    return out


def reconstruct_frame_p(fs, sps, qp: int, ref_recon):
    """Decoder-side P-frame reconstruction from parsed FrameSyntax.
    ref_recon: one (y, u, v) tuple or a list of them (L0 order).
    Invariant: TU = min(CU, 32), 2Nx2N (what this framework emits)."""
    bd = sps.bit_depth
    w, h = fs.width, fs.height
    if isinstance(ref_recon, tuple) or (isinstance(ref_recon, list)
                                        and len(ref_recon) == 3
                                        and hasattr(ref_recon[0], "shape")):
        ref_recon = [ref_recon]
    refs = [tuple(p.astype(np.int32) for p in r) for r in ref_recon]
    qp_ctu = getattr(fs, "qp_ctu", None)
    log2_ctu = sps.log2_ctu
    qpc = chroma_qp(qp)
    rec_y = np.zeros((h, w), dtype=np.int32)
    rec_u = np.zeros((h // 2, w // 2), dtype=np.int32)
    rec_v = np.zeros((h // 2, w // 2), dtype=np.int32)
    # gather CUs from the maps
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
            if qp_ctu is not None:  # cu_qp_delta: the CTU's coded QpY
                qp = int(qp_ctu[y0 >> log2_ctu, x0 >> log2_ctu])
                qpc = chroma_qp(qp)
            mv = fs.mv[y8, x8][None]
            ry, ru, rv = refs[min(int(fs.ref_idx[y8, x8]), len(refs) - 1)]
            pred = mc_np(ry, np.array([x0]), np.array([y0]), mv, size, True, bd)[0]
            blk = fs.coeff_y[y0 : y0 + size, x0 : x0 + size]
            if blk.any():
                pred = _add_residual_tiled(pred, blk, qp, bd)
            rec_y[y0 : y0 + size, x0 : x0 + size] = pred
            cs = size // 2
            clog2 = log2 - 1
            for plane, refp, coeff, qpcc in (
                (rec_u, ru, fs.coeff_cb, qpc), (rec_v, rv, fs.coeff_cr, qpc)
            ):
                cx, cy = x0 // 2, y0 // 2
                cpred = mc_np(refp, np.array([cx]), np.array([cy]), mv, cs,
                              False, bd)[0]
                cblk = coeff[cy : cy + cs, cx : cx + cs]
                if cblk.any():
                    cpred = _add_residual_tiled(
                        cpred, cblk, qpcc, bd,
                        T=16 if size == 64 else cs)
                plane[cy : cy + cs, cx : cx + cs] = cpred
    return rec_y, rec_u, rec_v
