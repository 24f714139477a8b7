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

The host stage `_compute_stage_np` is the port's numpy copy of the
reference's (`inter_enc.py:70-400`: `_bits_est_np`, `_np_me`, `_per_qp`,
the numpy branch of `_class_pipeline` and `_np_backend`): the same CU
classes with the host tools, DCT-IF refinement, RDOQ, sign-bit hiding
and per-CTU QPs. `encode_frame_p` takes it where the reference does, for
a picture with DCT-IF, sign hiding or RDOQ on, and for a picture with a
`ctu_qp_map` (the reference's `inter_backend="np"`, the route whose
stream signals the map it quantised with).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.nnfme import NNFME
from ..ops import me as me_ops
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


def _bits_est_np(lvl):
    """Integer residual-bit proxy: sum over nonzero coeffs of
    2*bit_length(|l|) + 1 (exactly reproducible on device)."""
    a = np.abs(lvl.reshape(lvl.shape[0], -1))
    bl = np.zeros_like(a)
    for k in range(15):
        bl += (a > (1 << k) - 1).astype(a.dtype)  # a >= 2^k
    return (2 * bl + (a > 0)).sum(axis=1).astype(np.int64)


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


def _np_me(ref, cur, xs, ys, sr, lambda_fp):
    mv, sad_map, best = me_ops.integer_me_np(ref, cur, xs, ys, sr, lambda_fp)
    return mv, me_ops.sad_surface_np(sad_map, best)


def _per_qp(op, arr, qpv, *rest):
    """Apply op(batch, qp, *rest) grouped by distinct per-block QP values
    (cu_qp_delta streams: blocks of one CTU share a QP, QPs vary across
    CTUs within the clip window, so the group count stays tiny)."""
    out = None
    for v in np.unique(qpv):
        m = qpv == v
        r = op(arr[m], int(v), *rest)
        if out is None:
            out = np.empty((len(qpv),) + r.shape[1:], r.dtype)
        out[m] = r
    return out


def _sbh(lvl, coef, log2, bd, qp, qpv):
    """Sign-bit hiding of the levels against the ideal levels of coef, at
    one QP or at the per-block QPs qpv."""
    from ..entropy.residual import SCAN_DIAG, apply_sign_bit_hiding

    ideal = (tx.ideal_levels_np(coef, qp, log2, bd) if qpv is None else
             _per_qp(lambda a, q: tx.ideal_levels_np(a, q, log2, bd),
                     np.asarray(coef), qpv))
    return apply_sign_bit_hiding(lvl, log2, SCAN_DIAG, ideal)


def _class_pipeline_np(cfg, orig, ref, size, xs_np, ys_np, nn_params,
                       lambda_fp):
    """ME + FME + MC + transform/quant + skip-bias for one CU-size class
    on the host: the numpy branch of the reference's `_class_pipeline`
    (DCT-IF refinement, NN offset, RDOQ, sign-bit hiding, per-block QP
    groups of a `ctu_qp_map`). Returns dict of batched arrays."""
    sps, qp = cfg.sps, cfg.qp
    bd = sps.bit_depth
    qpc = chroma_qp(qp)
    qp_map = cfg.ctu_qp_map
    qpv = qpcv = None
    if qp_map is not None:
        l2c = sps.log2_ctu
        qp_map = np.asarray(qp_map)
        qpv = qp_map[np.asarray(ys_np) >> l2c,
                     np.asarray(xs_np) >> l2c].astype(np.int32)
        qpcv = np.array([chroma_qp(int(v)) for v in qpv], np.int32)
    sr = min(cfg.search_range, 16)
    lam = _full_lambda_fp(cfg)
    oy, ou, ov = orig
    ry, ru, rv = ref
    n = len(xs_np)
    xs = np.asarray(xs_np)
    ys = np.asarray(ys_np)
    sbh = cfg.pps.sign_data_hiding
    cur = np.stack([oy[int(y) : int(y) + size, int(x) : int(x) + size]
                    for x, y in zip(xs_np, ys_np)])
    mv_int, sad9 = _np_me(ry, cur, xs, ys, sr, lambda_fp)
    mvq = mv_int * 4
    if cfg.fme_mode == "dctif":
        mvq = me_ops.fracdif_refine_np(ry, cur, xs_np, ys_np, mv_int,
                                       lambda_fp, bd)
    if nn_params is not None and cfg.fme_mode == "nn":
        from ..models import nnfme

        # the reference's `_np_backend.nn_np` is this forward, its
        # categories resolved first
        logits = nnfme.forward_np(nn_params, sad9, np.full(n, size),
                                  np.full(n, size))
        off = nnfme.CLASS_TO_QMV[np.argmax(logits, axis=-1)]
        mvq = mvq + off.astype(np.int32)
    pred = mc_np(ry, xs, ys, mvq, size, True, bd)
    log2 = size.bit_length() - 1
    coef = tx.forward_transform_np(cur.astype(np.int32) - pred, bd)
    if qpv is not None:
        if cfg.rdoq:
            lvl = _per_qp(lambda a, q: tx.rdoq_np(a, q, log2, bd, lam),
                          coef, qpv)
        else:
            lvl = _per_qp(lambda a, q: tx.quantize_np(a, q, log2, bd, False),
                          coef, qpv)
        if sbh:
            lvl = _sbh(lvl, coef, log2, bd, qp, qpv)
        rsd = tx.inverse_transform_np(
            _per_qp(lambda a, q: tx.dequantize_np(a, q, log2, bd), lvl, qpv),
            bd)
    else:
        if cfg.rdoq:
            lvl = tx.rdoq_np(coef, qp, log2, bd, lam)
        else:
            lvl = tx.quantize_np(coef, qp, log2, bd, False)
        if sbh:
            lvl = _sbh(lvl, coef, log2, bd, qp, None)
        rsd = tx.inverse_transform_np(tx.dequantize_np(lvl, qp, log2, bd), bd)
    rec = np.clip(pred + rsd, 0, (1 << bd) - 1)
    nz = (lvl != 0).reshape(n, -1).any(axis=1)
    rec = np.where(nz[:, None, None], rec, pred)
    d_skip = ((cur.astype(np.int32) - pred) ** 2).reshape(n, -1).astype(np.int64).sum(axis=1)
    d_coded = ((cur.astype(np.int32) - rec) ** 2).reshape(n, -1).astype(np.int64).sum(axis=1)
    # int32-safe: shift the lambda side instead of scaling distortion
    drop = (d_skip - d_coded) <= (lam * _bits_est_np(lvl).astype(np.int64)) >> 8
    lvl = np.where(drop[:, None, None], 0, lvl)
    rec = np.where(drop[:, None, None], pred, rec)
    d_total = np.where(drop, d_skip, d_coded)
    bits_total = _bits_est_np(lvl).astype(np.int64)

    out = dict(mvq=mvq, sad9=sad9, mv_int=mv_int, lvl=lvl, rec=rec)
    cs = size // 2
    clog2 = cs.bit_length() - 1
    cxs, cys = xs // 2, ys // 2
    for tag, plane, refp in (("u", ou, ru), ("v", ov, rv)):
        cur_c = np.stack([
            plane[int(y) // 2 : int(y) // 2 + cs, int(x) // 2 : int(x) // 2 + cs]
            for x, y in zip(xs_np, ys_np)])
        pred_c = mc_np(refp, cxs, cys, mvq, cs, False, bd)
        cc = tx.forward_transform_np(cur_c.astype(np.int32) - pred_c, bd)
        if qpcv is not None:
            if cfg.rdoq:
                clvl = _per_qp(lambda a, q: tx.rdoq_np(a, q, clog2, bd, lam),
                               cc, qpcv)
            else:
                clvl = _per_qp(
                    lambda a, q: tx.quantize_np(a, q, clog2, bd, False),
                    cc, qpcv)
        elif cfg.rdoq:
            clvl = tx.rdoq_np(cc, qpc, clog2, bd, lam)
        else:
            clvl = tx.quantize_np(cc, qpc, clog2, bd, False)
        if sbh:
            clvl = _sbh(clvl, cc, clog2, bd, qpc, qpcv)
        crs = tx.inverse_transform_np(
            (tx.dequantize_np(clvl, qpc, clog2, bd) if qpcv is None
             else _per_qp(lambda a, q: tx.dequantize_np(a, q, clog2, bd),
                          clvl, qpcv)), bd)
        crec = np.clip(pred_c + crs, 0, (1 << bd) - 1)
        cnz = (clvl != 0).reshape(n, -1).any(axis=1)
        crec = np.where(cnz[:, None, None], crec, pred_c)
        dc_s = ((cur_c.astype(np.int32) - pred_c) ** 2).reshape(n, -1).astype(np.int64).sum(axis=1)
        dc_c = ((cur_c.astype(np.int32) - crec) ** 2).reshape(n, -1).astype(np.int64).sum(axis=1)
        cdrop = (dc_s - dc_c) <= (lam * _bits_est_np(clvl).astype(np.int64)) >> 8
        clvl = np.where(cdrop[:, None, None], 0, clvl)
        crec = np.where(cdrop[:, None, None], pred_c, crec)
        d_total = d_total + np.where(cdrop, dc_s, dc_c)
        bits_total = bits_total + _bits_est_np(clvl).astype(np.int64)
        out["lvl_" + tag] = clvl
        out["rec_" + tag] = crec
    out["d"] = d_total
    out["bits"] = bits_total
    return out


def _compute_stage_np(cfg, orig, ref, nn_params, lambda_fp):
    """Host stage (hierarchical 32/16 + borders): `_class_pipeline_np`
    over the CU classes, the 32-vs-16 choice, the per-CU dict."""
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    grids = _grid_hier(w, h)
    pos32, sub16, pos16_free, pos8 = grids
    orig = tuple(np.asarray(p, dtype=np.int32) for p in orig)
    ref = tuple(np.asarray(p, dtype=np.int32) for p in ref)
    arrs = {}
    use32 = None
    lam = _full_lambda_fp(cfg)

    def run(poss, size):
        xs = np.array([p[0] for p in poss])
        ys = np.array([p[1] for p in poss])
        out = _class_pipeline_np(cfg, orig, ref, size, xs, ys, nn_params,
                                 lambda_fp)
        out["size"] = size
        return out

    if pos32:
        arrs["c32"] = run(pos32, 32)
        arrs["c16"] = run(sub16, 16)
        use32 = np.asarray(_choose32(arrs["c32"], arrs["c16"], lam))
    if pos16_free:
        arrs["cf"] = run(pos16_free, 16)
    if pos8:
        arrs["c8"] = run(pos8, 8)
    return _build_per_cu(cfg, grids, arrs, use32)


def host_stage(cfg: EncoderConfig) -> bool:
    """True where a P picture takes the host stage: DCT-IF, sign hiding or
    RDOQ on, or a per-CTU QP map (the reference's choice, its
    `inter_enc.py:570-572`, with `inter_backend="np"` for a map)."""
    return (cfg.fme_mode == "dctif" or cfg.pps.sign_data_hiding or cfg.rdoq
            or cfg.ctu_qp_map is not None)


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
    """Fetched uint8 buffer -> per-CU dict (mirrors _stage_fn packing;
    the recon as 16-bit samples at 10 bits, where the reference's row cuts
    them to bytes)."""
    from .inter_batch import recon_dtype

    pos32, sub16, pos16_free, pos8 = grids
    rdt = recon_dtype(cfg.sps.bit_depth)
    rs = rdt.itemsize
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
            rec=take(n * size * size * rs, rdt, (n, size, size)),
            lvl_u=take(n * cs * cs * 2, np.int16, (n, cs, cs)),
            rec_u=take(n * cs * cs * rs, rdt, (n, cs, cs)),
            lvl_v=take(n * cs * cs * 2, np.int16, (n, cs, cs)),
            rec_v=take(n * cs * cs * rs, rdt, (n, cs, cs)),
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
    rec_v); grids as `_grid_hier`. At 10 bits the row carries the recon
    as 16-bit samples (the reference's cuts them to bytes). Cached per configuration, weights and
    device, as the reference caches its jitted stage."""
    from .inter_batch import (_positions, _tables, _u8, choose32,
                              pack_recon, picture_pipeline, scatter_planes)

    dev = resolve(device)
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    bd = sps.bit_depth
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
                                qp, lam, lambda_fp, nn_m, bits, sr, False,
                                bd)
        use32 = choose32(arrs, lam) if grids[0] else None
        rec_y, rec_u, rec_v = scatter_planes(arrs, tabs, classes, use32, h,
                                             w)["rec"]
        parts = []
        for tag, _, _ in classes:
            a = arrs[tag]
            parts += [_u8(a["mvq"]), _u8(a["sad9"]), _u8(a["mv_int"]),
                      _u8(a["lvl"].to(torch.int16)), pack_recon(a["rec"], bd),
                      _u8(a["lvl_u"].to(torch.int16)),
                      pack_recon(a["rec_u"], bd),
                      _u8(a["lvl_v"].to(torch.int16)),
                      pack_recon(a["rec_v"], bd)]
        if use32 is not None:
            parts.append(_u8(use32.to(torch.int32)))
        return torch.cat(parts), rec_y, rec_u, rec_v

    _STAGE_CACHE[key] = (run, grids, nn_params)
    return run, grids


def encode_frame_p(orig, ref_recon, cfg: EncoderConfig, nn_params=None,
                   device="cuda"):
    """orig: (y, u, v) arrays; ref_recon: the reference's recon planes.
    Returns (FrameSyntax, recon). The configuration chooses the stage,
    as the reference does (`encode_frame_p`): with DCT-IF, sign hiding or
    RDOQ on, or a `ctu_qp_map` set, the host stage `_compute_stage_np`
    (numpy, `device` unused); otherwise the device stage on `device`, its
    packed row fetched. The absence of a card never chooses: a picture
    for the device stage on an absent CUDA device raises. Then the
    decision walk on the host."""
    sps, qp = cfg.sps, cfg.qp
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(np.asarray(orig[0]), h, w)
    ou = _pad_to(np.asarray(orig[1]), h // 2, w // 2)
    ov = _pad_to(np.asarray(orig[2]), h // 2, w // 2)
    lambda_fp = int(round(np.sqrt(cfg.frame_lambda
                                  or qp_to_lambda(qp, 0.4624)) * 256))
    if host_stage(cfg):
        ref = tuple(np.asarray(p).astype(np.int32) for p in ref_recon)
        per_cu = _compute_stage_np(cfg, (oy, ou, ov), ref, nn_params,
                                   lambda_fp)
        return assemble_frame_p(cfg, per_cu)
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
