"""In-loop deblocking filter (H.265 §8.7.2), batched over all edges.

Counterpart of TComLoopFilter.{h,cpp} (loopFilterPic, SURVEY.md §2.1):
vertical edges of the whole picture first, then horizontal — each pass is
one vectorized sweep over every 8-grid edge segment (mask-selected), the
TPU-friendly restructuring of HM's per-CTU recursive edge walk.

Scope matches what this framework's encoder emits: TU == CU (so block
edges == CU edges), uniform QP, deblocking offsets 0. BS derivation:
intra slices -> 2 everywhere on the block grid; P slices -> per 4-sample
segment from cbf / |mv| difference (single ref).
"""

from __future__ import annotations

import numpy as np

from ..utils.tables import chroma_qp

# normative threshold tables (H.265 Table 8-12)
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
     13, 14, 16, 18, 20, 22, 24], dtype=np.int32,
)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11, 12,
     13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38, 40, 42,
     44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32,
)


def _edge_columns(fs, axis: int) -> np.ndarray:
    """(h8, w8) bool: True where a block edge starts at this cell's
    left (axis=0, vertical edges) / top (axis=1, horizontal edges).
    Block edges = TU edges. For this encoder's streams TU = min(CU, 32);
    general (foreign) streams carry the parsed RQT leaves in fs.tu_log2
    (4-cell granularity; the deblock grid itself stays 8-aligned, so a
    cell whose TU is 4x4 always starts an edge)."""
    cu = np.minimum(fs.cu_log2, 5)
    h8, w8 = cu.shape
    y8, x8 = np.mgrid[0:h8, 0:w8]
    if fs.tu_log2 is not None and (fs.tu_log2 >= 0).any():
        tl = fs.tu_log2[::2, ::2].astype(np.int64)  # cell's top-left 4x4
        tl = np.where(tl < 0, cu, tl)
        tsz = np.int64(1) << tl
    else:
        tsz = np.int64(1) << cu
    if axis == 0:
        return ((x8 * 8) % tsz) == 0
    return ((y8 * 8) % tsz) == 0


def _cell_cbf(fs) -> np.ndarray:
    """(h8, w8) bool: containing LUMA TB has a nonzero coefficient.
    Luma-only per §8.7.2.4 — the bS cbf condition refers to the transform
    block containing p0/q0. TB = min(CU, 32): a 64 CU is coded as a
    forced RQT split into 4 32x32 TBs, so its cbf is per-quadrant."""
    h8, w8 = fs.cu_log2.shape
    out = np.zeros((h8, w8), dtype=bool)
    seen = np.zeros((h8, w8), dtype=bool)
    for y8 in range(h8):
        for x8 in range(w8):
            if seen[y8, x8]:
                continue
            s = 1 << int(fs.cu_log2[y8, x8])
            s8 = s // 8
            x0, y0 = x8 * 8, y8 * 8
            seen[y8 : y8 + s8, x8 : x8 + s8] = True
            t = min(s, 32)
            t8 = t // 8
            for ty in range(0, s, t):
                for tx in range(0, s, t):
                    cbf = bool(fs.coeff_y[y0 + ty : y0 + ty + t,
                                          x0 + tx : x0 + tx + t].any())
                    out[(y0 + ty) // 8 : (y0 + ty) // 8 + t8,
                        (x0 + tx) // 8 : (x0 + tx) // 8 + t8] = cbf
    return out


def boundary_strength(fs, is_intra_slice: bool, axis: int) -> np.ndarray:
    """(h8, w8) BS for the edge at each cell's left/top (0 where no edge).
    Segment granularity is 4 samples; our maps are 8-aligned so one value
    covers both 4-sample segments of a cell edge."""
    edge = _edge_columns(fs, axis)
    h8, w8 = edge.shape
    bs = np.zeros((h8, w8), dtype=np.int32)
    if is_intra_slice:
        bs[edge] = 2
        if axis == 0:
            bs[:, 0] = 0  # picture boundary
        else:
            bs[0, :] = 0
        return bs
    cbf = _cell_cbf(fs)
    mv = fs.mv
    ref = fs.ref_idx if fs.ref_idx is not None else np.zeros(
        fs.cu_log2.shape, np.int32)
    if axis == 0:
        p_cbf = np.roll(cbf, 1, axis=1)
        p_mv = np.roll(mv, 1, axis=1)
        p_ref = np.roll(ref, 1, axis=1)
    else:
        p_cbf = np.roll(cbf, 1, axis=0)
        p_mv = np.roll(mv, 1, axis=0)
        p_ref = np.roll(ref, 1, axis=0)
    # bs = 1 when refs differ or any mv component differs by >= 1 pel
    mv_far = (np.abs(mv - p_mv) >= 4).any(axis=-1) | (ref != p_ref)
    bs1 = (cbf | p_cbf | mv_far).astype(np.int32)
    bs = np.where(edge, bs1, 0)
    if axis == 0:
        bs[:, 0] = 0
    else:
        bs[0, :] = 0
    return bs


def _grp_any(m: np.ndarray, f: int) -> np.ndarray:
    if f == 1:
        return m
    hh, ww = m.shape
    hq, wq = -(-hh // f) * f, -(-ww // f) * f
    mp = np.zeros((hq, wq), bool)
    mp[:hh, :ww] = m
    g = mp.reshape(hq // f, f, wq // f, f).any((1, 3))
    return np.repeat(np.repeat(g, f, 0), f, 1)[:hh, :ww]


def boundary_strength_full(fs, axis: int) -> np.ndarray:
    """(h8, w8, 2) per-4-sample-segment BS for P slices with the full
    parsed feature set (rectangular PUs via fs.mv4/ref4, RQT leaves via
    fs.tu_log2, intra CUs -> bs 2): §8.7.2.4 at the spec's segment
    granularity. axis 0 = vertical edges (left of cell), 1 = horizontal."""
    h4, w4 = fs.tu_log2.shape
    h8, w8 = h4 // 2, w4 // 2
    cu4 = np.repeat(np.repeat(fs.cu_log2, 2, 0), 2, 1).astype(np.int64)
    tu4 = np.where(fs.tu_log2 < 0, np.minimum(cu4, 5),
                   fs.tu_log2).astype(np.int64)
    intra4 = np.repeat(np.repeat(fs.inter_dir == 0, 2, 0), 2, 1)
    # per-4-cell luma TB cbf (any nonzero coeff in the containing TB)
    nz4 = fs.coeff_y.reshape(h4, 4, w4, 4).astype(bool).any((1, 3))
    cbf4 = np.zeros((h4, w4), bool)
    for l in (2, 3, 4, 5):
        cbf4 = np.where(tu4 == l, _grp_any(nz4, 1 << (l - 2)), cbf4)
    mv = fs.mv4
    ref = fs.ref4
    two_list = (getattr(fs, "l1_pocs", None)
                and fs.dir4 is not None and (fs.dir4 == 3).any()
                or (getattr(fs, "l1_pocs", None)
                    and fs.dir4 is not None and (fs.dir4 == 2).any()))
    if two_list:
        l0p = list(fs.l0_pocs)
        l1p = list(fs.l1_pocs)
        big = 1 << 30
        poc0 = np.asarray(l0p, np.int64)[np.minimum(ref, len(l0p) - 1)]
        poc1 = np.asarray(l1p, np.int64)[
            np.minimum(fs.ref4_l1, len(l1p) - 1)]
        use0 = (fs.dir4 & 1).astype(bool) & ~(fs.dir4 == 0)
        use1 = (fs.dir4 & 2).astype(bool)
        poc0 = np.where(use0, poc0, big)
        poc1 = np.where(use1, poc1, big)
        mvl1 = fs.mv4_l1
    else:
        poc0 = poc1 = use0 = use1 = mvl1 = None

    def motion_far(qi, pi, sub):
        """(…) True where the motion difference forces BS 1, per
        §8.7.2.4 two-list rules. qi/pi: index tuples selecting the q/p
        cell rows/cols; sub: lambda m: m[qi] style selector pair."""
        if not two_list:
            return ((np.abs(mv[qi] - mv[pi]) >= 4).any(-1)
                    | (ref[qi] != ref[pi]))

        def far(a, b):
            return (np.abs(a - b) >= 4).any(-1)

        u0q, u1q = use0[qi], use1[qi]
        u0p, u1p = use0[pi], use1[pi]
        nq = u0q.astype(np.int32) + u1q.astype(np.int32)
        npn = u0p.astype(np.int32) + u1p.astype(np.int32)
        # single-MV selections
        pocSq = np.where(u0q, poc0[qi], poc1[qi])
        pocSp = np.where(u0p, poc0[pi], poc1[pi])
        mvSq = np.where(u0q[..., None], mv[qi], mvl1[qi])
        mvSp = np.where(u0p[..., None], mv[pi], mvl1[pi])
        one = (pocSq != pocSp) | far(mvSq, mvSp)
        # two-MV case
        seteq = (((poc0[qi] == poc0[pi]) & (poc1[qi] == poc1[pi]))
                 | ((poc0[qi] == poc1[pi]) & (poc1[qi] == poc0[pi])))
        samepic = poc0[qi] == poc1[qi]
        straight0 = poc0[qi] == poc0[pi]
        fs00 = far(mv[qi], mv[pi])
        fs11 = far(mvl1[qi], mvl1[pi])
        fx01 = far(mv[qi], mvl1[pi])
        fx10 = far(mvl1[qi], mv[pi])
        diffpic = np.where(straight0, fs00 | fs11, fx01 | fx10)
        same = ~((~fs00 & ~fs11) | (~fx01 & ~fx10))
        both2 = ~seteq | np.where(samepic, same, diffpic)
        return np.where(nq != npn, True, np.where(nq == 1, one, both2))

    if axis == 0:  # vertical edges at x = 8*x8; segments along y (h4)
        xq = np.arange(0, w4, 2)
        xp = np.maximum(xq - 1, 0)
        x0 = (xq // 2 * 8)[None, :]
        tu_edge = (x0 % (np.int64(1) << tu4[:, xq])) == 0
        cu_edge = (x0 % (np.int64(1) << cu4[:, xq])) == 0
        mv_far = motion_far((slice(None), xq), (slice(None), xp), None)
        isx = intra4[:, xq] | intra4[:, xp]
        cbfx = cbf4[:, xq] | cbf4[:, xp]
        bs = np.where(isx & (cu_edge | tu_edge), 2,
                      ((tu_edge & cbfx) | mv_far).astype(np.int64))
        bs[:, 0] = 0  # picture boundary
        return bs.reshape(h8, 2, w8).transpose(0, 2, 1).astype(np.int32)
    yq = np.arange(0, h4, 2)
    yp = np.maximum(yq - 1, 0)
    y0 = (yq // 2 * 8)[:, None]
    tu_edge = (y0 % (np.int64(1) << tu4[yq])) == 0
    cu_edge = (y0 % (np.int64(1) << cu4[yq])) == 0
    mv_far = motion_far(yq, yp, None)
    isx = intra4[yq] | intra4[yp]
    cbfx = cbf4[yq] | cbf4[yp]
    bs = np.where(isx & (cu_edge | tu_edge), 2,
                  ((tu_edge & cbfx) | mv_far).astype(np.int64))
    bs[0, :] = 0
    return bs.reshape(h8, w4).reshape(h8, w8, 2).astype(np.int32)


def _filter_luma_lines(p, q, tc, beta, mask, maxv=255):
    """Filter across one edge for a batch of 4-line segments.
    p, q: (N, 4, 4) samples, p[:, :, 0] nearest the edge reversed so
    p[:, line, i] = p_i; q[:, line, i] = q_i. Returns filtered (p, q)."""
    p = p.astype(np.int32)
    q = q.astype(np.int32)
    dp0 = np.abs(p[:, 0, 2] - 2 * p[:, 0, 1] + p[:, 0, 0])
    dp3 = np.abs(p[:, 3, 2] - 2 * p[:, 3, 1] + p[:, 3, 0])
    dq0 = np.abs(q[:, 0, 2] - 2 * q[:, 0, 1] + q[:, 0, 0])
    dq3 = np.abs(q[:, 3, 2] - 2 * q[:, 3, 1] + q[:, 3, 0])
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    d = dpq0 + dpq3
    do_filter = (d < beta) & mask

    def dsam(line, dpq):
        sp = np.abs(p[:, line, 3] - p[:, line, 0])
        sq = np.abs(q[:, line, 0] - q[:, line, 3])
        spq = np.abs(p[:, line, 0] - q[:, line, 0])
        return (
            (2 * dpq < (beta >> 2))
            & (sp + sq < (beta >> 3))
            & (spq < ((5 * tc + 1) >> 1))
        )

    strong = dsam(0, dpq0) & dsam(3, dpq3) & do_filter
    weak = do_filter & ~strong

    tc_ = tc[:, None]
    # strong filter (all 4 lines)
    sp0 = (p[:, :, 2] + 2 * p[:, :, 1] + 2 * p[:, :, 0] + 2 * q[:, :, 0] + q[:, :, 1] + 4) >> 3
    sp1 = (p[:, :, 2] + p[:, :, 1] + p[:, :, 0] + q[:, :, 0] + 2) >> 2
    sp2 = (2 * p[:, :, 3] + 3 * p[:, :, 2] + p[:, :, 1] + p[:, :, 0] + q[:, :, 0] + 4) >> 3
    sq0 = (q[:, :, 2] + 2 * q[:, :, 1] + 2 * q[:, :, 0] + 2 * p[:, :, 0] + p[:, :, 1] + 4) >> 3
    sq1 = (q[:, :, 2] + q[:, :, 1] + q[:, :, 0] + p[:, :, 0] + 2) >> 2
    sq2 = (2 * q[:, :, 3] + 3 * q[:, :, 2] + q[:, :, 1] + q[:, :, 0] + p[:, :, 0] + 4) >> 3
    clip = lambda v, ref: np.clip(v, ref - 2 * tc_, ref + 2 * tc_)
    sp0 = clip(sp0, p[:, :, 0])
    sp1 = clip(sp1, p[:, :, 1])
    sp2 = clip(sp2, p[:, :, 2])
    sq0 = clip(sq0, q[:, :, 0])
    sq1 = clip(sq1, q[:, :, 1])
    sq2 = clip(sq2, q[:, :, 2])

    # weak filter
    delta = (9 * (q[:, :, 0] - p[:, :, 0]) - 3 * (q[:, :, 1] - p[:, :, 1]) + 8) >> 4
    w_on = weak[:, None] & (np.abs(delta) < 10 * tc_)
    dlt = np.clip(delta, -tc_, tc_)
    wp0 = np.clip(p[:, :, 0] + dlt, 0, maxv)
    wq0 = np.clip(q[:, :, 0] - dlt, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    dep = (dp0 + dp3 < side_thr)[:, None]
    deq = (dq0 + dq3 < side_thr)[:, None]
    tc2 = tc_ >> 1
    dp_ = np.clip((((p[:, :, 2] + p[:, :, 0] + 1) >> 1) - p[:, :, 1] + dlt) >> 1, -tc2, tc2)
    dq_ = np.clip((((q[:, :, 2] + q[:, :, 0] + 1) >> 1) - q[:, :, 1] - dlt) >> 1, -tc2, tc2)
    wp1 = np.clip(p[:, :, 1] + dp_, 0, maxv)
    wq1 = np.clip(q[:, :, 1] + dq_, 0, maxv)

    s_on = strong[:, None]
    out_p = p.copy()
    out_q = q.copy()
    out_p[:, :, 0] = np.where(s_on, sp0, np.where(w_on, wp0, p[:, :, 0]))
    out_p[:, :, 1] = np.where(s_on, sp1, np.where(w_on & dep, wp1, p[:, :, 1]))
    out_p[:, :, 2] = np.where(s_on, sp2, p[:, :, 2])
    out_q[:, :, 0] = np.where(s_on, sq0, np.where(w_on, wq0, q[:, :, 0]))
    out_q[:, :, 1] = np.where(s_on, sq1, np.where(w_on & deq, wq1, q[:, :, 1]))
    out_q[:, :, 2] = np.where(s_on, sq2, q[:, :, 2])
    return out_p, out_q


def _deblock_luma_dir(plane, bs8, qp, vertical: bool, bd: int = 8):
    """One direction over the whole plane. bs8: (h8, w8) per-cell edge
    BS, or (h8, w8, 2) with per-4-sample-segment BS (partitioned
    streams). qp: scalar, or an (h8, w8) per-cell QpY map (cu_qp_delta
    streams) — each edge then filters at (QpP + QpQ + 1) >> 1
    (§8.7.2.5.3)."""
    h, w = plane.shape
    if bs8.ndim == 2:
        bs8 = np.repeat(bs8[:, :, None], 2, axis=2)
    h8, w8 = bs8.shape[:2]
    # collect 4-line segments: each cell edge has two segments
    cells = np.nonzero(bs8.max(axis=2) > 0)
    if len(cells[0]) == 0:
        return plane
    n = len(cells[0]) * 2
    p = np.empty((n, 4, 4), dtype=np.int32)
    q = np.empty((n, 4, 4), dtype=np.int32)
    bs = np.empty(n, dtype=np.int32)
    coords = []
    k = 0
    for y8, x8 in zip(*cells):
        for half in (0, 1):
            if vertical:
                x = x8 * 8
                y = y8 * 8 + half * 4
                q[k] = plane[y : y + 4, x : x + 4]
                p[k] = plane[y : y + 4, x - 4 : x][:, ::-1]
            else:
                y = y8 * 8
                x = x8 * 8 + half * 4
                q[k] = plane[y : y + 4, x : x + 4].T
                p[k] = plane[y - 4 : y, x : x + 4][::-1].T
            bs[k] = bs8[y8, x8, half]
            coords.append((y, x))
            k += 1
    if np.isscalar(qp):
        qp_seg = np.full(n, qp, dtype=np.int32)
    else:
        qp_seg = np.empty(n, dtype=np.int32)
        k2 = 0
        for y8, x8 in zip(*cells):
            qq = int(qp[y8, x8])
            qpp = int(qp[y8, x8 - 1] if vertical else qp[y8 - 1, x8])
            for _ in (0, 1):
                qp_seg[k2] = (qq + qpp + 1) >> 1
                k2 += 1
    qidx_b = np.clip(qp_seg, 0, 51)
    # beta' / tc' scale with bit depth (§8.7.2.5.3)
    beta = BETA_TABLE[qidx_b].astype(np.int32) << (bd - 8)
    qidx_t = np.clip(qp_seg + 2 * (bs - 1), 0, 53)
    tc = TC_TABLE[qidx_t].astype(np.int32) << (bd - 8)
    mask = bs > 0  # per-segment BS can be 0 in partitioned streams
    fp, fq = _filter_luma_lines(p, q, tc, beta, mask,
                                maxv=(1 << bd) - 1)
    out = plane.copy()
    for k2, (y, x) in enumerate(coords):
        if vertical:
            out[y : y + 4, x - 4 : x] = fp[k2][:, ::-1]
            out[y : y + 4, x : x + 4] = fq[k2]
        else:
            out[y - 4 : y, x : x + 4] = fp[k2].T[::-1]
            out[y : y + 4, x : x + 4] = fq[k2].T
    return out


def _deblock_chroma_dir(plane, bs8, qp_c, vertical: bool, bd: int = 8):
    """Chroma: BS==2 edges only, on the 8-chroma-sample grid (every other
    luma cell edge for 4:2:0), 2-tap delta filter (§8.7.2.5.5). With a
    per-segment (h8, w8, 2) BS the even luma segment's value applies
    (HM xEdgeFilterChroma doubles the segment index)."""
    if bs8.ndim == 3:
        bs8 = bs8[:, :, 0]
    h8, w8 = bs8.shape
    out = plane.copy().astype(np.int32)
    per_cell = not np.isscalar(qp_c)
    if not per_cell:
        qidx = np.clip(qp_c + 2, 0, 53)
        tc = int(TC_TABLE[qidx]) << (bd - 8)
        if tc == 0:
            return out
    for y8, x8 in zip(*np.nonzero(bs8 == 2)):
        if per_cell:
            qq = int(qp_c[y8, x8])
            qpp = int(qp_c[y8, x8 - 1] if vertical else qp_c[y8 - 1, x8])
            tc = int(TC_TABLE[np.clip(((qq + qpp + 1) >> 1) + 2,
                                      0, 53)]) << (bd - 8)
            if tc == 0:
                continue
        # chroma edge exists where the luma edge lies on the 16-luma grid
        if vertical:
            if (x8 * 8) % 16:
                continue
            cx = x8 * 4
            cy = y8 * 4
            q0 = out[cy : cy + 4, cx]
            q1 = out[cy : cy + 4, cx + 1]
            p0 = out[cy : cy + 4, cx - 1]
            p1 = out[cy : cy + 4, cx - 2]
        else:
            if (y8 * 8) % 16:
                continue
            cy = y8 * 4
            cx = x8 * 4
            q0 = out[cy, cx : cx + 4]
            q1 = out[cy + 1, cx : cx + 4]
            p0 = out[cy - 1, cx : cx + 4]
            p1 = out[cy - 2, cx : cx + 4]
        delta = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
        np0 = np.clip(p0 + delta, 0, (1 << bd) - 1)
        nq0 = np.clip(q0 - delta, 0, (1 << bd) - 1)
        if vertical:
            out[cy : cy + 4, cx - 1] = np0
            out[cy : cy + 4, cx] = nq0
        else:
            out[cy - 1, cx : cx + 4] = np0
            out[cy, cx : cx + 4] = nq0
    return out


def pcm_sample_mask(fs):
    """Boolean (luma, chroma) masks of I_PCM CU samples, for
    pcm_loop_filter_disabled_flag handling (TComLoopFilter::xDeblockCU's
    per-sample noFilter derivation). PCM CUs are >=8px aligned so the
    chroma mask is a plain 2x decimation."""
    my = np.zeros((fs.height, fs.width), bool)
    for (x8, y8) in fs.pcm_blocks or ():
        s = 1 << int(fs.cu_log2[y8, x8])
        my[y8 * 8 : y8 * 8 + s, x8 * 8 : x8 * 8 + s] = True
    return my, my[::2, ::2]


def deblock_frame(planes, fs, qp: int, is_intra_slice: bool, pcm_mask=None,
                  bd: int = 8):
    """(y, u, v) recon -> deblocked recon (both encoder and decoder call
    this after full-frame reconstruction; intra prediction already used the
    unfiltered samples, matching the normative decoding order). With
    fs.qp_ctu set (cu_qp_delta streams) edges filter at the per-cell
    average QP. pcm_mask=(luma, chroma) keeps those samples unfiltered
    (pcm_loop_filter_disabled_flag=1); they are restored between the
    vertical and horizontal passes so neighbor filtering reads the
    unfiltered PCM values, matching HM's write-mask semantics."""
    y, u, v = (np.asarray(p).astype(np.int32) for p in planes)
    if pcm_mask is not None:
        my, mc = pcm_mask
        y0, u0, v0 = y.copy(), u.copy(), v.copy()
    qpmap = getattr(fs, "qp8", None)  # per-CU QpY (exact §8.6.1 split)
    if qpmap is None:
        qpmap = getattr(fs, "qp_ctu", None)
    if qpmap is not None:
        h8, w8 = fs.height // 8, fs.width // 8
        f = -(-h8 // qpmap.shape[0])  # map -> 8-cell granularity
        qp = np.repeat(np.repeat(qpmap, f, 0), f, 1)[:h8, :w8]
        qpc = np.vectorize(chroma_qp)(qp).astype(np.int32)
    else:
        qpc = chroma_qp(qp)
    full = (not is_intra_slice and getattr(fs, "full_features", False)
            and fs.mv4 is not None)
    bs_v = (boundary_strength_full(fs, 0) if full
            else boundary_strength(fs, is_intra_slice, 0))
    y = _deblock_luma_dir(y, bs_v, qp, True, bd)
    u = _deblock_chroma_dir(u, bs_v, qpc, True, bd)
    v = _deblock_chroma_dir(v, bs_v, qpc, True, bd)
    if pcm_mask is not None:
        y, u, v = (np.where(m, p0, p)
                   for m, p0, p in ((my, y0, y), (mc, u0, u), (mc, v0, v)))
    bs_h = (boundary_strength_full(fs, 1) if full
            else boundary_strength(fs, is_intra_slice, 1))
    y = _deblock_luma_dir(y, bs_h, qp, False, bd)
    u = _deblock_chroma_dir(u, bs_h, qpc, False, bd)
    v = _deblock_chroma_dir(v, bs_h, qpc, False, bd)
    if pcm_mask is not None:
        y, u, v = (np.where(m, p0, p)
                   for m, p0, p in ((my, y0, y), (mc, u0, u), (mc, v0, v)))
    return y, u, v
