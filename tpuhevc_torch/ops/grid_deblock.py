"""The grid step's in-loop deblocking of a P picture (kernel `grid_deblock`).

Twin of `deblock_device` (`tpuhevc/codec/inter_grid.py:1217-1256`) with
`_tb_cbf_cells`, `_bs_dir`, `_deblock_luma_vert` and
`_deblock_chroma_vert` (:1040-1215), the device counterpart of the host
filter `ops/deblock.deblock_frame` for the grid's P slices:

- per 8x8 cell, its TU log2 = min(CU log2, 5) - RQT depth, and the luma
  cbf of its TU (any nonzero luma level in the TU's aligned region);
- the boundary strength of the edge at each cell's left (vertical) or top
  (horizontal) side: 1 where the motion differs (|dmv| >= 4 quarter-pels
  in a component, or another reference) at any 8-aligned edge, or where
  either side's TU cbf is set at a TU edge of the cell; 2 where either
  side is intra at a TU edge; 0 on the picture's border;
- vertical edges over the whole picture first, then horizontal edges on
  that result: luma at every 8-aligned edge with bs > 0 (HM's dE, dEp,
  dEq decisions per 4-line segment, the strong or the normal filter, tc
  from bs), chroma at bs 2 edges on the 16-luma grid (the 2-tap filter at
  the chroma QP).

`grid_deblock_plain` is the PyTorch version; `grid_deblock` launches
`kernels/csrc/grid_deblock.cu` for CUDA tensors: one launch a picture,
each CTA a tile of the planes whose output window it owns (both edge
directions in shared memory), into new output planes; the maps are read
in the dtypes the grid step gives them (CU log2 and RQT depth int8, cbf
and intra bool, motion and reference int32), the motion field at its
strides.
"""

from __future__ import annotations

import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import chroma_qp
from .deblock import BETA_TABLE, TC_TABLE


def _tables(qp: int) -> tuple[int, int, int, int]:
    """(beta, tc at bs 1, tc at bs 2, chroma tc) at the slice QP."""
    qpc = chroma_qp(qp)
    return (int(BETA_TABLE[min(max(qp, 0), 51)]),
            int(TC_TABLE[min(max(qp, 0), 53)]),
            int(TC_TABLE[min(max(qp + 2, 0), 53)]),
            int(TC_TABLE[min(max(qpc + 2, 0), 53)]))


def _grp_any(c: torch.Tensor, f: int) -> torch.Tensor:
    """Any over aligned f x f groups of cells, broadcast back per cell."""
    if f == 1:
        return c
    hh, ww = c.shape
    hq, wq = -(-hh // f) * f, -(-ww // f) * f
    cp = torch.zeros((hq, wq), dtype=torch.bool, device=c.device)
    cp[:hh, :ww] = c
    g = cp.reshape(hq // f, f, wq // f, f).any(dim=3).any(dim=1)
    return g.repeat_interleave(f, 0).repeat_interleave(f, 1)[:hh, :ww]


def boundary_strength(tu_map, mv_map, ref_map, cbf_cells, intra_cells,
                      axis: int) -> torch.Tensor:
    """(h8, w8) int32 bs of the edge at each cell's left (axis 1) or top
    (axis 0) side (`_bs_dir` over `_tb_cbf_cells`)."""
    h8, w8 = tu_map.shape
    tb = torch.where(tu_map == 3, cbf_cells,
                     torch.where(tu_map == 4, _grp_any(cbf_cells, 2),
                                 _grp_any(cbf_cells, 4)))
    dev = tu_map.device
    cs = (torch.arange(w8, device=dev)[None] if axis == 1
          else torch.arange(h8, device=dev)[:, None])
    edge = (cs % (1 << (tu_map - 3))) == 0
    border = cs.expand(h8, w8) == 0
    p_cbf = torch.roll(tb, 1, axis)
    p_mv = torch.roll(mv_map, 1, axis)
    p_ref = torch.roll(ref_map, 1, axis)
    mv_far = ((mv_map - p_mv).abs() >= 4).any(-1) | (ref_map != p_ref)
    bs = ((((tb | p_cbf) & edge) | mv_far) & ~border).int()
    p_in = torch.roll(intra_cells, 1, axis)
    return torch.where((intra_cells | p_in) & edge & ~border, 2, bs).int()


def _luma_vert(plane: torch.Tensor, bs8: torch.Tensor, qp: int):
    """Vertical-edge pass of `_deblock_luma_vert` over an (h, w) plane."""
    hp, wp = plane.shape
    wt = wp // 8
    beta, tc1, tc2, _ = _tables(qp)
    t = plane.reshape(hp, wt, 8)
    tl = torch.roll(t, 1, 1)
    h4 = hp // 4
    ps = torch.stack([tl[:, :, 7 - k] for k in range(4)], -1).reshape(
        h4, 4, wt, 4)
    qs = t[:, :, :4].reshape(h4, 4, wt, 4)
    bs_seg = bs8.repeat_interleave(2, 0)
    tc = torch.where(bs_seg == 2, tc2, tc1)

    def d2(x, line):
        return (x[:, line, :, 2] - 2 * x[:, line, :, 1]
                + x[:, line, :, 0]).abs()

    dp0, dp3, dq0, dq3 = d2(ps, 0), d2(ps, 3), d2(qs, 0), d2(qs, 3)
    dpq0, dpq3 = dp0 + dq0, dp3 + dq3
    do_f = (dpq0 + dpq3 < beta) & (bs_seg > 0)

    def dsam(line, dpq):
        sp = (ps[:, line, :, 3] - ps[:, line, :, 0]).abs()
        sq = (qs[:, line, :, 0] - qs[:, line, :, 3]).abs()
        spq = (ps[:, line, :, 0] - qs[:, line, :, 0]).abs()
        return ((2 * dpq < (beta >> 2)) & (sp + sq < (beta >> 3))
                & (spq < ((5 * tc + 1) >> 1)))

    strong = dsam(0, dpq0) & dsam(3, dpq3) & do_f
    weak = do_f & ~strong
    tcb = tc[:, None, :]
    p0, p1, p2, p3 = (ps[..., k] for k in range(4))
    q0, q1, q2, q3 = (qs[..., k] for k in range(4))

    def clip2(v, ref):
        return torch.minimum(torch.maximum(v, ref - 2 * tcb), ref + 2 * tcb)

    sp0 = clip2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = clip2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = clip2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = clip2((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0)
    sq1 = clip2((q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = clip2((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = weak[:, None] & (delta.abs() < 10 * tcb)
    dlt = torch.minimum(torch.maximum(delta, -tcb), tcb)
    wp0 = (p0 + dlt).clamp(0, 255)
    wq0 = (q0 - dlt).clamp(0, 255)
    side = (beta + (beta >> 1)) >> 3
    dep = ((dp0 + dp3) < side)[:, None]
    deq = ((dq0 + dq3) < side)[:, None]
    tch = tcb >> 1
    dp_ = torch.minimum(torch.maximum(
        (((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tch), tch)
    dq_ = torch.minimum(torch.maximum(
        (((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tch), tch)
    wp1 = (p1 + dp_).clamp(0, 255)
    wq1 = (q1 + dq_).clamp(0, 255)
    s_on = strong[:, None]
    np0 = torch.where(s_on, sp0, torch.where(w_on, wp0, p0))
    np1 = torch.where(s_on, sp1, torch.where(w_on & dep, wp1, p1))
    np2 = torch.where(s_on, sp2, p2)
    nq0 = torch.where(s_on, sq0, torch.where(w_on, wq0, q0))
    nq1 = torch.where(s_on, sq1, torch.where(w_on & deq, wq1, q1))
    nq2 = torch.where(s_on, sq2, q2)
    newq = torch.stack([nq0, nq1, nq2], -1).reshape(hp, wt, 3)
    newp = torch.roll(torch.stack([np2, np1, np0], -1).reshape(hp, wt, 3),
                      -1, 1)
    return torch.cat([newq, t[:, :, 3:5], newp], dim=2).reshape(hp, wp)


def _chroma_vert(plane: torch.Tensor, bs2: torch.Tensor, tcc: int):
    """Vertical chroma edges of one half (`_deblock_chroma_vert`); bs2:
    (h/4, w/8) bool, edge k at x = 8k."""
    hc, wc = plane.shape
    wt = wc // 8
    t = plane.reshape(hc, wt, 8)
    tl = torch.roll(t, 1, 1)
    p1, p0, q0, q1 = tl[:, :, 6], tl[:, :, 7], t[:, :, 0], t[:, :, 1]
    on = bs2.repeat_interleave(4, 0)
    on = on & (torch.arange(wt, device=plane.device) > 0)[None]
    delta = ((((q0 - p0) * 4) + p1 - q1 + 4) >> 3).clamp(-tcc, tcc)
    np0 = torch.where(on, (p0 + delta).clamp(0, 255), p0)
    nq0 = torch.where(on, (q0 - delta).clamp(0, 255), q0)
    t = t.clone()
    t[:, :, 0] = nq0
    on_p = torch.roll(on, -1, 1)
    t[:, :, 7] = torch.where(on_p, torch.roll(np0, -1, 1), t[:, :, 7])
    return t.reshape(hc, wc)


def tu_cells(log2_map: torch.Tensor, tsplit_cells: torch.Tensor):
    """Per-8x8-cell TU log2: min(CU log2, 5) minus the RQT depth."""
    return log2_map.int().clamp(max=5) - tsplit_cells.int()


def grid_deblock_plain(rec_y, rec_uv, log2_map, mv_map, ref_map, cbf_cells,
                       intra_cells, tsplit_cells, qp: int):
    """rec_y (H, W), rec_uv (H/2, W) packed [U | V] int32; per-8x8-cell
    maps: log2_map (CU log2), mv_map (h8, w8, 2) quarter-pel, ref_map,
    cbf_cells (luma), intra_cells (bool), tsplit_cells (RQT depth) ->
    deblocked (rec_y, rec_uv) int32."""
    tu = tu_cells(log2_map, tsplit_cells)
    mv, ref = mv_map.int(), ref_map.int()
    cbf, intra = cbf_cells.bool(), intra_cells.bool()
    bs_v = boundary_strength(tu, mv, ref, cbf, intra, 1)
    bs_h = boundary_strength(tu, mv, ref, cbf, intra, 0)
    y = _luma_vert(rec_y, bs_v, qp)
    y = _luma_vert(y.T.contiguous(), bs_h.T, qp).T.contiguous()
    tcc = _tables(qp)[3]
    wc = rec_uv.shape[1] // 2
    halves = []
    for c in (rec_uv[:, :wc], rec_uv[:, wc:]):
        c = _chroma_vert(c.contiguous(), (bs_v == 2)[:, ::2], tcc)
        c = _chroma_vert(c.T.contiguous(), (bs_h == 2)[::2, :].T, tcc).T
        halves.append(c)
    return y.int(), torch.cat(halves, dim=1).int().contiguous()


# the byte maps' dtypes: read by the kernel as bytes
_BYTE_MAPS = (torch.int8, torch.uint8, torch.bool)


def grid_deblock(rec_y, rec_uv, log2_map, mv_map, ref_map, cbf_cells,
                 intra_cells, tsplit_cells, qp: int):
    """Kernel `grid_deblock`. CPU tensors take the plain version; CUDA
    tensors the kernel (one launch a picture; the inputs are left as they
    are, the outputs are new tensors)."""
    if rec_y.device.type == "cpu":
        return grid_deblock_plain(rec_y, rec_uv, log2_map, mv_map, ref_map,
                                  cbf_cells, intra_cells, tsplit_cells, qp)
    if rec_y.device.type != "cuda":
        raise ValueError(f"grid_deblock: unsupported device {rec_y.device}")
    dev = rec_y.device
    H, W = rec_y.shape
    h8, w8 = H // 8, W // 8
    check_tensor(rec_y, "rec_y", torch.int32, 2, dev)
    check_tensor(rec_uv, "rec_uv", torch.int32, 2, dev)
    if H % 16 or W % 16 or tuple(rec_uv.shape) != (H // 2, W):
        raise ValueError(f"grid_deblock: planes {tuple(rec_y.shape)}, "
                         f"{tuple(rec_uv.shape)}")
    if rec_y.data_ptr() % 16 or rec_uv.data_ptr() % 16:
        raise ValueError("grid_deblock: planes must be 16-byte aligned")
    for t, name, shape, dtypes in (
            (log2_map, "log2_map", (h8, w8), _BYTE_MAPS),
            (mv_map, "mv_map", (h8, w8, 2), (torch.int32,)),
            (ref_map, "ref_map", (h8, w8), (torch.int32,)),
            (cbf_cells, "cbf_cells", (h8, w8), _BYTE_MAPS),
            (intra_cells, "intra_cells", (h8, w8), _BYTE_MAPS),
            (tsplit_cells, "tsplit_cells", (h8, w8), _BYTE_MAPS)):
        if tuple(t.shape) != shape or t.device != dev or \
                t.dtype not in dtypes:
            raise ValueError(f"grid_deblock: {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} of {dtypes} on {dev}")
        if t is not mv_map and not t.is_contiguous():
            raise ValueError(f"grid_deblock: {name} must be contiguous")
    y = torch.empty_like(rec_y)
    uv = torch.empty_like(rec_uv)
    beta, tc1, tc2, tcc = _tables(qp)
    fn = kbuild.function("grid_deblock", "tpuhevc_grid_deblock",
                         [kbuild.P] * 10 + [kbuild.I] * 9 + [kbuild.P])
    err = fn(rec_y.data_ptr(), rec_uv.data_ptr(), y.data_ptr(),
             uv.data_ptr(), log2_map.data_ptr(), mv_map.data_ptr(),
             ref_map.data_ptr(), cbf_cells.data_ptr(),
             intra_cells.data_ptr(), tsplit_cells.data_ptr(),
             *mv_map.stride(), H, W, beta, tc1, tc2, tcc,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_deblock")
    LAUNCHES["grid_deblock"] += 1
    return y, uv
