"""Plane-level LD-P device stage for coded sizes in whole 16x16 blocks.

Twin of `tpuhevc/codec/inter_grid.py` (`build_ldp_grid_scan`, the host
half `_parse_frame_buf` / `assemble_grid_frame` with `_sao_thrift`, and
the decision tables `_mode_tables` / `grid_live_tables`) for the anchor
LD-P cfg as shipped: the flat quantiser or RDOQ, with or without sign-bit
hiding, device deblocking and SAO on or off, with or without explicit
weighted prediction, FmeMode nn, dctif or none, with or without the recon
fetch, 8-bit, the default branch of every experiment knob of
the reference (`_TUNE`): 8- and 64-classes on, the fused merge sweep, the
DC-aware costs, rectangular PUs, the inter RQT to depth 2, the
measured-RD merge trial with the device TMVP candidate, the intra-16
candidate, no MV-rate anchor, merge bias 2, the RDOQ last-position
walk-back.

Per P picture (`GridStep.frame_step`):

1. ME: the dense +-16 coarse SAD on the 2x-pooled level (`grid_coarse`),
   the per-16 / per-32 picks and the global candidate; the +-64 prestage
   on the 4x-pooled level with its pick (`grid_prestage`); the 7x7 full-pel
   refine around up to five starts per block for the 16 (with the
   8-class from its quadrants) and 32 classes over every available
   reference, one launch a class (`grid_refine`, the starts
   reference-major, the best reference per block picked on the card);
   the global candidate stays on the card; with
   weighted prediction against the weighted full-pel references
   (`grid_wp_me`).
2. MC: the DCT-IF phase planes of every reference (`grid_planes`, the
   weighting folded into their rounding), the quarter-pel MVs (NN-FME
   offsets of every class through one launch of K2, `nn_refine_classes`,
   or the DCT-IF half- and quarter-pel
   squares of every class through one launch of `grid_subpel`,
   `grid_subpel_classes`), the fused merge-candidate sweep whose
   passes price every class's candidates by DC-aware SATD
   (`grid_satd_cost`, one launch a pass; the merge and rectangular
   trials' costs the same way), each class coding's predictions gathered
   from the planes (`grid_satd`, luma and chroma in one launch).
3. Coding: each class's TUs at TU = CU and the RQT split sizes
   (`grid_code`, with RDOQ and sign-bit hiding where the cfg has them),
   the skip trial, the measured-RD merge trial, the
   rectangular 2NxN / Nx2N trials, the intra-16 candidate (`grid_intra16`
   decides it and predicts it again from the composed recon), the
   bottom-up 8/16/32/64 compare and the composition into whole-frame
   planes and per-8-cell maps.
4. In-loop filters on the composed recon: deblocking (`grid_deblock`,
   the boundary strengths from the composed maps with the real RQT
   depths) and SAO (`grid_sao`: stats, the per-CTU decision, apply) where
   the cfg has them; the filtered planes are the next picture's
   references.
5. The packed row that `assemble_grid_frame` parses (with the SAO
   parameters where SAO is on; without the recon fetch, the picture
   checksums and SSEs of `grid_stats` in place of the recon planes), and
   the carry: the reference stacks, the full-pel MV seed and the TMVP
   collocated maps.

The `lax.scan` over GOPs and the per-reference scan become Python loops;
the kernels launch asynchronously, so the loops only enqueue work.

`GridStep.frame_steps` is the step of one row stripe of the picture, a
generator that yields where it needs what other stripes hold (the
reference rows of its reads, the block row above, the picture's sums,
the SAO decision: `codec/stripes.py`); `frame_step` runs it alone over
the whole picture, and `parallel/mesh.py:sharded_frame_step` runs one a
stripe in lockstep, equal to it byte for byte. The
glue between the kernels (argmins, the sweep's adoption test, the RD
compares, composition) is plain torch in float32 and int32, in the
reference's operation order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..entropy.bitest import EstTables, FracBits, ResidualBitEst
from ..models.nnfme import (NNFME, height_category, nn_refine_classes,
                            width_category)
from ..ops.grid_code import grid_code_batch, up
from ..ops.grid_deblock import grid_deblock
from ..ops.grid_intra import IMODES, grid_intra16, intra16_out
from ..ops.grid_me import (grid_coarse, grid_prestage, grid_refine,
                           grid_refine_refs, grid_wp_me, tile_sum, zcost)
from ..ops.grid_pred import (SatdField, grid_mc, grid_planes,
                              grid_satd_cost, grid_subpel_classes)
from ..ops.grid_sao import grid_sao_apply, grid_sao_decide, grid_sao_stats
from ..ops.grid_stats import grid_stats_partial, stats_finish
from ..utils.tables import chroma_qp
from .params import EncoderConfig, p_frame_lambda
from .stripes import Gather, Halo, HaloItem, Once, Rows, run_one

MERGE_BIAS = 2.0  # the reference's default merge adoption bit weight


def supports(cfg) -> bool:
    sps = cfg.sps
    return (sps.coded_width % 16 == 0 and sps.coded_height % 16 == 0
            and sps.bit_depth == 8 and not sps.scaling_list_enabled)


def _mvd_bits_np(v):
    """Exp-Golomb-ish bit cost of a quarter-pel mvd component (the ME
    loop's log2 model)."""
    return (2 * np.ceil(np.log2(2 * np.abs(v).astype(np.int64) + 1))
            .astype(np.int32) + 1)


def fetches_recon(cfg) -> bool:
    """The packed row carries the recon planes (else, with the checksum
    hash and no fetch, the device's picture checksums and SSEs)."""
    return cfg.fetch_recon or cfg.hash_type != "checksum"


def _lvl8(cfg) -> bool:
    offs = tuple(cfg.gop_qp_offsets) or (0,)
    return min(min(max(cfg.qp + o, 0), 51) for o in offs) >= 27


def _mode_tables(qp: int, num_ref: int, max_merge: int, amp: bool = True,
                 fb=None):
    """Host-side per-QP decision tables (P-slice init row); fb: a
    FracBits of fed-back context states, else the warmed init states."""
    fb = fb or FracBits(1, qp)
    b = fb.b
    amp_b = b("part_mode", 3, 1) if amp else 0.0
    return dict(
        fb=fb,
        mvd_lut=fb.mvd_lut,
        skip0=b("cu_skip_flag", 1, 0), skip1=b("cu_skip_flag", 1, 1),
        pred_inter=b("pred_mode_flag", 0, 0),
        pred_intra=b("pred_mode_flag", 0, 1),
        prev_mode=[b("prev_intra_luma_pred_flag", 0, v) for v in (0, 1)],
        chroma_dm=b("intra_chroma_pred_mode", 0, 0),
        part2n=b("part_mode", 0, 1),
        part_hv=[b("part_mode", 0, 0) + b("part_mode", 1, 1) + amp_b,
                 b("part_mode", 0, 0) + b("part_mode", 1, 0) + amp_b],
        mf1=b("merge_flag", 0, 1), mf0=b("merge_flag", 0, 0),
        midx=[fb.merge_idx_bits(i, max_merge) for i in range(max_merge)],
        mvp=0.5 * (b("mvp_flag", 0, 0) + b("mvp_flag", 0, 1)),
        root1=b("rqt_root_cbf", 0, 1), root0=b("rqt_root_cbf", 0, 0),
        split=[b("split_cu_flag", 1, v) for v in (0, 1)],
        tsplit={lg: [b("split_transform_flag", 5 - lg, v) for v in (0, 1)]
                for lg in (3, 4, 5)},
        ref_bits=np.asarray([fb.ref_idx_bits(r, num_ref)
                             for r in range(max(num_ref, 1))], np.float32),
        cbf_y=[b("qt_cbf", 1, v) for v in (0, 1)],
        cbf_c=[b("qt_cbf", 5, v) for v in (0, 1)],
        est_y={lg: ResidualBitEst(fb, lg, True) for lg in (2, 3, 4, 5)},
        est_c={lg: ResidualBitEst(fb, lg, False) for lg in (2, 3, 4, 5)},
    )


_LIVE_SCALARS = ("skip0", "skip1", "pred_inter", "pred_intra", "part2n",
                 "mf1", "mf0", "mvp", "root1", "root0", "chroma_dm")
_LIVE_VECTORS = ("prev_mode", "part_hv", "midx", "split", "cbf_y", "cbf_c")


def grid_live_tables(cfg: EncoderConfig, states_by_qp: dict) -> list:
    """Per-GOP-position decision tables of one chunk: {qp: end-of-slice
    context states} fed back from the written P slices (the adaptive
    re-freeze); a QP with no feedback yet takes the warmed init tables.
    Each entry: float32 scalars and vectors, the MV/ref bit tables, and
    the residual estimators (ResidualBitEst) per luma/chroma TU size."""
    offs = tuple(cfg.gop_qp_offsets) or (0,)
    R = max(1, cfg.num_ref_frames)
    out, cache = [], {}
    for o in offs:
        qp = min(max(cfg.qp + o, 0), 51)
        if qp not in cache:
            st = states_by_qp.get(qp)
            fb = FracBits.from_states(1, qp, st) if st is not None else None
            t = _mode_tables(qp, R, cfg.max_num_merge_cand,
                             cfg.sps.amp_enabled, fb=fb)
            lv = {k: np.float32(t[k]) for k in _LIVE_SCALARS}
            lv.update({k: np.asarray(t[k], np.float32)
                       for k in _LIVE_VECTORS})
            lv["mvd_lut"] = np.asarray(t["mvd_lut"], np.float32)
            lv["ref_bits"] = np.asarray(t["ref_bits"], np.float32)
            lv["tsplit"] = {lg: np.asarray(v, np.float32)
                            for lg, v in t["tsplit"].items()}
            lv["est_y"] = t["est_y"]
            lv["est_c"] = t["est_c"]
            cache[qp] = lv
        out.append(cache[qp])
    return out


def _intra_static(nh16, nw16, log2_ctu):
    """z-scan availability of the TR / BL 16-sample segments per 16-cell
    (min-CU z-addresses are static; §6.4.1)."""
    ctu_cells = max(1, (1 << log2_ctu) // 16)
    wctu_ = -(-nw16 // ctu_cells)
    zz = np.zeros((nh16, nw16), np.int64)
    for by in range(nh16):
        for bx in range(nw16):
            cy, cx = by // ctu_cells, bx // ctu_cells
            oy_, ox_ = by % ctu_cells, bx % ctu_cells
            m = 0
            for b_ in range(6):
                m |= (((ox_ >> b_) & 1) << (2 * b_)) \
                    | (((oy_ >> b_) & 1) << (2 * b_ + 1))
            zz[by, bx] = ((cy * wctu_ + cx) << 16) + m
    tr = np.zeros((nh16, nw16), bool)
    bl = np.zeros((nh16, nw16), bool)
    for by in range(nh16):
        for bx in range(nw16):
            if by > 0 and bx + 1 < nw16:
                tr[by, bx] = zz[by - 1, bx + 1] < zz[by, bx]
            if by + 1 < nh16 and bx > 0:
                bl[by, bx] = zz[by + 1, bx - 1] < zz[by, bx]
    return tr, bl


def sum22(x: torch.Tensor) -> torch.Tensor:
    """(2a, 2b) -> (a, b) sums of 2x2 groups, added in row-major order
    (((x00 + x01) + x10) + x11), the reduction order of the reference."""
    return ((x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2]) + x[1::2, 1::2]


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)


class _Tabs:
    """One frame's decision tables on the device: float32 0-dim tensors
    and vectors, and the residual estimators' device tables."""

    def __init__(self, lv: dict, dev):
        for k in _LIVE_SCALARS:
            setattr(self, k, _f32(lv[k], dev))
        for k in _LIVE_VECTORS:
            setattr(self, k, torch.as_tensor(np.asarray(lv[k], np.float32),
                                             device=dev))
        self.mvd_lut = torch.as_tensor(lv["mvd_lut"], device=dev)
        self.ref_bits = torch.as_tensor(lv["ref_bits"], device=dev)
        self.tsplit = {lg: torch.as_tensor(v, device=dev)
                       for lg, v in lv["tsplit"].items()}
        self.est_y = {lg: EstTables(e, dev) for lg, e in lv["est_y"].items()}
        self.est_c = {lg: EstTables(e, dev) for lg, e in lv["est_c"].items()}


class GridStep:
    """The per-configuration constants of the grid step on one device and
    `frame_step`, the decision and coding of one P picture."""

    def __init__(self, cfg: EncoderConfig, nn_by_qp: dict, device):
        dev = self.dev = resolve(device)
        sps = cfg.sps
        self.cfg = cfg
        W, H = self.W, self.H = sps.coded_width, sps.coded_height
        self.sr = sr = (16 if cfg.search_range >= 16
                        else max(4, cfg.search_range // 4 * 4))
        self.sr_full = max(sr, min(cfg.search_range, 64) // 4 * 4)
        offs = tuple(cfg.gop_qp_offsets) or (0,)
        self.G = len(offs)
        self.qps = tuple(min(max(cfg.qp + o, 0), 51) for o in offs)
        self.lvl8 = _lvl8(cfg)
        self.rdoq, self.sbh = cfg.rdoq, cfg.pps.sign_data_hiding
        self.deblock, self.sao = cfg.deblocking, sps.sao_enabled
        self.fetch = fetches_recon(cfg)
        self.use_wp = cfg.pps.weighted_pred
        self.R = max(1, cfg.num_ref_frames)
        self.MM = cfg.max_num_merge_cand
        self.nh16, self.nw16 = H // 16, W // 16
        self.nh32, self.nw32 = H // 32, W // 32
        self.nh64, self.nw64 = H // 64, W // 64
        self.h8, self.w8 = H // 8, W // 8
        self.n16 = self.nh16 * self.nw16
        self.Hc, self.Wc = H // 2, W // 2
        self.use_tusplit = sps.max_tu_depth_inter >= 1
        self.deep = sps.max_tu_depth_inter >= 2
        self.use_tmvp = sps.temporal_mvp_enabled
        self.log2_ctu = sps.log2_ctu
        R2 = self.R2 = sr // 2
        nc = self.nc = 2 * R2 + 1
        cb = np.zeros((nc, nc), np.int64)
        for dy in range(nc):
            for dx in range(nc):
                cb[dy, dx] = (_mvd_bits_np(8 * (dx - R2))
                              + _mvd_bits_np(8 * (dy - R2)))
        self.coarse_bits = torch.as_tensor(cb.reshape(-1), device=dev)
        if self.sr_full > sr:
            P4 = self.sr_full // 4
            n4 = 2 * P4 + 1
            d = np.abs(np.arange(n4) - P4) * 16
            lb = 2 * np.ceil(np.log2(2.0 * d + 1.0)).astype(np.int64)
            self.pre_bits = torch.as_tensor(
                (lb[:, None] + lb[None, :] + 2).reshape(-1),
                dtype=torch.int32, device=dev)
        self.LOOK = self.sr_full + 4
        self.PADL = self.LOOK + 4
        self.LOOKC = self.sr_full // 2 + 2
        self.PADC = self.LOOKC + 2
        self.HmL, self.WmL = H + 2 * self.LOOK, W + 2 * self.LOOK
        self.HmC, self.WmC = self.Hc + 2 * self.LOOKC, self.Wc + 2 * self.LOOKC
        # the reference rows a row stripe reads beyond its own, luma and
        # chroma: the phase planes' padding, which covers the refine's
        # reach (starts within +-sr_full, the 7x7 window: sr_full + 3), the
        # coarse search's (2 R2) and the prestage's (4 P4); a multiple of
        # 4, so the pooled levels of a stripe line up with the picture's
        self.KY, self.KC = self.PADL, self.PADC
        assert (self.KY >= max(self.sr_full + 3, 2 * R2, self.sr_full)
                and self.KY % 4 == 0)
        self.ref_bits_me = [min(r + 1, max(1, self.R - 1))
                            for r in range(self.R)]
        # grid_refine's reference bits on the card (none with one
        # reference, as the reference's acc_init adds none), the coarse
        # start's scale of each further reference, and the reference of
        # each start (by the count of reference 0's starts and of the
        # references searched)
        z32 = dict(dtype=torch.int32, device=dev)
        self.rbits_me = (torch.as_tensor(self.ref_bits_me, **z32)
                         if self.R > 1 else None)
        self.ref_scales = torch.arange(2, self.R + 1, **z32)[:, None]
        self._sref: dict = {}
        self.nn = {}
        if cfg.fme_mode == "nn":
            for qp in set(self.qps):
                p = nn_by_qp.get(qp)
                if p is not None:
                    self.nn[qp] = NNFME.from_numpy(p, dev)
        tr, bl = _intra_static(self.nh16, self.nw16, sps.log2_ctu)
        self.avtr = torch.as_tensor(tr, device=dev)
        self.avbl = torch.as_tensor(bl, device=dev)
        self.avtr_flat = self.avtr.reshape(-1).contiguous()
        self.avbl_flat = self.avbl.reshape(-1).contiguous()
        self.imodes = torch.as_tensor(IMODES, dtype=torch.int32, device=dev)
        self._col_geom_cache: dict = {}
        # grid_satd_cost's outputs on the card, by call site and size: each
        # call site's costs are consumed on the card before the step's next
        # request to codec.stripes, and never fetched, so the next call of
        # the site (in this picture, another stripe's or the next
        # picture's) may write the same buffer in stream order
        self._cost_out: dict = {}
        # grid_intra16's outputs on the card, by call site, stripe and
        # size: the decision's modes are read by the second call of the
        # same stripe and picture, later requests of codec.stripes, so each
        # stripe (row origin) has its own; the next picture's call of the
        # site writes them in stream order after this picture's reads
        self._intra_out: dict = {}
        self._c_s_of: dict = {}

    # --- helpers ------------------------------------------------------
    def _dcc(self, qp, npx, lam_me) -> int:
        qstep = 2.0 ** ((qp - 4) / 6.0)
        return int((lam_me * 12) >> 8) + int(npx * qstep / 4.0)

    def _col_geom(self, S, nbh, nbw, rows: Rows):
        """TMVP's collocated indices of the S-blocks of the stripe `rows`
        into its rows of the collocated maps: the bottom-right block where
        it is usable (ok0; in the block's CTU row, so in the stripe), else
        the centre."""
        key = (S, rows.y0, rows.y1)
        hit = self._col_geom_cache.get(key)
        if hit is None:
            H, W = self.H, self.W
            hc16, wc16 = (self.h8 + 1) // 2, (self.w8 + 1) // 2
            r16, nh = rows.y0 // 16, (rows.y1 - rows.y0) // 16
            x0 = (np.arange(nbw) * S)[None, :].repeat(nbh, 0)
            y0 = (rows.y0 + np.arange(nbh) * S)[:, None].repeat(nbw, 1)
            xbr, ybr = x0 + S, y0 + S
            lc = self.log2_ctu
            ok0 = (((ybr >> lc) == (y0 >> lc)) & (ybr < H) & (xbr < W))
            i0r = np.clip(ybr >> 4, 0, hc16 - 1) - r16
            assert ((i0r >= 0) & (i0r < nh))[ok0].all()
            i0 = (np.clip(i0r, 0, nh - 1) * wc16
                  + np.clip(xbr >> 4, 0, wc16 - 1)).ravel()
            xc, yc = x0 + S // 2, y0 + S // 2
            i1 = (((yc >> 4) - r16) * wc16 + (xc >> 4)).ravel()
            hit = tuple(torch.as_tensor(a, device=self.dev)
                        for a in (ok0.reshape(-1), i0.astype(np.int64),
                                  i1.astype(np.int64)))
            self._col_geom_cache[key] = hit
        return hit

    @staticmethod
    def _pad_edge(p: torch.Tensor, n: int) -> torch.Tensor:
        h, w = p.shape
        ys = (torch.arange(h + 2 * n, device=p.device) - n).clamp(0, h - 1)
        xs = (torch.arange(w + 2 * n, device=p.device) - n).clamp(0, w - 1)
        return p[ys][:, xs].contiguous()

    def _pooled(self, ry: torch.Tensor, f: int, n: int,
                rows: Rows) -> torch.Tensor:
        """The f x f tile sums of the stripe `rows` of a luma reference
        read with its carried halo rows (ry), padded by n pooled rows and
        columns as `_pad_edge` pads the whole picture's: pooled rows past
        the picture repeat its edge rows."""
        t = tile_sum(ry, f).int()
        g = (torch.arange(rows.y0 // f - n, rows.y1 // f + n, device=ry.device)
             .clamp(0, rows.H // f - 1) - (rows.y0 - rows.above(self.KY)) // f)
        w = t.shape[1]
        xs = (torch.arange(w + 2 * n, device=ry.device) - n).clamp(0, w - 1)
        return t[g][:, xs].contiguous()

    def pick_coarse(self, s16, sum16, qp, lam_me, nbh, nbw, f):
        """Coarse winner per block; f = aggregation factor in 16-units."""
        nc = self.nc
        s, sm = s16, sum16
        if f > 1:
            s = s[:, : nbh * f, : nbw * f].reshape(-1, nbh, f, nbw, f).sum(
                dim=(2, 4))
            sm = sm[:, : nbh * f, : nbw * f].reshape(-1, nbh, f, nbw, f).sum(
                dim=(2, 4))
        s = zcost(s, sm, self._dcc(qp, (16 * f) ** 2, lam_me))
        cost = s + ((self.coarse_bits[:, None, None] * lam_me) >> 8)
        ci = torch.argmin(cost.reshape(nc * nc, -1), dim=0)
        return (ci % nc - self.R2).int(), (ci // nc - self.R2).int()

    def refine(self, ry, oy, starts, S, nbh, nbw, qp, lam_me, quads=False,
               ry_y0=0):
        """grid_refine over the start grids [(x, y) full-pel per block];
        ry_y0: the row of `ry` level with `oy`'s row 0 (a row stripe with
        halo rows above it)."""
        st = torch.stack([torch.stack([x.reshape(-1).int(),
                                       y.reshape(-1).int()], -1)
                          for x, y in starts]).contiguous()
        return grid_refine(ry, oy, S, nbh, nbw, st, quads,
                           self._dcc(qp, S * S, lam_me),
                           self._dcc(qp, 64, lam_me), lam_me,
                           self.sr_full + 3, ry_y0)

    def refine_refs(self, ry_me, oy, st0, cxy, nref, S, nbh, nbw, qp,
                    lam_me, quads=False, ry_y0=0):
        """grid_refine over every searched reference in one launch: st0
        reference 0's start grids [(x, y) full-pel per block], then for
        each reference r in 1..nref-1 the coarse winner cxy (2-sample
        units) scaled by r + 1 and clipped to +-R2 -> ((mv, sad9, cost,
        ref), the quadrants' or None), each the winner over the
        references."""
        R2 = self.R2
        sc = (torch.stack(cxy)[:, None] * self.ref_scales[: nref - 1]
              ).clamp_(-R2, R2).mul_(2)  # (2, nref - 1, nb)
        st = torch.stack([torch.cat([torch.stack([x.reshape(-1)
                                                  for x, _ in st0]), sc[0]]),
                          torch.cat([torch.stack([y.reshape(-1)
                                                  for _, y in st0]), sc[1]])],
                         -1)
        key = (len(st0), nref)
        sref = self._sref.get(key)
        if sref is None:
            sref = self._sref[key] = torch.cat([
                torch.zeros(len(st0), dtype=torch.int32, device=self.dev),
                torch.arange(1, nref, dtype=torch.int32, device=self.dev)])
        return grid_refine_refs(ry_me, oy, S, nbh, nbw, st, quads,
                                self._dcc(qp, S * S, lam_me),
                                self._dcc(qp, 64, lam_me), lam_me,
                                self.sr_full + 3, ry_y0, sref, self.rbits_me)

    def intra_out(self, site, rows: Rows, nh16):
        """grid_intra16's kept outputs of call site `site` in the stripe
        `rows` (`_intra_out`), on the card; None on the CPU."""
        if self.dev.type != "cuda":
            return None
        key = (site, rows.y0, nh16)
        out = self._intra_out.get(key)
        if out is None:
            out = self._intra_out[key] = intra16_out(nh16, self.nw16,
                                                     self.dev)
        return out

    def mc(self, planes_y, planes_c, mv8, ref8):
        """Per-8-cell fields (h8', w8', 2) / (h8', w8') -> the luma and the
        packed [U | V] chroma prediction, one launch on the card."""
        return grid_mc(planes_y, planes_c, mv8, ref8, self.LOOK, self.LOOKC)

    def _c_s(self, S, qp) -> float:
        """satd_z's DC clamp term of S-CUs, (S S) qstep / 4 (float32)."""
        c = self._c_s_of.get((S, qp))
        if c is None:
            c = self._c_s_of[(S, qp)] = float(np.float32(
                (S * S) * 2.0 ** ((qp - 4) / 6.0) / 4.0))
        return c

    def satd_costs(self, site, planes_y, oy, fields, mode="z",
                   lam_me_f=None):
        """grid_satd_cost of the fields (one launch on the card), into the
        call site's kept outputs on the card (`_cost_out`)."""
        out = None
        if self.dev.type == "cuda":
            shapes = tuple((fl.rows, fl.cols) for fl in fields)
            out = self._cost_out.get((site, shapes))
            if out is None:
                buf = torch.empty(sum(r * c for r, c in shapes),
                                  dtype=torch.float32, device=self.dev)
                out = self._cost_out[(site, shapes)] = [
                    v.view(r, c) for v, (r, c) in zip(
                        buf.split([r * c for r, c in shapes]), shapes)]
        return grid_satd_cost(planes_y, oy, fields, self.LOOK, mode, lam_me_f,
                              out)

    def cu_field(self, mv_grid, ref_grid, S, qp):
        """The DC-aware cost field of S-CUs at (nbh, nbw, 2) / (nbh, nbw)."""
        nbh, nbw = ref_grid.shape
        return SatdField(mv_grid.contiguous(), ref_grid.contiguous(), S, nbh,
                         nbw, 0, self._c_s(S, qp))

    def pred_satd_z(self, planes_y, oy, mv_grid, ref_grid, S, qp, lam_me_f):
        """The DC-aware SATD per S-CU of the prediction at its MV."""
        return grid_satd_cost(planes_y, oy, [self.cu_field(
            mv_grid, ref_grid, S, qp)], self.LOOK, "z", lam_me_f)[0]

    # --- the merge-candidate sweep ---------------------------------------
    def cand_sweep_all(self, tabs, qp, lam_me_f, oy, planes_y, specs):
        """specs: [(S, nbh, nbw, mv (nbh, nbw, 2), ref (nbh, nbw))], the
        16 class first (its cover holds every class's) -> per spec
        (mv, ref, mode_b, merged, midx_b)."""
        return run_one(self._sweep(tabs, qp, lam_me_f, oy, planes_y, specs,
                                   Rows(0, self.H, self.H)), self.dev)

    def _sweep(self, tabs, qp, lam_me_f, oy, planes_y, specs, rows: Rows):
        """`cand_sweep_all` over the row stripe `rows`: before each
        vertical pass the classes' (mv, ref) fields of every stripe are
        gathered, and the candidates `dist` block rows up taken from them
        (wrapping as the whole picture's roll does, masked at its top)."""
        dev = self.dev
        site = ("sweep", specs[0][0])

        def batch_satd(grids, first=False):
            # every class's candidates in one launch; the first call's
            # costs outlive the first pass: a buffer of their own
            return self.satd_costs(
                site + (first,), planes_y, oy,
                [self.cu_field(mv_g, ref_g, S, qp)
                 for (S, _, _, _, _), (mv_g, ref_g) in zip(specs, grids)],
                "z", lam_me_f)

        states = []
        for (S, nbh_, nbw_, mv, ref), s0 in zip(
                specs, batch_satd([(mv, ref) for (_, _, _, mv, ref)
                                   in specs], True)):
            states.append((mv, ref, s0,
                           torch.zeros((nbh_, nbw_), dtype=torch.bool,
                                       device=dev),
                           torch.zeros((nbh_, nbw_), dtype=torch.float32,
                                       device=dev)))
        # the passes' distances from the picture's block grid
        dmax = max(max(rows.H // s[0], s[2]) for s in specs)
        dists = [d for d in (1, 4, 16) if d < dmax] + [1]
        mvd_lut, ref_lut = tabs.mvd_lut, tabs.ref_bits
        lam_b = lam_me_f * MERGE_BIAS
        for dist in dists:
            for axis, mb in ((1, tabs.midx[0]), (0, tabs.midx[1])):
                if axis == 1:
                    cands = [(torch.roll(st[0], dist, 1),
                              torch.roll(st[1], dist, 1)) for st in states]
                else:
                    full = yield Gather([t for st in states for t in st[:2]])
                    cands = []
                    for k, (S, nbh_, _, _, _) in enumerate(specs):
                        r0 = rows.y0 // S
                        cands.append(tuple(
                            torch.roll(f, dist, 0)[r0 : r0 + nbh_]
                            for f in full[2 * k : 2 * k + 2]))
                satcs = batch_satd(cands)
                new = []
                for (S, nbh_, nbw_, _, _), st, (mvc, refc), satc in zip(
                        specs, states, cands, satcs):
                    mv_g, ref_g, s0, mrg, mib = st
                    if axis == 1:
                        edge = (torch.arange(nbw_, device=dev)[None] < dist
                                ).expand(nbh_, nbw_)
                    else:
                        edge = (torch.arange(rows.y0 // S, rows.y0 // S + nbh_,
                                             device=dev)[:, None]
                                < dist).expand(nbh_, nbw_)
                    dmv = torch.clamp((mv_g - mvc).abs(), max=4095).long()
                    keep_b = (mvd_lut[dmv[..., 0]] + mvd_lut[dmv[..., 1]]
                              + ref_lut[ref_g.long()] + tabs.mf0 + tabs.mvp)
                    keep_b = torch.where(mrg, tabs.mf1 + mib, keep_b)
                    adopt = ((satc + lam_b * (tabs.mf1 + mb)
                              <= s0 + lam_b * keep_b) & ~edge)
                    new.append((torch.where(adopt[..., None], mvc, mv_g),
                                torch.where(adopt, refc, ref_g),
                                torch.where(adopt, satc, s0), mrg | adopt,
                                torch.where(adopt, mb, mib)))
                states = new
        outs = []
        # the top neighbours: the block row above the stripe (row 0
        # repeated at the picture's top)
        above = yield Halo([HaloItem(st[0], 1, 0) for st in states])
        for (mv_g, ref_g, _, merged, midx_b), ab in zip(states, above):
            left = torch.cat([mv_g[:, :1], mv_g[:, :-1]], 1)
            top = ab[: mv_g.shape[0]]
            d1 = torch.clamp((mv_g - left).abs(), max=4095).long()
            d2 = torch.clamp((mv_g - top).abs(), max=4095).long()
            mvd_b = torch.minimum(mvd_lut[d1[..., 0]] + mvd_lut[d1[..., 1]],
                                  mvd_lut[d2[..., 0]] + mvd_lut[d2[..., 1]])
            amvp_b = tabs.mf0 + ref_lut[ref_g.long()] + tabs.mvp + mvd_b
            mode_b = (tabs.pred_inter + tabs.part2n
                      + torch.where(merged, tabs.mf1 + midx_b, amvp_b))
            outs.append((mv_g, ref_g, mode_b, merged, midx_b))
        return outs

    # --- class coding ----------------------------------------------------
    def _txq(self, jobs):
        """grid_code of each job (orig, pred, T, qp, lam, est, cbf), in one
        launch on the card; lam and cbf stay device tensors, which the
        kernel reads there."""
        return grid_code_batch(jobs, self.lvl8, self.rdoq, self.sbh)

    def class_code(self, qp, tabs, lam, oy, ouv, planes_y, planes_c,
                   mv_grid, ref_grid, S, nbh, nbw, mv_cells=None,
                   ref_cells=None, tusplit=False):
        """Code every S-block under mv_grid/ref_grid (or per-8-cell maps)
        with TU = min(S, 32) and, with tusplit, the RQT below it."""
        dev = self.dev
        qpc = chroma_qp(qp)
        T = min(S, 32)
        log2t = T.bit_length() - 1
        Hp, Wp = nbh * S, nbw * S
        fT = S // T
        oy_c = oy[:Hp, :Wp].contiguous()
        if mv_cells is None:
            mv_cells = up(mv_grid.permute(2, 0, 1), S // 8).permute(1, 2, 0)
            ref_cells = up(ref_grid, S // 8)
        mv_cells = mv_cells.contiguous()
        ref_cells = ref_cells.contiguous()
        pred_y, pred_uv = self.mc(planes_y, planes_c, mv_cells, ref_cells)
        do_split = tusplit and T >= 16
        deep = do_split and S == 32 and self.deep
        Sc = S // 2
        Tc = 16 if S == 64 else min(Sc, 32)
        fTc = Sc // Tc
        Hpc, Wpc = Hp // 2, Wp // 2
        ouv_c = torch.cat([ouv[:Hpc, :Wpc], ouv[:Hpc, self.Wc : self.Wc + Wpc]],
                          dim=1).contiguous()
        wch = _f32(2.0 ** ((qp - qpc) / 3.0), dev)
        lam_c = lam / wch
        # the luma and chroma planes at each RQT depth: one launch
        jobs = []
        for f in (1, 2, 4)[:1 + do_split + deep]:
            jobs += [(oy_c, pred_y, T // f, qp, lam,
                      tabs.est_y[log2t - f.bit_length() + 1], tabs.cbf_y),
                     (ouv_c, pred_uv, Tc // f, qpc, lam_c,
                      tabs.est_c[(Tc // f).bit_length() - 1], tabs.cbf_c)]
        coded = self._txq(jobs)
        lvl, rec, d_tu, b_tu, cbf_tu, d0_tu = coded[0]
        lvl_c, rec_c, duv, buv, nzk, dc0 = coded[1]
        split_tu = td8 = None
        if do_split:
            T2 = T // 2
            lvl2, rec2, d_tu2, b_tu2, cbf_tu2, _ = coded[2]
            Tc2 = Tc // 2
            lvl_c2, rec_c2, duv2, buv2, nzk2, _ = coded[3]
            split16 = None
            if deep:
                lvl4, rec4, d_tu4, b_tu4, cbf_tu4, _ = coded[4]
                lvl_c4, rec_c4, duv4, buv4, nzk4, _ = coded[5]

                def csum4(x):  # Tc4 chroma (packed) -> T2-tile grid
                    ntw = x.shape[1] // 2
                    return sum22(x[:, :ntw]) + sum22(x[:, ntw:])

                def c0sum2(x):
                    ntw = x.shape[1] // 2
                    return x[:, :ntw] + x[:, ntw:]

                sd16 = tabs.tsplit[log2t - 1][1] - tabs.tsplit[log2t - 1][0]
                c16a = (d_tu2 + wch * c0sum2(duv2)
                        + lam * (b_tu2 + c0sum2(buv2)))
                c16b = (sum22(d_tu4) + wch * csum4(duv4)
                        + lam * (sum22(b_tu4) + csum4(buv4) + sd16))
                split16 = c16b < c16a
                sp2 = up(split16, T // 2)
                lvl2 = torch.where(sp2, lvl4, lvl2)
                rec2 = torch.where(sp2, rec4, rec2)
                d_tu2 = torch.where(split16, sum22(d_tu4), d_tu2)
                b_tu2 = torch.where(split16, sum22(b_tu4) + sd16, b_tu2)
                cbf_tu2 = torch.where(split16, sum22(cbf_tu4), cbf_tu2)
                spc2 = torch.cat([up(split16, Tc2)] * 2, dim=1)
                lvl_c2 = torch.where(spc2, lvl_c4, lvl_c2)
                rec_c2 = torch.where(spc2, rec_c4, rec_c2)

                def csel2(base, fine):
                    n4 = fine.shape[1] // 2
                    fpk = torch.cat([sum22(fine[:, :n4]),
                                     sum22(fine[:, n4:])], dim=1)
                    sel = torch.cat([split16] * 2, dim=1)
                    return torch.where(sel, fpk, base)

                duv2 = csel2(duv2, duv4)
                buv2 = csel2(buv2, buv4)
                nzk2 = csel2(nzk2, nzk4)

            def csum(x):
                ntw = x.shape[1] // 2
                return sum22(x[:, :ntw]) + sum22(x[:, ntw:])

            def c0sum(x):
                ntw = x.shape[1] // 2
                return x[:, :ntw] + x[:, ntw:]

            sdelta = tabs.tsplit[log2t][1] - tabs.tsplit[log2t][0]
            cost_a = d_tu + wch * c0sum(duv) + lam * (b_tu + c0sum(buv))
            cost_b = (sum22(d_tu2) + wch * csum(duv2)
                      + lam * (sum22(b_tu2) + csum(buv2) + sdelta))
            split_tu = cost_b < cost_a
            spp = up(split_tu, T)
            lvl = torch.where(spp, lvl2, lvl)
            rec = torch.where(spp, rec2, rec)
            d_tu = torch.where(split_tu, sum22(d_tu2), d_tu)
            b_tu = torch.where(split_tu, sum22(b_tu2) + sdelta, b_tu)
            cbf_tu = torch.where(split_tu, sum22(cbf_tu2), cbf_tu)
            spc = torch.cat([up(split_tu, Tc)] * 2, dim=1)
            lvl_c = torch.where(spc, lvl_c2, lvl_c)
            rec_c = torch.where(spc, rec_c2, rec_c)
            sel_cp = torch.cat([split_tu] * 2, dim=1)

            def csel(base, fine):
                n2 = fine.shape[1] // 2
                fpk = torch.cat([sum22(fine[:, :n2]), sum22(fine[:, n2:])],
                                dim=1)
                return torch.where(sel_cp, fpk, base)

            duv = csel(duv, duv2)
            buv = csel(buv, buv2)
            nzk = csel(nzk, nzk2)
            td8 = up(split_tu.to(torch.int8), T // 8)
            if split16 is not None:
                td8 = td8 + (up(split_tu, T // 8)
                             & up(split16, T // 16)).to(torch.int8)

        def cu_sum(x):
            return x if fT == 1 else sum22(x)

        def cu_sum_c(x):
            ntw = x.shape[1] // 2
            u_, v_ = x[:, :ntw], x[:, ntw:]
            if fTc > 1:
                u_, v_ = sum22(u_), sum22(v_)
            return u_ + v_

        out = dict(lvl=lvl, rec=rec, lvl_c=lvl_c, rec_c=rec_c,
                   d=cu_sum(d_tu) + wch * cu_sum_c(duv),
                   bits=cu_sum(b_tu) + cu_sum_c(buv),
                   cbf=(cu_sum(cbf_tu) + cu_sum_c(nzk)) > 0,
                   d0=cu_sum(d0_tu) + wch * cu_sum_c(dc0),
                   pred=pred_y, pred_c=pred_uv)
        if split_tu is not None:
            out["tsplit"] = split_tu
            out["td8"] = td8
        return out

    def cu_cost(self, tabs, lam, c, mode_b, merged, midx_b, S):
        cbf = c["cbf"]
        syn_skip = tabs.skip1 + midx_b
        syn_code = tabs.skip0 + mode_b + torch.where(
            merged, torch.zeros_like(mode_b),
            torch.where(cbf, tabs.root1, tabs.root0))
        syn = torch.where(~cbf & merged, syn_skip, syn_code)
        bits = syn + torch.where(cbf, c["bits"], torch.zeros_like(c["bits"]))
        if S > 8:
            bits = bits + tabs.split[0]
        return c["d"] + lam * bits, bits

    # --- intra-16 in P pictures ------------------------------------------
    def intra16_code(self, qp, tabs, lam, oy, ouv, pred_y, pred_uv):
        qpc = chroma_qp(qp)
        Hp, Wp = pred_y.shape
        Hpc, Wpc = Hp // 2, Wp // 2
        ouv_c = torch.cat([ouv[:Hpc, :Wpc], ouv[:Hpc, self.Wc : self.Wc + Wpc]],
                          dim=1).contiguous()
        wch = _f32(2.0 ** ((qp - qpc) / 3.0), self.dev)
        lam_c = lam / wch
        (lvl, rec, d_cu, b_cu, cbf_cu, _), (lvl_c, rec_c, duv, buv, nzk, _) = \
            self._txq([(oy[:Hp, :Wp].contiguous(), pred_y, 16, qp, lam,
                        tabs.est_y[4], tabs.cbf_y),
                       (ouv_c, pred_uv, 8, qpc, lam_c, tabs.est_c[3],
                        tabs.cbf_c)])
        ntw = duv.shape[1] // 2

        def cs(x):
            return x[:, :ntw] + x[:, ntw:]

        return dict(lvl=lvl, rec=rec, lvl_c=lvl_c, rec_c=rec_c,
                    d=d_cu + wch * cs(duv), bits=b_cu + cs(buv),
                    cbf=(cbf_cu + cs(nzk)) > 0)

    def intra16_cost(self, tabs, lam, ci):
        hdr = (tabs.skip0 + tabs.pred_intra + tabs.prev_mode[0] + 5.0
               + tabs.chroma_dm + 1.0)
        return ci["d"] + lam * (hdr + ci["bits"] + tabs.split[0])

    def intra_suppress(self, cand):
        """Deterministic 4-phase keep mask: a kept cell never uses another
        (potentially) intra cell's reconstruction as reference."""
        nh, nw = self.nh16, self.nw16
        avtr, avbl = self.avtr, self.avbl
        F = torch.nn.functional

        def prov(m):
            m8 = m.to(torch.uint8)
            pl = F.pad(m8, (1, 0))[:, :-1]
            pt = F.pad(m8, (0, 0, 1, 0))[:-1]
            ptl = F.pad(m8, (1, 0, 1, 0))[:-1, :-1]
            ptr = F.pad(m8, (0, 1, 1, 0))[:-1, 1:].bool() & avtr
            pbl = F.pad(m8, (1, 0, 0, 1))[1:, :-1].bool() & avbl
            return pl.bool() | pt.bool() | ptl.bool() | ptr | pbl

        bxg = torch.arange(nw, device=self.dev)[None].expand(nh, nw)
        byg = torch.arange(nh, device=self.dev)[:, None].expand(nh, nw)
        kept = torch.zeros((nh, nw), dtype=torch.bool, device=self.dev)
        decided = torch.zeros_like(kept)
        for px_, py_ in ((0, 0), (1, 0), (0, 1), (1, 1)):
            ph = (bxg % 2 == px_) & (byg % 2 == py_)
            blocked = prov(kept) | prov(cand & ~decided)
            kept = kept | (cand & ph & ~blocked)
            decided = decided | ph
        return kept

    # --- one P picture ---------------------------------------------------
    def source(self, fu8: torch.Tensor):
        """A picture's (W*H*3/2,) uint8 planes -> (oy (H, W), ouv (H/2, W)
        packed [U | V]) int32."""
        W, H, Hc, Wc = self.W, self.H, self.Hc, self.Wc
        oy = fu8[: W * H].reshape(H, W).int()
        ou = fu8[W * H : W * H * 5 // 4].reshape(Hc, Wc)
        ov = fu8[W * H * 5 // 4 :].reshape(Hc, Wc)
        return oy, torch.cat([ou, ov], dim=1).int()

    def frame_step(self, carry, fu8, navail: int, gpos: int, tabs: _Tabs,
                   wp=None):
        """One P picture -> (the next carry, the packed row). wp: with
        weighted prediction, the picture's (w (R, 3), o (R, 3)) int32
        tensors per reference and component (Y, Cb, Cr) and the
        denominator d (an int, luma and chroma alike)."""
        carry, parts = run_one(self.frame_steps(
            carry, self.source(fu8), navail, gpos, tabs, wp), self.dev)
        return carry, torch.cat([p for p, _ in parts])

    def frame_steps(self, carry, src, navail: int, gpos: int, tabs: _Tabs,
                    wp=None, rows: Rows | None = None):
        """`frame_step` of the row stripe `rows` (default the whole
        picture), a generator of the requests of `codec.stripes` ->
        (the stripe's next carry, the packed row's parts [(uint8 bytes,
        per_rows)]: per_rows parts hold the stripe's rows of a picture
        field, the others the picture's values, equal in every stripe).
        carry: the stripe's rows of the carry; src: its (oy, ouv) rows.
        Stripes start on 64-row boundaries, so that every 32- and 64-class
        block and every CTU lies inside one."""
        ry_stack, ruv_stack, mv16p, colmv_g, coltd_g = carry
        oy, ouv = src
        rows = rows or Rows(0, self.H, self.H)
        dev = self.dev
        W, Wc = self.W, self.Wc
        hs = rows.y1 - rows.y0
        r16 = rows.y0 // 16
        nh16, nw16, nh32, nw32 = hs // 16, self.nw16, hs // 32, self.nw32
        nh64, nw64, h8, w8 = hs // 64, self.nw64, hs // 8, self.w8
        n16, R, R2, nc = nh16 * nw16, self.R, self.R2, self.nc
        has32, has64 = nh32 * nw32 > 0, nh64 * nw64 > 0
        KY, KC = self.KY, self.KC
        u8 = torch.uint8
        qp = self.qps[gpos]
        lam_py = p_frame_lambda(self.cfg, gpos, qp)
        lam = _f32(lam_py, dev)
        lam_me_f = _f32(np.sqrt(lam_py), dev)
        lam_me = int(round(np.sqrt(lam_py) * 256))

        # --- ME ------------------------------------------------------------
        # with WP the search reads the weighted full-pel references; the
        # phase planes keep the unweighted ones and fold the weights into
        # their rounding (chroma stack: [U refs | V refs])
        wpy = wpc = None
        if self.use_wp:
            wpw, wpo, wpd = wp
            wpy = (wpw[:, 0].contiguous(), wpo[:, 0].contiguous(), wpd)
            wpc = (torch.cat([wpw[:, 1], wpw[:, 2]]),
                   torch.cat([wpo[:, 1], wpo[:, 2]]), wpd)
        # the carried reference stacks hold the stripe's rows with up to
        # KY (KC) halo rows of the picture's above and below: ya of them
        # above (none for the whole picture)
        ya = rows.above(KY)
        if ry_stack.shape[1] != ya + hs + rows.below(KY):
            raise ValueError(f"frame_steps: reference rows "
                             f"{ry_stack.shape[1]} for the stripe {rows}")
        ry_me = ry_stack if wpy is None else grid_wp_me(ry_stack, *wpy)
        oy2 = tile_sum(oy, 2).int()
        ry0 = ry_me[0]
        ry2p = self._pooled(ry0, 2, R2, rows)
        s16c, sum16c = grid_coarse(oy2, ry2p, nc, 8, 1, True)
        cx16, cy16 = self.pick_coarse(s16c, sum16c, qp, lam_me, nh16, nw16, 1)
        if has32:
            cx32, cy32 = self.pick_coarse(s16c, sum16c, qp, lam_me, nh32,
                                          nw32, 2)
        gtot = zcost(s16c, sum16c, self._dcc(qp, 256, lam_me))
        # the global candidate: the picture's sums (integers: exact in any
        # order), the first-index argmin
        (gsum,) = yield Once(_sum_once, [gtot.sum(dim=(1, 2))])
        # on the card: the start stays a tensor, so nothing waits on it
        gi = torch.argmin(gsum)
        g2 = torch.stack([gi % nc, gi // nc]).sub_(R2).mul_(2).int()
        sf = self.sr_full
        tx_ = mv16p[:, 0].clamp(-sf, sf).reshape(nh16, nw16)
        ty_ = mv16p[:, 1].clamp(-sf, sf).reshape(nh16, nw16)
        pre16 = pre32 = None
        if sf > self.sr:
            P4 = sf // 4
            n4 = 2 * P4 + 1
            oy4 = tile_sum(oy, 4).int()
            ry4p = self._pooled(ry0, 4, P4, rows)
            barg = grid_prestage(oy4, ry4p, n4, 4, 2, self.pre_bits, lam_me)
            lim_ps = sf - 4
            px_ = ((barg % n4 - P4) * 4).clamp(-lim_ps, lim_ps).int()
            py_ = ((barg // n4 - P4) * 4).clamp(-lim_ps, lim_ps).int()
            pre16 = (px_, py_)
            if has32:
                pre32 = (px_[: nh32 * 2 : 2, : nw32 * 2 : 2],
                         py_[: nh32 * 2 : 2, : nw32 * 2 : 2])

        def starts0(cxr, cyr, ts, pre):
            zero = torch.zeros_like(cxr)
            st = [(cxr * 2, cyr * 2), (zero, zero),
                  (g2[0].expand_as(cxr), g2[1].expand_as(cxr)), ts]
            if pre is not None:
                st.append(pre)
            return st

        # one launch a block size over every searched reference: the
        # references past the available ones cost 2^30 in the reference
        # and are never taken, so they are not searched
        nref = min(R, navail)
        (mv16, sad9_16, _, ref16), (mv8, sad9_8, _, ref8) = self.refine_refs(
            ry_me, oy, starts0(cx16, cy16, (tx_, ty_), pre16), (cx16, cy16),
            nref, 16, nh16, nw16, qp, lam_me, quads=True, ry_y0=ya)
        if has32:
            ts32 = (tx_[: nh32 * 2 : 2, : nw32 * 2 : 2],
                    ty_[: nh32 * 2 : 2, : nw32 * 2 : 2])
            (mv32, sad9_32, _, ref32), _ = self.refine_refs(
                ry_me, oy, starts0(cx32, cy32, ts32, pre32), (cx32, cy32),
                nref, 32, nh32, nw32, qp, lam_me, ry_y0=ya)

        # --- MC planes, FME --------------------------------------------------
        # the stripe's phase planes: the rows of the picture's that its
        # reads reach (rows [-LOOK, hs + LOOK) of the stripe), read from
        # row ya of the padded stacks
        planes_y = grid_planes(ry_stack, True, self.PADL, hs + 2 * self.LOOK,
                               self.WmL, wpy, ya)
        planes_c = grid_planes(
            torch.cat([ruv_stack[:, :, :Wc], ruv_stack[:, :, Wc:]], 0)
            .contiguous(), False, self.PADC, hs // 2 + 2 * self.LOOKC,
            self.WmC, wpc, ya // 2)
        model = self.nn.get(qp)
        if model is not None:  # K2: every class in one launch
            offs = nn_refine_classes(model, [
                (sad9.contiguous(), height_category(S), width_category(S))
                for sad9, S in ((sad9_16, 16), (sad9_8, 8))
                + (((sad9_32, 32),) if has32 else ())])
            mvq16, mvq8 = mv16 * 4 + offs[0], mv8 * 4 + offs[1]
            if has32:
                mvq32 = mv32 * 4 + offs[2]
        elif self.cfg.fme_mode == "dctif":  # every class in one launch
            mvqs = grid_subpel_classes(planes_y, oy, [
                (mv.contiguous(), ref.contiguous(), S, nbh_, nbw_)
                for mv, ref, S, nbh_, nbw_ in (
                    (mv16, ref16, 16, nh16, nw16), (mv8, ref8, 8, h8, w8))
                + (((mv32, ref32, 32, nh32, nw32),) if has32 else ())],
                self.LOOK)
            mvq16, mvq8 = mvqs[:2]
            if has32:
                mvq32 = mvqs[2]
        else:  # FmeMode none, or nn without weights: integer-pel
            mvq16, mvq8 = mv16 * 4, mv8 * 4
            if has32:
                mvq32 = mv32 * 4

        # --- sweep + coding per class ---------------------------------------
        use_ts = self.use_tusplit

        def code_candidate(mvg, refg, mode_b, mergeable, midx_b, S, nbh,
                           nbw):
            c = self.class_code(qp, tabs, lam, oy, ouv, planes_y, planes_c,
                                mvg, refg, S, nbh, nbw,
                                tusplit=use_ts and 16 <= S
                                and (S < 64 or self.deep))
            cost, _ = self.cu_cost(tabs, lam, c, mode_b, mergeable, midx_b, S)
            skip_syn = tabs.skip1 + midx_b
            if S > 8:
                skip_syn = skip_syn + tabs.split[0]
            cost_skip = c["d0"] + lam * skip_syn
            force = mergeable & (cost_skip < cost)
            cost = torch.where(force, cost_skip, cost)
            fp = up(force, S)
            c["lvl"] = torch.where(fp, 0, c["lvl"])
            c["rec"] = torch.where(fp, c["pred"], c["rec"])
            fc = torch.cat([up(force, S // 2)] * 2, dim=1)
            c["lvl_c"] = torch.where(fc, 0, c["lvl_c"])
            c["rec_c"] = torch.where(fc, c["pred_c"], c["rec_c"])
            c["cbf"] = c["cbf"] & ~force
            if "tsplit" in c:
                c["tsplit"] = c["tsplit"] & ~up(force, S // min(S, 32))
                c["td8"] = torch.where(up(force, S // 8), 0, c["td8"])
            c.update(mv=mvg, ref=refg, cost=cost)
            return c

        def run_class(S, nbh, nbw, settled):
            mvg, refg, mode_b, merged, midx_b = settled
            # the top neighbours: the block row above the stripe from the
            # stripe above (row 0 repeated at the picture's top)
            above = yield Halo([HaloItem(mvg, 1, 0), HaloItem(refg, 1, 0)])
            mvT, refT = above[0][:nbh], above[1][:nbh]
            eqL = torch.cat([torch.zeros((nbh, 1), dtype=torch.bool,
                                         device=dev),
                             (mvg[:, 1:] == mvg[:, :-1]).all(-1)
                             & (refg[:, 1:] == refg[:, :-1])], dim=1)
            below_top = (torch.arange(rows.y0 // S, rows.y0 // S + nbh,
                                      device=dev) > 0)[:, None]
            eqT = (mvg == mvT).all(-1) & (refg == refT) & below_top
            mergeable = merged | eqL | eqT
            midx_b = torch.where(merged, midx_b, tabs.midx[0])
            merge_mode_b = tabs.pred_inter + tabs.part2n + tabs.mf1 + midx_b
            mode_b = torch.where(mergeable,
                                 torch.minimum(mode_b, merge_mode_b), mode_b)
            c = code_candidate(mvg, refg, mode_b, mergeable, midx_b, S, nbh,
                               nbw)
            # measured-RD merge trial: the best spatial or temporal
            # neighbour candidate coded as a merge
            mvL = torch.cat([mvg[:, :1], mvg[:, :-1]], 1)
            refL = torch.cat([refg[:, :1], refg[:, :-1]], 1)
            # the left, top and (with TMVP) collocated candidates' costs in
            # one launch
            cands = [(mvL, refL), (mvT, refT)]
            if self.use_tmvp:
                ok0m, i0m, i1m = self._col_geom(S, nbh, nbw, rows)
                tdf = coltd_g.reshape(-1)
                mvf = colmv_g.reshape(-1, 2)
                td0 = torch.where(ok0m, tdf[i0m], torch.zeros_like(tdf[i0m]))
                td1 = tdf[i1m]
                use0 = td0 > 0
                td = torch.where(use0, td0, td1)
                idx = torch.where(use0, i0m, i1m)
                mvc = mvf[idx]
                tx2 = torch.div(16384 + (td >> 1), td.clamp(min=1),
                                rounding_mode="floor")
                dsf = ((tx2 + 32) >> 6).clamp(-4096, 4095)
                p = dsf[:, None] * mvc
                sc = (torch.sign(p) * ((p.abs() + 127) >> 8)).clamp(
                    -32768, 32767)
                mvC = torch.where((td == 1)[:, None], mvc, sc).reshape(
                    nbh, nbw, 2).int()
                refC = torch.zeros((nbh, nbw), dtype=torch.int32, device=dev)
                okc = (td > 0).reshape(nbh, nbw)
                cands.append((mvC, refC))
            sats = self.satd_costs(
                ("merge", S), planes_y, oy,
                [self.cu_field(m, r_, S, qp) for m, r_ in cands], "z",
                lam_me_f)
            satL, satT = sats[0], sats[1]
            useT = satT < satL
            mvN = torch.where(useT[..., None], mvT, mvL)
            refN = torch.where(useT, refT, refL)
            midxN = torch.where(useT, tabs.midx[min(1, self.MM - 1)],
                                tabs.midx[0])
            if self.use_tmvp:
                satC = torch.where(okc, sats[2], _f32(3e38, dev))
                useC = satC < torch.minimum(satL, satT)
                mvN = torch.where(useC[..., None], mvC, mvN)
                refN = torch.where(useC, refC, refN)
                midxN = torch.where(useC, tabs.midx[min(2, self.MM - 1)],
                                    midxN)
            mode_bN = tabs.pred_inter + tabs.part2n + tabs.mf1 + midxN
            ones = torch.ones((nbh, nbw), dtype=torch.bool, device=dev)
            cm = code_candidate(mvN, refN, mode_bN, ones, midxN, S, nbh, nbw)
            take = cm["cost"] < c["cost"]
            tp = up(take, S)
            tc = torch.cat([up(take, S // 2)] * 2, dim=1)
            for k, m in (("lvl", tp), ("rec", tp), ("pred", tp),
                         ("lvl_c", tc), ("rec_c", tc), ("pred_c", tc)):
                c[k] = torch.where(m, cm[k], c[k])
            for k in ("d", "bits", "cbf", "d0", "cost"):
                c[k] = torch.where(take, cm[k], c[k])
            c["mv"] = torch.where(take[..., None], cm["mv"], c["mv"])
            c["ref"] = torch.where(take, cm["ref"], c["ref"])
            if "tsplit" in c:
                f = c["tsplit"].shape[0] // nbh
                c["tsplit"] = torch.where(up(take, f), cm["tsplit"],
                                          c["tsplit"])
                c["td8"] = torch.where(up(take, S // 8), cm["td8"], c["td8"])
            return c

        specs = [(16, nh16, nw16, mvq16.reshape(nh16, nw16, 2),
                  ref16.reshape(nh16, nw16)),
                 (8, h8, w8, mvq8.reshape(h8, w8, 2), ref8.reshape(h8, w8))]
        if has32:
            specs.append((32, nh32, nw32, mvq32.reshape(nh32, nw32, 2),
                          ref32.reshape(nh32, nw32)))
        settled = yield from self._sweep(tabs, qp, lam_me_f, oy, planes_y,
                                         specs, rows)
        c16 = yield from run_class(16, nh16, nw16, settled[0])
        if has32:
            c32 = yield from run_class(32, nh32, nw32, settled[2])
        c8 = yield from run_class(8, h8, w8, settled[1])
        cost8q = sum22(c8["cost"]) + lam * tabs.split[1]
        use8 = cost8q < c16["cost"]
        best16 = torch.minimum(c16["cost"], cost8q)

        def rect_trial(S, nbh_, nbw_, mv_c, ref_c, sq_mv):
            C = S // 2
            f = C // 8
            hc, wc = nbh_ * 2, nbw_ * 2
            mv_cg = mv_c[:hc, :wc]
            ref_cg = ref_c[:hc, :wc]
            # the half-CU cells' SATDs at the first and the second MV of
            # their horizontal, then vertical pairs: one launch
            mv_c, ref_c = mv_c.contiguous(), ref_c.contiguous()
            sats = self.satd_costs(
                ("rect", S), planes_y, oy,
                [SatdField(mv_c, ref_c, C, hc, wc, k) for k in (1, 2, 3, 4)],
                "plain")

            def half_pick(pair_axis):
                if pair_axis == 1:
                    first = mv_cg[:, 0::2].repeat_interleave(2, 1)
                    second = mv_cg[:, 1::2].repeat_interleave(2, 1)
                    rfirst = ref_cg[:, 0::2].repeat_interleave(2, 1)
                    rsecond = ref_cg[:, 1::2].repeat_interleave(2, 1)
                else:
                    first = mv_cg[0::2].repeat_interleave(2, 0)
                    second = mv_cg[1::2].repeat_interleave(2, 0)
                    rfirst = ref_cg[0::2].repeat_interleave(2, 0)
                    rsecond = ref_cg[1::2].repeat_interleave(2, 0)
                sA, sB = sats[0:2] if pair_axis == 1 else sats[2:4]
                if pair_axis == 1:
                    hA = sA[:, 0::2] + sA[:, 1::2]
                    hB = sB[:, 0::2] + sB[:, 1::2]
                    takeB = hB < hA
                    tB2 = takeB.repeat_interleave(2, 1)
                else:
                    hA = sA[0::2] + sA[1::2]
                    hB = sB[0::2] + sB[1::2]
                    takeB = hB < hA
                    tB2 = takeB.repeat_interleave(2, 0)
                return (torch.where(tB2[..., None], second, first),
                        torch.where(tB2, rsecond, rfirst),
                        torch.where(takeB, hB, hA))

            mv_h, ref_h, sat_h = half_pick(1)
            mv_v, ref_v, sat_v = half_pick(0)
            s2nxn = sat_h[0::2] + sat_h[1::2]
            snx2n = sat_v[:, 0::2] + sat_v[:, 1::2]
            pick_v = snx2n < s2nxn
            ptype = torch.where(pick_v, 2, 1).int()
            pv2 = up(pick_v, 2)
            mvpc = torch.where(pv2[..., None], mv_v, mv_h)
            refpc = torch.where(pv2, ref_v, ref_h)
            mv_cells = up(mvpc.permute(2, 0, 1), f).permute(1, 2, 0)
            ref_cells = up(refpc, f)
            cpart = self.class_code(qp, tabs, lam, oy, ouv, planes_y,
                                    planes_c, None, None, S, nbh_, nbw_,
                                    mv_cells=mv_cells, ref_cells=ref_cells)
            sqmv2 = up(sq_mv.permute(2, 0, 1), 2).permute(1, 2, 0)
            dmv = torch.clamp((mvpc - sqmv2).abs(), max=4095).long()
            pu_bc = (tabs.mvd_lut[dmv[..., 0]] + tabs.mvd_lut[dmv[..., 1]]
                     + tabs.ref_bits[refpc.long()] + tabs.mf0 + tabs.mvp)
            pu_bits = 0.5 * sum22(pu_bc)
            mode_bp = (tabs.pred_inter + pu_bits
                       + torch.where(pick_v, tabs.part_hv[1],
                                     tabs.part_hv[0]))
            cbf_p = cpart["cbf"]
            syn_p = (tabs.skip0 + mode_bp
                     + torch.where(cbf_p, tabs.root1, tabs.root0))
            bits_p = (syn_p + torch.where(cbf_p, cpart["bits"],
                                          torch.zeros_like(cpart["bits"]))
                      + tabs.split[0])
            return (cpart["d"] + lam * bits_p, ptype, mv_cells, ref_cells,
                    cpart)

        cost_p, ptype16, mvp8, refp8, cpart = rect_trial(
            16, nh16, nw16, c8["mv"], c8["ref"], c16["mv"])
        use_part = cost_p < best16
        best16 = torch.minimum(best16, cost_p)
        use8 = use8 & ~use_part

        # the intra-16 candidate reads the row above the stripe: the
        # stripe above's last source row (none at the picture's top)
        top1 = rows.above(1)
        avtr = self.avtr[r16 : r16 + nh16].reshape(-1)
        avbl = self.avbl[r16 : r16 + nh16].reshape(-1)
        oy_b, ouv_b = yield Halo([HaloItem(oy, 1, 0, edge="cut", dtype=u8),
                                  HaloItem(ouv, 1, 0, edge="cut", dtype=u8)])
        bm16, ipy, ipuv = grid_intra16(oy_b, ouv_b, avtr, avbl, nh16, nw16,
                                       cur=oy, y0=top1,
                                       out=self.intra_out(0, rows, nh16))
        ci16 = self.intra16_code(qp, tabs, lam, oy, ouv, ipy, ipuv)
        icost16 = self.intra16_cost(tabs, lam, ci16)
        icand = icost16 < best16
        best16 = torch.minimum(best16, icost16)
        use32 = use64 = use_part32 = None
        if has32:
            b16 = sum22(best16[: nh32 * 2, : nw32 * 2]) + lam * tabs.split[1]
            cand32 = c32["cost"]
            cost_p32, ptype32, mvp8_32, refp8_32, cpart32 = rect_trial(
                32, nh32, nw32, c16["mv"], c16["ref"], c32["mv"])
            rect32_beats_sq = cost_p32 < cand32
            cand32 = torch.minimum(cand32, cost_p32)
            use32any = cand32 < b16
            use_part32 = use32any & rect32_beats_sq
            use32 = use32any & ~rect32_beats_sq
            best32 = torch.minimum(cand32, b16)
            if has64:
                # the reference reads the child costs in raster rows of
                # four (not per 64-CU) while it gathers the child MVs per
                # 64-CU; kept, as it only steers the 64 candidate
                flat = c32["cost"][: nh64 * 2, : nw64 * 2].reshape(
                    nh64 * nw64, 4)
                bi = torch.argmin(flat, dim=1)
                sub_mv = c32["mv"][: nh64 * 2, : nw64 * 2].reshape(
                    nh64, 2, nw64, 2, 2).permute(0, 2, 1, 3, 4).reshape(
                    nh64 * nw64, 4, 2)
                sub_ref = c32["ref"][: nh64 * 2, : nw64 * 2].reshape(
                    nh64, 2, nw64, 2).permute(0, 2, 1, 3).reshape(
                    nh64 * nw64, 4)
                mv64 = sub_mv.gather(1, bi[:, None, None].expand(
                    -1, 1, 2))[:, 0].reshape(nh64, nw64, 2)
                ref64 = sub_ref.gather(1, bi[:, None])[:, 0].reshape(
                    nh64, nw64)
                sw64 = (yield from self._sweep(
                    tabs, qp, lam_me_f, oy, planes_y,
                    [(64, nh64, nw64, mv64, ref64)], rows))[0]
                c64 = yield from run_class(64, nh64, nw64, sw64)
                b32 = sum22(best32[: nh64 * 2, : nw64 * 2]) \
                    + lam * tabs.split[1]
                use64 = c64["cost"] < b32

        # --- composition -------------------------------------------------
        def cells(x, S):
            return up(x, S // 8)

        def up_mv(mvg, S):
            return up(mvg.permute(2, 0, 1), S // 8).permute(1, 2, 0)

        i8 = torch.int8
        u8c = cells(use8, 16)
        log2_map = torch.where(u8c, 3, 4).to(i8)
        tsp = torch.zeros((h8, w8), dtype=i8, device=dev)
        if use_ts:
            tsp[: nh16 * 2, : nw16 * 2] = torch.where(
                u8c, torch.zeros_like(c16["td8"]), c16["td8"])
        mv_map = torch.where(u8c[..., None], c8["mv"], up_mv(c16["mv"], 16))
        ref_map = torch.where(u8c, c8["ref"], cells(c16["ref"], 16))
        m8pix = up(u8c, 8)
        m8uv = torch.cat([up(u8c, 4)] * 2, dim=1)
        lvl_y = torch.where(m8pix, c8["lvl"], c16["lvl"])
        rec_y = torch.where(m8pix, c8["rec"], c16["rec"])
        lvl_uv = torch.where(m8uv, c8["lvl_c"], c16["lvl_c"])
        rec_uv = torch.where(m8uv, c8["rec_c"], c16["rec_c"])

        def paste(dst, src, m_pix):
            hs, ws = m_pix.shape
            dst[:hs, :ws] = torch.where(m_pix, src, dst[:hs, :ws])

        def paste_uv(dst, src, m_pix):
            hs, ws = m_pix.shape
            for off_d, off_s in ((0, 0), (Wc, src.shape[1] // 2)):
                dst[:hs, off_d : off_d + ws] = torch.where(
                    m_pix, src[:, off_s : off_s + ws],
                    dst[:hs, off_d : off_d + ws])

        def set_cells(dst, src, m):
            hs, ws = m.shape
            dst[:hs, :ws] = torch.where(m[..., None] if dst.dim() == 3
                                        else m, src, dst[:hs, :ws])

        mp2 = up(use_part, 2)
        mv_map = torch.where(mp2[..., None], mvp8, mv_map)
        ref_map = torch.where(mp2, refp8, ref_map)
        log2_map = torch.where(mp2, torch.full_like(log2_map, 4), log2_map)
        if use_ts:
            tsp[: nh16 * 2, : nw16 * 2] = tsp[: nh16 * 2, : nw16 * 2] & ~mp2
        paste(lvl_y, cpart["lvl"], up(use_part, 16))
        paste(rec_y, cpart["rec"], up(use_part, 16))
        paste_uv(lvl_uv, cpart["lvl_c"], up(use_part, 8))
        paste_uv(rec_uv, cpart["rec_c"], up(use_part, 8))
        part16 = torch.where(use_part, ptype16, 0)

        part32 = None
        if has32:
            paste(lvl_y, c32["lvl"], up(use32, 32))
            paste(rec_y, c32["rec"], up(use32, 32))
            paste_uv(lvl_uv, c32["lvl_c"], up(use32, 16))
            paste_uv(rec_uv, c32["rec_c"], up(use32, 16))
            m32cell = up(use32, 4)
            set_cells(log2_map, torch.full_like(m32cell, 5, dtype=i8),
                      m32cell)
            if use_ts:
                set_cells(tsp, c32["td8"], m32cell)
            set_cells(mv_map, up_mv(c32["mv"], 32), m32cell)
            set_cells(ref_map, cells(c32["ref"], 32), m32cell)
            paste(lvl_y, cpart32["lvl"], up(use_part32, 32))
            paste(rec_y, cpart32["rec"], up(use_part32, 32))
            paste_uv(lvl_uv, cpart32["lvl_c"], up(use_part32, 16))
            paste_uv(rec_uv, cpart32["rec_c"], up(use_part32, 16))
            m32cp = up(use_part32, 4)
            set_cells(log2_map, torch.full_like(m32cp, 5, dtype=i8), m32cp)
            if use_ts:
                set_cells(tsp, torch.zeros_like(m32cp, dtype=i8), m32cp)
            set_cells(mv_map, mvp8_32, m32cp)
            set_cells(ref_map, refp8_32, m32cp)
            part32 = torch.where(use_part32, ptype32, 0)
            cover32 = use32 | use_part32
            set_cells(part16, torch.zeros_like(part16[: nh32 * 2, : nw32 * 2]),
                      up(cover32, 2))
            if has64:
                paste(lvl_y, c64["lvl"], up(use64, 64))
                paste(rec_y, c64["rec"], up(use64, 64))
                paste_uv(lvl_uv, c64["lvl_c"], up(use64, 32))
                paste_uv(rec_uv, c64["rec_c"], up(use64, 32))
                m64cell = up(use64, 8)
                set_cells(log2_map, torch.full_like(m64cell, 6, dtype=i8),
                          m64cell)
                if use_ts:
                    t64 = (c64["td8"] if "td8" in c64 else
                           torch.zeros(m64cell.shape, dtype=i8, device=dev))
                    set_cells(tsp, t64, m64cell)
                set_cells(mv_map, up_mv(c64["mv"], 64), m64cell)
                set_cells(ref_map, cells(c64["ref"], 64), m64cell)
                set_cells(part16, torch.zeros_like(
                    part16[: nh64 * 4, : nw64 * 4]), up(use64, 4))
                set_cells(part32, torch.zeros_like(
                    part32[: nh64 * 2, : nw64 * 2]), up(use64, 2))

        # --- intra-16: exact prediction from the composed recon -----------
        intra_cells = torch.zeros((h8, w8), dtype=torch.bool, device=dev)
        # the 4-phase keep mask reads its neighbours' candidates across
        # stripes: it runs on every stripe's (one bool a 16-block)
        (icand_all,) = yield Gather([icand])
        kept = self.intra_suppress(icand_all)[r16 : r16 + nh16]
        if has32:
            cov = torch.zeros((nh16, nw16), dtype=torch.bool, device=dev)
            cov[: nh32 * 2, : nw32 * 2] = up(use32 | use_part32, 2)
            if has64:
                cov[: nh64 * 4, : nw64 * 4] = (cov[: nh64 * 4, : nw64 * 4]
                                               | up(use64, 4))
            kept = kept & ~cov
        rec_yb, rec_uvb = yield Halo([
            HaloItem(rec_y, 1, 0, edge="cut", dtype=u8),
            HaloItem(rec_uv, 1, 0, edge="cut", dtype=u8)])
        _, ipred_y, ipred_uv = grid_intra16(rec_yb, rec_uvb, avtr, avbl,
                                            nh16, nw16, modes=bm16, y0=top1,
                                            out=self.intra_out(1, rows, nh16))
        cix = self.intra16_code(qp, tabs, lam, oy, ouv, ipred_y, ipred_uv)
        paste(lvl_y, cix["lvl"], up(kept, 16))
        paste(rec_y, cix["rec"], up(kept, 16))
        paste_uv(lvl_uv, cix["lvl_c"], up(kept, 8))
        paste_uv(rec_uv, cix["rec_c"], up(kept, 8))
        kp_cell = up(kept, 2)
        set_cells(log2_map, torch.full_like(kp_cell, 4, dtype=i8), kp_cell)
        if use_ts:
            tsp[: nh16 * 2, : nw16 * 2] = torch.where(
                kp_cell, 0, tsp[: nh16 * 2, : nw16 * 2])
        set_cells(mv_map, torch.zeros_like(mv_map[: nh16 * 2, : nw16 * 2]),
                  kp_cell)
        intra_cells[: nh16 * 2, : nw16 * 2] = kp_cell
        imode_map = torch.where(kept, self.imodes[bm16.long()].reshape(
            nh16, nw16), 0)
        part16 = torch.where(kept, 0, part16)

        cbf_cells = (tile_sum((lvl_y != 0).int(), 8)
                     + tile_sum((lvl_uv[:, :Wc] != 0).int(), 4)
                     + tile_sum((lvl_uv[:, Wc:] != 0).int(), 4)) > 0
        pb = torch.zeros((h8, w8), dtype=torch.int32, device=dev)
        pb[: nh16 * 2, : nw16 * 2] = up(part16, 2)
        yy = torch.arange(h8, device=dev)[:, None]
        xx = torch.arange(w8, device=dev)[None]
        part_cells = torch.where((yy % 2 == 0) & (xx % 2 == 0), pb, 0)
        if part32 is not None:
            pb32 = torch.zeros((h8, w8), dtype=torch.int32, device=dev)
            pb32[: nh32 * 4, : nw32 * 4] = up(part32, 4)
            pc32 = torch.where((yy % 4 == 0) & (xx % 4 == 0), pb32, 0)
            part_cells = torch.where(pc32 > 0, pc32, part_cells)

        # --- in-loop filters ---------------------------------------------
        if self.deblock:  # the luma TB cbf only, for the BS (§8.7.2.4)
            # 32 rows of the neighbours' recon and 4 of their cell maps:
            # both sides of the boundary edges, the vertical edges of those
            # rows first, the TU groups of 32 rows aligned
            top = rows.above(32)
            cells_ = (log2_map, mv_map, ref_map,
                      tile_sum((lvl_y != 0).int(), 8) > 0, intra_cells, tsp)
            bufs = yield Halo(
                [HaloItem(rec_y, 32, 32, edge="cut", dtype=u8),
                 HaloItem(rec_uv, 16, 16, edge="cut", dtype=u8)]
                + [HaloItem(m, 4, 4, edge="cut") for m in cells_])
            rec_y, rec_uv = grid_deblock(*bufs, qp)
            rec_y = rec_y[top : top + hs]
            rec_uv = rec_uv[top // 2 : top // 2 + hs // 2]
        sao_params = None
        if self.sao:
            # the stripe's CTUs' statistics, the picture's decision once
            ctu = 1 << self.log2_ctu
            top = rows.above(1)
            rec_yb, rec_uvb = yield Halo([
                HaloItem(rec_y, 1, 1, edge="cut", dtype=u8),
                HaloItem(rec_uv, 1, 1, edge="cut", dtype=u8)])
            st = grid_sao_stats(oy, ouv, rec_yb, rec_uvb, ctu, top)
            par, sao_params = yield Once(
                _SaoDecide(lam, qp, -(-self.H // ctu), -(-W // ctu)),
                list(st))
            rec_y, rec_uv = grid_sao_apply(rec_yb, rec_uvb, par, ctu, top, hs)

        # --- packing -----------------------------------------------------
        ldt = torch.int8 if self.lvl8 else torch.int16

        def raw(x):
            return x.contiguous().view(u8).reshape(-1)

        parts = [raw(lvl_y.to(ldt)), raw(lvl_uv.to(ldt))]
        if self.fetch:
            parts += [rec_y.to(u8).reshape(-1), rec_uv.to(u8).reshape(-1)]
        parts = [(p, True) for p in parts]
        if not self.fetch:  # the recon stays here: its checksums and SSEs,
            # the stripes' exact sums added, then one finish
            stats = yield Once(_stats_once, list(grid_stats_partial(
                oy, ouv, rec_y.contiguous(), rec_uv.contiguous(), rows.y0)))
            parts += [(raw(t), False) for t in stats]
        parts += [(p, True) for p in (
            log2_map.to(u8).reshape(-1), raw(mv_map.to(torch.int16)),
            ref_map.to(u8).reshape(-1), cbf_cells.to(u8).reshape(-1),
            intra_cells.to(u8).reshape(-1), imode_map.to(u8).reshape(-1),
            part_cells.to(u8).reshape(-1), tsp.to(u8).reshape(-1))]
        if sao_params is not None:
            parts.append((raw(sao_params), False))
        parts += [(raw(sad9_16.int()), True), (raw(mv16.to(torch.int16)), True)]
        # the recon's halo rows join it in the carried stacks: the older
        # references keep theirs
        rec_yh, rec_uvh = yield Halo([
            HaloItem(rec_y, KY, KY, edge="cut", dtype=u8),
            HaloItem(rec_uv, KC, KC, edge="cut", dtype=u8)])
        new_ry = torch.cat([rec_yh[None], ry_stack[:-1]])
        new_ruv = torch.cat([rec_uvh[None], ruv_stack[:-1]])
        seed16 = torch.div(mv_map[::2, ::2].reshape(n16, 2), 4,
                           rounding_mode="floor").int()
        colmv_n = mv_map[::2, ::2].int()
        coltd_n = torch.where(intra_cells[::2, ::2], 0,
                              ref_map[::2, ::2].int() + 1)
        return (new_ry, new_ruv, seed16, colmv_n, coltd_n), parts

    def carry0(self, ry_stack, ruv_stack):
        """Chunk-initial carry: zero MV seed, all-invalid collocated
        motion (the reference's `_carry0`)."""
        hc16, wc16 = (self.h8 + 1) // 2, (self.w8 + 1) // 2
        z = dict(dtype=torch.int32, device=self.dev)
        return (ry_stack, ruv_stack, torch.zeros((self.n16, 2), **z),
                torch.zeros((hc16, wc16, 2), **z),
                torch.zeros((hc16, wc16), **z))


def _sum_once(parts: list) -> list:
    """`Once`: the stripes' integer partial sums, added."""
    total = parts[0][0]
    for p in parts[1:]:
        total = total + p[0]
    return [(total,)] * len(parts)


def _stats_once(parts: list) -> list:
    """`Once`: the stripes' exact grid_stats sums, added, then wrapped and
    rounded once."""
    ck, se = parts[0]
    for c, e in parts[1:]:
        ck, se = ck + c, se + e
    return [stats_finish(ck, se)] * len(parts)


class _SaoDecide:
    """`Once`: the picture's SAO decision (kernel `grid_sao_decide`) over
    the stripes' per-CTU statistics, gathered in CTU raster order -> per
    stripe (its CTUs' rows of par, the picture's parameter rows)."""

    def __init__(self, lam, qp, ny, nx):
        self.lam, self.qp, self.ny, self.nx = lam, qp, ny, nx

    def __call__(self, parts: list) -> list:
        if len(parts) == 1:
            return [grid_sao_decide(*parts[0], self.lam, self.qp, self.ny,
                                    self.nx)]
        cnt = torch.cat([c for c, _ in parts], dim=1).contiguous()
        sm = torch.cat([s for _, s in parts], dim=1).contiguous()
        par, params = grid_sao_decide(cnt, sm, self.lam, self.qp, self.ny,
                                      self.nx)
        n = self.ny * self.nx
        out, a = [], 0
        for c, _ in parts:
            b = a + c.shape[1]
            out.append((torch.cat([par[:, a:b], par[:, n + a : n + b],
                                   par[:, 2 * n + 4 * a : 2 * n + 4 * b]],
                                  dim=1).contiguous(), params))
            a = b
        return out


def pack_stripes(outs: list, dev) -> torch.Tensor:
    """The stripes' `frame_steps` results -> the picture's packed row on
    `dev`: each per-rows part the stripes' pieces in order, each picture
    part the first stripe's."""
    pieces = []
    for k, (part, per_rows) in enumerate(outs[0][1]):
        if per_rows:
            pieces += [o[1][k][0].to(dev) for o in outs]
        else:
            pieces.append(part.to(dev))
    return torch.cat(pieces)


def build_ldp_grid_scan(cfg: EncoderConfig, nn_by_qp: dict, n_gops: int,
                        device):
    """-> (run, meta, qps). run(frames_u8 (n_gops, G, W*H*3/2) uint8,
    navail (n_gops, G) ints, ry_stack (R, H, W) int32, ruv_stack
    (R, H/2, W) int32 packed [U | V], live: per-GOP-position tables of
    `grid_live_tables`, wp: with weighted prediction the per-picture
    (w (n_gops, G, R, 3), o (n_gops, G, R, 3), d (n_gops, G)) int32
    arrays, as the reference's `run` takes them, nvalid: the pictures
    to code, default all) -> (packed rows (nvalid, nbytes) uint8,
    ry_stack, ruv_stack). The reference's compiled scan also codes the
    padding of a short last chunk; a picture's row depends only on the
    pictures before it, so stopping at nvalid leaves every row coded
    equal."""
    step = GridStep(cfg, nn_by_qp, device)
    G = step.G

    def run(frames_u8, navail, ry_stack, ruv_stack, live, wp=None,
            nvalid=None):
        if step.use_wp != (wp is not None):
            raise ValueError("weighted prediction needs its tables, and "
                             "only it")
        tabs = [_Tabs(lv, step.dev) for lv in live]
        if wp is not None:
            wpw, wpo = (torch.as_tensor(np.asarray(a, np.int32),
                                        device=step.dev) for a in wp[:2])
            wpd = np.asarray(wp[2], np.int64)
        carry = step.carry0(ry_stack, ruv_stack)
        rows = []
        nvalid = n_gops * G if nvalid is None else nvalid
        for g in range(n_gops):
            for p in range(G):
                if len(rows) == nvalid:
                    break
                wp_f = (None if wp is None else
                        (wpw[g, p], wpo[g, p], int(wpd[g, p])))
                carry, row = step.frame_step(carry, frames_u8[g, p],
                                             int(navail[g][p]), p, tabs[p],
                                             wp_f)
                rows.append(row)
        return torch.stack(rows), carry[0], carry[1]

    return run, dict(W=step.W, H=step.H, step=step), step.qps


# --- host half: the packed row -> FrameSyntax ------------------------------

def _parse_frame_buf(cfg, buf: np.ndarray) -> dict:
    """Unpack one fetched frame row into named arrays."""
    sps = cfg.sps
    W, H = sps.coded_width, sps.coded_height
    Hc = H // 2
    h8, w8 = H // 8, W // 8
    nh16, nw16 = H // 16, W // 16
    n16 = nh16 * nw16
    lvl8 = _lvl8(cfg)
    ldt = np.int8 if lvl8 else np.int16
    lb = 1 if lvl8 else 2
    off = 0

    def take(nbytes, dtype, shape):
        nonlocal off
        out = np.frombuffer(buf[off : off + nbytes].tobytes(), dtype=dtype)
        off += nbytes
        return out.reshape(shape)

    d = dict(
        lvl_y=take(W * H * lb, ldt, (H, W)).astype(np.int32),
        lvl_uv=take(W * Hc * lb, ldt, (Hc, W)).astype(np.int32),
    )
    if fetches_recon(cfg):
        d.update(rec_y=take(W * H, np.uint8, (H, W)),
                 rec_uv=take(W * Hc, np.uint8, (Hc, W)))
    else:
        d.update(cks=take(12, np.int32, (3,)),
                 sse=take(12, np.float32, (3,)))
    d.update(
        log2_map=take(h8 * w8, np.uint8, (h8, w8)).astype(np.int32),
        mv_map=take(h8 * w8 * 4, np.int16, (h8, w8, 2)).astype(np.int32),
        ref_map=take(h8 * w8, np.uint8, (h8, w8)).astype(np.int32),
        cbf_map=take(h8 * w8, np.uint8, (h8, w8)).astype(np.int32),
        intra_map=take(h8 * w8, np.uint8, (h8, w8)).astype(np.int32),
        imode_map=take(n16, np.uint8, (nh16, nw16)).astype(np.int32),
        part_map=take(h8 * w8, np.uint8, (h8, w8)),
        tsplit_map=take(h8 * w8, np.uint8, (h8, w8)).astype(np.int32),
    )
    if sps.sao_enabled:
        ny, nx = _ctu_grid(cfg)
        n = ny * nx
        for k, per in (("ty", 1), ("ay", 1), ("oy", 4), ("tc", 1),
                       ("acb", 1), ("ocb", 4), ("acr", 1), ("ocr", 4)):
            d["sao_" + k] = take(n * per, np.int8,
                                 (ny, nx, 4) if per == 4 else (ny, nx)
                                 ).astype(np.int32)
    d.update(
        sad9_16=take(n16 * 36, np.int32, (n16, 9)),
        mv16=take(n16 * 4, np.int16, (n16, 2)).astype(np.int32),
    )
    return d


def _ctu_grid(cfg) -> tuple[int, int]:
    ctu = 1 << cfg.sps.log2_ctu
    return (-(-cfg.sps.coded_height // ctu), -(-cfg.sps.coded_width // ctu))


def frame_bytes(cfg) -> int:
    """Bytes of one packed row."""
    sps = cfg.sps
    W, H = sps.coded_width, sps.coded_height
    lb = 1 if _lvl8(cfg) else 2
    n8, n16 = (H // 8) * (W // 8), (H // 16) * (W // 16)
    ny, nx = _ctu_grid(cfg)
    # SAO: 8 int8 rows, five of one byte a CTU and three of four
    sao = 17 * ny * nx if sps.sao_enabled else 0
    # the recon planes, or three int32 checksums and three float32 SSEs
    rec = W * H * 3 // 2 if fetches_recon(cfg) else 24
    return (W * H * 3 // 2) * lb + rec + n8 * 10 + n16 * (1 + 36 + 4) + sao


def assemble_grid_frame(cfg, buf: np.ndarray, num_ref: int = 1, col=None):
    """Fetched frame row -> (FrameSyntax, recon, stats) through the native
    decision walk: with the recon fetch stats is None; without it recon is
    None and stats holds the device's checksum hashes (hash_type 2) and
    SSEs.
    col: the TMVP collocated motion (col_mv16, col_td16) of the previous
    coded picture, required when the SPS grants TMVP. Intra cells ride the
    walk as reference sentinel 255 and are written as 16x16 intra CUs with
    DM chroma."""
    from ..entropy.native import decision_walk_map_native
    from ..entropy.syntax import FrameSyntax

    sps = cfg.sps
    W, H = sps.coded_width, sps.coded_height
    Wc = W // 2
    d = _parse_frame_buf(cfg, buf)
    ref_in = d["ref_map"]
    has_intra = bool(d["intra_map"].any())
    if has_intra:
        ref_in = np.where(d["intra_map"] > 0, 255, ref_in)
    part_map = d["part_map"]
    has_parts = bool(part_map.any())
    if sps.temporal_mvp_enabled and col is None:
        raise RuntimeError("temporal_mvp_enabled needs the collocated "
                           "motion maps at assembly")
    maps = decision_walk_map_native(
        d["log2_map"], d["mv_map"], ref_in, d["cbf_map"],
        W, H, sps.log2_ctu, cfg.max_num_merge_cand, num_ref,
        part_map=part_map if has_parts else None,
        col=col if sps.temporal_mvp_enabled else None)
    fs = FrameSyntax(
        W, H, cu_log2=maps["cu_log2"], mv=maps["mv"], skip=maps["skip"],
        merge_flag=maps["merge_flag"], merge_idx=maps["merge_idx"],
        mvp_flag=maps["mvp_flag"], mvd=maps["mvd"], ref_idx=maps["ref"],
        coeff_y=np.ascontiguousarray(d["lvl_y"]),
        coeff_cb=np.ascontiguousarray(d["lvl_uv"][:, :Wc]),
        coeff_cr=np.ascontiguousarray(d["lvl_uv"][:, Wc:]),
    )
    if has_parts:
        fs.part_mode = part_map.astype(np.int32)
    tsp = d["tsplit_map"]
    if bool(tsp.any()):
        # leaf TU log2 per 4-cell: min(CU, 32) minus the RQT depth chosen
        # on the device
        tu8 = np.minimum(d["log2_map"], 5) - tsp
        fs.tu_log2 = np.repeat(np.repeat(tu8, 2, 0), 2, 1).astype(
            fs.tu_log2.dtype)
    if has_intra:
        im = d["intra_map"] > 0
        fs.inter_dir = np.where(im, 0, fs.inter_dir)
        fs.skip = np.where(im, 0, fs.skip)
        fs.merge_flag = np.where(im, 0, fs.merge_flag)
        fs.ref_idx = np.where(im, 0, fs.ref_idx)
        m8 = np.repeat(np.repeat(d["imode_map"], 2, 0), 2, 1)[
            : im.shape[0], : im.shape[1]]
        fs.luma_mode = np.where(im, m8, fs.luma_mode)
        fs.chroma_mode = np.where(im, 4, fs.chroma_mode)  # DM
        m4 = np.repeat(np.repeat(m8, 2, 0), 2, 1)
        im4 = np.repeat(np.repeat(im, 2, 0), 2, 1)
        fs.luma_mode4 = np.where(im4, m4, fs.luma_mode4).astype(
            fs.luma_mode4.dtype)
        fs.tu_log2 = np.where(im4, 4, fs.tu_log2).astype(fs.tu_log2.dtype)
        fs.full_features = True
    if sps.sao_enabled:
        from .sao_enc import SaoPicParams

        ny, nx = d["sao_ty"].shape
        fs.sao = _sao_thrift(SaoPicParams(
            ny, nx, type_y=d["sao_ty"], aux_y=d["sao_ay"], off_y=d["sao_oy"],
            type_c=d["sao_tc"], aux_cb=d["sao_acb"], off_cb=d["sao_ocb"],
            aux_cr=d["sao_acr"], off_cr=d["sao_ocr"]))
    if "cks" in d:
        hashes = [int(np.uint32(c)).to_bytes(4, "big") for c in d["cks"]]
        return fs, None, dict(hashes=hashes, hash_type=2, sse=d["sse"])
    rec = (d["rec_y"].astype(np.int32),
           np.ascontiguousarray(d["rec_uv"][:, :Wc]).astype(np.int32),
           np.ascontiguousarray(d["rec_uv"][:, Wc:]).astype(np.int32))
    return fs, rec, None


def _sao_thrift(pp):
    """Bit-only cleanup of the device's SAO decisions (the applied offsets
    are unchanged): merge-left, else merge-up, where the neighbour CTU's
    luma and chroma parameters are identical, and None (both slice flags
    0, no CTU syntax) where every CTU of both components is off."""
    from .sao_enc import SAO_OFF

    for y in range(pp.ny):
        for x in range(pp.nx):
            for k, (sy, sx) in enumerate(((y, x - 1), (y - 1, x))):
                if sx < 0 or sy < 0:
                    continue
                if all(np.array_equal(a[y, x], a[sy, sx])
                       for a in (pp.type_y, pp.aux_y, pp.off_y, pp.type_c,
                                 pp.aux_cb, pp.off_cb, pp.aux_cr,
                                 pp.off_cr)):
                    pp.merge[y, x] = k + 1
                    break
    pp.luma_on = bool((pp.type_y != SAO_OFF).any())
    pp.chroma_on = bool((pp.type_c != SAO_OFF).any())
    if not pp.luma_on and not pp.chroma_on:
        return None
    return pp
