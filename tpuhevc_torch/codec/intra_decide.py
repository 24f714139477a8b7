"""Open-loop quadtree intra decision on the device.

Twin of `tpuhevc/codec/intra_decide_jax.py` (`_build`, lines 42-402, and
`decide_intra_qt_jax`): per size class (4 for the NxN trial and the 8-CU
TU split, then 8, 16, 32) the 35-mode prediction bank (`ops.intra`), the
SATD prescreen and top-nc (`ops.cost`), the full RD of the survivors
(`ops.intra_txq` + `entropy.bitest.tu_bits`) with the cbf compare, the
MPM-aware pick by a two-iteration relaxation, the one-level TU-split
trial, the chroma mode decision and the NxN trial; then the bottom-up
8/16/32 merge and the six maps the coding walk takes.

The mpm/mode-bit logic, the argmins and the map assembly are torch glue
on the same device as the kernels. Every float32 expression is the
reference's, in its order (Python-float constants are formed in double
and rounded where they meet a tensor, as JAX's weak types are);
`torch.argmin` keeps the first minimum, as `jnp.argmin` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..entropy.bitest import FracBits, est_tables, tu_bits
from ..ops.cost import satd35_topk
from ..ops.intra import blocks, intra_bank, refs
from ..ops.intra_txq import intra_txq
from ..utils.tables import chroma_qp
from .intra_qt import I_ROW, _mode_bits_tab
from .params import i_frame_lambda

_CACHE: dict = {}


def _take(x: torch.Tensor, pick: torch.Tensor) -> torch.Tensor:
    """x (N, K) at column pick (N,) -> (N,)."""
    return x.gather(1, pick[:, None])[:, 0]


class IntraDecision:
    """The decision for one (h, w, qp, bit depth, rdoq, strong smoothing,
    lambda in 8.8, TU split, NxN) on one device: the constants `_build`
    bakes into its graph, and `run`, its `fn`."""

    def __init__(self, h, w, qp, bd, rdoq, strong, lam_q8, tusplit_on,
                 nxn_on, device):
        self.h, self.w, self.qp, self.bd = h, w, qp, bd
        self.rdoq, self.strong = rdoq, strong
        self.tusplit_on, self.nxn_on = tusplit_on, nxn_on
        self.dev = device
        self.lam = lam_q8 / 256.0
        fb = self.fb = FracBits(I_ROW, qp)
        self.mpm0_b, self.mpm12_b, self.esc_b = _mode_bits_tab(fb)
        self.split_b = [fb.b("split_cu_flag", 1, v) for v in (0, 1)]
        self.part_b = fb.b("part_mode", 0, 1)
        self.part_nxn_b = fb.b("part_mode", 0, 0)
        self.cbf1_b = fb.b("qt_cbf", 1, 1)
        self.cbf0_b = fb.b("qt_cbf", 1, 0)
        self.scbf1_b = fb.b("qt_cbf", 0, 1)
        self.scbf0_b = fb.b("qt_cbf", 0, 0)
        self.ccbf_b = fb.b("qt_cbf", 5, 0)
        dm_b = fb.b("intra_chroma_pred_mode", 0, 0)
        ex_b = fb.b("intra_chroma_pred_mode", 0, 1) + 2.0
        self.qpc = chroma_qp(qp)
        self.wch = 2.0 ** ((qp - self.qpc) / 3.0)
        self.mbv = torch.tensor([ex_b, ex_b, ex_b, ex_b, dm_b],
                                dtype=torch.float32, device=device)

    # -- helpers ----------------------------------------------------------

    def _rd_lam(self, q: int) -> float:
        """The RDOQ lambda of a TU at QP q (`txq`'s lam / wch for chroma)."""
        return self.lam / (self.wch if q == self.qpc else 1.0)

    def _trial(self, org, preds, rows, modes, q, log2, luma, is_dst):
        """intra_txq + tu_bits -> dist, d0, bits (M, K) float32."""
        est = est_tables(self.fb, log2, luma, self.dev)
        dist, d0, lvl = intra_txq(org, preds, rows, modes, q, is_dst,
                                  self.rdoq, self._rd_lam(q), est, self.bd)
        S = 1 << log2
        bits = tu_bits(est, lvl.reshape(-1, S, S)).reshape(modes.shape)
        return dist, d0, bits

    def _arange(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=self.dev)

    @staticmethod
    def mpm3(a, b):
        """Vectorised candModeList (tables.intra_mpm_list)."""
        eq = a == b
        lt2 = a < 2
        m0 = torch.where(eq & lt2, 0, a)
        m1 = torch.where(eq, torch.where(lt2, 1, 2 + ((a + 29) % 32)), b)
        third = torch.where((a != 0) & (b != 0), 0,
                            torch.where((a != 1) & (b != 1), 1, 26))
        m2 = torch.where(eq, torch.where(lt2, 26, 2 + ((a - 1) % 32)), third)
        return m0, m1, m2

    def mode_bits(self, m, m0, m1, m2):
        return torch.where(m == m0, self.mpm0_b,
                           torch.where((m == m1) | (m == m2), self.mpm12_b,
                                       self.esc_b))

    def _mode_bits_all(self, topk, m0, m1, m2):
        return torch.stack([self.mode_bits(topk[:, k], m0, m1, m2)
                            for k in range(topk.shape[1])], 1)

    @staticmethod
    def _shift_in(m2d):
        """Left and above neighbour modes of a mode grid (1 = DC outside)."""
        nh, nw = m2d.shape
        lm = torch.cat([torch.ones((nh, 1), dtype=m2d.dtype,
                                   device=m2d.device), m2d[:, :-1]], 1)
        am = torch.cat([torch.ones((1, nw), dtype=m2d.dtype,
                                   device=m2d.device), m2d[:-1]], 0)
        return lm.reshape(-1), am.reshape(-1)

    # -- the stages of `_build` --------------------------------------------

    def luma_rd(self, oy, ry, S, nh, nw, nc):
        """SATD prescreen + full RD over the top nc candidates ->
        (topk, rd_d, rd_b, preds, org)."""
        log2 = S.bit_length() - 1
        tops, lefts = refs(ry, S, nh, nw)
        preds = intra_bank(tops, lefts, S, True, self.bd, self.strong)
        org = blocks(oy, S, nh, nw)
        _, topk = satd35_topk(org, preds, nc)
        dist, d0, rbits = self._trial(org, preds, self._arange(nh * nw), topk,
                                      self.qp, log2, True, S == 4)
        lam = self.lam
        use = dist + lam * (rbits + self.cbf1_b) < d0 + lam * self.cbf0_b
        rd_d = torch.where(use, dist, d0)
        rd_b = torch.where(use, rbits + self.cbf1_b,
                           torch.full_like(rbits, self.cbf0_b))
        return topk.long(), rd_d, rd_b, preds, org

    def luma_class(self, oy, ry, S, nh, nw):
        nc = 8 if S <= 8 else 3  # g_aucIntraModeNumFast_UseMPM
        topk, rd_d, rd_b, preds, org = self.luma_rd(oy, ry, S, nh, nw, nc)
        m2d = topk[:, 0].reshape(nh, nw)
        for _ in range(2):
            m0, m1, m2 = self.mpm3(*self._shift_in(m2d))
            mb = self._mode_bits_all(topk, m0, m1, m2)
            cst = rd_d + self.lam * (rd_b + mb)
            pick = torch.argmin(cst, 1)
            m2d = _take(topk, pick).reshape(nh, nw)
        mode_sel = m2d.reshape(-1)
        dL = _take(rd_d, pick)
        bL = _take(rd_b, pick) + _take(mb, pick)
        mbL = _take(mb, pick)
        return mode_sel, dL, bL, mbL, preds, org

    def tsplit_cost(self, S, mode_sel, nh, nw, preds_h, org_h):
        """Luma cost of a one-level TU split under the parent mode (the
        four children in one launch)."""
        C = S // 2
        nw2 = self.w // C
        by = torch.arange(nh, device=self.dev)[:, None]
        bx = torch.arange(nw, device=self.dev)[None, :]
        rows = torch.stack([((by * 2 + dy) * nw2 + (bx * 2 + dx)).reshape(-1)
                            for dy in (0, 1) for dx in (0, 1)])
        rows = rows.reshape(-1).int().contiguous()
        modes = mode_sel.repeat(4)[:, None].int().contiguous()
        dist, d0, rbits = self._trial(org_h, preds_h, rows, modes, self.qp,
                                      C.bit_length() - 1, True, C == 4)
        lam = self.lam
        use = dist + lam * (rbits + self.scbf1_b) < d0 + lam * self.scbf0_b
        dd = torch.where(use, dist, d0).reshape(4, -1)
        bb = torch.where(use, rbits + self.scbf1_b,
                         torch.full_like(rbits, self.scbf0_b)).reshape(4, -1)
        d_sum = torch.zeros(nh * nw, dtype=torch.float32, device=self.dev)
        b_sum = torch.zeros_like(d_sum)
        for q in range(4):
            d_sum = d_sum + dd[q]
            b_sum = b_sum + bb[q]
        return d_sum, b_sum

    def chroma_class(self, ou, ov, ru, rv, S, nh, nw, mode_sel):
        N = nh * nw
        Sc = max(4, S // 2)
        log2c = Sc.bit_length() - 1
        am = torch.stack([torch.where(mode_sel == base, 34, base)
                          for base in (0, 26, 10, 1)] + [mode_sel], 1)
        am = am.int().contiguous()
        wch, lam = self.wch, self.lam
        cd_by = torch.zeros((N, 5), dtype=torch.float32, device=self.dev)
        cb_by = torch.zeros_like(cd_by)
        for plane, rplane in ((ou, ru), (ov, rv)):
            ctops, clefts = refs(rplane, Sc, nh, nw)
            cpreds = intra_bank(ctops, clefts, Sc, False, self.bd, False)
            corg = blocks(plane, Sc, nh, nw)
            cd, cd0, cb = self._trial(corg, cpreds, self._arange(N), am,
                                      self.qpc, log2c, False, False)
            cuse = wch * cd + lam * cb < wch * cd0
            cd_by = cd_by + torch.where(cuse, cd, cd0)
            cb_by = cb_by + torch.where(cuse, cb, torch.zeros_like(cb))
        ccost = wch * cd_by + lam * (cb_by + self.mbv[None])
        csel = torch.argmin(ccost, 1)
        return csel, _take(ccost, csel)

    def nxn_trial(self, mode_sel, nh, nw, topk4, rdd4, rdb4):
        """4 PUs pick from the 4x4 top-8; the MPM chain runs through the
        CU's own PUs, outside neighbours from the 8-level winner map."""
        lam = self.lam
        lm_out, am_out = self._shift_in(mode_sel.reshape(nh, nw))
        nw4 = self.w // 4
        byg = torch.arange(nh, device=self.dev)[:, None]
        bxg = torch.arange(nw, device=self.dev)[None, :]
        pm = [None] * 4
        pud = torch.zeros(nh * nw, dtype=torch.float32, device=self.dev)
        pub = torch.zeros_like(pud)
        for q, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            idx = ((byg * 2 + dy) * nw4 + (bxg * 2 + dx)).reshape(-1)
            left_m = pm[q - 1] if dx else lm_out
            above_m = pm[q - 2] if dy else am_out
            m0, m1, m2 = self.mpm3(left_m, above_m)
            tk = topk4[idx]
            mb4 = self._mode_bits_all(tk, m0, m1, m2)
            cst = rdd4[idx] + lam * (rdb4[idx] + mb4)
            pick = torch.argmin(cst, 1)
            pm[q] = _take(tk, pick)
            pud = pud + _take(rdd4[idx], pick)
            pub = pub + (_take(rdb4[idx], pick) + _take(mb4, pick))
        return pm, pud, pub

    def run(self, oy, ou, ov, ry, ru, rv):
        """Planes (int32 tensors on the device) -> (cu_log2, lm8, cm8, nxn,
        lm4, tsp8) tensors."""
        h, w, lam = self.h, self.w, self.lam
        h8, w8 = h // 8, w // 8
        cost_tree, mode_by, cmode_by, tsp_by = {}, {}, {}, {}
        preds_of, org_of = {}, {}
        if self.nxn_on or self.tusplit_on:
            topk4, rdd4, rdb4, preds_of[4], org_of[4] = self.luma_rd(
                oy, ry, 4, h // 4, w // 4, 8)
        nxn_modes = use_nxn = None
        for S in (8, 16, 32):
            nh, nw = h // S, w // S
            if nh == 0 or nw == 0:
                cost_tree[S] = None
                continue
            mode_sel, dL, bL, mbL, preds_of[S], org_of[S] = self.luma_class(
                oy, ry, S, nh, nw)
            tsp = torch.zeros((nh, nw), dtype=torch.bool, device=self.dev)
            if self.tusplit_on:
                d2, b2 = self.tsplit_cost(S, mode_sel, nh, nw,
                                          preds_of[S // 2], org_of[S // 2])
                ctx = 5 - S.bit_length() + 1
                sdelta = (self.fb.b("split_transform_flag", ctx, 1)
                          - self.fb.b("split_transform_flag", ctx, 0))
                c_cu = dL + lam * bL
                c_sp = d2 + lam * (b2 + sdelta + mbL)
                tspf = c_sp < c_cu
                tsp = tspf.reshape(nh, nw)
                dL = torch.where(tspf, d2, dL)
                bL = torch.where(tspf, b2 + sdelta + mbL, bL)
            tsp_by[S] = tsp
            csel, cbest = self.chroma_class(ou, ov, ru, rv, S, nh, nw,
                                            mode_sel)
            cost = dL + cbest + lam * (bL + 2 * self.ccbf_b + 1.0)
            if S == 8:
                cost = cost + lam * self.part_b
            if S == 8 and self.nxn_on:
                pm, pud, pub = self.nxn_trial(mode_sel, nh, nw, topk4, rdd4,
                                              rdb4)
                cost_nxn = (pud + cbest
                            + lam * (pub + 2 * self.ccbf_b + 1.0
                                     + self.part_nxn_b))
                use_nxn = (cost_nxn < cost).reshape(nh, nw)
                nxn_modes = [p.reshape(nh, nw) for p in pm]
                cost = torch.minimum(cost, cost_nxn)
            cost_tree[S] = cost.reshape(nh, nw)
            mode_by[S] = mode_sel.reshape(nh, nw)
            cmode_by[S] = csel.reshape(nh, nw)

        cu_log2 = torch.full((h8, w8), 3, dtype=torch.int8, device=self.dev)
        lm8 = mode_by[8].to(torch.int8)
        cm8 = cmode_by[8].to(torch.int8)
        tsp8 = tsp_by[8]

        def up(m, f):
            """Repeat f x f into the top-left of an (h8, w8) map; the rest
            is never selected."""
            out = torch.zeros((h8, w8), dtype=m.dtype, device=self.dev)
            e = m.repeat_interleave(f, 0).repeat_interleave(f, 1)
            out[: e.shape[0], : e.shape[1]] = e
            return out

        def merge(S, keep):
            nonlocal cu_log2, lm8, cm8, tsp8
            k = up(keep, S // 8)
            cu_log2 = torch.where(k, S.bit_length() - 1, cu_log2).to(
                torch.int8)
            lm8 = torch.where(k, up(mode_by[S], S // 8).to(torch.int8), lm8)
            cm8 = torch.where(k, up(cmode_by[S], S // 8).to(torch.int8), cm8)
            tsp8 = torch.where(k, up(tsp_by[S], S // 8), tsp8)

        def sum4(t, nh, nw):
            """Sum of each 2x2 of t[:2nh, :2nw], raster order within."""
            t = t[: nh * 2, : nw * 2]
            return ((t[0::2, 0::2] + t[0::2, 1::2]) + t[1::2, 0::2]) \
                + t[1::2, 1::2]

        t16 = None
        if cost_tree.get(16) is not None:
            nh16, nw16 = h // 16, w // 16
            c16 = cost_tree[16] + lam * self.split_b[0]
            s16 = sum4(cost_tree[8], nh16, nw16) + lam * self.split_b[1]
            t16 = torch.minimum(c16, s16)
            merge(16, s16 >= c16)
        if cost_tree.get(32) is not None and t16 is not None:
            nh32, nw32 = h // 32, w // 32
            c32 = cost_tree[32] + lam * self.split_b[0]
            s32 = sum4(t16, nh32, nw32) + lam * self.split_b[1]
            merge(32, s32 >= c32)
        if use_nxn is None:
            use_nxn = torch.zeros((h8, w8), dtype=torch.bool, device=self.dev)
            nxn_modes = [lm8] * 4
        nxn = (cu_log2 == 3) & use_nxn
        lm4 = lm8.repeat_interleave(2, 0).repeat_interleave(2, 1)
        lm8 = torch.where(nxn, nxn_modes[0].to(torch.int8), lm8)
        pugrid = torch.zeros((h // 4, w // 4), dtype=torch.int8,
                             device=self.dev)
        pugrid[0::2, 0::2] = nxn_modes[0].to(torch.int8)
        pugrid[0::2, 1::2] = nxn_modes[1].to(torch.int8)
        pugrid[1::2, 0::2] = nxn_modes[2].to(torch.int8)
        pugrid[1::2, 1::2] = nxn_modes[3].to(torch.int8)
        n2 = nxn.repeat_interleave(2, 0).repeat_interleave(2, 1)
        lm4 = torch.where(n2, pugrid, lm4)
        tsp8 = tsp8 & ~nxn  # IntraSplit carries the 4x4 TBs already
        return cu_log2, lm8, cm8, nxn, lm4, tsp8


def decision_for(h, w, qp, bd, rdoq, strong, lam_q8, tusplit_on, nxn_on,
                 device) -> IntraDecision:
    key = (h, w, qp, bd, rdoq, strong, lam_q8, tusplit_on, nxn_on, str(device))
    d = _CACHE.get(key)
    if d is None:
        d = IntraDecision(h, w, qp, bd, rdoq, strong, lam_q8, tusplit_on,
                          nxn_on, device)
        _CACHE[key] = d
    return d


def decide_intra_qt(oy, ou, ov, cfg, qp: int, ref_planes=None,
                    device="cuda"):
    """Twin of `decide_intra_qt_jax`: the planes (numpy, padded to the
    coded size) -> (cu_log2, lm8, cm8, nxn, lm4, tsp8) numpy maps of the
    same dtypes and shapes. ref_planes: optional (ry, ru, rv) open-loop
    reference-sample source (the two-pass refinement passes the pass-1
    recon). `device` is explicit: a CUDA device that is absent raises."""
    dev = resolve(device)
    sps = cfg.sps
    h, w = oy.shape
    lam = i_frame_lambda(cfg, qp)
    use_nxn = cfg.intra_nxn
    if use_nxn is None:
        use_nxn = cfg.intra_period == 1
    d = decision_for(h, w, qp, sps.bit_depth, bool(cfg.rdoq),
                     bool(sps.strong_intra_smoothing), int(round(lam * 256)),
                     use_nxn and sps.max_tu_depth_intra >= 1, use_nxn, dev)
    ry, ru, rv = ref_planes if ref_planes is not None else (oy, ou, ov)

    def up(p):
        return torch.as_tensor(np.ascontiguousarray(p, dtype=np.int32)).to(dev)

    maps = d.run(*(up(p) for p in (oy, ou, ov, ry, ru, rv)))
    return tuple(m.cpu().numpy() for m in maps)
