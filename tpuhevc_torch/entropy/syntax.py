"""Slice-data syntax: CTU quadtree, intra CU, transform tree, per-CTU loop.

Counterpart of the reference's TEncSbac/TEncEntropy syntax coding and
TDecSbac/TDecEntropy parsing for the intra path (SURVEY.md §2.2-2.3);
process per H.265 §7.3.8. Encoder and decoder share geometry helpers so the
two directions cannot drift.

Frame-level data interchange is dense arrays (device-friendly):
  cu_log2[y8][x8]  : chosen CU log2 size for each 8x8 cell (>= 3)
  luma_mode[y8][x8]: intra luma mode of the covering CU
  chroma_mode      : chroma syntax value (4 = DM) per 8x8 cell
  coeff_y/cb/cr    : full-res coefficient planes, TU blocks in-place
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codec.params import I_SLICE, PicParams, SeqParams
from ..utils.tables import intra_mpm_list, intra_scan_idx
from .cabac import CTX_OFFSET, CabacDecoder, CabacEncoder
from .residual import decode_residual, encode_residual

DC_MODE = 1


@dataclass
class FrameSyntax:
    width: int   # coded (min-CU aligned) luma size
    height: int
    cu_log2: np.ndarray = None
    luma_mode: np.ndarray = None
    chroma_mode: np.ndarray = None
    coeff_y: np.ndarray = None
    coeff_cb: np.ndarray = None
    coeff_cr: np.ndarray = None
    # inter (P slices), per 8x8 cell, replicated across each CU:
    skip: np.ndarray = None        # cu_skip_flag
    merge_flag: np.ndarray = None
    merge_idx: np.ndarray = None
    mvp_flag: np.ndarray = None
    mv: np.ndarray = None          # (h8, w8, 2) quarter-pel, final MV
    mvd: np.ndarray = None         # (h8, w8, 2)
    ref_idx: np.ndarray = None     # (h8, w8) L0 reference index
    # B slices (two lists):
    inter_dir: np.ndarray = None   # 1 = L0, 2 = L1, 3 = BI
    mv_l1: np.ndarray = None
    mvd_l1: np.ndarray = None
    ref_idx_l1: np.ndarray = None
    mvp_flag_l1: np.ndarray = None
    sao: object = None             # codec.sao_enc.SaoPicParams, or None
    qp_ctu: np.ndarray = None      # per-CTU QpY (cu_qp_delta; QG = CTU)
    # general-stream (foreign-encoder) features, per 4x4 luma cell; only
    # populated by the decoder's parse. full_features flips when a
    # feature outside this encoder's subset appears (NxN, TU split,
    # transform skip, 64 intra CU) and routes recon to recon_full.
    tu_log2: np.ndarray = None     # leaf luma TB log2 per 4-cell (-1 unset)
    luma_mode4: np.ndarray = None  # intra mode per 4-cell (PU granularity)
    ts_y: np.ndarray = None        # transform_skip per luma 4-cell
    ts_cb: np.ndarray = None       # transform_skip per chroma 4-cell
    ts_cr: np.ndarray = None
    mv4: np.ndarray = None         # (h4, w4, 2) PU-granularity motion
    ref4: np.ndarray = None
    mv4_l1: np.ndarray = None      # B slices: L1 PU-granularity motion
    ref4_l1: np.ndarray = None
    dir4: np.ndarray = None        # inter_pred_idc per 4-cell (1/2/3)
    # I_PCM CUs: (x8, y8) top-left cell -> (y, u, v) raw sample blocks
    # already scaled to the output bit depth (sample << (bd - pcm_bd))
    pcm_blocks: dict = field(default_factory=dict)
    # encoder-side intra NxN partitions: 1 at the root cell of a min-CU
    # whose four PU modes live in luma_mode4 (part_mode == PART_NxN,
    # TEncCu.cpp:644-650 counterpart). The TU tree of any intra CU is
    # driven by tu_log2 (leaf TB log2 per 4-cell; -1 = TU = CU).
    nxn: np.ndarray = None
    full_features: bool = False

    def __post_init__(self):
        h8, w8 = self.height // 8, self.width // 8
        h4, w4 = self.height // 4, self.width // 4
        if self.tu_log2 is None:
            self.tu_log2 = np.full((h4, w4), -1, dtype=np.int8)
        if self.nxn is None:
            self.nxn = np.zeros((h8, w8), dtype=np.int8)
        if self.luma_mode4 is None:
            self.luma_mode4 = np.full((h4, w4), DC_MODE, dtype=np.int8)
        if self.ts_y is None:
            self.ts_y = np.zeros((h4, w4), dtype=np.int8)
        if self.ts_cb is None:
            self.ts_cb = np.zeros((h8, w8), dtype=np.int8)
        if self.ts_cr is None:
            self.ts_cr = np.zeros((h8, w8), dtype=np.int8)
        if self.mv4 is None:
            self.mv4 = np.zeros((h4, w4, 2), dtype=np.int32)
        if self.ref4 is None:
            self.ref4 = np.zeros((h4, w4), dtype=np.int32)
        if self.mv4_l1 is None:
            self.mv4_l1 = np.zeros((h4, w4, 2), dtype=np.int32)
        if self.ref4_l1 is None:
            self.ref4_l1 = np.zeros((h4, w4), dtype=np.int32)
        if self.dir4 is None:
            self.dir4 = np.ones((h4, w4), dtype=np.int32)
        if self.cu_log2 is None:
            self.cu_log2 = np.full((h8, w8), 3, dtype=np.int32)
        if self.luma_mode is None:
            self.luma_mode = np.full((h8, w8), DC_MODE, dtype=np.int32)
        if self.chroma_mode is None:
            self.chroma_mode = np.full((h8, w8), 4, dtype=np.int32)
        if self.coeff_y is None:
            self.coeff_y = np.zeros((self.height, self.width), dtype=np.int32)
        if self.coeff_cb is None:
            self.coeff_cb = np.zeros((self.height // 2, self.width // 2), dtype=np.int32)
        if self.coeff_cr is None:
            self.coeff_cr = np.zeros((self.height // 2, self.width // 2), dtype=np.int32)
        if self.skip is None:
            self.skip = np.zeros((h8, w8), dtype=np.int32)
        if self.merge_flag is None:
            self.merge_flag = np.zeros((h8, w8), dtype=np.int32)
        if self.merge_idx is None:
            self.merge_idx = np.zeros((h8, w8), dtype=np.int32)
        if self.mvp_flag is None:
            self.mvp_flag = np.zeros((h8, w8), dtype=np.int32)
        if self.mv is None:
            self.mv = np.zeros((h8, w8, 2), dtype=np.int32)
        if self.ref_idx is None:
            self.ref_idx = np.zeros((h8, w8), dtype=np.int32)
        if self.inter_dir is None:
            self.inter_dir = np.ones((h8, w8), dtype=np.int32)
        if self.mv_l1 is None:
            self.mv_l1 = np.zeros((h8, w8, 2), dtype=np.int32)
        if self.mvd_l1 is None:
            self.mvd_l1 = np.zeros((h8, w8, 2), dtype=np.int32)
        if self.ref_idx_l1 is None:
            self.ref_idx_l1 = np.zeros((h8, w8), dtype=np.int32)
        if self.mvp_flag_l1 is None:
            self.mvp_flag_l1 = np.zeros((h8, w8), dtype=np.int32)
        if self.mvd is None:
            self.mvd = np.zeros((h8, w8, 2), dtype=np.int32)


class _SliceCoder:
    """Shared geometry + context bookkeeping for encode/decode."""

    def __init__(self, fs: FrameSyntax, sps: SeqParams, pps: PicParams,
                 slice_type: int = I_SLICE, max_merge: int = 5,
                 num_ref: int = 1, ref_deltas=None):
        self.fs = fs
        self.sps = sps
        self.pps = pps
        self.slice_type = slice_type
        self.max_merge = max_merge
        self.num_ref = num_ref
        # POC deltas (cur - ref) per L0 entry, for AMVP scaling
        self.ref_deltas = list(ref_deltas) if ref_deltas else list(
            range(1, num_ref + 1))
        self.ref_pocs = [-d for d in self.ref_deltas]
        # B slices: L1 deltas (negative = future picture)
        self.num_ref_l1 = 0
        self.l1_pocs = []
        # TMVP (decode side): collocated-picture motion + current POC
        self.col = None
        self.col_b = None          # two-list ColMotionB for B slices
        self.col_from_l0 = True
        self.check_ldc = False     # all refs (both lists) precede cur
        self.mvd_l1_zero = False
        self.cur_poc = 0
        # cu_qp_delta state (§8.6.1; quantization group = CTU —
        # diff_cu_qp_delta_depth 0, the HM rate-control configuration):
        # last_qp is qPY_PREV, dqp_pending mirrors !IsCuQpDeltaCoded
        self.slice_qp = 26
        self.last_qp = 26
        self.qg_qp = 26      # encoder: intended QP of the current QG
        self.dqp_pending = False
        # tiles / multi-slice: BlockOrder gating cross-segment
        # availability for intra-MPM neighbors (None = whole-pic slice)
        if pps.tiles_enabled:
            from ..codec.tiles import block_order_for

            self.tile_order = block_order_for(sps, pps)
        else:
            self.tile_order = None
        self.ctu = sps.ctu_size
        self.log2_ctu = sps.log2_ctu
        self.w = fs.width
        self.h = fs.height
        self.wctu = (self.w + self.ctu - 1) >> self.log2_ctu
        self.hctu = (self.h + self.ctu - 1) >> self.log2_ctu
        # depth map for split_cu_flag context (depth of *decoded* CUs)
        self.depth8 = np.full((self.h // 8, self.w // 8), -1, dtype=np.int32)
        if slice_type != I_SLICE:
            from ..codec.mv import MvField
            from ..codec.mv_b import MvFieldB
            from ..codec.refsamples import BlockOrder

            if pps.tiles_enabled:
                from ..codec.tiles import block_order_for

                self.order = block_order_for(sps, pps)
                self.order4 = block_order_for(sps, pps, cell_log2=2)
            else:
                self.order = BlockOrder(self.w, self.h, self.log2_ctu)
                # P-path motion at 4-sample granularity (rect
                # partitions); equivalent to the old 8-cell field for
                # 2Nx2N-only streams
                self.order4 = BlockOrder(self.w, self.h, self.log2_ctu,
                                         cell_log2=2)
            self.mvfield = MvField(self.w // 8, self.h // 8, cell=4)
            self.mvfield_b = MvFieldB(self.w // 8, self.h // 8, cell=4)

    # --- context helpers ---------------------------------------------------
    def split_ctx(self, x0: int, y0: int, depth: int) -> int:
        c = 0
        if x0 > 0:
            d = self.depth8[y0 // 8, (x0 - 1) // 8]
            c += 1 if d > depth else 0
        if y0 > 0:
            d = self.depth8[(y0 - 1) // 8, x0 // 8]
            c += 1 if d > depth else 0
        return CTX_OFFSET["split_cu_flag"] + c

    def neighbor_mode(self, x0: int, y0: int, left: bool) -> int:
        """candIntraPredModeA/B with availability rules (§8.4.2), at PU
        (4-sample) granularity so NxN partitions resolve correctly. With
        tiles (tile_order set) a neighbor in another tile/slice segment
        is unavailable (same-cell neighbors — NxN PUs — stay valid)."""
        if left:
            if x0 == 0:
                return DC_MODE
            if not self._cell_avail(x0 - 1, y0, x0, y0):
                return DC_MODE
            return int(self.fs.luma_mode4[y0 // 4, (x0 - 1) // 4])
        if y0 == 0:
            return DC_MODE
        # above outside this CTU row -> DC
        if (y0 - 1) < ((y0 >> self.log2_ctu) << self.log2_ctu):
            return DC_MODE
        if not self._cell_avail(x0, y0 - 1, x0, y0):
            return DC_MODE
        return int(self.fs.luma_mode4[(y0 - 1) // 4, x0 // 4])

    def _cell_avail(self, nx: int, ny: int, cx: int, cy: int) -> bool:
        if self.tile_order is None:
            return True
        n8, c8 = (nx // 8, ny // 8), (cx // 8, cy // 8)
        if n8 == c8:
            return True  # same cell: earlier PU of the same CU
        return self.tile_order.precedes(n8[0], n8[1], c8[0], c8[1])

    def mark_cu(self, x0: int, y0: int, log2: int, mode: int, cmode: int):
        s = 1 << (log2 - 3)
        y8, x8 = y0 // 8, x0 // 8
        self.depth8[y8 : y8 + s, x8 : x8 + s] = self.log2_ctu - log2
        self.fs.cu_log2[y8 : y8 + s, x8 : x8 + s] = log2
        self.fs.luma_mode[y8 : y8 + s, x8 : x8 + s] = mode
        self.fs.chroma_mode[y8 : y8 + s, x8 : x8 + s] = cmode
        s4 = 1 << (log2 - 2)
        y4, x4 = y0 // 4, x0 // 4
        self.fs.luma_mode4[y4 : y4 + s4, x4 : x4 + s4] = mode

    def mark_pu4(self, x0: int, y0: int, size: int, mode: int):
        s4 = size // 4
        self.fs.luma_mode4[y0 // 4 : y0 // 4 + s4,
                           x0 // 4 : x0 // 4 + s4] = mode

    def chroma_actual_mode(self, cmode_syntax: int, luma_mode: int) -> int:
        """intra_chroma_pred_mode syntax -> actual mode (§7.4.9.6/Table 8-3)."""
        if cmode_syntax == 4:
            return luma_mode
        m = (0, 26, 10, 1)[cmode_syntax]
        return 34 if m == luma_mode else m


# --- encoding --------------------------------------------------------------

def effective_qp_ctu(fs: FrameSyntax, requested: np.ndarray, slice_qp: int,
                     ctu: int, wpp: bool = False) -> np.ndarray:
    """Resolve a per-CTU QP request map into the QPs the stream will
    actually carry. cu_qp_delta is only coded at the first
    residual-bearing TU of the quantization group (§7.3.8.10): CUs
    parsed before that point keep CuQpDeltaVal = 0 (QpY = prediction),
    the delta-bearing CU and everything after it in the QG carry the
    delta, and a QG with no coded coefficients at all inherits qPY_PREV
    (§8.6.1). Returns the per-CTU effective map (what fs.qp_ctu's
    decoder write-back will hold) and stores the per-8-cell per-CU QpY
    split in fs.qp8 — the map deblocking must use. With wpp, qPY_PREV
    resets to the slice QP at each CTB row."""
    hctu, wctu = requested.shape
    h8, w8 = fs.height // 8, fs.width // 8
    s8ctu = ctu // 8
    log2_ctu = ctu.bit_length() - 1
    eff = np.empty_like(requested)
    qp8 = np.empty((h8, w8), np.int32)
    cu_log2 = fs.cu_log2

    def leaves(x8, y8, log2):
        """CU leaves inside the cell block, z-order (decode order);
        implicit split at the coded-picture boundary."""
        if x8 >= w8 or y8 >= h8:
            return
        s8 = 1 << (log2 - 3)
        if (x8 + s8 <= w8 and y8 + s8 <= h8
                and int(cu_log2[y8, x8]) == log2):
            yield x8, y8, s8
            return
        half = s8 >> 1
        for dy in (0, half):
            for dx in (0, half):
                yield from leaves(x8 + dx, y8 + dy, log2 - 1)

    last = slice_qp
    for cy in range(hctu):
        if wpp:
            last = slice_qp
        for cx in range(wctu):
            req = int(requested[cy, cx])
            fired = False
            for x8, y8, s8 in leaves(cx * s8ctu, cy * s8ctu, log2_ctu):
                y0, x0, s = y8 * 8, x8 * 8, s8 * 8
                if not fired and (
                        fs.coeff_y[y0:y0 + s, x0:x0 + s].any()
                        or fs.coeff_cb[y0 // 2:(y0 + s) // 2,
                                       x0 // 2:(x0 + s) // 2].any()
                        or fs.coeff_cr[y0 // 2:(y0 + s) // 2,
                                       x0 // 2:(x0 + s) // 2].any()):
                    fired = True
                    last = req
                qp8[y8:y8 + s8, x8:x8 + s8] = last
            eff[cy, cx] = req if fired else last
    fs.qp8 = qp8
    return eff


def encode_slice_data(enc: CabacEncoder, fs: FrameSyntax, sps: SeqParams,
                      pps: PicParams, slice_type: int = I_SLICE,
                      max_merge: int = 5, num_ref: int = 1,
                      ref_deltas=None, num_ref_l1: int = 0,
                      l1_deltas=None, slice_qp: int = 26,
                      ctu_addrs=None, cell_order=None) -> None:
    """ctu_addrs: raster CTU addresses of ONE slice segment in coding
    order (tiles / multi-slice; default = the whole picture in raster
    order). cell_order: tiles.block_order_for BlockOrder gating
    cross-segment intra-MPM availability."""
    sc = _SliceCoder(fs, sps, pps, slice_type, max_merge, num_ref,
                     ref_deltas)
    if cell_order is not None:
        sc.tile_order = cell_order
    if num_ref_l1:
        sc.num_ref_l1 = num_ref_l1
        sc.l1_pocs = [-d for d in l1_deltas]
    use_dqp = pps.cu_qp_delta_enabled
    if use_dqp:
        assert pps.diff_cu_qp_delta_depth == 0, "QG = CTU only"
        sc.slice_qp = sc.last_qp = slice_qp
    if ctu_addrs is None:
        ctu_addrs = range(sc.hctu * sc.wctu)
    ctu_addrs = list(ctu_addrs)
    span_set = frozenset(ctu_addrs)
    for k, rs in enumerate(ctu_addrs):
        cy, cx = divmod(rs, sc.wctu)
        if use_dqp:
            sc.dqp_pending = True
            sc.qg_qp = (int(fs.qp_ctu[cy, cx])
                        if getattr(fs, "qp_ctu", None) is not None
                        else slice_qp)
        if fs.sao is not None:
            # sao_merge flags only when the neighbor CTU is inside this
            # slice segment + tile (§7.3.8.3; span = the segment, which
            # never crosses a tile here)
            _enc_sao_ctu(enc, fs.sao, cx, cy,
                         cx > 0 and (rs - 1) in span_set,
                         cy > 0 and (rs - sc.wctu) in span_set)
        _enc_quadtree(enc, sc, cx << sc.log2_ctu, cy << sc.log2_ctu,
                      sc.log2_ctu, 0)
        enc.encode_bin_trm(1 if k == len(ctu_addrs) - 1 else 0)


# --- SAO syntax (§7.3.8.3 sao(); TEncSbac codeSAOBlkParam order) ----------

def _enc_sao_uvlc(enc, val, max_sym=7):
    """sao_offset_abs: TR with all-bypass bins (parseSaoMaxUvlc mirror)."""
    if max_sym == 0:
        return
    enc.encode_bin_ep(1 if val else 0)
    if val:
        for i in range(1, val):
            enc.encode_bin_ep(1)
        if val < max_sym:
            enc.encode_bin_ep(0)


def _dec_sao_uvlc(dec, max_sym=7):
    if max_sym == 0 or dec.decode_bin_ep() == 0:
        return 0
    v = 1
    while v < max_sym and dec.decode_bin_ep():
        v += 1
    return v


def _enc_sao_type(enc, ctx, t):
    """t: SAO_OFF(-1) -> 0; BO(4) -> 1; EO(0..3) -> 2."""
    if t < 0:
        enc.encode_bin(0, ctx.idx("sao_type_idx"))
    else:
        enc.encode_bin(1, ctx.idx("sao_type_idx"))
        enc.encode_bin_ep(0 if t == 4 else 1)


def _dec_sao_type(dec):
    if dec.decode_bin(dec.ctx.idx("sao_type_idx")) == 0:
        return 0  # off
    return 2 if dec.decode_bin_ep() else 1  # 2 = EO, 1 = BO


def _enc_sao_comp(enc, t, aux, off4, code_type, is_luma):
    """One component's new-mode params (type already known for Cr)."""
    if code_type:
        _enc_sao_type(enc, enc.ctx, t)
    if t < 0:
        return
    for i in range(4):
        _enc_sao_uvlc(enc, abs(int(off4[i])))
    if t == 4:  # BO
        for i in range(4):
            if off4[i]:
                enc.encode_bin_ep(1 if off4[i] < 0 else 0)
        enc.encode_bins_ep(int(aux), 5)
    elif code_type:  # EO: eo_class coded once per channel type
        enc.encode_bins_ep(int(t), 2)


def _enc_sao_ctu(enc, pp, cx, cy, left_ok, up_ok):
    merge = int(pp.merge[cy, cx])
    if (merge == 1 and not left_ok) or (merge == 2 and not up_ok):
        # merge source outside the slice segment/tile: code the
        # resolved params explicitly instead (the apply is unchanged)
        merge = 0
        rp = getattr(pp, "_resolved", None)
        if rp is None:
            rp = pp.resolve()
            pp._resolved = rp
        if left_ok:
            enc.encode_bin(0, enc.ctx.idx("sao_merge_flag"))
        if up_ok:
            enc.encode_bin(0, enc.ctx.idx("sao_merge_flag"))
        if pp.luma_on:
            _enc_sao_comp(enc, int(rp["type_y"][cy, cx]),
                          int(rp["aux_y"][cy, cx]),
                          rp["off_y"][cy, cx], True, True)
        if pp.chroma_on:
            tc = int(rp["type_c"][cy, cx])
            _enc_sao_comp(enc, tc, int(rp["aux_cb"][cy, cx]),
                          rp["off_cb"][cy, cx], True, False)
            if tc >= 0:
                _enc_sao_comp(enc, tc, int(rp["aux_cr"][cy, cx]),
                              rp["off_cr"][cy, cx], False, False)
        return
    if left_ok:
        enc.encode_bin(1 if merge == 1 else 0,
                       enc.ctx.idx("sao_merge_flag"))
    if up_ok and merge != 1:
        enc.encode_bin(1 if merge == 2 else 0,
                       enc.ctx.idx("sao_merge_flag"))
    if merge != 0:
        return
    if pp.luma_on:
        _enc_sao_comp(enc, int(pp.type_y[cy, cx]), int(pp.aux_y[cy, cx]),
                      pp.off_y[cy, cx], True, True)
    if pp.chroma_on:
        tc = int(pp.type_c[cy, cx])
        _enc_sao_comp(enc, tc, int(pp.aux_cb[cy, cx]), pp.off_cb[cy, cx],
                      True, False)
        if tc >= 0:
            _enc_sao_comp(enc, tc, int(pp.aux_cr[cy, cx]),
                          pp.off_cr[cy, cx], False, False)


def _dec_sao_comp(dec, known_type):
    """Returns (type, aux, off4). known_type: None -> parse type;
    else reuse (Cr follows Cb)."""
    if known_type is None:
        mode = _dec_sao_type(dec)
        if mode == 0:
            return -1, 0, np.zeros(4, np.int32)
        is_bo = mode == 1
    else:
        if known_type < 0:
            return -1, 0, np.zeros(4, np.int32)
        is_bo = known_type == 4
    off = np.array([_dec_sao_uvlc(dec) for _ in range(4)], np.int32)
    aux = 0
    if is_bo:
        for i in range(4):
            if off[i] and dec.decode_bin_ep():
                off[i] = -off[i]
        aux = dec.decode_bins_ep(5)
        t = 4
    else:
        if known_type is None:
            t = dec.decode_bins_ep(2)
        else:
            t = known_type
    return t, aux, off


def _dec_sao_ctu(dec, pp, cx, cy, left_ok, up_ok):
    merge = 0
    if left_ok and dec.decode_bin(dec.ctx.idx("sao_merge_flag")):
        merge = 1
    if merge == 0 and up_ok and dec.decode_bin(dec.ctx.idx("sao_merge_flag")):
        merge = 2
    pp.merge[cy, cx] = merge
    if merge:
        return
    if pp.luma_on:
        t, aux, off = _dec_sao_comp(dec, None)
        pp.type_y[cy, cx] = t
        pp.aux_y[cy, cx] = aux
        pp.off_y[cy, cx] = off
    if pp.chroma_on:
        t, aux, off = _dec_sao_comp(dec, None)
        pp.type_c[cy, cx] = t
        pp.aux_cb[cy, cx] = aux
        pp.off_cb[cy, cx] = off
        t2, aux2, off2 = _dec_sao_comp(dec, t)
        pp.aux_cr[cy, cx] = aux2
        pp.off_cr[cy, cx] = off2


def _enc_quadtree(enc, sc, x0, y0, log2, depth):
    if x0 >= sc.w or y0 >= sc.h:
        return  # entirely outside: nothing coded
    size = 1 << log2
    inside = (x0 + size <= sc.w) and (y0 + size <= sc.h)
    want = int(sc.fs.cu_log2[y0 // 8, x0 // 8])
    split = log2 > want
    if inside and log2 > sc.sps.log2_min_cu:
        enc.encode_bin(1 if split else 0, sc.split_ctx(x0, y0, depth))
    elif not inside:
        split = True  # implicit
    if split:
        half = size >> 1
        for sy in (0, half):
            for sx in (0, half):
                _enc_quadtree(enc, sc, x0 + sx, y0 + sy, log2 - 1, depth + 1)
        return
    if sc.slice_type == I_SLICE:
        _enc_cu(enc, sc, x0, y0, log2)
    elif sc.num_ref_l1:
        _enc_cu_b(enc, sc, x0, y0, log2)
    else:
        _enc_cu_p(enc, sc, x0, y0, log2)


def _enc_luma_mode_payload(enc, cand, mode):
    """mpm_idx / rem_intra_luma_pred_mode EP bins (flag already coded)."""
    if mode in cand:
        idx = cand.index(mode)
        enc.encode_bin_ep(0 if idx == 0 else 1)
        if idx:
            enc.encode_bin_ep(idx - 1)
    else:
        rem = mode - sum(1 for c in cand if c < mode)
        enc.encode_bins_ep(rem, 5)


def _enc_cu(enc, sc, x0, y0, log2):
    fs, sps, pps = sc.fs, sc.sps, sc.pps
    y8, x8 = y0 // 8, x0 // 8
    mode = int(fs.luma_mode[y8, x8])
    cmode = int(fs.chroma_mode[y8, x8])
    nxn = bool(fs.nxn[y8, x8]) and log2 == sps.log2_min_cu
    # I slice: no skip/pred_mode flags; part_mode only at min CU size
    if log2 == sps.log2_min_cu:
        enc.encode_bin(0 if nxn else 1, CTX_OFFSET["part_mode"])
    if (not nxn and sps.pcm_enabled
            and sps.pcm_log2_min <= log2 <= sps.pcm_log2_max):
        pcm = fs.pcm_blocks.get((x0 // 8, y0 // 8))
        enc.encode_bin_trm(1 if pcm is not None else 0)
        if pcm is not None:
            sh = sps.bit_depth - sps.pcm_bit_depth
            enc.write_pcm(
                np.concatenate([np.asarray(b).ravel() >> sh for b in pcm]),
                sps.pcm_bit_depth)  # one align, then Y+Cb+Cr contiguous
            sc.mark_cu(x0, y0, log2, DC_MODE, 4)
            return
    if nxn:
        # 4 luma PUs: prev flags first, then idx/rem per PU (§7.3.8.5,
        # mirror of _dec_cu). Candidate lists depend on earlier PUs'
        # modes, so resolve sequentially while collecting the flags.
        half = 1 << (log2 - 1)
        offs = [(0, 0), (half, 0), (0, half), (half, half)]
        modes = [int(fs.luma_mode4[(y0 + dy) // 4, (x0 + dx) // 4])
                 for dx, dy in offs]
        cands = []
        for (dx, dy), m in zip(offs, modes):
            cands.append(intra_mpm_list(
                sc.neighbor_mode(x0 + dx, y0 + dy, True),
                sc.neighbor_mode(x0 + dx, y0 + dy, False)))
            sc.mark_pu4(x0 + dx, y0 + dy, half, m)
        for m, cand in zip(modes, cands):
            enc.encode_bin(1 if m in cand else 0,
                           CTX_OFFSET["prev_intra_luma_pred_flag"])
        for m, cand in zip(modes, cands):
            _enc_luma_mode_payload(enc, cand, m)
        if cmode == 4:
            enc.encode_bin(0, CTX_OFFSET["intra_chroma_pred_mode"])
        else:
            enc.encode_bin(1, CTX_OFFSET["intra_chroma_pred_mode"])
            enc.encode_bins_ep(cmode, 2)
        sc.mark_cu(x0, y0, log2, modes[0], cmode)
        for (dx, dy), m in zip(offs, modes):
            sc.mark_pu4(x0 + dx, y0 + dy, half, m)
        _enc_transform_tree(enc, sc, x0, y0, log2, 0, modes[0], cmode,
                            True, True, intra_split=True, pu_modes=modes)
        return
    # luma mode (single PU)
    cand = intra_mpm_list(sc.neighbor_mode(x0, y0, True),
                          sc.neighbor_mode(x0, y0, False))
    enc.encode_bin(1 if mode in cand else 0,
                   CTX_OFFSET["prev_intra_luma_pred_flag"])
    _enc_luma_mode_payload(enc, cand, mode)
    # chroma mode
    if cmode == 4:
        enc.encode_bin(0, CTX_OFFSET["intra_chroma_pred_mode"])
    else:
        enc.encode_bin(1, CTX_OFFSET["intra_chroma_pred_mode"])
        enc.encode_bins_ep(cmode, 2)
    sc.mark_cu(x0, y0, log2, mode, cmode)
    _enc_transform_tree(enc, sc, x0, y0, log2, 0, mode, cmode, True, True)


def _tu_cbfs(sc, x0, y0, log2):
    fs = sc.fs
    s = 1 << log2
    cbf_y = bool(fs.coeff_y[y0 : y0 + s, x0 : x0 + s].any())
    cs = max(4, s >> 1)  # chroma TB size (>= 4)
    cbf_cb = bool(fs.coeff_cb[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs].any())
    cbf_cr = bool(fs.coeff_cr[y0 // 2 : y0 // 2 + cs, x0 // 2 : x0 // 2 + cs].any())
    return cbf_y, cbf_cb, cbf_cr


def _enc_transform_tree(enc, sc, x0, y0, log2, depth, mode, cmode,
                        parent_cb, parent_cr, intra_split=False,
                        pu_modes=None, cu_x0=None, cu_y0=None):
    """§7.3.8.8 transform_tree, intra. Split decisions come from
    fs.tu_log2 (leaf TB log2 per 4-cell; -1/log2 = TU = this node) —
    exact mirror of _dec_transform_tree including IntraSplit and the
    chroma-at-8x8-parent rule."""
    sps = sc.sps
    fs = sc.fs
    if cu_x0 is None:
        cu_x0, cu_y0 = x0, y0
    max_depth = sps.max_tu_depth_intra + (1 if intra_split else 0)
    want = int(fs.tu_log2[y0 // 4, x0 // 4])
    if intra_split and depth == 0:
        split = 1  # inferred (§7.4.9.8)
    elif log2 > sps.log2_max_tu:
        split = 1  # implicit
    elif log2 <= sps.log2_min_tu or depth >= max_depth:
        split = 0
    else:
        split = 1 if (0 <= want < log2) else 0
        enc.encode_bin(split,
                       CTX_OFFSET["split_transform_flag"] + (5 - log2))
    cbf_y, cbf_cb, cbf_cr = _tu_cbfs(sc, x0, y0, log2)
    if log2 > 2:
        if parent_cb:
            enc.encode_bin(1 if cbf_cb else 0, CTX_OFFSET["qt_cbf"] + 5 + depth)
        if parent_cr:
            enc.encode_bin(1 if cbf_cr else 0, CTX_OFFSET["qt_cbf"] + 5 + depth)
    else:
        cbf_cb, cbf_cr = parent_cb, parent_cr
    if split:
        half = 1 << (log2 - 1)
        for sy in (0, half):
            for sx in (0, half):
                sub_mode = mode
                if pu_modes is not None and depth == 0:
                    sub_mode = pu_modes[(1 if sy else 0) * 2
                                        + (1 if sx else 0)]
                _enc_transform_tree(enc, sc, x0 + sx, y0 + sy, log2 - 1,
                                    depth + 1, sub_mode, cmode, cbf_cb,
                                    cbf_cr, intra_split, pu_modes,
                                    cu_x0, cu_y0)
        if log2 == 3 and (cbf_cb or cbf_cr):
            # chroma residual of the split 8x8 node lives at this level
            _enc_chroma_tu(enc, sc, x0, y0, 2, mode, cmode, cbf_cb,
                           cbf_cr, cu_x0, cu_y0)
        return
    # leaf TU: intra always codes cbf_luma (no rqt_root_cbf in intra)
    enc.encode_bin(1 if cbf_y else 0,
                   CTX_OFFSET["qt_cbf"] + (1 if depth == 0 else 0))
    _enc_transform_unit(enc, sc, x0, y0, log2, depth, mode, cmode,
                        cbf_y, cbf_cb, cbf_cr, cu_x0, cu_y0)


def _enc_chroma_tu(enc, sc, x0, y0, clog2, mode, cmode, cbf_cb, cbf_cr,
                   cu_x0, cu_y0):
    """Chroma residual blocks for a TU node (luma coords x0,y0); mirror
    of _dec_chroma_tu (without transform-skip: the encoder never emits
    it)."""
    fs, pps = sc.fs, sc.pps
    cs = 1 << clog2
    cx, cy2 = x0 // 2, y0 // 2
    if cbf_cb or cbf_cr:
        _enc_dqp_if_pending(enc, sc)
    # DM chroma of an NxN CU follows PU0's mode (§8.4.3)
    lm = int(fs.luma_mode4[cu_y0 // 4, cu_x0 // 4])
    actual_cmode = sc.chroma_actual_mode(cmode, lm)
    cscan = intra_scan_idx(actual_cmode, clog2, False)
    if cbf_cb:
        encode_residual(enc, fs.coeff_cb[cy2 : cy2 + cs, cx : cx + cs],
                        clog2, False, cscan, pps.sign_data_hiding)
    if cbf_cr:
        encode_residual(enc, fs.coeff_cr[cy2 : cy2 + cs, cx : cx + cs],
                        clog2, False, cscan, pps.sign_data_hiding)


def _enc_transform_unit(enc, sc, x0, y0, log2, depth, mode, cmode,
                        cbf_y, cbf_cb, cbf_cr, cu_x0=None, cu_y0=None):
    fs, pps = sc.fs, sc.pps
    if cu_x0 is None:
        cu_x0, cu_y0 = x0, y0
    s = 1 << log2
    if not (cbf_y or cbf_cb or cbf_cr):
        return
    _enc_dqp_if_pending(enc, sc)
    if cbf_y:
        scan = intra_scan_idx(mode, log2, True)
        blk = fs.coeff_y[y0 : y0 + s, x0 : x0 + s]
        encode_residual(enc, blk, log2, True, scan, pps.sign_data_hiding)
    # chroma (4:2:0): TBs at log2-1, but never below 4x4; 4x4 luma TUs
    # carry chroma at the parent 8x8 level (_enc_transform_tree)
    if log2 > 2:
        _enc_chroma_tu(enc, sc, x0, y0, log2 - 1, mode, cmode, cbf_cb,
                       cbf_cr, cu_x0, cu_y0)


# --- decoding --------------------------------------------------------------

def decode_slice_data(dec: CabacDecoder, sps: SeqParams, pps: PicParams,
                      width: int, height: int, slice_type: int = I_SLICE,
                      max_merge: int = 5, sao_luma: bool = False,
                      sao_chroma: bool = False, num_ref: int = 1,
                      ref_deltas=None, num_ref_l1: int = 0,
                      l1_deltas=None, col=None, col_b=None,
                      col_from_l0: bool = True, check_ldc: bool = False,
                      mvd_l1_zero: bool = False,
                      cur_poc: int = 0, slice_qp: int = 26,
                      fs: FrameSyntax = None, ctu_addrs=None,
                      cell_order=None, subset_end: bool = False
                      ) -> FrameSyntax:
    """fs/ctu_addrs/cell_order: multi-segment pictures decode each
    slice NAL into the shared picture FrameSyntax over its own CTU
    span (tiles: one segment per tile, coding order inside)."""
    if fs is None:
        fs = FrameSyntax(width, height)
    sc = _SliceCoder(fs, sps, pps, slice_type, max_merge, num_ref,
                     ref_deltas)
    if cell_order is not None:
        sc.tile_order = cell_order
    sc.col = col
    sc.col_b = col_b
    sc.col_from_l0 = col_from_l0
    sc.check_ldc = check_ldc
    sc.mvd_l1_zero = mvd_l1_zero
    sc.cur_poc = cur_poc
    if num_ref_l1:
        sc.num_ref_l1 = num_ref_l1
        sc.l1_pocs = [-d for d in l1_deltas]
    if (sao_luma or sao_chroma) and fs.sao is None:
        from ..codec.sao_enc import SaoPicParams

        fs.sao = SaoPicParams(sc.hctu, sc.wctu, luma_on=sao_luma,
                              chroma_on=sao_chroma)
    use_dqp = pps.cu_qp_delta_enabled
    if use_dqp:
        assert pps.diff_cu_qp_delta_depth == 0, "QG = CTU only"
        sc.slice_qp = sc.last_qp = slice_qp
        if getattr(fs, "qp_ctu", None) is None:
            fs.qp_ctu = np.full((sc.hctu, sc.wctu), slice_qp, np.int32)
        if getattr(fs, "qp8", None) is None:
            fs.qp8 = np.full((fs.height // 8, fs.width // 8), slice_qp,
                             np.int32)
    if ctu_addrs is None:
        ctu_addrs = range(sc.hctu * sc.wctu)
    ctu_addrs = list(ctu_addrs)
    span_set = frozenset(ctu_addrs)
    for k, rs in enumerate(ctu_addrs):
        cy, cx = divmod(rs, sc.wctu)
        if use_dqp:
            sc.dqp_pending = True
        if fs.sao is not None:
            # merge flags gated by slice segment/tile (§7.3.8.3)
            _dec_sao_ctu(dec, fs.sao, cx, cy,
                         cx > 0 and (rs - 1) in span_set,
                         cy > 0 and (rs - sc.wctu) in span_set)
        _dec_quadtree(dec, sc, cx << sc.log2_ctu, cy << sc.log2_ctu,
                      sc.log2_ctu, 0)
        if use_dqp:
            # QG QpY: predicted (= qPY_PREV) when no delta was coded
            fs.qp_ctu[cy, cx] = sc.last_qp
        end = dec.decode_bin_trm()
        if end:  # end_of_slice_segment_flag terminates the segment
            fs.consumed_ctus = k + 1
            return fs
        if k == len(ctu_addrs) - 1:
            # a tile substream inside a larger slice ends with
            # end_of_slice_segment_flag 0 + end_of_subset_one_bit
            # (§7.3.8.1); plain slice segments must have flagged end
            assert subset_end, "missing end_of_slice flag"
    fs.consumed_ctus = len(ctu_addrs)
    return fs


def _dec_quadtree(dec, sc, x0, y0, log2, depth):
    if x0 >= sc.w or y0 >= sc.h:
        return
    size = 1 << log2
    inside = (x0 + size <= sc.w) and (y0 + size <= sc.h)
    if inside and log2 > sc.sps.log2_min_cu:
        split = dec.decode_bin(sc.split_ctx(x0, y0, depth))
    elif not inside:
        split = 1
    else:
        split = 0
    if split:
        half = size >> 1
        for sy in (0, half):
            for sx in (0, half):
                _dec_quadtree(dec, sc, x0 + sx, y0 + sy, log2 - 1, depth + 1)
        return
    if sc.slice_type == I_SLICE:
        _dec_cu(dec, sc, x0, y0, log2)
    elif sc.num_ref_l1:
        _dec_cu_b(dec, sc, x0, y0, log2)
    else:
        _dec_cu_p(dec, sc, x0, y0, log2)
    if getattr(sc.fs, "qp8", None) is not None:
        # per-CU QpY for deblocking: CUs parsed before the QG's
        # cu_qp_delta keep CuQpDeltaVal = 0 (QpY = prediction), CUs from
        # the delta-bearing one onward carry it — sc.last_qp tracks
        # exactly that (§8.6.1; HM setQPSubParts at parseDeltaQP)
        s8 = max(1, size >> 3)
        sc.fs.qp8[y0 >> 3 : (y0 >> 3) + s8,
                  x0 >> 3 : (x0 >> 3) + s8] = sc.last_qp


def _dec_pcm_cu(dec, sc, x0, y0, log2):
    """I_PCM CU parse: raw samples after the pcm_flag terminating bin
    (§7.3.8.7; TDecSbac::parseIPCMInfo TDecSbac.cpp:364-404 — read
    luma then Cb then Cr row-major from the byte-aligned stream
    position, then restart the arithmetic engine). The CU's intra mode
    stays DC for neighbor MPM purposes (TComDataCU's init default)."""
    sps, fs = sc.sps, sc.fs
    size = 1 << log2
    nb = sps.pcm_bit_depth
    sh = sps.bit_depth - nb
    yb = dec.read_pcm_samples(size * size, nb).reshape(size, size) << sh
    cs = size >> 1
    ub = dec.read_pcm_samples(cs * cs, nb).reshape(cs, cs) << sh
    vb = dec.read_pcm_samples(cs * cs, nb).reshape(cs, cs) << sh
    dec.start()
    fs.full_features = True
    fs.pcm_blocks[(x0 // 8, y0 // 8)] = (yb, ub, vb)
    sc.mark_cu(x0, y0, log2, DC_MODE, 4)
    s4 = 1 << (log2 - 2)
    fs.tu_log2[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = log2


def _dec_luma_mode(dec, sc, x0, y0, prev_flag):
    cand = intra_mpm_list(sc.neighbor_mode(x0, y0, True),
                          sc.neighbor_mode(x0, y0, False))
    if prev_flag:
        idx = 0
        if dec.decode_bin_ep():
            idx = 1 + dec.decode_bin_ep()
        return cand[idx]
    rem = dec.decode_bins_ep(5)
    for c in sorted(cand):
        if rem >= c:
            rem += 1
    return rem


def _dec_cu(dec, sc, x0, y0, log2):
    sps = sc.sps
    nxn = False
    if log2 == sps.log2_min_cu:
        part = dec.decode_bin(CTX_OFFSET["part_mode"])
        nxn = part == 0
    if (not nxn and sps.pcm_enabled
            and sps.pcm_log2_min <= log2 <= sps.pcm_log2_max
            and dec.decode_bin_trm()):
        _dec_pcm_cu(dec, sc, x0, y0, log2)
        return
    if not nxn:
        mode = _dec_luma_mode(
            dec, sc, x0, y0,
            dec.decode_bin(CTX_OFFSET["prev_intra_luma_pred_flag"]))
        if dec.decode_bin(CTX_OFFSET["intra_chroma_pred_mode"]):
            cmode = dec.decode_bins_ep(2)
        else:
            cmode = 4
        sc.mark_cu(x0, y0, log2, mode, cmode)
        _dec_transform_tree(dec, sc, x0, y0, log2, 0, mode, cmode,
                            True, True)
        return
    # NxN: 4 luma PUs (prev flags first, then idx/rem per PU — §7.3.8.5)
    sc.fs.full_features = True
    half = 1 << (log2 - 1)
    offs = [(0, 0), (half, 0), (0, half), (half, half)]
    flags = [dec.decode_bin(CTX_OFFSET["prev_intra_luma_pred_flag"])
             for _ in range(4)]
    modes = []
    for (dx, dy), fl in zip(offs, flags):
        m = _dec_luma_mode(dec, sc, x0 + dx, y0 + dy, fl)
        sc.mark_pu4(x0 + dx, y0 + dy, half, m)
        modes.append(m)
    if dec.decode_bin(CTX_OFFSET["intra_chroma_pred_mode"]):
        cmode = dec.decode_bins_ep(2)
    else:
        cmode = 4
    sc.mark_cu(x0, y0, log2, modes[0], cmode)
    for (dx, dy), m in zip(offs, modes):
        sc.mark_pu4(x0 + dx, y0 + dy, half, m)
    # IntraSplit: depth-0 split inferred (§7.4.9.8), luma mode per quadrant
    _dec_transform_tree(dec, sc, x0, y0, log2, 0, modes[0], cmode,
                        True, True, intra_split=True, pu_modes=modes)


def _dec_transform_tree(dec, sc, x0, y0, log2, depth, mode, cmode,
                        parent_cb, parent_cr, intra_split=False,
                        pu_modes=None, cu_x0=None, cu_y0=None):
    """§7.3.8.8 transform_tree (intra). Handles IntraSplit (NxN),
    MaxTrafoDepth, the 4x4-split chroma-at-parent rule, and records leaf
    TBs into fs.tu_log2 for the general reconstruction."""
    sps = sc.sps
    fs = sc.fs
    if cu_x0 is None:
        cu_x0, cu_y0 = x0, y0
    max_depth = sps.max_tu_depth_intra + (1 if intra_split else 0)
    if intra_split and depth == 0:
        split = 1
    elif log2 > sps.log2_max_tu:
        split = 1
    elif log2 <= sps.log2_min_tu or depth >= max_depth:
        split = 0
    else:
        split = dec.decode_bin(CTX_OFFSET["split_transform_flag"]
                               + (5 - log2))
    cbf_cb = cbf_cr = False
    if log2 > 2:
        if parent_cb:
            cbf_cb = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"] + 5 + depth))
        if parent_cr:
            cbf_cr = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"] + 5 + depth))
    else:
        cbf_cb, cbf_cr = parent_cb, parent_cr
    if split:
        if depth > 0 or not intra_split:
            fs.full_features = True  # a real TU split (not TU = CU)
        half = 1 << (log2 - 1)
        for sy in (0, half):
            for sx in (0, half):
                sub_mode = mode
                if pu_modes is not None and depth == 0:
                    sub_mode = pu_modes[(1 if sy else 0) * 2
                                        + (1 if sx else 0)]
                _dec_transform_tree(dec, sc, x0 + sx, y0 + sy, log2 - 1,
                                    depth + 1, sub_mode, cmode, cbf_cb,
                                    cbf_cr, intra_split, pu_modes,
                                    cu_x0, cu_y0)
        if log2 == 3 and (cbf_cb or cbf_cr):
            # chroma residual of the split 8x8 node lives at this level
            _dec_chroma_tu(dec, sc, x0, y0, 2, mode, cmode, cbf_cb,
                           cbf_cr, cu_x0, cu_y0)
        return
    s4 = 1 << (log2 - 2)
    fs.tu_log2[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = log2
    if log2 == 6:
        fs.full_features = True
    cbf_y = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"]
                                + (1 if depth == 0 else 0)))
    _dec_transform_unit(dec, sc, x0, y0, log2, depth, mode, cmode,
                        cbf_y, cbf_cb, cbf_cr, cu_x0, cu_y0)


def _dec_ts_flag(dec, comp_c=False):
    return dec.decode_bin(CTX_OFFSET["transform_skip_flag"]
                          + (1 if comp_c else 0))


def _dec_chroma_tu(dec, sc, x0, y0, clog2, mode, cmode, cbf_cb, cbf_cr,
                   cu_x0, cu_y0):
    """Chroma residual blocks for a TU node (luma coords x0,y0)."""
    fs, pps = sc.fs, sc.pps
    cs = 1 << clog2
    cx, cy2 = x0 // 2, y0 // 2
    if cbf_cb or cbf_cr:
        _dec_dqp_if_pending(dec, sc)
    # DM chroma of an NxN CU follows PU0's mode (§8.4.3)
    lm = int(fs.luma_mode4[cu_y0 // 4, cu_x0 // 4])
    actual_cmode = sc.chroma_actual_mode(cmode, lm)
    cscan = intra_scan_idx(actual_cmode, clog2, False)
    ts_ok = pps.transform_skip_enabled and clog2 == 2
    if cbf_cb:
        if ts_ok and _dec_ts_flag(dec, True):
            fs.ts_cb[cy2 // 4, cx // 4] = 1
            fs.full_features = True
        fs.coeff_cb[cy2 : cy2 + cs, cx : cx + cs] = decode_residual(
            dec, clog2, False, cscan, pps.sign_data_hiding)
    if cbf_cr:
        if ts_ok and _dec_ts_flag(dec, True):
            fs.ts_cr[cy2 // 4, cx // 4] = 1
            fs.full_features = True
        fs.coeff_cr[cy2 : cy2 + cs, cx : cx + cs] = decode_residual(
            dec, clog2, False, cscan, pps.sign_data_hiding)


def _dec_transform_unit(dec, sc, x0, y0, log2, depth, mode, cmode,
                        cbf_y, cbf_cb, cbf_cr, cu_x0=None, cu_y0=None):
    fs, pps = sc.fs, sc.pps
    if cu_x0 is None:
        cu_x0, cu_y0 = x0, y0
    s = 1 << log2
    if not (cbf_y or cbf_cb or cbf_cr):
        return
    _dec_dqp_if_pending(dec, sc)
    if cbf_y:
        if pps.transform_skip_enabled and log2 == 2 \
                and _dec_ts_flag(dec, False):
            fs.ts_y[y0 // 4, x0 // 4] = 1
            fs.full_features = True
        scan = intra_scan_idx(mode, log2, True)
        fs.coeff_y[y0 : y0 + s, x0 : x0 + s] = decode_residual(
            dec, log2, True, scan, pps.sign_data_hiding)
    if log2 > 2:
        _dec_chroma_tu(dec, sc, x0, y0, log2 - 1, mode, cmode, cbf_cb,
                       cbf_cr, cu_x0, cu_y0)


# --- inter (P slice) CU coding ----------------------------------------------

def _mark_inter_cu(sc, x0, y0, log2, mv, skip, merge_f, merge_i, mvp_f,
                   mvd, ref=0):
    fs = sc.fs
    s8 = 1 << (log2 - 3)
    y8, x8 = y0 // 8, x0 // 8
    sc.depth8[y8 : y8 + s8, x8 : x8 + s8] = sc.log2_ctu - log2
    fs.cu_log2[y8 : y8 + s8, x8 : x8 + s8] = log2
    fs.skip[y8 : y8 + s8, x8 : x8 + s8] = skip
    fs.merge_flag[y8 : y8 + s8, x8 : x8 + s8] = merge_f
    fs.merge_idx[y8 : y8 + s8, x8 : x8 + s8] = merge_i
    fs.mvp_flag[y8 : y8 + s8, x8 : x8 + s8] = mvp_f
    fs.mv[y8 : y8 + s8, x8 : x8 + s8] = mv
    fs.mvd[y8 : y8 + s8, x8 : x8 + s8] = mvd
    fs.ref_idx[y8 : y8 + s8, x8 : x8 + s8] = ref
    s4 = 1 << (log2 - 2)
    y4, x4 = y0 // 4, x0 // 4
    fs.mv4[y4 : y4 + s4, x4 : x4 + s4] = mv
    fs.ref4[y4 : y4 + s4, x4 : x4 + s4] = ref
    if skip:
        fs.tu_log2[y4 : y4 + s4, x4 : x4 + s4] = min(log2, 5)
    sc.mvfield.set_cu(x0, y0, 1 << log2, mv, ref)


def _skip_ctx(sc, x0, y0):
    c = 0
    if x0 > 0 and sc.fs.skip[y0 // 8, (x0 - 1) // 8] and sc.depth8[y0 // 8, (x0 - 1) // 8] >= 0:
        c += 1
    if y0 > 0 and sc.fs.skip[(y0 - 1) // 8, x0 // 8] and sc.depth8[(y0 - 1) // 8, x0 // 8] >= 0:
        c += 1
    return CTX_OFFSET["cu_skip_flag"] + c


def _enc_merge_idx(enc, idx, max_merge):
    if max_merge <= 1:
        return
    enc.encode_bin(1 if idx > 0 else 0, CTX_OFFSET["merge_idx"])
    for k in range(1, idx):
        enc.encode_bin_ep(1)
    if 0 < idx < max_merge - 1:
        enc.encode_bin_ep(0)


def _dec_merge_idx(dec, max_merge):
    if max_merge <= 1:
        return 0
    if not dec.decode_bin(CTX_OFFSET["merge_idx"]):
        return 0
    idx = 1
    while idx < max_merge - 1 and dec.decode_bin_ep():
        idx += 1
    return idx


def _enc_mvd(enc, mvd):
    dx, dy = int(mvd[0]), int(mvd[1])
    enc.encode_bin(1 if dx != 0 else 0, CTX_OFFSET["abs_mvd_greater_flag"])
    enc.encode_bin(1 if dy != 0 else 0, CTX_OFFSET["abs_mvd_greater_flag"])
    if dx:
        enc.encode_bin(1 if abs(dx) > 1 else 0,
                       CTX_OFFSET["abs_mvd_greater_flag"] + 1)
    if dy:
        enc.encode_bin(1 if abs(dy) > 1 else 0,
                       CTX_OFFSET["abs_mvd_greater_flag"] + 1)
    for d in (dx, dy):
        if d:
            if abs(d) > 1:
                _enc_eg1(enc, abs(d) - 2)
            enc.encode_bin_ep(1 if d < 0 else 0)


def _dec_mvd(dec):
    gx = dec.decode_bin(CTX_OFFSET["abs_mvd_greater_flag"])
    gy = dec.decode_bin(CTX_OFFSET["abs_mvd_greater_flag"])
    g1x = dec.decode_bin(CTX_OFFSET["abs_mvd_greater_flag"] + 1) if gx else 0
    g1y = dec.decode_bin(CTX_OFFSET["abs_mvd_greater_flag"] + 1) if gy else 0
    out = []
    for g, g1 in ((gx, g1x), (gy, g1y)):
        if not g:
            out.append(0)
            continue
        v = (2 + _dec_eg1(dec)) if g1 else 1
        if dec.decode_bin_ep():
            v = -v
        out.append(v)
    return out


def _enc_dqp_if_pending(enc, sc):
    """cu_qp_delta_abs/sign at the first residual-bearing TU of the
    quantization group (§7.3.8.10; TEncSbac::codeDeltaQP — TU-5 prefix
    on two contexts, EG0 suffix, bypass sign)."""
    if not sc.dqp_pending:
        return
    sc.dqp_pending = False
    off = 6 * (sc.sps.bit_depth - 8)
    dqp = sc.qg_qp - sc.last_qp
    dqp = (dqp + 78 + off + off // 2) % (52 + off) - 26 - off // 2
    a = abs(dqp)
    tu = min(a, 5)
    c0 = CTX_OFFSET["cu_qp_delta"]
    enc.encode_bin(1 if tu else 0, c0)
    if tu:
        for _ in range(tu - 1):
            enc.encode_bin(1, c0 + 1)
        if tu < 5:
            enc.encode_bin(0, c0 + 1)
        if a >= 5:
            _enc_eg0(enc, a - 5)
        enc.encode_bin_ep(1 if dqp < 0 else 0)
    sc.last_qp = ((sc.last_qp + dqp + 52 + 2 * off) % (52 + off)) - off


def _dec_dqp_if_pending(dec, sc):
    """Inverse of _enc_dqp_if_pending; updates qPY_PREV."""
    if not sc.dqp_pending:
        return
    sc.dqp_pending = False
    c0 = CTX_OFFSET["cu_qp_delta"]
    a = 0
    sign = 0
    if dec.decode_bin(c0):
        a = 1
        while a < 5 and dec.decode_bin(c0 + 1):
            a += 1
        if a == 5:
            a += _dec_eg0(dec)
        sign = dec.decode_bin_ep()
    dqp = -a if sign else a
    off = 6 * (sc.sps.bit_depth - 8)
    sc.last_qp = ((sc.last_qp + dqp + 52 + 2 * off) % (52 + off)) - off


def _enc_eg0(enc, v):
    """0th-order Exp-Golomb, bypass (§9.3.3.3)."""
    k = 0
    while v >= (1 << k):
        enc.encode_bin_ep(1)
        v -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    if k:
        enc.encode_bins_ep(v, k)


def _dec_eg0(dec):
    k = 0
    v = 0
    while dec.decode_bin_ep():
        v += 1 << k
        k += 1
    if k:
        v += dec.decode_bins_ep(k)
    return v


def _enc_eg1(enc, v):
    """1st-order Exp-Golomb, bypass (§9.3.3.3)."""
    k = 1
    while v >= (1 << k):
        enc.encode_bin_ep(1)
        v -= 1 << k
        k += 1
    enc.encode_bin_ep(0)
    if k:
        enc.encode_bins_ep(v, k)


def _dec_eg1(dec):
    k = 1
    base = 0
    while dec.decode_bin_ep():
        base += 1 << k
        k += 1
    return base + (dec.decode_bins_ep(k) if k else 0)



def _enc_ref_idx(enc, ref, num_ref):
    if num_ref <= 1:
        return
    enc.encode_bin(0 if ref == 0 else 1, CTX_OFFSET["ref_idx"])
    if ref > 0:
        rem = num_ref - 2
        r = ref - 1
        for ui in range(rem):
            sym = 0 if ui == r else 1
            if ui == 0:
                enc.encode_bin(sym, CTX_OFFSET["ref_idx"] + 1)
            else:
                enc.encode_bin_ep(sym)
            if sym == 0:
                break


def _dec_ref_idx(dec, num_ref):
    if num_ref <= 1:
        return 0
    if dec.decode_bin(CTX_OFFSET["ref_idx"]) == 0:
        return 0
    ref = 1
    rem = num_ref - 2
    for ui in range(rem):
        sym = (dec.decode_bin(CTX_OFFSET["ref_idx"] + 1) if ui == 0
               else dec.decode_bin_ep())
        if sym == 0:
            break
        ref += 1
    return ref


def _enc_part_mode_inter(enc, sc, log2, part: str) -> None:
    """TEncSbac::codePartSize inter branch — exact inverse of
    _dec_part_mode_inter (prefix of up-to-2/3 ctx bins + AMP bin)."""
    sps = sc.sps
    at_min = log2 == sps.log2_min_cu
    names = ("2Nx2N", "2NxN", "Nx2N", "NxN")
    base = {"2NxnU": "2NxN", "2NxnD": "2NxN",
            "nLx2N": "Nx2N", "nRx2N": "Nx2N"}.get(part, part)
    mode = names.index(base)
    max_bits = 2 + (1 if at_min and log2 > 3 else 0)
    for ui in range(mode):
        enc.encode_bin(0, CTX_OFFSET["part_mode"] + ui)
    if mode < max_bits:
        enc.encode_bin(1, CTX_OFFSET["part_mode"] + mode)
    if sps.amp_enabled and not at_min and base in ("2NxN", "Nx2N"):
        if part == base:
            enc.encode_bin(1, CTX_OFFSET["part_mode"] + 3)
        else:
            enc.encode_bin(0, CTX_OFFSET["part_mode"] + 3)
            enc.encode_bin_ep(1 if part in ("2NxnD", "nRx2N") else 0)


def _enc_cu_p_partitioned(enc, sc, x0, y0, log2, part: str):
    """Encode one rectangular-PU inter CU. Per-PU motion and merge/AMVP
    decisions come from the per-8-cell maps at each PU's origin cell —
    derived by the native decision walk (decision_walk.cpp partition
    branch) in the same progressive PU order the decoder replays, so
    the coded stream decodes to the given motion exactly (TEncCu PU
    loop / TEncSearch::xCheckBestMVP counterpart)."""
    fs = sc.fs
    size = 1 << log2
    enc.encode_bin(0, CTX_OFFSET["pred_mode_flag"])  # inter
    _enc_part_mode_inter(enc, sc, log2, part)
    for pi, (dx, dy, pw, ph) in enumerate(_pu_geometry(part, size)):
        px, py = x0 + dx, y0 + dy
        y8, x8 = py // 8, px // 8
        mv = fs.mv[y8, x8].copy()
        ref = int(fs.ref_idx[y8, x8])
        merge_f = int(fs.merge_flag[y8, x8])
        enc.encode_bin(merge_f, CTX_OFFSET["merge_flag"])
        if merge_f:
            _enc_merge_idx(enc, int(fs.merge_idx[y8, x8]), sc.max_merge)
        else:
            _enc_ref_idx(enc, ref, sc.num_ref)
            _enc_mvd(enc, fs.mvd[y8, x8])
            enc.encode_bin(int(fs.mvp_flag[y8, x8]),
                           CTX_OFFSET["mvp_flag"])
        _mark_inter_pu(sc, x0, y0, log2, px, py, pw, ph, mv, ref, pi == 0)
    cbf_y, cbf_cb, cbf_cr = _tu_cbfs(sc, x0, y0, log2)
    root_cbf = 1 if (cbf_y or cbf_cb or cbf_cr) else 0
    enc.encode_bin(root_cbf, CTX_OFFSET["rqt_root_cbf"])
    if root_cbf:
        intersplit = sc.sps.max_tu_depth_inter == 0
        _enc_transform_tree_p(enc, sc, x0, y0, log2, 0, True, True,
                              inter_split=intersplit)
    else:
        s4 = 1 << (log2 - 2)
        fs.tu_log2[y0 // 4 : y0 // 4 + s4,
                   x0 // 4 : x0 // 4 + s4] = min(log2, 5)


def _enc_cu_p(enc, sc, x0, y0, log2):
    from ..codec.mv import amvp_candidates, merge_candidates

    fs = sc.fs
    y8, x8 = y0 // 8, x0 // 8
    skip = int(fs.skip[y8, x8])
    merge_f = int(fs.merge_flag[y8, x8])
    merge_i = int(fs.merge_idx[y8, x8])
    mvp_f = int(fs.mvp_flag[y8, x8])
    mv = fs.mv[y8, x8].copy()
    mvd = fs.mvd[y8, x8].copy()
    ref = int(fs.ref_idx[y8, x8])
    size = 1 << log2

    enc.encode_bin(skip, _skip_ctx(sc, x0, y0))
    if skip:
        _enc_merge_idx(enc, merge_i, sc.max_merge)
        _mark_inter_cu(sc, x0, y0, log2, mv, 1, 1, merge_i, 0, (0, 0), ref)
        return
    if int(fs.inter_dir[y8, x8]) == 0:  # intra CU in a P slice
        enc.encode_bin(1, CTX_OFFSET["pred_mode_flag"])
        sc.depth8[y8 : y8 + (1 << (log2 - 3)),
                  x8 : x8 + (1 << (log2 - 3))] = sc.log2_ctu - log2
        _enc_cu(enc, sc, x0, y0, log2)
        s8 = 1 << (log2 - 3)
        fs.inter_dir[y8 : y8 + s8, x8 : x8 + s8] = 0
        return
    part_map = getattr(fs, "part_mode", None)
    pcode = int(part_map[y8, x8]) if part_map is not None else 0
    if pcode:
        _enc_cu_p_partitioned(enc, sc, x0, y0, log2,
                              ("2Nx2N", "2NxN", "Nx2N")[pcode])
        return
    enc.encode_bin(0, CTX_OFFSET["pred_mode_flag"])  # inter
    enc.encode_bin(1, CTX_OFFSET["part_mode"])       # 2Nx2N
    enc.encode_bin(merge_f, CTX_OFFSET["merge_flag"])
    if merge_f:
        _enc_merge_idx(enc, merge_i, sc.max_merge)
    else:
        _enc_ref_idx(enc, ref, sc.num_ref)
        _enc_mvd(enc, mvd)
        enc.encode_bin(mvp_f, CTX_OFFSET["mvp_flag"])
    _mark_inter_cu(sc, x0, y0, log2, mv, 0, merge_f, merge_i, mvp_f, mvd,
                   ref)
    cbf_y, cbf_cb, cbf_cr = _tu_cbfs(sc, x0, y0, log2)
    root_cbf = 1 if (cbf_y or cbf_cb or cbf_cr) else 0
    if not merge_f:  # 2Nx2N merge infers rqt_root_cbf = 1
        enc.encode_bin(root_cbf, CTX_OFFSET["rqt_root_cbf"])
    if root_cbf:
        _enc_transform_tree_p(enc, sc, x0, y0, log2, 0, True, True)


def _dec_cu_p(dec, sc, x0, y0, log2):
    from ..codec.mv import amvp_candidates, merge_candidates

    size = 1 << log2
    skip = dec.decode_bin(_skip_ctx(sc, x0, y0))
    if skip:
        merge_i = _dec_merge_idx(dec, sc.max_merge)
        cands = merge_candidates(sc.mvfield, sc.order4, x0, y0, size,
                                 sc.max_merge, sc.num_ref, col=sc.col,
                                 ref_pocs=sc.ref_pocs, cur_poc=sc.cur_poc,
                                 pic_w=sc.w, pic_h=sc.h,
                                 log2_ctu=sc.log2_ctu)
        mv = np.array(cands[merge_i][:2], dtype=np.int32)
        _mark_inter_cu(sc, x0, y0, log2, mv, 1, 1, merge_i, 0, (0, 0),
                       cands[merge_i][2])
        return
    pred_mode = dec.decode_bin(CTX_OFFSET["pred_mode_flag"])
    if pred_mode == 1:  # intra CU in a P slice
        if log2 > 3:
            # the legacy intra-in-P recon pass only handles 8x8 CUs
            sc.fs.full_features = True
        _dec_cu(dec, sc, x0, y0, log2)
        s8 = 1 << (log2 - 3)
        y8, x8 = y0 // 8, x0 // 8
        sc.fs.inter_dir[y8 : y8 + s8, x8 : x8 + s8] = 0
        return
    part = _dec_part_mode_inter(dec, sc, log2)
    pus = _pu_geometry(part, size)
    if part != "2Nx2N":
        sc.fs.full_features = True
    any_merge = False
    for pi, (dx, dy, pw, ph) in enumerate(pus):
        px, py = x0 + dx, y0 + dy
        excl = None
        if pi == 1 and part in ("Nx2N", "nLx2N", "nRx2N"):
            excl = "A1"
        elif pi == 1 and part in ("2NxN", "2NxnU", "2NxnD"):
            excl = "B1"
        merge_f = dec.decode_bin(CTX_OFFSET["merge_flag"])
        merge_i = mvp_f = 0
        ref = 0
        mvd = np.zeros(2, dtype=np.int32)
        if merge_f:
            any_merge = True
            merge_i = _dec_merge_idx(dec, sc.max_merge)
            cands = merge_candidates(
                sc.mvfield, sc.order4, px, py, pw, sc.max_merge,
                sc.num_ref, col=sc.col, ref_pocs=sc.ref_pocs,
                cur_poc=sc.cur_poc, pic_w=sc.w, pic_h=sc.h,
                log2_ctu=sc.log2_ctu, pu_h=ph, excl=excl)
            mv = np.array(cands[merge_i][:2], dtype=np.int32)
            ref = cands[merge_i][2]
        else:
            ref = _dec_ref_idx(dec, sc.num_ref)
            mvd = np.array(_dec_mvd(dec), dtype=np.int32)
            mvp_f = dec.decode_bin(CTX_OFFSET["mvp_flag"])
            cands = amvp_candidates(
                sc.mvfield, sc.order4, px, py, pw, ref, sc.ref_pocs,
                sc.cur_poc, col=sc.col, pic_w=sc.w, pic_h=sc.h,
                log2_ctu=sc.log2_ctu, pu_h=ph)
            mv = mvd + np.array(cands[mvp_f], dtype=np.int32)
        if part == "2Nx2N":
            _mark_inter_cu(sc, x0, y0, log2, mv, 0, merge_f, merge_i,
                           mvp_f, mvd, ref)
        else:
            _mark_inter_pu(sc, x0, y0, log2, px, py, pw, ph, mv, ref,
                           pi == 0)
    root_cbf = 1
    if not (part == "2Nx2N" and any_merge):
        root_cbf = dec.decode_bin(CTX_OFFSET["rqt_root_cbf"])
    if root_cbf:
        intersplit = sc.sps.max_tu_depth_inter == 0 and part != "2Nx2N"
        _dec_transform_tree_p(dec, sc, x0, y0, log2, 0, True, True,
                              inter_split=intersplit)
    else:
        s4 = 1 << (log2 - 2)
        sc.fs.tu_log2[y0 // 4 : y0 // 4 + s4,
                      x0 // 4 : x0 // 4 + s4] = min(log2, 5)


def _dec_part_mode_inter(dec, sc, log2):
    """TDecSbac::parsePartSize inter branch: up to 2 ctx bins (3 at min
    CU when CU > 8x8), then the AMP refinement bin + bypass."""
    sps = sc.sps
    at_min = log2 == sps.log2_min_cu
    max_bits = 2 + (1 if at_min and log2 > 3 else 0)
    mode = 0
    for ui in range(max_bits):
        if dec.decode_bin(CTX_OFFSET["part_mode"] + ui):
            break
        mode += 1
    names = ("2Nx2N", "2NxN", "Nx2N", "NxN")
    part = names[mode]
    if sps.amp_enabled and not at_min:
        if part == "2NxN":
            if not dec.decode_bin(CTX_OFFSET["part_mode"] + 3):
                part = "2NxnD" if dec.decode_bin_ep() else "2NxnU"
        elif part == "Nx2N":
            if not dec.decode_bin(CTX_OFFSET["part_mode"] + 3):
                part = "nRx2N" if dec.decode_bin_ep() else "nLx2N"
    return part


def _pu_geometry(part: str, s: int):
    """[(dx, dy, w, h)] per PU, in PU decode order."""
    h = s // 2
    q = s // 4
    return {
        "2Nx2N": [(0, 0, s, s)],
        "2NxN": [(0, 0, s, h), (0, h, s, h)],
        "Nx2N": [(0, 0, h, s), (h, 0, h, s)],
        "NxN": [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)],
        "2NxnU": [(0, 0, s, q), (0, q, s, s - q)],
        "2NxnD": [(0, 0, s, s - q), (0, s - q, s, q)],
        "nLx2N": [(0, 0, q, s), (q, 0, s - q, s)],
        "nRx2N": [(0, 0, s - q, s), (s - q, 0, q, s)],
    }[part]


def _mark_inter_pu(sc, cu_x0, cu_y0, log2, px, py, pw, ph, mv, ref,
                   first_pu):
    """Store one rectangular PU: 4-granularity motion + the legacy 8-cell
    maps (first PU's values, for deblock/ColMotion compatibility)."""
    fs = sc.fs
    fs.mv4[py // 4 : (py + ph) // 4, px // 4 : (px + pw) // 4] = mv
    fs.ref4[py // 4 : (py + ph) // 4, px // 4 : (px + pw) // 4] = ref
    sc.mvfield.set_pu(px, py, pw, ph, mv, ref)
    if first_pu:
        s8 = 1 << (log2 - 3)
        y8, x8 = cu_y0 // 8, cu_x0 // 8
        fs.cu_log2[y8 : y8 + s8, x8 : x8 + s8] = log2
        sc.depth8[y8 : y8 + s8, x8 : x8 + s8] = sc.log2_ctu - log2
    # legacy 8-cell maps get each cell's top-left 4-cell motion
    for cy in range(py // 8, -(-(py + ph) // 8)):
        for cx in range(px // 8, -(-(px + pw) // 8)):
            fs.mv[cy, cx] = fs.mv4[cy * 2, cx * 2]
            fs.ref_idx[cy, cx] = fs.ref4[cy * 2, cx * 2]
            fs.inter_dir[cy, cx] = 1
            fs.skip[cy, cx] = 0
            fs.merge_flag[cy, cx] = 0


def _enc_transform_tree_p(enc, sc, x0, y0, log2, depth, parent_cb, parent_cr,
                          inter_split=False):
    """Exact inverse of _dec_transform_tree_p. inter_split: implicit
    depth-0 split for non-2Nx2N inter CUs when max_tu_depth_inter == 0
    (§7.4.9.8 interSplitFlag)."""
    sps = sc.sps
    fs = sc.fs
    explicit = False
    if inter_split and depth == 0:
        split = 1
    elif log2 > sps.log2_max_tu:
        split = 1
    elif log2 <= sps.log2_min_tu or depth >= sps.max_tu_depth_inter + (
            1 if inter_split else 0):
        split = 0
    else:
        # the grid path publishes its chosen leaf TU sizes in fs.tu_log2
        # (-1 = unset -> TU = CU); split while the leaf is smaller
        want = int(fs.tu_log2[y0 // 4, x0 // 4])
        split = 1 if 2 <= want < log2 else 0
        explicit = True
    if explicit:
        enc.encode_bin(split,
                       CTX_OFFSET["split_transform_flag"] + (5 - log2))
    cbf_y, cbf_cb, cbf_cr = _tu_cbfs(sc, x0, y0, log2)
    if log2 > 2:
        if parent_cb:
            enc.encode_bin(1 if cbf_cb else 0, CTX_OFFSET["qt_cbf"] + 5 + depth)
        if parent_cr:
            enc.encode_bin(1 if cbf_cr else 0, CTX_OFFSET["qt_cbf"] + 5 + depth)
    else:
        cbf_cb, cbf_cr = parent_cb, parent_cr
    if split:
        half = 1 << (log2 - 1)
        for sy in (0, half):
            for sx in (0, half):
                _enc_transform_tree_p(enc, sc, x0 + sx, y0 + sy, log2 - 1,
                                      depth + 1, cbf_cb, cbf_cr, inter_split)
        if log2 == 3 and (cbf_cb or cbf_cr):
            _enc_chroma_tu_p(enc, sc, x0, y0, 2, cbf_cb, cbf_cr)
        return
    s4 = 1 << (log2 - 2)
    fs.tu_log2[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = log2
    # inter leaf: cbf_luma inferred 1 at depth 0 with no chroma cbf
    if depth != 0 or cbf_cb or cbf_cr:
        enc.encode_bin(1 if cbf_y else 0,
                       CTX_OFFSET["qt_cbf"] + (1 if depth == 0 else 0))
    else:
        assert cbf_y, "rqt_root_cbf=1 requires residual at inferred leaf"
    _enc_transform_unit_p(enc, sc, x0, y0, log2, cbf_y, cbf_cb, cbf_cr)


def _enc_chroma_tu_p(enc, sc, x0, y0, clog2, cbf_cb, cbf_cr):
    """Chroma residual coded at the 8x8 parent of split 4x4 luma TUs
    (inverse of _dec_chroma_tu_p; own streams never use transform-skip)."""
    from ..utils.tables import SCAN_DIAG

    fs, pps = sc.fs, sc.pps
    cs = 1 << clog2
    cx, cy2 = x0 // 2, y0 // 2
    if cbf_cb or cbf_cr:
        _enc_dqp_if_pending(enc, sc)
    if cbf_cb:
        encode_residual(enc, fs.coeff_cb[cy2 : cy2 + cs, cx : cx + cs],
                        clog2, False, SCAN_DIAG, pps.sign_data_hiding)
    if cbf_cr:
        encode_residual(enc, fs.coeff_cr[cy2 : cy2 + cs, cx : cx + cs],
                        clog2, False, SCAN_DIAG, pps.sign_data_hiding)


def _dec_transform_tree_p(dec, sc, x0, y0, log2, depth, parent_cb,
                          parent_cr, inter_split=False):
    sps = sc.sps
    fs = sc.fs
    if inter_split and depth == 0:
        split = 1
    elif log2 > sps.log2_max_tu:
        split = 1
    elif log2 <= sps.log2_min_tu or depth >= sps.max_tu_depth_inter + (
            1 if inter_split else 0):
        split = 0
    else:
        split = dec.decode_bin(CTX_OFFSET["split_transform_flag"] + (5 - log2))
    cbf_cb = cbf_cr = False
    if log2 > 2:
        if parent_cb:
            cbf_cb = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"] + 5 + depth))
        if parent_cr:
            cbf_cr = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"] + 5 + depth))
    else:
        cbf_cb, cbf_cr = parent_cb, parent_cr
    if split:
        if depth > 0 or not inter_split:
            if log2 <= sps.log2_max_tu:
                fs.full_features = True  # real TU split below the CU
        half = 1 << (log2 - 1)
        for sy in (0, half):
            for sx in (0, half):
                _dec_transform_tree_p(dec, sc, x0 + sx, y0 + sy, log2 - 1,
                                      depth + 1, cbf_cb, cbf_cr,
                                      inter_split)
        if log2 == 3 and (cbf_cb or cbf_cr):
            _dec_chroma_tu_p(dec, sc, x0, y0, 2, cbf_cb, cbf_cr)
        return
    s4 = 1 << (log2 - 2)
    fs.tu_log2[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = log2
    if depth != 0 or cbf_cb or cbf_cr:
        cbf_y = bool(dec.decode_bin(CTX_OFFSET["qt_cbf"] + (1 if depth == 0 else 0)))
    else:
        cbf_y = True
    _dec_transform_unit_p(dec, sc, x0, y0, log2, cbf_y, cbf_cb, cbf_cr)


def _enc_transform_unit_p(enc, sc, x0, y0, log2, cbf_y, cbf_cb, cbf_cr):
    from ..utils.tables import SCAN_DIAG

    fs, pps = sc.fs, sc.pps
    s = 1 << log2
    if not (cbf_y or cbf_cb or cbf_cr):
        return
    _enc_dqp_if_pending(enc, sc)
    if cbf_y:
        encode_residual(enc, fs.coeff_y[y0 : y0 + s, x0 : x0 + s], log2,
                        True, SCAN_DIAG, pps.sign_data_hiding)
    if log2 > 2:
        clog2 = log2 - 1
        cs = 1 << clog2
        cx, cy2 = x0 // 2, y0 // 2
        if cbf_cb:
            encode_residual(enc, fs.coeff_cb[cy2 : cy2 + cs, cx : cx + cs],
                            clog2, False, SCAN_DIAG, pps.sign_data_hiding)
        if cbf_cr:
            encode_residual(enc, fs.coeff_cr[cy2 : cy2 + cs, cx : cx + cs],
                            clog2, False, SCAN_DIAG, pps.sign_data_hiding)


def _dec_transform_unit_p(dec, sc, x0, y0, log2, cbf_y, cbf_cb, cbf_cr):
    from ..utils.tables import SCAN_DIAG

    fs, pps = sc.fs, sc.pps
    s = 1 << log2
    if not (cbf_y or cbf_cb or cbf_cr):
        return
    _dec_dqp_if_pending(dec, sc)
    if cbf_y:
        if pps.transform_skip_enabled and log2 == 2 \
                and _dec_ts_flag(dec, False):
            fs.ts_y[y0 // 4, x0 // 4] = 1
            fs.full_features = True
        fs.coeff_y[y0 : y0 + s, x0 : x0 + s] = decode_residual(
            dec, log2, True, SCAN_DIAG, pps.sign_data_hiding)
    if log2 > 2:
        _dec_chroma_tu_p(dec, sc, x0, y0, log2 - 1, cbf_cb, cbf_cr)


def _dec_chroma_tu_p(dec, sc, x0, y0, clog2, cbf_cb, cbf_cr):
    from ..utils.tables import SCAN_DIAG

    fs, pps = sc.fs, sc.pps
    cs = 1 << clog2
    cx, cy2 = x0 // 2, y0 // 2
    if cbf_cb or cbf_cr:
        _dec_dqp_if_pending(dec, sc)
    ts_ok = pps.transform_skip_enabled and clog2 == 2
    if cbf_cb:
        if ts_ok and _dec_ts_flag(dec, True):
            fs.ts_cb[cy2 // 4, cx // 4] = 1
            fs.full_features = True
        fs.coeff_cb[cy2 : cy2 + cs, cx : cx + cs] = decode_residual(
            dec, clog2, False, SCAN_DIAG, pps.sign_data_hiding)
    if cbf_cr:
        if ts_ok and _dec_ts_flag(dec, True):
            fs.ts_cr[cy2 // 4, cx // 4] = 1
            fs.full_features = True
        fs.coeff_cr[cy2 : cy2 + cs, cx : cx + cs] = decode_residual(
            dec, clog2, False, SCAN_DIAG, pps.sign_data_hiding)


# --- B slices (two lists) ---------------------------------------------------

def _mark_inter_cu_b(sc, x0, y0, log2, inter_dir, mv0, ref0, mv1, ref1,
                     skip, merge_f, merge_i, mvp0, mvd0, mvp1, mvd1):
    fs = sc.fs
    s8 = 1 << (log2 - 3)
    y8, x8 = y0 // 8, x0 // 8
    sc.depth8[y8 : y8 + s8, x8 : x8 + s8] = sc.log2_ctu - log2
    fs.cu_log2[y8 : y8 + s8, x8 : x8 + s8] = log2
    fs.skip[y8 : y8 + s8, x8 : x8 + s8] = skip
    fs.merge_flag[y8 : y8 + s8, x8 : x8 + s8] = merge_f
    fs.merge_idx[y8 : y8 + s8, x8 : x8 + s8] = merge_i
    fs.inter_dir[y8 : y8 + s8, x8 : x8 + s8] = inter_dir
    fs.mv[y8 : y8 + s8, x8 : x8 + s8] = mv0
    fs.ref_idx[y8 : y8 + s8, x8 : x8 + s8] = max(ref0, 0)
    fs.mvp_flag[y8 : y8 + s8, x8 : x8 + s8] = mvp0
    fs.mvd[y8 : y8 + s8, x8 : x8 + s8] = mvd0
    fs.mv_l1[y8 : y8 + s8, x8 : x8 + s8] = mv1
    fs.ref_idx_l1[y8 : y8 + s8, x8 : x8 + s8] = max(ref1, 0)
    fs.mvp_flag_l1[y8 : y8 + s8, x8 : x8 + s8] = mvp1
    fs.mvd_l1[y8 : y8 + s8, x8 : x8 + s8] = mvd1
    s4 = 1 << (log2 - 2)
    y4, x4 = y0 // 4, x0 // 4
    fs.dir4[y4 : y4 + s4, x4 : x4 + s4] = inter_dir
    fs.mv4[y4 : y4 + s4, x4 : x4 + s4] = mv0
    fs.ref4[y4 : y4 + s4, x4 : x4 + s4] = max(ref0, 0)
    fs.mv4_l1[y4 : y4 + s4, x4 : x4 + s4] = mv1
    fs.ref4_l1[y4 : y4 + s4, x4 : x4 + s4] = max(ref1, 0)
    sc.mvfield_b.set_cu(x0, y0, 1 << log2, inter_dir, mv0, ref0, mv1, ref1)


def _mark_inter_pu_b(sc, cu_x0, cu_y0, log2, px, py, pw, ph, inter_dir,
                     mv0, ref0, mv1, ref1, first_pu):
    """One rectangular B PU: 4-granularity two-list motion + the legacy
    8-cell maps (each cell's top-left 4-cell motion)."""
    fs = sc.fs
    y4s, x4s = py // 4, px // 4
    sl = (slice(y4s, (py + ph) // 4), slice(x4s, (px + pw) // 4))
    fs.dir4[sl] = inter_dir
    fs.mv4[sl] = mv0
    fs.ref4[sl] = max(ref0, 0)
    fs.mv4_l1[sl] = mv1
    fs.ref4_l1[sl] = max(ref1, 0)
    sc.mvfield_b.set_pu(px, py, pw, ph, inter_dir, mv0, ref0, mv1, ref1)
    if first_pu:
        s8 = 1 << (log2 - 3)
        y8, x8 = cu_y0 // 8, cu_x0 // 8
        fs.cu_log2[y8 : y8 + s8, x8 : x8 + s8] = log2
        sc.depth8[y8 : y8 + s8, x8 : x8 + s8] = sc.log2_ctu - log2
    for cy in range(py // 8, -(-(py + ph) // 8)):
        for cx in range(px // 8, -(-(px + pw) // 8)):
            fs.inter_dir[cy, cx] = fs.dir4[cy * 2, cx * 2]
            fs.mv[cy, cx] = fs.mv4[cy * 2, cx * 2]
            fs.ref_idx[cy, cx] = fs.ref4[cy * 2, cx * 2]
            fs.mv_l1[cy, cx] = fs.mv4_l1[cy * 2, cx * 2]
            fs.ref_idx_l1[cy, cx] = fs.ref4_l1[cy * 2, cx * 2]
            fs.skip[cy, cx] = 0
            fs.merge_flag[cy, cx] = 0


def _enc_inter_dir(enc, inter_dir, depth):
    # TEncSbac::codeInterDir: first bin "is BI" ctx[depth]; else L0/L1
    # with ctx[4]
    enc.encode_bin(1 if inter_dir == 3 else 0,
                   CTX_OFFSET["inter_pred_idc"] + depth)
    if inter_dir != 3:
        enc.encode_bin(inter_dir - 1, CTX_OFFSET["inter_pred_idc"] + 4)


def _dec_inter_dir(dec, depth, small_pu: bool = False):
    # §9.3.3.7: 8x4/4x8 PUs (nPbW + nPbH == 12) cannot be bi-predicted —
    # only the L0/L1 bin (ctx 4) is coded
    if not small_pu and dec.decode_bin(CTX_OFFSET["inter_pred_idc"] + depth):
        return 3
    return 1 + dec.decode_bin(CTX_OFFSET["inter_pred_idc"] + 4)


def _enc_cu_b(enc, sc, x0, y0, log2):
    from ..codec.mv_b import merge_candidates_b

    fs = sc.fs
    y8, x8 = y0 // 8, x0 // 8
    skip = int(fs.skip[y8, x8])
    merge_f = int(fs.merge_flag[y8, x8])
    merge_i = int(fs.merge_idx[y8, x8])
    inter_dir = int(fs.inter_dir[y8, x8])
    mv0 = fs.mv[y8, x8].copy()
    mv1 = fs.mv_l1[y8, x8].copy()
    ref0 = int(fs.ref_idx[y8, x8]) if inter_dir & 1 else -1
    ref1 = int(fs.ref_idx_l1[y8, x8]) if inter_dir & 2 else -1

    enc.encode_bin(skip, _skip_ctx(sc, x0, y0))
    if skip:
        _enc_merge_idx(enc, merge_i, sc.max_merge)
        _mark_inter_cu_b(sc, x0, y0, log2, inter_dir, mv0, ref0, mv1, ref1,
                         1, 1, merge_i, 0, (0, 0), 0, (0, 0))
        return
    if inter_dir == 0:  # intra CU in a B slice
        enc.encode_bin(1, CTX_OFFSET["pred_mode_flag"])
        _enc_cu(enc, sc, x0, y0, log2)
        s8 = 1 << (log2 - 3)
        fs.inter_dir[y8 : y8 + s8, x8 : x8 + s8] = 0
        return
    enc.encode_bin(0, CTX_OFFSET["pred_mode_flag"])  # inter
    enc.encode_bin(1, CTX_OFFSET["part_mode"])       # 2Nx2N
    enc.encode_bin(merge_f, CTX_OFFSET["merge_flag"])
    mvp0 = mvp1 = 0
    mvd0 = np.zeros(2, np.int32)
    mvd1 = np.zeros(2, np.int32)
    if merge_f:
        _enc_merge_idx(enc, merge_i, sc.max_merge)
    else:
        depth = sc.log2_ctu - log2
        _enc_inter_dir(enc, inter_dir, depth)
        mvp0 = int(fs.mvp_flag[y8, x8])
        mvp1 = int(fs.mvp_flag_l1[y8, x8])
        mvd0 = fs.mvd[y8, x8].copy()
        mvd1 = fs.mvd_l1[y8, x8].copy()
        if inter_dir & 1:
            _enc_ref_idx(enc, ref0, sc.num_ref)
            _enc_mvd(enc, mvd0)
            enc.encode_bin(mvp0, CTX_OFFSET["mvp_flag"])
        if inter_dir & 2:
            _enc_ref_idx(enc, ref1, sc.num_ref_l1)
            _enc_mvd(enc, mvd1)
            enc.encode_bin(mvp1, CTX_OFFSET["mvp_flag"])
    _mark_inter_cu_b(sc, x0, y0, log2, inter_dir, mv0, ref0, mv1, ref1,
                     0, merge_f, merge_i, mvp0, mvd0, mvp1, mvd1)
    cbf_y, cbf_cb, cbf_cr = _tu_cbfs(sc, x0, y0, log2)
    root_cbf = 1 if (cbf_y or cbf_cb or cbf_cr) else 0
    if not merge_f:
        enc.encode_bin(root_cbf, CTX_OFFSET["rqt_root_cbf"])
    if root_cbf:
        _enc_transform_tree_p(enc, sc, x0, y0, log2, 0, True, True)


def _dec_cu_b(dec, sc, x0, y0, log2):
    from ..codec.mv_b import amvp_candidates_b, merge_candidates_b

    size = 1 << log2
    list_pocs = [sc.ref_pocs, sc.l1_pocs]
    tmvp = dict(col=sc.col_b, cur_poc=sc.cur_poc, pic_w=sc.w, pic_h=sc.h,
                log2_ctu=sc.log2_ctu, col_from_l0=sc.col_from_l0,
                check_ldc=sc.check_ldc)
    skip = dec.decode_bin(_skip_ctx(sc, x0, y0))
    if skip:
        merge_i = _dec_merge_idx(dec, sc.max_merge)
        cands = merge_candidates_b(sc.mvfield_b, sc.order, x0, y0, size,
                                   sc.max_merge, sc.num_ref, sc.num_ref_l1,
                                   sc.ref_pocs, sc.l1_pocs, **tmvp)
        c = cands[merge_i]
        _mark_inter_cu_b(sc, x0, y0, log2, c[0], (c[1], c[2]), c[3],
                         (c[4], c[5]), c[6], 1, 1, merge_i, 0, (0, 0),
                         0, (0, 0))
        return
    pred_mode = dec.decode_bin(CTX_OFFSET["pred_mode_flag"])
    if pred_mode == 1:  # intra CU in a B slice
        if log2 > 3:
            sc.fs.full_features = True
        _dec_cu(dec, sc, x0, y0, log2)
        s8 = 1 << (log2 - 3)
        y8, x8 = y0 // 8, x0 // 8
        sc.fs.inter_dir[y8 : y8 + s8, x8 : x8 + s8] = 0
        s4 = 1 << (log2 - 2)
        sc.fs.dir4[y0 // 4 : y0 // 4 + s4, x0 // 4 : x0 // 4 + s4] = 0
        return
    part = _dec_part_mode_inter(dec, sc, log2)
    pus = _pu_geometry(part, size)
    if part != "2Nx2N":
        sc.fs.full_features = True
    any_merge = False
    for pi, (dx, dy, pw, ph) in enumerate(pus):
        px, py = x0 + dx, y0 + dy
        excl = None
        if pi == 1 and part in ("Nx2N", "nLx2N", "nRx2N"):
            excl = "A1"
        elif pi == 1 and part in ("2NxN", "2NxnU", "2NxnD"):
            excl = "B1"
        merge_f = dec.decode_bin(CTX_OFFSET["merge_flag"])
        merge_i = mvp0 = mvp1 = 0
        mvd0 = np.zeros(2, np.int32)
        mvd1 = np.zeros(2, np.int32)
        if merge_f:
            any_merge = True
            merge_i = _dec_merge_idx(dec, sc.max_merge)
            cands = merge_candidates_b(
                sc.mvfield_b, sc.order, px, py, size, sc.max_merge,
                sc.num_ref, sc.num_ref_l1, sc.ref_pocs, sc.l1_pocs,
                pu_w=pw, pu_h=ph, excl=excl, **tmvp)
            c = cands[merge_i]
            inter_dir = c[0]
            mv0, ref0 = np.array(c[1:3], np.int32), c[3]
            mv1, ref1 = np.array(c[4:6], np.int32), c[6]
            # 8x4/4x8 PUs: a BI merge candidate degrades to L0 (§8.5.3.2.3)
            if pw + ph == 12 and inter_dir == 3:
                inter_dir, ref1 = 1, -1
                mv1 = np.zeros(2, np.int32)
        else:
            depth = sc.log2_ctu - log2
            inter_dir = _dec_inter_dir(dec, depth, small_pu=(pw + ph == 12))
            mv0 = np.zeros(2, np.int32)
            mv1 = np.zeros(2, np.int32)
            ref0 = ref1 = -1
            if inter_dir & 1:
                ref0 = _dec_ref_idx(dec, sc.num_ref)
                mvd0 = np.array(_dec_mvd(dec), np.int32)
                mvp0 = dec.decode_bin(CTX_OFFSET["mvp_flag"])
                cands = amvp_candidates_b(sc.mvfield_b, sc.order, px, py,
                                          size, 0, ref0, list_pocs,
                                          pu_w=pw, pu_h=ph, **tmvp)
                mv0 = mvd0 + np.array(cands[mvp0], np.int32)
            if inter_dir & 2:
                ref1 = _dec_ref_idx(dec, sc.num_ref_l1)
                if not (sc.mvd_l1_zero and inter_dir == 3):
                    mvd1 = np.array(_dec_mvd(dec), np.int32)
                mvp1 = dec.decode_bin(CTX_OFFSET["mvp_flag"])
                cands = amvp_candidates_b(sc.mvfield_b, sc.order, px, py,
                                          size, 1, ref1, list_pocs,
                                          pu_w=pw, pu_h=ph, **tmvp)
                mv1 = mvd1 + np.array(cands[mvp1], np.int32)
        if part == "2Nx2N":
            _mark_inter_cu_b(sc, x0, y0, log2, inter_dir, mv0, ref0, mv1,
                             ref1, 0, merge_f, merge_i, mvp0, mvd0, mvp1,
                             mvd1)
        else:
            _mark_inter_pu_b(sc, x0, y0, log2, px, py, pw, ph, inter_dir,
                             mv0, ref0, mv1, ref1, pi == 0)
    root_cbf = 1
    if not (part == "2Nx2N" and any_merge):
        root_cbf = dec.decode_bin(CTX_OFFSET["rqt_root_cbf"])
    if root_cbf:
        intersplit = sc.sps.max_tu_depth_inter == 0 and part != "2Nx2N"
        _dec_transform_tree_p(dec, sc, x0, y0, log2, 0, True, True,
                              inter_split=intersplit)
    else:
        s4 = 1 << (log2 - 2)
        sc.fs.tu_log2[y0 // 4 : y0 // 4 + s4,
                      x0 // 4 : x0 // 4 + s4] = min(log2, 5)


# --- WPP (entropy_coding_sync): per-CTU-row substreams ----------------------

def encode_slice_data_wpp(fs: FrameSyntax, sps: SeqParams, pps: PicParams,
                          init_row: int, qp: int, slice_type: int = I_SLICE,
                          max_merge: int = 5, num_ref: int = 1,
                          ref_deltas=None, num_ref_l1: int = 0,
                          l1_deltas=None, slice_qp: int = 26) -> list[bytes]:
    """Wavefront slice data: one CABAC substream per CTU row, contexts
    inherited from the snapshot taken after the second CTU of the row
    above (§9.3.1 sync process; TEncSlice substream loop /
    TEncSbac loadContexts — SURVEY.md §2.5 "Wavefront"). Returns the list
    of byte-aligned substream payloads (entry points = their sizes)."""
    from .bitio import BitWriter
    from .cabac import CabacEncoder, ContextSet

    sc = _SliceCoder(fs, sps, pps, slice_type, max_merge, num_ref,
                     ref_deltas)
    if num_ref_l1:
        sc.num_ref_l1 = num_ref_l1
        sc.l1_pocs = [-d for d in l1_deltas]
    use_dqp = pps.cu_qp_delta_enabled
    if use_dqp:
        assert pps.diff_cu_qp_delta_depth == 0, "QG = CTU only"
        sc.slice_qp = slice_qp
    subs = []
    saved = None
    sync_x = min(1, sc.wctu - 1)
    for cy in range(sc.hctu):
        ctx = ContextSet(init_row, qp)
        if cy > 0 and saved is not None:
            ctx.restore(saved)
        if use_dqp:
            sc.last_qp = slice_qp  # qPY_PREV resets per CTB row (§8.6.1)
        cab = CabacEncoder(ctx)
        for cx in range(sc.wctu):
            if use_dqp:
                sc.dqp_pending = True
                sc.qg_qp = (int(fs.qp_ctu[cy, cx])
                            if getattr(fs, "qp_ctu", None) is not None
                            else slice_qp)
            if fs.sao is not None:
                _enc_sao_ctu(cab, fs.sao, cx, cy, cx > 0, cy > 0)
            _enc_quadtree(cab, sc, cx << sc.log2_ctu, cy << sc.log2_ctu,
                          sc.log2_ctu, 0)
            if cx == sync_x:
                saved = ctx.snapshot()
            last = (cy == sc.hctu - 1) and (cx == sc.wctu - 1)
            cab.encode_bin_trm(1 if last else 0)
            if cx == sc.wctu - 1 and not last:
                cab.encode_bin_trm(1)  # end_of_subset_one_bit
        cab.finish()
        w = BitWriter()
        w.write_bytes(bytes(cab.out))
        val, nbits = cab.pending_bits
        w.write(val, nbits)
        w.rbsp_trailing_bits()  # byte_alignment()
        subs.append(w.getvalue())
    return subs


def decode_slice_data_wpp(payload: bytes, entry_points: list[int],
                          sps: SeqParams, pps: PicParams, width: int,
                          height: int, init_row: int, qp: int,
                          slice_type: int = I_SLICE, max_merge: int = 5,
                          sao_luma: bool = False, sao_chroma: bool = False,
                          num_ref: int = 1, ref_deltas=None,
                          num_ref_l1: int = 0, l1_deltas=None,
                          col=None, col_b=None, col_from_l0: bool = True,
                          check_ldc: bool = False,
                          mvd_l1_zero: bool = False,
                          slice_qp: int = 26) -> FrameSyntax:
    from .cabac import CabacDecoder, ContextSet

    fs = FrameSyntax(width, height)
    sc = _SliceCoder(fs, sps, pps, slice_type, max_merge, num_ref,
                     ref_deltas)
    sc.col = col
    sc.col_b = col_b
    sc.col_from_l0 = col_from_l0
    sc.check_ldc = check_ldc
    sc.mvd_l1_zero = mvd_l1_zero
    if num_ref_l1:
        sc.num_ref_l1 = num_ref_l1
        sc.l1_pocs = [-d for d in l1_deltas]
    if (sao_luma or sao_chroma) and fs.sao is None:
        from ..codec.sao_enc import SaoPicParams

        fs.sao = SaoPicParams(sc.hctu, sc.wctu, luma_on=sao_luma,
                              chroma_on=sao_chroma)
    use_dqp = pps.cu_qp_delta_enabled
    if use_dqp:
        assert pps.diff_cu_qp_delta_depth == 0, "QG = CTU only"
        sc.slice_qp = sc.last_qp = slice_qp
        fs.qp_ctu = np.full((sc.hctu, sc.wctu), slice_qp, np.int32)
        fs.qp8 = np.full((fs.height // 8, fs.width // 8), slice_qp,
                         np.int32)
    # split substreams by entry points
    offs = [0]
    for e in entry_points:
        offs.append(offs[-1] + e)
    offs.append(len(payload))
    saved = None
    sync_x = min(1, sc.wctu - 1)
    for cy in range(sc.hctu):
        sub = payload[offs[cy] : offs[cy + 1]]
        if use_dqp:
            sc.last_qp = slice_qp  # qPY_PREV resets per CTB row (§8.6.1)
        ctx = ContextSet(init_row, qp)
        if cy > 0 and saved is not None:
            ctx.restore(saved)
        dec = CabacDecoder(sub, ctx)
        for cx in range(sc.wctu):
            if use_dqp:
                sc.dqp_pending = True
            if fs.sao is not None:
                _dec_sao_ctu(dec, fs.sao, cx, cy, cx > 0, cy > 0)
            _dec_quadtree(dec, sc, cx << sc.log2_ctu, cy << sc.log2_ctu,
                          sc.log2_ctu, 0)
            if use_dqp:
                fs.qp_ctu[cy, cx] = sc.last_qp
            if cx == sync_x:
                saved = ctx.snapshot()
            dec.decode_bin_trm()
            if cx == sc.wctu - 1 and cx != sc.wctu * sc.hctu:
                pass  # end_of_subset bin is consumed implicitly: the
                # substream boundary resets the engine; nothing to read
    return fs
