"""Weighted prediction: parameter estimation, selection, and apply math.

Counterpart of the reference's WeightPredAnalysis.cpp (DC/AC estimation:
xCalcACDCParamSlice at WeightPredAnalysis.cpp:246, per-ref weight/offset
fit + range clamp: xUpdatingWPParameters at :398, the per-picture SAD
select: xSelectWP at :597) and TComWeightPrediction.cpp (weightUnidir
:52 / weightBidir :46 on 14-bit intermediates, parameter folding:
getWpScaling at :246).

Design notes (TPU-first): the normative apply is a per-reference affine
on the interpolated 14-bit intermediates.  The grid path folds it into
the MC phase-plane *final rounding* (one fused elementwise op over the
(R, phase, H, W) plane stack — zero extra HBM traffic), and weights the
full-pel reference copies used for SAD-based motion search with the
exactly-rounded full-pel special case (w*r + (1<<(d-1)) >> d) + o, which
is what xCalcSADvalueWPOptionalClip uses.  Host-side estimation needs
only original pictures (HM stores each picture's DC/AC computed on its
*original* samples — TComSlice::setWpAcDcParam), so nothing is fetched
from the device for it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class WpParams:
    """Explicit WP parameters of one slice (one prediction list entry per
    reference index; components ordered Y, Cb, Cr).

    weight/offset hold the *reconstruction-scale* values (iWeight /
    iOffset of the reference); flags mark coded presence. Non-present
    components carry the identity (w = 1 << denom, o = 0), which the
    apply formula reduces to default rounding bit-exactly."""

    denom_y: int = 6
    denom_c: int = 6
    # per ref: [flag_y, flag_c], [wY,wCb,wCr], [oY,oCb,oCr]
    flags: list = field(default_factory=list)    # (nref, 2) int
    weights: list = field(default_factory=list)  # (nref, 3) int
    offsets: list = field(default_factory=list)  # (nref, 3) int

    def any_present(self) -> bool:
        return any(f[0] or f[1] for f in self.flags)

    def identity(self, nref: int) -> "WpParams":
        self.flags = [[0, 0] for _ in range(nref)]
        self.weights = [[1 << self.denom_y, 1 << self.denom_c,
                         1 << self.denom_c] for _ in range(nref)]
        self.offsets = [[0, 0, 0] for _ in range(nref)]
        return self


def calc_acdc(y: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Per-component (DC, AC) of one picture's original samples
    (xCalcACDCParamSlice, WeightPredAnalysis.cpp:246): DC is the
    rounded mean, AC the L1 deviation from it."""
    out = []
    for p in (y, u, v):
        p = np.asarray(p, np.int64)
        n = p.size
        dc = (int(p.sum()) + (n >> 1)) // n
        ac = int(np.abs(p - dc).sum())
        out.append((dc, ac))
    return out


def estimate_wp(cur_acdc, ref_acdcs, bit_depth: int = 8,
                num_ref_l0: int = 1):
    """Fit per-reference explicit weights from DC/AC statistics
    (xUpdatingWPParameters, WeightPredAnalysis.cpp:398): weight =
    AC ratio at log2-denom scale, offset = DC residue; denom starts at
    6 (7 when >3 references) and decrements until every delta-weight
    fits the +-range window."""
    denom = 7 if num_ref_l0 > 3 else 6
    rng = 128
    while True:
        ok = True
        params = []
        for ref_acdc in ref_acdcs:
            ws, offs = [], []
            for comp in range(3):
                cur_dc, cur_ac = cur_acdc[comp]
                ref_dc, ref_ac = ref_acdc[comp]
                real_denom = denom + (bit_depth - 8)
                real_off = 1 << (real_denom - 1)
                dw = 1.0 if ref_ac == 0 else min(max(cur_ac / ref_ac,
                                                     -16.0), 15.0)
                w = int(0.5 + dw * (1 << denom))
                o = int((cur_dc << denom) - w * ref_dc
                        + real_off) >> real_denom
                if comp > 0:  # chroma offset range limitation
                    pred = rng - ((rng * w) >> denom)
                    d = min(max(o - pred, -4 * rng), 4 * rng - 1)
                    o = min(max(d + pred, -rng), rng - 1)
                else:
                    o = min(max(o, -rng), rng - 1)
                if not (-rng <= w - (1 << denom) < rng):
                    ok = False
                ws.append(w)
                offs.append(o)
            params.append((ws, offs))
        if ok:
            break
        denom -= 1
    wp = WpParams(denom_y=denom, denom_c=denom)
    for ws, offs in params:
        wp.flags.append([1, 1])
        wp.weights.append(ws)
        wp.offsets.append(offs)
    return wp


def _sad_wp(org, ref, denom: int, w: int, o: int, bit_depth: int) -> int:
    """xCalcSADvalueWP (WeightPredAnalysis.cpp:647): SAD between
    org<<denom and w*ref + (o << (denom + bd - 8)), unclipped."""
    real_off = o << (denom + bit_depth - 8)
    return int(np.abs((np.asarray(org, np.int64) << denom)
                      - (np.asarray(ref, np.int64) * w + real_off)).sum())


def select_wp(wp: WpParams, cur_yuv, ref_yuvs, bit_depth: int = 8,
              threshold: float = 0.99) -> WpParams:
    """Per-reference keep/drop by combined-component SAD ratio
    (xSelectWP, WeightPredAnalysis.cpp:597; WP kept when
    SAD_wp < 0.99 * SAD_default). ref_yuvs are the reference
    reconstructions (HM uses getPicYuvRec)."""
    denom = wp.denom_y
    dflt = 1 << denom
    for r, ref in enumerate(ref_yuvs):
        sad_wp = sad_no = 0
        for comp in range(3):
            sad_wp += _sad_wp(cur_yuv[comp], ref[comp], denom,
                              wp.weights[r][comp], wp.offsets[r][comp],
                              bit_depth)
            sad_no += _sad_wp(cur_yuv[comp], ref[comp], denom, dflt, 0,
                              bit_depth)
        ratio = (sad_wp / sad_no) if sad_no > 0 else float("inf")
        if ratio >= threshold:
            wp.flags[r] = [0, 0]
            wp.weights[r] = [dflt, dflt, dflt]
            wp.offsets[r] = [0, 0, 0]
    return wp


def analyse_slice_wp(cur_yuv, ref_orig_yuvs, ref_recon_yuvs=None,
                     bit_depth: int = 8) -> WpParams:
    """Full per-slice WP analysis for a P slice: DC/AC fit on originals,
    then the SAD select against the reference reconstructions (falls
    back to the originals when recons are not resident host-side — an
    encoder-choice approximation, never a conformance issue)."""
    cur = calc_acdc(*cur_yuv)
    refs = [calc_acdc(*r) for r in ref_orig_yuvs]
    wp = estimate_wp(cur, refs, bit_depth, num_ref_l0=len(ref_orig_yuvs))
    return select_wp(wp, cur_yuv, ref_recon_yuvs or ref_orig_yuvs,
                     bit_depth)


# --- normative apply (np reference forms; §8.5.3.3.4.3) -----------------

def weight_uni_np(p14: np.ndarray, w: int, o: int, denom: int,
                  bit_depth: int = 8) -> np.ndarray:
    """Explicit uni-pred weighting of the unsigned 14-bit MC intermediate
    (weightUnidir, TComWeightPrediction.cpp:52; our p14 = HM Pel +
    IF_INTERNAL_OFFS). Identity weights reduce to the default rounding
    exactly (same power-of-two multiply/shift)."""
    shift = denom + max(2, 14 - bit_depth)
    rnd = 1 << (shift - 1) if shift > 0 else 0
    off = o << (bit_depth - 8)
    maxv = (1 << bit_depth) - 1
    return np.clip(((np.asarray(p14, np.int64) * w + rnd) >> shift) + off,
                   0, maxv).astype(np.int32)


def weight_bi_np(p0_14: np.ndarray, p1_14: np.ndarray, w0: int, o0: int,
                 w1: int, o1: int, denom: int,
                 bit_depth: int = 8) -> np.ndarray:
    """Explicit bi-pred weighting (weightBidir,
    TComWeightPrediction.cpp:46): shift = denom + 1 + shiftNum, offset
    = (o0 + o1) at recon scale folded in before the shift."""
    shift = denom + 1 + max(2, 14 - bit_depth)
    rnd = 1 << (shift - 1)
    off = (o0 + o1) << (bit_depth - 8)
    maxv = (1 << bit_depth) - 1
    acc = (np.asarray(p0_14, np.int64) * w0
           + np.asarray(p1_14, np.int64) * w1
           + rnd + (off << (shift - 1))) >> shift
    return np.clip(acc, 0, maxv).astype(np.int32)


def weight_fullpel_np(r: np.ndarray, w: int, o: int, denom: int,
                      bit_depth: int = 8) -> np.ndarray:
    """Full-pel weighted reference (the clipped SAD form,
    xCalcSADvalueWPOptionalClip): equals weight_uni_np on the p14 =
    r << 6 embedding. Used to weight ME search references."""
    rnd = 1 << (denom - 1) if denom > 0 else 0
    maxv = (1 << bit_depth) - 1
    off = o  # recon scale already
    return np.clip(((np.asarray(r, np.int64) * w + rnd) >> denom) + off,
                   0, maxv).astype(np.int32)
