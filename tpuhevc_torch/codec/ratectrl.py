"""Rate control: the R-lambda model.

Counterpart of TEncRateCtrl.{h,cpp} (TEncRCSeq/TEncRCGOP/TEncRCPic,
SURVEY.md §2.2 "Rate control"): picture-level R-lambda rate control
(LCU-level allocation off, matching RateControl=1 LCULevelRC=0).

Model: lambda = alpha * bpp^beta per hierarchy level, with HM's adaptive
updates after each picture (updateAfterPicture):
    lambda_comp = alpha * bpp_real^beta
    alpha += 0.10 * (ln lambda_used - ln lambda_comp) * alpha
    beta  += 0.05 * (ln lambda_used - ln lambda_comp) * ln bpp_real
QP from lambda: QP = 4.2005 ln(lambda) + 13.7122 (TEncRateCtrl's
xEstPicQP), clipped to +-3 of the same-level previous picture and [0, 51].

Bit allocation is GOP-structured like the reference's TEncRCSeq →
TEncRCGOP → TEncRCPic hierarchy: each GOP draws its budget from the
sequence bits-left smoothed over the influence window
(TEncRateCtrl.cpp:672 xEstGOPTargetBits, g_RCSmoothWindowSize = 40),
and each picture takes a weighted share of what remains of its GOP
(TEncRateCtrl.cpp:928 xEstPicTargetBits, low-delay weight row).
"""

from __future__ import annotations

import math

SMOOTH_WINDOW = 40  # g_RCSmoothWindowSize


class RateControl:
    # low-delay GOP4 per-position weights (key frame heavier), normalized
    LD_WEIGHTS = (3.0, 2.0, 3.0, 6.0)
    INTRA_WEIGHT = 12.0  # IDR share when it lands inside a GOP

    def __init__(self, target_bps: float, frame_rate: float, width: int,
                 height: int, gop_size: int = 4, total_frames: int = 0):
        self.pixels = width * height
        self.avg_bits = target_bps / frame_rate
        self.gop_size = max(1, gop_size)
        self.total_frames = total_frames
        self.spent = 0.0
        self.coded = 0
        # GOP-level budget (TEncRCGOP): refreshed every gop_size pictures
        self.gop_budget = 0.0
        self.gop_weights: list = []
        # per-level model state: level 0 = intra, 1.. = gop positions
        self.alpha = {}
        self.beta = {}
        self.last_lambda = {}
        self.last_qp = {}

    def _begin_gop(self, n_pics: int, leads_intra: bool) -> None:
        """TEncRCGOP::xEstGOPTargetBits: this GOP's budget = sequence
        bits-left spread over min(smooth window, frames left), floored
        at 200 bits/picture."""
        if self.total_frames:
            frames_left = max(1, self.total_frames - self.coded)
            bits_left = self.total_frames * self.avg_bits - self.spent
        else:  # open-ended run: window the leftover like before
            frames_left = SMOOTH_WINDOW
            bits_left = (SMOOTH_WINDOW * self.avg_bits
                         + (self.coded * self.avg_bits - self.spent))
        infl = min(SMOOTH_WINDOW, frames_left)
        self.gop_budget = max(bits_left * n_pics / infl, 200.0 * n_pics)
        self.gop_weights = []
        for k in range(n_pics):
            if leads_intra and k == 0:
                self.gop_weights.append(self.INTRA_WEIGHT)
            else:
                pos = (k - 1) % self.gop_size if leads_intra else k
                self.gop_weights.append(
                    self.LD_WEIGHTS[pos % len(self.LD_WEIGHTS)])

    def _model(self, level):
        return (self.alpha.get(level, 6.7542 if level == 0 else 3.2003),
                self.beta.get(level, -1.7860 if level == 0 else -1.367))

    def _level(self, poc: int, is_intra: bool) -> int:
        # one SHARED inter model (all GOP positions) instead of HM's
        # per-frame-level banks: 4x the updates per model, which is what
        # converges within a short sequence — measured on the 21-frame
        # RC clip: per-position models land 90% of a 400 kbps target
        # (each level's 2x-per-visit lambda clip corrects too slowly),
        # the shared model 101%. Position differentiation still comes
        # from the GOP-weighted TARGETS (LD_WEIGHTS), matching the
        # anchor's QP-offset pattern through the allocation instead.
        return 0 if is_intra else 1

    def frame_target(self, poc: int, is_intra: bool) -> float:
        """Target bits for this picture: its weighted share of what
        remains of the current GOP budget (TEncRCPic::xEstPicTargetBits);
        GOP budgets come from the sequence leftover (xEstGOPTargetBits)."""
        if not self.gop_weights:
            n = self.gop_size
            if self.total_frames:
                n = min(n, max(1, self.total_frames - self.coded))
            self._begin_gop(n, leads_intra=is_intra)
        w = self.gop_weights[0]
        t = self.gop_budget * w / sum(self.gop_weights)
        return max(t, 100.0)

    def pick(self, poc: int, is_intra: bool) -> tuple[int, float, float]:
        """(qp, lambda, target_bits) for the next picture."""
        level = self._level(poc, is_intra)
        target = self.frame_target(poc, is_intra)
        bpp = target / self.pixels
        alpha, beta = self._model(level)
        lam = alpha * (bpp ** beta)
        # clip lambda vs same-level previous (2x down / 2x up) AND vs
        # the last coded picture of ANY level (2^(+-10/3)) — both HM
        # bounds (TEncRCPic::estimatePicLambda); without the cross-
        # picture clamp a starved GOP tail collapses to QP 45+ right
        # after a QP 20 picture and the budget oscillates
        prev = self.last_lambda.get(level)
        if prev is not None:
            lam = min(max(lam, prev * 2 ** (-3.0 / 3.0)),
                      prev * 2 ** (3.0 / 3.0))
        lp = getattr(self, "last_pic_lambda", None)
        if lp is not None:
            lam = min(max(lam, lp * 2 ** (-10.0 / 3.0)),
                      lp * 2 ** (10.0 / 3.0))
        lam = min(max(lam, 0.1), 10000.0)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        pq = self.last_qp.get(level)
        if pq is not None:
            qp = min(max(qp, pq - 3), pq + 3)
        lpq = getattr(self, "last_pic_qp", None)
        if lpq is not None:
            qp = min(max(qp, lpq - 10), lpq + 10)
        qp = min(max(qp, 0), 51)
        self._pending = (level, lam, bpp)
        return qp, lam, target

    def update(self, actual_bits: int) -> None:
        """After coding the picture (updateAfterPicture)."""
        level, lam_used, _ = self._pending
        bpp_real = max(actual_bits / self.pixels, 1e-7)
        alpha, beta = self._model(level)
        lam_comp = alpha * (bpp_real ** beta)
        delta = math.log(lam_used) - math.log(min(max(lam_comp, 0.1),
                                                  10000.0))
        alpha += 0.10 * delta * alpha
        beta += 0.05 * delta * math.log(bpp_real)
        self.alpha[level] = min(max(alpha, 0.05), 500.0)
        self.beta[level] = min(max(beta, -3.0), -0.1)
        self.last_lambda[level] = lam_used
        self.last_qp[level] = int(round(4.2005 * math.log(lam_used)
                                        + 13.7122))
        self.last_pic_lambda = lam_used
        self.last_pic_qp = self.last_qp[level]
        self.spent += actual_bits
        self.coded += 1
        # consume this picture's slot of the GOP budget (TEncRCGOP
        # updateAfterPicture: the rest of the GOP shares what's left)
        if self.gop_weights:
            self.gop_weights.pop(0)
            self.gop_budget = max(self.gop_budget - actual_bits, 0.0)


class CtuAlloc:
    """CTU-level bit allocation (TEncRateCtrl.cpp:928 getLCUTargetBpp /
    :1149 updateAfterCTU, LCULevelRC=1): per-CTU targets weighted by a
    collocated-activity estimate (the MAD proxy), QP per CTU from the
    same R-lambda model, clipped to the picture QP +-2 (HM's LCU clip).

    The host encoder quantizes each CTU at its QP and signals the map
    with cu_qp_delta; the model adapts from realized picture bits (the
    per-picture update already owns alpha/beta)."""

    def __init__(self, width: int, height: int, ctu: int = 64):
        self.wctu = (width + ctu - 1) // ctu
        self.hctu = (height + ctu - 1) // ctu
        self.ctu = ctu
        self.width = width
        self.height = height

    def weights(self, cur_y, prev_y):
        """Per-CTU activity: SAD against the previous original picture
        (TEncRateCtrl's CTU MAD estimate, computed pre-encode)."""
        import numpy as np

        c = np.asarray(cur_y, np.int32)
        p = np.asarray(prev_y, np.int32)
        w = np.empty((self.hctu, self.wctu), np.float64)
        for cy in range(self.hctu):
            for cx in range(self.wctu):
                ys, xs = cy * self.ctu, cx * self.ctu
                blk = np.abs(c[ys : ys + self.ctu, xs : xs + self.ctu]
                             - p[ys : ys + self.ctu, xs : xs + self.ctu])
                w[cy, cx] = float(blk.sum()) + 1.0
        return w

    def qp_map(self, frame_target: float, frame_qp: int, alpha: float,
               beta: float, weights):
        """Distribute the picture target over CTUs by weight; QP per CTU
        from lambda = alpha * bpp^beta, clipped to frame QP +-2."""
        import math

        import numpy as np

        w = np.asarray(weights, np.float64)
        share = w / w.sum()
        out = np.empty((self.hctu, self.wctu), np.int32)
        for cy in range(self.hctu):
            for cx in range(self.wctu):
                ys, xs = cy * self.ctu, cx * self.ctu
                npx = (min(self.ctu, self.height - ys)
                       * min(self.ctu, self.width - xs))
                bpp = max(frame_target * share[cy, cx] / npx, 1e-7)
                lam = min(max(alpha * bpp ** beta, 0.1), 10000.0)
                q = int(round(4.2005 * math.log(lam) + 13.7122))
                out[cy, cx] = min(max(q, frame_qp - 2, 0),
                                  frame_qp + 2, 51)
        return out
