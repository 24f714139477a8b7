"""Quadtree intra picture encode: the decision on the device, the coding
walk on the host.

Twin of `tpuhevc/codec/intra_qt.py:770-836` (`encode_frame_intra_qt`) on
its device branch: pad the picture to the coded size, decide the maps
with the port's `decide_intra_qt`, bind them (`_apply_maps`) and run
tpuhevc's closed-loop coding walk (`_walk`, native or Python as tpuhevc
picks); with `intra_two_pass`, decide again from the pass-1 recon and
walk again. `_apply_maps` and `_walk` are imported unchanged.
"""

from __future__ import annotations

import functools

import numpy as np

from tpuhevc.codec.intra_qt import _apply_maps, _walk
from tpuhevc.codec.params import EncoderConfig, i_frame_lambda
from tpuhevc.codec.recon import _pad_to
from tpuhevc.entropy.syntax import FrameSyntax

from .intra_decide import decide_intra_qt


def encode_frame_intra_qt(orig_y, orig_u, orig_v, cfg: EncoderConfig,
                          device="cuda"):
    """Quadtree all-intra encode of one picture -> (FrameSyntax,
    (y, u, v)), the contract of `tpuhevc.codec.recon.encode_frame_intra`."""
    sps, qp = cfg.sps, cfg.qp
    w, h = sps.coded_width, sps.coded_height
    oy = _pad_to(orig_y, h, w)
    ou = _pad_to(orig_u, h // 2, w // 2)
    ov = _pad_to(orig_v, h // 2, w // 2)
    use_nxn = cfg.intra_nxn
    if use_nxn is None:
        use_nxn = cfg.intra_period == 1  # auto (see params.intra_nxn)

    def _decide(ref_planes=None):
        cu_log2, lm8, cm8, nxn, lm4, tsp8 = decide_intra_qt(
            oy, ou, ov, cfg, qp, ref_planes=ref_planes, device=device)
        if not use_nxn:
            nxn = np.zeros_like(nxn)
            tsp8 = np.zeros_like(tsp8)
            lm4 = np.repeat(np.repeat(lm8, 2, 0), 2, 1)
        return cu_log2, lm8, cm8, nxn, lm4, tsp8

    fs = FrameSyntax(w, h)
    _apply_maps(fs, *_decide())
    y = np.zeros((h, w), np.int32)
    u = np.zeros((h // 2, w // 2), np.int32)
    v = np.zeros((h // 2, w // 2), np.int32)
    lam_fp = int(round(i_frame_lambda(cfg, qp) * 256))
    walk = functools.partial(_walk, fs, sps, qp, (y, u, v), (oy, ou, ov),
                             cfg.pps.sign_data_hiding, cfg.rdoq, lam_fp, True)
    walk()
    if cfg.intra_two_pass:
        # pass 2: re-decide with the pass-1 recon as the open-loop
        # reference source, then code again from scratch
        _apply_maps(fs, *_decide(ref_planes=(y, u, v)))
        y[:], u[:], v[:] = 0, 0, 0
        fs.coeff_y[:] = 0
        fs.coeff_cb[:] = 0
        fs.coeff_cr[:] = 0
        walk()
    return fs, (y, u, v)
