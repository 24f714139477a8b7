"""ctypes binding for the native closed-loop intra walk
(native/intra_walk.cpp) — drop-in fast path of intra_qt._walk for the
encoder side (byte-identical by construction; tested in
tests/test_intra_qt.py). Tables (scan orders, transform matrices) are
shipped from the Python side so the normative constants live in one
place (utils/tables.py, ops/transforms.py)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import transforms as tx
from ..utils.tables import chroma_qp, scan_order


@functools.lru_cache(maxsize=1)
def _tables():
    scans = []
    offs = []
    pos = 0
    for log2 in (2, 3, 4, 5):
        for si in (0, 1, 2):
            sc = np.asarray(scan_order(log2, si), np.int32)
            offs.append(pos)
            scans.append(sc)
            pos += sc.size
    scans = np.concatenate(scans).astype(np.int32)
    offs = np.asarray(offs, np.int32)
    mats = []
    moffs = []
    pos = 0
    for s in (4, 8, 16, 32):
        m = np.asarray(tx._matrix(s, False), np.int32).reshape(-1)
        moffs.append(pos)
        mats.append(m)
        pos += m.size
    mats = np.concatenate(mats).astype(np.int32)
    moffs = np.asarray(moffs, np.int32)
    return scans, offs, mats, moffs


@functools.lru_cache(maxsize=1)
def _fn():
    from ..entropy.native import get_lib

    f = get_lib().tpuhevc_intra_walk_v2
    f.restype = ctypes.c_int
    I32P = ctypes.POINTER(ctypes.c_int32)
    I64P = ctypes.POINTER(ctypes.c_int64)
    F64P = ctypes.POINTER(ctypes.c_double)
    f.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_int64, I32P, ctypes.c_int,
                   I64P, I64P] + [I32P] * 9 + [I32P] * 4
                  + [F64P, I64P, ctypes.c_double])
    return f


@functools.lru_cache(maxsize=8)
def _rdoq_tables(qp: int):
    """Pack the estBitsSbac-style RDOQ tables for quantTB's table path
    (native/intra_walk.cpp): per (log2 2..5, chroma/luma) entry
    [sig0 S*S][sig1 S*S][gt1 x4][gt2 x4][csbf x2], float64."""
    from ..entropy.bitest import FracBits, ResidualBitEst
    from .intra_qt import I_ROW

    fb = FracBits(I_ROW, qp)
    blobs = []
    offs = []
    pos = 0
    for log2 in (2, 3, 4, 5):
        for luma in (False, True):
            est = ResidualBitEst(fb, log2, luma)
            sig = np.asarray(est.sig_bits[0], np.float64)  # (S, S, 2)
            ent = np.concatenate([
                sig[:, :, 0].ravel(), sig[:, :, 1].ravel(),
                np.asarray([est.gt1_bits[0], est.gt1_bits[1],
                            est.gt1_bits0[0], est.gt1_bits0[1],
                            est.gt2_bits[0], est.gt2_bits[1],
                            est.gt2_bits0[0], est.gt2_bits0[1],
                            est.csbf_bits[0, 0], est.csbf_bits[0, 1]],
                           np.float64)])
            offs.append(pos)
            blobs.append(ent)
            pos += ent.size
    return (np.ascontiguousarray(np.concatenate(blobs), np.float64),
            np.asarray(offs, np.int64))


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def intra_walk_native(fs, sps, qp, planes, origs, sdh, rdoq, lam_fp,
                      order) -> None:
    """Run the intra walk natively: encoder side with `origs`, decoder
    side (read fs.coeff_*, reconstruct) with origs=None."""
    f = _fn()
    from .intra_qt import _cu_roots
    from .recon import _chroma_mode_resolver

    resolve = _chroma_mode_resolver(fs)
    roots = _cu_roots(fs.cu_log2, order)
    cu = np.empty((len(roots), 5), np.int32)
    for i, (x8, y8) in enumerate(roots):
        cu[i] = (x8, y8, int(fs.cu_log2[y8, x8]),
                 int(fs.luma_mode[y8, x8]), resolve(x8, y8))
    y, u, v = planes
    for a in (y, u, v):
        assert a.dtype == np.int32 and a.flags.c_contiguous
    if origs is not None:
        oy, ou, ov = origs
        oy = np.ascontiguousarray(oy, np.int32)
        ou = np.ascontiguousarray(ou, np.int32)
        ov = np.ascontiguousarray(ov, np.int32)
    else:
        oy = ou = ov = None
    order_map = np.ascontiguousarray(order.order, np.int64)
    smin = order.slice_min
    sminp = (np.ascontiguousarray(smin, np.int64).ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)) if smin is not None
        else ctypes.POINTER(ctypes.c_int64)())
    cy = np.ascontiguousarray(fs.coeff_y, np.int32)
    cb = np.ascontiguousarray(fs.coeff_cb, np.int32)
    cr = np.ascontiguousarray(fs.coeff_cr, np.int32)
    scans, soffs, mats, moffs = _tables()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    qpc = chroma_qp(qp)
    if rdoq:
        tb, toffs = _rdoq_tables(qp)
        tbp = tb.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        toffp = toffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    else:
        tbp = ctypes.POINTER(ctypes.c_double)()
        toffp = ctypes.POINTER(ctypes.c_int64)()
    lam_scale_c = 2.0 ** (-(qp - qpc) / 3.0)
    f(fs.width, fs.height, sps.bit_depth, qp, qpc,
      int(bool(sdh)), int(bool(rdoq)), int(bool(sps.strong_intra_smoothing)),
      int(lam_fp), _p32(np.ascontiguousarray(cu)), len(roots),
      order_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), sminp,
      _p32(y), _p32(u), _p32(v),
      _p32(oy) if oy is not None else null32,
      _p32(ou) if ou is not None else null32,
      _p32(ov) if ov is not None else null32,
      _p32(cy), _p32(cb), _p32(cr),
      _p32(scans), _p32(soffs), _p32(mats), _p32(moffs),
      tbp, toffp, lam_scale_c)
    fs.coeff_y[:] = cy
    fs.coeff_cb[:] = cb
    fs.coeff_cr[:] = cr
