"""The B step's fused entries: `b_pred_yuv` (a B picture's luma decision
and its three planes' predictions) and `b_txq_planes` (the three planes'
coding), one launch each. Imports no JAX.

On the CPU:
- `b_pred_yuv_plain` equals `b_pred_plain` on luma followed by the two
  chroma calls with that inter_dir, on seeded planes with MVs at negative
  quarter- and eighth-pel phases and windows across the four plane edges,
  and on flat planes, where the three costs tie at lambda 0 and every
  block takes bi (3, by `<=`);
- `b_txq_planes_plain` equals the three `b_txq_plain` calls at QP 22, 34
  and 45.

On a card (`cuda`; skipped here), every output `torch.equal` to plain and
one launch a call:
- kernel `b_pred` through `b_pred_yuv` at lambda 0 (flat planes too),
  63.9 and 900 at 416x240;
- kernel `b_txq` through `b_txq_planes` at the three QPs and two lambdas,
  and with a plane of 4x4 TUs beside 16x16 and 8x8 ones in one launch,
  then with a lambda that drops every TU and with cur == pred (every level
  0);
- the taps compiled into `b_pred` equal `ops/interp.py`'s `taps()`.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc_torch.entropy.bitest import FracBits, est_tables
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.interp import (
    b_pred_plain, b_pred_taps, b_pred_yuv, b_pred_yuv_plain, taps)
from tpuhevc_torch.ops.txq import b_txq_plain, b_txq_planes, b_txq_planes_plain
from tpuhevc_torch.utils.tables import chroma_qp

QPS = (22, 34, 45)


def tiles(p, s):
    """A plane (h, w) as its s x s blocks in raster order (n, s, s)."""
    h, w = p.shape
    return (p.reshape(h // s, s, w // s, s).permute(0, 2, 1, 3)
            .reshape(-1, s, s).contiguous())


def b_picture(dev, w, h, seed=3, flat=False):
    """The B step's inputs: the originals' blocks (Y 16x16, U and V 8x8),
    both lists' Y, U and V planes, the blocks' positions and each list's
    quarter-pel MVs (phases of every sign; the corner blocks' windows past
    each edge)."""
    sizes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    planes = [np.full((3, hh, ww), 120, np.int32) if flat
              else rng_planes(seed + k, hh, ww, 3)
              for k, (hh, ww) in enumerate(sizes)]
    nw = w // 16
    n = (h // 16) * nw
    rng = np.random.default_rng(seed)
    mvq = rng.integers(-90, 91, (2, n, 2)).astype(np.int32)
    # the four corners: windows across the left, top, right and bottom edges
    for k, mv in ((0, (-75, -61)), (nw - 1, (77, -66)), (n - nw, (-83, 70)),
                  (n - 1, (81, 73))):
        mvq[:, k] = mv
    (oy, r0y, r1y), (ou, r0u, r1u), (ov, r0v, r1v) = (
        [torch.from_numpy(x).to(dev) for x in p] for p in planes)
    blk = torch.arange(n, dtype=torch.int32, device=dev)
    m = torch.from_numpy(mvq).to(dev)
    return dict(cur=tiles(oy, 16), cur_u=tiles(ou, 8), cur_v=tiles(ov, 8),
                refs_y=(r0y, r1y), refs_u=(r0u, r1u), refs_v=(r0v, r1v),
                xs=(blk % nw) * 16, ys=(blk // nw) * 16,
                mvq0=m[0].contiguous(), mvq1=m[1].contiguous())


def pred_args(b, lam):
    return (b["cur"], b["refs_y"], b["refs_u"], b["refs_v"], b["xs"],
            b["ys"], b["mvq0"], b["mvq1"], lam)


def txq_planes(b, qp, lam, same=False):
    """The three planes' (cur, pred, qp, est) as the B step gives them, the
    predictions b_pred_yuv_plain's at lam (cur == pred with same)."""
    pred_y, _, pred_u, pred_v = b_pred_yuv_plain(*pred_args(b, lam))
    preds = (pred_y, pred_u, pred_v)
    curs = ([p.clone() for p in preds] if same
            else (b["cur"], b["cur_u"], b["cur_v"]))
    fb = FracBits(0, qp)
    est_y = est_tables(fb, 4, True, pred_y.device)
    est_c = est_tables(fb, 3, False, pred_y.device)
    return [(c, p, q, e) for c, p, q, e in zip(
        curs, preds, (qp, chroma_qp(qp), chroma_qp(qp)),
        (est_y, est_c, est_c))]


def test_b_pred_yuv_plain_is_the_three_calls():
    for flat in (False, True):
        b = b_picture("cpu", 64, 48, flat=flat)
        for lam in (0.0, 63.9):
            got = b_pred_yuv_plain(*pred_args(b, lam))
            pred_y, dirs = b_pred_plain(b["cur"], *b["refs_y"], b["xs"],
                                        b["ys"], b["mvq0"], b["mvq1"], 16,
                                        True, lam)
            want = [pred_y, dirs] + [
                b_pred_plain(None, *refs, b["xs"] // 2, b["ys"] // 2,
                             b["mvq0"], b["mvq1"], 8, False,
                             inter_dir=dirs)[0]
                for refs in (b["refs_u"], b["refs_v"])]
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            if flat and lam == 0.0:  # every cost ties: bi by `<=`
                assert bool((got[1] == 3).all())
        if not flat:
            assert {1, 2, 3} <= set(got[1].tolist())


def test_b_txq_planes_plain_is_the_three_calls():
    b = b_picture("cpu", 64, 48)
    for qp in QPS:
        planes = txq_planes(b, qp, 40.0)
        got = b_txq_planes_plain(planes, 57.1)
        want = [b_txq_plain(c, p, q, 57.1, e) for c, p, q, e in planes]
        assert all(torch.equal(x, y) for g, w in zip(got, want)
                   for x, y in zip(g, w))
        assert any(bool(g[0].any()) for g in got), qp  # some level coded


def launched(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 63.9, 900.0])
def test_cuda_b_pred_yuv_matches_plain(cuda_device, lam):
    for flat in ((False, True) if lam == 0.0 else (False,)):
        b = b_picture(cuda_device, 416, 240, flat=flat)
        got = launched("b_pred", lambda: b_pred_yuv(*pred_args(b, lam)))
        want = b_pred_yuv_plain(*pred_args(b, lam))
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (lam, flat)
        if flat:
            assert bool((got[1] == 3).all())


def with_4x4(planes, qp):
    """Luma, U and a plane of 4x4 TUs (the corners of the luma blocks):
    three TU sizes in one launch."""
    cur, pred, _, est = planes[0]
    return planes[:2] + [(cur[:, :4, :4].contiguous(),
                          pred[:, :4, :4].contiguous(), qp,
                          est_tables(FracBits(0, qp), 2, True, est.itab.device))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["qps", "all_drop_and_no_residual"])
def test_cuda_b_txq_planes_matches_plain(cuda_device, case):
    b = b_picture(cuda_device, 416, 240)
    for qp in QPS:
        runs = ([(txq_planes(b, qp, 40.0), lam) for lam in (0.0, 57.1)]
                + [(with_4x4(txq_planes(b, qp, 40.0), qp), 57.1)]
                if case == "qps" else
                [(txq_planes(b, qp, 40.0), 1e9),
                 (txq_planes(b, qp, 40.0, same=True), 57.1)])
        for planes, lam in runs:
            got = launched("b_txq", lambda: b_txq_planes(planes, lam))
            want = b_txq_planes_plain(planes, lam)
            assert all(torch.equal(x, y) for g, w in zip(got, want)
                       for x, y in zip(g, w)), (case, qp, lam)
            if case != "qps":  # nothing coded: every level 0, rec = pred
                assert all(not bool(lv.any()) and torch.equal(rec, p[1])
                           for (lv, rec), p in zip(got, planes))


@pytest.mark.cuda
def test_cuda_b_pred_taps_are_taps(cuda_device):
    luma, chroma = b_pred_taps(cuda_device)
    assert np.array_equal(luma, taps(True, "cpu").numpy())
    assert np.array_equal(chroma, taps(False, "cpu").numpy())
