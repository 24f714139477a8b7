"""The B step's 10-bit kernels, `b_me10`, `b_pred10` and `b_txq10`,
against their plain versions. Imports no JAX.

On the CPU: the wrappers refuse a bit depth they have no variant for, on
either device (the plain versions at 10 bits are what the random-access
Main10 path runs, held against tpuhevc in test_torch_ra_main10.py).

On a card (`cuda`; skipped here), every output `torch.equal` on 10-bit
planes (samples 0..1023, textured, and flat at 0 and 1023), one launch a
call and two calls back to back:
- `b_me10` at sr 4, 7 and 16, lambda 0 and the B step's, on textured
  planes, flat planes (every cost ties at lambda 0: the first offset) and
  a block at 1023 over references at 0 (SADs of 261,888);
- `b_pred10` through `b_pred_yuv` (the three planes) at lambda 0, 63.9
  and 900, and through its one-plane entries; flat planes at 0 and 1023
  (every cost ties at lambda 0: bi), and originals at 1023 over
  references at 0, whose SSEs (2.7e8) lie above 2^24;
- `b_txq10` through `b_txq_planes`, without and with sign hiding, at QP
  22, 34 and 45, with 4x4 TUs beside 16x16 and 8x8 in one launch, then
  originals at 1023 over predictions at 0 (the drop's SSEs above 2^24)
  and cur == pred;
- the B step at 10 bits (`build_b_step` on the card) equal to the CPU
  step, each 10-bit kernel launched once and the 8-bit ones idle.
"""

import numpy as np
import pytest
import torch

from test_torch_b_code import pred_args, tiles, txq_planes, with_4x4
from test_torch_main10_cuda import plane10
from tpuhevc_torch.codec import inter_b as tib
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.interp import (
    b_pred, b_pred_plain, b_pred_yuv, b_pred_yuv_plain)
from tpuhevc_torch.ops.me import b_me, b_me_plain
from tpuhevc_torch.ops.txq import b_txq, b_txq_planes, b_txq_planes_plain

W, H = 416, 240
MAX10 = 1023
QPS = (22, 34, 45)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda", torch.cuda.current_device())


def b_picture10(dev, w=W, h=H, seed=3, fill=None, cur_fill=None):
    """The B step's inputs at 10 bits (as test_torch_b_code.b_picture):
    the originals' blocks, both lists' Y, U and V planes (textured, or
    flat at `fill`; the originals at `cur_fill` where given), the blocks'
    positions and quarter-pel MVs of every phase and sign, the corner
    blocks' windows past each edge."""
    planes = []
    for k, (hh, ww) in enumerate(((h, w), (h // 2, w // 2),
                                  (h // 2, w // 2))):
        p = [np.full((hh, ww), fill, np.int32) if fill is not None
             else plane10(seed + 3 * k + i, hh, ww) for i in range(3)]
        if cur_fill is not None:
            p[0] = np.full((hh, ww), cur_fill, np.int32)
        planes.append(p)
    nw = w // 16
    n = (h // 16) * nw
    rng = np.random.default_rng(seed)
    mvq = rng.integers(-90, 91, (2, n, 2)).astype(np.int32)
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
                mvq0=m[0].contiguous(), mvq1=m[1].contiguous(),
                planes=(oy, r0y, r1y))


def twice(name, fn):
    """Two calls back to back, each one launch of `name`; both results."""
    before = LAUNCHES[name]
    out = (fn(), fn())
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 2, name
    return out


def equal(got, want):
    flat = []
    for g, w in zip(got, want, strict=True):
        if isinstance(g, (tuple, list)):
            flat += list(zip(g, w, strict=True))
        else:
            flat.append((g, w))
    return all(torch.equal(x, y) for x, y in flat)


def test_wrappers_refuse_other_depths():
    b = b_picture10("cpu", 64, 48)
    org, r0, r1 = b["planes"]
    with pytest.raises(ValueError, match="bit depth 12"):
        b_me(org, r0, r1, 0.0, 4, bit_depth=12)
    with pytest.raises(ValueError, match="bit depth 9"):
        b_pred_yuv(*pred_args(b, 0.0), bit_depth=9)
    with pytest.raises(ValueError, match="bit depth 12"):
        b_pred(b["cur"], *b["refs_y"], b["xs"], b["ys"], b["mvq0"],
               b["mvq1"], 16, True, 0.0, bit_depth=12)
    planes = txq_planes(b, 32, 40.0)
    with pytest.raises(ValueError, match="bit depth 9"):
        b_txq_planes(planes, 57.1, bit_depth=9)
    with pytest.raises(ValueError, match="bit depth 16"):
        b_txq(*planes[0][:3], 57.1, planes[0][3], bit_depth=16)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [4, 7, 16])
def test_b_me10_matches_plain(dev, sr):
    b = b_picture10(dev)
    org, r0, r1 = b["planes"]
    zero, top = torch.zeros_like(org), torch.full_like(org, MAX10)
    cases = (("textured", (org, r0, r1), (0.0, 7.56)),
             ("flat", (top, top, torch.full_like(org, 1000)), (0.0,)),
             ("1023 over 0", (top, zero, zero), (0.0, 7.56)))
    for tag, planes, lams in cases:
        for lam in lams:
            got = twice("b_me10", lambda: b_me(*planes, lam, sr,
                                               bit_depth=10))
            want = b_me_plain(*planes, lam, sr, 10)
            assert all(equal(g, want) for g in got), (tag, lam)
            if tag != "textured" and lam == 0.0:  # ties: the first offset
                assert bool((got[0][0] == -sr).all()), tag
            if tag == "1023 over 0":
                assert bool((got[0][1] == 256 * MAX10).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [0.0, 63.9, 900.0])
def test_b_pred10_matches_plain(dev, lam):
    pics = [("textured", b_picture10(dev))]
    if lam == 0.0:
        pics += [("flat 0", b_picture10(dev, fill=0)),
                 ("flat 1023", b_picture10(dev, fill=MAX10))]
    pics.append(("1023 over 0", b_picture10(dev, fill=0, cur_fill=MAX10)))
    for tag, b in pics:
        args = pred_args(b, lam)
        got = twice("b_pred10", lambda: b_pred_yuv(*args, bit_depth=10))
        want = b_pred_yuv_plain(*args, 10)
        assert all(equal(g, want) for g in got), (tag, lam)
        if tag.startswith("flat") and lam == 0.0:  # every cost ties: bi
            assert bool((got[0][1] == 3).all())
        if tag == "textured":
            assert {1, 2, 3} <= set(want[1].tolist()), lam
        # the one-plane entries: luma deciding, U with that inter_dir
        one = (b["cur"], *b["refs_y"], b["xs"], b["ys"], b["mvq0"],
               b["mvq1"], 16, True, lam)
        got = twice("b_pred10", lambda: b_pred(*one, bit_depth=10))
        assert all(equal(g, b_pred_plain(*one, bit_depth=10)) for g in got)
        one = (None, *b["refs_u"], b["xs"] // 2, b["ys"] // 2, b["mvq0"],
               b["mvq1"], 8, False)
        dirs = want[1]
        got = twice("b_pred10", lambda: b_pred(*one, inter_dir=dirs,
                                               bit_depth=10))
        assert all(equal(g, b_pred_plain(*one, inter_dir=dirs,
                                         bit_depth=10)) for g in got)


def txq_planes10(b, qp, lam):
    """The three planes' (cur, pred, qp, est) at 10 bits: the predictions
    b_pred_yuv_plain's at lam."""
    planes = txq_planes(b, qp, lam)
    preds = b_pred_yuv_plain(*pred_args(b, lam), 10)
    return [(c, p, q, e) for (c, _, q, e), p in zip(
        planes, (preds[0], preds[2], preds[3]))]


@pytest.mark.cuda
@pytest.mark.parametrize("sbh", [False, True], ids=["no_sbh", "sbh"])
def test_b_txq10_matches_plain(dev, sbh):
    b = b_picture10(dev)
    big = b_picture10(dev, fill=0, cur_fill=MAX10)
    for qp in QPS:
        planes = txq_planes10(b, qp, 40.0)
        top = [(c, torch.zeros_like(p), q, e)
               for c, p, q, e in txq_planes10(big, qp, 40.0)]
        same = [(p.clone(), p, q, e) for _, p, q, e in planes]
        runs = [(planes, 0.0), (planes, 57.1),
                (with_4x4(planes, qp), 57.1), (top, 57.1), (top, 1e9),
                (same, 57.1)]
        for k, (pl, lam) in enumerate(runs):
            got = twice("b_txq10", lambda: b_txq_planes(
                pl, lam, sbh=sbh, bit_depth=10))
            want = b_txq_planes_plain(pl, lam, sbh, 10)
            assert all(equal(g, want) for g in got), (qp, k)
            if k == 3:  # 1023 over 0: coded, the recon at 10 bits
                assert bool(got[0][0][0].any())
                assert int(got[0][0][1].max()) > 255
            if k >= 4:  # nothing coded: every level 0, rec = pred
                assert all(not bool(lv.any()) and torch.equal(rec, p[1])
                           for (lv, rec), p in zip(got[0], pl))


@pytest.mark.cuda
def test_b_step10_cuda_equals_cpu(dev):
    """The B step at 10 bits on the card equals the CPU step on the same
    planes; one launch each of b_me10, b_pred10 and b_txq10 a call, the
    8-bit variants idle."""
    from tpuhevc_torch.models.nnfme import random_params

    cfg = EncoderConfig(sps=SeqParams(width=W, height=H, bit_depth=10,
                                      profile_idc=2),
                        qp=32, gop_structure="ra")
    params = random_params(0)
    b = b_picture10("cpu")
    ins = [b["planes"][0], b["refs_u"][0], b["refs_v"][0],
           b["planes"][1], b["refs_u"][1], b["refs_v"][1],
           b["planes"][2], b["refs_u"][0], b["refs_v"][1]]
    want = tib.build_b_step(cfg, 34, params, "cpu")(*ins)
    before = dict(LAUNCHES)
    got = tib.build_b_step(cfg, 34, params, dev)(*(a.to(dev) for a in ins))
    torch.cuda.synchronize()
    for k in ("b_me", "b_pred", "b_txq"):
        assert LAUNCHES[k] == before[k], k
        assert LAUNCHES[k + "10"] == before[k + "10"] + 1, k
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert int(want[4].max()) > 255
