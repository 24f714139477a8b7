"""The 10-bit variants of K1 (`sad_search`), K3 (`mc_blk`), K4 (`txq`)
and `intra_txq` against their plain versions. Imports no JAX.

On the CPU: the plain versions at 10 bits are what the Main10 paths run
(held against tpuhevc in test_torch_main10.py); here the wrappers refuse
a bit depth they have no variant for.

On a card (`cuda`; skipped here), every output `torch.equal` on 10-bit
planes (samples 0..1023, textured, and flat at 0 and 1023):
- K1 over three classes (S = 32, 16, 8, PUs at every edge) in one
  launch, subsample on and off, lam_me 0 and 900, sr 1, 7 and 16;
- K3 over the six (size, plane) cases in one launch, MVs of every phase
  and sign, windows clamped at every edge;
- K4 over twelve jobs (every TU size, QP 22, 37 and 51 in the mix) in
  one launch, lambdas 3000, 2^26 and 2^30, and cur == pred;
- intra_txq at every TU size, luma and chroma (the DST at 4x4 luma),
  RDOQ on and off, on residuals up to +-1023.
"""

import numpy as np
import pytest
import torch

from tpuhevc_torch.entropy.bitest import FracBits, est_tables
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.interp import mc_blk_planes, mc_blk_planes_plain
from tpuhevc_torch.ops.intra_txq import intra_txq, intra_txq_plain
from tpuhevc_torch.ops.me import (bits_table, sad_search_classes,
                                  sad_search_classes_plain)
from tpuhevc_torch.ops.txq import txq_planes, txq_planes_plain

W, H = 416, 240
MAX10 = 1023


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda", torch.cuda.current_device())


def plane10(seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A smooth-plus-noise 10-bit plane (h, w) int32 reaching both ends."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(5, 40, 4)
    base = (512 + 420 * np.sin(xx / f[0] + yy / f[1])
            + 200 * np.cos(yy / f[2] - xx / f[3]) + rng.normal(0, 30, (h, w)))
    return np.clip(np.rint(base), 0, MAX10).astype(np.int32)


def launched(name: str, fn):
    before = LAUNCHES[name]
    out = fn()
    assert LAUNCHES[name] - before == 1, name
    return out


def test_wrappers_refuse_other_depths():
    z = torch.zeros((8, 8), dtype=torch.int32)
    idx = torch.zeros((1,), dtype=torch.int32)
    mv = torch.zeros((1, 2), dtype=torch.int32)
    cur = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="bit depth 12"):
        sad_search_classes(z, [(cur, idx, idx)], bits_table(1, "cpu"), 0, 1,
                           bit_depth=12)
    with pytest.raises(ValueError, match="bit depth 9"):
        mc_blk_planes([(z, idx, idx, mv, 8, True)], 9)
    with pytest.raises(ValueError, match="bit depth 12"):
        txq_planes([(cur, cur, 32)], 1000, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [1, 7, 16])
def test_k1_10bit_matches_plain(dev, sr):
    ref = torch.from_numpy(plane10(1)).to(dev)
    cur_plane = torch.from_numpy(plane10(2)).to(dev)
    classes = []
    for S in (32, 16, 8):
        poss = [(x, y) for y in (0, H - S, 96) for x in (0, W - S, 200)]
        xs = torch.tensor([p[0] for p in poss], dtype=torch.int32, device=dev)
        ys = torch.tensor([p[1] for p in poss], dtype=torch.int32, device=dev)
        ar = torch.arange(S, device=dev)
        idx = ((ys.long()[:, None, None] + ar[:, None]) * W
               + xs.long()[:, None, None] + ar)
        classes.append((cur_plane.reshape(-1)[idx].contiguous(), xs, ys))
    bits = bits_table(sr, dev)
    for plane, cs in ((ref, classes),
                      (torch.zeros_like(ref),
                       [(torch.full_like(c, MAX10), x, y)
                        for c, x, y in classes])):
        for lam_me in (0, 900):
            for sub in (True, False):
                got = launched("sad_search10", lambda: sad_search_classes(
                    plane, cs, bits, lam_me, sr, sub, bit_depth=10))
                want = sad_search_classes_plain(plane, cs, bits, lam_me, sr,
                                                sub, 10)
                torch.cuda.synchronize()
                for g, w in zip(got, want, strict=True):
                    assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.cuda
def test_k3_10bit_matches_plain(dev):
    rng = np.random.default_rng(5)
    jobs = []
    for k, (S, luma) in enumerate(((32, True), (16, True), (8, True),
                                   (16, False), (8, False), (4, False))):
        w, h = (W, H) if luma else (W // 2, H // 2)
        plane = torch.from_numpy(plane10(10 + k, h, w)).to(dev)
        fm = 4 if luma else 8
        pos = [(x, y) for x in (0, w - S) for y in (0, h - S)]
        pos += [(int(rng.integers(0, w // S)) * S,
                 int(rng.integers(0, h // S)) * S) for _ in range(40)]
        xs, ys, mvs = [], [], []
        for i, (x, y) in enumerate(pos):
            for ph in range(fm * fm):
                reach = fm * (max(w, h) + 24) if i < 4 else fm * int(
                    rng.integers(0, 40))
                sx, sy = (1, -1)[ph & 1], (1, -1)[(ph >> 1) & 1]
                xs.append(x)
                ys.append(y)
                mvs.append((sx * (reach + ph % fm), sy * (reach + ph // fm)))
        jobs.append((plane, torch.tensor(xs, dtype=torch.int32, device=dev),
                     torch.tensor(ys, dtype=torch.int32, device=dev),
                     torch.tensor(mvs, dtype=torch.int32, device=dev), S,
                     luma))
    got = launched("mc_blk10", lambda: mc_blk_planes(jobs, 10))
    want = mc_blk_planes_plain(jobs, 10)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert max(int(g.max()) for g in got) > 255


def tus10(S: int, seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, MAX10 + 1, (n, S, S)).astype(np.int32)
    cur = np.clip(pred + rng.integers(-300, 301, (n, S, S)), 0,
                  MAX10).astype(np.int32)
    return torch.from_numpy(cur), torch.from_numpy(pred)


@pytest.mark.cuda
def test_k4_10bit_matches_plain(dev):
    jobs = []
    for i, (S, qp, qpc) in enumerate(((32, 32, 31), (16, 37, 51),
                                      (16, 22, 22), (8, 47, 40))):
        for j, (s, q) in enumerate(((S, qp), (S // 2, qpc), (S // 2, qpc))):
            c, p = tus10(s, 3 * i + j)
            jobs.append((c.to(dev), p.to(dev), q))
    same = [(c, c.clone(), q) for c, _, q in jobs[:3]]
    for js in (jobs, same):
        for lam_full in (3000, 1 << 26, 1 << 30):
            got = launched("txq10", lambda: txq_planes(js, lam_full, 10))
            want = txq_planes_plain(js, lam_full, 10)
            torch.cuda.synchronize()
            for g, w in zip(got, want, strict=True):
                for a, b in zip(g, w, strict=True):
                    assert torch.equal(a, b)


@pytest.mark.cuda
def test_intra_txq_10bit_matches_plain(dev):
    rng = np.random.default_rng(9)
    qp, lam = 32, 57.1
    for S, luma in ((4, True), (8, True), (16, True), (32, True),
                    (4, False), (8, False), (16, False)):
        n = 40
        org = torch.as_tensor(rng.integers(0, MAX10 + 1, (n, S, S)),
                              dtype=torch.int32, device=dev)
        preds = torch.as_tensor(rng.integers(0, MAX10 + 1, (n, 35, S, S)),
                                dtype=torch.int32, device=dev)
        rows = torch.as_tensor(rng.permutation(n), dtype=torch.int32,
                               device=dev)
        modes = torch.as_tensor(rng.integers(0, 35, (n, 3)),
                                dtype=torch.int32, device=dev)
        et = est_tables(FracBits(2, qp), S.bit_length() - 1, luma, dev)
        for rdoq in (False, True):
            args = (org, preds, rows, modes, qp, luma and S == 4, rdoq, lam,
                    et, 10)
            got = launched("intra_txq10", lambda: intra_txq(*args))
            want = intra_txq_plain(*args)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w), (S, rdoq)
