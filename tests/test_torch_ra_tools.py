"""Random access beyond the GOP table's tools-off slice, in
tpuhevc_torch against tpuhevc (JAX on the CPU), and the B step's sign-bit
hiding.

- random access without a GOP table (`encoder._ra_gop4`: P key pictures,
  B pictures 2, 1, 3 of each GOP of 4, the P tail) at 64x48 x 6, and the
  random-access cfg with RDOQ, deblocking, SAO and DCT-IF at 64x48 x 6:
  streams byte-identical to tpuhevc's jax-backend encode, every hash OK
  in both decoders;
- with SignHideFlag 1 (and RDOQ, deblocking and SAO) at 64x48 x 10 the
  B step hides signs and the stream decodes with every hash OK in both
  decoders; it is not compared with tpuhevc's, whose B step hides no sign
  while its writer omits one (its streams fail their hashes);
- `ops.txq.sbh_levels` equals tpuhevc's host rule
  (`entropy.residual.apply_sign_bit_hiding` against `ideal_levels_np`)
  on random blocks at every TU size of the B step; `b_txq_plain` with sbh
  equals that rule composed with the B step's coding, and without sbh the
  same composition without the hiding (the kernel as it was);
- on a card (`cuda`; skipped here) kernel `b_txq`'s sign-hiding variant
  equals plain, one launch a call.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_b_code import b_picture, launched, txq_planes, with_4x4
from torch_port_util import (  # noqa: F401
    QP, Reader, clip_frames, cuda_device, write_weights)
from tpuhevc_torch.codec import inter_b as tib
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.recon import _pad_to
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.entropy.bitest import tu_bits_plain
from tpuhevc_torch.entropy.residual import SCAN_DIAG, apply_sign_bit_hiding
from tpuhevc_torch.ops import transforms as tx
from tpuhevc_torch.ops.txq import (
    b_txq_plain, b_txq_planes, b_txq_planes_plain, sbh_levels)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")
W, H = 64, 48
TOOLS = ["--RDOQ=1", "--LoopFilterDisable=0", "--SAO=1"]

# name: (frames, extra options, drop the GOP table)
ROUTES = {
    "no_gop_table": (6, [], True),
    "rdoq_deblocking_sao_dctif": (6, TOOLS + ["--FmeMode=dctif"], False),
}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")


def ra_args(npz, n, extra):
    return (["-c", RA_CFG, "-wdt", str(W), "-hgt", str(H), "-f", str(n),
             "-q", str(QP), f"--NNWeightsDir={npz}"] + list(extra))


def check_decodes(stream, n, recons=None):
    from tpuhevc.codec.decoder import decode_stream as jax_decode

    for decode in (decode_stream, jax_decode):
        decoded = decode(stream)
        assert len(decoded) == n and all(f.md5_ok for f in decoded)
    for f, (ry, ru, rv) in zip(decode_stream(stream), recons or ()):
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


@pytest.mark.parametrize("name", list(ROUTES))
def test_ra_stream_matches_tpuhevc(npz, name):
    from tpuhevc.codec.encoder import encode_sequence as jax_encode
    from tpuhevc.config.options import build_config as jbuild
    from tpuhevc.config.options import parse_args as jparse

    n, extra, no_table = ROUTES[name]
    frames = clip_frames(W, H, n)
    jcfg, _ = jbuild(jparse(ra_args(npz, n, extra)))
    cfg, _ = build_config(parse_args(ra_args(npz, n, extra)))
    if no_table:
        jcfg = dataclasses.replace(jcfg, gop_table=())
        cfg = dataclasses.replace(cfg, gop_table=())
    want, _ = jax_encode(Reader(frames),
                         dataclasses.replace(jcfg, inter_backend="jax"))
    got, recons = encode_sequence(Reader(frames), cfg, device="cpu")
    assert [r.poc for r in got.results] == [0, 4, 2, 1, 3, 5]
    assert got.bitstream() == want.bitstream(), name
    check_decodes(got.bitstream(), n, recons)


def test_ra_sign_hiding_decodes(npz):
    """SignHideFlag 1 with RDOQ, deblocking and SAO at 64x48 x 10 (two
    GOPs of B pictures and the P tail): every hash OK in both decoders;
    the B step's levels with hiding differ from those without, at one B
    picture's inputs."""
    n = 10
    frames = clip_frames(W, H, n)
    cfg, _ = build_config(parse_args(
        ra_args(npz, n, TOOLS + ["--SignHideFlag=1"])))
    assert cfg.pps.sign_data_hiding
    enc, recons = encode_sequence(Reader(frames), cfg, device="cpu")
    check_decodes(enc.bitstream(), n, recons)
    from tpuhevc_torch.models.nnfme import random_params

    ins = [torch.from_numpy(_pad_to(np.asarray(p), H >> s, W >> s)
                            .astype(np.int32))
           for f in (frames[2], frames[0], frames[4])
           for p, s in zip(f, (0, 1, 1))]
    off = dataclasses.replace(cfg, pps=dataclasses.replace(
        cfg.pps, sign_data_hiding=False))
    on_out = tib.build_b_step(cfg, QP + 2, random_params(0), "cpu")(*ins)
    off_out = tib.build_b_step(off, QP + 2, random_params(0), "cpu")(*ins)
    assert all(torch.equal(a, b) for a, b in zip(on_out[:3], off_out[:3]))
    assert any(not torch.equal(a, b) for a, b in zip(on_out[3::2],
                                                     off_out[3::2]))


@pytest.mark.parametrize("log2", [2, 3, 4])
def test_sbh_levels_is_the_host_rule(log2):
    """Random coefficients quantised, with levels nudged by +-1 so parities
    and signs vary, at QP 22-45: `sbh_levels` equals
    `apply_sign_bit_hiding` with the ideal levels, and hides signs."""
    rng = np.random.default_rng(log2)
    S = 1 << log2
    changed = 0
    for qp in (22, 30, 37, 45):
        coef = (rng.integers(-3000, 3000, (300, S, S))
                * (rng.random((300, S, S)) < 0.35)).astype(np.int32)
        lvl = tx.quantize_np(coef, qp, log2, 8, False)
        lvl = (lvl + rng.integers(-1, 2, lvl.shape)
               * (rng.random(lvl.shape) < 0.2)).astype(np.int32)
        want = apply_sign_bit_hiding(lvl, log2, SCAN_DIAG,
                                     tx.ideal_levels_np(coef, qp, log2, 8))
        got = sbh_levels(torch.from_numpy(lvl), torch.from_numpy(coef), qp,
                         log2)
        np.testing.assert_array_equal(got.numpy(), want)
        changed += int((want != lvl).sum())
    assert changed > 0


def composed(cur, pred, qp, lam, est, sbh):
    """The B step's TU coding from its parts, with tpuhevc's host sign
    hiding rule in numpy where sbh."""
    n, S = cur.shape[0], cur.shape[-1]
    log2 = S.bit_length() - 1
    coef = tx.forward_transform(cur - pred)
    lvl = tx.rdoq_est(coef, qp, log2, 8, lam, est)
    if sbh:
        lvl = torch.from_numpy(apply_sign_bit_hiding(
            lvl.numpy(), log2, SCAN_DIAG,
            tx.ideal_levels_np(coef.numpy(), qp, log2, 8)))
    rec = (pred + tx.inverse_transform(tx.dequantize(lvl, qp, log2))).clamp(
        0, 255)
    rec = torch.where((lvl != 0).reshape(n, -1).any(1)[:, None, None], rec,
                      pred)
    sse = [((cur - p).long() ** 2).reshape(n, -1).sum(1).int()
           for p in (pred, rec)]
    drop = ((sse[0] - sse[1]).float()
            <= torch.tensor(lam, dtype=torch.float32)
            * tu_bits_plain(est, lvl, sbh))
    return (torch.where(drop[:, None, None], 0, lvl),
            torch.where(drop[:, None, None], pred, rec))


def test_b_txq_plain_sign_hiding_is_the_composition():
    b = b_picture("cpu", 64, 48)
    hid = 0
    for qp in (22, 34, 45):
        for lam in (0.0, 57.1):
            for cur, pred, q, est in txq_planes(b, qp, 40.0):
                for sbh in (False, True):
                    got = b_txq_plain(cur, pred, q, lam, est, sbh)
                    want = composed(cur, pred, q, lam, est, sbh)
                    assert all(torch.equal(x, y) for x, y in zip(got, want))
                hid += int((got[0] != b_txq_plain(cur, pred, q, lam,
                                                  est)[0]).sum())
    assert hid > 0


@pytest.mark.cuda
def test_cuda_b_txq_sign_hiding_matches_plain(cuda_device):
    """Kernel `b_txq`'s sign-hiding variant against plain at 416x240: the
    three QPs, lambdas 0 and 57.1, a plane of 4x4 TUs beside the 16x16 and
    8x8 ones, one launch a call."""
    b = b_picture(cuda_device, 416, 240)
    for qp in (22, 34, 45):
        runs = ([(txq_planes(b, qp, 40.0), lam) for lam in (0.0, 57.1)]
                + [(with_4x4(txq_planes(b, qp, 40.0), qp), 57.1)])
        for planes, lam in runs:
            got = launched("b_txq",
                           lambda: b_txq_planes(planes, lam, sbh=True))
            want = b_txq_planes_plain(planes, lam, sbh=True)
            assert all(torch.equal(x, y) for g, w in zip(got, want)
                       for x, y in zip(g, w)), (qp, lam)
