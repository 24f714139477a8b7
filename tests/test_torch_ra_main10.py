"""Main10 (10-bit) random access in tpuhevc_torch against tpuhevc (JAX on
the CPU) at 64x48 x 5, QP 30, cfg/encoder_randomaccess_main.cfg with
`--InputBitDepth=10 --InternalBitDepth=10`, seeded NN-FME weights, on the
10-bit clip of tests/torch_port_util.py (`clip10`):

- the port's B step (`inter_b.build_b_step`, the plain versions of b_me,
  b_pred and b_txq at 10 bits) equals tpuhevc's `_b_step` in all nine
  outputs on the same 10-bit planes;
- with the cfg's GOP table (every picture after the IDR a B picture) the
  CPU stream is byte-identical to tpuhevc's jax-backend stream, tools off
  and with RDOQ, deblocking and SAO; every hash OK in both decoders, luma
  above 255;
- without a table (`encoder._ra_gop4`: a P key picture, then B pictures)
  the port's stream is hash-OK in both decoders, while tpuhevc's key P
  picture fails its hash: its per-picture stage packs the recon as bytes
  (`tpuhevc/codec/inter_enc.py:490-494`), so its encoder's POC 4 tops out
  at 255 (pinned);
- with SignHideFlag 1 (and RDOQ, deblocking, SAO) the stream decodes
  hash-OK, and `sbh_levels` at bit depth 10 equals tpuhevc's host rule
  (`apply_sign_bit_hiding` against `ideal_levels_np(..., 10)`).

tpuhevc compiles its B step once a (QP, weights): the module fixture
loads its NN-FME weights once, so every tpuhevc encode of the module and
the B-step test share those compiles (three QPs) and the P stage's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_util import Reader, clip10, write_weights
from tpuhevc.codec.decoder import decode_stream as jax_decode
from tpuhevc_torch.codec import inter_b as tib
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.recon import _pad_to
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.entropy.residual import SCAN_DIAG, apply_sign_bit_hiding
from tpuhevc_torch.ops import transforms as tx
from tpuhevc_torch.ops.txq import sbh_levels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")
W, H, N, QP = 64, 48, 5, 30
MAIN10 = ["--InputBitDepth=10", "--InternalBitDepth=10"]
TOOLS = ["--RDOQ=1", "--LoopFilterDisable=0", "--SAO=1"]
B_OUTS = ("mvq0", "mvq1", "inter_dir", "lvl_y", "rec_y", "lvl_u", "rec_u",
          "lvl_v", "rec_v")


def ra_args(npz, extra=()):
    return ["-c", RA_CFG, "-wdt", str(W), "-hgt", str(H), "-f", str(N),
            "-q", str(QP), f"--NNWeightsDir={npz}", *MAIN10, *extra]


def port_cfg(npz, extra=(), table=True):
    cfg, _ = build_config(parse_args(ra_args(npz, extra)))
    return cfg if table else dataclasses.replace(cfg, gop_table=())


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The weights, the clip, and tpuhevc's jax-backend encodes (run on
    demand, each once), its NN-FME weights loaded once for the module."""
    from tpuhevc.codec import encoder as jenc
    from tpuhevc.config.options import build_config as jbuild
    from tpuhevc.config.options import parse_args as jparse

    npz = write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz", qp=QP)
    with pytest.MonkeyPatch.context() as mp:
        loaded = {}
        load = jenc._load_nn_params

        def once(cfg):
            key = (cfg.nn_weights_dir, cfg.qp)
            if key not in loaded:
                loaded[key] = load(cfg)
            return loaded[key]

        mp.setattr(jenc, "_load_nn_params", once)
        streams = {}

        def encode(extra=(), table=True):
            key = (tuple(extra), table)
            if key not in streams:
                cfg, _ = jbuild(jparse(ra_args(npz, extra)))
                cfg = dataclasses.replace(cfg, inter_backend="jax")
                if not table:
                    cfg = dataclasses.replace(cfg, gop_table=())
                enc, recons = jenc.encode_sequence(Reader(clip), cfg)
                assert enc.nn_params is not None  # NN-FME really ran
                streams[key] = (enc, {r.poc: rec for r, rec in
                                      zip(enc.results, recons)})
            return streams[key]

        clip = clip10(W, H, N)
        yield dict(npz=npz, clip=clip, encode=encode)


def port_encode(ref, extra=(), table=True):
    enc, recons = encode_sequence(Reader(ref["clip"]),
                                  port_cfg(ref["npz"], extra, table),
                                  device="cpu")
    assert [r.poc for r in enc.results] == [0, 4, 2, 1, 3]
    return enc, recons


def check_decodes(stream, recons):
    """Every hash OK in tpuhevc's decoder and the port's, the same planes
    in both, equal to the encoder's recon (decoding order), luma above
    255."""
    ref, port = jax_decode(stream), port_decode(stream)
    assert len(ref) == len(port) == N
    assert all(f.md5_ok for f in ref) and all(f.md5_ok for f in port)
    for a, b, (ry, ru, rv) in zip(ref, port, recons):
        for p, q, r in ((a.y, b.y, ry), (a.u, b.u, ru), (a.v, b.v, rv)):
            np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(q, r[: q.shape[0], : q.shape[1]])
    assert max(int(f.y.max()) for f in port) > 255


def test_b_step_matches_jax(ref):
    """POC 2 (QP 32, between POC 0 and POC 4) from tpuhevc's own recons:
    every output of the port's B step equals `_b_step`'s at 10 bits."""
    from tpuhevc.codec import inter_b as jib

    enc, by_poc = ref["encode"]()
    qp = QP + 2
    ins = [_pad_to(np.asarray(p), H >> s, W >> s).astype(np.int32)
           for p, s in zip(ref["clip"][2], (0, 1, 1))] + [
        np.asarray(p, np.int32) for poc in (0, 4) for p in by_poc[poc]]
    assert max(int(a.max()) for a in ins) > 255
    want = jib._b_step(enc.cfg, qp, enc.nn_params)(*ins)
    got = tib.build_b_step(port_cfg(ref["npz"]), qp, enc.nn_params, "cpu")(
        *(torch.from_numpy(a) for a in ins))
    for name, g, w in zip(B_OUTS, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert 3 in set(got[2].numpy().tolist()) <= {1, 2, 3}
    assert (got[0].numpy() % 4).any()  # quarter-pel MVs from NN-FME
    assert int(got[4].max()) > 255 and any(got[k].any() for k in (3, 5, 7))


@pytest.mark.parametrize("tools", [False, True], ids=["tools_off",
                                                      "rdoq_dbf_sao"])
def test_ra_table_stream_matches_jax(ref, tools):
    """The cfg's GOP table at 10 bits, tools off or with RDOQ, deblocking
    and SAO: byte-identical to tpuhevc's stream, which decodes hash-OK."""
    extra = TOOLS if tools else []
    want, _ = ref["encode"](extra)
    assert all(f.md5_ok for f in jax_decode(want.bitstream()))
    got, recons = port_encode(ref, extra)
    assert got.bitstream() == want.bitstream()
    check_decodes(got.bitstream(), recons)


def test_ra_without_table_decodes(ref):
    """`_ra_gop4` at 10 bits: the port's stream hash-OK in both decoders;
    tpuhevc's key P picture (POC 4) fails its hash, its encoder's recon
    cut to bytes (pinned), and its B pictures decode."""
    got, recons = port_encode(ref, table=False)
    check_decodes(got.bitstream(), recons)
    assert int(recons[1][0].max()) > 255  # POC 4, the key P picture
    want, by_poc = ref["encode"](table=False)
    assert [f.md5_ok for f in jax_decode(want.bitstream())] == [
        True, False, True, True, True]
    assert int(by_poc[4][0].max()) <= 255


def test_ra_sign_hiding_decodes(ref):
    """SignHideFlag 1 with RDOQ, deblocking and SAO at 10 bits: the B step
    hides signs and the stream decodes hash-OK in both decoders (tpuhevc's
    B step hides none, so its stream is not compared)."""
    extra = TOOLS + ["--SignHideFlag=1"]
    assert port_cfg(ref["npz"], extra).pps.sign_data_hiding
    got, recons = port_encode(ref, extra)
    check_decodes(got.bitstream(), recons)
    plain, _ = port_encode(ref, TOOLS)
    assert got.bitstream() != plain.bitstream()


@pytest.mark.parametrize("log2", [2, 3, 4])
def test_sbh_levels_at_10_bits_is_the_host_rule(log2):
    """Random 10-bit-range coefficients quantised at bit depth 10, levels
    nudged by +-1 so parities and signs vary, QP 22-45: `sbh_levels` at
    bit depth 10 equals `apply_sign_bit_hiding` with the 10-bit ideal
    levels and hides signs."""
    rng = np.random.default_rng(10 + log2)
    S = 1 << log2
    changed = 0
    for qp in (22, 30, 37, 45):
        coef = (rng.integers(-12000, 12000, (300, S, S))
                * (rng.random((300, S, S)) < 0.35)).astype(np.int32)
        lvl = tx.quantize_np(coef, qp, log2, 10, False)
        lvl = (lvl + rng.integers(-1, 2, lvl.shape)
               * (rng.random(lvl.shape) < 0.2)).astype(np.int32)
        want = apply_sign_bit_hiding(lvl, log2, SCAN_DIAG,
                                     tx.ideal_levels_np(coef, qp, log2, 10))
        got = sbh_levels(torch.from_numpy(lvl), torch.from_numpy(coef), qp,
                         log2, 10)
        np.testing.assert_array_equal(got.numpy(), want)
        changed += int((want != lvl).sum())
    assert changed > 0
