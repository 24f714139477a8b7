"""Main10 (10-bit) in tpuhevc_torch against tpuhevc (JAX on the CPU) at
112x72 (every CU class), QP 32, on a 10-bit clip made as tpuhevc's
`tests/test_main10.py` makes it (the 8-bit seeded clip x 4 plus an
offset):

- the per-picture device stage (`inter_enc.build_stage`, the plain
  versions) against tpuhevc's `_stage_fn` on the same int32 planes: the
  MVs, the SAD surfaces, the levels and the 32-vs-16 choice equal, the
  recon equal to the int32 planes `_stage_fn` returns; tpuhevc's packed
  row cuts those planes to bytes (pinned: its recon bytes are the planes
  mod 256), the port's carries 16-bit samples;
- the LD-P scan (`inter_batch.build_ldp_scan`) against tpuhevc's, fed
  16-bit frames: integer-pel, every packed field but the recon equal and
  the final reference planes equal; with NN-FME's fractional MVs
  tpuhevc's scan interpolates with the 8-bit shifts at 10 bits (pinned:
  ME and K2 agree, its recon differs only inside PUs fractional on both
  axes; the port's takes the standard's shifts, as tpuhevc's per-picture
  stage and both decoders do);
- `decide_intra_qt` at 10 bits: the six maps of `decide_intra_qt_jax`
  for the all-intra Main variant and the LD-P IDR variant;
- `python -m tpuhevc_torch enc` with cfg/encoder_intra_main.cfg and
  `--InputBitDepth=10 --InternalBitDepth=10` (16-bit YUV in and out, a
  Main10 SPS) byte-identical to tpuhevc's jax-backend stream; the anchor
  LD-P cfg at 10 bits (the host tool stage) byte-identical to tpuhevc's;
- the tools-off scan and IntraPeriod 4 (the device stage) at 10 bits
  decode hash-OK in both decoders, with samples above 255.

tpuhevc's device routes fail their hashes at 10 bits (their recon cut to
bytes), so the streams are compared where tpuhevc is right: all-intra
and the host stage.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_util import QP, Reader, clip10, write_weights
from tpuhevc.codec import params as jax_params
from tpuhevc.codec.decoder import decode_stream
from tpuhevc.config import options as jax_options
from tpuhevc.models import nnfme as ref_nnfme
from tpuhevc_torch.codec import params as port_params
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.config import options as port_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTRA_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
LDP_CFG = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")
W, H = 112, 72
MAIN10 = ["--InputBitDepth=10", "--InternalBitDepth=10"]
MAPS = ("cu_log2", "lm8", "cm8", "nxn", "lm4", "tsp8")
GOP = (3, 2, 3, 1)



def cfg10(port: bool, **kw):
    """An EncoderConfig at 10 bits, Main10 (the port's or tpuhevc's)."""
    mod = port_params if port else jax_params
    args = dict(qp=QP)
    args.update(kw)
    return mod.EncoderConfig(sps=mod.SeqParams(width=W, height=H,
                                               bit_depth=10, profile_idc=2),
                             **args)


def from_cfg(path: str, frames: int, port: bool, *extra):
    opts = port_options if port else jax_options
    cfg, _ = opts.build_config(opts.parse_args([
        "-c", path, "-wdt", str(W), "-hgt", str(H), "-f", str(frames),
        "-q", str(QP), *MAIN10, *extra]))
    return cfg


@pytest.fixture(scope="module")
def clip():
    return clip10(W, H, 5)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    npz = write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")
    return npz, ref_nnfme.select_qp_params(ref_nnfme.load_npz(npz), QP)


def check_decodes(stream: bytes, n: int, recons=None):
    """n pictures, every hash OK in tpuhevc's decoder and the port's, the
    same planes in both, samples above 255 (and the encoder's recon)."""
    ref, port = decode_stream(stream), port_decode(stream)
    assert len(ref) == len(port) == n
    assert all(f.md5_ok for f in ref) and all(f.md5_ok for f in port)
    assert max(int(f.y.max()) for f in port) > 255
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.u, b.u)
    if recons is not None:  # decoding order is display order here
        for f, (ry, _, _) in zip(port, recons):
            np.testing.assert_array_equal(f.y, ry[:H, :W])


def test_device_stage_matches_stage_fn(clip, weights):
    """The port's per-picture stage at 10 bits (NN-FME: fractional MVs)
    against tpuhevc's `_stage_fn` on the same int32 planes."""
    from tpuhevc.codec import inter_enc as jie
    from tpuhevc_torch.codec import inter_enc as tie
    from tpuhevc_torch.utils.tables import qp_to_lambda

    npz, params = weights
    jcfg = cfg10(False, fme_mode="nn", nn_weights_dir=npz)
    tcfg = cfg10(True, fme_mode="nn", nn_weights_dir=npz)
    lambda_fp = int(round(np.sqrt(qp_to_lambda(QP, 0.4624)) * 256))
    planes = [np.ascontiguousarray(p, np.int32) for p in clip[1] + clip[0]]
    jfn, grids = jie._stage_fn(jcfg, params, lambda_fp)
    jbuf, *jrec = (np.asarray(x) for x in jfn(*planes))
    tfn, tgrids = tie.build_stage(tcfg, params, lambda_fp, "cpu")
    tbuf, *trec = (x.numpy() for x in tfn(*(torch.from_numpy(p)
                                             for p in planes)))
    assert grids == tgrids
    for a, b in zip(trec, jrec):  # the recon planes, int32
        np.testing.assert_array_equal(a, b)
    assert max(int(p.max()) for p in jrec) > 255
    jcu = jie._stage_collect(jcfg, jbuf, grids)
    tcu = tie._stage_collect(tcfg, tbuf, grids)
    assert jcu.keys() == tcu.keys()
    frac = 0
    for (x0, y0), j in jcu.items():
        t = tcu[(x0, y0)]
        for k in ("mv", "sad9", "mv_int", "lvl", "lvl_u", "lvl_v"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        s, c = j["size"], j["size"] // 2
        for k, plane, x, y, n in (("rec", jrec[0], x0, y0, s),
                                  ("rec_u", jrec[1], x0 // 2, y0 // 2, c),
                                  ("rec_v", jrec[2], x0 // 2, y0 // 2, c)):
            want = plane[y : y + n, x : x + n]
            np.testing.assert_array_equal(t[k], want)  # 16-bit in the row
            # tpuhevc's row holds the planes cut to bytes
            np.testing.assert_array_equal(j[k], want % 256)
        frac += bool((np.asarray(j["mv"]) & 3).all())
    assert frac  # 2-D fractional MVs were interpolated


def test_scan_matches_ldp_scan(clip, weights):
    """One GOP of the scan from the same IDR recon, 16-bit frames in both:
    integer-pel (no weights) every field but the recon equal and the final
    references equal; with NN-FME, ME and K2 equal and tpuhevc's recon off
    where its 8-bit interpolation shifts meet 2-D fractional MVs."""
    import jax.numpy as jnp

    from torch_port_util import parse_meta
    from tpuhevc.codec import inter_batch as jib
    from tpuhevc_torch.codec import inter_batch as tib
    from tpuhevc_torch.codec.intra_qt import encode_frame_intra_qt

    npz, params = weights
    qps = sorted({min(max(QP + o, 0), 51) for o in GOP})
    jcfg = cfg10(False, intra_period=-1, fme_mode="nn", nn_weights_dir=npz,
                 gop_qp_offsets=GOP)
    tcfg = cfg10(True, intra_period=-1, fme_mode="nn", nn_weights_dir=npz,
                 gop_qp_offsets=GOP)
    _, refs = encode_frame_intra_qt(*clip[0], tcfg, device="cpu")
    refs = [np.ascontiguousarray(p, np.int32) for p in refs]
    f16 = np.stack([np.concatenate([p.ravel() for p in fr])
                    for fr in clip[1:5]]).astype(np.int16).reshape(1, 4, -1)
    lvl_bytes = W * H * 3  # the int16 level planes lead the row
    rec = {8: W * H * 3 // 2, 16: W * H * 3}  # the recon's bytes after them
    for nn_by_qp in ({}, {qp: params for qp in qps}):
        jfn, _, _ = jib.build_ldp_scan(jcfg, nn_by_qp, 1)
        jrows, *jref = (np.asarray(x) for x in jfn(
            jnp.asarray(f16), *(jnp.asarray(p) for p in refs)))
        tfn, _, _ = tib.build_ldp_scan(tcfg, nn_by_qp, 1, "cpu")
        trows, *tref = (x.numpy() for x in tfn(
            torch.from_numpy(f16), *(torch.from_numpy(p) for p in refs)))
        assert trows.shape[1] == jrows.shape[1] + rec[8]
        for j, t in zip(jrows, trows):
            jmeta, tmeta = j[lvl_bytes + rec[8] :], t[lvl_bytes + rec[16] :]
            if not nn_by_qp:
                assert t[:lvl_bytes].tobytes() == j[:lvl_bytes].tobytes()
                assert tmeta.tobytes() == jmeta.tobytes()
                # the port's row carries the 16-bit recon, tpuhevc's bytes
                t16 = t[lvl_bytes : lvl_bytes + rec[16]].view("<i2")
                assert (t16 > 255).any()
                np.testing.assert_array_equal(
                    t16 % 256, j[lvl_bytes : lvl_bytes + rec[8]])
        if not nn_by_qp:
            for a, b in zip(tref, jref):
                np.testing.assert_array_equal(a, b)
            continue
        # NN-FME, the first picture: the search and the offsets agree; the
        # luma recon differs (beyond the byte cut) only inside PUs whose MV
        # is fractional on both axes, where tpuhevc's scan keeps the 8-bit
        # interpolation shifts at 10 bits; the carried references differ
        jm = parse_meta(jcfg, jrows[0])
        tm = parse_meta(jcfg, np.concatenate([  # as an 8-bit row
            trows[0][: lvl_bytes + rec[8]], trows[0][lvl_bytes + rec[16] :]]))
        frac2 = np.zeros((H, W), bool)
        for tag, poss, size in tib._positions(tcfg)[1]:
            for a, b in zip(tm[tag][:3], jm[tag][:3]):  # mvq, mv_int, sad9
                np.testing.assert_array_equal(a, b)
            for (x, y), mv in zip(poss, tm[tag][0]):
                frac2[y : y + size, x : x + size] |= bool((mv & 3).all())
        t16 = trows[0][lvl_bytes : lvl_bytes + rec[16]].view("<i2")
        j8 = jrows[0][lvl_bytes : lvl_bytes + rec[8]]
        diff = (t16[: W * H] % 256 != j8[: W * H]).reshape(H, W)
        assert diff.any() and not (diff & ~frac2).any()
        assert any((a != b).any() for a, b in zip(tref, jref))


@pytest.mark.parametrize("variant", ["all_intra", "ldp_idr"])
def test_decision_maps_equal_jax(clip, variant):
    from tpuhevc.codec.intra_decide_jax import decide_intra_qt_jax
    from tpuhevc_torch.codec.intra_decide import decide_intra_qt

    if variant == "all_intra":
        jcfg, tcfg = (from_cfg(INTRA_CFG, 2, port) for port in (False, True))
    else:
        jcfg, tcfg = (cfg10(port, intra_period=-1, gop_qp_offsets=GOP)
                      for port in (False, True))
    planes = [np.ascontiguousarray(p, np.int32) for p in clip[0]]
    want = decide_intra_qt_jax(*planes, jcfg, QP)
    got = decide_intra_qt(*planes, tcfg, QP, device="cpu")
    for name, g, w in zip(MAPS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_cli_all_intra_main10_matches_jax(tmp_path, clip):
    """The CLI at 10 bits: 16-bit YUV in, a Main10 stream byte-identical to
    tpuhevc's jax-backend encode, 16-bit recon out."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode
    from tpuhevc_torch.app import main_encode
    from tpuhevc_torch.entropy import bitio
    from tpuhevc_torch.entropy.headers import parse_sps

    yuv, out, rec = (tmp_path / n for n in ("in.yuv", "out.bin", "rec.yuv"))
    with open(yuv, "wb") as f:
        for fr in clip[:2]:
            for p in fr:
                f.write(np.ascontiguousarray(p, "<u2").tobytes())
    assert main_encode(["-c", INTRA_CFG, "-i", str(yuv), "-b", str(out),
                        "-o", str(rec), "-wdt", str(W), "-hgt", str(H),
                        "-f", "2", "-q", str(QP), *MAIN10,
                        "--Device=cpu"]) == 0
    stream = out.read_bytes()
    ref, _ = jax_encode(Reader(clip[:2]), dataclasses.replace(
        from_cfg(INTRA_CFG, 2, False), inter_backend="jax"))
    assert stream == ref.bitstream()
    check_decodes(stream, 2)
    sps_nal = next(n for n in bitio.read_annexb(stream)
                   if (n[0] >> 1) & 0x3F == bitio.NAL_SPS)
    sps, _ = parse_sps(bitio.ebsp_to_rbsp(sps_nal[2:]))
    assert (sps.bit_depth, sps.profile_idc) == (10, 2)
    got = np.fromfile(rec, "<u2")
    frames = port_decode(stream)
    want = np.concatenate([p.ravel() for f in frames for p in (f.y, f.u, f.v)])
    np.testing.assert_array_equal(got, want)


def test_anchor_main10_matches_jax(clip, weights):
    """The anchor LD-P cfg as shipped at 10 bits, 3 frames: the IDR decided
    on the device, the P pictures through the host tool stage (RDOQ, SBH,
    deblocking, SAO), byte-identical to tpuhevc's jax-backend encode (its
    IDR decided by `decide_intra_qt_jax`; the tools send its P pictures
    to its host stage)."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    npz, _ = weights
    extra = [f"--NNWeightsDir={npz}"]
    ref, _ = jax_encode(Reader(clip[:3]), dataclasses.replace(
        from_cfg(LDP_CFG, 3, False, *extra), inter_backend="jax"))
    enc, recons = encode_sequence(Reader(clip[:3]),
                                  from_cfg(LDP_CFG, 3, True, *extra),
                                  device="cpu")
    assert enc.nn_params is not None
    assert enc.bitstream() == ref.bitstream()
    check_decodes(enc.bitstream(), 3, recons)


def test_scan_and_intra_period_decode(clip, weights):
    """The tools-off LD-P scan (NN-FME) and IntraPeriod 4 (the per-picture
    device stage) at 10 bits, 5 frames each."""
    npz, _ = weights
    for kw in (dict(intra_period=-1, gop_qp_offsets=GOP),
               dict(intra_period=4)):
        cfg = cfg10(True, fme_mode="nn", nn_weights_dir=npz, **kw)
        enc, recons = encode_sequence(Reader(clip), cfg, device="cpu")
        check_decodes(enc.bitstream(), 5, recons)
