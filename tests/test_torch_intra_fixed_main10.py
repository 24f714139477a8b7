"""The port's fixed-8x8 intra (`intra_qt` off) at bit depth 10 (Main10)
against tpuhevc's (JAX on the CPU), exact, on the 10-bit clip of
tests/torch_port_util.py (`clip10`: the 8-bit clip x 4 plus an offset)
and one picture that drives the samples to 0 and 1023 (`extreme10`):

- the plain wavefront frame encoder (`codec/intra_frame.py:
  build_frame_encoder` on the CPU, kernel `intra_wave`'s plain version at
  bit depth 10) returns the seven outputs of tpuhevc's
  `intra_jax.build_frame_encoder` bit for bit, at 64x48 and 104x72;
- all-intra through `encode_sequence(..., device_batch=2)` over 3
  pictures with sign hiding off: byte-identical to tpuhevc's batched
  stream, every hash OK in both decoders; a picture at a time (`Encoder`'s
  `encode_frame_intra_device`) equal to tpuhevc's per-picture stream;
- with sign hiding on, the host's closed loop (`recon.encode_frame_intra`)
  equals tpuhevc's stream;
- the IDR of LD-P equals tpuhevc's I picture, and the port's whole LD-P
  stream decodes hash-OK (tpuhevc's scan cuts 10-bit recon to bytes after
  the IDR: ROADMAP queue 3, pinned in tests/test_torch_main10.py);
- random access with the cfg's GOP table at 64x48 x 5 byte-identical to
  tpuhevc's stream.

Seven items; each tpuhevc reference is compiled once.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_util import QP, Reader, clip10, write_weights
from tpuhevc.codec import params as jax_params
from tpuhevc.codec.decoder import decode_stream as jax_decode
from tpuhevc_torch.codec import params as port_params
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import Encoder, encode_sequence
from tpuhevc_torch.codec.intra_frame import build_frame_encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")
OUTS = ("rec_y", "rec_u", "rec_v", "modes", "coeff_y", "coeff_cb",
        "coeff_cr")


def extreme10(w: int, h: int) -> tuple:
    """One (y, u, v) uint16 picture at 0 and 1023 only: 8x8 checkers of
    luma, one-sample columns in its lower right quarter, 4x4 checkers of
    chroma (V the inverse of U)."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx >> 3) + (yy >> 3)) & 1
    y = np.where((xx >= w // 2) & (yy >= h // 2), xx & 1, y)
    cy, cx = np.mgrid[0 : h // 2, 0 : w // 2]
    u = ((cx >> 2) + (cy >> 2)) & 1
    return tuple((1023 * p).astype(np.uint16) for p in (y, u, 1 - u))


def cfgs(w, h, sbh=False, **kw):
    """(tpuhevc's, the port's) EncoderConfig at 10 bits (Main10) with
    fixed 8x8 intra, all-intra unless kw says otherwise."""
    out = []
    for mod, extra in ((jax_params, dict(inter_backend="jax")),
                       (port_params, {})):
        args = dict(qp=QP, intra_period=1, intra_qt=False, **extra)
        args.update(kw)
        cfg = mod.EncoderConfig(sps=mod.SeqParams(
            width=w, height=h, bit_depth=10, profile_idc=2), **args)
        cfg.pps.sign_data_hiding = sbh
        out.append(cfg)
    return out


def hashes_ok(stream: bytes, n: int):
    """n pictures, every hash OK in tpuhevc's decoder and the port's, the
    same planes in both, luma above 255."""
    ref, port = jax_decode(stream), port_decode(stream)
    assert len(ref) == len(port) == n
    assert all(f.md5_ok for f in ref), [f.md5_ok for f in ref]
    assert all(f.md5_ok for f in port), [f.md5_ok for f in port]
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.y, b.y)
    assert max(int(f.y.max()) for f in port) > 255


@pytest.mark.parametrize("w,h", [(64, 48), (104, 72)])
def test_frame_encoder_matches_jax(w, h):
    """64x48 the extreme picture (its recon clipped at 0 and 1023),
    104x72 a picture of the clip."""
    import jax.numpy as jnp

    from tpuhevc.codec.intra_jax import build_frame_encoder as jax_build

    jcfg, pcfg = cfgs(w, h)
    pic = extreme10(w, h) if w == 64 else clip10(w, h, 1)[0]
    planes = [p.astype(np.int32) for p in pic]
    ref = jax_build(jcfg)(*(jnp.asarray(p) for p in planes))
    got = build_frame_encoder(pcfg, "cpu")(*planes)
    for name, a, b in zip(OUTS, ref, got):
        a = np.asarray(a)
        assert b.dtype == torch.int32 and tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert int(got[0].max()) > 255
    if w == 64:
        assert int(got[0].min()) == 0 and int(got[0].max()) == 1023
    assert bool((got[4] != 0).any())


def test_batched_stream_matches_jax():
    """3 pictures (two of the clip, the extreme one) in batches of 2."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip10(104, 72, 2) + [extreme10(104, 72)]
    jcfg, pcfg = cfgs(104, 72)
    ref, _ = jax_encode(Reader(frames), jcfg, device_batch=2)
    got, recons = encode_sequence(Reader(frames), pcfg, device="cpu",
                                  device_batch=2)
    assert got.bitstream() == ref.bitstream()
    hashes_ok(got.bitstream(), 3)
    assert int(recons[2][0].min()) == 0 and int(recons[2][0].max()) == 1023


def test_per_picture_stream_matches_jax():
    """`Encoder`'s per-picture route (sign hiding off): each picture
    through `encode_frame_intra_device`, as tpuhevc's through
    `encode_frame_intra_jax`."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip10(64, 48, 1) + [extreme10(64, 48)]
    jcfg, pcfg = cfgs(64, 48)
    ref, _ = jax_encode(Reader(frames), jcfg)
    got, _ = encode_sequence(Reader(frames), pcfg, device="cpu")
    assert got.bitstream() == ref.bitstream()
    hashes_ok(got.bitstream(), 2)


def test_host_sign_hiding_matches_jax():
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip10(64, 64, 2)
    jcfg, pcfg = cfgs(64, 64, sbh=True)
    ref, _ = jax_encode(Reader(frames), jcfg)
    got, _ = encode_sequence(Reader(frames), pcfg, device="cpu")
    assert got.bitstream() == ref.bitstream()
    hashes_ok(got.bitstream(), 2)


def test_ldp_idr_matches_jax():
    from tpuhevc.codec.encoder import Encoder as JaxEncoder

    frames = clip10(112, 72, 3)
    jcfg, pcfg = cfgs(112, 72, intra_period=-1, fme_mode="none",
                      gop_qp_offsets=(3, 2, 3, 1))
    ref = JaxEncoder(jcfg)
    ref.encode_frame(*frames[0], poc=0)
    got = Encoder(pcfg, device="cpu")
    got.encode_frame(*frames[0], poc=0)
    assert got.bitstream() == ref.bitstream()
    enc, _ = encode_sequence(Reader(frames), pcfg, device="cpu")
    assert [r.poc for r in enc.results] == [0, 1, 2]
    hashes_ok(enc.bitstream(), 3)


def test_ra_gop_table_matches_jax(tmp_path):
    """cfg/encoder_randomaccess_main.cfg at 64x48 x 5 with its GOP table,
    seeded NN-FME weights, intra_qt off."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode
    from tpuhevc.config.options import build_config as jax_build
    from tpuhevc.config.options import parse_args as jax_parse
    from tpuhevc_torch.config.options import build_config, parse_args

    npz = write_weights(tmp_path / "w.npz")
    args = ["-c", RA_CFG, "-wdt", "64", "-hgt", "48", "-f", "5", "-q",
            str(QP), f"--NNWeightsDir={npz}", "--InputBitDepth=10",
            "--InternalBitDepth=10"]
    jcfg = dataclasses.replace(jax_build(jax_parse(args))[0],
                               inter_backend="jax", intra_qt=False)
    pcfg = dataclasses.replace(build_config(parse_args(args))[0],
                               intra_qt=False)
    frames = clip10(64, 48, 5)
    ref, _ = jax_encode(Reader(frames), jcfg)
    got, _ = encode_sequence(Reader(frames), pcfg, device="cpu")
    assert [r.poc for r in got.results] == [0, 4, 2, 1, 3]
    assert got.bitstream() == ref.bitstream()
    hashes_ok(got.bitstream(), 5)
