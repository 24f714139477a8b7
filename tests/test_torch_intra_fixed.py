"""The port's fixed-8x8 intra (`intra_qt` off) against tpuhevc's, exact:

- the plain wavefront frame encoder (`codec/intra_frame.py:
  build_frame_encoder` on the CPU, kernel `intra_wave`'s plain version)
  returns the seven outputs of tpuhevc's `intra_jax.build_frame_encoder`
  (JAX on the CPU) bit for bit, at sizes with partial CTUs;
- all-intra through `encode_sequence(..., device_batch=2)` with sign
  hiding off: byte-identical to tpuhevc's batched stream, every hash OK in
  both decoders;
- with sign hiding on: the host closed loop `recon.encode_frame_intra`
  equals tpuhevc's (syntax and recon), and so do the per-picture streams;
  tpuhevc's batched path ignores SignHideFlag and its stream fails its
  hashes, while the port's batched encode falls back to the host loop and
  decodes hash-OK (pinned);
- the IDR of LD-P with fixed 8x8 intra equals tpuhevc's, and a short LD-P
  stream behind it decodes hash-OK in both decoders.

Nine items, two of them the `cuda` test's cases (the recon on chip and
in device memory), which skip without a card; no tpuhevc grid scan is
built.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# test of this file also loads where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import QP, Reader, clip_frames, cuda_device, rng_planes  # noqa: F401
from tpuhevc_torch.codec import params as port_params
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import Encoder, encode_sequence
from tpuhevc_torch.codec.intra_frame import _sqlam_fp, build_frame_encoder, wave_tables
from tpuhevc_torch.codec.recon import encode_frame_intra
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.ops.intra_wave import (intra_wave, intra_wave_plain,
                                          wave_variant)

SYNTAX = ("luma_mode", "chroma_mode", "coeff_y", "coeff_cb", "coeff_cr")


def intra_cfgs(w, h, qp=QP, sbh=False, **kw):
    """(tpuhevc's, the port's) EncoderConfig of fixed-8x8 all-intra."""
    from tpuhevc.codec import params as jax_params

    out = []
    for mod, extra in ((jax_params, dict(inter_backend="jax")),
                       (port_params, {})):
        args = dict(qp=qp, intra_period=1, intra_qt=False, **extra)
        args.update(kw)
        cfg = mod.EncoderConfig(sps=mod.SeqParams(width=w, height=h), **args)
        cfg.pps.sign_data_hiding = sbh
        out.append(cfg)
    return out


def planes(w, h, seed):
    """Smooth-plus-noise luma and chroma planes, int32."""
    return (rng_planes(seed, h, w)[0], rng_planes(seed + 1, h // 2, w // 2)[0],
            rng_planes(seed + 2, h // 2, w // 2)[0])


def jax_decode(stream):
    from tpuhevc.codec.decoder import decode_stream

    return decode_stream(stream)


def hashes_ok(stream, n):
    """Every picture hash-OK in tpuhevc's decoder and in the port's."""
    for dec in (jax_decode, port_decode):
        frames = dec(stream)
        assert len(frames) == n and all(f.md5_ok for f in frames), \
            [f.md5_ok for f in frames]


@pytest.mark.parametrize("w,h,qp", [(128, 64, 32), (104, 72, 22),
                                    (64, 64, 37)])
def test_frame_encoder_matches_jax(w, h, qp):
    import jax.numpy as jnp

    from tpuhevc.codec.intra_jax import build_frame_encoder as jax_build

    jcfg, pcfg = intra_cfgs(w, h, qp)
    oy, ou, ov = planes(w, h, seed=qp)
    ref = jax_build(jcfg)(jnp.asarray(oy), jnp.asarray(ou), jnp.asarray(ov))
    got = build_frame_encoder(pcfg, "cpu")(oy, ou, ov)
    for name, a, b in zip(("rec_y", "rec_u", "rec_v", "modes", "coeff_y",
                           "coeff_cb", "coeff_cr"), ref, got):
        a = np.asarray(a)
        assert b.dtype == torch.int32 and tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def test_batched_stream_matches_jax():
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip_frames(104, 72, 3)
    jcfg, pcfg = intra_cfgs(104, 72)
    ref, _ = jax_encode(Reader(frames), jcfg, device_batch=2)
    got, _ = encode_sequence(Reader(frames), pcfg, device="cpu",
                             device_batch=2)
    assert got.bitstream() == ref.bitstream()
    hashes_ok(got.bitstream(), 3)


@pytest.fixture(scope="module")
def sbh_streams():
    """tpuhevc's SBH-on all-intra streams at 64x64 x 2, QP 32, per picture
    (device_batch 0) and batched (device_batch 2), and the frames."""
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = clip_frames(64, 64, 2)
    out = {}
    for db in (0, 2):
        enc, _ = jax_encode(Reader(frames), intra_cfgs(64, 64, sbh=True)[0],
                            device_batch=db)
        out[db] = enc.bitstream()
    return frames, out


def test_host_sign_hiding_matches_jax(sbh_streams):
    from tpuhevc.codec.recon import encode_frame_intra as jax_host

    frames, ref = sbh_streams
    jcfg, pcfg = intra_cfgs(64, 64, sbh=True)
    jfs, jrec = jax_host(*frames[0], jcfg)
    pfs, prec = encode_frame_intra(*frames[0], pcfg)
    for name in SYNTAX:
        np.testing.assert_array_equal(getattr(pfs, name), getattr(jfs, name),
                                      err_msg=name)
    for a, b in zip(prec, jrec):
        np.testing.assert_array_equal(a, b)
    assert np.any(pfs.coeff_y != 0)
    got, _ = encode_sequence(Reader(frames), pcfg, device="cpu")
    assert got.bitstream() == ref[0]


def test_sbh_batch_fault_of_tpuhevc_not_copied(sbh_streams):
    """tpuhevc's batched path ignores SignHideFlag: the SBH writer omits
    signs that were never hidden, so its pictures fail their MD5 (POC 0
    first). The port's batched encode takes the host loop there."""
    frames, ref = sbh_streams
    assert not any(f.md5_ok for f in jax_decode(ref[2]))
    got, _ = encode_sequence(Reader(frames), intra_cfgs(64, 64, sbh=True)[1],
                             device="cpu", device_batch=2)
    assert got.bitstream() == ref[0]
    hashes_ok(got.bitstream(), 2)


def test_ldp_idr_matches_jax():
    from tpuhevc.codec import params as jax_params
    from tpuhevc.codec.encoder import Encoder as JaxEncoder

    w, h = 112, 72
    frames = clip_frames(w, h, 3)
    cfgs = []
    for mod, extra in ((jax_params, dict(inter_backend="jax")),
                       (port_params, {})):
        cfgs.append(mod.EncoderConfig(
            sps=mod.SeqParams(width=w, height=h), qp=QP, intra_period=-1,
            fme_mode="none", intra_qt=False, gop_qp_offsets=(3, 2, 3, 1),
            **extra))
    ref = JaxEncoder(cfgs[0])
    ref.encode_frame(*frames[0], poc=0)
    got = Encoder(cfgs[1], device="cpu")
    got.encode_frame(*frames[0], poc=0)
    assert got.bitstream() == ref.bitstream()
    enc, _ = encode_sequence(Reader(frames), cfgs[1], device="cpu")
    hashes_ok(enc.bitstream(), 3)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,nf,on_chip", [(104, 72, 2, True),
                                           (832, 480, 1, False)])
def test_cuda_intra_wave_matches_plain(cuda_device, w, h, nf, on_chip):
    """The kernel against its plain version, the recon planes kept on chip
    (104x72) and in device memory (832x480: 599,040 bytes of 8-bit
    planes do not fit)."""
    pcfg = port_params.EncoderConfig(
        sps=port_params.SeqParams(width=w, height=h), qp=QP, intra_period=1,
        intra_qt=False)
    ps = [planes(w, h, seed) for seed in (3, 9)[:nf]]
    args = [torch.as_tensor(np.stack([p[i] for p in ps]), dtype=torch.int32)
            for i in range(3)]
    geo_cpu = wave_tables(w, h, pcfg.sps.log2_ctu, "cpu")
    assert wave_variant(w, h, *geo_cpu.slots.shape, 8)[0] == on_chip
    ref = intra_wave_plain(*args, geo_cpu, QP, _sqlam_fp(pcfg))
    geo = wave_tables(w, h, pcfg.sps.log2_ctu, cuda_device)
    reset_launches()
    got = intra_wave(*(a.to(cuda_device) for a in args), geo, QP,
                     _sqlam_fp(pcfg), bit_depth=8)
    assert LAUNCHES["intra_wave"] == 1
    for a, b in zip(ref, got):
        assert torch.equal(b.cpu(), a)
