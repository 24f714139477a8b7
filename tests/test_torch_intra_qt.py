"""The port's open-loop quadtree intra decision and its all-intra path
against tpuhevc's (JAX on the CPU) at 112x72, QP 32:

- `decide_intra_qt` returns the six maps of `decide_intra_qt_jax`, equal,
  for the all-intra Main variant (NxN, RDOQ), the LD-P IDR variant (NxN
  and TU split off, no RDOQ) and an all-intra variant with the TU split
  on, each for pass 1 and for a pass-2 call from the pass-1 recon;
- `python -m tpuhevc_torch enc` with cfg/encoder_intra_main.cfg: two
  pictures byte-identical to `tpuhevc.codec.encoder.encode_sequence` with
  inter_backend "jax", decoded with every hash OK, also with tpuhevc's
  host tools after the decision (SBH, deblocking, SAO) on;
- the all-intra path imports no jax and refuses what is outside it;
  rate control, admitted since the per-picture P path, encodes and
  decodes with every hash OK.

Each JAX variant is compiled once per module (its `_build` is cached per
configuration, and the streams reuse the maps tests' variants).
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import H, QP, W, Reader, clip_frames, cuda_device  # noqa: F401
from tpuhevc.codec import params as jax_params
from tpuhevc.codec.decoder import decode_stream
from tpuhevc.codec.recon import _pad_to
from tpuhevc.config import options as jax_options
from tpuhevc_torch.codec import params as port_params
from tpuhevc_torch.codec.decoder import decode_stream as port_decode
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.config import options as port_options
from tpuhevc_torch.codec.intra_decide import decide_intra_qt
from tpuhevc_torch.codec.intra_qt import encode_frame_intra_qt
from tpuhevc_torch.kernels import LAUNCHES, reset_launches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTRA_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
MAPS = ("cu_log2", "lm8", "cm8", "nxn", "lm4", "tsp8")


def intra_cfg(w=W, h=H, frames=2, *extra, port=True):
    """cfg/encoder_intra_main.cfg (IntraPeriod 1, RDOQ, QP 32) at w x h:
    the port's EncoderConfig through the port's options, or with
    port=False tpuhevc's through tpuhevc's, from the same options."""
    opts = port_options if port else jax_options
    cfg, _ = opts.build_config(opts.parse_args([
        "-c", INTRA_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
        "-q", str(QP), *extra]))
    return cfg


VARIANTS = {  # name: cfg(port), the port's or tpuhevc's EncoderConfig
    "all_intra": lambda port: intra_cfg(port=port),
    "ldp_idr": lambda port: (port_params if port else jax_params).EncoderConfig(
        sps=(port_params if port else jax_params).SeqParams(width=W,
                                                            height=H),
        qp=QP, intra_period=-1, gop_qp_offsets=(3, 2, 3, 1)),
    "all_intra_tusplit": lambda port: (
        port_params if port else jax_params).EncoderConfig(
        sps=(port_params if port else jax_params).SeqParams(width=W,
                                                            height=H),
        qp=QP, intra_period=1, rdoq=True),
}


@pytest.fixture(scope="module")
def frames():
    return clip_frames(W, H, 2)


def padded(cfg, frame):
    sps = cfg.sps
    return [_pad_to(np.asarray(p), sps.coded_height >> s,
                    sps.coded_width >> s).astype(np.int32)
            for p, s in zip(frame, (0, 1, 1))]


@pytest.mark.parametrize("pass_", [1, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decision_maps_equal_jax(frames, variant, pass_):
    from tpuhevc.codec.intra_decide_jax import decide_intra_qt_jax

    cfg = VARIANTS[variant](True)
    planes = padded(cfg, frames[0])
    ref = None
    if pass_ == 2:  # the pass-1 recon, as the two-pass encode passes it
        _, ref = encode_frame_intra_qt(
            *frames[0], dataclasses.replace(cfg, intra_two_pass=False),
            device="cpu")
    want = decide_intra_qt_jax(*planes, VARIANTS[variant](False), QP,
                               ref_planes=ref)
    got = decide_intra_qt(*planes, cfg, QP, ref_planes=ref, device="cpu")
    for name, g, w in zip(MAPS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if variant != "ldp_idr":  # the full-width decision is exercised
        assert got[3].any() and (got[0] > 3).any()
    if variant == "all_intra_tusplit":
        assert got[5].any()


def check_decodes(stream, recons, n):
    decoded = decode_stream(stream)
    assert len(decoded) == n and all(f.md5_ok for f in decoded)
    for f, (ry, ru, rv) in zip(decoded, recons):  # IDRs: every POC is 0
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


@pytest.mark.parametrize("tools", ["cfg", "sbh_deblock_sao"])
def test_all_intra_stream_matches_jax_and_decodes(frames, tools):
    from tpuhevc.codec.encoder import encode_sequence as jax_encode_sequence

    extra = [] if tools == "cfg" else [
        "--SignHideFlag=1", "--LoopFilterDisable=0", "--SAO=1"]
    ref, _ = jax_encode_sequence(
        Reader(frames), dataclasses.replace(
            intra_cfg(W, H, 2, *extra, port=False), inter_backend="jax"))
    enc, recons = encode_sequence(Reader(frames), intra_cfg(W, H, 2, *extra),
                                  device="cpu")
    stream = enc.bitstream()
    assert len(enc.results) == 2
    assert stream == ref.bitstream()
    check_decodes(stream, recons, 2)


def test_cli_all_intra_encodes(tmp_path, frames):
    """`python -m tpuhevc_torch enc -c cfg/encoder_intra_main.cfg` on the
    CPU: the stream decodes, and the port loaded no jax."""
    yuv = tmp_path / "in.yuv"
    with open(yuv, "wb") as f:
        for fr in frames:
            for p in fr:
                f.write(np.ascontiguousarray(p, np.uint8).tobytes())
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
sys.argv = ["tpuhevc_torch", "enc", "-c", {INTRA_CFG!r}, "-i", {str(yuv)!r},
            "-b", {str(tmp_path / 'out.bin')!r}, "-wdt", "{W}", "-hgt", "{H}",
            "-f", "2", "-q", "{QP}", "--Device=cpu"]
from tpuhevc_torch.app import main
rc = main()
print("jax loaded:", "jax" in sys.modules, "rc", rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         # one intra-op thread: faster at these sizes
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "jax loaded: False rc 0"
    decoded = decode_stream((tmp_path / "out.bin").read_bytes())
    assert len(decoded) == 2 and all(f.md5_ok for f in decoded)


OUTSIDE = {  # name: (cfg-file options, EncoderConfig fields)
    "multiple_slices": ([], dict(slice_ctus=2)),
    "bit_depth_10": (["--InputBitDepth=10", "--InternalBitDepth=10"], {}),
    "bit_depth_10_fixed_8x8": (["--InputBitDepth=10", "--InternalBitDepth=10"],
                               dict(intra_qt=False)),
    "rate_control": (["--RateControl=1", "--TargetBitrate=200000"], {}),
    "scaling_list": (["--ScalingList=1"], {}),
    "adaptive_qp": (["--AdaptiveQP=1"], {}),
    "wavefronts": (["--WaveFrontSynchro=1"], {}),
    "hrd": (["--SEIBufferingPeriod=1"], {}),
}


# rate control: the picture's QP from the R-lambda model; bit depth 10
# (Main10) with the quadtree intra and with fixed 8x8 intra
ADMITTED = {"rate_control", "bit_depth_10", "bit_depth_10_fixed_8x8"}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_all_intra_outside_slice_raises(frames, name):
    extra, fields = OUTSIDE[name]
    cfg = dataclasses.replace(intra_cfg(W, H, 2, *extra), **fields)
    if name in ADMITTED:
        enc, _ = encode_sequence(Reader(frames), cfg, device="cpu")
        for decode in (decode_stream, port_decode):
            decoded = decode(enc.bitstream())
            assert len(decoded) == 2 and all(f.md5_ok for f in decoded), name
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        encode_sequence(Reader(frames), cfg, device="cpu")


def test_decision_refuses_absent_cuda(monkeypatch, frames):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = intra_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        decide_intra_qt(*padded(cfg, frames[0]), cfg, QP, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_cuda_decision_equals_cpu(cuda_device, frames, variant):
    cfg = VARIANTS[variant](True)
    planes = padded(cfg, frames[0])
    want = decide_intra_qt(*planes, cfg, QP, device="cpu")
    reset_launches()
    got = decide_intra_qt(*planes, cfg, QP, device=cuda_device)
    for k in ("intra_bank", "satd35_topk", "intra_txq", "tu_bits"):
        assert LAUNCHES[k] > 0, k
    for name, g, w in zip(MAPS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.cuda
def test_cuda_all_intra_stream_equals_cpu(cuda_device, frames):
    cpu, _ = encode_sequence(Reader(frames), intra_cfg(), device="cpu")
    gpu, recons = encode_sequence(Reader(frames), intra_cfg(),
                                  device=cuda_device)
    assert gpu.bitstream() == cpu.bitstream()
    check_decodes(gpu.bitstream(), recons, 2)
