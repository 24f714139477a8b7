"""Rate control in tpuhevc_torch against tpuhevc (JAX on the CPU).

- `codec/ratectrl.py` (`RateControl`, `CtuAlloc`) is tpuhevc's model: the
  same QPs, lambdas, targets and CTU QP maps over a run of pictures fed
  the same bits;
- picture level (RateControl 1) on the anchor LD-P cfg with its four
  tools cut at 64x48 x 6: the P pictures through the device stage, the
  stream byte-identical to tpuhevc's on its jax backend;
- CTU level (LCULevelRateControl 1) at 128x64 x 4, two CTUs a picture,
  some picture at two QPs: on the anchor as shipped the stream equals
  tpuhevc's jax-backend stream (its tools send every P picture to the
  numpy stage, which quantises with the map); with the tools cut the
  port sends each picture with a map to the host stage, and equals
  tpuhevc with those pictures on its numpy stage (`inter_backend="np"`'s
  route), while tpuhevc's own jax-backend stream, whose device stage
  ignores the map its stream signals, fails its hashes from the first P
  picture (pinned here; the port does not copy it).

Every port stream decodes with every hash OK in both decoders.
"""

import dataclasses
import os

import numpy as np
import pytest

from torch_port_util import QP, Reader, clip_frames, write_weights
from tpuhevc_torch.codec import encoder as tenc
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.ratectrl import CtuAlloc, RateControl
from tpuhevc_torch.config.options import build_config, parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LDP_CFG = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")
CUT = ["--RDOQ=0", "--SignHideFlag=0", "--LoopFilterDisable=1", "--SAO=0"]
RC = ["--RateControl=1", "--TargetBitrate=200000"]
# a target that leaves the P pictures above the 100-bit floor at 128x64,
# so the allocator's CTU QPs differ
CTU = ["--RateControl=1", "--TargetBitrate=600000",
       "--LCULevelRateControl=1"]

# name: (w, h, frames, extra options)
CASES = {
    "picture_tools_cut": (64, 48, 6, CUT + RC),
    "ctu_anchor": (128, 64, 4, CTU),
    "ctu_tools_cut": (128, 64, 4, CUT + CTU),
}


def half_static(frames):
    """The clip with its left 64 columns held at the first picture's: the
    left CTU still, the right one moving, so CTU activities differ."""
    y0, u0, v0 = frames[0]
    out = []
    for y, u, v in frames:
        y, u, v = y.copy(), u.copy(), v.copy()
        y[:, :64], u[:, :32], v[:, :32] = y0[:, :64], u0[:, :32], v0[:, :32]
        out.append((y, u, v))
    return out


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")


def args(npz, w, h, n, extra):
    return (["-c", LDP_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(n),
             "-q", str(QP), f"--NNWeightsDir={npz}"] + list(extra))


def test_model_matches_tpuhevc():
    """Both models over 12 pictures (an I picture, then P), fed the same
    bits; both allocators' weights and QP maps at each P picture."""
    from tpuhevc.codec import ratectrl as jrc

    frames = clip_frames(200, 100, 12)
    models = [RateControl(300000, 50, 200, 100, 4, 12),
              jrc.RateControl(300000, 50, 200, 100, 4, 12)]
    allocs = [CtuAlloc(200, 100, 64), jrc.CtuAlloc(200, 100, 64)]
    rng = np.random.default_rng(1)
    for i in range(12):
        picks = [m.pick(i, i == 0) for m in models]
        assert picks[0] == picks[1], i
        if i:
            a, b = models[0]._model(models[0]._pending[0])
            w = [al.weights(frames[i][0], frames[i - 1][0]) for al in allocs]
            np.testing.assert_array_equal(w[0], w[1])
            maps = [al.qp_map(picks[0][2], picks[0][0], a, b, w[0])
                    for al in allocs]
            np.testing.assert_array_equal(maps[0], maps[1])
        bits = int(picks[0][2] * rng.uniform(0.5, 1.6))
        for m in models:
            m.update(bits)
    assert len({p[0] for p in [m.pick(12, False) for m in models]}) == 1


@pytest.mark.parametrize("name", list(CASES))
def test_rate_control_stream_matches_tpuhevc(npz, name, monkeypatch):
    from tpuhevc.codec import inter_enc as jie
    from tpuhevc.codec.decoder import decode_stream as jax_decode
    from tpuhevc.codec.encoder import encode_sequence as jax_encode
    from tpuhevc.config.options import build_config as jbuild
    from tpuhevc.config.options import parse_args as jparse

    w, h, n, extra = CASES[name]
    frames = clip_frames(w, h, n)
    if name.startswith("ctu"):
        frames = half_static(frames)

    def reference():
        jcfg, _ = jbuild(jparse(args(npz, w, h, n, extra)))
        enc, _ = jax_encode(Reader(frames),
                            dataclasses.replace(jcfg, inter_backend="jax"))
        return enc.bitstream()

    want = reference()
    if name == "ctu_tools_cut":
        ok = [f.md5_ok for f in jax_decode(want)]
        assert ok[0] and not any(ok[1:]), ok  # tpuhevc's fault, pinned
        real = jie.encode_frame_p

        def np_for_maps(orig, ref, cfg, nn_params=None, backend="np"):
            if cfg.ctu_qp_map is not None:
                backend = "np"
            return real(orig, ref, cfg, nn_params, backend=backend)

        monkeypatch.setattr(jie, "encode_frame_p", np_for_maps)
        want = reference()
    cfg, _ = build_config(parse_args(args(npz, w, h, n, extra)))
    maps = []
    real_map = tenc.CtuAlloc.qp_map
    monkeypatch.setattr(tenc.CtuAlloc, "qp_map",
                        lambda self, *a: maps.append(real_map(self, *a))
                        or maps[-1])
    got, recons = tenc.encode_sequence(Reader(frames), cfg, device="cpu")
    stream = got.bitstream()
    assert stream == want, name
    for decode in (decode_stream, jax_decode):
        decoded = decode(stream)
        assert len(decoded) == n and all(f.md5_ok for f in decoded), name
    for f, (ry, ru, rv) in zip(decode_stream(stream), recons):
        np.testing.assert_array_equal(f.y, ry[:h, :w])
    assert len({r.bits for r in got.results}) > 1
    if name.startswith("ctu"):  # a map a P picture, some at two QPs
        assert cfg.pps.cu_qp_delta_enabled and len(maps) == n - 1
        assert any(len(np.unique(m)) > 1 for m in maps), maps
    else:
        assert not maps
