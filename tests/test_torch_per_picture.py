"""The per-picture LD-P loop of tpuhevc_torch against tpuhevc (JAX on the
CPU): each stream byte-identical to tpuhevc's, and every picture hash OK
in the port's decoder and in tpuhevc's, the recon equal to the encoder's.

- the anchor cfg (cfg/encoder_lowdelay_P_main.cfg: RDOQ, sign hiding,
  deblocking, SAO) as shipped at 112x72 x 5, a size the grid does not
  take: the P pictures through the host tool stage;
- IntraPeriod 4 with the anchor's tools at 64x48 x 6 (I pictures at 0
  and 4, the second with the recovery-point SEI).

tpuhevc encodes on its jax backend (`python -m tpuhevc enc`'s). Rate
control has its own file, `test_torch_rate_control.py`.
"""

import dataclasses
import os

import numpy as np
import pytest

from torch_port_util import QP, Reader, clip_frames, write_weights
from tpuhevc_torch.codec import encoder as tenc
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.config.options import build_config, parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LDP_CFG = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")
# name: (w, h, frames, extra options)
ROUTES = {
    "anchor_112x72": (112, 72, 5, []),
    "intra_period_4": (64, 48, 6, ["--IntraPeriod=4"]),
}


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")


def args(npz, w, h, n, extra):
    return (["-c", LDP_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(n),
             "-q", str(QP), f"--NNWeightsDir={npz}"] + list(extra))


@pytest.mark.parametrize("name", list(ROUTES))
def test_per_picture_stream_matches_tpuhevc(npz, name):
    from tpuhevc.codec.decoder import decode_stream as jax_decode
    from tpuhevc.codec.encoder import encode_sequence as jax_encode
    from tpuhevc.config.options import build_config as jbuild
    from tpuhevc.config.options import parse_args as jparse

    w, h, n, extra = ROUTES[name]
    frames = clip_frames(w, h, n)
    jcfg, _ = jbuild(jparse(args(npz, w, h, n, extra)))
    jcfg = dataclasses.replace(jcfg, inter_backend="jax")
    want, _ = jax_encode(Reader(frames), jcfg)
    assert want.nn_params is not None  # NN-FME really ran
    cfg, _ = build_config(parse_args(args(npz, w, h, n, extra)))
    assert not tenc._takes_scan(cfg)  # the per-picture loop
    got, recons = tenc.encode_sequence(Reader(frames), cfg, device="cpu")
    stream = got.bitstream()
    assert stream == want.bitstream(), name
    for decode in (decode_stream, jax_decode):
        decoded = decode(stream)
        assert len(decoded) == n and all(f.md5_ok for f in decoded), name
    for f, (ry, ru, rv) in zip(decode_stream(stream), recons):
        np.testing.assert_array_equal(f.y, ry[:h, :w])
        np.testing.assert_array_equal(f.u, ru[: h // 2, : w // 2])
        np.testing.assert_array_equal(f.v, rv[: h // 2, : w // 2])
