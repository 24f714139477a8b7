"""Random access (hierarchical B) through tpuhevc_torch against tpuhevc
(JAX on the CPU) at 64x48, QP 32, cfg/encoder_randomaccess_main.cfg as
shipped, seeded NN-FME weights:

- the port's B step equals `inter_b._b_step` bit for bit (MVs, inter_dir,
  levels and recon of every plane) at one QP, and the port's per-frame P
  stage's packed row equals `inter_enc._stage_fn`'s for the P tail;
- six frames end to end (IDR, B pictures 4, 2, 1, 3 and the P tail 5)
  give a stream byte-identical to tpuhevc's default jax-backend encode,
  which both decoders decode with every hash OK;
- `mc14` and `bi_average` equal tpuhevc's on every phase; a size not in
  whole 16x16 blocks raises; RDOQ, sign hiding, deblocking, SAO and
  DCT-IF, admitted since the per-picture P path, encode on the CPU and
  decode with every hash OK;
- the B search keeps the first index among equal costs and reads the 3x3
  surface at clipped flat indices, wrapping at the window's edge, as an
  independent numpy twin of `dense_me` does, also on seeded planes at sr
  4;
- on a GPU, the three B kernels and K1 without row subsampling equal their
  plain versions (b_me at sr 4, 7 and 16, with its ties and edge
  planes), and the CUDA stream equals the CPU stream.

The JAX reference is encoded once per module; the stage tests reuse its
compiled B step and P stage (same weights object, same configuration).
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    QP, Reader, clip_frames, cuda_device, rng_planes, write_weights)
from tpuhevc.codec.decoder import decode_stream as jax_decode_stream
from tpuhevc_torch.codec import inter_b as tib
from tpuhevc_torch.codec import inter_enc as tie
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams, p_frame_lambda
from tpuhevc_torch.codec.recon import _pad_to
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.entropy.bitest import FracBits, est_tables
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.ops.interp import b_pred, b_pred_plain, bi_average, mc14
from tpuhevc_torch.ops.me import (
    b_me, b_me_plain, b_mv_bits, bits_table, sad_search,
    sad_search_classes_plain)
from tpuhevc_torch.ops.txq import b_txq, b_txq_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")
W, H, N = 64, 48, 6  # whole 16x16 blocks: the B step's tiling
SR = 16  # max(4, min(SearchRange 64, 16))
B_OUTS = ("mvq0", "mvq1", "inter_dir", "lvl_y", "rec_y", "lvl_u", "rec_u",
          "lvl_v", "rec_v")


def ra_args(npz, w=W, h=H, n=N):
    return ["-c", RA_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(n),
            "-q", str(QP), f"--NNWeightsDir={npz}"]


def port_cfg(npz, **kw):
    """The port's EncoderConfig through the port's options."""
    cfg, _ = build_config(parse_args(ra_args(npz, **kw)))
    return cfg


def jax_cfg(npz):
    """tpuhevc's EncoderConfig through tpuhevc's options, on its default
    (jax) backend, as `python -m tpuhevc enc` runs it."""
    from tpuhevc.config.options import build_config as jbuild
    from tpuhevc.config.options import parse_args as jparse

    cfg, _ = jbuild(jparse(ra_args(npz)))
    return dataclasses.replace(cfg, inter_backend="jax")


@pytest.fixture(scope="module")
def ra(tmp_path_factory):
    from tpuhevc.codec.encoder import encode_sequence as jax_encode_sequence

    npz = write_weights(tmp_path_factory.mktemp("nnfme") / "w.npz")
    frames = clip_frames(W, H, N)
    enc, recons = jax_encode_sequence(Reader(frames), jax_cfg(npz))
    assert enc.nn_params is not None  # NN-FME really ran
    by_poc = {r.poc: rec for r, rec in zip(enc.results, recons)}
    return dict(npz=npz, frames=frames, enc=enc, by_poc=by_poc)


def padded(frame):
    return [_pad_to(np.asarray(p), H >> s, W >> s).astype(np.int32)
            for p, s in zip(frame, (0, 1, 1))]


def test_b_step_matches_jax(ra):
    """POC 2 (QP 34, between POC 0 and POC 4) from the reference's own
    recons: every output of the port's B step equals `_b_step`'s."""
    from tpuhevc.codec import inter_b as jib

    enc = ra["enc"]
    qp = QP + 2
    ins = padded(ra["frames"][2]) + [
        np.asarray(p, np.int32) for poc in (0, 4) for p in ra["by_poc"][poc]]
    want = jib._b_step(enc.cfg, qp, enc.nn_params)(*ins)
    got = tib.build_b_step(port_cfg(ra["npz"]), qp, enc.nn_params, "cpu")(
        *(torch.from_numpy(a) for a in ins))
    for name, g, w in zip(B_OUTS, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert set(got[2].numpy().tolist()) <= {1, 2, 3}
    assert (got[0].numpy() % 4).any()  # quarter-pel MVs from NN-FME


def test_p_stage_matches_jax(ra):
    """The P tail (POC 5, QP 35, from the recon of POC 4): the port's
    packed row and recon planes equal `_stage_fn`'s byte for byte."""
    from tpuhevc.codec import inter_enc as jie

    enc = ra["enc"]
    qp = QP + 3
    jcfg = dataclasses.replace(enc.cfg, qp=qp,
                               frame_lambda=p_frame_lambda(enc.cfg, 0, qp))
    lambda_fp = int(round(np.sqrt(jcfg.frame_lambda) * 256))
    ins = padded(ra["frames"][5]) + [np.asarray(p, np.int32)
                                     for p in ra["by_poc"][4]]
    jfn, _ = jie._stage_fn(jcfg, enc.nn_params, lambda_fp)
    want = [np.asarray(x) for x in jfn(*ins)]
    tcfg = port_cfg(ra["npz"])
    tcfg = dataclasses.replace(tcfg, qp=qp,
                               frame_lambda=p_frame_lambda(tcfg, 0, qp))
    tfn, grids = tie.build_stage(tcfg, enc.nn_params, lambda_fp, "cpu")
    got = [x.numpy() for x in tfn(*(torch.from_numpy(a) for a in ins))]
    assert got[0].dtype == np.uint8
    assert got[0].tobytes() == want[0].tobytes()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert grids[1] or grids[2]  # 16x16 classes were coded


def test_e2e_stream_matches_jax_and_decodes(ra):
    enc, recons = encode_sequence(Reader(ra["frames"]), port_cfg(ra["npz"]),
                                  device="cpu")
    stream = enc.bitstream()
    assert [r.poc for r in enc.results] == [0, 4, 2, 1, 3, 5]
    assert stream == ra["enc"].bitstream()
    for decode in (decode_stream, jax_decode_stream):
        decoded = decode(stream)
        assert [f.poc for f in decoded] == [0, 4, 2, 1, 3, 5]
        assert all(f.md5_ok for f in decoded)
        for f, (ry, ru, rv) in zip(decoded, recons):
            np.testing.assert_array_equal(f.y, ry[:H, :W])
            np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
            np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


@pytest.mark.parametrize("luma", [True, False])
def test_mc14_and_bi_average_match_jax(luma):
    """The 14-bit prediction and the bi-average, against
    `tpuhevc.ops.interp.mc14` / `bi_average` on the same planes and MVs
    (every phase, positions at the plane's edges)."""
    import jax.numpy as jnp

    from tpuhevc.ops import interp as jinterp

    size = 16 if luma else 8
    planes = rng_planes(9, 48 if luma else 24, 64 if luma else 32, 2)
    rng = np.random.default_rng(9)
    n = 40
    xs = rng.integers(0, planes.shape[2] - size + 1, n).astype(np.int32)
    ys = rng.integers(0, planes.shape[1] - size + 1, n).astype(np.int32)
    mvs = [rng.integers(-70, 71, (n, 2)).astype(np.int32) for _ in range(2)]
    got, want = [], []
    for p, mv in zip(planes, mvs):
        got.append(mc14(torch.from_numpy(p), torch.from_numpy(xs),
                        torch.from_numpy(ys), torch.from_numpy(mv), size,
                        luma))
        want.append(jinterp.mc14(jnp.asarray(p), jnp.asarray(xs),
                                 jnp.asarray(ys), jnp.asarray(mv), size,
                                 luma, 8))
        np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    np.testing.assert_array_equal(bi_average(*got).numpy(),
                                  np.asarray(jinterp.bi_average(*want, 8)))


RA_OUTSIDE = {  # name: (extra cfg options, size)
    "size_112x72": ([], (112, 72)),  # the B step tiles in 16x16 blocks
    "rdoq": (["--RDOQ=1"], (W, H)),
    "sign_hiding": (["--SignHideFlag=1"], (W, H)),
    "deblocking": (["--LoopFilterDisable=0"], (W, H)),
    "sao": (["--SAO=1"], (W, H)),
    "dctif": (["--FmeMode=dctif"], (W, H)),
}


RA_ADMITTED = {"rdoq", "sign_hiding", "deblocking", "sao", "dctif"}


@pytest.mark.parametrize("name", sorted(RA_OUTSIDE))
def test_ra_outside_slice_raises(tmp_path, name):
    extra, (w, h) = RA_OUTSIDE[name]
    cfg, _ = build_config(parse_args(
        ra_args(str(tmp_path / "none.npz"), w, h) + extra))
    if name in RA_ADMITTED:
        enc, _ = encode_sequence(Reader(clip_frames(w, h, N)), cfg,
                                 device="cpu")
        decoded = decode_stream(enc.bitstream())
        assert len(decoded) == N and all(f.md5_ok for f in decoded), name
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        encode_sequence(Reader(clip_frames(w, h, N)), cfg, device="cpu")


def dense_me_np(org, ref, lam_me, sr):
    """An independent numpy twin of `dense_me` (inter_b.py:142-163): the
    SADs against the edge-padded reference, float32 costs, the first
    argmin, and the 3x3 surface at clipped flat indices."""
    h, w = org.shape
    side = 2 * sr + 1
    n = (h // 16) * (w // 16)
    ryp = np.pad(ref, sr, mode="edge").astype(np.int64)
    sad = np.empty((n, side * side), np.int64)
    for dy in range(side):
        for dx in range(side):
            d = np.abs(ryp[dy : dy + h, dx : dx + w] - org)
            sad[:, dy * side + dx] = d.reshape(h // 16, 16, w // 16,
                                               16).sum((1, 3)).reshape(n)
    cost = sad.astype(np.float32) + np.float32(lam_me) * b_mv_bits(sr)
    bi = cost.argmin(1)
    nbr9 = np.array([dy * side + dx for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)])
    i9 = np.clip(bi[:, None] + nbr9, 0, side * side - 1)
    mv = np.stack([bi % side - sr, bi // side - sr], -1)
    return mv, np.take_along_axis(sad, i9, 1), bi, sad


def edge_planes(shift):
    """org textured; ref the org rolled so that the block at (32, 16)
    matches exactly at horizontal offset -shift (shift = 16: the window's
    left column; -16: its right column)."""
    org = rng_planes(5, H, W)[0]
    return org, np.roll(org, -shift, axis=1)


@pytest.mark.parametrize("case", ["all_equal", "left_edge", "right_edge",
                                  "seeded_sr4"])
def test_b_me_ties_and_wrapped_surface(case):
    sr, lam, ref1 = SR, 0.0, None
    if case == "all_equal":
        org = np.full((H, W), 100, np.int32)
        ref = np.full((H, W), 97, np.int32)
    elif case == "seeded_sr4":  # two seeded lists at the least sr
        sr, lam = 4, 5.7
        org, ref, ref1 = rng_planes(21, H, W, 3)
    else:
        org, ref = edge_planes(SR if case == "left_edge" else -SR)
    refs = (ref, ref if ref1 is None else ref1)
    mv, sad9 = b_me_plain(torch.from_numpy(org), torch.from_numpy(refs[0]),
                          torch.from_numpy(refs[1]), lam, sr)
    for lst in (0, 1):
        want_mv, want_sad9, bi, sad = dense_me_np(org, refs[lst], lam, sr)
        np.testing.assert_array_equal(mv[lst].numpy(), want_mv)
        np.testing.assert_array_equal(sad9[lst].numpy(), want_sad9)
    if case == "seeded_sr4":
        return
    side = 2 * SR + 1
    if case == "all_equal":  # every cost ties: the first offset wins
        assert (bi == 0).all()
        assert mv[0].tolist() == [[-SR, -SR]] * mv.shape[1]
    else:
        blk = (16 // 16) * (W // 16) + 32 // 16  # the block at (32, 16)
        col = 0 if case == "left_edge" else side - 1
        assert bi[blk] == SR * side + col and sad[blk, bi[blk]] == 0
        # the neighbour beyond the edge is read from the adjacent row
        k, j = (3, bi[blk] - 1) if col == 0 else (5, bi[blk] + 1)
        assert sad9[0, blk, k] == sad[blk, j]


def test_b_me_names_its_bit_depth():
    """b_me has a variant a bit depth (8: samples packed four to a word,
    10: two): its callers name the depth, 8 and 10 are taken, any other
    raises (on either device); the B step at 10 bits builds and runs."""
    org, ref = (torch.from_numpy(p) for p in rng_planes(3, H, W, 2))
    with pytest.raises(TypeError):
        b_me(org, ref, ref, 0.0, SR)
    for bd in (8, 10):
        mv, _ = b_me(org, ref, ref, 0.0, SR, bit_depth=bd)
        assert torch.equal(mv, b_me_plain(org, ref, ref, 0.0, SR)[0])
    for bd in (9, 12):
        with pytest.raises(ValueError, match=f"bit depth {bd}"):
            b_me(org, ref, ref, 0.0, SR, bit_depth=bd)
    cfg = EncoderConfig(sps=SeqParams(width=W, height=H, bit_depth=10),
                        qp=QP, gop_structure="ra")
    step = tib.build_b_step(cfg, QP, None, "cpu")
    planes = [torch.from_numpy(p * 4) for p in rng_planes(5, H, W, 3)]
    chroma = [p[::2, ::2].contiguous() for p in planes]
    out = step(planes[0], chroma[0], chroma[0], planes[1], chroma[1],
               chroma[1], planes[2], chroma[2], chroma[2])
    assert int(out[4].max()) > 255  # the luma recon at 10 bits


def b_inputs(dev, w=416, h=240, seed=11):
    """Planes of a natural spread and the step's intermediate MVs."""
    org, r0, r1 = (torch.from_numpy(p).to(dev)
                   for p in rng_planes(seed, h, w, 3))
    rng = np.random.default_rng(seed)
    n = (h // 16) * (w // 16)
    mvq = torch.from_numpy(rng.integers(-70, 71, (2, n, 2)).astype(
        np.int32)).to(dev)
    return org, r0, r1, mvq


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [4, 7, 16])
def test_cuda_b_me_matches_plain(cuda_device, sr):
    """b_me (packed bytes, the block in registers) against plain at the
    B step's least, an odd and its largest search range: seeded planes at
    three lambdas, then the ties (flat planes, lambda 0: every cost
    equal) and the matches at the window's left and right edge."""
    org, r0, r1, _ = b_inputs(cuda_device)
    for lam_me in (0.0, 5.7, 40.3):
        got = b_me(org, r0, r1, lam_me, sr, bit_depth=8)
        want = b_me_plain(org, r0, r1, lam_me, sr)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), lam_me
    for case in ("all_equal", "left_edge", "right_edge"):
        o, r = (np.full((H, W), 100, np.int32), np.full((H, W), 97, np.int32)) \
            if case == "all_equal" else edge_planes(sr if case == "left_edge"
                                                    else -sr)
        o, r = (torch.from_numpy(p).to(cuda_device) for p in (o, r))
        got = b_me(o, r, r, 0.0, sr, bit_depth=8)
        want = b_me_plain(o, r, r, 0.0, sr)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), case


@pytest.mark.cuda
def test_b_kernels_match_plain(cuda_device):
    org, r0, r1, mvq = b_inputs(cuda_device)
    h, w = org.shape
    n_w = w // 16
    blk = torch.arange(mvq.shape[1], device=cuda_device, dtype=torch.int32)
    xs, ys = (blk % n_w) * 16, (blk // n_w) * 16
    cur = (org.reshape(h // 16, 16, n_w, 16).permute(0, 2, 1, 3)
           .reshape(-1, 16, 16).contiguous())
    m0, m1 = mvq[0].contiguous(), mvq[1].contiguous()
    for lam in (0.0, 63.9, 900.0):
        got = b_pred(cur, r0, r1, xs, ys, m0, m1, 16, True, lam)
        want = b_pred_plain(cur, r0, r1, xs, ys, m0, m1, 16, True, lam)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), lam
    dirs = got[1]
    assert {1, 2, 3} <= set(dirs.tolist())
    cplane = r1[: h // 2, : w // 2].contiguous()
    got = b_pred(None, cplane, cplane.flip(0).contiguous(), xs // 2, ys // 2,
                 m0, m1, 8, False, inter_dir=dirs)
    want = b_pred_plain(None, cplane, cplane.flip(0).contiguous(), xs // 2,
                        ys // 2, m0, m1, 8, False, inter_dir=dirs)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    pred = want[0]
    for qp in (22, 34, 45):
        fb = FracBits(0, qp)
        for size, luma in ((16, True), (8, False)):
            c = cur if size == 16 else cur[:, ::2, ::2].contiguous()
            p = b_pred_plain(c, r0, r1, xs // (16 // size), ys // (16 // size),
                             m0, m1, size, luma, 50.0)[0] \
                if size == 16 else pred
            est = est_tables(fb, size.bit_length() - 1, luma, cuda_device)
            for lam in (13.7, 57.1):
                got = b_txq(c, p, qp, lam, est)
                want = b_txq_plain(c, p, qp, lam, est)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (qp, size, lam)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 16, 32])
def test_sad_search_without_subsampling_matches_plain(cuda_device, size):
    from tpuhevc_torch.codec.inter_batch import _blk_idx

    ref, cur_plane = rng_planes(3, 240, 416, 2)
    poss = [(x, y) for y in range(0, 240 - size + 1, size)
            for x in range(0, 416 - size + 1, size)]
    ref_d = torch.from_numpy(ref).to(cuda_device)
    cur = torch.from_numpy(cur_plane.reshape(-1)[_blk_idx(poss, size, 416)]
                           ).to(cuda_device)
    xs, ys = (torch.tensor([p[i] for p in poss], dtype=torch.int32,
                           device=cuda_device) for i in (0, 1))
    bits = bits_table(SR, cuda_device)
    for lam_me in (0, 700):
        got = sad_search(ref_d, cur, xs, ys, bits, lam_me, SR, False,
                         bit_depth=8)
        want = sad_search_classes_plain(ref_d, [(cur, xs, ys)], bits, lam_me,
                                        SR, False)[0]
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_ra_stream_equals_cpu_and_launches_its_kernels(cuda_device,
                                                            tmp_path):
    npz = write_weights(tmp_path / "w.npz")
    frames = clip_frames(W, H, N)
    cpu, _ = encode_sequence(Reader(frames), port_cfg(npz), device="cpu")
    reset_launches()
    gpu, _ = encode_sequence(Reader(frames), port_cfg(npz),
                             device=cuda_device)
    for k in ("b_me", "b_pred", "b_txq", "nnfme_mlp", "sad_search",
              "mc_blk", "txq"):
        assert LAUNCHES[k] > 0, k
    assert gpu.bitstream() == cpu.bitstream()
