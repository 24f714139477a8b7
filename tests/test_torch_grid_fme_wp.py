"""The grid step's DCT-IF FME, explicit weighted prediction and the
no-recon-fetch tail of tpuhevc_torch against tpuhevc's (JAX on the CPU)
at 128x64:

- `grid_subpel` (plain) equals `inter_grid._PROBES["subpel_refine"]` bit
  for bit for S = 8, 16 and 32, with MVs at the refine's clamp
  +-(sr_full + 3) among them (every read inside the phase planes);
- the weighted phase planes of `grid_planes` (plain) equal
  `luma_planes_all` / `chroma_planes_all` with `wpy` / `wpc` for denoms
  5-7 and negative offsets, and identity weights give the unweighted
  planes; the weighted full-pel ME stack of `grid_wp_me` equals tpuhevc's
  `codec/wp.py:weight_fullpel_np` (the same formula), and the port's copy
  of `analyse_slice_wp` equals tpuhevc's on `make_fade_clip`;
- without the recon fetch (the checksum hash, bench.py's configuration)
  the port's stream equals its fetch-path stream byte for byte, the rows
  carry no recon, their checksums equal tpuhevc's host `picture_checksum`
  of the fetch run's recon and their SSEs the exact sums (each below
  2^24, where XLA's float32 sum is exact too), and the stream decodes
  with every checksum OK in tpuhevc's decoder;
- end to end, FmeMode dctif with WeightedPredP 1 on three pictures of
  `make_fade_clip`, two references, a flat QP: the packed rows and the
  stream equal tpuhevc's, both decoders decode every hash OK, and the
  stream holds fractional MVs and non-identity weights;
- `check_slice` admits DCT-IF, weighted prediction and the no-fetch tail
  on the grid and refuses them off it; a no-fetch run without the native
  decision walk raises;
- on a GPU, `grid_subpel`, the weighted `grid_planes`, `grid_wp_me` and
  `grid_stats` equal their plain versions at every call of a CUDA encode,
  and the CUDA streams equal the CPU streams.

tpuhevc builds one grid scan here (the end-to-end encode); each stage
check compiles the one closure it calls.
"""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import ctypes
import os

import numpy as np
import pytest
import torch

from tools.make_test_clip import make_fade_clip
from torch_port_util import (  # noqa: F401
    Reader, clip_frames, cuda_device, fresh_grid)
from tpuhevc_torch.codec import encoder as tenc
from tpuhevc_torch.codec import inter_grid as tig
from tpuhevc_torch.codec import params as tparams
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import (LdpScanDriver, check_slice,
                                         encode_sequence)
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.entropy import native
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.ops.grid_me import grid_wp_me, grid_wp_me_plain
from tpuhevc_torch.ops.grid_pred import (
    grid_planes, grid_planes_plain, grid_subpel_classes,
    grid_subpel_classes_plain, grid_subpel_plain)
from tpuhevc_torch.ops.grid_stats import (grid_stats_partial,
                                          grid_stats_partial_plain)

W, H = 128, 64
NREF = 2
FRAMES = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LDP_CFG = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def fade_frames(n, w=W, h=H):
    raw = make_fade_clip(w, h, n)
    fsz = w * h * 3 // 2
    out = []
    for i in range(n):
        b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], dtype=np.uint8)
        out.append((b[: w * h].reshape(h, w),
                    b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                    b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))
    return out


def fme_wp_cfg(port=True, wp=True, fme="dctif"):
    """LD-P at 128x64: FmeMode dctif, WeightedPredP 1, two references, a
    flat QP, RDOQ, sign hiding, deblocking and SAO off."""
    mod, kw = tparams, {}
    if not port:
        from tpuhevc.codec import params as mod

        kw = dict(inter_backend="jax")
    cfg = mod.EncoderConfig(sps=mod.SeqParams(width=W, height=H), qp=32,
                            intra_period=-1, fme_mode=fme,
                            num_ref_frames=NREF, **kw)
    cfg.pps.weighted_pred = wp
    return cfg


def anchor_cfg(path=LDP_CFG, w=W, h=H, extra=(), fetch=True):
    """A shipped cfg through the port's options at w x h, QP 32; fetch
    False as the CLI sets it without `-o`."""
    cfg, _ = build_config(parse_args(
        ["-c", path, "-wdt", str(w), "-hgt", str(h), "-f", str(FRAMES),
         "-q", "32"] + list(extra)))
    cfg.fetch_recon = fetch
    return cfg


def bench_cfg(fetch=False):
    """bench.py's configuration: the anchor cfg, FmeMode nn without
    weights (integer-pel), the checksum hash, no recon fetch."""
    return anchor_cfg(extra=["--SEIDecodedPictureHash=3"], fetch=fetch)


@pytest.fixture(scope="module")
def probes():
    """The stage closures of one tpuhevc grid build of the end-to-end
    configuration (built, not compiled), the port's GridStep of the same,
    and one picture's inputs: frame 4 of the fade clip against frames 3
    and 2 (originals standing in for their recons)."""
    from tpuhevc.codec import inter_grid as jg

    _, built = fresh_grid(jg.build_ldp_grid_scan, fme_wp_cfg(port=False), {},
                          1)
    frames = fade_frames(5)
    ry = np.stack([f[0] for f in frames[3:1:-1]]).astype(np.int32)
    ruv = np.stack([np.concatenate(f[1:], 1)
                    for f in frames[3:1:-1]]).astype(np.int32)
    return dict(P=built, step=tig.GridStep(fme_wp_cfg(), {}, "cpu"),
                oy=frames[4][0].astype(np.int32), ry=ry, ruv=ruv)


def test_subpel_refine_matches_jax(probes):
    """grid_subpel's plain version equals subpel_refine for every CU class,
    with MVs at the refine's clamp +-(sr_full + 3) in both corners."""
    import jax
    import jax.numpy as jnp

    P, step = probes["P"], probes["step"]
    lim = step.sr_full + 3
    planes = grid_planes_plain(t(probes["ry"]), True, step.PADL, step.HmL,
                               step.WmL)
    jplanes, joy = jnp.asarray(planes.numpy()), jnp.asarray(probes["oy"])
    rng = np.random.default_rng(11)
    frac = 0
    for S in (8, 16, 32):
        nbh, nbw = H // S, W // S
        mv = rng.integers(-4, 5, (nbh * nbw, 2)).astype(np.int32)
        mv[0], mv[-1] = (-lim, -lim), (lim, lim)
        mv[1], mv[-2] = (lim, -lim), (-lim, lim)
        ref = rng.integers(0, NREF, nbh * nbw).astype(np.int32)
        got = grid_subpel_plain(planes, t(probes["oy"]), t(mv), t(ref), S,
                                nbh, nbw, step.LOOK).numpy()
        want = np.asarray(jax.jit(
            lambda p, o, m, r, S=S, nbh=nbh, nbw=nbw: P["subpel_refine"](
                p, o, m, r, S, nbh, nbw))(jplanes, joy, jnp.asarray(mv),
                                          jnp.asarray(ref)))
        np.testing.assert_array_equal(got, want, f"S {S}")
        assert (got != mv * 4).any(), S
        frac += int(((got & 1) != 0).sum())
    assert frac > 0  # quarter-pel winners, not only half-pel ones


def test_wp_planes_match_jax(probes):
    """The weighted luma and chroma phase planes equal the reference's for
    denoms 5, 6 and 7 with weights around 1 << d and offsets of both signs;
    identity weights give the unweighted planes."""
    import jax
    import jax.numpy as jnp

    P, step = probes["P"], probes["step"]
    ry, ruv = t(probes["ry"]), t(probes["ruv"])
    wc = W // 2
    halves = torch.cat([ruv[:, :, :wc], ruv[:, :, wc:]], 0).contiguous()
    luma = jax.jit(lambda r, w, o, d: P["luma_planes_all"](r, (w, o, d)))
    chroma = jax.jit(lambda r, w, o, d: P["chroma_planes_all"](r, (w, o, d)))
    plain_y = grid_planes_plain(ry, True, step.PADL, step.HmL, step.WmL)
    plain_c = grid_planes_plain(halves, False, step.PADC, step.HmC, step.WmC)
    rng = np.random.default_rng(5)
    for d in (5, 6, 7):
        for ident in (False, True):
            w = np.full((NREF, 3), 1 << d, np.int32)
            o = np.zeros((NREF, 3), np.int32)
            if not ident:
                w += rng.integers(-40, 41, (NREF, 3)).astype(np.int32)
                o = rng.integers(-30, 31, (NREF, 3)).astype(np.int32)
                o[0] = (-25, -12, 9)  # negative offsets in every case
            jy = np.asarray(luma(jnp.asarray(probes["ry"]),
                                 jnp.asarray(w[:, 0]), jnp.asarray(o[:, 0]),
                                 jnp.int32(d)))
            ju, jv = (np.asarray(x) for x in chroma(
                jnp.asarray(probes["ruv"]), jnp.asarray(w[:, 1:]),
                jnp.asarray(o[:, 1:]), jnp.int32(d)))
            py = grid_planes_plain(ry, True, step.PADL, step.HmL, step.WmL,
                                   (t(w[:, 0]), t(o[:, 0]), d))
            pc = grid_planes_plain(
                halves, False, step.PADC, step.HmC, step.WmC,
                (t(np.concatenate([w[:, 1], w[:, 2]])),
                 t(np.concatenate([o[:, 1], o[:, 2]])), d))
            what = f"denom {d} identity {ident}"
            np.testing.assert_array_equal(py.numpy(), jy, "luma " + what)
            np.testing.assert_array_equal(pc[:NREF].numpy(), ju, "u " + what)
            np.testing.assert_array_equal(pc[NREF:].numpy(), jv, "v " + what)
            if ident:
                assert torch.equal(py, plain_y) and torch.equal(pc, plain_c)
            else:
                assert not torch.equal(py, plain_y), what


def test_wp_me_stack_and_analysis_match_tpuhevc(probes):
    """grid_wp_me's plain version equals tpuhevc's weight_fullpel_np per
    reference (denoms 0 and 5-7, offsets of both signs, clipping at both
    ends), and the port's analyse_slice_wp equals tpuhevc's on every
    picture of the fade clip against up to four references, some weights
    not the identity."""
    from tpuhevc.codec import wp as jwp
    from tpuhevc_torch.codec import wp as twp

    ry = probes["ry"]
    rng = np.random.default_rng(9)
    for d in (0, 5, 6, 7):
        w = ((1 << d) + rng.integers(-60, 61, NREF)).astype(np.int32)
        o = np.array([-40, 37][:NREF], np.int32)
        got = grid_wp_me_plain(t(ry), t(w), t(o), d).numpy()
        want = np.stack([jwp.weight_fullpel_np(ry[r], int(w[r]), int(o[r]), d)
                         for r in range(NREF)])
        np.testing.assert_array_equal(got, want, f"denom {d}")
        assert (got == 0).any() or (got == 255).any() or d == 0
    frames = fade_frames(9)
    seen = 0
    for poc in range(1, 9):
        refs = [frames[poc - 1 - r] for r in range(min(poc, 4))]
        a = twp.analyse_slice_wp(frames[poc], refs, bit_depth=8)
        b = jwp.analyse_slice_wp(frames[poc], refs, bit_depth=8)
        assert (a.denom_y, a.denom_c) == (b.denom_y, b.denom_c), poc
        for k in ("flags", "weights", "offsets"):
            assert np.array_equal(np.asarray(getattr(a, k)),
                                  np.asarray(getattr(b, k))), (poc, k)
        seen += a.any_present()
    assert seen > 0


def test_no_fetch_stream_equals_fetch_stream(tmp_path):
    """bench.py's configuration (the anchor cfg, the checksum hash, no
    recon fetch; FmeMode nn without weights runs integer-pel) at 128x64:
    the rows carry the device's checksums and SSEs instead of the recon,
    the checksums equal tpuhevc's host picture_checksum of the fetch run's
    recon, the SSEs the exact sums; the stream equals the fetch path's and
    decodes with every checksum OK in tpuhevc's decoder."""
    from tpuhevc.codec.decoder import decode_stream as jax_decode
    from tpuhevc.utils.yuv import picture_checksum

    frames = clip_frames(W, H, FRAMES)
    fetch, nofetch = bench_cfg(fetch=True), bench_cfg()
    assert fetch.hash_type == nofetch.hash_type == "checksum"
    assert fetch.fetch_recon and not nofetch.fetch_recon
    rows = []
    real = tig.assemble_grid_frame

    def recorded(cfg, buf, *a, **kw):
        rows.append(np.array(buf, np.uint8))
        return real(cfg, buf, *a, **kw)

    a, recons = encode_sequence(Reader(frames), fetch, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tig, "assemble_grid_frame", recorded)
        b, none = encode_sequence(Reader(frames), nofetch, device="cpu")
    assert a.bitstream() == b.bitstream()
    assert none[0] is not None and all(r is None for r in none[1:])
    nbytes = tig.frame_bytes(nofetch)
    assert nbytes == tig.frame_bytes(fetch) - W * H * 3 // 2 + 24
    assert len(rows) == FRAMES - 1 and all(r.size == nbytes for r in rows)
    for j, row in enumerate(rows):
        d = tig._parse_frame_buf(nofetch, row)
        assert "rec_y" not in d
        ry, ru, rv = recons[j + 1]
        want = picture_checksum(ry, ru, rv, 8)
        assert [int(np.uint32(c)).to_bytes(4, "big") for c in d["cks"]] \
            == list(want), j + 1
        y, u, v = frames[j + 1]
        exact = [int(((p.astype(np.int64) - r) ** 2).sum())
                 for p, r in ((y, ry), (u, ru), (v, rv))]
        assert max(exact) < 1 << 24  # XLA's float32 sum is exact here too
        assert d["sse"].tolist() == exact, j + 1
    dec = jax_decode(b.bitstream())
    assert len(dec) == FRAMES and all(f.md5_ok for f in dec)


def test_e2e_dctif_wp_matches_jax_and_decodes():
    """FmeMode dctif and WeightedPredP 1 end to end: the packed rows and
    the stream equal tpuhevc's, both decoders decode every hash OK with
    the encoder's recon, and the stream holds quarter- and half-pel MVs
    and slices with non-identity weights."""
    from tpuhevc.codec import inter_grid as jg
    from tpuhevc.codec.decoder import decode_stream as jax_decode
    from tpuhevc.codec.encoder import encode_sequence as jax_encode

    frames = fade_frames(FRAMES)
    rows = {"jax": [], "port": []}
    wps = []

    def recorder(mod, key):
        real = mod.assemble_grid_frame

        def wrapped(cfg, buf, *a, **kw):
            rows[key].append(np.array(buf, np.uint8))
            return real(cfg, buf, *a, **kw)
        return wrapped

    real_wp = tenc.analyse_slice_wp

    def analysed(*a, **kw):
        out = real_wp(*a, **kw)
        wps.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jg, "assemble_grid_frame", recorder(jg, "jax"))
        mp.setattr(tig, "assemble_grid_frame", recorder(tig, "port"))
        mp.setattr(tenc, "analyse_slice_wp", analysed)
        (enc_j, _), _ = fresh_grid(jax_encode, Reader(frames),
                                   fme_wp_cfg(port=False), max_frames=FRAMES)
        enc_t, recons = encode_sequence(Reader(frames), fme_wp_cfg(),
                                        max_frames=FRAMES, device="cpu")
    cfg = fme_wp_cfg()
    assert len(rows["port"]) == len(rows["jax"]) == FRAMES - 1
    frac = 0
    for j, (a, b) in enumerate(zip(rows["port"], rows["jax"])):
        assert a.tobytes() == b.tobytes(), f"picture {j + 1}"
        frac += int((tig._parse_frame_buf(cfg, a)["mv_map"] & 3).any(-1)
                    .sum())
    assert frac > 0
    assert any(w.any_present() and any(
        wt[0] != 1 << w.denom_y or o[0] != 0
        for wt, o in zip(w.weights, w.offsets)) for w in wps)
    assert enc_t.bitstream() == enc_j.bitstream()
    for dec in (decode_stream, jax_decode):
        out = dec(enc_t.bitstream())
        assert len(out) == FRAMES and all(f.md5_ok for f in out)
    for f, (ry, ru, rv) in zip(decode_stream(enc_t.bitstream()), recons):
        np.testing.assert_array_equal(f.y, ry[:H, :W])
        np.testing.assert_array_equal(f.u, ru[: H // 2, : W // 2])
        np.testing.assert_array_equal(f.v, rv[: H // 2, : W // 2])


def test_check_slice_admits_on_the_grid_only(monkeypatch):
    """check_slice admits the anchor cfg with FmeMode dctif, with
    WeightedPredP 1 (either FME mode) and bench.py's no-fetch checksum
    configuration on the grid (128x64), and DCT-IF off the grid (112x72:
    the host tool stage) and in random access; it refuses weighted
    prediction off the grid (112x72, and with IntraPeriod 4) and in
    random access, and WeightedPredB anywhere, naming each; a no-fetch
    run without the native decision walk raises."""
    admitted = [anchor_cfg(extra=["--FmeMode=dctif"]),
                anchor_cfg(extra=["--WeightedPredP=1"]),
                anchor_cfg(extra=["--WeightedPredP=1", "--FmeMode=dctif"]),
                bench_cfg()]
    for cfg in admitted:
        check_slice(cfg)
        assert tig.supports(cfg)
    for cfg in (anchor_cfg(w=112, h=72, extra=["--FmeMode=dctif"]),
                anchor_cfg(RA_CFG, extra=["--FmeMode=dctif"])):
        check_slice(cfg)
    refused = {
        "weighted prediction at 112x72": anchor_cfg(
            w=112, h=72, extra=["--WeightedPredP=1"]),
        "weighted prediction off the grid": anchor_cfg(
            extra=["--WeightedPredP=1", "--IntraPeriod=4"]),
        "weighted prediction in random access": anchor_cfg(
            RA_CFG, extra=["--WeightedPredP=1"]),
        "WeightedPredB": anchor_cfg(extra=["--WeightedPredB=1"]),
    }
    for name, cfg in refused.items():
        with pytest.raises(NotImplementedError, match=name):
            check_slice(cfg)

    class Enc:
        ctx_feedback: dict = {}

        def _nn_for_qp(self, qp):
            return None

    real = ctypes.CDLL(native._lib_path())

    class NoWalk:
        def __init__(self, path):
            self._lib = real

        def __getattr__(self, name):
            if name.startswith("tpuhevc_decision_walk"):
                raise AttributeError(name)
            return getattr(self._lib, name)

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.ctypes, "CDLL", NoWalk)
    with pytest.raises(AttributeError, match="decision_walk"):
        LdpScanDriver(Enc(), bench_cfg(), [None, None], None, "cpu")


# --- the kernels on the card -------------------------------------------------

def _checked(name, kern, plain, seen):
    def wrapped(*a):
        out = kern(*a)
        want = plain(*a)
        for x, y in zip(out if isinstance(out, (tuple, list)) else (out,),
                        want if isinstance(want, (tuple, list)) else (want,)):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        seen[name] += 1
        return out
    return wrapped


@pytest.mark.cuda
def test_cuda_fme_wp_kernels_match_plain(cuda_device):
    """grid_subpel, the weighted grid_planes, grid_wp_me and grid_stats
    equal their plain versions at every call of CUDA encodes: the
    end-to-end dctif + WP configuration, and bench.py's no-fetch one."""
    seen = dict.fromkeys(("grid_subpel", "grid_planes", "grid_wp_me",
                          "grid_stats"), 0)
    reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        for name, fn, kern, plain in (
                ("grid_subpel", "grid_subpel_classes", grid_subpel_classes,
                 grid_subpel_classes_plain),
                ("grid_planes", "grid_planes", grid_planes, grid_planes_plain),
                ("grid_wp_me", "grid_wp_me", grid_wp_me, grid_wp_me_plain),
                ("grid_stats", "grid_stats_partial", grid_stats_partial,
                 grid_stats_partial_plain)):
            mp.setattr(tig, fn, _checked(name, kern, plain, seen))
        encode_sequence(Reader(fade_frames(FRAMES)), fme_wp_cfg(),
                        device=cuda_device)
        encode_sequence(Reader(clip_frames(W, H, FRAMES)), bench_cfg(),
                        device=cuda_device)
    assert all(LAUNCHES[k] > 0 for k in seen), LAUNCHES
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.cuda
def test_cuda_fme_wp_and_no_fetch_streams_match_cpu(cuda_device):
    """The CUDA streams equal the CPU streams for dctif + WP and for the
    no-fetch configuration."""
    for frames, make in ((fade_frames(FRAMES), fme_wp_cfg),
                         (clip_frames(W, H, FRAMES), bench_cfg)):
        a, _ = encode_sequence(Reader(frames), make(), device=cuda_device)
        b, _ = encode_sequence(Reader(frames), make(), device="cpu")
        assert a.bitstream() == b.bitstream()
