"""tpuhevc_torch.parallel against tpuhevc.parallel on the CPU, and the
kernels it adds or changes against their plain versions on the card.

- `tile_prescreen` on 8- and 1-device meshes (n x cpu) equals tpuhevc's
  on the virtual 8-device mesh at every block, stripe boundaries
  included (tests/test_parallel.py's 512x128 plane);
- `stripe_refine`'s sharded and single refines equal tpuhevc's (mv, sad9,
  cost) at tests/test_parallel.py's 128x384, SearchRange 16, 8 stripes;
- `grid_refine_plain` with `ry_y0` equals its call on the plane without
  the halo rows;
- the two segment encoders at 64x64 x 8 in 2 segments: the stitched
  stream equals each segment's own stream with the repeated parameter
  sets dropped, and decodes hash-OK in the port's decoder and tpuhevc's;
- `cuda`: stripe_prescreen (one launch a device's stripes: 416x240 in 1
  and 3, 128x128 in 2, and test_torch_prescreen.py's cases), grid_refine
  with ry_y0 and grid_sao_decide (ties, an all-off picture) equal their
  plain versions on the card.

The JAX references compile the programs tests/test_parallel.py compiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_prescreen import PRESCREEN_CASES, prescreen_case
from torch_port_util import Reader, clip_frames, cuda_device, fresh_grid, \
    ldp_cfg, rng_planes, write_weights  # noqa: F401 (a fixture)
from tpuhevc.codec.decoder import decode_stream as jax_decode
from tpuhevc.codec.params import EncoderConfig as JaxConfig
from tpuhevc.codec.params import SeqParams as JaxSeq
from tpuhevc.parallel import mesh as jax_mesh
from tpuhevc_torch.codec.decoder import decode_stream
from tpuhevc_torch.codec.encoder import encode_sequence
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams
from tpuhevc_torch.entropy import bitio
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.grid_me import grid_refine, grid_refine_plain
from tpuhevc_torch.ops.grid_sao import (
    grid_sao_decide, grid_sao_decide_plain, sao_stats_plain)
from tpuhevc_torch.ops.stripe_prescreen import (
    stripe_prescreen_rows, stripe_prescreen_rows_plain)
from tpuhevc_torch.parallel import mesh, segments

PRE_H, PRE_W = 8 * 8 * 8, 128  # 8 stripes of 8 block rows
REF_W, REF_H = 128, 384  # 8 stripes of 48 rows >= the 40-row halo


@pytest.mark.parametrize("n", [8, 1])
def test_tile_prescreen_matches_jax(n):
    plane = np.random.default_rng(0).integers(0, 256, (PRE_H, PRE_W)).astype(
        np.int32)
    want = jax_mesh.tile_prescreen(jax_mesh.make_mesh(n), PRE_H, PRE_W)(
        jnp.asarray(plane))
    got = mesh.tile_prescreen(mesh.make_mesh(n, device="cpu"), PRE_H,
                              PRE_W)(torch.as_tensor(plane))
    for g, w, what in zip(got, want, ("mode", "cost")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), what)
    assert got[0].shape == (PRE_H // 8, PRE_W // 8)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh(n)


def test_stripe_refine_matches_jax():
    kw = dict(qp=32, intra_period=-1, fme_mode="none", num_ref_frames=1,
              search_range=16)
    jcfg = JaxConfig(sps=JaxSeq(width=REF_W, height=REF_H,
                                max_tu_depth_intra=0), inter_backend="jax",
                     **kw)
    pcfg = EncoderConfig(sps=SeqParams(width=REF_W, height=REF_H,
                                       max_tu_depth_intra=0), **kw)
    (j_sh, j_one, j_halo), _ = fresh_grid(jax_mesh.stripe_refine, jcfg,
                                          {32: None}, jax_mesh.make_mesh(8))
    p_sh, p_one, p_halo = mesh.stripe_refine(
        pcfg, {32: None}, mesh.make_mesh(8, device="cpu"))
    assert p_halo == j_halo == 40
    rng = np.random.default_rng(7)
    oy = rng.integers(0, 256, (REF_H, REF_W)).astype(np.int32)
    ry = (np.roll(oy, (5, -3), (0, 1))
          + rng.integers(-4, 5, (REF_H, REF_W))).astype(np.int32)
    c4 = [rng.integers(-4, 5, (REF_H // 16, REF_W // 16)).astype(np.int32)
          for _ in range(2)]
    args = (oy, ry, *c4)
    for pf, jf, what in ((p_sh, j_sh, "sharded"), (p_one, j_one, "single")):
        got = pf(*(torch.as_tensor(a) for a in args))
        want = jf(*(jnp.asarray(a) for a in args))
        for g, w, k in zip(got, want, ("mv", "sad9", "cost")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          f"{what} {k}")
    with pytest.raises(ValueError, match="halo"):
        mesh.stripe_refine(pcfg, {32: None}, mesh.make_mesh(12, device="cpu"))


def _refine_args(seed, h, w, S, G):
    rng = np.random.default_rng(seed)
    planes = rng_planes(seed, h, w, 2)
    nb = (h // S) * (w // S)
    starts = torch.as_tensor(rng.integers(-12, 13, (G, nb, 2)),
                             dtype=torch.int32)
    return (torch.as_tensor(planes[0]), torch.as_tensor(planes[1]), starts)


def test_grid_refine_plain_ry_y0_equals_the_plane_without_halo():
    """(a) ry_y0 edge-replicated rows above the plane change nothing
    (the clamp reads row 0 either way); (b) a stripe whose halo holds the
    real rows above and below it equals the whole plane's refine at the
    stripe's block rows (every window inside the halo)."""
    h, w, S, halo = 96, 64, 16, 24
    ry, oy, starts = _refine_args(3, h, w, S, 2)
    fixed = (True, 900, 700, 380, 40)  # quads, dcc, dcc8, lam_me, lim
    whole = grid_refine_plain(ry, oy, S, h // S, w // S, starts, *fixed)
    padded = torch.cat([ry[:1].expand(halo, w), ry]).contiguous()
    got = grid_refine_plain(padded, oy, S, h // S, w // S, starts, *fixed,
                            ry_y0=halo)
    for part in (0, 1):
        for g, x in zip(got[part], whole[part]):
            assert torch.equal(g, x)
    # the middle stripe, rows 32..64, with its 24-row halo; starts within
    # +-4 keep the windows (reach 3 + 4 + 16 + 3 rows) inside it
    y0, hs = 32, 32
    nbw = w // S
    st = starts.clamp(-4, 4)
    whole = grid_refine_plain(ry, oy, S, h // S, nbw, st, *fixed)
    rows = slice(y0 // S * nbw, (y0 + hs) // S * nbw)
    sub = st[:, rows].contiguous()
    got = grid_refine_plain(ry[y0 - halo : y0 + hs + halo], oy[y0 : y0 + hs],
                            S, hs // S, nbw, sub, *fixed, ry_y0=halo)
    for g, x in zip(got[0], whole[0]):
        assert torch.equal(g, x[rows])


def test_segment_encoders_stitch_per_segment_streams(tmp_path):
    """encode_segments_parallel and encode_segments_overlapped at 64x64 x 8
    in 2 segments, on a mesh of 2 x cpu: the stream is each segment's own
    encode_sequence stream with the second's VPS, SPS and PPS dropped, and
    every picture decodes hash-OK in both decoders."""
    npz = write_weights(tmp_path / "w.npz")
    w = h = 64
    frames = clip_frames(w, h, 8)
    devs = mesh.make_mesh(2, device="cpu").devices
    assert segments.split_segments(8, 2) == [(0, 4), (4, 4)]
    encs = [encode_sequence(Reader(frames[s : s + n]),
                            ldp_cfg(npz, w, h, port=True), device="cpu")[0]
            for s, n in ((0, 4), (4, 4))]
    want = bitio.write_annexb(encs[0].nals + encs[1].nals[3:],
                              encs[0].first_of_au + encs[1].first_of_au[3:])
    assert [(n[0] >> 1) & 0x3F for n in encs[1].nals[:3]] == [
        bitio.NAL_VPS, bitio.NAL_SPS, bitio.NAL_PPS]
    for fn in (segments.encode_segments_parallel,
               segments.encode_segments_overlapped):
        stream, results = fn(frames, ldp_cfg(npz, w, h, port=True), 2, devs)
        assert stream == want, fn.__name__
        assert [r.poc for r in results] == [0, 1, 2, 3] * 2
    for decode in (decode_stream, jax_decode):
        pics = decode(want)
        assert len(pics) == 8 and all(p.md5_ok for p in pics)


# --- the kernels on the card -------------------------------------------------

@pytest.mark.cuda
def test_cuda_stripe_prescreen_matches_plain(cuda_device):
    """`stripe_prescreen_rows` (one launch a call) against its plain
    version, modes and costs exact: 416x240 in 1 and 3 stripes and the
    graft entry's 128x128 in 2 (the halo mid-grey, and a row above as on
    a later device), and test_torch_prescreen.py's cases (width 72, bit
    depth 10, flat planes at 0 and the maximum); `tile_prescreen` on 1 x
    and 3 x the card, one launch a call, equal off the stripes' last
    block rows."""
    plane = torch.as_tensor(rng_planes(5, 240, 416)[0], device=cuda_device)
    graft = torch.as_tensor(rng_planes(6, 128, 128)[0], device=cuda_device)
    row = torch.as_tensor(rng_planes(7, 1, 416)[0], device=cuda_device)
    calls = [(plane, None, 240, 8), (plane, None, 80, 8),
             (plane, row, 80, 8), (graft, None, 64, 8),
             (graft, row[:, :128].contiguous(), 64, 8)]
    for case in PRESCREEN_CASES:
        rows, halo = prescreen_case(*case)
        calls.append((rows.to(cuda_device),
                      None if halo is None else halo.to(cuda_device),
                      case[1], case[3]))
    for rows, halo, hl, bd in calls:
        before = LAUNCHES["stripe_prescreen"]
        got = stripe_prescreen_rows(rows, halo, hl, bd)
        assert LAUNCHES["stripe_prescreen"] == before + 1
        for g, x in zip(got, stripe_prescreen_rows_plain(rows, halo, hl,
                                                         bd)):
            assert torch.equal(g, x), (tuple(rows.shape), hl, bd)
    dev = str(cuda_device)
    before = LAUNCHES["stripe_prescreen"]
    m1 = mesh.tile_prescreen(mesh.make_mesh(1, device=dev), 240, 416)(plane)
    m3 = mesh.tile_prescreen(mesh.make_mesh(3, device=dev), 240, 416)(plane)
    assert LAUNCHES["stripe_prescreen"] == before + 2
    inner = torch.ones(30, dtype=torch.bool)
    inner[9::10] = False
    for a, b in zip(m1, m3):
        assert torch.equal(a[inner], b[inner])


@pytest.mark.cuda
def test_cuda_grid_refine_ry_y0_matches_plain(cuda_device):
    h, w, S, halo = 96, 64, 16, 40
    ry, oy, starts = (t.to(cuda_device) for t in _refine_args(4, h, w, S, 2))
    loc = torch.cat([ry[:1].expand(halo, w), ry,
                     ry[-1:].expand(halo, w)]).contiguous()
    for quads in (False, True):
        args = (loc, oy, S, h // S, w // S, starts, quads, 900, 700, 380, 40)
        got = grid_refine(*args, ry_y0=halo)
        want = grid_refine_plain(*args, ry_y0=halo)
        for part in (0, 1) if quads else (0,):
            for g, x in zip(got[part], want[part]):
                assert torch.equal(g, x)


@pytest.mark.cuda
def test_cuda_grid_sao_decide_matches_plain(cuda_device):
    """Statistics of deblocked-like pictures at 1-5 CTU rows (each of the
    picture sums' orders), QPs below and above the chroma table's knee,
    all-zero statistics (every candidate ties), an all-off picture (a
    lambda that no offset repays) and 1920x1088 at CTU 16, whose costs
    take more than 48 KiB of shared memory: the rows exact."""
    cases = []
    for ny, nx, qp, ctu in ((1, 3, 22, 64), (2, 2, 32, 64), (3, 4, 37, 64),
                            (4, 7, 35, 64), (5, 2, 27, 64),
                            (68, 120, 32, 16)):
        org = torch.as_tensor(rng_planes(ny * 10 + nx, ny * ctu, nx * ctu)[0])
        rec = (org + torch.as_tensor(np.random.default_rng(qp).integers(
            -6, 7, org.shape), dtype=torch.int32)).clamp(0, 255)
        st = [sao_stats_plain(org, rec, ctu)] + [
            sao_stats_plain(org[::2, ::2].contiguous(),
                            rec[::2, ::2].contiguous(), ctu // 2)] * 2
        cnt = torch.stack([c for c, _ in st])
        sm = torch.stack([s for _, s in st])
        cases.append((cnt, sm, 40.0, qp, ny, nx))
        cases.append((torch.zeros_like(cnt), torch.zeros_like(sm), 40.0, qp,
                      ny, nx))
        cases.append((cnt, sm, 1e9, qp, ny, nx))
    for cnt, sm, lam, qp, ny, nx in cases:
        lam_t = torch.tensor(lam, dtype=torch.float32)
        want = grid_sao_decide_plain(cnt, sm, lam_t, qp, ny, nx)
        got = grid_sao_decide(cnt.to(cuda_device), sm.to(cuda_device),
                              lam_t.to(cuda_device), qp, ny, nx)
        for g, x in zip(got, want):
            assert torch.equal(g.cpu(), x)
        if lam == 1e9:  # all off: every type -1
            assert (want[0][:, : ny * nx] == -1).all()
