"""The grid step on row stripes (`tpuhevc_torch.parallel.mesh.
sharded_frame_step`) against tpuhevc's and the port's one-device step, its
halo exchange, and the kernels' row origins.

- (a) at tests/test_parallel.py's configuration and inputs (128x128, two
  references, SearchRange 16, deblocking; seed 3) the port's sharded step
  on 2 x cpu equals tpuhevc's single-device `sharded_frame_step`: the
  packed row byte for byte, the next reference stacks and MV seed
  exactly;
- (b) the anchor LD-P cfg's tools (RDOQ, SBH, deblocking, SAO, TMVP, four
  references, SearchRange 64, NN-FME with seeded weights) at 128x192 in 3
  stripes, 4 chained pictures (one per GOP position): sharded equals the
  port's single row for row and carry for carry; also with FmeMode
  dctif, weighted prediction and no recon fetch (the stripes' checksum
  and SSE sums);
- (c) the halo exchange over 1, 2 and 3 stripes, edge rows repeated or
  cut, reaches that span two stripes, and its byte count: a picture's new
  reference halo at 416x240 in 3 stripes, and every halo of a picture in
  (b), stay below one reference stack's 8-bit samples;
- (d) the plain versions with a row origin equal their whole-picture
  calls at the stripe's rows: grid_intra16 (y0), grid_sao's stats and
  apply (halo rows), grid_stats (y0, partial sums), and the stripe's
  phase planes (grid_planes from row y0 of its carried rows) and
  grid_satd reads (an out-of-range read asserts);
- (e) `make_mesh` with "cuda" raises where there is no GPU; more stripes
  than 64-row CTU rows raise;
- `cuda`: grid_intra16, grid_sao stats / apply, grid_stats and
  grid_planes with their row origins equal their plain versions, and the
  sharded step on n x the card equals the single one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401 (a fixture)
    cuda_device, fresh_grid, rng_planes)
from tpuhevc.codec.params import EncoderConfig as JaxConfig
from tpuhevc.codec.params import SeqParams as JaxSeq
from tpuhevc.parallel import mesh as jax_mesh
from tpuhevc_torch.codec import inter_grid as tig
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams
from tpuhevc_torch.codec.stripes import Exchange, Halo, HaloItem, Rows
from tpuhevc_torch.config.options import build_config, parse_args
from tpuhevc_torch.models.nnfme import random_params, save_npz
from tpuhevc_torch.ops.grid_intra import grid_intra16, grid_intra16_plain
from tpuhevc_torch.ops.grid_pred import (grid_planes, grid_planes_plain,
                                         grid_satd_plain)
from tpuhevc_torch.ops.grid_sao import (
    grid_sao_apply, grid_sao_apply_plain, grid_sao_decide_plain,
    grid_sao_stats, grid_sao_stats_plain)
from tpuhevc_torch.ops.grid_stats import (
    grid_stats_partial, grid_stats_partial_plain, grid_stats_plain,
    stats_finish)
from tpuhevc_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg")


def test_sharded_frame_step_matches_jax():
    """tests/test_parallel.py's frame step in 2 stripes of 64 rows."""
    w = h = 128
    kw = dict(qp=32, intra_period=-1, fme_mode="none", num_ref_frames=2,
              search_range=16, deblocking=True)
    jcfg = JaxConfig(sps=JaxSeq(width=w, height=h, max_tu_depth_intra=0),
                     inter_backend="jax", **kw)
    pcfg = EncoderConfig(sps=SeqParams(width=w, height=h,
                                       max_tu_depth_intra=0), **kw)
    (_, j_single, jmeta), _ = fresh_grid(jax_mesh.sharded_frame_step, jcfg,
                                         {32: None}, jax_mesh.make_mesh(1))
    sharded, _, meta = mesh.sharded_frame_step(
        pcfg, {32: None}, mesh.make_mesh(2, device="cpu"))
    R, Hc, Wc = jmeta["R"], jmeta["Hc"], jmeta["Wc"]
    assert (meta["R"], meta["Hc"], meta["Wc"]) == (R, Hc, Wc)
    assert [(r.y0, r.y1) for r in meta["rows"]] == [(0, 64), (64, 128)]
    rng = np.random.default_rng(3)
    oy = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ry = np.ascontiguousarray(np.broadcast_to(
        np.roll(oy, (3, -2), (0, 1)).astype(np.int32), (R, h, w)))
    ruv = rng.integers(0, 256, (R, Hc, 2 * Wc)).astype(np.int32)
    fu8 = np.concatenate([
        oy.ravel(), rng.integers(0, 256, (h * w // 4,), dtype=np.uint8),
        rng.integers(0, 256, (h * w // 4,), dtype=np.uint8)])
    seed = np.zeros(((h // 16) * (w // 16), 2), np.int32)
    want = j_single(jnp.asarray(ry), jnp.asarray(ruv), jnp.asarray(seed),
                    jnp.asarray(fu8), jnp.int32(R))
    carry = meta["step"].carry0(torch.as_tensor(ry), torch.as_tensor(ruv))
    parts, packed = sharded(meta["split"](carry), torch.as_tensor(fu8), R, 0)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[3]))
    got = meta["join"](parts)
    for g, x, what in zip(got, want[:3], ("ry", "ruv", "seed")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), what)
    assert meta["exchange"].halo_bytes > 0


def _anchor(tmp_path, w, h, extra=()):
    npz = str(tmp_path / "w.npz")
    params = random_params(0)
    save_npz(npz, {32: params})
    cfg, _ = build_config(parse_args(
        ["-c", ANCHOR, "-wdt", str(w), "-hgt", str(h), "-f", "8", "-q",
         "32", "--FmeMode=nn", f"--NNWeightsDir={npz}", *extra]))
    cfg.fetch_recon = cfg.hash_type != "checksum"
    cfg.sps.temporal_mvp_enabled = True
    qps = {min(max(cfg.qp + o, 0), 51) for o in cfg.gop_qp_offsets}
    return cfg, {q: params for q in qps}


def _clip(w, h, n, seed=7):
    from torch_port_util import clip_frames

    return [torch.as_tensor(np.concatenate([p.ravel() for p in f]))
            for f in clip_frames(w, h, n, seed)]


def _stacks(frames, w, h, R):
    """Frames 3, 2, 1, 0 as the reference stacks (originals standing in for
    their recons)."""
    def planes(f):
        y = f[: w * h].reshape(h, w).int()
        u = f[w * h : w * h * 5 // 4].reshape(h // 2, w // 2)
        v = f[w * h * 5 // 4 :].reshape(h // 2, w // 2)
        return y, torch.cat([u, v], 1).int()
    ps = [planes(frames[3 - r]) for r in range(R)]
    return torch.stack([p[0] for p in ps]), torch.stack([p[1] for p in ps])


@pytest.mark.parametrize("tools", ["anchor", "dctif_wp_no_fetch"])
def test_sharded_equals_single_with_the_anchor_tools(tmp_path, tools):
    w, h = 128, 192
    extra = (() if tools == "anchor" else
             ("--FmeMode=dctif", "--WeightedPredP=1",
              "--SEIDecodedPictureHash=3"))
    cfg, nn = _anchor(tmp_path, w, h, extra)
    sharded, single, meta = mesh.sharded_frame_step(
        cfg, nn, mesh.make_mesh(3, device="cpu"))
    step, R, G = meta["step"], meta["R"], meta["G"]
    assert (R, G, step.sr_full, step.rdoq, step.sbh, step.deblock,
            step.sao, step.use_tmvp) == (4, 4, 64, True, True, True, True,
                                         True)
    assert step.fetch == (tools == "anchor")
    assert step.use_wp == (tools != "anchor")
    # 72 halo rows of the reference stacks span two 64-row stripes
    assert step.KY == 72 and [r.y1 - r.y0 for r in meta["rows"]] == [64] * 3
    frames = _clip(w, h, 4 + G)
    carry = step.carry0(*_stacks(frames, w, h, R))
    parts = meta["split"](carry)
    wp = None
    if step.use_wp:
        wp = (torch.tensor([[64, 32, 32]] * R, dtype=torch.int32)
              + torch.arange(R, dtype=torch.int32)[:, None],
              torch.tensor([[2, -1, 1]] * R, dtype=torch.int32), 6)
    ex = meta["exchange"]
    for k in range(G):
        carry, row = single(carry, frames[4 + k], R, k, wp)
        x0 = ex.halo_bytes
        parts, rows = sharded(parts, frames[4 + k], R, k, wp)
        assert torch.equal(rows, row), f"picture {k}"
        for a, b in zip(meta["join"](parts), carry):
            assert torch.equal(a, b), f"picture {k} carry"
        # the older references keep their halos: a picture sends less
        # than one reference stack's 8-bit samples
        assert 0 < ex.halo_bytes - x0 < R * h * w * 3 // 2
    assert int(carry[3].abs().sum()) > 0  # TMVP read a collocated field


def _stripe_halos(parts, items, edge, dtype=None):
    def gen(x):
        return (yield Halo([HaloItem(x, a, b, dim, edge, dtype)
                            for a, b, dim in items]))
    ex = Exchange([torch.device("cpu")] * len(parts))
    return ex.run([gen(p) for p in parts]), ex


def test_halo_exchange_over_stripes():
    T, w = 240, 5
    field = torch.arange(T, dtype=torch.int32)[:, None].expand(T, w) \
        .contiguous()
    for sizes in ((240,), (128, 112), (64, 64, 112)):
        starts = np.cumsum((0,) + sizes)
        parts = [field[a:b] for a, b in zip(starts[:-1], starts[1:])]
        for edge in ("repeat", "cut"):
            k = 72  # spans two stripes of 64 rows
            outs, ex = _stripe_halos(parts, [(k, k, 0)], edge, torch.uint8)
            copied = 0
            for (buf,), a, b in zip(outs, starts[:-1], starts[1:]):
                want = np.arange(a - k, b + k)
                inside = want[(want >= 0) & (want < T)]
                # another stripe's rows cross once each, an edge row that
                # repeats once
                copied += int(((inside < a) | (inside >= b)).sum()) * w
                if edge == "repeat":
                    copied += w * ((a - k < 0 < a) + (b + k > T > b))
                    want = np.clip(want, 0, T - 1)
                else:
                    want = inside
                np.testing.assert_array_equal(buf[:, 0].numpy(), want)
                assert buf.dtype == torch.int32 and buf.shape[1] == w
            assert ex.halo_bytes == copied  # uint8 rows of other stripes
            if len(sizes) == 1:
                assert ex.halo_bytes == 0
    # a stack along dim 1 (4 x 240 x 5: 4 x 240 rows of 5, the reach
    # across the stripes)
    stack = field.T[None].repeat(4, 1, 1).transpose(1, 2).contiguous()
    parts = [stack[:, a:b] for a, b in ((0, 64), (64, 128), (128, 240))]
    outs, _ = _stripe_halos(parts, [(72, 72, 1)], "cut")
    for (buf,), a, b in zip(outs, (0, 64, 128), (64, 128, 240)):
        assert torch.equal(buf, stack[:, max(a - 72, 0) : b + 72])
    # the anchor's new reference a picture: the recon's luma and chroma
    # halos (72 and 36 rows, cut at the picture's edges, as uint8) of
    # 416x240 in 3 stripes stay below one reference stack's (4 pictures)
    # 8-bit samples
    rec_y = torch.zeros((240, 416), dtype=torch.int32)
    rec_uv = torch.zeros((120, 416), dtype=torch.int32)
    rows = mesh.stripe_rows(240, 3)
    assert [(r.y0, r.y1) for r in rows] == [(0, 64), (64, 128), (128, 240)]

    def gen(r):
        return (yield Halo([
            HaloItem(rec_y[r.y0 : r.y1], 72, 72, edge="cut",
                     dtype=torch.uint8),
            HaloItem(rec_uv[r.y0 // 2 : r.y1 // 2], 36, 36, edge="cut",
                     dtype=torch.uint8)]))
    ex = Exchange([torch.device("cpu")] * 3)
    outs = ex.run([gen(r) for r in rows])
    assert [tuple(o[0].shape) for o in outs] == [
        (64 + 72, 416), (64 + 64 + 72, 416), (72 + 112, 416)]
    assert ex.halo_bytes == (72 + 64 + 72 + 72) * 416 * 3 // 2
    assert ex.halo_bytes < 4 * 240 * 416 * 3 // 2


def test_plain_row_origins_equal_the_whole_picture():
    h, w, y0, y1 = 192, 128, 64, 128
    oy, ry = (torch.as_tensor(p) for p in rng_planes(11, h, w, 2))
    ouv = torch.cat([torch.as_tensor(p) for p in rng_planes(12, h // 2,
                                                            w // 2, 2)], 1)
    step = tig.GridStep(EncoderConfig(sps=SeqParams(width=w, height=h),
                                      qp=32, intra_period=-1), {}, "cpu")
    nh, nw = (y1 - y0) // 16, w // 16
    r16 = y0 // 16
    # grid_intra16: the stripe with the row above it (y0 = 1)
    whole = grid_intra16_plain(oy, ouv, step.avtr_flat, step.avbl_flat,
                               h // 16, w // 16, cur=oy)
    av = [a[r16 : r16 + nh].reshape(-1) for a in (step.avtr, step.avbl)]
    got = grid_intra16_plain(oy[y0 - 1 : y1], ouv[y0 // 2 - 1 : y1 // 2],
                             *av, nh, nw, cur=oy[y0:y1], y0=1)
    assert torch.equal(got[0], whole[0][r16 * nw : (r16 + nh) * nw])
    assert torch.equal(got[1], whole[1][y0:y1])
    assert torch.equal(got[2], whole[2][y0 // 2 : y1 // 2])
    # grid_sao: stats and apply of the stripe with one halo row each side
    ctu = 64
    cnt, sm = grid_sao_stats_plain(oy, ouv, ry, ouv.flip(1), ctu)
    sc, ss = grid_sao_stats_plain(oy[y0:y1], ouv[y0 // 2 : y1 // 2],
                                  ry[y0 - 1 : y1 + 1],
                                  ouv.flip(1)[y0 // 2 - 1 : y1 // 2 + 1], ctu,
                                  top=1)
    c0, c1 = y0 // ctu * (w // ctu), y1 // ctu * (w // ctu)
    assert torch.equal(sc, cnt[:, c0:c1]) and torch.equal(ss, sm[:, c0:c1])
    par, _ = grid_sao_decide_plain(cnt, sm, torch.tensor(30.0), 32,
                                   h // ctu, w // ctu)
    n, nk = par.shape[1] // 6, c1 - c0
    par_k = torch.cat([par[:, c0:c1], par[:, n + c0 : n + c1],
                       par[:, 2 * n + 4 * c0 : 2 * n + 4 * c1]], 1)
    assert nk and (par_k[:, :nk] >= 0).any()  # some CTU filtered
    wy, wuv = grid_sao_apply_plain(ry, ouv.flip(1), par, ctu)
    gy, guv = grid_sao_apply_plain(ry[y0 - 1 : y1 + 1],
                                   ouv.flip(1)[y0 // 2 - 1 : y1 // 2 + 1],
                                   par_k, ctu, top=1, h=y1 - y0)
    assert torch.equal(gy, wy[y0:y1]) and torch.equal(guv, wuv[y0 // 2 :
                                                              y1 // 2])
    # grid_stats: the stripes' exact sums give the picture's values
    rec_uv = ouv.flip(0).contiguous()
    sums = [grid_stats_partial_plain(oy[a:b], ouv[a // 2 : b // 2], ry[a:b],
                                     rec_uv[a // 2 : b // 2], a)
            for a, b in ((0, 64), (64, 128), (128, 192))]
    cks, sse = stats_finish(sum(s[0] for s in sums), sum(s[1] for s in sums))
    want = grid_stats_plain(oy, ouv, ry, rec_uv)
    assert torch.equal(cks, want[0]) and torch.equal(sse, want[1])
    # each stripe's phase planes, read from row y0 of its carried rows
    # (up to KY halo rows each side, cut at the picture's edges), are the
    # whole picture's rows, and grid_satd reads the same predictions
    # through them
    k, pad, look = step.KY, step.PADL, step.LOOK
    stack = ry[None]
    planes_w = grid_planes_plain(stack, True, pad, step.HmL, step.WmL)
    for a, b in ((0, 64), (64, 128), (128, 192)):
        r = Rows(a, b, h)
        buf = stack[:, a - r.above(k) : b + r.below(k)]
        got = grid_planes_plain(buf, True, pad, b - a + 2 * look, step.WmL,
                                y0=r.above(k))
        assert torch.equal(got, planes_w[..., a : b + 2 * look, :])
    r = Rows(y0, y1, h)
    planes_s = grid_planes_plain(stack[:, y0 - r.above(k) : y1 + k], True,
                                 pad, y1 - y0 + 2 * look, step.WmL,
                                 y0=r.above(k))
    rng = np.random.default_rng(5)
    mv = torch.as_tensor(rng.integers(-4 * look, 4 * look - 4 * 8,
                                      (1, (y1 - y0) // 8, w // 8, 2)),
                         dtype=torch.int32)
    ref = torch.zeros(mv.shape[:3], dtype=torch.int32)
    mv_w = torch.zeros((1, h // 8, w // 8, 2), dtype=torch.int32)
    mv_w[:, y0 // 8 : y1 // 8] = mv
    ref_w = torch.zeros(mv_w.shape[:3], dtype=torch.int32)
    a = grid_satd_plain(planes_s, mv, ref, 8, look, oy[y0:y1])
    b = grid_satd_plain(planes_w, mv_w, ref_w, 8, look, oy)
    assert torch.equal(a[0], b[0][:, y0:y1])
    assert torch.equal(a[1], b[1][:, y0 // 8 : y1 // 8])
    with pytest.raises(AssertionError, match="reads rows"):
        grid_satd_plain(planes_s, mv + torch.tensor([0, 4 * 8]), ref, 8,
                        look + 4 * 64)


def test_mesh_and_stripe_limits():
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.make_mesh(2, device="cuda")
    assert mesh.stripe_rows(240, 1) == [Rows(0, 240, 240)]
    assert [(r.y0, r.y1) for r in mesh.stripe_rows(320, 3)] == [
        (0, 128), (128, 256), (256, 320)]
    with pytest.raises(ValueError, match="CTU rows"):
        mesh.stripe_rows(240, 4)  # 3 full 64-row CTU rows
    cfg = EncoderConfig(sps=SeqParams(width=64, height=128), qp=32,
                        intra_period=-1)
    with pytest.raises(ValueError, match="CTU rows"):
        mesh.sharded_frame_step(cfg, {}, mesh.make_mesh(3, device="cpu"))


# --- the kernels on the card -------------------------------------------------

@pytest.mark.cuda
def test_cuda_row_origin_kernels_and_sharded_step(cuda_device, tmp_path):
    """grid_intra16 (y0 1), grid_sao stats / apply (a halo row each side,
    and at the picture's edges), grid_stats (y0, int64 sums) and
    grid_planes (each stripe's row origin) equal their plain versions on
    the card; the sharded step on 3 x the card
    equals the single one over one anchor picture."""
    dev = cuda_device
    h, w, y0, y1 = 192, 128, 64, 128
    oy, ry = (torch.as_tensor(p, device=dev) for p in rng_planes(13, h, w, 2))
    ouv = torch.cat([torch.as_tensor(p, device=dev)
                     for p in rng_planes(14, h // 2, w // 2, 2)], 1)
    step = tig.GridStep(EncoderConfig(sps=SeqParams(width=w, height=h),
                                      qp=32, intra_period=-1), {}, dev)
    nh, nw, r16 = (y1 - y0) // 16, w // 16, y0 // 16
    av = [a[r16 : r16 + nh].reshape(-1).contiguous()
          for a in (step.avtr, step.avbl)]
    args = (oy[y0 - 1 : y1].contiguous(),
            ouv[y0 // 2 - 1 : y1 // 2].contiguous(), *av, nh, nw)
    for kw in (dict(cur=oy[y0:y1].contiguous()),
               dict(modes=torch.arange(nh * nw, dtype=torch.int32,
                                       device=dev) % 7)):
        for g, x in zip(grid_intra16(*args, **kw, y0=1),
                        grid_intra16_plain(*args, **kw, y0=1)):
            assert torch.equal(g, x)
    rec_uv = ouv.flip(1).contiguous()
    for a, b in ((0, 64), (64, 128), (128, 192)):
        top, bot = int(a > 0), int(b < h)
        sa = (oy[a:b].contiguous(), ouv[a // 2 : b // 2].contiguous(),
              ry[a - top : b + bot].contiguous(),
              rec_uv[a // 2 - top : b // 2 + bot].contiguous(), 64, top)
        st = grid_sao_stats(*sa)
        for g, x in zip(st, grid_sao_stats_plain(*sa)):
            assert torch.equal(g, x)
        par = torch.as_tensor(np.random.default_rng(a).integers(
            -1, 5, (3, 6 * st[0].shape[1])), dtype=torch.int32, device=dev)
        par[:, 2 * st[0].shape[1]:] = par[:, 2 * st[0].shape[1]:] % 8
        pa = (sa[2], sa[3], par, 64, top, b - a)
        for g, x in zip(grid_sao_apply(*pa), grid_sao_apply_plain(*pa)):
            assert torch.equal(g, x)
        ga = (sa[0], sa[1], ry[a:b].contiguous(),
              rec_uv[a // 2 : b // 2].contiguous(), a)
        for g, x in zip(grid_stats_partial(*ga),
                        grid_stats_partial_plain(*ga)):
            assert torch.equal(g, x)
        # the luma and chroma phase planes from the stripe's row origin
        r, k = Rows(a, b, h), step.KY
        buf = ry[None, a - r.above(k) : b + r.below(k)].contiguous()
        pa = (buf, True, step.PADL, b - a + 2 * step.LOOK, step.WmL, None,
              r.above(k))
        assert torch.equal(grid_planes(*pa), grid_planes_plain(*pa))
        cbuf = torch.cat([rec_uv[None, :, : w // 2], rec_uv[None, :, w // 2 :]]
                         )[:, (a - r.above(k)) // 2 : (b + r.below(k)) // 2]
        pa = (cbuf.contiguous(), False, step.PADC,
              (b - a) // 2 + 2 * step.LOOKC, step.WmC, None, r.above(k) // 2)
        assert torch.equal(grid_planes(*pa), grid_planes_plain(*pa))
    cfg, nn = _anchor(tmp_path, w, h)
    sharded, single, meta = mesh.sharded_frame_step(
        cfg, nn, mesh.make_mesh(3, device=str(dev)))
    frames = [f.to(dev) for f in _clip(w, h, 5)]
    carry = meta["step"].carry0(*(t.to(dev) for t in _stacks(
        frames, w, h, meta["R"])))
    c1, row1 = single(carry, frames[4], meta["R"], 0)
    c3, row3 = sharded(meta["split"](carry), frames[4], meta["R"], 0)
    assert torch.equal(row1, row3)
    for a, b in zip(meta["join"](c3), c1):
        assert torch.equal(a, b)
