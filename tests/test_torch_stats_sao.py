"""The grid step's statistics kernels: `grid_stats` (the no-fetch tail's
checksums and SSEs, `ops/grid_stats.py`) and the stats launch of
`grid_sao` (`ops/grid_sao.py:grid_sao_stats`). The JAX package is imported
only inside the CPU tests (numpy functions, no JAX compile), so that the
`cuda` tests load where only the GPU stack is.

On the CPU:
- `grid_sao_stats_plain`, per component, equals tpuhevc's numpy
  `ops.sao.collect_stats` regrouped into the 48 bins (EO class k,
  category c at 4 k + c - 1; band b at 16 + b) on a one-band flat plane
  (every sample in one band, every EO category 0), a noise plane, and a
  ragged 416x240 picture at CTU 64 and 16;
- on 3 row stripes (64, 64 and 112 rows of 416x240) with their `top` and
  `bot` halo rows it gives the whole picture's CTU rows;
- `grid_stats_partial_plain` equals the checksum and SSE built on
  tpuhevc's `inter_grid._xor_mask` at a width of 528 (the `x >> 8` term
  live in luma and chroma), and 4 stripes' sums (each from its row
  origin) equal the picture's;
- an SSE above 2^24 is the exact integer, rounded once by `stats_finish`.

On a card (`cuda`; skipped here), `torch.equal` to the plain versions:
- `grid_stats_partial` on noise, flat and one-band planes at 416x240, a
  1920x1088 noise picture (its luma SSE above 2^31), the stripe origins,
  a width that is not a multiple of 8 and a view that is not 16-byte
  aligned (read sample by sample), two launches back to back, and two
  launches on two streams of one card without a sync between (each
  stream's own scratch and ticket, left at zero);
- `grid_sao_stats` on the same kinds of planes at 416x240 with CTU 64, 32
  and 16, on the 3 stripes with their halo rows, and two launches back
  to back;
- `grid_sao_apply` (a thread a run of 4 samples, one 16-byte store) on
  the same kinds of planes with seeded parameters (every type -1..4 among
  the CTUs of each component, every band position, offsets -7..7) at CTU
  64, 32 and 16, the whole picture and the middle stripe with
  top = bot = 1.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.grid_sao import (grid_sao_apply,
                                        grid_sao_apply_plain,
                                        grid_sao_stats,
                                        grid_sao_stats_plain)
from tpuhevc_torch.ops.grid_stats import (grid_stats_partial,
                                          grid_stats_partial_plain,
                                          stats_finish)

W, H = 416, 240
STRIPES = ((0, 64), (64, 128), (128, 240))  # the grid's 3 stripes


def planes(kind, h, w, seed):
    """(org, rec) (h, w) int32 8-bit planes: `noise` both uniform; `flat`
    both one value; `band` rec one value (one band, every EO category 0)
    and org noise around it; `smooth` a gentle ramp with small noise."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        o, r = rng.integers(0, 256, (2, h, w))
    elif kind == "flat":
        o = r = np.full((h, w), 77)
    elif kind == "band":
        r = np.full((h, w), 100)
        o = r + rng.integers(-40, 41, (h, w))
    else:
        ramp = (np.arange(w)[None] // 3 + np.arange(h)[:, None] // 5) % 200
        r = ramp + rng.integers(0, 3, (h, w))
        o = r + rng.integers(-6, 7, (h, w))
    return (np.clip(o, 0, 255).astype(np.int32),
            np.clip(r, 0, 255).astype(np.int32))


def picture(kind, h, w, seed, dev="cpu"):
    """(oy, ouv, ry, ruv) torch int32 on dev, chroma packed [U | V]."""
    oy, ry = planes(kind, h, w, seed)
    ou, ru = planes(kind, h // 2, w // 2, seed + 1)
    ov, rv = planes(kind, h // 2, w // 2, seed + 2)
    out = (oy, np.concatenate([ou, ov], 1), ry, np.concatenate([ru, rv], 1))
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                 for x in out)


def stripe_args(pic, a, b, h):
    """grid_sao_stats' arguments for rows a..b of the picture: the own rows
    of the original, the deblocked rows with one halo row each side that
    the picture has."""
    oy, ouv, ry, ruv = pic
    top, bot = int(a > 0), int(b < h)
    return (oy[a:b].contiguous(), ouv[a // 2 : b // 2].contiguous(),
            ry[a - top : b + bot].contiguous(),
            ruv[a // 2 - top : b // 2 + bot].contiguous(), top)


# --- the CPU -----------------------------------------------------------------

def test_sao_stats_plain_equals_collect_stats():
    from tpuhevc.ops.sao import collect_stats

    cases = [("band", 64, 64, 64), ("flat", 64, 64, 32),
             ("noise", 96, 128, 64), ("noise", H, W, 64),
             ("smooth", H, W, 64), ("smooth", H, W, 16)]
    for seed, (kind, h, w, ctu) in enumerate(cases):
        oy, ouv, ry, ruv = picture(kind, h, w, seed)
        cnt, sm = grid_sao_stats_plain(oy, ouv, ry, ruv, ctu)
        wc = w // 2
        comps = ((oy, ry, ctu), (ouv[:, :wc], ruv[:, :wc], ctu // 2),
                 (ouv[:, wc:], ruv[:, wc:], ctu // 2))
        for c, (o, r, cs) in enumerate(comps):
            st = collect_stats(o.numpy(), r.numpy(), cs)
            n = st["bo_count"].shape[0] * st["bo_count"].shape[1]
            want_c = np.concatenate([st["eo_count"].reshape(n, 16),
                                     st["bo_count"].reshape(n, 32)], 1)
            want_s = np.concatenate([st["eo_sum"].reshape(n, 16),
                                     st["bo_sum"].reshape(n, 32)], 1)
            np.testing.assert_array_equal(cnt[c].numpy(), want_c,
                                          err_msg=f"{kind} {h}x{w} {ctu}")
            np.testing.assert_array_equal(sm[c].numpy(),
                                          want_s.astype(np.int64),
                                          err_msg=f"{kind} {h}x{w} {ctu}")
        if kind == "band":  # one band holds every sample; no EO category
            assert int(cnt[0, :, :16].sum()) == 0
            assert int(cnt[0, :, 16 + 100 // 8].sum()) == h * w


def test_sao_stats_plain_stripes_equal_picture():
    pic = picture("noise", H, W, 5)
    whole = grid_sao_stats_plain(*pic, 64)
    nx = -(-W // 64)
    got = []
    for a, b in STRIPES:
        sa = stripe_args(pic, a, b, H)
        got.append(grid_sao_stats_plain(*sa[:4], 64, sa[4]))
    for i in range(2):
        joined = torch.cat([g[i] for g in got], 1)
        assert joined.shape[1] == -(-H // 64) * nx
        assert torch.equal(joined, whole[i])


def test_stats_plain_equals_xor_mask_sums():
    from tpuhevc.codec.inter_grid import _xor_mask

    h, w = 64, 528  # x >> 8 is live in luma (528) and chroma (264)
    oy, ouv, ry, ruv = picture("noise", h, w, 11)
    wc = w // 2
    want_c, want_s = [], []
    for o, r, ph in ((oy, ry, h), (ouv[:, :wc], ruv[:, :wc], h // 2),
                     (ouv[:, wc:], ruv[:, wc:], h // 2)):
        o, r = o.numpy().astype(np.int64), r.numpy().astype(np.int64)
        m = _xor_mask(ph, r.shape[1]).astype(np.int64)
        want_c.append(int(((r & 0xFF) ^ m).sum()))
        want_s.append(int(((o - r) ** 2).sum()))
    cks, sse = grid_stats_partial_plain(oy, ouv, ry, ruv)
    assert cks.tolist() == want_c and sse.tolist() == want_s
    # stripes of 16 rows, each from its row origin, add to the picture's
    parts = [grid_stats_partial_plain(oy[a : a + 16], ouv[a // 2 : a // 2 + 8],
                                      ry[a : a + 16],
                                      ruv[a // 2 : a // 2 + 8], a)
             for a in range(0, h, 16)]
    assert sum(p[0] for p in parts).tolist() == want_c
    assert sum(p[1] for p in parts).tolist() == want_s


def test_stats_sse_above_2_24_is_exact():
    oy, ouv, ry, ruv = picture("noise", H, W, 12)
    cks, sse = grid_stats_partial_plain(oy, ouv, ry, ruv)
    exact = [int(((o.long() - r.long()) ** 2).sum()) for o, r in (
        (oy, ry), (ouv[:, : W // 2], ruv[:, : W // 2]),
        (ouv[:, W // 2 :], ruv[:, W // 2 :]))]
    assert exact[0] > 2 ** 24 and sse.tolist() == exact
    _, sse32 = stats_finish(cks, sse)
    assert sse32.dtype == torch.float32
    assert sse32.tolist() == [float(np.float32(e)) for e in exact]


# --- the card ----------------------------------------------------------------

def same(got, want, what):
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x.to(g.device)), what


@pytest.mark.cuda
def test_cuda_grid_stats_matches_plain(cuda_device):
    dev = cuda_device
    for seed, kind in enumerate(("noise", "flat", "band", "smooth")):
        pic = picture(kind, H, W, seed, dev)
        same(grid_stats_partial(*pic), grid_stats_partial_plain(*pic), kind)
        for a, b in STRIPES:  # each stripe from its row origin
            part = (pic[0][a:b], pic[1][a // 2 : b // 2], pic[2][a:b],
                    pic[3][a // 2 : b // 2], a)
            same(grid_stats_partial(*part), grid_stats_partial_plain(*part),
                 f"{kind} rows {a}..{b}")
    big = picture("noise", 1088, 1920, 9, dev)
    want = grid_stats_partial_plain(*big)
    assert int(want[1][0]) > 2 ** 31
    same(grid_stats_partial(*big), want, "1920x1088")
    # a width that is not a multiple of 8, and a view 8 bytes off the
    # 16-byte grid: both read sample by sample
    odd = picture("noise", 32, 418, 3, dev)
    same(grid_stats_partial(*odd), grid_stats_partial_plain(*odd), "418")
    flat = [torch.cat([t.reshape(-1), t.new_zeros(2)]) for t in
            picture("noise", 32, 64, 4, dev)]
    off = tuple(f[2 : 2 + n].view(s) for f, n, s in zip(
        flat, (2048, 1024, 2048, 1024), ((32, 64), (16, 64)) * 2))
    assert off[0].data_ptr() % 16 == 8
    same(grid_stats_partial(*off), grid_stats_partial_plain(*off), "offset")
    # two launches back to back, no sync between
    before = LAUNCHES["grid_stats"]
    pic2 = picture("smooth", H, W, 7, dev)
    got = [grid_stats_partial(*big), grid_stats_partial(*pic2)]
    torch.cuda.synchronize()
    same(got[0], want, "back to back, 1st")
    same(got[1], grid_stats_partial_plain(*pic2), "back to back, 2nd")
    assert LAUNCHES["grid_stats"] - before == 2


@pytest.mark.cuda
def test_cuda_grid_stats_two_streams(cuda_device):
    dev = cuda_device
    pics = [picture("noise", 1088, 1920, 21, dev),
            picture("band", H, W, 22, dev)]
    want = [grid_stats_partial_plain(*p) for p in pics]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in pics]
    for _ in range(3):
        got = []
        for p, st in zip(pics, streams):
            with torch.cuda.stream(st):
                got.append(grid_stats_partial(*p))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            same(g, w, "two streams")


@pytest.mark.cuda
def test_cuda_sao_stats_matches_plain(cuda_device):
    dev = cuda_device
    before = LAUNCHES["grid_sao"]
    calls = 0
    for seed, kind in enumerate(("noise", "flat", "band", "smooth")):
        pic = picture(kind, H, W, 30 + seed, dev)
        for ctu in (64, 32, 16):
            same(grid_sao_stats(*pic, ctu), grid_sao_stats_plain(*pic, ctu),
                 f"{kind} CTU {ctu}")
            calls += 1
        for a, b in STRIPES:
            sa = stripe_args(pic, a, b, H)
            same(grid_sao_stats(*sa[:4], 64, sa[4]),
                 grid_sao_stats_plain(*sa[:4], 64, sa[4]),
                 f"{kind} rows {a}..{b}")
            calls += 1
    # two launches back to back, no sync between
    pics = [picture("noise", H, W, 40, dev), picture("band", H, W, 41, dev)]
    got = [grid_sao_stats(*p, 64) for p in pics]
    calls += 2
    torch.cuda.synchronize()
    for g, p in zip(got, pics):
        same(g, grid_sao_stats_plain(*p, 64), "back to back")
    assert LAUNCHES["grid_sao"] - before == calls


def sao_par(n, seed, dev):
    """par (3, 6 n) int32 of n CTUs: types cycling through -1..4 from a
    seeded start, aux 0..31 and offsets -7..7 from a seeded generator."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(3):
        typ = (np.arange(n) + rng.integers(0, 6)) % 6 - 1
        rows.append(np.concatenate([typ, rng.integers(0, 32, n),
                                    rng.integers(-7, 8, 4 * n)]))
    return torch.as_tensor(np.stack(rows).astype(np.int32), device=dev)


@pytest.mark.cuda
def test_cuda_sao_apply_matches_plain(cuda_device):
    dev = cuda_device
    before = LAUNCHES["grid_sao"]
    calls = 0
    a, b = STRIPES[1]
    for seed, kind in enumerate(("noise", "flat", "band", "smooth")):
        pic = picture(kind, H, W, 50 + seed, dev)
        for ctu in (64, 32, 16):
            n = -(-H // ctu) * -(-W // ctu)
            par = sao_par(n, 60 + seed, dev)
            same(grid_sao_apply(pic[2], pic[3], par, ctu),
                 grid_sao_apply_plain(pic[2], pic[3], par, ctu),
                 f"{kind} CTU {ctu}")
            sa = stripe_args(pic, a, b, H)
            assert sa[4] == 1 and sa[2].shape[0] == b - a + 2
            n = -(-(b - a) // ctu) * -(-W // ctu)
            par = sao_par(n, 70 + seed, dev)
            same(grid_sao_apply(sa[2], sa[3], par, ctu, 1, b - a),
                 grid_sao_apply_plain(sa[2], sa[3], par, ctu, 1, b - a),
                 f"{kind} CTU {ctu} rows {a}..{b}")
            calls += 2
    assert LAUNCHES["grid_sao"] - before == calls
