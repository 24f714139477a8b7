"""The grid step's motion-compensation kernels (`kernels/csrc/grid_pred.cu`)
against their plain versions, and the SATD cost entry's plain version
against the composition it stands for. Imports no JAX.

On the CPU:
- `grid_satd_cost_plain` of several fields in one call, both modes,
  equals each field's composition on its own: `satd_z` of
  `grid_satd_plain` of the CU's MV repeated over its 8x8 blocks (mode z,
  S = 8..64), and the rectangular trial's sums of the 8x8 SATDs over the
  half-CU cells at the first and the second MV of their pairs, the pairs'
  MVs gathered as `GridStep.frame_steps`' rect trial gathers them
  (`repeat_interleave` of every other column or row; mode plain);
- `grid_subpel_classes` (the DCT-IF half- and quarter-pel search of up
  to three classes of CUs in one launch) and its one-class case
  `grid_subpel` on the CPU equal `grid_subpel_plain` of each class at
  S = 8, 16 and 32, MVs at +-(look - 1); on flat planes, where all nine
  points of both rounds tie, the first point of `OFFS9`, (-1, -1), wins
  each round.

On a card (`cuda`; skipped here), every output `torch.equal`:
- `grid_planes` (the tiled separable filter) against `grid_planes_plain`:
  luma and chroma, with and without the WP rounding, from row y0 > 0,
  at window widths and heights that are not multiples of the 32 x 64
  tile, and at widths taking each store width (8, 4 and 1 samples);
- `grid_satd_cost` against its plain version: 1, 2 and 3 fields, both
  modes, every CU size, pairs along x and y, MVs reaching each edge of
  the planes, lambda read on the card under sync debug mode "error";
- the gathers of a class coding (`grid_mc`: luma, U and V in one
  launch) at whole and cut fields;
- `grid_subpel` (lane-team butterflies, the classes in one launch) at
  S = 8, 16 and 32 alone and the three classes in one launch, at whole
  and cut CU grids, oy in 16-byte and in single loads, MVs at
  +-(look - 1), flat planes (every point ties), one launch a call.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.grid_code import up
from tpuhevc_torch.ops.grid_pred import (
    SatdField, grid_mc, grid_mc_plain, grid_planes, grid_planes_plain,
    grid_satd_cost, grid_satd_cost_plain, grid_satd_plain, grid_subpel,
    grid_subpel_classes, grid_subpel_classes_plain, grid_subpel_plain,
    group_sum, satd_z)

LOOK = 12  # the planes' margin around the picture
H, W, NREF = 64, 128, 3


def planes_and_picture(dev="cpu", seed=1):
    """Luma phase planes of NREF random references of H x W (padded by
    LOOK + 4, the window H + 2 LOOK by W + 2 LOOK) and a picture."""
    rng = np.random.default_rng(seed)
    ref = torch.as_tensor(rng.integers(0, 256, (NREF, H, W)), dtype=torch.int32)
    oy = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32)
    planes = grid_planes_plain(ref, True, LOOK + 4, H + 2 * LOOK,
                               W + 2 * LOOK)
    return planes.to(dev), oy.to(dev)


def cu_grid(S, seed, rows=None, cols=None, reach=LOOK - 1, dev="cpu"):
    """(mv (rows, cols, 2) quarter-pel, ref) of S-CUs; the MVs reach
    +-reach samples, the corner CUs the planes' edges."""
    rng = np.random.default_rng(seed)
    rows, cols = rows or H // S, cols or W // S
    mv = rng.integers(-4 * reach, 4 * reach + 1, (rows, cols, 2))
    mv[0, 0], mv[-1, -1] = -4 * reach, 4 * reach
    ref = rng.integers(0, NREF, (rows, cols))
    return (torch.as_tensor(mv, dtype=torch.int32, device=dev),
            torch.as_tensor(ref, dtype=torch.int32, device=dev))


def subpel_class(S, seed, rows=None, cols=None, dev="cpu"):
    """(mv (rows cols, 2) full-pel, ref, S, rows, cols) of an S-class for
    grid_subpel: MVs in +-(LOOK - 1), the first and last CU's at the
    extremes (the refine's clamp)."""
    rng = np.random.default_rng(seed)
    rows, cols = rows or H // S, cols or W // S
    mv = rng.integers(-(LOOK - 1), LOOK, (rows * cols, 2))
    mv[0], mv[-1] = -(LOOK - 1), LOOK - 1
    ref = rng.integers(0, NREF, rows * cols)
    return (torch.as_tensor(mv, dtype=torch.int32, device=dev),
            torch.as_tensor(ref, dtype=torch.int32, device=dev), S, rows,
            cols)


def flat_planes(dev="cpu"):
    """Phase planes of constant references and a constant picture: every
    point of both rounds costs the same."""
    ref = torch.full((NREF, H, W), 97, dtype=torch.int32)
    planes = grid_planes_plain(ref, True, LOOK + 4, H + 2 * LOOK,
                               W + 2 * LOOK)
    return planes.to(dev), torch.full((H, W), 100, dtype=torch.int32,
                                      device=dev)


def composed_z(planes, oy, mv, ref, S, dc, lam):
    f = S // 8
    _, m8, s8 = grid_satd_plain(
        planes, up(mv.permute(2, 0, 1), f).permute(1, 2, 0)[None]
        .contiguous(), up(ref, f)[None].contiguous(), 8, LOOK, oy,
        want_pred=False)
    return satd_z(m8[0], s8[0], S, *ref.shape, dc, lam)


def test_satd_cost_plain_fields_and_pairs_match_composition():
    planes, oy = planes_and_picture()
    lam = torch.tensor(np.float32(7.3))
    fields = [SatdField(*cu_grid(S, S), S, H // S, W // S, 0, 11.5 * S)
              for S in (8, 16, 32, 64)]
    got = grid_satd_cost_plain(planes, oy, fields, LOOK, "z", lam)
    for fl, g in zip(fields, got):
        want = composed_z(planes, oy, fl.mv, fl.ref, fl.size, fl.dc, lam)
        assert g.dtype == torch.float32 and torch.equal(g, want), fl.size
    for C in (8, 16):  # the rect trial's half-CU cells at S = 16, 32
        mv, ref = cu_grid(C, 40 + C)
        hc, wc = mv.shape[:2]
        got = grid_satd_cost_plain(
            planes, oy, [SatdField(mv, ref, C, hc, wc, k) for k in (1, 2, 3, 4)],
            LOOK, "plain")
        f = C // 8
        for k, (axis, sel) in enumerate(((1, 0), (1, 1), (0, 0), (0, 1))):
            pick = (slice(None), slice(sel, None, 2)) if axis == 1 else (
                slice(sel, None, 2),)
            m = mv[pick].repeat_interleave(2, axis)
            r = ref[pick].repeat_interleave(2, axis)
            _, m8, _ = grid_satd_plain(
                planes, up(m.permute(2, 0, 1), f).permute(1, 2, 0)[None]
                .contiguous(), up(r, f)[None].contiguous(), 8, LOOK, oy,
                want_pred=False)
            assert torch.equal(got[k], group_sum(m8[0], f).float()), (C, k)


def test_subpel_classes_plain_matches_each_class():
    planes, oy = planes_and_picture(seed=3)
    classes = [subpel_class(S, 20 + S) for S in (16, 8, 32)]
    got = grid_subpel_classes_plain(planes, oy, classes, LOOK)
    for cl, g in zip(classes, got):
        want = grid_subpel_plain(planes, oy, *cl[:2], *cl[2:], LOOK)
        assert g.dtype == torch.int32 and torch.equal(g, want), cl[2]
        # the CPU wrappers take the plain version
        assert torch.equal(grid_subpel(planes, oy, *cl, LOOK), want)
    assert all(torch.equal(a, b) for a, b in zip(
        grid_subpel_classes(planes, oy, classes, LOOK), got))
    # flat planes: all nine points tie in both rounds, so (-1, -1) of
    # OFFS9 wins each: the half-pel (-2, -2), then the quarter-pel (-1, -1)
    planes, oy = flat_planes()
    classes = [subpel_class(S, 30 + S) for S in (8, 16, 32)]
    for cl, g in zip(classes, grid_subpel_classes_plain(planes, oy, classes,
                                                        LOOK)):
        assert torch.equal(g, cl[0] * 4 - 3), cl[2]


@pytest.mark.cuda
def test_cuda_grid_planes_match_plain(cuda_device):
    dev = cuda_device
    rng = np.random.default_rng(5)
    # (luma, n, h, w, pad, y0, hm, wm): whole tiles, ragged windows, the
    # store widths 8 (wm % 8 == 0), 4 and 1, a row origin past 0
    cases = [(True, 4, 64, 128, 16, 0, 80, 152),
             (True, 2, 70, 90, 10, 5, 75, 100),
             (True, 3, 48, 61, 9, 3, 50, 69),
             (False, 6, 32, 64, 8, 0, 44, 72),
             (False, 4, 35, 45, 6, 4, 33, 52),
             (False, 2, 20, 30, 5, 2, 21, 35)]
    for luma, n, h, w, pad, y0, hm, wm in cases:
        stack = torch.as_tensor(rng.integers(0, 256, (n, h, w)),
                                dtype=torch.int32, device=dev)
        wps = [None, (torch.as_tensor(rng.integers(-40, 200, n),
                                      dtype=torch.int32, device=dev),
                      torch.as_tensor(rng.integers(-30, 30, n),
                                      dtype=torch.int32, device=dev), 6)]
        for wp in wps:
            a = grid_planes(stack, luma, pad, hm, wm, wp, y0)
            b = grid_planes_plain(stack, luma, pad, hm, wm, wp, y0)
            assert torch.equal(a, b), (luma, n, h, w, y0, hm, wm, wp is None)


@pytest.mark.cuda
def test_cuda_grid_satd_cost_matches_plain(cuda_device):
    dev = cuda_device
    planes, oy = planes_and_picture(dev)
    lam = torch.tensor(np.float32(9.25), device=dev)

    def fields(S, seed, n):
        return [SatdField(*cu_grid(S, seed + k, reach=LOOK - 1, dev=dev), S,
                          H // S, W // S, 0, 3.0 * S + 0.1) for k in range(n)]

    calls = [(fields(S, S, n), "z") for S in (8, 16, 32, 64) for n in (1, 2, 3)]
    calls.append((fields(16, 3, 1) + fields(8, 4, 1) + fields(32, 5, 1), "z"))
    for C in (8, 16):
        mv, ref = cu_grid(C, C, dev=dev)
        hc, wc = mv.shape[:2]
        calls.append(([SatdField(mv, ref, C, hc, wc, k)
                       for k in (1, 2, 3, 4)], "plain"))
        calls.append(([SatdField(mv, ref, C, hc - 2, wc - 2, k)
                       for k in (0, 2, 4)], "plain"))
    for fl, mode in calls:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = grid_satd_cost(planes, oy, fl, LOOK, mode, lam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = grid_satd_cost_plain(planes, oy, fl, LOOK, mode, lam)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), (mode, [f.size for f in fl])


@pytest.mark.cuda
def test_cuda_grid_satd_gather_matches_plain(cuda_device):
    dev = cuda_device
    planes, _ = planes_and_picture(dev)
    rng = np.random.default_rng(9)
    ref = torch.as_tensor(rng.integers(0, 256, (2 * NREF, H // 2, W // 2)),
                          dtype=torch.int32, device=dev)
    planes_c = grid_planes(ref, False, LOOK // 2 + 2, H // 2 + LOOK,
                           W // 2 + LOOK)
    for rows, cols in ((H // 8, W // 8), (H // 8 - 3, W // 8 - 5)):
        mv, r = cu_grid(8, 11 + rows, rows, cols, reach=LOOK // 2 - 1,
                        dev=dev)
        args = (planes, planes_c, mv, r, LOOK, LOOK // 2)
        for x, y in zip(grid_mc(*args), grid_mc_plain(*args)):
            assert torch.equal(x, y), (rows, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S8", "S16", "S32", "fused"])
def test_cuda_grid_subpel_matches_plain(cuda_device, case):
    dev = cuda_device
    sizes = (8, 16, 32) if case == "fused" else (int(case[1:]),)
    for flat in (False, True):
        planes, oy = flat_planes(dev) if flat else planes_and_picture(dev, 7)
        # whole CU grids, oy in 16-byte loads (wo % 4 == 0); cut grids
        # (dead teams), then also oy in single loads (wo 127)
        for oyc, cut in ((oy, False), (oy, True),
                         (oy[:, : W - 1].contiguous(), True)):
            classes = [subpel_class(
                S, 50 + S + cut, (H // S - 1 if cut and S < 32 else None),
                (W // S - 1 if cut else None), dev) for S in sizes]
            before = LAUNCHES["grid_subpel"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = grid_subpel_classes(planes, oyc, classes, LOOK)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert LAUNCHES["grid_subpel"] - before == 1
            want = grid_subpel_classes_plain(planes, oyc, classes, LOOK)
            for cl, g, w_ in zip(classes, got, want):
                assert g.dtype == w_.dtype and torch.equal(g, w_), (
                    case, flat, oyc.shape, cut, cl[2])
            if len(classes) == 1:
                assert torch.equal(grid_subpel(planes, oyc, *classes[0],
                                               LOOK), want[0])
