"""The grid step's motion search (kernels `grid_coarse`, `grid_prestage`
and `grid_refine`, `ops/grid_me.py`) and its intra-16 candidate (kernel
`grid_intra16`) against their plain versions. Imports no JAX.

On the CPU:
- `grid_refine_refs_plain` over a stack of 4 references at 64x48 (S = 16
  with the quadrants, S = 32) equals `grid_refine_plain` on each
  reference's starts followed by the reference loop's merge (`acc_init`,
  then `merge_acc` on a strict less in reference order, as
  `tpuhevc/codec/inter_grid.py:2453-2512` merges): with the reference
  bits, with one reference (no bits), and with two equal reference
  planes, where the earlier reference wins every tie;
- `grid_prestage` (its plain version) equals the strict-less running
  best over k in order of `ps_row` (:2395-2416), in numpy, on a picture
  and on a flat one where every offset ties.

On a card (`cuda`; skipped here), every output `torch.equal`:
- `grid_coarse` (the stack, with and without the sums) and
  `grid_prestage` (the pick) against their plain versions at the
  anchor's two shapes (416x240: n = 17 on the 2x-pooled level, tile 8;
  n = 33 on the 4x-pooled level, tile 4), at the 3-stripe shapes (64,
  64 and 112 rows), at tile counts that are no multiple of a block's
  strip, and on flat planes with equal costs, where the first index wins;
- `grid_refine_refs` against its plain version at the anchor picture's
  shapes (416x240: S = 16 with the quadrants, S = 32, 5 + 3 starts),
  with a row origin ry_y0 > 0 and starts that reach the plane's edges,
  and `grid_refine` (one reference) split and unsplit over blocks;
- two split S = 32 launches on two streams of one card, not
  synchronised between: each has its own candidate scratch and tickets,
  each equals plain, the tickets are left at 0;
- `grid_intra16` against its plain version on cells with every
  availability pattern (none available: all 128; edge cells; `avtr` /
  `avbl` false), from row 0 and from y0 = 1, deciding (`cur`) and with the
  modes given.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc_torch.ops.grid_intra import grid_intra16, grid_intra16_plain
from tpuhevc_torch.ops import grid_me as gm
from tpuhevc_torch.ops.grid_me import (
    grid_coarse, grid_coarse_plain, grid_prestage, grid_prestage_plain,
    grid_refine, grid_refine_plain, grid_refine_refs, grid_refine_refs_plain,
    tile_sum)

REF_BITS = (1, 2, 3, 3)  # GridStep.ref_bits_me with four references
LAM, DCC, DCC8, LIM = 380, 900, 250, 67


def refine_inputs(h, w, nref, S, G0, seed, reach=24, halo=0, equal=False):
    """(ry stack (nref, h + 2 halo, w), oy (h, w), reference-major starts
    (G0 + nref - 1, nb, 2), sref) from a seed; with `equal` (four
    references) planes 2 and 3 are the same, their reference bits too, the
    picture is plane 2 with a little noise and both start at the zero MV:
    a tie between references 2 and 3 in most blocks."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * halo, w))
    ry = np.stack([np.clip(np.roll(base, (r, 2 * r), (0, 1))
                           + rng.integers(-6, 7, base.shape), 0, 255)
                   for r in range(nref)])
    oy = np.clip(np.roll(base[halo : halo + h], (1, -3), (0, 1))
                 + rng.integers(-4, 5, (h, w)), 0, 255)
    nb = (h // S) * (w // S)
    G = G0 + nref - 1
    st = rng.integers(-reach, reach + 1, (G, nb, 2))
    st[1] = 0
    if equal:
        ry[3] = ry[2]
        oy = np.clip(ry[2, halo : halo + h] + rng.integers(-2, 3, (h, w)),
                     0, 255)
        st[G0 + 1] = st[G0 + 2] = 0
    sref = np.array([0] * G0 + list(range(1, nref)))
    i32 = dict(dtype=torch.int32)
    return (torch.as_tensor(ry, **i32), torch.as_tensor(oy, **i32),
            torch.as_tensor(st, **i32), torch.as_tensor(sref, **i32))


def merged(ry, oy, S, nbh, nbw, st, sref, quads, bits):
    """Per reference `grid_refine_plain` over its starts, merged in
    reference order as the reference loop merges (acc_init, merge_acc)."""
    def acc_init(m):
        mv, sad9, cost = m
        return [cost + ((REF_BITS[0] * LAM) >> 8) if bits else cost, mv,
                sad9, torch.zeros_like(cost)]

    def merge_acc(acc, m, r):
        mv, sad9, cost = m
        cost = cost + ((REF_BITS[r] * LAM) >> 8)
        take = cost < acc[0]
        acc[0] = torch.where(take, cost, acc[0])
        acc[1] = torch.where(take[:, None], mv, acc[1])
        acc[2] = torch.where(take[:, None], sad9, acc[2])
        acc[3] = torch.where(take, torch.full_like(acc[3], r), acc[3])

    accs = None
    for r in range(ry.shape[0]):
        m = grid_refine_plain(ry[r], oy, S, nbh, nbw, st[sref == r], quads,
                              DCC, DCC8, LAM, LIM)
        parts = [m[0]] + ([m[1]] if quads else [])
        if accs is None:
            accs = [acc_init(p) for p in parts]
        else:
            for acc, p in zip(accs, parts):
                merge_acc(acc, p, r)
    # (mv, sad9, cost, ref) as grid_refine_refs orders them
    return [(a[1], a[2], a[0], a[3]) for a in accs]


@pytest.mark.parametrize("case", ["four references", "one reference",
                                  "equal planes"])
def test_refine_refs_plain_equals_per_reference_picks_and_merge(case):
    h, w = 48, 64
    nref = 1 if case == "one reference" else 4
    bits = torch.as_tensor(REF_BITS, dtype=torch.int32) if nref > 1 else None
    for S, quads in ((16, True), (32, False)):
        ry, oy, st, sref = refine_inputs(h, w, nref, S, 5, seed=S + nref,
                                         equal=case == "equal planes")
        nbh, nbw = h // S, w // S
        got = grid_refine_refs_plain(ry, oy, S, nbh, nbw, st, quads, DCC,
                                     DCC8, LAM, LIM, 0, sref, bits)
        want = merged(ry, oy, S, nbh, nbw, st, sref, quads, bits is not None)
        for g, x in zip([got[0]] + ([got[1]] if quads else []), want):
            for a, b in zip(g, x):
                assert a.dtype == torch.int32 and torch.equal(a, b.int())
        if case == "equal planes":
            # references 2 and 3 tie: the earlier one wins every block
            ref = got[0][3]
            assert not bool((ref == 3).any())
            assert int((ref == 2).sum()) > ref.numel() // 2
        if case == "four references":
            assert len(set(got[0][3].tolist())) > 1  # the merge takes some


@pytest.mark.cuda
def test_cuda_refine_refs_matches_plain(cuda_device):
    H, W, halo = 240, 416, 40
    bits = torch.as_tensor(REF_BITS, dtype=torch.int32, device=cuda_device)
    for S, quads in ((16, True), (32, False)):
        ry, oy, st, sref = (t.to(cuda_device) for t in refine_inputs(
            H, W, 4, S, 5, seed=S, reach=80, halo=halo))
        # starts reaching past the plane's edges
        st[0, 0] = torch.as_tensor([-80, -80], device=cuda_device)
        st[2, -1] = torch.as_tensor([80, 80], device=cuda_device)
        for y0 in (0, halo):
            args = (ry, oy, S, H // S, W // S, st, quads, DCC, DCC8, LAM, LIM,
                    y0, sref, bits)
            got, want = grid_refine_refs(*args), grid_refine_refs_plain(*args)
            torch.cuda.synchronize()
            for part in (0, 1) if quads else (0,):
                for g, x in zip(got[part], want[part]):
                    assert torch.equal(g, x)
        # one reference, 2 starts (split over blocks) and 8 (one block)
        for G in (2, 8):
            args = (ry[0], oy, S, H // S, W // S, st[:G].contiguous(), quads,
                    DCC, DCC8, LAM, LIM, halo)
            got, want = grid_refine(*args), grid_refine_plain(*args)
            for part in (0, 1) if quads else (0,):
                for g, x in zip(got[part], want[part]):
                    assert torch.equal(g, x)


def prestage_bits(n):
    """The prestage's MV bits of each offset (`GridStep.pre_bits`), int32."""
    d = np.abs(np.arange(n) - n // 2) * 16
    lb = 2 * np.ceil(np.log2(2.0 * d + 1.0)).astype(np.int64)
    return torch.as_tensor((lb[:, None] + lb[None, :] + 2).reshape(-1),
                           dtype=torch.int32)


def pooled_pair(h, w, f, n, seed, flat=False):
    """A picture and a moved, noisy reference of h x w, f x f pooled, the
    reference edge-padded by n // 2 pooled samples -> (cur, refp) int32."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h, w))
    cur = np.clip(np.roll(ref, (5, -9), (0, 1))
                  + rng.integers(-5, 6, (h, w)), 0, 255)
    if flat:
        ref[:] = cur[:] = 77
    r = n // 2
    cur = tile_sum(torch.as_tensor(cur, dtype=torch.int32), f).int()
    refp = np.pad(tile_sum(torch.as_tensor(ref, dtype=torch.int32),
                           f).int().numpy(), r, mode="edge")
    return cur, torch.as_tensor(refp)


def scan_first_index(cur, refp, n, tile, shift, bits, lam):
    """`ps_row`'s scan in numpy: over k = dy n + dx in order, a strict-less
    running best of (sad << shift) + ((bits[k] lam) >> 8)."""
    c, r = cur.numpy().astype(np.int64), refp.numpy().astype(np.int64)
    h, w = c.shape
    best = np.full((h // tile, w // tile), 1 << 40)
    arg = np.zeros_like(best)
    for k in range(n * n):
        dy, dx = divmod(k, n)
        d = np.abs(r[dy : dy + h, dx : dx + w] - c)
        sad = d.reshape(h // tile, tile, w // tile, tile).sum((1, 3))
        cost = (sad << shift) + ((int(bits[k]) * lam) >> 8)
        take = cost < best
        best = np.where(take, cost, best)
        arg = np.where(take, k, arg)
    return arg


def test_prestage_plain_is_the_first_index_scan():
    n = 9
    for flat in (False, True):
        cur, refp = pooled_pair(48, 64, 4, n, seed=4, flat=flat)
        for bits, lam in ((prestage_bits(n), 1800),
                          (torch.zeros(n * n, dtype=torch.int32), 0)):
            got = grid_prestage(cur, refp, n, 4, 2, bits, lam)
            assert got.dtype == torch.int32
            want = scan_first_index(cur, refp, n, 4, 2, bits, lam)
            assert np.array_equal(got.numpy(), want)
            if flat and lam == 0:  # every offset ties: the first wins
                assert not bool(got.any())


@pytest.mark.cuda
def test_cuda_coarse_and_prestage_match_plain(cuda_device):
    """The anchor's shapes, its 3 stripes' (64, 64, 112 rows), tile
    counts that are no multiple of a block's strip (13 and 11 tiles a
    row), and flat planes where every cost ties."""
    bits33 = prestage_bits(33).to(cuda_device)
    cases = [(240, 416, 0, False), (64, 416, 1, False), (112, 416, 2, False),
             (48, 208, 3, False), (48, 176, 4, False), (64, 416, 5, True)]
    for h, w, seed, flat in cases:
        cur2, ref2 = (x.to(cuda_device) for x in pooled_pair(
            h, w, 2, 17, seed, flat))
        for sums in (True, False):
            args = (cur2, ref2, 17, 8, 1, sums)
            got, want = grid_coarse(*args), grid_coarse_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert (got[1] is None) == (not sums)
            assert not sums or torch.equal(got[1], want[1])
        cur4, ref4 = (x.to(cuda_device) for x in pooled_pair(
            h, w, 4, 33, seed, flat))
        zero = torch.zeros_like(bits33)
        for bits, lam in ((bits33, 1800), (bits33, 23000), (zero, 0)):
            args = (cur4, ref4, 33, 4, 2, bits, lam)
            got, want = grid_prestage(*args), grid_prestage_plain(*args)
            torch.cuda.synchronize()
            assert got.shape == (h // 16, w // 16) and torch.equal(got, want)
            if flat and lam == 0:
                assert not bool(got.any())


@pytest.mark.cuda
def test_cuda_refine_two_streams(cuda_device):
    """Two split S = 32 launches (8 starts over 91 blocks: chunks of
    starts meet through the candidate scratch, the last by a ticket) on
    two streams of one card, not synchronised between."""
    H, W = 240, 416
    bits = torch.as_tensor(REF_BITS, dtype=torch.int32, device=cuda_device)
    ins = [[t.to(cuda_device) for t in refine_inputs(H, W, 4, 32, 5, seed=s,
                                                      reach=40)]
           for s in (21, 22)]
    streams = [torch.cuda.Stream(cuda_device) for _ in ins]
    torch.cuda.synchronize()
    for _ in range(3):
        outs = []
        for (ry, oy, st, sref), stream in zip(ins, streams):
            with torch.cuda.stream(stream):
                outs.append(grid_refine_refs(ry, oy, 32, H // 32, W // 32, st,
                                             False, DCC, DCC8, LAM, LIM, 0,
                                             sref, bits))
        torch.cuda.synchronize()
        for (ry, oy, st, sref), (got, _) in zip(ins, outs):
            want, _ = grid_refine_refs_plain(ry, oy, 32, H // 32, W // 32, st,
                                             False, DCC, DCC8, LAM, LIM, 0,
                                             sref, bits)
            for g, x in zip(got, want):
                assert torch.equal(g, x)
    keys = [(cuda_device.index, s.cuda_stream) for s in streams]
    assert all(k in gm._SCRATCH for k in keys)
    assert gm._SCRATCH[keys[0]][0].data_ptr() != gm._SCRATCH[keys[1]][0]\
        .data_ptr()
    for k in keys:
        assert not bool(gm._SCRATCH[k][1].any())  # the tickets back at 0


def intra_cells(seed, nh, nw, y0, dev):
    """Planes with y0 rows above nh x nw 16x16 cells, the availability of
    every pattern, and a picture."""
    rng = np.random.default_rng(seed)
    H, W = nh * 16 + y0, nw * 16
    ref_y = torch.as_tensor(rng.integers(0, 256, (H, W)), dtype=torch.int32)
    ref_uv = torch.as_tensor(rng.integers(0, 256, ((H - y0) // 2 + y0, W)),
                             dtype=torch.int32)
    cur = torch.as_tensor(rng.integers(0, 256, (nh * 16, W)),
                          dtype=torch.int32)
    n = nh * nw
    avtr = torch.as_tensor(np.arange(n) % 2 == 0)
    avbl = torch.as_tensor(np.arange(n) % 3 == 0)
    return [t.to(dev) for t in (ref_y, ref_uv, avtr, avbl, cur)]


@pytest.mark.cuda
def test_cuda_intra16_matches_plain(cuda_device):
    nh, nw = 5, 7
    for y0 in (0, 1):
        ref_y, ref_uv, avtr, avbl, cur = intra_cells(y0 + 3, nh, nw, y0,
                                                     cuda_device)
        cases = [(avtr, avbl), (~avtr, ~avbl), (avtr | True, avbl | True)]
        for tr, bl in cases:
            got = grid_intra16(ref_y, ref_uv, tr, bl, nh, nw, cur=cur, y0=y0)
            want = grid_intra16_plain(ref_y, ref_uv, tr, bl, nh, nw,
                                      cur=cur, y0=y0)
            torch.cuda.synchronize()
            for g, x in zip(got, want):
                assert torch.equal(g, x)
            modes = torch.as_tensor(np.arange(nh * nw) % 7, dtype=torch.int32,
                                    device=cuda_device)
            got = grid_intra16(ref_y, ref_uv, tr, bl, nh, nw, modes=modes,
                               y0=y0)
            want = grid_intra16_plain(ref_y, ref_uv, tr, bl, nh, nw,
                                      modes=modes, y0=y0)
            for g, x in zip(got, want):
                assert torch.equal(g, x)
    # none available: a single cell at the picture's corner, every
    # boundary sample substituted by 128
    ref_y, ref_uv, avtr, avbl, cur = intra_cells(9, 1, 1, 0, cuda_device)
    got = grid_intra16(ref_y, ref_uv, avtr & False, avbl & False, 1, 1,
                       cur=cur)
    want = grid_intra16_plain(ref_y, ref_uv, avtr & False, avbl & False, 1,
                              1, cur=cur)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    dc = grid_intra16_plain(ref_y, ref_uv, avtr & False, avbl & False, 1, 1,
                            modes=torch.ones(1, dtype=torch.int32,
                                             device=cuda_device))
    assert bool((dc[1] == 128).all()) and bool((dc[2] == 128).all())
