"""K1 (dense full-pel SAD search) of tpuhevc_torch.

The JAX stage (`sad_search`, a closure of inter_batch.build_ldp_scan) is
held against the port through the packed rows in test_torch_ldp_scan.py;
here the plain version meets tpuhevc.ops.me's numpy search at S=8 (no row
subsampling), the 2:1 row rule at S > 8, the first-index tie rule, the
classes' entry (windows read from the reference plane) meets the window
form on the windows of tpuhevc's `_win_idx` (PUs at every edge, S = 8,
16 and 32 in one call), and on a GPU the kernel meets the plain version."""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc.codec.inter_batch import _blk_idx, _win_idx
from tpuhevc.ops.me import integer_me_np, sad_surface_np
from tpuhevc_torch.ops.me import (bits_table, sad_search, sad_search_classes,
                                  sad_search_classes_plain, sad_search_plain)

SR = 16


def inputs(size, seed, w=96, h=64):
    ref, cur_plane = rng_planes(seed, h, w, 2)
    cur_plane = np.roll(ref, (2, -3), (0, 1)) // 2 + cur_plane // 2
    poss = [(x, y) for y in range(0, h - size + 1, size)
            for x in range(0, w - size + 1, size)]
    wnd = ref.reshape(-1)[_win_idx(poss, size, SR, w, h)]
    cur = cur_plane.reshape(-1)[_blk_idx(poss, size, w)]
    return ref, poss, wnd, cur


def origins(poss):
    return (torch.tensor([p[0] for p in poss], dtype=torch.int32),
            torch.tensor([p[1] for p in poss], dtype=torch.int32))


def test_sad_search_matches_numpy_me_at_8x8():
    ref, poss, wnd, cur = inputs(8, 1)
    lam_me = 700
    mv_t, sad9_t = sad_search(torch.from_numpy(ref), torch.from_numpy(cur),
                              *origins(poss), bits_table(SR, "cpu"), lam_me,
                              SR, bit_depth=8)
    xs = np.array([p[0] for p in poss])
    ys = np.array([p[1] for p in poss])
    mv_n, sad, best = integer_me_np(ref, cur, xs, ys, SR, lam_me)
    np.testing.assert_array_equal(mv_t.numpy(), mv_n)
    np.testing.assert_array_equal(sad9_t.numpy(), sad_surface_np(sad, best))


@pytest.mark.parametrize("size", [16, 32])
def test_sad_search_subsamples_rows(size):
    """Rows 0, 2, 4, ... only, sum << 1: equal to the full search on the
    even rows (a 2x taller offset grid read every other row)."""
    ref, poss, wnd, cur = inputs(size, 2)
    bits = bits_table(SR, "cpu")
    mv, sad9 = sad_search_plain(torch.from_numpy(wnd), torch.from_numpy(cur),
                                bits, 0, SR)
    m = 2 * SR + 1
    n = len(poss)
    sad = np.zeros((n, m, m), np.int64)
    for dy in range(m):
        for dx in range(m):
            d = wnd[:, dy : dy + size : 2, dx : dx + size] - cur[:, ::2, :]
            sad[:, dy, dx] = np.abs(d).sum((1, 2)) << 1
    inner = sad[:, 1:-1, 1:-1].reshape(n, -1)
    bi = inner.argmin(1)
    want_mv = np.stack([bi % (m - 2) + 1 - SR, bi // (m - 2) + 1 - SR], -1)
    np.testing.assert_array_equal(mv.numpy(), want_mv)
    np.testing.assert_array_equal(sad9.numpy()[:, 4],
                                  sad[np.arange(n), want_mv[:, 1] + SR,
                                      want_mv[:, 0] + SR])


def test_sad_search_first_minimum_wins():
    """Flat planes and no rate term: every cost ties, so the first inner
    offset (row-major) wins, as jnp.argmin returns it."""
    n, size = 3, 16
    ref = torch.full((48, 64), 77, dtype=torch.int32)
    cur = torch.full((n, size, size), 80, dtype=torch.int32)
    xs = torch.tensor([0, 16, 48], dtype=torch.int32)
    ys = torch.tensor([0, 32, 16], dtype=torch.int32)
    mv, sad9 = sad_search(ref, cur, xs, ys, bits_table(SR, "cpu"), 0, SR,
                          bit_depth=8)
    assert mv.tolist() == [[1 - SR, 1 - SR]] * n
    assert (sad9 == 3 * size * size).all()


def edge_classes(seed, w=96, h=64):
    """A reference plane and one class each of S = 32, 16 and 8, their PUs
    against all four edges of the plane and inside it: [(S, poss, cur)]."""
    ref, cur_plane = rng_planes(seed, h, w, 2)
    cur_plane = np.roll(ref, (3, -2), (0, 1)) // 2 + cur_plane // 2
    out = []
    for size in (32, 16, 8):
        poss = [(0, 0), (w - size, 0), (0, h - size), (w - size, h - size),
                (32, 16), (w - size, 16)]
        out.append((size, poss, cur_plane.reshape(-1)[_blk_idx(poss, size,
                                                                 w)]))
    return ref, out


@pytest.mark.parametrize("subsample", [True, False])
@pytest.mark.parametrize("sr", [1, 16])
def test_sad_search_classes_plain_matches_windows(sr, subsample):
    """The classes' entry on the plane equals the window form on the
    windows that tpuhevc's `_win_idx` gathers (rows and columns clamped to
    the plane), class by class, S = 32, 16 and 8 in one call."""
    ref, classes = edge_classes(4)
    h, w = ref.shape
    bits = bits_table(sr, "cpu")
    got = sad_search_classes_plain(
        torch.from_numpy(ref),
        [(torch.from_numpy(cur), *origins(poss)) for _, poss, cur in classes],
        bits, 900, sr, subsample)
    assert len(got) == 3
    for (size, poss, cur), (mv, sad9) in zip(classes, got):
        wnd = ref.reshape(-1)[_win_idx(poss, size, sr, w, h)]
        want = sad_search_plain(torch.from_numpy(wnd), torch.from_numpy(cur),
                                bits, 900, sr, subsample)
        assert torch.equal(mv, want[0]) and torch.equal(sad9, want[1])
        assert mv.abs().max() <= sr - 1


@pytest.mark.parametrize("sr", [1, 16])
def test_sad_search_classes_flat_first_index(sr):
    """lam_me 0 on flat planes: every cost ties in every class, so the
    first inner index wins: mv (1 - sr, 1 - sr), sad9 all equal."""
    ref = torch.full((64, 96), 120, dtype=torch.int32)
    _, classes = edge_classes(5)
    cls = [(torch.full((len(poss), size, size), 117, dtype=torch.int32),
            *origins(poss)) for size, poss, _ in classes]
    got = sad_search_classes(ref, cls, bits_table(sr, "cpu"), 0, sr,
                             bit_depth=8)
    for (size, poss, _), (mv, sad9) in zip(classes, got):
        assert mv.tolist() == [[1 - sr, 1 - sr]] * len(poss)
        assert (sad9 == 3 * size * size).all()


def test_sad_search_names_its_bit_depth():
    """K1's kernel has a variant for 8-bit and one for 10-bit samples: its
    callers name the depth (never the data), a depth without a variant
    raises, and the plain sums are the same at either depth."""
    ref, poss, _, cur = inputs(16, 2)
    args = (torch.from_numpy(ref), torch.from_numpy(cur), *origins(poss),
            bits_table(SR, "cpu"), 300, SR)
    with pytest.raises(TypeError):
        sad_search(*args)
    for bd in (9, 12):
        with pytest.raises(ValueError, match=f"bit depth {bd}"):
            sad_search(*args, bit_depth=bd)
    got8, got10 = (sad_search(*args, bit_depth=bd) for bd in (8, 10))
    assert all(torch.equal(a, b) for a, b in zip(got8, got10))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 16, 32])
def test_sad_search_kernel_matches_plain(cuda_device, size):
    ref, poss, _, cur = inputs(size, 3, w=416, h=240)
    bits = bits_table(SR, cuda_device)
    r_d = torch.from_numpy(ref).to(cuda_device)
    c_d = torch.from_numpy(cur).to(cuda_device)
    xs, ys = (t.to(cuda_device) for t in origins(poss))
    for lam_me in (0, 500, 4000):
        for sub in (True, False):
            got = sad_search(r_d, c_d, xs, ys, bits, lam_me, SR, sub,
                             bit_depth=8)
            want = sad_search_classes_plain(r_d, [(c_d, xs, ys)], bits,
                                            lam_me, SR, sub)[0]
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    flat_r = torch.full_like(r_d, 9)
    flat_c = torch.full_like(c_d[:4], 9)
    got = sad_search(flat_r, flat_c, xs[:4], ys[:4], bits, 0, SR,
                     bit_depth=8)
    torch.cuda.synchronize()
    assert got[0].tolist() == [[1 - SR, 1 - SR]] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [1, 7, 16])
def test_sad_search_classes_kernel_matches_plain(cuda_device, sr):
    """The three classes at every edge in one launch, subsample on and
    off, lam_me 0 and 900, textured and flat planes."""
    ref, classes = edge_classes(6)
    r_d = torch.from_numpy(ref).to(cuda_device)
    cls = [(torch.from_numpy(cur).to(cuda_device),
            *(t.to(cuda_device) for t in origins(poss)))
           for _, poss, cur in classes]
    flat = (torch.full_like(r_d, 120),
            [(torch.full_like(c, 117), xs, ys) for c, xs, ys in cls])
    bits = bits_table(sr, cuda_device)
    for plane, cs in ((r_d, cls), flat):
        for lam_me in (0, 900):
            for sub in (True, False):
                got = sad_search_classes(plane, cs, bits, lam_me, sr, sub,
                                         bit_depth=8)
                want = sad_search_classes_plain(plane, cs, bits, lam_me, sr,
                                                sub)
                torch.cuda.synchronize()
                for g, w_ in zip(got, want, strict=True):
                    assert torch.equal(g[0], w_[0])
                    assert torch.equal(g[1], w_[1])
