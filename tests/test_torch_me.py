"""K1 (dense full-pel SAD search) of tpuhevc_torch.

The JAX stage (`sad_search`, a closure of inter_batch.build_ldp_scan) is
held against the port through the packed rows in test_torch_ldp_scan.py;
here the plain version meets tpuhevc.ops.me's numpy search at S=8 (no row
subsampling), the 2:1 row rule at S > 8, the first-index tie rule, and on
a GPU the kernel meets the plain version."""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc.codec.inter_batch import _blk_idx, _win_idx
from tpuhevc.ops.me import integer_me_np, sad_surface_np
from tpuhevc_torch.ops.me import bits_table, sad_search, sad_search_plain

SR = 16


def inputs(size, seed, w=96, h=64):
    ref, cur_plane = rng_planes(seed, h, w, 2)
    cur_plane = np.roll(ref, (2, -3), (0, 1)) // 2 + cur_plane // 2
    poss = [(x, y) for y in range(0, h - size + 1, size)
            for x in range(0, w - size + 1, size)]
    wnd = ref.reshape(-1)[_win_idx(poss, size, SR, w, h)]
    cur = cur_plane.reshape(-1)[_blk_idx(poss, size, w)]
    return ref, poss, wnd, cur


def test_sad_search_matches_numpy_me_at_8x8():
    ref, poss, wnd, cur = inputs(8, 1)
    lam_me = 700
    mv_t, sad9_t = sad_search(torch.from_numpy(wnd), torch.from_numpy(cur),
                              bits_table(SR, "cpu"), lam_me, SR)
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
    wnd = torch.full((n, size + 2 * SR, size + 2 * SR), 77, dtype=torch.int32)
    cur = torch.full((n, size, size), 80, dtype=torch.int32)
    mv, sad9 = sad_search(wnd, cur, bits_table(SR, "cpu"), 0, SR)
    assert mv.tolist() == [[1 - SR, 1 - SR]] * n
    assert (sad9 == 3 * size * size).all()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 16, 32])
def test_sad_search_kernel_matches_plain(cuda_device, size):
    _, _, wnd, cur = inputs(size, 3, w=416, h=240)
    bits = bits_table(SR, cuda_device)
    w_d = torch.from_numpy(wnd).to(cuda_device)
    c_d = torch.from_numpy(cur).to(cuda_device)
    for lam_me in (0, 500, 4000):
        got = sad_search(w_d, c_d, bits, lam_me, SR)
        want = sad_search_plain(w_d, c_d, bits, lam_me, SR)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    flat_w = torch.full_like(w_d[:4], 9)
    flat_c = torch.full_like(c_d[:4], 9)
    got = sad_search(flat_w, flat_c, bits, 0, SR)
    torch.cuda.synchronize()
    assert got[0].tolist() == [[1 - SR, 1 - SR]] * 4
