"""`grid_wp_me` (the weighted full-pel ME references of explicit weighted
prediction, `ops/grid_me.py`; tpuhevc/codec/inter_grid.py:2352-2362):

- on the CPU, the plain version against a numpy int64 twin of
  clip(((ref * w + ((1 << d) >> 1)) >> d) + o, 0, 255), denominators 0-7,
  negative weights and offsets, clipping at 0 and 255;
- on the card, the kernel (16-byte runs on a (chunk, reference) grid)
  against plain with `torch.equal`: 1 and 4 references of a 416x240
  picture, stripe-shaped stacks (64 rows with halo rows) at d 0 and 7,
  negative weights and offsets that clip at both ends, two launches back
  to back, and the wrapper's refusals (rows that are not whole 16-sample
  runs, data that is not 16-byte aligned).

No JAX: `tests/test_torch_grid_fme_wp.py` holds the plain version
against tpuhevc's `weight_fullpel_np`.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.grid_me import grid_wp_me, grid_wp_me_plain

W, H = 416, 240
KY = 72  # the anchor's halo rows a stripe carries (sr_full 64)


def stack(nref, h, w=W, seed=0):
    return rng_planes(seed, h, w, nref)


def weights(nref, d, seed, extreme=False):
    """Weights (1 << d) + delta and offsets, int32; `extreme`: negative
    weights and offsets at the HEVC ranges' ends."""
    rng = np.random.default_rng(seed)
    if extreme:
        w = np.array([-128, (1 << d) + 127, -1, 3][:nref], np.int32)
        o = np.array([127, -128, 100, -100][:nref], np.int32)
    else:
        w = ((1 << d) + rng.integers(-60, 61, nref)).astype(np.int32)
        o = rng.integers(-40, 41, nref).astype(np.int32)
    return w, o


def numpy_twin(ref, w, o, d):
    r = ref.astype(np.int64)
    rnd = (1 << d) >> 1
    return np.clip(((r * w[:, None, None] + rnd) >> d) + o[:, None, None],
                   0, 255).astype(np.int32)


def test_wp_me_plain_matches_numpy():
    ref = stack(4, 48, 64, seed=3)
    for d in range(8):
        for extreme in (False, True):
            w, o = weights(4, d, d, extreme)
            got = grid_wp_me_plain(torch.from_numpy(ref), torch.from_numpy(w),
                                   torch.from_numpy(o), d)
            want = numpy_twin(ref, w, o, d)
            np.testing.assert_array_equal(got.numpy(), want, f"d {d}")
            if extreme:
                assert (want == 0).any() and (want == 255).any()


def on_card(dev, ref, w, o, d):
    """The kernel and plain on the card; equal, the launch counted."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ref, w, o)]
    before = LAUNCHES["grid_wp_me"]
    got = grid_wp_me(*args, d)
    assert LAUNCHES["grid_wp_me"] == before + 1
    want = grid_wp_me_plain(*args, d)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("nref", [1, 4])
def test_cuda_wp_me_picture(cuda_device, nref):
    w, o = weights(nref, 6, nref)
    on_card(cuda_device, stack(nref, H), w, o, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [0, 7])
def test_cuda_wp_me_stripes(cuda_device, d):
    """A middle stripe's stack (halo rows above and below) and the top
    stripe's (below only), four references."""
    for rows in (KY + 64 + KY, 64 + KY):
        w, o = weights(4, d, rows + d)
        on_card(cuda_device, stack(4, rows, seed=d), w, o, d)


@pytest.mark.cuda
def test_cuda_wp_me_clips_both_ends(cuda_device):
    for d in (0, 5, 7):
        w, o = weights(4, d, d, extreme=True)
        got = on_card(cuda_device, stack(4, H, seed=d), w, o, d)
        assert (got == 0).any() and (got == 255).any()


@pytest.mark.cuda
def test_cuda_wp_me_back_to_back_and_refusals(cuda_device):
    ref = torch.from_numpy(stack(4, H, seed=9)).to(cuda_device)
    pairs = [weights(4, d, 20 + d) for d in (2, 6)]
    args = [(ref, torch.from_numpy(w).to(cuda_device),
             torch.from_numpy(o).to(cuda_device), d)
            for (w, o), d in zip(pairs, (2, 6))]
    got = [grid_wp_me(*a) for a in args]  # queued without a sync between
    want = [grid_wp_me_plain(*a) for a in args]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    w, o, d = args[0][1:]
    flat = torch.zeros(4 * H * W + 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        grid_wp_me(flat[1 : 1 + 4 * H * W].view(4, H, W), w, o, d)
    with pytest.raises(ValueError, match="16-sample"):
        grid_wp_me(ref[:, :, :408].contiguous(), w, o, d)
