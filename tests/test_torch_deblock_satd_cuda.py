"""`grid_deblock` and `satd35_topk` on the card against their plain
versions on the same card, `torch.equal` (no JAX):

- `grid_deblock` (one launch a picture over owned tiles) on the
  adversarial inputs of `deblock_inputs` (flat 8x8 blocks with steps,
  noise, every cell intra, RQT depth 2 at CU 32, far motion at every
  edge) at QP 22, 37 and 51, at 416x240, at a 128-row stripe-shaped
  buffer and at the tile's smallest pictures, with the motion field at
  the grid's strides; at 1920x1088; two launches back to back; its
  inputs left as they were;
- `satd35_topk` (Hadamard teams, a warp's top-nc) at S = 4..32 on noise,
  on flat references (ties), at nc = 1, 8 and 35, and at S = 4 over
  1920x1088 (130,560 blocks).

On a machine without a card every item skips.
"""

import numpy as np
import pytest
import torch

from torch_port_util import (  # noqa: F401
    DEBLOCK_KINDS, cuda_device, deblock_inputs)
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.cost import satd35_topk, satd35_topk_plain
from tpuhevc_torch.ops.grid_deblock import grid_deblock, grid_deblock_plain

pytestmark = pytest.mark.cuda

QPS = (22, 37, 51)


def on(dev, args):
    return tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)


def check_deblock(args, qp):
    before = [a.clone() for a in args]
    n0 = LAUNCHES["grid_deblock"]
    got = grid_deblock(*args, qp)
    want = grid_deblock_plain(*args, qp)
    torch.cuda.synchronize()
    assert LAUNCHES["grid_deblock"] == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    for a, b in zip(args, before):
        assert torch.equal(a, b)  # the inputs are left as they were


@pytest.mark.parametrize("kind", DEBLOCK_KINDS)
def test_grid_deblock_matches_plain(cuda_device, kind):
    """Every adversarial kind at QP 22, 37 and 51 on a 416x240 picture,
    a 128-row stripe-shaped buffer of 416 and pictures of 16x16, 48x32
    and 80x96 (one tile, a partial last tile)."""
    for seed, (h, w) in enumerate(((240, 416), (128, 416), (16, 16),
                                   (32, 48), (96, 80))):
        args = on(cuda_device, deblock_inputs(kind, h, w, seed))
        assert not args[3].is_contiguous()  # the grid's layout
        for qp in QPS:
            check_deblock(args, qp)


def test_grid_deblock_1080p_and_back_to_back(cuda_device):
    """1920x1088 (2,040 tiles), a contiguous motion field, and two
    launches back to back on different pictures without a sync between."""
    big = on(cuda_device, deblock_inputs("noise", 1088, 1920, 7))
    check_deblock(big, 37)
    flat = list(big)
    flat[3] = flat[3].contiguous()
    check_deblock(tuple(flat), 32)
    pics = [big, on(cuda_device, deblock_inputs("steps", 240, 416, 8))]
    got = [grid_deblock(*p, 32) for p in pics]
    torch.cuda.synchronize()
    for g, p in zip(got, pics):
        for x, y in zip(g, grid_deblock_plain(*p, 32)):
            assert torch.equal(x, y)


def satd_inputs(n, S, seed, flat=False):
    rng = np.random.default_rng(seed)
    org = rng.integers(0, 256, (n, S, S))
    if flat:  # a few values: many modes price the same
        preds = np.repeat(rng.integers(0, 256, (n, 1, 1, 1)), 35, 1)
        preds = preds + (rng.integers(0, 35, (n, 35, 1, 1)) % 3)
        preds = np.broadcast_to(preds, (n, 35, S, S))
        org[: n // 2] = preds[: n // 2, 0]
    else:
        preds = np.clip(org[:, None] + rng.integers(-40, 41, (n, 35, S, S)),
                        0, 255)
    return (torch.from_numpy(np.ascontiguousarray(org, np.int32)),
            torch.from_numpy(np.ascontiguousarray(preds, np.int32)))


def test_satd35_topk_matches_plain(cuda_device):
    """S = 4..32, noise and flat references (ties: the lower mode first),
    nc = 1, 8 and 35, block counts that leave the last CTA partial."""
    for S in (4, 8, 16, 32):
        for seed, (n, flat) in enumerate(((1, False), (91, False),
                                          (390, True), (37, True))):
            org, preds = satd_inputs(n, S, seed * 10 + S, flat)
            org, preds = org.to(cuda_device), preds.to(cuda_device)
            for nc in (1, 8, 35):
                got = satd35_topk(org, preds, nc)
                want = satd35_topk_plain(org, preds, nc)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (S, n, flat, nc)
            if flat:
                assert (want[0][:, :, None] == want[0][:, None]).sum() > \
                    35 * n  # ties occur


def test_satd35_topk_s4_1080p(cuda_device):
    """S = 4 over a 1920x1088 picture: 130,560 blocks, nc 8."""
    org, preds = satd_inputs(130560, 4, 3)
    org, preds = org.to(cuda_device), preds.to(cuda_device)
    got = satd35_topk(org, preds, 8)
    want = satd35_topk_plain(org, preds, 8)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
