"""A mesh of devices, and row-stripe sharding with halo copies.

Counterpart of `tpuhevc/parallel/mesh.py`. JAX drives a mesh from one
controller and moves halos with `ppermute` inside `shard_map`; here one
process holds an ordered list of `torch.device`s, runs each stripe's
kernel on its device in turn, with that device current (the launches
are asynchronous, so stripes on different cards may overlap; not
measured), and a halo exchange is an explicit `tensor.to(device)` of
the boundary rows to the neighbour's device (no copy where both stripes
share a device). On the CPU a mesh is n x `cpu`; on a host with one card
n x `cuda:0`, which runs the stripes one after the other on that card;
with four cards `cuda:0..3`. No process group: NCCL cannot form a group
of more than one rank on one card, and one process needs none.

- `tile_prescreen`: the open-loop 35-mode 8x8 SATD argmin of a luma
  plane on row stripes with a one-row halo (kernel `stripe_prescreen`,
  one launch a stripe);
- `stripe_refine`: the grid step's full-pel refine (kernel `grid_refine`)
  per stripe, with `sr + 24` halo rows above and below read through
  `ry_y0`, equal to the refine of the whole picture;
- not ported: `sharded_frame_step` (the whole grid step on stripes;
  ROADMAP queue 1, item 7) and `dp_shard` (data-parallel NN-FME
  training, item 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.inter_grid import GridStep
from ..codec.params import p_frame_lambda
from ..device import on_device, resolve
from ..ops.stripe_prescreen import stripe_prescreen


@dataclass(frozen=True)
class Mesh:
    """An ordered list of devices."""

    devices: tuple

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(resolve(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """n devices: n x `cpu` for device "cpu"; for "cuda" the cards in turn
    from the named (or current) one, n x `cuda:0` on a host with one card.
    A CUDA device that is absent raises."""
    dev = resolve(device)
    if dev.type == "cpu":
        return Mesh((dev,) * n_devices)
    count = torch.cuda.device_count()
    return Mesh(tuple(torch.device("cuda", (dev.index + k) % count)
                      for k in range(n_devices)))


def _stripes(x: torch.Tensor, mesh: Mesh) -> list:
    """x split by rows into mesh.size stripes, stripe k on device k."""
    h = x.shape[0] // mesh.size
    return [x[k * h : (k + 1) * h].to(dev).contiguous()
            for k, dev in enumerate(mesh.devices)]


def _gather(parts: list, mesh: Mesh) -> torch.Tensor:
    """Per-stripe results concatenated by rows on the mesh's first
    device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def tile_prescreen(mesh: Mesh, height: int, width: int, bit_depth: int = 8):
    """-> fn: luma plane (height, width) int32 -> (mode, cost) (height / 8,
    width / 8) int32 on the mesh's first device: the open-loop 35-mode
    SATD prescreen, row-stripe sharded over the mesh, each stripe's top
    reference row copied from the stripe above (mid-grey for the first).
    The height must split into stripes of whole 8x8 block rows."""
    n = mesh.size
    if height % (8 * n) or width % 8:
        raise ValueError(f"tile_prescreen: {width}x{height} does not split "
                         f"into {n} stripes of 8x8 blocks")
    mid = 1 << (bit_depth - 1)

    def fn(plane: torch.Tensor):
        if tuple(plane.shape) != (height, width):
            raise ValueError(f"tile_prescreen: plane {tuple(plane.shape)}, "
                             f"expected {(height, width)}")
        stripes = _stripes(plane, mesh)
        modes, costs = [], []
        for k, dev in enumerate(mesh.devices):
            halo = (torch.full((1, width), mid, dtype=torch.int32, device=dev)
                    if k == 0 else stripes[k - 1][-1:].to(dev))
            with on_device(dev):
                m, c = stripe_prescreen(stripes[k], halo, bit_depth)
            modes.append(m)
            costs.append(c)
        return _gather(modes, mesh), _gather(costs, mesh)

    return fn


def stripe_refine(cfg, nn_by_qp: dict, mesh: Mesh):
    """The grid step's full-pel ME refine (`GridStep.refine`, kernel
    `grid_refine`) on CTU-row stripes. Returns (sharded, single, halo):
    both map (oy (H, W), ry (H, W), cx4, cy4 (H/16, W/16)) int32, the
    coarse winners in 2-sample units, to (mv (n16, 2), sad9 (n16, 9), cost
    (n16,)) int32 on the mesh's first device, over the grids of the coarse
    winner and of the zero MV. Each stripe reads `halo` = sr + 24 rows of
    the stripes above and below (copied over), or its own edge row
    replicated at the picture's edges, so the sharded refine equals the
    single one wherever a stripe covers the halo (raised otherwise). The
    lambda, DC clamps and MV limit are the grid step's at GOP position
    0."""
    steps = {}

    def step_on(dev):
        if dev not in steps:
            with on_device(dev):
                steps[dev] = GridStep(cfg, nn_by_qp, dev)
        return steps[dev]

    step0 = step_on(mesh.devices[0])
    H, W, n = step0.H, step0.W, mesh.size
    qp = step0.qps[0]
    lam_me = int(round(np.sqrt(p_frame_lambda(cfg, 0, qp)) * 256))
    if H % (16 * n):
        raise ValueError(f"stripe_refine: height {H} does not split into "
                         f"{n} stripes of 16-row blocks")
    hs = H // n
    # a block row's reference reach: the coarse centre (<= sr), the
    # window margin and the block
    halo = step0.sr + 24
    if hs < halo:
        raise ValueError(f"stripe_refine: stripes of {hs} rows do not cover "
                         f"the {halo}-row halo")

    def starts(cx4, cy4):
        return [(cx4 * 2, cy4 * 2), (torch.zeros_like(cx4),) * 2]

    def sharded(oy, ry, cx4, cy4):
        oys, rys = _stripes(oy, mesh), _stripes(ry, mesh)
        cxs, cys = _stripes(cx4, mesh), _stripes(cy4, mesh)
        outs = []
        for k, dev in enumerate(mesh.devices):
            up = (rys[k - 1][-halo:].to(dev) if k > 0
                  else rys[k][:1].expand(halo, W))
            dn = (rys[k + 1][:halo].to(dev) if k < n - 1
                  else rys[k][-1:].expand(halo, W))
            ry_loc = torch.cat([up, rys[k], dn])
            step = step_on(dev)
            with on_device(dev):
                main, _ = step.refine(ry_loc, oys[k], starts(cxs[k], cys[k]),
                                      16, hs // 16, W // 16, qp, lam_me,
                                      ry_y0=halo)
            outs.append(main)
        return tuple(_gather([o[i] for o in outs], mesh) for i in range(3))

    def single(oy, ry, cx4, cy4):
        dev = mesh.devices[0]
        with on_device(dev):
            main, _ = step0.refine(ry.to(dev).contiguous(), oy.to(dev),
                                   starts(cx4.to(dev), cy4.to(dev)), 16,
                                   H // 16, W // 16, qp, lam_me)
        return main

    return sharded, single, halo

