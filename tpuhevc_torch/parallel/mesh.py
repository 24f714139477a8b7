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
  one launch a device over the consecutive stripes it holds);
- `stripe_refine`: the grid step's full-pel refine (kernel `grid_refine`)
  per stripe, with `sr + 24` halo rows above and below read through
  `ry_y0`, equal to the refine of the whole picture;
- `sharded_frame_step`: the whole grid step (`GridStep.frame_steps`) on
  64-row stripes, the picture state (reference stacks with their halo
  rows, MV seed, collocated maps) kept in stripes, so that a picture
  sends only its new reference's halo, every cross-stripe reach an explicit
  exchange (`codec/stripes.py`: halo rows, gathered per-block fields,
  the picture's sums and SAO decision once), equal to the one-device
  step byte for byte;
- not ported: `dp_shard` (data-parallel NN-FME training, ROADMAP queue 1,
  item 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.inter_grid import (GridStep, _Tabs, grid_live_tables,
                                pack_stripes, supports)
from ..codec.params import p_frame_lambda
from ..codec.stripes import Exchange, Rows
from ..device import on_device, resolve
from ..ops.stripe_prescreen import stripe_prescreen_rows


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
    """Per-stripe (or per-device) results concatenated by rows on the
    mesh's first device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _groups(mesh: Mesh) -> list:
    """The mesh's runs of consecutive stripes on one device: [(device,
    first stripe, stripes)]."""
    out = []
    for k, dev in enumerate(mesh.devices):
        if out and out[-1][0] == dev:
            out[-1][2] += 1
        else:
            out.append([dev, k, 1])
    return out


def tile_prescreen(mesh: Mesh, height: int, width: int, bit_depth: int = 8):
    """-> fn: luma plane (height, width) int32 -> (mode, cost) (height / 8,
    width / 8) int32 on the mesh's first device: the open-loop 35-mode
    SATD prescreen, row-stripe sharded over the mesh, each stripe's top
    reference row the last row of the stripe above (mid-grey for the
    first). The stripes that sit on one device, consecutive in the mesh,
    take one launch (`stripe_prescreen_rows`): the row above the first of
    them is copied from the previous device, the others read theirs in
    place. On one card (a mesh of n x cuda:0) that is one launch, whose
    maps are returned as they are. The height must split into stripes of
    whole 8x8 block rows."""
    n = mesh.size
    if height % (8 * n) or width % 8:
        raise ValueError(f"tile_prescreen: {width}x{height} does not split "
                         f"into {n} stripes of 8x8 blocks")
    hl = height // n
    groups = _groups(mesh)

    def fn(plane: torch.Tensor):
        if tuple(plane.shape) != (height, width):
            raise ValueError(f"tile_prescreen: plane {tuple(plane.shape)}, "
                             f"expected {(height, width)}")
        modes, costs = [], []
        for dev, k, cnt in groups:
            rows = plane[k * hl : (k + cnt) * hl].to(dev).contiguous()
            halo = (None if k == 0 else
                    plane[k * hl - 1 : k * hl].to(dev).contiguous())
            with on_device(dev):
                m, c = stripe_prescreen_rows(rows, halo, hl, bit_depth)
            modes.append(m)
            costs.append(c)
        if len(groups) == 1:  # on the first device
            return modes[0], costs[0]
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



BAND = 64  # stripes start on 64-row boundaries: whole CTUs, 32 and 64 blocks


def stripe_rows(H: int, n: int) -> list:
    """n row stripes of an H-row picture: the full 64-row bands split as
    evenly as they go (the first stripes take the extra), the last stripe
    also the partial band. One stripe is the whole picture; more stripes
    than full bands raise ValueError."""
    if n == 1:
        return [Rows(0, H, H)]
    full = H // BAND
    if not 1 <= n <= full:
        raise ValueError(f"{n} stripes of a {H}-row picture: it has "
                         f"{full} full {BAND}-row CTU rows")
    base, extra = divmod(full, n)
    out, y = [], 0
    for k in range(n):
        y1 = H if k == n - 1 else y + BAND * (base + (k < extra))
        out.append(Rows(y, y1, H))
        y = y1
    return out


def sharded_frame_step(cfg, nn_by_qp: dict, mesh: Mesh):
    """The grid step's whole P picture on row stripes, stripe k on
    mesh.devices[k] (`stripe_rows`). Returns (sharded, single, meta):

    - single(carry, fu8, navail, gpos, wp=None) -> (carry, packed):
      `GridStep.frame_step` on the mesh's first device;
    - sharded(carries, fu8, navail, gpos, wp=None) -> (carries, packed):
      the stripes' carries (meta["split"] of a whole carry: each its rows
      of the reference stacks with up to KY (luma) / KY / 2 (chroma) halo
      rows each side, the MV seed and the collocated maps, on its device;
      meta["join"] takes them back) -> the next ones, still in stripes,
      and the packed row on the first device, equal to single's byte
      for byte. Each stripe's
      pixel work runs on its device with that device current; only halo
      rows, per-block fields, the per-CTU SAO statistics and partial sums
      cross between stripes (meta["exchange"] counts their bytes).

    fu8: the picture's (W*H*3/2,) uint8 planes (each stripe takes its
    rows). The decision tables are the warmed init tables of each GOP
    position (`grid_live_tables` without feedback), as tpuhevc's step
    bakes them in."""
    if not supports(cfg):
        raise ValueError("sharded_frame_step: the grid step needs a coded "
                         "size of whole 16x16 blocks at 8 bits")
    steps = {}
    for dev in mesh.devices:
        if dev not in steps:
            with on_device(dev):
                steps[dev] = GridStep(cfg, nn_by_qp, dev)
    dev0 = mesh.devices[0]
    step0 = steps[dev0]
    H, W, Hc, Wc = step0.H, step0.W, step0.Hc, step0.Wc
    rows = stripe_rows(H, mesh.size)
    live = grid_live_tables(cfg, {})
    tabs = {dev: [_Tabs(lv, dev) for lv in live] for dev in steps}
    ex = Exchange(mesh.devices)

    def split(carry):
        """A whole carry -> the stripes' carries on their devices: the
        reference stacks with the halo rows that frame_steps carries."""
        ry, ruv, mv16p, colmv, coltd = carry
        out = []
        for r, dev in zip(rows, mesh.devices):
            a, b = r.y0 - r.above(step0.KY), r.y1 + r.below(step0.KY)
            b0, b1 = r.y0 // 16, r.y1 // 16
            out.append(tuple(t.to(dev).contiguous() for t in (
                ry[:, a:b], ruv[:, a // 2 : b // 2],
                mv16p[b0 * step0.nw16 : b1 * step0.nw16], colmv[b0:b1],
                coltd[b0:b1])))
        return out

    def join(carries):
        """The stripes' carries -> the whole carry on the first device."""
        own = [(c[0][:, r.above(step0.KY) :][:, : r.y1 - r.y0],
                c[1][:, r.above(step0.KY) // 2 :][:, : (r.y1 - r.y0) // 2],
                *c[2:]) for r, c in zip(rows, carries)]
        return tuple(torch.cat([c[i].to(dev0) for c in own],
                               dim=1 if i < 2 else 0)
                     for i in range(5))

    def source(fu8, r, dev):
        """The stripe's rows of the picture's planes: (oy, ouv) int32."""
        u0, n = W * H, Wc * Hc
        oy = fu8[r.y0 * W : r.y1 * W].to(dev).reshape(-1, W)
        uv = [fu8[u0 + k * n + r.y0 // 2 * Wc : u0 + k * n + r.y1 // 2 * Wc]
              .to(dev).reshape(-1, Wc) for k in (0, 1)]
        return oy.int(), torch.cat(uv, dim=1).int()

    def sharded(carries, fu8, navail: int, gpos: int, wp=None):
        gens = []
        for r, dev, c in zip(rows, mesh.devices, carries):
            wp_d = None if wp is None else (wp[0].to(dev), wp[1].to(dev),
                                            wp[2])
            gens.append(steps[dev].frame_steps(
                c, source(fu8, r, dev), navail, gpos, tabs[dev][gpos], wp_d,
                r))
        outs = ex.run(gens)
        return [o[0] for o in outs], pack_stripes(outs, dev0)

    def single(carry, fu8, navail: int, gpos: int, wp=None):
        with on_device(dev0):
            return step0.frame_step(carry, fu8.to(dev0), navail, gpos,
                                    tabs[dev0][gpos], wp)

    meta = dict(R=step0.R, Hc=Hc, Wc=Wc, G=step0.G, rows=rows, step=step0,
                exchange=ex, split=split, join=join)
    return sharded, single, meta
