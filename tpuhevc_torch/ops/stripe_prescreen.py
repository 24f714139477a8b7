"""The open-loop intra prescreen of row stripes (kernel
`stripe_prescreen`), one launch a device over that device's stripes.

Twin of `local` in `tile_prescreen` (`tpuhevc/parallel/mesh.py:56-96`):
for every 8x8 block of a stripe (hl, W), from `padded` = [halo row;
stripe], its 17 top samples `padded[by][clip(bx - 1 + i, 0, W - 1)]`, its
17 left samples `padded[min(by + i, hl)][clip(bx - 1, 0, W - 1)]` (all
mid-grey at bx == 0), the 35 predictions at 8x8 luma
(`ops/intra.py:predict_all_modes_plain`), the SATD of each,
`(sum |H d H^T| + 2) >> 2` (`ops/cost.py:satd35_plain`), and the first
mode of least cost with that cost. The halo of the picture's first stripe
is mid-grey; a later stripe's is the last row of the stripe above. An
advisory analysis: the last block row of a stripe reads its below-left
samples clamped to the stripe.

`stripe_prescreen_rows(rows, halo, hl)` takes k consecutive stripes of hl
rows that sit on one device: the halo of the first is `halo` (the row
above it, copied from the previous device by `parallel/mesh.py`, or None:
mid-grey, the picture's first stripe), that of each later one the row
above it in `rows`, read in place; the maps of all k come out of one
launch of `kernels/csrc/stripe_prescreen.cu` for CUDA tensors.
`stripe_prescreen_rows_plain` is its PyTorch version, `stripe_prescreen`
its one-stripe case and `stripe_prescreen_plain` the one-stripe PyTorch
twin of the reference.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from .cost import satd35_plain
from .intra import intra_tables, predict_all_modes_plain

_INIT_DEVICES: set = set()


def _modes_costs(preds, blocks, nbh, nbw):
    """The first mode of least SATD a block, and that SATD."""
    sat = satd35_plain(blocks, preds)
    best = torch.argmin(sat, dim=1)
    cost = sat.gather(1, best[:, None])[:, 0]
    return best.int().reshape(nbh, nbw), cost.int().reshape(nbh, nbw)


def stripe_prescreen_plain(plane: torch.Tensor, halo: torch.Tensor,
                           bit_depth: int = 8):
    """plane (hl, W) int32, halo (1, W) int32 -> (mode, cost) (hl / 8,
    W / 8) int32."""
    hl, w = plane.shape
    dev = plane.device
    nbh, nbw = hl // 8, w // 8
    padded = torch.cat([halo.reshape(1, w), plane])
    by = (torch.arange(nbh, device=dev) * 8).repeat_interleave(nbw)[:, None]
    bx = (torch.arange(nbw, device=dev) * 8).repeat(nbh)[:, None]
    i = torch.arange(17, device=dev)[None]
    top = padded[by.expand(-1, 17), (bx - 1 + i).clamp(0, w - 1)]
    left = padded[(by + i).clamp(max=hl), (bx - 1).clamp(0, w - 1).expand(
        -1, 17)]
    left = torch.where(bx == 0, 1 << (bit_depth - 1), left)
    preds = predict_all_modes_plain(top, left, 8, True, bit_depth)
    blocks = plane.reshape(nbh, 8, nbw, 8).permute(0, 2, 1, 3).reshape(
        -1, 8, 8)
    return _modes_costs(preds, blocks, nbh, nbw)


def stripe_prescreen_rows_plain(rows: torch.Tensor, halo, hl: int,
                                bit_depth: int = 8):
    """rows (k hl, W) int32, k stripes of hl rows; halo (1, W) int32 the
    row above the first, or None (mid-grey) -> (mode, cost) (k hl / 8,
    W / 8) int32: each stripe's prescreen, the row above a later stripe
    its halo, each stripe's left samples clamped at its own last row."""
    h, w = rows.shape
    dev = rows.device
    mid = 1 << (bit_depth - 1)
    nbh, nbw = h // 8, w // 8
    # group row g at padded[g + 1], the row above the group at padded[0]
    above = (torch.full((1, w), mid, dtype=rows.dtype, device=dev)
             if halo is None else halo.reshape(1, w))
    padded = torch.cat([above, rows])
    by = (torch.arange(nbh, device=dev) * 8).repeat_interleave(nbw)[:, None]
    bx = (torch.arange(nbw, device=dev) * 8).repeat(nbh)[:, None]
    end = (by // hl + 1) * hl  # the block's stripe's end in the group
    i = torch.arange(17, device=dev)[None]
    top = padded[by.expand(-1, 17), (bx - 1 + i).clamp(0, w - 1)]
    left = padded[torch.minimum(by + i, end),
                  (bx - 1).clamp(0, w - 1).expand(-1, 17)]
    left = torch.where(bx == 0, mid, left)
    preds = predict_all_modes_plain(top, left, 8, True, bit_depth)
    blocks = rows.reshape(nbh, 8, nbw, 8).permute(0, 2, 1, 3).reshape(
        -1, 8, 8)
    return _modes_costs(preds, blocks, nbh, nbw)


def _init_tables(dev: torch.device) -> None:
    """Copy the intra tables into the kernel's constant memory, once a
    device."""
    if dev.index in _INIT_DEVICES:
        return
    fn = kbuild.function("stripe_prescreen", "tpuhevc_stripe_prescreen_init",
                         [kbuild.P] * 3)
    with torch.cuda.device(dev):
        kbuild.check(fn(*(a.ctypes.data_as(ctypes.c_void_p)
                          for a in intra_tables())), "stripe_prescreen init")
    _INIT_DEVICES.add(dev.index)


def stripe_prescreen_rows(rows: torch.Tensor, halo, hl: int,
                          bit_depth: int = 8):
    """Kernel `stripe_prescreen` over k stripes of hl rows on one device
    (see `stripe_prescreen_rows_plain`). CPU tensors take the plain
    version; CUDA tensors the kernel (one launch)."""
    if rows.device.type == "cpu":
        return stripe_prescreen_rows_plain(rows, halo, hl, bit_depth)
    if rows.device.type != "cuda":
        raise ValueError(f"stripe_prescreen: unsupported device "
                         f"{rows.device}")
    dev = rows.device
    check_tensor(rows, "rows", torch.int32, 2, dev)
    h, w = rows.shape
    if halo is not None:
        check_tensor(halo, "halo", torch.int32, 2, dev)
    if (hl < 8 or hl % 8 or h % hl or w % 8 or not 8 <= bit_depth <= 12
            or (halo is not None and tuple(halo.shape) != (1, w))):
        raise ValueError(f"stripe_prescreen: rows {tuple(rows.shape)} in "
                         f"stripes of {hl}, halo "
                         f"{None if halo is None else tuple(halo.shape)}, "
                         f"bit depth {bit_depth}")
    if rows.data_ptr() % 16:
        raise ValueError("stripe_prescreen: rows must be 16-byte aligned")
    mode = torch.empty((h // 8, w // 8), dtype=torch.int32, device=dev)
    cost = torch.empty_like(mode)
    if mode.numel() == 0:
        return mode, cost
    _init_tables(dev)
    fn = kbuild.function("stripe_prescreen", "tpuhevc_stripe_prescreen_rows",
                         [kbuild.P] * 4 + [kbuild.I] * 4 + [kbuild.P])
    err = fn(rows.data_ptr(), None if halo is None else halo.data_ptr(),
             mode.data_ptr(), cost.data_ptr(), h // hl, hl, w, bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "stripe_prescreen")
    LAUNCHES["stripe_prescreen"] += 1
    return mode, cost


def stripe_prescreen(plane: torch.Tensor, halo, bit_depth: int = 8):
    """One stripe (hl, W) with its halo row (1, W), or None (mid-grey):
    `stripe_prescreen_rows` with k = 1."""
    return stripe_prescreen_rows(plane, halo, plane.shape[0], bit_depth)
