"""The open-loop intra prescreen of one row stripe (kernel
`stripe_prescreen`).

Twin of `local` in `tile_prescreen` (`tpuhevc/parallel/mesh.py:56-96`):
for every 8x8 block of a stripe (hl, W), from `padded` = [halo row;
stripe], its 17 top samples `padded[by][clip(bx - 1 + i, 0, W - 1)]`, its
17 left samples `padded[min(by + i, hl)][clip(bx - 1, 0, W - 1)]` (all
mid-grey at bx == 0), the 35 predictions at 8x8 luma
(`ops/intra.py:predict_all_modes_plain`), the SATD of each,
`(sum |H d H^T| + 2) >> 2` (`ops/cost.py:satd35_plain`), and the first
mode of least cost with that cost. The halo of the picture's first stripe
is mid-grey; a later stripe's is the last row of the stripe above
(`parallel/mesh.py` copies it over). An advisory analysis: the last block
row of a stripe reads its below-left samples clamped to the stripe.

`stripe_prescreen_plain` is the PyTorch version; `stripe_prescreen`
launches `kernels/csrc/stripe_prescreen.cu` (one launch a stripe) for CUDA
tensors.
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
    sat = satd35_plain(blocks, preds)
    best = torch.argmin(sat, dim=1)
    cost = sat.gather(1, best[:, None])[:, 0]
    return best.int().reshape(nbh, nbw), cost.int().reshape(nbh, nbw)


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


def stripe_prescreen(plane: torch.Tensor, halo: torch.Tensor,
                     bit_depth: int = 8):
    """Kernel `stripe_prescreen`. CPU tensors take the plain version; CUDA
    tensors the kernel (one launch)."""
    if plane.device.type == "cpu":
        return stripe_prescreen_plain(plane, halo, bit_depth)
    if plane.device.type != "cuda":
        raise ValueError(f"stripe_prescreen: unsupported device "
                         f"{plane.device}")
    dev = plane.device
    check_tensor(plane, "plane", torch.int32, 2, dev)
    check_tensor(halo, "halo", torch.int32, 2, dev)
    hl, w = plane.shape
    if hl % 8 or w % 8 or tuple(halo.shape) != (1, w) or \
            not 8 <= bit_depth <= 12:
        raise ValueError(f"stripe_prescreen: plane {tuple(plane.shape)}, "
                         f"halo {tuple(halo.shape)}, bit depth {bit_depth}")
    mode = torch.empty((hl // 8, w // 8), dtype=torch.int32, device=dev)
    cost = torch.empty_like(mode)
    if mode.numel() == 0:
        return mode, cost
    _init_tables(dev)
    fn = kbuild.function("stripe_prescreen", "tpuhevc_stripe_prescreen",
                         [kbuild.P] * 4 + [kbuild.I] * 3 + [kbuild.P])
    err = fn(plane.data_ptr(), halo.data_ptr(), mode.data_ptr(),
             cost.data_ptr(), hl, w, bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "stripe_prescreen")
    LAUNCHES["stripe_prescreen"] += 1
    return mode, cost
