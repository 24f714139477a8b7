"""The grid step's motion compensation (kernels `grid_planes` and
`grid_satd`).

`grid_planes`, twin of `luma_planes_all` / `chroma_planes_all` without
weighted prediction (`tpuhevc/codec/inter_grid.py:862-910`): every
fractional phase of a stack of reference planes, edge-padded by `pad`,
through the separable DCT-IF filter (luma 8 taps, 4x4 phases; chroma 4
taps, 8x8 phases): h = sum_i taps[fx, i] ref[y, x + i + 1] (no shift at
8 bits), v = sum_j taps[fy, j] h[y + j + 1, x], then
clip(((v >> 6) + 32) >> 6, 0, 255) as int16, over the (hm, wm) window of
the padded plane. Out: (n, P, P, hm, wm) int16, P phases per axis.

`grid_satd`, twin of the gather of `pred_luma` / `pred_chroma` (:912-930,
`batch_satd` :1597) with the Hadamard of `satd8_plane` (:951): for C
candidate fields given per cell (mv in 1/P pel and the reference index,
one entry per `cell` x `cell` block of the prediction), the prediction
read from the phase planes at (ref, phase, integer position + look); with
`oy` the 8x8 Hadamard SATD (sum |H r H^T| + 2) >> 2 of r = oy - pred per
8x8 block and the residual sum per 8x8 block (both int32). The DC-aware
float costs that combine them are torch glue in `codec/inter_grid.py`.

`*_plain` are the PyTorch versions; the wrappers launch the CUDA kernels
(`kernels/csrc/grid_pred.cu`) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from .cost import wht
from .grid_me import tile_sum
from .interp import CHROMA_TAPS, LUMA_TAPS

HAD8 = [[1, 1, 1, 1, 1, 1, 1, 1],
        [1, -1, 1, -1, 1, -1, 1, -1],
        [1, 1, -1, -1, 1, 1, -1, -1],
        [1, -1, -1, 1, 1, -1, -1, 1],
        [1, 1, 1, 1, -1, -1, -1, -1],
        [1, -1, 1, -1, -1, 1, -1, 1],
        [1, 1, -1, -1, -1, -1, 1, 1],
        [1, -1, -1, 1, -1, 1, 1, -1]]


def satd8(res: torch.Tensor) -> torch.Tensor:
    """(..., h, w) int32 residual -> (..., h/8, w/8) int32 8x8 Hadamard
    SATD, (sum |H r H^T| + 2) >> 2 (exact in int32)."""
    *lead, h, w = res.shape
    x = res.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    t = wht(wht(x).transpose(-1, -2))
    return ((t.abs().sum(dim=(-1, -2)) + 2) >> 2).int()


def grid_planes_plain(stack: torch.Tensor, is_luma: bool, pad: int,
                      hm: int, wm: int) -> torch.Tensor:
    """stack (n, h, w) int32 -> (n, P, P, hm, wm) int16 phase planes."""
    n, h, w = stack.shape
    dev = stack.device
    taps = torch.as_tensor(LUMA_TAPS if is_luma else CHROMA_TAPS,
                           dtype=torch.int32, device=dev)
    P, nt = taps.shape
    ys = (torch.arange(h + 2 * pad, device=dev) - pad).clamp(0, h - 1)
    xs = (torch.arange(w + 2 * pad, device=dev) - pad).clamp(0, w - 1)
    rp = stack[:, ys][:, :, xs]
    # int32 sums: |h| < 2^15, |v| < 2^22
    hst = torch.zeros((n, P, rp.shape[1], wm), dtype=torch.int32,
                      device=dev)
    for i in range(nt):
        hst += taps[:, i].view(1, P, 1, 1) * rp[:, None, :, i + 1 : i + 1 + wm]
    pl = torch.zeros((n, P, P, hm, wm), dtype=torch.int32, device=dev)
    for j in range(nt):
        pl += (taps[:, j].view(1, P, 1, 1, 1)
               * hst[:, None, :, j + 1 : j + 1 + hm, :])
    return (((pl >> 6) + 32) >> 6).clamp(0, 255).to(torch.int16)


_READY: set = set()


def init_consts(dev: torch.device, lib: str = "grid_pred") -> None:
    """Copy the taps and the Hadamard matrix to `lib`'s constant memory on
    `dev` (once per device)."""
    if (lib, dev.index) in _READY:
        return
    had = np.ascontiguousarray(HAD8, dtype=np.int32)
    if lib == "grid_pred":
        lt = np.ascontiguousarray(LUMA_TAPS, dtype=np.int32)
        ct = np.ascontiguousarray(CHROMA_TAPS, dtype=np.int32)
        fn = kbuild.function(lib, "tpuhevc_grid_pred_init", [kbuild.P] * 3)
        kbuild.check(fn(lt.ctypes.data, ct.ctypes.data, had.ctypes.data),
                     "grid_pred init")
    else:
        fn = kbuild.function(lib, "tpuhevc_grid_intra_init", [kbuild.P])
        kbuild.check(fn(had.ctypes.data), "grid_intra init")
    _READY.add((lib, dev.index))


def grid_planes(stack: torch.Tensor, is_luma: bool, pad: int, hm: int,
                wm: int) -> torch.Tensor:
    """Kernel `grid_planes`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if stack.device.type == "cpu":
        return grid_planes_plain(stack, is_luma, pad, hm, wm)
    if stack.device.type != "cuda":
        raise ValueError(f"grid_planes: unsupported device {stack.device}")
    dev = stack.device
    check_tensor(stack, "stack", torch.int32, 3, dev)
    n, h, w = stack.shape
    P, nt = (4, 8) if is_luma else (8, 4)
    if hm + nt > h + 2 * pad or wm + nt > w + 2 * pad:
        raise ValueError(f"grid_planes: window {hm}x{wm} exceeds the padded "
                         f"plane {h}x{w} + {pad}")
    init_consts(dev)
    out = torch.empty((n, P, P, hm, wm), dtype=torch.int16, device=dev)
    fn = kbuild.function("grid_pred", "tpuhevc_grid_planes",
                         [kbuild.P] * 2 + [kbuild.I] * 7 + [kbuild.P])
    err = fn(stack.data_ptr(), out.data_ptr(), n, h, w, int(is_luma), pad,
             hm, wm, torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_planes")
    LAUNCHES["grid_planes"] += 1
    return out


def grid_satd_plain(planes: torch.Tensor, mv: torch.Tensor, ref: torch.Tensor,
                    cell: int, look: int, oy: torch.Tensor | None = None,
                    want_pred: bool = True):
    """planes (R, P, P, hm, wm) int16; mv (C, hc, wc, 2), ref (C, hc, wc)
    int32 per cell -> (pred (C, hc*cell, wc*cell) int32 or None, satd,
    rsum (C, h/8, w/8) int32 or None without oy)."""
    R, P, _, hm, wm = planes.shape
    C, hc, wc = ref.shape
    dev = planes.device
    fb = P.bit_length() - 1
    mvp = mv.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    rp = ref.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    h, w = hc * cell, wc * cell
    yg = torch.arange(h, device=dev)[None, :, None]
    xg = torch.arange(w, device=dev)[None, None, :]
    fx, fy = mvp[..., 0] & (P - 1), mvp[..., 1] & (P - 1)
    ix = (mvp[..., 0] >> fb) + xg + look
    iy = (mvp[..., 1] >> fb) + yg + look
    idx = (((rp * P * P + fy * P + fx) * hm) + iy) * wm + ix
    pred = planes.reshape(-1)[idx].int()
    if oy is None:
        return pred, None, None
    r = oy[:h, :w][None] - pred
    return (pred if want_pred else None), satd8(r), tile_sum(r, 8).int()


def grid_satd(planes: torch.Tensor, mv: torch.Tensor, ref: torch.Tensor,
              cell: int, look: int, oy: torch.Tensor | None = None,
              want_pred: bool = True):
    """Kernel `grid_satd`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if planes.device.type == "cpu":
        return grid_satd_plain(planes, mv, ref, cell, look, oy, want_pred)
    if planes.device.type != "cuda":
        raise ValueError(f"grid_satd: unsupported device {planes.device}")
    dev = planes.device
    check_tensor(planes, "planes", torch.int16, 5, dev)
    check_tensor(mv, "mv", torch.int32, 4, dev)
    check_tensor(ref, "ref", torch.int32, 3, dev)
    R, P, _, hm, wm = planes.shape
    C, hc, wc = ref.shape
    h, w = hc * cell, wc * cell
    satd = oy is not None
    if satd:
        check_tensor(oy, "oy", torch.int32, 2, dev)
        if h % 8 or w % 8 or oy.shape[0] < h or oy.shape[1] < w:
            raise ValueError(f"grid_satd: oy {tuple(oy.shape)}, field "
                             f"{h}x{w}")
    if tuple(mv.shape) != (C, hc, wc, 2) or P not in (4, 8):
        raise ValueError(f"grid_satd: mv {tuple(mv.shape)}, ref "
                         f"{tuple(ref.shape)}, planes {tuple(planes.shape)}")
    init_consts(dev)
    wp = want_pred or not satd
    pred = (torch.empty((C, h, w), dtype=torch.int32, device=dev)
            if wp else None)
    m8 = s8 = None
    if satd:
        m8 = torch.empty((C, h // 8, w // 8), dtype=torch.int32, device=dev)
        s8 = torch.empty_like(m8)
    fn = kbuild.function("grid_pred", "tpuhevc_grid_satd",
                         [kbuild.P] * 7 + [kbuild.I] * 10 + [kbuild.P])
    err = fn(planes.data_ptr(), mv.data_ptr(), ref.data_ptr(),
             oy.data_ptr() if satd else None,
             pred.data_ptr() if wp else None,
             m8.data_ptr() if satd else None,
             s8.data_ptr() if satd else None,
             R, P, hm, wm, C, hc, wc, cell, look,
             oy.shape[1] if satd else 0,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_satd")
    LAUNCHES["grid_satd"] += 1
    return pred, m8, s8
