"""DCT-IF motion-compensated prediction of whole blocks (kernel K3).

Twin of the `mc_blk` stage of `tpuhevc/codec/inter_batch.py:166` (8-bit;
same semantics as `tpuhevc.ops.interp.mc`): per PU, the window at the
integer part of the MV (`>>` floors on signed MVs), clamped at the plane
edge, filtered horizontally then vertically with the 8-tap luma
(quarter-pel) or 4-tap chroma (eighth-pel) taps, `>> 6`, then
`clip((x + 32) >> 6)`.

`mc_blk_plain` is the PyTorch version; `mc_blk` launches the CUDA kernel
(`kernels/csrc/mc_blk.cu`) for CUDA tensors.
"""

from __future__ import annotations

import torch

from tpuhevc.ops.interp import CHROMA_TAPS, LUMA_TAPS

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

_TAPS: dict = {}


def taps(is_luma: bool, device, dtype=torch.int64) -> torch.Tensor:
    key = (is_luma, str(device), dtype)
    t = _TAPS.get(key)
    if t is None:
        t = torch.as_tensor(LUMA_TAPS if is_luma else CHROMA_TAPS,
                            dtype=dtype, device=device)
        _TAPS[key] = t
    return t


def mc_blk_plain(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 mvq: torch.Tensor, size: int, is_luma: bool) -> torch.Tensor:
    """plane (H, W), positions (N,), MVs (N, 2) int32 -> (N, S, S) int32.
    Luma MVs in quarter pels, chroma MVs in eighth pels of the chroma grid."""
    tab = taps(is_luma, plane.device)
    ntaps = tab.shape[1]
    off, fmask, fshift = (3, 3, 2) if is_luma else (1, 7, 3)
    hh, ww = plane.shape
    ix = xs + (mvq[:, 0] >> fshift)
    iy = ys + (mvq[:, 1] >> fshift)
    fx = (mvq[:, 0] & fmask).long()
    fy = (mvq[:, 1] & fmask).long()
    win = size + ntaps - 1
    ar = torch.arange(win, device=plane.device)
    yc = (iy[:, None] - off + ar[None]).clamp(0, hh - 1).long()
    xc = (ix[:, None] - off + ar[None]).clamp(0, ww - 1).long()
    wnd = plane.reshape(-1)[yc[:, :, None] * ww + xc[:, None, :]].long()
    th = tab[fx]  # (N, ntaps)
    tv = tab[fy]
    acc_h = (wnd.unfold(2, ntaps, 1) * th[:, None, None, :]).sum(-1)
    acc = (acc_h.unfold(1, ntaps, 1) * tv[:, None, None, :]).sum(-1) >> 6
    return ((acc + 32) >> 6).clamp(0, 255).int()


def mc_blk(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           mvq: torch.Tensor, size: int, is_luma: bool) -> torch.Tensor:
    """K3. CPU tensors take the plain version; CUDA tensors the kernel."""
    if plane.device.type == "cpu":
        return mc_blk_plain(plane, xs, ys, mvq, size, is_luma)
    if plane.device.type != "cuda":
        raise ValueError(f"mc_blk: unsupported device {plane.device}")
    dev = plane.device
    check_tensor(plane, "plane", torch.int32, 2, dev)
    check_tensor(xs, "xs", torch.int32, 1, dev)
    check_tensor(ys, "ys", torch.int32, 1, dev)
    check_tensor(mvq, "mvq", torch.int32, 2, dev)
    n = xs.shape[0]
    if ys.shape[0] != n or tuple(mvq.shape) != (n, 2):
        raise ValueError("mc_blk: xs, ys, mvq disagree on N")
    if size not in (4, 8, 16, 32):
        raise ValueError(f"mc_blk: unsupported size {size}")
    out = torch.empty((n, size, size), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    tab = taps(is_luma, dev, torch.int32)
    fn = kbuild.function("mc_blk", "tpuhevc_mc_blk",
                         [kbuild.P] * 6 + [kbuild.I] * 5 + [kbuild.P])
    err = fn(plane.data_ptr(), xs.data_ptr(), ys.data_ptr(), mvq.data_ptr(),
             tab.data_ptr(), out.data_ptr(), n, plane.shape[0],
             plane.shape[1], size, int(is_luma),
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "mc_blk")
    LAUNCHES["mc_blk"] += 1
    return out
