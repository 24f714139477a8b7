"""The grid step's picture statistics without a recon fetch (kernel
`grid_stats`).

Twin of the `fetch_recon` off branch of the packing tail
(`tpuhevc/codec/inter_grid.py:3170-3185`, `_xor_mask` :86-91): with the
checksum hash and no recon fetch, a P picture's row carries, instead of
its recon planes, per plane (Y, U, V) of the composed, filtered recon

- the int32 picture checksum sum((rec & 0xFF) ^ mask(x, y)) of the
  decoded-picture-hash SEI (D.3.19), mask(x, y) = (x & 0xFF) ^ (y & 0xFF)
  ^ (x >> 8) ^ (y >> 8) in the plane's own coordinates;
- the float32 SSE sum((orig - rec)^2), which only PSNR reads.

The SSE is the exact integer sum rounded once to float32. The reference
adds float32 squares in XLA's order; the two agree wherever the total is
below 2^24 (ROADMAP queue 3 logs this divergence).

The kernel computes the exact int64 sums of the rows it is given, from
picture row `y0` (`grid_stats_partial`); `stats_finish` wraps the
checksum to int32 and rounds the SSE once. Row stripes add their sums
before that one finish, which keeps the picture's values bit for bit.

`*_plain` are the PyTorch versions; the wrapper launches the CUDA kernel
(`kernels/csrc/grid_stats.cu`) for CUDA tensors: one launch of many
blocks, which meet through a scratch of accumulators and a ticket, kept
per (device, stream) and left at zero by every launch.
"""

from __future__ import annotations

import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild


def xor_mask(h: int, w: int, dev, y0: int = 0) -> torch.Tensor:
    """(h, w) int64 per-sample mask of the checksum hash (D.3.19) of the
    rows from y0."""
    x = torch.arange(w, device=dev)[None]
    y = torch.arange(y0, y0 + h, device=dev)[:, None]
    return (x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)


def grid_stats_partial_plain(oy: torch.Tensor, ouv: torch.Tensor,
                             rec_y: torch.Tensor, rec_uv: torch.Tensor,
                             y0: int = 0):
    """oy, rec_y (h, W) int32; ouv, rec_uv (h/2, W) int32 packed [U | V],
    the rows from picture row y0 (even) -> (cks (3,), sse (3,)) int64
    exact sums, in the order Y, U, V."""
    wc = rec_uv.shape[1] // 2
    planes = ((oy, rec_y, y0), (ouv[:, :wc], rec_uv[:, :wc], y0 // 2),
              (ouv[:, wc:], rec_uv[:, wc:], y0 // 2))
    cks, sse = [], []
    for o, r, py0 in planes:
        m = xor_mask(*r.shape, r.device, py0)
        cks.append(((r.long() & 0xFF) ^ m).sum())
        sse.append(((o.long() - r.long()) ** 2).sum())
    return torch.stack(cks), torch.stack(sse)


def stats_finish(cks: torch.Tensor, sse: torch.Tensor):
    """Exact int64 sums -> (cks (3,) int32, sse (3,) float32): the checksum
    wraps as an int32 sum; the exact SSE is rounded once."""
    cks = (cks + (1 << 31)) % (1 << 32) - (1 << 31)
    return cks.int(), sse.double().float()


def grid_stats_plain(oy: torch.Tensor, ouv: torch.Tensor, rec_y: torch.Tensor,
                     rec_uv: torch.Tensor):
    """oy, rec_y (H, W) int32; ouv, rec_uv (H/2, W) int32 packed [U | V]
    -> (cks (3,) int32, sse (3,) float32), in the order Y, U, V."""
    return stats_finish(*grid_stats_partial_plain(oy, ouv, rec_y, rec_uv))


# per (device, stream): the kernel's accumulators and ticket (7 int64,
# left at zero by every launch); a launch on another stream of the device
# has its own, so that two launches in flight at once never share them
_SCRATCH: dict = {}
_ARGS = [kbuild.P] * 4 + [kbuild.I] * 3 + [kbuild.P] * 3 + [kbuild.I,
                                                            kbuild.P]


def grid_stats_partial(oy: torch.Tensor, ouv: torch.Tensor,
                       rec_y: torch.Tensor, rec_uv: torch.Tensor,
                       y0: int = 0):
    """Kernel `grid_stats`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if rec_y.device.type == "cpu":
        return grid_stats_partial_plain(oy, ouv, rec_y, rec_uv, y0)
    if rec_y.device.type != "cuda":
        raise ValueError(f"grid_stats: unsupported device {rec_y.device}")
    dev = rec_y.device
    for t, name in ((oy, "oy"), (ouv, "ouv"), (rec_y, "rec_y"),
                    (rec_uv, "rec_uv")):
        check_tensor(t, name, torch.int32, 2, dev)
    h, w = rec_y.shape
    if (tuple(oy.shape) != (h, w) or tuple(ouv.shape) != (h // 2, w)
            or tuple(rec_uv.shape) != (h // 2, w) or h % 2 or w % 2
            or y0 % 2 or y0 < 0):
        raise ValueError(f"grid_stats: oy {tuple(oy.shape)}, ouv "
                         f"{tuple(ouv.shape)}, rec_y {(h, w)}, rec_uv "
                         f"{tuple(rec_uv.shape)}, y0 {y0}")
    sums = torch.empty(6, dtype=torch.int64, device=dev)
    cks, sse = sums[:3], sums[3:]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    acc = _SCRATCH.get((dev.index, stream))
    if acc is None:
        acc = _SCRATCH[dev.index, stream] = torch.zeros(
            7, dtype=torch.int64, device=dev)
    ptrs = (oy.data_ptr(), ouv.data_ptr(), rec_y.data_ptr(),
            rec_uv.data_ptr())
    vec = int(w % 8 == 0 and all(p % 16 == 0 for p in ptrs))
    fn = kbuild.function("grid_stats", "tpuhevc_grid_stats", _ARGS)
    err = fn(*ptrs, h, w, y0, cks.data_ptr(), sse.data_ptr(),
             acc.data_ptr(), vec, stream)
    kbuild.check(err, "grid_stats")
    LAUNCHES["grid_stats"] += 1
    return cks, sse


def grid_stats(oy: torch.Tensor, ouv: torch.Tensor, rec_y: torch.Tensor,
               rec_uv: torch.Tensor):
    """The picture's (cks (3,) int32, sse (3,) float32): kernel
    `grid_stats` (`grid_stats_partial`), then `stats_finish`."""
    return stats_finish(*grid_stats_partial(oy, ouv, rec_y, rec_uv))
