"""Dense full-pel motion search with the NN-FME SAD surface (kernel K1).

Twin of the `sad_search` stage of `tpuhevc/codec/inter_batch.py:139`:
for each PU, the SAD of every (2sr+1)^2 full-pel offset over its clipped
search window, rows subsampled 2:1 and the sum shifted <<1 for PUs taller
than 8 (the reference's FEN setting), plus the rate term
(mv_bits * lam_me) >> 8; the argmin over the inner (2sr-1)^2 square (first
index wins, row-major), and the 3x3 raw-SAD surface around it.

`sad_search_plain` is the PyTorch version; `sad_search` launches the CUDA
kernel (`kernels/csrc/sad_search.cu`) for CUDA tensors.
"""

from __future__ import annotations

import torch

from tpuhevc.ops.me import mv_bits_table

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild


def bits_table(sr: int, device) -> torch.Tensor:
    """(2sr+1, 2sr+1) int32 MV bit cost (`tpuhevc.ops.me.mv_bits_table`)."""
    return torch.as_tensor(mv_bits_table(sr), dtype=torch.int32, device=device)


def sad_search_plain(wnd: torch.Tensor, cur: torch.Tensor, bits: torch.Tensor,
                     lam_me: int, sr: int):
    """wnd (N, S+2sr, S+2sr), cur (N, S, S) int32 -> (mv (N,2), sad9 (N,9))."""
    n, size = cur.shape[0], cur.shape[1]
    m = 2 * sr + 1
    sub = 1 if size > 8 else 0
    c = cur[:, :: 1 << sub, :].long()
    rows_sad = []
    for dy in range(m):
        rows = wnd[:, dy : dy + size : 1 << sub, :].long()  # (N, r, win)
        sl = rows.unfold(2, size, 1)  # (N, r, m, size)
        rows_sad.append((sl - c[:, :, None, :]).abs().sum(dim=(1, 3)))
    sad = (torch.stack(rows_sad, dim=1) << sub).int()  # (N, m, m)
    cost = sad + ((bits[None] * lam_me) >> 8)
    inner = cost[:, 1 : m - 1, 1 : m - 1].reshape(n, -1)
    bi = torch.argmin(inner, dim=1)
    by = bi // (m - 2) + 1
    bx = bi % (m - 2) + 1
    mv = torch.stack([bx - sr, by - sr], dim=-1).int()
    idx = torch.arange(n, device=cur.device)
    sad9 = torch.stack([sad[idx, by + dy, bx + dx]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=-1)
    return mv, sad9


def sad_search(wnd: torch.Tensor, cur: torch.Tensor, bits: torch.Tensor,
               lam_me: int, sr: int):
    """K1. CPU tensors take the plain version; CUDA tensors the kernel."""
    if cur.device.type == "cpu":
        return sad_search_plain(wnd, cur, bits, lam_me, sr)
    if cur.device.type != "cuda":
        raise ValueError(f"sad_search: unsupported device {cur.device}")
    dev = cur.device
    check_tensor(cur, "cur", torch.int32, 3, dev)
    n, size = cur.shape[0], cur.shape[1]
    m = 2 * sr + 1
    win = size + 2 * sr
    check_tensor(wnd, "wnd", torch.int32, 3, dev)
    check_tensor(bits, "bits", torch.int32, 2, dev)
    if cur.shape[2] != size or tuple(wnd.shape) != (n, win, win):
        raise ValueError(f"sad_search: cur {tuple(cur.shape)} / wnd "
                         f"{tuple(wnd.shape)} do not match sr={sr}")
    if tuple(bits.shape) != (m, m) or not 1 <= sr <= 16 or size > 32:
        raise ValueError(f"sad_search: unsupported sr={sr} size={size}")
    mv = torch.empty((n, 2), dtype=torch.int32, device=dev)
    sad9 = torch.empty((n, 9), dtype=torch.int32, device=dev)
    if n == 0:
        return mv, sad9
    fn = kbuild.function("sad_search", "tpuhevc_sad_search",
                         [kbuild.P] * 5 + [kbuild.I] * 4 + [kbuild.P])
    err = fn(wnd.data_ptr(), cur.data_ptr(), bits.data_ptr(), mv.data_ptr(),
             sad9.data_ptr(), n, size, sr, int(lam_me),
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "sad_search")
    LAUNCHES["sad_search"] += 1
    return mv, sad9
