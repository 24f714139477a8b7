"""The grid step's intra-16 candidate in P pictures (kernel
`grid_intra16`).

Twin of `cell_refs`, `_smooth121`, `intra_preds`, `satd_cells` and the
decision of `intra16_class` (`tpuhevc/codec/inter_grid.py:2038-2203`):
per 16x16 cell of the picture,

- the 33 + 33 reference samples of the luma plane `ref_y` (the original
  for the open-loop decision, the composed recon for the exact
  prediction), read at clamped coordinates, with the z-scan availability
  of the left, top-left, top, top-right and bottom-left segments
  (`avtr` / `avbl` per cell, the picture's edges) and the substitution of
  §8.4.4.2.2 (forward fill from the first available sample, 128 when none
  is);
- the [1 2 1] smoothing where `filter_flag` asks for it, and the seven
  modes IMODES = (planar, DC, H, V, 2, 18, 34) with the DC, V and H edge
  filters;
- with `cur` given, the 8x8 Hadamard SATD of cur - pred per mode (four
  8x8 blocks per cell) and the first-index argmin; else the modes given;
- the chosen mode's luma prediction, and its DM chroma prediction (8x8,
  no smoothing or edge filters) on both halves of the packed [U | V]
  plane `ref_uv`, whose references are taken in each half with the same
  availability.

Out: (mode index (n16,) int32 into IMODES, pred_y (16 nh, 16 nw) int32,
pred_uv (8 nh, 16 nw) int32 packed [U | V]). With the row origin `y0`
the reference planes hold y0 rows above the cells' row 0 (a row stripe
with the last row of the stripe above it): the cells' top samples are
read there and are available, as in the whole picture. `grid_intra16_plain` is the
PyTorch version; `grid_intra16` launches `kernels/csrc/grid_intra.cu` for
CUDA tensors.
"""

from __future__ import annotations

import torch

from ..device import contiguous_on as _on
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from .grid_pred import satd8
from .intra import filter_flag, unblocks

IMODES = (0, 1, 10, 26, 2, 18, 34)  # planar, DC, H, V, diagonals
_INTRA_ARGS = [kbuild.P] * 9 + [kbuild.I] * 5 + [kbuild.P]


def cell_refs(plane: torch.Tensor, S: int, ox: int, nh: int, nw: int,
              avtr: torch.Tensor, avbl: torch.Tensor, y0: int = 0):
    """(nh*nw, 2S+1) top / left reference arrays (corner at 0) of the S x S
    cells of `plane` whose grid starts at column ox and row y0
    (`cell_refs`)."""
    dev = plane.device
    hp, wp = plane.shape
    n4 = 4 * S + 1
    bx = (torch.arange(nw, device=dev).repeat(nh) * S + ox)[:, None]
    by = (torch.arange(nh, device=dev).repeat_interleave(nw) * S + y0)[:, None]
    kk = torch.arange(n4, device=dev)
    is_left = kk < 2 * S
    ky = torch.where(is_left, (2 * S - 1) - kk, torch.full_like(kk, -1))
    kx = torch.where(is_left, torch.full_like(kk, -1),
                     torch.where(kk == 2 * S, torch.full_like(kk, -1),
                                 kk - (2 * S + 1)))
    xmax = (ox + nw * S) if ox else wp
    yy = (by + ky[None]).clamp(0, hp - 1)
    xx = (bx + kx[None]).clamp(0, xmax - 1)
    v = plane.reshape(-1)[yy * wp + xx]
    left_ok = (bx[:, 0] - ox) > 0
    top_ok = by[:, 0] > 0
    inb_y = (by + ky[None]) < hp
    inb_x = (bx + kx[None]) < xmax
    av = (((kk < S)[None] & (avbl & left_ok)[:, None] & inb_y)
          | (((kk >= S) & (kk < 2 * S))[None] & left_ok[:, None])
          | ((kk == 2 * S)[None] & (left_ok & top_ok)[:, None])
          | (((kk > 2 * S) & (kk <= 3 * S))[None] & top_ok[:, None])
          | ((kk > 3 * S)[None] & (avtr & top_ok)[:, None] & inb_x))
    ffi = torch.where(av, kk[None], torch.full_like(v, -1).long())
    ffi = torch.cummax(ffi, dim=1).values
    first = torch.argmax(av.int(), dim=1)
    vf = v.gather(1, ffi.clamp(min=0))
    v0 = v.gather(1, first[:, None])
    filled = torch.where(ffi >= 0, vf, v0)
    filled = torch.where(av.any(dim=1)[:, None], filled,
                         torch.full_like(filled, 128))
    corner = filled[:, 2 * S : 2 * S + 1]
    t = torch.cat([corner, filled[:, 2 * S + 1 :]], dim=1)
    lft = torch.cat([corner, filled[:, : 2 * S].flip(1)], dim=1)
    return t.int(), lft.int()


def _smooth121(t, lft, S):
    s2 = 2 * S
    c = (lft[:, 1] + 2 * t[:, 0] + t[:, 1] + 2) >> 2
    tm = (t[:, : s2 - 1] + 2 * t[:, 1:s2] + t[:, 2:] + 2) >> 2
    lm = (lft[:, : s2 - 1] + 2 * lft[:, 1:s2] + lft[:, 2:] + 2) >> 2
    ft = torch.cat([c[:, None], tm, t[:, s2:]], dim=1)
    fl = torch.cat([c[:, None], lm, lft[:, s2:]], dim=1)
    return ft, fl


def intra_preds(t, lft, S, is_luma):
    """(n, 7, S, S) int32 predictions of IMODES (`intra_preds`)."""
    n = t.shape[0]
    dev = t.device
    log2 = S.bit_length() - 1
    ft, fl = _smooth121(t, lft, S) if is_luma and log2 in (3, 4) else (t, lft)
    xs = torch.arange(S, device=dev)
    preds = []
    for m in IMODES:
        tt, ll = (ft, fl) if (is_luma and filter_flag(m, log2)) else (t, lft)
        if m == 0:
            p = ((S - 1 - xs[None, None, :]) * ll[:, 1 : S + 1, None]
                 + (xs[None, None, :] + 1) * tt[:, S + 1, None, None]
                 + (S - 1 - xs[None, :, None]) * tt[:, None, 1 : S + 1]
                 + (xs[None, :, None] + 1) * ll[:, S + 1, None, None]
                 + S) >> (log2 + 1)
        elif m == 1:
            dc = ((tt[:, 1 : S + 1].sum(1) + ll[:, 1 : S + 1].sum(1) + S)
                  >> (log2 + 1))
            p = dc[:, None, None].expand(n, S, S).clone()
            if is_luma:
                p[:, 0, 1:] = (tt[:, 2 : S + 1] + 3 * dc[:, None] + 2) >> 2
                p[:, 1:, 0] = (ll[:, 2 : S + 1] + 3 * dc[:, None] + 2) >> 2
                p[:, 0, 0] = (ll[:, 1] + 2 * dc + tt[:, 1] + 2) >> 2
        elif m == 26:
            p = tt[:, None, 1 : S + 1].expand(n, S, S).clone()
            if is_luma:
                p[:, :, 0] = (tt[:, 1, None] + ((ll[:, 1 : S + 1]
                                                 - ll[:, 0, None]) >> 1)
                              ).clamp(0, 255)
        elif m == 10:
            p = ll[:, 1 : S + 1, None].expand(n, S, S).clone()
            if is_luma:
                p[:, 0, :] = (ll[:, 1, None] + ((tt[:, 1 : S + 1]
                                                 - tt[:, 0, None]) >> 1)
                              ).clamp(0, 255)
        elif m == 2:
            p = ll[:, 2:][:, xs[:, None] + xs[None, :]]
        elif m == 34:
            p = tt[:, 2:][:, xs[:, None] + xs[None, :]].transpose(1, 2)
        else:  # 18
            comb = torch.cat([ll[:, 1:].flip(1), tt], dim=1)
            p = comb[:, 2 * S + xs[None, :] - xs[:, None]]
        preds.append(p.int())
    return torch.stack(preds, dim=1)


def grid_intra16_plain(ref_y: torch.Tensor, ref_uv: torch.Tensor,
                       avtr: torch.Tensor, avbl: torch.Tensor, nh: int,
                       nw: int, cur: torch.Tensor | None = None,
                       modes: torch.Tensor | None = None, y0: int = 0,
                       out=None):
    """ref_y (H, W), ref_uv ((H - y0)/2 + y0, W) packed int32, y0 rows
    above the cells; avtr / avbl (nh*nw,) bool; cur (16 nh, W) int32 to
    decide, or modes (nh*nw,) int32 given. out is the kernel's and
    unused."""
    H, W = ref_y.shape
    n = nh * nw
    t, lft = cell_refs(ref_y, 16, 0, nh, nw, avtr, avbl, y0)
    preds = intra_preds(t, lft, 16, True)
    if modes is None:
        c = (cur[: nh * 16, : nw * 16].reshape(nh, 16, nw, 16)
             .permute(0, 2, 1, 3).reshape(n, 16, 16))
        sat = satd8(c[:, None] - preds).sum(dim=(-1, -2))  # (n, 7)
        modes = torch.argmin(sat, dim=1).int()
    sel = modes.long()[:, None, None, None].expand(n, 1, 16, 16)
    pred_y = unblocks(preds.gather(1, sel)[:, 0], nh, nw)
    sel8 = modes.long()[:, None, None, None].expand(n, 1, 8, 8)
    halves = []
    for ox in (0, W // 2):
        tc, lc = cell_refs(ref_uv, 8, ox, nh, nw, avtr, avbl, y0)
        pc = intra_preds(tc, lc, 8, False).gather(1, sel8)[:, 0]
        halves.append(unblocks(pc, nh, nw))
    return modes, pred_y, torch.cat(halves, dim=1)


def intra16_out(nh: int, nw: int, dev: torch.device):
    """grid_intra16's outputs for nh x nw cells on `dev`, in one
    allocation: (modes (nh nw,), pred_y (16 nh, 16 nw), pred_uv (8 nh,
    16 nw)) int32."""
    n = nh * nw
    buf = torch.empty(n * (1 + 256 + 128), dtype=torch.int32, device=dev)
    return (buf[:n], buf[n : 257 * n].view(nh * 16, nw * 16),
            buf[257 * n :].view(nh * 8, nw * 16))


def grid_intra16(ref_y: torch.Tensor, ref_uv: torch.Tensor,
                 avtr: torch.Tensor, avbl: torch.Tensor, nh: int, nw: int,
                 cur: torch.Tensor | None = None,
                 modes: torch.Tensor | None = None, y0: int = 0, out=None):
    """Kernel `grid_intra16`. CPU tensors take the plain version; CUDA
    tensors the kernel. out: the outputs to write (`intra16_out`; the
    modes' part written only when deciding), or None to allocate them."""
    if ref_y.device.type == "cpu":
        return grid_intra16_plain(ref_y, ref_uv, avtr, avbl, nh, nw, cur,
                                  modes, y0)
    if ref_y.device.type != "cuda":
        raise ValueError(f"grid_intra16: unsupported device {ref_y.device}")
    dev = ref_y.device
    di = dev.index
    decide = modes is None
    i32 = torch.int32
    if not (_on(ref_y, i32, di, 2) and _on(ref_uv, i32, di, 2)
            and _on(avtr, torch.bool, di, 1) and _on(avbl, torch.bool, di, 1)
            and (_on(cur, i32, di, 2) if decide
                 else _on(modes, i32, di, 1))):
        raise ValueError("grid_intra16: ref_y, ref_uv, avtr, avbl and cur "
                         f"or modes must be contiguous on {dev} (int32, "
                         "int32, bool, bool, int32)")
    H, W = ref_y.shape
    n = nh * nw
    if decide and (cur.shape[0] < nh * 16 or cur.shape[1] != W
                   or cur.data_ptr() % 16):
        raise ValueError(f"grid_intra16: cur {tuple(cur.shape)} for "
                         f"{nh}x{nw} cells, 16-byte aligned")
    if (tuple(ref_uv.shape) != ((H - y0) // 2 + y0, W) or avtr.numel() != n
            or avbl.numel() != n or nh * 16 + y0 > H or nw * 16 != W
            or y0 < 0):
        raise ValueError(f"grid_intra16: planes {tuple(ref_y.shape)}, "
                         f"{tuple(ref_uv.shape)}, cells {nh}x{nw}, y0 {y0}")
    out_m, pred_y, pred_uv = out if out is not None else intra16_out(nh, nw,
                                                                     dev)
    fn = kbuild.function("grid_intra", "tpuhevc_grid_intra16", _INTRA_ARGS)
    err = fn(ref_y.data_ptr(), ref_uv.data_ptr(), avtr.data_ptr(),
             avbl.data_ptr(), cur.data_ptr() if decide else None,
             None if decide else modes.data_ptr(), out_m.data_ptr(),
             pred_y.data_ptr(), pred_uv.data_ptr(), H, W, nh, nw, y0,
             torch._C._cuda_getCurrentRawStream(di))
    kbuild.check(err, "grid_intra16")
    LAUNCHES["grid_intra16"] += 1
    return (out_m if decide else modes), pred_y, pred_uv
