"""The grid step's motion compensation (kernels `grid_planes`,
`grid_satd` and `grid_subpel`).

`grid_planes`, twin of `luma_planes_all` / `chroma_planes_all`
(`tpuhevc/codec/inter_grid.py:862-910`): every
fractional phase of a stack of reference planes, edge-padded by `pad`,
through the separable DCT-IF filter (luma 8 taps, 4x4 phases; chroma 4
taps, 8x8 phases): h = sum_i taps[fx, i] ref[y, x + i + 1] (no shift at
8 bits), v = sum_j taps[fy, j] h[y + j + 1, x], then
clip(((v >> 6) + 32) >> 6, 0, 255) as int16, over the (hm, wm) window of
the padded plane. Out: (n, P, P, hm, wm) int16, P phases per axis. With
explicit weighted prediction, `wp` = (w (n,), o (n,), d): the weighting
folded into the rounding of the 14-bit intermediate p14 = v >> 6,
clip(((p14 * w + (1 << (d + 6) >> 1)) >> (d + 6)) + o, 0, 255); identity
weights give the default rounding bit for bit.

`grid_satd`, twin of the gather of `pred_luma` / `pred_chroma` (:912-930,
`batch_satd` :1597) with the Hadamard of `satd8_plane` (:951): for C
candidate fields given per cell (mv in 1/P pel and the reference index,
one entry per `cell` x `cell` block of the prediction), the prediction
read from the phase planes at (ref, phase, integer position + look); with
`oy` the 8x8 Hadamard SATD (sum |H r H^T| + 2) >> 2 of r = oy - pred per
8x8 block and the residual sum per 8x8 block (both int32). The DC-aware
float costs that combine them are torch glue in `codec/inter_grid.py`.

`grid_subpel`, twin of `subpel_refine` (:1012-1035, FmeMode dctif): per
CU of size S a 9-point half-pel square around its full-pel MV, then a
9-point quarter-pel square around the winner, each point scored by
`pred_satd` (:969-981: the 8x8 Hadamard SATDs of the gathered prediction
summed over the CU, exact integers) with the first index among equal
minima. Out: the quarter-pel MVs.

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
                      hm: int, wm: int, wp=None, y0: int = 0) -> torch.Tensor:
    """stack (n, h, w) int32 -> (n, P, P, hm, wm) int16 phase planes of the
    window from row y0 of the padded plane; wp: (w (n,) int32, o (n,)
    int32, d) or None."""
    n, h, w = stack.shape
    dev = stack.device
    taps = torch.as_tensor(LUMA_TAPS if is_luma else CHROMA_TAPS,
                           dtype=torch.int32, device=dev)
    P, nt = taps.shape
    if not 0 <= y0 <= h + 2 * pad - hm - nt:
        raise ValueError(f"grid_planes: window rows [{y0}, {y0 + hm + nt}) "
                         f"outside the padded plane {h} + 2 x {pad}")
    ys = (torch.arange(y0, h + 2 * pad, device=dev) - pad).clamp(0, h - 1)
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
    p14 = pl >> 6
    if wp is None:
        return ((p14 + 32) >> 6).clamp(0, 255).to(torch.int16)
    w_, o_, d = wp
    sh = d + 6
    rnd = (1 << sh) >> 1
    return (((p14 * w_.view(n, 1, 1, 1, 1) + rnd) >> sh)
            + o_.view(n, 1, 1, 1, 1)).clamp(0, 255).to(torch.int16)


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
                wm: int, wp=None, y0: int = 0) -> torch.Tensor:
    """Kernel `grid_planes`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if stack.device.type == "cpu":
        return grid_planes_plain(stack, is_luma, pad, hm, wm, wp, y0)
    if stack.device.type != "cuda":
        raise ValueError(f"grid_planes: unsupported device {stack.device}")
    dev = stack.device
    check_tensor(stack, "stack", torch.int32, 3, dev)
    n, h, w = stack.shape
    P, nt = (4, 8) if is_luma else (8, 4)
    if (y0 < 0 or y0 + hm + nt > h + 2 * pad or wm + nt > w + 2 * pad):
        raise ValueError(f"grid_planes: window {hm}x{wm} from row {y0} "
                         f"exceeds the padded plane {h}x{w} + {pad}")
    wpw = wpo = None
    d = 0
    if wp is not None:
        wpw, wpo, d = wp
        check_tensor(wpw, "wp w", torch.int32, 1, dev)
        check_tensor(wpo, "wp o", torch.int32, 1, dev)
        if wpw.shape[0] != n or wpo.shape[0] != n or not 0 <= d <= 7:
            raise ValueError(f"grid_planes: wp w {tuple(wpw.shape)}, o "
                             f"{tuple(wpo.shape)}, d {d} for {n} planes")
    init_consts(dev)
    out = torch.empty((n, P, P, hm, wm), dtype=torch.int16, device=dev)
    fn = kbuild.function("grid_pred", "tpuhevc_grid_planes",
                         [kbuild.P] * 4 + [kbuild.I] * 9 + [kbuild.P])
    err = fn(stack.data_ptr(), None if wp is None else wpw.data_ptr(),
             None if wp is None else wpo.data_ptr(), out.data_ptr(), n, h, w,
             int(is_luma), pad, y0, hm, wm, int(d),
             torch.cuda.current_stream(dev).cuda_stream)
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
    # every read inside the planes: a row stripe's planes end at its halo,
    # and a flat index past a row's end would read the next row
    assert not ix.numel() or (
        int(iy.min()) >= 0 and int(iy.max()) < hm and int(ix.min()) >= 0
        and int(ix.max()) < wm), (
        f"grid_satd: reads rows [{int(iy.min())}, {int(iy.max())}], columns "
        f"[{int(ix.min())}, {int(ix.max())}] of {hm}x{wm} planes")
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


OFFS9 = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def subpel_search(planes: torch.Tensor, oy: torch.Tensor, mv: torch.Tensor,
                  ref: torch.Tensor, S: int, nbh: int, nbw: int, look: int):
    """planes (R, 4, 4, hm, wm) int16 luma phase planes; oy (>= nbh S,
    >= nbw S) int32; mv (nbh nbw, 2) full-pel, ref (nbh nbw,) int32 ->
    ((nbh nbw, 2) int32 quarter-pel MVs, [the (9, nbh, nbw, 2) candidate
    MVs of the half-pel round, then of the quarter-pel round])."""
    hm, wm = planes.shape[-2:]
    Hp, Wp = nbh * S, nbw * S
    f = S // 8
    # every read inside the planes (jnp.take would wrap below 0 and fill
    # past the end): the quarter-pel offsets reach +-3, the integer part
    # of the MV +-(look - 1) with the refine's clamp
    lo, hi = int(mv.min()), int(mv.max())
    assert (look + lo - 1 >= 0 and hi + look + Hp <= hm
            and hi + look + Wp <= wm), (
        f"grid_subpel: MVs in [{lo}, {hi}] read outside the planes "
        f"({hm}x{wm}, look {look})")
    mvq = mv.reshape(nbh, nbw, 2) * 4
    refg = ref.reshape(nbh, nbw)
    offs = torch.as_tensor(OFFS9, dtype=torch.int32, device=mv.device)
    rounds = []
    for step in (2, 1):
        cand = (mvq[None] + offs[:, None, None] * step).contiguous()
        rounds.append(cand)
        _, m8, _ = grid_satd_plain(planes, cand, refg[None].expand(9, -1, -1)
                                   .contiguous(), S, look, oy)
        cost = m8.reshape(9, nbh, f, nbw, f).sum(dim=(2, 4))
        bi = torch.argmin(cost, dim=0)  # the first index among equals
        mvq = mvq + offs[bi] * step
    return mvq.reshape(-1, 2).int(), rounds


def grid_subpel_plain(planes: torch.Tensor, oy: torch.Tensor,
                      mv: torch.Tensor, ref: torch.Tensor, S: int, nbh: int,
                      nbw: int, look: int) -> torch.Tensor:
    """`subpel_search`'s MVs: (nbh nbw, 2) int32 quarter-pel."""
    return subpel_search(planes, oy, mv, ref, S, nbh, nbw, look)[0]


def grid_subpel(planes: torch.Tensor, oy: torch.Tensor, mv: torch.Tensor,
                ref: torch.Tensor, S: int, nbh: int, nbw: int,
                look: int) -> torch.Tensor:
    """Kernel `grid_subpel`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if planes.device.type == "cpu":
        return grid_subpel_plain(planes, oy, mv, ref, S, nbh, nbw, look)
    if planes.device.type != "cuda":
        raise ValueError(f"grid_subpel: unsupported device {planes.device}")
    dev = planes.device
    check_tensor(planes, "planes", torch.int16, 5, dev)
    check_tensor(oy, "oy", torch.int32, 2, dev)
    check_tensor(mv, "mv", torch.int32, 2, dev)
    check_tensor(ref, "ref", torch.int32, 1, dev)
    R, P, _, hm, wm = planes.shape
    nb = nbh * nbw
    if (P != 4 or S not in (8, 16, 32) or tuple(mv.shape) != (nb, 2)
            or ref.shape[0] != nb or oy.shape[0] < nbh * S
            or oy.shape[1] < nbw * S):
        raise ValueError(f"grid_subpel: planes {tuple(planes.shape)}, oy "
                         f"{tuple(oy.shape)}, mv {tuple(mv.shape)}, S {S}, "
                         f"{nbh}x{nbw} CUs")
    init_consts(dev)
    out = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    fn = kbuild.function("grid_pred", "tpuhevc_grid_subpel",
                         [kbuild.P] * 5 + [kbuild.I] * 7 + [kbuild.P])
    err = fn(planes.data_ptr(), oy.data_ptr(), mv.data_ptr(), ref.data_ptr(),
             out.data_ptr(), hm, wm, nbh, nbw, S, look, oy.shape[1],
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_subpel")
    LAUNCHES["grid_subpel"] += 1
    return out
