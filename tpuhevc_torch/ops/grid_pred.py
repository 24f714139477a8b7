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

`grid_satd_plain`, twin of the gather of `pred_luma` / `pred_chroma`
(:912-930): for C fields given per cell (mv in 1/P pel and the reference
index, one entry per `cell` x `cell` block of the prediction), the
prediction read from the phase planes at (ref, phase, integer position +
look); with `oy` also the 8x8 Hadamard SATD (sum |H r H^T| + 2) >> 2 of
r = oy - pred per 8x8 block and the residual sum per 8x8 block (both
int32), as `satd8_plane` (:951) and `batch_satd` (:1597). Kernel
`grid_satd` (wrapper `grid_mc`) gathers one class coding's luma and
chroma predictions in one launch.

`grid_satd_cost`, twin of `pred_satd_z` (:983) and `batch_satd`'s float
part: for up to MAX_FIELDS fields of CUs (`SatdField`: each CU of size S
at one MV and reference), the SATDs of the prediction gathered at the
CU's MV and, per CU, one float32: the DC-aware cost `satd_z` (mode "z")
or the sum of the 8x8 SATDs (mode "plain", the rectangular trial's
half-CU cells). Its plain version is the composition
satd_z(grid_satd_plain(...)).

`grid_subpel`, twin of `subpel_refine` (:1012-1035, FmeMode dctif): per
CU of size S a 9-point half-pel square around its full-pel MV, then a
9-point quarter-pel square around the winner, each point scored by
`pred_satd` (:969-981: the 8x8 Hadamard SATDs of the gathered prediction
summed over the CU, exact integers) with the first index among equal
minima. Out: the quarter-pel MVs. `grid_subpel_classes` runs up to three
classes of CUs (the grid's 16x16, 8x8 and 32x32) in one launch;
`grid_subpel` is its one-class case.

`*_plain` are the PyTorch versions; the wrappers launch the CUDA kernels
(`kernels/csrc/grid_pred.cu`) for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import check_tensor
from ..device import contiguous_on as _on
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from .cost import wht
from .grid_code import up
from .grid_me import tile_sum
from .interp import CHROMA_TAPS, LUMA_TAPS

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
MAX_FIELDS = 8  # grid_satd_cost's fields a launch (kMaxFields)
MAX_CLASSES = 3  # grid_subpel's classes a launch (kSubpelClasses)


def init_consts(dev: torch.device) -> None:
    """Copy the taps to grid_pred's constant memory on `dev` (once per
    device)."""
    if dev.index in _READY:
        return
    lt = np.ascontiguousarray(LUMA_TAPS, dtype=np.int32)
    ct = np.ascontiguousarray(CHROMA_TAPS, dtype=np.int32)
    fn = kbuild.function("grid_pred", "tpuhevc_grid_pred_init", [kbuild.P] * 2)
    kbuild.check(fn(lt.ctypes.data, ct.ctypes.data), "grid_pred init")
    _READY.add(dev.index)


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
    out = torch.empty((n, P, P, hm, wm), dtype=torch.int16, device=dev)
    err = _entry(dev, "tpuhevc_grid_planes", _PLANES_ARGS)(
        stack.data_ptr(), None if wp is None else wpw.data_ptr(),
        None if wp is None else wpo.data_ptr(), out.data_ptr(), n, h, w,
        int(is_luma), pad, y0, hm, wm, int(d),
        torch._C._cuda_getCurrentRawStream(dev.index))
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


def grid_mc_plain(planes_y: torch.Tensor, planes_c: torch.Tensor,
                  mv8: torch.Tensor, ref8: torch.Tensor, look: int,
                  look_c: int):
    """One class coding's predictions from per-8-cell fields mv8 (h8',
    w8', 2), ref8 (h8', w8'): (luma (8 h8', 8 w8'), chroma (4 h8', 8 w8')
    packed [U | V]) int32; planes_c holds U's references, then V's."""
    R = planes_y.shape[0]
    pred_y = grid_satd_plain(planes_y, mv8[None].contiguous(),
                             ref8[None].contiguous(), 8, look)[0][0]
    mv = torch.stack([mv8, mv8]).contiguous()
    ref = torch.stack([ref8, ref8 + R]).contiguous()
    pc = grid_satd_plain(planes_c, mv, ref, 4, look_c)[0]
    return pred_y, torch.cat([pc[0], pc[1]], dim=1)


def grid_mc(planes_y: torch.Tensor, planes_c: torch.Tensor,
            mv8: torch.Tensor, ref8: torch.Tensor, look: int, look_c: int):
    """Kernel `grid_satd`, the gathers of one class coding (see
    `grid_mc_plain`) in one launch. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if planes_y.device.type == "cpu":
        return grid_mc_plain(planes_y, planes_c, mv8, ref8, look, look_c)
    if planes_y.device.type != "cuda":
        raise ValueError(f"grid_satd: unsupported device {planes_y.device}")
    dev = planes_y.device
    di = dev.index
    R, P, _, hmy, wmy = planes_y.shape
    _, Pc, _, hmc, wmc = planes_c.shape
    hc, wc = ref8.shape
    if (not (_on(planes_y, torch.int16, di) and _on(planes_c, torch.int16, di)
             and _on(mv8, torch.int32, di) and _on(ref8, torch.int32, di))
            or P != 4 or Pc != 8 or planes_c.shape[0] != 2 * R
            or mv8.shape != (hc, wc, 2)):
        raise ValueError(f"grid_satd: planes {tuple(planes_y.shape)} and "
                         f"{tuple(planes_c.shape)}, mv {tuple(mv8.shape)}, "
                         f"ref {tuple(ref8.shape)}")
    # one allocation: the luma rows, then the chroma rows
    buf = torch.empty(96 * hc * wc, dtype=torch.int32, device=dev)
    pred_y = buf.as_strided((8 * hc, 8 * wc), (8 * wc, 1))
    pred_uv = buf.as_strided((4 * hc, 8 * wc), (8 * wc, 1), 64 * hc * wc)
    la = _launch(di, "tpuhevc_grid_satd")
    la.p[:6] = (planes_y.data_ptr(), planes_c.data_ptr(), mv8.data_ptr(),
                ref8.data_ptr(), pred_y.data_ptr(), pred_uv.data_ptr())
    la.q[:9] = (R, hmy, wmy, hmc, wmc, hc, wc, look, look_c)
    kbuild.check(la(), "grid_satd")
    LAUNCHES["grid_satd"] += 1
    return pred_y, pred_uv


class _Launch:
    """A C entry of grid_pred on one device that takes its arguments in
    host arrays (pointers p, ints q, floats d), read before the launch
    returns: the arrays are kept with their addresses, so that a call
    only fills them."""

    def __init__(self, di: int, symbol: str):
        dev = torch.device("cuda", di)
        self.p = np.zeros(3 + 3 * MAX_FIELDS, np.uint64)
        self.q = np.zeros(7 + 5 * MAX_FIELDS, np.int32)
        self.d = np.zeros(MAX_FIELDS, np.float32)
        addr = [self.p.ctypes.data, self.q.ctypes.data]
        if symbol == "tpuhevc_grid_satd_cost":
            addr.append(self.d.ctypes.data)
        self.fn = _entry(dev, symbol, [kbuild.P] * (len(addr) + 1))
        self.addr = tuple(addr)
        self.di = di

    def __call__(self) -> int:
        return self.fn(*self.addr,
                       torch._C._cuda_getCurrentRawStream(self.di))


_LAUNCH: dict = {}


def _launch(di: int, symbol: str) -> _Launch:
    la = _LAUNCH.get((di, symbol))
    if la is None:
        la = _LAUNCH[(di, symbol)] = _Launch(di, symbol)
    return la


_PLANES_ARGS = [kbuild.P] * 4 + [kbuild.I] * 9 + [kbuild.P]
_ENTRIES: dict = {}


def _entry(dev: torch.device, symbol: str, argtypes: list):
    """grid_pred's C entry `symbol`, its constants on `dev` copied first;
    looked up once per device."""
    key = (symbol, dev.index)
    fn = _ENTRIES.get(key)
    if fn is None:
        init_consts(dev)
        fn = _ENTRIES[key] = kbuild.function("grid_pred", symbol, argtypes)
    return fn


def group_sum(x: torch.Tensor, f: int) -> torch.Tensor:
    """(f a, f b, ...) -> (a, b, ...) sums of f x f groups (integer or
    integer-valued float32 data: exact in any order)."""
    if f == 1:
        return x
    h, w = x.shape[:2]
    return x.reshape(h // f, f, w // f, f, *x.shape[2:]).sum(dim=(1, 3))


def satd_z(m8, s8, S, nbh, nbw, dc, lam_me_f) -> torch.Tensor:
    """DC-aware per-CU SATD (nbh, nbw) float32 from the 8x8 SATD and
    residual sums of a field of S-CUs (`pred_satd_z` / `batch_satd`'s
    float part); dc: c_S, a float32 value; lam_me_f: a float32 0-dim
    tensor."""
    m8c = m8[: nbh * S // 8, : nbw * S // 8]
    s8c = s8[: nbh * S // 8, : nbw * S // 8]
    dc8 = (s8c.abs() + 2) >> 2
    ac8 = (m8c - dc8).float()
    dcc = lam_me_f * 12.0 + torch.tensor(np.float32(dc), dtype=torch.float32,
                                         device=m8.device)
    if S == 8:
        return ac8 + torch.minimum(dc8.float(), dcc)
    f = S // 8
    ac = group_sum(ac8, f)
    dcsum = group_sum(dc8, f).float()
    cu_dc = ((group_sum(s8c, f).abs() + 2) >> 2).float()
    dcvar = torch.clamp(dcsum - cu_dc, min=0.0)
    return ac + 0.5 * dcvar + torch.minimum(cu_dc, dcc)


class SatdField(NamedTuple):
    """A field of CUs for `grid_satd_cost`: mv (rows', ld, 2) and ref
    (rows', ld) int32 per source cell; the CUs of size `size` (8, 16, 32,
    64) on a (rows, cols) grid read the source cell at their own position,
    or with `pair` 1 / 2 the first / second cell of their pair along x
    (columns 2k, 2k + 1), 3 / 4 along y; dc: the field's c_S (mode z)."""
    mv: torch.Tensor
    ref: torch.Tensor
    size: int
    rows: int
    cols: int
    pair: int = 0
    dc: float = 0.0


def field_cells(fl: SatdField):
    """The (rows, cols, 2) MVs and (rows, cols) references of the field's
    CUs (its pairs resolved)."""
    ys = torch.arange(fl.rows, device=fl.mv.device)
    xs = torch.arange(fl.cols, device=fl.mv.device)
    if fl.pair in (1, 2):
        xs = (xs & ~1) | (fl.pair - 1)
    elif fl.pair in (3, 4):
        ys = (ys & ~1) | (fl.pair - 3)
    return fl.mv[ys][:, xs], fl.ref[ys][:, xs]


def grid_satd_cost_plain(planes: torch.Tensor, oy: torch.Tensor, fields,
                         look: int, mode: str = "z", lam_me_f=None,
                         out=None) -> list:
    """The PyTorch composition: per field, `grid_satd_plain` of its CUs'
    MVs repeated over their 8x8 blocks, then `satd_z` (mode "z") or the
    sums of the 8x8 SATDs over each CU as float32 (mode "plain") ->
    [(rows, cols) float32 a field]. out is the kernel's and unused."""
    res = []
    for fl in fields:
        mv, ref = field_cells(fl)
        f = fl.size // 8
        _, m8, s8 = grid_satd_plain(
            planes, up(mv.permute(2, 0, 1), f).permute(1, 2, 0)[None]
            .contiguous(), up(ref, f)[None].contiguous(), 8, look, oy,
            want_pred=False)
        if mode == "z":
            res.append(satd_z(m8[0], s8[0], fl.size, fl.rows, fl.cols, fl.dc,
                              lam_me_f))
        else:
            res.append(group_sum(m8[0], f).float())
    return res


def grid_satd_cost(planes: torch.Tensor, oy: torch.Tensor, fields,
                   look: int, mode: str = "z", lam_me_f=None,
                   out: list | None = None) -> list:
    """Kernel `grid_satd_cost`: the fields' CU costs (see
    `grid_satd_cost_plain`) in one launch. CPU tensors take the plain
    version. On CUDA lam_me_f is a 0-dim float32 tensor read on the card
    (no sync); out: the fields' (rows, cols) float32 tensors to write
    (returned), or None to allocate them."""
    if planes.device.type == "cpu":
        return grid_satd_cost_plain(planes, oy, fields, look, mode, lam_me_f)
    if planes.device.type != "cuda":
        raise ValueError(f"grid_satd_cost: unsupported device "
                         f"{planes.device}")
    dev = planes.device
    di = dev.index
    plain = mode == "plain"
    nf = len(fields)
    R, P, _, hm, wm = planes.shape
    ho, wo = oy.shape
    if (not (_on(planes, torch.int16, di) and _on(oy, torch.int32, di))
            or P != 4 or mode not in ("z", "plain") or not 0 < nf <= MAX_FIELDS
            or not (plain or (_on(lam_me_f, torch.float32, di)
                              and lam_me_f.dim() == 0))):
        raise ValueError(f"grid_satd_cost: planes {planes.dtype}"
                         f"{tuple(planes.shape)}, oy {oy.dtype}"
                         f"{tuple(oy.shape)} on {oy.device}, mode {mode}, "
                         f"{nf} fields, lambda {lam_me_f!r}")
    if out is None:
        buf = torch.empty(sum(fl.rows * fl.cols for fl in fields),
                          dtype=torch.float32, device=dev)
        out = [o.view(fl.rows, fl.cols) for o, fl in zip(
            buf.split([fl.rows * fl.cols for fl in fields]), fields)]
    ptrs = [planes.data_ptr(), oy.data_ptr(),
            0 if plain else lam_me_f.data_ptr()]
    ints = [nf, plain, R, hm, wm, wo, look]
    for fl, o in zip(fields, out):
        mv, ref, S, rows, cols, pair = fl[:6]
        hs, ld = ref.shape
        if (not (_on(mv, torch.int32, di) and _on(ref, torch.int32, di)
                 and _on(o, torch.float32, di))
                or mv.shape != (hs, ld, 2) or o.shape != (rows, cols)
                or S not in (8, 16, 32, 64) or not 0 <= pair <= 4
                or cols + (pair in (1, 2) and cols % 2) > ld
                or rows + (pair in (3, 4) and rows % 2) > hs
                or rows * S > ho or cols * S > wo):
            raise ValueError(f"grid_satd_cost: field mv {tuple(mv.shape)}, "
                             f"ref {tuple(ref.shape)}, out {tuple(o.shape)}, "
                             f"{rows}x{cols} CUs of {S}, pair {pair}, oy "
                             f"{tuple(oy.shape)}")
        ptrs += (mv.data_ptr(), ref.data_ptr(), o.data_ptr())
        ints += (ld, rows, cols, S.bit_length() - 4, pair)
    la = _launch(di, "tpuhevc_grid_satd_cost")
    la.p[: len(ptrs)] = ptrs
    la.q[: len(ints)] = ints
    la.d[:nf] = [fl.dc for fl in fields]
    kbuild.check(la(), "grid_satd_cost")
    LAUNCHES["grid_satd_cost"] += 1
    return out


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


def grid_subpel_classes_plain(planes: torch.Tensor, oy: torch.Tensor,
                              classes, look: int) -> list:
    """`grid_subpel_plain` of each class (mv, ref, S, nbh, nbw)."""
    return [grid_subpel_plain(planes, oy, mv, ref, S, nbh, nbw, look)
            for mv, ref, S, nbh, nbw in classes]


def grid_subpel_classes(planes: torch.Tensor, oy: torch.Tensor, classes,
                        look: int) -> list:
    """Kernel `grid_subpel` over up to three classes of CUs in one launch:
    classes [(mv (nbh nbw, 2) full-pel, ref (nbh nbw,) int32, S (8, 16,
    32), nbh, nbw)] -> [(nbh nbw, 2) int32 quarter-pel MVs a class]. CPU
    tensors take the plain version; CUDA tensors the kernel. The caller
    keeps |mv| <= look - 1, so that every read lies inside the planes
    (the plain version asserts it; the kernel does not sync to check)."""
    if planes.device.type == "cpu":
        return grid_subpel_classes_plain(planes, oy, classes, look)
    if planes.device.type != "cuda":
        raise ValueError(f"grid_subpel: unsupported device {planes.device}")
    dev = planes.device
    di = dev.index
    R, P, _, hm, wm = planes.shape
    ho, wo = oy.shape
    if (not (_on(planes, torch.int16, di) and _on(oy, torch.int32, di))
            or P != 4 or not 0 < len(classes) <= MAX_CLASSES):
        raise ValueError(f"grid_subpel: planes {planes.dtype}"
                         f"{tuple(planes.shape)}, oy {oy.dtype}"
                         f"{tuple(oy.shape)}, {len(classes)} classes")
    sizes = [nbh * nbw for _, _, _, nbh, nbw in classes]
    buf = torch.empty((sum(sizes), 2), dtype=torch.int32, device=dev)
    out = list(buf.split(sizes))
    ptrs = [planes.data_ptr(), oy.data_ptr()]
    ints = [len(classes), R, hm, wm, wo, look]
    for (mv, ref, S, nbh, nbw), o in zip(classes, out):
        nb = nbh * nbw
        if (not (_on(mv, torch.int32, di) and _on(ref, torch.int32, di))
                or tuple(mv.shape) != (nb, 2) or tuple(ref.shape) != (nb,)
                or S not in (8, 16, 32) or nbh * S > ho or nbw * S > wo):
            raise ValueError(f"grid_subpel: class mv {tuple(mv.shape)}, ref "
                             f"{tuple(ref.shape)}, {nbh}x{nbw} CUs of {S}, "
                             f"oy {tuple(oy.shape)}")
        ptrs += (mv.data_ptr(), ref.data_ptr(), o.data_ptr())
        ints += (nb, nbh, nbw, S.bit_length() - 4)
    if not sum(sizes):
        return out
    la = _launch(di, "tpuhevc_grid_subpel")
    la.p[: len(ptrs)] = ptrs
    la.q[: len(ints)] = ints
    kbuild.check(la(), "grid_subpel")
    LAUNCHES["grid_subpel"] += 1
    return out


def grid_subpel(planes: torch.Tensor, oy: torch.Tensor, mv: torch.Tensor,
                ref: torch.Tensor, S: int, nbh: int, nbw: int,
                look: int) -> torch.Tensor:
    """Kernel `grid_subpel` of one class: `grid_subpel_classes`' one-class
    case. CPU tensors take the plain version; CUDA tensors the kernel."""
    return grid_subpel_classes(planes, oy, [(mv, ref, S, nbh, nbw)],
                               look)[0]
