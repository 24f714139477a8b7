"""The 35-mode intra prediction bank of the open-loop decision (kernel
`intra_bank`).

Twin of the reference gather `refs` (`tpuhevc/codec/intra_decide_jax.py:
66-73`) and of `predict_all_modes` (`tpuhevc/ops/intra.py:197-347`): for
N target blocks of size S, from their (2S+1)-sample top and left
reference arrays (corner at index 0), every mode's S x S prediction --
planar, DC and the 33 angular modes with projected side samples for the
negative angles -- with [1 2 1] smoothing for luma S >= 8 by the mode's
filter flag, bilinear strong smoothing for luma 32x32 where the SPS
enables it and the block is flat enough, and the DC/VER/HOR boundary
post-filters for luma S < 32. All integer, exact.

`predict_all_modes_plain` is the PyTorch version; `intra_bank` launches
the CUDA kernel (`kernels/csrc/intra_bank.cu`) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import (
    DC_IDX,
    HOR_IDX,
    INTRA_INV_ANGLE,
    INTRA_PRED_ANGLE,
    PLANAR_IDX,
    VER_IDX,
)

_INIT_DEVICES: set = set()


def refs(plane: torch.Tensor, S: int, nh: int, nw: int):
    """Open-loop reference arrays of the nh x nw grid of S x S blocks of
    `plane` (H, W) int32, the plane edge-replicated: -> tops, lefts
    (nh*nw, 2S+1) int32, corner at index 0."""
    h, w = plane.shape
    dev = plane.device
    ys = torch.arange(nh, device=dev) * S - 1
    xs = torch.arange(nw, device=dev) * S - 1
    rng = torch.arange(2 * S + 1, device=dev)
    ty = ys.clamp(0, h - 1)[:, None, None].expand(nh, nw, 2 * S + 1)
    tx = (xs[None, :, None] + rng).clamp(0, w - 1).expand(nh, nw, 2 * S + 1)
    ly = (ys[:, None, None] + rng).clamp(0, h - 1).expand(nh, nw, 2 * S + 1)
    lx = xs.clamp(0, w - 1)[None, :, None].expand(nh, nw, 2 * S + 1)
    tops = plane[ty, tx].reshape(nh * nw, -1).int().contiguous()
    lefts = plane[ly, lx].reshape(nh * nw, -1).int().contiguous()
    return tops, lefts


def blocks(plane: torch.Tensor, S: int, nh: int, nw: int) -> torch.Tensor:
    """The nh x nw grid of S x S blocks of `plane`, raster order ->
    (nh*nw, S, S) int32."""
    return (plane[: nh * S, : nw * S].reshape(nh, S, nw, S)
            .permute(0, 2, 1, 3).reshape(nh * nw, S, S).int().contiguous())


def unblocks(b: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(nh*nw, S, S) blocks in raster order -> the (nh S, nw S) plane."""
    S = b.shape[-1]
    return b.reshape(nh, nw, S, S).permute(0, 2, 1, 3).reshape(nh * S,
                                                                 nw * S)


def _smooth(t, l):
    s2 = t.shape[-1] - 1
    corner = (l[:, 1] + 2 * t[:, 0] + t[:, 1] + 2) >> 2
    ft_mid = (t[:, : s2 - 1] + 2 * t[:, 1:s2] + t[:, 2:] + 2) >> 2
    fl_mid = (l[:, : s2 - 1] + 2 * l[:, 1:s2] + l[:, 2:] + 2) >> 2
    ft = torch.cat([corner[:, None], ft_mid, t[:, s2:]], dim=-1)
    fl = torch.cat([corner[:, None], fl_mid, l[:, s2:]], dim=-1)
    return ft, fl


def _strong(t, l):
    s2 = t.shape[-1] - 1
    i = torch.arange(1, s2, device=t.device)
    tl = t[:, 0:1]
    tr = t[:, s2 : s2 + 1]
    bl = l[:, s2 : s2 + 1]
    ft = torch.cat([tl, ((s2 - i) * tl + i * tr + 32) >> 6, tr], dim=-1)
    fl = torch.cat([tl, ((s2 - i) * tl + i * bl + 32) >> 6, bl], dim=-1)
    return ft, fl


def _strong_ok(t, l, bit_depth):
    s2 = t.shape[-1] - 1
    thr = 1 << (bit_depth - 5)
    c1 = (t[:, 0] + t[:, s2] - 2 * t[:, s2 // 2]).abs() < thr
    c2 = (l[:, 0] + l[:, s2] - 2 * l[:, s2 // 2]).abs() < thr
    return c1 & c2


def _predict_one(t, l, mode: int, s: int):
    n = t.shape[0]
    dev = t.device
    if mode == PLANAR_IDX:
        x = torch.arange(s, device=dev)[None, None, :]
        y = torch.arange(s, device=dev)[None, :, None]
        tr = t[:, s + 1][:, None, None]
        bl = l[:, s + 1][:, None, None]
        lcol = l[:, 1 : s + 1][:, :, None]
        trow = t[:, 1 : s + 1][:, None, :]
        return ((s - 1 - x) * lcol + (x + 1) * tr + (s - 1 - y) * trow
                + (y + 1) * bl + s) >> s.bit_length()
    if mode == DC_IDX:
        dc = (t[:, 1 : s + 1].sum(-1) + l[:, 1 : s + 1].sum(-1) + s) \
            >> s.bit_length()
        return dc[:, None, None].expand(n, s, s)
    angle = mode_angle(mode)
    main, side = (t, l) if mode >= 18 else (l, t)
    need = (s * angle) >> 5 if angle < 0 else 0
    if angle < 0 and need < -1:
        inv = mode_inv_angle(mode)
        proj_idx = [((x * inv + 128) >> 8) for x in range(need, 0)]
        ref = torch.cat([side[:, proj_idx], main[:, : 2 * s + 1]], dim=-1)
        base = -need
    else:
        ref = main[:, : 2 * s + 1]
        base = 0
    y = np.arange(1, s + 1)[:, None]
    pos = y * angle
    idx = (pos >> 5) + np.arange(s)[None, :] + 1
    frac = torch.as_tensor(pos & 31, device=dev)[None]
    # jnp.take clamps: the `b` index past the end only occurs with frac 0
    ia = torch.as_tensor(base + idx, device=dev).reshape(-1)
    ib = (ia + 1).clamp(max=ref.shape[1] - 1)
    a = ref[:, ia].reshape(n, s, s)
    b = ref[:, ib].reshape(n, s, s)
    pred = ((32 - frac) * a + frac * b + 16) >> 5
    return pred.transpose(-1, -2) if mode < 18 else pred


def _post_filter(pred, t, l, mode: int, bit_depth: int):
    s = pred.shape[-1]
    maxv = (1 << bit_depth) - 1
    if mode == DC_IDX:
        pred = pred.clone()
        dc = pred[:, 0, 0][:, None]
        row0 = (t[:, 2 : s + 1] + 3 * dc + 2) >> 2
        col0 = (l[:, 2 : s + 1] + 3 * dc + 2) >> 2
        pred[:, 0, 0] = (l[:, 1] + 2 * dc[:, 0] + t[:, 1] + 2) >> 2
        pred[:, 0, 1:] = row0
        pred[:, 1:, 0] = col0
    elif mode == VER_IDX:
        pred = pred.clone()
        pred[:, :, 0] = (t[:, 1][:, None]
                         + ((l[:, 1 : s + 1] - l[:, 0][:, None]) >> 1)
                         ).clamp(0, maxv)
    elif mode == HOR_IDX:
        pred = pred.clone()
        pred[:, 0, :] = (l[:, 1][:, None]
                         + ((t[:, 1 : s + 1] - t[:, 0][:, None]) >> 1)
                         ).clamp(0, maxv)
    return pred


def predict_all_modes_plain(tops: torch.Tensor, lefts: torch.Tensor, S: int,
                            is_luma: bool = True, bit_depth: int = 8,
                            strong_smoothing: bool = True) -> torch.Tensor:
    """(N, 2S+1) int32 refs -> (N, 35, S, S) int32 predictions."""
    log2 = S.bit_length() - 1
    t, l = tops.long(), lefts.long()
    if is_luma and log2 >= 3:
        ft, fl = _smooth(t, l)
        if log2 == 5 and strong_smoothing:
            ok = _strong_ok(t, l, bit_depth)[:, None]
            st, sl = _strong(t, l)
            ft = torch.where(ok, st, ft)
            fl = torch.where(ok, sl, fl)
    else:
        ft, fl = t, l
    preds = []
    for mode in range(35):
        use_f = is_luma and filter_flag(mode, log2)
        p = _predict_one(ft if use_f else t, fl if use_f else l, mode, S)
        if is_luma and S < 32:
            p = _post_filter(p, t, l, mode, bit_depth)
        preds.append(p)
    return torch.stack(preds, dim=1).int()


def intra_tables():
    """Each mode's angle, inverse angle (modes 11..25, else 0) and filter
    flags by log2 size [log2 - 2][mode], int32 host arrays: the constant
    tables of intra_pred.cuh."""
    ang = np.zeros(35, np.int32)
    inv = np.zeros(35, np.int32)
    flt = np.zeros(4 * 35, np.int32)
    for m in range(2, 35):
        ang[m] = mode_angle(m)
        if 11 <= m <= 25:
            inv[m] = mode_inv_angle(m)
    for log2 in range(2, 6):
        for m in range(35):
            flt[(log2 - 2) * 35 + m] = int(filter_flag(m, log2))
    return ang, inv, flt


def _init_tables(dev: torch.device) -> None:
    """Copy each mode's angle, inverse angle and filter flags by log2 size
    into the kernel's constant memory."""
    if dev.index in _INIT_DEVICES:
        return
    fn = kbuild.function("intra_bank", "tpuhevc_intra_bank_init",
                         [kbuild.P] * 3)
    with torch.cuda.device(dev):
        kbuild.check(fn(*(a.ctypes.data_as(ctypes.c_void_p)
                          for a in intra_tables())),
                     "intra_bank init")
    _INIT_DEVICES.add(dev.index)


def intra_bank(tops: torch.Tensor, lefts: torch.Tensor, S: int,
               is_luma: bool = True, bit_depth: int = 8,
               strong_smoothing: bool = True) -> torch.Tensor:
    """Kernel `intra_bank`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if tops.device.type == "cpu":
        return predict_all_modes_plain(tops, lefts, S, is_luma, bit_depth,
                                       strong_smoothing)
    if tops.device.type != "cuda":
        raise ValueError(f"intra_bank: unsupported device {tops.device}")
    dev = tops.device
    check_tensor(tops, "tops", torch.int32, 2, dev)
    check_tensor(lefts, "lefts", torch.int32, 2, dev)
    n = tops.shape[0]
    if S not in (4, 8, 16, 32) or tuple(tops.shape) != (n, 2 * S + 1) or \
            lefts.shape != tops.shape or not 8 <= bit_depth <= 12:
        raise ValueError(f"intra_bank: unsupported S={S} refs "
                         f"{tuple(tops.shape)}/{tuple(lefts.shape)} "
                         f"bit depth {bit_depth}")
    out = torch.empty((n, 35, S, S), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _init_tables(dev)
    fn = kbuild.function("intra_bank", "tpuhevc_intra_bank",
                         [kbuild.P] * 3 + [kbuild.I] * 5 + [kbuild.P])
    err = fn(tops.data_ptr(), lefts.data_ptr(), out.data_ptr(), n,
             S.bit_length() - 1, int(is_luma), bit_depth,
             int(strong_smoothing), torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "intra_bank")
    LAUNCHES["intra_bank"] += 1
    return out


# --- numpy host prediction (the coding walks, the decoder) ------------------
# Copied from the reference's numpy path; the host side stays numpy.

# smoothing threshold per nTbS (§8.4.4.2.3): index by log2 size
_FILTER_THRES = {3: 7, 4: 1, 5: 0}


def mode_angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def mode_inv_angle(mode: int) -> int:
    return int(INTRA_INV_ANGLE[mode - 11])


def filter_flag(mode: int, log2_size: int) -> bool:
    """Whether [1 2 1] reference smoothing applies (luma only)."""
    if mode == DC_IDX or log2_size == 2:
        return False
    min_dist = min(abs(mode - HOR_IDX), abs(mode - VER_IDX))
    if mode == PLANAR_IDX:
        min_dist = 10  # |planar-10| per mode-number arithmetic
    return min_dist > _FILTER_THRES[log2_size]


def smooth_refs_np(top: np.ndarray, left: np.ndarray, bit_depth: int = 8,
                   strong: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """[1 2 1]/4 smoothing of the reference arrays (§8.4.4.2.3).
    top/left: (..., 2S+1) with corner at index 0 (shared)."""
    s2 = top.shape[-1] - 1  # 2S
    if strong:
        # bi-linear strong smoothing for 32x32 (§8.4.4.2.3 eq. 8-30..8-35)
        size = s2 // 2
        tl = top[..., 0]
        tr = top[..., s2]
        bl = left[..., s2]
        i = np.arange(1, s2)
        ft = top.copy()
        fl = left.copy()
        # pF at array index i = ((2N-i)*TL + i*TR + N) >> (log2(2N)); the
        # reference writes ((uiTuWidth2-i)*topLeft + i*topRight +
        # uiTuWidth) >> shift (TComPattern.cpp:279)
        ft[..., 1:s2] = ((s2 - i) * tl[..., None] + i * tr[..., None] + 32) >> 6
        fl[..., 1:s2] = ((s2 - i) * tl[..., None] + i * bl[..., None] + 32) >> 6
        return ft, fl
    ft = top.copy()
    fl = left.copy()
    # corner filtered with top[1] and left[1]
    ft[..., 0] = (left[..., 1] + 2 * top[..., 0] + top[..., 1] + 2) >> 2
    fl[..., 0] = ft[..., 0]
    ft[..., 1:s2] = (top[..., :s2 - 1] + 2 * top[..., 1:s2] + top[..., 2:] + 2) >> 2
    fl[..., 1:s2] = (left[..., :s2 - 1] + 2 * left[..., 1:s2] + left[..., 2:] + 2) >> 2
    # last samples unfiltered (p[2S-1])
    return ft, fl


def strong_smoothing_ok(top: np.ndarray, left: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Flatness criterion enabling bilinear smoothing for 32x32 luma."""
    s2 = top.shape[-1] - 1
    size = s2 // 2
    thr = 1 << (bit_depth - 5)
    c1 = np.abs(top[..., 0] + top[..., s2] - 2 * top[..., size]) < thr
    c2 = np.abs(left[..., 0] + left[..., s2] - 2 * left[..., size]) < thr
    return c1 & c2


def predict_np(top: np.ndarray, left: np.ndarray, mode: int, size: int,
               bit_depth: int = 8) -> np.ndarray:
    """Single-block prediction. top/left: (2S+1,) arrays (corner at 0).
    Returns (S, S) prediction [y][x]. No post-filtering toggles here:
    DC/H/V boundary filters are applied by the caller for luma < 32."""
    s = size
    maxv = (1 << bit_depth) - 1
    t = top.astype(np.int32)
    l = left.astype(np.int32)
    if mode == PLANAR_IDX:
        x = np.arange(s)[None, :]
        y = np.arange(s)[:, None]
        tr = t[s + 1]  # p[nTbS][-1]
        bl = l[s + 1]  # p[-1][nTbS]
        pred = (
            (s - 1 - x) * l[1 + np.arange(s)][:, None]
            + (x + 1) * tr
            + (s - 1 - y) * t[1 + np.arange(s)][None, :]
            + (y + 1) * bl
            + s
        ) >> (int(s).bit_length())  # log2(s) + 1
        return pred.astype(np.int32)
    if mode == DC_IDX:
        dc = (t[1 : s + 1].sum() + l[1 : s + 1].sum() + s) >> (int(s).bit_length())
        return np.full((s, s), dc, dtype=np.int32)
    angle = mode_angle(mode)
    if mode >= 18:
        # vertical-ish: main reference = top row
        ref = np.zeros(3 * s + 2, dtype=np.int32)  # index i maps x = i - s
        ref[s : 3 * s + 1] = t[: 2 * s + 1]
        ref[3 * s + 1] = t[2 * s]
        if angle < 0:
            inv = mode_inv_angle(mode)
            need = (s * angle) >> 5
            if need < -1:  # extension only when reads reach below ref[0]
                for x in range(-1, need - 1, -1):
                    ref[s + x] = l[((x * inv + 128) >> 8)]
        y = np.arange(1, s + 1)[:, None]
        pos = y * angle
        idx = (pos >> 5) + np.arange(s)[None, :]  # x offset
        frac = pos & 31
        a = ref[s + idx + 1]   # ref[x + iIdx + 1], corner at ref[s]
        b = ref[s + idx + 2]
        pred = ((32 - frac) * a + frac * b + 16) >> 5
        return pred.astype(np.int32)
    # horizontal-ish: main reference = left col, then transpose
    ref = np.zeros(3 * s + 2, dtype=np.int32)
    ref[s : 3 * s + 1] = l[: 2 * s + 1]
    ref[3 * s + 1] = l[2 * s]
    if angle < 0:
        inv = mode_inv_angle(mode)
        need = (s * angle) >> 5
        if need < -1:
            for x in range(-1, need - 1, -1):
                ref[s + x] = t[((x * inv + 128) >> 8)]
    y = np.arange(1, s + 1)[:, None]
    pos = y * angle
    idx = (pos >> 5) + np.arange(s)[None, :]
    frac = pos & 31
    a = ref[s + idx + 1]
    b = ref[s + idx + 2]
    pred = ((32 - frac) * a + frac * b + 16) >> 5
    return pred.T.astype(np.int32)


def post_filter_np(pred: np.ndarray, top: np.ndarray, left: np.ndarray,
                   mode: int, bit_depth: int = 8) -> np.ndarray:
    """DC/H/V boundary filtering for luma TBs < 32 (§8.4.4.2.5/2.6)."""
    s = pred.shape[-1]
    maxv = (1 << bit_depth) - 1
    p = pred.copy()
    t = top.astype(np.int32)
    l = left.astype(np.int32)
    if mode == DC_IDX:
        dc = p[0, 0]
        p[0, 1:] = (t[2 : s + 1] + 3 * dc + 2) >> 2
        p[1:, 0] = (l[2 : s + 1] + 3 * dc + 2) >> 2
        p[0, 0] = (l[1] + 2 * dc + t[1] + 2) >> 2
    elif mode == VER_IDX:
        p[:, 0] = np.clip(t[1] + ((l[1 : s + 1] - l[0]) >> 1), 0, maxv)
    elif mode == HOR_IDX:
        p[0, :] = np.clip(l[1] + ((t[1 : s + 1] - t[0]) >> 1), 0, maxv)
    return p


def predict_block_np(top: np.ndarray, left: np.ndarray, mode: int, size: int,
                     is_luma: bool, bit_depth: int = 8,
                     strong_smoothing: bool = True) -> np.ndarray:
    """Full per-TB intra prediction incl. smoothing + post filters."""
    log2 = int(size).bit_length() - 1
    ft, fl = top, left
    if is_luma and filter_flag(mode, log2):
        strong = (
            log2 == 5 and strong_smoothing
            and bool(strong_smoothing_ok(top, left, bit_depth))
        )
        ft, fl = smooth_refs_np(top, left, bit_depth, strong=strong)
    pred = predict_np(ft, fl, mode, size, bit_depth)
    if is_luma and size < 32:
        pred = post_filter_np(pred, top, left, mode, bit_depth)
    return pred
