"""DCT-IF motion-compensated prediction of whole blocks (kernels K3 and
`b_pred`).

K3, twin of the `mc_blk` stage of `tpuhevc/codec/inter_batch.py:166`
(8-bit; same semantics as `tpuhevc.ops.interp.mc`): per PU, the window at
the integer part of the MV (`>>` floors on signed MVs), clamped at the
plane edge, filtered horizontally then vertically with the 8-tap luma
(quarter-pel) or 4-tap chroma (eighth-pel) taps, `>> 6` (the 14-bit
intermediate, `mc14`), then `clip((x + 32) >> 6)`.

`b_pred`, twin of the prediction and the uni/bi arbitration of the B step
(`tpuhevc/codec/inter_b.py:196-222` luma, 225-232 chroma, over
`ops/interp.py:141-211` `mc`, `mc14`, `bi_average`): per 16x16 block,
both lists' predictions at the 14-bit scale, the two uni predictions and
their bi-average; for luma the float32 costs SSE + lam_full * (MV bits +
2) of the three and the winner `inter_dir` (bi where its cost is at most
both uni costs, else L0 where it is at most L1's, else L1); chroma takes
the luma `inter_dir`. Returns the chosen prediction.

`*_plain` are the PyTorch versions; `mc_blk` and `b_pred` launch the CUDA
kernels (`kernels/csrc/mc_blk.cu`, `kernels/csrc/b_pred.cu`) for CUDA
tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

# H.265 Table 8-12: luma taps per quarter-pel phase (identity at 0)
LUMA_TAPS = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [-1, 4, -10, 58, 17, -5, 1, 0],
        [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1],
    ],
    dtype=np.int32,
)

# H.265 Table 8-13: chroma taps per eighth-pel phase
CHROMA_TAPS = np.array(
    [
        [0, 64, 0, 0],
        [-2, 58, 10, -2],
        [-4, 54, 16, -2],
        [-6, 46, 28, -4],
        [-4, 36, 36, -4],
        [-4, 28, 46, -6],
        [-2, 16, 54, -4],
        [-2, 10, 58, -2],
    ],
    dtype=np.int32,
)

_TAPS: dict = {}


def taps(is_luma: bool, device, dtype=torch.int64) -> torch.Tensor:
    key = (is_luma, str(device), dtype)
    t = _TAPS.get(key)
    if t is None:
        t = torch.as_tensor(LUMA_TAPS if is_luma else CHROMA_TAPS,
                            dtype=dtype, device=device)
        _TAPS[key] = t
    return t


def mc14(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
         mvq: torch.Tensor, size: int, is_luma: bool) -> torch.Tensor:
    """The prediction at the 14-bit intermediate scale (`mc14`, 8-bit):
    plane (H, W), positions (N,), MVs (N, 2) int32 -> (N, S, S) int64.
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
    return (acc_h.unfold(1, ntaps, 1) * tv[:, None, None, :]).sum(-1) >> 6


def bi_average(p0_14: torch.Tensor, p1_14: torch.Tensor) -> torch.Tensor:
    """The default bi-prediction combine of two 14-bit predictions
    (`bi_average`, 8-bit): clip((a + b + 64) >> 7) as int32."""
    return ((p0_14.long() + p1_14 + 64) >> 7).clamp(0, 255).int()


def mc_blk_plain(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 mvq: torch.Tensor, size: int, is_luma: bool) -> torch.Tensor:
    """plane (H, W), positions (N,), MVs (N, 2) int32 -> (N, S, S) int32
    (`mc`: the 14-bit prediction rounded back to 8 bits)."""
    acc = mc14(plane, xs, ys, mvq, size, is_luma)
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


def _mv_rate(mvq: torch.Tensor) -> torch.Tensor:
    """The B step's MV bit proxy |mvx| + |mvy| floor-divided by 4, plus 4,
    as float32."""
    return (mvq.long().abs().sum(dim=1) // 4 + 4).float()


def b_pred_plain(cur, ref0: torch.Tensor, ref1: torch.Tensor,
                 xs: torch.Tensor, ys: torch.Tensor, mvq0: torch.Tensor,
                 mvq1: torch.Tensor, size: int, is_luma: bool,
                 lam_full: float = 0.0, inter_dir=None):
    """-> (pred (N, S, S) int32, inter_dir (N,) int32). Luma (inter_dir
    None): cur (N, S, S) int32 and lam_full (a Python float, rounded once
    to float32 where it meets a tensor) decide inter_dir 1 (L0), 2 (L1) or
    3 (bi). Chroma: the luma inter_dir is given and cur is not read."""
    p0 = mc14(ref0, xs, ys, mvq0, size, is_luma)
    p1 = mc14(ref1, xs, ys, mvq1, size, is_luma)
    pred0 = ((p0 + 32) >> 6).clamp(0, 255).int()
    pred1 = ((p1 + 32) >> 6).clamp(0, 255).int()
    pred_bi = bi_average(p0, p1)
    if inter_dir is None:
        n = cur.shape[0]

        def sse(p):
            d = cur - p
            return (d * d).reshape(n, -1).sum(dim=1).float()

        lam = torch.tensor(lam_full, dtype=torch.float32, device=cur.device)
        b0, b1 = _mv_rate(mvq0), _mv_rate(mvq1)
        cost0 = sse(pred0) + lam * (b0 + 2)
        cost1 = sse(pred1) + lam * (b1 + 2)
        cost_bi = sse(pred_bi) + lam * (b0 + b1 + 2)
        inter_dir = torch.where(
            cost_bi <= torch.minimum(cost0, cost1), 3,
            torch.where(cost0 <= cost1, 1, 2)).int()
    pd = inter_dir[:, None, None]
    pred = torch.where(pd == 1, pred0, torch.where(pd == 2, pred1, pred_bi))
    return pred, inter_dir


def b_pred(cur, ref0: torch.Tensor, ref1: torch.Tensor, xs: torch.Tensor,
           ys: torch.Tensor, mvq0: torch.Tensor, mvq1: torch.Tensor,
           size: int, is_luma: bool, lam_full: float = 0.0, inter_dir=None):
    """Kernel `b_pred`. CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if ref0.device.type == "cpu":
        return b_pred_plain(cur, ref0, ref1, xs, ys, mvq0, mvq1, size,
                            is_luma, lam_full, inter_dir)
    if ref0.device.type != "cuda":
        raise ValueError(f"b_pred: unsupported device {ref0.device}")
    dev = ref0.device
    check_tensor(ref0, "ref0", torch.int32, 2, dev)
    check_tensor(ref1, "ref1", torch.int32, 2, dev)
    for t_, name in ((xs, "xs"), (ys, "ys")):
        check_tensor(t_, name, torch.int32, 1, dev)
    check_tensor(mvq0, "mvq0", torch.int32, 2, dev)
    check_tensor(mvq1, "mvq1", torch.int32, 2, dev)
    n = xs.shape[0]
    if (tuple(ref1.shape) != tuple(ref0.shape) or ys.shape[0] != n
            or tuple(mvq0.shape) != (n, 2) or tuple(mvq1.shape) != (n, 2)
            or size not in (4, 8, 16, 32)):
        raise ValueError(f"b_pred: refs {tuple(ref0.shape)} / "
                         f"{tuple(ref1.shape)}, n {n}, size {size}")
    decide = inter_dir is None
    if decide:
        check_tensor(cur, "cur", torch.int32, 3, dev)
        if tuple(cur.shape) != (n, size, size):
            raise ValueError(f"b_pred: cur {tuple(cur.shape)}")
        inter_dir = torch.empty((n,), dtype=torch.int32, device=dev)
    else:
        check_tensor(inter_dir, "inter_dir", torch.int32, 1, dev)
        if inter_dir.shape[0] != n:
            raise ValueError(f"b_pred: inter_dir {tuple(inter_dir.shape)}")
    pred = torch.empty((n, size, size), dtype=torch.int32, device=dev)
    if n == 0:
        return pred, inter_dir
    tab = taps(is_luma, dev, torch.int32)
    fn = kbuild.function(
        "b_pred", "tpuhevc_b_pred",
        [kbuild.P] * 10 + [kbuild.I] * 6 + [ctypes.c_float, kbuild.P])
    err = fn(cur.data_ptr() if decide else None, ref0.data_ptr(),
             ref1.data_ptr(), xs.data_ptr(), ys.data_ptr(), mvq0.data_ptr(),
             mvq1.data_ptr(), tab.data_ptr(), pred.data_ptr(),
             inter_dir.data_ptr(), n,
             ref0.shape[0], ref0.shape[1], size, int(is_luma), int(decide),
             float(np.float32(lam_full)),
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "b_pred")
    LAUNCHES["b_pred"] += 1
    return pred, inter_dir


# --- numpy host MC (the decoder) ---------------------------------------------

def _gather_windows_np(plane, x0s, y0s, win):
    h, w = plane.shape
    n = len(x0s)
    out = np.empty((n, win, win), dtype=np.int32)
    ys = np.clip(y0s[:, None] + np.arange(win)[None, :], 0, h - 1)
    xs = np.clip(x0s[:, None] + np.arange(win)[None, :], 0, w - 1)
    for i in range(n):
        out[i] = plane[np.ix_(ys[i], xs[i])]
    return out


def mc_np(plane: np.ndarray, xs, ys, mvs_q: np.ndarray, size: int,
          is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    """Reference MC: (N,) block positions + (N, 2) MVs -> (N, S, S) pred.
    Luma MVs in quarter-pel, chroma MVs in eighth-pel of the chroma grid."""
    taps_tab = LUMA_TAPS if is_luma else CHROMA_TAPS
    ntaps = taps_tab.shape[1]
    off = 3 if is_luma else 1
    fmask = 3 if is_luma else 7
    fshift = 2 if is_luma else 3
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    mvs = np.asarray(mvs_q)
    ix = xs + (mvs[:, 0] >> fshift)
    iy = ys + (mvs[:, 1] >> fshift)
    fx = mvs[:, 0] & fmask
    fy = mvs[:, 1] & fmask
    win = size + ntaps - 1
    w = _gather_windows_np(plane, ix - off, iy - off, win).astype(np.int64)
    th = taps_tab[fx].astype(np.int64)  # (N, ntaps)
    tv = taps_tab[fy].astype(np.int64)
    # horizontal pass, truncated to the 14-bit intermediate scale
    # (shift1 = bd - 8, §8.5.3.3.3 / TComInterpolationFilter shifts)
    acc_h = np.zeros((len(xs), win, size), dtype=np.int64)
    for i in range(ntaps):
        acc_h += th[:, i, None, None] * w[:, :, i : i + size]
    acc_h >>= bit_depth - 8
    acc = np.zeros((len(xs), size, size), dtype=np.int64)
    for i in range(ntaps):
        acc += tv[:, i, None, None] * acc_h[:, i : i + size, :]
    acc >>= 6
    sh2 = 14 - bit_depth
    maxv = (1 << bit_depth) - 1
    return np.clip((acc + (1 << (sh2 - 1))) >> sh2, 0, maxv
                   ).astype(np.int32)


def mc_np14(plane: np.ndarray, xs, ys, mvs_q: np.ndarray, size: int,
            is_luma: bool, bit_depth: int = 8) -> np.ndarray:
    """MC at the 14-bit intermediate scale (§8.5.3.3.3: isLast=false),
    for bi-prediction averaging. Returns (N, S, S) int32 (14-bit range)."""
    taps_tab = LUMA_TAPS if is_luma else CHROMA_TAPS
    ntaps = taps_tab.shape[1]
    off = 3 if is_luma else 1
    fmask = 3 if is_luma else 7
    fshift = 2 if is_luma else 3
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    mvs = np.asarray(mvs_q)
    ix = xs + (mvs[:, 0] >> fshift)
    iy = ys + (mvs[:, 1] >> fshift)
    fx = mvs[:, 0] & fmask
    fy = mvs[:, 1] & fmask
    win = size + ntaps - 1
    w = _gather_windows_np(plane, ix - off, iy - off, win).astype(np.int64)
    th = taps_tab[fx].astype(np.int64)
    tv = taps_tab[fy].astype(np.int64)
    acc_h = np.zeros((len(xs), win, size), dtype=np.int64)
    for i in range(ntaps):
        acc_h += th[:, i, None, None] * w[:, :, i : i + size]
    acc_h >>= bit_depth - 8
    acc = np.zeros((len(xs), size, size), dtype=np.int64)
    for i in range(ntaps):
        acc += tv[:, i, None, None] * acc_h[:, i : i + size, :]
    return (acc >> 6).astype(np.int32)  # 14-bit scale


def bi_average_np(p0_14: np.ndarray, p1_14: np.ndarray,
                  bit_depth: int = 8) -> np.ndarray:
    """Default bi-prediction combine (§8.5.3.3.3.2): shift2 = 15 - bd."""
    shift = 15 - bit_depth
    off = 1 << (shift - 1)
    maxv = (1 << bit_depth) - 1
    return np.clip((p0_14.astype(np.int64) + p1_14 + off) >> shift,
                   0, maxv).astype(np.int32)
