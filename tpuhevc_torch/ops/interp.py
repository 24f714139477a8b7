"""DCT-IF motion-compensated prediction of whole blocks (kernels K3 and
`b_pred`).

K3, twin of the `mc_blk` stage of `tpuhevc/codec/inter_batch.py:166` at
8 bits and of `tpuhevc.ops.interp.mc` at bit depth bd (8 or 10; the
scan's closure keeps the 8-bit shifts at 10 bits, and `mc` is the
standard's): per PU, the window at the integer part of the MV (`>>`
floors on signed MVs), clamped at the plane edge, filtered horizontally
(`>> (bd - 8)`) then vertically with the 8-tap luma (quarter-pel) or
4-tap chroma (eighth-pel) taps, `>> 6` (the 14-bit intermediate,
`mc14`), then `clip((x + 2^(13 - bd)) >> (14 - bd), 0, 2^bd - 1)`.

`b_pred`, twin of the prediction and the uni/bi arbitration of the B step
(`tpuhevc/codec/inter_b.py:196-222` luma, 225-232 chroma, over
`ops/interp.py:141-211` `mc`, `mc14`, `bi_average`): per 16x16 block,
both lists' predictions at the 14-bit scale, the two uni predictions and
their bi-average; for luma the float32 costs SSE + lam_full * (MV bits +
2) of the three and the winner `inter_dir` (bi where its cost is at most
both uni costs, else L0 where it is at most L1's, else L1); chroma takes
the luma `inter_dir`. Returns the chosen prediction. At bit depth bd (8
or 10) the predictions take `mc14`'s and `bi_average`'s shifts and clip
at bd, as the reference's step does; the SSEs are exact integers (at 10
bits above 2^24), each converted once to float32. `b_pred_yuv` is a B
picture's three planes in one launch, `b_pred` one plane.

`mc_blk_planes` is a P picture's CU classes, Y, U and V each, in one
launch, `mc_blk` one plane.

`*_plain` are the PyTorch versions; `mc_blk_planes`, `mc_blk`,
`b_pred_yuv` and `b_pred` launch the CUDA kernels
(`kernels/csrc/mc_blk.cu`, `kernels/csrc/b_pred.cu`) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_depth, check_tensor
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
         mvq: torch.Tensor, size: int, is_luma: bool,
         bit_depth: int = 8) -> torch.Tensor:
    """The prediction at the 14-bit intermediate scale (`mc14`): plane
    (H, W) of bit_depth samples, positions (N,), MVs (N, 2) int32 ->
    (N, S, S) int64. Luma MVs in quarter pels, chroma MVs in eighth pels
    of the chroma grid."""
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
    acc_h = acc_h >> (bit_depth - 8)
    return (acc_h.unfold(1, ntaps, 1) * tv[:, None, None, :]).sum(-1) >> 6


def bi_average(p0_14: torch.Tensor, p1_14: torch.Tensor,
               bit_depth: int = 8) -> torch.Tensor:
    """The default bi-prediction combine of two 14-bit predictions
    (`bi_average`): clip((a + b + 2^(14 - bd)) >> (15 - bd), 0,
    2^bd - 1) as int32."""
    sh = 15 - bit_depth
    return ((p0_14.long() + p1_14 + (1 << (sh - 1))) >> sh).clamp(
        0, (1 << bit_depth) - 1).int()


def uni_from14(p14: torch.Tensor, bit_depth: int = 8) -> torch.Tensor:
    """A 14-bit prediction rounded back to bit_depth bits (`mc`'s last
    step): clip((p + 2^(13 - bd)) >> (14 - bd), 0, 2^bd - 1) as int32."""
    sh = 14 - bit_depth
    return ((p14 + (1 << (sh - 1))) >> sh).clamp(
        0, (1 << bit_depth) - 1).int()


def mc_blk_plain(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                 mvq: torch.Tensor, size: int, is_luma: bool,
                 bit_depth: int = 8) -> torch.Tensor:
    """plane (H, W), positions (N,), MVs (N, 2) int32 -> (N, S, S) int32
    (`mc`: the 14-bit prediction rounded back to bit_depth bits)."""
    return uni_from14(mc14(plane, xs, ys, mvq, size, is_luma, bit_depth),
                      bit_depth)


def mc_blk_planes_plain(jobs, bit_depth: int = 8):
    """jobs: [(plane, xs, ys, mvq, size, is_luma)] -> [pred (N, S, S)
    int32], each job by `mc_blk_plain` at bit_depth."""
    return [mc_blk_plain(*job, bit_depth) for job in jobs]


def mc_blk_planes(jobs, bit_depth: int = 8):
    """K3 over up to 12 jobs (a P picture's CU classes, Y, U and V each) in
    one launch; the arguments and results of `mc_blk_planes_plain`, the
    predictions views of one buffer. CPU tensors take the plain version;
    CUDA tensors the kernel (samples of bit_depth 8 or 10, its variant for
    each; luma S = 8, 16 or 32, chroma S = 4, 8 or 16)."""
    check_depth("mc_blk", bit_depth)
    dev = jobs[0][0].device
    if dev.type == "cpu":
        return mc_blk_planes_plain(jobs, bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"mc_blk: unsupported device {dev}")
    if not 1 <= len(jobs) <= 12:
        raise ValueError(f"mc_blk: {len(jobs)} jobs (1 to 12)")
    sizes = []
    for plane, xs, ys, mvq, size, is_luma in jobs:
        check_tensor(plane, "plane", torch.int32, 2, dev)
        check_tensor(xs, "xs", torch.int32, 1, dev)
        check_tensor(ys, "ys", torch.int32, 1, dev)
        check_tensor(mvq, "mvq", torch.int32, 2, dev)
        n = xs.shape[0]
        if ys.shape[0] != n or tuple(mvq.shape) != (n, 2):
            raise ValueError("mc_blk: xs, ys, mvq disagree on N")
        if size not in ((8, 16, 32) if is_luma else (4, 8, 16)):
            raise ValueError(f"mc_blk: unsupported size {size} (luma "
                             f"{bool(is_luma)})")
        sizes.append(n * size * size)
    # one buffer for every prediction; each view starts on a whole 16-byte
    # vector (S * S is a multiple of 16 samples)
    arena = torch.empty((sum(sizes),), dtype=torch.int32, device=dev)
    outs = [v.view(job[1].shape[0], job[4], job[4])
            for v, job in zip(arena.split(sizes), jobs)]
    live = [(job, out) for job, out in zip(jobs, outs) if out.shape[0]]
    if not live:
        return outs
    # the largest PUs first: their blocks take longest
    live.sort(key=lambda jo: -jo[0][4])
    ptrs, ints = [], []
    for (plane, xs, ys, mvq, size, is_luma), out in live:
        ptrs += [plane.data_ptr(), xs.data_ptr(), ys.data_ptr(),
                 mvq.data_ptr(), out.data_ptr()]
        ints += [xs.shape[0], plane.shape[0], plane.shape[1], size,
                 int(bool(is_luma))]
    fn = kbuild.function("mc_blk", "tpuhevc_mc_blk",
                         [kbuild.I, kbuild.P, kbuild.P, kbuild.I, kbuild.P])
    err = fn(len(live), (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(ints))(*ints), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "mc_blk")
    LAUNCHES["mc_blk" if bit_depth == 8 else "mc_blk10"] += 1
    return outs


def mc_blk(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
           mvq: torch.Tensor, size: int, is_luma: bool,
           bit_depth: int = 8) -> torch.Tensor:
    """K3 on one plane: `mc_blk_planes` with one job."""
    return mc_blk_planes([(plane, xs, ys, mvq, size, is_luma)],
                         bit_depth)[0]


def _mv_rate(mvq: torch.Tensor) -> torch.Tensor:
    """The B step's MV bit proxy |mvx| + |mvy| floor-divided by 4, plus 4,
    as float32."""
    return (mvq.long().abs().sum(dim=1) // 4 + 4).float()


def b_pred_plain(cur, ref0: torch.Tensor, ref1: torch.Tensor,
                 xs: torch.Tensor, ys: torch.Tensor, mvq0: torch.Tensor,
                 mvq1: torch.Tensor, size: int, is_luma: bool,
                 lam_full: float = 0.0, inter_dir=None, bit_depth: int = 8):
    """-> (pred (N, S, S) int32, inter_dir (N,) int32). Luma (inter_dir
    None): cur (N, S, S) int32 and lam_full (a Python float, rounded once
    to float32 where it meets a tensor) decide inter_dir 1 (L0), 2 (L1) or
    3 (bi). Chroma: the luma inter_dir is given and cur is not read. The
    planes hold samples of bit_depth (8 or 10)."""
    check_depth("b_pred", bit_depth)
    p0 = mc14(ref0, xs, ys, mvq0, size, is_luma, bit_depth)
    p1 = mc14(ref1, xs, ys, mvq1, size, is_luma, bit_depth)
    pred0, pred1 = uni_from14(p0, bit_depth), uni_from14(p1, bit_depth)
    pred_bi = bi_average(p0, p1, bit_depth)
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


def b_pred_yuv_plain(cur: torch.Tensor, refs_y, refs_u, refs_v,
                     xs: torch.Tensor, ys: torch.Tensor, mvq0: torch.Tensor,
                     mvq1: torch.Tensor, lam_full: float,
                     bit_depth: int = 8):
    """A B picture's three planes: `b_pred_plain` on luma (16x16 blocks at
    xs, ys, deciding inter_dir), then on U and V (8x8 at xs // 2, ys // 2)
    with that inter_dir, at bit_depth. refs_*: (list 0, list 1) planes. ->
    (pred_y, inter_dir, pred_u, pred_v)."""
    pred_y, inter_dir = b_pred_plain(cur, *refs_y, xs, ys, mvq0, mvq1, 16,
                                     True, lam_full, bit_depth=bit_depth)
    cxs, cys = xs // 2, ys // 2
    pred_u, _ = b_pred_plain(None, *refs_u, cxs, cys, mvq0, mvq1, 8, False,
                             inter_dir=inter_dir, bit_depth=bit_depth)
    pred_v, _ = b_pred_plain(None, *refs_v, cxs, cys, mvq0, mvq1, 8, False,
                             inter_dir=inter_dir, bit_depth=bit_depth)
    return pred_y, inter_dir, pred_u, pred_v


def _b_pred_launch(n, cur, refs_y, refs_c, xs, ys, mvq0, mvq1, inter_dir,
                   lam_full, cshift, bit_depth):
    """One launch of kernel `b_pred` (its variant of bit_depth) over n
    16x16 blocks: luma (refs_y not None: cur decides inter_dir) and the
    chroma planes of refs_c (a list of (list 0, list 1) planes; their
    blocks at xs, ys >> cshift, from the lists inter_dir uses). Returns
    (pred_y or None, [pred_c])."""
    dev = xs.device
    for t_, name in ((xs, "xs"), (ys, "ys"), (inter_dir, "inter_dir")):
        check_tensor(t_, name, torch.int32, 1, dev)
    for t_, name in ((mvq0, "mvq0"), (mvq1, "mvq1")):
        check_tensor(t_, name, torch.int32, 2, dev)
        if tuple(t_.shape) != (n, 2) or t_.data_ptr() % 8:
            raise ValueError(f"b_pred: {name} {tuple(t_.shape)}, 8-byte "
                             "aligned (n, 2) wanted")
    if ys.shape[0] != n or inter_dir.shape[0] != n:
        raise ValueError("b_pred: xs, ys, inter_dir disagree on n")
    shape_y = shape_c = (0, 0)
    pred_y = None
    if refs_y is not None:
        check_tensor(cur, "cur", torch.int32, 3, dev)
        if tuple(cur.shape) != (n, 16, 16):
            raise ValueError(f"b_pred: cur {tuple(cur.shape)}")
        for t_ in refs_y:
            check_tensor(t_, "luma reference", torch.int32, 2, dev)
        shape_y = tuple(refs_y[0].shape)
        if tuple(refs_y[1].shape) != shape_y:
            raise ValueError("b_pred: the luma references differ in shape")
        pred_y = torch.empty((n, 16, 16), dtype=torch.int32, device=dev)
    for pair in refs_c:
        for t_ in pair:
            check_tensor(t_, "chroma reference", torch.int32, 2, dev)
            if tuple(t_.shape) != tuple(refs_c[0][0].shape):
                raise ValueError("b_pred: the chroma references differ in "
                                 "shape")
        shape_c = tuple(refs_c[0][0].shape)
    preds_c = [torch.empty((n, 8, 8), dtype=torch.int32, device=dev)
               for _ in refs_c]
    planes = list(refs_y or (None, None))
    for k in range(2):
        planes += list(refs_c[k]) if k < len(refs_c) else [None, None]
    outs = [pred_y] + preds_c + [None] * (2 - len(preds_c))
    ptrs = (ctypes.c_void_p * 15)(*[
        None if t_ is None else t_.data_ptr()
        for t_ in [cur if refs_y is not None else None] + planes + outs
        + [xs, ys, mvq0, mvq1, inter_dir]])
    ints = (ctypes.c_int * 8)(n, *shape_y, *shape_c, int(refs_y is not None),
                              len(refs_c), cshift)
    fn = kbuild.function("b_pred", "tpuhevc_b_pred",
                         [kbuild.P, kbuild.P, ctypes.c_float, kbuild.I,
                          kbuild.P])
    err = fn(ptrs, ints, float(np.float32(lam_full)), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "b_pred")
    LAUNCHES["b_pred" if bit_depth == 8 else "b_pred10"] += 1
    return pred_y, preds_c


def b_pred_yuv(cur: torch.Tensor, refs_y, refs_u, refs_v, xs: torch.Tensor,
               ys: torch.Tensor, mvq0: torch.Tensor, mvq1: torch.Tensor,
               lam_full: float, bit_depth: int = 8):
    """Kernel `b_pred` over a B picture's three planes in one launch (the
    arguments and results of `b_pred_yuv_plain`). CPU tensors take the
    plain version; CUDA tensors the kernel (its 8-bit variant, or at
    bit_depth 10 `b_pred10`)."""
    check_depth("b_pred", bit_depth)
    if xs.device.type == "cpu":
        return b_pred_yuv_plain(cur, refs_y, refs_u, refs_v, xs, ys, mvq0,
                                mvq1, lam_full, bit_depth)
    if xs.device.type != "cuda":
        raise ValueError(f"b_pred: unsupported device {xs.device}")
    n = xs.shape[0]
    inter_dir = torch.empty((n,), dtype=torch.int32, device=xs.device)
    if n == 0:
        e = torch.empty((0, 8, 8), dtype=torch.int32, device=xs.device)
        return (torch.empty((0, 16, 16), dtype=torch.int32, device=xs.device),
                inter_dir, e, e.clone())
    pred_y, (pred_u, pred_v) = _b_pred_launch(
        n, cur, tuple(refs_y), [tuple(refs_u), tuple(refs_v)], xs, ys, mvq0,
        mvq1, inter_dir, lam_full, 1, bit_depth)
    return pred_y, inter_dir, pred_u, pred_v


def b_pred(cur, ref0: torch.Tensor, ref1: torch.Tensor, xs: torch.Tensor,
           ys: torch.Tensor, mvq0: torch.Tensor, mvq1: torch.Tensor,
           size: int, is_luma: bool, lam_full: float = 0.0, inter_dir=None,
           bit_depth: int = 8):
    """Kernel `b_pred` on one plane (the arguments and results of
    `b_pred_plain`). CPU tensors take the plain version; CUDA tensors the
    kernel (the variant of bit_depth), which takes the B step's two cases:
    16x16 luma deciding inter_dir, and 8x8 chroma (blocks at xs, ys) with
    inter_dir given."""
    check_depth("b_pred", bit_depth)
    if ref0.device.type == "cpu":
        return b_pred_plain(cur, ref0, ref1, xs, ys, mvq0, mvq1, size,
                            is_luma, lam_full, inter_dir, bit_depth)
    if ref0.device.type != "cuda":
        raise ValueError(f"b_pred: unsupported device {ref0.device}")
    decide = inter_dir is None
    if (size, is_luma, decide) not in ((16, True, True), (8, False, False)):
        raise ValueError(f"b_pred: the kernel takes 16x16 luma deciding "
                         f"inter_dir or 8x8 chroma given it, not size {size},"
                         f" luma {is_luma}, deciding {decide}")
    n = xs.shape[0]
    if decide:
        inter_dir = torch.empty((n,), dtype=torch.int32, device=ref0.device)
    if n == 0:
        return (torch.empty((0, size, size), dtype=torch.int32,
                            device=ref0.device), inter_dir)
    if is_luma:
        pred, _ = _b_pred_launch(n, cur, (ref0, ref1), [], xs, ys, mvq0,
                                 mvq1, inter_dir, lam_full, 0, bit_depth)
    else:
        _, (pred,) = _b_pred_launch(n, None, None, [(ref0, ref1)], xs, ys,
                                    mvq0, mvq1, inter_dir, 0.0, 0, bit_depth)
    return pred, inter_dir


def b_pred_taps(device) -> tuple[np.ndarray, np.ndarray]:
    """The taps compiled into kernel `b_pred`: (4, 8) luma, (8, 4) chroma
    int32, as the card holds them."""
    luma = np.zeros((4, 8), np.int32)
    chroma = np.zeros((8, 4), np.int32)
    fn = kbuild.function("b_pred", "tpuhevc_b_pred_taps", [kbuild.P] * 2)
    with torch.cuda.device(torch.device(device)):
        kbuild.check(fn(luma.ctypes.data_as(ctypes.c_void_p),
                        chroma.ctypes.data_as(ctypes.c_void_p)),
                     "b_pred taps")
    return luma, chroma


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
