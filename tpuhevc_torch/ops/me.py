"""Dense full-pel motion search with the NN-FME SAD surface (kernels K1
and `b_me`).

K1, twin of the `sad_search` stage of `tpuhevc/codec/inter_batch.py:139`
and, with `subsample=False`, of `integer_me` (`tpuhevc/ops/me.py:123-157`,
the per-frame P stage's search): for each PU, the SAD of every
(2sr+1)^2 full-pel offset over its clipped search window (with
`subsample`, rows subsampled 2:1 and the sum shifted <<1 for PUs taller
than 8, the LD-P scan's FEN setting), plus the rate term
(mv_bits * lam_me) >> 8; the argmin over the inner (2sr-1)^2 square
(first index wins, row-major), and the 3x3 raw-SAD surface around it.

`b_me`, twin of `dense_me` in the B step (`tpuhevc/codec/inter_b.py:
142-163`): for every 16x16 block of a picture and for both reference
lists, the SAD at every offset of the edge-padded reference, the float32
cost sad + lam_me * mvb with the B step's MV bit model, the first-index
argmin over the WHOLE window, and the 3x3 surface read at flat indices
clipped to the window (at its left or right edge a neighbour wraps into
the adjacent row, as in the reference).

`sad_search_classes` searches a P picture's CU classes in one launch,
reading each PU's clamped window from the reference plane itself;
`sad_search` is its one-class case. Their callers, and `b_me`'s, name
the samples' bit depth (8 or 10) explicitly: each kernel has a variant
for each (K1's 8-bit samples packed four to a word, 10-bit ones a block a
PU; `b_me`'s four or two to a word), and the data never chooses one. `*_plain` are the PyTorch versions
(`sad_search_plain` takes the gathered windows); `sad_search_classes` and
`b_me` launch the CUDA kernels (`kernels/csrc/sad_search.cu`,
`kernels/csrc/b_me.cu`) for CUDA tensors.

The host numpy search at the end (`integer_me_np`, `sad_surface_np`,
`fracdif_refine_np`; copies of `tpuhevc/ops/me.py:31-121`) labels the
NN-FME training set (`models/fme_data.py:extract`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_depth, check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild


def mv_bits_table(sr: int) -> np.ndarray:
    """(2R+1, 2R+1) Exp-Golomb-ish bit cost of each full-pel offset vs a
    zero predictor (quarter-pel mvd => |v*4|), mirroring TComRdCost's
    getCostOfVectorWithPredictor bit model."""
    d = np.arange(-sr, sr + 1)
    bits1 = 2 * np.ceil(np.log2(2 * np.abs(4 * d) + 1)).astype(np.int64) + 1
    return bits1[:, None] + bits1[None, :]


def bits_table(sr: int, device) -> torch.Tensor:
    """(2sr+1, 2sr+1) int32 MV bit cost (`mv_bits_table`) on `device`."""
    return torch.as_tensor(mv_bits_table(sr), dtype=torch.int32, device=device)


def _sad_map(wnd: torch.Tensor, cur: torch.Tensor, sub: int) -> torch.Tensor:
    """wnd (N, S+2sr, S+2sr), cur (N, S, S) -> (N, 2sr+1, 2sr+1) int32 SADs
    (rows 0, 2, 4, ... and the sum << 1 when sub is 1)."""
    size = cur.shape[1]
    m = wnd.shape[1] - size + 1
    c = cur[:, :: 1 << sub, :].long()
    rows_sad = []
    for dy in range(m):
        rows = wnd[:, dy : dy + size : 1 << sub, :].long()  # (N, r, win)
        sl = rows.unfold(2, size, 1)  # (N, r, m, size)
        rows_sad.append((sl - c[:, :, None, :]).abs().sum(dim=(1, 3)))
    return (torch.stack(rows_sad, dim=1) << sub).int()


def sad_search_plain(wnd: torch.Tensor, cur: torch.Tensor, bits: torch.Tensor,
                     lam_me: int, sr: int, subsample: bool = True):
    """wnd (N, S+2sr, S+2sr), cur (N, S, S) int32 -> (mv (N,2), sad9 (N,9)).
    subsample: the FEN row rule (2:1 rows for S > 8); False searches every
    row."""
    n, size = cur.shape[0], cur.shape[1]
    m = 2 * sr + 1
    sad = _sad_map(wnd, cur, 1 if subsample and size > 8 else 0)
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


def window_index(xs: torch.Tensor, ys: torch.Tensor, size: int, sr: int,
                 h: int, w: int) -> torch.Tensor:
    """(N, S+2sr, S+2sr) flat indices into an h x w plane of the PUs'
    search windows, rows and columns clamped to the plane (`_win_idx` of
    tpuhevc/codec/inter_batch.py:67-77)."""
    ar = torch.arange(size + 2 * sr, device=xs.device)
    yy = (ys.long()[:, None] - sr + ar).clamp(0, h - 1)
    xx = (xs.long()[:, None] - sr + ar).clamp(0, w - 1)
    return yy[:, :, None] * w + xx[:, None, :]


def sad_search_classes_plain(ref_y: torch.Tensor, classes, bits: torch.Tensor,
                             lam_me: int, sr: int, subsample: bool = True,
                             bit_depth: int = 8):
    """ref_y (H, W) int32; classes: [(cur (N, S, S) int32, xs, ys (N,))]
    -> [(mv (N, 2), sad9 (N, 9))], each class's windows gathered as
    `window_index` gives them and searched by `sad_search_plain`. The sums
    are the same at either bit depth (8 or 10)."""
    check_depth("sad_search", bit_depth)
    h, w = ref_y.shape
    flat = ref_y.reshape(-1)
    return [sad_search_plain(
        flat[window_index(xs, ys, cur.shape[1], sr, h, w)], cur, bits,
        lam_me, sr, subsample) for cur, xs, ys in classes]


def sad_search_classes(ref_y: torch.Tensor, classes, bits: torch.Tensor,
                       lam_me: int, sr: int, subsample: bool = True, *,
                       bit_depth: int):
    """K1 over a P picture's CU classes in one launch; the arguments and
    results of `sad_search_classes_plain`. CPU tensors take the plain
    version; CUDA tensors the kernel, which reads the windows from ref_y
    itself and takes S = 8, 16 or 32 and sr 1..16: its 8-bit variant
    (samples 0..255 in the int32 planes, packed four to a word on the
    card) or its 10-bit one (samples 0..1023), as `bit_depth` says."""
    check_depth("sad_search", bit_depth)
    if ref_y.device.type == "cpu":
        return sad_search_classes_plain(ref_y, classes, bits, lam_me, sr,
                                        subsample, bit_depth)
    if ref_y.device.type != "cuda":
        raise ValueError(f"sad_search: unsupported device {ref_y.device}")
    dev = ref_y.device
    check_tensor(ref_y, "ref_y", torch.int32, 2, dev)
    check_tensor(bits, "bits", torch.int32, 2, dev)
    m = 2 * sr + 1
    if tuple(bits.shape) != (m, m) or not 1 <= sr <= 16:
        raise ValueError(f"sad_search: sr={sr}, bits {tuple(bits.shape)}")
    if not 1 <= len(classes) <= 4:
        raise ValueError(f"sad_search: {len(classes)} classes (1 to 4)")
    outs, live = [], []
    for cur, xs, ys in classes:
        check_tensor(cur, "cur", torch.int32, 3, dev)
        check_tensor(xs, "xs", torch.int32, 1, dev)
        check_tensor(ys, "ys", torch.int32, 1, dev)
        n, size = cur.shape[0], cur.shape[1]
        if (size not in (8, 16, 32) or cur.shape[2] != size
                or xs.shape[0] != n or ys.shape[0] != n):
            raise ValueError(f"sad_search: cur {tuple(cur.shape)}, xs "
                             f"{tuple(xs.shape)}, ys {tuple(ys.shape)}")
        if cur.data_ptr() % 16:
            raise ValueError("sad_search: cur must be 16-byte aligned")
        mv = torch.empty((n, 2), dtype=torch.int32, device=dev)
        sad9 = torch.empty((n, 9), dtype=torch.int32, device=dev)
        outs.append((mv, sad9))
        if n:
            live.append((cur, xs, ys, mv, sad9))
    if not live:
        return outs
    # the largest PUs first: a 32x32 PU's cluster starts the launch
    live.sort(key=lambda c: -c[0].shape[1])
    ptrs = [t_.data_ptr() for c in live for t_ in c]
    ints = [v for c in live for v in (c[0].shape[0], c[0].shape[1])]
    fn = kbuild.function("sad_search", "tpuhevc_sad_search",
                         [kbuild.I, kbuild.P, kbuild.P, kbuild.P, kbuild.I,
                          kbuild.I, kbuild.P] + [kbuild.I] * 4 + [kbuild.P])
    h, w = ref_y.shape
    err = fn(len(live), (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(ints))(*ints), ref_y.data_ptr(), h, w,
             bits.data_ptr(), sr, int(lam_me), int(subsample), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "sad_search")
    LAUNCHES["sad_search" if bit_depth == 8 else "sad_search10"] += 1
    return outs


def sad_search(ref_y: torch.Tensor, cur: torch.Tensor, xs: torch.Tensor,
               ys: torch.Tensor, bits: torch.Tensor, lam_me: int, sr: int,
               subsample: bool = True, *, bit_depth: int):
    """K1 on one class: `sad_search_classes` with one (cur, xs, ys)."""
    return sad_search_classes(ref_y, [(cur, xs, ys)], bits, lam_me, sr,
                              subsample, bit_depth=bit_depth)[0]


# --- the B step's two-list search ----------------------------------------------

B_BLK = 16  # the B step codes 16x16 CUs

_B_TABLES: dict = {}


def b_mv_bits(sr: int) -> np.ndarray:
    """(side*side,) float32 MV bits per flat offset of the B step's search
    (`inter_b.py:116-120`): 2 ceil(log2(2 |4 dx| + 1)) + 2 ceil(log2(
    2 |4 dy| + 1)) + 2, row-major over (dy, dx)."""
    side = 2 * sr + 1
    dxs = np.tile(np.arange(side) - sr, side)
    dys = np.repeat(np.arange(side) - sr, side)
    return (2 * np.ceil(np.log2(2.0 * np.abs(dxs * 4) + 1))
            + 2 * np.ceil(np.log2(2.0 * np.abs(dys * 4) + 1))
            + 2).astype(np.float32)


def _b_tables(h: int, w: int, sr: int, device) -> dict:
    """Gather tables of the 16x16 grid (raster order) of an h x w picture:
    the blocks, their edge-clamped search windows, the MV bit model."""
    key = (h, w, sr, str(device))
    t = _B_TABLES.get(key)
    if t is None:
        n_w = w // B_BLK
        n = (h // B_BLK) * n_w
        blk = torch.arange(n, device=device)
        ys = (blk // n_w) * B_BLK
        xs = (blk % n_w) * B_BLK
        ar = torch.arange(B_BLK, device=device)
        t = dict(
            blk=((ys[:, None] + ar)[:, :, None] * w
                 + (xs[:, None] + ar)[:, None, :]),
            win=window_index(xs, ys, B_BLK, sr, h, w),
            mvb=torch.as_tensor(b_mv_bits(sr), device=device))
        _B_TABLES[key] = t
    return t


def b_me_plain(org: torch.Tensor, ref0: torch.Tensor, ref1: torch.Tensor,
               lam_me: float, sr: int, bit_depth: int = 8):
    """org, ref0, ref1 (H, W) int32 planes, H and W multiples of 16 ->
    (mv (2, N, 2), sad9 (2, N, 9)) int32 for the N 16x16 blocks in raster
    order, list 0 then list 1. lam_me is a Python float, rounded once to
    float32 where it meets the bit table (JAX's weak type). The sums are
    the same at either bit depth (8 or 10): a 16x16 SAD at 10 bits is at
    most 261,888, so its float32 cost is exact."""
    check_depth("b_me", bit_depth)
    h, w = org.shape
    t = _b_tables(h, w, sr, org.device)
    side = 2 * sr + 1
    cur = org.reshape(-1)[t["blk"]]
    rate = torch.tensor(lam_me, dtype=torch.float32,
                        device=org.device) * t["mvb"]
    nbr9 = torch.tensor([dy * side + dx for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1)], device=org.device)
    mvs, sad9s = [], []
    for ref in (ref0, ref1):
        sad = _sad_map(ref.reshape(-1)[t["win"]], cur, 0).reshape(
            cur.shape[0], -1)
        bi = torch.argmin(sad.float() + rate[None], dim=1)
        mvs.append(torch.stack([bi % side - sr, bi // side - sr], -1).int())
        i9 = (bi[:, None] + nbr9[None]).clamp(0, side * side - 1)
        sad9s.append(sad.gather(1, i9))
    return torch.stack(mvs), torch.stack(sad9s)


def b_me(org: torch.Tensor, ref0: torch.Tensor, ref1: torch.Tensor,
         lam_me: float, sr: int, *, bit_depth: int):
    """Kernel `b_me`. CPU tensors take the plain version; CUDA tensors the
    kernel: its 8-bit variant (samples 0..255 in the int32 planes, packed
    four to a word on the card) or its 10-bit one (`b_me10`: samples
    0..1023, two to a word), as the caller's `bit_depth` says; any other
    depth raises on either device."""
    check_depth("b_me", bit_depth)
    if org.device.type == "cpu":
        return b_me_plain(org, ref0, ref1, lam_me, sr, bit_depth)
    if org.device.type != "cuda":
        raise ValueError(f"b_me: unsupported device {org.device}")
    dev = org.device
    for t_, name in ((org, "org"), (ref0, "ref0"), (ref1, "ref1")):
        check_tensor(t_, name, torch.int32, 2, dev)
    h, w = org.shape
    if (tuple(ref0.shape) != (h, w) or tuple(ref1.shape) != (h, w)
            or h % B_BLK or w % B_BLK or not 1 <= sr <= 16):
        raise ValueError(f"b_me: planes {tuple(org.shape)}, "
                         f"{tuple(ref0.shape)}, {tuple(ref1.shape)}, sr={sr}")
    n = (h // B_BLK) * (w // B_BLK)
    mv = torch.empty((2, n, 2), dtype=torch.int32, device=dev)
    sad9 = torch.empty((2, n, 9), dtype=torch.int32, device=dev)
    if n == 0:
        return mv, sad9
    mvb = _b_tables(h, w, sr, dev)["mvb"]
    fn = kbuild.function("b_me", "tpuhevc_b_me",
                         [kbuild.P] * 6 + [kbuild.I] * 3
                         + [ctypes.c_float, kbuild.I, kbuild.P])
    err = fn(org.data_ptr(), ref0.data_ptr(), ref1.data_ptr(), mvb.data_ptr(),
             mv.data_ptr(), sad9.data_ptr(), h, w, sr,
             float(np.float32(lam_me)), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "b_me")
    LAUNCHES["b_me" if bit_depth == 8 else "b_me10"] += 1
    return mv, sad9


# --- the host search of the NN-FME dataset extraction --------------------------


def _windows_np(plane, xs, ys, size, sr):
    h, w = plane.shape
    win = size + 2 * sr
    n = len(xs)
    out = np.empty((n, win, win), dtype=np.int32)
    for i in range(n):
        yy = np.clip(ys[i] - sr + np.arange(win), 0, h - 1)
        xx = np.clip(xs[i] - sr + np.arange(win), 0, w - 1)
        out[i] = plane[np.ix_(yy, xx)]
    return out


def integer_me_np(ref, cur, xs, ys, sr, lambda_fp256: int):
    """ref (H,W), cur (N,S,S), positions (N,). Returns
    (mv_full (N,2), sad_map (N, 2R+1, 2R+1), best_idx (N,2)); the argmin
    over the map's interior (first index wins), so the 3x3 surface exists."""
    n, s, _ = cur.shape
    wnd = _windows_np(ref, xs, ys, s, sr)
    m = 2 * sr + 1
    sad = np.empty((n, m, m), dtype=np.int64)
    c = cur.astype(np.int32)
    for dy in range(m):
        for dx in range(m):
            sad[:, dy, dx] = (
                np.abs(wnd[:, dy : dy + s, dx : dx + s] - c).sum(axis=(1, 2))
            )
    cost = sad + (mv_bits_table(sr)[None] * lambda_fp256 >> 8)
    inner = cost[:, 1 : m - 1, 1 : m - 1].reshape(n, -1)
    bi = np.argmin(inner, axis=1)
    by = bi // (m - 2) + 1
    bx = bi % (m - 2) + 1
    mv = np.stack([bx - sr, by - sr], axis=-1).astype(np.int32)
    return mv, sad, np.stack([bx, by], axis=-1)


def sad_surface_np(sad_map, best_idx):
    """(N, 9) [TL,T,TR,L,C,R,BL,B,BR] raw SADs around the winner."""
    n = sad_map.shape[0]
    out = np.empty((n, 9), dtype=np.int64)
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out[:, k] = sad_map[np.arange(n), best_idx[:, 1] + dy,
                                best_idx[:, 0] + dx]
            k += 1
    return out


def fracdif_refine_np(ref, cur, xs, ys, mv_int, lambda_fp256: int = 0,
                      bit_depth: int = 8):
    """DCT-IF fractional refinement (xPatternSearchFracDIF,
    TEncSearch.cpp:5232): the 9-point half-pel SATD search around the
    integer MV, then the 9-point quarter-pel one around the best half-pel;
    the ground-truth labeller of the NN-FME training set.

    cur: (N, S, S); mv_int: (N, 2) full-pel. Returns (N, 2) quarter-pel.
    """
    from .cost import satd_np
    from .interp import mc_np

    n, s, _ = cur.shape
    # HM s_acMvRefineH/Q visit order (ties resolve to earlier entries)
    offs = np.array([(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
                     (-1, -1), (1, -1), (-1, 1), (1, 1)], np.int32)
    bs = 8 if s >= 8 else 4  # SATD over 8x8 subblocks (4x4 for tiny PUs)

    def satd_pu(pred):
        a = cur.reshape(n, s // bs, bs, s // bs, bs).transpose(0, 1, 3, 2, 4)
        b = pred.reshape(n, s // bs, bs, s // bs, bs).transpose(0, 1, 3, 2, 4)
        return satd_np(a, b).reshape(n, -1).sum(axis=1)

    mvq = mv_int.astype(np.int32) * 4
    for step in (2, 1):
        costs = np.empty((9, n), np.int64)
        for k, (dx, dy) in enumerate(offs):
            cand = mvq + np.array([dx * step, dy * step], np.int32)
            pred = mc_np(ref, xs, ys, cand, s, True, bit_depth)
            bits = (_mv_bits(cand[:, 0]) + _mv_bits(cand[:, 1]))
            costs[k] = satd_pu(pred) + ((bits * lambda_fp256) >> 8)
        best = np.argmin(costs, axis=0)
        mvq = mvq + offs[best] * step
    return mvq


def _mv_bits(v):
    return (2 * np.ceil(np.log2(2 * np.abs(v).astype(np.int64) + 1))
            .astype(np.int64) + 1)
