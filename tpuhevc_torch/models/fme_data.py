"""NN-FME training data: the dataset extraction and its CSV files.

Copies of `extract` and the CSV writer of `tools/extract_fme_dataset.py`
(31-70, 97-102) and of the CSV reader `load_csv` of `tools/train_fme.py`
(25-31): for every 16x16 block of every P picture, the 3x3 integer-pel
SAD surface [TL,T,TR,L,C,R,BL,B,BR] around the full-pel winner, the PU
size, and the label class of the DCT-IF fractional search (class =
(qy+3)*7 + (qx+3)), the reference's extraction hooks
(TEncSearch.cpp:4561-4582). The search is the host numpy one of
`ops/me.py`; the columns are `TL,...,BR,Width,Height,label`, so a CSV
written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..ops.me import fracdif_refine_np, integer_me_np, sad_surface_np
from ..utils.tables import qp_to_lambda

CSV_HEADER = "TL,T,TR,L,C,R,BL,B,BR,Width,Height,label"


def extract(frames, qp: int, sr: int = 16):
    """frames: list of (y, u, v) uint8. Returns (sads9 (N,9), dims (N,2),
    labels (N,)): each picture searched against the previous original."""
    lam = int(round(np.sqrt(qp_to_lambda(qp, 0.4624)) * 256))
    rows_s, rows_d, rows_l = [], [], []
    for i in range(1, len(frames)):
        cur_y = frames[i][0].astype(np.int32)
        ref_y = frames[i - 1][0].astype(np.int32)
        h, w = cur_y.shape
        xs, ys = [], []
        for y0 in range(0, h - 15, 16):
            for x0 in range(0, w - 15, 16):
                xs.append(x0)
                ys.append(y0)
        xs = np.array(xs)
        ys = np.array(ys)
        cur = np.stack([cur_y[y : y + 16, x : x + 16]
                        for x, y in zip(xs, ys)])
        mv_int, sad_map, best = integer_me_np(ref_y, cur, xs, ys, sr, lam)
        sad9 = sad_surface_np(sad_map, best)
        mvq = fracdif_refine_np(ref_y, cur, xs, ys, mv_int, lam)
        off = np.clip(mvq - mv_int * 4, -3, 3)
        label = (off[:, 1] + 3) * 7 + (off[:, 0] + 3)
        rows_s.append(sad9)
        rows_d.append(np.full((len(xs), 2), 16))
        rows_l.append(label)
    return (np.concatenate(rows_s), np.concatenate(rows_d),
            np.concatenate(rows_l))


def split_frames(raw: bytes, w: int, h: int) -> list:
    """The (y, u, v) uint8 planes of each whole 4:2:0 picture in `raw`."""
    fsz = w * h * 3 // 2
    frames = []
    for i in range(len(raw) // fsz):
        b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], np.uint8)
        frames.append((b[: w * h].reshape(h, w),
                       b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                       b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))
    return frames


def write_csv(path: str, sads, dims, labels) -> None:
    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for s, d, lab in zip(sads, dims, labels):
            f.write(",".join(str(int(x)) for x in s)
                    + f",{d[0]},{d[1]},{lab}\n")


def load_csv(path: str):
    """-> (sads (N,9) float32, heights (N,), widths (N,), labels (N,))."""
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64)
    sads = rows[:, :9].astype(np.float32)
    widths = rows[:, 9].astype(np.int32)
    heights = rows[:, 10].astype(np.int32)
    labels = rows[:, 11].astype(np.int32)
    return sads, heights, widths, labels
