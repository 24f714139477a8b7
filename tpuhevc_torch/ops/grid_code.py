"""The grid step's residual coding of one TU size (kernel `grid_code`).

Twin of `_txq_luma` and the `_txq_chroma` closure of `class_code`
(`tpuhevc/codec/inter_grid.py:1718-1750,1822-1851`), with the plane
transforms of :342-383 and the flat quantiser (no RDOQ, no sign hiding,
8-bit): over an (h, w) plane tiled into T x T TUs (T in 4..32),

  r = orig - pred; c = forward DCT (rows then columns, as `fwd_tx`);
  lvl = clip(sign(c) ((|c| scale + (85 << (qbits - 9))) >> qbits), +-lim),
        lim = 127 when the frame's levels are packed as int8, else 32767;
  rec = nz ? clip(pred + IDCT(dequant(lvl)), 0, 255) : pred;
  d_skip, d_coded = the TU's SSE of orig - pred and orig - rec (int32
        sums, then float32);
  bits = the table bit estimate of lvl (`entropy.bitest.tu_bits` with the
        estimator's live tables);
  drop = d_skip + lam cbf0 <= d_coded + lam (bits + cbf1), float32 with
        every product rounded on its own;
  dropped TUs: lvl 0, rec = pred, d = d_skip, b = cbf0, cbf count 0;
        else d = d_coded, b = bits + cbf1, cbf count = nonzero levels.

Chroma runs the same function over the packed [U | V] plane at the
chroma QP with the chroma lambda, estimator and cbf bits. `grid_code_plain`
is the PyTorch version; `grid_code` launches `kernels/csrc/grid_code.cu`
for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_tensor
from ..entropy.bitest import EstTables, tu_bits_plain
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import dct_matrix
from .intra import blocks, unblocks
from .transforms import (dequant_params, forward_transform, inverse_transform,
                         quant_params)


def up(p: torch.Tensor, t: int) -> torch.Tensor:
    """Repeat each entry of the last two dims t x t times."""
    return p.repeat_interleave(t, -2).repeat_interleave(t, -1)


def grid_code_plain(orig: torch.Tensor, pred: torch.Tensor, T: int, qp: int,
                    lam: float, est: EstTables, cbf0: float, cbf1: float,
                    lvl8: bool):
    """orig, pred (h, w) int32 -> (lvl, rec (h, w) int32; d, bits
    (h/T, w/T) float32; cbf (h/T, w/T) int32; d_skip float32)."""
    h, w = orig.shape
    log2 = T.bit_length() - 1
    scale, add, qbits = quant_params(qp, log2, 8, False)
    lim = 127 if lvl8 else 32767
    g = (h // T, w // T)
    c = forward_transform(blocks(orig - pred, T, *g)).long()
    lv = (torch.sign(c) * ((c.abs() * scale + add) >> qbits)).clamp(
        -lim, lim)
    dqs, dqsh = dequant_params(qp, log2, 8)
    x = lv * dqs
    dq = ((x + (1 << (dqsh - 1))) >> dqsh if dqsh > 0 else x << -dqsh)
    rsd = inverse_transform(dq.clamp(-32768, 32767).int())
    pt = blocks(pred, T, *g)
    ot = blocks(orig, T, *g)
    nz = (lv != 0).sum(dim=(1, 2)).int()
    rec = torch.where(nz[:, None, None] > 0, (pt + rsd).clamp(0, 255), pt)
    d_skip = ((ot - pt) ** 2).sum(dim=(1, 2)).int().float()
    d_coded = ((ot - rec) ** 2).sum(dim=(1, 2)).int().float()
    lvt = lv.int()
    bits = tu_bits_plain(est, lvt)
    lam32 = torch.tensor(lam, dtype=torch.float32)
    c0 = torch.tensor(cbf0, dtype=torch.float32)
    c1 = torch.tensor(cbf1, dtype=torch.float32)
    drop = d_skip + lam32 * c0 <= d_coded + lam32 * (bits + c1)
    lvt = torch.where(drop[:, None, None], 0, lvt)
    rec = torch.where(drop[:, None, None], pt, rec)
    d = torch.where(drop, d_skip, d_coded)
    b = torch.where(drop, c0, bits + c1)
    cbf = torch.where(drop, 0, nz)
    return (unblocks(lvt, *g), unblocks(rec, *g), d.reshape(g),
            b.reshape(g), cbf.reshape(g), d_skip.reshape(g))


_DCT32: dict = {}


def _init(dev: torch.device) -> None:
    if dev.index in _DCT32:
        return
    t = np.ascontiguousarray(dct_matrix(32), dtype=np.int32)
    fn = kbuild.function("grid_code", "tpuhevc_grid_code_init", [kbuild.P])
    kbuild.check(fn(t.ctypes.data), "grid_code init")
    _DCT32[dev.index] = True


def grid_code(orig: torch.Tensor, pred: torch.Tensor, T: int, qp: int,
              lam: float, est: EstTables, cbf0: float, cbf1: float,
              lvl8: bool):
    """Kernel `grid_code`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if orig.device.type == "cpu":
        return grid_code_plain(orig, pred, T, qp, lam, est, cbf0, cbf1, lvl8)
    if orig.device.type != "cuda":
        raise ValueError(f"grid_code: unsupported device {orig.device}")
    dev = orig.device
    check_tensor(orig, "orig", torch.int32, 2, dev)
    check_tensor(pred, "pred", torch.int32, 2, dev)
    check_tensor(est.itab, "est.itab", torch.int32, 1, dev)
    check_tensor(est.ftab, "est.ftab", torch.float32, 1, dev)
    h, w = orig.shape
    log2 = T.bit_length() - 1
    if pred.shape != orig.shape or h % T or w % T or est.S != T or not (
            2 <= log2 <= 5):
        raise ValueError(f"grid_code: planes {tuple(orig.shape)}, "
                         f"{tuple(pred.shape)}, T {T}, estimator {est.S}")
    _init(dev)
    scale, add, qbits = quant_params(qp, log2, 8, False)
    dqs, dqsh = dequant_params(qp, log2, 8)
    g = (h // T, w // T)
    lvl = torch.empty_like(orig)
    rec = torch.empty_like(orig)
    d = torch.empty(g, dtype=torch.float32, device=dev)
    b = torch.empty_like(d)
    cbf = torch.empty(g, dtype=torch.int32, device=dev)
    d0 = torch.empty_like(d)
    f32 = np.float32
    fn = kbuild.function(
        "grid_code", "tpuhevc_grid_code",
        [kbuild.P] * 10 + [kbuild.I] * 9 + [kbuild.F] * 3 + [kbuild.P])
    err = fn(orig.data_ptr(), pred.data_ptr(), est.itab.data_ptr(),
             est.ftab.data_ptr(), lvl.data_ptr(), rec.data_ptr(),
             d.data_ptr(), b.data_ptr(), cbf.data_ptr(), d0.data_ptr(),
             h, w, log2, scale, add, qbits, dqs, dqsh, 127 if lvl8 else 32767,
             f32(lam), f32(cbf0), f32(cbf1),
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_code")
    LAUNCHES["grid_code"] += 1
    return lvl, rec, d, b, cbf, d0
