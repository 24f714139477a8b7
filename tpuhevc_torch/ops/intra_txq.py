"""Intra TU rate-distortion trial of the open-loop decision (kernel
`intra_txq`).

Twin of `txq` (`tpuhevc/codec/intra_decide_jax.py:86-98`) with the
uncoded-distortion term of its callers (`:139-140`, `:194-195`,
`:227-228`): for M target blocks and K candidate modes each, the residual
org - pred (the prediction picked from the block's 35-mode bank by mode
index), the forward DCT-II (or the 4x4 DST-VII), the intra quantiser
(rounding 171) or the table RDOQ (`transforms.rdoq_est`), dequantiser and
inverse transform; returns the float32 SSE against the residual (dist),
the SSE of the residual itself (d0) and the levels, which
`entropy.bitest.tu_bits` turns into bits.

Blocks are addressed through `rows`: block m takes org[rows[m]] and the
bank preds[rows[m]], so the TU-split trial reads its children's banks in
place. The SSEs are exact integer sums rounded once to float32; JAX sums
in float32, which equals that while a sum stays below 2^24.

`intra_txq_plain` is the PyTorch version; `intra_txq` launches the CUDA
kernel (`kernels/csrc/intra_txq.cu`) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.tables import DST4, dct_matrix

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from . import transforms as tx

_INIT_DEVICES: set = set()


def _sse(x: torch.Tensor) -> torch.Tensor:
    return (x.long() * x.long()).sum(dim=(-1, -2)).float()


def intra_txq_plain(org: torch.Tensor, preds: torch.Tensor, rows: torch.Tensor,
                    modes: torch.Tensor, qp: int, is_dst: bool, rdoq: bool,
                    lam: float, est, bit_depth: int = 8):
    """org (R, S, S), preds (R, 35, S, S), rows (M,), modes (M, K) int32
    -> (dist (M, K) f32, d0 (M, K) f32, lvl (M, K, S, S) int32). `lam`:
    the RDOQ lambda (full, already divided by the chroma weight); `est`:
    the TU size's `EstTables` (read only with rdoq)."""
    m, k = modes.shape
    S = org.shape[-1]
    log2 = S.bit_length() - 1
    r = rows.long()
    sel = preds[r[:, None], modes.long()]
    resi = org[r][:, None] - sel
    c = tx.forward_transform(resi, bit_depth, is_dst).reshape(-1, S, S)
    if rdoq:
        lvl = tx.rdoq_est(c, qp, log2, bit_depth, lam, est)
    else:
        lvl = tx.quantize(c, qp, log2, bit_depth, True)
    rec = tx.inverse_transform(tx.dequantize(lvl, qp, log2, bit_depth),
                               bit_depth, is_dst).reshape(m, k, S, S)
    return _sse(resi - rec), _sse(resi), lvl.reshape(m, k, S, S)


def _init_matrices(dev: torch.device) -> None:
    """Copy the 32x32 DCT and the 4x4 DST matrices into the kernel's
    constant memory."""
    if dev.index in _INIT_DEVICES:
        return
    t32 = np.ascontiguousarray(dct_matrix(32), dtype=np.int32)
    dst = np.ascontiguousarray(DST4, dtype=np.int32)
    fn = kbuild.function("intra_txq", "tpuhevc_intra_txq_init",
                         [kbuild.P] * 2)
    with torch.cuda.device(dev):
        kbuild.check(fn(t32.ctypes.data_as(ctypes.c_void_p),
                        dst.ctypes.data_as(ctypes.c_void_p)),
                     "intra_txq init")
    _INIT_DEVICES.add(dev.index)


def intra_txq(org: torch.Tensor, preds: torch.Tensor, rows: torch.Tensor,
              modes: torch.Tensor, qp: int, is_dst: bool, rdoq: bool,
              lam: float, est, bit_depth: int = 8):
    """Kernel `intra_txq`. CPU tensors take the plain version; CUDA
    tensors the kernel, its variant for bit_depth 8 or 10."""
    if org.device.type == "cpu":
        return intra_txq_plain(org, preds, rows, modes, qp, is_dst, rdoq,
                               lam, est, bit_depth)
    if org.device.type != "cuda":
        raise ValueError(f"intra_txq: unsupported device {org.device}")
    dev = org.device
    check_tensor(org, "org", torch.int32, 3, dev)
    check_tensor(preds, "preds", torch.int32, 4, dev)
    check_tensor(rows, "rows", torch.int32, 1, dev)
    check_tensor(modes, "modes", torch.int32, 2, dev)
    R, S = org.shape[0], org.shape[-1]
    m, k = modes.shape
    if S not in (4, 8, 16, 32) or tuple(preds.shape) != (R, 35, S, S) or \
            org.shape[1] != S or rows.shape[0] != m or (is_dst and S != 4):
        raise ValueError(f"intra_txq: unsupported shapes org "
                         f"{tuple(org.shape)} preds {tuple(preds.shape)} "
                         f"rows {tuple(rows.shape)} modes {tuple(modes.shape)}")
    if bit_depth not in (8, 10) or not 0 <= qp <= 51:
        raise ValueError(f"intra_txq: bit depth {bit_depth} / qp {qp}")
    if rdoq:
        check_tensor(est.ftab, "est.ftab", torch.float32, 1, dev)
        if est.S != S:
            raise ValueError(f"intra_txq: a {est.S}x{est.S} estimator for "
                             f"{S}x{S} TUs")
    dist = torch.empty((m, k), dtype=torch.float32, device=dev)
    d0 = torch.empty((m, k), dtype=torch.float32, device=dev)
    lvl = torch.empty((m, k, S, S), dtype=torch.int32, device=dev)
    if m * k == 0:
        return dist, d0, lvl
    _init_matrices(dev)
    log2 = S.bit_length() - 1
    qscale, qadd, qbits = tx.quant_params(qp, log2, bit_depth, True)
    dqscale, dqshift = tx.dequant_params(qp, log2, bit_depth)
    rk = tx.rdoq_consts(qp, log2, bit_depth)
    lc0 = lc1 = 0.0
    if rdoq:
        csbf = est.csbf_host
        lc0, lc1 = lam * float(csbf[0, 0]), lam * float(csbf[0, 1])
    f = ctypes.c_float
    fn = kbuild.function(
        "intra_txq", "tpuhevc_intra_txq",
        [kbuild.P] * 8 + [kbuild.I] * 10 + [f] * 7 + [kbuild.I, kbuild.P])
    err = fn(org.data_ptr(), preds.data_ptr(), rows.data_ptr(),
             modes.data_ptr(), est.ftab.data_ptr() if rdoq else None,
             dist.data_ptr(), d0.data_ptr(), lvl.data_ptr(),
             m, k, log2, int(is_dst), qscale, qadd, qbits, dqscale, dqshift,
             int(rdoq),
             *(float(np.float32(x)) for x in (
                 rk["scale"], rk["qdiv"], rk["inv_qdiv"], rk["inv_den"], lam,
                 lc0, lc1)),
             bit_depth, torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "intra_txq")
    LAUNCHES["intra_txq" if bit_depth == 8 else "intra_txq10"] += 1
    return dist, d0, lvl
