"""Fused inter TU coding with the skip/code decision (kernels K4 and
`b_txq`).

K4, twin of `tpuhevc/codec/inter_batch.py:193-211` (`coded_plane`, `bits_est`,
`sse`) and its drop rule at 231-236 / 246-252, over the transforms of
`tpuhevc/ops/transforms.py:144-198`: residual -> forward DCT-II -> inter
quantiser (rounding 85) -> dequantiser -> inverse DCT -> recon clip; the
nz flag; SSE of the skip (pred) and coded recons; the bit proxy; and the
lambda drop `(d_skip - d_coded) <= (lam_full * bits) >> 8`, whose product
wraps in int32 as JAX computes it. Outputs lvl, rec (N, S, S) and d, bits
(N,) int32 after the drop. The bit depth (8 or 10) sets the transforms'
shifts, the quantiser's constants and the recon clip; the kernel has a
variant for each.

`b_txq`, twin of `code_blocks` in the B step (`tpuhevc/codec/inter_b.py:
181-194`): residual -> forward DCT-II -> the table RDOQ
(`transforms.rdoq_est`, float32, with the B-slice estimator) ->
dequantiser -> inverse DCT -> recon clip; the nz flag; the table bit
estimate (`entropy.bitest.tu_bits`); the int32 SSEs of the skip and coded
recons; and the float32 drop `f32(d_skip - d_coded) <= lam_full * bits`.
Outputs lvl, rec (N, S, S) int32 after the drop. The bit depth (8 or 10)
sets the transforms' shifts, the quantiser's, dequantiser's and RDOQ's
constants and the recon clip, as `code_blocks` takes them at its `bd`; at
10 bits the SSEs pass 2^24, and their difference is converted to float32
once, as JAX's astype does. The kernel has a variant for each depth. With sbh (SignHideFlag)
the levels are sign-hidden after the RDOQ (`sbh_levels`: the rule of
tpuhevc's host stage, `apply_sign_bit_hiding` against
`ideal_levels_np`, `tpuhevc/codec/inter_enc.py:188-214,252-257`), and the
bit estimate counts one sign fewer for each hiding CG; tpuhevc's B step
hides no sign, while its writer omits one, so its streams fail their
hashes there.

`txq_planes` codes up to 12 planes (a P picture's CU classes, Y, U and V
each) in one launch, `txq` one plane; `b_txq_planes` up to three (a B
picture's Y, U and V), `b_txq` one plane.

`*_plain` are the PyTorch versions; `txq_planes` and `b_txq_planes`
launch the CUDA kernels (`kernels/csrc/txq.cu`, `kernels/csrc/b_txq.cu`)
for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_depth, check_tensor
from ..entropy.bitest import tu_bits_plain
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import dct_matrix
from . import transforms as tx

_INIT_DEVICES: set = set()
_B_INIT_DEVICES: set = set()


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement range (as int64)."""
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def bits_est(lvl: torch.Tensor) -> torch.Tensor:
    """(N, S, S) levels -> (N,) bit proxy: per coefficient 2*bitlen(|l|)
    (bitlen capped at 15) + (l != 0)."""
    a = lvl.reshape(lvl.shape[0], -1).abs().long()
    bl = torch.zeros_like(a)
    for k in range(15):
        bl = bl + (a > (1 << k) - 1).long()
    return (2 * bl + (a > 0).long()).sum(dim=1).int()


def _sse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b).reshape(a.shape[0], -1).long()
    return (d * d).sum(dim=1).int()


def txq_plain(cur: torch.Tensor, pred: torch.Tensor, qp: int, lam_full: int,
              bit_depth: int = 8):
    """cur, pred (N, S, S) int32 -> (lvl, rec (N,S,S), d, bits (N,)) int32."""
    log2 = cur.shape[-1].bit_length() - 1
    bd = bit_depth
    lvl = tx.quantize(tx.forward_transform(cur - pred, bd), qp, log2, bd,
                      False)
    rsd = tx.inverse_transform(tx.dequantize(lvl, qp, log2, bd), bd)
    rec = (pred + rsd).clamp(0, (1 << bd) - 1)
    nz = (lvl != 0).reshape(lvl.shape[0], -1).any(dim=1)
    rec = torch.where(nz[:, None, None], rec, pred)
    d_skip = _sse(cur, pred)
    d_coded = _sse(cur, rec)
    bits = bits_est(lvl)
    drop = (d_skip - d_coded) <= (wrap_int32(lam_full * bits.long()) >> 8)
    lvl = torch.where(drop[:, None, None], torch.zeros_like(lvl), lvl)
    rec = torch.where(drop[:, None, None], pred, rec)
    d = torch.where(drop, d_skip, d_coded)
    bits = torch.where(drop, torch.zeros_like(bits), bits)
    return lvl, rec, d, bits


def txq_planes_plain(jobs, lam_full: int, bit_depth: int = 8):
    """jobs: [(cur, pred (N, S, S) int32, qp)] -> [(lvl, rec, d, bits)],
    each job by `txq_plain` at bit_depth."""
    return [txq_plain(cur, pred, qp, lam_full, bit_depth)
            for cur, pred, qp in jobs]


def _init_matrix(dev: torch.device) -> None:
    """Copy the 32x32 HEVC matrix into the kernel's copy in device
    memory."""
    if dev.index in _INIT_DEVICES:
        return
    t32 = np.ascontiguousarray(dct_matrix(32), dtype=np.int32)
    fn = kbuild.function("txq", "tpuhevc_txq_init", [kbuild.P])
    with torch.cuda.device(dev):
        kbuild.check(fn(t32.ctypes.data_as(ctypes.c_void_p)), "txq init")
    _INIT_DEVICES.add(dev.index)


def txq_planes(jobs, lam_full: int, bit_depth: int = 8):
    """K4 over up to 12 jobs (a P picture's CU classes, Y, U and V each) in
    one launch; the arguments and results of `txq_planes_plain`. CPU
    tensors take the plain version; CUDA tensors the kernel (its variant
    for bit_depth 8 or 10: pred in 0..2^bit_depth - 1; S = 4, 8, 16 or
    32)."""
    check_depth("txq", bit_depth)
    dev = jobs[0][0].device
    if dev.type == "cpu":
        return txq_planes_plain(jobs, lam_full, bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"txq: unsupported device {dev}")
    if not 1 <= len(jobs) <= 12:
        raise ValueError(f"txq: {len(jobs)} jobs (1 to 12)")
    if not 0 <= lam_full < (1 << 31):
        raise ValueError(f"txq: lambda {lam_full} out of range")
    outs, live = [], []
    for cur, pred, qp in jobs:
        check_tensor(cur, "cur", torch.int32, 3, dev)
        check_tensor(pred, "pred", torch.int32, 3, dev)
        n, size = cur.shape[0], cur.shape[-1]
        if size not in (4, 8, 16, 32) or cur.shape[1] != size or \
                pred.shape != cur.shape:
            raise ValueError(f"txq: unsupported shapes {tuple(cur.shape)}, "
                             f"{tuple(pred.shape)}")
        if not 0 <= qp <= 51:
            raise ValueError(f"txq: qp {qp} out of range")
        out = (torch.empty_like(cur), torch.empty_like(cur),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev))
        outs.append(out)
        if any(t_.data_ptr() % 16 for t_ in (cur, pred, *out[:2])):
            raise ValueError("txq: cur, pred, lvl and rec must be 16-byte "
                             "aligned")
        if n:
            live.append(((cur, pred, *out), qp))
    if not live:
        return outs
    _init_matrix(dev)
    # the largest TUs first: their blocks take longest
    live.sort(key=lambda j: -j[0][0].shape[-1])
    ptrs, ints = [], []
    for tens, qp in live:
        log2 = tens[0].shape[-1].bit_length() - 1
        ptrs += [t_.data_ptr() for t_ in tens]
        ints += [tens[0].shape[0], log2,
                 *tx.quant_params(qp, log2, bit_depth, False),
                 *tx.dequant_params(qp, log2, bit_depth)]
    fn = kbuild.function("txq", "tpuhevc_txq",
                         [kbuild.I, kbuild.P, kbuild.P, kbuild.I, kbuild.I,
                          kbuild.P])
    err = fn(len(live), (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(ints))(*ints), int(lam_full), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "txq")
    LAUNCHES["txq" if bit_depth == 8 else "txq10"] += 1
    return outs


def txq(cur: torch.Tensor, pred: torch.Tensor, qp: int, lam_full: int,
        bit_depth: int = 8):
    """K4 on one plane: `txq_planes` with one job."""
    return txq_planes([(cur, pred, qp)], lam_full, bit_depth)[0]


# scan position -> raster index in a 4x4 diagonal scan
_DIAG4 = (0, 4, 1, 8, 5, 2, 12, 9, 6, 3, 13, 10, 7, 14, 11, 15)
_SBH_INF = 1 << 62


def _cg_index(S: int, device) -> torch.Tensor:
    """(S/4 * S/4, 16) raster indices of each 4x4 CG's levels in diagonal
    scan order."""
    cgw = S // 4
    idx = [((cg // cgw) * 4 + (r >> 2)) * S + (cg % cgw) * 4 + (r & 3)
           for cg in range(cgw * cgw) for r in _DIAG4]
    return torch.tensor(idx, dtype=torch.long, device=device).reshape(-1, 16)


def sbh_levels(lvl: torch.Tensor, coef: torch.Tensor, qp: int,
               log2: int, bit_depth: int = 8) -> torch.Tensor:
    """Sign-bit hiding of (N, S, S) levels against the coefficients they
    quantise (at bit_depth): `entropy.residual.apply_sign_bit_hiding` with
    the ideal levels `ideal_levels_np(coef, qp, log2, bit_depth)`, exactly. Per 4x4 CG
    whose first and last nonzero lie 4 or more apart in scan and whose
    absolute sum's parity differs from the first level's sign, one level
    in that span moves by +-1: the first least |new - |ideal|| over the
    positions in scan order, +1 before -1 at each (-1 not at 0, nor to 0
    at the first); a level that was 0 takes the coefficient's sign. The
    errors are compared as the integers |new 2^qbits - |coef| scale|,
    which order as the reference's float64 errors do (those are exact)."""
    n, S = lvl.shape[0], lvl.shape[-1]
    if n == 0:
        return lvl
    scale, _, qbits = tx.quant_params(qp, log2, bit_depth)
    idx = _cg_index(S, lvl.device)
    lv = lvl.reshape(n, -1).long()[:, idx]      # (n, ncg, 16)
    cf = coef.reshape(n, -1).long()[:, idx]
    a = lv.abs()
    nz = a > 0
    pos = torch.arange(16, device=lvl.device)
    first = torch.where(nz, pos, 16).amin(dim=-1, keepdim=True)
    last = torch.where(nz, pos, -1).amax(dim=-1, keepdim=True)
    lead = torch.gather(lv, -1, first.clamp(max=15))
    need = (((last - first) >= 4)
            & ((a.sum(dim=-1, keepdim=True) & 1) != (lead < 0).long()))
    ia = cf.abs() * scale
    span = (pos >= first) & (pos <= last)
    up = a + 1
    dn = a - 1
    err_up = torch.where(span, ((up << qbits) - ia).abs(), _SBH_INF)
    ok_dn = span & (dn >= 0) & ~((pos == first) & (dn == 0))
    err_dn = torch.where(ok_dn, ((dn << qbits) - ia).abs(), _SBH_INF)
    # candidates in the reference's order: position by position, +1 first
    k = torch.argmin(torch.stack([err_up, err_dn], dim=-1).flatten(-2),
                     dim=-1, keepdim=True)
    p = k >> 1
    na = torch.where((k & 1) == 0, torch.gather(up, -1, p),
                     torch.gather(dn, -1, p))
    lp = torch.gather(lv, -1, p)
    sgn = torch.where(lp != 0, torch.sign(lp),
                      torch.where(torch.gather(cf, -1, p) >= 0, 1, -1))
    out = lv.scatter(-1, p, torch.where(need, sgn * na, lp))
    flat = lvl.reshape(n, -1).long().clone()
    flat[:, idx.reshape(-1)] = out.reshape(n, -1)
    return flat.reshape(lvl.shape).to(lvl.dtype)


def b_txq_plain(cur: torch.Tensor, pred: torch.Tensor, qp: int,
                lam_full: float, est, sbh: bool = False, bit_depth: int = 8):
    """cur, pred (N, S, S) int32 of bit_depth (8 or 10) -> (lvl, rec (N, S,
    S) int32). `est`: the TU size's `EstTables`; lam_full a Python float
    (rounded to float32 where it meets a tensor, as JAX's weak type); sbh:
    sign-bit hiding after the RDOQ (`sbh_levels`), one sign fewer a hiding
    CG in the bits."""
    check_depth("b_txq", bit_depth)
    n = cur.shape[0]
    log2 = cur.shape[-1].bit_length() - 1
    coef = tx.forward_transform(cur - pred, bit_depth)
    lvl = tx.rdoq_est(coef, qp, log2, bit_depth, lam_full, est)
    if sbh:
        lvl = sbh_levels(lvl, coef, qp, log2, bit_depth)
    rsd = tx.inverse_transform(tx.dequantize(lvl, qp, log2, bit_depth),
                               bit_depth)
    rec = (pred + rsd).clamp(0, (1 << bit_depth) - 1)
    nz = (lvl != 0).reshape(n, -1).any(dim=1)
    rec = torch.where(nz[:, None, None], rec, pred)
    bits = tu_bits_plain(est, lvl, sbh)
    lam = torch.tensor(lam_full, dtype=torch.float32, device=cur.device)
    drop = (_sse(cur, pred) - _sse(cur, rec)).float() <= lam * bits
    lvl = torch.where(drop[:, None, None], torch.zeros_like(lvl), lvl)
    rec = torch.where(drop[:, None, None], pred, rec)
    return lvl, rec


def _init_b_matrix(dev: torch.device) -> None:
    """Copy the 32x32 HEVC matrix into b_txq's constant memory."""
    if dev.index in _B_INIT_DEVICES:
        return
    t32 = np.ascontiguousarray(dct_matrix(32), dtype=np.int32)
    fn = kbuild.function("b_txq", "tpuhevc_b_txq_init", [kbuild.P])
    with torch.cuda.device(dev):
        kbuild.check(fn(t32.ctypes.data_as(ctypes.c_void_p)),
                     "b_txq init")
    _B_INIT_DEVICES.add(dev.index)


def b_txq_planes_plain(planes, lam_full: float, sbh: bool = False,
                       bit_depth: int = 8):
    """planes: [(cur, pred (N, S, S) int32, qp, est)] -> [(lvl, rec)], each
    plane by `b_txq_plain` at bit_depth."""
    return [b_txq_plain(cur, pred, qp, lam_full, est, sbh, bit_depth)
            for cur, pred, qp, est in planes]


def b_txq_planes(planes, lam_full: float, sbh: bool = False,
                 bit_depth: int = 8):
    """Kernel `b_txq` over up to three planes (a B picture's Y, U and V) in
    one launch; the arguments and results of `b_txq_planes_plain`. CPU
    tensors take the plain version; CUDA tensors the kernel (S = 4, 8 or
    16; sign hiding a variant compiled in, and each bit depth, 8 or 10:
    `b_txq10` counts the 10-bit launches)."""
    check_depth("b_txq", bit_depth)
    dev = planes[0][0].device
    if dev.type == "cpu":
        return b_txq_planes_plain(planes, lam_full, sbh, bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"b_txq: unsupported device {dev}")
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"b_txq: {len(planes)} planes (1 to 3)")
    outs, classes = [], []
    for cur, pred, qp, est in planes:
        check_tensor(cur, "cur", torch.int32, 3, dev)
        check_tensor(pred, "pred", torch.int32, 3, dev)
        check_tensor(est.itab, "est.itab", torch.int32, 1, dev)
        check_tensor(est.ftab, "est.ftab", torch.float32, 1, dev)
        size = cur.shape[-1]
        if (size not in (4, 8, 16) or cur.shape[1] != size
                or pred.shape != cur.shape or est.S != size):
            raise ValueError(f"b_txq: shapes {tuple(cur.shape)}, "
                             f"{tuple(pred.shape)}, a {est.S}x{est.S} "
                             "estimator")
        if not 0 <= qp <= 51:
            raise ValueError(f"b_txq: qp {qp}")
        lvl, rec = torch.empty_like(cur), torch.empty_like(cur)
        outs.append((lvl, rec))
        tens = (cur, pred, est.itab, est.ftab, lvl, rec)
        if any(t_.data_ptr() % 16 for t_ in tens):
            raise ValueError("b_txq: tensors and tables must be 16-byte "
                             "aligned")
        if cur.shape[0]:
            classes.append((tens, qp, est))
    if not classes:
        return outs
    _init_b_matrix(dev)
    # the largest TUs first: their blocks take longest
    classes.sort(key=lambda c: -c[0][0].shape[-1])
    ptrs, ints, flts = [], [], []
    for tens, qp, est in classes:
        n, size = tens[0].shape[0], tens[0].shape[-1]
        log2 = size.bit_length() - 1
        rk = tx.rdoq_consts(qp, log2, bit_depth)
        csbf = est.csbf_host
        ptrs += [t_.data_ptr() for t_ in tens]
        qscale, _, qbits = tx.quant_params(qp, log2, bit_depth)
        ints += [n, log2, *tx.dequant_params(qp, log2, bit_depth), qscale,
                 qbits]
        flts += [float(np.float32(x)) for x in (
            rk["scale"], rk["qdiv"], rk["inv_qdiv"], rk["inv_den"],
            lam_full, lam_full * float(csbf[0, 0]),
            lam_full * float(csbf[0, 1]))]
    fn = kbuild.function("b_txq", "tpuhevc_b_txq",
                         [kbuild.I, kbuild.I] + [kbuild.P] * 3
                         + [kbuild.I, kbuild.P])
    err = fn(len(classes), int(sbh), (ctypes.c_void_p * len(ptrs))(*ptrs),
             (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_float * len(flts))(*flts), bit_depth,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "b_txq")
    LAUNCHES["b_txq" if bit_depth == 8 else "b_txq10"] += 1
    return outs


def b_txq(cur: torch.Tensor, pred: torch.Tensor, qp: int, lam_full: float,
          est, sbh: bool = False, bit_depth: int = 8):
    """Kernel `b_txq` on one plane (the arguments and results of
    `b_txq_plain`). CPU tensors take the plain version; CUDA tensors the
    kernel."""
    return b_txq_planes([(cur, pred, qp, est)], lam_full, sbh,
                        bit_depth)[0]
