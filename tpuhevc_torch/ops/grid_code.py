"""The grid step's residual coding of one TU size (kernel `grid_code`).

Twin of `_txq_luma` and the `_txq_chroma` closure of `class_code`
(`tpuhevc/codec/inter_grid.py:1718-1750,1822-1851`), with the plane
transforms of :342-383, the flat quantiser or the grid's RDOQ
(`rdoq_plane`, :399-559) and, optionally, sign-bit hiding (`ideal_plane`,
`sbh_plane`, :561-631), 8-bit: over an (h, w) plane tiled into T x T TUs
(T in 4..32),

  r = orig - pred; c = forward DCT (rows then columns, as `fwd_tx`);
  lvl = clip(sign(c) ((|c| scale + (85 << (qbits - 9))) >> qbits), +-lim),
        lim = 127 when the frame's levels are packed as int8, else 32767;
        with rdoq, lvl = `rdoq_tiles` (per coefficient ceil / ceil-1 / 0,
        the per-CG all-zero trial, the last-position walk-back);
        with sbh, lvl = `sbh_tiles(lvl, ideal)` per 4x4 CG;
  rec = nz ? clip(pred + IDCT(dequant(lvl)), 0, 255) : pred;
  d_skip, d_coded = the TU's SSE of orig - pred and orig - rec (int32
        sums, then float32);
  bits = the table bit estimate of lvl (`entropy.bitest.tu_bits` with the
        estimator's live tables; one sign bit fewer per hiding CG with sbh);
  drop = d_skip + lam cbf0 <= d_coded + lam (bits + cbf1), float32 with
        every product rounded on its own;
  dropped TUs: lvl 0, rec = pred, d = d_skip, b = cbf0, cbf count 0;
        else d = d_coded, b = bits + cbf1, cbf count = nonzero levels.

Chroma runs the same function over the packed [U | V] plane at the
chroma QP with the chroma lambda, estimator and cbf bits. `grid_code_plain`
is the PyTorch version; `grid_code_batch` launches
`kernels/csrc/grid_code.cu` (RDOQ and SBH in `grid_rdoq.cuh`) for CUDA
tensors, up to eight planes (the class coding's luma and chroma at each
RQT depth) in one launch.

lam and the cbf bits (cbf0, cbf1) are float32 values: the plain version
takes them as Python floats or as tensors (a 0-dim lam, a (2,) cbf), the
kernel only as tensors on its device, which it reads on the card. So a
call on the card copies nothing between the host and the device and never
waits for the stream (a float there would need an upload, which syncs).

The RDOQ's float32 sums follow the order in which XLA's CPU backend adds
them (measured against `inter_grid._PROBES["rdoq_plane"]`): a 4x4 CG sum
in raster order, one after the other; a cumulative sum over scan
positions in blocks of 16 (each block left to right, the blocks' totals
scanned the same way, recursively, and added to the later blocks); a
whole-TU sum in chunks of 32, each left to right, the chunks' sums left to
right.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..device import check_tensor, on_device
from ..entropy.bitest import EstTables, tu_bits_plain
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..entropy.bitest import bit_length_minus1, rice_param, up4
from ..utils.tables import (MAX_TR_DYNAMIC_RANGE, QUANT_SCALES, SCAN_DIAG,
                            dct_matrix, scan_order)
from .intra import blocks, unblocks
from .transforms import (dequant_params, forward_transform, inverse_transform,
                         quant_params)

F32 = np.float32
_CODE_ARGS = [kbuild.P, kbuild.P] + [kbuild.I] * 4 + [kbuild.P]
SBH_INF = 1e30  # the reference's stand-in for an impossible SBH change


def up(p: torch.Tensor, t: int) -> torch.Tensor:
    """Repeat each entry of the last two dims t x t times."""
    return p.repeat_interleave(t, -2).repeat_interleave(t, -1)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right in float32."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last dim, left to right in
    float32 (torch.cumsum accumulates float32 in double on the CPU)."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.cumsum` over the last dim (a multiple of 16, or shorter) in
    XLA CPU's order: blocks of 16 scanned left to right, the blocks'
    totals scanned the same way, each block's exclusive prefix added."""
    L = x.shape[-1]
    if L <= 16:
        return seq_cumsum(x)
    inner = seq_cumsum(x.reshape(*x.shape[:-1], L // 16, 16))
    outer = xla_cumsum(inner[..., 15].contiguous())
    excl = torch.zeros_like(outer)
    excl[..., 1:] = outer[..., :-1]
    return (inner + excl[..., None]).reshape(x.shape)


def xla_rowsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.sum` over the last dim (16 or a multiple of 32) in XLA CPU's
    order: chunks of 32 left to right, then the chunks' sums."""
    L = x.shape[-1]
    if L <= 32:
        return seq_sum(x)
    return seq_sum(seq_sum(x.reshape(*x.shape[:-1], L // 32, 32)))


def cg_sum16(x: torch.Tensor) -> torch.Tensor:
    """(n, S, S) -> (n, S/4, S/4) 4x4-CG sums in raster order, one after
    the other (the reference's `tile_sum(., 4)`)."""
    n, S = x.shape[0], x.shape[-1]
    g = x.reshape(n, S // 4, 4, S // 4, 4).permute(0, 1, 3, 2, 4)
    return seq_sum(g.reshape(n, S // 4, S // 4, 16))


def _scan_geom(est: EstTables):
    """Raster index of each diagonal scan position of the TU."""
    return (est.scan_y * est.S + est.scan_x).long()


def rdoq_tiles(c: torch.Tensor, qp: int, log2: int, lam32: torch.Tensor,
               est: EstTables, lim: int) -> torch.Tensor:
    """`rdoq_plane` on (n, S, S) coefficient tiles -> levels (int64)."""
    n, S = c.shape[0], 1 << log2
    dev = c.device
    per, rem = qp // 6, qp % 6
    tshift = MAX_TR_DYNAMIC_RANGE - 8 - log2
    qbits = 14 + per + tshift
    scale = F32(QUANT_SCALES[rem])
    q2 = torch.tensor(F32(1 << qbits), device=dev)
    err_den = torch.tensor(F32(int(QUANT_SCALES[rem]) * (1 << tshift)),
                           device=dev)
    ac = c.abs().float() * torch.tensor(scale, device=dev)
    lmax = torch.ceil(ac / q2)
    s0 = est.sig_bits[0, :, :, 0][None]
    s1 = est.sig_bits[0, :, :, 1][None]
    is_cg0 = torch.zeros((S, S), dtype=torch.bool, device=dev)
    is_cg0[:4, :4] = True
    g1, g10, g2, g20 = (est.gt1_bits, est.gt1_bits0, est.gt2_bits,
                        est.gt2_bits0)
    gt1_0 = torch.where(is_cg0, g10[0], g1[0])
    gt1_1 = torch.where(is_cg0, g10[1], g1[1])
    gt2_0 = torch.where(is_cg0, g20[0], g2[0])
    gt2_1 = torch.where(is_cg0, g20[1], g2[1])
    cgw = S // 4
    rice = up4(rice_param(lmax.reshape(n, cgw, 4, cgw, 4).amax(dim=4)
                          .amax(dim=2)))
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)

    def lvl_bits(level):
        r = (level - 3.0).clamp(min=0.0).long()
        three = 3 << rice
        esc = bit_length_minus1(((r - three).clamp(min=0) >> rice) + 1)
        rl = torch.where(r < three, ((r >> rice) + 1 + rice),
                         (4 + rice) + 2 * esc).float()
        w2 = torch.where(level > 2.0, (gt2_1 - gt2_0) + rl, zero)
        w1 = torch.where(level > 1.0, ((gt1_1 - gt1_0) + gt2_0) + w2, zero)
        return ((s1 + one) + gt1_0) + w1

    def bits_of(level):
        return torch.where(level > 0, lvl_bits(level), s0)

    def cost(level):
        d = (ac - level * q2) / err_den
        return d * d + lam32 * bits_of(level)

    l1 = lmax.clamp(min=0.0)
    l2 = (lmax - 1.0).clamp(min=0.0)
    best = torch.where(cost(l1) <= cost(l2), l1, l2)
    best = torch.where(cost(best) <= cost(torch.zeros_like(best)), best,
                       zero)
    csbf = est.csbf_bits
    dz = (ac - best * q2) / err_den
    ck = cg_sum16(dz * dz + lam32 * bits_of(best))
    acn = ac / err_den
    czp = acn * acn
    cz = cg_sum16(czp)
    keep = up4(ck + lam32 * csbf[0, 1] <= cz + lam32 * csbf[0, 0])
    best = torch.where(keep, best, zero)
    # the last-position walk-back over scan positions
    dzl = (ac - best * q2) / err_den
    cc = torch.where(keep,
                     dzl * dzl + lam32 * (bits_of(best) + csbf[0, 1] / 16.0),
                     czp + lam32 * csbf[0, 0] / 16.0)
    sr = _scan_geom(est)
    n2 = S * S
    ccs = cc.reshape(n, n2)[:, sr]
    czs = czp.reshape(n, n2)[:, sr]
    bs = best.reshape(n, n2)[:, sr]
    s1s = s1.reshape(1, n2)[:, sr]
    pref = xla_cumsum(ccs) - ccs
    suf = xla_rowsum(czs)[:, None] - xla_cumsum(czs)
    gi = est.group_idx
    lbv = (lam32 * est.lastx_bits[gi[est.scan_x]]
           + lam32 * est.lasty_bits[gi[est.scan_y]])[None]
    costp = (((pref + ccs) - lam32 * s1s) + lbv) + suf
    costp = torch.where(bs > 0, costp, torch.tensor(float("inf"),
                                                    device=dev))
    pbest = torch.argmin(costp, dim=1)
    k = torch.arange(n2, device=dev)[None]
    bs = torch.where(k <= pbest[:, None], bs, zero)
    best = torch.zeros_like(bs)
    best[:, sr] = bs
    lv = torch.sign(c) * best.reshape(n, S, S).long()
    return lv.clamp(-lim, lim)


def ideal_tiles(c: torch.Tensor, qp: int, log2: int) -> torch.Tensor:
    """`ideal_plane`: the signed pre-rounding level c scale / 2^qbits."""
    per, rem = qp // 6, qp % 6
    qbits = 14 + per + MAX_TR_DYNAMIC_RANGE - 8 - log2
    scale = torch.tensor(F32(QUANT_SCALES[rem]), device=c.device)
    return c.float() * scale / torch.tensor(F32(1 << qbits),
                                            device=c.device)


_S4 = np.asarray(scan_order(2, SCAN_DIAG), np.int64)  # scan pos -> raster


def _cg_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, S, S) -> (n * (S/4)^2, 16) rows of 4x4 CGs in diagonal scan."""
    n, S = x.shape[0], x.shape[-1]
    g = x.reshape(n, S // 4, 4, S // 4, 4).permute(0, 1, 3, 2, 4)
    return g.reshape(-1, 16)[:, torch.as_tensor(_S4, device=x.device)]


def _from_cg_rows(rows: torch.Tensor, n: int, S: int) -> torch.Tensor:
    raster = torch.empty_like(rows)
    raster[:, torch.as_tensor(_S4, device=rows.device)] = rows
    return raster.reshape(n, S // 4, S // 4, 4, 4).permute(
        0, 1, 3, 2, 4).reshape(n, S, S)


def sbh_tiles(lvl: torch.Tensor, ideal: torch.Tensor,
              lim: int) -> torch.Tensor:
    """`sbh_plane` on (n, S, S) levels (int64) with the ideal levels: per
    4x4 CG whose nonzero scan span is 4 or more, change one level by +-1
    where the parity of the CG's sum disagrees with the first level's
    sign, at the first least |change - ideal| of the +1 then the -1
    candidates."""
    n, S = lvl.shape[0], lvl.shape[-1]
    lv = _cg_rows(lvl)
    iv = _cg_rows(ideal)
    a = lv.abs()
    nz = a > 0
    pos = torch.arange(16, device=lvl.device)[None]
    first = torch.where(nz, pos, 16).amin(dim=1, keepdim=True)
    last = torch.where(nz, pos, -1).amax(dim=1, keepdim=True)
    hide = (last - first) >= 4
    first_sel = pos == first.clamp(max=15)
    want = torch.where(first_sel, lv, 0).sum(dim=1, keepdim=True) < 0
    need = hide & ((a.sum(dim=1, keepdim=True) & 1) != want.long())
    ia = iv.abs()
    in_rng = (pos >= first) & (pos <= last)
    inf = torch.tensor(SBH_INF, dtype=torch.float32, device=lvl.device)
    err_up = torch.where(in_rng & (a + 1 <= lim),
                         ((a + 1).float() - ia).abs(), inf)
    bad_dn = (a == 0) | ((pos == first) & (a == 1))
    err_dn = torch.where(in_rng & ~bad_dn, ((a - 1).float() - ia).abs(), inf)
    bi = torch.argmin(torch.cat([err_up, err_dn], dim=1), dim=1,
                      keepdim=True)
    sel = pos == bi % 16
    d_abs = torch.where(bi < 16, 1, -1)
    sgn = torch.where(sel, lv, 0).sum(dim=1, keepdim=True)
    isgn = torch.where(sel, iv, torch.zeros_like(iv)).sum(dim=1,
                                                          keepdim=True)
    sgn = torch.where(sgn != 0, torch.sign(sgn),
                      torch.where(isgn >= 0, 1, -1))
    delta = torch.where(need & sel, sgn * d_abs, 0)
    return _from_cg_rows(lv + delta, n, S)


def _f32_on(v, dev) -> torch.Tensor:
    """v (a Python float or a tensor) as a float32 tensor on dev."""
    if isinstance(v, torch.Tensor):
        return v.to(dev, torch.float32)
    return torch.tensor(v, dtype=torch.float32, device=dev)


def grid_code_plain(orig: torch.Tensor, pred: torch.Tensor, T: int, qp: int,
                    lam, est: EstTables, cbf, lvl8: bool, rdoq: bool = False,
                    sbh: bool = False):
    """orig, pred (h, w) int32, lam (a float or a 0-dim tensor), cbf (the
    cbf bits cbf0, cbf1: two floats or a (2,) tensor) -> (lvl, rec (h, w)
    int32; d, bits (h/T, w/T) float32; cbf (h/T, w/T) int32; d_skip
    float32)."""
    h, w = orig.shape
    log2 = T.bit_length() - 1
    scale, add, qbits = quant_params(qp, log2, 8, False)
    lim = 127 if lvl8 else 32767
    g = (h // T, w // T)
    lam32 = _f32_on(lam, orig.device)
    c = forward_transform(blocks(orig - pred, T, *g)).long()
    if rdoq:
        lv = rdoq_tiles(c, qp, log2, lam32, est, lim)
    else:
        lv = (torch.sign(c) * ((c.abs() * scale + add) >> qbits)).clamp(
            -lim, lim)
    if sbh:
        lv = sbh_tiles(lv, ideal_tiles(c, qp, log2), lim)
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
    bits = tu_bits_plain(est, lvt, sbh)
    c0, c1 = _f32_on(cbf[0], orig.device), _f32_on(cbf[1], orig.device)
    drop = d_skip + lam32 * c0 <= d_coded + lam32 * (bits + c1)
    lvt = torch.where(drop[:, None, None], 0, lvt)
    rec = torch.where(drop[:, None, None], pt, rec)
    d = torch.where(drop, d_skip, d_coded)
    b = torch.where(drop, c0, bits + c1)
    cbf = torch.where(drop, 0, nz)
    return (unblocks(lvt, *g), unblocks(rec, *g), d.reshape(g),
            b.reshape(g), cbf.reshape(g), d_skip.reshape(g))


_DCT32: dict = {}
MAX_JOBS = 8  # planes a launch (grid_code.cu kMaxSeg)
_QUANT: dict = {}  # (T, qp) -> (log2, scale, add, qbits, dqscale, dqshift)
_CHECKED = weakref.WeakKeyDictionary()  # EstTables -> the device checked


def _init(dev: torch.device) -> None:
    if dev.index in _DCT32:
        return
    t = np.ascontiguousarray(dct_matrix(32), dtype=np.int32)
    fn = kbuild.function("grid_code", "tpuhevc_grid_code_init", [kbuild.P])
    with on_device(dev):
        kbuild.check(fn(t.ctypes.data), "grid_code init")
    _DCT32[dev.index] = True


def _quant(T: int, qp: int) -> tuple:
    v = _QUANT.get((T, qp))
    if v is None:
        log2 = T.bit_length() - 1
        v = _QUANT[(T, qp)] = (log2, *quant_params(qp, log2, 8, False),
                               *dequant_params(qp, log2, 8))
    return v


def _ok(t, dtype, ndim: int, dev) -> bool:
    return (isinstance(t, torch.Tensor) and t.dtype == dtype
            and t.dim() == ndim and t.device == dev and t.is_contiguous())


def _check_job(orig, pred, T, lam, est, cbf, dev) -> None:
    """Raise unless the job is one the kernel takes (the estimator's
    tables checked once per EstTables and device)."""
    if not (_ok(orig, torch.int32, 2, dev) and _ok(pred, torch.int32, 2, dev)
            and _ok(lam, torch.float32, 0, dev)
            and _ok(cbf, torch.float32, 1, dev)):
        check_tensor(orig, "orig", torch.int32, 2, dev)
        check_tensor(pred, "pred", torch.int32, 2, dev)
        check_tensor(lam, "lam", torch.float32, 0, dev)
        check_tensor(cbf, "cbf", torch.float32, 1, dev)
    if _CHECKED.get(est) != dev:
        check_tensor(est.itab, "est.itab", torch.int32, 1, dev)
        check_tensor(est.ftab, "est.ftab", torch.float32, 1, dev)
        _CHECKED[est] = dev
    h, w = orig.shape
    if (pred.shape != orig.shape or h % T or w % T or est.S != T
            or not 4 <= T <= 32 or T & (T - 1) or cbf.shape[0] != 2):
        raise ValueError(f"grid_code: planes {tuple(orig.shape)}, "
                         f"{tuple(pred.shape)}, T {T}, estimator {est.S}, "
                         f"cbf {tuple(cbf.shape)}")


def grid_code_batch_plain(jobs, lvl8: bool, rdoq: bool = False,
                          sbh: bool = False) -> list:
    """`grid_code_plain` of each job (orig, pred, T, qp, lam, est, cbf)."""
    return [grid_code_plain(*j, lvl8, rdoq, sbh) for j in jobs]


def grid_code_batch(jobs, lvl8: bool, rdoq: bool = False,
                    sbh: bool = False) -> list:
    """Kernel `grid_code`: up to MAX_JOBS planes, each job (orig, pred, T,
    qp, lam, est, cbf) as `grid_code_plain` takes it, in one launch (their
    TUs side by side on the card); returns each job's outputs, in order.
    CPU tensors take the plain version, job by job; on CUDA lam is a 0-dim
    and cbf a (2,) float32 tensor on the same device, read on the card
    (no copy, no sync)."""
    if not jobs:
        return []
    dev = jobs[0][0].device
    if dev.type == "cpu":
        return grid_code_batch_plain(jobs, lvl8, rdoq, sbh)
    if dev.type != "cuda":
        raise ValueError(f"grid_code: unsupported device {dev}")
    if len(jobs) > MAX_JOBS:
        raise ValueError(f"grid_code: {len(jobs)} jobs, at most {MAX_JOBS}")
    _init(dev)
    ptrs, ints, outs = [], [], []
    for orig, pred, T, qp, lam, est, cbf in jobs:
        _check_job(orig, pred, T, lam, est, cbf, dev)
        h, w = orig.shape
        g = (h // T, w // T)
        out = (torch.empty_like(orig), torch.empty_like(orig),
               torch.empty(g, dtype=torch.float32, device=dev),
               torch.empty(g, dtype=torch.float32, device=dev),
               torch.empty(g, dtype=torch.int32, device=dev),
               torch.empty(g, dtype=torch.float32, device=dev))
        ptrs += (orig.data_ptr(), pred.data_ptr(), est.itab.data_ptr(),
                 est.ftab.data_ptr(), lam.data_ptr(), cbf.data_ptr(),
                 *(o.data_ptr() for o in out))
        ints += (h, w, *_quant(T, qp))
        outs.append(out)
    p = np.array(ptrs, np.uint64)
    q = np.array(ints, np.int32)
    fn = kbuild.function("grid_code", "tpuhevc_grid_code", _CODE_ARGS)
    err = fn(p.ctypes.data, q.ctypes.data, len(jobs), 127 if lvl8 else 32767,
             int(rdoq), int(sbh),
             torch._C._cuda_getCurrentRawStream(dev.index))
    kbuild.check(err, "grid_code")
    LAUNCHES["grid_code"] += 1
    return outs

