"""The grid step's sample adaptive offset of a P picture (kernels
`grid_sao` and `grid_sao_decide`).

Twin of `sao_device` (`tpuhevc/codec/inter_grid.py:1427-1494`) with
`_eo_cat`, `_ctu_sum`, `_cls_hist`, `_sao_stats`, `_best_eo`,
`_eval_eo_all`, `_eval_bo`, `_sao_decide_plane` and `_sao_apply_plane`
(:1258-1425), on the deblocked picture:

1. stats (`grid_sao`, launch 1): per CTU of each component (luma CTUs of
   `ctu`, chroma of ctu / 2), the count and the sum of org - rec of each
   edge-offset category 1-4 of each of the four EO classes (categories
   from the deblocked picture, invalid at the picture's border in the
   class's direction) and of each of the 32 bands (rec >> 3); int32 sums,
   which the reference's float32 sums equal (|sum| <= 64 * 64 * 255 <
   2^24, so they are exact); on the card a cluster of blocks a CTU (at
   CTU 64 four of luma rows, one for Cb, one for Cr), each over a staged
   tile, packed counts and sums a thread's own, no atomics;
2. the per-CTU rate-distortion decision (`grid_sao_decide`, launch 2),
   float32 in the reference's operation order: the best offsets of each
   EO class and of the band offset, the luma type, the chroma type shared
   by Cb and Cr (at the chroma lambda lam / 2^((qp - qpc) / 3)), and the
   picture-level on/off choice of the two components over four
   configurations; lambda stays on the device; on the card a warp a
   (CTU, component) over many blocks, the picture's choice in the last
   block to finish (a ticket in a per-device scratch, left at zero);
3. apply (`grid_sao`, launch 3): per sample the EO or band offset of its
   CTU's type, from the unfiltered (deblocked) input, clipped to 8 bits;
   on the card a thread a run of 4 samples of a row, its loads in one
   round, one 16-byte store.

The decision writes the rows the apply reads, `par` (3, 6 n) int32 (per
component: types, aux, offsets), and the int8 parameter rows the host
half reads (type_y, aux_y, off_y, type_c, aux_cb, off_cb, aux_cr,
off_cr). `grid_sao_plain` takes the plain stats, `sao_decide` and the
plain apply; `grid_sao` launches `kernels/csrc/grid_sao.cu` for CUDA
tensors, and never calls `sao_decide` there.

Row stripes: `grid_sao_stats` and `grid_sao_apply` (each counted as a
launch of `grid_sao`) take a stripe's deblocked planes with `top` rows
above it and `bot` rows below (the neighbouring stripes' edge rows; 0 at
the picture's edges), so that the EO categories of its edge rows see
their neighbours as the whole picture does; the statistics and the
output are the stripe's own CTUs and rows. The decision between them
needs every CTU's statistics: the sharded grid step gathers them and
decides once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import chroma_qp
from .sao import EO_NEIGHBORS

SAO_INF = 1e18  # the reference's cost of an offset out of reach
NSTAT = 48  # per CTU: 16 EO (class-major, categories 1-4), 32 bands
_CAT = (1, 2, 0, 3, 4)  # EO category of sign(r - n0) + sign(r - n1) + 2


def eo_cat(rec: torch.Tensor, klass: int):
    """(category (h, w) int64 in 0..4, valid (h, w) bool) of EO class
    `klass` (`_eo_cat`; neighbours read at clamped coordinates)."""
    hh, ww = rec.shape
    dev = rec.device
    yy = torch.arange(hh, device=dev)[:, None]
    xx = torch.arange(ww, device=dev)[None]
    et = torch.zeros((hh, ww), dtype=torch.int64, device=dev)
    valid = torch.ones((hh, ww), dtype=torch.bool, device=dev)
    for dy, dx in EO_NEIGHBORS[klass]:
        nb = rec[(yy + dy).clamp(0, hh - 1), (xx + dx).clamp(0, ww - 1)]
        et = et + torch.sign(rec - nb).long()
        if dx:
            valid &= (xx + dx >= 0) & (xx + dx < ww)
        if dy:
            valid &= (yy + dy >= 0) & (yy + dy < hh)
    cat = torch.as_tensor(_CAT, device=dev)[et + 2]
    return cat, valid


def _ctu_index(hh: int, ww: int, ctu: int, dev):
    ny, nx = -(-hh // ctu), -(-ww // ctu)
    cy = torch.arange(hh, device=dev) // ctu
    cx = torch.arange(ww, device=dev) // ctu
    return (cy[:, None] * nx + cx[None]), ny, nx


def sao_stats_plain(org: torch.Tensor, rec: torch.Tensor, ctu: int,
                    top: int = 0):
    """One component -> (count, sum) (ny * nx, 48) int32 per CTU of org's
    rows; rec holds them from its row `top`, between its halo rows."""
    hh, ww = org.shape
    ci, ny, nx = _ctu_index(hh, ww, ctu, rec.device)
    own = rec[top : top + hh]
    diff = (org - own).long()
    cls = []
    for k in range(4):
        cat, valid = (x[top : top + hh] for x in eo_cat(rec, k))
        cls.append(torch.where(valid & (cat > 0), 4 * k + cat - 1, -1))
    cls.append(16 + (own >> 3).long())
    cnt = torch.zeros((ny * nx * NSTAT,), dtype=torch.int64,
                      device=rec.device)
    sm = torch.zeros_like(cnt)
    for c in cls:
        on = c >= 0
        idx = (ci * NSTAT + c)[on]
        cnt.index_add_(0, idx, torch.ones_like(idx))
        sm.index_add_(0, idx, diff[on])
    return (cnt.reshape(ny * nx, NSTAT).int(),
            sm.reshape(ny * nx, NSTAT).int())


def sao_apply_plain(rec: torch.Tensor, types: torch.Tensor,
                    aux: torch.Tensor, off4: torch.Tensor, ctu: int,
                    top: int = 0, hh: int | None = None):
    """One component: rec + the offset of each sample's CTU type (EO
    class 0-3 by category, band offset 4 at bands aux..aux+3), clipped;
    the hh rows of rec from its row `top` (default: all of rec)."""
    hh = rec.shape[0] - top if hh is None else hh
    ww = rec.shape[1]
    ci, _, _ = _ctu_index(hh, ww, ctu, rec.device)
    t = types.reshape(-1).long()[ci]
    o = off4.reshape(-1, 4).long()
    own = rec[top : top + hh]
    out = own.long()
    zero = torch.zeros_like(o[:, 0])
    lut = torch.stack([zero, o[:, 0], o[:, 1], -o[:, 2], -o[:, 3]], -1)
    for k in range(4):
        cat, valid = (x[top : top + hh] for x in eo_cat(rec, k))
        out = out + torch.where(valid & (t == k), lut[ci, cat], 0)
    band = (own >> 3).long()
    rel = (band - aux.reshape(-1).long()[ci]) % 32
    addb = o[ci, rel.clamp(max=3)]
    out = out + torch.where((t == 4) & (rel < 4), addb, 0)
    return out.clamp(0, 255).int()


# --- the per-CTU decision (float32 glue, the reference's order) -------------

def _best_eo(cnt, s, lam, sign: float):
    start = torch.round(sign * s / cnt.clamp(min=1.0)).clamp(0, 7).long()
    ob = torch.arange(8, dtype=torch.float32, device=cnt.device)
    d = cnt[..., None] * ob * ob - 2.0 * ob * (sign * s)[..., None]
    cost = d + lam * (ob + 1.0)
    cost = torch.where(torch.arange(8, device=cnt.device) <= start[..., None],
                       cost, torch.tensor(SAO_INF, device=cnt.device))
    bi = torch.argmin(cost, -1)
    return bi.int(), torch.gather(cost, -1, bi[..., None])[..., 0]


def _eval_eo_all(eo_cnt, eo_sum, lam):
    """(n, 4 classes, 4 cats) -> offsets (n, 4, 4), cost (n, 4)."""
    offs, costs = [], []
    for cat in range(4):
        o, c = _best_eo(eo_cnt[..., cat], eo_sum[..., cat], lam,
                        1.0 if cat < 2 else -1.0)
        offs.append(o)
        costs.append(c)
    total = ((costs[0] + costs[1]) + costs[2]) + costs[3]
    return torch.stack(offs, -1), total + lam * 2.0


def _eval_bo(bo_cnt, bo_sum, lam):
    """(n, 32) -> (off4 (n, 4), pos (n,), cost (n,))."""
    dev = bo_cnt.device
    start = torch.round(bo_sum / bo_cnt.clamp(min=1.0)).clamp(-7, 7)
    m = torch.arange(8, dtype=torch.float32, device=dev)
    sgn = torch.where(start >= 0, 1.0, -1.0)[..., None]
    o = sgn * m
    d = bo_cnt[..., None] * o * o - 2.0 * o * bo_sum[..., None]
    cost = d + lam * (m + 2.0)
    cost = torch.where(m <= start.abs()[..., None], cost,
                       torch.tensor(SAO_INF, device=dev))
    cost[..., 0] = lam
    bi = torch.argmin(cost, -1)
    bo = (sgn[..., 0] * bi.float()).int()
    bc = torch.gather(cost, -1, bi[..., None])[..., 0]
    # the 29 four-band windows, each summed left to right
    wins = ((bc[..., :29] + bc[..., 1:30]) + bc[..., 2:31]) + bc[..., 3:]
    pos = torch.argmin(wins, -1)
    off4 = torch.stack([torch.gather(bo, -1, (pos + i)[..., None])[..., 0]
                        for i in range(4)], -1)
    cost = torch.gather(wins, -1, pos[..., None])[..., 0] + lam * 5.0
    return off4, pos.int(), cost


def _decide_plane(cnt, sm, lam, type_bits):
    """One component's (count, sum) float32 (n, 48) -> (type, aux, off4,
    cost, the per-class EO offsets and costs, the BO offsets, position,
    cost)."""
    eo_cnt, eo_sum = cnt[:, :16].reshape(-1, 4, 4), sm[:, :16].reshape(
        -1, 4, 4)
    eo_offs, eo_cost = _eval_eo_all(eo_cnt, eo_sum, lam)
    bo_off, bo_pos, bo_cost = _eval_bo(cnt[:, 16:], sm[:, 16:], lam)
    costs = torch.stack([lam.expand(bo_cost.shape)]
                        + [eo_cost[:, k] + type_bits for k in range(4)]
                        + [bo_cost + type_bits], -1)
    bi = torch.argmin(costs, -1)
    typ, aux, off = _select(bi, eo_offs, bo_off, bo_pos)
    cost = torch.gather(costs, -1, bi[:, None])[:, 0]
    return typ, aux, off, cost, eo_offs, eo_cost, bo_off, bo_pos, bo_cost


def _select(bi, eo_offs, bo_off, bo_pos):
    """Candidate index (0 off, 1-4 EO class, 5 BO) -> (type, aux, off4)."""
    typ = torch.where(bi == 0, -1, torch.where(bi <= 4, bi - 1, 4)).int()
    aux = torch.where(bi == 5, bo_pos, 0).int()
    off = torch.zeros_like(eo_offs[:, 0])
    for k in range(4):
        off = torch.where((bi == k + 1)[:, None], eo_offs[:, k], off)
    off = torch.where((bi == 5)[:, None], bo_off, off)
    return typ, aux, off


def xla_sum2d(x: torch.Tensor) -> torch.Tensor:
    """`jnp.sum` of an (ny, nx) float32 array in XLA CPU's order for the
    picture grids in use (measured): row sums left to right, then the
    rows left to right, or ((r0 + r2) + (r1 + r3)) for four rows."""
    def seq(v):
        acc = v[0]
        for i in range(1, v.shape[0]):
            acc = acc + v[i]
        return acc

    if x.shape[0] == 4:
        r = [seq(x[i]) for i in range(4)]
        return (r[0] + r[2]) + (r[1] + r[3])
    if x.shape[0] <= 2:
        return seq(torch.stack([seq(row) for row in x]))
    return seq(x.reshape(-1))


def sao_decide(stats, lam: torch.Tensor, qp: int, ny: int, nx: int):
    """stats: [(count, sum) int32 (ny nx, 48)] of Y, Cb, Cr -> the int8
    parameter rows (type_y, aux_y, off_y, type_c, aux_cb, off_cb, aux_cr,
    off_cr), each (ny * nx[, 4]) int32."""
    (cy, sy), (ccb, scb), (ccr, scr) = [(c.float(), s.float())
                                        for c, s in stats]
    ty, ay, offy, cost_y = _decide_plane(cy, sy, lam, 2.0 * lam)[:4]
    dev = lam.device
    wch = torch.tensor(np.float32(2.0 ** ((qp - chroma_qp(qp)) / 3.0)),
                       device=dev)
    lam_c = lam / wch
    zero = torch.zeros((), device=dev)
    _, _, _, _, eo_cb, ec_cb, bo_cb, bp_cb, bc_cb = _decide_plane(
        ccb, scb, lam_c, zero)
    _, _, _, _, eo_cr, ec_cr, bo_cr, bp_cr, bc_cr = _decide_plane(
        ccr, scr, lam_c, zero)
    joint = torch.stack(
        [lam_c.expand(bc_cb.shape)]
        + [((ec_cb[:, k] + ec_cr[:, k]) - 2.0 * lam_c) + 2.0 * lam_c
           for k in range(4)]
        + [(bc_cb + bc_cr) + 2.0 * lam_c], -1)
    bi = torch.argmin(joint, -1)
    tc, acb, ocb = _select(bi, eo_cb, bo_cb, bp_cb)
    _, acr, ocr = _select(bi, eo_cr, bo_cr, bp_cr)
    n_flags = torch.tensor(np.float32(ny * (nx - 1) + (ny - 1) * nx),
                           device=dev)
    cost_c = torch.gather(joint, -1, bi[:, None])[:, 0]
    sum_y = xla_sum2d(cost_y.reshape(ny, nx))
    sum_c = xla_sum2d(cost_c.reshape(ny, nx))
    floor = lam * n_flags
    cfgs = torch.stack([zero, sum_y + floor, sum_c + floor,
                        (sum_y + sum_c) + floor])
    ci = torch.argmin(cfgs)  # stays on the device: no host sync
    ty = torch.where((ci == 1) | (ci == 3), ty, -1).int()
    tc = torch.where((ci == 2) | (ci == 3), tc, -1).int()
    return ty, ay, offy, tc, acb, ocb, acr, ocr


def grid_sao_decide_plain(cnt, sm, lam: torch.Tensor, qp: int, ny: int,
                          nx: int):
    """cnt, sm (3, ny nx, 48) int32 statistics of Y, Cb, Cr; lam the frame
    lambda (float32 0-dim tensor) -> (par (3, 6 ny nx) int32: per
    component the types, aux and offsets, as the apply reads them; params
    (17 ny nx,) int8)."""
    p = sao_decide([(cnt[i], sm[i]) for i in range(3)], lam, qp, ny, nx)
    ty, ay, offy, tc, acb, ocb, acr, ocr = p
    par = torch.stack([torch.cat([x.reshape(-1) for x in q]) for q in
                       ((ty, ay, offy), (tc, acb, ocb), (tc, acr, ocr))])
    params = torch.cat([x.to(torch.int8).reshape(-1) for x in p])
    return par.int().contiguous(), params


# per (device, stream): the decision's cost scratch (2 n float32) and its
# ticket; a launch on another stream of the device has its own, so that
# two launches in flight at once never share them
_DECIDE_SCRATCH: dict = {}
_DECIDE_ARGS = [kbuild.P] * 7 + [kbuild.F] + [kbuild.I] * 3 + [kbuild.P]
DECIDE_CTUS = 8  # the most CTUs a block of the decision (three warps each)


def grid_sao_decide(cnt, sm, lam: torch.Tensor, qp: int, ny: int, nx: int):
    """Kernel `grid_sao_decide`. CPU tensors take the plain version; CUDA
    tensors the kernel: one launch, a warp a (CTU, component), the
    picture's choice in its last block; lambda read on the device."""
    if cnt.device.type == "cpu":
        return grid_sao_decide_plain(cnt, sm, lam, qp, ny, nx)
    if cnt.device.type != "cuda":
        raise ValueError(f"grid_sao_decide: unsupported device {cnt.device}")
    dev = cnt.device
    di = dev.index
    n = ny * nx
    for t, name in ((cnt, "cnt"), (sm, "sm")):
        check_tensor(t, name, torch.int32, 3, dev)
        if tuple(t.shape) != (3, n, NSTAT):
            raise ValueError(f"grid_sao_decide: {name} {tuple(t.shape)}, "
                             f"expected {(3, n, NSTAT)}")
    check_tensor(lam, "lam", torch.float32, 0, dev)
    par = torch.empty((3, 6 * n), dtype=torch.int32, device=dev)
    params = torch.empty((17 * n,), dtype=torch.int8, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(di)
    cost, ticket, sms = _DECIDE_SCRATCH.get((di, stream), (None, None, None))
    if cost is None or cost.numel() < 2 * n:
        if ticket is None:
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            sms = torch.cuda.get_device_properties(di).multi_processor_count
        cost = torch.empty(max(2 * n, 1), dtype=torch.float32, device=dev)
        _DECIDE_SCRATCH[di, stream] = (cost, ticket, sms)
    # CTUs a block: one where the picture has no more CTUs than SMs, else
    # enough that the blocks fit in one wave
    cpb = min(max(-(-n // sms), 1), DECIDE_CTUS)
    wch = np.float32(2.0 ** ((qp - chroma_qp(qp)) / 3.0))
    fn = kbuild.function("grid_sao", "tpuhevc_grid_sao_decide", _DECIDE_ARGS)
    err = fn(cnt.data_ptr(), sm.data_ptr(), lam.data_ptr(), par.data_ptr(),
             params.data_ptr(), cost.data_ptr(), ticket.data_ptr(),
             float(wch), ny, nx, cpb, stream)
    kbuild.check(err, "grid_sao_decide")
    LAUNCHES["grid_sao_decide"] += 1
    return par, params


def _comps(oy, ouv, rec_y, rec_uv, ctu):
    wc = ouv.shape[1] // 2
    return ((oy, rec_y, ctu), (ouv[:, :wc], rec_uv[:, :wc], ctu // 2),
            (ouv[:, wc:], rec_uv[:, wc:], ctu // 2))


def grid_sao_stats_plain(oy, ouv, rec_y, rec_uv, ctu: int, top: int = 0):
    """oy (h, W), ouv (h/2, W) packed [U | V] int32: a stripe's original;
    rec_y, rec_uv: its deblocked planes with `top` rows above them (and 0
    or 1 below) -> cnt, sm (3, ny nx, 48) int32 of its CTUs."""
    st = [sao_stats_plain(o, r, c, top)
          for o, r, c in _comps(oy, ouv, rec_y, rec_uv, ctu)]
    return (torch.stack([c for c, _ in st]),
            torch.stack([s for _, s in st]))


def grid_sao_apply_plain(rec_y, rec_uv, par, ctu: int, top: int = 0,
                         h: int | None = None):
    """rec_y, rec_uv: a stripe's deblocked planes with `top` rows above its
    h luma rows (default: all but the top rows); par (3, 6 n) int32 of its
    n CTUs -> (rec_y (h, W), rec_uv (h/2, W)) after SAO."""
    h = rec_y.shape[0] - top if h is None else h
    n = par.shape[1] // 6
    out = [sao_apply_plain(r, par[i, :n], par[i, n : 2 * n],
                           par[i, 2 * n :].reshape(n, 4), c, top, hh)
           for i, ((_, r, c), hh) in enumerate(zip(
               _comps(rec_y, rec_uv, rec_y, rec_uv, ctu),
               (h, h // 2, h // 2)))]
    return out[0], torch.cat(out[1:], dim=1).contiguous()


def grid_sao_plain(oy, ouv, rec_y, rec_uv, lam: torch.Tensor, qp: int,
                   ctu: int):
    """oy, rec_y (H, W), ouv, rec_uv (H/2, W) packed [U | V] int32; lam the
    frame lambda (float32 0-dim tensor) -> (rec_y, rec_uv) after SAO and
    the packed int8 parameters."""
    H, W = rec_y.shape
    cnt, sm = grid_sao_stats_plain(oy, ouv, rec_y, rec_uv, ctu)
    par, params = grid_sao_decide_plain(cnt, sm, lam, qp, -(-H // ctu),
                                        -(-W // ctu))
    return (*grid_sao_apply_plain(rec_y, rec_uv, par, ctu), params)


def _halo_rows(rec_y, rec_uv, h: int, top: int, W: int, what: str) -> int:
    """The bottom halo rows (0 or 1) of a stripe's deblocked planes."""
    bot = rec_y.shape[0] - top - h
    if (h % 16 or W % 16 or top not in (0, 1) or bot not in (0, 1)
            or tuple(rec_uv.shape) != (top + h // 2 + bot, W)):
        raise ValueError(f"{what}: planes {tuple(rec_y.shape)}, "
                         f"{tuple(rec_uv.shape)} for {h} rows, top {top}")
    return bot


def grid_sao_stats(oy, ouv, rec_y, rec_uv, ctu: int, top: int = 0):
    """The stats launch of kernel `grid_sao`. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if rec_y.device.type == "cpu":
        return grid_sao_stats_plain(oy, ouv, rec_y, rec_uv, ctu, top)
    if rec_y.device.type != "cuda":
        raise ValueError(f"grid_sao: unsupported device {rec_y.device}")
    dev = rec_y.device
    h, W = oy.shape
    for t, name in ((oy, "oy"), (ouv, "ouv"), (rec_y, "rec_y"),
                    (rec_uv, "rec_uv")):
        check_tensor(t, name, torch.int32, 2, dev)
    bot = _halo_rows(rec_y, rec_uv, h, top, W, "grid_sao stats")
    if tuple(ouv.shape) != (h // 2, W) or rec_y.shape[1] != W or \
            ctu not in (16, 32, 64):
        raise ValueError(f"grid_sao stats: oy {tuple(oy.shape)}, ouv "
                         f"{tuple(ouv.shape)}, CTU {ctu}")
    ptrs = (oy.data_ptr(), ouv.data_ptr(), rec_y.data_ptr(),
            rec_uv.data_ptr())
    if any(p % 16 for p in ptrs):  # the kernel reads runs of 16 bytes
        raise ValueError("grid_sao stats: a plane's data is not 16-byte "
                         "aligned")
    ny, nx = -(-h // ctu), -(-W // ctu)
    cnt = torch.empty((3, ny * nx, NSTAT), dtype=torch.int32, device=dev)
    sm = torch.empty_like(cnt)
    fn = kbuild.function("grid_sao", "tpuhevc_grid_sao_stats",
                         [kbuild.P] * 6 + [kbuild.I] * 5 + [kbuild.P])
    err = fn(*ptrs, cnt.data_ptr(), sm.data_ptr(), h, W, ctu, top, bot,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_sao stats")
    LAUNCHES["grid_sao"] += 1
    return cnt, sm


def grid_sao_apply(rec_y, rec_uv, par, ctu: int, top: int = 0,
                   h: int | None = None):
    """The apply launch of kernel `grid_sao`. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if rec_y.device.type == "cpu":
        return grid_sao_apply_plain(rec_y, rec_uv, par, ctu, top, h)
    if rec_y.device.type != "cuda":
        raise ValueError(f"grid_sao: unsupported device {rec_y.device}")
    dev = rec_y.device
    h = rec_y.shape[0] - top if h is None else h
    W = rec_y.shape[1]
    check_tensor(rec_y, "rec_y", torch.int32, 2, dev)
    check_tensor(rec_uv, "rec_uv", torch.int32, 2, dev)
    check_tensor(par, "par", torch.int32, 2, dev)
    bot = _halo_rows(rec_y, rec_uv, h, top, W, "grid_sao apply")
    n = (-(-h // ctu)) * (-(-W // ctu))
    if tuple(par.shape) != (3, 6 * n) or ctu not in (16, 32, 64):
        raise ValueError(f"grid_sao apply: par {tuple(par.shape)} for {n} "
                         f"CTUs of {ctu}")
    if rec_y.data_ptr() % 16 or rec_uv.data_ptr() % 16:  # 16-byte runs
        raise ValueError("grid_sao apply: a plane's data is not 16-byte "
                         "aligned")
    new_y = torch.empty((h, W), dtype=torch.int32, device=dev)
    new_uv = torch.empty((h // 2, W), dtype=torch.int32, device=dev)
    fn = kbuild.function("grid_sao", "tpuhevc_grid_sao_apply",
                         [kbuild.P] * 5 + [kbuild.I] * 5 + [kbuild.P])
    err = fn(rec_y.data_ptr(), rec_uv.data_ptr(), par.data_ptr(),
             new_y.data_ptr(), new_uv.data_ptr(), h, W, ctu, top, bot,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_sao apply")
    LAUNCHES["grid_sao"] += 1
    return new_y, new_uv


def grid_sao(oy, ouv, rec_y, rec_uv, lam: torch.Tensor, qp: int, ctu: int):
    """Kernel `grid_sao` on the whole picture. CPU tensors take the plain
    version; CUDA tensors the kernels (three launches: the stats,
    `grid_sao_decide`, the apply)."""
    if rec_y.device.type == "cpu":
        return grid_sao_plain(oy, ouv, rec_y, rec_uv, lam, qp, ctu)
    H, W = rec_y.shape
    for t, name, shape in ((oy, "oy", (H, W)), (ouv, "ouv", (H // 2, W)),
                           (rec_uv, "rec_uv", (H // 2, W))):
        if tuple(t.shape) != shape:
            raise ValueError(f"grid_sao: {name} {tuple(t.shape)}, "
                             f"expected {shape}")
    cnt, sm = grid_sao_stats(oy, ouv, rec_y, rec_uv, ctu)
    par, params = grid_sao_decide(cnt, sm, lam, qp, -(-H // ctu),
                                  -(-W // ctu))
    return (*grid_sao_apply(rec_y, rec_uv, par, ctu), params)
