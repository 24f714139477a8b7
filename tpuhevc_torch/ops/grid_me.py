"""The grid step's motion search (kernels `grid_coarse`, `grid_prestage`
and `grid_refine`).

`grid_coarse`, twin of `coarse_stack` (`tpuhevc/codec/inter_grid.py:650`):
for every offset (dy, dx) of an n x n window over an edge-padded pooled
reference, the SAD of the pooled current picture per `tile` x `tile`
block, shifted left by `shift` (the pooling's weight), and with `sums`
the signed residual sum per block (the DC term of the DC-aware cost).
The costs, the first-index argmins and the global candidate that read
the stack are torch glue in `codec/inter_grid.py`.

`grid_prestage`, twin of the long-range prestage `ps_row` (:2395-2416)
with its pick: per block the first index k = dy * n + dx of the least
(sad << shift) + ((bits[k] * lam_me) >> 8), where `ps_row` keeps a
strict-less running best over k in order; the SAD stack is never
written.

`grid_refine`, twin of `_refine_grid` + `_pick_grids` (:681-776) with the
default knobs (no MV-rate anchor) and of the reference loop around them
(`ref_body` with `merge_acc`, :2468-2512, and `acc_init`, :2453-2456):
for each block of size S and each of G start points (full-pel centres,
reference-major: reference 0's, then one for each further reference),
each read from its plane `sref[g]` of the reference stack, the 7x7 raw
SADs of the windows read at clamped coordinates (`ry` rows and columns
clipped to the plane, as the reference's gather is; with `ry_y0` the
reference row of a block row y is y + ry_y0, where `ry` is a row stripe
with ry_y0 halo rows above its blocks, as `stripe_refine` gives it), the
DC-aware selection cost zc(sad, sum, dcc) + ((bits(mv) * lam_me) >> 8)
on the inner 5x5 (the outer ring costs 2^30), and the winner: the first
index over the G x 49 candidates of that cost plus the start's reference
bits ((rbits[ref] * lam_me) >> 8; none without rbits, as `acc_init` adds
none with one reference), which equals each reference's first-index pick
merged in reference order on a strict less; its MV clipped to +-(sr_full
+ 3), its 3x3 raw-SAD surface, its cost and its reference. With `quads`
(S = 16) the same pick per 8x8 quadrant (the 8-class), from the quadrant
partial sums, in 8-grid order. bits(mv) = 2 ceil(log2(2|4 mvx| + 1)) + 2
ceil(log2(2|4 mvy| + 1)) + 2, taken exactly as bit lengths (2a + 1 is
odd, so the ceiling of its log2 is the bit length of 2a).
`grid_refine_refs` takes the stack; `grid_refine` is its one-reference
case on a plane (no reference bits, no reference output).

`grid_wp_me`, twin of the weighted full-pel search references of
explicit weighted prediction (:2352-2362, luma): per reference r,
clip(((ref * w[r] + rnd) >> d) + o[r], 0, 255) with rnd = (1 << d) >> 1.
The motion search reads these; the phase planes keep the unweighted
references and fold the weighting into their rounding (`grid_planes`).

`*_plain` are the PyTorch versions; the wrappers launch the CUDA kernels
(`kernels/csrc/grid_me.cu`) for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..device import check_tensor
from ..device import contiguous_on as _on
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

BIG = 1 << 30  # the cost of a refine point outside the inner 5x5
MAX_STARTS = 16  # start grids a grid_refine launch takes


def tile_sum(p: torch.Tensor, t: int) -> torch.Tensor:
    """(..., h, w) -> (..., h/t, w/t) sums of t x t tiles."""
    *lead, h, w = p.shape
    return p.reshape(*lead, h // t, t, w // t, t).sum(dim=(-3, -1))


def zcost(sad: torch.Tensor, sdc: torch.Tensor, dcc: int) -> torch.Tensor:
    """DC-aware cost: sad - |sum| + min(|sum|, dcc) (`_zc`)."""
    a = sdc.abs()
    return sad - a + torch.clamp(a, max=dcc)


def ceil_log2_odd(a: torch.Tensor) -> torch.Tensor:
    """ceil(log2(2a + 1)) of integers a >= 0 (< 2^15), exactly."""
    out = torch.zeros_like(a)
    for j in range(1, 17):
        out = out + ((2 * a) >= (1 << (j - 1))).to(a.dtype)
    return out


def grid_coarse_plain(cur: torch.Tensor, refp: torch.Tensor, n: int,
                      tile: int, shift: int, sums: bool):
    """cur (h, w) int32 pooled picture, refp (h+n-1, w+n-1) int32 padded
    pooled reference -> (sad (n*n, h/tile, w/tile) int32, sum or None)."""
    h, w = cur.shape
    win = refp.unfold(0, h, 1).unfold(1, w, 1)  # (n, n, h, w) view
    d = win - cur
    sad = tile_sum(d.abs(), tile).reshape(n * n, h // tile, w // tile)
    sad = sad.int() << shift
    sm = (tile_sum(d, tile).reshape(n * n, h // tile, w // tile).int()
          if sums else None)
    return sad, sm


def _coarse_shapes(name, cur, refp, n, tile, tiles):
    """Check the coarse entries' inputs on the card -> (h, w)."""
    dev = cur.device
    check_tensor(cur, "cur", torch.int32, 2, dev)
    check_tensor(refp, "refp", torch.int32, 2, dev)
    h, w = cur.shape
    if (refp.shape != (h + n - 1, w + n - 1) or tile not in tiles
            or h % tile or w % tile or n < 1):
        raise ValueError(f"{name}: cur {tuple(cur.shape)}, refp "
                         f"{tuple(refp.shape)}, n {n}, tile {tile}")
    return h, w


def grid_coarse(cur: torch.Tensor, refp: torch.Tensor, n: int, tile: int,
                shift: int, sums: bool):
    """Kernel `grid_coarse`. CPU tensors take the plain version; CUDA
    tensors the kernel (tile 8, the 2x-pooled level's)."""
    if cur.device.type == "cpu":
        return grid_coarse_plain(cur, refp, n, tile, shift, sums)
    if cur.device.type != "cuda":
        raise ValueError(f"grid_coarse: unsupported device {cur.device}")
    dev = cur.device
    h, w = _coarse_shapes("grid_coarse", cur, refp, n, tile, (8,))
    nbh, nbw = h // tile, w // tile
    sad = torch.empty((n * n, nbh, nbw), dtype=torch.int32, device=dev)
    sm = (torch.empty((n * n, nbh, nbw), dtype=torch.int32, device=dev)
          if sums else None)
    fn = kbuild.function("grid_me", "tpuhevc_grid_coarse",
                         [kbuild.P] * 4 + [kbuild.I] * 5 + [kbuild.P])
    err = fn(cur.data_ptr(), refp.data_ptr(), sad.data_ptr(),
             sm.data_ptr() if sums else None, h, w, n, tile, shift,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_coarse")
    LAUNCHES["grid_coarse"] += 1
    return sad, sm


def grid_prestage_plain(cur: torch.Tensor, refp: torch.Tensor, n: int,
                        tile: int, shift: int, bits: torch.Tensor,
                        lam_me: int) -> torch.Tensor:
    """cur (h, w), refp (h+n-1, w+n-1) int32 as `grid_coarse_plain`, bits
    (n*n,) the offsets' MV bits -> (h/tile, w/tile) int32: per block the
    first index k of the least (sad << shift) + ((bits[k] * lam_me) >> 8)
    (the stack, the bits, then `torch.argmin`)."""
    h, w = cur.shape
    sad, _ = grid_coarse_plain(cur, refp, n, tile, shift, False)
    cost = sad + ((bits.long()[:, None, None] * lam_me) >> 8)
    return torch.argmin(cost.reshape(n * n, -1), dim=0).reshape(
        h // tile, w // tile).int()


def grid_prestage(cur: torch.Tensor, refp: torch.Tensor, n: int, tile: int,
                  shift: int, bits: torch.Tensor,
                  lam_me: int) -> torch.Tensor:
    """Kernel `grid_prestage` (see `grid_prestage_plain`). CPU tensors take
    the plain version; CUDA tensors the kernel (tile 4, the 4x-pooled
    level's; bits int32 on the card, every cost below 2^31)."""
    if cur.device.type == "cpu":
        return grid_prestage_plain(cur, refp, n, tile, shift, bits, lam_me)
    if cur.device.type != "cuda":
        raise ValueError(f"grid_prestage: unsupported device {cur.device}")
    dev = cur.device
    h, w = _coarse_shapes("grid_prestage", cur, refp, n, tile, (4,))
    check_tensor(bits, "bits", torch.int32, 1, dev)
    if bits.shape[0] != n * n or lam_me < 0:
        raise ValueError(f"grid_prestage: bits {tuple(bits.shape)}, n {n}, "
                         f"lam_me {lam_me}")
    barg = torch.empty((h // tile, w // tile), dtype=torch.int32, device=dev)
    fn = kbuild.function("grid_me", "tpuhevc_grid_prestage",
                         [kbuild.P] * 4 + [kbuild.I] * 6 + [kbuild.P])
    err = fn(cur.data_ptr(), refp.data_ptr(), bits.data_ptr(),
             barg.data_ptr(), h, w, n, tile, shift, int(lam_me),
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_prestage")
    LAUNCHES["grid_prestage"] += 1
    return barg


def _pick(sad, cost, mvx, mvy, lim):
    """First-index argmin over (nb, G*49) candidates -> mv, sad9, cost,
    the winner's index."""
    bi = torch.argmin(cost, dim=1)
    bdy = (bi % 49) // 7
    bdx = bi % 7
    mv = torch.stack([mvx.gather(1, bi[:, None])[:, 0],
                      mvy.gather(1, bi[:, None])[:, 0]], dim=-1)
    base = (bi // 49) * 49
    oy = torch.tensor([-1, -1, -1, 0, 0, 0, 1, 1, 1], device=cost.device)
    ox = torch.tensor([-1, 0, 1] * 3, device=cost.device)
    idx9 = base[:, None] + (bdy[:, None] + oy[None]) * 7 + bdx[:, None] + ox
    sad9 = sad.gather(1, idx9)
    best = cost.gather(1, bi[:, None])[:, 0]
    return mv.clamp(-lim, lim).int(), sad9.int(), best.int(), bi


def _refine_plain(ry, oy, S, nbh, nbw, starts, sref, radd, quads, dcc,
                  dcc8, lam_me, lim, ry_y0):
    """ry (R', hr, W) int32; sref (G,) int64 each start's plane; radd (G,)
    the cost added to each start's candidates -> ((mv, sad9, cost, ref),
    quads' or None)."""
    dev = ry.device
    _, hr, wr = ry.shape
    G, nb = starts.shape[0], nbh * nbw
    win = S + 6
    ar = torch.arange(win, device=dev)
    bx = (torch.arange(nbw, device=dev) * S).repeat(nbh)
    by = (torch.arange(nbh, device=dev) * S).repeat_interleave(nbw)
    cx, cy = starts[..., 0].long(), starts[..., 1].long()
    yy = (by[None, :, None] + cy[..., None] - 3 + ry_y0 + ar).clamp(0, hr - 1)
    xx = (bx[None, :, None] + cx[..., None] - 3 + ar).clamp(0, wr - 1)
    wnd = ry.reshape(-1)[(sref[:, None, None, None] * hr + yy[..., :, None])
                         * wr + xx[..., None, :]]
    cur = (oy[: nbh * S, : nbw * S].reshape(nbh, S, nbw, S)
           .permute(0, 2, 1, 3).reshape(nb, S, S))
    sl = wnd.unfold(2, S, 1).unfold(3, S, 1)  # (G, nb, 7, 7, S, S)
    d = (sl - cur[None, :, None, None]).reshape(G, nb, 49, S, S)
    f = S // 8
    if quads:
        dq = d.reshape(G, nb, 49, f, 8, f, 8)
        sadq = dq.abs().sum(dim=(4, 6)).reshape(G, nb, 49, f * f)
        sumq = dq.sum(dim=(4, 6)).reshape(G, nb, 49, f * f)
        sad, sm = sadq.sum(-1), sumq.sum(-1)
    else:
        sad, sm = d.abs().sum(dim=(3, 4)), d.sum(dim=(3, 4))
    k = torch.arange(49, device=dev)
    rdx, rdy = k % 7 - 3, k // 7 - 3
    mvx = cx[..., None] + rdx  # (G, nb, 49)
    mvy = cy[..., None] + rdy
    babs = (2 * ceil_log2_odd((mvx * 4).abs())
            + 2 * ceil_log2_odd((mvy * 4).abs()) + 2)
    rate = (babs * lam_me) >> 8
    inner = ((rdx.abs() <= 2) & (rdy.abs() <= 2))[None, None]
    radd = radd.long()[:, None, None]
    cost = torch.where(inner, zcost(sad, sm, dcc) + rate,
                       torch.full_like(sad, BIG)) + radd

    def flat(x):  # (G, nb, 49) -> (nb, G*49), start-major
        return x.permute(1, 0, 2).reshape(nb, G * 49)

    def pick(sad_, cost_):
        mv, sad9, best, bi = _pick(flat(sad_), flat(cost_), fx, fy, lim)
        return mv, sad9, best, sref[bi // 49].int()

    fx, fy = flat(mvx), flat(mvy)
    main = pick(sad, cost)
    if not quads:
        return main, None
    costq = torch.where(inner[..., None], zcost(sadq, sumq, dcc8)
                        + rate[..., None], torch.full_like(sadq, BIG))
    picks = [pick(sadq[..., q], costq[..., q] + radd) for q in range(4)]

    def to8(xs):
        x = torch.stack(xs, 1)
        tail = tuple(x.shape[2:])
        x = x.reshape((nbh, nbw, 2, 2) + tail).permute(
            (0, 2, 1, 3) + tuple(4 + i for i in range(len(tail))))
        return x.reshape((nbh * 2 * nbw * 2,) + tail).contiguous()

    quad = tuple(to8([p[i] for p in picks]) for i in range(4))
    return main, quad


def grid_refine_refs_plain(ry: torch.Tensor, oy: torch.Tensor, S: int,
                           nbh: int, nbw: int, starts: torch.Tensor,
                           quads: bool, dcc: int, dcc8: int, lam_me: int,
                           lim: int, ry_y0: int = 0, sref=None, rbits=None):
    """ry (R', hr, W) int32 a reference stack, oy (H, W) int32; starts (G,
    nb, 2) int32 full-pel centres in reference-major order; sref (G,)
    int32 each start's plane of ry (None: plane 0); rbits (R,) int32 the
    reference bits, or None (one reference: none added) -> ((mv (nb, 2),
    sad9 (nb, 9), cost (nb,), ref (nb,)), the same per 8x8 quadrant in
    8-grid order (4 nb rows) with quads, else None): the first index over
    the G x 49 candidates of cost + ((rbits[ref] * lam_me) >> 8)."""
    G = starts.shape[0]
    sref = (torch.zeros(G, dtype=torch.long, device=ry.device)
            if sref is None else sref.long())
    radd = (torch.zeros_like(sref) if rbits is None
            else (rbits.long()[sref] * lam_me) >> 8)
    return _refine_plain(ry, oy, S, nbh, nbw, starts, sref, radd, quads, dcc,
                         dcc8, lam_me, lim, ry_y0)


def grid_refine_plain(ry: torch.Tensor, oy: torch.Tensor, S: int, nbh: int,
                      nbw: int, starts: torch.Tensor, quads: bool, dcc: int,
                      dcc8: int, lam_me: int, lim: int, ry_y0: int = 0):
    """ry (hr, W), oy (H, W) int32; starts (G, nb, 2) int32 full-pel
    centres; ry_y0 the row of ry level with oy's row 0 ->
    (mv (nb, 2), sad9 (nb, 9), cost (nb,)) and, with quads, the same
    triple per 8x8 quadrant in 8-grid order (4 nb rows), else None."""
    main, quad = grid_refine_refs_plain(ry[None], oy, S, nbh, nbw, starts,
                                        quads, dcc, dcc8, lam_me, lim, ry_y0)
    return main[:3], None if quad is None else quad[:3]


# per (device, stream): the candidates' scratch and the tickets of a
# launch whose picture blocks are split over several CUDA blocks; a
# launch on another stream of the device has its own, so that two launches
# in flight at once never share them
_SCRATCH: dict = {}
# (device index, S, nb, G, quads) -> starts a CUDA block
_GPB: dict = {}
_REFINE_ARGS = [kbuild.P] * 11 + [kbuild.I] * 14 + [kbuild.P]


def _starts_a_block(di: int, S: int, nb: int, G: int, quads: bool) -> int:
    """Starts a CUDA block: split until two blocks an SM are in flight,
    and within the 48 KB of shared memory a launch may take."""
    key = (di, S, nb, G, quads)
    gpb = _GPB.get(key)
    if gpb is not None:
        return gpb
    sms = torch.cuda.get_device_properties(di).multi_processor_count
    gpb = G
    while gpb > 1 and nb * -(-G // gpb) < 2 * sms:
        gpb = -(-gpb // 2)
    while True:
        smem = 2 * (S * (S + 8) + gpb * (S + 6) * (S + 8))
        if gpb == G:
            smem += 4 * (10 if quads else 2) * G * 49
        if smem <= 48 * 1024 or gpb == 1:
            _GPB[key] = gpb
            return gpb
        gpb = -(-gpb // 2)


def grid_refine_refs(ry: torch.Tensor, oy: torch.Tensor, S: int, nbh: int,
                     nbw: int, starts: torch.Tensor, quads: bool, dcc: int,
                     dcc8: int, lam_me: int, lim: int, ry_y0: int = 0,
                     sref=None, rbits=None):
    """Kernel `grid_refine` over every reference in one launch (see
    `grid_refine_refs_plain`). CPU tensors take the plain version; CUDA
    tensors the kernel. sref's values must index ry's planes."""
    if ry.device.type == "cpu":
        return grid_refine_refs_plain(ry, oy, S, nbh, nbw, starts, quads,
                                      dcc, dcc8, lam_me, lim, ry_y0, sref,
                                      rbits)
    if ry.device.type != "cuda":
        raise ValueError(f"grid_refine: unsupported device {ry.device}")
    dev = ry.device
    di = dev.index
    i32 = torch.int32
    if not (_on(ry, i32, di, 3) and _on(oy, i32, di, 2)
            and _on(starts, i32, di, 3)
            and (sref is None or _on(sref, i32, di, 1))
            and (rbits is None or _on(rbits, i32, di, 1))):
        raise ValueError("grid_refine: ry, oy, starts, sref and rbits must "
                         f"be contiguous int32 on {dev} (3, 2, 3, 1, 1 "
                         "dimensions)")
    G, nb = starts.shape[0], nbh * nbw
    if (starts.shape[1:] != (nb, 2) or S not in (8, 16, 32)
            or not 0 < G <= MAX_STARTS or (quads and S != 16)
            or (sref is not None and sref.shape[0] != G)):
        raise ValueError(f"grid_refine: S {S}, starts {tuple(starts.shape)}, "
                         f"sref {None if sref is None else tuple(sref.shape)}")
    if oy.shape[0] < nbh * S or oy.shape[1] < nbw * S:
        raise ValueError(f"grid_refine: oy {tuple(oy.shape)} < blocks")
    if not 0 <= ry_y0 < ry.shape[1]:
        raise ValueError(f"grid_refine: ry_y0 {ry_y0}, ry "
                         f"{tuple(ry.shape)}")
    nq = 4 if quads else 0
    n = nb * (1 + nq)
    mv, sad9, cost, ref = torch.empty(n * 13, dtype=i32, device=dev).split(
        [2 * n, 9 * n, n, n])
    mv, sad9 = mv.view(n, 2), sad9.view(n, 9)
    gpb = _starts_a_block(di, S, nb, G, quads)
    stream = torch._C._cuda_getCurrentRawStream(di)
    cand = tickets = None
    if gpb < G:
        need = (10 if quads else 2) * nb * G * 49
        cand, tickets = _SCRATCH.get((di, stream), (None, None))
        if cand is None or cand.numel() < need or tickets.numel() < nb:
            cand = torch.empty(need, dtype=i32, device=dev)
            tickets = torch.zeros(nb, dtype=i32, device=dev)
            _SCRATCH[di, stream] = (cand, tickets)
    fn = kbuild.function("grid_me", "tpuhevc_grid_refine", _REFINE_ARGS)
    err = fn(ry.data_ptr(), oy.data_ptr(), starts.data_ptr(),
             None if sref is None else sref.data_ptr(),
             None if rbits is None else rbits.data_ptr(), mv.data_ptr(),
             sad9.data_ptr(), cost.data_ptr(), ref.data_ptr(),
             None if cand is None else cand.data_ptr(),
             None if tickets is None else tickets.data_ptr(), ry.shape[1],
             ry.shape[2], oy.shape[1], S, nbh, nbw, G, gpb, int(quads), dcc,
             dcc8, lam_me, lim, ry_y0, stream)
    kbuild.check(err, "grid_refine")
    LAUNCHES["grid_refine"] += 1
    main = (mv[:nb], sad9[:nb], cost[:nb], ref[:nb])
    if not quads:
        return main, None
    return main, (mv[nb:], sad9[nb:], cost[nb:], ref[nb:])


def grid_refine(ry: torch.Tensor, oy: torch.Tensor, S: int, nbh: int,
                nbw: int, starts: torch.Tensor, quads: bool, dcc: int,
                dcc8: int, lam_me: int, lim: int, ry_y0: int = 0):
    """Kernel `grid_refine` on one reference plane ry (hr, W): the
    one-reference case of `grid_refine_refs` (no reference bits). CPU
    tensors take the plain version; CUDA tensors the kernel."""
    if ry.device.type == "cpu":
        return grid_refine_plain(ry, oy, S, nbh, nbw, starts, quads, dcc,
                                 dcc8, lam_me, lim, ry_y0)
    if ry.dim() != 2:
        raise ValueError(f"grid_refine: ry {tuple(ry.shape)} is no plane")
    main, quad = grid_refine_refs(ry[None], oy, S, nbh, nbw, starts, quads,
                                  dcc, dcc8, lam_me, lim, ry_y0)
    return main[:3], None if quad is None else quad[:3]


def grid_wp_me_plain(ref: torch.Tensor, w: torch.Tensor, o: torch.Tensor,
                     d: int) -> torch.Tensor:
    """ref (n, h, w) int32, w and o (n,) int32 -> (n, h, w) int32."""
    rnd = (1 << d) >> 1
    return (((ref * w[:, None, None] + rnd) >> d)
            + o[:, None, None]).clamp(0, 255)


def grid_wp_me(ref: torch.Tensor, w: torch.Tensor, o: torch.Tensor,
               d: int) -> torch.Tensor:
    """Kernel `grid_wp_me`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if ref.device.type == "cpu":
        return grid_wp_me_plain(ref, w, o, d)
    if ref.device.type != "cuda":
        raise ValueError(f"grid_wp_me: unsupported device {ref.device}")
    dev = ref.device
    check_tensor(ref, "ref", torch.int32, 3, dev)
    check_tensor(w, "w", torch.int32, 1, dev)
    check_tensor(o, "o", torch.int32, 1, dev)
    n, h, wd = ref.shape
    if w.shape[0] != n or o.shape[0] != n or not 0 <= d < 31 or wd % 16:
        raise ValueError(f"grid_wp_me: ref {tuple(ref.shape)} (rows of whole "
                         f"16-sample runs), w {tuple(w.shape)}, o "
                         f"{tuple(o.shape)}, d {d}")
    if ref.data_ptr() % 16:  # the kernel moves runs of 16 bytes
        raise ValueError("grid_wp_me: ref's data is not 16-byte aligned")
    out = torch.empty_like(ref)
    fn = kbuild.function("grid_me", "tpuhevc_grid_wp_me",
                         [kbuild.P] * 4 + [kbuild.I] * 4 + [kbuild.P])
    err = fn(ref.data_ptr(), w.data_ptr(), o.data_ptr(), out.data_ptr(), n,
             h, wd, int(d), torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "grid_wp_me")
    LAUNCHES["grid_wp_me"] += 1
    return out
