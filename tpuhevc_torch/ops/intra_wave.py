"""Fixed-8x8 intra coding of whole pictures over dependency wavefronts
(kernel `intra_wave`).

Twin of `step` (`tpuhevc/codec/intra_jax.py:205-281`) scanned over the
waves of `build_frame_encoder` (182-314), batched over frames as
`encode_frames_intra_jax_batch` vmaps it (317-369). Per wave, for each of
its 8x8 cells, from the recon of the earlier waves: gather and substitute
the 33 luma references, predict all 35 modes
(`ops/intra.py:predict_all_modes_plain`, the 8x8 filtering), price each by
the 8x8 Hadamard SATD `(sum|H d H^T| + 2) >> 2` plus `(bits * sqlam_fp) >>
8` (bits 2 inside the MPM list, 6 outside), take the first mode of least
cost, then DCT, the flat intra quantiser, dequantiser and IDCT
(`ops/transforms.py`), keeping the prediction where no level is non-zero;
chroma the same on 4x4 blocks with the luma mode (DM) at the chroma QP.
All integer, exact: the integer products are taken in int64 as
broadcast-multiply-sums (`ops/cost.py:wht`, `ops/transforms.py:_mm`), which
CUDA computes exactly too.

`intra_wave_plain` is the PyTorch version, wave by wave; `intra_wave`
launches the CUDA kernel (`kernels/csrc/intra_wave.cu`, one launch for
all frames) for CUDA tensors, at bit depth 8 or 10 (counted as
`intra_wave10`: the kernel's `BD = 10` instantiation), in one of two
variants that `wave_variant` picks from the shared memory each needs: the
recon planes and mode map kept on chip where they fit (at 8 bits 416x240,
in a cluster of 4 blocks a frame, and 192x128, one block; at 10 bits, two
bytes a plane sample, 104x72 and 192x128 one block a frame, 256x240 a
cluster of 4), else in device memory (8-bit
832x480 and 1920x1088; 10-bit 416x240 and larger). `WaveTables` is the
geometry both read, built by `codec/intra_frame.py` from the reference's
schedule.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..utils.tables import chroma_qp, dct_matrix
from . import transforms as tx
from .cost import satd35_plain
from .intra import intra_tables, predict_all_modes_plain

_INIT_DEVICES: set = set()
SMEM_LIMIT = 232448  # the shared memory a block can opt into (bytes)
# blocks a frame (a thread block cluster) where the recon is on chip and
# a wave holds at least CLUSTER_CELLS cells on average: each block runs
# every cell's references and coding and a share of the 35-mode costs; the
# cluster's barrier costs more than the share saves on fewer cells
CLUSTER, CLUSTER_CELLS = 4, 5
# the kernel's shared words: fixed (the DCT matrices and their
# transposes, the reference substitution tables) and per slot of
# a wave (org double buffer, references, DC and MPM, transform scratch,
# slot ring), as `kernels/csrc/intra_wave.cu` lays them out
_FIXED_WORDS = 560
_CELL_WORDS = 2 * 96 + 68 + 36 + 8 + 192 + 3


def wave_smem(w: int, h: int, bmax: int, on_chip: bool,
              bit_depth: int) -> int:
    """Shared memory (bytes) of one block of kernel `intra_wave` for w x h
    pictures and waves of bmax cells; on_chip adds the recon planes (a
    byte a sample at bit depth 8, two at 10) and the mode map (a byte a
    cell) (`tpuhevc_intra_wave_smem`)."""
    pel = 2 if bit_depth > 8 else 1
    planes = pel * 3 * w * h // 2 + (w // 8) * (h // 8) if on_chip else 0
    return 4 * (_FIXED_WORDS + _CELL_WORDS * bmax) + planes


def wave_variant(w: int, h: int, steps: int, bmax: int,
                 bit_depth: int) -> tuple[bool, int, int]:
    """(on_chip, cluster, shared bytes) of the kernel that runs w x h
    pictures of `steps` waves of at most bmax cells at `bit_depth`: the
    recon on chip where it fits, in clusters of CLUSTER blocks a frame
    where the waves hold CLUSTER_CELLS cells or more on average, else in
    device memory; raises where neither fits."""
    for on_chip in (True, False):
        smem = wave_smem(w, h, bmax, on_chip, bit_depth)
        if smem <= SMEM_LIMIT:
            many = (w // 8) * (h // 8) >= CLUSTER_CELLS * steps
            return on_chip, CLUSTER if on_chip and many else 1, smem
    raise ValueError(f"intra_wave: waves of {bmax} cells need "
                     f"{wave_smem(w, h, bmax, False, bit_depth)} bytes of "
                     "shared memory")


@dataclass(frozen=True)
class WaveTables:
    """The wave schedule of one coded size on one device: `counts` (host)
    the cells of each wave, which fill its first slots; `cells` (S, B) the
    flat cell index y8 * W8 + x8, -1 in an empty slot; `flags` (S, B) bits
    0-4 the availability of the [lb, l, c, t, tr] reference segments, bit
    5 the left MPM neighbour, bit 6 the above one; `slots` (S, B) what
    the kernel reads, x8 | y8 << 12 | flags << 24, -1 in an empty slot;
    and the reference's gather indices (the plain version reads them):
    `avail` (S, B, 5) bool, `ml_i`/`ma_i` (S, B) the MPM
    neighbours' flat cells, `y_seg` (S, B, 33), `y_blk` (S, B, 64),
    `c_seg` (S, B, 17), `c_blk` (S, B, 16) flat plane indices."""

    counts: tuple
    cells: torch.Tensor
    flags: torch.Tensor
    slots: torch.Tensor
    avail: torch.Tensor
    ml_i: torch.Tensor
    ma_i: torch.Tensor
    y_seg: torch.Tensor
    y_blk: torch.Tensor
    c_seg: torch.Tensor
    c_blk: torch.Tensor

    @property
    def ml_ok(self) -> torch.Tensor:
        return (self.flags >> 5) & 1 == 1

    @property
    def ma_ok(self) -> torch.Tensor:
        return (self.flags >> 6) & 1 == 1


def _code_blocks(org, pred, qp: int, log2: int, bd: int):
    """Residual, transform, flat intra quantiser and the recon of (N, S, S)
    blocks -> (levels, recon)."""
    lvl = tx.quantize(tx.forward_transform(org - pred, bd), qp, log2, bd,
                      True)
    cbf = (lvl != 0).flatten(1).any(-1)
    r = tx.inverse_transform(tx.dequantize(lvl, qp, log2, bd), bd)
    rec = (pred + r).clamp(0, (1 << bd) - 1)
    return lvl, torch.where(cbf[:, None, None], rec, pred).int()


def intra_wave_plain(oy, ou, ov, geo: WaveTables, qp: int, sqlam_fp: int,
                     strong_smoothing: bool = True, bit_depth: int = 8):
    """oy (F, H, W), ou, ov (F, H/2, W/2) int32 -> (rec_y, rec_u, rec_v,
    modes (F, H/8, W/8), coeff_y, coeff_cb, coeff_cr), int32, the
    reference's outputs per frame."""
    from ..codec.intra_frame import _mpm_cands, _substitute

    F, h, w = oy.shape
    dev, bd = oy.device, bit_depth
    mid = 1 << (bd - 1)
    qpc = chroma_qp(qp)
    ny, nc = h * w, h * w // 4
    ry = torch.zeros((F, ny), dtype=torch.int32, device=dev)
    cy = torch.zeros_like(ry)
    rc = [torch.zeros((F, nc), dtype=torch.int32, device=dev)
          for _ in range(2)]
    cc = [torch.zeros_like(rc[0]) for _ in range(2)]
    modes = torch.zeros((F, ny // 64), dtype=torch.int32, device=dev)
    oyf = oy.reshape(F, ny)
    ocf = [ou.reshape(F, nc), ov.reshape(F, nc)]
    ml_ok, ma_ok = geo.ml_ok, geo.ma_ok
    mode_ids = torch.arange(35, device=dev)[None, :, None]

    def refs(plane, seg, av, s):
        raw = plane[:, seg].reshape(-1, seg.shape[-1])
        lb, l, c, t, tr = _substitute(raw, av, s, mid)
        return (torch.cat([c, t, tr], -1),
                torch.cat([c, l.flip(-1), lb.flip(-1)], -1))

    for s, n in enumerate(geo.counts):
        av = geo.avail[s, :n].repeat(F, 1)  # frame-major (F * n, 5)
        top, left = refs(ry, geo.y_seg[s, :n], av, 8)
        preds = predict_all_modes_plain(top, left, 8, True, bd,
                                        strong_smoothing)
        yblk = geo.y_blk[s, :n].reshape(-1)
        org = oyf[:, yblk].reshape(F * n, 8, 8)
        sat = satd35_plain(org, preds)
        lm = torch.where(ml_ok[s, :n], modes[:, geo.ml_i[s, :n]], 1)
        am = torch.where(ma_ok[s, :n], modes[:, geo.ma_i[s, :n]], 1)
        cands = _mpm_cands(lm.reshape(-1), am.reshape(-1))
        bits = torch.where((mode_ids == cands[:, None, :]).any(-1), 2, 6)
        mode = (sat + ((bits * sqlam_fp) >> 8)).argmin(-1)
        rows = torch.arange(F * n, device=dev)
        lvl, rec = _code_blocks(org, preds[rows, mode], qp, 3, bd)
        ry[:, yblk] = rec.reshape(F, -1)
        cy[:, yblk] = lvl.reshape(F, -1)
        modes[:, geo.cells[s, :n].long()] = mode.reshape(F, n).int()
        cblk = geo.c_blk[s, :n].reshape(-1)
        for p in range(2):
            ctop, cleft = refs(rc[p], geo.c_seg[s, :n], av, 4)
            cpred = predict_all_modes_plain(ctop, cleft, 4, False, bd,
                                            False)[rows, mode]
            corg = ocf[p][:, cblk].reshape(F * n, 4, 4)
            clvl, crec = _code_blocks(corg, cpred, qpc, 2, bd)
            rc[p][:, cblk] = crec.reshape(F, -1)
            cc[p][:, cblk] = clvl.reshape(F, -1)
    return (ry.reshape(F, h, w), rc[0].reshape(F, h // 2, w // 2),
            rc[1].reshape(F, h // 2, w // 2),
            modes.reshape(F, h // 8, w // 8), cy.reshape(F, h, w),
            cc[0].reshape(F, h // 2, w // 2), cc[1].reshape(F, h // 2, w // 2))


def table_arrays():
    """The kernel's constant tables (host int32): the intra tables
    (`ops/intra.py:intra_tables`) and the 32x32 DCT matrix."""
    return (*intra_tables(), np.ascontiguousarray(dct_matrix(32), np.int32))


def _init_tables(dev: torch.device) -> None:
    """Copy the tables into the kernel's constant memory, once a device."""
    if dev.index in _INIT_DEVICES:
        return
    fn = kbuild.function("intra_wave", "tpuhevc_intra_wave_init",
                         [kbuild.P] * 4)
    with torch.cuda.device(dev):
        kbuild.check(fn(*(a.ctypes.data_as(ctypes.c_void_p)
                          for a in table_arrays())), "intra_wave init")
    _INIT_DEVICES.add(dev.index)


def launch(fn, planes, geo: WaveTables, outs, qp: int, sqlam_fp: int,
           on_chip: bool, cluster: int, bit_depth: int) -> int:
    """Call the entry point `fn` (`tpuhevc_intra_wave`) on the planes
    (oy, ou, ov) into the seven outputs, the recon on chip or not, in
    clusters of `cluster` blocks a frame, at `bit_depth`; returns its CUDA
    error."""
    F, h, w = planes[0].shape
    steps, bmax = geo.slots.shape
    qpc, bd = chroma_qp(qp), bit_depth
    q = (*tx.quant_params(qp, 3, bd), *tx.dequant_params(qp, 3, bd),
         *tx.quant_params(qpc, 2, bd), *tx.dequant_params(qpc, 2, bd))
    return fn(*(p.data_ptr() for p in planes), geo.slots.data_ptr(),
              *(o.data_ptr() for o in outs), F, w, h, steps, bmax,
              int(on_chip), cluster, *q, sqlam_fp, bd,
              torch.cuda.current_stream(planes[0].device).cuda_stream)


ARGS = [kbuild.P] * 11 + [kbuild.I] * 18 + [kbuild.P]


def intra_wave(oy, ou, ov, geo: WaveTables, qp: int, sqlam_fp: int,
               strong_smoothing: bool = True, *, bit_depth: int):
    """Kernel `intra_wave`: one launch for the F frames at bit depth 8 or
    10 (the caller names it; counted as `intra_wave10` at 10), any other
    depth raises. CPU tensors take the plain version; CUDA tensors the kernel."""
    if bit_depth not in (8, 10):
        raise ValueError(f"intra_wave: bit depth {bit_depth} (8 or 10)")
    if oy.device.type == "cpu":
        return intra_wave_plain(oy, ou, ov, geo, qp, sqlam_fp,
                                strong_smoothing, bit_depth)
    if oy.device.type != "cuda":
        raise ValueError(f"intra_wave: unsupported device {oy.device}")
    dev = oy.device
    check_tensor(oy, "oy", torch.int32, 3, dev)
    check_tensor(ou, "ou", torch.int32, 3, dev)
    check_tensor(ov, "ov", torch.int32, 3, dev)
    check_tensor(geo.slots, "slots", torch.int32, 2, dev)
    F, h, w = oy.shape
    steps, bmax = geo.slots.shape
    if (w % 8 or h % 8 or tuple(ou.shape) != (F, h // 2, w // 2)
            or ov.shape != ou.shape):
        raise ValueError(f"intra_wave: unsupported shapes oy {tuple(oy.shape)}"
                         f" ou {tuple(ou.shape)} ov {tuple(ov.shape)}")
    if any(p.data_ptr() % 16 for p in (oy, ou, ov)):
        raise ValueError("intra_wave: a plane's data is not 16-byte aligned")
    outs = [torch.empty((F, h >> s, w >> s), dtype=torch.int32, device=dev)
            for s in (0, 1, 1)]
    outs.append(torch.empty((F, h // 8, w // 8), dtype=torch.int32,
                            device=dev))
    outs += [torch.empty_like(o) for o in outs[:3]]
    if F == 0:
        return tuple(outs)
    on_chip, cluster, _ = wave_variant(w, h, steps, bmax, bit_depth)
    _init_tables(dev)
    fn = kbuild.function("intra_wave", "tpuhevc_intra_wave", ARGS)
    kbuild.check(launch(fn, (oy, ou, ov), geo, outs, qp, sqlam_fp, on_chip,
                        cluster, bit_depth), "intra_wave")
    LAUNCHES["intra_wave" if bit_depth == 8 else "intra_wave10"] += 1
    return tuple(outs)
