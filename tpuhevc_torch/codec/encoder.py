"""Encode loops of the port: all-intra Main (IntraPeriod 1) and LD-P.

All-intra: every picture through the port's quadtree intra decision on
the device (`codec/intra_qt.py`), then tpuhevc's coding walk, in-loop
filters and CABAC (`Encoder.encode_frame`); the twin of the last branch
of `tpuhevc/codec/encoder.py:encode_sequence` with the JAX decision.

LD-P: the IDR the same way (decided twice, `intra_two_pass`), then chunks
of P frames through the device scan, host serialisation of chunk i-1
overlapped with the device work of chunk i. Twin of the non-grid half of
`tpuhevc/codec/encoder.py:737-942` (`LdpScanDriver`,
`_ldp_scan_pipelined`) and of the LD-P branch of its `encode_sequence`.
It reuses `tpuhevc.codec.encoder.Encoder` for headers, CABAC and NAL
packing, and `tpuhevc.codec.inter_batch.collect_frame` plus
`tpuhevc.codec.inter_enc.assemble_frame_p` for the decision walk. Until
the grid step is ported, every picture size takes this scan.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tpuhevc.codec.encoder import Encoder
from tpuhevc.codec.inter_batch import collect_frame
from tpuhevc.codec.inter_enc import assemble_frame_p
from tpuhevc.codec.params import EncoderConfig
from tpuhevc.codec.recon import _pad_to

from ..device import resolve
from .inter_batch import build_ldp_scan
from .intra_qt import encode_frame_intra_qt

# The port passes its own frame encoder for I pictures; anything but "jax"
# keeps tpuhevc from selecting one of its JAX stages anywhere else.
INTER_BACKEND = "torch"


def check_slice(cfg: EncoderConfig) -> None:
    """Raise NotImplementedError for any configuration outside the ported
    slices: all-intra (IntraPeriod 1) with tpuhevc's host tools after the
    decision, or LD-P with NN-FME or integer-pel and those tools off; both
    8-bit, quadtree intra, one slice."""
    sps, pps = cfg.sps, cfg.pps
    off = [
        (cfg.target_bitrate > 0, "rate control"),
        (sps.bit_depth != 8, f"bit depth {sps.bit_depth}"),
        (sps.scaling_list_enabled, "scaling lists"),
        (not cfg.intra_qt, "fixed 8x8 intra"),
        (cfg.adaptive_qp or cfg.ctu_qp_map is not None, "adaptive QP"),
        (pps.tiles_enabled or pps.entropy_coding_sync or cfg.slice_ctus > 0,
         "tiles, wavefronts or multiple slices"),
    ]
    if cfg.intra_period != 1:  # LD-P
        off += [
            (cfg.rdoq, "RDOQ"),
            (pps.sign_data_hiding, "sign-bit hiding"),
            (cfg.deblocking, "deblocking"),
            (sps.sao_enabled, "SAO"),
            (cfg.fme_mode not in ("nn", "none"), f"FmeMode {cfg.fme_mode}"),
            (cfg.gop_structure != "ldp" or bool(cfg.gop_table),
             "random access / B pictures"),
            (cfg.intra_period != -1, f"IntraPeriod {cfg.intra_period}"),
            (cfg.intra_in_inter, "intra CUs in P pictures"),
            (pps.weighted_pred, "weighted prediction"),
        ]
    bad = [name for cond, name in off if cond]
    if bad:
        raise NotImplementedError("not yet ported: " + ", ".join(bad))


class LdpScanDriver:
    """Chunked LD-P scan with explicit dispatch/collect halves.

    Protocol: start(); num_chunks() times { dispatch(ci); collect() } —
    dispatch enqueues the chunk's upload, kernels and the fetch of its
    packed rows into pinned memory without waiting; collect waits for the
    oldest chunk and serialises its frames via `finish`.
    """

    def __init__(self, enc, cfg, frames, finish, device,
                 chunk_frames: int = 8):
        self.enc, self.frames, self.finish = enc, frames, finish
        self.device = resolve(device)
        self.cuda = self.device.type == "cuda"
        sps = cfg.sps
        self.w, self.h = sps.coded_width, sps.coded_height
        offs = tuple(cfg.gop_qp_offsets) or (0,)
        self.G = len(offs)
        self.n_gops = max(1, chunk_frames // self.G)
        self.K = self.n_gops * self.G
        qps = set(min(max(cfg.qp + o, 0), 51) for o in offs)
        nn_by_qp = {qp: enc._nn_for_qp(qp) for qp in qps}
        self.cfg = cfg
        self.fn, _, _ = build_ldp_scan(cfg, nn_by_qp, self.n_gops,
                                       self.device)
        self.refs = None
        self.pending: list = []
        self.starts = list(range(0, len(frames) - 1, self.K))

    def num_chunks(self) -> int:
        return len(self.starts)

    def start(self) -> None:
        """Encode the leading IDR (decided on the device) and stage its
        recon."""
        self.finish(0, self.frames[0])
        self.refs = tuple(
            torch.from_numpy(np.ascontiguousarray(p, dtype=np.int32))
            .to(self.device) for p in self.enc.dpb_recon)

    def _chunk_u8(self, blk) -> np.ndarray:
        w, h = self.w, self.h
        rows = []
        for y, u, v in blk:
            rows.append(np.concatenate([
                _pad_to(np.asarray(y), h, w).astype(np.uint8).ravel(),
                _pad_to(np.asarray(u), h // 2, w // 2).astype(np.uint8).ravel(),
                _pad_to(np.asarray(v), h // 2, w // 2).astype(np.uint8).ravel(),
            ]))
        return np.stack(rows).reshape(self.n_gops, self.G, -1)

    def dispatch(self, ci: int) -> None:
        s = self.starts[ci]
        blk = self.frames[1:][s : s + self.K]
        nvalid = len(blk)
        blk = blk + [blk[-1]] * (self.K - nvalid)
        host = torch.from_numpy(self._chunk_u8(blk))
        if self.cuda:
            staged = torch.empty(host.shape, dtype=torch.uint8,
                                 pin_memory=True)
            staged.copy_(host)
            frames = staged.to(self.device, non_blocking=True)
        else:
            frames = host
        buf, *refs = self.fn(frames, *self.refs)
        self.refs = tuple(refs)
        done = None
        if self.cuda:
            rows = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            rows.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        else:
            rows = buf
        self.pending.append((s, nvalid, rows, done))

    def collect(self) -> None:
        """Serialise the oldest in-flight chunk (waits for its fetch)."""
        if not self.pending:
            return
        ps, pnv, rows, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        rows = rows.numpy()
        for j in range(pnv):
            poc = ps + 1 + j
            cfg_f = dataclasses.replace(self.cfg, qp=self.enc.frame_qp(poc))
            per_cu = collect_frame(cfg_f, rows[j])
            pre = assemble_frame_p(cfg_f, per_cu, 1, agglomerate=True)
            self.finish(poc, self.frames[poc], pre)


def _ldp_scan_pipelined(enc, cfg, frames, finish, device) -> None:
    drv = LdpScanDriver(enc, cfg, frames, finish, device)
    drv.start()
    for ci in range(drv.num_chunks()):
        drv.dispatch(ci)
        if ci > 0:  # serialise chunk ci-1 while chunk ci computes
            drv.collect()
    drv.collect()


def encode_sequence(reader, cfg: EncoderConfig, max_frames: int | None = None,
                    device="cuda"):
    """Encode frames read from `reader` (read_frame(i) -> (y, u, v) or
    None): every picture intra with IntraPeriod 1, else one IDR followed by
    P pictures. Returns (Encoder, recons), as
    `tpuhevc.codec.encoder.encode_sequence` does. `device` is explicit: a
    CUDA device that is absent raises, it never falls back to the CPU."""
    dev = resolve(device)
    check_slice(cfg)
    cfg = dataclasses.replace(cfg, inter_backend=INTER_BACKEND)
    enc = Encoder(cfg, frame_encoder=functools.partial(encode_frame_intra_qt,
                                                       device=dev))
    n = max_frames if max_frames is not None else cfg.frames
    frames = []
    for i in range(n):
        fr = reader.read_frame(i)
        if fr is None:
            break
        frames.append(fr)
    recons = []

    def _finish(i, fr, pre=None):
        enc.encode_frame(*fr, poc=i, precomputed=pre)
        recons.append(enc._recon)

    if cfg.intra_period == -1 and len(frames) > 1:
        _ldp_scan_pipelined(enc, cfg, frames, _finish, dev)
    else:
        for i, fr in enumerate(frames):
            _finish(i, fr)
    return enc, recons
