"""Encode loops of the port: all-intra Main (IntraPeriod 1), LD-P and
random access, and the per-picture `Encoder`.

All-intra: every picture through the port's quadtree intra decision on
the device (`codec/intra_qt.py`), then the host coding walk, in-loop
filters and CABAC (`Encoder.encode_frame`); the twin of the last branch
of `tpuhevc/codec/encoder.py:encode_sequence` with the JAX decision. With
fixed 8x8 intra (`intra_qt` off) each picture is coded whole on the device
(`codec/intra_frame.py`, kernel `intra_wave`), or with sign hiding on by
the host's closed loop (`recon.encode_frame_intra`); `device_batch` codes
batches of pictures in one launch each (the reference's branch at its
`encoder.py:518-527`), with sign hiding off only.

LD-P: the IDR the same way (decided twice, `intra_two_pass`), then chunks
of P frames through a device scan, host serialisation of chunk i-1
overlapped with the device work of chunk i: the grid step
(`codec/inter_grid.py`, multi-reference, TMVP granted in the SPS) where
`inter_grid.supports` holds (a coded size in whole 16x16 blocks; there
the anchor cfg runs as shipped, with RDOQ, sign hiding, deblocking and
SAO on the device, and with DCT-IF FME, explicit weighted prediction, or
the checksum hash without the recon fetch where the cfg asks for them),
the non-grid scan (`codec/inter_batch.py`) elsewhere, with RDOQ, sign
hiding, deblocking, SAO and DCT-IF off. Twin of
`tpuhevc/codec/encoder.py:737-942` (`LdpScanDriver`,
`_ldp_scan_pipelined`) and of the LD-P branch of its `encode_sequence`.

Every other LD-P configuration (those tools at a size the grid does not
take, IntraPeriod N, rate control) goes picture by picture, as the
reference's loop does: I pictures as above, P pictures through
`inter_enc.encode_frame_p` (the device stage with the tools off, the host
tool stage with RDOQ, sign hiding or DCT-IF on or a per-CTU QP map),
then the host's deblocking and SAO. Rate control (`_rate_controlled`,
`codec/ratectrl.py`) sets each picture's QP and lambda, and at CTU level
a QP map that cu_qp_delta signals.

Random access: the IDR the same way, every B picture through the device
B step (`codec/inter_b.py`, which hides signs where SignHideFlag is on),
and the P pictures through `encode_frame_p`, driven in decode order by
`_gop_table_driven` (a cfg GOP table of B pictures, the twin of
`tpuhevc/codec/encoder.py:606-682`) or by `_ra_gop4` (no table, 685-734);
deblocking and SAO on the host after each picture.

Main10 (bit depth 10): all-intra with the quadtree intra or fixed 8x8
intra (kernel `intra_wave`'s 10-bit variant, batched or a picture at a
time, or the host's closed loop where sign hiding is on) and LD-P off
the grid (the grid is 8-bit): the non-grid scan (its frames staged as
16-bit samples, its rows carrying 16-bit recon) and the per-picture
loop, each device stage at the kernels' 10-bit variants; random access
with its B pictures through the B step's 10-bit variants and its P
pictures through those routes; the IDR of either by the same intra
routes. Weighted prediction stays 8-bit (`check_slice`).

`Encoder`, `FrameResult`, `_rate_controlled`, `_ra_gop4` and
`_load_nn_params` are the port's copies of the reference's host code
(`encoder.py:27-490,564-603,685-734,945-962`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve
from ..entropy import bitio, headers, sei
from ..entropy.cabac import CabacEncoder, ContextSet
from ..entropy.headers import ShortTermRPS
from ..entropy.native import encode_slice_data_native, get_lib
from ..entropy.syntax import effective_qp_ctu, encode_slice_data
from ..ops.deblock import deblock_frame
from ..utils.yuv import picture_checksum, picture_crc, picture_md5, psnr
from . import inter_grid
from .inter_b import encode_frame_b
from .inter_batch import build_ldp_scan, collect_frame
from .inter_enc import assemble_frame_p, encode_frame_p
from .intra_frame import encode_frame_intra_device, encode_frames_intra_batch
from .intra_qt import encode_frame_intra_qt
from .params import (B_SLICE, I_SLICE, P_SLICE, EncoderConfig,
                     i_frame_lambda, p_frame_lambda)
from .ratectrl import CtuAlloc, RateControl
from .recon import _pad_to, encode_frame_intra
from .sao_enc import apply_sao_picture, decide_sao_params
from .wp import WpParams, analyse_slice_wp


@dataclass
class FrameResult:
    poc: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float
    md5: list = field(default_factory=list)
    seconds: float = 0.0


class Encoder:
    """Per-picture encoder: headers, the picture's analysis, in-loop
    filters, CABAC and NAL packing (the reference's `Encoder`,
    `tpuhevc/codec/encoder.py:38-490`, cut to the configurations
    `check_slice` admits). I pictures go through the quadtree intra
    decision on `device`, or with fixed 8x8 intra through the wavefront
    kernel on `device` (the reference's `encode_frame_intra_jax`) where
    sign hiding is off and the host's closed loop where it is on (the
    reference's choice at its `encoder.py:62-71`); P pictures without a
    precomputed result through `inter_enc.encode_frame_p` (the per-frame
    device stage, or the host tool stage)."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        self.cfg = cfg
        self.device = device
        cfg.pps.init_qp = cfg.qp
        cfg.pps.deblocking_disabled = not cfg.deblocking
        self.nals: list[bytes] = []
        self.first_of_au: list[bool] = []
        self.results: list[FrameResult] = []
        self._wrote_ps = False
        if cfg.intra_qt:
            self._frame_encoder = functools.partial(encode_frame_intra_qt,
                                                    device=device)
        elif not cfg.pps.sign_data_hiding:
            self._frame_encoder = functools.partial(
                encode_frame_intra_device, device=device)
        else:
            self._frame_encoder = encode_frame_intra
        self.dpb_recon = None  # previous frame recon (single-ref LD-P)
        self._nn_cache: dict = {}
        # rate control's picture QP and lambda (`_rate_controlled`)
        self._rc_qp = self._rc_lambda = None
        # end-of-slice context states of the last P slice per QP: the
        # grid step's adaptive bit-estimator feedback
        self.ctx_feedback: dict = {}
        self.nn_params = self._nn_for_qp(cfg.qp)
        # steady-state LD-P RPS published in the SPS; slices reference it
        # by index (TEncCavlc SPS RPS list) instead of re-coding it
        if cfg.intra_period == -1 and cfg.gop_structure == "ldp":
            n = max(1, cfg.num_ref_frames)
            self._sps_rps = [headers.ShortTermRPS(
                [-(i + 1) for i in range(n)], [1] * n)]
        else:
            self._sps_rps = []

    def _slice_type(self, poc: int) -> int:
        ip = self.cfg.intra_period
        if poc == 0 or ip == 1 or (ip > 0 and poc % ip == 0):
            return I_SLICE
        return P_SLICE

    def frame_qp(self, poc: int) -> int:
        cfg = self.cfg
        if self._rc_qp is not None:
            return self._rc_qp  # rate control owns the picture QP
        if self._slice_type(poc) == I_SLICE or not cfg.gop_qp_offsets:
            return cfg.qp
        off = cfg.gop_qp_offsets[(poc - 1) % len(cfg.gop_qp_offsets)]
        return min(max(cfg.qp + off, 0), 51)

    def _nn_for_qp(self, qp: int):
        """NN-FME weights for a frame. The reference selects the weight
        set ONCE from the base config QP (TEncSearch.cpp:472
        m_pcEncCfg->getQP()), NOT the per-frame QP — GOP QP offsets must
        not silently reroute every P frame to the QP22 fallback set."""
        if self.cfg.fme_mode != "nn":
            return None
        qp = self.cfg.qp
        if qp not in self._nn_cache:
            self._nn_cache[qp] = _load_nn_params(self.cfg)
        return self._nn_cache[qp]

    def _emit(self, nal: bytes, first_of_au: bool = False) -> None:
        self.nals.append(nal)
        self.first_of_au.append(first_of_au)

    def encode_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     poc: int, precomputed=None,
                     slice_info: dict | None = None) -> FrameResult:
        cfg, sps, pps = self.cfg, self.cfg.sps, self.cfg.pps
        t0 = time.time()
        if not self._wrote_ps:
            self._emit(bitio.make_nal(bitio.NAL_VPS, headers.write_vps(sps)))
            self._emit(bitio.make_nal(
                bitio.NAL_SPS, headers.write_sps(sps, self._sps_rps or None)))
            self._emit(bitio.make_nal(bitio.NAL_PPS, headers.write_pps(pps)))
            self._emit(bitio.make_nal(bitio.NAL_PREFIX_SEI, sei.write_sei_nal([
                sei.ActiveParameterSets(sps_ids=[0]),
                sei.UserDataUnregistered(data=b"tpuhevc"),
            ])))
            self._wrote_ps = True
        aus = []
        if slice_info is None and self._slice_type(poc) == I_SLICE \
                and poc > 0:
            aus.append(sei.RecoveryPoint(recovery_poc_cnt=0))
        if sps.vui_timing:
            aus.append(sei.PicTiming())
        if aus:
            self._emit(bitio.make_nal(bitio.NAL_PREFIX_SEI,
                                      sei.write_sei_nal(aus)))

        if slice_info is not None:
            stype = slice_info["stype"]
            fqp = slice_info["qp"]
        else:
            stype = self._slice_type(poc)
            fqp = self.frame_qp(poc)
        stats = None
        if precomputed is not None:
            fs, rec, stats = precomputed
            # stats: the recon stayed on the device
            ry, ru, rv = rec if stats is None else (None, None, None)
        elif stype == I_SLICE:
            # rate control may override the picture QP (frame_qp), so the
            # analysis must run at fqp, not the base cfg QP
            cfg_i = dataclasses.replace(cfg, qp=fqp) if fqp != cfg.qp else cfg
            fs, (ry, ru, rv) = self._frame_encoder(y, u, v, cfg_i)
        else:
            G = max(1, len(cfg.gop_qp_offsets))
            lam_f = (self._rc_lambda
                     or p_frame_lambda(cfg, (poc - 1) % G, fqp))
            cfg_f = dataclasses.replace(cfg, qp=fqp, frame_lambda=lam_f)
            fs, (ry, ru, rv) = encode_frame_p(
                (y, u, v), self.dpb_recon, cfg_f, self._nn_for_qp(fqp),
                device=self.device)
            if cfg_f.ctu_qp_map is not None:
                # CTU-level RC: signal the map via cu_qp_delta. CTUs
                # with no coded residual can't carry the delta — resolve
                # to the QPs the stream will actually convey so deblock
                # matches the decoder (effective_qp_ctu docstring).
                fs.qp_ctu = effective_qp_ctu(
                    fs, np.asarray(cfg_f.ctu_qp_map, np.int32), fqp,
                    sps.ctu_size, wpp=pps.entropy_coding_sync)

        # deblocking and SAO on the host (I pictures, B pictures and the
        # per-picture P pictures), but for the grid's P pictures, which
        # the device filtered (an all-off SAO decision included: the
        # reference decides SAO again on the host there, and then its
        # device references are not the decoder's)
        pre_f = getattr(fs, "prefiltered", False)
        if cfg.deblocking and not pre_f:
            ry, ru, rv = deblock_frame((ry, ru, rv), fs, fqp,
                                       stype == I_SLICE,
                                       bd=sps.bit_depth)
        if sps.sao_enabled and fs.sao is None and not pre_f:
            w_, h_ = sps.coded_width, sps.coded_height
            org = (_pad_to(np.asarray(y), h_, w_),
                   _pad_to(np.asarray(u), h_ // 2, w_ // 2),
                   _pad_to(np.asarray(v), h_ // 2, w_ // 2))
            if self._rc_lambda:
                lam_s = self._rc_lambda
            elif stype == I_SLICE:
                lam_s = i_frame_lambda(cfg, fqp)
            else:
                G = max(1, len(cfg.gop_qp_offsets))
                lam_s = p_frame_lambda(cfg, (poc - 1) % G, fqp)
            fs.sao = decide_sao_params(org, (ry, ru, rv), sps.ctu_size,
                                       fqp, sps.bit_depth, lam=lam_s)
            ry, ru, rv = apply_sao_picture((ry, ru, rv), fs.sao,
                                           sps.ctu_size, sps.bit_depth)

        max_merge = cfg.max_num_merge_cand
        if slice_info is not None and stype != I_SLICE:
            hdr = headers.SliceHeader(
                slice_type=stype, nal_type=bitio.NAL_TRAIL_R, poc=poc,
                qp=fqp, rps=slice_info["rps"],
                num_ref_idx_l0=slice_info["num_ref_l0"],
                num_ref_idx_l1=slice_info.get("num_ref_l1", 0),
                five_minus_max_num_merge_cand=5 - max_merge,
            )
            init_row = stype  # 0 = B, 1 = P (reference init-table layout)
        elif stype == I_SLICE:
            hdr = headers.SliceHeader(
                slice_type=I_SLICE, nal_type=bitio.NAL_IDR_W_RADL, poc=poc,
                qp=fqp,
            )
            init_row = 2
        else:
            n_ref = max(1, min(poc, cfg.num_ref_frames))
            if fs.ref_idx is not None and fs.ref_idx.max() >= n_ref:
                n_ref = int(fs.ref_idx.max()) + 1
            hdr = headers.SliceHeader(
                slice_type=P_SLICE, nal_type=bitio.NAL_TRAIL_R, poc=poc,
                qp=fqp,
                rps=headers.ShortTermRPS([-(i + 1) for i in range(n_ref)],
                                         [1] * n_ref),
                num_ref_idx_l0=n_ref,
                five_minus_max_num_merge_cand=5 - max_merge,
            )
            init_row = 1
            hdr.temporal_mvp = sps.temporal_mvp_enabled
        if fs.sao is not None:
            hdr.sao_luma = fs.sao.luma_on
            hdr.sao_chroma = fs.sao.chroma_on
        if pps.weighted_pred and stype == P_SLICE:
            hdr.wp_l0 = getattr(fs, "wp_l0", None) or WpParams().identity(
                hdr.num_ref_idx_l0)
        if stype != I_SLICE and hdr.rps is not None:
            for i, r in enumerate(self._sps_rps):
                if (r.delta_pocs == hdr.rps.delta_pocs
                        and r.used == hdr.rps.used):
                    hdr.rps_sps_idx = i
                    break
        n_ref_slice = hdr.num_ref_idx_l0 if stype != I_SLICE else 1
        n_ref_l1 = hdr.num_ref_idx_l1 if stype == B_SLICE else 0
        l0d = l1d = None
        if slice_info is not None:
            l0d = slice_info.get("l0_deltas")
            l1d = slice_info.get("l1_deltas")
        w = headers.write_slice_header(hdr, sps, pps,
                                       num_sps_rps=len(self._sps_rps))
        # the native coder codes I and P slices; it returns None for
        # frames whose features exceed it (NxN, TU splits), and B slices
        # take the Python coder
        ctx_snap = np.zeros(256, np.int32)
        payload = (None if stype == B_SLICE else
                   encode_slice_data_native(fs, sps, pps, init_row, fqp,
                                            stype, max_merge, n_ref_slice,
                                            ctx_out=ctx_snap))
        if payload is not None:  # native fast path (byte-identical)
            w.write_bytes(payload)
            if stype == P_SLICE and ctx_snap.any():
                self.ctx_feedback[fqp] = ctx_snap
        else:
            ctx = ContextSet(init_row, fqp)
            cab = CabacEncoder(ctx)
            encode_slice_data(cab, fs, sps, pps, stype, max_merge,
                              num_ref=n_ref_slice, ref_deltas=l0d,
                              num_ref_l1=n_ref_l1, l1_deltas=l1d,
                              slice_qp=fqp)
            cab.finish()
            w.write_bytes(bytes(cab.out))
            val, nbits = cab.pending_bits
            w.write(val, nbits)
            w.rbsp_trailing_bits()
            if stype == P_SLICE:
                self.ctx_feedback[fqp] = np.asarray(ctx.states, np.int32)
        self._emit(bitio.make_nal(hdr.nal_type, w.getvalue()),
                   first_of_au=True)
        bits = (len(self.nals[-1]) + 4) * 8

        # decoded-picture-hash SEI (suffix) + per-frame stats
        if stats is not None:  # device-computed (checksum hash + SSE)
            hashes, htype = stats["hashes"], stats["hash_type"]
            maxv = (1 << sps.bit_depth) - 1

            def _ps(sse, npx):
                return (999.99 if sse == 0
                        else 10.0 * np.log10(maxv * maxv * npx / sse))

            npx = sps.coded_width * sps.coded_height
            psnrs = (_ps(float(stats["sse"][0]), npx),
                     _ps(float(stats["sse"][1]), npx // 4),
                     _ps(float(stats["sse"][2]), npx // 4))
            self.dpb_recon = None
        else:
            if cfg.hash_type == "checksum":
                hashes, htype = picture_checksum(ry, ru, rv,
                                                 sps.bit_depth), 2
            elif cfg.hash_type == "crc":
                hashes, htype = picture_crc(ry, ru, rv, sps.bit_depth), 1
            else:
                hashes, htype = picture_md5(ry, ru, rv, sps.bit_depth), 0
            psnrs = (psnr(y, ry[: y.shape[0], : y.shape[1]], sps.bit_depth),
                     psnr(u, ru[: u.shape[0], : u.shape[1]], sps.bit_depth),
                     psnr(v, rv[: v.shape[0], : v.shape[1]], sps.bit_depth))
            self.dpb_recon = (ry, ru, rv)
        self._emit(bitio.make_nal(
            bitio.NAL_SUFFIX_SEI,
            headers.write_picture_hash_sei(hashes, htype)))

        res = FrameResult(
            poc=poc, bits=bits, psnr_y=psnrs[0], psnr_u=psnrs[1],
            psnr_v=psnrs[2], md5=hashes, seconds=time.time() - t0,
        )
        self.results.append(res)
        self._recon = (ry, ru, rv) if ry is not None else None
        return res

    def bitstream(self) -> bytes:
        return bitio.write_annexb(self.nals, self.first_of_au)


def check_slice(cfg: EncoderConfig) -> None:
    """Raise NotImplementedError for any configuration outside the ported
    slices: all-intra (IntraPeriod 1) with the host tools after the
    decision; LD-P with NN-FME, integer-pel or DCT-IF FME, RDOQ, sign
    hiding, deblocking and SAO at any coded size (the grid step where the
    size is whole 16x16 blocks, else the per-picture P path with the host
    tool stage), IntraPeriod N and rate control (picture or CTU level);
    explicit weighted prediction on the grid only; random access with or
    without a GOP table of B pictures, with those tools, at coded sizes in
    whole 16x16 blocks; quadtree or fixed 8x8 intra (all-intra pictures
    and the IDR alike), one slice, no weighted bi-prediction. All of it
    at 8 bits; at 10 bits (Main10) all-intra and the IDR with the quadtree
    or fixed 8x8 intra, LD-P off the grid (the scan, the per-picture
    device and host stages, IntraPeriod N, rate control) and random
    access (with or without a GOP table, with those tools), but not
    weighted prediction."""
    sps, pps = cfg.sps, cfg.pps
    bd = sps.bit_depth
    off = [
        (bd not in (8, 10), f"bit depth {bd}"),
        (sps.scaling_list_enabled, "scaling lists"),
        (cfg.adaptive_qp, "adaptive QP"),
        (pps.tiles_enabled or pps.entropy_coding_sync or cfg.slice_ctus > 0,
         "tiles, wavefronts or multiple slices"),
        (sps.hrd_enabled, "HRD buffering-period SEIs"),
    ]
    if cfg.intra_period != 1:  # LD-P or random access
        ra = cfg.gop_structure == "ra"
        where = (" in random access" if ra else
                 f" at {sps.coded_width}x{sps.coded_height} (not whole "
                 "16x16 blocks)" if not inter_grid.supports(cfg) else
                 " off the grid (IntraPeriod N or rate control)")
        off += [
            (bd == 10 and pps.weighted_pred,
             "weighted prediction at bit depth 10"),
            (bd == 8 and not (_takes_scan(cfg) and inter_grid.supports(cfg))
             and pps.weighted_pred,
             "weighted prediction" + where),
            (cfg.fme_mode not in ("nn", "none", "dctif"),
             f"FmeMode {cfg.fme_mode}"),
            (not ra and bool(cfg.gop_table), "a GOP table of P pictures"),
            (ra and (sps.coded_width % 16 or sps.coded_height % 16),
             f"random access at {sps.coded_width}x{sps.coded_height} "
             "(not whole 16x16 blocks)"),
            (pps.weighted_bipred, "weighted bi-prediction (WeightedPredB)"),
        ]
    bad = [name for cond, name in off if cond]
    if bad:
        raise NotImplementedError("not yet ported: " + ", ".join(bad))


def _takes_scan(cfg: EncoderConfig) -> bool:
    """LD-P through the chunked device scan (the reference's test at its
    `encoder.py:536-550`): IntraPeriod -1, no rate control, and the tools
    off or the grid; every other LD-P configuration takes the
    per-picture loop."""
    tools = (cfg.pps.sign_data_hiding or cfg.rdoq or cfg.deblocking
             or cfg.sps.sao_enabled or cfg.fme_mode == "dctif")
    return (cfg.gop_structure != "ra" and cfg.intra_period == -1
            and cfg.target_bitrate <= 0
            and (not tools or inter_grid.supports(cfg)))


class LdpScanDriver:
    """Chunked LD-P scan with explicit dispatch/collect halves: the grid
    step (R reference planes, TMVP) where `inter_grid.supports(cfg)`, the
    non-grid scan (one reference) elsewhere.

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
        self.grid = inter_grid.supports(cfg)
        if self.grid and not inter_grid.fetches_recon(cfg):
            # the no-fetch row is read only by the native decision walk:
            # without it this raises (the reference fetches instead)
            get_lib()
        if self.grid:
            self.fn, _, _ = inter_grid.build_ldp_grid_scan(
                cfg, nn_by_qp, self.n_gops, self.device)
        else:
            self.fn, _, _ = build_ldp_scan(cfg, nn_by_qp, self.n_gops,
                                           self.device)
        self.R = max(1, cfg.num_ref_frames) if self.grid else 1
        self.use_wp = self.grid and cfg.pps.weighted_pred
        self.wp_by_poc: dict = {}  # the slice headers' WP tables
        self._col = None  # TMVP collocated motion of the last coded picture
        self.refs = None
        self.pending: list = []
        self.starts = list(range(0, len(frames) - 1, self.K))

    def num_chunks(self) -> int:
        return len(self.starts)

    def start(self) -> None:
        """Encode the leading IDR (decided on the device) and stage its
        recon."""
        self.finish(0, self.frames[0])
        ry, ru, rv = (
            torch.from_numpy(np.ascontiguousarray(p, dtype=np.int32))
            .to(self.device) for p in self.enc.dpb_recon)
        if self.grid:  # R copies of the IDR: [Y], [U | V] packed
            ruv = torch.cat([ru, rv], dim=1)
            self.refs = (ry[None].repeat(self.R, 1, 1).contiguous(),
                         ruv[None].repeat(self.R, 1, 1).contiguous())
        else:
            self.refs = (ry, ru, rv)

    def _chunk_frames(self, blk) -> np.ndarray:
        """The chunk's source frames, padded, one row each: bytes at 8
        bits, 16-bit samples (int16) at 10."""
        w, h = self.w, self.h
        dt = np.uint8 if self.cfg.sps.bit_depth == 8 else np.int16
        rows = []
        for y, u, v in blk:
            rows.append(np.concatenate([
                _pad_to(np.asarray(y), h, w).astype(dt).ravel(),
                _pad_to(np.asarray(u), h // 2, w // 2).astype(dt).ravel(),
                _pad_to(np.asarray(v), h // 2, w // 2).astype(dt).ravel(),
            ]))
        return np.stack(rows).reshape(self.n_gops, self.G, -1)

    def dispatch(self, ci: int) -> None:
        s = self.starts[ci]
        blk = self.frames[1:][s : s + self.K]
        nvalid = len(blk)
        blk = blk + [blk[-1]] * (self.K - nvalid)
        host = torch.from_numpy(self._chunk_frames(blk))
        if self.cuda:
            staged = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
            staged.copy_(host)
            frames = staged.to(self.device, non_blocking=True)
        else:
            frames = host
        if self.grid:
            nav = [[max(1, min(s + 1 + g * self.G + p, self.R))
                    for p in range(self.G)] for g in range(self.n_gops)]
            # adaptive bit-estimator re-freeze: the decision tables of
            # the last written P slices' end-of-slice context states
            live = inter_grid.grid_live_tables(self.cfg,
                                               self.enc.ctx_feedback)
            wp = self._wp_arrays(s) if self.use_wp else None
            buf, *refs = self.fn(frames, nav, *self.refs, live, wp, nvalid)
        else:
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

    def _wp_arrays(self, s: int):
        """Per-picture explicit-WP parameters of one chunk: the host's DC/AC
        analysis against the reference *originals* (the reference's
        `_wp_arrays`, WeightPredAnalysis.cpp:246,398; the SAD select uses
        the originals as the recon proxy, an encoder choice). Returns
        (w, o, d) shaped (n_gops, G, R, 3) / (n_gops, G); references past
        the available ones, and the padding of a short last chunk (not
        coded), carry the identity."""
        K, R = self.K, self.R
        wpw = np.full((K, R, 3), 1 << 6, np.int32)
        wpo = np.zeros((K, R, 3), np.int32)
        wpd = np.full(K, 6, np.int32)
        for j in range(min(K, len(self.frames) - 1 - s)):
            poc = s + 1 + j
            nav = max(1, min(poc, R))
            cur = self.frames[poc]
            refs = [self.frames[poc - 1 - r] for r in range(nav)]
            wp = analyse_slice_wp(cur, refs, bit_depth=8)
            self.wp_by_poc[poc] = wp
            d = wp.denom_y
            wpd[j] = d
            wpw[j, :, :] = 1 << d
            for r in range(nav):
                wpw[j, r] = wp.weights[r]
                wpo[j, r] = wp.offsets[r]
        return (wpw.reshape(self.n_gops, self.G, R, 3),
                wpo.reshape(self.n_gops, self.G, R, 3),
                wpd.reshape(self.n_gops, self.G))

    def collect(self) -> None:
        """Serialise the oldest in-flight chunk (waits for its fetch)."""
        if not self.pending:
            return
        ps, pnv, rows, done = self.pending.pop(0)
        if done is not None:
            done.synchronize()
        rows = rows.numpy()
        tmvp = self.grid and self.cfg.sps.temporal_mvp_enabled
        for j in range(pnv):
            poc = ps + 1 + j
            cfg_f = dataclasses.replace(self.cfg, qp=self.enc.frame_qp(poc))
            if not self.grid:
                pre = assemble_frame_p(cfg_f, collect_frame(cfg_f, rows[j]))
                self.finish(poc, self.frames[poc], (*pre, None))
                continue
            col = None
            if tmvp:
                # the previous coded picture's final 16x16-compressed
                # motion (the IDR contributes an all-invalid field)
                if self._col is None:
                    h16, w16 = (self.h // 8 + 1) // 2, (self.w // 8 + 1) // 2
                    self._col = (np.zeros((h16, w16, 2), np.int32),
                                 np.zeros((h16, w16), np.int32))
                col = self._col
            pre = inter_grid.assemble_grid_frame(
                cfg_f, rows[j], max(1, min(poc, self.R)), col=col)
            # the device ran the cfg's in-loop filters already
            pre[0].prefiltered = True
            if self.use_wp:
                pre[0].wp_l0 = self.wp_by_poc.pop(poc, None)
            if tmvp:
                fs = pre[0]
                self._col = (
                    np.ascontiguousarray(fs.mv[::2, ::2]).astype(np.int32),
                    np.where(fs.inter_dir[::2, ::2] != 0,
                             fs.ref_idx[::2, ::2] + 1, 0).astype(np.int32))
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
                    device="cuda", device_batch: int = 0):
    """Encode frames read from `reader` (read_frame(i) -> (y, u, v) or
    None): every picture intra with IntraPeriod 1; with a target bitrate,
    rate control over the per-picture loop; random access with a GOP
    table of B pictures (`_gop_table_driven`) or without one (`_ra_gop4`);
    LD-P with IntraPeriod -1 through the chunked device scan where the
    reference takes it (`_takes_scan`); else picture by picture (the P
    pictures through `inter_enc.encode_frame_p`). Returns (Encoder,
    recons), as `tpuhevc.codec.encoder.encode_sequence` does. `device` is
    explicit: a CUDA device that is absent raises, it never falls back to
    the CPU.

    device_batch > 0, with IntraPeriod 1 and fixed 8x8 intra: batches of
    that many pictures, each coded in one kernel launch and fetched in one
    copy (a short last batch as it is). With sign hiding on, the pictures
    go one by one through the host's closed loop instead, which hides
    signs (the reference's batch path ignores SignHideFlag, and its
    streams then fail their hashes)."""
    dev = resolve(device)
    check_slice(cfg)
    enc = Encoder(cfg, device=dev)
    n = max_frames if max_frames is not None else cfg.frames
    frames = []
    for i in range(n):
        fr = reader.read_frame(i)
        if fr is None:
            break
        frames.append(fr)
    recons = []

    def _finish(i, fr, pre=None, slice_info=None):
        enc.encode_frame(*fr, poc=i, precomputed=pre, slice_info=slice_info)
        recons.append(enc._recon)

    if (device_batch > 0 and cfg.intra_period == 1 and not cfg.intra_qt
            and not cfg.pps.sign_data_hiding):
        for s in range(0, len(frames), device_batch):
            chunk = frames[s : s + device_batch]
            for j, (fs, rec) in enumerate(
                    encode_frames_intra_batch(chunk, cfg, dev)):
                _finish(s + j, chunk[j], (fs, rec, None))
    elif cfg.target_bitrate > 0:
        _rate_controlled(enc, cfg, frames, _finish)
    elif cfg.gop_structure == "ra" and len(frames) > 1:
        if cfg.gop_table:
            _gop_table_driven(enc, cfg, frames, _finish)
        else:
            _ra_gop4(enc, cfg, frames, _finish)
    elif _takes_scan(cfg) and len(frames) > 1:
        # TMVP rides the grid's native collocated walk: granted in the
        # SPS there, as the reference does (its encoder.py:541-550)
        if cfg.tmvp and inter_grid.supports(cfg):
            cfg.sps.temporal_mvp_enabled = True
        _ldp_scan_pipelined(enc, cfg, frames, _finish, dev)
    else:
        for i, fr in enumerate(frames):
            _finish(i, fr)
    return enc, recons


def _rate_controlled(enc, cfg, frames, finish):
    """Picture-level R-lambda rate control (RateControl=1): QP per frame
    from the model, model updated with actual bits (TEncRateCtrl
    counterpart; SURVEY.md §2.2). Rides the regular coding structure —
    the anchor's multi-ref LD-P GOP included — via the encoder's
    _rc_qp/_rc_lambda overrides instead of forcing IPPP, matching
    TEncGOP.cpp:1821-1831 (RC supplies QP+lambda, the GOP machinery
    supplies structure). With cfg.rc_ctu (LCULevelRC) the picture target
    is further distributed over CTUs by activity and the per-CTU QPs
    ride cu_qp_delta (such a picture takes the host stage)."""
    sps = cfg.sps
    rc = RateControl(cfg.target_bitrate, cfg.frame_rate, sps.coded_width,
                     sps.coded_height, len(cfg.gop_qp_offsets) or 4,
                     len(frames))
    alloc = None
    if cfg.rc_ctu:
        cfg.pps.cu_qp_delta_enabled = True  # before the PPS is written
        alloc = CtuAlloc(sps.coded_width, sps.coded_height, sps.ctu_size)
    for i, fr in enumerate(frames):
        stype = enc._slice_type(i)
        qp, lam, target = rc.pick(i, stype == I_SLICE)
        enc._rc_qp, enc._rc_lambda = qp, lam
        try:
            if alloc is not None and stype != I_SLICE:
                level = rc._pending[0]
                a, b = rc._model(level)
                m = alloc.qp_map(target, qp,
                                 a, b, alloc.weights(fr[0],
                                                     frames[i - 1][0]))
                enc.cfg = dataclasses.replace(cfg, ctu_qp_map=m)
                finish(i, fr)
                enc.cfg = cfg
            else:
                finish(i, fr)
        finally:
            enc._rc_qp = enc._rc_lambda = None
        rc.update(enc.results[-1].bits)


def _gop_table_driven(enc, cfg, frames, finish):
    """GOP-table-driven hierarchical structure (the reference's
    `tpuhevc/codec/encoder.py:606-682`): slice types, QP offsets,
    temporal order, and RPS come straight from the parsed cfg GOP table
    (config.options.GopEntry rows, Frame1..FrameN = decode order).
    Counterpart of TEncGOP::compressGOP's table traversal
    (TEncGOP.cpp:1077-1321) with the ref lists truncated to one active
    picture per list (legal num_ref_idx override; the RPS keeps every
    table reference alive in the DPB so HM replays the full hierarchy
    hash-exact). First-GOP entries whose references precede POC 0 are
    trimmed like TEncTop's initial-RPS adjustment."""
    table = list(cfg.gop_table)
    G = len(table)
    n = len(frames)
    cfg.sps.num_reorder_pics = max(cfg.sps.num_reorder_pics,
                                   max(1, G - 1))
    max_refs = max((len(e.ref_pics) for e in table), default=1)
    cfg.sps.max_dec_pic_buffering = max(cfg.sps.max_dec_pic_buffering,
                                        max_refs + 2)
    dpb: dict = {}

    finish(0, frames[0])
    dpb[0] = enc._recon
    last_coded = 0
    base = 0
    while base + G < n:
        for e in table:
            poc = base + e.poc_offset
            if poc >= n:
                continue
            qp = min(max(cfg.qp + e.qp_offset, 0), 51)
            # trim refs that precede the IDR or were never coded (the
            # first GOPs reference pictures that do not exist yet)
            deltas = [d for d in e.ref_pics if (poc + d) in dpb]
            if not deltas:
                deltas = [last_coded - poc]
            past = sorted((poc + d for d in deltas if d < 0), reverse=True)
            fut = sorted(poc + d for d in deltas if d > 0)
            l0_poc = past[0] if past else fut[0]
            l1_poc = fut[0] if fut else past[0]
            rps = ShortTermRPS(deltas, [1] * len(deltas))
            if e.slice_type == "B":
                fs, recon = encode_frame_b(
                    frames[poc], dpb[l0_poc], dpb[l1_poc], cfg, qp,
                    [l0_poc], [l1_poc], poc, enc._nn_for_qp(qp),
                    device=enc.device)
                si = dict(stype=B_SLICE, qp=qp, rps=rps,
                          num_ref_l0=1, num_ref_l1=1,
                          l0_deltas=[poc - l0_poc],
                          l1_deltas=[poc - l1_poc])
                finish(poc, frames[poc], (fs, recon, None), si)
            else:
                enc.dpb_recon = dpb[l0_poc]
                si = dict(stype=P_SLICE, qp=qp, rps=rps,
                          num_ref_l0=1, l0_deltas=[poc - l0_poc])
                finish(poc, frames[poc], None, si)
            dpb[poc] = enc._recon
            last_coded = poc
            # DPB: exactly the decoder's — keep only pictures the
            # just-coded RPS names (plus the current picture)
            keep = {poc} | {poc + d for d in deltas}
            for p in [p for p in dpb if p not in keep]:
                dpb.pop(p)
        base += G
    # tail: plain LD-P chain from the last coded picture
    for poc in range(base + 1, n):
        if poc in dpb:
            continue
        qp = min(max(cfg.qp + (table[-1].qp_offset if table else 3), 0), 51)
        ref = max(p for p in dpb if p < poc)
        enc.dpb_recon = dpb[ref]
        si = dict(stype=P_SLICE, qp=qp,
                  rps=ShortTermRPS([ref - poc], [1]),
                  num_ref_l0=1, l0_deltas=[poc - ref])
        finish(poc, frames[poc], None, si)
        dpb[poc] = enc._recon


def _ra_gop4(enc, cfg, frames, finish):
    """Random-access hierarchical GOP4: decode order [b+4, b+2, b+1, b+3]
    with one reference per list for B pictures (key pictures are P).
    Counterpart of TEncGOP::compressGOP's RA traversal (TEncGOP.cpp:1077)
    with the encoder_randomaccess GOP-table structure collapsed to GOP4."""
    n = len(frames)
    cfg.sps.num_reorder_pics = max(cfg.sps.num_reorder_pics, 2)
    dpb: dict = {}

    def enc_b(poc, qp_off, l0_poc, l1_poc, rps_deltas, rps_used):
        qp = min(max(cfg.qp + qp_off, 0), 51)
        fs, recon = encode_frame_b(
            frames[poc], dpb[l0_poc], dpb[l1_poc], cfg, qp,
            [l0_poc], [l1_poc], poc, enc._nn_for_qp(qp), device=enc.device)
        si = dict(stype=B_SLICE, qp=qp,
                  rps=ShortTermRPS(rps_deltas, rps_used),
                  num_ref_l0=1, num_ref_l1=1,
                  l0_deltas=[poc - l0_poc], l1_deltas=[poc - l1_poc])
        finish(poc, frames[poc], (fs, recon, None), si)
        dpb[poc] = enc._recon

    finish(0, frames[0])
    dpb[0] = enc._recon
    base = 0
    while base + 4 < n:
        b = base
        # key picture: P referencing the previous key
        qp = min(max(cfg.qp + 1, 0), 51)
        enc.dpb_recon = dpb[b]
        si = dict(stype=P_SLICE, qp=qp, rps=ShortTermRPS([-4], [1]),
                  num_ref_l0=1, l0_deltas=[4])
        finish(b + 4, frames[b + 4], None, si)
        dpb[b + 4] = enc._recon
        enc_b(b + 2, 2, b, b + 4, [-2, 2], [1, 1])
        enc_b(b + 1, 3, b, b + 2, [-1, 1, 3], [1, 1, 0])
        enc_b(b + 3, 3, b + 2, b + 4, [-1, 1], [1, 1])
        for p in (b, b + 1, b + 2, b + 3):  # no longer referenced
            dpb.pop(p, None)
        base += 4
    # tail: plain LD-P chain from the last key picture
    for poc in range(base + 1, n):
        qp = min(max(cfg.qp + 3, 0), 51)
        enc.dpb_recon = dpb.get(poc - 1, enc._recon)
        si = dict(stype=P_SLICE, qp=qp, rps=ShortTermRPS([-1], [1]),
                  num_ref_l0=1, l0_deltas=[1])
        finish(poc, frames[poc], None, si)
        dpb[poc] = enc._recon


def _load_nn_params(cfg: EncoderConfig):
    """Per-QP NN-FME weights from `NNWeightsDir` (an npz, or a CSV tree
    with one directory per QP); None disables (falls back to integer)."""
    import os

    from ..models import nnfme

    d = cfg.nn_weights_dir
    if d and d.endswith(".npz") and os.path.exists(d):
        return nnfme.select_qp_params(nnfme.load_npz(d), cfg.qp)
    for root in [d] if d else []:
        if root and os.path.isdir(root):
            qp_dir = os.path.join(root, str(cfg.qp))
            if not os.path.isdir(qp_dir):
                qp_dir = os.path.join(root, "22")  # reference QP fallback
            if os.path.isdir(qp_dir):
                return nnfme.load_csv_weights(qp_dir)
    return None
