"""Conforming decoder for the subset this framework emits.

Counterpart of the reference's TDecTop/TDecSlice/TDecCu stack
(TDecTop.cpp:592, TDecSlice.cpp:69, TDecCu.cpp:135 — SURVEY.md §3.4):
Annex-B demux -> parameter sets -> slice header -> CABAC slice data ->
reconstruction -> decoded-picture-hash verification. Used as the in-repo
oracle; full conformance is cross-checked against the reference TAppDecoder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..entropy import bitio, headers
from ..entropy.cabac import CabacDecoder, ContextSet
from ..entropy.syntax import decode_slice_data
from ..utils.yuv import picture_checksum, picture_crc, picture_md5
from .params import B_SLICE, I_SLICE, P_SLICE
from .recon import reconstruct_frame


@dataclass
class DecodedFrame:
    poc: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    md5_ok: bool | None = None  # None = no hash SEI seen


def decode_stream(data: bytes, with_hash_check: bool = True) -> list[DecodedFrame]:
    nals = bitio.read_annexb(data)
    sps = None
    pps = None
    sps_rps: list = []
    frames: list[DecodedFrame] = []
    cols: dict = {}  # poc -> ColMotion (TMVP collocated-picture motion)
    cols_b: dict = {}  # poc -> ColMotionB (two-list TMVP for B slices)
    pending = None  # last decoded picture awaiting its suffix SEI
    prev_tid0 = (0, 0)  # (poc_msb, poc_lsb) of the last temporal-id-0 pic
    part_fs = None  # multi-segment picture: shared FrameSyntax + count
    part_done = 0
    part_starts: list = []  # coding-order start rank of each segment
    for nal in nals:
        nal_type = (nal[0] >> 1) & 0x3F
        temporal_id = (nal[1] & 7) - 1
        rbsp = bitio.ebsp_to_rbsp(nal[2:])
        if nal_type == bitio.NAL_VPS:
            continue
        if nal_type == bitio.NAL_SPS:
            sps, sps_rps = headers.parse_sps(rbsp)
            continue
        if nal_type == bitio.NAL_PPS:
            pps = headers.parse_pps(rbsp)
            continue
        if nal_type in (bitio.NAL_PREFIX_SEI, bitio.NAL_SUFFIX_SEI):
            parsed = headers.parse_picture_hash_sei(rbsp)
            if parsed is not None and pending is not None and with_hash_check:
                htype, hashes = parsed
                # hash_type per D.3.19: 0 = MD5, 1 = CRC, 2 = checksum
                calc = {0: picture_md5, 1: picture_crc,
                        2: picture_checksum}[htype]
                got = calc(pending.y, pending.u, pending.v, sps.bit_depth)
                pending.md5_ok = got == hashes
            continue
        if nal_type <= 31:  # VCL
            assert sps is not None and pps is not None
            hdr, off = headers.parse_slice_header(rbsp, nal_type, sps, pps, sps_rps)
            if hdr.entry_points:
                # entry-point offsets count EBSP bytes (§7.4.7.1);
                # convert to the unescaped payload this decoder slices
                _, removed = bitio.ebsp_to_rbsp_map(nal[2:])
                hdr.entry_points = bitio.ebsp_entry_sizes_to_rbsp(
                    hdr.entry_points, off, removed)
            # PicOrderCntVal (§8.3.1): MSB continuation from the previous
            # temporal-id-0 picture; IDR resets to 0
            if bitio.is_idr(hdr.nal_type):
                prev_tid0 = (0, 0)
            else:
                max_lsb = 1 << sps.log2_max_poc_lsb
                pm, pl = prev_tid0
                lsb = hdr.poc
                if lsb < pl and (pl - lsb) >= max_lsb // 2:
                    msb = pm + max_lsb
                elif lsb > pl and (lsb - pl) > max_lsb // 2:
                    msb = pm - max_lsb
                else:
                    msb = pm
                hdr.poc = msb + lsb
                if temporal_id == 0:
                    prev_tid0 = (msb, lsb)
            max_merge = 5 - hdr.five_minus_max_num_merge_cand
            if hdr.slice_type == I_SLICE:
                init_row = 2
            elif hdr.cabac_init_flag:
                # §9.3.2.2: cabac_init_flag swaps the P/B init tables
                init_row = 0 if hdr.slice_type == P_SLICE else 1
            else:
                init_row = hdr.slice_type
            ctx = ContextSet(init_row, hdr.qp)
            dec = CabacDecoder(rbsp[off:], ctx)
            if hdr.slice_type != I_SLICE:
                used = [(d, u) for d, u in zip(hdr.rps.delta_pocs,
                                               hdr.rps.used) if u]
                past = sorted([-d for d, _ in used if d < 0])     # cur-ref
                fut = sorted([-d for d, _ in used if d > 0])      # negative
                fut = sorted(fut, key=abs)
                num_ref = hdr.num_ref_idx_l0
                l0 = past + fut
                deltas = (l0 * ((num_ref + len(l0) - 1)
                                // max(1, len(l0))))[:num_ref]
                if hdr.list_entry_l0 is not None:
                    # ref_pic_list_modification (§8.3.4): explicit
                    # temp-list indices replace the cyclic default
                    deltas = [l0[e] for e in hdr.list_entry_l0[:num_ref]]
                num_ref_l1 = (hdr.num_ref_idx_l1
                              if hdr.slice_type == B_SLICE else 0)
                l1 = fut + past
                l1_deltas = (l1 * ((num_ref_l1 + len(l1) - 1)
                                   // max(1, len(l1))))[:num_ref_l1] \
                    if num_ref_l1 else []
                if num_ref_l1 and hdr.list_entry_l1 is not None:
                    l1_deltas = [l1[e]
                                 for e in hdr.list_entry_l1[:num_ref_l1]]
            else:
                deltas, num_ref, l1_deltas, num_ref_l1 = [], 1, [], 0
            col = col_b = None
            check_ldc = (hdr.slice_type != I_SLICE
                         and all(d > 0 for d in deltas)
                         and all(d > 0 for d in l1_deltas))
            if hdr.slice_type != I_SLICE and hdr.temporal_mvp and deltas:
                # col picture: list per collocated_from_l0 (B), L0 for P
                # (TComDataCU.cpp:2995)
                src = (deltas if (hdr.slice_type == P_SLICE
                                  or hdr.collocated_from_l0)
                       else (l1_deltas or deltas))
                ci = min(hdr.collocated_ref_idx, len(src) - 1)
                col = cols.get(hdr.poc - src[ci])
                col_b = cols_b.get(hdr.poc - src[ci])
            if pps.entropy_coding_sync:
                from ..entropy.syntax import decode_slice_data_wpp

                fs = decode_slice_data_wpp(
                    rbsp[off:], hdr.entry_points or [], sps, pps,
                    sps.coded_width, sps.coded_height, init_row, hdr.qp,
                    hdr.slice_type, max_merge, sao_luma=hdr.sao_luma,
                    sao_chroma=hdr.sao_chroma, num_ref=num_ref,
                    ref_deltas=deltas, num_ref_l1=num_ref_l1,
                    l1_deltas=l1_deltas, col=col, col_b=col_b,
                    col_from_l0=hdr.collocated_from_l0,
                    check_ldc=check_ldc, mvd_l1_zero=hdr.mvd_l1_zero,
                    slice_qp=hdr.qp)
            elif pps.tiles_enabled and hdr.entry_points:
                # HM-style single slice spanning multiple tiles: one
                # CABAC substream per tile, delimited by the slice
                # header's entry points; each substream restarts the
                # contexts (§9.3.1) and ends with end_of_subset_one_bit,
                # which decode_slice_data's per-CTU trm read consumes.
                from .tiles import tile_layout

                _, _, tspans = tile_layout(sps, pps)
                addr0 = 0 if hdr.first_slice else hdr.segment_address
                t0 = next(i for i, sp in enumerate(tspans)
                          if sp[0] == addr0)
                data = rbsp[off:]
                bounds = []
                p = 0
                for sz in hdr.entry_points:
                    bounds.append((p, p + sz))
                    p += sz
                bounds.append((p, len(data)))
                fs = None if hdr.first_slice else part_fs
                done = 0
                for (b0, b1), span in zip(bounds, tspans[t0:]):
                    dec_t = CabacDecoder(data[b0:b1],
                                         ContextSet(init_row, hdr.qp))
                    fs = decode_slice_data(
                        dec_t, sps, pps, sps.coded_width,
                        sps.coded_height, hdr.slice_type, max_merge,
                        sao_luma=hdr.sao_luma, sao_chroma=hdr.sao_chroma,
                        num_ref=num_ref, ref_deltas=deltas,
                        num_ref_l1=num_ref_l1, l1_deltas=l1_deltas,
                        col=col, col_b=col_b,
                        col_from_l0=hdr.collocated_from_l0,
                        check_ldc=check_ldc,
                        mvd_l1_zero=hdr.mvd_l1_zero, slice_qp=hdr.qp,
                        fs=fs, ctu_addrs=span, subset_end=True)
                    done += getattr(fs, "consumed_ctus", len(span))
                fs.consumed_ctus = done
                if hdr.first_slice:
                    part_fs, part_done = fs, 0
                part_done += done
                if part_done < sps.num_ctus:
                    continue  # later slices cover the remaining tiles
                from .tiles import block_order_for

                fs.tile_order8 = block_order_for(sps, pps)
                fs.tile_order4 = block_order_for(sps, pps, cell_log2=2)
                part_fs, part_done = None, 0
            else:
                # slice segment's CTU span in coding order (tile scan
                # with tiles); the segment ends at end_of_slice_segment
                nctu = sps.num_ctus
                if pps.tiles_enabled:
                    from .tiles import tile_layout

                    ts_order, _, _ = tile_layout(sps, pps)
                else:
                    ts_order = list(range(nctu))
                addr = 0 if hdr.first_slice else hdr.segment_address
                start_rank = ts_order.index(addr)
                span = ts_order[start_rank:]
                cell_order = None
                if start_rank and not pps.tiles_enabled:
                    # multi-slice picture: gate intra-MPM availability at
                    # the segment boundary (tiles: _SliceCoder derives
                    # the gating from the PPS itself)
                    from .refsamples import BlockOrder

                    c8 = sps.log2_ctu - 3
                    per_ctu = (1 << c8) ** 2
                    smin = np.full((sps.coded_height >> 3,
                                    sps.coded_width >> 3),
                                   start_rank * per_ctu, np.int64)
                    cell_order = BlockOrder(sps.coded_width,
                                            sps.coded_height,
                                            sps.log2_ctu, 3,
                                            slice_min=smin)
                fs = decode_slice_data(dec, sps, pps, sps.coded_width,
                                       sps.coded_height, hdr.slice_type,
                                       max_merge, sao_luma=hdr.sao_luma,
                                       sao_chroma=hdr.sao_chroma,
                                       num_ref=num_ref, ref_deltas=deltas,
                                       num_ref_l1=num_ref_l1,
                                       l1_deltas=l1_deltas, col=col,
                                       col_b=col_b,
                                       col_from_l0=hdr.collocated_from_l0,
                                       check_ldc=check_ldc,
                                       mvd_l1_zero=hdr.mvd_l1_zero,
                                       slice_qp=hdr.qp,
                                       fs=(None if hdr.first_slice
                                           else part_fs),
                                       ctu_addrs=span,
                                       cell_order=cell_order)
                if hdr.first_slice:
                    part_fs, part_done, part_starts = fs, 0, []
                part_starts.append(start_rank)
                part_done += getattr(fs, "consumed_ctus", nctu)
                if part_done < nctu:
                    continue  # more slice segments of this picture follow
                if pps.tiles_enabled:
                    # recon availability gated at tile boundaries
                    from .tiles import block_order_for

                    fs.tile_order8 = block_order_for(sps, pps)
                    fs.tile_order4 = block_order_for(sps, pps,
                                                     cell_log2=2)
                elif len(part_starts) > 1:
                    # multi-slice: recon availability gated at the
                    # observed slice-segment boundaries
                    from .tiles import spans_block_order

                    bounds = part_starts + [nctu]
                    spans = [list(range(bounds[i], bounds[i + 1]))
                             for i in range(len(part_starts))]
                    fs.tile_order8 = spans_block_order(sps, spans)
                    fs.tile_order4 = spans_block_order(sps, spans,
                                                       cell_log2=2)
                part_fs, part_done, part_starts = None, 0, []
            if hdr.slice_type != I_SLICE:
                from .mv import ColMotion
                from .mv_b import ColMotionB

                l0_abs = [hdr.poc - d for d in deltas]
                l1_abs = [hdr.poc - d for d in l1_deltas]
                cols[hdr.poc] = ColMotion(fs, l0_abs, hdr.poc)
                cols_b[hdr.poc] = ColMotionB(fs, l0_abs, l1_abs, hdr.poc)
                fs.l0_pocs = l0_abs  # for two-list deblock BS
                fs.l1_pocs = l1_abs
            if sps.scaling_list_enabled:
                # default-list dequant lives in the full recon paths
                fs.full_features = True
            if hdr.slice_type == I_SLICE:
                if fs.full_features:
                    from .recon_full import reconstruct_frame_full

                    y, u, v = reconstruct_frame_full(fs, sps, hdr.qp)
                else:
                    from .intra_qt import reconstruct_frame_qt

                    y, u, v = reconstruct_frame_qt(fs, sps, hdr.qp)
            else:
                by_poc = {f.poc: f for f in frames}

                def ref_list(ds):
                    out = []
                    for d in ds:
                        f = by_poc.get(hdr.poc - d, frames[-1])
                        out.append((f.y, f.u, f.v))
                    return out

                # explicit WP routes through the general recon path
                # (per-ref weighting of the 14-bit MC intermediates)
                wp_on = hdr.wp_l0 is not None and (
                    hdr.wp_l0.any_present()
                    or (hdr.wp_l1 is not None
                        and hdr.wp_l1.any_present()))
                if hdr.slice_type == B_SLICE:
                    if wp_on or fs.full_features or (fs.cu_log2 > 5).any():
                        from .recon_full import reconstruct_frame_p_full

                        y, u, v = reconstruct_frame_p_full(
                            fs, sps, hdr.qp, ref_list(deltas),
                            l1_recon=ref_list(l1_deltas),
                            wp_l0=hdr.wp_l0, wp_l1=hdr.wp_l1)
                    else:
                        from .inter_b import reconstruct_frame_b

                        y, u, v = reconstruct_frame_b(
                            fs, sps, hdr.qp, ref_list(deltas),
                            ref_list(l1_deltas))
                elif wp_on or fs.full_features:
                    from .recon_full import reconstruct_frame_p_full

                    y, u, v = reconstruct_frame_p_full(fs, sps, hdr.qp,
                                                       ref_list(deltas),
                                                       wp_l0=hdr.wp_l0)
                else:
                    from .inter_enc import reconstruct_frame_p

                    y, u, v = reconstruct_frame_p(fs, sps, hdr.qp,
                                                  ref_list(deltas))
                if (fs.inter_dir == 0).any() and not fs.full_features:
                    # full-feature frames recon intra CUs inside
                    # reconstruct_frame_p_full already
                    from .recon import reconstruct_intra_cus_inter_frame

                    reconstruct_intra_cus_inter_frame(fs, sps, hdr.qp,
                                                      (y, u, v))
            # pcm_loop_filter_disabled_flag: PCM CU samples bypass both
            # in-loop filters (TComLoopFilter noFilter / TComSAO skip)
            pcm_keep = None
            if sps.pcm_loop_filter_disabled and fs.pcm_blocks:
                from ..ops.deblock import pcm_sample_mask

                pcm_keep = pcm_sample_mask(fs)
            if not pps.deblocking_disabled:
                from ..ops.deblock import deblock_frame

                y, u, v = deblock_frame((y, u, v), fs, hdr.qp,
                                        hdr.slice_type == I_SLICE,
                                        pcm_mask=pcm_keep,
                                        bd=sps.bit_depth)
            if fs.sao is not None:
                from .sao_enc import apply_sao_picture

                pre = (y, u, v)
                y, u, v = apply_sao_picture((y, u, v), fs.sao,
                                            sps.ctu_size, sps.bit_depth)
                if pcm_keep is not None:
                    my, mc = pcm_keep
                    y, u, v = (np.where(m, p0, p) for m, p0, p in
                               ((my, pre[0], y), (mc, pre[1], u),
                                (mc, pre[2], v)))
            pending = DecodedFrame(poc=hdr.poc, y=y, u=u, v=v)
            frames.append(pending)
    return frames  # decode order; callers sort by .poc for display order


def cropped_output(frames: list[DecodedFrame], width: int, height: int):
    """Apply the conformance window (HM decoder output semantics)."""
    out = []
    for f in frames:
        out.append(
            (f.y[:height, :width], f.u[: height // 2, : width // 2],
             f.v[: height // 2, : width // 2])
        )
    return out
