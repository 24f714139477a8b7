"""Parameter-set / slice-header / SEI syntax: writer and parser.

Counterpart of the reference's TEncCavlc.cpp (write) and TDecCAVLC.cpp
(parse) for the feature subset this framework emits, plus SEIwrite/SEIread
for the decoded-picture-hash SEI (the conformance oracle, TEncGOP.cpp:1801 /
TDecGop.cpp:180-208). Syntax per H.265 §7.3; both directions live here so
they evolve in lockstep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..codec.params import B_SLICE, I_SLICE, P_SLICE, PicParams, SeqParams
from . import bitio
from .bitio import BitReader, BitWriter


# --- profile_tier_level ----------------------------------------------------

def write_ptl(w: BitWriter, sps: SeqParams) -> None:
    w.write(0, 2)                    # general_profile_space
    w.write_flag(sps.tier_flag)      # general_tier_flag
    w.write(sps.profile_idc, 5)      # general_profile_idc
    for j in range(32):              # general_profile_compatibility_flag[j]
        w.write_flag(1 if j == sps.profile_idc else 0)
    w.write_flag(1)                  # general_progressive_source_flag
    w.write_flag(0)                  # general_interlaced_source_flag
    w.write_flag(0)                  # general_non_packed_constraint_flag
    w.write_flag(1)                  # general_frame_only_constraint_flag
    w.write(0, 22)                   # reserved_zero_43bits (22+21)
    w.write(0, 21)
    w.write(0, 1)                    # reserved / inbld
    w.write(sps.level_idc, 8)        # general_level_idc


def parse_ptl(r: BitReader, max_sub_layers_minus1: int = 0) -> dict:
    out = {}
    r.read(2)
    out["tier"] = r.read(1)
    out["profile_idc"] = r.read(5)
    r.read(32)
    r.read(4)
    r.read(22)
    r.read(21)
    r.read(1)
    out["level_idc"] = r.read(8)
    # sub-layer PTL entries (§7.3.3): present for temporal-scalable
    # streams (the reference's RA GOP8 has 4 temporal layers)
    if max_sub_layers_minus1 > 0:
        prof, lvl = [], []
        for _ in range(max_sub_layers_minus1):
            prof.append(r.read_flag())
            lvl.append(r.read_flag())
        for _ in range(max_sub_layers_minus1, 8):
            r.read(2)  # reserved_zero_2bits
        for i in range(max_sub_layers_minus1):
            if prof[i]:
                r.read(32)
                r.read(32)
                r.read(24)  # 88-bit sub_layer profile block
            if lvl[i]:
                r.read(8)
    return out


# --- VPS -------------------------------------------------------------------

def write_vps(sps: SeqParams) -> bytes:
    w = BitWriter()
    w.write(0, 4)        # vps_video_parameter_set_id
    w.write(3, 2)        # vps_base_layer_internal/available (reserved "11")
    w.write(0, 6)        # vps_max_layers_minus1
    w.write(0, 3)        # vps_max_sub_layers_minus1
    w.write_flag(1)      # vps_temporal_id_nesting_flag
    w.write(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    write_ptl(w, sps)
    w.write_flag(1)      # vps_sub_layer_ordering_info_present_flag
    w.write_ue(sps.max_dec_pic_buffering - 1)
    w.write_ue(sps.num_reorder_pics)
    w.write_ue(0)        # vps_max_latency_increase_plus1
    w.write(0, 6)        # vps_max_layer_id
    w.write_ue(0)        # vps_num_layer_sets_minus1
    w.write_flag(0)      # vps_timing_info_present_flag
    w.write_flag(0)      # vps_extension_flag
    w.rbsp_trailing_bits()
    return w.getvalue()


# --- Short-term RPS (§7.3.7) ----------------------------------------------

@dataclass
class ShortTermRPS:
    """One short-term reference picture set: negative (past) deltas only is
    all LD-P needs; generic enough for RA later."""

    delta_pocs: list[int] = field(default_factory=list)  # signed, sorted desc by |.|? kept as given
    used: list[int] = field(default_factory=list)

    @property
    def num_negative(self) -> int:
        return sum(1 for d in self.delta_pocs if d < 0)

    @property
    def num_positive(self) -> int:
        return sum(1 for d in self.delta_pocs if d > 0)


def write_st_rps(w: BitWriter, rps: ShortTermRPS, idx: int, first: bool) -> None:
    if not first:
        w.write_flag(0)  # inter_ref_pic_set_prediction_flag (explicit coding)
    neg = sorted([d for d in rps.delta_pocs if d < 0], reverse=True)  # closest first
    pos = sorted([d for d in rps.delta_pocs if d > 0])
    w.write_ue(len(neg))
    w.write_ue(len(pos))
    prev = 0
    for d in neg:
        w.write_ue(prev - d - 1)  # delta_poc_s0_minus1
        prev = d
        w.write_flag(rps.used[rps.delta_pocs.index(d)])
    prev = 0
    for d in pos:
        w.write_ue(d - prev - 1)
        prev = d
        w.write_flag(rps.used[rps.delta_pocs.index(d)])


def parse_st_rps(r: BitReader, first: bool,
                 prev_sets: list[ShortTermRPS] | None = None,
                 slice_level: bool = False) -> ShortTermRPS:
    """§7.4.8 st_ref_pic_set incl. inter-RPS prediction (the form the
    reference encoder emits for sets 1..n, TEncCavlc::codeShortTermRefPicSet
    / TDecCAVLC parse counterpart)."""
    if not first:
        pred = r.read_flag()
        if pred:
            assert prev_sets, "inter-RPS prediction without prior sets"
            if slice_level:
                delta_idx = r.read_ue() + 1
            else:
                delta_idx = 1
            ref = prev_sets[len(prev_sets) - delta_idx]
            sign = r.read_flag()
            abs_delta = r.read_ue() + 1
            delta_rps = (1 - 2 * sign) * abs_delta
            ref_neg = sorted([d for d in ref.delta_pocs if d < 0],
                             reverse=True)      # S0: -1, -2, ...
            ref_pos = sorted([d for d in ref.delta_pocs if d > 0])
            ref_used = {d: u for d, u in zip(ref.delta_pocs, ref.used)}
            nref = len(ref_neg) + len(ref_pos)
            used_by = []
            use_delta = []
            for _ in range(nref + 1):
                ub = r.read_flag()
                used_by.append(ub)
                use_delta.append(r.read_flag() if not ub else 1)
            # derivation (7-57..7-60): j indexes S0 first then S1
            deltas, used = [], []
            # S0 of the new set
            for j in range(len(ref_pos) - 1, -1, -1):
                dpoc = ref_pos[j] + delta_rps
                if dpoc < 0 and use_delta[len(ref_neg) + j]:
                    deltas.append(dpoc)
                    used.append(used_by[len(ref_neg) + j])
            if delta_rps < 0 and use_delta[nref]:
                deltas.append(delta_rps)
                used.append(used_by[nref])
            for j in range(len(ref_neg)):
                dpoc = ref_neg[j] + delta_rps
                if dpoc < 0 and use_delta[j]:
                    deltas.append(dpoc)
                    used.append(used_by[j])
            # S1
            for j in range(len(ref_neg) - 1, -1, -1):
                dpoc = ref_neg[j] + delta_rps
                if dpoc > 0 and use_delta[j]:
                    deltas.append(dpoc)
                    used.append(used_by[j])
            if delta_rps > 0 and use_delta[nref]:
                deltas.append(delta_rps)
                used.append(used_by[nref])
            for j in range(len(ref_pos)):
                dpoc = ref_pos[j] + delta_rps
                if dpoc > 0 and use_delta[len(ref_neg) + j]:
                    deltas.append(dpoc)
                    used.append(used_by[len(ref_neg) + j])
            return ShortTermRPS(deltas, used)
    n_neg = r.read_ue()
    n_pos = r.read_ue()
    deltas, used = [], []
    prev = 0
    for _ in range(n_neg):
        d = prev - (r.read_ue() + 1)
        prev = d
        deltas.append(d)
        used.append(r.read_flag())
    prev = 0
    for _ in range(n_pos):
        d = prev + r.read_ue() + 1
        prev = d
        deltas.append(d)
        used.append(r.read_flag())
    return ShortTermRPS(deltas, used)


# --- SPS -------------------------------------------------------------------

def write_sps(sps: SeqParams, rps_list: list[ShortTermRPS] | None = None) -> bytes:
    w = BitWriter()
    w.write(0, 4)    # sps_video_parameter_set_id
    w.write(0, 3)    # sps_max_sub_layers_minus1
    w.write_flag(1)  # sps_temporal_id_nesting_flag
    write_ptl(w, sps)
    w.write_ue(0)    # sps_seq_parameter_set_id
    w.write_ue(sps.chroma_format)
    # coded size is the true size padded up to the min-CU grid (HM behavior);
    # partial CTUs at the right/bottom borders use implicit quadtree splits.
    mincu = 1 << sps.log2_min_cu
    lumaw = (sps.width + mincu - 1) // mincu * mincu
    lumah = (sps.height + mincu - 1) // mincu * mincu
    w.write_ue(lumaw)
    w.write_ue(lumah)
    crop_r, crop_b = (lumaw - sps.width) >> 1, (lumah - sps.height) >> 1
    if crop_r or crop_b:
        w.write_flag(1)
        w.write_ue(0)
        w.write_ue(crop_r)
        w.write_ue(0)
        w.write_ue(crop_b)
    else:
        w.write_flag(0)
    w.write_ue(sps.bit_depth - 8)
    w.write_ue(sps.bit_depth - 8)
    w.write_ue(sps.log2_max_poc_lsb - 4)
    w.write_flag(1)  # sps_sub_layer_ordering_info_present_flag
    w.write_ue(sps.max_dec_pic_buffering - 1)
    w.write_ue(sps.num_reorder_pics)
    w.write_ue(0)    # sps_max_latency_increase_plus1
    w.write_ue(sps.log2_min_cu - 3)
    w.write_ue(sps.log2_ctu - sps.log2_min_cu)
    w.write_ue(sps.log2_min_tu - 2)
    w.write_ue(sps.log2_max_tu - sps.log2_min_tu)
    w.write_ue(sps.max_tu_depth_inter)
    w.write_ue(sps.max_tu_depth_intra)
    w.write_flag(sps.scaling_list_enabled)
    if sps.scaling_list_enabled:
        # default scaling lists (§7.4.5): no explicit scaling_list_data
        w.write_flag(0)
    w.write_flag(sps.amp_enabled)
    w.write_flag(sps.sao_enabled)
    w.write_flag(sps.pcm_enabled)
    if sps.pcm_enabled:
        w.write(sps.pcm_bit_depth - 1, 4)
        w.write(sps.pcm_bit_depth - 1, 4)
        w.write_ue(sps.pcm_log2_min - 3)
        w.write_ue(sps.pcm_log2_max - sps.pcm_log2_min)
        w.write_flag(sps.pcm_loop_filter_disabled)
    rps_list = rps_list or []
    w.write_ue(len(rps_list))
    for i, rps in enumerate(rps_list):
        write_st_rps(w, rps, i, first=(i == 0))
    w.write_flag(0)  # long_term_ref_pics_present_flag
    w.write_flag(sps.temporal_mvp_enabled)
    w.write_flag(sps.strong_intra_smoothing)
    if sps.vui_timing:
        # minimal VUI (E.2.1): frame_field_info + timing info; enables
        # the per-AU pic_timing SEI (D.3.3 pic_struct branch)
        w.write_flag(1)   # vui_parameters_present_flag
        w.write_flag(0)   # aspect_ratio_info_present_flag
        w.write_flag(0)   # overscan_info_present_flag
        w.write_flag(0)   # video_signal_type_present_flag
        w.write_flag(0)   # chroma_loc_info_present_flag
        w.write_flag(0)   # neutral_chroma_indication_flag
        w.write_flag(0)   # field_seq_flag
        w.write_flag(1)   # frame_field_info_present_flag
        w.write_flag(0)   # default_display_window_flag
        w.write_flag(1)   # vui_timing_info_present_flag
        w.write(1, 32)    # vui_num_units_in_tick
        w.write(max(1, sps.time_scale), 32)  # vui_time_scale
        w.write_flag(0)   # vui_poc_proportional_to_timing_flag
        if sps.hrd_enabled:
            # hrd_parameters (E.2.2): one NAL CPB, fixed frame rate,
            # 24-bit delay fields (SEIEncoder/TEncTop HRD setup
            # counterpart, TLibEncoder/SEIwrite.cpp)
            w.write_flag(1)   # vui_hrd_parameters_present_flag
            w.write_flag(1)   # nal_hrd_parameters_present_flag
            w.write_flag(0)   # vcl_hrd_parameters_present_flag
            w.write_flag(0)   # sub_pic_hrd_params_present_flag
            w.write(hrd_scale(sps)[0], 4)   # bit_rate_scale
            w.write(hrd_scale(sps)[1], 4)   # cpb_size_scale
            w.write(23, 5)    # initial_cpb_removal_delay_length_minus1
            w.write(23, 5)    # au_cpb_removal_delay_length_minus1
            w.write(23, 5)    # dpb_output_delay_length_minus1
            # one sub-layer
            w.write_flag(1)   # fixed_pic_rate_general_flag
            w.write_ue(0)     # elemental_duration_in_tc_minus1
            # fixed rate -> no low_delay flag; cpb_cnt inferred from ue
            w.write_ue(0)     # cpb_cnt_minus1
            br, cpb = hrd_values(sps)
            w.write_ue(br)    # bit_rate_value_minus1
            w.write_ue(cpb)   # cpb_size_value_minus1
            w.write_flag(0)   # cbr_flag
        else:
            w.write_flag(0)   # vui_hrd_parameters_present_flag
        w.write_flag(0)   # bitstream_restriction_flag
    else:
        w.write_flag(0)  # vui_parameters_present_flag
    w.write_flag(0)  # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.getvalue()


def hrd_scale(sps) -> tuple[int, int]:
    """(bit_rate_scale, cpb_size_scale): fixed units of 2^(6+4) and
    2^(4+4) bits — ample headroom for any Level 4.1 rate."""
    return 4, 4


def hrd_values(sps) -> tuple[int, int]:
    """(bit_rate_value_minus1, cpb_size_value_minus1) from the sps HRD
    config (nominal 2 Mbps / 1 s CPB when unset)."""
    brs, cps = hrd_scale(sps)
    br = sps.hrd_bitrate or 2_000_000
    cpb = sps.hrd_cpb_size or br
    return (max(1, br >> (6 + brs)) - 1,
            max(1, cpb >> (4 + cps)) - 1)


def parse_sps(data: bytes) -> tuple[SeqParams, list[ShortTermRPS]]:
    r = BitReader(data)
    sps = SeqParams()
    r.read(4)
    max_sub_m1 = r.read(3)
    r.read(1)
    ptl = parse_ptl(r, max_sub_m1)
    sps.profile_idc = ptl["profile_idc"]
    sps.level_idc = ptl["level_idc"]
    r.read_ue()  # sps id
    sps.chroma_format = r.read_ue()
    lumaw = r.read_ue()
    lumah = r.read_ue()
    crop_r = crop_b = crop_l = crop_t = 0
    if r.read_flag():
        crop_l = r.read_ue()
        crop_r = r.read_ue()
        crop_t = r.read_ue()
        crop_b = r.read_ue()
    sps.bit_depth = 8 + r.read_ue()
    r.read_ue()  # chroma bit depth
    sps.log2_max_poc_lsb = 4 + r.read_ue()
    sub_layer_info = r.read_flag()
    for _ in range(max_sub_m1 + 1 if sub_layer_info else 1):
        sps.max_dec_pic_buffering = r.read_ue() + 1  # keep highest layer's
        sps.num_reorder_pics = r.read_ue()
        r.read_ue()
    sps.log2_min_cu = 3 + r.read_ue()
    sps.log2_ctu = sps.log2_min_cu + r.read_ue()
    sps.log2_min_tu = 2 + r.read_ue()
    sps.log2_max_tu = sps.log2_min_tu + r.read_ue()
    sps.max_tu_depth_inter = r.read_ue()
    sps.max_tu_depth_intra = r.read_ue()
    sps.scaling_list_enabled = bool(r.read_flag())
    if sps.scaling_list_enabled:
        # only the DEFAULT scaling lists are supported (no explicit
        # scaling_list_data; HM's ScalingList=1 writes none either)
        assert r.read_flag() == 0, "explicit scaling_list_data"
    sps.amp_enabled = bool(r.read_flag())
    sps.sao_enabled = bool(r.read_flag())
    sps.pcm_enabled = bool(r.read_flag())
    if sps.pcm_enabled:
        sps.pcm_bit_depth = r.read(4) + 1
        cbd = r.read(4) + 1
        assert cbd == sps.pcm_bit_depth  # we keep one PCM depth
        sps.pcm_log2_min = 3 + r.read_ue()
        sps.pcm_log2_max = sps.pcm_log2_min + r.read_ue()
        sps.pcm_loop_filter_disabled = bool(r.read_flag())
    n_rps = r.read_ue()
    rps_list: list = []
    for i in range(n_rps):
        rps_list.append(parse_st_rps(r, first=(i == 0),
                                     prev_sets=rps_list))
    lt = r.read_flag()
    assert lt == 0
    sps.temporal_mvp_enabled = bool(r.read_flag())
    sps.strong_intra_smoothing = bool(r.read_flag())
    if r.read_flag():  # vui_parameters_present_flag (the subset we emit)
        sps.vui_timing = True
        assert r.read_flag() == 0  # aspect_ratio_info
        assert r.read_flag() == 0  # overscan
        assert r.read_flag() == 0  # video_signal_type
        assert r.read_flag() == 0  # chroma_loc
        r.read_flag()              # neutral_chroma
        r.read_flag()              # field_seq
        r.read_flag()              # frame_field_info
        assert r.read_flag() == 0  # default_display_window
        if r.read_flag():          # timing info
            r.read(32)
            sps.time_scale = r.read(32)
            r.read_flag()          # poc_proportional
            if r.read_flag():      # hrd_parameters (the subset we emit)
                sps.hrd_enabled = True
                nal = r.read_flag()
                vcl = r.read_flag()
                assert nal and not vcl
                assert r.read_flag() == 0  # sub_pic_hrd
                brs = r.read(4)
                cps = r.read(4)
                r.read(5)          # initial_cpb_removal_delay_len-1
                r.read(5)          # au_cpb_removal_delay_len-1
                r.read(5)          # dpb_output_delay_len-1
                fixed = r.read_flag()
                if fixed:
                    r.read_ue()    # elemental_duration_in_tc_minus1
                else:
                    if r.read_flag():  # fixed_within_cvs
                        r.read_ue()
                    else:
                        r.read_flag()  # low_delay_hrd
                r.read_ue()        # cpb_cnt_minus1 (0)
                sps.hrd_bitrate = (r.read_ue() + 1) << (6 + brs)
                sps.hrd_cpb_size = (r.read_ue() + 1) << (4 + cps)
                r.read_flag()      # cbr_flag
        assert r.read_flag() == 0  # bitstream_restriction
    r.read_flag()
    sps.width = lumaw - 2 * (crop_l + crop_r)
    sps.height = lumah - 2 * (crop_t + crop_b)
    return sps, rps_list


# --- PPS -------------------------------------------------------------------

def write_pps(pps: PicParams) -> bytes:
    w = BitWriter()
    w.write_ue(0)    # pps_pic_parameter_set_id
    w.write_ue(0)    # pps_seq_parameter_set_id
    w.write_flag(0)  # dependent_slice_segments_enabled_flag
    w.write_flag(0)  # output_flag_present_flag
    w.write(0, 3)    # num_extra_slice_header_bits
    w.write_flag(pps.sign_data_hiding)
    w.write_flag(pps.cabac_init_present)
    w.write_ue(pps.num_ref_idx_l0_default - 1)
    w.write_ue(pps.num_ref_idx_l1_default - 1)
    w.write_se(pps.init_qp - 26)
    w.write_flag(pps.constrained_intra_pred)
    w.write_flag(pps.transform_skip_enabled)
    w.write_flag(pps.cu_qp_delta_enabled)
    if pps.cu_qp_delta_enabled:
        w.write_ue(pps.diff_cu_qp_delta_depth)
    w.write_se(pps.cb_qp_offset)
    w.write_se(pps.cr_qp_offset)
    w.write_flag(0)  # pps_slice_chroma_qp_offsets_present_flag
    w.write_flag(pps.weighted_pred)
    w.write_flag(pps.weighted_bipred)
    w.write_flag(pps.transquant_bypass_enabled)
    w.write_flag(pps.tiles_enabled)
    w.write_flag(pps.entropy_coding_sync)
    if pps.tiles_enabled:
        w.write_ue(pps.num_tile_columns - 1)
        w.write_ue(pps.num_tile_rows - 1)
        w.write_flag(1)  # uniform_spacing_flag (only shape we emit)
        if pps.num_tile_columns + pps.num_tile_rows > 2:
            w.write_flag(pps.loop_filter_across_tiles)
    w.write_flag(pps.loop_filter_across_slices)
    w.write_flag(pps.deblocking_control_present)
    if pps.deblocking_control_present:
        w.write_flag(pps.deblocking_override_enabled)
        w.write_flag(pps.deblocking_disabled)
        if not pps.deblocking_disabled:
            w.write_se(pps.beta_offset_div2)
            w.write_se(pps.tc_offset_div2)
    w.write_flag(0)  # pps_scaling_list_data_present_flag
    w.write_flag(pps.lists_modification_present)
    w.write_ue(pps.log2_parallel_merge_level - 2)
    w.write_flag(0)  # slice_segment_header_extension_present_flag
    w.write_flag(0)  # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return w.getvalue()


def parse_pps(data: bytes) -> PicParams:
    r = BitReader(data)
    pps = PicParams()
    r.read_ue()
    r.read_ue()
    assert r.read_flag() == 0  # dependent slices unsupported
    r.read_flag()
    r.read(3)
    pps.sign_data_hiding = bool(r.read_flag())
    pps.cabac_init_present = bool(r.read_flag())
    pps.num_ref_idx_l0_default = r.read_ue() + 1
    pps.num_ref_idx_l1_default = r.read_ue() + 1
    pps.init_qp = 26 + r.read_se()
    pps.constrained_intra_pred = bool(r.read_flag())
    pps.transform_skip_enabled = bool(r.read_flag())
    pps.cu_qp_delta_enabled = bool(r.read_flag())
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = r.read_ue()
    pps.cb_qp_offset = r.read_se()
    pps.cr_qp_offset = r.read_se()
    assert r.read_flag() == 0
    pps.weighted_pred = bool(r.read_flag())
    pps.weighted_bipred = bool(r.read_flag())
    pps.transquant_bypass_enabled = bool(r.read_flag())
    pps.tiles_enabled = bool(r.read_flag())
    pps.entropy_coding_sync = bool(r.read_flag())  # WPP
    if pps.tiles_enabled:
        pps.num_tile_columns = r.read_ue() + 1
        pps.num_tile_rows = r.read_ue() + 1
        assert r.read_flag() == 1, "only uniform tile spacing supported"
        if pps.num_tile_columns + pps.num_tile_rows > 2:
            pps.loop_filter_across_tiles = bool(r.read_flag())
    pps.loop_filter_across_slices = bool(r.read_flag())
    pps.deblocking_control_present = bool(r.read_flag())
    pps.deblocking_disabled = False  # spec default when not signaled
    if pps.deblocking_control_present:
        pps.deblocking_override_enabled = bool(r.read_flag())
        pps.deblocking_disabled = bool(r.read_flag())
        if not pps.deblocking_disabled:
            pps.beta_offset_div2 = r.read_se()
            pps.tc_offset_div2 = r.read_se()
    assert r.read_flag() == 0  # scaling lists unsupported
    pps.lists_modification_present = bool(r.read_flag())
    pps.log2_parallel_merge_level = 2 + r.read_ue()
    r.read_flag()
    r.read_flag()
    return pps


# --- Slice header ----------------------------------------------------------

@dataclass
class SliceHeader:
    slice_type: int = I_SLICE
    nal_type: int = bitio.NAL_IDR_W_RADL
    poc: int = 0
    qp: int = 32
    first_slice: bool = True
    segment_address: int = 0   # first CTU (raster scan) of the segment
    sao_luma: bool = False
    sao_chroma: bool = False
    temporal_mvp: bool = False
    # reference state (P slices)
    rps: ShortTermRPS | None = None
    rps_sps_idx: int | None = None   # use SPS RPS by index if set
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 0
    five_minus_max_num_merge_cand: int = 0
    cabac_init_flag: bool = False
    mvd_l1_zero: bool = False
    collocated_from_l0: bool = True
    collocated_ref_idx: int = 0
    temporal_id: int = 0
    entry_points: list | None = None  # WPP substream byte sizes
    # explicit weighted prediction (pred_weight_table, §7.3.6.3);
    # present when (pps.weighted_pred and P) or (pps.weighted_bipred
    # and B). codec.wp.WpParams per list.
    wp_l0: object | None = None
    wp_l1: object | None = None
    # ref_pic_list_modification (§7.3.6.2): list_entry indices into the
    # cyclic temp list, or None when unmodified
    list_entry_l0: list | None = None
    list_entry_l1: list | None = None


def write_pred_weight_table(w: BitWriter, hdr: "SliceHeader") -> None:
    """pred_weight_table() (§7.3.6.3; TEncCavlc counterpart of
    TDecCavlc::xParsePredWeightTable, TDecCAVLC.cpp:1807). Chroma
    offsets are coded as deltas against the DC-compensating predictor
    128 - ((128*w) >> denom)."""
    wp0 = hdr.wp_l0
    denom_y = wp0.denom_y
    w.write_ue(denom_y)
    w.write_se(wp0.denom_c - denom_y)
    lists = [wp0] + ([hdr.wp_l1] if hdr.slice_type == B_SLICE else [])
    for wp in lists:
        for f in wp.flags:
            w.write_flag(f[0])
        for f in wp.flags:
            w.write_flag(f[1])
        for f, ws, os_ in zip(wp.flags, wp.weights, wp.offsets):
            if f[0]:
                w.write_se(ws[0] - (1 << denom_y))
                w.write_se(os_[0])
            if f[1]:
                for j in (1, 2):
                    w.write_se(ws[j] - (1 << wp.denom_c))
                    pred = 128 - ((128 * ws[j]) >> wp.denom_c)
                    w.write_se(os_[j] - pred)


def parse_pred_weight_table(r: BitReader, hdr: "SliceHeader") -> None:
    """Inverse of write_pred_weight_table; fills hdr.wp_l0/wp_l1 with
    identity entries for refs whose flags are absent
    (TDecCAVLC.cpp:1877-1912 defaults)."""
    from ..codec.wp import WpParams

    denom_y = r.read_ue()
    denom_c = denom_y + r.read_se()
    nlists = 2 if hdr.slice_type == B_SLICE else 1
    nrefs = [hdr.num_ref_idx_l0, hdr.num_ref_idx_l1]
    out = []
    for li in range(nlists):
        wp = WpParams(denom_y=denom_y, denom_c=denom_c)
        n = nrefs[li]
        fy = [r.read_flag() for _ in range(n)]
        fc = [r.read_flag() for _ in range(n)]
        for i in range(n):
            ws = [1 << denom_y, 1 << denom_c, 1 << denom_c]
            os_ = [0, 0, 0]
            if fy[i]:
                ws[0] = r.read_se() + (1 << denom_y)
                os_[0] = r.read_se()
            if fc[i]:
                for j in (1, 2):
                    ws[j] = r.read_se() + (1 << denom_c)
                    delta = r.read_se()
                    pred = 128 - ((128 * ws[j]) >> denom_c)
                    os_[j] = min(max(delta + pred, -128), 127)
            wp.flags.append([fy[i], fc[i]])
            wp.weights.append(ws)
            wp.offsets.append(os_)
        out.append(wp)
    hdr.wp_l0 = out[0]
    hdr.wp_l1 = out[1] if nlists == 2 else None


def write_slice_header(
    hdr: SliceHeader, sps: SeqParams, pps: PicParams,
    num_sps_rps: int = 0,
) -> BitWriter:
    """Returns a BitWriter positioned after byte_alignment; CABAC slice data
    is appended as bytes by the caller."""
    w = BitWriter()
    w.write_flag(1 if hdr.first_slice else 0)
    if bitio.is_irap(hdr.nal_type):
        w.write_flag(0)  # no_output_of_prior_pics_flag
    w.write_ue(0)        # slice_pic_parameter_set_id
    if not hdr.first_slice:
        nctu = sps.pic_width_in_ctus * sps.pic_height_in_ctus
        nb = max(1, (nctu - 1).bit_length())
        w.write(hdr.segment_address, nb)  # CTU raster-scan address
    w.write_ue(hdr.slice_type)
    if not bitio.is_idr(hdr.nal_type):
        w.write(hdr.poc & ((1 << sps.log2_max_poc_lsb) - 1), sps.log2_max_poc_lsb)
        if hdr.rps_sps_idx is not None:
            w.write_flag(1)  # short_term_ref_pic_set_sps_flag
            if num_sps_rps > 1:
                nbits = max(1, (num_sps_rps - 1).bit_length())
                w.write(hdr.rps_sps_idx, nbits)
        else:
            w.write_flag(0)
            write_st_rps(w, hdr.rps, num_sps_rps, first=(num_sps_rps == 0))
        if sps.temporal_mvp_enabled:
            w.write_flag(hdr.temporal_mvp)
    if sps.sao_enabled:
        w.write_flag(hdr.sao_luma)
        w.write_flag(hdr.sao_chroma)
    if hdr.slice_type != I_SLICE:
        # num_ref_idx_active_override
        override = (
            hdr.num_ref_idx_l0 != pps.num_ref_idx_l0_default
            or (hdr.slice_type == B_SLICE and hdr.num_ref_idx_l1 != pps.num_ref_idx_l1_default)
        )
        w.write_flag(override)
        if override:
            w.write_ue(hdr.num_ref_idx_l0 - 1)
            if hdr.slice_type == B_SLICE:
                w.write_ue(hdr.num_ref_idx_l1 - 1)
        nptc = sum(hdr.rps.used) if hdr.rps is not None else 0
        if pps.lists_modification_present and nptc > 1:
            nb = max(1, (nptc - 1).bit_length())
            w.write_flag(hdr.list_entry_l0 is not None)
            if hdr.list_entry_l0 is not None:
                for e in hdr.list_entry_l0[: hdr.num_ref_idx_l0]:
                    w.write(e, nb)
            if hdr.slice_type == B_SLICE:
                w.write_flag(hdr.list_entry_l1 is not None)
                if hdr.list_entry_l1 is not None:
                    for e in hdr.list_entry_l1[: hdr.num_ref_idx_l1]:
                        w.write(e, nb)
        if hdr.slice_type == B_SLICE:
            w.write_flag(hdr.mvd_l1_zero)
        if pps.cabac_init_present:
            w.write_flag(0)
        if hdr.temporal_mvp:
            if hdr.slice_type == B_SLICE:
                w.write_flag(hdr.collocated_from_l0)
            nrefs = hdr.num_ref_idx_l0 if hdr.collocated_from_l0 else hdr.num_ref_idx_l1
            if nrefs > 1:
                w.write_ue(0)  # collocated_ref_idx
        if (pps.weighted_pred and hdr.slice_type == P_SLICE) or (
                pps.weighted_bipred and hdr.slice_type == B_SLICE):
            write_pred_weight_table(w, hdr)
        w.write_ue(hdr.five_minus_max_num_merge_cand)
    w.write_se(hdr.qp - pps.init_qp)
    if pps.deblocking_control_present and pps.deblocking_override_enabled:
        w.write_flag(0)  # deblocking_filter_override_flag
    if pps.loop_filter_across_slices and (
        hdr.sao_luma or hdr.sao_chroma or not pps.deblocking_disabled
    ):
        w.write_flag(1)  # slice_loop_filter_across_slices_enabled_flag
    if pps.entropy_coding_sync or pps.tiles_enabled:
        # entry_point_offset per WPP substream after the first (0 with
        # tiles: one tile per slice segment — §7.3.6.1 codes it anyway)
        offs = hdr.entry_points or []
        w.write_ue(len(offs))
        if offs:
            maxlen = max(1, max(offs).bit_length())
            w.write_ue(maxlen - 1)
            for o in offs:
                w.write(o - 1, maxlen)
    # byte_alignment() (§7.3.2.8): the one-bit is unconditional — even when
    # already aligned it adds a full 0x80 byte
    w.write(1, 1)
    w.align_zero()
    return w


def parse_slice_header(
    data: bytes, nal_type: int, sps: SeqParams, pps: PicParams,
    sps_rps: list[ShortTermRPS],
) -> tuple[SliceHeader, int]:
    """Returns (header, offset_bytes_of_slice_data)."""
    r = BitReader(data)
    hdr = SliceHeader(nal_type=nal_type)
    hdr.first_slice = bool(r.read_flag())
    if bitio.is_irap(nal_type):
        r.read_flag()
    r.read_ue()
    if not hdr.first_slice:
        nctu = sps.pic_width_in_ctus * sps.pic_height_in_ctus
        nb = max(1, (nctu - 1).bit_length())
        hdr.segment_address = r.read(nb)
    hdr.slice_type = r.read_ue()
    if not bitio.is_idr(nal_type):
        hdr.poc = r.read(sps.log2_max_poc_lsb)
        if r.read_flag():  # from SPS
            idx = 0
            if len(sps_rps) > 1:
                idx = r.read(max(1, (len(sps_rps) - 1).bit_length()))
            hdr.rps_sps_idx = idx
            hdr.rps = sps_rps[idx]
        else:
            hdr.rps = parse_st_rps(r, first=(len(sps_rps) == 0),
                                   prev_sets=sps_rps, slice_level=True)
        if sps.temporal_mvp_enabled:
            hdr.temporal_mvp = bool(r.read_flag())
    if sps.sao_enabled:
        hdr.sao_luma = bool(r.read_flag())
        hdr.sao_chroma = bool(r.read_flag())
    if hdr.slice_type != I_SLICE:
        hdr.num_ref_idx_l0 = pps.num_ref_idx_l0_default
        hdr.num_ref_idx_l1 = pps.num_ref_idx_l1_default
        if r.read_flag():
            hdr.num_ref_idx_l0 = r.read_ue() + 1
            if hdr.slice_type == B_SLICE:
                hdr.num_ref_idx_l1 = r.read_ue() + 1
        nptc = sum(hdr.rps.used) if hdr.rps is not None else 0
        if pps.lists_modification_present and nptc > 1:
            nb = max(1, (nptc - 1).bit_length())
            if r.read_flag():  # ref_pic_list_modification_flag_l0
                hdr.list_entry_l0 = [r.read(nb)
                                     for _ in range(hdr.num_ref_idx_l0)]
            if hdr.slice_type == B_SLICE and r.read_flag():
                hdr.list_entry_l1 = [r.read(nb)
                                     for _ in range(hdr.num_ref_idx_l1)]
        if hdr.slice_type == B_SLICE:
            hdr.mvd_l1_zero = bool(r.read_flag())
        if pps.cabac_init_present:
            hdr.cabac_init_flag = bool(r.read_flag())
        if hdr.temporal_mvp:
            if hdr.slice_type == B_SLICE:
                hdr.collocated_from_l0 = bool(r.read_flag())
            nrefs = hdr.num_ref_idx_l0 if hdr.collocated_from_l0 else hdr.num_ref_idx_l1
            if nrefs > 1:
                hdr.collocated_ref_idx = r.read_ue()
        if (pps.weighted_pred and hdr.slice_type == P_SLICE) or (
                pps.weighted_bipred and hdr.slice_type == B_SLICE):
            parse_pred_weight_table(r, hdr)
        hdr.five_minus_max_num_merge_cand = r.read_ue()
    hdr.qp = pps.init_qp + r.read_se()
    if pps.deblocking_control_present and pps.deblocking_override_enabled:
        ov = r.read_flag()
        assert ov == 0
    if pps.loop_filter_across_slices and (
        hdr.sao_luma or hdr.sao_chroma or not pps.deblocking_disabled
    ):
        r.read_flag()
    if pps.entropy_coding_sync or pps.tiles_enabled:
        n = r.read_ue()
        hdr.entry_points = []
        if n:
            ln = r.read_ue() + 1
            hdr.entry_points = [r.read(ln) + 1 for _ in range(n)]
    # byte alignment
    one = r.read_flag()
    assert one == 1
    r.align()
    return hdr, r.bit_position // 8


# --- SEI: decoded picture hash (payloadType 132) ---------------------------

def write_picture_hash_sei(hashes: list[bytes], hash_type: int = 0) -> bytes:
    """Suffix SEI: per-plane decoded-picture hash. hash_type 0 = MD5
    (16 B/plane), 2 = checksum (4 B/plane, D.3.19)."""
    payload = bytearray([hash_type])
    hlen = {0: 16, 1: 2, 2: 4}[hash_type]
    for h in hashes:
        assert len(h) == hlen
        payload += h
    w = BitWriter()
    w.write(132, 8)           # payload type
    size = len(payload)
    while size >= 255:
        w.write(255, 8)
        size -= 255
    w.write(size, 8)
    w.write_bytes(bytes(payload))
    w.rbsp_trailing_bits()
    return w.getvalue()


def parse_picture_hash_sei(data: bytes) -> list[bytes] | None:
    r = BitReader(data)
    ptype = 0
    while True:
        b = r.read(8)
        ptype += b
        if b != 255:
            break
    psize = 0
    while True:
        b = r.read(8)
        psize += b
        if b != 255:
            break
    if ptype != 132:
        return None
    hash_type = r.read(8)
    if hash_type not in (0, 1, 2):
        return None
    hlen = {0: 16, 1: 2, 2: 4}[hash_type]
    n = (psize - 1) // hlen
    return hash_type, [bytes(r.read(8) for _ in range(hlen))
                       for _ in range(n)]
