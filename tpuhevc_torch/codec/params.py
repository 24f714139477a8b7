"""Sequence/picture parameter model: the subset of H.265 SPS/PPS state the
framework supports, plus encoder-side configuration.

Counterpart of the reference's TComSlice.h parameter-set classes (TComSPS,
TComPPS, TComVPS — SURVEY.md §2.1 "Slice / parameter sets") and TEncCfg.h's
encoder config surface, collapsed to plain dataclasses. Anything the encoder
does not yet exercise defaults to its conforming 'off' value.
"""

from __future__ import annotations

from dataclasses import dataclass, field

I_SLICE = 2
P_SLICE = 1
B_SLICE = 0


@dataclass
class SeqParams:
    """SPS-level state (+ the profile/level we advertise)."""

    width: int = 416
    height: int = 240
    bit_depth: int = 8
    chroma_format: int = 1  # 420 only for now (reference Main profile anchor)

    log2_ctu: int = 6           # MaxCUWidth 64
    log2_min_cu: int = 3        # MinCUSize 8
    log2_min_tu: int = 2        # QuadtreeTULog2MinSize 4
    log2_max_tu: int = 5        # QuadtreeTULog2MaxSize 32
    max_tu_depth_intra: int = 1  # max_transform_hierarchy_depth_intra
    max_tu_depth_inter: int = 1

    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: int = 5  # minus1 coded
    num_reorder_pics: int = 0

    amp_enabled: bool = True
    sao_enabled: bool = False
    temporal_mvp_enabled: bool = False
    strong_intra_smoothing: bool = True
    scaling_list_enabled: bool = False
    pcm_enabled: bool = False
    # PCM (I_PCM raw-sample CUs, §7.3.2.2.1 / TypeDef PCM defaults)
    pcm_bit_depth: int = 8          # luma == chroma PCM sample depth
    pcm_log2_min: int = 3           # log2 min PCM CU size
    pcm_log2_max: int = 5           # log2 max PCM CU size
    pcm_loop_filter_disabled: bool = False

    vui_timing: bool = False    # minimal VUI: timing + frame_field_info
    time_scale: int = 50        # vui_time_scale (fps, num_units 1)
    hrd_enabled: bool = False   # VUI hrd_parameters (E.2.2, one NAL CPB)
    hrd_bitrate: int = 0        # bps (0 -> nominal when HRD on)
    hrd_cpb_size: int = 0       # bits (0 -> 1 second at hrd_bitrate)

    profile_idc: int = 1  # Main
    level_idc: int = 123  # 4.1
    tier_flag: int = 0

    # derived ------------------------------------------------------------
    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu

    @property
    def pic_width_in_ctus(self) -> int:
        return (self.width + self.ctu_size - 1) >> self.log2_ctu

    @property
    def pic_height_in_ctus(self) -> int:
        return (self.height + self.ctu_size - 1) >> self.log2_ctu

    @property
    def num_ctus(self) -> int:
        return self.pic_width_in_ctus * self.pic_height_in_ctus

    @property
    def max_cu_depth(self) -> int:
        return self.log2_ctu - self.log2_min_cu

    @property
    def coded_width(self) -> int:
        """pic_width_in_luma_samples: true width padded to the min-CU grid."""
        mincu = 1 << self.log2_min_cu
        return (self.width + mincu - 1) // mincu * mincu

    @property
    def coded_height(self) -> int:
        mincu = 1 << self.log2_min_cu
        return (self.height + mincu - 1) // mincu * mincu


@dataclass
class PicParams:
    """PPS-level state."""

    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: bool = False
    transform_skip_enabled: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    weighted_pred: bool = False
    weighted_bipred: bool = False
    lists_modification_present: bool = False
    transquant_bypass_enabled: bool = False
    loop_filter_across_slices: bool = True
    deblocking_control_present: bool = True
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = True
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    log2_parallel_merge_level: int = 2  # minus2 coded
    entropy_coding_sync: bool = False   # WPP: per-CTU-row substreams
    tiles_enabled: bool = False         # uniform-spacing tile grid
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    loop_filter_across_tiles: bool = True


@dataclass
class EncoderConfig:
    """Top-level encoder configuration (TEncCfg-equivalent subset)."""

    sps: SeqParams = field(default_factory=SeqParams)
    pps: PicParams = field(default_factory=PicParams)

    qp: int = 32
    frames: int = 8
    frame_rate: int = 50
    intra_period: int = 1        # 1 = all intra, -1 = first frame only
    gop_size: int = 4
    search_range: int = 64
    hadamard_me: bool = True
    fme_mode: str = "nn"         # nn | dctif | none (TEncSearch.cpp:4534-4590 A/B)
    nn_weights_dir: str | None = None
    max_num_merge_cand: int = 5
    num_ref_frames: int = 1      # active L0 refs (anchor LD-P uses 4)
    gop_structure: str = "ldp"   # ldp | ra (hierarchical-B)
    gop_table: tuple = ()        # config.options.GopEntry rows in decode
                                 # order; drives the RA structure when set
    target_bitrate: int = 0      # bps; > 0 enables R-lambda rate control
    rc_ctu: bool = False         # CTU-level allocation (HM LCULevelRC):
                                 # per-CTU QP via cu_qp_delta
    adaptive_qp: bool = False    # source-activity AQ (TEncPreanalyzer)
    aq_range: int = 6            # MaxQPAdaptationRange
    tmvp: bool = True            # request TMVP (SPS flag granted when the
                                 # grid path + native col walk carry it)
    ctu_qp_map: object = None    # per-frame (hctu, wctu) QpY map the host
                                 # pipelines quantize with (set by RC)
    intra_qt: bool = True        # quadtree intra CUs 8/16/32 (vs fixed 8x8)
    # NxN 4x4 PUs + one-level intra RQT in the I-frame decision. None =
    # auto: on for all-intra encodes, off for the LD-P scan's single
    # IDR (the general coding walk with closed-loop arbitration is
    # host-side; the 2Nx2N TU=CU subset rides the native fast path)
    intra_nxn: bool | None = None
    # two-pass intra decision: re-run the open-loop decide with pass-1
    # recon as the reference-sample source (removes the clean-ref bias
    # that over-splits toward 8-CUs), then recode. ~2x the I-frame cost.
    intra_two_pass: bool = True
    slice_ctus: int = 0          # >0: fixed-CTU-count slices (HM SliceMode
                                 # 1 / SliceArgument); 0 = one slice/pic
    decoding_refresh_type: int = 0   # 0 off, 1 CRA, 2 IDR (HM DRT)
    bipred_search_range: int = 4     # HM BipredSearchRange (iterative ME)
    rc_initial_qp: int = 0           # rate control InitialQP (0 = auto)
    rdoq: bool = False           # RD-optimized quantization (host paths)

    hash_type: str = "md5"       # decoded-picture-hash SEI: md5|crc|checksum
    fetch_recon: bool = True     # False: leave the grid's P recon on the
                                 # device (checksum hash + PSNR computed
                                 # there; no ReconFile)
    gop_qp_offsets: tuple = ()   # per-GOP-position P-frame QP offsets (HM
                                 # GOP table QPoffset column; () = flat QP)
    gop_qp_factors: tuple = ()   # per-GOP-position QPfactor column; when
                                 # empty, the CTC LD-P defaults apply
                                 # (0.4624, key picture 0.578)
    deblocking: bool = False     # in-loop deblocking filter (host pass)

    # encoder-side lambda model (TEncSlice.cpp:295-310)
    lambda_qp_factor: float = 0.57  # intra QPfactor as in HM for I slices
    frame_lambda: float = 0.0    # per-frame picture lambda (set by the
                                 # encoder from p_frame_lambda; 0 = derive
                                 # from qp with flat defaults)


def p_frame_lambda(cfg: EncoderConfig, gpos: int, frame_qp: int) -> float:
    """Full HM picture lambda for the P frame at GOP position index
    `gpos` (0-based: frames with POC % G == (gpos+1) % G). Includes the
    QPfactor column and the depth>0 multiplier (TEncSlice.cpp:283-325)."""
    from ..utils.tables import gop_depth, slice_lambda

    G = max(1, len(cfg.gop_qp_offsets))
    if cfg.gop_qp_factors and len(cfg.gop_qp_factors) >= G:
        qf = float(cfg.gop_qp_factors[gpos % G])
    elif G > 1 and (gpos + 1) % G == 0:
        qf = 0.578  # CTC LD-P key-picture factor
    else:
        qf = 0.4624
    depth = gop_depth((gpos + 1) % G, G) if G > 1 else 0
    return slice_lambda(frame_qp, qf, depth, G)


def i_frame_lambda(cfg: EncoderConfig, frame_qp: int) -> float:
    """I-slice lambda: 0.57 * (1 - clip(0.05*(GOPSize-1))) * 2^((qp-12)/3)."""
    from ..utils.tables import slice_lambda

    G = max(1, len(cfg.gop_qp_offsets) or cfg.gop_size)
    if cfg.intra_period == 1:
        G = 1  # all-intra: no GOP hierarchy, full 0.57
    return slice_lambda(frame_qp, 0.57, 0, G, is_intra=True)
