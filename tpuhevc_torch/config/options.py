"""HM-compatible option parsing.

Supports the reference's config syntax (program_options_lite): `Key : value`
lines, `#` comments, cascading `-c file.cfg` (later files/CLI override
earlier), `--Key=value` long options and the common short options. The GOP
table (`Frame1: P 1 3 0.4624 ...`) is parsed into GopEntry records.

Unknown keys are collected (not fatal) so the reference's full cfg files
parse cleanly; keys that name not-yet-implemented features raise only when
they would silently change conformance.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..codec.params import EncoderConfig, SeqParams


@dataclass
class GopEntry:
    slice_type: str = "P"
    poc_offset: int = 1
    qp_offset: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    qp_factor: float = 0.5
    tc_offset_div2: int = 0
    beta_offset_div2: int = 0
    temporal_id: int = 0
    num_ref_pics_active: int = 1
    ref_pics: list = field(default_factory=list)  # delta POCs
    inter_rps_predict: int = 0
    delta_rps: int = 0
    ref_idcs: list = field(default_factory=list)


def parse_cfg_file(path: str, into: dict | None = None) -> dict:
    """One cfg file -> {key: value-string}; GOP rows under 'Frame<N>'."""
    out = into if into is not None else {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if ":" in line:
                key, val = line.split(":", 1)
            elif "=" in line:
                key, val = line.split("=", 1)
            else:
                continue
            out[key.strip()] = val.strip()
    return out


def parse_gop_entry(val: str) -> GopEntry:
    """HM-16.9 GOP row (TAppEncCfg.cpp istream>>GOPEntry):
    Type POC QPoffset CbQPoffset CrQPoffset QPfactor tcOffsetDiv2
    betaOffsetDiv2 temporal_id #ref_pics_active #ref_pics ref_pics...
    predict [deltaRPS #ref_idcs ref_idcs...]. Older two-column variants
    (QPfactor directly after QPoffset) are auto-detected by locating the
    float column."""
    t = val.split()
    e = GopEntry()
    e.slice_type = t[0]
    e.poc_offset = int(t[1])
    e.qp_offset = int(t[2])
    # locate QPfactor: the first token containing '.' among columns 3..5
    fi = next((i for i in (3, 4, 5) if i < len(t) and "." in t[i]), 3)
    if fi == 5:  # genuine HM-16.9 layout with chroma QP offset columns
        e.cb_qp_offset = int(t[3])
        e.cr_qp_offset = int(t[4])
    e.qp_factor = float(t[fi])
    try:
        e.tc_offset_div2 = int(t[fi + 1])
        e.beta_offset_div2 = int(t[fi + 2])
        e.temporal_id = int(t[fi + 3])
        e.num_ref_pics_active = int(t[fi + 4])
        nref = int(t[fi + 5])
        e.ref_pics = [int(x) for x in t[fi + 6 : fi + 6 + nref]]
        p = fi + 6 + nref
        e.inter_rps_predict = int(t[p])
        if e.inter_rps_predict:
            e.delta_rps = int(t[p + 1])
            nidc = int(t[p + 2])
            e.ref_idcs = [int(x) for x in t[p + 3 : p + 3 + nidc]]
    except (IndexError, ValueError):
        pass
    return e


def parse_args(argv: list[str]) -> dict:
    """CLI args -> raw option dict (cfg files expanded, later wins)."""
    opts: dict = {}
    i = 0
    short = {
        "-i": "InputFile", "-b": "BitstreamFile", "-o": "ReconFile",
        "-wdt": "SourceWidth", "-hgt": "SourceHeight", "-fr": "FrameRate",
        "-f": "FramesToBeEncoded", "-q": "QP", "-ip": "IntraPeriod",
        "-g": "GOPSize", "-sr": "SearchRange",
    }
    while i < len(argv):
        a = argv[i]
        if a == "-c":
            parse_cfg_file(argv[i + 1], opts)
            i += 2
        elif a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
            i += 1
        elif a in short:
            opts[short[a]] = argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"unknown option: {a}")
    return opts


_TRUE = {"1", "true", "yes", "on"}


def _b(v: str) -> bool:
    return v.strip().lower() in _TRUE


# SEIDecodedPictureHash (HM) -> EncoderConfig.hash_type
_HASH_TYPES = {1: "md5", 2: "crc", 3: "checksum"}


# Keys accepted ONLY at their HM default: any other value would require
# a feature this encoder does not implement (silently ignoring it would
# change conformance or the coded toolset). Value = the accepted string.
_DEFAULT_ONLY = {
    "TransquantBypassEnableFlag": "0",
    "CUTransquantBypassFlagForce": "0",
    "SAOLcuBoundary": "0",
    "DeltaQpRD": "0",
    "MaxDeltaQP": "0",
    "DeblockingFilterMetric": "0",
    "SliceChromaQPOffsetPeriodicity": "0",
}

# Encoder-speed knobs of HM's RD search with no counterpart in this
# architecture (dense batched decisions instead of HM's pruned
# recursion) — accepted and inert by design, any value.
_ACCEPTED_NOOP = {
    "FDM", "FEN", "FastSearch", "ESD", "ASR", "RDpenalty",
    "TransformSkipFast", "RDOQTS", "KeepHierarchicalBit",
    "RCForceIntraQP", "RCLCUSeparateModel", "ScalingListFile",
    "LoopFilterOffsetInPPS",
    "PCMInputBitDepthFlag", "SliceCbQpOffsetIntraOrPeriodic",
    "SliceCrQpOffsetIntraOrPeriodic", "Tier",
}


def build_config(opts: dict) -> tuple[EncoderConfig, dict]:
    """Raw options -> (EncoderConfig, io dict). io: InputFile etc."""
    cfg = EncoderConfig(sps=SeqParams())
    sps = cfg.sps
    gop: list[GopEntry] = []
    unknown = {}
    slice_mode = 0
    for k, v in opts.items():
        if k == "SourceWidth":
            sps.width = int(v)
        elif k == "SourceHeight":
            sps.height = int(v)
        elif k == "InternalBitDepth" or k == "InputBitDepth":
            bd = int(v)
            if bd not in (8, 10):
                raise NotImplementedError("bit depth must be 8 or 10")
            sps.bit_depth = bd
            if bd == 10:
                sps.profile_idc = 2  # Main10
        elif k == "FrameRate":
            cfg.frame_rate = int(float(v))
        elif k == "SEIBufferingPeriod":
            # HRD timing: VUI hrd_parameters + buffering-period /
            # pic-timing SEIs (TEncCfg m_bufferingPeriodSEIEnabled)
            if _b(v):
                sps.hrd_enabled = True
                sps.vui_timing = True
        elif k == "SEIPictureTiming":
            if _b(v):
                sps.vui_timing = True
        elif k == "ScalingList":
            sl = int(v)
            if sl > 1:
                raise NotImplementedError(
                    "only default scaling lists (ScalingList 0/1)")
            sps.scaling_list_enabled = sl == 1
        elif k == "PCMEnabledFlag":
            sps.pcm_enabled = _b(v)
        elif k == "PCMLog2MaxSize":
            sps.pcm_log2_max = int(v)
        elif k == "PCMLog2MinSize":
            sps.pcm_log2_min = int(v)
        elif k == "PCMFilterDisableFlag":
            sps.pcm_loop_filter_disabled = _b(v)
        elif k == "FramesToBeEncoded":
            cfg.frames = int(v)
        elif k == "QP":
            cfg.qp = int(float(v))
        elif k == "IntraPeriod":
            cfg.intra_period = int(v)
        elif k == "GOPSize":
            cfg.gop_size = int(v)
        elif k == "SearchRange":
            cfg.search_range = int(v)
        elif k in ("MaxCUSize", "MaxCUWidth", "MaxCUHeight"):
            sps.log2_ctu = int(v).bit_length() - 1
        elif k == "MaxPartitionDepth":
            sps.log2_min_cu = sps.log2_ctu - int(v) + 1
        elif k == "QuadtreeTULog2MaxSize":
            sps.log2_max_tu = int(v)
        elif k == "QuadtreeTULog2MinSize":
            sps.log2_min_tu = int(v)
        elif k == "QuadtreeTUMaxDepthIntra":
            sps.max_tu_depth_intra = int(v) - 1
        elif k == "QuadtreeTUMaxDepthInter":
            sps.max_tu_depth_inter = int(v) - 1
        elif k == "SAO":
            sps.sao_enabled = _b(v)
        elif k == "RDOQ":
            cfg.rdoq = _b(v)
        elif k == "WaveFrontSynchro":
            cfg.pps.entropy_coding_sync = _b(v)
        elif k == "Tiles":  # shorthand: enable the uniform grid
            cfg.pps.tiles_enabled = _b(v)
        elif k == "NumTileColumnsMinus1":
            cfg.pps.num_tile_columns = int(v) + 1
            cfg.pps.tiles_enabled |= int(v) > 0
        elif k == "NumTileRowsMinus1":
            cfg.pps.num_tile_rows = int(v) + 1
            cfg.pps.tiles_enabled |= int(v) > 0
        elif k == "UniformSpacingIdc":
            assert _b(v) or not cfg.pps.tiles_enabled, \
                "only uniform tile spacing supported"
        elif k == "LFCrossTileBoundaryFlag":
            cfg.pps.loop_filter_across_tiles = _b(v)
        elif k == "SliceMode":
            assert int(v) in (0, 1), "only SliceMode 0/1 (CTU count)"
            slice_mode = int(v)
            if slice_mode == 0:
                cfg.slice_ctus = 0
        elif k == "SliceArgument":
            if slice_mode == 1:
                cfg.slice_ctus = int(v)
        elif k == "NumRefFrames":  # active L0 refs (HM GOP-table column)
            cfg.num_ref_frames = int(v)
        elif k == "RateControl":
            if not _b(v):
                cfg.target_bitrate = 0
        elif k == "TargetBitrate":
            cfg.target_bitrate = int(v)
        elif k == "LCULevelRateControl":
            cfg.rc_ctu = _b(v)
        elif k == "AdaptiveQP":
            cfg.adaptive_qp = _b(v)
        elif k == "MaxQPAdaptationRange":
            cfg.aq_range = int(v)
        elif k == "LoopFilterDisable":
            cfg.deblocking = not _b(v)
        elif k == "AMP":
            sps.amp_enabled = _b(v)
        elif k == "HadamardME":
            cfg.hadamard_me = _b(v)
        elif k == "WeightedPredP":
            cfg.pps.weighted_pred = _b(v)
        elif k == "WeightedPredB":
            cfg.pps.weighted_bipred = _b(v)
        elif k == "SignHideFlag":
            cfg.pps.sign_data_hiding = _b(v)
        elif k == "MaxNumMergeCand":
            cfg.max_num_merge_cand = int(v)
        elif k == "TemporalMVP" or k == "TMVPMode":
            cfg.tmvp = int(v) != 0  # granted at encode_sequence when
            # the grid path + native col walk carry it
        elif k == "FmeMode":
            cfg.fme_mode = v.strip()
        elif k == "NNWeightsDir":
            cfg.nn_weights_dir = v.strip()
        elif k == "SEIDecodedPictureHash":  # HM: 1 MD5, 2 CRC, 3 checksum
            if int(v) not in _HASH_TYPES:
                raise NotImplementedError(
                    f"SEIDecodedPictureHash {v}: only 1 (MD5), 2 (CRC) "
                    "or 3 (checksum)")
            cfg.hash_type = _HASH_TYPES[int(v)]
        elif k == "Level":
            cfg.sps.level_idc = int(float(v) * 30)
        elif k == "LoopFilterBetaOffset_div2":
            cfg.pps.beta_offset_div2 = int(v)
            assert int(v) == 0, "deblock beta offset not applied yet"
        elif k == "LoopFilterTcOffset_div2":
            cfg.pps.tc_offset_div2 = int(v)
            assert int(v) == 0, "deblock tc offset not applied yet"
        elif k == "LFCrossSliceBoundaryFlag":
            cfg.pps.loop_filter_across_slices = _b(v)
        elif k == "MaxCuDQPDepth":
            cfg.pps.diff_cu_qp_delta_depth = int(v)
            assert int(v) == 0, "cu_qp_delta QG = CTU only"
        elif k == "CbQpOffset":
            cfg.pps.cb_qp_offset = int(v)
        elif k == "CrQpOffset":
            cfg.pps.cr_qp_offset = int(v)
        elif k == "TransformSkip":
            cfg.pps.transform_skip_enabled = _b(v)
        elif k == "DecodingRefreshType":
            cfg.decoding_refresh_type = int(v)
        elif k == "Profile":
            p = v.strip().lower()
            assert p in ("main", "main10"), f"profile {v} unsupported"
        elif k == "BipredSearchRange":
            cfg.bipred_search_range = int(v)
        elif k == "InitialQP":
            cfg.rc_initial_qp = int(v)
        elif k in ("TileColumnWidthArray", "TileRowHeightArray",
                   "ColumnWidthArray", "RowHeightArray"):
            assert not v.strip() or not cfg.pps.tiles_enabled, \
                "only uniform tile spacing supported"
        elif k == "TileUniformSpacing":
            assert _b(v) or not cfg.pps.tiles_enabled, \
                "only uniform tile spacing supported"
        elif k in _DEFAULT_ONLY:
            # accepted only at the HM default — a non-default value
            # names a feature this encoder does not implement, and
            # ignoring it would silently change conformance/behavior
            if v.strip() != _DEFAULT_ONLY[k]:
                raise NotImplementedError(
                    f"{k} = {v!r} not supported (only {_DEFAULT_ONLY[k]})")
        elif k in _ACCEPTED_NOOP:
            pass  # encoder-speed knobs of HM's search; our search is
            # structurally different, the knobs have no counterpart
        elif k.startswith("Frame") and k[5:].isdigit():
            gop.append(parse_gop_entry(v))
        else:
            unknown[k] = v
    # apply the GOP table (cfg Frame1..FrameN rows): low-delay tables (all
    # poc_offset ascending by 1) drive per-position QP offsets and the
    # active-reference count (encoder_lowdelay_P_main.cfg:23-28).
    # Frame1..FrameN row order IS decode order (TEncGOP traversal) — keep
    # it for the table-driven hierarchical structure.
    decode_order = tuple(gop)
    gop = sorted(gop, key=lambda e: e.poc_offset)
    if gop and all(e.slice_type == "P" for e in gop) \
            and [e.poc_offset for e in gop] == list(range(1, len(gop) + 1)):
        cfg.gop_qp_offsets = tuple(e.qp_offset for e in gop)
        cfg.gop_qp_factors = tuple(e.qp_factor for e in gop)
        nact = max((e.num_ref_pics_active for e in gop), default=1)
        if nact > 1:
            cfg.num_ref_frames = nact
    elif gop and any(e.slice_type == "B" for e in gop):
        cfg.gop_structure = "ra"  # hierarchical-B random access
        cfg.gop_table = decode_order
    io = {
        "InputFile": opts.get("InputFile"),
        "BitstreamFile": opts.get("BitstreamFile"),
        "ReconFile": opts.get("ReconFile"),
        "gop_table": gop,
        "unknown": unknown,
    }
    return cfg, io
