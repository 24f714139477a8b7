"""Normative CABAC constants: H.265 Tables 9-40..9-44 + context init values.

These are standard-mandated constants (ITU-T H.265 §9.3.2.2, §9.3.3, Tables
9-4..9-44); every conforming implementation contains the same numbers. Layout
and code here are original. Reference counterparts for parity checking:
TComCABACTables.cpp (LPS/renorm), ContextModel.cpp:56-94 (init + state FSM),
ContextTables.h (per-syntax init values), SURVEY.md §2.1 "CABAC contexts".
"""

from __future__ import annotations

import numpy as np

# rangeTabLPS[pStateIdx][qRangeIdx] (H.265 Table 9-40)
LPS_TABLE = np.array(
    [
        [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
        [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
        [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
        [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
        [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
        [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
        [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
        [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
        [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
        [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
        [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
        [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
        [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
        [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
        [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
        [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
        [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
        [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
        [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
        [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
        [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
        [2, 2, 2, 2],
    ],
    dtype=np.uint16,
)

# number of renormalization shifts as a function of LPS>>3 (Table 9-44 equiv.)
RENORM_TABLE = np.array(
    [6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    dtype=np.uint8,
)

# State transition FSM over the combined encoding s = (pStateIdx << 1) | MPS,
# equivalent to transIdxMps/transIdxLps of H.265 Table 9-41.
NEXT_STATE_MPS = np.array(
    [2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17,
     18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
     34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49,
     50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65,
     66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81,
     82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
     98, 99, 100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111, 112,
     113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 125, 124,
     125, 126, 127],
    dtype=np.uint8,
)

NEXT_STATE_LPS = np.array(
    [1, 0, 0, 1, 2, 3, 4, 5, 4, 5, 8, 9, 8, 9, 10, 11,
     12, 13, 14, 15, 16, 17, 18, 19, 18, 19, 22, 23, 22, 23, 24, 25,
     26, 27, 26, 27, 30, 31, 30, 31, 32, 33, 32, 33, 36, 37, 36, 37,
     38, 39, 38, 39, 42, 43, 42, 43, 44, 45, 44, 45, 46, 47, 48, 49,
     48, 49, 50, 51, 52, 53, 52, 53, 54, 55, 54, 55, 56, 57, 58, 59,
     58, 59, 60, 61, 60, 61, 60, 61, 62, 63, 64, 65, 64, 65, 66, 67,
     66, 67, 66, 67, 68, 69, 68, 69, 70, 71, 70, 71, 70, 71, 72, 73,
     72, 73, 72, 73, 74, 75, 74, 75, 74, 75, 76, 77, 76, 77, 126, 127],
    dtype=np.uint8,
)

# Fractional-bit estimation table (32768 = one bit), indexed by combined
# state XOR bin. Used by the RD search / RDOQ bit estimator (the reference's
# FAST_BIT_EST m_entropyBits, ContextModel.cpp). Vectorizable on device.
ENTROPY_BITS = np.array(
    [
        0x07B23, 0x085F9, 0x074A0, 0x08CBC, 0x06EE4, 0x09354, 0x067F4, 0x09C1B,
        0x060B0, 0x0A62A, 0x05A9C, 0x0AF5B, 0x0548D, 0x0B955, 0x04F56, 0x0C2A9,
        0x04A87, 0x0CBF7, 0x045D6, 0x0D5C3, 0x04144, 0x0E01B, 0x03D88, 0x0E937,
        0x039E0, 0x0F2CD, 0x03663, 0x0FC9E, 0x03347, 0x10600, 0x03050, 0x10F95,
        0x02D4D, 0x11A02, 0x02AD3, 0x12333, 0x0286E, 0x12CAD, 0x02604, 0x136DF,
        0x02425, 0x13F48, 0x021F4, 0x149C4, 0x0203E, 0x1527B, 0x01E4D, 0x15D00,
        0x01C99, 0x166DE, 0x01B18, 0x17017, 0x019A5, 0x17988, 0x01841, 0x18327,
        0x016DF, 0x18D50, 0x015D9, 0x19547, 0x0147C, 0x1A083, 0x0138E, 0x1A8A3,
        0x01251, 0x1B418, 0x01166, 0x1BD27, 0x01068, 0x1C77B, 0x00F7F, 0x1D18E,
        0x00EDA, 0x1D91A, 0x00E19, 0x1E254, 0x00D4F, 0x1EC9A, 0x00C90, 0x1F6E0,
        0x00C01, 0x1FEF8, 0x00B5F, 0x208B1, 0x00AB6, 0x21362, 0x00A15, 0x21E46,
        0x00988, 0x2285D, 0x00934, 0x22EA8, 0x008A8, 0x239B2, 0x0081D, 0x24577,
        0x007C9, 0x24CE6, 0x00763, 0x25663, 0x00710, 0x25E8F, 0x006A0, 0x26A26,
        0x00672, 0x26F23, 0x005E8, 0x27EF8, 0x005BA, 0x284B5, 0x0055E, 0x29057,
        0x0050C, 0x29BAB, 0x004C1, 0x2A674, 0x004A7, 0x2AA5E, 0x0046F, 0x2B32F,
        0x0041F, 0x2C0AD, 0x003E7, 0x2CA8D, 0x003BA, 0x2D323, 0x0010C, 0x3BFBB,
    ],
    dtype=np.int32,
)


def init_state(qp: int, init_value: int) -> int:
    """Map 8-bit initValue + slice QP to the combined context state
    (H.265 §9.3.2.2; ContextModel::init)."""
    qp = min(max(qp, 0), 51)
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    s = min(max(1, ((slope * qp) >> 4) + offset), 126)
    mps = 1 if s >= 64 else 0
    return (((s - 64) if mps else (63 - s)) << 1) + mps


CNU = 154  # context-not-used dummy init value

# Per-syntax init values, rows = slice type index used at init time
# (0=B, 1=P, 2=I) following the reference's NUMBER_OF_SLICE_TYPES layout.
# Values are H.265 Tables 9-5..9-32 constants.
INIT_VALUES: dict[str, list[list[int]]] = {
    "cu_transquant_bypass": [[154], [154], [154]],
    "split_cu_flag": [[107, 139, 126], [107, 139, 126], [139, 141, 157]],
    "cu_skip_flag": [[197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]],
    "merge_flag": [[154], [110], [CNU]],
    "merge_idx": [[137], [122], [CNU]],
    "part_mode": [[154, 139, 154, 154], [154, 139, 154, 154], [184, CNU, CNU, CNU]],
    "pred_mode_flag": [[134], [149], [CNU]],
    "prev_intra_luma_pred_flag": [[183], [154], [184]],
    "intra_chroma_pred_mode": [[152, 139], [152, 139], [63, 139]],
    "inter_pred_idc": [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31], [CNU] * 5],
    "abs_mvd_greater_flag": [[169, 198], [140, 198], [CNU, CNU]],
    "ref_idx": [[153, 153], [153, 153], [CNU, CNU]],
    "cu_qp_delta": [[154, 154, 154]] * 3,
    "chroma_qp_adj_flag": [[154], [154], [154]],
    "chroma_qp_adj_idc": [[154], [154], [154]],
    # cbf: 5 luma contexts then 5 chroma contexts
    "qt_cbf": [
        [153, 111, CNU, CNU, CNU, 149, 92, 167, 154, 154],
        [153, 111, CNU, CNU, CNU, 149, 107, 167, 154, 154],
        [111, 141, CNU, CNU, CNU, 94, 138, 182, 154, 154],
    ],
    "rqt_root_cbf": [[79], [79], [CNU]],
    # last significant position: separate x and y context banks (30 each,
    # same init values — the reference's m_cCuCtxLastX/m_cCuCtxLastY both
    # init from INIT_LAST). Layout: x luma 0-14, x chroma 15-29, then y.
    "last_sig_xy": [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79,
         108, 123, 93, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU] * 2,
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94,
         108, 123, 108, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU] * 2,
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79,
         108, 123, 63, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU, CNU] * 2,
    ],
    # coded_sub_block_flag: 2 luma + 2 chroma
    "sig_cg_flag": [
        [121, 140, 61, 154],
        [121, 140, 61, 154],
        [91, 171, 134, 141],
    ],
    # sig_coeff_flag: 28 luma (2.1 layout) + 16 chroma (but HEVC spec uses 27+15
    # plus shared DC handling; the 28th/16th is the single TS context)
    "sig_coeff_flag": [
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
         170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183,
         140, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 140,
         170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183,
         140, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 141,
         140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139,
         111, 111],
    ],
    # coeff_abs_level_greater1: 16 luma (4 sets x 4) + 8 chroma (2 sets x 4)
    "coeff_gt1": [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121,
         136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
         122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    ],
    # coeff_abs_level_greater2: 4 luma sets + 2 chroma sets
    "coeff_gt2": [
        [107, 167, 91, 107, 107, 167],
        [107, 167, 91, 122, 107, 167],
        [138, 153, 136, 167, 152, 152],
    ],
    "mvp_flag": [[168], [168], [CNU]],
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[160], [185], [200]],
    "split_transform_flag": [
        [224, 167, 122], [124, 138, 94], [153, 138, 138]
    ],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],
    "explicit_rdpcm_flag": [[139, 139], [139, 139], [CNU, CNU]],
    "explicit_rdpcm_dir": [[139, 139], [139, 139], [CNU, CNU]],
    "cross_comp_pred": [[154] * 10, [154] * 10, [154] * 10],
}
