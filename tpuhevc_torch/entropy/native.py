"""ctypes binding for the native entropy encoder (the byte-identical
fast path of encode_slice_data for I and P slices, and the decode-order
merge/skip/AMVP walk of the grid step's decision maps; the closed-loop
intra walk is bound in `codec/native_intra.py`).

The library is `native/libtpuhevc_entropy.so` at the repository root,
beside the C++ sources it is built from. Where that file is absent, the
first use builds it from `native/*.cpp` into `build/` with the flags of
`tools/build_native.sh`; where it can be neither built nor loaded,
`get_lib` raises."""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCES = ("entropy_enc.cpp", "intra_walk.cpp", "decision_walk.cpp")


def _lib_path() -> str:
    return os.path.join(_ROOT, "native", "libtpuhevc_entropy.so")


def _build() -> str:
    """Compile native/*.cpp into build/libtpuhevc_entropy.so (atomic
    rename, so a concurrent process never maps half a file)."""
    out = os.path.join(_ROOT, "build", "libtpuhevc_entropy.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-o", tmp] + [os.path.join(_ROOT, "native", s) for s in _SOURCES],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library; builds it first where the committed file is
    absent. Raises if it can be neither built nor loaded: the encoder has
    no silent slower path."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _lib_path()
    if not os.path.exists(path):
        try:
            path = _build()
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise RuntimeError(
                f"native entropy library: {_lib_path()} is absent and "
                f"building it from native/*.cpp failed: {e} "
                f"{detail.decode(errors='replace')[-2000:]}") from e
    lib = ctypes.CDLL(path)
    lib.tpuhevc_encode_slice_data_v5.restype = ctypes.c_int
    lib.tpuhevc_encode_slice_data_v5.argtypes = (
        [ctypes.POINTER(ctypes.c_int32)] * 13 + [ctypes.c_int] * 2
        + [ctypes.POINTER(ctypes.c_int32)] * 2 + [ctypes.c_int]
        + [ctypes.POINTER(ctypes.c_int32)] + [ctypes.c_int] * 14
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
           ctypes.POINTER(ctypes.c_int32)])
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    lib.tpuhevc_decision_walk_map.restype = ctypes.c_int
    lib.tpuhevc_decision_walk_map.argtypes = (
        [u8p, i32p, u8p, u8p] + [ctypes.c_int] * 5 + [i32p] * 8)
    lib.tpuhevc_decision_walk_map_part.restype = ctypes.c_int
    lib.tpuhevc_decision_walk_map_part.argtypes = (
        [u8p, i32p] + [u8p] * 3 + [ctypes.c_int] * 5 + [i32p] * 8)
    lib.tpuhevc_decision_walk_map_col.restype = ctypes.c_int
    lib.tpuhevc_decision_walk_map_col.argtypes = (
        [u8p, i32p] + [u8p] * 3 + [i32p] * 2 + [ctypes.c_int] * 5
        + [i32p] * 8)
    _LIB = lib
    return _LIB


def decision_walk_map_native(log2_map, mv_map, ref_map, cbf_map, W, H,
                             log2_ctu, max_merge, num_ref: int = 1,
                             part_map=None, col=None) -> dict:
    """The native decode-order walk of the grid step's final per-8x8-cell
    maps (cu_log2, mv, ref (255: intra), cbf[, part]) -> the FrameSyntax
    merge/skip/AMVP maps (per PU at the PU-origin cells of rectangular
    partitions). col: the TMVP collocated motion (col_mv16 (h16, w16, 2)
    int32, col_td16 (h16, w16) int32: POC distance from the collocated
    picture to its reference per 16x16 block, 0 = invalid). Raises where
    the walk fails; the library must export the three walk entry points
    (`get_lib` binds them and fails without them)."""
    lib = get_lib()
    h8, w8 = H // 8, W // 8

    def u8(a):
        a = np.ascontiguousarray(a, dtype=np.uint8)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def i32(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    keep = [u8(log2_map), i32(mv_map), u8(ref_map), u8(cbf_map)]
    outs = [np.zeros((h8, w8), np.int32) for _ in range(6)]
    mv = np.zeros((h8, w8, 2), np.int32)
    mvd = np.zeros((h8, w8, 2), np.int32)
    # order: cu_log2, mv, ref, skip, merge_flag, merge_idx, mvp_flag, mvd
    arrs = [outs[0], mv, outs[1], outs[2], outs[3], outs[4], outs[5], mvd]
    outp = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) for a in arrs]
    ins = [p for _, p in keep]
    dims = (W, H, log2_ctu, max_merge, num_ref)
    if col is not None:
        pm = u8(part_map if part_map is not None else np.zeros((h8, w8)))
        cm, ct = i32(col[0]), i32(col[1])
        keep += [pm, cm, ct]
        rc = lib.tpuhevc_decision_walk_map_col(
            *ins, pm[1], cm[1], ct[1], *dims, *outp)
    elif part_map is not None and np.any(part_map):
        pm = u8(part_map)
        keep.append(pm)
        rc = lib.tpuhevc_decision_walk_map_part(*ins, pm[1], *dims, *outp)
    else:
        rc = lib.tpuhevc_decision_walk_map(*ins, *dims, *outp)
    if rc != 0:
        raise RuntimeError(f"native decision walk failed ({rc})")
    cu_log2, ref, skipf, merge_flag, merge_idx, mvp_flag = outs
    return dict(cu_log2=cu_log2, mv=mv, ref=ref, skip=skipf,
                merge_flag=merge_flag, merge_idx=merge_idx,
                mvp_flag=mvp_flag, mvd=mvd)


def encode_slice_data_native(fs, sps, pps, slice_type_row: int, qp: int,
                             slice_type: int = 2, max_merge: int = 5,
                             num_ref: int = 1,
                             ctx_out: np.ndarray | None = None
                             ) -> bytes | None:
    """Full slice-data payload (CABAC bytes + rbsp trailing) of an I or P
    slice, or None for a frame whose features the native coder does not
    cover (per-CTU QP deltas, I-slice NxN PUs or TU splits, 4x4 TU leaves
    in P, intra CUs of a P slice other than whole-CU 2Nx2N): the caller
    then takes the Python coder. slice_type: 2 = I, 1 = P. ctx_out: an int32 buffer of at
    least 202 entries that receives the end-of-slice context states (the
    grid step's adaptive bit-estimator feedback)."""
    if ctx_out is not None and (ctx_out.dtype != np.int32
                                or ctx_out.size < 202):
        raise ValueError("ctx_out: needs an int32 buffer of >= 202 states")
    lib = get_lib()
    if pps.cu_qp_delta_enabled:
        return None  # per-CTU QP deltas ride the python slice coder
    has_intra_p = (slice_type != 2 and fs.inter_dir is not None
                   and bool((fs.inter_dir == 0).any()))
    part_mode = getattr(fs, "part_mode", None)
    has_parts = (slice_type != 2 and part_mode is not None
                 and bool(np.any(part_mode)))
    # explicit TU splits below the CU (fs.tu_log2 leaves < CU size)
    tu8 = np.asarray(fs.tu_log2)[::2, ::2]
    exp8 = np.minimum(np.asarray(fs.cu_log2), 5)
    if slice_type == 2 and (
            bool(np.asarray(fs.nxn).any())
            or bool(((tu8 >= 2) & (tu8 < exp8)).any())):
        return None  # I-slice NxN PUs / TU splits: python writer
    has_tsplit = (slice_type != 2
                  and bool(((tu8 >= 2) & (tu8 < exp8)).any()))
    if has_tsplit and bool((tu8 == 2).any()):
        return None  # python writer handles (incl. 4x4 leaf chroma)
    if has_intra_p:
        # native intra-in-P covers square whole-CU intra only: no NxN
        # (luma_mode4 uniform per 8-cell), no transform-skip, TU = CU
        im = fs.inter_dir == 0
        im4 = np.repeat(np.repeat(im, 2, 0), 2, 1)
        m4 = np.repeat(np.repeat(np.asarray(fs.luma_mode), 2, 0), 2, 1)
        exp_tu = np.minimum(
            np.repeat(np.repeat(np.asarray(fs.cu_log2), 2, 0), 2, 1), 5)
        if (bool((np.asarray(fs.luma_mode4)[im4] != m4[im4]).any())
                or bool(np.asarray(fs.ts_y)[im4].any())
                or bool(np.asarray(fs.ts_cb)[im].any())
                or bool(np.asarray(fs.ts_cr)[im].any())
                or bool((np.asarray(fs.tu_log2)[im4] != exp_tu[im4]).any())):
            return None

    def ptr(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    keep = []
    ptrs = []
    for arr in (fs.cu_log2, fs.luma_mode, fs.chroma_mode, fs.coeff_y,
                fs.coeff_cb, fs.coeff_cr, fs.skip, fs.merge_flag,
                fs.merge_idx, fs.mvp_flag, fs.mvd, fs.ref_idx):
        a, p = ptr(arr)
        keep.append(a)
        ptrs.append(p)
    cap = fs.width * fs.height * 4 + 1024
    out = np.empty(cap, dtype=np.uint8)
    nullp = ctypes.POINTER(ctypes.c_int32)()
    sao_p, sao_l, sao_c = nullp, 0, 0
    if fs.sao is not None:
        pp = fs.sao
        nctu = pp.ny * pp.nx
        pack = np.zeros((nctu, 18), np.int32)
        pack[:, 0] = pp.type_y.reshape(-1)
        pack[:, 1] = pp.aux_y.reshape(-1)
        pack[:, 2:6] = pp.off_y.reshape(nctu, 4)
        pack[:, 6] = pp.type_c.reshape(-1)
        pack[:, 7] = pp.aux_cb.reshape(-1)
        pack[:, 8:12] = pp.off_cb.reshape(nctu, 4)
        pack[:, 12] = pp.aux_cr.reshape(-1)
        pack[:, 13:17] = pp.off_cr.reshape(nctu, 4)
        pack[:, 17] = pp.merge.reshape(-1)
        a, sao_p = ptr(pack)
        keep.append(a)
        sao_l, sao_c = int(pp.luma_on), int(pp.chroma_on)
    part_p = dir_p = want_p = nullp
    if has_parts:
        a, part_p = ptr(part_mode)
        keep.append(a)
    if has_intra_p:
        a, dir_p = ptr(fs.inter_dir)
        keep.append(a)
    if has_tsplit:
        a, want_p = ptr(tu8)
        keep.append(a)
    n = lib.tpuhevc_encode_slice_data_v5(
        *ptrs, sao_p, sao_l, sao_c, part_p, dir_p,
        1 if sps.amp_enabled else 0, want_p,
        fs.width, fs.height, sps.log2_ctu, sps.log2_min_cu,
        sps.log2_min_tu, sps.log2_max_tu, sps.max_tu_depth_intra,
        sps.max_tu_depth_inter, slice_type, max_merge,
        slice_type_row, qp, 1 if pps.sign_data_hiding else 0,
        num_ref,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        nullp if ctx_out is None else ctx_out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)))
    if n < 0:
        raise RuntimeError(f"native slice coder failed ({n})")
    return out[:n].tobytes()
