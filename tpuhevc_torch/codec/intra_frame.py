"""Fixed-8x8 intra pictures on the device: the whole picture in one
kernel launch over dependency wavefronts of 8x8 cells.

Counterpart of `tpuhevc/codec/intra_jax.py`: the host geometry (the wave
schedule, gather indices and availability flags, `_compute_waves`,
`_seg_indices`, `_geometry`, `_Geometry`, copied) built once per coded
size and uploaded once per device; the segment substitution and the MPM
candidates (`_substitute`, `_mpm_cands`) as torch helpers of the plain
version; and the three entry points: `build_frame_encoder` (one picture
-> the reference's seven int32 outputs), `encode_frames_intra_batch` (a
list of pictures in one launch and one device-to-host fetch) and
`encode_frame_intra_device` (the per-picture drop-in for
`recon.encode_frame_intra`). The device work is kernel `intra_wave`
(`ops/intra_wave.py`). Decisions, levels and recon equal the host path's
(`recon.encode_frame_intra` without sign hiding) bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve
from ..entropy.syntax import FrameSyntax
from ..ops.intra_wave import WaveTables, intra_wave
from ..utils.tables import qp_to_lambda
from .params import EncoderConfig
from .recon import _pad_to
from .refsamples import BlockOrder


@dataclass(frozen=True)
class _Geometry:
    """Static per-resolution schedule + gather indices (numpy, host)."""

    steps: int
    bmax: int
    mask: np.ndarray          # (S, B) bool
    cell_idx: np.ndarray      # (S, B) flat index into (H8*W8) mode map
    avail: np.ndarray         # (S, B, 5) [lb, l, c, t, tr]
    mpm_left_idx: np.ndarray  # (S, B) flat mode-map index (clamped)
    mpm_left_ok: np.ndarray   # (S, B)
    mpm_above_idx: np.ndarray
    mpm_above_ok: np.ndarray
    y_seg: np.ndarray         # (S, B, 33) luma ref sample flat idx
    y_blk: np.ndarray         # (S, B, 64) luma block flat idx
    c_seg: np.ndarray         # (S, B, 17) chroma ref flat idx (half-res plane)
    c_blk: np.ndarray         # (S, B, 16)


def _compute_waves(w8: int, h8: int, order: BlockOrder) -> list[list[tuple[int, int]]]:
    wave = np.zeros((h8, w8), dtype=np.int64)
    cells = sorted(
        ((x, y) for y in range(h8) for x in range(w8)),
        key=lambda c: order.order[c[1], c[0]],
    )
    for x, y in cells:
        m = 0
        for dx, dy in ((-1, 0), (0, -1), (1, -1), (-1, 1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < w8 and 0 <= ny < h8 and order.order[ny, nx] < order.order[y, x]:
                m = max(m, wave[ny, nx] + 1)
        wave[y, x] = m
    out = [[] for _ in range(int(wave.max()) + 1)]
    for x, y in cells:  # decode order within a wave (host-path parity)
        out[wave[y, x]].append((x, y))
    return out


def _seg_indices(x0, y0, s, w, h):
    """Flat indices for [lb(s), l(s), corner(1), t(s), tr(s)], clamped."""

    def clamp_flat(x, y):
        return min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1)

    idx = []
    # left segments are emitted BOTTOM-first: the substitution scan runs
    # from p[-1][2S-1] upward (§8.4.4.2.2)
    for i in range(s):
        idx.append(clamp_flat(x0 - 1, y0 + 2 * s - 1 - i))
    for i in range(s):
        idx.append(clamp_flat(x0 - 1, y0 + s - 1 - i))
    idx.append(clamp_flat(x0 - 1, y0 - 1))
    for i in range(s):
        idx.append(clamp_flat(x0 + i, y0 - 1))
    for i in range(s):
        idx.append(clamp_flat(x0 + s + i, y0 - 1))
    return idx


@lru_cache(maxsize=8)
def _geometry(w: int, h: int, log2_ctu: int) -> _Geometry:
    order = BlockOrder(w, h, log2_ctu)
    w8, h8 = w // 8, h // 8
    waves = _compute_waves(w8, h8, order)
    steps = len(waves)
    bmax = max(len(wv) for wv in waves)
    cw = w // 2
    ctu = 1 << log2_ctu

    mask = np.zeros((steps, bmax), dtype=bool)
    cell_idx = np.zeros((steps, bmax), dtype=np.int32)
    avail = np.zeros((steps, bmax, 5), dtype=bool)
    ml_i = np.zeros((steps, bmax), dtype=np.int32)
    ml_ok = np.zeros((steps, bmax), dtype=bool)
    ma_i = np.zeros((steps, bmax), dtype=np.int32)
    ma_ok = np.zeros((steps, bmax), dtype=bool)
    y_seg = np.zeros((steps, bmax, 33), dtype=np.int32)
    y_blk = np.zeros((steps, bmax, 64), dtype=np.int32)
    c_seg = np.zeros((steps, bmax, 17), dtype=np.int32)
    c_blk = np.zeros((steps, bmax, 16), dtype=np.int32)

    for s_i, wv in enumerate(waves):
        for b, (x8, y8) in enumerate(wv):
            mask[s_i, b] = True
            cell_idx[s_i, b] = y8 * w8 + x8
            avail[s_i, b] = [
                order.precedes(x8 - 1, y8 + 1, x8, y8),
                order.precedes(x8 - 1, y8, x8, y8),
                order.precedes(x8 - 1, y8 - 1, x8, y8),
                order.precedes(x8, y8 - 1, x8, y8),
                order.precedes(x8 + 1, y8 - 1, x8, y8),
            ]
            ml_ok[s_i, b] = x8 > 0
            ml_i[s_i, b] = y8 * w8 + max(x8 - 1, 0)
            above_ok = y8 > 0 and ((y8 * 8) % ctu) != 0
            ma_ok[s_i, b] = above_ok
            ma_i[s_i, b] = max(y8 - 1, 0) * w8 + x8
            x0, y0 = x8 * 8, y8 * 8
            y_seg[s_i, b] = _seg_indices(x0, y0, 8, w, h)
            y_blk[s_i, b] = [
                (y0 + yy) * w + x0 + xx for yy in range(8) for xx in range(8)
            ]
            cx0, cy0 = x8 * 4, y8 * 4
            c_seg[s_i, b] = _seg_indices(cx0, cy0, 4, cw, h // 2)
            c_blk[s_i, b] = [
                (cy0 + yy) * cw + cx0 + xx for yy in range(4) for xx in range(4)
            ]
    return _Geometry(steps, bmax, mask, cell_idx, avail, ml_i, ml_ok, ma_i,
                     ma_ok, y_seg, y_blk, c_seg, c_blk)


def _substitute(segs, avail, s, fill):
    """Vectorized §8.4.4.2.2 substitution at segment granularity.
    segs: (B, 4s+1) raw samples in order [lb, l, c, t, tr]; avail: (B,5)."""
    bounds = [0, s, 2 * s, 2 * s + 1, 3 * s + 1, 4 * s + 1]
    parts = [segs[:, bounds[i] : bounds[i + 1]] for i in range(5)]
    a = [avail[:, i : i + 1] for i in range(5)]
    # first available segment's first sample (default mid-gray)
    fa = torch.full_like(parts[0][:, :1], fill)
    for i in (4, 3, 2, 1, 0):
        fa = torch.where(a[i], parts[i][:, :1], fa)
    out = []
    last = fa
    for i in range(5):
        seg = torch.where(a[i], parts[i], last)
        out.append(seg)
        last = seg[:, -1:]
    return out  # list of (B, len) post-substitution segments


def _mpm_cands(a, b):
    """Vectorized intra_mpm_list: (B,) x2 -> (B,3)."""
    eq = a == b
    lt2 = a < 2
    c0_eq = torch.where(lt2, 0, a)
    c1_eq = torch.where(lt2, 1, 2 + ((a + 29) % 32))
    c2_eq = torch.where(lt2, 26, 2 + ((a - 2 + 1) % 32))
    c2_ne = torch.where(
        (a != 0) & (b != 0), 0, torch.where((a != 1) & (b != 1), 1, 26)
    )
    c0 = torch.where(eq, c0_eq, a)
    c1 = torch.where(eq, c1_eq, b)
    c2 = torch.where(eq, c2_eq, c2_ne)
    return torch.stack([c0, c1, c2], dim=-1)


_TABLES: dict = {}


def wave_tables(w: int, h: int, log2_ctu: int, device) -> WaveTables:
    """The schedule of a w x h coded picture, uploaded once per device."""
    dev = resolve(device)
    key = (w, h, log2_ctu, str(dev))
    t = _TABLES.get(key)
    if t is None:
        g = _geometry(w, h, log2_ctu)
        flags = (g.avail.astype(np.int32)
                 << np.arange(5, dtype=np.int32)).sum(-1)
        flags = flags | (g.mpm_left_ok << 5) | (g.mpm_above_ok << 6)
        w8 = w // 8
        if w8 > 0xfff or h // 8 > 0xfff:
            raise ValueError(f"wave_tables: {w}x{h} is too large")
        slots = np.where(g.mask, (g.cell_idx % w8)
                         | (g.cell_idx // w8) << 12 | flags << 24, -1)

        def up(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=dev)

        t = WaveTables(
            counts=tuple(int(c) for c in g.mask.sum(1)),
            cells=up(np.where(g.mask, g.cell_idx, -1), torch.int32),
            flags=up(np.where(g.mask, flags, 0), torch.int32),
            slots=up(slots, torch.int32),
            avail=up(g.avail, torch.bool), ml_i=up(g.mpm_left_idx),
            ma_i=up(g.mpm_above_idx), y_seg=up(g.y_seg), y_blk=up(g.y_blk),
            c_seg=up(g.c_seg), c_blk=up(g.c_blk))
        _TABLES[key] = t
    return t


def _sqlam_fp(cfg: EncoderConfig) -> int:
    """sqrt(lambda) in 8.8 fixed point, the mode cost's rate weight."""
    return int(round(np.sqrt(qp_to_lambda(cfg.qp, cfg.lambda_qp_factor))
                     * 256))


def _run(oys, ous, ovs, cfg: EncoderConfig, dev):
    """(F, H, W), (F, H/2, W/2) x2 tensors -> the seven (F, ...) outputs."""
    sps = cfg.sps
    geo = wave_tables(sps.coded_width, sps.coded_height, sps.log2_ctu, dev)
    return intra_wave(oys, ous, ovs, geo, cfg.qp, _sqlam_fp(cfg),
                      sps.strong_intra_smoothing, bit_depth=sps.bit_depth)


def build_frame_encoder(cfg: EncoderConfig, device):
    """Returns fn: (orig_y, orig_u, orig_v) at the coded size (the caller
    pads) -> (rec_y, rec_u, rec_v, modes, coeff_y, coeff_cb, coeff_cr),
    int32 tensors on `device` in the reference's shapes."""
    dev = resolve(device)

    def encode(oy, ou, ov):
        planes = [torch.as_tensor(np.asarray(p), device=dev).to(torch.int32)
                  [None].contiguous() for p in (oy, ou, ov)]
        return tuple(o[0] for o in _run(*planes, cfg, dev))

    return encode


def _frame_syntax(w, h, modes, cy, cb, cr) -> FrameSyntax:
    fs = FrameSyntax(w, h)
    fs.luma_mode[:] = modes
    fs.chroma_mode[:] = 4
    fs.coeff_y[:] = cy
    fs.coeff_cb[:] = cb
    fs.coeff_cr[:] = cr
    return fs


def encode_frames_intra_batch(frames, cfg: EncoderConfig, device):
    """Encode a list of pictures in one kernel launch and one
    device-to-host fetch of the seven outputs packed into one int32
    buffer, as the reference packs its vmapped scan. A short last batch is
    coded as it is: only the valid pictures, none repeated (the stream is
    the same either way). Returns [(FrameSyntax, (ry, ru, rv))]."""
    dev = resolve(device)
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    host = [np.stack([_pad_to(np.asarray(f[i]), h >> s, w >> s)
                      for f in frames])
            for i, s in ((0, 0), (1, 1), (2, 1))]
    planes = [torch.from_numpy(p).to(dev) for p in host]
    n = len(frames)
    outs = _run(*planes, cfg, dev)
    packed = torch.cat([o.reshape(n, -1) for o in outs], dim=1)
    if dev.type == "cuda":  # into pinned memory: the faster copy
        host_buf = torch.empty(packed.shape, dtype=torch.int32,
                               pin_memory=True)
        host_buf.copy_(packed)
        buf = host_buf.numpy()
    else:
        buf = packed.numpy()
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2), (h // 8, w // 8),
              (h, w), (h // 2, w // 2), (h // 2, w // 2)]
    results = []
    for i in range(n):
        parts, off = [], 0
        for shp in shapes:
            sz = shp[0] * shp[1]
            parts.append(buf[i, off : off + sz].reshape(shp))
            off += sz
        ry, ru, rv, modes, cy, cb, cr = parts
        results.append((_frame_syntax(w, h, modes, cy, cb, cr), (ry, ru, rv)))
    return results


def encode_frame_intra_device(orig_y, orig_u, orig_v, cfg: EncoderConfig,
                              device="cuda"):
    """Drop-in for `recon.encode_frame_intra` (sign hiding off): one
    picture through the kernel -> (FrameSyntax, (rec_y, rec_u, rec_v))."""
    return encode_frames_intra_batch([(orig_y, orig_u, orig_v)], cfg,
                                     device)[0]
