"""Planar YUV file I/O + picture hashing + PSNR.

Counterpart of TLibVideoIO/TVideoIOYuv.{h,cpp} (read/write with bit-depth
handling) and TComPicYuvMD5.cpp (decoded-picture-hash), SURVEY.md §2.3.
"""

from __future__ import annotations

import hashlib

import numpy as np


class YuvReader:
    """4:2:0 planar reader. Yields (y, u, v) uint8/uint16 arrays."""

    def __init__(self, path: str, width: int, height: int, bit_depth: int = 8):
        self.path = path
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self._bpp = 1 if bit_depth <= 8 else 2
        self._frame_bytes = width * height * 3 // 2 * self._bpp
        self._f = open(path, "rb")

    def __del__(self):
        try:
            self._f.close()
        except Exception:
            pass

    @property
    def num_frames(self) -> int:
        import os

        return os.path.getsize(self.path) // self._frame_bytes

    def read_frame(self, idx: int | None = None):
        if idx is not None:
            self._f.seek(idx * self._frame_bytes)
        raw = self._f.read(self._frame_bytes)
        if len(raw) < self._frame_bytes:
            return None
        dt = np.uint8 if self._bpp == 1 else np.dtype("<u2")
        w, h = self.width, self.height
        buf = np.frombuffer(raw, dtype=dt)
        y = buf[: w * h].reshape(h, w)
        u = buf[w * h : w * h + w * h // 4].reshape(h // 2, w // 2)
        v = buf[w * h + w * h // 4 :].reshape(h // 2, w // 2)
        return y, u, v


def write_yuv(path: str, frames, bit_depth: int = 8, append: bool = False):
    mode = "ab" if append else "wb"
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    with open(path, mode) as f:
        for y, u, v in frames:
            f.write(np.ascontiguousarray(y, dtype=dt).tobytes())
            f.write(np.ascontiguousarray(u, dtype=dt).tobytes())
            f.write(np.ascontiguousarray(v, dtype=dt).tobytes())


def plane_md5(plane: np.ndarray, bit_depth: int = 8) -> bytes:
    """MD5 of one plane, per-sample little-endian bytes (TComPicYuvMD5
    semantics: 1 byte/sample for 8-bit, 2 for higher)."""
    if bit_depth <= 8:
        data = np.ascontiguousarray(plane, dtype=np.uint8).tobytes()
    else:
        data = np.ascontiguousarray(plane, dtype="<u2").tobytes()
    return hashlib.md5(data).digest()


def picture_md5(y: np.ndarray, u: np.ndarray, v: np.ndarray, bit_depth: int = 8) -> list[bytes]:
    return [plane_md5(p, bit_depth) for p in (y, u, v)]


def plane_checksum(p: np.ndarray, bit_depth: int = 8) -> bytes:
    """Decoded-picture-hash checksum (D.3.19 / TComPicYuvMD5.cpp:141):
    big-endian 4 bytes of sum((pel & 0xff) ^ xor_mask) mod 2^32 (plus the
    high byte for >8-bit)."""
    h, w = p.shape
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)
    mask = ((x[None, :] & 0xFF) ^ (y[:, None] & 0xFF)
            ^ (x[None, :] >> 8) ^ (y[:, None] >> 8)).astype(np.uint32)
    pel = p.astype(np.uint32)
    s = np.uint32(((pel & 0xFF) ^ mask).sum(dtype=np.uint64) & 0xFFFFFFFF)
    if bit_depth > 8:
        s = np.uint32((int(s) + int(((pel >> 8) ^ mask)
                                    .sum(dtype=np.uint64))) & 0xFFFFFFFF)
    return int(s).to_bytes(4, "big")


def picture_checksum(y, u, v, bit_depth: int = 8) -> list[bytes]:
    return [plane_checksum(p, bit_depth) for p in (y, u, v)]


def plane_crc(p: np.ndarray, bit_depth: int = 8) -> bytes:
    """Decoded-picture-hash CRC (D.3.19 / TComPicYuvMD5.cpp:89 compCRC):
    CRC-16 poly 0x1021 init 0xffff over per-sample bytes (low byte first
    sample order; for >8-bit the high byte follows the low byte of each
    sample), with 16 zero bits pushed at the end. binascii.crc_hqx is the
    non-augmented table form of the same polynomial; the augmented result
    equals crc_hqx with the init shifted through those 16 bits:
    0xffff * x^16 mod G = 0x1d0f (verified against a direct transcription
    of the reference loop in tests/test_options.py)."""
    import binascii

    if bit_depth <= 8:
        data = np.ascontiguousarray(p, dtype=np.uint8).tobytes()
    else:
        # compCRC feeds bits 7..0 then 15..8 of each sample
        a = np.ascontiguousarray(p, dtype=np.uint16)
        data = a.astype("<u2").tobytes()
    return int(binascii.crc_hqx(data, 0x1D0F)).to_bytes(2, "big")


def picture_crc(y, u, v, bit_depth: int = 8) -> list[bytes]:
    return [plane_crc(p, bit_depth) for p in (y, u, v)]


def psnr(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    maxv = (1 << bit_depth) - 1
    mse = np.mean((ref.astype(np.float64) - rec.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    return 10.0 * np.log10(maxv * maxv / mse)
