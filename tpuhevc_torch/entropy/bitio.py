"""Raw bitstream I/O: bit writer/reader, Exp-Golomb, NAL + Annex-B framing.

Counterpart of the reference's TComBitStream.{h,cpp} (byte FIFO + bit cache),
SyntaxElementWriter/Parser (ue(v)/se(v)/u(n)), NALwrite.cpp / NALread.cpp
(emulation prevention) and AnnexBwrite.h / AnnexBread.cpp (start codes).
Implementation is original; the formats are normative (H.265 §7.3, §B.2).
"""

from __future__ import annotations


# --- NAL unit types (H.265 Table 7-1) -------------------------------------
NAL_TRAIL_N = 0
NAL_TRAIL_R = 1
NAL_TSA_N = 2
NAL_TSA_R = 3
NAL_STSA_N = 4
NAL_STSA_R = 5
NAL_RADL_N = 6
NAL_RADL_R = 7
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_BLA_W_LP = 16
NAL_BLA_W_RADL = 17
NAL_BLA_N_LP = 18
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40


def is_irap(nal_type: int) -> bool:
    return NAL_BLA_W_LP <= nal_type <= 23


def is_idr(nal_type: int) -> bool:
    return nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)


class BitWriter:
    """MSB-first bit accumulator producing an RBSP byte string."""

    __slots__ = ("_bytes", "_cur", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0  # partial byte, left-aligned count in _nbits
        self._nbits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert 0 <= value < (1 << nbits), (value, nbits)
        cur, have = self._cur, self._nbits
        total = have + nbits
        acc = (cur << nbits) | value
        out = self._bytes
        while total >= 8:
            total -= 8
            out.append((acc >> total) & 0xFF)
        self._cur = acc & ((1 << total) - 1)
        self._nbits = total

    def write_flag(self, flag: int) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (H.265 §9.2)."""
        assert value >= 0
        code = value + 1
        nbits = code.bit_length()
        self.write(0, nbits - 1)
        self.write(code, nbits)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb: k -> 2k-1 if k>0 else -2k."""
        self.write_ue((value << 1) - 1 if value > 0 else (-value) << 1)

    def write_bytes(self, data: bytes) -> None:
        assert self._nbits == 0, "byte-align before writing raw bytes"
        self._bytes += data

    @property
    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def align_one(self) -> None:
        """alignment_bit_equal_to_one padding."""
        if self._nbits:
            pad = 8 - self._nbits
            self.write((1 << pad) - 1, pad)

    def align_zero(self) -> None:
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + zero padding (H.265 §7.3.2.11)."""
        self.write(1, 1)
        self.align_zero()

    def getvalue(self) -> bytes:
        assert self._nbits == 0, "unaligned bitstream"
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        pos, data = self._pos, self._data
        end = pos + nbits
        assert end <= len(data) * 8, "bitstream overrun"
        value = 0
        # byte-at-a-time extraction
        first_byte = pos >> 3
        last_byte = (end - 1) >> 3
        chunk = int.from_bytes(data[first_byte : last_byte + 1], "big")
        total_bits = (last_byte - first_byte + 1) * 8
        value = (chunk >> (total_bits - (end - first_byte * 8))) & (
            (1 << nbits) - 1
        )
        self._pos = end
        return value

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros < 64, "bad ue(v)"
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    @property
    def bit_position(self) -> int:
        return self._pos

    def byte_aligned(self) -> bool:
        return (self._pos & 7) == 0

    def align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP data before the trailing stop bit."""
        data, pos = self._data, self._pos
        nbits = len(data) * 8
        if pos >= nbits:
            return False
        # find last set bit in the stream (the rbsp_stop_one_bit)
        last = nbits - 1
        while last >= 0:
            byte = data[last >> 3]
            if byte & (1 << (7 - (last & 7))):
                break
            last -= 1
        return pos < last


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (H.265 §7.4.2; NALwrite.cpp)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    # a NAL may not end in 0x00 runs that could be mistaken; HM appends a
    # cabac_zero_word guard only where required -- trailing 0x00 gets escaped:
    if rbsp.endswith(b"\x00"):
        out.append(3)
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation prevention bytes."""
    return ebsp_to_rbsp_map(ebsp)[0]


def ebsp_to_rbsp_map(ebsp: bytes) -> tuple[bytes, list[int]]:
    """Strip emulation prevention bytes; also return the RBSP positions
    where an escape byte was removed (the escape sits immediately before
    the byte that lands at each returned position). Entry-point offsets
    in slice headers count EBSP bytes (§7.4.7.1 + TDecTop's adjustment
    after emulation removal), so substream splitting needs this map."""
    out = bytearray()
    removed: list[int] = []
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 <= n:
            removed.append(len(out))
            zeros = 0
            i += 1
            if i >= n:
                break
            b = ebsp[i]
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out), removed


def ebsp_entry_sizes_to_rbsp(sizes, data_start: int, removed) -> list:
    """Convert slice-header entry-point sizes (EBSP byte counts) into
    RBSP byte counts, given the RBSP offset where the slice data starts
    and the removed-escape map from ebsp_to_rbsp_map."""
    import bisect

    out = []
    pos = data_start
    for e in sizes:
        r = e
        while True:
            c = (bisect.bisect_right(removed, pos + r)
                 - bisect.bisect_right(removed, pos))
            if r - (e - c) == 0:
                break
            r = e - c
        out.append(r)
        pos += r
    return out


def rbsp_entry_sizes_to_ebsp(subs, lead: bytes = b"\x01") -> list[int]:
    """EBSP byte count of each RBSP substream, accounting for the
    emulation-prevention bytes rbsp_to_ebsp WILL insert (zero-run state
    carries across substream boundaries; `lead` = the bytes immediately
    preceding the first substream)."""
    zeros = 0
    for b in lead[-2:]:
        zeros = zeros + 1 if b == 0 else 0
    out = []
    for s in subs:
        n = len(s)
        for b in s:
            if zeros >= 2 and b <= 3:
                n += 1
                zeros = 0
            zeros = zeros + 1 if b == 0 else 0
        out.append(n)
    return out


def nal_header(nal_type: int, temporal_id: int = 0, layer_id: int = 0) -> bytes:
    """Two-byte nal_unit_header (H.265 §7.3.1.2)."""
    b0 = (nal_type & 0x3F) << 1 | (layer_id >> 5)
    b1 = ((layer_id & 0x1F) << 3) | (temporal_id + 1)
    return bytes((b0, b1))


def make_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0) -> bytes:
    return nal_header(nal_type, temporal_id) + rbsp_to_ebsp(rbsp)


def write_annexb(nals: list[bytes], first_of_au_flags: list[bool] | None = None) -> bytes:
    """Annex-B byte stream: 4-byte start code for parameter sets / first NAL
    of an access unit, 3-byte otherwise (mirrors AnnexBwrite.h behavior)."""
    out = bytearray()
    for i, nal in enumerate(nals):
        nal_type = (nal[0] >> 1) & 0x3F
        long_sc = (
            i == 0
            or nal_type in (NAL_VPS, NAL_SPS, NAL_PPS)
            or (first_of_au_flags is not None and first_of_au_flags[i])
        )
        out += b"\x00\x00\x00\x01" if long_sc else b"\x00\x00\x01"
        out += nal
    return bytes(out)


def read_annexb(data: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL units (EBSP, header included)."""
    nals = []
    i = 0
    n = len(data)
    # find first start code
    starts = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trim the extra 0x00 of a 4-byte start code belonging to next NAL
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nals.append(data[s:e])
    return nals
