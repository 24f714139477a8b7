"""CABAC binary arithmetic coder: encoder, decoder, and context state.

Implements the normative H.265 §9.3 arithmetic coding process (the same
process the reference implements in TEncBinCoderCABAC.cpp / TDecBinCABAC.cpp
and ContextModel.cpp — it is fully specified by the standard, so any
conforming engine computes identical bits). Host-side by design: bit-serial
with per-bin context dependence; the TPU side only ever needs the *fractional
bit estimator* (ENTROPY_BITS lookups), which is vectorized separately.

Contexts are stored in the combined encoding s = (pStateIdx << 1) | valMps,
as a flat list per context set for cheap snapshot/restore (the encoder's RD
search saves/loads full context states like the reference's RDSbac array,
TEncTop.h:78-152).
"""

from __future__ import annotations

from .ctx_tables import (
    ENTROPY_BITS,
    INIT_VALUES,
    LPS_TABLE,
    NEXT_STATE_LPS,
    NEXT_STATE_MPS,
    RENORM_TABLE,
    init_state,
)

# plain-python copies (faster than numpy scalar indexing in tight loops)
_LPS = [tuple(int(x) for x in row) for row in LPS_TABLE]
_RENORM = tuple(int(x) for x in RENORM_TABLE)
_NEXT_MPS = tuple(int(x) for x in NEXT_STATE_MPS)
_NEXT_LPS = tuple(int(x) for x in NEXT_STATE_LPS)
_EBITS = tuple(int(x) for x in ENTROPY_BITS)

# ordered context layout: (name, count) in a fixed order so the whole context
# bank is one flat list (snapshot = list copy)
CTX_LAYOUT: list[tuple[str, int]] = [
    (name, len(rows[0])) for name, rows in INIT_VALUES.items()
]
CTX_OFFSET: dict[str, int] = {}
_off = 0
for _name, _cnt in CTX_LAYOUT:
    CTX_OFFSET[_name] = _off
    _off += _cnt
NUM_CTX = _off


class ContextSet:
    """Flat bank of CABAC context states addressed by (name, idx)."""

    __slots__ = ("states",)

    def __init__(self, slice_type_idx: int | None = None, qp: int | None = None):
        self.states: list[int] = [0] * NUM_CTX
        if slice_type_idx is not None:
            self.reset(slice_type_idx, qp)

    def reset(self, slice_type_idx: int, qp: int) -> None:
        """slice_type_idx: 0=B, 1=P, 2=I (reference init-table layout)."""
        s = self.states
        for name, cnt in CTX_LAYOUT:
            vals = INIT_VALUES[name][slice_type_idx]
            base = CTX_OFFSET[name]
            for i in range(cnt):
                s[base + i] = init_state(qp, vals[i])

    def snapshot(self) -> list[int]:
        return self.states.copy()

    def restore(self, snap: list[int]) -> None:
        self.states = snap.copy()

    def idx(self, name: str, i: int = 0) -> int:
        return CTX_OFFSET[name] + i

    def estimate_bits(self, name: str, i: int, binval: int) -> int:
        """Fractional bits (32768 = 1 bit) to code binval in this context,
        WITHOUT updating state. For RD estimation parity use CabacBitEstimator
        which also tracks state evolution."""
        return _EBITS[self.states[CTX_OFFSET[name] + i] ^ binval]


class CabacEncoder:
    """Binary arithmetic encoder (H.265 §9.3.4.3 encoding process)."""

    __slots__ = (
        "low", "range", "bits_left", "buffered_byte", "num_buffered", "out",
        "ctx", "_pending",
    )

    def __init__(self, ctx: ContextSet):
        self.ctx = ctx
        self.out = bytearray()
        self.start()

    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.buffered_byte = 0xFF
        self.num_buffered = 0

    # -- core bin coding ----------------------------------------------------
    def encode_bin(self, binval: int, ctx_idx: int) -> None:
        states = self.ctx.states
        s = states[ctx_idx]
        rng = self.range
        lps = _LPS[s >> 1][(rng >> 6) & 3]
        rng -= lps
        if binval != (s & 1):
            nbits = _RENORM[lps >> 3]
            self.low = ((self.low + rng) << nbits) & 0xFFFFFFFF
            self.range = lps << nbits
            states[ctx_idx] = _NEXT_LPS[s]
            self.bits_left -= nbits
        else:
            states[ctx_idx] = _NEXT_MPS[s]
            if rng >= 256:
                self.range = rng
                return
            self.low = (self.low << 1) & 0xFFFFFFFF
            self.range = rng << 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bin_ep(self, binval: int) -> None:
        self.low = (self.low << 1) & 0xFFFFFFFF
        if binval:
            self.low = (self.low + self.range) & 0xFFFFFFFF
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, value: int, nbins: int) -> None:
        rng = self.range
        while nbins > 8:
            nbins -= 8
            pattern = value >> nbins
            self.low = ((self.low << 8) + rng * pattern) & 0xFFFFFFFF
            value -= pattern << nbins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = ((self.low << nbins) + rng * value) & 0xFFFFFFFF
        self.bits_left -= nbins
        if self.bits_left < 12:
            self._write_out()

    def encode_bin_trm(self, binval: int) -> None:
        """Terminating bin (end_of_slice_segment_flag, pcm_flag)."""
        rng = self.range - 2
        if binval:
            self.low = ((self.low + rng) << 7) & 0xFFFFFFFF
            self.range = 2 << 7
            self.bits_left -= 7
        elif rng >= 256:
            self.range = rng
            return
        else:
            self.low = (self.low << 1) & 0xFFFFFFFF
            self.range = rng << 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def write_pcm(self, samples, nbits: int) -> None:
        """I_PCM sample write (TEncBinCABAC::encodePCMAlignBits +
        xWritePCMCode + resetBac, TEncSbac.cpp:1034-1068): caller has
        already coded pcm_flag via encode_bin_trm(1). Flushes the
        arithmetic codeword, writes a '1' bit + zero alignment, emits the
        raw fixed-length samples byte-aligned, then restarts the engine."""
        import numpy as np

        self.finish()
        val, n = self._pending
        acc = (val << 1) | 1          # flush bits + the '1' marker bit
        nb = n + 1
        pad = (-nb) % 8               # pcm alignment zero bits
        acc <<= pad
        nb += pad
        for shift in range(nb - 8, -1, -8):
            self.out.append((acc >> shift) & 0xFF)
        arr = np.asarray(samples, dtype=np.int64).ravel()
        total = arr.size * nbits
        assert total % 8 == 0, "PCM payload must be byte-aligned"
        shifts = np.arange(nbits - 1, -1, -1)
        bits = ((arr[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        self.out.extend(np.packbits(bits.ravel()).tobytes())
        self.start()

    def finish(self) -> None:
        """Flush the arithmetic coder (called after the final terminating
        bin; caller then writes the rbsp stop bit + alignment)."""
        out = self.out
        if (self.low >> (32 - self.bits_left)) & 0xFFFFFFFF:
            out.append((self.buffered_byte + 1) & 0xFF)
            while self.num_buffered > 1:
                out.append(0x00)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered > 0:
                out.append(self.buffered_byte)
            while self.num_buffered > 1:
                out.append(0xFF)
                self.num_buffered -= 1
        # remaining 24 - bits_left bits of low, MSB-aligned from bit 8
        nbits = 24 - self.bits_left
        val = (self.low >> 8) & ((1 << nbits) - 1) if nbits else 0
        self._pending = (val, nbits)  # handed to the bit writer by caller

    @property
    def pending_bits(self) -> tuple[int, int]:
        return self._pending

    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead == 0xFF:
            self.num_buffered += 1
        else:
            if self.num_buffered > 0:
                carry = lead >> 8
                self.out.append((self.buffered_byte + carry) & 0xFF)
                self.buffered_byte = lead & 0xFF
                fill = (0xFF + carry) & 0xFF
                while self.num_buffered > 1:
                    self.out.append(fill)
                    self.num_buffered -= 1
            else:
                self.num_buffered = 1
                self.buffered_byte = lead & 0xFF


class CabacDecoder:
    """Binary arithmetic decoder (H.265 §9.3.3 decoding process)."""

    __slots__ = ("data", "pos", "range", "value", "bits_needed", "ctx")

    def __init__(self, data: bytes, ctx: ContextSet):
        self.ctx = ctx
        self.data = data
        self.pos = 0
        self.start()

    def _byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.pos += 1
        return 0

    def start(self) -> None:
        self.range = 510
        self.bits_needed = -8
        self.value = (self._byte() << 8) | self._byte()

    def decode_bin(self, ctx_idx: int) -> int:
        states = self.ctx.states
        s = states[ctx_idx]
        rng = self.range
        lps = _LPS[s >> 1][(rng >> 6) & 3]
        rng -= lps
        scaled = rng << 7
        if self.value < scaled:
            binval = s & 1
            states[ctx_idx] = _NEXT_MPS[s]
            if scaled >= (256 << 7):
                self.range = rng
                return binval
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._byte()
        else:
            nbits = _RENORM[lps >> 3]
            self.value = (self.value - scaled) << nbits
            self.range = lps << nbits
            binval = 1 - (s & 1)
            states[ctx_idx] = _NEXT_LPS[s]
            self.bits_needed += nbits
            if self.bits_needed >= 0:
                self.value += self._byte() << self.bits_needed
                self.bits_needed -= 8
        return binval

    def decode_bin_ep(self) -> int:
        self.value += self.value
        self.bits_needed += 1
        if self.bits_needed >= 0:
            self.bits_needed = -8
            self.value += self._byte()
        scaled = self.range << 7
        if self.value >= scaled:
            self.value -= scaled
            return 1
        return 0

    def decode_bins_ep(self, nbins: int) -> int:
        bits = 0
        while nbins > 8:
            self.value = ((self.value << 8) + (self._byte() << (8 + self.bits_needed))) & 0xFFFFFFFF
            scaled = self.range << 15
            for _ in range(8):
                bits += bits
                scaled >>= 1
                if self.value >= scaled:
                    bits += 1
                    self.value -= scaled
            nbins -= 8
        self.bits_needed += nbins
        self.value <<= nbins
        if self.bits_needed >= 0:
            self.value += self._byte() << self.bits_needed
            self.bits_needed -= 8
        scaled = self.range << (nbins + 7)
        for _ in range(nbins):
            bits += bits
            scaled >>= 1
            if self.value >= scaled:
                bits += 1
                self.value -= scaled
        return bits

    def decode_bin_trm(self) -> int:
        rng = self.range - 2
        scaled = rng << 7
        if self.value >= scaled:
            return 1
        self.range = rng
        if scaled < (256 << 7):
            self.range = scaled >> 6
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.bits_needed = -8
                self.value += self._byte()
        return 0

    def read_pcm_samples(self, count: int, nbits: int):
        """I_PCM raw-sample read (TDecSbac::parseIPCMInfo semantics,
        TDecSbac.cpp:364-404): the reference reads samples directly from
        the bitstream's current byte position, discarding the engine's
        prefetched bits — the encoder's flush + alignment guarantees the
        position is the sample start. Caller must call start() after."""
        import numpy as np

        total = count * nbits
        assert total % 8 == 0, "PCM payload must be byte-aligned"
        nbytes = total // 8
        chunk = self.data[self.pos : self.pos + nbytes]
        if len(chunk) < nbytes:
            chunk = chunk + b"\x00" * (nbytes - len(chunk))
        self.pos += nbytes
        bits = np.unpackbits(np.frombuffer(chunk, np.uint8))
        w = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
        return bits.reshape(count, nbits).astype(np.int64) @ w

    def consumed_bytes(self) -> int:
        return self.pos


class CabacBitEstimator:
    """Counting-only coder with the same interface as CabacEncoder: tracks
    context evolution and accumulates fractional bits (32768 = 1 bit).
    Counterpart of the reference's TEncBinCABACCounter for RD decisions."""

    __slots__ = ("frac_bits", "ctx")

    def __init__(self, ctx: ContextSet):
        self.ctx = ctx
        self.frac_bits = 0

    def encode_bin(self, binval: int, ctx_idx: int) -> None:
        states = self.ctx.states
        s = states[ctx_idx]
        self.frac_bits += _EBITS[s ^ binval]
        states[ctx_idx] = _NEXT_MPS[s] if binval == (s & 1) else _NEXT_LPS[s]

    def encode_bin_ep(self, binval: int) -> None:
        self.frac_bits += 32768

    def encode_bins_ep(self, value: int, nbins: int) -> None:
        self.frac_bits += 32768 * nbins

    def encode_bin_trm(self, binval: int) -> None:
        self.frac_bits += _EBITS[126 ^ binval]

    @property
    def bits(self) -> float:
        return self.frac_bits / 32768.0
