"""SEI message model beyond the decoded-picture hash.

Counterpart of the reference's SEI framework (SEI.h payload classes,
SEIwrite.cpp / SEIread.cpp — SURVEY.md §2.1 "SEI model"): a generic
prefix/suffix SEI NAL writer/parser plus the messages the encoder emits:

- active_parameter_sets (129, D.3.21): VPS/SPS activation, first AU
- recovery_point (6, D.3.8): random-access recovery markers on IRAPs
- pic_timing (1, D.3.3): pic_struct per access unit (frame_field_info;
  the HRD delay branch is off — no HRD is signaled)
- user_data_unregistered (5, D.3.6): encoder tag (SEIwrite's analog of
  the HM version string SEI)

The decoded-picture-hash SEI (132) stays in entropy.headers — it is the
conformance oracle and predates this module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitio import BitReader, BitWriter

SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_USER_DATA_UNREGISTERED = 5
SEI_RECOVERY_POINT = 6
SEI_ACTIVE_PARAMETER_SETS = 129
SEI_DECODED_PICTURE_HASH = 132

# 16-byte ISO/IEC 11578 UUID tagging this encoder's user-data SEI
TPUHEVC_UUID = bytes.fromhex("7d9f2a4cb6e1408ba3c5d07e8f612354")


@dataclass
class ActiveParameterSets:
    active_vps_id: int = 0
    self_contained_cvs: bool = False
    no_parameter_set_update: bool = False
    sps_ids: list = field(default_factory=lambda: [0])

    def write(self, w: BitWriter) -> None:
        w.write(self.active_vps_id, 4)
        w.write_flag(self.self_contained_cvs)
        w.write_flag(self.no_parameter_set_update)
        w.write_ue(len(self.sps_ids) - 1)
        for i in self.sps_ids:
            w.write_ue(i)

    @classmethod
    def parse(cls, r: BitReader) -> "ActiveParameterSets":
        m = cls()
        m.active_vps_id = r.read(4)
        m.self_contained_cvs = bool(r.read_flag())
        m.no_parameter_set_update = bool(r.read_flag())
        n = r.read_ue() + 1
        m.sps_ids = [r.read_ue() for _ in range(n)]
        return m


@dataclass
class RecoveryPoint:
    recovery_poc_cnt: int = 0
    exact_match: bool = True
    broken_link: bool = False

    def write(self, w: BitWriter) -> None:
        w.write_se(self.recovery_poc_cnt)
        w.write_flag(self.exact_match)
        w.write_flag(self.broken_link)

    @classmethod
    def parse(cls, r: BitReader) -> "RecoveryPoint":
        m = cls()
        m.recovery_poc_cnt = r.read_se()
        m.exact_match = bool(r.read_flag())
        m.broken_link = bool(r.read_flag())
        return m


@dataclass
class BufferingPeriod:
    """D.2.2 buffering_period, the subset matching our SPS HRD config:
    one NAL CPB, no sub-pic params, 24-bit delay fields (SEIwrite.cpp
    xWriteSEIBufferingPeriod counterpart). Sent on every IRAP AU."""

    sps_id: int = 0
    irap_cpb_params: bool = False
    concatenation: bool = False
    au_cpb_removal_delay_delta_minus1: int = 0
    initial_cpb_removal_delay: int = 90000  # 90 kHz units
    initial_cpb_removal_offset: int = 0

    def write(self, w: BitWriter) -> None:
        w.write_ue(self.sps_id)
        w.write_flag(self.irap_cpb_params)  # (sub_pic off -> coded)
        w.write_flag(self.concatenation)
        w.write(self.au_cpb_removal_delay_delta_minus1, 24)
        w.write(self.initial_cpb_removal_delay, 24)
        w.write(self.initial_cpb_removal_offset, 24)

    @classmethod
    def parse(cls, r: BitReader) -> "BufferingPeriod":
        m = cls()
        m.sps_id = r.read_ue()
        m.irap_cpb_params = bool(r.read_flag())
        m.concatenation = bool(r.read_flag())
        m.au_cpb_removal_delay_delta_minus1 = r.read(24)
        m.initial_cpb_removal_delay = r.read(24)
        m.initial_cpb_removal_offset = r.read(24)
        return m


@dataclass
class PicTiming:
    """pic_struct branch (frame_field_info_present_flag in the VUI);
    with_hrd adds the D.2.3 CPB/DPB delay fields our 24-bit-length SPS
    HRD announces."""

    pic_struct: int = 0       # 0 = progressive frame
    source_scan_type: int = 1  # 1 = progressive
    duplicate_flag: bool = False
    with_hrd: bool = False
    au_cpb_removal_delay_minus1: int = 0
    pic_dpb_output_delay: int = 0

    def write(self, w: BitWriter) -> None:
        w.write(self.pic_struct, 4)
        w.write(self.source_scan_type, 2)
        w.write_flag(self.duplicate_flag)
        if self.with_hrd:
            w.write(self.au_cpb_removal_delay_minus1, 24)
            w.write(self.pic_dpb_output_delay, 24)

    @classmethod
    def parse(cls, r: BitReader, with_hrd: bool = False) -> "PicTiming":
        m = cls()
        m.pic_struct = r.read(4)
        m.source_scan_type = r.read(2)
        m.duplicate_flag = bool(r.read_flag())
        if with_hrd:
            m.with_hrd = True
            m.au_cpb_removal_delay_minus1 = r.read(24)
            m.pic_dpb_output_delay = r.read(24)
        return m


@dataclass
class UserDataUnregistered:
    uuid: bytes = TPUHEVC_UUID
    data: bytes = b""

    def write(self, w: BitWriter) -> None:
        for b in self.uuid:
            w.write(b, 8)
        for b in self.data:
            w.write(b, 8)

    @classmethod
    def parse(cls, r: BitReader, size: int) -> "UserDataUnregistered":
        m = cls()
        m.uuid = bytes(r.read(8) for _ in range(16))
        m.data = bytes(r.read(8) for _ in range(size - 16))
        return m


_WRITERS = {
    SEI_ACTIVE_PARAMETER_SETS: ActiveParameterSets,
    SEI_BUFFERING_PERIOD: BufferingPeriod,
    SEI_RECOVERY_POINT: RecoveryPoint,
    SEI_PIC_TIMING: PicTiming,
    SEI_USER_DATA_UNREGISTERED: UserDataUnregistered,
}


def write_sei_nal(messages: list) -> bytes:
    """Messages (dataclasses above) -> one SEI RBSP (D.2.1 framing:
    ff-escaped payload type/size, byte-aligned payloads)."""
    w = BitWriter()
    for m in messages:
        ptype = next(t for t, c in _WRITERS.items() if isinstance(m, c))
        pw = BitWriter()
        m.write(pw)
        if pw.bit_position % 8:  # payload bit_equal_to_one alignment
            pw.write_flag(1)
            pw.align_zero()
        payload = pw.getvalue()
        t = ptype
        while t >= 255:
            w.write(255, 8)
            t -= 255
        w.write(t, 8)
        size = len(payload)
        while size >= 255:
            w.write(255, 8)
            size -= 255
        w.write(size, 8)
        w.write_bytes(payload)
    w.rbsp_trailing_bits()
    return w.getvalue()


def parse_sei_nal(data: bytes) -> list[tuple[int, object]]:
    """SEI RBSP -> [(payload_type, parsed message or raw bytes)]."""
    out = []
    pos = 0
    while pos < len(data) - 1:  # trailing rbsp byte stops the loop
        ptype = 0
        while data[pos] == 255:
            ptype += 255
            pos += 1
        ptype += data[pos]
        pos += 1
        size = 0
        while data[pos] == 255:
            size += 255
            pos += 1
        size += data[pos]
        pos += 1
        payload = data[pos : pos + size]
        pos += size
        r = BitReader(payload)
        if ptype == SEI_ACTIVE_PARAMETER_SETS:
            out.append((ptype, ActiveParameterSets.parse(r)))
        elif ptype == SEI_BUFFERING_PERIOD and size >= 10:
            out.append((ptype, BufferingPeriod.parse(r)))
        elif ptype == SEI_RECOVERY_POINT:
            out.append((ptype, RecoveryPoint.parse(r)))
        elif ptype == SEI_PIC_TIMING:
            # our no-HRD pic timing is 1 byte; with the 24-bit delay
            # pair it is 7 — size-infer which branch was written
            out.append((ptype, PicTiming.parse(r, with_hrd=size >= 7)))
        elif ptype == SEI_USER_DATA_UNREGISTERED:
            out.append((ptype, UserDataUnregistered.parse(r, size)))
        else:
            out.append((ptype, payload))
        if pos < len(data) and data[pos] == 0x80 and pos == len(data) - 1:
            break
    return out
