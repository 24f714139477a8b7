"""Segment-parallel encoding: IDR-led segments, each on its own device.

Counterpart of `tpuhevc/parallel/segments.py`. Closed segments that each
start with an IDR share no prediction, so their device work can run on
different devices; the host stitches the Annex-B stream in order, keeping
the parameter sets of the first segment only (a later segment's VPS, SPS
and PPS repeat the first's).

`encode_segments_parallel` encodes the segments one after the other
through `encode_sequence`, segment k on `devices[k % n]`;
`encode_segments_overlapped` gives each segment its own `LdpScanDriver`
on its device and dispatches one chunk of every segment before it
collects any, so each device has a chunk in flight while the host
serialises (LD-P only). Each segment's work runs with its device
current. On one card both run the segments in turn.
"""

from __future__ import annotations

import copy

from ..codec import inter_grid
from ..codec.encoder import (Encoder, LdpScanDriver, check_slice,
                             encode_sequence)
from ..device import on_device, resolve
from ..entropy import bitio

N_PARAM_SETS = 3  # VPS, SPS, PPS lead every segment's NAL units


def split_segments(n_frames: int, n_segments: int) -> list[tuple[int, int]]:
    """[(start, length)] per segment; each starts with an IDR."""
    base = (n_frames + n_segments - 1) // n_segments
    out = []
    s = 0
    while s < n_frames:
        ln = min(base, n_frames - s)
        out.append((s, ln))
        s += ln
    return out


class ListReader:
    """`encode_sequence`'s reader over a list of (y, u, v) frames."""

    def __init__(self, frames):
        self.frames = frames

    def read_frame(self, i):
        return self.frames[i] if i < len(self.frames) else None


def stitch(encoders) -> bytes:
    """The segments' NAL units in order, the repeated parameter sets
    dropped -> one Annex-B stream."""
    nals, first = [], []
    for k, enc in enumerate(encoders):
        skip = N_PARAM_SETS if k else 0
        nals += enc.nals[skip:]
        first += enc.first_of_au[skip:]
    return bitio.write_annexb(nals, first)


def encode_segments_parallel(frames, cfg, n_segments: int, devices):
    """Encode `frames` ((y, u, v) uint8 each) as `n_segments` IDR-led
    segments through `encode_sequence`, segment k on devices[k %
    len(devices)]. Returns (stream bytes, the FrameResults in the order
    coded)."""
    devices = [resolve(d) for d in devices]
    encs = []
    for k, (s, ln) in enumerate(split_segments(len(frames), n_segments)):
        dev = devices[k % len(devices)]
        with on_device(dev):
            enc, _ = encode_sequence(ListReader(frames[s : s + ln]),
                                     copy.deepcopy(cfg), max_frames=ln,
                                     device=dev)
        encs.append(enc)
    return stitch(encs), [r for e in encs for r in e.results]


def encode_segments_overlapped(frames, cfg, n_segments: int, devices):
    """LD-P segment-parallel encode with device overlap: one
    `LdpScanDriver` a segment on its device; each round dispatches one
    chunk of every segment before it collects the round before, so on n
    devices n chunks compute while the host serialises. Each segment's
    stream equals its `encode_sequence` stream. Returns (stream bytes, the
    FrameResults in the order coded)."""
    devices = [resolve(d) for d in devices]
    drivers = []
    for k, (s, ln) in enumerate(split_segments(len(frames), n_segments)):
        cfg_k = copy.deepcopy(cfg)
        check_slice(cfg_k)
        if cfg_k.intra_period != -1 or cfg_k.gop_structure == "ra":
            raise ValueError("encode_segments_overlapped: LD-P only")
        dev = devices[k % len(devices)]
        with on_device(dev):
            enc = Encoder(cfg_k, device=dev)
            # TMVP rides the grid, granted in the SPS there (encode_sequence)
            if cfg_k.tmvp and inter_grid.supports(cfg_k):
                cfg_k.sps.temporal_mvp_enabled = True

            def finish(i, fr, pre=None, slice_info=None, _enc=enc):
                _enc.encode_frame(*fr, poc=i, precomputed=pre,
                                  slice_info=slice_info)

            drv = LdpScanDriver(enc, cfg_k, frames[s : s + ln], finish, dev)
            drv.start()
        drivers.append((enc, drv, dev))

    rounds = max(d.num_chunks() for _, d, _ in drivers)
    for ci in range(rounds):
        for _, drv, dev in drivers:  # dispatch everywhere first (async)
            if ci < drv.num_chunks():
                with on_device(dev):
                    drv.dispatch(ci)
        for _, drv, dev in drivers:  # then serialise the round before
            if 0 < ci <= drv.num_chunks():
                with on_device(dev):
                    drv.collect()
    for _, drv, dev in drivers:
        with on_device(dev):
            drv.collect()
    encs = [e for e, _, _ in drivers]
    return stitch(encs), [r for e in encs for r in e.results]
