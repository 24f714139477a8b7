"""`intra_bank` and `tu_bits` on the card against their plain versions on
the same card, `torch.equal` (no JAX):

- `intra_bank` (16-byte stores, a warp's lanes on one mode, the extended
  references tabulated once a CTA) at every S, luma and chroma, with and
  without strong smoothing; flat references at the edges of the strong
  smoothing threshold (2^(bd-5) - 1 and 2^(bd-5), each sign, top and
  left apart); references at 0 and (1 << bd) - 1 at bit depths 8 and 10;
  block counts that leave a CTA's last blocks empty; S = 4 over a
  1920x1088 picture (130,560 blocks);
- `tu_bits` (lane teams of 16-byte vectors, exact fixed-point sums) at
  every S, luma and chroma:
  all-zero TUs, DC-only TUs, the last position at the last scan
  position, levels up to 2^15 with alternating signs (escape lengths),
  TU counts that leave a warp's or a block's last TUs empty;
- both kernels, two launches back to back without a sync between.

On the CPU, the host side of `intra_wave`: the variant that keeps the
recon planes on chip where they fit (8 bits: 104x72, 416x240; 10 bits,
two bytes a plane sample: 104x72, 192x128, 256x240) and in device memory
where they do not (8 bits: 832x480, 1920x1088; 10 bits: 416x240 and those),
its shared-memory bytes and the packed slot words of the wave schedule;
the wrapper's refusal of bit depths other than 8 and 10. On the card,
`intra_wave10` (the kernel's 10-bit variant) against its plain version
on 10-bit planes (noise, and pictures at 0 and 1023 alone) at 104x72
and 192x128 (on chip), 256x240 (on chip, a cluster of 4 blocks a frame)
and 416x240 (in device memory), two launches back
to back, one count of `intra_wave10` a launch and none of `intra_wave`.
Without a card every other item skips.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc_torch.codec.intra_qt import I_ROW
from tpuhevc_torch.entropy.bitest import (
    FracBits, est_tables, tu_bits, tu_bits_plain)
from tpuhevc_torch.codec.intra_frame import _sqlam_fp, wave_tables
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams
from tpuhevc_torch.kernels import LAUNCHES, reset_launches
from tpuhevc_torch.ops.intra import intra_bank, predict_all_modes_plain, refs
from tpuhevc_torch.ops.intra_wave import (SMEM_LIMIT, intra_wave,
                                          intra_wave_plain, wave_smem,
                                          wave_variant)

SIZES = (4, 8, 16, 32)


def bank_refs(S, bd, n, seed):
    """(tops, lefts) (m, 2S+1) int32: n noise blocks, then flat blocks
    whose top and left deviations t0 + t2S - 2 tS (l0 + l2S - 2 lS) take
    each of +-(2^(bd-5) - 1) and +-2^(bd-5), then blocks at 0, at
    (1 << bd) - 1 and alternating between the two."""
    rng = np.random.default_rng(seed)
    hi, mid, thr = (1 << bd) - 1, 1 << (bd - 1), 1 << (bd - 5)
    t = [rng.integers(0, hi + 1, (n, 2 * S + 1))]
    l = [rng.integers(0, hi + 1, (n, 2 * S + 1))]
    devs = (thr - 1, thr, 1 - thr, -thr)
    for dt in devs:
        for dl in devs:
            a, b = np.full(2 * S + 1, mid), np.full(2 * S + 1, mid)
            a[2 * S] += dt
            b[2 * S] += dl
            t.append(a[None])
            l.append(b[None])
    alt = np.where(np.arange(2 * S + 1) % 2, hi, 0)
    for a, b in ((0, 0), (hi, hi), (0, hi), (alt, hi - alt)):
        t.append(np.broadcast_to(a, (1, 2 * S + 1)))
        l.append(np.broadcast_to(b, (1, 2 * S + 1)))
    return tuple(torch.as_tensor(np.concatenate(x), dtype=torch.int32)
                 for x in (t, l))


def check_bank(tops, lefts, S, luma, bd, strong):
    n0 = LAUNCHES["intra_bank"]
    got = intra_bank(tops, lefts, S, luma, bd, strong)
    want = predict_all_modes_plain(tops, lefts, S, luma, bd, strong)
    torch.cuda.synchronize()
    assert LAUNCHES["intra_bank"] == n0 + 1
    assert got.dtype == torch.int32 and torch.equal(got, want), (S, luma, bd)


@pytest.mark.cuda
@pytest.mark.parametrize("S", SIZES)
def test_intra_bank_matches_plain(cuda_device, S):
    """Luma (strong smoothing on and off) and chroma at bit depths 8 and
    10; 1, 3, 8k + 3 and 2k + 1 noise blocks before the flat and extreme
    ones."""
    for bd in (8, 10):
        for n in (1, 3, 27, 53):
            t, l = (x.to(cuda_device) for x in bank_refs(S, bd, n, S + n + bd))
            for luma, strong in ((True, True), (True, False), (False, False)):
                check_bank(t, l, S, luma, bd, strong)


@pytest.mark.cuda
def test_intra_bank_s4_1080p(cuda_device):
    """S = 4 over a 1920x1088 picture: 130,560 blocks, luma."""
    plane = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (1088, 1920)), dtype=torch.int32, device=cuda_device)
    t, l = refs(plane, 4, 1088 // 4, 1920 // 4)
    assert t.shape[0] == 130560
    check_bank(t, l, 4, True, 8, True)


def bits_tiles(S, n, seed):
    """(m, S, S) int32 levels: all-zero, DC-only, the last position at the
    last scan position (alone and under noise), levels up to 2^15 with
    alternating signs, then n sparse noise TUs."""
    rng = np.random.default_rng(seed)
    tiles = [np.zeros((2, S, S), np.int64)]
    dc = np.zeros((3, S, S), np.int64)
    dc[:, 0, 0] = (1, -7, 1 << 15)
    tiles.append(dc)
    corner = np.round(rng.normal(0, 2, (2, S, S)))
    corner[0] = 0
    corner[:, S - 1, S - 1] = (-1, 40)
    tiles.append(corner)
    big = rng.integers(0, 1 << 15, (3, S, S)) + 1
    big = big * np.where(np.arange(S * S).reshape(S, S) % 2, -1, 1)
    big[1] //= 1 << rng.integers(0, 15, (S, S))  # every escape length
    big[2, :, S // 2:] = 0
    tiles.append(big)
    noise = np.round(rng.normal(0, rng.choice((0.4, 1.5, 6, 50), (n, 1, 1)),
                                (n, S, S)))
    noise[rng.random((n, S, S)) < rng.random((n, 1, 1))] = 0
    tiles.append(noise)
    return torch.as_tensor(np.concatenate(tiles), dtype=torch.int32)


def check_bits(est, tiles):
    n0 = LAUNCHES["tu_bits"]
    got = tu_bits(est, tiles)
    want = tu_bits_plain(est, tiles)
    torch.cuda.synchronize()
    assert LAUNCHES["tu_bits"] == n0 + 1
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.cuda
def test_tu_bits_matches_plain(cuda_device):
    """Every S, luma and chroma, at QP 22 and 37; TU counts of 1, 8k + 5
    and 64k + 37 noise TUs after the edge cases."""
    for qp in (22, 37):
        fb = FracBits(I_ROW, qp)
        for S in SIZES:
            for luma in (True, False) if S < 32 else (True,):
                est = est_tables(fb, S.bit_length() - 1, luma, cuda_device)
                for n in (1, 29, 101):
                    check_bits(est, bits_tiles(S, n, S + n + qp).to(cuda_device))


@pytest.mark.cuda
def test_bank_and_bits_back_to_back(cuda_device):
    """Two launches of each kernel back to back on different inputs, no
    sync between; then each against plain."""
    fb = FracBits(I_ROW, 32)
    for S in SIZES:
        ins = [tuple(x.to(cuda_device) for x in bank_refs(S, 8, 61, s))
               for s in (1, 2)]
        got = [intra_bank(t, l, S, True, 8, True) for t, l in ins]
        est = est_tables(fb, S.bit_length() - 1, True, cuda_device)
        tiles = [bits_tiles(S, 77, s).to(cuda_device) for s in (3, 4)]
        bits = [tu_bits(est, x) for x in tiles]
        torch.cuda.synchronize()
        for g, (t, l) in zip(got, ins):
            assert torch.equal(g, predict_all_modes_plain(t, l, S, True, 8,
                                                          True))
        for g, x in zip(bits, tiles):
            assert torch.equal(g, tu_bits_plain(est, x))


def test_intra_wave_variant_and_smem():
    """The recon on chip where 1.5 w h + w h / 64 bytes of 8-bit planes fit
    beside the per-slot words (499 a slot, 560 fixed: intra_wave.cu's
    layout), else in device memory; a cluster of 4 blocks a frame where
    the waves hold 5 cells or more on average; a size that fits neither
    raises. The slot words decode to the schedule's cells and flags."""
    expect = {(104, 72): (5, True, 1), (192, 128): (8, True, 1),
              (416, 240): (14, True, 4), (832, 480): (25, False, 1),
              (1920, 1088): (52, False, 1)}
    for (w, h), (bmax, on_chip, cluster) in expect.items():
        geo = wave_tables(w, h, 6, "cpu")
        steps = geo.slots.shape[0]
        assert geo.slots.shape[1] == bmax
        assert (on_chip and (w // 8) * (h // 8) >= 5 * steps) == (
            cluster == 4)
        work = 4 * (560 + 499 * bmax)
        planes = 3 * w * h // 2 + (w // 8) * (h // 8)
        assert wave_smem(w, h, bmax, False, 8) == work
        assert wave_smem(w, h, bmax, True, 8) == work + planes
        assert (work + planes <= SMEM_LIMIT) == on_chip
        assert wave_variant(w, h, steps, bmax, 8) == (
            on_chip, cluster, work + planes * on_chip)
        v, cells, w8 = geo.slots, geo.cells, w // 8
        ok = cells >= 0
        assert torch.equal(v >= 0, ok)
        assert torch.equal((((v >> 12) & 0xFFF) * w8 + (v & 0xFFF))[ok],
                           cells[ok])
        assert torch.equal((v >> 24)[ok], geo.flags[ok])
    assert wave_smem(416, 240, 14, True, 8) == 181504
    with pytest.raises(ValueError):
        wave_variant(1920, 1088, 1156, 466, 8)


def test_intra_wave10_variant_and_smem():
    """At bit depth 10 the planes take two bytes a sample (3 w h + w h /
    64 bytes with the mode map): on chip at 104x72 (34,801 bytes in all)
    and 192x128 (92,320), one block a frame; at 256x240 (211,472, 6.5
    cells a wave) in a cluster of 4 blocks a frame, as at 8 bits; in
    device memory at 416x240 (331,264 would not fit), 832x480 and
    1920x1088."""
    expect = {(104, 72): (5, True, 1, 34801),
              (192, 128): (8, True, 1, 92320),
              (256, 240): (12, True, 4, 211472),
              (416, 240): (14, False, 1, 30184),
              (832, 480): (25, False, 1, None),
              (1920, 1088): (52, False, 1, None)}
    for (w, h), (bmax, on_chip, cluster, smem) in expect.items():
        geo = wave_tables(w, h, 6, "cpu")
        steps = geo.slots.shape[0]
        assert geo.slots.shape[1] == bmax
        work = 4 * (560 + 499 * bmax)
        planes = 3 * w * h + (w // 8) * (h // 8)
        assert wave_smem(w, h, bmax, False, 10) == work
        assert wave_smem(w, h, bmax, True, 10) == work + planes
        assert (work + planes <= SMEM_LIMIT) == on_chip
        assert (on_chip and (w // 8) * (h // 8) >= 5 * steps) == (
            cluster == 4)
        got = wave_variant(w, h, steps, bmax, 10)
        assert got == (on_chip, cluster, work + planes * on_chip)
        assert smem is None or got[2] == smem
    assert wave_smem(416, 240, 14, True, 10) == 331264


def wave10_case(w, h, seed):
    """(planes (2, ...) int32: a 10-bit noise picture and one at 0 and
    1023 alone; geometry on the CPU; qp; sqlam_fp)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = 512 + 300 * np.sin(xx / 9 + yy / 13)
    noise = np.clip(smooth + rng.normal(0, 40, (h, w)), 0, 1023)
    checker = 1023 * (((xx >> 3) + (yy >> 3)) & 1)
    ys = np.stack([noise, checker]).astype(np.int32)
    cs = [np.stack([rng.integers(0, 1024, (h // 2, w // 2)),
                    1023 * (((np.arange(w // 2)[None] >> 2)
                             + (np.arange(h // 2)[:, None] >> 2) + k) & 1)])
          .astype(np.int32) for k in (0, 1)]
    cfg = EncoderConfig(sps=SeqParams(width=w, height=h, bit_depth=10,
                                      profile_idc=2), qp=32,
                        intra_period=1, intra_qt=False)
    planes = [torch.from_numpy(p) for p in (ys, *cs)]
    return planes, wave_tables(w, h, cfg.sps.log2_ctu, "cpu"), _sqlam_fp(cfg)


@pytest.mark.parametrize("bd", [7, 9, 12, 16])
def test_intra_wave_refuses_bit_depth(bd):
    """The caller names the depth: only 8 and 10 run, on any device."""
    planes, geo, sqlam = wave10_case(16, 16, 0)
    with pytest.raises(ValueError, match="bit depth"):
        intra_wave(*planes, geo, 32, sqlam, bit_depth=bd)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,on_chip,cluster", [(104, 72, True, 1),
                                                 (192, 128, True, 1),
                                                 (256, 240, True, 4),
                                                 (416, 240, False, 1)])
def test_cuda_intra_wave10_matches_plain(cuda_device, w, h, on_chip,
                                         cluster):
    """Two launches back to back on different inputs, no sync between,
    each against plain, in each 10-bit variant (on chip one block or a
    cluster of 4 a frame, in device memory): every output torch.equal,
    `intra_wave10` counted once a launch, `intra_wave` idle."""
    cases = [wave10_case(w, h, seed) for seed in (1, 2)]
    geo = wave_tables(w, h, 6, cuda_device)
    assert wave_variant(w, h, *geo.slots.shape, 10)[:2] == (on_chip, cluster)
    reset_launches()
    got = [intra_wave(*(p.to(cuda_device) for p in planes), geo, 32, sqlam,
                      bit_depth=10) for planes, _, sqlam in cases]
    torch.cuda.synchronize()
    assert LAUNCHES["intra_wave10"] == 2 and LAUNCHES["intra_wave"] == 0
    for g, (planes, geo_cpu, sqlam) in zip(got, cases):
        want = intra_wave_plain(*planes, geo_cpu, 32, sqlam, bit_depth=10)
        for a, b in zip(g, want):
            assert torch.equal(a.cpu(), b)
        assert min(int(x.min()) for x in want[:3]) == 0
        assert max(int(x.max()) for x in want[:3]) == 1023
