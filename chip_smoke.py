#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (tpuhevc_torch) on one card.

    python3 chip_smoke.py

1. Needs CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from tpuhevc_torch/kernels/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it at 416x240: the LD-P scan kernels at the
   CU classes c32/c16/cf plus the 8x8 luma / 4x4 chroma class of sizes
   that are not 16-aligned; the intra decision kernels at every call of
   the decision (both passes) of one all-intra picture and of one LD-P
   IDR, captured from the decision itself. Prints the max difference and
   median times (CUDA events).
4. Main path 1, LD-P: encodes a 416x240, 17-frame synthetic clip through
   the port's encode_sequence (anchor LD-P cfg, QP 32, FmeMode nn with
   seeded weights, RDOQ/SBH/SAO/deblocking off) with the launch counters
   reset just before; all eight kernels must have launched (the IDR's
   decision runs the intra kernels). Main path 2, all-intra: 3 pictures
   of the same clip with cfg/encoder_intra_main.cfg (RDOQ, NxN), counters
   reset just before; the four intra kernels must have launched. Decodes
   both streams with tpuhevc's host decoder: every picture hash must match
   and the recon must equal the encoder's. Cross-checks CUDA against the
   CPU path at 112x72 for both paths (bitstreams byte-identical).
5. Last line: {"ok": true, "device": {...}}. Any failure raises (exit != 0).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from tools.make_test_clip import make_clip  # noqa: E402
from tpuhevc.codec.decoder import decode_stream  # noqa: E402
from tpuhevc.codec.inter_batch import _blk_idx, _positions, _win_idx  # noqa: E402
from tpuhevc.codec.params import EncoderConfig, SeqParams, p_frame_lambda  # noqa: E402
from tpuhevc.config.options import build_config, parse_args  # noqa: E402
from tpuhevc.models import nnfme as ref_nnfme  # noqa: E402
from tpuhevc.utils.tables import chroma_qp  # noqa: E402
from tpuhevc.codec.recon import _pad_to  # noqa: E402
from tpuhevc_torch.codec import intra_decide  # noqa: E402
from tpuhevc_torch.codec.encoder import encode_sequence  # noqa: E402
from tpuhevc_torch.codec.intra_decide import decide_intra_qt  # noqa: E402
from tpuhevc_torch.device import require_cuda  # noqa: E402
from tpuhevc_torch.entropy.bitest import tu_bits, tu_bits_plain  # noqa: E402
from tpuhevc_torch.kernels import KERNELS, LAUNCHES, reset_launches  # noqa: E402
from tpuhevc_torch.kernels import build as kbuild  # noqa: E402
from tpuhevc_torch.models.nnfme import (  # noqa: E402
    NNFME, height_category, nn_refine, nn_refine_plain, random_params,
    width_category)
from tpuhevc_torch.ops.cost import satd35_topk, satd35_topk_plain  # noqa: E402
from tpuhevc_torch.ops.interp import mc_blk, mc_blk_plain  # noqa: E402
from tpuhevc_torch.ops.intra import intra_bank, predict_all_modes_plain  # noqa: E402
from tpuhevc_torch.ops.intra_txq import intra_txq, intra_txq_plain  # noqa: E402
from tpuhevc_torch.ops.me import bits_table, sad_search, sad_search_plain  # noqa: E402
from tpuhevc_torch.ops.txq import txq, txq_plain  # noqa: E402

SOURCES = {
    "sad_search": ("tpuhevc_torch/kernels/csrc/sad_search.cu",
                   "tpuhevc/codec/inter_batch.py:139"),
    "nnfme_mlp": ("tpuhevc_torch/kernels/csrc/nnfme_mlp.cu",
                  "tpuhevc/models/nnfme.py:176"),
    "mc_blk": ("tpuhevc_torch/kernels/csrc/mc_blk.cu",
               "tpuhevc/codec/inter_batch.py:166"),
    "txq": ("tpuhevc_torch/kernels/csrc/txq.cu",
            "tpuhevc/codec/inter_batch.py:193"),
    "intra_bank": ("tpuhevc_torch/kernels/csrc/intra_bank.cu",
                   "tpuhevc/ops/intra.py:197"),
    "satd35_topk": ("tpuhevc_torch/kernels/csrc/satd35_topk.cu",
                    "tpuhevc/codec/intra_decide_jax.py:75"),
    "intra_txq": ("tpuhevc_torch/kernels/csrc/intra_txq.cu",
                  "tpuhevc/codec/intra_decide_jax.py:86"),
    "tu_bits": ("tpuhevc_torch/kernels/csrc/tu_bits.cu",
                "tpuhevc/entropy/bitest.py:286"),
}
INTRA = ("intra_bank", "satd35_topk", "intra_txq", "tu_bits")
INTRA_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
N_INTRA = 3  # all-intra pictures (the host walk dominates their time)
W, H, NFRAMES, QP, SEED = 416, 240, 17, 32, 0
SR = 16


def check(cond, what):
    """Fail the smoke run (works under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Reader:
    def __init__(self, w, h, n):
        raw = make_clip(w, h, n)
        fsz = w * h * 3 // 2
        self.frames = []
        for i in range(n):
            b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], np.uint8)
            self.frames.append((b[: w * h].reshape(h, w),
                                b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                                b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))

    def read_frame(self, i):
        return self.frames[i] if i < len(self.frames) else None


def median_ms(fn, reps=25):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def stage_shapes(dev):
    """Per class: the main path's inputs at 416x240 (frame 1 against frame
    0) plus an 8x8 class along the bottom rows (N=52), as non-16-aligned
    sizes have it."""
    clip = Reader(W, H, 2).frames
    cfg = EncoderConfig(sps=SeqParams(width=W, height=H), qp=QP,
                        intra_period=-1, fme_mode="nn")
    classes = list(_positions(cfg)[1])
    classes.append(("c8", [(x, H - 8) for x in range(0, W, 8)], 8))
    ref = [torch.as_tensor(p.astype(np.int32), device=dev) for p in clip[0]]
    org = [torch.as_tensor(p.astype(np.int32), device=dev) for p in clip[1]]
    out = []
    for tag, poss, size in classes:
        xs = np.array([p[0] for p in poss], np.int32)
        ys = np.array([p[1] for p in poss], np.int32)
        out.append(dict(
            tag=tag, size=size, n=len(poss),
            cur=org[0].reshape(-1)[torch.as_tensor(_blk_idx(poss, size, W),
                                                   device=dev).long()],
            cur_c=[p.reshape(-1)[torch.as_tensor(
                _blk_idx(poss, size // 2, W // 2, 2), device=dev).long()]
                for p in org[1:]],
            wnd=ref[0].reshape(-1)[torch.as_tensor(
                _win_idx(poss, size, SR, W, H), device=dev).long()],
            xs=torch.as_tensor(xs, device=dev),
            ys=torch.as_tensor(ys, device=dev),
            xs_c=torch.as_tensor(xs // 2, device=dev),
            ys_c=torch.as_tensor(ys // 2, device=dev),
            ref=ref))
    return out


def check_kernels(dev, model):
    """Kernel vs plain on the card. Returns {name: row} for the JSON line;
    ms/plain_ms are summed over the 416x240 classes (one P frame)."""
    lam_full = int(round(p_frame_lambda(
        EncoderConfig(qp=QP, gop_qp_offsets=(3, 2, 3, 1)), 0, QP + 3) * 256))
    lam_me = int(round(np.sqrt(lam_full / 256.0) * 256))
    bits = bits_table(SR, dev)
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            for k in KERNELS if k not in INTRA}

    def record(name, tag, err, ms, plain_ms):
        r = rows[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        if tag != "c8":  # c8 does not occur at 416x240
            r["ms"] += ms
            r["plain_ms"] += plain_ms
        print(f"kernel {name:10s} {tag:4s} max_abs_err {err:.3g} "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f}", flush=True)

    def exact(a, b):
        return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                   for x, y in zip(a, b))

    for st in stage_shapes(dev):
        size, tag = st["size"], st["tag"]
        # K1
        k = sad_search(st["wnd"], st["cur"], bits, lam_me, SR)
        p = sad_search_plain(st["wnd"], st["cur"], bits, lam_me, SR)
        torch.cuda.synchronize()
        err = exact(k, p)
        check(err == 0, f"sad_search {tag}: {err}")
        record("sad_search", tag, err,
               median_ms(lambda: sad_search(st["wnd"], st["cur"], bits,
                                            lam_me, SR)),
               median_ms(lambda: sad_search_plain(st["wnd"], st["cur"], bits,
                                                  lam_me, SR)))
        mv_int, sad9 = k
        # K2: logits within atol 1e-4 / rtol 1e-5; the argmax must agree
        # wherever the plain top-2 gap exceeds 1e-3
        hc, wc = height_category(size), width_category(size)
        kl, kc, kq = nn_refine(model, sad9, hc, wc)
        pl, pc, pq = nn_refine_plain(model, sad9, hc, wc)
        torch.cuda.synchronize()
        err = float((kl - pl).abs().max())
        torch.testing.assert_close(kl, pl, atol=1e-4, rtol=1e-5)
        top2 = torch.topk(pl, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        check(torch.equal(kc[clear], pc[clear]), f"nnfme argmax {tag}")
        check(torch.equal(kq[clear], pq[clear]), f"nnfme offset {tag}")
        record("nnfme_mlp", tag, err,
               median_ms(lambda: nn_refine(model, sad9, hc, wc)),
               median_ms(lambda: nn_refine_plain(model, sad9, hc, wc)))
        mvq = (mv_int * 4 + kq).contiguous()
        # K3: luma and both chroma planes
        calls = [(st["ref"][0], st["xs"], st["ys"], size, True)] + [
            (pln, st["xs_c"], st["ys_c"], size // 2, False)
            for pln in st["ref"][1:]]
        err = 0
        preds = []
        for pln, xs, ys, s, luma in calls:
            a = mc_blk(pln, xs, ys, mvq, s, luma)
            b = mc_blk_plain(pln, xs, ys, mvq, s, luma)
            torch.cuda.synchronize()
            err = max(err, exact([a], [b]))
            preds.append(a)
        check(err == 0, f"mc_blk {tag}: {err}")
        record("mc_blk", tag, err,
               median_ms(lambda: [mc_blk(*c[:3], mvq, *c[3:]) for c in calls]),
               median_ms(lambda: [mc_blk_plain(*c[:3], mvq, *c[3:])
                                  for c in calls]))
        # K4: luma at QP, chroma at the chroma QP; also a QP-50 luma pass
        # for the int32-wrapping drop product
        tus = [(st["cur"], preds[0], QP)] + [
            (c, pr, chroma_qp(QP)) for c, pr in zip(st["cur_c"], preds[1:])]
        err = 0
        for cur, pred, qp in tus + [(st["cur"], preds[0], 50)]:
            a = txq(cur, pred, qp, lam_full)
            b = txq_plain(cur, pred, qp, lam_full)
            torch.cuda.synchronize()
            err = max(err, exact(a, b))
        check(err == 0, f"txq {tag}: {err}")
        record("txq", tag, err,
               median_ms(lambda: [txq(c, pr, q, lam_full) for c, pr, q in tus]),
               median_ms(lambda: [txq_plain(c, pr, q, lam_full)
                                  for c, pr, q in tus]))
    return rows


INTRA_FUNCS = {  # name: (kernel wrapper, plain version)
    "intra_bank": (intra_bank, predict_all_modes_plain),
    "satd35_topk": (satd35_topk, satd35_topk_plain),
    "intra_txq": (intra_txq, intra_txq_plain),
    "tu_bits": (tu_bits, tu_bits_plain),
}


def intra_cfg(w, h, frames):
    """cfg/encoder_intra_main.cfg at w x h (IntraPeriod 1, RDOQ, QP 32)."""
    cfg, _ = build_config(parse_args([
        "-c", INTRA_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
        "-q", str(QP)]))
    return cfg


def ldp_cfg(npz, w=None, h=None, frames=None):
    """The anchor LD-P cfg at w x h (default: the main path's), cut to the
    LD-P slice."""
    cfg, _ = build_config(parse_args([
        "-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
        "-wdt", str(w or W), "-hgt", str(h or H), "-f", str(frames or NFRAMES),
        "-q", str(QP),
        "--RDOQ=0", "--SignHideFlag=0", "--SAO=0", "--LoopFilterDisable=1",
        "--FmeMode=nn", f"--NNWeightsDir={npz}"]))
    return cfg


def capture_intra_calls(dev, cfg, frame):
    """Run the decision of one picture on the card, both passes (pass 2
    from a recon-like reference: the picture blurred), recording every
    call of the four intra wrappers -> {name: [args]}."""
    calls = {k: [] for k in INTRA}
    saved = {k: getattr(intra_decide, k) for k in INTRA}

    def recorder(name, fn):
        def wrapped(*args):
            calls[name].append(args)
            return fn(*args)
        return wrapped

    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    planes = [_pad_to(np.asarray(p), h >> s, w >> s).astype(np.int32)
              for p, s in zip(frame, (0, 1, 1))]
    blurred = [(p + np.roll(p, 1, 0) + np.roll(p, 1, 1) + np.roll(p, 1, (0, 1))
                + 2) >> 2 for p in planes]
    try:
        for k in INTRA:
            setattr(intra_decide, k, recorder(k, saved[k]))
        decide_intra_qt(*planes, cfg, cfg.qp, device=dev)
        decide_intra_qt(*planes, cfg, cfg.qp, ref_planes=blurred, device=dev)
        torch.cuda.synchronize()
    finally:
        for k in INTRA:
            setattr(intra_decide, k, saved[k])
    return calls


def check_intra_kernels(dev, npz):
    """Kernel vs plain on the card for the intra decision, at every call
    of the two passes of one 416x240 all-intra picture (RDOQ, NxN) and of
    one LD-P IDR (no RDOQ, no NxN). Integer outputs exact; float32 dist,
    d0 and bits within rtol 1e-5, atol 1e-3 (sum order). Returns {name:
    row}; ms/plain_ms are per all-intra picture (both passes)."""
    frame = Reader(W, H, 1).frames[0]
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0) for k in INTRA}
    for tag, cfg in (("all-intra", intra_cfg(W, H, 1)),
                     ("ldp-idr", ldp_cfg(npz))):
        calls = capture_intra_calls(dev, cfg, frame)
        for name in INTRA:
            kern, plain = INTRA_FUNCS[name]
            err = 0.0
            for args in calls[name]:
                a, b = kern(*args), plain(*args)
                torch.cuda.synchronize()
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                for x, y in zip(a, b):
                    check(x.dtype == y.dtype and x.shape == y.shape,
                          f"{name} {tag}: {x.dtype}{tuple(x.shape)} vs "
                          f"{y.dtype}{tuple(y.shape)}")
                    if x.numel() == 0:
                        continue
                    d = float((x.double() - y.double()).abs().max())
                    err = max(err, d)
                    if x.dtype.is_floating_point:
                        torch.testing.assert_close(x, y, rtol=1e-5,
                                                   atol=1e-3)
                    else:
                        check(d == 0, f"{name} {tag}: integer outputs "
                              f"differ by {d}")
            ms = median_ms(lambda: [kern(*c) for c in calls[name]], reps=5)
            plain_ms = median_ms(lambda: [plain(*c) for c in calls[name]],
                                 reps=5)
            r = rows[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if tag == "all-intra":
                r["ms"], r["plain_ms"] = ms, plain_ms
            print(f"kernel {name:11s} {tag:9s} calls {len(calls[name]):3d} "
                  f"max_abs_err {err:.3g} kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} (per picture, both passes)",
                  flush=True)
    return rows


def run_path(dev, cfg, nframes):
    """One main path through encode_sequence with the launch counters set
    to 0 just before and read just after; returns (enc, recons, seconds,
    launches)."""
    reader = Reader(W, H, nframes)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    enc, recons = encode_sequence(reader, cfg, device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t0
    return enc, recons, secs, dict(LAUNCHES)


def check_stream(enc, recons, n, launches, need, what):
    """Every needed kernel launched; n pictures decode hash-OK with the
    encoder's recon, in decoding order (all-intra pictures are IDRs, each
    with POC 0)."""
    check(len(enc.results) == n, f"{what}: encoded {len(enc.results)}")
    missing = [k for k in need if launches[k] <= 0]
    check(not missing, f"{what}: kernels not launched: {missing}")
    frames = decode_stream(enc.bitstream())
    check(len(frames) == n, f"{what}: decoded {len(frames)} pictures")
    check(all(f.md5_ok for f in frames), [f.md5_ok for f in frames])
    for i, (f, (ry, ru, rv)) in enumerate(zip(frames, recons)):
        check(np.array_equal(f.y, ry[:H, :W])
              and np.array_equal(f.u, ru[: H // 2, : W // 2])
              and np.array_equal(f.v, rv[: H // 2, : W // 2]),
              f"{what}: decoded picture {i} (POC {f.poc}) differs from the "
              f"encoder's recon")


def cross_check_cpu(npz):
    """CUDA vs CPU path of the port at 112x72 (all four CU classes), LD-P
    five pictures and all-intra two; returns the two stream sizes."""
    out = []
    for make, n in ((lambda: ldp_cfg(npz, 112, 72, 5), 5),
                    (lambda: intra_cfg(112, 72, 2), 2)):
        r = Reader(112, 72, n)
        a, _ = encode_sequence(r, make(), device="cuda")
        b, _ = encode_sequence(r, make(), device="cpu")
        check(a.bitstream() == b.bitstream(), "CUDA and CPU streams differ")
        out.append(len(a.bitstream()))
    return out


def main():
    dev = require_cuda()
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.time()
    built = kbuild.build()
    print(f"build: {time.time() - t0:.2f} s for {sorted(built)}", flush=True)
    for name, log in kbuild.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "nnfme_seeded.npz")
        params = random_params(SEED)
        ref_nnfme.save_npz(npz, {QP: params})
        model = NNFME.from_numpy(params, dev)

        rows = check_kernels(dev, model)
        rows.update(check_intra_kernels(dev, npz))

        enc, recons, secs, launches = run_path(dev, ldp_cfg(npz), NFRAMES)
        # all eight: the IDR's decision runs the intra kernels too
        check_stream(enc, recons, NFRAMES, launches, KERNELS, "LD-P")
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        print(f"main path LD-P: {W}x{H} x {NFRAMES} frames in {secs:.3f} s "
              f"= {NFRAMES / secs:.3f} fps (IDR {enc.results[0].seconds:.3f} "
              f"s) | {kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
              f"{launches} | {gpu}", flush=True)

        enc, recons, secs, ai_launches = run_path(
            dev, intra_cfg(W, H, N_INTRA), N_INTRA)
        check_stream(enc, recons, N_INTRA, ai_launches, INTRA, "all-intra")
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        pic = [round(r.seconds, 3) for r in enc.results]
        print(f"main path all-intra: {W}x{H} x {N_INTRA} pictures in "
              f"{secs:.3f} s = {N_INTRA / secs:.3f} fps (per picture {pic} "
              f"s) | {kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
              f"{ai_launches} | {gpu}", flush=True)
        for k in KERNELS:
            launches[k] += ai_launches[k]

        nbytes = cross_check_cpu(npz)
        print(f"cross-check 112x72: CUDA == CPU streams (LD-P {nbytes[0]} "
              f"bytes, all-intra {nbytes[1]} bytes)", flush=True)

    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=rows[k]["max_abs_err"], ms=rows[k]["ms"],
                    plain_ms=rows[k]["plain_ms"]) for k in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
