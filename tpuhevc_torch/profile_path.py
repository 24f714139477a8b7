"""Time and profile one encode path of the port on the card.

    python -m tpuhevc_torch.profile_path --path ra [--width 416 --height 240
        --frames 18 --reps 3 --trace chiprun_out/ra_trace.json]
    python -m tpuhevc_torch.profile_path --path bench
    python -m tpuhevc_torch.profile_path --path intra8 --frames 8
    python -m tpuhevc_torch.profile_path --path step --reps 20

Encodes the synthetic clip of `tools/make_test_clip.py` (seed 7) through
`codec.encoder.encode_sequence` with one of the repository's cfgs: `ra`
(cfg/encoder_randomaccess_main.cfg as shipped), `ldp`
(cfg/encoder_lowdelay_P_main.cfg as shipped: RDOQ, sign hiding, SAO and
deblocking on, the P pictures through the grid step), `intra`
(cfg/encoder_intra_main.cfg) or `intra8` (the same cfg with fixed 8x8
intra, `intra_qt` off: every picture coded whole by kernel `intra_wave`, four
pictures a launch through `encode_sequence(..., device_batch=4)`), QP
32,
NN-FME weights random from seed 0. One encode warms up (kernel builds,
caches), `reps` more are timed on the host clock ended by
`torch.cuda.synchronize()`, and a last one runs under `torch.profiler`:
the device's busy time is the sum of the device-side events' time (the
kernels and copies themselves, not the host operators that launched
them, which the profiler credits with the same time), its idle share
1 - busy / wall over the profiled encode. Prints the card's
name and power limit beside every number. Needs a CUDA device.

`bench` runs bench.py's clip, cfg and procedure on the port: 32 frames of
`make_clip(416, 240, 32)`, the anchor LD-P cfg at QP 32 with four
references, IntraPeriod -1, FmeMode nn, the checksum hash and no recon
fetch (the P pictures' recon stays on the card); a 6-frame warm-up
encode, then the best of 4 timed encodes, printed as frames/s. The repo
ships no NN-FME weights, so FmeMode nn runs integer-pel there, as it
does in bench.py. This is not a benchmark and prints no comparison with
bench.py's target, which was set for a TPU.

`step` times the grid step alone (`GridStep.frame_step`, the LD-P
path's P picture) on one picture of the anchor cfg as shipped, TMVP
granted: frame 4 of the clip against frames 3..0 as its four references
(the originals standing in for their recons), GOP position 0, the MV
seed and collocated field of the step's first picture. One call warms
up, then `reps` calls (default 20) are timed with CUDA events; prints
their median and the median host time of a call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

CFGS = {
    "ra": ("encoder_randomaccess_main.cfg", []),
    "ldp": ("encoder_lowdelay_P_main.cfg", []),
    "intra": ("encoder_intra_main.cfg", []),
    "intra8": ("encoder_intra_main.cfg", []),  # with intra_qt off
    # bench.py: the checksum hash without the recon fetch, no NN weights
    "bench": ("encoder_lowdelay_P_main.cfg", ["--SEIDecodedPictureHash=3"]),
    "step": ("encoder_lowdelay_P_main.cfg", []),
}
BENCH_FRAMES, BENCH_WARMUP, BENCH_REPS = 32, 6, 4  # bench.py's procedure
INTRA8_BATCH = 4  # intra8: pictures a launch, as chip_smoke.py runs it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clip:
    def __init__(self, w: int, h: int, n: int):
        from tools.make_test_clip import make_clip

        raw = make_clip(w, h, n)
        fsz = w * h * 3 // 2
        self.frames = []
        for i in range(n):
            b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], np.uint8)
            self.frames.append((
                b[: w * h].reshape(h, w),
                b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))

    def read_frame(self, i):
        return self.frames[i] if i < len(self.frames) else None


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_step(cfg, nn_by_qp, clip, dev, reps: int, gpu: str) -> None:
    """`step`: the grid step's median event and host ms a picture."""
    from .codec import inter_grid

    cfg.sps.temporal_mvp_enabled = cfg.tmvp
    step = inter_grid.GridStep(cfg, nn_by_qp, dev)
    R, W, H = step.R, step.W, step.H

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    f = clip.frames
    carry = step.carry0(
        dev_t(np.stack([f[3 - r][0] for r in range(R)]).astype(np.int32)),
        dev_t(np.stack([np.concatenate(f[3 - r][1:], 1)
                        for r in range(R)]).astype(np.int32)))
    fu8 = dev_t(np.concatenate([p.ravel() for p in f[4]]))
    tabs = inter_grid._Tabs(inter_grid.grid_live_tables(cfg, {})[0], dev)
    step.frame_step(carry, fu8, R, 0, tabs)
    torch.cuda.synchronize()
    ev, host = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        step.frame_step(carry, fu8, R, 0, tabs)
        b.record()
        host.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        ev.append(a.elapsed_time(b))
    print(f"step {W}x{H}: grid step (GridStep.frame_step), the anchor cfg, "
          f"one P picture, {reps} calls: event ms median "
          f"{float(np.median(ev)):.3f} (all {[round(x, 3) for x in ev]}), "
          f"host ms median {float(np.median(host)):.3f} | {gpu}", flush=True)


def main(argv=None) -> int:
    from .codec.encoder import encode_sequence
    from .config.options import build_config, parse_args
    from .device import require_cuda
    from .models.nnfme import random_params, save_npz

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(CFGS), default="ra")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=None,
                    help="default 18; bench: 32")
    ap.add_argument("--reps", type=int, default=None,
                    help="default 3; bench: 4, the best of them")
    ap.add_argument("--trace", default=None,
                    help="write the profiled encode's chrome trace here")
    args = ap.parse_args(argv)
    bench = args.path == "bench"
    frames = args.frames or (BENCH_FRAMES if bench else 18)
    reps = args.reps or (BENCH_REPS if bench else 3)
    dev = require_cuda()
    gpu = gpu_line()
    clip = _Clip(args.width, args.height, frames)
    cfg_file, extra = CFGS[args.path]
    if args.path == "step":
        frames = max(frames, 5)
        reps = args.reps or 20
        clip = _Clip(args.width, args.height, frames)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "nnfme_seeded.npz")
        save_npz(npz, {32: random_params(0)})
        if args.path == "step":
            cfg, _ = build_config(parse_args([
                "-c", os.path.join(ROOT, "cfg", cfg_file),
                "-wdt", str(args.width), "-hgt", str(args.height),
                "-f", str(frames), "-q", "32", f"--NNWeightsDir={npz}"]))
            qps = {min(max(cfg.qp + o, 0), 51) for o in cfg.gop_qp_offsets}
            time_step(cfg, {q: random_params(0) for q in qps}, clip, dev,
                      reps, gpu)
            return 0
        # bench.py names no weights: FmeMode nn runs integer-pel
        weights = [] if bench else [f"--NNWeightsDir={npz}"]

        def encode(n=frames):
            cfg, _ = build_config(parse_args([
                "-c", os.path.join(ROOT, "cfg", cfg_file),
                "-wdt", str(args.width), "-hgt", str(args.height),
                "-f", str(n), "-q", "32"] + weights + extra))
            cfg.fetch_recon = not bench
            intra8 = args.path == "intra8"
            if intra8:
                cfg.intra_qt = False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc, _ = encode_sequence(clip, cfg, max_frames=n, device=dev,
                                     device_batch=INTRA8_BATCH if intra8
                                     else 0)
            torch.cuda.synchronize()
            return enc, time.perf_counter() - t0

        encode(BENCH_WARMUP if bench else frames)
        secs = [encode()[1] for _ in range(reps)]
        print(f"{args.path} {args.width}x{args.height} x {frames}: warm "
              f"encodes {[round(s, 4) for s in secs]} s, "
              f"{frames / min(secs):.3f} frames/s at best | {gpu}",
              flush=True)
        if bench:
            print("bench: bench.py's clip, cfg and procedure (the anchor LD-P "
                  "cfg, QP 32, 4 references, the checksum hash, no recon "
                  "fetch; a 6-frame warm-up, the best of 4); FmeMode nn ran "
                  "integer-pel for want of NN-FME weights, as in bench.py",
                  flush=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            enc, wall = encode()
        stats = prof.key_averages()
        dev_us = {e.key: e.self_device_time_total for e in stats
                  if e.self_device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA}
        busy = sum(dev_us.values()) / 1e6
        print(f"profiled encode {wall:.4f} s: device busy {busy * 1e3:.3f} "
              f"ms, idle {100 * (1 - busy / wall):.2f}% | {gpu}", flush=True)
        pic = [(r.poc, round(r.seconds, 4)) for r in enc.results]
        print(f"per picture (poc, host seconds in encode_frame): {pic}")
        for key, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
            calls = next(e.count for e in stats if e.key == key)
            print(f"  device {us / 1e3:9.3f} ms  calls {calls:5d}  {key}")
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                        exist_ok=True)
            prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
