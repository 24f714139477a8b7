"""Time and profile one encode path of the port on the card.

    python -m tpuhevc_torch.profile_path --path ra [--width 416 --height 240
        --frames 18 --reps 3 --trace chiprun_out/ra_trace.json]
    python -m tpuhevc_torch.profile_path --path bench
    python -m tpuhevc_torch.profile_path --path intra8 --frames 8
    python -m tpuhevc_torch.profile_path --path step --reps 20
    python -m tpuhevc_torch.profile_path --path train
    python -m tpuhevc_torch.profile_path --path fwp --frames 17
    python -m tpuhevc_torch.profile_path --path stripes

Encodes the synthetic clip of `tools/make_test_clip.py` (seed 7) through
`codec.encoder.encode_sequence` with one of the repository's cfgs: `ra`
(cfg/encoder_randomaccess_main.cfg as shipped), `ldp`
(cfg/encoder_lowdelay_P_main.cfg as shipped: RDOQ, sign hiding, SAO and
deblocking on, the P pictures through the grid step), `intra`
(cfg/encoder_intra_main.cfg) or `intra8` (the same cfg with fixed 8x8
intra, `intra_qt` off: every picture coded whole by kernel `intra_wave`, four
pictures a launch through `encode_sequence(..., device_batch=4)`) or
`fwp` (the `ldp` cfg with FmeMode dctif and WeightedPredP 1 on the fade
clip, `make_fade_clip`: grid_subpel and grid_wp_me), QP
32,
NN-FME weights random from seed 0. One encode warms up (kernel builds,
caches), `reps` more are timed on the host clock ended by
`torch.cuda.synchronize()`, and a last one runs under `torch.profiler`:
the device's busy time is the sum of the device-side events' time (the
kernels and copies themselves, not the host operators that launched
them, which the profiler credits with the same time), its idle share
1 - busy / wall over the profiled encode; the largest device items and
the grid step's kernels (STEP_KERNELS) over it. Prints the card's
name and power limit beside every number. The encode paths also print
the device time and launches over the profiled encode of the grid
step's kernels and of the intra decision's (IDR_KERNELS: intra_bank,
satd35_topk, intra_txq, tu_bits; in `ldp` only the IDR launches them,
and `--path intra --frames 1` is one all-intra picture), and of every
other kernel of KERNEL_SYMBOLS the encode launched (K1, K3, K4 and the B
step's in `ra`, grid_stats in `bench`, grid_wp_me and grid_subpel in
`fwp`). `ra` then replays b_pred's and b_txq's calls of one more encode
(`b_split`): their `device_ms` as the B step makes them, and each plane's
class alone. Needs a CUDA device.

`stripes` is the multi-device path's stripe kernels as `chip_smoke.py`'s
path 7 runs them on one card (a mesh of 3 x the card): `tile_prescreen`
of the clip's frame 1 at 416x240 in 3 stripes (kernel
`stripe_prescreen`, one launch a device: here one for the 3 stripes; a
launch a stripe on a parent tree before it) and `stripe_refine` of frame 1
against frame 0 in 3 stripes (grid_refine with each stripe's ry_y0),
`reps` calls (default 20) of each under `torch.profiler`: the device
time and launches of their kernels a call.

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
their median and the median host time of a call. Then five such
pictures under `torch.profiler`: the device time and launches a picture
of the kernels of grid_coarse (both launches; the prestage's also
alone, grid_prestage), grid_refine, grid_planes, grid_satd (the
gathers and the SATD costs), K2, grid_intra16, grid_deblock and grid_sao
(its statistics, decision and apply), and the count of every device
operation of the step a picture (kernels, copies and fills); K2's device
time at each of its calls of a picture (one: the 16x16, 8x8 and 32x32
classes' PUs in one launch). Then kernel
`grid_code`'s share: its launches in one such picture (recorded from the
step, as the step makes them: each class coding's planes in one launch),
replayed 5 times under `torch.profiler`, the device time of its kernel a
picture (`kernel_ms`: the kernel's own time, whatever the wrapper's host
work), and the same planes one a launch, in all and by TU size and plane,
with the anchor's tools (RDOQ, sign hiding) and with them cut (the flat
quantiser: `--RDOQ=0 --SignHideFlag=0`, deblocking and SAO off too).

`train` is NN-FME training as `chip_smoke.py`'s path 8 runs it: the
dataset extracted from `make_clip(416, 240, 17)` at QP 32, SearchRange
16, then `models.fme_train.train_fme` at the full `TrainConfig` (1,000
steps of 1,024). One run warms up, `reps` more are timed on the host
clock, and one runs under `torch.profiler`: the device's busy and idle
share over the run and each kernel's device time summed over it. Then
each train-step kernel's `device_ms` (`device_ms`: CUDA events around
200 back-to-back launches queued behind a device sleep, over 200) at
B = 1,024 on the run's first batch. `chip_smoke.py` takes its path 8
data from `fme_dataset` and `train_inputs` here.
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
    # LD-P with DCT-IF FME and weighted prediction, on the fade clip
    "fwp": ("encoder_lowdelay_P_main.cfg",
            ["--FmeMode=dctif", "--WeightedPredP=1"]),
}
BENCH_FRAMES, BENCH_WARMUP, BENCH_REPS = 32, 6, 4  # bench.py's procedure
# step: the anchor's four tools cut (grid_code's flat quantiser)
STEP_CUT = ["--RDOQ=0", "--SignHideFlag=0", "--SAO=0", "--LoopFilterDisable=1"]
INTRA8_BATCH = 4  # intra8: pictures a launch, as chip_smoke.py runs it
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# train: path 8's extraction (416x240 x 17 at QP 32, SearchRange 16), the
# steps chip_smoke.py holds against the plain versions, the launches a
# device_ms
TRAIN_W, TRAIN_H, TRAIN_FRAMES, TRAIN_QP, TRAIN_SR = 416, 240, 17, 32, 16
TRAIN_STEPS_CHECKED, DEVICE_LAUNCHES = 20, 200
SLEEP_CYCLES = 100_000_000  # ~50-60 ms at the H100's clocks


class _Clip:
    def __init__(self, w: int, h: int, n: int, fade: bool = False):
        from tools.make_test_clip import make_clip, make_fade_clip

        raw = (make_fade_clip if fade else make_clip)(w, h, n)
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


def step_inputs(cfg, nn_by_qp, clip, dev):
    """The grid step of cfg (TMVP as cfg asks) on frame 4 of clip against
    frames 3..0: (step, carry, the picture's planes, the tables)."""
    from .codec import inter_grid

    cfg.sps.temporal_mvp_enabled = cfg.tmvp
    step = inter_grid.GridStep(cfg, nn_by_qp, dev)
    R = step.R

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    f = clip.frames
    carry = step.carry0(
        dev_t(np.stack([f[3 - r][0] for r in range(R)]).astype(np.int32)),
        dev_t(np.stack([np.concatenate(f[3 - r][1:], 1)
                        for r in range(R)]).astype(np.int32)))
    fu8 = dev_t(np.concatenate([p.ravel() for p in f[4]]))
    tabs = inter_grid._Tabs(inter_grid.grid_live_tables(cfg, {})[0], dev)
    return step, carry, fu8, tabs


def code_split(cfg, nn_by_qp, clip, dev, gpu: str, tag: str) -> None:
    """`step`: kernel grid_code's device time in one P picture of cfg: its
    launches recorded from the step and replayed; then each plane alone,
    in all and by (TU size, plane shape)."""
    from .codec import inter_grid

    step, carry, fu8, tabs = step_inputs(cfg, nn_by_qp, clip, dev)
    calls = []
    code = inter_grid.grid_code_batch

    def recorded(jobs, *a):
        calls.append((jobs, a))
        return code(jobs, *a)

    inter_grid.grid_code_batch = recorded
    try:
        step.frame_step(carry, fu8, step.R, 0, tabs)
        torch.cuda.synchronize()
    finally:
        inter_grid.grid_code_batch = code
    singles = [([j], a) for jobs, a in calls for j in jobs]
    groups: dict = {}
    for jobs, a in singles:
        groups.setdefault((jobs[0][2], tuple(jobs[0][0].shape)), []).append(
            (jobs, a))

    def replay(cs):
        return kernel_ms(lambda: [code(j, *a) for j, a in cs], "grid_code")

    total, alone = replay(calls), replay(singles)
    split = {f"T{t} {h}x{w}": (len(cs), round(replay(cs), 5))
             for (t, (h, w)), cs in sorted(groups.items())}
    print(f"step {step.W}x{step.H}: grid_code, {tag}: {len(singles)} planes "
          f"in {len(calls)} launches, kernel_ms {total:.5f} a picture; the "
          f"planes one a launch {alone:.5f}, by (TU size, plane): "
          f"{ {k: v for k, v in split.items()} } (planes, kernel_ms) | {gpu}",
          flush=True)


# every kernel of the port by the names the profiler gives it (a
# template's name ends in "<", a plain function's in "("; a name given
# with "<" matches those template arguments: the prestage is `grid_coarse`'s tile-4 pick, so it is also
# inside the `grid_coarse` row, which takes both of the step's launches;
# a redesigned kernel keeps its parent's name after its own, so that this
# file also profiles the parent tree)
KERNEL_SYMBOLS = {
    "grid_coarse": ("coarse_stage_kernel",),
    "grid_prestage": ("coarse_stage_kernel<4, true",),
    "grid_refine": ("refine_kernel",), "grid_planes": ("planes_kernel",),
    "grid_satd": ("gather_kernel", "satd_cost_kernel"),
    "nnfme_mlp": ("nnfme_mlp_kernel",), "grid_intra16": ("intra16_kernel",),
    "grid_deblock": ("grid_deblock_kernel",),
    "grid_sao": ("sao_stats_kernel", "sao_decide_kernel",
                 "sao_apply_kernel"),
    "intra_bank": ("intra_bank_rows",),
    "satd35_topk": ("satd35_topk_kernel",),
    "intra_txq": ("intra_txq_tus",),
    "tu_bits": ("tu_bits_teams",),
    "sad_search": ("sad_search_kernel",), "mc_blk": ("mc_blk_jobs", "mc_blk_kernel"),
    "txq": ("txq_kernel",), "b_me": ("b_me_kernel",),
    "b_pred": ("b_pred_kernel",), "b_txq": ("b_txq_kernel",),
    "grid_wp_me": ("wp_me_runs", "wp_me_kernel"), "grid_subpel": ("subpel_kernel",),
    "grid_stats": ("stats_kernel",), "intra_wave": ("intra_wave_kernel",),
    "stripe_prescreen": ("stripe_prescreen_runs", "stripe_prescreen_kernel")}
# the grid step's kernels, and the intra decision's (every picture of
# `intra`; only the IDR of `ldp`, whose P pictures take the grid step):
# printed even where an encode launched none
STEP_KERNELS = ("grid_coarse", "grid_prestage", "grid_refine",
                "grid_planes", "grid_satd", "nnfme_mlp", "grid_intra16",
                "grid_deblock", "grid_sao")
IDR_KERNELS = ("intra_bank", "satd35_topk", "intra_txq", "tu_bits")


def _is_kernel(key: str, keys) -> bool:
    """Whether the profiler's name `key` is one of the kernels `keys`."""
    return any((f"::{k}" in key) if "<" in k
               else (f"::{k}<" in key or f"::{k}(" in key) for k in keys)


def pred_split(cfg, nn_by_qp, clip, dev, gpu: str, reps: int = 5) -> None:
    """`step`: the device time and launches a picture of each kernel of
    STEP_KERNELS and the count of every launch of the step, from `reps`
    pictures under torch.profiler; then K2's device time at each of its
    calls (the classes' PU counts), replayed under torch.profiler."""
    from .codec import inter_grid

    step, carry, fu8, tabs = step_inputs(cfg, nn_by_qp, clip, dev)
    step.frame_step(carry, fu8, step.R, 0, tabs)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step.frame_step(carry, fu8, step.R, 0, tabs)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0]
    total = sum(e.count for e in ev) / reps
    busy = sum(e.self_device_time_total for e in ev) / reps / 1e3
    for name in STEP_KERNELS:
        keys = KERNEL_SYMBOLS[name]
        each = {}  # kernel -> (launches, kernel_ms) a picture
        for e in ev:
            for k in keys:
                if _is_kernel(e.key, (k,)):
                    n0, t0 = each.get(k, (0, 0.0))
                    each[k] = (n0 + e.count / reps,
                               t0 + e.self_device_time_total / reps / 1e3)
        ms = sum(t for _, t in each.values())
        n = sum(c for c, _ in each.values())
        each = {k: (c, round(t, 5)) for k, (c, t) in each.items()}
        print(f"step {step.W}x{step.H}: {name} kernel_ms {ms:.5f} a picture "
              f"in {n:g} launches {each} (launches, kernel_ms) | {gpu}",
              flush=True)
    print(f"step {step.W}x{step.H}: every device operation of the step: "
          f"{total:g} a picture (kernels, copies, fills), device busy "
          f"{busy:.4f} ms a picture | {gpu}", flush=True)
    # K2's entry in the grid step: the classes in one call (a call a class
    # on the parents of this tree)
    k2 = ("nn_refine_classes" if hasattr(inter_grid, "nn_refine_classes")
          else "nn_refine")
    calls, nn = [], getattr(inter_grid, k2)

    def recorded(*a):
        calls.append(a)
        return nn(*a)

    setattr(inter_grid, k2, recorded)
    try:
        step.frame_step(carry, fu8, step.R, 0, tabs)
        torch.cuda.synchronize()
    finally:
        setattr(inter_grid, k2, nn)
    each = [([p[0].shape[0] for p in a[1]] if k2 == "nn_refine_classes"
             else a[1].shape[0],
             round(kernel_ms(lambda a=a: nn(*a), "nnfme_mlp_kernel"), 5))
            for a in calls]
    print(f"step {step.W}x{step.H}: K2 (nnfme_mlp_kernel) at each call of "
          f"a picture: {each} (PUs of each class, kernel_ms) | {gpu}",
          flush=True)


def time_step(cfg, nn_by_qp, clip, dev, reps: int, gpu: str) -> None:
    """`step`: the grid step's median event and host ms a picture."""
    step, carry, fu8, tabs = step_inputs(cfg, nn_by_qp, clip, dev)
    R, W, H = step.R, step.W, step.H
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


def device_ms(fn, n: int = DEVICE_LAUNCHES, warmup: int = 5,
              tries: int = 3) -> float:
    """A launch's device time: CUDA events around n back-to-back calls of
    fn, over n, after a warm-up. The calls queue behind a device sleep, so
    the host's time to issue them is hidden and the events time the
    device. Where issuing them took longer than the sleep, the sleep
    grows past twice the issue time and the calls are timed again; raises
    if that fails `tries` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(tries):
        s0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        slept = s0.elapsed_time(a)
        if host < slept:
            return a.elapsed_time(b) / n
        cycles = int(cycles * (2 * host / slept + 1))
    raise RuntimeError(f"device_ms: issuing {n} calls took {host:.1f} ms, "
                       f"longer than the {slept:.1f} ms sleep, {tries} times")


def kernel_ms(fn, name: str, reps: int = 5, tries: int = 3) -> float:
    """The device time of the kernels whose name holds `name` in one call
    of fn: the sum of their durations under torch.profiler over reps
    calls, over reps, after a warm-up call. A trace that holds no device
    event of them (seen now and then in a process that has traced
    before) is taken again, at most `tries` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if name in e.key
                 and e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    raise RuntimeError(f"kernel_ms: no device time for {name!r}")


def fme_dataset():
    """Path 8's extraction, on the host: (sads, heights, widths, labels,
    seconds)."""
    from .models.fme_data import extract

    frames = _Clip(TRAIN_W, TRAIN_H, TRAIN_FRAMES).frames
    t0 = time.time()
    sads, dims, labels = extract(frames, TRAIN_QP, TRAIN_SR)
    secs = time.time() - t0
    return (sads.astype(np.float32), dims[:, 1], dims[:, 0], labels, secs)


def train_inputs(dev, ds, steps: int = TRAIN_STEPS_CHECKED) -> dict:
    """train_fme's start on dev: the data (normalised as train_fme does),
    the initial weights and state, `steps` batches (the first epochs'
    order) and their dropout uniforms."""
    from .models.fme_train import epoch_batches, prepare
    from .models.nnfme import (STATE_SHAPES, TRAIN_SHAPES, TrainConfig,
                               flatten_np, height_category_np, init_bn_state,
                               width_category_np)
    from .ops import fme_train as ft

    sads, heights, widths, labels, _ = ds
    cfg = TrainConfig()
    rng, tr, _, _, _, xs, params = prepare(sads, cfg)
    rows = []
    while len(rows) < steps:
        rows += list(epoch_batches(tr, rng.permutation(len(tr)),
                                   cfg.batch_size))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    return dict(
        cfg=cfg,
        flat=torch.as_tensor(flatten_np(params, TRAIN_SHAPES), device=dev),
        state=torch.as_tensor(flatten_np(init_bn_state(), STATE_SHAPES),
                              device=dev),
        data=ft.FmeData.from_numpy(xs, height_category_np(heights),
                                   width_category_np(widths), labels, dev),
        rows=torch.as_tensor(np.stack(rows[:steps]), device=dev),
        unif=torch.rand((steps, cfg.batch_size, ft.UNIF_COLS), generator=gen,
                        device=dev))


def profile_train(args, dev, gpu: str) -> None:
    """`train`: train_fme timed and profiled, and the kernels' device_ms."""
    from .models.fme_train import train_fme
    from .models.nnfme import TrainConfig
    from .ops import fme_train as ft

    ds = fme_dataset()
    sads, heights, widths, labels, ext = ds
    print(f"train: extracted {len(labels)} samples ({TRAIN_W}x{TRAIN_H} x "
          f"{TRAIN_FRAMES}, QP {TRAIN_QP}, SR {TRAIN_SR}) in {ext:.3f} s of "
          f"host", flush=True)
    cfg = TrainConfig()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = []
        train_fme(sads, labels, heights, widths, cfg, device=dev,
                  history=hist)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, hist

    run()
    secs = [run()[0] for _ in range(args.reps or 3)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, hist = run()
    stats = prof.key_averages()
    dev_us = {e.key: (e.self_device_time_total, e.count) for e in stats
              if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(us for us, _ in dev_us.values()) / 1e6
    print(f"train: train_fme {cfg.epochs} epochs of batch {cfg.batch_size}, "
          f"warm runs {[round(x, 4) for x in secs]} s; profiled run "
          f"{wall:.4f} s: device busy {busy * 1e3:.3f} ms, idle "
          f"{100 * (1 - busy / wall):.2f}% | epoch loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f} | {gpu}", flush=True)
    for key, (us, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  device {us / 1e3:9.3f} ms  calls {n:5d}  "
              f"{us / max(n, 1):8.3f} us a call  {key[:90]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    t = train_inputs(dev, ds)
    one = torch.ones((), device=dev)
    a = (t["data"], t["rows"][0], t["unif"][0], cfg.dropouts)
    out = ft.fme_train_fwd(t["flat"], t["state"], *a, cfg.bn_momentum)
    g = ft.fme_train_bwd(t["flat"], *a, out.saved, out.stats, one)
    flat, opt = t["flat"].clone(), ft.AdamState.zeros(g.shape[0], dev)
    ms = {"fme_train_fwd": device_ms(lambda: ft.fme_train_fwd(
              t["flat"], t["state"], *a, cfg.bn_momentum)),
          "fme_train_bwd": device_ms(lambda: ft.fme_train_bwd(
              t["flat"], *a, out.saved, out.stats, one)),
          "fme_adam": device_ms(lambda: ft.fme_adam(flat, g, opt, cfg.lr))}
    print(f"train: device_ms at B {cfg.batch_size} (events around "
          f"{DEVICE_LAUNCHES} launches): "
          f"{ {k: round(v, 5) for k, v in ms.items()} }; the backward's "
          f"launch {ft.bwd_geometry(dev)} | {gpu}", flush=True)


def profile_stripes(args, dev, gpu: str) -> None:
    """`stripes`: the multi-device path's stripe kernels on a mesh of 3 x
    the card, their device time and launches a call."""
    from .codec.inter_grid import GridStep
    from .codec.params import p_frame_lambda
    from .config.options import build_config, parse_args
    from .ops.grid_me import grid_coarse, tile_sum
    from .parallel import mesh

    frames = _Clip(args.width, args.height, 2).frames
    oy = torch.as_tensor(frames[1][0].astype(np.int32), device=dev)
    ry = torch.as_tensor(frames[0][0].astype(np.int32), device=dev)
    cfg, _ = build_config(parse_args([
        "-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
        "-wdt", str(args.width), "-hgt", str(args.height), "-f", "2",
        "-q", "32"]))
    step = GridStep(cfg, {}, dev)
    qp = step.qps[0]
    lam_me = int(round(np.sqrt(p_frame_lambda(cfg, 0, qp)) * 256))
    s16, sum16 = grid_coarse(tile_sum(oy, 2).int(), step._pad_edge(
        tile_sum(ry, 2).int(), step.R2), step.nc, 8, 1, True)
    cx, cy = step.pick_coarse(s16, sum16, qp, lam_me, args.height // 16,
                              args.width // 16, 1)
    pre = mesh.tile_prescreen(mesh.make_mesh(3, device=dev), *oy.shape)
    refine = mesh.stripe_refine(cfg, {}, mesh.make_mesh(3, device=dev))[0]
    reps = args.reps or 20
    for what, fn, keys in (
            ("tile_prescreen", lambda: pre(oy),
             KERNEL_SYMBOLS["stripe_prescreen"]),
            ("stripe_refine", lambda: refine(oy, ry, cx.contiguous(),
                                             cy.contiguous()),
             ("refine_kernel",))):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hit = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and _is_kernel(e.key, keys)]
        ms = sum(e.self_device_time_total for e in hit) / reps / 1e3
        n = sum(e.count for e in hit) / reps
        print(f"stripes {args.width}x{args.height} in 3: {what} "
              f"({keys[0]}) device {ms:.5f} ms a call in {n:g} launches "
              f"({reps} calls) | {gpu}", flush=True)


def b_split(encode, gpu: str, reps: int = 10) -> None:
    """`ra`: kernels b_pred and b_txq on the B step's calls of one more
    encode, recorded from `codec/inter_b.py` and replayed: `device_ms` of
    all the calls as the step makes them (on this tree a launch a B
    picture, on a parent tree without `b_pred_yuv` and `b_txq_planes` a
    launch a plane: luma, U and V in turn), then of each plane's class
    alone through the one-plane entries."""
    from .codec import inter_b
    from .ops import interp, txq

    fused = hasattr(inter_b, "b_pred_yuv")
    names = ("b_pred_yuv", "b_txq_planes") if fused else ("b_pred", "b_txq")
    calls = {k: [] for k in names}
    saved = {k: getattr(inter_b, k) for k in names}

    def recorder(k):
        def rec(*a, **kw):
            calls[k].append((a, kw))
            return saved[k](*a, **kw)
        return rec

    for k in names:
        setattr(inter_b, k, recorder(k))
    try:
        encode()
    finally:
        for k in names:
            setattr(inter_b, k, saved[k])
    pred, code = (calls[k] for k in names)
    if fused:
        runs = {"b_pred": [(interp.b_pred_yuv, a, k) for a, k in pred],
                "b_txq": [(txq.b_txq_planes, a, k) for a, k in code]}
        classes = {n: [[], [], []] for n in runs}
        for (cur, ry, ru, rv, xs, ys, m0, m1, lam), _ in pred:
            dirs = interp.b_pred_yuv(cur, ry, ru, rv, xs, ys, m0, m1, lam)[1]
            cx, cy = xs // 2, ys // 2
            classes["b_pred"][0].append(
                (interp.b_pred, (cur, *ry, xs, ys, m0, m1, 16, True, lam), {}))
            for i, r in ((1, ru), (2, rv)):
                classes["b_pred"][i].append(
                    (interp.b_pred, (None, *r, cx, cy, m0, m1, 8, False),
                     {"inter_dir": dirs}))
        for (planes, lam), _ in code:
            for i, (c, p, q, e) in enumerate(planes):
                classes["b_txq"][i].append((txq.b_txq, (c, p, q, lam, e), {}))
    else:  # a call a plane: luma, U, V in turn
        runs = {"b_pred": [(interp.b_pred, a, k) for a, k in pred],
                "b_txq": [(txq.b_txq, a, k) for a, k in code]}
        classes = {n: [runs[n][i::3] for i in range(3)] for n in runs}
    for name, run in runs.items():
        every = device_ms(lambda: [f(*a, **k) for f, a, k in run], n=reps)
        alone = [round(device_ms(lambda c=c: [f(*a, **k) for f, a, k in c],
                                 n=reps), 5) for c in classes[name]]
        print(f"ra: {name} on the B step's {len(run)} calls of an encode: "
              f"device_ms {every:.5f}; each plane's class alone (luma, U, "
              f"V; {len(classes[name][0])} calls each): {alone} (events "
              f"around {reps} replays queued behind a device sleep, over "
              f"{reps}) | {gpu}", flush=True)


def main(argv=None) -> int:
    from .codec.encoder import encode_sequence
    from .config.options import build_config, parse_args
    from .device import require_cuda
    from .models.nnfme import random_params, save_npz

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=sorted(CFGS) + ["stripes", "train"],
                    default="ra")
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
    if args.path == "train":
        profile_train(args, dev, gpu)
        return 0
    if args.path == "stripes":
        profile_stripes(args, dev, gpu)
        return 0
    clip = _Clip(args.width, args.height, frames, args.path == "fwp")
    cfg_file, extra = CFGS[args.path]
    if args.path == "step":
        frames = max(frames, 5)
        reps = args.reps or 20
        clip = _Clip(args.width, args.height, frames)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "nnfme_seeded.npz")
        save_npz(npz, {32: random_params(0)})
        if args.path == "step":
            def step_cfg(extra=()):
                cfg, _ = build_config(parse_args([
                    "-c", os.path.join(ROOT, "cfg", cfg_file),
                    "-wdt", str(args.width), "-hgt", str(args.height),
                    "-f", str(frames), "-q", "32", f"--NNWeightsDir={npz}"]
                    + list(extra)))
                qps = {min(max(cfg.qp + o, 0), 51)
                       for o in cfg.gop_qp_offsets}
                return cfg, {q: random_params(0) for q in qps}

            time_step(*step_cfg(), clip, dev, reps, gpu)
            pred_split(*step_cfg(), clip, dev, gpu)
            code_split(*step_cfg(), clip, dev, gpu, "the anchor's tools")
            code_split(*step_cfg(STEP_CUT), clip, dev, gpu,
                       "RDOQ, sign hiding, deblocking and SAO cut")
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
        for name, keys in KERNEL_SYMBOLS.items():
            hit = [e for e in stats if e.key in dev_us
                   and _is_kernel(e.key, keys)]
            if not hit and name not in STEP_KERNELS + IDR_KERNELS:
                continue
            ms = sum(dev_us[e.key] for e in hit) / 1e3
            # a row of several kernels (grid_sao: stats, decision, apply)
            # also by kernel
            each = {k: (sum(e.count for e in hit if _is_kernel(e.key, (k,))),
                        round(sum(dev_us[e.key] for e in hit
                                  if _is_kernel(e.key, (k,))) / 1e3, 5))
                    for k in keys} if len(keys) > 1 else ""
            print(f"  {name}: device {ms:.5f} ms in "
                  f"{sum(e.count for e in hit)} launches over the profiled "
                  f"encode {each}")
        if args.path == "ra":
            b_split(encode, gpu)
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                        exist_ok=True)
            prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
