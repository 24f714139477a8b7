"""Where a wave of kernel `intra_wave` spends its time, on the card.

    python -m tpuhevc_torch.profile_wave [--width 416 --height 240
        --frames 3 --bit-depth 8]

Builds `kernels/csrc/intra_wave.cu` as it is and three variants with
phases cut out of each wave (`no_cost`: no 35-mode costs, phase 2, so
every cell takes mode 0; `refs_only`: the slots, prefetches and phase 1,
the references, filtered references, DC values and MPM list; `empty`: the
slots, prefetches and barriers alone) into
`build/tpuhevc_torch/variants/`, runs each on the same frames of the
synthetic clip of `tools/make_test_clip.py` (seed 7) at QP 32, and
prints the variant of the kernel that ran (recon on chip or in device
memory), the median CUDA-event time of 7 launches, and per wave (the
dependency depth), with the card's name and power limit. The full
kernel must equal its plain version; the variants compute something else
and are only timed. The differences between rows are the phases' shares
of a wave. At --bit-depth 10 the clip's samples are x 4 plus 2, 1, 3 (the
10-bit clip of `chip_smoke.py`) and the kernel's 10-bit variant runs.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

# (variant, [(first line of a cut, first line after it)]) of intra_wave.cu
P1 = ("        // phase 1:", "        // end of phase 1")
P2 = ("        // phase 2:", "        // end of phase 2")
P3 = ("        // phase 3:", "        // end of phase 3")
CUTS = {"no_cost": [P2], "refs_only": [P2, P3], "empty": [P1, P2, P3]}


def _cut(src: str, cuts) -> str:
    for start, end in cuts:
        a = src.index(start)
        src = src[:a] + src[src.index(end, a):]
    return src


def _build_variants() -> dict:
    """{name: ctypes library} of the kernel as it is and its variants."""
    from .kernels import build as kbuild

    with open(os.path.join(kbuild.CSRC, "intra_wave.cu")) as f:
        src = f.read()
    out_dir = os.path.join(kbuild.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in CUTS.items():
        cu = os.path.join(out_dir, f"intra_wave_{name}.cu")
        with open(cu, "w") as f:
            f.write(_cut(src, cuts))
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [kbuild.nvcc()] + kbuild.FLAGS + ["-I", kbuild.CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {"full": kbuild.library("intra_wave")}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main(argv=None) -> int:
    from .codec.intra_frame import _sqlam_fp, wave_tables
    from .codec.params import EncoderConfig, SeqParams
    from .device import require_cuda
    from .kernels import build as kbuild
    from .ops import intra_wave as iw
    from .profile_path import _Clip, gpu_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--cluster", type=int, choices=(1, 4), default=None,
                    help="blocks a frame where the recon is on chip "
                         "(default the wrapper's choice)")
    ap.add_argument("--bit-depth", type=int, choices=(8, 10), default=8)
    args = ap.parse_args(argv)
    dev = require_cuda()
    gpu = gpu_line()
    w, h, n, bd = args.width, args.height, args.frames, args.bit_depth
    cfg = EncoderConfig(sps=SeqParams(width=w, height=h, bit_depth=bd),
                        qp=32, intra_period=1, intra_qt=False)
    clip = _Clip(w, h, n).frames
    if bd == 10:
        clip = [[p.astype(np.int32) * 4 + o for p, o in zip(f, (2, 1, 3))]
                for f in clip]
    planes = [torch.as_tensor(np.stack([f[i] for f in clip]).astype(np.int32),
                              device=dev) for i in range(3)]
    geo = wave_tables(w, h, cfg.sps.log2_ctu, dev)
    steps, bmax = geo.slots.shape
    on_chip, cluster, smem = iw.wave_variant(w, h, steps, bmax, bd)
    if on_chip and args.cluster:
        cluster = args.cluster
    ref = iw.intra_wave_plain(*planes, geo, cfg.qp, _sqlam_fp(cfg),
                              bit_depth=bd)
    libs = _build_variants()
    init_args = iw.table_arrays()
    for name, lib in libs.items():
        init = lib.tpuhevc_intra_wave_init
        init.argtypes = [kbuild.P] * 4
        kbuild.check(init(*(a.ctypes.data_as(ctypes.c_void_p)
                            for a in init_args)), f"{name} init")
        fn = lib.tpuhevc_intra_wave
        fn.argtypes = iw.ARGS
        outs = [torch.zeros_like(r) for r in ref]

        def run():
            kbuild.check(iw.launch(fn, planes, geo, outs, cfg.qp,
                                   _sqlam_fp(cfg), on_chip, cluster, bd),
                         name)

        run()
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(outs, ref))
        if name == "full" and not exact:
            raise RuntimeError("intra_wave differs from its plain version")
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = statistics.median(times)
        print(f"intra_wave {name:9s} {w}x{h} x {n} at {bd} bits (recon "
              f"{'on chip' if on_chip else 'in device memory'}, {smem} bytes "
              f"of shared memory, {cluster} blocks a frame): {ms:.4f} ms a "
              f"launch, "
              f"{ms / steps * 1e3:.2f} us a wave ({steps} waves)"
              f"{' (equal to the plain version)' if exact else ''} | {gpu}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
