"""The multi-device steps of the graft entry's `dryrun_multichip`
(`__graft_entry__.py:26-240`) through the port, at the same shapes.

    python -m tpuhevc_torch.parallel.dryrun --devices 2 --device cuda

- step "2": `tile_prescreen` of a 64n x 128 plane over an n-device mesh,
  equal to the one-device prescreen off the stripes' last block rows;
- step "2b": `stripe_refine` at 64 x 48n (48-row stripes over the 40-row
  halo of SearchRange 16), the sharded result equal to the single one;
- step "2c": `sharded_frame_step` at the graft entry's shapes (128x128,
  two references, SearchRange 16, deblocking, FmeMode none; random
  planes) in min(n, 2) stripes (128 rows hold two 64-row CTU rows): the
  sharded packed row and carry equal the single ones; prints the halo
  bytes of the step and both wall times on the mesh (on one card the
  stripes run in turn: no scaling figure);
- step "3": `encode_segments_parallel` of 2 min(n, 2) random 64x32
  pictures in min(n, 2) segments, whose stream decodes hash-OK.

Step "1" is not ported: asking for it raises NotImplementedError (ROADMAP
queue 1, item 1). It is the data-parallel NN-FME train step: the one-device step runs on the
card (`models/fme_train.py`, kernels `fme_train_fwd`/`fme_train_bwd`/
`fme_adam`); what is left is a batch split across devices whose three
BatchNorm layers take global batch statistics, a cross-device reduction
in each forward and backward, equal to the one-device step.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..codec.decoder import decode_stream
from ..codec.params import EncoderConfig, SeqParams
from ..device import on_device
from .mesh import (Mesh, make_mesh, sharded_frame_step, stripe_refine,
                   tile_prescreen)
from .segments import encode_segments_parallel

STEPS = ("2", "2b", "2c", "3")
NOT_PORTED = {"1": "the data-parallel NN-FME train step (global BatchNorm "
                   "statistics by a cross-device reduction in each BN layer, "
                   "forward and backward; the one-device step is "
                   "models.fme_train; ROADMAP queue 1, item 1)"}


def dryrun_multichip(n_devices: int, device="cuda", steps=STEPS) -> dict:
    """Run the named steps over an n-device mesh on `device` ("cpu": n x
    cpu; "cuda": the cards in turn, n x cuda:0 on one card); raises on a
    failed check. Returns {step: summary}."""
    for s in steps:
        if s in NOT_PORTED:
            raise NotImplementedError(f"dryrun step {s}: {NOT_PORTED[s]} is "
                                      "not ported")
        if s not in STEPS:
            raise ValueError(f"dryrun: no step {s!r}")
    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    out = {}

    def plane(h, w):
        return torch.as_tensor(rng.integers(0, 256, (h, w)),
                               dtype=torch.int32, device=dev)

    if "2" in steps:
        h, w = 8 * 8 * n_devices, 128
        p = plane(h, w)
        modes, costs = tile_prescreen(mesh, h, w)(p)
        if tuple(modes.shape) != (h // 8, w // 8) or not bool(
                ((modes >= 0) & (modes < 35) & (costs >= 0)).all()):
            raise RuntimeError("dryrun step 2: prescreen out of range")
        # off each stripe's last block row, whose left samples the stripe
        # clamps, the stripes equal the prescreen of the whole plane
        whole = tile_prescreen(make_mesh(1, device=dev), h, w)(p)
        inner = torch.arange(h // 8, device=dev) % 8 != 7
        inner[-1] = True
        if not all(torch.equal(a[inner], b[inner])
                   for a, b in zip((modes, costs), whole)):
            raise RuntimeError("dryrun step 2: the stripes differ from the "
                               "whole plane off their last block rows")
        out["2"] = (f"prescreen {w}x{h}: {modes.numel()} blocks, == the "
                    "whole plane off the stripes' last block rows")
    if "2b" in steps:
        w2, h2 = 64, 48 * n_devices
        cfg = EncoderConfig(sps=SeqParams(width=w2, height=h2,
                                          max_tu_depth_intra=0),
                            qp=32, intra_period=-1, fme_mode="none",
                            num_ref_frames=1, search_range=16)
        sharded, single, halo = stripe_refine(cfg, {32: None}, mesh)
        oy, ry = plane(h2, w2), plane(h2, w2)
        z16 = torch.zeros((h2 // 16, w2 // 16), dtype=torch.int32,
                          device=dev)
        got, want = sharded(oy, ry, z16, z16), single(oy, ry, z16, z16)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("dryrun step 2b: sharded refine differs from "
                               "the single one")
        out["2b"] = f"stripe refine {w2}x{h2}, halo {halo}: equal"
    if "2c" in steps:
        wf = hf = 128
        cfg = EncoderConfig(sps=SeqParams(width=wf, height=hf,
                                          max_tu_depth_intra=0),
                            qp=32, intra_period=-1, fme_mode="none",
                            num_ref_frames=2, search_range=16,
                            deblocking=True)
        mesh_c = Mesh(mesh.devices[: min(n_devices, hf // 64)])
        sharded, single, meta = sharded_frame_step(cfg, {32: None}, mesh_c)
        R, hc = meta["R"], meta["Hc"]
        ry = torch.stack([plane(hf, wf) for _ in range(R)])
        ruv = torch.stack([plane(hc, wf) for _ in range(R)])
        carry = meta["step"].carry0(ry, ruv)
        fu8 = plane(hf * wf * 3 // 2, 1).reshape(-1).to(torch.uint8)
        parts = meta["split"](carry)
        ex = meta["exchange"]
        times = []
        for fn, c in ((single, carry), (sharded, parts)):
            with on_device(dev):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(c, fu8, R, 0)
                if dev.type == "cuda":
                    for d in set(mesh_c.devices):
                        torch.cuda.synchronize(d)
                times.append(time.perf_counter() - t0)
            if fn is single:
                want = got
        if not (torch.equal(got[1], want[1]) and all(
                torch.equal(a, b) for a, b in zip(meta["join"](got[0]),
                                                  want[0]))):
            raise RuntimeError("dryrun step 2c: the sharded frame step "
                               "differs from the single one")
        out["2c"] = (f"sharded frame step {wf}x{hf} in {mesh_c.size} "
                     f"stripes == single ({got[1].numel()} bytes); halo "
                     f"{ex.halo_bytes} bytes, fields "
                     f"{ex.field_bytes} bytes a step; wall single "
                     f"{times[0] * 1e3:.1f} ms, sharded {times[1] * 1e3:.1f}"
                     f" ms (first calls; stripes that share a device run in "
                     f"turn)")
    if "3" in steps:
        wf, hf = 64, 32
        nseg = min(n_devices, 2)
        frames = [tuple(rng.integers(0, 256, s, dtype=np.uint8)
                        for s in ((hf, wf), (hf // 2, wf // 2),
                                  (hf // 2, wf // 2)))
                  for _ in range(2 * nseg)]
        cfg = EncoderConfig(sps=SeqParams(width=wf, height=hf,
                                          max_tu_depth_intra=0),
                            qp=32, intra_period=-1, fme_mode="none")
        bs, results = encode_segments_parallel(frames, cfg, nseg,
                                               mesh.devices)
        dec = decode_stream(bs)
        if len(results) != len(frames) or len(dec) != len(frames) or not all(
                f.md5_ok for f in dec):
            raise RuntimeError("dryrun step 3: the stitched stream does not "
                               "decode hash-OK")
        out["3"] = (f"segments {wf}x{hf} x {len(frames)} in {nseg}: "
                    f"{len(bs)} bytes, hash OK")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for step, what in dryrun_multichip(a.devices, a.device).items():
        print(f"step {step}: {what}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
