"""Shared inputs of the tests that hold tpuhevc_torch against tpuhevc.

Not a test module: seeded clips and planes (numpy), seeded NN-FME weights
written with `tpuhevc.models.nnfme.save_npz`, the slice's LD-P config (as
tpuhevc's EncoderConfig, or with port=True as the port's own, from the
same fields), `fresh_grid` (tpuhevc's grid builders with its build
cache emptied around them), and the `cuda_device` fixture that skips a
test where PyTorch sees no GPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tools.make_test_clip import make_clip
from tpuhevc.codec import params as jax_params
from tpuhevc.models import nnfme
from tpuhevc_torch.codec import params as port_params
from tpuhevc_torch.models.nnfme import random_params

# One intra-op thread: the port's plain versions work on small tensors,
# where torch's thread pool costs more than it saves, and the tests run
# beside other test processes, whose cores those threads would take.
torch.set_num_threads(1)

W, H = 112, 72  # not 16-aligned: JAX takes build_ldp_scan; all 4 CU classes
GOP_QP_OFFSETS = (3, 2, 3, 1)  # the anchor LD-P cfg's GOP table
QP = 32


def clip_frames(w: int, h: int, n: int, seed: int = 7) -> list:
    """n (y, u, v) uint8 frames of tools.make_test_clip's seeded clip."""
    raw = make_clip(w, h, n, seed=seed)
    fsz = w * h * 3 // 2
    out = []
    for i in range(n):
        b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], dtype=np.uint8)
        out.append((b[: w * h].reshape(h, w),
                    b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                    b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))
    return out


def clip10(w: int, h: int, n: int) -> list:
    """n (y, u, v) uint16 frames: the seeded 8-bit clip x 4 plus 2, 1, 3
    (tests/test_main10.py's `_clip10`), samples up to 1023."""
    return [tuple(np.clip(p.astype(np.uint16) * 4 + o, 0, 1023)
                  for p, o in zip(f, (2, 1, 3)))
            for f in clip_frames(w, h, n)]


class Reader:
    def __init__(self, frames):
        self.frames = frames

    def read_frame(self, i):
        return self.frames[i] if i < len(self.frames) else None


def write_weights(path, qp: int = QP, seed: int = 0) -> str:
    """Seeded NN-FME weights for `qp` as an npz; returns the path."""
    nnfme.save_npz(str(path), {qp: random_params(seed)})
    return str(path)


def ldp_cfg(npz: str | None, w: int = W, h: int = H, backend: str = "jax",
            port: bool = False, **kw):
    """The slice: LD-P, NN-FME, RDOQ/SBH/deblocking/SAO off; tpuhevc's
    EncoderConfig on `backend`, or the port's with port=True (the port
    has one backend: the device)."""
    mod = port_params if port else jax_params
    args = dict(qp=QP, intra_period=-1, fme_mode="nn", nn_weights_dir=npz,
                gop_qp_offsets=GOP_QP_OFFSETS)
    if not port:
        args["inter_backend"] = backend
    args.update(kw)
    return mod.EncoderConfig(sps=mod.SeqParams(width=w, height=h), **args)


def rng_planes(seed: int, h: int, w: int, n: int = 1) -> np.ndarray:
    """Smooth-plus-noise 8-bit planes (n, h, w) int32 that give SAD
    surfaces and residuals of a natural spread."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for _ in range(n):
        f = rng.uniform(5, 40, 4)
        base = (128 + 50 * np.sin(xx / f[0] + yy / f[1])
                + 40 * np.cos(yy / f[2] - xx / f[3])
                + rng.normal(0, 6, (h, w)))
        out.append(np.clip(np.rint(base), 0, 255).astype(np.int32))
    return np.stack(out)


def parse_meta(cfg, row: np.ndarray) -> dict:
    """{class tag: (mvq, mv_int, sad9, cbf)} of one packed frame row, at the
    offsets `tpuhevc.codec.inter_batch.collect_frame` reads them."""
    from tpuhevc.codec.inter_batch import _positions

    w, h = cfg.sps.coded_width, cfg.sps.coded_height
    off = w * h * 2 + 2 * (w * h // 2) + w * h + 2 * (w * h // 4)
    out = {}
    for tag, poss, _ in _positions(cfg)[1]:
        n = len(poss)
        parts = []
        for nbytes, dt, shape in ((n * 4, np.int16, (n, 2)),
                                  (n * 4, np.int16, (n, 2)),
                                  (n * 36, np.int32, (n, 9)),
                                  (n, np.uint8, (n,))):
            parts.append(np.frombuffer(row[off : off + nbytes].tobytes(),
                                       dtype=dt).reshape(shape))
            off += nbytes
        out[tag] = tuple(parts)
    return out


def fresh_grid(fn, *args, **kw):
    """fn(*args, **kw) -- tpuhevc's `inter_grid.build_ldp_grid_scan`,
    `parallel.mesh.stripe_refine` or `sharded_frame_step`, or an encode
    that builds a grid -- with `inter_grid._BUILD_CACHE` emptied before
    and after. Returns (fn's result, a copy of `inter_grid._PROBES` as
    the call left them).

    tpuhevc registers the probes only when it builds, not on a cache hit,
    and its mesh functions read them after a build. Emptied before, the
    call builds and registers its own probes; emptied after, no later
    caller in the process hits an entry whose probes another build has
    replaced."""
    from tpuhevc.codec import inter_grid as jg

    jg._BUILD_CACHE.clear()
    try:
        out = fn(*args, **kw)
        probes = dict(jg._PROBES)
    finally:
        jg._BUILD_CACHE.clear()
    return out, probes


# the adversarial inputs of grid_deblock (`deblock_inputs`)
DEBLOCK_KINDS = ("steps", "noise", "intra", "rqt2", "farmv")


def deblock_inputs(kind: str, h: int, w: int, seed: int = 0):
    """Seeded inputs of `grid_deblock` at h x w, as the grid step gives
    them: (rec_y (h, w), rec_uv (h/2, w) [U | V] int32 8-bit planes; per
    8x8 cell log2 (CU) int8, mv (h8, w8, 2) int32 stored as (2, h8, w8)
    planes, ref int32, cbf bool, intra bool, tsplit (RQT depth) int8).

    A CU quadtree from 64x64 split at random (forced where a CU would
    cross the edge), an RQT depth, motion, reference and intra flag a CU
    with a PU's own motion in some cells, a cbf a cell. `kind`: `steps`
    flat 8x8 blocks 0-2 apart with every cbf set (the strong filter at
    every edge with bs > 0 from QP 18); `noise` 8x8 block offsets with
    sample noise (weak filters, one-sided and none); `intra` every cell
    intra; `rqt2` every CU 32x32 at RQT depth 2 (8x8 TUs); `farmv`
    motion and reference drawn a cell (bs 1 at nearly every edge)."""
    rng = np.random.default_rng(seed)
    h8, w8 = h // 8, w // 8
    log2 = np.zeros((h8, w8), np.int8)
    tsplit = np.zeros((h8, w8), np.int8)
    mv = np.zeros((h8, w8, 2), np.int32)
    ref = np.zeros((h8, w8), np.int32)
    intra = np.zeros((h8, w8), bool)

    def cu(y, x, lg):
        n = 1 << (lg - 3)
        fits = y + n <= h8 and x + n <= w8
        want = 5 if kind == "rqt2" else 3
        if lg > 3 and (not fits or lg > want and (
                kind == "rqt2" or rng.random() < 0.5)):
            for dy in (0, n // 2):
                for dx in (0, n // 2):
                    if y + dy < h8 and x + dx < w8:
                        cu(y + dy, x + dx, lg - 1)
            return
        sl = np.s_[y : y + n, x : x + n]
        log2[sl] = lg
        tsplit[sl] = (2 if kind == "rqt2" and lg == 5
                      else rng.integers(0, min(lg, 5) - 2))
        mv[sl] = rng.integers(-12, 13, 2)
        ref[sl] = rng.integers(0, 4)
        intra[sl] = kind == "intra" or rng.random() < 0.15

    for y in range(0, h8, 8):
        for x in range(0, w8, 8):
            cu(y, x, 6)
    pu = rng.random((h8, w8)) < 0.2  # a PU's own motion
    mv[pu] = rng.integers(-12, 13, (int(pu.sum()), 2))
    if kind == "farmv":
        mv = rng.integers(-256, 257, (h8, w8, 2)).astype(np.int32)
        ref = rng.integers(0, 4, (h8, w8)).astype(np.int32)
    cbf = rng.random((h8, w8)) < 0.5
    if kind == "steps":
        cbf[:] = True

    def plane(ph, pw):
        if kind == "steps":
            blk = 120 + rng.integers(0, 3, (ph // 8 + 1, pw // 8 + 1))
            return np.kron(blk, np.ones((8, 8), np.int64))[:ph, :pw]
        if kind == "noise":
            blk = rng.integers(-10, 11, (ph // 8 + 1, pw // 8 + 1))
            off = np.kron(blk, np.ones((8, 8), np.int64))[:ph, :pw]
            return 128 + off + rng.integers(-3, 4, (ph, pw))
        return rng_planes(int(rng.integers(1 << 30)), ph, pw)[0]

    planes = [np.clip(plane(ph, w), 0, 255).astype(np.int32)
              for ph in (h, h // 2)]
    mv_t = torch.from_numpy(np.ascontiguousarray(mv.transpose(2, 0, 1)))
    return (torch.from_numpy(planes[0]), torch.from_numpy(planes[1]),
            torch.from_numpy(log2), mv_t.permute(1, 2, 0),
            torch.from_numpy(ref), torch.from_numpy(cbf),
            torch.from_numpy(intra), torch.from_numpy(tsplit))


@pytest.fixture
def cuda_device():
    """torch.device('cuda'); skips the test where there is no GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain on the card)")
    return torch.device("cuda", torch.cuda.current_device())
