"""K3 (DCT-IF block MC) of tpuhevc_torch against tpuhevc.ops.interp.mc
(JAX, CPU; the same semantics as inter_batch.py's mc_blk at 8 bits):
bit-exact for luma 8/16/32 and chroma 4/8/16, with fractional MVs of both
signs and windows clamped at every plane edge. `mc_blk_planes` (a P
picture's classes, Y, U and V, in one launch) equals `mc_blk` job by job
at all six sizes in one job list, with MVs past every plane edge. On a
GPU the kernel meets the plain version, one plane a launch and every job
in one launch."""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc.ops.interp import mc as jax_mc
from tpuhevc_torch.kernels import LAUNCHES
from tpuhevc_torch.ops.interp import (mc_blk, mc_blk_planes,
                                      mc_blk_planes_plain, mc_blk_plain)

CASES = [(8, True), (16, True), (32, True), (4, False), (8, False),
         (16, False)]


def inputs(size, seed, w=112, h=72, n=40):
    rng = np.random.default_rng(seed)
    plane = rng_planes(seed, h, w)[0]
    xs = rng.integers(0, w // size, n).astype(np.int32) * size
    ys = rng.integers(0, h // size, n).astype(np.int32) * size
    mvq = rng.integers(-70, 71, (n, 2)).astype(np.int32)  # both signs, all phases
    return plane, xs, ys, mvq


@pytest.mark.parametrize("size,is_luma", CASES)
def test_mc_blk_matches_jax(size, is_luma):
    import jax.numpy as jnp

    plane, xs, ys, mvq = inputs(size, size + is_luma)
    want = np.asarray(jax_mc(jnp.asarray(plane), jnp.asarray(xs),
                             jnp.asarray(ys), jnp.asarray(mvq), size, is_luma))
    got = mc_blk(torch.from_numpy(plane), torch.from_numpy(xs),
                 torch.from_numpy(ys), torch.from_numpy(mvq), size, is_luma)
    np.testing.assert_array_equal(got.numpy(), want)
    frac = mvq & (3 if is_luma else 7)
    assert (frac[:, 0] != 0).any() and ((mvq < 0) & (frac != 0)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("size,is_luma", CASES)
def test_mc_blk_kernel_matches_plain(cuda_device, size, is_luma):
    plane, xs, ys, mvq = inputs(size, 7, w=416, h=240, n=400)
    args = [torch.from_numpy(a).to(cuda_device) for a in (plane, xs, ys, mvq)]
    got = mc_blk(*args, size, is_luma)
    want = mc_blk_plain(*args, size, is_luma)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def edge_inputs(size, seed, w=112, h=72, n=40):
    """`inputs` plus a PU at each corner whose MVs reach past that
    corner's two plane edges and past the opposite ones, every phase of
    both signs among them."""
    plane, xs, ys, mvq = inputs(size, seed, w, h, n)
    far = 8 * (max(w, h) + 40)  # whole pels of either grid
    ex, ey, em = [], [], []
    for cx, cy in ((0, 0), (w - size, 0), (0, h - size), (w - size, h - size)):
        for sx, sy in ((-1, -1), (1, 1), (-1, 1), (1, -1)):
            k = len(em)
            ex.append(cx)
            ey.append(cy)
            em.append((sx * (far + k % 8), sy * (far + (k + 3) % 8)))
    return (plane, np.concatenate([xs, np.array(ex, np.int32)]),
            np.concatenate([ys, np.array(ey, np.int32)]),
            np.concatenate([mvq, np.array(em, np.int32)]))


def job_list(w=112, h=72, n=40, device="cpu"):
    """All six sizes in one job list (luma 32, 16, 8, chroma 16, 8, 4)."""
    jobs = []
    for i, (size, is_luma) in enumerate(CASES):
        arrs = edge_inputs(size, 30 + i, w, h, n)
        jobs.append(tuple(torch.from_numpy(a).to(device) for a in arrs)
                    + (size, is_luma))
    return jobs


def test_mc_blk_planes_plain_matches_mc_blk_by_job():
    """mc_blk_planes_plain, and mc_blk_planes on CPU tensors, equal
    mc_blk_plain job by job; the windows reach past every plane edge."""
    jobs = job_list()
    want = [mc_blk_plain(*job) for job in jobs]
    for got in (mc_blk_planes_plain(jobs), mc_blk_planes(jobs)):
        assert len(got) == len(jobs)
        for g, w_, job in zip(got, want, jobs):
            assert g.dtype == torch.int32 and torch.equal(g, w_), job[4:]
    for plane, xs, ys, mvq, size, is_luma in jobs:
        fs, off, nt = (2, 3, 8) if is_luma else (3, 1, 4)
        ix = xs + (mvq[:, 0] >> fs) - off
        iy = ys + (mvq[:, 1] >> fs) - off
        hh, ww = plane.shape
        win = size + nt - 1
        assert (ix + win <= 0).any() and (ix >= ww).any()
        assert (iy + win <= 0).any() and (iy >= hh).any()


@pytest.mark.cuda
def test_mc_blk_planes_kernel_matches_plain(cuda_device):
    """Kernel K3 over twelve jobs at 416x240 (the six sizes twice) in one
    launch equals plain job by job; its outputs are views of one buffer,
    each 16-byte aligned; an empty job leaves the launch to the rest."""
    jobs = (job_list(416, 240, 400, cuda_device)
            + job_list(416, 240, 91, cuda_device))
    before = LAUNCHES["mc_blk"]
    got = mc_blk_planes(jobs)
    assert LAUNCHES["mc_blk"] == before + 1
    want = mc_blk_planes_plain(jobs)
    torch.cuda.synchronize()
    for g, w_, job in zip(got, want, jobs, strict=True):
        assert g.data_ptr() % 16 == 0 and torch.equal(g, w_), job[4:]
    empty = tuple(t_[:0] for t_ in jobs[0][1:4])
    got = mc_blk_planes([(jobs[0][0],) + empty + jobs[0][4:]] + jobs[1:3])
    want = mc_blk_planes_plain(jobs[1:3])
    torch.cuda.synchronize()
    assert got[0].shape == (0, jobs[0][4], jobs[0][4])
    assert all(torch.equal(g, w_) for g, w_ in zip(got[1:], want))
