"""K3 (DCT-IF block MC) of tpuhevc_torch against tpuhevc.ops.interp.mc
(JAX, CPU; the same semantics as inter_batch.py's mc_blk at 8 bits):
bit-exact for luma 8/16/32 and chroma 4/8/16, with fractional MVs of both
signs and windows clamped at every plane edge. On a GPU the kernel meets
the plain version."""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc.ops.interp import mc as jax_mc
from tpuhevc_torch.ops.interp import mc_blk, mc_blk_plain

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
