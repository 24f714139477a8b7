"""tpuhevc_torch.ops.transforms against tpuhevc.ops.transforms (JAX, CPU):
forward/inverse DCT-II and the quantiser pair, bit-exact for S = 4..32.
On a GPU the same plain functions (the references of kernel K4 there)
must give the CPU's integers."""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc.ops import transforms as jtx
from tpuhevc_torch.ops import transforms as ttx


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transforms_match_jax(size):
    import jax.numpy as jnp

    rng = np.random.default_rng(size)
    log2 = size.bit_length() - 1
    resi = rng.integers(-255, 256, (6, size, size)).astype(np.int32)
    resi[0] = 255  # extremes: the largest stage sums
    resi[1] = -255
    c_j = np.asarray(jtx.forward_transform(jnp.asarray(resi), 8))
    c_t = ttx.forward_transform(torch.from_numpy(resi)).numpy()
    np.testing.assert_array_equal(c_t, c_j)
    for qp in (0, 22, 37, 51):
        for intra in (False, True):
            l_j = np.asarray(jtx.quantize(jnp.asarray(c_j), qp, log2, 8, intra))
            l_t = ttx.quantize(torch.from_numpy(c_j), qp, log2, 8, intra)
            np.testing.assert_array_equal(l_t.numpy(), l_j)
        d_j = np.asarray(jtx.dequantize(jnp.asarray(l_j), qp, log2, 8))
        d_t = ttx.dequantize(torch.from_numpy(l_j), qp, log2, 8).numpy()
        np.testing.assert_array_equal(d_t, d_j)
        r_j = np.asarray(jtx.inverse_transform(jnp.asarray(d_j), 8))
        r_t = ttx.inverse_transform(torch.from_numpy(d_j)).numpy()
        np.testing.assert_array_equal(r_t, r_j)


def test_dst_matches_jax():
    """The 4x4 DST-VII of intra luma, forward and inverse."""
    import jax.numpy as jnp

    rng = np.random.default_rng(44)
    resi = rng.integers(-255, 256, (40, 4, 4)).astype(np.int32)
    resi[0], resi[1] = 255, -255
    c_j = np.asarray(jtx.forward_transform(jnp.asarray(resi), 8, True))
    c_t = ttx.forward_transform(torch.from_numpy(resi), 8, True).numpy()
    np.testing.assert_array_equal(c_t, c_j)
    d = np.asarray(jtx.dequantize(jtx.quantize(jnp.asarray(c_j), 27, 2), 27, 2))
    r_j = np.asarray(jtx.inverse_transform(jnp.asarray(d), 8, True))
    r_t = ttx.inverse_transform(torch.from_numpy(d.copy()), 8, True).numpy()
    np.testing.assert_array_equal(r_t, r_j)
    assert not np.array_equal(c_j, np.asarray(
        jtx.forward_transform(jnp.asarray(resi), 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transforms_on_cuda_equal_cpu(cuda_device, size):
    rng = np.random.default_rng(size + 100)
    log2 = size.bit_length() - 1
    resi = torch.from_numpy(
        rng.integers(-255, 256, (50, size, size)).astype(np.int32))
    for dev in ("cpu", cuda_device):
        c = ttx.forward_transform(resi.to(dev))
        lvl = ttx.quantize(c, 27, log2, 8, False)
        rec = ttx.inverse_transform(ttx.dequantize(lvl, 27, log2))
        if dev == "cpu":
            want = (c, lvl, rec)
        else:
            for g, w in zip((c, lvl, rec), want):
                assert torch.equal(g.cpu(), w)
