"""K2 (the NN-FME MLP) of tpuhevc_torch against
tpuhevc.models.nnfme.forward (JAX, CPU) on seeded weights carried across
with NNFME.from_numpy. Logits agree within atol 1e-4 / rtol 1e-5 (the two
sum their fp32 products in different orders); the argmax agrees wherever
the top-2 gap exceeds 1e-3, and on this seeded set everywhere. On a GPU
the kernel meets the plain version at the same tolerance."""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, write_weights  # noqa: F401
from tpuhevc.models import nnfme as ref_nnfme
from tpuhevc_torch.models.nnfme import (
    NNFME, height_category, nn_refine, nn_refine_plain, random_params,
    width_category)


def sad_surfaces(seed, n=600):
    """(n, 9) int32 SAD surfaces around a minimum, at 8-bit block scale."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(200, 6000, (n, 1))
    bowl = rng.uniform(0.0, 0.6, (n, 9)) * base
    bowl[:, 4] = 0
    return np.rint(base + bowl).astype(np.int32)


@pytest.mark.parametrize("size", [8, 16, 32])
def test_nnfme_matches_jax(tmp_path, size):
    import jax.numpy as jnp

    p = ref_nnfme.select_qp_params(
        ref_nnfme.load_npz(write_weights(tmp_path / "w.npz")), 32)
    model = NNFME.from_numpy(p, "cpu")
    sads = sad_surfaces(size)
    hc, wc = height_category(size), width_category(size)
    want = np.asarray(ref_nnfme.forward(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(sads).astype(jnp.float32), jnp.full(len(sads), hc),
        jnp.full(len(sads), wc)))
    logits, cls, qoff = nn_refine(model, torch.from_numpy(sads), hc, wc)
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=1e-5)
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    np.testing.assert_array_equal(cls.numpy()[clear], want.argmax(1)[clear])
    np.testing.assert_array_equal(cls.numpy(), want.argmax(1))  # no flips
    np.testing.assert_array_equal(
        qoff.numpy(), ref_nnfme.CLASS_TO_QMV[want.argmax(1)])
    assert len(np.unique(cls.numpy())) > 1


def test_from_numpy_carries_all_keys():
    p = random_params(3)
    model = NNFME.from_numpy(p, "cpu")
    for k in ref_nnfme.PARAM_KEYS:
        np.testing.assert_array_equal(getattr(model, k).numpy(), p[k])
        assert getattr(model, k).dtype == torch.float32
    packed = np.concatenate([p[k].reshape(-1) for k in ref_nnfme.PARAM_KEYS])
    np.testing.assert_array_equal(model.packed.numpy(), packed)
    bad = dict(p)
    del bad["std"]
    with pytest.raises(KeyError):
        NNFME.from_numpy(bad, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 16, 32])
def test_nnfme_kernel_matches_plain(cuda_device, size):
    model = NNFME.from_numpy(random_params(1), cuda_device)
    sads = torch.from_numpy(sad_surfaces(size + 10, n=5000)).to(cuda_device)
    hc, wc = height_category(size), width_category(size)
    kl, kc, kq = nn_refine(model, sads, hc, wc)
    pl, pc, pq = nn_refine_plain(model, sads, hc, wc)
    torch.cuda.synchronize()
    torch.testing.assert_close(kl, pl, atol=1e-4, rtol=1e-5)
    top2 = torch.topk(pl, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(kc[clear], pc[clear].int())
    assert torch.equal(kq[clear], pq[clear])
