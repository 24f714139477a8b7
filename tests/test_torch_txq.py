"""K4 (fused inter TU coding) against the JAX stage of
tpuhevc/codec/inter_batch.py:193-236, composed here from the functions it
calls (tpuhevc.ops.transforms, inter_enc._bits_est_jnp) on the same
arrays: lvl, rec, d and bits bit-exact for S = 4..32, including the
int32-wrapping drop product; `txq_planes_plain` (a P picture's planes)
against `txq_plain` job by job. The CUDA kernel against the plain version
runs on a GPU only."""

# jax is imported inside the tests that compare with it, so that the CUDA
# tests of this file also load where only the GPU stack is installed.
import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, rng_planes  # noqa: F401
from tpuhevc.codec.inter_enc import _bits_est_jnp
from tpuhevc.ops import transforms as jtx
from tpuhevc_torch.ops import transforms as ttx
from tpuhevc_torch.ops.txq import (bits_est, txq, txq_plain, txq_planes,
                                   txq_planes_plain)


def jax_txq(cur, pred, qp, lam_full):
    """inter_batch.py's coded_plane + drop rule for one TU class."""
    import jax.numpy as jnp

    cur = jnp.asarray(cur)
    pred = jnp.asarray(pred)
    log2 = cur.shape[-1].bit_length() - 1
    lvl = jtx.quantize(jtx.forward_transform(cur - pred, 8), qp, log2, 8,
                       False)
    rsd = jtx.inverse_transform(jtx.dequantize(lvl, qp, log2, 8), 8)
    rec = jnp.clip(pred + rsd, 0, 255)
    nz = (lvl != 0).reshape(lvl.shape[0], -1).any(axis=1)
    rec = jnp.where(nz[:, None, None], rec, pred)

    def sse(a, b):
        d = (a - b).reshape(a.shape[0], -1)
        return (d * d).sum(axis=1)

    d_skip, d_coded = sse(cur, pred), sse(cur, rec)
    drop = (d_skip - d_coded) <= (lam_full * _bits_est_jnp(lvl)) >> 8
    lvl = jnp.where(drop[:, None, None], 0, lvl)
    rec = jnp.where(drop[:, None, None], pred, rec)
    d = jnp.where(drop, d_skip, d_coded)
    return [np.asarray(x) for x in (lvl, rec, d, _bits_est_jnp(lvl))]


def tus(size, seed, n=24):
    """cur from a textured plane; pred = cur (every other TU shifted by a
    pixel) plus noise, so that some TUs are coded and some dropped."""
    rng = np.random.default_rng(seed)
    rows = -(-n // 6)
    plane = rng_planes(seed, rows * size, 6 * size)[0]
    cur = plane.reshape(rows, size, 6, size).transpose(0, 2, 1, 3)
    cur = np.ascontiguousarray(cur.reshape(-1, size, size))[:n]
    noise = rng.normal(0, rng.uniform(0, 20, (len(cur), 1, 1)), cur.shape)
    moved = (np.arange(len(cur)) % 2 == 0)[:, None, None]
    pred = np.clip(np.where(moved, np.roll(cur, 1, axis=2), cur)
                   + np.rint(noise), 0, 255)
    return cur.astype(np.int32), pred.astype(np.int32)


@pytest.mark.parametrize("qp", [22, 32, 47])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_txq_plain_matches_jax(size, qp):
    cur, pred = tus(size, size + qp)
    lam_full = int(round(0.4624 * 2 ** ((qp - 12) / 3) * 256))
    want = jax_txq(cur, pred, qp, lam_full)
    got = txq(torch.from_numpy(cur), torch.from_numpy(pred), qp, lam_full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    dropped = (want[3] == 0) & (want[2] == ((cur - pred) ** 2).sum((1, 2)))
    if qp == 32:
        assert 0 < dropped.sum() < len(cur)  # both branches of the drop


def test_txq_drop_product_wraps_int32():
    """At QP 47 with a lambda whose product with the bit count leaves
    int32, the decision must follow JAX's wrapped product."""
    cur, pred = tus(32, 5)
    pred = np.clip(pred + np.random.default_rng(1).integers(-90, 90, pred.shape),
                   0, 255).astype(np.int32)
    lam_full = 1 << 26
    want = jax_txq(cur, pred, 47, lam_full)
    got = txq(torch.from_numpy(cur), torch.from_numpy(pred), 47, lam_full)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    lvl = ttx.quantize(ttx.forward_transform(
        torch.from_numpy(cur - pred)), 47, 5, 8, False)
    assert int(bits_est(lvl).max()) * lam_full >= 1 << 31


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_txq_kernel_matches_plain(cuda_device, size):
    for qp in (22, 32, 47):
        cur, pred = tus(size, size + qp, n=300)
        c = torch.from_numpy(cur).to(cuda_device)
        p = torch.from_numpy(pred).to(cuda_device)
        for lam_full in (int(round(0.4624 * 2 ** ((qp - 12) / 3) * 256)),
                         1 << 26):
            got = txq(c, p, qp, lam_full)
            want = txq_plain(c, p, qp, lam_full)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def picture_jobs(n=20):
    """A P picture's jobs as the class pipeline gives them: luma 32 and
    chroma 16, luma 16 and chroma 8 (twice), luma 8 and chroma 4; the
    chroma at QP 50 in one class (the wrapping drop product at a large
    lambda), seeded TUs each."""
    jobs = []
    for i, (size, qp, qpc) in enumerate(((32, 32, 31), (16, 37, 50),
                                         (16, 22, 22), (8, 47, 40))):
        for j, (s, q) in enumerate(((size, qp), (size // 2, qpc),
                                    (size // 2, qpc))):
            cur, pred = tus(s, 3 * i + j, n)
            jobs.append((torch.from_numpy(cur), torch.from_numpy(pred), q))
    return jobs


@pytest.mark.parametrize("lam_full", [3000, 1 << 26])
def test_txq_planes_plain_matches_txq_plain(lam_full):
    jobs = picture_jobs()
    got = txq_planes_plain(jobs, lam_full)
    assert len(got) == 12
    for (cur, pred, qp), g in zip(jobs, got):
        for a, b in zip(g, txq_plain(cur, pred, qp, lam_full), strict=True):
            assert torch.equal(a, b)
    one = txq_planes(jobs[:1], lam_full)[0]
    for a, b in zip(one, txq(*jobs[0][:2], jobs[0][2], lam_full)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_txq_planes_kernel_matches_plain(cuda_device):
    """Twelve jobs (every TU size, QP 50 in the mix) in one launch, one
    job alone, every TU dropped (lambda 2^30) and cur == pred."""
    jobs = [(c.to(cuda_device), p.to(cuda_device), q)
            for c, p, q in picture_jobs(n=300)]
    same = [(c, c.clone(), q) for c, _, q in jobs[:3]]
    for js in (jobs, jobs[3:4], same):
        for lam_full in (3000, 1 << 26, 1 << 30):
            got = txq_planes(js, lam_full)
            want = txq_planes_plain(js, lam_full)
            torch.cuda.synchronize()
            for g, w in zip(got, want, strict=True):
                for a, b in zip(g, w, strict=True):
                    assert torch.equal(a, b)
