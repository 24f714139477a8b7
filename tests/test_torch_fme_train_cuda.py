"""The train step's multi-block kernels on a card (`cuda`; skipped here).

`fme_train_fwd` and `fme_train_bwd` are each one cooperative launch over
the card and `fme_adam` one thread an element over ceil(n / 256) blocks
(`tpuhevc_torch/kernels/csrc/fme_train.cu`). Inputs are made with numpy
from seeds: 2,048 samples of mapper-normalised SADs, categories and
labels, the initial weights of `init_train_params`, the dropout
uniforms from a seeded CPU generator; the default dropouts.

- the forward against the plain forward at B = 1, 31, 33, 256 and 1,024
  (logits atol 1e-4; loss, batch and running statistics rtol 1e-5 +
  atol 1e-5: float sums in another order), and the backward against
  autograd of the plain forward (the same masks): rtol 1e-4, atol 1e-6;
- two launches of the forward and of the backward give the same bits,
  on grids of at least 64 blocks (the forward's at B = 1,024);
- Adam against the plain version at n = 2,042 and n = 1,000 (not a
  multiple of the block): parameters atol 1e-7 after three steps on the
  same gradient, and the count 3;
- five whole steps (`models.fme_train.train_step`, as `train_fme` runs
  them) equal from run to run, with the wrappers' bindings kept in the
  data and the Adam state and with them made afresh each step.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device  # noqa: F401
from tpuhevc_torch.models import nnfme as pn
from tpuhevc_torch.models.fme_train import train_step
from tpuhevc_torch.ops import fme_train as ft

N_DATA = 2048


def start(dev, b, seed=3):
    """(data, flat, state, idx, unif) for a batch of b on dev."""
    rng = np.random.default_rng(seed)
    data = ft.FmeData.from_numpy(
        rng.standard_normal((N_DATA, 9)).astype(np.float32),
        rng.integers(0, 8, N_DATA), rng.integers(0, 8, N_DATA),
        rng.integers(0, 49, N_DATA), dev)
    flat = torch.as_tensor(pn.flatten_np(pn.init_train_params(rng),
                                         pn.TRAIN_SHAPES), device=dev)
    state = torch.as_tensor(pn.flatten_np(pn.init_bn_state(),
                                          pn.STATE_SHAPES), device=dev)
    idx = torch.as_tensor(rng.permutation(N_DATA)[:b].astype(np.int32),
                          device=dev)
    unif = torch.rand((b, ft.UNIF_COLS),
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    return data, flat, state, idx, unif


FWD_KEYS = ("logits", "loss", "stats", "state", "saved")


def backward(dev, b):
    """(forward out, the forward again, the plain forward, gradient, the
    backward again, the plain gradient) for a batch of b."""
    cfg = pn.TrainConfig()
    data, flat, state, idx, unif = start(dev, b)
    fwd_args = (flat, state, data, idx, unif, cfg.dropouts, 0.1)
    out = ft.fme_train_fwd(*fwd_args)
    one = torch.ones((), device=dev)
    args = (flat, data, idx, unif, cfg.dropouts)
    return (out, lambda: ft.fme_train_fwd(*fwd_args),
            ft.fme_train_fwd_plain(*fwd_args),
            ft.fme_train_bwd(*args, out.saved, out.stats, one),
            lambda: ft.fme_train_bwd(*args, out.saved, out.stats, one),
            ft.fme_train_bwd_plain(*args, one))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 31, 33, 256, 1024])
def test_cuda_bwd_matches_plain(cuda_device, b):  # noqa: F811
    """The forward against the plain forward, then the backward against
    autograd of it."""
    out, _, plain, got, _, want = backward(cuda_device, b)
    torch.testing.assert_close(out.logits, plain.logits, rtol=0, atol=1e-4)
    for k in ("loss", "stats", "state"):
        torch.testing.assert_close(getattr(out, k), getattr(plain, k),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_bwd_same_bits_on_the_whole_card(cuda_device):  # noqa: F811
    """Two launches of the forward, and of the backward, bit for bit, each
    one cooperative launch of at least 64 blocks."""
    out, fwd_again, _, got, again, _ = backward(cuda_device, 1024)
    # the outputs are the bindings' buffers, which the next calls write
    first = {k: getattr(out, k).clone() for k in FWD_KEYS}
    got = got.clone()
    out2 = fwd_again()
    assert all(torch.equal(first[k], getattr(out2, k)) for k in FWD_KEYS)
    assert torch.equal(got, again())
    for geo in (ft.fwd_geometry(cuda_device, 1024),
                ft.bwd_geometry(cuda_device)):
        assert geo["grid"] >= 64 and geo["cooperative"] == 1, geo


@pytest.mark.cuda
def test_cuda_adam_multi_block(cuda_device):  # noqa: F811
    dev = cuda_device
    lr = pn.TrainConfig().lr
    for n in (pn.N_TRAIN, 1000):
        rng = np.random.default_rng(n)
        flat0 = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                                device=dev)
        g = torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                            device=dev)
        runs = []
        for adam in (ft.fme_adam, ft.fme_adam_plain):
            flat, opt = flat0.clone(), ft.AdamState.zeros(n, dev)
            for _ in range(3):
                adam(flat, g, opt, lr)
            runs.append((flat, opt))
        (fk, ok), (fp, op) = runs
        torch.testing.assert_close(fk, fp, rtol=0, atol=1e-7)
        torch.testing.assert_close(ok.m, op.m, rtol=0, atol=1e-9)
        assert int(ok.count) == int(op.count) == 3
        assert int(ok.ticket) == 0


@pytest.mark.cuda
def test_cuda_five_steps_same_bits(cuda_device):  # noqa: F811
    dev = cuda_device
    cfg = pn.TrainConfig()
    data, flat0, state0, _, _ = start(dev, 256)
    rng = np.random.default_rng(9)
    rows = torch.as_tensor(np.stack([rng.permutation(N_DATA)[:256]
                                     for _ in range(5)]).astype(np.int32),
                           device=dev)
    unif = torch.rand((5, 256, ft.UNIF_COLS),
                      generator=torch.Generator().manual_seed(9)).to(dev)
    one = torch.ones((), device=dev)

    def run(kept):
        flat, state = flat0.clone(), state0.clone()
        opt = ft.AdamState.zeros(pn.N_TRAIN, dev)
        for s in range(5):
            if not kept:  # bind the wrappers afresh each step
                data.launch = data.fwd_launch = opt.launch = None
            out = train_step(flat, state, data, rows[s], unif[s], opt, cfg,
                             one)
            state = out.state
        # out.state is a buffer of the forward's binding, which the next
        # run's steps write again
        return flat, state.clone(), opt.m, opt.v, opt.count

    a, b, c = run(True), run(True), run(False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    assert int(a[4]) == 5
