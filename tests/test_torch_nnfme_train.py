"""NN-FME training in tpuhevc_torch against tpuhevc's (JAX on the CPU).

The same inputs, made with numpy from seeds, go through both packages:

- the dataset extraction (`models/fme_data.extract` against
  `tools/extract_fme_dataset.extract`) at 128x64 x 6, SR 8: bit for bit;
  the CSVs the two CLIs write byte for byte, and each package's reader
  loads the other's file;
- the plain training forward (`models/nnfme.train_forward`, training mode,
  no dropout) on a batch of 256 from `init_train_params`, the JAX dicts
  carried across by `NNFMETrain.from_numpy`: logits and new running
  statistics within atol 1e-5 (fp32 sums in another order);
- the mean loss and its gradient (`ops/fme_train`: the plain forward and
  autograd, through the wrappers and `FmeTrainLoss`) against
  `jax.value_and_grad` of `loss_fn`: rtol 1e-4, atol 1e-6;
- 10 plain steps (`FmeTrainLoss`, `fme_adam`) with dropouts (0, 0)
  against 10 of JAX's jitted step with optax adam: parameters and state
  within rtol 1e-4 (atol 1e-6 for the parameters, which pass near zero;
  the measured gap is ~1e-7);
- `train_fme` on the CPU with epochs=3, batch_size=64, dropouts (0, 0):
  at epochs=0 the exported arrays equal JAX's exactly (the same draws of
  `default_rng(seed)`: split, mapper, initial weights); after 3 epochs the
  15 exported arrays within rtol 1e-3 (atol 1e-6) of JAX's and the
  validation accuracy within one sample;
- `export_inference_params` exactly;
- the CLI round trip on the CPU (`extract`, then `train --Device=cpu`):
  the npz loads in `tpuhevc.models.nnfme.load_npz`, and the port's 64x48
  LD-P grid encode with it decodes hash-OK; without a card the default
  device raises;
- on a card (`cuda`, skipped here): the three kernels against their plain
  versions at B = 256 with the default dropouts (the same uniforms): the
  forward's logits within atol 1e-4, its loss and statistics within rtol
  1e-5 / atol 1e-5, the gradient within rtol 1e-4 / atol 1e-6, Adam twice
  on the same gradient within atol 1e-7 (parameters; moments 1e-9 and
  rtol 1e-6), and 5 whole steps within rtol 1e-4 / atol 1e-5; two kernel
  runs of 5 steps equal bit for bit.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from torch_port_util import clip_frames, cuda_device  # noqa: F401
from tools import extract_fme_dataset, train_fme as train_tool
from tpuhevc.models import nnfme as jn
from tpuhevc_torch import app
from tpuhevc_torch.models import nnfme as pn
from tpuhevc_torch.models.fme_data import extract, load_csv
from tpuhevc_torch.models.fme_train import train_fme
from tpuhevc_torch.ops import fme_train as ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DROP = (0.0, 0.0)


@functools.lru_cache(maxsize=None)
def dataset():
    """The port's extraction at 128x64 x 6, SR 8 (160 samples)."""
    return extract(clip_frames(128, 64, 6), 32, sr=8)


@functools.lru_cache(maxsize=None)
def jax_step():
    """tpuhevc's jitted train step (`nnfme.py:355-368`), compiled once."""
    import optax

    cfg = jn.TrainConfig(dropouts=NO_DROP)
    opt = optax.adam(cfg.lr)

    def loss_fn(p, s, key, xb, hb, wb, yb):
        logits, s2 = jn.train_forward(p, s, xb, hb, wb, True, key,
                                      cfg.dropouts, cfg.bn_momentum)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, yb).mean(), s2

    @jax.jit
    def step(p, s, o, key, xb, hb, wb, yb):
        (l, s2), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, s, key, xb, hb, wb, yb)
        upd, o2 = opt.update(g, o, p)
        return optax.apply_updates(p, upd), s2, o2, l, g

    return opt, step


def batch_inputs(b, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 9)).astype(np.float32),
            rng.integers(0, 8, b).astype(np.int32),
            rng.integers(0, 8, b).astype(np.int32),
            rng.integers(0, 49, b).astype(np.int32))


def flat_np(d, shapes):
    return pn.flatten_np({k: np.asarray(v) for k, v in d.items()}, shapes)


def test_extract_equals_tools_and_csvs_cross_load(tmp_path, monkeypatch):
    frames = clip_frames(128, 64, 6)
    ref = extract_fme_dataset.extract(frames, 32, sr=8)
    got = dataset()
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert got[0].shape == (160, 9) and 0 <= got[2].min() <= got[2].max() < 49
    # both CLIs on the same clip write the same file, which both readers load
    args = ["--width", "64", "--height", "48", "--frames", "3", "--qp", "32"]
    a, b = str(tmp_path / "tool.csv"), str(tmp_path / "port.csv")
    monkeypatch.setattr(sys, "argv", ["extract_fme_dataset.py", a] + args)
    extract_fme_dataset.main()
    assert app.main_extract([b] + args) == 0
    assert open(a).read() == open(b).read()
    for x, y in zip(train_tool.load_csv(b), load_csv(a)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_train_forward_matches_jax():
    cfg = jn.TrainConfig()
    p = jn.init_train_params(np.random.default_rng(1), cfg)
    s = jn.init_bn_state(cfg)
    x, hc, wc, _ = batch_inputs(256)
    lj, sj = jax.jit(lambda p, s, x, h, w: jn.train_forward(
        p, s, x, h, w, True, None))(p, s, x, hc, wc)
    m = pn.NNFMETrain.from_numpy(p, s, "cpu")
    back_p, back_s = m.to_numpy()
    assert all(np.array_equal(back_p[k], p[k]) for k in p)
    assert all(np.array_equal(back_s[k], s[k]) for k in s)
    lt, st = pn.train_forward(
        dict(m.named_parameters()), {k: getattr(m, k) for k in pn.STATE_KEYS},
        torch.from_numpy(x), torch.from_numpy(hc).long(),
        torch.from_numpy(wc).long(), True)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), rtol=0,
                               atol=1e-5)
    for k in pn.STATE_KEYS:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=0,
                                   atol=1e-5)


def test_loss_and_gradient_match_jax():
    opt, step = jax_step()
    cfg = jn.TrainConfig()
    p = jn.init_train_params(np.random.default_rng(2), cfg)
    s = jn.init_bn_state(cfg)
    x, hc, wc, y = batch_inputs(256)
    _, sj, _, lj, gj = step(p, s, opt.init(p), jax.random.PRNGKey(0), x, hc,
                            wc, y)
    flat = torch.from_numpy(pn.flatten_np(p, pn.TRAIN_SHAPES))
    state = torch.from_numpy(pn.flatten_np(s, pn.STATE_SHAPES))
    data = ft.FmeData.from_numpy(x, hc, wc, y, "cpu")
    idx = torch.arange(256, dtype=torch.int32)
    unif = torch.rand(256, ft.UNIF_COLS, generator=torch.Generator().manual_seed(0))
    out = ft.fme_train_fwd(flat, state, data, idx, unif, NO_DROP, 0.1)
    np.testing.assert_allclose(out.loss.item(), float(lj), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.state.numpy(),
                               flat_np(sj, pn.STATE_SHAPES), rtol=1e-4)
    g = ft.fme_train_bwd(flat, data, idx, unif, NO_DROP, out.saved,
                         out.stats, torch.ones(()))
    np.testing.assert_allclose(g.numpy(), flat_np(gj, pn.TRAIN_SHAPES),
                               rtol=1e-4, atol=1e-6)
    # the autograd Function ties the same two together
    leaf = flat.clone().requires_grad_()
    loss, _ = ft.FmeTrainLoss.apply(leaf, state, data, idx, unif, NO_DROP, 0.1)
    (g2,) = torch.autograd.grad(loss, leaf)
    assert torch.equal(g2, g) and loss.item() == out.loss.item()


def test_ten_steps_match_jax():
    opt, step = jax_step()
    sads, dims, labels = dataset()
    cfg = jn.TrainConfig(dropouts=NO_DROP)
    rng = np.random.default_rng(0)
    xs = ((sads - sads.mean(0)) / (sads.std(0) + 1e-7)).astype(np.float32)
    hc, wc = jn.height_category(dims[:, 1]), jn.width_category(dims[:, 0])
    p = jn.init_train_params(rng, cfg)
    s = jn.init_bn_state(cfg)
    o = opt.init(p)
    m = pn.NNFMETrain.from_numpy(p, s, "cpu")
    data = ft.FmeData.from_numpy(xs, hc, wc, labels, "cpu")
    adam = ft.AdamState.zeros(pn.N_TRAIN, "cpu")
    leaf = m.flat.detach().requires_grad_()
    state = m.state
    key = jax.random.PRNGKey(0)
    for _ in range(10):
        b = rng.permutation(len(sads))[:64].astype(np.int32)
        key, k = jax.random.split(key)
        p, s, o, _, _ = step(p, s, o, k, xs[b], hc[b], wc[b], labels[b])
        loss, state = ft.FmeTrainLoss.apply(
            leaf, state, data, torch.from_numpy(b),
            torch.rand(64, ft.UNIF_COLS), NO_DROP, 0.1)
        (g,) = torch.autograd.grad(loss, leaf)
        ft.fme_adam(m.flat, g, adam, cfg.lr)
    assert int(adam.count) == 10
    np.testing.assert_allclose(m.flat.numpy(), flat_np(p, pn.TRAIN_SHAPES),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(state.numpy(), flat_np(s, pn.STATE_SHAPES),
                               rtol=1e-4)


def test_train_fme_matches_jax():
    sads, dims, labels = dataset()
    sads = sads.astype(np.float32)
    cfg = jn.TrainConfig(seed=5)
    assert all(np.array_equal(a, b) for a, b in zip(
        jn.init_train_params(np.random.default_rng(5), cfg).values(),
        pn.init_train_params(np.random.default_rng(5)).values()))
    n_val = len(sads) // 5
    for epochs, exact in ((0, True), (3, False)):
        kw = dict(epochs=epochs, batch_size=64, dropouts=NO_DROP)
        ref, acc_ref = jn.train_fme(sads, labels, dims[:, 1], dims[:, 0],
                                    jn.TrainConfig(**kw))
        hist = []
        got, acc = train_fme(sads, labels, dims[:, 1], dims[:, 0],
                             pn.TrainConfig(**kw), device="cpu", history=hist)
        assert sorted(got) == sorted(jn.PARAM_KEYS) and len(hist) == epochs
        for k in jn.PARAM_KEYS:
            if exact:  # the initial weights, folded
                assert np.array_equal(got[k], ref[k]), k
            else:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-3,
                                           atol=1e-6, err_msg=k)
        assert abs(acc - acc_ref) * n_val <= 1 + 1e-9, (acc, acc_ref)
    assert hist[-1] < hist[0]


def test_export_matches_jax():
    cfg = jn.TrainConfig()
    rng = np.random.default_rng(9)
    p = jn.init_train_params(rng, cfg)
    s = {k: rng.uniform(0.1, 2.0, v.shape).astype(np.float32)
         for k, v in jn.init_bn_state(cfg).items()}
    mean = rng.uniform(500, 3000, 9).astype(np.float32)
    std = rng.uniform(100, 900, 9).astype(np.float32)
    ref = jn.export_inference_params(p, s, mean, std)
    got = pn.export_inference_params(p, s, mean, std)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    sads = rng.uniform(0, 4000, (32, 9)).astype(np.float32)
    assert np.array_equal(pn.forward_np(got, sads, np.full(32, 16), np.full(32, 8)),
                          jn.forward_np(ref, sads, np.full(32, 16), np.full(32, 8)))


def test_cli_extract_train_encode_round_trip(tmp_path):
    from torch_port_util import Reader
    from tpuhevc_torch.codec.decoder import decode_stream
    from tpuhevc_torch.codec.encoder import encode_sequence
    from tpuhevc_torch.config.options import build_config, parse_args

    csv, npz = str(tmp_path / "d.csv"), str(tmp_path / "w.npz")
    assert app.main_extract([csv, "--width", "128", "--height", "64",
                             "--frames", "6"]) == 0
    assert app.main_train([npz, "--data", csv + ":32", "--epochs", "3",
                           "--Device=cpu"]) == 0
    weights = jn.load_npz(npz)
    assert sorted(weights) == [32] and sorted(weights[32]) == sorted(
        jn.PARAM_KEYS)
    cfg, _ = build_config(parse_args(
        ["-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
         "-wdt", "64", "-hgt", "48", "-f", "3", "-q", "32",
         "--NNWeightsDir=" + npz, "--RDOQ=0", "--SignHideFlag=0", "--SAO=0",
         "--LoopFilterDisable=1"]))
    enc, _ = encode_sequence(Reader(clip_frames(64, 48, 3)), cfg,
                             device="cpu")
    frames = decode_stream(enc.bitstream())
    assert len(frames) == 3 and all(f.md5_ok for f in frames)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            app.main_train([npz, "--data", csv + ":32", "--epochs", "1"])


@pytest.mark.cuda
def test_cuda_train_kernels_match_plain(cuda_device):  # noqa: F811
    dev = cuda_device
    cfg = pn.TrainConfig()
    x, hc, wc, y = batch_inputs(512)
    data_c = ft.FmeData.from_numpy(x, hc, wc, y, dev)
    data_p = ft.FmeData.from_numpy(x, hc, wc, y, "cpu")
    p = pn.init_train_params(np.random.default_rng(4))
    flat0 = torch.from_numpy(pn.flatten_np(p, pn.TRAIN_SHAPES))
    state0 = torch.from_numpy(pn.flatten_np(pn.init_bn_state(),
                                            pn.STATE_SHAPES))
    idx = torch.from_numpy(np.random.default_rng(5).permutation(512)[:256]
                           .astype(np.int32))
    unif = torch.rand(256, ft.UNIF_COLS,
                      generator=torch.Generator().manual_seed(1))
    drop = cfg.dropouts
    args_c = (data_c, idx.to(dev), unif.to(dev), drop)
    out_c = ft.fme_train_fwd(flat0.to(dev), state0.to(dev), *args_c[:3],
                             drop, 0.1)
    out_p = ft.fme_train_fwd_plain(flat0.to(dev), state0.to(dev), *args_c[:3],
                                   drop, 0.1)
    torch.testing.assert_close(out_c.logits, out_p.logits, rtol=0, atol=1e-4)
    for a, b in ((out_c.loss, out_p.loss), (out_c.stats, out_p.stats),
                 (out_c.state, out_p.state)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    one = torch.ones((), device=dev)
    g_c = ft.fme_train_bwd(flat0.to(dev), *args_c, out_c.saved, out_c.stats,
                           one)
    g_p = ft.fme_train_bwd_plain(flat0.to(dev), *args_c, one)
    torch.testing.assert_close(g_c, g_p, rtol=1e-4, atol=1e-6)

    def run(kernel, steps):
        flat = flat0.to(dev).clone()
        state = state0.to(dev).clone()
        opt = ft.AdamState.zeros(pn.N_TRAIN, dev)
        for _ in range(steps):
            if kernel:
                o = ft.fme_train_fwd(flat, state, *args_c[:3], drop, 0.1)
                g = ft.fme_train_bwd(flat, *args_c, o.saved, o.stats, one)
                ft.fme_adam(flat, g, opt, cfg.lr)
            else:
                o = ft.fme_train_fwd_plain(flat, state, *args_c[:3], drop, 0.1)
                g = ft.fme_train_bwd_plain(flat, *args_c, one)
                ft.fme_adam_plain(flat, g, opt, cfg.lr)
            state = o.state
        return flat, state, opt

    # Adam on the same gradient, twice (the count on the card)
    flats, opts = [], []
    for adam in (ft.fme_adam, ft.fme_adam_plain):
        flat, opt = flat0.to(dev).clone(), ft.AdamState.zeros(pn.N_TRAIN, dev)
        for _ in range(2):
            adam(flat, g_p, opt, cfg.lr)
        flats.append(flat)
        opts.append(opt)
    torch.testing.assert_close(flats[0], flats[1], rtol=0, atol=1e-7)
    torch.testing.assert_close(opts[0].m, opts[1].m, rtol=0, atol=1e-9)
    torch.testing.assert_close(opts[0].v, opts[1].v, rtol=1e-6, atol=1e-12)
    assert int(opts[0].count) == int(opts[1].count) == 2
    a, b = run(True, 5), run(True, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = run(False, 5)
    torch.testing.assert_close(a[0], c[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a[1], c[1], rtol=1e-4, atol=1e-5)
    # the plain forward on the CPU agrees with the card's
    out_cpu = ft.fme_train_fwd(flat0, state0, data_p, idx, unif, drop, 0.1)
    torch.testing.assert_close(out_cpu.logits, out_c.logits.cpu(), rtol=0,
                               atol=1e-4)
