"""NN-FME training: `train_fme`, the port's counterpart of
`tpuhevc/models/nnfme.py:327-403`.

It consumes numpy's `default_rng(cfg.seed)` exactly as the reference does
(the train/validation split, the mapper's mean and std, the initial
weights, one permutation an epoch, a short last batch padded from the
epoch's order), so the initial weights and the batch order equal JAX's.
The dataset is uploaded once; each epoch's batch indices go up in one
copy; each step (`train_step`) calls kernels `fme_train_fwd`,
`fme_train_bwd` and `fme_adam` directly (the pair that
`ops.fme_train.FmeTrainLoss` ties together for autograd, without the
autograd engine's host work a step), the Adam step count on the device;
the losses stay there (fetched once, at the end, for `history`).

Divergence: the dropout masks come from a `torch.Generator` on the
device seeded from cfg.seed, not JAX's threefry keys, so the two runs
draw different masks; with `dropouts=(0, 0)` both keep every unit
(u >= 0), and their trajectories are comparable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_device, resolve
from ..ops.fme_train import (UNIF_COLS, AdamState, FmeData, FwdOut,
                             fme_adam, fme_train_bwd, fme_train_fwd)
from .nnfme import (NNFMETrain, TrainConfig, export_inference_params,
                    forward_np, height_category_np, init_bn_state,
                    init_train_params, width_category_np)


def epoch_batches(tr: np.ndarray, order: np.ndarray, bs: int) -> np.ndarray:
    """(n_batches, bs) dataset rows of one epoch: tr in `order`, cut into
    batches of bs, the last one padded from the start of the order."""
    rows = []
    for i in range(0, len(tr), bs):
        b = tr[order[i : i + bs]]
        if len(b) < bs:
            b = np.concatenate([b, tr[order[: bs - len(b)]]])
        rows.append(b)
    return np.stack(rows).astype(np.int32)


def prepare(samples: np.ndarray, cfg: TrainConfig):
    """train_fme's first draws of `default_rng(cfg.seed)`, in the
    reference's order: the train/validation split, the mapper's mean and
    std (float32, std + 1e-7) and the initial weights. Returns (rng, tr,
    va, mean, std, xs (N, 9) mapper-normalised, params); rng goes on to
    draw one permutation an epoch."""
    rng_np = np.random.default_rng(cfg.seed)
    n = len(samples)
    idx = rng_np.permutation(n)
    n_val = max(1, n // 5)
    tr, va = idx[n_val:], idx[:n_val]
    mean = samples[tr].mean(0).astype(np.float32)
    std = samples[tr].std(0).astype(np.float32) + 1e-7
    xs = ((samples - mean) / std).astype(np.float32)
    return rng_np, tr, va, mean, std, xs, init_train_params(rng_np)


def train_step(flat, state, data: FmeData, idx, unif, opt: AdamState,
               cfg: TrainConfig, one) -> FwdOut:
    """One step of train_fme in place on flat and opt: the forward on the
    batch rows idx with the dropout uniforms unif, the gradient of the
    mean loss (one: a 0-dim 1.0 on flat's device), the Adam update.
    Returns the forward's out (loss, new running statistics). On the card
    the forward and the backward write into their bindings' buffers:
    out.loss is the step's own, out.state one of two buffers that
    alternate from step to step, the rest is overwritten by the next
    step."""
    out = fme_train_fwd(flat, state, data, idx, unif, cfg.dropouts,
                        cfg.bn_momentum)
    g = fme_train_bwd(flat, data, idx, unif, cfg.dropouts, out.saved,
                      out.stats, one)
    fme_adam(flat, g, opt, cfg.lr)
    return out


def train_fme(samples: np.ndarray, labels: np.ndarray, heights: np.ndarray,
              widths: np.ndarray, cfg: TrainConfig | None = None,
              device="cuda", history: list | None = None):
    """Train one QP's MLP. samples (N, 9) raw SADs; labels (N,) class ids.
    Runs on `device` (a CUDA device must exist; the CPU only when named).
    history, when given, receives each epoch's mean training loss.
    Returns (inference_params, val_accuracy)."""
    dev = resolve(device)
    cfg = cfg or TrainConfig()
    rng_np, tr, va, mean, std, xs, params = prepare(samples, cfg)
    model = NNFMETrain.from_numpy(params, init_bn_state(), dev)
    data = FmeData.from_numpy(xs, height_category_np(heights),
                              width_category_np(widths), labels, dev)
    opt = AdamState.zeros(model.flat.shape[0], dev)
    one = torch.ones((), device=dev)  # d(loss)/d(loss)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    bs = min(cfg.batch_size, len(tr))
    state = model.state
    losses = []
    with on_device(dev):
        for _ in range(cfg.epochs):
            rows = epoch_batches(tr, rng_np.permutation(len(tr)), bs)
            rows_d = torch.as_tensor(rows, device=dev)
            unif = torch.rand((len(rows), bs, UNIF_COLS), generator=gen,
                              device=dev)
            for s in range(len(rows)):
                out = train_step(model.flat, state, data, rows_d[s], unif[s],
                                 opt, cfg, one)
                state = out.state
                losses.append(out.loss)
        model.state.copy_(state)
    if history is not None and losses:
        per = np.asarray(torch.stack(losses).cpu()).reshape(cfg.epochs, -1)
        history.extend(float(v) for v in per.mean(1))

    # validation with folded inference params (tests the export too)
    p, s = model.to_numpy()
    inf = export_inference_params(p, s, mean, std)
    logits = forward_np(inf, samples[va], heights[va], widths[va])
    acc = float((np.argmax(logits, -1) == labels[va]).mean())
    return inf, acc
