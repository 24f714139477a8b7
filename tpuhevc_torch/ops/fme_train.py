"""The NN-FME train step: the live-BatchNorm forward with its loss, the
backward and the Adam update (kernels `fme_train_fwd`, `fme_train_bwd`,
`fme_adam`).

Twin of the jitted `step` of `tpuhevc/models/nnfme.py:361-368`:
`jax.value_and_grad` of `loss_fn` (355-359: `train_forward` 245-287 in
training mode, then the mean of optax's per-sample softmax cross-entropy)
and the `optax.adam(lr)` update (352, 366-368).

- `fme_train_fwd_plain`: the forward on tensors (`models/nnfme.py:
  train_forward`) and the loss; `fme_train_bwd_plain`: the gradient of the
  mean loss as torch autograd of that forward; `fme_adam_plain`: optax
  0.2.6's adam written out (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, the
  bias correction 1 - b**count with the count starting at 1).
- `fme_train_fwd`, `fme_train_bwd`, `fme_adam`: the wrappers. CPU tensors
  take the plain versions; CUDA tensors launch the kernels of
  `kernels/csrc/fme_train.cu`, each adding one to its count in
  `kernels.LAUNCHES`.
- `FmeTrainLoss`: a `torch.autograd.Function` whose forward is
  `fme_train_fwd` and whose backward is `fme_train_bwd`.
- On the card the three wrappers check and bind the tensors that stay
  from step to step once (kept in the `FmeData` and the `AdamState`) and
  check only a step's own tensors on each call. The forward and the
  backward write into buffers kept in the binding: the next call
  overwrites the logits, statistics, saved activations, gradient and
  scratch, the new running statistics alternate between two buffers (so
  one step's `state` is the next step's input), and each call's loss is a
  slot of its own. The buffers are reused in stream order, so calls that
  share a binding run on one stream; a caller that keeps an output past
  the next call clones it (as `FmeTrainLoss` does).

Layouts: the trained arrays flat (`models.nnfme.TRAIN_KEYS`, 2042 floats),
the running statistics flat (`STATE_KEYS`, 102), a batch as int32 row
indices into the dataset on the device (`FmeData`), and the dropout
uniforms as (B, 42) float32 in [0, 1): 22 for the mask after BN1, 20 for
the one after BN2, kept where u >= p (as JAX's `uniform >= p`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import check_tensor, on_device
from ..kernels import LAUNCHES
from ..kernels import build as kbuild
from ..models.nnfme import (N_STATE, N_TRAIN, STATE_SHAPES, TRAIN_SHAPES,
                            split_flat, train_forward)

UNIF_COLS = 42  # dropout uniforms a sample: 22 after BN1, 20 after BN2
SAVED_ROWS = 202  # the forward's saved rows a sample (fme_train.cu kSaved)
WORK_ROWS = 150  # the backward's scratch rows a sample (kWork)
MAX_BATCH = 1024  # the forward's batch sums: at most 32 samples a lane
LOSS_SLOTS = 1024  # the forward's losses: slots allocated at once


@dataclass
class FmeData:
    """The training set on its device: x (N, 9) float32 mapper-normalised
    SADs, cat (N, 2) int32 (height, width embedding rows), y (N,) int32
    class labels."""
    x: torch.Tensor
    cat: torch.Tensor
    y: torch.Tensor
    launch: "_BwdLaunch | None" = field(default=None, repr=False,
                                        compare=False)
    fwd_launch: "_FwdLaunch | None" = field(default=None, repr=False,
                                            compare=False)

    @classmethod
    def from_numpy(cls, xs, hcat, wcat, labels, device) -> "FmeData":
        return cls(
            torch.as_tensor(np.asarray(xs, np.float32), device=device),
            torch.as_tensor(np.stack([hcat, wcat], -1).astype(np.int32),
                            device=device),
            torch.as_tensor(np.asarray(labels, np.int32), device=device))


@dataclass
class FwdOut:
    logits: torch.Tensor  # (B, 49)
    loss: torch.Tensor  # () the mean loss
    stats: torch.Tensor  # (102,) the batch mean and variance of each BN
    state: torch.Tensor  # (102,) the updated running statistics
    saved: torch.Tensor | None  # what the backward kernel reads (CUDA)


@dataclass
class AdamState:
    """optax's ScaleByAdamState over the flat parameters; the step count
    lives on the device (no host sync a step). `ticket` is the kernel's
    count of its blocks done, zero between launches."""
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor  # () int32
    ticket: torch.Tensor  # () int32
    launch: "_AdamLaunch | None" = field(default=None, repr=False,
                                         compare=False)

    @classmethod
    def zeros(cls, n: int, device) -> "AdamState":
        return cls(torch.zeros(n, device=device),
                   torch.zeros(n, device=device),
                   torch.zeros((), dtype=torch.int32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def keep_masks(unif: torch.Tensor, dropouts) -> tuple:
    """The two dropout keep masks (0/1 float32) from the uniforms."""
    return ((unif[:, :22] >= dropouts[0]).float(),
            (unif[:, 22:] >= dropouts[1]).float())


def _batch(data: FmeData, idx: torch.Tensor):
    ii = idx.long()
    cat = data.cat[ii].long()
    return data.x[ii], cat[:, 0], cat[:, 1], data.y[ii].long()


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """optax's softmax_cross_entropy_with_integer_labels, per sample."""
    return torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]


def fme_train_fwd_plain(flat, state, data, idx, unif, dropouts, momentum):
    x, hc, wc, y = _batch(data, idx)
    stats = {}
    with torch.no_grad():
        logits, new = train_forward(
            split_flat(flat, TRAIN_SHAPES), split_flat(state, STATE_SHAPES),
            x, hc, wc, True, keep_masks(unif, dropouts), dropouts, momentum,
            stats)
        loss = _ce(logits, y).mean()
    return FwdOut(logits, loss,
                  torch.cat([stats[k].reshape(-1) for k in STATE_SHAPES]),
                  torch.cat([new[k].reshape(-1) for k in STATE_SHAPES]), None)


def fme_train_bwd_plain(flat, data, idx, unif, dropouts, gloss):
    """The gradient (2042,) of gloss * the mean loss: torch autograd of
    the plain forward."""
    x, hc, wc, y = _batch(data, idx)
    with torch.enable_grad():
        leaf = flat.detach().requires_grad_()
        logits, _ = train_forward(split_flat(leaf, TRAIN_SHAPES), None, x, hc,
                                  wc, True, keep_masks(unif, dropouts),
                                  dropouts)
        (g,) = torch.autograd.grad(_ce(logits, y).mean(), leaf,
                                   grad_outputs=gloss.reshape(()))
    return g


def _adam_consts(lr):
    """optax.adam's python floats (b1 0.9, b2 0.999, eps 1e-8), each
    rounded once to float32 where it meets the float32 moments (JAX's weak
    types); fme_train.cu's kAdamB1 ... kAdamEps are the same values."""
    def f(v):
        return float(np.float32(v))

    return dict(neg_lr=f(-lr), b1=f(0.9), omb1=f(1 - 0.9), b2=f(0.999),
                omb2=f(1 - 0.999), eps=f(1e-8))


def fme_adam_plain(flat, grad, opt: AdamState, lr) -> None:
    """optax.adam(lr) in place on flat and opt (scale_by_adam, then
    scale_by_learning_rate, then apply_updates)."""
    c = _adam_consts(lr)
    with torch.no_grad():
        opt.count += 1
        t = opt.count.float()
        m = c["omb1"] * grad + c["b1"] * opt.m
        v = c["omb2"] * (grad * grad) + c["b2"] * opt.v
        bc1 = 1 - torch.pow(torch.tensor(c["b1"], device=flat.device), t)
        bc2 = 1 - torch.pow(torch.tensor(c["b2"], device=flat.device), t)
        u = (m / bc1) / (torch.sqrt(v / bc2) + c["eps"])
        flat.add_(u * c["neg_lr"])
        opt.m.copy_(m)
        opt.v.copy_(v)


def _check_model(flat, data: FmeData, dev):
    """The tensors that stay from step to step."""
    check_tensor(flat, "flat", torch.float32, 1, dev)
    check_tensor(data.x, "data.x", torch.float32, 2, dev)
    check_tensor(data.cat, "data.cat", torch.int32, 2, dev)
    check_tensor(data.y, "data.y", torch.int32, 1, dev)
    n = data.x.shape[0]
    if (flat.shape[0] != N_TRAIN or data.x.shape[1] != 9
            or tuple(data.cat.shape) != (n, 2) or data.y.shape[0] != n):
        raise ValueError(f"fme_train: flat {tuple(flat.shape)}, data "
                         f"{tuple(data.x.shape)}")


def _check_batch(idx, unif, dev) -> int:
    """A step's batch rows and dropout uniforms; returns the batch size."""
    check_tensor(idx, "idx", torch.int32, 1, dev)
    check_tensor(unif, "unif", torch.float32, 2, dev)
    b = idx.shape[0]
    if tuple(unif.shape) != (b, UNIF_COLS) or not 1 <= b <= MAX_BATCH:
        raise ValueError(f"fme_train: idx {b}, unif {tuple(unif.shape)}")
    return b


def _f32(v) -> float:
    """v rounded once to float32 (as the kernels take their constants)."""
    return float(np.float32(v))


def _drop_args(dropouts) -> tuple:
    p1, p2 = dropouts
    return _f32(p1), _f32(1 - p1), _f32(p2), _f32(1 - p2)


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of dev, as the handle the kernels take."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


_FWD_ARGS = [kbuild.P] * 7 + [kbuild.I] + [kbuild.F] * 6 + [kbuild.P] * 6
_BWD_ARGS = ([kbuild.P] * 5 + [kbuild.P, kbuild.I] + [kbuild.F] * 4
             + [kbuild.P] * 5)
_ADAM_ARGS = [kbuild.P] * 6 + [kbuild.I, kbuild.F, kbuild.P]


class _FwdLaunch:
    """fme_train_fwd bound to (flat, data, dropouts, momentum): those
    tensors checked, the function, the float constants and the pointers
    taken once; kept in data while the same flat and data tensors (by
    identity), dropouts and momentum come back. Holds the output buffers
    of a batch size: logits, statistics, saved rows, two running-state
    buffers and the loss slots."""

    def __init__(self, flat, data: FmeData, dropouts, momentum):
        dev = flat.device
        _check_model(flat, data, dev)
        self.key = (flat, data.x, data.cat, data.y, tuple(dropouts),
                    momentum)
        self.dev = dev
        self.fn = kbuild.function("fme_train", "tpuhevc_fme_train_fwd",
                                  _FWD_ARGS)
        self.head = (flat.data_ptr(),)
        self.data = (data.x.data_ptr(), data.cat.data_ptr(),
                     data.y.data_ptr())
        self.consts = (*_drop_args(dropouts), _f32(momentum),
                       _f32(1 - momentum))
        self.b = 0  # the batch size of the buffers
        self.states: tuple = ()
        self.slots: list = []

    def serves(self, flat, data: FmeData, dropouts, momentum) -> bool:
        return (all(a is b for a, b in zip(self.key, (
            flat, data.x, data.cat, data.y)))
            and self.key[4:] == (tuple(dropouts), momentum))

    def _outputs(self, b: int, state):
        """(logits, loss, stats, new state, saved) to write."""
        dev = self.dev
        if b != self.b:
            self.b = b
            self.logits = torch.empty((b, 49), dtype=torch.float32,
                                      device=dev)
            self.stats = torch.empty(N_STATE, dtype=torch.float32, device=dev)
            self.saved = torch.empty(SAVED_ROWS * b, dtype=torch.float32,
                                     device=dev)
            self.states = tuple(torch.empty(N_STATE, dtype=torch.float32,
                                            device=dev) for _ in range(2))
        if not self.slots:
            log = torch.empty(LOSS_SLOTS, dtype=torch.float32, device=dev)
            self.slots = list(reversed(log.unbind()))
        loss = self.slots.pop()
        new = self.states[1] if state is self.states[0] else self.states[0]
        return self.logits, loss, self.stats, new, self.saved

    def __call__(self, state, idx, unif) -> FwdOut:
        dev = self.dev
        b = _check_batch(idx, unif, dev)
        if not any(state is s for s in self.states):
            check_tensor(state, "state", torch.float32, 1, dev)
            if state.shape[0] != N_STATE:
                raise ValueError(f"fme_train_fwd: state {tuple(state.shape)}")
        outs = self._outputs(b, state)
        err = self.fn(*self.head, state.data_ptr(), *self.data,
                      idx.data_ptr(), unif.data_ptr(), b, *self.consts,
                      *(o.data_ptr() for o in outs), _stream(dev))
        kbuild.check(err, "fme_train_fwd")
        LAUNCHES["fme_train_fwd"] += 1
        return FwdOut(*outs)


def fme_train_fwd(flat, state, data: FmeData, idx, unif, dropouts=(0.001, 0.01),
                  momentum=0.1) -> FwdOut:
    """Kernel `fme_train_fwd`: gathers the batch idx (B,) from data, runs
    the training forward with batch statistics and the dropout masks of
    unif (B, 42), and returns the logits, the mean loss, the batch
    statistics, the updated running statistics and (CUDA) the saved
    activations. One cooperative launch over the card, every sum over the
    batch one warp's in a fixed order. flat and data are checked and bound
    on the first call for these tensors, dropouts and momentum, and kept
    in data; state is checked unless it is one of the binding's state
    buffers. On the card the outputs are the binding's buffers (the
    module's docstring). CPU tensors take the plain version."""
    if flat.device.type == "cpu":
        return fme_train_fwd_plain(flat, state, data, idx, unif, dropouts,
                                   momentum)
    if flat.device.type != "cuda":
        raise ValueError(f"fme_train_fwd: unsupported device {flat.device}")
    lf = data.fwd_launch
    if lf is None or not lf.serves(flat, data, dropouts, momentum):
        lf = data.fwd_launch = _FwdLaunch(flat, data, dropouts, momentum)
    return lf(state, idx, unif)


class _BwdLaunch:
    """fme_train_bwd bound to (flat, data, dropouts): those tensors checked,
    the function, the dropout constants and their pointers taken once;
    kept in data while the same flat and data tensors (by identity) and
    dropouts come back. Holds the gradient and scratch rows of a batch
    size."""

    def __init__(self, flat, data: FmeData, dropouts):
        dev = flat.device
        _check_model(flat, data, dev)
        self.key = (flat, data.x, data.cat, data.y, tuple(dropouts))
        self.dev = dev
        self.fn = kbuild.function("fme_train", "tpuhevc_fme_train_bwd",
                                  _BWD_ARGS)
        self.head = (flat.data_ptr(), data.cat.data_ptr(), data.y.data_ptr())
        self.drop = _drop_args(dropouts)
        self.b = 0  # the batch size of the buffers

    def serves(self, flat, data: FmeData, dropouts) -> bool:
        return (all(a is b for a, b in zip(self.key, (
            flat, data.x, data.cat, data.y)))
            and self.key[-1] == tuple(dropouts))

    def _outputs(self, b: int):
        """(grad, work) to write."""
        dev = self.dev
        if b != self.b:
            self.b = b
            self.grad = torch.empty(N_TRAIN, dtype=torch.float32, device=dev)
            self.work = torch.empty(WORK_ROWS * b, dtype=torch.float32,
                                    device=dev)
        return self.grad, self.work

    def __call__(self, idx, unif, saved, stats, gloss) -> torch.Tensor:
        dev = self.dev
        b = _check_batch(idx, unif, dev)
        check_tensor(saved, "saved", torch.float32, 1, dev)
        check_tensor(stats, "stats", torch.float32, 1, dev)
        check_tensor(gloss, "gloss", torch.float32, 0, dev)
        if saved.shape[0] != SAVED_ROWS * b or stats.shape[0] != N_STATE:
            raise ValueError(f"fme_train_bwd: saved {tuple(saved.shape)}, "
                             f"stats {tuple(stats.shape)} for a batch of {b}")
        grad, work = self._outputs(b)
        err = self.fn(*self.head, idx.data_ptr(), unif.data_ptr(),
                      saved.data_ptr(), b, *self.drop, stats.data_ptr(),
                      gloss.data_ptr(), grad.data_ptr(), work.data_ptr(),
                      _stream(dev))
        kbuild.check(err, "fme_train_bwd")
        LAUNCHES["fme_train_bwd"] += 1
        return grad


def fme_train_bwd(flat, data: FmeData, idx, unif, dropouts, saved, stats,
                  gloss) -> torch.Tensor:
    """Kernel `fme_train_bwd`: the gradient (2042,) of gloss (a 0-dim
    tensor) times the mean loss, from the forward's saved activations and
    batch statistics; one cooperative launch over the card, every sum over
    the batch one warp's in a fixed order, no atomics (two runs give the
    same bits). flat and data are checked and bound on the first call for
    these tensors and dropouts, and kept in data; on the card the gradient
    and the scratch rows are the binding's (the module's docstring). CPU
    tensors take the plain version (autograd of the plain forward)."""
    if flat.device.type == "cpu":
        return fme_train_bwd_plain(flat, data, idx, unif, dropouts, gloss)
    if flat.device.type != "cuda":
        raise ValueError(f"fme_train_bwd: unsupported device {flat.device}")
    if data.launch is None or not data.launch.serves(flat, data, dropouts):
        data.launch = _BwdLaunch(flat, data, dropouts)
    return data.launch(idx, unif, saved, stats,
                       gloss.reshape(()).contiguous())


def _geometry(dev, symbol, what, *head) -> dict:
    fn = kbuild.function("fme_train", symbol,
                         [kbuild.I] * len(head) + [kbuild.P] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    with on_device(dev):
        kbuild.check(fn(*head, *(ctypes.byref(o) for o in out)), what)
    return dict(zip(("grid", "block", "cooperative"), (o.value for o in out)))


def fwd_geometry(dev, b: int) -> dict:
    """The forward's launch on dev for a batch of b: {grid, block,
    cooperative}."""
    return _geometry(dev, "tpuhevc_fme_train_fwd_geometry", "fme_train_fwd",
                     b)


def bwd_geometry(dev) -> dict:
    """The backward's launch on dev: {grid, block, cooperative}."""
    return _geometry(dev, "tpuhevc_fme_train_bwd_geometry", "fme_train_bwd")


def _check_vec(t, name, n, dev) -> None:
    check_tensor(t, name, torch.float32, 1, dev)
    if t.shape[0] != n:
        raise ValueError(f"fme_adam: {name} {tuple(t.shape)}, expected ({n},)")


class _AdamLaunch:
    """fme_adam bound to (flat, opt, lr): those tensors checked, the
    function, float32(-lr) and the pointers taken once; kept in opt while
    the same tensors (by identity) and lr come back. The gradient is a
    step's own, checked on each call."""

    def __init__(self, flat, opt: AdamState, lr):
        dev = flat.device
        self.n = n = flat.shape[0]
        for t, name in ((flat, "flat"), (opt.m, "m"), (opt.v, "v")):
            _check_vec(t, name, n, dev)
        check_tensor(opt.count, "count", torch.int32, 0, dev)
        check_tensor(opt.ticket, "ticket", torch.int32, 0, dev)
        self.key = (flat, opt.m, opt.v, opt.count, opt.ticket, lr)
        self.dev = dev
        self.fn = kbuild.function("fme_train", "tpuhevc_fme_adam", _ADAM_ARGS)
        self.head = (flat.data_ptr(),)
        self.tail = (opt.m.data_ptr(), opt.v.data_ptr(),
                     opt.count.data_ptr(), opt.ticket.data_ptr(), n,
                     _f32(-lr))

    def serves(self, flat, opt: AdamState, lr) -> bool:
        return (all(a is b for a, b in zip(self.key, (
            flat, opt.m, opt.v, opt.count, opt.ticket)))
            and self.key[-1] == lr)

    def __call__(self, grad) -> None:
        _check_vec(grad, "grad", self.n, self.dev)
        kbuild.check(self.fn(*self.head, grad.data_ptr(), *self.tail,
                             _stream(self.dev)), "fme_adam")
        LAUNCHES["fme_adam"] += 1


def fme_adam(flat, grad, opt: AdamState, lr) -> None:
    """Kernel `fme_adam`: optax.adam(lr) in place on flat, opt.m, opt.v
    and opt.count. flat and opt are checked and bound on the first call
    for these tensors and lr, and kept in opt; grad is checked on every
    call. CPU tensors take the plain version."""
    if flat.device.type == "cpu":
        return fme_adam_plain(flat, grad, opt, lr)
    if flat.device.type != "cuda":
        raise ValueError(f"fme_adam: unsupported device {flat.device}")
    if opt.launch is None or not opt.launch.serves(flat, opt, lr):
        opt.launch = _AdamLaunch(flat, opt, lr)
    opt.launch(grad)


class FmeTrainLoss(torch.autograd.Function):
    """loss, new_state = FmeTrainLoss.apply(flat, state, data, idx, unif,
    dropouts, momentum): the mean loss of one batch, differentiable in
    flat, through `fme_train_fwd`; its backward is `fme_train_bwd`. What
    it saves, returns or hands to autograd is cloned out of the wrappers'
    buffers, which their next calls overwrite."""

    @staticmethod
    def forward(ctx, flat, state, data, idx, unif, dropouts, momentum):
        out = fme_train_fwd(flat, state, data, idx, unif, dropouts, momentum)
        ctx.data, ctx.dropouts = data, dropouts
        saved = None if out.saved is None else out.saved.clone()
        ctx.save_for_backward(flat, idx, unif, saved, out.stats.clone())
        new_state = out.state.clone()
        ctx.mark_non_differentiable(new_state)
        return out.loss, new_state

    @staticmethod
    def backward(ctx, gloss, _gstate):
        flat, idx, unif, saved, stats = ctx.saved_tensors
        g = fme_train_bwd(flat, ctx.data, idx, unif, ctx.dropouts, saved,
                          stats, gloss)
        return g.clone(), None, None, None, None, None, None
