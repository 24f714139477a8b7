"""Device selection: explicit, with no fallback.

Callers name their device. A CUDA device that is not there is an error,
never a silent switch to the CPU.
"""

from __future__ import annotations

import contextlib

import torch

# Decision costs (the NN-FME logits) must be plain fp32: TF32 keeps ~10
# mantissa bits and would flip argmaxes that the reference resolves.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The current CUDA device; raises when PyTorch sees no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """torch.device for `device` ("cpu", "cuda", "cuda:1", torch.device);
    a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(dev: torch.device):
    """Context in which `dev` is the current CUDA device (nothing for the
    CPU): the wrappers launch on `dev`'s current stream, which the runtime
    takes only while `dev` is current."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def contiguous_on(t: torch.Tensor, dtype, di: int,
                  ndim: int | None = None) -> bool:
    """Whether `t` is a contiguous `dtype` tensor (of ndim dimensions) on
    cuda:di: the lean check of the wrappers whose host time a call counts
    (`check_tensor` says which argument is wrong)."""
    return (t.dtype == dtype and t.get_device() == di and t.is_contiguous()
            and (ndim is None or t.dim() == ndim))


def check_tensor(t: torch.Tensor, name: str, dtype, ndim: int | None = None,
                 device: torch.device | None = None) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor (on `device`)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_depth(what: str, bit_depth: int) -> None:
    """Raise ValueError unless bit_depth is one the kernels take (8 or
    10): each has a variant a depth, which the caller names."""
    if bit_depth not in (8, 10):
        raise ValueError(f"{what}: bit depth {bit_depth} (8 or 10)")
