"""Hadamard SATD of the 35-mode bank and the per-block top-k (kernel
`satd35_topk`), and the host SATD of the 8x8 intra path.

Twin of `satd35` (`tpuhevc/codec/intra_decide_jax.py:75-84`) and of the
`lax.top_k(-sat, nc)` at `:130`: for every block and mode the SATD of
org - pred, summed over 8x8 Hadamard tiles rounded `(sum|H d H^T| + 2)
// 4` for S >= 8, or one 4x4 tile rounded `(sum + 1) // 2` at S = 4;
then the nc modes of least SATD, ties to the lower mode index (what
top_k of the negated costs gives). JAX takes the products in float32,
exactly here (an 8x8 sum stays below 2^24), so the integer results are
equal.

`satd35_topk_plain` is the PyTorch version (stable ascending sort, not
`torch.topk`, whose tie order is unspecified); `satd35_topk` launches the
CUDA kernel (`kernels/csrc/satd35_topk.cu`: the TU size compiled in, a
team of lanes a Hadamard tile, a warp's top-nc a block) for CUDA
tensors.

`hadamard` and `satd_np` are numpy copies of `tpuhevc/ops/cost.py:18-45`
for the host closed-loop intra encode (`codec/recon.py`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild


def wht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised Walsh-Hadamard transform over the last dim (power of
    two): the product with the Sylvester Hadamard matrix."""
    n = x.shape[-1]
    h = 1
    while h < n:
        y = x.reshape(*x.shape[:-1], n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(*x.shape[:-1], n)
        h *= 2
    return x


def satd35_plain(org: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """org (N, S, S), preds (N, 35, S, S) int32 -> (N, 35) int32 SATD."""
    n, m, S = preds.shape[0], preds.shape[1], preds.shape[-1]
    d = org[:, None] - preds
    t = 8 if S >= 8 else 4
    k = S // t
    tiles = d.reshape(n, m, k, t, k, t).permute(0, 1, 2, 4, 3, 5)
    c = wht(wht(tiles).transpose(-1, -2))
    s = c.abs().sum(dim=(-1, -2))
    s = (s + 2) >> 2 if t == 8 else (s + 1) >> 1
    return s.reshape(n, m, -1).sum(dim=-1).int()


def satd35_topk_plain(org: torch.Tensor, preds: torch.Tensor, nc: int):
    """-> (sat (N, 35) int32, topk (N, nc) int32: least SATD first, the
    lower mode first among equals)."""
    sat = satd35_plain(org, preds)
    order = torch.sort(sat, dim=1, stable=True).indices
    return sat, order[:, :nc].int().contiguous()


def satd35_topk(org: torch.Tensor, preds: torch.Tensor, nc: int):
    """Kernel `satd35_topk`. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if org.device.type == "cpu":
        return satd35_topk_plain(org, preds, nc)
    if org.device.type != "cuda":
        raise ValueError(f"satd35_topk: unsupported device {org.device}")
    dev = org.device
    check_tensor(org, "org", torch.int32, 3, dev)
    check_tensor(preds, "preds", torch.int32, 4, dev)
    n, S = org.shape[0], org.shape[-1]
    if S not in (4, 8, 16, 32) or tuple(preds.shape) != (n, 35, S, S) or \
            org.shape[1] != S or not 1 <= nc <= 35:
        raise ValueError(f"satd35_topk: unsupported shapes org "
                         f"{tuple(org.shape)} preds {tuple(preds.shape)} "
                         f"nc={nc}")
    if org.data_ptr() % 16 or preds.data_ptr() % 16:
        raise ValueError("satd35_topk: org and preds must be 16-byte "
                         "aligned")
    sat = torch.empty((n, 35), dtype=torch.int32, device=dev)
    topk = torch.empty((n, nc), dtype=torch.int32, device=dev)
    if n == 0:
        return sat, topk
    fn = kbuild.function("satd35_topk", "tpuhevc_satd35_topk",
                         [kbuild.P] * 4 + [kbuild.I] * 3 + [kbuild.P])
    err = fn(org.data_ptr(), preds.data_ptr(), sat.data_ptr(),
             topk.data_ptr(), n, S.bit_length() - 1, nc,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "satd35_topk")
    LAUNCHES["satd35_topk"] += 1
    return sat, topk


# --- numpy host SATD (the host closed-loop intra encode) ---------------------


@lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    if n == 1:
        return np.array([[1]], dtype=np.int32)
    h = hadamard(n // 2)
    return np.block([[h, h], [h, -h]]).astype(np.int32)


def satd_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """HM-style Hadamard SATD for 4x4 or 8x8 blocks (batched: (..., S, S))."""
    s = a.shape[-1]
    h = hadamard(s)
    d = a.astype(np.int32) - b.astype(np.int32)
    m = h @ d @ h.T
    tot = np.abs(m).sum(axis=(-1, -2))
    if s == 8:
        return (tot + 2) >> 2
    if s == 4:
        return (tot + 1) >> 1
    return tot >> (s.bit_length() - 1)
