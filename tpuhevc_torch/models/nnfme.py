"""NN-FME inference: the per-QP MLP that turns the 3x3 integer-pel SAD
surface into a quarter-pel MV offset (kernel K2).

Twin of `tpuhevc/models/nnfme.py:176` (`forward`) plus the argmax ->
`CLASS_TO_QMV` step of `tpuhevc/codec/inter_batch.py:222-228`. Weights come
in the numpy layout of `tpuhevc.models.nnfme` (`load_npz`,
`select_qp_params`, `load_csv_weights`: the 15 `PARAM_KEYS`), so both
packages read the same files and compute the same thing.

`NNFME.forward` is the plain PyTorch version; `nn_refine` launches the
CUDA kernel (`kernels/csrc/nnfme_mlp.cu`) for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuhevc.models import nnfme as ref_nnfme
from tpuhevc.models.nnfme import CLASS_TO_QMV, PARAM_KEYS

from ..device import check_tensor
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

SHAPES = {
    "emb0": (8, 4), "emb1": (8, 4), "w1": (22, 17), "b1": (22,),
    "w2": (20, 22), "b2": (20,), "wout": (49, 20), "bout": (49,),
    "bn_in": (9,), "bn1_w": (22,), "bn1_b": (22,), "bn2_w": (20,),
    "bn2_b": (20,), "mean": (9,), "std": (9,),
}
N_PACKED = sum(int(np.prod(s)) for s in SHAPES.values())  # 2060 floats


def height_category(size: int) -> int:
    return int(ref_nnfme.height_category(size))


def width_category(size: int) -> int:
    return int(ref_nnfme.width_category(size))


class NNFME(nn.Module):
    """The NN-FME MLP with its weights as fp32 buffers. `packed` holds them
    flattened in `PARAM_KEYS` order, the layout the kernel reads."""

    def __init__(self):
        super().__init__()
        for k in PARAM_KEYS:
            self.register_buffer(k, torch.zeros(SHAPES[k]))
        self.register_buffer("packed", torch.zeros(N_PACKED), persistent=False)
        self.register_buffer("cls_to_qmv",
                             torch.as_tensor(CLASS_TO_QMV, dtype=torch.int32),
                             persistent=False)

    @classmethod
    def from_numpy(cls, p: dict, device="cpu") -> "NNFME":
        """From the dict of numpy arrays that `tpuhevc.models.nnfme`
        returns (all 15 `PARAM_KEYS`, shapes as `_check_shapes`)."""
        missing = set(PARAM_KEYS) - set(p)
        if missing:
            raise KeyError(f"NN-FME weights lack {sorted(missing)}")
        ref_nnfme._check_shapes(p)
        m = cls()
        with torch.no_grad():
            for k in PARAM_KEYS:
                a = np.asarray(p[k], dtype=np.float32).reshape(SHAPES[k])
                getattr(m, k).copy_(torch.from_numpy(a))
            m.packed.copy_(torch.cat([getattr(m, k).reshape(-1)
                                      for k in PARAM_KEYS]))
        return m.to(device)

    def forward(self, sads: torch.Tensor, height_cat, width_cat) -> torch.Tensor:
        """Plain version: (N, 9) SADs -> (N, 49) fp32 logits."""
        n = sads.shape[0]
        dev = sads.device
        hc = torch.as_tensor(height_cat, device=dev).long().expand(n)
        wc = torch.as_tensor(width_cat, device=dev).long().expand(n)
        x = (sads.float() - self.mean) / self.std
        x = x * self.bn_in
        inp = torch.cat([self.emb0[hc], self.emb1[wc], x], dim=-1)
        h1 = inp @ self.w1.T + self.b1
        h1 = torch.clamp_min(h1, 0) * self.bn1_w + self.bn1_b
        h2 = h1 @ self.w2.T + self.b2
        h2 = torch.clamp_min(h2, 0) * self.bn2_w + self.bn2_b
        return h2 @ self.wout.T + self.bout


def nn_refine_plain(model: NNFME, sad9: torch.Tensor, hcat: int, wcat: int):
    """-> (logits (N,49) f32, class (N,) i32, quarter-pel offset (N,2) i32)."""
    logits = model(sad9, hcat, wcat)
    cls = torch.argmax(logits, dim=-1)
    return logits, cls.int(), model.cls_to_qmv[cls]


def nn_refine(model: NNFME, sad9: torch.Tensor, hcat: int, wcat: int):
    """K2. CPU tensors take the plain version; CUDA tensors the kernel."""
    if sad9.device.type == "cpu":
        return nn_refine_plain(model, sad9, hcat, wcat)
    if sad9.device.type != "cuda":
        raise ValueError(f"nn_refine: unsupported device {sad9.device}")
    dev = sad9.device
    check_tensor(sad9, "sad9", torch.int32, 2, dev)
    check_tensor(model.packed, "packed weights", torch.float32, 1, dev)
    if sad9.shape[1] != 9 or model.packed.numel() != N_PACKED:
        raise ValueError(f"nn_refine: sad9 {tuple(sad9.shape)}")
    if not (0 <= hcat < 8 and 0 <= wcat < 8):
        raise ValueError(f"nn_refine: categories {hcat}, {wcat} out of range")
    n = sad9.shape[0]
    logits = torch.empty((n, 49), dtype=torch.float32, device=dev)
    cls = torch.empty((n,), dtype=torch.int32, device=dev)
    qoff = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return logits, cls, qoff
    fn = kbuild.function("nnfme_mlp", "tpuhevc_nnfme_mlp",
                         [kbuild.P] * 5 + [kbuild.I] * 3 + [kbuild.P])
    err = fn(sad9.data_ptr(), model.packed.data_ptr(), logits.data_ptr(),
             cls.data_ptr(), qoff.data_ptr(), n, hcat, wcat,
             torch.cuda.current_stream(dev).cuda_stream)
    kbuild.check(err, "nnfme_mlp")
    LAUNCHES["nnfme_mlp"] += 1
    return logits, cls, qoff


def random_params(seed: int) -> dict:
    """Seeded stand-in weights in the numpy layout of
    `tpuhevc.models.nnfme` (the repository ships no trained set). The
    mapper statistics are set to the scale of 8-bit block SADs so that
    the predicted offsets spread over the 49 classes."""
    rng = np.random.default_rng(seed)

    def nrm(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {
        "emb0": nrm((8, 4), 0.5), "emb1": nrm((8, 4), 0.5),
        "w1": nrm((22, 17), 17 ** -0.5 * 2), "b1": nrm((22,), 0.1),
        "w2": nrm((20, 22), 22 ** -0.5 * 2), "b2": nrm((20,), 0.1),
        "wout": nrm((49, 20), 20 ** -0.5 * 2), "bout": nrm((49,), 0.1),
        "bn_in": (1.0 + nrm((9,), 0.1)), "bn1_w": (1.0 + nrm((22,), 0.1)),
        "bn1_b": nrm((22,), 0.1), "bn2_w": (1.0 + nrm((20,), 0.1)),
        "bn2_b": nrm((20,), 0.1),
        "mean": rng.uniform(800, 3000, 9).astype(np.float32),
        "std": rng.uniform(300, 1500, 9).astype(np.float32),
    }
    ref_nnfme._check_shapes(p)
    return p
