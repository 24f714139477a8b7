"""NN-FME inference: the per-QP MLP that turns the 3x3 integer-pel SAD
surface into a quarter-pel MV offset (kernel K2).

Twin of `tpuhevc/models/nnfme.py:176` (`forward`) plus the argmax ->
`CLASS_TO_QMV` step of `tpuhevc/codec/inter_batch.py:222-228`. Weights are
dicts of numpy arrays (the 15 `PARAM_KEYS`), read and written by the host
loaders below (`load_npz`, `save_npz`, `select_qp_params`,
`load_csv_weights`: copies of the reference's, same file layout), so both
packages read the same files and compute the same thing.

`NNFME.forward` is the plain PyTorch version; `nn_refine` (one class,
with its logits and classes) and `nn_refine_classes` (the offsets of up
to three classes a launch, as the grid step asks for them) launch the
CUDA kernel (`kernels/csrc/nnfme_mlp.cu`) for CUDA tensors.

The training half copies `tpuhevc/models/nnfme.py:207-324`: `TrainConfig`
(the FastAI tabular learner of the reference's NN_training.ipynb),
`init_train_params`, `init_bn_state`, `export_inference_params` (numpy)
and `train_forward` (on tensors, the plain live-BatchNorm forward);
`NNFMETrain` holds the 13 trained arrays as parameters and the six
BatchNorm running statistics as buffers, all views of two flat tensors
(`TRAIN_KEYS`, `STATE_KEYS` order), the layout the training kernels read
(`ops/fme_train.py`); `from_numpy`/`to_numpy` carry the JAX package's
parameter and state dicts across both ways. `forward_np` is the host
inference forward the validation accuracy uses.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import contiguous_on
from ..kernels import LAUNCHES
from ..kernels import build as kbuild

# class index -> quarter-pel offsets: class = (qy+3)*7 + (qx+3)
# (TEncSearch.cpp:136-193; label construction comment at 4568-4579)
CLASS_TO_QMV = np.array(
    [[(c % 7) - 3, (c // 7) - 3] for c in range(49)], dtype=np.int32
)


# category row orders (TEncSearch.cpp:93-113): index = row in emb matrix
_HEIGHT_ROWS = {4: 1, 8: 2, 16: 3, 12: 4, 24: 5, 32: 6, 64: 7}
_WIDTH_ROWS = {4: 1, 8: 2, 12: 3, 16: 4, 24: 5, 32: 6, 64: 7}


def height_category_np(h) -> np.ndarray:
    h = np.asarray(h)
    out = np.zeros(h.shape, dtype=np.int32)
    for k, v in _HEIGHT_ROWS.items():
        out = np.where(h == k, v, out)
    return out


def width_category_np(w) -> np.ndarray:
    w = np.asarray(w)
    out = np.zeros(w.shape, dtype=np.int32)
    for k, v in _WIDTH_ROWS.items():
        out = np.where(w == k, v, out)
    return out


PARAM_KEYS = (
    "emb0", "emb1", "w1", "b1", "w2", "b2", "wout", "bout",
    "bn_in", "bn1_w", "bn1_b", "bn2_w", "bn2_b", "mean", "std",
)


def _read_csv_matrix(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            vals = [x for x in re.split(r"[,;\s]+", line.strip()) if x]
            if vals:
                rows.append([float(x) for x in vals])
    return np.array(rows, dtype=np.float32)


def load_csv_weights(qp_dir: str) -> dict[str, np.ndarray]:
    """Load one QP's weights from a reference-format CSV export directory
    (files like 1.emb0-weight.csv ... 14.mapper_XX.csv)."""
    files = {f.split(".", 1)[1]: os.path.join(qp_dir, f)
             for f in os.listdir(qp_dir) if f.endswith(".csv")}

    def get(tag):
        for name, path in files.items():
            if name.startswith(tag):
                return _read_csv_matrix(path)
        raise FileNotFoundError(f"{tag} in {qp_dir}")

    mapper = get("mapper")  # rows: mean, std (9 each) in some layout
    mean, std = mapper[0], mapper[1]
    p = {
        "emb0": get("emb0-weight"),
        "emb1": get("emb1-weight"),
        "w1": get("lins0-weight"),
        "b1": get("lins0-bias").reshape(-1),
        "w2": get("lins1-weight"),
        "b2": get("lins1-bias").reshape(-1),
        "wout": get("outp-weight"),
        "bout": get("outp-bias").reshape(-1),
        "bn_in": get("bn-weight").reshape(-1),
        "bn1_w": get("bns0-weight").reshape(-1),
        "bn1_b": get("bns0-bias").reshape(-1),
        "bn2_w": get("bns1-weight").reshape(-1),
        "bn2_b": get("bns1-bias").reshape(-1),
        "mean": mean.reshape(-1),
        "std": std.reshape(-1),
    }
    _check_shapes(p)
    return p


def _check_shapes(p):
    assert p["emb0"].shape == (8, 4) and p["emb1"].shape == (8, 4), (
        p["emb0"].shape, p["emb1"].shape)
    assert p["w1"].shape == (22, 17) and p["w2"].shape == (20, 22)
    assert p["wout"].shape == (49, 20)
    assert p["mean"].shape == (9,) and p["std"].shape == (9,)


def save_npz(path: str, per_qp: dict[int, dict[str, np.ndarray]]) -> None:
    flat = {}
    for qp, p in per_qp.items():
        for k, v in p.items():
            flat[f"qp{qp}/{k}"] = v
    np.savez(path, **flat)


def load_npz(path: str) -> dict[int, dict[str, np.ndarray]]:
    data = np.load(path)
    out: dict[int, dict[str, np.ndarray]] = {}
    for key in data.files:
        qp_s, k = key.split("/", 1)
        out.setdefault(int(qp_s[2:]), {})[k] = data[qp_s + "/" + k]
    return out


def select_qp_params(per_qp: dict[int, dict], qp: int) -> dict:
    """Reference QP fallback: untrained QPs silently use the QP22 set
    (TEncSearch.cpp:925) — kept, with a loud warning."""
    if qp in per_qp:
        return per_qp[qp]
    import warnings

    base = 22 if 22 in per_qp else sorted(per_qp)[0]
    warnings.warn(
        f"NN-FME has no weights for QP {qp}; falling back to QP {base} "
        "(reference behavior)")
    return per_qp[base]


SHAPES = {
    "emb0": (8, 4), "emb1": (8, 4), "w1": (22, 17), "b1": (22,),
    "w2": (20, 22), "b2": (20,), "wout": (49, 20), "bout": (49,),
    "bn_in": (9,), "bn1_w": (22,), "bn1_b": (22,), "bn2_w": (20,),
    "bn2_b": (20,), "mean": (9,), "std": (9,),
}
N_PACKED = sum(int(np.prod(s)) for s in SHAPES.values())  # 2060 floats


def height_category(size: int) -> int:
    return int(height_category_np(size))


def width_category(size: int) -> int:
    return int(width_category_np(size))


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
    def from_numpy(cls, p: dict, device) -> "NNFME":
        """From a dict of numpy arrays (all 15 `PARAM_KEYS`, shapes as
        `_check_shapes`), as the loaders return it, on `device` (named by
        the caller: no default)."""
        missing = set(PARAM_KEYS) - set(p)
        if missing:
            raise KeyError(f"NN-FME weights lack {sorted(missing)}")
        _check_shapes(p)
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


def nn_refine_classes_plain(model: NNFME, parts):
    """parts: [(sad9 (n, 9) int32, hcat, wcat)] -> [quarter-pel offset
    (n, 2) int32] per part."""
    return [nn_refine_plain(model, sad9, hc, wc)[2] for sad9, hc, wc in parts]


# the classes one launch takes (the grid's 16, 8 and 32); the most
# blocks a launch, per device
K2_SEGS = 3
_BLOCKS: dict = {}
_K2_ARGS = ([kbuild.P] + ([kbuild.P] * 4 + [kbuild.I] * 3) * K2_SEGS
            + [kbuild.I] * 2 + [kbuild.P])


def _k2_launch(model: NNFME, segs: list, what: str) -> None:
    """One launch of K2 over up to K2_SEGS segments (sad9, qoff, logits or
    None, cls or None, hcat, wcat) on sad9's card."""
    dev = segs[0][0].device
    di = dev.index
    if not contiguous_on(model.packed, torch.float32, di, 1) or \
            model.packed.numel() != N_PACKED:
        raise ValueError(f"{what}: the packed weights must be {N_PACKED} "
                         f"contiguous float32 on {dev}")
    blocks = _BLOCKS.get(di)
    if blocks is None:  # as many as the card holds at once
        with torch.cuda.device(dev):
            blocks = kbuild.function("nnfme_mlp", "tpuhevc_nnfme_mlp_blocks",
                                     [])()
        if blocks <= 0:
            raise RuntimeError(f"{what}: occupancy query failed ({blocks})")
        _BLOCKS[di] = blocks
    args = [model.packed.data_ptr()]
    for k in range(K2_SEGS):
        if k < len(segs):
            sad9, qoff, logits, cls, hc, wc = segs[k]
            args += [sad9.data_ptr(), qoff.data_ptr(),
                     None if logits is None else logits.data_ptr(),
                     None if cls is None else cls.data_ptr(),
                     sad9.shape[0], hc, wc]
        else:
            args += [None] * 4 + [0] * 3
    fn = kbuild.function("nnfme_mlp", "tpuhevc_nnfme_mlp", _K2_ARGS)
    err = fn(*args, len(segs), blocks, torch._C._cuda_getCurrentRawStream(di))
    kbuild.check(err, what)
    LAUNCHES["nnfme_mlp"] += 1


def _check_part(sad9: torch.Tensor, hcat: int, wcat: int, dev, what: str):
    if not contiguous_on(sad9, torch.int32, dev.index, 2) or \
            sad9.shape[1] != 9:
        raise ValueError(f"{what}: sad9 must be (n, 9) contiguous int32 on "
                         f"{dev}, got {sad9.dtype} {tuple(sad9.shape)} on "
                         f"{sad9.device}")
    if not (0 <= hcat < 8 and 0 <= wcat < 8):
        raise ValueError(f"{what}: categories {hcat}, {wcat} out of range")


def nn_refine_classes(model: NNFME, parts):
    """K2 over up to K2_SEGS classes of PUs: parts [(sad9 (n, 9) int32,
    hcat, wcat)] -> [quarter-pel offset (n, 2) int32] per part, what the
    JAX stage `nn_refine` returns per class. CPU tensors take the plain
    version; CUDA tensors the kernel, one launch (no logits or classes
    written)."""
    if not 0 < len(parts) <= K2_SEGS:
        raise ValueError(f"nn_refine_classes: {len(parts)} classes, "
                         f"expected 1 to {K2_SEGS}")
    dev = parts[0][0].device
    if dev.type == "cpu":
        return nn_refine_classes_plain(model, parts)
    if dev.type != "cuda":
        raise ValueError(f"nn_refine_classes: unsupported device {dev}")
    for sad9, hc, wc in parts:
        _check_part(sad9, hc, wc, dev, "nn_refine_classes")
    sizes = [p[0].shape[0] for p in parts]
    offs = list(torch.empty((sum(sizes), 2), dtype=torch.int32,
                            device=dev).split(sizes))
    segs = [(sad9, off, None, None, hc, wc)
            for (sad9, hc, wc), off in zip(parts, offs) if sad9.shape[0]]
    if segs:
        _k2_launch(model, segs, "nn_refine_classes")
    return offs


def nn_refine(model: NNFME, sad9: torch.Tensor, hcat: int, wcat: int):
    """K2 on one class. CPU tensors take the plain version; CUDA tensors
    the kernel (one launch of one segment, logits and classes written)."""
    if sad9.device.type == "cpu":
        return nn_refine_plain(model, sad9, hcat, wcat)
    if sad9.device.type != "cuda":
        raise ValueError(f"nn_refine: unsupported device {sad9.device}")
    dev = sad9.device
    _check_part(sad9, hcat, wcat, dev, "nn_refine")
    n = sad9.shape[0]
    logits = torch.empty((n, 49), dtype=torch.float32, device=dev)
    cls = torch.empty((n,), dtype=torch.int32, device=dev)
    qoff = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n:
        _k2_launch(model, [(sad9, qoff, logits, cls, hcat, wcat)],
                   "nnfme_mlp")
    return logits, cls, qoff


def forward_np(p: dict, sads: np.ndarray, heights, widths) -> np.ndarray:
    """Reference-exact forward: (N, 9) SAD surfaces [TL,T,TR,L,C,R,BL,B,BR]
    -> (N, 49) logits (float32)."""
    x = (sads.astype(np.float32) - p["mean"]) / p["std"]
    x = x * p["bn_in"]
    e0 = p["emb0"][height_category_np(heights)]
    e1 = p["emb1"][width_category_np(widths)]
    inp = np.concatenate([e0, e1, x], axis=-1)  # (N, 17)
    h1 = inp @ p["w1"].T + p["b1"]
    h1 = np.maximum(h1, 0) * p["bn1_w"] + p["bn1_b"]
    h2 = h1 @ p["w2"].T + p["b2"]
    h2 = np.maximum(h2, 0) * p["bn2_w"] + p["bn2_b"]
    return h2 @ p["wout"].T + p["bout"]


def random_params(seed: int) -> dict:
    """Seeded stand-in weights in the numpy layout of the loaders (the
    repository ships no trained set). The
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
    _check_shapes(p)
    return p


# --- training (FastAI tabular learner parity) ----------------------------------

@dataclass
class TrainConfig:
    """The learner's training settings (the widths are fixed: TRAIN_SHAPES,
    the layers 17 -> 22 -> 20 -> 49 with 8x4 embeddings, as the kernels
    are)."""
    dropouts: tuple = (0.001, 0.01)
    lr: float = 3e-3
    epochs: int = 200
    batch_size: int = 1024
    bn_momentum: float = 0.1
    seed: int = 0


# the trained arrays and the running statistics, in their flat order (the
# trained arrays' offsets equal `nnfme_mlp.cu`'s for the same weights)
TRAIN_SHAPES = {
    "emb0": (8, 4), "emb1": (8, 4), "w1": (22, 17), "b1": (22,),
    "w2": (20, 22), "b2": (20,), "wout": (49, 20), "bout": (49,),
    "bn_in_w": (9,), "bn1_w": (22,), "bn1_b": (22,), "bn2_w": (20,),
    "bn2_b": (20,),
}
STATE_SHAPES = {"in_mu": (9,), "in_var": (9,), "bn1_mu": (22,),
                "bn1_var": (22,), "bn2_mu": (20,), "bn2_var": (20,)}
TRAIN_KEYS = tuple(TRAIN_SHAPES)
STATE_KEYS = tuple(STATE_SHAPES)
N_TRAIN = sum(int(np.prod(s)) for s in TRAIN_SHAPES.values())  # 2042
N_STATE = sum(int(np.prod(s)) for s in STATE_SHAPES.values())  # 102


def init_train_params(rng: np.random.Generator) -> dict:
    """The initial trained arrays, drawn from `rng` in the reference's
    order: the three layers (weight, then bias), then emb0, then emb1."""
    def lin(key):
        n_out, n_in = TRAIN_SHAPES[key]
        bound = np.sqrt(1.0 / n_in)
        return (
            rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32),
            rng.uniform(-bound, bound, (n_out,)).astype(np.float32),
        )

    w1, b1 = lin("w1")
    w2, b2 = lin("w2")
    wo, bo = lin("wout")
    return {
        "emb0": (rng.standard_normal(TRAIN_SHAPES["emb0"]) * 0.01
                 ).astype(np.float32),
        "emb1": (rng.standard_normal(TRAIN_SHAPES["emb1"]) * 0.01
                 ).astype(np.float32),
        "w1": w1, "b1": b1, "w2": w2, "b2": b2, "wout": wo, "bout": bo,
        "bn_in_w": np.ones(9, np.float32),
        "bn1_w": np.ones(22, np.float32), "bn1_b": np.zeros(22, np.float32),
        "bn2_w": np.ones(20, np.float32), "bn2_b": np.zeros(20, np.float32),
    }


def init_bn_state() -> dict:
    return {k: (np.ones if k.endswith("_var") else np.zeros)(shp, np.float32)
            for k, shp in STATE_SHAPES.items()}


def export_inference_params(p: dict, state: dict, mean: np.ndarray,
                            std: np.ndarray) -> dict:
    """Fold the BN running statistics into the reference inference formula
    (no input-BN bias; scale and shift after the ReLU)."""
    eps = 1e-5
    in_sigma = np.sqrt(np.asarray(state["in_var"]) + eps)
    s1 = np.asarray(p["bn1_w"]) / np.sqrt(np.asarray(state["bn1_var"]) + eps)
    s2 = np.asarray(p["bn2_w"]) / np.sqrt(np.asarray(state["bn2_var"]) + eps)
    return {
        "emb0": np.asarray(p["emb0"]),
        "emb1": np.asarray(p["emb1"]),
        "w1": np.asarray(p["w1"]), "b1": np.asarray(p["b1"]),
        "w2": np.asarray(p["w2"]), "b2": np.asarray(p["b2"]),
        "wout": np.asarray(p["wout"]), "bout": np.asarray(p["bout"]),
        # (x - mean')/std' * bn_in == BN_nobias((x-mean)/std)
        "mean": mean + np.asarray(state["in_mu"]) * std,
        "std": std * in_sigma,
        "bn_in": np.asarray(p["bn_in_w"]),
        "bn1_w": s1,
        "bn1_b": np.asarray(p["bn1_b"]) - np.asarray(state["bn1_mu"]) * s1,
        "bn2_w": s2,
        "bn2_b": np.asarray(p["bn2_b"]) - np.asarray(state["bn2_mu"]) * s2,
    }


def split_flat(flat: torch.Tensor, shapes: dict) -> dict:
    """Views of `flat` (1-D), one per entry of `shapes`, in order."""
    out, o = {}, 0
    for k, shp in shapes.items():
        n = int(np.prod(shp))
        out[k] = flat[o : o + n].view(shp)
        o += n
    return out


def flatten_np(d: dict, shapes: dict) -> np.ndarray:
    for k, shp in shapes.items():
        if np.shape(d[k]) != shp:
            raise ValueError(f"{k}: shape {np.shape(d[k])}, expected {shp}")
    return np.concatenate([np.asarray(d[k], np.float32).reshape(-1)
                           for k in shapes])


class NNFMETrain(nn.Module):
    """The NN-FME MLP in training form: the 13 trained arrays as
    parameters (views of `flat`, 2042 floats) and the six BatchNorm
    running statistics as buffers (views of `state`, 102 floats). Built on
    its device by `from_numpy`; the training kernels update `flat` and
    `state` in place."""

    def __init__(self, flat: torch.Tensor, state: torch.Tensor):
        super().__init__()
        if flat.shape != (N_TRAIN,) or state.shape != (N_STATE,):
            raise ValueError(f"NNFMETrain: flat {tuple(flat.shape)}, state "
                             f"{tuple(state.shape)}")
        self.register_buffer("flat", flat, persistent=False)
        self.register_buffer("state", state, persistent=False)
        for k, v in split_flat(flat, TRAIN_SHAPES).items():
            self.register_parameter(k, nn.Parameter(v))
        for k, v in split_flat(state, STATE_SHAPES).items():
            self.register_buffer(k, v)

    @classmethod
    def from_numpy(cls, params: dict, state: dict, device
                   ) -> "NNFMETrain":
        """From the JAX package's dicts (`init_train_params`'s 13 keys and
        `init_bn_state`'s 6), as numpy arrays, on `device` (named by the
        caller: no default)."""
        flat = torch.as_tensor(flatten_np(params, TRAIN_SHAPES), device=device)
        st = torch.as_tensor(flatten_np(state, STATE_SHAPES), device=device)
        return cls(flat, st)

    def to_numpy(self) -> tuple[dict, dict]:
        """-> (params, state): the JAX package's dicts of numpy arrays."""
        flat = self.flat.detach().cpu().numpy()
        st = self.state.detach().cpu().numpy()
        return ({k: v.numpy().copy() for k, v in split_flat(
                    torch.from_numpy(flat), TRAIN_SHAPES).items()},
                {k: v.numpy().copy() for k, v in split_flat(
                    torch.from_numpy(st), STATE_SHAPES).items()})


def train_forward(p: dict, state: dict | None, x: torch.Tensor,
                  hcat: torch.Tensor, wcat: torch.Tensor, train: bool,
                  masks=None, dropouts=(0.001, 0.01), momentum=0.1,
                  stats: dict | None = None):
    """Plain training forward with live BatchNorm (twin of
    `tpuhevc/models/nnfme.py:245-287`). p: the 13 trained arrays as
    tensors; state: the six running statistics (or None in training mode:
    no running update); x (B, 9) mapper-normalised SADs; hcat, wcat (B,)
    embedding rows; masks: None or the two dropout keep masks (B, 22),
    (B, 20) as 0/1 floats, applied in training mode and scaled by
    1/(1 - p); stats: a dict that receives the batch statistics (the
    `STATE_KEYS`). Returns (logits (B, 49), new_state)."""
    eps = 1e-5
    new = {} if state is None else dict(state)

    def bn(h, key, w, b):
        if train:
            mu = h.mean(0)
            d = h - mu
            var = (d * d).mean(0)  # biased (ddof 0), as jnp.var
            if stats is not None:
                stats[key + "_mu"], stats[key + "_var"] = (mu.detach(),
                                                           var.detach())
            if state is not None:
                new[key + "_mu"] = ((1 - momentum) * state[key + "_mu"]
                                    + momentum * mu.detach())
                new[key + "_var"] = ((1 - momentum) * state[key + "_var"]
                                     + momentum * var.detach())
        else:
            mu, var = state[key + "_mu"], state[key + "_var"]
        y = (h - mu) / torch.sqrt(var + eps) * w
        return y if b is None else y + b

    xn = bn(x, "in", p["bn_in_w"], None)  # the input BN has no bias
    inp = torch.cat([p["emb0"][hcat], p["emb1"][wcat], xn], dim=-1)
    h = torch.relu(inp @ p["w1"].T + p["b1"])
    h = bn(h, "bn1", p["bn1_w"], p["bn1_b"])
    if train and masks is not None:
        h = h * masks[0] / (1 - dropouts[0])
    h = torch.relu(h @ p["w2"].T + p["b2"])
    h = bn(h, "bn2", p["bn2_w"], p["bn2_b"])
    if train and masks is not None:
        h = h * masks[1] / (1 - dropouts[1])
    return h @ p["wout"].T + p["bout"], new
