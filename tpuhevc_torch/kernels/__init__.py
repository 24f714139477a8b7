"""Hand-written CUDA kernels (sm_90a) of the port, and their launch counts.

Each kernel lives in `csrc/<name>.cu` with a plain C entry point; `build`
compiles it with nvcc on first use and binds it with ctypes. The wrapper
that launches a kernel lives beside the op's plain PyTorch version
(`ops/me.py`, `models/nnfme.py`, `ops/interp.py`, `ops/txq.py`,
`ops/intra.py`, `ops/cost.py`, `ops/intra_txq.py`, `entropy/bitest.py`)
and adds one to `LAUNCHES[name]` for every launch, and nowhere else.
"""

from __future__ import annotations

KERNELS = ("sad_search", "nnfme_mlp", "mc_blk", "txq",
           "intra_bank", "satd35_topk", "intra_txq", "tu_bits",
           "b_me", "b_pred", "b_txq")

LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
