"""Hand-written CUDA kernels (sm_90a) of the port, and their launch counts.

Each kernel lives in `csrc/<source>.cu` with a plain C entry point (the
grid step's `grid_me.cu` holds four, `grid_pred.cu` four); `build`
compiles a source with nvcc on first use and binds it with ctypes. The
wrapper that launches a kernel lives beside the op's plain PyTorch version
(`ops/me.py`, `models/nnfme.py`, `ops/interp.py`, `ops/txq.py`,
`ops/intra.py`, `ops/cost.py`, `ops/intra_txq.py`, `entropy/bitest.py`,
`ops/grid_me.py`, `ops/grid_pred.py`, `ops/grid_code.py`,
`ops/grid_intra.py`, `ops/grid_deblock.py`, `ops/grid_sao.py`,
`ops/grid_stats.py`, `ops/intra_wave.py`, `ops/stripe_prescreen.py`,
`ops/fme_train.py`) and
adds one to `LAUNCHES[name]` for every launch, and nowhere else
(`sad_search` launches once a P picture of the LD-P scan or the P stage
for all its CU classes, `mc_blk` and `txq` once each for all their Y, U
and V planes; at 10 bits they count as `sad_search10`, `mc_blk10` and
`txq10`, `intra_txq` as `intra_txq10`, the B step's `b_me`, `b_pred`
and `b_txq` as `b_me10`, `b_pred10` and `b_txq10`, and `intra_wave` as
`intra_wave10`: the 10-bit variants of the same sources;
`grid_deblock` once a picture, both edge directions;
`grid_code` once for the planes of one class coding; `grid_satd_cost`
once for up to eight fields of CU costs; `grid_coarse` and
`grid_prestage` once each a P picture (a stripe); `grid_subpel` once a
P picture (a stripe) for all its classes; `grid_refine` once a
block size a P picture, over every reference searched; `intra_txq` once a
class of TUs, all its candidates;
`b_pred` and `b_txq` once a B picture each, its three planes;
`grid_sao` twice, its stats and its apply, with `grid_sao_decide` between
them (on row stripes: stats and apply a stripe, the decision once);
`intra_wave` once for a whole batch of pictures; `stripe_prescreen` once
a device, over the row stripes it holds; `fme_train_fwd`,
`fme_train_bwd` and `fme_adam` once a training step each). Shared device code sits in `csrc/*.cuh`.
"""

from __future__ import annotations

# kernel name -> its source file (csrc/<source>.cu)
SOURCE_OF = {"sad_search": "sad_search", "nnfme_mlp": "nnfme_mlp",
             "mc_blk": "mc_blk", "txq": "txq", "intra_bank": "intra_bank",
             "satd35_topk": "satd35_topk", "intra_txq": "intra_txq",
             "tu_bits": "tu_bits", "b_me": "b_me", "b_pred": "b_pred",
             "b_txq": "b_txq", "grid_coarse": "grid_me",
             "grid_prestage": "grid_me", "grid_refine": "grid_me", "grid_planes": "grid_pred",
             "grid_satd": "grid_pred", "grid_satd_cost": "grid_pred",
             "grid_code": "grid_code",
             "grid_intra16": "grid_intra", "grid_deblock": "grid_deblock",
             "grid_sao": "grid_sao", "grid_sao_decide": "grid_sao",
             "grid_subpel": "grid_pred",
             "grid_wp_me": "grid_me", "grid_stats": "grid_stats",
             "intra_wave": "intra_wave",
             "stripe_prescreen": "stripe_prescreen",
             "fme_train_fwd": "fme_train", "fme_train_bwd": "fme_train",
             "fme_adam": "fme_train",
             # the 10-bit variants (Main10), in the same sources
             "sad_search10": "sad_search", "mc_blk10": "mc_blk",
             "txq10": "txq", "intra_txq10": "intra_txq",
             "b_me10": "b_me", "b_pred10": "b_pred", "b_txq10": "b_txq",
             "intra_wave10": "intra_wave"}
KERNELS = tuple(SOURCE_OF)
SOURCES = tuple(dict.fromkeys(SOURCE_OF.values()))

LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
