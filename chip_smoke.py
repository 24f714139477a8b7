#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (tpuhevc_torch) on one card.

    python3 chip_smoke.py

1. Needs CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds every kernel from tpuhevc_torch/kernels/csrc with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it at 416x240: the LD-P scan kernels at the
   CU classes c32/c16/cf plus the 8x8 luma / 4x4 chroma class of sizes
   that are not 16-aligned, K1 every class in one launch
   (`sad_search_classes`, reading the windows from the reference plane)
   with row subsampling on and off (the per-frame P stage's search) at
   lam_me 0 and the path's, K3 and K4 every class's Y, U and V in one
   launch each (`mc_blk_planes`, `txq_planes`; K4 at the path's QPs and
   at QP 50), each torch.equal, K3 also on adversarial MVs at 416x240
   (the six PU sizes, every phase of both signs, windows clamped at each
   edge) and at every call of the 112x72 LD-P scan (its four classes);
   K1's, K3's and K4's device time a P picture and bound printed, and
   beside K1
   torch.cdist (p=1) of the classes' PUs against their unfolded windows
   (the library time); the intra decision kernels at every call of the
   decision (both passes) of one all-intra picture and of one LD-P IDR,
   captured from the decision itself (every output torch.equal, tu_bits'
   exact sums too; intra_bank's, satd35_topk's and tu_bits' device time
   a picture and bound printed,
   intra_bank's beside torch's fill_ of its outputs), then intra_bank and
   tu_bits on adversarial inputs at every S at 1920x1088 (flat
   references at the strong-smoothing threshold's edges, references at 0
   and the maximum at bit depths 8 and 10; all-zero, DC-only,
   last-position and 2^15-escape TUs), two launches of each back to back;
   the B step kernels (b_me, b_pred,
   b_txq) at every call of one random-access B picture (b_pred and b_txq
   a picture's three planes in one launch each, their device time and
   bound printed; then their one-plane entries at that picture's luma and
   U, each launch's device time printed), b_me also alone on
   that picture's planes at sr 4 and 16 (each launch's device time) and
   on flat planes at lambda 0 (every cost ties), and torch.cdist (p=1) of
   its blocks against their unfolded windows (the SAD surface only, the
   library time); the grid step
   kernels (grid_coarse, grid_prestage (the +-64 prestage's pick on the
   card; both also at every call of the dctif + WP picture, of bench.py's
   cfg and of the 3 stripes), grid_refine (one launch a block size over every
   reference: the starts reference-major, the reference merge on the
   card), grid_planes (also beside
   torch.nn.functional.conv2d of its sums, the library time; grid_coarse
   and grid_refine beside torch.cdist (p=1) of their SAD stack and
   surfaces, grid_satd beside one advanced-index gather a call, each
   library call's values checked against the kernel's and its event and
   device time printed beside the kernel's), grid_satd's gathers, grid_satd_cost (the DC-aware CU costs and the
   rect trial's sums: every CU class, both modes, the merge trial's three
   candidates in one launch; torch.equal), grid_code with RDOQ and sign
   hiding, grid_intra16, grid_deblock, grid_sao) at every call of one
   416x240 P picture of the anchor LD-P cfg as shipped (four references,
   TMVP candidates), captured from the port's grid step (grid_code's,
   grid_satd's, grid_satd_cost's, grid_refine's and grid_intra16's calls
   under sync debug mode "error": lambda and the cbf bits are read on the
   card, so no call syncs the stream; so is the motion search from its
   first grid_coarse launch to its first grid_planes launch, the global
   start and every reference's starts kept on the card; the event time
   a picture of grid_satd's and grid_satd_cost's
   calls together; grid_code's
   device time a picture by events around 20 pictures' calls queued
   behind a device sleep; a grid_code call codes a class coding's planes
   in one launch), and grid_code again at every call of the same picture
   with the tools cut (the flat quantiser); grid_subpel (the picture's
   three classes in one launch, `grid_subpel_classes`), grid_wp_me (its
   device time and bound printed; also on 1 and 4 references, stripe-
   shaped stacks at d 0 and 7, negative weights and offsets clipping at
   both ends, two launches back to back),
   grid_stats and the weighted grid_planes, grid_refine and grid_intra16
   at every call of one 416x240 P picture of the anchor cfg with FmeMode
   dctif, WeightedPredP 1, the
   checksum hash and no recon fetch, on the fade clip (some weights not
   the identity), grid_subpel also at every call of that picture through
   the sharded step in 3 stripes (a launch a stripe) and the single one;
   intra_wave (fixed-8x8 intra of whole pictures) on 3 frames of the
   416x240 clip at QP 32 and at the graft entry's shape (192x128, QP 32,
   planes from np.random.default_rng(0)), both with the recon planes on
   chip (416x240 in a cluster of 4 blocks a frame, 192x128 one block),
   and on 1 frame of an 832x480 clip,
   whose planes do not fit on chip (the variant that keeps them in device
   memory), all seven outputs; its shared-memory bytes as the C entry
   gives them against the wrapper's at 104x72, 192x128, 416x240, 832x480
   and 1920x1088, at bit depths 8 and 10.
   grid_refine's split S = 32 launch and grid_sao_decide of the anchor
   and the fade picture on two streams of one card without a sync between
   (each stream's own ticket scratch), each equal to plain.
   grid_sao_decide (the SAO decision, the launch between grid_sao's two:
   a warp a CTU component, the picture's choice in the last block) at
   every call of the same anchor P picture, its rows and the SAO'd
   planes exact, and its device time (events around 100 calls queued
   behind a device sleep); K2 over the grid's three classes of that
   picture in one launch (nn_refine_classes: the offsets equal to plain
   wherever the plain top-2 gap exceeds 1e-3; its event and device time);
   both again at every call of a weighted fade-clip picture with NN-FME
   (WeightedPredP 1) and of the 3-stripe step below, grid_sao_decide also
   at the dctif + WP picture's; grid_sao's stats launch and grid_sao whole
   at every call of the anchor, the dctif + WP and bench.py's cfg's P
   picture and grid_stats at the latter two's (each stats launch's
   device time a picture printed), then both stats kernels on noise,
   flat and one-band planes at 416x240 (grid_sao at CTU 64, 32 and 16,
   both on the 3 stripes' rows), grid_stats on a 1920x1088 picture (its
   luma SSE above 2^31), two launches of each back to back and grid_stats
   on two streams without a sync between (its scratch and ticket are
   kept per stream); grid_deblock (one launch a picture over owned tiles)
   at every call of the anchor, the dctif + WP and bench.py's cfg's P
   picture and of the 3 stripes' halo buffers, one launch a call, its
   device time a picture and bound printed, then on adversarial inputs
   (flat 8x8 blocks with steps: the strong filter; noise; every cell
   intra; RQT depth 2 at CU 32; far motion at every edge) at QP 22, 37
   and 51 at 416x240 and on a 128-row stripe-shaped buffer, at
   1920x1088, two launches back to back; satd35_topk (Hadamard teams, a
   warp's top-nc) on flat references (ties) and noise at S = 4..32 with
   nc 1, 8 and 35, and at S = 4 over 1920x1088 (130,560 blocks), its
   device time a decision picture and bound printed;
   stripe_prescreen (the multi-device path's intra
   prescreen, one launch a device over its stripes) at its 3 calls: 416x240
   in 1 and 3 stripes and the graft entry's dryrun shape (128x128 in 2),
   the 3-stripe call's time, device time and bound printed, then on
   adversarial inputs (width 72: a run of 4 blocks ending one block into
   its last; bit depth 10; flat planes at 0 and the maximum; a halo row;
   8 stripes; 1920x1088 in 17 stripes, its device time printed); grid_refine with
   ry_y0 at every call of the 3-stripe refine at 416x240; the launches
   that take a row origin at every call of one 416x240 anchor P picture
   through the sharded grid step in 3 stripes (grid_refine with each
   stripe's ry_y0, grid_intra16 with y0,
   grid_planes from each stripe's row in its carried reference rows,
   grid_sao's stats and apply with their halo rows, grid_stats' partial
   sums without the recon fetch), and the bound of that sharded step and
   of the single one (each kernel's bound summed, plus the exchanged
   bytes).
   Prints the max difference, median times (CUDA events), and each
   kernel's bound: the larger of its bytes (each tensor read or written
   once per picture; a plane that a kernel reads through windows or
   gathers, only the samples read, their union over the calls) over
   3.35 TB/s and its operations over 67 T/s.
4. Main path 1, LD-P: encodes a 416x240, 17-frame synthetic clip through
   the port's encode_sequence (the anchor LD-P cfg as shipped: four
   references, SearchRange 64, QuadtreeTUMaxDepthInter 3, TMVP, RDOQ,
   sign hiding, deblocking and SAO; QP 32, FmeMode nn with seeded
   weights), which takes the grid step (416x240 is whole 16x16 blocks),
   with the launch counters reset just before; the nine grid kernels, K2
   and grid_deblock (each once a P picture: 16 launches) and the intra
   kernels (the IDR's decision) must have launched (grid_deblock once a
   P picture on paths 4 and 5 too). Main path 2, all-intra: 3 pictures
   of the same clip with cfg/encoder_intra_main.cfg (RDOQ, NxN), counters
   reset just before; the four intra kernels must have launched. Main path
   3, random access: cfg/encoder_randomaccess_main.cfg as shipped at
   416x240, 18 frames (IDR, four GOPs of hierarchical B pictures, POC 17
   as the P tail), once to warm up and once with the counters reset just
   before; b_me, b_pred, b_txq and K1-K4 must have launched, the first
   three once a B picture each, and on no other path; its P picture
   launches K1, K3 and K4 once each (every class in the launch; K2 17
   over the encode: a B picture's and the P picture's classes in one),
   each torch.equal to plain at those calls; paths 1, 2 and 6 launch
   none of them. Main path 4,
   LD-P with DCT-IF FME and weighted prediction: the anchor cfg with
   FmeMode dctif and WeightedPredP 1 on 17 frames of the fade clip
   (`make_fade_clip`), counters reset just before; the grid kernels with
   grid_subpel (once a P picture, and on no path without dctif) and
   grid_wp_me must have launched, some MV must be
   fractional and some slice's weights not the identity. Main path 5,
   bench.py's configuration (the anchor cfg at QP 32, four references,
   FmeMode nn without weights, the checksum hash, no recon fetch) on
   bench.py's clip (`make_clip(416, 240, 32)`) with bench.py's procedure
   (a 6-frame warm-up, then the best of 4 timed encodes, counters reset
   before each): grid_stats must have launched, the rows carry no recon.
   Main path 6, all-intra with fixed 8x8 intra: cfg/encoder_intra_main.cfg
   with intra_qt off, 8 pictures through encode_sequence(...,
   device_batch=4), counters reset just before: intra_wave must have
   launched twice (one launch a batch) and no other kernel. Paths 1-5 must
   not launch intra_wave. Paths 1, 4 and 5 must decide SAO on the card:
   the plain `ops.grid_sao.sao_decide` is called 0 times, grid_sao
   launches twice (stats, apply) and grid_sao_decide once a P picture.
   Main path 7, the multi-device path on a mesh of n x cuda:0 (one card
   runs the stripes in turn; no scaling figure), counters reset just
   before: tile_prescreen at 416x240 over 3 stripes equals it over 1
   off the last block rows of stripes 0 and 1; stripe_refine at 416x240
   over 3 stripes (80 rows, over the 40-row halo; the coarse winners of
   frame 1 against frame 0) equals the single refine; encode_segments_
   overlapped on 16 frames of the anchor LD-P cfg in 2 segments decodes
   hash-OK and equals the segments' own encode_sequence streams with the
   repeated parameter sets dropped; dryrun_multichip(2, "cuda") (steps
   2, 2b, 2c, 3); the grid step on row stripes: the anchor cfg uncut at
   416x240 in 3 stripes (64, 64, 112 rows), 16 P pictures chained from
   the IDR's recon through sharded_frame_step and, on the same carry,
   the single step: every packed row and carry equal, the sharded step
   launching each grid kernel 3 times as often (grid_sao_decide as
   often); the halo bytes and both times a picture printed;
   stripe_prescreen (once a tile_prescreen call: 4), grid_refine and the
   grid kernels must have launched. Decodes every stream with the port's host decoder: every picture hash
   must match and, where the recon was fetched, equal the encoder's.
   Cross-checks CUDA against the CPU path (bitstreams byte-identical) at
   112x72 for LD-P (the non-grid scan: K1-K4) and all-intra, at 128x64 x
   9 for LD-P through the grid step (the anchor's tools on, and cut; with
   dctif and WP on the fade clip; bench.py's no-fetch configuration), at
   64x48 x 6 for random access, and with fixed 8x8 intra at 104x72 x 3
   all-intra with device_batch=2 and at 112x72 x 3 LD-P (its IDR).
   Main path 8, NN-FME training: the dataset extraction from
   make_clip(416, 240, 17) at QP 32, SearchRange 16 (host numpy; 6,240
   samples), train_fme at the full TrainConfig on the card (200 epochs of
   5 batches of 1,024: 1,000 steps, counters reset just before; each of
   fme_train_fwd, fme_train_bwd and fme_adam must launch once a step and
   the last epoch's mean loss must be below the first's), the export to
   an npz, and the anchor LD-P cfg at 416x240 x 17 encoded with it (K2
   must launch, every picture hash OK); its kbit and Y-PSNR printed
   beside path 1's (seeded weights) and an FmeMode dctif encode of the
   same clip. Before it, the three train-step kernels are held against
   their plain versions on the extracted data at B = 1,024 (the first
   batch of the first epoch, the initial weights of train_fme): the
   forward (logits, loss, batch and running statistics), the backward
   (autograd of the plain forward, the same dropout masks), Adam (the
   same gradient), 20 whole steps of train_fme's own step
   (`models.fme_train.train_step`) against plain from the same start,
   two such runs of 20 steps bit for bit, and equal to 20 steps through
   the autograd Function FmeTrainLoss (the data and sizes of
   `tpuhevc_torch/profile_path.py`'s `fme_dataset`, `train_inputs`); each train-step
   kernel (and torch._fused_adam_ beside fme_adam) also timed by its
   device_ms (events around 200 launches queued behind a device sleep,
   over 200; the forward and the backward as train_step calls them,
   into their bindings' buffers) and the forward's and the backward's
   launch geometry printed (and, after the build, every source's ptxas
   report: entry function, registers, spills).
   Main path 9, the per-picture P path with the host tool stage (each
   encode with the counters reset just before, decoded hash-OK): the
   anchor LD-P cfg as shipped at 1920x1080 x 2 (off the grid: the IDR
   decided on the card, the intra kernels launched; the P picture
   through the host stage, its seconds printed; no grid kernel, K1, K3 or
   K4); IntraPeriod 4 with the tools at 416x240 x 9 (I pictures at 0, 4,
   8; six P pictures through the host stage); the random-access cfg with
   RDOQ, sign hiding, deblocking and SAO at 416x240 x 10 (b_txq once a B
   picture in its sign-hiding variant, each launch torch.equal to plain,
   its device time beside the variant without hiding and its bound
   printed; the P tail through the host stage); random access without a
   GOP table (`_ra_gop4`) at 416x240 x 9 (K1, K3 and K4 once a key P
   picture, the B step 3 times a GOP); rate control at picture level (the
   tools cut: the P pictures through the device stage, K1-K4) and at CTU
   level (the anchor as shipped, a QP map a P picture: the host stage) at
   416x240 x 5, target and achieved bits printed. Then CUDA against CPU
   streams byte-identical for these routes (the anchor at 112x72 x 4, the
   others at 64x48 x 6).
   Main path 10, Main10 (`--InputBitDepth=10 --InternalBitDepth=10`) on
   the 416x240 clip at 10 bits (each 8-bit plane x 4 plus an offset, as
   tests/test_main10.py makes it), QP 32, each encode with the counters
   reset just before and read just after, every hash OK in the port's
   decoder with the encoder's recon and luma samples above 255: the
   all-intra cfg x 2, the LD-P scan with the anchor's tools cut x 9
   (seeded NN-FME weights), IntraPeriod 4 with the tools cut x 5 (the
   per-picture device stage) and the anchor cfg as shipped x 3 (the host
   tool stage). The 10-bit variants of K1, K3, K4 and intra_txq (the
   counters `sad_search10`, `mc_blk10`, `txq10`, `intra_txq10`) and
   intra_bank must launch where the route runs them, the 8-bit ones stay
   idle, and every call of them is held against its plain version with
   torch.equal; K1's, K3's and K4's time, device time and bound at the
   device stage's first P picture (K1 beside torch.cdist, its samples
   counted at 2 bytes), intra_txq's over one all-intra picture's
   decision, both passes. Then CUDA against CPU streams byte-identical
   for these four routes at 112x72. Then random access at 10 bits
   (`run_ra10`): the random-access cfg with its GOP table x 9, without
   it (`_ra_gop4`: the key P pictures through the 10-bit K1, K3 and K4)
   x 9, and with RDOQ, SBH, deblocking and SAO x 10; every hash OK,
   `b_me10`, `b_pred10` and `b_txq10` once a B picture and the 8-bit B
   kernels idle, every call of them (and the key P pictures' K1, K3, K4)
   held against plain with torch.equal; their device time and bound a B
   picture (samples at 2 bytes), `b_txq10`'s SBH variant beside it and
   `b_me10` beside torch.cdist; CUDA against CPU streams byte-identical
   for these three routes at 64x48 x 6. Then fixed 8x8 intra at 10 bits
   (`run_main10_intra8`, intra_qt off): all-intra at 416x240 x 4 with
   device_batch=4 (one launch; the 16-bit planes do not fit on chip: the
   recon in device memory), all-intra at 192x128 x 4 a picture at a time
   (the recon on chip) and the LD-P scan with the tools cut x 3 (its IDR);
   every hash OK with luma above 255, `intra_wave10` launched where the
   route runs it and `intra_wave` (and the quadtree decision) idle, every
   call of it torch.equal to plain; its device time a launch and a wave
   at 416x240 x 4, 192x128 x 4 and 256x240 x 4 (its on-chip cluster
   variant, held against plain there) beside the 8-bit kernel's on the
   8-bit clip, and its bound (samples at 2 bytes); CUDA against CPU streams
   byte-identical for all-intra at 112x72 x 3 (device_batch=2) and the
   LD-P scan at 64x48 x 3.
5. Prints the kernels' JSON line, the card's name and power limit, and as
   the last line {"ok": true, "device": {...}}. Any failure raises (exit
   != 0).
"""

import dataclasses
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from tools.make_test_clip import make_clip, make_fade_clip  # noqa: E402
from tpuhevc_torch.codec import encoder as encoder_mod  # noqa: E402
from tpuhevc_torch.codec import (  # noqa: E402
    inter_b, inter_batch, inter_enc, inter_grid, intra_decide, intra_frame)
from tpuhevc_torch.codec.decoder import decode_stream  # noqa: E402
from tpuhevc_torch.codec.encoder import encode_sequence  # noqa: E402
from tpuhevc_torch.codec.inter_batch import _blk_idx, _positions  # noqa: E402
from tpuhevc_torch.codec.intra_frame import _sqlam_fp, wave_tables  # noqa: E402
from tpuhevc_torch.codec.intra_decide import decide_intra_qt  # noqa: E402
from tpuhevc_torch.codec.params import EncoderConfig, SeqParams, p_frame_lambda  # noqa: E402
from tpuhevc_torch.codec.recon import _pad_to  # noqa: E402
from tpuhevc_torch.codec.wp import analyse_slice_wp  # noqa: E402
from tpuhevc_torch.config.options import build_config, parse_args  # noqa: E402
from tpuhevc_torch.device import require_cuda  # noqa: E402
from tpuhevc_torch.entropy import bitio  # noqa: E402
from tpuhevc_torch.codec.intra_qt import I_ROW  # noqa: E402
from tpuhevc_torch.entropy.bitest import (  # noqa: E402
    FracBits, est_tables, tu_bits, tu_bits_plain)
from tpuhevc_torch.kernels import KERNELS, LAUNCHES, reset_launches  # noqa: E402
from tpuhevc_torch.kernels import build as kbuild  # noqa: E402
from tpuhevc_torch.models.fme_train import train_fme, train_step  # noqa: E402
from tpuhevc_torch.models.nnfme import (  # noqa: E402
    N_TRAIN, NNFME, TrainConfig, height_category, nn_refine,
    nn_refine_classes, nn_refine_classes_plain, nn_refine_plain,
    random_params, save_npz, width_category)
from tpuhevc_torch.ops import fme_train as ft  # noqa: E402
from tpuhevc_torch.ops.cost import satd35_topk, satd35_topk_plain  # noqa: E402
from tpuhevc_torch.ops.grid_code import (  # noqa: E402
    grid_code_batch, grid_code_batch_plain)
from tpuhevc_torch.ops.grid_deblock import (  # noqa: E402
    boundary_strength, grid_deblock, grid_deblock_plain, tu_cells)
from tpuhevc_torch.ops.grid_intra import grid_intra16, grid_intra16_plain  # noqa: E402
from tpuhevc_torch.ops.grid_me import (  # noqa: E402
    grid_coarse, grid_coarse_plain, grid_prestage, grid_prestage_plain,
    grid_refine, grid_refine_plain, grid_refine_refs, grid_refine_refs_plain,
    grid_wp_me, grid_wp_me_plain, tile_sum)
from tpuhevc_torch.ops.grid_pred import (  # noqa: E402
    field_cells, grid_mc, grid_mc_plain, grid_planes, grid_planes_plain,
    grid_satd_cost, grid_satd_cost_plain, grid_subpel_classes,
    grid_subpel_classes_plain, subpel_search)
from tpuhevc_torch.ops.interp import CHROMA_TAPS, LUMA_TAPS  # noqa: E402
from tpuhevc_torch.ops import grid_sao as grid_sao_mod  # noqa: E402
from tpuhevc_torch.ops.grid_sao import (  # noqa: E402
    grid_sao, grid_sao_apply, grid_sao_apply_plain, grid_sao_decide,
    grid_sao_decide_plain, grid_sao_plain, grid_sao_stats,
    grid_sao_stats_plain)
from tpuhevc_torch.ops.stripe_prescreen import (  # noqa: E402
    stripe_prescreen_rows, stripe_prescreen_rows_plain)
from tpuhevc_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpuhevc_torch.parallel import segments  # noqa: E402
from tpuhevc_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from tpuhevc_torch.profile_path import (  # noqa: E402
    STEP_CUT, TRAIN_FRAMES, TRAIN_H, TRAIN_QP, TRAIN_SR, TRAIN_STEPS_CHECKED,
    TRAIN_W, device_ms, fme_dataset, train_inputs)
from tpuhevc_torch.ops.grid_stats import (  # noqa: E402
    grid_stats, grid_stats_partial, grid_stats_partial_plain,
    grid_stats_plain)
from tpuhevc_torch.ops.interp import (  # noqa: E402
    b_pred, b_pred_plain, b_pred_yuv, b_pred_yuv_plain, mc_blk_planes,
    mc_blk_planes_plain)
from tpuhevc_torch.ops.intra import intra_bank, predict_all_modes_plain  # noqa: E402
from tpuhevc_torch.ops.intra_txq import intra_txq, intra_txq_plain  # noqa: E402
from tpuhevc_torch.ops.intra_wave import (  # noqa: E402
    WaveTables, intra_wave, intra_wave_plain, wave_smem, wave_variant)
from tpuhevc_torch.ops.me import (  # noqa: E402
    _b_tables, b_me, b_me_plain, bits_table, sad_search_classes,
    sad_search_classes_plain, window_index)
from tpuhevc_torch.ops.txq import (  # noqa: E402
    b_txq, b_txq_plain, b_txq_planes, b_txq_planes_plain, txq_planes,
    txq_planes_plain)
from tpuhevc_torch.utils.tables import chroma_qp  # noqa: E402

SOURCES = {
    "sad_search": ("tpuhevc_torch/kernels/csrc/sad_search.cu",
                   "tpuhevc/codec/inter_batch.py:139"),
    "nnfme_mlp": ("tpuhevc_torch/kernels/csrc/nnfme_mlp.cu",
                  "tpuhevc/models/nnfme.py:176"),
    "mc_blk": ("tpuhevc_torch/kernels/csrc/mc_blk.cu",
               "tpuhevc/codec/inter_batch.py:166"),
    "txq": ("tpuhevc_torch/kernels/csrc/txq.cu",
            "tpuhevc/codec/inter_batch.py:193"),
    "intra_bank": ("tpuhevc_torch/kernels/csrc/intra_bank.cu",
                   "tpuhevc/ops/intra.py:197"),
    "satd35_topk": ("tpuhevc_torch/kernels/csrc/satd35_topk.cu",
                    "tpuhevc/codec/intra_decide_jax.py:75"),
    "intra_txq": ("tpuhevc_torch/kernels/csrc/intra_txq.cu",
                  "tpuhevc/codec/intra_decide_jax.py:86"),
    "tu_bits": ("tpuhevc_torch/kernels/csrc/tu_bits.cu",
                "tpuhevc/entropy/bitest.py:286"),
    "b_me": ("tpuhevc_torch/kernels/csrc/b_me.cu",
             "tpuhevc/codec/inter_b.py:142"),
    "b_pred": ("tpuhevc_torch/kernels/csrc/b_pred.cu",
               "tpuhevc/codec/inter_b.py:196"),
    "b_txq": ("tpuhevc_torch/kernels/csrc/b_txq.cu",
              "tpuhevc/codec/inter_b.py:181"),
    "grid_coarse": ("tpuhevc_torch/kernels/csrc/grid_me.cu",
                    "tpuhevc/codec/inter_grid.py:650"),
    "grid_prestage": ("tpuhevc_torch/kernels/csrc/grid_me.cu",
                      "tpuhevc/codec/inter_grid.py:2395"),
    "grid_refine": ("tpuhevc_torch/kernels/csrc/grid_me.cu",
                    "tpuhevc/codec/inter_grid.py:681"),
    "grid_planes": ("tpuhevc_torch/kernels/csrc/grid_pred.cu",
                    "tpuhevc/codec/inter_grid.py:862"),
    "grid_satd": ("tpuhevc_torch/kernels/csrc/grid_pred.cu",
                  "tpuhevc/codec/inter_grid.py:912"),
    "grid_satd_cost": ("tpuhevc_torch/kernels/csrc/grid_pred.cu",
                       "tpuhevc/codec/inter_grid.py:983"),
    "grid_code": ("tpuhevc_torch/kernels/csrc/grid_code.cu",
                  "tpuhevc/codec/inter_grid.py:1718"),
    "grid_intra16": ("tpuhevc_torch/kernels/csrc/grid_intra.cu",
                     "tpuhevc/codec/inter_grid.py:2175"),
    "grid_deblock": ("tpuhevc_torch/kernels/csrc/grid_deblock.cu",
                     "tpuhevc/codec/inter_grid.py:1217"),
    "grid_sao": ("tpuhevc_torch/kernels/csrc/grid_sao.cu",
                 "tpuhevc/codec/inter_grid.py:1427"),
    "grid_sao_decide": ("tpuhevc_torch/kernels/csrc/grid_sao.cu",
                        "tpuhevc/codec/inter_grid.py:1377"),
    "grid_subpel": ("tpuhevc_torch/kernels/csrc/grid_pred.cu",
                    "tpuhevc/codec/inter_grid.py:1012"),
    "grid_wp_me": ("tpuhevc_torch/kernels/csrc/grid_me.cu",
                   "tpuhevc/codec/inter_grid.py:2352"),
    "grid_stats": ("tpuhevc_torch/kernels/csrc/grid_stats.cu",
                   "tpuhevc/codec/inter_grid.py:3170"),
    "intra_wave": ("tpuhevc_torch/kernels/csrc/intra_wave.cu",
                   "tpuhevc/codec/intra_jax.py:182"),
    "stripe_prescreen": ("tpuhevc_torch/kernels/csrc/stripe_prescreen.cu",
                         "tpuhevc/parallel/mesh.py:32"),
    "fme_train_fwd": ("tpuhevc_torch/kernels/csrc/fme_train.cu",
                      "tpuhevc/models/nnfme.py:355"),
    "fme_train_bwd": ("tpuhevc_torch/kernels/csrc/fme_train.cu",
                      "tpuhevc/models/nnfme.py:363"),
    "fme_adam": ("tpuhevc_torch/kernels/csrc/fme_train.cu",
                 "tpuhevc/models/nnfme.py:367"),
    # the 10-bit variants (Main10, path 10) of K1, K3, K4 and intra_txq
    "sad_search10": ("tpuhevc_torch/kernels/csrc/sad_search.cu",
                     "tpuhevc/codec/inter_batch.py:139"),
    "mc_blk10": ("tpuhevc_torch/kernels/csrc/mc_blk.cu",
                 "tpuhevc/codec/inter_batch.py:166"),
    "txq10": ("tpuhevc_torch/kernels/csrc/txq.cu",
              "tpuhevc/codec/inter_batch.py:193"),
    "intra_txq10": ("tpuhevc_torch/kernels/csrc/intra_txq.cu",
                    "tpuhevc/codec/intra_decide_jax.py:86"),
    # the B step's 10-bit variants (path 10's random-access routes)
    "b_me10": ("tpuhevc_torch/kernels/csrc/b_me.cu",
               "tpuhevc/codec/inter_b.py:142"),
    "b_pred10": ("tpuhevc_torch/kernels/csrc/b_pred.cu",
                 "tpuhevc/codec/inter_b.py:196"),
    "b_txq10": ("tpuhevc_torch/kernels/csrc/b_txq.cu",
                "tpuhevc/codec/inter_b.py:181"),
    # fixed-8x8 intra's 10-bit variant (path 10's fixed-8x8 routes)
    "intra_wave10": ("tpuhevc_torch/kernels/csrc/intra_wave.cu",
                     "tpuhevc/codec/intra_jax.py:182"),
}
# the NN-FME train step, once each a step
TRAIN_KERNELS = ("fme_train_fwd", "fme_train_bwd", "fme_adam")
INTRA = ("intra_bank", "satd35_topk", "intra_txq", "tu_bits")
B_KERNELS = ("b_me", "b_pred", "b_txq")
G_KERNELS = ("grid_coarse", "grid_prestage", "grid_refine", "grid_planes",
             "grid_satd", "grid_satd_cost", "grid_code", "grid_intra16",
             "grid_deblock", "grid_sao")
# the LD-P path at 416x240: the IDR's decision, the grid step and K2
LDP_NEED = INTRA + G_KERNELS + ("grid_sao_decide", "nnfme_mlp")
# the random-access path: the B step, the P tail's stage (K1-K4) and K2
RA_NEED = B_KERNELS + ("nnfme_mlp", "sad_search", "mc_blk", "txq")
# K1, K3 and K4: one launch each a P picture of the per-frame P stage
# (the random-access path's P tail), every CU class in it
P_ONCE = ("sad_search", "mc_blk", "txq")
# DCT-IF FME, weighted prediction and the no-fetch tail of the grid step
F_KERNELS = ("grid_subpel", "grid_wp_me", "grid_stats")
FME_WP = ["--FmeMode=dctif", "--WeightedPredP=1"]
NO_FETCH = ["--SEIDecodedPictureHash=3"]
# LD-P with dctif + WP: the IDR's decision, the grid step, its DCT-IF
# refinement and weighted ME references (no K2: no NN-FME)
FWP_NEED = INTRA + G_KERNELS + ("grid_sao_decide", "grid_subpel",
                                 "grid_wp_me")
# bench.py's configuration: FmeMode nn without weights runs integer-pel
BENCH_NEED = INTRA + G_KERNELS + ("grid_sao_decide", "grid_stats")
BENCH_FRAMES, BENCH_WARMUP, BENCH_REPS = 32, 6, 4  # bench.py's procedure
# fixed-8x8 all-intra: pictures, and pictures per launch
N_INTRA8, INTRA8_BATCH = 8, 4
INTRA_CFG = os.path.join(ROOT, "cfg", "encoder_intra_main.cfg")
RA_CFG = os.path.join(ROOT, "cfg", "encoder_randomaccess_main.cfg")
N_INTRA = 3  # all-intra pictures (the host walk dominates their time)
N_RA = 18  # IDR, four GOPs of B pictures, POC 17 as the P tail
W, H, NFRAMES, QP, SEED = 416, 240, 17, 32, 0
SR = 16
# one H100 SXM (NVIDIA's data sheet): HBM bytes/s; float32 (and int32)
# operations/s outside the tensor cores
HBM_BPS, SCALAR_OPS = 3.35e12, 67e12


def check(cond, what):
    """Fail the smoke run (works under python -O, unlike assert)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class Reader:
    def __init__(self, w, h, n, fade=False):
        raw = (make_fade_clip if fade else make_clip)(w, h, n)
        fsz = w * h * 3 // 2
        self.frames = []
        for i in range(n):
            b = np.frombuffer(raw[i * fsz : (i + 1) * fsz], np.uint8)
            self.frames.append((b[: w * h].reshape(h, w),
                                b[w * h : w * h * 5 // 4].reshape(h // 2, w // 2),
                                b[w * h * 5 // 4 :].reshape(h // 2, w // 2)))

    def read_frame(self, i):
        return self.frames[i] if i < len(self.frames) else None


def median_ms(fn, reps=25):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def tensors(x):
    """The tensors of a kernel's arguments or results (an estimator's
    tables and a model's packed weights included)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors(v)
    elif isinstance(x, NNFME):
        yield from tensors(x.packed)
    elif hasattr(x, "itab"):  # EstTables
        yield from (x.itab, x.ftab)
    elif isinstance(x, WaveTables):  # what the kernel reads of the schedule
        yield x.slots


def window_mask(plane, xs, ys, mvq, size, is_luma, sel=None):
    """The samples of `plane` that the blocks' interpolation needs: per
    block and axis, S samples at an integer phase, else the S + taps - 1
    around them, clamped at the picture's edge as the plane is read.
    sel: the blocks that read this plane (None: all)."""
    nt, off, fmask, fshift = (8, 3, 3, 2) if is_luma else (4, 1, 7, 3)
    hh, ww = plane.shape
    mask = np.zeros((hh, ww), bool)
    x = xs.cpu().numpy().astype(np.int64)
    y = ys.cpu().numpy().astype(np.int64)
    mv = mvq.cpu().numpy().astype(np.int64)
    pick = np.ones(len(x), bool) if sel is None else sel.cpu().numpy()
    for i in np.nonzero(pick)[0]:
        span = []
        for p, v, n in ((x[i], mv[i, 0], ww), (y[i], mv[i, 1], hh)):
            frac = v & fmask
            lo = p + (v >> fshift) - (off if frac else 0)
            hi = lo + size - 1 + (nt - 1 if frac else 0)
            span.append((min(max(lo, 0), n - 1), min(max(hi, 0), n - 1) + 1))
        (x0, x1), (y0, y1) = span
        mask[y0:y1, x0:x1] = True
    return mask


def refine_mask(ry, S, nbh, nbw, starts, ry_y0=0, sref=None):
    """The samples of `ry` (a plane, or a stack whose plane sref[g] start g
    reads) that grid_refine's clamped 7x7-search windows (S + 6 square
    around each start) read; ry_y0: ry's row level with the block rows'
    row 0 (a stripe's halo)."""
    stack = ry.dim() == 3
    hh, ww = ry.shape[-2:]
    mask = np.zeros((ry.shape[0] if stack else 1, hh, ww), bool)
    st = starts.cpu().numpy().astype(np.int64)
    pl = (np.zeros(st.shape[0], np.int64) if sref is None
          else sref.cpu().numpy().astype(np.int64))
    for g in range(st.shape[0]):
        for b in range(nbh * nbw):
            y0 = ry_y0 + (b // nbw) * S + st[g, b, 1] - 3
            x0 = (b % nbw) * S + st[g, b, 0] - 3
            ys = np.clip(np.arange(y0, y0 + S + 6), 0, hh - 1)
            xs = np.clip(np.arange(x0, x0 + S + 6), 0, ww - 1)
            mask[pl[g], ys.min() : ys.max() + 1,
                 xs.min() : xs.max() + 1] = True
    return mask if stack else mask[0]


def gather_mask(planes, mv, ref, cell, look):
    """The samples of the phase planes that grid_satd gathers (one per
    predicted pixel), as a mask of the planes' shape (on the card)."""
    _, P, _, hm, wm = planes.shape
    fb = P.bit_length() - 1
    mvp = mv.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    rp = ref.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    h, w = rp.shape[1:]
    yg = torch.arange(h, device=mv.device)[None, :, None]
    xg = torch.arange(w, device=mv.device)[None, None, :]
    idx = ((((rp * P * P + (mvp[..., 1] & (P - 1)) * P
              + (mvp[..., 0] & (P - 1))) * hm)
            + (mvp[..., 1] >> fb) + yg + look) * wm
           + (mvp[..., 0] >> fb) + xg + look)
    mask = torch.zeros(planes.numel(), dtype=torch.bool, device=mv.device)
    mask[idx.reshape(-1)] = True
    return mask.reshape(planes.shape)


def boundary_mask(plane, S, nh, nw, halves, y0=0):
    """The samples of `plane` that grid_intra16 reads around its S x S
    cells (from row y0): the row above (with the top-right segment) and
    the column to the left (with the bottom-left one), clamped, in each
    half."""
    hh, ww = plane.shape
    mask = np.zeros((hh, ww), bool)
    for ox in halves:
        for cy in range(nh):
            for cx in range(nw):
                by, bx = cy * S + y0, cx * S + ox
                ys = np.clip(np.arange(by - 1, by + 2 * S), 0, hh - 1)
                xs = np.clip(np.arange(bx - 1, bx + 2 * S), 0, ww - 1)
                mask[ys[0], xs] = True
                mask[ys, xs[0]] = True
    return mask


def windows(name, a, kw, out=None):
    """[(plane, samples read)] of one call (its results `out`) of a kernel
    that reads a plane through windows or gathers: K3 reads its plane,
    b_pred both lists' planes (with a given `inter_dir`, list k only for
    the blocks that use it; `b_pred_yuv` luma both lists, U and V as its
    inter_dir says), grid_refine its reference around each start,
    grid_satd the phase planes at its gathers, grid_intra16 the planes
    around each cell."""
    if name == "mc_blk":  # every job's plane (mc_blk_planes)
        return [(job[0], window_mask(*job)) for job in a[0]]
    if name == "b_pred" and isinstance(a[1], tuple):  # b_pred_yuv: luma
        # both lists, U and V the lists inter_dir (out[1]) uses
        xs, ys, m0, m1 = a[4:8]
        return [(ref, window_mask(ref, bx, by, mvq, size, size == 16,
                                  None if size == 16
                                  else (out[1] & k) != 0))
                for refs, bx, by, size in ((a[1], xs, ys, 16),
                                           (a[2], xs // 2, ys // 2, 8),
                                           (a[3], xs // 2, ys // 2, 8))
                for ref, mvq, k in zip(refs, (m0, m1), (1, 2))]
    if name == "b_pred":
        idir = kw.get("inter_dir", a[10] if len(a) > 10 else None)
        return [(ref, window_mask(ref, a[3], a[4], mvq, a[7], a[8],
                                  None if idir is None else (idir & k) != 0))
                for ref, mvq, k in ((a[1], a[5], 1), (a[2], a[6], 2))]
    if name in ("grid_refine", "grid_refine_one"):
        return [(a[0], refine_mask(a[0], a[2], a[3], a[4], a[5],
                                   a[11] if len(a) > 11
                                   else kw.get("ry_y0", 0),
                                   a[12] if len(a) > 12
                                   else kw.get("sref")))]
    if name == "grid_satd":  # a class coding's luma, then U and V
        planes_y, planes_c, mv8, ref8, look, look_c = a[:6]
        R = planes_y.shape[0]
        return [(planes_y, gather_mask(planes_y, mv8[None], ref8[None], 8,
                                       look)),
                (planes_c, gather_mask(planes_c, torch.stack([mv8, mv8]),
                                       torch.stack([ref8, ref8 + R]), 4,
                                       look_c))]
    if name == "grid_satd_cost":  # each field's CUs at their MVs
        planes, _, fields, look = a[:4]
        mask = None
        for fl in fields:
            mv, ref = field_cells(fl)
            m = gather_mask(planes, mv[None].contiguous(),
                            ref[None].contiguous(), fl.size, look)
            mask = m if mask is None else mask | m
        return [(planes, mask)]
    if name == "grid_intra16":
        nh, nw, y0 = a[4], a[5], kw.get("y0", 0)
        return [(a[0], boundary_mask(a[0], 16, nh, nw, (0,), y0)),
                (a[1], boundary_mask(a[1], 8, nh, nw,
                                     (0, a[1].shape[1] // 2), y0))]
    if name == "sad_search":  # the PUs' clamped windows
        ref, sr = a[0], a[4]
        hh, ww = ref.shape
        mask = np.zeros((hh, ww), bool)
        for cur, xs, ys in a[1]:
            S = cur.shape[1]
            for x, y in zip(xs.tolist(), ys.tolist()):
                mask[max(y - sr, 0) : y + S + sr, max(x - sr, 0) : x + S + sr] \
                    = True
        return [(ref, mask)]
    if name == "grid_subpel":  # each class's 18 points' gathers of this
        # run's data
        planes, oy, classes, look = a
        mask = None
        for mv, ref, S, nbh, nbw in classes:
            refc = ref.reshape(1, nbh, nbw).expand(9, -1, -1).contiguous()
            for cand in subpel_search(planes, oy, mv, ref, S, nbh, nbw,
                                      look)[1]:
                m = gather_mask(planes, cand, refc, S, look)
                mask = m if mask is None else mask | m
        return [(planes, mask)]
    return []


class Work:
    """Bytes and operations of a kernel's calls over one picture. Each
    tensor counts once, however many calls read it (each input read once,
    each output written once); a reference plane read through block
    windows counts the samples the windows cover, their union over the
    calls. Holds the tensors, so that no address is reused meanwhile."""

    def __init__(self, sample_bytes=None):
        self.held = {}  # data_ptr -> tensor
        self.planes = {}  # data_ptr -> (plane, samples read)
        self.ops = 0
        self.written = 0  # outputs written into a kept buffer, per call
        # with sample_bytes: the samples K1 reads (the windows' union and
        # the PUs), and those the B kernels and intra_wave read and write,
        # count that many bytes each (2 for 10-bit video, as int16 holds
        # it), not the int32 planes' 4
        self.sample_bytes = sample_bytes
        self.narrow = set()  # data_ptrs of those sample tensors

    def add(self, name, args, out, kw=None):
        kw = kw or {}
        self.ops += kernel_ops(name, args, kw, out)
        if self.sample_bytes and name == "sad_search":
            self.narrow.update(c[0].data_ptr() for c in args[1])
        if self.sample_bytes and name == "intra_wave":  # originals, recon
            self.narrow.update(t.data_ptr() for t in (*args[:3], *out[:3]))
        if self.sample_bytes and name in B_KERNELS:
            self.narrow.update(t.data_ptr() for t in b_samples(name, args,
                                                               out))
        if name == "grid_satd_cost":  # views of the caller's buffer
            self.written += sum(t.nbytes for t in out)
            kw = {k: v for k, v in kw.items() if k != "out"}
            args, out = args[:6], ()
        for plane, mask in windows(name, args, kw, out):
            prev = self.planes.get(plane.data_ptr())
            self.planes[plane.data_ptr()] = (
                plane, mask if prev is None else prev[1] | mask)
        for t in tensors((args, kw, out)):
            old = self.held.get(t.data_ptr())
            if t.numel() and (old is None or t.nbytes > old.nbytes):
                self.held[t.data_ptr()] = t

    @property
    def bytes(self):
        sb = self.sample_bytes
        return (self.written
                + sum(t.numel() * sb if p in self.narrow else t.nbytes
                      for p, t in self.held.items() if p not in self.planes)
                + sum(int(m.sum()) * (sb or pl.element_size())
                      for pl, m in self.planes.values()))


def b_samples(name, a, out):
    """The sample tensors of a B kernel's call (not its MVs, positions,
    SADs, inter_dir or tables): b_me's three planes; b_pred_yuv's
    originals and its three predictions (the reference planes count
    through their windows); b_txq_planes' originals, predictions, levels
    and recons."""
    if name == "b_me":
        return a[:3]
    if name == "b_pred":
        return (a[0], out[0], out[2], out[3])
    return [t for p, o in zip(a[0], out) for t in (p[0], p[1], *o)]


def kernel_ops(name, a, kw=None, out=None) -> int:
    """Integer or float32 operations of one call (its results `out`), from
    its shapes: the work the function needs, not what a kernel happens to
    repeat. A call of several classes (planes) counts their sum."""
    kw = kw or {}
    if name == "sad_search":  # every class: sub, abs, add
        sr = a[4]
        sub = (a[5] if len(a) > 5 else kw.get("subsample", True))
        ops = 0
        for cur, _, _ in a[1]:
            n, S = cur.shape[0], cur.shape[1]
            rows = S // 2 if sub and S > 8 else S
            ops += 3 * n * (2 * sr + 1) ** 2 * rows * S
        return ops
    if name in ("nnfme_mlp", "nn_refine_classes"):  # one class, or several
        n = (a[1].shape[0] if name == "nnfme_mlp"
             else sum(p[0].shape[0] for p in a[1]))
        return n * (2 * (17 * 22 + 22 * 20 + 20 * 49) + 3 * (9 + 22 + 20)
                    + 49)
    if name == "mc_blk":  # every job (mc_blk_planes)
        return sum(xs.shape[0] * 2 * (8 if luma else 4)
                   * ((S + (7 if luma else 3)) * S + S * S)
                   for _, xs, _, _, S, luma in a[0])
    if name in ("txq", "b_txq") and isinstance(a[0], list):  # the planes
        return sum(kernel_ops(name, p) for p in a[0])
    if name in ("txq", "b_txq"):
        n, S = a[0].shape[0], a[0].shape[-1]
        return n * (8 * S ** 3 + (80 if name == "b_txq" else 20) * S * S)
    if name == "intra_bank":
        return a[0].shape[0] * 35 * a[2] ** 2 * 6
    if name == "satd35_topk":
        n, S = a[0].shape[0], a[0].shape[-1]
        t = 8 if S >= 8 else 4
        return n * 35 * S * S * (2 * (t.bit_length() - 1) + 3)
    if name == "intra_txq":
        S, rdoq = a[0].shape[-1], a[6]
        return a[3].numel() * (8 * S ** 3 + (60 if rdoq else 4) * S * S)
    if name == "tu_bits":
        return a[1].numel() * 20
    if name == "b_me":
        side = 2 * a[4] + 1
        return 2 * (a[0].numel() // 256) * side * side * (256 * 3 + 2)
    if name == "b_pred" and isinstance(a[1], tuple):  # b_pred_yuv
        cur, refs_y, refs_u, refs_v, xs, ys, m0, m1 = a[:8]
        return (kernel_ops("b_pred", (cur, *refs_y, xs, ys, m0, m1, 16,
                                      True))
                + 2 * kernel_ops("b_pred", (None, *refs_u, xs, ys, m0, m1, 8,
                                            False), {"inter_dir": out[1]}))
    if name == "b_pred":  # the MACs of each list a block uses; the
        # averages, and the decision's SSEs and costs
        S, nt = a[7], 8 if a[8] else 4
        idir = kw.get("inter_dir", a[10] if len(a) > 10 else None)
        n = a[3].shape[0]
        lists = 2 * n if idir is None else n + int((idir == 3).sum())
        return (lists * 2 * nt * ((S + nt - 1) * S + S * S)
                + n * (12 if idir is None else 3) * S * S)
    if name == "grid_coarse":  # sub, abs, add (+ add for the sum)
        return a[0].numel() * a[2] ** 2 * (4 if a[5] else 3)
    if name == "grid_prestage":  # sub, abs, add a sample and offset; the
        # shift, the rate's add and the compare a block and offset
        blocks = a[0].numel() // a[3] ** 2
        return (a[0].numel() + blocks) * a[2] ** 2 * 3
    if name in ("grid_refine", "grid_refine_one"):  # sub, abs, add, add
        # per pixel and candidate
        S, nb = a[2], a[3] * a[4]
        return a[5].shape[0] * 49 * nb * S * S * 4
    if name == "grid_planes":  # the separable filter's products and sums
        n, P, nt = a[0].shape[0], (4 if a[1] else 8), (8 if a[1] else 4)
        hm, wm = a[3], a[4]
        return n * (P * (hm + nt) * wm * nt * 2
                    + P * P * hm * wm * (nt * 2 + 3))
    if name == "grid_satd":  # gather: index and load, luma and chroma
        return a[3].numel() * (64 + 2 * 16) * 2
    if name == "grid_satd_cost":  # gather; residual, butterflies, abs,
        # sums a pixel; the DC-aware epilogue a CU
        return sum(fl.rows * fl.cols * (fl.size ** 2 * 12 + 12)
                   for fl in a[2])
    if name == "grid_code":  # transforms, quantiser, bits; RDOQ, SBH
        jobs = a[0]
        rdoq = a[2] if len(a) > 2 else False
        sbh = a[3] if len(a) > 3 else False
        per = 40 + (80 if rdoq else 0) + (12 if sbh else 0)
        return sum(j[0].numel() // (j[2] ** 2) * (8 * j[2] ** 3
                                                   + per * j[2] ** 2)
                   for j in jobs)
    if name == "grid_deblock":  # the bs per cell, the filters at bs > 0
        tu = tu_cells(a[2], a[7])
        mv, ref, cbf, intra = a[3].int(), a[4].int(), a[5].bool(), a[6].bool()
        ops = 0
        for axis in (1, 0):
            bs = boundary_strength(tu, mv, ref, cbf, intra, axis)
            ops += tu.numel() * 2 * 30  # two edge segments per cell
            ops += int((bs > 0).sum()) * 2 * (40 + 4 * 60)
            ops += int((bs[:, ::2] == 2).sum() if axis == 1 else
                       (bs[::2, :] == 2).sum()) * 2 * 4 * 12
        return ops
    if name == "grid_sao":  # 4 EO classes and the band per sample, twice
        return (a[2].numel() + a[3].numel()) * 50
    if name == "grid_sao_stats":  # one of grid_sao's two passes
        return (a[0].numel() + a[1].numel()) * 25
    if name == "grid_sao_apply":
        return (a[0].numel() + a[1].numel()) * 25
    if name == "grid_sao_decide":  # per CTU and component: 16 EO
        # categories and 32 bands of 8 candidates (~9 operations each),
        # the 29 band windows, the types; the picture sums
        n = a[0].shape[1]
        return n * 3 * (16 * 8 * 9 + 32 * 8 * 9 + 29 * 4 + 40) + 2 * n
    if name == "stripe_prescreen":  # per sample and mode: the prediction
        # (~6), the residual and the Hadamard stages (~8); the argmin
        return (a[0].numel() * 35 * (6 + 8)
                + a[0].numel() // 64 * 35 * 2)
    if name == "grid_intra16":
        decide = kw.get("cur", a[6] if len(a) > 6 else None) is not None
        return a[4] * a[5] * ((7 * 256 * 14 if decide else 256 * 4)
                              + 128 * 4)
    if name == "grid_subpel":  # each class, 18 points: gather, residual,
        # SATD, sums
        return sum(18 * nbh * S * nbw * S * 12 + 2 * nbh * nbw * 9
                   for _, _, S, nbh, nbw in a[2])
    if name == "grid_wp_me":  # multiply, round, shift, offset, clip
        return a[0].numel() * 5
    if name in ("grid_stats", "grid_stats_partial"):  # mask, xor, add;
        # difference, square, add
        return (a[2].numel() + a[3].numel()) * 10
    if name == "intra_wave":  # per 8x8 cell: 35 predictions (6 ops a
        # sample), differences and Hadamards (8 ops a sample), the mode
        # costs, the chosen luma block's 4 transform stages (2 S ops an
        # output) and quantisers; chroma one prediction and the same at 4x4
        cells = a[0].numel() // 64
        luma = 35 * 64 * (6 + 8) + 35 * 4 + 4 * 64 * 16 + 64 * 12
        chroma = 2 * (16 * 6 + 4 * 16 * 8 + 16 * 12)
        return cells * (luma + chroma)
    raise KeyError(name)


def bound_of(row):
    """The least time the card could take for the row's work, and which
    of bytes or operations bounds it."""
    t_bytes = row["work"].bytes / HBM_BPS * 1e3
    t_ops = row["work"].ops / SCALAR_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def stage_shapes(dev):
    """Per class: the main path's inputs at 416x240 (frame 1 against frame
    0) plus an 8x8 class along the bottom rows (N=52), as non-16-aligned
    sizes have it."""
    clip = Reader(W, H, 2).frames
    cfg = EncoderConfig(sps=SeqParams(width=W, height=H), qp=QP,
                        intra_period=-1, fme_mode="nn")
    classes = list(_positions(cfg)[1])
    classes.append(("c8", [(x, H - 8) for x in range(0, W, 8)], 8))
    ref = [torch.as_tensor(p.astype(np.int32), device=dev) for p in clip[0]]
    org = [torch.as_tensor(p.astype(np.int32), device=dev) for p in clip[1]]
    out = []
    for tag, poss, size in classes:
        xs = np.array([p[0] for p in poss], np.int32)
        ys = np.array([p[1] for p in poss], np.int32)
        out.append(dict(
            tag=tag, size=size, n=len(poss),
            cur=org[0].reshape(-1)[torch.as_tensor(_blk_idx(poss, size, W),
                                                   device=dev).long()],
            cur_c=[p.reshape(-1)[torch.as_tensor(
                _blk_idx(poss, size // 2, W // 2, 2), device=dev).long()]
                for p in org[1:]],
            xs=torch.as_tensor(xs, device=dev),
            ys=torch.as_tensor(ys, device=dev),
            xs_c=torch.as_tensor(xs // 2, device=dev),
            ys_c=torch.as_tensor(ys // 2, device=dev),
            ref=ref))
    return out


def k1_library_ms(ref_y, classes, found):
    """torch.cdist (p=1) of each class's PUs against their unfolded
    windows in float32 (sr 16): the SAD surface of the classes only (no
    cost, pick or sad9), its values at K1's picks checked (every row
    searched). Returns its event ms over the classes."""
    h, w = ref_y.shape
    side = 2 * SR + 1
    pairs = []
    for (cur, xs, ys), (mv, sad9) in zip(classes, found):
        n, S = cur.shape[0], cur.shape[1]
        wnd = ref_y.reshape(-1)[window_index(xs, ys, S, SR, h, w)]
        x1 = cur.reshape(n, 1, S * S).float().contiguous()
        x2 = (wnd.unfold(1, S, 1).unfold(2, S, 1)
              .reshape(n, side * side, S * S).float().contiguous())
        d = torch.cdist(x1, x2, p=1)[:, 0]
        bi = (mv[:, 1] + SR) * side + mv[:, 0] + SR
        check(torch.equal(d.gather(1, bi[:, None].long())[:, 0].int(),
                          sad9[:, 4]),
              f"torch.cdist's SAD at K1's picks differs from sad9 (S={S})")
        pairs.append((x1, x2))
    ms = median_ms(lambda: [torch.cdist(a, b, p=1) for a, b in pairs])
    print(f"library sad_search: torch.cdist(p=1) of the P picture's "
          f"{[a.shape[0] for a, _ in pairs]} PUs against {side * side} "
          f"unfolded window blocks each (float32, sr 16), the SAD surface "
          f"only: event ms {ms:.4f} | {gpu_line()}", flush=True)
    return ms


def check_k3(jobs, what):
    """K3 over `jobs` (mc_blk_planes) in one launch against plain, every
    prediction torch.equal. Returns the kernel's predictions."""
    before = LAUNCHES["mc_blk"]
    got = mc_blk_planes(jobs)
    check(LAUNCHES["mc_blk"] - before == 1,
          f"mc_blk {what}: {LAUNCHES['mc_blk'] - before} launches")
    want = mc_blk_planes_plain(jobs)
    torch.cuda.synchronize()
    for g, w_, job in zip(got, want, jobs, strict=True):
        check(g.dtype == w_.dtype and torch.equal(g, w_),
              f"mc_blk {what}: S {job[4]} luma {job[5]} differs from plain")
    print(f"kernel mc_blk: {what}: {len(jobs)} jobs "
          f"{[(j[4], 'Y' if j[5] else 'C', j[1].shape[0]) for j in jobs]} "
          f"in one launch, equal to plain", flush=True)
    return got


def k3_adversarial_jobs(dev):
    """K3's six (size, plane) cases at 416x240 on seeded planes: PUs at
    every position class, each MV phase of both signs in each axis, and
    windows clamped at each edge (PUs along the edges with MVs reaching
    far past them and past the opposite edge)."""
    rng = np.random.default_rng(SEED + 3)
    jobs = []
    for size, luma in ((32, True), (16, True), (8, True), (16, False),
                       (8, False), (4, False)):
        w, h = (W, H) if luma else (W // 2, H // 2)
        plane = torch.as_tensor(rng.integers(0, 256, (h, w)).astype(np.int32),
                                device=dev)
        fm, sc = (4, 4) if luma else (8, 8)  # phases, sub-pels a pel
        pos = [(x, y) for x in (0, w - size) for y in (0, h - size)]
        pos += [(int(rng.integers(0, w // size)) * size,
                 int(rng.integers(0, h // size)) * size) for _ in range(64)]
        xs, ys, mvs = [], [], []
        far = sc * (max(w, h) + 24)
        for k, (x, y) in enumerate(pos):
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for ph in range(fm):
                        reach = far if k < 4 else sc * int(rng.integers(0, 40))
                        xs.append(x)
                        ys.append(y)
                        mvs.append((sx * (reach + ph),
                                    sy * (reach + (ph + k) % fm)))
        jobs.append((plane, torch.tensor(xs, dtype=torch.int32, device=dev),
                     torch.tensor(ys, dtype=torch.int32, device=dev),
                     torch.tensor(mvs, dtype=torch.int32, device=dev), size,
                     luma))
    return jobs


def check_kernels(dev, model):
    """Kernel vs plain on the card. Returns {name: row} for the JSON line:
    K1 and K4 one launch for the 416x240 P picture's classes (c32, c16,
    cf; their ms, plain_ms, device_ms and bound those of the random-access
    P picture's call: K1 with every row searched), K2 and K3 summed over
    those classes. K1 and K4 are also checked with the synthetic c8 class
    in the launch."""
    lam_full = int(round(p_frame_lambda(
        EncoderConfig(qp=QP, gop_qp_offsets=(3, 2, 3, 1)), 0, QP + 3) * 256))
    lam_me = int(round(np.sqrt(lam_full / 256.0) * 256))
    bits = bits_table(SR, dev)
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=Work())
            for k in ("sad_search", "nnfme_mlp", "mc_blk", "txq")}

    def record(name, tag, err, ms, plain_ms, calls=()):
        r = rows[name]
        r["max_abs_err"] = max(r["max_abs_err"], float(err))
        if tag != "c8":  # c8 does not occur at 416x240
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            for args, out in calls:
                r["work"].add(name, args, out)
        print(f"kernel {name:10s} {tag:4s} max_abs_err {err:.3g} "
              f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f}", flush=True)

    def exact(a, b):
        return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
                   for x, y in zip(a, b))

    def equal(got, want, what):
        for g, w_ in zip(got, want, strict=True):
            err = exact(g, w_)
            check(err == 0 and all(torch.equal(x, y) for x, y in zip(g, w_)),
                  f"{what}: differs from plain by {err}")

    shapes = stage_shapes(dev)
    main = [st for st in shapes if st["tag"] != "c8"]
    ref_y = shapes[0]["ref"][0]
    every = [(st["cur"], st["xs"], st["ys"]) for st in shapes]
    pic = [(st["cur"], st["xs"], st["ys"]) for st in main]
    # K1: every class (c8 too) in one launch, subsample on and off, lam_me
    # 0 and the path's
    for sub in (True, False):
        for lam in (0, lam_me):
            got = sad_search_classes(ref_y, every, bits, lam, SR, sub,
                                     bit_depth=8)
            want = sad_search_classes_plain(ref_y, every, bits, lam, SR, sub)
            torch.cuda.synchronize()
            equal(got, want, f"sad_search subsample {sub}, lam_me {lam}")
    print(f"kernel sad_search: classes {[st['tag'] for st in shapes]} in "
          f"one launch, subsample on and off, lam_me 0 and {lam_me}: equal "
          "to plain", flush=True)
    # the random-access P picture's call (every row searched)
    found = sad_search_classes(ref_y, pic, bits, lam_me, SR, False,
                               bit_depth=8)
    record("sad_search", "P picture", 0,
           median_ms(lambda: sad_search_classes(ref_y, pic, bits, lam_me,
                                                SR, False, bit_depth=8)),
           median_ms(lambda: sad_search_classes_plain(ref_y, pic, bits,
                                                      lam_me, SR, False)),
           [((ref_y, pic, bits, lam_me, SR, False), found)])
    r = rows["sad_search"]
    for sub in (False, True):
        dms = device_ms(lambda: sad_search_classes(ref_y, pic, bits, lam_me,
                                                   SR, sub, bit_depth=8),
                        n=100)
        if not sub:
            r["device_ms"] = dms
        print(f"kernel sad_search P picture (subsample {sub}): device_ms "
              f"{dms:.5f} a launch (events around 100 launches queued "
              f"behind a device sleep) | {gpu_line()}", flush=True)
    bound, by = bound_of(r)
    print(f"kernel sad_search P picture: bound {bound:.6f} ms ({by}; "
          f"{r['work'].bytes} bytes, {r['work'].ops} operations)",
          flush=True)
    r["library_ms"] = k1_library_ms(ref_y, pic, found)
    # the LD-P scan's search feeds K2 below
    scan = sad_search_classes(ref_y, every, bits, lam_me, SR, bit_depth=8)

    mc_jobs = []
    for st, (mv_int, sad9) in zip(shapes, scan):
        size, tag = st["size"], st["tag"]
        # K2: logits within atol 1e-4 / rtol 1e-5; the argmax must agree
        # wherever the plain top-2 gap exceeds 1e-3
        hc, wc = height_category(size), width_category(size)
        kl, kc, kq = nn_refine(model, sad9, hc, wc)
        pl, pc, pq = nn_refine_plain(model, sad9, hc, wc)
        torch.cuda.synchronize()
        err = float((kl - pl).abs().max())
        torch.testing.assert_close(kl, pl, atol=1e-4, rtol=1e-5)
        top2 = torch.topk(pl, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        check(torch.equal(kc[clear], pc[clear]), f"nnfme argmax {tag}")
        check(torch.equal(kq[clear], pq[clear]), f"nnfme offset {tag}")
        record("nnfme_mlp", tag, err,
               median_ms(lambda: nn_refine(model, sad9, hc, wc)),
               median_ms(lambda: nn_refine_plain(model, sad9, hc, wc)),
               [((model, sad9, hc, wc), (kl, kc, kq))])
        mvq = (mv_int * 4 + kq).contiguous()
        # K3's jobs: luma and both chroma planes
        mc_jobs += [(st["ref"][0], st["xs"], st["ys"], mvq, size, True)] + [
            (pln, st["xs_c"], st["ys_c"], mvq, size // 2, False)
            for pln in st["ref"][1:]]
    # K3: every class's three planes (c8 too) in one launch, then the P
    # picture's classes (c32, c16, cf) as the path calls them
    preds = check_k3(mc_jobs, "416x240 classes with c8")
    k3_pic = mc_jobs[: 3 * len(main)]
    got = mc_blk_planes(k3_pic)
    r = rows["mc_blk"]
    r["ms"] = median_ms(lambda: mc_blk_planes(k3_pic))
    r["plain_ms"] = median_ms(lambda: mc_blk_planes_plain(k3_pic))
    r["work"].add("mc_blk", (k3_pic,), got)
    r["device_ms"] = device_ms(lambda: mc_blk_planes(k3_pic), n=100)
    bound, by = bound_of(r)
    print(f"kernel mc_blk P picture, {len(k3_pic)} jobs in one launch: "
          f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} device_ms "
          f"{r['device_ms']:.5f} (events around 100 launches queued behind "
          f"a device sleep), bound {bound:.6f} ms ({by}; {r['work'].bytes} "
          f"bytes, {r['work'].ops} operations) | {gpu_line()}", flush=True)
    check_k3(k3_adversarial_jobs(dev), "adversarial MVs at 416x240")
    jobs, jobs_pic = [], []
    for i, st in enumerate(shapes):
        cls = [(st["cur"], preds[3 * i], QP)] + [
            (c, pr, chroma_qp(QP))
            for c, pr in zip(st["cur_c"], preds[3 * i + 1 : 3 * i + 3])]
        jobs += cls
        if st["tag"] != "c8":
            jobs_pic += cls
    # K4: every class's three planes (c8 too) in one launch at the path's
    # QPs, and at QP 50 (the int32-wrapping drop product)
    for js, what in ((jobs, "the path's QPs"),
                     ([(c, p, 50) for c, p, _ in jobs], "QP 50")):
        got = txq_planes(js, lam_full)
        want = txq_planes_plain(js, lam_full)
        torch.cuda.synchronize()
        equal(got, want, f"txq {len(js)} jobs at {what}")
    print(f"kernel txq: {len(jobs)} jobs (classes "
          f"{[st['tag'] for st in shapes]}, Y, U, V) in one launch at QP "
          f"{QP} / {chroma_qp(QP)} and at QP 50: equal to plain", flush=True)
    coded = txq_planes(jobs_pic, lam_full)
    record("txq", "P picture", 0,
           median_ms(lambda: txq_planes(jobs_pic, lam_full)),
           median_ms(lambda: txq_planes_plain(jobs_pic, lam_full)),
           [((jobs_pic, lam_full), coded)])
    r = rows["txq"]
    r["device_ms"] = device_ms(lambda: txq_planes(jobs_pic, lam_full), n=100)
    bound, by = bound_of(r)
    print(f"kernel txq P picture, {len(jobs_pic)} jobs in one launch: "
          f"device_ms {r['device_ms']:.5f} (events around 100 launches "
          f"queued behind a device sleep), bound {bound:.6f} ms ({by}; "
          f"{r['work'].bytes} bytes, {r['work'].ops} operations) | "
          f"{gpu_line()}", flush=True)
    return rows


INTRA_FUNCS = {  # name: (kernel wrapper, plain version)
    "intra_bank": (intra_bank, predict_all_modes_plain),
    "satd35_topk": (satd35_topk, satd35_topk_plain),
    "intra_txq": (intra_txq, intra_txq_plain),
    "tu_bits": (tu_bits, tu_bits_plain),
}


def intra_cfg(w, h, frames):
    """cfg/encoder_intra_main.cfg at w x h (IntraPeriod 1, RDOQ, QP 32)."""
    cfg, _ = build_config(parse_args([
        "-c", INTRA_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
        "-q", str(QP)]))
    return cfg


# the anchor's four tools off: the grid's flat quantiser, no filters
CUT = STEP_CUT  # the anchor's four tools cut


def ldp_cfg(npz, w=None, h=None, frames=None, cut=False, extra=()):
    """The anchor LD-P cfg at w x h (default: the main path's), as shipped
    or with its four tools cut, then the `extra` options (npz None: no
    NN-FME weights, as bench.py runs it). The recon is fetched unless the
    hash is the checksum (NO_FETCH: bench.py's cfg, the CLI without
    `-o`)."""
    weights = [f"--NNWeightsDir={npz}"] if npz else []
    cfg, _ = build_config(parse_args([
        "-c", os.path.join(ROOT, "cfg", "encoder_lowdelay_P_main.cfg"),
        "-wdt", str(w or W), "-hgt", str(h or H), "-f", str(frames or NFRAMES),
        "-q", str(QP),
        "--FmeMode=nn"] + weights + (CUT if cut else []) + list(extra)))
    cfg.fetch_recon = cfg.hash_type != "checksum"
    return cfg


def weighted(wp) -> bool:
    """Whether a slice's WP tables hold a non-identity weight or offset."""
    return any(wt != [1 << wp.denom_y, 1 << wp.denom_c, 1 << wp.denom_c]
               or o != [0, 0, 0] for wt, o in zip(wp.weights, wp.offsets))


def ra_cfg(npz, w=None, h=None, frames=None, extra=()):
    """cfg/encoder_randomaccess_main.cfg as shipped at w x h (default: the
    main path's), QP 32, the seeded NN-FME weights, then the `extra`
    options."""
    cfg, _ = build_config(parse_args([
        "-c", RA_CFG, "-wdt", str(w or W), "-hgt", str(h or H),
        "-f", str(frames or N_RA), "-q", str(QP), f"--NNWeightsDir={npz}"]
        + list(extra)))
    return cfg


# kernel name -> the wrapper the grid step (the B step, the P stage)
# calls, where they differ
# ("grid_refine_one": grid_refine's one-reference wrapper, which
# stripe_refine calls)
CALLED_AS = {"sad_search": "sad_search_classes", "txq": "txq_planes",
             "mc_blk": "mc_blk_planes",
             "grid_code": "grid_code_batch", "grid_satd": "grid_mc",
             "grid_refine": "grid_refine_refs",
             "grid_refine_one": "grid_refine",
             "grid_subpel": "grid_subpel_classes",
             "b_pred": "b_pred_yuv", "b_txq": "b_txq_planes",
             "stripe_prescreen": "stripe_prescreen_rows"}


def recording(module, names, calls, no_sync=(), span=None):
    """Swap module.<name> (or CALLED_AS[name]) for a wrapper that records
    (args, kwargs) of every call into calls[name]; returns the originals.
    The calls of the names in no_sync run under
    torch.cuda.set_sync_debug_mode("error"): a sync of the stream inside
    them (a device-to-host read, an upload from pageable memory) raises.
    span (first, end): from the entry of `first`'s call to the entry of
    `end`'s, everything the caller does runs under that mode too."""
    saved = {k: getattr(module, CALLED_AS.get(k, k)) for k in names}

    def recorder(name, fn):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            if span is not None and name == span[0]:
                torch.cuda.set_sync_debug_mode("error")
            elif span is not None and name == span[1]:
                torch.cuda.set_sync_debug_mode("default")
            if name not in no_sync:
                return fn(*args, **kw)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wrapped

    for k in names:
        setattr(module, CALLED_AS.get(k, k), recorder(k, saved[k]))
    return saved


def restore(module, saved):
    """Undo `recording`."""
    for k, fn in saved.items():
        setattr(module, CALLED_AS.get(k, k), fn)


def capture_intra_calls(dev, cfg, frame):
    """Run the decision of one picture on the card, both passes (pass 2
    from a recon-like reference: the picture blurred), recording every
    call of the four intra wrappers -> {name: [args]}."""
    calls = {k: [] for k in INTRA}
    sps = cfg.sps
    w, h = sps.coded_width, sps.coded_height
    planes = [_pad_to(np.asarray(p), h >> s, w >> s).astype(np.int32)
              for p, s in zip(frame, (0, 1, 1))]
    blurred = [(p + np.roll(p, 1, 0) + np.roll(p, 1, 1) + np.roll(p, 1, (0, 1))
                + 2) >> 2 for p in planes]
    saved = recording(intra_decide, INTRA, calls)
    try:
        decide_intra_qt(*planes, cfg, cfg.qp, device=dev)
        decide_intra_qt(*planes, cfg, cfg.qp, ref_planes=blurred, device=dev)
        torch.cuda.synchronize()
    finally:
        for k in INTRA:
            setattr(intra_decide, k, saved[k])
    return {k: [a for a, _ in v] for k, v in calls.items()}


def check_intra_kernels(dev, npz):
    """Kernel vs plain on the card for the intra decision, at every call
    of the two passes of one 416x240 all-intra picture (RDOQ, NxN) and of
    one IDR of the anchor LD-P cfg. Every output torch.equal: integers,
    intra_txq's float32 dist and d0 and tu_bits' float32 bits (exact sums
    rounded once). intra_bank's, satd35_topk's and tu_bits' device time a
    picture and bound printed, and beside intra_bank's the device time
    of torch's fill_ writing the same outputs. Returns {name: row};
    ms/plain_ms are per all-intra picture (both passes)."""
    frame = Reader(W, H, 1).frames[0]
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=Work())
            for k in INTRA}
    for tag, cfg in (("all-intra", intra_cfg(W, H, 1)),
                     ("ldp-idr", ldp_cfg(npz))):
        calls = capture_intra_calls(dev, cfg, frame)
        for name in INTRA:
            kern, plain = INTRA_FUNCS[name]
            err = 0.0
            for args in calls[name]:
                a, b = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if tag == "all-intra":
                    rows[name]["work"].add(name, args, a)
                a = a if isinstance(a, tuple) else (a,)
                b = b if isinstance(b, tuple) else (b,)
                for x, y in zip(a, b):
                    check(x.dtype == y.dtype and x.shape == y.shape,
                          f"{name} {tag}: {x.dtype}{tuple(x.shape)} vs "
                          f"{y.dtype}{tuple(y.shape)}")
                    if x.numel() == 0:
                        continue
                    d = float((x.double() - y.double()).abs().max())
                    err = max(err, d)
                    check(torch.equal(x, y), f"{name} {tag}: outputs "
                          f"differ by {d}")
            ms = median_ms(lambda: [kern(*c) for c in calls[name]], reps=5)
            plain_ms = median_ms(lambda: [plain(*c) for c in calls[name]],
                                 reps=5)
            r = rows[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if tag == "all-intra":
                r["ms"], r["plain_ms"] = ms, plain_ms
            if name != "intra_txq":  # device time and bound a picture
                work = Work()
                for args in calls[name]:
                    work.add(name, args, kern(*args))
                b, by = bound_of(dict(work=work))
                dms = device_ms(lambda: [kern(*c) for c in calls[name]],
                                n=20)
                if tag == "all-intra":
                    r["device_ms"] = dms
                print(f"kernel {name} {tag:9s} {len(calls[name])} "
                      f"launches: device_ms {dms:.5f} a picture (both "
                      f"passes; events around 20 pictures' calls queued "
                      f"behind a device sleep), bound {b:.6f} ms ({by}) | "
                      f"{gpu_line()}", flush=True)
            if name == "intra_bank":  # the bytes alone: fill the outputs
                outs = [kern(*c) for c in calls[name]]
                fms = device_ms(lambda: [o.fill_(7) for o in outs], n=20)
                print(f"kernel intra_bank {tag:9s}: torch's fill_ of the "
                      f"same {len(outs)} outputs device_ms {fms:.5f} a "
                      f"picture (the stores alone) | {gpu_line()}",
                      flush=True)
            print(f"kernel {name:11s} {tag:9s} calls {len(calls[name]):3d} "
                  f"max_abs_err {err:.3g} kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} (per picture, both passes)",
                  flush=True)
    return rows


B_FUNCS = {  # name: (kernel wrapper, plain version)
    "b_me": (b_me, b_me_plain),
    # a B picture's three planes in one launch
    "b_pred": (b_pred_yuv, b_pred_yuv_plain),
    "b_txq": (b_txq_planes, b_txq_planes_plain),
}


def check_b_kernels(dev, npz, params):
    """Kernel vs plain on the card for the B step, at every call of one
    416x240 B picture of the random-access path (POC 2 at QP 34 between
    POC 0 and POC 4, the originals standing in for their recons), captured
    from the port's B step: b_me, and b_pred and b_txq as the step calls
    them, a B picture's three planes in one launch each (their device
    time a picture and bound printed); then the one-plane entries at the
    same shapes (`check_b_one_plane`). Every output is an integer: exact.
    Returns {name: row}; ms/plain_ms are per B picture."""
    clip = Reader(W, H, 5).frames
    cfg = ra_cfg(npz)
    calls = {k: [] for k in B_KERNELS}
    saved = recording(inter_b, B_KERNELS, calls)
    try:
        inter_b.encode_frame_b(clip[2], clip[0], clip[4], cfg, QP + 2, [0],
                               [4], 2, params, device=dev)
        torch.cuda.synchronize()
    finally:
        restore(inter_b, saved)
    rows = {}
    for name in B_KERNELS:
        check(len(calls[name]) == 1, f"{name}: {len(calls[name])} calls a "
              "B picture")
        kern, plain = B_FUNCS[name]
        r = rows[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                              work=Work())
        for args, kw in calls[name]:
            a, b = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            r["work"].add(name, args, a, kw)
            for x, y in zip(tensors(a), tensors(b), strict=True):
                check(x.dtype == y.dtype and x.shape == y.shape,
                      f"{name}: {x.dtype}{tuple(x.shape)} vs "
                      f"{y.dtype}{tuple(y.shape)}")
                d = float((x.double() - y.double()).abs().max())
                check(d == 0 and torch.equal(x, y),
                      f"{name}: integer outputs differ by {d}")
                r["max_abs_err"] = max(r["max_abs_err"], d)
        r["ms"] = median_ms(lambda: [kern(*a, **k) for a, k in calls[name]],
                            reps=10)
        r["plain_ms"] = median_ms(
            lambda: [plain(*a, **k) for a, k in calls[name]], reps=5)
        print(f"kernel {name:11s} B picture calls {len(calls[name]):2d} "
              f"max_abs_err {r['max_abs_err']:.3g} kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} (per B picture)", flush=True)
        if name != "b_me":
            bound, by = bound_of(r)
            r["device_ms"] = dms = device_ms(
                lambda: [kern(*a, **k) for a, k in calls[name]], n=100)
            print(f"kernel {name} B picture, Y, U and V in one launch: "
                  f"device_ms {dms:.5f} (events around 100 launches queued "
                  f"behind a device sleep), bound {bound:.6f} ms ({by}; "
                  f"{r['work'].bytes} bytes, {r['work'].ops} operations) | "
                  f"{gpu_line()}", flush=True)
    check_b_one_plane(calls["b_pred"][0][0], calls["b_txq"][0][0])
    rows["b_me"]["library_ms"] = check_b_me_direct(*calls["b_me"][0][0])
    return rows


def check_b_one_plane(pred_args, txq_args):
    """The one-plane entries of b_pred and b_txq (the fused kernels with
    one class) at the B picture's shapes, against plain: b_pred on luma
    (deciding inter_dir) and on U (with that inter_dir), b_txq on luma (S =
    16) and on U (S = 8); each launch's device time printed (a class
    alone)."""
    cur, refs_y, refs_u, _, xs, ys, m0, m1, lam = pred_args
    planes, lam_t = txq_args
    dirs = b_pred_yuv(*pred_args)[1]
    cases = (
        ("b_pred", "luma, deciding", b_pred, b_pred_plain,
         (cur, *refs_y, xs, ys, m0, m1, 16, True, lam), {}),
        ("b_pred", "U, inter_dir given", b_pred, b_pred_plain,
         (None, *refs_u, xs // 2, ys // 2, m0, m1, 8, False),
         {"inter_dir": dirs}),
        ("b_txq", "luma, S = 16", b_txq, b_txq_plain,
         (*planes[0][:3], lam_t, planes[0][3]), {}),
        ("b_txq", "U, S = 8", b_txq, b_txq_plain,
         (*planes[1][:3], lam_t, planes[1][3]), {}))
    for name, tag, kern, plain, args, kw in cases:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want, strict=True)),
              f"{name} one plane ({tag}): differs from plain")
        dms = device_ms(lambda: kern(*args, **kw), n=100)
        print(f"kernel {name} one plane ({tag}): equal to plain, device_ms "
              f"{dms:.5f} a launch (the class alone) | {gpu_line()}",
              flush=True)


def check_b_me_direct(org, r0, r1, lam_me, sr_step):
    """b_me on the B picture's planes at the B step's least and largest
    search range (sr 4 and 16) and on flat planes at lambda 0 (every cost
    ties: the first offset wins), against plain, each launch's device
    time printed; then the library yardstick: torch.cdist (p=1) of the
    16x16 blocks against their unfolded windows in float32 (both lists,
    sr 16), which computes the SAD surface only (no cost, argmin or
    sad9), its values at the kernel's picks checked. Returns its event
    ms."""
    flat = (torch.full_like(org, 100), torch.full_like(org, 97))
    for sr in (4, 16):
        for tag, (o, a, b, lam) in (("B picture", (org, r0, r1, lam_me)),
                                    ("flat, lambda 0",
                                     (flat[0], flat[1], flat[1], 0.0))):
            got = b_me(o, a, b, lam, sr, bit_depth=8)
            want = b_me_plain(o, a, b, lam, sr)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"b_me sr {sr} {tag}: differs from plain")
            if tag == "flat, lambda 0":
                check(bool((got[0] == -sr).all()),
                      f"b_me sr {sr} flat: not the first offset")
                continue
            dms = device_ms(lambda: b_me(o, a, b, lam, sr, bit_depth=8),
                            n=100)
            print(f"kernel b_me direct sr {sr} (B step's sr {sr_step}), "
                  f"{W}x{H}, both lists: equal to plain (also flat planes "
                  f"at lambda 0), device_ms {dms:.5f} a launch (events "
                  f"around 100 launches queued behind a device sleep) | "
                  f"{gpu_line()}", flush=True)
    return b_me_cdist_ms(org, r0, r1, lam_me, 16, 8)


def b_me_cdist_ms(org, r0, r1, lam_me, sr, bit_depth):
    """The library yardstick of b_me (its variant of bit_depth): torch.cdist
    (p=1) of the 16x16 blocks against their unfolded windows in float32
    (both lists), which computes the SAD surface only (no cost, argmin or
    sad9), its values at the kernel's picks checked. Returns its event
    ms."""
    h, w = org.shape
    side, n = 2 * sr + 1, (h // 16) * (w // 16)
    t = _b_tables(h, w, sr, org.device)
    cur = org.reshape(-1)[t["blk"]].reshape(n, 1, 256).float()
    x1 = torch.cat([cur, cur]).contiguous()
    x2 = torch.cat([ref.reshape(-1)[t["win"]].unfold(1, 16, 1)
                    .unfold(2, 16, 1).reshape(n, side * side, 256)
                    for ref in (r0, r1)]).float().contiguous()
    d = torch.cdist(x1, x2, p=1)[:, 0]
    mv, sad9 = b_me(org, r0, r1, lam_me, sr, bit_depth=bit_depth)
    bi = ((mv[..., 1] + sr) * side + mv[..., 0] + sr).reshape(-1)
    check(torch.equal(d.gather(1, bi[:, None].long())[:, 0].int(),
                      sad9[..., 4].reshape(-1)),
          "torch.cdist's SAD at the kernel's picks differs from sad9")
    ms = median_ms(lambda: torch.cdist(x1, x2, p=1))
    print(f"library b_me (bit depth {bit_depth}): torch.cdist(p=1) of "
          f"{2 * n} blocks against {side * side} unfolded window blocks of "
          f"256 float32 (sr {sr}), the SAD surface only: event ms {ms:.4f} "
          f"| {gpu_line()}", flush=True)
    return ms


G_FUNCS = {  # name: (kernel wrapper, plain version)
    "grid_coarse": (grid_coarse, grid_coarse_plain),
    "grid_prestage": (grid_prestage, grid_prestage_plain),
    "grid_refine": (grid_refine_refs, grid_refine_refs_plain),
    "grid_planes": (grid_planes, grid_planes_plain),
    "grid_satd": (grid_mc, grid_mc_plain),
    "grid_satd_cost": (grid_satd_cost, grid_satd_cost_plain),
    "grid_code": (grid_code_batch, grid_code_batch_plain),
    "grid_intra16": (grid_intra16, grid_intra16_plain),
    "grid_deblock": (grid_deblock, grid_deblock_plain),
    "grid_sao": (grid_sao, grid_sao_plain),
    # the picture's classes in one launch
    "grid_subpel": (grid_subpel_classes, grid_subpel_classes_plain),
    "grid_wp_me": (grid_wp_me, grid_wp_me_plain),
    "grid_stats": (grid_stats, grid_stats_plain),
    "grid_sao_decide": (grid_sao_decide, grid_sao_decide_plain),
    # K2 over the grid's classes of a picture, one launch
    "nn_refine_classes": (nn_refine_classes, nn_refine_classes_plain),
    # a device's stripes in one launch (tile_prescreen's calls)
    "stripe_prescreen": (stripe_prescreen_rows, stripe_prescreen_rows_plain),
    # grid_refine's one-reference wrapper (stripe_refine's)
    "grid_refine_one": (grid_refine, grid_refine_plain),
    # the row-stripe launches of grid_sao and grid_stats
    "grid_sao_stats": (grid_sao_stats, grid_sao_stats_plain),
    "grid_sao_apply": (grid_sao_apply, grid_sao_apply_plain),
    "grid_stats_partial": (grid_stats_partial, grid_stats_partial_plain),
}


def picture_wp(clip, R, dev):
    """The explicit-WP tables of frame 4 against frames 3..0
    (LdpScanDriver's `_wp_arrays` for one picture) -> ((w (R, 3), o (R,
    3)) on `dev`, d, the WpParams)."""
    wp = analyse_slice_wp(clip[4], [clip[3 - r] for r in range(R)],
                          bit_depth=8)
    w = np.array(wp.weights, np.int32).reshape(R, 3)
    o = np.array(wp.offsets, np.int32).reshape(R, 3)
    return ((torch.as_tensor(w, device=dev), torch.as_tensor(o, device=dev),
             wp.denom_y), wp)


# the grid step's wrappers that must not sync the stream
NO_SYNC = ("grid_code", "grid_satd", "grid_satd_cost", "grid_refine",
           "grid_intra16", "nn_refine_classes", "grid_sao_decide")
# the grid step's motion search, from its first grid_coarse launch to its
# first grid_planes launch (the coarse picks, the global start, the
# starts of every reference and both refine launches between): no sync
ME_SPAN = ("grid_coarse", "grid_planes")
# the grid step's launches of the whole-picture functions grid_sao
# (statistics, decision, apply) and grid_stats (the int64 sums)
WHOLE = {"grid_sao": ("grid_sao_stats", "grid_sao_decide"),
         "grid_stats": ("grid_stats_partial",)}


def capture_grid_calls(dev, cfg, params, names, fade=False):
    """Run the port's GridStep on one 416x240 P picture of `cfg` (frame 4
    against frames 3..0 as its four references, the originals standing in
    for their recons, GOP position 0 at QP 35, a collocated field of
    random motion so that the TMVP merge candidates are priced; with
    weighted prediction, the picture's analysed tables), recording every
    call of the named grid wrappers -> ({name: [(args, kwargs)]}, the
    WpParams or None). fade: the fade clip, else the synthetic one.
    The calls of NO_SYNC, and the motion search from its first grid_coarse
    launch to its first grid_planes launch (ME_SPAN; where both are
    recorded), run under sync debug mode "error" (`recording`)."""
    clip = Reader(W, H, 5, fade).frames
    cfg.sps.temporal_mvp_enabled = True
    qps = {min(max(cfg.qp + o, 0), 51) for o in cfg.gop_qp_offsets}
    step = inter_grid.GridStep(cfg, {q: params for q in qps}, dev)
    R = step.R

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    ry = dev_t(np.stack([clip[3 - r][0] for r in range(R)]).astype(np.int32))
    ruv = dev_t(np.stack([np.concatenate(clip[3 - r][1:], 1)
                          for r in range(R)]).astype(np.int32))
    rng = np.random.default_rng(SEED)
    hc16, wc16 = (H // 8 + 1) // 2, (W // 8 + 1) // 2
    carry = (ry, ruv, torch.zeros((step.n16, 2), dtype=torch.int32,
                                  device=dev),
             dev_t(rng.integers(-24, 25, (hc16, wc16, 2)).astype(np.int32)),
             dev_t(rng.integers(0, R + 1, (hc16, wc16)).astype(np.int32)))
    fu8 = dev_t(np.concatenate([p.ravel() for p in clip[4]]))
    tabs = inter_grid._Tabs(inter_grid.grid_live_tables(cfg, {})[0], dev)
    wp, wpp = picture_wp(clip, R, dev) if step.use_wp else (None, None)
    # grid_sao and grid_stats run as their row-stripe launches (here one
    # stripe, the whole picture): each picture's call is rebuilt from them
    rec = list(dict.fromkeys([k for k in names if k not in WHOLE] + [
        k for w in names if w in WHOLE for k in WHOLE[w]]))
    calls = {k: [] for k in rec}
    # grid_code and grid_satd_cost read lambda (and the cbf bits) on the
    # card: no sync a call, nor in the gathers
    span = ME_SPAN if all(k in rec for k in ME_SPAN) else None
    saved = recording(inter_grid, rec, calls, no_sync=NO_SYNC, span=span)
    try:
        step.frame_step(carry, fu8, R, 0, tabs, wp)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        restore(inter_grid, saved)
    if "grid_sao" in names:
        calls["grid_sao"] = [((*st[:4], dc[2], dc[3], st[4]), {})
                             for (st, _), (dc, _) in zip(
                                 calls["grid_sao_stats"],
                                 calls["grid_sao_decide"])]
    if "grid_stats" in names:
        calls["grid_stats"] = [(a[:4], {})
                               for a, _ in calls["grid_stats_partial"]]
    return calls, wpp


def compare_calls(name, calls, work=None):
    """Kernel vs plain at each recorded call: every output equal. Returns
    the largest difference (0)."""
    kern, plain = G_FUNCS[name]
    err = 0.0
    for args, kw in calls:
        a, b = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if work is not None:
            work.add(name, args, a, kw)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(tensors(a), tensors(b)):
            check(x.dtype == y.dtype and x.shape == y.shape,
                  f"{name}: {x.dtype}{tuple(x.shape)} vs "
                  f"{y.dtype}{tuple(y.shape)}")
            d = float((x.double() - y.double()).abs().max()) \
                if x.numel() else 0.0
            check(d == 0 and torch.equal(x, y),
                  f"{name}: outputs differ by {d}")
            err = max(err, d)
    return err


def compare_k2(calls, what):
    """nn_refine_classes (K2 over a picture's classes, one launch) against
    its plain version at each recorded call: per class the offsets equal
    wherever the plain logits' top-2 gap exceeds 1e-3 (the plain version
    sums its products in another order; the logits themselves are held by
    check_kernels), one launch a call. Returns (PUs, PUs at a near
    tie)."""
    pus = near = 0
    for args, kw in calls:
        model, parts = args[:2]
        before = LAUNCHES["nnfme_mlp"]
        got = nn_refine_classes(model, parts)
        check(LAUNCHES["nnfme_mlp"] - before == 1,
              f"nn_refine_classes {what}: "
              f"{LAUNCHES['nnfme_mlp'] - before} launches for "
              f"{len(parts)} classes")
        want = nn_refine_classes_plain(model, parts)
        torch.cuda.synchronize()
        for (sad9, hc, wc), g, w in zip(parts, got, want):
            top2 = torch.topk(model(sad9, hc, wc), 2, dim=1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-3
            check(g.dtype == w.dtype and g.shape == w.shape
                  and torch.equal(g[clear], w[clear]),
                  f"nn_refine_classes {what}: offsets differ (S category "
                  f"{hc}, {wc})")
            pus += sad9.shape[0]
            near += int((~clear).sum())
    print(f"kernel nn_refine_classes {what}: calls {len(calls)}, "
          f"{pus} PUs, offsets equal to plain ({near} at a near tie)",
          flush=True)
    return pus, near


def check_grid_kernels(dev, npz, params):
    """Kernel vs plain on the card for the grid step, at every call of one
    416x240 P picture of the anchor LD-P cfg as shipped (RDOQ, sign
    hiding, deblocking, SAO), captured from the port's GridStep, and
    grid_code at every call of the same picture with the four tools cut
    (the flat quantiser); a grid_code call is a launch of the class
    coding's planes (`grid_code_batch`). Every output equal: integers and
    the float32 costs of grid_code (whose sums are exact) and of
    grid_sao's decision. Returns {name: row}; ms/plain_ms are per P
    picture of the anchor."""
    calls, _ = capture_grid_calls(dev, ldp_cfg(npz), params,
                                  G_KERNELS + ("nn_refine_classes",))
    check_cost_calls(calls["grid_satd_cost"])
    k2 = calls["nn_refine_classes"]
    check(len(k2) == 1 and len(k2[0][0][1]) == 3,
          f"K2 at the anchor picture: {len(k2)} calls")
    compare_k2(k2, "anchor P picture")
    k2_ms = median_ms(lambda: [nn_refine_classes(*a, **k) for a, k in k2],
                      reps=20)
    k2_plain = median_ms(
        lambda: [nn_refine_classes_plain(*a, **k) for a, k in k2], reps=5)
    k2_dev = device_ms(
        lambda: [nn_refine_classes(*a, **k) for a, k in k2], n=100)
    grid_k2 = dict(ms=k2_ms, plain_ms=k2_plain, device_ms=k2_dev,
                   pus=[p[0].shape[0] for p in k2[0][0][1]])
    print(f"kernel nn_refine_classes P picture: one launch of "
          f"{grid_k2['pus']} PUs, event ms {k2_ms:.4f}, device_ms "
          f"{k2_dev:.5f} (events around 100 calls queued behind a device "
          f"sleep), plain_ms {k2_plain:.4f} | {gpu_line()}", flush=True)
    rows = {}
    for name in G_KERNELS:
        kern, plain = G_FUNCS[name]
        r = rows[name] = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                              work=Work())
        r["max_abs_err"] = compare_calls(name, calls[name], r["work"])
        r["ms"] = median_ms(lambda: [kern(*a, **k) for a, k in calls[name]],
                            reps=10)
        r["plain_ms"] = median_ms(
            lambda: [plain(*a, **k) for a, k in calls[name]], reps=3)
        extra = ""
        if name == "grid_code":  # the picture's launches' device time
            r["device_ms"] = device_ms(
                lambda: [kern(*a, **k) for a, k in calls[name]], n=20)
            extra = (f" device_ms {r['device_ms']:.4f} (events around 20 "
                     f"pictures' calls queued behind a device sleep; no "
                     f"sync inside a call); "
                     f"{sum(len(a[0]) for a, _ in calls[name])} planes")
        if name in LIBRARY_OF:  # torch.cdist or one gather
            r["library_ms"], lib_dev = LIBRARY_OF[name](calls[name])
            r["device_ms"] = device_ms(
                lambda: [kern(*a, **k) for a, k in calls[name]], n=20)
            extra = (f" library_ms {r['library_ms']:.4f}; device_ms "
                     f"{r['device_ms']:.5f} against the library's "
                     f"{lib_dev:.5f} (events around 20 pictures' calls "
                     f"queued behind a device sleep)")
        if name == "grid_planes":
            r["library_ms"] = planes_library_ms(calls[name])
            extra = (f" library_ms {r['library_ms']:.4f} (conv2d of the "
                     f"padded stacks by the phase filters, float32, TF32 "
                     f"off: the sums without the rounding and the int16 "
                     f"cast)")
        print(f"kernel {name:12s} P picture calls {len(calls[name]):3d} "
              f"max_abs_err {r['max_abs_err']:.3g} kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} (per P picture){extra}",
              flush=True)
    both = calls["grid_satd"] + calls["grid_satd_cost"]
    fns = [grid_mc] * len(calls["grid_satd"]) + [grid_satd_cost] * len(
        calls["grid_satd_cost"])
    def sat_calls():
        return [f(*a, **k) for f, (a, k) in zip(fns, both)]

    sat_ms, sat_host = median_ms(sat_calls, reps=20), host_ms(sat_calls)
    print(f"kernel grid_satd + grid_satd_cost P picture calls {len(both)} "
          f"({len(calls['grid_satd'])} gathers, "
          f"{len(calls['grid_satd_cost'])} cost launches) event ms "
          f"{sat_ms:.4f}, host ms {sat_host:.4f} a P picture | "
          f"{gpu_line()}", flush=True)
    check(len(calls["grid_deblock"]) == 1,
          f"grid_deblock at the anchor picture: {len(calls['grid_deblock'])}"
          f" calls")
    check_deblock_calls(calls["grid_deblock"], rows, "anchor P picture")
    rows["grid_deblock"]["device_ms"] = device_ms(
        lambda: [grid_deblock(*a, **k) for a, k in calls["grid_deblock"]],
        n=100)
    b, by = bound_of(rows["grid_deblock"])
    print(f"kernel grid_deblock P picture: device_ms "
          f"{rows['grid_deblock']['device_ms']:.5f} (events around 100 "
          f"calls queued behind a device sleep), bound {b:.6f} ms ({by}) | "
          f"{gpu_line()}", flush=True)
    check_stats_calls(calls, rows, "anchor P picture")
    rows.update(check_sao_decide(calls["grid_sao"]))
    rows["grid_sao_decide"]["device_ms"] = device_ms(
        lambda: [grid_sao_decide(*a, **k)
                 for a, k in calls["grid_sao_decide"]], n=100)
    print(f"kernel grid_sao_decide P picture: device_ms "
          f"{rows['grid_sao_decide']['device_ms']:.5f} (events around 100 "
          f"calls queued behind a device sleep) | {gpu_line()}", flush=True)
    cut = capture_grid_calls(dev, ldp_cfg(npz, cut=True), params,
                             ("grid_code",))[0]["grid_code"]
    err = compare_calls("grid_code", cut)
    rows["grid_code"]["max_abs_err"] = max(rows["grid_code"]["max_abs_err"],
                                           err)
    print(f"kernel grid_code     P picture calls {len(cut):3d} max_abs_err "
          f"{err:.3g} (the four tools cut: the flat quantiser)", flush=True)
    # DCT-IF FME, weighted prediction and the no-fetch tail: one P picture
    # of the fade clip with the anchor cfg, dctif, WP and no recon fetch
    # (grid_refine, grid_intra16 and grid_planes held beside their rows;
    # grid_coarse and grid_prestage on the weighted references, and
    # recorded for the motion search's sync-free span)
    anchor = calls
    calls, wpp = capture_grid_calls(
        dev, ldp_cfg(npz, extra=FME_WP + NO_FETCH), params,
        F_KERNELS + WP_TOO + ME_FIRST + ("grid_sao", "grid_deblock"),
        fade=True)
    check(weighted(wpp), f"fade picture: identity weights only {wpp}")
    check_stats_calls(calls, rows, "P picture, dctif + WP")
    check_deblock_calls(calls["grid_deblock"], rows, "P picture, dctif + WP")
    err = compare_calls("grid_sao_decide", calls["grid_sao_decide"])
    print(f"kernel grid_sao_decide P picture, dctif + WP: calls "
          f"{len(calls['grid_sao_decide'])} max_abs_err {err:.3g}",
          flush=True)
    # the coarse search, the prestage's pick and the two statistics
    # launches also at bench.py's cfg (no NN-FME weights, the checksum
    # hash, no recon fetch)
    bench = capture_grid_calls(dev, ldp_cfg(None, extra=NO_FETCH), params,
                               ME_FIRST + ("grid_sao", "grid_stats",
                                           "grid_deblock"))[0]
    check_stats_calls(bench, rows, "P picture, bench.py's cfg")
    check_deblock_calls(bench["grid_deblock"], rows,
                        "P picture, bench.py's cfg")
    for name in ME_FIRST:
        for tag, cs in (("dctif + WP", calls[name]), ("bench.py's cfg",
                                                      bench[name])):
            check(len(cs) == 1, f"{name} {tag}: {len(cs)} calls")
            err = compare_calls(name, cs)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            print(f"kernel {name:12s} P picture, {tag}: calls {len(cs)} "
                  f"max_abs_err {err:.3g}", flush=True)
    check_two_streams(anchor, calls)
    # the weighted picture with NN-FME: K2 and the SAO decision
    wcalls, wpp_nn = capture_grid_calls(
        dev, ldp_cfg(npz, extra=["--WeightedPredP=1"]), params,
        ("nn_refine_classes", "grid_sao_decide"), fade=True)
    check(weighted(wpp_nn), f"fade picture: identity weights only {wpp_nn}")
    check(len(wcalls["nn_refine_classes"]) == 1,
          f"K2 at the weighted picture: {len(wcalls['nn_refine_classes'])}")
    compare_k2(wcalls["nn_refine_classes"], "P picture, WP + NN-FME")
    err = compare_calls("grid_sao_decide", wcalls["grid_sao_decide"])
    print(f"kernel grid_sao_decide P picture, WP + NN-FME: calls "
          f"{len(wcalls['grid_sao_decide'])} max_abs_err {err:.3g}",
          flush=True)
    for name in F_KERNELS + WP_TOO:
        kern, plain = G_FUNCS[name]
        r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=Work())
        r["max_abs_err"] = compare_calls(name, calls[name], r["work"])
        r["ms"] = median_ms(lambda: [kern(*a, **k) for a, k in calls[name]],
                            reps=10)
        r["plain_ms"] = median_ms(
            lambda: [plain(*a, **k) for a, k in calls[name]], reps=3)
        tag = "P picture"
        if name in WP_TOO:  # the weighted picture, beside the row
            tag = "P picture, weighted"
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            r["max_abs_err"])
            bound_ms, bound_by = bound_of(r)
            rows[name]["wp"] = dict(ms=r["ms"], plain_ms=r["plain_ms"],
                                    bound_ms=bound_ms, bound_by=bound_by)
        else:
            rows[name] = r
        print(f"kernel {name:12s} {tag} calls {len(calls[name]):3d} "
              f"max_abs_err {r['max_abs_err']:.3g} kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} (per P picture, dctif + WP, no "
              f"fetch)", flush=True)
        if name == "grid_wp_me":  # the picture's call(s), device time
            r["device_ms"] = device_ms(
                lambda: [kern(*a, **k) for a, k in calls[name]], n=100)
            b, by = bound_of(r)
            print(f"kernel grid_wp_me P picture, dctif + WP: device_ms "
                  f"{r['device_ms']:.5f} (events around 100 pictures' calls "
                  f"queued behind a device sleep), bound {b:.6f} ms ({by}; "
                  f"{r['work'].bytes} bytes, {r['work'].ops} operations) | "
                  f"{gpu_line()}", flush=True)
    rows["nnfme_mlp_grid"] = grid_k2  # beside the kernels' rows
    return rows


def check_wp_me_adversarial(dev):
    """grid_wp_me against plain on a 416x240 stack of 1 and 4 references,
    on stripe-shaped stacks (64 rows with the anchor's 72 halo rows above
    and below, and below only) at denominators 0 and 7, with negative
    weights and offsets that clip at 0 and at 255, and two launches back
    to back without a sync between; every output torch.equal."""
    rng = np.random.default_rng(SEED + 5)

    def case(nref, rows, d, extreme):
        ref = torch.as_tensor(rng.integers(0, 256, (nref, rows, W)).astype(
            np.int32), device=dev)
        if extreme:
            w = [-128, (1 << d) + 127, -1, 3][:nref]
            o = [127, -128, 100, -100][:nref]
        else:
            w = ((1 << d) + rng.integers(-60, 61, nref)).tolist()
            o = rng.integers(-40, 41, nref).tolist()
        return (ref, torch.tensor(w, dtype=torch.int32, device=dev),
                torch.tensor(o, dtype=torch.int32, device=dev), d)

    cases = [case(1, H, 6, False), case(4, H, 6, False)]
    cases += [case(4, rows, d, False) for rows in (72 + 64 + 72, 64 + 72)
              for d in (0, 7)]
    cases += [case(4, H, d, True) for d in (0, 7)]
    clipped = False
    for args in cases:
        before = LAUNCHES["grid_wp_me"]
        got = grid_wp_me(*args)
        check(LAUNCHES["grid_wp_me"] - before == 1, "grid_wp_me launches")
        want = grid_wp_me_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"grid_wp_me {tuple(args[0].shape)} d {args[3]}: differs from "
              "plain")
        clipped |= bool((want == 0).any() and (want == 255).any())
    check(clipped, "grid_wp_me adversarial: no case clipped at both ends")
    got = [grid_wp_me(*a) for a in cases[-2:]]  # back to back
    want = [grid_wp_me_plain(*a) for a in cases[-2:]]
    torch.cuda.synchronize()
    check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
          "grid_wp_me back to back: differs from plain")
    print(f"kernel grid_wp_me adversarial: {len(cases)} stacks (1 and 4 "
          "references, stripe-shaped with halo rows, d 0 / 6 / 7, negative "
          "weights and offsets clipping at 0 and 255) and two launches back "
          "to back: equal to plain", flush=True)


def check_stats_calls(calls, rows, what):
    """grid_sao's stats launch, grid_sao whole and grid_stats (where the
    picture has them: no recon fetch) against their plain versions at
    every recorded call of one P picture: torch.equal; the rows of
    grid_sao and grid_stats gain the difference (0). Prints each stats
    launch's device time a picture (events around 100 pictures' calls
    queued behind a device sleep)."""
    for name, row in (("grid_sao_stats", "grid_sao"), ("grid_sao", "grid_sao"),
                      ("grid_stats_partial", "grid_stats"),
                      ("grid_stats", "grid_stats")):
        cs = calls.get(name, [])
        if not cs:
            continue
        err = compare_calls(name, cs)
        if row in rows:
            rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], err)
        extra = ""
        if name in ("grid_sao_stats", "grid_stats_partial"):
            kern = G_FUNCS[name][0]
            dms = device_ms(lambda: [kern(*a, **k) for a, k in cs], n=100)
            extra = f", device_ms {dms:.5f} a picture"
        print(f"kernel {name:18s} {what}: calls {len(cs)} max_abs_err "
              f"{err:.3g}{extra} | {gpu_line()}", flush=True)


def stats_planes(kind, h, w, seed, dev):
    """(oy, ouv, ry, ruv) int32 8-bit planes on dev, chroma packed [U | V]:
    `noise` uniform; `flat` org = rec, one value; `band` rec one value (one
    band, every EO category 0), org noise around it."""
    rng = np.random.default_rng(seed)
    out = []
    for ph, pw in ((h, w), (h // 2, w)):
        if kind == "noise":
            o, r = rng.integers(0, 256, (2, ph, pw))
        elif kind == "flat":
            o = r = np.full((ph, pw), 77)
        else:
            r = np.full((ph, pw), 100)
            o = r + rng.integers(-40, 41, (ph, pw))
        out.append((o, r))
    return tuple(torch.as_tensor(np.clip(x, 0, 255).astype(np.int32),
                                 device=dev)
                 for x in (out[0][0], out[1][0], out[0][1], out[1][1]))


def check_stats_adversarial(dev):
    """grid_stats and grid_sao's stats launch against their plain versions
    (torch.equal) on noise, flat and one-band planes at 416x240 (grid_sao
    at CTU 64, 32 and 16; both on the 3 stripes' rows, grid_sao with their
    halo rows), grid_stats on a 1920x1088 noise picture (its luma SSE
    above 2^31), two launches of each back to back, and grid_stats (whose
    scratch and ticket are kept per stream) on two streams of one card
    without a sync between, three times."""
    stripes = ((0, 64), (64, 128), (128, H))
    for seed, kind in enumerate(("noise", "flat", "band")):
        pic = stats_planes(kind, H, W, seed, dev)
        compare_calls("grid_stats_partial", [(pic, {})])
        for ctu in (64, 32, 16):
            compare_calls("grid_sao_stats", [((*pic, ctu), {})])
        for a, b in stripes:
            top, bot = int(a > 0), int(b < H)
            oy, ouv, ry, ruv = pic
            compare_calls("grid_sao_stats", [(
                (oy[a:b], ouv[a // 2 : b // 2], ry[a - top : b + bot],
                 ruv[a // 2 - top : b // 2 + bot], 64, top), {})])
            compare_calls("grid_stats_partial", [(
                (oy[a:b], ouv[a // 2 : b // 2], ry[a:b],
                 ruv[a // 2 : b // 2], a), {})])
    big = stats_planes("noise", 1088, 1920, 7, dev)
    want = grid_stats_partial_plain(*big)
    check(int(want[1][0]) > 2 ** 31, f"1920x1088: luma SSE {int(want[1][0])}")
    compare_calls("grid_stats_partial", [(big, {})])
    pics = [stats_planes("noise", H, W, 8, dev),
            stats_planes("band", H, W, 9, dev)]
    for name, args in (("grid_stats_partial", (big, pics[1])),
                       ("grid_sao_stats", [(*p, 64) for p in pics])):
        kern, plain = G_FUNCS[name]
        got = [kern(*a) for a in args]  # back to back, no sync between
        torch.cuda.synchronize()
        for g, a in zip(got, args):
            for x, y in zip(g, plain(*a)):
                check(torch.equal(x, y), f"{name} back to back: differs")
    streams = [torch.cuda.Stream() for _ in range(2)]
    args = (big, pics[1])
    want = [grid_stats_partial_plain(*a) for a in args]
    torch.cuda.synchronize()
    for _ in range(3):
        got = []
        for a, st in zip(args, streams):
            with torch.cuda.stream(st):
                got.append(grid_stats_partial(*a))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                check(torch.equal(x, y), "grid_stats on two streams: differs")
    print("kernel grid_stats, grid_sao stats on noise, flat and one-band "
          f"planes at {W}x{H} (grid_sao at CTU 64, 32, 16; the 3 stripes' "
          "rows), grid_stats at 1920x1088 (luma SSE above 2^31), back to "
          "back, grid_stats on two streams (3 times): equal to plain",
          flush=True)


def check_deblock_calls(calls, rows, what):
    """grid_deblock at every recorded call of a P picture (or stripe):
    one launch a call, both planes torch.equal to plain; the row gains the
    difference (0)."""
    before = LAUNCHES["grid_deblock"]
    err = compare_calls("grid_deblock", calls)
    n = LAUNCHES["grid_deblock"] - before
    check(n == len(calls), f"grid_deblock {what}: {n} launches for "
          f"{len(calls)} calls")
    rows["grid_deblock"]["max_abs_err"] = max(
        rows["grid_deblock"]["max_abs_err"], err)
    print(f"kernel grid_deblock {what}: calls {len(calls)}, one launch "
          f"each, max_abs_err {err:.3g}", flush=True)


DEBLOCK_KINDS = ("steps", "noise", "intra", "rqt2", "farmv")


def deblock_inputs(kind, h, w, seed, dev):
    """Seeded inputs of grid_deblock at h x w in the grid step's dtypes and
    layout (the motion field as (2, h8, w8) planes): a CU quadtree from
    64x64 split at random, an RQT depth, motion, reference and intra flag
    a CU, a PU's own motion in some cells, a cbf a cell. `steps`: flat
    8x8 blocks 0-2 apart, every cbf set (the strong filter at every edge
    with bs > 0); `noise`: block offsets with sample noise; `intra`: every
    cell intra; `rqt2`: every CU 32x32 at RQT depth 2; `farmv`: motion
    and reference a cell (bs 1 at nearly every edge). The kinds of
    tests/torch_port_util.py `deblock_inputs`."""
    rng = np.random.default_rng(seed)
    h8, w8 = h // 8, w // 8
    log2 = np.zeros((h8, w8), np.int8)
    tsplit = np.zeros((h8, w8), np.int8)
    mv = np.zeros((h8, w8, 2), np.int32)
    ref = np.zeros((h8, w8), np.int32)
    intra = np.zeros((h8, w8), bool)

    def cu(y, x, lg):
        n = 1 << (lg - 3)
        fits = y + n <= h8 and x + n <= w8
        want = 5 if kind == "rqt2" else 3
        if lg > 3 and (not fits or lg > want and (
                kind == "rqt2" or rng.random() < 0.5)):
            for dy in (0, n // 2):
                for dx in (0, n // 2):
                    if y + dy < h8 and x + dx < w8:
                        cu(y + dy, x + dx, lg - 1)
            return
        sl = np.s_[y : y + n, x : x + n]
        log2[sl] = lg
        tsplit[sl] = (2 if kind == "rqt2" and lg == 5
                      else rng.integers(0, min(lg, 5) - 2))
        mv[sl] = rng.integers(-12, 13, 2)
        ref[sl] = rng.integers(0, 4)
        intra[sl] = kind == "intra" or rng.random() < 0.15

    for y in range(0, h8, 8):
        for x in range(0, w8, 8):
            cu(y, x, 6)
    pu = rng.random((h8, w8)) < 0.2
    mv[pu] = rng.integers(-12, 13, (int(pu.sum()), 2))
    if kind == "farmv":
        mv = rng.integers(-256, 257, (h8, w8, 2)).astype(np.int32)
        ref = rng.integers(0, 4, (h8, w8)).astype(np.int32)
    cbf = rng.random((h8, w8)) < 0.5
    if kind == "steps":
        cbf[:] = True

    def plane(ph, pw):
        blk = rng.integers(0, 3, (ph // 8 + 1, pw // 8 + 1))
        if kind == "steps":
            return 120 + np.kron(blk, np.ones((8, 8), np.int64))[:ph, :pw]
        if kind == "noise":
            blk = rng.integers(-10, 11, (ph // 8 + 1, pw // 8 + 1))
            off = np.kron(blk, np.ones((8, 8), np.int64))[:ph, :pw]
            return 128 + off + rng.integers(-3, 4, (ph, pw))
        yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float64)
        f = rng.uniform(5, 40, 4)
        return np.rint(128 + 50 * np.sin(xx / f[0] + yy / f[1])
                       + 40 * np.cos(yy / f[2] - xx / f[3])
                       + rng.normal(0, 6, (ph, pw)))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    planes = [t(np.clip(plane(ph, w), 0, 255).astype(np.int32))
              for ph in (h, h // 2)]
    return (*planes, t(log2), t(mv.transpose(2, 0, 1)).permute(1, 2, 0),
            t(ref), t(cbf), t(intra), t(tsplit))


def check_deblock_adversarial(dev):
    """grid_deblock against plain (torch.equal, one launch a call, inputs
    left as they were) on adversarial inputs (flat steps: the strong
    filter; noise; every cell intra; RQT depth 2 at CU 32; far motion at
    every edge) at QP 22, 37 and 51 on a 416x240 picture and a 128-row
    stripe-shaped buffer, on a 1920x1088 picture, and two launches back
    to back without a sync between."""
    cases = 0
    for seed, kind in enumerate(DEBLOCK_KINDS):
        for h in (H, 128):
            args = deblock_inputs(kind, h, W, 10 * seed + h, dev)
            keep = [a.clone() for a in args]
            for qp in (22, 37, 51):
                before = LAUNCHES["grid_deblock"]
                compare_calls("grid_deblock", [((*args, qp), {})])
                check(LAUNCHES["grid_deblock"] - before == 1,
                      f"grid_deblock {kind} {h} rows: "
                      f"{LAUNCHES['grid_deblock'] - before} launches")
                cases += 1
            check(all(torch.equal(a, b) for a, b in zip(args, keep)),
                  f"grid_deblock {kind}: an input changed")
    big = deblock_inputs("noise", 1088, 1920, 99, dev)
    compare_calls("grid_deblock", [((*big, 37), {})])
    pics = [big, deblock_inputs("steps", H, W, 98, dev)]
    got = [grid_deblock(*p, 32) for p in pics]  # back to back, no sync
    torch.cuda.synchronize()
    for g, p in zip(got, pics):
        for x, y in zip(g, grid_deblock_plain(*p, 32)):
            check(torch.equal(x, y), "grid_deblock back to back: differs")
    print(f"kernel grid_deblock adversarial: {cases} cases ({DEBLOCK_KINDS} "
          f"x QP 22, 37, 51 at {W}x{H} and a {W}x128 stripe-shaped "
          f"buffer), 1920x1088, two launches back to back: equal to plain, "
          f"one launch a call", flush=True)


def satd_inputs(n, S, seed, dev, flat=False):
    """(org (n, S, S), preds (n, 35, S, S)) int32 on dev: noise with the
    predictions near the original, or (flat) each block's predictions a
    few flat values, half the originals equal to one of them (ties)."""
    rng = np.random.default_rng(seed)
    org = rng.integers(0, 256, (n, S, S))
    if flat:
        preds = np.repeat(rng.integers(0, 256, (n, 1, 1, 1)), 35, 1)
        preds = preds + (rng.integers(0, 35, (n, 35, 1, 1)) % 3)
        preds = np.broadcast_to(preds, (n, 35, S, S))
        org[: n // 2] = preds[: n // 2, 0]
    else:
        preds = np.clip(org[:, None] + rng.integers(-40, 41, (n, 35, S, S)),
                        0, 255)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                 device=dev) for a in (org, preds))


def check_satd_adversarial(dev, gpu):
    """satd35_topk against plain (torch.equal) on flat references (ties:
    the lower mode first) and noise at S = 4..32 with nc 1, 8 and 35, and
    at S = 4 over a 1920x1088 picture (130,560 blocks); that launch's
    device time and bound printed."""
    for S in (4, 8, 16, 32):
        for flat in (True, False):
            org, preds = satd_inputs(390, S, S + flat, dev, flat)
            for nc in (1, 8, 35):
                got = satd35_topk(org, preds, nc)
                want = satd35_topk_plain(org, preds, nc)
                torch.cuda.synchronize()
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"satd35_topk S={S} flat={flat} nc={nc}: differs")
            if flat:
                sat = want[0]
                check(bool((sat[:, :, None] == sat[:, None]).sum()
                           > 35 * sat.shape[0]), f"S={S}: no ties")
    org, preds = satd_inputs(130560, 4, 4, dev)
    got = satd35_topk(org, preds, 8)
    want = satd35_topk_plain(org, preds, 8)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "satd35_topk S=4 at 1920x1088: differs")
    work = Work()
    work.add("satd35_topk", (org, preds, 8), got)
    b, by = bound_of(dict(work=work))
    dms = device_ms(lambda: satd35_topk(org, preds, 8), n=20)
    print(f"kernel satd35_topk adversarial: flat references (ties) and "
          f"noise at S = 4..32, nc 1, 8, 35; S = 4 at 1920x1088 (130,560 "
          f"blocks, nc 8): equal to plain; that launch device_ms {dms:.5f}, "
          f"bound {b:.6f} ms ({by}) | {gpu}", flush=True)


def bank_refs(S, bd, n, seed, dev):
    """(tops, lefts) (m, 2S+1) int32 on dev: n noise blocks, then flat
    blocks whose top and left deviations (t0 + t2S - 2 tS) take each of
    +-(2^(bd-5) - 1) and +-2^(bd-5), then blocks at 0, at (1 << bd) - 1
    and alternating between the two."""
    rng = np.random.default_rng(seed)
    hi, mid, thr = (1 << bd) - 1, 1 << (bd - 1), 1 << (bd - 5)
    t = [rng.integers(0, hi + 1, (n, 2 * S + 1))]
    l = [rng.integers(0, hi + 1, (n, 2 * S + 1))]
    for dt in (thr - 1, thr, 1 - thr, -thr):
        for dl in (thr - 1, thr, 1 - thr, -thr):
            a, b = np.full((1, 2 * S + 1), mid), np.full((1, 2 * S + 1), mid)
            a[0, 2 * S] += dt
            b[0, 2 * S] += dl
            t.append(a)
            l.append(b)
    alt = np.where(np.arange(2 * S + 1) % 2, hi, 0)
    for a, b in ((0, 0), (hi, hi), (0, hi), (alt, hi - alt)):
        t.append(np.broadcast_to(a, (1, 2 * S + 1)))
        l.append(np.broadcast_to(b, (1, 2 * S + 1)))
    return tuple(torch.as_tensor(np.concatenate(x), dtype=torch.int32,
                                 device=dev) for x in (t, l))


def bits_tiles(S, n, seed, dev):
    """(m, S, S) int32 levels on dev: all-zero, DC-only, the last position
    at the last scan position, levels up to 2^15 with alternating signs
    (every escape length), then n sparse noise TUs."""
    rng = np.random.default_rng(seed)
    edge = np.zeros((8, S, S), np.int64)
    edge[2:5, 0, 0] = (1, -7, 1 << 15)
    edge[5, S - 1, S - 1] = -1
    big = (rng.integers(0, 1 << 15, (2, S, S)) + 1) * np.where(
        np.arange(S * S).reshape(S, S) % 2, -1, 1)
    big[1] //= 1 << rng.integers(0, 15, (S, S))
    noise = np.round(rng.normal(0, rng.choice((0.4, 1.5, 6, 50), (n, 1, 1)),
                                (n, S, S)))
    noise[rng.random((n, S, S)) < rng.random((n, 1, 1))] = 0
    return torch.as_tensor(np.concatenate([edge, big, noise]),
                           dtype=torch.int32, device=dev)


def check_bank_bits_adversarial(dev, gpu):
    """intra_bank and tu_bits against plain (torch.equal) at 1920x1088: the
    bank at every S over the picture's blocks (luma with and without
    strong smoothing, chroma) with the flat threshold-edge and extreme
    reference blocks appended, at bit depths 8 and 10; tu_bits at every S
    on as many TUs as the picture holds, after the edge-case TUs; two launches of each back to back; the S = 4
    launches' device time and bound printed."""
    fb = FracBits(I_ROW, QP)
    for S in (4, 8, 16, 32):
        n = 1920 * 1088 // (S * S)
        for bd in (8, 10):
            t, l = bank_refs(S, bd, n, S + bd, dev)
            for luma, strong in ((True, True), (True, False), (False, False)):
                got = intra_bank(t, l, S, luma, bd, strong)
                want = predict_all_modes_plain(t, l, S, luma, bd, strong)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"intra_bank S={S} bd={bd} "
                      f"luma={luma} strong={strong} at 1920x1088: differs")
                del got, want
        for luma in (True, False) if S < 32 else (True,):
            est = est_tables(fb, S.bit_length() - 1, luma, dev)
            tiles = bits_tiles(S, n, S + luma, dev)
            got, want = tu_bits(est, tiles), tu_bits_plain(est, tiles)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"tu_bits S={S} luma={luma} "
                  f"at 1920x1088: differs")
    ins = [bank_refs(4, 8, 130560, s, dev) for s in (1, 2)]
    est = est_tables(fb, 2, True, dev)
    tiles = [bits_tiles(4, 130560, s, dev) for s in (3, 4)]
    banks = [intra_bank(t, l, 4, True, 8, True) for t, l in ins]
    bits = [tu_bits(est, x) for x in tiles]  # back to back, no sync
    torch.cuda.synchronize()
    for g, (t, l) in zip(banks, ins):
        check(torch.equal(g, predict_all_modes_plain(t, l, 4, True, 8, True)),
              "intra_bank back to back: differs")
    for g, x in zip(bits, tiles):
        check(torch.equal(g, tu_bits_plain(est, x)),
              "tu_bits back to back: differs")
    for name, fn, args, out in (
            ("intra_bank", intra_bank, (*ins[0], 4, True, 8, True), banks[0]),
            ("tu_bits", tu_bits, (est, tiles[0]), bits[0])):
        work = Work()
        work.add(name, args, out)
        b, by = bound_of(dict(work=work))
        dms = device_ms(lambda: fn(*args), n=20)
        print(f"kernel {name} adversarial at 1920x1088: S = 4 ({args[1].shape[0]} "
              f"{'blocks' if name == 'intra_bank' else 'TUs'}) device_ms "
              f"{dms:.5f}, bound {b:.6f} ms ({by}) | {gpu}", flush=True)
    print("kernel intra_bank, tu_bits adversarial: every S at 1920x1088 "
          "(the bank with flat threshold-edge and extreme references at bit "
          "depths 8 and 10, luma with and without strong smoothing, chroma; "
          "tu_bits on all-zero, DC-only, last-position and 2^15 escape TUs), two launches back to back: equal to "
          f"plain | {gpu}", flush=True)


# the anchor picture's kernels held again at every call of the weighted
# picture
WP_TOO = ("grid_planes", "grid_refine", "grid_intra16")
# the motion search's first launches: the coarse stack, the prestage's pick
ME_FIRST = ("grid_coarse", "grid_prestage")


def check_two_streams(anchor, fade):
    """The ticket scratches on two streams of one card: the split S = 32
    launch of grid_refine (chunks of starts meeting through a candidate
    scratch, the last by a ticket) of the anchor picture and of the fade
    picture, and grid_sao_decide of both, each pair launched on two
    streams without a sync between (three times), each launch equal to
    plain: a launch finds the scratch and ticket of its own stream."""
    refine = [next((a, k) for a, k in c["grid_refine"] if a[2] == 32)
              for c in (anchor, fade)]
    pairs = {"grid_refine": refine,
             "grid_sao_decide": [c["grid_sao_decide"][0]
                                 for c in (anchor, fade)]}
    streams = [torch.cuda.Stream() for _ in range(2)]
    for name, cs in pairs.items():
        kern, plain = G_FUNCS[name]
        want = [plain(*a, **k) for a, k in cs]
        torch.cuda.synchronize()
        for _ in range(3):
            got = []
            for (a, k), st in zip(cs, streams):
                with torch.cuda.stream(st):
                    got.append(kern(*a, **k))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                for x, y in zip(tensors(g), tensors(w)):
                    check(torch.equal(x, y), f"{name} on two streams: "
                          "outputs differ from plain")
        print(f"kernel {name:12s} two streams of one card, no sync "
              f"between, 3 times: equal to plain", flush=True)


def check_cost_calls(cost):
    """The anchor picture's grid_satd_cost calls price every CU class (8
    to 64) in both modes (the DC-aware cost; the rect trial's sums), the
    merge trial's three candidates (TMVP) in one launch."""
    modes = {a[4] if len(a) > 4 else k.get("mode", "z") for a, k in cost}
    sizes = {fl.size for a, _ in cost for fl in a[2]}
    merge3 = any(len(a[2]) == 3 and len({fl.size for fl in a[2]}) == 1
                 and (a[4] if len(a) > 4 else "z") == "z" for a, _ in cost)
    check(modes == {"z", "plain"} and sizes >= {8, 16, 32, 64} and merge3,
          f"grid_satd_cost calls: modes {modes}, CU sizes {sizes}, a merge "
          f"call of three fields {merge3}")


def planes_library_ms(calls):
    """Event ms of torch.nn.functional.conv2d over one picture's
    grid_planes calls: each call's padded stack (n, 1, hm + nt - 1, wm +
    nt - 1) against the P x P phase filters (outer products of the taps)
    as weights, in float32 with TF32 off (|v| < 2^22: the sums are exact
    where the algorithm multiplies and adds in float32). The call leaves
    out the rounding and the int16 cast. Each call's sums, rounded as the
    kernel rounds, should give its planes (printed); where cuDNN's choice
    is not exact, cuDNN is switched off and the call timed again."""
    F = torch.nn.functional
    prep = []
    for a, k in calls:
        stack, luma, pad, hm, wm = a[:5]
        y0 = a[6] if len(a) > 6 else k.get("y0", 0)
        n, h, w = stack.shape
        taps = torch.tensor(LUMA_TAPS if luma else CHROMA_TAPS,
                            dtype=torch.float32, device=stack.device)
        P, nt = taps.shape
        ys = (torch.arange(y0 + 1, y0 + hm + nt, device=stack.device)
              - pad).clamp(0, h - 1)
        xs = (torch.arange(1, wm + nt, device=stack.device) - pad).clamp(
            0, w - 1)
        x = stack[:, ys][:, :, xs].float()[:, None].contiguous()
        wgt = (taps[:, None, :, None] * taps[None, :, None, :]).reshape(
            P * P, 1, nt, nt).contiguous()
        planes = grid_planes(*a, **k).reshape(n, P * P, hm, wm)
        prep.append((x, wgt, planes))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for cudnn in (True, False):
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                exact = all(torch.equal(
                    (((F.conv2d(x, wgt).int() >> 6) + 32) >> 6).clamp(
                        0, 255).short(), pl) for x, wgt, pl in prep)
                ms = median_ms(lambda: [F.conv2d(x, wgt)
                                        for x, wgt, _ in prep], reps=20)
            print(f"library grid_planes: conv2d (cuDNN {cudnn}) "
                  f"{ms:.4f} ms a P picture ({len(prep)} calls), rounded "
                  f"sums equal to the planes: {exact}", flush=True)
            if exact:
                break
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return ms


def coarse_library_ms(calls):
    """Event ms of torch.cdist (p=1) over one picture's grid_coarse calls:
    each 8x8 tile of the pooled picture (1, 64) against its n x n offset
    windows of the padded pooled reference (n^2, 64), float32 (the sums
    stay below 2^24, so they are exact), prepared outside the timed calls.
    The call computes the SAD stack only: not the shift, not the DC sums.
    Its SADs, shifted, must equal the kernel's stack. Returns its event
    ms and device ms."""
    prep = []
    for a, k in calls:
        cur, refp, n, tile, shift = a[:5]
        h, w = cur.shape
        nbh, nbw = h // tile, w // tile
        x1 = (cur.reshape(nbh, tile, nbw, tile).permute(0, 2, 1, 3)
              .reshape(nbh * nbw, 1, tile * tile).float().contiguous())
        win = refp.unfold(0, tile, 1).unfold(1, tile, 1)  # (.., .., t, t)
        ty = torch.arange(nbh, device=cur.device) * tile
        tx = torch.arange(nbw, device=cur.device) * tile
        o = torch.arange(n, device=cur.device)
        yy = (ty[:, None, None, None] + o[None, None, :, None]).expand(
            nbh, nbw, n, n)
        xx = (tx[None, :, None, None] + o[None, None, None, :]).expand(
            nbh, nbw, n, n)
        x2 = win[yy, xx].reshape(nbh * nbw, n * n, tile * tile).float()
        x2 = x2.contiguous()
        sad = grid_coarse(*a, **k)[0]
        d = torch.cdist(x1, x2, p=1)[:, 0]
        check(torch.equal((d.int() << shift).T.reshape(n * n, nbh, nbw),
                          sad), "torch.cdist's SADs differ from grid_coarse's")
        prep.append((x1, x2))
    def lib():
        return [torch.cdist(x1, x2, p=1) for x1, x2 in prep]

    ms, dms = median_ms(lib, reps=20), device_ms(lib, n=20)
    print(f"library grid_coarse: torch.cdist(p=1) of "
          f"{[x1.shape[0] for x1, _ in prep]} pooled 8x8 tiles against "
          f"{[x2.shape[1] for _, x2 in prep]} offset windows each (float32), "
          f"the SAD stack only: event ms {ms:.4f}, device_ms {dms:.5f} a P "
          f"picture | {gpu_line()}", flush=True)
    return ms, dms


def refine_library_ms(calls):
    """Event ms of torch.cdist (p=1) over one picture's grid_refine calls
    (every reference's starts, a launch a block size): each picture block
    (1, S^2) against the 49 candidates of its (S + 6)^2 window at each
    start (49, S^2), float32 (exact below 2^24), the windows gathered from
    the reference stack outside the timed calls. The call computes the SAD
    surfaces only: not the DC-aware cost, the MV rate, the reference bits,
    the first-index pick, sad9 or the quadrants. At every block whose MV
    lies inside the limit, the winner's SAD (sad9's centre) must be a
    value of the surface at the winner's candidate. Returns its event ms
    and device ms."""
    sig = inspect.signature(grid_refine_refs_plain)
    prep = []
    for a, k in calls:
        b = sig.bind(*a, **k)
        b.apply_defaults()
        g = b.arguments
        ry, oy, S, nbh, nbw = g["ry"], g["oy"], g["S"], g["nbh"], g["nbw"]
        starts, ry_y0, lim = g["starts"], g["ry_y0"], g["lim"]
        dev = oy.device
        _, hr, wr = ry.shape
        G, nb = starts.shape[0], nbh * nbw
        sref = (torch.zeros(G, dtype=torch.long, device=dev)
                if g["sref"] is None else g["sref"].long())
        ar = torch.arange(S + 6, device=dev)
        bx = (torch.arange(nbw, device=dev) * S).repeat(nbh)
        by = (torch.arange(nbh, device=dev) * S).repeat_interleave(nbw)
        cx, cy = starts[..., 0].long(), starts[..., 1].long()
        yy = (by[None, :, None] + cy[..., None] - 3 + ry_y0 + ar).clamp(
            0, hr - 1)
        xx = (bx[None, :, None] + cx[..., None] - 3 + ar).clamp(0, wr - 1)
        wnd = ry.reshape(-1)[(sref[:, None, None, None] * hr
                              + yy[..., :, None]) * wr + xx[..., None, :]]
        x2 = (wnd.unfold(2, S, 1).unfold(3, S, 1)
              .reshape(G * nb, 49, S * S).float().contiguous())
        cur = (oy[: nbh * S, : nbw * S].reshape(nbh, S, nbw, S)
               .permute(0, 2, 1, 3).reshape(nb, 1, S * S))
        x1 = cur.expand(G, nb, 1, S * S).reshape(G * nb, 1, S * S).float()
        x1 = x1.contiguous()
        (mv, sad9, _, ref), _ = grid_refine_refs(*a, **k)
        d = torch.cdist(x1, x2, p=1)[:, 0].reshape(G, nb, 49)
        kk = torch.arange(49, device=dev)
        cand = torch.stack([cx[..., None] + kk % 7 - 3,
                            cy[..., None] + kk // 7 - 3], -1)  # (G, nb, 49, 2)
        hit = ((cand == mv[None, :, None]).all(-1)
               & (sref[:, None, None] == ref[None, :, None].long())
               & (d.int() == sad9[None, :, None, 4]))
        inside = (mv.abs() < lim).all(-1)
        check(bool(hit.any(2).any(0)[inside].all()) and
              int(inside.sum()) * 10 >= 9 * nb,
              "torch.cdist's SAD at grid_refine's picks differs from sad9")
        prep.append((x1, x2))
    def lib():
        return [torch.cdist(x1, x2, p=1) for x1, x2 in prep]

    ms, dms = median_ms(lib, reps=20), device_ms(lib, n=20)
    print(f"library grid_refine: torch.cdist(p=1) of "
          f"{[x1.shape[0] for x1, _ in prep]} (start, block) pairs against "
          f"their 49 candidates (float32), the SAD surfaces only: event ms "
          f"{ms:.4f}, device_ms {dms:.5f} a P picture | {gpu_line()}",
          flush=True)
    return ms, dms


def gather_index(planes, mv, ref, cell, look):
    """grid_satd_plain's flat index into planes (R, P, P, hm, wm) of the
    cells' predictions (C, hc cell, wc cell)."""
    _, P, _, hm, wm = planes.shape
    dev = planes.device
    fb = P.bit_length() - 1
    mvp = mv.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    rp = ref.long().repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    yg = torch.arange(rp.shape[1], device=dev)[None, :, None]
    xg = torch.arange(rp.shape[2], device=dev)[None, None, :]
    fx, fy = mvp[..., 0] & (P - 1), mvp[..., 1] & (P - 1)
    ix = (mvp[..., 0] >> fb) + xg + look
    iy = (mvp[..., 1] >> fb) + yg + look
    return (((rp * P * P + fy * P + fx) * hm) + iy) * wm + ix


def gather_library_ms(calls):
    """Event ms of one advanced-index gather per grid_satd call over one
    picture: the call's luma and chroma phase planes flattened into one
    tensor and its predictions' flat indices (luma, then U and V) built
    outside the timed calls. The call leaves out the indices' arithmetic
    from the MVs and references and the int16 to int32 widening. Its
    values, widened, must equal the kernel's predictions. Returns its
    event ms and device ms."""
    prep = []
    for a, k in calls:
        py, pc, mv8, ref8, look, look_c = a[:6]
        R = py.shape[0]
        iy = gather_index(py, mv8[None], ref8[None], 8, look)
        ic = gather_index(pc, torch.stack([mv8, mv8]),
                          torch.stack([ref8, ref8 + R]), 4, look_c)
        flat = torch.cat([py.reshape(-1), pc.reshape(-1)])
        idx = torch.cat([iy.reshape(-1), ic.reshape(-1) + py.numel()])
        got = flat[idx].int()
        pred_y, pred_uv = grid_mc(*a, **k)
        n = iy.numel()
        uv = got[n:].reshape(2, *ic.shape[1:])
        check(torch.equal(got[:n].reshape(pred_y.shape), pred_y)
              and torch.equal(torch.cat([uv[0], uv[1]], 1), pred_uv),
              "the library gather differs from grid_satd's predictions")
        prep.append((flat, idx))
    def lib():
        return [f[i] for f, i in prep]

    ms, dms = median_ms(lib, reps=20), device_ms(lib, n=20)
    print(f"library grid_satd: one advanced-index gather a call "
          f"({len(prep)} calls, {sum(i.numel() for _, i in prep)} samples), "
          f"the indices built before: event ms {ms:.4f}, device_ms "
          f"{dms:.5f} a P picture | {gpu_line()}", flush=True)
    return ms, dms


# the grid kernels timed beside one PyTorch call of their function
LIBRARY_OF = {"grid_coarse": coarse_library_ms,
              "grid_refine": refine_library_ms,
              "grid_satd": gather_library_ms}


def host_ms(fn, reps=10):
    """Median host time of fn (what the caller waits before it can issue
    more work; no synchronisation inside), ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def check_sao_decide(sao_calls):
    """grid_sao_decide against its plain version at every call of the
    anchor P picture (the statistics that grid_sao's kernel gives for each
    recorded grid_sao call; grid_sao's own phase holds the SAO'd planes
    and rows against grid_sao_plain): par and the parameter rows exact.
    Also times
    grid_sao whole, with the decision as the kernel and, as before it was
    one, as the plain torch glue between the two kernels: CUDA-event and
    host time per P picture. Returns {"grid_sao_decide": row}."""
    calls = {"grid_sao_decide": []}
    saved = recording(grid_sao_mod, ("grid_sao_decide",), calls)
    try:
        for a, k in sao_calls:
            grid_sao(*a, **k)
        torch.cuda.synchronize()
    finally:
        grid_sao_mod.grid_sao_decide = saved["grid_sao_decide"]
    dc = calls["grid_sao_decide"]
    check(len(dc) == len(sao_calls), f"grid_sao_decide: {len(dc)} calls for "
          f"{len(sao_calls)} of grid_sao")
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=Work())
    r["max_abs_err"] = compare_calls("grid_sao_decide", dc, r["work"])
    r["ms"] = median_ms(lambda: [grid_sao_decide(*a, **k) for a, k in dc],
                        reps=20)
    r["plain_ms"] = median_ms(
        lambda: [grid_sao_decide_plain(*a, **k) for a, k in dc], reps=5)

    def whole():
        return [grid_sao(*a, **k) for a, k in sao_calls]

    after = (median_ms(whole, reps=20), host_ms(whole))
    grid_sao_mod.grid_sao_decide = grid_sao_decide_plain
    try:
        before = (median_ms(whole, reps=10), host_ms(whole))
    finally:
        grid_sao_mod.grid_sao_decide = saved["grid_sao_decide"]
    r["sao"] = dict(event_ms=after[0], host_ms=after[1],
                    glue_event_ms=before[0], glue_host_ms=before[1])
    print(f"kernel grid_sao_decide P picture calls {len(dc):3d} max_abs_err "
          f"{r['max_abs_err']:.3g} kernel_ms {r['ms']:.4f} plain_ms "
          f"{r['plain_ms']:.4f} (per P picture) | grid_sao whole per P "
          f"picture: event {after[0]:.4f} ms, host {after[1]:.4f} ms; with "
          f"the decision as torch glue: event {before[0]:.4f} ms, host "
          f"{before[1]:.4f} ms", flush=True)
    return {"grid_sao_decide": r}


def multi_calls(dev):
    """The stripe kernels' calls of main path 7 at 416x240: the prescreen
    of frame 1's luma over 1 and 3 stripes and of the dryrun's 128x128
    plane over 2, and the refine of frame 1 against frame 0 over 3
    stripes (the coarse winners of the grid's coarse search), recorded ->
    ({name: [(args, kwargs)]}, prescreen args, refine args, the refine
    functions)."""
    clip = Reader(W, H, 2).frames
    oy = torch.as_tensor(clip[1][0].astype(np.int32), device=dev)
    ry = torch.as_tensor(clip[0][0].astype(np.int32), device=dev)
    cfg = ldp_cfg(None)
    step = inter_grid.GridStep(cfg, {}, dev)
    qp = step.qps[0]
    lam_me = int(round(np.sqrt(p_frame_lambda(cfg, 0, qp)) * 256))
    s16, sum16 = grid_coarse(tile_sum(oy, 2).int(), step._pad_edge(
        tile_sum(ry, 2).int(), step.R2), step.nc, 8, 1, True)
    cx4, cy4 = step.pick_coarse(s16, sum16, qp, lam_me, H // 16, W // 16, 1)
    graft = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 256, (128, 128)), dtype=torch.int32, device=dev)
    calls = {"stripe_prescreen": [], "grid_refine_one": []}
    saved = recording(mesh_mod, ("stripe_prescreen",), calls)
    saved_g = recording(inter_grid, ("grid_refine_one",), calls)
    try:
        for n, plane in ((1, oy), (3, oy), (2, graft)):
            mesh_mod.tile_prescreen(mesh_mod.make_mesh(n), *plane.shape)(
                plane)
        refine = mesh_mod.stripe_refine(cfg, {}, mesh_mod.make_mesh(3))
        refine[0](oy, ry, cx4.contiguous(), cy4.contiguous())
        torch.cuda.synchronize()
    finally:
        restore(mesh_mod, saved)
        restore(inter_grid, saved_g)
    return calls, oy, (oy, ry, cx4.contiguous(), cy4.contiguous()), refine


def check_multi_kernels(calls, rows):
    """stripe_prescreen at every call of main path 7's prescreens (one
    launch a call: 416x240 in 1 and 3 stripes and the dryrun's 128x128 in
    2), then on adversarial inputs, and grid_refine with ry_y0 at every
    call of the 3-stripe refine at 416x240 (multi_calls), against their
    plain versions: exact. Returns {"stripe_prescreen": row}; ms/plain_ms
    per prescreen of 416x240 in 3 stripes (one launch); grid_refine's row
    gains the stripes' max difference."""
    pre = calls["stripe_prescreen"]
    r = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, work=Work())
    shapes = [tuple(a[0].shape) + (a[2],) for a, _ in pre]
    check(shapes == [(H, W, H), (H, W, H // 3), (128, 128, 64)],
          f"stripe_prescreen calls (rows, stripe rows): {shapes}")
    r["max_abs_err"] = compare_calls("stripe_prescreen", pre)
    a, k = pre[1]  # 416x240 in 3 stripes
    r["work"].add("stripe_prescreen", a, stripe_prescreen_rows(*a, **k), k)
    r["ms"] = median_ms(lambda: stripe_prescreen_rows(*a, **k), reps=20)
    r["plain_ms"] = median_ms(lambda: stripe_prescreen_rows_plain(*a, **k),
                              reps=3)
    r["device_ms"] = device_ms(lambda: stripe_prescreen_rows(*a, **k), n=100)
    bound_ms, bound_by = bound_of(r)
    print(f"kernel stripe_prescreen calls {len(pre)} (416x240 in 1 and 3 "
          f"stripes, 128x128 in 2; a launch each) max_abs_err "
          f"{r['max_abs_err']:.3g}; 416x240 in 3 stripes: kernel_ms "
          f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} device_ms "
          f"{r['device_ms']:.5f} (events around 100 launches queued behind "
          f"a device sleep), bound {bound_ms:.6f} ms ({bound_by}; "
          f"{r['work'].bytes} bytes, {r['work'].ops} operations) | "
          f"{gpu_line()}", flush=True)
    check_prescreen_adversarial(a[0].device)
    ref = calls["grid_refine_one"]
    check(len(ref) == 3 and all(a[-1] == 40 for a, _ in ref),
          f"grid_refine stripe calls: ry_y0 {[a[-1] for a, _ in ref]}")
    err = compare_calls("grid_refine_one", ref)
    ms = median_ms(lambda: [grid_refine(*a, **k) for a, k in ref], reps=20)
    plain_ms = median_ms(lambda: [grid_refine_plain(*a, **k)
                                  for a, k in ref], reps=3)
    work = Work()
    for a, k in ref:
        work.add("grid_refine_one", a, grid_refine(*a, **k), k)
    bound_ms, bound_by = bound_of(dict(work=work))
    rows["grid_refine"]["max_abs_err"] = max(
        rows["grid_refine"]["max_abs_err"], err)
    rows["grid_refine"]["stripes_ms"] = ms
    print(f"kernel grid_refine   3 stripes of 416x240 with ry_y0 40: "
          f"max_abs_err {err:.3g} kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} bound {bound_ms:.6f} ms ({bound_by}; "
          f"{work.bytes} bytes, {work.ops} operations)", flush=True)
    return {"stripe_prescreen": r}


def check_prescreen_adversarial(dev):
    """stripe_prescreen_rows against its plain version on adversarial
    inputs, one launch a call, modes and costs exact: width 72 (9 blocks a
    row: the last run of 4 ends one block in), bit depth 10, flat planes
    at 0 and at the maximum (every block's costs tie inside), a halo row
    (a later device's first stripe), 8 stripes, and 1920x1088 in 17
    stripes of 64 rows (its device time printed)."""
    rng = np.random.default_rng(SEED)
    # (width, stripe rows, stripes, bit depth, plane, with a halo row)
    cases = ((72, 8, 2, 8, "noise", False), (72, 24, 1, 10, "noise", True),
             (128, 16, 2, 8, "zero", False), (128, 8, 3, 10, "max", True),
             (128, 16, 8, 8, "noise", True),
             (1920, 64, 17, 8, "noise", False))
    for w, hl, k, bd, kind, with_halo in cases:
        maxv = (1 << bd) - 1
        rows = (rng.integers(0, maxv + 1, (k * hl, w)) if kind == "noise"
                else np.full((k * hl, w), 0 if kind == "zero" else maxv))
        rows = torch.as_tensor(rows, dtype=torch.int32, device=dev)
        halo = (torch.as_tensor(rng.integers(0, maxv + 1, (1, w)),
                                dtype=torch.int32, device=dev)
                if with_halo else None)
        n0 = LAUNCHES["stripe_prescreen"]
        got = stripe_prescreen_rows(rows, halo, hl, bd)
        check(LAUNCHES["stripe_prescreen"] == n0 + 1,
              "stripe_prescreen: not one launch a call")
        want = stripe_prescreen_rows_plain(rows, halo, hl, bd)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"stripe_prescreen {w}x{k * hl} in {k} stripes, bd {bd}, "
              f"{kind}: differs from plain")
        if w == 1920:
            dms = device_ms(lambda: stripe_prescreen_rows(rows, halo, hl, bd),
                            n=100)
            print(f"kernel stripe_prescreen 1920x1088 in 17 stripes: equal "
                  f"to plain, device_ms {dms:.5f} a launch | {gpu_line()}",
                  flush=True)
    print(f"kernel stripe_prescreen adversarial: {len(cases)} cases equal "
          f"to plain, one launch each", flush=True)


# path 7's grid step on row stripes: the anchor cfg uncut at 416x240 in 3
# stripes of n x cuda:0 (64, 64 and 112 rows), 16 chained P pictures
N_STRIPES, N_SHARD = 3, 16
# every kernel call of one grid P picture (in the grid step's
# namespace), for its bound
STEP_CALLS = ("grid_coarse", "grid_prestage", "grid_refine", "grid_planes",
              "grid_satd", "grid_satd_cost", "grid_code", "grid_intra16",
              "grid_deblock", "grid_sao_stats", "grid_sao_apply",
              "grid_sao_decide", "grid_stats_partial", "nn_refine_classes")
# the launches a stripe's row origin reaches: their calls held vs plain
# (the coarse entries at the stripes' pooled shapes)
STRIPE_KERNELS = ("grid_coarse", "grid_prestage", "grid_refine",
                  "grid_intra16", "grid_planes", "grid_deblock",
                  "grid_sao_stats", "grid_sao_apply", "grid_stats_partial")


def shard_cfg(npz, extra=()):
    """The anchor cfg with TMVP granted, as encode_sequence grants it."""
    cfg = ldp_cfg(npz, extra=extra)
    cfg.sps.temporal_mvp_enabled = cfg.tmvp
    return cfg


def sharded_step(cfg, params):
    qps = {min(max(cfg.qp + o, 0), 51) for o in cfg.gop_qp_offsets}
    return mesh_mod.sharded_frame_step(cfg, {q: params for q in qps},
                                       mesh_mod.make_mesh(N_STRIPES))


def stripe_calls(dev, npz, params):
    """One 416x240 P picture (frame 4 against frames 3..0, a random
    collocated field, GOP position 0) through the sharded step in 3
    stripes and through the single one, of the anchor cfg and of it
    without the recon fetch, recording every kernel call ->
    ({"sharded" | "single" | "sharded_nofetch": {name: [(args, kw)]}},
    the sharded step's exchange bytes of the anchor picture, {"sharded" |
    "single": a function that runs the anchor picture again})."""
    clip = Reader(W, H, 5).frames
    out, xbytes, runs = {}, 0, {}
    for tag, extra in (("", ()), ("_nofetch", NO_FETCH)):
        cfg = shard_cfg(npz, extra)
        sharded, single, meta = sharded_step(cfg, params)
        R = meta["R"]
        rng = np.random.default_rng(SEED)
        hc16, wc16 = H // 16, W // 16
        carry = meta["step"].carry0(
            torch.as_tensor(np.stack([clip[3 - r][0] for r in range(R)])
                            .astype(np.int32), device=dev),
            torch.as_tensor(np.stack([np.concatenate(clip[3 - r][1:], 1)
                                      for r in range(R)]).astype(np.int32),
                            device=dev))
        carry = carry[:3] + (
            torch.as_tensor(rng.integers(-24, 25, (hc16, wc16, 2)),
                            dtype=torch.int32, device=dev),
            torch.as_tensor(rng.integers(0, R + 1, (hc16, wc16)),
                            dtype=torch.int32, device=dev))
        fu8 = torch.as_tensor(np.concatenate([p.ravel() for p in clip[4]]),
                              device=dev)
        if not tag:
            runs = {"sharded": lambda s=sharded, m=meta, c=carry, f=fu8, R=R:
                    s(m["split"](c), f, R, 0),
                    "single": lambda s=single, c=carry, f=fu8, R=R:
                    s(c, f, R, 0)}
        for kind in ("sharded", "single"):
            calls = {k: [] for k in STEP_CALLS}
            saved = recording(inter_grid, STEP_CALLS, calls)
            try:
                if kind == "sharded":
                    x0 = (meta["exchange"].halo_bytes
                          + meta["exchange"].field_bytes)
                    sharded(meta["split"](carry), fu8, R, 0)
                    if not tag:
                        xbytes = (meta["exchange"].halo_bytes
                                  + meta["exchange"].field_bytes - x0)
                else:
                    single(carry, fu8, R, 0)
                torch.cuda.synchronize()
            finally:
                restore(inter_grid, saved)
            out[kind + tag] = calls
    return out, xbytes, runs


def step_bound(calls):
    """(bound ms, bytes, operations) of one grid P picture's kernel calls:
    each kernel's bound (the larger of its bytes and operations terms),
    summed."""
    total, nbytes, ops = 0.0, 0, 0
    for name, cs in calls.items():
        if not cs:
            continue
        work = Work()
        for a, k in cs:
            work.add(name, a, G_FUNCS[name][0](*a, **k), k)
        total += bound_of(dict(work=work))[0]
        nbytes += work.bytes
        ops += work.ops
    torch.cuda.synchronize()
    return total, nbytes, ops


def check_stripe_kernels(calls, xbytes, runs, rows):
    """The row-origin launches of one sharded picture (grid_coarse and
    grid_prestage at each stripe's pooled rows, grid_refine over
    every reference with its stripe's ry_y0, grid_intra16 with
    y0 1 in stripes 1 and 2, grid_planes from each stripe's row origin in
    its carried reference rows, grid_sao's stats and apply with their halo
    rows, grid_stats' partial sums without the fetch) against their plain
    versions: exact; their rows gain the stripes' max difference. Also
    the bound of the sharded and of the single step a picture (the
    kernels' bounds summed; the sharded one plus its exchange bytes over
    HBM), and both steps' times on that picture, with the kernels and
    with every kernel's plain version in its place. Returns {"sharded" |
    "single": {bound, ms, plain_ms}}."""
    sh = dict(calls["sharded"])
    sh["grid_stats_partial"] = calls["sharded_nofetch"]["grid_stats_partial"]
    origin = {"grid_coarse": "grid_coarse", "grid_prestage": "grid_prestage",
              "grid_refine": "grid_refine", "grid_intra16": "grid_intra16",
              "grid_planes": "grid_planes", "grid_deblock": "grid_deblock",
              "grid_sao_stats": "grid_sao", "grid_sao_apply": "grid_sao",
              "grid_stats_partial": "grid_stats"}
    ys = sorted({k.get("y0", 0) for _, k in sh["grid_intra16"]})
    check(len(sh["grid_intra16"]) == 2 * N_STRIPES and ys == [0, 1],
          f"grid_intra16 stripe calls: y0 {ys}")
    for name in STRIPE_KERNELS:
        cs = sh[name]
        n_calls = N_STRIPES * (2 if name in ("grid_refine", "grid_intra16",
                                             "grid_planes") else 1)
        check(len(cs) == n_calls, f"{name}: {len(cs)} calls in "
              f"{N_STRIPES} stripes")
        err = compare_calls(name, cs)
        kern, plain = G_FUNCS[name]
        ms = median_ms(lambda: [kern(*a, **k) for a, k in cs], reps=10)
        plain_ms = median_ms(lambda: [plain(*a, **k) for a, k in cs],
                             reps=3)
        r = rows[origin[name]]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("stripes", {})[name] = dict(ms=ms, plain_ms=plain_ms)
        print(f"kernel {name:18s} {N_STRIPES} stripes of {W}x{H} (row "
              f"origins): calls {len(cs)} max_abs_err {err:.3g} kernel_ms "
              f"{ms:.4f} plain_ms {plain_ms:.4f}", flush=True)
    # K2 (a launch a stripe, each over its stripe's classes) and the
    # picture's one SAO decision over the gathered statistics
    check(len(sh["nn_refine_classes"]) == N_STRIPES
          and len(sh["grid_sao_decide"]) == 1,
          f"stripes: K2 {len(sh['nn_refine_classes'])} calls, "
          f"grid_sao_decide {len(sh['grid_sao_decide'])}")
    compare_k2(sh["nn_refine_classes"], f"{N_STRIPES} stripes")
    err = compare_calls("grid_sao_decide", sh["grid_sao_decide"])
    rows["grid_sao_decide"]["max_abs_err"] = max(
        rows["grid_sao_decide"]["max_abs_err"], err)
    print(f"kernel grid_sao_decide {N_STRIPES} stripes of {W}x{H} (the "
          f"gathered statistics): calls 1 max_abs_err {err:.3g}", flush=True)
    out = {}
    plain = {k: G_FUNCS[k][1] for k in STEP_CALLS}
    for kind in ("sharded", "single"):
        cs = {k: v for k, v in calls[kind].items() if v}
        b, nb, ops = step_bound(cs)
        if kind == "sharded":
            b += xbytes / HBM_BPS * 1e3
        ms = median_ms(runs[kind], reps=5)
        saved = {k: getattr(inter_grid, CALLED_AS.get(k, k)) for k in plain}
        try:
            for k, fn in plain.items():
                setattr(inter_grid, CALLED_AS.get(k, k), fn)
            plain_ms = median_ms(runs[kind], reps=2)
        finally:
            restore(inter_grid, saved)
        out[kind] = dict(bound=b, ms=ms, plain_ms=plain_ms)
        print(f"{kind} grid step, one {W}x{H} anchor P picture: event ms "
              f"{ms:.3f} with the kernels, {plain_ms:.3f} with their plain "
              f"versions | {gpu_line()}", flush=True)
        print(f"bound of the {kind} grid step, one {W}x{H} P picture: "
              f"{b:.6f} ms (kernels' bounds summed: {nb} bytes, {ops} "
              f"operations" + (f"; + {xbytes} bytes exchanged"
                               if kind == "sharded" else "") + ")",
              flush=True)
    return out


def check_stripe_subpel(dev, npz, params, rows):
    """grid_subpel at every call of one 416x240 P picture of the fade clip
    (frame 4 against frames 3..0, its analysed WP tables) with the anchor
    cfg, dctif, WP and no fetch, through the sharded step in 3 stripes
    (one launch a stripe over its classes) and through the single step
    (one launch): kernel vs plain, exact."""
    clip = Reader(W, H, 5, fade=True).frames
    sharded, single, meta = sharded_step(
        shard_cfg(npz, FME_WP + NO_FETCH), params)
    R = meta["R"]
    carry = meta["step"].carry0(
        torch.as_tensor(np.stack([clip[3 - r][0] for r in range(R)])
                        .astype(np.int32), device=dev),
        torch.as_tensor(np.stack([np.concatenate(clip[3 - r][1:], 1)
                                  for r in range(R)]).astype(np.int32),
                        device=dev))
    fu8 = torch.as_tensor(np.concatenate([p.ravel() for p in clip[4]]),
                          device=dev)
    wp = picture_wp(clip, R, dev)[0]
    for kind, n_calls in (("sharded", N_STRIPES), ("single", 1)):
        calls = {"grid_subpel": []}
        saved = recording(inter_grid, ("grid_subpel",), calls)
        try:
            if kind == "sharded":
                sharded(meta["split"](carry), fu8, R, 0, wp)
            else:
                single(carry, fu8, R, 0, wp)
            torch.cuda.synchronize()
        finally:
            restore(inter_grid, saved)
        cs = calls["grid_subpel"]
        check(len(cs) == n_calls, f"grid_subpel {kind}: {len(cs)} calls")
        err = compare_calls("grid_subpel", cs)
        rows["grid_subpel"]["max_abs_err"] = max(
            rows["grid_subpel"]["max_abs_err"], err)
        ms = median_ms(lambda: [grid_subpel_classes(*a, **k)
                                for a, k in cs], reps=10)
        print(f"kernel grid_subpel {kind} step, {W}x{H} dctif + WP P "
              f"picture{f' in {N_STRIPES} stripes' if n_calls > 1 else ''}: "
              f"calls {len(cs)} (classes {[len(a[2]) for a, _ in cs]}) "
              f"max_abs_err {err:.3g} kernel_ms {ms:.4f}", flush=True)


def run_sharded(dev, npz, params, gpu, bounds):
    """Path 7's grid step on row stripes: the anchor cfg uncut at 416x240,
    16 P pictures chained from the IDR's state (its recon as every
    reference, GOP positions 0-3 in turn) through the sharded step in 3
    stripes and, on the same carry, the single one: every packed row
    and carry equal; per picture the sharded step launches each grid
    kernel 3 times as often as the single one (grid_sao_decide as
    often). Prints the halo bytes and both times a picture."""
    cfg = shard_cfg(npz)
    sharded, single, meta = sharded_step(cfg, params)
    R, G, ex = meta["R"], meta["G"], meta["exchange"]
    reader = Reader(W, H, N_SHARD + 1)
    idr, _ = encode_sequence(segments.ListReader(reader.frames[:1]),
                             ldp_cfg(npz, frames=1), device=dev)
    ry, ru, rv = (torch.as_tensor(np.asarray(p, np.int32), device=dev)
                  for p in idr.dpb_recon)
    carry = meta["step"].carry0(ry[None].repeat(R, 1, 1).contiguous(),
                                torch.cat([ru, rv], 1)[None]
                                .repeat(R, 1, 1).contiguous())
    parts = meta["split"](carry)
    fu8s = [torch.as_tensor(np.concatenate([p.ravel() for p in f]),
                            device=dev) for f in reader.frames[1:]]
    launches = {"single": dict.fromkeys(KERNELS, 0),
                "sharded": dict.fromkeys(KERNELS, 0)}
    ms = {"single": [], "sharded": []}
    halo, fields = [], []
    for k, fu8 in enumerate(fu8s):
        gpos, navail = k % G, max(1, min(k + 1, R))
        for kind in ("single", "sharded"):
            before = dict(LAUNCHES)
            x0 = (ex.halo_bytes, ex.field_bytes)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            if kind == "single":
                carry, row1 = single(carry, fu8, navail, gpos)
            else:
                parts, row3 = sharded(parts, fu8, navail, gpos)
            b.record()
            b.synchronize()
            ms[kind].append(a.elapsed_time(b))
            for n in KERNELS:
                launches[kind][n] += LAUNCHES[n] - before[n]
        halo.append(ex.halo_bytes - x0[0])
        fields.append(ex.field_bytes - x0[1])
        check(torch.equal(row1, row3), f"sharded step picture {k + 1}: the "
              "packed row differs from the single step's")
        check(all(torch.equal(x, y) for x, y in zip(meta["join"](parts),
                                                     carry)),
              f"sharded step picture {k + 1}: the carry differs")
    grid = [n for n in KERNELS if launches["single"][n]]
    missing = [n for n in G_KERNELS + ("grid_sao_decide", "nnfme_mlp")
               if n not in grid]
    check(not missing, f"sharded chain: the single step launched no "
          f"{missing}")
    for n in grid:
        want = launches["single"][n] * (1 if n == "grid_sao_decide"
                                         else N_STRIPES)
        check(launches["sharded"][n] == want,
              f"sharded chain: {n} launched {launches['sharded'][n]} times "
              f"in stripes, {launches['single'][n]} whole")
    check(not any(launches["sharded"][n] for n in KERNELS if n not in grid),
          "sharded chain: a kernel the single step does not launch")
    per = {n: launches["sharded"][n] / N_SHARD for n in grid}
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"main path sharded grid step ({N_STRIPES} stripes "
          f"{[(r.y0, r.y1) for r in meta['rows']]} of n x {dev}): the "
          f"anchor cfg uncut at {W}x{H}, {N_SHARD} P pictures chained from "
          f"the IDR, every packed row and carry == the single step's | "
          f"halo {statistics.median(halo):.0f} bytes a picture (median; "
          f"{sum(halo)} in all), fields {statistics.median(fields):.0f} | "
          f"event ms a picture: sharded median {med['sharded']:.3f} (all "
          f"{[round(x, 3) for x in ms['sharded']]}), single median "
          f"{med['single']:.3f} (all {[round(x, 3) for x in ms['single']]})"
          f" | bound a picture: sharded {bounds['sharded']['bound']:.6f} ms, "
          f"single {bounds['single']['bound']:.6f} ms | sharded launches a "
          f"picture {per} "
          f"(single x {N_STRIPES}; grid_sao_decide x 1) | {gpu}",
          flush=True)
    return dict(ms=med, halo=statistics.median(halo), per=per)


def intra8_cfg(w, h, frames):
    """cfg/encoder_intra_main.cfg at w x h with fixed 8x8 intra (intra_qt
    off; sign hiding off, as the cfg ships)."""
    cfg = intra_cfg(w, h, frames)
    cfg.intra_qt = False
    return cfg


def graft_planes(dev):
    """The inputs of the graft entry's flagship step (copied from
    `__graft_entry__.entry()`, not imported): 192x128 planes from
    np.random.default_rng(0), as (1, H, W) / (1, H/2, W/2) int32."""
    rng = np.random.default_rng(0)
    oy = rng.integers(0, 256, (128, 192))
    ou = rng.integers(0, 256, (64, 96))
    ov = rng.integers(0, 256, (64, 96))
    return [torch.as_tensor(p, dtype=torch.int32, device=dev)[None]
            .contiguous() for p in (oy, ou, ov)]


def check_intra_wave(dev):
    """Kernel vs plain on the card for intra_wave, all seven outputs exact:
    (a) 3 frames of the 416x240 clip at QP 32 in one launch (the main
    path's batches), (b) the graft entry's step, 192x128 at QP 32 with
    max_tu_depth_intra 0, both with the recon on chip, (c) 1 frame of an
    832x480 clip (its 8-bit planes, 599,040 bytes, do not fit on chip:
    the recon in device memory; compared, not timed against plain).
    Returns {name: row}; ms/plain_ms per launch of (a); `steps` its
    dependency depth."""
    smem_c = kbuild.function("intra_wave", "tpuhevc_intra_wave_smem",
                             [kbuild.I] * 5)
    for w, h in ((104, 72), (192, 128), (416, 240), (832, 480),
                 (1920, 1088)):
        bmax = wave_tables(w, h, 6, "cpu").slots.shape[1]
        for on_chip in (True, False):
            for bd in (8, 10):
                check(smem_c(w, h, bmax, int(on_chip), bd)
                      == wave_smem(w, h, bmax, on_chip, bd),
                      f"intra_wave smem at {w}x{h}, bit depth {bd}: C and "
                      "Python differ")
    clip = Reader(W, H, 3).frames
    big = Reader(832, 480, 1).frames
    graft = EncoderConfig(sps=SeqParams(width=192, height=128,
                                        max_tu_depth_intra=0), qp=32,
                          intra_period=1, intra_qt=False)

    def stack(frames):
        return [torch.as_tensor(np.stack([f[i] for f in frames]).astype(
            np.int32), device=dev) for i in range(3)]

    cases = [("416x240 x 3", intra8_cfg(W, H, 3), stack(clip), True),
             ("192x128 graft", graft, graft_planes(dev), True),
             ("832x480 x 1", intra8_cfg(832, 480, 1), stack(big), False)]
    row = None
    for tag, cfg, planes, timed in cases:
        sps = cfg.sps
        geo = wave_tables(sps.coded_width, sps.coded_height, sps.log2_ctu,
                          dev)
        on_chip, cluster, smem = wave_variant(
            sps.coded_width, sps.coded_height, *geo.slots.shape, 8)
        args = (*planes, geo, cfg.qp, _sqlam_fp(cfg),
                sps.strong_intra_smoothing)
        a, b = intra_wave(*args, bit_depth=8), intra_wave_plain(*args)
        torch.cuda.synchronize()
        err = 0.0
        for x, y in zip(a, b):
            check(x.dtype == y.dtype == torch.int32 and x.shape == y.shape,
                  f"intra_wave {tag}: {x.dtype}{tuple(x.shape)} vs "
                  f"{y.dtype}{tuple(y.shape)}")
            err = max(err, float((x.double() - y.double()).abs().max()))
        check(err == 0, f"intra_wave {tag}: outputs differ by {err}")
        ms = median_ms(lambda: intra_wave(*args, bit_depth=8), reps=10)
        plain_ms = (median_ms(lambda: intra_wave_plain(*args), reps=1)
                    if timed else float("nan"))
        work = Work()
        work.add("intra_wave", args, a)
        bound_ms, bound_by = bound_of(dict(work=work))
        nf, steps = planes[0].shape[0], geo.slots.shape[0]
        print(f"kernel intra_wave   {tag}: recon "
              f"{'on chip' if on_chip else 'in device memory'} ({smem} "
              f"bytes of shared memory, {cluster} blocks a frame) "
              f"max_abs_err {err:.3g} kernel_ms "
              f"{ms:.4f} ({ms / nf:.4f} a picture) plain_ms {plain_ms:.4f} "
              f"bound {bound_ms:.6f} ms ({bound_by}; {work.bytes} bytes, "
              f"{work.ops} operations) dependency depth {steps} waves of "
              f"up to {geo.slots.shape[1]} cells ({ms / steps * 1e3:.2f} us "
              f"a wave)", flush=True)
        if row is None:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, work=work,
                       steps=steps)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return {"intra_wave": row}


PLAIN_DECIDE = [0]  # calls of the plain SAO decision since the last reset


def count_plain_decide():
    """Wrap ops.grid_sao.sao_decide (the plain SAO decision) with a
    counter, for the paths' check that the card decides SAO itself."""
    real = grid_sao_mod.sao_decide

    def counted(*a, **kw):
        PLAIN_DECIDE[0] += 1
        return real(*a, **kw)

    grid_sao_mod.sao_decide = counted


def run_path(dev, cfg, nframes, fade=False, reader=None, device_batch=0):
    """One main path through encode_sequence with the launch counters (and
    the plain SAO decision's count) set to 0 just before and read just
    after; returns (enc, recons, seconds, launches)."""
    reader = reader or Reader(W, H, nframes, fade)
    torch.cuda.synchronize()
    reset_launches()
    PLAIN_DECIDE[0] = 0
    t0 = time.time()
    enc, recons = encode_sequence(reader, cfg, max_frames=nframes,
                                  device=dev, device_batch=device_batch)
    torch.cuda.synchronize()
    secs = time.time() - t0
    return enc, recons, secs, dict(LAUNCHES, plain_sao_decide=PLAIN_DECIDE[0])


def check_sao_on_card(launches, n_p, what):
    """SAO decided on the card: the plain decision never called, grid_sao
    launched twice (stats, apply) and grid_sao_decide once a P picture."""
    check(launches["plain_sao_decide"] == 0,
          f"{what}: the plain sao_decide ran {launches['plain_sao_decide']} "
          "times on the card")
    check(launches["grid_sao"] == 2 * n_p
          and launches["grid_sao_decide"] == n_p,
          f"{what}: grid_sao {launches['grid_sao']}, grid_sao_decide "
          f"{launches['grid_sao_decide']} for {n_p} P pictures")


def check_deblock_once(launches, n_p, what):
    """grid_deblock launched once a P picture (both edge directions in one
    launch)."""
    check(launches["grid_deblock"] == n_p,
          f"{what}: grid_deblock {launches['grid_deblock']} launches for "
          f"{n_p} P pictures")


def check_p_tail(calls, launches):
    """Random access x 18: its one P picture (the POC 17 tail) launches K1,
    K3 and K4 once each, every class in the launch (K2 once for its
    classes and once a B picture), and the three equal their plain
    versions at every call, replayed from their recorded arguments."""
    want = {"sad_search": 1, "txq": 1, "mc_blk": 1, "nnfme_mlp": N_RA - 1}
    got = {k: launches[k] for k in want}
    check(got == want, f"random access: launches {got}, want {want}")
    plain = {"sad_search": sad_search_classes_plain,
             "mc_blk": mc_blk_planes_plain, "txq": txq_planes_plain}
    kern = {"sad_search": sad_search_classes, "mc_blk": mc_blk_planes,
            "txq": txq_planes}
    for name in P_ONCE:
        check(len(calls[name]) == 1, f"random access: {name} called "
              f"{len(calls[name])} times")
        for args, kw in calls[name]:
            a, b = kern[name](*args, **kw), plain[name](*args, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(
                tensors(a), tensors(b), strict=True)),
                f"random access: {name} differs from plain at its P "
                "picture's call")
    print(f"random access P picture: K1, K3 and K4 one launch each, equal "
          f"to plain at their calls; launches {got}", flush=True)


def check_stream(enc, recons, n, launches, need, what, w=W, h=H):
    """Every needed kernel launched; n pictures of w x h decode hash-OK in
    the port's decoder with the encoder's recon, in decoding order
    (all-intra pictures are IDRs, each with POC 0; random access codes out
    of display order)."""
    check(len(enc.results) == n, f"{what}: encoded {len(enc.results)}")
    missing = [k for k in need if launches[k] <= 0]
    check(not missing, f"{what}: kernels not launched: {missing}")
    frames = decode_stream(enc.bitstream())
    check(len(frames) == n, f"{what}: decoded {len(frames)} pictures")
    check(all(f.md5_ok for f in frames), [f.md5_ok for f in frames])
    for i, (f, (ry, ru, rv)) in enumerate(zip(frames, recons)):
        check(np.array_equal(f.y, ry[:h, :w])
              and np.array_equal(f.u, ru[: h // 2, : w // 2])
              and np.array_equal(f.v, rv[: h // 2, : w // 2]),
              f"{what}: decoded picture {i} (POC {f.poc}) differs from the "
              f"encoder's recon")
    return frames


def cross_check_cpu(npz):
    """CUDA vs CPU path of the port: at 112x72 (all four CU classes; the
    non-grid LD-P scan, which runs the anchor with its four tools cut)
    LD-P five pictures and all-intra two, LD-P through
    the grid step at 128x64 x 9 (every CU class 8-64, four references)
    with the anchor's four tools on and cut, with DCT-IF FME and weighted
    prediction (the fade clip) and in bench.py's no-fetch configuration,
    and random access at 64x48 x 6 (four B pictures and the P tail);
    returns the seven stream sizes. The 112x72 LD-P encode must launch
    K1-K4, K3 once a frame step of the scan for the four classes' twelve
    planes (held against plain at each of its calls), the 128x64 ones
    every grid kernel they run."""
    out = []
    for make, n, w, h, need, fade in (
            (lambda: ldp_cfg(npz, 112, 72, 5, cut=True), 5, 112, 72,
             ("sad_search", "mc_blk", "txq"), False),
            (lambda: intra_cfg(112, 72, 2), 2, 112, 72, (), False),
            (lambda: ldp_cfg(npz, 128, 64, 9), 9, 128, 64, G_KERNELS, False),
            (lambda: ldp_cfg(npz, 128, 64, 9, cut=True), 9, 128, 64,
             G_KERNELS[:7], False),
            (lambda: ldp_cfg(npz, 128, 64, 9, extra=FME_WP), 9, 128, 64,
             G_KERNELS + F_KERNELS[:2], True),
            (lambda: ldp_cfg(None, 128, 64, 9, extra=NO_FETCH), 9, 128, 64,
             G_KERNELS + F_KERNELS[2:], False),
            (lambda: ra_cfg(npz, 64, 48, 6), 6, 64, 48, (), False)):
        r = Reader(w, h, n, fade)
        reset_launches()
        k3 = {"mc_blk": []}
        saved = recording(inter_batch, ("mc_blk",), k3)
        try:
            a, _ = encode_sequence(r, make(), device="cuda")
        finally:
            restore(inter_batch, saved)
        missing = [k for k in need if LAUNCHES[k] <= 0]
        check(not missing, f"{w}x{h}: kernels not launched: {missing}")
        if "mc_blk" in need:  # the LD-P scan: a launch a frame step (its
            # chunks of 8 pictures, the last padded) for its classes
            check(LAUNCHES["mc_blk"] == len(k3["mc_blk"]) >= n - 1,
                  f"{w}x{h} LD-P scan: mc_blk launched {LAUNCHES['mc_blk']}"
                  f" times in {len(k3['mc_blk'])} calls for {n - 1} P "
                  "pictures")
            for (jobs, bd), _ in k3["mc_blk"]:
                check(bd == 8, f"{w}x{h}: K3 at bit depth {bd}")
                check(len(jobs) == 12, f"{w}x{h}: K3 of {len(jobs)} jobs")
                check_k3(jobs, f"LD-P scan {w}x{h} frame step")
        b, _ = encode_sequence(r, make(), device="cpu")
        check(a.bitstream() == b.bitstream(),
              f"{w}x{h}: CUDA and CPU streams differ")
        out.append(len(a.bitstream()))
    return out


def cross_check_intra8(npz):
    """CUDA vs CPU of fixed-8x8 intra: all-intra at 104x72 x 3 (partial
    CTUs on both axes) with device_batch=2, two launches; the IDR of LD-P
    at 112x72 x 3 (the anchor with its four tools cut: the non-grid scan,
    SBH off), one launch. The streams byte-identical; returns their
    sizes."""
    out = []
    for make, w, h, db, want in (
            (lambda: intra8_cfg(104, 72, 3), 104, 72, 2, 2),
            (lambda: dataclasses.replace(ldp_cfg(npz, 112, 72, 3, cut=True),
                                         intra_qt=False), 112, 72, 0, 1)):
        r = Reader(w, h, 3)
        reset_launches()
        a, _ = encode_sequence(r, make(), device="cuda", device_batch=db)
        check(LAUNCHES["intra_wave"] == want,
              f"{w}x{h} fixed 8x8: intra_wave launched "
              f"{LAUNCHES['intra_wave']}, want {want}")
        b, _ = encode_sequence(r, make(), device="cpu", device_batch=db)
        check(a.bitstream() == b.bitstream(),
              f"{w}x{h} fixed 8x8: CUDA and CPU streams differ")
        out.append(len(a.bitstream()))
    return out


def run_intra8(dev, gpu):
    """Main path 6: fixed-8x8 all-intra, 8 pictures of the 416x240 clip
    through encode_sequence(..., device_batch=4), after a warm-up encode of
    one batch; intra_wave launches once a batch, nothing else launches,
    every picture decodes hash-OK with the encoder's recon. Returns its
    launches."""
    run_path(dev, intra8_cfg(W, H, INTRA8_BATCH), INTRA8_BATCH,
             device_batch=INTRA8_BATCH)
    enc, recons, secs, launches = run_path(
        dev, intra8_cfg(W, H, N_INTRA8), N_INTRA8,
        device_batch=INTRA8_BATCH)
    check_stream(enc, recons, N_INTRA8, launches, ("intra_wave",),
                 "fixed-8x8 all-intra")
    want = -(-N_INTRA8 // INTRA8_BATCH)
    others = {k: v for k, v in launches.items() if v and k != "intra_wave"}
    check(launches["intra_wave"] == want and not others,
          f"fixed-8x8 all-intra: launches {launches}, want intra_wave "
          f"{want} and nothing else")
    kbits = sum(r.bits for r in enc.results) / 1000
    psnr = np.mean([r.psnr_y for r in enc.results])
    pic = [round(r.seconds, 3) for r in enc.results]
    print(f"main path fixed-8x8 all-intra: {W}x{H} x {N_INTRA8} pictures, "
          f"device_batch {INTRA8_BATCH}, in {secs:.3f} s = "
          f"{N_INTRA8 / secs:.3f} frames/s (host encode_frame per picture "
          f"{pic} s) | {kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
          f"{launches} | {gpu}", flush=True)
    return launches


def run_fme_wp(dev, npz, gpu):
    """LD-P with DCT-IF FME and weighted prediction (the anchor cfg with
    FmeMode dctif and WeightedPredP 1) on 17 frames of the fade clip: a
    warm-up encode, then the counted one, which must decode hash-OK with
    the encoder's recon, launch the grid kernels with grid_subpel and
    grid_wp_me, and hold fractional MVs and non-identity weights. Returns
    its launches."""
    run_path(dev, ldp_cfg(npz, frames=3, extra=FME_WP), 3, fade=True)
    seen = dict(frac=0, weighted=0)
    real_asm, real_wp = (inter_grid.assemble_grid_frame,
                         encoder_mod.analyse_slice_wp)

    def assembled(*a, **kw):
        out = real_asm(*a, **kw)
        seen["frac"] += int((out[0].mv & 3).any(-1).sum())
        return out

    def analysed(*a, **kw):
        wp = real_wp(*a, **kw)
        seen["weighted"] += weighted(wp)
        return wp

    inter_grid.assemble_grid_frame = assembled
    encoder_mod.analyse_slice_wp = analysed
    try:
        enc, recons, secs, launches = run_path(
            dev, ldp_cfg(npz, extra=FME_WP), NFRAMES, fade=True)
    finally:
        inter_grid.assemble_grid_frame = real_asm
        encoder_mod.analyse_slice_wp = real_wp
    check_stream(enc, recons, NFRAMES, launches, FWP_NEED, "LD-P dctif + WP")
    check_sao_on_card(launches, NFRAMES - 1, "LD-P dctif + WP")
    check_deblock_once(launches, NFRAMES - 1, "LD-P dctif + WP")
    check(seen["frac"] > 0, "LD-P dctif + WP: no fractional MV")
    check(seen["weighted"] > 0, "LD-P dctif + WP: identity weights only")
    kbits = sum(r.bits for r in enc.results) / 1000
    psnr = np.mean([r.psnr_y for r in enc.results])
    print(f"main path LD-P dctif + WP: {W}x{H} x {NFRAMES} frames of the "
          f"fade clip in {secs:.3f} s = {NFRAMES / secs:.3f} fps | "
          f"{kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | {seen['frac']} "
          f"fractional-MV cells, {seen['weighted']} weighted pictures | "
          f"launches {launches} | {gpu}", flush=True)
    return launches


def run_bench(dev, gpu):
    """bench.py's configuration, clip and procedure through the port (as
    `profile_path --path bench`): a 6-frame warm-up encode, whose packed
    rows must carry no recon, then the best of 4 timed encodes of 32
    frames, the launch counters reset before each; the last stream must
    decode with every checksum OK. Returns the last encode's launches."""
    reader = Reader(W, H, BENCH_FRAMES)
    sizes = []
    real_asm = inter_grid.assemble_grid_frame

    def assembled(cfg, buf, *a, **kw):
        sizes.append((buf.size, "rec_y" in inter_grid._parse_frame_buf(cfg,
                                                                        buf)))
        return real_asm(cfg, buf, *a, **kw)

    inter_grid.assemble_grid_frame = assembled
    try:
        run_path(dev, ldp_cfg(None, frames=BENCH_WARMUP, extra=NO_FETCH),
                 BENCH_WARMUP, reader=reader)
    finally:
        inter_grid.assemble_grid_frame = real_asm
    cfg = ldp_cfg(None, frames=BENCH_FRAMES, extra=NO_FETCH)
    nbytes = inter_grid.frame_bytes(cfg)
    check(nbytes == inter_grid.frame_bytes(
        ldp_cfg(None, frames=BENCH_FRAMES)) - W * H * 3 // 2 + 24,
        f"bench: row of {nbytes} bytes")
    check(len(sizes) == BENCH_WARMUP - 1
          and all(n == nbytes and not rec for n, rec in sizes),
          f"bench: packed rows {sizes}, expected {nbytes} bytes, no recon")
    secs = []
    for _ in range(BENCH_REPS):
        enc, recons, s, bl = run_path(
            dev, ldp_cfg(None, frames=BENCH_FRAMES, extra=NO_FETCH),
            BENCH_FRAMES, reader=reader)
        secs.append(s)
    missing = [k for k in BENCH_NEED if bl[k] <= 0]
    check(not missing, f"bench: kernels not launched: {missing}")
    check_sao_on_card(bl, BENCH_FRAMES - 1, "bench")
    check_deblock_once(bl, BENCH_FRAMES - 1, "bench")
    check(len(enc.results) == BENCH_FRAMES and recons[0] is not None
          and all(r is None for r in recons[1:]),
          "bench: the P pictures' recon was fetched")
    frames = decode_stream(enc.bitstream())
    check(len(frames) == BENCH_FRAMES and all(f.md5_ok for f in frames),
          f"bench: checksums {[f.md5_ok for f in frames]}")
    kbits = sum(r.bits for r in enc.results) / 1000
    psnr = np.mean([r.psnr_y for r in enc.results])
    print(f"main path bench.py's cfg: {W}x{H} x {BENCH_FRAMES} frames, warm "
          f"encodes {[round(x, 4) for x in secs]} s, best "
          f"{BENCH_FRAMES / min(secs):.3f} frames/s | {kbits:.1f} kbit, "
          f"Y-PSNR {psnr:.3f} dB (from the device's SSEs) | FmeMode nn ran "
          f"integer-pel for want of NN-FME weights | launches {bl} | {gpu}",
          flush=True)
    return bl


# path 9, the per-picture P path: the anchor cfg at 1920x1080 (class B),
# IntraPeriod 4, random access with the tools and sign hiding, random
# access without a GOP table, rate control at picture and CTU level
W9, H9, N9_1080 = 1920, 1080, 2
N9_IP, N9_RA, N9_GOP4, N9_RC = 9, 10, 9, 5
RA_TOOLS = ["--RDOQ=1", "--SignHideFlag=1", "--LoopFilterDisable=0",
            "--SAO=1"]
RC_BPS = 400000  # the rate-control paths' target at 416x240


def gop4_cfg(npz, w=None, h=None, frames=None):
    """Random access without a GOP table (`_ra_gop4`): the random-access
    cfg with its table dropped, the tools off as shipped."""
    return dataclasses.replace(ra_cfg(npz, w, h, frames), gop_table=())


def rc_cfg(npz, ctu, w=None, h=None, frames=None):
    """Rate control on the anchor LD-P cfg: at picture level with the four
    tools cut (the P pictures through the device stage), at CTU level as
    shipped (a QP map a P picture: the host stage)."""
    extra = ["--RateControl=1", f"--TargetBitrate={RC_BPS}"]
    if ctu:
        extra.append("--LCULevelRateControl=1")
    return ldp_cfg(npz, w, h, frames or N9_RC, cut=not ctu, extra=extra)


class HostStage:
    """Counts and times the host tool stage (`inter_enc._compute_stage_np`)
    while active."""

    def __init__(self):
        self.secs = []
        self.real = inter_enc._compute_stage_np

    def __enter__(self):
        def timed(*a, **kw):
            t0 = time.time()
            out = self.real(*a, **kw)
            self.secs.append(time.time() - t0)
            return out

        inter_enc._compute_stage_np = timed
        return self

    def __exit__(self, *exc):
        inter_enc._compute_stage_np = self.real


def summary9(enc, secs, launches, gpu, what, extra=""):
    kbits = sum(r.bits for r in enc.results) / 1000
    psnr = np.mean([r.psnr_y for r in enc.results])
    used = {k: v for k, v in launches.items() if v}
    print(f"main path 9, {what}: {len(enc.results)} pictures in {secs:.3f} "
          f"s = {len(enc.results) / secs:.3f} fps | {kbits:.1f} kbit, Y-PSNR "
          f"{psnr:.3f} dB{extra} | launches {used} | {gpu}", flush=True)


def run_per_picture(dev, npz, gpu):
    """Main path 9, the per-picture P path with the host tool stage, each
    encode with the counters reset just before and read just after,
    decoded hash-OK with the encoder's recon: the anchor LD-P cfg as
    shipped at 1920x1080 x 2 (the IDR decided on the card; the P picture
    through the host stage, whose seconds are printed); IntraPeriod 4
    with the tools at 416x240 x 9 (three I pictures decided on the card,
    six P pictures through the host stage); the random-access cfg with
    RDOQ, sign hiding, deblocking and SAO at 416x240 x 10 (b_txq once a B
    picture with sign hiding, each launch torch.equal to plain and its
    device time and bound printed; the P tail through the host stage);
    random access without a GOP table at 416x240 x 9 (K1, K3 and K4 once
    a key P picture); rate control at picture level (the P pictures
    through the device stage) and at CTU level (the host stage), the
    target and achieved bits printed. Returns (launches summed over the
    path, the SBH b_txq row)."""
    total = {k: 0 for k in KERNELS}

    def add(launches):
        for k in KERNELS:
            total[k] += launches[k]

    # the anchor at 1920x1080: coded height 1080, not whole 16x16 blocks
    cfg = ldp_cfg(npz, W9, H9, N9_1080)
    check(not inter_grid.supports(cfg), "1920x1080 took the grid")
    reader = Reader(W9, H9, N9_1080)
    with HostStage() as hs:
        enc, recons, secs, la = run_path(dev, cfg, N9_1080, reader=reader)
    check_stream(enc, recons, N9_1080, la, INTRA, "1920x1080 anchor", W9,
                 H9)
    check(len(hs.secs) == N9_1080 - 1, f"1920x1080: host stage ran "
          f"{len(hs.secs)} times")
    check(all(la[k] == 0 for k in G_KERNELS + P_ONCE),
          "1920x1080: a grid kernel or K1, K3, K4 launched")
    add(la)
    summary9(enc, secs, la, gpu, f"the anchor LD-P cfg at {W9}x{H9}",
             f" | IDR {enc.results[0].seconds:.3f} s | host stage "
             f"{[round(x, 3) for x in hs.secs]} s a P picture")

    # IntraPeriod 4 with the tools
    with HostStage() as hs:
        enc, recons, secs, la = run_path(
            dev, ldp_cfg(npz, frames=N9_IP, extra=["--IntraPeriod=4"]),
            N9_IP)
    check_stream(enc, recons, N9_IP, la, INTRA, "IntraPeriod 4")
    n_i = len(range(0, N9_IP, 4))
    check(len(hs.secs) == N9_IP - n_i, f"IntraPeriod 4: host stage ran "
          f"{len(hs.secs)} times")
    add(la)
    summary9(enc, secs, la, gpu, f"IntraPeriod 4 {W}x{H}",
             f" | host stage {np.mean(hs.secs):.3f} s a P picture")

    # random access with RDOQ, SBH, deblocking and SAO
    calls = {"b_txq": []}
    saved = recording(inter_b, ("b_txq",), calls)
    try:
        with HostStage() as hs:
            enc, recons, secs, la = run_path(
                dev, ra_cfg(npz, frames=N9_RA, extra=RA_TOOLS), N9_RA)
    finally:
        restore(inter_b, saved)
    check_stream(enc, recons, N9_RA, la, B_KERNELS + INTRA,
                 "random access with the tools")
    n_b = 4 * ((N9_RA - 1) // 4)  # whole GOPs of 4 B pictures; P tail
    check(la["b_txq"] == n_b == len(calls["b_txq"]),
          f"random access with the tools: b_txq {la['b_txq']} launches, "
          f"{len(calls['b_txq'])} calls for {n_b} B pictures")
    check(len(hs.secs) == N9_RA - 1 - n_b, "random access with the tools: "
          f"host stage ran {len(hs.secs)} times")
    row = dict(max_abs_err=0.0, work=Work(), launches=la["b_txq"])
    for args, kw in calls["b_txq"]:
        check(kw.get("sbh") is True, f"b_txq called with {kw}")
        a, b = b_txq_planes(*args, **kw), b_txq_planes_plain(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(
            tensors(a), tensors(b), strict=True)),
            "b_txq with sign hiding differs from plain")
    args, kw = calls["b_txq"][0]
    row["work"].add("b_txq", args, b_txq_planes(*args, **kw), kw)
    row["ms"] = median_ms(lambda: b_txq_planes(*args, **kw), reps=10)
    row["plain_ms"] = median_ms(lambda: b_txq_planes_plain(*args, **kw),
                                reps=5)
    row["device_ms"] = device_ms(lambda: b_txq_planes(*args, **kw), n=100)
    row["device_ms_off"] = device_ms(
        lambda: b_txq_planes(*args, **dict(kw, sbh=False)), n=100)
    row["bound_ms"], row["bound_by"] = bound_of(row)
    print(f"kernel b_txq with sign hiding (B picture, Y, U and V in one "
          f"launch): equal to plain at all {len(calls['b_txq'])} calls; "
          f"kernel_ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
          f"device_ms {row['device_ms']:.5f} (without SBH on the same "
          f"inputs {row['device_ms_off']:.5f}) bound {row['bound_ms']:.6f} "
          f"ms ({row['bound_by']}) | launches {la['b_txq']} | {gpu}",
          flush=True)
    add(la)
    summary9(enc, secs, la, gpu, f"random access with RDOQ, SBH, "
             f"deblocking and SAO {W}x{H}", f" | decode order "
             f"{[r.poc for r in enc.results]}")

    # random access without a GOP table
    with HostStage() as hs:
        enc, recons, secs, la = run_path(
            dev, gop4_cfg(npz, frames=N9_GOP4), N9_GOP4)
    check_stream(enc, recons, N9_GOP4, la, B_KERNELS + P_ONCE + INTRA,
                 "random access without a GOP table")
    n_key = (N9_GOP4 - 1) // 4
    check(not hs.secs and all(la[k] == n_key for k in P_ONCE)
          and all(la[k] == 3 * n_key for k in B_KERNELS),
          f"random access without a GOP table: launches {la}, host stage "
          f"{len(hs.secs)}")
    add(la)
    summary9(enc, secs, la, gpu, f"random access without a GOP table "
             f"{W}x{H}", f" | decode order {[r.poc for r in enc.results]}")

    # rate control, picture and CTU level
    for ctu in (False, True):
        cfg = rc_cfg(npz, ctu)
        with HostStage() as hs:
            enc, recons, secs, la = run_path(dev, cfg, N9_RC)
        what = f"rate control at {'CTU' if ctu else 'picture'} level"
        check_stream(enc, recons, N9_RC, la,
                     INTRA + (() if ctu else P_ONCE), what)
        check(len(hs.secs) == (N9_RC - 1 if ctu else 0),
              f"{what}: host stage ran {len(hs.secs)} times")
        bits = sum(r.bits for r in enc.results)
        got = bits * cfg.frame_rate / N9_RC
        add(la)
        summary9(enc, secs, la, gpu, f"{what} {W}x{H}",
                 f" | target {cfg.target_bitrate} bit/s, achieved "
                 f"{got:.0f} bit/s ({bits} bits, {cfg.frame_rate} "
                 "pictures/s)")
    return total, row


def cross_check_per_picture(npz):
    """CUDA vs CPU of path 9's routes: the anchor cfg at 112x72 x 4 (off
    the grid: the host stage), and at 64x48 x 6 IntraPeriod 4 with the
    tools, random access with RDOQ, SBH, deblocking and SAO, random access
    without a GOP table, rate control at picture and CTU level; the
    streams byte-identical. Returns their sizes."""
    out = []
    for make, w, h, n in (
            (lambda: ldp_cfg(npz, 112, 72, 4), 112, 72, 4),
            (lambda: ldp_cfg(npz, 64, 48, 6, extra=["--IntraPeriod=4"]),
             64, 48, 6),
            (lambda: ra_cfg(npz, 64, 48, 6, extra=RA_TOOLS), 64, 48, 6),
            (lambda: gop4_cfg(npz, 64, 48, 6), 64, 48, 6),
            (lambda: rc_cfg(npz, False, 64, 48, 6), 64, 48, 6),
            (lambda: rc_cfg(npz, True, 64, 48, 6), 64, 48, 6)):
        r = Reader(w, h, n)
        a, _ = encode_sequence(r, make(), device="cuda")
        b, _ = encode_sequence(r, make(), device="cpu")
        check(a.bitstream() == b.bitstream(),
              f"path 9 route {len(out)} at {w}x{h}: CUDA and CPU streams "
              "differ")
        out.append(len(a.bitstream()))
    return out


# path 10, Main10: the all-intra, LD-P scan, IntraPeriod 4 and anchor
# encodes at 10 bits (416x240, QP 32), pictures each
N10_AI, N10_SCAN, N10_IP, N10_ANCHOR = 2, 9, 5, 3
MAIN10 = ["--InputBitDepth=10", "--InternalBitDepth=10"]
# the 10-bit variants, and the kernels of the Main10 paths that have one
B10_KERNELS = ("b_me10", "b_pred10", "b_txq10")
M10_KERNELS = ("sad_search10", "mc_blk10", "txq10", "intra_txq10",
               *B10_KERNELS, "intra_wave10")
M10_OF = {"sad_search10": "sad_search", "mc_blk10": "mc_blk",
          "txq10": "txq", "intra_txq10": "intra_txq", "b_me10": "b_me",
          "b_pred10": "b_pred", "b_txq10": "b_txq",
          "intra_wave10": "intra_wave"}
M10_FUNCS = {  # base name: (kernel wrapper, plain version)
    "sad_search": (sad_search_classes, sad_search_classes_plain),
    "mc_blk": (mc_blk_planes, mc_blk_planes_plain),
    "txq": (txq_planes, txq_planes_plain),
    "intra_txq": (intra_txq, intra_txq_plain),
    "intra_bank": (intra_bank, predict_all_modes_plain),
    # the B step's entries (b_pred and b_txq: a picture's three planes)
    "b_me": (b_me, b_me_plain),
    "b_pred": (b_pred_yuv, b_pred_yuv_plain),
    "b_txq": (b_txq_planes, b_txq_planes_plain),
    "intra_wave": (intra_wave, intra_wave_plain),
}


class Reader10(Reader):
    """The clip at 10 bits as tests/test_main10.py makes it: each 8-bit
    plane x 4, plus 2 (Y), 1 (U), 3 (V)."""

    def __init__(self, w, h, n):
        super().__init__(w, h, n)
        self.frames = [tuple(p.astype(np.uint16) * 4 + o
                             for p, o in zip(fr, (2, 1, 3)))
                       for fr in self.frames]


def main10_cfgs(npz, w=None, h=None):
    """Path 10's routes: (what, cfg, pictures, the kernels it must launch,
    the kernels that must stay idle)."""
    ai, _ = build_config(parse_args([
        "-c", INTRA_CFG, "-wdt", str(w or W), "-hgt", str(h or H),
        "-f", str(N10_AI), "-q", str(QP)] + MAIN10))
    p10 = ("sad_search10", "mc_blk10", "txq10")
    p8 = ("sad_search", "mc_blk", "txq", "intra_txq")
    idr = ("intra_bank", "intra_txq10")
    return [
        ("all-intra", ai, N10_AI, idr, p8 + p10),
        ("LD-P scan, tools cut", ldp_cfg(npz, w, h, N10_SCAN, cut=True,
                                         extra=MAIN10),
         N10_SCAN, idr + p10 + ("nnfme_mlp",), p8),
        ("IntraPeriod 4, tools cut", ldp_cfg(
            npz, w, h, N10_IP, cut=True, extra=MAIN10 + ["--IntraPeriod=4"]),
         N10_IP, idr + p10 + ("nnfme_mlp",), p8),
        ("the anchor cfg (host stage)", ldp_cfg(npz, w, h, N10_ANCHOR,
                                                extra=MAIN10),
         N10_ANCHOR, idr, p8 + p10)]


def main10_row(name, calls, sample_bytes=None):
    """A 10-bit variant's row (or intra_bank's at 10 bits) from `calls`
    (one picture's): its event ms and the plain version's over the calls,
    its device time, its work."""
    base = M10_OF.get(name, name)
    kern, plain = M10_FUNCS[base]
    work = Work(sample_bytes)
    for args, kw in calls:
        work.add(base, args, kern(*args, **kw), kw)
    row = dict(max_abs_err=0.0, work=work)
    row["ms"] = median_ms(lambda: [kern(*a, **k) for a, k in calls],
                          reps=10)
    row["plain_ms"] = median_ms(lambda: [plain(*a, **k) for a, k in calls],
                                reps=3)
    row["device_ms"] = device_ms(lambda: [kern(*a, **k) for a, k in calls],
                                 n=20)
    row["bound_ms"], row["bound_by"] = bound_of(row)
    return row


def run_main10(dev, npz, gpu):
    """Main path 10, Main10 at 416x240 on the 10-bit clip (Reader10): the
    all-intra cfg x 2, the LD-P scan with the tools cut x 9 (seeded
    NN-FME weights), IntraPeriod 4 with the tools cut x 5 (the per-picture
    device stage), the anchor cfg as shipped x 3 (the host tool stage),
    each with the counters reset just before and read just after, every
    hash OK in the port's decoder with the encoder's recon and samples
    above 255; the 10-bit variants of K1, K3, K4 and intra_txq (and
    intra_bank, one kernel at any depth) launched, the 8-bit ones idle;
    every call of those kernels held against its plain version with
    torch.equal. Returns (launches summed over the path, the 10-bit
    variants' rows: K1, K3 and K4 at the device stage's first P picture
    (every row searched), intra_txq over one all-intra picture's
    decision, both passes; K1's bytes at 2 a sample)."""
    total = {k: 0 for k in KERNELS}
    names = ("sad_search", "mc_blk", "txq")
    calls = {}
    for what, cfg, n, need, idle in main10_cfgs(npz):
        rec = {k: [] for k in names}
        irec = {k: [] for k in ("intra_txq", "intra_bank")}
        saved = recording(inter_batch, names, rec)
        isaved = recording(intra_decide, tuple(irec), irec)
        try:
            enc, recons, secs, la = run_path(dev, cfg, n,
                                             reader=Reader10(W, H, n))
        finally:
            restore(inter_batch, saved)
            restore(intra_decide, isaved)
        frames = check_stream(enc, recons, n, la, need, f"Main10 {what}")
        peak = max(int(f.y.max()) for f in frames)
        check(peak > 255, f"Main10 {what}: luma peaks at {peak}")
        check(all(la[k] == 0 for k in idle),
              f"Main10 {what}: an 8-bit kernel or idle variant launched: "
              f"{ {k: la[k] for k in idle if la[k]} }")
        for k, v in list(rec.items()) + list(irec.items()):
            # K1, K3 and K4 launch at every call; the intra kernels skip
            # a call with nothing to do
            want = la[k if k == "intra_bank" else k + "10"]
            check(len(v) == want if k in names else len(v) >= want,
                  f"Main10 {what}: {k} called {len(v)} times, {want} "
                  "launches")
            kern, plain = M10_FUNCS[k]
            for args, kw in v:
                a, b = kern(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(
                    tensors(a), tensors(b), strict=True)),
                    f"Main10 {what}: {k} differs from plain at a call")
        calls[what] = dict(rec, **irec)
        for k in KERNELS:
            total[k] += la[k]
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        used = {k: v for k, v in la.items() if v}
        print(f"main path 10, Main10 {what}: {W}x{H} x {n} pictures in "
              f"{secs:.3f} s = {n / secs:.3f} fps | {kbits:.1f} kbit, Y-PSNR "
              f"{psnr:.3f} dB, luma peak {peak} | every 10-bit call equal "
              f"to plain: { {k: len(v) for k, v in calls[what].items()} } | "
              f"launches {used} | {gpu}", flush=True)
    stage = calls["IntraPeriod 4, tools cut"]
    rows = {name: main10_row(name, stage[M10_OF[name]][:1],
                             2 if name == "sad_search10" else None)
            for name in ("sad_search10", "mc_blk10", "txq10")}
    # beside K1: torch.cdist (p=1) of the PUs against their windows
    args, kw = stage["sad_search"][0]
    rows["sad_search10"]["library_ms"] = k1_library_ms(
        args[0], args[1], sad_search_classes(*args, **kw))
    ai_cfg = main10_cfgs(npz)[0][1]
    frame = Reader10(W, H, 1).frames[0]
    ic = capture_intra_calls(dev, ai_cfg, frame)
    rows["intra_txq10"] = main10_row("intra_txq10",
                                     [(a, {}) for a in ic["intra_txq"]])
    # intra_bank: one kernel at any depth (its row is path 1-9's); here
    # its time at 10 bits
    bank = main10_row("intra_bank", [(a, {}) for a in ic["intra_bank"]])
    for name, r in list(rows.items()) + [("intra_bank at 10 bits", bank)]:
        where = ("one all-intra picture, both passes"
                 if name.startswith("intra") else
                 "the device stage's P picture")
        print(f"kernel {name} (Main10, {where}): kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} device_ms {r['device_ms']:.5f} "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
              f"{r['work'].bytes} bytes, {r['work'].ops} operations) | "
              f"{gpu}", flush=True)
    return total, rows


def cross_check_main10(npz):
    """CUDA vs CPU of path 10's routes at 112x72 (every CU class): the
    streams byte-identical. Returns their sizes."""
    out = []
    for (what, cfg, n, _, _), (_, cpu_cfg, _, _, _) in zip(
            main10_cfgs(npz, 112, 72), main10_cfgs(npz, 112, 72)):
        r = Reader10(112, 72, n)
        a, _ = encode_sequence(r, cfg, device="cuda")
        b, _ = encode_sequence(r, cpu_cfg, device="cpu")
        check(a.bitstream() == b.bitstream(),
              f"Main10 {what} at 112x72: CUDA and CPU streams differ")
        out.append(len(a.bitstream()))
    return out


# path 10's random-access routes at 10 bits: (what, options, the GOP
# table kept, pictures, B pictures, the P pictures' device-stage kernels)
RA10_ROUTES = (
    ("random access, GOP table", [], True, 9, 8, ()),
    ("random access without a table", [], False, 9, 6, P_ONCE),
    ("random access with RDOQ, SBH, deblocking and SAO", RA_TOOLS, True, 10,
     8, ()))


def ra10_cfg(npz, extra, table, w=None, h=None, frames=None):
    cfg = ra_cfg(npz, w, h, frames, extra=MAIN10 + list(extra))
    return cfg if table else dataclasses.replace(cfg, gop_table=())


def run_ra10(dev, npz, gpu):
    """Main path 10's random-access routes, Main10 at 416x240 on the 10-bit
    clip (Reader10): the random-access cfg with its GOP table x 9 (eight B
    pictures), without it x 9 (`_ra_gop4`: two key P pictures through the
    10-bit device stage, six B pictures) and with RDOQ, SBH, deblocking
    and SAO x 10 (eight B pictures, the P tail through the host stage),
    each with the counters reset just before and read just after; every
    hash OK in the port's decoder with the encoder's recon and luma above
    255; b_me10, b_pred10 and b_txq10 launched once a B picture, the 8-bit
    B kernels (and K1, K3, K4 where no P picture takes the device stage)
    idle; every call of the B step's kernels (and the key P pictures' K1,
    K3, K4) held against its plain version with torch.equal. Returns
    (launches summed over the routes, the rows of b_me10, b_pred10 and
    b_txq10 at the table route's first B picture, b_txq10's with its SBH
    variant from the tools route's, samples counted at 2 bytes; b_me10
    beside torch.cdist)."""
    total = {k: 0 for k in KERNELS}
    calls, route_la = {}, {}
    for what, extra, table, n, n_b, p_kernels in RA10_ROUTES:
        rec = {k: [] for k in B_KERNELS}
        prec = {k: [] for k in P_ONCE}
        saved = recording(inter_b, B_KERNELS, rec)
        psaved = recording(inter_batch, P_ONCE, prec)
        try:
            enc, recons, secs, la = run_path(
                dev, ra10_cfg(npz, extra, table, frames=n), n,
                reader=Reader10(W, H, n))
        finally:
            restore(inter_b, saved)
            restore(inter_batch, psaved)
        need = ("intra_bank", "intra_txq10", "nnfme_mlp") + B10_KERNELS + \
            tuple(k + "10" for k in p_kernels)
        frames = check_stream(enc, recons, n, la, need, f"Main10 {what}")
        peak = max(int(f.y.max()) for f in frames)
        check(peak > 255, f"Main10 {what}: luma peaks at {peak}")
        check(all(la[k] == n_b for k in B10_KERNELS),
              f"Main10 {what}: { {k: la[k] for k in B10_KERNELS} } for "
              f"{n_b} B pictures")
        idle = B_KERNELS + P_ONCE + ("intra_txq",) + tuple(
            k + "10" for k in P_ONCE if k not in p_kernels)
        check(all(la[k] == 0 for k in idle),
              f"Main10 {what}: an 8-bit kernel or idle variant launched: "
              f"{ {k: la[k] for k in idle if la[k]} }")
        for k, v in list(rec.items()) + list(prec.items()):
            want = la[k + "10"]
            check(len(v) == want, f"Main10 {what}: {k} called {len(v)} "
                  f"times, {want} launches")
            kern, plain = M10_FUNCS[k]
            for args, kw in v:
                a, b = kern(*args, **kw), plain(*args, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(
                    tensors(a), tensors(b), strict=True)),
                    f"Main10 {what}: {k} differs from plain at a call")
        calls[what], route_la[what] = rec, la
        for k in KERNELS:
            total[k] += la[k]
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        used = {k: v for k, v in la.items() if v}
        print(f"main path 10, Main10 {what}: {W}x{H} x {n} pictures "
              f"(decode order {[r.poc for r in enc.results]}) in {secs:.3f} "
              f"s = {n / secs:.3f} fps | {kbits:.1f} kbit, Y-PSNR "
              f"{psnr:.3f} dB, luma peak {peak} | every 10-bit call equal to "
              f"plain: { {k: len(v) for k, v in {**rec, **prec}.items()} } "
              f"| launches {used} | {gpu}", flush=True)
    table_calls = calls[RA10_ROUTES[0][0]]
    rows = {name: main10_row(name, table_calls[M10_OF[name]][:1], 2)
            for name in B10_KERNELS}
    tools = RA10_ROUTES[2][0]
    sbh_calls = calls[tools]["b_txq"][:1]
    check(bool(sbh_calls[0][1].get("sbh")),
          "the tools route's b_txq calls are not its SBH variant")
    rows["b_txq10"]["sbh"] = dict(main10_row("b_txq10", sbh_calls, 2),
                                  launches=route_la[tools]["b_txq10"])
    args, kw = table_calls["b_me"][0]
    rows["b_me10"]["library_ms"] = b_me_cdist_ms(*args, bit_depth=10)
    for name, r in list(rows.items()) + [("b_txq10 (SBH)",
                                          rows["b_txq10"]["sbh"])]:
        print(f"kernel {name} (Main10, a B picture of random access): "
              f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"device_ms {r['device_ms']:.5f} bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}; {r['work'].bytes} bytes at 2 a sample, "
              f"{r['work'].ops} operations)"
              + (f" | torch.cdist {r['library_ms']:.4f} ms"
                 if "library_ms" in r else "") + f" | {gpu}", flush=True)
    return total, rows


def cross_check_ra10(npz):
    """CUDA vs CPU of path 10's random-access routes at 64x48 x 6: the
    streams byte-identical. Returns their sizes."""
    out = []
    for what, extra, table, _, _, _ in RA10_ROUTES:
        r = Reader10(64, 48, 6)
        a, _ = encode_sequence(r, ra10_cfg(npz, extra, table, 64, 48, 6),
                               device="cuda")
        b, _ = encode_sequence(r, ra10_cfg(npz, extra, table, 64, 48, 6),
                               device="cpu")
        check(a.bitstream() == b.bitstream(),
              f"Main10 {what} at 64x48: CUDA and CPU streams differ")
        out.append(len(a.bitstream()))
    return out


N_SEG_FRAMES, N_SEGS = 16, 2  # path 7's segment encode
MULTI_NEED = ("stripe_prescreen", "grid_refine") + LDP_NEED


# path 10's fixed-8x8 routes at 10 bits: pictures each
N10_I8, N10_I8_SCAN = 4, 3


def intra8_cfg10(w, h, frames):
    """cfg/encoder_intra_main.cfg at 10 bits with fixed 8x8 intra."""
    cfg, _ = build_config(parse_args([
        "-c", INTRA_CFG, "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
        "-q", str(QP)] + MAIN10))
    cfg.intra_qt = False
    return cfg


def intra8_10_routes(npz):
    """Path 10's fixed-8x8 routes: (what, cfg, w, h, pictures,
    device_batch, intra_wave10's launches, the other kernels that must
    launch, whether the recon stays on chip)."""
    scan = dataclasses.replace(ldp_cfg(npz, W, H, N10_I8_SCAN, cut=True,
                                       extra=MAIN10), intra_qt=False)
    return [
        (f"fixed-8x8 all-intra, device_batch {N10_I8}",
         intra8_cfg10(W, H, N10_I8), W, H, N10_I8, N10_I8, 1, (), False),
        ("fixed-8x8 all-intra, a picture a launch",
         intra8_cfg10(192, 128, N10_I8), 192, 128, N10_I8, 0, N10_I8, (),
         True),
        ("LD-P scan, tools cut, fixed-8x8 IDR", scan, W, H, N10_I8_SCAN, 0,
         1, ("sad_search10", "mc_blk10", "txq10", "nnfme_mlp"), False)]


def wave_planes(dev, w, h, n, bd):
    """n pictures of the w x h clip (Reader10's at 10 bits) as (n, h, w),
    (n, h/2, w/2) x 2 int32 on dev."""
    frames = (Reader10 if bd == 10 else Reader)(w, h, n).frames
    return [torch.as_tensor(np.stack([f[i] for f in frames]).astype(
        np.int32), device=dev) for i in range(3)]


def wave_times(dev, gpu):
    """intra_wave10's device time a launch and a wave at 416x240 x 4 (the
    recon in device memory), 192x128 x 4 (on chip) and 256x240 x 4 (on
    chip, a cluster of 4 blocks a frame) beside the 8-bit kernel's on the
    8-bit clip at the same sizes, each launch first held against plain;
    the bound of each (10-bit samples at 2 bytes)."""
    for w, h in ((W, H), (192, 128), (256, 240)):
        for bd in (8, 10):
            cfg = (intra8_cfg10 if bd == 10 else intra8_cfg)(w, h, N10_I8)
            planes = wave_planes(dev, w, h, N10_I8, bd)
            geo = wave_tables(w, h, cfg.sps.log2_ctu, dev)
            steps, bmax = geo.slots.shape
            on_chip, cluster, smem = wave_variant(w, h, steps, bmax, bd)
            args = (*planes, geo, cfg.qp, _sqlam_fp(cfg), True)
            a = intra_wave(*args, bit_depth=bd)
            b = intra_wave_plain(*args, bit_depth=bd)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
                  f"intra_wave at {w}x{h}, bit depth {bd}: differs from "
                  "plain")
            dms = device_ms(lambda: intra_wave(*args, bit_depth=bd), n=20)
            work = Work(2 if bd == 10 else None)
            work.add("intra_wave", args, a)
            bound_ms, bound_by = bound_of(dict(work=work))
            name = "intra_wave10" if bd == 10 else "intra_wave"
            print(f"kernel {name} {w}x{h} x {N10_I8} (bit depth {bd}, "
                  f"recon {'on chip' if on_chip else 'in device memory'}, "
                  f"{smem} bytes of shared memory, {cluster} blocks a "
                  f"frame): device_ms {dms:.5f} a launch ({dms / N10_I8:.5f} "
                  f"a picture, {dms / steps * 1e3:.3f} us a wave of "
                  f"{steps}) bound {bound_ms:.6f} ms ({bound_by}; "
                  f"{work.bytes} bytes, {work.ops} operations) | {gpu}",
                  flush=True)


def run_main10_intra8(dev, npz, gpu):
    """Main path 10's fixed-8x8 routes, Main10 on the 10-bit clip
    (Reader10), each with the counters reset just before and read just
    after: every hash OK with the encoder's recon and luma above 255,
    intra_wave10 launched as the route runs it (once a batch, once a
    picture, once for the IDR) in the variant expected, intra_wave and the
    quadtree decision's kernels idle, every call torch.equal to plain.
    Returns (launches summed over the routes, {"intra_wave10": row}: the
    device-batch route's call timed, samples at 2 bytes)."""
    total = {k: 0 for k in KERNELS}
    first = None
    idle = ("intra_wave", "intra_txq10", *INTRA, *P_ONCE)
    for (what, cfg, w, h, n, db, want, need,
         on_chip) in intra8_10_routes(npz):
        geo = wave_tables(w, h, cfg.sps.log2_ctu, "cpu")
        check(wave_variant(w, h, *geo.slots.shape, 10)[0] == on_chip,
              f"Main10 {what}: the recon is not "
              f"{'on chip' if on_chip else 'in device memory'}")
        rec = {"intra_wave": []}
        saved = recording(intra_frame, ("intra_wave",), rec)
        try:
            enc, recons, secs, la = run_path(
                dev, cfg, n, reader=Reader10(w, h, n), device_batch=db)
        finally:
            restore(intra_frame, saved)
        frames = check_stream(enc, recons, n, la, ("intra_wave10",) + need,
                              f"Main10 {what}", w, h)
        peak = max(int(f.y.max()) for f in frames)
        check(peak > 255, f"Main10 {what}: luma peaks at {peak}")
        check(la["intra_wave10"] == want == len(rec["intra_wave"])
              and all(la[k] == 0 for k in idle),
              f"Main10 {what}: intra_wave10 launched {la['intra_wave10']} "
              f"times in {len(rec['intra_wave'])} calls, want {want}; idle "
              f"kernels launched { {k: la[k] for k in idle if la[k]} }")
        for args, kw in rec["intra_wave"]:
            a, b = intra_wave(*args, **kw), intra_wave_plain(*args, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
                  f"Main10 {what}: intra_wave10 differs from plain at a "
                  "call")
        first = first or rec["intra_wave"][:1]
        for k in KERNELS:
            total[k] += la[k]
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        used = {k: v for k, v in la.items() if v}
        print(f"main path 10, Main10 {what}: {w}x{h} x {n} pictures in "
              f"{secs:.3f} s = {n / secs:.3f} fps | {kbits:.1f} kbit, Y-PSNR "
              f"{psnr:.3f} dB, luma peak {peak} | every intra_wave10 call "
              f"equal to plain ({len(rec['intra_wave'])}) | launches "
              f"{used} | {gpu}", flush=True)
    row = main10_row("intra_wave10", first, 2)
    row["steps"] = wave_tables(W, H, 6, "cpu").slots.shape[0]
    wave_times(dev, gpu)
    return total, {"intra_wave10": row}


def cross_check_main10_intra8(npz):
    """CUDA vs CPU of path 10's fixed-8x8 routes: all-intra at 112x72 x 3
    with device_batch=2 (two launches), the LD-P scan at 64x48 x 3 (one);
    the streams byte-identical. Returns their sizes."""
    out = []
    for what, w, h, db, want in (("all-intra", 112, 72, 2, 2),
                                 ("LD-P scan", 64, 48, 0, 1)):
        streams = []
        for device in ("cuda", "cpu"):
            cfg = (intra8_cfg10(w, h, 3) if what == "all-intra" else
                   dataclasses.replace(ldp_cfg(npz, w, h, 3, cut=True,
                                               extra=MAIN10),
                                       intra_qt=False))
            reset_launches()
            enc, _ = encode_sequence(Reader10(w, h, 3), cfg, device=device,
                                     device_batch=db)
            if device == "cuda":
                check(LAUNCHES["intra_wave10"] == want
                      and LAUNCHES["intra_wave"] == 0,
                      f"Main10 fixed 8x8 {what} at {w}x{h}: intra_wave10 "
                      f"launched {LAUNCHES['intra_wave10']}, want {want}")
            streams.append(enc.bitstream())
        check(streams[0] == streams[1],
              f"Main10 fixed 8x8 {what} at {w}x{h}: CUDA and CPU streams "
              "differ")
        out.append(len(streams[0]))
    return out


def run_multi(dev, npz, gpu, plane, rargs, refine, params, bounds):
    """Main path 7, multi-device on a mesh of n x cuda:0 (one card runs
    the stripes in turn): the prescreen of `plane` and the stripe refine
    (`refine` on `rargs`, from multi_calls) at 416x240 over 3 stripes
    against 1, the overlapped segment encode of 16 anchor LD-P frames in 2
    segments against the segments' own streams, dryrun_multichip(2,
    "cuda") (steps 2, 2b, 2c, 3), and the grid step on row stripes
    (run_sharded), with the counters reset just before and read just
    after. Returns its launches."""
    sharded, single, halo = refine
    reader = Reader(W, H, N_SEG_FRAMES)
    segs = segments.split_segments(N_SEG_FRAMES, N_SEGS)
    own = [encode_sequence(segments.ListReader(reader.frames[s : s + n]),
                           ldp_cfg(npz, frames=n), device=dev)[0]
           for s, n in segs]
    want = bitio.write_annexb(own[0].nals + own[1].nals[3:],
                              own[0].first_of_au + own[1].first_of_au[3:])
    torch.cuda.synchronize()
    reset_launches()
    PLAIN_DECIDE[0] = 0
    t0 = time.time()
    m1 = mesh_mod.tile_prescreen(mesh_mod.make_mesh(1), H, W)(plane)
    m3 = mesh_mod.tile_prescreen(mesh_mod.make_mesh(3), H, W)(plane)
    r3, r1 = sharded(*rargs), single(*rargs)
    t1 = time.time()
    mesh2 = mesh_mod.make_mesh(N_SEGS)
    stream, results = segments.encode_segments_overlapped(
        reader.frames, ldp_cfg(npz, frames=N_SEG_FRAMES), N_SEGS,
        mesh2.devices)
    t2 = time.time()
    dry = dryrun_multichip(2, "cuda")
    torch.cuda.synchronize()
    t3 = time.time()
    shard = run_sharded(dev, npz, params, gpu, bounds)
    t4 = time.time()
    launches = dict(LAUNCHES, plain_sao_decide=PLAIN_DECIDE[0])
    missing = [k for k in MULTI_NEED if launches[k] <= 0]
    check(not missing, f"multi-device: kernels not launched: {missing}")
    # one launch a tile_prescreen call on one card: 1 and 3 stripes here,
    # the dryrun's 2 stripes and its whole plane
    check(launches["stripe_prescreen"] == 4,
          f"multi-device: stripe_prescreen launched "
          f"{launches['stripe_prescreen']} times for 4 tile_prescreen calls")
    check(launches["plain_sao_decide"] == 0,
          "multi-device: the plain sao_decide ran on the card")
    inner = torch.ones(H // 8, dtype=torch.bool)
    inner[[H // 24 - 1, 2 * H // 24 - 1]] = False  # stripes 0, 1: last rows
    for a, b, k in zip(m1, m3, ("mode", "cost")):
        check(a.shape == (H // 8, W // 8) and torch.equal(a[inner], b[inner]),
              f"prescreen {k}: 3 stripes differ from 1 off the stripes' "
              "last block rows")
    edge = int((m1[0][~inner] != m3[0][~inner]).sum())
    for a, b, k in zip(r3, r1, ("mv", "sad9", "cost")):
        check(torch.equal(a, b), f"stripe refine {k}: 3 stripes differ from "
              "the single refine")
    check(stream == want, "segments: the overlapped stream differs from the "
          "segments' own streams")
    frames = decode_stream(stream)
    check(len(frames) == N_SEG_FRAMES and len(results) == N_SEG_FRAMES
          and all(f.md5_ok for f in frames),
          f"segments: hashes {[f.md5_ok for f in frames]}")
    print(f"main path multi-device (mesh of n x {dev}): prescreen 416x240 in "
          f"3 stripes == 1 off the stripes' last block rows ({edge} of "
          f"{int((~inner).sum()) * (W // 8)} boundary modes differ, as the "
          f"reference's stripes clamp there); stripe refine in 3 stripes "
          f"(halo {halo}) == single; both in {t1 - t0:.3f} s | overlapped "
          f"segments {W}x{H} x {N_SEG_FRAMES} in {N_SEGS}: {len(stream)} "
          f"bytes == the segments' own streams, hash OK, {t2 - t1:.3f} s "
          f"= {N_SEG_FRAMES / (t2 - t1):.3f} fps | dryrun_multichip(2): "
          f"{dry} in {t3 - t2:.3f} s | sharded grid step x {N_SHARD} "
          f"(with the single one and the IDR) in {t4 - t3:.3f} s | "
          f"launches {launches} | {gpu}", flush=True)
    return launches


class Counted:
    """Bytes and operations of a call, counted from its shapes."""

    def __init__(self, nbytes, ops):
        self.bytes, self.ops = nbytes, ops


def train_work(name, b) -> Counted:
    """What one call of a train-step kernel must move and compute for a
    batch of b (4-byte values): what a train step needs read once and
    written once -- parameters, state, the batch's rows and uniforms in;
    loss, statistics, new state and the gradient out. The logits (no train
    step reads them) and the activations the forward saves for the
    backward (the backward could recompute them) are the kernels' choice
    and not counted. Operations: a multiply-add counts two."""
    mm = 2 * (17 * 22 + 22 * 20 + 20 * 49)  # the three layers' products
    per = 1 + 9 + 2 + 1 + 42  # a sample's index, x, categories, label, u
    if name == "fme_train_fwd":
        # + BN (mean, variance, normalise: ~8 a feature), ReLU, dropout
        # (compare, multiply, divide), the loss (max, sub, exp, add)
        ops = b * (mm + 8 * (9 + 22 + 20) + 42 + 3 * 42 + 4 * 49 + 3)
        return Counted(4 * (N_TRAIN + 102 + b * per + 1 + 2 * 102), ops)
    if name == "fme_train_bwd":
        # softmax and dlogits, the transposed products, the weight
        # products, biases, BN backward (~10 a feature), dropout, ReLU
        ops = b * (4 * 49 + 2 * mm + 91 + 10 * 42 + 2 * 9 + 2 * 42 + 42 + 8)
        return Counted(4 * (N_TRAIN + b * per + 1 + N_TRAIN), ops)
    # Adam: the two moments, the corrections, the update (~14 an element)
    return Counted(4 * (7 * N_TRAIN + 2), 14 * N_TRAIN)


def train_steps(t, mode, steps=TRAIN_STEPS_CHECKED):
    """`steps` whole train steps from t's start: mode "direct" is
    train_fme's own step (`models.fme_train.train_step`: the wrappers,
    their bindings kept in the data and the Adam state), "function" goes
    through FmeTrainLoss and torch.autograd.grad, "plain" runs the plain
    versions. Returns (flat, state, losses, seconds)."""
    cfg = t["cfg"]
    flat, state = t["flat"].clone(), t["state"].clone()
    opt = ft.AdamState.zeros(N_TRAIN, flat.device)
    leaf = flat.detach().requires_grad_()
    one = torch.ones((), device=flat.device)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        args = (t["data"], t["rows"][s], t["unif"][s])
        if mode == "direct":
            out = train_step(flat, state, *args, opt, cfg, one)
            loss, state = out.loss, out.state
        elif mode == "function":
            loss, state = ft.FmeTrainLoss.apply(leaf, state, *args,
                                                cfg.dropouts, cfg.bn_momentum)
            (g,) = torch.autograd.grad(loss, leaf, grad_outputs=one)
            ft.fme_adam(flat, g, opt, cfg.lr)
        else:
            out = ft.fme_train_fwd_plain(flat, state, *args, cfg.dropouts,
                                         cfg.bn_momentum)
            g = ft.fme_train_bwd_plain(flat, *args, cfg.dropouts, one)
            ft.fme_adam_plain(flat, g, opt, cfg.lr)
            loss, state = out.loss, out.state
        losses.append(loss.detach())
    torch.cuda.synchronize()
    # (state.clone(): "direct"'s state is a buffer of the forward's
    # binding, which the next run's steps write again)
    return (flat, state.clone(), torch.stack(losses),
            time.perf_counter() - t0)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_train_kernels(dev, ds):
    """The train step's kernels against their plain versions on the
    extracted data at B = 1,024, with the stated tolerances: the forward
    (logits atol 1e-4; loss, batch and running statistics rtol 1e-5 +
    atol 1e-5: float sums in another order), the backward against
    autograd of the plain forward with the same masks (rtol 1e-4 + atol
    1e-6), Adam on the same gradient twice (atol 1e-7), 20 steps from the
    same start (parameters and state rtol 1e-4 + atol 1e-5), two kernel
    runs of 20 steps bit for bit, Adam's count 1,000 after 1,000
    launches. Each kernel's time two ways: the median event time of one
    wrapper call (`ms`, launch included; the outputs are the bindings'
    buffers, so no allocation is in it) and `device_ms` (events around
    200 launches queued behind a device sleep, over 200),
    `torch._fused_adam_` beside Adam both ways. Prints the forward's and
    the backward's launch geometry (main() prints every source's ptxas
    report, fme_train's with it).
    Returns {name: row}."""
    t = train_inputs(dev, ds)
    cfg, data = t["cfg"], t["data"]
    b = cfg.batch_size
    fwd_args = (t["flat"], t["state"], data, t["rows"][0], t["unif"][0],
                cfg.dropouts, cfg.bn_momentum)
    got = ft.fme_train_fwd(*fwd_args)
    want = ft.fme_train_fwd_plain(*fwd_args)
    torch.cuda.synchronize()
    errs = {k: max_err(getattr(got, k), getattr(want, k))
            for k in ("logits", "loss", "stats", "state")}
    check(errs["logits"] <= 1e-4, f"fme_train_fwd: logits differ by "
          f"{errs['logits']}")
    for k in ("loss", "stats", "state"):
        check(torch.allclose(getattr(got, k), getattr(want, k), rtol=1e-5,
                             atol=1e-5), f"fme_train_fwd: {k} differ by "
              f"{errs[k]}")
    rows = {}

    def record(name, err, call, plain, extra=""):
        work = train_work(name, b)
        bound_ms, bound_by = bound_of(dict(work=work))
        ms, plain_ms = median_ms(call), median_ms(plain)
        dev_ms = device_ms(call)
        print(f"kernel {name:13s} B {b}: max_abs_err {err:.3g} kernel_ms "
              f"{ms:.4f} device_ms {dev_ms:.5f} plain_ms {plain_ms:.4f} "
              f"bound {bound_ms:.6f} ms ({bound_by}; {work.bytes} bytes, "
              f"{work.ops} operations){extra}", flush=True)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          device_ms=dev_ms, work=work)

    record("fme_train_fwd", max(errs.values()),
           lambda: ft.fme_train_fwd(*fwd_args),
           lambda: ft.fme_train_fwd_plain(*fwd_args),
           f" | logits {errs['logits']:.3g}, loss {errs['loss']:.3g}, stats "
           f"{errs['stats']:.3g}, state {errs['state']:.3g} | launch "
           f"{ft.fwd_geometry(dev, b)}")

    one = torch.ones((), device=dev)
    bwd_args = (t["flat"], data, t["rows"][0], t["unif"][0], cfg.dropouts)
    g = ft.fme_train_bwd(*bwd_args, got.saved, got.stats, one)
    g_plain = ft.fme_train_bwd_plain(*bwd_args, one)
    torch.cuda.synchronize()
    check(torch.allclose(g, g_plain, rtol=1e-4, atol=1e-6),
          f"fme_train_bwd: gradients differ by {max_err(g, g_plain)}")
    record("fme_train_bwd", max_err(g, g_plain),
           lambda: ft.fme_train_bwd(*bwd_args, got.saved, got.stats, one),
           lambda: ft.fme_train_bwd_plain(*bwd_args, one),
           f" | launch {ft.bwd_geometry(dev)}")

    outs = []
    for adam in (ft.fme_adam, ft.fme_adam_plain):
        flat, opt = t["flat"].clone(), ft.AdamState.zeros(N_TRAIN, dev)
        for _ in range(2):
            adam(flat, g_plain, opt, cfg.lr)
        outs.append((flat, opt))
    torch.cuda.synchronize()
    a_err = max(max_err(outs[0][0], outs[1][0]),
                max_err(outs[0][1].m, outs[1][1].m))
    check(a_err <= 1e-7 and int(outs[0][1].count) == 2,
          f"fme_adam: differs by {a_err}, count {int(outs[0][1].count)}")
    flat, opt = t["flat"].clone(), ft.AdamState.zeros(N_TRAIN, dev)
    lib = [flat.clone()], [g_plain], [opt.m.clone()], [opt.v.clone()]
    step_t = [torch.ones((), device=dev)]

    def fused():
        torch._fused_adam_(*lib, [], step_t, lr=cfg.lr, beta1=0.9,
                           beta2=0.999, weight_decay=0.0, eps=1e-8,
                           amsgrad=False, maximize=False)

    record("fme_adam", a_err,
           lambda: ft.fme_adam(flat, g_plain, opt, cfg.lr),
           lambda: ft.fme_adam_plain(flat, g_plain, opt, cfg.lr),
           f" | {-(-N_TRAIN // 256)} blocks")
    lib_ms, lib_dev = median_ms(fused), device_ms(fused)
    rows["fme_adam"]["library_ms"] = lib_ms
    r = rows["fme_adam"]
    print(f"library fme_adam: torch._fused_adam_ {lib_ms:.4f} ms, device_ms "
          f"{lib_dev:.5f}; fme_adam at or below it: per call "
          f"{r['ms'] <= lib_ms}, device {r['device_ms'] <= lib_dev}",
          flush=True)
    # the count over many blocks: one a launch, the ticket back at 0
    opt = ft.AdamState.zeros(N_TRAIN, dev)
    for _ in range(1000):
        ft.fme_adam(flat, g_plain, opt, cfg.lr)
    check(int(opt.count) == 1000 and int(opt.ticket) == 0,
          f"fme_adam: count {int(opt.count)}, ticket {int(opt.ticket)} "
          f"after 1,000 launches")

    k1, fn, k2, plain = (train_steps(t, m) for m in
                         ("direct", "function", "direct", "plain"))
    same = all(torch.equal(x, y) for x, y in zip(k1[:3], k2[:3]))
    check(same, "fme_train: two kernel runs of 20 steps differ")
    check(all(torch.equal(x, y) for x, y in zip(k1[:3], fn[:3])),
          "fme_train: the steps through FmeTrainLoss differ from the direct "
          "calls")
    for x, y, what in zip(k1, plain, ("parameters", "state", "losses")):
        check(torch.allclose(x, y, rtol=1e-4, atol=1e-5),
              f"fme_train: 20 steps' {what} differ by {max_err(x, y)}")
    print(f"train steps: {TRAIN_STEPS_CHECKED} kernel steps == "
          f"{TRAIN_STEPS_CHECKED} plain within rtol 1e-4 + atol 1e-5 "
          f"(parameters {max_err(k1[0], plain[0]):.3g}, state "
          f"{max_err(k1[1], plain[1]):.3g}, losses {max_err(k1[2], plain[2]):.3g}"
          f"; loss {float(k1[2][0]):.4f} -> {float(k1[2][-1]):.4f}); two "
          f"kernel runs bit-identical: {same}, and through FmeTrainLoss; "
          f"{TRAIN_STEPS_CHECKED} steps in {k1[3]:.4f} / {k2[3]:.4f} s direct, "
          f"{fn[3]:.4f} s through FmeTrainLoss, {plain[3]:.4f} s plain",
          flush=True)
    return rows


def run_training(dev, ds, npz, gpu, seeded):
    """Main path 8: train_fme at the full TrainConfig on the card (the
    counters reset just before), the export, and the anchor LD-P cfg
    encoded with the weights it made; beside it an FmeMode dctif encode
    of the same clip and path 1's (seeded weights) numbers. Returns the
    launches."""
    sads, heights, widths, labels, ext_secs = ds
    cfg = TrainConfig()
    n_tr = len(sads) - max(1, len(sads) // 5)
    steps = cfg.epochs * -(-n_tr // min(cfg.batch_size, n_tr))
    hist = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    inf, acc = train_fme(sads, labels, heights, widths, cfg, device=dev,
                         history=hist)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = dict(LAUNCHES)
    for k in TRAIN_KERNELS:
        check(launches[k] == steps, f"training: {k} launched {launches[k]} "
              f"times for {steps} steps")
    check(hist[-1] < hist[0], f"training: loss {hist[0]} -> {hist[-1]}")
    check(all(np.isfinite(v).all() for v in inf.values()),
          "training: exported weights not finite")
    print(f"main path NN-FME training: extract {len(labels)} samples "
          f"({TRAIN_W}x{TRAIN_H} x {TRAIN_FRAMES}, QP {TRAIN_QP}, SR "
          f"{TRAIN_SR}) in {ext_secs:.3f} s "
          f"of host | train_fme {cfg.epochs} epochs, {steps} steps of "
          f"{cfg.batch_size} in {secs:.3f} s = {steps / secs:.1f} steps/s, "
          f"{secs / steps * 1e3:.3f} ms a step | epoch loss {hist[0]:.4f} -> "
          f"{hist[-1]:.4f} | val accuracy {acc:.4f} | launches "
          f"{ {k: launches[k] for k in TRAIN_KERNELS} } | {gpu}", flush=True)
    trained = os.path.join(os.path.dirname(npz), "nnfme_trained.npz")
    save_npz(trained, {TRAIN_QP: inf})
    enc, recons, e_secs, e_launches = run_path(dev, ldp_cfg(trained), NFRAMES)
    check_stream(enc, recons, NFRAMES, e_launches, LDP_NEED,
                 "LD-P with the trained weights")
    res = {"trained": enc.results, "seeded": seeded}
    for k in KERNELS:
        launches[k] += e_launches[k]
    enc, recons, _, d_launches = run_path(
        dev, ldp_cfg(npz, extra=["--FmeMode=dctif"]), NFRAMES)
    check_stream(enc, recons, NFRAMES, d_launches, INTRA + G_KERNELS
                 + ("grid_subpel",), "LD-P dctif")
    check(d_launches["grid_subpel"] == NFRAMES - 1,
          f"LD-P dctif: grid_subpel launched {d_launches['grid_subpel']} "
          f"times for {NFRAMES - 1} P pictures")
    res["dctif"] = enc.results
    for k in KERNELS:
        launches[k] += d_launches[k]
    summary = ", ".join(
        f"{tag} {sum(r.bits for r in rs) / 1000:.1f} kbit Y-PSNR "
        f"{np.mean([r.psnr_y for r in rs]):.3f} dB" for tag, rs in res.items())
    print(f"main path NN-FME training, encode: the anchor LD-P cfg {W}x{H} x "
          f"{NFRAMES} at QP {QP} with the trained weights in {e_secs:.3f} s, "
          f"hash OK, nnfme_mlp {e_launches['nnfme_mlp']} launches | "
          f"{summary} | {gpu}", flush=True)
    return launches


def main():
    dev = require_cuda()
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.time()
    built = kbuild.build()
    print(f"build: {time.time() - t0:.2f} s for {sorted(built)}", flush=True)
    for name, log in kbuild.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas {name}: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "nnfme_seeded.npz")
        params = random_params(SEED)
        save_npz(npz, {QP: params})
        model = NNFME.from_numpy(params, dev)

        rows = check_kernels(dev, model)
        rows.update(check_intra_kernels(dev, npz))
        rows.update(check_b_kernels(dev, npz, params))
        rows.update(check_grid_kernels(dev, npz, params))
        check_stats_adversarial(dev)
        check_wp_me_adversarial(dev)
        check_deblock_adversarial(dev)
        check_satd_adversarial(dev, gpu)
        check_bank_bits_adversarial(dev, gpu)
        rows.update(check_intra_wave(dev))
        multi = multi_calls(dev)
        rows.update(check_multi_kernels(multi[0], rows))
        step_bounds = check_stripe_kernels(*stripe_calls(dev, npz, params),
                                           rows)
        check_stripe_subpel(dev, npz, params, rows)
        fme_ds = fme_dataset()
        rows.update(check_train_kernels(dev, fme_ds))
        count_plain_decide()

        # LD-P: a warm-up encode (the grid step's first picture pays the
        # libraries' loads), then the counted one
        run_path(dev, ldp_cfg(npz, frames=3), 3)
        enc, recons, secs, launches = run_path(dev, ldp_cfg(npz), NFRAMES)
        check_stream(enc, recons, NFRAMES, launches, LDP_NEED, "LD-P")
        check_sao_on_card(launches, NFRAMES - 1, "LD-P")
        check_deblock_once(launches, NFRAMES - 1, "LD-P")
        # K2: the grid's classes of a P picture in one launch
        check(launches["nnfme_mlp"] == NFRAMES - 1,
              f"LD-P: nnfme_mlp launched {launches['nnfme_mlp']} times for "
              f"{NFRAMES - 1} P pictures")
        seeded = enc.results
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        print(f"main path LD-P: {W}x{H} x {NFRAMES} frames in {secs:.3f} s "
              f"= {NFRAMES / secs:.3f} fps (IDR {enc.results[0].seconds:.3f} "
              f"s) | {kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
              f"{launches} | {gpu}", flush=True)

        enc, recons, secs, ai_launches = run_path(
            dev, intra_cfg(W, H, N_INTRA), N_INTRA)
        check_stream(enc, recons, N_INTRA, ai_launches, INTRA, "all-intra")
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        pic = [round(r.seconds, 3) for r in enc.results]
        print(f"main path all-intra: {W}x{H} x {N_INTRA} pictures in "
              f"{secs:.3f} s = {N_INTRA / secs:.3f} fps (per picture {pic} "
              f"s) | {kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
              f"{ai_launches} | {gpu}", flush=True)
        for k in KERNELS:
            launches[k] += ai_launches[k]
        check(all(launches[k] == 0 for k in B_KERNELS + P_ONCE),
              "LD-P or all-intra launched a B step kernel, K1, K3 or K4")

        # random access: a warm-up encode (builds every B step and the P
        # tail's stage), then the counted one
        run_path(dev, ra_cfg(npz, frames=6), 6)
        p_calls = {k: [] for k in P_ONCE}
        saved = recording(inter_batch, P_ONCE, p_calls)
        try:
            enc, recons, secs, ra_launches = run_path(dev, ra_cfg(npz), N_RA)
        finally:
            restore(inter_batch, saved)
        check_stream(enc, recons, N_RA, ra_launches, RA_NEED,
                     "random access")
        check_p_tail(p_calls, ra_launches)
        kbits = sum(r.bits for r in enc.results) / 1000
        psnr = np.mean([r.psnr_y for r in enc.results])
        pocs = [r.poc for r in enc.results]
        print(f"main path random access: {W}x{H} x {N_RA} pictures (decode "
              f"order {pocs}) in {secs:.3f} s warm = {N_RA / secs:.3f} fps | "
              f"{kbits:.1f} kbit, Y-PSNR {psnr:.3f} dB | launches "
              f"{ra_launches} | {gpu}", flush=True)
        # the B step (a call a B picture: N_RA - 2 of them) launches b_me,
        # b_pred and b_txq once each
        check(all(ra_launches[k] == N_RA - 2 for k in B_KERNELS),
              f"random access: B step launches "
              f"{ {k: ra_launches[k] for k in B_KERNELS} } for {N_RA - 2} "
              "B pictures")
        for k in KERNELS:
            launches[k] += ra_launches[k]

        # grid_subpel runs on the DCT-IF paths only, once a P picture
        check(launches["grid_subpel"] == 0,
              f"paths 1-3 launched grid_subpel {launches['grid_subpel']} "
              "times")
        fw_launches = run_fme_wp(dev, npz, gpu)
        check(fw_launches["grid_subpel"] == NFRAMES - 1,
              f"LD-P dctif + WP: grid_subpel launched "
              f"{fw_launches['grid_subpel']} times for {NFRAMES - 1} P "
              f"pictures")
        for k in KERNELS:
            launches[k] += fw_launches[k]

        bench_launches = run_bench(dev, gpu)
        check(bench_launches["grid_subpel"] == 0,
              "bench.py's cfg launched grid_subpel")
        for k in KERNELS:
            launches[k] += bench_launches[k]
        # paths 1-5 run quadtree intra: the fixed-8x8 kernel stays idle
        check(launches["intra_wave"] == 0,
              f"paths 1-5 launched intra_wave {launches['intra_wave']} times")

        i8_launches = run_intra8(dev, gpu)
        check(i8_launches["grid_subpel"] == 0, "path 6 launched grid_subpel")
        check(all(i8_launches[k] == 0 for k in P_ONCE),
              "path 6 launched K1, K3 or K4")
        for k in KERNELS:
            launches[k] += i8_launches[k]
        # paths 4-6 code no B picture
        check(all(x[k] == 0 for x in (fw_launches, bench_launches,
                                      i8_launches) for k in B_KERNELS),
              "paths 4-6 launched a B step kernel")
        # paths 1-6 run no stripe
        check(launches["stripe_prescreen"] == 0,
              "paths 1-6 launched stripe_prescreen")

        mp_launches = run_multi(dev, npz, gpu, *multi[1:], params,
                                step_bounds)
        for k in KERNELS:
            launches[k] += mp_launches[k]
        # paths 1-7 train nothing
        check(all(launches[k] == 0 for k in TRAIN_KERNELS),
              "paths 1-7 launched a train-step kernel")

        tr_launches = run_training(dev, fme_ds, npz, gpu, seeded)
        for k in KERNELS:
            launches[k] += tr_launches[k]

        pp_launches, sbh_row = run_per_picture(dev, npz, gpu)
        check(all(pp_launches[k] == 0 for k in TRAIN_KERNELS + G_KERNELS),
              "path 9 launched a train-step or grid kernel")
        for k in KERNELS:
            launches[k] += pp_launches[k]
        rows["b_txq"]["sbh"] = sbh_row
        # paths 1-9 run 8-bit video
        check(all(launches[k] == 0 for k in M10_KERNELS),
              "paths 1-9 launched a 10-bit variant")

        m10_launches, m10_rows = run_main10(dev, npz, gpu)
        check(all(m10_launches[k] == 0 for k in TRAIN_KERNELS + G_KERNELS
                  + B_KERNELS + ("intra_wave", "intra_wave10")),
              "path 10 launched a train-step, grid, B step or intra_wave "
              "kernel")
        for k in KERNELS:
            launches[k] += m10_launches[k]
        rows.update(m10_rows)
        ra10_launches, ra10_rows = run_ra10(dev, npz, gpu)
        check(all(ra10_launches[k] == 0 for k in TRAIN_KERNELS + G_KERNELS
                  + ("intra_wave", "intra_wave10")),
              "path 10's random access launched a train-step, grid or "
              "intra_wave kernel")
        for k in KERNELS:
            launches[k] += ra10_launches[k]
        rows.update(ra10_rows)
        i10_launches, i10_rows = run_main10_intra8(dev, npz, gpu)
        check(all(i10_launches[k] == 0 for k in TRAIN_KERNELS + G_KERNELS
                  + B_KERNELS + B10_KERNELS),
              "path 10's fixed-8x8 routes launched a train-step, grid or B "
              "step kernel")
        for k in KERNELS:
            launches[k] += i10_launches[k]
        rows.update(i10_rows)

        sizes = cross_check_cpu(npz)
        print(f"cross-check: CUDA == CPU streams (LD-P scan 112x72 "
              f"{sizes[0]} bytes, all-intra 112x72 {sizes[1]} bytes, LD-P "
              f"grid 128x64 {sizes[2]} bytes, with the tools cut "
              f"{sizes[3]} bytes, with dctif + WP {sizes[4]} bytes, without "
              f"the recon fetch {sizes[5]} bytes, random access 64x48 "
              f"{sizes[6]} bytes; fixed 8x8: all-intra 104x72, LD-P "
              f"112x72 {cross_check_intra8(npz)} bytes)", flush=True)
        print(f"cross-check: CUDA == CPU streams of path 9's routes (the "
              f"anchor 112x72 x 4, then at 64x48 x 6 IntraPeriod 4, random "
              f"access with the tools and SBH, without a GOP table, rate "
              f"control at picture and CTU level): "
              f"{cross_check_per_picture(npz)} bytes", flush=True)
        print(f"cross-check: CUDA == CPU streams of path 10's routes at "
              f"112x72 (Main10 all-intra x {N10_AI}, the LD-P scan x "
              f"{N10_SCAN}, IntraPeriod 4 x {N10_IP}, the anchor x "
              f"{N10_ANCHOR}): {cross_check_main10(npz)} bytes", flush=True)
        print(f"cross-check: CUDA == CPU streams of path 10's random-access "
              f"routes at 64x48 x 6 (Main10 with the GOP table, without it, "
              f"with RDOQ, SBH, deblocking and SAO): {cross_check_ra10(npz)} "
              f"bytes", flush=True)
        print(f"cross-check: CUDA == CPU streams of path 10's fixed-8x8 "
              f"routes (Main10 all-intra 112x72 x 3 with device_batch=2, the "
              f"LD-P scan 64x48 x 3): {cross_check_main10_intra8(npz)} "
              f"bytes", flush=True)

    kernels = []
    for k in KERNELS:
        r = rows[k]
        bound_ms, bound_by = bound_of(r)
        print(f"bound {k}: {r['work'].bytes} bytes, {r['work'].ops} "
              f"operations -> {bound_ms:.6f} ms ({bound_by})"
              + (f"; dependency depth {r['steps']} waves" if "steps" in r
                 else ""))
        if "wp" in r:
            print(f"bound {k} (weighted): {r['wp']['bound_ms']:.6f} ms "
                  f"({r['wp']['bound_by']}); kernel_ms {r['wp']['ms']:.4f} "
                  f"plain_ms {r['wp']['plain_ms']:.4f}")
        kernels.append(dict(
            name=k, route="cuda", source=SOURCES[k][0],
            replaces=SOURCES[k][1], launches=launches[k],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            # the device time where the script measured it (events around
            # launches queued behind a device sleep), else None
            device_ms=r.get("device_ms"),
            bound_ms=bound_ms, bound_by=bound_by,
            # torch.cdist (p=1) computes the SAD surfaces of sad_search,
            # b_me, grid_coarse and grid_refine, one advanced-index gather
            # grid_satd's predictions, torch.nn.functional.conv2d
            # grid_planes' sums and torch._fused_adam_ fme_adam's update;
            # no single PyTorch call computes any of the other functions
            library_ms=r.get("library_ms"),
            # b_txq's sign-hiding variant (path 9's B pictures): its
            # launches, times and bound
            **({"sbh": {key: r["sbh"][key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "device_ms",
                "bound_ms", "bound_by")}} if "sbh" in r else {})))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
