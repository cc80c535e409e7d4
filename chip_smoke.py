#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (dcanet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device and build: the card's name and power limit (nvidia-smi); every
     CUDA kernel built from the checkout's sources, one nvcc per source, with
     ptxas's registers, shared memory and spills per kernel; the conv3d library's SASS
     (cuobjdump) must hold only the two tensor-core kernels, with TF32 HMMA
     in the f32 (3xTF32) kernel and bf16 HMMA in the bf16 one.
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at edge cases (for the gwc forward and
     backward: odd W, D = 60, D > W, 1 and 32 channels per group; for the
     forward also the KITTI eval protocol's features, W = 308, and plane
     ranges against the plain version's slices of the whole volume: the
     two ranks' [0, 24) and [24, 48) at ETH3D's 768x1024, [0, 8) and
     [54, 60) of D = 60 at a half-resolution Middlebury pair, a range past
     W, each timed beside its bound and the whole ETH3D volume; for the
     backward also D = 140, 2 and 16 channels per group, 32 on a full tile,
     the Middlebury shape and a batch of 12, and plane ranges against the
     plain version's range backward with NaN at the occluded grad entries:
     [0, 24), [24, 48), [16, 32) and [0, 48) of the train shape, [54, 60)
     and [0, 8) of the Middlebury train shape, a range across W and one
     past it, each timed beside its bound; forward and backward also over
     the planes of the disparity-sharded Middlebury train step's ranks at
     its train shape, [0, 30) and [30, 60) (2 ranks), [0, 16), [16, 32),
     [32, 46) and [46, 60) (4 ranks), each timed, with the shared memory
     each backward range asks for a block held to the card's limit), TF32
     off: the gwc volume, its backward (against autograd through the plain
     version), conv3d (with scale, bias and ReLU) and conv3d_fast's
     backward; CUDA-event times of kernel, plain version and, for conv3d,
     F.conv3d (cuDNN) beside the card's bound for the same work (the gwc
     forward also at the train shape, at batch 1, at the bf16 train leg's
     batch 4, at the KITTI preset's batch 12 and at a card's share of it
     on 2 and 4 cards, 6 and 3, and at the KITTI eval shape, the backward
     at the train shape at batch 1, 4, 12, 6 and 3 and at the Middlebury
     shape); the gwc kernels
     retimed at the end; for context only, F.conv3d f32 with TF32 on (time,
     and its error, which misses the f32 tolerance). The train-mode
     BatchNorm kernels (`phase_batch_norm`), f32 and bf16, against their
     plain version and float64 at the kitti step's shapes, a ragged S, one
     channel and a small N*S; the forward and backward pairs timed at the
     kitti step's largest 3D and 2D BatchNorm beside their byte bounds, the
     plain version and F.batch_norm, each kernel's own time from the
     profiler.
  2b. io: the native PNG decoder (`data/native.py` over `csrc/stereoio.cpp`,
     host code, built with the kernels by the host compiler) exact against
     the plain numpy reader and the written pixels: a procedural KITTI
     scene at 376x1248 (RGB and its uint16 sparse gt) with each filter type
     on every row and with the writer's own choice per row, and a 1988x2880
     scene (the writer's choice, against the pixels alone); single-thread
     ms/image of the native decoder, the plain reader and zlib's inflate of
     the IDAT alone; `read_image` of 24 KITTI images serially and on an
     8-thread pool beside one image; the host's usable CPU count beside the
     card's name and power limit. Phases 13 and 14 then write their trees
     with the same writer (every row's filter chosen as libpng chooses it).
  3. model: DCANet(num_cva=3, maxdisp=192) eval on one 1x3x384x1248 pair,
     weights from `weights.from_jax_variables` on seeded numpy arrays, in bf16
     autocast with the eval BatchNorm folded into its conv (the default, as
     the JAX package does at bf16), in bf16 with it literal
     (DCANET_FOLD_EVAL_BN=0) and in f32; output shape, finiteness, one gwc
     launch per forward, the BatchNorm module forwards (folded: Guidance's
     10 alone), ms/pair (the two bf16 forms timed twice, alternating),
     pairs/s, peak memory, a profile each (device busy share, launches,
     BatchNorm kernels' share); the GPU model against the CPU model (plain
     gwc) on a small input in f32, and folded bf16 on both (BatchNorm
     statistics of one train-mode forward of the small pair): their dtype
     plans op by op equal (`dtype_record`; ops/precision.py), one
     MultiAggregation within 2e-2 scaled, the disparity closer than the
     CPU's own bf16 forward is to its f32 one.
  4. serving: three `cli infer --submission` requests on a synthetic
     KITTI-sized PNG pair; the gwc launches of this phase are counted.
  5. conv3d path: the counterpart of the JAX package's run_pallas
     (tools/bench_conv3d.py), in f32 and in bf16: the convs at its shapes and
     one conv3d_fast forward and backward; the launches of this phase are
     counted for each of the two conv3d kernels.
  6. train: `cli train --preset sceneflow` with DCANet(num_cva=3,
     maxdisp=192) at full width on a synthetic SceneFlow tree (540x960
     pairs from the seed), the preset's 256x512 crop, batch 1, f32: loss
     finite at every step, one gwc forward and one gwc backward launch per
     step (the counts of this phase), ms/step, pairs/s, peak memory, the
     checkpoints, a resumed epoch, and one `cli infer --submission --logdir`
     request served from the run's newest checkpoint (its gwc launch
     counted, its PNG against the checkpoint's weights run in-process). Then
     the bf16 leg: `cli train --dtype bfloat16 --batch-size 4` for one epoch
     on 24 procedural scenes at 320x640 (`write_procedural_sceneflow_tree`):
     every metric finite, one bf16 gwc forward and one bf16 backward launch
     per step and no f32 one (the counts of this leg, per dtype), ms/step,
     pairs/s, peak memory; the train step alone at batch 1, 2 and 4 in f32
     and bf16: peak memory, the memory held between steps and what holds
     the memory at a step's peak (the allocator's history). Then one GPU
     train step against the CPU train step from the same weights on a small
     input, in f32 and in bf16 (the bf16 step within the CPU's own
     bf16-vs-f32 distance), and the dtype plan of the bf16 step's forward
     and loss op by op (`dtype_record`), equal on the card and the CPU;
     then the KITTI preset's step (5x / 10x focal and smooth-L1 on a sparse
     gt) on a crop of a procedural KITTI scene, GPU against CPU, in f32 and
     in bf16 with the same bounds.
  7. eval: `cli eval --preset kitti --dataset kitti2015` with DCANet(num_cva=3,
     maxdisp=192) on a synthetic KITTI 2015 tree of 6 pairs at 375x1242
     (sparse gt, one pair that the per-image skip rule drops), in f32 and in
     bf16, with phase 6's newest checkpoint (the seed-0 init when phase 6
     does not run): one gwc launch per pair (the counts of this phase), EPE,
     D1 and >1/2/3 px against direct model calls with numpy formulas (rel
     1e-5), the class scores of every CVA volume against a numpy count of
     the same logits (exact), `--log-images 2` panels read back; then the
     command again with cuDNN's default algorithms, as a user runs it:
     ms/pair, pairs/s (host clock, after the first pair), peak memory, the
     host's decode of a pair and the forward alone. Then `cli infer --list`
     over 3 names against single `infer --submission` requests, and `cli
     export` of phase 6's run with `infer --weights` on it against `infer
     --logdir`, each bit for bit. The checks that compare two runs take
     cuDNN's deterministic algorithms in both (`cudnn_deterministic`).
  8. family: the rest of the model registry, each at full width (maxdisp
     192) with weights from `weights.from_jax_variables` on seeded numpy
     arrays: `dcanet-g`, `gwcnet-g`, `gwcnet-gc` and `ganet` eval on one
     1x3x384x1248 pair in bf16 autocast and in f32 (shape, finiteness,
     exactly one gwc launch per forward, ms/pair, pairs/s, peak memory, one
     profile each: device busy share, kernel launches, BatchNorm kernels;
     `gwcnet-gc` and `ganet` also in bf16 with the BatchNorm literal,
     DCANET_FOLD_EVAL_BN=0), each GPU model
     against its CPU model on a small pair (disparity 5e-3 px, the final
     head's logits 1e-4 scaled) and, folded bf16 with calibrated BatchNorm
     statistics, their dtype plans equal op by op and the disparity's
     distance logged; `cli train --preset sceneflow --model
     gwcnet-gc` and `--model ganet` for 4 steps at the 256x512 crop, f32
     (finite loss, one gwc forward and one backward launch per step,
     ms/step, peak memory), each with one GPU train step against the CPU
     one; one `cli infer --submission --model gwcnet-gc` request and
     `cli eval --model ganet` on two pairs of a KITTI 2015 tree (one gwc
     launch per pair, no class scores).
  9. extras: the modules of `nn/extras.py` and `nn/context.py`, on no model
     path, at realistic widths with weights from `weights.from_jax_variables`
     on seeded numpy arrays, TF32 off: `UNetFeatureExtractor` on a stacked
     2x3x384x1248 pair (160 + 12 channels at 96x312), `PyramidPooling` cat
     and sum at (1, 128, 24, 78) (1/16 of 384x1248), `MobileV2Residual` and
     `Hourglass2D` at (1, 32, 96, 312), `ImageLevelContext`,
     `DisparityLevelContext`, `SELayerD` and `SemanticLevelContextLocal` at a
     CVA-sized (1, 32, 24, 48, 156) volume, `NonLocalAttention` at (1, 32, 8,
     16, 32) (4,096 tokens); each in eval and train mode against a CPU copy
     with the same weights (outputs and train-mode BN statistics within 1e-4
     scaled by max(|ref|, 1); `UNetFeatureExtractor` compared at 2x3x128x256),
     its time by `utils.profiling.device_time` beside `time_cuda`;
     `UNetFeatureExtractor`'s ms and peak memory in bf16 autocast and f32;
     one `utils.profiling.trace` of its forward, whose file must hold CUDA
     kernel events; `utils.summary.summarize` of DCANet at 384x1248.
 10. parallel: data-parallel `cli train` over two worker processes that share
     the card under gloo (NCCL refuses two ranks on one device), each
     forming the group itself: DCANet(num_cva=3, maxdisp=192), the SceneFlow
     preset's 256x512 crop, f32 with TF32 off, `--batch-size 2` (1 per rank)
     on a synthetic tree of 4 pairs at 540x960, 2 epochs and a resumed one:
     finite losses, one gwc forward and one backward launch per rank per
     step (the counts of this phase, `parallel_train`), the ranks' metrics
     equal, parameters, BatchNorm buffers and Adam state bit-equal at the
     end, rank 1 writing nothing, ms/step and each rank's peak memory; then
     one step from the seeded weights on a global batch of 2 whose ranks
     have different valid-pixel counts, 2 ranks against one process at
     batch 2, both with cuDNN's deterministic algorithms: in f32 (loss terms
     rtol 1e-4, grad norm 1e-3, BatchNorm statistics 1e-4 scaled; the whole
     gradient's and each parameter's distance recorded) and in float64, the
     gwc volume by its plain version (loss terms 1e-7, grad norm 1e-6,
     statistics 1e-10 scaled, each parameter's gradient 1e-7 relative in
     L2); each f32 step's distance to the float64 gradient and the BatchNorm
     inputs' channel |mean| / std recorded; and the step alone, one process
     against 2 ranks time-sharing the card.
 11. disp: disparity-sharded `cli eval --preset eth3d --dataset eth3d` (the
     768x1024 canvas) with DCANet(num_cva=3, maxdisp=192), seeded weights
     whose BatchNorm statistics are those of one train-mode forward of the
     first pair (`calibrate_batch_norm`), on a synthetic ETH3D tree of 4
     scenes: `--n-disp-shards 2` over two worker processes that share the
     card under gloo (as phase 10), in f32 and in bf16, against one process
     on the same tree, cuDNN's deterministic algorithms on both sides: EPE,
     D1 and >1/2/3 px within 5e-3 px / 1e-3, each pair's and volume's
     confusion within 1 % of its total in L1, the ranks' results equal and
     their disparities bit-equal, rank 1 writing nothing, one gwc launch
     per rank per pair of 24 planes (the counts of this phase,
     `disp_eval`), each rank's peak memory and ms/pair beside one
     process's (time-shared); then one float64 forward at 256x512, the gwc
     volume by its plain version, 2 ranks against one process: disparity
     1e-9 px, class logits 1e-10 scaled.
 12. disp_train: disparity-sharded `cli train --n-disp-shards 2` over two
     worker processes that share the card under gloo (as phase 10),
     DCANet(num_cva=3, maxdisp=192), the SceneFlow preset's 256x512 crop,
     f32 with TF32 off, `--batch-size 1` (both ranks load the same pair) on
     a synthetic tree of 4 pairs at 540x960, 2 epochs and a resumed one,
     beside one process on the same tree: finite losses, one gwc forward
     and one backward launch per rank per step, each of 24 planes (the
     range backward; the counts of this phase, `disp_train`), parameters,
     BatchNorm buffers and Adam state bit-equal across the ranks, rank 1
     writing nothing, ms/step and each rank's peak memory beside one
     process's; then one step from the seeded weights on phase 10's global
     batch of 2 (whole on each rank), 2 ranks against one process, cuDNN's
     deterministic algorithms: in f32 (loss terms rtol 1e-4, grad norm
     1e-3, BatchNorm statistics 1e-4 scaled) and in float64, the gwc volume
     by its plain version (loss terms 1e-7, grad norm 1e-6, statistics
     1e-10 scaled, each parameter's gradient 1e-7 relative in L2); and the
     step alone, one process against 2 ranks time-sharing the card.
 13. kitti: the KITTI training stage. Procedural KITTI trees at 376x1248
     (`write_procedural_kitti_tree`: 12 KITTI 2012 + 12 KITTI 2015 scenes
     as kitti_mix, 4 held-out KITTI 2015 scenes, a seed each); `cli export`
     of phase 6's newest checkpoint (a seeded model's without phase 6);
     `cmd_train` with the kitti preset at its batch of 12 in bf16 from
     `loadckpt` of the export, 3 epochs (6 steps), a checkpoint after each:
     the weights before step 1 equal to the export bit for bit, no Adam
     state at step 0 and lr 1e-3, every metric finite, one bf16 gwc forward
     and one bf16 backward launch per step and no f32 one (the counts of
     each run), ms/step, pairs/s, peak memory; the same with `remat` from
     the same weights and batches (its first loss within 1e-3 relative, its
     peak lower); then the leg over 2 ranks that share the card under gloo
     (as phase 10): `cli train --preset kitti` at the global batch of 12
     (6 a rank) in bf16 from the export, 2 epochs (4 steps): the ranks'
     records equal and finite, one bf16 gwc forward and backward launch a
     step on each rank, ms/step and each rank's peak beside one process's;
     the first step from the export, 2 ranks against one process
     (`_hold_parity`, phase 10's bounds): f32 on a global batch of 12 crops
     (six KITTI 2012, six KITTI 2015), float64 (the gwc volume by its plain
     version) on the same samples cut to 64x128, every parameter's gradient
     within 1e-7; `cli eval --preset kitti --dataset kitti2015` in bf16 of
     the trained checkpoint on the held-out scenes: one bf16 gwc launch per
     pair, EPE, D1, ms/pair.
 14. middlebury: the ETH3D and Middlebury training stages. Procedural trees
     (`write_procedural_middlebury_tree`: 4 full-resolution MiddEval3 frames
     at 1988x2880 to train on and 2 held out, disparities up to 640 px;
     `write_procedural_eth3d_tree`: 4 ETH3D frames at 489x941; gt inf where
     unknown; a seed each); `cmd_train --preset middlebury` (DCANet(num_cva=3,
     maxdisp=240): the scenes halved, 320x704 crops, the smooth-L1 preset, D
     = 60 through the gwc kernels) in f32 and in bf16, 2 epochs each, and
     `--preset eth3d` in bf16 for one: every metric finite, one gwc forward
     and one backward launch per step, all of the run's dtype (the counts of
     each run), ms/step with the loader (the steady median inside an epoch,
     and each epoch start's stall beside the checkpoint save and the
     loader's waits there), pairs/s, peak memory; the disparity-sharded leg
     over 2 ranks that share the card under gloo (as phase 12): `cli train
     --preset middlebury --n-disp-shards 2` in bf16, one epoch (4 steps):
     the ranks' records equal and finite, one bf16 gwc forward of the
     rank's planes ([0, 30) and [30, 60) of D = 60) and one range backward
     a step on each rank, ms/step and each rank's peak beside one
     process's; the first step, 2 ranks against one process (as the kitti
     leg; the f32 grad norm within 3e-3): f32 on one 320x704 crop, float64
     on it cut to 64x256 (D = 60 still split); the smooth-L1 step at
     maxdisp 240 on the card against the CPU on 2 Middlebury crops cut to
     64x256, with phase 6's bounds (the bf16 scalars at the kitti case's 2x)
     but for the f32 grad norm: on each crop a float64 step on the card as
     its witness (on the first crop held to the CPU's at phase 10's
     bounds), the card's f32 gradient within 2x the CPU's f32 gradient
     distance from it and its grad norm within 3e-3 of the float64 norm;
     `cli eval --preset
     middlebury` of the f32 run's checkpoint on the held-out scenes (halved,
     replicate-padded to 1024x1472) in f32 and in folded bf16: one gwc launch
     per pair, EPE, D1 and >1/2/3 px against direct model calls (rel 1e-5),
     the class scores against a numpy count of the same logits (exact), both
     under cuDNN's deterministic algorithms; ms/pair and peak memory with
     cuDNN's defaults, the host's decode of each pair and the forward alone.
     Phase 2 checks and times the gwc forward at the phase's train crop and
     eval pair.
 15. summary: each phase's summary line (the io phase's `[io] summary`),
     the card's name and power limit, one `{"kernels": [...]}` line, and
     last `{"ok": true, "device": {...}}`.

`--phases cards`, `cards_kitti` and `cards_middlebury`, manual measurements
outside the smoke's phases (never run by default; each needs two or more
cards; any of them together write `chiprun_out/cards.json`), each command
started as a user starts it, one process per card with the DCANET_*
variables (NCCL). `cards`: `cli train` on 1,
2, 4, ... cards at one 256x512 pair per card: ms/step, pairs/s and the
scaling against one card, and the 2-card first step's loss terms against
one card at batch 2; `cli train --n-disp-shards 2` on 2 cards and on a
data=2 x disp=2 grid of 4: ms/step, each card's peak memory, the first
step's loss against one card; `cli eval --dataset eth3d --n-disp-shards N`
on N = 1, 2, 4, ... cards, f32 and bf16: ms/pair and the metrics against
one card. `cards_kitti`: `cli train --preset kitti --loadckpt` at the global
batch of 12 in bf16 on 1, 2 and 4 cards (12, 6 and 3 pairs a card): ms/step,
pairs/s, the scaling, each card's peak, the gwc launches; the step alone on
a resident batch on each card count (bf16) and the first f32 step's loss
terms against one card (rtol 1e-4). `cards_middlebury`: `cli train --preset
middlebury --n-disp-shards N` on N = 1, 2 and 4 cards in f32 and bf16:
ms/step, each card's peak and what holds it (`memory_at_peak`), the gwc
launches a step on each card and their planes, the first f32 step's loss
terms against one card (rtol 1e-4).

`--phases curve`, a manual measurement outside the smoke's phases (never
run by default; ~30 min): the port's training curve (`phase_curve`,
`dcanet_tpu_torch/traincurve.py`) on 1600 + 40 procedural scenes at
320x640, 5 epochs at batch 4 in bf16, `cli eval` on the held-out scenes
after each epoch, then f32, literal bf16 and folded bf16 `cli eval` of the
trained checkpoint and its folded bf16 forward on the card against the CPU;
its JSON goes to `chiprun_out/traincurve.json` beside the script.

`--phases kitti12`, a manual measurement (never run by default; ~3 min):
the KITTI preset's train step alone at batch 12 (256x512 crops of the
kitti phase's kitti_mix, the batch on the card) for f32 and bf16, each
with and without remat, each in a process of its own: median ms/step after
2 warm-up steps, pairs/s, the peak and its largest blocks; running out of
memory is a result, printed as "oom" with the allocator's message and the
need reckoned from the peak before it plus the allocation refused. JSON in
`chiprun_out/kitti12.json`.

`--phases middlebury_step`, a manual measurement (never run by default): the
Middlebury preset's train step alone at batch 1 (320x704 crops of the
middlebury phase's halved scenes, the batch on the card), as `kitti12`
measures the KITTI one; then `cli train --preset middlebury` over 2 epochs
of 15 procedural scenes (MiddEval3's training set) at batch 1, f32 and
bf16, as the middlebury phase times its runs. JSON in
`chiprun_out/middlebury_step.json`.

`--phases finetune`, a manual measurement (never run by default; ~35 min):
the curve as `--phases curve` runs it, then the KITTI fine-tune leg
(`dcanet_tpu_torch/finetune_kitti.py`) on its epoch-5 checkpoint: 120
KITTI 2012 + 120 KITTI 2015 procedural scenes at 376x1248 and 24 held out
(seeds 1, 2, 3), 8 epochs at batch 4 in bf16, `cli eval` before and after.
JSON in `chiprun_out/traincurve.json` and `chiprun_out/finetune.json`.

`--phases` runs a subset (for iterating on one part); the summary lines are
printed only for the full run.

Needs CUDA: without a card it exits 1 before printing any result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TF32_TC_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
BF16_TC_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
SEED = 0
# BatchNorm modules that DCANet(num_cva=3)'s eval forward runs: all 116 but
# those of the train-only heads classif0-2; in bf16 with the fold on only
# Guidance's `norm1` and its four ResidualBlocks' (norm1, norm2; the strided
# one's downsample BN), literal in the JAX package too
N_EVAL_BN, N_GUIDANCE_BN = 113, 10
MAIN_SHAPE = (1, 320, 96, 312)  # gwc features of a 384x1248 pair
# gwc features of the KITTI eval protocol's 368x1232 crop: W % 8 != 0, the
# bf16 forward's scalar route
KITTI_EVAL_SHAPE = (1, 320, 92, 308)
TRAIN_SHAPE = (1, 320, 64, 128)  # gwc features of a 256x512 SceneFlow crop
# ... of a batch of 4 such crops: the bf16 train leg's and the curve's
TRAIN_B4_SHAPE = (4,) + TRAIN_SHAPE[1:]
# ... of the KITTI preset's batch of 12 crops of 256x512 (the kitti phase's)
TRAIN_B12_SHAPE = (12,) + TRAIN_SHAPE[1:]
# ... of one card's share of that batch on 2 and 4 cards (and of a rank's in
# the kitti phase's 2-rank leg): 6 and 3 crops
TRAIN_B6_SHAPE, TRAIN_B3_SHAPE = (6,) + TRAIN_SHAPE[1:], (3,) + TRAIN_SHAPE[1:]
MAIN_GROUPS, MAIN_D = 40, 48
# the gwc backward at the Middlebury preset's 320x704 crop, maxdisp 240
MIDDLEBURY_SHAPE, MIDDLEBURY_D = (1, 320, 80, 176), 60
# the ranks' planes of the disparity-sharded Middlebury train step (maxdisp
# 240, D = 60 at the 320x704 crop's W/4 = 176; `DispPlan.split`): 2 ranks
# take 15 / 15 plane pairs, 4 ranks 8 / 8 / 7 / 7; the starts 30, 16, 32 and
# 46 are not multiples of the kernels' kV or kND, so they take the range
# instantiations (`csrc/gwc.cu`)
MIDDLEBURY_SHARDS = {2: ((0, 30), (30, 60)), 4: ((0, 16), (16, 32), (32, 46), (46, 60))}
MIDDLEBURY_SHARD_RANGES = tuple((f"middlebury train [{lo},{hi})", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, (lo, hi))
                                for ranges in MIDDLEBURY_SHARDS.values() for lo, hi in ranges)
# the gwc forward's plane ranges, the shares of the disparity-sharded eval's
# ranks: ETH3D's 768x1024 canvas (D = 48 on 2 ranks), a half-resolution
# Middlebury pair padded to 512x768 (maxdisp 240: D = 60, 8 ranks take
# 4,4,4,4,4,4,3,3 pairs of planes), a range past W; None: the whole volume
ETH3D_FEATURES, MIDDLEBURY_EVAL_SHAPE = (1, 320, 192, 256), (1, 320, 128, 192)
GWC_RANGES = (  # name, features, groups, D, planes
    ("eth3d whole", ETH3D_FEATURES, MAIN_GROUPS, MAIN_D, None),
    ("eth3d [0,24)", ETH3D_FEATURES, MAIN_GROUPS, MAIN_D, (0, 24)),
    ("eth3d [24,48)", ETH3D_FEATURES, MAIN_GROUPS, MAIN_D, (24, 48)),
    ("middlebury [0,8)", MIDDLEBURY_EVAL_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, (0, 8)),
    ("middlebury [54,60)", MIDDLEBURY_EVAL_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, (54, 60)),
    ("past W [8,12)", (2, 16, 5, 7), 4, 12, (8, 12)),
) + MIDDLEBURY_SHARD_RANGES
# the forward's ranges that are timed: all but the one past W
GWC_TIMED_RANGES = tuple(r for r in GWC_RANGES if not r[0].startswith("past W"))
# the gwc backward's plane ranges, the shares of the disparity-sharded train
# step's ranks: the SceneFlow train shape (D = 48; 2 ranks take [0, 24) and
# [24, 48), the middle one of 3 [16, 32); the whole range by the range
# entry), the Middlebury train shape (D = 60 on 8 ranks: the last [54, 60),
# 54 % kND != 0, and the first [0, 8)), a range across W and one past it;
# each timed
GWC_BWD_RANGES = (  # name, features, groups, D, planes
    ("train [0,24)", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, (0, 24)),
    ("train [24,48)", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, (24, 48)),
    ("train [16,32)", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, (16, 32)),
    ("train [0,48)", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, (0, 48)),
    ("middlebury [54,60)", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, (54, 60)),
    ("middlebury [0,8)", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, (0, 8)),
    ("across W [40,52)", (1, 16, 5, 45), 4, 60, (40, 52)),
    ("past W [8,12)", (2, 16, 5, 7), 4, 12, (8, 12)),
) + MIDDLEBURY_SHARD_RANGES
# train-mode BatchNorm (kernels/batchnorm.py): the kitti step's largest 3D
# BatchNorm (batch 12, 256x512 crops: the quarter-resolution cost volume)
# and its largest 2D one (the half-resolution features), timed; checked
# besides on its most frequent 2D shape, a ragged S (S * 2 % 16 != 0 in
# bf16), one channel, a small N*S and one value per channel
BN_TIMED = (("3d", (12, 32, 48, 64, 128)), ("2d", (12, 32, 128, 256)))
BN_CHECKED = tuple(s for _, s in BN_TIMED) + ((12, 64, 64, 128), (2, 5, 3, 7, 9), (3, 1, 17), (2, 3, 2, 2),
                                              (1, 3, 1, 1))
# the conv3d kernel's own path: tools/bench_conv3d.py::run_pallas's shapes, NCDHW
CONV_SHAPE = (1, 32, 48, 96, 312)
CONV_SHAPE_64 = (1, 64, 48, 96, 312)
# training phase: synthetic SceneFlow pairs at the dataset's 540x960, the
# preset's 256x512 crop, TRAIN_EPOCHS epochs, then one resumed epoch
SCENEFLOW_HW = (540, 960)
TRAIN_PAIRS, TRAIN_EPOCHS, TRAIN_WARMUP = 5, 2, 2
# the bf16 leg of the train phase: `cli train --dtype bfloat16` at batch
# BF16_TRAIN_BATCH on BF16_TRAIN_SCENES procedural scenes at PROCEDURAL_HW
# (TRAINCURVE.md's size), one epoch; the train step's peak memory at each of
# MEMORY_BATCHES in f32 and bf16, over MEMORY_STEPS steps
PROCEDURAL_HW, BF16_TRAIN_SCENES, BF16_TRAIN_BATCH = (320, 640), 24, 4
MEMORY_BATCHES, MEMORY_STEPS = (1, 2, 4), 2
# curve phase (manual): TRAINCURVE.md's run, CURVE_TRAIN + CURVE_TEST scenes,
# CURVE_EPOCHS epochs at batch CURVE_BATCH in bf16; GPU vs CPU on
# CURVE_CPU_SCENES TEST scenes
CURVE_TRAIN, CURVE_TEST, CURVE_EPOCHS, CURVE_BATCH, CURVE_CPU_SCENES = 1600, 40, 5, 4, 2
KITTI_HW = (375, 1242)  # a KITTI 2015 image, padded to 384x1248 by --submission
# kitti phase: `cmd_train --preset kitti` (batch KITTI_BATCH, bf16, KITTI_EPOCHS
# epochs, with and without remat, from `cli export` of phase 6's checkpoint)
# on a procedural kitti_mix of KITTI_TREE KITTI 2012 + KITTI_TREE KITTI 2015
# scenes at KITTI_TRAIN_HW (the JAX fine-tune leg's size), then `cli eval` on
# KITTI_VAL held-out KITTI 2015 scenes; each tree from its own seed
KITTI_TRAIN_HW, KITTI_TREE, KITTI_VAL, KITTI_BATCH, KITTI_EPOCHS = (376, 1248), 12, 4, 12, 3
KITTI_SEEDS = (("kitti2012", 1), ("kitti2015", 2), ("kitti2015", 3))  # kitti_mix's two trees, the held-out one
# the kitti and middlebury phases' legs over LEG_WORLD ranks that share the
# card under gloo (as phases 10 and 12): the kitti leg's `cmd_train` at the
# global batch of KITTI_BATCH for KITTI_LEG_EPOCHS epochs of the phase's
# kitti_mix (2 steps each), its parity batch the samples KITTI_LEG_INDICES
# (six KITTI 2012 crops, then six KITTI 2015 ones: one tree a rank); the
# middlebury leg's `cmd_train --n-disp-shards LEG_WORLD` for one epoch of
# the phase's MIDDLEBURY_TREE scenes
LEG_WORLD, KITTI_LEG_EPOCHS, LEG_TIMEOUT_S = 2, 2, 420
KITTI_LEG_INDICES = tuple(range(6)) + tuple(range(KITTI_TREE, KITTI_TREE + 6))
# the legs' float64 steps run on their parity batch cut to these crops (a
# float64 step at the presets' crops would not fit beside the f32 ones)
KITTI_LEG_F64_CROP = (64, 128)
# kitti12 and middlebury_step (manual): a preset's step alone for {f32, bf16} x
# {remat, none}, each in its own process, STEP_ALONE_WARMUP + STEP_ALONE_TIMED
# steps
STEP_ALONE_WARMUP, STEP_ALONE_TIMED, STEP_ALONE_TIMEOUT_S = 2, 5, 600
# phase 8's kitti case: its bf16 scalars (loss terms, EPE) on KITTI_PARITY_DRAWS
# procedural KITTI crops, within KITTI_PARITY_SCALAR_BOUND times the CPU's own
# bf16-vs-f32 distance, the largest over them: the card's and the CPU's bf16
# steps are two roundings of one f32 step, each about that far from it (the
# bound of the CPU tests against the JAX package; 1x failed on the EPE on the
# H100 with 1 and 3 crops, the gradient and BatchNorm statistics inside 1x)
KITTI_PARITY_DRAWS, KITTI_PARITY_SCALAR_BOUND = 3, 2.0
# finetune (manual): the curve, then the JAX fine-tune leg's run
# (TRAINCURVE.md): FINETUNE_TREE + FINETUNE_TREE scenes, FINETUNE_VAL held
# out, FINETUNE_EPOCHS epochs at batch FINETUNE_BATCH in bf16
FINETUNE_TREE, FINETUNE_VAL, FINETUNE_EPOCHS, FINETUNE_BATCH = 120, 24, 8, 4
# eval phase: a synthetic KITTI 2015 tree at KITTI_HW, the last pair's gt
# almost all at maxdisp, so that the per-image skip rule drops it
EVAL_PAIRS, EVAL_LIST = 6, ("000000_10.png", "000002_10.png", "000004_10.png")
# family phase: the registry's other models; timed forwards per model and
# dtype (GANet's SGA loop takes thousands of launches a forward), train
# steps per model on FAMILY_TRAIN_PAIRS pairs, pairs of its `cli eval`
FAMILY = ("dcanet-g", "gwcnet-g", "gwcnet-gc", "ganet")
FAMILY_ITERS = {"dcanet-g": 10, "gwcnet-g": 10, "gwcnet-gc": 10, "ganet": 5}
# family models whose bf16 eval is timed with the BatchNorm folded and literal
FAMILY_FOLD_AB = ("gwcnet-gc", "ganet")
FAMILY_HEAD = {"dcanet-g": "classif3", "gwcnet-g": "classif3", "gwcnet-gc": "classif3", "ganet": "classif_final"}
FAMILY_TRAIN, FAMILY_TRAIN_PAIRS, FAMILY_EVAL_PAIRS = ("gwcnet-gc", "ganet"), 4, 2
# extras phase: a stacked left+right pair at the submission shape; a CVA-sized
# volume (1/8 of 384x1248, D = 192 / 8); NonLocalAttention's 4,096 tokens
EXTRAS_HW, EXTRAS_VOLUME, EXTRAS_NONLOCAL = (384, 1248), (1, 32, 24, 48, 156), (1, 32, 8, 16, 32)
# parallel phase: 2 ranks under gloo on the one card, a global batch of 2
# (1 per rank) at the preset's 256x512 crop, PARALLEL_PAIRS synthetic pairs
# (2 steps an epoch), PARALLEL_EPOCHS epochs and a resumed one; the parity
# step's global batch; timed steps after warm-ups
PARALLEL_WORLD, PARALLEL_PAIRS, PARALLEL_EPOCHS = 2, 4, 2
PARALLEL_CROP, PARALLEL_WARMUP, PARALLEL_TIMED = (256, 512), 2, 5
PARALLEL_TIMEOUT_S = 300
# cards phase (opt-in, two or more cards): `cli train` on 1, 2, 4, ... cards,
# one process each, CARDS_STEPS steps at 1 pair per card; the first
# CARDS_WARMUP intervals between steps are not timed
CARDS_STEPS, CARDS_WARMUP, CARDS_TIMEOUT_S = 8, 2, 600
# its kitti leg: a kitti_mix of CARDS_KITTI_TREE + CARDS_KITTI_TREE scenes at
# 376x1248 (4 steps an epoch at batch 12), CARDS_KITTI_EPOCHS epochs; its
# middlebury leg: CARDS_MIDDLEBURY_EPOCHS epochs of MIDDLEBURY_TREE scenes
CARDS_KITTI_TREE, CARDS_KITTI_EPOCHS, CARDS_MIDDLEBURY_EPOCHS = 24, 2, 2
CARDS_EVAL_PAIRS = 8
# disp phase: `cli eval --dataset eth3d` (the 768x1024 canvas) over
# DISP_WORLD ranks under gloo on the one card against one process, on
# DISP_PAIRS synthetic scenes at an ETH3D image's size; one float64 forward
# at DISP_F64_HW
DISP_WORLD, DISP_PAIRS, ETH3D_HW, DISP_F64_HW = 2, 4, (490, 941), (256, 512)
DISP_TIMEOUT_S = 420
# disp_train phase: `cli train --n-disp-shards DISP_TRAIN_WORLD` under gloo on
# the one card, --batch-size 1 (both ranks load the same pair) on
# DISP_TRAIN_PAIRS synthetic pairs, DISP_TRAIN_EPOCHS epochs and a resumed
# one, against one process on the same tree; the parity step on phase 10's
# global batch of 2, whole on each rank
DISP_TRAIN_WORLD, DISP_TRAIN_PAIRS, DISP_TRAIN_EPOCHS = 2, 4, 2
DISP_TRAIN_TIMEOUT_S = 420
# middlebury phase: procedural trees of MIDDLEBURY_TREE + MIDDLEBURY_VAL
# (held out) full-resolution MiddEval3 frames and ETH3D_TREE ETH3D two-view
# frames, a seed each (BENCHMARK_SEEDS); `cmd_train --preset middlebury` in f32
# and bf16 for MIDDLEBURY_EPOCHS epochs, `--preset eth3d` in bf16 for one; the
# smooth-L1 parity step on MIDDLEBURY_PARITY_DRAWS Middlebury crops cut to
# MIDDLEBURY_PARITY_CROP (a CPU step at maxdisp 240 takes seconds there)
MIDDLEBURY_TREE, MIDDLEBURY_VAL, ETH3D_TREE, MIDDLEBURY_EPOCHS = 4, 2, 4, 2
BENCHMARK_SEEDS = (1, 2, 3)
MIDDLEBURY_PARITY_DRAWS, MIDDLEBURY_PARITY_CROP = 2, (64, 256)
# the card's f32 grad norm on each parity crop against the float64 step's,
# relative to its norm (`_float64_witness`; the card read 1.6e-3 on the first
# crop, PERF.md §6)
MIDDLEBURY_F32_GRAD_NORM_BOUND = 3e-3
# middlebury_step: `cmd_train --preset middlebury` at MiddEval3's training-set
# size (15 scenes), batch 1, for MIDDLEBURY_EPOCH_RUN epochs in f32 and bf16
MIDDLEBURY_EPOCH_SCENES, MIDDLEBURY_EPOCH_RUN, MIDDLEBURY_EPOCH_SEED = 15, 2, 4
# gwc features of `cli eval --preset middlebury`'s pair: a 1988x2880 frame
# halved to 994x1440 and replicate-padded to 1024x1472 (D = 60)
MIDDLEBURY_EVAL_FEATURES = (1, 320, 256, 368)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bn_counts() -> dict:
    """The train-mode BatchNorm kernels' launches and plain calls since the
    last `kernels/batchnorm.py::reset_launch_counts` (set just before a
    path runs)."""
    from dcanet_tpu_torch.kernels import batchnorm

    return dict(launches=batchnorm.LAUNCHES, plain_calls=batchnorm.PLAIN_CALLS)


def check_bn_counts(tag: str, counts: dict) -> dict:
    """`counts` (`bn_counts`) of a one-process train path on the card, which
    runs every train-mode BatchNorm on the kernels: some launches and no
    plain call."""
    if counts["launches"] <= 0 or counts["plain_calls"] != 0:
        raise AssertionError(f"[{tag}] train-mode BatchNorm: {counts['launches']} kernel launches and "
                             f"{counts['plain_calls']} plain calls; expected launches and no plain call")
    return counts


def time_cuda(fn, iters: int, warmup: int = 2, flush=None) -> float:
    """Median ms of `fn` over `iters` launches timed with CUDA events. With
    `flush` (a tensor larger than L2), it is overwritten before every launch
    so that each launch reads its inputs from device memory."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def gwc_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int, planes=None):
    """Least time for the gwc volume on an H100, or for its planes [d_lo,
    d_hi): each input read once, the planes written once; the products this
    input needs (w >= d only)."""
    b, c, h, w = shape
    d_lo, d_hi = planes or (0, maxdisp)
    bytes_moved = (2 * b * c * h * w + b * groups * (d_hi - d_lo) * h * w) * elem_bytes
    pairs = sum(w - d for d in range(d_lo, min(d_hi, w)))
    ops = 2 * b * c * h * pairs  # a multiply and an add per channel product
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from dcanet_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    log(f"[build] {len(report)} libraries in {time.perf_counter() - t0:.2f} s (one nvcc per kernel, the host "
        "compiler for the PNG decoder, all at once)")
    for name, r in report.items():
        log(f"[build] {name}: {r['seconds']:.2f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if any(k in line for k in ("entry function", "registers", "smem", "spill")):
                log(f"[build]   {line.strip()}")
    check_tensor_cores(report["conv3d"]["path"])


def check_tensor_cores(lib_path: str) -> None:
    """The conv3d library's SASS (cuobjdump): HMMA instructions per kernel;
    raises unless the library holds only the f32 (3xTF32) and the bf16
    kernels, every HMMA of the f32 ones is TF32 and of the bf16 ones BF16,
    and each has some."""
    from dcanet_tpu_torch.kernels import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    hmma, first, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            hmma[fn] = []
        elif fn is not None and "HMMA" in line:
            hmma[fn].append(line.split("HMMA", 1)[1].split()[0])  # e.g. ".1684.F32.TF32"
            first.setdefault(fn, " ".join(line.split()))
    for fn, ops in hmma.items():
        log(f"[build] SASS {fn}: {len(ops)} HMMA {sorted(set(ops))}" + (f", first: {first[fn]}" if ops else ""))
    want = {"conv3d_tf32x3_kernel": ".TF32", "conv3d_bf16_kernel": ".BF16"}  # x2: with and without ReLU
    bad = []
    for fn, ops in hmma.items():
        types = [t for k, t in want.items() if k in fn]
        if len(types) != 1 or not ops or not all(op.endswith(types[0]) for op in ops):
            bad.append(fn)
    if bad or len(hmma) != 4:
        raise AssertionError(f"[build] conv3d SASS: expected 2 TF32 and 2 BF16 tensor-core kernels, got "
                             f"{ {fn: sorted(set(ops)) for fn, ops in hmma.items()} }")


def check_close(tag: str, got, want, atol: float, rtol: float) -> float:
    """max |got - want|; raises if any element lies outside atol + rtol*|want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"[kernels] {tag}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    err = (got.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum())
    max_err = float(err.max())
    log(f"[kernels] {tag}: max|err| {max_err:.3e} (atol {atol:.3g}, rtol {rtol:g}), {bad} elements outside")
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {tag}")
    return max_err


def gwc_backward_bound_ms(shape, groups: int, maxdisp: int, elem_bytes: int, planes=None):
    """Least time for the gwc backward, or for the backward of its planes
    [d_lo, d_hi): the entries w >= d of those planes' grad (the occluded
    w < d reach neither dL nor dR), L and R read once, dL and dR written
    once; a multiply-add per channel product this input needs, for dL and
    again for dR."""
    b, c, h, w = shape
    d_lo, d_hi = planes or (0, maxdisp)
    pairs = sum(w - d for d in range(d_lo, min(d_hi, w)))
    bytes_moved = (4 * b * c * h * w + b * groups * h * pairs) * elem_bytes
    ops = 2 * 2 * b * c * h * pairs
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def batch_norm_bound_ms(shape, elem_bytes: int, backward: bool = False) -> float:
    """Least time for a train-mode BatchNorm's forward (x read for the
    statistics, read again and y written: 3 passes) or backward (x and dy
    read for the sums, read again and dx written: 5 passes) on an H100; the
    statistics and parameters are C values."""
    return 1e3 * math.prod(shape) * elem_bytes * (5 if backward else 3) / HBM_BYTES_PER_S


def _batch_norm_plain_backward(x, w, b, g):
    """The plain version's backward alone: autograd through it, its forward
    made once."""
    import torch
    from dcanet_tpu_torch.kernels import batchnorm

    xr = x.detach().clone().requires_grad_()
    wr, br = w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    y = batchnorm.batch_norm_train_reference(xr, wr, br, torch.zeros_like(w), torch.ones_like(w), 0.1, 1e-5, False)
    return lambda: torch.autograd.grad(y, (xr, wr, br), g, retain_graph=True)


def phase_batch_norm(gen, flush) -> tuple:
    """The train-mode BatchNorm kernels against their plain version (f32:
    1e-5 of the largest value; bf16: one bf16 ulp of an f32 reference from
    the kernels' own statistics, on 1e-5 of the largest value; dgamma and
    dbeta 1e-4 relative L2 of float64), then each timed shape's forward and
    backward pair with CUDA events (L2 flushed before each launch) beside
    their byte bounds, the plain version and F.batch_norm's (`library_ms`),
    and each kernel's share of the pair from the profiler."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from dcanet_tpu_torch.kernels import batchnorm

    errs, timing = {}, {}
    for shape in BN_CHECKED:
        c, dims = shape[1], len(shape) - 2
        bshape = [1, -1] + [1] * dims
        n = math.prod(shape) // c
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.rand(c, generator=gen, device="cuda") + 0.5
            b = torch.randn(c, generator=gen, device="cuda") * 0.1
            rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
            y, mean, invstd = batchnorm.batch_norm_train_cuda(x, w, b, rm, rv, 0.1, 1e-5, True)
            dx, dw, db = batchnorm.batch_norm_train_backward_cuda(g, x, w, mean, invstd)
            xd = x.double().requires_grad_()
            w64, b64 = w.double().requires_grad_(), b.double().requires_grad_()
            y64 = batchnorm.batch_norm_train_reference(xd, w64, b64, rm.double(), rv.double(), 0.1, 1e-5, False)
            _, dw64, db64 = torch.autograd.grad(y64, (xd, w64, b64), g.double())
            torch.cuda.synchronize()
            name = f"{tuple(shape)} {tag}"
            if dtype == torch.float32:
                xr = x.clone().requires_grad_()
                yr = batchnorm.batch_norm_train_reference(xr, w, b, torch.zeros_like(rm), torch.ones_like(rv), 0.1,
                                                          1e-5, True)
                dxr, = torch.autograd.grad(yr, (xr,), g)
                tol = lambda ref: (1e-5 * float(ref.abs().max()), 0.0)  # noqa: E731
            else:
                xhat = (x.float() - mean.view(bshape)) * invstd.view(bshape)
                yr = xhat * w.view(bshape) + b.view(bshape)
                dxr = (g.float() - db.view(bshape) / n - xhat * (dw.view(bshape) / n)) * (w * invstd).view(bshape)
                tol = lambda ref: (1e-5 * float(ref.abs().max()), 2.0**-7)  # noqa: E731
                y, dx = y.float(), dx.float()
            errs[name] = max(check_close(f"batch norm {name} y", y, yr, *tol(yr)),
                             check_close(f"batch norm {name} dx", dx, dxr, *tol(dxr)))
            for part, got, want in (("dgamma", dw, dw64), ("dbeta", db, db64)):
                err, norm = float((got.double() - want).norm()), float(want.norm())
                if not err <= 1e-4 * norm:  # dgamma is 0 with one value per channel
                    raise AssertionError(f"[kernels] batch norm {name} {part}: {err:.3e} from float64, whose norm is "
                                         f"{norm:.3e} (relative L2 limit 1e-4)")
            del x, g, y, dx, xd, y64, yr, dxr
    torch.cuda.empty_cache()

    names = ("bn_stats_kernel", "bn_normalize_kernel", "bn_backward_reduce_kernel", "bn_backward_kernel")
    for shape_tag, shape in BN_TIMED:
        c = shape[1]
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w, b = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
            rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
            _, mean, invstd = batchnorm.batch_norm_train_cuda(x, w, b, rm, rv, 0.1, 1e-5, True)
            fwd = lambda: batchnorm.batch_norm_train_cuda(x, w, b, rm, rv, 0.1, 1e-5, True)  # noqa: E731
            bwd = lambda: batchnorm.batch_norm_train_backward_cuda(g, x, w, mean, invstd)  # noqa: E731
            entry = {}
            for part, fn, plain, library, backward in (
                ("forward", fwd, lambda: batchnorm.batch_norm_train_reference(x, w, b, rm, rv, 0.1, 1e-5, True),
                 lambda: F.batch_norm(x, None, None, w, b, True, 0.0, 1e-5), False),
                ("backward", bwd, _batch_norm_plain_backward(x, w, b, g),
                 lambda: torch.ops.aten.native_batch_norm_backward(g, x, w, None, None, mean, invstd, True, 1e-5,
                                                                   [True, True, True]), True)):
                ms = time_cuda(fn, 20, flush=flush)
                plain_ms = time_cuda(plain, 5, flush=flush)
                library_ms = time_cuda(library, 10, flush=flush)
                bound = batch_norm_bound_ms(shape, x.element_size(), backward)
                entry[part] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=library_ms)
                log(f"[kernels] batch norm {part} {shape_tag} {tag} x{tuple(shape)}: kernels {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, F.batch_norm {library_ms:.4f} ms, kernels / F.batch_norm "
                    f"{ms / library_ms:.3f}, bound {bound:.4f} ms (bytes), {bound / ms:.1%} of bound (cold L2)")
            # each kernel's own device time (the profiler's), the L2 flushed
            # before each pair, beside its share of the bytes (stats 1 pass,
            # normalize 2, backward reduce 2, backward 3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush.zero_()
                    fwd()
                    flush.zero_()
                    bwd()
                torch.cuda.synchronize()
            per = {k: [] for k in names}
            for ev in prof.events():
                for k in names:
                    if ev.device_type == torch.autograd.DeviceType.CUDA and f"{k}<" in ev.name:
                        per[k].append((ev.time_range.end - ev.time_range.start) / 1e3)
            one = batch_norm_bound_ms(shape, x.element_size()) / 3
            for k, passes in zip(names, (1, 2, 2, 3)):
                kms = statistics.median(per[k]) if per[k] else float("nan")
                entry[k] = dict(ms=kms, bound_ms=one * passes)
                log(f"[kernels] batch norm {k} {shape_tag} {tag}: {kms:.4f} ms, bound {one * passes:.4f} ms, "
                    f"{one * passes / kms:.1%} of bound (profiler, cold L2)")
            timing[f"{shape_tag} {tag}"] = entry
            del x, g
    torch.cuda.empty_cache()
    return errs, timing


def conv3d_bound_ms(x_shape, co: int, elem_bytes: int, fma: bool = False):
    """Least time for a 3x3x3 conv: x and the weight read once, the output
    written once; 2*27*C*Co operations per output point at the dense
    tensor-core rate, for f32 three TF32 passes (3xTF32, the f32 kernel's
    arithmetic), or with `fma` at the f32 rate outside the tensor cores."""
    b, c, d, h, w = x_shape
    n = b * d * h * w
    bytes_moved = (n * (c + co) + 27 * c * co) * elem_bytes
    ops = 2 * 27 * c * co * n
    if elem_bytes == 2:
        peak = BF16_TC_FLOPS
    else:
        peak = F32_FLOPS if fma else TF32_TC_FLOPS / 3
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_tf32(x, w, flush) -> dict:
    """For context only: F.conv3d on f32 with TF32 on (cuDNN's default), its
    time and its error against the plain version, which misses the f32
    tolerance 1e-5 * max(1, max|ref|); TF32 is off again afterwards."""
    import torch
    import torch.nn.functional as F

    from dcanet_tpu_torch.kernels import conv3d as cv

    torch.backends.cudnn.allow_tf32 = True
    try:
        ms = time_cuda(lambda: F.conv3d(x, w, padding=1), 10, flush=flush)
        got = F.conv3d(x, w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    want = cv.conv3d_reference(x, w)
    err = float((got - want).abs().max())
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    log(f"[kernels] context: F.conv3d f32 with TF32 on x{tuple(x.shape)}: {ms:.4f} ms, max|err| vs plain "
        f"{err:.3e}, {err / atol:.1f}x the f32 tolerance {atol:.3g}")
    return dict(ms=ms, max_abs_err=err, tolerance=atol)


def _gwc_backward_plain(left, right, grad, d, groups, planes=None):
    """The plain backward's graph, built once: autograd through the plain
    forward (of the planes `planes`); the returned closure runs its
    backward only."""
    import torch

    from dcanet_tpu_torch.kernels import gwc

    l, r = left.detach().requires_grad_(), right.detach().requires_grad_()
    vol = gwc.gwc_volume_reference(l, r, d, groups, planes)
    if not vol.requires_grad:  # every plane past W: the plain backward's zeros
        return lambda: gwc.gwc_volume_backward_reference(grad, left, right, d, groups, planes)
    return lambda: torch.autograd.grad(vol, (l, r), grad, retain_graph=True)


def _range_grad_shape(shape, groups: int, planes) -> tuple:
    """The grad of the planes [d_lo, d_hi) of a gwc volume of `shape` features."""
    b, _, h, w = shape
    return (b, groups, planes[1] - planes[0], h, w)


def occluded_nan(grad, d_lo: int = 0):
    """`grad` (B, G, D, H, W) of the planes from d_lo on, NaN at the occluded
    entries w < d."""
    import torch

    d = d_lo + torch.arange(grad.shape[2], device=grad.device)[:, None, None]
    w = torch.arange(grad.shape[4], device=grad.device)
    return torch.where(w < d, torch.full((), float("nan"), dtype=grad.dtype, device=grad.device), grad)


def phase_kernels():
    """Each kernel vs its plain version; returns the numbers for the kernels line."""
    import torch
    import torch.nn.functional as F

    from dcanet_tpu_torch.kernels import conv3d as cv
    from dcanet_tpu_torch.kernels import gwc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    # gwc, f32: the kernel and the plain version differ only in summation
    # order. bf16: both sum in f32 and round once to bf16, so they differ by
    # at most one bf16 ulp (2^-7 relative).
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}
    cases = [
        ("main f32", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("main bf16", MAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("kitti eval f32", KITTI_EVAL_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("kitti eval bf16", KITTI_EVAL_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train f32", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train bf16", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b4 f32", TRAIN_B4_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b4 bf16", TRAIN_B4_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b12 f32", TRAIN_B12_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b12 bf16", TRAIN_B12_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b6 f32", TRAIN_B6_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b6 bf16", TRAIN_B6_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b3 f32", TRAIN_B3_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b3 bf16", TRAIN_B3_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("D=60 f32", MAIN_SHAPE, MAIN_GROUPS, 60, torch.float32),
        ("D=60 bf16", MAIN_SHAPE, MAIN_GROUPS, 60, torch.bfloat16),
        # the middlebury phase's: its train crop and its eval pair, D = 60
        ("middlebury train f32", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.float32),
        ("middlebury train bf16", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.bfloat16),
        ("middlebury eval f32", MIDDLEBURY_EVAL_FEATURES, MAIN_GROUPS, MIDDLEBURY_D, torch.float32),
        ("middlebury eval bf16", MIDDLEBURY_EVAL_FEATURES, MAIN_GROUPS, MIDDLEBURY_D, torch.bfloat16),
        ("D>W f32", (2, 16, 5, 7), 4, 12, torch.float32),
        ("D>W bf16", (2, 16, 5, 7), 4, 12, torch.bfloat16),
        # the forward kernel's edges: odd W (scalar loads and stores), one
        # channel per group with D > its 128-column tile (three passes over
        # d), 32 channels per group with W % 8 != 0 on two tiles
        ("odd W f32", (1, 16, 5, 45), 4, 60, torch.float32),
        ("odd W bf16", (1, 16, 5, 45), 4, 60, torch.bfloat16),
        ("CPG=1 f32", (2, 8, 2, 150), 8, 140, torch.float32),
        ("CPG=1 bf16", (2, 8, 2, 150), 8, 140, torch.bfloat16),
        ("CPG=32 f32", (1, 64, 3, 130), 2, 48, torch.float32),
        ("CPG=32 bf16", (1, 64, 3, 130), 2, 48, torch.bfloat16),
    ]
    errs = {}
    for name, shape, groups, d, dtype in cases:
        left, right = randn(shape, dtype), randn(shape, dtype)
        got = gwc.gwc_volume_cuda(left, right, d, groups)
        want = gwc.gwc_volume_reference(left, right, d, groups)
        torch.cuda.synchronize()
        errs[name] = check_close(f"gwc {name} {tuple(shape)} G={groups} D={d}", got, want, *tol[dtype])
        del left, right, got, want
    # plane ranges against the plain version's slices of the whole volume
    for name, shape, groups, d, planes in GWC_RANGES:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            left, right = randn(shape, dtype), randn(shape, dtype)
            got = gwc.gwc_volume_cuda(left, right, d, groups, planes)
            want = gwc.gwc_volume_reference(left, right, d, groups)
            lo, hi = planes or (0, d)
            torch.cuda.synchronize()
            errs[f"{name} {tag}"] = check_close(f"gwc range {name} {tag} {tuple(shape)} D={d}", got,
                                                want[:, :, lo:hi].contiguous(), *tol[dtype])
            del left, right, got, want
    torch.cuda.empty_cache()

    # gwc backward against autograd through the plain version, grad at unit
    # scale. f32: sums of up to D products (no mean over the channels where
    # one channel makes a group) in another order, so the tolerance scales
    # with the output's magnitude as conv3d's does: 1e-5 * max(1, max|ref|);
    # bf16: one ulp on top, both round once from f32.
    def bwd_tol(dtype, ref):
        return 1e-5 * max(1.0, float(ref.float().abs().max())), tol[dtype][1]

    bwd_cases = [
        ("train f32", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train bf16", TRAIN_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b4 f32", TRAIN_B4_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b4 bf16", TRAIN_B4_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("D>W f32", (2, 16, 5, 7), 4, 12, torch.float32),
        ("D>W bf16", (2, 16, 5, 7), 4, 12, torch.bfloat16),
        # the backward kernel's edges: odd W (scalar loads and stores), one
        # channel per group with D = 140 > its 64-disparity pass (three
        # passes, the later ones staged once for dL and once for dR), 32
        # channels per group on two ragged tiles and on one full 128-column
        # tile (f32: one thread per set of sums, 512 threads), 2 and 16
        # channels per group; the Middlebury train shape (three tiles of 64,
        # D = 60) and the KITTI preset's batch of 12
        ("odd W f32", (1, 16, 5, 45), 4, 60, torch.float32),
        ("odd W bf16", (1, 16, 5, 45), 4, 60, torch.bfloat16),
        ("CPG=1 f32", (2, 8, 2, 150), 8, 140, torch.float32),
        ("CPG=1 bf16", (2, 8, 2, 150), 8, 140, torch.bfloat16),
        ("CPG=32 f32", (1, 64, 3, 130), 2, 48, torch.float32),
        ("CPG=32 bf16", (1, 64, 3, 130), 2, 48, torch.bfloat16),
        ("CPG=32 W=128 f32", (1, 64, 3, 128), 2, 48, torch.float32),
        ("CPG=32 W=128 bf16", (1, 64, 3, 128), 2, 48, torch.bfloat16),
        ("CPG=2 f32", (2, 8, 3, 100), 4, 48, torch.float32),
        ("CPG=2 bf16", (2, 8, 3, 100), 4, 48, torch.bfloat16),
        ("CPG=16 f32", (1, 32, 3, 256), 2, 48, torch.float32),
        ("CPG=16 bf16", (1, 32, 3, 256), 2, 48, torch.bfloat16),
        ("middlebury f32", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.float32),
        ("middlebury bf16", MIDDLEBURY_SHAPE, MAIN_GROUPS, MIDDLEBURY_D, torch.bfloat16),
        ("train b12 f32", TRAIN_B12_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b12 bf16", TRAIN_B12_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b6 f32", TRAIN_B6_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b6 bf16", TRAIN_B6_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
        ("train b3 f32", TRAIN_B3_SHAPE, MAIN_GROUPS, MAIN_D, torch.float32),
        ("train b3 bf16", TRAIN_B3_SHAPE, MAIN_GROUPS, MAIN_D, torch.bfloat16),
    ]
    bwd_errs = {}
    for name, shape, groups, d, dtype in bwd_cases:
        b, c, h, w = shape
        left, right = randn(shape, dtype), randn(shape, dtype)
        grad = randn((b, groups, d, h, w), dtype)
        got = gwc.gwc_volume_backward_cuda(grad, left, right, d, groups)
        want = gwc.gwc_volume_backward_reference(grad, left, right, d, groups)
        torch.cuda.synchronize()
        bwd_errs[name] = max(
            check_close(f"gwc backward {name} {tuple(shape)} G={groups} D={d} {part}", g_, w_, *bwd_tol(dtype, w_))
            for part, g_, w_ in (("dL", got[0], want[0]), ("dR", got[1], want[1]))
        )
        del left, right, grad, got, want
    # the shared memory each backward range asks for per block, against
    # what the card lets a block opt in to (kernels/gwc.py reports both when
    # a launch fails)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    lib = gwc._lib()
    for name, shape, groups, d, planes in GWC_BWD_RANGES:
        for dtype_bytes, tag in ((4, "f32"), (2, "bf16")):
            smem = lib.gwc_volume_backward_smem_bytes(shape[1], shape[3], groups, planes[1] - planes[0], planes[0],
                                                      dtype_bytes)
            if not 0 < smem <= limit:
                raise AssertionError(f"[kernels] gwc backward range {name} {tag}: {smem} bytes of shared memory a "
                                     f"block, the card allows {limit}")
    log(f"[kernels] gwc backward ranges: shared memory a block " + ", ".join(
        f"{name} {lib.gwc_volume_backward_smem_bytes(shape[1], shape[3], groups, p[1] - p[0], p[0], 4)} / "
        f"{lib.gwc_volume_backward_smem_bytes(shape[1], shape[3], groups, p[1] - p[0], p[0], 2)}"
        for name, shape, groups, d, p in GWC_BWD_RANGES) + f" bytes (f32 / bf16), the card allows {limit}")
    # the backward of plane ranges against autograd through the plain
    # version's planes, the grad NaN at the occluded entries w < d (which
    # must reach neither dL nor dR), the tolerances as above
    for name, shape, groups, d, planes in GWC_BWD_RANGES:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            left, right = randn(shape, dtype), randn(shape, dtype)
            grad = occluded_nan(randn(_range_grad_shape(shape, groups, planes), dtype), planes[0])
            got = gwc.gwc_volume_backward_cuda(grad, left, right, d, groups, planes)
            want = gwc.gwc_volume_backward_reference(grad, left, right, d, groups, planes)
            torch.cuda.synchronize()
            bwd_errs[f"{name} {tag}"] = max(
                check_close(f"gwc backward range {name} {tag} {tuple(shape)} G={groups} D={d} {part}", g_, w_,
                            *bwd_tol(dtype, w_))
                for part, g_, w_ in (("dL", got[0], want[0]), ("dR", got[1], want[1]))
            )
            del left, right, grad, got, want
    torch.cuda.empty_cache()

    # conv3d forward. f32: 27*C products summed in another order, so the
    # tolerance scales with the output's magnitude: 1e-5 * max(1, max|ref|).
    # bf16: both sum in f32 and round once, so one bf16 ulp (2^-7 relative)
    # on top of that.
    def conv_tol(dtype, ref):
        scale = max(1.0, float(ref.float().abs().max()))
        return 1e-5 * scale, (0.0 if dtype == torch.float32 else 2.0**-7)

    conv_cases = [
        ("32->32 f32", CONV_SHAPE, 32, torch.float32, False),
        ("32->32 f32 scale+bias+relu", CONV_SHAPE, 32, torch.float32, True),
        ("32->32 bf16 scale+bias+relu", CONV_SHAPE, 32, torch.bfloat16, True),
        ("64->32 f32 scale+bias+relu", CONV_SHAPE_64, 32, torch.float32, True),
        ("64->32 bf16", CONV_SHAPE_64, 32, torch.bfloat16, False),
        ("ragged f32 scale+bias+relu", (2, 5, 3, 9, 33), 40, torch.float32, True),
        ("ragged bf16", (2, 5, 3, 9, 33), 40, torch.bfloat16, False),
        # the f32 (3xTF32) kernel's edges: ragged H and W (W % 4 != 0: scalar
        # stores), D = 1, two Co tiles, C not a multiple of its 8-channel step
        ("H=7 W=45 f32 scale+bias+relu", (1, 32, 2, 7, 45), 32, torch.float32, True),
        ("D=1 f32", (2, 32, 1, 9, 72), 32, torch.float32, False),
        ("64->64 f32 scale+bias+relu", (1, 64, 6, 20, 72), 64, torch.float32, True),
        ("C=12 f32", (1, 12, 4, 10, 40), 32, torch.float32, False),
        ("C=5 f32 scale+bias+relu", (1, 5, 2, 5, 9), 40, torch.float32, True),
        # the bf16 tensor-core kernel's edges: two Co tiles, C not a multiple
        # of its 16-channel step, W not a multiple of 8 (scalar stores) with a
        # ragged H, and D = 1
        ("64->64 bf16 scale+bias+relu", (1, 64, 6, 20, 72), 64, torch.bfloat16, True),
        ("C=24 bf16", (1, 24, 4, 10, 40), 32, torch.bfloat16, False),
        ("W=33 bf16 scale+bias+relu", (1, 32, 3, 10, 33), 32, torch.bfloat16, True),
        ("D=1 bf16", (2, 32, 1, 12, 64), 32, torch.bfloat16, False),
    ]
    conv_errs = {}
    for name, xs, co, dtype, affine in conv_cases:
        x = randn(xs, dtype)
        w = randn((co, xs[1], 3, 3, 3), dtype, 0.1)
        sc = (torch.rand(co, generator=gen, device="cuda") + 0.5) if affine else None
        bi = randn((co,), torch.float32, 0.1) if affine else None
        got = cv.conv3d_cuda(x, w, sc, bi, relu=affine)
        want = cv.conv3d_reference(x, w, sc, bi, relu=affine)
        torch.cuda.synchronize()
        conv_errs[name] = check_close(f"conv3d {name} x{tuple(xs)}", got, want, *conv_tol(dtype, want))
        del x, got, want

    # conv3d_fast backward (ReLU) against autograd through the plain conv,
    # both given the grad masked by the kernel's own y > 0 (the plain
    # output's sign differs where |y| is within rounding of 0, and a flipped
    # mask moves dx by a whole tap): dx is the kernel (tolerance as the
    # forward); dw is the library's wgrad, summed over every output point in
    # another order (1e-4 of max|dw| in f32, 1e-2 in bf16, which may round
    # partial sums).
    bwd_conv_errs = {}
    for name, xs, dtype in (("32->32 f32", CONV_SHAPE, torch.float32), ("32->32 bf16", CONV_SHAPE, torch.bfloat16),
                            ("64->32 f32", CONV_SHAPE_64, torch.float32), ("64->32 bf16", CONV_SHAPE_64, torch.bfloat16)):
        x = randn(xs, dtype).requires_grad_()
        w = randn((32, xs[1], 3, 3, 3), dtype, 0.1).requires_grad_()
        y = cv.conv3d_fast(x, w, True)
        g = randn(y.shape, dtype)
        dx, dw = torch.autograd.grad(y, (x, w), g)
        xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
        gm = torch.where(y.detach() > 0, g, torch.zeros((), dtype=dtype, device="cuda"))
        dxr, dwr = torch.autograd.grad(cv.conv3d_reference(xr, wr), (xr, wr), gm)
        torch.cuda.synchronize()
        dw_scale = float(dwr.float().abs().max())
        bwd_conv_errs[name] = check_close(f"conv3d_fast backward {name} dx", dx, dxr, *conv_tol(dtype, dxr))
        check_close(f"conv3d_fast backward {name} dw (library wgrad)", dw, dwr,
                    (1e-4 if dtype == torch.float32 else 1e-2) * dw_scale, 0.0)
        del x, w, y, g, gm, dx, dw, xr, wr, dxr, dwr
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB > 50 MB L2
    bn_errs, bn_timing = phase_batch_norm(gen, flush)
    timing = {"gwc": {}, "gwc_bwd": {}, "gwc_bwd_range": {}, "conv3d": {}, "batchnorm": bn_timing}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        left, right = randn(MAIN_SHAPE, dtype), randn(MAIN_SHAPE, dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, MAIN_D, MAIN_GROUPS), 5, flush=flush)
        bound_ms, bound_by = gwc_bound_ms(MAIN_SHAPE, MAIN_GROUPS, MAIN_D, left.element_size())
        timing["gwc"][tag] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log(f"[kernels] gwc main {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")

        for shape_tag, xs, d in (("train", TRAIN_SHAPE, MAIN_D), ("kitti eval", KITTI_EVAL_SHAPE, MAIN_D),
                                 ("train b4", TRAIN_B4_SHAPE, MAIN_D), ("train b12", TRAIN_B12_SHAPE, MAIN_D),
                                 ("train b6", TRAIN_B6_SHAPE, MAIN_D), ("train b3", TRAIN_B3_SHAPE, MAIN_D),
                                 ("middlebury train", MIDDLEBURY_SHAPE, MIDDLEBURY_D),
                                 ("middlebury eval", MIDDLEBURY_EVAL_FEATURES, MIDDLEBURY_D)):
            left, right = randn(xs, dtype), randn(xs, dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, d, MAIN_GROUPS), 20, flush=flush)
            plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, d, MAIN_GROUPS), 5, flush=flush)
            bound_ms, bound_by = gwc_bound_ms(xs, MAIN_GROUPS, d, left.element_size())
            timing["gwc"][f"{shape_tag} {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                                       library_ms=None)
            log(f"[kernels] gwc {shape_tag} {tag} x{tuple(xs)} D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")
        for shape_tag, xs, d in (("train", TRAIN_SHAPE, MAIN_D), ("middlebury", MIDDLEBURY_SHAPE, MIDDLEBURY_D),
                                 ("train b4", TRAIN_B4_SHAPE, MAIN_D), ("train b12", TRAIN_B12_SHAPE, MAIN_D),
                                 ("train b6", TRAIN_B6_SHAPE, MAIN_D), ("train b3", TRAIN_B3_SHAPE, MAIN_D)):
            b, c, h, w = xs
            left, right = randn(xs, dtype), randn(xs, dtype)
            grad = randn((b, MAIN_GROUPS, d, h, w), dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_backward_cuda(grad, left, right, d, MAIN_GROUPS), 20, flush=flush)
            plain_ms = time_cuda(_gwc_backward_plain(left, right, grad, d, MAIN_GROUPS), 5, flush=flush)
            bound_ms, bound_by = gwc_backward_bound_ms(xs, MAIN_GROUPS, d, left.element_size())
            key = tag if shape_tag == "train" else f"{shape_tag} {tag}"
            timing["gwc_bwd"][key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                          library_ms=None)
            log(f"[kernels] gwc backward {shape_tag} {tag} x{tuple(xs)} D={d}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")

        for shape_tag, xs in (("32->32", CONV_SHAPE), ("64->32", CONV_SHAPE_64)):
            x = randn(xs, dtype)
            w = randn((32, xs[1], 3, 3, 3), dtype, 0.1)
            ms = time_cuda(lambda: cv.conv3d_cuda(x, w), 10, flush=flush)
            plain_ms = time_cuda(lambda: cv.conv3d_reference(x, w), 3, flush=flush)
            library_ms = time_cuda(lambda: F.conv3d(x, w, padding=1), 10, flush=flush)
            bound_ms, bound_by = conv3d_bound_ms(xs, 32, x.element_size())
            entry = timing["conv3d"][f"{shape_tag} {tag}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            extra = ""
            if dtype == torch.float32:
                entry["fma_bound_ms"] = conv3d_bound_ms(xs, 32, 4, fma=True)[0]
                extra = (f" (3xTF32 on the tensor cores; the FMA bound {entry['fma_bound_ms']:.4f} ms, "
                         f"{entry['fma_bound_ms'] / ms:.1%})")
            log(f"[kernels] conv3d {shape_tag} {tag} x{tuple(xs)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.conv3d {library_ms:.4f} ms, kernel / F.conv3d {ms / library_ms:.3f}, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.1%} of bound{extra} (cold L2)")
            if dtype == torch.float32:
                entry["library_tf32"] = library_tf32(x, w, flush)
            del x, w
    # the plane ranges' times beside their bounds (the disparity-sharded eval's
    # and train step's launches), the whole ETH3D volume beside them
    for name, shape, groups, d, planes in GWC_TIMED_RANGES:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            left, right = randn(shape, dtype), randn(shape, dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, d, groups, planes), 20, flush=flush)
            plain_ms = time_cuda(lambda: gwc.gwc_volume_reference(left, right, d, groups, planes), 5, flush=flush)
            bound_ms, bound_by = gwc_bound_ms(shape, groups, d, left.element_size(), planes)
            timing["gwc"][f"{name} {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                                   library_ms=None)
            log(f"[kernels] gwc range {name} {tag} x{tuple(shape)} D={d}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")
            del left, right
    # the backward's plane ranges (the disparity-sharded train step's
    # launches) beside their bounds
    for name, shape, groups, d, planes in GWC_BWD_RANGES:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            left, right = randn(shape, dtype), randn(shape, dtype)
            grad = randn(_range_grad_shape(shape, groups, planes), dtype)
            ms = time_cuda(lambda: gwc.gwc_volume_backward_cuda(grad, left, right, d, groups, planes), 20,
                           flush=flush)
            plain_ms = time_cuda(_gwc_backward_plain(left, right, grad, d, groups, planes), 5, flush=flush)
            bound_ms, bound_by = gwc_backward_bound_ms(shape, groups, d, left.element_size(), planes)
            timing["gwc_bwd_range"][f"{name} {tag}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                            bound_by=bound_by, library_ms=None)
            log(f"[kernels] gwc backward range {name} {tag} x{tuple(shape)} D={d}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound (cold L2)")
            del left, right, grad
    # the gwc forward at the main shape once more, after everything else: the
    # first f32 timing above has read up to ~15 % above later ones in the
    # same process (not the clock, fresh memory or the host: PERF.md §7)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        left, right = randn(MAIN_SHAPE, dtype), randn(MAIN_SHAPE, dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_cuda(left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        timing["gwc"][tag]["ms_retimed"] = ms
        log(f"[kernels] gwc main {tag} retimed: kernel {ms:.4f} ms, {timing['gwc'][tag]['bound_ms'] / ms:.1%} of bound")
        # and the backward at the train shape, for the same reason
        b, c, h, w = TRAIN_SHAPE
        left, right = randn(TRAIN_SHAPE, dtype), randn(TRAIN_SHAPE, dtype)
        grad = randn((b, MAIN_GROUPS, MAIN_D, h, w), dtype)
        ms = time_cuda(lambda: gwc.gwc_volume_backward_cuda(grad, left, right, MAIN_D, MAIN_GROUPS), 20, flush=flush)
        timing["gwc_bwd"][tag]["ms_retimed"] = ms
        log(f"[kernels] gwc backward train {tag} retimed: kernel {ms:.4f} ms, "
            f"{timing['gwc_bwd'][tag]['bound_ms'] / ms:.1%} of bound")
    del flush
    torch.cuda.empty_cache()
    return dict(gwc=errs, gwc_bwd=bwd_errs, conv3d=conv_errs, conv3d_bwd=bwd_conv_errs, batchnorm=bn_errs), timing


# io phase: the native PNG decoder at KITTI's and MiddEval3's sizes
IO_SEED = 11
IO_FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4, "mixed": None}
IO_MIDDLEBURY_HW = (1988, 2880)
IO_POOL_IMAGES, IO_POOL_THREADS = 24, 8  # one KITTI batch's images on the loader's decode pool


def _idat(png: bytes) -> bytes:
    """A PNG's IDAT payloads, joined: what zlib inflates."""
    import struct

    parts, pos = [], 8
    while pos < len(png):
        n, ctype = struct.unpack(">I4s", png[pos : pos + 8])
        if ctype == b"IDAT":
            parts.append(png[pos + 8 : pos + 8 + n])
        pos += 12 + n
    return b"".join(parts)


def _host_ms(fn, runs: int) -> float:
    """Median host-clock ms of `fn` over `runs` calls after one more."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_io(workdir: Path) -> dict:
    """The native PNG decoder (`data/native.py` over `csrc/stereoio.cpp`),
    host code that the loader runs on the card's host: exact against the
    plain numpy reader (`data/io.py::read_png`) and the written pixels, on a
    procedural KITTI scene at 376x1248 (RGB, and its uint16 sparse gt) with
    each filter type on every row and with the writer's own choice per row
    (libpng's heuristic), and on the scene upsampled to MiddEval3's
    1988x2880 (the writer's choice; no plain read there, ~12 s a file); single-thread
    ms/image of the native decoder, the plain reader and zlib's inflate of
    the IDAT alone (the floor); `read_image` of IO_POOL_IMAGES KITTI images
    (12 procedural scenes, left and right) serially and on an
    IO_POOL_THREADS-thread pool (the loader's decode pool), beside one image
    alone. Host clock, medians; the card's name and power limit and the
    host's usable CPU count beside them."""
    import concurrent.futures
    import zlib

    from dcanet_tpu_torch.data import io, native
    from dcanet_tpu_torch.data.synthetic import (_resize_bilinear, kitti_sparse_gt, procedural_scene,
                                                 write_procedural_kitti_tree)

    t_phase = time.perf_counter()
    cpus = len(os.sched_getaffinity(0))
    h, w = KITTI_TRAIN_HW
    left, _, disp = procedural_scene(IO_SEED, h, w)
    images = {"rgb": left, "gt16": kitti_sparse_gt(disp, IO_SEED)}
    out: dict = {"card": gpu_line(), "cpus": cpus, "kitti_hw": [h, w], "files": {}}
    for kind, img in images.items():
        for name, f in IO_FILTERS.items():
            png = io._encode_png(img, None if f is None else np.full(h, f))
            path = workdir / f"io_{kind}_{name}.png"
            path.write_bytes(png)
            got = native.read_image_f32(path)
            if not (np.array_equal(got, io.read_png(path).astype(np.float32))
                    and np.array_equal(got, img.astype(np.float32))):
                raise RuntimeError(f"[io] native decode of {path.name} differs from the plain reader's or the pixels")
            row = {"bytes": len(png), "native_ms": _host_ms(lambda: native.read_image_f32(path), 5),
                   "inflate_ms": _host_ms(lambda: zlib.decompress(_idat(png)), 5)}
            if kind == "rgb":
                row["plain_ms"] = _host_ms(lambda: io.read_png(path), 3 if f in (0, 1, 2) else 1)
            out["files"][f"{kind} {name}"] = row
            log(f"[io] {kind} {h}x{w} {name}: exact; native {row['native_ms']:.3f} ms, "
                f"inflate alone {row['inflate_ms']:.3f}" + (f", plain {row['plain_ms']:.3f}" if "plain_ms" in row
                                                            else "") + f" ({len(png)} B)")
    mh, mw = IO_MIDDLEBURY_HW
    # the KITTI scene upsampled: a procedural scene of this size takes ~14 s to draw
    big = np.clip(np.rint(_resize_bilinear(left.astype(np.float32), mh, mw)), 0, 255).astype(np.uint8)
    path = workdir / "io_middlebury.png"
    t0 = time.perf_counter()
    io.write_png(path, big)
    write_s = time.perf_counter() - t0
    if not np.array_equal(native.read_image_f32(path), big.astype(np.float32)):
        raise RuntimeError("[io] native decode of the 1988x2880 file differs from the written pixels")
    png = path.read_bytes()
    out["middlebury"] = {"hw": [mh, mw], "bytes": len(png), "write_s": write_s,
                         "native_ms": _host_ms(lambda: native.read_image_f32(path), 3),
                         "inflate_ms": _host_ms(lambda: zlib.decompress(_idat(png)), 3)}
    log(f"[io] rgb {mh}x{mw} mixed: exact; native {out['middlebury']['native_ms']:.3f} ms, inflate alone "
        f"{out['middlebury']['inflate_ms']:.3f} ({len(png)} B; written in {write_s:.2f} s)")
    t0 = time.perf_counter()
    root = write_procedural_kitti_tree(workdir / "io_kitti", "kitti2015", IO_POOL_IMAGES // 2, KITTI_TRAIN_HW,
                                       seed=IO_SEED)
    tree_s = time.perf_counter() - t0
    paths = sorted(root.glob("image_[23]/*.png"))
    with concurrent.futures.ThreadPoolExecutor(IO_POOL_THREADS) as pool:
        pooled = _host_ms(lambda: list(pool.map(io.read_image, paths)), 5)
    out["pool"] = {"images": len(paths), "threads": IO_POOL_THREADS, "tree_s": tree_s, "pool_ms": pooled,
                   "serial_ms": _host_ms(lambda: [io.read_image(p) for p in paths], 3),
                   "one_ms": _host_ms(lambda: io.read_image(paths[0]), 5)}
    pool_row = out["pool"]
    log(f"[io] read_image of {len(paths)} KITTI images (tree of {len(paths) // 2} scenes written in {tree_s:.1f} s): "
        f"{IO_POOL_THREADS} threads {pooled:.3f} ms, serial {pool_row['serial_ms']:.3f} ms, one image "
        f"{pool_row['one_ms']:.3f} ms ({pooled / pool_row['one_ms']:.2f}x one); {cpus} usable CPUs; {out['card']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[io] phase {out['seconds']:.1f} s")
    return out


def seeded_flax_variables(model, seed: int):
    """Flat flax variables for `model`, drawn with numpy: reference-init conv
    kernels (normal, std sqrt(2/fan_out)), BN affine and running statistics as
    the parity tests randomise them."""
    from dcanet_tpu_torch import weights

    rng = np.random.default_rng(seed)
    flat = {}
    for key, ref in weights.to_jax_variables(model.state_dict(), model).items():
        shape = ref.shape
        if key.endswith("/mean"):
            arr = rng.normal(0.0, 0.2, shape)
        elif key.endswith("/var") or key.endswith("/scale"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("/bias"):
            arr = rng.normal(0.0, 0.1, shape)
        else:
            fan_out = math.prod(shape[:-2]) * shape[-1]
            arr = rng.normal(0.0, math.sqrt(2.0 / fan_out), shape)
        flat[key] = arr.astype(np.float32)
    return flat


def synthetic_pair(seed: int):
    """A KITTI-sized textured stereo pair (uint8 RGB): the right image is the
    left one shifted by a disparity d that grows down the image,
    left[y, x] = right[y, x - d]."""
    rng = np.random.default_rng(seed)
    h, w = KITTI_HW
    pad = 96
    base = rng.integers(0, 256, size=(h // 4 + 1, (w + pad) // 4 + 1, 3)).astype(np.float32)
    tex = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)[:h, : w + pad]
    left = tex[:, :w]
    right = np.empty_like(left)
    for y in range(h):
        d = 8 + (80 * y) // h
        right[y] = tex[y, d : d + w]
    return left.astype(np.uint8), right.astype(np.uint8)


def profile_call(fn, tag: str, top: int = 6):
    """One profiled call of `fn`: the sum of kernel time against the call's
    wall time (the device's busy share), BatchNorm's kernels' share of it,
    and the kernels that take most. Returns {busy_ms, wall_ms, launches,
    bn_ms, bn_launches}, or None without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"[profile {tag}] the profiler recorded no device time")
        return None
    launches = sum(e.count for e in kernels)
    # PyTorch's, cuDNN's and the port's train-mode kernels (csrc/batchnorm.cu)
    bn = [e for e in kernels if any(k in e.key for k in ("batch_norm", "bn_fw", "bn_bw", "bn_stats", "bn_normalize",
                                                          "bn_backward"))]
    bn_ms = sum(e.self_device_time_total for e in bn) / 1e3
    bn_launches = sum(e.count for e in bn)
    log(f"[profile {tag}] kernels {busy_ms:.3f} ms of a {wall_ms:.3f} ms profiled call "
        f"(device busy {busy_ms / wall_ms:.1%}), {launches} kernel launches; BatchNorm kernels {bn_ms:.3f} ms "
        f"({bn_ms / busy_ms:.1%}), {bn_launches} launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[profile {tag}]   {ms:8.3f} ms {ms / busy_ms:6.1%} x{e.count:<4d} {e.key[:110]}")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, launches=launches, bn_ms=bn_ms, bn_launches=bn_launches)


@contextlib.contextmanager
def fold_eval_bn(enabled: bool):
    """DCANET_FOLD_EVAL_BN at "1" (the eval BatchNorm folded into its conv in
    bf16, the default) or "0" (literal) for the duration."""
    prev = os.environ.get("DCANET_FOLD_EVAL_BN")
    os.environ["DCANET_FOLD_EVAL_BN"] = "1" if enabled else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("DCANET_FOLD_EVAL_BN")
        else:
            os.environ["DCANET_FOLD_EVAL_BN"] = prev


def batch_norm_forwards(model, fn):
    """fn()'s result, and the BatchNorm modules of `model` that ran in it
    outside Guidance (whose ResidualBlocks and `norm1` keep their BN in a
    folded eval, as in the JAX package), and the count of all BN forwards."""
    from torch import nn

    ran, total = set(), [0]

    def hook(name):
        def count(*_):
            total[0] += 1
            if not name.startswith("guidance."):
                ran.add(name)
        return count

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, ran, total[0]


# ops whose dtype bf16 autocast may decide on the eval path
# (dcanet_tpu_torch/ops/precision.py, rule (c)): the convolutions and
# transposed convolutions, matmuls and einsums, which both devices run in
# bf16, and `cat` / `stack`, which promote as they do without autocast
AUTOCAST_DECIDES = ("aten.convolution.default", "aten.bmm.default", "aten.mm.default", "aten.cat.default",
                    "aten.stack.default")
# the batch norm kernel's name depends on the device (Guidance's literal BN)
_BATCH_NORM_OPS = ("aten.native_batch_norm.default", "aten.cudnn_batch_norm.default",
                   "aten._native_batch_norm_legit_no_training.default")


def dtype_record(model, left, right, autocast: bool = True, disparity=None, loss_cfg=None) -> list:
    """The dtype plan of one bf16-autocast eval forward of `model` on the
    device of `left` (with `autocast` False: in the model's dtype), under
    no_grad, after a warm-up forward (which fills the fold cache): one entry
    per op that the dispatcher runs below autocast and that returns a
    floating tensor, views aside, as (op, module, input dtypes, output dtype,
    autocast on at the call). With a `disparity` (the gt), one train-mode
    forward with grad on and its loss (`train.loop.compute_loss` with
    `loss_cfg`, by default the sceneflow preset's, outside autocast as
    `train_step` takes it), after a
    warm-up one: the forward a bf16 train step runs, whose backward follows
    its casts (the backward is not recorded). The gwc volume is one entry
    ("gwc_volume", ...): the kernel on the card, its plain version on the
    CPU. The batch norm kernel is named "batch_norm"; a train-mode batch
    norm (`kernels/batchnorm.py::batch_norm_train`: the kernels on the
    card, the plain version on the CPU) is one such entry, its inputs x,
    weight, bias and the running statistics. Equal records of the CPU and
    the card mean the two devices ran one plan."""
    import torch
    from torch.nn.modules import module as nn_module
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from dcanet_tpu_torch.kernels import batchnorm
    from dcanet_tpu_torch.models import dcanet as dcanet_module
    from dcanet_tpu_torch.train.loop import LossConfig, compute_loss, valid_mask

    dev = left.device.type
    names = {m: n for n, m in model.named_modules()}
    stack, record, state = [""], [], {"autocast": False, "skip": 0}

    def dtypes(tree):
        return tuple(str(t.dtype).removeprefix("torch.") for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor) and t.is_floating_point())

    class Calls(TorchFunctionMode):  # the autocast state of each torch call, above autocast
        def __torch_function__(self, func, types, args=(), kwargs=None):
            state["autocast"] = torch.is_autocast_enabled(dev)
            return func(*args, **(kwargs or {}))

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = dtypes(out)
            if outs and not state["skip"] and not func.is_view:
                op = "batch_norm" if str(func) in _BATCH_NORM_OPS else str(func)
                record.append((op, stack[-1], dtypes((args, kwargs)), outs[0], state["autocast"]))
            return out

    gwc_volume = dcanet_module.gwc_volume
    batch_norm_train = batchnorm.batch_norm_train

    def recorded_batch_norm_train(x, *args):
        state["skip"] += 1
        try:
            out = batch_norm_train(x, *args)
        finally:
            state["skip"] -= 1
        record.append(("batch_norm", stack[-1], dtypes((x, *args[:4])), dtypes(out)[0], torch.is_autocast_enabled(dev)))
        return out

    def recorded_gwc_volume(fl, fr, *args, **kwargs):
        state["skip"] += 1
        try:
            out = gwc_volume(fl, fr, *args, **kwargs)
        finally:
            state["skip"] -= 1
        record.append(("gwc_volume", stack[-1], dtypes((fl, fr)), dtypes(out)[0], torch.is_autocast_enabled(dev)))
        return out

    def forward():
        if disparity is None:
            with torch.no_grad(), torch.autocast(dev, torch.bfloat16, enabled=autocast):
                return model(left, right)
        with torch.autocast(dev, torch.bfloat16, enabled=autocast):
            out = model(left, right)
        return compute_loss(out, disparity, valid_mask(disparity, model.maxdisp),
                            loss_cfg or LossConfig(max_disp=model.maxdisp))

    def enter(module, args):
        stack.append(names.get(module, stack[-1]))

    def leave(module, args, out):
        stack.pop()

    model.train(disparity is not None)
    forward()
    hooks = [nn_module.register_module_forward_pre_hook(enter), nn_module.register_module_forward_hook(leave)]
    dcanet_module.gwc_volume = recorded_gwc_volume
    batchnorm.batch_norm_train = recorded_batch_norm_train
    try:
        with Calls(), Ops():
            forward()
    finally:
        dcanet_module.gwc_volume = gwc_volume
        batchnorm.batch_norm_train = batch_norm_train
        for h in hooks:
            h.remove()
    return record


def same_dtype_plan(tag: str, cuda: list, cpu: list, what: str = "the folded bf16 eval, 1x3x64x256") -> None:
    """Raises unless the card's dtype record equals the CPU's; logs its length
    and the dtypes it holds."""
    counts = {}
    for _, _, ins, out, _ in cuda:
        counts[out] = counts.get(out, 0) + 1
    log(f"[{tag}] dtype plan of {what}: {len(cuda)} ops on the card, {len(cpu)} on the "
        f"CPU, {'equal' if cuda == cpu else 'NOT equal'}; outputs by dtype {counts}")
    if cuda != cpu:
        i = next((k for k, (a, b) in enumerate(zip(cuda, cpu)) if a != b), min(len(cuda), len(cpu)))
        for k in range(max(i - 2, 0), i + 3):
            log(f"[{tag}]   op {k}: card {cuda[k] if k < len(cuda) else None} | CPU {cpu[k] if k < len(cpu) else None}")
        raise AssertionError(f"[{tag}] the card runs another dtype plan of {what} than the CPU (op {i})")


def phase_model(flat):
    """DCANet(num_cva=3) eval at 384x1248 in bf16 and f32; GPU vs CPU model."""
    import torch
    from torch import nn

    from dcanet_tpu_torch import weights
    from dcanet_tpu_torch.data.submission import to_submission_shape, whiten_per_channel
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.nn import layers

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = DCANet(maxdisp=192, num_cva=3)
    model.load_state_dict(weights.from_jax_variables(flat, 3), strict=True)
    model.eval()

    left, right = synthetic_pair(SEED)
    tl, tr = (
        torch.from_numpy(to_submission_shape(whiten_per_channel(x))[0].transpose(2, 0, 1)[None].copy())
        for x in (left, right)
    )
    gpu = model.cuda()
    tl, tr = tl.cuda(), tr.cuda()
    n_bn = sum(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in gpu.modules())
    if n_bn != 116:
        raise AssertionError(f"[model] DCANet(num_cva=3) holds {n_bn} BatchNorm modules, not 116")
    disp, results, fwds = {}, {}, {}
    # bf16 with the eval BatchNorm folded into its conv (the default, as the
    # JAX package does at bf16), bf16 with it literal, then f32 (literal)
    for tag, bf16, fold in (("bf16", True, True), ("bf16 literal", True, False), ("f32", False, True)):
        def fwd(bf16=bf16):
            with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
                return gpu(tl, tr)

        fwds[tag] = fwd
        with fold_eval_bn(fold):
            gwc.LAUNCHES = 0
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out, ran, n_fwd = batch_norm_forwards(gpu, fwd)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            if gwc.LAUNCHES != 1:
                raise AssertionError(f"[model {tag}] gwc kernel launched {gwc.LAUNCHES} times in one forward")
            folded = tag == "bf16"
            if (folded and (ran or n_fwd != N_GUIDANCE_BN)) or (not folded and n_fwd != N_EVAL_BN):
                raise AssertionError(f"[model {tag}] {n_fwd} BatchNorm forwards, outside Guidance "
                                     f"{sorted(ran)[:4]}...")
            d = out.disparity
            if d.shape != (1, 384, 1248) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"[model {tag}] disparity {tuple(d.shape)} {d.dtype}, finite={bool(torch.isfinite(d).all())}")
            for lg in out.class_logits:
                if lg.shape != (1, 24, 48, 156) or not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"[model {tag}] class logits {tuple(lg.shape)} not finite or misshapen")
            disp[tag] = d.cpu().numpy()[0]
            iters = 10
            ms = time_cuda(fwd, iters)
            if gwc.LAUNCHES != 1 + 2 + iters:
                raise AssertionError(f"[model {tag}] {gwc.LAUNCHES} gwc launches for {3 + iters} forwards")
            results[tag] = dict(ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak, bn_forwards=n_fwd)
            log(f"[model] DCANet(num_cva=3, maxdisp=192) eval {tag} 1x3x384x1248: {ms:.3f} ms/pair, "
                f"{1e3 / ms:.3f} pairs/s, peak memory {peak / 2**30:.3f} GiB above weights, "
                f"disparity range [{disp[tag].min():.3f}, {disp[tag].max():.3f}], 1 gwc launch per forward, "
                f"{n_fwd} BatchNorm module forwards of the {N_EVAL_BN} an eval forward holds")
            results[tag]["profile"] = profile_call(fwd, tag)
    # the two bf16 forwards again, alternating, for their spread in this call
    for tag, fold in (("bf16 literal", False), ("bf16", True)):
        with fold_eval_bn(fold):
            results[tag]["ms_again"] = time_cuda(fwds[tag], 10)
    # the fold computed at each call instead of cached: its launches and time
    cached = layers._folded
    layers._folded = layers._fold
    try:
        with fold_eval_bn(True):
            results["bf16 uncached"] = dict(ms=time_cuda(fwds["bf16"], 10),
                                            profile=profile_call(fwds["bf16"], "bf16 fold uncached"))
    finally:
        layers._folded = cached
    f, lit, unc = results["bf16"], results["bf16 literal"], results["bf16 uncached"]
    log(f"[model] bf16 folded {f['ms']:.3f} / {f['ms_again']:.3f} ms/pair against literal {lit['ms']:.3f} / "
        f"{lit['ms_again']:.3f} (first / second round); the fold uncached {unc['ms']:.3f}; card: {gpu_line()}")
    for tag, other in (("bf16", "f32"), ("bf16", "bf16 literal"), ("bf16 literal", "f32")):
        diff = np.abs(disp[tag] - disp[other])
        log(f"[model] {tag} vs {other} disparity: mean |diff| {diff.mean():.4f} px, max {diff.max():.4f} px")

    # the GPU model (gwc kernel, cuDNN) against the CPU model (plain gwc) on a
    # small pair; tolerance as the JAX package's eval parity (5e-3 px)
    rng = np.random.default_rng(SEED + 1)
    sl, sr = (torch.from_numpy(rng.standard_normal((1, 3, 64, 256)).astype(np.float32)) for _ in range(2))
    with torch.inference_mode():
        want = model.cpu()(sl, sr).disparity
        gpu = model.cuda()
        got = gpu(sl.cuda(), sr.cuda()).disparity.cpu()
    small_err = float((got - want).abs().max())
    log(f"[model] GPU vs CPU model, 1x3x64x256 f32: max |diff| {small_err:.3e} px (atol 5e-3)")
    if not small_err <= 5e-3:
        raise AssertionError("GPU model disagrees with the CPU model on the small pair")
    results["small_err"] = small_err
    results["small_bf16"] = folded_gpu_vs_cpu(model, sl, sr, "model", block=lambda m: m.cva1.cost_agg)
    return results, disp["f32"]


def folded_gpu_vs_cpu(model, sl, sr, tag: str, block=None) -> dict:
    """The folded bf16 eval on the card (cuDNN) against the folded bf16 eval
    on the CPU (oneDNN), in a copy of `model` with the BatchNorm statistics
    of one train-mode forward of the small pair (with the seeded ones the
    activations are unnormalised). The dtype plans of the two (`dtype_record`)
    must be equal. With `block` (a module of the model, phase 3's
    `cva1.cost_agg`: a MultiAggregation with its deconv fold), the block on
    a bf16-representable volume: max |diff| / max(max |CPU|, 1e-3) <= 2e-2,
    the block bound of tests/test_torch_fold_eval.py, and the model on the
    pair closer than the CPU's own folded bf16 forward is to its f32 one
    (mean |diff|; random weights make a bf16 disparity at maxdisp 192 turn
    on rounding order). No BatchNorm outside Guidance may run on either
    device."""
    import copy

    import torch

    calibrated = calibrate_batch_norm(copy.deepcopy(model).cuda(), sl.cuda(), sr.cuda())
    vol = torch.randn(1, 32, 48, 16, 64, generator=torch.Generator().manual_seed(SEED + 8)).bfloat16().float()
    out, records = {}, {}
    with fold_eval_bn(True):
        for dev in ("cuda", "cpu"):
            m = calibrated.to(dev)
            with torch.inference_mode(), torch.autocast(dev, torch.bfloat16):
                res, ran, _ = batch_norm_forwards(m, lambda: m(sl.to(dev), sr.to(dev)))
                blk = None if block is None else block(m)(vol.to(dev)).float().cpu()
            if ran:
                raise AssertionError(f"[{tag}] folded bf16 on {dev}: BatchNorm modules ran: {sorted(ran)[:4]}")
            d = res.disparity
            if d.shape != (1, 64, 256) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"[{tag}] folded bf16 on {dev}: disparity {tuple(d.shape)} {d.dtype}")
            out[dev] = d.cpu(), blk
            records[dev] = dtype_record(m, sl.to(dev), sr.to(dev))
        with torch.inference_mode():
            f32 = calibrated(sl, sr).disparity
    same_dtype_plan(tag, records["cuda"], records["cpu"])
    (gd, gb), (cd, cb) = out["cuda"], out["cpu"]
    err, noise = float((gd - cd).abs().mean()), float((cd - f32).abs().mean())
    result = dict(disparity_err=err, disparity_max_err=float((gd - cd).abs().max()), cpu_bf16_vs_f32=noise,
                  dtype_ops=len(records["cuda"]))
    log(f"[{tag}] folded bf16, GPU vs CPU, calibrated BatchNorm statistics, 1x3x64x256: mean |diff| {err:.4f} px, "
        f"max {result['disparity_max_err']:.4f} px; the CPU's folded bf16 - its f32 {noise:.4f} px; card: "
        f"{gpu_line()}")
    if block is not None:
        result["block_err"] = float((gb - cb).abs().max()) / max(float(cb.abs().max()), 1e-3)
        log(f"[{tag}] the block on (1, 32, 48, 16, 64): scaled max |diff| {result['block_err']:.3e} (bound 2e-2); "
            f"the model's bound: the CPU's folded bf16 - its f32")
        if not (result["block_err"] <= 2e-2 and err < noise):
            raise AssertionError(f"[{tag}] the folded bf16 GPU model disagrees with the folded bf16 CPU model")
    return result


def phase_serving(flat, ref_disp, workdir: Path):
    """Three `cli infer --submission` requests; returns the gwc launch count."""
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.io import read_png, write_png
    from dcanet_tpu_torch.data.submission import from_submission_shape
    from dcanet_tpu_torch.kernels import gwc

    left, right = synthetic_pair(SEED)
    lp, rp, wp = workdir / "left.png", workdir / "right.png", workdir / "weights.npz"
    write_png(lp, left)
    write_png(rp, right)
    np.savez(wp, **flat)
    ref = from_submission_shape(ref_disp, KITTI_HW)

    gwc.LAUNCHES = 0
    outs = []
    for i in range(3):
        out = workdir / f"disp_{i}.png"
        t0 = time.perf_counter()
        cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out),
                  "--submission", "--weights", str(wp), "--device", "cuda"])
        log(f"[serving] request {i}: {time.perf_counter() - t0:.3f} s wall, incl. model build and weight load")
        outs.append(out)
    launches = gwc.LAUNCHES
    if launches != 3:
        raise AssertionError(f"[serving] gwc kernel launched {launches} times for 3 requests")
    for out in outs:
        png = read_png(out)
        if png.shape != KITTI_HW or png.dtype != np.uint16:
            raise AssertionError(f"[serving] {out.name}: {png.shape} {png.dtype}, expected {KITTI_HW} uint16")
        served = png.astype(np.float32) / 256.0
        close = np.abs(served - np.clip(ref, 0, 65535 / 256.0)) <= 1.0 / 128
        log(f"[serving] {out.name}: {png.shape} uint16, {close.mean():.4%} of pixels within 1/128 px "
            "of the phase-3 f32 disparity")
        if close.mean() < 0.99:
            raise AssertionError(f"[serving] {out.name} disagrees with the model run of phase 3")
    return launches


def phase_conv3d_path():
    """The conv3d kernel's own path, the counterpart of the JAX package's
    tools/bench_conv3d.py::run_pallas, in f32 and again in bf16 (its `--bf16`
    flag): the plain conv and the scale+bias+ReLU conv at 32 -> 32, the
    64 -> 32 conv, and one conv3d_fast forward and backward (the JAX
    package's custom_vjp, whose dgrad is the kernel). Returns the launch
    counts of the f32 (3xTF32) and the bf16 kernel on this path."""
    import torch

    from dcanet_tpu_torch.kernels import conv3d as cv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn(CONV_SHAPE, generator=gen, device="cuda")
    w = torch.randn((32, 32, 3, 3, 3), generator=gen, device="cuda") * 0.1
    x64 = torch.randn(CONV_SHAPE_64, generator=gen, device="cuda")
    w64 = torch.randn((32, 64, 3, 3, 3), generator=gen, device="cuda") * 0.1
    sc = torch.ones(32, device="cuda")
    bi = torch.zeros(32, device="cuda")
    launches = {}
    for tag, dtype, rtol in (("f32", torch.float32, 0.0), ("bf16", torch.bfloat16, 2.0**-7)):
        xd, wd, x64d, w64d = (t.to(dtype) for t in (x, w, x64, w64))
        cv.LAUNCHES = cv.BF16_LAUNCHES = 0
        outs = [cv.conv3d(xd, wd), cv.conv3d(xd, wd, sc, bi, relu=True), cv.conv3d(x64d, w64d)]
        xg, wg = xd.clone().requires_grad_(), wd.clone().requires_grad_()
        y = cv.conv3d_fast(xg, wg, True)
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
        n, n_bf16 = cv.LAUNCHES, cv.BF16_LAUNCHES
        launches[tag] = n_bf16 if dtype == torch.bfloat16 else n - n_bf16
        if n != 5 or launches[tag] != 5:
            raise AssertionError(f"[conv3d path {tag}] {n} kernel launches ({n_bf16} bf16), expected 3 convs + "
                                 f"1 forward + 1 dgrad of the {tag} kernel")
        want = cv.conv3d_reference(xd, wd).float()
        atol = 1e-5 * max(1.0, float(want.abs().max()))
        errs = [(outs[0].float() - want).abs(), (outs[1].float() - torch.relu(want)).abs()]
        bad = sum(int((e > atol + rtol * r.abs()).sum()) for e, r in zip(errs, (want, torch.relu(want))))
        finite = all(bool(torch.isfinite(t).all()) for t in (*outs, y, xg.grad, wg.grad))
        log(f"[conv3d path {tag}] 3 convs + conv3d_fast fwd/bwd at {CONV_SHAPE} and {CONV_SHAPE_64}: {n} launches, "
            f"max|err| vs plain {float(errs[0].max()):.3e} (affine+relu {float(errs[1].max()):.3e}; atol {atol:.3g}, "
            f"rtol {rtol:g}), all finite: {finite}")
        if not finite or bad:
            raise AssertionError(f"[conv3d path {tag}] outputs not finite or off the plain version")
        del xd, wd, x64d, w64d, outs, xg, wg, y, want, errs
    return launches


def phase_train(workdir: Path):
    """`cli train --preset sceneflow` at full width on a synthetic SceneFlow
    tree at 540x960, the preset's random 256x512 crop, batch 1, f32, then a
    resumed epoch. Returns the numbers for the summary."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree
    from dcanet_tpu_torch.kernels import batchnorm, gwc

    t0 = time.perf_counter()
    root = write_sceneflow_tree(workdir / "sceneflow", TRAIN_PAIRS, SCENEFLOW_HW, seed=SEED)
    log(f"[train] wrote {TRAIN_PAIRS} synthetic SceneFlow pairs at {SCENEFLOW_HW} in {time.perf_counter() - t0:.2f} s")
    logdir = workdir / "run"
    args = ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--batch-size", "1", "--dtype", "float32", "--seed", str(SEED), "--print-freq", "1",
            "--num-workers", "4", "--device", "cuda"]

    gwc.LAUNCHES = gwc.BACKWARD_LAUNCHES = 0
    batchnorm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    hist = cli.main(args + ["--epochs", str(TRAIN_EPOCHS)])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = gwc.LAUNCHES, gwc.BACKWARD_LAUNCHES
    bn = check_bn_counts("train", bn_counts())
    steps = len(hist)
    if steps != TRAIN_PAIRS * TRAIN_EPOCHS:
        raise AssertionError(f"[train] {steps} steps, expected {TRAIN_PAIRS * TRAIN_EPOCHS}")
    for rec in hist:
        log(f"[train] step {rec['step']}: loss {rec['total']:.4f} (focal {rec['focal']:.4f}, smooth-L1 "
            f"{rec['smooth_l1']:.4f}), grad norm {rec['grad_norm']:.4f}, epe {rec['epe']:.4f}")
        if not all(math.isfinite(rec[k]) for k in ("total", "focal", "smooth_l1", "grad_norm", "epe")):
            raise AssertionError(f"[train] step {rec['step']} is not finite: {rec}")
    if fwd != steps or bwd != steps:
        raise AssertionError(f"[train] gwc forward {fwd} / backward {bwd} launches in {steps} steps")
    ms, lo, hi = _median_gap_ms(hist, skip=TRAIN_WARMUP - 1)
    log(f"[train] DCANet(num_cva=3, maxdisp=192) f32, 1x3x256x512 crops: {steps} steps, "
        f"{fwd} gwc forward and {bwd} gwc backward launches (1 each per step), BatchNorm kernels {bn['launches']} "
        f"launches and {bn['plain_calls']} plain calls; median {ms:.3f} ms/step "
        f"over steps {TRAIN_WARMUP}-{steps - 1} (range {lo:.3f}-{hi:.3f}), "
        f"{1e3 / ms:.3f} pairs/s, peak memory {peak / 2**30:.3f} GiB")

    ckpts = sorted(p.name for p in (logdir / "ckpt").iterdir())
    want = [f"ckpt_{TRAIN_PAIRS * (e + 1):08d}.pt" for e in range(TRAIN_EPOCHS)]
    if ckpts != want:
        raise AssertionError(f"[train] checkpoints {ckpts}, expected {want}")
    gwc.LAUNCHES = gwc.BACKWARD_LAUNCHES = 0
    resumed = cli.main(args + ["--epochs", str(TRAIN_EPOCHS + 1), "--resume"])
    if [r["step"] for r in resumed] != list(range(steps, steps + TRAIN_PAIRS)):
        raise AssertionError(f"[train] the resumed run took steps {[r['step'] for r in resumed]}")
    if not all(math.isfinite(r["total"]) for r in resumed):
        raise AssertionError("[train] the resumed run's loss is not finite")
    log(f"[train] checkpoints {ckpts}; resumed at step {resumed[0]['step']}, {len(resumed)} more steps, "
        f"loss {resumed[0]['total']:.4f} -> {resumed[-1]['total']:.4f}")
    resumed_fwd, resumed_bwd = gwc.LAUNCHES, gwc.BACKWARD_LAUNCHES
    infer_launches = serve_from_logdir(logdir, workdir)
    alone = profile_train_step(root)
    bf16 = train_bf16_leg(workdir)
    memory = train_memory(bf16.pop("root"))
    return dict(alone=alone, steps=steps, ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak, fwd=fwd, bwd=bwd, bn=bn,
                resumed_fwd=resumed_fwd, resumed_bwd=resumed_bwd, infer=infer_launches, bf16=bf16, memory=memory)


def train_bf16_leg(workdir: Path) -> dict:
    """`cli train --preset sceneflow --dtype bfloat16 --batch-size 4` at full
    width on BF16_TRAIN_SCENES procedural scenes at 320x640, one epoch: every
    metric finite, one bf16 gwc forward and one bf16 backward launch per step
    and no f32 one (the counts of this leg), ms/step (host clock between the
    steps' metric reads, median after TRAIN_WARMUP steps), pairs/s, peak
    memory. Returns them and the tree's root."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.synthetic import write_procedural_sceneflow_tree
    from dcanet_tpu_torch.kernels import batchnorm, gwc

    t0 = time.perf_counter()
    root = write_procedural_sceneflow_tree(workdir / "procedural", BF16_TRAIN_SCENES, 0, PROCEDURAL_HW, seed=SEED)
    log(f"[train bf16] wrote {BF16_TRAIN_SCENES} procedural SceneFlow scenes at {PROCEDURAL_HW} in "
        f"{time.perf_counter() - t0:.2f} s")
    args = ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(workdir / "run_bf16"),
            "--batch-size", str(BF16_TRAIN_BATCH), "--dtype", "bfloat16", "--seed", str(SEED), "--print-freq", "1",
            "--num-workers", "4", "--epochs", "1", "--device", "cuda"]
    gwc.reset_launch_counts()
    batchnorm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    hist = cli.main(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = dict(gwc.LAUNCHES_BY_DTYPE), dict(gwc.BACKWARD_LAUNCHES_BY_DTYPE)
    bn = check_bn_counts("train bf16", bn_counts())
    steps = len(hist)
    if steps != BF16_TRAIN_SCENES // BF16_TRAIN_BATCH:
        raise AssertionError(f"[train bf16] {steps} steps, expected {BF16_TRAIN_SCENES // BF16_TRAIN_BATCH}")
    keys = ("total", "focal", "smooth_l1", "grad_norm", "epe")
    for rec in hist:
        log(f"[train bf16] step {rec['step']}: " + ", ".join(f"{k} {rec[k]:.4f}" for k in keys))
        if not all(math.isfinite(rec[k]) for k in keys):
            raise AssertionError(f"[train bf16] step {rec['step']} is not finite: {rec}")
    if fwd != {"float32": 0, "bfloat16": steps} or bwd != {"float32": 0, "bfloat16": steps}:
        raise AssertionError(f"[train bf16] gwc launches by dtype: forward {fwd}, backward {bwd} in {steps} steps")
    ms, lo, hi = _median_gap_ms(hist, skip=TRAIN_WARMUP - 1)
    log(f"[train bf16] cli train --dtype bfloat16 --batch-size {BF16_TRAIN_BATCH}, DCANet(num_cva=3, maxdisp=192), "
        f"{BF16_TRAIN_BATCH}x3x256x512 crops: {steps} steps, gwc launches forward {fwd}, backward {bwd}, BatchNorm "
        f"kernels {bn['launches']} launches and {bn['plain_calls']} plain calls; median "
        f"{ms:.3f} ms/step over steps {TRAIN_WARMUP}-{steps - 1} (range {lo:.3f}-{hi:.3f}), "
        f"{1e3 * BF16_TRAIN_BATCH / ms:.3f} pairs/s, peak memory {peak / 2**30:.4f} GiB")
    return dict(root=root, steps=steps, ms=ms, pairs_per_s=1e3 * BF16_TRAIN_BATCH / ms, peak_bytes=peak,
                fwd=fwd, bwd=bwd, bn=bn)


def memory_at_peak(fn, top: int = 6) -> dict:
    """What holds the device memory at the peak of one call of `fn`, among
    the blocks allocated during it (the allocator's history): the live bytes
    at the peak by the innermost frame in dcanet_tpu_torch/ of each block's
    allocation (with the innermost Python frame), largest first, and the
    largest blocks."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def where(frames):
        """The three innermost frames in the port (the call and its callers),
        and the innermost Python frame; no Python frame: the backward."""
        port = [f"{f['filename'].split('dcanet_tpu_torch/')[-1]}:{f['line']} {f['name']}"
                for f in frames if "dcanet_tpu_torch" in f["filename"]][:3]
        inner = next((f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} {f['name']}" for f in frames
                      if f["filename"].endswith(".py")), None)
        if inner is None:
            return "no Python frame (the backward)"
        return f"{' < '.join(port) or 'outside the port'} ({inner})"

    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    by_site = {}
    for size, frames in at_peak.values():
        by_site[where(frames)] = by_site.get(where(frames), 0) + size
    sites = sorted(by_site.items(), key=lambda kv: -kv[1])[:top]
    blocks = sorted(((size, where(frames)) for size, frames in at_peak.values()), reverse=True)[:top]
    return dict(peak_bytes=peak, blocks=len(at_peak), sites=sites, largest=blocks)


def step_alone(cfg, batch: dict, loss_cfg, steps: int, warmup: int = 0, at_peak: bool = False) -> dict:
    """The train step alone (the batch already on the card, no loader) of
    the model and optimiser `cli.build_train_state(cfg)` builds: `steps`
    steps, the median ms of those after `warmup` (host clock, synchronised
    around each step), pairs/s, the losses, the peak device memory over them
    and the memory held before the first step and after the last; with
    `at_peak`, what holds the memory at the peak of one more step
    (`memory_at_peak`)."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.train.loop import train_step

    state = cli.build_train_state(cfg, 1, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(before_bytes=torch.cuda.memory_allocated(), losses=[])
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(float(train_step(state, batch, loss_cfg)["total"]))  # the read waits for the step
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times)
    b = len(next(iter(batch.values())))
    out.update(ms=ms, ms_range=[min(times), max(times)], pairs_per_s=1e3 * b / ms,
               peak_bytes=torch.cuda.max_memory_allocated(), held_bytes=torch.cuda.memory_allocated())
    if at_peak:
        out["at_peak"] = memory_at_peak(lambda: train_step(state, batch, loss_cfg))
    return out


def train_memory(root: Path) -> dict:
    """The train step alone (`step_alone`) of DCANet(num_cva=3, maxdisp=192)
    on 256x512 crops of the procedural tree, at each batch of MEMORY_BATCHES
    in f32 and in bf16: the peak device memory over MEMORY_STEPS steps and
    the memory held between steps (the parameters, gradients and Adam's
    state); what holds the memory at the peak of one step (`memory_at_peak`)
    in f32 at batch 2 (PERF.md §7's question: 22.17 GiB against 3.70 at
    batch 1) and in bf16 at the largest batch."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.loop import LossConfig

    base = preset("sceneflow", data_root=str(root), seed=SEED)
    ds = cli.build_dataset(base, training=True)
    samples = [ds[i] for i in range(max(MEMORY_BATCHES))]
    loss_cfg = LossConfig(max_disp=base.maxdisp)
    results = {}
    for dtype in ("float32", "bfloat16"):
        for b in MEMORY_BATCHES:
            batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:b]])).cuda() for k in samples[0]}
            entry = step_alone(preset("sceneflow", seed=SEED, dtype=dtype), batch, loss_cfg, MEMORY_STEPS,
                               at_peak=(dtype, b) in (("float32", 2), ("bfloat16", max(MEMORY_BATCHES))))
            entry["batch_bytes"] = sum(t.numel() * t.element_size() for t in batch.values())
            results[f"{dtype} b{b}"] = entry
            peak, held, before, loss = (entry[k] for k in ("peak_bytes", "held_bytes", "before_bytes", "losses"))
            log(f"[train memory] {dtype} batch {b}: peak {peak / 2**30:.4f} GiB, held between steps "
                f"{held / 2**30:.4f} GiB (before the first step {before / 2**30:.4f}), loss {loss[-1]:.4f}")
            for site, size in entry.get("at_peak", {}).get("sites", []):
                log(f"[train memory]   at the peak of one step: {size / 2**30:8.4f} GiB {site}")
            for size, site in entry.get("at_peak", {}).get("largest", [])[:3]:
                log(f"[train memory]   largest block: {size / 2**20:10.1f} MiB {site}")
            if not all(math.isfinite(x) for x in loss):
                raise AssertionError(f"[train memory] {dtype} batch {b}: a loss is not finite")
            del batch
            torch.cuda.empty_cache()
    return results


def serve_from_logdir(logdir: Path, workdir: Path) -> int:
    """One `cli infer --submission --logdir` request from the train run's
    newest checkpoint, f32; the served PNG against the checkpoint's "model"
    weights run in-process on the same pair. Returns the request's gwc
    launches."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.io import read_png, write_png
    from dcanet_tpu_torch.data.submission import from_submission_shape, to_submission_shape, whiten_per_channel
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet

    left, right = synthetic_pair(SEED)
    lp, rp, out = workdir / "train_left.png", workdir / "train_right.png", workdir / "train_disp.png"
    write_png(lp, left)
    write_png(rp, right)
    gwc.LAUNCHES = 0
    t0 = time.perf_counter()
    cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--submission",
              "--logdir", str(logdir), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = gwc.LAUNCHES
    if launches != 1:
        raise AssertionError(f"[train infer] gwc kernel launched {launches} times for 1 request")

    newest = sorted((logdir / "ckpt").iterdir())[-1]
    model = DCANet(maxdisp=192, num_cva=3)
    model.load_state_dict(torch.load(newest, map_location="cpu", weights_only=True)["model"], strict=True)
    model = model.cuda().eval()
    tl, tr = (torch.from_numpy(to_submission_shape(whiten_per_channel(x.astype(np.float32)))[0]
                               .transpose(2, 0, 1)[None].copy()).cuda() for x in (left, right))
    with torch.inference_mode():
        ref = from_submission_shape(model(tl, tr).disparity[0].float().cpu().numpy(), KITTI_HW)
    png = read_png(out)
    if png.shape != KITTI_HW or png.dtype != np.uint16:
        raise AssertionError(f"[train infer] {out.name}: {png.shape} {png.dtype}, expected {KITTI_HW} uint16")
    close = np.abs(png.astype(np.float32) / 256.0 - np.clip(ref, 0, 65535 / 256.0)) <= 1.0 / 128
    log(f"[train infer] cli infer --submission --logdir: {newest.name}, {wall:.3f} s wall, {launches} gwc launch, "
        f"{close.mean():.4%} of pixels within 1/128 px of the checkpoint's weights run in-process")
    if close.mean() < 0.99:
        raise AssertionError("[train infer] the served PNG disagrees with the checkpoint's weights")
    return launches


def profile_train_step(root: Path) -> dict:
    """The train step alone, on one batch already on the card (no loader),
    in f32, in bf16 autocast (`--dtype bfloat16`) and in f32 with `--remat`:
    median ms of 5 steps after 2 warm-ups, peak memory, finite losses; then
    one profiled f32 step (device busy share and the kernels that take
    most). Its launches are not counted as the path's."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.loop import LossConfig, train_step

    base = preset("sceneflow", data_root=str(root), seed=SEED)
    sample = cli.build_dataset(base, training=True)[0]
    batch = {k: torch.from_numpy(v[None]).cuda() for k, v in sample.items()}
    loss_cfg = LossConfig(max_disp=base.maxdisp)
    results = {}
    for tag, overrides in (("f32", {}), ("bf16 autocast", {"dtype": "bfloat16"}), ("f32 remat", {"remat": True})):
        state = cli.build_train_state(preset("sceneflow", seed=SEED, **overrides), TRAIN_PAIRS, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(state, batch, loss_cfg)["total"]))
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times)
        results[tag] = dict(ms=ms, peak_bytes=peak)
        log(f"[train] the train step alone, {tag} (batch on the card, no loader): median {ms:.3f} ms over 5 steps "
            f"(range {min(times):.3f}-{max(times):.3f}), peak memory {peak / 2**30:.3f} GiB, "
            f"losses {', '.join(f'{x:.3f}' for x in losses)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[train] {tag}: a loss is not finite")
        if tag == "f32":
            profile_call(lambda: train_step(state, batch, loss_cfg), "train step", top=10)
        del state
        torch.cuda.empty_cache()
    return results


def _kitti_parity_batch(seed: int) -> dict:
    """A 1x3x64x128 crop of a procedural KITTI scene (`procedural_scene` at
    64x256, its right half), the images normalised as the loader does, the
    gt sparse as `write_procedural_kitti_tree` writes it (x256, truncated)."""
    from dcanet_tpu_torch.data.io import normalize_imagenet
    from dcanet_tpu_torch.data.synthetic import kitti_sparse_gt, procedural_scene

    left, right, disp = procedural_scene(seed, 64, 256)
    gt = kitti_sparse_gt(disp, seed)[:, 128:].astype(np.float32) / 256.0

    def chw(img):
        return normalize_imagenet(img[:, 128:].astype(np.float32)).transpose(2, 0, 1)[None].astype(np.float32)

    return {"left": chw(left), "right": chw(right), "disparity": np.ascontiguousarray(gt[None])}


def phase_train_parity(name: str = "dcanet", loss_preset: str = "sceneflow", maxdisp: int = 192, batches=None,
                       float64_witness: bool = False):
    """One GPU train step (CUDA kernels, cuDNN) against one CPU train step
    (plain versions) of the registry's model `name` (at `maxdisp`) from the
    same weights on a small input: loss terms, grad norm and the updated
    BatchNorm statistics, in f32. With `batches`, the `loss_preset` step on
    them (the middlebury phase: the smooth-L1 preset on Middlebury crops);
    with `float64_witness`, the f32 grad norm is held not card against CPU
    but against a float64 step on each batch (`_float64_witness`);
    with `loss_preset="kitti"`, the KITTI preset's step
    (5x / 10x focal and smooth-L1 on a sparse gt) on crops of procedural
    KITTI scenes (`_kitti_parity_batch`); else the sceneflow loss on random
    images and a dense gt. For DCANet also in bf16 autocast (the bf16 train
    step): the GPU's bf16 step against the CPU's, within the CPU's own
    bf16-vs-f32 distance on the step, for the loss terms and EPE (relative,
    the CPU distance the largest over them and over the draws: one
    scalar's distance is one draw of its rounding noise, so the kitti case
    takes KITTI_PARITY_DRAWS crops, each step on the card held against the
    CPU's on the same crop, within KITTI_PARITY_SCALAR_BOUND times that
    distance), the whole gradient and the BatchNorm statistics (relative
    L2, on the first crop), the grad norm within the gradient's
    bf16-vs-f32 distance (|a| - |b| <= |a - b|); and the dtype plan of the
    bf16 step's forward and loss (`dtype_record`) equal on both."""
    import copy

    import torch

    from dcanet_tpu_torch.models.registry import make_model
    from dcanet_tpu_torch.nn.layers import reference_init_
    from dcanet_tpu_torch.train.loop import LossConfig, train_step
    from dcanet_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = reference_init_(make_model(name, maxdisp=maxdisp), torch.Generator().manual_seed(SEED + 3))
    if batches is not None:
        cfg = LossConfig(max_disp=maxdisp, preset=loss_preset)
    elif loss_preset == "kitti":
        batches = [_kitti_parity_batch(SEED + 3 + i) for i in range(KITTI_PARITY_DRAWS)]
        cfg = LossConfig(max_disp=192, sparse=True, preset="kitti")
    else:
        rng = np.random.default_rng(SEED + 3)
        batches = [{
            "left": rng.standard_normal((1, 3, 64, 128)).astype(np.float32),
            "right": rng.standard_normal((1, 3, 64, 128)).astype(np.float32),
            "disparity": rng.uniform(1.0, 60.0, (1, 64, 128)).astype(np.float32),
        }]
        cfg = LossConfig(max_disp=192)
    tag = name if loss_preset == "sceneflow" else f"{name}, {loss_preset} preset"
    amps = (None, torch.bfloat16) if name == "dcanet" else (None,)
    draws = []
    for i, batch in enumerate(batches):
        results = {}
        for amp in amps:
            for dev in ("cpu", "cuda"):
                m = copy.deepcopy(model).to(dev)
                state = create_train_state(m, lambda step: 1e-3, amp)
                metrics = train_step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, cfg)
                stats = {k: v.detach().cpu() for k, v in m.state_dict().items() if "running" in k}
                # the kitti loss leaves the heads of vol_2.. out: no gradient there, as Adam skips them
                grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
                                  .reshape(-1) for p in m.parameters()])
                results[dev, amp] = ({k: float(v) for k, v in metrics.items()}, stats, grad)
        draws.append(results)
    (mc, sc, _), (mg, sg, _) = draws[0]["cpu", None], draws[0]["cuda", None]
    stat_err = max(float((sc[k] - sg[k]).abs().max()) for k in sc)
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12)
           for k in ("total", "focal", "smooth_l1", "grad_norm") if k in mc}
    size = "x".join(map(str, batches[0]["left"].shape))
    log(f"[train parity] {tag}: GPU vs CPU train step, {size} f32: loss {mg['total']:.6f} vs {mc['total']:.6f}, "
        f"grad norm {mg['grad_norm']:.6f} vs {mc['grad_norm']:.6f}; relative differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; BatchNorm statistics max|diff| {stat_err:.3e} (tolerances: loss terms 1e-4, grad norm 1e-3"
        + (" (here: the float64 witness below)" if float64_witness else "") + ", statistics 1e-4)")
    norm_bad = rel["grad_norm"] > 1e-3
    out = dict(rel=rel, stat_err=stat_err)
    if float64_witness:
        # float64 on the CPU for the first crop only (~20 s a step): there the card's float64 step is held
        # to it, and is the witness on the others
        out["float64"] = [_float64_witness(model, batch, cfg, draw, f"{tag}, crop {i}", on_cpu=i == 0)
                          for i, (batch, draw) in enumerate(zip(batches, draws))]
        norm_bad = False
    if max(v for k, v in rel.items() if k != "grad_norm") > 1e-4 or norm_bad or stat_err > 1e-4:
        raise AssertionError("[train parity] the GPU train step disagrees with the CPU train step")
    if name == "dcanet":
        out["bf16"] = _bf16_step_parity(draws, tag, 1.0 if loss_preset == "sceneflow" else KITTI_PARITY_SCALAR_BOUND,
                                        size)
        batch = batches[0]
        gt = torch.from_numpy(batch["disparity"])
        left, right = (torch.from_numpy(batch[k]) for k in ("left", "right"))
        cpu_rec = dtype_record(copy.deepcopy(model), left, right, disparity=gt, loss_cfg=cfg)
        cuda_rec = dtype_record(copy.deepcopy(model).cuda(), left.cuda(), right.cuda(), disparity=gt.cuda(),
                                loss_cfg=cfg)
        same_dtype_plan("train parity", cuda_rec, cpu_rec, f"a bf16 train step's forward and loss ({tag}), {size}")
        out["bf16"]["dtype_plan_ops"] = len(cuda_rec)
    return out


def _float64_witness(model, batch: dict, cfg, draw: dict, tag: str, on_cpu: bool = True) -> dict:
    """The step of `model` on `batch` in float64 on the card (cuDNN's
    float64 convolutions; the gwc volume by its plain version, the kernels
    taking f32 and bf16) and, with `on_cpu`, on the CPU, the two held
    together as phase 10 holds float64 steps: loss terms 1e-7, grad norm
    1e-6, the whole gradient 1e-7 (relative L2). Then the f32 steps of
    `draw` against the float64 step (the CPU's, else the card's): the card's
    gradient no farther from the float64 gradient than twice the CPU's f32
    gradient is (the triangle bound: two roundings of one step), and the
    card's grad norm within MIDDLEBURY_F32_GRAD_NORM_BOUND of the float64
    norm (relative). On the Middlebury crop at maxdisp 240 the f32 gradient
    lies ~5e-3 from float64 on either device (PERF.md §6): the f32 grad
    norms are not within 1e-3 of each other there. The card's f32 step with
    the plain gwc in place of the kernels is logged beside it: where the f32
    error comes from."""
    import copy

    import torch

    from dcanet_tpu_torch.kernels.gwc import gwc_volume_reference
    from dcanet_tpu_torch.models import dcanet
    from dcanet_tpu_torch.train.loop import train_step
    from dcanet_tpu_torch.train.state import create_train_state

    wide = {}
    runs = (("cpu", torch.float64),) * on_cpu + (("cuda", torch.float64), ("cuda", torch.float32))
    kernel_gwc, dcanet.gwc_volume = dcanet.gwc_volume, gwc_volume_reference
    try:  # float64, and the card's f32 step with the plain gwc beside the kernel's
        for dev, dtype in runs:
            m = copy.deepcopy(model).to(dev, dtype)
            metrics = train_step(create_train_state(m, lambda step: 1e-3, None),
                                 {k: torch.from_numpy(v).to(dev, dtype) for k, v in batch.items()}, cfg)
            grad = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().double().cpu()
                              .reshape(-1) for p in m.parameters()])
            wide[dev, dtype] = ({k: float(v) for k, v in metrics.items()}, grad)
    finally:
        dcanet.gwc_volume = kernel_gwc
    mg, gg = wide["cuda", torch.float64]
    mc, gc = wide["cpu", torch.float64] if on_cpu else (mg, gg)
    mp, gp = wide["cuda", torch.float32]
    rel64 = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-300) for k in mc if k != "epe"}
    grad64 = float((gg - gc).norm() / gc.norm())
    exact_norm = float(gc.norm())
    f32 = {dev: draw[dev, None][2].double() for dev in ("cpu", "cuda")}
    own = float((f32["cpu"] - gc).norm())
    card = float((f32["cuda"] - gc).norm())
    norm_card = abs(draw["cuda", None][0]["grad_norm"] - mc["grad_norm"])
    norm_cpu = abs(draw["cpu", None][0]["grad_norm"] - mc["grad_norm"])
    plain, norm_plain = float((gp - gc).norm()), abs(mp["grad_norm"] - mc["grad_norm"])
    log(f"[train parity] {tag}: "
        + ("float64 steps, card (cuDNN, plain gwc) against CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in rel64.items())
           + f", whole gradient {grad64:.2e} (bounds: loss terms 1e-7, grad norm 1e-6, gradient 1e-7); "
           if on_cpu else "the card's float64 step as the witness; ")
        + f"the f32 steps against float64 (grad norm {mc['grad_norm']:.6f}): "
        f"gradient card {card / exact_norm:.3e}, CPU {own / exact_norm:.3e} (relative L2; bound for the card: 2x the "
        f"CPU's), grad norm card {norm_card / exact_norm:.3e}, CPU {norm_cpu / exact_norm:.3e} (relative; bound for "
        f"the card: {MIDDLEBURY_F32_GRAD_NORM_BOUND:g}); the card's f32 step with the plain gwc in place of the "
        f"kernels: gradient {plain / exact_norm:.3e}, grad norm {norm_plain / exact_norm:.3e}")
    if (max(v for k, v in rel64.items() if k != "grad_norm") > 1e-7 or rel64["grad_norm"] > 1e-6 or grad64 > 1e-7
            or card > 2 * own or norm_card > MIDDLEBURY_F32_GRAD_NORM_BOUND * exact_norm):
        raise AssertionError(f"[train parity] {tag}: the card's step disagrees with the float64 witness")
    return dict(rel64=rel64 if on_cpu else None, grad64=grad64 if on_cpu else None,
                f32_grad=(card / exact_norm, own / exact_norm),
                f32_grad_norm=(norm_card / exact_norm, norm_cpu / exact_norm),
                f32_plain_gwc=(plain / exact_norm, norm_plain / exact_norm))


def _bf16_step_parity(draws: list, tag: str, scalar_bound: float = 1.0, size: str = "1x3x64x128") -> dict:
    """The GPU bf16 step against the CPU bf16 step (phase_train_parity): the
    scalars on every draw, within `scalar_bound` times the CPU's own
    distance; the rest on the first draw, within 1x. Logs each draw's
    scalars: the CPU's and the card's own bf16-vs-f32 distance, the card's
    f32 step against the CPU's, and the card's bf16 step against the CPU's."""
    import torch

    bf16 = torch.bfloat16
    (mf, sf, gf), (mb, sb, gb), (mgb, sgb, ggb) = (draws[0]["cpu", None], draws[0]["cpu", bf16],
                                                 draws[0]["cuda", bf16])

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def cat(d):
        return torch.cat([d[k].double().reshape(-1) for k in sorted(d)])

    def scalar_rel(r, a, b):
        return {k: abs(r[a][0][k] - r[b][0][k]) / abs(r[b][0][k]) for k in losses}

    losses = tuple(k for k in ("total", "focal", "smooth_l1", "epe") if k in mf)  # the smooth-L1 preset has no focal
    own = [scalar_rel(r, ("cpu", bf16), ("cpu", None)) for r in draws]
    crosses = [scalar_rel(r, ("cuda", bf16), ("cpu", bf16)) for r in draws]
    for i, r in enumerate(draws):
        parts = {"CPU bf16-f32": own[i], "card bf16-f32": scalar_rel(r, ("cuda", bf16), ("cuda", None)),
                 "card-CPU f32": scalar_rel(r, ("cuda", None), ("cpu", None)), "card-CPU bf16": crosses[i]}
        log(f"[train parity] {tag}: draw {i}, relative: " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v[k]:.3e}" for k in losses) for name, v in parts.items()))
    cpu_scale = max(max(o.values()) for o in own)
    cross = {k: max(c[k] for c in crosses) for k in losses}
    grad_cross, grad_own = rel_l2(ggb, gb), rel_l2(gf, gb)
    stat_cross, stat_own = rel_l2(cat(sgb), cat(sb)), rel_l2(cat(sf), cat(sb))
    norm_cross, norm_bound = abs(mgb["grad_norm"] - mb["grad_norm"]), float((gf - gb).norm())
    log(f"[train parity] {tag}: GPU vs CPU bf16 train step, {size}: loss {mgb['total']:.6f} vs {mb['total']:.6f} "
        f"(CPU f32 {mf['total']:.6f}), grad norm {mgb['grad_norm']:.6f} vs {mb['grad_norm']:.6f} (f32 "
        f"{mf['grad_norm']:.6f}); relative, the largest over {len(draws)} draw(s): "
        + ", ".join(f"{k} {v:.3e}" for k, v in cross.items())
        + f" against {scalar_bound:g}x the CPU's own bf16-vs-f32 {cpu_scale:.3e} (the largest over them); whole "
        f"gradient {grad_cross:.4f} against {grad_own:.4f}; BatchNorm statistics {stat_cross:.3e} against "
        f"{stat_own:.3e}; grad norm {norm_cross:.4f} against the CPU's bf16-vs-f32 gradient distance "
        f"{norm_bound:.4f} (bound: the CPU's own distance)")
    if (max(cross.values()) > scalar_bound * cpu_scale or grad_cross > grad_own or stat_cross > stat_own
            or norm_cross > norm_bound):
        raise AssertionError("[train parity] the GPU's bf16 train step sits farther from the CPU's than its bound "
                             "from the CPU's own bf16-vs-f32 distance")
    return dict(rel=cross, cpu_scale=cpu_scale, scalar_bound=scalar_bound, draws=[dict(own=o, cross=c) for o, c
                                                                                  in zip(own, crosses)],
                grad=(grad_cross, grad_own), stats=(stat_cross, stat_own), grad_norm=(norm_cross, norm_bound))


def _eval_reference(model, ds, bf16: bool, maxdisp: int = 192, protocol: str = "kitti"):
    """The eval command's numbers from direct model calls on the same
    transformed pairs: EPE, D1 and >1/2/3 px with numpy (float32 errors,
    float64 means), the per-image skip rule, the means weighted by the
    images kept; and per CVA volume the (gt class, argmax class) counts."""
    import torch

    from dcanet_tpu_torch.data.eval_protocol import eval_transform

    sums, kept, confusions = dict.fromkeys(("epe", "d1", "thres1", "thres2", "thres3"), 0.0), 0, None
    for i in range(len(ds)):
        left, right, gt, pads = eval_transform(ds[i], protocol)
        tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])).cuda() for x in (left, right))
        with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            out = model(tl, tr)
        disp = out.disparity[0].float().cpu().numpy()
        disp = disp[pads[0]:, : disp.shape[1] - pads[1]]
        mask = (gt > 0) & (gt < maxdisp)
        if mask.mean() >= 0.1 * (gt > 0).mean() and (gt > 0).any():
            err = np.abs(disp - gt)[mask]
            bad = {"epe": err, "d1": (err > 3.0) & (err > 0.05 * np.abs(gt[mask])),
                   "thres1": err > 1.0, "thres2": err > 2.0, "thres3": err > 3.0}
            for k, v in bad.items():
                sums[k] += float(v.astype(np.float64).mean())
            kept += 1
        gt_model = np.pad(gt, [(pads[0], 0), (0, pads[1])])
        counts = []
        for lg in out.class_logits:
            n, hp, wp = lg.shape[1:]
            scale = gt_model.shape[1] // wp
            gt_cls = np.floor(gt_model.astype(np.float64).reshape(hp, scale, wp, scale).mean(axis=(1, 3)) / 8.0)
            pred = lg[0].float().argmax(dim=0).cpu().numpy()
            ok = (gt_cls >= 0) & (gt_cls < n)
            counts.append(np.bincount((gt_cls[ok] * n + pred[ok]).astype(np.int64), minlength=n * n).reshape(n, n))
        confusions = counts if confusions is None else [a + c for a, c in zip(confusions, counts)]
    return {k: v / max(kept, 1) for k, v in sums.items()}, kept, confusions


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the duration. Its default f32
    ConvTranspose3d algorithm adds with atomics, so two f32 forwards of one
    pair may differ in the last bits; a check that holds one run against
    another needs the same fixed order in both."""
    import torch

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _eval_parts(model, ds, bf16: bool, protocol: str = "kitti") -> dict:
    """Where an eval pair's time goes: the host's decode and transform of
    each pair under `protocol` (and their median), and the forward alone on
    the first pair (CUDA events, median of 5)."""
    import torch

    from dcanet_tpu_torch.data.eval_protocol import eval_transform

    host = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        left, right, _, _ = eval_transform(ds[i], protocol)
        host.append(1e3 * (time.perf_counter() - t0))
    tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])).cuda() for x in eval_transform(ds[0], protocol)[:2])

    def fwd():
        with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            return model(tl, tr)

    return dict(host_ms=statistics.median(host), host_ms_each=host, forward_ms=time_cuda(fwd, 5))


def phase_eval(workdir: Path, train_logdir) -> dict:
    """`cli eval --preset kitti --dataset kitti2015` with DCANet(num_cva=3,
    maxdisp=192) on a synthetic KITTI 2015 tree at 375x1242, in f32 and in
    bf16, with the weights of phase 6's newest checkpoint (`train_logdir`)
    or, without it, the seed-0 reference init: one gwc launch per pair, the
    metrics and the class scores against `_eval_reference`, readable image
    panels; then `cli infer --list` over 3 names against single `infer
    --submission` requests, and with a train run, `cli export` then `infer
    --weights` against `infer --logdir`, bit for bit; each check that holds
    one run against another under `cudnn_deterministic`, the timed run with
    cuDNN's defaults."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.data.eval_protocol import KITTI_H, KITTI_W
    from dcanet_tpu_torch.data.io import read_png
    from dcanet_tpu_torch.data.synthetic import write_kitti2015_tree
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.nn.layers import reference_init_
    from dcanet_tpu_torch.train.checkpoint import checkpoint_step, latest_checkpoint
    from dcanet_tpu_torch.train.metrics import segmentation_scores

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    root = write_kitti2015_tree(workdir / "kitti", EVAL_PAIRS, KITTI_HW, seed=SEED, out_of_range_pair=EVAL_PAIRS - 1)
    log(f"[eval] wrote {EVAL_PAIRS} synthetic KITTI 2015 pairs at {KITTI_HW} (sparse gt; the last one's mostly "
        f"at maxdisp) in {time.perf_counter() - t0:.2f} s")
    model = DCANet(maxdisp=192, num_cva=3)
    if train_logdir is not None:
        newest = latest_checkpoint(train_logdir / "ckpt")
        step = checkpoint_step(newest)
        ckpt_args, infer_args = ["--ckpt", str(train_logdir / "ckpt")], ["--logdir", str(train_logdir)]
        model.load_state_dict(torch.load(newest, map_location="cpu", weights_only=True)["model"], strict=True)
    else:
        step, ckpt_args, infer_args = 0, [], []
        reference_init_(model, torch.Generator().manual_seed(0))  # eval's and infer's default seed
    model = model.cuda().eval()
    ds = cli.build_dataset(preset("kitti", dataset="kitti2015", data_root=str(root)), training=False)

    def run_eval(tag, dtype, logdir, images):
        """One eval command; returns its results and its peak memory above
        the memory held before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gwc.LAUNCHES = 0
        got = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(root), "--logdir",
                        str(logdir), "--dtype", dtype, "--log-images", str(images), "--device", "cuda", *ckpt_args])
        n = gwc.LAUNCHES
        launches[tag] = launches.get(tag, 0) + n
        if n != EVAL_PAIRS:
            raise AssertionError(f"[eval {tag}] gwc kernel launched {n} times for {EVAL_PAIRS} pairs")
        return got, torch.cuda.max_memory_allocated() - base

    out, launches = {}, {}
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        logdir = workdir / f"eval_{tag}"
        with cudnn_deterministic():
            got, _ = run_eval(tag, dtype, logdir, 2)
            want, kept, confusions = _eval_reference(model, ds, dtype == "bfloat16")
        if kept != EVAL_PAIRS - 1:
            raise AssertionError(f"[eval {tag}] the skip rule kept {kept} of {EVAL_PAIRS} pairs")
        rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
        log(f"[eval {tag}] metrics " + ", ".join(f"{k} {got[k]:.6f} (direct {want[k]:.6f}, rel {rel[k]:.1e})"
                                                 for k in want) + " (tolerance rel 1e-5)")
        if max(rel.values()) > 1e-5:
            raise AssertionError(f"[eval {tag}] metrics disagree with the direct model calls: {rel}")
        for vi, conf in enumerate(confusions):
            scores = segmentation_scores(torch.from_numpy(conf).float().cuda())
            wrong = {k: (got[f"vol{vi + 1}/{k}"], float(v)) for k, v in scores.items()
                     if got[f"vol{vi + 1}/{k}"] != float(v)}
            log(f"[eval {tag}] vol{vi + 1}: " + ", ".join(f"{k} {got[f'vol{vi + 1}/{k}']:.6f}" for k in scores)
                + f" over {int(conf.sum())} counted pixels; {'equal to' if not wrong else 'NOT equal to'} the "
                  "scores of a numpy count of the same logits")
            if wrong:
                raise AssertionError(f"[eval {tag}] vol{vi + 1} scores differ from the numpy count: {wrong}")
        panels = sorted((logdir / "images").iterdir())
        want_panels = [f"eval_sample{i}{s}_{step:08d}.png" for i in range(2)
                       for s in ("", "_probmass_vol1", "_probmass_vol2", "_probmass_vol3")]
        if [p.name for p in panels] != sorted(want_panels):
            raise AssertionError(f"[eval {tag}] panels {[p.name for p in panels]}, expected {sorted(want_panels)}")
        ch, cw = min(KITTI_H, KITTI_HW[0]), min(KITTI_W, KITTI_HW[1])  # the protocol's crop
        for name, shape in {p.name: read_png(p).shape for p in panels}.items():
            want_shape = (4 * ch, cw, 3) if "probmass" not in name else (ch // 8, cw // 8, 3)
            if shape != want_shape:
                raise AssertionError(f"[eval {tag}] panel {name}: {shape}, expected {want_shape}")
        # the time of the command as a user runs it: cuDNN's default
        # algorithms, no panels (with them, pair 2's panel PNGs fall inside
        # the timed pairs); its metrics may move by a pixel's count in f32
        timed, peak = run_eval(tag, dtype, workdir / f"eval_{tag}_timed", 0)
        parts = _eval_parts(model, ds, dtype == "bfloat16")
        moved = {k: abs(timed[k] - got[k]) / max(abs(got[k]), 1e-12) for k in want}
        if max(moved.values()) > 1e-3:
            raise AssertionError(f"[eval {tag}] the run with cuDNN's defaults moved the metrics: {moved}")
        out[tag] = dict(ms_per_pair=timed["ms_per_pair"], pairs_per_s=timed["pairs_per_s"], peak_bytes=peak,
                        ms_per_pair_with_panels=got["ms_per_pair"], metrics={k: got[k] for k in want},
                        miou=got["miou"], mpa=got["mpa"], **parts)
        log(f"[eval {tag}] cli eval, DCANet(num_cva=3, maxdisp=192), {EVAL_PAIRS} pairs at {ch}x{cw}: "
            f"{timed['ms_per_pair']:.3f} ms/pair, {timed['pairs_per_s']:.3f} pairs/s (host clock, pairs "
            f"2-{EVAL_PAIRS}: decode, transform, forward, metrics; {got['ms_per_pair']:.3f} ms/pair with "
            f"--log-images 2 and cuDNN's deterministic algorithms), peak memory {peak / 2**30:.3f} GiB above the "
            f"memory held before; metrics within rel {max(moved.values()):.1e} of the deterministic run's; "
            f"{launches[tag]} gwc launches in the two; {len(panels)} readable PNG panels; {gpu_line()}")
        log(f"[eval {tag}] parts: decode + transform of a pair {parts['host_ms']:.3f} ms (host, median), the "
            f"forward alone {parts['forward_ms']:.3f} ms (CUDA events, median of 5)")

    # the list and the single requests it is held against, bit for bit
    with cudnn_deterministic():
        lst = workdir / "test.txt"
        lst.write_text("\n".join(EVAL_LIST) + "\n")
        gwc.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["infer", "--list", str(lst), "--data-root", str(root), "--save-path", str(workdir / "submission"),
                  "--device", "cuda", *infer_args])
        launches["infer_list"] = gwc.LAUNCHES
        wall = time.perf_counter() - t0
        if launches["infer_list"] != len(EVAL_LIST):
            raise AssertionError(f"[eval] infer --list launched gwc {launches['infer_list']} times for "
                                 f"{len(EVAL_LIST)} names")

        def single(name, *weights):
            png = workdir / "single.png"
            cli.main(["infer", "--left", str(root / "image_2" / name), "--right", str(root / "image_3" / name),
                      "--out", str(png), "--submission", "--device", "cuda", *weights])
            return read_png(png)

        for name in EVAL_LIST:
            listed = read_png(workdir / "submission" / name)
            same = np.array_equal(listed, single(name, *infer_args))
            if listed.shape != KITTI_HW or listed.dtype != np.uint16 or not same:
                raise AssertionError(f"[eval] infer --list's {name} differs from a single --submission request")
        log(f"[eval] infer --list over {len(EVAL_LIST)} names: {wall:.3f} s wall, {launches['infer_list']} gwc "
            "launches (cuDNN's deterministic algorithms); each PNG equal to a single infer --submission request, "
            "bit for bit")
        if train_logdir is not None:
            export = workdir / "export.pt"
            cli.main(["export", "--logdir", str(train_logdir), "--out", str(export)])
            if not np.array_equal(single(EVAL_LIST[0], "--weights", str(export)), single(EVAL_LIST[0], *infer_args)):
                raise AssertionError("[eval] infer --weights <export> differs from infer --logdir")
            log(f"[eval] export of {train_logdir.name}'s step {step}: infer --weights on it equals infer --logdir, "
                "bit for bit")
    return dict(launches=launches, step=step, exported=train_logdir is not None, **out)


def family_eval(name: str, tl, tr) -> dict:
    """One registry model at full width, eval at 1x3x384x1248 in bf16 and f32:
    shape, finiteness, one gwc launch per forward, ms/pair, pairs/s, peak
    memory, a profile; then the GPU model against the CPU model on a small
    pair. Returns its numbers and its gwc launches."""
    import torch

    from dcanet_tpu_torch import weights
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models.registry import make_model

    model = make_model(name, maxdisp=192)
    model.load_state_dict(weights.from_jax_variables(seeded_flax_variables(model, SEED), model), strict=True)
    gpu = model.eval().cuda()
    out, launches = {}, 0
    runs = [("bf16", True, True)] + ([("bf16 literal", True, False)] if name in FAMILY_FOLD_AB else [])
    for tag, bf16, fold in runs + [("f32", False, True)]:
        def fwd():
            with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
                return gpu(tl, tr)

        with fold_eval_bn(fold):
            gwc.LAUNCHES = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res = fwd()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            d = res.disparity
            if gwc.LAUNCHES != 1:
                raise AssertionError(f"[family {name} {tag}] gwc kernel launched {gwc.LAUNCHES} times in one forward")
            if d.shape != (1, 384, 1248) or d.dtype != torch.float32 or not bool(torch.isfinite(d).all()):
                raise AssertionError(f"[family {name} {tag}] disparity {tuple(d.shape)} {d.dtype}, "
                                     f"finite={bool(torch.isfinite(d).all())}")
            if name != "dcanet-g" and res.class_logits != ():
                raise AssertionError(f"[family {name} {tag}] class logits from a model that has none")
            iters = FAMILY_ITERS[name]
            ms = time_cuda(fwd, iters)
            if gwc.LAUNCHES != 3 + iters:
                raise AssertionError(f"[family {name} {tag}] {gwc.LAUNCHES} gwc launches for {3 + iters} forwards")
            prof = profile_call(fwd, f"family {name} {tag}")
            if gwc.LAUNCHES != 4 + iters:
                raise AssertionError(f"[family {name} {tag}] {gwc.LAUNCHES} gwc launches for {4 + iters} forwards")
            launches += gwc.LAUNCHES
            out[tag] = dict(ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak, profile=prof)
            log(f"[family] {name} eval {tag} 1x3x384x1248: {ms:.3f} ms/pair (median of {iters}), {1e3 / ms:.3f} "
                f"pairs/s, peak memory {peak / 2**30:.3f} GiB above weights, disparity range "
                f"[{float(d.min()):.3f}, {float(d.max()):.3f}], 1 gwc launch per forward")
    if name in FAMILY_FOLD_AB and out["bf16"]["profile"] and out["bf16 literal"]["profile"]:
        f, lit = out["bf16"], out["bf16 literal"]
        log(f"[family] {name} bf16 eval, BatchNorm folded against literal: {f['ms']:.3f} against {lit['ms']:.3f} "
            f"ms/pair, launches {f['profile']['launches']} against {lit['profile']['launches']}, device busy "
            f"{f['profile']['busy_ms'] / f['profile']['wall_ms']:.1%} against "
            f"{lit['profile']['busy_ms'] / lit['profile']['wall_ms']:.1%}, BatchNorm kernels "
            f"{f['profile']['bn_ms']:.3f} against {lit['profile']['bn_ms']:.3f} ms; card: {gpu_line()}")

    # the disparity (5e-3 px) and, since random weights saturate the softmax
    # and the disparity alone would not see a difference below it, the final
    # head's cost logits (1e-4 after scaling by max(|x|, 1)), as the CPU tests
    rng = np.random.default_rng(SEED + 4)
    sl, sr = (torch.from_numpy(rng.standard_normal((1, 3, 64, 256)).astype(np.float32)) for _ in range(2))
    head = getattr(model, FAMILY_HEAD[name])
    logits = []
    hook = head.register_forward_hook(lambda m, i, o: logits.append(o.detach().float().cpu()))
    with torch.inference_mode():
        want = model.cpu()(sl, sr).disparity
        gwc.LAUNCHES = 0
        got = model.cuda()(sl.cuda(), sr.cuda()).disparity.cpu()
    hook.remove()
    if gwc.LAUNCHES != 1:
        raise AssertionError(f"[family {name}] gwc kernel launched {gwc.LAUNCHES} times in the small forward")
    launches += 1
    err = float((got - want).abs().max())
    scale = max(float(logits[0].abs().max()), 1.0)
    logit_err = float((logits[1] - logits[0]).abs().max()) / scale
    log(f"[family] {name}: GPU vs CPU model, 1x3x64x256 f32: max |diff| {err:.3e} px (atol 5e-3); "
        f"{FAMILY_HEAD[name]} logits max |diff| {logit_err:.3e} after scaling by {scale:.3g} (atol 1e-4)")
    if not (err <= 5e-3 and logit_err <= 1e-4):
        raise AssertionError(f"[family {name}] GPU model disagrees with the CPU model on the small pair")
    out["small_err"], out["small_logit_err"] = err, logit_err
    out["small_bf16"] = folded_gpu_vs_cpu(model, sl, sr, f"family {name}")
    del model, gpu
    torch.cuda.empty_cache()
    return out, launches


def family_train(name: str, root: Path, workdir: Path) -> dict:
    """`cli train --preset sceneflow --model name`, one epoch at the preset's
    256x512 crop, f32: finite losses, one gwc forward and one backward
    launch per step, ms/step (median after the first step), peak memory;
    then one GPU train step against the CPU one."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.kernels import gwc

    gwc.LAUNCHES = gwc.BACKWARD_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = cli.main(["train", "--preset", "sceneflow", "--model", name, "--data-root", str(root), "--logdir",
                     str(workdir / f"family_{name}"), "--batch-size", "1", "--dtype", "float32", "--epochs", "1",
                     "--seed", str(SEED), "--print-freq", "1", "--num-workers", "4", "--device", "cuda"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd, steps = gwc.LAUNCHES, gwc.BACKWARD_LAUNCHES, len(hist)
    if steps != FAMILY_TRAIN_PAIRS or fwd != steps or bwd != steps:
        raise AssertionError(f"[family train {name}] {steps} steps, gwc forward {fwd} / backward {bwd} launches")
    for rec in hist:
        if not all(math.isfinite(rec[k]) for k in ("total", "smooth_l1", "grad_norm", "epe")):
            raise AssertionError(f"[family train {name}] step {rec['step']} is not finite: {rec}")
    ms, lo, hi = _median_gap_ms(hist, skip=0)
    log(f"[family] cli train --model {name} f32, 1x3x256x512 crops: {steps} steps, losses "
        + ", ".join(f"{r['total']:.4f}" for r in hist)
        + f"; {fwd} gwc forward and {bwd} gwc backward launches (1 each per step); median {ms:.3f} ms/step over "
        f"steps 1-{steps - 1} (range {lo:.3f}-{hi:.3f}), {1e3 / ms:.3f} pairs/s, peak memory "
        f"{peak / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    parity = phase_train_parity(name)
    return dict(steps=steps, ms=ms, pairs_per_s=1e3 / ms, peak_bytes=peak, fwd=fwd, bwd=bwd, parity=parity)


def phase_family(workdir: Path) -> dict:
    """The registry's other models on the card (see the module docstring,
    phase 8). Returns their numbers and the gwc launches of each path."""
    import torch

    from dcanet_tpu_torch import cli, weights
    from dcanet_tpu_torch.data.io import read_png, write_png
    from dcanet_tpu_torch.data.submission import from_submission_shape, to_submission_shape, whiten_per_channel
    from dcanet_tpu_torch.data.synthetic import write_kitti2015_tree, write_sceneflow_tree
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models.registry import make_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    left, right = synthetic_pair(SEED)
    tl, tr = (torch.from_numpy(to_submission_shape(whiten_per_channel(x))[0].transpose(2, 0, 1)[None].copy()).cuda()
              for x in (left, right))
    results, launches = {"eval": {}, "train": {}}, {}
    for name in FAMILY:
        results["eval"][name], n = family_eval(name, tl, tr)
        launches[f"family_eval {name}"] = n

    root = write_sceneflow_tree(workdir / "family_sceneflow", FAMILY_TRAIN_PAIRS, SCENEFLOW_HW, seed=SEED + 5)
    for name in FAMILY_TRAIN:
        results["train"][name] = r = family_train(name, root, workdir)
        launches[f"family_train {name}"] = r["fwd"]
        launches[f"family_train_backward {name}"] = r["bwd"]

    # one request of cli infer --submission with gwcnet-gc, against the model
    # run in-process on the same pair, both under cuDNN's deterministic
    # algorithms (the f32 transposed conv adds with atomics otherwise)
    model = make_model("gwcnet-gc", maxdisp=192)
    flat = seeded_flax_variables(model, SEED)
    wp, lp, rp, out = (workdir / n for n in ("gwcnet_gc.npz", "family_left.png", "family_right.png", "gwcnet.png"))
    np.savez(wp, **flat)
    write_png(lp, left)
    write_png(rp, right)
    model.load_state_dict(weights.from_jax_variables(flat, model), strict=True)
    model = model.eval().cuda()
    with cudnn_deterministic():
        gwc.LAUNCHES = 0
        t0 = time.perf_counter()
        cli.main(["infer", "--left", str(lp), "--right", str(rp), "--out", str(out), "--submission", "--model",
                  "gwcnet-gc", "--weights", str(wp), "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches["family_serving gwcnet-gc"] = gwc.LAUNCHES
        with torch.inference_mode():
            ref = from_submission_shape(model(tl, tr).disparity[0].float().cpu().numpy(), KITTI_HW)
    if launches["family_serving gwcnet-gc"] != 1:
        raise AssertionError(f"[family] infer gwcnet-gc launched gwc {launches['family_serving gwcnet-gc']} times")
    png = read_png(out)
    close = np.abs(png.astype(np.float32) / 256.0 - np.clip(ref, 0, 65535 / 256.0)) <= 1.0 / 128
    log(f"[family] cli infer --submission --model gwcnet-gc: {wall:.3f} s wall incl. model build, {png.shape} "
        f"{png.dtype}, {close.mean():.4%} of pixels within 1/128 px of the model run in-process, 1 gwc launch")
    if png.shape != KITTI_HW or png.dtype != np.uint16 or close.mean() < 0.99:
        raise AssertionError("[family] the gwcnet-gc request disagrees with the model run in-process")
    del model
    torch.cuda.empty_cache()

    # cli eval with ganet on two KITTI 2015 pairs: one gwc launch per pair, no
    # class scores
    kitti = write_kitti2015_tree(workdir / "family_kitti", FAMILY_EVAL_PAIRS, KITTI_HW, seed=SEED + 6)
    gwc.LAUNCHES = 0
    res = cli.main(["eval", "--preset", "kitti", "--dataset", "kitti2015", "--data-root", str(kitti), "--model",
                    "ganet", "--logdir", str(workdir / "family_eval_ganet"), "--device", "cuda"])
    launches["family_cli_eval ganet"] = gwc.LAUNCHES
    if gwc.LAUNCHES != FAMILY_EVAL_PAIRS or any(k.startswith("vol") or k == "miou" for k in res):
        raise AssertionError(f"[family] cli eval --model ganet: {gwc.LAUNCHES} gwc launches, keys {sorted(res)}")
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"[family] cli eval --model ganet: {res}")
    log(f"[family] cli eval --model ganet, {FAMILY_EVAL_PAIRS} KITTI pairs: epe {res['epe']:.4f}, d1 {res['d1']:.4f}, "
        f"{res['ms_per_pair']:.3f} ms/pair (host clock, pair 2), no class scores, {gwc.LAUNCHES} gwc launches")
    results["cli_eval_ganet"] = res
    results["launches"] = launches
    return results


def _scaled_err(got, want) -> float:
    """max |got - want| / max(max |want|, 1), on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


def _bn_statistics(module):
    return {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def phase_extras(workdir: Path) -> dict:
    """The extras on the card (see the module docstring, phase 9)."""
    import copy

    import torch

    from dcanet_tpu_torch import weights
    from dcanet_tpu_torch.models.registry import make_model
    from dcanet_tpu_torch.nn import context as C
    from dcanet_tpu_torch.nn import extras as X
    from dcanet_tpu_torch.utils import profiling, summary

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED + 11)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    vol = EXTRAS_VOLUME
    small_pair = draw(2, 3, 128, 256)
    cases = [  # name, module, inputs on the card, inputs of the GPU-vs-CPU comparison (None: the same)
        ("UNetFeatureExtractor", X.UNetFeatureExtractor(), [draw(2, 3, *EXTRAS_HW)], [small_pair]),
        ("PyramidPooling cat", X.PyramidPooling(128, (8, 4, 2, 1), "cat"), [draw(1, 128, 24, 78)], None),
        ("PyramidPooling sum", X.PyramidPooling(128, (8, 4, 2, 1), "sum"), [draw(1, 128, 24, 78)], None),
        ("MobileV2Residual", X.MobileV2Residual(32, 32), [draw(1, 32, 96, 312)], None),
        ("Hourglass2D", X.Hourglass2D(32), [draw(1, 32, 96, 312)], None),
        ("ImageLevelContext", C.ImageLevelContext(32, 32, 32), [draw(*vol)], None),
        ("DisparityLevelContext", C.DisparityLevelContext(32, vol[2]), [draw(*vol)], None),
        ("SELayerD", C.SELayerD(vol[2]), [draw(*vol)], None),
        ("SemanticLevelContextLocal", C.SemanticLevelContextLocal(32, 32, 32),
         [draw(*vol), draw(vol[0], *vol[2:])], None),
        ("NonLocalAttention", C.NonLocalAttention(32, 32, 32), [draw(*EXTRAS_NONLOCAL), draw(*EXTRAS_NONLOCAL)], None),
    ]
    results = {}
    for i, (name, module, inputs, compare) in enumerate(cases):
        flat = seeded_flax_variables(module, SEED + 20 + i)
        module.load_state_dict(weights.from_jax_variables(flat, module), strict=True)
        compare = inputs if compare is None else compare
        r = results[name] = {"shape": [list(t.shape) for t in inputs]}
        for mode in ("eval", "train"):
            cpu = copy.deepcopy(module).train(mode == "train")
            gpu = copy.deepcopy(module).cuda().train(mode == "train")
            with torch.no_grad():
                want, got = cpu(*compare), gpu(*(t.cuda() for t in compare))
                if isinstance(want, dict):
                    err = max(_scaled_err(got[k], want[k]) for k in want)
                else:
                    err = _scaled_err(got, want)
                stats_cpu, stats_gpu = _bn_statistics(cpu), _bn_statistics(gpu)
                stats_err = max((_scaled_err(stats_gpu[k], stats_cpu[k]) for k in stats_cpu), default=0.0)
                full = gpu(*(t.cuda() for t in inputs))
                outs = full.values() if isinstance(full, dict) else [full]
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
            log(f"[extras] {name} {mode}: GPU vs CPU {err:.3e} scaled (1e-4), BN statistics {stats_err:.3e} "
                f"(1e-4), output at {r['shape']} {[list(o.shape) for o in outs]} finite={finite}")
            if not (err <= 1e-4 and stats_err <= 1e-4 and finite):
                raise AssertionError(f"[extras] {name} {mode} disagrees with its CPU copy or is not finite")
            r[mode] = {"err": err, "bn_statistics_err": stats_err}
        if name == "UNetFeatureExtractor":
            quarter = (EXTRAS_HW[0] // 4, EXTRAS_HW[1] // 4)
            want_shapes = {"gwc_feature": (2, 160, *quarter), "concat_feature": (2, 12, *quarter)}
            if {k: tuple(v.shape) for k, v in full.items()} != want_shapes:
                raise AssertionError(f"[extras] UNetFeatureExtractor shapes {[tuple(v.shape) for v in outs]}")
        gpu = gpu.eval()
        args = [t.cuda() for t in inputs]

        def fwd(*a):
            with torch.no_grad():
                return gpu(*a)

        dt = profiling.device_time(fwd, *args)
        ms = time_cuda(lambda: fwd(*args), 10)
        log(f"[extras] {name} eval {r['shape']}: device_time {1e3 * dt:.3f} ms, time_cuda {ms:.3f} ms")
        if not (math.isfinite(dt) and dt > 0):
            raise AssertionError(f"[extras] device_time of {name} is {dt}")
        r.update(device_time_ms=1e3 * dt, time_cuda_ms=ms)
        del cpu, gpu, args, full
        torch.cuda.empty_cache()

    # UNetFeatureExtractor at full width: ms and peak memory in bf16 and f32;
    # one trace of its forward
    unet = cases[0][1].cuda().eval()
    pair = cases[0][2][0].cuda()
    for tag, bf16 in (("bf16", True), ("f32", False)):
        def unet_fwd():
            with torch.no_grad(), torch.autocast("cuda", torch.bfloat16, enabled=bf16):
                return unet(pair)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        unet_fwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = time_cuda(unet_fwd, 10)
        log(f"[extras] UNetFeatureExtractor 2x3x{EXTRAS_HW[0]}x{EXTRAS_HW[1]} {tag}: {ms:.3f} ms, "
            f"peak memory {peak / 2**30:.3f} GiB above weights and input")
        results["UNetFeatureExtractor"][f"full_{tag}"] = {"ms": ms, "peak_bytes": peak}
    tracedir = workdir / "extras_trace"
    with profiling.trace(str(tracedir)):
        unet(pair)
        torch.cuda.synchronize()
    files = sorted(tracedir.glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if files else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"[extras] utils.profiling.trace: {len(files)} file(s), {len(events)} events, {len(kernels)} CUDA kernel "
        f"events, {sum(e.get('dur', 0) for e in kernels) / 1e3:.3f} ms of kernels")
    if not kernels:
        raise AssertionError("[extras] the trace of UNetFeatureExtractor holds no CUDA kernel event")
    results["trace"] = {"events": len(events), "kernel_events": len(kernels)}
    del unet, pair
    torch.cuda.empty_cache()

    model = make_model("dcanet")
    text = summary.summarize(model, EXTRAS_HW, train=False)
    lines = text.splitlines()
    for line in lines[:8] + ["..."] + lines[-1:]:
        log(f"[extras] summarize: {line}")
    if summary.count_params(model) != sum(p.numel() for p in model.parameters()) or \
            f"(1, {EXTRAS_HW[0]}, {EXTRAS_HW[1]})" not in text:
        raise AssertionError("[extras] summarize of DCANet is wrong")
    results["dcanet_params"] = summary.count_params(model)
    log(f"[extras] card: {gpu_line()}")
    return results


def _parallel_batch(seed: int) -> dict:
    """The parity step's global batch of 2 at the crop: pair 0's gt all inside
    (0, 192), about a third of pair 1's at or above 192, so that the two
    ranks' valid-pixel counts differ."""
    import torch

    rng = np.random.default_rng(seed)
    h, w = PARALLEL_CROP
    disp = np.stack([rng.uniform(1.0, 190.0, (h, w)), rng.uniform(1.0, 288.0, (h, w))]).astype(np.float32)
    return {"left": torch.from_numpy(rng.standard_normal((2, 3, h, w)).astype(np.float32)),
            "right": torch.from_numpy(rng.standard_normal((2, 3, h, w)).astype(np.float32)),
            "disparity": torch.from_numpy(disp)}


def state_digest(state) -> str:
    """sha256 of the model's state_dict and the optimizer's state tensors."""
    import torch

    h = hashlib.sha256()
    tensors = list(state.model.state_dict().values())
    for st in state.optimizer.state_dict()["state"].values():
        tensors += [v for v in st.values() if torch.is_tensor(v)]
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step_record(state, batch: dict, cfg) -> dict:
    """One train step under cuDNN's deterministic algorithms: its metrics,
    the parameters' gradients and the BatchNorm statistics, on the CPU."""
    from dcanet_tpu_torch.train.loop import train_step

    with cudnn_deterministic():
        metrics = {k: float(v) for k, v in train_step(state, batch, cfg).items()}
    return {"metrics": metrics,
            "grads": {n: p.grad.to("cpu", copy=True) for n, p in state.model.named_parameters() if p.grad is not None},
            "stats": {k: v.to("cpu", copy=True) for k, v in state.model.state_dict().items() if "running" in k}}


def _bn_input_ratios(model) -> tuple:
    """Forward pre-hooks on every BatchNorm of `model` that record, per call,
    each channel's |mean| / std of its input; returns the list they fill
    and the hooks' handles."""
    import torch

    from dcanet_tpu_torch.nn.layers import _FlaxStatistics

    ratios = []

    def hook(_, inp):
        x = inp[0].detach().float()
        var, mean = torch.var_mean(x, dim=[0] + list(range(2, x.dim())), correction=0)
        ratios.append((mean.abs() / var.sqrt().clamp(min=1e-30)).cpu())

    return ratios, [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, _FlaxStatistics)]


def _parity_state(name: str, mesh, loadckpt):
    """The `name` preset's train state on the card from the seed's init, or
    with `loadckpt`'s weights, with the disparity-sharding plan of `mesh`'s
    disp axis where it has one; and the preset's loss config."""
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.checkpoint import load_params_only
    from dcanet_tpu_torch.train.loop import LossConfig

    cfg = preset(name, seed=SEED)
    state = cli.build_train_state(cfg, 1, "cuda", mesh)
    if loadckpt:
        load_params_only(loadckpt, state.model)
    return state, LossConfig(max_disp=cfg.maxdisp, sparse=cfg.sparse_gt, preset=cfg.loss_preset)


def _parity_step(batch: dict, bn_ratios: bool = False, mesh=None, name: str = "sceneflow", loadckpt=None,
                 timed: int = PARALLEL_WARMUP + PARALLEL_TIMED) -> dict:
    """One f32 train step (`_parity_state`: by default the seeded
    DCANet(num_cva=3, maxdisp=192) of the SceneFlow preset) on `batch` (this
    process's share), cuDNN's deterministic algorithms (with `bn_ratios`,
    its BatchNorm inputs' channel |mean| / std too); then `timed` more
    steps with cuDNN's defaults, each timed on the host clock between
    synchronisations, the first PARALLEL_WARMUP of them not kept."""
    import torch

    from dcanet_tpu_torch.train.loop import train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state, cfg = _parity_state(name, mesh, loadckpt)
    batch = {k: v.cuda() for k, v in batch.items()}
    ratios, hooks = _bn_input_ratios(state.model) if bn_ratios else ([], [])
    out = _step_record(state, batch, cfg)
    for h in hooks:
        h.remove()
    if ratios:
        out["bn_ratios"] = torch.cat(ratios).numpy()
    times = []
    for i in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(state, batch, cfg)
        torch.cuda.synchronize()
        if i >= PARALLEL_WARMUP:
            times.append(1e3 * (time.perf_counter() - t0))
    out["step_ms"] = times
    del state
    torch.cuda.empty_cache()
    return out


def _parity_step_f64(batch: dict, mesh=None, name: str = "sceneflow", loadckpt=None) -> dict:
    """One float64 train step of `_parity_state`'s model on `batch` (this
    process's share; with `mesh`'s disparity-sharding plan), cuDNN's
    deterministic algorithms, the gwc volume by its plain version (the
    kernels take f32 and bf16; the plain version computes float64 input in
    float64): float64 leaves the rounding of a 2-rank step against one
    process far below a fault in the global BatchNorm's backward, an
    exchange's gradient or the gradient all-reduce."""
    import torch

    from dcanet_tpu_torch.kernels.gwc import gwc_volume_reference
    from dcanet_tpu_torch.models import dcanet

    state, cfg = _parity_state(name, mesh, loadckpt)
    state.model.double()
    batch = {k: v.to("cuda", torch.float64) for k, v in batch.items()}
    kernel_gwc, dcanet.gwc_volume = dcanet.gwc_volume, gwc_volume_reference
    try:
        out = _step_record(state, batch, cfg)
    finally:
        dcanet.gwc_volume = kernel_gwc
    del state
    torch.cuda.empty_cache()
    return out


def _grads_digest(grads: dict) -> str:
    return hashlib.sha256(b"".join(g.numpy().tobytes() for g in grads.values())).hexdigest()


@contextlib.contextmanager
def writes_under(root: str, written: list):
    """Record into `written` each path under `root` that this process opens
    for writing, creates, replaces or deletes, for the duration."""
    import builtins

    saved = builtins.open, os.replace, os.makedirs, Path.mkdir, Path.unlink

    def spy(fn, writes=lambda *a, **k: True):
        def wrapper(*a, **k):
            if writes(*a, **k):
                written.extend(str(x) for x in a[:2] if str(x).startswith(root))
            return fn(*a, **k)
        return wrapper

    builtins.open = spy(builtins.open, lambda f, mode="r", *a, **k: any(c in mode for c in "wax+"))
    os.replace, os.makedirs = spy(os.replace), spy(os.makedirs)
    Path.mkdir, Path.unlink = spy(Path.mkdir), spy(Path.unlink)
    try:
        yield written
    finally:
        builtins.open, os.replace, os.makedirs, Path.mkdir, Path.unlink = saved


LOSS_TERMS = ("total", "focal", "smooth_l1")


def _rel_metrics(got: dict, want: dict, keys=LOSS_TERMS + ("grad_norm",)) -> dict:
    """Each of `keys` that `want` has, relative to it (the smooth-L1 preset
    has no focal term)."""
    return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys if k in want}


def _norm(t) -> float:
    return float(t.double().norm())


def _grad_rel(grads: dict, ref: dict):
    """The whole gradient's distance to `ref`'s and each parameter's,
    relative in L2 (a parameter's to max(its norm, 1e-6 of the whole): a
    conv bias before a BatchNorm has an exact gradient of 0)."""
    total = math.sqrt(sum(_norm(g) ** 2 for g in ref.values()))
    whole = math.sqrt(sum(_norm(grads[n] - g) ** 2 for n, g in ref.items())) / total
    each = {n: _norm(grads[n] - g) / max(_norm(g), 1e-6 * total) for n, g in ref.items()}
    return whole, each


def _worst(each: dict, k: int = 3) -> str:
    return ", ".join(f"{n} {v:.2e}" for n, v in sorted(each.items(), key=lambda kv: -kv[1])[:k])


def _hold_parity(tag: str, ranks: list, one: dict, one64: dict, grad_norm_bound: float = 1e-3) -> dict:
    """The ranks' parity steps (`_train_worker`) against one process's on
    the same global batch: the ranks hold the same summed gradients and
    report the same metrics; f32: the loss terms within 1e-4, the grad norm
    within `grad_norm_bound`, the BatchNorm statistics 1e-4 scaled (the
    gradient recorded); float64: the loss terms within 1e-7, the grad norm
    1e-6 (summed in f32), the statistics 1e-10, each parameter's gradient
    1e-7 relative in L2. Logs the distances and returns them."""
    two, two64 = ranks[0]["parity"], ranks[0]["parity64"]
    for key in ("parity", "parity64"):
        for r in ranks[1:]:
            if r[key]["grads_digest"] != _grads_digest(ranks[0][key]["grads"]):
                raise AssertionError(f"[{tag}] {key}: the ranks hold different summed gradients")
            if r[key]["metrics"] != ranks[0][key]["metrics"]:
                raise AssertionError(f"[{tag}] {key}: the ranks report different metrics")
    rel, rel64 = _rel_metrics(two["metrics"], one["metrics"]), _rel_metrics(two64["metrics"], one64["metrics"])
    stat_err = max(_scaled_err(two["stats"][k], one["stats"][k]) for k in one["stats"])
    stat_err64 = max(_scaled_err(two64["stats"][k], one64["stats"][k]) for k in one64["stats"])
    whole, each = _grad_rel(two["grads"], one["grads"])
    whole64, each64 = _grad_rel(two64["grads"], one64["grads"])
    m1, m2 = one["metrics"], two["metrics"]
    log(f"[{tag}] parity, one f32 step (cuDNN deterministic): {len(ranks)} ranks vs one process on the same global "
        f"batch: loss {m2['total']:.6f} vs {m1['total']:.6f}, grad norm {m2['grad_norm']:.6f} vs "
        f"{m1['grad_norm']:.6f}; relative " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; BatchNorm statistics {stat_err:.3e} scaled (bounds: loss terms 1e-4, grad norm {grad_norm_bound:g}, "
        f"statistics 1e-4). Recorded: the whole gradient {whole:.2e} relative in L2; each parameter's, worst "
        f"{_worst(each)}")
    log(f"[{tag}] parity in float64 (the gwc volume by its plain version): {len(ranks)} ranks vs one process: "
        f"relative " + ", ".join(f"{k} {v:.2e}" for k, v in rel64.items()) + f"; BatchNorm statistics "
        f"{stat_err64:.3e} scaled; the whole gradient {whole64:.2e}, each parameter's worst {_worst(each64)} "
        f"(bounds: loss terms 1e-7, grad norm 1e-6 (summed in f32), statistics 1e-10, each parameter 1e-7)")
    if (max(v for k, v in rel.items() if k != "grad_norm") > 1e-4 or rel["grad_norm"] > grad_norm_bound
            or stat_err > 1e-4):
        raise AssertionError(f"[{tag}] the {len(ranks)}-rank f32 step disagrees with the one-process step")
    if (max(v for k, v in rel64.items() if k != "grad_norm") > 1e-7 or rel64["grad_norm"] > 1e-6
            or stat_err64 > 1e-10 or max(each64.values()) > 1e-7):
        raise AssertionError(f"[{tag}] the float64 {len(ranks)}-rank step disagrees with the one-process step")
    return dict(rel=rel, stat_err=stat_err, whole_grad=whole, rel64=rel64, stat_err64=stat_err64,
                whole_grad64=whole64, worst_grad64=max(each64.values()))


def run_workers(tag: str, target, world: int, args: tuple, workdir: Path, timeout_s: float):
    """`target(rank, port, *args, out_path)` in `world` spawned processes
    that meet on a free local port, each joined within `timeout_s` of their
    start and killed after it: the results they saved, by rank, and their
    wall time. Raises unless every one exits 0 (its traceback is above)."""
    import multiprocessing

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    outs = [workdir / f"{tag}_rank{r}.pt" for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, port, *args, str(outs[r]))) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"[{tag}] worker exit codes {codes} (their tracebacks are above)")
    return [torch.load(o, weights_only=False) for o in outs], wall


def phase_parallel(workdir: Path) -> dict:
    """Data-parallel `cli train` over PARALLEL_WORLD processes on the one
    card (see the module docstring, phase 10). Returns its numbers."""
    import torch

    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    t0 = time.perf_counter()
    root = write_sceneflow_tree(workdir / "parallel_sceneflow", PARALLEL_PAIRS, SCENEFLOW_HW, seed=SEED + 1)
    batch = _parallel_batch(SEED + 4)
    batch_path = workdir / "parallel_batch.pt"
    torch.save(batch, batch_path)
    valid = ((batch["disparity"] > 0) & (batch["disparity"] < 192)).flatten(1).sum(1).tolist()
    log(f"[parallel] wrote {PARALLEL_PAIRS} synthetic SceneFlow pairs at {SCENEFLOW_HW} and a global batch of 2 "
        f"at {PARALLEL_CROP} (valid pixels per rank {valid}) in {time.perf_counter() - t0:.2f} s")

    one = _parity_step(batch, bn_ratios=True)  # one process, the whole global batch
    one64 = _parity_step_f64(batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    logdir = workdir / "parallel_run"
    args = ["train", "--preset", "sceneflow", "--data-root", str(root), "--logdir", str(logdir),
            "--batch-size", str(PARALLEL_WORLD), "--dtype", "float32", "--seed", str(SEED), "--print-freq", "1",
            "--num-workers", "4", "--device", "cuda"]
    runs = [args + ["--epochs", str(PARALLEL_EPOCHS)], args + ["--epochs", str(PARALLEL_EPOCHS + 1), "--resume"]]
    parity = dict(name="sceneflow", loadckpt=None, n_disp=1, batch=str(batch_path), batch64=str(batch_path),
                  timed=PARALLEL_WARMUP + PARALLEL_TIMED)
    ranks, wall = run_workers("parallel", _train_worker, PARALLEL_WORLD,
                              (PARALLEL_WORLD, runs, str(logdir), parity), workdir, PARALLEL_TIMEOUT_S)

    steps = PARALLEL_PAIRS // PARALLEL_WORLD * (PARALLEL_EPOCHS + 1)
    keys = ("total", "focal", "smooth_l1", "grad_norm", "epe")
    for r, res in enumerate(ranks):
        hist = sum(res["hists"], [])
        if [h["step"] for h in hist] != list(range(steps)):
            raise AssertionError(f"[parallel] rank {r} took steps {[h['step'] for h in hist]}")
        if not all(math.isfinite(h[k]) for h in hist for k in keys):
            raise AssertionError(f"[parallel] rank {r}: a metric is not finite")
        if res["fwd"] != steps or res["bwd"] != steps:
            raise AssertionError(f"[parallel] rank {r}: gwc forward {res['fwd']} / backward {res['bwd']} launches "
                                 f"in {steps} steps")
    h0 = sum(ranks[0]["hists"], [])
    for h in h0:
        log(f"[parallel] step {h['step']}: loss {h['total']:.4f} (focal {h['focal']:.4f}, smooth-L1 "
            f"{h['smooth_l1']:.4f}), grad norm {h['grad_norm']:.4f}, epe {h['epe']:.4f}")
    h1 = sum(ranks[1]["hists"], [])
    if [{k: h[k] for k in keys} for h in h0] != [{k: h[k] for k in keys} for h in h1]:
        raise AssertionError("[parallel] the ranks report different metrics")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("[parallel] the replicas' parameters, BatchNorm buffers or Adam state differ at the end")
    if ranks[1]["written"]:
        raise AssertionError(f"[parallel] rank 1 wrote {ranks[1]['written']}")
    ckpts = sorted(p.name for p in (logdir / "ckpt").iterdir())
    want = [f"ckpt_{PARALLEL_PAIRS // PARALLEL_WORLD * (e + 1):08d}.pt" for e in range(PARALLEL_EPOCHS + 1)]
    lines = len((logdir / "train_log.jsonl").read_text().splitlines())
    rows = len((logdir / "metrics.jsonl").read_text().splitlines())
    if ckpts != want or lines != steps or rows != steps:
        raise AssertionError(f"[parallel] checkpoints {ckpts} (expected {want}), {lines} train_log and {rows} "
                             f"metrics rows for {steps} steps")
    first = ranks[0]["hists"][0]
    cli_ms, lo, hi = _median_gap_ms(first, skip=0)
    log(f"[parallel] cli train over {PARALLEL_WORLD} ranks (gloo, one card), DCANet(num_cva=3, maxdisp=192) f32, "
        f"global batch {PARALLEL_WORLD}x3x{PARALLEL_CROP[0]}x{PARALLEL_CROP[1]}: {steps} steps per rank, gwc "
        f"forward / backward launches per rank {[(r['fwd'], r['bwd']) for r in ranks]} (1 each per step); "
        f"rank 0 median {cli_ms:.3f} ms/step over steps 1-{len(first) - 1} of the first run (host clock between "
        f"metric reads, range {lo:.3f}-{hi:.3f}); peak memory per rank "
        f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB; replicas bit-equal at the end "
        f"({ranks[0]['digest'][:12]}); rank 0 alone wrote {len(ranks[0]['written'])} paths, checkpoints {ckpts}; "
        f"the workers' wall time {wall:.1f} s")

    # parity: the 2-rank step against one process on the same global batch
    held = _hold_parity("parallel", ranks, one, one64)
    two = ranks[0]["parity"]
    # each f32 step's own distance to the float64 gradient of the same step
    one_vs64, one_each64 = _grad_rel(one["grads"], one64["grads"])
    two_vs64, two_each64 = _grad_rel(two["grads"], one64["grads"])
    ratios = one["bn_ratios"]
    ms1, ms2 = statistics.median(one["step_ms"]), statistics.median(two["step_ms"])
    log(f"[parallel] the f32 steps against the float64 step's gradient: one process {one_vs64:.2e} (worst "
        f"{_worst(one_each64)}), 2 ranks {two_vs64:.2e} (worst {_worst(two_each64)}); the BatchNorm inputs' channel "
        f"|mean| / std over the step's {len(ratios)} channels: max {ratios.max():.3f}, 99th percentile "
        f"{np.percentile(ratios, 99):.3f}, median {np.median(ratios):.3f}")
    log(f"[parallel] the step alone (batch on the card, cuDNN defaults, median of {PARALLEL_TIMED} after "
        f"{PARALLEL_WARMUP} warm-ups): one process at batch 2 {ms1:.3f} ms (range {min(one['step_ms']):.3f}-"
        f"{max(one['step_ms']):.3f}); 2 ranks sharing the card over gloo, rank 0 {ms2:.3f} ms (range "
        f"{min(two['step_ms']):.3f}-{max(two['step_ms']):.3f}); one card time-shared, not a multi-card number")
    log(f"[parallel] card: {gpu_line()}")
    return dict(steps=steps, launches=[(r["fwd"], r["bwd"]) for r in ranks], cli_ms=cli_ms,
                peak_bytes=[r["peak_bytes"] for r in ranks], parity=dict(held, one_vs64=one_vs64, two_vs64=two_vs64),
                bn_ratio_max=float(ratios.max()), step_ms={"one_process_batch2": ms1, "two_ranks": ms2},
                workers_s=wall)


def calibrate_batch_norm(model, left, right):
    """Every BatchNorm's running statistics set to those of one train-mode
    forward of (left, right), in place; the model returned in eval mode.
    Seeded statistics leave a full-width DCANet's activations unnormalised
    (class logits near 1e13, a one-hot softmax and whole-number
    disparities), where a comparison of two forwards sees little."""
    import torch
    from torch import nn

    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(left, right)
    for m, momentum in zip(norms, momenta):
        m.momentum = momentum
    return model.eval()


def _disp_eval_run(args: list, logdir: str) -> dict:
    """`cli eval` with `args` under cuDNN's deterministic algorithms: its
    results, the gwc launches (the count set to 0 before, read after) and
    each launch's planes, each pair's disparity and class confusions, the
    peak memory above what the process held before, the paths written
    under `logdir`."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.train import metrics

    planes, disps, confusions = [], [], []
    kernel, eval_one, confusion = gwc.gwc_volume_cuda, cli._eval_one, metrics.disparity_class_confusion

    def kernel_spy(*a, **k):
        out = kernel(*a, **k)
        planes.append(out.shape[2])
        return out

    def eval_one_spy(cfg, i, step, out, *rest):
        disps.append(out.disparity[0].float().to("cpu", copy=True))
        return eval_one(cfg, i, step, out, *rest)

    def confusion_spy(*a, **k):
        out = confusion(*a, **k)
        confusions.append(out.to("cpu", copy=True).numpy())
        return out

    gwc.gwc_volume_cuda, cli._eval_one, metrics.disparity_class_confusion = kernel_spy, eval_one_spy, confusion_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gwc.LAUNCHES = 0
    try:
        with cudnn_deterministic(), writes_under(logdir, []) as written:
            results = cli.main(args + ["--logdir", logdir])
        launches = gwc.LAUNCHES
    finally:
        gwc.gwc_volume_cuda, cli._eval_one, metrics.disparity_class_confusion = kernel, eval_one, confusion
    torch.cuda.synchronize()
    return dict(results=results, launches=launches, planes=planes, disps=disps, confusions=confusions,
                peak_bytes=torch.cuda.max_memory_allocated() - held, written=written)


def _disp_f64_forward(state_dict: dict, plan=None) -> dict:
    """One float64 eval forward of DCANet(num_cva=3, maxdisp=192) with
    `state_dict` on a seeded DISP_F64_HW pair, cuDNN's deterministic
    algorithms, the gwc volume by its plain version (the kernels take f32
    and bf16); with `plan`, this rank's share. Disparity and logits on the
    CPU."""
    import torch

    from dcanet_tpu_torch.kernels.gwc import gwc_volume_reference
    from dcanet_tpu_torch.models import DCANet, dcanet

    model = DCANet(maxdisp=192, num_cva=3, constrain_volume=plan)
    model.load_state_dict(state_dict, strict=True)
    model = model.to("cuda", torch.float64).eval()
    rng = np.random.default_rng(SEED + 7)
    left, right = (torch.from_numpy(rng.standard_normal((1, 3) + DISP_F64_HW)).cuda() for _ in range(2))
    kernel_gwc, dcanet.gwc_volume = dcanet.gwc_volume, gwc_volume_reference
    try:
        with cudnn_deterministic(), torch.inference_mode():
            out = model(left, right)
    finally:
        dcanet.gwc_volume = kernel_gwc
    return {"disparity": out.disparity.to("cpu", copy=True),
            "logits": [lg.to("cpu", copy=True) for lg in out.class_logits]}


def _disp_args(root: str, ckpt: str, dtype: str, n_disp: int) -> list:
    return ["eval", "--preset", "eth3d", "--dataset", "eth3d", "--data-root", root, "--ckpt", ckpt,
            "--dtype", dtype, "--n-disp-shards", str(n_disp), "--log-images", "1", "--device", "cuda"]


def _disp_worker(rank: int, port: int, root: str, ckpt: str, logdir: str, out_path: str) -> None:
    """One rank of phase 11: gloo on cuda:0 (the ranks share the card);
    `cli eval --n-disp-shards DISP_WORLD` in f32 and in bf16, then this
    rank's share of the float64 forward."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=DISP_WORLD)
    torch.cuda.set_device(0)
    from dcanet_tpu_torch.parallel import make_disp_constraint, make_mesh, shutdown
    from dcanet_tpu_torch.train.checkpoint import latest_checkpoint

    result = {tag: _disp_eval_run(_disp_args(root, ckpt, dtype, DISP_WORLD), f"{logdir}_{tag}")
              for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
    state = torch.load(latest_checkpoint(ckpt), weights_only=False)["model"]
    result["f64"] = _disp_f64_forward(state, make_disp_constraint(make_mesh(1, DISP_WORLD)))
    torch.save(result, out_path)
    shutdown()


def _eth3d_tree_and_checkpoint(workdir: Path, flat, pairs: int, tag: str):
    """A synthetic ETH3D tree of `pairs` scenes at ETH3D_HW and a checkpoint
    directory holding DCANet(num_cva=3, maxdisp=192) from the seeded `flat`
    with the BatchNorm statistics of one train-mode forward of pair 0 at
    the eval canvas (f32, TF32 off): (root, checkpoint directory, state_dict)."""
    import torch

    from dcanet_tpu_torch.data.datasets import StereoDataset, scan_eth3d
    from dcanet_tpu_torch.data.eval_protocol import eval_transform
    from dcanet_tpu_torch.data.synthetic import write_eth3d_tree
    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.weights import from_jax_variables

    t0 = time.perf_counter()
    root = write_eth3d_tree(workdir / f"{tag}_eth3d", pairs, ETH3D_HW, seed=SEED + 5, max_disp=120)
    left, right, _, _ = eval_transform(StereoDataset(scan_eth3d(str(root)), False, "eth3d")[0], "eth3d")
    model = DCANet(maxdisp=192, num_cva=3)
    model.load_state_dict(from_jax_variables(flat, model), strict=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calibrate_batch_norm(model.cuda(), *(torch.from_numpy(x[None]).cuda() for x in (left, right)))
    ckpt = workdir / f"{tag}_ckpt"
    ckpt.mkdir()
    state = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
    torch.save({"step": 0, "model": state}, ckpt / "ckpt_00000000.pt")
    del model
    torch.cuda.empty_cache()
    log(f"[{tag}] wrote {pairs} synthetic ETH3D scenes at {ETH3D_HW} (768x1024 canvas) and the seeded weights "
        f"with the BatchNorm statistics of one train-mode forward of pair 0 in {time.perf_counter() - t0:.2f} s")
    return root, ckpt, state


def phase_disp(workdir: Path, flat) -> dict:
    """Disparity-sharded `cli eval` over DISP_WORLD processes on the one card
    (see the module docstring, phase 11). Returns its numbers."""
    import torch

    t_phase = time.perf_counter()
    root, ckpt, state = _eth3d_tree_and_checkpoint(workdir, flat, DISP_PAIRS, "disp")

    one = {tag: _disp_eval_run(_disp_args(str(root), str(ckpt), dtype, 1), str(workdir / f"disp_one_{tag}"))
           for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
    one["f64"] = _disp_f64_forward(state)
    torch.cuda.empty_cache()

    logdir = workdir / "disp_ranks"
    ranks, wall = run_workers("disp", _disp_worker, DISP_WORLD, (str(root), str(ckpt), str(logdir)), workdir,
                              DISP_TIMEOUT_S)

    out = {"workers_s": wall}
    half = MAIN_D // DISP_WORLD
    for tag in ("f32", "bf16"):
        ref, runs = one[tag], [r[tag] for r in ranks]
        res = [r["results"] for r in runs]
        if res[0] != res[1]:
            raise AssertionError(f"[disp] {tag}: the ranks return different results")
        for r, run in enumerate(runs):
            if run["launches"] != DISP_PAIRS or run["planes"] != [half] * DISP_PAIRS:
                raise AssertionError(f"[disp] {tag} rank {r}: {run['launches']} gwc launches of {run['planes']} "
                                     f"planes for {DISP_PAIRS} pairs")
        if ref["launches"] != DISP_PAIRS or ref["planes"] != [MAIN_D] * DISP_PAIRS:
            raise AssertionError(f"[disp] {tag} one process: {ref['launches']} gwc launches of {ref['planes']} planes")
        if not all(torch.equal(a, b) for a, b in zip(runs[0]["disps"], runs[1]["disps"])):
            raise AssertionError(f"[disp] {tag}: the ranks' disparities differ")
        if runs[1]["written"]:
            raise AssertionError(f"[disp] {tag}: rank 1 wrote {runs[1]['written']}")
        if not all(math.isfinite(v) for v in res[0].values()):
            raise AssertionError(f"[disp] {tag}: a result is not finite: {res[0]}")
        metric_err = {k: abs(res[0][k] - ref["results"][k]) for k in ("epe", "d1", "thres1", "thres2", "thres3")}
        conf_err = float(max(np.abs(g - w).sum() / w.sum() for g, w in zip(runs[0]["confusions"], ref["confusions"])))
        disp_err = max(float((a - b).abs().max()) for a, b in zip(runs[0]["disps"], ref["disps"]))
        n_conf = len(ref["confusions"])
        log(f"[disp] cli eval --dtype {tag} over {DISP_WORLD} ranks (gloo, one card) against one process, "
            f"DCANet(num_cva=3, maxdisp=192), {DISP_PAIRS} pairs at 768x1024: EPE {res[0]['epe']:.6f} vs "
            f"{ref['results']['epe']:.6f}, differences " + ", ".join(f"{k} {v:.2e}" for k, v in metric_err.items())
            + f" (bounds 5e-3 px, 1e-3); confusions ({n_conf} = pairs x volumes) worst {conf_err:.2e} of the total "
            f"in L1 (bound 1e-2); disparity max |diff| {disp_err:.3e} px (recorded); gwc launches per rank "
            f"{[r['launches'] for r in runs]} of {half} planes (one process {ref['launches']} of {MAIN_D}); the "
            f"ranks' disparities bit-equal; rank 1 wrote nothing")
        if (metric_err["epe"] > 5e-3 or max(v for k, v in metric_err.items() if k != "epe") > 1e-3
                or len(runs[0]["confusions"]) != n_conf or conf_err > 1e-2):
            raise AssertionError(f"[disp] {tag}: the sharded eval disagrees with one process")
        peaks = [r["peak_bytes"] for r in runs]
        log(f"[disp] {tag}: peak memory per rank {[round(p / 2**30, 3) for p in peaks]} GiB against one process "
            f"{ref['peak_bytes'] / 2**30:.3f} GiB ({max(peaks) / ref['peak_bytes']:.1%}); ms/pair (host clock "
            f"after the first pair, cuDNN deterministic) {res[0].get('ms_per_pair', float('nan')):.3f} on "
            f"{DISP_WORLD} ranks time-sharing the card, one process {ref['results'].get('ms_per_pair', float('nan')):.3f}")
        out[tag] = dict(metric_err=metric_err, confusion_err=conf_err, disparity_err=disp_err,
                        launches=[r["launches"] for r in runs], one_launches=ref["launches"], peak_bytes=peaks,
                        one_peak_bytes=ref["peak_bytes"], ms_per_pair=res[0].get("ms_per_pair"),
                        one_ms_per_pair=ref["results"].get("ms_per_pair"), epe=res[0]["epe"])

    want = one["f64"]
    disp64 = max(float((r["f64"]["disparity"] - want["disparity"]).abs().max()) for r in ranks)
    logit64 = max(_scaled_err(g, w) for r in ranks for g, w in zip(r["f64"]["logits"], want["logits"]))
    log(f"[disp] float64 forward at {DISP_F64_HW} (plain gwc volume), {DISP_WORLD} ranks against one process: "
        f"disparity max |diff| {disp64:.3e} px (bound 1e-9), class logits {logit64:.3e} scaled (bound 1e-10)")
    if disp64 > 1e-9 or logit64 > 1e-10 or any(len(r["f64"]["logits"]) != 3 for r in ranks):
        raise AssertionError("[disp] the float64 sharded forward disagrees with one process")
    log(f"[disp] card: {gpu_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    out.update(f64_disparity_err=disp64, f64_logits_err=logit64)
    return out


def _disp_train_args(root: str, n_disp: int, logdir: str) -> list:
    """Phase 12's `cli train` runs: DISP_TRAIN_EPOCHS epochs, then a resumed
    one."""
    args = ["train", "--preset", "sceneflow", "--data-root", root, "--logdir", logdir, "--batch-size", "1",
            "--dtype", "float32", "--seed", str(SEED), "--print-freq", "1", "--num-workers", "4",
            "--n-disp-shards", str(n_disp), "--device", "cuda"]
    return [args + ["--epochs", str(DISP_TRAIN_EPOCHS)], args + ["--epochs", str(DISP_TRAIN_EPOCHS + 1), "--resume"]]


def _train_run(runs: list, logdir: str = None, last: list = None) -> dict:
    """`cli train` with each argument list of `runs` in turn, in this
    process: the records of each run (`hists`), the gwc launches of all
    (the counts set to 0 before, read after: forward, backward and the
    range backward's, and the first two by dtype), the train-mode
    BatchNorm kernels' launches and plain calls (`bn`), the planes of each
    forward and backward launch, the peak device memory above what the
    process held before, the final state's digest and, with `logdir`, the
    paths written under it; `last`, where given, receives the last step's
    (state, batch, loss config)."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.kernels import batchnorm, gwc
    from dcanet_tpu_torch.train import loop

    fwd_planes, bwd_planes, steps = [], [], [None]
    kernel, backward, real_step = gwc.gwc_volume_cuda, gwc.gwc_volume_backward_cuda, loop.train_step

    def kernel_spy(*a, **k):
        out = kernel(*a, **k)
        fwd_planes.append(out.shape[2])
        return out

    def backward_spy(grad, *a, **k):
        bwd_planes.append(grad.shape[2])
        return backward(grad, *a, **k)

    def step_spy(state, batch, cfg):
        steps[0] = (state, batch, cfg)
        return real_step(state, batch, cfg)

    gwc.gwc_volume_cuda, gwc.gwc_volume_backward_cuda, loop.train_step = kernel_spy, backward_spy, step_spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gwc.reset_launch_counts()
    batchnorm.reset_launch_counts()
    try:
        with writes_under(logdir, []) if logdir else contextlib.nullcontext([]) as written:
            hists = [cli.main(args) for args in runs]
        launches = dict(fwd=gwc.LAUNCHES, bwd=gwc.BACKWARD_LAUNCHES, range_bwd=gwc.RANGE_BACKWARD_LAUNCHES,
                        fwd_by_dtype=dict(gwc.LAUNCHES_BY_DTYPE), bwd_by_dtype=dict(gwc.BACKWARD_LAUNCHES_BY_DTYPE),
                        bn=bn_counts())
    finally:
        gwc.gwc_volume_cuda, gwc.gwc_volume_backward_cuda, loop.train_step = kernel, backward, real_step
    torch.cuda.synchronize()
    out = dict(hists=hists, fwd_planes=fwd_planes, bwd_planes=bwd_planes, written=written,
               digest=state_digest(steps[0][0]), peak_bytes=torch.cuda.max_memory_allocated() - held, **launches)
    if last is not None:
        last[:] = steps[0]
    del steps
    torch.cuda.empty_cache()
    return out


def _train_worker(rank: int, port: int, world: int, runs: list, logdir, parity: dict, out_path: str) -> None:
    """One rank of a phase's run over `world` processes that share the card
    (gloo on cuda:0): `cli train` with each argument list of `runs`
    (`_train_run`, the writes under `logdir` recorded); then, on a (world /
    n_disp, n_disp) mesh of `parity`'s n_disp, the parity steps of its
    `name` preset from its `loadckpt` (or the seed's init) on this rank's
    share of a global batch: `_parity_step` (with its `timed` steps) on the
    batch saved at its `batch`, `_parity_step_f64` on the one at its
    `batch64`. Rank 0's gradients stand for all: the others send their
    digest."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    torch.cuda.set_device(0)
    from dcanet_tpu_torch.parallel import make_mesh, shard_batch, shutdown

    result = _train_run(runs, logdir)
    mesh = make_mesh(world // parity["n_disp"], parity["n_disp"])
    kw = dict(mesh=mesh, name=parity["name"], loadckpt=parity["loadckpt"])
    share = {key: shard_batch(torch.load(parity[key], weights_only=True), mesh) for key in ("batch", "batch64")}
    result["parity"] = _parity_step(share["batch"], timed=parity["timed"], **kw)
    result["parity64"] = _parity_step_f64(share["batch64"], **kw)
    for key in ("parity", "parity64"):
        if rank != 0:
            result[key]["grads_digest"] = _grads_digest(result[key].pop("grads"))
    torch.save(result, out_path)
    shutdown()


def phase_disp_train(workdir: Path) -> dict:
    """Disparity-sharded `cli train` over DISP_TRAIN_WORLD processes on the
    one card (see the module docstring, phase 12). Returns its numbers."""
    import torch

    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = write_sceneflow_tree(workdir / "disp_train_sceneflow", DISP_TRAIN_PAIRS, SCENEFLOW_HW, seed=SEED + 1)
    batch = _parallel_batch(SEED + 4)
    batch_path = workdir / "disp_train_batch.pt"
    torch.save(batch, batch_path)

    one_run = _train_run(_disp_train_args(str(root), 1, str(workdir / "disp_train_one")))
    check_bn_counts("disp_train one process", one_run["bn"])
    one, one64 = _parity_step(batch), _parity_step_f64(batch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    logdir = workdir / "disp_train_ranks"
    parity = dict(name="sceneflow", loadckpt=None, n_disp=DISP_TRAIN_WORLD, batch=str(batch_path),
                  batch64=str(batch_path), timed=PARALLEL_WARMUP + PARALLEL_TIMED)
    ranks, wall = run_workers("disp_train", _train_worker, DISP_TRAIN_WORLD,
                              (DISP_TRAIN_WORLD, _disp_train_args(str(root), DISP_TRAIN_WORLD, str(logdir)),
                               str(logdir), parity), workdir, DISP_TRAIN_TIMEOUT_S)

    steps = DISP_TRAIN_PAIRS * (DISP_TRAIN_EPOCHS + 1)
    half = MAIN_D // DISP_TRAIN_WORLD
    keys = ("total", "focal", "smooth_l1", "grad_norm", "epe")
    for r, res in enumerate([one_run] + ranks):
        who = "one process" if r == 0 else f"rank {r - 1}"
        hist = sum(res["hists"], [])
        if [h["step"] for h in hist] != list(range(steps)):
            raise AssertionError(f"[disp_train] {who} took steps {[h['step'] for h in hist]}")
        if not all(math.isfinite(h[k]) for h in hist for k in keys):
            raise AssertionError(f"[disp_train] {who}: a metric is not finite")
        planes = MAIN_D if r == 0 else half
        want = (steps, steps, 0 if r == 0 else steps, [planes] * steps, [planes] * steps)
        got = (res["fwd"], res["bwd"], res["range_bwd"], res["fwd_planes"], res["bwd_planes"])
        if got != want:
            raise AssertionError(f"[disp_train] {who}: gwc forward / backward / range backward launches and their "
                                 f"planes {got}, expected {want}")
    h0, h1 = (sum(r["hists"], []) for r in ranks)
    for h, w in zip(h0, sum(one_run["hists"], [])):
        log(f"[disp_train] step {h['step']}: loss {h['total']:.4f} (one process {w['total']:.4f}), grad norm "
            f"{h['grad_norm']:.4f} ({w['grad_norm']:.4f}), epe {h['epe']:.4f} ({w['epe']:.4f})")
    if [{k: h[k] for k in keys} for h in h0] != [{k: h[k] for k in keys} for h in h1]:
        raise AssertionError("[disp_train] the ranks report different metrics")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("[disp_train] the ranks' parameters, BatchNorm buffers or Adam state differ at the end")
    if ranks[1]["written"]:
        raise AssertionError(f"[disp_train] rank 1 wrote {ranks[1]['written']}")
    ckpts = sorted(p.name for p in (logdir / "ckpt").iterdir())
    want_ckpts = [f"ckpt_{DISP_TRAIN_PAIRS * (e + 1):08d}.pt" for e in range(DISP_TRAIN_EPOCHS + 1)]
    if ckpts != want_ckpts or len((logdir / "train_log.jsonl").read_text().splitlines()) != steps:
        raise AssertionError(f"[disp_train] checkpoints {ckpts} (expected {want_ckpts}) or train_log rows")

    ms2, ms1 = _median_gap_ms(ranks[0]["hists"][0], skip=0), _median_gap_ms(one_run["hists"][0], skip=0)
    peaks = [r["peak_bytes"] for r in ranks]
    log(f"[disp_train] cli train --n-disp-shards {DISP_TRAIN_WORLD} (gloo, one card), DCANet(num_cva=3, "
        f"maxdisp=192) f32, batch 1x3x256x512: {steps} steps per rank, gwc forward / backward launches per rank "
        f"{[(r['fwd'], r['range_bwd']) for r in ranks]} of {half} planes each (one process {one_run['fwd']} / "
        f"{one_run['bwd']} of {MAIN_D}, BatchNorm kernels {one_run['bn']['launches']} launches and "
        f"{one_run['bn']['plain_calls']} plain calls); rank 0 median {ms2[0]:.3f} ms/step (range "
        f"{ms2[1]:.3f}-{ms2[2]:.3f}), one process {ms1[0]:.3f} ({ms1[1]:.3f}-{ms1[2]:.3f}) (host clock between "
        f"metric reads, steps 1-"
        f"{DISP_TRAIN_PAIRS * DISP_TRAIN_EPOCHS - 1} of the first run); peak memory per rank "
        f"{[round(p / 2**30, 4) for p in peaks]} GiB, one process {one_run['peak_bytes'] / 2**30:.4f} GiB "
        f"({max(peaks) / one_run['peak_bytes']:.1%}); the ranks bit-equal at the end; rank 1 wrote nothing; "
        f"the workers' wall time {wall:.1f} s")

    held = _hold_parity("disp_train", ranks, one, one64)
    step1, step2 = statistics.median(one["step_ms"]), statistics.median(ranks[0]["parity"]["step_ms"])
    log(f"[disp_train] the step alone at batch 2 (cuDNN defaults, median of {PARALLEL_TIMED} after "
        f"{PARALLEL_WARMUP} warm-ups): one process {step1:.3f} ms, 2 disp ranks time-sharing the card {step2:.3f} ms")
    log(f"[disp_train] card: {gpu_line()}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(steps=steps, launches=[(r["fwd"], r["range_bwd"]) for r in ranks],
                one_launches=(one_run["fwd"], one_run["bwd"]), one_bn=one_run["bn"], ms_per_step=ms2[0],
                one_ms_per_step=ms1[0],
                peak_bytes=peaks, one_peak_bytes=one_run["peak_bytes"], parity=held,
                step_ms={"one_process_batch2": step1, "two_disp_ranks": step2}, workers_s=wall)


def card_rank(argv: list) -> None:
    """One rank of `_train_on_cards`, a process of its own: `cli train` with
    `argv` (less a leading `--at-peak`) through `_train_run`, then one line
    `CARD_RESULT {...}` with its peak device memory, gwc launches and their
    planes and, with `--at-peak`, what holds the memory at the peak of one
    more step on the last batch (`memory_at_peak`); then it leaves the
    group."""
    import torch

    from dcanet_tpu_torch.parallel import shutdown
    from dcanet_tpu_torch.train.loop import train_step

    # this rank's card before any CUDA call (as `parallel.initialize` will
    # choose it), so that no rank makes a context on another's card
    torch.cuda.set_device(int(os.environ.get("DCANET_PROCESS_ID", "0")) % torch.cuda.device_count())
    at_peak = argv[:1] == ["--at-peak"]
    last = []
    result = _train_run([argv[1:] if at_peak else argv], last=last)
    result["steps"] = len(result.pop("hists")[0])
    if at_peak:
        result["at_peak"] = memory_at_peak(lambda: train_step(*last), top=4)
    print("CARD_RESULT " + json.dumps(result), flush=True)
    shutdown()


def _train_on_cards(world: int, batch: int, roots: tuple, logdir: Path, steps: int, preset: str = "sceneflow",
                    dtype: str = "float32", n_disp: int = 1, loadckpt=None, epochs: int = 1, at_peak: bool = False):
    """`cli train --preset preset` as a user starts it on `world` cards: one
    process per card with the DCANET_* variables (NCCL), the same arguments:
    the tree `roots` (--data-root, and --data-root2 for kitti_mix's second),
    the global --batch-size, --dtype, --loadckpt, --epochs, `--n-disp-shards
    n_disp` (a (world / n_disp, n_disp) grid). Rank 0's metrics.jsonl rows
    (one per step, `steps` of them) and each rank's `card_rank` record."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.card_rank(sys.argv[1:])",
           *(["--at-peak"] if at_peak else []), "train", "--preset", preset, "--data-root", str(roots[0]),
           *(["--data-root2", str(roots[1])] if len(roots) > 1 else []), "--logdir", str(logdir),
           "--batch-size", str(batch), "--dtype", dtype, "--seed", str(SEED), "--print-freq", "1",
           "--num-workers", "4", "--epochs", str(epochs), "--n-disp-shards", str(n_disp),
           *(["--loadckpt", str(loadckpt)] if loadckpt else []), "--device", "cuda"]
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        if world > 1:
            env.update(DCANET_COORDINATOR=f"127.0.0.1:{port}", DCANET_NUM_PROCESSES=str(world),
                       DCANET_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(Path(__file__).resolve().parent),
                                      stdout=subprocess.PIPE, text=True))
    deadline = time.monotonic() + CARDS_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    tag = f"[cards] {preset} {dtype} on {world} card(s), batch {batch}, disp {n_disp}"
    if codes != [0] * world:
        raise AssertionError(f"{tag}: exit codes {codes}")
    ranks = [json.loads(line.split(" ", 1)[1]) for out in outs for line in out.splitlines()
             if line.startswith("CARD_RESULT ")]
    rows = [json.loads(line) for line in (logdir / "metrics.jsonl").read_text().splitlines()]
    if len(rows) != steps or not all(math.isfinite(r["train/total"]) for r in rows):
        raise AssertionError(f"{tag}: {len(rows)} rows for {steps} steps, or a loss that is not finite")
    if len(ranks) != world or any(r["steps"] != steps for r in ranks):
        raise AssertionError(f"{tag}: {len(ranks)} rank records, steps {[r['steps'] for r in ranks]}")
    return rows, ranks


def _eval_on_cards(world: int, root: Path, ckpt: Path, logdir: Path, dtype: str) -> dict:
    """`cli eval --dataset eth3d --n-disp-shards world` as a user starts it:
    one process per card with the DCANET_* variables (NCCL); rank 0's
    results (its metrics.jsonl row)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "dcanet_tpu_torch.cli", "eval", "--preset", "eth3d", "--dataset", "eth3d",
           "--data-root", str(root), "--ckpt", str(ckpt), "--logdir", str(logdir), "--dtype", dtype,
           "--n-disp-shards", str(world), "--device", "cuda"]
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        if world > 1:
            env.update(DCANET_COORDINATOR=f"127.0.0.1:{port}", DCANET_NUM_PROCESSES=str(world),
                       DCANET_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(Path(__file__).resolve().parent),
                                      stdout=subprocess.DEVNULL))
    deadline = time.monotonic() + CARDS_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"[cards] eval on {world} card(s), {dtype}: exit codes {codes}")
    row = json.loads((logdir / "metrics.jsonl").read_text().splitlines()[-1])
    return {k.split("/", 1)[1]: v for k, v in row.items() if k.startswith("eval/")}


def _cards_sceneflow(workdir: Path, flat, worlds: list) -> dict:
    """`--phases cards`: data-parallel `cli train`
    across the host's cards: DCANet(num_cva=3, maxdisp=192), the
    SceneFlow preset's 256x512 crop, f32 with TF32 off, 1 pair per card, on
    1, 2, 4, ... cards, CARDS_STEPS steps each (host clock between rank 0's
    metric rows, median after CARDS_WARMUP intervals): ms/step, pairs/s and
    pairs/s per card; the first step's loss terms on 2 cards against one
    card at --batch-size 2 (the same weights and global batch; rtol 1e-4).
    Then the disparity-sharded `cli eval --dataset eth3d` on 1, 2, 4, ...
    cards (NCCL, cuDNN's defaults, as a user runs it), f32 and bf16, on
    CARDS_EVAL_PAIRS scenes: ms/pair (rank 0's host clock after the first
    pair) and EPE, D1, >1/2/3 px against one card (5e-3 px, 1e-3). Between
    the two, on the training tree, the disparity-sharded `cli train`:
    `--n-disp-shards 2` on 2 cards at --batch-size 1, and a data=2 x disp=2
    grid on 4 cards at --batch-size 2, beside one card at the same batch:
    ms/step, each card's peak memory (`max_memory_allocated` of its
    process), and the first step's loss terms against one card (rtol
    1e-4)."""
    from dcanet_tpu_torch.data.synthetic import write_sceneflow_tree

    pairs = CARDS_STEPS * worlds[-1]
    root = write_sceneflow_tree(workdir / "cards_sceneflow", pairs, SCENEFLOW_HW, seed=SEED + 2)
    results = {}
    for world in worlds:
        rows, ranks = _train_on_cards(world, world, (root,), workdir / f"cards_{world}", pairs // world)
        peaks = [r["peak_bytes"] for r in ranks]
        ms, lo, hi = _median_gap_ms(rows)
        results[world] = dict(ms=ms, pairs_per_s=1e3 * world / ms, first=rows[0], peaks=peaks)
        log(f"[cards] {world} card(s), 1 pair each: {len(rows)} steps, median {ms:.3f} ms/step over steps "
            f"{CARDS_WARMUP + 1}-{len(rows) - 1} (range {lo:.3f}-{hi:.3f}), "
            f"{1e3 * world / ms:.3f} pairs/s, {1e3 / ms:.3f} pairs/s per card")
    one_rows, one_ranks = _train_on_cards(1, 2, (root,), workdir / "cards_1_batch2", pairs // 2)
    one_peaks = [r["peak_bytes"] for r in one_ranks]
    one = one_rows[0]
    two = results[2]["first"]
    rel = _rel_metrics(two, one, tuple(f"train/{k}" for k in LOSS_TERMS))
    base = results[1]["pairs_per_s"]
    log("[cards] scaling, pairs/s against one card: " + ", ".join(
        f"{w} cards {r['pairs_per_s'] / base:.3f}x ({r['pairs_per_s'] / (w * base):.1%} per card)"
        for w, r in results.items() if w > 1)
        + "; the first step on 2 cards against one card at batch 2, relative: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (bound 1e-4)")
    if max(rel.values()) > 1e-4:
        raise AssertionError("[cards] the 2-card step disagrees with one card at batch 2")

    one_card = {1: results[1], 2: dict(ms=_median_gap_ms(one_rows)[0], first=one,
                                       peaks=one_peaks)}  # one card at batch 1 and 2, from the runs above
    disp_train = {}
    for world, n_disp, batch in ((2, 2, 1), (4, 2, 2)):
        if world > worlds[-1]:
            continue
        rows, ranks = _train_on_cards(world, batch, (root,), workdir / f"cards_disp_{world}x{batch}", pairs // batch,
                                      n_disp=n_disp)
        peaks = [r["peak_bytes"] for r in ranks]
        ms, lo, hi = _median_gap_ms(rows)
        run = disp_train[world, batch] = dict(ms=ms, peaks=peaks, first=rows[0])
        base = one_card[batch]
        drel = _rel_metrics(run["first"], base["first"], tuple(f"train/{k}" for k in LOSS_TERMS))
        log(f"[cards] cli train --n-disp-shards {n_disp} on {world} card(s) (data={world // n_disp}), batch {batch}: "
            f"median {ms:.3f} ms/step over steps {CARDS_WARMUP + 1}-{len(rows) - 1} (range {lo:.3f}-{hi:.3f}; "
            f"one card at batch {batch} {base['ms']:.3f}); peak memory per card "
            f"{[round(p / 2**30, 4) for p in peaks]} GiB (one card {base['peaks'][0] / 2**30:.4f}); the first step "
            f"against one card, relative " + ", ".join(f"{k} {v:.2e}" for k, v in drel.items()) + " (bound 1e-4)")
        if max(drel.values()) > 1e-4:
            raise AssertionError(f"[cards] the disparity-sharded step on {world} cards disagrees with one card")

    eth3d, ckpt, _ = _eth3d_tree_and_checkpoint(workdir, flat, CARDS_EVAL_PAIRS, "cards_eval")
    evals = {}
    for dtype in ("float32", "bfloat16"):
        for world in worlds:
            res = evals[dtype, world] = _eval_on_cards(world, eth3d, ckpt, workdir / f"cards_eval_{dtype}_{world}",
                                                       dtype)
            one = evals[dtype, 1]
            err = {k: abs(res[k] - one[k]) for k in ("epe", "d1", "thres1", "thres2", "thres3")}
            log(f"[cards] cli eval --n-disp-shards {world} on {world} card(s), {dtype}, {CARDS_EVAL_PAIRS} pairs at "
                f"768x1024: {res['ms_per_pair']:.3f} ms/pair (one card {one['ms_per_pair']:.3f}), EPE "
                f"{res['epe']:.6f}; against one card " + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
                + " (bounds 5e-3 px, 1e-3)")
            if err["epe"] > 5e-3 or max(v for k, v in err.items() if k != "epe") > 1e-3:
                raise AssertionError(f"[cards] the sharded eval on {world} cards disagrees with one card")
    return {"runs": {w: {k: r[k] for k in ("ms", "pairs_per_s")} for w, r in results.items()},
            "first_step_rel": rel,
            "eval_ms_per_pair": {f"{d} {w}": r["ms_per_pair"] for (d, w), r in evals.items()},
            "one_card_peaks": {b: r["peaks"] for b, r in one_card.items()},
            "disp_train": {f"{w}x{b}": {k: r[k] for k in ("ms", "peaks")} for (w, b), r in disp_train.items()}}


def _preset_batch(name: str, roots: tuple, indices, crop=None) -> dict:
    """The samples `indices` of the `name` preset's training set under
    `roots` through its training transform (its crop, or `crop`), epoch
    seed SEED, stacked: a global batch on the host."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset

    ds = cli.build_dataset(preset(name, data_root=str(roots[0]), data_root2=str(roots[1]) if len(roots) > 1 else ""),
                           training=True)
    if crop:
        ds.cfg = dict(ds.cfg, crop=crop)
    ds.reseed(SEED)
    samples = [ds[i] for i in indices]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples])) for k in samples[0]}


def _cards_step_worker(rank: int, port: int, world: int, name: str, root: str, root2: str, batch_size: int,
                       out_path: str) -> None:
    """One card of `--phases cards_kitti`: NCCL over `world`
    processes, one a card (`parallel.initialize` from the DCANET_*
    variables); this card's share of the global batch of `batch_size` crops
    of the preset's training set, resident on the card: one f32 step from
    the seed's init (its loss terms, which must match one card's), then the
    bf16 step alone (`step_alone`, STEP_ALONE_WARMUP + STEP_ALONE_TIMED
    steps, the gradients all-reduced over the cards)."""
    import torch

    os.environ.update(DCANET_COORDINATOR=f"127.0.0.1:{port}", DCANET_NUM_PROCESSES=str(world),
                      DCANET_PROCESS_ID=str(rank))
    torch.cuda.set_device(rank)
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.parallel import initialize, make_mesh, shard_batch, shutdown
    from dcanet_tpu_torch.train.loop import LossConfig

    initialize(device="cuda")
    roots = (root, root2) if root2 else (root,)
    batch = shard_batch(_preset_batch(name, roots, range(batch_size)), make_mesh())
    first = _parity_step(batch, name=name, timed=0)["metrics"]
    cfg = preset(name, seed=SEED, dtype="bfloat16")
    loss_cfg = LossConfig(max_disp=cfg.maxdisp, sparse=cfg.sparse_gt, preset=cfg.loss_preset)
    alone = step_alone(cfg, {k: v.cuda() for k, v in batch.items()}, loss_cfg, STEP_ALONE_WARMUP + STEP_ALONE_TIMED,
                       STEP_ALONE_WARMUP)
    torch.save(dict(first=first, alone=alone), out_path)
    shutdown()


def _median_gap_ms(rows: list, skip: int = CARDS_WARMUP, epoch: int = 0) -> tuple:
    """The median and range of the host-clock intervals between consecutive
    records (`time`), the first `skip` left out; with `epoch` (the steps of
    an epoch), only the intervals inside an epoch of metrics.jsonl rows
    (`step` from 1) count."""
    gaps = [1e3 * (b["time"] - a["time"]) for a, b in zip(rows, rows[1:])
            if not epoch or (a["step"] - 1) // epoch == (b["step"] - 1) // epoch][skip:]
    return statistics.median(gaps), min(gaps), max(gaps)


def cards_kitti(workdir: Path, worlds: list) -> dict:
    """`--phases cards_kitti`: `cli train --preset kitti` at its
    global batch of KITTI_BATCH in bf16 from `--loadckpt` of a seeded
    model's weights, on 1, 2 and 4 cards (12, 6 and 3 pairs a card) under
    NCCL, on a procedural kitti_mix of CARDS_KITTI_TREE + CARDS_KITTI_TREE
    scenes at 376x1248, CARDS_KITTI_EPOCHS epochs: ms/step (host clock
    between rank 0's metric rows, median after CARDS_WARMUP intervals),
    pairs/s and the scaling against one card, each card's peak memory, one
    bf16 gwc forward and one backward launch a step on each card of 48
    planes; then on each card count the step alone (`_cards_step_worker`):
    the first f32 step's loss terms against one card at the same global
    batch (rtol 1e-4), the bf16 step alone's ms on a resident batch and
    each card's peak."""
    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.checkpoint import save_params_only

    k12, k15, _ = kitti_trees(workdir, CARDS_KITTI_TREE, 0)
    weights = workdir / "cards_kitti_weights.pt"
    save_params_only(weights, cli.build_train_state(preset("sceneflow", seed=SEED), 1, "cpu").model)
    steps = CARDS_KITTI_EPOCHS * (2 * CARDS_KITTI_TREE // KITTI_BATCH)
    runs = {}
    for world in worlds:
        rows, ranks = _train_on_cards(world, KITTI_BATCH, (k12, k15), workdir / f"cards_kitti_{world}", steps,
                                      preset="kitti", dtype="bfloat16", loadckpt=weights, epochs=CARDS_KITTI_EPOCHS)
        for r, res in enumerate(ranks):
            if (res["fwd_by_dtype"], res["bwd_by_dtype"], set(res["fwd_planes"])) != (
                    {"float32": 0, "bfloat16": steps}, {"float32": 0, "bfloat16": steps}, {MAIN_D}):
                raise AssertionError(f"[cards kitti] {world} card(s), rank {r}: gwc launches {res['fwd_by_dtype']} / "
                                     f"{res['bwd_by_dtype']}, planes {set(res['fwd_planes'])} in {steps} steps")
        ms, lo, hi = _median_gap_ms(rows)
        runs[world] = dict(ms=ms, ms_range=[lo, hi], pairs_per_s=1e3 * KITTI_BATCH / ms,
                           peaks=[r["peak_bytes"] for r in ranks], first=rows[0])
        log(f"[cards kitti] cli train --preset kitti --batch-size {KITTI_BATCH} --dtype bfloat16 --loadckpt on {world} "
            f"card(s) ({KITTI_BATCH // world} pairs each): {steps} steps, one bf16 gwc forward and backward a step on "
            f"each card; median {ms:.3f} ms/step over steps {CARDS_WARMUP + 1}-{steps - 1} (range {lo:.3f}-{hi:.3f}), "
            f"{1e3 * KITTI_BATCH / ms:.3f} pairs/s; peak per card {[round(p / 2**30, 4) for p in runs[world]['peaks']]} "
            "GiB")
    base = runs[1]["pairs_per_s"]
    log("[cards kitti] scaling, pairs/s against one card: " + ", ".join(
        f"{w} cards {r['pairs_per_s'] / base:.3f}x ({r['pairs_per_s'] / (w * base):.1%} per card)"
        for w, r in runs.items() if w > 1))
    alone = {}
    for world in worlds:
        per_card, wall = run_workers(f"cards_kitti_alone_{world}", _cards_step_worker, world,
                                     (world, "kitti", str(k12), str(k15), KITTI_BATCH), workdir, CARDS_TIMEOUT_S)
        first = per_card[0]["first"]
        if any(c["first"] != first for c in per_card[1:]):
            raise AssertionError(f"[cards kitti] {world} card(s): the cards report different first-step metrics")
        rel = _rel_metrics(first, alone[1]["first"], LOSS_TERMS) if world > 1 else {}
        alone[world] = dict(first=first, rel=rel, ms=[c["alone"]["ms"] for c in per_card],
                            peaks=[c["alone"]["peak_bytes"] for c in per_card])
        log(f"[cards kitti] the step alone on {world} card(s), {KITTI_BATCH // world} resident pairs each: bf16 median "
            f"{alone[world]['ms'][0]:.3f} ms over {STEP_ALONE_TIMED} steps after {STEP_ALONE_WARMUP} (rank 0; the "
            f"cards {[round(m, 3) for m in alone[world]['ms']]}), {1e3 * KITTI_BATCH / alone[world]['ms'][0]:.3f} "
            f"pairs/s, peak per card {[round(p / 2**30, 4) for p in alone[world]['peaks']]} GiB; cli train "
            f"{runs[world]['ms']:.3f} ms/step; the first f32 step's loss {first['total']:.6f}"
            + (", against one card " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + " (bound 1e-4)"
               if rel else "") + f"; workers {wall:.1f} s")
        if rel and max(rel.values()) > 1e-4:
            raise AssertionError(f"[cards kitti] the first f32 step on {world} cards disagrees with one card")
    return dict(runs={w: {k: r[k] for k in ("ms", "ms_range", "pairs_per_s", "peaks")} for w, r in runs.items()},
                alone=alone, steps=steps)


def cards_middlebury(workdir: Path, worlds: list) -> dict:
    """`--phases cards_middlebury`: `cli train --preset
    middlebury --n-disp-shards N` (maxdisp 240, the scenes halved, 320x704
    crops, D = 60) on N = 1, 2 and 4 cards under NCCL, every card on the
    same pair, in f32 and in bf16, CARDS_MIDDLEBURY_EPOCHS epochs of
    MIDDLEBURY_TREE procedural scenes: ms/step (host clock between rank 0's
    metric rows, median of the intervals inside an epoch after the first),
    each card's peak memory and what holds it (`memory_at_peak` of one more
    step), one gwc forward and one backward launch a step on each card of
    its planes (`MIDDLEBURY_SHARDS`; the range backward above one card), and
    the first f32 step's loss terms against one card (rtol 1e-4)."""
    from dcanet_tpu_torch.data.synthetic import write_procedural_middlebury_tree

    t0 = time.perf_counter()
    root = workdir / "cards_middlebury"
    if not root.exists():
        write_procedural_middlebury_tree(root, MIDDLEBURY_TREE, seed=BENCHMARK_SEEDS[0])
    log(f"[cards middlebury] {MIDDLEBURY_TREE} procedural scenes at 1988x2880 (seed {BENCHMARK_SEEDS[0]}), "
        f"{time.perf_counter() - t0:.1f} s")
    steps = CARDS_MIDDLEBURY_EPOCHS * MIDDLEBURY_TREE
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for world in worlds:
            rows, ranks = _train_on_cards(world, 1, (root,), workdir / f"cards_middlebury_{dtype}_{world}", steps,
                                          preset="middlebury", dtype=dtype, n_disp=world,
                                          epochs=CARDS_MIDDLEBURY_EPOCHS, at_peak=True)
            shares = MIDDLEBURY_SHARDS.get(world, ((0, MIDDLEBURY_D),))
            for r, (res, (lo, hi)) in enumerate(zip(ranks, shares)):
                want = (steps, steps, steps if world > 1 else 0, {hi - lo})
                got = (res["fwd_by_dtype"][dtype], res["bwd_by_dtype"][dtype], res["range_bwd"], set(res["fwd_planes"]))
                if got != want:
                    raise AssertionError(f"[cards middlebury] {dtype} on {world} card(s), rank {r}: gwc forward / "
                                         f"backward / range backward launches and planes {got}, expected {want}")
            ms, lo, hi = _median_gap_ms(rows, skip=1, epoch=MIDDLEBURY_TREE)
            run = runs[dtype, world] = dict(
                ms=ms, ms_range=[lo, hi], first=rows[0], peaks=[r["peak_bytes"] for r in ranks],
                at_peak=[r["at_peak"] for r in ranks],
                launches_per_step=[(r["fwd_by_dtype"][dtype] / steps, r["range_bwd"] / steps) for r in ranks])
            one = runs[dtype, 1]
            rel = _rel_metrics(rows[0], one["first"], tuple(f"train/{k}" for k in LOSS_TERMS))
            run["rel"] = rel
            log(f"[cards middlebury] cli train --preset middlebury --dtype {dtype} --n-disp-shards {world} on {world} "
                f"card(s): {steps} steps, gwc planes per card {[hi - lo for lo, hi in shares]}; median "
                f"{ms:.3f} ms/step over the intervals inside an epoch, the first left out (range {lo:.3f}-{hi:.3f}; "
                f"one card {one['ms']:.3f}); peak per card {[round(p / 2**30, 4) for p in run['peaks']]}"
                f" GiB (one card {one['peaks'][0] / 2**30:.4f}, {max(run['peaks']) / one['peaks'][0]:.1%}); the first "
                f"step against one card, relative " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
                + (" (bound 1e-4)" if dtype == "float32" else " (bf16, recorded)"))
            for r, at in enumerate(run["at_peak"]):
                log(f"[cards middlebury]   {dtype}, {world} card(s), rank {r}: one more step's peak "
                    f"{at['peak_bytes'] / 2**30:.4f} GiB; held by " + "; ".join(
                        f"{size / 2**20:.1f} MiB {site}" for site, size in at["sites"][:3]))
            if dtype == "float32" and max(rel.values()) > 1e-4:
                raise AssertionError(f"[cards middlebury] the first f32 step on {world} cards disagrees with one card")
    return {f"{d} {w}": {k: r[k] for k in ("ms", "ms_range", "peaks", "rel", "launches_per_step")} |
            {"at_peak": [{"peak_bytes": a["peak_bytes"], "sites": a["sites"][:3]} for a in r["at_peak"]]}
            for (d, w), r in runs.items()}


def phase_cards(workdir: Path, flat, phases: set) -> dict:
    """The manual measurements across the host's cards (two or more) that
    `phases` names, each on 1, 2 and 4 cards (and 8 where the host has
    them): `cards` (`_cards_sceneflow`), `cards_kitti` (`cards_kitti`),
    `cards_middlebury` (`cards_middlebury`, up to 4 cards). Writes
    chiprun_out/cards.json."""
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        raise AssertionError(f"[cards] needs two or more cards, found {cards}")
    worlds = [w for w in (1, 2, 4, 8) if w <= cards]
    out = {"card": f"{gpu_line()} x {cards}"}
    if "cards" in phases:
        out["sceneflow"] = _cards_sceneflow(workdir, flat, worlds)
    if "cards_kitti" in phases:
        out["kitti"] = cards_kitti(workdir, worlds)
    if "cards_middlebury" in phases:
        out["middlebury"] = cards_middlebury(workdir, [w for w in worlds if w <= 4])
    log(f"[cards] card: {out['card']}")
    out_path = Path(__file__).resolve().parent / "chiprun_out" / "cards.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    log(f"[cards] summary: {json.dumps(out)}")
    return out


def phase_curve(workdir: Path, out_path: Path) -> dict:
    """The port's training curve (manual: `--phases curve`; the default run
    never starts it): CURVE_TRAIN + CURVE_TEST procedural scenes at 320x640
    (`write_procedural_sceneflow_tree`, seed SEED), then
    `traincurve.run_curve`: `cli train --preset sceneflow --dtype bfloat16
    --batch-size CURVE_BATCH` for CURVE_EPOCHS epochs, each resumed from the
    last checkpoint, `cli eval` on the TEST split after each (epoch 0: the
    random init). On the trained checkpoint (ROADMAP Queue 3 item 13): `cli
    eval` on the TEST split in f32, in bf16 with the BatchNorm literal
    (DCANET_FOLD_EVAL_BN=0) and folded, each EPE, D1 and >1 px against the
    ground truth; then the folded bf16 forward on the card against the same
    forward on the CPU on CURVE_CPU_SCENES TEST scenes (mean |GPU - CPU|
    beside the CPU's own bf16-vs-f32 distance). Raises unless every score is
    finite and the last epoch's EPE is below the random init's; writes the
    results to `out_path`."""
    import copy

    import torch

    from dcanet_tpu_torch import cli, traincurve
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.data.eval_protocol import eval_transform
    from dcanet_tpu_torch.data.submission import unpad
    from dcanet_tpu_torch.data.synthetic import write_procedural_sceneflow_tree

    t0 = time.perf_counter()
    root = write_procedural_sceneflow_tree(workdir / "curve_tree", CURVE_TRAIN, CURVE_TEST, PROCEDURAL_HW, seed=SEED)
    log(f"[curve] wrote {CURVE_TRAIN} TRAIN + {CURVE_TEST} TEST procedural scenes at {PROCEDURAL_HW} in "
        f"{time.perf_counter() - t0:.1f} s")
    logdir = workdir / "curve_run"
    curve = traincurve.run_curve(str(root), CURVE_EPOCHS, CURVE_BATCH, "bfloat16", str(logdir), "cuda",
                                 print_freq=100, num_workers=6, say=log)
    if not all(math.isfinite(r[k]) for r in curve for k in ("val_epe", "val_d1", "val_thres1")):
        raise AssertionError("[curve] a score is not finite")
    if not curve[-1]["val_epe"] < curve[0]["val_epe"]:
        raise AssertionError(f"[curve] val EPE {curve[0]['val_epe']} -> {curve[-1]['val_epe']} did not fall")

    item13 = {}
    for tag, dtype, fold in (("f32", "float32", True), ("bf16 literal", "bfloat16", False),
                             ("bf16 folded", "bfloat16", True)):
        cfg = preset("sceneflow", data_root=str(root), dtype=dtype, logdir=str(workdir / f"curve_eval_{dtype}"),
                     seed=SEED)
        with fold_eval_bn(fold):
            r = cli.cmd_eval(cfg, ckpt=str(logdir / "ckpt"), device="cuda")
        item13[tag] = {k: float(r[k]) for k in ("epe", "d1", "thres1")} | {"ms_per_pair": r.get("ms_per_pair")}
        log(f"[curve] trained checkpoint, cli eval {tag}: EPE {r['epe']:.4f} px, D1 {r['d1']:.5f}, "
            f">1px {r['thres1']:.5f}")
    for a, b in (("bf16 folded", "f32"), ("bf16 folded", "bf16 literal")):
        log(f"[curve] EPE {a} - {b}: {item13[a]['epe'] - item13[b]['epe']:+.4f} px (the JAX package's bound 0.05 px)")

    newest = sorted((logdir / "ckpt").iterdir())[-1]
    model = cli.build_model("dcanet", 192, newest, torch.device("cpu"), SEED)
    ds = cli.build_dataset(preset("sceneflow", data_root=str(root)), training=False)
    gpu_model = copy.deepcopy(model).cuda()
    distances = []
    for i in range(CURVE_CPU_SCENES):
        left, right, gt, pads = eval_transform(ds[i], "sceneflow")
        tl, tr = (torch.from_numpy(np.ascontiguousarray(x[None])) for x in (left, right))
        disp = {}
        for dev, m, bf16 in (("cuda", gpu_model, True), ("cpu", model, True), ("cpu f32", model, False)):
            d = dev.split()[0]
            with torch.inference_mode(), torch.autocast(d, torch.bfloat16, enabled=bf16):
                disp[dev] = unpad(m(tl.to(d), tr.to(d)).disparity[0].float().cpu(), pads).numpy()
        mask = (gt > 0) & (gt < 192)
        row = {"gpu_vs_cpu_mean": float(np.abs(disp["cuda"] - disp["cpu"]).mean()),
               "gpu_vs_cpu_max": float(np.abs(disp["cuda"] - disp["cpu"]).max()),
               "cpu_bf16_vs_f32_mean": float(np.abs(disp["cpu"] - disp["cpu f32"]).mean()),
               **{f"epe_{k.replace(' ', '_')}": float(np.abs(v - gt)[mask].mean()) for k, v in disp.items()}}
        distances.append(row)
        log(f"[curve] TEST scene {i}, folded bf16 GPU vs CPU: mean {row['gpu_vs_cpu_mean']:.4f} px, max "
            f"{row['gpu_vs_cpu_max']:.4f} (the CPU's bf16 vs f32: {row['cpu_bf16_vs_f32_mean']:.4f}); EPE GPU "
            f"{row['epe_cuda']:.4f}, CPU {row['epe_cpu']:.4f}, CPU f32 {row['epe_cpu_f32']:.4f}")
    result = {"card": gpu_line(), "scenes": [CURVE_TRAIN, CURVE_TEST], "hw": list(PROCEDURAL_HW),
              "batch": CURVE_BATCH, "dtype": "bfloat16", "curve": curve, "item13": item13,
              "gpu_vs_cpu": distances}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2))
    log(f"[curve] summary: {json.dumps(result)}")
    return result


def kitti_trees(workdir: Path, n: int, n_val: int) -> tuple:
    """The procedural kitti_mix, `n` KITTI 2012 and `n` KITTI 2015 scenes, and
    `n_val` held-out KITTI 2015 scenes, at KITTI_TRAIN_HW
    (`write_procedural_kitti_tree`, the seeds of KITTI_SEEDS); each tree
    written once under `workdir`. Returns their roots."""
    import concurrent.futures

    from dcanet_tpu_torch.data.synthetic import write_procedural_kitti_tree

    t0 = time.perf_counter()
    roots = [workdir / f"{layout}_seed{seed}_{count}" for (layout, seed), count in zip(KITTI_SEEDS, (n, n, n_val))]
    with concurrent.futures.ThreadPoolExecutor(len(roots)) as pool:  # the trees' worker pools side by side
        for f in [pool.submit(write_procedural_kitti_tree, root, layout, count, KITTI_TRAIN_HW, seed=seed)
                  for root, (layout, seed), count in zip(roots, KITTI_SEEDS, (n, n, n_val)) if count and not root.exists()]:
            f.result()
    log(f"[kitti] procedural trees at {KITTI_TRAIN_HW}: {n} KITTI 2012 (seed {KITTI_SEEDS[0][1]}) + {n} KITTI 2015 "
        f"(seed {KITTI_SEEDS[1][1]}), {n_val} held-out KITTI 2015 (seed {KITTI_SEEDS[2][1]}), "
        f"{time.perf_counter() - t0:.1f} s")
    return tuple(roots)


@contextlib.contextmanager
def first_step_probe(record: list):
    """Within it, the first call of `train.loop.train_step` (which `cmd_train`
    imports at each call) appends what the step finds: the step count,
    the number of parameters with Adam state, the LR of the step, the loss
    config and the model's state_dict copied to the host."""
    from dcanet_tpu_torch.train import loop

    step_fn = loop.train_step

    def probe(state, batch, cfg):
        if not record:
            record.append(dict(step=state.step, adam_entries=len(state.optimizer.state), lr=state.lr_fn(state.step),
                               loss_cfg=cfg,
                               weights={k: v.to("cpu", copy=True) for k, v in state.model.state_dict().items()}))
        return step_fn(state, batch, cfg)

    loop.train_step = probe
    try:
        yield
    finally:
        loop.train_step = step_fn


def _run_leg(tag: str, name: str, args: list, batch: dict, batch64: dict, workdir: Path, n_disp: int = 1,
             loadckpt: str = None, grad_norm_bound: float = 1e-3) -> dict:
    """A phase's leg over LEG_WORLD ranks that share the card: the parity
    steps of one process on the whole global batches (f32 on `batch`,
    float64 on `batch64`), then `_train_worker` over the ranks: `cli train`
    with `args`, then the same steps on each rank's share with a mesh of
    `n_disp` disp ranks; checks the ranks' records (every step, finite,
    equal) and holds their parity steps to one process's (`_hold_parity`).
    Returns the ranks' results, one process's f32 metrics, the workers'
    wall time and the distances."""
    import torch

    paths = {key: workdir / f"{tag.replace(' ', '_')}_{key}.pt" for key in ("batch", "batch64")}
    torch.save(batch, paths["batch"])
    torch.save(batch64, paths["batch64"])
    one = _parity_step(batch, name=name, loadckpt=loadckpt, timed=0)
    one64 = _parity_step_f64(batch64, name=name, loadckpt=loadckpt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parity = dict(name=name, loadckpt=loadckpt, n_disp=n_disp, timed=0, **{k: str(p) for k, p in paths.items()})
    ranks, wall = run_workers(tag.replace(" ", "_"), _train_worker, LEG_WORLD, (LEG_WORLD, [args], None, parity),
                              workdir, LEG_TIMEOUT_S)
    keys = ("grad_norm", "epe") + tuple(k for k in LOSS_TERMS if k in one["metrics"])
    h0 = ranks[0]["hists"][0]
    for r, res in enumerate(ranks):
        hist = res["hists"][0]
        if [h["step"] for h in hist] != list(range(len(h0))) or not all(
                math.isfinite(h[k]) for h in hist for k in keys):
            raise AssertionError(f"[{tag}] rank {r}: steps {[h['step'] for h in hist]} or a metric not finite")
        if [{k: h[k] for k in keys} for h in hist] != [{k: h[k] for k in keys} for h in h0]:
            raise AssertionError(f"[{tag}] the ranks report different metrics")
    log(f"[{tag}] the parity steps from the same weights: f32 on the global batch of {len(batch['disparity'])} at "
        f"{tuple(batch['disparity'].shape[1:])}, float64 on the same samples at "
        f"{tuple(batch64['disparity'].shape[1:])}")
    held = _hold_parity(tag, ranks, one, one64, grad_norm_bound)
    return dict(ranks=ranks, one=one["metrics"], parity=held, wall=wall)


def kitti_leg(workdir: Path, k12: Path, k15: Path, weights: Path, one_peak: int) -> dict:
    """The kitti phase's leg: `cli train --preset kitti` over LEG_WORLD ranks
    on the one card (gloo), the global batch of KITTI_BATCH (6 a rank) in
    bf16 from `--loadckpt weights`, KITTI_LEG_EPOCHS epochs: every metric
    finite, the ranks' records equal, one bf16 gwc forward and one backward
    launch a step on each rank (48 planes), ms/step and each rank's peak
    beside the one-process run's (`one_peak`); the first step from the same
    weights against one process (`_run_leg`, phase 10's bounds): f32 on the
    global batch of KITTI_LEG_INDICES, float64 on the same samples at
    KITTI_LEG_F64_CROP."""
    steps = KITTI_LEG_EPOCHS * (2 * KITTI_TREE // KITTI_BATCH)
    args = ["train", "--preset", "kitti", "--data-root", str(k12), "--data-root2", str(k15), "--logdir",
            str(workdir / "kitti_leg_run"), "--loadckpt", str(weights), "--batch-size", str(KITTI_BATCH), "--dtype",
            "bfloat16", "--epochs", str(KITTI_LEG_EPOCHS), "--print-freq", "1", "--num-workers", "4", "--seed",
            str(SEED), "--device", "cuda"]
    roots = (k12, k15)
    leg = _run_leg("kitti leg", "kitti", args, _preset_batch("kitti", roots, KITTI_LEG_INDICES),
                   _preset_batch("kitti", roots, KITTI_LEG_INDICES, KITTI_LEG_F64_CROP), workdir,
                   loadckpt=str(weights))
    ranks = leg["ranks"]
    bf16 = {"float32": 0, "bfloat16": steps}
    for r, res in enumerate(ranks):
        got = (len(res["hists"][0]), res["fwd_by_dtype"], res["bwd_by_dtype"], set(res["fwd_planes"]))
        if got != (steps, bf16, bf16, {MAIN_D}):
            raise AssertionError(f"[kitti leg] rank {r}: steps, gwc launches by dtype and planes {got}, expected "
                                 f"{(steps, bf16, bf16, {MAIN_D})}")
    ms, lo, hi = _median_gap_ms(ranks[0]["hists"][0], skip=0)
    peaks = [r["peak_bytes"] for r in ranks]
    log(f"[kitti leg] cmd_train --preset kitti --batch-size {KITTI_BATCH} --dtype bfloat16 --loadckpt over "
        f"{LEG_WORLD} ranks (gloo, one card; {KITTI_BATCH // LEG_WORLD} pairs a rank): {steps} steps, gwc launches per "
        f"rank {[(r['fwd'], r['bwd']) for r in ranks]} (one bf16 forward and backward a step); rank 0 median "
        f"{ms:.3f} ms/step over steps 1-{steps - 1} (range {lo:.3f}-{hi:.3f}; one card time-shared); peak per rank "
        f"{[round(p / 2**30, 4) for p in peaks]} GiB (one process {one_peak / 2**30:.4f}); the workers' wall time "
        f"{leg['wall']:.1f} s; {gpu_line()}")
    return dict(steps=steps, launches=[(r["fwd"], r["bwd"]) for r in ranks], ms=ms, peak_bytes=peaks,
                parity=leg["parity"], workers_s=leg["wall"])


def middlebury_leg(workdir: Path, root: Path, one_peak: int) -> dict:
    """The middlebury phase's leg: `cli train --preset middlebury
    --n-disp-shards LEG_WORLD` over LEG_WORLD ranks on the one card (gloo),
    in bf16, one epoch of the phase's MIDDLEBURY_TREE scenes: every metric
    finite, the ranks' records equal, one bf16 gwc forward and one range
    backward a step on each rank of its planes (MIDDLEBURY_SHARDS: [0, 30)
    and [30, 60) of D = 60), ms/step and each rank's peak beside the
    one-process bf16 run's (`one_peak`); the first step from the seed's
    init against one process (`_run_leg`): f32 on one 320x704 crop (the f32
    grad norm within 3e-3, phase 14's bound at maxdisp 240), float64 on the
    same sample at MIDDLEBURY_PARITY_CROP."""
    steps = MIDDLEBURY_TREE
    args = ["train", "--preset", "middlebury", "--data-root", str(root), "--logdir", str(workdir / "middlebury_leg_run"),
            "--dtype", "bfloat16", "--n-disp-shards", str(LEG_WORLD), "--epochs", "1", "--print-freq", "1",
            "--num-workers", "4", "--seed", str(SEED), "--device", "cuda"]
    leg = _run_leg("middlebury leg", "middlebury", args, _preset_batch("middlebury", (root,), (0,)),
                   _preset_batch("middlebury", (root,), (0,), MIDDLEBURY_PARITY_CROP), workdir, n_disp=LEG_WORLD,
                   grad_norm_bound=3e-3)
    ranks = leg["ranks"]
    bf16 = {"float32": 0, "bfloat16": steps}
    for r, (res, (lo, hi)) in enumerate(zip(ranks, MIDDLEBURY_SHARDS[LEG_WORLD])):
        got = (len(res["hists"][0]), res["fwd_by_dtype"], res["bwd_by_dtype"], res["range_bwd"],
               set(res["fwd_planes"]), set(res["bwd_planes"]))
        want = (steps, bf16, bf16, steps, {hi - lo}, {hi - lo})
        if got != want:
            raise AssertionError(f"[middlebury leg] rank {r}: steps, gwc forward / backward launches by dtype, range "
                                 f"backward launches and planes {got}, expected {want}")
    ms, lo, hi = _median_gap_ms(ranks[0]["hists"][0], skip=0)
    peaks = [r["peak_bytes"] for r in ranks]
    log(f"[middlebury leg] cmd_train --preset middlebury --dtype bfloat16 --n-disp-shards {LEG_WORLD} (gloo, one "
        f"card): {steps} steps, gwc forward / range backward launches per rank "
        f"{[(r['fwd'], r['range_bwd']) for r in ranks]} of planes {MIDDLEBURY_SHARDS[LEG_WORLD]}; rank 0 "
        f"median {ms:.3f} ms/step over steps 1-{steps - 1} (range {lo:.3f}-{hi:.3f}; one card time-shared); peak per "
        f"rank {[round(p / 2**30, 4) for p in peaks]} GiB (one process {one_peak / 2**30:.4f}, "
        f"{max(peaks) / one_peak:.1%}); the workers' wall time {leg['wall']:.1f} s; {gpu_line()}")
    return dict(steps=steps, launches=[(r["fwd"], r["range_bwd"]) for r in ranks], ms=ms, peak_bytes=peaks,
                parity=leg["parity"], workers_s=leg["wall"])


def phase_kitti(workdir: Path, pretrain_logdir) -> dict:
    """The KITTI training stage (the `kitti` phase): `cli export` of the newest
    checkpoint under `pretrain_logdir` (phase 6's run; a seeded model's
    checkpoint when phase 6 does not run), then `cmd_train` with the kitti
    preset (kitti_mix, sparse gt, 5x / 10x focal, the piecewise LR, the
    random 256x512 crop) at its batch of KITTI_BATCH in bf16 from
    `loadckpt` of the export, KITTI_EPOCHS epochs with a checkpoint after
    each (`save_after_epoch=0`, as the fine-tune leg sets it), once without
    and once with `remat` from the same weights and batches: the weights
    before step 1 equal to the export bit for bit, no Adam state at step 0,
    the LR 1e-3, every metric finite, one bf16 gwc forward and one bf16
    backward launch per step and no f32 one (the counts of each run), the
    remat run's first loss within 1e-3 relative of the other's and its peak
    lower; ms/step (host clock between the steps' metric reads, median
    after TRAIN_WARMUP steps), pairs/s, peak memory. Then `cli eval --preset
    kitti --dataset kitti2015` in bf16 of the run's newest checkpoint on
    the KITTI_VAL held-out scenes: one bf16 gwc launch per pair, EPE, D1,
    ms/pair."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.kernels import batchnorm, gwc
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    k12, k15, val = kitti_trees(workdir, KITTI_TREE, KITTI_VAL)
    if pretrain_logdir is None:
        pretrain_logdir = workdir / "kitti_pretrain"
        CheckpointManager(pretrain_logdir / "ckpt").save(cli.build_train_state(preset("sceneflow", seed=SEED), 1,
                                                                                "cuda"))
    weights = workdir / "kitti_pretrained.pt"
    cli.main(["export", "--logdir", str(pretrain_logdir), "--out", str(weights)])
    export = torch.load(weights, map_location="cpu", weights_only=True)["state_dict"]
    steps_want = KITTI_EPOCHS * (2 * KITTI_TREE // KITTI_BATCH)
    keys = ("total", "focal", "smooth_l1", "grad_norm", "epe")
    runs = {}
    for remat in (False, True):
        tag = "remat" if remat else "no remat"
        logdir = workdir / f"kitti_run_{'remat' if remat else 'plain'}"
        cfg = preset("kitti", data_root=str(k12), data_root2=str(k15), batch_size=KITTI_BATCH, dtype="bfloat16",
                     logdir=str(logdir), epochs=KITTI_EPOCHS, loadckpt=str(weights), save_after_epoch=0,
                     print_freq=1, num_workers=8, seed=SEED, remat=remat)
        first = []
        gwc.reset_launch_counts()
        batchnorm.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with first_step_probe(first):
            hist = cli.cmd_train(cfg, "cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        fwd, bwd = dict(gwc.LAUNCHES_BY_DTYPE), dict(gwc.BACKWARD_LAUNCHES_BY_DTYPE)
        bn = check_bn_counts(f"kitti {tag}", bn_counts())
        steps = len(hist)
        for rec in hist:
            log(f"[kitti] {tag}, step {rec['step']}: " + ", ".join(f"{k} {rec[k]:.4f}" for k in keys))
        if steps != steps_want or not all(math.isfinite(r[k]) for r in hist for k in keys):
            raise AssertionError(f"[kitti] {tag}: {steps} steps (expected {steps_want}) or a metric not finite")
        start = first[0]
        same = start["weights"].keys() == export.keys() and all(torch.equal(start["weights"][k], export[k])
                                                                 for k in export)
        if not same or start["step"] != 0 or start["adam_entries"] != 0 or start["lr"] != 1e-3:
            raise AssertionError(f"[kitti] {tag}: the first step found weights equal to the export: {same}, step "
                                 f"{start['step']}, {start['adam_entries']} parameters with Adam state, lr {start['lr']}")
        if fwd != {"float32": 0, "bfloat16": steps} or bwd != {"float32": 0, "bfloat16": steps}:
            raise AssertionError(f"[kitti] {tag}: gwc launches by dtype: forward {fwd}, backward {bwd} in {steps} steps")
        ckpts = sorted(q.name for q in (logdir / "ckpt").iterdir())
        if len(ckpts) != KITTI_EPOCHS:
            raise AssertionError(f"[kitti] {tag}: checkpoints {ckpts}, expected one per epoch")
        ms, lo, hi = _median_gap_ms(hist, skip=TRAIN_WARMUP - 1)
        runs[tag] = dict(steps=steps, ms=ms, ms_range=[lo, hi],
                         pairs_per_s=1e3 * KITTI_BATCH / ms, peak_bytes=peak, fwd=fwd, bwd=bwd, bn=bn,
                         first_loss=hist[0]["total"], last_loss=hist[-1]["total"])
        log(f"[kitti] cmd_train --preset kitti --batch-size {KITTI_BATCH} --dtype bfloat16{' --remat' if remat else ''}"
            f" --loadckpt (the export, bit-equal at step 0; fresh Adam, lr {start['lr']}), {KITTI_BATCH}x3x256x512 crops"
            f" of kitti_mix: {steps} steps, gwc launches forward {fwd}, backward {bwd}, BatchNorm kernels "
            f"{bn['launches']} launches and {bn['plain_calls']} plain calls; median {ms:.3f} ms/step over "
            f"steps {TRAIN_WARMUP}-{steps - 1} (range {lo:.3f}-{hi:.3f}), "
            f"{1e3 * KITTI_BATCH / ms:.3f} pairs/s, peak memory {peak / 2**30:.4f} GiB; checkpoints {ckpts}")
    plain, rem = runs["no remat"], runs["remat"]
    loss_rel = abs(rem["first_loss"] - plain["first_loss"]) / abs(plain["first_loss"])
    log(f"[kitti] remat against none: first loss {rem['first_loss']:.6f} vs {plain['first_loss']:.6f} (relative "
        f"{loss_rel:.2e}, bound 1e-3); peak {rem['peak_bytes'] / 2**30:.4f} vs {plain['peak_bytes'] / 2**30:.4f} GiB "
        f"({rem['peak_bytes'] / plain['peak_bytes']:.3f}x); {rem['ms']:.3f} vs {plain['ms']:.3f} ms/step "
        f"({rem['ms'] / plain['ms']:.3f}x)")
    if loss_rel > 1e-3 or not rem["peak_bytes"] < plain["peak_bytes"]:
        raise AssertionError("[kitti] the remat run's first loss or its peak memory is off")
    leg = kitti_leg(workdir, k12, k15, weights, plain["peak_bytes"])

    gwc.reset_launch_counts()
    cfg = preset("kitti", dataset="kitti2015", data_root=str(val), dtype="bfloat16", batch_size=1, seed=SEED,
                 logdir=str(workdir / "kitti_eval"))
    r = cli.cmd_eval(cfg, ckpt=str(workdir / "kitti_run_plain" / "ckpt"), device="cuda")
    eval_fwd = dict(gwc.LAUNCHES_BY_DTYPE)
    if eval_fwd != {"float32": 0, "bfloat16": KITTI_VAL} or not all(math.isfinite(r[k]) for k in ("epe", "d1")):
        raise AssertionError(f"[kitti] cli eval: gwc launches {eval_fwd} for {KITTI_VAL} pairs, or a score not finite")
    evaluation = {k: r.get(k) for k in ("epe", "d1", "thres1", "ms_per_pair", "pairs_per_s")}
    log(f"[kitti] cli eval --preset kitti --dataset kitti2015 --dtype bfloat16, {KITTI_VAL} held-out scenes, the "
        f"run's newest checkpoint: EPE {r['epe']:.4f} px, D1 {r['d1']:.5f}, {r['ms_per_pair']:.3f} ms/pair, gwc "
        f"launches {eval_fwd}")
    launches = dict(train_fwd=plain["fwd"]["bfloat16"] + rem["fwd"]["bfloat16"],
                    train_bwd=plain["bwd"]["bfloat16"] + rem["bwd"]["bfloat16"], eval=eval_fwd["bfloat16"],
                    train_bn={k: plain["bn"][k] + rem["bn"][k] for k in plain["bn"]},
                    leg_fwd=sum(f for f, _ in leg["launches"]), leg_bwd=sum(b for _, b in leg["launches"]))
    seconds = time.perf_counter() - t_phase
    log(f"[kitti] the phase took {seconds:.1f} s")
    return dict(runs=runs, remat_loss_rel=loss_rel, leg=leg, eval=evaluation, launches=launches, seconds=seconds)


def benchmark_trees(workdir: Path) -> tuple:
    """The middlebury phase's procedural trees, written side by side
    (`write_procedural_middlebury_tree`, `write_procedural_eth3d_tree`, the
    seeds of BENCHMARK_SEEDS): MIDDLEBURY_TREE Middlebury scenes to train on
    and MIDDLEBURY_VAL held out, full-resolution MiddEval3 frames, and
    ETH3D_TREE ETH3D two-view frames; each tree written once under
    `workdir`. Returns their roots."""
    import concurrent.futures

    from dcanet_tpu_torch.data.synthetic import write_procedural_eth3d_tree, write_procedural_middlebury_tree

    t0 = time.perf_counter()
    jobs = [(write_procedural_middlebury_tree, "middlebury_train", MIDDLEBURY_TREE, BENCHMARK_SEEDS[0]),
            (write_procedural_middlebury_tree, "middlebury_val", MIDDLEBURY_VAL, BENCHMARK_SEEDS[1]),
            (write_procedural_eth3d_tree, "eth3d_train", ETH3D_TREE, BENCHMARK_SEEDS[2])]
    roots = tuple(workdir / f"{name}_seed{seed}_{n}" for _, name, n, seed in jobs)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:  # the trees' worker pools side by side
        for f in [pool.submit(writer, root, n, seed=seed) for (writer, _, n, seed), root in zip(jobs, roots)
                  if not root.exists()]:
            f.result()
    log(f"[middlebury] procedural trees: {MIDDLEBURY_TREE} + {MIDDLEBURY_VAL} held-out Middlebury scenes at "
        f"1988x2880 (seeds {BENCHMARK_SEEDS[0]}, {BENCHMARK_SEEDS[1]}), {ETH3D_TREE} ETH3D scenes at 489x941 (seed "
        f"{BENCHMARK_SEEDS[2]}), {time.perf_counter() - t0:.1f} s")
    return roots


@contextlib.contextmanager
def train_waits():
    """Times what a `cmd_train` step can wait on besides the step itself, in
    host seconds: for each pass of the loader, the wait for each batch that
    `device_prefetch` pulls from it (it pulls batch j + 2 before it hands
    over batch j, so three before the first step of a pass) and the wait for
    its end (its decode pools shut down, before the step two from the end);
    and each checkpoint save. Yields the record, filled as the
    command runs: "loader" (a list of waits per pass), "loader_end" (one per
    pass), "checkpoint" (one per save)."""
    from dcanet_tpu_torch.data import loader as loader_module
    from dcanet_tpu_torch.train.checkpoint import CheckpointManager

    record = dict(loader=[], loader_end=[], checkpoint=[])
    prefetch, save = loader_module.device_prefetch, CheckpointManager.save

    def timed(iterable):
        waits = []
        record["loader"].append(waits)
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                record["loader_end"].append(time.perf_counter() - t0)
                return
            waits.append(time.perf_counter() - t0)
            yield batch

    def timed_save(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return save(self, *args, **kwargs)
        finally:
            record["checkpoint"].append(time.perf_counter() - t0)

    loader_module.device_prefetch = lambda iterator, *args, **kwargs: prefetch(timed(iterator), *args, **kwargs)
    CheckpointManager.save = timed_save
    try:
        yield record
    finally:
        loader_module.device_prefetch, CheckpointManager.save = prefetch, save


def _benchmark_train_run(tag: str, cfg, scenes: int) -> dict:
    """`cmd_train` with `cfg` on the card: every metric finite, one gwc
    forward and one backward launch per step, all of cfg.dtype (the counts
    of this run), one checkpoint per epoch; ms/step on the host clock
    between the steps' metric reads after TRAIN_WARMUP steps: the median of
    the intervals inside an epoch (the steady state) and the mean of all
    (epoch starts in); each epoch start's stall (its interval less the
    steady median) beside what the command waited on there (`train_waits`:
    the checkpoint save and the loader's first three batches of the new
    pass); the loader's waits inside a pass (for batch 3 on, each before the
    step two batches back, and its end); pairs/s at both; peak memory."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.data.datasets import PRESETS
    from dcanet_tpu_torch.kernels import batchnorm, gwc

    gwc.reset_launch_counts()
    batchnorm.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with train_waits() as waits:
        hist = cli.cmd_train(cfg, "cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = dict(gwc.LAUNCHES_BY_DTYPE), dict(gwc.BACKWARD_LAUNCHES_BY_DTYPE)
    bn = check_bn_counts(f"middlebury {tag}", bn_counts())
    steps, keys = len(hist), ("total", "smooth_l1", "grad_norm", "epe")
    for rec in hist:
        log(f"[middlebury] {tag}, step {rec['step']}: " + ", ".join(f"{k} {rec[k]:.4f}" for k in keys))
    if steps != cfg.epochs * scenes // cfg.batch_size or not all(math.isfinite(r[k]) for r in hist for k in keys):
        raise AssertionError(f"[middlebury] {tag}: {steps} steps or a metric not finite")
    other = "float32" if cfg.dtype == "bfloat16" else "bfloat16"
    if fwd != {cfg.dtype: steps, other: 0} or bwd != {cfg.dtype: steps, other: 0}:
        raise AssertionError(f"[middlebury] {tag}: gwc launches by dtype: forward {fwd}, backward {bwd} in {steps} "
                             "steps")
    ckpts = sorted(q.name for q in (Path(cfg.logdir) / "ckpt").iterdir())
    if len(ckpts) != cfg.epochs or len(waits["checkpoint"]) != cfg.epochs or len(waits["loader"]) != cfg.epochs:
        raise AssertionError(f"[middlebury] {tag}: checkpoints {ckpts}, {len(waits['loader'])} loader passes; "
                             "expected one of each per epoch")
    pairs = list(zip(hist, hist[1:]))[TRAIN_WARMUP - 1:]
    step_ms = [1e3 * (b["time"] - a["time"]) for a, b in pairs]
    steady = [t for t, (a, b) in zip(step_ms, pairs) if a["epoch"] == b["epoch"]]
    ms, mean_ms = statistics.median(steady), statistics.mean(step_ms)
    # each epoch start after the first: its interval, less the steady median, against what it waited on
    starts = []
    for a, b in zip(hist, hist[1:]):
        if a["epoch"] != b["epoch"]:
            e = b["epoch"]
            starts.append(dict(epoch=e, stall_s=(b["time"] - a["time"]) - ms / 1e3,
                               checkpoint_s=waits["checkpoint"][e - 1], first_batches_s=sum(waits["loader"][e][:3])))
    in_epoch = [w for passes in waits["loader"] for w in passes[3:]]
    crop = "x".join(map(str, PRESETS[cfg.dataset]["crop"]))
    log(f"[middlebury] cmd_train --preset {cfg.dataset} --dtype {cfg.dtype} (maxdisp {cfg.maxdisp}, half_res "
        f"{cfg.half_res}, {cfg.batch_size}x3x{crop} crops, {scenes} scenes): {steps} steps, gwc launches forward "
        f"{fwd}, backward {bwd}, BatchNorm kernels {bn['launches']} launches and {bn['plain_calls']} plain calls; "
        f"over steps {TRAIN_WARMUP}-{steps - 1}: steady median {ms:.3f} ms/step over "
        f"{len(steady)} intervals inside an epoch (range {min(steady):.3f}-{max(steady):.3f}), mean "
        f"{mean_ms:.3f} over all {len(step_ms)} (epoch starts in), {1e3 * cfg.batch_size / ms:.3f} / "
        f"{1e3 * cfg.batch_size / mean_ms:.3f} pairs/s; peak memory {peak / 2**30:.4f} GiB; checkpoints {ckpts}; "
        f"{gpu_line()}")
    for s in starts:
        log(f"[middlebury] {tag}, epoch {s['epoch']} starts: stall {s['stall_s']:.3f} s over the steady step; waited "
            f"on the checkpoint save {s['checkpoint_s']:.3f} s and the loader's first three batches "
            f"{s['first_batches_s']:.3f} s")
    log(f"[middlebury] {tag}: the loader's waits inside a pass (batch 3 on): "
        + (f"median {1e3 * statistics.median(in_epoch):.3f} ms, max {1e3 * max(in_epoch):.3f} ms over "
           f"{len(in_epoch)} batches" if in_epoch else "none")
        + f"; at each pass's end {', '.join(f'{1e3 * w:.3f}' for w in waits['loader_end'])} ms")
    return dict(steps=steps, ms=ms, mean_ms=mean_ms, ms_range=[min(steady), max(steady)],
                pairs_per_s=1e3 * cfg.batch_size / ms, pairs_per_s_mean=1e3 * cfg.batch_size / mean_ms,
                epoch_starts=starts, loader_waits_ms=[[1e3 * w for w in p] for p in waits["loader"]],
                loader_end_ms=[1e3 * w for w in waits["loader_end"]],
                peak_bytes=peak, fwd=fwd, bwd=bwd, bn=bn, first_loss=hist[0]["total"], last_loss=hist[-1]["total"])


def phase_middlebury(workdir: Path) -> dict:
    """The ETH3D and Middlebury stages (the `middlebury` phase; see the module
    docstring, phase 14): the trees (`benchmark_trees`); `cmd_train --preset
    middlebury` (DCANet(num_cva=3, maxdisp=240), the scenes halved, the
    320x704 crop, the smooth-L1 preset) in f32 and in bf16 for
    MIDDLEBURY_EPOCHS epochs and `--preset eth3d` in bf16 for one
    (`_benchmark_train_run`); the smooth-L1 step at maxdisp 240 on the card
    against the CPU on MIDDLEBURY_PARITY_DRAWS Middlebury crops cut to
    MIDDLEBURY_PARITY_CROP (`phase_train_parity`, phase 6's bounds but for
    the f32 grad norm, held against a float64 step on each crop); then
    `cli eval --preset middlebury` of the f32 run's newest checkpoint on the
    held-out scenes in f32 and in bf16 (the BatchNorm folded): one gwc
    launch of the run's dtype per pair, EPE, D1 and >1/2/3 px against direct
    model calls with numpy formulas (rel 1e-5) and the class scores against
    a numpy count of the same logits (exact), both under cuDNN's
    deterministic algorithms; ms/pair and peak memory of the command run
    again with cuDNN's defaults, and its parts (`_eval_parts`)."""
    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.data.eval_protocol import eval_transform
    from dcanet_tpu_torch.kernels import gwc
    from dcanet_tpu_torch.models import DCANet
    from dcanet_tpu_torch.train.checkpoint import checkpoint_step, latest_checkpoint
    from dcanet_tpu_torch.train.metrics import segmentation_scores

    t_phase = time.perf_counter()
    mb_train, mb_val, eth3d = benchmark_trees(workdir)
    marks = [("trees", time.perf_counter())]
    maxdisp = preset("middlebury").maxdisp
    halved = cli.build_dataset(preset("middlebury", data_root=str(mb_train)), training=False)
    known = past = 0
    for i in range(len(halved)):
        gt = halved[i]["disparity"]
        known, past = known + int((gt > 0).sum()), past + int((gt >= maxdisp).sum())
    log(f"[middlebury] the training scenes halved: {past / known:.4%} of the known gt pixels at or past maxdisp "
        f"{maxdisp} (masked by valid_mask)")
    if not past:
        raise AssertionError("[middlebury] no halved gt pixel past maxdisp: the mask's upper edge is not exercised")

    runs = {}
    for tag, name, root, dtype, epochs, scenes in (
            ("middlebury f32", "middlebury", mb_train, "float32", MIDDLEBURY_EPOCHS, MIDDLEBURY_TREE),
            ("middlebury bf16", "middlebury", mb_train, "bfloat16", MIDDLEBURY_EPOCHS, MIDDLEBURY_TREE),
            ("eth3d bf16", "eth3d", eth3d, "bfloat16", 1, ETH3D_TREE)):
        cfg = preset(name, data_root=str(root), dtype=dtype, logdir=str(workdir / f"{name}_run_{dtype}"),
                     epochs=epochs, print_freq=1, seed=SEED)
        runs[tag] = _benchmark_train_run(tag, cfg, scenes)
    marks.append(("cmd_train runs", time.perf_counter()))
    leg = middlebury_leg(workdir, mb_train, runs["middlebury bf16"]["peak_bytes"])
    marks.append(("disp-sharded leg", time.perf_counter()))

    ds = cli.build_dataset(preset("middlebury", data_root=str(mb_train)), training=True)
    ds.cfg = dict(ds.cfg, crop=MIDDLEBURY_PARITY_CROP)
    draws = []
    for i in range(MIDDLEBURY_PARITY_DRAWS):
        ds.reseed(i)
        draws.append({k: v[None] for k, v in ds[i % len(ds)].items()})
    parity = phase_train_parity(loss_preset="smooth_l1", maxdisp=maxdisp, batches=draws, float64_witness=True)
    marks.append(("parity", time.perf_counter()))

    # cli eval on the held-out scenes, f32 and bf16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = workdir / "middlebury_run_float32" / "ckpt"
    newest = latest_checkpoint(ckpt)
    model = DCANet(maxdisp=maxdisp, num_cva=3)
    model.load_state_dict(torch.load(newest, map_location="cpu", weights_only=True)["model"], strict=True)
    model = model.cuda().eval()
    val = cli.build_dataset(preset("middlebury", data_root=str(mb_val)), training=False)

    def run_eval(dtype, logdir):
        """One eval command; its results, its peak memory above the memory
        held before it and its gwc launches by dtype."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gwc.reset_launch_counts()
        got = cli.main(["eval", "--preset", "middlebury", "--data-root", str(mb_val), "--logdir", str(logdir),
                        "--dtype", dtype, "--ckpt", str(ckpt), "--device", "cuda"])
        launches = dict(gwc.LAUNCHES_BY_DTYPE)
        other = "float32" if dtype == "bfloat16" else "bfloat16"
        if launches != {dtype: MIDDLEBURY_VAL, other: 0}:
            raise AssertionError(f"[middlebury eval] gwc launches {launches} for {MIDDLEBURY_VAL} pairs in {dtype}")
        return got, torch.cuda.max_memory_allocated() - base, launches[dtype]

    evaluation, eval_launches = {}, 0
    first = val[0]
    shape = tuple(eval_transform(first, "middlebury")[0].shape)
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        with cudnn_deterministic():
            got, _, n = run_eval(dtype, workdir / f"middlebury_eval_{tag}")
            want, kept, confusions = _eval_reference(model, val, dtype == "bfloat16", maxdisp, "middlebury")
        eval_launches += n
        rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
        log(f"[middlebury eval {tag}] metrics " + ", ".join(
            f"{k} {got[k]:.6f} (direct {want[k]:.6f}, rel {rel[k]:.1e})" for k in want) + f" over {kept} kept "
            "pairs (tolerance rel 1e-5)")
        if kept != MIDDLEBURY_VAL or max(rel.values()) > 1e-5:
            raise AssertionError(f"[middlebury eval {tag}] {kept} pairs kept, or the metrics disagree with the direct "
                                 f"model calls: {rel}")
        for vi, conf in enumerate(confusions):
            scores = segmentation_scores(torch.from_numpy(conf).float().cuda())
            wrong = {k: (got[f"vol{vi + 1}/{k}"], float(v)) for k, v in scores.items()
                     if got[f"vol{vi + 1}/{k}"] != float(v)}
            if wrong:
                raise AssertionError(f"[middlebury eval {tag}] vol{vi + 1} scores differ from the numpy count: {wrong}")
        log(f"[middlebury eval {tag}] the class scores of {len(confusions)} volumes equal a numpy count of the same "
            "logits")
        timed, peak, n = run_eval(dtype, workdir / f"middlebury_eval_{tag}_timed")
        eval_launches += n
        moved = {k: abs(timed[k] - got[k]) / max(abs(got[k]), 1e-12) for k in want}
        if max(moved.values()) > 1e-3:
            raise AssertionError(f"[middlebury eval {tag}] the run with cuDNN's defaults moved the metrics: {moved}")
        parts = _eval_parts(model, val, dtype == "bfloat16", "middlebury")
        evaluation[tag] = dict(ms_per_pair=timed["ms_per_pair"], pairs_per_s=timed["pairs_per_s"], peak_bytes=peak,
                               metrics={k: got[k] for k in want}, miou=got["miou"], mpa=got["mpa"], **parts)
        log(f"[middlebury eval {tag}] cli eval --preset middlebury, DCANet(num_cva=3, maxdisp={maxdisp}), checkpoint "
            f"step {checkpoint_step(newest)}, {MIDDLEBURY_VAL} held-out scenes halved to {first['disparity'].shape} "
            f"and padded to {shape[1:]}: {timed['ms_per_pair']:.3f} ms/pair (host clock, pair 2: decode, halve, "
            f"transform, forward, metrics), peak memory {peak / 2**30:.4f} GiB above the memory held before; EPE "
            f"{got['epe']:.4f} px, D1 {got['d1']:.5f}; {gpu_line()}")
        log(f"[middlebury eval {tag}] parts: decode, halve and transform of each held-out pair "
            + ", ".join(f"{t:.3f}" for t in parts["host_ms_each"]) + f" ms (host), the forward alone "
            f"{parts['forward_ms']:.3f} ms (CUDA events, median of 5)")
    launches = dict(middlebury_train_fwd=sum(runs[t]["fwd"][d] for t, d in (("middlebury f32", "float32"),
                                                                           ("middlebury bf16", "bfloat16"))),
                    middlebury_train_bwd=sum(runs[t]["bwd"][d] for t, d in (("middlebury f32", "float32"),
                                                                           ("middlebury bf16", "bfloat16"))),
                    middlebury_train_bn={k: runs["middlebury f32"]["bn"][k] + runs["middlebury bf16"]["bn"][k]
                                         for k in runs["middlebury f32"]["bn"]},
                    eth3d_train_bn=runs["eth3d bf16"]["bn"],
                    eth3d_train_fwd=runs["eth3d bf16"]["fwd"]["bfloat16"],
                    eth3d_train_bwd=runs["eth3d bf16"]["bwd"]["bfloat16"], middlebury_eval=eval_launches,
                    leg_fwd=[f for f, _ in leg["launches"]], leg_range_bwd=[b for _, b in leg["launches"]])
    marks.append(("cli eval", time.perf_counter()))
    seconds = time.perf_counter() - t_phase
    log(f"[middlebury] the phase took {seconds:.1f} s: " + ", ".join(
        f"{name} {t - t_prev:.1f} s" for (name, t), t_prev in zip(marks, [t_phase] + [t for _, t in marks])))
    return dict(runs=runs, leg=leg, parity=parity, eval=evaluation, eval_shape=list(shape), launches=launches,
                seconds=seconds)


def phase_middlebury_step(workdir: Path, out_path: Path) -> dict:
    """The Middlebury step alone at batch 1 (320x704 crops of the halved
    scenes) for {f32, bf16} x {remat, none} (manual: `--phases
    middlebury_step`), each in a process of its own (`steps_alone`); then
    `cmd_train --preset middlebury` at an epoch of MiddEval3's training-set
    size (MIDDLEBURY_EPOCH_SCENES procedural scenes, batch 1) for
    MIDDLEBURY_EPOCH_RUN epochs in f32 and bf16 (`_benchmark_train_run`: the
    steady ms/step beside the step alone, each epoch start's stall and what
    it waited on); writes the results to `out_path`."""
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.data.synthetic import write_procedural_middlebury_tree

    mb_train, _, _ = benchmark_trees(workdir)
    out = steps_alone("middlebury_step", "middlebury", (mb_train, None), 1, workdir, out_path, (320, 704))
    t0 = time.perf_counter()
    root = write_procedural_middlebury_tree(workdir / "middlebury_epoch", MIDDLEBURY_EPOCH_SCENES,
                                            seed=MIDDLEBURY_EPOCH_SEED)
    log(f"[middlebury_step] procedural tree: {MIDDLEBURY_EPOCH_SCENES} Middlebury scenes at 1988x2880 (seed "
        f"{MIDDLEBURY_EPOCH_SEED}), {time.perf_counter() - t0:.1f} s")
    out["epoch_runs"] = {}
    for dtype in ("float32", "bfloat16"):
        cfg = preset("middlebury", data_root=str(root), dtype=dtype, logdir=str(workdir / f"middlebury_epoch_{dtype}"),
                     epochs=MIDDLEBURY_EPOCH_RUN, print_freq=1, seed=SEED)
        out["epoch_runs"][dtype] = _benchmark_train_run(f"middlebury {dtype}, epoch of {MIDDLEBURY_EPOCH_SCENES}",
                                                        cfg, MIDDLEBURY_EPOCH_SCENES)
    out_path.write_text(json.dumps(out, indent=2))
    log(f"[middlebury_step] epoch runs: {json.dumps(out['epoch_runs'])}")
    return out


def _step_alone_worker(rank: int, port: int, name: str, root: str, root2: str, batch_size: int, dtype: str,
                       remat: bool, out_path: str) -> None:
    """The train step alone (`step_alone`) of the `name` preset at batch
    `batch_size` (crops of the preset's training set under `root` and
    `root2`) in one process: the median of STEP_ALONE_TIMED steps after
    STEP_ALONE_WARMUP, pairs/s, the peak memory and, without remat, what
    holds it (`memory_at_peak`: with remat, the checkpointed backward under
    the allocator's history raised a SystemError on the card); or, where
    the card runs out of memory, the allocator's message, the peak reached
    before it and the allocation refused. No other exception is caught."""
    import re

    import torch

    from dcanet_tpu_torch import cli
    from dcanet_tpu_torch.config import preset
    from dcanet_tpu_torch.train.loop import LossConfig

    cfg = preset(name, data_root=root, data_root2=root2, seed=SEED, dtype=dtype, remat=remat)
    ds = cli.build_dataset(cfg, training=True)
    samples = [ds[i % len(ds)] for i in range(batch_size)]
    batch = {k: torch.from_numpy(np.stack([x[k] for x in samples])).cuda() for k in samples[0]}
    if dtype == "float32":  # as `cli train` runs it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    loss_cfg = LossConfig(max_disp=cfg.maxdisp, sparse=cfg.sparse_gt, preset=cfg.loss_preset)
    result = dict(dtype=dtype, remat=remat, batch=batch_size)
    try:
        result.update(step_alone(cfg, batch, loss_cfg, STEP_ALONE_WARMUP + STEP_ALONE_TIMED, STEP_ALONE_WARMUP,
                                 at_peak=not remat))
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
        m = re.search(r"Tried to allocate ([\d.]+) (GiB|MiB|KiB|B)", msg)
        tried = float(m.group(1)) * {"GiB": 2**30, "MiB": 2**20, "KiB": 2**10, "B": 1}[m.group(2)] if m else 0.0
        peak = torch.cuda.max_memory_allocated()
        result.update(oom=msg, peak_bytes_before_oom=peak, refused_bytes=tried, reckoned_need_bytes=peak + tried)
    torch.save(result, out_path)


def steps_alone(tag: str, name: str, roots: tuple, batch_size: int, workdir: Path, out_path: Path, crop) -> dict:
    """The `name` preset's step alone (`_step_alone_worker`) at batch
    `batch_size` for {f32, bf16} x {remat, none}, each in a process of its
    own: ms/step, pairs/s, the peak and its largest blocks, or "oom" with
    the allocator's message and the need reckoned from the peak before it
    plus the allocation refused. Writes the results to `out_path`."""
    results = {}
    for dtype in ("float32", "bfloat16"):
        for remat in (False, True):
            key = f"{dtype}{' remat' if remat else ''}"
            (r,), wall = run_workers(f"{tag}_{dtype}_{remat}", _step_alone_worker, 1,
                                     (name, str(roots[0]), str(roots[1]) if roots[1] else "", batch_size, dtype,
                                      remat), workdir, STEP_ALONE_TIMEOUT_S)
            results[key] = r
            if "oom" in r:
                log(f"[{tag}] {key}, batch {batch_size}: oom; peak before it "
                    f"{r['peak_bytes_before_oom'] / 2**30:.4f} GiB, refused {r['refused_bytes'] / 2**30:.4f} GiB, "
                    f"reckoned need at least {r['reckoned_need_bytes'] / 2**30:.4f} GiB; the allocator: {r['oom']}")
                continue
            if not all(math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"[{tag}] {key}: a loss is not finite: {r['losses']}")
            log(f"[{tag}] {key}, batch {batch_size}x3x{crop[0]}x{crop[1]}, the step alone: median {r['ms']:.3f} ms "
                f"over {STEP_ALONE_TIMED} steps (range {r['ms_range'][0]:.3f}-{r['ms_range'][1]:.3f}), "
                f"{r['pairs_per_s']:.3f} pairs/s, peak {r['peak_bytes'] / 2**30:.4f} GiB (held before the first step "
                f"{r['before_bytes'] / 2**30:.4f}), process {wall:.1f} s")
            for size, site in r.get("at_peak", {}).get("largest", [])[:4]:
                log(f"[{tag}]   largest block at the peak: {size / 2**20:10.1f} MiB {site}")
    out = {"card": gpu_line(), "preset": name, "batch": batch_size, "crop": list(crop), "results": results}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=2))
    log(f"[{tag}] summary: {json.dumps(out)}")
    return out


def phase_kitti12(workdir: Path, out_path: Path) -> dict:
    """The KITTI step alone at batch KITTI_BATCH for {f32, bf16} x {remat,
    none} (manual: `--phases kitti12`), each in a process of its own
    (`steps_alone`); writes the results to `out_path`."""
    k12, k15, _ = kitti_trees(workdir, KITTI_TREE, 0)
    return steps_alone("kitti12", "kitti", (k12, k15), KITTI_BATCH, workdir, out_path, (256, 512))


def phase_finetune(workdir: Path, out_dir: Path) -> dict:
    """The KITTI fine-tune leg after the SceneFlow curve (manual: `--phases
    finetune`): `phase_curve`, then `finetune_kitti.run_finetune` on its
    newest (epoch CURVE_EPOCHS) checkpoint: FINETUNE_TREE KITTI 2012 +
    FINETUNE_TREE KITTI 2015 procedural scenes at KITTI_TRAIN_HW, FINETUNE_VAL
    held out (`kitti_trees`), FINETUNE_EPOCHS epochs at batch
    FINETUNE_BATCH in bf16, `cli eval` before and after. Raises unless
    every score is finite; says whether both points are under 1.0 px EPE
    and 2 % D1. Writes traincurve.json and finetune.json to `out_dir`."""
    from dcanet_tpu_torch import finetune_kitti

    phase_curve(workdir, out_dir / "traincurve.json")
    k12, k15, val = kitti_trees(workdir, FINETUNE_TREE, FINETUNE_VAL)
    result = finetune_kitti.run_finetune(str(workdir / "curve_run" / "ckpt"), str(k12), str(k15), str(val),
                                         FINETUNE_EPOCHS, FINETUNE_BATCH, "bfloat16", str(workdir / "finetune_run"),
                                         "cuda", say=log)
    result["card"] = gpu_line()
    if not all(math.isfinite(r[k]) for r in result["curve"] for k in ("val_epe", "val_d1")):
        raise AssertionError(f"[finetune] a score is not finite: {result['curve']}")
    for r in result["curve"]:
        log(f"[finetune] {r['tag']}: val EPE {r['val_epe']:.4f} px, D1 {r['val_d1']:.5f} (under 1.0 px and 2 %: "
            f"{r['val_epe'] < 1.0 and r['val_d1'] < 0.02})")
    log(f"[finetune] {result['train_steps']} steps at batch {FINETUNE_BATCH}: {result['ms_per_step']:.3f} ms/step, "
        f"{result['pairs_per_s']:.3f} pairs/s, {result['train_wall_s']:.1f} s, peak "
        f"{result['peak_memory_bytes'] / 2**30:.4f} GiB")
    (out_dir / "finetune.json").write_text(json.dumps(result, indent=2))
    log(f"[finetune] summary: {json.dumps(result)}")
    return result


def _shard_launches(middlebury: dict, planes, tag: str, key: str = "leg_fwd") -> int:
    """The middlebury phase's 2-rank leg's launches (bf16) of one rank's
    planes; 0 for another range or dtype."""
    shards = MIDDLEBURY_SHARDS[LEG_WORLD]
    if tag != "bf16" or tuple(planes) not in shards:
        return 0
    return middlebury["launches"][key][shards.index(tuple(planes))]


def kernel_entry(name, source, replaces, launches, by_path, err, t, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"], **extra}


PHASES = ("kernels", "io", "model", "serving", "conv3d_path", "train", "eval", "family", "extras", "parallel", "disp",
          "disp_train", "kitti", "middlebury")
# measurements that the default run never starts
# the manual measurements across the host's cards (`phase_cards`)
CARDS_PHASES = {"cards", "cards_kitti", "cards_middlebury"}
MANUAL_PHASES = CARDS_PHASES | {"curve", "kitti12", "finetune", "middlebury_step"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s to run after the build, or a manual "
                         "measurement: `cards`, `cards_kitti`, `cards_middlebury` (two or more cards: `cli "
                         "train` of the sceneflow, kitti or middlebury preset across them), `curve` (the "
                         "training curve, ~30 min), `kitti12` (the KITTI step alone at batch 12, f32 / bf16 x "
                         "remat / none), `finetune` (the curve, then the KITTI fine-tune leg, ~35 min) or "
                         "`middlebury_step` (the Middlebury step alone, f32 / bf16 x remat / none); the summary "
                         "lines are printed only when all of the default run")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES) | MANUAL_PHASES:
        ap.error(f"unknown phases {sorted(phases - set(PHASES) - MANUAL_PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dcanet_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible device(s)")
    phase_build()
    errs, timing = phase_kernels() if "kernels" in phases else ({}, {})

    from dcanet_tpu_torch.models import DCANet

    flat = seeded_flax_variables(DCANet(maxdisp=192, num_cva=3), SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "io" in phases:
            host_io = phase_io(Path(tmp))
        if "model" in phases or "serving" in phases:
            _, ref_disp = phase_model(flat)
        serving = phase_serving(flat, ref_disp, Path(tmp)) if "serving" in phases else None
        conv_launches = phase_conv3d_path() if "conv3d_path" in phases else None
        if "train" in phases:
            train = phase_train(Path(tmp))
            parity = phase_train_parity()
            parity["kitti"] = phase_train_parity(loss_preset="kitti")
        if "eval" in phases:
            evaluation = phase_eval(Path(tmp), Path(tmp) / "run" if "train" in phases else None)
        if "family" in phases:
            family = phase_family(Path(tmp))
        if "extras" in phases:
            extras = phase_extras(Path(tmp))
        if "parallel" in phases:
            parallel = phase_parallel(Path(tmp))
        if "disp" in phases:
            disp = phase_disp(Path(tmp), flat)
        if "disp_train" in phases:
            disp_train = phase_disp_train(Path(tmp))
        if phases & CARDS_PHASES:
            phase_cards(Path(tmp), flat, phases)
        if "kitti" in phases:
            kitti = phase_kitti(Path(tmp), Path(tmp) / "run" if "train" in phases else None)
        if "middlebury" in phases:
            middlebury = phase_middlebury(Path(tmp))
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        if "curve" in phases:
            phase_curve(Path(tmp), out_dir / "traincurve.json")
        if "kitti12" in phases:
            phase_kitti12(Path(tmp), out_dir / "kitti12.json")
        if "finetune" in phases:
            phase_finetune(Path(tmp), out_dir)
        if "middlebury_step" in phases:
            phase_middlebury_step(Path(tmp), out_dir / "middlebury_step.json")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)}; no summary for a subset")
        return 0

    gwc_t, bwd_t, range_t = timing["gwc"], timing["gwc_bwd"], timing["gwc_bwd_range"]
    # each one-process train path's train-mode BatchNorm counts, set to 0
    # just before it ran
    bn_by_path = {"train": train["bn"], "train_bf16": train["bf16"]["bn"], "kitti_train": kitti["launches"]["train_bn"],
                  "middlebury_train": middlebury["launches"]["middlebury_train_bn"],
                  "eth3d_train": middlebury["launches"]["eth3d_train_bn"],
                  "disp_train_one_process": disp_train["one_bn"]}
    eval_launches = evaluation["launches"]["f32"] + evaluation["launches"]["bf16"]
    conv_t = timing["conv3d"]
    kernels = [
        kernel_entry(
            "gwc_volume", "dcanet_tpu_torch/csrc/gwc.cu", "dcanet_tpu/kernels/gwc.py:51", eval_launches,
            {"eval": eval_launches, "infer_list": evaluation["launches"]["infer_list"], "train": train["fwd"],
             "train_bf16": train["bf16"]["fwd"]["bfloat16"],
             "serving": serving, "train_infer": train["infer"],
             "parallel_train": sum(f for f, _ in parallel["launches"]),
             "disp_eval": sum(disp["f32"]["launches"]) + sum(disp["bf16"]["launches"]),
             "disp_eval_one_process": disp["f32"]["one_launches"] + disp["bf16"]["one_launches"],
             "disp_train": sum(f for f, _ in disp_train["launches"]),
             "disp_train_one_process": disp_train["one_launches"][0],
             "kitti_train": kitti["launches"]["train_fwd"], "kitti_eval": kitti["launches"]["eval"],
             "kitti_train_2_ranks": kitti["launches"]["leg_fwd"],
             "middlebury_train": middlebury["launches"]["middlebury_train_fwd"],
             "middlebury_disp_train_2_ranks": sum(middlebury["launches"]["leg_fwd"]),
             "eth3d_train": middlebury["launches"]["eth3d_train_fwd"],
             "middlebury_eval": middlebury["launches"]["middlebury_eval"],
             **{k: v for k, v in family["launches"].items() if not k.startswith("family_train_backward")}},
            errs["gwc"]["main f32"],
            gwc_t["f32"],
            dtype="float32", shape={"features": list(MAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D},
            bfloat16={"max_abs_err": errs["gwc"]["main bf16"], **gwc_t["bf16"]},
            train_shape={"features": list(TRAIN_SHAPE), "float32": gwc_t["train f32"],
                         "bfloat16": gwc_t["train bf16"]},
            # the bf16 train leg's launches (train_bf16), batch 4
            train_b4_shape={"features": list(TRAIN_B4_SHAPE),
                            "float32": {"max_abs_err": errs["gwc"]["train b4 f32"], **gwc_t["train b4 f32"]},
                            "bfloat16": {"max_abs_err": errs["gwc"]["train b4 bf16"], **gwc_t["train b4 bf16"],
                                         "launches": train["bf16"]["fwd"]["bfloat16"]}},
            # the kitti phase's train launches (kitti_train), batch 12
            train_b12_shape={"features": list(TRAIN_B12_SHAPE),
                             "float32": {"max_abs_err": errs["gwc"]["train b12 f32"], **gwc_t["train b12 f32"]},
                             "bfloat16": {"max_abs_err": errs["gwc"]["train b12 bf16"], **gwc_t["train b12 bf16"],
                                          "launches": kitti["launches"]["train_fwd"]}},
            # a rank's share of it in the kitti phase's 2-rank leg (6) and on
            # 4 cards (3; `--phases cards_kitti` alone)
            **{f"train_b{b}_shape": {
                "features": [b, *TRAIN_SHAPE[1:]],
                "float32": {"max_abs_err": errs["gwc"][f"train b{b} f32"], **gwc_t[f"train b{b} f32"]},
                "bfloat16": {"max_abs_err": errs["gwc"][f"train b{b} bf16"], **gwc_t[f"train b{b} bf16"],
                             "launches": kitti["launches"]["leg_fwd"] if b == 6 else 0}} for b in (6, 3)},
            # the middlebury phase's launches at D = 60: its train crops (f32 and
            # bf16 runs) and its eval pairs (f32 and bf16, two runs each)
            middlebury_train_shape={
                "features": list(MIDDLEBURY_SHAPE), "maxdisp": MIDDLEBURY_D,
                "launches": middlebury["launches"]["middlebury_train_fwd"],
                "float32": {"max_abs_err": errs["gwc"]["middlebury train f32"], **gwc_t["middlebury train f32"]},
                "bfloat16": {"max_abs_err": errs["gwc"]["middlebury train bf16"], **gwc_t["middlebury train bf16"]}},
            middlebury_eval_shape={
                "features": list(MIDDLEBURY_EVAL_FEATURES), "maxdisp": MIDDLEBURY_D,
                "launches": middlebury["launches"]["middlebury_eval"],
                "float32": {"max_abs_err": errs["gwc"]["middlebury eval f32"], **gwc_t["middlebury eval f32"]},
                "bfloat16": {"max_abs_err": errs["gwc"]["middlebury eval bf16"], **gwc_t["middlebury eval bf16"]}},
            kitti_eval_shape={"features": list(KITTI_EVAL_SHAPE),
                              "float32": {"max_abs_err": errs["gwc"]["kitti eval f32"], **gwc_t["kitti eval f32"]},
                              "bfloat16": {"max_abs_err": errs["gwc"]["kitti eval bf16"],
                                           **gwc_t["kitti eval bf16"]}},
            # the disparity-sharded eval's launches (disp_eval) take the planes
            # [0, 24) on rank 0 and [24, 48) on rank 1 of D = 48; the middlebury
            # phase's 2-rank leg [0, 30) and [30, 60) of D = 60, in bf16 (the
            # 4-rank ranges launch in `--phases cards_middlebury` alone)
            plane_ranges={f"{name} {tag}": {"features": list(shape), "maxdisp": d, "planes": planes,
                                            "max_abs_err": errs["gwc"][f"{name} {tag}"], **gwc_t[f"{name} {tag}"],
                                            **({"launches": _shard_launches(middlebury, planes, tag)}
                                               if name.startswith("middlebury train") else {})}
                          for name, shape, _, d, planes in GWC_TIMED_RANGES for tag in ("f32", "bf16")},
        ),
        kernel_entry(
            "gwc_volume_backward", "dcanet_tpu_torch/csrc/gwc.cu", "dcanet_tpu/kernels/gwc.py:133",
            train["bwd"], {"train": train["bwd"], "train_bf16": train["bf16"]["bwd"]["bfloat16"],
                           "parallel_train": sum(b for _, b in parallel["launches"]),
                           "disp_train_one_process": disp_train["one_launches"][1],
                           "kitti_train": kitti["launches"]["train_bwd"],
                           "kitti_train_2_ranks": kitti["launches"]["leg_bwd"],
                           "middlebury_train": middlebury["launches"]["middlebury_train_bwd"],
                           "eth3d_train": middlebury["launches"]["eth3d_train_bwd"],
                           **{k.replace("_backward", ""): v for k, v in family["launches"].items()
                              if k.startswith("family_train_backward")}},
            errs["gwc_bwd"]["train f32"], bwd_t["f32"],
            dtype="float32", shape={"features": list(TRAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D},
            bfloat16={"max_abs_err": errs["gwc_bwd"]["train bf16"], **bwd_t["bf16"]},
            train_b4_shape={"features": list(TRAIN_B4_SHAPE),
                            "float32": {"max_abs_err": errs["gwc_bwd"]["train b4 f32"], **bwd_t["train b4 f32"]},
                            "bfloat16": {"max_abs_err": errs["gwc_bwd"]["train b4 bf16"], **bwd_t["train b4 bf16"],
                                         "launches": train["bf16"]["bwd"]["bfloat16"]}},
            train_b12_shape={"features": list(TRAIN_B12_SHAPE),
                             "float32": {"max_abs_err": errs["gwc_bwd"]["train b12 f32"], **bwd_t["train b12 f32"]},
                             "bfloat16": {"max_abs_err": errs["gwc_bwd"]["train b12 bf16"], **bwd_t["train b12 bf16"],
                                          "launches": kitti["launches"]["train_bwd"]}},
            **{f"train_b{b}_shape": {
                "features": [b, *TRAIN_SHAPE[1:]],
                "float32": {"max_abs_err": errs["gwc_bwd"][f"train b{b} f32"], **bwd_t[f"train b{b} f32"]},
                "bfloat16": {"max_abs_err": errs["gwc_bwd"][f"train b{b} bf16"], **bwd_t[f"train b{b} bf16"],
                             "launches": kitti["launches"]["leg_bwd"] if b == 6 else 0}} for b in (6, 3)},
            middlebury_shape={"features": list(MIDDLEBURY_SHAPE), "maxdisp": MIDDLEBURY_D,
                              "launches": middlebury["launches"]["middlebury_train_bwd"],
                              "float32": {"max_abs_err": errs["gwc_bwd"]["middlebury f32"], **bwd_t["middlebury f32"]},
                              "bfloat16": {"max_abs_err": errs["gwc_bwd"]["middlebury bf16"],
                                           **bwd_t["middlebury bf16"]}},
        ),
        # the backward of a plane range: rank 0 of the disparity-sharded train
        # step takes [0, 24), rank 1 [24, 48) (the range arithmetic, d_lo > 0);
        # the middlebury phase's 2-rank leg [0, 30) and [30, 60) of D = 60
        kernel_entry(
            "gwc_volume_backward_range", "dcanet_tpu_torch/csrc/gwc.cu", "dcanet_tpu/kernels/gwc.py:133",
            sum(b for _, b in disp_train["launches"]) + sum(middlebury["launches"]["leg_range_bwd"]),
            {"disp_train": sum(b for _, b in disp_train["launches"]),
             "middlebury_disp_train_2_ranks": sum(middlebury["launches"]["leg_range_bwd"])},
            errs["gwc_bwd"]["train [24,48) f32"], range_t["train [24,48) f32"],
            dtype="float32", shape={"features": list(TRAIN_SHAPE), "groups": MAIN_GROUPS, "maxdisp": MAIN_D,
                                    "planes": [24, 48]},
            bfloat16={"max_abs_err": errs["gwc_bwd"]["train [24,48) bf16"], **range_t["train [24,48) bf16"]},
            plane_ranges={f"{name} {tag}": {"features": list(shape), "maxdisp": d, "planes": list(planes),
                                            "max_abs_err": errs["gwc_bwd"][f"{name} {tag}"],
                                            **range_t[f"{name} {tag}"],
                                            **({"launches": _shard_launches(middlebury, planes, tag, "leg_range_bwd")}
                                               if name.startswith("middlebury train") else {})}
                          for name, shape, _, d, planes in GWC_BWD_RANGES for tag in ("f32", "bf16")},
        ),
        kernel_entry(
            "conv3d", "dcanet_tpu_torch/csrc/conv3d.cu", "dcanet_tpu/kernels/conv3d.py:54", conv_launches["f32"],
            {"conv3d_path": conv_launches["f32"]}, errs["conv3d"]["32->32 f32"], conv_t["32->32 f32"],
            dtype="float32", units="tensor cores (mma.sync m16n8k8 TF32, 3xTF32 split)",
            shape={"x": list(CONV_SHAPE), "out_channels": 32},
            **{"64->32": {"x": list(CONV_SHAPE_64), "max_abs_err": errs["conv3d"]["64->32 f32 scale+bias+relu"],
                          **conv_t["64->32 f32"]}},
        ),
        kernel_entry(
            "conv3d_bf16", "dcanet_tpu_torch/csrc/conv3d.cu", "dcanet_tpu/kernels/conv3d.py:54", conv_launches["bf16"],
            {"conv3d_path": conv_launches["bf16"]}, errs["conv3d"]["32->32 bf16 scale+bias+relu"],
            conv_t["32->32 bf16"], dtype="bfloat16", units="tensor cores (mma.sync)",
            shape={"x": list(CONV_SHAPE), "out_channels": 32},
            **{"64->32": {"x": list(CONV_SHAPE_64), "max_abs_err": errs["conv3d"]["64->32 bf16"],
                          **conv_t["64->32 bf16"]}},
        ),
        # train-mode BatchNorm: replaces no TPU kernel (XLA's BatchNorm there);
        # the launches of each train path (two a forward, two a backward),
        # and its calls of the plain version (0 on each)
        kernel_entry(
            "batch_norm_train", "dcanet_tpu_torch/csrc/batchnorm.cu", None,
            sum(c["launches"] for c in bn_by_path.values()), {k: c["launches"] for k, c in bn_by_path.items()},
            errs["batchnorm"][f"{BN_TIMED[0][1]} f32"], timing["batchnorm"]["3d f32"]["forward"],
            plain_calls_by_path={k: c["plain_calls"] for k, c in bn_by_path.items()},
            dtype="float32", shape={"x": list(BN_TIMED[0][1])},
            **{f"{shape_tag} {tag}": {"x": list(shape), "max_abs_err": errs["batchnorm"][f"{shape} {tag}"],
                                      **timing["batchnorm"][f"{shape_tag} {tag}"]}
               for shape_tag, shape in BN_TIMED for tag in ("f32", "bf16")},
        ),
    ]
    log("[train] summary: " + json.dumps({k: train[k] for k in ("ms", "pairs_per_s", "peak_bytes", "alone", "bf16")}
                                         | {"parity": parity}))
    log("[train memory] summary: " + json.dumps(train["memory"]))
    log("[eval] summary: " + json.dumps(evaluation))
    log("[family] summary: " + json.dumps(family))
    log("[extras] summary: " + json.dumps(extras))
    log("[parallel] summary: " + json.dumps(parallel))
    log("[disp] summary: " + json.dumps(disp))
    log("[disp_train] summary: " + json.dumps(disp_train))
    log("[kitti] summary: " + json.dumps(kitti))
    log("[middlebury] summary: " + json.dumps(middlebury))
    log("[io] summary: " + json.dumps(host_io))
    print(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
