#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Drive the PyTorch/H100 port's main paths on one card and check them.

The paths of ``climsr_tpu_torch`` at the flagship width (nf=64, nb=11,
gc=16, one output channel, bf16), pre-training and inference at the
reference defaults (``GeneratorConfig``: nf=64, nb=23, gc=32), and the entry
points of the three kernels that no model path runs:

- inference: the ESRGAN tiled whole-globe sweep, CRU-TS months of 360x720 LR
  cut into 128-px tiles with 8-px overlap, 16 tiles per generator call,
  feather blend, land gather, 12-bit packed readback and one GeoTIFF per
  month. Kernel A, the fused residual dense block (``csrc/rdb_fwd.cu``), runs
  33 times per generator call;
- pixel-loss pre-training: ``create_generator(train=True)`` ->
  ``build_optimizer`` (AdamW, one-cycle) -> ``make_pretrain_step`` at batch
  192 (LR 32x32, HR 128x128), then ``make_eval_step``. Each step runs kernel
  B1 (the RDB forward that saves its features, ``csrc/rdb_fwd.cu``) and B2
  (the RDB backward, ``csrc/rdb_bwd.cu``) 33 times each and kernel C (the
  fusion head's input gradient to channel 0, ``csrc/conv9_dx_c0.cu``) once;
  the eval step runs A 33 times;
- the relativistic GAN fine-tune: ``create_discriminator`` (ESRGAN
  discriminator, 8192-input fc1 at HR 128), ``build_perceptual_loss`` (VGG19
  to conv5_4 on seeded weights), Adam for G and D -> ``make_gan_step`` at
  batch 192, then ``make_gan_val_losses``. Each step runs B1 and B2 33 times
  each and C once; the val-loss call runs A 33 times;
- pre-training at the reference defaults: the same entry points at nf=64,
  nb=23, gc=32, batch 192. Each step runs B1 and B2 69 times each (the bf16
  chain at 8 x 16 tiles) and C once;
- training through the entry point a user calls (``cli.train.run`` from the
  composed ``esrgan_pre_training`` config) on a synthetic WorldClim set: the
  same kernels as pre-training (B1, B2, C per step) and A per validation or
  test batch;
- the other generator families at their published widths (RCAN 10 x 20 x 64,
  DRLN 64, RFB-ESRGAN 16 RRDB + 8 RRFDB) and the RFB-ESRGAN discriminator:
  RCAN pre-trained, fine-tuned at europe extent and run over europe-extent
  GeoTIFF months, DRLN and RFB-ESRGAN pre-trained, all through the entry
  points; none of them runs a TPU kernel's counterpart (their convs are
  library convs, as in the JAX package). The ESRGAN GAN fine-tune preset
  pairs the flagship ESRGAN with the RFB discriminator: B1, B2 and C in each
  step, A in each generator forward of validation and test;
- the offline pipelines as a user chains them: data preparation (host
  numpy and a process pool) writes the tile index, statistics and tiles;
  training reads them from disk (B1, B2, C a step, A in validation and the
  ``log_images`` callback); inference (A) and the result inspection read
  what that wrote;
- kernel D (``fused_rdb_nhwc``, the NHWC entry to kernel A), kernel E
  (``fused_hr_tail``, ``csrc/hr_tail.cu``) and kernel F (``dc0``, two
  variants, which launches kernel C, ``csrc/conv9_dx_c0.cu``, through the
  probe ``climsr_tpu_torch.scripts.bench_head_bwd_probe``). No model path
  runs them (as in the JAX package); each is driven through its own entry
  point.

Phases (each raises on failure; nothing is caught):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for the comparisons,
2. build: the four kernel libraries from ``climsr_tpu_torch/csrc``, one
   ``nvcc`` each, started together; ptxas registers and spills,
3. kernel A against its plain version at the inference shape (16 x 64 x
   128 x 128) and a ragged one (2 x 64 x 45 x 91), with and without the
   folded residual, in bf16 and f32, at gc=16 and gc=32 (and gc=48 on the
   ragged shape), and at gc=16 on phase 13's eval batches (192 and 64 x 64 x
   32 x 32); times (CUDA events, medians) beside the bound at gc=16 and
   gc=32, in bf16,
4. the generator (seeded weights) on 16 tiles of 32x32 through the kernel
   and through the plain RDB, in bf16 and f32, at the flagship widths (33
   launches per forward) and at the reference defaults (69),
5. end to end: a synthetic globe (8 months of 360x720 NetCDF, 1440x2880
   elevation and land mask at 29% land) through ``CRUTSInferenceDataset`` and
   ``inference_on_full_images``; 8 GeoTIFFs, launches = 33 x 14 generator
   calls, outputs against the same sweep with the plain RDB; a third sweep
   under ``torch.profiler`` for the device's busy share and top kernels,
6. kernels B1 and B2 against their plain versions at the training shape
   (192 x 64 x 32 x 32) and a ragged one (3 x 64 x 29 x 45), bf16 and f32,
   with scales (0.2, 1) and, with x0, (0.04, 0.2): out, feat, dx, every dW
   and db, at gc=16 and gc=32 (and gc=48 on the ragged shape); at the
   training shape (gc=16 and gc=32) the times beside the bounds, B2's dX
   pass, dW pass, reduction and wrapper ops each timed on the device, and
   two B2 calls on the same inputs bitwise equal; kernel C at 192 x 64 x
   128 x 128 and 2 x 64 x 45 x 91;
   times beside the bounds (and C's library conv), two C calls bitwise equal,
7. pre-training at full width: 6 steps through the kernels and 6 through
   the plain versions from the same seeded init and batch; losses and
   grad norms compared; exactly 33 B1 + 33 B2 + 1 C launches per step and no
   A; ms/step, samples/s, a profiled step (with the device time of every
   kernel inside the fusion head's backward, ``FusionConv1``: kernel C and the
   wrapper's own ops); then one eval step (33 A launches, 16 finite metrics),
8. kernels D, E and F against their plain versions, bf16 and f32: D at
   192 x 64 x 32 x 32 and 3 x 64 x 29 x 45 (also at gc=32), E and F (C's
   kernel) at 192 x 64 x 128 x 128 and 2 x 64 x 45 x 91; times beside the
   bounds; E also at the sweep's HR
   head, 16 x 64 x 512 x 512 bf16, timed against its plain version (cuDNN's
   two convs) and not listed; two E calls bitwise equal. Then D's and E's own
   paths, counted: the flagship generator's first RRDB through D (three
   launches) and its HR tail through E (one launch), each against the
   generator's own modules,
9. the probe (``bench_head_bwd_probe.probe``): F1 and F2 (C's kernel through
   F's entry) checked and timed against kernel C, the plain version and the
   library's transposed conv; F launches no C count,
10. the GAN fine-tune at full width: 4 steps through the kernels and 4
   through the plain versions from the same seeded init and batch; loss_G
   and loss_D compared step by step; exactly 33 B1 + 33 B2 + 1 C launches
   per step and no A, D, E or F; ms/step, samples/s, a profiled step; then
   one val-loss call (33 A launches, finite losses),
11. pre-training at the reference defaults (nf=64, nb=23, gc=32): 4 steps
   through the kernels and 4 through the plain versions from the same seeded
   init and batch, compared as in phase 7; exactly 69 B1 + 69 B2 + 1 C
   launches per step and no A; ms/step with the card line,
12. the kernels A, B1, B2 and D at gc=32: time, plain time, bound and error
   printed with the card line (the JSON line carries gc=16's),
13. the training entry point end to end, as a user runs it: a synthetic
   WorldClim set (``make_synthetic_dataset``, 128/64/64 tiles per stage and
   temperature variable, its tables handed over without feather files),
   ``compose(... "experiment=esrgan_pre_training" ...)`` (nf=64, nb=11, gc=16,
   batch 192, bf16) and ``cli.train.run`` with the datamodule: the tile store
   on the card, device augmentation, 2 epochs of 2 steps, a validation each
   epoch, three test sets, checkpoints and the simple profiler's stage
   table. Exactly 33 B1 + 33 B2 + 1 C per step and 33 A per eval batch; the
   same run through the plain versions (kernel A too) from the same seed,
   per-step train/loss and val/rmse compared; the best checkpoint re-validated
   in a fresh generator and the latest one against the trained model on 16
   tiles; the trained generator on a validation batch of 192 and of 64
   through kernel A and through the plain RDB; the trainer's samples/s
   beside phase 7's bare step,
A. each family's modules at full width on 4 seeded tiles (LR 32x32; the
   discriminator on HR 128, in train mode, its logits): the card in f32 (TF32
   off) against the same module and weights on the CPU, and bf16 against f32
   on the card; each one's forward ms at batch 192 in bf16,
B. RCAN through the entry points: ``compose(... "experiment=rcan_pre_training"
   ...)`` and ``cli.train.run`` on phase 13's synthetic set (batch 96, 2
   epochs of 4 steps, validation, three test sets, checkpoints), then
   ``experiment=rcan_fine_tuning`` with ``training.model_weights`` at its
   checkpoints on a europe-extent synthetic set (HR 452, LR 113, 11/4/4
   frames per stage and variable, batch 16, 2 epochs of 2 steps; the graft
   copies every tensor), then the fine-tuned model from its best checkpoint
   (``load_generator``) over 8 synthetic europe-extent GeoTIFF months
   (``GeoTiffInferenceDataset``, ``inference_on_full_images``, the
   whole-frame path): 8 GeoTIFFs of 452x452, finite on land and NaN on sea;
   samples/s, peak device memory, months/s,
C. ``experiment=esrgan_fine_tune_no_gan_pre_training`` (the flagship ESRGAN,
   the RFB-ESRGAN discriminator, VGG19 to conv5_4 on seeded weights) through
   ``cli.train.run`` from phase 13's best checkpoint on the europe-extent set:
   2 epochs of 2 steps, a validation each epoch, three test sets. Exactly 33
   B1 + 33 B2 + 1 C per step and 33 A per generator forward (a GAN validation
   batch runs two: the metric suite and the GAN val losses), no D, E or F.
   Then A (12 and 4 x 64 x 113 x 113), B1 and B2 (16 x 64 x 113 x 113) and C
   (16 x 64 x 452 x 452) against their plain versions at those shapes, as in
   phases 3 and 6; the fine-tuned generator through A against the plain RDB
   on the validation batch and a test batch's size, and its parameter
   gradients of a train batch through B1, B2 and C against the plain versions
   (each tensor and all together), with the plain versions in bf16 against
   f32 printed beside. Last, the same fit through the plain versions from the
   same seed, per-step loss_G and loss_D and the validations' val/rmse and
   val/loss_G compared, beside that comparison's noise: the plain fit again,
   and the plain fit from the checkpoint with every generator weight moved by
   one bf16 rounding step; and the same three comparisons from a seeded
   generator (printed, not held to the tolerance),
D. DRLN and RFB-ESRGAN pre-training through ``cli.train.run`` on the composed
   ``esrgan_pre_training`` experiment with ``generator=<name>``: 2 epochs of
   one step of 192 over the same 192 tiles and one validation; finite
   losses, the step-2 loss below the step-1 loss; peak device memory,
W. fault 1, the bf16 chain at nf other than 64: kernels A, B1, B2 and D
   in bf16 at nf = 32, 48, 96, 128 and gc = 16, 32 against their plain
   versions at the training shape (192 x nf x 32 x 32) and a ragged one (3 x
   nf x 29 x 45), tolerances of phases 3 and 6; A, B1, B2 timed at the
   training shape beside their bounds, nf=64's beside phase 3's and phase
   6's times of that shape; a bf16 ESRGAN at nf=32, nb=11, gc=16 through 2
   pre-training steps at batch 192 against the plain versions (as phase 7),
L. the LR range test, ``training.lr_find_only=true`` on phase 13's
   experiment and set: 100 steps of batch 192, exactly 33 B1 + 33 B2 + 1 C a
   step; ``lr_find.csv``; the same test through the plain versions, the
   losses held over the descent (to the plain run's smoothed minimum) at
   phase 7's trajectory tolerance,
R. ``callbacks=[model_pruning]`` and then ``[lottery_ticket]`` on phase 13's
   experiment (2 epochs of 2 steps): the weights' sparsity 50% and then 75%,
   the pruned weights still exactly 0 after the next steps, the fit against
   the same fit through the plain versions, the pruned generator through A
   against the plain RDB on a validation batch,
Q. ``profiler=pytorch`` (``profile_ops.txt`` lists A, B1/B2's dX, B2's dW
   and C by symbol with device times) and ``profiler=jax`` (the fit's Chrome
   trace parses as JSON and holds those kernels' events),
H. ``hparams_search=srcnn_optuna`` through ``cli.train.run_hparams_search``:
   3 trials of 1 epoch of at most 2 steps on phase 13's set (the
   resolutions dimension dropped: the set holds 2.5m tiles only);
   ``trials.csv`` and ``best.yaml`` printed, ``best.yaml`` read back,
P. ``trainer.auto_scale_batch_size=power`` and then ``binsearch`` (the
   Trainer alone): each trial's batch, peak and verdict, the chosen batch,
   the next doubling shown not to fit, one real train step at the chosen
   batch,
X. the offline pipelines, each through its entry point's ``main(argv)`` with
   no table handed over: raw inputs fabricated from seeds at the real grids
   (three CRU-TS NetCDF of 24 months at 360 x 720; WorldClim 2.5m tmin and
   tmax for months 1-2 of 1999, 2002 and 2010 and the elevation at 4320 x
   8640, one 10m tmin at 1080 x 2160; the ocean from one land mask); then
   ``cli.data_preparation`` (download off, all seven steps, a ``spawn`` pool
   of min(8, CPUs), in a child interpreter) with each step's seconds, the
   resized rasters (1440 x 2880, NaN exactly on the ocean), the tiles of one
   raster on ``_tile_windows``, the statistics against a float64
   recomputation (1e-12 relative) and every feather read back; then
   ``cli.train`` on the prepared directory (``esrgan_pre_training``, batch
   192, bf16, 2 epochs, ``callbacks=[log_images]``): B1, B2 33 and C once a
   step, A in the validations and the callback, every tile read by the
   native reader, samples/s, and samples/s with the device's busy share over
   4 profiled steps; then 1 epoch with ``trainer.device_resident_data=false``
   (the host loaders) beside it, and 4 profiled steps of it with the tiles
   read from their files (its tile cache emptied) and from the host cache; then ``cli.inference`` from the best checkpoint with
   the prepared min-max and z-score tables, the whole globe from the CRU-TS
   tmp NetCDF (a NetCDF of 24 x 1440 x 2880, NaN exactly on the ocean) and
   the prepared europe-extent CRU-TS GeoTIFFs (24 x 452 x 452), months/s
   and A's launches, the europe NetCDF against a rerun through the plain
   RDB; then ``cli.inspect_results`` against the fabricated CRU-TS tmp file
   (MAE, MSE, RMSE; the three CSVs' rows; plots where matplotlib is);
   seconds by step and the disk used. The shape of every A, B1 and C launch
   on the path is recorded, and after it A is checked against its plain
   version at each of them, B1, B2 and C at those phase 6 did not check.
   The launches of every path of W, L, R, Q, H, P and X printed,
M. the multi-rank code: ``parallel.launch.spawn`` starts 4 ranks (fresh
   interpreters after this process built every kernel library, so none runs
   ``nvcc``) in a gloo group over ``tcp://127.0.0.1``, all on ``cuda:0``
   (NCCL refuses two ranks on one card), against references computed here
   on one rank and handed over as a file: M1, the flagship pre-training step
   at global batch 192 (48 a rank), 3 steps at ZeRO stages 0-3 (losses, grad
   norms, parameters; at stage 3 no full gradient kept); M2, 2 GAN steps at
   stages 0 and 2 with the discriminator's batch statistics over the data
   axis; M3, the spatial step at europe extent (4 x 113 x 113 LR, halo 8) on
   a (1, 4) mesh against the edge-fair unsharded step (the seam error in the
   interior, the frame-edge error against the plain unsharded model, the
   gradients), then the step on (1, 4) and with ZeRO-3 on (2, 2), and 2
   spatial GAN steps on (2, 2) at batch 192 against one rank's edge-fair
   step (the generator on the frames reflect-padded as the shards pad them); M4, RCAN's
   channel attention at 64 channels with the exact pool against the
   unsharded pool and a local-pool control, and RCAN 10 x 20 x 64 sharded;
   M5, ``cli.inference`` with ``inference.spatial_shard=true`` (2 whole-globe
   months, halo 32; rank 0 writes) against one rank's whole-frame and tiled
   runs; M6, ``cli.train`` at ZeRO-2 over the 4 ranks on phase 13's set, then
   with ``plugins=spatial_shard`` (halo 4: a 128-px tile leaves 8 LR rows a
   rank), each best ``.ckpt`` loaded in one rank with ``strict=True``. Each
   part's launches are counted from 0 on every rank; every launch's shape is
   recorded and A, B1, B2 and C are checked at them after the phase,
O. the JAX package's orbax checkpoint (``tests/fixtures/jax_orbax_ckpt.tar``,
   a JAX Trainer's checkpoints at nf=64, nb=1, gc=16 with SGD, unpacked into a
   temporary directory) read with the port's own zstd, OCDBT and zarr
   readers: O1 the tree read whole (seconds and MB/s on this host's CPU);
   O2 the generator strictly loaded against the JAX output on the record's 2
   seeded 32x32 tiles (``tests/fixtures/jax_orbax_record.npz``; f32 and bf16),
   then ``cli.inference`` from the checkpoint directory over 2 whole-globe
   months (360x720 -> 1440x2880) through kernel A, against the same sweep
   through the plain RDB; O3 the f32 pre-training step's loss on the record's
   batch from the loaded state against the JAX step's, then ``cli.train``
   with ``trainer.resume_from_checkpoint`` on phase 13's set, resuming at the
   JAX step for 2 steps through B1, B2 and C; every launch's shape recorded
   and A, B1, B2, C checked against their plain versions after the phase,
14. one JSON line with every kernel (the launches of A, B1, B2 and C are
   phase 13's, and A's times, bound and error are per launch over phase 13's
   eval shapes, from phase 3), the card line, then the device line as the
   last line.

Usage: ``python3 chip_smoke.py`` (one CUDA card). Exits non-zero, printing no
result, where there is no card or no ``climsr_tpu_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# max |kernel - plain| / max |plain|: f32 differs by summation order only; bf16
# also by where each side rounds its intermediates (cuDNN rounds every conv's
# output and bias add to bf16, the kernel keeps f32 sums and rounds once)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the same bound for the whole generator: 33 blocks and the head compound the
# per-block differences above (bf16), or summation order (f32)
GENERATOR_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}

# B1/B2 against their plain versions, max |kernel - plain| / max |plain| per
# output. f32: summation order only (dW sums 196,608 pixels in another order).
# bf16: both sides round dz to bf16 before the products read it, but a sum
# that lands on the other side of a rounding boundary moves that dz by one
# bf16 step (2^-8 relative) and the difference carries down the chain; the
# growth db sums dz after that rounding in the kernel and before it in the
# plain version (as in the TPU kernel).
TRAIN_KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# kernel C: the same bf16 inputs and f32 sums on both sides; the output is
# rounded once (2^-8 relative) after sums in another order
HEAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# pre-training through the kernels against the plain versions (bf16): the
# per-block differences above through 33 blocks, the head and 6 AdamW steps
STEP_LOSS_TOL, STEP_GRAD_NORM_TOL, TRAJECTORY_TOL = 1e-2, 5e-2, 2e-2
# kernel D is kernel A reached through the NHWC entry: KERNEL_TOL. Kernel E:
# f32 differs by summation order only; in bf16 both sides read the same
# rounded lrelu(x) and weights and sum in f32, but the plain version's cuDNN
# conv rounds HRconv's sum to bf16 before the bias add and the lrelu, where the
# kernel rounds once after them, so a hidden value can move by one bf16 step
# (2^-8 relative) before conv_last sums 576 of them: KERNEL_TOL as for A.
# Kernel F computes C's function from the same bf16 inputs with f32 sums:
# HEAD_TOL.
TAIL_TOL = KERNEL_TOL
# D's and E's own paths against the generator's own modules (bf16): D's path
# adds RDB3's outer residual in bf16 after the kernel's rounding, where the
# generator folds it into kernel A's single write: two roundings, not one
PATH_TOL = {torch.bfloat16: 2e-2}
# the GAN fine-tune through the kernels against the plain versions (bf16),
# loss_G and loss_D at each of 4 Adam steps: the generator's per-block
# differences above, through the discriminator, VGG19 and the Adam updates
GAN_LOSS_TOL = 2e-2
GAN_STEPS = 4
# phase C's compared keys: loss_G and loss_D per step, val/rmse and val/loss_G per validation
GAN_KEYS = ("train/loss_G", "train/loss_D", "val/rmse", "val/loss_G")
# phase C, the fine-tuned generator's parameter gradients of one train batch
# against the plain versions in f32 (|got - ref| / |ref|, over all and for
# each tensor): through B1, B2 and C in bf16 at most twice the plain versions'
# in bf16, or this, the bound phase 7 puts on grad norms (STEP_GRAD_NORM_TOL)
GRAD_TOL = 5e-2

NF, NB, GC = 64, 11, 16
NB_REF, GC_REF = 23, 32  # GeneratorConfig's defaults (with nf=64): the reference's own widths
TRAIN_N, TRAIN_LR = 192, 32
STEPS = 6
REF_STEPS = 4  # phase 11's steps through the kernels and through the plain versions
# phase 13: synthetic tiles per stage (train, val, test) and temperature variable,
# 2 steps of 192 an epoch, one validation batch, three test sets
TRAINER_TILES, TRAINER_EPOCHS = (128, 64, 64), 2
# kernel A's shapes there: the validation set (3 x 64 tiles) in one batch of
# 192, each test set in one of 64
EVAL_SHAPES = ((TRAIN_N, TRAIN_LR, TRAIN_LR), (TRAINER_TILES[2], TRAIN_LR, TRAIN_LR))
# the (n, h, w) at which phases 3 and 6 check kernels A, B1 and B2, and C at
# the flagship widths; phase X checks its own launches' shapes beyond these
A_CHECKED = ((16, 128, 128), (2, 45, 91), *EVAL_SHAPES)
B_CHECKED = ((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45))
C_CHECKED = ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91))

# phases A-D: the other generator families at their published widths
# (conf/generator/*.yaml; 3 input channels, 1 output, x4)
FAMILIES = {
    "rcan": dict(n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16),
    "drln": dict(channels=64),
    "rfb_esrgan": dict(num_rrdb_blocks=16, num_rrfdb_blocks=8),
}
FAMILY_N = 4  # phase A's tiles per comparison
# phase A, max |got - ref| / max |ref| of a family's output: the card in f32
# (TF32 off) against the CPU differs by the convs' summation order only
# (cuDNN's against oneDNN's, through 400 convs for RCAN); bf16 against f32 on
# the card by each conv's output rounding (2^-8 relative) carried through
# the residual chains, as GENERATOR_TOL bounds it for ESRGAN
FAMILY_CPU_TOL, FAMILY_BF16_TOL = 1e-3, 5e-2
# europe extent (phases B, C): HR 452 frames per stage and temperature
# variable (33 train = 2 steps of 16, 12 val, 3 test sets of 4), 8 months to infer
EU_TILES, EU_HR, EU_MONTHS = (11, 4, 4), 452, 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rdb_inputs(n, h, w, dtype, device, nf=NF, gc=GC):
    """x, x0 (N, nf, H, W) channels_last and five (weight, bias) pairs, from seed 0."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def act():
        t = torch.randn(n, nf, h, w, generator=gen)
        return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)

    x, x0 = act(), act()
    weights = []
    for k in range(5):
        cin, cout = nf + k * gc, gc if k < 4 else nf
        bound = 1.0 / (9 * cin) ** 0.5
        wt = (torch.rand(cout, cin, 3, 3, generator=gen) * 2 - 1) * bound
        bs = (torch.rand(cout, generator=gen) * 2 - 1) * bound
        weights.append((wt.to(device, dtype), bs.to(device, dtype)))
    return x, x0, weights


def rdb_macs_per_px(nf=NF, gc=GC) -> int:
    return 9 * (sum((nf + k * gc) * gc for k in range(4)) + (nf + 4 * gc) * nf)


def bound(flops: float, moved: float, dtype) -> tuple:
    """(ms, "operations"|"bytes"): the least time on an H100, the larger of
    the operations over the peak rate of ``dtype`` and the bytes over the
    memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rdb_bound_ms(x: torch.Tensor, with_x0: bool, nf=NF, gc=GC):
    """Kernel A's bound: its operations, and x, x0, out once and the packed f32 weights."""
    n, _, h, w = x.shape
    weight_bytes = 4 * (rdb_macs_per_px(nf, gc) + 4 * gc + nf)
    moved = x.numel() * x.element_size() * (3 if with_x0 else 2) + weight_bytes
    return bound(2.0 * rdb_macs_per_px(nf, gc) * n * h * w, moved, x.dtype)


def phase_kernel(device, gc=GC, shapes=((16, 128, 128), (2, 45, 91)), timed=((16, 128, 128),)) -> dict:
    """Kernel A at growth width ``gc`` against rdb_reference at each of
    ``shapes``; returns {((n, h, w), with x0): numbers} for the bf16 cases of
    the shapes in ``timed``, which are also timed."""
    from climsr_tpu_torch.ops.rdb import fused_rdb, pack_rdb_weights, rdb_reference

    result = {}
    for n, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, x0, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            packed = pack_rdb_weights(weights, dtype)
            for res in (None, x0):
                got = fused_rdb(x, weights, res, packed)
                torch.cuda.synchronize()
                ref = rdb_reference(x, weights, res)
                abs_err = (got.float() - ref.float()).abs().max().item()
                rel = abs_err / ref.float().abs().max().item()
                tag = f"fused_rdb {n}x{NF}x{h}x{w} gc={gc} {str(dtype)[6:]} x0={res is not None}"
                print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {KERNEL_TOL[dtype]:g})")
                if not (rel <= KERNEL_TOL[dtype]):
                    raise AssertionError(f"{tag}: kernel disagrees with rdb_reference ({rel:.3e})")
                if (n, h, w) in timed and dtype == torch.bfloat16:
                    ms = cuda_ms(lambda: fused_rdb(x, weights, res, packed))
                    plain = cuda_ms(lambda: rdb_reference(x, weights, res))
                    bound, bound_by = rdb_bound_ms(x, res is not None, gc=gc)
                    print(f"# {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                          f"bound {bound:.4f} ms ({bound_by})")
                    result[(n, h, w), res is not None] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain,
                                                              bound_ms=bound, bound_by=bound_by)
    return result


def launch_mean(rows: list) -> dict:
    """Kernel A's numbers per launch over a path's launches (one row each):
    the times and bound averaged, the largest error."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {k: sum(r[k] for r in rows) / len(rows) for k in keys}
    by = [r["bound_by"] for r in rows]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows), bound_by=max(set(by), key=by.count), **out)


def device_breakdown(run, top: int = 6, what: str = "sweep", under: str = "") -> list:
    """Run ``run()`` under ``torch.profiler`` and print the device's busy share
    of the wall time and the kernels that take the most device time; returns
    the device rows of ``key_averages()``. With ``under``, also print the
    device time of every kernel launched inside the CPU ops whose name
    contains it (an autograd node's backward, say), by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"# profiled {what}: {wall_us / 1e6:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / wall_us:.1f}%; no device time means the trace saw no kernels)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"#   {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:100]}")
    if under:
        inside = {}

        def walk(e):
            for k in e.kernels:
                inside[k.name] = inside.get(k.name, 0.0) + k.duration / 1e3
            for c in e.cpu_children:
                walk(c)

        for e in prof.events():
            if under in e.name and not (e.cpu_parent is not None and under in e.cpu_parent.name):
                walk(e)
        print(f"# device ms inside {under} ({len(inside)} kernels; none means the trace did not link them):")
        for name, ms in sorted(inside.items(), key=lambda kv: -kv[1]):
            print(f"#   {ms:10.4f} ms  {name[:100]}")
    return kernels


@contextlib.contextmanager
def plain_rdb():
    """Run ESRGAN's dense blocks through rdb_reference instead of the kernel."""
    from climsr_tpu_torch.models import esrgan
    from climsr_tpu_torch.ops.rdb import rdb_reference

    kernel = esrgan.fused_rdb
    esrgan.fused_rdb = lambda x, weights, x0=None, packed=None: rdb_reference(x, weights, x0)
    try:
        yield
    finally:
        esrgan.fused_rdb = kernel


def seeded_esrgan(device, dtype, nf=NF, nb=NB, gc=GC):
    from climsr_tpu_torch.models import create_generator

    gen = torch.Generator(device="cpu").manual_seed(0)
    return create_generator(
        "esrgan", dtype=dtype, generator=gen, device=device,
        in_channels=3, out_channels=1, nf=nf, nb=nb, gc=gc,
    )


def phase_generator(device, nf=NF, nb=NB, gc=GC, n=16, lr=32) -> None:
    """The full-width generator through the kernel and through the plain RDB."""
    from climsr_tpu_torch.ops.rdb import fused_rdb

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, 3, lr, lr)).astype(np.float32))
    elev = torch.from_numpy(rng.normal(size=(n, 1, 4 * lr, 4 * lr)).astype(np.float32))
    mask = torch.from_numpy((rng.random((n, 1, 4 * lr, 4 * lr)) > 0.3).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        model = seeded_esrgan(device, dtype, nf, nb, gc)
        args = [t.to(device, dtype).contiguous(memory_format=torch.channels_last) for t in (x, elev, mask)]
        with torch.inference_mode():
            before = fused_rdb.launches
            got = model(*args)
            launched = fused_rdb.launches - before
            with plain_rdb():
                ref = model(*args)
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        print(f"# generator nf={nf} nb={nb} gc={gc} {n}x{lr}x{lr} -> {tuple(got.shape)} {str(dtype)[6:]}: "
              f"relative err vs plain {rel:.3e} (tol {GENERATOR_TOL[dtype]:g}), {launched} RDB launches")
        if got.shape != (n, 1, 4 * lr, 4 * lr) or not torch.isfinite(got).all():
            raise AssertionError("generator output has the wrong shape or non-finite values")
        if not (rel <= GENERATOR_TOL[dtype]):
            raise AssertionError(f"generator kernel path disagrees with the plain path ({rel:.3e})")
        if device.type == "cuda" and launched != 3 * nb:
            raise AssertionError(f"expected {3 * nb} RDB launches per forward, counted {launched}")


def make_globe(root: Path, months: int, h: int, w: int, scale: int = 4) -> None:
    """Synthetic CRU-TS world, as scripts/bench_whole_globe.py builds it: NetCDF
    months with a polar ocean strip, elevation, and a smooth land mask thresholded
    at the real 29% land fraction (about 26% once the polar strip is ocean)."""
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff
    from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series

    hr_h, hr_w = h * scale, w * scale
    strip = h // 9  # 40 of 360 rows
    rng = np.random.default_rng(0)
    data = rng.normal(10, 5, size=(months, h, w)).astype(np.float32)
    data[:, :strip, :] = np.nan
    tstamps = np.array([f"{1901 + m // 12}-{m % 12 + 1:02d}-16" for m in range(months)], dtype="datetime64[D]")
    write_climate_series(
        root / "cru_ts4.05.1901.2020.tmp.dat.nc",
        ClimateSeries("tmp", data, tstamps, np.linspace(-89, 89, h), np.linspace(-179, 179, w)),
    )
    blob = max(1, hr_h // 36)
    field = rng.normal(size=(-(-hr_h // blob), -(-hr_w // blob))).astype(np.float32)
    field = np.kron(field, np.ones((blob, blob), np.float32))[:hr_h, :hr_w]
    for ax in (0, 1):  # cheap separable smoothing
        acc = np.zeros_like(field)
        for d in range(-(blob // 2), blob // 2 + 1):
            acc += np.roll(field, d, axis=ax)
        field = acc / (2 * (blob // 2) + 1)
    mask_hr = np.where(field >= np.quantile(field, 0.71), 1.0, np.nan).astype(np.float32)
    mask_hr[: strip * scale, :] = np.nan
    write_geotiff(root / "land_mask.tif", mask_hr, GeoProfile.global_grid(hr_h, hr_w))
    elev = rng.normal(500, 300, size=(hr_h, hr_w)).astype(np.float32)
    write_geotiff(root / "elevation.tif", elev, GeoProfile.global_grid(hr_h, hr_w, nodata=None))


def phase_globe(device, months=8, h=360, w=720, nf=NF, nb=NB, gc=GC, dtype=torch.bfloat16,
                tile_size=None, tile_overlap=16) -> dict:
    """The whole-globe sweep through the kernel, checked against the plain RDB."""
    from climsr_tpu_torch.inference.datasets import CRUTSInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.ops.pack12 import MAX_ABS_ERR
    from climsr_tpu_torch.ops.rdb import fused_rdb

    scale = 4
    with tempfile.TemporaryDirectory(prefix="climsr_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        make_globe(root, months, h, w, scale)
        ds = CRUTSInferenceDataset(
            ds_path=str(root / "cru_ts4.05.1901.2020.tmp.dat.nc"),
            elevation_file=str(root / "elevation.tif"),
            land_mask_file=str(root / "land_mask.tif"),
            generator_type="esrgan",
            scaling_factor=scale,
        )
        print(f"# globe set-up (data + dataset): {time.perf_counter() - t0:.3f} s, "
              f"land fraction {ds.mask_np.mean():.4f}")
        model = seeded_esrgan(device, dtype, nf, nb, gc)

        def sweep(name):
            t = time.perf_counter()
            paths = inference_on_full_images(
                model, ds, str(root / name / "tmp"), "esrgan", batch_size=8,
                tile_size=tile_size, tile_overlap=tile_overlap, device=device,
            )
            return paths, time.perf_counter() - t

        fused_rdb.launches = 0
        paths, seconds = sweep("kernel")
        launches = fused_rdb.launches
        _, warm_seconds = sweep("kernel_warm")
        if device.type == "cuda":
            device_breakdown(lambda: sweep("profiled"))
        with plain_rdb():
            ref_paths, plain_seconds = sweep("plain")

        mask = ds.mask_np
        worst = 0.0
        if len(paths) != months:
            raise AssertionError(f"expected {months} GeoTIFFs, got {len(paths)}")
        for i, (p, rp) in enumerate(zip(paths, ref_paths)):
            arr, _ = read_geotiff(p)
            ref, _ = read_geotiff(rp)
            if arr.shape != (h * scale, w * scale):
                raise AssertionError(f"{p}: shape {arr.shape}")
            if not (np.isfinite(arr[mask]).all() and np.isnan(arr[~mask]).all()):
                raise AssertionError(f"{p}: not finite on land and NaN on ocean")
            item = ds[i]
            half_range = (float(item["max"]) - float(item["min"])) / 2
            # both readbacks quantize to 12 bits: a code step apart, plus the
            # bf16 kernel/plain difference, in the normalized [-1, 1] domain
            err = float(np.max(np.abs(arr[mask] - ref[mask]))) / half_range
            worst = max(worst, err)
        tol = 2 * MAX_ABS_ERR + GENERATOR_TOL[dtype]
        print(f"# globe: {months} months {h}x{w} -> {h * scale}x{w * scale}: worst normalized "
              f"|kernel - plain| {worst:.3e} (tol {tol:.3e}); {launches} RDB launches")
        if not (worst <= tol):
            raise AssertionError(f"whole-globe outputs disagree with the plain path ({worst:.3e})")
        return dict(launches=launches, seconds=seconds, warm_seconds=warm_seconds,
                    plain_seconds=plain_seconds, months=months)



def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    abs_err = (got.float() - ref.float()).abs().max().item()
    return abs_err, abs_err / max(ref.float().abs().max().item(), 1e-30)


def assert_bitwise_repeatable(tag: str, run) -> None:
    """Two calls of ``run()`` on the same inputs give bitwise-equal bf16 outputs, or raise."""
    first, second = run(), run()
    torch.cuda.synchronize()
    same = torch.equal(first.view(torch.int16), second.view(torch.int16))
    print(f"# {tag}: two calls on the same inputs give bitwise-equal outputs: {same}")
    if not same:
        raise AssertionError(f"{tag} is not deterministic: two calls differ")


def phase_train_kernels(device, gc=GC, shapes=B_CHECKED) -> dict:
    """Kernels B1 and B2 at growth width ``gc`` against rdb_fwd_save_reference /
    rdb_bwd_reference (in f64 for B2 in f32: the plain f32 dW, cuDNN's sum over
    every pixel, strays from the exact sums as the batch grows, past the f32
    tolerance at M8's 384 x 64 x 32 x 32, where the kernel's does not; the
    print shows both); times, bounds and B2's repeatability at the training
    shape."""
    from climsr_tpu_torch.ops.rdb import (
        fused_rdb_bwd, fused_rdb_fwd_save, pack_rdb_weights, rdb_bwd_reference, rdb_fwd_save_reference,
    )

    result = {}
    for n, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = TRAIN_KERNEL_TOL[dtype]
            x, x0, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            packed = pack_rdb_weights(weights, dtype)
            gen = torch.Generator(device="cpu").manual_seed(2)
            g = (0.01 * torch.randn(n, NF, h, w, generator=gen)).to(device, dtype).contiguous(
                memory_format=torch.channels_last)  # an upstream gradient's scale
            for res, (gy, gx) in ((None, (0.2, 1.0)), (x0, (0.04, 0.2))):
                tag = f"{n}x{NF}x{h}x{w} gc={gc} {str(dtype)[6:]} x0={res is not None}"
                out, feat = fused_rdb_fwd_save(x, weights, res, packed)
                torch.cuda.synchronize()
                ref_out, ref_feat = rdb_fwd_save_reference(x, weights, res)
                checks = {"out": rel_err(out, ref_out), "feat": rel_err(feat, ref_feat)}
                dx, dws, dbs = fused_rdb_bwd(feat, g, weights, gy, gx)
                torch.cuda.synchronize()
                ref_dx, ref_dws, ref_dbs = rdb_bwd_reference(feat, g, weights, gy, gx)
                gap = ""
                if dtype == torch.float32:  # dW sums every pixel: hold it against the exact sums
                    f32_dws = ref_dws
                    ref_dx, ref_dws, ref_dbs = rdb_bwd_reference(
                        feat.double(), g.double(), [(wt.double(), b.double()) for wt, b in weights], gy, gx)
                    gap = (f"; B2 against the plain version in f64, the plain f32 dW "
                           f"{max(rel_err(a, b)[1] for a, b in zip(f32_dws, ref_dws)):.2e} from it")
                checks["dx"] = rel_err(dx, ref_dx)
                for k in range(5):
                    checks[f"dW{k + 1}"] = rel_err(dws[k], ref_dws[k])
                    checks[f"db{k + 1}"] = rel_err(dbs[k], ref_dbs[k])
                worst = max(r for _, r in checks.values())
                print(f"# B1/B2 {tag} (gy, gx)=({gy}, {gx}): relative err "
                      + ", ".join(f"{k} {r:.2e}" for k, (_, r) in checks.items()) + f" (tol {tol:g}{gap})")
                if not (worst <= tol):
                    raise AssertionError(f"B1/B2 {tag}: kernels disagree with the plain versions ({worst:.3e})")
                if (n, dtype, res) == (TRAIN_N, torch.bfloat16, None):
                    px = n * h * w
                    total = NF + 4 * gc
                    macs = rdb_macs_per_px(gc=gc)
                    wbytes = 4 * macs + 4 * (4 * gc + NF)
                    fwd_bytes = px * 2 * (2 * NF + total) + wbytes
                    bwd_bytes = px * 2 * (total + 2 * NF) + wbytes
                    b1_bound = bound(2.0 * macs * px, fwd_bytes, dtype)
                    b2_bound = bound(4.0 * macs * px, bwd_bytes, dtype)
                    result["fused_rdb_fwd_save"] = dict(
                        max_abs_err=max(checks["out"][0], checks["feat"][0]),
                        ms=cuda_ms(lambda: fused_rdb_fwd_save(x, weights, None, packed)),
                        plain_ms=cuda_ms(lambda: rdb_fwd_save_reference(x, weights, None)),
                        bound_ms=b1_bound[0], bound_by=b1_bound[1], library_ms=None)
                    result["fused_rdb_bwd"] = dict(
                        max_abs_err=max(checks[k][0] for k in checks if k not in ("out", "feat")),
                        ms=cuda_ms(lambda: fused_rdb_bwd(feat, g, weights, gy, gx)),
                        plain_ms=cuda_ms(lambda: rdb_bwd_reference(feat, g, weights, gy, gx)),
                        bound_ms=b2_bound[0], bound_by=b2_bound[1], library_ms=None)
                    for name in ("fused_rdb_fwd_save", "fused_rdb_bwd"):
                        r = result[name]
                        print(f"# {name} {tag}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
                    passes = b2_passes(lambda: fused_rdb_bwd(feat, g, weights, gy, gx))
                    print(f"# fused_rdb_bwd {tag} device ms per call: "
                          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
                    again = fused_rdb_bwd(feat, g, weights, gy, gx)
                    torch.cuda.synchronize()
                    first = [dx, *dws, *dbs]
                    second = [again[0], *again[1], *again[2]]
                    same = all(torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))
                               for a, b in zip(first, second))
                    print(f"# fused_rdb_bwd {tag}: two calls on the same inputs give bitwise-equal dx, dW, db: {same}")
                    if not same:
                        raise AssertionError("fused_rdb_bwd is not deterministic: two calls differ")
    return result


def b2_passes(run, calls: int = 5) -> dict:
    """Device ms per call of kernel B2's parts, from :func:`device_breakdown`
    over ``calls`` calls: its dX pass, its dW pass, the fixed-order reduction
    and the wrapper's own device ops (weight packing, db_5)."""
    run()
    torch.cuda.synchronize()
    kernels = device_breakdown(lambda: [run() for _ in range(calls)], what=f"{calls} B2 calls")
    parts = dict.fromkeys(("dX", "dW", "reduce", "wrapper ops"), 0.0)
    wrapper = []
    for e in kernels:
        part = ("dX" if "rdb_bwd_dx" in e.key else "reduce" if "wgrad_reduce" in e.key
                else "dW" if "rdb_wgrad" in e.key else "wrapper ops")
        parts[part] += e.self_device_time_total / 1e3 / calls
        if part == "wrapper ops":
            wrapper.append(f"{e.self_device_time_total / 1e3 / calls:.4f} ms {e.key[:60]}")
    print("#   wrapper ops per call: " + "; ".join(wrapper))
    return parts


def phase_head_kernel(device, shapes=C_CHECKED) -> dict:
    """Kernel C against conv9_dx_c0_reference at each of ``shapes``; at the
    training shape also its times and the library's transposed conv."""
    import torch.nn.functional as F

    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, conv9_dx_c0_reference

    result = {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, 64, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
            weight = ((torch.rand(64, 3, 9, 9, generator=gen) * 2 - 1) / (81 * 3) ** 0.5).to(device, dtype)
            got = conv9_dx_c0(g, weight)
            torch.cuda.synchronize()
            ref = conv9_dx_c0_reference(g, weight)
            abs_err, rel = rel_err(got, ref)
            tag = f"conv9_dx_c0 {n}x64x{h}x{w} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {HEAD_TOL[dtype]:g})")
            if got.shape != (n, 1, h, w) or not (rel <= HEAD_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with conv9_dx_c0_reference ({rel:.3e})")
            if (n, dtype) == (TRAIN_N, torch.bfloat16):
                px = n * h * w
                b = bound(2.0 * 81 * 64 * px, px * 2 * (64 + 1) + 4 * 81 * 64, dtype)
                w0 = weight[:, :1].contiguous()
                result = dict(
                    max_abs_err=abs_err, ms=cuda_ms(lambda: conv9_dx_c0(g, weight)),
                    plain_ms=cuda_ms(lambda: conv9_dx_c0_reference(g, weight)),
                    bound_ms=b[0], bound_by=b[1],
                    library_ms=cuda_ms(lambda: F.conv_transpose2d(g, w0, padding=4)))
                print(f"# {tag}: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
                      f"library conv_transpose2d {result['library_ms']:.4f} ms, "
                      f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
                assert_bitwise_repeatable(tag, lambda: conv9_dx_c0(g, weight))
    return result


@contextlib.contextmanager
def plain_training():
    """Run FusedRDB and the fusion head's backward through the plain versions."""
    from climsr_tpu_torch.ops import head_bwd, rdb

    saved = rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd, head_bwd.conv9_dx_c0
    rdb.fused_rdb_fwd_save = lambda x, weights, x0=None, packed=None: rdb.rdb_fwd_save_reference(x, weights, x0)
    rdb.fused_rdb_bwd = rdb.rdb_bwd_reference
    head_bwd.conv9_dx_c0 = head_bwd.conv9_dx_c0_reference
    try:
        yield
    finally:
        rdb.fused_rdb_fwd_save, rdb.fused_rdb_bwd, head_bwd.conv9_dx_c0 = saved


def train_batch(n=TRAIN_N, lr=TRAIN_LR, scale=4) -> dict:
    """A seeded NCHW batch: LR (climate, elevation, mask) and an HR target that
    the generator can learn (the nearest-upsampled climate channel plus noise)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(n, 3, lr, lr, generator=gen)
    hr = torch.repeat_interleave(torch.repeat_interleave(x[:, :1], scale, 2), scale, 3)
    hr = (hr + 0.1 * torch.randn(hr.shape, generator=gen)).clamp(-1, 1)
    elev = torch.randn(n, 1, lr * scale, lr * scale, generator=gen)
    mask = (torch.rand(n, 1, lr * scale, lr * scale, generator=gen) > 0.3).float()
    return {"lr": x, "hr": hr, "elevation": elev, "mask": mask,
            "min": torch.full((n,), -30.0), "max": torch.full((n,), 40.0), "original_data": 35.0 * hr + 5.0}


def phase_pretrain(device, nb=NB, gc=GC, steps=STEPS, nf=NF) -> dict:
    """Pre-training at (nf, nb, gc) through the kernels and through the
    plain versions, ``steps`` steps each, then an eval step. The loss must
    fall over more than two steps."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig, SchedulerConfig
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.schedules import resolve_momentum_schedule, resolve_schedule
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step, make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState
    from climsr_tpu_torch.models import create_generator

    batch = {k: v.to(device) for k, v in train_batch().items()}
    lr = 1e-4
    sched = SchedulerConfig(name="one_cycle_schedule", max_lr=lr, num_training_steps=steps)
    widths = f"nf={nf} nb={nb} gc={gc}"
    counters = (fused_rdb_fwd_save, fused_rdb_bwd, conv9_dx_c0, fused_rdb)

    def run(tag: str):
        model = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                                 device=device, train=True, in_channels=3, out_channels=1, nf=nf, nb=nb, gc=gc)
        tx = build_optimizer(OptimizerConfig(name="adamw", lr=lr, weight_decay=1e-4),
                             resolve_schedule(sched, lr, steps), b1_schedule=resolve_momentum_schedule(sched, steps),
                             device=device)
        state = TrainState.create(model, tx)
        step = make_pretrain_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
        losses, norms, times = [], [], []
        for c in counters:
            c.launches = 0
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(metrics["train/loss"].item())
            norms.append(metrics["grad_norm"].item())
            times.append(time.perf_counter() - t)
        launches = [c.launches for c in counters]
        ms = 1e3 * statistics.median(times[1:])
        print(f"# pre-training {widths} {tag}: losses {['%.6f' % v for v in losses]}, grad norms "
              f"{['%.6f' % v for v in norms]}, {ms:.3f} ms/step (median of steps 2-{steps}), "
              f"{TRAIN_N / ms * 1e3:.2f} samples/s; launches B1 {launches[0]}, B2 {launches[1]}, "
              f"C {launches[2]}, A {launches[3]}")
        if not all(np.isfinite(losses + norms)):
            raise AssertionError(f"pre-training {tag}: non-finite loss or grad norm")
        return model, state, step, losses, norms, ms, launches

    model, state, step, losses, norms, ms, launches = run("through the kernels")
    expected = [3 * nb * steps, 3 * nb * steps, steps, 0]
    if launches != expected:
        raise AssertionError(f"pre-training {widths}: expected launches B1, B2, C, A = {expected}, "
                             f"counted {launches}")
    if steps > 2 and not losses[-1] < losses[0]:
        raise AssertionError(f"pre-training {widths}: the loss did not decrease ({losses[0]} -> {losses[-1]})")
    # the fusion head's backward: kernel C and the wrapper's other device ops
    device_breakdown(lambda: step(state, batch), what=f"pre-training step {widths}", under="FusionConv1Backward")
    with plain_training():
        *_, plain_losses, plain_norms, plain_ms, _ = run("through the plain versions")
    loss_err = abs(losses[0] - plain_losses[0]) / abs(plain_losses[0])
    norm_err = abs(norms[0] - plain_norms[0]) / abs(plain_norms[0])
    traj_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"# pre-training {widths} kernels vs plain: step-1 loss {loss_err:.2e} (tol {STEP_LOSS_TOL:g}), "
          f"step-1 grad norm {norm_err:.2e} (tol {STEP_GRAD_NORM_TOL:g}), loss trajectory {traj_err:.2e} "
          f"(tol {TRAJECTORY_TOL:g})")
    if not (loss_err <= STEP_LOSS_TOL and norm_err <= STEP_GRAD_NORM_TOL and traj_err <= TRAJECTORY_TOL):
        raise AssertionError(f"pre-training {widths} through the kernels disagrees with the plain versions")

    eval_step = make_eval_step(model, "esrgan", compute_dtype=torch.bfloat16, device=device)
    fused_rdb.launches = 0
    metrics = eval_step(batch)
    a_launches = fused_rdb.launches
    bad = sorted(k for k, v in metrics.items() if not torch.isfinite(v).item())
    print(f"# eval step {widths}: {len(metrics) - 2} metrics + 2 losses, {a_launches} A launches; "
          + ", ".join(f"{k} {v.item():.4f}" for k, v in sorted(metrics.items())))
    if len(metrics) != 18 or bad:
        raise AssertionError(f"eval step: expected 16 finite metrics and 2 losses, non-finite {bad}")
    if a_launches != 3 * nb:
        raise AssertionError(f"eval step: expected {3 * nb} A launches, counted {a_launches}")
    return dict(launches=dict(zip(("fused_rdb_fwd_save", "fused_rdb_bwd", "conv9_dx_c0"), launches)),
                ms=ms, plain_ms=plain_ms)


def phase_rdb_nhwc(device, gc=GC) -> dict:
    """Kernel D's entry, ``fused_rdb_nhwc`` (NHWC in and out, HWIO weights),
    at growth width ``gc`` against rdb_reference. Its timed call packs the
    weights, as the JAX ``fused_rdb`` takes raw ones."""
    from climsr_tpu_torch.ops.rdb import fused_rdb_nhwc, rdb_reference

    result = {}
    for n, h, w in ((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45)):
        for dtype in (torch.float32, torch.bfloat16):
            x, _, weights = rdb_inputs(n, h, w, dtype, device, gc=gc)
            xn = x.permute(0, 2, 3, 1)  # the NHWC view of channels_last storage
            hwio = [t for wt, bs in weights for t in (wt.permute(2, 3, 1, 0), bs)]
            got = fused_rdb_nhwc(xn, *hwio)
            torch.cuda.synchronize()
            ref = rdb_reference(x, weights).permute(0, 2, 3, 1)
            abs_err, rel = rel_err(got, ref)
            tag = f"fused_rdb_nhwc {n}x{h}x{w}x{NF} gc={gc} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {TAIL_TOL[dtype]:g})")
            if got.shape != xn.shape or not (rel <= TAIL_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with rdb_reference ({rel:.3e})")
            if (n, dtype) == (TRAIN_N, torch.bfloat16):
                b = rdb_bound_ms(x, False, gc=gc)
                result = dict(max_abs_err=abs_err, ms=cuda_ms(lambda: fused_rdb_nhwc(xn, *hwio)),
                              plain_ms=cuda_ms(lambda: rdb_reference(x, weights)),
                              bound_ms=b[0], bound_by=b[1], library_ms=None)
                print(f"# {tag}: kernel {result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms, "
                      f"bound {result['bound_ms']:.4f} ms ({result['bound_by']})")
    return result


def tail_inputs(n, h, w, dtype, device):
    """x (N, 64, H, W) channels_last and (whr, bhr, wcl, bcl) OIHW, from seed 0."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(n, NF, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
    bound = 1.0 / (9 * NF) ** 0.5
    shapes = ((NF, NF, 3, 3), (NF,), (1, NF, 3, 3), (1,))
    return x, [((torch.rand(s, generator=gen) * 2 - 1) * bound).to(device) for s in shapes]


def hr_tail_bound(x: torch.Tensor) -> tuple:
    """Kernel E's bound: HRconv 64 -> 64 and conv_last 64 -> 1, x and out once and the weights."""
    px = x.shape[0] * x.shape[2] * x.shape[3]
    flops = 2.0 * 9 * NF * (NF + 1) * px
    return bound(flops, px * 2 * (NF + 1) + 2 * 9 * NF * (NF + 1) + 4 * (NF + 1), x.dtype)


def phase_hr_tail(device) -> dict:
    """Kernel E against hr_tail_reference (the library's two cuDNN convs), at
    the training head's shape, a ragged one and, timed too but not listed,
    the sweep's HR head (16 tiles of 512 x 512)."""
    from climsr_tpu_torch.ops.head import fused_hr_tail, hr_tail_reference

    result = {}
    for n, h, w in ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91), (16, 512, 512)):
        for dtype in (torch.float32, torch.bfloat16) if n != 16 else (torch.bfloat16,):
            x, weights = tail_inputs(n, h, w, dtype, device)
            got = fused_hr_tail(x, *weights)
            torch.cuda.synchronize()
            ref = hr_tail_reference(x, weights)
            abs_err, rel = rel_err(got, ref)
            tag = f"fused_hr_tail {n}x{NF}x{h}x{w} {str(dtype)[6:]}"
            print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {TAIL_TOL[dtype]:g})")
            if got.shape != (n, 1, h, w) or not (rel <= TAIL_TOL[dtype]):
                raise AssertionError(f"{tag}: kernel disagrees with hr_tail_reference ({rel:.3e})")
            if dtype == torch.bfloat16 and n in (TRAIN_N, 16):
                b = hr_tail_bound(x)
                timed = dict(max_abs_err=abs_err, ms=cuda_ms(lambda: fused_hr_tail(x, *weights)),
                             plain_ms=cuda_ms(lambda: hr_tail_reference(x, weights)),
                             bound_ms=b[0], bound_by=b[1], library_ms=None)
                print(f"# {tag}: kernel {timed['ms']:.4f} ms, plain (cuDNN's two convs) {timed['plain_ms']:.4f} ms, "
                      f"bound {timed['bound_ms']:.4f} ms ({timed['bound_by']})")
                assert_bitwise_repeatable(tag, lambda: fused_hr_tail(x, *weights))
                if n == TRAIN_N:
                    result = timed
    return result


def phase_dc0(device) -> None:
    """Kernel F, both variants, against dc0_reference (the probe times them);
    each call launches kernel C, counted as F's and not as C's."""
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0, dc0_reference

    before = dc0.launches, conv9_dx_c0.launches
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n, h, w in ((TRAIN_N, 4 * TRAIN_LR, 4 * TRAIN_LR), (2, 45, 91)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(n, 64, h, w, generator=gen).to(device, dtype).contiguous(memory_format=torch.channels_last)
            w1c0 = ((torch.rand(9, 9, 64, generator=gen) * 2 - 1) / 72).to(device)
            ref = dc0_reference(g, w1c0)
            for variant in ("flat", "dyfac"):
                got = dc0(g, w1c0, variant)
                torch.cuda.synchronize()
                abs_err, rel = rel_err(got, ref)
                tag = f"dc0 {variant} {n}x64x{h}x{w} {str(dtype)[6:]}"
                print(f"# {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} (tol {HEAD_TOL[dtype]:g})")
                if got.shape != (n, 1, h, w) or not (rel <= HEAD_TOL[dtype]):
                    raise AssertionError(f"{tag}: kernel disagrees with dc0_reference ({rel:.3e})")
    counted = dc0.launches - before[0], conv9_dx_c0.launches - before[1]
    print(f"# dc0: {counted[0]} F launches (kernel C's kernel), {counted[1]} counted as C")
    if counted != (8, 0):
        raise AssertionError(f"dc0: expected 8 F launches and 0 C launches, counted {counted}")


def path_rdb_nhwc_and_hr_tail(device) -> dict:
    """D's and E's own paths, their counts reset just before and read just
    after: the flagship generator's first RRDB (x + 0.2 * RDB3(RDB2(RDB1(x))))
    through ``fused_rdb_nhwc`` in NHWC, and its HR tail (lrelu, HRconv, lrelu,
    conv_last) through ``fused_hr_tail`` on its upconv2 output, each against
    the generator's own modules on the training batch's LR input (bf16)."""
    from climsr_tpu_torch.models.common import leaky_relu
    from climsr_tpu_torch.ops import head, rdb
    from climsr_tpu_torch.ops.fused_upsample_conv import nearest_up2_conv3

    dtype = torch.bfloat16
    model = seeded_esrgan(device, dtype)
    lr = train_batch()["lr"].to(device, dtype).contiguous(memory_format=torch.channels_last)
    launches = {}
    with torch.inference_mode():
        fea = model.conv_first(lr).contiguous(memory_format=torch.channels_last)
        rrdb = model.RRDB_trunk[0]
        want = rrdb(fea).permute(0, 2, 3, 1)
        rdb.fused_rdb_nhwc.launches = 0
        y = fea.permute(0, 2, 3, 1)
        for block in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            y = rdb.fused_rdb_nhwc(y, *(t for wt, bs in block.weights() for t in (wt.permute(2, 3, 1, 0), bs)))
        got = fea.permute(0, 2, 3, 1) + 0.2 * y
        launches["fused_rdb_nhwc"] = rdb.fused_rdb_nhwc.launches
        checks = {"fused_rdb_nhwc (first RRDB)": rel_err(got, want)}

        trunk = fea + model.trunk_conv(model.RRDB_trunk(fea))
        up = leaky_relu(nearest_up2_conv3(trunk, model.upconv1.weight, model.upconv1.bias))
        pre = nearest_up2_conv3(up, model.upconv2.weight, model.upconv2.bias)
        want = model.conv_last(leaky_relu(model.HRconv(leaky_relu(pre))))
        head.fused_hr_tail.launches = 0
        got = head.fused_hr_tail(pre.contiguous(memory_format=torch.channels_last), model.HRconv.weight,
                                 model.HRconv.bias, model.conv_last.weight, model.conv_last.bias)
        launches["fused_hr_tail"] = head.fused_hr_tail.launches
        checks[f"fused_hr_tail (HR head {tuple(pre.shape)})"] = rel_err(got, want)
    for tag, (abs_err, rel) in checks.items():
        print(f"# own path {tag}: max_abs_err {abs_err:.3e}, relative {rel:.3e} against the generator's "
              f"modules (tol {PATH_TOL[dtype]:g})")
        if not (rel <= PATH_TOL[dtype]):
            raise AssertionError(f"{tag} disagrees with the generator's own modules ({rel:.3e})")
    print(f"# own paths: launches {launches}")
    if launches != {"fused_rdb_nhwc": 3, "fused_hr_tail": 1}:
        raise AssertionError(f"D's and E's own paths: expected 3 and 1 launches, counted {launches}")
    return launches


def phase_probe(device) -> dict:
    """The probe's own path: F1 and F2 checked and timed, their counts reset
    just before and read just after. Returns F1's and F2's numbers."""
    from climsr_tpu_torch.ops.head_bwd import dc0
    from climsr_tpu_torch.scripts import bench_head_bwd_probe as probe_mod

    dc0.launches = 0
    dc0.variant_launches.update(dict.fromkeys(dc0.variant_launches, 0))
    res = probe_mod.probe(device)
    launches = dict(dc0.variant_launches)
    px = probe_mod.B * probe_mod.H * probe_mod.W
    b = bound(2.0 * 81 * probe_mod.C * px, px * 2 * (probe_mod.C + 1) + 4 * 81 * probe_mod.C, torch.bfloat16)
    out = {}
    for variant in ("flat", "dyfac"):
        r = res[f"dc0_{variant}"]
        out[f"dc0_{variant}"] = dict(
            launches=launches[variant], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=res["plain dc0_reference"]["ms"], bound_ms=b[0], bound_by=b[1],
            library_ms=res["library conv_transpose2d"]["ms"])
    print(f"# probe: launches {launches}; bound {b[0]:.4f} ms ({b[1]}); kernel C {res['kernel C conv9_dx_c0']['ms']:.4f} ms")
    if min(launches.values()) < 1:
        raise AssertionError(f"probe: a variant of kernel F was never launched ({launches})")
    return out


def phase_gan(device) -> dict:
    """The GAN fine-tune at full width through the kernels and through the plain versions."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
    from climsr_tpu_torch.models import create_discriminator, create_generator
    from climsr_tpu_torch.ops.head import fused_hr_tail
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save, fused_rdb_nhwc
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step, make_gan_val_losses
    from climsr_tpu_torch.training.train_state import GANTrainState

    batch = {k: v.to(device) for k, v in train_batch().items()}
    lr, dtype = 1e-4, torch.bfloat16
    perceptual = build_perceptual_loss(compute_dtype=dtype, cutoff="conv5_4", device=device)
    counters = (fused_rdb_fwd_save, fused_rdb_bwd, conv9_dx_c0, fused_rdb, fused_rdb_nhwc, fused_hr_tail, dc0)
    names = ("B1", "B2", "C", "A", "D", "E", "F")

    def run(tag: str):
        g = create_generator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(0), device=device,
                             train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
        d = create_discriminator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(1), device=device,
                                 train=True, in_channels=1, out_channels=64, hr_size=4 * TRAIN_LR)
        if d.classification[0].in_features != 8192:
            raise AssertionError(f"fc1 takes {d.classification[0].in_features} inputs, not 8192")

        def tx():
            return build_optimizer(OptimizerConfig(name="adam", lr=lr, weight_decay=1e-4), lambda s: lr,
                                   device=device)

        state = GANTrainState.create(g, tx(), d, tx())
        step = make_gan_step(g, d, "esrgan", perceptual_fn=perceptual, compute_dtype=dtype, device=device)
        trace, times = [], []
        for c in counters:
            c.launches = 0
        for _ in range(GAN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            trace.append({k: v.item() for k, v in metrics.items()})
            times.append(time.perf_counter() - t)
        launches = dict(zip(names, (c.launches for c in counters)))
        ms = 1e3 * statistics.median(times[1:])
        print(f"# GAN {tag}: loss_G {['%.6f' % m['train/loss_G'] for m in trace]}, loss_D "
              f"{['%.6f' % m['train/loss_D'] for m in trace]}; step 1 terms "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(trace[0].items()))
              + f"; {ms:.3f} ms/step (median of steps 2-{GAN_STEPS}), {TRAIN_N / ms * 1e3:.2f} samples/s; "
              f"launches {launches}")
        if not all(np.isfinite(v) for m in trace for v in m.values()):
            raise AssertionError(f"GAN {tag}: a non-finite loss")
        return g, d, state, step, trace, ms, launches

    g, d, state, step, trace, ms, launches = run("through the kernels")
    expected = dict(B1=3 * NB * GAN_STEPS, B2=3 * NB * GAN_STEPS, C=GAN_STEPS, A=0, D=0, E=0, F=0)
    if launches != expected:
        raise AssertionError(f"GAN: expected launches {expected}, counted {launches}")
    device_breakdown(lambda: step(state, batch), what="GAN step")
    with plain_training():
        *_, plain_trace, plain_ms, _ = run("through the plain versions")
    worst = 0.0
    for k in ("train/loss_G", "train/loss_D"):
        for a, b in zip(trace, plain_trace):
            worst = max(worst, abs(a[k] - b[k]) / abs(b[k]))
    print(f"# GAN kernels vs plain: worst relative difference of loss_G and loss_D over {GAN_STEPS} steps "
          f"{worst:.2e} (tol {GAN_LOSS_TOL:g})")
    if not (worst <= GAN_LOSS_TOL):
        raise AssertionError("the GAN step through the kernels disagrees with the plain versions")

    val = make_gan_val_losses(g, d, "esrgan", perceptual_fn=perceptual, compute_dtype=dtype, device=device)
    fused_rdb.launches = 0
    losses = val(batch)
    a_launches = fused_rdb.launches
    print(f"# GAN val losses: {a_launches} A launches; "
          + ", ".join(f"{k} {v.item():.6f}" for k, v in sorted(losses.items())))
    if len(losses) != 3 or not all(torch.isfinite(v).item() for v in losses.values()):
        raise AssertionError(f"GAN val losses: expected 3 finite losses, got {losses}")
    if a_launches != 3 * NB:
        raise AssertionError(f"GAN val losses: expected {3 * NB} A launches, counted {a_launches}")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms)


# ---- the training entry point (phases 13, B, C, D) ---------------------------

def metric_rows(path: Path) -> list:
    """metrics.csv (a header row before each block of rows) -> [{column: float}]."""
    rows, header = [], None
    for line in path.read_text().splitlines():
        cells = line.split(",")
        if cells[0] == "step":
            header = cells
        else:
            rows.append({k: float(v) for k, v in zip(header, cells)})
    return rows


@contextlib.contextmanager
def keep_trainers(into: list):
    """Keep each Trainer that ``cli.train.run`` closes (its models, its graft)."""
    from climsr_tpu_torch.training import loop

    close = loop.Trainer.close

    def keep(self):
        into.append(self)
        close(self)

    loop.Trainer.close = keep
    try:
        yield
    finally:
        loop.Trainer.close = close


def fit_entry_point(device, root: Path, tag: str, overrides: list, tables: dict, profile: bool = False) -> dict:
    """``compose`` + ``cli.train.run`` with the datamodule on ``tables``; the
    run's Trainer, metrics rows, wall, peak device memory and kernel launches.
    With ``profile``, one more train step of the fitted Trainer runs under
    ``torch.profiler`` (the device's busy share, the top kernels) after the
    numbers are taken."""
    from climsr_tpu_torch.cli.train import run
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.config.schemas import SuperResolutionDataConfig, from_dict
    from climsr_tpu_torch.data.datamodule import SuperResolutionDataModule

    counters = kernel_counters()
    cfg = compose(default_config_dir(), "config", overrides + [
        "trainer.log_every_n_steps=1", "logger=csv", "print_config=false", f"training.output_dir={root / tag}"])
    dm = SuperResolutionDataModule(from_dict(SuperResolutionDataConfig, cfg["datamodule"]["cfg"]), tables=tables)
    for c in counters.values():
        c.launches = 0
    trainers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with keep_trainers(trainers):
        hp = run(cfg, datamodule=dm, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (run_dir,) = (root / tag / "outputs" / "runs" / cfg["training"]["generator_type"]).iterdir()
    rows = metric_rows(run_dir / "metrics.csv") if (run_dir / "metrics.csv").exists() else []  # none without a fit
    peak_gb, launches = torch.cuda.max_memory_allocated() / 1e9, {k: c.launches for k, c in counters.items()}
    if profile and device.type == "cuda":
        tr = trainers[0]
        batch = next(iter(tr.train_loader))  # an index batch into the tile store on the card
        device_breakdown(lambda: tr.train_step(tr.state, batch), top=8, what=f"{tag} train step")
    return dict(cfg=cfg, dm=dm, trainer=trainers[0], run_dir=run_dir, hp=hp, wall=wall,
                peak_gb=peak_gb, launches=launches,
                train=[r for r in rows if any(k.startswith("train/loss") for k in r)],
                val=[r for r in rows if "val/rmse" in r], test=[r for r in rows if any("test/" in k for k in r)])


def kernel_counters() -> dict:
    """Each kernel's launch-counting wrapper, by the label the PERF table gives it."""
    from climsr_tpu_torch.ops.head import fused_hr_tail
    from climsr_tpu_torch.ops.head_bwd import conv9_dx_c0, dc0
    from climsr_tpu_torch.ops.rdb import fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save, fused_rdb_nhwc

    return dict(A=fused_rdb, B1=fused_rdb_fwd_save, B2=fused_rdb_bwd, C=conv9_dx_c0, D=fused_rdb_nhwc,
                E=fused_hr_tail, F=dc0)


def report_fit(tag: str, r: dict, loss_key: str, card: str) -> None:
    """Print a fit's logged trajectory, rates, peak memory and launches; raise on a non-finite value."""
    steps = [int(x["step"]) for x in r["train"]]
    print(f"# {tag}: {r['wall']:.3f} s for fit + test, hp_metric {r['hp']:.6f}; {loss_key} "
          f"{['%.6f' % x[loss_key] for x in r['train']]} at steps {steps}, val/rmse "
          f"{['%.6f' % x['val/rmse'] for x in r['val']]}; train/samples_per_sec "
          f"{['%.2f' % x['train/samples_per_sec'] for x in r['train']]}; peak device memory {r['peak_gb']:.3f} GB "
          f"({card}); launches {r['launches']}")
    values = [x[loss_key] for x in r["train"]] + [x["val/rmse"] for x in r["val"]]
    if not all(np.isfinite(values)) or not np.isfinite(r["hp"]):
        raise AssertionError(f"{tag}: a non-finite loss or metric")


def phase_trainer(device, step_ms: float, card: str, root: Path) -> dict:
    """The training entry point end to end: the composed ``esrgan_pre_training``
    experiment through ``cli.train.run`` on a synthetic WorldClim set (tiles on
    the card, device augmentation), through the kernels and then through the
    plain versions from the same seed; the best checkpoint read back. The set
    and the runs live under ``root``; returns the set's tables and the best
    checkpoint's path beside the numbers."""
    from climsr_tpu_torch.data.pipeline import DataLoader, build_eval_device_store, device_prefetch, gather
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.models import apply_generator_batch, create_generator
    from climsr_tpu_torch.training.checkpoint import CheckpointManager
    from climsr_tpu_torch.training.tasks.pretrain import make_eval_step

    t = time.perf_counter()
    tables = make_synthetic_dataset(root / "ds", n_tiles_per_stage=TRAINER_TILES, seed=0, write_index=False)
    data_s = time.perf_counter() - t
    overrides = ["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                 f"trainer.max_epochs={TRAINER_EPOCHS}", "profiler=simple"]

    def fit(tag: str) -> dict:
        r = fit_entry_point(device, root, tag, overrides, tables)
        report_fit(f"trainer {tag}", r, "train/loss", card)
        for line in (r["run_dir"] / "profile_stages.txt").read_text().splitlines():
            print(f"#   stage {line.strip()}")
        return r

    r = fit("kernels")
    cfg, dm, run_dir, train, val, launches, wall = (r[k] for k in ("cfg", "dm", "run_dir", "train", "val",
                                                                   "launches", "wall"))
    trained = r["trainer"].g_model
    cfg_ = cfg["datamodule"]["cfg"]
    n_train, bs, vbs = 3 * TRAINER_TILES[0], cfg_["batch_size"], cfg_["validation_batch_size"]
    steps = TRAINER_EPOCHS * (n_train // bs)
    def sizes(n):  # the eval batches of a set of n tiles (a padded tail runs on its valid prefix)
        return [min(vbs, n - i) for i in range(0, n, vbs)]

    eval_sizes = TRAINER_EPOCHS * sizes(3 * TRAINER_TILES[1]) + 3 * sizes(TRAINER_TILES[2])
    eval_batches = len(eval_sizes)
    if {(n, TRAIN_LR, TRAIN_LR) for n in eval_sizes} != set(EVAL_SHAPES):
        raise AssertionError(f"trainer: eval batches {eval_sizes} are not kernel A's timed shapes {EVAL_SHAPES}")
    gen = cfg["generator"]
    nb = gen["nb"]
    expected = dict(A=3 * nb * eval_batches, B1=3 * nb * steps, B2=3 * nb * steps, C=steps, D=0, E=0, F=0)
    print(f"# trainer launches: {steps} steps x (3 x nb={nb} B1 + 3 x nb B2 + 1 C), {eval_batches} eval batches "
          f"({TRAINER_EPOCHS} val + 3 test) x 3 x nb A = {expected}; counted {launches}")
    if launches != expected or len(train) != steps or len(val) != TRAINER_EPOCHS:
        raise AssertionError(f"trainer: expected launches {expected} over {steps} logged steps and "
                             f"{TRAINER_EPOCHS} validations, counted {launches}, {len(train)}, {len(val)}")
    if (gen["nf"], nb, gen["gc"], bs, cfg["trainer"]["precision"]) != (NF, NB, GC, TRAIN_N, "bf16"):
        raise AssertionError(f"trainer: the composed config is not the flagship at batch {TRAIN_N}: {gen}")

    with plain_rdb(), plain_training():
        plain = fit("plain")
    plain_train, plain_val, plain_wall = plain["train"], plain["val"], plain["wall"]
    pairs = [(a["train/loss"], b["train/loss"]) for a, b in zip(train, plain_train)]
    pairs += [(a["val/rmse"], b["val/rmse"]) for a, b in zip(val, plain_val)]
    traj_err = max(abs(a - b) / abs(b) for a, b in pairs)
    print(f"# trainer kernels vs plain: train/loss and val/rmse within {traj_err:.2e} (relative; tol "
          f"{TRAJECTORY_TOL:g})")
    if not traj_err <= TRAJECTORY_TOL or not all(np.isfinite(a) for a, _ in pairs):
        raise AssertionError("trainer through the kernels disagrees with the plain versions")

    # the best checkpoint into a fresh generator: its validation reproduces
    # the logged val/rmse; the latest gives the trained model's output
    mgr = CheckpointManager(run_dir / "checkpoints", save_top_k=-1)
    kw = dict(dtype=torch.bfloat16, device=device, train=True, in_channels=3, out_channels=1, nf=gen["nf"],
              nb=nb, gc=gen["gc"])
    store = build_eval_device_store(dm.val_dataset, device=device)
    n_val = len(dm.val_dataset)
    batches = [gather(store, torch.arange(i, min(i + vbs, n_val), device=device)) for i in range(0, n_val, vbs)]
    fresh = create_generator("esrgan", **kw)
    fresh.load_state_dict(load_generator_checkpoint(mgr.path(mgr.best_step)), strict=True)
    eval_step = make_eval_step(fresh, "esrgan", device=device)
    # the Trainer's epoch mean: batch means weighted by batch size
    best_rmse = sum(eval_step(b)["val/rmse"].item() * len(b["hr"]) for b in batches) / n_val
    batch = batches[0]
    logged = next(r["val/rmse"] for r in val if r["step"] == mgr.best_step)
    latest = create_generator("esrgan", **kw)
    latest.load_state_dict(load_generator_checkpoint(mgr.path(mgr.latest_step)), strict=True)
    tiles = {k: v[:16] for k, v in batch.items()}
    with torch.inference_mode():
        out = [apply_generator_batch("esrgan", m, tiles, torch.bfloat16) for m in (latest, trained)]
    ckpt_err = (out[0] - out[1]).abs().max().item()
    print(f"# trainer checkpoints: best step {mgr.best_step} re-validated val/rmse {best_rmse:.6f} against "
          f"logged {logged:.6f}; latest step {mgr.latest_step} on 16 tiles: max |loaded - trained| {ckpt_err:.3e}")
    if abs(best_rmse - logged) > 1e-5 * abs(logged) or ckpt_err != 0.0:
        raise AssertionError("trainer: a checkpoint read back does not give the trained model's numbers")

    # kernel A in the trained generator on this path's eval inputs (a
    # validation batch of 192, and of 64 as a test set's), against the
    # plain RDB on the same inputs
    for n in sorted(set(eval_sizes)):
        tiles = {k: v[:n] for k, v in batch.items()}
        with torch.inference_mode():
            got = apply_generator_batch("esrgan", trained, tiles, torch.bfloat16)
            with plain_rdb():
                ref = apply_generator_batch("esrgan", trained, tiles, torch.bfloat16)
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        print(f"# trainer's generator on {n} val tiles, kernel A against the plain RDB: relative err {rel:.3e} "
              f"(tol {GENERATOR_TOL[torch.bfloat16]:g})")
        if not rel <= GENERATOR_TOL[torch.bfloat16] or not torch.isfinite(got).all():
            raise AssertionError(f"trainer: the trained generator through kernel A disagrees with the plain RDB")

    # the streaming path (no device store): the val loader through pinned
    # memory and a side stream gives the store's batches bit for bit
    loader = DataLoader(dm.val_dataset, vbs, shuffle=False, drop_last=False, pad_last=True, num_workers=8)
    n = 0
    for got, want in zip(device_prefetch(iter(loader), device), batches):
        nv = len(want["hr"])
        if got["hr"].device != want["hr"].device or not all(torch.equal(got[k][:nv], v) for k, v in want.items()):
            raise AssertionError("device_prefetch: a batch differs from the device store's")
        n += 1
    print(f"# device_prefetch: {n} val batch(es) through pinned host memory and a side stream equal the "
          f"device store's, bit for bit")

    sps = train[-1]["train/samples_per_sec"]
    print(f"# trainer samples/s: {sps:.2f} (train/samples_per_sec at step {steps}, epoch {TRAINER_EPOCHS}) against "
          f"{TRAIN_N / step_ms * 1e3:.2f} for phase 7's bare step at batch {TRAIN_N}; fit + test {wall:.3f} s "
          f"({plain_wall:.3f} s plain); synthetic set {data_s:.3f} s ({card})")
    return dict(launches=launches, samples_per_sec=sps, eval_sizes=eval_sizes, tables=tables,
                best_ckpt=mgr.path(mgr.best_step), train_loss=[r["train/loss"] for r in train],
                val_rmse=[r["val/rmse"] for r in val])


# ---- phases A-D: the RCAN, DRLN and RFB-ESRGAN families ---------------------

def family_model(name: str, device, dtype, train: bool = False):
    """A family at its published width (``conf/generator``; the RFB
    discriminator at HR 128), seeded: the same weights on every device and in
    every dtype (bf16 rounds them)."""
    from climsr_tpu_torch.models import create_discriminator, create_generator

    gen = torch.Generator().manual_seed(0)
    if name == "rfb_discriminator":
        return create_discriminator("rfb_esrgan", dtype=dtype, generator=gen, device=device, train=train, in_channels=1)
    return create_generator(name, dtype=dtype, generator=gen, device=device, in_channels=3, out_channels=1,
                            scaling_factor=4, **FAMILIES[name])


def family_inputs(name: str, n: int, device, dtype) -> tuple:
    """Seeded inputs: n LR tiles of 32x32 (with elevation and mask for RCAN), or n HR tiles of 128."""
    gen = torch.Generator().manual_seed(2)
    if name == "rfb_discriminator":
        args = (torch.rand(n, 1, 4 * TRAIN_LR, 4 * TRAIN_LR, generator=gen) * 2 - 1,)
    else:
        args = (torch.randn(n, 3, TRAIN_LR, TRAIN_LR, generator=gen),)
        if name == "rcan":
            hr = (n, 1, 4 * TRAIN_LR, 4 * TRAIN_LR)
            args += (torch.randn(hr, generator=gen), (torch.rand(hr, generator=gen) > 0.3).float())
    return tuple(a.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last) for a in args)


def family_forward(name: str, model, args) -> torch.Tensor:
    """The generator's output, or the discriminator's logits (before its sigmoid,
    which would hide the differences near 0.5)."""
    return model.logits(*args) if name == "rfb_discriminator" else model(*args)


def phase_families(device, card: str) -> dict:
    """Phase A: each family's modules at full width, on the card in f32 (TF32
    off) against the same module and weights on the CPU, and in bf16 against
    f32 on the card; each one's forward ms at batch 192 in bf16."""
    out = {}
    for name in (*FAMILIES, "rfb_discriminator"):
        train = name == "rfb_discriminator"  # the GAN step runs D in train mode (batch statistics)
        cpu_model = family_model(name, torch.device("cpu"), torch.float32, train)
        with torch.no_grad():
            ref = family_forward(name, cpu_model, family_inputs(name, FAMILY_N, torch.device("cpu"), torch.float32))
        n_params = sum(p.numel() for p in cpu_model.parameters())
        del cpu_model
        got = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = family_model(name, device, dtype, train)
            with torch.no_grad():
                got[dtype] = family_forward(name, model, family_inputs(name, FAMILY_N, device, dtype)).float()
        _, cpu_rel = rel_err(got[torch.float32].cpu(), ref)
        _, bf16_rel = rel_err(got[torch.bfloat16], got[torch.float32])
        args = family_inputs(name, TRAIN_N, device, torch.bfloat16)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(*args), reps=3, inner=2)
            if device.type == "cuda":
                device_breakdown(lambda: model(*args), top=5, what=f"{name} forward at batch {TRAIN_N}")
        print(f"# family {name} ({n_params / 1e6:.2f}M params) on {FAMILY_N} tiles -> {tuple(ref.shape)}: card f32 "
              f"vs CPU f32 {cpu_rel:.3e} (tol {FAMILY_CPU_TOL:g}), card bf16 vs card f32 {bf16_rel:.3e} (tol "
              f"{FAMILY_BF16_TOL:g}); forward {ms:.3f} ms at batch {TRAIN_N} bf16 ({card})")
        if not (torch.isfinite(got[torch.bfloat16]).all() and cpu_rel <= FAMILY_CPU_TOL
                and bf16_rel <= FAMILY_BF16_TOL):
            raise AssertionError(f"family {name}: the card disagrees with the CPU or bf16 with f32")
        out[name] = dict(ms=ms, cpu_rel=cpu_rel, bf16_rel=bf16_rel)
        del model, args
        torch.cuda.empty_cache()
    return out


def make_europe_months(root: Path, months: int, seed: int = 3) -> dict:
    """Synthetic europe-extent inference inputs: ``months`` LR GeoTIFFs of
    113x113 (0.5 deg), a 452x452 elevation and land mask (NaN on sea, ~30%),
    and the min-max table ``GeoTiffInferenceDataset`` reads."""
    from climsr_tpu_torch.consts.datasets_and_preprocessing import europe_bbox_hr
    from climsr_tpu_torch.data.tables import Table
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff

    rng = np.random.default_rng(seed)
    hr, lr = EU_HR, EU_HR // 4
    (x0, y0), _ = europe_bbox_hr
    hr_prof = GeoProfile(width=hr, height=hr, origin_x=x0, origin_y=y0, pixel_size_x=0.125, pixel_size_y=0.125,
                         nodata=np.nan)
    yy, xx = np.meshgrid(np.linspace(0, 1, hr), np.linspace(0, 1, hr), indexing="ij")
    field = np.cos(5 * xx + 1.0) * np.cos(4 * yy) + 0.3 * np.sin(11 * xx * yy)
    mask = np.where(field < np.quantile(field, 0.7), 1.0, np.nan).astype(np.float32)
    write_geotiff(root / "land_mask.tif", mask, hr_prof)
    write_geotiff(root / "elevation.tif", rng.normal(500, 300, (hr, hr)).astype(np.float32), hr_prof)
    lr_prof = GeoProfile(width=lr, height=lr, origin_x=x0, origin_y=y0, pixel_size_x=0.5, pixel_size_y=0.5,
                         nodata=np.nan)
    names = [f"tmp_2001-{m + 1:02d}.tif" for m in range(months)]
    for name in names:
        write_geotiff(root / "tiffs" / name, rng.normal(10, 5, (lr, lr)).astype(np.float32), lr_prof)
    table = Table({"filename": names, "min": [-10.0] * months, "max": [30.0] * months,
                   "global_min": [-15.0] * months, "global_max": [35.0] * months})
    return dict(tiff_dir=str(root / "tiffs"), tiff_df=table, elevation_file=str(root / "elevation.tif"),
                land_mask_file=str(root / "land_mask.tif"), mask=~np.isnan(mask))


def phase_rcan(device, root: Path, world_tables: dict, eu_tables: dict, card: str) -> dict:
    """Phase B: RCAN as the reference ships it, through the entry points:
    ``rcan_pre_training`` on the world set, ``rcan_fine_tuning`` from its best
    checkpoint on the europe-extent set, and the fine-tuned model over 8
    europe-extent GeoTIFF months (the whole-frame path)."""
    from climsr_tpu_torch.inference.datasets import GeoTiffInferenceDataset
    from climsr_tpu_torch.inference.run import inference_on_full_images, load_generator
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.training.checkpoint import CheckpointManager

    pre = fit_entry_point(device, root, "rcan_pre", [
        "experiment=rcan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
        f"trainer.max_epochs={TRAINER_EPOCHS}"], world_tables, profile=True)
    gen, bs = pre["cfg"]["generator"], pre["cfg"]["training"]["batch_size"]
    steps = TRAINER_EPOCHS * (3 * TRAINER_TILES[0] // bs)
    report_fit(f"RCAN pre-training (batch {bs})", pre, "train/loss", card)
    if {k: gen[k] for k in FAMILIES["rcan"]} != FAMILIES["rcan"]:
        raise AssertionError(f"RCAN pre-training: not the published widths: {gen}")
    if len(pre["train"]) != steps or len(pre["val"]) != TRAINER_EPOCHS or len(pre["test"]) != 3:
        raise AssertionError(f"RCAN pre-training: {len(pre['train'])} steps, {len(pre['val'])} validations, "
                             f"{len(pre['test'])} test rows; expected {steps}, {TRAINER_EPOCHS}, 3")
    if any(pre["launches"].values()):
        raise AssertionError(f"RCAN runs no TPU kernel's counterpart, counted {pre['launches']}")

    fine = fit_entry_point(device, root, "rcan_fine", [
        "experiment=rcan_fine_tuning", f"datamodule.cfg.data_path={root / 'eu'}",
        f"trainer.max_epochs={TRAINER_EPOCHS}", f"training.model_weights={pre['run_dir'] / 'checkpoints'}"], eu_tables,
        profile=True)
    copied, total = fine["trainer"].graft
    report_fit(f"RCAN fine-tuning (europe extent, batch {fine['cfg']['training']['batch_size']})", fine,
               "train/loss", card)
    print(f"# RCAN fine-tuning graft: {copied} of {total} generator tensors copied from the pre-training's best "
          f"checkpoint; HR {fine['dm'].train_dataset.hr_size}")
    if copied != total or fine["dm"].train_dataset.hr_size != EU_HR:
        raise AssertionError("RCAN fine-tuning: the graft missed a tensor, or the run is not at europe extent")

    mgr = CheckpointManager(fine["run_dir"] / "checkpoints", save_top_k=-1)
    model = load_generator(str(mgr.path(mgr.best_step)), "rcan", fine["cfg"]["generator"], device=device)
    months = make_europe_months(root / "eu_months", EU_MONTHS)
    mask = months.pop("mask")
    ds = GeoTiffInferenceDataset(**months, generator_type="rcan", variable="tmp", hr_size=EU_HR, scaling_factor=4)
    seconds = []
    for sweep in ("first", "second"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        paths = inference_on_full_images(model, ds, str(root / "eu_out" / sweep), "rcan", batch_size=8,
                                         device=device)
        seconds.append(time.perf_counter() - t)
    for p in paths:
        arr, _ = read_geotiff(p)
        if arr.shape != (EU_HR, EU_HR) or not (np.isfinite(arr[mask]).all() and np.isnan(arr[~mask]).all()):
            raise AssertionError(f"{p}: shape {arr.shape}, or not finite on land and NaN on sea")
    if len(paths) != EU_MONTHS:
        raise AssertionError(f"RCAN inference: expected {EU_MONTHS} GeoTIFFs, got {len(paths)}")
    rates = [EU_MONTHS / s for s in seconds]
    print(f"# RCAN europe-extent inference: {len(paths)} GeoTIFFs of {EU_HR}x{EU_HR}, finite on land and NaN on "
          f"sea (land {mask.mean():.4f}); {rates[0]:.4f} months/s first sweep, {rates[1]:.4f} second ({card})")
    return dict(pre=pre["train"][-1]["train/samples_per_sec"], fine=fine["train"][-1]["train/samples_per_sec"],
                pre_peak=pre["peak_gb"], fine_peak=fine["peak_gb"], months_per_s=rates)


def moved_ckpt(src: Path, dst: Path, seed: int = 5) -> Path:
    """A copy of the ``.ckpt`` at ``src`` with every floating-point generator
    tensor moved by one bf16 rounding step (2^-8 relative, signs from
    ``seed``): a start that differs from ``src``'s by about what the kernels'
    roundings make differ from the plain versions'."""
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    gen = torch.Generator().manual_seed(seed)
    sd = ckpt["state_dict"]
    for k, v in sd.items():
        if k.startswith("generator.") and v.is_floating_point():
            sign = torch.randint(0, 2, v.shape, generator=gen).to(v.dtype) * 2 - 1
            sd[k] = v * (1 + sign * 2.0 ** -8)
    torch.save(ckpt, dst)
    return dst


def trajectory_err(got: dict, ref: dict, keys=GAN_KEYS) -> dict:
    """Worst relative difference per key between two GAN fits' logged rows
    (per step for train/..., per validation for val/...)."""
    out = {}
    for k in keys:
        rows = "val" if k.startswith("val/") else "train"
        out[k] = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got[rows], ref[rows]))
    return out


def generator_grads(model, batch: dict, dtype) -> dict:
    """Every parameter's gradient (f32) of the mean squared error between the
    generator's output on ``batch`` in ``dtype`` and the batch's HR target."""
    from climsr_tpu_torch.models import apply_generator_batch

    model.zero_grad(set_to_none=True)
    sr = apply_generator_batch("esrgan", model, batch, dtype).float()
    (sr - batch["hr"].to(sr.device, torch.float32)).square().mean().backward()
    grads = {k: p.grad.float().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def grad_err(got: dict, ref: dict) -> tuple:
    """(|got - ref| / |ref| over all gradients as one vector, {name: that ratio for the one tensor})."""
    num = sum((got[k] - ref[k]).square().sum().item() for k in ref)
    den = sum(ref[k].square().sum().item() for k in ref)
    return (num / den) ** 0.5, {k: ((got[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30)).item() for k in ref}


def phase_gan_preset(device, root: Path, eu_tables: dict, best_ckpt: Path, card: str) -> dict:
    """Phase C: the ESRGAN GAN fine-tune preset with its RFB-ESRGAN
    discriminator through ``cli.train.run``, from phase 13's best checkpoint
    on the europe-extent set: kernels B1, B2 and C in each step, A in each
    generator forward of validation and test. Then each kernel at this path's
    shapes against its plain version; the fine-tuned generator on this path's
    batches through the kernels and through the plain versions (A's output,
    B1, B2 and C's parameter gradients); and the same fit through the plain
    versions from the same seed, beside the same comparison's noise: the
    plain fit again, and from a start moved by one bf16 rounding step, from
    phase 13's checkpoint and from a seeded generator."""
    from climsr_tpu_torch.data.pipeline import build_eval_device_store, gather
    from climsr_tpu_torch.models import apply_generator_batch

    def overrides(weights: Path) -> list:
        return ["experiment=esrgan_fine_tune_no_gan_pre_training", f"datamodule.cfg.data_path={root / 'eu'}",
                f"trainer.max_epochs={TRAINER_EPOCHS}", f"training.model_weights={weights}"]

    r = fit_entry_point(device, root, "gan_kernels", overrides(best_ckpt), eu_tables, profile=True)
    cfg, trainer = r["cfg"], r["trainer"]
    report_fit("GAN fine-tune preset", r, "train/loss_G", card)
    nb, bs, vbs = cfg["generator"]["nb"], cfg["training"]["batch_size"], cfg["training"]["validation_batch_size"]
    n_train, n_val, n_test = 3 * EU_TILES[0], 3 * EU_TILES[1], EU_TILES[2]
    steps = TRAINER_EPOCHS * (n_train // bs)
    val_batches, test_batches = -(-n_val // vbs), 3 * -(-n_test // vbs)
    # a GAN validation batch runs the generator twice (the metric suite, then the GAN val losses)
    expected = dict(A=3 * nb * (2 * TRAINER_EPOCHS * val_batches + test_batches), B1=3 * nb * steps,
                    B2=3 * nb * steps, C=steps, D=0, E=0, F=0)
    print(f"# phase C launches: {steps} steps x (3 x nb={nb} B1 + 3 x nb B2 + 1 C), {TRAINER_EPOCHS} validations "
          f"x {val_batches} batch x 2 forwards + {test_batches} test batches, 3 x nb A per forward: expected "
          f"{expected}, counted {r['launches']}")
    if r["launches"] != expected or len(r["train"]) != steps or len(r["val"]) != TRAINER_EPOCHS:
        raise AssertionError(f"GAN preset: expected launches {expected} over {steps} steps, counted {r['launches']} "
                             f"over {len(r['train'])}")
    if cfg["discriminator"]["name"] != "rfb_esrgan" or type(trainer.d_model).__name__ != "RFBESRGANDiscriminator":
        raise AssertionError(f"GAN preset: the discriminator is not RFB-ESRGAN's: {cfg['discriminator']}")
    copied, total = trainer.graft
    if copied != total or trainer.dm.train_dataset.hr_size != EU_HR:
        raise AssertionError(f"GAN preset: graft {copied} of {total}, HR {trainer.dm.train_dataset.hr_size}")

    # each kernel at this path's shapes against its plain version (seeded
    # inputs): A at the eval batches (12 validation tiles, 4 per test set),
    # B1 and B2 at the train batch, C at its HR gradient
    lr = EU_HR // 4
    eval_sizes = sorted({min(vbs, n_val), min(vbs, n_test)})
    phase_kernel(device, shapes=tuple((n, lr, lr) for n in eval_sizes), timed=())
    phase_train_kernels(device, shapes=((bs, lr, lr),))
    phase_head_kernel(device, shapes=((bs, EU_HR, EU_HR),))

    # the fine-tuned generator on this path's own batches: A on the eval
    # batches, and the parameter gradients of a train batch (B1, B2, C)
    # through the kernels and through the plain versions, beside the plain
    # versions in bf16 against f32 (TF32 off)
    g = trainer.g_model
    val_store = build_eval_device_store(trainer.dm.val_dataset, device=device)
    for n in eval_sizes:
        tiles = gather(val_store, torch.arange(n, device=device))
        with torch.inference_mode():
            got = apply_generator_batch("esrgan", g, tiles, torch.bfloat16)
            with plain_rdb():
                ref = apply_generator_batch("esrgan", g, tiles, torch.bfloat16)
        _, rel = rel_err(got, ref)
        print(f"# GAN preset's generator on {n} val tiles of {lr}x{lr}, kernel A against the plain RDB: relative "
              f"err {rel:.3e} (tol {GENERATOR_TOL[torch.bfloat16]:g})")
        if not rel <= GENERATOR_TOL[torch.bfloat16] or not torch.isfinite(got).all():
            raise AssertionError("GAN preset: the fine-tuned generator through kernel A disagrees with the plain RDB")
    del val_store
    batch = gather(build_eval_device_store(trainer.dm.train_dataset, device=device), torch.arange(bs, device=device))
    grads = generator_grads(g, batch, torch.bfloat16)
    with plain_rdb(), plain_training():
        plain_grads = generator_grads(g, batch, torch.bfloat16)
        f32_grads = generator_grads(g, batch, torch.float32)
    (k_all, k_per), (p_all, p_per), (k32_all, k32_per) = (
        grad_err(grads, plain_grads), grad_err(plain_grads, f32_grads), grad_err(grads, f32_grads))
    # against f32, the gradients through the kernels may be no further off
    # than twice the plain versions' in bf16, or GRAD_TOL: over all and for
    # each tensor (a bias whose gradient sums terms that cancel is far from
    # f32 in bf16 on both sides)
    k32_per["over all"], p_per["over all"] = k32_all, p_all
    bad = {k: v for k, v in k32_per.items() if not v <= max(2 * p_per[k], GRAD_TOL)}
    worst = max(k_per, key=k_per.get)
    ratio = max(k32_per, key=lambda k: k32_per[k] / max(p_per[k], 1e-30))
    print(f"# GAN preset's generator, parameter gradients on a train batch of {bs} x {lr}x{lr} (relative L2): "
          f"against plain f32, kernels {k32_all:.3e} and plain bf16 {p_all:.3e} over all; kernels against plain "
          f"bf16 {k_all:.3e} over all, worst tensor {k_per[worst]:.3e} ({worst}); the largest ratio of kernels to "
          f"plain bf16 against f32 {k32_per[ratio] / max(p_per[ratio], 1e-30):.3f} ({ratio}: {k32_per[ratio]:.3e} "
          f"against {p_per[ratio]:.3e}); past max(2 x plain bf16, {GRAD_TOL:g}): {bad or 'none'}")
    if bad:
        raise AssertionError("GAN preset: the generator's gradients through B1, B2 and C are further from f32 than "
                             "the plain versions' in bf16")
    del batch, grads, plain_grads, f32_grads

    # the fit through the plain versions, and the noise of that comparison:
    # the plain fit again, and from a start moved by one bf16 rounding step;
    # the same from a seeded generator, whose D does not saturate by step 4
    seeded = root / "seeded.ckpt"
    torch.save({"state_dict": {f"generator.{k}": v for k, v in
                               seeded_esrgan(torch.device("cpu"), torch.float32).state_dict().items()}}, seeded)
    starts = {"checkpoint": best_ckpt, "seeded": seeded}
    moved = {start: moved_ckpt(w, root / f"{start}_moved.ckpt") for start, w in starts.items()}
    plan = [("checkpoint", "plain", best_ckpt), ("checkpoint", "plain again", best_ckpt),
            ("checkpoint", "plain, start moved", moved["checkpoint"]), ("seeded", "kernels", seeded),
            ("seeded", "plain", seeded), ("seeded", "plain, start moved", moved["seeded"])]
    fits = {("checkpoint", "kernels"): r}
    for i, (start, tag, weights) in enumerate(plan):
        with contextlib.ExitStack() as stack:
            if tag.startswith("plain"):
                stack.enter_context(plain_rdb())
                stack.enter_context(plain_training())
            f = fit_entry_point(device, root, f"gan_{i}", overrides(weights), eu_tables)
        fits[start, tag] = dict(train=f["train"], val=f["val"], wall=f["wall"])
        del f
    errs = {}
    for start in starts:
        for k in GAN_KEYS:
            rows = "val" if k.startswith("val/") else "train"
            print(f"#   {start} {k}: " + "; ".join(f"{tag} {['%.6f' % x[k] for x in fits[s_, tag][rows]]}"
                                                for s_, tag in fits if s_ == start))
        for tag in ("kernels", "plain again", "plain, start moved"):
            if (start, tag) in fits:
                e = trajectory_err(fits[start, tag], fits[start, "plain"])
                errs[start, tag] = max(e.values())
                print(f"# GAN preset from {start}, {tag} vs plain: worst relative " + ", ".join(
                    f"{k} {v:.2e}" for k, v in e.items()) + f"; over all {errs[start, tag]:.2e}")
    worst = errs["checkpoint", "kernels"]
    print(f"# GAN preset kernels vs plain from phase 13's checkpoint: loss_G, loss_D per step and val/rmse, "
          f"val/loss_G per validation within {worst:.2e} (relative; tol {GAN_LOSS_TOL:g}); graft {copied} of "
          f"{total} tensors; the plain run {fits['checkpoint', 'plain']['wall']:.3f} s")
    if not worst <= GAN_LOSS_TOL:
        raise AssertionError("the GAN preset through the kernels disagrees with the plain versions")
    sps = r["train"][-1]["train/samples_per_sec"]
    print(f"# GAN preset samples/s: {sps:.2f} at step {steps} (batch {bs}, HR {EU_HR}); peak device memory "
          f"{r['peak_gb']:.3f} GB ({card})")
    return dict(launches=r["launches"], samples_per_sec=sps, peak_gb=r["peak_gb"])


def phase_family_pretrain(device, root: Path, card: str) -> dict:
    """Phase D: DRLN and RFB-ESRGAN pre-training through ``cli.train.run`` on
    the composed ``esrgan_pre_training`` experiment with the generator
    switched, at their published widths and batch 192: 2 epochs of one step
    over the same 192 tiles (a synthetic set of 64 per stage and variable),
    so the step-2 loss reads the first update, and one validation."""
    from climsr_tpu_torch.data.synthetic import make_synthetic_dataset

    n = TRAIN_N // 3
    tables = make_synthetic_dataset(root / "ds_d", n_tiles_per_stage=(n, n, n), seed=2, write_index=False)
    out = {}
    for name in ("drln", "rfb_esrgan"):
        gc.collect()
        torch.cuda.empty_cache()
        r = fit_entry_point(device, root, f"pre_{name}", [
            "experiment=esrgan_pre_training", f"generator={name}", f"training.generator_type={name}",
            f"datamodule.cfg.data_path={root / 'ds_d'}", "trainer.max_epochs=2", "trainer.check_val_every_n_epoch=2",
            "training.run_test_after_fit=false"], tables, profile=True)
        bs = r["cfg"]["training"]["batch_size"]
        report_fit(f"{name} pre-training (batch {bs})", r, "train/loss", card)
        losses = [x["train/loss"] for x in r["train"]]
        if bs != TRAIN_N or len(losses) != 2 or len(r["val"]) != 1 or not losses[-1] < losses[0]:
            raise AssertionError(f"{name} pre-training: expected 2 steps of {TRAIN_N} with a falling loss and one "
                                 f"validation, got batch {bs}, {losses}, {len(r['val'])}")
        if type(r["trainer"].g_model).__name__ != {"drln": "DRLN", "rfb_esrgan": "RFBESRGANGenerator"}[name]:
            raise AssertionError(f"{name} pre-training built {type(r['trainer'].g_model).__name__}")
        out[name] = dict(samples_per_sec=r["train"][-1]["train/samples_per_sec"], peak_gb=r["peak_gb"])
        print(f"# {name} pre-training samples/s: {out[name]['samples_per_sec']:.2f} at the last step, batch {bs}; "
              f"peak device memory {r['peak_gb']:.3f} GB ({card})")
        del r
    return out


# ---- phases W, L, R, Q, H, P: fault 1 and the training entry point's services ----

# phase W: the bf16 chain's other widths (fault 1)
WIDTH_NF, WIDTH_GC = (32, 48, 96, 128), (16, 32)
WIDTH_NB = 11  # phase W's ESRGAN at nf=32: the flagship's depth and growth width
# phase L: the LR range test's steps (lr_range_test's default)
LR_FIND_STEPS = 100
# phase Q: the port's kernels by their symbols in the profiler's table and trace (A and B1, B2's dX and dW passes, C)
PROFILE_SYMBOLS = ("rdb_fwd_bf16_kernel", "rdb_bwd_dx_bf16_kernel", "rdb_wgrad_bf16_kernel", "conv9_dx_c0_bf16_kernel")
# phase P: the probe's headroom (Trainer._auto_scale_batch_size), of the card's memory
PROBE_HEADROOM = 0.9


def counts(counters: dict) -> dict:
    return {k: c.launches for k, c in counters.items()}


def zero_counts(counters: dict) -> None:
    for c in counters.values():
        c.launches = 0


def phase_widths(device, card: str, phase3: dict, phase6: dict) -> dict:
    """Fault 1: kernels A, B1, B2 and D in bf16 at nf in WIDTH_NF and gc in
    WIDTH_GC against their plain versions at the training shape (192 x nf x
    32 x 32) and a ragged one (3 x nf x 29 x 45), with the tolerances of
    phases 3 and 6; A, B1, B2 timed at the training shape beside their bounds
    at those widths and at nf=64 (gc=16, 32), where phase 3's and phase 6's
    times of the same shape stand beside them; then a bf16 ESRGAN at nf=32
    (nb=11, gc=16) through 2 pre-training steps at batch 192 against the
    plain versions, as in phase 7. Returns the numbers by (nf, gc)."""
    from climsr_tpu_torch.ops.rdb import (
        fused_rdb, fused_rdb_bwd, fused_rdb_fwd_save, fused_rdb_nhwc, pack_rdb_weights, rdb_bwd_reference,
        rdb_fwd_save_reference, rdb_reference,
    )

    dtype = torch.bfloat16
    out = {}
    for nf in sorted(WIDTH_NF + (NF,)):
        for gc in WIDTH_GC:
            for n, h, w in ((TRAIN_N, TRAIN_LR, TRAIN_LR), (3, 29, 45)):
                x, x0, weights = rdb_inputs(n, h, w, dtype, device, nf=nf, gc=gc)
                packed = pack_rdb_weights(weights, dtype)
                tag = f"{n}x{nf}x{h}x{w} gc={gc} bfloat16"
                gen = torch.Generator(device="cpu").manual_seed(2)
                g = (0.01 * torch.randn(n, nf, h, w, generator=gen)).to(device, dtype).contiguous(
                    memory_format=torch.channels_last)  # an upstream gradient's scale, as phase 6's
                if nf != NF:  # nf=64 is phases 3, 6 and 8's
                    errs = {}
                    for res in (None, x0):
                        errs[f"A x0={res is not None}"] = rel_err(fused_rdb(x, weights, res, packed),
                                                                  rdb_reference(x, weights, res))
                    hwio = [t for wt, bs in weights for t in (wt.permute(2, 3, 1, 0), bs)]
                    errs["D"] = rel_err(fused_rdb_nhwc(x.permute(0, 2, 3, 1), *hwio),
                                        rdb_reference(x, weights).permute(0, 2, 3, 1))
                    got, feat = fused_rdb_fwd_save(x, weights, None, packed)
                    ref, ref_feat = rdb_fwd_save_reference(x, weights)
                    errs["B1 out"], errs["B1 feat"] = rel_err(got, ref), rel_err(feat, ref_feat)
                    for res, (gy, gx) in ((None, (0.2, 1.0)), (x0, (0.04, 0.2))):
                        dx, dws, dbs = fused_rdb_bwd(feat, g, weights, gy, gx)
                        rdx, rdws, rdbs = rdb_bwd_reference(feat, g, weights, gy, gx)
                        errs[f"B2 ({gy}, {gx})"] = max((rel_err(a, b) for a, b in zip([dx, *dws, *dbs],
                                                                                     [rdx, *rdws, *rdbs])),
                                                       key=lambda e: e[1])
                    torch.cuda.synchronize()
                    print(f"# W {tag}: relative err " + ", ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
                          + f" (tol A, D {KERNEL_TOL[dtype]:g}; B1, B2 {TRAIN_KERNEL_TOL[dtype]:g})")
                    for k, (_, r) in errs.items():
                        tol = TRAIN_KERNEL_TOL[dtype] if k.startswith("B") else KERNEL_TOL[dtype]
                        if not r <= tol:
                            raise AssertionError(f"W {tag}: {k} disagrees with its plain version ({r:.3e})")
                if (n, h, w) != (TRAIN_N, TRAIN_LR, TRAIN_LR):
                    continue
                _, feat = fused_rdb_fwd_save(x, weights, None, packed)
                px, total, macs = n * h * w, nf + 4 * gc, rdb_macs_per_px(nf, gc)
                wbytes = 4 * macs + 4 * (4 * gc + nf)
                bounds = {"A": rdb_bound_ms(x, False, nf, gc),
                          "B1": bound(2.0 * macs * px, px * 2 * (2 * nf + total) + wbytes, dtype),
                          "B2": bound(4.0 * macs * px, px * 2 * (total + 2 * nf) + wbytes, dtype)}
                runs = {"A": (lambda: fused_rdb(x, weights, None, packed), lambda: rdb_reference(x, weights)),
                        "B1": (lambda: fused_rdb_fwd_save(x, weights, None, packed),
                               lambda: rdb_fwd_save_reference(x, weights)),
                        "B2": (lambda: fused_rdb_bwd(feat, g, weights, 0.2, 1.0),
                               lambda: rdb_bwd_reference(feat, g, weights, 0.2, 1.0))}
                row = {k: dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), bound_ms=bounds[k][0],
                               bound_by=bounds[k][1]) for k, (kernel, plain) in runs.items()}
                out[nf, gc] = row
                beside = ""
                if nf == NF:  # the same shape's times from phase 3 (A, at gc=16) and phase 6 (B1, B2)
                    ph3 = phase3.get(gc)
                    beside = ((f"; beside phase 3's A {ph3['ms']:.4f} ms" if ph3 else "")
                              + f"; beside phase 6's B1 {phase6[gc]['fused_rdb_fwd_save']['ms']:.4f}, "
                              f"B2 {phase6[gc]['fused_rdb_bwd']['ms']:.4f} ms")
                print(f"# W {tag} times: " + ", ".join(
                    f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']})"
                    for k, r in row.items()) + beside + f" ({card})")
    # a bf16 ESRGAN at nf=32 trains through the kernels: this phase's path
    pre = phase_pretrain(device, nb=WIDTH_NB, gc=16, steps=2, nf=32)
    out["launches"] = dict(A=3 * WIDTH_NB, B1=pre["launches"]["fused_rdb_fwd_save"],
                           B2=pre["launches"]["fused_rdb_bwd"], C=pre["launches"]["conv9_dx_c0"], D=0, E=0, F=0)
    print(f"# W pre-training step nf=32 nb={WIDTH_NB} gc=16, batch {TRAIN_N}: {pre['ms']:.3f} ms/step through the "
          f"kernels, {pre['plain_ms']:.3f} plain ({card})")
    out["pretrain"] = pre
    return out


def phase_lr_find(device, root: Path, tables: dict, card: str) -> dict:
    """L: ``training.lr_find_only=true`` on phase 13's experiment and set
    (``lr_range_test``'s 100 steps of batch 192, the tile store on the card,
    the fixed draw of step 0): exactly 3 x nb B1 + 3 x nb B2 + 1 C a step and
    no A; ``lr_find.csv`` written; the same test through the plain versions,
    the loss histories compared step by step (phase 7's trajectory
    tolerance) and the suggestions printed."""
    overrides = ["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                 "training.lr_find_only=true"]

    def sweep(tag: str) -> tuple:  # (the run, lrs, losses, smoothed losses)
        r = fit_entry_point(device, root, tag, overrides, tables)
        path = r["run_dir"] / "lr_find.csv"
        if not path.exists():
            raise AssertionError(f"L {tag}: no lr_find.csv in {r['run_dir']}")
        rows = [line.split(",") for line in path.read_text().splitlines()[1:]]
        lrs, losses, smoothed = ([float(c[i]) for c in rows] for i in range(3))
        print(f"# L {tag}: {len(rows)} steps, suggestion {r['hp']:.4g}, wall {r['wall']:.3f} s, losses "
              f"{['%.5f' % v for v in losses[::10]]} (every 10th), launches {r['launches']}")
        if not np.isfinite(r["hp"]) or not rows:
            raise AssertionError(f"L {tag}: no suggestion or no steps")
        return r, lrs, losses, smoothed

    r, lrs, losses, _ = sweep("lr_find")
    # a sweep that stops early ran one step more than it recorded: the one whose loss stopped it
    steps, nb = len(lrs) + (len(lrs) < LR_FIND_STEPS), r["cfg"]["generator"]["nb"]
    want = dict(A=0, B1=3 * nb * steps, B2=3 * nb * steps, C=steps, D=0, E=0, F=0)
    if r["launches"] != want:
        raise AssertionError(f"L: expected launches {want} for {steps} steps, counted {r['launches']}")
    with plain_rdb(), plain_training():
        _, plain_lrs, plain_losses, plain_smoothed = sweep("lr_find_plain")
    # held over the descent, up to the plain run's smoothed minimum: past it the
    # sweep diverges by design (lr up to 1), and any rounding difference grows
    # with lr (two plain formulations of the gradient on the CPU part by 20% at
    # lr 1); the rest is printed
    common = min(len(losses), len(plain_losses))
    held = int(np.argmin(plain_smoothed)) + 1
    errs = [abs(a - b) / abs(b) for a, b in zip(losses[:common], plain_losses[:common])]
    worst = int(np.argmax(errs[:held]))
    print(f"# L kernels vs plain: loss within {errs[worst]:.2e} over steps 1-{held} (relative, worst at step "
          f"{worst + 1}, lr {lrs[worst]:.3g}; tol {TRAJECTORY_TOL:g}; the plain smoothed minimum at lr "
          f"{plain_lrs[held - 1]:.3g}), {max(errs[held:], default=0.0):.2e} over steps {held + 1}-{common}; lrs "
          f"equal: {lrs[:common] == plain_lrs[:common]}")
    if not errs[worst] <= TRAJECTORY_TOL or lrs[:common] != plain_lrs[:common]:
        raise AssertionError("L: the LR range test through the kernels disagrees with the plain versions")
    return dict(launches=r["launches"], steps=steps, suggestion=r["hp"])


def phase_pruning(device, root: Path, tables: dict, card: str) -> dict:
    """R: ``callbacks=[model_pruning]`` and then ``[lottery_ticket]`` on phase
    13's experiment (2 epochs of 2 steps, a validation each epoch): the
    weights' measured sparsity 50% after epoch 1 and 75% after epoch 2, the
    weights pruned at epoch 1 still exactly 0 after epoch 2's steps; the fit
    against the same fit through the plain versions; the pruned generator
    through kernel A against the plain RDB on a validation batch (a stale
    packing of the pruned weights would show here). Returns each callback's
    logged train/loss and val/rmse beside the launches (phase M7's reference)."""
    from climsr_tpu_torch.data.pipeline import build_eval_device_store, gather
    from climsr_tpu_torch.models import apply_generator_batch
    from climsr_tpu_torch.training.callbacks import ModelPruningCallback

    result = dict(launches=dict.fromkeys(kernel_counters(), 0), runs={})
    for name in ("model_pruning", "lottery_ticket"):
        overrides = ["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                     f"callbacks=[{name}]", f"trainer.max_epochs={TRAINER_EPOCHS}", "training.run_test_after_fit=false"]
        record = []
        prune = ModelPruningCallback.on_train_epoch_end

        def watched(self, trainer, epoch):
            kept = None
            if self._masks is not None:  # the last epoch's masks after this epoch's steps
                kept = all(bool((p.detach()[~torch.from_numpy(self._masks[k]).to(p.device)] == 0).all())
                           for k, p in trainer.g_model.named_parameters() if k in self._masks)
            prune(self, trainer, epoch)
            ws = [p.detach() for p in trainer.g_model.parameters() if p.ndim >= 2]
            zeros = sum(int((w == 0).sum()) for w in ws) / sum(w.numel() for w in ws)
            record.append(dict(epoch=epoch, measured=zeros, reported=self.sparsity, kept_zero=kept))

        def fit(tag: str) -> dict:
            record.clear()
            ModelPruningCallback.on_train_epoch_end = watched
            try:
                r = fit_entry_point(device, root, tag, overrides, tables)
            finally:
                ModelPruningCallback.on_train_epoch_end = prune
            report_fit(f"R {tag}", r, "train/loss", card)
            print(f"# R {tag} sparsity after each epoch: {record}")
            wants = [1 - (1 - 0.5) ** (e + 1) for e in range(TRAINER_EPOCHS)]
            if [round(x["measured"], 3) for x in record] != [round(v, 3) for v in wants] or not all(
                    x["kept_zero"] for x in record[1:]):
                raise AssertionError(f"R {tag}: expected sparsity {wants} with pruned weights kept at 0, got {record}")
            return r

        r = fit(name)
        nb, steps = r["cfg"]["generator"]["nb"], len(r["train"])
        vbs = r["cfg"]["datamodule"]["cfg"]["validation_batch_size"]
        evals = TRAINER_EPOCHS * -(-len(r["dm"].val_dataset) // vbs)
        want = dict(A=3 * nb * evals, B1=3 * nb * steps, B2=3 * nb * steps, C=steps, D=0, E=0, F=0)
        if r["launches"] != want:
            raise AssertionError(f"R {name}: expected launches {want}, counted {r['launches']}")
        with plain_rdb(), plain_training():
            plain = fit(f"{name}_plain")
        pairs = [(a["train/loss"], b["train/loss"]) for a, b in zip(r["train"], plain["train"])]
        pairs += [(a["val/rmse"], b["val/rmse"]) for a, b in zip(r["val"], plain["val"])]
        traj = max(abs(a - b) / abs(b) for a, b in pairs)
        store = build_eval_device_store(r["dm"].val_dataset, device=device)
        batch = gather(store, torch.arange(min(TRAIN_N, len(r["dm"].val_dataset)), device=device))
        model = r["trainer"].g_model
        with torch.inference_mode():
            got = apply_generator_batch("esrgan", model, batch, torch.bfloat16)
            with plain_rdb():
                ref = apply_generator_batch("esrgan", model, batch, torch.bfloat16)
        gen_err = rel_err(got, ref)[1]
        print(f"# R {name} kernels vs plain: train/loss and val/rmse within {traj:.2e} (tol {TRAJECTORY_TOL:g}); the "
              f"pruned generator through A on {len(batch['hr'])} val tiles {gen_err:.3e} "
              f"(tol {GENERATOR_TOL[torch.bfloat16]:g})")
        if not traj <= TRAJECTORY_TOL or not gen_err <= GENERATOR_TOL[torch.bfloat16]:
            raise AssertionError(f"R {name}: the pruned run through the kernels disagrees with the plain versions")
        result["launches"] = {k: v + r["launches"][k] for k, v in result["launches"].items()}
        result["runs"][name] = dict(train_loss=[x["train/loss"] for x in r["train"]],
                                    val_rmse=[x["val/rmse"] for x in r["val"]])
    return result


def phase_profilers(device, root: Path, tables: dict, card: str) -> dict:
    """Q: ``profiler=pytorch`` and ``profiler=jax`` on phase 13's experiment
    (2 epochs of 2 steps): ``profile_ops.txt`` lists the port's kernels (A,
    B1 and B2's dX pass, B2's dW pass, C) by symbol with device times; the
    ``jax`` preset's Chrome trace of the fit exists, parses as JSON and holds
    those kernels' events."""
    symbols = PROFILE_SYMBOLS
    base = ["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
            f"trainer.max_epochs={TRAINER_EPOCHS}", "training.run_test_after_fit=false"]
    r = fit_entry_point(device, root, "profiler_pytorch", base + ["profiler=pytorch"], tables)
    table = (r["run_dir"] / "profile_ops.txt").read_text()
    print("# Q profiler=pytorch, profile_ops.txt (epoch 0):\n" + "\n".join(f"#   {line}" for line in table.splitlines()))
    found = {}
    for sym in symbols:  # a row: name, total "<ms>ms", count, mean, share
        times = [re.search(r"\s([0-9.]+)ms\s+[0-9]+\s", line) for line in table.splitlines() if sym in line]
        found[sym] = sum(float(t.group(1)) for t in times if t)
    print(f"# Q device ms by kernel in epoch 0: {found}; launches {r['launches']}")
    if not all(v > 0 for v in found.values()):
        raise AssertionError(f"Q: profile_ops.txt misses a kernel of the port or its device time: {found}")
    j = fit_entry_point(device, root, "profiler_jax", base + ["profiler=jax"], tables)
    path = j["run_dir"] / "profiles" / "trace.json"
    trace = json.loads(path.read_text())
    names = [e.get("name", "") for e in trace.get("traceEvents", [])]
    hits = {sym: sum(sym in n for n in names) for sym in symbols}
    print(f"# Q profiler=jax: {path.name} {path.stat().st_size / 1e6:.3f} MB, {len(names)} events; kernel events "
          f"{hits}; launches {j['launches']}")
    if not all(hits.values()):
        raise AssertionError(f"Q: the fit's Chrome trace misses a kernel of the port: {hits}")
    return dict(launches={k: v + j["launches"][k] for k, v in r["launches"].items()})


def phase_search(device, root: Path, tables: dict, card: str) -> dict:
    """H: ``hparams_search=srcnn_optuna`` on ``experiment=esrgan_pre_training``
    through the port's search path (``cli.train.run_hparams_search``), 3
    trials of 1 epoch of at most 2 steps on phase 13's set, without
    ``datamodule.cfg.resolutions`` in the space (the set holds 2.5m tiles
    only); ``trials.csv`` and ``best.yaml`` printed, ``best.yaml`` read back."""
    from climsr_tpu_torch.cli.train import run_hparams_search
    from climsr_tpu_torch.config.compose import compose, default_config_dir
    from climsr_tpu_torch.config.yaml_subset import load_yaml

    out = root / "search"
    overrides = ["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                 "hparams_search=srcnn_optuna", "hparams_search.n_trials=3", "trainer.max_epochs=1",
                 "trainer.limit_train_batches=2", "training.run_test_after_fit=false", "logger=csv",
                 "print_config=false", f"training.output_dir={out}"]
    cfg = compose(default_config_dir(), "config", overrides)
    cut = cfg["hparams_search"]["search_space"].pop("datamodule.cfg.resolutions")
    print(f"# H search space cut to phase 13's set: datamodule.cfg.resolutions {cut['choices']} dropped; "
          f"{len(cfg['hparams_search']['search_space'])} dimensions left")
    counters = kernel_counters()
    zero_counts(counters)
    best = run_hparams_search(cfg, overrides, device, tables=tables)
    launches = counts(counters)
    trials = (out / "hparams_search" / "trials.csv").read_text()
    text = (out / "hparams_search" / "best.yaml").read_text()
    back = load_yaml(text)
    print("# H trials.csv:\n" + "\n".join(f"#   {line}" for line in trials.splitlines()))
    print("# H best.yaml:\n" + "\n".join(f"#   {line}" for line in text.splitlines()))
    print(f"# H best {best}; best.yaml read back: value {back['value']}, {len(back['params'])} params; launches "
          f"{launches}")
    complete = trials.count(",COMPLETE,")
    if best is None or back["value"] != best or not complete or not all(launches[k] for k in ("A", "B1", "B2", "C")):
        raise AssertionError(f"H: the search gave best {best}, {complete} complete trials, launches {launches}")
    if launches["B1"] != launches["B2"] or launches["B1"] != 3 * cfg["generator"]["nb"] * launches["C"]:
        raise AssertionError(f"H: expected 3 x nb B1 and B2 per C launch, counted {launches}")
    return dict(launches=launches)


def phase_batch_probe(device, root: Path, tables: dict, card: str) -> dict:
    """P: ``trainer.auto_scale_batch_size=power`` and then ``binsearch`` on
    phase 13's experiment through ``cli.train.run`` (the Trainer alone,
    ``training.run_fit=false``): each trial's batch, peak GB and verdict, the
    chosen batch; the next doubling of it did not fit (out of memory, over
    the headroom, or past a size limit of a PyTorch op); then one real train step of the Trainer at the chosen batch
    (its tile store and device augmentation, indices cycled over the set)
    runs without running out of memory, through B1, B2 and C."""
    result = dict(launches=dict.fromkeys(kernel_counters(), 0))
    total = torch.cuda.get_device_properties(device).total_memory
    for mode in ("power", "binsearch"):
        r = fit_entry_point(device, root, f"probe_{mode}", [
            "experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
            f"trainer.auto_scale_batch_size={mode}", "training.run_fit=false", "training.run_test_after_fit=false"],
            tables)
        tr = r["trainer"]
        chosen = tr.dm.cfg.batch_size
        for t in tr.batch_trials:
            why = " (out of memory)" if t["oom"] else f" ({t['limit']})" if t["limit"] else ""
            print(f"# P {mode} trial: batch {t['bs']}, step peak {t['peak_bytes'] / 1e9:.3f} GB, fits {t['fits']}{why}")
        failed = [t["bs"] for t in tr.batch_trials if not t["fits"]]
        print(f"# P {mode}: chosen batch {chosen} (from {TRAIN_N}); {len(tr.batch_trials)} trials in {r['wall']:.3f} s; "
              f"launches {r['launches']}; limit {PROBE_HEADROOM:g} x the usable GB (free on the card plus the process's "
              f"own) {sorted({round(t['usable_bytes'] / 1e9, 3) for t in tr.batch_trials})} of {total / 1e9:.3f} "
              f"({card})")
        if chosen < TRAIN_N or not failed or min(failed) > 2 * chosen:
            raise AssertionError(f"P {mode}: chose {chosen}; the trials did not show that {2 * chosen} fails: "
                                 f"{tr.batch_trials}")
        counters = kernel_counters()
        before = counts(counters)
        idx = torch.arange(chosen) % len(tr.dm.train_dataset)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.state, metrics = tr.train_step(tr.state, idx)
        loss = metrics["train/loss"].item()
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launched = {k: v - before[k] for k, v in counts(counters).items()}
        nb = r["cfg"]["generator"]["nb"]
        print(f"# P {mode}: one train step at batch {chosen}: loss {loss:.6f}, {step_s:.3f} s, peak {peak:.3f} GB, "
              f"launches {launched}")
        if not np.isfinite(loss) or (launched["B1"], launched["B2"], launched["C"]) != (3 * nb, 3 * nb, 1):
            raise AssertionError(f"P {mode}: the step at the chosen batch failed: loss {loss}, launches {launched}")
        result[mode] = chosen
        result["launches"] = {k: v + r["launches"][k] + launched[k] for k, v in result["launches"].items()}
        del tr, r, metrics
        gc.collect()
        torch.cuda.empty_cache()
    return result


# ---- phase X: the offline pipelines, raw files to inspection ----------------

# the raw world: CRU-TS months (1999-2000) at 360 x 720, WorldClim 2.5m months
# 1-2 of a train, a val and a test year at 4320 x 8640 (tmin, tmax) and the
# elevation, one 10m tmin raster at 1080 x 2160 (the 4/3 resize)
X_CRU_GRID, X_CRU_MONTHS = (360, 720), 24
X_WC_YEARS, X_WC_MONTHS = (1999, 2002, 2010), (1, 2)
X_TRAIN_EPOCHS = 2
# the profiled window after each fit: the device's busy share with the store on and off
X_PROFILED_STEPS = 4
# the statistics against a float64 recomputation, relative
X_STATS_RTOL = 1e-12


def x_land() -> np.ndarray:
    """A north-up land mask on the CRU-TS grid: a smooth field thresholded at
    29% land, the south polar rows ocean, and land over Poland (the result
    inspection's probe peaks). Every raster of the phase repeats it."""
    h, w = X_CRU_GRID
    rng = np.random.default_rng(10)
    blob = 10
    field = np.kron(rng.normal(size=(h // blob, w // blob)), np.ones((blob, blob)))
    for ax in (0, 1):
        field = sum(np.roll(field, d, axis=ax) for d in range(-blob // 2, blob // 2 + 1)) / (blob + 1)
    land = field >= np.quantile(field, 0.71)
    land[-h // 9:] = False  # the south polar rows: ocean
    land[int((90 - 55) / 0.5):int((90 - 49) / 0.5), int((14 + 180) / 0.5):int((24 + 180) / 0.5)] = True
    return land


def x_repeat(a: np.ndarray, k: int) -> np.ndarray:
    return np.repeat(np.repeat(a, k, axis=0), k, axis=1)


def make_raw_world(root: Path) -> dict:
    """Raw CRU-TS NetCDF and WorldClim GeoTIFFs at the real grids, from seeds,
    the ocean NaN (CRU-TS) or ``ocean_mask_value`` (WorldClim); the HR
    elevation and land mask that inference reads."""
    from climsr_tpu_torch import consts
    from climsr_tpu_torch.io.geotiff import GeoProfile, write_geotiff
    from climsr_tpu_torch.io.netcdf import ClimateSeries, write_climate_series

    WC = consts.world_clim
    land = x_land()
    h, w = X_CRU_GRID
    rng = np.random.default_rng(11)
    cruts_dir, wc_dir = root / "cruts", root / "world-clim"
    cruts_dir.mkdir(parents=True)
    time_axis = np.array([f"{1999 + m // 12}-{m % 12 + 1:02d}-16" for m in range(X_CRU_MONTHS)], "datetime64[D]")
    base = rng.normal(10, 5, size=(X_CRU_MONTHS, h, w)).astype(np.float32)
    for var, shift in (("tmn", -4.0), ("tmp", 0.0), ("tmx", 4.0)):
        data = np.where(land, base + shift, np.nan).astype(np.float32)[:, ::-1]  # NetCDF lat ascends
        write_climate_series(cruts_dir / consts.cruts.file_pattern.format(var), ClimateSeries(
            var, np.ascontiguousarray(data), time_axis, -89.75 + 0.5 * np.arange(h), -179.75 + 0.5 * np.arange(w)))

    def raster(res: str, var: str, name: str, scale: int, coarse: np.ndarray) -> None:
        d = wc_dir / "wc2.1" / res / var
        d.mkdir(parents=True, exist_ok=True)
        arr = np.where(x_repeat(land, scale), x_repeat(coarse.astype(np.float32), scale),
                       np.float32(WC.ocean_mask_value))
        write_geotiff(d / name, arr.astype(np.float32), GeoProfile.global_grid(h * scale, w * scale, nodata=None))

    for year in X_WC_YEARS:
        for month in X_WC_MONTHS:
            coarse = rng.normal(8, 6, size=(h, w))
            raster("2.5m", WC.tmin, f"wc2.1_2.5m_tmin_{year}-{month:02d}.tif", 12, coarse - 5)
            raster("2.5m", WC.tmax, f"wc2.1_2.5m_tmax_{year}-{month:02d}.tif", 12, coarse + 5)
    elev = rng.uniform(0, 3000, size=(h, w))
    raster("2.5m", WC.elev, "wc2.1_2.5m_elev.tif", 12, elev)
    raster("10m", WC.tmin, "wc2.1_10m_tmin_1999-01.tif", 3, rng.normal(3, 6, size=(h, w)))
    hr = x_repeat(land, 4)
    write_geotiff(root / "land_mask.tif", np.where(hr, 1.0, np.nan).astype(np.float32),
                  GeoProfile.global_grid(4 * h, 4 * w))
    write_geotiff(root / "elevation.tif", x_repeat(elev.astype(np.float32), 4),
                  GeoProfile.global_grid(4 * h, 4 * w, nodata=None))
    return dict(cruts=cruts_dir, wc_extracted=wc_dir, rasters=len(list(wc_dir.rglob("*.tif"))),
                ocean_hr=~hr, elevation=root / "elevation.tif", land_mask=root / "land_mask.tif")


def x_prepare(raw: dict, out: Path, n_workers: int) -> dict:
    """``cli.data_preparation.main`` in a child interpreter (``-c``): the
    preprocessing's ``spawn`` workers then import no ``__main__`` of ours,
    and with it no torch. Returns each step's seconds."""
    argv = ["run_download=false", f"preprocessing.data_dir_cruts={raw['cruts']}",
            f"preprocessing.data_dir_world_clim={raw['wc_extracted']}", f"preprocessing.output_path={out}",
            f"preprocessing.n_workers={n_workers}"]
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})\n"
        "from climsr_tpu_torch.cli.data_preparation import main\n"
        f"print(json.dumps(main({argv!r})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"X data preparation failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def x_stats_reference(raw: dict, pre: Path) -> tuple:
    """The z-score and min-max tables recomputed in float64 numpy from the
    same files (the JAX package's rules: pooled per-file statistics, 'temp'
    over the six temperature rows, global min/max pooled with 0.0)."""
    from climsr_tpu_torch import consts
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.io.netcdf import read_climate_series

    WC = consts.world_clim

    def clean(a):
        a = a.astype(np.float64)
        for m in WC.missing_indicators:
            a[a == m] = np.nan
        return a

    def stats(a):
        a = clean(a)
        mean, std, lo, hi = np.nanmean(a), np.nanstd(a), np.nanmin(a), np.nanmax(a)
        return [mean, std, lo, hi, (lo - mean) / (std + 1e-8), (hi - mean) / (std + 1e-8)]

    def pooled(rows):
        r = np.asarray(rows)
        return [r[:, 0].mean(), r[:, 1].mean(), r[:, 2].min(), r[:, 3].max(), r[:, 4].min(), r[:, 5].max()]

    zscore, minmax = {}, []
    for var in consts.cruts.temperature_vars:
        zscore[var] = stats(read_climate_series(raw["cruts"] / consts.cruts.file_pattern.format(var), var).data)
        for fp in sorted((pre / "cruts" / consts.cruts.full_res_dir / var).glob("*.tif")):
            a = clean(read_geotiff(fp)[0])
            minmax.append((str(fp), var, np.nanmin(a), np.nanmax(a)))
    for var in WC.temperature_vars + [WC.elev]:
        files = sorted((pre / "world-clim" / WC.resized_dir).rglob(f"*{var}*.tif"))
        per_file = [stats(read_geotiff(fp)[0]) for fp in files]
        zscore[var] = pooled(per_file)
        minmax += [(str(fp), var, s[2], s[3]) for fp, s in zip(files, per_file)]
    zscore[WC.temp] = pooled([v for k, v in zscore.items() if k != WC.elev])
    glob_min = {v: min(r[2] for r in minmax if r[1] == v) for v in {r[1] for r in minmax}}
    glob_max = {v: max(r[3] for r in minmax if r[1] == v) for v in {r[1] for r in minmax}}
    for group in (consts.cruts.temperature_vars, WC.temperature_vars):
        lo, hi = min([0.0] + [glob_min[v] for v in group]), max([0.0] + [glob_max[v] for v in group])
        for v in group:
            glob_min[v], glob_max[v] = lo, hi
    return zscore, {fp: (lo, hi, glob_min[v], glob_max[v]) for fp, v, lo, hi in minmax}


def x_check_prepared(raw: dict, out: Path) -> dict:
    """Resized rasters on the target grid with the ocean NaN, tiles on
    ``_tile_windows`` (kept where at most 85% is NaN), the statistics against
    the recomputation, every feather read back. Returns the counts."""
    from climsr_tpu_torch import consts
    from climsr_tpu_torch.data.tables import read_feather
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.preprocessing.preprocessing import _tile_windows

    WC, D, S = consts.world_clim, consts.datasets_and_preprocessing, consts.stats
    pre = out / D.preprocessing_output_path
    resized = sorted((pre / "world-clim" / WC.resized_dir).rglob("*.tif"))
    tiles = list((pre / "world-clim" / WC.tiles_dir).rglob("*.tif"))
    tw, th = WC.target_hr_resolution
    for fp in resized:
        arr = read_geotiff(fp)[0]
        if arr.shape != (th, tw) or not np.array_equal(np.isnan(arr), raw["ocean_hr"]):
            raise AssertionError(f"X {fp.name}: shape {arr.shape} or its NaN cells are not the ocean")
    sample = next(fp for fp in resized if fp.name == "wc2.1_2.5m_tmin_1999-01.tif")
    arr = read_geotiff(sample)[0]
    want = {(c, r) for c, r in _tile_windows(tw, th, 128, 128, 64)
            if np.isnan(arr[r:r + 128, c:c + 128]).mean() <= 0.85}
    got = {tuple(int(v) for v in p.name.split(".")[-3:-1])
           for p in (pre / "world-clim" / WC.tiles_dir / "wc2.1" / "2.5m" / "tmin").glob("wc2.1_2.5m_tmin_1999-01.*.tif")}
    if got != want:
        raise AssertionError(f"X tiles of {sample.name}: {len(got)} windows written, {len(want)} expected")

    feathers = {p.relative_to(pre / D.feather_path).as_posix(): read_feather(p)
                for p in sorted((pre / D.feather_path).rglob("*.feather"))}
    zscore_ref, minmax_ref = x_stats_reference(raw, pre)
    z = feathers[D.zscore_stats_filename]
    worst = 0.0
    for row in z.rows():
        ref = zscore_ref[row[D.variable]]
        for k, col in enumerate((S.mean, S.std, S.min, S.max, S.normalized_min, S.normalized_max)):
            worst = max(worst, abs(row[col] - ref[k]) / max(abs(ref[k]), 1e-300))
    mm = feathers[D.min_max_stats_filename]
    if len(mm) != len(minmax_ref) or len(z) != len(zscore_ref):
        raise AssertionError(f"X statistics: {len(z)} z-score and {len(mm)} min-max rows, expected "
                             f"{len(zscore_ref)} and {len(minmax_ref)}")
    for row in mm.rows():
        ref = minmax_ref[row[D.file_path]]
        for k, col in enumerate((S.min, S.max, S.global_min, S.global_max)):
            worst = max(worst, abs(row[col] - ref[k]) / max(abs(ref[k]), 1e-300))
    print(f"# X statistics: {len(z)} z-score and {len(mm)} min-max rows against a float64 recomputation: "
          f"largest relative difference {worst:.3e} (tol {X_STATS_RTOL:g})")
    if not worst <= X_STATS_RTOL:
        raise AssertionError("X: the statistics disagree with the recomputation")
    rows = {k: len(t) for k, t in feathers.items()}
    print(f"# X prepared: {len(resized)} resized rasters of {th}x{tw}, {len(tiles)} tiles, {len(feathers)} feathers "
          f"read back by io/feather.py: {json.dumps(rows)}")
    return dict(resized=len(resized), tiles=len(tiles), rows=rows)


def x_train(device, out: Path, run_root: Path, extra: list) -> dict:
    """``cli.train.main`` on the prepared files: the fit's Trainer, launches,
    metrics rows, wall, peak memory and reads by codec."""
    from climsr_tpu_torch.cli.train import main as train_main
    from climsr_tpu_torch.io import geotiff

    counters = kernel_counters()
    zero_counts(counters)
    geotiff.READS.reset()
    trainers = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with keep_trainers(trainers):
        hp = train_main(["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={out}", "logger=csv",
                         "print_config=false", "trainer.log_every_n_steps=1", f"training.output_dir={run_root}",
                         *extra], device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    (run_dir,) = (run_root / "outputs" / "runs" / "esrgan").iterdir()
    rows = metric_rows(run_dir / "metrics.csv")
    peak = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else float("nan")
    return dict(trainer=trainers[0], hp=hp, wall=wall, run_dir=run_dir, launches=counts(counters), peak_gb=peak,
                reads=(geotiff.READS.native, geotiff.READS.python),
                train=[r for r in rows if "train/loss" in r], val=[r for r in rows if "val/rmse" in r])


def x_profiled_steps(device, tr, what: str, steps: int = X_PROFILED_STEPS, cold: bool = False) -> tuple:
    """``steps`` more training steps of a fitted Trainer (its logger off) under
    the profiler; with ``cold`` the dataset's tile cache is emptied first, so
    the host loaders read every tile from its file again, as in a first
    epoch. Returns (samples/s, the device's busy share in percent) of the
    window; on the CPU the steps run unprofiled and the share is NaN."""
    tr.metric_logger.enabled = False
    tr.trainer_cfg.limit_train_batches = steps
    if cold:
        tr.dm.train_dataset._tile_cache.clear()
    samples = steps * tr.dm.cfg.batch_size
    wall = {}

    def window():
        t = time.perf_counter()
        tr.train_epoch(99)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t

    if device.type != "cuda":
        window()
        return samples / wall["s"], float("nan")
    kernels = device_breakdown(window, top=4, what=f"X {what}: {steps} training steps ({samples} samples)")
    return samples / wall["s"], 100 * sum(e.self_device_time_total for e in kernels) / 1e6 / wall["s"]


@contextlib.contextmanager
def recorded_shapes():
    """Record, by kernel, the ((n, h, w), widths, dtype) of every launch of
    kernels A, B1 and C while the block runs (B2 runs at B1's shapes, on the
    feat of each B1 forward). The counts are untouched."""
    from climsr_tpu_torch.ops import head_bwd, rdb

    shapes = {}
    launch_rdb, launch_c = rdb._launch_forward, head_bwd._launch_conv9

    def record(counter, t, widths):
        shapes.setdefault(counter.__name__, set()).add(((t.shape[0], *t.shape[2:]), widths, t.dtype))

    def rdb_launch(x, weights, x0, packed, save, counter):
        record(counter, x, rdb._widths(weights))
        return launch_rdb(x, weights, x0, packed, save, counter)

    def c_launch(g, weight, counter):
        record(counter, g, g.shape[1])
        return launch_c(g, weight, counter)

    rdb._launch_forward, head_bwd._launch_conv9 = rdb_launch, c_launch
    try:
        yield shapes
    finally:
        rdb._launch_forward, head_bwd._launch_conv9 = launch_rdb, launch_c


def x_check_shapes(device, shapes: dict, label: str = "X") -> None:
    """Each kernel at every shape path ``label`` (X, M) launched it at, against
    its plain version at the phase's tolerance (the launches here are not
    counted): A at all of them, B1, B2 and C at those phase 6 did not check."""
    a, b1, c = (shapes.get(k, set()) for k in ("fused_rdb", "fused_rdb_fwd_save", "conv9_dx_c0"))
    odd = {(k, w, dt) for k, got in (("A", a), ("B1", b1)) for _, w, dt in got if w != (NF, GC)}
    odd |= {("C", ch, dt) for _, ch, dt in c if ch != NF}
    odd |= {(k, dt) for k, got in (("A", a), ("B1", b1), ("C", c)) for _, _, dt in got
            if dt not in (torch.float32, torch.bfloat16)}
    if odd:
        raise AssertionError(f"{label}: kernels launched at widths or dtypes no phase checks: {sorted(map(str, odd))}")
    a_shapes, b_shapes, c_shapes = (sorted({n for n, _, _ in got}) for got in (a, b1, c))
    print(f"# {label} kernel shapes launched (n, h, w): A {a_shapes}; B1 and B2 {b_shapes}; C {c_shapes}; "
          f"A checked here at all of them, B1, B2 and C beyond phase 6's")
    if device.type == "cuda" and not (a_shapes and b_shapes and c_shapes):
        raise AssertionError(f"{label}: no launch of A, B1 or C was recorded")
    phase_kernel(device, shapes=a_shapes, timed=())
    extra_b = [n for n in b_shapes if n not in B_CHECKED]
    extra_c = [n for n in c_shapes if n not in C_CHECKED]
    if extra_b:
        phase_train_kernels(device, shapes=extra_b)
    if extra_c:
        phase_head_kernel(device, shapes=extra_c)


def phase_pipeline(device, root: Path, card: str) -> dict:
    """X: data preparation -> training from the prepared files -> inference ->
    result inspection, each through its entry point's ``main(argv)``."""
    import importlib.util

    from climsr_tpu_torch.cli.inference import main as inference_main
    from climsr_tpu_torch.cli.inspect_results import main as inspect_main, plots_available
    from climsr_tpu_torch import consts
    from climsr_tpu_torch.data.tables import read_feather, write_feather
    from climsr_tpu_torch.io.geotiff import read_geotiff, write_geotiff
    from climsr_tpu_torch.io.netcdf import read_climate_series
    from climsr_tpu_torch.native import native_error
    from climsr_tpu_torch.ops.pack12 import MAX_ABS_ERR
    from climsr_tpu_torch.preprocessing.scrape_polish_mountains import build_fallback_table
    from climsr_tpu_torch.training.callbacks import LogImagesCallback
    from climsr_tpu_torch.training.checkpoint import CheckpointManager

    D, S = consts.datasets_and_preprocessing, consts.stats
    disk_before = du(root)  # root holds the earlier phases' files too
    seconds = {}
    t = time.perf_counter()
    raw = make_raw_world(root / "raw")
    seconds["fabricate"] = time.perf_counter() - t
    print(f"# X raw world: 3 CRU-TS NetCDF of {X_CRU_MONTHS} x {X_CRU_GRID[0]}x{X_CRU_GRID[1]}, {raw['rasters']} "
          f"WorldClim GeoTIFFs (4320x8640 and 1080x2160), {du(root / 'raw') / 1e9:.3f} GB, "
          f"{seconds['fabricate']:.3f} s")

    # 1. data preparation, on the host
    out = root / "prepared"
    n_workers = min(8, os.cpu_count() or 1)
    t = time.perf_counter()
    steps = x_prepare(raw, out, n_workers)
    seconds["prepare"] = time.perf_counter() - t
    print(f"# X data preparation ({n_workers} spawn workers), seconds by step: "
          + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()) + f"; {seconds['prepare']:.3f} s with start-up")
    prepared = x_check_prepared(raw, out)
    print(f"# X matplotlib importable: {importlib.util.find_spec('matplotlib') is not None} (the plots run only "
          f"where it is)")

    # 2. training from the prepared files: the tile store on the card, log_images on
    t = time.perf_counter()
    fit = x_train(device, out, root / "x_fit", [f"trainer.max_epochs={X_TRAIN_EPOCHS}", "callbacks=[log_images]"])
    seconds["train"] = time.perf_counter() - t
    tr, launches = fit["trainer"], fit["launches"]
    steps_run = len(fit["train"])
    print(f"# X fit from files: {steps_run} steps of {tr.dm.cfg.batch_size} over {len(tr.dm.train_dataset)} tiles, "
          f"{len(fit['val'])} validations, {fit['wall']:.3f} s with tests; train/loss "
          f"{fit['train'][0]['train/loss']:.6f} -> {fit['train'][-1]['train/loss']:.6f}; launches {launches}; "
          f"peak {fit['peak_gb']:.3f} GB; tile reads native {fit['reads'][0]}, Python codec {fit['reads'][1]} ({card})")
    nb = tr.config_snapshot["generator"]["nb"]
    per_step = dict(B1=3 * nb * steps_run, B2=3 * nb * steps_run, C=steps_run)
    if device.type == "cuda" and (launches["A"] <= 0 or any(launches[k] != v for k, v in per_step.items())):
        raise AssertionError(f"X fit: expected A > 0 and {per_step} over {steps_run} steps, counted {launches}")
    if fit["reads"][0] <= 0 or fit["reads"][1] != 0:
        raise AssertionError(f"X fit: the tiles did not all come through the native reader: {fit['reads']} "
                             f"({native_error()})")
    if not all(np.isfinite([r["train/loss"] for r in fit["train"]] + [r["val/rmse"] for r in fit["val"]])):
        raise AssertionError("X fit: a non-finite loss or metric")
    store_sps = fit["train"][-1]["train/samples_per_sec"]
    store_window = x_profiled_steps(device, tr, "store on")
    if importlib.util.find_spec("matplotlib") is not None:
        LogImagesCallback(save_figures=True).on_validation_end(tr, 99, {})
        print(f"# X log_images figure panel: {sorted(p.name for p in (tr.workdir / 'images').glob('*.png'))}")

    # the host loaders, the store off: one epoch, its tiles read from their files
    t = time.perf_counter()
    host = x_train(device, out, root / "x_host", ["trainer.max_epochs=1", "trainer.device_resident_data=false",
                                                  "training.run_test_after_fit=false"])
    seconds["train_store_off"] = time.perf_counter() - t
    host_sps = host["train"][-1]["train/samples_per_sec"]
    cold = x_profiled_steps(device, host["trainer"], "store off, tiles from their files", cold=True)
    warm = x_profiled_steps(device, host["trainer"], "store off, tiles from the host cache")
    print(f"# X samples/s from files: store on {store_sps:.2f} (train/samples_per_sec at step {steps_run}), "
          f"{store_window[0]:.2f} over {X_PROFILED_STEPS} profiled steps at {store_window[1]:.1f}% device busy; "
          f"store off {host_sps:.2f} (host loaders, step {len(host['train'])}, the first epoch), "
          f"{cold[0]:.2f} at {cold[1]:.1f}% busy with the tiles read from their files, {warm[0]:.2f} at "
          f"{warm[1]:.1f}% from the host cache; launches store off {host['launches']}; tile reads native "
          f"{host['reads'][0]}, Python {host['reads'][1]} ({card})")
    if host["reads"][1] != 0 or (device.type == "cuda" and host["launches"]["B1"] <= 0):
        raise AssertionError(f"X store off: reads {host['reads']}, launches {host['launches']}")

    # 3. inference from the best checkpoint, with step 2's min-max and z-score tables: the whole globe
    # from the CRU-TS tmp NetCDF (the GeoTIFF dataset is the europe extent's, 452 x 452), then the
    # prepared europe-extent CRU-TS GeoTIFFs of tmp
    mgr = CheckpointManager(fit["run_dir"] / "checkpoints", save_top_k=-1)
    pre = out / "pre-processed"
    cru_tmp = raw["cruts"] / "cru_ts4.05.1901.2020.tmp.dat.nc"
    common = [f"inference.pretrained_model={mgr.path(mgr.best_step)}", "inference.generator_type=esrgan",
              f"inference.min_max_lookup={pre / 'feather' / 'statistics_min_max.feather'}",
              f"inference.zscore_lookup={pre / 'feather' / 'statistics_zscore.feather'}",
              "inference.cruts_variable=tmp", "generator.in_channels=3", "generator.out_channels=1",
              *[f"generator.{k}={tr.config_snapshot['generator'][k]}" for k in ("nf", "nb", "gc")]]
    eu_elev = pre / "world-clim" / "europe-extent" / "elev" / "wc2.1_2.5m_elev.tif"
    eu_land = root / "x_land_mask_europe.tif"
    elev_arr, elev_profile = read_geotiff(eu_elev)
    write_geotiff(eu_land, np.where(np.isfinite(elev_arr), 1.0, np.nan).astype(np.float32), elev_profile)
    runs = {
        "globe": (["inference.use_netcdf_datasets=true", f"inference.ds_path={cru_tmp}",
                   f"inference.elevation_file={raw['elevation']}", f"inference.land_mask_file={raw['land_mask']}"],
                  raw["ocean_hr"]),
        "europe": ([f"inference.tiff_dir={pre / 'cruts' / 'europe-extent'}", f"inference.elevation_file={eu_elev}",
                    f"inference.land_mask_file={eu_land}"], ~np.isfinite(elev_arr)),
    }

    def infer(tag: str, out_tag: str) -> Path:
        inference_main(common + runs[tag][0] + [f"inference.inference_out_path={root / f'x_sr_{out_tag}'}",
                                                f"inference.extent_out_path_sr_nc={root / f'x_nc_{out_tag}'}"],
                       device=device)
        (nc,) = (root / f"x_nc_{out_tag}").glob("*.tmp.dat.nc")
        return nc

    counters = kernel_counters()
    sweeps = {}
    for tag, (_, ocean) in runs.items():
        zero_counts(counters)
        t = time.perf_counter()
        nc_path = infer(tag, tag)
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[f"inference_{tag}"] = wall = time.perf_counter() - t
        a_inf = counts(counters)["A"]
        sr = read_climate_series(nc_path, "tmp")
        ocean = ocean[::-1]  # the NetCDF's rows run south to north
        pattern_ok = sr.data.shape == (X_CRU_MONTHS, *ocean.shape) and all(
            np.array_equal(np.isnan(m), ocean) for m in sr.data)
        print(f"# X inference, {tag}: {X_CRU_MONTHS} months in {wall:.3f} s through cli.inference (load, sweep, "
              f"GeoTIFFs, NetCDF): {X_CRU_MONTHS / wall:.4f} months/s; A launches {a_inf}; {nc_path.name} "
              f"{sr.data.shape}, NaN exactly on the ocean: {pattern_ok} ({card})")
        if (device.type == "cuda" and a_inf <= 0) or not pattern_ok or not np.isfinite(sr.data[:, ~ocean]).all():
            raise AssertionError(f"X inference {tag}: no A launch, or the NetCDF's shape or land/NaN pattern is wrong")
        sweeps[tag] = dict(nc=nc_path, launches=a_inf, months_per_s=X_CRU_MONTHS / wall)
    nc_path = sweeps["globe"]["nc"]

    # the europe sweep again through the plain RDB: every land value within a 12-bit step a side plus the
    # generator's bf16 tolerance, in the [-1, 1] domain of the global min-max range inference scaled by
    with plain_rdb():
        plain_nc = infer("europe", "europe_plain")
    mm = read_feather(pre / "feather" / "statistics_min_max.feather")
    mm = mm.filter((mm[D.dataset] == "cru-ts") & (mm[D.variable] == "tmp"))
    ranges = set(zip(mm[S.global_min].tolist(), mm[S.global_max].tolist()))
    if len(ranges) != 1:
        raise AssertionError(f"X: the cru-ts tmp rows hold {len(ranges)} global min-max ranges, expected one")
    ((lo, hi),) = ranges
    got = read_climate_series(sweeps["europe"]["nc"], "tmp").data
    ref = read_climate_series(plain_nc, "tmp").data
    land = np.isfinite(ref)
    worst = float(np.max(np.abs(got[land] - ref[land]))) / ((hi - lo) / 2)
    tol = 2 * MAX_ABS_ERR + GENERATOR_TOL[torch.bfloat16]
    print(f"# X inference, europe through the kernels against the plain RDB: worst normalized |kernel - plain| "
          f"{worst:.3e} (tol {tol:.3e}) over {int(land.sum())} land values, NaN alike: "
          f"{np.array_equal(land, np.isfinite(got))}")
    if not (worst <= tol) or not np.array_equal(land, np.isfinite(got)):
        raise AssertionError(f"X inference europe: the kernels' NetCDF disagrees with the plain RDB's ({worst:.3e})")

    # 4. result inspection: the SR NetCDF against the fabricated CRU-TS tmp file
    peaks = root / "x_peaks.feather"
    write_feather(build_fallback_table(), peaks)
    t = time.perf_counter()
    results = inspect_main([f"result_inspection.ds_temp_nn_path={nc_path}",
                            f"result_inspection.ds_temp_cru_path={cru_tmp}",
                            f"result_inspection.peaks_feather={peaks}", f"result_inspection.results_dir={root / 'x_ri'}"])
    seconds["inspect"] = time.perf_counter() - t
    csv_rows = {tag: len((root / "x_ri" / f"{tag}.csv").read_text().splitlines()) - 1 for tag in results}
    r = results["mountain_peaks"]
    print(f"# X result inspection: MAE {r.mae:.6f}, MSE {r.mse:.6f}, RMSE {r.rmse:.6f} at the mountain peaks; CSV rows "
          f"{csv_rows}; plots {'written' if plots_available() else 'skipped (no matplotlib)'}")
    want_rows = {"peaks_feather": 23, "mountain_peaks": 23, "2_locations": 2}
    if csv_rows != want_rows or not all(np.isfinite([x.mae, x.mse, x.rmse]).all() for x in results.values()):
        raise AssertionError(f"X result inspection: CSV rows {csv_rows} (expected {want_rows}) or a non-finite error")
    print(f"# X seconds by step: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; disk used {(du(root) - disk_before) / 1e9:.3f} GB")
    a_inf = sum(v["launches"] for v in sweeps.values())
    return dict(launches={k: v + (a_inf if k == "A" else 0) for k, v in launches.items()}, seconds=seconds,
                prepared=prepared, store_sps=store_sps, host_sps=host_sps, sweeps=sweeps)


# ---- phase M: the multi-rank code, 4 gloo ranks sharing the one card --------

M_RANKS = 4
M_STEPS, M_GAN_STEPS = 3, 2  # M1's and M2's steps per ZeRO stage
M_EU_N, M_HALO = 4, 8  # M3: europe-extent frames (LR 113 -> HR 452) and the plugin's halo
M_RCAN_N = 2  # M4: europe-extent frames through RCAN at its published widths
M_MONTHS, M_INFER_HALO = 2, 32  # M5: whole-globe months and halo
# M3/M4, rows of the output within this many LR rows of the frame's top or
# bottom: the sharded path reflects there once where the model zero-pads at
# every conv, a boundary choice no halo removes (scripts/measure_halo_error.py)
M_EDGE_ROWS = 16
# M4, the exact pool at RCAN's width on the card in f32 against the unsharded
# pool (as tests/test_torch_spatial.py on the CPU); the local-pool control
# must differ by more than 100x that
M_POOL_TOL = 1e-4
# M1, M2: the ranks against one rank on the same global batch, bounds set from
# the card's readings (NVIDIA H100 80GB HBM3, 700 W: M1 losses 9.4e-08, grad
# norms 2.4e-04, parameters 2.5e-05 rel-L2; M2 losses 1.7e-04, D's running
# variances 5.4e-05, parameters 1.4e-04), far under what a rank training on its
# slice alone or a ZeRO update left unpublished would give. M1's parameter
# error must also be within M_MOVE_SHARE of how far the steps moved them; M2's
# (bf16 D gradients, whose summation order alone moves D ~7% of its steps)
# within M_CONTROL_SHARE of a single rank's GAN steps on one rank's slice alone
M_LOSS_TOL, M_NORM_TOL, M_PARAM_TOL, M_GAN_TOL = 1e-5, 2e-3, 1e-3, 1e-3
M_MOVE_SHARE, M_CONTROL_SHARE = 0.05, 0.2
# M6: cli.train at ZeRO-2 over the ranks against phase 13's single-rank run of
# the same experiment on the same set: train/loss, and val/rmse (each eval
# batch split over the ranks); the spatial plugin (halo 4 < the receptive
# field) against the same run at M6_SPATIAL_TOL
M6_TOL, M6_SPATIAL_TOL = 1e-4, 1e-2
# M5: one rank's default tiled run against its whole frame, of the half range:
# max and mean in the interior, max at the frame's left and right edge columns
# (the card's readings: 9.4e-02, 3.7e-03, 8.9e-01; at 32 px of overlap 3.3e-02,
# 3.0e-03, 8.9e-01)
M5_TILED_MAX, M5_TILED_MEAN, M5_TILED_EDGE = 0.3, 1e-2, 1.0
# M7: cli.train with the pruning callbacks over the ranks, (ZeRO stage, callback)
# each, against phase R's single-rank run of the same callback at M6_TOL
M7_RUNS = ((1, "model_pruning"), (2, "model_pruning"), (3, "model_pruning"), (2, "lottery_ticket"))
M7_SPARSITY = (50.0, 75.0)  # % of the prunable elements after each epoch
# M8: trainer.auto_scale_batch_size over the ranks, each mode
M8_MODES = ("power", "binsearch")


def m_batch(n: int, lr_h: int, lr_w: int, seed: int) -> dict:
    """Seeded NCHW fusion inputs and an HR target, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 3, lr_h, lr_w, generator=gen)
    hr = torch.repeat_interleave(torch.repeat_interleave(x[:, :1], 4, 2), 4, 3)
    hr = (hr + 0.1 * torch.randn(hr.shape, generator=gen)).clamp(-1, 1)
    return {"lr": x, "hr": hr, "elevation": torch.randn(n, 1, 4 * lr_h, 4 * lr_w, generator=gen),
            "mask": (torch.rand(n, 1, 4 * lr_h, 4 * lr_w, generator=gen) > 0.3).float()}


def m_pretrain(device, steps: int, stage: int = 0, mesh=None, spatial=None, batch=None):
    """The flagship ESRGAN's pre-training steps (bf16, AdamW at a constant lr):
    (losses, grad norms, state); one rank when ``mesh`` is None."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState

    batch = {k: v.to(device) for k, v in (batch or train_batch()).items() if k in ("lr", "hr", "elevation", "mask")}
    model = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                             device=device, train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
    tx = build_optimizer(OptimizerConfig(name="adamw", lr=1e-4, weight_decay=1e-4), lambda s: 1e-4,
                         gradient_clip_val=1.0, device=device)
    state = TrainState.create(model, tx, zero_stage=stage, mesh=mesh)
    step = make_pretrain_step(model, "esrgan", compute_dtype=torch.bfloat16, spatial=spatial, device=device,
                              zero=None if mesh is None else {"stage": stage})
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["train/loss"].item())
        norms.append(metrics["grad_norm"].item())
    return losses, norms, state


class _EdgeFair(torch.nn.Module):
    """The fusion generator on its inputs reflect-padded by ``halo`` LR rows
    (x4 for the HR ones) at the top and bottom, cropped back: the unsharded
    model under the sharded path's boundary condition (M3's spatial GAN)."""

    def __init__(self, model, halo: int):
        super().__init__()
        self.model, self.halo = model, halo

    def forward(self, lr, elev, mask):
        import torch.nn.functional as F

        h = self.halo
        xs = [F.pad(x, (0, 0, h * s, h * s), mode="reflect") for x, s in ((lr, 1), (elev, 4), (mask, 4))]
        return self.model(*xs)[:, :, 4 * h: -4 * h]


def m_gan(device, steps: int, stage: int = 0, mesh=None, spatial=None, edge_fair_halo: int = 0, n: int = TRAIN_N):
    """The GAN steps of phase 10 (VGG19 to conv5_4 on seeded weights, the
    ESRGAN discriminator with BatchNorm; Adam at eps 1e-3, the generator's
    output scaled to the targets'): ([metrics per step], state).
    ``spatial`` H-shards the generator; ``edge_fair_halo`` runs it on one
    rank under the sharded path's boundary condition instead; ``n`` takes the
    first ``n`` samples of the batch."""
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.losses.perceptual import build_perceptual_loss
    from climsr_tpu_torch.models import create_discriminator, create_generator
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.training.tasks.gan import make_gan_step
    from climsr_tpu_torch.training.train_state import GANTrainState

    batch = {k: v[:n].to(device) for k, v in train_batch().items() if k in ("lr", "hr", "elevation", "mask")}
    dtype = torch.bfloat16
    g = create_generator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(0), device=device,
                         train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
    d = create_discriminator("esrgan", dtype=dtype, generator=torch.Generator().manual_seed(1), device=device,
                             train=True, in_channels=1, out_channels=64, hr_size=4 * TRAIN_LR)
    with torch.no_grad():
        # sr on the targets' scale, as parallel/cases.py: an untrained
        # generator's near-constant output leaves channels of D's first
        # BatchNorm with a batch variance under its eps, where x - mean cancels
        # and any two summation orders of the statistics (one rank, or a sum
        # over ranks) part D's gradients by several percent
        g.srcnn.conv3.weight.mul_(20.0)
    # eps 1e-3, as tests/test_torch_gan.py: at Adam's default 1e-8 the first
    # update moves a weight whose gradient is near zero by a full step of
    # either sign, so the summation order of its bf16 gradient (one rank, or a
    # sum over ranks) would decide it (D's parameters 2.3e-03 rel-L2 apart)
    tx = build_optimizer(OptimizerConfig(name="adam", lr=1e-4, weight_decay=1e-4, eps=1e-3), lambda s: 1e-4,
                         device=device)
    state = GANTrainState.create(g, tx, d, tx, zero_stage=stage, mesh=mesh)
    if edge_fair_halo:
        g = state.g_model = _EdgeFair(g, edge_fair_halo)
    step = make_gan_step(g, d, "esrgan", perceptual_fn=build_perceptual_loss(compute_dtype=dtype, cutoff="conv5_4",
                                                                              device=device),
                         compute_dtype=dtype, device=device, zero=None if mesh is None else {"stage": stage},
                         spatial=spatial)
    trace = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        trace.append({k: v.item() for k, v in metrics.items()})
    return trace, state


def m_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``fn`` between device syncs (a collective's time from
    ranks sharing one card: an overhead figure, not a multi-GPU one)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times[1:])


def m_flat(named) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for _, t in named])


def m_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-12)).item()


def m_spatial_refs(device, model, batch: dict, halo: int) -> dict:
    """M3/M4's references from one rank: the unsharded forward, and the
    edge-fair one (the frame reflect-padded as the sharded path pads it: its
    bottom to a multiple of the ranks, then ``halo`` rows a side; applied
    whole and cropped), with the gradients of the mean absolute error to
    ``hr`` over the true rows."""
    import torch.nn.functional as F

    h = batch["lr"].shape[2]
    pad = (-h) % M_RANKS
    args = [batch[k].to(device=device, dtype=torch.bfloat16) for k in ("lr", "elevation", "mask")]
    hr = batch["hr"].to(device).float()
    out = {}
    for tag in ("unsharded", "fair"):
        xs = args
        if tag == "fair":
            xs = [F.pad(F.pad(x, (0, 0, 0, pad * s), mode="reflect"), (0, 0, halo * s, halo * s), mode="reflect")
                  for x, s in zip(args, (1, 4, 4))]
        model.zero_grad()
        sr = model(*xs)
        if tag == "fair":
            sr = sr[:, :, 4 * halo: 4 * (halo + h)]
        loss = torch.abs(sr.float() - hr).mean()
        loss.backward()
        out[tag] = dict(sr=sr.detach().float().cpu(), loss=loss.item(),
                        grad=m_flat((n, p.grad) for n, p in model.named_parameters()).cpu())
    return out


def m_errors(sr: torch.Tensor, refs: dict) -> dict:
    """Seam error (against the edge-fair baseline, away from the frame's edge
    rows) and frame-edge error (against the unsharded model), relative to the
    reference's largest value."""
    e = 4 * M_EDGE_ROWS
    scale = refs["unsharded"]["sr"].abs().max().item()
    seam = (sr - refs["fair"]["sr"])[:, :, e:-e].abs()
    edge = (sr - refs["unsharded"]["sr"]).abs()
    return dict(seam_max=seam.max().item() / scale, seam_rmse=seam.pow(2).mean().sqrt().item() / scale,
                edge_max=edge.max().item() / scale, edge_rmse=edge.pow(2).mean().sqrt().item() / scale)


def m_gather_rows(t: torch.Tensor, mesh, n_rows: int, per: int) -> torch.Tensor:
    """The frame of ``n_rows`` from every spatial rank's ``per`` rows (the
    last rank may hold fewer): on every rank."""
    import torch.distributed as dist

    from climsr_tpu_torch.parallel.mesh import axis_info

    group, _, size = axis_info(mesh, "spatial")
    padded = torch.zeros(t.shape[0], t.shape[1], per, t.shape[3], dtype=t.dtype, device=t.device)
    padded[:, :, : t.shape[2]] = t
    parts = [torch.empty_like(padded) for _ in range(size)]
    dist.all_gather(parts, padded.contiguous(), group=group)
    return torch.cat(parts, dim=2)[:, :, :n_rows]


def m_pruning_summary(record: list) -> list:
    """A pruning record (``parallel.cases.RecordedPruning``) as JSON, one
    entry an epoch: the sparsity the callback reports and the share of the
    prunable elements at 0 in the full weights after the pruning; whether the
    positions pruned the epoch before were still 0 after this epoch's steps
    (``kept``) and this epoch's after the pruning (``pruned``), each as
    [in the full weights, in the rank's shards]; digests of the masks and of
    the weights the pruning read."""
    from climsr_tpu_torch.parallel.cases import digest

    out = []
    for r in record[1:]:
        masks = r["masks"]
        total = sum(m.size for m in masks.values())
        zeros = sum(int((r["after"][k] == 0).sum()) for k in masks)
        out.append(dict(reported=r["sparsity"], measured=zeros / total, kept=list(r["kept"]),
                        pruned=list(r["pruned"]), masks=digest(masks.values()),
                        before=digest(v.numpy() for v in r["before"].values())))
    return out


def m_probe_only(tr):
    """A Trainer holding only what ``Trainer._probe_batch_size`` reads of
    ``tr`` (its configuration and datamodule, none of its models or stores on
    the card), with no trials yet: M8's one-rank probe on it finds the card as
    the ranks' probe found it."""
    from climsr_tpu_torch.training.loop import Trainer

    bare = object.__new__(Trainer)
    bare.__dict__.update({k: getattr(tr, k) for k in ("dm", "device", "generator_type", "generator_cfg",
                                                      "compute_dtype", "training_cfg", "optimizers_cfg",
                                                      "trainer_cfg")}, batch_trials=[])
    return bare


def phase_multi_rank(root: str) -> None:
    """One rank of phase M (started by :func:`phase_multi` under gloo, on
    ``cuda:0`` with the other ranks): M1-M8 through the port's entry points,
    each part's kernel launches counted from 0, every launch's shape of M1-M7
    and of M8's steps recorded, M8's one-rank probe run after the counted
    window; the results go to ``root/rank<r>.json`` and ``.pt``."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from climsr_tpu_torch.cli.inference import main as inference_main
    from climsr_tpu_torch.cli.train import main as train_main
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.rcan import CALayer
    from climsr_tpu_torch.parallel import halo as H
    from climsr_tpu_torch.parallel.cases import recorded_pruning
    from climsr_tpu_torch.parallel.mesh import all_gather_dim, axis_info, create_mesh, reduce_scatter_dim

    root_p = Path(root)
    rank = dist.get_rank()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = torch.load(root_p / "refs.pt", weights_only=False)
    counters = kernel_counters()
    out = {"launches": {}, "seconds": {}}
    tensors = {}

    def part(label: str):
        @contextlib.contextmanager
        def ctx():
            zero_counts(counters)
            torch.cuda.synchronize()
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            out["seconds"][label] = time.perf_counter() - t
            out["launches"][label] = counts(counters)
        return ctx()

    with recorded_shapes() as shapes:
        data = create_mesh()
        # M1: ZeRO stages 0-3 of the pre-training step
        with part("M1"):
            for stage in (0, 1, 2, 3):
                losses, norms, state = m_pretrain(device, M_STEPS, stage, data)
                p = state.partition
                full = sum(q.grad is not None for n, q in p.named if p.is_sharded(n))
                p.materialize()
                if stage == 3:  # one all-gather, and one reduce-scatter, of every sharded tensor
                    sharded = [(p.shards[n].detach(), state.model.get_parameter(n).detach(), p.dims[n])
                               for n, _ in p.named if p.is_sharded(n)]
                    out["zero_gather_ms"] = m_ms(lambda: [all_gather_dim(s, d, p.group, p.size)
                                                          for s, _, d in sharded])
                    out["zero_scatter_ms"] = m_ms(lambda: [reduce_scatter_dim(f, d, p.group, p.size)
                                                           for _, f, d in sharded])
                    out["zero_sharded_mb"] = sum(f.numel() * 4 for _, f, _ in sharded) / 1e6
                out[f"M1 stage {stage}"] = dict(
                    losses=losses, norms=norms, sharded=sum(map(p.is_sharded, (n for n, _ in p.named))),
                    full_grads=full, params_rel=m_rel(m_flat(state.model.named_parameters()), refs["M1"]["params"]))
                del state, p
        # M2: the GAN step at stages 0 and 2, batch statistics over the data axis
        with part("M2"):
            for stage in (0, 2):
                trace, state = m_gan(device, M_GAN_STEPS, stage, data)
                for part_ in (state.g_partition, state.d_partition):
                    if part_ is not None:
                        part_.materialize()
                out[f"M2 stage {stage}"] = dict(
                    trace=trace, running_var_rel=m_rel(
                        m_flat((n, b) for n, b in state.d_model.named_buffers() if "running_var" in n),
                        refs["M2"]["running_var"]),
                    g_rel=m_rel(m_flat(state.g_model.named_parameters()), refs["M2"]["g"]),
                    d_rel=m_rel(m_flat(state.d_model.named_parameters()), refs["M2"]["d"]))
                del state
        # M3: the spatial step at europe extent, on (1, 4) and, with ZeRO-3, on (2, 2)
        eu = m_batch(M_EU_N, 113, 113, seed=4)
        with part("M3"):
            mesh = create_mesh(axes=("data", "spatial"), last_axis_size=M_RANKS)
            model = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                                     device=device, train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
            fwd = H.spatial_sharded_model_forward(model, "esrgan", mesh, axis="spatial", halo=M_HALO, scale=4)
            args = [eu[k].to(device=device, dtype=torch.bfloat16) for k in ("lr", "elevation", "mask")]
            hl = (113 + 3) // M_RANKS  # the frame padded to 116 rows
            local = [F.pad(a, (0, 0, 0, 3 * s), mode="reflect")[:, :, rank * hl * s:(rank + 1) * hl * s]
                     for a, s in zip(args, (1, 4, 4))]
            feat = torch.randn(M_EU_N, NF, hl, 113, device=device, dtype=torch.bfloat16)
            out["halo_inputs_ms"] = m_ms(lambda: [H._halo_pad_reflect(a, M_HALO * s, mesh, "spatial")
                                                  for a, s in zip(local, (1, 4, 4))])
            out["halo_feature_ms"] = m_ms(lambda: H._halo_pad_reflect(feat, M_HALO, mesh, "spatial"))
            sr, rows = fwd(*args)
            hr = eu["hr"].to(device)[:, :, rows].float()
            loss = torch.abs(sr.float() - hr).sum() / eu["hr"].numel()
            loss.backward()
            grad = m_flat((n, q.grad) for n, q in model.named_parameters())
            dist.all_reduce(grad)
            loss_all = loss.detach().clone()
            dist.all_reduce(loss_all)
            frame = m_gather_rows(sr.detach().float(), mesh, 4 * 113, 4 * 29).cpu()  # 113 rows padded to 116
            out["M3 (1, 4)"] = dict(loss=loss_all.item(), grad_rel_fair=m_rel(grad.cpu(), refs["M3"]["fair"]["grad"]),
                                    grad_rel_unsharded=m_rel(grad.cpu(), refs["M3"]["unsharded"]["grad"]),
                                    **m_errors(frame, refs["M3"]))
            del model
            spatial = {"mesh": mesh, "axis": "spatial", "halo": M_HALO, "scale": 4}
            losses, norms, _ = m_pretrain(device, 2, 0, mesh, spatial=spatial, batch=eu)
            out["M3 step (1, 4)"] = dict(losses=losses, norms=norms)
            mesh22 = create_mesh(axes=("data", "spatial"), last_axis_size=2)
            spatial = {"mesh": mesh22, "axis": "spatial", "halo": M_HALO, "scale": 4}
            losses, norms, state = m_pretrain(device, 2, 3, mesh22, spatial=spatial, batch=eu)
            out["M3 step (2, 2) ZeRO-3"] = dict(losses=losses, norms=norms, sharded=sum(
                map(state.partition.is_sharded, (n for n, _ in state.partition.named))))
            del state
            spatial = {"mesh": mesh22, "axis": "spatial", "halo": M_HALO, "scale": 4}
            trace, state = m_gan(device, M_GAN_STEPS, 0, mesh22, spatial=spatial)
            out["M3 GAN (2, 2)"] = dict(trace=trace)
            del state
        # M4: RCAN at its published widths, the exact pool against the local-pool control
        with part("M4"):
            axis = axis_info(mesh, "spatial")
            x = refs["M4"]["ca_x"].to(device)
            hl = x.shape[2] // M_RANKS
            local = H._halo_pad_reflect(x[:, :, rank * hl:(rank + 1) * hl], 4, mesh, "spatial")
            plain = CALayer(64, 16).to(device)
            plain.load_state_dict(refs["M4"]["ca"])
            exact = CALayer(64, 16, spatial_axis=axis, spatial_halo=4).to(device)
            exact.load_state_dict(refs["M4"]["ca"])
            with torch.no_grad():
                ca = {tag: m_gather_rows(m(local)[:, :, 4:-4], mesh, x.shape[2], hl).cpu()
                      for tag, m in (("exact", exact), ("local", plain))}
            rcan = create_generator("rcan", dtype=torch.bfloat16, device=device, in_channels=3, out_channels=1,
                                    **FAMILIES["rcan"])
            rcan.load_state_dict(refs["M4"]["rcan"])
            frames = {}
            rb = m_batch(M_RCAN_N, 113, 113, seed=6)
            args = [rb[k].to(device=device, dtype=torch.bfloat16) for k in ("lr", "elevation", "mask")]
            for tag, model in (("exact", rcan), ("local", _LocalPoolRCAN(rcan))):
                fwd = H.spatial_sharded_model_forward(model, "rcan", mesh, axis="spatial", halo=M_HALO, scale=4)
                with torch.inference_mode():
                    frames[tag] = m_gather_rows(fwd(*args)[0].float(), mesh, 4 * 113, 4 * 29).cpu()
            out["M4"] = dict(pool_exact=(ca["exact"] - refs["M4"]["ca_want"]).abs().max().item(),
                             pool_local=(ca["local"] - refs["M4"]["ca_want"]).abs().max().item(),
                             exact=m_errors(frames["exact"], refs["M4"]), local=m_errors(frames["local"], refs["M4"]))
        # M5: cli.inference with spatial_shard over the ranks; rank 0 writes
        with part("M5"):
            inference_main(refs["M5"]["overrides"] + ["inference.spatial_shard=true",
                                                      f"inference.spatial_halo={M_INFER_HALO}",
                                                      f"inference.inference_out_path={root_p / 'sharded'}",
                                                      f"inference.extent_out_path_sr_nc={root_p / 'sharded_nc'}"],
                           device=device)
        # M6: cli.train over the ranks at ZeRO-2, then with the spatial plugin
        with part("M6"):
            base = refs["M6"]["overrides"]
            train_main(base + ["trainer.zero_stage=2", f"training.output_dir={root_p / 'zero2'}"], device=device)
            train_main(base + ["plugins=spatial_shard", "trainer.spatial_shard_halo=4",
                               f"training.output_dir={root_p / 'spatial'}"], device=device)
        # M7: cli.train with the pruning callbacks under ZeRO 1-3, each epoch's pruning recorded
        with part("M7"):
            for stage, name in M7_RUNS:
                record = []
                with recorded_pruning(record):
                    train_main(base + [f"callbacks=[{name}]", f"trainer.zero_stage={stage}",
                                       "training.run_test_after_fit=false",
                                       f"training.output_dir={root_p / f'prune{stage}_{name}'}"], device=device)
                out[f"M7 {stage} {name}"] = m_pruning_summary(record)
    # M8: the batch probe over the ranks, then one step at the chosen batch on every rank at once. The trials
    # (rank 0's, up to the card's memory, as P's) are counted; the steps' shapes are recorded
    def release() -> None:
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()  # every rank's cache is empty before rank 0's trials

    probes = {}
    with part("M8"):
        for mode in M8_MODES:
            release()
            held_gb = torch.cuda.memory_allocated() / 1e9
            trainers = []
            with keep_trainers(trainers):
                train_main(base + [f"trainer.auto_scale_batch_size={mode}", "training.run_fit=false",
                                   "training.run_test_after_fit=false",
                                   f"training.output_dir={root_p / f'probe_{mode}'}"], device=device)
            (tr,) = trainers
            chosen = tr.dm.cfg.batch_size
            idx = torch.arange(chosen) % len(tr.dm.train_dataset)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            with recorded_shapes() as step_shapes:
                tr.state, metrics = tr.train_step(tr.state, idx)
            for k, v in step_shapes.items():
                shapes.setdefault(k, set()).update(v)
            out[f"M8 {mode}"] = dict(batch=chosen, trials=tr.batch_trials, loss=metrics["train/loss"].item(),
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9, held_gb=held_gb)
            probes[mode] = m_probe_only(tr)
            del tr, trainers, metrics
    # one rank's probe from the same start under the same split, outside the counted window: on rank 0, with
    # nothing of the runs left on the card, while the others wait
    for mode in M8_MODES:
        release()
        ref = None
        if rank == 0:
            bare = probes[mode]
            bare.dm.cfg.batch_size = out[f"M8 {mode}"]["trials"][0]["bs"]
            ref = dict(batch=bare._probe_batch_size(M_RANKS, PROBE_HEADROOM / M_RANKS), trials=bare.batch_trials)
        out[f"M8 {mode}"]["ref"] = ref
    release()
    out["shapes"] = {k: sorted([list(n), list(w) if isinstance(w, tuple) else w, str(dt)] for n, w, dt in v)
                     for k, v in shapes.items()}
    (root_p / f"rank{rank}.json").write_text(json.dumps(out))


class _LocalPoolRCAN(torch.nn.Module):
    """M4's control: RCAN whose channel attention pools each shard alone
    (no ``spatial_axis`` for the sharded forward to set)."""

    def __init__(self, rcan):
        super().__init__()
        self.rcan = rcan

    def forward(self, *args):
        return self.rcan(*args)


def phase_multi(device, root: Path, card: str, trainer: dict, pruning: dict) -> dict:
    """M: the port's multi-rank code, 4 gloo ranks sharing the one card (NCCL
    refuses two ranks on one card): the references from one rank here, the
    ranks' results held against them, and A, B1, B2 and C at every shape the
    ranks launched them in M1-M7 and in M8's steps against their plain
    versions. ``trainer`` is phase 13's result: its set, best checkpoint and
    logged single-rank run;
    ``pruning`` is phase R's logged single-rank run of each pruning callback.
    Times from ranks that share a card are not multi-GPU figures."""
    from climsr_tpu_torch.consts import datasets_and_preprocessing as D
    from climsr_tpu_torch.data.tables import Table, write_feather
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.io.geotiff import read_geotiff
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.models.rcan import CALayer
    from climsr_tpu_torch.parallel.launch import spawn
    from climsr_tpu_torch.cli.inference import main as inference_main

    t0 = time.perf_counter()
    m_root = root / "m"
    m_root.mkdir()
    refs = {}
    # M1, M2: one rank on the global batch of 192
    losses, norms, state = m_pretrain(device, M_STEPS)
    refs["M1"] = dict(losses=losses, norms=norms, params=m_flat(state.model.named_parameters()).cpu())
    del state
    trace, state = m_gan(device, M_GAN_STEPS)
    refs["M2"] = dict(trace=trace, running_var=m_flat(
        (n, b) for n, b in state.d_model.named_buffers() if "running_var" in n).cpu(),
        g=m_flat(state.g_model.named_parameters()).cpu(), d=m_flat(state.d_model.named_parameters()).cpu())
    del state
    # M1's model at its start (m_pretrain's seed): how far the steps moved it
    start = m_flat(create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                                    device=device, train=True, in_channels=3, out_channels=1, nf=NF, nb=NB,
                                    gc=GC).named_parameters())
    m1_moved = m_rel(refs["M1"]["params"], start)
    # M2's control: one rank's GAN steps on rank 0's slice of the batch alone
    _, state = m_gan(device, M_GAN_STEPS, n=TRAIN_N // M_RANKS)
    control = {k: m_rel(m_flat(m.named_parameters()), refs["M2"][k]) for k, m in (("g", state.g_model),
                                                                                  ("d", state.d_model))}
    del state
    trace, state = m_gan(device, M_GAN_STEPS, edge_fair_halo=M_HALO)
    refs["M3 GAN"] = dict(trace=trace)
    del state
    # M3, M4: the unsharded and edge-fair references
    esr = create_generator("esrgan", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0), device=device,
                           train=True, in_channels=3, out_channels=1, nf=NF, nb=NB, gc=GC)
    refs["M3"] = m_spatial_refs(device, esr, m_batch(M_EU_N, 113, 113, seed=4), M_HALO)
    del esr
    ca = CALayer(64, 16)
    gen = torch.Generator().manual_seed(7)
    for conv in (ca.conv_du[0], ca.conv_du[2]):
        torch.nn.init.normal_(conv.weight, 0, 0.2, generator=gen)
    x = torch.randn(2, 64, 128, 113, generator=gen)
    x[:, :, :64] += 3.0  # rows whose shards' local means differ
    rcan = create_generator("rcan", dtype=torch.bfloat16, device=device, in_channels=3, out_channels=1,
                            generator=torch.Generator().manual_seed(8), **FAMILIES["rcan"])
    with torch.no_grad():
        ca_want = ca.to(device)(x.to(device)).cpu()
    refs["M4"] = dict(ca=ca.state_dict(), ca_x=x, ca_want=ca_want, rcan=rcan.state_dict())
    rb = m_batch(M_RCAN_N, 113, 113, seed=6)
    with torch.inference_mode():
        import torch.nn.functional as F

        args = [rb[k].to(device=device, dtype=torch.bfloat16) for k in ("lr", "elevation", "mask")]
        unsharded = rcan(*args).float().cpu()
        fair_in = [F.pad(F.pad(a, (0, 0, 0, 3 * s), mode="reflect"), (0, 0, M_HALO * s, M_HALO * s), mode="reflect")
                   for a, s in zip(args, (1, 4, 4))]
        fair = rcan(*fair_in).float()[:, :, 4 * M_HALO: 4 * (M_HALO + 113)].cpu()
    refs["M4"].update(unsharded=dict(sr=unsharded), fair=dict(sr=fair))
    del rcan
    # M5: a whole-globe world of M_MONTHS months, the lookups, and the single-rank tiled run
    make_globe(m_root, M_MONTHS, 360, 720)
    write_feather(Table.from_rows([{"dataset": "cru-ts", "variable": "tmp", "filename": "x", "min": -20.0,
                                    "max": 40.0, "global_min": -20.0, "global_max": 40.0}]), m_root / "minmax.feather")
    overrides = [f"inference.pretrained_model={trainer['best_ckpt']}", "inference.generator_type=esrgan",
                 f"inference.min_max_lookup={m_root / 'minmax.feather'}", "inference.cruts_variable=tmp",
                 "inference.use_netcdf_datasets=true", f"inference.ds_path={m_root / 'cru_ts4.05.1901.2020.tmp.dat.nc'}",
                 f"inference.elevation_file={m_root / 'elevation.tif'}",
                 f"inference.land_mask_file={m_root / 'land_mask.tif'}", "generator.in_channels=3",
                 "generator.out_channels=1", f"generator.nf={NF}", f"generator.nb={NB}", f"generator.gc={GC}"]
    refs["M5"] = dict(overrides=overrides)
    # the default tiles (128 px, 8 px of overlap), tiles with 32 px of overlap, and the whole frame (1024 > 720)
    for tag, extra in (("tiled", []), ("tiled32", ["inference.tile_size=128", "inference.tile_overlap=32"]),
                       ("whole", ["inference.tile_size=1024"])):
        inference_main(overrides + extra + [f"inference.inference_out_path={m_root / tag}",
                                            f"inference.extent_out_path_sr_nc={m_root / (tag + '_nc')}"],
                       device=device)
    # M6: phase 13's set with its index on disk, for the ranks' datamodules
    feather_dir = root / "ds" / D.preprocessing_output_path / D.feather_path
    for rel, table in trainer["tables"].items():
        (feather_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        write_feather(table, feather_dir / rel)
    refs["M6"] = dict(overrides=["experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
                                 f"trainer.max_epochs={TRAINER_EPOCHS}", f"trainer.num_devices={M_RANKS}",
                                 "trainer.log_every_n_steps=1", "logger=csv", "print_config=false"])
    torch.save(refs, m_root / "refs.pt")
    ref_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()  # the card's memory for the ranks
    t = time.perf_counter()
    spawn("chip_smoke:phase_multi_rank", M_RANKS, {"root": str(m_root)},
          env={"PYTHONPATH": str(Path(__file__).resolve().parent)}, timeout=900)
    ranks_s = time.perf_counter() - t
    res = [json.loads((m_root / f"rank{r}.json").read_text()) for r in range(M_RANKS)]
    r0 = res[0]
    for label, s in r0["seconds"].items():
        print(f"# M {label}: {s:.3f} s on rank 0; launches summed over the ranks "
              + json.dumps({k: sum(r["launches"][label][k] for r in res) for k in r0["launches"][label]}))

    # M1
    failures = []  # every part is read and printed; the phase fails at its end if any part failed

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    for stage in (0, 1, 2, 3):
        got = r0[f"M1 stage {stage}"]
        traj = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], refs["M1"]["losses"]))
        norm = max(abs(a - b) / abs(b) for a, b in zip(got["norms"], refs["M1"]["norms"]))
        same = all(r[f"M1 stage {stage}"]["losses"] == got["losses"] for r in res)
        print(f"# M1 ZeRO-{stage}, 4 x {TRAIN_N // M_RANKS}: losses {['%.6f' % v for v in got['losses']]} against one "
              f"rank's {['%.6f' % v for v in refs['M1']['losses']]}: trajectory {traj:.2e}, grad norms {norm:.2e} "
              f"(tol {M_LOSS_TOL:g}, {M_NORM_TOL:g}); parameters rel-L2 {got['params_rel']:.2e} (tol {M_PARAM_TOL:g}, "
              f"and {M_MOVE_SHARE:g} of the steps' move {m1_moved:.2e}); {got['sharded']} tensors sharded; full "
              f"gradients kept {got['full_grads']}")
        check(traj <= M_LOSS_TOL and norm <= M_NORM_TOL and got["params_rel"] <= M_PARAM_TOL
              and got["params_rel"] <= M_MOVE_SHARE * m1_moved and same, f"M1 stage {stage} disagrees with one rank")
        check((stage >= 1) == (got["sharded"] > 0) and not (stage == 3 and any(r["M1 stage 3"]["full_grads"]
                                                                               for r in res)),
              f"M1 stage {stage}: sharding {got['sharded']}, full gradients {got['full_grads']}")
    print(f"# M collectives, gloo, 4 ranks sharing the card (overhead figures, not multi-GPU ones; {card}): ZeRO-3 "
          f"all-gather of the {r0['M1 stage 3']['sharded']} sharded tensors ({r0['zero_sharded_mb']:.1f} MB f32) "
          f"{r0['zero_gather_ms']:.3f} ms, reduce-scatter {r0['zero_scatter_ms']:.3f} ms; halo exchange of M3's "
          f"inputs (halo {M_HALO} LR rows, 4 x {M_HALO} HR) {r0['halo_inputs_ms']:.3f} ms, of a {M_EU_N} x {NF} x 29 "
          f"x 113 bf16 feature map {r0['halo_feature_ms']:.3f} ms (rank 0's medians of 5)")
    # M2
    for stage in (0, 2):
        got = r0[f"M2 stage {stage}"]
        worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["trace"], refs["M2"]["trace"])
                    for k in ("train/loss_G", "train/loss_D"))
        print(f"# M2 GAN ZeRO-{stage}: loss_G {['%.6f' % m['train/loss_G'] for m in got['trace']]}, loss_D "
              f"{['%.6f' % m['train/loss_D'] for m in got['trace']]}; worst relative difference to one rank "
              f"{worst:.2e}, D's running variances rel-L2 {got['running_var_rel']:.2e} (tol {M_GAN_TOL:g}); G's and "
              f"D's parameters rel-L2 {got['g_rel']:.2e}, {got['d_rel']:.2e} (tol {M_PARAM_TOL:g}, and "
              f"{M_CONTROL_SHARE:g} of one rank's on its slice alone, {control['g']:.2e}, {control['d']:.2e})")
        check(worst <= M_GAN_TOL and got["running_var_rel"] <= M_GAN_TOL
              and all(got[f"{k}_rel"] <= min(M_PARAM_TOL, M_CONTROL_SHARE * control[k]) for k in ("g", "d")),
              f"M2 stage {stage} disagrees with one rank")
    # M3
    got = r0["M3 (1, 4)"]
    loss_err = abs(got["loss"] - refs["M3"]["fair"]["loss"]) / refs["M3"]["fair"]["loss"]
    print(f"# M3 spatial (1, 4), halo {M_HALO}, {M_EU_N} x 113 x 113 LR: loss {got['loss']:.6f} against the "
          f"edge-fair {refs['M3']['fair']['loss']:.6f} ({loss_err:.2e}) and unsharded "
          f"{refs['M3']['unsharded']['loss']:.6f}; output relative to its max: seam max {got['seam_max']:.3e} rmse "
          f"{got['seam_rmse']:.3e} (interior, against the edge-fair baseline), frame edge max {got['edge_max']:.3e} "
          f"rmse {got['edge_rmse']:.3e} (against the unsharded model); gradient rel-L2 {got['grad_rel_fair']:.3e} "
          f"edge-fair, {got['grad_rel_unsharded']:.3e} unsharded")
    for tag in ("M3 step (1, 4)", "M3 step (2, 2) ZeRO-3"):
        print(f"# {tag}: losses {['%.6f' % v for v in r0[tag]['losses']]}, grad norms "
              f"{['%.4f' % v for v in r0[tag]['norms']]}")
    steps_ok = all(np.isfinite(r0[t]["losses"] + r0[t]["norms"]).all() for t in ("M3 step (1, 4)",
                                                                                  "M3 step (2, 2) ZeRO-3"))
    first = [r0[t]["losses"][0] for t in ("M3 step (1, 4)", "M3 step (2, 2) ZeRO-3")]
    check(loss_err <= STEP_LOSS_TOL and got["seam_max"] <= GENERATOR_TOL[torch.bfloat16]
          and got["grad_rel_fair"] <= GRAD_TOL and steps_ok
          and max(abs(v - refs["M3"]["fair"]["loss"]) / refs["M3"]["fair"]["loss"] for v in first) <= STEP_LOSS_TOL
          and r0["M3 step (2, 2) ZeRO-3"]["sharded"] > 0,
          "M3: the spatial step disagrees with the edge-fair unsharded step")
    got = r0["M3 GAN (2, 2)"]
    worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["trace"], refs["M3 GAN"]["trace"])
                for k in ("train/loss_G", "train/loss_D"))
    print(f"# M3 spatial GAN (2, 2), halo {M_HALO}, batch {TRAIN_N}: loss_G "
          f"{['%.6f' % m['train/loss_G'] for m in got['trace']]}, loss_D "
          f"{['%.6f' % m['train/loss_D'] for m in got['trace']]}; worst relative difference to one rank's "
          f"edge-fair step {worst:.2e} (tol {GAN_LOSS_TOL:g})")
    check(worst <= GAN_LOSS_TOL, "M3: the spatial GAN step disagrees with the edge-fair unsharded step")
    # M4
    got = r0["M4"]
    print(f"# M4 RCAN CALayer at 64 channels, f32, 128 rows over 4 ranks: exact pool {got['pool_exact']:.3e} "
          f"(tol {M_POOL_TOL:g}), local-pool control {got['pool_local']:.3e}; RCAN 10 x 20 x 64 bf16 sharded, "
          f"halo {M_HALO}: exact pool seam max {got['exact']['seam_max']:.3e} rmse {got['exact']['seam_rmse']:.3e}, "
          f"local pool seam max {got['local']['seam_max']:.3e} rmse {got['local']['seam_rmse']:.3e}; frame edge max "
          f"{got['exact']['edge_max']:.3e}")
    check(got["pool_exact"] <= M_POOL_TOL and got["pool_local"] > 100 * max(got["pool_exact"], 1e-7)
          and got["local"]["seam_rmse"] > got["exact"]["seam_rmse"],
          "M4: the exact channel-attention pool is not exact, or the control does not differ")
    # M5: rank 0's GeoTIFFs against one rank's whole-frame run (the same function but the seams, each rank
    # seeing M_INFER_HALO rows of its neighbours). The default tiled run is no reference for them: its own tiles
    # see 8 px of context against a ~170-px receptive field, and it reflect-pads the frame's right edge to the
    # tile grid where the whole frame zero-pads (tests/test_torch_inference.py holds the tiled sweep against the
    # JAX package's, and its gap to the whole frame against the JAX package's gap). Its gap to the whole frame
    # is bounded here, in the interior and at the frame's left and right edge columns, with the run at 32 px of
    # overlap as a second witness: more context, a smaller interior gap, the same edge columns.
    mask = read_geotiff(m_root / "land_mask.tif")[0]
    land = np.isfinite(mask)
    e = 4 * M_EDGE_ROWS

    def tifs(tag: str) -> list:
        paths = sorted((m_root / tag / "tmp").glob("*.tif"))
        if len(paths) != M_MONTHS:
            raise AssertionError(f"M5: {tag} wrote {[p.name for p in paths]}")
        return [(p.name, read_geotiff(p)[0]) for p in paths]

    whole = tifs("whole")

    def gap(tag: str) -> dict:
        """Worst over the months of |run - whole frame| / the frame's half range, away from its top and bottom
        edge rows: max and mean over the interior columns, max over the left and right edge columns."""
        worst = dict(max=0.0, mean=0.0, edge_cols=0.0)
        for (name, a), (name_b, b) in zip(tifs(tag), whole):
            if name != name_b:
                raise AssertionError(f"M5: {tag} wrote {name} where one rank's whole frame wrote {name_b}")
            if not (np.isfinite(a[land]).all() and np.isnan(a[~land]).all()):
                raise AssertionError(f"M5: the {tag} GeoTIFF is not finite on land and NaN on the sea")
            half = (float(np.nanmax(b)) - float(np.nanmin(b))) / 2
            d = np.abs(a - b)[e:-e] / half
            worst["max"] = max(worst["max"], float(np.nanmax(d[:, e:-e])))
            worst["mean"] = max(worst["mean"], float(np.nanmean(d[:, e:-e])))
            worst["edge_cols"] = max(worst["edge_cols"], float(np.nanmax(np.concatenate([d[:, :e], d[:, -e:]], 1))))
        return worst

    gaps = {tag: gap(tag) for tag in ("sharded", "tiled", "tiled32")}
    nc = list((m_root / "sharded_nc").glob("*.nc"))
    g = gaps["sharded"]
    print(f"# M5 cli.inference spatial_shard over {M_RANKS} ranks, {M_MONTHS} whole-globe months, halo "
          f"{M_INFER_HALO}: finite on land, NaN on the sea; of the frame's half range, away from its top and bottom "
          f"{M_EDGE_ROWS} LR rows, against one rank's whole frame: max {max(g['max'], g['edge_cols']):.3e} mean "
          f"{g['mean']:.3e} (tol {GENERATOR_TOL[torch.bfloat16] + 1e-3:g}: bf16 plus the CPU test's seam 1e-3); "
          f"NetCDF {[p.name for p in nc]}")
    for tag, overlap in (("tiled", 8), ("tiled32", 32)):
        g = gaps[tag]
        print(f"# M5 one rank's tiled run (128-px tiles, {overlap} px of overlap) against its whole frame, of the "
              f"half range: interior max {g['max']:.3e} mean {g['mean']:.3e}, the {M_EDGE_ROWS} LR columns at the "
              f"frame's left and right edges max {g['edge_cols']:.3e} (tol: interior max {M5_TILED_MAX:g}, mean "
              f"{M5_TILED_MEAN:g}, edges {M5_TILED_EDGE:g}; 32 px below 8 px in the interior)")
    check(max(gaps["sharded"]["max"], gaps["sharded"]["edge_cols"]) <= GENERATOR_TOL[torch.bfloat16] + 1e-3
          and len(nc) == 1,
          "M5: the sharded inference disagrees with the single-rank run")
    tiled, tiled32 = gaps["tiled"], gaps["tiled32"]
    check(all(g["max"] <= M5_TILED_MAX and g["mean"] <= M5_TILED_MEAN and g["edge_cols"] <= M5_TILED_EDGE
              for g in (tiled, tiled32)) and tiled32["mean"] < tiled["mean"] and tiled32["max"] < tiled["max"],
          "M5: the tiled run's gap to the whole frame is not the tiles' seams")
    # M6: the runs against phase 13's single-rank run; the best checkpoints load in one rank
    from climsr_tpu_torch.training.checkpoint import CheckpointManager

    for tag, tol in (("zero2", M6_TOL), ("spatial", M6_SPATIAL_TOL)):
        (run_dir,) = (m_root / tag / "outputs" / "runs" / "esrgan").iterdir()
        rows = metric_rows(run_dir / "metrics.csv")
        mgr = CheckpointManager(run_dir / "checkpoints", save_top_k=-1)
        fresh = create_generator("esrgan", dtype=torch.bfloat16, device=device, train=True, in_channels=3,
                                 out_channels=1, nf=NF, nb=NB, gc=GC)
        fresh.load_state_dict(load_generator_checkpoint(mgr.path(mgr.best_step)), strict=True)
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        rmse = [r["val/rmse"] for r in rows if "val/rmse" in r]
        pairs = list(zip(losses, trainer["train_loss"])) + list(zip(rmse, trainer["val_rmse"]))
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        print(f"# M6 cli.train {tag} over {M_RANKS} ranks: train/loss {['%.6f' % v for v in losses]}, val/rmse "
              f"{['%.6f' % v for v in rmse]} against phase 13's one rank {['%.6f' % v for v in trainer['train_loss']]}, "
              f"{['%.6f' % v for v in trainer['val_rmse']]}: {err:.2e} relative (tol {tol:g}); best checkpoint step "
              f"{mgr.best_step} loads in one rank with strict=True")
        check(len(losses) == len(trainer["train_loss"]) and len(rmse) == len(trainer["val_rmse"]) and err <= tol
              and np.isfinite(losses + rmse).all(), f"M6 {tag}: the run over the ranks disagrees with phase 13's run")
    # M7: every rank's pruning, and the runs against phase R's one rank with the same callback
    for stage, name in M7_RUNS:
        label = f"M7 {stage} {name}"
        epochs = [r[label] for r in res]
        (run_dir,) = (m_root / f"prune{stage}_{name}" / "outputs" / "runs" / "esrgan").iterdir()
        rows = metric_rows(run_dir / "metrics.csv")
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        rmse = [r["val/rmse"] for r in rows if "val/rmse" in r]
        ref = pruning[name]
        pairs = list(zip(losses, ref["train_loss"])) + list(zip(rmse, ref["val_rmse"]))
        err = max(abs(a - b) / abs(b) for a, b in pairs)
        measured = [[round(100 * e["measured"], 1) for e in got] for got in epochs]
        reported = [[round(100 * e["reported"], 1) for e in got] for got in epochs]
        same = all([(e["masks"], e["before"]) for e in got] == [(e["masks"], e["before"]) for e in epochs[0]]
                   for got in epochs)
        zeros = all(e["kept"] == [True, True] and e["pruned"] == [True, True] for got in epochs for e in got)
        print(f"# {label} over {M_RANKS} ranks: sparsity after each epoch, measured on each rank's gathered "
              f"generator {measured} (reported {reported}; want {list(M7_SPARSITY)}); pruned positions 0 after the "
              f"next steps and after each pruning, in the gathered weights and every rank's shards: {zeros}; masks "
              f"and the weights they were taken from identical on every rank: {same}; train/loss "
              f"{['%.6f' % v for v in losses]}, val/rmse {['%.6f' % v for v in rmse]} against phase R's one rank "
              f"{['%.6f' % v for v in ref['train_loss']]}, {['%.6f' % v for v in ref['val_rmse']]}: {err:.2e} "
              f"relative (tol {M6_TOL:g})")
        check(all(m == list(M7_SPARSITY) for m in measured + reported) and zeros and same
              and len(losses) == len(ref["train_loss"]) and len(rmse) == len(ref["val_rmse"]) and err <= M6_TOL
              and np.isfinite(losses + rmse).all(), f"{label}: the pruning over the ranks is wrong or disagrees "
                                                    f"with one rank")
    # M8: one batch on every rank, one rank's probe's, and a step at it on every rank at once
    for mode in M8_MODES:
        got = [r[f"M8 {mode}"] for r in res]
        batches = [g["batch"] for g in got]
        ref = got[0]["ref"]

        def trials(ts):
            return [(t["bs"], round(t["peak_bytes"] / 1e9, 3), t["fits"]) for t in ts]

        usable = sorted({round(t["usable_bytes"] / 1e9, 3) for t in got[0]["trials"]})
        print(f"# M8 {mode} over {M_RANKS} ranks sharing the card: batch {batches} (from {TRAIN_N}); one rank's probe "
              f"at a rank's slice ({M_RANKS} shards) under {PROBE_HEADROOM:g} / {M_RANKS} of the usable memory, on "
              f"rank 0 after the runs while the others waited: {ref['batch']}; trials (global batch, step peak GB, fits) on rank 0 "
              f"{trials(got[0]['trials'])}, one rank's {trials(ref['trials'])}, on ranks 1-3 "
              f"{[len(g['trials']) for g in got[1:]]}; usable GB (free on the card plus rank 0's own) {usable}, "
              f"{got[0]['held_gb']:.3f} GB held by rank 0 before; a step at the batch on all {M_RANKS} ranks at once "
              f"({-(-batches[0] // M_RANKS)} samples a rank): "
              f"losses {['%.6f' % g['loss'] for g in got]}, peak GB {['%.3f' % g['peak_gb'] for g in got]} ({card})")
        check(batches == [ref["batch"]] * M_RANKS and ref["batch"] >= TRAIN_N and not any(g["trials"] for g in got[1:])
              and all(np.isfinite(g["loss"]) for g in got), f"M8 {mode}: the ranks' batch is not one rank's probe's")
    # A, B1, B2 and C at every shape the ranks launched them in M1-M7 and in M8's steps
    merged = {}
    for r in res:
        for k, v in r["shapes"].items():
            merged.setdefault(k, set()).update((tuple(n), tuple(w) if isinstance(w, list) else w,
                                                getattr(torch, dt.split(".")[1])) for n, w, dt in v)
    launches = {label: {k: sum(r["launches"][label][k] for r in res) for k in r0["launches"][label]}
                for label in r0["launches"]}
    needed = dict(M1=("B1", "B2", "C"), M2=("B1", "B2", "C"), M3=("B1", "B2", "C"), M5=("A",),
                  M6=("A", "B1", "B2", "C"), M7=("A", "B1", "B2", "C"), M8=("B1", "B2", "C"))
    missing = [(label, k) for label, ks in needed.items() for k in ks if launches[label][k] <= 0]
    if missing:
        raise AssertionError(f"M: kernels of a part's path were not launched: {missing}")
    x_check_shapes(device, merged, label="M")
    if failures:
        raise AssertionError("M: " + "; ".join(failures))
    print(f"# M: references {ref_s:.1f} s, ranks {ranks_s:.1f} s ({card}; 4 ranks share the card: no time here "
          f"is a multi-GPU figure)")
    return dict(launches=launches)


O_MONTHS, O_GLOBE_LR = 2, (360, 720)  # phase O's whole-globe months
O_GEN = dict(nf=64, nb=1, gc=16, in_channels=3, out_channels=1)  # the fixture's generator
O_F32_TOL = 1e-4  # the card's f32 generator and loss against the JAX CPU record, relative to max |ref|


def o_record_inputs() -> dict:
    """The record's inputs, from seed 0 (as ``tests/test_torch_orbax.py`` makes them)."""
    rng = np.random.default_rng(0)
    tiles = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32), rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             (rng.random((2, 128, 128, 1)) > 0.3).astype(np.float32))
    batch = {"lr": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
             "hr": rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             "elevation": rng.normal(size=(2, 128, 128, 1)).astype(np.float32),
             "mask": (rng.random((2, 128, 128, 1)) > 0.3).astype(np.float32)}
    return {"tiles": tiles, "batch": batch}


def o_host() -> str:
    """This host's name and CPU model (the reader runs on the CPU)."""
    import platform

    model = "unknown CPU"
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{platform.node()}, {model}, {os.cpu_count()} CPUs"


def phase_orbax(device, root: Path, tables: dict, card: str) -> dict:
    """O: a JAX orbax checkpoint read, swept and resumed through the entry points."""
    import tarfile

    from climsr_tpu_torch.cli.inference import main as inference_main
    from climsr_tpu_torch.data.tables import Table, write_feather
    from climsr_tpu_torch.interop.orbax import restore_pytree
    from climsr_tpu_torch.interop.params import load_generator_checkpoint
    from climsr_tpu_torch.io.netcdf import read_climate_series
    from climsr_tpu_torch.models import create_generator
    from climsr_tpu_torch.ops.pack12 import MAX_ABS_ERR
    from climsr_tpu_torch.training.checkpoint import load_checkpoint
    from climsr_tpu_torch.training.optimizers import build_optimizer
    from climsr_tpu_torch.config.schemas import OptimizerConfig
    from climsr_tpu_torch.training.tasks.pretrain import make_pretrain_step
    from climsr_tpu_torch.training.train_state import TrainState

    here = Path(__file__).resolve().parent / "tests" / "fixtures"
    record = np.load(here / "jax_orbax_record.npz")
    with tarfile.open(here / "jax_orbax_ckpt.tar") as tar:
        tar.extractall(root / "o", filter="data")
    ckpt = root / "o" / "checkpoints"
    counters = kernel_counters()
    launches, failed = {}, []

    # O1: the whole tree, on the host
    t = time.perf_counter()
    tree = restore_pytree(ckpt)
    read_s = time.perf_counter() - t
    nbytes = du(ckpt)
    sd = load_generator_checkpoint(ckpt)
    print(f"# O1 orbax checkpoint read whole: {nbytes / 1e6:.3f} MB on disk, {sum(v.numel() for v in sd.values())} "
          f"generator parameters, step {int(tree['step'])}, in {read_s:.3f} s = {nbytes / 1e6 / read_s:.3f} MB/s on "
          f"the host ({o_host()})")

    # O2: the generator against the JAX record, then cli.inference from the directory
    x, elev, mask = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in o_record_inputs()["tiles"])
    want = torch.from_numpy(record["jax_out"]).permute(0, 3, 1, 2)
    for dtype, tol in ((torch.float32, O_F32_TOL), (torch.bfloat16, GENERATOR_TOL[torch.bfloat16])):
        gen = create_generator("esrgan", dtype=dtype, device=device, **O_GEN)
        gen.load_state_dict(sd, strict=True)
        args = [a.to(device, dtype).contiguous(memory_format=torch.channels_last) for a in (x, elev, mask)]
        with torch.inference_mode():
            got = gen(*args).float().cpu()
        _, rel = rel_err(got, want)
        print(f"# O2 generator from the checkpoint on the record's 2 tiles, {str(dtype)[6:]}: relative err vs the "
              f"JAX output {rel:.3e} (tol {tol:g})")
        if not (rel <= tol):
            failed.append(f"O2 generator {dtype}")
    globe = root / "o_globe"
    globe.mkdir()
    make_globe(globe, O_MONTHS, *O_GLOBE_LR)
    gmin, gmax = -3.0, 25.0
    write_feather(Table({"dataset": ["cru-ts", "world-clim"], "variable": ["tmp", "tmp"],
                         "filename": ["tmp_2001-01.tif"] * 2, "min": [1.0, 0.0], "max": [20.0, 1.0],
                         "global_min": [gmin, 0.0], "global_max": [gmax, 1.0]}), globe / "min_max.feather")
    write_feather(Table({"variable": ["tmp"], "mean": [10.0], "std": [5.0]}), globe / "zscore.feather")
    common = [f"inference.pretrained_model={ckpt}", "inference.generator_type=esrgan",
              "inference.use_netcdf_datasets=true", f"inference.ds_path={globe / 'cru_ts4.05.1901.2020.tmp.dat.nc'}",
              f"inference.elevation_file={globe / 'elevation.tif'}", f"inference.land_mask_file={globe / 'land_mask.tif'}",
              f"inference.min_max_lookup={globe / 'min_max.feather'}", f"inference.zscore_lookup={globe / 'zscore.feather'}",
              "inference.cruts_variable=tmp", *[f"generator.{k}={v}" for k, v in O_GEN.items()]]

    def sweep(tag):
        inference_main(common + [f"inference.inference_out_path={root / f'o_sr_{tag}'}",
                                 f"inference.extent_out_path_sr_nc={root / f'o_nc_{tag}'}"], device=device)
        (nc,) = (root / f"o_nc_{tag}").glob("*.tmp.dat.nc")
        return read_climate_series(nc, "tmp").data

    zero_counts(counters)
    t = time.perf_counter()
    sr = sweep("kernel")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches["sweep"] = counts(counters)
    with plain_rdb():
        ref = sweep("plain")
    land = np.isfinite(ref)
    lr = read_climate_series(globe / "cru_ts4.05.1901.2020.tmp.dat.nc", "tmp").data
    half = (np.nanmax(lr, axis=(1, 2)) - np.nanmin(lr, axis=(1, 2))) / 2  # each month's own min-max scaling
    err = max(float(np.max(np.abs(sr[m][land[m]] - ref[m][land[m]]))) / half[m] for m in range(O_MONTHS))
    tol = 2 * MAX_ABS_ERR + GENERATOR_TOL[torch.bfloat16]
    print(f"# O2 cli.inference from the orbax directory: {O_MONTHS} months {O_GLOBE_LR} -> {sr.shape[1:]} in {wall:.3f} s "
          f"({O_MONTHS / wall:.4f} months/s, load and NetCDF included); worst normalized |kernel - plain| {err:.3e} "
          f"(tol {tol:.3e}); NaN pattern equal: {bool(np.array_equal(np.isnan(sr), ~land))}; launches "
          f"{launches['sweep']} ({card})")
    if sr.shape != (O_MONTHS, 4 * O_GLOBE_LR[0], 4 * O_GLOBE_LR[1]) or not (err <= tol) or not np.array_equal(np.isnan(sr), ~land):
        failed.append("O2 sweep")
    if device.type == "cuda" and launches["sweep"]["A"] <= 0:
        failed.append("O2 sweep: no A launch")

    # O3: the loaded state's f32 step on the record's batch, then cli.train resuming at the JAX step
    payload = load_checkpoint(ckpt, map_location=device)
    model = create_generator("esrgan", dtype=torch.float32, device=device, train=True, **O_GEN)
    model.load_state_dict({k[len("generator."):]: v for k, v in payload["state_dict"].items()}, strict=True)
    opt = build_optimizer(OptimizerConfig(name="sgd", lr=1e-4, weight_decay=0.0), lambda s: 1e-4, device=device)
    state = TrainState.create(model, opt)
    state.optimizer.load_state_dict(payload["optimizer_states"][0])
    step = make_pretrain_step(model, "esrgan", compute_dtype=torch.float32, device=device)
    batch = {k: torch.from_numpy(v).permute(0, 3, 1, 2).to(device).contiguous(memory_format=torch.channels_last)
             for k, v in o_record_inputs()["batch"].items()}
    _, metrics = step(state, batch)
    loss, want_loss = float(metrics["train/loss"]), float(record["loss"])
    print(f"# O3 f32 pre-training step from the checkpoint on the record's batch: loss {loss:.8f}, JAX {want_loss:.8f}, "
          f"relative err {abs(loss - want_loss) / abs(want_loss):.3e} (tol {O_F32_TOL:g})")
    if not (abs(loss - want_loss) <= O_F32_TOL * abs(want_loss)):
        failed.append("O3 loss")
    saved = int(payload["global_step"])
    r = fit_entry_point(device, root, "o_resume", [
        "experiment=esrgan_pre_training", f"datamodule.cfg.data_path={root / 'ds'}",
        *[f"generator.{k}={v}" for k, v in O_GEN.items()],
        "optimizers.generator_optimizer.name=sgd", "optimizers.generator_optimizer.weight_decay=0",
        f"trainer.resume_from_checkpoint={ckpt}", "trainer.max_epochs=1", "trainer.limit_train_batches=2",
        "trainer.limit_val_batches=1", "training.run_test_after_fit=false"], tables)
    launches["resume"] = r["launches"]
    steps = [int(x["step"]) for x in r["train"]]
    losses = [x["train/loss"] for x in r["train"]]
    print(f"# O3 cli.train resumed from the orbax directory at step {saved}: steps {steps}, train/loss "
          f"{['%.6f' % v for v in losses]}, Trainer at step {r['trainer'].global_step}, {r['wall']:.3f} s; launches "
          f"{r['launches']} ({card})")
    per_step = dict(B1=3 * O_GEN["nb"] * len(steps), B2=3 * O_GEN["nb"] * len(steps), C=len(steps))
    if steps != [saved + 1, saved + 2] or r["trainer"].global_step != saved + 2 or not np.isfinite(losses).all():
        failed.append("O3 resume")
    if device.type == "cuda" and any(r["launches"][k] != v for k, v in per_step.items()):
        failed.append(f"O3 resume: expected {per_step}, counted {r['launches']}")
    if failed:
        raise AssertionError(f"phase O: {failed}")
    return dict(read_s=read_s, mb_per_s=nbytes / 1e6 / read_s, launches={k: sum(v[k] for v in launches.values())
                                                                          for k in counters})


def du(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from climsr_tpu_torch.data.synthetic import make_synthetic_dataset
        from climsr_tpu_torch.ops import cuda_lib, head, head_bwd, rdb
    except ImportError as e:
        print(f"chip_smoke: the climsr_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda")

    # 1. environment
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"# python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"# card: {card}")

    # 2. build, one nvcc per library, all at once
    t0 = time.perf_counter()
    libs = cuda_lib.build({"climsr_rdb": rdb._SOURCES, "climsr_rdb_bwd": rdb._BWD_SOURCES,
                           "climsr_head_bwd": head_bwd._SOURCES, "climsr_hr_tail": head._SOURCES})
    print(f"# built {', '.join(p.name for p in libs.values())} in {time.perf_counter() - t0:.3f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"#   ptxas {name}: {line.strip()}")

    # 3. kernel A against its plain version, at the flagship and the reference-default growth widths
    kernel_a = phase_kernel(device, shapes=A_CHECKED, timed=((16, 128, 128), *EVAL_SHAPES))
    kernel_ref = phase_kernel(device, gc=GC_REF)[(16, 128, 128), False]
    phase_kernel(device, gc=48, shapes=((2, 45, 91),))

    # 4. the generator at the flagship widths and at the reference defaults
    phase_generator(device)
    phase_generator(device, nb=NB_REF, gc=GC_REF)

    # 5. end to end
    globe = phase_globe(device)
    expected = 3 * NB * 14  # 8 months x 28 tiles = 224 tiles = 14 calls of 16
    if globe["launches"] != expected:
        raise AssertionError(f"whole-globe sweep: expected {expected} RDB launches, counted {globe['launches']}")
    print(f"# globe sweep: {globe['months'] / globe['seconds']:.4f} months/s first sweep, "
          f"{globe['months'] / globe['warm_seconds']:.4f} months/s second sweep, "
          f"{globe['months'] / globe['plain_seconds']:.4f} months/s with the plain RDB ({card})")

    # 6. the training kernels against their plain versions
    train_kernels = phase_train_kernels(device)
    train_kernels_ref = phase_train_kernels(device, gc=GC_REF)
    phase_train_kernels(device, gc=48, shapes=((3, 29, 45),))
    train_kernels["conv9_dx_c0"] = phase_head_kernel(device)

    # 7. pre-training and an eval step at full width
    pretrain = phase_pretrain(device)
    print(f"# pre-training step, batch {TRAIN_N}: {pretrain['ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['ms'] * 1e3:.2f} samples/s) through the kernels, {pretrain['plain_ms']:.3f} ms/step "
          f"({TRAIN_N / pretrain['plain_ms'] * 1e3:.2f} samples/s) through the plain versions ({card})")

    # 8. kernels D, E, F against their plain versions; D's and E's own paths
    rdb_nhwc = phase_rdb_nhwc(device)
    rdb_nhwc_ref = phase_rdb_nhwc(device, gc=GC_REF)
    hr_tail = phase_hr_tail(device)
    phase_dc0(device)
    own = path_rdb_nhwc_and_hr_tail(device)

    # 9. the probe: F's own path
    probe = phase_probe(device)

    # 10. the GAN fine-tune and a val-loss call at full width
    gan = phase_gan(device)
    print(f"# GAN step, batch {TRAIN_N}: {gan['ms']:.3f} ms/step ({TRAIN_N / gan['ms'] * 1e3:.2f} samples/s) "
          f"through the kernels, {gan['plain_ms']:.3f} ms/step ({TRAIN_N / gan['plain_ms'] * 1e3:.2f} samples/s) "
          f"through the plain versions ({card})")

    # 11. pre-training at the reference defaults (nf=64, nb=23, gc=32)
    pre_ref = phase_pretrain(device, nb=NB_REF, gc=GC_REF, steps=REF_STEPS)
    print(f"# pre-training step nf={NF} nb={NB_REF} gc={GC_REF}, batch {TRAIN_N}: {pre_ref['ms']:.3f} ms/step "
          f"({TRAIN_N / pre_ref['ms'] * 1e3:.2f} samples/s) through the kernels, {pre_ref['plain_ms']:.3f} ms/step "
          f"({TRAIN_N / pre_ref['plain_ms'] * 1e3:.2f} samples/s) through the plain versions ({card})")
    # 12. the kernels at gc=32, beside gc=16's in the JSON line below
    for name, r in (("fused_rdb", kernel_ref), ("fused_rdb_fwd_save", train_kernels_ref["fused_rdb_fwd_save"]),
                    ("fused_rdb_bwd", train_kernels_ref["fused_rdb_bwd"]), ("fused_rdb_nhwc", rdb_nhwc_ref)):
        print(f"# {name} at gc={GC_REF}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3e} ({card})")

    # W. fault 1: the bf16 chain at nf other than 64, checked and timed; an nf=32 ESRGAN trains
    t = time.perf_counter()
    paths = {"W": phase_widths(device, card, {GC: kernel_a[(TRAIN_N, TRAIN_LR, TRAIN_LR), False]},
                               {GC: train_kernels, GC_REF: train_kernels_ref})["launches"]}
    seconds = {"W": time.perf_counter() - t}

    with tempfile.TemporaryDirectory(prefix="climsr_smoke_") as tmp:
        root = Path(tmp)
        # 13. the training entry point: composed config, data path, Trainer, checkpoints
        trainer = phase_trainer(device, pretrain["ms"], card, root)

        # A. the RCAN, DRLN and RFB-ESRGAN families at full width: card against CPU, bf16 against f32
        phase_families(device, card)
        # B. RCAN: pre-training, europe-extent fine-tuning, europe-extent inference, through the entry points
        t = time.perf_counter()
        eu_tables = make_synthetic_dataset(root / "eu", n_tiles_per_stage=EU_TILES, europe_extent=True, seed=1,
                                           write_index=False)
        print(f"# europe-extent synthetic set: {EU_TILES} frames of {EU_HR}x{EU_HR} per stage and variable, "
              f"{time.perf_counter() - t:.3f} s")
        phase_rcan(device, root, trainer["tables"], eu_tables, card)
        # C. the ESRGAN GAN fine-tune preset with its RFB-ESRGAN discriminator: kernels B1, B2, C and A
        phase_gan_preset(device, root, eu_tables, trainer["best_ckpt"], card)
        # D. DRLN and RFB-ESRGAN pre-training through the entry point
        phase_family_pretrain(device, root, card)

        # L, R, Q, H, P: the training entry point's services on phase 13's experiment and set
        services = {}
        for label, phase in (("L", phase_lr_find), ("R", phase_pruning), ("Q", phase_profilers),
                             ("H", phase_search), ("P", phase_batch_probe)):
            t = time.perf_counter()
            services[label] = phase(device, root, trainer["tables"], card)
            paths[label] = services[label]["launches"]
            seconds[label] = time.perf_counter() - t
        # X. the offline pipelines: data preparation -> training from files -> inference -> result inspection
        t = time.perf_counter()
        with recorded_shapes() as x_shapes:
            paths["X"] = phase_pipeline(device, root, card)["launches"]
        seconds["X"] = time.perf_counter() - t
        x_check_shapes(device, x_shapes)
        # M. the multi-rank code: 4 gloo ranks sharing the card
        t = time.perf_counter()
        paths["M"] = phase_multi(device, root, card, trainer, services["R"]["runs"])["launches"]
        seconds["M"] = time.perf_counter() - t
        # O. the JAX package's orbax checkpoint: read, swept, resumed
        t = time.perf_counter()
        with recorded_shapes() as o_shapes:
            paths["O"] = phase_orbax(device, root, trainer["tables"], card)["launches"]
        seconds["O"] = time.perf_counter() - t
        x_check_shapes(device, o_shapes, "O")
        print(f"# launches on each path of this slice, through the kernels (plain runs and checks not "
              f"counted): {json.dumps(paths)}")
        print(f"# seconds by phase of this slice: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    # 14. results
    # A, B1, B2 and C: their launches on this slice's main path, the training
    # entry point (phase 13); D, E, F run on no model path. A's numbers are per
    # launch over phase 13's: each eval batch of n tiles runs A on n x 64 x 32 x 32
    # twice without x0 and once with it in each of nb blocks
    kernel = launch_mean([kernel_a[(n, TRAIN_LR, TRAIN_LR), x0] for n in trainer["eval_sizes"]
                          for x0 in (False, False, True)])
    print(f"# fused_rdb per launch over phase 13's eval batches {trainer['eval_sizes']}: {kernel['ms']:.4f} ms, "
          f"plain {kernel['plain_ms']:.4f} ms, bound {kernel['bound_ms']:.4f} ms ({kernel['bound_by']}), "
          f"max_abs_err {kernel['max_abs_err']:.3e} ({card})")
    kernels = [dict(name="fused_rdb", route="cuda", source="climsr_tpu_torch/csrc/rdb_fwd.cu",
                    replaces="climsr_tpu/ops/pallas/rdb.py:190", launches=trainer["launches"]["A"], library_ms=None,
                    **kernel)]
    for name, label, source, replaces in (
        ("fused_rdb_fwd_save", "B1", "climsr_tpu_torch/csrc/rdb_fwd.cu", "climsr_tpu/ops/pallas/rdb.py:315"),
        ("fused_rdb_bwd", "B2", "climsr_tpu_torch/csrc/rdb_bwd.cu", "climsr_tpu/ops/pallas/rdb.py:432"),
        ("conv9_dx_c0", "C", "climsr_tpu_torch/csrc/conv9_dx_c0.cu", "climsr_tpu/ops/pallas/head_bwd.py:53"),
    ):
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=trainer["launches"][label], **train_kernels[name]))
    # D, E, F: their launches are their own paths' (phases 8, 9)
    kernels.append(dict(name="fused_rdb_nhwc", route="cuda", source="climsr_tpu_torch/csrc/rdb_fwd.cu",
                        replaces="climsr_tpu/ops/pallas/rdb.py:83", launches=own["fused_rdb_nhwc"], **rdb_nhwc))
    kernels.append(dict(name="fused_hr_tail", route="cuda", source="climsr_tpu_torch/csrc/hr_tail.cu",
                        replaces="climsr_tpu/ops/pallas/head.py:58", launches=own["fused_hr_tail"], **hr_tail))
    for name, line in (("dc0_flat", 48), ("dc0_dyfac", 68)):  # F1, F2: kernel C's source through F's entry
        kernels.append(dict(name=name, route="cuda", source="climsr_tpu_torch/csrc/conv9_dx_c0.cu",
                            replaces=f"scripts/bench_head_bwd_probe.py:{line}", **probe[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
