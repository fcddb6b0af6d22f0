#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``. It

1. reads the card (``torch.cuda`` and ``nvidia-smi``);
2. builds the FNO-layer kernels from ``blindno_torch/csrc`` with nvcc (one process per
   source, all at once; timed);
3. holds each kernel against its plain PyTorch version at the serving paths' shapes
   (in 1-D the gpe1d heads' and the ODE-observation NIO's head's among them, and the
   1-D training shapes at batch 32), a
   ragged one and, in 2-D, the ncfpe2d heads' and the NIOFNO2D inner branch's shapes on
   the fpe2d and the ncfpe2d grid, the heads' layer as tensor parallelism slices it
   (``TP_SLICE``: Cout 6 of 12) and the shapes that take the 2-D kernel's tiled layouts
   (``TILED_SHAPES``: grids of 200 and 232 points a side, a thin 16 x 3600 one, 192
   input channels, the heads padded to 183 x 183),
   and, after replaying the main layer for 0.2 s to bring the card to its clocks, times
   at the main shapes and the NIOFNO2D inner branch kernel, plain version and a
   ``torch.fft`` restatement on
   the device (each replayed from a CUDA graph, so host launch costs drop out; the
   kernel's replayed output is held against the plain version too), at every tiled shape
   the kernel and the restatement from smaller graphs, at the others the wrapper's
   host cost per call beside that of one ``torch.add`` on the same input, and the 2-D gelu
   layer's stages at the main shape in a ``torch.profiler`` trace; then each wrapper on
   bfloat16 and float16 operands at the training shapes, against its plain version on
   them raised to float32;
4. serves the fpe2d NIO model at the width of ``bench.py`` (seeded weights, calibrated
   BatchNorm) through ``predict_fields`` on 8 sets of 100 snapshots of a 61x61 grid,
   counts the kernel launches, checks the result against the CPU plain path, and times
   it; then drives the served heads' ``SpectralConv2d`` modules (the 2-D spectral-conv
   kernel) on the lifted fields of one batch and checks them against the CPU;
5. serves the fpe1d NIO models (``NIOFP1D`` and the FNO-branch ``NIOFNO1D`` at the
   suite's width) the same way on 64 sets of 100 snapshots of 80 points, batch 16, and
   drives the ``NIOFP1D`` heads' ``SpectralConv1d`` modules (the 1-D spectral-conv
   kernel) on one batch; then serves the gpe1d NIO (``NIOFP1D`` at the GPE suite's
   width) on 64 sets of 101 snapshots of 128 points;
6. serves the BlinDNO UNet (``PermInvUNetAttn``, randomized LayerNorms, calibrated
   BatchNorms) the same way: the fpe2d suite's UNet on the fpe2d NIO's sets, the gpe1d
   suite's 1-D UNet on the gpe1d NIO's, and the ncfpe2d suite's plain-block UNet on 4 sets
   of 100 snapshots of 80x80; each forward split between the set encoder and the heads,
   on the device (eager and from CUDA graphs, its top kernels in a profiler trace) and
   on the host;
7. serves the FNO-branch and token-attention NIOs (phase ``serve_nio2d``) the same way:
   the fpe2d suite's ``NIOFNO2D``, ``NIOAttn2D`` and ``NIOFNOAttn2D`` on 8 sets of 100
   snapshots of 61x61 and the ncfpe2d suite's ``NIOFNO2D`` on 4 sets of 80x80, each
   forward split on the device between the per-snapshot fields (but ``NIOAttn2D``'s),
   the attention, the fusion and the heads; then (phase ``serve3d``) the 3-D NIO
   ``NIOFP3D`` at its defaults on 4 sets of 100 snapshots of a 40^3 grid, batch 2 (no
   kernel of the port on its path: FNO3d's spectral convolution is the einsum chain, as
   in JAX), against the CPU on the
   first set cut to 8 snapshots, its forwards per second, peak memory and forward split
   on the device between the encoder, the trunk, the fusion and the FNO3d head, and
   three float32 training steps with finite losses; and the ODE-observation NIO
   ``NIOFPOde`` at its defaults on 16 sets of 100 x 11 observations with a grid of 100
   points, its FNO1d head's ``fno1d_layer`` launched exactly 3 times a forward, every
   call at (16, 30, 125) with 15 modes, against the CPU;
8. trains the fpe2d NIO at the ``bench.py`` config (4 sets of 100 snapshots of 61x61):
   one float32 step on the card against the same step on the CPU plain path (same
   seeded weights, batch and injected set subsample), its launches counted; a bfloat16
   ``encoder_bn32`` step from the same weights; a float16 ``encoder_bn32`` step from
   them too, its 6 launches counted, its loss and heads' gradients held to the card's
   float32 step, 10 timed float16 steps whose loss must fall
   (:func:`low_precision_steps`); ten float32 steps on one batch with fresh draws, whose
   loss must fall, timed; the step's split, the FNO2d layer's backward per call, the
   BatchNorm correction's cost and the peak memory;
9. trains the fpe2d suite's UNet on the same batch (phase ``train_unet``): one float32
   step on the card against the CPU, its exact zero gradients exact; ten timed steps
   whose loss must fall; a bfloat16 step under JAX's default policy ``all`` from the
   same weights (the UNet in bfloat16 end to end, its heads' kernels inside the cast), 6
   launches counted, its loss and heads' gradients held to the card's float32 step, 10
   timed bfloat16 steps whose loss must fall; the step's split on the device and the
   host and its peak memory (its top kernels: phase ``epoch_scan``); then the fpe2d
   suite's ``NIOFNO2D`` the same way (phase ``train_fno``, 8 launches a step in float32
   and in bfloat16 ``all``, every bfloat16 gradient held, the frozen fusion unchanged),
   with the FNO2d layer's torch backward timed at the inner shape;
10. trains and evaluates the fpe2d NIO through the port's suites CLI at the suite's own
   config (phase ``fit``): a synthetic archive of 80 sets of 100 snapshots of 61x61 in
   the JAX datagen's format (numpy seed 0) under a temporary workdir, 2 epochs of
   ``--stage train`` (64 train sets, 4 steps of batch 16 an epoch, d4 augmentation,
   bfloat16 input storage), a resumed third epoch whose restored state must equal the
   saved one bit for bit, and ``--stage eval`` with its symmetry test-time average; the
   launches counted exactly, every loss finite, after each training stage its checkpoints
   in the JAX package's formats (an orbax ``best_*`` directory and ``resume.msgpack``)
   read back by the port's reader bit for bit against the trained state, 4 test
   predictions held against the CPU plain path on the same checkpoint; the loop's
   steps per second beside bare ``train_step``'s on one batch of 16, the epoch wall
   time, the eval with and without the average, the checkpoint saves, each writer's
   seconds beside ``torch.save`` of the same state, and peak memory;
   then the same for the suite's UNet (``--model unet``): one epoch and the eval stage,
   launches counted exactly, no host synchronization in a step, predictions against the
   CPU; then the ncfpe2d suite at its own config (batch 4, ``c4_vector``) on a
   synthetic archive of 20 sets of 100 snapshots of 80x80, its ``NIOFNO2D`` and its
   plain-block UNet each for one epoch and the eval stage, checked the same way; then
   (phase ``epoch_scan``) the fpe2d suite's UNet through ``train_model`` with
   ``epoch_scan=True``, each epoch one CUDA graph of the step replayed once a step
   (``blindno_torch/train/scan.py``), against ``epoch_scan=False`` on the same archive
   from the same weights and seed: 2 float32 epochs and one bfloat16 ``all`` epoch,
   history and final state within bounds, every run's ``fno2d_layer`` executions exact,
   one replayed epoch under ``torch.cuda.set_sync_debug_mode("error")`` and traced (3
   stage kernels a layer call); and at ``bench.py``'s batch 10 replayed steps beside 10
   eager ones (steps/s, the host's ms a step, the device's busy ms);
11. trains the fpe1d suite's NIOFP1D, NIOFNO1D and BlinDNO UNet at full width on the
   suite's batch of 32 sets of 100 snapshots of 80 points (phase ``train1d``): for each
   one float32 step on the card against the CPU (the FNO1d layer's kernel forward in
   ``FNO1dLinear``, its launches counted exactly: 6, 8 and 6), ten timed steps whose
   loss must fall, the step's split and the host's enqueue against the device's busy
   time, peak memory; for NIOFNO1D also a bfloat16 ``all`` step from the same weights
   (8 launches, at (32, 30, 100) and (3200, 4, 100), every gradient held to the card's
   float32 step), 10 timed whose loss must fall; then an A/B of three layers trained
   with Adam writing their weights right before each call, kernel against plain version,
   and the layer's torch backward at the training shapes;
12. trains and evaluates the 1-D suites through the CLI at their own configs (phase
   ``fit1d``) on synthetic archives in the datagen's format (320 sets and 16 test sets):
   the fpe1d NIO for an epoch and a resumed one, the gpe1d UNet for an epoch, each then
   the eval stage; launches exact, no host synchronization in a step, predictions with
   and without the flip average against the CPU; then ``train_model`` of the fpe1d
   UNet for 2 epochs with ``compute_dtype="bfloat16"`` under JAX's default policy
   ``all``, its launches exact, its losses finite and falling;
13. trains NIOFP2D data- and tensor-parallel (phase ``parallel``): phase 8's step in
   ranks spawned on the card (``blindno_torch.parallel``), one rank over NCCL through
   the DDP path bit for bit against the single-process step, two ranks over gloo (DP 2)
   and four over gloo (a 2 x 2 mesh, tp=2: each rank's ``fno2d_layer`` launches 6 a
   step at the sliced shape, Cout 6 of 12) within phase 8's tolerances, and two ranks
   over NCCL on two cards where the host has them; each case's steps per second and
   wall time; the sliced layer is timed in phase 3; then the fpe2d suite's UNet through
   ``train_model(epoch_scan=True)`` on ``fit``'s archive in one NCCL rank (case ``e``):
   DDP's step captured in a CUDA graph with its all-reduce, 4 epochs, the last replayed
   whole under ``torch.cuda.set_sync_debug_mode("error")``, bit for bit a one-process
   ``epoch_scan`` run, its ``fno2d_layer`` executions exact, its replayed steps/s and
   host ms a step beside the one-process run's; and (case ``f``) DP 2 over NCCL on two
   cards where the host has them; then (case ``g``) ``train_model`` of NIOFP2D at the
   ``bench.py`` config and batch of 4 for an epoch of ``fit``'s archive on 3 gloo ranks,
   whose data axis of 2 leaves rank 2 idle (JAX's ``data_mesh`` rule): every rank's result
   bit for bit the same run's on 2 ranks, 6 ``fno2d_layer`` launches a step and eval batch
   on ranks 0 and 1 and none on rank 2, against the one-process run; and (case ``h``)
   the same with ``epoch_scan`` over NCCL on three cards where the host has them;
14. serves and trains ``NIOFP2D`` at the ``bench.py`` config with ``padding_frac=2.0``
   on its FNO2d heads (phase ``padded``: each layer at (4, 12, 183, 183), past what one
   block holds, so the kernel's first stage takes its tiled layout): served through
   ``predict_fields`` on 4 sets of 100 snapshots of 61x61, 6 launches a forward, the
   first set against the CPU, then one float32 step on the first set of ``bench.py``'s batch against the
   CPU's step, 6 launches;
15. serves and trains the Transolver NIOs (phase ``trans``): the fpe2d suite's
   ``NIOTrans2D`` and ``NIOTransAttn2D`` (Transolver weights drawn at random) through
   ``predict_fields`` on 8 sets of 100 snapshots of 61x61, batch 4, against the CPU,
   timed and split on the device between the attention, the fusion and the heads, with
   peak memory; one float32 step of each on the first set of
   ``bench.py``'s batch against the CPU's step, 6 ``fno2d_layer`` launches a forward or
   step counted exactly, and ten timed steps on the whole batch whose loss must fall;
16. reads every committed JAX checkpoint (``runs/ckpt/*/best_*``, orbax's OCDBT
   directories) with the port's own reader, without JAX (phase ``jax_ckpt``): arrays, MB
   and seconds, the CPU workers stopped while it reads (``libzstd.so.1`` loaded first);
   writes each tree with the port's writer and reads it back, bit for bit the tree read,
   timed with the workers still stopped; then loads each strictly into its port model on the card and serves one seeded batch
   through ``predict_fields`` (2 sets of 100 snapshots on the 2-D grids, 16 on the 1-D
   ones), its ``fno2d_layer`` or ``fno1d_layer`` launches counted exactly,
   each field within 2e-3 of its scale from the same weights on the CPU;
17. generates every FPE and GPE suite's archives through the CLI (phase ``datagen``) at
   each suite's full grid and time axis and a few sets (48 fpe1d, 64 gpe1d, 8 fpe2d, 2
   ncfpe2d), with TF32 on for matrix products, timed per set: the parameters equal to a
   CPU run's bit for bit, the trajectories within 1e-3 of the CPU's on the first set (of
   a float64 run on the card for ncfpe2d, every set), the FPE masses at 1; then the
   eval and time-error stages through the CLI on copies of the committed fpe1d NIO and
   gpe1d FNO-branch NIO directories (JAX's) on those archives, the time-error stage on
   one fpe2d sample of an untrained ``NIOTrans2D``, each against the CPU's predictions
   and errors; and one ``--stage train`` epoch of each of the two warm-restarted from its
   committed directory (the fpe1d NIO's epoch 401 from JAX's 400, the gpe1d FNO's 391
   from 390, with JAX's best loss, Adam's step advanced, the directory kept or replaced
   by ``save_best``'s rule), its ``best_*`` and ``resume.msgpack`` read back bit for bit
   against the trained state and the state read back served on the card against the
   CPU;
18. prints one JSON line per phase, the nvidia-smi line, the kernels line, and last
   ``{"ok": true, "device": {...}}``.

Every path runs with all four kernels' launch counts set to 0 just before it and read
just after. Any failed check raises, and the script exits non-zero without the last
line. TF32 is off for matmul and cuDNN throughout, so every comparison is in full
float32, except around the datagen stage, where the solver must turn it off itself.

The script reads ``runs/`` and writes nothing there: phase ``datagen`` works on copies
in a temporary workdir.

The CPU references of phases 14 to 17, and phase 8's CPU step (queued first, and waited
for at the build's end), run in CPU_WORKERS worker processes, started before the build
on the cores it leaves idle and stopped (SIGSTOP) from the build's end until after phase
13, and again while phase 16 reads the checkpoints: phases 3 to 13 and that read run
with no other process of this script running but phase 13's ranks.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import gc
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

KERNEL_TOL = 3e-4   # the 2-D Pallas kernels' tolerance, tests/test_spectral_pallas.py:47,67
KERNEL_TOL_1D = 2e-4  # the 1-D Pallas kernels' tolerance, tests/test_spectral_pallas.py:34,59
SERVE_TOL = 2e-3    # the NIO parity tolerance, tests/test_nio2d_torch_parity.py:190
# the training step against the CPU, relative L2 per tensor as tests/test_torch_train.py
# holds the port to JAX: 2e-3, and 1e-2 for the Encoder2D's gradients, below ten leaky
# ReLU kinks, and for its parameters after the step (its BatchNorm biases start at zero,
# so after one step they are Adam's update lr * g / (|g| + eps) itself, whose error
# follows the gradient's where |g| is not far above eps); the bf16 step's loss within
# 5e-2 of the f32 step's
TRAIN_TOL, ENCODER_TOL, BF16_LOSS_TOL = 2e-3, 1e-2, 5e-2
TRAIN_STEPS = 10
# the low-precision steps against the card's own float32 step from the same state, set
# from the CPU tests' gaps between JAX's bfloat16 (or float16) and float32 steps at small
# widths (tests/test_torch_amp.py): outside the conv encoders and the UNet's conv stack,
# JAX's bf16 step lies at most 4.4e-2 from its f32 one in a gradient (the 1-D UNet's
# heads under "all"; 1.7-2.5e-2 for the FNO-branch models and the 2-D UNet) and 4.2e-4
# in the loss; its f16 encoder_bn32 step of NIOFP2D 2.3e-3 in the heads' gradients and
# 7.3e-6 in the loss. The bounds are about 2-4x those: a gradient is held where its norm
# is at least 1e-3 of the largest one's (b0's, which cancels, and the conv biases before
# a BatchNorm are rounding). LOW_STEPS steps from the same state, timed, must bring the
# loss down
LOW_LOSS_TOL = {"bfloat16": 2e-3, "float16": 1e-4}
LOW_GRAD_TOL = {"bfloat16": 1e-1, "float16": 1e-2}
LOW_STEPS = 10
MAIN_SHAPE = (4, 12, 76, 76, 32, 32)   # (B, C, H, W, m1, m2) of the serving path's layers
RAGGED_SHAPE = (3, 5, 40, 36, 7, 9)
FIT_SHAPE = (16, 12, 76, 76, 32, 32)   # the layers of the fpe2d suite's batch of 16
# the ncfpe2d heads (blindno/suites/registry.py:233: an 80x80 grid padded by a quarter),
# and the NIOFNO2D inner FNO2d over B*L = 4 x 100 snapshots (blindno/models/nio2d.py:74-86)
NCFPE2D_HEADS = (4, 12, 100, 100, 32, 32)
NIOFNO2D_INNER = (400, 4, 76, 76, 12, 12)
# the same inner FNO2d on the ncfpe2d suite's 80x80 grid, padded to 100x100
NCFPE2D_INNER = (400, 4, 100, 100, 12, 12)
# shapes whose stages take the 2-D kernel's tiled layouts (csrc/fno2d_layer.cu): a
# 200x200 grid at 64x64 modes; the largest grid with every mode kept that the two-stage
# kernel before took; a thin grid; 192 input channels into 12 at B=2, and at B=4, where
# S2 takes its weights in channel chunks; and the fpe2d heads with padding_frac=2.0,
# 61 + 2 x 61 = 183 points a side
PADDED_HEADS = (4, 12, 183, 183, 32, 32)
TILED_SHAPES = [(1, 1, 200, 200, 64, 64), (1, 2, 232, 232, 116, 117), (2, 3, 16, 3600, 8, 40),
                (2, 192, 76, 76, 32, 32, 12), (4, 192, 76, 76, 32, 32, 12), PADDED_HEADS]
# (B, C, H, W, m1, m2, Cout): the heads' layer sliced for tensor parallelism, as phase
# parallel's 2 x 2 mesh runs it: 2 of bench.py's 4 sets a data rank, 6 of 12 output
# channels a model rank
TP_SLICE = (2, 12, 76, 76, 32, 32, 6)
# 1-D (B, C, N, modes, dc_half): the fpe1d heads' layers at batch 16, the FNO-branch
# model's inner FNO1d over 16 x 100 snapshots, the gpe1d NIO heads (width 20, 40 modes,
# 128 points padded to 160; blindno/suites/registry.py:139-141), and a ragged shape
# without DC halving
HEADS_1D = (16, 30, 100, 15, True)
BRANCH_1D = (1600, 4, 100, 12, True)
GPE_HEADS_1D = (16, 20, 160, 40, True)
RAGGED_1D = (3, 5, 37, 7, False)
# the ODE-observation NIO's head (NIOFPOde: width 30, 15 modes, a grid of 100 points
# padded by a quarter to 125, an odd N) at the serving batch of 16
ODE_HEADS_1D = (16, 30, 125, 15, True)
# H100 SXM published peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores, HBM3
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12
SERVE = dict(m=8, l=100, n=61, batch=4, timed_rounds=5)
# phase padded: NIOFP2D at bench.py's config with padding_frac=2.0 on both FNO2d heads
# (each layer at PADDED_HEADS), served on one batch of 4 sets and stepped once on
# bench.py's batch, the first PADDED_CHECK_SETS sets of each against the CPU's run in
# the cpu_pool workers (a set takes the card host's CPU 1.5 s to serve, 7 s to step)
PADDING_FRAC = 2.0
PADDED = dict(m=4, l=100, n=61, batch=4)
PADDED_CHECK_SETS = 1
MODEL = dict(width=12, modes=32, n_basis=25, neurons=100, fno_layers=3)
# fpe1d (blindno/suites/registry.py:88-90): 64 sets in batches of 16, the JAX
# predict_fields default
SERVE_1D = dict(m=64, l=100, n=80, batch=16, timed_rounds=3)
MODEL_1D = dict(width=30, modes=15)
# gpe1d (blindno/suites/registry.py:132-141): 101 snapshots of 128 points a set
SERVE_GPE = dict(m=64, l=101, n=128, batch=16, timed_rounds=3)
MODEL_GPE = dict(width=20, modes=40, head_dims=(1,))
# the BlinDNO UNet (PermInvUNetAttn): the fpe2d suite's (blindno/suites/registry.py:196-198,
# bench_train.UNET_CONFIG) on SERVE's sets; the gpe1d suite's (:148-150) on SERVE_GPE's;
# the ncfpe2d suite's plain-block UNet (:235-238) on 4 sets of 100 snapshots of 80x80 at
# that suite's batch of 4, whose heads run fno2d_layer at NCFPE2D_HEADS
MODEL_UNET_GPE = dict(input_size=(128,), depth=4, width=20, fno_modes=40, head_dims=(1,),
                      subsample=True)
MODEL_UNET_NC = dict(input_size=(80, 80), depth=5, width=12, fno_modes=32, head_dims=(1, 1),
                     subsample=True, block="plain")
SERVE_UNET_NC = dict(m=4, l=100, n=80, batch=4, timed_rounds=3)
# phase serve3d: NIOFP3D at its defaults (blindno/models/nio3d.py:29-36: width 12, 8
# modes, 25 basis functions, 100 neurons) on 4 sets of 100 snapshots of 40^3, the grid
# Encoder3D's schedule collapses to one point, at batch 2; the CPU reference on the
# first set cut to 8 snapshots; three float32 training steps on one batch. Then NIOFPOde
# at its defaults (blindno/models/nio1d.py:61-87) on 16 sets of 100 x 11 observations
# with a grid of 100 points, batch 16: 3 fno1d_layer launches a forward at ODE_HEADS_1D
SERVE_3D = dict(m=4, l=100, n=40, batch=2, timed_rounds=3, cpu_snapshots=8, train_steps=3)
SERVE_ODE = dict(m=16, l=100, n_obs=11, n=100, batch=16, timed_rounds=3)
# phase fit: the fpe2d suite's config (blindno/suites/registry.py:186-220) on a synthetic
# archive; 80 sets split 64/16, 4 steps of 16 an epoch; a test archive of 16 sets
FIT = dict(m=80, m_test=16, l=100, n=61, epochs=2, cpu_sets=4, bare_steps=10, unet_epochs=1)
# phase fit, ncfpe2d: that suite's config (blindno/suites/registry.py:222-253: batch 4,
# c4_vector, float32 inputs) on a synthetic archive of 20 sets of 100 snapshots of 80x80,
# split 16/4 (4 steps an epoch), and 8 test sets; one epoch each of the FNO-branch NIO
# and the plain-block UNet
FIT_NC = dict(m=20, m_test=8, l=100, n=80, epochs=1)
# phase train1d: the fpe1d suite's models (blindno/suites/registry.py:77-107) at full width
# on its training batch (bench_train.BATCHES_1D: 32 sets of 100 snapshots of 80 points);
# fno1d_layer launches a step, which the phase also derives from the models' FNO1d
# modules: 3 layers in each of the 2 heads, and NIOFNO1D's 2 inner layers
TRAIN_1D = {"nio": 6, "fno": 8, "unet": 6}
# the 1-D layers at the suites' training batch of 32: the fpe1d heads, the FNO-branch
# model's inner FNO1d over 32 x 100 snapshots, and the gpe1d heads
TRAIN_HEADS_1D = (32, 30, 100, 15, True)
TRAIN_BRANCH_1D = (3200, 4, 100, 12, True)
TRAIN_GPE_HEADS_1D = (32, 20, 160, 40, True)
# phase fit1d: the fpe1d NIO (an epoch and a resumed one) and the gpe1d UNet (an epoch)
# through the CLI on synthetic archives in the datagen's format, 320 sets split 256/64
# (8 steps of 32 an epoch) and 16 test sets each
FIT_1D = dict(m=320, m_test=16, epochs=1)
# and the fpe1d UNet through train_model in bfloat16 "all" for two epochs on such sets
FIT_1D_BF16 = dict(epochs=2)
# phase datagen: (train, test) sets per suite, each suite's full grid and time axis
# (blindno/data/generate.py); the card's archives against the CPU's (or float64) within
# DATAGEN_TOL relative L2 per set, the FPE masses within DATAGEN_MASS_TOL of 1, the
# time-error stage's errors within TIME_ERROR_TOL of the CPU's, relative
DATAGEN = {"fpe1d": (48, 8), "gpe1d": (64, 16), "fpe2d": (8, 2), "ncfpe2d": (2, 1)}
DATAGEN_TOL, DATAGEN_MASS_TOL, TIME_ERROR_TOL = 1e-3, 1e-3, 1e-3
# phase datagen's committed checkpoints (JAX's orbax directories, copied): the eval and
# time-error stages on the fpe1d NIO and the gpe1d FNO-branch NIO, and a warm restart of
# each for one epoch past its own
DATAGEN_CKPTS = (("fpe1d", "nio"), ("gpe1d", "fno"))
# phase jax_ckpt: every committed runs/ckpt/{name}/best_* served on one seeded batch of sets
# of its suite's grid, (sets, snapshots) by the rank of the grid, against the CPU
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "ckpt")
JAX_CKPT_SETS = {2: (2, 100), 1: (16, 100)}
# the committed directories: the registry's {suite}_{model} ones, and the fpe1d NIO and
# the fpe2d UNet variants at the registry's widths
JAX_CKPT_MODELS = ("fpe1d_fno", "fpe1d_nio", "fpe1d_unet", "fpe2d_nio", "fpe2d_unet",
                   "gpe1d_fno", "gpe1d_nio", "gpe1d_unet", "gpe1d_vgk_nio", "ncfpe2d_fno",
                   "ncfpe2d_unet", "schrodinger1d_fno", "schrodinger1d_nio",
                   "schrodinger1d_unet")
JAX_CKPT_VARIANTS = {"fpe1d_nio_bf16val": ("fpe1d", "nio"),
                     "fpe1d_nio_bf16val_bn32": ("fpe1d", "nio"),
                     "fpe1d_nio_bf16val_enc": ("fpe1d", "nio"),
                     "fpe2d_unet_leakdemo": ("fpe2d", "unet")}


def counted(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before; return the
    counts just after, and ``fn``'s result."""
    from blindno_torch.parallel import dryrun

    wrappers = dryrun.kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    result = fn()
    return {name: w.launches for name, w in wrappers.items()}, result


def expect_launches(path, counts, **want):
    """Raise unless ``path`` launched each named kernel the wanted number of times and
    every other kernel never."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise RuntimeError(f"{path} launched {counts}, want {full}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check_close(what, got, want, tol, scale=1.0):
    """Raise unless ``got`` is finite and within rtol ``tol``, atol ``tol * scale``."""
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol * scale) or not torch.isfinite(got).all():
        raise RuntimeError(f"{what}: disagrees with its reference, max_abs_err {err:.3g} "
                           f"against rtol {tol}, atol {tol * scale:.3g}")
    return err


def time_ms(fn, iters, host=False):
    """Mean time of one call, by CUDA events over ``iters`` eager calls after warm-up.
    With ``host``, also the host's time to enqueue one call: where the two are equal,
    the loop was bound by the launches and not by the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    end.record()
    end.synchronize()
    device_ms = start.elapsed_time(end) / iters
    return (device_ms, host_ms) if host else device_ms


def graph_ms(fn, calls=20, replays=10, result=False):
    """Device time of one call: ``calls`` calls captured in one CUDA graph, replayed
    ``replays`` times and timed by CUDA events, so no host launch cost is in the figure.
    Inputs stay in L2 between calls, as a layer's input does on the serving path. With
    ``result``, also the last call's output after the last replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # no garbage collection between the events: collecting an earlier graph frees its
    # memory pool, and that cudaFree would hold the host while the device ran dry
    collecting = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
    finally:
        if collecting:
            gc.enable()
    ms = start.elapsed_time(end) / (calls * replays)
    return (ms, out) if result else ms


def stage_ms(fn, iters=20):
    """Mean device time per call of each CUDA kernel that ``fn`` launches, from a
    ``torch.profiler`` trace; empty where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    short = lambda key: (re.search(r"(\w+(<\d+>)?)\(", key) or [key, key])[1]
    return {short(e.key): e.device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_time_total > 0}


def fft_flops(n, real):
    """Operations of an n-point FFT by the usual count, 5 n log2 n (half for real data)."""
    return (2.5 if real else 5.0) * n * math.log2(n)


def layer_bound(shape, epilogue):
    """Least time for one layer call, 1-D shape (B, C, N, modes) or 2-D shape
    (B, C, H, W, m1, m2[, Cout]): the larger of its bytes (inputs read once, output
    written once) over the memory rate and the least operations that compute it over the
    f32 peak. The least operations do the truncated transforms as FFTs: the kernels'
    dense DFT products (``mflop_dense_dft``, reported beside) are their own algorithm,
    not what the function needs. The forward transforms run over the C input channels,
    the inverse ones over the Cout output channels."""
    if len(shape) == 4:
        b, c, n, m = shape
        o = c
        dense = b * c * n * m * 4 + b * c * c * m * 8 + b * c * m * n * 4
        least = 2 * b * c * fft_flops(n, True) + b * c * c * m * 8
        floats = 2 * b * c * n + 2 * c * c * m
        points = b * c * n
    else:
        b, c, h, w, m1, m2 = shape[:6]
        o = shape[6] if len(shape) > 6 else c
        k = 2 * m1
        dense = (b * c * h * m2 * w * 4 + b * c * k * m2 * h * 8 + b * c * o * k * m2 * 8
                 + b * o * h * m2 * k * 8 + b * o * h * w * m2 * 4)
        least = (b * (c + o) * h * fft_flops(w, True) + b * (c + o) * m2 * fft_flops(h, False)
                 + b * c * o * k * m2 * 8)
        floats = b * (c + o) * h * w + 2 * c * o * k * m2
        points = b * o * h * w
    if epilogue:
        pointwise = points * (2 * c + 1)
        dense += pointwise
        least += pointwise
        floats += c * o + o
    t_ops, t_bytes = least / PEAK_F32_FLOP_S, 4 * floats / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_bytes_ms=1e3 * t_bytes, bound_ops_ms=1e3 * t_ops,
                mflop_least=least / 1e6, mflop_dense_dft=dense / 1e6, mbytes=4 * floats / 1e6)


def layer_backward_bound(shape):
    """Least time for one call of the layer's backward at the 2-D shape (B, C, H, W, m1,
    m2) or the 1-D shape (B, C, N, modes), as :func:`layer_bound` reckons the forward:
    its bytes (x, du and the weights read, dx and the weight gradients written) over the
    memory rate, and its least operations (x's and du's truncated transforms, dx's
    inverse, as FFTs; the two mode mixes; the two pointwise products) over the f32
    peak."""
    if len(shape) == 4:
        b, c, n, m = shape
        transform, points, planes = 2 * b * c * fft_flops(n, True), b * c * n, c * c * m
    else:
        b, c, h, w, m1, m2 = shape
        transform = 2 * b * c * h * fft_flops(w, True) + 2 * b * c * m2 * fft_flops(h, False)
        points, planes = b * c * h * w, c * c * 2 * m1 * m2
    least = 3 * transform + 2 * b * planes * 8 + 2 * 2 * c * points
    floats = 3 * points + 4 * planes + 2 * (c * c + c)
    t_ops, t_bytes = least / PEAK_F32_FLOP_S, 4 * floats / PEAK_BYTES_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_bytes_ms=1e3 * t_bytes, bound_ops_ms=1e3 * t_ops, mbytes=4 * floats / 1e6)


def layer_inputs(shape, device):
    """Seeded layer inputs: (x, wr, wi, pk, pb) in 2-D, and dc_half after them in 1-D."""
    rng = np.random.default_rng(0)
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
    if len(shape) == 5:
        b, c, n, m, dc_half = shape
        return t(b, c, n), t(c, c, m), t(c, c, m), t(c, c), t(c), dc_half
    b, c, h, w, m1, m2 = shape[:6]
    o = shape[6] if len(shape) > 6 else c  # Cout
    return t(b, c, h, w), t(c, o, 2 * m1, m2), t(c, o, 2 * m1, m2), t(c, o), t(o)


def warm_up(fn, seconds=0.2):
    """Replay ``fn`` from a CUDA graph for about ``seconds``, so that the first timed row
    finds the card at its working clocks (without it, a run's first timing has read up
    to 40% high: PERF.md section 7)."""
    ms = graph_ms(fn)
    graph_ms(fn, replays=max(1, int(1e3 * seconds / (20 * ms))))
    gc.collect()  # the graphs' memory pools go now, not during a timed row
    torch.cuda.synchronize()


# a case timed from small CUDA graphs alone: the kernel and the library call, for the
# layer with gelu and the spectral conv (not the layer without gelu, nor the plain version
# or the host's cost), which keeps the tiled shapes' rows inside the script's budget
GRAPH_ONLY = "graph"


def check_and_time(cases, variants, library, tol, stats):
    """Hold each variant against its plain version at each (shape, timed, main) case;
    at a timed case also time kernel, plain version and library call, the kernel's eager
    calls and the wrapper's host cost (a GRAPH_ONLY case: see there). ``stats`` keeps
    each kernel's largest error and the gelu variant's numbers at its main shape."""
    for shape, timed, main in cases:
        args = layer_inputs(shape, "cuda")
        bound_shape = shape[:4] if len(shape) == 5 else shape
        for name, act, kernel, plain in variants:
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            err = check_close(f"{name} act={act} {shape}", got, want, tol)
            row = dict(kernel=name, gelu=act, shape=shape, max_abs_err=err, tol=tol)
            if timed == GRAPH_ONLY and act is not False:
                lib_fn = library[name]
                check_close(f"{name} fft restatement", lib_fn(*args, act), want, tol)
                kernel_ms, replayed = graph_ms(lambda: kernel(*args), 5, 4, result=True)
                row.update(max_abs_err_graph=check_close(f"{name} act={act} {shape} replayed",
                                                         replayed, want, tol),
                           kernel_ms=kernel_ms,
                           library_ms=graph_ms(lambda: lib_fn(*args, act), 5, 4),
                           **layer_bound(bound_shape, act is not None))
            elif timed is True:
                lib_fn = library[name]
                check_close(f"{name} fft restatement", lib_fn(*args, act), want, tol)
                eager_ms, host_ms = time_ms(lambda: kernel(*args), 200, host=True)
                # the host's cost of one plain PyTorch call, as a yardstick beside it
                op_host_ms = time_ms(lambda: torch.add(args[0], 1.0), 200, host=True)[1]
                # the kernels' launches replayed from a graph hold to the plain version too
                kernel_ms, replayed = graph_ms(lambda: kernel(*args), result=True)
                row.update(max_abs_err_graph=check_close(f"{name} act={act} {shape} replayed",
                                                         replayed, want, tol))
                row.update(kernel_ms=kernel_ms,
                           plain_ms=graph_ms(lambda: plain(*args)),
                           library_ms=graph_ms(lambda: lib_fn(*args, act)),
                           eager_kernel_ms=eager_ms, wrapper_host_ms=host_ms,
                           torch_add_host_ms=op_host_ms,
                           **layer_bound(bound_shape, act is not None))
                if shape == MAIN_SHAPE and act:  # the 2-D gelu layer's stages
                    row["stages_ms"] = stage_ms(lambda: kernel(*args))
            emit("kernels", **row)
            s = stats.setdefault(name, {"max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], err, row.get("max_abs_err_graph", 0.0))
            if main and act is not False:  # the gelu variant: all but the last layer
                s.update({k: row[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")})


def fft_restatements():
    """Each kernel's function in ``torch.fft`` calls (its ``library_ms`` yardstick),
    called with the kernel's inputs (:func:`layer_inputs`) and its activation flag."""
    from blindno_torch.ops.spectral import spectral_conv1d_fft, spectral_conv2d_fft

    gelu = torch.nn.functional.gelu
    act_fn = lambda act: gelu if act else (lambda y: y)
    return {
        "fno2d_layer": lambda x, wr, wi, pk, pb, act: act_fn(act)(
            spectral_conv2d_fft(x, wr, wi) + torch.einsum("bchw,co->bohw", x, pk)
            + pb.reshape(1, -1, 1, 1)),
        "spectral_conv2d": lambda x, wr, wi, pk, pb, act: spectral_conv2d_fft(x, wr, wi),
        "fno1d_layer": lambda x, wr, wi, pk, pb, dc, act: act_fn(act)(
            spectral_conv1d_fft(x, wr, wi, dc) + torch.einsum("bcn,co->bon", x, pk)
            + pb.reshape(1, -1, 1)),
        "spectral_conv1d": lambda x, wr, wi, pk, pb, dc, act: spectral_conv1d_fft(x, wr, wi, dc),
    }


def phase_kernels():
    from blindno_torch.ops.fno_layer import fno1d_layer_plain, fno2d_layer_plain
    from blindno_torch.ops.spectral import spectral_conv1d, spectral_conv2d
    from blindno_torch.ops.spectral_cuda import (fno1d_layer_cuda, fno2d_layer_cuda,
                                                 spectral_conv1d_cuda, spectral_conv2d_cuda)

    library = fft_restatements()
    variants_2d = [
        ("fno2d_layer", True, lambda x, wr, wi, pk, pb: fno2d_layer_cuda(x, wr, wi, pk, pb, True),
         lambda x, wr, wi, pk, pb: fno2d_layer_plain(x, wr, wi, pk, pb, True)),
        ("fno2d_layer", False, lambda x, wr, wi, pk, pb: fno2d_layer_cuda(x, wr, wi, pk, pb, False),
         lambda x, wr, wi, pk, pb: fno2d_layer_plain(x, wr, wi, pk, pb, False)),
        ("spectral_conv2d", None, lambda x, wr, wi, pk, pb: spectral_conv2d_cuda(x, wr, wi),
         lambda x, wr, wi, pk, pb: spectral_conv2d(x, wr, wi)),
    ]
    layer_1d = lambda act: (
        ("fno1d_layer", act,
         lambda x, wr, wi, pk, pb, dc: fno1d_layer_cuda(x, wr, wi, pk, pb, dc, act),
         lambda x, wr, wi, pk, pb, dc: fno1d_layer_plain(x, wr, wi, pk, pb, dc, act)))
    spectral_1d = ("spectral_conv1d", None,
                   lambda x, wr, wi, pk, pb, dc: spectral_conv1d_cuda(x, wr, wi, dc),
                   lambda x, wr, wi, pk, pb, dc: spectral_conv1d(x, wr, wi, dc))
    stats = {}
    with torch.inference_mode():
        main_args = layer_inputs(MAIN_SHAPE, "cuda")
        warm_up(lambda: variants_2d[0][2](*main_args))
        # every shape checked; timed: the main shapes, in 2-D the NIOFNO2D inner branch
        # and, from graphs alone, every tiled layout's shape (the padded heads' on the
        # slice's path); the other shapes' times are in PERF.md from earlier runs
        check_and_time([(MAIN_SHAPE, True, True), (RAGGED_SHAPE, False, False),
                        (NCFPE2D_HEADS, False, False), (NIOFNO2D_INNER, True, False),
                        (NCFPE2D_INNER, False, False), (FIT_SHAPE, False, False),
                        (TP_SLICE, False, False),
                        *((shape, GRAPH_ONLY, False) for shape in TILED_SHAPES)],
                       variants_2d, library, KERNEL_TOL, stats)
        check_and_time([(HEADS_1D, True, True), (RAGGED_1D, False, False)],
                       [layer_1d(True), layer_1d(False), spectral_1d], library,
                       KERNEL_TOL_1D, stats)
        check_and_time([(BRANCH_1D, False, False)], [layer_1d(True), layer_1d(False)], library,
                       KERNEL_TOL_1D, stats)
        check_and_time([(GPE_HEADS_1D, False, False)],
                       [layer_1d(True), layer_1d(False), spectral_1d], library, KERNEL_TOL_1D,
                       stats)
        check_and_time([(ODE_HEADS_1D, False, False)], [layer_1d(True), layer_1d(False)],
                       library, KERNEL_TOL_1D, stats)
        check_and_time([(TRAIN_HEADS_1D, False, False), (TRAIN_BRANCH_1D, False, False),
                        (TRAIN_GPE_HEADS_1D, False, False)], [layer_1d(True), layer_1d(False)],
                       library, KERNEL_TOL_1D, stats)
        for shape, (name, act, kernel, plain), tol in (
                (MAIN_SHAPE, variants_2d[0], KERNEL_TOL),
                (MAIN_SHAPE, variants_2d[2], KERNEL_TOL),
                (TRAIN_HEADS_1D, layer_1d(True), KERNEL_TOL_1D),
                (TRAIN_HEADS_1D, spectral_1d, KERNEL_TOL_1D)):
            low_precision_operands(name, act, kernel, plain, shape, tol)
    gc.collect()  # the phase's CUDA graphs and their memory pools go before the next phase
    torch.cuda.synchronize()
    return stats


def low_precision_operands(name, act, kernel, plain, shape, tol):
    """The wrapper given bfloat16 and float16 operands at ``shape``, as the training
    step's low-precision modes call it: its result in that dtype, within ``tol`` plus the
    dtype's unit roundoff (of the output's scale) of the plain version on the operands
    raised to float32 (the casts' and the kernel's time are in PERF.md section 6, PR 16)."""
    args = layer_inputs(shape, "cuda")
    for dtype, eps in ((torch.bfloat16, 2.0 ** -8), (torch.float16, 2.0 ** -11)):
        low = [a.to(dtype) if torch.is_tensor(a) else a for a in args]
        got = kernel(*low)
        want = plain(*[a.float() if torch.is_tensor(a) else a for a in low])
        if got.dtype != dtype:
            raise RuntimeError(f"{name} {shape}: {dtype} operands gave a {got.dtype} result")
        scale = float(want.abs().max())
        err = check_close(f"{name} act={act} {shape} {dtype}", got.float(), want, tol + eps,
                          scale)
        emit("kernels", kernel=name, gelu=act, shape=shape, operands=str(dtype)[6:],
             max_abs_err=err, tol=f"rtol {tol + eps:.3g}, atol that x {scale:.3g}")


def calibrate_bn(model, x, grid, rng):
    """BatchNorm as a trained model has it: affine parameters drawn in the ranges of
    tests/test_nio2d_torch_parity.py, running statistics measured on a calibration batch
    (one train-mode pass of the NIO's branch and trunk, or of the UNet's set encoder).
    Statistics drawn at random instead leave an untrained encoder's output all but
    independent of its input. A model without BatchNorm is left as it is."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    if not bns:
        return
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(torch.tensor(rng.uniform(0.6, 1.4, m.num_features)))
            m.bias.copy_(torch.tensor(rng.normal(0.0, 0.08, m.num_features)))
            m.reset_running_stats()
            m.momentum = None  # running stats = this pass's batch stats
        if hasattr(model, "deeponet"):
            deeponet = model.deeponet
            deeponet.train()
            deeponet.branch(torch.as_tensor(x))
            deeponet.trunk(torch.as_tensor(grid).reshape(-1, grid.shape[-1]))
        else:
            model.train().features(torch.as_tensor(x))
        model.eval()
        for m in bns:
            m.momentum = 0.1


def serve(label, cpu_model, inputs, grid, batch, rounds, layer, per_forward, min_spread=1e-5,
          out_dim=2, cpu_reference=None, cpu_sets=None):
    """One model's main path: ``predict_fields`` on the card with every launch counted
    (``per_forward`` launches of kernel ``layer`` per forward and no other), its
    throughput, and its output of ``out_dim`` fields checked against the CPU plain path
    on the first batch of sets (the first ``cpu_sets`` where given), computed here or
    handed in by ``cpu_reference()`` as (output, seconds). The
    outputs of the first two sets must differ by ``min_spread`` at least, so that the
    output depends on the input. Returns the model on the card, the launch counts and
    the fields of its phase line."""
    from blindno_torch.eval.field_eval import predict_fields

    model = copy.deepcopy(cpu_model).to("cuda")
    m = inputs.shape[0]
    n_batches = -(-m // batch)
    t0 = time.perf_counter()
    counts, out = counted(lambda: predict_fields(model, inputs, grid, batch=batch))
    first_s = time.perf_counter() - t0
    expect_launches(f"serving {label}", counts, **{layer: per_forward * n_batches})
    spread = np.abs(out[0] - out[1]).max()
    want_shape = (m, *grid.shape[:-1], out_dim)
    if out.shape != want_shape or not np.isfinite(out).all() or spread < min_spread:
        raise RuntimeError(f"serving {label}: shape {out.shape} (want {want_shape}), finite "
                           f"{np.isfinite(out).all()}, difference between two sets {spread:.3g}")

    # throughput of the entry point (numpy in, numpy out), host clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        predict_fields(model, inputs, grid, batch=batch)
    wall = time.perf_counter() - t0
    forwards = rounds * n_batches

    # the same weights on the CPU plain path; the tolerance scales with the output
    k = cpu_sets or batch
    if cpu_reference is None:
        t0 = time.perf_counter()
        want = predict_fields(cpu_model, inputs[:k], grid, batch=k, device="cpu")
        cpu_s = time.perf_counter() - t0
    else:
        want, cpu_s = cpu_reference()
    want = torch.tensor(want)
    scale = want.abs().max().item()
    err_cpu = check_close(f"serving {label} vs the CPU plain path", torch.tensor(out[:k]),
                          want, SERVE_TOL, scale)
    fields = dict(sets=m, snapshots=inputs.shape[1], grid=list(grid.shape), batch=batch,
                  launches=counts, launches_per_forward=counts[layer] / n_batches,
                  output_abs_max=scale, output_set_spread=float(spread),
                  max_abs_err_vs_cpu=err_cpu, sets_vs_cpu=k,
                  tol=f"rtol {SERVE_TOL}, atol {SERVE_TOL} x output_abs_max",
                  first_call_s=first_s, cpu_reference_s=cpu_s, timed_forwards=forwards,
                  forwards_per_s=forwards / wall, ms_per_forward=1e3 * wall / forwards,
                  sets_per_s=rounds * m / wall)
    return model, counts, fields


def spectral_path(label, model, cpu_model, lifted, kernel, tol):
    """Each head's SpectralConv modules on that head's lifted fields, launches counted
    (one per module and no other kernel), against the same modules on the CPU."""
    counts, spec = counted(lambda: [sc(x) for head, x in zip(model.heads, lifted)
                                    for sc in head.spectral])
    expect_launches(label, counts, **{kernel: len(spec)})
    spec_want = [sc(x.cpu()) for head, x in zip(cpu_model.heads, lifted) for sc in head.spectral]
    err = max(check_close(f"{label} module {i} vs the CPU", got.cpu(), want, tol)
              for i, (got, want) in enumerate(zip(spec, spec_want)))
    emit("spectral_path", path=label, launches=counts, max_abs_err_vs_cpu=err, tol=tol)
    return counts[kernel]


def grid_2d(n):
    """The n x n grid on [-1, 1]^2, (n, n, 2)."""
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    return np.stack([gx, gy], 2).astype(np.float32)


def sets_1d(rng, k, l, n):
    """k sets of l snapshots of n points. The snapshots of one set share that set's
    profile, as the snapshots of one solution do; with independent noise alone, the mean
    over a set is nearly the same for every set, and so is the FNO-branch model's
    output."""
    return (rng.standard_normal((k, 1, n)) + 0.5 * rng.standard_normal((k, l, n))).astype(np.float32)


def phase_serve():
    from blindno_torch.models.nio2d import NIOFP2D

    m, l, n, batch = SERVE["m"], SERVE["l"], SERVE["n"], SERVE["batch"]
    inputs = np.random.default_rng(0).standard_normal((m, l, n, n)).astype(np.float32)
    grid = grid_2d(n)

    cpu_model = NIOFP2D(**MODEL, generator=torch.Generator().manual_seed(0), device="cpu")
    calib = np.random.default_rng(1).standard_normal((1, l, n, n)).astype(np.float32)
    calibrate_bn(cpu_model, calib, grid, np.random.default_rng(7))
    model, counts, fields = serve("NIOFP2D", cpu_model, inputs, grid, batch,
                                  SERVE["timed_rounds"], "fno2d_layer",
                                  2 * MODEL["fno_layers"])
    launches = {"fno2d_layer": counts["fno2d_layer"]}

    with torch.inference_mode():
        xb = torch.tensor(inputs[:batch], device="cuda")
        g = torch.tensor(grid, device="cuda")
        dn = model.deeponet
        feats = model.fusion(g.unsqueeze(0).expand(batch, *g.shape),
                             dn(xb, g.reshape(-1, 2)).reshape(batch, l, n, n))
        launches["spectral_conv2d"] = spectral_path(
            "SpectralConv2d", model, cpu_model, [head.lift(feats) for head in model.heads],
            "spectral_conv2d", KERNEL_TOL)

        # where one forward's device time goes, by CUDA events
        split = dict(forward_ms=time_ms(lambda: model(xb, g), 10),
                     encoder_ms=time_ms(lambda: dn.branch(xb), 10),
                     heads_ms=time_ms(lambda: [h(feats) for h in model.heads], 10),
                     heads_graph_ms=graph_ms(lambda: [h(feats) for h in model.heads], 5),
                     h2d_ms=time_ms(lambda: torch.as_tensor(inputs[:batch]).to("cuda"), 10))
    emit("serve", model="NIOFP2D", config=MODEL, **fields, device_split=split)
    return launches


def phase_serve1d():
    """The 1-D serving paths: the fpe1d NIOFP1D (Encoder1D branch) and NIOFNO1D (inner
    FNO1d branch), each with two FNO1d heads of three layers at the suite's width, and
    the gpe1d NIOFP1D with one head at the GPE suite's width."""
    from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D
    from blindno_torch.nn.cnn import ENC_GPE128

    launches = {"fno1d_layer": 0}
    # (label, class, config, serving sizes, fno1d_layer launches per forward, least
    # spread between two sets' outputs, output fields): 3 layers in each head, and the
    # FNO-branch model's 2 inner layers. The untrained FNO-branch model's output moves
    # by about 7e-5 of its scale between sets (3.6e-6 at a scale of 0.054 in a CPU run),
    # so its floor is lower.
    paths = (("NIOFP1D", NIOFP1D, MODEL_1D, SERVE_1D, 6, 1e-5, 2),
             ("NIOFNO1D", NIOFNO1D, MODEL_1D, SERVE_1D, 8, 1e-7, 2),
             ("NIOFP1D gpe1d", NIOFP1D, dict(MODEL_GPE, encoder_final_convs=ENC_GPE128),
              SERVE_GPE, 3, 1e-5, 1))
    for label, cls, config, sizes, per_forward, min_spread, out_dim in paths:
        m, l, n, batch = sizes["m"], sizes["l"], sizes["n"], sizes["batch"]
        inputs = sets_1d(np.random.default_rng(2), m, l, n)
        grid = np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)
        cpu_model = cls(**config, generator=torch.Generator().manual_seed(0), device="cpu")
        calibrate_bn(cpu_model, sets_1d(np.random.default_rng(3), 1, l, n), grid,
                     np.random.default_rng(7))
        model, counts, fields = serve(label, cpu_model, inputs, grid, batch,
                                      sizes["timed_rounds"], "fno1d_layer", per_forward,
                                      min_spread, out_dim)
        launches["fno1d_layer"] += counts["fno1d_layer"]

        with torch.inference_mode():
            xb = torch.tensor(inputs[:batch], device="cuda")
            g = torch.tensor(grid, device="cuda")
            # the encoder: Encoder1D over every snapshot, or the inner FNO1d over every
            # (snapshot, grid) pair
            if cls is NIOFP1D:
                encoder = lambda: model.deeponet.branch(xb)
                snap_fields = model.deeponet(xb, g)
            else:
                snaps = torch.cat([xb.reshape(batch * l, n, 1), g.expand(batch * l, n, 1)], -1)
                encoder = lambda: model.branch(snaps)
                snap_fields = encoder().reshape(batch, l, n)
            feats = model.fusion(g.expand(batch, n, 1), snap_fields)
            if label == "NIOFP1D":
                launches["spectral_conv1d"] = spectral_path(
                    "SpectralConv1d", model, cpu_model,
                    [head.lift(feats) for head in model.heads], "spectral_conv1d",
                    KERNEL_TOL_1D)
            # where one forward's device time goes: eager parts by CUDA events, and the
            # same parts replayed from CUDA graphs, whose device times add up
            heads = lambda: [h(feats) for h in model.heads]
            split = dict(forward_ms=time_ms(lambda: model(xb, g), 10),
                         encoder_ms=time_ms(encoder, 10), heads_ms=time_ms(heads, 10),
                         forward_graph_ms=graph_ms(lambda: model(xb, g), 5, 5),
                         encoder_graph_ms=graph_ms(encoder, 5, 5),
                         heads_graph_ms=graph_ms(heads, 5, 5),
                         h2d_ms=time_ms(lambda: torch.as_tensor(inputs[:batch]).to("cuda"), 10))
            split["rest_graph_ms"] = (split["forward_graph_ms"] - split["encoder_graph_ms"]
                                      - split["heads_graph_ms"])
        emit("serve1d", model=label, config=config, **fields, device_split=split)
    return launches


def grid_3d(n):
    """The n^3 grid on [0, 1]^3, (n, n, n, 3)."""
    axis = np.linspace(0.0, 1.0, n, dtype=np.float32)
    return np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)


def sets_3d(rng, k, l, n):
    """k sets of l volumes of n^3, each set's volumes sharing that set's profile (as
    :func:`sets_1d`)."""
    base = rng.standard_normal((k, 1, n, n, n), dtype=np.float32)
    return base + np.float32(0.5) * rng.standard_normal((k, l, n, n, n), dtype=np.float32)


def conv_flop(blocks, size):
    """The operations (2 per multiply-add) of one snapshot of spatial ``size`` through
    ``blocks``, each with its convolution as ``.conv``."""
    from blindno_torch.nn.cnn import schedule_output_size

    macs = 0
    for block in blocks:
        c = block.conv
        size = schedule_output_size(size, [(c.in_channels, c.out_channels, c.kernel_size,
                                            c.stride, c.padding)])
        macs += math.prod(size) * c.out_channels * c.in_channels * math.prod(c.kernel_size)
    return 2 * macs


def serve_nio3d(smi_line):
    """``NIOFP3D`` at its defaults (SERVE_3D): seeded weights, BatchNorm calibrated on the
    card; served through ``predict_fields`` (no kernel of the port on this path: FNO3d's
    spectral convolution is the einsum chain, as in JAX), against the CPU on the first
    set cut to ``cpu_snapshots``; forwards per second, peak memory, and the forward split
    on the device (each part replayed from a CUDA graph) between the encoder, the trunk,
    the fusion and the FNO3d head; then ``train_steps`` float32 training steps on one
    batch, each loss finite. Returns the phase line's fields."""
    from blindno_torch.eval.field_eval import predict_fields
    from blindno_torch.models.nio3d import NIOFP3D
    from blindno_torch.train.step import make_optimizer, train_step

    m, l, n, batch = SERVE_3D["m"], SERVE_3D["l"], SERVE_3D["n"], SERVE_3D["batch"]
    inputs, grid = sets_3d(np.random.default_rng(2), m, l, n), grid_3d(n)
    model = NIOFP3D(generator=torch.Generator().manual_seed(0), device="cuda")
    g = torch.tensor(grid, device="cuda")
    calibrate_bn(model, torch.tensor(sets_3d(np.random.default_rng(3), 1, l, n), device="cuda"),
                 g, np.random.default_rng(7))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts, out = counted(lambda: predict_fields(model, inputs, grid, batch=batch))
    first_s = time.perf_counter() - t0
    expect_launches("serving NIOFP3D", counts)
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spread = np.abs(out[0] - out[1]).max()
    if out.shape != (m, n, n, n, 1) or not np.isfinite(out).all() or spread < 1e-5:
        raise RuntimeError(f"serving NIOFP3D: shape {out.shape}, finite {np.isfinite(out).all()}, "
                           f"difference between two sets {spread:.3g}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_3D["timed_rounds"]):
        predict_fields(model, inputs, grid, batch=batch)
    wall = time.perf_counter() - t0
    forwards = SERVE_3D["timed_rounds"] * -(-m // batch)

    # the card against the CPU plain path, on the first set cut to a few snapshots
    cut = inputs[:1, :SERVE_3D["cpu_snapshots"]]
    cpu_model = NIOFP3D(generator=torch.Generator().manual_seed(0), device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    got = predict_fields(model, cut, grid, batch=1)
    t0 = time.perf_counter()
    want = torch.tensor(predict_fields(cpu_model, cut, grid, batch=1, device="cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_model
    scale = want.abs().max().item()
    err = check_close("serving NIOFP3D vs the CPU plain path", torch.tensor(got), want,
                      SERVE_TOL, scale)

    xb = torch.tensor(inputs[:batch], device="cuda")
    with torch.inference_mode():
        gb = g.expand(batch, *g.shape)
        dn = model.deeponet
        fields = model.fields(xb, g)
        feats = model.fusion(gb, fields)
        parts = {"encoder": lambda: dn.branch(xb), "trunk": lambda: dn.trunk(g.reshape(-1, 3)),
                 "fusion": lambda: model.fusion(gb, fields), "fno3d": lambda: model.head(feats),
                 "forward": lambda: model(xb, g)}
        split = {f"{k}_graph_ms": graph_ms(fn, 2, 3) for k, fn in parts.items()}
        split["rest_graph_ms"] = split["forward_graph_ms"] - sum(
            split[f"{k}_graph_ms"] for k in ("encoder", "trunk", "fusion", "fno3d"))
        split["h2d_ms"] = time_ms(lambda: torch.as_tensor(inputs[:batch]).to("cuda"), 3)
        del fields, feats
    # the encoder's convolutions a forward, and the rate its graph time gives them
    encoder_tflop = conv_flop(model.deeponet.branch.blocks, (n, n, n)) * batch * l / 1e12
    encoder_tflop_s = encoder_tflop / (split["encoder_graph_ms"] / 1e3)

    # float32 training steps on one batch, the set subsample drawn on the card
    y = torch.tensor(np.random.default_rng(4).standard_normal((batch, n, n, n, 1),
                                                              dtype=np.float32), device="cuda")
    model.train()
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts_train, losses = counted(lambda: [float(train_step(model, opt, xb, y, g, generator=gen))
                                            for _ in range(SERVE_3D["train_steps"])])
    step_s = (time.perf_counter() - t0) / SERVE_3D["train_steps"]
    expect_launches("training NIOFP3D", counts_train)
    if not np.isfinite(losses).all():
        raise RuntimeError(f"training NIOFP3D: losses {losses}")
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, opt, xb, y
    torch.cuda.empty_cache()
    return dict(model="NIOFP3D", config="defaults", sets=m, snapshots=l, grid=[n, n, n],
                batch=batch, launches=counts, first_call_s=first_s, timed_forwards=forwards,
                forwards_per_s=forwards / wall, ms_per_forward=1e3 * wall / forwards,
                output_abs_max=scale, output_set_spread=float(spread), max_abs_err_vs_cpu=err,
                cpu_sets_snapshots=list(cut.shape[:2]), cpu_reference_s=cpu_s,
                tol=f"rtol {SERVE_TOL}, atol {SERVE_TOL} x output_abs_max",
                serve_peak_memory_gb=serve_peak_gb, device_split=split,
                encoder_conv_tflop=encoder_tflop, encoder_tflop_s=encoder_tflop_s,
                encoder_share_of_f32_peak=encoder_tflop_s * 1e12 / PEAK_F32_FLOP_S,
                train_losses=losses,
                train_launches=counts_train, train_step_s=step_s,
                train_peak_memory_gb=train_peak_gb, nvidia_smi=smi_line)


def phase_serve3d(smi_line):
    """The 3-D NIO's path (:func:`serve_nio3d`), then the ODE-observation NIO's:
    ``NIOFPOde`` at its defaults (SERVE_ODE; seeded weights, calibrated BatchNorm) through
    ``predict_fields``, its FNO1d head's ``fno1d_layer`` launched exactly 3 times a
    forward, every call at ODE_HEADS_1D, against the CPU plain path."""
    from blindno_torch.models.nio1d import NIOFPOde
    from blindno_torch.nn import fno

    emit("serve3d", **serve_nio3d(smi_line))
    m, l, k, n = SERVE_ODE["m"], SERVE_ODE["l"], SERVE_ODE["n_obs"], SERVE_ODE["n"]
    inputs = sets_1d(np.random.default_rng(2), m, l, k)
    grid = np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)
    cpu_model = NIOFPOde(generator=torch.Generator().manual_seed(0), device="cpu")
    calibrate_bn(cpu_model, sets_1d(np.random.default_rng(3), 1, l, k), grid,
                 np.random.default_rng(7))
    shapes = set()

    def recorded(x, wr, *args, **kwargs):
        shapes.add((*x.shape, wr.shape[-1]))
        return layer(x, wr, *args, **kwargs)

    layer = fno.fno1d_layer_cuda
    with patched(fno, "fno1d_layer_cuda", recorded):
        _, counts, fields = serve("NIOFPOde", cpu_model, inputs, grid, SERVE_ODE["batch"],
                                  SERVE_ODE["timed_rounds"], "fno1d_layer", 3, out_dim=1)
    want = (SERVE_ODE["batch"], *ODE_HEADS_1D[1:4])  # ODE_HEADS_1D at the phase's batch
    if shapes != {want}:
        raise RuntimeError(f"serving NIOFPOde: fno1d_layer called at {sorted(shapes)}, "
                           f"want {want} (B, C, N, modes) only")
    emit("serve3d", model="NIOFPOde", config="defaults", observations=k, layer_shape=ODE_HEADS_1D,
         **fields, nvidia_smi=smi_line)
    return counts["fno1d_layer"]


def randomize_layernorms(model, rng):
    """Each LayerNorm's scale drawn from U(0.6, 1.4) and its bias from N(0, 0.08), as the
    CPU tests draw them: at flax's init (ones and zeros) a LayerNorm laid over its
    tokens in the wrong order would not show."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(torch.tensor(rng.uniform(0.6, 1.4, m.weight.shape)))
                m.bias.copy_(torch.tensor(rng.normal(0.0, 0.08, m.bias.shape)))


def top_kernels(fn, n=6, iters=3):
    """The ``n`` CUDA kernels of ``fn`` with the most device time per call (ms; names cut
    to 80 characters) in a ``torch.profiler`` trace, and the sum over all of its kernels,
    the device's busy time per call, as ``"all"``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = sorted(((e.key[:80], e.device_time_total / 1e3 / iters) for e in prof.key_averages()
                 if e.device_time_total > 0), key=lambda kv: -kv[1])
    return dict(ms[:n], all=sum(v for _, v in ms))


def phase_serve_unet():
    """The BlinDNO UNet's serving paths: the fpe2d suite's UNet (ConvNeXt blocks, two
    FNO2d heads) on the NIO's serving sets, the gpe1d suite's 1-D UNet (one FNO1d head)
    on the gpe1d NIO's, and the ncfpe2d suite's plain-block UNet on 80x80 sets; seeded
    weights, randomized LayerNorms, calibrated BatchNorms. Each through
    ``predict_fields`` with its launches counted exactly, against the CPU plain path,
    timed, and split between the set encoder and the heads on the device and the host."""
    from blindno_torch.models.blindno_unet import PermInvUNetAttn
    from blindno_torch.tools.bench_train import UNET_CONFIG

    launches = {"fno2d_layer": 0, "fno1d_layer": 0}
    # (label, config, serving sizes, kernel, its launches per forward, output fields)
    paths = (("fpe2d UNet", UNET_CONFIG, SERVE, "fno2d_layer", 6, 2),
             ("gpe1d UNet", MODEL_UNET_GPE, SERVE_GPE, "fno1d_layer", 3, 1),
             ("ncfpe2d plain UNet", MODEL_UNET_NC, SERVE_UNET_NC, "fno2d_layer", 6, 2))
    for label, config, sizes, layer, per_forward, out_dim in paths:
        m, l, n, batch = sizes["m"], sizes["l"], sizes["n"], sizes["batch"]
        rng = np.random.default_rng(2)
        if len(config["input_size"]) == 1:
            inputs, calib = sets_1d(rng, m, l, n), sets_1d(np.random.default_rng(3), 1, l, n)
            grid = np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)
        else:
            inputs = rng.standard_normal((m, l, n, n)).astype(np.float32)
            calib = np.random.default_rng(1).standard_normal((1, l, n, n)).astype(np.float32)
            grid = grid_2d(n)
        cpu_model = PermInvUNetAttn(**config, generator=torch.Generator().manual_seed(0),
                                    device="cpu")
        randomize_layernorms(cpu_model, np.random.default_rng(8))
        calibrate_bn(cpu_model, calib, grid, np.random.default_rng(7))
        model, counts, fields = serve(label, cpu_model, inputs, grid, batch,
                                      sizes["timed_rounds"], layer, per_forward, 1e-5, out_dim)
        launches[layer] += counts[layer]

        # where one forward's time goes: on the device (eager, by CUDA events; and each
        # part replayed from a CUDA graph, whose device times add up) and on the host
        # (the time to enqueue one forward: where it matches the eager device time, the
        # device waited on the host)
        with torch.inference_mode():
            xb = torch.tensor(inputs[:batch], device="cuda")
            feats = model.features(xb)
            heads = lambda: [h(feats) for h in model.heads]
            forward_ms, forward_host_ms = time_ms(lambda: model(xb, None), 10, host=True)
            split = dict(forward_ms=forward_ms, forward_host_ms=forward_host_ms,
                         features_ms=time_ms(lambda: model.features(xb), 10),
                         heads_ms=time_ms(heads, 10),
                         forward_graph_ms=graph_ms(lambda: model(xb, None), 5, 5),
                         features_graph_ms=graph_ms(lambda: model.features(xb), 5, 5),
                         heads_graph_ms=graph_ms(heads, 5, 5),
                         h2d_ms=time_ms(lambda: torch.as_tensor(inputs[:batch]).to("cuda"), 10),
                         top_kernels_ms=top_kernels(lambda: model(xb, None)))
        emit("serve_unet", model=label, config=config, **fields, device_split=split)
    return launches


def sets_2d(rng, k, l, n):
    """k sets of l snapshots of n x n, each set's snapshots sharing that set's profile
    (as :func:`sets_1d`): the untrained FNO-branch models average their inner FNO2d's
    fields over the set, which would leave sets of independent noise all alike."""
    return (rng.standard_normal((k, 1, n, n)) + 0.5 * rng.standard_normal((k, l, n, n))
            ).astype(np.float32)


def phase_serve_nio2d():
    """The FNO-branch and token-attention NIOs' serving paths at their suites' widths:
    the fpe2d ``NIOFNO2D``, ``NIOAttn2D`` and ``NIOFNOAttn2D`` on SERVE's sizes and the
    ncfpe2d ``NIOFNO2D`` on SERVE_UNET_NC's; seeded weights, calibrated BatchNorms. Each
    through ``predict_fields`` with its launches counted exactly (2 inner and 6 head
    layers a forward, or 6), against the CPU plain path, timed, and split on the device
    (each part replayed from a CUDA graph) between the per-snapshot fields (the inner
    FNO2d over all B x L snapshots, or the DeepONet), the token attention, the fusion and
    the heads, beside the host's time to enqueue a forward."""
    from blindno_torch.models import nio2d
    from blindno_torch.tools.bench_train import CONFIG, FNO_CONFIG

    launches = 0
    # (label, class, config, serving sizes, fno2d_layer launches per forward, least spread
    # between two sets' outputs). The untrained FNO-branch models' outputs move by about
    # 6e-4 of their scale between two sets (tests/test_torch_nio2d_models.py), so their
    # floor is lower.
    paths = (("fpe2d NIOFNO2D", nio2d.NIOFNO2D, FNO_CONFIG, SERVE, 8, 1e-7),
             ("fpe2d NIOAttn2D", nio2d.NIOAttn2D, CONFIG, SERVE, 6, 1e-5),
             ("fpe2d NIOFNOAttn2D", nio2d.NIOFNOAttn2D, FNO_CONFIG, SERVE, 8, 1e-7),
             ("ncfpe2d NIOFNO2D", nio2d.NIOFNO2D, FNO_CONFIG, SERVE_UNET_NC, 8, 1e-7))
    for label, cls, config, sizes, per_forward, min_spread in paths:
        # NIOAttn2D's split times the attention, the fusion and the heads: its forward
        # and DeepONet times are PERF.md's (section 5, PR 11: 18.3-18.5 ms, the DeepONet
        # 98%)
        parts_of = (("fusion", "heads", "attention") if cls is nio2d.NIOAttn2D else
                    ("forward", "fields", "fusion", "heads", "attention"))
        counts, fields, split = serve_split(label, cls, config, sizes, per_forward, min_spread,
                                            parts_of=parts_of)
        launches += counts["fno2d_layer"]
        emit("serve_nio2d", model=label, config=config, **fields, device_split=split)
    return launches


def served_model(cls, config, sizes, prepare):
    """A 2-D NIO on the CPU, its weights from seed 0 and then ``prepare(model, sets, grid,
    rng)``, and seeded sets of ``sizes`` with their grid."""
    m, l, n = sizes["m"], sizes["l"], sizes["n"]
    inputs, grid = sets_2d(np.random.default_rng(2), m, l, n), grid_2d(n)
    cpu_model = cls(**config, generator=torch.Generator().manual_seed(0), device="cpu")
    prepare(cpu_model, sets_2d(np.random.default_rng(3), 1, l, n), grid, np.random.default_rng(7))
    return cpu_model, inputs, grid


def serve_split(label, cls, config, sizes, per_forward, min_spread, prepare=calibrate_bn,
                parts_of=("forward", "fields", "fusion", "heads", "attention"),
                cpu_reference=None):
    """One 2-D NIO's serving path (:func:`serve`, ``cpu_reference`` as there) on
    :func:`served_model`'s model and sets; and each forward split on the device (each
    part replayed from a CUDA graph) between the per-snapshot fields, the token attention
    where the model has it, the fusion and the heads (the parts named in ``parts_of``),
    beside the host's time to enqueue a forward and the forward's top kernels. Returns
    the launch counts, the serving fields and the split."""
    from blindno_torch.models import nio2d

    batch = sizes["batch"]
    cpu_model, inputs, grid = served_model(cls, config, sizes, prepare)
    model, counts, fields = serve(label, cpu_model, inputs, grid, batch, sizes["timed_rounds"],
                                  "fno2d_layer", per_forward, min_spread,
                                  cpu_reference=cpu_reference)
    with torch.inference_mode():
        xb = torch.tensor(inputs[:batch], device="cuda")
        g = torch.tensor(grid, device="cuda")
        # the fusion's inputs as the forward hands them, read by a hook
        fusion_args = []
        hook = model.fusion.register_forward_hook(lambda mod, a, out: fusion_args.append(a))
        model(xb, g)
        hook.remove()
        snap = model.fields(xb, g)
        feats = model.fusion(*fusion_args[0])
        parts = {"fields": lambda: model.fields(xb, g),
                 "fusion": lambda: model.fusion(*fusion_args[0]),
                 "heads": lambda: [h(feats) for h in model.heads]}
        if cls in (nio2d.NIOAttn2D, nio2d.NIOFNOAttn2D, nio2d.NIOTransAttn2D):
            parts["attention"] = lambda: nio2d._token_attention_tokens(snap, g, None)
        parts["forward"] = lambda: model(xb, g)
        forward_ms, forward_host_ms = time_ms(lambda: model(xb, g), 10, host=True)
        split = dict(forward_ms=forward_ms, forward_host_ms=forward_host_ms,
                     **{f"{k}_graph_ms": graph_ms(fn, 5, 5) for k, fn in parts.items()
                        if k in parts_of},
                     h2d_ms=time_ms(lambda: torch.as_tensor(inputs[:batch]).to("cuda"), 10))
        if "fields" in parts_of:
            split["top_kernels_ms"] = top_kernels(lambda: model(xb, g))
        del snap, feats, fusion_args
    return counts, fields, split


def rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def train_tol(key):
    """The tolerance of one entry of :func:`train_errors`: the encoder's gradients and
    parameters take ENCODER_TOL, its running statistics and everything else TRAIN_TOL."""
    encoder = key.startswith(("deeponet.branch.", "state deeponet.branch."))
    return ENCODER_TOL if encoder and "running_" not in key else TRAIN_TOL


def train_errors(card, cpu):
    """Relative L2 errors of the card's step against the CPU's: the loss, each gradient,
    each parameter and running statistic after the step. The conv biases' gradients (a
    BatchNorm follows each conv) are zero but for rounding: both must stay below 1e-6 of
    the largest gradient. Raises naming every tensor out of its tolerance."""
    (loss, grads, state), (want_loss, want_grads, want_state) = card, cpu
    top = max(float(g.abs().max()) for g in want_grads.values())
    zero = [k for k in want_grads if k.endswith("conv.bias")]
    worst_zero = max((float(g.abs().max()) for k in zero for g in (grads[k], want_grads[k])),
                     default=0.0)
    if worst_zero >= 1e-6 * top:
        raise RuntimeError(f"train: a conv bias's gradient is {worst_zero:.3g}, want < 1e-6 x {top:.3g}")
    errs = {"loss": abs(loss - want_loss) / abs(want_loss)}
    errs.update({k: rel_l2(grads[k], want_grads[k]) for k in want_grads if k not in zero})
    errs.update({f"state {k}": rel_l2(state[k], want_state[k]) for k in want_state})
    bad = {k: e for k, e in errs.items() if not e <= train_tol(k)}
    if bad:
        raise RuntimeError(f"train: on the card, relative L2 from the CPU beyond "
                           f"{TRAIN_TOL} ({ENCODER_TOL} for the encoder): "
                           f"{bad}; worst ten: {sorted(errs.items(), key=lambda kv: -kv[1])[:10]}")
    return errs


def one_step(model, x, y, grid, draw, compute_dtype=None, amp_policy="encoder_bn32"):
    """One ``train_step`` from a fresh optimizer; the loss, the gradients and the state
    after it, on the CPU."""
    from blindno_torch.train.step import make_optimizer, train_step

    loss = train_step(model, make_optimizer(model), x, y, grid, subsample=draw,
                      compute_dtype=compute_dtype, amp_policy=amp_policy)
    grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
    state = {k: v.cpu() for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    return float(loss), grads, state


def timed_steps(step, n=TRAIN_STEPS):
    """One warm-up ``step()``, then ``n`` more timed on the host clock between two
    synchronizes (no synchronization between them): their losses and steps per second."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n)]
    torch.cuda.synchronize()
    return [float(v) for v in losses], n / (time.perf_counter() - t0)


def low_precision_steps(label, model, initial, batch, draw, card, per_step, held,
                        compute_dtype="bfloat16", amp_policy="all", lr=5e-4):
    """The training step in ``compute_dtype`` under ``amp_policy`` (``train_step``, JAX's
    casts), from the state ``initial`` that gave the card's float32 step ``card`` (loss,
    gradients, state) on ``batch`` (x, y, grid) and ``draw``: its launches counted (the
    FNO kernels inside the cast: ``per_step`` of each kernel a step), every gradient
    finite, the loss and each gradient that ``held(name)`` names within LOW_LOSS_TOL and
    LOW_GRAD_TOL of the float32 step's; LOW_STEPS steps from ``initial``, a fresh draw
    each, whose loss must fall, timed (steps per second, the host's time to enqueue one,
    the device's busy time in one from a profiler trace, peak memory). Returns the fields
    to emit and the launches of every counted step."""
    from blindno_torch.train.step import make_optimizer, train_step

    x, y, grid = batch
    mode = f"{compute_dtype} {amp_policy}"
    model.load_state_dict(initial)
    torch.cuda.reset_peak_memory_stats()
    counts, (loss, grads, _) = counted(
        lambda: one_step(model, x, y, grid, draw, compute_dtype, amp_policy))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches(f"{label} {mode} step", counts, **per_step)
    if not (math.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())):
        raise RuntimeError(f"{label}: the {mode} step's loss is {loss} or a gradient is not finite")
    want_loss, want_grads = card[0], card[1]
    top = max(float(g.norm()) for g in want_grads.values())
    errs = {"loss": abs(loss - want_loss) / abs(want_loss)}
    errs.update({k: rel_l2(grads[k], g) for k, g in want_grads.items()
                 if held(k) and float(g.norm()) >= 1e-3 * top})
    tol = lambda k: LOW_LOSS_TOL[compute_dtype] if k == "loss" else LOW_GRAD_TOL[compute_dtype]
    bad = {k: e for k, e in errs.items() if not e <= tol(k)}
    if bad:
        raise RuntimeError(f"{label}: the {mode} step lies beyond its bound from the float32 "
                           f"step: {bad}")
    model.load_state_dict(initial)
    opt = make_optimizer(model, lr)
    gen = torch.Generator(device="cuda").manual_seed(2)
    step = lambda: train_step(model, opt, x, y, grid, generator=gen,
                              compute_dtype=compute_dtype, amp_policy=amp_policy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_counts, losses = counted(lambda: [step() for _ in range(LOW_STEPS)])
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{label}: the {mode} loss did not fall over {LOW_STEPS} steps: "
                           f"{losses}")
    expect_launches(f"{label} {mode} steps", timed_counts,
                    **{k: v * LOW_STEPS for k, v in per_step.items()})
    busy_ms = top_kernels(step)["all"]
    total = {k: counts[k] + timed_counts[k] for k in counts}
    fields = dict(mode=mode, launches_per_step=counts, loss=loss, loss_f32=want_loss,
                  rel_l2_from_f32=dict(sorted(errs.items(), key=lambda kv: -kv[1])[:3]),
                  tol=f"loss {LOW_LOSS_TOL[compute_dtype]}, gradients "
                  f"{LOW_GRAD_TOL[compute_dtype]} (relative L2) from the card's float32 step",
                  losses_steps=[losses[0], losses[-1]],
                  steps_per_sec=LOW_STEPS / wall_s,
                  host_enqueue_ms=1e3 * enqueue_s / LOW_STEPS, device_busy_ms=busy_ms,
                  peak_memory_gb=peak_gb)
    return fields, total


def train_step_reference():
    """On the CPU: phase ``train``'s float32 step (:func:`one_step` of NIOFP2D at
    ``bench.py``'s config from seed 0 on its batch and draw), as numpy, and its seconds."""
    from blindno_torch.tools import bench_train

    x, y, grid = bench_train.bench_batch("cpu")
    t0 = time.perf_counter()
    loss, grads, state = one_step(bench_train.fresh_model("cpu"), x, y, grid,
                                  trans_draw(bench_train.BATCH["l"]))
    as_numpy = lambda d: {k: v.numpy() for k, v in d.items()}
    return (loss, as_numpy(grads), as_numpy(state)), time.perf_counter() - t0


def phase_train(kernel_ms, smi_line, cpu_reference):
    """The main path, training: ``train_step`` on NIOFP2D at the ``bench.py`` config.
    ``kernel_ms`` is the forward kernel's time from phase ``kernels``, printed beside
    the layer's backward; ``smi_line`` the card's name and power limit;
    ``cpu_reference`` :func:`train_step_reference`'s result, made in a CPU worker while
    the kernels built."""
    from blindno_torch.nn.torch_layers import BatchNorm2d
    from blindno_torch.ops.fno_layer import fno2d_layer_backward_plain
    from blindno_torch.tools import bench_train
    from blindno_torch.train.step import make_optimizer, train_step

    b, l = bench_train.BATCH["b"], bench_train.BATCH["l"]
    rng = np.random.default_rng(5)
    draw = (rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32))
    cpu_model = bench_train.fresh_model("cpu")
    initial = copy.deepcopy(cpu_model.state_dict())
    x, y, grid = bench_train.bench_batch("cuda")

    # 1-2. one f32 step on the card, its launches counted, against the CPU plain path
    model = copy.deepcopy(cpu_model).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    counts, card = counted(lambda: one_step(model, x, y, grid, draw))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches("training step", counts, fno2d_layer=6)
    (loss_cpu, grads_cpu, state_cpu), cpu_s = cpu_reference
    as_torch = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    cpu = (loss_cpu, as_torch(grads_cpu), as_torch(state_cpu))
    errs = train_errors(card, cpu)
    encoder = {k: e for k, e in errs.items() if train_tol(k) == ENCODER_TOL}
    rest = {k: e for k, e in errs.items() if k not in encoder}

    # 3. a bf16 encoder_bn32 step from the same weights
    model.load_state_dict(initial)
    loss16, grads16, state16 = one_step(model, x, y, grid, draw, "bfloat16")
    bf16_gap = abs(loss16 - card[0]) / card[0]
    # the bf16 encoder's gradients lie this far from the f32 ones (relative L2): bf16 ran
    bf16_grad_gap = max(rel_l2(grads16[k], card[1][k]) for k in card[1]
                        if k.startswith("deeponet.branch.") and not k.endswith("conv.bias"))
    if not (all(torch.isfinite(g).all() for g in grads16.values()) and bf16_gap <= BF16_LOSS_TOL):
        raise RuntimeError(f"train: bf16 step loss {loss16} against f32 {card[0]} "
                           f"(gap {bf16_gap:.3g}, want <= {BF16_LOSS_TOL}) or a non-finite gradient")
    # 3b. the float16 encoder_bn32 step from the same weights, the mode bench.py validated
    # in bfloat16: the Encoder2D computes in float16, the heads in float32 (the grid
    # promotes), so the heads' gradients are held; the trunk's take a one-signed grid
    # through BatchNorms that erase units, ill-conditioned in float32 already
    f16, f16_launches = low_precision_steps(
        "train NIOFP2D", model, initial, (x, y, grid), draw, card, {"fno2d_layer": 6},
        lambda k: k.startswith("heads."), "float16", "encoder_bn32")

    # 4. ten f32 steps on the one batch, a fresh draw each, timed: the loss must fall
    model.load_state_dict(initial)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    losses, f32_sps = timed_steps(lambda: train_step(model, opt, x, y, grid, generator=gen))
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss did not fall over {TRAIN_STEPS} steps: {losses}")

    # 5. the step's split, the layer's backward, the BatchNorm correction (the bf16
    # encoder_bn32 steps/s from fresh weights are bench_train's, PERF.md section 5)
    sps = {"f32": f32_sps}
    ev = lambda: torch.cuda.Event(enable_timing=True)
    split = {k: 0.0 for k in ("forward_ms", "backward_ms", "optimizer_ms", "encoder_fwd_bwd_ms",
                             "heads_fwd_bwd_ms")}
    rounds = 3
    dn, xg = model.deeponet, x[:, torch.as_tensor(draw[0], device="cuda")]
    mask = torch.as_tensor(draw[1], device="cuda")
    for r in range(rounds + 1):
        e = [ev() for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        e[0].record()
        out = model(x, grid, subsample=draw)
        loss = torch.mean((out - y) ** 2)
        e[1].record()
        loss.backward()
        e[2].record()
        opt.step()
        e[3].record()
        # the parts: the encoder over all B x L snapshots, the heads on the fused fields
        p = [ev() for _ in range(4)]
        p[0].record()
        dn.branch(xg).sum().backward()
        p[1].record()
        with torch.no_grad():
            fields = dn(xg, grid.reshape(-1, 2)).reshape(b, l, *grid.shape[:2])
            feats = model.fusion(grid.unsqueeze(0).expand(b, *grid.shape), fields, mask)
        p[2].record()
        sum(h(feats).sum() for h in model.heads).backward()
        p[3].record()
        torch.cuda.synchronize()
        if r:  # round 0 warms up
            for k, (i, j) in zip(split, ((e, 0), (e, 1), (e, 2), (p, 0), (p, 2))):
                split[k] += i[j].elapsed_time(i[j + 1]) / rounds
    lx, wr, wi, pk, pb = layer_inputs(MAIN_SHAPE, "cuda")
    du = torch.randn_like(lx)
    backward_ms = graph_ms(lambda: fno2d_layer_backward_plain(lx, wr, wi, pk, du), calls=5)
    backward_eager_ms = time_ms(lambda: fno2d_layer_backward_plain(lx, wr, wi, pk, du), 50)
    act = torch.randn(b * l, 64, 61, 31, device="cuda")  # the first block's output
    bn_ms = {}
    for label, cls in (("flax_running_var", BatchNorm2d), ("torch_batchnorm2d", torch.nn.BatchNorm2d)):
        bn = cls(64).to("cuda").train()
        bn_ms[label] = time_ms(lambda: bn(act), 20)
    del act
    emit("train", model="NIOFP2D", config=bench_train.CONFIG, batch=bench_train.BATCH,
         launches=counts, loss_card=card[0], loss_cpu=cpu[0],
         worst_rel_l2_encoder=max(encoder.items(), key=lambda kv: kv[1]),
         worst_rel_l2_rest=max(rest.items(), key=lambda kv: kv[1]),
         tol=f"relative L2: {TRAIN_TOL}, encoder gradients and parameters {ENCODER_TOL}",
         cpu_step_s=cpu_s, loss_bf16=loss16, bf16_loss_gap=bf16_gap,
         bf16_encoder_grad_rel_l2_from_f32=bf16_grad_gap, float16_encoder_bn32=f16,
         losses_f32_steps=[losses[0], losses[-1]], steps_per_sec=sps, step_split=split,
         fno2d_layer_backward_ms=backward_ms, fno2d_layer_backward_eager_ms=backward_eager_ms,
         fno2d_layer_backward_bound=layer_backward_bound(MAIN_SHAPE),
         fno2d_layer_forward_ms=kernel_ms, layer_shape=MAIN_SHAPE,
         batchnorm_forward_ms_400x64x61x31=bn_ms, peak_memory_gb_f32_step=peak_gb,
         nvidia_smi=smi_line)
    return counts["fno2d_layer"] + f16_launches["fno2d_layer"]


def unet_tol(key):
    """The UNet step's tolerance per entry of :func:`unet_train_errors`: the NIO's,
    ENCODER_TOL for the conv stack's gradients and parameters (its max pools play the
    part of the encoder's leaky-ReLU kinks: two entries of a window within rounding of
    each other may send the gradient to either), TRAIN_TOL for the heads, the loss and
    the running statistics."""
    conv_stack = not key.startswith(("heads.", "state heads.", "loss"))
    return ENCODER_TOL if conv_stack and "running_" not in key else TRAIN_TOL


def unet_train_errors(card, cpu):
    """Relative L2 errors of the card's UNet step against the CPU's, as
    :func:`train_errors` takes them. The gradients that are exactly zero on the CPU (the
    one-channel ConvNeXt blocks' depthwise conv and LayerNorm scale) must be exactly zero
    on the card. Raises naming every tensor out of its tolerance."""
    (loss, grads, state), (want_loss, want_grads, want_state) = card, cpu
    zero = sorted(k for k, g in want_grads.items() if not g.any())
    if not zero or any(grads[k].any() for k in zero):
        raise RuntimeError(f"train_unet: gradients exactly zero on the CPU ({zero}) are not "
                           "all zero on the card")
    errs = {"loss": abs(loss - want_loss) / abs(want_loss)}
    errs.update({k: rel_l2(grads[k], want_grads[k]) for k in want_grads if k not in zero})
    errs.update({f"state {k}": rel_l2(state[k], want_state[k]) for k in want_state})
    bad = {k: e for k, e in errs.items() if not e <= unet_tol(k)}
    if bad:
        raise RuntimeError(f"train_unet: on the card, relative L2 from the CPU beyond its "
                           f"tolerance: {bad}")
    return errs, zero


def phase_train_unet(smi_line):
    """The fpe2d UNet's training step (``train_step`` on ``PermInvUNetAttn`` at the fpe2d
    suite's config, seeded weights, randomized LayerNorms) on ``bench.py``'s batch: one
    float32 step on the card against the same step on the CPU, its launches counted;
    ten timed steps whose loss must fall; the bfloat16 ``all`` steps
    (:func:`low_precision_steps`); the step's split on the device and the host (its
    top kernels and busy time: phase ``epoch_scan``), and its peak memory. Returns its
    ``fno2d_layer`` launches."""
    from blindno_torch.tools import bench_train
    from blindno_torch.train.step import make_optimizer, train_step

    b, l = bench_train.BATCH["b"], bench_train.BATCH["l"]
    rng = np.random.default_rng(5)
    draw = (rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32))
    # LayerNorms randomized: at their init (scale 1, bias 0) each attention's tokens
    # leave with mean 0 over D, so the one-channel skip BatchNorm's running mean is
    # zero but for rounding, and the two devices' rounding is all a comparison sees
    cpu_model = bench_train.fresh_model("cpu", "unet")
    randomize_layernorms(cpu_model, np.random.default_rng(8))
    initial = copy.deepcopy(cpu_model.state_dict())
    x, y, grid = bench_train.bench_batch("cuda")

    # 1. one f32 step on the card, its launches counted, against the CPU plain path
    model = copy.deepcopy(cpu_model).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    counts, card = counted(lambda: one_step(model, x, y, grid, draw))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches("UNet training step", counts, fno2d_layer=6)
    t0 = time.perf_counter()
    cpu = one_step(cpu_model, x.cpu(), y.cpu(), grid.cpu(), draw)
    cpu_s = time.perf_counter() - t0
    errs, zero = unet_train_errors(card, cpu)
    conv_stack = {k: e for k, e in errs.items() if unet_tol(k) == ENCODER_TOL}
    rest = {k: e for k, e in errs.items() if k not in conv_stack}

    # 2. ten f32 steps on the one batch, a fresh draw each: the loss must fall
    model.load_state_dict(initial)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    step = lambda: train_step(model, opt, x, y, grid, generator=gen)
    losses, sps = timed_steps(step)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train_unet: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    # the bfloat16 step under JAX's default policy "all": the UNet ignores its grid, so it
    # computes in bfloat16 end to end, its FNO heads' kernels inside the cast; the heads'
    # gradients held (the conv stack's are chaotic in bfloat16, tests/test_torch_amp.py)
    bf16, bf16_launches = low_precision_steps(
        "train_unet", model, initial, (x, y, grid), draw, card, {"fno2d_layer": 6},
        lambda k: k.startswith("heads."))

    # 3. throughput, and the step's split: CUDA events around its forward, backward and
    # Adam, and around the set encoder's and the heads' forward and backward alone; the
    # host's time to enqueue a step (its kernels by device time: phase epoch_scan)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    split = {k: 0.0 for k in ("forward_ms", "backward_ms", "optimizer_ms", "host_enqueue_ms",
                             "features_fwd_bwd_ms", "heads_fwd_bwd_ms")}
    rounds = 3
    xg, mask = x[:, torch.as_tensor(draw[0], device="cuda")], torch.as_tensor(draw[1], device="cuda")
    for r in range(rounds + 1):
        e = [ev() for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        e[0].record()
        out = model(x, grid, subsample=draw)
        loss = torch.mean((out - y) ** 2)
        e[1].record()
        loss.backward()
        e[2].record()
        opt.step()
        e[3].record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        p = [ev() for _ in range(4)]
        p[0].record()
        model.features(xg, mask).sum().backward()
        p[1].record()
        with torch.no_grad():
            feats = model.features(xg, mask)
        p[2].record()
        sum(h(feats).sum() for h in model.heads).backward()
        p[3].record()
        torch.cuda.synchronize()
        if r:  # round 0 warms up
            split["host_enqueue_ms"] += host_ms / rounds
            for k, (i, j) in zip(("forward_ms", "backward_ms", "optimizer_ms",
                                  "features_fwd_bwd_ms", "heads_fwd_bwd_ms"),
                                 ((e, 0), (e, 1), (e, 2), (p, 0), (p, 2))):
                split[k] += i[j].elapsed_time(i[j + 1]) / rounds
    emit("train_unet", model="PermInvUNetAttn", config=bench_train.UNET_CONFIG,
         batch=bench_train.BATCH, launches=counts, loss_card=card[0], loss_cpu=cpu[0],
         worst_rel_l2_conv_stack=max(conv_stack.items(), key=lambda kv: kv[1]),
         worst_rel_l2_rest=max(rest.items(), key=lambda kv: kv[1]),
         zero_gradients=zero, tol=f"relative L2: {TRAIN_TOL}, the conv stack's gradients "
         f"and parameters {ENCODER_TOL}; exact zeros stay exact", cpu_step_s=cpu_s,
         losses_f32_steps=[losses[0], losses[-1]], steps_per_sec_f32=sps, step_split=split,
         peak_memory_gb_f32_step=peak_gb, bfloat16_all=bf16, nvidia_smi=smi_line)
    return counts["fno2d_layer"] + bf16_launches["fno2d_layer"]


def phase_train_fno(smi_line):
    """The FNO-branch NIO's training step (``train_step`` on ``NIOFNO2D`` at the fpe2d
    suite's width, seeded weights) on ``bench.py``'s batch: one float32 step on the card
    against the same step on the CPU, its 8 launches counted, the frozen fusion unchanged;
    ten timed steps whose loss must fall; the bfloat16 ``all`` steps; the step's split
    on the device and the host, its top kernels and peak memory; and the
    FNO2d layer's torch backward per call at the inner shape, from a graph and eagerly,
    beside its bound. Returns its ``fno2d_layer`` launches."""
    from blindno_torch.ops.fno_layer import fno2d_layer_backward_plain
    from blindno_torch.tools import bench_train
    from blindno_torch.train.step import make_optimizer, train_step

    b, l = bench_train.BATCH["b"], bench_train.BATCH["l"]
    rng = np.random.default_rng(5)
    draw = (rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32))
    cpu_model = bench_train.fresh_model("cpu", "fno")
    initial = copy.deepcopy(cpu_model.state_dict())
    x, y, grid = bench_train.bench_batch("cuda")

    # 1. one f32 step on the card, its launches counted, against the CPU plain path
    model = copy.deepcopy(cpu_model).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    counts, card = counted(lambda: one_step(model, x, y, grid, draw))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_launches("NIOFNO2D training step", counts, fno2d_layer=8)
    frozen = [k for k in initial if k.startswith("fusion.")]
    if not all(torch.equal(card[2][k], initial[k]) for k in frozen):
        raise RuntimeError(f"train_fno: the frozen fusion ({frozen}) moved in a step")
    t0 = time.perf_counter()
    cpu = one_step(cpu_model, x.cpu(), y.cpu(), grid.cpu(), draw)
    cpu_s = time.perf_counter() - t0
    errs = train_errors(card, cpu)

    # 2. ten f32 steps on the one batch, a fresh draw each: the loss must fall
    model.load_state_dict(initial)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    step = lambda: train_step(model, opt, x, y, grid, generator=gen)
    losses, sps = timed_steps(step)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train_fno: loss did not fall over {TRAIN_STEPS} steps: {losses}")
    # the bfloat16 step under "all": the float32 grid promotes the inner FNO2d's input, so
    # every kernel runs on float32 activations and bfloat16-valued weights; every
    # gradient held (the frozen fusion has none)
    bf16, bf16_launches = low_precision_steps(
        "train_fno", model, initial, (x, y, grid), draw, card, {"fno2d_layer": 8},
        lambda k: True)

    # 3. throughput, and the step's split: CUDA events around its forward, backward and
    # Adam, and around the inner FNO2d's and the heads' forward and backward alone; the
    # host's time to enqueue a step; its kernels by device time in a profiler trace
    ev = lambda: torch.cuda.Event(enable_timing=True)
    split = {k: 0.0 for k in ("forward_ms", "backward_ms", "optimizer_ms", "host_enqueue_ms",
                             "inner_fno2d_fwd_bwd_ms", "heads_fwd_bwd_ms")}
    rounds = 3
    xg, mask = x[:, torch.as_tensor(draw[0], device="cuda")], torch.as_tensor(draw[1], device="cuda")
    grid_feats = grid.unsqueeze(0).expand(b, *grid.shape)
    for r in range(rounds + 1):
        e = [ev() for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        e[0].record()
        out = model(x, grid, subsample=draw)
        loss = torch.mean((out - y) ** 2)
        e[1].record()
        loss.backward()
        e[2].record()
        opt.step()
        e[3].record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        p = [ev() for _ in range(4)]
        p[0].record()
        model.fields(xg, grid).sum().backward()
        p[1].record()
        with torch.no_grad():
            feats = model.fusion(grid_feats, model.fields(xg, grid), mask)
        p[2].record()
        sum(h(feats).sum() for h in model.heads).backward()
        p[3].record()
        torch.cuda.synchronize()
        if r:  # round 0 warms up
            split["host_enqueue_ms"] += host_ms / rounds
            for k, (i, j) in zip(("forward_ms", "backward_ms", "optimizer_ms",
                                  "inner_fno2d_fwd_bwd_ms", "heads_fwd_bwd_ms"),
                                 ((e, 0), (e, 1), (e, 2), (p, 0), (p, 2))):
                split[k] += i[j].elapsed_time(i[j + 1]) / rounds
    del out, loss, feats
    split["top_kernels_ms"] = top_kernels(step)  # "all": the device's busy time in a step

    # 4. the layer's torch backward at the inner shape, from a graph and eagerly
    lx, wr, wi, pk, pb = layer_inputs(NIOFNO2D_INNER, "cuda")
    du = torch.randn_like(lx)
    backward = lambda: fno2d_layer_backward_plain(lx, wr, wi, pk, du)
    backward_ms = graph_ms(backward, calls=5)
    backward_eager_ms, backward_host_ms = time_ms(backward, 20, host=True)
    del lx, du
    emit("train_fno", model="NIOFNO2D", config=bench_train.FNO_CONFIG, batch=bench_train.BATCH,
         launches=counts, loss_card=card[0], loss_cpu=cpu[0],
         worst_rel_l2=sorted(errs.items(), key=lambda kv: -kv[1])[:3],
         tol=f"relative L2: {TRAIN_TOL}", frozen_fusion_unchanged=frozen, cpu_step_s=cpu_s,
         losses_f32_steps=[losses[0], losses[-1]], steps_per_sec_f32=sps, step_split=split,
         peak_memory_gb_f32_step=peak_gb, bfloat16_all=bf16,
         fno2d_layer_backward_ms=backward_ms,
         fno2d_layer_backward_eager_ms=backward_eager_ms,
         fno2d_layer_backward_host_ms=backward_host_ms,
         fno2d_layer_backward_bound=layer_backward_bound(NIOFNO2D_INNER),
         layer_shape=NIOFNO2D_INNER, nvidia_smi=smi_line)
    return counts["fno2d_layer"] + bf16_launches["fno2d_layer"]


def randomize_transolver(model, sets, grid, rng):
    """The Transolver's weights drawn at random, as ``tests/test_torch_transolver.py``
    draws them (weights ~ N(0, 1/fan_in), LayerNorm scales ~ U(0.6, 1.4), biases ~
    N(0, 0.1), temperatures ~ U(0.3, 1)): flax's init leaves the slice attention's output
    near 1e-4 of its input, where a fault would hide. ``sets`` and ``grid`` are unused
    (the signature of :func:`calibrate_bn`)."""
    with torch.no_grad():
        for name, p in model.trans.named_parameters():
            if name.endswith("temperature"):
                draw = rng.uniform(0.3, 1.0, p.shape)
            elif p.dim() > 1:
                draw = rng.standard_normal(p.shape) / math.sqrt(p[0].numel())
            elif ".norms." in name and name.endswith("weight"):
                draw = rng.uniform(0.6, 1.4, p.shape)
            else:
                draw = 0.1 * rng.standard_normal(p.shape)
            p.copy_(torch.tensor(draw))


TRANS_MODELS = {"trans": "NIOTrans2D", "trans_attn": "NIOTransAttn2D"}
# the sets of bench.py's batch in phase trans's step checked against the CPU (the first
# one; a Transolver step on all four took 26.6-26.7 s of the card host's CPU), and the
# batch of its timed steps, all four
TRANS_CHECK_SETS = 1


def trans_draw(l):
    """The injected subsample of phase ``trans``'s step: (indices, mask)."""
    rng = np.random.default_rng(5)
    return rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32)


def trans_step_model(name):
    """Phase ``trans``'s model to train, on the CPU: the suite's config from seed 0,
    the Transolver's weights drawn at random."""
    from blindno_torch.tools import bench_train

    model = bench_train.fresh_model("cpu", name)
    randomize_transolver(model, None, None, np.random.default_rng(8))
    return model


def trans_serve_reference(name):
    """On the CPU: the served Transolver NIO's output on its first batch of sets, and
    the seconds it took."""
    from blindno_torch.eval.field_eval import predict_fields
    from blindno_torch.models import nio2d
    from blindno_torch.tools import bench_train

    t0 = time.perf_counter()
    cpu_model, inputs, grid = served_model(getattr(nio2d, TRANS_MODELS[name]),
                                           bench_train.MODELS[name][1], SERVE,
                                           randomize_transolver)
    k = SERVE["batch"]
    out = predict_fields(cpu_model, inputs[:k], grid, batch=k, device="cpu")
    return out, time.perf_counter() - t0


def trans_step_reference(name):
    """On the CPU: phase ``trans``'s checked training step (:func:`one_step` on the first
    TRANS_CHECK_SETS sets of ``bench.py``'s batch) and its seconds."""
    from blindno_torch.tools import bench_train

    model = trans_step_model(name)
    x, y, grid = bench_train.bench_batch("cpu")
    k = TRANS_CHECK_SETS
    t0 = time.perf_counter()
    loss, grads, state = one_step(model, x[:k], y[:k], grid, trans_draw(bench_train.BATCH["l"]))
    # numpy arrays: torch tensors would cross through shared memory, which may be small
    as_numpy = lambda d: {k: v.numpy() for k, v in d.items()}
    return (loss, as_numpy(grads), as_numpy(state)), time.perf_counter() - t0


def padded_nio():
    """Phase ``padded``'s model class: NIOFP2D with PADDING_FRAC on its FNO2d heads."""
    from blindno_torch.models import nio2d

    return functools.partial(nio2d.NIOFP2D, padding_frac=PADDING_FRAC)


def padded_serve_reference():
    """On the CPU: the padded NIOFP2D's output on the first PADDED_CHECK_SETS of PADDED's
    sets (the model and sets of :func:`served_model`), and the seconds it took."""
    from blindno_torch.eval.field_eval import predict_fields

    t0 = time.perf_counter()
    cpu_model, inputs, grid = served_model(padded_nio(), MODEL, PADDED, calibrate_bn)
    k = PADDED_CHECK_SETS
    out = predict_fields(cpu_model, inputs[:k], grid, batch=k, device="cpu")
    return out, time.perf_counter() - t0


def padded_step_reference():
    """On the CPU: phase ``padded``'s training step (:func:`one_step` of the padded
    NIOFP2D from seed 0 on the first PADDED_CHECK_SETS sets of ``bench.py``'s batch) and
    its seconds."""
    from blindno_torch.tools import bench_train

    model = padded_nio()(**bench_train.CONFIG, generator=torch.Generator().manual_seed(0),
                         device="cpu").train()
    x, y, grid = bench_train.bench_batch("cpu")
    k = PADDED_CHECK_SETS
    t0 = time.perf_counter()
    loss, grads, state = one_step(model, x[:k], y[:k], grid, trans_draw(bench_train.BATCH["l"]))
    as_numpy = lambda d: {k: v.numpy() for k, v in d.items()}
    return (loss, as_numpy(grads), as_numpy(state)), time.perf_counter() - t0


def phase_padded(smi_line, refs):
    """NIOFP2D at ``bench.py``'s config with ``padding_frac=2.0`` on both FNO2d heads, a
    model the JAX registry builds whose padded grid (183 x 183) the 2-D kernel takes in
    its tiled layout: served through ``predict_fields`` on PADDED's sets (6 launches a
    forward, every one at PADDED_HEADS), the first PADDED_CHECK_SETS against the CPU,
    then one float32 ``train_step``
    on the first PADDED_CHECK_SETS sets of ``bench.py``'s batch (the forward kernel inside
    ``FNO2dLinear``, 6 launches) against the CPU's step within phase ``train``'s
    tolerances. The CPU's output and step are ``refs``' futures
    (:func:`submit_cpu_references`). Returns the ``fno2d_layer`` launches."""
    from blindno_torch.tools import bench_train

    cpu_model, inputs, grid = served_model(padded_nio(), MODEL, PADDED, calibrate_bn)
    head = cpu_model.heads[0]
    padded = tuple(head.lift(torch.zeros(1, *grid.shape[:2], head.fc0.in_features)).shape[2:])
    if padded != PADDED_HEADS[2:4]:
        raise RuntimeError(f"padded: the heads' grid is {padded}, want {PADDED_HEADS[2:4]}")
    _, counts, fields = serve("NIOFP2D padding_frac=2.0", cpu_model, inputs, grid,
                              PADDED["batch"], 1, "fno2d_layer", 2 * MODEL["fno_layers"],
                              cpu_reference=refs["serve"].result, cpu_sets=PADDED_CHECK_SETS)
    launches = counts["fno2d_layer"]

    model = padded_nio()(**bench_train.CONFIG, generator=torch.Generator().manual_seed(0),
                         device="cuda").train()
    x, y, grid = bench_train.bench_batch("cuda")
    k = PADDED_CHECK_SETS
    counts, card = counted(lambda: one_step(model, x[:k], y[:k], grid,
                                            trans_draw(bench_train.BATCH["l"])))
    expect_launches("padded NIOFP2D training step", counts, fno2d_layer=6)
    launches += counts["fno2d_layer"]
    (loss_cpu, grads_cpu, state_cpu), cpu_s = refs["step"].result()
    as_torch = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    errs = train_errors(card, (loss_cpu, as_torch(grads_cpu), as_torch(state_cpu)))
    emit("padded", model="NIOFP2D", config=MODEL, padding_frac=PADDING_FRAC,
         layer_shape=PADDED_HEADS, serve=fields, train_sets=k, train_launches=counts,
         loss_card=card[0], loss_cpu=loss_cpu,
         worst_rel_l2=sorted(errs.items(), key=lambda kv: -kv[1])[:3],
         tol=f"relative L2: {TRAIN_TOL}, encoder gradients and parameters {ENCODER_TOL}",
         cpu_step_s=cpu_s, nvidia_smi=smi_line)
    return launches


def submit_cpu_references(pool):
    """Queue the CPU references of phases ``train``, ``padded``, ``trans``, ``jax_ckpt``
    and ``datagen`` on ``pool``'s workers, in that order: NIOFP2D's training step, the
    padded NIOFP2D's served output and training step, each Transolver NIO's served output
    and training step, each committed checkpoint's served batch, each suite's generator
    run."""
    return {"train": pool.submit(train_step_reference),
            "padded": {"serve": pool.submit(padded_serve_reference),
                       "step": pool.submit(padded_step_reference)},
            "serve": {name: pool.submit(trans_serve_reference, name) for name in TRANS_MODELS},
            "step": {name: pool.submit(trans_step_reference, name) for name in TRANS_MODELS},
            "jax_ckpt": {name: pool.submit(jax_ckpt_reference, name)
                         for name in jax_ckpt_names()},
            "datagen": {suite: pool.submit(datagen_reference, suite, m, 0)
                        for suite, (m, _) in DATAGEN.items()}}


def phase_trans(smi_line, refs):
    """The Transolver NIOs (``NIOTrans2D``, ``NIOTransAttn2D``) at the fpe2d suite's
    config: served on SERVE's sets through ``predict_fields`` (Transolver weights drawn
    at random), against the CPU, timed and split on the device between the attention,
    the fusion and the heads, with peak memory; then one float32
    ``train_step`` on the first TRANS_CHECK_SETS sets of ``bench.py``'s batch against the
    CPU's step, 6 ``fno2d_layer`` launches counted, the frozen fusion unchanged, and ten
    steps on the whole batch whose loss must fall, timed. The CPU's outputs and steps are
    ``refs``' futures (:func:`submit_cpu_references`). Returns their ``fno2d_layer``
    launches."""
    from blindno_torch.models import nio2d
    from blindno_torch.tools import bench_train
    from blindno_torch.train.step import make_optimizer, train_step

    served, stepped = refs["serve"], refs["step"]
    launches = 0
    # the attention model's Transolver, fusion and heads are the plain one's: its split
    # times the attention alone. The forward's and the Transolver's graph times and top
    # kernels are PERF.md's (section 5, PR 13)
    for name, parts_of in (("trans", ("fusion", "heads")),
                           ("trans_attn", ("attention",))):
        cls, config = getattr(nio2d, TRANS_MODELS[name]), bench_train.MODELS[name][1]
        torch.cuda.reset_peak_memory_stats()
        counts, fields, split = serve_split(f"fpe2d {cls.__name__}", cls, config, SERVE, 6,
                                            1e-5, prepare=randomize_transolver,
                                            parts_of=parts_of,
                                            cpu_reference=served[name].result)
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launches += counts["fno2d_layer"]

        draw = trans_draw(bench_train.BATCH["l"])
        cpu_model = trans_step_model(name)
        initial = copy.deepcopy(cpu_model.state_dict())
        x, y, grid = bench_train.bench_batch("cuda")
        model = cpu_model.to("cuda")
        torch.cuda.reset_peak_memory_stats()
        k = TRANS_CHECK_SETS
        counts, card = counted(lambda: one_step(model, x[:k], y[:k], grid, draw))
        expect_launches(f"{cls.__name__} training step", counts, fno2d_layer=6)
        launches += counts["fno2d_layer"]
        frozen = [k for k in initial if k.startswith("fusion.")]
        if not all(torch.equal(card[2][k], initial[k]) for k in frozen):
            raise RuntimeError(f"trans: the frozen fusion ({frozen}) moved in a step")
        (loss_cpu, grads_cpu, state_cpu), cpu_s = stepped[name].result()
        as_torch = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
        cpu = (loss_cpu, as_torch(grads_cpu), as_torch(state_cpu))
        errs = train_errors(card, cpu)

        # ten f32 steps on the one batch, a fresh draw each: the loss must fall
        model.load_state_dict(initial)
        opt = make_optimizer(model)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.reset_peak_memory_stats()
        train_step(model, opt, x, y, grid, generator=gen)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts, losses = counted(lambda: [train_step(model, opt, x, y, grid, generator=gen)
                                          for _ in range(TRAIN_STEPS)])
        losses = [float(v) for v in losses]
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expect_launches(f"{cls.__name__} training steps", counts, fno2d_layer=6 * TRAIN_STEPS)
        launches += counts["fno2d_layer"]
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"trans: loss did not fall over {TRAIN_STEPS} steps: {losses}")
        emit("trans", model=cls.__name__, config=config, serve=fields, device_split=split,
             serve_peak_memory_gb=serve_peak_gb, train_batch=bench_train.BATCH,
             train_launches_per_step=counts["fno2d_layer"] / TRAIN_STEPS,
             loss_card=card[0], loss_cpu=cpu[0],
             worst_rel_l2=sorted(errs.items(), key=lambda kv: -kv[1])[:3],
             tol=f"relative L2: {TRAIN_TOL}", frozen_fusion_unchanged=frozen, cpu_step_s=cpu_s,
             losses_f32_steps=[losses[0], losses[-1]], steps_per_sec_f32=TRAIN_STEPS / wall,
             peak_memory_gb_f32_step=peak_gb, nvidia_smi=smi_line)
        del model, opt
    return launches


def fno_layer_calls(model):
    """The FNO-layer calls of one forward of ``model``, by kernel: one per spectral layer
    of each FNO1d and FNO2d module (the heads, and an FNO-branch NIO's inner branch)."""
    from blindno_torch.nn.fno import FNO1d, FNO2d

    calls = {"fno1d_layer": 0, "fno2d_layer": 0}
    for m in model.modules():
        if isinstance(m, (FNO1d, FNO2d)):
            calls["fno1d_layer" if isinstance(m, FNO1d) else "fno2d_layer"] += len(m.spectral)
    return calls


def masked_train_errors(label, card, cpu, tol, grads64):
    """Relative L2 errors of a 1-D model's step on the card against the CPU's, as
    :func:`train_errors` takes them, each within ``tol(key)``. Gradients exactly zero on
    the CPU (the frozen fusion has none; the one-channel ConvNeXt blocks') stay exactly
    zero on the card, and gradients zero but for rounding (a whole tensor below 1e-6 of
    the largest gradient: the conv biases before a BatchNorm) stay below it on both
    sides. After the step, a parameter is compared where its gradient is not within
    rounding of zero (its entries from 1e-6 of the tensor's largest up): Adam's first
    step moves the others by about lr with the rounding's sign, and the trunk's biases,
    which start at zero, have such entries (a unit whose input keeps one sign over the
    1-D grid, so that its bias only shifts what the BatchNorm after it centres).

    A gradient beyond ``tol(key)`` but within ENCODER_TOL passes only where float32
    itself is ill-conditioned there: ``grads64()`` gives the CPU's float64 gradients, and
    the card's must lie no further from them than ``tol(key)`` or 1.5 times the CPU's
    float32 gradient does (the NIO's trunk takes a one-dimensional grid: every unit of
    its first layer is linear in x and the BatchNorms erase each unit of the second that
    keeps one sign over the grid, so that its first layers' gradients are what survives a
    cancellation). Returns the errors, the count of parameter entries left out after the
    step and each such gradient's (card to CPU, card to float64, CPU to float64); raises
    naming every tensor out of its tolerance."""
    (loss, grads, state), (want_loss, want_grads, want_state) = card, cpu
    zero = sorted(k for k, g in want_grads.items() if not g.any())
    if any(grads[k].any() for k in zero):
        raise RuntimeError(f"{label}: gradients exactly zero on the CPU ({zero}) are not all "
                           "zero on the card")
    top = max(float(g.abs().max()) for g in want_grads.values())
    rounding = [k for k, g in want_grads.items() if k not in zero and g.abs().max() < 1e-6 * top]
    worst = max((float(g.abs().max()) for k in rounding for g in (grads[k], want_grads[k])),
                default=0.0)
    if worst >= 1e-6 * top:
        raise RuntimeError(f"{label}: a gradient within rounding of zero on the CPU "
                           f"({rounding}) is {worst:.3g} on the card, want < 1e-6 x {top:.3g}")
    errs, left_out = {"loss": abs(loss - want_loss) / abs(want_loss)}, 0
    for k, g in want_grads.items():
        if k in zero:
            continue
        if k in rounding:
            errs[f"state {k}"] = rel_l2(state[k], want_state[k])
            continue
        kept = g.abs() >= 1e-6 * g.abs().max()
        left_out += int((~kept).sum())
        errs[k] = rel_l2(grads[k], g)
        errs[f"state {k}"] = rel_l2(state[k][kept], want_state[k][kept])
    errs.update({f"state {k}": rel_l2(state[k], want_state[k]) for k in want_state
                 if k not in want_grads or k in zero})
    bad = {k: e for k, e in errs.items() if not e <= tol(k)}
    conditioned = {}
    if bad and all(k in want_grads and e <= ENCODER_TOL for k, e in bad.items()):
        g64 = grads64()
        conditioned = {k: (e, rel_l2(grads[k], g64[k]), rel_l2(want_grads[k], g64[k]))
                       for k, e in bad.items()}
        bad = {k: e for k, (e, card64, cpu64) in conditioned.items()
               if not card64 <= max(tol(k), 1.5 * cpu64)}
    if bad:
        raise RuntimeError(f"{label}: on the card, relative L2 from the CPU beyond its "
                           f"tolerance: {bad} ((card to CPU, card to float64, CPU to "
                           f"float64): {conditioned})")
    return errs, left_out, conditioned


def float64_grads(model, state, x, y, grid, draw):
    """The gradients of one step's loss for ``model`` from ``state`` in float64 on the
    CPU, the same draw and batch: the reference that tells float32's own rounding from a
    fault."""
    model = copy.deepcopy(model)
    model.load_state_dict(state)
    model.double().train()
    out = model(x.cpu().double(), grid.cpu().double(), subsample=draw)
    torch.mean((out - y.cpu().double()) ** 2).backward()
    return {k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None}


def train1d_tol(model):
    """The 1-D step's tolerance per entry of :func:`masked_train_errors`: the NIO's as
    :func:`train_tol` (ENCODER_TOL in its Encoder1D), the UNet's as :func:`unet_tol`,
    TRAIN_TOL everywhere in the FNO-branch NIO (no conv, no kink but gelu's)."""
    return {"nio": train_tol, "unet": unet_tol}.get(model, lambda key: TRAIN_TOL)


def adam_rewrites_weights_ab(shape, steps=8):
    """A/B of the 1-D layer in training with its weights written right before each call:
    ``steps`` steps of three layers (gelu between them) at ``shape`` (B, C, N, modes,
    dc_half), Adam's kernels and then a ``torch.mul`` writing every weight, pk and pb
    right before each forward layer call, through the kernel (A) and through the plain
    layer (B) from the same start on the card. The kernel starts while the kernel
    before it runs (programmatic dependent launch); a call that read its weights before
    ``griddepcontrol.wait`` would train on stale ones. Returns the worst relative L2
    between A's and B's parameters after the steps. A check against the plain version:
    its launches do not count as the path's."""
    from blindno_torch.ops.fno_layer import fno1d_layer_plain
    from blindno_torch.ops.spectral_cuda import fno1d_layer_cuda

    b, c, n, m, dc_half = shape
    rng = np.random.default_rng(5)
    t = lambda *sz, scale=1.0: torch.tensor((scale * rng.standard_normal(sz)).astype(np.float32),
                                            device="cuda")
    start = [(t(c, c, m, scale=0.1), t(c, c, m, scale=0.1), t(c, c, scale=c ** -0.5), t(c))
             for _ in range(3)]
    x, target = t(b, c, n), t(b, c, n)

    def run(layer):
        params = [[p.clone().requires_grad_() for p in lp] for lp in start]
        opt = torch.optim.Adam([p for lp in params for p in lp], lr=1e-3)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            h = x
            for i, lp in enumerate(params):
                wr, wi, pk_t, pb = (torch.mul(p, 1.0) for p in lp)
                h = layer(h, wr, wi, pk_t.t(), pb, dc_half, i < 2)
            loss = torch.mean((h - target) ** 2)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        return torch.stack(losses).cpu(), [p.detach() for lp in params for p in lp]

    counts, (losses, got) = counted(lambda: run(fno1d_layer_cuda))
    expect_launches("train1d A/B", counts, fno1d_layer=3 * steps)
    want_losses, want = run(fno1d_layer_plain)
    worst = max(rel_l2(a, w) for a, w in zip(got, want))
    loss_gap = float(((losses - want_losses).abs() / want_losses.abs()).max())
    if not (worst <= 3e-4 and loss_gap <= 3e-4):
        raise RuntimeError(f"train1d A/B: the kernel's run drifts from the plain layer's: "
                           f"parameters {worst:.3g}, losses {loss_gap:.3g} (want <= 3e-4)")
    return dict(shape=shape, steps=steps, worst_param_rel_l2=worst, worst_loss_rel=loss_gap,
                tol=3e-4)


def phase_train1d(smi_line):
    """The 1-D training step (``train_step``) of the fpe1d suite's NIOFP1D, NIOFNO1D and
    BlinDNO UNet (``blindno_torch.suites.registry``, full width, seeded weights, the
    UNet's LayerNorms randomized) on the suite's batch of 32 sets of 100 snapshots of 80
    points (numpy seed 0): one float32 step on the card against the same step on the
    CPU, its ``fno1d_layer`` launches counted exactly (the layer's forward in
    ``FNO1dLinear``; its backward is torch); ten timed steps whose loss must fall (and
    for NIOFNO1D the bfloat16 ``all`` steps of :func:`low_precision_steps`); the step's
    forward, backward and Adam by
    CUDA events, the host's time to enqueue a step against the device's busy time, peak
    memory. Then the A/B of weights written by Adam right before each layer call, and
    the layer's torch backward at the heads' and branch's training shapes, from a graph
    and eagerly, beside its bound. Returns its ``fno1d_layer`` launches."""
    from blindno_torch.ops.fno_layer import fno1d_layer_backward_plain
    from blindno_torch.tools import bench_train
    from blindno_torch.train.step import make_optimizer, train_step

    suite = "fpe1d"
    l = bench_train.BATCHES_1D[suite]["l"]
    x, y, grid = bench_train.bench_batch("cuda", suite)
    launches = 0
    for name, want_calls in TRAIN_1D.items():
        rng = np.random.default_rng(5)
        draw = (rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32))
        cpu_model = bench_train.fresh_model("cpu", name, suite)
        randomize_layernorms(cpu_model, np.random.default_rng(8))
        initial = copy.deepcopy(cpu_model.state_dict())
        calls = fno_layer_calls(cpu_model)["fno1d_layer"]
        if calls != want_calls:
            raise RuntimeError(f"train1d {name}: {calls} FNO1d layer calls a forward, "
                               f"want {want_calls}")

        # 1. one f32 step on the card, its launches counted, against the CPU plain path
        model = copy.deepcopy(cpu_model).to("cuda")
        torch.cuda.reset_peak_memory_stats()
        counts, card = counted(lambda: one_step(model, x, y, grid, draw))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expect_launches(f"1-D training step {name}", counts, fno1d_layer=calls)
        launches += counts["fno1d_layer"]
        t0 = time.perf_counter()
        cpu = one_step(cpu_model, x.cpu(), y.cpu(), grid.cpu(), draw)
        cpu_s = time.perf_counter() - t0
        tol = train1d_tol(name)
        errs, left_out, conditioned = masked_train_errors(
            f"train1d {name}", card, cpu, tol,
            lambda: float64_grads(cpu_model, initial, x, y, grid, draw))
        loose = {k: e for k, e in errs.items() if tol(k) > TRAIN_TOL}
        rest = {k: e for k, e in errs.items() if k not in loose}

        # 2. ten f32 steps on the one batch, a fresh draw each: the loss must fall
        model.load_state_dict(initial)
        opt = make_optimizer(model, 1e-3)
        gen = torch.Generator(device="cuda").manual_seed(2)
        step = lambda: train_step(model, opt, x, y, grid, generator=gen)
        losses, sps = timed_steps(step)
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"train1d {name}: loss did not fall over {TRAIN_STEPS} steps: "
                               f"{losses}")
        # NIOFNO1D in bfloat16 under "all": its kernels at (32, 30, 100) and (3200, 4, 100)
        # inside the cast, every gradient held
        bf16 = None
        if name == "fno":
            bf16, bf16_launches = low_precision_steps(
                "train1d fno", model, initial, (x, y, grid), draw, card, {"fno1d_layer": calls},
                lambda k: True, lr=1e-3)
            launches += bf16_launches["fno1d_layer"]

        # 3. the step's split: CUDA events around its
        # forward, backward and Adam; the host's time to enqueue a step; the device's busy
        # time in a step (the sum of its kernels in a profiler trace)
        ev = lambda: torch.cuda.Event(enable_timing=True)
        split = {k: 0.0 for k in ("forward_ms", "backward_ms", "optimizer_ms", "host_enqueue_ms")}
        rounds = 3
        for r in range(rounds + 1):
            e = [ev() for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            e[0].record()
            out = model(x, grid, subsample=draw)
            loss = torch.mean((out - y) ** 2)
            e[1].record()
            loss.backward()
            e[2].record()
            opt.step()
            e[3].record()
            host_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            if r:  # round 0 warms up
                split["host_enqueue_ms"] += host_ms / rounds
                for k, j in zip(("forward_ms", "backward_ms", "optimizer_ms"), range(3)):
                    split[k] += e[j].elapsed_time(e[j + 1]) / rounds
        del out, loss
        split["top_kernels_ms"] = top_kernels(step)  # "all": the device's busy time in a step
        emit("train1d", suite=suite, model=name, cls=type(model).__name__,
             batch=bench_train.BATCHES_1D[suite], launches=counts,
             fno1d_layer_calls_per_forward=calls, loss_card=card[0], loss_cpu=cpu[0],
             worst_rel_l2_encoder=max(loose.items(), key=lambda kv: kv[1], default=None),
             worst_rel_l2_rest=max(rest.items(), key=lambda kv: kv[1]),
             parameter_entries_left_out_after_the_step=left_out,
             ill_conditioned_card_cpu_card64_cpu64=conditioned,
             tol=f"relative L2: {TRAIN_TOL}, {ENCODER_TOL} for the conv encoders' gradients "
             "and parameters; exact zeros stay exact", cpu_step_s=cpu_s,
             losses_f32_steps=[losses[0], losses[-1]], steps_per_sec_f32=sps, step_split=split,
             peak_memory_gb_f32_step=peak_gb, bfloat16_all=bf16, nvidia_smi=smi_line)
        del model, opt, cpu_model

    # 4. the A/B of weights written right before each layer call, and the layer's torch
    # backward at the training shapes
    ab = adam_rewrites_weights_ab(TRAIN_HEADS_1D)
    backward = {}
    for label, shape in (("heads", TRAIN_HEADS_1D), ("branch", TRAIN_BRANCH_1D)):
        lx, wr, wi, pk, _, dc_half = layer_inputs(shape, "cuda")
        du = torch.randn_like(lx)
        fn = lambda: fno1d_layer_backward_plain(lx, wr, wi, pk, du, dc_half)
        eager_ms, host_ms = time_ms(fn, 20, host=True)
        backward[label] = dict(shape=shape, graph_ms=graph_ms(fn, calls=5), eager_ms=eager_ms,
                               host_ms=host_ms, bound=layer_backward_bound(shape[:4]))
    emit("train1d", adam_rewrites_weights_ab=ab, fno1d_layer_backward=backward,
         nvidia_smi=smi_line)
    return launches


def fpe2d_archive(m, l, n, rng):
    """A synthetic fpe2d archive in the JAX datagen's keys and raw magnitudes
    (trajectories (m, l, n, n) ~ 1e-10, potential ~ 1e-21 and drag ~ 1e-6 (m, n, n)): a
    Gaussian well per set, snapshots that sharpen towards it, plus noise."""
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    c = rng.uniform(-0.5, 0.5, (m, 2, 1, 1))
    well = np.exp(-((gx - c[:, 0]) ** 2 + (gy - c[:, 1]) ** 2) / 0.2).astype(np.float32)
    t = rng.uniform(0.2, 1.0, (m, l, 1, 1)).astype(np.float32)
    traj = well[:, None] ** t + 0.05 * rng.random((m, l, n, n), dtype=np.float32)
    return {"trajectories": traj * np.float32(1e-10), "potential": -well * np.float32(1e-21),
            "drag": (1 + 0.3 * well + 0.05 * rng.random((m, n, n), dtype=np.float32))
            * np.float32(1e-6)}


def ncfpe2d_archive(m, l, n, rng):
    """A synthetic ncfpe2d archive in the JAX datagen's keys and raw magnitudes
    (trajectories (m, l, n, n) ~ 1e-10, the force F (m, 2, n, n) ~ 1e-12): a spiral force
    about a random centre per set, snapshots of a blob drifting along it, plus noise."""
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    c = rng.uniform(-0.3, 0.3, (m, 2, 1, 1))
    a = rng.uniform(0.2, 1.0, (m, 1, 1))
    dx, dy = (gx - c[:, 0]).astype(np.float32), (gy - c[:, 1]).astype(np.float32)
    force = np.stack([-dy - a * dx, dx - a * dy], axis=1).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (m, l, 1, 1)).astype(np.float32)
    r = (dx[:, None] - 0.3 * np.cos(3 * t)) ** 2 + (dy[:, None] - 0.3 * np.sin(3 * t)) ** 2
    traj = np.exp(-r / 0.1) + 0.05 * rng.random((m, l, n, n), dtype=np.float32)
    return {"trajectories": traj * np.float32(1e-10), "F": force * np.float32(1e-12)}


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def timed_calls(seconds):
    """Wrap a function so that each call adds its wall seconds to ``seconds``."""
    def wrap(fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds.append(time.perf_counter() - t0)
        return call
    return wrap


def sync_free(fn, syncs):
    """Wrap ``fn`` so that each call runs under ``torch.cuda.set_sync_debug_mode("warn")``
    and adds the message of every host synchronization it makes to ``syncs``."""
    def call(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.extend(str(w.message) for w in caught
                             if "called a synchronizing" in str(w.message))
    return call


def cli_stage(workdir, suite, model, *argv):
    """One stage of the suites CLI for ``model`` of ``suite`` on the card, its launches
    counted and its stdout kept: (counts, result, wall seconds, start time)."""
    from blindno_torch.suites.run import main as cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        counts, res = counted(lambda: cli(["--suite", suite, "--model", model,
                                           "--workdir", workdir, *argv]))
    return counts, res, time.perf_counter() - t0, t0


def eval_vs_cpu(workdir, spec, model, tta=False):
    """The first FIT["cpu_sets"] predictions of the eval stage against the CPU plain path
    on the same ``best_*`` checkpoint, each field relative to its scale; with ``tta``,
    also the symmetry-averaged predictions of those sets on the card against the CPU's
    (normalized, each field relative to its scale). Returns the errors, the CPU's
    seconds, the normalized test inputs and the checkpoint."""
    from blindno_torch.eval.field_eval import (cached_train_stats, denormalize_predictions,
                                               normalized_test_inputs, predict_fields,
                                               predict_fields_tta)
    from blindno_torch.train import checkpoint

    stats = cached_train_stats(spec, workdir)
    with np.load(os.path.join(workdir, "data", spec.test_file)) as z:
        inputs = normalized_test_inputs(stats, z)
    k = FIT["cpu_sets"]
    best = checkpoint.load_best(os.path.join(workdir, "ckpt", f"{spec.name}_{model}"))
    cpu_model = spec.models[model](device="cpu")
    cpu_model.load_state_dict({**best["params"], **best["batch_stats"]})
    t0 = time.perf_counter()
    want = denormalize_predictions(spec, stats, predict_fields(cpu_model, inputs[:k], spec.grid,
                                                               batch=k, device="cpu"))
    cpu_s = time.perf_counter() - t0
    got = np.load(os.path.join(workdir, "eval", f"{spec.name}_{model}", "predictions.npy"))[:k]
    pairs = {"plain": (got, want)}
    if tta:
        card_model = spec.models[model](device="cuda")
        card_model.load_state_dict({**best["params"], **best["batch_stats"]})
        kind = spec.train_cfg.augment
        pairs["tta"] = tuple(predict_fields_tta(m, inputs[:k], spec.grid, kind, batch=k,
                                                device=dev)
                             for m, dev in ((card_model, "cuda"), (cpu_model, "cpu")))
    err = {}
    for label, (a, b) in pairs.items():
        scales = [float(np.abs(b[..., f]).max()) for f in range(b.shape[-1])]
        err[label] = [check_close(f"fit: {spec.name} {model} eval predictions ({label}), "
                                  f"field {f}, vs the CPU plain path",
                                  torch.tensor(a[..., f]), torch.tensor(b[..., f]), SERVE_TOL,
                                  scales[f]) / scales[f] for f in range(b.shape[-1])]
    return (err if tta else err["plain"]), cpu_s, inputs, best


def eval_batch():
    """The eval stage's batch: ``evaluate_suite_model``'s default, not the suite's
    training batch."""
    import inspect

    from blindno_torch.eval.field_eval import evaluate_suite_model

    return inspect.signature(evaluate_suite_model).parameters["batch"].default


def trees_equal(got, want) -> bool:
    """Whether two flax trees (nested dicts of numpy arrays, ints and floats) are equal
    bit for bit: keys, types, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            trees_equal(got[k], want[k]) for k in want)
    if isinstance(want, (int, float)):
        return type(got) is type(want) and got == want
    bits = lambda a: a.reshape(-1).view(f"u{a.dtype.itemsize}")  # NaN equal to itself
    return (isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(bits(got), bits(want)))


@contextlib.contextmanager
def recorded_optimizers():
    """(model, optimizer) of each optimizer that ``train_model`` makes while the context
    is open, in order."""
    from blindno_torch.train import loop

    made, make = [], loop.make_optimizer

    def record(model, *args, **kwargs):
        made.append((model, make(model, *args, **kwargs)))
        return made[-1][1]

    with patched(loop, "make_optimizer", record):
        yield made


def check_written(label, ckpt_dir, res, trained):
    """The checkpoints that a run of ``train_model`` (its ``TrainResult`` ``res``, and
    ``trained``, its model and Adam as :func:`recorded_optimizers` gives them) left in
    ``ckpt_dir``, read back by the port's own reader
    (``jax_checkpoint.read_orbax``, ``read_msgpack``) and held bit for bit against the
    trained state: the one ``best_*``, an orbax directory, against the flax trees of the
    run's best params and statistics, its epoch and loss against its name and the run's
    best loss; ``resume.msgpack`` against the final params and statistics, optax's tree of
    the optimizer's state (``adam_to_optax``), the last epoch and the best loss. Raises
    where one differs or the directory holds anything else. Returns the MB of each."""
    from blindno_torch.convert import adam_to_optax, to_flax
    from blindno_torch.train import checkpoint, jax_checkpoint

    names = sorted(os.listdir(ckpt_dir))
    bests = [n for n in names if n.startswith("best_")]
    if len(bests) != 1 or names != sorted(bests + [checkpoint.RESUME]) \
            or not jax_checkpoint.is_orbax(os.path.join(ckpt_dir, bests[0])):
        raise RuntimeError(f"{label}: {ckpt_dir} holds {names}, want one orbax best_* "
                           f"directory and {checkpoint.RESUME}")
    best_path, resume_path = (os.path.join(ckpt_dir, n) for n in (bests[0], checkpoint.RESUME))
    best, resume = jax_checkpoint.read_orbax(best_path), jax_checkpoint.read_msgpack(resume_path)
    want_best = to_flax({**res.best_params, **res.best_batch_stats})
    want_resume = to_flax({**res.params, **res.batch_stats})
    model, optimizer = trained
    opt_state = adam_to_optax(optimizer.state_dict(), res.params,
                              [k for k, p in model.named_parameters() if p.requires_grad])
    checks = {
        "best params": trees_equal(best["params"], want_best[0]),
        "best statistics": trees_equal(best["batch_stats"], want_best[1]),
        "best epoch and loss": (f"best_{best['test_loss']:.6f}_e{best['epoch']}" == bests[0]
                                and best["test_loss"] == res.best_test_loss),
        "resume params": trees_equal(resume["params"], want_resume[0]),
        "resume statistics": trees_equal(resume["batch_stats"], want_resume[1]),
        "resume Adam state": trees_equal(resume["opt_state"], opt_state),
        "resume epoch and loss": (resume["epoch"] == res.history[-1]["epoch"]
                                  and resume["best_loss"] == res.best_test_loss),
    }
    if not all(checks.values()):
        raise RuntimeError(f"{label}: the checkpoints read back differ from the trained state: "
                           f"{checks}")
    disk = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(best_path) for f in fs)
    return {"best_mb": disk / 1e6, "resume_mb": os.path.getsize(resume_path) / 1e6}


def fit_cli(w, spec, model, m, m_test, epochs, per_forward, smi_line, layer="fno2d_layer",
            resumed=False, tta=False):
    """``model`` of the suite ``spec`` through the CLI on the archives in ``w`` (``m`` train
    and ``m_test`` test sets): ``epochs`` epochs of ``--stage train`` (no host
    synchronization inside a step), with ``resumed`` one more epoch by a second
    ``--stage train`` that resumes, then ``--stage eval`` with the symmetry average;
    ``per_forward`` launches of the kernel ``layer`` a step and a forward, counted
    exactly; losses finite, one ``best_*`` checkpoint, predictions against the CPU (with
    ``tta`` the averaged ones too). Returns its launches."""
    from blindno_torch.train import loop

    cfg = spec.train_cfg
    n_train = int(cfg.train_frac * m)
    steps = n_train // cfg.batch_size
    eval_forwards = -(-(m - n_train) // cfg.batch_size)
    test_forwards = -(-m_test // eval_batch())
    label = f"fit: {spec.name} {model}"
    syncs = []
    torch.cuda.reset_peak_memory_stats()
    with patched(loop, "train_step", sync_free(loop.train_step, syncs)):
        counts1, res, wall1, _ = cli_stage(w, spec.name, model, "--stage", "train",
                                           "--epochs", str(epochs))
        expect_launches(f"{label} training", counts1,
                        **{layer: per_forward * (steps * epochs + eval_forwards)})
        history, walls = list(res.history), [wall1]
        if resumed:
            counts_r, res_r, wall_r, _ = cli_stage(w, spec.name, model, "--stage", "train",
                                                   "--epochs", str(epochs + 1))
            expect_launches(f"{label} resumed epoch", counts_r,
                            **{layer: per_forward * (steps + eval_forwards)})
            if [h["epoch"] for h in res_r.history] != [epochs + 1] or not res_r.finished:
                raise RuntimeError(f"{label}: the resumed run's history is {res_r.history}, "
                                   f"want epoch {epochs + 1} only")
            counts1 = {k: v + counts_r[k] for k, v in counts1.items()}
            history += res_r.history
            walls.append(wall_r)
    losses = [v for h in history for v in (h["train_loss"], h["test_loss"], *h["field_rel_l2"])]
    if not (res.finished and losses and np.isfinite(losses).all()):
        raise RuntimeError(f"{label}: unfinished or non-finite run: {history}")
    bests = [f for f in os.listdir(os.path.join(w, "ckpt", f"{spec.name}_{model}"))
             if f.startswith("best_")]
    if len(bests) != 1:
        raise RuntimeError(f"{label}: want one best_* checkpoint, found {bests}")
    if syncs:
        raise RuntimeError(f"{label}: the training steps synchronized the host {len(syncs)} "
                           f"times: {sorted(set(syncs))[:3]}")
    counts2, report, wall2, _ = cli_stage(w, spec.name, model, "--stage", "eval")
    emit("fit_figures", suite=spec.name, model=model, figures=report["figures"])
    group = len(loop.make_augment(cfg.augment))
    expect_launches(f"{label} eval", counts2,
                    **{layer: per_forward * test_forwards * (1 + group)})
    numbers = [report["mean_rel_l2_sum"], report["mean_rel_l2_sum_tta"]]
    if report["n_test"] != m_test or not np.isfinite(numbers).all():
        raise RuntimeError(f"{label}: eval report {report}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    err, cpu_s, _, _ = eval_vs_cpu(w, spec, model, tta)
    emit("fit", suite=spec.name, model=model, epochs=epochs + resumed, steps_per_epoch=steps,
         batch=cfg.batch_size, augment=cfg.augment,
         launches={"train": counts1, "eval": counts2}, history=history,
         host_syncs_in_steps=len(syncs), report=report, max_rel_err_vs_cpu=err,
         tol=f"rtol {SERVE_TOL}, atol {SERVE_TOL} x each field's scale", cpu_reference_s=cpu_s,
         loop_steps_per_sec=[h["steps_per_sec"] for h in history],
         stage_wall_s=[*walls, wall2], peak_memory_gb=peak_gb, nvidia_smi=smi_line)
    return counts1[layer] + counts2[layer]


def writer_times(res, trained, directory):
    """Seconds of the port's writers, ``checkpoint.save_best`` (the orbax directory) and
    ``save_resume`` (``resume.msgpack``, optax's Adam state made by ``adam_to_optax``
    inside the timed call, as the loop makes it), on the state of a training run (its
    ``TrainResult`` ``res``, ``trained`` its model and Adam), each beside ``torch.save``
    of the same state as an earlier port version wrote it (its tensors as they lie, on
    the card), each into a fresh directory under ``directory``, and the MB each wrote."""
    from blindno_torch.convert import adam_to_optax
    from blindno_torch.train import checkpoint

    model, opt = trained
    trainable = [k for k, p in model.named_parameters() if p.requires_grad]
    loss = res.best_test_loss
    writers = {
        "save_best": lambda d: checkpoint.save_best(d, res.best_params, res.best_batch_stats,
                                                    1, loss),
        "torch_save_best": lambda d: torch.save(
            {"params": res.best_params, "batch_stats": res.best_batch_stats, "epoch": 1,
             "test_loss": loss}, os.path.join(d, "best.pt")),
        "save_resume": lambda d: checkpoint.save_resume(
            d, res.params, res.batch_stats, adam_to_optax(opt.state_dict(), res.params, trainable),
            1, loss),
        "torch_save_resume": lambda d: torch.save(
            {"params": res.params, "batch_stats": res.batch_stats, "opt_state": opt.state_dict(),
             "epoch": 1, "best_loss": loss}, os.path.join(d, "resume.pt")),
    }
    out = {}
    for name, write in writers.items():
        d = os.path.join(directory, name)
        os.makedirs(d)
        t0 = time.perf_counter()
        write(d)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_mb"] = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d)
                                for f in fs) / 1e6
    return out


def phase_fit(smi_line):
    """The main path, training and evaluation through the suites CLI
    (``blindno_torch.suites.run``) at the fpe2d suite's config. Returns its
    ``fno2d_layer`` launches and the loaded train archive, which phase ``epoch_scan``
    trains on."""
    from blindno_torch.convert import adam_from_optax
    from blindno_torch.data.datasets import load_fpe2d
    from blindno_torch.eval.field_eval import predict_fields, predict_fields_tta
    from blindno_torch.suites import registry
    from blindno_torch.train import checkpoint, loop
    from blindno_torch.train.step import make_optimizer, train_step

    spec = registry.SUITES["fpe2d"]
    cfg = spec.train_cfg
    m, l, n = FIT["m"], FIT["l"], FIT["n"]
    n_train = int(cfg.train_frac * m)
    steps = n_train // cfg.batch_size
    eval_forwards = -(-(m - n_train) // cfg.batch_size)
    test_forwards = -(-FIT["m_test"] // eval_batch())
    group = len(loop.make_augment(cfg.augment))
    out, fields = {}, {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blindno_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as w:
        os.makedirs(os.path.join(w, "data"))
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        arch = fpe2d_archive(m, l, n, rng)
        np.savez(os.path.join(w, "data", spec.train_file), **arch)
        np.savez(os.path.join(w, "data", spec.test_file), **fpe2d_archive(FIT["m_test"], l, n, rng))
        fields["archive_s"] = time.perf_counter() - t0
        fields["archive_mb"] = os.path.getsize(os.path.join(w, "data", spec.train_file)) / 1e6
        ckpt_dir = os.path.join(w, "ckpt", "fpe2d_nio")

        models, epoch_starts, syncs = [], [], []
        saves = {"save_best": [], "save_resume": []}
        factory = spec.models["nio"]
        real_trace = loop.trace

        def run(*argv):
            epoch_starts.clear()
            return cli_stage(w, "fpe2d", "nio", *argv)

        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(
                loop, "trace", lambda d: (epoch_starts.append(time.perf_counter()), real_trace(d))[1]))
            # each training step must leave the host free: no synchronization inside it
            stack.enter_context(patched(loop, "train_step", sync_free(loop.train_step, syncs)))
            for name in ("save_best", "save_resume"):
                stack.enter_context(patched(checkpoint, name,
                                            timed_calls(saves[name])(getattr(checkpoint, name))))
            made = stack.enter_context(recorded_optimizers())
            # keep each model the CLI builds, to read its state after the restore
            spec.models["nio"] = lambda **kw: models.append(factory(**kw)) or models[-1]
            try:
                # 1. two epochs from scratch
                counts1, res1, wall1, t_1 = run("--stage", "train", "--epochs", str(FIT["epochs"]))
                starts1 = list(epoch_starts)
                expect_launches("fit: 2 epochs", counts1,
                                fno2d_layer=6 * steps * FIT["epochs"] + 6 * eval_forwards)
                written = [check_written("fit: 2 epochs", ckpt_dir, res1, made[-1])]
                saved = checkpoint.load_resume(ckpt_dir)  # the port's reader, to the host

                # 2. a third epoch, resumed: the state right after the restore (when the
                # optimizer has just been loaded) must be the saved one bit for bit
                restored = {}
                adam_load = torch.optim.Adam.load_state_dict

                def check_restore(opt, state):
                    adam_load(opt, state)
                    model = models[-1]
                    restored["params"] = all(torch.equal(p.cpu(), saved["params"][k])
                                             for k, p in model.named_parameters())
                    restored["buffers"] = all(torch.equal(b.cpu(), saved["batch_stats"][k])
                                              for k, b in model.named_buffers())
                    got = opt.state_dict()["state"]
                    want = adam_from_optax(
                        saved["opt_state"],
                        [k for k, p in model.named_parameters() if p.requires_grad],
                        opt.state_dict()["param_groups"])["state"]
                    restored["adam"] = got.keys() == want.keys() and all(
                        torch.equal(got[i][k].cpu(), want[i][k]) for i in want for k in want[i])
                    restored["moments_on_card"] = all(s["exp_avg"].is_cuda for s in opt.state.values())
                    restored["steps_on_host"] = all(s["step"].is_cpu for s in opt.state.values())

                with patched(torch.optim.Adam, "load_state_dict", check_restore):
                    counts2, res2, wall2, t_2 = run("--stage", "train", "--epochs",
                                                    str(FIT["epochs"] + 1))
                starts2 = list(epoch_starts)
                written.append(check_written("fit: resumed epoch", ckpt_dir, res2, made[-1]))
            finally:
                spec.models["nio"] = factory
        if syncs:
            raise RuntimeError(f"fit: the training steps synchronized the host {len(syncs)} "
                               f"times: {sorted(set(syncs))[:3]}")
        if not (restored and all(restored.values())):
            raise RuntimeError(f"fit: the resumed state differs from the saved one: {restored}")
        expect_launches("fit: resumed epoch", counts2, fno2d_layer=6 * steps + 6 * eval_forwards)
        hist = res1.history + res2.history
        if [h["epoch"] for h in res2.history] != [FIT["epochs"] + 1]:
            raise RuntimeError(f"fit: the resumed run's history is {res2.history}, want epoch 3 only")
        losses = [v for h in hist for v in (h["train_loss"], h["test_loss"], *h["field_rel_l2"])]
        if not (res1.finished and res2.finished and np.isfinite(losses).all()):
            raise RuntimeError(f"fit: unfinished or non-finite run: {hist}")
        # the writers beside torch.save of the same state, on the resumed run's
        writers = writer_times(res2, made[-1], os.path.join(w, "writers"))

        # 3. the eval stage, with the symmetry average
        counts3, report, wall3, _ = run("--stage", "eval")
        emit("fit_figures", suite="fpe2d", model="nio", figures=report["figures"])
        expect_launches("fit: eval", counts3, fno2d_layer=6 * test_forwards * (1 + group))
        numbers = [report["mean_rel_l2_sum"], report["mean_rel_l2_sum_tta"]]
        if report["n_test"] != FIT["m_test"] or not np.isfinite(numbers).all():
            raise RuntimeError(f"fit: eval report {report}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        # 4. the card's eval predictions against the CPU plain path on the same checkpoint
        err, cpu_s, inputs, best = eval_vs_cpu(w, spec, "nio")

        # 5. eval with and without the average, on the card, warm
        card_model = factory(device="cuda")
        card_model.load_state_dict({**best["params"], **best["batch_stats"]})
        eval_s = {}
        for label, fn in (("plain", lambda: predict_fields(card_model, inputs, spec.grid)),
                          ("tta", lambda: predict_fields_tta(card_model, inputs, spec.grid,
                                                             cfg.augment))):
            fn()
            t0 = time.perf_counter()
            fn()
            eval_s[label] = time.perf_counter() - t0

        # 6. bare train_step on one batch of 16 in this process, the loop's yardstick
        data = load_fpe2d(arch)
        x = torch.tensor(data.inputs[:cfg.batch_size], device="cuda")
        y = torch.tensor(data.targets[:cfg.batch_size], device="cuda")
        del arch
        g = torch.tensor(spec.grid, device="cuda")
        model = factory(generator=torch.Generator().manual_seed(1), device="cuda").train()
        opt = make_optimizer(model, cfg.lr)
        gen = torch.Generator(device="cuda").manual_seed(1)
        for _ in range(3):
            train_step(model, opt, x, y, g, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FIT["bare_steps"]):
            loss = train_step(model, opt, x, y, g, generator=gen)
        torch.cuda.synchronize()
        bare_sps = FIT["bare_steps"] / (time.perf_counter() - t0)
        if not torch.isfinite(loss):
            raise RuntimeError(f"fit: bare step loss {loss.item()}")
        del model, opt, card_model

        loop_sps = [h["steps_per_sec"] for h in hist]
        epoch_wall = [b - a for a, b in zip(starts1, starts1[1:] + [t_1 + wall1])]
        emit("fit", suite="fpe2d", model="nio", config=dict(cfg.__dict__), sets=m, test_sets=FIT["m_test"],
             snapshots=l, grid=[n, n], steps_per_epoch=steps, **fields,
             launches={"train_2_epochs": counts1, "resumed_epoch": counts2, "eval": counts3},
             history=hist, restored_bit_for_bit=restored, host_syncs_in_steps=len(syncs), report=report,
             max_rel_err_vs_cpu=err, tol=f"rtol {SERVE_TOL}, atol {SERVE_TOL} x each field's scale",
             cpu_reference_s=cpu_s, loop_steps_per_sec=loop_sps, bare_train_step_steps_per_sec=bare_sps,
             loop_overhead=1.0 - float(np.mean(loop_sps)) / bare_sps,
             epoch_wall_s=epoch_wall, resumed_epoch_wall_s=t_2 + wall2 - starts2[0],
             data_load_s=[starts1[0] - t_1, starts2[0] - t_2], stage_wall_s=[wall1, wall2, wall3],
             eval_s=eval_s, checkpoint_save_s=saves, checkpoints_read_back_bit_for_bit=written,
             writers=writers, peak_memory_gb=peak_gb, nvidia_smi=smi_line)

        # 7. the fpe2d suite's UNet through the CLI on the same archive
        unet_launches = fit_cli(w, spec, "unet", m, FIT["m_test"], FIT["unet_epochs"], 6,
                                smi_line)

    return (counts1["fno2d_layer"] + counts2["fno2d_layer"] + counts3["fno2d_layer"]
            + unet_launches + fit_ncfpe2d(build, smi_line)), data


# phase epoch_scan: TrainConfig(epoch_scan=True) against the per-step loop. Its Adam is
# the host's, whose bias corrections are float64 numbers where the captured Adam's are
# float32 products on the card: the history is held within SCAN_HIST_TOL relative (or
# two per-step runs' gap, where cuDNN's atomics make that larger), the final tensors
# within unet_tol, but in bfloat16 only the heads' (the conv stack's are chaotic in
# bfloat16: low_precision_steps holds the heads' gradients alone)
SCAN_EPOCHS, SCAN_BF16_EPOCHS, SCAN_HIST_TOL = 2, 1, 1e-4
FNO2D_STAGES = "fno2d_"  # in the names of the 2-D layer's three stage kernels, and no other


def scan_gaps(scanned, eager):
    """The gaps of the run ``scanned`` from ``eager``: the worst relative gap of the
    history's numbers, and each final parameter and floating buffer's relative L2 gap."""
    def numbers(res):
        return np.array([v for h in res.history for v in (h["train_loss"], h["test_loss"],
                                                           *h["field_rel_l2"])], np.float64)

    a, b = numbers(scanned), numbers(eager)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise RuntimeError(f"epoch_scan: histories {scanned.history} against {eager.history}")
    gap = lambda x, y: 0.0 if torch.equal(x, y) else rel_l2(x, y)
    state = {**{k: gap(scanned.params[k], v) for k, v in eager.params.items()},
             **{f"state {k}": gap(scanned.batch_stats[k], v)
                for k, v in eager.batch_stats.items() if v.is_floating_point()}}
    return float(np.max(np.abs(a - b) / np.abs(b))), state


def check_scan_gaps(label, hist, state, hist_tol, held, tol=None):
    """Raise unless the history's gap is within ``hist_tol`` and each tensor that
    ``held(key)`` names within ``tol(key)`` (:func:`unet_tol` unless given); return the
    worst gaps."""
    tol = tol or unet_tol
    bad = {k: e for k, e in state.items() if held(k) and not e <= tol(k)}
    if not hist <= hist_tol or bad:
        raise RuntimeError(f"{label}: the run lies beyond its bounds from the run it is held "
                           f"to: history {hist:.3g} (bound {hist_tol:.3g}), tensors {bad}")
    worst = lambda part: max(part.items(), key=lambda kv: kv[1])
    conv = {k: e for k, e in state.items() if tol(k) == ENCODER_TOL}
    return dict(history=hist, worst_conv_stack=worst(conv),
                worst_rest=worst({k: e for k, e in state.items() if k not in conv}))


def phase_epoch_scan(smi_line, data):
    """``TrainConfig(epoch_scan=True)`` (``blindno_torch/train/scan.py``) on the fpe2d
    suite's UNet at the suite's config, through ``train_model``, on ``data``, ``fit``'s
    synthetic archive loaded (FIT["m"] sets: 4 steps of 16 an epoch): (a) SCAN_EPOCHS float32 epochs with
    ``epoch_scan=True`` and with False from the same weights and seed (see SCAN_HIST_TOL
    for the bounds); (b) the same for SCAN_BF16_EPOCHS in bfloat16 ``all``; (c) the first
    wholly replayed epoch under ``set_sync_debug_mode("error")``; (d) its ``fno2d_layer``
    calls (the graph's, per replay) against the stage kernels in a profiler trace of that
    epoch; every run's
    kernel executions exact (the wrappers are called eagerly for the run's first step
    and during the capture, which executes nothing; each replay executes what the
    capture recorded); (e) at ``bench.py``'s batch, STEPS replays of the captured step
    beside STEPS eager steps: steps/s, the host's ms a step and the device's busy ms.
    Returns the executed ``fno2d_layer`` calls of (a) and (b)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from blindno_torch.parallel import dryrun
    from blindno_torch.suites import registry
    from blindno_torch.tools import bench_train
    from blindno_torch.train import loop, scan

    spec = registry.SUITES["fpe2d"]
    m = FIT["m"]
    base = dataclasses.replace(spec.train_cfg, save_interval=1)
    n_train = int(base.train_frac * m)
    steps, evals = n_train // base.batch_size, -(-(m - n_train) // base.batch_size)
    programs = []

    class Recorded(scan.EpochProgram):
        """The loop's program, kept: its capture's wrapper calls counted, and its first
        wholly replayed epoch run under sync debug mode "error" and traced."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.captured = self.stages = self.kernels = None
            programs.append(self)

        def _capture(self):
            before = {k: w.launches for k, w in dryrun.kernel_wrappers().items()}
            super()._capture()
            self.captured = {k: w.launches - before[k]
                             for k, w in dryrun.kernel_wrappers().items()}

        def run(self):
            if self.graph is None or self.stages is not None:
                return super().run()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = super().run()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_time_total > 0]
            self.stages = sum(e.count for e in events if FNO2D_STAGES in e.key)
            self.kernels = sorted(((e.key[:60], e.count) for e in events), key=lambda kv: -kv[1])
            return out

    def train(epochs, scanned, **fields):
        cfg = dataclasses.replace(base, epochs=epochs, epoch_scan=scanned, **fields)
        model = spec.models["unet"](generator=torch.Generator().manual_seed(0), device="cuda")
        t0 = time.perf_counter()
        counts, res = counted(lambda: loop.train_model(model, data, spec.grid, cfg))
        wall = time.perf_counter() - t0
        want = 6 * (steps + evals) * epochs
        label = f"epoch_scan: {fields or 'float32'} epoch_scan={scanned}"
        if not scanned:
            expect_launches(label, counts, fno2d_layer=want)
            return res, counts["fno2d_layer"], dict(wall_s=wall)
        program = programs[-1]
        cap = program.captured
        executed = {k: v - cap[k] + cap[k] * program.replays for k, v in counts.items()}
        if program.replays != steps * epochs - scan.WARMUP_STEPS or cap["fno2d_layer"] != 6:
            raise RuntimeError(f"{label}: {program.replays} replays of a graph of {cap}")
        expect_launches(f"{label} (executed)", executed, fno2d_layer=want)
        return res, want, dict(wall_s=wall, replays=program.replays, graph_calls=cap,
                               loop_steps_per_sec=[h["steps_per_sec"] for h in res.history])

    fields, launches = {}, 0
    with patched(loop, "EpochProgram", Recorded):
        for label, epochs, amp in (("float32", SCAN_EPOCHS, {}),
                                   ("bfloat16_all", SCAN_BF16_EPOCHS,
                                    dict(compute_dtype="bfloat16", amp_policy="all"))):
            eager, n_eager, eager_f = train(epochs, False, **amp)
            scanned, n_scanned, scan_f = train(epochs, True, **amp)
            launches += n_eager + n_scanned
            tol, eager_gap = SCAN_HIST_TOL, None
            hist, state = scan_gaps(scanned, eager)
            if hist > tol:
                # a second per-step run from the same seed: where cuDNN's atomics part two
                # per-step runs by more than the bound, their gap is the bound
                again, n_again, _ = train(epochs, False, **amp)
                launches += n_again
                eager_gap = scan_gaps(again, eager)[0]
                tol = max(tol, eager_gap)
            heads = ("heads.", "state heads.")
            held = (lambda k: k.startswith(heads)) if amp else (lambda k: True)
            gaps = check_scan_gaps(f"epoch_scan {label}", hist, state, tol, held)
            fields[label] = dict(epochs=epochs, steps_per_epoch=steps, gaps=gaps,
                                 history_bound=tol, per_step_runs_gap=eager_gap,
                                 eager=eager_f, scanned=scan_f,
                                 history=[(h["train_loss"], h["test_loss"]) for h in scanned.history])
    program = programs[0]
    replayed_calls = program.captured["fno2d_layer"] * steps
    if program.stages != 3 * replayed_calls:
        raise RuntimeError(f"epoch_scan: a replayed epoch's trace holds {program.stages} "
                           f"{FNO2D_STAGES}* kernels, want 3 x {replayed_calls}; its kernels "
                           f"by count: {program.kernels[:12]}")

    # (e) bench.py's batch: the captured step's replays beside eager steps
    eager_sps, eager_host_ms, step = bench_train.steps_per_sec(None, "unet", figures=True)
    eager_kernels = top_kernels(step)  # "all": the device's busy time in a step
    del step
    sps, host_ms, epoch = bench_train.scanned_steps_per_sec(None, "unet", figures=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        epoch()
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e3 / bench_train.STEPS
    del epoch
    emit("epoch_scan", model="PermInvUNetAttn", config=dict(base.__dict__), sets=m,
         tol=f"history {SCAN_HIST_TOL} relative (or two per-step runs' gap); state "
             f"{TRAIN_TOL} relative L2 a tensor, {ENCODER_TOL} in the conv stack (bfloat16: "
             "the heads')",
         **fields, replayed_epoch=dict(host_syncs=0, fno2d_layer_calls=replayed_calls,
                                       fno2d_stage_kernels_in_trace=program.stages),
         bench_batch=dict(batch=bench_train.BATCH, steps=bench_train.STEPS,
                          eager=dict(steps_per_sec=eager_sps, host_ms=eager_host_ms,
                                     device_busy_ms=eager_kernels.pop("all"),
                                     top_kernels_ms=eager_kernels),
                          replayed=dict(steps_per_sec=sps, host_ms=host_ms, device_busy_ms=busy)),
         nvidia_smi=smi_line)
    return launches


def fit_ncfpe2d(build, smi_line):
    """The ncfpe2d suite through the CLI at its own config on a synthetic archive: the
    FNO-branch NIO (8 launches a step and a forward) and the plain-block UNet (6), each
    for FIT_NC["epochs"] epochs and the eval stage with the c4_vector average. Returns
    their launches."""
    from blindno_torch.suites import registry

    spec = registry.SUITES["ncfpe2d"]
    m, m_test, l, n = FIT_NC["m"], FIT_NC["m_test"], FIT_NC["l"], FIT_NC["n"]
    with tempfile.TemporaryDirectory(dir=build) as w:
        os.makedirs(os.path.join(w, "data"))
        rng = np.random.default_rng(0)
        np.savez(os.path.join(w, "data", spec.train_file), **ncfpe2d_archive(m, l, n, rng))
        np.savez(os.path.join(w, "data", spec.test_file), **ncfpe2d_archive(m_test, l, n, rng))
        return sum(fit_cli(w, spec, model, m, m_test, FIT_NC["epochs"], per_forward, smi_line)
                   for model, per_forward in (("fno", 8), ("unet", 6)))


def fpe1d_archive(m, l, n, rng):
    """A synthetic fpe1d archive in the JAX datagen's keys and raw magnitudes
    (``blindno/data/generate.py:60-120``: trajectories (m, l, n) ~ 1e-2, potential (m, n)
    ~ 1e-20, drag (m,) ~ 1e-9): a Gaussian well per set, snapshots that sharpen towards
    it, plus noise."""
    x = np.linspace(-1, 1, n)
    well = np.exp(-(x - rng.uniform(-0.5, 0.5, (m, 1))) ** 2 / 0.1).astype(np.float32)
    t = rng.uniform(0.2, 1.0, (m, l, 1)).astype(np.float32)
    traj = well[:, None] ** t + 0.05 * rng.random((m, l, n), dtype=np.float32)
    return {"trajectories": traj * np.float32(1e-2), "potential": -well * np.float32(3e-20),
            "drag": rng.uniform(0.5, 2.0, m).astype(np.float32) * np.float32(1e-9)}


def gpe1d_archive(m, l, n, rng):
    """A synthetic gpe1d archive in the JAX datagen's keys (``blindno/data/generate.py:
    272-320``: |psi| snapshots y (m, l, n), the potential V (m, n), g and kappa (m,) at
    2): a harmonic well about a random centre per set, snapshots of a Gaussian moving in
    it."""
    x = np.linspace(-10, 10, n)
    x0 = rng.uniform(-3, 3, (m, 1))
    v = rng.uniform(0.1, 0.3, (m, 1)) * (x - x0) ** 2
    y = np.exp(-(x - x0[:, None] - 2 * np.sin(rng.uniform(0, 6, (m, l, 1)))) ** 2 / 4)
    return {"y": y.astype(np.float32), "V": v.astype(np.float32), "g": np.full(m, 2.0),
            "kappa": np.full(m, 2.0)}


def phase_fit1d(smi_line):
    """The 1-D suites through the CLI at their own configs (batch 32, lr 1e-3, the parity
    flip) on synthetic archives: the fpe1d NIO for an epoch and a resumed one, the gpe1d
    UNet for an epoch, each then the eval stage with and without the flip average;
    launches counted exactly, no host synchronization in a step, predictions against the
    CPU. Returns their ``fno1d_layer`` launches."""
    from blindno_torch.suites import registry

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blindno_torch", "_build")
    os.makedirs(build, exist_ok=True)
    launches = 0
    for suite, model, make, (l, n), resumed in (
            ("fpe1d", "nio", fpe1d_archive, (100, 80), True),
            ("gpe1d", "unet", gpe1d_archive, (101, 128), False)):
        spec = registry.SUITES[suite]
        with tempfile.TemporaryDirectory(dir=build) as w:
            os.makedirs(os.path.join(w, "data"))
            rng = np.random.default_rng(0)
            np.savez(os.path.join(w, "data", spec.train_file), **make(FIT_1D["m"], l, n, rng))
            np.savez(os.path.join(w, "data", spec.test_file), **make(FIT_1D["m_test"], l, n, rng))
            per_forward = fno_layer_calls(spec.models[model](device="cpu"))["fno1d_layer"]
            launches += fit_cli(w, spec, model, FIT_1D["m"], FIT_1D["m_test"], FIT_1D["epochs"],
                                per_forward, smi_line, layer="fno1d_layer", resumed=resumed,
                                tta=True)
    return launches + fit1d_bf16(smi_line)


def fit1d_bf16(smi_line):
    """``train_model`` of the fpe1d suite's UNet at the suite's config in bfloat16 under
    JAX's default policy ``all`` (the CLI, as JAX's, has no compute dtype): FIT_1D_BF16's
    epochs on a synthetic archive of FIT_1D["m"] sets, an eval after each, its
    ``fno1d_layer`` launches counted exactly (the steps' inside the cast, the eval's in
    float32), its history finite and its train loss falling. Returns its launches."""
    import dataclasses

    from blindno_torch.suites import registry
    from blindno_torch.train.loop import train_model

    spec, m, epochs = registry.SUITES["fpe1d"], FIT_1D["m"], FIT_1D_BF16["epochs"]
    data = spec.loader(fpe1d_archive(m, 100, 80, np.random.default_rng(1)))
    cfg = dataclasses.replace(spec.train_cfg, epochs=epochs, save_interval=1,
                              compute_dtype="bfloat16", amp_policy="all")
    model = spec.models["unet"](generator=torch.Generator().manual_seed(0), device="cuda")
    per_forward = fno_layer_calls(model)["fno1d_layer"]
    n_train = int(cfg.train_frac * m)
    steps, eval_forwards = n_train // cfg.batch_size, -(-(m - n_train) // cfg.batch_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts, res = counted(lambda: train_model(model, data, spec.grid, cfg))
    wall = time.perf_counter() - t0
    expect_launches("fit1d fpe1d unet bfloat16", counts,
                    fno1d_layer=per_forward * (steps + eval_forwards) * epochs)
    losses = [v for h in res.history for v in (h["train_loss"], h["test_loss"])]
    if not (res.finished and np.isfinite(losses).all()
            and res.history[-1]["train_loss"] < res.history[0]["train_loss"]):
        raise RuntimeError(f"fit1d: the bfloat16 UNet run is unfinished, not finite or its "
                           f"train loss did not fall: {res.history}")
    emit("fit1d", suite="fpe1d", model="unet", compute_dtype="bfloat16", amp_policy="all",
         epochs=epochs, steps_per_epoch=steps, launches=counts, history=res.history,
         loop_steps_per_sec=[h["steps_per_sec"] for h in res.history], wall_s=wall,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi_line)
    return counts["fno1d_layer"]


# phase parallel: (case, ranks, tp, backend); NCCL takes one rank per card, so the
# cases of several ranks on one card run over gloo, their compute on the card
PARALLEL_CASES = [("a_nccl_1rank", 1, 1, "nccl"), ("b_gloo_dp2", 2, 1, "gloo"),
                  ("c_gloo_dp2_tp2", 4, 2, "gloo")]
PARALLEL_TWO_CARDS = ("d_nccl_dp2_two_cards", 2, 1, "nccl")
PARALLEL_STEPS = 1  # timed steps a case, after the checked one and a warm-up
PARALLEL_RANKS = 4
# the epoch program across ranks: (case, ranks), over NCCL. At 4 steps an epoch DDP's 11
# eager steps end in epoch 3, whose last step is captured: epoch 4 replays whole
PARALLEL_SCAN = ("e_nccl_1rank_epoch_scan", 1)
PARALLEL_SCAN_TWO_CARDS = ("f_nccl_dp2_epoch_scan_two_cards", 2)
PARALLEL_SCAN_EPOCHS = 4
# the ranks past the data axis (case, ranks, backend): train_model of NIOFP2D at bench.py's
# config and batch of 4, whose data axis on 3 ranks is 2 (JAX's data_mesh rule): ranks 0
# and 1 train on 2 rows each and rank 2 idles. For an epoch of fit's first 20 sets (4 steps
# and an eval batch, so that the three gloo runs take seconds) over gloo on the one card,
# then with epoch_scan over NCCL on three cards where there are three
PARALLEL_IDLE = ("g_gloo_3ranks_data2", 3, "gloo")
PARALLEL_IDLE_CARDS = ("h_nccl_3ranks_epoch_scan_three_cards", 3, "nccl")
PARALLEL_IDLE_SETS = 20


def phase_parallel(smi_line, ranks, data):
    """The train stage's data- and tensor-parallel path (``blindno_torch.parallel``):
    one f32 ``train_step`` of NIOFP2D at the ``bench.py`` config (phase ``train``'s
    weights, batch and injected draw) in ranks spawned on the card
    (``RankPool``), against the single-process step on the card: (a) one rank over NCCL
    through the DDP path, bit for bit; (b) two ranks over gloo, DP 2, and (c) four ranks
    over gloo on a 2 x 2 mesh with tp=2, within :func:`train_tol` on the loss, the
    gradients, the updated parameters (gathered) and the running statistics, each rank's
    ``fno2d_layer`` launches counted (in (c) 6 a step at ``TP_SLICE``); (d) two ranks
    over NCCL on two cards where there are two. Each case's steps/s and wall time. Then
    the epoch program across ranks on ``data``, ``fit``'s archive loaded
    (:func:`parallel_epoch_scan`). ``ranks`` is the ``RankPool`` of PARALLEL_RANKS
    workers that main() started before the build. Returns the launches of every rank's
    checked step and the executed ``fno2d_layer`` calls of the epoch-program runs."""
    from blindno_torch.models.nio2d import NIOFP2D
    from blindno_torch.parallel.dryrun import train_step_ranks
    from blindno_torch.tools import bench_train

    b, l = bench_train.BATCH["b"], bench_train.BATCH["l"]
    rng = np.random.default_rng(5)  # phase train's draw
    draw = (rng.integers(0, l, l), (np.arange(l) < rng.integers(50, l)).astype(np.float32))
    cpu_model = bench_train.fresh_model("cpu")
    state = {k: v.numpy() for k, v in cpu_model.state_dict().items()}
    x, y, grid = (t.numpy() for t in bench_train.bench_batch("cpu"))
    factory = (NIOFP2D, dict(**bench_train.CONFIG, device="cpu"))
    with deterministic_convolutions():
        single = [one_step(copy.deepcopy(cpu_model).to("cuda"),
                           *(torch.from_numpy(a).to("cuda") for a in (x, y, grid)), draw)
                  for _ in range(2)]
    if not same_step(*single):
        raise RuntimeError("parallel: the single-process step on the card is not "
                           "reproducible, so case (a) cannot be held to it bit for bit")
    cases = PARALLEL_CASES + ([PARALLEL_TWO_CARDS] if torch.cuda.device_count() >= 2 else [])
    results, launches, tp_launches = {}, 0, 0
    for name, world, tp, backend in cases:
        t0 = time.perf_counter()
        out = ranks.run(train_step_ranks, world, factory, state, x, y, grid, draw, tp,
                        "cuda", 2, PARALLEL_STEPS, tp > 1, device="cuda", backend=backend,
                        timeout=300)
        wall = time.perf_counter() - t0
        for rank, r in enumerate(out):
            card = (r["loss"], r["grads"], {k: v for k, v in r["state"].items()
                                            if not k.endswith("num_batches_tracked")})
            errs = train_errors(card, single[0])  # raises beyond train_tol
            if name.startswith("a_") and not same_step(card, single[0]):
                raise RuntimeError(f"parallel {name}: one rank through DDP differs from "
                                   f"the single-process step (worst {max(errs.values())})")
            expect_launches(f"parallel {name} rank {rank}", r["launches"], fno2d_layer=6)
            if tp > 1 and r["shapes"] != [(TP_SLICE[:4], TP_SLICE[6])] * 6:
                raise RuntimeError(f"parallel {name} rank {rank}: fno2d_layer launched at "
                                   f"{r['shapes']}, want 6 at {TP_SLICE}")
            launches += r["launches"]["fno2d_layer"]
            tp_launches += r["launches"]["fno2d_layer"] if tp > 1 else 0
        results[name] = dict(
            ranks=world, tp=tp, backend=backend, mesh=[world // tp, tp], wall_s=wall,
            steps_per_sec=[r["steps_per_sec"] for r in out],
            loss=out[0]["loss"], worst_rel_l2=max(errs.items(), key=lambda kv: kv[1]),
            launches_fno2d_layer=[r["launches"]["fno2d_layer"] for r in out],
            rank0_seconds=out[0]["seconds"])
    if len(cases) == len(PARALLEL_CASES):
        print(f"parallel: case (d) did not run: it needs two CUDA devices, and "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}", flush=True)
    scan_launches, scan = parallel_epoch_scan(ranks, data)
    idle_launches, idle = parallel_idle_ranks(ranks, data)
    emit("parallel", model="NIOFP2D", config=bench_train.CONFIG, batch=bench_train.BATCH,
         loss_single=single[0][0], cases=results,
         bit_for_bit="a_nccl_1rank", tp_slice=TP_SLICE, tp_slice_launches=tp_launches,
         timed_steps=PARALLEL_STEPS,
         tol=f"relative L2: {TRAIN_TOL}, encoder gradients and parameters {ENCODER_TOL}",
         epoch_scan=scan, idle_ranks=idle, nvidia_smi=smi_line)
    return launches + scan_launches + idle_launches


def check_program(label, record, launches, steps, executed, ranked):
    """Raise unless the epoch program that ``record`` accounts for (a
    ``recorded_programs`` entry) took its eager steps (DDP's where ``ranked``, else
    one), replayed the rest of the run's ``steps`` and its last epoch whole, captured
    the step's 6 ``fno2d_layer`` calls and, where ``ranked``, DDP's all-reduce, and
    executed ``executed`` layer calls: its wrappers counted ``launches``, the eager
    steps' and evals' calls and the capture's (which execute nothing), and each replay
    executes the capture's. Returns ``executed``."""
    from blindno_torch.train import scan

    warmup = scan.DDP_WARMUP_STEPS if ranked else scan.WARMUP_STEPS
    cap = record["captured"]["fno2d_layer"]
    got = launches["fno2d_layer"] - cap + cap * record["replays"]
    reduced = any("allreduce" in k for k in record["collectives_captured"] or ())
    if not (record["eager_steps"] == warmup and record["replays"] == steps - warmup
            and record["replayed"] and cap == 6 and reduced == ranked and got == executed):
        raise RuntimeError(f"{label}: the program took {record} and {launches} wrapper calls: "
                           f"want {warmup} eager steps of {steps}, 6 layer calls captured, "
                           f"DDP's all-reduce captured: {ranked}, {executed} executed")
    return executed


def same_run(a, b):
    """Whether two ``TrainResult`` are equal bit for bit: history and final state."""
    numbers = lambda res: [(h["train_loss"], h["test_loss"], h["field_rel_l2"])
                           for h in res.history]
    same = lambda x, y: all(torch.equal(x[k], v.to(x[k].device)) for k, v in y.items())
    return (numbers(a) == numbers(b) and same(a.params, b.params)
            and same(a.batch_stats, b.batch_stats))


def parallel_epoch_scan(ranks, data):
    """Phase parallel's epoch-program cases: the fpe2d suite's UNet through
    ``train_model(..., TrainConfig(epoch_scan=True))`` at the suite's config on ``data``
    for PARALLEL_SCAN_EPOCHS epochs, from seeded weights, in ``ranks`` over NCCL. (e) one
    rank: DDP's step (its all-reduce inside) captured after DDP_WARMUP_STEPS eager steps,
    its last epoch replayed whole under sync debug mode "error"; bit for bit a
    one-process ``epoch_scan`` run on the card (its first step eager) with the same
    weights, seed and epochs, deterministic cuDNN in both; both runs' ``fno2d_layer``
    executions exact (the eager steps' and evals' calls, plus the capture's calls times
    the replays); each wholly replayed epoch's steps/s and host ms a step. (f) two ranks
    on two cards (DP 2) where there are two, within :func:`unet_tol` of the one-process
    run. Returns the executed calls of the runs, and the figures."""
    import dataclasses

    from blindno_torch.models.blindno_unet import PermInvUNetAttn
    from blindno_torch.parallel.dryrun import recorded_programs, train_model_ranks
    from blindno_torch.suites import registry
    from blindno_torch.tools import bench_train
    from blindno_torch.train import loop

    spec = registry.SUITES["fpe2d"]
    cfg = dataclasses.replace(spec.train_cfg, epochs=PARALLEL_SCAN_EPOCHS, save_interval=1,
                              epoch_scan=True)
    m = data.inputs.shape[0]
    n_train = int(cfg.train_frac * m)
    steps, evals = n_train // cfg.batch_size, -(-(m - n_train) // cfg.batch_size)
    executed = 6 * (steps + evals) * cfg.epochs
    model = spec.models["unet"](generator=torch.Generator().manual_seed(0), device="cpu")
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    factory = (PermInvUNetAttn, dict(bench_train.UNET_CONFIG, device="cpu"))
    t0 = time.perf_counter()
    with deterministic_convolutions(), recorded_programs() as programs:
        counts, single = counted(lambda: loop.train_model(model, data, spec.grid, cfg))
    (one,) = programs
    one_wall = time.perf_counter() - t0
    launches = check_program("parallel epoch_scan, one process", one, counts,
                             steps * cfg.epochs, executed, False)
    cases = [PARALLEL_SCAN] + ([PARALLEL_SCAN_TWO_CARDS] if torch.cuda.device_count() >= 2 else [])
    figures = {}
    for name, world in cases:
        t0 = time.perf_counter()
        out = ranks.run(train_model_ranks, world, factory, state, data, spec.grid, cfg, "cuda",
                        None, True, device="cuda", backend="nccl", timeout=300)
        wall = time.perf_counter() - t0
        gaps = None
        for rank, r in enumerate(out):
            (record,) = r["programs"]
            launches += check_program(f"parallel {name} rank {rank}", record, r["launches"],
                                      steps * cfg.epochs, executed, True)
            if world == 1 and not (r["result"].finished and same_run(r["result"], single)):
                raise RuntimeError(f"parallel {name}: the program in one NCCL rank differs "
                                   f"from the one-process program: {r['result'].history} "
                                   f"against {single.history}")
            if world > 1:
                gaps = check_scan_gaps(f"parallel {name} rank {rank}",
                                       *scan_gaps(r["result"], single), TRAIN_TOL, lambda k: True)
        figures[name] = dict(
            ranks=world, wall_s=wall, history=[(h["train_loss"], h["test_loss"])
                                               for h in out[0]["result"].history],
            eager_steps=record["eager_steps"], replays=record["replays"],
            collectives_captured=record["collectives_captured"], gaps_from_one_process=gaps,
            train_model_s=[r["train_s"] for r in out],
            replayed_epochs=[r["programs"][0]["replayed"] for r in out])
    if len(cases) == 1:
        print(f"parallel: case {PARALLEL_SCAN_TWO_CARDS[0]} did not run: it needs two CUDA "
              f"devices, and torch.cuda.device_count() is {torch.cuda.device_count()}",
              flush=True)
    figures.update(one_process=dict(wall_s=one_wall, eager_steps=one["eager_steps"],
                                    replays=one["replays"], replayed_epochs=one["replayed"]),
                   epochs=cfg.epochs, steps_per_epoch=steps, sets=m,
                   executed_fno2d_layer_calls_a_run=executed,
                   bit_for_bit=PARALLEL_SCAN[0], tol_two_cards=f"history {TRAIN_TOL} relative; "
                   f"state {TRAIN_TOL} relative L2 a tensor, {ENCODER_TOL} in the conv stack")
    return launches, figures


def parallel_idle_ranks(ranks, data):
    """Phase parallel's cases of ranks past the data axis (``PARALLEL_IDLE``):
    ``train_model`` of NIOFP2D at the ``bench.py`` config and batch for one epoch on the
    first PARALLEL_IDLE_SETS sets of ``data`` (``fit``'s archive loaded), from phase
    ``train``'s seeded weights, on 3 ranks in ``ranks``, whose data axis of 2 leaves rank 2
    idle; deterministic cuDNN convolutions throughout.

    (g) Over gloo on the card: every rank's result, the idle rank's too, equal bit for bit
    to the same run on 2 gloo ranks; each training rank launches ``fno2d_layer`` 6 times a
    step and eval batch, the idle rank never. Its one-step epoch (the first 5 sets) within
    :func:`train_tol` of the one-process run's, the history within TRAIN_TOL. Over more
    steps Adam carries rounding-level differences past those bounds (its first update is
    the gradient's sign times the rate, so a gradient within rounding of 0 moves its
    weight either way), so the whole epoch's gaps from the one-process run are figures,
    beside the gaps of a one-process run from weights one ulp up.

    (h) Over NCCL on three cards with ``epoch_scan=True``, where there are three, on the
    whole archive (16 steps: the step is captured after DDP's eager ones): the idle rank's
    result bit for bit rank 0's, each training rank's layer executions exact (its eager
    steps', evals' and capture's calls, and the capture's times its replays), the idle
    rank's none.

    Returns the executed ``fno2d_layer`` calls of the runs, and the figures."""
    import dataclasses

    from blindno_torch.data.datasets import SetToFieldData
    from blindno_torch.models.nio2d import NIOFP2D
    from blindno_torch.parallel.dryrun import train_model_ranks
    from blindno_torch.suites import registry
    from blindno_torch.tools import bench_train
    from blindno_torch.train import loop, scan

    grid = registry.SUITES["fpe2d"].grid
    cfg = loop.TrainConfig(epochs=1, batch_size=bench_train.BATCH["b"], save_interval=1)
    sets = lambda m: SetToFieldData(data.inputs[:m], data.targets[:m])
    epoch, one_step = sets(PARALLEL_IDLE_SETS), sets(cfg.batch_size + 1)
    n_train = int(cfg.train_frac * PARALLEL_IDLE_SETS)
    steps = n_train // cfg.batch_size
    evals = -(-(PARALLEL_IDLE_SETS - n_train) // cfg.batch_size)
    per_rank = 6 * (steps + evals)  # 6 layer calls a step and an eval batch
    state = {k: v.numpy().copy() for k, v in bench_train.fresh_model("cpu").state_dict().items()}
    factory = (NIOFP2D, dict(**bench_train.CONFIG, device="cpu"))
    launches = 0

    def single(run_data, nudged=False):
        """The one-process run on the card, its launches checked, and its wall s; where
        ``nudged``, from weights each one ulp up."""
        nonlocal launches
        model = bench_train.fresh_model("cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        if nudged:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))
        t0 = time.perf_counter()
        with deterministic_convolutions():
            counts, res = counted(lambda: loop.train_model(model, run_data, grid, cfg))
        m = run_data.inputs.shape[0]
        want = 6 * (int(cfg.train_frac * m) // cfg.batch_size
                    + -(-(m - int(cfg.train_frac * m)) // cfg.batch_size))
        expect_launches("parallel idle ranks, one process", counts, fno2d_layer=want)
        launches += counts["fno2d_layer"]
        return res, time.perf_counter() - t0

    def run(world, backend, run_data, run_cfg=cfg):
        t0 = time.perf_counter()
        with deterministic_convolutions():
            out = ranks.run(train_model_ranks, world, factory, state, run_data, grid, run_cfg,
                            "cuda", None, True, device="cuda", backend=backend, timeout=300)
        return out, time.perf_counter() - t0

    def gaps(label, res, one, held):
        """The gaps of ``res`` from the one-process run ``one``; checked where ``held``."""
        if not res.finished:
            raise RuntimeError(f"{label}: the run did not finish")
        return check_scan_gaps(label, *scan_gaps(res, one), TRAIN_TOL if held else np.inf,
                               lambda k: held, train_tol)

    name, world, backend = PARALLEL_IDLE
    (out, wall), (two, two_wall) = run(world, backend, epoch), run(2, backend, epoch)
    for rank, r in enumerate(out + two):
        label = (f"parallel {name} rank {rank}" if rank < world
                 else f"parallel {name}'s 2-rank run, rank {rank - world}")
        expect_launches(label, r["launches"], fno2d_layer=0 if rank == world - 1 else per_rank)
        if not same_run(r["result"], two[0]["result"]):
            raise RuntimeError(f"{label}: differs from the 2-rank run: {r['result'].history} "
                               f"against {two[0]['result'].history}")
        launches += r["launches"]["fno2d_layer"]
    (stepped, step_wall), (one_stepped, _) = run(world, backend, one_step), single(one_step)
    launches += sum(r["launches"]["fno2d_layer"] for r in stepped)
    (one, one_wall), (nudged, _) = single(epoch), single(epoch, nudged=True)
    figures = {name: dict(
        ranks=world, backend=backend, data_axis=2, wall_s=wall, two_ranks_wall_s=two_wall,
        one_process_wall_s=one_wall, train_model_s=[r["train_s"] for r in out],
        two_ranks_train_model_s=[r["train_s"] for r in two],
        launches_fno2d_layer=[r["launches"]["fno2d_layer"] for r in out],
        history=[(h["train_loss"], h["test_loss"]) for h in out[0]["result"].history],
        history_one_process=[(h["train_loss"], h["test_loss"]) for h in one.history],
        bit_for_bit="the 2-rank run, every rank",
        one_step_gaps_from_one_process=gaps(f"parallel {name}, one step",
                                            stepped[0]["result"], one_stepped, True),
        one_step_wall_s=step_wall,
        epoch_gaps_from_one_process=gaps(name, out[0]["result"], one, False),
        epoch_gaps_of_one_process_nudged_one_ulp=gaps(name, nudged, one, False))}
    if torch.cuda.device_count() >= 3:
        # the whole archive: its 16 steps an epoch outlast DDP's eager ones, so the step is
        # captured and replayed
        name, world, backend = PARALLEL_IDLE_CARDS
        m = data.inputs.shape[0]
        steps = int(cfg.train_frac * m) // cfg.batch_size
        per_rank = 6 * (steps + -(-(m - int(cfg.train_frac * m)) // cfg.batch_size))
        out, wall = run(world, backend, data, dataclasses.replace(cfg, epoch_scan=True))
        for rank, r in enumerate(out):
            label = f"parallel {name} rank {rank}"
            if rank == world - 1:
                expect_launches(label, r["launches"], fno2d_layer=0)
                if r["programs"] or not same_run(r["result"], out[0]["result"]):
                    raise RuntimeError(f"{label}: the idle rank built {r['programs']} or "
                                       f"returned another result than rank 0's")
                continue
            (record,) = r["programs"]
            cap = record["captured"]["fno2d_layer"]
            executed = r["launches"]["fno2d_layer"] - cap + cap * record["replays"]
            if not (record["eager_steps"] == scan.DDP_WARMUP_STEPS and cap == 6
                    and record["replays"] == steps - scan.DDP_WARMUP_STEPS
                    and executed == per_rank):
                raise RuntimeError(f"{label}: the program took {record}, {executed} layer "
                                   f"calls executed, want {per_rank}")
            launches += executed
        figures[name] = dict(ranks=world, backend=backend, wall_s=wall, sets=m,
                             train_model_s=[r["train_s"] for r in out],
                             history=[(h["train_loss"], h["test_loss"])
                                      for h in out[0]["result"].history])
    else:
        print(f"parallel: case {PARALLEL_IDLE_CARDS[0]} did not run: it needs three CUDA "
              f"devices, and torch.cuda.device_count() is {torch.cuda.device_count()}",
              flush=True)
    figures.update(model="NIOFP2D", batch=cfg.batch_size, epochs=cfg.epochs,
                   sets=PARALLEL_IDLE_SETS, steps_per_epoch=steps, eval_batches=evals,
                   fno2d_layer_calls_a_training_rank=per_rank,
                   tol=f"one step: history {TRAIN_TOL} relative; state {TRAIN_TOL} relative "
                   f"L2 a tensor, {ENCODER_TOL} in the encoder")
    return launches, figures


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic convolution algorithms for the block: its default backward
    algorithms may sum in another order from one run to the next."""
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False


def rank_setup():
    """Phase parallel's ranks compute as the script does: TF32 off (torch's default
    leaves it on for cuDNN), and deterministic cuDNN convolutions as the single-process
    step they are held to. Each worker then pays its first-use costs here, while the
    kernels build: its CUDA context, cuDNN and cuBLAS, Adam, the port's modules, the
    profiler's start-up, and a first gloo and NCCL collective (each in a group of its
    own, torn down). Left to the phase, they took 9-10 s of each case's setup. At the
    lowest priority, so that the build's nvcc processes come first; nothing else runs
    beside the phase."""
    import torch.distributed as dist

    os.nice(19)

    from blindno_torch.parallel import dryrun  # the ranks' functions
    from blindno_torch.train.step import make_optimizer

    dryrun.full_precision()
    conv = torch.nn.Conv2d(1, 2, 3).to("cuda")
    (conv(torch.ones(1, 1, 4, 4, device="cuda")) @ torch.ones(2, 2, device="cuda")).sum().backward()
    make_optimizer(conv).step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass  # the profiler's start-up, which phase parallel's case e pays otherwise
    for backend in ("gloo", "nccl"):
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group(backend, init_method=f"file://{d}/store", rank=0,
                                    world_size=1)
            dist.broadcast(torch.ones(1, device="cuda"), 0)
            dist.destroy_process_group()
    torch.cuda.synchronize()


def same_step(a, b):
    """Whether two :func:`one_step` results are equal bit for bit."""
    return a[0] == b[0] and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a[1:], b[1:]))


CPU_WORKERS = 2


def _low_priority():
    os.nice(19)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // CPU_WORKERS))


@contextlib.contextmanager
def cpu_pool():
    """CPU_WORKERS spawned worker processes, at the lowest priority and with a share of
    the cores each, for the CPU references of phases ``trans`` and ``datagen``: the pool
    and the workers' pids. Work not started when the block ends is dropped."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"), initializer=_low_priority)
    for _ in range(CPU_WORKERS):
        pool.submit(int)  # starts a worker
    try:
        yield pool, [p.pid for p in multiprocessing.active_children()]
    finally:
        pool.shutdown(cancel_futures=True)


def _stopped(pid):
    """Whether process ``pid`` is stopped (state T in /proc), or gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in "Tt"
    except (OSError, IndexError):
        return True


@contextlib.contextmanager
def stopped(pids):
    """The processes ``pids`` stopped by SIGSTOP for the block and resumed after it. No
    child process may start inside the block: on the H100 host (Ubuntu 24.04) the
    ``/sbin/ldconfig`` that ``ctypes.util.find_library`` runs, a shell script there, hung
    up the whole process group while members of it were stopped. So the zstd library
    that the checkpoint code finds that way (every save and read) is loaded first."""
    from blindno_torch.train import jax_checkpoint

    jax_checkpoint.zstd_library()
    for pid in pids:
        with contextlib.suppress(ProcessLookupError):  # a worker that died: its futures raise
            os.kill(pid, signal.SIGSTOP)
    deadline = time.perf_counter() + 5.0
    while not all(map(_stopped, pids)) and time.perf_counter() < deadline:
        time.sleep(1e-3)
    try:
        yield
    finally:
        for pid in pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGCONT)


def first_set_on_cpu(solve, batched):
    """``solve``, a batched solver whose arguments at the positions ``batched`` (and
    whose tensor keywords) have the batch axis first, run on the first set of each batch
    only, the others left zero: the CPU's trajectories of set 0 without the cost of
    every set."""
    def call(*args, **kwargs):
        b = args[batched[0]].shape[0]
        first = lambda a: a[:1] if torch.is_tensor(a) and a.dim() and a.shape[0] == b else a
        args = [first(a) if i in batched else a for i, a in enumerate(args)]
        out = solve(*args, **{k: first(v) for k, v in kwargs.items()})
        return torch.cat([out, out.new_zeros((b - 1,) + out.shape[1:])])
    return call


def datagen_on_cpu(suite, m, seed):
    """The port's generator of ``suite`` on the CPU with ``m`` sets from ``seed``: every
    parameter as the card's run draws it; the trajectories of the first set of each
    batch (all of ncfpe2d's left at the uniform density, unsolved: a 6400-cell series
    takes minutes on the CPU)."""
    from blindno_torch.data import generate
    from blindno_torch.solvers import gpe as gpe_solver
    from blindno_torch.suites import registry

    make = lambda: registry.SUITES[suite].datagen_train(seed, m, device="cpu")
    if suite == "gpe1d":  # solve_gpe(psi0, x, dt, nt, g, kappa, v): the batch is v's
        with patched(gpe_solver, "solve_gpe", first_set_on_cpu(gpe_solver.solve_gpe, (6,))):
            return make()
    if suite == "ncfpe2d":
        uniform = lambda u, *a, **kw: torch.full(
            (u.shape[0], a[4].shape[0], u[0].numel()), 1.0 / u[0].numel(), dtype=u.dtype)
        with patched(generate, "propagate_expm", uniform):
            return make()
    with patched(generate, "propagate_expm", first_set_on_cpu(generate.propagate_expm, (0, 1))):
        return make()


def datagen_reference(suite, m, seed):
    """:func:`datagen_on_cpu` and its seconds."""
    t0 = time.perf_counter()
    out = datagen_on_cpu(suite, m, seed)
    return out, time.perf_counter() - t0


def time_error_reference(suite, model, workdir, num_samples):
    """The time-error stage's report on the CPU for ``model`` of ``suite`` in
    ``workdir``, and its seconds."""
    from blindno_torch.eval.time_error import time_error_suite
    from blindno_torch.suites import registry

    t0 = time.perf_counter()
    report = time_error_suite(registry.SUITES[suite], model, workdir, num_samples=num_samples,
                              device="cpu")
    return report, time.perf_counter() - t0


@contextlib.contextmanager
def tf32_matmul():
    """TF32 on for CUDA matrix products inside the block, restored after it: what the
    solver computes there is full float32 only if it turns TF32 off itself."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def trajectory_errors(got, want, sets):
    """Relative L2 of ``got`` from ``want``, per set, over the sets given."""
    return [float(np.linalg.norm((got[i] - want[i]).ravel()) / np.linalg.norm(want[i].ravel()))
            for i in sets]


def phase_datagen(smi_line, pool, refs):
    """The port's datagen through the CLI (``--stage datagen``) at each suite's full
    grid and time axis, at DATAGEN's set counts, with TF32 on for matrix products (the
    solver must turn it off for its own), timed per set and extrapolated to the
    suite's default train archive; its parameters against a CPU run of the same generator
    bit for bit, its trajectories against the CPU's on the first set (1-D suites and
    fpe2d) or against a float64 run on the card (ncfpe2d, every set), masses at 1. Then
    the eval and time-error stages through the CLI on those archives with copies of the
    committed JAX checkpoints of DATAGEN_CKPTS (the port reads the orbax directories
    itself), the predictions and errors against the CPU's, and the time-error stage on
    one fpe2d sample of an untrained Transolver NIO; then a warm restart of each of
    DATAGEN_CKPTS from its committed directory for one epoch (:func:`warm_restart_epoch`). The CPU's
    generator runs are ``refs``' futures (:func:`submit_cpu_references`), its
    predictions and time errors come from ``pool``'s workers while the card works.
    Returns the launches of both layers."""
    from blindno_torch.data import generate
    from blindno_torch.suites import registry
    from blindno_torch.train import checkpoint

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blindno_torch", "_build")
    os.makedirs(build, exist_ok=True)
    launches = {"fno1d_layer": 0, "fno2d_layer": 0}
    suites, walls, runs, evals = {}, {}, {}, {}
    on_cpu = refs["datagen"]
    with tempfile.TemporaryDirectory(dir=build) as w:
        # TF32 on: the trajectory checks below then hold the solver's own guard
        with tf32_matmul():
            for suite, (m, m_test) in DATAGEN.items():
                _, _, walls[suite], _ = cli_stage(w, suite, "nio", "--stage", "datagen", "--m",
                                                  str(m), "--m-test", str(m_test),
                                                  "--device", "cuda")

        def time_error_run(suite, name, m_te, committed):
            """The time-error stage on the card (where ``committed``, on a copy of the
            committed JAX directory, after the eval stage), each CPU reference queued on
            ``pool`` once what it reads is in place."""
            if committed:
                copy_committed(w, suite, name)
                counts, report, eval_s, _ = cli_stage(w, suite, name, "--stage", "eval",
                                                      "--device", "cuda")
                for k in launches:
                    launches[k] += counts[k]
                evals[(suite, name)] = (report, eval_s,
                                        pool.submit(eval_reference, suite, name, w))
            on_cpu_te = pool.submit(time_error_reference, suite, name, w, m_te)
            counts, card, card_s, _ = cli_stage(w, suite, name, "--stage", "time-error",
                                                "--m", str(m_te), "--device", "cuda")
            for k in launches:
                launches[k] += counts[k]
            runs[(suite, name)] = (card, card_s, committed, on_cpu_te)

        # fpe2d's time error first (an untrained Transolver NIO on one sample): its CPU
        # reference is the longest and runs while the card goes on
        model = registry.SUITES["fpe2d"].models["trans"](
            generator=torch.Generator().manual_seed(0), device="cpu")
        checkpoint.save_best(os.path.join(w, "ckpt", "fpe2d_trans"),
                             dict(model.named_parameters()), dict(model.named_buffers()), 0, 1.0)
        time_error_run("fpe2d", "trans", 1, False)

        for suite, (m, m_test) in DATAGEN.items():
            spec = registry.SUITES[suite]
            with np.load(os.path.join(w, "data", spec.train_file)) as z:
                card = {k: z[k] for k in z.files}
            cpu, cpu_s = on_cpu[suite].result()
            traj = "y" if suite == "gpe1d" else "trajectories"
            unequal = [k for k in cpu if k != traj and not np.array_equal(card[k], cpu[k])]
            if unequal or card.keys() != cpu.keys():
                raise RuntimeError(f"datagen {suite}: parameters {unequal} differ from the CPU's")
            if suite == "ncfpe2d":
                t0 = time.perf_counter()
                ref = generate.generate_ncfpe2d(0, m, device="cuda", dtype=torch.float64)[traj]
                ref_label, ref_s, sets = "float64 on the card", time.perf_counter() - t0, range(m)
            else:
                ref, ref_label, ref_s, sets = cpu[traj], "the CPU", cpu_s, [0]
            errs = trajectory_errors(card[traj], ref, sets)
            fields = dict(traj_rel_l2_vs_reference=max(errs), reference=ref_label,
                          reference_s=ref_s, sets_compared=len(sets))
            if suite != "gpe1d":
                mass = card[traj].reshape(card[traj].shape[:2] + (-1,)).sum(-1)
                fields["max_mass_deviation"] = float(np.abs(mass - 1.0).max())
                if not fields["max_mass_deviation"] <= DATAGEN_MASS_TOL:
                    raise RuntimeError(f"datagen {suite}: masses {fields['max_mass_deviation']}"
                                       f" from 1 (want <= {DATAGEN_MASS_TOL})")
            if not max(errs) <= DATAGEN_TOL:
                raise RuntimeError(f"datagen {suite}: trajectories {max(errs):.3g} from "
                                   f"{ref_label}'s (relative L2, want <= {DATAGEN_TOL})")
            per_set = walls[suite] / (m + m_test)
            suites[suite] = dict(sets=m, test_sets=m_test, stage_s=walls[suite],
                                 s_per_set=per_set,
                                 default_train_archive_s_extrapolated=per_set * spec.m_train,
                                 default_m_train=spec.m_train, cpu_run_s=cpu_s, **fields)

        # the committed checkpoints on the archives just made
        for suite, name in DATAGEN_CKPTS:
            time_error_run(suite, name, DATAGEN[suite][1], True)
        restart = {}
        for suite, name in DATAGEN_CKPTS:
            restart[f"{suite} {name}"], restart_launches = warm_restart_epoch(w, suite, name)
            for k in launches:
                launches[k] += restart_launches[k]
        evaluated = {}
        for (suite, name), (report, eval_s, on_cpu_eval) in evals.items():
            want, cpu_s = on_cpu_eval.result()
            got = np.load(os.path.join(w, "eval", f"{suite}_{name}", "predictions.npy"))
            errs = [check_close(f"datagen: {suite} {name} eval predictions, field {f}, vs the "
                                f"CPU", torch.from_numpy(got[..., f]),
                                torch.from_numpy(want[..., f]), SERVE_TOL,
                                float(np.abs(want[..., f]).max()))
                    / float(np.abs(want[..., f]).max()) for f in range(want.shape[-1])]
            evaluated[f"{suite} {name}"] = dict(
                ckpt_epoch=report["ckpt_epoch"], ckpt_test_loss=report["ckpt_test_loss"],
                mean_rel_l2_sum=report["mean_rel_l2_sum"], test_sets=len(got),
                max_rel_err_vs_cpu=max(errs), stage_s=eval_s, cpu_s=cpu_s)
        terr = {}
        for (suite, name), (card, card_s, committed, on_cpu_te) in runs.items():
            cpu, cpu_s = on_cpu_te.result()
            err = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("mean_err_l2", "std_err_l2")
                   if cpu[k]}
            if not (np.isfinite(card["mean_err_l2"]) and all(e <= TIME_ERROR_TOL
                                                             for e in err.values())):
                raise RuntimeError(f"time-error {suite} {name}: card {card}, CPU {cpu}, "
                                   f"relative {err} (want <= {TIME_ERROR_TOL})")
            terr[f"{suite} {name}"] = dict(card=card, cpu=cpu, rel_err_vs_cpu=err,
                                           stage_s=card_s, cpu_s=cpu_s,
                                           committed_jax_checkpoint=committed)
    emit("datagen", suites=suites, eval=evaluated, time_error=terr, warm_restart=restart,
         launches=launches,
         tol=f"trajectories {DATAGEN_TOL} relative L2, masses {DATAGEN_MASS_TOL}, "
             f"time errors {TIME_ERROR_TOL} relative, predictions {SERVE_TOL} of each "
             f"field's scale", nvidia_smi=smi_line)
    return launches


def copy_committed(workdir, suite, model):
    """A copy of the committed JAX checkpoint of ``model`` of ``suite`` in ``workdir``'s
    ``ckpt``: the path of its ``best_*`` directory."""
    import shutil

    src = committed_best(f"{suite}_{model}")
    dst = os.path.join(workdir, "ckpt", f"{suite}_{model}", os.path.basename(src))
    shutil.copytree(src, dst)
    return dst


def eval_reference(suite, model, workdir):
    """On the CPU: the eval stage's denormalized predictions of every test set of
    ``workdir`` for ``model`` of ``suite`` (the train statistics' sidecar, which the
    card's eval stage wrote, read back), from the same ``best_*``, and its seconds."""
    from blindno_torch.eval.field_eval import (cached_train_stats, denormalize_predictions,
                                               normalized_test_inputs, predict_fields)
    from blindno_torch.suites import registry
    from blindno_torch.train import checkpoint

    t0 = time.perf_counter()
    spec = registry.SUITES[suite]
    stats = cached_train_stats(spec, workdir)
    with np.load(os.path.join(workdir, "data", spec.test_file)) as z:
        inputs = normalized_test_inputs(stats, z)
    best = checkpoint.load_best(os.path.join(workdir, "ckpt", f"{suite}_{model}"))
    cpu_model = spec.models[model](device="cpu")
    cpu_model.load_state_dict({**best["params"], **best["batch_stats"]})
    cpu_model.eval()
    out = denormalize_predictions(spec, stats, predict_fields(cpu_model, inputs, spec.grid,
                                                              batch=eval_batch(), device="cpu"))
    return out, time.perf_counter() - t0


def warm_restart_epoch(workdir, suite, model):
    """``--stage train`` of ``model`` of ``suite`` on the card in a workdir of its own
    beside ``workdir`` (its archives, a copy of the committed JAX directory, no resume
    file) for one epoch past the directory's: the port warm-restarts from JAX's
    ``best_*`` as JAX's loop does. It must start at that epoch + 1 with the directory's
    test loss as its best, Adam's step advanced to the schedule's, and leave the JAX
    directory or a new orbax ``best_*`` by ``save_best``'s rule, and ``resume.msgpack``:
    both read back by the port's reader bit for bit against the trained state
    (:func:`check_written`), and the state read back from ``resume.msgpack`` served on the
    card within SERVE_TOL of the CPU (:func:`served_resume`). Returns its phase fields and
    launches."""
    import shutil

    from blindno_torch.data.datasets import train_test_split
    from blindno_torch.suites import registry
    from blindno_torch.train import checkpoint

    spec = registry.SUITES[suite]
    w = os.path.join(workdir, f"warm_restart_{suite}_{model}")
    os.makedirs(os.path.join(w, "data"))
    for f in (spec.train_file, spec.test_file):
        shutil.copy(os.path.join(workdir, "data", f), os.path.join(w, "data", f))
    jax_dir = copy_committed(w, suite, model)
    jax_best = checkpoint.load_best(os.path.dirname(jax_dir))
    epoch = jax_best["epoch"] + 1
    with recorded_optimizers() as made:
        counts, res, train_s, _ = cli_stage(w, suite, model, "--stage", "train", "--epochs",
                                            str(epoch), "--device", "cuda")
    ckpt = os.path.dirname(jax_dir)
    written = check_written(f"warm restart of {suite} {model}", ckpt, res, made[-1])
    resume = checkpoint.load_resume(ckpt)
    with np.load(os.path.join(w, "data", spec.train_file)) as z:
        m = len(z[next(iter(z.files))])
    cfg = spec.train_cfg
    steps = epoch * (len(train_test_split(m, cfg.train_frac, cfg.split_seed)[0]) // cfg.batch_size)
    (record,) = res.history
    loss = record["test_loss"]
    improved = loss < jax_best["test_loss"]
    bests = sorted(f for f in os.listdir(ckpt) if f.startswith("best_"))
    want_bests = [f"best_{loss:.6f}_e{epoch}"] if improved else [os.path.basename(jax_dir)]
    adam_steps = {int(resume["opt_state"][i]["count"]) for i in ("0", "1")}
    if (record["epoch"] != epoch or resume["epoch"] != epoch
            or resume["best_loss"] != min(loss, jax_best["test_loss"])
            or adam_steps != {steps} or bests != want_bests or not np.isfinite(loss)):
        raise RuntimeError(
            f"warm restart of {suite} {model} from {jax_dir}: epoch {record['epoch']} "
            f"(want {epoch}), resume epoch {resume['epoch']}, best {resume['best_loss']} "
            f"(JAX's {jax_best['test_loss']}, the epoch's {loss}), Adam steps {adam_steps} "
            f"(want {steps}), best_* {bests} (want {want_bests})")
    served, served_counts = served_resume(f"warm restart of {suite} {model}", suite, model,
                                          resume)
    counts = {k: v + served_counts[k] for k, v in counts.items()}
    return dict(jax_epoch=jax_best["epoch"], jax_test_loss=jax_best["test_loss"],
                epoch=epoch, test_loss=loss, train_loss=record["train_loss"],
                adam_step=steps, jax_dir_kept=not improved, stage_s=train_s,
                checkpoints_read_back_bit_for_bit=written, served_resume=served), counts


RESUME_SETS = 4  # the seeded sets on which a warm restart's resume state is served


def served_resume(label, suite, model_name, resume):
    """``resume``, a state that the port's reader read back from ``resume.msgpack``,
    loaded strictly into ``model_name`` of ``suite`` on the card and on the CPU and served
    on RESUME_SETS seeded sets (:func:`jax_ckpt_case`'s snapshots) through
    ``predict_fields``: its FNO-layer launches counted exactly, each field within
    SERVE_TOL of its scale from the CPU's. Returns its fields and launches."""
    from blindno_torch.eval.field_eval import predict_fields
    from blindno_torch.suites import registry

    grid = registry.SUITES[suite].grid
    rng = np.random.default_rng(list(label.encode()))
    x = rng.standard_normal((RESUME_SETS, JAX_CKPT_SETS[grid.shape[-1]][1],
                             *grid.shape[:-1])).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        model = registry.SUITES[suite].models[model_name](device=device)
        model.load_state_dict({**resume["params"], **resume["batch_stats"]})
        model.eval()
        if device == "cuda":
            counts, out[device] = counted(lambda: predict_fields(model, x, grid, batch=len(x)))
            expect_launches(f"{label}: resume state served", counts, **fno_layer_calls(model))
        else:
            out[device] = predict_fields(model, x, grid, batch=len(x), device="cpu")
    got, want = out["cuda"], out["cpu"]
    errs = [check_close(f"{label}: resume state served, field {f}, vs the CPU",
                        torch.from_numpy(got[..., f]), torch.from_numpy(want[..., f]), SERVE_TOL,
                        float(np.abs(want[..., f]).max())) / float(np.abs(want[..., f]).max())
            for f in range(want.shape[-1])]
    return dict(sets=list(x.shape), launches=counts, max_rel_err_vs_cpu=max(errs)), counts


def jax_ckpt_names():
    """The committed ``runs/ckpt/{name}`` directories, each holding one JAX ``best_*``."""
    return sorted(JAX_CKPT_MODELS + tuple(JAX_CKPT_VARIANTS))


def committed_best(name):
    """The ``best_*`` directory of committed checkpoint ``name``, which must be the one
    entry of ``runs/ckpt/{name}``: a ``--stage train`` on the default workdir leaves a
    resume file or a port ``best_*`` there, or replaces the directory."""
    d = os.path.join(CKPT_DIR, name)
    entries = sorted(os.listdir(d)) if os.path.isdir(d) else []
    if len(entries) != 1 or not entries[0].startswith("best_") \
            or not os.path.isdir(os.path.join(d, entries[0])):
        raise RuntimeError(f"committed checkpoint {d}: want one best_* directory, found "
                           f"{entries or 'nothing'}")
    return os.path.join(d, entries[0])


def jax_ckpt_case(name):
    """Committed checkpoint ``name``'s suite, model name, ``best_*`` directory, and its
    seeded batch of normalized sets (JAX_CKPT_SETS by the grid's rank) with the grid."""
    from blindno_torch.suites import registry

    suite, model = JAX_CKPT_VARIANTS.get(name) or name.rsplit("_", 1)
    path = committed_best(name)
    grid = registry.SUITES[suite].grid
    sets, snapshots = JAX_CKPT_SETS[grid.shape[-1]]
    rng = np.random.default_rng(list(name.encode()))
    x = rng.standard_normal((sets, snapshots, *grid.shape[:-1])).astype(np.float32)
    return suite, model, path, x, grid


def jax_ckpt_reference(name):
    """On the CPU: committed checkpoint ``name``, read by the port's reader, served on its
    batch (:func:`jax_ckpt_case`), and the seconds it took."""
    from blindno_torch.convert import from_flax_checkpoint
    from blindno_torch.eval.field_eval import predict_fields
    from blindno_torch.suites import registry
    from blindno_torch.train.jax_checkpoint import read_orbax

    t0 = time.perf_counter()
    suite, model_name, path, x, grid = jax_ckpt_case(name)
    state = from_flax_checkpoint(read_orbax(path))
    model = registry.SUITES[suite].models[model_name](device="cpu")
    model.load_state_dict({**state["params"], **state["batch_stats"]})
    model.eval()
    out = predict_fields(model, x, grid, batch=len(x), device="cpu")
    return out, time.perf_counter() - t0


def read_committed(paths):
    """Each orbax directory of ``paths`` read by the port's reader (``read_orbax``), and
    what it took: directories, zarr arrays (scalars among them), MB on disk and decoded,
    seconds and MB/s, and the seconds within them of the manifests' and nodes' CRC-32C
    checks and of the zstd calls (each frame decoded into its buffer); the rest is
    Python's parsing and file reads. ``python3 -c 'import chip_smoke as c; print(c.read_committed([c.committed_best(n)
    for n in c.jax_ckpt_names()])[1])'`` gives the figures on any host."""
    from blindno_torch.train import jax_checkpoint

    disk = sum(os.path.getsize(os.path.join(r, f)) for d in paths for r, _, fs in os.walk(d)
               for f in fs)
    crc, zstd = [], []
    with patched(jax_checkpoint, "crc32c", timed_calls(crc)(jax_checkpoint.crc32c)), \
            patched(jax_checkpoint, "zstd_decompress",
                    timed_calls(zstd)(jax_checkpoint.zstd_decompress)):
        t0 = time.perf_counter()
        trees = [jax_checkpoint.read_orbax(d) for d in paths]
        seconds = time.perf_counter() - t0

    def leaves(t):
        return [v for x in t.values() for v in (leaves(x) if isinstance(x, dict) else [x])]

    zarr = [v for t in trees for v in leaves(t)]
    decoded = sum(v.nbytes for v in zarr if isinstance(v, np.ndarray))
    return trees, {"directories": len(paths), "zarr_arrays": len(zarr), "disk_mb": disk / 1e6,
                   "decoded_mb": decoded / 1e6, "read_s": seconds,
                   "read_mb_per_s": disk / 1e6 / seconds, "crc32c_s": sum(crc),
                   "crc32c_share": sum(crc) / seconds, "zstd_s": sum(zstd),
                   "zstd_share": sum(zstd) / seconds}


def write_committed(trees, directory):
    """Each tree of ``trees`` (as :func:`read_committed` reads them) written by the port's
    writer (``write_orbax``) into a directory of its own under ``directory``, and what it
    took: MB on disk, seconds and MB/s, and the seconds within them of the manifests' and
    nodes' CRC-32C and of the zstd calls (each array's chunk and each manifest and node
    compressed); the rest is Python's coding and the file writes. Returns the
    directories and the figures."""
    from blindno_torch.train import jax_checkpoint

    paths = [os.path.join(directory, f"best_{i}") for i in range(len(trees))]
    crc, zstd = [], []
    with patched(jax_checkpoint, "crc32c", timed_calls(crc)(jax_checkpoint.crc32c)), \
            patched(jax_checkpoint, "zstd_compress",
                    timed_calls(zstd)(jax_checkpoint.zstd_compress)):
        t0 = time.perf_counter()
        for path, tree in zip(paths, trees):
            jax_checkpoint.write_orbax(path, tree)
        seconds = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(r, f)) for d in paths for r, _, fs in os.walk(d)
               for f in fs)
    return paths, {"disk_mb": disk / 1e6, "write_s": seconds,
                   "write_mb_per_s": disk / 1e6 / seconds, "crc32c_s": sum(crc),
                   "crc32c_share": sum(crc) / seconds, "zstd_s": sum(zstd),
                   "zstd_share": sum(zstd) / seconds}


def phase_jax_ckpt(smi_line, workers, refs):
    """Every committed ``runs/ckpt/*/best_*`` (JAX's orbax directories) read by the port's
    own reader, without JAX (``blindno_torch/train/jax_checkpoint.py``), timed with the CPU
    workers ``workers`` stopped (:func:`read_committed`); each tree then written by the
    port's writer (:func:`write_committed`) and read back, bit for bit the tree read, the
    workers still stopped. Then each loaded strictly into
    its port model on the card and served on one seeded batch through ``predict_fields``,
    its ``fno2d_layer`` or ``fno1d_layer`` launches counted exactly, each field within
    SERVE_TOL of its scale from the same weights on the CPU (``refs``' futures, run in the
    CPU workers). Reads ``runs/`` and writes nothing there. Returns the launches of both
    layers."""
    from blindno_torch.convert import from_flax_checkpoint
    from blindno_torch.eval.field_eval import predict_fields
    from blindno_torch.suites import registry

    names = jax_ckpt_names()
    cases = {name: jax_ckpt_case(name) for name in names}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blindno_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with stopped(workers), tempfile.TemporaryDirectory(dir=build) as w:
        trees, read = read_committed([cases[name][2] for name in names])
        paths, write = write_committed(trees, w)
        back, reread = read_committed(paths)
    unequal = [name for name, a, b in zip(names, back, trees) if not trees_equal(a, b)]
    if unequal:
        raise RuntimeError(f"jax_ckpt: the port's writer's directories of {unequal} read "
                           "back unlike the committed ones")
    raws = dict(zip(names, trees))
    launches = {"fno1d_layer": 0, "fno2d_layer": 0}
    served = {}
    t0 = time.perf_counter()
    for name in names:
        suite, model_name, _, x, grid = cases[name]
        state = from_flax_checkpoint(raws[name])
        model = registry.SUITES[suite].models[model_name](device="cuda")
        model.load_state_dict({**state["params"], **state["batch_stats"]})
        model.eval()
        counts, out = counted(lambda: predict_fields(model, x, grid, batch=len(x)))
        expect_launches(f"jax_ckpt: {name}", counts, **fno_layer_calls(model))
        for k in launches:
            launches[k] += counts[k]
        want, cpu_s = refs[name].result()
        if out.shape != want.shape:
            raise RuntimeError(f"jax_ckpt: {name} served {out.shape}, the CPU {want.shape}")
        errs = []
        for f in range(want.shape[-1]):
            scale = float(np.abs(want[..., f]).max())
            errs.append(check_close(f"jax_ckpt: {name} field {f} vs the CPU",
                                    torch.from_numpy(out[..., f]), torch.from_numpy(want[..., f]),
                                    SERVE_TOL, scale) / scale)
        served[name] = dict(suite=suite, model=model_name, epoch=raws[name]["epoch"],
                            test_loss=raws[name]["test_loss"], sets=list(x.shape),
                            launches=counts, max_rel_err_vs_cpu=max(errs), cpu_s=cpu_s)
        del model
    serve_s = time.perf_counter() - t0
    emit("jax_ckpt", **read, write=write, read_back=reread, read_back_bit_for_bit=True,
         serve_s=serve_s, served=served,
         launches=launches, tol=f"{SERVE_TOL} of each field's scale", nvidia_smi=smi_line)
    return launches


def earlier_phases(timed, smi_line, ranks, train_reference):
    """Phases ``kernels`` to ``parallel`` (``epoch_scan`` after ``fit``), each timed by
    ``timed``: their launches of each kernel, and under ``"stats"`` phase ``kernels``'
    figures. ``train_reference`` is phase ``train``'s CPU step."""
    stats = timed("kernels", phase_kernels)
    launches = {**timed("serve", phase_serve), **timed("serve1d", phase_serve1d)}
    for kernel, count in timed("serve_unet", phase_serve_unet).items():
        launches[kernel] += count
    launches["fno2d_layer"] += timed("serve_nio2d", phase_serve_nio2d)
    launches["fno1d_layer"] += timed("serve3d", phase_serve3d, smi_line)
    launches["fno2d_layer"] += timed("train", phase_train,
                                     stats["fno2d_layer"]["kernel_ms"], smi_line, train_reference)
    launches["fno2d_layer"] += timed("train_unet", phase_train_unet, smi_line)
    launches["fno2d_layer"] += timed("train_fno", phase_train_fno, smi_line)
    fit_launches, fit_data = timed("fit", phase_fit, smi_line)
    launches["fno2d_layer"] += fit_launches
    launches["fno2d_layer"] += timed("epoch_scan", phase_epoch_scan, smi_line, fit_data)
    launches["fno1d_layer"] += timed("train1d", phase_train1d, smi_line)
    launches["fno1d_layer"] += timed("fit1d", phase_fit1d, smi_line)
    launches["fno2d_layer"] += timed("parallel", phase_parallel, smi_line, ranks, fit_data)
    return {**launches, "stats": stats}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU")
    from blindno_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    # the CPU references of the last two phases (a Transolver step takes 12-19 s on the
    # card host's CPU) start here, on the cores the build leaves idle, and are stopped
    # from the build's end until after phase parallel: the phases before trans run with
    # no other process of this script running but phase parallel's ranks
    from blindno_torch.parallel.mesh import RankPool

    # phase parallel's ranks start here too: they import torch and make their CUDA
    # contexts while the kernels build, then wait idle for that phase
    with cpu_pool() as (pool, workers), RankPool(PARALLEL_RANKS, rank_setup) as ranks:
        refs = submit_cpu_references(pool)
        cached = _build.build_dir().joinpath("libblindno_torch_kernels.so").exists()
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.library()
        log = (lib_path.parent / "build.log").read_text().splitlines()
        emit("build", seconds=time.perf_counter() - t0, cached=cached,
             cpu_references_beside=True,
             ptxas=[ln.strip() for ln in log if "registers" in ln or "spill" in ln])
        train_reference = refs["train"].result()  # queued first: done while the kernels built
        with stopped(workers):
            launches = earlier_phases(timed, smi_line, ranks, train_reference)
        stats = launches.pop("stats")
        launches["fno2d_layer"] += timed("padded", phase_padded, smi_line, refs["padded"])
        launches["fno2d_layer"] += timed("trans", phase_trans, smi_line, refs)
        for phase, fn, args in (("jax_ckpt", phase_jax_ckpt, (workers, refs["jax_ckpt"])),
                                ("datagen", phase_datagen, (pool, refs))):
            for kernel, count in timed(phase, fn, smi_line, *args).items():
                launches[kernel] += count

    csrc, replaces = "blindno_torch/csrc", "blindno/ops/spectral_pallas.py"
    kernels = [
        {"name": "fno2d_layer", "route": "cuda", "source": f"{csrc}/fno2d_layer.cu",
         "replaces": f"{replaces}:165"},
        {"name": "spectral_conv2d", "route": "cuda", "source": f"{csrc}/fno2d_layer.cu",
         "replaces": f"{replaces}:234"},
        {"name": "fno1d_layer", "route": "cuda", "source": f"{csrc}/fno1d_layer.cu",
         "replaces": f"{replaces}:69"},
        {"name": "spectral_conv1d", "route": "cuda", "source": f"{csrc}/fno1d_layer.cu",
         "replaces": f"{replaces}:201"},
    ]
    for k in kernels:
        s = stats[k["name"]]
        k.update(launches=launches[k["name"]], max_abs_err=s["max_abs_err"], ms=s["kernel_ms"],
                 plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                 library_ms=s["library_ms"])
    emit("done", wall_s=time.perf_counter() - t_start, phase_s=phase_s, nvidia_smi=smi_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
