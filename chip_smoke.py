#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. The device: name, power limit, torch and CUDA versions; TF32 off (the
   float32 slices stay float32).
2. The build: one nvcc for each source, started together: csrc/ee_fused.cu
   (kernels K1, K2, K3a, K3b) and csrc/gemm_conv.cu (K4), for sm_90a; the
   compiler's register and spill report; the gemm_conv library's SASS must
   hold both HGMMA (wgmma) forms, BF16 for the bf16 K4 and TF32 for the
   float32 K4 (three TF32 products, 3xTF32), and the ee_fused library's a
   bf16 tensor-core instruction with float32 sums (HMMA or HGMMA .F32.BF16)
   for the bf16 K1/K2's products, and packed bf16x2 arithmetic in both
   bf16 K3a/K3b kernels: a library whose kernels fell back to FP32 FMAs
   fails.
3. The kernels against their plain PyTorch versions at the shapes their
   paths give them, errors against stated limits, median times from CUDA
   events, and each kernel's bound (the least time the card could take for
   its bytes and its operations); a kernel's time is its device time per
   launch from a replayed CUDA graph of 20 launches, beside the eager
   call's time: K1/K2 and K3a/K3b at 100 x 3 x 64 x 64
   float32 (with constant patches and saturated pixels), K1/K2 also at
   ImageNet's 224 px (square on) with 8 images (56 blocks, under half the
   SMs) and with free-AT's batch of 256, and at phase l's two shapes:
   50 x 1 x 28 x 28 (MNIST's one channel, r 4, the square at eps 0.3) and
   100 x 3 x 64 x 64 with no square (the AWP configs' BPDA-3 front-end),
   K3a/K3b also with ImageNet's batch
   of 128 at 224 px, each beside its bound and its plain version's time;
   K3a/K3b in bfloat16 at fast-AT phase 1's 256 x 3 x 128 x 128 and phase
   2's 128 x 3 x 224 x 224 (all four outputs and dx exactly the plain
   versions'), beside the float32 pair on the same image, with their SASS's
   conversions and packed bf16x2 instructions;
   K1/K2 in bfloat16 at fast-AT's three phases, 256 x 3 x 128 x 128,
   128 x 3 x 224 x 224 and 96 x 3 x 288 x 288, at the evaluate config's
   128 x 3 x 288 x 288, at 8 x 3 x 224 x 224 and at
   100 x 3 x 64 x 64, square on and off (the edge maps exact, out and y
   within one bf16 ulp, dx within the limits below), each beside its bound
   and its share of it; K4 forward and
   dgrad at 128 x 56 x 56, 64 -> 64, in float32 and bfloat16, timed on
   weights packed once and with the packing, beside cuDNN's convolution
   (float32 with TF32 off, so both sides compute at float32 accuracy).
4. The slices, each with every launch count set to 0 before it and read
   after it:
   a. the port's training driver on the flagship config
      (resnet18_EE_square, Tiny-ImageNet 64 px, batch 100, 200 classes,
      PGD-10 adversarial training), synthetic data, 3 train steps and 3
      validation batches; the loss must be finite and K1/K2's launch counts
      exact, with no other kernel launched;
   b. the same with the edge map smoothed (`gf: true`): exact K3a/K3b
      counts, no K1/K2 launch;
   c. free-AT on ImageNet (`configs/free_imagenet/free_at_ee.yml`:
      resnet50_EE, 1000 classes, 224 px, batch 256, float32, 4 replays a
      batch), 2 train steps and 1 validation batch: K1/K2 float32 launch
      4 and 4 times a step, 12 and 10 times a validation batch;
   d. fast-AT on ImageNet (`configs/fast_imagenet/fast_2px_phase1_ee.yml`:
      resnet50_EE, 128 px, batch 256, the bf16 policy), 2 train steps and 1
      validation batch: K1/K2 bfloat16 launch 2 and 1 times a step (the
      descent pass asks for no input gradient), 12 and 10 a validation
      batch. c and d print ms/step, peak device memory and the front-end
      kernels' share of the step;
   e. the GEMM-conv op (forward and its autograd backward, float32 and
      bfloat16) and the bench entry point tools/bench_gemm_conv over its
      three shapes, in bfloat16 and in float32: exact K4 counts; K4's and
      cuDNN's device times at each shape beside the bound;
   f. fast-AT phase 2 (`configs/fast_imagenet/fast_2px_phase2_ee.yml`:
      resnet50_EE, 224 px, batch 128, bf16) by --resume of d's checkpoint,
      one epoch of 2 train steps and 1 validation batch: the restored
      weights and momentum equal the file's bit for bit before the first
      step, the first logged epoch is the checkpoint's, K1/K2 bfloat16
      counts exact; ms/step, peak memory, the front-end's share;
   g. --evaluate of `configs/fast_imagenet/fast_2px_evaluate_ee.yml`
      (resnet50_EE, 288 px, batch 128, bf16, PGD-50) resumed from f's
      checkpoint, one validation batch: K1/K2 bfloat16 52 and 50 launches;
      ms per attack iteration;
   h. the port's eval.py (`--suite pgd,fgsm,cw`) on a's checkpoint, one
      batch of 100: PGD-10, PGD-50, PGD-100, FGSM and CW-20, K1/K2 float32
      12 + 52 + 102 + 3 + 23 and 10 + 50 + 100 + 1 + 20 launches; each
      battery's ms per attack iteration.
   i. the training objectives of objectives/methods.py through the driver
      at full width (ResNet-18, 200 classes, bs100, 64 px, f32, PGD-10,
      eps 16/255), 2 train steps and 1 validation batch each on 200
      synthetic images: first the 9 Tiny-ImageNet configs of the other
      kinds (ST, ALP, AVmixup, pre_square AT, targeted AT, tarALP,
      tarAVmixup, targeted EE AT, TRADES), then every new kind on the
      flagship's resnet18_EE_square (its method name swapped); TF32 set on
      before each run and found off after it (a float32 recipe computes in
      float32), a finite loss, and K1/K2's exact counts a step: K + 1 / K
      for the AT family and AVmixup, K + 2 / K for ALP, K + 3 / K for
      TRADES, 1 / 0 for ST, and K + 2 / K a validation batch (none where
      the model has no front-end); each run's ms/step and peak memory.
   j. AutoAttack and restart PGD on the flagship's checkpoint at 64 px:
      j1. the port's eval.py with --suite aa on one batch of 100 at the
      standard defaults (APGD-CE, APGD-T and FAB-T with 100 steps and 9
      target classes, Square with 1000 queries): K1/K2 float32 exactly
      5734 and 1900 launches, finite accuracies with robust <= clean, the
      batch's wall seconds, the front-end's share of them and the peak
      memory; j2. APGD-CE, APGD-T, FAB-T (5 steps) and Square (20 queries)
      on 8 images on the card and on the CPU path, TF32 off on both, with
      the same replayed draws: each forward's logits and the front-end's
      input gradient of the card's runs held in lockstep against the CPU
      path, the results compared sample by sample, within the limits
      below; j3.
      restart PGD (attacks/restart_pgd.py), l_inf and l_2, 2 restarts x 10
      iterations on j1's batch: K1 22 and K2 20 launches a norm, its time.
   k. the rest of the front-end through the driver at full width, 2 train
      steps and 1 validation batch each: k1. tiny_imagenet/ee_at_training.yml
      (resnet18_EE, the full CannyFilter, bs100, 64 px, PGD-10, f32), with the
      share of edge-map pixels that differ between card and CPU on a batch
      of 100 held to EDGE_FLIP_SHARE; k2. tiny_imagenet/ee_at_u2netp.yml (the
      U2-NetP edge map), ms/step and peak memory; k3.
      imagenet/targeted_ee_training.yml (tarEE, resnet18_EE at 224 px,
      bs256, 1000 classes, the full Canny as the registry's default); k4.
      the flagship with n_queries: 4 (its edge map on K3a/K3b in float32);
      k5. fast_2px_phase1_ee.yml with gf: true (the bf16 policy, its edge
      map on K3a/K3b in bfloat16). Each: a finite loss, exact launch counts
      (none for k1-k3, whose front-ends are plain PyTorch), ms/step and peak
      memory, and the reference below.
   l. the rest of the model zoo through the driver at full width, 2 train
      steps and 1 validation batch each, float32: l1. the 7 MNIST configs
      (Net2, Net2_EE, Net2_EE_square; bs50, 28 x 28 x 1, PGD-40), K1/K2
      41/40 a step for Net2_EE_square; l2. the denoising ResNet-18's two
      ImageNet configs (tarFD, tarFD_trick; 224 px, bs256, targeted
      PGD-10); l3. the 5 AWP configs (PreActResNet18, _EE, _EE_BPDA,
      _EE_BPDA_3 at 64 px bs100, and the CIFAR-100 stem at 32 px bs128;
      PGD-10), K1/K2 12/10 a step for _EE_BPDA_3 (the attack, the proxy's
      and the robust forward). Each: a finite loss, exact launch counts,
      ms/step, peak memory and the reference below.
   m. data parallelism (parallel/mesh.py), after l: m1. the flagship at
      full width (bs100, 64 px, PGD-10, f32, synthetic-hard) on 2 ranks
      on cuda:0 through gloo, started by this script (`--rank m1`, an
      explicit file:// init), 2 train steps and 1 validation batch, then
      each step again in one process from the ranks' state on the same
      global batch and draws: the replicas bitwise equal, the step's first
      attack gradient within M1_GRAD_TOL, then (the one process trained on
      the ranks' x_adv) the loss and the step's update within the limits
      below, K1/K2 34 and 30 launches a rank, ms/step of both; m2. the flagship through torchrun (`python -m
      torch.distributed.run --nproc_per_node 1`, 2 on a machine with 2
      cards: env://, NCCL) with --limit-batches 2 and --profile: one log,
      rank 0's checkpoint, its logits against the CPU (the reference
      below), a trace that names K1; m3. free-AT
      (`configs/free_imagenet/free_at_ee.yml`, 256 = 2 x 128 at 224 px) on
      2 ranks on cuda:0 through the driver, 1 step and its checkpoint,
      then --resume for 1 step: each rank's noise_p{rank}.pt restored bit
      for bit, the ranks' rows different, the weights and momentum the
      file's, K1/K2 16 and 14 a run, ms/step and peak memory a rank.
   n. real folders (before m): the port's JPEG decoder (data/native.py:
      csrc/eedata.cpp with g++, libjpeg where the machine has it, else
      PIL) built and its decode path printed; an ImageNet-layout folder of
      512 train and 256 validation JPEGs (2 classes, 500 x 375, 375 x 500,
      333 x 500 and 640 x 480, quality 92; written with PIL, or copied
      from tests/data/jpeg/ without it) read by fast-AT phase 1 through
      the driver, 2 train steps at bs256 on 128 px RandomResizedCrops and
      1 validation batch (K1/K2 bfloat16 exact, path folder_fast_at);
      then the flagship from a Tiny-ImageNet-layout JPEG folder (with
      val_annotations.txt), 1 step and 1 validation batch (path
      folder_flagship); the host's decode ms per batch, ms/step, and the
      seconds each step waited for its batch.
   o. the serving export (utils/export.py) through tools/export_model on
      the card from slice a's checkpoint, the batch symbolic: the graph
      holds K1's operator once; the artifact at 100 and 37 images, draws
      from one seed, equals the live eval forward bit for bit, launching
      K1 once a call and its plain version never (path export); the
      artifact's MB and ms per call.
   p. the rest of the JAX package's computations (after m):
      p1. the mesh's `model` axis (parallel/sharding.py): m1's flagship
      run (bs100, 64 px, 200 classes, f32, TF32 off, PGD-10, 2 steps and
      1 validation batch) on 2 ranks of data 1 x model 2, every
      convolution and the head cut on its output channels, on cuda:0
      through gloo; the model ranks' losses, x_adv and attack gradients
      bitwise equal; each step against one process from the ranks'
      gathered state on the same batch and draws, held to P1_*; the checkpoint
      gathered over the model group is the one-process file of the
      ranks' state; K1/K2 34/30 a rank, ms/step and peak memory a rank.
      p2. under the bf16 policy (half: true), 1 train step and 1
      validation batch each through the driver: ee_at_training.yml (the
      full Canny), the same with the BPDA Canny, ee_at_u2netp.yml and
      imagenet/targeted_feature_denoising_training.yml (resnet18_fd, 224
      px bs256); no kernel launched, ms/step, peak memory, the reference.
   q. steps_per_dispatch (train/graphs.py: K train steps a dispatch, one
      train step captured as a CUDA graph and replayed), after p:
      q1. the flagship at full width (bs100, 64 px, f32, TF32 off,
      PGD-10) through run() with K = 4 on 1000 synthetic images: 10 train
      steps in chains of 4, 4 and the tail's 2, and 5 validation batches;
      one capture, the log naming the CUDA graph, a finite loss, K1/K2
      exactly 170/150 (phase a's formula; path chained); ms/step over the
      full chains after the first dispatch beside the same run with
      single steps, in turns (eager, chained, chained, eager), and phase
      a's; the capture's seconds, peak memory. q2. two eager runs of 3
      flagship steps and one chained dispatch of 3 (step 1 eager, the
      capture, 2 replays) from one seed on the same batches, cuDNN
      deterministic: parameters, momentum, BatchNorm statistics and the
      last loss equal bit for bit. q3. phase i's 9 Tiny-ImageNet
      objectives with K = 2, one dispatch of 2 steps and 1 validation
      batch each: a capture each, exact K1/K2 counts by phase i's
      per-kind formulas (path chained_objectives).
   r. the chained step under several ranks and AWP on the model axis,
      after q: r1. m1's flagship (bs100, 50 a rank) on 2 ranks on cuda:0
      through gloo, the chained step in its loop form: 3 eager steps and
      one chained dispatch of 3 from one seed, cuDNN deterministic, equal
      bit for bit on each rank, the replicas alike, K1/K2 33/30 a rank
      (path chained_ranks_gloo); one more dispatch timed. r2. the same
      through NCCL in the graph form, the step's all-reduces captured with
      it (path chained_ranks_nccl): one rank a card where the machine has
      2, else both on cuda:0 with NCCL_HOSTID set apart for each rank
      (NCCL takes them as two hosts, over its socket transport on the
      loopback); the capture's seconds, ms/step a rank. Where NCCL
      refuses, the refusal prints and r2' runs instead: a world-1 NCCL
      group's all-reduce captured beside K1 and replayed, equal to eager.
      r3. AWP (awp_tiny_imagenet/ee_bpda_3_at_awp.yml, the gate on) on 2
      ranks of data 1 x model 2 through gloo, as p1: each step against one
      process from the ranks' gathered state, its perturbation within
      R3_DIFF_TOL, then on the ranks' perturbation within P1_*; K1/K2
      36/30 a rank (path awp_model_axis). `python3 chip_smoke.py --phase
      r` runs the device, the build and phase r alone.
   s. the port's whole-training twin (edge_enhancement_tpu_torch/tools/
      twin.py) on the flagship recipe: 1 seed, 1 epoch, 100 train and 50
      validation images of synthetic-hard at batch 25 (4 train steps of
      PGD-10, 2 validation batches of PGD-10); K1/K2 exactly 11/10 a step
      and 12/10 a validation batch, no other kernel (path twin); finite
      accuracies. Then the twin's two other loop shapes, free-AT's replay
      loop (free family: resnet18_EE with the full CannyFilter, 4 replays
      a batch, one noise buffer) and fast-AT's (fast family: resnet50_EE,
      FGSM from a uniform start, the knots' lr), 1 seed, 1 epoch, 50 train
      and 25 validation images: 2 train steps (8 and 2 SGD updates), 1
      validation batch of PGD-10, no kernel launched (paths twin_free,
      twin_fast); finite accuracies. `python3 chip_smoke.py --phase s`
      runs the device, the build and phase s alone.
5. The reference, for slices a to d, k, l, m2 and p2: the trained weights on a small
   batch, the card's path (kernels, cuDNN) against the same weights and
   draws on the CPU (the plain versions, which the CPU tests hold against
   the JAX package), in eval mode (the denoising ResNet in train mode).

Prints a JSON line of the kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failure raises: the exit
code is then non-zero and the last line is not printed. Exits non-zero when
CUDA is absent.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "edge_enhancement_tpu", "configs")
CONFIG = os.path.join(CONFIGS, "tiny_imagenet", "ee_at_bpda3_square.yml")
SLICE_ARGS = dict(data="synthetic", synthetic_size=600, epochs=1,
                  limit_batches=3, device="cuda")
# The ImageNet slices: 512 synthetic images make 2 train batches of 256 and
# a validation split of 256, 1 batch; epochs 1 (free-AT: ceil(1 / 4) = 1)
IMAGENET_SLICES = (
    ("free_at", os.path.join(CONFIGS, "free_imagenet", "free_at_ee.yml"),
     "ee_fused_fwd", "ee_fused_bwd", (4, 4)),
    ("fast_at", os.path.join(CONFIGS, "fast_imagenet", "fast_2px_phase1_ee.yml"),
     "ee_fused_fwd_bf16", "ee_fused_bwd_bf16", (2, 1)))
IMAGENET_ARGS = dict(data="synthetic", synthetic_size=512, epochs=1,
                     limit_batches=2, device="cuda")
# f and g: fast-AT phase 2 at bs128 on 256 synthetic images (2 train batches,
# a validation split of 128, 1 batch), then the evaluate config on its
# validation split of 128 (1 batch of PGD-50)
PHASE2 = os.path.join(CONFIGS, "fast_imagenet", "fast_2px_phase2_ee.yml")
EVALUATE = os.path.join(CONFIGS, "fast_imagenet", "fast_2px_evaluate_ee.yml")
RESUME_ARGS = dict(data="synthetic", synthetic_size=256, limit_batches=2,
                   device="cuda")
# h: eval.py's suite on the flagship's validation split of 100 (1 batch)
EVAL_ARGS = dict(data="synthetic", synthetic_size=200, limit_batches=1,
                 device="cuda", suite="pgd,fgsm,cw")
# K1's outputs: the edge maps agree exactly (same rounding order), the HFS
# products sum 64 FP32 terms in another order than cuBLAS: ~1e-6 on values
# of order 1. K2: the same sums, scaled by at most 1/|g| < 1/high = 3.4.
FWD_TOL, BWD_TOL = 2e-5, 1e-4
# K3a: the same operations in the same order as the plain version, so its
# outputs agree exactly. K3b: stencil adjoints summed in another order,
# scaled by at most 1/|g| < 3.4.
CANNY_FWD_TOL, CANNY_BWD_TOL = 0.0, 1e-4
# K4 vs its plain version (same operands, float32 sums of 9 * 64 = 576
# products of order 0.1 in another order): float32, as three TF32 products
# (3xTF32) whose sums are added up in float32 a ring step at a time, ~6e-6
# on outputs of order 10 (one TF32 product would be ~3e-3); bfloat16: both
# round a float32 sum once, so they differ by at most one bf16 ulp (2^-7
# relative) where the two sums straddle a rounding boundary, plus the
# float32 difference near zero.
CONV_F32_ATOL = 1e-4
CONV_BF16_ATOL, CONV_BF16_RTOL = 1e-4, 2.0 ** -7
# Logits of the small batch, card vs CPU, relative to the largest logit
# (eval-mode logits after 3 steps can reach the thousands): the edge maps
# agree bit for bit, the rest is two libraries' float32 convolutions. Under
# the bf16 policy both round every convolution's output to bfloat16 (2^-9
# relative) after float32 sums in other orders, through 53 layers.
REF_TOL, REF_TOL_BF16 = 1e-3, 5e-2
# K1/K2 bfloat16 against their plain versions: the edge maps exact, out and
# y within one bf16 ulp, at most BF16_DX_SHARE of dx more than one ulp off
# and none more than BF16_DX_REL of the largest |dx| (tests/test_torch_cuda.py
# explains them).
BF16_DX_REL, BF16_DX_SHARE = 2.0 ** -7, 1e-2
# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor),
# dense bf16 and dense TF32 tensor-core FLOP/s.
PEAK_BYTES, PEAK_F32, PEAK_BF16, PEAK_TF32 = 3.35e12, 67e12, 989e12, 494.7e12
# K4 against cuDNN in the bench: bf16 within a few bf16 ulps of outputs of
# order 10; float32 within 1e-3, not K4's 1e-4, because cuDNN may pick a
# Winograd or FFT algorithm that carries its own ~1e-4 error.
BENCH_BF16_DIFF, BENCH_F32_DIFF = 0.5, 1e-3
# i: the Tiny-ImageNet configs of the other objective kinds, then the new
# kinds on the flagship config (method name and the shipped configs' keys),
# each at full width for 2 train steps and 1 validation batch of 100
OBJECTIVE_CONFIGS = ("standard_training", "alp_training", "avmixup_training",
                     "ee_at_bpda3_pre_square", "targeted_adversarial_training",
                     "targeted_alp_training", "targeted_avmixup_training",
                     "targeted_ee_at_bpda3_square", "trades_training")
FLAGSHIP_KINDS = (("ST", {}), ("tarEE_BPDA3_AT_square", {}),
                  ("tarEE_trick", dict(label_smooth=0.1, prob_start_from_clean=0.2)),
                  ("ALP", dict(beta=1.0)), ("tarALP", dict(beta=1.0)),
                  ("TRADES", dict(beta=6.0)), ("AVmixup", {}), ("tarAVmixup", {}))
OBJECTIVE_ARGS = dict(data="synthetic", synthetic_size=200, epochs=1,
                      limit_batches=2, device="cuda")
# j: eval.py --suite aa at the standard defaults (APGD 100 steps, FAB 100,
# Square 1000 queries, 9 target classes) on the flagship's checkpoint, one
# batch of 100
AA_ARGS = dict(EVAL_ARGS, suite="aa", aa_batches=1)
AA_STANDARD = dict(apgd=100, fab=100, queries=1000, n_tc=9)
# j2: the attacks on 8 images, card against CPU (TF32 off on both), on the
# same draws. Five APGD steps, five FAB steps or twenty Square queries take
# discrete decisions (a step halving, the max-loss point, an accepted
# square, FAB's backward step) on values that can tie to float32 rounding,
# and a sample whose decision differs follows another trajectory from
# there: tools/attack_split.py --sets 10 shows the port's own float32 and
# float64 runs on the CPU part so on 0-2 samples of an attack's 8, and the
# card's runs parted from the CPU's on up to 5 of 8 (APGD-CE on an H100).
# So whole trajectories are printed, not held. What is held is each call
# of the card's runs against the CPU path at the same input and draws
# (tools/attack_split.py::Lockstep): the logits within REF_TOL of
# max(1, max |logit|), as in the reference phase, and the front-end's
# input gradient (K2 against the plain adjoint, through the same autograd
# wiring as the model) within AA_FRONTEND_TOL of its norm: both sides sum
# in float32 in other orders (~1e-6). The whole model's input gradient is
# printed, not held: it jumps where the backbone sits on a tie (equal
# convolution outputs over a saturated patch, which a pooling window
# routes by position and the two libraries round apart), by up to ~1e-2
# of its norm on an H100. A parted trajectory may end on the other side
# of the boundary (1 of 8 in one H100 run); a fault of the attacks' own
# arithmetic on the card would flip most, so at most AA_FLIP_SAMPLES (half)
# may end misclassified on one side only.
AA_CMP_N, AA_CMP_STEPS, AA_CMP_QUERIES = 8, 5, 20
AA_FRONTEND_TOL, AA_FLIP_SAMPLES = 1e-4, AA_CMP_N // 2
# j3: restart PGD (the AWP drivers' attack_pgd), 2 restarts x 10 iterations,
# at the AWP drivers' radii: l_inf 16/255 (the flagship's eps) with steps
# of 2/255, l_2 128/255 with steps of 15/255
RESTART_PGD = (dict(norm="l_inf", epsilon=16 / 255, alpha=2 / 255),
               dict(norm="l_2", epsilon=128 / 255, alpha=15 / 255))
RESTART_PGD_ITERS, RESTART_PGD_RESTARTS = 10, 2
# the K4 check's shape (ResNet-50 layer1), and the bench's repetitions
CONV_SHAPE = (128, 56, 56, 64, 64)
BENCH_REPS = 5
# K1/K2's further checks: ImageNet's 224 px, which the row-band kernels
# take, on a few images and at free-AT's batch
LARGE_SHAPES = ((8, 3, 224, 224), (256, 3, 224, 224))
# the flagship's front-end constants (FusedConsts fields)
FLAGSHIP_CONSTS = dict(r=8, eps=0.062745098039216, w=1.0, alpha=0.0,
                       high=76.0 / 255.0, sigma=1.0, square=True)
# K1/K2 at phase l's shapes: mnist/ee_at_bpda3_square.yml (Net2_EE_square,
# one channel at 28 px, r 4, the square at eps 0.3, alpha 0.3, high 51) and
# awp_tiny_imagenet/ee_bpda_3_at_awp.yml (PreActResNet18_EE_BPDA_3 at 64 px,
# r 8, no square)
ZOO_SHAPES = (
    ((50, 1, 28, 28), dict(r=4, eps=0.3, w=1.0, alpha=0.3, high=51.0 / 255.0,
                           sigma=1.0, square=True), "at_50x1x28x28"),
    ((100, 3, 64, 64), dict(FLAGSHIP_CONSTS, eps=16 / 255, square=False),
     "at_100x3x64x64_no_square"))
# K1/K2 bfloat16: fast-AT's phase 1 (128 px, its slice's shape) first, then
# phases 2 and 3 (fast_*_phase2_ee.yml, fast_*_phase3_ee.yml), the evaluate
# config's batch at 288 px (fast_*_evaluate_ee.yml), a few images at 224 px,
# and 64 px
BF16_SHAPES = ((256, 3, 128, 128), (128, 3, 224, 224), (96, 3, 288, 288),
               (128, 3, 288, 288), (8, 3, 224, 224), (100, 3, 64, 64))
# K3a/K3b's further check: ImageNet's batch at 224 px, 180 MB a launch
CANNY_LARGE_SHAPES = ((128, 3, 224, 224),)
# K3a/K3b bfloat16: fast-AT phase 1's shape (the k5 path's), then phase 2's
CANNY_BF16_SHAPES = ((256, 3, 128, 128), (128, 3, 224, 224))
# k: (tag, config, keys over the config's, driver arguments, the front-end
# kernels it runs and their launches a train step, or None for a plain
# PyTorch front-end). Validation batches run PGD-K: K + 2 forwards and K
# input gradients.
VARIANTS = (
    ("k1_canny", os.path.join(CONFIGS, "tiny_imagenet", "ee_at_training.yml"), {},
     OBJECTIVE_ARGS, None),
    ("k2_u2netp", os.path.join(CONFIGS, "tiny_imagenet", "ee_at_u2netp.yml"), {},
     OBJECTIVE_ARGS, None),
    ("k3_imagenet_canny", os.path.join(CONFIGS, "imagenet", "targeted_ee_training.yml"),
     {}, IMAGENET_ARGS, None),
    ("k4_queries", CONFIG, dict(n_queries=4), OBJECTIVE_ARGS,
     ("canny_fused_fwd", "canny_fused_bwd", (11, 10))),
    ("k5_fast_gf", os.path.join(CONFIGS, "fast_imagenet", "fast_2px_phase1_ee.yml"),
     dict(gf=True), IMAGENET_ARGS, ("canny_fused_fwd_bf16", "canny_fused_bwd_bf16", (2, 1))))
# l: (tag, config, driver arguments, K1/K2 launches a train step as a
# function of the attack's K, or None where the front-end is plain PyTorch
# or absent). The AWP step runs K attack forwards with K input gradients,
# the proxy's and the robust forward (no input gradient: the front-end has
# no parameters), so K + 2 and K.
MNIST_ARGS = dict(data="synthetic", synthetic_size=100, epochs=1, limit_batches=2,
                  device="cuda")
AWP_ARGS = dict(data="synthetic", synthetic_size=200, epochs=1, limit_batches=2,
                device="cuda")
ZOO_RUNS = (
    *((f"l1_mnist_{n}", os.path.join(CONFIGS, "mnist", f"{n}.yml"), MNIST_ARGS,
       (lambda k: (k + 1, k)) if n == "ee_at_bpda3_square" else None)
      for n in ("standard_training", "adversarial_training", "alp_training", "avmixup",
                "trades_training", "ee_at_training", "ee_at_bpda3_square")),
    *((f"l2_{n}", os.path.join(CONFIGS, "imagenet", f"{n}.yml"), IMAGENET_ARGS, None)
      for n in ("targeted_feature_denoising_training",
                "targeted_feature_denoising_trick_training")),
    *((f"l3_{n}", os.path.join(CONFIGS, "awp_tiny_imagenet", f"{n}.yml"), AWP_ARGS,
       (lambda k: (k + 2, k)) if n == "ee_bpda_3_at_awp" else None)
      for n in ("at_awp", "ee_at_awp", "ee_bpda_at_awp", "ee_bpda_3_at_awp")),
    ("l3_cifar100_at_awp", os.path.join(CONFIGS, "awp_cifar100", "at_awp.yml"),
     dict(AWP_ARGS, synthetic_size=256), None))
# k1: the full Canny's edge map, card against CPU, on a batch of 100 at
# 64 px. Its NMS bins atan(gy / gx), and CUDA's atan is not glibc's: a pixel
# whose angle sits on a bin's edge can land in the other bin (and the
# magnitudes of a few pixels in the other rounding order of the Sobel
# sums are equal on one side), so a few pixels may flip
EDGE_FLIP_SHARE = 1e-3
# the reference logits where the card's and the CPU's edge maps differ on
# the reference batch: one flipped edge pixel moves its image's logits
REF_TOL_FLIP = 5e-2
# m: data parallelism (parallel/mesh.py). m1 and m3 put M_WORLD ranks on the
# one card through gloo (NCCL refuses two ranks on one device; gloo's CUDA
# all-reduce goes through host memory, so their times measure correctness,
# not scaling); m2 starts the driver under torchrun (env://, NCCL), on two
# cards where the machine has two. Every rank process runs under
# M_TIMEOUT seconds, and a rank that fails takes the others down.
M_WORLD = 2
M_TIMEOUT = 600
# m1: the flagship at full width on synthetic-hard, 2 train steps and 1
# validation batch of 100 (50 a rank); then each step again in one process
# (twice), from the ranks' state before it, on the same global batch and
# draws. The ranks' replicas are bitwise equal. Against the one process
# the BatchNorm sums run in other orders (two half-batch partial sums):
# the first attack gradient of a step is 8.2e-4 to 5.4e-3 of its norm
# apart on an H100, its signs 99.96% alike or more (tests/
# test_torch_parallel.py holds the same arithmetic to 1e-10 in float64 on
# the CPU). PGD-10 turns that into another x_adv: 68-74% of the pixels
# apart, and up to 72% between two runs of the one process (cuDNN's
# algorithms are not deterministic). So x_adv is printed, not held, and
# what is held: the first attack gradient within M1_GRAD_TOL of its norm;
# then, the one process trained on the ranks' x_adv, the loss within
# M1_LOSS_RTOL (1.1e-7 at most, measured) and the step's parameter update
# within M1_UPDATE_TOL of its norm (5.6e-3 at most; a missing gradient
# sum would take half of it). The parameter vector (7.9e-5 of its norm at
# most), the worst tensor (near-zero BatchNorm biases, up to 1.3e-2 of
# their largest value) and the momentum are printed.
M1_ARGS = dict(data="synthetic-hard", synthetic_size=400, epochs=1, limit_batches=2,
               device="cuda:0")
M1_GRAD_TOL, M1_LOSS_RTOL, M1_UPDATE_TOL = 3e-2, 1e-4, 5e-2
# m3: free-AT at full width (resnet50_EE, 224 px, bs256: 128 a rank), 1 step,
# the checkpoint, then --resume for 1 step
M3_ARGS = dict(data="synthetic", synthetic_size=512, epochs=1, limit_batches=1,
               device="cuda:0")

# n: real folders written by the script (PIL): ImageNet's layout with 2
# classes, 512 train and 256 validation JPEGs of four shapes (h, w), read by
# fast-AT phase 1 (2 train steps of 256, 1 validation batch); then
# Tiny-ImageNet's layout, 64 x 64, for the flagship (1 step, 1 batch of 100)
FOLDER_TRAIN, FOLDER_VAL = 512, 256
FOLDER_SIZES = ((375, 500), (500, 375), (500, 333), (480, 640))
TINY_CLASSES, TINY_PER_CLASS = 10, 10
# one JPEG of each of those shapes, copied where PIL is not installed
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
FOLDER_ARGS = dict(epochs=1, limit_batches=2, device="cuda")
# o: the exported flagship at two batch sizes, draws from one seed
EXPORT_BATCHES, EXPORT_SEED = (100, 37), 11
# p1: the mesh's `model` axis (parallel/sharding.py): m1's flagship run on
# M_WORLD ranks of data 1 x model P1_MODEL, every convolution and the head
# cut on its output channels, on the one card through gloo; each step
# against one process from the ranks' gathered state on the same batch and
# draws; the gathered checkpoint is the one-process file. With one data
# rank no BatchNorm sum is split, so p1 parts from the one process far less
# than m1 (on an H100, 700 W: first attack gradients 1.52e-6 of their norm
# at most, losses 2.1e-7, updates 2.8e-6 of the update) and is held to
# P1_GRAD_TOL, P1_LOSS_RTOL and P1_UPDATE_TOL, about ten times those
P1_MODEL = 2
P1_GRAD_TOL, P1_LOSS_RTOL, P1_UPDATE_TOL = 2e-5, 2e-6, 3e-5
# p2: the full and BPDA Canny, the U2-NetP and the denoising blocks under
# the bf16 policy, one train step and one validation batch each through
# the driver (plain PyTorch front-ends: no kernel), logits card vs CPU
P2_RUNS = (
    ("p2_canny_bf16", os.path.join(CONFIGS, "tiny_imagenet", "ee_at_training.yml"), {},
     OBJECTIVE_ARGS),
    ("p2_bpda_bf16", os.path.join(CONFIGS, "tiny_imagenet", "ee_at_training.yml"),
     dict(type_canny="CannyFilter_BPDA"), OBJECTIVE_ARGS),
    ("p2_u2netp_bf16", os.path.join(CONFIGS, "tiny_imagenet", "ee_at_u2netp.yml"), {},
     OBJECTIVE_ARGS),
    ("p2_fd_bf16", os.path.join(CONFIGS, "imagenet", "targeted_feature_denoising_training.yml"),
     {}, IMAGENET_ARGS))
# q: steps_per_dispatch (train/graphs.py). q1: the flagship at full width
# through run() with K = 4 on 1000 synthetic images, 10 train batches
# (chains of 4, 4 and the tail's 2) and 5 validation batches; beside it the
# same run with single steps, in turns (eager, chained, chained, eager)
CHAINED_ARGS = dict(data="synthetic", synthetic_size=1000, epochs=1, limit_batches=10,
                    device="cuda")
CHAINED_K, CHAINED_STEPS, CHAINED_EVALS = 4, 10, 5
# q2: 3 eager steps against one chained dispatch of 3, from one seed; then
# Q2_TIMED more dispatches of the graph, timed on the host and the device
Q2_STEPS, Q2_TIMED = 3, 3
# q3: phase i's 9 Tiny-ImageNet configs, K = 2: one dispatch of 2 steps and
# 1 validation batch each
Q3_ARGS = dict(OBJECTIVE_ARGS, steps_per_dispatch=2)
# r: the chained step under M_WORLD ranks and AWP on the model axis. r1 and
# r2: m1's flagship (bs100, 50 a rank) from one seed, R_STEPS eager steps
# and one chained dispatch of R_STEPS, cuDNN deterministic, equal bit for
# bit; then R_TIMED more dispatches timed. r1 through gloo (the loop form),
# r2 through NCCL (the graph form, its all-reduces captured), one rank a
# card where the machine has M_WORLD cards, else both on the one card with
# NCCL_HOSTID set apart for each rank (NCCL refuses two ranks of one host
# on one card, and takes them as two hosts over its socket transport on
# the loopback). Where NCCL refuses all the same, r2' instead captures a
# world-1 NCCL group's all-reduce beside K1 and replays it. r3: AWP
# (awp_tiny_imagenet/ee_bpda_3_at_awp.yml, PreActResNet18_EE_BPDA_3, the
# gate on) on data 1 x model P1_MODEL through gloo, as p1 runs the
# flagship, held to one process within P1_*. A rank process of r2 runs
# under R2_TIMEOUT seconds.
R_STEPS, R_TIMED, R2_TIMEOUT = 3, 1, 300
# r3's perturbation against the one process's: d = (w + proxy_lr g) - w
# rounds in float32 (the proxy's step is small beside w), so two runs whose
# proxy gradients part by 1.4e-6 part there by 1.32e-5 to 1.38e-5 (H100,
# 700 W); held to about seven times that. Norms of a cut weight's rows
# alone would move it by tens of percent
R3_DIFF_TOL = 1e-4
R3_CONFIG = os.path.join(CONFIGS, "awp_tiny_imagenet", "ee_bpda_3_at_awp.yml")
# s: the twin's flagship family at 1 seed and 1 epoch: 4 train steps and 2
# validation batches of 25
TWIN_ARGS = dict(seeds=[1], epochs=1, n_train=100, n_val=50)
TWIN_STEPS, TWIN_EVALS = 4, 2
# s: the free and fast families at 1 seed and 1 epoch: 2 train steps (the
# free family's 4 replays each) and 1 validation batch of 25
TWIN_LOOPS = ("free", "fast")
TWIN_LOOP_ARGS = dict(seeds=[1], epochs=1, n_train=50, n_val=25)
TWIN_LOOP_STEPS, TWIN_LOOP_EVALS = 2, 1

def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """The least time for the work: bytes at the memory rate or operations
    at the peak rate of their type, whichever is longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return name, smi


def build_phase():
    from edge_enhancement_tpu_torch.ops.cuda import build
    t0 = time.time()
    libs = build.load_all()
    print(f"[build] {len(libs)} sources in parallel, {time.time() - t0:.1f} s "
          "wall", flush=True)
    for name, lib in libs.items():
        print(f"[build] {os.path.relpath(lib.path, ROOT)}: nvcc "
              f"{lib.build_seconds:.1f} s", flush=True)
        print(lib.log.strip(), flush=True)
    # both K4 kernels must run on the tensor cores: the library holds wgmma
    # (HGMMA in SASS) of both forms, or a build that fell back to FP32 FMAs
    # would pass
    hgmma = re.findall(r"HGMMA[.\w]*", build.sass(libs["gemm_conv"].path))
    forms = {t: sum(h.endswith(f".F32.{t}") for h in hgmma) for t in ("BF16", "TF32")}
    print(f"[build] gemm_conv SASS: {len(hgmma)} HGMMA instructions "
          f"({', '.join(sorted(set(hgmma)))}); by form {forms}", flush=True)
    if not all(forms.values()):
        fail(f"the gemm_conv library lacks an HGMMA form: {forms}")
    # the bfloat16 K1/K2 run their products on the tensor cores: bf16 inputs,
    # float32 sums, as mma.sync (HMMA) or wgmma (HGMMA)
    sass = build.sass(libs["ee_fused"].path)
    mma = re.findall(r"HG?MMA[.\w]*", sass)
    bf16 = sorted({m for m in mma if m.endswith(".F32.BF16")})
    print(f"[build] ee_fused SASS: {len(mma)} tensor-core instructions "
          f"({', '.join(sorted(set(mma)))}); bf16 with float32 sums: {bf16}", flush=True)
    if not bf16:
        fail("the ee_fused library holds no bf16 tensor-core instruction "
             "(HMMA/HGMMA .F32.BF16)")
    # the bfloat16 K3a/K3b compute in packed bf16x2 instructions (HADD2,
    # HMUL2, HFMA2.MMA .BF16_V2): kernels that computed in float32 and
    # rounded value by value would pass their checks
    k3 = {re.search(r"canny_\w+?_bf16_kernel", k).group(0): v
          for k, v in build.sass_counts(sass).items() if "_bf16_kernel" in k}
    print(f"[build] bf16 K3a/K3b SASS, packed bf16x2 instructions: "
          f"{ {k: v['bf16x2'] for k, v in sorted(k3.items())} }", flush=True)
    if len(k3) != 2 or not all(v["bf16x2"] for v in k3.values()):
        fail(f"the bfloat16 K3a/K3b hold no packed bf16x2 arithmetic: {k3}")


def _timings(torch, kernel, plain, library=None) -> dict:
    """ms: the kernel's device time per launch; call_ms: one eager call of
    its wrapper; plain_ms, library_ms: device time per call of the plain
    version and of the one PyTorch call that computes the same function."""
    from edge_enhancement_tpu_torch.utils.cuda_timing import device_ms, median_ms
    with torch.no_grad():
        return {"ms": device_ms(kernel), "call_ms": median_ms(kernel),
                "plain_ms": device_ms(plain),
                "library_ms": None if library is None else device_ms(library)}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _patched_input(torch, dev, shape=(100, 3, 64, 64)):
    """float32 noise of `shape` (the slice's by default) with a constant
    patch (|g| = 0 inside) and saturated pixels, placed as at 64 x 64."""
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    at = lambda v: v * shape[2] // 64
    x[:, :, at(8):at(24), at(8):at(24)] = 0.5
    x[::2, :, at(40):at(56), 0:at(16)] = 1.0
    x[1::2, :, at(40):at(56), at(40):at(60)] = 0.0
    return torch.from_numpy(x).to(dev)


def _front_end_case(torch, shape, consts=None):
    """K1 and K2 against their plain versions at `shape`, with the
    front-end constants `consts` (FusedConsts fields; default the
    flagship's, the square on): the errors, the times and the bounds. K2 is
    held against the plain adjoint and against autograd of the plain
    forward (given the plain forward's y, so both sides see the same clip
    mask)."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import (add_square_draws,
                                                       kernel_layout)

    dev = torch.device("cuda")
    x = _patched_input(torch, dev, shape)
    b, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    k = F.FusedConsts(**(consts or FLAGSHIP_CONSTS))
    st = sqd = None
    if k.square:
        st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), k.eps)
    u = torch.randn(x.shape, generator=gen, device=dev)

    out_k, y_k = F.ee_fused_fwd(x, st, sqd, k)
    torch.cuda.synchronize()
    out_p, y_p = F.ee_fused_fwd_plain(x, st, sqd, k)
    fwd_err = max((out_k - out_p).abs().max().item(),
                  (y_k - y_p).abs().max().item())
    dx_k = F.ee_fused_bwd(u, x, st, sqd, y_k, k)
    torch.cuda.synchronize()
    bwd_err = (dx_k - F.ee_fused_bwd_plain(u, x, st, sqd, y_k, k)).abs().max().item()
    xa = x.clone().requires_grad_(True)
    out_a, y_a = F.ee_fused_fwd_plain(xa, st, sqd, k)
    (g_auto,) = torch.autograd.grad((out_a * u).sum(), [xa])
    dx_ka = F.ee_fused_bwd(u, x, st, sqd, y_a.detach().contiguous(), k)
    torch.cuda.synchronize()
    auto_err = (dx_ka - g_auto).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (out_k, y_k, dx_k))
    tag = "x".join(map(str, shape)) + ("" if k.square else ", no square")
    print(f"[kernels] at ({tag}): K1 vs plain: max |err| {fwd_err:.3e} (limit "
          f"{FWD_TOL}); K2 vs plain adjoint: {bwd_err:.3e}, vs autograd of plain "
          f"forward: {auto_err:.3e} (limit {BWD_TOL}); max |dx| "
          f"{dx_k.abs().max().item():.3f}", flush=True)
    if not finite or fwd_err > FWD_TOL or bwd_err > BWD_TOL or auto_err > BWD_TOL:
        fail(f"a kernel disagrees with its plain version at {tag}")

    t1 = _timings(torch, lambda: F.ee_fused_fwd(x, st, sqd, k),
                  lambda: F.ee_fused_fwd_plain(x, st, sqd, k))
    t2 = _timings(torch, lambda: F.ee_fused_bwd(u, x, st, sqd, y_k, k),
                  lambda: F.ee_fused_bwd_plain(u, x, st, sqd, y_k, k))
    # bounds: the four HFS products per (image, channel) plane, two of
    # 2 H^2 W and two of 2 H W^2 FLOPs, on the FP32 pipes (the stencils add
    # < 1%); bytes: each operand read once and each output written once
    flops = b * c * (4 * h * h * w + 4 * h * w * w)
    ops = F.operators(h, w, k.r, k.sigma, dev)
    b1 = bound(_nbytes(x, st, sqd, *ops, out_k, y_k), flops, PEAK_F32)
    b2 = bound(_nbytes(u, x, y_k, st, sqd, *ops, dx_k), flops, PEAK_F32)
    print(f"[kernels] at ({tag}), ms per launch on the device (eager call in "
          f"brackets): K1 {t1['ms']:.4f} ({t1['call_ms']:.4f}) vs plain "
          f"{t1['plain_ms']:.4f}, bound {b1['bound_us']:.2f} us ({b1['bound_by']}), "
          f"{100 * b1['bound_ms'] / t1['ms']:.1f}% of it; K2 {t2['ms']:.4f} "
          f"({t2['call_ms']:.4f}) vs plain {t2['plain_ms']:.4f}, bound "
          f"{b2['bound_us']:.2f} us ({b2['bound_by']}), "
          f"{100 * b2['bound_ms'] / t2['ms']:.1f}% of it", flush=True)
    return ({"max_abs_err": fwd_err, **t1, **b1},
            {"max_abs_err": max(bwd_err, auto_err), **t2, **b2})


def kernel_phase(torch):
    """K1 and K2 at the slice's shape, at ImageNet's 224 px, and at phase
    l's two new shapes (MNIST's one channel, the AWP config's no square)."""
    k1, k2 = _front_end_case(torch, (100, 3, 64, 64))
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    cases = [(shape, None, "at_" + "x".join(map(str, shape))) for shape in LARGE_SHAPES]
    cases += list(ZOO_SHAPES)
    for shape, consts, at in cases:
        l1, l2 = _front_end_case(torch, shape, consts)
        k1[at] = {k: l1[k] for k in keys}
        k2[at] = {k: l2[k] for k in keys}
    src = "edge_enhancement_tpu_torch/csrc/ee_fused.cu"
    return [
        {"name": "ee_fused_fwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:409",
         **k1},
        {"name": "ee_fused_bwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:427",
         **k2},
    ]


def _bf16_case(torch, shape, square: bool):
    """K1 and K2 in bfloat16 against their plain versions at `shape`: the
    edge map exact (a flip moves y by w = 1), out and y within one bf16 ulp,
    dx within BF16_DX_SHARE and BF16_DX_REL; the times and the bounds."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import (add_square_draws,
                                                       kernel_layout)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    x = _patched_input(torch, dev, shape).to(bf16)
    b, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = 0.062745098039216
    st = sqd = None
    if square:
        st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), eps, bf16)
    k = F.FusedConsts(r=8, eps=eps, w=1.0, alpha=0.0, high=76.0 / 255.0,
                      sigma=1.0, square=square)
    u = torch.randn(x.shape, generator=gen, device=dev).to(bf16)

    out_k, y_k = F.ee_fused_fwd(x, st, sqd, k)
    torch.cuda.synchronize()
    out_p, y_p = F.ee_fused_fwd_plain(x, st, sqd, k)
    flips = int(((y_k.float() - y_p.float()).abs() >= 0.5).sum().item())
    fwd_ulps = max(F.bf16_ulps(out_k, out_p).max().item(),
                   F.bf16_ulps(y_k, y_p).max().item())
    fwd_err = max((out_k.float() - out_p.float()).abs().max().item(),
                  (y_k.float() - y_p.float()).abs().max().item())
    dx_k = F.ee_fused_bwd(u, x, st, sqd, y_k, k)
    torch.cuda.synchronize()
    dx_p = F.ee_fused_bwd_plain(u, x, st, sqd, y_k, k)
    share = (F.bf16_ulps(dx_k, dx_p) > 1).float().mean().item()
    bwd_err = (dx_k.float() - dx_p.float()).abs().max().item()
    dx_max = dx_p.float().abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (out_k, y_k, dx_k))
    tag = "x".join(map(str, shape)) + (" square" if square else "")
    print(f"[kernels] bf16 at ({tag}): K1 vs plain: {flips} edge flips, max "
          f"{fwd_ulps:.0f} ulp, max |err| {fwd_err:.3e} (limits 0, 1 ulp); K2 vs plain: "
          f"{100 * share:.4f}% of dx more than one ulp off (limit "
          f"{100 * BF16_DX_SHARE}%), max |err| {bwd_err:.3e} (limit "
          f"{BF16_DX_REL * dx_max:.3e}, max |dx| {dx_max:.3f})", flush=True)
    if (not finite or flips or fwd_ulps > 1 or share > BF16_DX_SHARE
            or bwd_err > BF16_DX_REL * dx_max or dx_max < 0.1
            or {out_k.dtype, y_k.dtype, dx_k.dtype} != {bf16}):
        fail(f"a bfloat16 kernel disagrees with its plain version at {tag}")

    t1 = _timings(torch, lambda: F.ee_fused_fwd(x, st, sqd, k),
                  lambda: F.ee_fused_fwd_plain(x, st, sqd, k))
    t2 = _timings(torch, lambda: F.ee_fused_bwd(u, x, st, sqd, y_k, k),
                  lambda: F.ee_fused_bwd_plain(u, x, st, sqd, y_k, k))
    # the four products as bf16 x bf16 summed in float32, what the bf16
    # tensor cores do; bytes: the bf16 planes and the operators the kernels
    # read (K1's A as float32), once each
    flops = b * c * (4 * h * h * w + 4 * h * w * w)
    ops1 = F.band_operators(h, w, 8, False, dev, bf16)
    ops2 = F.band_operators(h, w, 8, True, dev, bf16)
    b1 = bound(_nbytes(x, st, sqd, *ops1, out_k, y_k), flops, PEAK_BF16)
    b2 = bound(_nbytes(u, x, y_k, st, sqd, *ops2, dx_k), flops, PEAK_BF16)
    print(f"[kernels] bf16 at ({tag}), ms per launch on the device (eager call in "
          f"brackets): K1 {t1['ms']:.4f} ({t1['call_ms']:.4f}) vs plain "
          f"{t1['plain_ms']:.4f}, bound {b1['bound_us']:.2f} us ({b1['bound_by']}), "
          f"{100 * b1['bound_ms'] / t1['ms']:.1f}% of it; K2 {t2['ms']:.4f} "
          f"({t2['call_ms']:.4f}) vs plain {t2['plain_ms']:.4f}, bound "
          f"{b2['bound_us']:.2f} us ({b2['bound_by']}), "
          f"{100 * b2['bound_ms'] / t2['ms']:.1f}% of it", flush=True)
    return ({"max_abs_err": fwd_err, "max_ulps": fwd_ulps, **t1, **b1},
            {"max_abs_err": bwd_err, "share_over_1_ulp": share, **t2, **b2})


def bf16_kernel_phase(torch):
    """K1 and K2 in bfloat16: the first row is fast-AT's shape without the
    square (resnet50_EE), the others under at_<shape>[_square]."""
    rows = None
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for shape in BF16_SHAPES:
        for square in (False, True):
            r1, r2 = _bf16_case(torch, shape, square)
            if rows is None:
                rows = (r1, r2)
                continue
            at = "at_" + "x".join(map(str, shape)) + ("_square" if square else "")
            rows[0][at] = {k: r1[k] for k in keys}
            rows[1][at] = {k: r2[k] for k in keys}
    src = "edge_enhancement_tpu_torch/csrc/ee_fused.cu"
    return [
        {"name": "ee_fused_fwd_bf16", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:409", **rows[0]},
        {"name": "ee_fused_bwd_bf16", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:427", **rows[1]},
    ]


def _canny_case(torch, shape):
    """K3a and K3b against their plain versions at `shape`: the errors, the
    times and the bounds. K3b is held against the plain adjoint and against
    autograd of the plain forward."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F

    dev = torch.device("cuda")
    x = _patched_input(torch, dev, shape)
    high, sigma, alpha = 76.0 / 255.0, 1.0, 0.0
    b, c, h, w = x.shape
    u = torch.randn((b, 1, h, w), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    outs_k = F.canny_fused_fwd(x, high, sigma, alpha)
    torch.cuda.synchronize()
    outs_p = F.canny_fused_fwd_plain(x, high, sigma, alpha)
    fwd_err = max((a - p).abs().max().item() for a, p in zip(outs_k, outs_p))
    _, mag, gx, gy = outs_k
    dx_k = F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha)
    torch.cuda.synchronize()
    bwd_err = (dx_k - F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma,
                                              alpha)).abs().max().item()
    xa = x.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(
        (F.canny_fused_fwd_plain(xa, high, sigma, alpha)[0] * u).sum(), [xa])
    auto_err = (dx_k - g_auto).abs().max().item()
    edge_share = outs_k[0].mean().item()
    tag = "x".join(map(str, shape))
    print(f"[kernels] at ({tag}): K3a vs plain (out, mag, gx, gy): max |err| "
          f"{fwd_err:.3e} (limit {CANNY_FWD_TOL}), edge share {edge_share:.4f}; K3b vs "
          f"plain adjoint {bwd_err:.3e}, vs autograd of plain forward {auto_err:.3e} "
          f"(limit {CANNY_BWD_TOL}); max |dx| {dx_k.abs().max().item():.3f}", flush=True)
    finite = all(bool(torch.isfinite(t).all()) for t in (*outs_k, dx_k))
    if (not finite or fwd_err > CANNY_FWD_TOL or bwd_err > CANNY_BWD_TOL
            or auto_err > CANNY_BWD_TOL or not 0.0 < edge_share < 1.0
            or dx_k.abs().max().item() == 0.0):
        fail(f"a Canny kernel disagrees with its plain version at {tag}")
    t3a = _timings(torch, lambda: F.canny_fused_fwd(x, high, sigma, alpha),
                   lambda: F.canny_fused_fwd_plain(x, high, sigma, alpha))
    t3b = _timings(torch, lambda: F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha),
                   lambda: F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma, alpha))
    # operations per pixel: K3a blurs C planes (17 each), sums them (C - 1),
    # two Sobels (11 each), divides (2), magnitude (4) and two compares;
    # K3b gates (6), scales (5), two Sobel adjoints (12 each), divides,
    # the blur's adjoint (18) and its C stores are bytes
    px = b * h * w
    b3a = bound(_nbytes(x, *outs_k), px * (18 * c + 29), PEAK_F32)
    b3b = bound(_nbytes(u, mag, gx, gy, dx_k), px * 54, PEAK_F32)
    geo = F.canny_geometry(c, h, w)
    print(f"[kernels] at ({tag}), {geo.tiles_h * geo.tiles_w * b} blocks of "
          f"{F.CANNY_ROWS}x{F.CANNY_COLS} px, ms per launch on the device (eager call in "
          f"brackets): K3a {t3a['ms']:.4f} ({t3a['call_ms']:.4f}) vs plain "
          f"{t3a['plain_ms']:.4f}, bound {b3a['bound_us']:.2f} us ({b3a['bound_by']}), "
          f"{100 * b3a['bound_ms'] / t3a['ms']:.1f}% of it; K3b {t3b['ms']:.4f} "
          f"({t3b['call_ms']:.4f}) vs plain {t3b['plain_ms']:.4f}, bound "
          f"{b3b['bound_us']:.2f} us ({b3b['bound_by']}), "
          f"{100 * b3b['bound_ms'] / t3b['ms']:.1f}% of it", flush=True)
    return ({"max_abs_err": fwd_err, **t3a, **b3a},
            {"max_abs_err": max(bwd_err, auto_err), **t3b, **b3b})


def canny_kernel_phase(torch):
    """K3a and K3b at the gf slice's shape, and at ImageNet's 224 px."""
    k3a, k3b = _canny_case(torch, (100, 3, 64, 64))
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for shape in CANNY_LARGE_SHAPES:
        l3a, l3b = _canny_case(torch, shape)
        at = "at_" + "x".join(map(str, shape))
        k3a[at] = {k: l3a[k] for k in keys}
        k3b[at] = {k: l3b[k] for k in keys}
    src = "edge_enhancement_tpu_torch/csrc/ee_fused.cu"
    return [
        {"name": "canny_fused_fwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:149", **k3a},
        {"name": "canny_fused_bwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:166", **k3b},
    ]


def _canny_bf16_case(torch, shape):
    """K3a and K3b in bfloat16 at `shape` against their plain bfloat16
    versions, all four outputs and dx bit for bit; the times, the bounds and
    the float32 pair's times on the same image."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.utils.cuda_timing import device_ms

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    x = _patched_input(torch, dev, shape).to(bf16)
    high, sigma, alpha = 76.0 / 255.0, 1.0, 0.0
    b, c, h, w = x.shape
    u = torch.randn((b, 1, h, w), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(bf16)
    outs_k = F.canny_fused_fwd(x, high, sigma, alpha)
    torch.cuda.synchronize()
    outs_p = F.canny_fused_fwd_plain(x, high, sigma, alpha)
    fwd_err = max((a.float() - p.float()).abs().max().item() for a, p in zip(outs_k, outs_p))
    _, mag, gx, gy = outs_k
    dx_k = F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha)
    torch.cuda.synchronize()
    dx_p = F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma, alpha)
    exact = (F.bf16_ulps(dx_k, dx_p) == 0).float().mean().item()
    bwd_err = (dx_k.float() - dx_p.float()).abs().max().item()
    dx_max = dx_p.float().abs().max().item()
    edge_share = outs_k[0].float().mean().item()
    tag = "x".join(map(str, shape))
    print(f"[kernels] bf16 at ({tag}): K3a vs plain (out, mag, gx, gy): max |err| "
          f"{fwd_err:.3e} (limit 0), edge share {edge_share:.4f}; K3b vs plain: "
          f"{100 * exact:.4f}% of dx bit for bit (limit 100%), max |err| {bwd_err:.3e}, "
          f"max |dx| {dx_max:.3f}", flush=True)
    finite = all(bool(torch.isfinite(t).all()) for t in (*outs_k, dx_k))
    if (not finite or fwd_err > 0 or exact != 1.0 or not 0.0 < edge_share < 1.0
            or dx_max == 0.0 or {t.dtype for t in (*outs_k, dx_k)} != {bf16}):
        fail(f"a bfloat16 Canny kernel disagrees with its plain version at {tag}")
    t3a = _timings(torch, lambda: F.canny_fused_fwd(x, high, sigma, alpha),
                   lambda: F.canny_fused_fwd_plain(x, high, sigma, alpha))
    t3b = _timings(torch, lambda: F.canny_fused_bwd(u, mag, gx, gy, c, high, sigma, alpha),
                   lambda: F.canny_fused_bwd_plain(u, mag, gx, gy, c, high, sigma, alpha))
    # the float32 pair on the same image, beside: twice the bytes
    x32, u32 = x.float(), u.float()
    _, mag32, gx32, gy32 = F.canny_fused_fwd(x32, high, sigma, alpha)
    f32_ms = (device_ms(lambda: F.canny_fused_fwd(x32, high, sigma, alpha)),
              device_ms(lambda: F.canny_fused_bwd(u32, mag32, gx32, gy32, c, high, sigma,
                                                  alpha)))
    # operations as the float32 forms count them; bytes: bfloat16 in and out
    px = b * h * w
    b3a = bound(_nbytes(x, *outs_k), px * (18 * c + 29), PEAK_F32)
    b3b = bound(_nbytes(u, mag, gx, gy, dx_k), px * 54, PEAK_F32)
    print(f"[kernels] bf16 at ({tag}), ms per launch on the device (eager call in "
          f"brackets): K3a {t3a['ms']:.4f} ({t3a['call_ms']:.4f}) vs plain "
          f"{t3a['plain_ms']:.4f}, bound {b3a['bound_us']:.2f} us ({b3a['bound_by']}), "
          f"{100 * b3a['bound_ms'] / t3a['ms']:.1f}% of it; K3b {t3b['ms']:.4f} "
          f"({t3b['call_ms']:.4f}) vs plain {t3b['plain_ms']:.4f}, bound "
          f"{b3b['bound_us']:.2f} us ({b3b['bound_by']}), "
          f"{100 * b3b['bound_ms'] / t3b['ms']:.1f}% of it; the float32 K3a / K3b on "
          f"the same image {f32_ms[0]:.4f} / {f32_ms[1]:.4f}", flush=True)
    return ({"max_abs_err": fwd_err, "f32_ms_same_shape": f32_ms[0], **t3a, **b3a},
            {"max_abs_err": bwd_err, "share_exact": exact, "f32_ms_same_shape": f32_ms[1],
             **t3b, **b3b})


def canny_bf16_kernel_phase(torch):
    """K3a and K3b in bfloat16 at CANNY_BF16_SHAPES, each bit for bit its
    plain version; their SASS's conversions and packed bf16x2 instructions."""
    from edge_enhancement_tpu_torch.ops.cuda import build

    k3a, k3b = _canny_bf16_case(torch, CANNY_BF16_SHAPES[0])
    keys = ("max_abs_err", "f32_ms_same_shape", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by")
    for shape in CANNY_BF16_SHAPES[1:]:
        l3a, l3b = _canny_bf16_case(torch, shape)
        at = "at_" + "x".join(map(str, shape))
        k3a[at] = {k: l3a[k] for k in keys}
        k3b[at] = {k: l3b[k] for k in keys + ("share_exact",)}
    counts = build.sass_counts(build.sass(build.load("ee_fused").path))
    for row, kernel in ((k3a, "canny_fwd_bf16_kernel"), (k3b, "canny_bwd_bf16_kernel")):
        (c,) = [v for k, v in counts.items() if kernel in k]
        row["sass"] = {"instructions": c["all"], "F2FP": c["F2FP"], "bf16x2": c["bf16x2"]}
        print(f"[kernels] {kernel} SASS: {c['all']} instructions, {c['F2FP']} conversions "
              f"to bfloat16 (F2FP), {c['bf16x2']} packed bf16x2, {c['FMUL/FADD/FFMA']} "
              f"FP32 mul/add/fma, {c['LDS']} LDS", flush=True)
    src = "edge_enhancement_tpu_torch/csrc/ee_fused.cu"
    return [
        {"name": "canny_fused_fwd_bf16", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:149", **k3a},
        {"name": "canny_fused_bwd_bf16", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:166", **k3b},
    ]


def conv_kernel_phase(torch):
    """K4 forward and dgrad against the plain version, float32 and
    bfloat16, at CONV_SHAPE; times beside cuDNN's F.conv2d."""
    import numpy as np

    from edge_enhancement_tpu_torch.ops.cuda import gemm_conv as G
    from edge_enhancement_tpu_torch.tools.bench_gemm_conv import cudnn_conv
    from edge_enhancement_tpu_torch.utils.cuda_timing import device_ms

    dev = torch.device("cuda")
    bsz, h, w, ci, co = CONV_SHAPE
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.standard_normal((bsz, h, w, ci), np.float32)).to(dev)
    w32 = torch.from_numpy(rng.standard_normal((3, 3, ci, co), np.float32) * 0.1).to(dev)
    dy32 = torch.from_numpy(rng.standard_normal((bsz, h, w, co), np.float32)).to(dev)
    kernels = []
    for dtype, name in ((torch.float32, "conv_cgemm_f32"),
                        (torch.bfloat16, "conv_cgemm_bf16")):
        x, wk, dy = x32.to(dtype), w32.to(dtype), dy32.to(dtype)
        out_k = G.conv_cgemm_nhwc(x, wk)
        xa = x.clone().requires_grad_(True)
        (dx_k,) = torch.autograd.grad(G.conv3x3_cgemm(xa, wk), [xa], dy)
        torch.cuda.synchronize()
        out_p = G.conv_cgemm_nhwc_plain(x, wk)
        dx_p = G.conv_cgemm_nhwc_plain(dy, G._dgrad_weights(wk))
        errs, ok = [], True
        for got, want in ((out_k, out_p), (dx_k, dx_p)):
            d = (got.float() - want.float()).abs()
            errs.append(d.max().item())
            if dtype == torch.float32:
                ok &= errs[-1] <= CONV_F32_ATOL
            else:
                ok &= bool((d <= CONV_BF16_ATOL + CONV_BF16_RTOL * want.float().abs()).all())
            ok &= bool(torch.isfinite(got).all()) and got.dtype == dtype
        lib = cudnn_conv(x, wk)
        with torch.no_grad():
            lib_err = (out_k.float() - lib().float()).abs().max().item()
        # ms: the kernel alone, on weights packed once (as cuDNN's are);
        # op_ms: the op, packing included
        xk, wp = G.pack_operands(x, wk)
        t = _timings(torch, lambda: G.conv_cgemm_packed(xk, wp),
                     lambda: G.conv_cgemm_nhwc_plain(x, wk), lib)
        t["op_ms"] = device_ms(lambda: G.conv_cgemm_nhwc(x, wk))
        b = conv_bound(dtype, _nbytes(x, wp, out_k), 2 * bsz * h * w * co * 9 * ci)
        tol = (f"{CONV_F32_ATOL}" if dtype == torch.float32 else
               f"{CONV_BF16_ATOL} + 2^-7 |plain|")
        print(f"[kernels] K4 {name} at {CONV_SHAPE}: forward max |err| "
              f"{errs[0]:.3e}, dgrad {errs[1]:.3e} (limit {tol}); vs cuDNN "
              f"{lib_err:.3e}; ms per launch on the device: K4 {t['ms']:.4f} "
              f"(with packing {t['op_ms']:.4f}, eager call {t['call_ms']:.4f}), "
              f"plain {t['plain_ms']:.4f}, cuDNN {t['library_ms']:.4f} (K4 / cuDNN "
              f"{t['ms'] / t['library_ms']:.3f}); bound {b['bound_us']:.1f} us "
              f"({b['bound_by']}), {100 * b['bound_ms'] / t['ms']:.1f}% of it", flush=True)
        if not ok:
            fail(f"K4 ({name}) disagrees with its plain version")
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "edge_enhancement_tpu_torch/csrc/gemm_conv.cu",
             "replaces": "edge_enhancement_tpu/ops/pallas/gemm_conv.py:49",
             "max_abs_err": max(errs), **t, **b})
    return kernels


def conv_bound(dtype, nbytes: float, flop: float) -> dict:
    """K4's bound for a torch dtype or its name: bfloat16 one product on the
    bf16 tensor cores, float32 three TF32 products (3xTF32) on the TF32
    tensor cores."""
    if str(dtype).split(".")[-1] == "float32":
        return bound(nbytes, 3 * flop, PEAK_TF32)
    return bound(nbytes, flop, PEAK_BF16)


def _record_launches(kernels, path: str, launches: dict) -> None:
    """Each kernel's launches on `path`, under launches_by_path."""
    for kern in kernels:
        if launches.get(kern["name"]):
            kern.setdefault("launches_by_path", {})[path] = launches[kern["name"]]


def _reset_counts():
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused, gemm_conv
    ee_fused.reset_launches()
    gemm_conv.reset_launches()


def _read_counts() -> dict:
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused, gemm_conv
    return {**ee_fused.LAUNCHES, **gemm_conv.LAUNCHES}


def slice_phase(torch, kernels, device_line, gf: bool):
    """The flagship config through the port's driver, at full width; with
    `gf` the edge map is smoothed and the front-end runs on K3a/K3b."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    tag = "gf" if gf else "flagship"
    cfg = load_config(CONFIG, dict(SLICE_ARGS, gf=gf, output=_out_dir(tag)))
    _reset_counts()
    summary = run(cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
    n_steps = int(cfg["num_steps_1"])
    fwd, bwd = (("canny_fused_fwd", "canny_fused_bwd") if gf
                else ("ee_fused_fwd", "ee_fused_bwd"))
    want = {k: 0 for k in launches}
    want.update({fwd: steps * (n_steps + 1) + evals * (n_steps + 2),
                 bwd: (steps + evals) * n_steps})
    print(f"[slice {tag}] {steps} train steps, {evals} eval batches; launches "
          f"{launches}, expected {want}; loss {summary['loss']:.4f}", flush=True)
    if steps != 3 or evals != 3:
        fail(f"expected 3 train steps and 3 eval batches, got {steps}, {evals}")
    if launches != want:
        fail("kernel launch counts differ from the slice's forwards/backwards")
    if not math.isfinite(summary["loss"]):
        fail(f"loss {summary['loss']} is not finite")
    _record_launches(kernels, tag, launches)
    secs = summary["step_seconds"]
    steady = sorted(secs[1:]) or secs
    ms = 1000.0 * steady[len(steady) // 2]
    bs = int(cfg["batch_size"])
    print(f"[slice {tag}] train step ms: {[round(1000 * s, 1) for s in secs]}; "
          f"median after the first {ms:.1f} ms/step = {bs / ms * 1000:.1f} img/s "
          f"(bs{bs}, f32, PGD-10) on {device_line}", flush=True)
    return cfg, summary["checkpoint"], ms


def _kernel_ms(kernels, name: str, at: str) -> float:
    """A kernel's device ms per launch: its row at `at` where it has one,
    else its first row."""
    kern = next(k for k in kernels if k["name"] == name)
    return kern.get(at, kern)["ms"]


def _out_dir(tag: str) -> str:
    """A phase's output root, emptied first, so its log is this run's."""
    out = os.path.join(ROOT, "output", "chip_smoke", tag)
    shutil.rmtree(out, ignore_errors=True)
    return out


def imagenet_slice_phase(torch, kernels, device_line, tag: str, path: str,
                         fwd: str, bwd: str, per_step: tuple, args=IMAGENET_ARGS):
    """An ImageNet recipe through the port's driver at full width
    (resnet50_EE, 1000 classes): 2 train steps, 1 validation batch, exact
    launch counts of its front-end pair, a finite loss; ms/step, peak
    device memory and the front-end kernels' share of the step (launches a
    step times their device ms, over the step's ms). Returns the config and
    the run's summary."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(path, dict(args, output=_out_dir(tag)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    summary = run(cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
    n_steps = int(cfg["num_steps_1"])
    want = {k: 0 for k in launches}
    want.update({fwd: steps * per_step[0] + evals * (n_steps + 2),
                 bwd: steps * per_step[1] + evals * n_steps})
    print(f"[slice {tag}] {cfg['arch']} {cfg['cize']} px bs{cfg['batch_size']} "
          f"{'bf16' if cfg.get('half') else 'f32'}: {steps} train steps, {evals} eval "
          f"batches; launches {launches}, expected {want}; loss "
          f"{summary['loss']:.4f}", flush=True)
    if steps != 2 or evals != 1:
        fail(f"expected 2 train steps and 1 eval batch, got {steps}, {evals}")
    if launches != want:
        fail(f"the {tag} slice's kernel launch counts differ from its passes")
    if not math.isfinite(summary["loss"]):
        fail(f"loss {summary['loss']} is not finite")
    _record_launches(kernels, tag, launches)
    secs = summary["step_seconds"]
    ms = 1000.0 * sorted(secs[1:])[len(secs[1:]) // 2]
    shape = f"at_{cfg['batch_size']}x3x{cfg['cize']}x{cfg['cize']}"
    front = (per_step[0] * _kernel_ms(kernels, fwd, shape)
             + per_step[1] * _kernel_ms(kernels, bwd, shape))
    print(f"[slice {tag}] train step ms: {[round(1000 * s, 1) for s in secs]}; "
          f"after the first {ms:.1f} ms/step = {int(cfg['batch_size']) / ms * 1000:.1f} "
          f"img/s; peak device memory {peak_gb:.2f} GB; front-end kernels "
          f"{front:.2f} ms a step ({per_step[0]} x {fwd}, {per_step[1]} x {bwd}), "
          f"{100 * front / ms:.2f}% of the step; on {device_line}", flush=True)
    return cfg, summary


def conv_path_phase(torch, kernels):
    """The GEMM-conv op forward and backward in both types, then the bench
    entry point over its three shapes: K4's counts must be exact."""
    from edge_enhancement_tpu_torch.ops.cuda.gemm_conv import conv3x3_cgemm
    from edge_enhancement_tpu_torch.tools import bench_gemm_conv

    dev = torch.device("cuda")
    bsz, h, w, ci, co = CONV_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    _reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((bsz, h, w, ci), generator=gen, device=dev).to(dtype)
        wk = (0.1 * torch.randn((3, 3, ci, co), generator=gen, device=dev)).to(dtype)
        x.requires_grad_(True)
        wk.requires_grad_(True)
        conv3x3_cgemm(x, wk).float().square().mean().backward()
        if not (torch.isfinite(x.grad).all() and torch.isfinite(wk.grad).all()):
            fail(f"the GEMM-conv op's gradients are not finite ({dtype})")
    results = {dtype: bench_gemm_conv.main(["--dtype", dtype, "--reps", str(BENCH_REPS)])
               for dtype in ("bfloat16", "float32")}
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {k: 0 for k in launches}
    want.update({"conv_cgemm_f32": 2 + sum(r["calls"] for r in results["float32"]),
                 "conv_cgemm_bf16": 2 + sum(r["calls"] for r in results["bfloat16"])})
    print(f"[slice conv] launches {launches}, expected {want}", flush=True)
    if any(len(r) != 3 for r in results.values()) or launches != want:
        fail("the GEMM-conv path's launch counts are not as expected")
    benches = {}
    for dtype, limit, short in (("bfloat16", BENCH_BF16_DIFF, "bf16"),
                                ("float32", BENCH_F32_DIFF, "f32")):
        bench = benches[dtype] = []
        for r in results[dtype]:
            if not (math.isfinite(r["max_diff"]) and r["max_diff"] < limit):
                fail(f"K4 and cuDNN disagree at {r['label']} {dtype}: "
                     f"{r['max_diff']} (limit {limit})")
            b = conv_bound(dtype, r["nbytes"], r["flop"])
            print(f"[slice conv] {r['label']} {short}: device ms K4 {r['ms']:.4f} "
                  f"(with packing {r['op_ms']:.4f}), cuDNN {r['cudnn_ms']:.4f} "
                  f"(K4 / cuDNN {r['ms'] / r['cudnn_ms']:.3f}); bound "
                  f"{b['bound_us']:.1f} us ({b['bound_by']}): K4 at "
                  f"{100 * b['bound_ms'] / r['ms']:.1f}%, cuDNN at "
                  f"{100 * b['bound_ms'] / r['cudnn_ms']:.1f}%; max diff "
                  f"{r['max_diff']:.3e} (limit {limit})", flush=True)
            bench.append({"shape": r["label"], "ms": r["ms"], "op_ms": r["op_ms"],
                          "library_ms": r["cudnn_ms"], "bound_ms": b["bound_ms"],
                          "bound_by": b["bound_by"], "max_diff": r["max_diff"]})
    _record_launches(kernels, "conv", launches)
    for kern in kernels:
        if kern["name"].startswith("conv_cgemm"):
            kern["bench"] = benches["float32" if kern["name"].endswith("f32")
                                    else "bfloat16"]


def _check_launches(tag: str, launches: dict, want: dict) -> None:
    want = {**{k: 0 for k in launches}, **want}
    print(f"[slice {tag}] launches {launches}, expected {want}", flush=True)
    if launches != want:
        fail(f"the {tag} path's kernel launch counts differ from its passes")


def resume_phase(torch, kernels, device_line, checkpoint: str) -> str:
    """f. Fast-AT phase 2 (224 px, batch 128) by --resume of the fast_at
    slice's checkpoint, for one epoch: the weights and momentum the driver
    restores must equal the file's bit for bit before the first step (a
    wrapper around the driver's restore_into_state reads them), and the
    first logged epoch must be the checkpoint's. Returns its checkpoint
    directory."""
    from edge_enhancement_tpu_torch.train import driver

    saved = torch.load(checkpoint, map_location="cpu", weights_only=True)
    restored = []
    real = driver.restore_into_state

    def checked(state, payload):
        out = real(state, payload)
        sd = state.model.state_dict()
        bufs = payload["optimizer"]["state"]
        restored.append((
            sorted(sd) == sorted(saved["state_dict"]) and all(
                torch.equal(sd[k].cpu(), v) for k, v in saved["state_dict"].items()),
            len(bufs) == len(state.momentum_buf) and all(
                torch.equal(b.cpu(), bufs[i]["momentum_buffer"])
                for i, b in enumerate(state.momentum_buf))))
        return out

    driver.restore_into_state = checked
    try:
        cfg, summary = imagenet_slice_phase(
            torch, kernels, device_line, "fast_at_phase2", PHASE2,
            "ee_fused_fwd_bf16", "ee_fused_bwd_bf16", (2, 1),
            dict(RESUME_ARGS, resume=os.path.dirname(checkpoint),
                 epochs=saved["epoch"] + 1))
    finally:
        driver.restore_into_state = real
    with open(os.path.join(summary["out_dir"], "log", "log.txt")) as f:
        lines = f.read().splitlines()
    epochs = [int(ln[len("Epoch: ["):].split("]")[0]) for ln in lines
              if ln.startswith("Epoch: [")]
    notes = [ln for ln in lines if ln.startswith(("=> resumed", "=> restored", "WARNING"))]
    print(f"[slice fast_at_phase2] {cfg['cize']} px from the {saved['epoch']}-epoch "
          f"checkpoint; restored state_dict and momentum equal the file's: "
          f"{restored}; logged epochs {sorted(set(epochs))}; {notes}", flush=True)
    if restored != [(True, True)]:
        fail("the resumed state differs from the checkpoint's")
    if not epochs or epochs[0] != saved["epoch"] or summary["start_epoch"] != saved["epoch"]:
        fail(f"the resumed run did not start at the checkpoint's epoch {saved['epoch']}")
    return os.path.dirname(summary["checkpoint"])


def evaluate_phase(torch, kernels, device_line, ckpt_dir: str) -> None:
    """g. --evaluate of the fast-AT evaluate config (288 px, batch 128,
    bf16, PGD-50) resumed from f's checkpoint: one validation batch, K1
    bf16 K + 2 and K2 bf16 K launches, finite accuracies, no checkpoint."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(EVALUATE, dict(RESUME_ARGS, resume=ckpt_dir,
                                     output=_out_dir("evaluate")))
    if not cfg.get("evaluate"):
        fail(f"{EVALUATE} no longer sets evaluate")
    _reset_counts()
    summary = run(cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    (tier,) = summary["tiers"]
    k, n = tier["num_steps"], tier["batches"]
    at = f"at_{cfg['batch_size']}x3x{cfg['cize']}x{cfg['cize']}"
    front = n * ((k + 2) * _kernel_ms(kernels, "ee_fused_fwd_bf16", at)
                 + k * _kernel_ms(kernels, "ee_fused_bwd_bf16", at))
    print(f"[slice evaluate] {cfg['arch']} {cfg['cize']} px bs{cfg['batch_size']} bf16, "
          f"PGD-{k}, {n} batch: clean Prec@1 {tier['clean_top1']:.3f}, adv Prec@1 "
          f"{tier['adv_top1']:.3f}; {tier['seconds']:.3f} s, "
          f"{1e3 * tier['seconds'] / (n * k):.2f} ms per attack iteration (the clean "
          f"and adversarial forwards included); front-end kernels {front:.1f} ms, "
          f"{100 * front / (1e3 * tier['seconds']):.2f}% of it; on {device_line}",
          flush=True)
    _check_launches("evaluate", launches, {"ee_fused_fwd_bf16": n * (k + 2),
                                           "ee_fused_bwd_bf16": n * k})
    if (n != 1 or k != 50 or "checkpoint" in summary
            or not all(math.isfinite(tier[m]) for m in ("clean_top1", "adv_top1"))):
        fail(f"the evaluate run is not one finite PGD-50 batch: {tier}")
    _record_launches(kernels, "evaluate", launches)


def eval_entry_phase(torch, kernels, device_line, ckpt_dir: str) -> None:
    """h. The port's eval.py with --suite pgd,fgsm,cw on the flagship's
    checkpoint, one batch of 100: PGD-10/50/100, FGSM and CW-20, each K1
    float32 K + 2 times (CW: K + 3, its prediction forward) and K2 K
    times; finite accuracies."""
    from edge_enhancement_tpu_torch import eval as port_eval
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, dict(EVAL_ARGS, resume=ckpt_dir))
    _reset_counts()
    results = port_eval.run(cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    labels = [r["label"] for r in results]
    k1, k2 = (_kernel_ms(kernels, name, "") for name in ("ee_fused_fwd", "ee_fused_bwd"))
    want = {"ee_fused_fwd": 0, "ee_fused_bwd": 0}
    for r in results:
        # K1: the clean and adversarial forwards and one an iteration (CW:
        # and its prediction forward); K2: one an iteration
        fwd = r["batches"] * (r["iterations"] + (3 if r["label"].startswith("CW") else 2))
        bwd = r["batches"] * r["iterations"]
        want["ee_fused_fwd"] += fwd
        want["ee_fused_bwd"] += bwd
        front = fwd * k1 + bwd * k2
        print(f"[slice eval.py] {r['label']}: clean Prec@1 {r['clean_top1']:.3f}, adv "
              f"Prec@1 {r['adv_top1']:.3f}; {r['batches']} batch of "
              f"{cfg['batch_size']}, {r['seconds']:.3f} s, "
              f"{1e3 * r['seconds'] / (r['batches'] * r['iterations']):.2f} ms per "
              f"attack iteration; front-end kernels {front:.2f} ms, "
              f"{100 * front / (1e3 * r['seconds']):.2f}% of it; on {device_line}",
              flush=True)
    _check_launches("eval.py", launches, want)
    if labels != ["PGD-10", "PGD-50", "PGD-100", "FGSM", "CW-Linf-20"]:
        fail(f"eval.py ran {labels}")
    if not all(r["batches"] == 1 and math.isfinite(r["adv_top1"])
               and math.isfinite(r["clean_top1"]) for r in results):
        fail(f"eval.py's batteries are not one finite batch each: {results}")
    _record_launches(kernels, "eval_py", launches)


def aa_launches(apgd: int, fab: int, queries: int, n_tc: int) -> tuple:
    """K1's and K2's launches in one batch of eval.py's AA battery: the
    suite's first prediction, APGD-CE (2N + 1 forwards) and its merge
    prediction, the target order, APGD-T 2N + 2 and FAB-T 3N + 1 (two
    decisions and the gradient's forward a step, the merge) a target, Square
    Q + 1 (the init is query 1), then the clean and the robust scoring; an
    input gradient each APGD and FAB step."""
    fwd = (1 + (2 * apgd + 2) + 1 + n_tc * (2 * apgd + 2) + n_tc * (3 * fab + 1)
           + queries + 1 + 2)
    return fwd, apgd + n_tc * (apgd + fab)


def aa_phase(torch, kernels, device_line, ckpt_dir: str) -> None:
    """j1. eval.py --suite aa on the flagship's checkpoint, one batch of 100
    at the standard defaults: exact K1/K2 counts (5734 / 1900), finite
    accuracies with robust <= clean, the batch's wall seconds, K1/K2's share
    of them and the peak device memory."""
    from edge_enhancement_tpu_torch import eval as port_eval
    from edge_enhancement_tpu_torch.utils.config import load_config

    from edge_enhancement_tpu_torch.attacks import autoattack as aa

    cfg = load_config(CONFIG, dict(AA_ARGS, resume=ckpt_dir))
    # each attack's seconds: a device sync at its start and end (a few
    # dozen a batch, in a suite that syncs nowhere else)
    spent = {}
    real = {n: getattr(aa, n) for n in ("apgd", "fab_targeted", "square_attack")}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            tag = ("apgd-t" if kw.get("y_target") is not None else "apgd-ce") \
                if name == "apgd" else name
            spent[tag] = spent.get(tag, 0.0) + time.time() - t0
            return out
        return run

    for n, f in real.items():
        setattr(aa, n, timed(n, f))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    try:
        (res,) = port_eval.run(cfg)
    finally:
        for n, f in real.items():
            setattr(aa, n, f)
    torch.cuda.synchronize()
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = aa_launches(**AA_STANDARD)
    k1, k2 = (_kernel_ms(kernels, name, "") for name in ("ee_fused_fwd", "ee_fused_bwd"))
    front = res["batches"] * (fwd * k1 + bwd * k2)
    print(f"[slice aa] {res['label']}: clean Prec@1 {res['clean_top1']:.3f}, robust "
          f"Prec@1 {res['adv_top1']:.3f}; {res['batches']} batch of {cfg['batch_size']}, "
          f"{res['seconds']:.3f} s wall, {1e3 * res['seconds'] / res['iterations']:.2f} ms "
          f"per attack iteration ({res['iterations']} a batch); K1/K2 {fwd} / {bwd} "
          f"launches a batch, {front:.1f} ms, {100 * front / (1e3 * res['seconds']):.2f}% "
          f"of it; peak device memory {peak_gb:.2f} GB; on {device_line}", flush=True)
    print("[slice aa] seconds by attack: " + ", ".join(
        f"{k} {v:.3f} ({100 * v / res['seconds']:.1f}%)" for k, v in spent.items()),
        flush=True)
    _check_launches("aa", launches, {"ee_fused_fwd": res["batches"] * fwd,
                                     "ee_fused_bwd": res["batches"] * bwd})
    a = AA_STANDARD
    if (res["batches"] != 1
            or res["iterations"] != a["apgd"] * (1 + a["n_tc"]) + a["fab"] * a["n_tc"]
            + a["queries"]
            or not all(math.isfinite(res[m]) for m in ("clean_top1", "adv_top1"))
            or res["adv_top1"] > res["clean_top1"]):
        fail(f"the AA battery is not one finite batch with robust <= clean: {res}")
    _record_launches(kernels, "aa", launches)


def aa_card_vs_cpu_phase(torch, checkpoint: str) -> None:
    """j2. APGD-CE, APGD-T (one target), FAB-T and Square on 8 noise images
    through the flagship's checkpoint, on the card and on the CPU, with the
    same draws (tools/attack_split.py: the attacks' draw functions and the
    model's square source replay one seeded CPU sequence each, moved to the
    device); each forward's logits and the front-end's input gradient of
    the card's runs held in lockstep against the CPU path, and the results
    compared sample by sample, within the limits above."""
    import numpy as np

    from edge_enhancement_tpu_torch.ops.square import add_square_draws
    from edge_enhancement_tpu_torch.tools.attack_split import (agrees, clean_top2,
                                                               model_from_state,
                                                               replayed_attacks,
                                                               sample_diffs)
    from edge_enhancement_tpu_torch.train.modelops import ModelOps
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    eps = float(cfg["epsilon"])
    state = torch.load(checkpoint, map_location="cpu")["state_dict"]
    size = int(cfg["cize"])
    x = torch.from_numpy(np.random.default_rng(2).random(
        (AA_CMP_N, size, size, 3)).astype(np.float32))
    fixed = add_square_draws(x.shape, torch.Generator().manual_seed(6))
    y, target = clean_top2(state, cfg, x, fixed)
    kw = dict(steps=AA_CMP_STEPS, queries=AA_CMP_QUERIES)
    card = replayed_attacks(state, cfg, x, y, target, fixed, "cuda",
                            reference=ModelOps(model_from_state(state, cfg)), **kw)
    cpu = replayed_attacks(state, cfg, x, y, target, fixed, "cpu", **kw)
    for name in card:
        (xa, wa, step), (xb, wb, _) = card[name], cpu[name]
        share, worst = sample_diffs(xa, xb)
        agree = agrees(name, share, worst)
        split = [i for i in range(AA_CMP_N) if not agree[i]]
        flips = [i for i in range(AA_CMP_N) if wa[i] != wb[i]]
        moved = (xa - x.double()).abs().max().item()
        print(f"[aa card vs cpu] {name} ({AA_CMP_N} images, {AA_CMP_STEPS} steps / "
              f"{AA_CMP_QUERIES} queries): in lockstep, {step.forwards} forwards' logits "
              f"within {step.logits_err:.3e} (limit {REF_TOL}), {step.gradients} input "
              f"gradients: the front-end's within {step.frontend_err:.3e} of their norm "
              f"(limit {AA_FRONTEND_TOL}), the model's {step.grad_norm_err:.3e}; "
              f"results: "
              f"{100 * share.mean().item():.4f}% of x_adv more than 1e-6 apart, per "
              f"sample {[round(v, 4) for v in share.tolist()]}, max |diff| "
              f"{[float(f'{v:.3e}') for v in worst.tolist()]}; trajectories parted on "
              f"{split}; misclassification differs on {flips} (limit {AA_FLIP_SAMPLES}); "
              f"misclassified card {int(wa.sum())} cpu {int(wb.sum())}; max |x_adv - x| "
              f"{moved:.4f}", flush=True)
        if (step.logits_err > REF_TOL or step.frontend_err > AA_FRONTEND_TOL
                or step.forwards < AA_CMP_STEPS
                or (name != "square" and step.gradients < AA_CMP_STEPS)
                or len(flips) > AA_FLIP_SAMPLES or moved > eps + 1e-6
                or not bool(torch.isfinite(xa).all())):
            fail(f"{name} on the card disagrees with the CPU path")


def restart_pgd_phase(torch, kernels, device_line, checkpoint: str) -> None:
    """j3. The restart PGD of attacks/restart_pgd.py on the flagship's
    checkpoint and j1's batch of 100, l_inf and l_2, 2 restarts x 10
    iterations: one forward with its input gradient an iteration (its
    early-stop logits and gradient share a key in JAX) and one a restart,
    so K1 restarts x (iters + 1) and K2 restarts x iters a norm."""
    from edge_enhancement_tpu_torch.attacks.restart_pgd import (RestartPGDConfig,
                                                                attack_pgd)
    from edge_enhancement_tpu_torch.train.driver import build, load_datasets
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, AA_ARGS)
    _, val_ds, spec = load_datasets(cfg, train=False)
    ops, state, gen = build(cfg, spec.num_classes, torch.device("cuda"))
    state.model.load_state_dict(torch.load(checkpoint, map_location="cuda")["state_dict"])
    x, y = next(val_ds.batches(int(cfg["batch_size"]), shuffle=False, seed=0))
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda().long()
    total = {}
    for over in RESTART_PGD:
        rcfg = RestartPGDConfig(attack_iters=RESTART_PGD_ITERS,
                                restarts=RESTART_PGD_RESTARTS, **over)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.time()
        delta = attack_pgd(ops.logits_eval, x, y, rcfg, gen, draw=ops.square_draws)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = _read_counts()
        with torch.no_grad():
            draws = ops.square_draws(x)
            clean = (ops.logits_eval(x, draws).argmax(-1) == y).float().mean().item()
            adv = (ops.logits_eval(torch.clamp(x + delta, 0, 1), draws).argmax(-1)
                   == y).float().mean().item()
        flat = delta.reshape(len(y), -1)
        size = (flat.abs().amax(1) if rcfg.norm == "l_inf"
                else torch.linalg.vector_norm(flat, dim=1)).max().item()
        r, k = rcfg.restarts, rcfg.attack_iters
        print(f"[slice restart_pgd] {rcfg.norm} eps {rcfg.epsilon:.4f}, {r} restarts x "
              f"{k} iterations on {len(y)} images: {secs:.3f} s, "
              f"{1e3 * secs / (r * k):.2f} ms per iteration; clean {100 * clean:.1f}%, "
              f"adversarial {100 * adv:.1f}%; largest delta {size:.4f}; on "
              f"{device_line}", flush=True)
        _check_launches(f"restart_pgd {rcfg.norm}", launches,
                        {"ee_fused_fwd": r * (k + 1), "ee_fused_bwd": r * k})
        if not math.isfinite(size) or size > rcfg.epsilon * (1 + 1e-5) or adv > clean:
            fail(f"restart PGD {rcfg.norm} left its ball or raised the accuracy")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    _record_launches(kernels, "restart_pgd", total)


def edge_flip_phase(torch, cfg, n: int = 100) -> float:
    """k1's check: the config's Canny edge map (the front-end's call) of n
    images at the config's size on the card and on the CPU; returns and
    prints the share of pixels that differ."""
    import numpy as np

    from edge_enhancement_tpu_torch.models.ee_frontend import CANNY_VARIANTS
    from edge_enhancement_tpu_torch.models.registry import _ee_from_args

    ee = _ee_from_args(cfg, square=False)
    size = int(cfg["cize"])
    x = torch.from_numpy(np.random.default_rng(3).random((n, 3, size, size)).astype(np.float32))
    edges = {dev: CANNY_VARIANTS[ee.type_canny](
        x.to(dev), ee.low_scaled, ee.high_scaled, hysteresis=True, sigma=ee.sigma,
        alpha=ee.alpha).cpu() for dev in ("cpu", "cuda")}
    share = (edges["cuda"] != edges["cpu"]).float().mean().item()
    print(f"[slice k1] {ee.type_canny} edge map of {n}x3x{size}x{size}, card vs CPU: "
          f"{100 * share:.5f}% of pixels differ "
          f"({int((edges['cuda'] != edges['cpu']).sum())} of {edges['cpu'].numel()}; limit "
          f"{100 * EDGE_FLIP_SHARE}%), edge share {edges['cpu'].mean().item():.4f}",
          flush=True)
    if share > EDGE_FLIP_SHARE or not 0 < edges["cpu"].mean().item() < 1:
        fail(f"the {ee.type_canny} edge map differs between card and CPU")
    return share


def variants_phase(torch, kernels, device_line) -> None:
    """k. The front-end's other variants through the driver at full width
    (VARIANTS): launch counts, a finite loss, ms/step and peak memory; the
    reference of each trained model; k1's edge-map check."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    for tag, path, over, args, pair in VARIANTS:
        cfg = load_config(path, dict(args, **over, output=_out_dir(tag)))
        if tag.startswith("k1"):
            edge_flip_phase(torch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        summary = run(cfg)
        torch.cuda.synchronize()
        launches = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        k = int(cfg["num_steps_1"])
        want = {}
        if pair is not None:
            fwd, bwd, (f_step, b_step) = pair
            want = {fwd: steps * f_step + evals * (k + 2), bwd: steps * b_step + evals * k}
        secs = summary["step_seconds"]
        ms = 1000.0 * sorted(secs[1:] or secs)[len(secs[1:] or secs) // 2]
        print(f"[slice {tag}] {cfg['arch']} type_canny {cfg.get('type_canny', 'CannyFilter')} "
              f"{cfg['method_name']} {cfg['cize']} px bs{cfg['batch_size']} "
              f"{'bf16' if cfg.get('half') else 'f32'} gf={bool(cfg.get('gf'))} "
              f"n_queries={cfg.get('n_queries', 1)}, PGD-{k}: {steps} train steps, {evals} "
              f"eval batch; loss {summary['loss']:.4f}; train step ms "
              f"{[round(1000 * s_, 1) for s_ in secs]}, {ms:.1f} ms/step after the first "
              f"= {int(cfg['batch_size']) / ms * 1000:.1f} img/s; peak device memory "
              f"{peak_gb:.2f} GB; on {device_line}", flush=True)
        _check_launches(tag, launches, want)
        if steps != 2 or evals != 1:
            fail(f"{tag}: expected 2 train steps and 1 eval batch, got {steps}, {evals}")
        if not math.isfinite(summary["loss"]):
            fail(f"{tag}: loss {summary['loss']} is not finite")
        _record_launches(kernels, tag, launches)
        reference_phase(torch, cfg, summary["checkpoint"])
        shutil.rmtree(cfg["output"])


def step_launches(kind: str, k: int) -> tuple:
    """K1's and K2's launches in one train step of an objective kind with a
    K-step attack: a forward each attack step, the clean forward of ALP and
    TRADES, ALP's eval-mode `out`, TRADES' metric and train-mode
    adversarial forwards; an input gradient each attack step (the
    parameter backward reaches no K2: the front-end has no parameters)."""
    fwd = {"st": 1, "alp": k + 2, "tar_alp": k + 2, "trades": k + 3}.get(kind, k + 1)
    return fwd, 0 if kind == "st" else k


def objectives_phase(torch, kernels, device_line) -> None:
    """i. The objective kinds through the port's driver at full width: the
    Tiny-ImageNet configs, then the new kinds on the flagship config."""
    from edge_enhancement_tpu_torch.objectives.methods import canonical_method
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    runs = [(name, os.path.join(CONFIGS, "tiny_imagenet", f"{name}.yml"), {})
            for name in OBJECTIVE_CONFIGS]
    runs += [(f"flagship_{method}", CONFIG, dict(extra, method_name=method))
             for method, extra in FLAGSHIP_KINDS]
    total = {}
    for tag, path, over in runs:
        cfg = load_config(path, dict(OBJECTIVE_ARGS, **over,
                                     output=_out_dir(f"objectives/{tag}")))
        kind, k = canonical_method(cfg["method_name"]), int(cfg["num_steps_1"])
        if (int(cfg["batch_size"]) != 100 or k != 10 or cfg.get("half")
                or not cfg["arch"].startswith("resnet18")):
            fail(f"{tag} is not the full-width recipe: {cfg['arch']} "
                 f"bs{cfg['batch_size']} K {k}")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        summary = run(cfg)
        torch.cuda.synchronize()
        launches = _read_counts()
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        fwd, bwd = step_launches(kind, k)
        want = ({"ee_fused_fwd": steps * fwd + evals * (k + 2),
                 "ee_fused_bwd": steps * bwd + evals * k}
                if "_EE" in cfg["arch"] else {})
        secs = summary["step_seconds"]
        print(f"[slice objectives] {tag}: {cfg['method_name']} (kind {kind}) on "
              f"{cfg['arch']}, bs{cfg['batch_size']}, PGD-{k}: {steps} train steps, "
              f"{evals} eval batch; loss {summary['loss']:.4f}; train step ms "
              f"{[round(1000 * s_, 1) for s_ in secs]}, {1000 * secs[-1]:.1f} ms/step "
              f"after the first; peak device memory {peak_gb:.2f} GB; TF32 after the "
              f"run (cudnn, matmul) {tf32}; on {device_line}", flush=True)
        _check_launches(f"objectives {tag}", launches, want)
        if steps != 2 or evals != 1:
            fail(f"{tag}: expected 2 train steps and 1 eval batch, got {steps}, {evals}")
        if not math.isfinite(summary["loss"]):
            fail(f"{tag}: loss {summary['loss']} is not finite")
        if tf32 != (False, False):
            fail(f"{tag}: a float32 recipe left TF32 on: {tf32}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        shutil.rmtree(cfg["output"])          # two checkpoints a run
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _record_launches(kernels, "objectives", total)


def reference_phase(torch, cfg, checkpoint):
    """The trained model's eval-mode logits on a small batch: the card's
    path against the CPU's, on the same weights and square draws."""
    import numpy as np

    from edge_enhancement_tpu_torch.data.datasets import SPECS
    from edge_enhancement_tpu_torch.models.ee_frontend import CANNY_VARIANTS
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.ops.square import add_square_draws

    state = torch.load(checkpoint, map_location="cpu")["state_dict"]
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        fail("checkpoint holds non-finite weights")
    spec = SPECS[cfg["dataset"]]
    size = int(cfg["cize"])
    n = 8 if size <= 64 else 4
    tol = REF_TOL_BF16 if cfg.get("half") else REF_TOL
    x = torch.from_numpy(np.random.default_rng(1).random(
        (n, size, size, spec.channels)).astype(np.float32))
    draws = add_square_draws(x.shape, torch.Generator().manual_seed(1),
                             n_queries=int(cfg.get("n_queries", 1)))
    # The denoising blocks' eval-mode output grows as the cube of their
    # input while the running statistics still hold their init after 2
    # steps: eval-mode logits reach 1e14 or overflow (the JAX model's
    # too), so a resnet*_fd is held in train mode (batch statistics).
    train = cfg["arch"].endswith("_fd")
    logits = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg["arch"], cfg, spec.num_classes,
                            square_source=lambda shape, d=dev, **_: tuple(
                                t.to(d) for t in draws))
        model.load_state_dict(state)
        model.to(dev).train(train)
        with torch.no_grad():
            logits[dev] = model(x.to(dev)).cpu()
    ee = getattr(model, "ee", None)
    if ee is not None and ee.type_canny in CANNY_VARIANTS:
        # in the front-end's dtype (bfloat16 under the bf16 policy)
        xc = x.permute(0, 3, 1, 2).to(getattr(model, "dtype", None) or torch.float32)
        edges = [CANNY_VARIANTS[ee.type_canny](xc.to(d), ee.low_scaled, ee.high_scaled,
                                               hysteresis=True, sigma=ee.sigma,
                                               alpha=ee.alpha).cpu() for d in ("cpu", "cuda")]
        flips = int((edges[0] != edges[1]).sum())
        print(f"[reference] {ee.type_canny} edge maps of the reference batch, card vs "
              f"CPU: {flips} pixels differ", flush=True)
        tol = max(tol, REF_TOL_FLIP) if flips else tol
    num_classes = logits["cpu"].shape[1]
    scale = max(1.0, logits["cpu"].abs().max().item())
    err = (logits["cuda"] - logits["cpu"]).abs().max().item() / scale
    print(f"[reference] {cfg['arch']} {cfg['method_name']} "
          f"{'train' if train else 'eval'} mode gf={bool(cfg.get('gf'))} "
          f"half={bool(cfg.get('half'))} type_canny "
          f"{ee.type_canny if ee is not None else None} "
          f"n_queries {cfg.get('n_queries', 1)}: logits {tuple(logits['cuda'].shape)} on "
          f"{n}x{size}x{size}x{spec.channels}, card vs CPU: max |err| / max(1, max |logit|) "
          f"{err:.3e} (limit {tol}), max |logit| {scale:.3f}", flush=True)
    if (logits["cuda"].shape != (n, num_classes)
            or not bool(torch.isfinite(logits["cuda"]).all()) or err > tol):
        fail("the card's logits disagree with the CPU reference")


def zoo_phase(torch, kernels, device_line) -> None:
    """l. The rest of the model zoo through the port's driver at full
    width, 2 train steps and 1 validation batch each (ZOO_RUNS): l1 the 7
    MNIST configs, l2 the denoising ResNet, l3 the 5 AWP configs. Each: a
    finite loss, exact launch counts of its front-end pair (none where the
    front-end is plain PyTorch or absent), ms/step and peak memory, and the
    reference."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    total = {}
    for tag, path, args, per_step in ZOO_RUNS:
        cfg = load_config(path, dict(args, output=_out_dir(f"zoo/{tag}")))
        k = int(cfg["num_steps_1"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.time()
        summary = run(cfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        want = {}
        if per_step is not None:
            f_step, b_step = per_step(k)
            want = {"ee_fused_fwd": steps * f_step + evals * (k + 2),
                    "ee_fused_bwd": steps * b_step + evals * k}
        secs = summary["step_seconds"]
        ms = 1000.0 * sorted(secs[1:] or secs)[len(secs[1:] or secs) // 2]
        print(f"[slice {tag}] {cfg['arch']} {cfg['method_name']} {cfg['dataset']} "
              f"{cfg['cize']} px bs{cfg['batch_size']} f32, PGD-{k}"
              f"{', AWP gamma ' + str(cfg['awp_gamma']) if cfg.get('awp_gamma') else ''}: "
              f"{steps} train steps, {evals} eval batch; loss {summary['loss']:.4f}; train "
              f"step ms {[round(1000 * s_, 1) for s_ in secs]}, {ms:.1f} ms/step after the "
              f"first = {int(cfg['batch_size']) / ms * 1000:.1f} img/s; run {wall:.1f} s; "
              f"peak device memory {peak_gb:.2f} GB; on {device_line}", flush=True)
        _check_launches(tag, launches, want)
        if steps != 2 or evals != 1:
            fail(f"{tag}: expected 2 train steps and 1 eval batch, got {steps}, {evals}")
        if not math.isfinite(summary["loss"]):
            fail(f"{tag}: loss {summary['loss']} is not finite")
        if cfg.get("half"):
            fail(f"{tag}: phase l's configs are float32 recipes")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        reference_phase(torch, cfg, summary["checkpoint"])
        shutil.rmtree(cfg["output"])
    _record_launches(kernels, "zoo", total)


def _spawn_ranks(task: str, out: str, timeout: float = M_TIMEOUT,
                 rank_env=None) -> list:
    """M_WORLD rank processes of this script (`--rank <task>`) joined by a
    file store in `out`, each under `timeout` seconds, with `rank_env(r)`'s
    variables added to rank r's environment; one that fails (or the clock)
    kills them all. Returns each rank's saved result."""
    import torch
    store = os.path.join(out, "store")
    logs = [os.path.join(out, f"rank{r}.log") for r in range(M_WORLD)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", task,
                               str(r), f"file://{store}", out],
                              cwd=ROOT, env=dict(env, **(rank_env(r) if rank_env else {})),
                              stdout=open(logs[r], "w"),
                              stderr=subprocess.STDOUT) for r in range(M_WORLD)]
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    for lg in logs:
        with open(lg) as f:
            tail = f.read()[-4000:]
        print(f"[mesh {task}] {os.path.relpath(lg, ROOT)}:\n{tail}", flush=True)
    if codes != [0] * M_WORLD:
        fail(f"the {task} ranks exited {codes} (timeout {timeout} s)")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(M_WORLD)]


def _m1_batches(rank: int, world: int, path: str = CONFIG, n: int = 2):
    """(config, this process's n train batches, its validation batch) of m1
    (of the config at `path` with m1's settings): rows `rank` of `world` of
    each global batch of 100, as the driver loads them."""
    import torch
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(path, M1_ARGS)
    train_ds, val_ds, _ = driver.load_datasets(cfg)
    b = int(cfg["batch_size"]) // world
    kw = dict(process_index=rank, process_count=world, as_uint8=True)
    train = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in itertools.islice(
        train_ds.batches(b, shuffle=True, seed=int(cfg["seed"]), **kw), n)]
    vx, vy = next(val_ds.batches(b, shuffle=False, seed=0, **kw))
    return cfg, train, (torch.from_numpy(vx), torch.from_numpy(vy))


def _snapshot(state) -> tuple:
    """The state's weights and momentum in the one-process layout (a state
    cut over the model axis gathered: every rank calls it)."""
    from edge_enhancement_tpu_torch.parallel import sharding
    sd, mom = sharding.gather_state(state)
    return ({k: v.detach().cpu().clone() for k, v in sd.items()},
            [b.detach().cpu().clone() for b in mom])


def _m1_run(torch, cfg, train, val, given=None, ckpt_dir=None) -> dict:
    """2 train steps and 1 validation batch of the flagship on this
    process's rows (the process group's, when there is one; its model cut
    over the mesh's `model` axis, when it has one): the losses, each step's
    x_adv and first attack gradient, ms/step, launches, peak memory, and
    the state (parameters, buffers, momentum; gathered) before and after
    each step. With `given` (another run's result) each step starts from
    that run's state before it, and its attack runs and is kept, but that
    run's x_adv trains the model: each step is held alone. With `ckpt_dir`
    the run ends with the driver's checkpoint there. An AWP config
    (`awp_gamma`) trains with the AWP step, the gate on: each step's
    perturbation (objectives/awp.py's awp_diff, gathered) is kept too, and
    `given` may also hold another run's ("diffs"), which then perturbs the
    weights in place of this run's own."""
    from edge_enhancement_tpu_torch.attacks import pgd
    from edge_enhancement_tpu_torch.objectives import awp as awp_step, methods
    from edge_enhancement_tpu_torch.parallel import mesh, sharding
    from edge_enhancement_tpu_torch.train import checkpoint, driver
    from edge_enhancement_tpu_torch.train.trainer import (OptimConfig, build_eval_step,
                                                          build_train_step)
    device = torch.device(cfg["device"])
    driver.pin_precision(cfg)
    ops, state, gen = driver.build(cfg, 200, device)
    mesh.replicate(state.model)
    sharding.shard_state(state)
    opt = OptimConfig(momentum=float(cfg["momentum"]), weight_decay=float(cfg["weight_decay"]))
    method, awp = driver.make_method_config(cfg, 200), driver.awp_config(cfg)
    diffs, real_diff = [], awp_step.awp_diff
    kept_diff = real_diff
    if awp is None:
        step, attacks = build_train_step(ops, method, opt, gen), methods
    else:
        one = awp_step.build_awp_train_step(ops, method, opt, awp, gen)
        step, attacks = (lambda st, x, y, lr: one(st, x, y, lr, 1.0)), awp_step

        def kept_diff(params, grads, proxy_lr, cut):
            out = real_diff(params, grads, proxy_lr, cut)
            diffs.append([(mesh.gather_model(d, 0) if c else d).cpu()
                          for d, c in zip(out, cut)])
            if given is None or "diffs" not in given:
                return out
            return [d.to(p.device) for d, p in zip(given["diffs"][len(diffs) - 1], params)]
    eval_step = build_eval_step(ops, driver.eval_attack(cfg, 200), gen)
    x_adv, grads, real, real_grad = [], [], attacks.pgd_linf, pgd._input_grad

    def kept(*args, **kwargs):
        n = len(grads)
        x_adv.append(real(*args, **kwargs))
        del grads[n + 1:]                     # each attack's first gradient
        if given is None:
            return x_adv[-1]
        return given["x_adv"][len(x_adv) - 1].to(x_adv[-1].device)

    def first_grad(loss_fn, x):
        grads.append(real_grad(loss_fn, x))
        return grads[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _reset_counts()
    losses, ms, after = [], [], []
    start = _snapshot(state)
    attacks.pgd_linf, pgd._input_grad, awp_step.awp_diff = kept, first_grad, kept_diff
    try:
        for i, (x, y) in enumerate(train):
            if given is not None:
                sd, mom = given["starts"][i]
                state.model.load_state_dict(sd)
                for b, v in zip(state.momentum_buf, mom):
                    b.copy_(v)
            torch.cuda.synchronize()
            t0 = time.time()
            m = step(state, x.to(device), y.to(device), driver.epoch_lr(cfg, 0))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.time() - t0))
            after.append(_snapshot(state))
    finally:
        attacks.pgd_linf, pgd._input_grad = real, real_grad
        awp_step.awp_diff = real_diff
    metrics = eval_step(state, val[0].to(device), val[1].to(device))
    torch.cuda.synchronize()
    launches, peak_gb = _read_counts(), torch.cuda.max_memory_allocated(device) / 1e9
    if ckpt_dir is not None:
        checkpoint.save_checkpoint(ckpt_dir, state, 1, cfg["arch"], 0.0, False, opt,
                                   driver.epoch_lr(cfg, 0))
    return {"losses": losses, "ms": ms,
            "starts": [start] + after[:-1], "after": after,
            "x_adv": [a.detach().cpu() for a in x_adv],
            "grads": [g.cpu() for g in grads], "diffs": diffs,
            "val": {k: float(v) for k, v in metrics.items()},
            "peak_gb": peak_gb, "launches": launches}


def _m3_run(torch, out: str) -> dict:
    """m3 on one rank: free-AT through the driver's run() for 1 step and
    the checkpoint, then --resume for 1 step; the restored noise, weights
    and momentum against the files, launches and peak memory of each."""
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.utils.config import load_config
    path = os.path.join(CONFIGS, "free_imagenet", "free_at_ee.yml")
    runs = {}
    for tag, over in (("fresh", {}), ("resumed", {"epochs": 5})):
        cfg = load_config(path, dict(M3_ARGS, **over, output=os.path.join(out, tag)))
        if tag == "resumed":
            cfg["resume"] = os.path.dirname(runs["fresh"]["checkpoint"])
        seen, real_noise, real_restore = {}, driver._load_noise, driver.restore_into_state

        def load_noise(c, noise, log):
            seen["restored_noise"] = real_noise(c, noise, log).cpu().clone()
            return seen["restored_noise"].to(noise.device)

        def restore(state, payload):
            result = real_restore(state, payload)
            seen["restored_state"] = {k: v.cpu().clone() for k, v in
                                      state.model.state_dict().items()}
            seen["restored_momentum"] = [b.cpu().clone() for b in state.momentum_buf]
            return result

        driver._load_noise, driver.restore_into_state = load_noise, restore
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        try:
            summary = driver.run(cfg)
        finally:
            driver._load_noise, driver.restore_into_state = real_noise, real_restore
        torch.cuda.synchronize()
        runs[tag] = {"checkpoint": summary["checkpoint"], "noise_file": summary["noise"],
                     "noise_saved": torch.load(summary["noise"], weights_only=True),
                     "steps": summary["train_steps"], "evals": summary["eval_batches"],
                     "loss": summary["loss"], "ms": [1e3 * s for s in summary["step_seconds"]],
                     "launches": _read_counts(), "start_epoch": summary["start_epoch"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **seen}
    return runs


def _r_chain_run(torch, cfg, train) -> dict:
    """r1 or r2 on one rank of the group: R_STEPS eager flagship steps on
    this rank's rows from the config's seed, then one chained dispatch of
    them from a fresh build, cuDNN deterministic, the launch counters set
    to 0 before each and read after; then R_TIMED more dispatches of the
    chained step, each's host seconds (to the device sync) and device
    seconds (CUDA events). The state's tensors (on the CPU) and the last
    loss of both runs, the form the chained step took and its capture
    seconds, each eager step's ms."""
    from edge_enhancement_tpu_torch.parallel import mesh
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.train.graphs import chained_form
    from edge_enhancement_tpu_torch.train.trainer import (OptimConfig,
                                                          build_chained_train_step,
                                                          build_train_step)
    device = torch.device("cuda", torch.cuda.current_device())
    driver.pin_precision(cfg)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    opt = OptimConfig(momentum=float(cfg["momentum"]), weight_decay=float(cfg["weight_decay"]))
    method, lr = driver.make_method_config(cfg, 200), driver.epoch_lr(cfg, 0)
    xs = torch.stack([x for x, _ in train]).to(device)
    ys = torch.stack([y for _, y in train]).to(device)
    result = {"form": chained_form(device.type, mesh.backend(), mesh.world_size()),
              "backend": mesh.backend(), "device": str(device), "eager_ms": []}
    for run in ("eager", "chained"):
        ops, state, gen = driver.build(cfg, 200, device)
        mesh.replicate(state.model)
        torch.cuda.synchronize()
        _reset_counts()
        if run == "eager":
            step = build_train_step(ops, method, opt, gen)
            for x, y in zip(xs, ys):
                t0 = time.perf_counter()
                m = step(state, x, y, lr)
                torch.cuda.synchronize()
                result["eager_ms"].append(1e3 * (time.perf_counter() - t0))
        else:
            step = build_chained_train_step(ops, method, opt, gen)
            m = step(state, xs, ys, lr)
            torch.cuda.synchronize()
        names = [n for n, _ in state.model.named_parameters()]
        tensors = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        tensors.update({f"momentum {n}": b.cpu().clone()
                        for n, b in zip(names, state.momentum_buf)})
        tensors["loss"] = m["loss"].detach().cpu().clone()
        result[run] = {"tensors": tensors, "launches": _read_counts(), "step": state.step}
    result["capture_seconds"] = step.capture_seconds
    result["timed"] = []
    for _ in range(R_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(state, xs, ys, lr)
        end.record()
        torch.cuda.synchronize()
        result["timed"].append((time.perf_counter() - t0, start.elapsed_time(end) / 1e3))
    return result


def _nccl_refusal(torch, device) -> str:
    """'' where this rank's NCCL group all-reduces a probe (which creates
    its communicator), else NCCL's error."""
    try:
        probe = torch.ones(1, device=device)
        torch.distributed.all_reduce(probe)
        torch.cuda.synchronize()
    except RuntimeError as e:             # DistBackendError is one
        return f"{type(e).__name__}: {e}"
    if probe.item() != M_WORLD:
        fail(f"r2: the NCCL probe summed to {probe.item()}, not {M_WORLD}")
    return ""


def rank_main(argv) -> None:
    """One rank of phases m, p and r: `--rank <m1|m3|p1|r1|r2|r3> <rank>
    <store url> <out dir>`, on cuda:0 through gloo (p1 and r3: a model axis
    of P1_MODEL); r2 through NCCL, on cuda:<rank> where the machine has a
    card a rank, else on cuda:0; saves its result to <out>/rank<r>.pt."""
    import torch
    from edge_enhancement_tpu_torch.parallel import mesh
    task, rank, store, out = argv[0], int(argv[1]), argv[2], argv[3]
    device, backend = "cuda:0", "gloo"
    if task == "r2":
        backend = "nccl"
        if torch.cuda.device_count() >= M_WORLD:
            device = f"cuda:{rank}"
    mesh.init(device, backend=backend, init_method=store, rank=rank, world_size=M_WORLD,
              n_model=P1_MODEL if task in ("p1", "r3") else 1)
    try:
        if task in ("r1", "r2"):
            refused = _nccl_refusal(torch, device) if task == "r2" else ""
            if refused:
                result = {"refused": refused}
            else:
                cfg, train, _ = _m1_batches(rank, M_WORLD, n=R_STEPS)
                result = _r_chain_run(torch, cfg, train)
        elif task == "r3":
            cfg, train, val = _m1_batches(mesh.data_rank(), mesh.data_size(), R3_CONFIG)
            result = _m1_run(torch, cfg, train, val)
            result["model_rank"], result["n_model"] = mesh.model_rank(), mesh.model_size()
            if rank:                  # the perturbations are compared on rank 0's
                result["diffs"] = []
        elif task == "p1":
            cfg, train, val = _m1_batches(mesh.data_rank(), mesh.data_size())
            result = _m1_run(torch, cfg, train, val, ckpt_dir=os.path.join(out, "ckpt"))
            result["model_rank"], result["n_model"] = mesh.model_rank(), mesh.model_size()
        elif task == "m1":
            cfg, train, val = _m1_batches(rank, M_WORLD)
            result = _m1_run(torch, cfg, train, val)
            if rank:                  # the others' last state, for the replica check
                result["starts"], result["after"] = [], result["after"][-1:]
        else:
            result = _m3_run(torch, out)
        result["backend"] = torch.distributed.get_backend()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def _param_names(cfg):
    """The named parameters of the config's model (on the meta device)."""
    import torch
    from edge_enhancement_tpu_torch.models.registry import build_model
    with torch.device("meta"):
        return list(build_model(cfg["arch"], cfg, 200).named_parameters())


def _max_rel(got, want) -> float:
    """max |got - want| over want's largest magnitude."""
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def mesh_step_phase(torch, kernels, device_line) -> None:
    """m1. The flagship on M_WORLD ranks on the one card (gloo), then one
    process on the same global batches."""
    out = _out_dir("mesh/m1")
    os.makedirs(out)
    ranks = _spawn_ranks("m1", out)
    last = ranks[0]["after"][-1]
    for r in ranks[1:]:
        sd, mom = r["after"][-1]
        if (not all(torch.equal(sd[k], v) for k, v in last[0].items())
                or not all(torch.equal(a, b) for a, b in zip(mom, last[1]))
                or r["losses"] != ranks[0]["losses"]):
            fail("m1: the ranks' replicas differ")
    parts = [_m1_batches(r, M_WORLD) for r in range(M_WORLD)]
    cfg = parts[0][0]
    train = [tuple(torch.cat([p[1][i][j] for p in parts]) for j in range(2))
             for i in range(2)]
    val = tuple(torch.cat([p[2][j] for p in parts]) for j in range(2))
    given = {"starts": ranks[0]["starts"],
             "x_adv": [torch.cat([r["x_adv"][i] for r in ranks]) for i in range(len(train))]}
    one = _m1_run(torch, cfg, train, val, given)
    again = _m1_run(torch, cfg, train, val, given)
    k = int(cfg["num_steps_1"])
    want = {k_: 0 for k_ in one["launches"]}
    want.update({"ee_fused_fwd": 2 * (k + 1) + (k + 2), "ee_fused_bwd": 2 * k + k})
    names = [n for n, _ in _param_names(cfg)]
    flat = lambda sd: torch.cat([sd[n].reshape(-1).double() for n in names])
    share = lambda a, b: float((a - b).abs().gt(1e-6).float().mean())
    grad_rel, signs, loss_rel, param_rel, update_rel, worst, mom_rel = ([] for _ in range(7))
    for i, g in enumerate(one["grads"]):
        gr = torch.cat([r["grads"][i] for r in ranks])
        grad_rel.append(((gr - g).norm() / g.norm()).item())
        signs.append((torch.sign(gr) == torch.sign(g)).float().mean().item())
        a, b = ranks[0]["losses"][i], one["losses"][i]
        loss_rel.append(abs(a - b) / abs(b))
        (sd_r, mom_r), (sd_1, mom_1) = ranks[0]["after"][i], one["after"][i]
        param_rel.append(((flat(sd_r) - flat(sd_1)).norm() / flat(sd_1).norm()).item())
        update_rel.append(((flat(sd_r) - flat(sd_1)).norm()
                           / (flat(sd_1) - flat(ranks[0]["starts"][i][0])).norm()).item())
        worst.append(max((_max_rel(sd_r[n], sd_1[n]), n) for n in names))
        mom_rel.append(max(_max_rel(u, v) for u, v in zip(mom_r, mom_1)))
    print(f"[mesh m1] {cfg['arch']} bs{cfg['batch_size']} ({int(cfg['batch_size']) // M_WORLD} "
          f"a rank) f32 PGD-{k} on synthetic-hard, {M_WORLD} ranks ({ranks[0]['backend']}) "
          f"on {cfg['device']}, each step against one process from the ranks' state on "
          f"the same global batch and draws: first attack gradient |diff| / |g| "
          f"{[f'{v:.3e}' for v in grad_rel]} (limit {M1_GRAD_TOL}), signs alike {signs}; "
          f"x_adv pixels apart {[share(a, b) for a, b in zip(given['x_adv'], one['x_adv'])]} "
          f"(one process against itself "
          f"{[share(a, b) for a, b in zip(one['x_adv'], again['x_adv'])]}); trained on the "
          f"ranks' x_adv: losses {ranks[0]['losses']} and {one['losses']}, rel "
          f"{[f'{v:.3e}' for v in loss_rel]} (limit {M1_LOSS_RTOL}); parameter vector "
          f"|diff| / |p| {[f'{v:.3e}' for v in param_rel]}, over the step's update "
          f"{[f'{v:.3e}' for v in update_rel]} (limit {M1_UPDATE_TOL}); per "
          f"tensor the largest max |diff| / max |p| {[(f'{v:.3e}', n) for v, n in worst]}, "
          f"momentum {[f'{v:.3e}' for v in mom_rel]}; validation 2 ranks {ranks[0]['val']}, "
          f"one process {one['val']}", flush=True)
    for tag, res in [(f"rank {r}", ranks[r]) for r in range(M_WORLD)] + [("one process", one)]:
        print(f"[mesh m1] {tag}: train step ms {[round(t, 1) for t in res['ms']]} "
              f"({res['ms'][-1]:.1f} ms/step after the first); peak device memory "
              f"{res['peak_gb']:.2f} GB; on {device_line}", flush=True)
    for r, res in enumerate(ranks):
        _check_launches(f"mesh m1 rank {r}", res["launches"], want)
        _record_launches(kernels, f"mesh_m1_rank{r}", res["launches"])
    _check_launches("mesh m1 one process", one["launches"], want)
    if ranks[0]["backend"] != "gloo" or len(ranks[0]["losses"]) != 2:
        fail(f"m1 ran {len(ranks[0]['losses'])} steps on {ranks[0]['backend']}")
    if not all(math.isfinite(v) for v in ranks[0]["losses"] + one["losses"]):
        fail("m1: a loss is not finite")
    if (len(grad_rel) != 2 or max(grad_rel) > M1_GRAD_TOL or max(loss_rel) > M1_LOSS_RTOL
            or max(update_rel) > M1_UPDATE_TOL):
        fail("m1: the ranks' run disagrees with the one process's")


def _against_one_process(torch, cfg, rank: dict, one: dict) -> tuple:
    """A model-axis rank's run against one process's from its state on the
    same batches and x_adv (p1, r3): each step's first attack gradient,
    |diff| / |g|; its loss, relative; its update, |diff| / |update|."""
    names = [n for n, _ in _param_names(cfg)]
    flat = lambda sd: torch.cat([sd[n].reshape(-1).double() for n in names])
    grad_rel, loss_rel, update_rel = [], [], []
    for i, g in enumerate(one["grads"]):
        grad_rel.append(((rank["grads"][i] - g).norm() / g.norm()).item())
        loss_rel.append(abs(rank["losses"][i] - one["losses"][i]) / abs(one["losses"][i]))
        (sd_r, _), (sd_1, _) = rank["after"][i], one["after"][i]
        update_rel.append(((flat(sd_r) - flat(sd_1)).norm()
                           / (flat(sd_1) - flat(rank["starts"][i][0])).norm()).item())
    return grad_rel, loss_rel, update_rel


def model_axis_phase(torch, kernels, device_line) -> None:
    """p1. The flagship on M_WORLD ranks of data 1 x model P1_MODEL (the
    mesh's model axis), then one process on the same batches: m1's checks
    at P1_*'s limits, and the gathered checkpoint against the one-process
    file."""
    from edge_enhancement_tpu_torch.train import checkpoint
    out = _out_dir("mesh/p1")
    os.makedirs(out)
    ranks = _spawn_ranks("p1", out)
    for r in ranks[1:]:
        if (r["losses"] != ranks[0]["losses"]
                or any(not torch.equal(a, b) for a, b in zip(r["x_adv"], ranks[0]["x_adv"]))
                or any(not torch.equal(a, b) for a, b in zip(r["grads"], ranks[0]["grads"]))):
            fail("p1: the model ranks' losses, x_adv or attack gradients differ")
    cfg, train, val = _m1_batches(0, 1)
    given = {"starts": ranks[0]["starts"], "x_adv": ranks[0]["x_adv"]}
    one = _m1_run(torch, cfg, train, val, given)
    k = int(cfg["num_steps_1"])
    want = {k_: 0 for k_ in one["launches"]}
    want.update({"ee_fused_fwd": 2 * (k + 1) + (k + 2), "ee_fused_bwd": 2 * k + k})
    grad_rel, loss_rel, update_rel = _against_one_process(torch, cfg, ranks[0], one)
    share = lambda a, b: float((a - b).abs().gt(1e-6).float().mean())
    payload = checkpoint.load_checkpoint(os.path.join(out, "ckpt"))
    sd_last, mom_last = ranks[0]["after"][-1]
    one_sd = one["after"][-1][0]
    ckpt_ok = (sorted(payload["state_dict"]) == sorted(one_sd)
               and all(payload["state_dict"][n].shape == v.shape for n, v in one_sd.items())
               and all(torch.equal(payload["state_dict"][n], v.to(payload["state_dict"][n].device))
                       for n, v in sd_last.items())
               and all(torch.equal(payload["optimizer"]["state"][i]["momentum_buffer"], b)
                       for i, b in enumerate(mom_last)))
    print(f"[model p1] {cfg['arch']} bs{cfg['batch_size']} f32 PGD-{k} on synthetic-hard, "
          f"{M_WORLD} ranks of data 1 x model {ranks[0]['n_model']} ({ranks[0]['backend']}, "
          f"cuda:0), convolutions and head cut on their output "
          f"channels; each step against one process from the ranks' gathered state on the "
          f"same batch and draws: first attack gradient |diff| / |g| "
          f"{[f'{v:.3e}' for v in grad_rel]} (limit {P1_GRAD_TOL}); x_adv pixels apart "
          f"{[share(a, b) for a, b in zip(given['x_adv'], one['x_adv'])]}; trained on the "
          f"ranks' x_adv: losses {ranks[0]['losses']} and {one['losses']}, rel "
          f"{[f'{v:.3e}' for v in loss_rel]} (limit {P1_LOSS_RTOL}); update |diff| / "
          f"|update| {[f'{v:.3e}' for v in update_rel]} (limit {P1_UPDATE_TOL}); validation "
          f"ranks {ranks[0]['val']}, one process {one['val']}; gathered checkpoint = the "
          f"one-process format and the ranks' state: {ckpt_ok}", flush=True)
    for tag, res in [(f"rank {r}", ranks[r]) for r in range(M_WORLD)] + [("one process", one)]:
        print(f"[model p1] {tag}: K1/K2 launches {res['launches'].get('ee_fused_fwd')}/"
              f"{res['launches'].get('ee_fused_bwd')}; train step ms "
              f"{[round(t, 1) for t in res['ms']]} ({res['ms'][-1]:.1f} ms/step after the "
              f"first); peak device memory {res['peak_gb']:.2f} GB; on {device_line}",
              flush=True)
    for r, res in enumerate(ranks):
        _check_launches(f"model p1 rank {r}", res["launches"], want)
        _record_launches(kernels, f"model_p1_rank{r}", res["launches"])
    if len(ranks[0]["losses"]) != 2 or not all(
            math.isfinite(v) for v in ranks[0]["losses"] + one["losses"]):
        fail("p1: the ranks did not run 2 finite steps")
    if (len(grad_rel) != 2 or max(grad_rel) > P1_GRAD_TOL or max(loss_rel) > P1_LOSS_RTOL
            or max(update_rel) > P1_UPDATE_TOL):
        fail("p1: the model axis's run disagrees with the one process's")
    if not ckpt_ok:
        fail("p1: the gathered checkpoint is not the one-process file of the ranks' state")


def bf16_variants_phase(torch, kernels, device_line) -> None:
    """p2. P2_RUNS under the bf16 policy through the driver at full width:
    one train step and one validation batch each, a finite loss, no kernel
    launched (their front-ends and blocks are plain PyTorch), ms/step and
    peak memory, and the reference (logits card vs CPU)."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    for tag, path, over, args in P2_RUNS:
        cfg = load_config(path, dict(args, **over, half=True, limit_batches=1,
                                     output=_out_dir(tag)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.time()
        summary = run(cfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _read_counts()
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        print(f"[slice {tag}] {cfg['arch']} type_canny {cfg.get('type_canny', 'CannyFilter')} "
              f"{cfg['method_name']} {cfg['cize']} px bs{cfg['batch_size']} bf16 policy, "
              f"PGD-{cfg['num_steps_1']}: {steps} train step, {evals} eval batch; loss "
              f"{summary['loss']:.4f}; train step ms "
              f"{[round(1000 * s_, 1) for s_ in summary['step_seconds']]}; run {wall:.1f} s; "
              f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; on "
              f"{device_line}", flush=True)
        _check_launches(tag, launches, {})
        if steps != 1 or evals != 1:
            fail(f"{tag}: expected 1 train step and 1 eval batch, got {steps}, {evals}")
        if not math.isfinite(summary["loss"]):
            fail(f"{tag}: loss {summary['loss']} is not finite")
        reference_phase(torch, cfg, summary["checkpoint"])
        shutil.rmtree(cfg["output"])


def torchrun_phase(torch, kernels, device_line) -> None:
    """m2. The flagship through the real entry point under torchrun (one
    process a card, env://, NCCL): 2 train steps and 1 validation batch
    with --profile. One log, one checkpoint (rank 0's), its logits against
    the CPU path, and the trace names K1."""
    from edge_enhancement_tpu_torch.utils.config import load_config
    n = 2 if torch.cuda.device_count() >= 2 else 1
    out, prof = _out_dir("mesh/m2"), _out_dir("mesh/m2_trace")
    args = ["--config", CONFIG, "--data", "synthetic-hard", "--synthetic-size", "400",
            "--epochs", "1", "--limit-batches", "2", "--device", "cuda",
            "--output", out, "--profile", prof]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), "-m", "edge_enhancement_tpu_torch.train", *args]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=M_TIMEOUT)
    print(f"[mesh m2] {' '.join(cmd[1:])}: exit {proc.returncode} in "
          f"{time.time() - t0:.1f} s\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}", flush=True)
    if proc.returncode != 0:
        fail("m2: torchrun's run failed")
    cfg = load_config(CONFIG, dict(data="synthetic-hard", output=out))
    run_dir = os.path.join(out, "tiny_imagenet", "EE_BPDA3_AT_square",
                           f"resnet18_EE_square-bs{cfg['batch_size']}-lr{cfg['lr']}-seed{cfg['seed']}")
    with open(os.path.join(run_dir, "log", "log.txt")) as f:
        log = f.read()
    ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
    first = log.splitlines()[0]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "ee_fused_fwd_kernel" in e.get("name", "")]
    busy = sum(e.get("dur", 0) for e in events if e.get("cat") == "kernel")
    print(f"[mesh m2] {n} process(es): first log line {first!r}; "
          f"{[ln for ln in log.splitlines() if ln.startswith('=> epoch')]}; ckpt files "
          f"{ckpts}; trace {len(events)} events, "
          f"{len(k1)} K1 launches (ee_fused_fwd_kernel), kernels {busy / 1e3:.1f} ms "
          f"of device time in the window", flush=True)
    if log.count("=> dataset") != 1 or f"{n} processes (nccl)" not in first:
        fail(f"m2: expected one log of {n} NCCL process(es)")
    if "checkpoint.pth.tar" not in ckpts or "=> epoch 0: 2 train steps" not in log:
        fail("m2: no checkpoint, or not 2 train steps")
    if not k1:
        fail("m2: the profiler trace names no K1 launch")
    reference_phase(torch, cfg, os.path.join(run_dir, "ckpt", "checkpoint.pth.tar"))
    shutil.rmtree(out)


def free_at_mesh_phase(torch, kernels, device_line) -> None:
    """m3. Free-AT on M_WORLD ranks on the one card (gloo) through the
    driver's run(): 1 step and the checkpoint, then --resume for 1 step.
    Each rank's noise_p{rank}.pt restored bit for bit, the ranks' noise of
    different rows, the restored weights and momentum the file's."""
    out = _out_dir("mesh/m3")
    os.makedirs(out)
    ranks = _spawn_ranks("m3", out)
    saved = torch.load(ranks[0]["fresh"]["checkpoint"], map_location="cpu", weights_only=True)
    bufs = saved["optimizer"]["state"]
    want = {"ee_fused_fwd": 4 + 12, "ee_fused_bwd": 4 + 10}    # a step + a validation batch
    for r, res in enumerate(ranks):
        f, s = res["fresh"], res["resumed"]
        checks = {
            "file": os.path.basename(f["noise_file"]) == f"noise_p{r}.pt",
            "noise restored": torch.equal(s["restored_noise"], f["noise_saved"]),
            "state restored": all(torch.equal(s["restored_state"][k], v)
                                  for k, v in saved["state_dict"].items()),
            "momentum restored": len(bufs) == len(s["restored_momentum"]) and all(
                torch.equal(b, bufs[i]["momentum_buffer"])
                for i, b in enumerate(s["restored_momentum"])),
            "steps": f["steps"] == s["steps"] == [1] and s["start_epoch"] == 1,
            "finite": math.isfinite(f["loss"]) and math.isfinite(s["loss"])}
        print(f"[mesh m3] rank {r} ({res['backend']}): {os.path.basename(f['noise_file'])} "
              f"{tuple(f['noise_saved'].shape)} max |n| {f['noise_saved'].abs().max().item():.4f}; "
              f"losses {f['loss']:.4f} then {s['loss']:.4f} (resumed at epoch "
              f"{s['start_epoch']}); train step ms {[round(t, 1) for t in f['ms'] + s['ms']]}; "
              f"peak device memory {f['peak_gb']:.2f} / {s['peak_gb']:.2f} GB; {checks}; "
              f"on {device_line}", flush=True)
        if not all(checks.values()):
            fail(f"m3 rank {r}: {checks}")
        for tag, run in (("fresh", f), ("resumed", s)):
            _check_launches(f"mesh m3 rank {r} {tag}", run["launches"], want)
            _record_launches(kernels, f"mesh_m3_rank{r}_{tag}", run["launches"])
    if torch.equal(ranks[0]["fresh"]["noise_saved"], ranks[1]["fresh"]["noise_saved"]):
        fail("m3: the ranks' replay noise holds the same rows")
    shutil.rmtree(out)


def _write_jpegs(jobs) -> None:
    """(path, (h, w), seed) each: a quality-92 JPEG of a smooth colour ramp
    under noise of amplitude 48, written by PIL on 8 threads; where PIL is
    not installed, a copy of the fixture of that shape
    (tests/data/jpeg/make_fixtures.py wrote them)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    try:
        from PIL import Image
    except ImportError:
        for path, (h, w), _ in jobs:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            shutil.copyfile(os.path.join(JPEG_FIXTURES, f"{h}x{w}.JPEG"), path)
        return

    def one(job):
        path, (h, w), seed = job
        rng = np.random.default_rng(seed)
        ramp = (np.linspace(0, 1, h)[:, None, None] * rng.uniform(0, 200, 3)
                + np.linspace(0, 1, w)[None, :, None] * rng.uniform(0, 200, 3))
        px = np.clip(ramp + rng.integers(0, 48, (h, w, 3)), 0, 255).astype(np.uint8)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(px).save(path, "JPEG", quality=92)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))


def write_imagenet_folder(root: str) -> None:
    """ImageNet's layout, <split>/<wnid>/*.JPEG: 2 classes, FOLDER_TRAIN
    train and FOLDER_VAL validation images, FOLDER_SIZES in turn."""
    jobs = []
    for split, n in (("train", FOLDER_TRAIN), ("val", FOLDER_VAL)):
        for i in range(n):
            jobs.append((os.path.join(root, split, f"n{i % 2:08d}", f"{split}_{i:05d}.JPEG"),
                         FOLDER_SIZES[i % len(FOLDER_SIZES)], i + (0 if split == "train" else 10**6)))
    _write_jpegs(jobs)


def write_tiny_imagenet_folder(root: str) -> None:
    """Tiny-ImageNet's layout: train/<wnid>/images/*.JPEG and the raw
    val/images with val_annotations.txt, 64 x 64 JPEGs, TINY_CLASSES
    classes of TINY_PER_CLASS images, as many in validation."""
    wnids = [f"n{9000 + c:08d}" for c in range(TINY_CLASSES)]
    n = TINY_CLASSES * TINY_PER_CLASS
    jobs = [(os.path.join(root, "train", wnids[i % TINY_CLASSES], "images", f"t_{i}.JPEG"),
             (64, 64), i) for i in range(n)]
    jobs += [(os.path.join(root, "val", "images", f"val_{i}.JPEG"), (64, 64), 10**6 + i)
             for i in range(n)]
    _write_jpegs(jobs)
    with open(os.path.join(root, "val", "val_annotations.txt"), "w") as f:
        for i in range(n):
            f.write(f"val_{i}.JPEG\t{wnids[i % TINY_CLASSES]}\t0\t0\t63\t63\n")


def folder_phase(torch, kernels, device_line) -> None:
    """n. Real folders: the port's decoder built, its path printed; fast-AT
    phase 1 through the driver from an ImageNet-layout JPEG folder (2 train
    steps at bs256 on 128 px RandomResizedCrops, 1 validation batch, K1/K2
    bf16 counts exact, path folder_fast_at), then the flagship for 1 step
    and 1 validation batch from a Tiny-ImageNet-layout JPEG folder (path
    folder_flagship). Prints the host's decode ms per batch (one batch
    loaded alone), the step's ms and how long each step waited for its
    batch (the lookahead thread decodes batch i + 1 during step i)."""
    from edge_enhancement_tpu_torch.data import native
    from edge_enhancement_tpu_torch.data.datasets import StreamingImageFolder, get_dataset
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    t0 = time.time()
    lib = native.build()
    path = native.decode_path()          # raises where neither libjpeg nor PIL is present
    print(f"[folder] decoder {os.path.relpath(lib, ROOT)} built in {time.time() - t0:.1f} s; "
          f"decode path {path}", flush=True)
    root = _out_dir("folders")
    t0 = time.time()
    write_imagenet_folder(os.path.join(root, "imagenet"))
    write_tiny_imagenet_folder(os.path.join(root, "tiny"))
    print(f"[folder] wrote {FOLDER_TRAIN} + {FOLDER_VAL} ImageNet-layout JPEGs "
          f"({', '.join(f'{w}x{h}' for h, w in FOLDER_SIZES)}) and "
          f"{2 * TINY_CLASSES * TINY_PER_CLASS} Tiny-ImageNet ones in "
          f"{time.time() - t0:.1f} s", flush=True)

    _, fast_path, fwd, bwd, per_step = next(s for s in IMAGENET_SLICES if s[0] == "fast_at")
    cfg, summary = imagenet_slice_phase(
        torch, kernels, device_line, "folder_fast_at", fast_path, fwd, bwd, per_step,
        dict(FOLDER_ARGS, data=os.path.join(root, "imagenet")))
    size, bs = int(cfg["cize"]), int(cfg["batch_size"])
    train_ds, _ = get_dataset("imagenet", os.path.join(root, "imagenet"), train=True,
                              image_size=size)
    if not isinstance(train_ds, StreamingImageFolder) or len(train_ds) != FOLDER_TRAIN:
        fail(f"the ImageNet folder loaded as {type(train_ds).__name__} of {len(train_ds)}")
    t0 = time.time()
    x, _ = next(train_ds.batches(bs, shuffle=True, seed=1, as_uint8=True))
    decode_ms = 1e3 * (time.time() - t0)
    if x.shape != (bs, size, size, 3):
        fail(f"a folder batch has shape {x.shape}")
    _report_folder_steps("folder_fast_at", summary, decode_ms, bs, size, path, device_line)

    cfg = load_config(CONFIG, dict(FOLDER_ARGS, data=os.path.join(root, "tiny"),
                                   limit_batches=1, output=_out_dir("folder_flagship")))
    _reset_counts()
    summary = run(cfg)
    torch.cuda.synchronize()
    launches = _read_counts()
    steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
    k = int(cfg["num_steps_1"])
    if steps != 1 or evals != 1:
        fail(f"folder_flagship: expected 1 train step and 1 eval batch, got {steps}, {evals}")
    _check_launches("folder_flagship", launches,
                    {"ee_fused_fwd": steps * (k + 1) + evals * (k + 2),
                     "ee_fused_bwd": (steps + evals) * k})
    if not math.isfinite(summary["loss"]):
        fail(f"folder_flagship: loss {summary['loss']} is not finite")
    _record_launches(kernels, "folder_flagship", launches)
    with open(os.path.join(summary["out_dir"], "log", "log.txt")) as f:
        logged = [ln for ln in f.read().splitlines() if ln.startswith("=> image folder")]
    if not logged or not logged[0].endswith(f"decoded by {path}"):
        fail(f"folder_flagship: the driver logged {logged}")
    tiny = get_dataset("tiny_imagenet", os.path.join(root, "tiny"), train=True)[0]
    t0 = time.time()
    next(tiny.batches(int(cfg["batch_size"]), shuffle=True, seed=1, as_uint8=True))
    _report_folder_steps("folder_flagship", summary, 1e3 * (time.time() - t0),
                         int(cfg["batch_size"]), 64, path, device_line)
    shutil.rmtree(root)


def _report_folder_steps(tag, summary, decode_ms, bs, size, path, device_line) -> None:
    """The decode against the step: the lookahead thread decodes batch
    i + 1 during step i, so a step waits for its batch by about decode -
    step once the first (warm-up) step is past."""
    steps_ms = [1e3 * s for s in summary["step_seconds"]]
    waits_ms = [1e3 * s for s in summary["data_seconds"]]
    steady = sorted(steps_ms[1:] or steps_ms)[len(steps_ms[1:] or steps_ms) // 2]
    print(f"[slice {tag}] host decode {decode_ms:.1f} ms per batch of {bs} at {size} px "
          f"({path}, one batch loaded alone); train step ms "
          f"{[round(v, 1) for v in steps_ms]}; each step waited for its batch ms "
          f"{[round(v, 1) for v in waits_ms]} (the first for a whole decode, the second "
          f"behind the warm-up step); past warm-up the lookahead "
          f"{'keeps each step waiting ~%.1f ms' % (decode_ms - steady) if decode_ms > steady else 'hides the decode'}"
          f" (decode {decode_ms:.1f} vs step {steady:.1f} ms); on {device_line}", flush=True)


def export_phase(torch, kernels, device_line, checkpoint: str) -> None:
    """o. The serving export: tools/export_model on the card from the
    flagship's checkpoint (slice a), a symbolic batch; the artifact
    (loaded with utils/export.py) at EXPORT_BATCHES images, with draws
    from one seed: its logits equal the live eval forward's on the same
    draws exactly, and each call launches K1 once and its plain version
    never (path export). Prints the artifact's MB and ms per call."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.tools import export_model
    from edge_enhancement_tpu_torch.train.checkpoint import load_checkpoint, restore_into_state
    from edge_enhancement_tpu_torch.train.driver import build
    from edge_enhancement_tpu_torch.utils.config import load_config
    from edge_enhancement_tpu_torch.utils.cuda_timing import median_ms
    from edge_enhancement_tpu_torch.utils.export import load_serving_artifact, make_serving_fn

    out = os.path.join(_out_dir("export"), "flagship.pt2")
    os.makedirs(os.path.dirname(out))
    ckpt_dir = os.path.dirname(checkpoint)
    _reset_counts()
    t0 = time.time()
    export_model.main(["--config", CONFIG, "--resume", ckpt_dir, "--out", out,
                       "--device", "cuda"])
    export_s = time.time() - t0
    torch.cuda.synchronize()
    if any(_read_counts().values()):
        fail(f"the export launched kernels: {_read_counts()}")
    art = load_serving_artifact(out)
    op = torch.ops.ee_tpu_torch.ee_fused_fwd.default
    nodes = [n for n in art.exported.graph.nodes if n.op == "call_function"]
    if sum(n.target is op for n in nodes) != 1:
        fail("the exported graph does not hold the K1 operator once")

    dev = torch.device("cuda")
    cfg = load_config(CONFIG, dict(device="cuda"))
    ops, state, _ = build(cfg, 200, dev)
    restore_into_state(state, load_checkpoint(ckpt_dir, "best")
                       or load_checkpoint(ckpt_dir, "last"))
    serve = make_serving_fn(ops)
    plain_calls = []
    real_plain = F.ee_fused_fwd_plain
    F.ee_fused_fwd_plain = lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k)
    gen = torch.Generator(device=dev).manual_seed(5)
    launches = {}
    try:
        for n in EXPORT_BATCHES:
            x = torch.rand((n, 64, 64, 3), generator=gen, device=dev)
            _reset_counts()
            got = art(x, EXPORT_SEED)
            torch.cuda.synchronize()
            counts = _read_counts()
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            want = serve(x, EXPORT_SEED)
            err = (got - want).abs().max().item()
            print(f"[export] {n} images: logits {tuple(got.shape)}, artifact vs live eval "
                  f"forward on the same draws: max |err| {err:.3e}, bit for bit "
                  f"{torch.equal(got, want)}; launches {counts}", flush=True)
            if got.shape != (n, 200) or not torch.equal(got, want):
                fail(f"the artifact's logits differ from the live forward at {n} images")
            _check_launches(f"export at {n} images", counts, {"ee_fused_fwd": 1})
        if plain_calls:
            fail(f"the artifact ran K1's plain version {len(plain_calls)} times")
        x = torch.rand((EXPORT_BATCHES[0], 64, 64, 3), generator=gen, device=dev)
        call_ms = median_ms(lambda: art(x, EXPORT_SEED))
        live_ms = median_ms(lambda: serve(x, EXPORT_SEED))
    finally:
        F.ee_fused_fwd_plain = real_plain
    _record_launches(kernels, "export", launches)
    print(f"[export] {os.path.relpath(out, ROOT)}: {os.path.getsize(out) / 1e6:.2f} MB, "
          f"exported in {export_s:.1f} s; {call_ms:.3f} ms per call of "
          f"{EXPORT_BATCHES[0]} images (draws included; live eval forward "
          f"{live_ms:.3f} ms); K1 launched once a call, its plain version never; on "
          f"{device_line}", flush=True)
    shutil.rmtree(os.path.dirname(out))


def _chained_run(torch, tag: str, spd: int) -> tuple:
    """q1's run of the flagship through run() with `spd` steps a dispatch:
    (config, summary, launches, the run's peak device GB above what was
    allocated before it)."""
    import gc

    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, dict(CHAINED_ARGS, steps_per_dispatch=spd,
                                   output=_out_dir(tag)))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _reset_counts()
    summary = run(cfg)
    torch.cuda.synchronize()
    return (cfg, summary, _read_counts(),
            (torch.cuda.max_memory_allocated() - held) / 1e9)


def _check_chained_run(tag: str, summary, spd: int, device_line: str) -> None:
    """q1's and q3's checks of a run: a finite loss; with K > 1 a capture
    and the log's first line naming the CUDA graph, with K = 1 neither."""
    with open(os.path.join(summary["out_dir"], "log", "log.txt")) as f:
        first = f.readline()
    capture = summary["capture_seconds"]
    print(f"[chained {tag}] K {spd}: {sum(summary['train_steps'])} train steps, "
          f"{sum(summary['eval_batches'])} eval batches; loss {summary['loss']:.4f}; "
          f"capture {capture} s on {device_line}; first log line: {first.strip()}",
          flush=True)
    if not math.isfinite(summary["loss"]):
        fail(f"{tag}: loss {summary['loss']} is not finite")
    chained = spd > 1
    if (capture is not None) != chained or chained != (
            f"steps_per_dispatch {spd} (CUDA graph)" in first):
        fail(f"{tag}: K {spd} but capture {capture}, log {first!r}")


def _median_ms(secs) -> float:
    return 1000.0 * sorted(secs)[len(secs) // 2]


def chained_run_phase(torch, kernels, device_line, eager_ms: float) -> None:
    """q1. The flagship with K = 4 through run(): 10 steps, 5 validation
    batches, K1/K2 by phase a's formula, one capture; ms/step over the full
    chains after the first dispatch beside the single-step runs' in turns
    and phase a's."""
    rows = []
    for tag, spd in (("q1_eager", 1), ("q1_chained", CHAINED_K),
                     ("q1_chained_2", CHAINED_K), ("q1_eager_2", 1)):
        cfg, summary, launches, peak_gb = _chained_run(torch, tag, spd)
        _check_chained_run(tag, summary, spd, device_line)
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        n_steps = int(cfg["num_steps_1"])
        if steps != CHAINED_STEPS or evals != CHAINED_EVALS:
            fail(f"{tag}: expected {CHAINED_STEPS} train steps and {CHAINED_EVALS} eval "
                 f"batches, got {steps}, {evals}")
        _check_launches(tag, launches, {"ee_fused_fwd": steps * (n_steps + 1)
                                        + evals * (n_steps + 2),
                                        "ee_fused_bwd": (steps + evals) * n_steps})
        if tag == "q1_chained":
            _record_launches(kernels, "chained", launches)
        secs = summary["step_seconds"]
        # the full chains after the first dispatch: steps K .. K * (n // K) - 1
        window = secs[CHAINED_K:CHAINED_K * (CHAINED_STEPS // CHAINED_K)]
        rows.append((tag, _median_ms(window), _median_ms(secs[1:]), peak_gb,
                     summary["capture_seconds"]))
        print(f"[chained {tag}] train step ms: {[round(1000 * s_, 1) for s_ in secs]}; "
              f"median over steps {CHAINED_K}-{CHAINED_K * (CHAINED_STEPS // CHAINED_K) - 1} "
              f"{rows[-1][1]:.1f} ms/step, after the first {rows[-1][2]:.1f}; the run's "
              f"peak device memory {peak_gb:.3f} GB; on {device_line}", flush=True)
    chained = [r for r in rows if "chained" in r[0]]
    eager = [r for r in rows if "eager" in r[0]]
    print(f"[chained q1] ms/step over the full chains after the first dispatch: "
          f"chained {[round(r[1], 1) for r in chained]}, eager "
          f"{[round(r[1], 1) for r in eager]} (same steps), chained / eager "
          f"{sum(r[1] for r in chained) / sum(r[1] for r in eager):.3f}; phase a's eager "
          f"{eager_ms:.1f}; capture {[round(r[4], 3) for r in chained]} s; the runs' "
          f"peak memory chained {[round(r[3], 3) for r in chained]} GB, eager "
          f"{[round(r[3], 3) for r in eager]}; on {device_line}", flush=True)


def _q2_steps(torch, cfg, batches, chained: bool, timed: list = None) -> dict:
    """Q2_STEPS flagship steps from the config's seed on `batches`, eager
    or as one chained dispatch: the state's tensors by name and the last
    loss. With `timed` (chained), Q2_TIMED more dispatches of the same
    batches after it, each's host seconds (to the device sync) and device
    seconds (CUDA events around it) appended."""
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.train.trainer import (OptimConfig,
                                                          build_chained_train_step,
                                                          build_train_step)
    device = torch.device(cfg["device"])
    ops, state, gen = driver.build(cfg, 200, device)
    opt = OptimConfig(momentum=float(cfg["momentum"]),
                      weight_decay=float(cfg["weight_decay"]))
    method = driver.make_method_config(cfg, 200)
    lr = driver.epoch_lr(cfg, 0)
    xs = torch.stack([torch.from_numpy(x) for x, _ in batches]).to(device)
    ys = torch.stack([torch.from_numpy(y) for _, y in batches]).to(device)
    if chained:
        step = build_chained_train_step(ops, method, opt, gen)
        m = step(state, xs, ys, lr)
        if step.capture_seconds is None:
            fail("q2: the chained dispatch did not capture")
    else:
        step = build_train_step(ops, method, opt, gen)
        for x, y in zip(xs, ys):
            m = step(state, x, y, lr)
    if state.step != Q2_STEPS:
        fail(f"q2: state.step {state.step}, expected {Q2_STEPS}")
    names = [n for n, _ in state.model.named_parameters()]
    tensors = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    tensors.update({f"momentum {n}": b.clone() for n, b in zip(names, state.momentum_buf)})
    tensors["loss"] = m["loss"].detach().clone()
    for _ in range(Q2_TIMED if timed is not None else 0):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(state, xs, ys, lr)
        end.record()
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0, start.elapsed_time(end) / 1e3))
    return tensors


def _differ(torch, a: dict, b: dict) -> list:
    return [(k, float((a[k].double() - b[k].double()).abs().max())) for k in a
            if not torch.equal(a[k], b[k])]


def chained_exact_phase(torch, device_line) -> None:
    """q2. Two eager runs of Q2_STEPS flagship steps and one chained
    dispatch of Q2_STEPS (step 1 eager, the capture, 2 replays) from one
    seed on the same batches, cuDNN deterministic: parameters, momentum,
    BatchNorm statistics and the last loss equal bit for bit."""
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG, dict(CHAINED_ARGS, output=_out_dir("q2")))
    driver.pin_precision(cfg)
    train_ds, _, _ = driver.load_datasets(cfg, train=True)
    batches = [(x, y) for _, x, y in driver._batches(train_ds, int(cfg["batch_size"]),
                                                      int(cfg["seed"]), 0, Q2_STEPS)]
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        eager = _q2_steps(torch, cfg, batches, False)
        again = _q2_steps(torch, cfg, batches, False)
        timed = []
        graphed = _q2_steps(torch, cfg, batches, True, timed)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    twice, apart = _differ(torch, eager, again), _differ(torch, eager, graphed)
    print(f"[chained q2] {Q2_STEPS} flagship steps, cuDNN deterministic: eager against "
          f"eager: {len(twice)} of {len(eager)} tensors differ {twice[:8]}; the chained "
          f"dispatch (1 eager, capture, {Q2_STEPS - 1} replays) against eager: "
          f"{len(apart)} differ {apart[:8]}; last loss {float(eager['loss']):.6f} / "
          f"{float(graphed['loss']):.6f}; on {device_line}", flush=True)
    host, dev = (1e3 * sum(t[j] for t in timed) / (len(timed) * Q2_STEPS) for j in (0, 1))
    print(f"[chained q2] {len(timed)} more dispatches of {Q2_STEPS} replays: {host:.2f} "
          f"ms/step on the host clock, {dev:.2f} on the device's (CUDA events around "
          f"each dispatch): the device idle {100 * (1 - dev / host):.2f}% of a dispatch; "
          f"on {device_line}", flush=True)
    if twice:
        fail("q2: two eager runs differ, so the graph cannot be held bit for bit")
    if apart:
        fail("q2: the replayed graph differs from the eager steps")


def chained_objectives_phase(torch, kernels, device_line) -> None:
    """q3. Phase i's 9 Tiny-ImageNet configs with K = 2 through run(): one
    dispatch of 2 steps (eager, capture, replay) and 1 validation batch
    each, K1/K2 by phase i's per-kind counts."""
    from edge_enhancement_tpu_torch.objectives.methods import canonical_method
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config

    total = {}
    for name in OBJECTIVE_CONFIGS:
        cfg = load_config(os.path.join(CONFIGS, "tiny_imagenet", f"{name}.yml"),
                          dict(Q3_ARGS, output=_out_dir(f"q3/{name}")))
        kind, k = canonical_method(cfg["method_name"]), int(cfg["num_steps_1"])
        _reset_counts()
        summary = run(cfg)
        torch.cuda.synchronize()
        launches = _read_counts()
        _check_chained_run(f"q3 {name}", summary, 2, device_line)
        steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
        if steps != 2 or evals != 1:
            fail(f"q3 {name}: expected 2 train steps and 1 eval batch, got {steps}, {evals}")
        fwd, bwd = step_launches(kind, k)
        _check_launches(f"q3 {name}", launches,
                        {"ee_fused_fwd": steps * fwd + evals * (k + 2),
                         "ee_fused_bwd": steps * bwd + evals * k}
                        if "_EE" in cfg["arch"] else {})
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        shutil.rmtree(cfg["output"])
    _record_launches(kernels, "chained_objectives", total)
    print(f"[chained q3] {len(OBJECTIVE_CONFIGS)} objectives captured and replayed; "
          f"launches {total}; on {device_line}", flush=True)


def chained_phase(torch, kernels, device_line, eager_ms: float) -> None:
    """q. steps_per_dispatch: q1, q2, q3."""
    chained_run_phase(torch, kernels, device_line, eager_ms)
    chained_exact_phase(torch, device_line)
    chained_objectives_phase(torch, kernels, device_line)


def _r_check(torch, tag: str, ranks: list, form: str, kernels, device_line) -> None:
    """r1's and r2's checks of each rank: the form, the chained dispatch
    equal to the eager steps bit for bit, the replicas alike, both runs'
    K1/K2 counts a rank by phase a's formula; the times printed."""
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, M1_ARGS)
    k = int(cfg["num_steps_1"])
    want = {"ee_fused_fwd": R_STEPS * (k + 1), "ee_fused_bwd": R_STEPS * k}
    for r, res in enumerate(ranks):
        eager, chained = res["eager"]["tensors"], res["chained"]["tensors"]
        apart = _differ(torch, eager, chained)
        host, dev = (1e3 * sum(t[j] for t in res["timed"]) / (len(res["timed"]) * R_STEPS)
                     for j in (0, 1))
        print(f"[ranks {tag}] rank {r} of {M_WORLD} ({res['backend']}, {res['device']}): the "
              f"chained step's form {res['form']}; {R_STEPS} flagship steps (bs"
              f"{cfg['batch_size']}, {int(cfg['batch_size']) // M_WORLD} a rank, PGD-{k}, cuDNN "
              f"deterministic) eager against one chained dispatch: {len(apart)} of "
              f"{len(eager)} tensors differ {apart[:8]}; last loss "
              f"{float(eager['loss']):.6f} / {float(chained['loss']):.6f}; K1/K2 eager "
              f"{res['eager']['launches'].get('ee_fused_fwd')}/"
              f"{res['eager']['launches'].get('ee_fused_bwd')}, chained "
              f"{res['chained']['launches'].get('ee_fused_fwd')}/"
              f"{res['chained']['launches'].get('ee_fused_bwd')}; eager step ms "
              f"{[round(t, 1) for t in res['eager_ms']]}; {len(res['timed'])} more dispatches "
              f"of {R_STEPS}: {host:.2f} ms/step on the host clock, {dev:.2f} on the "
              f"device's; capture {res['capture_seconds']} s; on {device_line}", flush=True)
        if res["form"] != form:
            fail(f"{tag} rank {r}: the chained step took the {res['form']} form, not {form}")
        if (res["capture_seconds"] is None) != (form == "loop"):
            fail(f"{tag} rank {r}: form {form} but capture {res['capture_seconds']}")
        if res["eager"]["step"] != R_STEPS or res["chained"]["step"] != R_STEPS:
            fail(f"{tag} rank {r}: state.step {res['eager']['step']} / "
                 f"{res['chained']['step']}, expected {R_STEPS}")
        if not math.isfinite(float(chained["loss"])):
            fail(f"{tag} rank {r}: the loss is not finite")
        if apart:
            fail(f"{tag} rank {r}: the chained dispatch differs from the eager steps")
        _check_launches(f"{tag} rank {r} eager", res["eager"]["launches"], want)
        _check_launches(f"{tag} rank {r} chained", res["chained"]["launches"], want)
        _record_launches(kernels, f"chained_ranks_{res['backend']}_rank{r}",
                         res["chained"]["launches"])
    if _differ(torch, ranks[0]["chained"]["tensors"], ranks[1]["chained"]["tensors"]):
        fail(f"{tag}: the ranks' replicas differ")


def _nccl_one_rank_capture(torch, device_line) -> None:
    """r2'. A world-1 NCCL group: K1 on the slice's batch and the
    all-reduce of `mesh._sum_over` on its outputs (one flat buffer, as
    sum_step's), eager and then captured in a CUDA graph and replayed on
    two inputs: the replays equal the eager calls bit for bit."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import add_square_draws, kernel_layout
    from edge_enhancement_tpu_torch.parallel import mesh
    out = _out_dir("mesh/r2_one")
    os.makedirs(out)
    mesh.init("cuda:0", backend="nccl", init_method=f"file://{os.path.join(out, 'store')}",
              rank=0, world_size=1)
    try:
        dev = torch.device("cuda:0")
        b, c, h, w = shape = (100, 3, 64, 64)
        k = F.FusedConsts(**FLAGSHIP_CONSTS)
        gen = torch.Generator(device=dev).manual_seed(0)
        st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), k.eps)

        def work(x):
            y, edge = F.ee_fused_fwd(x, st, sqd, k)
            return mesh._sum_over([y * 2.0, edge], None)

        inputs = [_patched_input(torch, dev, shape)]
        inputs.append(inputs[0].flip(-1).contiguous())
        eager = [[t.clone() for t in work(x)] for x in inputs]   # creates the communicator
        torch.cuda.synchronize()
        static = inputs[0].clone()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            outs = work(static)
        capture = time.perf_counter() - t0
        same = []
        for x, want in zip(inputs, eager):
            static.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            same.append(all(torch.equal(a, b_) for a, b_ in zip(outs, want)))
    finally:
        mesh.shutdown()
    print(f"[ranks r2'] a world-1 NCCL group on cuda:0: K1 (100x3x64x64) and the flat "
          f"all-reduce of mesh._sum_over captured in a CUDA graph in {capture:.3f} s; "
          f"replays equal to the eager calls bit for bit on 2 inputs: {same}; on "
          f"{device_line}", flush=True)
    if same != [True, True]:
        fail("r2': the replayed NCCL all-reduce differs from the eager one")
    shutil.rmtree(out)


def chained_ranks_phase(torch, kernels, device_line) -> None:
    """r1. The flagship's chained step on M_WORLD gloo ranks on cuda:0 (the
    loop form) against eager steps; r2 the same on NCCL ranks (the graph
    form), or r2' where NCCL refuses."""
    for tag, form in (("r1", "loop"), ("r2", "graph")):
        out = _out_dir(f"mesh/{tag}")
        os.makedirs(out)
        rank_env, timeout = None, M_TIMEOUT
        if tag == "r2":
            timeout = R2_TIMEOUT
            if torch.cuda.device_count() < M_WORLD:
                # two hosts to NCCL: its socket transport on the loopback
                rank_env = lambda r: {"NCCL_HOSTID": f"chip-smoke-rank{r}",
                                      "NCCL_SOCKET_IFNAME": "lo", "NCCL_DEBUG": "WARN"}
        t0 = time.perf_counter()
        ranks = _spawn_ranks(tag, out, timeout, rank_env)
        refused = [res["refused"] for res in ranks if "refused" in res]
        if refused:
            print(f"[ranks {tag}] NCCL refused {M_WORLD} ranks on "
                  f"{min(torch.cuda.device_count(), M_WORLD)} card(s) "
                  f"(NCCL_HOSTID set apart: {rank_env is not None}): {refused[0]}; "
                  f"r2' runs instead, and two-rank NCCL capture stays open", flush=True)
            _nccl_one_rank_capture(torch, device_line)
        else:
            _r_check(torch, tag, ranks, form, kernels, device_line)
        print(f"[ranks {tag}] {time.perf_counter() - t0:.1f} s wall", flush=True)
        shutil.rmtree(out)


def awp_model_axis_phase(torch, kernels, device_line) -> None:
    """r3. AWP (R3_CONFIG, the gate on) on M_WORLD ranks of data 1 x model
    P1_MODEL on cuda:0 through gloo, then one process from the ranks'
    gathered state on the same batches and x_adv, held to P1_*: each
    step's perturbation against the one process's own (R3_DIFF_TOL), then the one
    process trained on the ranks' perturbation (its update, as the loss
    and the attack gradient, is then held as p1's). A run with its own
    perturbation is printed beside it, not held: in float32 the
    perturbations' ~1e-5 rounding apart moves AWP's update by ~1e-3."""
    out = _out_dir("mesh/r3")
    os.makedirs(out)
    t0 = time.perf_counter()
    ranks = _spawn_ranks("r3", out)
    for r in ranks[1:]:
        if (r["losses"] != ranks[0]["losses"]
                or any(not torch.equal(a, b) for a, b in zip(r["x_adv"], ranks[0]["x_adv"]))
                or any(not torch.equal(a, b) for a, b in zip(r["grads"], ranks[0]["grads"]))):
            fail("r3: the model ranks' losses, x_adv or attack gradients differ")
    cfg, train, val = _m1_batches(0, 1, R3_CONFIG)
    given = {"starts": ranks[0]["starts"], "x_adv": ranks[0]["x_adv"]}
    own = _m1_run(torch, cfg, train, val, given)
    one = _m1_run(torch, cfg, train, val, dict(given, diffs=ranks[0]["diffs"]))
    flat = lambda ds: torch.cat([d.reshape(-1).double() for d in ds])
    diff_rel = [((flat(a) - flat(b)).norm() / flat(b).norm()).item()
                for a, b in zip(ranks[0]["diffs"], one["diffs"])]
    k = int(cfg["num_steps_1"])
    # a step: the attack's k forwards and backwards, then the proxy's and the
    # robust forward, whose backwards need no input gradient; the
    # validation batch k + 2 and k
    want = {"ee_fused_fwd": 2 * (k + 2) + (k + 2), "ee_fused_bwd": 2 * k + k}
    grad_rel, loss_rel, update_rel = _against_one_process(torch, cfg, ranks[0], one)
    own_update = _against_one_process(torch, cfg, ranks[0], own)[2]
    print(f"[ranks r3] {cfg['arch']} AWP (gamma {cfg['awp_gamma']}, the gate on) bs"
          f"{cfg['batch_size']} f32 PGD-{k} on synthetic-hard, {M_WORLD} ranks of data 1 x "
          f"model {ranks[0]['n_model']} ({ranks[0]['backend']}, cuda:0); each step against "
          f"one process from the ranks' gathered state on the same batch and x_adv: first "
          f"attack gradient |diff| / |g| {[f'{v:.3e}' for v in grad_rel]} (limit "
          f"{P1_GRAD_TOL}); the perturbation (whole-tensor norms over the model group) "
          f"|diff| / |d| {[f'{v:.3e}' for v in diff_rel]} (limit {R3_DIFF_TOL}); on the "
          f"ranks' perturbation: losses {ranks[0]['losses']} and {one['losses']}, rel "
          f"{[f'{v:.3e}' for v in loss_rel]} (limit {P1_LOSS_RTOL}); update |diff| / "
          f"|update| {[f'{v:.3e}' for v in update_rel]} (limit {P1_UPDATE_TOL}); on its own "
          f"perturbation {[f'{v:.3e}' for v in own_update]} (not held); validation ranks "
          f"{ranks[0]['val']}, one process {one['val']}", flush=True)
    for tag, res in [(f"rank {r}", ranks[r]) for r in range(M_WORLD)] + [("one process", one)]:
        print(f"[ranks r3] {tag}: K1/K2 launches {res['launches'].get('ee_fused_fwd')}/"
              f"{res['launches'].get('ee_fused_bwd')}; train step ms "
              f"{[round(t, 1) for t in res['ms']]} ({res['ms'][-1]:.1f} ms/step after the "
              f"first); peak device memory {res['peak_gb']:.2f} GB; on {device_line}",
              flush=True)
    for r, res in enumerate(ranks):
        _check_launches(f"r3 rank {r}", res["launches"], want)
        _record_launches(kernels, f"awp_model_axis_rank{r}", res["launches"])
    _check_launches("r3 one process", one["launches"], want)
    if len(ranks[0]["losses"]) != 2 or not all(
            math.isfinite(v) for v in ranks[0]["losses"] + one["losses"]):
        fail("r3: the ranks did not run 2 finite steps")
    if (len(grad_rel) != 2 or len(diff_rel) != 2 or max(grad_rel) > P1_GRAD_TOL
            or max(diff_rel) > R3_DIFF_TOL or max(loss_rel) > P1_LOSS_RTOL
            or max(update_rel) > P1_UPDATE_TOL):
        fail("r3: AWP on the model axis disagrees with the one process")
    print(f"[ranks r3] {time.perf_counter() - t0:.1f} s wall", flush=True)
    shutil.rmtree(out)


def ranks_phase(torch, kernels, device_line) -> None:
    """r. The chained step under several ranks (r1, r2 or r2') and AWP on
    the model axis (r3)."""
    torch.cuda.empty_cache()            # the ranks share the card
    chained_ranks_phase(torch, kernels, device_line)
    awp_model_axis_phase(torch, kernels, device_line)


def twin_phase(torch, kernels, device_line) -> None:
    """s. The flagship family of the port's twin (tools/twin.py) through
    its entry point, TWIN_ARGS: exact K1/K2 counts, finite accuracies."""
    from edge_enhancement_tpu_torch.tools import twin

    t0 = time.perf_counter()
    _reset_counts()
    record = twin.run("flagship", device="cuda", **TWIN_ARGS)
    torch.cuda.synchronize()
    launches = _read_counts()
    run = record["port"]["1"]
    steps, evals = run["train_steps"], run["eval_batches"]
    k = int(record["recipe"]["num_steps_1"])
    f_step, b_step = step_launches("at", k)
    print(f"[twin s] flagship recipe, seed 1, 1 epoch: {steps} train steps, {evals} "
          f"validation batches; clean {run['clean']} adv {run['adv']}; "
          f"{time.perf_counter() - t0:.1f} s wall on {device_line}", flush=True)
    if (steps, evals) != (TWIN_STEPS, TWIN_EVALS):
        fail(f"s: expected {TWIN_STEPS} train steps and {TWIN_EVALS} validation batches, "
             f"got {steps}, {evals}")
    _check_launches("twin", launches, {"ee_fused_fwd": steps * f_step + evals * (k + 2),
                                       "ee_fused_bwd": steps * b_step + evals * k})
    if run["launches"] != {name: n for name, n in launches.items() if n}:
        fail(f"s: the twin's own counts {run['launches']} differ from {launches}")
    if not all(math.isfinite(v) for v in run["clean"] + run["adv"]):
        fail(f"s: accuracies not finite: {run['clean']}, {run['adv']}")
    _record_launches(kernels, "twin", launches)
    for family in TWIN_LOOPS:
        twin_loop_phase(torch, family, device_line)


def twin_loop_phase(torch, family: str, device_line) -> None:
    """s. The free or fast family of the twin (free-AT's replay loop,
    fast-AT's FGSM loop) through its entry point, TWIN_LOOP_ARGS: the train
    steps, the SGD updates (replays), no kernel launched, finite
    accuracies."""
    from edge_enhancement_tpu_torch.tools import twin

    t0 = time.perf_counter()
    _reset_counts()
    record = twin.run(family, device="cuda", **TWIN_LOOP_ARGS)
    torch.cuda.synchronize()
    launches = _read_counts()
    run = record["port"]["1"]
    want = (TWIN_LOOP_STEPS, TWIN_LOOP_STEPS * int(record["recipe"]["n_repeats"]),
            TWIN_LOOP_EVALS)
    got = (run["train_steps"], run["updates"], run["eval_batches"])
    print(f"[twin s] {family} recipe ({record['recipe']['arch']}), seed 1, 1 epoch: "
          f"{got[0]} train steps, {got[1]} SGD updates, {got[2]} validation batches; "
          f"lr {run['lr']}; clean {run['clean']} adv {run['adv']}; "
          f"{time.perf_counter() - t0:.1f} s wall on {device_line}", flush=True)
    if got != want:
        fail(f"s: {family}: expected train steps, updates and validation batches "
             f"{want}, got {got}")
    _check_launches(f"twin_{family}", launches, {})
    if run["launches"]:
        fail(f"s: {family}: the twin's own counts {run['launches']} are not empty")
    if not all(math.isfinite(v) for v in run["clean"] + run["adv"]):
        fail(f"s: {family}: accuracies not finite: {run['clean']}, {run['adv']}")


def main():
    import torch

    name, smi = device_phase(torch)
    sys.path.insert(0, ROOT)
    build_phase()
    kernels = kernel_phase(torch)
    kernels += bf16_kernel_phase(torch)
    kernels += canny_kernel_phase(torch)
    kernels += canny_bf16_kernel_phase(torch)
    kernels += conv_kernel_phase(torch)
    checkpoints = {}
    eager_ms = {}
    for gf in (False, True):
        cfg, checkpoints[gf], eager_ms[gf] = slice_phase(torch, kernels, smi, gf)
        reference_phase(torch, cfg, checkpoints[gf])
    for tag, path, fwd, bwd, per_step in IMAGENET_SLICES:
        cfg, summary = imagenet_slice_phase(torch, kernels, smi, tag, path,
                                            fwd, bwd, per_step)
        reference_phase(torch, cfg, summary["checkpoint"])
    conv_path_phase(torch, kernels)
    phase2_ckpt = resume_phase(torch, kernels, smi, summary["checkpoint"])
    evaluate_phase(torch, kernels, smi, phase2_ckpt)
    eval_entry_phase(torch, kernels, smi, os.path.dirname(checkpoints[False]))
    objectives_phase(torch, kernels, smi)
    aa_phase(torch, kernels, smi, os.path.dirname(checkpoints[False]))
    aa_card_vs_cpu_phase(torch, checkpoints[False])
    restart_pgd_phase(torch, kernels, smi, checkpoints[False])
    variants_phase(torch, kernels, smi)
    zoo_phase(torch, kernels, smi)
    folder_phase(torch, kernels, smi)
    export_phase(torch, kernels, smi, checkpoints[False])
    torch.cuda.empty_cache()            # the ranks of phase m share the card
    mesh_step_phase(torch, kernels, smi)
    torchrun_phase(torch, kernels, smi)
    free_at_mesh_phase(torch, kernels, smi)
    model_axis_phase(torch, kernels, smi)
    bf16_variants_phase(torch, kernels, smi)
    chained_phase(torch, kernels, smi, eager_ms[False])
    ranks_phase(torch, kernels, smi)
    twin_phase(torch, kernels, smi)
    for kern in kernels:
        kern["launches"] = sum(kern.get("launches_by_path", {}).values())
    if any(k["launches"] < 1 for k in kernels):
        fail("a kernel was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


PHASES = {"r": ranks_phase, "s": twin_phase}


def phase_main(letter: str) -> None:
    """`--phase r` or `--phase s`: the device, the build and that phase
    alone (r on a machine with one card, or with a card a rank for r2); no
    kernels line and no final line."""
    import torch

    name, smi = device_phase(torch)
    sys.path.insert(0, ROOT)
    build_phase()
    PHASES[letter](torch, [], smi)
    print(f"chip_smoke: phase {letter} passed on {torch.cuda.device_count()} x {name}",
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.path.insert(0, ROOT)
        rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--phase"] and len(sys.argv) == 3 and sys.argv[2] in PHASES:
        phase_main(sys.argv[2])
    else:
        main()
