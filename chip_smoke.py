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
   for the bf16 K1/K2's products: a library whose kernels fell back to FP32
   FMAs fails.
3. The kernels against their plain PyTorch versions at the shapes their
   paths give them, errors against stated limits, median times from CUDA
   events, and each kernel's bound (the least time the card could take for
   its bytes and its operations); a kernel's time is its device time per
   launch from a replayed CUDA graph of 20 launches, beside the eager
   call's time: K1/K2 and K3a/K3b at 100 x 3 x 64 x 64
   float32 (with constant patches and saturated pixels), K1/K2 also at
   ImageNet's 224 px (square on) with 8 images (56 blocks, under half the
   SMs) and with free-AT's batch of 256, K3a/K3b also with ImageNet's batch
   of 128 at 224 px, each beside its bound and its plain version's time;
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
5. The reference, for slices a to d: the trained weights on a small
   batch, the card's path (kernels, cuDNN) against the same weights and
   draws on the CPU (the plain versions, which the CPU tests hold against
   the JAX package).

Prints a JSON line of the kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failure raises: the exit
code is then non-zero and the last line is not printed. Exits non-zero when
CUDA is absent.
"""

from __future__ import annotations

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
# the K4 check's shape (ResNet-50 layer1), and the bench's repetitions
CONV_SHAPE = (128, 56, 56, 64, 64)
BENCH_REPS = 5
# K1/K2's further checks: ImageNet's 224 px, which the row-band kernels
# take, on a few images and at free-AT's batch
LARGE_SHAPES = ((8, 3, 224, 224), (256, 3, 224, 224))
# K1/K2 bfloat16: fast-AT's phase 1 (128 px, its slice's shape) first, then
# phases 2 and 3 (fast_*_phase2_ee.yml, fast_*_phase3_ee.yml), the evaluate
# config's batch at 288 px (fast_*_evaluate_ee.yml), a few images at 224 px,
# and 64 px
BF16_SHAPES = ((256, 3, 128, 128), (128, 3, 224, 224), (96, 3, 288, 288),
               (128, 3, 288, 288), (8, 3, 224, 224), (100, 3, 64, 64))
# K3a/K3b's further check: ImageNet's batch at 224 px, 180 MB a launch
CANNY_LARGE_SHAPES = ((128, 3, 224, 224),)


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
    mma = re.findall(r"HG?MMA[.\w]*", build.sass(libs["ee_fused"].path))
    bf16 = sorted({m for m in mma if m.endswith(".F32.BF16")})
    print(f"[build] ee_fused SASS: {len(mma)} tensor-core instructions "
          f"({', '.join(sorted(set(mma)))}); bf16 with float32 sums: {bf16}", flush=True)
    if not bf16:
        fail("the ee_fused library holds no bf16 tensor-core instruction "
             "(HMMA/HGMMA .F32.BF16)")


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


def _front_end_case(torch, shape):
    """K1 and K2 against their plain versions at `shape`, the square on:
    the errors, the times and the bounds. K2 is held against the plain
    adjoint and against autograd of the plain forward (given the plain
    forward's y, so both sides see the same clip mask)."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import (add_square_draws,
                                                       kernel_layout)

    dev = torch.device("cuda")
    x = _patched_input(torch, dev, shape)
    b, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = 0.062745098039216
    st, sqd = kernel_layout(add_square_draws((b, h, w, c), gen), eps)
    k = F.FusedConsts(r=8, eps=eps, w=1.0, alpha=0.0, high=76.0 / 255.0,
                      sigma=1.0, square=True)
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
    tag = "x".join(map(str, shape))
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
    ops = F.operators(h, w, 8, 1.0, dev)
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
    """K1 and K2 at the slice's shape, and at ImageNet's 224 px."""
    k1, k2 = _front_end_case(torch, (100, 3, 64, 64))
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by")
    for shape in LARGE_SHAPES:
        l1, l2 = _front_end_case(torch, shape)
        at = "at_" + "x".join(map(str, shape))
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
    return cfg, summary["checkpoint"]


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


def reference_phase(torch, cfg, checkpoint):
    """The trained model's eval-mode logits on a small batch: the card's
    path against the CPU's, on the same weights and square draws."""
    import numpy as np

    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.ops.square import add_square_draws

    state = torch.load(checkpoint, map_location="cpu")["state_dict"]
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        fail("checkpoint holds non-finite weights")
    num_classes = state["fc.weight"].shape[0]
    size = int(cfg["cize"])
    n = 8 if size <= 64 else 4
    tol = REF_TOL_BF16 if cfg.get("half") else REF_TOL
    x = torch.from_numpy(
        np.random.default_rng(1).random((n, size, size, 3)).astype(np.float32))
    draws = add_square_draws(x.shape, torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg["arch"], cfg, num_classes,
                            square_source=lambda shape, d=dev: tuple(
                                t.to(d) for t in draws))
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.no_grad():
            logits[dev] = model(x.to(dev)).cpu()
    scale = max(1.0, logits["cpu"].abs().max().item())
    err = (logits["cuda"] - logits["cpu"]).abs().max().item() / scale
    print(f"[reference] {cfg['arch']} {cfg['method_name']} gf={bool(cfg.get('gf'))} "
          f"half={bool(cfg.get('half'))}: logits {tuple(logits['cuda'].shape)} on "
          f"{n}x{size}x{size}x3, card vs CPU: max |err| / max(1, max |logit|) "
          f"{err:.3e} (limit {tol}), max |logit| {scale:.3f}", flush=True)
    if (logits["cuda"].shape != (n, num_classes)
            or not bool(torch.isfinite(logits["cuda"]).all()) or err > tol):
        fail("the card's logits disagree with the CPU reference")


def main():
    import torch

    name, smi = device_phase(torch)
    sys.path.insert(0, ROOT)
    build_phase()
    kernels = kernel_phase(torch)
    kernels += bf16_kernel_phase(torch)
    kernels += canny_kernel_phase(torch)
    kernels += conv_kernel_phase(torch)
    checkpoints = {}
    for gf in (False, True):
        cfg, checkpoints[gf] = slice_phase(torch, kernels, smi, gf)
        reference_phase(torch, cfg, checkpoints[gf])
    for tag, path, fwd, bwd, per_step in IMAGENET_SLICES:
        cfg, summary = imagenet_slice_phase(torch, kernels, smi, tag, path,
                                            fwd, bwd, per_step)
        reference_phase(torch, cfg, summary["checkpoint"])
    conv_path_phase(torch, kernels)
    phase2_ckpt = resume_phase(torch, kernels, smi, summary["checkpoint"])
    evaluate_phase(torch, kernels, smi, phase2_ckpt)
    eval_entry_phase(torch, kernels, smi, os.path.dirname(checkpoints[False]))
    for kern in kernels:
        kern["launches"] = sum(kern.get("launches_by_path", {}).values())
    if any(k["launches"] < 1 for k in kernels):
        fail("a kernel was not launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
