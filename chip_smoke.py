#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. The device: name, power limit, torch and CUDA versions; TF32 off (the
   slice is float32).
2. The build: nvcc compiles csrc/ee_fused.cu (kernels K1, K2) for sm_90a.
3. The kernels against their plain PyTorch versions at the slice's shape
   (100 x 64 x 64 x 3 float32, with constant patches and saturated pixels),
   errors against stated limits, and median times from CUDA events.
4. The slice: the port's training driver on the flagship config
   (resnet18_EE_square, Tiny-ImageNet 64 px, batch 100, 200 classes,
   PGD-10 adversarial training), synthetic data, 3 train steps and 3
   validation batches; the loss must be finite and the kernels' launch
   counts exact.
5. The reference: the trained weights on a small batch, the card's path
   (kernels, cuDNN) against the same weights and draws on the CPU (the plain
   versions, which the CPU tests hold against the JAX package).

Prints a JSON line of the kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Any failure raises: the exit
code is then non-zero and the last line is not printed. Exits non-zero when
CUDA is absent.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")
SLICE_ARGS = dict(data="synthetic", synthetic_size=600, epochs=1,
                  limit_batches=3, device="cuda")
# K1's outputs: the edge maps agree exactly (same rounding order), the HFS
# products sum 64 FP32 terms in another order than cuBLAS: ~1e-6 on values
# of order 1. K2: the same sums, scaled by at most 1/|g| < 1/high = 3.4.
FWD_TOL, BWD_TOL = 2e-5, 1e-4
# Logits of the small batch, card vs CPU, relative to the largest logit
# (eval-mode logits after 3 steps can reach the thousands): the edge maps
# agree bit for bit, the rest is two libraries' float32 convolutions.
REF_TOL = 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused
    t0 = time.time()
    lib = ee_fused._library()
    print(f"[build] {os.path.relpath(lib.path, ROOT)}: nvcc "
          f"{lib.build_seconds:.1f} s, load {time.time() - t0:.1f} s",
          flush=True)
    print(lib.log.strip(), flush=True)


def _median_ms(torch, fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_phase(torch):
    """K1 and K2 against their plain versions at the slice's shape."""
    import numpy as np

    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import (add_square_draws,
                                                       kernel_layout)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = rng.random((100, 3, 64, 64)).astype(np.float32)
    x[:, :, 8:24, 8:24] = 0.5          # constant patch: |g| = 0 inside
    x[::2, :, 40:56, 0:16] = 1.0       # saturated pixels
    x[1::2, :, 40:56, 40:60] = 0.0
    x = torch.from_numpy(x).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = 0.062745098039216
    st, sqd = kernel_layout(add_square_draws((100, 64, 64, 3), gen), eps)
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
    # autograd of the plain forward; K2 gets the plain forward's y so both
    # sides see the same clip mask
    xa = x.clone().requires_grad_(True)
    out_a, y_a = F.ee_fused_fwd_plain(xa, st, sqd, k)
    (g_auto,) = torch.autograd.grad((out_a * u).sum(), [xa])
    dx_ka = F.ee_fused_bwd(u, x, st, sqd, y_a.detach().contiguous(), k)
    torch.cuda.synchronize()
    auto_err = (dx_ka - g_auto).abs().max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (out_k, y_k, dx_k))
    print(f"[kernels] K1 vs plain: max |err| {fwd_err:.3e} (limit {FWD_TOL}); "
          f"K2 vs plain adjoint: {bwd_err:.3e}, vs autograd of plain forward: "
          f"{auto_err:.3e} (limit {BWD_TOL}); max |dx| "
          f"{dx_k.abs().max().item():.3f}", flush=True)
    if not finite or fwd_err > FWD_TOL or bwd_err > BWD_TOL or auto_err > BWD_TOL:
        fail("a kernel disagrees with its plain version")

    with torch.no_grad():
        t = {"K1": _median_ms(torch, lambda: F.ee_fused_fwd(x, st, sqd, k)),
             "K1_plain": _median_ms(torch, lambda: F.ee_fused_fwd_plain(x, st, sqd, k)),
             "K2": _median_ms(torch, lambda: F.ee_fused_bwd(u, x, st, sqd, y_k, k)),
             "K2_plain": _median_ms(
                 torch, lambda: F.ee_fused_bwd_plain(u, x, st, sqd, y_k, k))}
    print(f"[kernels] median ms at (100,3,64,64): K1 {t['K1']:.4f} vs plain "
          f"{t['K1_plain']:.4f}; K2 {t['K2']:.4f} vs plain {t['K2_plain']:.4f}",
          flush=True)
    src = "edge_enhancement_tpu_torch/csrc/ee_fused.cu"
    return [
        {"name": "ee_fused_fwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:409",
         "max_abs_err": fwd_err, "ms": t["K1"], "plain_ms": t["K1_plain"]},
        {"name": "ee_fused_bwd", "route": "cuda", "source": src,
         "replaces": "edge_enhancement_tpu/ops/pallas/ee_fused.py:427",
         "max_abs_err": max(bwd_err, auto_err), "ms": t["K2"],
         "plain_ms": t["K2_plain"]},
    ]


def slice_phase(torch, kernels, device_line):
    """The flagship config through the port's driver, at full width."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.train.driver import load_config, run

    cfg = load_config(CONFIG, dict(SLICE_ARGS, output=os.path.join(
        ROOT, "output", "chip_smoke")))
    F.reset_launches()
    summary = run(cfg)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    steps, evals = sum(summary["train_steps"]), sum(summary["eval_batches"])
    n_steps = int(cfg["num_steps_1"])
    want = {"ee_fused_fwd": steps * (n_steps + 1) + evals * (n_steps + 2),
            "ee_fused_bwd": (steps + evals) * n_steps}
    print(f"[slice] {steps} train steps, {evals} eval batches; launches "
          f"{launches}, expected {want}; loss {summary['loss']:.4f}", flush=True)
    if steps != 3 or evals != 3:
        fail(f"expected 3 train steps and 3 eval batches, got {steps}, {evals}")
    if launches != want:
        fail("kernel launch counts differ from the slice's forwards/backwards")
    if not math.isfinite(summary["loss"]):
        fail(f"loss {summary['loss']} is not finite")
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    secs = summary["step_seconds"]
    steady = sorted(secs[1:]) or secs
    ms = 1000.0 * steady[len(steady) // 2]
    bs = int(cfg["batch_size"])
    print(f"[slice] train step ms: {[round(1000 * s, 1) for s in secs]}; "
          f"median after the first {ms:.1f} ms/step = {bs / ms * 1000:.1f} img/s "
          f"(bs{bs}, f32, PGD-10) on {device_line}", flush=True)
    return cfg, summary["checkpoint"]


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
    x = torch.from_numpy(
        np.random.default_rng(1).random((8, 64, 64, 3)).astype(np.float32))
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
    print(f"[reference] logits {tuple(logits['cuda'].shape)} on 8x64x64x3, "
          f"card vs CPU: max |err| / max(1, max |logit|) {err:.3e} (limit "
          f"{REF_TOL}), max |logit| {scale:.3f}", flush=True)
    if (logits["cuda"].shape != (8, num_classes)
            or not bool(torch.isfinite(logits["cuda"]).all()) or err > REF_TOL):
        fail("the card's logits disagree with the CPU reference")


def main():
    import torch

    name, smi = device_phase(torch)
    sys.path.insert(0, ROOT)
    build_phase()
    kernels = kernel_phase(torch)
    cfg, checkpoint = slice_phase(torch, kernels, smi)
    reference_phase(torch, cfg, checkpoint)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
