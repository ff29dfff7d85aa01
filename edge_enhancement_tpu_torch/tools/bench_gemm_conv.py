"""Microbenchmark of the GEMM-conv kernel K4 (ops/cuda/gemm_conv.py) against
cuDNN's convolution on the 64-channel 3x3 layers of the JAX package's
tools/bench_gemm_conv.py, on one CUDA device:

    python -m edge_enhancement_tpu_torch.tools.bench_gemm_conv \\
        [--dtype bfloat16|float32] [--shape r50] [--reps 20]

Both sides get the same NHWC data: K4 through `conv_cgemm_nhwc` (weight
packing included), cuDNN through `F.conv2d` on channels-last views, with
TF32 off. Times are medians of CUDA-event timed launches. Prints one line
per shape: ms, GFLOP/s, and the largest difference between the two.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.gemm_conv import conv_cgemm_nhwc

# (label, B, H, W, C_in, C_out)
SHAPES = [
    ("tinyin_l1 bs512 16x16 64->64", 512, 16, 16, 64, 64),
    ("tinyin_stemout bs512 32x32 64->64", 512, 32, 32, 64, 64),
    ("r50_l1 bs128 56x56 64->64", 128, 56, 56, 64, 64),
]
WARMUP = 3


def median_ms(fn, reps: int) -> float:
    """Median of `reps` CUDA-event timed calls after WARMUP untimed ones."""
    for _ in range(WARMUP):
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
    return sorted(times)[len(times) // 2]


def cudnn_conv(x: torch.Tensor, w_hwio: torch.Tensor):
    """cuDNN's SAME 3x3 conv of NHWC x and HWIO w, as a closure: NHWC out."""
    xc = x.permute(0, 3, 1, 2)
    wc = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1)


def run(dtype: torch.dtype = torch.bfloat16, reps: int = 20,
        shape_filter: str | None = None) -> list[dict]:
    """Time K4 and cuDNN at each selected shape; `calls` counts K4's
    launches."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm_conv: needs a CUDA device")
    dev = torch.device("cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    results = []
    try:
        for label, b, h, w, ci, co in SHAPES:
            if shape_filter and shape_filter not in label:
                continue
            rng = np.random.default_rng(0)
            x = torch.from_numpy(rng.standard_normal((b, h, w, ci), np.float32))
            wk = torch.from_numpy(rng.standard_normal((3, 3, ci, co), np.float32) * 0.1)
            x, wk = x.to(dev, dtype), wk.to(dev, dtype)
            lib = cudnn_conv(x, wk)
            diff = (conv_cgemm_nhwc(x, wk).float() - lib().float()).abs().max().item()
            ms = median_ms(lambda: conv_cgemm_nhwc(x, wk), reps)
            lib_ms = median_ms(lib, reps)
            gflop = 2 * b * h * w * ci * co * 9 / 1e9
            results.append(dict(label=label, ms=ms, cudnn_ms=lib_ms, gflop=gflop,
                                max_diff=diff, calls=1 + WARMUP + reps))
            print(f"{label} {str(dtype).split('.')[-1]}: K4 {ms:.4f} ms "
                  f"({gflop / ms * 1e3:.0f} GFLOP/s) | cuDNN {lib_ms:.4f} ms "
                  f"({gflop / lib_ms * 1e3:.0f} GFLOP/s, {lib_ms / ms:.3f}x) "
                  f"| max diff {diff:.3e}", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return results


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--shape", default=None, help="substring filter on the shape label")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}, dtype {args.dtype}", flush=True)
    return run(getattr(torch, args.dtype), args.reps, args.shape)


if __name__ == "__main__":
    main()
