"""Microbenchmark of the GEMM-conv kernel K4 (ops/cuda/gemm_conv.py) against
cuDNN's convolution on the 64-channel 3x3 layers of the JAX package's
tools/bench_gemm_conv.py, on one CUDA device:

    python -m edge_enhancement_tpu_torch.tools.bench_gemm_conv \\
        [--dtype bfloat16|float32] [--shape r50] [--reps 20]

Both sides get the same NHWC data: K4 through `conv_cgemm_packed` on
weights packed once (the kernel alone) and through `conv_cgemm_nhwc`
(packing included), cuDNN through `F.conv2d` on channels-last views, with
TF32 off. Times are device times per call in a replayed CUDA graph
(utils/cuda_timing.device_ms), with the median eager call beside them.
Prints one line per shape: ms, TFLOP/s, and the largest difference between
the two.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.gemm_conv import conv_cgemm_nhwc, conv_cgemm_packed, pack_operands
from ..utils.cuda_timing import device_ms, median_ms

# (label, B, H, W, C_in, C_out)
SHAPES = [
    ("tinyin_l1 bs512 16x16 64->64", 512, 16, 16, 64, 64),
    ("tinyin_stemout bs512 32x32 64->64", 512, 32, 32, 64, 64),
    ("r50_l1 bs128 56x56 64->64", 128, 56, 56, 64, 64),
]
WARMUP = 3
GRAPH_CALLS = 20


def cudnn_conv(x: torch.Tensor, w_hwio: torch.Tensor):
    """cuDNN's SAME 3x3 conv of NHWC x and HWIO w, as a closure: NHWC out."""
    xc = x.permute(0, 3, 1, 2)
    wc = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xc, wc, padding=1).permute(0, 2, 3, 1)


def run(dtype: torch.dtype = torch.bfloat16, reps: int = 20,
        shape_filter: str | None = None) -> list[dict]:
    """Time K4 and cuDNN at each selected shape. `calls` counts K4's
    launches through its wrapper: the check against cuDNN, the eager
    calls, and two device timings (kernel alone, op) of 1 + GRAPH_CALLS
    each (graph replays launch no wrapper). `nbytes` counts x, the packed
    weights and out once each; `flop` the products' 2 M N K."""
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
            xk, wp = pack_operands(x, wk)
            lib = cudnn_conv(x, wk)
            out = conv_cgemm_nhwc(x, wk)
            diff = (out.float() - lib().float()).abs().max().item()
            with torch.no_grad():
                r = dict(ms=device_ms(lambda: conv_cgemm_packed(xk, wp), GRAPH_CALLS),
                         op_ms=device_ms(lambda: conv_cgemm_nhwc(x, wk), GRAPH_CALLS),
                         call_ms=median_ms(lambda: conv_cgemm_nhwc(x, wk), reps, WARMUP),
                         cudnn_ms=device_ms(lib, GRAPH_CALLS),
                         cudnn_call_ms=median_ms(lib, reps, WARMUP))
            flop = 2 * b * h * w * ci * co * 9
            nbytes = sum(t.numel() * t.element_size() for t in (x, wp, out))
            results.append(dict(label=label, **r, flop=flop, nbytes=nbytes,
                                max_diff=diff,
                                calls=1 + WARMUP + reps + 2 * (1 + GRAPH_CALLS)))
            print(f"{label} {str(dtype).split('.')[-1]}: device ms K4 {r['ms']:.4f} "
                  f"({flop / r['ms'] / 1e9:.1f} TFLOP/s), with packing "
                  f"{r['op_ms']:.4f} | cuDNN {r['cudnn_ms']:.4f} "
                  f"({flop / r['cudnn_ms'] / 1e9:.1f} TFLOP/s, K4 / cuDNN "
                  f"{r['ms'] / r['cudnn_ms']:.3f}) | eager call K4 {r['call_ms']:.4f}, "
                  f"cuDNN {r['cudnn_call_ms']:.4f} | max diff {diff:.3e}", flush=True)
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
