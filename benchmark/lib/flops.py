"""Every count that a share divides, from shapes: the convolutions' and the
head's operations of a ResNet forward, a step's operations by what the
step runs, the front-end kernels' (K1/K2) bytes and operations, and the
chip's peaks.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit
(dense rates), as chip_smoke.py's table has them: HBM 3.35 TB/s, float32
outside the tensor cores 67 TFLOP/s, bfloat16 989 TFLOP/s. A card set
below 700 W reaches less; the run prints its power limit beside them.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bf16": 989e12}
LAYOUTS = {18: ("basic", (2, 2, 2, 2)), 50: ("bottleneck", (3, 4, 6, 3))}


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def _conv(cin: int, cout: int, k: int, stride: int, size: int) -> tuple:
    """(operations of one image's convolution, its output size): two a
    multiply-add."""
    o = _out(size, k, stride)
    return 2 * cin * cout * k * k * o * o, o


def resnet_forward(depth: int, size: int, num_classes: int) -> dict:
    """One image's forward: {"convs": operations of every convolution,
    "stem": the first convolution's, "head": the final Dense's}."""
    kind, layers = LAYOUTS[depth]
    stem, s = _conv(3, 64, 7, 2, size)
    s = _out(s, 3, 2)                       # the 3x3 stride-2 max pool
    total, inplanes = stem, 64
    for g, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for i in range(n):
            stride = (1 if g == 0 else 2) if i == 0 else 1
            if kind == "basic":
                f1, s1 = _conv(inplanes, planes, 3, stride, s)
                f2, _ = _conv(planes, planes, 3, 1, s1)
                convs, out = f1 + f2, planes
            else:
                f1, _ = _conv(inplanes, planes, 1, 1, s)
                f2, s1 = _conv(planes, planes, 3, stride, s)
                f3, _ = _conv(planes, planes * 4, 1, 1, s1)
                convs, out = f1 + f2 + f3, planes * 4
            if stride != 1 or inplanes != out:
                convs += _conv(inplanes, out, 1, stride, s)[0]
            total += convs
            inplanes, s = out, s1
    return {"convs": total, "stem": stem, "head": 2 * inplanes * num_classes}


def step_flops(fwd: dict, step: dict) -> float:
    """One image's operations in a step, from what it runs:
    `attack_iterations` forwards each with its input gradient (the data
    gradient of every layer, the stem's too) and `train_passes` forwards
    each with the parameter gradient
    (the weight gradient of every layer and the data gradient of every
    layer but the stem)."""
    f = fwd["convs"] + fwd["head"]
    return (step.get("attack_iterations", 0) * 2 * f
            + step.get("train_passes", 0) * (3 * f - fwd["stem"]))


def ee_fused_bound(b: int, c: int, h: int, w: int, dtype: str, square: bool) -> dict:
    """The least seconds of one K1 (forward) and one K2 (backward) launch:
    the larger of their bytes at the HBM rate (each operand read once,
    each output written once) and their operations at the dtype's peak
    (the four HFS products of each (image, channel) plane, two of 2 H^2 W
    and two of 2 H W^2; the stencils add under 1%). K1 reads x, the
    operators, the Gaussian taps and, with the square, its stripes and
    moved square, and writes out and y; K2 reads the cotangent, x, y, the
    same operators and draws, and writes dx. bf16 planes are 2 bytes; K1
    reads its row operators (Ar, Ai) as float32 under bf16 too."""
    e = 4 if dtype == "float32" else 2
    plane = b * c * h * w * e
    draws = (b * c * w * e + c * h * w * e) if square else 0
    taps = 9 * 4
    rows, cols = 2 * h * h, 2 * w * w
    ops_k1 = rows * 4 + cols * e + taps
    ops_k2 = (rows + cols) * e + taps
    flops = b * c * (4 * h * h * w + 4 * h * w * w)
    t_ops = flops / PEAK_FLOPS[dtype]
    k1 = max((3 * plane + draws + ops_k1) / PEAK_BYTES, t_ops)
    k2 = max((4 * plane + draws + ops_k2) / PEAK_BYTES, t_ops)
    return {"fwd_s": k1, "bwd_s": k2,
            "fwd_by": "bytes" if k1 > t_ops else "operations",
            "bwd_by": "bytes" if k2 > t_ops else "operations"}
