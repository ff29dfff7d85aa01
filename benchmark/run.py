"""The benchmark of edge_enhancement_tpu_torch, the PyTorch and CUDA port:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. One process, one cell: the cell's entry is built from its
configuration with weights and batches made from the seed, warmed up on
the cell's own shapes (set-up, `setup_s`, from the process's start to
the window's), driven for `--seconds` (the measured window), then, with
`--trace 1`, traced over a few more whole steps for the per-layer
metrics. After that the program's state is freed and the plain reference
(benchmark/reference/) recomputes what the timed path produced; the
numbers compared, each beside its limit, decide `correct`. The last line
of standard output is one JSON object; the lines before it, and the last
lines of standard error, name the card and every number compared.

Exits 2 without a result when no card (or too few) is present, and 3
when a module of the JAX package, jax, jaxlib or flax is loaded at the
start or once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its CUDA libraries into edge_enhancement_tpu_torch/_build/)
CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")

from benchmark.lib import guard  # noqa: E402


def card() -> dict:
    """The card's name, the cards present, and its power limit."""
    import torch
    info = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"not read ({e})"
    info["power_limit"] = out
    return info


def window(adapter, seconds: float, sync) -> dict:
    """Drive whole units until `seconds` have passed; the window ends with
    the read that ends its last unit."""
    images, steps, failed, step_s = 0, 0, 0, []
    t0 = time.perf_counter()
    while True:
        u = adapter.unit()
        images += u.images
        steps += len(u.step_seconds)
        step_s += u.step_seconds
        failed += 0 if u.finite else len(u.step_seconds)
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return {"images": images, "steps": steps, "failed": failed, "step_seconds": step_s,
            "window_s": time.perf_counter() - t0, "start": t0}


def main(argv=None, device=None, bench_root: str = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    guard.check("at start")

    import torch

    from benchmark.lib import spec
    from benchmark.lib import trace as tracing
    cell = spec.find_cell(args.workload, root=bench_root,
                          bench_dir=os.path.join(bench_root, "benchmark"))
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"torch.cuda.is_available() {torch.cuda.is_available()}, "
                  f"device_count {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        info = card()
    else:
        info = {"name": str(device), "count": 1, "power_limit": "none"}
    print(f"card: {info['name']}, {info['count']} present, power.limit {info['power_limit']}",
          flush=True)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    from benchmark.lib import port
    print(f"precision: {port.pin_precision(cell.config)}", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t_imports = time.perf_counter()
    adapter = spec.path_adapter(cell.traffic["path"],
                                os.path.join(bench_root, "benchmark")).Path(
        cell, args.seed, device)
    t_pool = time.perf_counter()
    adapter.setup()
    sync()
    t_steps = time.perf_counter()
    print(f"set-up: start to the batches {t_imports - T_START:.3f} s, batch pool "
          f"{t_pool - t_imports:.3f} s, build and first steps {t_steps - t_pool:.3f} s"
          + (f" (capture {adapter.capture_seconds:.3f} s)"
             if getattr(adapter, "capture_seconds", None) else ""), flush=True)
    w = window(adapter, args.seconds, sync)
    setup_s = w["start"] - T_START
    print(f"window: {w['steps']} steps, {w['images']} images in {w['window_s']:.4f} s; "
          f"set-up {setup_s:.4f} s", flush=True)

    ctx = types.SimpleNamespace(
        kind=adapter.kind, setup_s=setup_s, trace=None, **w,
        flops_per_image=adapter.flops_per_image(), precision=adapter.precision,
        ee_bound=adapter.ee_bound())
    if args.trace:
        span = []
        ctx.trace = tracing.profile(
            lambda: span.extend(adapter.unit() for _ in range(adapter.trace_units)), device)
        ctx.span_steps = sum(len(u.step_seconds) for u in span)
    ctx.peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0

    names = [m["name"] for m in (cell.per_layer if args.trace else cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    for name in names:
        value = spec.metric_reader(name, os.path.join(bench_root, "benchmark"))(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}

    adapter.release()
    t_ref = time.perf_counter()
    checks = adapter.judge(adapter.program_record())
    print(f"reference: {time.perf_counter() - t_ref:.2f} s", flush=True)
    guard.check("once the window has closed")

    result = {"correct": all(c.ok for c in checks), "attempted": w["steps"],
              "failed": w["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type, "kind": info["name"],
                         "count": cell.chips, "memory_peak_bytes": int(ctx.peak_bytes)}}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.span_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["power_limit"] = info["power_limit"]
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


def _number(v: float):
    """A compared number for the JSON line: itself, or its name ("nan",
    "inf") where it is not finite."""
    return v if math.isfinite(v) else repr(v)


if __name__ == "__main__":
    sys.exit(main())
