"""A copy of the benchmark at test sizes, for the CPU tests: the checkout's
BENCHMARK.json and benchmark files in a temporary root, with one tiny cell
beside each real one (`tiny_<config>.tiny_<traffic>`: ResNet at 32 px,
10 classes, PGD-2, batches of 4), listed under the same metrics and
limits. Runs go through run.main with a CPU device, which skips the look
for a card; the kernels run as their plain versions there."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.lib import spec

REAL = {"tinyin_r18.pgd10_at_graph": ("tinyin_r18", "pgd10_at_graph")}
TINY = {real: f"tiny_{c}.tiny_{t}" for real, (c, t) in REAL.items()}


def make_root(tmp: str) -> str:
    """The temporary root; returns its path."""
    root = os.path.join(tmp, "checkout")
    bench = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic", "limits", "paths", "metrics"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), os.path.join(bench, sub))
    top = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for real, (cfg, traffic) in REAL.items():
        tiny = TINY[real]
        if not any(c["name"] == "tiny_" + cfg for c in top["configs"]):
            c = spec.load_json(os.path.join(bench, "configs", cfg + ".json"))
            c.update(cize=32, r=4, num_classes=10, num_steps_1=2)
            _dump(c, os.path.join(bench, "configs", f"tiny_{cfg}.json"))
            top["configs"].append({"name": "tiny_" + cfg, "source": "test",
                                   "file": f"benchmark/configs/tiny_{cfg}.json",
                                   "reduced": [], "why": "test"})
        t = spec.load_json(os.path.join(bench, "traffic", traffic + ".json"))
        t.update(batch_size=4, pool_batches=5)
        if "steps_per_dispatch" in t:
            t["steps_per_dispatch"] = 2
        _dump(t, os.path.join(bench, "traffic", f"tiny_{traffic}.json"))
        shutil.copy(os.path.join(bench, "limits", real + ".json"),
                    os.path.join(bench, "limits", tiny + ".json"))
        top["workloads"].append({"name": tiny, "config": "tiny_" + cfg,
                                 "traffic": "tiny_" + traffic, "chips": 1, "why": "test"})
        for m in top["end_to_end"] + top["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    _dump(top, os.path.join(root, "BENCHMARK.json"))
    return root


def _dump(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root: str, cell: str, capsys, seed: int = 12345, trace: int = 0,
        seconds: float = 0.5) -> tuple:
    """One run of `cell` on the CPU: (its last line of standard output,
    parsed; its standard error)."""
    import torch

    from benchmark import run as harness
    capsys.readouterr()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device=torch.device("cpu"), bench_root=root)
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1]), out.err
