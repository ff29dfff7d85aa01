"""What a run measures, found by name: the cell in BENCHMARK.json, its
configuration (the file the configuration's entry names), its traffic mix
(traffic/<name>.json), its entry's adapter (paths/<kind>.py) and a reader
for each of its metrics (metrics/<metric name>.py). A later cell, mix,
adapter or metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's contents
    end_to_end: list      # the BENCHMARK.json entries of its end-to-end metrics
    per_layer: list       # and of its per-layer metrics
    bench_dir: str        # the benchmark's folder (limits/<cell>.json)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    """A metric with `workloads` applies to the cells listed; an end-to-end
    metric without it to every cell; a per-layer one without it to every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json with everything it names."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(w["chips"]), load_json(os.path.join(root, conf["file"])),
                load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
                e2e, per_layer, bench_dir)


def load_file(path: str, tag: str):
    """A module from a file whose name may hold dots (metrics/x.train.py)."""
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_adapter(kind: str, bench_dir: str = BENCH_DIR):
    """paths/<kind>.py: the adapter that builds and drives one kind of entry."""
    return load_file(os.path.join(bench_dir, "paths", kind + ".py"), f"benchmark_path_{kind}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """metrics/<name>.py's `read(ctx)`: the metric's value, or None where the
    run has nothing for it to read."""
    tag = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    return load_file(os.path.join(bench_dir, "metrics", name + ".py"), tag).read
