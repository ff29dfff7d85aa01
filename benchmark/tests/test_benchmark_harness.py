"""The harness on the CPU at test sizes: the result line's keys, a
configuration, a traffic mix and a per-layer metric added as new files
alone, and the import guard."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark.lib import guard, spec
from benchmark.tests import tiny


def test_result_line_keys(tiny_root, capsys):
    result, err = tiny.run(tiny_root, tiny.TINY["tinyin_r18.pgd10_at_graph"], capsys)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    # peak_mem_gib reads the card's allocator: none on the CPU
    assert set(result["metrics"]) == {"setup_s", "train_img_per_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
    # the numbers compared are standard error's last lines
    assert err.strip().splitlines()[-len(result["checks"]):] == [
        f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in result["checks"].items()]


def test_traced_result_line(tiny_root, capsys):
    result, _ = tiny.run(tiny_root, tiny.TINY["tinyin_r18.pgd10_at_graph"], capsys, trace=1)
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the trace holds no device activity: only the host-clock share
    assert set(result["metrics"]) == {"step_mfu.train"}


def test_new_config_traffic_and_metric_as_files_alone(tiny_root, tmp_path, capsys):
    import shutil
    root = str(tmp_path / "added")
    shutil.copytree(tiny_root, root)
    bench = os.path.join(root, "benchmark")
    top = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    cfg = spec.load_json(os.path.join(bench, "configs", "tiny_tinyin_r18.json"))
    cfg.update(arch="resnet18_EE", cize=40, r=5)
    json.dump(cfg, open(os.path.join(bench, "configs", "added_r18.json"), "w"))
    traffic = spec.load_json(os.path.join(bench, "traffic", "tiny_pgd10_at_graph.json"))
    traffic.update(batch_size=6, steps_per_dispatch=3)
    json.dump(traffic, open(os.path.join(bench, "traffic", "added_mix.json"), "w"))
    shutil.copy(os.path.join(bench, "limits", "tiny_tinyin_r18.tiny_pgd10_at_graph.json"),
                os.path.join(bench, "limits", "added_r18.added_mix.json"))
    with open(os.path.join(bench, "metrics", "images_a_step.train.py"), "w") as f:
        f.write('"""Images a step of the window."""\n\n\n'
                'def read(ctx):\n    return ctx.images / ctx.steps\n')
    top["configs"].append({"name": "added_r18", "source": "test",
                           "file": "benchmark/configs/added_r18.json", "reduced": [],
                           "why": "test"})
    top["workloads"].append({"name": "added_r18.added_mix", "config": "added_r18",
                             "traffic": "added_mix", "chips": 1, "why": "test"})
    top["end_to_end"][1]["workloads"].append("added_r18.added_mix")   # train_img_per_s
    top["per_layer"].append({"name": "images_a_step.train", "unit": "img", "better": "higher",
                             "source": "host_clock", "layer": "train and eval steps",
                             "moves": "train_img_per_s", "workloads": ["added_r18.added_mix"]})
    json.dump(top, open(os.path.join(root, "BENCHMARK.json"), "w"))
    result, _ = tiny.run(root, "added_r18.added_mix", capsys, trace=1)
    assert result["correct"] is True
    assert result["metrics"]["images_a_step.train"]["value"] == 6.0
    result, _ = tiny.run(root, "added_r18.added_mix", capsys, trace=0)
    assert {"setup_s", "train_img_per_s", "peak_mem_gib"} - set(result["metrics"]) \
        == {"peak_mem_gib"}                        # no card: no peak memory


def test_guard_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "edge_enhancement_tpu",
              "edge_enhancement_tpu.ops", "edge_enhancement_tpu_torch",
              "edge_enhancement_tpu_torch.ops", "jaxtyping", "flaxen", "benchmark"]
    assert guard.forbidden_modules(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "edge_enhancement_tpu",
         "edge_enhancement_tpu.ops"])


def test_guard_exits_when_a_forbidden_module_is_loaded(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit) as e:
        guard.check("test")
    assert e.value.code == 3 and "jax" in capsys.readouterr().err


def test_a_run_loads_nothing_forbidden(tiny_root, capsys):
    tiny.run(tiny_root, tiny.TINY["tinyin_r18.pgd10_at_graph"], capsys)
    assert guard.forbidden_modules() == []


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tinyin_r18.pgd10_at_graph", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    if "device_count 0" not in r.stderr:
        pytest.skip("a card is present")
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_only_the_benchmark_s_files_is_no_result(tmp_path):
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tinyin_r18.pgd10_at_graph", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and not r.stdout.strip().startswith("{")
