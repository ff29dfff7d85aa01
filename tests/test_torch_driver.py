"""The port's training driver on the CPU at a tiny size, its refusals, the
jax-free import rule of the port, and chip_smoke.py's refusal without CUDA."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_driver_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "edge_enhancement_tpu_torch.train", "--config", CONFIG,
         "--data", "synthetic", "--synthetic-size", "8", "--batch-size", "4",
         "--epochs", "1", "--limit-batches", "1", "--device", "cpu",
         "--output", str(tmp_path)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_dir = tmp_path / "tiny_imagenet" / "EE_BPDA3_AT_square" / "resnet18_EE_square-bs4-lr0.1-seed1"
    log = (run_dir / "log" / "log.txt").read_text()
    for line in ("Epoch: [0][0/2]", " * Clean Prec@1", " * Adv Prec@1",
                 "=> done. best robust-eval Prec@1"):
        assert line in log, log
    ckpt = torch.load(run_dir / "ckpt" / "checkpoint.pth.tar")
    assert ckpt["epoch"] == 1 and ckpt["arch"] == "resnet18_EE_square"
    assert "layer4.1.bn2.running_var" in ckpt["state_dict"]
    assert ckpt["optimizer"]["param_groups"][0]["momentum"] == 0.9
    assert (run_dir / "ckpt" / "model_best.pth.tar").exists() or ckpt["best_prec1"] == 0.0


def test_driver_runs_gf_on_cpu(tmp_path):
    """The flagship config with the edge map smoothed (`gf: true`, the K3
    path) through the driver's run()."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, dict(data="synthetic", synthetic_size=8,
                                   batch_size=4, epochs=1, limit_batches=1,
                                   device="cpu", gf=True, output=str(tmp_path)))
    summary = run(cfg)
    assert summary["train_steps"] == [1] and summary["eval_batches"] == [1]
    assert np.isfinite(summary["loss"])
    state = torch.load(summary["checkpoint"])["state_dict"]
    assert all(bool(torch.isfinite(v).all()) for v in state.values())


@pytest.mark.parametrize("override,error", [
    ({"device": "cuda"}, RuntimeError),
    ({"attack_method": "FGSM"}, NotImplementedError),
    ({"method_name": "TRADES"}, NotImplementedError),
    ({"awp_gamma": 0.01}, NotImplementedError),
    ({"evaluate": True}, NotImplementedError),
    ({"resume": "ckpt"}, NotImplementedError),
])
def test_driver_refuses(override, error):
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    if override.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("CUDA is present")
    cfg = load_config(CONFIG, {**dict(data="synthetic", synthetic_size=8,
                                      batch_size=4, device="cpu"), **override})
    with pytest.raises(error):
        run(cfg)


IMAGENET = os.path.join(REPO, "edge_enhancement_tpu", "configs")


@pytest.mark.parametrize("config,method,dtype", [
    ("free_imagenet/free_at_ee.yml", "free_AT", torch.float32),
    ("fast_imagenet/fast_2px_phase1_ee.yml", "fast_AT", torch.bfloat16)])
def test_driver_runs_free_and_fast_at_on_cpu(tmp_path, config, method, dtype):
    """The ImageNet recipes (resnet50_EE, 1000 classes) through run() at a
    tiny size: one train step, one validation batch, the log, the
    checkpoint and the replay noise beside it; --resume still raises."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    over = dict(data="synthetic", synthetic_size=4, batch_size=2, cize=32,
                epochs=1, limit_batches=1, num_steps_1=1, device="cpu",
                output=str(tmp_path))
    cfg = load_config(os.path.join(IMAGENET, config), over)
    summary = run(cfg)
    assert summary["train_steps"] == [1] and summary["eval_batches"] == [1]
    assert np.isfinite(summary["loss"])
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    for line in (f"method {method}", "Epoch: [0][0/2]", " * Adv Prec@1",
                 "=> done. best robust-eval Prec@1"):
        assert line in log, log
    ckpt = torch.load(summary["checkpoint"])
    assert ckpt["epoch"] == 1 and ckpt["arch"] == "resnet50_EE"
    assert ckpt["state_dict"]["layer4.2.conv3.weight"].dtype == torch.float32
    assert len(ckpt["optimizer"]["state"]) == len(
        [k for k in ckpt["state_dict"] if not k.endswith(("running_mean", "running_var"))])
    noise = torch.load(summary["noise"])
    assert os.path.dirname(summary["noise"]) == os.path.dirname(summary["checkpoint"])
    clip = float(cfg["clip_eps"]) / 255
    assert noise.shape == (2, 32, 32, 3) and 0 < noise.abs().max() <= clip + 1e-7
    from edge_enhancement_tpu_torch.models.registry import build_model
    assert build_model(cfg["arch"], cfg, 1000).dtype == (None if dtype == torch.float32
                                                          else dtype)
    with pytest.raises(NotImplementedError):
        run(load_config(os.path.join(IMAGENET, config), {**over, "resume": "ckpt"}))


def test_port_imports_no_jax():
    """Every module of the port, its entry points and chip_smoke.py import
    with jax, jaxlib, flax and the JAX package blocked."""
    code = (
        "import pkgutil, sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'edge_enhancement_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import edge_enhancement_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import edge_enhancement_tpu_torch.train.driver\n"
        "import edge_enhancement_tpu_torch.tools.bench_gemm_conv\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if sys.modules[k] is not None and\n"
        "             k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'edge_enhancement_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith(p.__name__)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 25


def test_port_sources_name_no_jax_package():
    """A scan of the port's sources and chip_smoke.py: no import of the JAX
    package, jax or flax in any form."""
    pattern = re.compile(r"^\s*(from|import)\s+(edge_enhancement_tpu|jax|jaxlib|flax)\b",
                         re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "edge_enhancement_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    hits = []
    for path in files:
        with open(path) as f:
            hits += [(path, m.group(0)) for m in pattern.finditer(f.read())]
    assert not hits, hits


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
