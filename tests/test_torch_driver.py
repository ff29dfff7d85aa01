"""The port's training driver on the CPU at a tiny size, its refusals, the
jax-free import rule of the port, and chip_smoke.py's refusal without CUDA."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_checkpoints import drop_checkpoints, drop_written_checkpoints  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")


def _env():
    """The child's environment: the repo on its path, CPU torch on one
    thread (as tests/torch_threads.py holds this process)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
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


def test_profile_and_platform_pass_the_port_check():
    """--profile, --platform and --steps-per-dispatch are ported (the driver
    traces with torch.profiler, picks the device, and chains K train steps
    a dispatch): the port's check passes each."""
    from edge_enhancement_tpu_torch.train.driver import _check_ported
    for key, value in (("profile", "trace"), ("platform", "cpu"), ("platform", "gpu"),
                       ("steps_per_dispatch", 4)):
        _check_ported({key: value})
    _check_ported({"profile": "trace", "steps_per_dispatch": 2})


def test_driver_runs_the_full_canny_under_bf16(tmp_path):
    """ee_at_training.yml's full Canny under the bf16 policy (`half: true`,
    which the driver refused before the policy reached that front-end):
    one train step and one validation batch through run(), the model's
    compute dtype bfloat16, a finite loss and finite weights."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(CONFIG, dict(data="synthetic", synthetic_size=8, batch_size=4,
                                   epochs=1, limit_batches=1, device="cpu", cize=32,
                                   num_steps_1=1, type_canny="CannyFilter", half=True,
                                   output=str(tmp_path)))
    summary = run(cfg)
    assert summary["train_steps"] == [1] and summary["eval_batches"] == [1]
    assert np.isfinite(summary["loss"])
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert "bf16 policy" in log.splitlines()[0]
    state = torch.load(summary["checkpoint"])["state_dict"]
    assert all(bool(torch.isfinite(v).all()) for v in state.values())


@pytest.mark.parametrize("override,error", [
    ({"device": "cuda"}, RuntimeError),
    # AWP and the multi-step dispatch run now (objectives/awp.py,
    # train/graphs.py): a chained run is refused only for what else it asks
    ({"steps_per_dispatch": 2, "platform": "tpu"}, NotImplementedError),
    ({"attack_method": "AA"}, NotImplementedError),
])
def test_driver_refuses(override, error):
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    if override.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("CUDA is present")
    cfg = load_config(CONFIG, {**dict(data="synthetic", synthetic_size=8,
                                      batch_size=4, device="cpu"), **override})
    with pytest.raises(error) as refused:
        run(cfg)
    assert "steps_per_dispatch" not in str(refused.value)


@pytest.mark.parametrize("device_type,backend,world,form", [
    ("cuda", "nccl", 2, "graph"), ("cuda", "gloo", 2, "loop"),
    ("cuda", "nccl", 8, "graph"), ("cuda", "gloo", 8, "loop"),
    ("cuda", None, 1, "graph"), ("cuda", "gloo", 1, "graph"), ("cuda", "nccl", 1, "graph"),
    ("cpu", "gloo", 2, "loop"), ("cpu", "gloo", 1, "loop"), ("cpu", None, 1, "loop")])
def test_chained_dispatch_refuses_cuda_under_several_ranks(device_type, backend, world,
                                                           form):
    """The chained step's form for each (device type, backend, world): on
    CUDA the graph with one rank (no collective to capture) or under NCCL
    (its all-reduces captured with the step); a loop on the CPU under any
    group, and on CUDA under gloo, whose collectives a capture cannot hold
    (no longer a refusal: the driver's log line names the loop and why)."""
    from edge_enhancement_tpu_torch.train.graphs import chained_form, describe_form
    assert chained_form(device_type, backend, world) == form
    words = describe_form(device_type, backend, world)
    if form == "graph":
        assert words == "CUDA graph"
    elif device_type == "cuda":
        assert words == "loop: gloo's collectives cannot be captured in a CUDA graph"
    else:
        assert words == "loop"


def _run_cpu(tmp_path, config, tag, **over):
    """run() of `config` on the CPU at a tiny size into tmp_path/tag:
    (summary, the checkpoint's state_dict and momentum, the log's lines)."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(config, {**dict(data="synthetic", device="cpu", epochs=1,
                                      output=str(tmp_path / tag)), **over})
    summary = run(cfg)
    ckpt = torch.load(summary["checkpoint"])
    mom = [v["momentum_buffer"] for _, v in sorted(ckpt["optimizer"]["state"].items())]
    with open(os.path.join(summary["out_dir"], "log", "log.txt")) as f:
        return summary, ckpt["state_dict"], mom, f.read().splitlines()


def _same_training(a, b):
    (sa, sda, ma, _), (sb, sdb, mb, _) = a, b
    assert sa["train_steps"] == sb["train_steps"] and sa["loss"] == sb["loss"]
    assert sorted(sda) == sorted(sdb)
    assert all(torch.equal(sda[k], sdb[k]) for k in sda)
    assert len(ma) == len(mb) and all(torch.equal(u, v) for u, v in zip(ma, mb))


def test_driver_chains_steps_on_cpu(tmp_path):
    """run() with steps_per_dispatch 2 and 3 batches (chains of 2 and 1)
    trains as steps_per_dispatch 1 does, bit for bit: the same last loss,
    step count, checkpoint and momentum; its first log line says the loop
    form, and its step times are 3 (each dispatch's split over its
    steps)."""
    over = dict(synthetic_size=12, batch_size=4, limit_batches=3, cize=32,
                num_steps_1=1, print_freq=1)
    single = _run_cpu(tmp_path, CONFIG, "single", **over)
    chained = _run_cpu(tmp_path, CONFIG, "chained", steps_per_dispatch=2, **over)
    _same_training(single, chained)
    assert chained[0]["train_steps"] == [3] and len(chained[0]["step_seconds"]) == 3
    assert chained[0]["capture_seconds"] is None
    assert "steps_per_dispatch 2 (loop), backend none, world 1" in chained[3][0]
    assert "steps_per_dispatch" not in single[3][0]
    # a dispatch's log line at its last batch, where a batch falls on print_freq
    assert [ln.split("\t")[0] for ln in chained[3] if ln.startswith("Epoch:")] == [
        "Epoch: [0][1/3]", "Epoch: [0][2/3]"]


@pytest.mark.parametrize("config,over", [
    ("awp_cifar100/at_awp.yml", dict(synthetic_size=8, batch_size=4, limit_batches=2,
                                     num_steps_1=1)),
    ("free_imagenet/free_at_ee.yml", dict(synthetic_size=4, batch_size=2, cize=32,
                                          limit_batches=2, num_steps_1=1))])
def test_single_step_paths_ignore_steps_per_dispatch(tmp_path, config, over):
    """AWP (its learning rate set every minibatch) and free-AT keep single
    steps and ignore steps_per_dispatch, as the JAX driver does: with 2
    they train as with 1, bit for bit, and the log names no chained
    dispatch."""
    path = os.path.join(IMAGENET, config)
    single = _run_cpu(tmp_path, path, "single", **over)
    chained = _run_cpu(tmp_path, path, "k2", steps_per_dispatch=2, **over)
    _same_training(single, chained)
    assert "steps_per_dispatch" not in chained[3][0]


IMAGENET = os.path.join(REPO, "edge_enhancement_tpu", "configs")


@pytest.mark.parametrize("config,method,dtype", [
    ("free_imagenet/free_at_ee.yml", "free_AT", torch.float32),
    ("fast_imagenet/fast_2px_phase1_ee.yml", "fast_AT", torch.bfloat16)])
def test_driver_runs_free_and_fast_at_on_cpu(tmp_path, config, method, dtype):
    """The ImageNet recipes (resnet50_EE, 1000 classes) through run() at a
    tiny size: one train step, one validation batch, the log, the
    checkpoint and the replay noise beside it; then --resume of that
    checkpoint runs the next epoch on the restored replay noise."""
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
    # free-AT's epochs count replays: ceil(5 / 4) = 2 takes one more epoch
    more = dict(over, epochs=5 if method == "free_AT" else 2,
                resume=os.path.dirname(summary["checkpoint"]),
                output=str(tmp_path / "resumed"))
    resumed = run(load_config(os.path.join(IMAGENET, config), more))
    assert resumed["start_epoch"] == 1 and resumed["train_steps"] == [1]
    assert torch.load(resumed["checkpoint"])["epoch"] == 2
    log = open(os.path.join(resumed["out_dir"], "log", "log.txt")).read()
    for line in ("=> resumed from", "=> restored free-AT replay noise shard "
                 f"(2, 32, 32, 3) (max |n| = {noise.abs().max().item():.4f})",
                 "Epoch: [1][0/2]"):
        assert line in log, log
    assert "Epoch: [0]" not in log


SMALL = dict(data="synthetic", synthetic_size=8, batch_size=4, limit_batches=1,
             device="cpu", num_steps_1=1, num_steps_2=1, num_steps_3=1)


@pytest.fixture(scope="module")
def flagship_ckpt(tmp_path_factory):
    """One epoch of the flagship config at a tiny size; its ckpt dir,
    deleted once the module's tests are done."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    out = tmp_path_factory.mktemp("flagship")
    summary = run(load_config(CONFIG, dict(SMALL, epochs=1, output=str(out))))
    yield os.path.dirname(summary["checkpoint"])
    drop_checkpoints(out)


def _small_config(tmp_path, drop=(), **over):
    """The flagship YAML with SMALL's tiers, less the keys in `drop`."""
    import yaml
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.update({k: v for k, v in SMALL.items() if k.startswith("num_steps")}, **over)
    for k in drop:
        del cfg[k]
    path = tmp_path / "small.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_driver_resume_continues_at_the_checkpoint_epoch(tmp_path, flagship_ckpt):
    """--resume: the run starts at the checkpoint's epoch, with its weights,
    momentum and best_prec1 (set here out of reach, so the resumed run
    keeps it and writes no best copy)."""
    from edge_enhancement_tpu_torch.train import checkpoint as ckpt
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    payload = ckpt.load_checkpoint(flagship_ckpt)
    payload["best_prec1"] = 150.0
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save(payload, src / "checkpoint.pth.tar")
    summary = run(load_config(CONFIG, dict(SMALL, epochs=2, resume=str(src),
                                           output=str(tmp_path / "out"))))
    assert summary["start_epoch"] == 1 and summary["train_steps"] == [1]
    assert summary["best_prec1"] == 150.0
    saved = torch.load(summary["checkpoint"])
    assert saved["epoch"] == 2 and saved["best_prec1"] == 150.0
    assert not os.path.exists(os.path.join(os.path.dirname(summary["checkpoint"]),
                                           "model_best.pth.tar"))
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert f"=> resumed from {src} (epoch 1)" in log and "Epoch: [1][0/2]" in log
    assert "Epoch: [0]" not in log and "best robust-eval Prec@1 150.000" in log


def test_free_at_noise_resets_on_a_shape_mismatch(tmp_path):
    """The replay noise of another batch size is not restored: JAX's
    warning, and the run goes on from zero noise."""
    from edge_enhancement_tpu_torch.train import checkpoint as ckpt
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    config = os.path.join(IMAGENET, "free_imagenet", "free_at_ee.yml")
    src = tmp_path / "ckpt"
    ckpt.save_noise(str(src), torch.full((3, 32, 32, 3), 0.01))
    summary = run(load_config(config, dict(
        data="synthetic", synthetic_size=4, batch_size=2, cize=32, epochs=1,
        limit_batches=1, num_steps_1=1, device="cpu", resume=str(src),
        output=str(tmp_path / "out"))))
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert (f"WARNING: free-AT noise in {src} has shard (3, 32, 32, 3), expected "
            "(2, 32, 32, 3) (process count / batch size changed?); replay noise "
            "resets to zeros") in log
    assert "restored free-AT replay noise" not in log
    # no checkpoint to resume: the run starts at the config's epoch
    assert "=> no checkpoint at" in log and summary["train_steps"] == [1]
    assert torch.load(summary["noise"]).shape == (2, 32, 32, 3)


def test_driver_evaluate_runs_each_declared_tier(tmp_path, flagship_ckpt):
    """--evaluate: one battery per num_steps_k/step_size_k pair (tier 3
    without its step size is left out), on the resumed weights, and no
    checkpoint written."""
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    config = _small_config(tmp_path, drop=("step_size_3",))
    summary = run(load_config(config, dict(SMALL, evaluate=True, resume=flagship_ckpt,
                                           num_steps_2=2, output=str(tmp_path / "out"))))
    assert summary["eval_batches"] == [1, 1] and summary["train_steps"] == []
    assert [t["num_steps"] for t in summary["tiers"]] == [1, 2]
    assert not os.path.exists(os.path.join(summary["out_dir"], "ckpt"))
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert log.count("=> evaluate num_steps:") == 2 and log.count(" * Adv Prec@1") == 2
    assert "=> evaluate num_steps:2, step_size:0.003921568627451" in log
    assert "ms per attack iteration" in log and "Epoch:" not in log


def test_driver_pretrained_warm_start_and_resume_wins(tmp_path, flagship_ckpt):
    """--pretrained loads a torchvision-format file (the head of another
    class count skipped and logged); with --resume as well, the
    checkpoint's weights are the ones evaluated."""
    from edge_enhancement_tpu_torch.models.registry import build_model
    from edge_enhancement_tpu_torch.train import driver
    from edge_enhancement_tpu_torch.utils.config import load_config
    tv = build_model("resnet18", {}, 1000, generator=torch.Generator().manual_seed(7))
    pth = tmp_path / "tv.pth"
    torch.save(tv.state_dict(), pth)
    seen = []
    real = driver.run_evaluate
    over = dict(SMALL, evaluate=True, pretrained=str(pth), output=str(tmp_path / "out"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(driver, "run_evaluate",
                   lambda cfg, ops, state, *a: seen.append(state.model.state_dict())
                   or real(cfg, ops, state, *a))
        summary = driver.run(load_config(CONFIG, over))
        driver.run(load_config(CONFIG, dict(over, resume=flagship_ckpt)))
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    n = len(tv.state_dict()) - 2
    assert (f"=> warm-started {n} tensors from torch weights {pth}\n"
            "   skipped fc.weight (torch (1000, 512) vs ours (200, 512))") in log
    assert torch.equal(seen[0]["layer2.0.conv1.weight"], tv.state_dict()["layer2.0.conv1.weight"])
    want = torch.load(os.path.join(flagship_ckpt, "checkpoint.pth.tar"))["state_dict"]
    assert all(torch.equal(seen[1][k], v) for k, v in want.items())


def test_eval_entry_point_prints_the_jax_tags(tmp_path, flagship_ckpt):
    config = _small_config(tmp_path, cw_iters=1)
    proc = subprocess.run(
        [sys.executable, "-m", "edge_enhancement_tpu_torch.eval", "--config", config,
         "--data", "synthetic", "--synthetic-size", "8", "--batch-size", "4",
         "--limit-batches", "1", "--resume", flagship_ckpt,
         "--suite", "pgd,fgsm,cw", "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "=> loaded checkpoint (epoch 1)" in lines
    tags = [ln.split(":")[0] for ln in lines if "clean Prec@1" in ln and "adv Prec@1" in ln]
    assert tags == ["PGD-1", "PGD-1", "PGD-1", "FGSM", "CW-Linf-1"], proc.stdout


@pytest.mark.parametrize("suite,error", [("aa", FileNotFoundError),
                                         ("pgd", FileNotFoundError)])
def test_eval_refuses(tmp_path, suite, error):
    """A --resume with no checkpoint under it raises before any battery
    runs, the PGD battery's and the AutoAttack suite's alike, as the JAX
    eval.py does."""
    from edge_enhancement_tpu_torch import eval as port_eval
    from edge_enhancement_tpu_torch.utils.config import load_config
    over = dict(SMALL, resume=str(tmp_path / "absent"), suite=suite)
    with pytest.raises(error, match="absent"):
        port_eval.run(load_config(CONFIG, over))


def test_port_imports_no_jax():
    """Every module of the port (parallel/ and utils/analysis.py named),
    its entry points and chip_smoke.py import with jax, jaxlib, flax and
    the JAX package blocked."""
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
        "import edge_enhancement_tpu_torch.parallel.mesh\n"
        "import edge_enhancement_tpu_torch.utils.analysis\n"
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
    package, jax or flax in any form (parallel/ and utils/analysis.py
    among them)."""
    pattern = re.compile(r"^\s*(from|import)\s+(edge_enhancement_tpu|jax|jaxlib|flax)\b",
                         re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "edge_enhancement_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for must in (os.path.join("parallel", "mesh.py"), os.path.join("parallel", "__init__.py"),
                 os.path.join("utils", "analysis.py")):
        assert any(f.endswith(os.path.join("edge_enhancement_tpu_torch", must))
                   for f in files), must
    hits = []
    for path in files:
        with open(path) as f:
            hits += [(path, m.group(0)) for m in pattern.finditer(f.read())]
    assert not hits, hits


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
