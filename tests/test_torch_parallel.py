"""The port's data parallelism (edge_enhancement_tpu_torch/parallel/mesh.py)
on the CPU: real 2-rank gloo groups, each rank a subprocess
(tests/torch_parallel_worker.py, or torchrun for the driver) on one
OpenMP thread, joined through a file:// store, each run under a timeout
that kills the group.

(a) global-batch BatchNorm against one module on the whole batch;
(b) a train step of the flagship recipe on 2 ranks against the port's
    single-process step on the global batch, both in float64;
(c) the same step in float32 against the JAX package's own step sharded
    over a 2-device mesh, on the same replayed global draws;
(d) the loaders' process sharding against the JAX package's;
(e) free-AT's replay noise, one file a rank;
(f) torchrun driving the port's trainer; with --steps-per-dispatch, the
    chains (the loop form under gloo) against single steps;
(g) --profile and --platform."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from torch_checkpoints import drop_written_checkpoints  # noqa: F401
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.data import datasets as jds
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.objectives import methods as jmethods
from edge_enhancement_tpu.parallel import mesh as meshlib
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.data import datasets as tds
from edge_enhancement_tpu_torch.models.batchnorm import BatchNorm2d
from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, build_train_step
from edge_enhancement_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")
WORLD = 2


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs, logs, timeout: float) -> None:
    """Every process exits 0 within `timeout` seconds, or all are killed
    (a rank that fails leaves the others waiting in a collective) and the
    test fails with their output."""
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        out = "\n".join(f"--- {lg}:\n{open(lg).read()[-3000:]}" for lg in logs)
        pytest.fail(f"exit codes {[p.returncode for p in procs]}\n{out}")


def run_ranks(tmp_path, task: str, inputs: dict, timeout: float = 240,
              world: int = WORLD, n_model: int = 1) -> list:
    """`task` of the worker on `world` ranks of a mesh with a `model` axis
    of `n_model`; their results. The task's directory (inputs.pt,
    rank{r}.pt, the logs: up to 345 MB for the step tests) goes once the
    results are loaded."""
    d = tmp_path / task
    d.mkdir()
    torch.save(inputs, d / "inputs.pt")
    logs = [str(d / f"log{r}.txt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, str(r), str(world), f"file://{d / 'store'}", str(d),
         str(n_model)],
        cwd=REPO, env=_env(), stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
        for r in range(world)]
    _wait(procs, logs, timeout)
    results = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(d)
    return results


def _assert_bitwise_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_replicas_equal(results) -> None:
    for r in results[1:]:
        _assert_bitwise_equal(results[0]["state"], r["state"])
        assert all(torch.equal(u, v) for u, v in zip(results[0]["momentum"], r["momentum"]))
        assert results[0]["metrics"] == r["metrics"]


# ---- (a) ---------------------------------------------------------------------

def test_sync_batchnorm_equals_one_module_on_the_whole_batch(tmp_path):
    """Forward, input and parameter gradients and running statistics of
    2 ranks x 3 images against one module on the 6, float64, to 1e-12."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (6, 5, 4, 3)))
    g = torch.from_numpy(rng.normal(size=x.shape))
    bn = BatchNorm2d(5).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.normal(1, 0.5, 5)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.5, 5)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 1, 5)))
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    ranks = run_ranks(tmp_path, "syncbn", {"x": x, "g": g, "state": state})
    xx = x.clone().requires_grad_(True)
    out = bn(xx)
    (out * g).sum().backward()
    tol = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["out"] for r in ranks]), out.detach(), **tol)
    torch.testing.assert_close(torch.cat([r["dx"] for r in ranks]), xx.grad, **tol)
    for r in ranks:
        torch.testing.assert_close(r["dweight"], bn.weight.grad, **tol)
        torch.testing.assert_close(r["dbias"], bn.bias.grad, **tol)
        for k, v in bn.state_dict().items():
            torch.testing.assert_close(r["state"][k], v, **tol)
    _assert_bitwise_equal(ranks[0]["state"], ranks[1]["state"])


# ---- (b) ---------------------------------------------------------------------

STEP_OVER = dict(num_steps_1=2, seed=3, device="cpu")
STEP_SHAPE = (16, 32, 32, 3)             # 8 images a rank


def test_two_rank_step_equals_one_process_in_float64(tmp_path):
    """The flagship's AT step (resnet18_EE_square, EE_BPDA3_AT_square,
    PGD-2, 32 px) from the driver's build: every draw from the run's
    generator at the global batch's shape. 2 ranks x 8 images against one
    process on the 16, float64: 1e-10; the replicas bitwise equal."""
    cfg = load_config(CONFIG, STEP_OVER)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random(STEP_SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 200, STEP_SHAPE[0]).astype(np.int64))
    inputs = dict(cfg=dict(cfg), num_classes=200, x=x, y=y, dtype=torch.float64,
                  lr=0.1, momentum=0.9, weight_decay=2e-4)
    ranks = run_ranks(tmp_path, "step", inputs)
    _assert_replicas_equal(ranks)

    ops, state, gen = driver.build(cfg, 200, torch.device("cpu"))
    state.model.double()
    state.momentum_buf = [b.double() for b in state.momentum_buf]
    step = build_train_step(ops, driver.make_method_config(cfg, 200),
                            OptimConfig(0.9, 2e-4), gen)
    m = step(state, x.double(), y, 0.1)
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(ranks[0]["state"][k], v, rtol=1e-10, atol=1e-10,
                                   msg=k)
    for a, b in zip(ranks[0]["momentum"], state.momentum_buf):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    # the ResNets return float32 logits (models/resnet.py), so the loss is
    # a float32 sum: one process's mean and the ranks' partial sums round
    # apart by an ulp (6e-8 relative, measured)
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(m["loss"]), rtol=1e-6)
    assert ranks[0]["metrics"]["top1"] == pytest.approx(float(m["top1"]), abs=1e-4)


# ---- (c) ---------------------------------------------------------------------

def _jax_step(monkeypatch, x, y, draws, noise, n_data=2):
    """JAX's train step of EE_BPDA3_AT_square jitted over an n_data-device
    mesh (batch on the `data` axis; None: one device), the square draws
    and the PGD start replayed; its metrics, state and x_adv, and the
    port's model on the same weights."""
    ops_j, params, bs, model = helpers.jax_and_port_models(STEP_SHAPE)
    cap = {}
    monkeypatch.setattr(jee, "add_square", helpers.JaxSquareReplay(draws))
    monkeypatch.setattr(jpgd, "_init_perturbation",
                        lambda cfg, key, xx: jnp.clip(xx + noise, 0.0, 1.0))
    monkeypatch.setattr(jmethods, "pgd_linf", helpers._jax_spy(cap))
    mesh = None if n_data is None else meshlib.make_mesh(n_data=n_data)
    mcfg = jmethods.MethodConfig("EE_BPDA3_AT_square", epsilon=helpers.EPS,
                                 num_steps=helpers.PGD_STEPS,
                                 step_size=helpers.STEP_SIZE, num_classes=200)
    step = jtrainer.build_train_step(
        ops_j, mcfg, jtrainer.OptimConfig(helpers.MOMENTUM, helpers.WD), mesh=mesh)
    state = jtrainer.TrainState(params=params, batch_stats=bs,
                                momentum_buf=init_momentum(params),
                                step=jnp.zeros((), jnp.int32))
    xb, yb, key = jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0)
    if mesh is not None:
        state, key = meshlib.replicate(mesh, (state, key))
        xb, yb = meshlib.shard_batch(mesh, (xb, yb))
    state, m = step(state, xb, yb, key, jnp.float32(helpers.LR))
    jax.block_until_ready(state)
    jax.effects_barrier()
    return m, state, cap["x_adv"], model


# The tolerances of the comparison with JAX's sharded step that replace
# torch_port_helpers.JAX_TOL's. On this batch of 16 the float32 attack is
# chaotic: JAX's own single-device and mesh steps end with 17.2% of their
# x_adv pixels apart, so the share of the port's x_adv off the mesh step's
# (15.8%) is held to JAX's own share plus JAX_TOL's 5%. The running
# statistics come from attack forwards on those x_adv (2.0e-2). On JAX's
# x_adv the loss agrees to 3e-7, but JAX's float32 BatchNorm parameter
# gradients drift from float64 where the port's do not
# (tests/test_torch_objectives.py): the parameters 5.9e-3 and the momentum
# 4.2e-2 apart, as |a - b| / (1 + |b|). Test (b) holds the port's ranks
# to its single process in float64. (Measured by this test.)
MESH_TOL = dict(params=1e-2, running=5e-2, momentum=1e-1)


def test_two_rank_step_agrees_with_jax_mesh_step(monkeypatch, tmp_path):
    """The flagship step in float32 on 2 ranks against JAX's step sharded
    over meshlib.make_mesh(n_data=2), on the same global draws (numpy),
    held as tests/test_torch_train_step.py holds one process to JAX: the
    share of x_adv pixels off JAX's, then on JAX's x_adv the loss, top-1,
    parameters, running statistics and momentum (MESH_TOL), with the
    share bounded by JAX's own single-device step's share off its mesh
    step plus 5%."""
    rng = np.random.default_rng(0)
    x = rng.random(STEP_SHAPE).astype(np.float32)
    y = rng.integers(0, 200, STEP_SHAPE[0]).astype(np.int32)
    noise = rng.uniform(-helpers.EPS, helpers.EPS, STEP_SHAPE).astype(np.float32)
    draws = helpers.square_draws(helpers.PGD_STEPS + 1, STEP_SHAPE)
    x_adv_1 = _jax_step(monkeypatch, x, y, draws, noise, n_data=None)[2]
    m_j, state_j, x_adv_j, model = _jax_step(monkeypatch, x, y, draws, noise)
    jax_share = float(np.mean(np.abs(x_adv_1 - x_adv_j) > 1e-6))
    t = torch.from_numpy
    ranks = run_ranks(tmp_path, "replay", dict(
        arch="resnet18_EE_square", ee_args=helpers.EE_ARGS, num_classes=200,
        state=model.state_dict(), draws=[tuple(t(a) for a in d) for d in draws],
        noise=t(noise), x_adv=t(x_adv_j.copy()), x=t(x), y=t(y).long(),
        method="EE_BPDA3_AT_square", fields=dict(
            epsilon=helpers.EPS, num_steps=helpers.PGD_STEPS,
            step_size=helpers.STEP_SIZE, num_classes=200),
        lr=helpers.LR, momentum=helpers.MOMENTUM, weight_decay=helpers.WD))
    _assert_replicas_equal(ranks)
    model.load_state_dict(ranks[0]["state"])
    state = types.SimpleNamespace(step=ranks[0]["step"], momentum_buf=ranks[0]["momentum"])
    port = (ranks[0]["metrics"], state, model,
            torch.cat([r["x_adv"] for r in ranks]).numpy())
    helpers.assert_train_steps_agree(port, (m_j, state_j, x_adv_j),
                                     tol=dict(MESH_TOL, share=jax_share + 0.05))


# ---- (d) ---------------------------------------------------------------------

def _cifar_like(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 100, n).astype(np.int32))


@pytest.mark.parametrize("n", [24, 23])             # 23: truncated for 2 and 3
@pytest.mark.parametrize("kind", ["mnist", "cifar100_augment"])
def test_process_shards_match_jax(kind, n):
    """batches(process_index, process_count) for 1-3 processes: the same
    rows (pixels and labels) as the JAX package's loader, with the CIFAR
    augmentation drawn from the same stream."""
    if kind == "mnist":
        t = tds.synthetic_dataset(tds.SPECS["mnist"], n)
        j = jds.ArrayDataset(t.images.copy(), t.labels.copy())
    else:
        imgs, labels = _cifar_like(n, 5)
        t = tds.ArrayDataset(imgs, labels, augment=tds.cifar_augment)
        j = jds.ArrayDataset(imgs.copy(), labels.copy(), augment=jds.cifar_augment)
    for count in (1, 2, 3):
        seen = []
        for index in range(count):
            kw = dict(batch_size=3, shuffle=True, seed=1, epoch=2, as_uint8=True,
                      process_index=index, process_count=count)
            got, want = list(t.batches(**kw)), list(j.batches(**kw))
            assert len(got) == len(want) == (n // count) // 3
            for (xg, yg), (xw, yw) in zip(got, want):
                np.testing.assert_array_equal(xg, xw)
                np.testing.assert_array_equal(yg, yw)
                seen.append(len(yg))
        assert sum(seen) == count * ((n // count) // 3) * 3


# ---- (e) ---------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_free_at_noise_shards_round_trip(tmp_path, world):
    """Each of `world` ranks writes its rows to noise_p{rank}.pt and reads
    them back bit for bit; a shard of another batch size is refused with
    JAX's warning; one process resuming the run finds rank 0's shard of
    the wrong shape and starts from zeros with the same warning."""
    n = 3 * world
    noise = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.01, 0.01, (n, 8, 8, 3)).astype(np.float32))
    ckpt = tmp_path / "ckpt"
    ranks = run_ranks(tmp_path, "noise", {"noise": noise, "dir": str(ckpt)}, world=world)
    for r, res in enumerate(ranks):
        assert res["path"] == f"noise_p{r}.pt"
        assert torch.equal(res["back"], noise[3 * r:3 * (r + 1)])
        assert torch.equal(res["other"], torch.zeros(4, 8, 8, 3))
        assert res["log"] == [f"WARNING: free-AT noise in {ckpt} has shard (3, 8, 8, 3), "
                              "expected (4, 8, 8, 3) (process count / batch size "
                              "changed?); replay noise resets to zeros"]
    assert sorted(os.listdir(ckpt)) == [f"noise_p{r}.pt" for r in range(world)]
    log = []
    fresh = driver._load_noise({"resume": str(ckpt)}, torch.zeros(n, 8, 8, 3), log.append)
    assert torch.equal(fresh, torch.zeros(n, 8, 8, 3))
    assert log and f"has shard (3, 8, 8, 3), expected ({n}, 8, 8, 3)" in log[0]


# ---- (f) ---------------------------------------------------------------------

def _tiny_config(tmp_path):
    """A tiny synthetic recipe whose weights do not depend on which rows a
    batch's draws go to (ST on the plain ResNet-18, 32 px): a 2-rank run
    and one process then differ only in the order of their sums."""
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg.update(arch="resnet18", method_name="ST", cize=32, num_steps_1=1,
               batch_size=8, print_freq=1)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _assert_close_to_scale(got, want, rel: float, name: str) -> None:
    """|got - want| within `rel` of want's largest magnitude."""
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-12), (name, err)


def test_torchrun_trains_like_one_process(tmp_path):
    """torchrun with 2 processes: one log (rank 0's), one checkpoint, the
    weights those of a single process's run to float32 rounding: each
    tensor within 1e-3 of its largest magnitude, the momentum within
    2e-3 (measured 1.1e-4 and 1.9e-4: BatchNorm over 8 rows of layer4's
    1 x 1 maps amplifies the other order of the float32 sums; test (b)
    holds the same arithmetic to 1e-10 in float64)."""
    config = _tiny_config(tmp_path)
    args = ["-m", "edge_enhancement_tpu_torch.train", "--config", config,
            "--data", "synthetic", "--synthetic-size", "16", "--epochs", "1",
            "--limit-batches", "2", "--device", "cpu"]
    logs = [str(tmp_path / "torchrun.txt")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), *args, "--output", str(tmp_path / "two")],
        cwd=REPO, env=_env(), stdout=open(logs[0], "w"), stderr=subprocess.STDOUT)
    _wait([proc], logs, 300)
    one = driver.run(load_config(config, dict(
        data="synthetic", synthetic_size=16, epochs=1, limit_batches=2, device="cpu",
        output=str(tmp_path / "one"))))
    run_dir = os.path.relpath(os.path.dirname(os.path.dirname(one["checkpoint"])),
                              tmp_path / "one")
    two_dir = tmp_path / "two" / run_dir
    log = (two_dir / "log" / "log.txt").read_text()
    assert log.count("=> dataset") == 1 and "2 processes (gloo), 4 images a process" in log
    assert log.count("Epoch: [0][") == 2 and log.count(" * Adv Prec@1") == 1
    assert sorted(os.listdir(two_dir / "ckpt")) in (
        ["checkpoint.pth.tar"], ["checkpoint.pth.tar", "model_best.pth.tar"])
    got = torch.load(two_dir / "ckpt" / "checkpoint.pth.tar")
    want = torch.load(one["checkpoint"])
    assert got["epoch"] == want["epoch"] == 1
    for k, v in want["state_dict"].items():
        _assert_close_to_scale(got["state_dict"][k].float(), v.float(), 1e-3, k)
    for i, s in want["optimizer"]["state"].items():
        _assert_close_to_scale(got["optimizer"]["state"][i]["momentum_buffer"],
                               s["momentum_buffer"], 2e-3, f"momentum {i}")


def _torchrun(tmp_path, tag, args):
    """torchrun with WORLD processes of the driver into tmp_path/tag,
    started (the caller waits): (process, log path)."""
    log = str(tmp_path / f"{tag}.txt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", "edge_enhancement_tpu_torch.train", *args,
         "--output", str(tmp_path / tag)],
        cwd=REPO, env=_env(), stdout=open(log, "w"), stderr=subprocess.STDOUT)
    return proc, log


def test_torchrun_chained_dispatch_equals_single_steps(tmp_path):
    """torchrun with 2 processes, --steps-per-dispatch 3 and
    --limit-batches 5: chains of 3 and 2 on every rank (each loads 5
    batches), the loop form named on the first log line with the backend
    and the world; the checkpoint bit for bit that of the same run with
    single steps."""
    config = _tiny_config(tmp_path)
    args = ["--config", config, "--data", "synthetic", "--synthetic-size", "40",
            "--epochs", "1", "--limit-batches", "5", "--device", "cpu"]
    runs = {tag: _torchrun(tmp_path, tag, args + extra) for tag, extra in
            (("single", []), ("chained", ["--steps-per-dispatch", "3"]))}
    _wait([p for p, _ in runs.values()], [lg for _, lg in runs.values()], 300)
    ckpts, logs = {}, {}
    for tag in runs:
        (run_dir,) = [d for d in (tmp_path / tag).rglob("ckpt")]
        ckpts[tag] = torch.load(run_dir / "checkpoint.pth.tar")
        logs[tag] = (run_dir.parent / "log" / "log.txt").read_text().splitlines()
    assert ("2 processes (gloo), 4 images a process, steps_per_dispatch 3 (loop), "
            "backend gloo, world 2") in logs["chained"][0]
    assert "steps_per_dispatch" not in logs["single"][0]
    # print_freq 1: a line a dispatch, at its last batch (chains 0-2, 3-4)
    assert [ln.split("\t")[0] for ln in logs["chained"] if ln.startswith("Epoch:")] == [
        "Epoch: [0][2/5]", "Epoch: [0][4/5]"]
    for lines in logs.values():
        assert sum(ln.startswith("=> epoch 0: 5 train steps") for ln in lines) == 1
    got, want = ckpts["chained"], ckpts["single"]
    assert got["epoch"] == want["epoch"] == 1
    assert sorted(got["state_dict"]) == sorted(want["state_dict"])
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    for i, st in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][i]["momentum_buffer"],
                           st["momentum_buffer"]), i


# ---- (g) ---------------------------------------------------------------------

def test_profile_writes_a_trace_and_platform_picks_the_device(tmp_path):
    config = _tiny_config(tmp_path)
    over = dict(data="synthetic", synthetic_size=16, epochs=1, limit_batches=2,
                platform="cpu", profile=str(tmp_path / "trace"),
                output=str(tmp_path / "out"))
    summary = driver.run(load_config(config, over))
    assert summary["train_steps"] == [2]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::conv") for e in events)
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert f"=> profiler trace written to {tmp_path / 'trace' / 'trace.json'}" in log
    assert driver.run_device({"platform": "cpu"}) == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="tpu"):
        driver.run_device({"platform": "tpu"})
    with pytest.raises(ValueError, match="contradicts"):
        driver.run_device({"platform": "gpu", "device": "cpu"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            driver.run_device({"platform": "cuda"})
