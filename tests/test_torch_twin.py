"""The port's whole-training twin (edge_enhancement_tpu_torch/tools/twin.py):
(a) its data and batch order are the JAX package's, bit for bit; (b) the
harness runs a family end to end on the CPU at a tiny size and writes its
record; (c) the gate on the committed card runs (output/twin_port/): each
family's converged clean and PGD top-1, over 3 seeds, against the JAX
package's committed twin run (output/twin_hard*/twin_hard.json) within the
largest per-side seed band + 1 point, and mid-band, as
tests/test_digital_twin_tiny.py gates the committed runs. AWP starts from
torch's default initialisation, the committed runs' reference
PreActResNet's; from the port's own (output/twin_port/port_init/) it
converges lower on both metrics."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import json
import math
import os

import numpy as np
import pytest
import torch

from edge_enhancement_tpu.data import datasets as jds
from edge_enhancement_tpu.train.schedules import piecewise_50_75 as jax_piecewise
from edge_enhancement_tpu_torch.data.datasets import synthetic_hard_images
from edge_enhancement_tpu_torch.tools import twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "output", "twin_port")


def test_data_and_batch_order_are_the_jax_packages():
    for n, seed in ((40, 0), (20, 1)):
        xs, ys = synthetic_hard_images(n, seed)
        jxs, jys = jds.synthetic_hard_images(n, seed)
        assert xs.dtype == jxs.dtype == np.uint8
        np.testing.assert_array_equal(xs, jxs)
        np.testing.assert_array_equal(ys, jys)
    recipe = twin.family_recipe("flagship")
    train, val = twin.datasets(recipe)
    jtrain = jds.ArrayDataset(*jds.synthetic_hard_images(recipe["n_train"], 0))
    jval = jds.ArrayDataset(*jds.synthetic_hard_images(recipe["n_val"], 1))
    bs = recipe["batch_size"]
    streams = [(train, jtrain, dict(shuffle=True, seed=s, epoch=e))
               for s in (1, 2, 3) for e in (0, 1)]
    streams.append((val, jval, dict(shuffle=False, seed=0)))
    for ours, theirs, kw in streams:
        got = list(ours.batches(bs, as_uint8=True, **kw))
        want = list(theirs.batches(bs, as_uint8=True, **kw))
        assert len(got) == len(want) == len(ours) // bs
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("family", ["flagship", "awp"])
def test_harness_runs_on_cpu(tmp_path, family, capsys):
    argv = ["--family", family, "--seeds", "1", "--epochs", "1", "--n-train", "50",
            "--n-val", "25", "--num-steps", "1", "--device", "cpu", "--out", str(tmp_path)]
    record = twin.main(argv)
    with open(tmp_path / f"{family}.json") as f:
        assert json.load(f) == json.loads(json.dumps(record))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert set(record) >= {"family", "recipe", "seeds", "port", "device", "torch"}
    assert record["device"] == {"type": "cpu", "name": "cpu", "nvidia_smi": None}
    assert record["init"] == ("torch" if family == "awp" else "port")
    recipe = record["recipe"]
    assert recipe["method_name"] == twin.committed(family)["recipe"]["method_name"]
    assert (recipe["epochs"], recipe["n_train"], recipe["n_val"],
            recipe["num_steps_1"]) == (1, 50, 25, 1)
    run = record["port"]["1"]
    assert run["train_steps"] == 2 and run["eval_batches"] == 1
    assert run["launches"] == {}            # the CPU runs the plain versions
    for m in ("clean", "adv"):
        assert len(run[m]) == 1 and math.isfinite(run[m][0]) and 0 <= run[m][0] <= 100
    if family == "awp":
        # the JAX tool's per-minibatch schedule (tools/digital_twin_awp.py)
        assert run["lr"] == [jax_piecewise(recipe["lr"], 0 + (i + 1) / 2, 1)
                             for i in range(2)] == [0.1, 0.001]
    else:
        assert run["lr"] == [recipe["lr"]] * 2
    with open(tmp_path / "summary.json") as f:
        assert set(json.load(f)) == {family}


def test_torch_default_init_draws_torchs_distribution():
    """--init torch: every convolution and dense layer from torch's
    reset_parameters distribution (|w| <= 1/sqrt(fan_in), std
    1/sqrt(3 fan_in)) on a seeded CPU generator, the same each time; the
    port's own init draws the convolutions N(0, 2/fan_out)."""
    from edge_enhancement_tpu_torch.models.registry import build_model

    recipe = twin.family_recipe("awp")
    models = [build_model(recipe["arch"], recipe, twin.NUM_CLASSES,
                          generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    port_w = models[0].layer1[0].conv1.weight.clone()
    assert abs(port_w.std().item() / math.sqrt(2.0 / port_w[0].numel()) - 1) < 0.05
    for m in models:
        twin.torch_default_init(m, 3)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    layers = [m for m in models[0].modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert len(layers) == 21                    # PreActResNet18: 20 convs and fc
    for m in layers:
        fan_in = m.weight[0].numel()
        # the bound itself rounds to float32
        assert m.weight.abs().max().item() <= (1 + 2 ** -23) / math.sqrt(fan_in)
        if m.weight.numel() > 10000:
            assert abs(m.weight.std().item() * math.sqrt(3 * fan_in) - 1) < 0.05


def _want_launches(family: str, recipe: dict, steps: int, evals: int) -> dict:
    """K1/K2 launches: a forward each attack step, the training forward
    (and AWP's proxy forward), the clean and adversarial validation
    forwards; an input gradient each attack step. resnet18 has no
    front-end."""
    if family in ("trades", "alp"):
        return {}
    k = recipe["num_steps_1"]
    ke = recipe.get("num_steps_2", k)
    per_step = k + (2 if family == "awp" else 1)
    return {"ee_fused_fwd": steps * per_step + evals * (ke + 2),
            "ee_fused_bwd": steps * k + evals * ke}


def _converged(hist):
    return {m: float(np.mean(hist[m][-2:])) for m in ("clean", "adv")}


def _card_run(path: str, family: str, twin_dir: str, init: str) -> tuple:
    """A committed card run of the twin: 3 seeds of the committed recipe on
    an H100, its launches the steps' and validation batches'; with the
    committed JAX twin run."""
    with open(path) as f:
        port = json.load(f)
    with open(os.path.join(REPO, "output", twin_dir, "twin_hard.json")) as f:
        jax_twin = json.load(f)
    recipe = port["recipe"]
    assert {k: recipe[k] for k in jax_twin["recipe"]} == jax_twin["recipe"]
    assert recipe["n_val"] == 250 and port["seeds"] == [1, 2, 3] and port["init"] == init
    assert port["device"]["type"] == "cuda" and "H100" in port["device"]["name"]
    assert port["device"]["nvidia_smi"].endswith(" W")
    n_batches = recipe["n_train"] // recipe["batch_size"]
    val_batches = recipe["n_val"] // recipe["batch_size"]
    for s in port["seeds"]:
        run = port["port"][str(s)]
        assert len(run["clean"]) == len(run["adv"]) == recipe["epochs"]
        assert run["train_steps"] == recipe["epochs"] * n_batches
        assert run["eval_batches"] == recipe["epochs"] * val_batches
        assert run["launches"] == _want_launches(family, recipe, run["train_steps"],
                                                 run["eval_batches"])
    return port, jax_twin


@pytest.mark.parametrize("family,twin_dir,clean_hi,init", [
    ("flagship", "twin_hard", 95.0, "port"), ("tar", "twin_hard_tar", 95.0, "port"),
    ("trades", "twin_hard_trades", 97.0, "port"), ("alp", "twin_hard_alp", 95.0, "port"),
    ("awp", "twin_hard_awp", 95.0, "torch")])
def test_port_twin_converges_with_the_jax_package(family, twin_dir, clean_hi, init):
    port, jax_twin = _card_run(os.path.join(PORT_DIR, f"{family}.json"), family, twin_dir,
                               init)
    conv = {"port": [_converged(port["port"][str(s)]) for s in port["seeds"]],
            "ours": [_converged(jax_twin["ours"][str(s)]) for s in jax_twin["seeds"]],
            "reference": [_converged(jax_twin["reference"][str(s)])
                          for s in jax_twin["seeds"]]}
    cm = np.mean([c["clean"] for c in conv["port"]])
    am = np.mean([c["adv"] for c in conv["port"]])
    assert 40.0 <= cm <= clean_hi, cm          # mid-band, not 100/100
    assert am <= cm - 5.0, (cm, am)            # attackable
    assert am >= 30.0, am                      # but learnable
    with open(os.path.join(PORT_DIR, "summary.json")) as f:
        summary = json.load(f)[family]
    for m in ("clean", "adv"):
        vals = {side: [c[m] for c in cs] for side, cs in conv.items()}
        band = max(max(v) - min(v) for v in vals.values())
        gap = abs(np.mean(vals["port"]) - np.mean(vals["ours"]))
        assert gap <= band + 1.0, (m, gap, band, vals)
        assert summary[m]["gap"] == pytest.approx(gap, abs=1e-9)
        assert summary[m]["band"] == pytest.approx(band, abs=1e-9)
        assert summary[m]["pass"]
    assert summary["mid_band"]["pass"] and summary["pass"]


def test_awp_from_the_ports_init_converges_lower():
    """The AWP family's finding: the same seeds from the port's own
    PreActResNet initialisation (the JAX package's, convolutions
    N(0, 2/fan_out)) converge below the runs from torch's default, the
    committed runs' reference init, on both metrics and on every seed's
    adversarial accuracy."""
    port_init, _ = _card_run(os.path.join(PORT_DIR, "port_init", "awp.json"), "awp",
                             "twin_hard_awp", "port")
    torch_init, _ = _card_run(os.path.join(PORT_DIR, "awp.json"), "awp", "twin_hard_awp",
                              "torch")
    conv = {name: [_converged(r["port"][str(s)]) for s in r["seeds"]]
            for name, r in (("port", port_init), ("torch", torch_init))}
    for m in ("clean", "adv"):
        assert (np.mean([c[m] for c in conv["port"]])
                < np.mean([c[m] for c in conv["torch"]]) - 5.0), m
    assert max(c["adv"] for c in conv["port"]) < min(c["adv"] for c in conv["torch"])
