"""The port's whole-training twin (edge_enhancement_tpu_torch/tools/twin.py):
(a) its data and batch order are the JAX package's, bit for bit; (b) the
harness runs a family end to end on the CPU at a tiny size and writes its
record; (c) the gate on the committed card runs (output/twin_port/): each
family's converged clean and PGD top-1, over 3 seeds, against the JAX
package's committed twin run (output/twin_hard*/twin_hard.json) within the
largest per-side seed band + 1 point, and mid-band, as
tests/test_digital_twin_tiny.py gates the committed runs; (d) each
family's recipe, head, loop and lr sequence are its JAX tool's. AWP starts
from torch's default initialisation, the committed runs' reference
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
from edge_enhancement_tpu.train import schedules as jsched
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


# family -> train images of the CPU run (2 steps; fast-AT's resnet50_EE 1)
HARNESS_N_TRAIN = {"flagship": 50, "awp": 50, "free": 50, "fast": 25, "fd": 50,
                   "trick": 50}


@pytest.mark.parametrize("family", list(HARNESS_N_TRAIN))
def test_harness_runs_on_cpu(tmp_path, family, capsys):
    n_train = HARNESS_N_TRAIN[family]
    argv = ["--family", family, "--seeds", "1", "--epochs", "1", "--n-train", str(n_train),
            "--n-val", "25", "--num-steps", "1", "--device", "cpu", "--out", str(tmp_path)]
    record = twin.main(argv)
    with open(tmp_path / f"{family}.json") as f:
        assert json.load(f) == json.loads(json.dumps(record))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == record
    assert set(record) >= {"family", "recipe", "seeds", "port", "device", "torch"}
    assert record["device"] == {"type": "cpu", "name": "cpu", "nvidia_smi": None}
    assert record["init"] == ("torch" if family == "awp" else "reference")
    recipe = record["recipe"]
    assert recipe["method_name"] == twin.committed(family)["recipe"]["method_name"]
    loop = twin.FAMILIES[family].loop
    # free-AT and fast-AT train with no PGD: --num-steps sets the validation's
    assert (recipe["epochs"], recipe["n_train"], recipe["n_val"],
            recipe.get("num_steps_2", recipe.get("num_steps_1"))) == (1, n_train, 25, 1)
    assert ("num_steps_1" in recipe) == (loop not in ("free", "fast"))
    run = record["port"]["1"]
    steps = n_train // 25
    assert run["train_steps"] == steps and run["eval_batches"] == 1
    assert run["updates"] == steps * (4 if loop == "free" else 1)
    assert run["launches"] == {}            # the CPU runs the plain versions
    for m in ("clean", "adv"):
        assert len(run[m]) == 1 and math.isfinite(run[m][0]) and 0 <= run[m][0] <= 100
    if family == "awp":
        # the JAX tool's per-minibatch schedule (tools/digital_twin_awp.py)
        assert run["lr"] == [jax_piecewise(recipe["lr"], 0 + (i + 1) / 2, 1)
                             for i in range(2)] == [0.1, 0.001]
    elif family == "fast":
        assert run["lr"] == [recipe["lr_peak"]]     # interp(0 + 1/1) at knot 1
    else:
        assert run["lr"] == [recipe["lr"]] * steps
    with open(tmp_path / "summary.json") as f:
        assert set(json.load(f)) == {family}


# the JAX package's gate (tests/test_digital_twin_tiny.py) and the JAX
# tools' heads (tools/digital_twin_{free,fast,fd,trick}.py: NUM_CLASSES)
GATE = {"flagship": ("twin_hard", 95.0, 200), "tar": ("twin_hard_tar", 95.0, 200),
        "trades": ("twin_hard_trades", 97.0, 200), "alp": ("twin_hard_alp", 95.0, 200),
        "awp": ("twin_hard_awp", 95.0, 200), "free": ("twin_hard_free", 98.0, 1000),
        "fast": ("twin_hard_fast", 96.0, 1000), "fd": ("twin_hard_fd", 96.0, 1000),
        "trick": ("twin_hard_trick", 96.0, 1000)}


@pytest.mark.parametrize("family", sorted(GATE))
def test_family_recipe_is_the_committed_one(family):
    """The recipe is the committed JSON's, key for key (fast-AT's lr_peak
    0.005, not its tool's 0.4 * 25 / 512 default, which collapses in both
    stacks), plus n_val and the validation's PGD steps; the head, the
    clean_hi and the loop's SGD settings are the JAX tools'."""
    fam = twin.FAMILIES[family]
    assert (fam.twin, fam.clean_hi, fam.num_classes) == GATE[family]
    with open(os.path.join(REPO, "output", fam.twin, "twin_hard.json")) as f:
        want = json.load(f)["recipe"]
    recipe = twin.family_recipe(family)
    extra = {k: recipe[k] for k in set(recipe) - set(want)}
    assert {k: recipe[k] for k in want} == want
    assert extra == ({"n_val": 250} if fam.eval_steps is None
                     else {"n_val": 250, "num_steps_2": fam.eval_steps})
    opt = twin.optim_config(fam.loop, recipe)
    assert (opt.momentum, opt.weight_decay) == (want["momentum"], want["weight_decay"])
    assert opt.bn_no_decay == (family == "fast")
    want_loop = {"free_AT": "free", "fast_AT": "fast"}.get(
        want["method_name"], "awp" if "awp_gamma" in want else "generic")
    assert fam.loop == want_loop
    if family == "fast":
        assert want["lr_peak"] == 0.005 and list(want["lr_epochs"]) == [0, 1, 6]
    if fam.loop in ("free", "fast"):
        ff = twin.free_fast_config(recipe)
        assert (ff.n_repeats, ff.fgsm_step, ff.clip_eps) == (
            want["n_repeats"], want["fgsm_step"], want["clip_eps"])
        assert fam.eval_steps == 10             # the JAX tools' EVAL_STEPS


@pytest.mark.parametrize("family", ["free", "fast"])
def test_lr_sequence_is_the_jax_tools(family):
    """Every minibatch's lr over the committed recipe (500 images, batch 25)
    equals the JAX tool's formula: free-AT step30_free of the outer epoch
    (tools/digital_twin_free.py), fast-AT np.interp over the knots at
    epoch + (i + 1) / ceil(n_train / 25) (tools/digital_twin_fast.py)."""
    recipe = twin.family_recipe(family)
    loop = twin.FAMILIES[family].loop
    n = twin.n_batches(loop, recipe, recipe["n_train"])
    assert n == -(-recipe["n_train"] // recipe["batch_size"]) == 20
    got = [twin.step_lr(loop, recipe, e, i, n) for e in range(recipe["epochs"])
           for i in range(n)]
    if family == "free":
        want = [jsched.step30_free(recipe["lr"], e, recipe["n_repeats"])
                for e in range(recipe["epochs"]) for _ in range(n)]
        assert set(want) == {0.1}
    else:
        peak = recipe["lr_peak"]
        want = [float(np.interp(e + (i + 1) / n, list(recipe["lr_epochs"]),
                                [0.0, peak, peak / 10]))
                for e in range(recipe["epochs"]) for i in range(n)]
        assert want[19] == peak
        assert want[0] == pytest.approx(peak / 20) and want[-1] == pytest.approx(peak / 10)
    assert got == want


def test_torch_default_init_draws_torchs_distribution():
    """--init torch: every convolution and dense layer from torch's
    reset_parameters distribution (|w| <= 1/sqrt(fan_in), std
    1/sqrt(3 fan_in)) on a seeded CPU generator, the same each time; the
    port's own init draws the convolutions N(0, 2/fan_out)."""
    from edge_enhancement_tpu_torch.models.registry import build_model

    recipe = twin.family_recipe("awp")
    models = [build_model(recipe["arch"], recipe, twin.FAMILIES["awp"].num_classes,
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


def test_reference_init_redraws_only_the_head_and_conv_biases():
    """--init reference: the torchvision-style ResNets' init loop draws the
    convolution weights and BatchNorms (the port's init keeps them), and
    leaves the dense head and the convolutions' biases (resnet18_fd's
    denoising blocks) at torch's defaults, the same draws as --init torch
    makes for them on that seed."""
    from edge_enhancement_tpu_torch.models.batchnorm import BatchNorm2d
    from edge_enhancement_tpu_torch.models.registry import build_model

    models = [build_model("resnet18_fd", {}, twin.FAMILIES["fd"].num_classes,
                          generator=torch.Generator().manual_seed(1)) for _ in range(2)]
    before = {k: v.clone() for k, v in models[0].state_dict().items()}
    twin.torch_default_init(models[0], 3, conv_weights=False)
    twin.torch_default_init(models[1], 3)
    biased = 0
    for (name, m), (_, full) in zip(models[0].named_modules(), models[1].named_modules()):
        if isinstance(m, torch.nn.Conv2d):
            assert torch.equal(m.weight, before[name + ".weight"]), name
            if m.bias is not None:
                biased += 1
                assert torch.equal(m.bias, full.bias) and m.bias.abs().max() > 0
        elif isinstance(m, torch.nn.Linear):
            assert torch.equal(m.weight, full.weight) and torch.equal(m.bias, full.bias)
            assert m.weight.abs().max().item() <= (1 + 2 ** -23) / math.sqrt(512)
        elif isinstance(m, BatchNorm2d):
            assert torch.equal(m.weight, before[name + ".weight"]), name
    assert biased == 4                          # the four denoising blocks' conv3


@pytest.mark.parametrize("group,hw", [(1, 16), (2, 8), (3, 4), (4, 2)])
def test_denoising_block_normalises_by_the_map_it_is_given(group, hw):
    """The fd family at 64 px: the reference's denoising blocks hard-wire
    56/28/14/7 (224 px), which the JAX tool sets to 16/8/4/2
    (tools/digital_twin_fd.py:64-73); the port's DenoisingBlock takes the
    size of its input map. Each block of resnet18_fd on its input at 64 px
    (eval mode) against x + bn(conv3(x Gram(x, x) / (H W))) in float64 at that H W
    (a size off by 2x moves f by 4x)."""
    from edge_enhancement_tpu_torch.models.registry import build_model

    model = build_model("resnet18_fd", {}, twin.FAMILIES["fd"].num_classes,
                        generator=torch.Generator().manual_seed(0))
    block = getattr(model, f"denoise{group}")
    seen = []
    block.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    with torch.no_grad():
        # train mode: batch statistics keep the maps O(1) (in eval mode the
        # init's running statistics let x^3 overflow by layer4)
        model(torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)))
        x = seen[0]
        out = block.eval()(x)
    b, c = x.shape[:2]
    assert x.shape[2:] == (hw, hw)
    v = x.double().reshape(b, c, hw * hw)
    f = (torch.bmm(torch.bmm(v, v.transpose(1, 2)).transpose(1, 2), v)
         / (hw * hw)).reshape(x.shape)
    with torch.no_grad():
        block.double()
        want = x.double() + block.bn(block.conv3(f))
    # float32 sums of up to 512 x H W products: 1e-5 of the largest value
    assert (out.double() - want).abs().max() <= 1e-5 * want.abs().max()


def _want_launches(family: str, recipe: dict, steps: int, evals: int) -> dict:
    """K1/K2 launches: a forward each attack step, the training forward
    (and AWP's proxy forward), the clean and adversarial validation
    forwards; an input gradient each attack step. resnet18 and resnet18_fd
    have no front-end, and the full CannyFilter of free, fast and trick is
    plain PyTorch: those launch no kernel."""
    if family in ("trades", "alp", "free", "fast", "fd", "trick"):
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
        assert run.get("updates", run["train_steps"]) == (run["train_steps"]
                                                          * recipe.get("n_repeats", 1))
        assert run["eval_batches"] == recipe["epochs"] * val_batches
        assert run["launches"] == _want_launches(family, recipe, run["train_steps"],
                                                 run["eval_batches"])
    return port, jax_twin


@pytest.mark.parametrize("family,twin_dir,clean_hi,init", [
    ("flagship", "twin_hard", 95.0, "reference"), ("tar", "twin_hard_tar", 95.0, "reference"),
    ("trades", "twin_hard_trades", 97.0, "reference"),
    ("alp", "twin_hard_alp", 95.0, "reference"),
    ("awp", "twin_hard_awp", 95.0, "torch"), ("free", "twin_hard_free", 98.0, "reference"),
    ("fast", "twin_hard_fast", 96.0, "reference"), ("fd", "twin_hard_fd", 96.0, "reference"),
    ("trick", "twin_hard_trick", 96.0, "reference")])
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


@pytest.mark.parametrize("family", ["flagship", "tar", "trades", "alp", "free", "fast",
                                    "fd", "trick"])
def test_resnet_families_from_the_ports_own_init_pass_too(family):
    """The ResNet families from the port's own init (its dense head
    lecun-normal with a zero bias, the JAX package's), committed under
    output/twin_port/port_init/: each passes the same gate."""
    fam = twin.FAMILIES[family]
    port, _ = _card_run(os.path.join(PORT_DIR, "port_init", f"{family}.json"), family,
                        fam.twin, "port")
    stat = twin.statistic(family, port)
    assert stat["clean"]["pass"] and stat["adv"]["pass"] and stat["mid_band"]["pass"]


def test_free_from_the_ports_head_converges_higher_on_adv():
    """The free family's finding: from the port's own init, three card runs
    (seeds 1-3 twice, seeds 4-6) converged to an adversarial accuracy above
    the JAX runs' mean on all 9 seed-runs, and above every seed from the
    reference init (torch's default dense head), whose mean is within 1
    point of JAX's."""
    ref, jax_twin = _card_run(os.path.join(PORT_DIR, "free.json"), "free",
                              "twin_hard_free", "reference")
    runs = [_card_run(os.path.join(PORT_DIR, "port_init", "free.json"), "free",
                      "twin_hard_free", "port")[0]]
    for seeds in ("seeds123", "seeds456"):
        with open(os.path.join(PORT_DIR, "port_init", "free_rerun", seeds, "free.json")) as f:
            runs.append(json.load(f))
    assert [r["seeds"] for r in runs] == [[1, 2, 3], [1, 2, 3], [4, 5, 6]]
    assert all(r["init"] == "port" and "H100" in r["device"]["name"] for r in runs)
    port_adv = [_converged(r["port"][str(s)])["adv"] for r in runs for s in r["seeds"]]
    ref_adv = [_converged(ref["port"][str(s)])["adv"] for s in ref["seeds"]]
    jax_adv = np.mean([_converged(jax_twin["ours"][str(s)])["adv"] for s in jax_twin["seeds"]])
    assert min(port_adv) > max(max(ref_adv), jax_adv), (port_adv, ref_adv, jax_adv)
    assert abs(np.mean(ref_adv) - jax_adv) < 1.0
