"""The port's checkpoints (train/checkpoint.py): its own round trip, both
directions across the frameworks through the JAX package's converter
(tools/convert_torch_checkpoint.py), the torchvision warm start against
the JAX package's, and the refusals of restore_into_state.

1. The port's checkpoint.pth.tar -> `convert` -> a JAX state: the same
   eval-mode logits.
2. A JAX Orbax checkpoint -> `--to-torch` -> the port's load and
   `--evaluate --resume <file>`: the same eval-mode logits.

Logits are compared within tests/test_torch_resnet.py's eval-mode float32
tolerance (atol = rtol = 1e-5), on the same square draws."""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.train import checkpoint as jckpt
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train import checkpoint as ckpt
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state
from tools import convert_torch_checkpoint as conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "resnet18_EE_square"
SHAPE = (2, 64, 64, 3)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


def _port_model(seed=4):
    """A port model with its own initialisation and BatchNorm statistics
    away from (0, 1), so every tensor of the conversion matters."""
    model = build_model(ARCH, helpers.EE_ARGS, 200,
                        generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("running_var"):
                t.copy_(1.0 + 0.5 * torch.rand(t.shape, generator=gen))
    return model


def _logits_pair(model, ops_j, params, stats):
    """Eval-mode logits of the port model and of the JAX model on the same
    input and square draw."""
    x = np.random.default_rng(8).random(SHAPE).astype(np.float32)
    draws = helpers.square_draws(1, SHAPE, seed=9)
    model.square_source = helpers.TorchSquareReplay(draws)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    old = jee.add_square
    jee.add_square = helpers.JaxSquareReplay(draws)
    try:
        want = np.asarray(jax.jit(ops_j.logits_eval)(params, stats, jnp.asarray(x),
                                                     jax.random.PRNGKey(0)))
    finally:
        jee.add_square = old
    return got, want


def _jax_template():
    ops_j = JaxModelOps(jax_build_model(ARCH, helpers.EE_ARGS, 200))
    shapes = jax.eval_shape(ops_j.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + SHAPE[1:], jnp.float32))
    return ops_j, shapes


def test_port_checkpoint_through_the_jax_converter(tmp_path):
    model = _port_model()
    state = create_train_state(model)
    for b in state.momentum_buf:
        b.normal_(generator=torch.Generator().manual_seed(2))
    path = ckpt.save_checkpoint(str(tmp_path), state, 4, ARCH, 12.5, True,
                                OptimConfig(), 0.1)
    assert os.path.exists(tmp_path / "model_best.pth.tar")
    payload = torch.load(path, weights_only=False)
    assert payload["epoch"] == 4 and type(payload["best_prec1"]) is float

    ops_j, shapes = _jax_template()
    params, stats = helpers.random_variables(shapes, np.random.default_rng(0))
    params, stats, n, skipped = conv.convert(
        payload["state_dict"], conv.resnet_name_map(18), params, stats)
    assert not skipped and n == len(payload["state_dict"])
    got, want = _logits_pair(model, ops_j, params, stats)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert np.abs(want).max() > 0.1


def test_jax_checkpoint_through_to_torch_into_the_port(tmp_path, monkeypatch):
    ops_j, shapes = _jax_template()
    params, stats = helpers.random_variables(shapes, np.random.default_rng(3), 0.1)
    state_j = jtrainer.TrainState(params=params, batch_stats=stats,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    jckpt.save_checkpoint(str(tmp_path / "orbax"), state_j, 3, ARCH, 55.5, True)
    pth = tmp_path / "exported.pth"
    monkeypatch.setattr(sys, "argv", [
        "convert_torch_checkpoint.py", str(tmp_path / "orbax"), str(pth),
        "--arch", ARCH, "--num-classes", "200", "--to-torch"])
    conv.main()

    payload = ckpt.load_checkpoint(str(pth))
    assert "optimizer" not in payload
    model = build_model(ARCH, helpers.EE_ARGS, 200)
    state, epoch, best = ckpt.restore_into_state(create_train_state(model), payload)
    assert (epoch, best) == (3, 55.5)
    assert all(float(b.abs().max()) == 0.0 for b in state.momentum_buf)
    got, want = _logits_pair(model, ops_j, params, stats)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert np.abs(want).max() > 0.1

    # the same file through the port's driver: --evaluate --resume <file>
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(REPO, "edge_enhancement_tpu", "configs",
                                   "tiny_imagenet", "ee_at_bpda3_square.yml"),
                      dict(data="synthetic", synthetic_size=8, batch_size=4,
                           limit_batches=1, device="cpu", evaluate=True,
                           resume=str(pth), num_steps_1=1, num_steps_2=1,
                           num_steps_3=1, output=str(tmp_path / "out")))
    summary = run(cfg)
    assert summary["start_epoch"] == 3 and summary["eval_batches"] == [1, 1, 1]
    log = open(os.path.join(summary["out_dir"], "log", "log.txt")).read()
    assert f"=> resumed from {pth} (epoch 3)" in log


def test_load_pretrained_matches_jax(tmp_path):
    """A torchvision-format 1000-class resnet18 state_dict (DataParallel
    names) warm-starts resnet18_EE for 200 classes on both sides: the same
    backbone, the head skipped and reported by both."""
    tv = build_model("resnet18", {}, 1000, generator=torch.Generator().manual_seed(7))
    pth = tmp_path / "tv.pth"
    torch.save({"module." + k: v for k, v in tv.state_dict().items()}, pth)

    ops_j = JaxModelOps(jax_build_model("resnet18_EE", helpers.EE_ARGS, 200))
    params, stats = jax.jit(ops_j.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + SHAPE[1:]))
    state_j = jtrainer.TrainState(params=params, batch_stats=stats,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    state_j, n_j, skipped_j = conv.load_pretrained_torch(state_j, "resnet18_EE", str(pth))

    model = build_model("resnet18_EE", helpers.EE_ARGS, 200,
                        generator=torch.Generator().manual_seed(1))
    head = model.fc.weight.detach().clone()
    n, skipped = ckpt.load_pretrained(model, str(pth))
    assert n == n_j == len(tv.state_dict()) - 2
    assert sorted(k for k, _, _ in skipped) == ["fc.bias", "fc.weight"]
    assert sorted(k for k, _, _ in skipped_j) == [("Dense_0", "bias"), ("Dense_0", "kernel")]
    assert ("fc.weight", (1000, 512), (200, 512)) in skipped
    want = state_dict_from_jax(helpers.to_numpy_tree(state_j.params),
                               helpers.to_numpy_tree(state_j.batch_stats))
    sd = model.state_dict()
    for k, v in want.items():
        if not k.startswith("fc."):
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
            np.testing.assert_array_equal(sd[k].numpy(), tv.state_dict()[k].numpy())
    assert torch.equal(model.fc.weight, head)


def test_round_trip_in_the_port(tmp_path):
    model = _port_model(seed=6)
    state = create_train_state(model)
    for i, b in enumerate(state.momentum_buf):
        b.fill_(0.01 * i)
    ckpt.save_checkpoint(str(tmp_path), state, 2, ARCH, 1.5, False, OptimConfig(), 0.1)
    assert ckpt.load_checkpoint(str(tmp_path), "best") is None
    assert ckpt.load_checkpoint(str(tmp_path / "absent")) is None
    # a DataParallel-named copy of the same payload, as a file
    payload = torch.load(tmp_path / "checkpoint.pth.tar", weights_only=True)
    payload["state_dict"] = {"module." + k: v for k, v in payload["state_dict"].items()}
    torch.save(payload, tmp_path / "dp.pth")
    for source in (str(tmp_path), str(tmp_path / "dp.pth")):
        fresh = create_train_state(build_model(ARCH, helpers.EE_ARGS, 200))
        fresh, epoch, best = ckpt.restore_into_state(fresh, ckpt.load_checkpoint(source))
        assert (epoch, best) == (2, 1.5)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.model.state_dict()[k], v), k
        for a, b in zip(fresh.momentum_buf, state.momentum_buf):
            assert torch.equal(a, b)
    noise = torch.rand(2, 8, 8, 3)
    assert ckpt.load_noise(str(tmp_path)) is None
    path = ckpt.save_noise(str(tmp_path), noise)
    assert path == str(tmp_path / "noise.pt")
    for source in (str(tmp_path), str(tmp_path / "checkpoint.pth.tar")):
        assert torch.equal(ckpt.load_noise(source), noise)


@pytest.mark.parametrize("fault", ["missing", "shape", "momentum_shape",
                                   "momentum_missing"])
def test_restore_into_state_names_what_does_not_fit(tmp_path, fault):
    model = build_model(ARCH, helpers.EE_ARGS, 200)
    state = create_train_state(model)
    ckpt.save_checkpoint(str(tmp_path), state, 1, ARCH, 0.0, False, OptimConfig(), 0.1)
    payload = ckpt.load_checkpoint(str(tmp_path))
    sd, opt = payload["state_dict"], payload["optimizer"]["state"]
    name = {"missing": "layer3.0.bn1.running_var", "shape": "fc.weight",
            "momentum_shape": "fc.bias", "momentum_missing": "conv1.weight"}[fault]
    if fault == "missing":
        del sd[name]
    elif fault == "shape":
        sd[name] = torch.zeros(10, 512)
    elif fault == "momentum_shape":
        opt[len(opt) - 1]["momentum_buffer"] = torch.zeros(10)
    else:
        del opt[0]
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        ckpt.restore_into_state(create_train_state(build_model(ARCH, helpers.EE_ARGS, 200)),
                                payload)
