"""The port's MNIST CNNs (models/cnn_mnist.py: Net2, Net2_EE,
Net2_EE_square) against the JAX package's on carried weights: logits and
input gradients in eval mode and in train mode, where the port takes the
Dropout2d masks that JAX's own forward drew (taken out of it, never
re-drawn); one train step of AT, ALP (whose two clean JAX passes share one
mask, which the port's one clean forward takes) and TRADES; the converter's
fc1 rows; and the port's checkpoints through the JAX package's converter
both ways. 28 x 28 x 1, batches of 4."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from torch_checkpoints import drop_written_checkpoints  # noqa: F401  (autouse)
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu_torch.convert import arch_state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train import checkpoint as ckpt
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state
from edge_enhancement_tpu_torch.utils.config import load_config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from tools import convert_torch_checkpoint as conv  # noqa: E402

SHAPE = (4, 28, 28, 1)
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "edge_enhancement_tpu", "configs", "mnist")
# the front-end of configs/mnist/ee_at_bpda3_square.yml (Net2_EE takes the
# registry's default full Canny)
MNIST_EE = dict(r=4, w=1.0, low=25.0, high=51.0, alpha=0.3, sigma=1.0, gf=False,
                type_canny="CannyFilter_step125_1", epsilon=0.3, n_queries=1)
ARCH_ARGS = {"Net2": {}, "Net2_EE": {k: v for k, v in MNIST_EE.items() if k != "type_canny"},
             "Net2_EE_square": MNIST_EE}


def _models(arch):
    return helpers.jax_and_port_models(SHAPE, arch=arch, ee_args=ARCH_ARGS[arch],
                                       num_classes=10)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", list(ARCH_ARGS))
def test_net2_forward_and_input_gradient_match_jax(monkeypatch, arch, train):
    ops_j, params, _, model = _models(arch)
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(np.float32)
    u = rng.standard_normal((SHAPE[0], 10)).astype(np.float32)
    draws = helpers.square_draws(1, SHAPE, seed=3)
    monkeypatch.setattr(jee, "add_square", helpers.JaxSquareReplay(draws))
    dropout = helpers.JaxDropoutCapture()
    monkeypatch.setattr(jax.random, "bernoulli", dropout)

    def f(xx):
        if train:
            logits, _ = ops_j.logits_train(params, {}, xx, jax.random.PRNGKey(1))
        else:
            logits = ops_j.logits_eval(params, {}, xx, jax.random.PRNGKey(1))
        return jnp.sum(logits * u), logits
    (_, logits_j), g_j = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    jax.effects_barrier()
    assert len(dropout.masks) == int(train)
    if train:      # whole (image, channel) maps dropped, about half of them
        assert 0.2 < dropout.masks[0].mean() < 0.8

    model.square_source = helpers.TorchSquareReplay(draws)
    model.dropout_source = helpers.MaskReplay(dropout.masks)
    model.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    (g,) = torch.autograd.grad((logits * torch.from_numpy(u)).sum(), [xt])
    assert model.dropout_source.calls == int(train)
    # float32 convolutions and products of two libraries: measured 1e-6 on
    # logits of order 1, and 2e-6 of the largest input gradient
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=1e-5 * max(1.0, np.abs(logits_j).max()))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g.numpy(), g_j, atol=1e-4 * np.abs(g_j).max())


def test_fc1_rows_follow_torch_flatten():
    """JAX's Dense_0 kernel rows are in NHWC (h, w, c) order, the port's
    fc1 columns in (c, h, w) order: pinned on named entries, and a feature
    map flattened either way gives the same fc1 output."""
    _, params, _, model = _models("Net2")
    k = np.asarray(params["Dense_0"]["kernel"])            # (4*4*64, 1024)
    w = model.fc1.weight.detach().numpy()                   # (1024, 64*4*4)
    for c, h, ww in ((0, 0, 0), (5, 1, 2), (63, 3, 3)):
        np.testing.assert_array_equal(w[:, c * 16 + h * 4 + ww], k[h * 4 * 64 + ww * 64 + c])
    fmap = np.random.default_rng(0).random((2, 64, 4, 4)).astype(np.float32)
    # the same 1024 products summed in two orders: ~1e-6 on values of order 1
    np.testing.assert_allclose(fmap.reshape(2, -1) @ w.T,
                               fmap.transpose(0, 2, 3, 1).reshape(2, -1) @ k, atol=1e-5)


@pytest.mark.parametrize("method", ["AT", "ALP", "TRADES"])
def test_net2_train_step_matches_jax(monkeypatch, method):
    """One train step of Net2 with JAX's dropout masks replayed: x_adv
    (share of pixels off JAX's), then on JAX's x_adv the loss, top-1, the
    parameters and the momentum (no BatchNorm: nothing drifts, JAX_TOL
    holds); and the port's float64 step on the same draws."""
    port, jax_side, port64 = helpers.train_step_pair(
        monkeypatch, method=method, arch="Net2", float64=True, shape=SHAPE,
        num_classes=10, beta=1.0)
    helpers.assert_matches_float64(port, port64, dict(share=1e-3, params=1e-4,
                                                      running=1e-5, momentum=1e-3))
    helpers.assert_train_steps_agree(port, jax_side, arch="Net2")


def test_net2_ee_square_takes_the_configs_epsilon():
    cfg = load_config(os.path.join(CONFIGS, "ee_at_bpda3_square.yml"), {})
    model = build_model(cfg["arch"], cfg, 10)
    assert model.ee.square and model.ee.epsilon == 0.3 and model.ee.r == 4
    assert model.fc2.out_features == 10


def test_net2_checkpoints_cross_the_jax_converter_both_ways(tmp_path):
    """port checkpoint -> the JAX converter (reference format, NCHW fc1) ->
    JAX's trees equal the ones the port's weights came from; JAX's trees ->
    its --to-torch state_dict -> the port's restore equals the port's
    conversion. A Net2 has no BatchNorm: batch_stats stay empty."""
    _, params, bs, model = _models("Net2")
    assert bs == {} or not jax.tree.leaves(bs)
    state = create_train_state(model)
    path = ckpt.save_checkpoint(str(tmp_path), state, 1, "Net2", 9.0, False,
                                OptimConfig(), 0.1)
    payload = ckpt.load_checkpoint(path)
    sd = {k: v.numpy() for k, v in payload["state_dict"].items()}
    zeros = jax.tree.map(jnp.zeros_like, params)
    back, _, n, _ = conv.convert(sd, conv.mnist_name_map(), zeros, {})
    assert n == 8
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    exported = conv.params_to_torch_state_dict(params, {}, conv.mnist_name_map())
    other = build_model("Net2", {}, 10, generator=torch.Generator().manual_seed(5))
    state2, epoch, _ = ckpt.restore_into_state(
        create_train_state(other), {"state_dict": exported, "epoch": 3, "best_prec1": 0.0})
    assert epoch == 3
    want = arch_state_dict_from_jax("Net2", helpers.to_numpy_tree(params), {})
    for k, v in state2.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
