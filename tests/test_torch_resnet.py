"""The port's ResNet-18 (resnet18_EE_square) on weights carried over from
the JAX model: train- and eval-mode logits, the BatchNorm running
statistics (flax's biased-variance rule), and the weight conversion."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.models.resnet import BatchNorm2d

# batch 4: at 32 px layer4 is 1x1, so its batch statistics come from B values
# per channel; with B = 2 they amplify float32 differences (flax computes
# E[x^2] - E[x]^2, torch a two-pass variance) to ~5e-2 in the logits
SHAPE = (4, 32, 32, 3)


def test_logits_and_running_stats(monkeypatch):
    ops, params, bs, model = helpers.jax_and_port_models(SHAPE)
    draws = helpers.square_draws(2, SHAPE)
    monkeypatch.setattr(jee, "add_square", helpers.JaxSquareReplay(draws))
    model.square_source = helpers.TorchSquareReplay(draws)
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)

    logits_j, bs_j = jax.jit(ops.logits_train)(params, bs, jnp.asarray(x),
                                               jax.random.PRNGKey(1))
    model.train()
    logits = model(torch.from_numpy(x))
    # batch-statistic BN over 4 values per channel at layer4 (see SHAPE):
    # measured 1.8e-4 on logits of magnitude ~5
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               atol=5e-4, rtol=1e-4)
    sd = model.state_dict()
    want = state_dict_from_jax(helpers.to_numpy_tree(params), helpers.to_numpy_tree(bs_j))
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)

    logits_e = np.asarray(jax.jit(ops.logits_eval)(params, bs_j, jnp.asarray(x),
                                                   jax.random.PRNGKey(2)))
    model.eval()
    with torch.no_grad():
        # running statistics: float32 conv stacks of two libraries (5e-7 measured)
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), logits_e,
                                   atol=1e-5, rtol=1e-5)


def test_batchnorm_running_var_is_biased():
    """flax moves running_var toward the biased batch variance; torch's own
    BatchNorm uses the unbiased one (1.0443 vs 1.0353 on this batch)."""
    import flax.linen as fnn
    x = np.random.default_rng(3).standard_normal((4, 2, 2, 3)).astype(np.float32) * 1.7
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(3).train()
    y = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), atol=1e-7)
    unbiased = 0.9 + 0.1 * x.reshape(-1, 3).var(axis=0, ddof=1)
    assert np.abs(port.running_var.numpy() - unbiased).max() > 1e-4


def test_state_dict_matches_tools_converter(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), "..", "tools"))
    from convert_torch_checkpoint import params_to_torch_state_dict, resnet_name_map
    _, params, bs, model = helpers.jax_and_port_models(SHAPE, arch="resnet18")
    got = state_dict_from_jax(helpers.to_numpy_tree(params), helpers.to_numpy_tree(bs))
    want = params_to_torch_state_dict(params, bs, resnet_name_map(18))
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_init_statistics():
    """conv N(0, 2/fan_out), Dense lecun-normal, BN 1/0, zero Dense bias."""
    model = build_model("resnet18", {}, 200, generator=torch.Generator().manual_seed(0))
    w = model.layer3[0].conv1.weight
    assert abs(w.std().item() / np.sqrt(2.0 / (256 * 9)) - 1) < 0.02
    fc = model.fc.weight
    assert abs(fc.std().item() * np.sqrt(512) - 1) < 0.02
    assert fc.abs().max().item() <= 2 * np.sqrt(1 / 512) / 0.87962566103423978
    assert model.fc.bias.abs().max().item() == 0.0
    assert (model.bn1.weight == 1).all() and (model.bn1.bias == 0).all()


# depths the JAX package lacks
@pytest.mark.parametrize("arch,args", [("resnet200", {}), ("PreActResNet200", {})])
def test_unported_models_raise(arch, args):
    with pytest.raises(NotImplementedError):
        build_model(arch, args, 200)


# resnet18_EE's default front-end (the full Canny) and the denoising
# ResNets run under the bf16 policy (tests/test_torch_frontend_variants.py
# and tests/test_torch_model_zoo.py hold them to JAX)
@pytest.mark.parametrize("arch,args", [("resnet18_EE", {"half": True}),
                                       ("resnet50_fd", {"dtype": "bfloat16"})])
def test_bf16_policy_models_run(arch, args):
    model = build_model(arch, args, 200, generator=torch.Generator().manual_seed(0))
    assert model.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32))
    # train mode: on the initial running statistics (0 and 1) the denoising
    # blocks' cubic terms overflow in eval mode, in float32 too
    logits = model.train()(x)
    assert logits.dtype == torch.float32 and logits.shape == (2, 200)
    assert bool(torch.isfinite(logits).all())
