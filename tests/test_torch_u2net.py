"""The port's U2-Net (models/u2net.py) and the U2-NetP edge map of
resnet18_EE (type_canny u2netp, tiny_imagenet/ee_at_u2netp.yml) against the
JAX package's on the CPU, on the JAX model's weights carried over by
convert.py.

Train mode at these sizes (32 and 20 px, a few images) is ill-conditioned:
the deepest levels of every RSU pool down to 1 x 1 (20 px: 20 -> 10 -> 5
-> 3 -> 2 -> 1, the decoder upsampling 2 -> 3), so their BatchNorm
statistics come from a handful of values, and the input gradient of the
freshly initialised net reaches ~6e3. In float32 the port's input gradient
is 13% off its own float64 one in norm, and JAX's 55% (measured at 32 px,
8 images), while the two in float64 agree to 1e-10. So train mode is held
in float64 on both sides (JAX under jax.enable_x64) to F64_TOL, and eval mode,
which is well conditioned, in float32 to F32_TOL.
"""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import u2net as ju2
from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu_torch.convert import state_dict_from_jax, u2net_state_dict_from_jax
from edge_enhancement_tpu_torch.models import u2net as tu2
from edge_enhancement_tpu_torch.models.registry import build_model

F64_TOL = 1e-8
# eval-mode float32: outputs in (0, 1) and input gradients of order 0.1
# (measured 6e-7 on the logits of resnet18_EE at 20 px)
F32_TOL = 2e-5


def _variables(full, shape):
    """The JAX U2Net and its flax-initialised variables as numpy, the
    running statistics moved off (0, 1) so that they matter in eval mode."""
    model = ju2.U2Net(full=full)
    v = jax.jit(lambda k: model.init(k, jnp.zeros(shape), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def stat(path, a):
        a = np.array(a)
        if path[-1].key == "mean":
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    return (model, helpers.to_numpy_tree(v["params"]),
            jax.tree_util.tree_map_with_path(stat, v["batch_stats"]))


def _inputs(shape, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.random(shape).astype(np.float32),
            rng.standard_normal(shape[:3] + (1,)).astype(np.float32))


def _port(params, stats, full=False, dtype=torch.float32):
    model = tu2.U2Net(full=full)
    model.load_state_dict(u2net_state_dict_from_jax(params, stats))
    return model.to(dtype)


def _port_run(model, x, u, train, dtype):
    """Fused map, input gradient and state_dict of one forward."""
    model.train(train)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_()
    out = model(xt)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.from_numpy(u.transpose(0, 3, 1, 2).copy()).to(dtype)).sum().backward()
    return (out.detach().permute(0, 2, 3, 1).double().numpy(),
            xt.grad.permute(0, 2, 3, 1).double().numpy(), model.state_dict())


def _jax_run(model, params, stats, x, u, train):
    """The fused map, its input gradient against u and the moved
    statistics, in one compiled function."""
    def loss(a):
        out, upd = model.apply({"params": params, "batch_stats": stats}, a, train=train,
                               mutable=["batch_stats"])
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * jnp.asarray(u)), (out, upd)
    (_, (out, upd)), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad), upd["batch_stats"]


@pytest.mark.parametrize("px", [32, 20])
def test_u2netp_train_mode_matches_jax_in_float64(px):
    """Train mode: the fused map, the input gradient and every running
    statistic, both sides in float64."""
    shape = (4, px, px, 3)
    x, u = _inputs(shape)
    model, params, stats = _variables(False, shape)
    with jax.enable_x64(True):
        wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
        params, stats = wide(params), wide(stats)
        out_j, g_j, stats_j = _jax_run(model, params, stats, x.astype(np.float64),
                                       u.astype(np.float64), True)
        stats_j = jax.tree.map(np.asarray, stats_j)
    port = _port(params, stats, dtype=torch.float64)
    out, g, sd = _port_run(port, x, u, True, torch.float64)
    np.testing.assert_allclose(out, out_j, atol=F64_TOL, rtol=0)
    # gradients up to ~1e4 (measured 8e-4 off at one element of 1e4)
    scale = np.abs(g_j).max()
    np.testing.assert_allclose(g, g_j, atol=10 * F64_TOL * scale, rtol=0)
    want = u2net_state_dict_from_jax(params, stats_j)
    moved = 0
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.double().numpy(), atol=1e-6, err_msg=k)
            moved += not np.allclose(v.numpy(), u2net_state_dict_from_jax(params, stats)[k].numpy())
    assert moved == len([k for k in want if k.endswith("running_mean")]) * 2


@pytest.mark.parametrize("px", [32, 20])
def test_u2netp_eval_mode_matches_jax(px):
    shape = (2, px, px, 3)
    x, u = _inputs(shape, seed=3)
    model, params, stats = _variables(False, shape)
    out_j, g_j, _ = _jax_run(model, params, stats, x, u, False)
    out, g, _ = _port_run(_port(params, stats), x, u, False, torch.float32)
    np.testing.assert_allclose(out, out_j, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(g, g_j, atol=F32_TOL * max(1.0, np.abs(g_j).max()), rtol=0)
    assert 0.0 < out.min() and out.max() < 1.0 and np.abs(g_j).max() > 1e-3


def test_u2net_full_returns_seven_maps_as_jax():
    """U2NET (the full net, 44M parameters) in eval mode: all seven sigmoid
    maps, the fused one first."""
    shape = (1, 32, 32, 3)
    x, _ = _inputs(shape, seed=4)
    model, params, stats = _variables(True, shape)
    outs_j = jax.jit(lambda a: model.apply({"params": params, "batch_stats": stats}, a,
                                           train=False))(jnp.asarray(x))
    port = _port(params, stats, full=True).eval()
    with torch.no_grad():
        outs = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(outs) == len(outs_j) == 7
    for o, oj in zip(outs, outs_j):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(oj),
                                   atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("src,tar", [((2, 2), (3, 3)), ((1, 1), (2, 2)), ((5, 5), (10, 10)),
                                     ((3, 2), (5, 3))])
def test_upsample_like_is_jax_resize(src, tar):
    """Bilinear upsampling with half-pixel centres, the 2 -> 3 of ceil
    pooling included: F.interpolate(align_corners=False) is
    jax.image.resize's bilinear on an upsample."""
    a = np.random.default_rng(5).standard_normal((2, *src, 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(a), (2, *tar, 4), method="bilinear")
    got = tu2._upsample_like(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()),
                             torch.zeros((1, 1, *tar)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(5, 5), (4, 7), (1, 1)])
def test_pool_ceil_matches_jax(hw):
    a = np.random.default_rng(6).standard_normal((2, *hw, 3)).astype(np.float32)
    want = ju2._pool_ceil(jnp.asarray(a))
    got = tu2._pool_ceil(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_sobel_magnitude_matches_jax():
    a = np.random.default_rng(7).random((2, 9, 11, 1)).astype(np.float32)
    got = tu2.sobel_magnitude(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ju2.sobel_magnitude(jnp.asarray(a))),
                               atol=1e-6, rtol=0)


def test_converter_carries_the_u2net_subtree():
    """A built JAX resnet18_EE with type_canny u2netp names its U-Net
    U2Net_0: state_dict_from_jax carries every tensor of it, under the
    reference's names, and the port's logits are JAX's in eval mode at 20
    px (the non-2x upsampling)."""
    args = dict(helpers.EE_ARGS, type_canny="u2netp")
    jm = jax_build_model("resnet18_EE", args, 200)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 20, 3)),
                                            train=False))
    assert "U2Net_0" in shapes["params"]
    params, stats = (helpers.random_variables(shapes[k], np.random.default_rng(8), 0.1)
                     for k in ("params", "batch_stats"))
    sd = state_dict_from_jax(params, stats)
    model = build_model("resnet18_EE", args, 200)
    assert sorted(sd) == sorted(model.state_dict())
    assert "u2net.stage1d.rebnconv1d.bn_s1.running_var" in sd and "u2net.outconv.bias" in sd
    model.load_state_dict(sd)
    x = np.random.default_rng(9).random((2, 20, 20, 3)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda a: jm.apply({"params": params, "batch_stats": stats},
                                                 a, train=False))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(want).max() > 0.1


def test_u2netp_init_is_flax_default():
    """The U2-NetP inside resnet18_EE keeps flax's init (lecun-normal
    kernels, zero biases, BatchNorm 1 / 0), not the ResNet's."""
    model = build_model("resnet18_EE", dict(helpers.EE_ARGS, type_canny="u2netp"), 200,
                        generator=torch.Generator().manual_seed(0))
    conv = model.u2net.stage1.rebnconv2.conv_s1          # 16 -> 16 channels, 3x3
    assert conv.bias.abs().max() == 0
    std = float(conv.weight.detach().std())
    assert abs(std - (1 / (16 * 9)) ** 0.5) < 0.1 * std
    assert float(conv.weight.detach().abs().max()) <= 2 * (1 / (16 * 9)) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(model.u2net.stage1.rebnconv2.bn_s1.weight, torch.ones(16))
    assert build_model("u2netp", {}, 1).outconv.in_channels == 6
    assert len(build_model("u2net", {}, 1).eval()(torch.rand(1, 3, 16, 16))) == 7


def test_ee_at_u2netp_train_step(monkeypatch):
    """One EE_AT step of ee_at_u2netp.yml (a one-iteration attack) on
    carried weights and replayed draws. The step is ill-conditioned at this
    size (see the module docstring): the freshly initialised U-Net's
    parameter gradients are so large that one step moves its weights by up
    to ~10 (JAX) or ~40 (the port's own float64 step) times 1 + |w| apart,
    and the attacks part on 24% of x_adv. What stays conditioned is held
    against JAX: the loss on the same x_adv (measured 2.1e-4 relative) and
    the U-Net's running statistics (measured 4.5e-4); the parameters and
    momentum are finite and the statistics moved. The float64 train-mode
    comparison above is where the U2-NetP is held tightly."""
    ee_args = dict(helpers.EE_ARGS, type_canny="u2netp")
    (m, state, model, _), (m_j, state_j, _) = helpers.train_step_pair(
        monkeypatch, ee_args=ee_args, method="EE_AT", arch="resnet18_EE",
        pgd_steps=1)
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-3)
    sd = model.state_dict()
    want = state_dict_from_jax(helpers.to_numpy_tree(state_j.params),
                               helpers.to_numpy_tree(state_j.batch_stats))
    assert sorted(sd) == sorted(want)
    for k, v in sd.items():
        assert torch.isfinite(v).all(), k
        if k.startswith("u2net.") and k.endswith("running_mean"):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=5e-3, err_msg=k)
            assert v.abs().max() > 0
    assert all(torch.isfinite(b).all() for b in state.momentum_buf)
