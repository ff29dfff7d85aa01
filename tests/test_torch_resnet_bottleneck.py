"""The port's Bottleneck ResNets and the bf16 policy against the JAX
models: one Bottleneck block against flax's, resnet50_EE (10 classes) on
weights carried across by state_dict_from_jax in float32 and under the
bf16 policy, BatchNorm in bfloat16 against flax's, and the depths 34 to
152. The parameters are drawn with numpy on the tree jax.eval_shape gives
(no compile of the init): the JAX init's distributions for the ResNets;
for the single block, BatchNorm statistics and affine terms away from 1
and 0."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

import torch_port_helpers as helpers
from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.models.resnet import Bottleneck as JaxBottleneck
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu.train.modelops import cross_entropy as jax_ce
from edge_enhancement_tpu_torch.convert import resnet_name_map, state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.models.resnet import BatchNorm2d, Bottleneck
from edge_enhancement_tpu_torch.ops.cuda.ee_fused import bf16_ulps

ARGS = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
            type_canny="CannyFilter_step125_1", fused_canny=True)
# 128 px, batch 2: layer4 is 4 x 4, so train-mode BatchNorm there normalises
# 32 values a channel. At 32 px it would normalise 2 (layer4 1 x 1): the
# input gradient then reaches 6e7 and the logits differ by 2.5 between any
# two float32 implementations, so 32 px is no test of the train mode.
SHAPE = (2, 128, 128, 3)
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def r50():
    """(JAX ModelOps, params, batch_stats) of resnet50_EE, 10 classes."""
    ops = JaxModelOps(jax_build_model("resnet50_EE", ARGS, 10))
    shapes = jax.eval_shape(ops.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params, stats = helpers.random_variables(shapes, np.random.default_rng(0))
    return ops, params, stats


def _port(params, stats, half=False):
    model = build_model("resnet50_EE", {**ARGS, "half": half}, 10)
    model.load_state_dict(state_dict_from_jax(params, stats, 50))
    return model


def _inputs(size: int = SHAPE[1]):
    rng = np.random.default_rng(1)
    return (rng.random((SHAPE[0], size, size, 3)).astype(np.float32),
            np.array([3, 7], np.int32))


def test_resnet50_ee_matches_jax_in_float32(r50):
    """Train mode: logits, running statistics and the input gradient; eval
    mode: logits."""
    ops, params, stats = r50
    x, y = _inputs()

    def train_grad(p, s, v):
        def loss(a):
            logits, s2 = ops.logits_train(p, s, a, jax.random.PRNGKey(1))
            return jax_ce(logits, jnp.asarray(y)), (logits, s2)
        (_, (logits, s2)), g = jax.value_and_grad(loss, has_aux=True)(v)
        return logits, s2, g, ops.logits_eval(p, s, v, jax.random.PRNGKey(2))

    lj, sj, gj, lej = jax.jit(train_grad)(params, stats, jnp.asarray(x))
    model = _port(params, stats)
    with torch.no_grad():
        le = model.eval()(torch.from_numpy(x))
    # eval mode: float32 convolution stacks of two libraries
    np.testing.assert_allclose(le.numpy(), np.asarray(lej), atol=1e-4, rtol=1e-5)
    model.train()
    xt = torch.from_numpy(x).requires_grad_()
    lt = model(xt)
    torch.nn.functional.cross_entropy(lt, torch.from_numpy(y).long()).backward()
    # train mode: flax normalises with E[x^2] - E[x]^2 statistics, the port
    # with two-pass ones. The port in float64 is the referee: the port's
    # float32 logits lie within tests/test_torch_resnet.py's tolerance of
    # it (1.5e-4 measured), JAX's 2.9e-3 from it
    m64 = _port(params, stats).double().train()
    with torch.no_grad():
        l64 = m64(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(lt.detach().numpy(), l64, atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=5e-3, rtol=1e-4)
    # the running statistics likewise, JAX's off by the normalisation of the
    # layers before (2.1e-4 relative at most measured)
    sd = model.state_dict()
    want = state_dict_from_jax(params, jax.tree.map(np.asarray, sj), 50)
    sd64 = m64.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), sd64[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=k)
    # the input gradient of a float32 ResNet-50 at this size sums large
    # terms that cancel in layer4's backward: the port's lies 2.2% of its
    # largest entry from its float64 one, JAX's 8.2% (measured on this input)
    gj = np.asarray(gj)
    assert 0 < np.abs(xt.grad.numpy() - gj).max() <= 0.1 * np.abs(gj).max()


def test_resnet50_ee_matches_jax_under_the_bf16_policy(r50):
    """Eval-mode logits (returned as float32) and input gradient of the
    bf16-policy models, at 64 px (eval mode has no batch statistics). Both
    round every convolution's, BatchNorm's and the
    head's output to bfloat16 after float32 sums in other orders, so the
    yardstick is bfloat16 itself: the two bf16 models may lie at most twice
    as far apart as the port's bf16 model lies from its float32 one (two
    independent roundings of one function lie ~1.4 times as far apart)."""
    ops, params, stats = r50
    ops_b = JaxModelOps(jax_build_model("resnet50_EE", {**ARGS, "half": True}, 10))
    x, y = _inputs(64)

    def eval_grad(p, s, v):
        f = lambda a: ops_b.logits_eval(p, s, a, jax.random.PRNGKey(2))
        return f(v), jax.grad(lambda a: jax_ce(f(a), jnp.asarray(y)))(v)

    lj, gj = jax.jit(eval_grad, compiler_options=EXACT_ROUNDING)(params, stats,
                                                                 jnp.asarray(x))
    assert lj.dtype == jnp.float32
    outs = {}
    for half in (True, False):
        model = _port(params, stats, half=half).eval()
        xt = torch.from_numpy(x).requires_grad_()
        logits = model(xt)
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long()).backward()
        outs[half] = (model, logits.detach().numpy(), xt.grad.numpy())
    model, logits, grad = outs[True]
    assert model.dtype == torch.bfloat16 and model.conv1.weight.dtype == torch.float32
    assert logits.dtype == np.float32 and np.abs(np.asarray(gj)).max() > 0
    for got, want, f32 in ((logits, np.asarray(lj), outs[False][1]),
                           (grad, np.asarray(gj), outs[False][2])):
        yardstick = np.abs(got - f32).max()
        assert 0 < yardstick
        assert np.abs(got - want).max() <= 2 * yardstick


def _block_tree(jax_params, jax_stats):
    """The flax Bottleneck's variables as the port block's state_dict."""
    names = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
             "Conv_3": "downsample.0", "BatchNorm_0": "bn1", "BatchNorm_1": "bn2",
             "BatchNorm_2": "bn3", "BatchNorm_3": "downsample.1"}
    sd = {}
    for flax_name, name in names.items():
        p = {k: torch.from_numpy(np.array(v)) for k, v in jax_params[flax_name].items()}
        if "kernel" in p:
            sd[name + ".weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous()
        else:
            s = jax_stats[flax_name]
            sd.update({name + ".weight": p["scale"], name + ".bias": p["bias"],
                       name + ".running_mean": torch.from_numpy(np.array(s["mean"])),
                       name + ".running_var": torch.from_numpy(np.array(s["var"]))})
    return sd


@pytest.mark.parametrize("train", [True, False])
def test_bottleneck_block_matches_flax(train):
    """One Bottleneck (8 -> 4 x 4 planes, stride 2, so with its projection):
    output, running statistics, input and parameter gradients."""
    block_j = JaxBottleneck(planes=4, stride=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8, 8, 8)).astype(np.float32)
    shapes = jax.eval_shape(lambda: block_j.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params, stats = helpers.random_variables((shapes["params"], shapes["batch_stats"]), rng, 0.1)
    cot = rng.standard_normal((4, 4, 4, 16)).astype(np.float32)

    def f(p, v):
        out, upd = block_j.apply({"params": p, "batch_stats": stats}, v, train=train,
                                 mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    (_, (out_j, upd)), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    block = Bottleneck(8, 4, stride=2)
    block.load_state_dict(_block_tree(params, stats))
    block.train(train)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = block(xt)
    (out * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx),
                               atol=1e-5, rtol=1e-5)
    want = _block_tree(gp, upd["batch_stats"] if train else stats)
    got = dict(block.named_parameters())
    for k, v in block.state_dict().items():
        if k in got:            # parameter gradients
            np.testing.assert_allclose(got[k].grad.numpy(), want[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
        else:                   # running statistics
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_in_bf16_computes_as_flax(train):
    """flax's BatchNorm(dtype=bf16): statistics reduced from x in float32
    (flax's _compute_stats promotes to at least float32), the output
    normalised in float32 with the float32 scale and bias (_normalize) and
    rounded to bfloat16 once; running statistics float32."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 3, 3, 5)) * 1.7 + 0.4).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    v = bn.init(jax.random.PRNGKey(0), xb)
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.standard_normal(5)
    mean, var = rng.standard_normal(5) * 0.3, rng.uniform(0.5, 2.0, 5)
    v = {"params": {"scale": jnp.asarray(scale, jnp.float32),
                    "bias": jnp.asarray(bias, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                         "var": jnp.asarray(var, jnp.float32)}}
    y_j, upd = bn.apply(v, xb, mutable=["batch_stats"])
    assert y_j.dtype == jnp.bfloat16
    port = BatchNorm2d(5).train(train)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            t.copy_(torch.from_numpy(a.astype(np.float32)))
    y = port(torch.from_numpy(np.asarray(xb.astype(jnp.float32)).transpose(0, 3, 1, 2)
                              .copy()).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and port.running_var.dtype == torch.float32
    y_j = torch.from_numpy(np.asarray(y_j.astype(jnp.float32)).transpose(0, 3, 1, 2).copy())
    # one rounding of float32 values that differ in their last bits
    assert bf16_ulps(y, y_j).max() <= 1
    stats_j = upd["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats_j["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats_j["var"]),
                               rtol=1e-5)


# torchvision's parameter counts at 1000 classes
@pytest.mark.parametrize("depth,count", [(34, 21797672), (50, 25557032),
                                         (101, 44549160), (152, 60192808)])
def test_every_depth_builds_and_converts(depth, count):
    model = build_model(f"resnet{depth}", {}, 1000,
                        generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == count
    names = resnet_name_map(depth)
    modules = {n for n, m in model.named_modules() if list(m.parameters(recurse=False))}
    assert modules <= set(names)
    # a projection only where the block changes shape: one per layer group,
    # but layer1 of the BasicBlock nets (64 -> 64, stride 1)
    assert sum(n.endswith("downsample.0") for n in modules) == (3 if depth == 34 else 4)


def test_the_half_key_selects_the_bf16_policy():
    for args in ({"half": True}, {"dtype": "bf16"}, {"dtype": "bfloat16"}):
        assert build_model("resnet50_EE", {**ARGS, **args}, 10).dtype == torch.bfloat16
    assert build_model("resnet50_EE", ARGS, 10).dtype is None
