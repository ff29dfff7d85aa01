"""The rest of the port's model zoo against the JAX package's on carried
weights: the feature-denoising ResNet-18 (`resnet18_fd`), PreActResNet18
with the CIFAR stem and with the Tiny-ImageNet stem, and its `_EE`,
`_EE_BPDA` and `_EE_BPDA_3` variants, each in train mode (logits, the
BatchNorm running statistics it moves, the input gradient); the
registry's rules (the PreAct EE Canny from the suffix, the class count
from the dataset); and the port's checkpoints through the JAX package's
converter. Batches of 4 at 64 px (CIFAR's stem at 32 px)."""

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
from edge_enhancement_tpu_torch.convert import arch_state_dict_from_jax
from edge_enhancement_tpu_torch.models.batchnorm import BatchNorm2d
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train import checkpoint as ckpt
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from tools import convert_torch_checkpoint as conv  # noqa: E402

SHAPE, CIFAR_SHAPE = (4, 64, 64, 3), (4, 32, 32, 3)
# the AWP configs' front-end (configs/awp_tiny_imagenet/ee_*_at_awp.yml)
AWP_EE = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
              epsilon=16 / 255, dataset="tiny_imagenet")
# arch, config keys, classes; the CIFAR stem at its own 32 px (SHAPE's 64 px
# through its undownsampled layer1 is 4 times the work)
CASES = {
    "resnet18_fd": ("resnet18_fd", dict(dataset="imagenet"), 1000),
    "preact_cifar": ("PreActResNet18", dict(dataset="cifar100",
                                             dataset_variant="CIFAR100"), 100),
    "preact_tiny": ("PreActResNet18", dict(dataset="tiny_imagenet"), 200),
    "preact_ee": ("PreActResNet18_EE", AWP_EE, 200),
    "preact_ee_bpda": ("PreActResNet18_EE_BPDA", AWP_EE, 200),
    "preact_ee_bpda_3": ("PreActResNet18_EE_BPDA_3", AWP_EE, 200),
}


# float64 on both sides, relative to the largest value: (logits, input
# gradient, running statistics). Both models hand back float32 logits (their
# last cast). The plain PreActResNets agree to rounding (measured 0 and
# 4e-14). JAX's denoising block sums its Gram products in float32
# (preferred_element_type) and JAX's front-end builds its HFS operators in
# float32, so those models' float64 runs part at ~1e-7, which train-mode
# BatchNorm lifts to 2.6e-6 on the denoising ResNet's logits and gradient
# and to 1.5e-6 on the EE logits; the EE input gradient, through the batch
# statistics' backward, to 2.6e-3-6.1e-3 of its largest value (the front
# ends alone agree to 4e-7 in float64 and to rounding in float32,
# tests/test_torch_frontend_variants.py).
F64_TOL = {"resnet18_fd": (1e-5, 2e-5, 1e-5), "preact_cifar": (1e-6, 1e-9, 1e-7),
           "preact_tiny": (1e-6, 1e-9, 1e-7), "preact_ee": (1e-5, 1e-2, 1e-5),
           "preact_ee_bpda": (1e-5, 1e-2, 1e-5), "preact_ee_bpda_3": (1e-5, 1e-2, 1e-5)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_mode_forward_matches_jax_in_float64(case):
    """Logits, input gradient and running statistics of one train-mode
    forward, both sides in float64 (JAX under jax.enable_x64): batch
    statistics make float32 train mode ill-conditioned at test sizes
    (measured in float32 at this shape: the EE input gradients 4.6% of
    their largest value apart; at 2 x 32 x 32, 1.2 of 4 on the denoising
    ResNet's logits)."""
    arch, args, n = CASES[case]
    shape = CIFAR_SHAPE if case == "preact_cifar" else SHAPE
    tol_logits, tol_grad, tol_stats = F64_TOL[case]
    ops_j, params, bs, model = helpers.jax_and_port_models(
        shape, arch=arch, ee_args=args, num_classes=n)
    rng = np.random.default_rng(0)
    x = rng.random(shape)
    u = rng.standard_normal((shape[0], n))
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    with jax.enable_x64(True):
        def f(xx):
            logits, stats = ops_j.logits_train(wide(params), wide(bs), xx,
                                               jax.random.PRNGKey(1))
            return jnp.sum(logits * u), (logits, stats)
        (_, (logits_j, stats_j)), g_j = jax.jit(jax.value_and_grad(f, has_aux=True))(
            jnp.asarray(x))
        logits_j, g_j, stats_j = np.asarray(logits_j), np.asarray(g_j), wide(stats_j)
    assert g_j.dtype == np.float64

    model.double().train()
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    assert logits.shape == (shape[0], n)
    (g,) = torch.autograd.grad((logits * torch.from_numpy(u)).sum(), [xt])
    assert logits.dtype == torch.float32 and logits_j.dtype == np.float32
    np.testing.assert_allclose(logits.detach().numpy(), logits_j,
                               atol=tol_logits * np.abs(logits_j).max())
    np.testing.assert_allclose(g.numpy(), g_j, atol=tol_grad * np.abs(g_j).max())
    want = arch_state_dict_from_jax(arch, helpers.to_numpy_tree(params), stats_j, args)
    sd = model.state_dict()
    assert sorted(sd) == sorted(want)
    running = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert running
    for k in running:    # the converter rounds JAX's values to float32
        w = want[k].double().numpy()
        np.testing.assert_allclose(sd[k].numpy(), w, err_msg=k,
                                   atol=max(1e-7, tol_stats * np.abs(w).max()))


def test_registry_rules():
    """PreAct EE: the Canny from the suffix whatever type_canny says; the
    stem, head and class count from dataset_variant / dataset, whatever
    num_classes says; Net2 has 10 classes; fd puts a block after each
    layer group."""
    with torch.device("meta"):
        m = build_model("PreActResNet18_EE_BPDA_3", dict(AWP_EE, type_canny="CannyFilter"), 7)
        assert m.ee.type_canny == "CannyFilter_step125_1" and m.fc.out_features == 200
        m = build_model("PreActResNet18_EE_BPDA", dict(AWP_EE, type_canny="u2netp"), 7)
        assert m.ee.type_canny == "CannyFilter_BPDA"
        m = build_model("PreActResNet18", dict(dataset="tiny_imagenet",
                                               dataset_variant="CIFAR100"), 200)
        assert m.cifar and m.linear.out_features == 100 and not hasattr(m, "bn1")
        assert m.conv1.kernel_size == (3, 3)
        m = build_model("PreActResNet18", dict(dataset="imagenet"), 7)
        assert m.fc.out_features == 1000 and m.conv1.kernel_size == (7, 7)
        assert build_model("PreActResNet50", dict(dataset="cifar10"), 7).linear.in_features == 2048
        assert build_model("Net2", {}, 200).fc2.out_features == 10
        m = build_model("resnet18_fd", {}, 1000)
        assert [m.denoise1.conv3.in_channels, m.denoise4.conv3.in_channels] == [64, 512]


@pytest.mark.parametrize("case", ["resnet18_fd", "preact_tiny"])
def test_checkpoints_cross_the_jax_converter(tmp_path, case):
    """The port's checkpoint of carried weights, read by the JAX package's
    converter with its name map, gives JAX's trees back bit for bit; and
    JAX's --to-torch state_dict restores into the port."""
    arch, args, n = CASES[case]
    _, params, bs, model = helpers.jax_and_port_models(SHAPE, arch=arch, ee_args=args,
                                                       num_classes=n)
    path = ckpt.save_checkpoint(str(tmp_path), create_train_state(model), 1, arch,
                                0.0, False, OptimConfig(), 0.1)
    sd = {k: v.numpy() for k, v in ckpt.load_checkpoint(path)["state_dict"].items()}
    name_map = conv.name_map_for_arch(arch)
    zeros = jax.tree.map(jnp.zeros_like, (params, bs))
    back_p, back_s, _, _ = conv.convert(sd, name_map, *zeros)
    for a, b in zip(jax.tree.leaves((back_p, back_s)), jax.tree.leaves((params, bs))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    exported = conv.params_to_torch_state_dict(params, bs, name_map)
    other = build_model(arch, args, n, generator=torch.Generator().manual_seed(5))
    state, _, _ = ckpt.restore_into_state(create_train_state(other), {
        "state_dict": exported, "epoch": 1, "best_prec1": 0.0})
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), model.state_dict()[k].numpy(), err_msg=k)


# The denoising block under the bf16 policy against JAX's, train mode, on a
# bfloat16 input: its float32 output within FD_BLOCK_TOL of the largest
# value (measured 1.6e-5: the Gram products' float32 sums in another order
# round f to bfloat16 one ulp apart here and there) and its bfloat16 input
# gradient within FD_BLOCK_DX (measured 7.7e-3, one bfloat16 ulp).
FD_BLOCK_TOL, FD_BLOCK_DX = 1e-4, 2e-2


def test_denoising_block_under_bf16_matches_jax():
    """JAX's DenoisingBlock on a bfloat16 x sums its Gram products in
    float32, casts f to x's dtype, runs its 1x1 conv and BatchNorm with no
    dtype (so in float32, promoted against their parameters) and returns
    x + f in float32; the port's block does the same."""
    from edge_enhancement_tpu.models.resnet import DenoisingBlock as JaxBlock
    from edge_enhancement_tpu_torch.models.resnet import DenoisingBlock
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 32)).astype(np.float32)
    u = rng.standard_normal(x.shape).astype(np.float32)
    block = JaxBlock()
    v = block.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    p = helpers.to_numpy_tree(v["params"])
    p["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    p["BatchNorm_0"]["bias"] = rng.normal(0, 0.3, 32).astype(np.float32)
    p["Conv_0"]["bias"] = rng.normal(0, 0.3, 32).astype(np.float32)

    def f(a, cot):
        out, vjp = jax.vjp(lambda t: block.apply({"params": p, "batch_stats": v["batch_stats"]},
                                                 t, train=True, mutable=["batch_stats"])[0], a)
        return out, vjp(cot)[0]
    out_j, g_j = jax.jit(f, compiler_options={"xla_allow_excess_precision": False})(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(u))
    port = DenoisingBlock(32)
    with torch.no_grad():
        port.conv3.weight.copy_(torch.from_numpy(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1))
        port.conv3.bias.copy_(torch.from_numpy(p["Conv_0"]["bias"]))
        port.bn.weight.copy_(torch.from_numpy(p["BatchNorm_0"]["scale"]))
        port.bn.bias.copy_(torch.from_numpy(p["BatchNorm_0"]["bias"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16).requires_grad_()
    out = port(xt)
    out.backward(torch.from_numpy(u).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and out_j.dtype == jnp.float32
    assert xt.grad.dtype == torch.bfloat16 and g_j.dtype == jnp.bfloat16
    out_j = np.asarray(out_j).transpose(0, 3, 1, 2)
    g_j = np.asarray(g_j.astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out.detach().numpy(), out_j,
                               atol=FD_BLOCK_TOL * np.abs(out_j).max())
    np.testing.assert_allclose(xt.grad.float().numpy(), g_j,
                               atol=FD_BLOCK_DX * np.abs(g_j).max())


# Whole nets under the bf16 policy (`half: true`) against JAX's, jitted
# with exact bfloat16 rounding (xla_allow_excess_precision off, as
# tests/test_torch_frontend_variants.py), in eval mode on running
# statistics set to the batch's own (one float32 train-mode forward with
# momentum 0; from the initial 0 and 1 each denoising block's cubic term
# overflows). At the initial weights a random ResNet-18 in bfloat16 is
# ill-conditioned: its rounding error doubles at every layer group, to 95%
# of the largest logit. So the nets are made well conditioned first: each
# residual branch's last BatchNorm scale times RESIDUAL_GAIN and each
# denoising block's times DENOISE_GAIN (the zero-init-residual idea, short
# of zero). Then, relative to the largest value, (logits, input gradient):
#   resnet18_fd: measured 8.9e-3 (two bfloat16 ulps of the largest logit),
#     3.7e-2; a wholly float32 port reads 1.8e-2, 2.7e-1; one that leaves
#     the layer groups after a denoising block in float32 1.3e-2, 2.2e-1.
#   resnet18_EE + u2netp (the stem convolves the front-end's float32 output
#     in float32 and its BatchNorm rounds to bfloat16): measured 3.9e-3,
#     4.4e-3; a wholly float32 port 1.0e-2, 2.1e-1; a stem that does not
#     round at its BatchNorm 7.8e-3, 9.9e-2; one that convolves in bfloat16
#     7.8e-3, 1.3e-1.
# The head's bfloat16 product shows in the logits, which lie on the
# bfloat16 grid on both sides before the last cast (a float32 head's do
# not). Each case also holds that its own float32 run of the same weights
# misses the bound, so the bound tells the policy from no policy.
RESIDUAL_GAIN, DENOISE_GAIN = 0.05, 0.03
BF16_NET_TOL = {"resnet18_fd": (1.5e-2, 0.1), "resnet18_EE": (1e-2, 2e-2)}


def _bf16_net_against_jax(arch, args, n, shape, name_map, hooked):
    """The port's bf16-policy net and its float32 twin against JAX's at
    bfloat16 on the same well-conditioned weights: asserts the tolerances
    above and returns {module name: output dtype} for `hooked`."""
    ops_j, params, bs, model = helpers.jax_and_port_models(
        shape, arch=arch, ee_args=dict(args, half=True), num_classes=n)
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    u = rng.standard_normal((shape[0], n)).astype(np.float32)
    f32 = build_model(arch, args, n)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.startswith("layer") and k.endswith("bn2.weight"):
            v *= RESIDUAL_GAIN
        elif k.startswith("denoise") and k.endswith("bn.weight"):
            v *= DENOISE_GAIN
    f32.load_state_dict(sd)
    for m in f32.modules():
        if isinstance(m, BatchNorm2d):
            m.momentum = 0.0
    with torch.no_grad():
        f32.train()(torch.from_numpy(x))
    model.load_state_dict(f32.state_dict())
    params, bs, _, _ = conv.convert({k: v.numpy() for k, v in f32.state_dict().items()},
                                    name_map, *jax.tree.map(jnp.zeros_like, (params, bs)))

    def f(xx):
        logits = ops_j.logits_eval(params, bs, xx, jax.random.PRNGKey(1))
        return jnp.sum(logits * u), logits
    (_, logits_j), g_j = jax.jit(jax.value_and_grad(f, has_aux=True),
                                 compiler_options={"xla_allow_excess_precision": False})(
        jnp.asarray(x))
    logits_j, g_j = np.asarray(logits_j), np.asarray(g_j)
    dtypes = {}
    for name in hooked:
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: dtypes.__setitem__(name, o.dtype))

    def run(net):
        xt = torch.from_numpy(x).requires_grad_(True)
        logits = net.eval()(xt)
        (g,) = torch.autograd.grad((logits * torch.from_numpy(u)).sum(), [xt])
        return logits.detach().numpy(), g.numpy()
    (logits, g), (logits32, g32) = run(model), run(f32)
    assert model.dtype == torch.bfloat16
    assert logits.dtype == logits_j.dtype == np.float32
    assert np.isfinite(logits_j).all() and np.isfinite(g_j).all()

    def on_bf16_grid(a):
        return np.array_equal(a, torch.tensor(a).bfloat16().float().numpy())
    assert on_bf16_grid(logits_j) and on_bf16_grid(logits) and not on_bf16_grid(logits32)
    for got, want, own, tol in zip((logits, g), (logits_j, g_j), (logits32, g32),
                                   BF16_NET_TOL[arch]):
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max() / scale, tol)
        assert np.abs(own - want).max() > tol * scale
    return dtypes


def test_resnet18_fd_under_bf16_matches_jax():
    """The denoising ResNet under the bf16 policy, logits and input
    gradient against JAX's (BF16_NET_TOL above). Its blocks hand on
    float32, the next layer group and the head compute in bfloat16 again;
    the blocks alone are held tightly above."""
    dtypes = _bf16_net_against_jax(
        "resnet18_fd", dict(dataset="imagenet"), 1000, SHAPE,
        conv.name_map_for_arch("resnet18_fd"), ("denoise1", "layer2", "denoise4"))
    assert dtypes == {"denoise1": torch.float32, "layer2": torch.bfloat16,
                      "denoise4": torch.float32}


def test_u2netp_resnet_under_bf16_matches_jax():
    """resnet18_EE with the U2-NetP edge map under the bf16 policy, logits
    and input gradient against JAX's (BF16_NET_TOL above), 2 x 32 x 32: the
    U2-NetP and the front-end hand the stem float32, which it convolves in
    float32; its BatchNorm rounds to bfloat16, and the layer groups and the
    head compute in bfloat16."""
    from edge_enhancement_tpu_torch.convert import u2net_name_map
    dtypes = _bf16_net_against_jax(
        "resnet18_EE", dict(helpers.EE_ARGS, type_canny="u2netp"), 200, (2, 32, 32, 3),
        {**conv.resnet_name_map(18), **u2net_name_map()}, ("u2net", "conv1", "layer1", "layer4"))
    assert dtypes == {"u2net": torch.float32, "conv1": torch.float32,
                      "layer1": torch.bfloat16, "layer4": torch.bfloat16}
