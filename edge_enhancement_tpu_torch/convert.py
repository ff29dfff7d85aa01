"""JAX model parameters -> this package's state_dict.

`state_dict_from_jax(params, batch_stats)` takes the flax trees of
edge_enhancement_tpu's ResNet (18/34 with BasicBlocks, 50/101/152 with
Bottlenecks; with type_canny u2netp, its U2-NetP `U2Net_0`) as nested dicts
of numpy arrays and returns a state_dict with torchvision names (the
U2-NetP's under `u2net.`, the reference's U2-Net names):
conv kernels HWIO -> OIHW, Dense (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. Every array is
copied. `u2net_state_dict_from_jax` does the same for a bare U2Net tree,
and `arch_state_dict_from_jax` for any arch of the registry: the MNIST
CNNs (whose fc1 rows go from JAX's NHWC flatten to torch's (C, H, W)), the
denoising ResNet and the PreActResNets of either stem.
The name maps (torch module name -> flax path) follow the reference's
torch names, which the JAX package's converter
(tools/convert_torch_checkpoint.py) reads from the port's checkpoints.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .models.cnn_mnist import FEATURE_HW, FEATURES
from .models.registry import preact_dataset
from .models.resnet import _LAYOUTS, _PREACT_LAYOUTS, BasicBlock, PreActBlock
from .models.u2net import U2NET_HEADS, U2NET_NAMES

# Dense layers whose input is a flattened feature map, with its (C, H, W):
# the JAX model flattens NHWC, torch flattens (C, H, W)
FLATTENED = {"fc1": (FEATURES, FEATURE_HW, FEATURE_HW)}


def resnet_name_map(depth: int = 18) -> dict:
    """torchvision module name -> flax module path. flax names modules by
    call order: BasicBlock_k holds Conv_0/1 and BatchNorm_0/1, Bottleneck_k
    Conv_0/1/2 and BatchNorm_0/1/2 (1x1, 3x3, 1x1), and the block's
    projection, where it has one, is the next Conv and BatchNorm."""
    block, layers = _LAYOUTS[depth]
    n = 2 if block is BasicBlock else 3     # convolutions on the main path
    m = {"conv1": ("Conv_0",), "bn1": ("BatchNorm_0",), "fc": ("Dense_0",)}
    k = 0
    for li, blocks in enumerate(layers):
        for i in range(blocks):
            blk, base = f"{block.__name__}_{k}", f"layer{li + 1}.{i}"
            k += 1
            for ci in range(n):
                m[f"{base}.conv{ci + 1}"] = (blk, f"Conv_{ci}")
                m[f"{base}.bn{ci + 1}"] = (blk, f"BatchNorm_{ci}")
            m[f"{base}.downsample.0"] = (blk, f"Conv_{n}")
            m[f"{base}.downsample.1"] = (blk, f"BatchNorm_{n}")
    return m


def fd_name_map(depth: int = 18) -> dict:
    """resnet_name_map and the four DenoisingBlocks (flax's
    DenoisingBlock_0..3: Conv_0 the 1x1 convolution, BatchNorm_0)."""
    m = resnet_name_map(depth)
    for d in range(4):
        m[f"denoise{d + 1}.conv3"] = (f"DenoisingBlock_{d}", "Conv_0")
        m[f"denoise{d + 1}.bn"] = (f"DenoisingBlock_{d}", "BatchNorm_0")
    return m


def preact_name_map(depth: int = 18, cifar: bool = False) -> dict:
    """PreActResNet module name -> flax path. flax names by call order: the
    CIFAR stem is Conv_0 with no BatchNorm, so the final BatchNorm is
    BatchNorm_0; the 7x7 stem's is BatchNorm_0 and the final one
    BatchNorm_1. In a block, bn1, bn2 (bn3) are BatchNorm_0, 1 (2); the
    projection shortcut, where the block has one, is created first
    (Conv_0) and conv1.. follow it."""
    block, layers = _PREACT_LAYOUTS[depth]
    n = 2 if block is PreActBlock else 3
    m = {"conv1": ("Conv_0",)}
    if cifar:
        m.update({"bn": ("BatchNorm_0",), "linear": ("Dense_0",)})
    else:
        m.update({"bn1": ("BatchNorm_0",), "bn": ("BatchNorm_1",),
                  "fc": ("Dense_0",)})
    k, inplanes = 0, 64
    for li, blocks in enumerate(layers):
        planes = (64 << li) * block.expansion
        for i in range(blocks):
            proj = (li > 0 and i == 0) or inplanes != planes
            inplanes = planes
            blk, base = f"{block.__name__}_{k}", f"layer{li + 1}.{i}"
            k += 1
            if proj:
                m[f"{base}.shortcut.0"] = (blk, "Conv_0")
            for ci in range(n):
                m[f"{base}.bn{ci + 1}"] = (blk, f"BatchNorm_{ci}")
                m[f"{base}.conv{ci + 1}"] = (blk, f"Conv_{ci + int(proj)}")
    return m


def mnist_name_map() -> dict:
    """Net2's reference names -> flax's MnistCNN paths."""
    return {"conv1": ("Conv_0",), "conv2": ("Conv_1",),
            "fc1": ("Dense_0",), "fc2": ("Dense_1",)}


def u2net_name_map(prefix: str = "u2net.", scope: tuple = ("U2Net_0",)) -> dict:
    """torch module name -> flax path of a U2-Net's convolutions and
    BatchNorms: `prefix` before the torch names, `scope` before the flax
    path (a bare U2Net: "" and (); inside a ResNet: flax's auto-name
    U2Net_0)."""
    m = {}
    for stage, (fscope, inner) in U2NET_NAMES.items():
        for tname, idx in inner.items():
            base = scope + (fscope, f"REBNConv_{idx}")
            m[f"{prefix}{stage}.{tname}.conv_s1"] = base + ("Conv_0",)
            m[f"{prefix}{stage}.{tname}.bn_s1"] = base + ("BatchNorm_0",)
    m.update({prefix + t: scope + (f,) for t, f in U2NET_HEADS.items()})
    return m


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _from_jax(params, batch_stats, name_map: dict) -> dict:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {}
    for tname, path in name_map.items():
        mod = _get(params, path)
        if mod is None:
            continue                      # e.g. no projection in this block
        if "kernel" in mod:
            kernel = np.asarray(mod["kernel"])
            if kernel.ndim == 4:
                kernel = kernel.transpose(3, 2, 0, 1)
            elif tname in FLATTENED:       # rows (H, W, C) -> (C, H, W)
                c, h, w = FLATTENED[tname]
                kernel = kernel.reshape(h, w, c, -1).transpose(2, 0, 1, 3)
                kernel = kernel.reshape(c * h * w, -1).T
            else:
                kernel = kernel.T
            sd[tname + ".weight"] = t(kernel)
            if "bias" in mod:
                sd[tname + ".bias"] = t(mod["bias"])
        else:
            stats = _get(batch_stats, path)
            sd[tname + ".weight"] = t(mod["scale"])
            sd[tname + ".bias"] = t(mod["bias"])
            sd[tname + ".running_mean"] = t(stats["mean"])
            sd[tname + ".running_var"] = t(stats["var"])
    return sd


def state_dict_from_jax(params, batch_stats, depth: int = 18) -> dict:
    return arch_state_dict_from_jax(f"resnet{depth}", params, batch_stats)


def u2net_state_dict_from_jax(params, batch_stats) -> dict:
    """A bare U2Net's flax trees -> the port's U2Net state_dict."""
    return _from_jax(params, batch_stats, u2net_name_map("", ()))


def name_map_for_arch(arch: str, args=None) -> dict:
    """The name map of a registry arch; `args` (the config) picks the
    PreActResNet's stem through its dataset."""
    if arch.startswith("Net2"):
        return mnist_name_map()
    m = re.fullmatch(r"PreActResNet(\d+).*", arch)
    if m is not None:
        cifar = preact_dataset(args or {}).startswith("CIFAR")
        return preact_name_map(int(m.group(1)), cifar)
    m = re.fullmatch(r"resnet(\d+)(_fd)?.*", arch)
    if m is None:
        raise NotImplementedError(f"no name map for arch {arch!r}")
    depth = int(m.group(1))
    return fd_name_map(depth) if m.group(2) else resnet_name_map(depth)


def arch_state_dict_from_jax(arch: str, params, batch_stats, args=None) -> dict:
    """The flax trees of the JAX model of `arch` -> the port's state_dict."""
    name_map = name_map_for_arch(arch, args)
    if "U2Net_0" in params:
        name_map.update(u2net_name_map())
    return _from_jax(params, batch_stats, name_map)
