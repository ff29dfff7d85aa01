"""JAX ResNet and U2-Net parameters -> this package's state_dict.

`state_dict_from_jax(params, batch_stats)` takes the flax trees of
edge_enhancement_tpu's ResNet (18/34 with BasicBlocks, 50/101/152 with
Bottlenecks; with type_canny u2netp, its U2-NetP `U2Net_0`) as nested dicts
of numpy arrays and returns a state_dict with torchvision names (the
U2-NetP's under `u2net.`, the reference's U2-Net names):
conv kernels HWIO -> OIHW, Dense (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. Every array is
copied. `u2net_state_dict_from_jax` does the same for a bare U2Net tree.
The name maps (torch module name -> flax path) also serve the JAX
package's converter (tools/convert_torch_checkpoint.py), which takes a map.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.resnet import _LAYOUTS, BasicBlock
from .models.u2net import U2NET_HEADS, U2NET_NAMES


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
            sd[tname + ".weight"] = t(kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                                      else kernel.T)
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
    name_map = resnet_name_map(depth)
    if "U2Net_0" in params:
        name_map.update(u2net_name_map())
    return _from_jax(params, batch_stats, name_map)


def u2net_state_dict_from_jax(params, batch_stats) -> dict:
    """A bare U2Net's flax trees -> the port's U2Net state_dict."""
    return _from_jax(params, batch_stats, u2net_name_map("", ()))
