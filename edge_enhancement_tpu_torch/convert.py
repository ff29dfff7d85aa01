"""JAX ResNet parameters -> this package's state_dict.

`state_dict_from_jax(params, batch_stats)` takes the flax trees of
edge_enhancement_tpu's ResNet-18 as nested dicts of numpy arrays and returns
a state_dict with torchvision names: conv kernels HWIO -> OIHW, Dense
(in, out) -> (out, in), BatchNorm scale/bias/mean/var -> weight/bias/
running_mean/running_var. Every array is copied.
"""

from __future__ import annotations

import numpy as np
import torch

_LAYERS = {18: (2, 2, 2, 2)}


def resnet_name_map(depth: int = 18) -> dict:
    """torchvision module name -> flax module path (flax names modules by
    call order: BasicBlock_k holds Conv_0/1 (+ Conv_2 for the projection))."""
    m = {"conv1": ("Conv_0",), "bn1": ("BatchNorm_0",), "fc": ("Dense_0",)}
    k = 0
    for li, n in enumerate(_LAYERS[depth]):
        for i in range(n):
            blk, base = f"BasicBlock_{k}", f"layer{li + 1}.{i}"
            k += 1
            for ci in range(2):
                m[f"{base}.conv{ci + 1}"] = (blk, f"Conv_{ci}")
                m[f"{base}.bn{ci + 1}"] = (blk, f"BatchNorm_{ci}")
            m[f"{base}.downsample.0"] = (blk, "Conv_2")
            m[f"{base}.downsample.1"] = (blk, "BatchNorm_2")
    return m


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def state_dict_from_jax(params, batch_stats, depth: int = 18) -> dict:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    sd = {}
    for tname, path in resnet_name_map(depth).items():
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
