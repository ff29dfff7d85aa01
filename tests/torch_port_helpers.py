"""Shared pieces of the port-vs-JAX tests (tests/test_torch_*.py): square
draws made with numpy and replayed on both sides, and the JAX ResNet's
weights carried into the port."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.ops.square import square_side

EPS = 0.062745098039216
EE_ARGS = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
               type_canny="CannyFilter_step125_1", epsilon=EPS, n_queries=1)


def square_draws(n_calls, shape, seed=7):
    """One (stripes (B,1,W,C), mask (H,W), sign (1,1,1,C)) per forward."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    s = square_side(h, c)
    draws = []
    for _ in range(n_calls):
        stripes = rng.choice([-1.0, 1.0], size=(b, 1, w, c)).astype(np.float32)
        vh = int(rng.integers(0, h - s + 1))
        mask = np.zeros((h, w), np.float32)
        mask[vh:vh + s, vh:vh + s] = 1.0
        sign = rng.choice([-1.0, 1.0], size=(1, 1, 1, c)).astype(np.float32)
        draws.append((stripes, mask, sign))
    return draws


class JaxSquareReplay:
    """Stands in for edge_enhancement_tpu.models.ee_frontend.add_square: the
    JAX add_square arithmetic on the next recorded draw (one per traced call,
    so the attack loop must stay unrolled)."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, x, key, *, epsilon, n_queries=1, **_):
        stripes, mask, sign = (jnp.asarray(a) for a in self.draws[self.calls])
        self.calls += 1
        x_best = jnp.clip(x + epsilon * stripes, 0.0, 1.0)
        x_best = x_best + 2.0 * epsilon * sign * mask[None, :, :, None]
        x_best = jnp.minimum(jnp.maximum(x_best, x - epsilon), x + epsilon)
        return jnp.clip(x_best, 0.0, 1.0)


class TorchSquareReplay:
    """The port's square draw source replaying the same draws."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, shape):
        d = self.draws[self.calls]
        self.calls += 1
        return tuple(torch.from_numpy(a.copy()) for a in d)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def jax_and_port_models(shape, arch="resnet18_EE_square", seed=0):
    """(jax ModelOps, params, batch_stats, port model with those weights)."""
    ops = JaxModelOps(jax_build_model(arch, EE_ARGS, 200))
    params, batch_stats = jax.jit(ops.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1,) + tuple(shape[1:]), jnp.float32))
    model = build_model(arch, EE_ARGS, 200)
    model.load_state_dict(state_dict_from_jax(to_numpy_tree(params),
                                              to_numpy_tree(batch_stats)))
    return ops, params, batch_stats, model
