"""Shared pieces of the port-vs-JAX tests (tests/test_torch_*.py): square
draws made with numpy and replayed on both sides, the JAX ResNet's
weights carried into the port, and one train step run on both sides and
compared."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.objectives import methods as jmethods
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.objectives import methods as tmethods
from edge_enhancement_tpu_torch.ops.square import square_side
from edge_enhancement_tpu_torch.train import trainer as ttrainer
from edge_enhancement_tpu_torch.train.modelops import ModelOps

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


def random_variables(shapes, rng, spread: float = 0.0):
    """numpy values for a flax variable tree of ShapeDtypeStructs: conv
    kernels N(0, 2/fan_out), Dense N(0, 1/fan_in), biases 0, BatchNorm
    scale and variance 1 and mean 0; `spread` > 0 moves the BatchNorm
    terms by N(0, spread) (the variance by U(-5 spread, 5 spread))."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan = (np.prod(s.shape[:-2]) * s.shape[-1] if len(s.shape) == 4
                   else s.shape[0] / 2.0)
            return rng.normal(0, np.sqrt(2.0 / fan), s.shape).astype(np.float32)
        if name == "var":
            return 1.0 + rng.uniform(-5 * spread, 5 * spread, s.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        if name == "bias" and len(path) == 2 and path[0].key.startswith("Dense"):
            return np.zeros(s.shape, np.float32)
        return (base + spread * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def jax_and_port_models(shape, arch="resnet18_EE_square", seed=0, ee_args=None):
    """(jax ModelOps, params, batch_stats, port model with those weights)."""
    ee_args = EE_ARGS if ee_args is None else ee_args
    ops = JaxModelOps(jax_build_model(arch, ee_args, 200))
    params, batch_stats = jax.jit(ops.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1,) + tuple(shape[1:]), jnp.float32))
    model = build_model(arch, ee_args, 200)
    model.load_state_dict(state_dict_from_jax(to_numpy_tree(params),
                                              to_numpy_tree(batch_stats)))
    return ops, params, batch_stats, model


# The train step of the comparison: EE_BPDA3_AT_square at a small size
STEP_SHAPE = (8, 32, 32, 3)
PGD_STEPS, LR, MOMENTUM, WD = 2, 0.1, 0.9, 2e-4
STEP_SIZE = 0.007843137254902


def _jax_spy(captured):
    real = jmethods.pgd_linf

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(lambda a: captured.__setitem__("x_adv", np.asarray(a)),
                           out[0])
        return out
    return spy


def _port_spy(captured, replacement):
    """Runs the port's attack (its draws and BatchNorm updates happen) and
    returns `replacement['x_adv']` in place of its result."""
    real = tmethods.pgd_linf

    def spy(*args, **kwargs):
        captured["x_adv"] = real(*args, **kwargs).numpy()
        return torch.from_numpy(replacement["x_adv"].copy())
    return spy


def train_step_pair(monkeypatch, ee_args=None):
    """One EE_BPDA3_AT_square train step of the JAX package and one of the
    port on carried weights, with the square draws and the PGD start noise
    made with numpy and replayed on both sides. The port's attack runs, but
    the port takes JAX's x_adv for the update. Returns the port's
    (metrics, state, model, x_adv) and JAX's (metrics, state, x_adv)."""
    ops_j, params, bs, model = jax_and_port_models(STEP_SHAPE, ee_args=ee_args)
    rng = np.random.default_rng(0)
    x = rng.random(STEP_SHAPE).astype(np.float32)
    y = rng.integers(0, 200, STEP_SHAPE[0]).astype(np.int32)
    noise = rng.uniform(-EPS, EPS, STEP_SHAPE).astype(np.float32)
    draws = square_draws(PGD_STEPS + 1, STEP_SHAPE)
    cap_j, cap_t = {}, {}

    # ---- JAX: the jitted step; the fakes trace once per (unrolled) call ----
    monkeypatch.setattr(jee, "add_square", JaxSquareReplay(draws))
    monkeypatch.setattr(jpgd, "_init_perturbation",
                        lambda cfg, key, xx: jnp.clip(xx + noise, 0.0, 1.0))
    monkeypatch.setattr(jmethods, "pgd_linf", _jax_spy(cap_j))
    mcfg_j = jmethods.MethodConfig("EE_BPDA3_AT_square", epsilon=EPS,
                                   num_steps=PGD_STEPS, step_size=STEP_SIZE,
                                   num_classes=200)
    step_j = jtrainer.build_train_step(ops_j, mcfg_j, jtrainer.OptimConfig(MOMENTUM, WD))
    state_j = jtrainer.TrainState(params=params, batch_stats=bs,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), jnp.float32(LR))
    jax.block_until_ready(state_j)

    # ---- the port ----------------------------------------------------------
    model.square_source = TorchSquareReplay(draws)
    monkeypatch.setattr(tpgd, "uniform_init_noise",
                        lambda xx, eps, gen: torch.from_numpy(noise))
    monkeypatch.setattr(tmethods, "pgd_linf", _port_spy(cap_t, cap_j))
    mcfg = tmethods.MethodConfig("EE_BPDA3_AT_square", epsilon=EPS,
                                 num_steps=PGD_STEPS, step_size=STEP_SIZE)
    state = ttrainer.create_train_state(model)
    step = ttrainer.build_train_step(ModelOps(model), mcfg,
                                     ttrainer.OptimConfig(MOMENTUM, WD))
    m = step(state, torch.from_numpy(x), torch.from_numpy(y).long(), LR)
    return (m, state, model, cap_t["x_adv"]), (m_j, state_j, cap_j["x_adv"])


def assert_train_steps_agree(port, jax_side):
    """The comparison of `train_step_pair`'s two steps (the tolerances are
    explained in tests/test_torch_train_step.py)."""
    (m, state, model, x_adv), (m_j, state_j, x_adv_j) = port, jax_side
    assert state.step == 1
    # the port's own x_adv: the share of pixels off JAX's
    differ = np.abs(x_adv - x_adv_j) > 1e-6
    assert differ.mean() <= 0.05, differ.mean()
    # from here both sides hold the same x_adv: loss and top-1 (measured
    # 2.4e-6 relative), then the update
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-5)
    assert float(m["top1"]) == float(m_j["top1"])

    sd = model.state_dict()
    want = state_dict_from_jax(to_numpy_tree(state_j.params),
                               to_numpy_tree(state_j.batch_stats))
    mom = dict(zip((n for n, _ in model.named_parameters()), state.momentum_buf))
    want_mom = state_dict_from_jax(to_numpy_tree(state_j.momentum_buf),
                                   to_numpy_tree(state_j.batch_stats))
    assert sorted(want) == sorted(sd)
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            # the attack forwards ran on each side's own x_adv (measured
            # 8.4e-4 on values of order 1)
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=2e-3, err_msg=k)
        else:
            # p - lr * buf: float32 parameter gradients of two libraries
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)
    for k, b in mom.items():
        # buf = g + wd * p after one step (measured 3.3e-4 on |buf| ~ 7)
        np.testing.assert_allclose(b.numpy(), want_mom[k].numpy(),
                                   atol=1e-3, rtol=1e-3, err_msg=k)
