"""One train step of the port against one JAX train step: the flagship
recipe (resnet18_EE_square, EE_BPDA3_AT_square: PGD against the train-mode
model, CE, SGD with momentum and coupled weight decay) at a small size, on
carried weights, with the square draws and the PGD start noise made with
numpy and replayed on both sides.

The attack is chaotic at float32 resolution: where the two libraries' input
gradients differ in sign (|g| ~ 0, and one-ulp ties at the front-end's
saturated plateaus), x + step * sign(g) moves a pixel the other way, and the
hard edge threshold turns that into O(1) gradient changes at the next
iteration. So the test bounds the share of x_adv pixels that differ, then
hands the port JAX's x_adv for the update, which it compares tightly."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.objectives import methods as jmethods
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.objectives import methods as tmethods
from edge_enhancement_tpu_torch.train import trainer as ttrainer
from edge_enhancement_tpu_torch.train.modelops import ModelOps

SHAPE = (8, 32, 32, 3)
PGD_STEPS, LR, MOMENTUM, WD = 2, 0.1, 0.9, 2e-4
STEP = 0.007843137254902


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


def test_train_step_matches_jax(monkeypatch):
    ops_j, params, bs, model = helpers.jax_and_port_models(SHAPE)
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(np.float32)
    y = rng.integers(0, 200, SHAPE[0]).astype(np.int32)
    noise = rng.uniform(-helpers.EPS, helpers.EPS, SHAPE).astype(np.float32)
    draws = helpers.square_draws(PGD_STEPS + 1, SHAPE)
    cap_j, cap_t = {}, {}

    # ---- JAX: the jitted step; the fakes trace once per (unrolled) call ----
    monkeypatch.setattr(jee, "add_square", helpers.JaxSquareReplay(draws))
    monkeypatch.setattr(jpgd, "_init_perturbation",
                        lambda cfg, key, xx: jnp.clip(xx + noise, 0.0, 1.0))
    monkeypatch.setattr(jmethods, "pgd_linf", _jax_spy(cap_j))
    mcfg_j = jmethods.MethodConfig("EE_BPDA3_AT_square", epsilon=helpers.EPS,
                                   num_steps=PGD_STEPS, step_size=STEP,
                                   num_classes=200)
    step_j = jtrainer.build_train_step(ops_j, mcfg_j, jtrainer.OptimConfig(MOMENTUM, WD))
    state_j = jtrainer.TrainState(params=params, batch_stats=bs,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), jnp.float32(LR))
    jax.block_until_ready(state_j)

    # ---- the port ----------------------------------------------------------
    model.square_source = helpers.TorchSquareReplay(draws)
    monkeypatch.setattr(tpgd, "uniform_init_noise",
                        lambda xx, eps, gen: torch.from_numpy(noise))
    monkeypatch.setattr(tmethods, "pgd_linf", _port_spy(cap_t, cap_j))
    mcfg = tmethods.MethodConfig("EE_BPDA3_AT_square", epsilon=helpers.EPS,
                                 num_steps=PGD_STEPS, step_size=STEP)
    state = ttrainer.create_train_state(model)
    step = ttrainer.build_train_step(ModelOps(model), mcfg,
                                     ttrainer.OptimConfig(MOMENTUM, WD))
    m = step(state, torch.from_numpy(x), torch.from_numpy(y).long(), LR)
    assert state.step == 1

    # the port's own x_adv: the share of pixels off JAX's (module docstring)
    differ = np.abs(cap_t["x_adv"] - cap_j["x_adv"]) > 1e-6
    assert differ.mean() <= 0.05, differ.mean()
    # from here both sides hold the same x_adv: loss and top-1 (measured
    # 2.4e-6 relative), then the update
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-5)
    assert float(m["top1"]) == float(m_j["top1"])

    sd = model.state_dict()
    want = state_dict_from_jax(helpers.to_numpy_tree(state_j.params),
                               helpers.to_numpy_tree(state_j.batch_stats))
    mom = dict(zip((n for n, _ in model.named_parameters()), state.momentum_buf))
    want_mom = state_dict_from_jax(helpers.to_numpy_tree(state_j.momentum_buf),
                                   helpers.to_numpy_tree(state_j.batch_stats))
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
