"""Free-AT and fast-AT (objectives/free_fast.py) against the JAX steps: one
free-AT step with 2 replays and one fast-AT step with JAX's uniform draws,
on resnet18_EE with weights carried across: parameters, momentum, BatchNorm
statistics, the noise and the loss. Each on two front-ends: the BPDA-3
step125 Canny (K1/K2's plain versions here) and the full CannyFilter (NMS
and the double threshold, ops/canny.py) of the whole-training twins, r 16
for free-AT and r 12 for fast-AT (tools/digital_twin_{free,fast}.py). Then
the BatchNorm no-decay mask and the two schedules against the JAX
functions.

Batch 8 at 32 px, as tests/test_torch_train_step.py: with batch 2,
layer4's train-mode BatchNorm (1 x 1) would normalise 2 values a channel."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.objectives import free_fast as jff
from edge_enhancement_tpu.train import schedules as jsched
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu.train.sgd import batchnorm_decay_mask as jax_mask
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.convert import state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.objectives import free_fast as tff
from edge_enhancement_tpu_torch.train import schedules as tsched
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.train.sgd import batchnorm_decay_mask
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state

ARGS = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
            type_canny="CannyFilter_step125_1", fused_canny=True)
# the twins' full Canny front-end (CannyFilter: NMS, the double threshold)
FRONT_ENDS = {"step125": ARGS,
              "canny_r16": dict(ARGS, r=16, type_canny="CannyFilter"),
              "canny_r12": dict(ARGS, r=12, type_canny="CannyFilter")}
SHAPE, CLASSES = (8, 32, 32, 3), 10
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4
STEP_NOISE = tff._step_noise


@functools.lru_cache(maxsize=None)
def _setup(front: str):
    """(JAX ModelOps, params, batch_stats, x, y): params from JAX's init."""
    ops = JaxModelOps(jax_build_model("resnet18_EE", FRONT_ENDS[front], CLASSES))
    params, stats = jax.jit(ops.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1,) + SHAPE[1:], jnp.float32))
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(np.float32)
    y = rng.integers(0, CLASSES, SHAPE[0]).astype(np.int32)
    return ops, params, stats, x, y


def _port(params, stats, front: str = "step125"):
    tree = lambda t: jax.tree.map(np.asarray, t)
    model = build_model("resnet18_EE", FRONT_ENDS[front], CLASSES)
    model.load_state_dict(state_dict_from_jax(tree(params), tree(stats)))
    return model


class NoiseReplay:
    """Stands in for the port's noise update: records the port's own
    updated noise and returns JAX's instead, so that both sides run every
    pass on the same input. The noise follows sign(g), and where the two
    libraries' |g| ~ 0 (batch-statistic BatchNorm over 8 values a channel at
    layer4; flax's E[x^2] - E[x]^2 statistics) its sign differs; the hard
    edge threshold then turns a moved pixel into O(1) changes, as in
    tests/test_torch_train_step.py's attack."""

    def __init__(self, jax_noises):
        self.jax, self.own = list(jax_noises), []

    def with_own(self, own):
        self.own = list(own)
        return self

    def __call__(self, noise, g, cfg):
        self.own.append(STEP_NOISE(noise, g, cfg))
        return torch.from_numpy(np.array(self.jax[len(self.own) - 1]))


def _replay(monkeypatch, jax_noises):
    replay = NoiseReplay(jax_noises)
    monkeypatch.setattr(tff, "_step_noise", replay)
    return replay


def _compare(state, model, m, state_j, m_j, replay):
    """The port's state after a step against JAX's on the same noise, at the
    tolerances of tests/test_torch_train_step.py; the port's own noise:
    at most 2% of its entries off JAX's (measured 0.9%)."""
    for own, want in zip(replay.own, replay.jax):
        assert (np.abs(own.numpy() - np.asarray(want)) > 1e-6).mean() <= 0.02
    tree = lambda t: jax.tree.map(np.asarray, t)
    if m is not None:
        np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-5)
    sd = model.state_dict()
    want = state_dict_from_jax(tree(state_j.params), tree(state_j.batch_stats))
    want_mom = state_dict_from_jax(tree(state_j.momentum_buf), tree(state_j.batch_stats))
    assert sorted(want) == sorted(sd)
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=2e-3, err_msg=k)
        else:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    for (k, _), b in zip(model.named_parameters(), state.momentum_buf):
        np.testing.assert_allclose(b.numpy(), want_mom[k].numpy(), atol=1e-3,
                                   rtol=1e-3, err_msg=k)


def _jax_state(params, stats):
    return jtrainer.TrainState(params=params, batch_stats=stats,
                               momentum_buf=init_momentum(params),
                               step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("front", ["step125", "canny_r16"])
def test_free_at_step_matches_jax(front, monkeypatch):
    """Two replays on a zero noise, each a forward, one backward for the
    parameters and the noise, the noise update and SGD. JAX's side is its
    one-replay step run twice (its scan over replays carries exactly that
    state), which gives the state and the noise after each replay. The port
    is held to JAX's state after each replay, then continues from JAX's:
    at batch 8 and 32 px a ReLU or max-pool decision flips under the 1e-4
    by which the two states differ, and moves a BatchNorm gradient by a
    share of one of its 8 to 32 terms (1e-2 on the parameters after two
    replays when left to run on)."""
    ops, params, stats, x, y = _setup(front)
    cfg = jff.FreeFastConfig(n_repeats=1, fgsm_step=4 / 255, clip_eps=4 / 255)
    step_j = jff.build_free_train_step(ops, cfg, jtrainer.OptimConfig(MOMENTUM, WD))
    states, noises = [_jax_state(params, stats)], [jnp.zeros(SHAPE)]
    for i in range(2):
        state_j, nz, m_j = step_j(states[-1], noises[-1], jnp.asarray(x), jnp.asarray(y),
                                  jax.random.PRNGKey(i), jnp.float32(LR))
        states.append(state_j)
        noises.append(nz)
    model = _port(params, stats, front)
    state = create_train_state(model)
    step = tff.build_free_train_step(
        ModelOps(model), tff.FreeFastConfig(2, 4 / 255, 4 / 255),
        OptimConfig(MOMENTUM, WD))
    replay = _replay(monkeypatch, noises[1:])
    real_sgd = tff._sgd

    def sgd_then_sync(st, grads, lr, opt, mask):
        real_sgd(st, grads, lr, opt, mask)
        k = st.step + len(replay.own)          # the replay just finished
        _compare(st, model, None, states[k], None,
                 NoiseReplay(replay.jax[k - 1:k]).with_own(replay.own[k - 1:k]))
        _load(model, st, states[k])

    monkeypatch.setattr(tff, "_sgd", sgd_then_sync)
    noise, m = step(state, tff.init_noise(8, 32), torch.from_numpy(x),
                    torch.from_numpy(y).long(), LR)
    assert state.step == 2 and len(replay.own) == 2
    assert replay.own[1].abs().max() <= 4 / 255 + 1e-7
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-5)


def _load(model, state, state_j):
    """JAX's parameters, momentum and statistics into the port's state."""
    tree = lambda t: jax.tree.map(np.asarray, t)
    model.load_state_dict(state_dict_from_jax(tree(state_j.params), tree(state_j.batch_stats)))
    mom = state_dict_from_jax(tree(state_j.momentum_buf), tree(state_j.batch_stats))
    with torch.no_grad():
        for (k, _), b in zip(model.named_parameters(), state.momentum_buf):
            b.copy_(mom[k])


@pytest.mark.parametrize("front", ["step125", "canny_r12"])
def test_fast_at_step_matches_jax(front, monkeypatch):
    """One repeat with JAX's uniform draw: ascent on the noise, descent on
    the model with the noise fixed, SGD with no decay on BatchNorm."""
    ops, params, stats, x, y = _setup(front)
    cfg = jff.FreeFastConfig(n_repeats=1, fgsm_step=2.5 / 255, clip_eps=2 / 255)
    key = jax.random.PRNGKey(2)
    # the draw the JAX step makes: split(key, n_repeats), then split(k, 3)[0]
    k_init = jax.random.split(jax.random.split(key, 1)[0], 3)[0]
    draw = jax.random.uniform(k_init, SHAPE, minval=-cfg.clip_eps, maxval=cfg.clip_eps)
    step_j = jff.build_fast_train_step(
        ops, cfg, jtrainer.OptimConfig(MOMENTUM, WD, bn_no_decay=True))
    state_j, noise_j, m_j = step_j(_jax_state(params, stats), jnp.zeros(SHAPE),
                                   jnp.asarray(x), jnp.asarray(y), key, jnp.float32(LR))
    model = _port(params, stats, front)
    state = create_train_state(model)
    step = tff.build_fast_train_step(
        ModelOps(model), tff.FreeFastConfig(1, 2.5 / 255, 2 / 255),
        OptimConfig(MOMENTUM, WD, bn_no_decay=True))
    replay = _replay(monkeypatch, [noise_j])
    noise, m = step(state, tff.init_noise(8, 32), torch.from_numpy(x),
                    torch.from_numpy(y).long(), LR,
                    draws=[torch.from_numpy(np.array(draw))])
    assert state.step == 1 and len(replay.own) == 1
    _compare(state, model, m, state_j, m_j, replay)


def test_batchnorm_decay_mask_matches_jax():
    ops = JaxModelOps(jax_build_model("resnet50_EE", ARGS, CLASSES))
    shapes = jax.eval_shape(ops.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    mask_j = jax_mask(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[0]))
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes[1])
    want = state_dict_from_jax(jax.tree.map(np.asarray, mask_j), stats, 50)
    model = build_model("resnet50_EE", ARGS, CLASSES)
    got = batchnorm_decay_mask(model)
    names = [n for n, _ in model.named_parameters()]
    assert len(got) == len(names) and 0 < sum(got) < len(got)
    for name, m in zip(names, got):
        assert float(want[name].reshape(-1)[0]) == m, name
        assert (m == 0.0) == (".bn" in name or name.startswith("bn")
                              or name.endswith(("downsample.1.weight", "downsample.1.bias")))


def test_schedules_match_jax():
    for n_repeats in (1, 4, 8):
        for epoch in range(0, 95):
            assert tsched.step30_free(0.1, epoch, n_repeats) == \
                jsched.step30_free(0.1, epoch, n_repeats)
    knots = ([0, 1, 6], [0.0, 0.4, 0.04])
    for e in np.linspace(-0.5, 7.0, 61):
        assert tsched.interp_knots(e, *knots) == jsched.interp_knots(e, *knots)
    for step in range(0, 101, 7):
        assert tsched.cyclic_interp(0.0, 0.2, step, 100) == \
            jsched.cyclic_interp(0.0, 0.2, step, 100)
