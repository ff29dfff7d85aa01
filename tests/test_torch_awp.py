"""The port's AWP step (objectives/awp.py) against the JAX package's
build_awp_train_step, and the driver's AWP loop.

One step of PreActResNet18 on the CIFAR stem (the awp_cifar100 config's
model) at 4 x 32 x 32 with a 1-step train-mode PGD and nonzero weight
decay, with the gate off (awp_on 0) and on (1): the PGD start is one
numpy draw replayed on both sides; the port's attack runs (its BatchNorm
updates happen) and the port then takes JAX's x_adv, as
tests/torch_port_helpers.py::train_step_pair does. After the step: the
loss, the parameters, the momentum and the running statistics. Both sides
run in float64 (JAX under jax.enable_x64): train-mode BatchNorm over 4
images makes float32 ill-conditioned here (measured: the first attack
step's input gradient 2.5% of its largest value apart between the port's
float32 and float64; with 2 steps, 7.3% of x_adv pixels apart, and the
updated parameters 6.3e-4 and the running statistics 2.2e-3 apart on
the same x_adv), while the two float64 steps agree to rounding. The
driver: the learning rate set every minibatch at epoch + (i + 1) /
n_batches and the warmup gate, on a CPU run of the config. The same step
on a mesh with a model axis: the port on 4 gloo ranks of data 2 x model 2
(tests/torch_parallel_worker.py) against JAX's step jitted over
make_mesh(n_data=2, n_model=2)."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import copy
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from torch_checkpoints import drop_written_checkpoints  # noqa: F401  (autouse)
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.objectives import awp as jawp
from edge_enhancement_tpu.objectives.methods import MethodConfig as JMethodConfig
from edge_enhancement_tpu.parallel import mesh as jmesh
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.objectives import awp as tawp
from edge_enhancement_tpu_torch.objectives.methods import MethodConfig
from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state
from edge_enhancement_tpu_torch.utils.config import load_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "edge_enhancement_tpu", "configs")
ARCH, ARGS, N = "PreActResNet18", dict(dataset="cifar100", dataset_variant="CIFAR100"), 100
SHAPE, PGD_STEPS = (4, 32, 32, 3), 1
EPS, STEP_SIZE = 8 / 255, 2 / 255
GAMMA, PROXY_LR, LR, MOMENTUM, WD = 0.01, 0.01, 0.1, 0.9, 2e-4
# The port's float64 step against JAX's: the share of x_adv pixels off
# JAX's, then on JAX's x_adv the parameters and momentum as
# |a - b| / (1 + |b|) and the running statistics absolute, the converter
# rounding JAX's values to float32. Measured with either gate: share 0,
# params 3.0e-8, running statistics 1.2e-7, momentum 1.6e-7, the float32
# rounding of the values. (With a 2-step PGD and the gate on, the params
# were 4.4e-6 and the momentum 3.8e-5 apart, the rest as here; not traced.)
F64_TOL = dict(share=1e-3, params=1e-6, running=1e-6, momentum=1e-6)


def _jax_awp_step(mesh=None):
    """JAX's jitted AWP step on the carried weights in float64, its PGD
    start replayed, on one device or jitted over `mesh` (the state
    replicated, the batch on the `data` axis); yields (step(awp_on) ->
    (state, metrics, x_adv), x, y, noise). One compile for both gates
    (awp_on is traced)."""
    ops_j, params, bs, _ = helpers.jax_and_port_models(SHAPE, arch=ARCH, ee_args=ARGS,
                                                        num_classes=N)
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(np.float32)
    y = rng.integers(0, N, SHAPE[0]).astype(np.int32)
    noise = rng.uniform(-EPS, EPS, SHAPE).astype(np.float32)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpgd, "_init_perturbation",
                   lambda cfg, key, xx: jnp.clip(xx + noise, 0.0, 1.0))
        mp.setattr(jawp, "pgd_linf", helpers._jax_spy(captured))
        step = jawp.build_awp_train_step(
            ops_j, JMethodConfig("AT_AWP", epsilon=EPS, num_steps=PGD_STEPS,
                                 step_size=STEP_SIZE, num_classes=N),
            jtrainer.OptimConfig(MOMENTUM, WD), jawp.AWPConfig(gamma=GAMMA, proxy_lr=PROXY_LR),
            mesh=mesh)

        def run(awp_on):
            with jax.enable_x64(True):
                state = jtrainer.TrainState(params=wide(params), batch_stats=wide(bs),
                                            momentum_buf=init_momentum(wide(params)),
                                            step=jnp.zeros((), jnp.int32))
                xb, yb = jnp.asarray(x, jnp.float64), jnp.asarray(y)
                if mesh is not None:
                    xb, yb = jmesh.shard_batch(mesh, (xb, yb))
                state, m = step(state, xb, yb, jax.random.PRNGKey(0), jnp.asarray(LR),
                                jnp.asarray(awp_on))
                jax.block_until_ready(state)
                jax.effects_barrier()           # the x_adv callback has run
                assert state.params["Conv_0"]["kernel"].dtype == jnp.float64
                return state, m, captured["x_adv"].copy()
        yield run, x, y, noise


@pytest.fixture(scope="module")
def jax_step():
    yield from _jax_awp_step()


def _port_step(monkeypatch, model, x, y, noise, x_adv_j, awp_on, dtype):
    t = torch.from_numpy
    monkeypatch.setattr(tpgd, "uniform_init_noise",
                        lambda xx, eps, gen: t(noise).to(dtype))
    cap = {}
    monkeypatch.setattr(tawp, "pgd_linf", helpers._port_spy(cap, {"x_adv": x_adv_j}))
    state = create_train_state(model)
    step = tawp.build_awp_train_step(
        ModelOps(model), MethodConfig("AT_AWP", epsilon=EPS, num_steps=PGD_STEPS,
                                      step_size=STEP_SIZE, num_classes=N),
        OptimConfig(MOMENTUM, WD), tawp.AWPConfig(gamma=GAMMA, proxy_lr=PROXY_LR))
    m = step(state, t(x).to(dtype), t(y).long(), LR, awp_on)
    return m, state, model, cap["x_adv"]


@pytest.mark.parametrize("awp_on", [0.0, 1.0])
def test_awp_step_matches_jax(monkeypatch, jax_step, awp_on):
    run, x, y, noise = jax_step
    state_j, m_j, x_adv_j = run(awp_on)
    _, _, _, model = helpers.jax_and_port_models(SHAPE, arch=ARCH, ee_args=ARGS,
                                                 num_classes=N)
    model.double()
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    m, state, _, x_adv = _port_step(monkeypatch, model, x, y, noise, x_adv_j, awp_on,
                                    torch.float64)
    assert state.step == 1
    assert all(not torch.equal(p, w0[k]) for k, p in model.named_parameters())
    # both models hand back float32 logits, so the losses are float32
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=1e-6)
    # the running statistics hold the attack's forwards and the robust
    # forward's only (the proxy's are thrown away), on both sides
    port = (m, state, model.float(), x_adv.astype(np.float32))
    for b in state.momentum_buf:
        b.data = b.data.float()
    helpers.assert_train_steps_agree(port, (m_j, state_j, x_adv_j.astype(np.float32)),
                                     F64_TOL, arch=ARCH, args=ARGS)


def test_awp_on_a_model_axis_matches_jax_mesh_step(tmp_path):
    """The step on 4 gloo ranks of data 2 x model 2 (every convolution and
    the head cut on their output channels; a cut weight's norms summed
    over the model group) against JAX's AWP step on make_mesh(n_data=2,
    n_model=2), both gates from one compile: the PGD start replayed and
    JAX's x_adv given (each rank its data rows); F64_TOL, as on one
    process."""
    from test_torch_parallel import run_ranks
    cfg = load_config(os.path.join(CONFIGS, "awp_cifar100", "at_awp.yml"), dict(
        num_steps_1=PGD_STEPS, epsilon=EPS, step_size_1=STEP_SIZE, device="cpu"))
    _, _, _, model = helpers.jax_and_port_models(SHAPE, arch=ARCH, ee_args=ARGS,
                                                 num_classes=N)
    gen = _jax_awp_step(jmesh.make_mesh(n_data=2, n_model=2))
    run, x, y, noise = next(gen)
    gates = (0.0, 1.0)
    jax_side = [run(awp_on) for awp_on in gates]
    gen.close()
    t = torch.from_numpy
    ranks = run_ranks(tmp_path, "awp", dict(
        cfg=dict(cfg), num_classes=N, x=t(x), y=t(y).long(),
        variants=[(awp_on, 0.0) for awp_on in gates], weights=model.state_dict(),
        noise=t(noise), x_adv=[t(x_adv_j) for _, _, x_adv_j in jax_side], lr=LR,
        momentum=MOMENTUM, weight_decay=WD, gamma=GAMMA, proxy_lr=PROXY_LR), world=4, n_model=2)
    for i, (state_j, m_j, x_adv_j) in enumerate(jax_side):
        got = ranks[0]["variants"][i]
        for r in ranks[1:]:
            assert r["variants"][i]["metrics"] == got["metrics"]
        port_model = copy.deepcopy(model)
        port_model.load_state_dict({k: v.float() for k, v in got["state"].items()})
        state = create_train_state(port_model)
        state.step = got["step"]
        state.momentum_buf = [b.float() for b in got["momentum"]]
        # each data row's model rank 0 holds the row's x_adv
        x_adv = torch.cat([r["x_adv"][i] for r in ranks[::2]]).numpy()
        np.testing.assert_allclose(got["metrics"]["loss"], float(m_j["loss"]), rtol=1e-6)
        helpers.assert_train_steps_agree(
            (got["metrics"], state, port_model, x_adv.astype(np.float32)),
            (m_j, state_j, x_adv_j.astype(np.float32)), F64_TOL, arch=ARCH, args=ARGS)


def test_awp_gate_and_diff():
    """awp_diff: zero on 1-D tensors; elsewhere the proxy's step (w +
    lr g) - w scaled to the norm of w."""
    w = [torch.randn(3, 4, generator=torch.Generator().manual_seed(0)), torch.ones(5)]
    g = [torch.full((3, 4), 2.0), torch.ones(5)]
    d = tawp.awp_diff(w, g, 0.01)
    assert torch.equal(d[1], torch.zeros(5))
    np.testing.assert_allclose(float(torch.linalg.vector_norm(d[0])),
                               float(torch.linalg.vector_norm(w[0])), rtol=1e-6)
    # a constant gradient: (w + 0.02) - w is 0.02 to the rounding of w
    np.testing.assert_allclose((d[0] / d[0].abs().max()).numpy(), np.ones((3, 4)), rtol=1e-4)


def test_driver_awp_lr_every_minibatch_and_warmup(tmp_path, monkeypatch):
    """The driver on awp_cifar100/at_awp.yml at a tiny size, 2 epochs with
    awp_warmup 1: each step gets lr(epoch + (i + 1) / n_batches) and
    awp_on 0 in the warmup epoch, 1 after; a checkpoint is written."""
    seen = []
    real = driver.build_awp_train_step

    def spy(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, x, y, lr, awp_on):
            seen.append((lr, awp_on))
            return step(state, x, y, lr, awp_on)
        return wrapped
    monkeypatch.setattr(driver, "build_awp_train_step", spy)
    cfg = load_config(os.path.join(CONFIGS, "awp_cifar100", "at_awp.yml"), dict(
        data="synthetic", synthetic_size=16, batch_size=4, limit_batches=2,
        device="cpu", num_steps_1=1, epochs=2, awp_warmup=1, output=str(tmp_path)))
    summary = driver.run(cfg)
    n_batches = 16 // 4
    want = [(driver.epoch_lr(cfg, e + (i + 1) / n_batches), float(e >= 1))
            for e in range(2) for i in range(2)]
    assert seen == want
    # piecewise_50_75 over 2 epochs: 0.1 until epoch 1, then 0.01 past it
    assert [lr for lr, _ in seen] == pytest.approx([0.1, 0.1, 0.01, 0.01])
    assert summary["train_steps"] == [2, 2] and np.isfinite(summary["loss"])
    assert summary["checkpoint"].endswith("checkpoint.pth.tar")
