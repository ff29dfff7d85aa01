"""The port's `model` axis (edge_enhancement_tpu_torch/parallel/sharding.py
on the (data, model) mesh of parallel/mesh.py) on the CPU: real gloo
groups, each rank a subprocess of tests/torch_parallel_worker.py on one
OpenMP thread, as tests/test_torch_parallel.py runs the `data` axis
(n_model = 1, which that file covers unchanged).

(a) a Net2 AT step (PGD-2, eps 0.3, as tests/test_tensor_parallel.py) on
    data 2 x model 2 against one process on the global batch, float64;
(b) the same step in float32 against the JAX package's own
    make_mesh(n_data=2, n_model=2) + shard_state + state_sharding step, on
    JAX's draws;
(c) the flagship (resnet18_EE_square, 32 px, 16 classes,
    EE_BPDA3_AT_square) on data 1 x model 2 against one process, float64:
    the first attack step's input gradient, then the state;
(d) in (a) and (c): the checkpoint written under the model axis is the
    one-process file, and the ranks resume from a one-process file;
(e) an output width that does not divide by the model axis;
(f) the step's reduction on data 2 x model 2: a cut parameter's gradient
    summed over the data group, a replicated one's also averaged over the
    model group, which keeps the model ranks' replicas equal where they
    computed it apart and leaves it bit for bit where they did not;
(g) AWP (objectives/awp.py) on data 1 x model 2 and data 2 x model 2
    against one process, float64, the gate off and on, with and without
    the L1 term (tests/test_torch_awp.py holds the same step against JAX's
    on a data 2 x model 2 mesh)."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from test_torch_parallel import CONFIG, REPO, run_ranks
from torch_checkpoints import drop_written_checkpoints  # noqa: F401
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.models.cnn_mnist import net2
from edge_enhancement_tpu.objectives import methods as jmethods
from edge_enhancement_tpu.parallel import mesh as jmesh
from edge_enhancement_tpu.parallel import sharding as jsharding
from edge_enhancement_tpu.train import modelops as jmodelops
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.convert import arch_state_dict_from_jax
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.parallel import mesh as tmesh
from edge_enhancement_tpu_torch.parallel import sharding
from edge_enhancement_tpu_torch.train import checkpoint, driver
from edge_enhancement_tpu_torch.train.trainer import (OptimConfig, build_eval_step,
                                                      build_train_step)
from edge_enhancement_tpu_torch.utils.config import load_config

MNIST_AT = os.path.join(REPO, "edge_enhancement_tpu", "configs", "mnist",
                        "adversarial_training.yml")
# JAX's test: PGD-2, eps 0.3, step 0.1, 16 images, lr 0.1, momentum 0.9, wd 1e-4
NET2_OVER = dict(num_steps_1=2, epsilon=0.3, step_size_1=0.1, seed=3, device="cpu")
FLAGSHIP_OVER = dict(num_steps_1=2, seed=3, device="cpu")
LR, MOMENTUM, WD = 0.1, 0.9, 1e-4
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def _model_rows(sd, m, n_model):
    """A one-process state dict (or {name: momentum buffer}) cut to model
    rank m of n_model: each cut tensor's m-th block of rows."""
    return {k: v.chunk(n_model)[m] if sharding.param_spec(k, v) is not None else v
            for k, v in sd.items()}


def _gather_row(ranks, names, key="state"):
    """One data row's model ranks joined into the one-process layout: a cut
    tensor concatenated over the ranks, a replicated one bitwise equal on
    every rank."""
    out = {}
    for name in names:
        parts = [r[key][name] for r in ranks]
        if sharding.param_spec(name, parts[0]) is not None:
            out[name] = torch.cat(parts)
        else:
            assert all(torch.equal(parts[0], p) for p in parts[1:]), name
            out[name] = parts[0]
    return out


def _check_rows_and_replicas(ranks, n_model, full_shapes):
    """Each rank's conv and dense weights hold out / n_model rows, every
    other tensor its full shape; the data rows' replicas are bitwise
    equal."""
    for r in ranks:
        for name, shape in r["shapes"].items():
            want = full_shapes[name]
            if sharding.param_spec(name, torch.empty(want, device="meta")) is not None:
                assert shape == (want[0] // n_model,) + want[1:], name
            else:
                assert shape == want, name
    for r, res in enumerate(ranks[n_model:], n_model):
        first = ranks[r % n_model]
        assert all(torch.equal(v, res["state"][k]) for k, v in first["state"].items())
        assert all(torch.equal(a, b) for a, b in zip(first["momentum"], res["momentum"]))
        assert first["metrics"] == res["metrics"]


def _one_process(cfg, n, x, y, vx, vy, monkeypatch):
    """The same step and validation batch in one process (no group): the
    state, the metrics and the first attack gradient."""
    ops, state, gen = driver.build(cfg, n, torch.device("cpu"))
    state.model.double()
    state.momentum_buf = [b.double() for b in state.momentum_buf]
    grads, real = [], tpgd._input_grad

    def kept(loss_fn, xx):
        grads.append(real(loss_fn, xx))
        return grads[-1]
    monkeypatch.setattr(tpgd, "_input_grad", kept)
    opt = OptimConfig(MOMENTUM, WD)
    m = build_train_step(ops, driver.make_method_config(cfg, n), opt, gen)(
        state, x.double(), y, LR)
    ev = build_eval_step(ops, driver.eval_attack(cfg, n), gen)(state, vx.double(), vy)
    return state, m, ev, grads[0], opt


def _mesh_against_one_process(tmp_path, monkeypatch, cfg, n, shape, world, n_model):
    """tp_step on the mesh against one process: returns (ranks, the one
    process's state, first attack gradient) after checking the state, the
    metrics, the validation batch and the checkpoint round trips."""
    rng = np.random.default_rng(4)
    x, vx = (torch.from_numpy(rng.random(shape).astype(np.float32)) for _ in range(2))
    y, vy = (torch.from_numpy(rng.integers(0, n, shape[0]).astype(np.int64))
             for _ in range(2))
    state, m, ev, grad0, opt = _one_process(cfg, n, x, y, vx, vy, monkeypatch)
    resume = checkpoint.save_checkpoint(str(tmp_path / "one"), state, 7, cfg["arch"],
                                        0.0, False, opt, LR)
    ckpt = tmp_path / "mesh"
    ranks = run_ranks(tmp_path, "tp_step", dict(
        cfg=dict(cfg), num_classes=n, x=x, y=y, vx=vx, vy=vy, lr=LR, momentum=MOMENTUM,
        weight_decay=WD, dir=str(ckpt), resume=resume), world=world, n_model=n_model)
    sd = state.model.state_dict()
    names = [k for k, _ in state.model.named_parameters()]
    _check_rows_and_replicas(ranks, n_model, {k: tuple(v.shape) for k, v in sd.items()})
    row = ranks[:n_model]
    got = _gather_row(row, sd)
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, **F64_TOL, msg=k)
    got_m = _gather_row([dict(r, mom=dict(zip(names, r["momentum"]))) for r in row],
                        names, "mom")
    for k, v in zip(names, state.momentum_buf):
        torch.testing.assert_close(got_m[k], v, **F64_TOL, msg=k)
    # the ResNets' logits are float32 (models/resnet.py): one ulp of the sum
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(m["loss"]), rtol=1e-6)
    assert ranks[0]["metrics"]["top1"] == pytest.approx(float(m["top1"]), abs=1e-4)
    for k, v in ev.items():
        assert ranks[0]["eval"][k] == pytest.approx(float(v), rel=1e-6, abs=1e-4), k

    # (d) the model axis's checkpoint is the one-process file of its state,
    # bit for bit, and loads into one process
    payload = checkpoint.load_checkpoint(str(ckpt))
    assert sorted(payload["state_dict"]) == sorted(sd) and payload["epoch"] == 1
    for k, v in got.items():
        assert torch.equal(payload["state_dict"][k], v), k
    for i, k in enumerate(names):
        assert torch.equal(payload["optimizer"]["state"][i]["momentum_buffer"], got_m[k]), k
    checkpoint.restore_into_state(state, payload)
    assert all(torch.equal(state.model.state_dict()[k], v) for k, v in got.items())
    # ... and the ranks resumed from the one-process file: each its rows
    one = checkpoint.load_checkpoint(resume)
    for r, res in enumerate(ranks):
        cut = _model_rows(one["state_dict"], r % n_model, n_model)
        restored = res["restored"]
        assert restored["epoch"] == 7
        assert all(torch.equal(restored["state"][k], v) for k, v in cut.items())
        cut_m = _model_rows({k: one["optimizer"]["state"][i]["momentum_buffer"]
                             for i, k in enumerate(names)}, r % n_model, n_model)
        assert all(torch.equal(a, cut_m[k]) for k, a in zip(names, restored["momentum"]))
    # free-AT's noise: one file a data rank, written by its model rank 0
    n_data = world // n_model
    assert [res["noise_path"] for res in ranks] == [
        f"noise_p{r // n_model}.pt" if n_data > 1 else "noise.pt" for r in range(world)]
    return ranks, grad0


# ---- (a) + (d) ---------------------------------------------------------------

def test_net2_data2_model2_step_equals_one_process_in_float64(tmp_path, monkeypatch):
    """Net2's AT step (PGD-2, eps 0.3, its dropout masks and PGD start from
    the run's generator at the global batch's shape) on 4 ranks, data 2 x
    model 2: each rank's conv and dense weights hold out / 2 rows; the
    data rows' replicas bitwise equal; the state after the step, the loss
    and a validation batch (PGD-2, the cut model in eval mode) against one
    process on the global batch of 16, float64: 1e-10."""
    cfg = load_config(MNIST_AT, NET2_OVER)
    ranks, grad0 = _mesh_against_one_process(tmp_path, monkeypatch, cfg, 10,
                                             (16, 28, 28, 1), 4, 2)
    got = torch.cat([ranks[0]["grad0"], ranks[2]["grad0"]])
    torch.testing.assert_close(got, grad0, **F64_TOL)
    assert ranks[0]["shapes"]["fc2.weight"] == (5, 1024)
    assert ranks[0]["shapes"]["conv1.weight"] == (16, 1, 5, 5)


# ---- (c) + (d) ---------------------------------------------------------------

def test_flagship_model2_step_equals_one_process_in_float64(tmp_path, monkeypatch):
    """The flagship's step (resnet18_EE_square, EE_BPDA3_AT_square, PGD-2,
    32 px, 16 classes, 16 images) on data 1 x model 2 against one process,
    float64: the first attack step's input gradient to 1e-10 (a missing
    model-group sum of the input gradient would leave each rank about half
    of it), then the state, the loss and a validation batch."""
    cfg = load_config(CONFIG, FLAGSHIP_OVER)
    ranks, grad0 = _mesh_against_one_process(tmp_path, monkeypatch, cfg, 16,
                                             (16, 32, 32, 3), 2, 2)
    for r in ranks:
        torch.testing.assert_close(r["grad0"], grad0, **F64_TOL)
    assert float(grad0.abs().max()) > 0
    assert ranks[1]["shapes"]["layer4.1.conv2.weight"] == (256, 512, 3, 3)


# ---- (b) ---------------------------------------------------------------------

# JAX's own TP-vs-DP tolerance (tests/test_tensor_parallel.py: atol 2e-6,
# rtol 2e-5). Measured by this test (the port in float32 on 4 ranks
# against JAX's 4-device data 2 x model 2 step): the port's own x_adv is
# JAX's at every pixel (share 0); the loss 7.0e-8 relative; the
# parameters at most 6.0e-8 apart and the momentum 1.8e-7 (on values up
# to 0.44).
NET2_JAX_TOL = dict(share=0.0, atol=2e-6, rtol=2e-5)


def _jax_net2_mesh_step(monkeypatch, x, y, noise):
    """JAX's Net2 AT step on make_mesh(n_data=2, n_model=2) with the state
    sharded by its sharding.py, the PGD start replayed; (metrics, state,
    x_adv, dropout masks, initial params). An ordered callback does not
    run on several devices, so the masks come out of the same step on one
    device, on the same key (jax.random's draws do not depend on the
    sharding)."""
    ops = jmodelops.ModelOps(net2())
    state = jtrainer.create_train_state(ops, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    params0 = helpers.to_numpy_tree(state.params)
    mcfg = jmethods.MethodConfig("AT", epsilon=0.3, num_steps=2, step_size=0.1,
                                 num_classes=10)
    monkeypatch.setattr(jpgd, "_init_perturbation",
                        lambda cfg, key, xx: jnp.clip(xx + noise, 0.0, 1.0))
    dropout = helpers.JaxDropoutCapture()
    monkeypatch.setattr(jax.random, "bernoulli", dropout)
    one = jtrainer.build_train_step(ops, mcfg, jtrainer.OptimConfig(MOMENTUM, WD))
    jax.block_until_ready(one(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(1),
                              jnp.float32(LR)))
    jax.effects_barrier()
    monkeypatch.setattr(jax.random, "bernoulli", dropout.real)
    cap = {}
    monkeypatch.setattr(jmethods, "pgd_linf", helpers._jax_spy(cap))
    mesh = jmesh.make_mesh(n_data=2, n_model=2)
    s_tp = jsharding.shard_state(mesh, state)
    assert "model" in str(s_tp.params["Dense_0"]["kernel"].sharding.spec)
    step = jtrainer.build_train_step(ops, mcfg, jtrainer.OptimConfig(MOMENTUM, WD),
                                     mesh=mesh,
                                     state_sharding=jsharding.state_shardings(mesh, s_tp))
    xb, yb = jmesh.shard_batch(mesh, (jnp.asarray(x), jnp.asarray(y)))
    new, m = step(s_tp, xb, yb, jax.random.PRNGKey(1), jnp.float32(LR))
    jax.block_until_ready(new)
    jax.effects_barrier()
    return m, jax.device_get(new), cap["x_adv"], dropout.masks, params0


def test_net2_data2_model2_step_agrees_with_jax_mesh_step(monkeypatch, tmp_path):
    """The Net2 step in float32 on 4 ranks (data 2 x model 2) against JAX's
    own data 2 x model 2 step, on the same PGD start and JAX's dropout
    masks (each rank its data rows): the share of x_adv pixels off JAX's,
    then on JAX's x_adv the loss, top-1, parameters and momentum
    (NET2_JAX_TOL)."""
    rng = np.random.default_rng(3)
    x = rng.random((16, 28, 28, 1)).astype(np.float32)
    y = (np.arange(16) % 10).astype(np.int32)
    noise = rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
    m_j, state_j, x_adv_j, masks, params0 = _jax_net2_mesh_step(monkeypatch, x, y, noise)
    assert len(masks) == 3                       # 2 attack forwards, the trained one
    t = torch.from_numpy
    ranks = run_ranks(tmp_path, "tp_replay", dict(
        arch="Net2", num_classes=10, state=arch_state_dict_from_jax("Net2", params0, {}),
        masks=[t(mk) for mk in masks], noise=t(noise), x_adv=t(np.array(x_adv_j)),
        x=t(x), y=t(y).long(), method="AT",
        fields=dict(epsilon=0.3, num_steps=2, step_size=0.1, num_classes=10),
        lr=LR, momentum=MOMENTUM, weight_decay=WD), world=4, n_model=2)
    names = list(ranks[0]["state"])
    for r in (2, 3):
        assert all(torch.equal(ranks[r - 2]["state"][k], ranks[r]["state"][k]) for k in names)
    x_adv = torch.cat([ranks[0]["x_adv"], ranks[2]["x_adv"]]).numpy()
    share = float(np.mean(np.abs(x_adv - np.asarray(x_adv_j)) > 1e-6))
    assert share <= NET2_JAX_TOL["share"], share
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(m_j["loss"]), rtol=2e-6)
    assert ranks[0]["metrics"]["top1"] == pytest.approx(float(m_j["top1"]), abs=1e-4)
    got = _gather_row(ranks[:2], names)
    want = arch_state_dict_from_jax("Net2", helpers.to_numpy_tree(state_j.params), {})
    mom = _gather_row([dict(r, mom=dict(zip(names, r["momentum"]))) for r in ranks[:2]],
                      names, "mom")
    want_m = arch_state_dict_from_jax("Net2", helpers.to_numpy_tree(state_j.momentum_buf), {})
    tol = dict(atol=NET2_JAX_TOL["atol"], rtol=NET2_JAX_TOL["rtol"])
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol, err_msg=k)
        np.testing.assert_allclose(mom[k].numpy(), want_m[k].numpy(), **tol, err_msg=k)


# ---- (e) ---------------------------------------------------------------------

@pytest.mark.parametrize("arch,size,layer", [("Net2", 4, "fc2"), ("Net2", 3, "conv1"),
                                             ("resnet18", 3, "conv1")])
def test_indivisible_output_width_names_the_layer(monkeypatch, arch, size, layer):
    """Net2's fc2 (10 classes) over a model axis of 4, its conv1 (32) and
    the ResNet's stem (64) over 3: ValueError naming the layer, and the
    model is left whole. Needs no ranks (the mesh's model rank and axis
    stood in for)."""
    monkeypatch.setattr(tmesh, "model_size", lambda: size)
    monkeypatch.setattr(tmesh, "model_rank", lambda: 0)
    model = build_model(arch, {}, 10)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=rf"^{layer}: \d+ output channels do not divide "
                                         rf"over a model axis of {size}"):
        sharding.shard_model(model)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert sharding.param_spec("layer1.0.bn1.weight", torch.ones(64)) is None
    assert sharding.param_spec("fc.bias", torch.ones(10)) is None
    assert sharding.param_spec("conv1.weight", torch.ones(64, 3, 7, 7)) == 0


# ---- (f) ---------------------------------------------------------------------

def test_replicated_gradients_are_averaged_over_the_model_group(tmp_path):
    """mesh.sum_step on data 2 x model 2 (rank r: data r // 2, model r % 2).
    Every gradient r + 1 on rank r: a cut weight's becomes its data group's
    sum, (m + 1) + (m + 3) on model rank m; a replicated one's (biases) the
    model group's mean of those, 5 on every rank; the loss the data group's
    sum. Gradients alike on a data row's model ranks: a replicated one is
    the data group's sum bit for bit ((g + g) / 2 == g)."""
    world, n_model = 4, 2
    ranks = run_ranks(tmp_path, "tp_sum", {}, world=world, n_model=n_model)
    names = ranks[0]["names"]
    assert any(sharding.param_spec(n, g) is None for n, g in zip(names, ranks[0]["apart"]))
    for r, res in enumerate(ranks):
        m = r % n_model
        assert res["loss"] == 2 * m + 2
        for name, g, alike, data_sum in zip(names, res["apart"], res["alike"],
                                            res["data_sum"]):
            cut = sharding.param_spec(name, g) is not None
            assert torch.all(g == (2 * m + 4 if cut else 5)), name
            assert torch.equal(alike, data_sum), name


# ---- (g) ---------------------------------------------------------------------

AWP_CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "awp_cifar100",
                          "at_awp.yml")
AWP_SHAPE = (4, 16, 16, 3)
# (awp_on, l1): the gate off and on; the L1 term, whose cut weights' parts
# are summed over the model group
AWP_VARIANTS = ((0.0, 0.0), (1.0, 0.0), (1.0, 1e-3))
AWP_PARAMS = dict(gamma=0.01, proxy_lr=0.01)


def _awp_one_process(cfg, x, y, awp_on, l1):
    """One AWP step of the config's model in one process, float64."""
    from edge_enhancement_tpu_torch.objectives import awp as tawp
    ops, state, gen = driver.build(cfg, 100, torch.device("cpu"))
    state.model.double()
    state.momentum_buf = [b.double() for b in state.momentum_buf]
    step = tawp.build_awp_train_step(ops, driver.make_method_config(cfg, 100),
                                     OptimConfig(MOMENTUM, WD),
                                     tawp.AWPConfig(l1=l1, **AWP_PARAMS), gen)
    m = step(state, x.double(), y, LR, awp_on)
    return state, m


@pytest.mark.parametrize("world,n_model", [(2, 2), (4, 2)])
def test_awp_on_a_model_axis_equals_one_process_in_float64(tmp_path, world, n_model):
    """AWP steps of PreActResNet18 (awp_cifar100/at_awp.yml, PGD-1, 4
    images of 16 px, its PGD start from the run's generator) on data
    world / n_model x model n_model, each (awp_on, l1) of AWP_VARIANTS from
    the same weights: every rank's gathered state bitwise alike, and
    against one process on the global batch, float64: parameters,
    BatchNorm statistics and momentum 1e-10, the loss 1e-6 (float32
    logits). A cut weight's norms taken on its rows alone would move the
    perturbation and miss."""
    cfg = load_config(AWP_CONFIG, dict(num_steps_1=1, seed=3, device="cpu"))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random(AWP_SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 100, AWP_SHAPE[0]).astype(np.int64))
    ranks = run_ranks(tmp_path, "awp", dict(
        cfg=dict(cfg), num_classes=100, x=x, y=y, variants=AWP_VARIANTS, lr=LR,
        momentum=MOMENTUM, weight_decay=WD, **AWP_PARAMS), world=world, n_model=n_model)
    for i, (awp_on, l1) in enumerate(AWP_VARIANTS):
        got = ranks[0]["variants"][i]
        for r in ranks[1:]:
            other = r["variants"][i]
            assert other["metrics"] == got["metrics"]
            assert all(torch.equal(v, other["state"][k]) for k, v in got["state"].items())
            assert all(torch.equal(a, b) for a, b in zip(got["momentum"], other["momentum"]))
        state, m = _awp_one_process(cfg, x, y, awp_on, l1)
        assert got["step"] == state.step == 1
        for k, v in state.model.state_dict().items():
            torch.testing.assert_close(got["state"][k], v, **F64_TOL, msg=k)
        for a, b in zip(got["momentum"], state.momentum_buf):
            torch.testing.assert_close(a, b, **F64_TOL)
        np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]), rtol=1e-6)
        assert got["metrics"]["top1"] == pytest.approx(float(m["top1"]), abs=1e-4)
