"""K train steps a dispatch (train/graphs.py, trainer.build_chained_train_step)
on the CPU: the port's chained dispatch against the JAX package's
build_chained_train_step (a lax.scan over the batch stack) on carried
weights and replayed draws, and against the port's own K single steps,
bit for bit; the learning rate as a float and as a 0-dim tensor. Under
gloo ranks (tests/torch_parallel_worker.py, as tests/test_torch_parallel.py
starts them): on data 2 and on data 2 x model 2 the chained step against
one process on the global batch in float64 and against 2 single steps on
the same ranks bit for bit; on data 2, data 4 and data 2 x model 2 against
JAX's chained step on the same mesh of host devices."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)

import types

import numpy as np
import pytest
import torch

import torch_port_helpers as helpers
from test_torch_parallel import CONFIG, run_ranks
from edge_enhancement_tpu_torch.train import driver
from edge_enhancement_tpu_torch.utils.config import load_config
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.objectives.methods import MethodConfig
from edge_enhancement_tpu_torch.train import trainer
from edge_enhancement_tpu_torch.train.graphs import ChainedTrainStep
from edge_enhancement_tpu_torch.train.sgd import sgd_update
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.ops.square import add_square_draws

# Against JAX (tests/torch_port_helpers.py::chained_step_pair): K = 2 steps
# of a 1-step PGD, both sides in float64 (in float32 this model's second
# step at this size moves ~40% of its largest gradient for the first
# step's 4e-5 difference between the libraries). At the single step's
# tolerances (JAX_TOL): each step's x_adv at most 5% of pixels off JAX's
# (measured 0 and 0.55%); then, every step trained on JAX's x_adv, the
# state after the chain, parameters 1e-4 (measured 7.6e-6 relative),
# running statistics 2e-3 (2.8e-5) and momentum 1e-3 (6.2e-5); the last
# step's loss within 2e-5 relative (6.6e-7), its top-1 equal. JAX's
# float32 islands (its logits, constants) keep the float64 sides ~1e-7
# apart a step, which the next step multiplies: a 2-step PGD or K = 3
# parts past these tolerances.
CHAIN_TOL = dict(loss=2e-5)


def test_chained_step_matches_jax(monkeypatch):
    port, jax_side = helpers.chained_step_pair(monkeypatch, k=2, pgd_steps=1)
    helpers.assert_chained_steps_agree(port, jax_side, CHAIN_TOL)


def _flagship(seed=3):
    """A small flagship model (resnet18_EE_square, 10 classes) on its own
    generator, its ModelOps, a fresh state and 3 batches of uint8 pixels."""
    gen = torch.Generator().manual_seed(seed)
    args = dict(helpers.EE_ARGS)
    model = build_model("resnet18_EE_square", args, 10,
                        square_source=lambda shape: add_square_draws(shape, gen),
                        generator=torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    xs = torch.randint(0, 256, (3, 4, 16, 16, 3), generator=data, dtype=torch.uint8)
    ys = torch.randint(0, 10, (3, 4), generator=data)
    return gen, model, xs, ys


def _step_parts(gen, model):
    method = MethodConfig("EE_BPDA3_AT_square", epsilon=helpers.EPS, num_steps=2,
                          step_size=helpers.STEP_SIZE, num_classes=10)
    return ModelOps(model), method, trainer.OptimConfig(0.9, 2e-4)


def _state_tensors(state):
    return [*state.model.state_dict().values(), *state.momentum_buf]


def test_chained_step_equals_single_steps():
    """One chained dispatch of K = 3 on the CPU (the loop form) equals 3
    build_train_step calls from the same seed bit for bit: parameters,
    BatchNorm statistics, momentum, the last metrics; state.step moves
    by 3."""
    gen, model, xs, ys = _flagship()
    ops, method, opt = _step_parts(gen, model)
    single = trainer.create_train_state(model)
    step = trainer.build_train_step(ops, method, opt, gen)
    for x, y in zip(xs, ys):
        m_single = step(single, x, y, 0.1)

    gen2, model2, _, _ = _flagship()
    ops2, method2, opt2 = _step_parts(gen2, model2)
    chained = trainer.create_train_state(model2)
    chain = trainer.build_chained_train_step(ops2, method2, opt2, gen2)
    assert isinstance(chain, ChainedTrainStep)
    m_chain = chain(chained, xs, ys, 0.1)
    assert single.step == chained.step == 3
    assert chain.capture_seconds is None          # the CPU runs the loop
    for a, b in zip(_state_tensors(single), _state_tensors(chained)):
        assert torch.equal(a, b)
    for key in ("loss", "top1", "top5"):
        assert torch.equal(m_single[key], m_chain[key]), key


def test_float_and_tensor_lr_give_the_same_bits():
    """sgd_update and a whole train step with lr as a float and as a 0-dim
    float32 tensor (the CUDA graph's form): the same bits."""
    g = torch.Generator().manual_seed(5)
    params = [torch.randn(7, 3, generator=g) for _ in range(3)]
    grads = [torch.randn(7, 3, generator=g) for _ in range(3)]
    out = []
    for lr in (0.1, torch.full((), 0.1)):
        ps, bufs = [p.clone() for p in params], [torch.zeros(7, 3) for _ in params]
        for _ in range(3):
            sgd_update(ps, grads, bufs, lr=lr, momentum=0.9, weight_decay=2e-4)
        out.append(ps + bufs)
    assert all(torch.equal(a, b) for a, b in zip(*out))

    states = []
    for lr in (0.1, torch.full((), 0.1)):
        gen, model, xs, ys = _flagship()
        ops, method, opt = _step_parts(gen, model)
        state = trainer.create_train_state(model)
        trainer.build_train_step(ops, method, opt, gen)(state, xs[0], ys[0], lr)
        states.append(_state_tensors(state))
    assert all(torch.equal(a, b) for a, b in zip(*states))



# ---- under several ranks -------------------------------------------------------

RANK_SHAPE = (8, 32, 32, 3)              # the global batch: 4 images a data rank of 2


def _chain_on_ranks(tmp_path, n_data: int, n_model: int):
    """The flagship's chained step (K = 2, PGD-1, float64, its draws from
    the run's generator at the global batch's shape) and 2 single steps on
    n_data x n_model gloo ranks (the loop form), then one process's chained
    step on the global batch: (the ranks' results, the one process's
    metrics and state)."""
    cfg = load_config(CONFIG, dict(num_steps_1=1, seed=3, device="cpu"))
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.random((2,) + RANK_SHAPE).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 200, (2, RANK_SHAPE[0])).astype(np.int64))
    lr, opt = 0.1, trainer.OptimConfig(0.9, 2e-4)
    ranks = run_ranks(tmp_path, "chain", dict(
        cfg=dict(cfg), num_classes=200, xs=xs, ys=ys, dtype=torch.float64, lr=lr,
        momentum=opt.momentum, weight_decay=opt.weight_decay),
        world=n_data * n_model, n_model=n_model)
    ops, state, gen = driver.build(cfg, 200, torch.device("cpu"))
    state.model.double()
    state.momentum_buf = [b.double() for b in state.momentum_buf]
    m = trainer.build_chained_train_step(ops, driver.make_method_config(cfg, 200), opt,
                                         gen)(state, xs.double(), ys, lr)
    return ranks, m, state


def _assert_chain_on_ranks(ranks, m, state):
    """On each rank the chained dispatch equals the 2 single steps bit for
    bit (parameters, BatchNorm statistics, momentum, step, last metrics),
    the replicas (gathered over the model axis) bitwise equal; against the
    one process: 1e-10."""
    for r in ranks:
        single, chained = r["single"], r["chained"]
        assert single["step"] == chained["step"] == 2
        assert single["metrics"] == chained["metrics"]
        assert all(torch.equal(v, chained["state"][k]) for k, v in single["state"].items())
        assert all(torch.equal(a, b) for a, b in zip(single["momentum"], chained["momentum"]))
    for r in ranks[1:]:
        assert r["chained"]["metrics"] == ranks[0]["chained"]["metrics"]
        assert all(torch.equal(v, r["chained"]["state"][k])
                   for k, v in ranks[0]["chained"]["state"].items())
    got = ranks[0]["chained"]
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(got["state"][k], v, rtol=1e-10, atol=1e-10, msg=k)
    for a, b in zip(got["momentum"], state.momentum_buf):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    # float32 logits (models/resnet.py): the loss is a float32 sum
    np.testing.assert_allclose(got["metrics"]["loss"], float(m["loss"]), rtol=1e-6)
    assert got["metrics"]["top1"] == float(m["top1"])


def test_two_rank_chained_step_equals_one_process_and_single_steps(tmp_path):
    """The flagship's chained step on 2 gloo ranks (data 2): on each rank
    bit for bit the same 2 batches as 2 single steps, the replicas bitwise
    equal; against one process's chained step on the global batch,
    float64: 1e-10."""
    _assert_chain_on_ranks(*_chain_on_ranks(tmp_path, 2, 1))


def test_model_axis_chained_step_equals_one_process_and_single_steps(tmp_path):
    """The same on 4 gloo ranks of data 2 x model 2 (every convolution and
    the head cut on their output channels, parallel/sharding.py): on each
    rank the chained dispatch equals 2 single steps bit for bit, the
    gathered replicas are bitwise equal, and one process agrees to 1e-10
    in float64."""
    ranks, m, state = _chain_on_ranks(tmp_path, 2, 2)
    assert [r["world"] for r in ranks] == [4] * 4
    _assert_chain_on_ranks(ranks, m, state)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (4, 1), (2, 2)])
def test_chained_step_on_ranks_agrees_with_jax_mesh(monkeypatch, tmp_path, n_data, n_model):
    """The chained step (K = 2, PGD-1, float64) on n_data x n_model gloo
    ranks against JAX's build_chained_train_step jitted over
    make_mesh(n_data, n_model), its state laid out by JAX's sharding.py
    (state_sharding) and its stacks sharded by shard_batch_stacked, on the
    draws replayed from JAX (each data rank its rows) and JAX's x_adv for
    each update: the replicas (gathered over the model axis) bitwise
    equal, then CHAIN_TOL as on one process."""
    port, jax_side = helpers.chained_step_jax(monkeypatch, k=2, pgd_steps=1, n_data=n_data,
                                              n_model=n_model)
    t = torch.from_numpy
    ranks = run_ranks(tmp_path, "chain_replay", dict(
        arch="resnet18_EE_square", ee_args=helpers.EE_ARGS, num_classes=200,
        state=port["model"].state_dict(), draws=[tuple(t(a) for a in d) for d in port["draws"]],
        noise=[t(n) for n in port["noise"]], x_adv=[t(a.copy()) for a in jax_side[2]],
        xs=t(port["xs"]), ys=t(port["ys"]).long(), method="EE_BPDA3_AT_square",
        fields=port["fields"], lr=helpers.LR, momentum=helpers.MOMENTUM,
        weight_decay=helpers.WD), world=n_data * n_model, n_model=n_model)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        assert all(torch.equal(v, r["state"][k]) for k, v in ranks[0]["state"].items())
        assert all(torch.equal(a, b) for a, b in zip(ranks[0]["momentum"], r["momentum"]))
    model = port["model"].double()
    model.load_state_dict(ranks[0]["state"])
    state = types.SimpleNamespace(step=ranks[0]["step"], momentum_buf=ranks[0]["momentum"])
    heads = ranks[::n_model]                  # model rank 0 of each data row
    x_adv = [torch.cat([r["x_adv"][i] for r in heads]).numpy() for i in range(2)]
    helpers.assert_chained_steps_agree((ranks[0]["metrics"], state, model, x_adv),
                                       jax_side, CHAIN_TOL)
