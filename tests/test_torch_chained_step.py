"""K train steps a dispatch (train/graphs.py, trainer.build_chained_train_step)
on the CPU: the port's chained dispatch against the JAX package's
build_chained_train_step (a lax.scan over the batch stack) on carried
weights and replayed draws, and against the port's own K single steps,
bit for bit; the learning rate as a float and as a 0-dim tensor."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)

import torch

import torch_port_helpers as helpers
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

