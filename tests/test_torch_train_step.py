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

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import torch_port_helpers as helpers


def test_train_step_matches_jax(monkeypatch):
    port, jax_side = helpers.train_step_pair(monkeypatch)
    assert not port[2].ee.with_gf
    helpers.assert_train_steps_agree(port, jax_side)
