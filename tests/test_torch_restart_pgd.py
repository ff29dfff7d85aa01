"""The port's multi-restart PGD and mixup helpers
(edge_enhancement_tpu_torch/attacks/restart_pgd.py) against the JAX
package's, on a fixed linear logits closure (as tests/test_attacks.py's
TestRestartPGD), with JAX's draws recomputed from its key outside the
trace and fed to the port's draw functions; and the draw sharing of
attack_pgd's forwards on resnet18_EE_square."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.attacks import restart_pgd as jrp
from edge_enhancement_tpu.train.modelops import cross_entropy as jce
from edge_enhancement_tpu_torch.attacks import restart_pgd as trp
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train.modelops import ModelOps, cross_entropy

SHAPE, NC = (8, 4, 4, 3), 10


def _linear():
    rng = np.random.default_rng(20)
    w = rng.normal(0, 1, (48, NC)).astype(np.float32)
    x = rng.random(SHAPE).astype(np.float32)
    logits = x.reshape(8, -1) @ w
    # six samples correct, two wrong: early stop freezes the wrong ones
    y = logits.argmax(1).astype(np.int32)
    y[6:] = (y[6:] + 1) % NC
    wt = torch.from_numpy(w)

    def fwd_j(xx, key):
        return xx.reshape(xx.shape[0], -1) @ jnp.asarray(w)

    def fwd_t(xx, draws):
        return xx.reshape(xx.shape[0], -1) @ wt
    return x, y, fwd_j, fwd_t


def jax_restart_draws(key, cfg, shape):
    """attack_pgd's start draws, one per restart, as it splits its key."""
    draws = []
    for _ in range(cfg.restarts):
        key, k_init, _ = jax.random.split(key, 3)
        if cfg.norm == "l_inf":
            d = jax.random.uniform(k_init, shape, minval=-cfg.epsilon, maxval=cfg.epsilon)
        else:
            d = jax.random.normal(k_init, shape)
        draws.append(np.asarray(d))
        key, _ = jax.random.split(key)
    return draws


CASES = {
    "l_inf": dict(epsilon=0.1, alpha=0.03, attack_iters=5, restarts=3, norm="l_inf"),
    "l_2": dict(epsilon=0.5, alpha=0.1, attack_iters=5, restarts=2, norm="l_2"),
    "l_inf_no_early_stop": dict(epsilon=0.1, alpha=0.03, attack_iters=4,
                                restarts=2, norm="l_inf", early_stop=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attack_pgd_matches_jax(monkeypatch, case):
    """JAX's attack_pgd (unpatched) and the port's on JAX's start draws:
    the best delta within 1e-6 (l_inf: sign steps of the same gradient and
    the same clips; l_2: norms summed in another order, a few float32
    ulps), the ball and the box kept, and no correct sample's loss
    lowered."""
    x, y, fwd_j, fwd_t = _linear()
    cfg = dict(CASES[case])
    key = jax.random.PRNGKey(21)
    want = np.asarray(jrp.attack_pgd(fwd_j, jnp.asarray(x), jnp.asarray(y), key,
                                     jrp.RestartPGDConfig(**cfg)))
    draws = jax_restart_draws(key, jrp.RestartPGDConfig(**cfg), SHAPE)
    monkeypatch.setattr(trp, "delta_draw",
                        lambda xx, c, gen: torch.from_numpy(np.array(draws.pop(0))))
    got = trp.attack_pgd(fwd_t, torch.from_numpy(x), torch.from_numpy(y),
                         trp.RestartPGDConfig(**cfg)).numpy()
    assert not draws
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if cfg["norm"] == "l_inf":
        assert np.abs(got).max() <= cfg["epsilon"] + 1e-6
    else:
        assert (np.linalg.norm(got.reshape(8, -1), axis=1) <= cfg["epsilon"] + 1e-4).all()
    assert ((x + got) >= -1e-6).all() and ((x + got) <= 1 + 1e-6).all()
    ce = lambda d: cross_entropy(fwd_t(torch.from_numpy(x + d), None),
                                 torch.from_numpy(y), "none").numpy()
    assert (ce(got)[:6] >= ce(np.zeros_like(x))[:6] - 1e-5).all()


def test_mixup_matches_jax(monkeypatch):
    """mixup_data on JAX's lam and permutation: the mixed batch within
    1e-7 (the same two float32 products and add); mixup_criterion within
    float32 rounding; the port's own draws: lam in [0, 1] and a
    permutation."""
    x = np.array(jax.random.uniform(jax.random.PRNGKey(0), (8, 4, 4, 1)))
    y = np.arange(8, dtype=np.int32) % 4
    key = jax.random.PRNGKey(1)
    mx_j, ya_j, yb_j, lam_j = jrp.mixup_data(jnp.asarray(x), jnp.asarray(y), key, alpha=1.0)
    k_lam, k_perm = jax.random.split(key)
    lam = float(jax.random.beta(k_lam, 1.0, 1.0))
    idx = np.array(jax.random.permutation(k_perm, 8))
    monkeypatch.setattr(trp, "mixup_draws",
                        lambda n, a, gen, dev=None: (lam, torch.from_numpy(idx).long()))
    mx, ya, yb, lam_t = trp.mixup_data(torch.from_numpy(x), torch.from_numpy(y))
    assert lam_t == float(lam_j)
    np.testing.assert_allclose(mx.numpy(), np.asarray(mx_j), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(yb.numpy(), np.asarray(yb_j))
    np.testing.assert_array_equal(ya.numpy(), np.asarray(ya_j))
    pred = np.array(jax.random.normal(jax.random.PRNGKey(2), (8, 4)))
    want = jrp.mixup_criterion(lambda p, t: jce(p, t, "mean"), jnp.asarray(pred),
                               ya_j, yb_j, lam_j)
    got = trp.mixup_criterion(lambda p, t: cross_entropy(p, t, "mean"),
                              torch.from_numpy(pred), ya, yb, lam_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(3)
    lam2, perm = trp.mixup_draws(8, 1.0, gen)
    assert 0.0 <= lam2 <= 1.0 and sorted(perm.tolist()) == list(range(8))
    assert trp.mixup_draws(8, 0.0, gen)[0] == 1.0


def test_normalize_is_exact():
    x = np.random.default_rng(4).random((2, 3, 3, 3)).astype(np.float32)
    want = np.asarray(jrp.normalize(jnp.asarray(x)))
    np.testing.assert_array_equal(trp.normalize(torch.from_numpy(x)).numpy(), want)
    assert trp.CIFAR100_MEAN == jrp.CIFAR100_MEAN and trp.CIFAR100_STD == jrp.CIFAR100_STD


def test_attack_pgd_shares_one_draw_per_iteration(monkeypatch):
    """JAX takes an iteration's early-stop logits and its gradient under one
    key (restart_pgd.py:75-79) and the restart's final loss under another
    (:91): on resnet18_EE_square, one forward an iteration and one a
    restart, each with a fresh square draw."""
    source = helpers.RecordingSource()
    model = build_model("resnet18_EE_square", helpers.EE_ARGS, 200,
                        square_source=source, generator=torch.Generator().manual_seed(1))
    ops = ModelOps(model)
    used = helpers.record_forwards(monkeypatch, source)
    x = torch.from_numpy(np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32))
    cfg = trp.RestartPGDConfig(epsilon=helpers.EPS, alpha=2 / 255, attack_iters=3,
                               restarts=2)
    delta = trp.attack_pgd(ops.logits_eval, x, torch.tensor([1, 2]), cfg, source.gen,
                           draw=ops.square_draws)
    assert used == list(range(cfg.restarts * (cfg.attack_iters + 1)))
    assert float(delta.abs().max()) <= helpers.EPS + 1e-6
