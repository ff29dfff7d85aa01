"""The port's training objectives against the JAX package's: one train step
of every objective kind (ST, targeted AT and its trick, ALP, tarALP,
TRADES, AVmixup, tarAVmixup, and AT after the training-time square) on
carried weights at the flagship test's small size, with every draw made
with numpy and replayed on both sides (tests/torch_port_helpers.py); then
the three losses, the Gaussian and trick starts and L2 PGD against their
JAX functions.

The attacks are chaotic at float32 resolution, as in
tests/test_torch_train_step.py: the share of x_adv pixels off JAX's is
bounded, then the port goes on with JAX's x_adv and the loss, the top-1,
the parameters, the momentum and the BatchNorm running statistics are
compared. Each step is also held against the port's own step in float64
on the same draws, which is where the tight tolerances apply (see KINDS).
ALP and TRADES attack the eval-mode model, so their running statistics
come only from train-mode forwards on the same inputs on both sides (the
clean batch, and TRADES' adversarial batch). The helper also counts each
side's forwards (one square draw each): the port's are the K1 launches of
a step on the card."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.train import modelops as jmodelops
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.train import modelops as tmodelops

EPS = helpers.EPS
# kind -> (method_name, arch, MethodConfig fields beside the flagship's,
# tolerances against JAX that replace helpers.JAX_TOL). The fields are the
# shipped configs' (the trick configs' label_smooth and
# prob_start_from_clean, TRADES' beta 6). The replaced tolerances are for
# JAX's side: its float32 BatchNorm parameter gradients on these batches
# are off float64 (JAX's own float64 step, and the port's) by up to 0.3%
# of the largest conv1 gradient, where the port's float32 gradients are
# within 1e-5 of float64 (`F64_TOL` below holds every kind to that). The
# values measured against JAX stand beside each (params and momentum as
# |a - b| / (1 + |b|)).
KINDS = {
    "st": ("ST", "resnet18_EE_square", {},
           dict(params=5e-3, momentum=5e-2)),            # 2.7e-3, 2.3e-2
    "tar_at": ("tarEE_BPDA3_AT_square", "resnet18_EE_square", {},
               dict(params=1e-2, momentum=1e-1)),        # 4.9e-3, 4.6e-2
    "tar_at_trick": ("tarEE_trick", "resnet18_EE_square",
                     dict(label_smooth=0.1, prob_start_from_clean=0.2),
                     dict(params=1e-2, momentum=1e-1)),  # 4.4e-3, 4.2e-2
    "alp": ("ALP", "resnet18_EE_square", dict(beta=1.0),
            dict(params=1e-2, momentum=1e-1)),           # 5.6e-3, 4.4e-2
    "tar_alp": ("tarALP", "resnet18_EE_square", dict(beta=1.0),
                dict(params=1e-2, momentum=1e-1)),       # 5.8e-3, 5.4e-2
    "trades": ("TRADES", "resnet18_EE_square", dict(beta=6.0),
               dict(params=1e-2, momentum=1e-1)),        # 5.6e-3, 5.4e-2
    "avmixup": ("AVmixup", "resnet18_EE_square", {}, {}),
    # share 5.8% of x_adv, params 8.2e-4, momentum 7.1e-3
    "tar_avmixup": ("tarAVmixup", "resnet18_EE_square", {},
                    dict(share=0.08, params=2e-3, momentum=2e-2)),
    # share 13.9% (the port's float32 x_adv equals its float64 one),
    # params 1.5e-2, running statistics 9.1e-3, momentum 0.11
    "pre_square": ("EE_BPDA3_AT_pre_square", "resnet18_EE",
                   dict(pre_square=True, square_epsilon=EPS, square_n_queries=1),
                   dict(share=0.2, params=3e-2, running=2e-2, momentum=0.2)),
}
# The port's float32 step against its float64 step on the same draws
# (measured: x_adv share <= 4.1e-5, params <= 1.6e-5, running statistics
# <= 1.2e-6, momentum <= 1.3e-4)
F64_TOL = dict(share=1e-3, params=1e-4, running=1e-5, momentum=1e-3)


@pytest.mark.parametrize("kind", list(KINDS))
def test_objective_step_matches_jax(monkeypatch, kind):
    method, arch, fields, tol = KINDS[kind]
    port, jax_side, port64 = helpers.train_step_pair(
        monkeypatch, method=method, arch=arch, float64=True, **fields)
    helpers.assert_matches_float64(port, port64, F64_TOL)
    helpers.assert_train_steps_agree(port, jax_side, tol)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _logits(seed=0, b=6, n=7, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, n))).astype(np.float32)


def _value_and_grads(fn_t, fn_j, *arrays):
    """Each side's value and gradients w.r.t. every argument."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    v_t = fn_t(*ts)
    g_t = torch.autograd.grad(v_t, ts)
    v_t = v_t.detach()
    v_j, g_j = jax.value_and_grad(fn_j, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return (float(v_t), [g.numpy() for g in g_t]), (float(v_j), [np.asarray(g) for g in g_j])


def test_soft_cross_entropy_sum_matches_jax():
    logits = _logits()
    soft = np.random.default_rng(1).random(logits.shape).astype(np.float32)
    (v, g), (vj, gj) = _value_and_grads(tmodelops.soft_cross_entropy_sum,
                                        jmodelops.soft_cross_entropy_sum, logits, soft)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    for a, b in zip(g, gj):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smooth_loss_matches_jax(smoothing):
    logits = _logits(2)
    y = np.array([0, 6, 3, 3, 1, 5])
    (v, (g,)), (vj, (gj,)) = _value_and_grads(
        lambda z: tmodelops.label_smooth_loss(z, torch.from_numpy(y), smoothing),
        lambda z: jmodelops.label_smooth_loss(z, jnp.asarray(y), smoothing), logits)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    np.testing.assert_allclose(g, gj, rtol=1e-5, atol=1e-7)
    if smoothing == 0.0:   # no smoothing: the cross-entropy
        ce = torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                               torch.from_numpy(y))
        np.testing.assert_allclose(v, float(ce), rtol=1e-6)


def test_kl_div_batchmean_matches_jax_at_zero_probabilities():
    """KL(p || q) with exact zeros in p: 0 log 0 := 0 decides the value and
    the gradients, d/dlog q = -p / B and d/dp = (log p + 1 - log q) / B
    where p > 0, -log q / B where p = 0 (the written-out formula; torch's
    F.kl_div would give 0 there). XLA's CPU compiler flushes the denormal
    floor 1e-38 of JAX's log(max(p, 1e-38)) to zero, so JAX's gradient
    w.r.t. p is not finite where p = 0; elsewhere the two agree."""
    log_q = np.asarray(jax.nn.log_softmax(jnp.asarray(_logits(3)), axis=-1))
    p = np.asarray(jax.nn.softmax(jnp.asarray(_logits(4)), axis=-1)).copy()
    p[0, :3] = 0.0
    p[2, 5] = 0.0
    p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    (v, (g_q, g_p)), (vj, (gj_q, gj_p)) = _value_and_grads(
        tmodelops.kl_div_batchmean, jmodelops.kl_div_batchmean, log_q, p)
    np.testing.assert_allclose(v, vj, rtol=1e-6)
    np.testing.assert_allclose(g_q, gj_q, rtol=1e-6, atol=1e-8)
    pos = p > 0
    np.testing.assert_allclose(g_p[pos], gj_p[pos], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g_p[~pos], -log_q[~pos] / p.shape[0], rtol=1e-6)
    # KL(p || p) = 0
    lp = torch.log(torch.from_numpy(p).clamp_min(1e-38))
    assert abs(float(tmodelops.kl_div_batchmean(lp, torch.from_numpy(p)))) < 1e-7


# ---------------------------------------------------------------------------
# the PGD starts and L2 PGD
# ---------------------------------------------------------------------------

START_SHAPE = (4, 8, 8, 3)


def _start_case(monkeypatch, init, prob):
    """JAX's `_init_perturbation` on a real key, and the port's
    `init_start` given the draws JAX made from that key."""
    x = np.random.default_rng(5).random(START_SHAPE).astype(np.float32)
    x[0, :2] = 1.0                          # saturated pixels: the clips act
    key = jax.random.PRNGKey(9)
    cfg_j = jpgd.PGDConfig(EPS, 1, 0.01, random_init=init, prob_start_from_clean=prob)
    want = np.asarray(jpgd._init_perturbation(cfg_j, key, jnp.asarray(x)))
    if init == "gaussian":
        normal = np.array(jax.random.normal(key, START_SHAPE))
        monkeypatch.setattr(tpgd, "gaussian_init_noise",
                            lambda xx, gen: torch.from_numpy(normal))
    else:
        key_u, key_b = jax.random.split(key)
        noise = np.array(jax.random.uniform(key_u, START_SHAPE, minval=-EPS, maxval=EPS))
        u = np.array(jax.random.uniform(key_b, ()))
        monkeypatch.setattr(tpgd, "uniform_init_noise",
                            lambda xx, eps, gen: torch.from_numpy(noise))
        monkeypatch.setattr(tpgd, "trick_gate", lambda xx, gen: torch.from_numpy(u))
    cfg = tpgd.PGDConfig(EPS, 1, 0.01, random_init=init, prob_start_from_clean=prob)
    return x, tpgd.init_start(torch.from_numpy(x), cfg).numpy(), want


@pytest.mark.parametrize("init,prob", [("gaussian", 0.0), ("trick", 0.0),
                                       ("trick", 1.0)])
def test_pgd_start_matches_jax(monkeypatch, init, prob):
    x, got, want = _start_case(monkeypatch, init, prob)
    np.testing.assert_array_equal(got, want)
    if init == "gaussian":               # not clipped: leaves [0, 1]
        assert got.max() > 1.0 and 0 < np.abs(got - x).max() < 0.01
    elif prob == 1.0:                    # U() > 1 never: the clean start
        np.testing.assert_array_equal(got, x)
    else:
        assert np.abs(got - x).max() > 0.5 * EPS


def test_pgd_start_draws():
    """The port's own draws: N(0, 1) noise, and one gate for the batch
    (all of it noisy or all of it clean)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.full((64, 8, 8, 3), 0.5)
    g = tpgd.gaussian_init_noise(x, gen)
    assert g.shape == x.shape and abs(float(g.mean())) < 0.02
    assert abs(float(g.std()) - 1.0) < 0.02
    cfg = tpgd.PGDConfig(EPS, 1, 0.01, random_init="trick", prob_start_from_clean=0.5)
    clean = [bool((tpgd.init_start(x, cfg, gen) == x).all()) for _ in range(40)]
    assert 5 < sum(clean) < 35
    moved = tpgd.init_start(x, cfg, gen)
    while bool((moved == x).all()):
        moved = tpgd.init_start(x, cfg, gen)
    assert bool(((moved - x).abs() > 0).float().mean() > 0.99)


@pytest.mark.parametrize("init", ["none", "gaussian"])
def test_pgd_l2_matches_jax(monkeypatch, init):
    """L2 PGD on a linear logits closure: steps along g over its per-sample
    root-mean-square, the ball's projection, the clip; the Gaussian start
    from JAX's draw. Steps large enough that the projection acts."""
    rng = np.random.default_rng(11)
    wmat = rng.normal(0, 1, (48, 10)).astype(np.float32)
    x = rng.random((6, 4, 4, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    eps, step, n = 0.05, 0.03, 4
    key = jax.random.PRNGKey(2)

    def loss_j(xx, aux, k):
        logp = jax.nn.log_softmax(xx.reshape(6, -1) @ jnp.asarray(wmat), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1).sum(), aux

    want, _ = jpgd.pgd_l2(loss_j, jnp.asarray(x), key,
                          jpgd.PGDConfig(eps, n, step, random_init=init))
    normal = np.array(jax.random.normal(jax.random.split(key)[0], x.shape))
    monkeypatch.setattr(tpgd, "gaussian_init_noise",
                        lambda xx, gen: torch.from_numpy(normal))
    wt, yt = torch.from_numpy(wmat), torch.from_numpy(y).long()
    got = tpgd.pgd_l2(
        lambda xx: torch.nn.functional.cross_entropy(xx.reshape(6, -1) @ wt, yt,
                                                     reduction="sum"),
        torch.from_numpy(x), tpgd.PGDConfig(eps, n, step, random_init=init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    d = (got.numpy() - x).reshape(6, -1)
    rms = np.sqrt((d ** 2).mean(axis=1))
    assert rms.max() <= eps * (1 + 1e-5) and rms.max() > 0.9 * eps
