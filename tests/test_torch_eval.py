"""The port's eval battery against the JAX package's: `fgsm`,
`random_targets` and `cw_linf` on a fixed linear logits closure, then
`build_eval_step` branch for branch (PGD, targeted PGD, PGD with restarts,
FGSM, CW, targeted CW, pre_square, none) on resnet18_EE_square at 64 px,
batch 4, with the weights carried across and JAX's draws replayed on the
port: the square draws (one per traced forward), the PGD and CW starts and
the target offsets, all made with numpy.

The labels are the model's own clean predictions, so every sample starts
correct: CW attacks all of them and the adversarial accuracy can move.
Each side's x_adv is captured per attack call; the port then goes on with
JAX's x_adv (as tests/test_torch_train_step.py does for the update), so the
restart selection and the adversarial metrics are compared on the same
input. Eval mode moves no BatchNorm statistic, so the two attacks differ
only where a float32 input gradient of the two libraries changes sign."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.attacks import cw as jcw
from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.attacks import cw as tcw
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.ops.square import add_square
from edge_enhancement_tpu_torch.train import trainer as ttrainer
from edge_enhancement_tpu_torch.train.modelops import ModelOps

# ---------------------------------------------------------------------------
# the attack functions on a linear logits closure
# ---------------------------------------------------------------------------

LIN_SHAPE, LIN_CLASSES = (6, 4, 4, 3), 10


def _linear():
    rng = np.random.default_rng(11)
    w = rng.normal(0, 1, (48, LIN_CLASSES)).astype(np.float32)
    x = rng.random(LIN_SHAPE).astype(np.float32)
    wt = torch.from_numpy(w)

    def fwd_t(xx):
        return xx.reshape(xx.shape[0], -1) @ wt

    def fwd_j(xx, _key=None):
        return xx.reshape(xx.shape[0], -1) @ jnp.asarray(w)

    logits = x.reshape(6, -1) @ w
    # four samples correct, two wrong: CW attacks only the first four
    y = logits.argmax(1).astype(np.int32)
    y[4:] = (y[4:] + 3) % LIN_CLASSES
    return x, y, fwd_t, fwd_j


def _ce_sum_t(fwd, y):
    return lambda xx: torch.nn.functional.cross_entropy(fwd(xx), y.long(),
                                                        reduction="sum")


def _ce_sum_j(fwd, y):
    def loss(xx, aux, key):
        logp = jax.nn.log_softmax(fwd(xx), axis=-1)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).sum(), aux
    return loss


@pytest.mark.parametrize("targeted", [False, True])
def test_fgsm_matches_jax(targeted):
    x, y, fwd_t, fwd_j = _linear()
    want, _ = jpgd.fgsm(_ce_sum_j(fwd_j, jnp.asarray(y)), jnp.asarray(x),
                        jax.random.PRNGKey(0), step_size=0.03, targeted=targeted)
    got = tpgd.fgsm(_ce_sum_t(fwd_t, torch.from_numpy(y)), torch.from_numpy(x),
                    step_size=0.03, targeted=targeted)
    # one sign step of the same gradient (no gradient entry is near zero
    # here), then the same add and clamp: equal up to the float32 add
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0)
    assert float((got - torch.from_numpy(x)).abs().max()) > 0.029


def test_random_targets_matches_jax():
    y = np.arange(8, dtype=np.int32) % 5
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpgd.random_targets(key, jnp.asarray(y), 5))
    offset = np.asarray(jax.random.randint(key, y.shape, 1, 5))
    got = tpgd.random_targets(torch.from_numpy(y), 5, offset=torch.from_numpy(offset))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draw: a wrong label in range, every offset reachable
    gen = torch.Generator().manual_seed(0)
    yy = torch.zeros(4000, dtype=torch.long)
    t = tpgd.random_targets(yy, 5, gen)
    assert t.dtype == torch.long and not bool((t == yy).any())
    assert sorted(set(t.tolist())) == [1, 2, 3, 4]


@pytest.mark.parametrize("mode", ["untargeted", "targeted", "previous_p"])
def test_cw_linf_matches_jax(monkeypatch, mode):
    x, y, fwd_t, fwd_j = _linear()
    cfg = dict(magnitude=0.05, max_eps=0.08, max_iters=3, num_classes=LIN_CLASSES)
    start = np.random.default_rng(5).uniform(-0.05, 0.05, LIN_SHAPE).astype(np.float32)
    target = ((y + 1) % LIN_CLASSES).astype(np.int32) if mode == "targeted" else None
    prev = (np.random.default_rng(6).uniform(-0.02, 0.02, LIN_SHAPE).astype(np.float32)
            if mode == "previous_p" else None)

    real_uniform = jax.random.uniform

    def uniform(key, shape, *a, minval=0.0, maxval=1.0, **k):
        assert tuple(shape) == LIN_SHAPE and minval == -0.05 and maxval == 0.05
        return jnp.asarray(start)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    adv_j, p_j = jcw.cw_linf(fwd_j, jnp.asarray(x), jnp.asarray(y),
                             jax.random.PRNGKey(0), jcw.CWConfig(**cfg),
                             previous_p=None if prev is None else jnp.asarray(prev),
                             target=None if target is None else jnp.asarray(target))
    monkeypatch.setattr(jax.random, "uniform", real_uniform)

    monkeypatch.setattr(tcw, "uniform_start",
                        lambda xx, m, gen: torch.from_numpy(start))
    adv_t, p_t = tcw.cw_linf(fwd_t, torch.from_numpy(x), torch.from_numpy(y),
                             tcw.CWConfig(**cfg),
                             previous_p=None if prev is None else torch.from_numpy(prev),
                             target=None if target is None else torch.from_numpy(target))
    # three sign steps of the same margin gradient and the same clamps
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), atol=1e-7, rtol=0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-7, rtol=0)
    # the two misclassified samples are left as they were
    np.testing.assert_array_equal(adv_t[4:].numpy(), x[4:])
    assert float((adv_t[:4] - torch.from_numpy(x[:4])).abs().max()) > 0.01


# ---------------------------------------------------------------------------
# build_eval_step, branch for branch
# ---------------------------------------------------------------------------

SHAPE = (4, 64, 64, 3)
CW_ITERS = 2
# name -> EvalAttackConfig fields (besides epsilon, step size, classes)
BRANCHES = {
    "pgd": dict(attack_method="PGD", num_steps=2),
    "pgd_targeted": dict(attack_method="PGD", num_steps=2, targeted=True),
    "pgd_restarts": dict(attack_method="PGD", num_steps=1, restarts=2),
    "fgsm": dict(attack_method="FGSM", num_steps=1),
    "cw": dict(attack_method="CW", num_steps=CW_ITERS, cw_iters=CW_ITERS),
    "cw_targeted": dict(attack_method="CW", num_steps=CW_ITERS, cw_iters=CW_ITERS,
                        targeted=True),
    "pre_square": dict(attack_method="PGD", num_steps=1, pre_square=True),
    "none": dict(attack_method="none"),
}
# Share of x_adv pixels that may differ between the two sides' attacks
# (|diff| > 1e-6): no looser than the train step's 5%; eval mode keeps the
# BatchNorm statistics fixed, so only sign flips of near-zero gradients and
# their knock-on at the next step remain (measured: 0.38% for PGD-2, 0.35%
# targeted, 0.05% for a PGD-1 run, 0 for FGSM, CW and pre_square).
XADV_SHARE = 0.01


@pytest.fixture(scope="module")
def models():
    return helpers.jax_and_port_models(SHAPE)


def _forwards(fields) -> list:
    """The square draw of each of the port's forwards, as indices into the
    JAX trace's calls (the pre-square draw first when there is one). JAX
    traces the CW loop's body once, so its one draw serves every
    iteration."""
    method = fields["attack_method"]
    pre = [0] if fields.get("pre_square") else []
    k = len(pre)
    if method == "none":
        return pre + [k]
    if method == "CW":
        return pre + [k, k + 1] + [k + 2] * CW_ITERS + [k + 3]
    if method == "FGSM":
        return pre + [k, k + 1, k + 2]
    n, r = fields["num_steps"], fields.get("restarts", 1)
    # clean, the first run, each restart's run and prediction, adv
    return pre + list(range(k, k + 2 + r * n + r - 1))


def _jax_spy(fn, captured):
    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        i = len(captured)
        captured.append(None)
        jax.debug.callback(lambda a: captured.__setitem__(i, np.asarray(a)), out[0])
        return out
    return spy


def _port_spy(fn, captured, replacement, pair: bool):
    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        i = len(captured)
        captured.append((out[0] if pair else out).numpy())
        x_j = torch.from_numpy(replacement[i].copy())
        return (x_j, out[1]) if pair else x_j
    return spy


def _replay(draws, order):
    return helpers.TorchSquareReplay([draws[i] for i in order])


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_eval_step_matches_jax(monkeypatch, models, branch):
    fields = BRANCHES[branch]
    ops_j, params, bs, model = models
    order = _forwards(fields)
    rng = np.random.default_rng(1)
    x = rng.random(SHAPE).astype(np.float32)
    draws = helpers.square_draws(max(order) + 1, SHAPE, seed=3)
    starts = [rng.uniform(-helpers.EPS, helpers.EPS, SHAPE).astype(np.float32)
              for _ in range(2)]
    offset = rng.integers(1, 200, SHAPE[0]).astype(np.int32)

    # the labels: the port's clean predictions on the same draws
    model.eval()
    with torch.no_grad():
        xc = torch.from_numpy(x)
        if fields.get("pre_square"):
            xc = add_square(xc, tuple(torch.from_numpy(a) for a in draws[0]),
                            epsilon=helpers.EPS)
        model.square_source = _replay(draws, [1 if fields.get("pre_square") else 0])
        y = model(xc).argmax(-1).numpy().astype(np.int32)
    atk = dict(epsilon=helpers.EPS, step_size=helpers.STEP_SIZE, num_classes=200,
               square_epsilon=helpers.EPS, **fields)

    # ---- JAX: every draw replayed at trace time ------------------------------
    replay_j = helpers.JaxSquareReplay(draws)
    monkeypatch.setattr(jee, "add_square", replay_j)
    monkeypatch.setattr(jtrainer, "add_square", replay_j)
    jstarts = list(starts)
    monkeypatch.setattr(jpgd, "_init_perturbation",
                        lambda cfg, key, xx: jnp.clip(xx + jstarts.pop(0), 0.0, 1.0))
    monkeypatch.setattr(jtrainer, "random_targets",
                        lambda key, labels, n: jnp.mod(labels + offset, n))
    real_uniform = jax.random.uniform

    def uniform(key, shape, *a, minval=0.0, maxval=1.0, **k):
        assert tuple(shape) == SHAPE and minval == -helpers.EPS
        return jnp.asarray(starts[0])
    monkeypatch.setattr(jax.random, "uniform", uniform)
    cap_j = []
    for name in ("pgd_linf", "fgsm", "cw_linf"):
        monkeypatch.setattr(jtrainer, name, _jax_spy(getattr(jtrainer, name), cap_j))
    state_j = jtrainer.TrainState(params=params, batch_stats=bs,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    step_j = jtrainer.build_eval_step(ops_j, jtrainer.EvalAttackConfig(**atk))
    m_j = jax.device_get(step_j(state_j, jnp.asarray(x), jnp.asarray(y),
                                jax.random.PRNGKey(0)))
    monkeypatch.setattr(jax.random, "uniform", real_uniform)
    assert replay_j.calls == max(order) + 1

    # ---- the port, on the same draws ----------------------------------------
    replay_t = _replay(draws, order)
    model.square_source = replay_t
    tstarts = list(starts)
    monkeypatch.setattr(tpgd, "uniform_init_noise",
                        lambda xx, eps, gen: torch.from_numpy(tstarts.pop(0)))
    monkeypatch.setattr(tcw, "uniform_start",
                        lambda xx, m, gen: torch.from_numpy(starts[0]))
    real_targets = ttrainer.random_targets
    monkeypatch.setattr(ttrainer, "random_targets", lambda labels, n, gen: real_targets(
        labels, n, offset=torch.from_numpy(offset)))
    cap_t = []
    for name, pair in (("pgd_linf", False), ("fgsm", False), ("cw_linf", True)):
        monkeypatch.setattr(ttrainer, name,
                            _port_spy(getattr(ttrainer, name), cap_t, cap_j, pair))
    step = ttrainer.build_eval_step(ModelOps(model), ttrainer.EvalAttackConfig(**atk),
                                    square_source=replay_t)
    m = step(ttrainer.create_train_state(model), torch.from_numpy(x),
             torch.from_numpy(y).long())
    assert replay_t.calls == len(order)

    # clean metrics: the same input and draws through two float32 stacks
    assert sorted(m) == sorted(m_j)
    assert float(m["clean_top1"]) == float(m_j["clean_top1"]) == 100.0
    assert float(m["clean_top5"]) == float(m_j["clean_top5"])
    np.testing.assert_allclose(float(m["clean_loss"]), float(m_j["clean_loss"]),
                               rtol=1e-5, atol=1e-6)
    if fields["attack_method"] == "none":
        assert not cap_t and not cap_j
        return
    assert len(cap_t) == len(cap_j) == fields.get("restarts", 1)
    for got, want in zip(cap_t, cap_j):
        differ = np.abs(got - want) > 1e-6
        assert differ.mean() <= XADV_SHARE, differ.mean()
        assert np.abs(got - x).max() > 0.5 * helpers.STEP_SIZE
    # adversarial metrics on JAX's x_adv (restarts selected on the port)
    assert float(m["adv_top1"]) == float(m_j["adv_top1"])
    assert float(m["adv_top5"]) == float(m_j["adv_top5"])
    np.testing.assert_allclose(float(m["adv_loss"]), float(m_j["adv_loss"]),
                               rtol=1e-5, atol=1e-6)


def test_eval_protocol_is_jax_s():
    for cfg in (dict(method_name="tarEE_BPDA3_AT_square", epsilon=0.03, n_queries=1),
                dict(method_name="EE_BPDA3_AT_pre_square", restarts=3,
                     attack_unroll=1),
                dict(method_name="fast_AT")):
        assert ttrainer.eval_protocol(cfg) == jtrainer.eval_protocol(cfg)
    names = [f.name for f in dataclasses.fields(ttrainer.EvalAttackConfig)]
    assert names == [f.name for f in dataclasses.fields(jtrainer.EvalAttackConfig)]
