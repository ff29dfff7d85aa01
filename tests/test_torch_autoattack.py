"""The port's AutoAttack (edge_enhancement_tpu_torch/attacks/autoattack.py)
against the JAX package's and against the official package's arithmetic:

(a) the numpy mirrors of the official attacks in
    tests/test_autoattack_fidelity.py (APGD's step-halving trajectory, the
    targeted-DLR and small-num_steps cases, the FAB projection's exact
    oracle, FAB-T's and Square's full trajectories), imported from there;
(b) JAX's own functions, unpatched, on linear logits closures: JAX's draws
    are recomputed from its key outside the trace, with the same
    jax.random.split sequence, and fed to the port's draw functions;
(c) the static schedules, for every N and Q up to 1000;
(d) the suite on resnet18_EE at a small size, the weights carried across;
(e) the draw sharing on resnet18_EE_square (which forwards share the
    square front-end's draw, as JAX shares keys);
(f) the port's eval.py with --suite aa on the CPU.

Tolerances are stated where they are used."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.attacks import autoattack as jaa
from edge_enhancement_tpu_torch.attacks import autoattack as taa
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from test_autoattack_fidelity import (_exact_min_radius, _mirror_official_apgd,
                                      _mirror_official_fab_t,
                                      _mirror_official_square)

t_ = torch.from_numpy


# ---------------------------------------------------------------------------
# JAX's draws, recomputed from its keys as the JAX functions split them
# ---------------------------------------------------------------------------

def jax_apgd_start(key, shape):
    """apgd's U[-1, 1) start: the second of split(key, 4)."""
    _, k0, _, _ = jax.random.split(key, 4)
    return np.asarray(jax.random.uniform(k0, shape, minval=-1.0, maxval=1.0))


def jax_square_draws(key, shape, n_queries, p_init=0.8):
    """square_attack's stripes and, per loop query, (vh, vw, signs)."""
    b, h, w, c = shape
    key, k0, _ = jax.random.split(key, 3)
    stripes = np.sign(np.asarray(jax.random.uniform(k0, (b, 1, w, c))) * 2 - 1)
    sizes = taa.square_sizes(n_queries, p_init, h, w, c)
    queries = []
    if sizes:
        keys = jax.random.split(key, 4 * len(sizes)).reshape(len(sizes), 4, -1)
        for it, s in enumerate(sizes):
            queries.append((int(jax.random.randint(keys[it, 0], (), 0, h - s)),
                            int(jax.random.randint(keys[it, 1], (), 0, w - s)),
                            np.sign(np.asarray(jax.random.uniform(
                                keys[it, 2], (1, 1, 1, c))) * 2 - 1)))
    return stripes, queries


def jax_suite_draws(key, shape, attacks, n_tc, n_queries):
    """The suite's attack draws in the order the port makes them: the APGD
    starts (APGD-CE, APGD-DLR, then each APGD-T target) and Square's."""
    key, _ = jax.random.split(key)
    starts, square = [], None
    for name in ("apgd-ce", "apgd-dlr"):
        if name in attacks:
            key, k1, _ = jax.random.split(key, 3)
            starts.append(jax_apgd_start(k1, shape))
    if "apgd-t" in attacks or "fab-t" in attacks:
        key, _ = jax.random.split(key)
    for name in ("apgd-t", "fab-t"):
        if name in attacks:
            for _ in range(n_tc):
                key, k1, _ = jax.random.split(key, 3)
                if name == "apgd-t":
                    starts.append(jax_apgd_start(k1, shape))
    if "square" in attacks:
        key, k1, _ = jax.random.split(key, 3)
        square = jax_square_draws(k1, shape, n_queries)
    return starts, square


def replay_draws(monkeypatch, starts=(), square=None):
    """The port's attack draws replaced by recorded ones, consumed in order;
    returns the lists, so a test can check they were all used."""
    starts = [np.array(s) for s in starts]
    queries = list(square[1]) if square else []
    monkeypatch.setattr(taa, "apgd_start", lambda x, gen: t_(starts.pop(0)).to(x.device))
    if square:
        monkeypatch.setattr(taa, "square_stripes",
                            lambda shape, gen, dev: t_(np.array(square[0])).to(dev))

    def query(h, w, c, s, gen, dev):
        vh, vw, sgn = queries.pop(0)
        return (torch.tensor(vh, device=dev), torch.tensor(vw, device=dev),
                t_(np.array(sgn)).to(dev))
    monkeypatch.setattr(taa, "square_query_draws", query)
    return starts, queries


def linear(shape, nc, seed, correct=False):
    """(x, y, W, b, JAX forward(x, key), port forward(x, draws)) of a fixed
    linear model; with `correct`, y is the model's own prediction."""
    rng = np.random.default_rng(seed)
    d = int(np.prod(shape[1:]))
    w = rng.standard_normal((d, nc)).astype(np.float32)
    b = rng.standard_normal(nc).astype(np.float32)
    x = (rng.random(shape) * 0.6 + 0.2).astype(np.float32)
    y = (x.reshape(shape[0], -1) @ w + b).argmax(1).astype(np.int32) if correct \
        else rng.integers(0, nc, shape[0]).astype(np.int32)
    wt, bt = t_(w), t_(b)

    def fwd_j(xx, key):
        return xx.reshape(xx.shape[0], -1) @ jnp.asarray(w) + jnp.asarray(b)

    def fwd_t(xx, draws):
        return xx.reshape(xx.shape[0], -1) @ wt + bt
    return x, y, w, b, fwd_j, fwd_t


# ---------------------------------------------------------------------------
# (a) the official mirrors
# ---------------------------------------------------------------------------

# name -> (B, D, classes, eps, N, seed, loss); the fidelity tests' instances
APGD_MIRROR_CASES = {
    "ce": (6, 12, 5, 0.08, 30, 11, "ce"),
    "targeted_dlr": (6, 12, 6, 0.08, 25, 23, "targeted"),
    "small_niter_dlr": (8, 10, 5, 0.1, 8, 0, "dlr"),
}


@pytest.mark.parametrize("case", list(APGD_MIRROR_CASES))
def test_apgd_matches_official_mirror(monkeypatch, case):
    """The port's APGD against the numpy transcription of the official
    loop: the same halving decisions (step sizes exact), best loss and best
    point within the fidelity tests' 2e-5 (float32 sums in another order).
    The DLR mirrors take JAX's loss and gradient, as the fidelity tests do,
    which holds the port's DLR to JAX's too."""
    bsz, dim, nc, eps, n, seed, loss = APGD_MIRROR_CASES[case]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((dim, nc)).astype(np.float32)
    b = rng.standard_normal(nc).astype(np.float32)
    x = (rng.random((bsz, dim)) * 0.6 + 0.2).astype(np.float32)
    y = rng.integers(0, nc, bsz).astype(np.int32)
    yt = ((y + 1 + rng.integers(0, nc - 1, bsz)) % nc).astype(np.int32)
    start = np.random.default_rng(seed + 1).uniform(-1, 1, x.shape).astype(np.float32)
    yj, ytj = jnp.asarray(y), jnp.asarray(yt)
    loss_j = {"ce": None,
              "targeted": lambda lg: jaa._dlr_targeted(lg, yj, ytj),
              "dlr": lambda lg: jaa._dlr_untargeted(lg, yj)}[loss]
    mirror_kw = {}
    if loss_j is not None:
        grad_j = jax.jit(jax.grad(lambda z: jnp.sum(loss_j(z @ jnp.asarray(w) + jnp.asarray(b)))))
        mirror_kw = dict(per_loss=lambda z: np.asarray(loss_j(jnp.asarray(z @ w + b))),
                         grad=lambda z: np.asarray(grad_j(jnp.asarray(z))))
    xb_m, fb_m, alpha_m, halve_log = _mirror_official_apgd(
        w, b, x, y, eps, n, start, **mirror_kw)

    replay_draws(monkeypatch, [start])
    wt, bt = t_(w), t_(b)
    kw = {"targeted": dict(y_target=t_(yt)), "dlr": dict(loss="dlr")}.get(loss, {})
    _, info = taa.apgd(lambda xx, d: xx @ wt + bt, t_(x), t_(y),
                       taa.APGDConfig(eps, n, nc), return_info=True, **kw)
    np.testing.assert_array_equal(info["alpha"].numpy(), alpha_m)
    np.testing.assert_allclose(info["f_best"].numpy(), fb_m, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(info["x_best"].numpy(), xb_m, atol=2e-5)
    assert len(halve_log) == len(taa._apgd_checkpoints(n))
    assert any(h.any() for h in halve_log)


def test_proj_linf_box_matches_exact_oracle():
    """The bisection reaches the exact minimal radius within 2^-iters plus
    float32 slack (1e-5), lands on the plane (residual 1e-4 of |c|), stays
    in the box, and falls back to the box-extremal point when the plane
    misses the box: the fidelity test's instance and limits."""
    rng = np.random.default_rng(0)
    bsz, dim, iters = 64, 24, 50
    p = rng.random((bsz, dim)).astype(np.float32)
    w = rng.standard_normal((bsz, dim)).astype(np.float32)
    c = (np.sum(w * p, axis=1)
         + rng.standard_normal(bsz) * np.linalg.norm(w, axis=1) * 0.3)
    c[:8] = np.sum(w[:8] * p[:8], axis=1)
    c[8:12] -= 100.0
    c = c.astype(np.float32)
    z = taa._proj_linf_box(t_(p), t_(w), t_(c), iters).numpy()
    tol = 2.0 ** -iters + 1e-5
    n_feasible = 0
    for i in range(bsz):
        r_exact, feasible = _exact_min_radius(p[i], w[i], c[i])
        assert (z[i] >= -1e-9).all() and (z[i] <= 1 + 1e-9).all(), i
        if feasible:
            n_feasible += 1
            assert np.max(np.abs(z[i] - p[i])) <= r_exact + tol, i
            assert abs(float(w[i] @ z[i] - c[i])) <= 1e-4 * max(1.0, abs(c[i])), i
        else:
            s = 1.0 if float(w[i] @ p[i] - c[i]) >= 0 else -1.0
            best = float(np.sum(np.where(s * w[i] > 0, 0.0, s * w[i])))
            assert abs(float(s * w[i] @ z[i]) - best) <= 1e-6, i
    assert 4 <= n_feasible < bsz
    # on the plane already: zero radius
    on = taa._proj_linf_box(t_(p[:4]), t_(w[:4]), t_(np.sum(w[:4] * p[:4], axis=1)), 50)
    np.testing.assert_allclose(on.numpy(), p[:4], atol=1e-6)


def test_fab_targeted_matches_official_mirror():
    """The fidelity test's instance: the float64 official trajectory with
    the exact projection, against the port's float32 bisection, within its
    2e-4; the ball and box invariants on the result."""
    shape, nc, eps, n = (8, 3, 2, 2), 5, 0.25, 12
    x, y, w, b, _, fwd_t = linear(shape, nc, seed=2, correct=True)
    rng = np.random.default_rng(3)
    yt = ((y + 1 + rng.integers(0, nc - 1, shape[0])) % nc).astype(np.int32)
    out = taa.fab_targeted(fwd_t, t_(x), t_(y), t_(yt),
                           taa.FABConfig(eps, n, proj_iters=50)).numpy().reshape(8, -1)
    want, res = _mirror_official_fab_t(w.astype(np.float64), b.astype(np.float64),
                                       x.reshape(8, -1), y, yt, eps, n)
    assert np.isfinite(res).any()
    np.testing.assert_allclose(out, want, atol=2e-4)
    ok = np.isfinite(res) & (res <= eps)
    d = np.abs(out - x.reshape(8, -1)).max(axis=1)
    assert (d[~ok] == 0).all() and (d[ok] <= eps + 1e-5).all() and ok.any()


def test_square_matches_official_mirror(monkeypatch):
    """The official square.py transcription on JAX's draws, which the port
    consumes too: equal within 1e-6 (one float32 add and two clips)."""
    shape, nc, eps, nq = (6, 8, 8, 4), 5, 0.15, 40
    x, y, w, b, _, fwd_t = linear(shape, nc, seed=4, correct=True)
    key = jax.random.PRNGKey(3)
    want, loss_best = _mirror_official_square(w, b, x, y, eps, nq, 0.8, key)
    _, queries = replay_draws(monkeypatch, square=jax_square_draws(key, shape, nq))
    out = taa.square_attack(fwd_t, t_(x), t_(y), taa.SquareConfig(eps, nq, num_classes=nc))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)
    assert not queries and (np.abs(want - x) > 0).any()


# ---------------------------------------------------------------------------
# (b) JAX's own functions on linear closures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["ce", "dlr", "targeted"])
def test_apgd_matches_jax(monkeypatch, loss):
    """JAX's apgd (unpatched) and the port's on JAX's start: step sizes
    exact; x_adv, the max-loss point and its loss within 2e-5 (float32
    sums of two libraries: the sign steps agree, the losses differ in the
    last bits)."""
    shape, nc, eps, n = (6, 3, 2, 2), 6, 0.08, 30
    x, y, _, _, fwd_j, fwd_t = linear(shape, nc, seed=11)
    yt = ((y + 2) % nc).astype(np.int32)
    key = jax.random.PRNGKey(42)
    kw_j = {"targeted": dict(y_target=jnp.asarray(yt)), "dlr": dict(loss="dlr")}.get(loss, {})
    out_j, info_j = jaa.apgd(fwd_j, jnp.asarray(x), jnp.asarray(y), key,
                             jaa.APGDConfig(eps, n, nc), return_info=True, **kw_j)
    starts, _ = replay_draws(monkeypatch, [jax_apgd_start(key, shape)])
    kw_t = {"targeted": dict(y_target=t_(yt)), "dlr": dict(loss="dlr")}.get(loss, {})
    out_t, info_t = taa.apgd(fwd_t, t_(x), t_(y), taa.APGDConfig(eps, n, nc),
                             return_info=True, **kw_t)
    assert not starts
    np.testing.assert_array_equal(info_t["alpha"].numpy(), np.asarray(info_j["alpha"]))
    np.testing.assert_array_equal(info_t["found"].numpy(), np.asarray(info_j["found"]))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(info_t["x_best"].numpy(), np.asarray(info_j["x_best"]),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(info_t["f_best"].numpy(), np.asarray(info_j["f_best"]),
                               rtol=2e-5, atol=1e-6)
    assert np.abs(out_t.numpy() - x).max() > 0.5 * eps


def test_fab_targeted_matches_jax():
    """JAX's fab_targeted and the port's (both 40-pass bisections in
    float32): within 1e-5 (the planes' sums in another order move the
    bisection's radius by a few float32 ulps)."""
    shape, nc, eps = (8, 3, 2, 2), 5, 0.25
    x, y, _, _, fwd_j, fwd_t = linear(shape, nc, seed=2, correct=True)
    yt = ((y + 1) % nc).astype(np.int32)
    want = jaa.fab_targeted(fwd_j, jnp.asarray(x), jnp.asarray(y), jnp.asarray(yt),
                            jax.random.PRNGKey(0), jaa.FABConfig(eps, 10))
    got = taa.fab_targeted(fwd_t, t_(x), t_(y), t_(yt), taa.FABConfig(eps, 10))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert np.abs(got.numpy() - x).max() > 0.01


@pytest.mark.parametrize("n_queries", [1, 2, 60])
def test_square_attack_matches_jax(monkeypatch, n_queries):
    """JAX's square_attack and the port's on JAX's draws: equal within 1e-6
    (the same float32 adds and clips); one query runs only the init."""
    shape, nc, eps = (6, 8, 8, 4), 5, 0.15
    x, y, _, _, fwd_j, fwd_t = linear(shape, nc, seed=4, correct=True)
    key = jax.random.PRNGKey(9)
    cfg = dict(epsilon=eps, n_queries=n_queries, num_classes=nc)
    want = jaa.square_attack(fwd_j, jnp.asarray(x), jnp.asarray(y), key,
                             jaa.SquareConfig(**cfg))
    draws = jax_square_draws(key, shape, n_queries)
    _, queries = replay_draws(monkeypatch, square=draws)
    got = taa.square_attack(fwd_t, t_(x), t_(y), taa.SquareConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert not queries and len(draws[1]) == n_queries - 1


SUITE_ATTACKS = {"standard": jaa.STANDARD_ATTACKS,
                 "individual": ("square", "apgd-dlr", "nonsense", "apgd-ce")}


@pytest.mark.parametrize("attacks", list(SUITE_ATTACKS))
def test_suite_matches_jax(monkeypatch, attacks):
    """JAX's build_autoattack and the port's on a linear closure with JAX's
    draws: x_adv within 2e-5 (APGD's tolerance above), the same samples
    broken, and the run order and merge rule (unknown names ignored)."""
    shape, nc, eps = (8, 3, 4, 4), 10, 0.05
    x, y, _, _, fwd_j, fwd_t = linear(shape, nc, seed=5, correct=True)
    kw = dict(epsilon=eps, num_classes=nc, apgd_steps=6, fab_steps=4,
              square_queries=12, n_target_classes=3,
              attacks_to_run=SUITE_ATTACKS[attacks])
    key = jax.random.PRNGKey(15)
    want = np.asarray(jaa.build_autoattack(fwd_j, **kw)(jnp.asarray(x), jnp.asarray(y), key))
    starts, queries = replay_draws(monkeypatch, *jax_suite_draws(
        key, shape, kw["attacks_to_run"], kw["n_target_classes"], kw["square_queries"]))
    got = taa.build_autoattack(fwd_t, **kw)(t_(x), t_(y)).numpy()
    assert not starts and not queries
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    logits = lambda a: fwd_t(t_(np.array(a)), None).numpy()
    np.testing.assert_array_equal(logits(got).argmax(1) != y, logits(want).argmax(1) != y)
    assert 0 < (logits(got).argmax(1) != y).sum()
    assert np.abs(got - x).max() <= eps + 1e-6


# ---------------------------------------------------------------------------
# (c) the static schedules
# ---------------------------------------------------------------------------

def test_schedules_match_jax_up_to_1000():
    """_apgd_checkpoints for every N <= 1000, _square_p for every query of
    every Q <= 1000 (and the size table at 64 px, 3 channels, against the
    JAX body's own expression)."""
    for n in range(1, 1001):
        assert taa._apgd_checkpoints(n) == jaa._apgd_checkpoints(n), n
    for q in range(1, 1001):
        for it in range(q):
            assert taa._square_p(it, q, 0.8) == jaa._square_p(it, q, 0.8), (q, it)
    h = w = 64
    c = 3
    for q in (1, 2, 100, 1000, 5000):
        want = [min(max(int(round(math.sqrt(jaa._square_p(it, q, 0.8) * (c * h * w) / c))),
                        1), h - 1, w - 1) for it in range(max(q - 1, 0))]
        assert taa.square_sizes(q, 0.8, h, w, c) == want


# ---------------------------------------------------------------------------
# (d) the suite on resnet18_EE, the weights carried across
# ---------------------------------------------------------------------------

MODEL_SHAPE = (4, 32, 32, 3)
# eps 6/255: on these weights APGD-CE breaks two of the four samples and
# APGD-T the other two, so the merge takes candidates of both
MODEL_SUITE = dict(epsilon=6 / 255, num_classes=200, apgd_steps=3,
                   fab_steps=2, square_queries=3, n_target_classes=1)
# Share of x_adv pixels that may differ by more than 1e-6 between the two
# suites: the eval battery's limit (tests/test_torch_eval.py XADV_SHARE),
# where only sign flips of near-zero input gradients remain
XADV_SHARE = 0.01


@pytest.fixture(scope="module")
def model_suite():
    """Both suites once on resnet18_EE (no square, so the forwards draw
    nothing): x, y (the model's own predictions), JAX's x_adv and the
    attack draws, and the port's model."""
    ops_j, params, bs, model = helpers.jax_and_port_models(MODEL_SHAPE, arch="resnet18_EE")
    x = np.random.default_rng(3).random(MODEL_SHAPE).astype(np.float32)

    def fwd_j(xx, key):
        return ops_j.logits_eval(params, bs, xx, key)
    k0 = jax.random.PRNGKey(0)
    y = np.asarray(jnp.argmax(jax.jit(fwd_j)(jnp.asarray(x), k0), -1)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    x_adv_j = np.asarray(jaa.build_autoattack(fwd_j, **MODEL_SUITE)(
        jnp.asarray(x), jnp.asarray(y), key))
    acc_j = float(jnp.mean(jnp.argmax(jax.jit(fwd_j)(jnp.asarray(x_adv_j), k0), -1) == y))
    draws = jax_suite_draws(key, MODEL_SHAPE, jaa.STANDARD_ATTACKS, 1, 3)
    return x, y, x_adv_j, acc_j, draws, model


def test_model_suite_matches_jax(monkeypatch, model_suite):
    x, y, x_adv_j, acc_j, draws, model = model_suite
    ops = ModelOps(model)
    with torch.no_grad():
        assert (ops.logits_eval(t_(x)).argmax(-1).numpy() == y).all()
    starts, queries = replay_draws(monkeypatch, *draws)
    suite = taa.build_autoattack(ops.logits_eval, draw=ops.square_draws, **MODEL_SUITE)
    x_adv = suite(t_(x), t_(y).long()).numpy()
    assert not starts and not queries
    differ = np.abs(x_adv - x_adv_j) > 1e-6
    assert differ.mean() <= XADV_SHARE, differ.mean()
    assert np.abs(x_adv - x).max() <= MODEL_SUITE["epsilon"] + 1e-6
    # robust accuracy on JAX's x_adv: the same samples stand
    with torch.no_grad():
        acc = (ops.logits_eval(t_(np.array(x_adv_j))).argmax(-1).numpy() == y).mean()
    assert acc == acc_j < 1.0


# ---------------------------------------------------------------------------
# (e) which forwards share the square front-end's draw
# ---------------------------------------------------------------------------

def square_model(shape=(2, 32, 32, 3)):
    source = helpers.RecordingSource()
    model = build_model("resnet18_EE_square", helpers.EE_ARGS, 200,
                        square_source=source, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).random(shape).astype(np.float32))
    return ModelOps(model), source, x


def test_draws_shared_as_jax_keys_them(monkeypatch):
    """JAX keys (edge_enhancement_tpu/attacks/autoattack.py): every APGD
    forward (:148, :157, :161, :198, :205) and every Square query (:449,
    :480) under its own key; FAB's decision at the iterate and at the new
    point under one (:356, :376), its gradient under another (:357)."""
    ops, source, x = square_model()
    used = helpers.record_forwards(monkeypatch, source)
    y = torch.tensor([3, 5])
    n = 3
    taa.apgd(ops.logits_eval, x, y, taa.APGDConfig(helpers.EPS, n, 200),
             draw=ops.square_draws)
    assert used == list(range(2 * n + 1)) and len(source.draws) == 2 * n + 1
    used.clear()
    source.draws.clear()
    taa.fab_targeted(ops.logits_eval, x, y, torch.tensor([1, 2]),
                     taa.FABConfig(helpers.EPS, 2), draw=ops.square_draws)
    assert used == [0, 1, 0, 2, 3, 2] and len(source.draws) == 4
    used.clear()
    source.draws.clear()
    taa.square_attack(ops.logits_eval, x, y, taa.SquareConfig(helpers.EPS, 4),
                      draw=ops.square_draws)
    assert used == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# (f) eval.py --suite aa on the CPU
# ---------------------------------------------------------------------------

CONFIG = "edge_enhancement_tpu/configs/tiny_imagenet/ee_at_bpda3_square.yml"


def test_eval_autoattack_path(monkeypatch, capsys):
    """The port's eval.py runs the AA battery at tiny counts (as
    tests/test_eval_driver.py's JAX case) and prints JAX's tag line; the
    clean and the robust scoring forwards share one draw (JAX's k2,
    eval.py:151-152), and the forward and gradient counts are the suite's."""
    import os

    from edge_enhancement_tpu_torch import eval as port_eval
    from edge_enhancement_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = port_eval.parser().parse_args([
        "--config", os.path.join(repo, CONFIG), "--data", "synthetic",
        "--synthetic-size", "8", "--batch-size", "2", "--device", "cpu",
        "--suite", "aa", "--aa-batches", "1", "--aa-attacks",
        "apgd-ce,apgd-t,fab-t,square"])
    cfg = load_config(args.config, vars(args))
    cfg.update(aa_apgd_steps=2, aa_fab_steps=2, aa_square_queries=2,
               aa_target_classes=1, cize=32, limit_batches=3)
    source = helpers.RecordingSource()
    real_build = port_eval.build

    def build(cfg_, num_classes, device):
        ops, state, gen = real_build(cfg_, num_classes, device)
        ops.model.square_source = source
        return ops, state, gen
    monkeypatch.setattr(port_eval, "build", build)
    used = helpers.record_forwards(monkeypatch, source)
    (res,) = port_eval.run(cfg)
    lines = capsys.readouterr().out.splitlines()
    aa = [ln for ln in lines if ln.startswith("AutoAttack:")]
    assert len(aa) == 1, lines
    clean = float(aa[0].split("clean Prec@1")[1].split()[0])
    robust = float(aa[0].split("robust Prec@1")[1].split()[0])
    assert 0.0 <= robust <= clean <= 100.0
    assert res["label"] == "AutoAttack" and res["batches"] == 1
    assert res["iterations"] == 2 + 2 + 2 + 2
    # forwards: prediction, APGD-CE 2N + 1 and its merge, the order, APGD-T
    # 2N + 2, FAB-T 3N + 1, Square Q + 1, clean and robust scoring; FAB's
    # N steps and the scoring each reuse one draw
    assert len(used) == 1 + 6 + 1 + 6 + 7 + 3 + 2
    assert used[-1] == used[-2] and used.count(used[-1]) == 2
    assert len(source.draws) == len(used) - 2 - 1


def test_attack_split_tool_runs():
    """tools/attack_split.py at a tiny size: the four attacks twice on the
    same draws (float32 and float64), a count of split samples for each;
    and its Lockstep (chip_smoke.py j2's check of the card) against a CPU
    reference of the same weights: every forward and gradient call held,
    errors 0 on one host, and the wrapped runs equal to the plain ones."""
    from edge_enhancement_tpu_torch.tools import attack_split as tool

    small = dict(steps=1, queries=2)
    splits = tool.main(["--sets", "1", "--n", "2", "--size", "16",
                        "--steps", "1", "--queries", "2"])
    assert sorted(splits) == ["apgd-ce", "apgd-t", "fab-t", "square"]
    assert all(len(v) == 1 and 0 <= v[0] <= 2 for v in splits.values())

    cfg = tool.load_config(tool.CONFIG)
    state = build_model(cfg["arch"], cfg, 200,
                        generator=torch.Generator().manual_seed(1)).state_dict()
    x = t_(np.random.default_rng(3).random((2, 16, 16, 3)).astype(np.float32))
    fixed = tool.add_square_draws(x.shape, torch.Generator().manual_seed(6))
    y, target = tool.clean_top2(state, cfg, x, fixed)
    held = tool.replayed_attacks(state, cfg, x, y, target, fixed, "cpu", reference=ModelOps(
        tool.model_from_state(state, cfg)), **small)
    plain = tool.replayed_attacks(state, cfg, x, y, target, fixed, "cpu", **small)
    # forwards and gradients of one APGD step, one FAB step, two Square queries
    counts = {"apgd-ce": (3, 1), "apgd-t": (3, 1), "fab-t": (3, 1), "square": (2, 0)}
    for name, (x_adv, wrong, step) in held.items():
        assert (step.forwards, step.gradients) == counts[name], name
        assert step.logits_err == step.grad_norm_err == step.frontend_err == 0.0, name
        torch.testing.assert_close(x_adv, plain[name][0], rtol=0, atol=0)
        assert torch.equal(wrong, plain[name][1]) and plain[name][2] is None
