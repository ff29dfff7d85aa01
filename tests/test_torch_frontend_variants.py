"""The rest of the port's front-end against the JAX package on the CPU: the
full and BPDA Canny (ops/canny.py), their straight-through estimators
(ops/ste.py), shift2d, add_square with any number of queries
(ops/square.py), every branch of models/ee_frontend.py's dispatch, and one
train step of the configs they open (ee_at_training.yml's full Canny, the
flagship with n_queries: 3).

Inputs are made with numpy from a seed; the square draws are JAX's own,
recomputed from its key (torch_port_helpers.jax_draws) and handed to the
port. Tolerances: the edge maps exactly; the un-thresholded NMS output
within 2 float32 ulps of 1 (XLA's CPU compiler contracts the magnitude's
gx^2 + gy^2 into an FMA at a few pixels: measured 1 ulp at 8 of 2048);
input gradients within GRAD_TOL (measured 1.2e-7 on gradients of order
1)."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.ops import square as jsq
from edge_enhancement_tpu.ops import stencil as jst
from edge_enhancement_tpu.ops import ste as jste
from edge_enhancement_tpu_torch.models import ee_frontend as tee
from edge_enhancement_tpu_torch.ops import square as tsq
from edge_enhancement_tpu_torch.ops import stencil as tst
from edge_enhancement_tpu_torch.ops import ste as tste

jcanny = importlib.import_module("edge_enhancement_tpu.ops.canny")
tcanny = importlib.import_module("edge_enhancement_tpu_torch.ops.canny")

EPS = 0.062745098039216
GRAD_TOL = 1e-6
THIN_TOL = 2.4e-7          # 2 float32 ulps of 1


def _images():
    """Noise, and the ideal step: a square at 0.2 on 0.1 (an exact
    magnitude tie across each side, with magnitudes inside the STE window)."""
    rng = np.random.default_rng(0)
    noise = rng.random((2, 32, 32, 3)).astype(np.float32)
    step = np.full((2, 32, 32, 3), 0.1, np.float32)
    step[:, 8:24, 8:24, :] = 0.2
    return {"noise": noise, "step": step}


@pytest.mark.parametrize("image", ["noise", "step"])
@pytest.mark.parametrize("variant", ["canny", "canny_bpda"])
@pytest.mark.parametrize("thresholds", ["none", "low", "double", "hysteresis"])
def test_canny_matches_jax(image, variant, thresholds):
    args = {"none": (None, None, False), "low": (38 / 255, None, False),
            "double": (38 / 255, 76 / 255, False),
            "hysteresis": (38 / 255, 76 / 255, True)}[thresholds]
    x = _images()[image]
    u = np.random.default_rng(1).standard_normal((2, 32, 32, 1)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: getattr(jcanny, variant)(a, *args, alpha=0.05),
                         jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(u))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = getattr(tcanny, variant)(xt, *args, alpha=0.05)
    out.backward(torch.from_numpy(u))
    out, out_j = out.detach().numpy(), np.asarray(out_j)
    thresholded = thresholds != "none" and not (variant == "canny_bpda"
                                                and thresholds == "low")
    if thresholded:
        np.testing.assert_array_equal(out, out_j)
    else:
        np.testing.assert_allclose(out, out_j, atol=THIN_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), atol=GRAD_TOL, rtol=0)
    if image == "noise":
        assert 0 < (out > 0).mean() < 1
        assert np.abs(np.asarray(g_j)).max() > 1e-3
    elif not thresholded:
        # the ring, thinned
        assert 0 < (out > 0).sum() < 4 * 16 * 2


def test_step_ties_match_jax():
    """The knife edge of the ideal step. Across its right side the
    magnitude ties exactly (the channel sum before the Sobel computes JAX's
    exact tie) and NMS keeps neither pixel (the strict `> 0` test); across
    its left side the Sobel's tap order leaves one ulp between the two and
    NMS keeps the larger. The whole NMS output is JAX's bit for bit."""
    x = torch.from_numpy(_images()["step"])
    _, _, mag = tcanny._blur_sobel_magnitude_nchw(x.permute(0, 3, 1, 2), 1.0, wide=False)
    mag = mag[0, 0]
    thin = tcanny.canny(x)[0, :, :, 0]
    assert float(mag[16, 23]) == float(mag[16, 24]) > 0.1
    assert float(thin[16, 23]) == float(thin[16, 24]) == 0.0
    assert float(mag[16, 7]) == float(np.nextafter(np.float32(mag[16, 8]), np.float32(1)))
    assert float(thin[16, 7]) == float(mag[16, 7]) and float(thin[16, 8]) == 0.0
    np.testing.assert_array_equal(
        thin.numpy(), np.asarray(jcanny.canny(jnp.asarray(x.numpy())))[0, :, :, 0])


@pytest.mark.parametrize("fn", ["binary_connect", "to_eq"])
def test_ste_window_edges(fn):
    """Forward and gradient at the window's edges: |x| = 1.001 passes
    binary_connect's gradient and the next float32 above does not; 0 maps
    to -1; to_eq passes at exactly 0.5 only."""
    above = float(np.nextafter(np.float32(1.001), np.float32(2)))
    vals = {"binary_connect": [-above, -1.001, -0.3, 0.0, 0.3, 1.001, above],
            "to_eq": [0.0, 0.4999999, 0.5, 0.5000001, 1.0]}[fn]
    x = np.asarray(vals, np.float32)
    g = np.arange(1, len(vals) + 1, dtype=np.float32)
    out_j, vjp = jax.vjp(getattr(jste, fn), jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = getattr(tste, fn)(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    if fn == "binary_connect":
        np.testing.assert_array_equal(out.detach().numpy(), [-1, -1, -1, -1, 1, 1, 1])
        np.testing.assert_array_equal(xt.grad.numpy(), [0, 2, 3, 4, 5, 6, 0])
    else:
        np.testing.assert_array_equal(xt.grad.numpy(), [0, 0, 3, 0, 0])


@pytest.mark.parametrize("offset", [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1),
                                    (1, -1), (1, 0), (1, 1), (0, 0)])
def test_shift2d_matches_jax(offset):
    x = np.random.default_rng(2).random((2, 5, 7, 3)).astype(np.float32)
    got = tst.shift2d_nchw(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), *offset)
    want = np.asarray(jst.shift2d(jnp.asarray(x), *offset)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_queries", [1, 3, 7])
def test_add_square_matches_jax(n_queries):
    shape = (2, 16, 16, 3)
    rng = np.random.default_rng(3)
    x = rng.random(shape).astype(np.float32)
    x[0, :4] = 0.0                      # clip ties at the bounds
    x[1, :4] = 1.0
    u = rng.standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    out_j, vjp = jax.vjp(lambda a: jsq.add_square(a, key, epsilon=EPS, n_queries=n_queries),
                         jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = tsq.add_square(xt, helpers.jax_draws(key, shape, n_queries), epsilon=EPS)
    out.backward(torch.from_numpy(u))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(u))[0]))
    assert (xt.grad.numpy() == 0).any() and (xt.grad.numpy() == u).any()


def test_square_schedule_and_draws():
    """p_selection and the side of every query, with and without
    rescale_schedule, equal JAX's; the port's own draws have JAX's layout
    and the sides of that schedule."""
    for n, rescale in ((60, False), (60, True), (5000, False), (7, True)):
        for i in range(n):
            assert tsq.p_selection(i, 0.8, n, rescale) == jsq.p_selection(i, 0.8, n, rescale)
    stripes, masks, signs = tsq.add_square_draws((2, 64, 64, 3), torch.Generator().manual_seed(0),
                                                 n_queries=60, rescale_schedule=True)
    assert stripes.shape == (2, 1, 64, 3) and signs.shape == (60, 1, 1, 1, 3)
    sides = masks.sum(dim=(1, 2)).sqrt()
    want = [tsq.square_side(64, 3, 0.8, i, 60, True) for i in range(60)]
    assert sides.tolist() == want and want[0] > want[-1]
    assert set(stripes.unique().tolist()) == {-1.0, 1.0}


def _cfg(type_canny="CannyFilter_step125_1", **kw):
    base = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0,
                type_canny=type_canny, square=False, epsilon=EPS, n_queries=1)
    return {**base, **kw}


# every branch of the port's dispatch: K1/K2 (step125, one query), the
# K3 pair (more queries, gf), a given edge map, the full and BPDA Canny
BRANCHES = {
    "k1_square": _cfg(square=True),
    "k3_queries": _cfg(square=True, n_queries=3),
    "k3_gf": _cfg(with_gf=True),
    "edge_map": _cfg(type_canny="u2netp", square=True, n_queries=2),
    "canny": _cfg(type_canny="CannyFilter"),
    "canny_bpda_square_gf": _cfg(type_canny="CannyFilter_BPDA", square=True,
                                 n_queries=2, with_gf=True),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_frontend_branch_matches_jax(branch):
    kw = BRANCHES[branch]
    shape = (2, 32, 32, 3)
    rng = np.random.default_rng(4)
    x = rng.random(shape).astype(np.float32)
    u = rng.standard_normal(shape).astype(np.float32)
    edge = (rng.random(shape[:3] + (1,)).astype(np.float32)
            if kw["type_canny"] == "u2netp" else None)
    key = jax.random.PRNGKey(5)
    jcfg = jee.EEConfig(**kw, fused=True)

    def fn(a):
        return jee.ee_frontend(a, jcfg, key if kw["square"] else None,
                               edge_map=None if edge is None else jnp.asarray(edge))
    out_j, vjp = jax.vjp(fn, jnp.asarray(x))
    draws = helpers.jax_draws(key, shape, kw["n_queries"]) if kw["square"] else None
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = tee.ee_frontend(xt, tee.EEConfig(**kw), lambda s, **_: draws,
                          edge_map=None if edge is None else torch.from_numpy(edge))
    out.backward(torch.from_numpy(u))
    # the HFS products sum in another order than XLA's: 1e-5 on values in
    # [0, 1], as tests/test_torch_ee_fused.py holds the front-end
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(u))[0]),
                               atol=1e-4, rtol=0)


BF = jnp.bfloat16
# XLA's CPU compiler otherwise drops bf16 roundings that feed a float32
# upcast (tests/test_torch_ee_fused_bf16.py)
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
# The bf16 policy (models/resnet.py casts the input to bfloat16 before the
# front-end) on the variants that ran in float32 only, against JAX jitted
# with EXACT_ROUNDING. The Canny edge maps: every bfloat16 operation
# rounds where JAX's does, so the maps are JAX's at all but BF16_FLIP of
# the pixels (measured: none flips), and the input gradient within BF16_DX
# of its largest magnitude (measured 7.4e-3 for CannyFilter and 5.5e-3 for
# the BPDA Canny: the stencils' adjoints sum their bfloat16 taps in another
# order than JAX's, one bfloat16 ulp apart here and there). The U2-NetP
# promotes the bfloat16 input against its float32 parameters, as flax's
# Conv with no dtype does: its edge map and the front-end's output are
# float32 on both sides and agree to U2NET_TOL (measured 1.2e-7), the
# bfloat16 input gradient within BF16_DX of its largest magnitude
# (measured: equal).
BF16_FLIP, BF16_DX, U2NET_TOL = 1e-3, 1e-2, 2e-5


def _bf16_canny_case(variant):
    fn = {"CannyFilter": "canny", "CannyFilter_BPDA": "canny_bpda"}[variant]
    args = (38 / 255, 76 / 255, True)
    x, u = _images()["noise"], np.random.default_rng(1).standard_normal(
        (2, 32, 32, 1)).astype(np.float32)

    def pair(a, cot):
        out, vjp = jax.vjp(lambda v: getattr(jcanny, fn)(v, *args, alpha=0.05), a)
        return out, vjp(cot)[0]
    out_j, g_j = jax.jit(pair, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u).astype(BF))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = getattr(tcanny, fn)(xt, *args, alpha=0.05)
    out.backward(torch.from_numpy(u).to(torch.bfloat16))
    assert out.dtype == xt.grad.dtype == torch.bfloat16 and out_j.dtype == g_j.dtype == BF
    return (out.detach().float().numpy(), np.asarray(out_j.astype(jnp.float32)),
            xt.grad.float().numpy(), np.asarray(g_j.astype(jnp.float32)))


def _bf16_u2netp_case():
    from edge_enhancement_tpu.models import u2net as ju2
    from edge_enhancement_tpu_torch.convert import u2net_state_dict_from_jax
    from edge_enhancement_tpu_torch.models import u2net as tu2
    shape = (2, 16, 16, 3)
    rng = np.random.default_rng(6)
    x = rng.random(shape).astype(np.float32)
    u = rng.standard_normal(shape).astype(np.float32)
    net = ju2.U2Net(full=False)
    v = jax.jit(lambda k: net.init(k, jnp.zeros(shape), train=False))(jax.random.PRNGKey(0))
    cfg = _cfg(type_canny="u2netp")

    def fn(a):
        edge = net.apply(v, a, train=False)
        return jee.ee_frontend(a, jee.EEConfig(**cfg), None, edge_map=edge), edge

    def pair(a, cot):
        (out, edge), vjp = jax.vjp(fn, a)
        return out, edge, vjp((cot, jnp.zeros_like(edge)))[0]
    out_j, edge_j, g_j = jax.jit(pair, compiler_options=EXACT_ROUNDING)(
        jnp.asarray(x).astype(BF), jnp.asarray(u))
    model = tu2.U2Net(full=False)
    model.load_state_dict(u2net_state_dict_from_jax(helpers.to_numpy_tree(v["params"]),
                                                    helpers.to_numpy_tree(v["batch_stats"])))
    model.eval()
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    edge = model(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    out = tee.ee_frontend(xt, tee.EEConfig(**cfg), edge_map=edge)
    out.backward(torch.from_numpy(u))
    assert edge.dtype == out.dtype == torch.float32 and edge_j.dtype == out_j.dtype == jnp.float32
    assert xt.grad.dtype == torch.bfloat16 and g_j.dtype == BF
    np.testing.assert_allclose(edge.detach().numpy(), np.asarray(edge_j), atol=U2NET_TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=U2NET_TOL)
    return xt.grad.float().numpy(), np.asarray(g_j.astype(jnp.float32))


@pytest.mark.parametrize("variant", ["CannyFilter", "CannyFilter_BPDA", "u2netp"])
def test_bf16_policy_runs_the_float32_variants(variant):
    """The full Canny and the BPDA Canny (as the front-end calls them:
    hysteresis, the flagship's thresholds), forward and input gradient, and
    the U2-NetP edge map through the front-end, in bfloat16 against JAX's
    at bfloat16."""
    if variant == "u2netp":
        g, g_j = _bf16_u2netp_case()
    else:
        out, out_j, g, g_j = _bf16_canny_case(variant)
        flips = np.abs(out - out_j) > 0.25
        assert flips.mean() <= BF16_FLIP, flips.mean()
        assert 0 < (out > 0).mean() < 1
    assert np.abs(g_j).max() > 1e-3
    np.testing.assert_allclose(g, g_j, atol=BF16_DX * np.abs(g_j).max(), rtol=0)


# config -> (ee_args beside the flagship's, step fields, tolerances against
# JAX that replace helpers.JAX_TOL, with what was measured). The full
# Canny (ee_at_training.yml): JAX's x_adv parts from the port's at 41.6% of
# pixels, where the port's float32 attack equals its float64 one (share 0):
# the attack is chaotic at float32 resolution (tests/test_torch_train_step.py)
# and JAX's float32 BatchNorm parameter gradients drift from float64
# (tests/test_torch_objectives.py); on the same x_adv the update agrees.
# The flagship with n_queries: 3 runs its edge map on K3a/K3b, JAX's on its
# Canny-only kernel (fused_canny); only conv1's update parts (8.2e-3 of
# 1 + |p|): the front-end's output saturates at 1 along the edges, and the
# max pool routes the gradient of an exact tie to its first maximum, which
# float32 rounding decides (the port's float32 and float64 steps part there
# too, so that config is not held to float64).
STEPS = {
    "ee_at_training": (dict(type_canny="CannyFilter"),
                       dict(method="EE_AT", arch="resnet18_EE"),
                       # share 0.416, params 1.0e-3, running 5.7e-2, momentum 9.0e-3
                       dict(share=0.5, params=2e-3, running=0.1, momentum=2e-2)),
    "bpda3_square_3_queries": (dict(n_queries=3, fused_canny=True), {},
                               # share 0.040, params 8.2e-3, running 5.8e-4,
                               # momentum 8.1e-2
                               dict(params=1e-2, momentum=0.1)),
}
# the port's float32 step against its float64 step (measured for
# ee_at_training: share 0, params 7.5e-6, running 1.1e-6, momentum 4.5e-5)
F64_TOL = dict(share=1e-3, params=1e-4, running=1e-5, momentum=1e-3)


@pytest.mark.parametrize("config", list(STEPS))
def test_train_step_matches_jax(monkeypatch, config):
    """One EE_AT step of ee_at_training.yml (resnet18_EE, the full Canny),
    and one flagship step with n_queries: 3, as tests/test_torch_objectives.py
    compares the objectives' steps."""
    ee_extra, kw, tol = STEPS[config]
    float64 = config == "ee_at_training"
    out = helpers.train_step_pair(monkeypatch, ee_args=dict(helpers.EE_ARGS, **ee_extra),
                                  float64=float64, **kw)
    if float64:
        helpers.assert_matches_float64(out[0], out[2], F64_TOL)
    helpers.assert_train_steps_agree(out[0], out[1], tol)
