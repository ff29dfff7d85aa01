"""Shared pieces of the port-vs-JAX tests (tests/test_torch_*.py): square
draws made with numpy and replayed on both sides, JAX's dropout masks
taken out of its forwards and replayed in the port, the JAX model's
weights carried into the port, and one train step run on both sides and
compared."""

import copy
import functools
import math

import numpy as np
import torch
import jax
import jax.numpy as jnp

from edge_enhancement_tpu.attacks import pgd as jpgd
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.models.registry import build_model as jax_build_model
from edge_enhancement_tpu.objectives import methods as jmethods
from edge_enhancement_tpu.ops import square as jsquare
from edge_enhancement_tpu.train import trainer as jtrainer
from edge_enhancement_tpu.train.modelops import ModelOps as JaxModelOps
from edge_enhancement_tpu.train.sgd import init_momentum
from edge_enhancement_tpu_torch.attacks import pgd as tpgd
from edge_enhancement_tpu_torch.convert import arch_state_dict_from_jax
from edge_enhancement_tpu_torch.models import resnet as tresnet
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.objectives import methods as tmethods
from edge_enhancement_tpu_torch.ops.square import add_square_draws, square_side
from edge_enhancement_tpu_torch.train import trainer as ttrainer
from edge_enhancement_tpu_torch.train.modelops import ModelOps

EPS = 0.062745098039216
EE_ARGS = dict(r=8, w=1.0, low=38.0, high=76.0, alpha=0.0, sigma=1.0, gf=False,
               type_canny="CannyFilter_step125_1", epsilon=EPS, n_queries=1)
def jax_draws(key, shape, n_queries, p_init=0.8, rescale_schedule=False):
    """The draws that JAX's add_square makes from `key`, in the port's
    layout (ops/square.add_square_draws): the same key splits, in order."""
    b, h, w, c = shape
    key_init, key_loop = jax.random.split(key)
    stripes = jsquare._random_sign(key_init, (b, 1, w, c))
    masks, signs, rows = [], [], jnp.arange(h)
    for i in range(n_queries):
        key_loop, key_pos, key_sgn = jax.random.split(key_loop, 3)
        s = max(int(round(math.sqrt(jsquare.p_selection(i, p_init, n_queries, rescale_schedule)
                                    * (c * h * h) / c))), 1)
        vh = jnp.floor(jax.random.uniform(key_pos) * (h - s)).astype(jnp.int32)
        span = (rows >= vh) & (rows < vh + s)
        masks.append((span[:, None] & span[None, :]).astype(jnp.float32))
        signs.append(jsquare._random_sign(key_sgn, (1, 1, 1, c)))
    t = lambda a: torch.from_numpy(np.array(a))
    if n_queries == 1:
        return t(stripes), t(masks[0]), t(signs[0])
    return t(stripes), t(jnp.stack(masks)), t(jnp.stack(signs))


def square_draws(n_calls, shape, seed=7, n_queries=1):
    """One (stripes (B,1,W,C), mask (H,W), sign (1,1,1,C)) per forward; with
    n_queries > 1 the masks and signs of the queries stacked, (n, H, W) and
    (n, 1, 1, 1, C) (ops/square.add_square_draws's layout)."""
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(n_calls):
        stripes = rng.choice([-1.0, 1.0], size=(b, 1, w, c)).astype(np.float32)
        masks, signs = [], []
        for i in range(n_queries):
            s = square_side(h, c, 0.8, i, n_queries)
            vh = int(rng.integers(0, h - s + 1))
            mask = np.zeros((h, w), np.float32)
            mask[vh:vh + s, vh:vh + s] = 1.0
            masks.append(mask)
            signs.append(rng.choice([-1.0, 1.0], size=(1, 1, 1, c)).astype(np.float32))
        if n_queries == 1:
            draws.append((stripes, masks[0], signs[0]))
        else:
            draws.append((stripes, np.stack(masks), np.stack(signs)))
    return draws


class JaxSquareReplay:
    """Stands in for edge_enhancement_tpu.models.ee_frontend.add_square: the
    JAX add_square arithmetic on the next recorded draw (one per traced call,
    so the attack loop must stay unrolled)."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, x, key, *, epsilon, n_queries=1, **_):
        stripes, masks, signs = (jnp.asarray(a) for a in self.draws[self.calls])
        self.calls += 1
        if masks.ndim == 2:
            masks, signs = masks[None], signs[None]
        assert masks.shape[0] == n_queries
        x_best = jnp.clip(x + epsilon * stripes, 0.0, 1.0)
        for mask, sign in zip(masks, signs):
            x_best = x_best + 2.0 * epsilon * sign * mask[None, :, :, None]
            x_best = jnp.minimum(jnp.maximum(x_best, x - epsilon), x + epsilon)
            x_best = jnp.clip(x_best, 0.0, 1.0)
        return x_best


class TorchSquareReplay:
    """The port's square draw source replaying the same draws."""

    def __init__(self, draws):
        self.draws, self.calls = list(draws), 0

    def __call__(self, shape, n_queries=1):
        d = self.draws[self.calls]
        self.calls += 1
        assert n_queries == (1 if d[1].ndim == 2 else d[1].shape[0])
        return tuple(torch.from_numpy(a.copy()) for a in d)


class RecordingSource:
    """A square source that keeps every fresh draw it makes (the draw
    sharing tests of tests/test_torch_autoattack.py and
    test_torch_restart_pgd.py)."""

    def __init__(self):
        self.gen = torch.Generator().manual_seed(0)
        self.draws = []

    def __call__(self, shape):
        self.draws.append(add_square_draws(shape, self.gen))
        return self.draws[-1]


def record_forwards(monkeypatch, source):
    """The index into source.draws of the draw each front-end call used."""
    used = []
    real = tresnet.ee_frontend

    def spy(x, cfg, square_source, edge_map=None):
        d = square_source(x.shape)
        used.append(next(i for i, r in enumerate(source.draws) if r is d))
        return real(x, cfg, lambda shape: d, edge_map=edge_map)
    monkeypatch.setattr(tresnet, "ee_frontend", spy)
    return used


def random_variables(shapes, rng, spread: float = 0.0):
    """numpy values for a flax variable tree of ShapeDtypeStructs: conv
    kernels N(0, 2/fan_out), Dense N(0, 1/fan_in), biases 0, BatchNorm
    scale and variance 1 and mean 0; `spread` > 0 moves the BatchNorm
    terms by N(0, spread) (the variance by U(-5 spread, 5 spread))."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan = (np.prod(s.shape[:-2]) * s.shape[-1] if len(s.shape) == 4
                   else s.shape[0] / 2.0)
            return rng.normal(0, np.sqrt(2.0 / fan), s.shape).astype(np.float32)
        if name == "var":
            return 1.0 + rng.uniform(-5 * spread, 5 * spread, s.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        if name == "bias" and len(path) == 2 and path[0].key.startswith("Dense"):
            return np.zeros(s.shape, np.float32)
        return (base + spread * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_init(image_shape, arch, seed, ee_items, num_classes=200):
    """The JAX model's ModelOps and its initial variables, and the port's
    state_dict of them, made once a process (JAX arrays are immutable)."""
    args = dict(ee_items)
    ops = JaxModelOps(jax_build_model(arch, args, num_classes))
    params, batch_stats = jax.jit(ops.init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1,) + image_shape, jnp.float32))
    sd = arch_state_dict_from_jax(arch, to_numpy_tree(params),
                                  to_numpy_tree(batch_stats), args)
    return ops, params, batch_stats, sd


def jax_and_port_models(shape, arch="resnet18_EE_square", seed=0, ee_args=None,
                        num_classes=200):
    """(jax ModelOps, params, batch_stats, a fresh port model with those
    weights)."""
    ee_args = EE_ARGS if ee_args is None else ee_args
    ops, params, batch_stats, sd = _jax_init(tuple(shape[1:]), arch, seed,
                                             tuple(sorted(ee_args.items())),
                                             num_classes)
    model = build_model(arch, ee_args, num_classes)
    model.load_state_dict(sd)
    return ops, params, batch_stats, model


class JaxDropoutCapture:
    """Stands in for jax.random.bernoulli (flax's Dropout draws its mask
    with it): the real draw, each mask handed out of the traced program in
    program order (an ordered debug callback). `masks` are the port's keep
    masks, (B, C) booleans."""

    def __init__(self):
        self.masks, self.real = [], jax.random.bernoulli

    def __call__(self, key, p=0.5, shape=None, **kw):
        mask = self.real(key, p, shape, **kw)
        jax.debug.callback(lambda m: self.masks.append(
            np.array(m).reshape(m.shape[0], m.shape[-1])), mask, ordered=True)
        return mask


class MaskReplay:
    """The port's dropout source replaying given keep masks in order."""

    def __init__(self, masks):
        self.masks, self.calls = list(masks), 0

    def __call__(self, shape):
        m = self.masks[self.calls]
        self.calls += 1
        assert m.shape == tuple(shape[:2]), (m.shape, shape)
        return torch.from_numpy(m.copy())


# The train step of the comparison: EE_BPDA3_AT_square at a small size
STEP_SHAPE = (8, 32, 32, 3)
PGD_STEPS, LR, MOMENTUM, WD = 2, 0.1, 0.9, 2e-4
STEP_SIZE = 0.007843137254902


def _jax_spy(captured):
    real = jmethods.pgd_linf

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(lambda a: captured.__setitem__("x_adv", np.asarray(a)),
                           out[0])
        return out
    return spy


def _port_spy(captured, replacement):
    """Runs the port's attack (its draws and BatchNorm updates happen) and
    returns `replacement['x_adv']` in place of its result."""
    real = tpgd.pgd_linf

    def spy(*args, **kwargs):
        captured["x_adv"] = real(*args, **kwargs).numpy()
        return torch.from_numpy(replacement["x_adv"].copy()).to(args[1].dtype)
    return spy


def port_forwards(kind, k):
    """(the port's forwards in one train step of `kind` with a K-step
    attack, and for each forward of the JAX trace the port forward whose
    square draw it takes). Each forward draws one square and, on the card,
    launches K1 once. JAX runs ALP's and TRADES' clean train-mode forward
    twice on one key, so both of its passes take the port's one draw."""
    if kind == "st":
        return 1, [0]
    if kind in ("alp", "tar_alp"):          # clean, K attack steps, out
        return k + 2, list(range(k + 1)) + [0, k + 1]
    if kind == "trades":                    # clean, K steps, metric, adv
        return k + 3, list(range(k + 2)) + [0, k + 2]
    return k + 1, list(range(k + 1))        # K steps, the trained forward


def port_masks(kind):
    """Which of JAX's dropout masks, in the order of its train-mode
    forwards, the port's train-mode forwards take (None: all of them).
    JAX's ALP and TRADES run the clean forward twice on one key, so one
    mask twice; the port's one clean forward takes it."""
    return {"alp": [0], "tar_alp": [0], "trades": [0, 2]}.get(kind)


def train_step_pair(monkeypatch, ee_args=None, method="EE_BPDA3_AT_square",
                    arch="resnet18_EE_square", float64=False,
                    shape=STEP_SHAPE, pgd_steps=PGD_STEPS, num_classes=200,
                    **fields):
    """One train step of `method` (MethodConfig `fields` beside the
    flagship's) in the JAX package and in the port on carried weights, with
    every draw made with numpy and replayed on both sides: the square
    draws, the PGD start (uniform, Gaussian, the trick's gate), the target
    offsets, tarAVmixup's offsets, AVmixup's weights and pre_square's
    square; an MNIST CNN's dropout masks are JAX's own, taken out of its
    step and replayed in the port (`port_masks`). The port's attack runs,
    but the port takes JAX's x_adv for the update. Returns the port's (metrics, state, model, x_adv) and JAX's
    (metrics, state, x_adv); x_adv is None for ST, which runs no attack.
    `shape` is the batch's and `pgd_steps` the attack's iterations
    (STEP_SHAPE and PGD_STEPS by default).
    With `float64`, also the port's step in float64 on the same draws (its
    own attack, then JAX's x_adv for the update) as a third such tuple."""
    n = num_classes
    ops_j, params, bs, model = jax_and_port_models(shape, arch=arch,
                                                   ee_args=ee_args, num_classes=n)
    model64 = copy.deepcopy(model).double() if float64 else None
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    y = rng.integers(0, n, shape[0]).astype(np.int32)
    noise = rng.uniform(-EPS, EPS, shape).astype(np.float32)
    b = shape[0]
    kind = jmethods.canonical_method(method)
    n_port, jax_order = port_forwards(kind, pgd_steps)
    draws = square_draws(n_port if arch.endswith("_square") else 0, shape,
                         n_queries=(ee_args or EE_ARGS).get("n_queries", 1))
    drng = np.random.default_rng(1)
    gauss = drng.standard_normal(shape).astype(np.float32)
    gate = np.float32(drng.random())
    tgt_offs = drng.integers(1, n, b).astype(np.int32)
    mix_offs = drng.integers(1, n, (b, n)).astype(np.int32)
    w = drng.random((b, 1, 1, 1)).astype(np.float32)
    pre = square_draws(1, shape, seed=8)
    cap_j = {}

    # ---- JAX: the jitted step; the fakes trace once per (unrolled) call ----
    sq_j = JaxSquareReplay([draws[i] for i in jax_order] if draws else [])
    pre_j = JaxSquareReplay(pre)
    monkeypatch.setattr(jee, "add_square", sq_j)
    monkeypatch.setattr(jmethods, "add_square", pre_j)

    def init(cfg, key, xx):
        if cfg.random_init == "gaussian":
            return xx + 0.001 * gauss
        if cfg.random_init == "trick":
            use = (gate > cfg.prob_start_from_clean).astype(np.float32)
            return jnp.clip(xx + use * noise, 0.0, 1.0)
        return jnp.clip(xx + noise, 0.0, 1.0)
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *a, **k):     # AVmixup's w; others real
        if tuple(shape) == w.shape:
            return jnp.asarray(w)
        return real_uniform(key, shape, *a, **k)
    monkeypatch.setattr(jpgd, "_init_perturbation", init)
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, *a, **k: jnp.asarray(
        {(b,): tgt_offs, (b, n): mix_offs}[tuple(shape)]))
    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jmethods, "pgd_linf", _jax_spy(cap_j))
    dropout = JaxDropoutCapture()
    monkeypatch.setattr(jax.random, "bernoulli", dropout)
    common = dict(epsilon=EPS, num_steps=pgd_steps, step_size=STEP_SIZE,
                  num_classes=n, **fields)
    mcfg_j = jmethods.MethodConfig(method, **common)
    step_j = jtrainer.build_train_step(ops_j, mcfg_j, jtrainer.OptimConfig(MOMENTUM, WD))
    state_j = jtrainer.TrainState(params=params, batch_stats=bs,
                                  momentum_buf=init_momentum(params),
                                  step=jnp.zeros((), jnp.int32))
    state_j, m_j = step_j(state_j, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(0), jnp.float32(LR))
    jax.block_until_ready(state_j)
    assert sq_j.calls == len(sq_j.draws)
    assert pre_j.calls == int(bool(fields.get("pre_square")))
    masks = dropout.masks
    if kind in ("alp", "tar_alp", "trades"):    # both clean passes, one mask
        assert len(masks) == 0 or np.array_equal(masks[0], masks[1])
    take = port_masks(kind)
    masks = masks if take is None or not masks else [masks[i] for i in take]

    # ---- the port ----------------------------------------------------------
    t = torch.from_numpy
    monkeypatch.setattr(tpgd, "uniform_init_noise", lambda xx, eps, gen: t(noise))
    monkeypatch.setattr(tpgd, "gaussian_init_noise", lambda xx, gen: t(gauss))
    monkeypatch.setattr(tpgd, "trick_gate", lambda xx, gen: torch.tensor(gate))
    obj = tmethods.Objective
    monkeypatch.setattr(obj, "target_offsets", lambda self, yy: t(tgt_offs))
    monkeypatch.setattr(obj, "avmixup_offsets", lambda self, oh: t(mix_offs))
    monkeypatch.setattr(obj, "mix_weights", lambda self, xx: t(w))
    mcfg = tmethods.MethodConfig(method, **common)

    def port_step(model, dtype):
        sq_t = model.square_source = TorchSquareReplay(draws)
        drop_t = model.dropout_source = MaskReplay(masks)
        pre_t = TorchSquareReplay(pre)
        cap_t = {}
        monkeypatch.setattr(obj, "square_draws", lambda self, shape: pre_t(shape))
        monkeypatch.setattr(tmethods, "pgd_linf", _port_spy(cap_t, cap_j))
        state = ttrainer.create_train_state(model)
        step = ttrainer.build_train_step(ModelOps(model), mcfg,
                                         ttrainer.OptimConfig(MOMENTUM, WD))
        m = step(state, t(x).to(dtype), t(y).long(), LR)
        assert sq_t.calls == len(draws) and pre_t.calls == pre_j.calls
        assert drop_t.calls == len(masks)
        return m, state, model, cap_t.get("x_adv")

    out = (port_step(model, torch.float32), (m_j, state_j, cap_j.get("x_adv")))
    return out + (port_step(model64, torch.float64),) if float64 else out


# The comparison's tolerances against JAX (tests/test_torch_train_step.py
# explains them): the share of x_adv pixels off JAX's, then on the same
# x_adv the parameters, the running statistics and the momentum.
JAX_TOL = dict(share=0.05, params=1e-4, running=2e-3, momentum=1e-3)


def _state_dicts(state, model, want_params, want_stats, want_mom, arch, args):
    sd = model.state_dict()
    mom = dict(zip((n for n, _ in model.named_parameters()), state.momentum_buf))
    want = arch_state_dict_from_jax(arch, want_params, want_stats, args)
    assert sorted(want) == sorted(sd)
    return sd, mom, want, arch_state_dict_from_jax(arch, want_mom, want_stats, args)


def _assert_states_close(sd, mom, want, want_mom, tol):
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=tol["running"], err_msg=k)
        else:
            np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                       atol=tol["params"], rtol=tol["params"], err_msg=k)
    for k, b in mom.items():
        np.testing.assert_allclose(b.numpy(), want_mom[k].numpy(),
                                   atol=tol["momentum"], rtol=tol["momentum"], err_msg=k)


def assert_train_steps_agree(port, jax_side, tol=None, arch="resnet18", args=None):
    """The comparison of `train_step_pair`'s two steps, with JAX_TOL's
    tolerances unless `tol` replaces some; `arch` (and the config `args`,
    for a PreActResNet's stem) picks the name map."""
    tol = {**JAX_TOL, **(tol or {})}
    (m, state, model, x_adv), (m_j, state_j, x_adv_j) = port, jax_side
    assert state.step == 1
    if x_adv_j is not None:
        # the port's own x_adv: the share of pixels off JAX's
        differ = np.abs(x_adv - x_adv_j) > 1e-6
        assert differ.mean() <= tol["share"], differ.mean()
    # from here both sides hold the same x_adv: loss and top-1 (measured
    # 2.4e-6 relative), then the update: p - lr * buf from float32
    # parameter gradients of two libraries (measured 2.9e-5); the running
    # statistics, whose attack forwards ran on each side's own x_adv
    # (measured 8.4e-4 on values of order 1); buf = g + wd * p after one
    # step (measured 3.3e-4 on |buf| ~ 7)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=2e-5)
    assert float(m["top1"]) == float(m_j["top1"])
    tree = to_numpy_tree
    _assert_states_close(*_state_dicts(state, model, tree(state_j.params),
                                       tree(state_j.batch_stats),
                                       tree(state_j.momentum_buf), arch, args), tol)


def assert_matches_float64(port, port64, tol):
    """The port's float32 step against its float64 step on the same draws:
    both attacks' x_adv (share of pixels off by > 1e-6), then, both on
    JAX's x_adv, the loss and the update."""
    (m, state, model, x_adv), (m64, state64, model64, x_adv64) = port, port64
    if x_adv is not None:
        differ = np.abs(x_adv - x_adv64) > 1e-6
        assert differ.mean() <= tol["share"], differ.mean()
    np.testing.assert_allclose(float(m["loss"]), float(m64["loss"]), rtol=2e-6)
    sd64 = {k: v.float() for k, v in model64.state_dict().items()}
    mom64 = [b.float() for b in state64.momentum_buf]
    names = [n for n, _ in model.named_parameters()]
    _assert_states_close(model.state_dict(), dict(zip(names, state.momentum_buf)),
                         sd64, dict(zip(names, mom64)), tol)


def native_decode_spy(monkeypatch, *modules) -> list:
    """Wrap each module's stream_decode_files (the port's data/native.py,
    the JAX package's data/native.py); returns, per module, [batches the
    native decoder delivered, batches it handed back to PIL (None)]."""
    hits = [[0, 0] for _ in modules]
    for i, mod in enumerate(modules):
        real = mod.stream_decode_files

        def spy(*a, _real=real, _i=i, **kw):
            out = _real(*a, **kw)
            hits[_i][out is None] += 1
            return out

        monkeypatch.setattr(mod, "stream_decode_files", spy)
    return hits


class _JaxStream:
    """Hands the next of `items` (tuples of float32 numpy arrays) to a
    traced JAX program at each call, in program order: so a fake that a
    lax.scan body traces once gives each step its own draws. On one device
    an ordered io_callback keeps the order. A program on several devices
    refuses ordered effects, so there the callback is unordered and takes
    the array that the draw is for as an operand: each draw's input
    depends on the previous draw's use (the attack's next iterate, the next
    step of the scan), which orders the calls; the callback runs once, on
    the whole array (checked against `operand_shape`). (The callback runs
    on the runtime's thread, which jax.enable_x64 does not reach: a float64
    item would come back as float32, so the fakes widen what they get.)"""

    def __init__(self, items, operand_shape=None):
        self.items, self.calls = list(items), 0
        self.operand_shape = operand_shape

    def _next(self, *operands):
        for a in operands:
            assert a.shape == self.operand_shape, (a.shape, self.operand_shape)
        item = self.items[self.calls]
        self.calls += 1
        return item

    def __call__(self, operand=None):
        from jax.experimental import io_callback
        shapes = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in self.items[0])
        if self.operand_shape is None:
            return io_callback(self._next, shapes, ordered=True)
        return io_callback(self._next, shapes, jax.lax.stop_gradient(operand),
                           ordered=False)


def chained_step_jax(monkeypatch, k=2, shape=STEP_SHAPE, pgd_steps=1, n_data=None,
                     n_model=1):
    """JAX's half of `chained_step_pair`: K flagship steps
    (EE_BPDA3_AT_square) as one chained dispatch of the JAX package
    (build_chained_train_step: a lax.scan over the batch stack, its keys
    split as the JAX driver splits a chain's) on float64 carried weights,
    each step's square draws and PGD start made with numpy and replayed.
    With `n_data` the step is jitted over meshlib.make_mesh(n_data,
    n_model), the state laid out by the JAX package's sharding.py
    (shard_state, state_sharding: conv and dense kernels cut on the
    `model` axis) and the stacks sharded P(None, 'data') by
    shard_batch_stacked, as the JAX driver's chains under several devices.
    Returns (the port's inputs: its model on the same weights, xs, ys, the
    draws in the port's order, the PGD starts, the fields of the method),
    and JAX's (metrics, state, [x_adv a step])."""
    from edge_enhancement_tpu.parallel import mesh as meshlib
    from edge_enhancement_tpu.parallel import sharding as jsharding
    ops_j, params, bs, model = jax_and_port_models(shape)
    wide = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)
    rng = np.random.default_rng(0)
    b = shape[0]
    xs = rng.random((k,) + shape)
    ys = rng.integers(0, 200, (k, b)).astype(np.int32)
    noise = [rng.uniform(-EPS, EPS, shape).astype(np.float32) for _ in range(k)]
    n_fwd, order = port_forwards("at", pgd_steps)
    draws = square_draws(k * n_fwd, shape)

    # ---- JAX: each fake traced once in the scan body, its draws streamed --
    along = shape if n_data else None
    squares = _JaxStream([draws[s * n_fwd + i] for s in range(k) for i in order], along)
    starts = _JaxStream([(n,) for n in noise], along)

    def add_square(x, key, *, epsilon, n_queries=1, **_):
        stripes, mask, sign = (a.astype(x.dtype) for a in squares(x))
        x_best = jnp.clip(x + epsilon * stripes, 0.0, 1.0)
        x_best = x_best + 2.0 * epsilon * sign * mask[None, :, :, None]
        x_best = jnp.minimum(jnp.maximum(x_best, x - epsilon), x + epsilon)
        return jnp.clip(x_best, 0.0, 1.0)

    def init(cfg, key, xx):
        (n,) = starts(xx)
        return jnp.clip(xx + n.astype(xx.dtype), 0.0, 1.0)

    x_adv_j = []
    real_pgd = jmethods.pgd_linf

    def spy(*args, **kwargs):
        # x_adv's float64 bits as uint32 pairs: a float64 array would come
        # back rounded to float32 (_JaxStream says why); unordered on a
        # mesh, where the scan's steps still run one after the other
        out = real_pgd(*args, **kwargs)
        jax.debug.callback(lambda a: x_adv_j.append(np.asarray(a).view(np.float64)[..., 0]),
                           jax.lax.bitcast_convert_type(out[0], jnp.uint32),
                           ordered=not n_data)
        return out
    monkeypatch.setattr(jee, "add_square", add_square)
    monkeypatch.setattr(jpgd, "_init_perturbation", init)
    monkeypatch.setattr(jmethods, "pgd_linf", spy)
    common = dict(epsilon=EPS, num_steps=pgd_steps, step_size=STEP_SIZE, num_classes=200)
    mesh = meshlib.make_mesh(n_data=n_data, n_model=n_model) if n_data else None
    method_j = jmethods.MethodConfig("EE_BPDA3_AT_square", **common)
    with jax.enable_x64(True):
        state_j = jtrainer.TrainState(params=wide(params), batch_stats=wide(bs),
                                      momentum_buf=init_momentum(wide(params)),
                                      step=jnp.zeros((), jnp.int32))
        keys = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[1], k)
        xb, yb, lr = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(LR)
        state_sharding = None
        if mesh is not None:
            state_j = jsharding.shard_state(mesh, state_j)
            kernel = state_j.params["Conv_0"]["kernel"]
            assert kernel.sharding.shard_shape(kernel.shape)[-1] * n_model == kernel.shape[-1]
            state_sharding = jsharding.state_shardings(mesh, state_j)
            keys, lr = meshlib.replicate(mesh, (keys, lr))
            xb, yb = meshlib.shard_batch_stacked(mesh, (xb, yb))
        step_j = jtrainer.build_chained_train_step(
            ops_j, method_j, jtrainer.OptimConfig(MOMENTUM, WD), mesh=mesh,
            state_sharding=state_sharding)
        state_j, m_j = step_j(state_j, xb, yb, keys, lr)
        jax.block_until_ready(state_j)
        jax.effects_barrier()                   # the x_adv callbacks have run
        assert state_j.params["Conv_0"]["kernel"].dtype == jnp.float64
    assert squares.calls == len(squares.items) and starts.calls == k
    assert int(state_j.step) == k and len(x_adv_j) == k
    port = dict(model=model, xs=xs, ys=ys, draws=draws, noise=noise, fields=common)
    return port, (m_j, state_j, x_adv_j)


def chained_step_pair(monkeypatch, k=2, shape=STEP_SHAPE, pgd_steps=1):
    """K flagship train steps (EE_BPDA3_AT_square) as one chained dispatch
    in the JAX package (`chained_step_jax`) and in the port
    (build_chained_train_step: the CPU loop), on carried weights, with
    each step's square draws and PGD start noise made with numpy and
    replayed on both sides in step order. The port's attack runs, but the
    port takes JAX's x_adv of each step for its update. Both sides run in
    float64 (JAX under jax.enable_x64): in float32 the second step's
    gradient at this size moves by ~40% of its largest value for a 4e-5
    move of conv1's weights (the first step's float32 difference between
    the two libraries), so only float64 can hold K steps. Returns the
    port's (metrics, state, model, [x_adv a step]) and JAX's (metrics,
    state, [x_adv a step])."""
    port, (m_j, state_j, x_adv_j) = chained_step_jax(monkeypatch, k, shape, pgd_steps)
    model, draws, common = port["model"], port["draws"], port["fields"]

    # ---- the port --------------------------------------------------------
    t = torch.from_numpy
    model.double()
    sq_t = model.square_source = TorchSquareReplay(draws)
    noise_t = iter(port["noise"])
    monkeypatch.setattr(tpgd, "uniform_init_noise",
                        lambda xx, eps, gen: t(next(noise_t)).to(xx.dtype))
    x_adv_t, real_port = [], tpgd.pgd_linf

    def port_spy(*args, **kwargs):
        x_adv_t.append(real_port(*args, **kwargs).numpy())
        return t(x_adv_j[len(x_adv_t) - 1].copy()).to(args[1].dtype)
    monkeypatch.setattr(tmethods, "pgd_linf", port_spy)
    state = ttrainer.create_train_state(model)
    step = ttrainer.build_chained_train_step(
        ModelOps(model), tmethods.MethodConfig("EE_BPDA3_AT_square", **common),
        ttrainer.OptimConfig(MOMENTUM, WD))
    m = step(state, t(port["xs"]), t(port["ys"]).long(), LR)
    assert sq_t.calls == len(draws) and len(x_adv_t) == k
    return (m, state, model, x_adv_t), (m_j, state_j, x_adv_j)


def assert_chained_steps_agree(port, jax_side, tol=None):
    """`chained_step_pair`'s two dispatches at JAX_TOL's tolerances (or
    `tol`'s): each step's x_adv share off JAX's, then the state after the
    K steps and the last step's metrics."""
    tol = {**JAX_TOL, **(tol or {})}
    (m, state, model, x_adv), (m_j, state_j, x_adv_j) = port, jax_side
    assert state.step == len(x_adv_j)
    for a, a_j in zip(x_adv, x_adv_j):
        assert (np.abs(a - a_j) > 1e-6).mean() <= tol["share"]
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]), rtol=tol["loss"])
    assert float(m["top1"]) == float(m_j["top1"])
    tree = to_numpy_tree
    _assert_states_close(*_state_dicts(state, model, tree(state_j.params),
                                       tree(state_j.batch_stats),
                                       tree(state_j.momentum_buf), "resnet18", None), tol)
