"""AutoAttack, as edge_enhancement_tpu/attacks/autoattack.py: APGD-CE and
APGD-T (targeted DLR), FAB-T, the Square attack, and the standard suite
that runs them in turn and keeps, per sample, the first candidate that
breaks it (the reference's robust numbers come from the official
`autoattack` package; the JAX module transcribes its arithmetic).

Each attack is a plain Python loop over the JAX package's static tables
(APGD's checkpoint schedule, Square's size schedule), with per-sample masks
in place of dynamic shapes, so no step reads a tensor back to the host and
the number of forwards and input gradients does not depend on the data.

Randomness. A forward is `forward_fn(x, draws)`: `draws` are the model's
own random draws for that forward (the EE_square front-end's square), made
by `draw(x)`. Where the JAX code runs two forwards under one key, the port
passes them the same draws; every other forward gets fresh ones. The
attacks' own draws are the functions `apgd_start`, `square_stripes` and
`square_query_draws` of this module, on the explicit generator; tests
replace them to replay the JAX side's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh

ForwardFn = Callable[[torch.Tensor, Any], torch.Tensor]  # (x, draws) -> logits
DrawFn = Callable[[torch.Tensor], Any]                  # x -> one forward's draws


def no_draws(x: torch.Tensor) -> None:
    """The draw function of a forward that draws nothing."""
    return None


def _per_sample(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (B,) mask viewed to broadcast over x's sample dimensions."""
    return mask.view((-1,) + (1,) * (x.ndim - 1))


def _input_grad(fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """d sum(fn(x)) / dx, with autograd on whatever the caller's mode."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(x).sum(), [x])
    return g


def _take(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logits.gather(1, labels[:, None])[:, 0]


# --------------------------------------------------------------------------
# APGD
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class APGDConfig:
    epsilon: float
    num_steps: int = 100
    num_classes: int = 10
    rho: float = 0.75          # step-halving success-rate threshold
    momentum: float = 0.75


def _apgd_checkpoints(num_steps: int) -> list[int]:
    """Checkpoint positions as the official AutoAttack computes them
    (autopgd_base.py: n_iter_2, n_iter_min and size_decr with int()
    truncation, the window decayed at each checkpoint)."""
    n2 = max(int(0.22 * num_steps), 1)
    n_min = max(int(0.06 * num_steps), 1)
    decr = max(int(0.03 * num_steps), 1)
    ckpts = []
    k, pos = n2, n2
    while pos <= num_steps:
        ckpts.append(pos)
        k = max(k - decr, n_min)
        pos += k
    return ckpts


def _ce_loss(logits, y):
    return -_take(F.log_softmax(logits, dim=-1), y)


def _dlr_untargeted(logits, y):
    """-(z_y - max_{i!=y} z_i) / (z_pi1 - z_pi3) (Croce & Hein 2020, eq. 6)."""
    sorted_logits = torch.sort(logits, dim=-1).values
    one_hot = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
    zother = torch.amax(logits - 1e9 * one_hot, dim=-1)
    z1 = sorted_logits[:, -1]
    z3 = (sorted_logits[:, -3] if logits.shape[-1] >= 3
          else sorted_logits[:, 0])
    return -(_take(logits, y) - zother) / (z1 - z3 + 1e-12)


def _dlr_targeted(logits, y, y_target):
    """Targeted DLR (APGD-T)."""
    sorted_logits = torch.sort(logits, dim=-1).values
    z1 = sorted_logits[:, -1]
    z3 = sorted_logits[:, -3]
    z4 = sorted_logits[:, -4] if logits.shape[-1] >= 4 else sorted_logits[:, 0]
    return (-(_take(logits, y) - _take(logits, y_target))
            / (z1 - 0.5 * z3 - 0.5 * z4 + 1e-12))


def apgd_start(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """APGD's start draw: U[-1, 1) of x's shape."""
    u = mesh.draw_rows(lambda s: torch.rand(s, generator=generator, device=x.device,
                                            dtype=x.dtype), x.shape)
    return u * 2.0 - 1.0


@torch.no_grad()
def apgd(forward_fn: ForwardFn, x: torch.Tensor, y: torch.Tensor,
         cfg: APGDConfig, y_target: Optional[torch.Tensor] = None,
         loss: str = "ce", return_info: bool = False,
         generator: Optional[torch.Generator] = None,
         draw: DrawFn = no_draws):
    """APGD maximising CE or untargeted DLR (loss='ce'|'dlr'), or targeted
    DLR when y_target is given. Returns x_adv (and with `return_info` the
    step sizes, best losses, found mask and max-loss iterate).

    As the official attack_single_run: the first step has momentum weight
    1; a checkpoint at position 1 (num_steps <= 9) is applied between the
    first step and the loop; the halving counter counts successive loss
    increases, seeded with f1 > 0 (the official first window compares
    against a zero row); `halved_last` starts all-True, so the
    no-improvement condition is dead at the first checkpoint; a halving
    restarts the iterate at the max-loss point but keeps `x_prev`. The
    result is the latest misclassified iterate, else the max-loss one."""
    eps = cfg.epsilon
    x = x.detach()
    y = y.long()
    y_target = None if y_target is None else y_target.long()
    lo, hi = x - eps, x + eps

    all_ckpts = _apgd_checkpoints(cfg.num_steps)
    is_ckpt = [False] * (cfg.num_steps + 1)
    interval = [0] * (cfg.num_steps + 1)
    last = 1 if 1 in all_ckpts else 0
    for c in all_ckpts:
        if c > 1:
            is_ckpt[c] = True
            interval[c] = c - last
            last = c

    def losses(xa, draws):
        logits = forward_fn(xa, draws)
        if y_target is not None:
            per = _dlr_targeted(logits, y, y_target)
        elif loss == "dlr":
            per = _dlr_untargeted(logits, y)
        else:
            per = _ce_loss(logits, y)
        return per, logits

    def grad(xa):
        draws = draw(xa)
        return _input_grad(lambda v: losses(v, draws)[0], xa)

    def project(z):
        return torch.clamp(torch.minimum(torch.maximum(z, lo), hi), 0.0, 1.0)

    x0 = torch.clamp(x + eps * apgd_start(x, generator), 0.0, 1.0)
    f0, logits0 = losses(x0, draw(x0))
    found = logits0.argmax(dim=-1) != y
    x_adv_found = torch.where(_per_sample(found, x), x0, x)

    alpha = torch.full((x.shape[0],), 2.0 * eps, device=x.device, dtype=x.dtype)
    x1 = project(x0 + _per_sample(alpha, x) * torch.sign(grad(x0)))
    f1, logits1 = losses(x1, draw(x1))
    mis1 = logits1.argmax(dim=-1) != y
    x_adv_found = torch.where(_per_sample(mis1, x), x1, x_adv_found)
    found = found | mis1

    x_best = torch.where(_per_sample(f1 > f0, x), x1, x0)
    f_best = torch.maximum(f0, f1)
    n_incr = (f1 > 0).int()
    halved_last = torch.ones_like(found)
    f_best_last = f_best
    if 1 in all_ckpts:
        halve = n_incr.float() <= cfg.rho * 1.0
        alpha = torch.where(halve, alpha / 2.0, alpha)
        x1 = torch.where(_per_sample(halve, x), x_best, x1)
        n_incr = torch.zeros_like(n_incr)
        halved_last = halve

    x_prev, x_cur, f_prev = x0, x1, f1
    for step in range(1, cfg.num_steps):
        z = project(x_cur + _per_sample(alpha, x) * torch.sign(grad(x_cur)))
        xn = project(x_cur + cfg.momentum * (z - x_cur)
                     + (1 - cfg.momentum) * (x_cur - x_prev))
        f, logits = losses(xn, draw(xn))
        mis = logits.argmax(dim=-1) != y
        x_adv_found = torch.where(_per_sample(mis, x), xn, x_adv_found)
        found = found | mis
        n_incr = n_incr + (f > f_prev).int()
        x_best = torch.where(_per_sample(f > f_best, x), xn, x_best)
        f_best = torch.maximum(f, f_best)
        x_prev, x_cur, f_prev = x_cur, xn, f
        if is_ckpt[step + 1]:
            halve = ((n_incr.float() <= cfg.rho * interval[step + 1])
                     | (~halved_last & (f_best_last >= f_best)))
            alpha = torch.where(halve, alpha / 2.0, alpha)
            x_cur = torch.where(_per_sample(halve, x), x_best, x_cur)
            n_incr = torch.zeros_like(n_incr)
            f_best_last, halved_last = f_best, halve

    out = torch.where(_per_sample(found, x), x_adv_found, x_best)
    if return_info:
        return out, {"alpha": alpha, "f_best": f_best, "found": found,
                     "x_best": x_best}
    return out


# --------------------------------------------------------------------------
# FAB-T
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FABConfig:
    epsilon: float
    num_steps: int = 100
    alpha_max: float = 0.1
    eta: float = 1.05          # overshoot
    beta: float = 0.9          # backward step
    proj_iters: int = 40       # bisection passes of the L-inf projection


def _proj_linf_box(p: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """min ||z - p||_inf  s.t.  w.z = c,  0 <= z <= 1, per sample (p, w:
    (B, D); c: (B,)). Bisection over the radius r (the extremal value of
    w.z over the box of radius r is monotone in r), then the clipped
    signed step scaled by theta so that w.z = c; where the hyperplane
    misses the unit box, the box-extremal point."""
    v = torch.sum(w * p, dim=1) - c
    sgn = 1.0 - 2.0 * (v < 0).to(p.dtype)        # now w_eff.p - c_eff >= 0
    w_eff = w * sgn[:, None]
    c_eff = c * sgn
    pos = w_eff > 0

    def extremal_point(r):
        lo = torch.clamp(p - r[:, None], min=0.0)
        hi = torch.clamp(p + r[:, None], max=1.0)
        return torch.where(pos, lo, hi)           # minimises w_eff.z

    def reaches(r):
        return torch.sum(w_eff * extremal_point(r), dim=1) <= c_eff

    lo_r = torch.zeros_like(c_eff)
    hi_r = torch.ones_like(c_eff)
    feasible_at_1 = reaches(hi_r)
    for _ in range(iters):
        mid = 0.5 * (lo_r + hi_r)
        ok = reaches(mid)
        lo_r, hi_r = torch.where(ok, lo_r, mid), torch.where(ok, mid, hi_r)
    z = extremal_point(hi_r)
    num = torch.sum(w_eff * p, dim=1) - c_eff
    den = torch.sum(w_eff * (p - z), dim=1)
    theta = torch.clamp(num / torch.where(den.abs() < 1e-12, 1e-12, den), 0.0, 1.0)
    z_exact = p + theta[:, None] * (z - p)
    return torch.where(feasible_at_1[:, None], z_exact, z)


@torch.no_grad()
def fab_targeted(forward_fn: ForwardFn, x: torch.Tensor, y: torch.Tensor,
                 y_target: torch.Tensor, cfg: FABConfig,
                 draw: DrawFn = no_draws) -> torch.Tensor:
    """FAB-T toward y_target (the official attack_single_run_targeted):
    the decision function z_y - z_target linearised at the iterate, both
    projections (from the iterate and from x), the blend a1 / (a1 + a2)
    with the 1e-8 floor on both radii capped at alpha_max, the eta
    overshoot, misclassification as success, the best point by strict
    L-inf distance, and the beta backward step at misclassified iterates.
    Returns the best adversarial point within epsilon, else x. A step's
    two decision forwards (at the iterate, and at the new point) share one
    draw, as they share one key in JAX; its gradient draws its own."""
    b = x.shape[0]
    x = x.detach()
    y, y_target = y.long(), y_target.long()
    xf = x.reshape(b, -1)

    def decision(xa, draws):
        logits = forward_fn(xa, draws)
        return _take(logits, y) - _take(logits, y_target), logits

    x_cur, x_best = x, x
    d_best = torch.full((b,), math.inf, device=x.device, dtype=x.dtype)
    for _ in range(cfg.num_steps):
        draws_f = draw(x_cur)
        f, _ = decision(x_cur, draws_f)
        draws_g = draw(x_cur)
        gf = _input_grad(lambda v: decision(v, draws_g)[0], x_cur).reshape(b, -1)
        xc = x_cur.reshape(b, -1)
        c = torch.sum(gf * xc, dim=1) - f        # the plane g.z = g.x_cur - f
        z_cur = _proj_linf_box(xc, gf, c, cfg.proj_iters)
        z_orig = _proj_linf_box(xf, gf, c, cfg.proj_iters)
        d_cur = torch.clamp(torch.amax(torch.abs(z_cur - xc), dim=1), min=1e-8)
        d_orig = torch.clamp(torch.amax(torch.abs(z_orig - xf), dim=1), min=1e-8)
        alpha = torch.clamp(d_cur / (d_cur + d_orig), 0.0, cfg.alpha_max)
        step_cur = xc + cfg.eta * (z_cur - xc)
        step_orig = xf + cfg.eta * (z_orig - xf)
        xn = (1.0 - alpha)[:, None] * step_cur + alpha[:, None] * step_orig
        xn = torch.clamp(xn.reshape(x.shape), 0.0, 1.0)

        _, logits_new = decision(xn, draws_f)
        adv = logits_new.argmax(dim=-1) != y
        dist = torch.amax(torch.abs(xn - x).reshape(b, -1), dim=1)
        better = adv & (dist < d_best)
        x_best = torch.where(_per_sample(better, x), xn, x_best)
        d_best = torch.where(better, dist, d_best)
        x_cur = torch.where(_per_sample(adv, x),
                            torch.clamp((1.0 - cfg.beta) * x + cfg.beta * xn, 0.0, 1.0),
                            xn)
    return torch.where(_per_sample(d_best <= cfg.epsilon, x), x_best, x)


# --------------------------------------------------------------------------
# Square attack
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SquareConfig:
    epsilon: float
    n_queries: int = 1000
    p_init: float = 0.8
    num_classes: int = 10


def _margin_loss(logits, y):
    """z_y - max_{i != y} z_i: negative == misclassified."""
    one_hot = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
    zy = torch.sum(one_hot * logits, dim=-1)
    zother = torch.amax(logits - 1e9 * one_hot, dim=-1)
    return zy - zother


def _square_p(it: int, n_queries: int, p_init: float) -> float:
    it = int(it / n_queries * 10000)
    sched = [(10, 1), (50, 2), (200, 4), (500, 8), (1000, 16), (2000, 32),
             (4000, 64), (6000, 128), (8000, 256), (10001, 512)]
    for bound, div in sched:
        if it <= bound:
            return p_init / div if div > 1 else p_init
    return p_init / 512


def square_sizes(n_queries: int, p_init: float, h: int, w: int,
                 c: int) -> list[int]:
    """The side of each loop query's square (queries 2..n_queries), from
    the size schedule with Python's round in the JAX expression's float
    order, at most h - 1 and w - 1."""
    n_feat = c * h * w
    return [min(max(int(round(math.sqrt(_square_p(it, n_queries, p_init)
                                        * n_feat / c))), 1), h - 1, w - 1)
            for it in range(max(n_queries - 1, 0))]


def square_stripes(shape, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """The init's vertical stripes: one sign per (sample, column, channel),
    (B, 1, W, C)."""
    b, _, w, c = shape
    u = mesh.draw_rows(lambda s: torch.rand(s, generator=generator, device=device),
                       (b, 1, w, c))
    return torch.sign(u * 2 - 1)


def square_query_draws(h: int, w: int, c: int, s: int,
                       generator: Optional[torch.Generator], device):
    """One query's draws, shared across the batch: the square's corner
    (vh, vw), uniform in [0, h - s) and [0, w - s) as 0-dim tensors on the
    device (no host sync), and one sign per channel, (1, 1, 1, C)."""
    vh = torch.randint(0, h - s, (), generator=generator, device=device)
    vw = torch.randint(0, w - s, (), generator=generator, device=device)
    u = torch.rand((1, 1, 1, c), generator=generator, device=device)
    return vh, vw, torch.sign(u * 2 - 1)


@torch.no_grad()
def square_attack(forward_fn: ForwardFn, x: torch.Tensor, y: torch.Tensor,
                  cfg: SquareConfig, generator: Optional[torch.Generator] = None,
                  draw: DrawFn = no_draws) -> torch.Tensor:
    """L-inf Square attack (the official AutoAttack square.py): the stripe
    init is query 1 (n_queries == 1 runs only the init); each of the other
    n_queries - 1 queries moves one square, at one position and with one
    sign per channel shared by the batch, from the best point, projects on
    the eps-ball and [0, 1], and is accepted per sample on a strict
    margin-loss decrease, only for samples still classified right (the
    official idx_to_fool). As in JAX, the first draw of a square is taken
    (the official resamples one that changes no element)."""
    b, h, w, c = x.shape
    eps = cfg.epsilon
    x = x.detach()
    y = y.long()
    x_best = torch.clamp(x + eps * square_stripes(x.shape, generator, x.device), 0.0, 1.0)
    loss_best = _margin_loss(forward_fn(x_best, draw(x_best)), y)
    lo, hi = x - eps, x + eps
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    for s in square_sizes(cfg.n_queries, cfg.p_init, h, w, c):
        vh, vw, sgn = square_query_draws(h, w, c, s, generator, x.device)
        rmask = (rows >= vh) & (rows < vh + s)
        cmask = (cols >= vw) & (cols < vw + s)
        mask = (rmask[:, None] & cmask[None, :]).to(x.dtype)[None, :, :, None]
        cand = x_best + 2.0 * eps * sgn * mask
        cand = torch.clamp(torch.minimum(torch.maximum(cand, lo), hi), 0.0, 1.0)
        loss_cand = _margin_loss(forward_fn(cand, draw(cand)), y)
        accept = (loss_cand < loss_best) & (loss_best > 0.0)
        x_best = torch.where(_per_sample(accept, x), cand, x_best)
        loss_best = torch.where(accept, loss_cand, loss_best)
    return x_best


# --------------------------------------------------------------------------
# Suite
# --------------------------------------------------------------------------

STANDARD_ATTACKS = ("apgd-ce", "apgd-t", "fab-t", "square")


def build_autoattack(forward_fn: ForwardFn, *, epsilon: float,
                     num_classes: int, apgd_steps: int = 100,
                     fab_steps: int = 100, square_queries: int = 1000,
                     n_target_classes: int = 9,
                     attacks_to_run=STANDARD_ATTACKS,
                     draw: DrawFn = no_draws) -> Callable:
    """Returns suite(x, y, generator=None) -> x_adv. Each attack in
    `attacks_to_run` runs from x in the standard order (APGD-CE, the
    individual-mode APGD-DLR, APGD-T, FAB-T, Square; unknown names are
    ignored); a candidate replaces x_adv only where it newly breaks a
    sample that every earlier attack left correct. APGD-T and FAB-T run
    once per target: the 2nd to (n_tc + 1)-th highest clean logit, with
    n_tc = max(1, min(n_target_classes, num_classes - 1)) (9 is the
    official standard suite's)."""
    n_tc = max(1, min(n_target_classes, num_classes - 1))
    apgd_cfg = APGDConfig(epsilon, apgd_steps, num_classes)
    fab_cfg = FABConfig(epsilon, fab_steps)
    sq_cfg = SquareConfig(epsilon, square_queries, num_classes=num_classes)

    @torch.no_grad()
    def logits(xa):
        return forward_fn(xa, draw(xa))

    def suite(x: torch.Tensor, y: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, y = x.detach(), y.long()
        x_adv = x
        still_ok = logits(x).argmax(dim=-1) == y

        def merge(cand):
            nonlocal x_adv, still_ok
            newly_broken = (logits(cand).argmax(dim=-1) != y) & still_ok
            x_adv = torch.where(_per_sample(newly_broken, x), cand, x_adv)
            still_ok = still_ok & ~newly_broken

        if "apgd-ce" in attacks_to_run:
            merge(apgd(forward_fn, x, y, apgd_cfg, generator=generator, draw=draw))
        if "apgd-dlr" in attacks_to_run:
            merge(apgd(forward_fn, x, y, apgd_cfg, loss="dlr",
                       generator=generator, draw=draw))
        if "apgd-t" in attacks_to_run or "fab-t" in attacks_to_run:
            # stable ascending, as jnp.argsort: ties keep the lower class first
            order = torch.argsort(logits(x), dim=-1, stable=True)
        if "apgd-t" in attacks_to_run:
            for t in range(2, 2 + n_tc):
                merge(apgd(forward_fn, x, y, apgd_cfg, y_target=order[:, -t],
                           generator=generator, draw=draw))
        if "fab-t" in attacks_to_run:
            for t in range(2, 2 + n_tc):
                merge(fab_targeted(forward_fn, x, y, order[:, -t], fab_cfg, draw=draw))
        if "square" in attacks_to_run:
            merge(square_attack(forward_fn, x, y, sq_cfg, generator, draw=draw))
        return x_adv

    return suite


def run_autoattack(forward_fn: ForwardFn, x: torch.Tensor, y: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   epsilon: float, num_classes: int, apgd_steps: int = 100,
                   square_queries: int = 1000, n_target_classes: int = 9,
                   attacks_to_run=STANDARD_ATTACKS,
                   draw: DrawFn = no_draws) -> torch.Tensor:
    """One suite run (see build_autoattack). Returns x_adv; robust accuracy
    = acc(forward(x_adv), y)."""
    suite = build_autoattack(
        forward_fn, epsilon=epsilon, num_classes=num_classes,
        apgd_steps=apgd_steps, square_queries=square_queries,
        n_target_classes=n_target_classes, attacks_to_run=attacks_to_run,
        draw=draw)
    return suite(x, y, generator)
