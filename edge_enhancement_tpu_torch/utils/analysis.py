"""Log scraping and the paper's analysis figures, as
edge_enhancement_tpu/utils/analysis.py: the `Epoch:` and `* Clean/Adv
Prec@` lines of a log.txt (the port's driver writes the reference's
format, as the JAX train.py does, so both packages' logs read alike), the
FFT low/high-frequency split of an image, the HFS image and edge map of
one image, and the 2-D loss landscape over two filter-normalised
directions. The plots return None where matplotlib is absent.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.canny import CANNY_VARIANTS
from ..ops.hfs import hfs_mask, high_freq_suppress
from ..train.modelops import ModelOps, cross_entropy

_EPOCH_RE = re.compile(
    r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\].*?"
    r"Loss ([\d.]+) \(([\d.]+)\).*?"
    r"Prec@1 ([\d.]+) \(([\d.]+)\).*?"
    r"Prec@5 ([\d.]+) \(([\d.]+)\)", re.S)
_CLEAN_RE = re.compile(r"\* Clean Prec@1 ([\d.]+) Prec@5 ([\d.]+)")
_ADV_RE = re.compile(r"\* Adv Prec@1 ([\d.]+) Prec@5 ([\d.]+)")


def parse_train_log(path: str) -> dict:
    """{'epochs', 'iters', 'loss_avg', 'top1_avg', 'top5_avg', 'clean_top1',
    'clean_top5', 'adv_top1', 'adv_top5'} arrays scraped from a log.txt."""
    with open(path) as f:
        text = f.read()
    rows = _EPOCH_RE.findall(text)
    clean = _CLEAN_RE.findall(text)
    adv = _ADV_RE.findall(text)
    return {
        "epochs": np.array([int(r[0]) for r in rows]),
        "iters": np.array([int(r[1]) for r in rows]),
        "loss_avg": np.array([float(r[4]) for r in rows]),
        "top1_avg": np.array([float(r[6]) for r in rows]),
        "top5_avg": np.array([float(r[8]) for r in rows]),
        "clean_top1": np.array([float(a) for a, _ in clean]),
        "clean_top5": np.array([float(b) for _, b in clean]),
        "adv_top1": np.array([float(a) for a, _ in adv]),
        "adv_top5": np.array([float(b) for _, b in adv]),
    }


def frequency_split(img_hwc: np.ndarray, r: int) -> tuple[np.ndarray, np.ndarray]:
    """An image's low- and high-frequency parts, with HFS's centred-square
    mask."""
    h, w = img_hwc.shape[:2]
    mask = hfs_mask(h, w, r)
    f = np.fft.fft2(img_hwc, axes=(0, 1))
    low = np.real(np.fft.ifft2(f * mask[..., None], axes=(0, 1)))
    return low, img_hwc - low


def edge_visualization(img_hwc: np.ndarray, *, variant: str = "CannyFilter",
                       low: float = 60 / 255, high: float = 120 / 255,
                       r: int = 8, sigma: float = 1.0,
                       alpha: float = 0.0) -> dict:
    """The HFS image and the edge map of one (H, W, C) image, the panels of
    the reference's visualisation grids."""
    x = torch.as_tensor(np.asarray(img_hwc, np.float32))[None]
    with torch.no_grad():
        edges = CANNY_VARIANTS[variant](x.permute(0, 3, 1, 2), low, high,
                                        hysteresis=True, sigma=sigma, alpha=alpha)
        return {"hfs": high_freq_suppress(x, r)[0].numpy(),
                "edges": edges.permute(0, 2, 3, 1)[0].numpy()}


def filter_normalised_direction(params: Sequence[torch.Tensor],
                                generator: torch.Generator) -> list:
    """A N(0, 1) direction of each parameter's shape, scaled to the norm of
    its parameter (tensor by tensor, as the JAX function does)."""
    out = []
    for p in params:
        d = torch.randn(p.shape, generator=generator, dtype=p.dtype).to(p.device)
        out.append(d * (torch.linalg.vector_norm(p) /
                        (torch.linalg.vector_norm(d) + 1e-10)))
    return out


@torch.no_grad()
def loss_landscape(ops: ModelOps, x: torch.Tensor, y: torch.Tensor, *,
                   span: float = 1.0, resolution: int = 11, seed: int = 0,
                   directions: Optional[tuple] = None, draws=None) -> dict:
    """The eval-mode mean cross-entropy at p + a d1 + b d2 over an a, b grid
    in [-span, span]^2: the reference's 3-D loss-landscape figure.
    `directions` (two lists in `model.parameters()` order) replace the
    filter-normalised ones drawn from a generator seeded with `seed`;
    `draws` (the square front-end's, one for every point, as the JAX
    function's one key) default to one fresh draw. The parameters are
    restored. Returns {'alphas', 'betas', 'loss'}."""
    params = list(ops.model.parameters())
    if directions is None:
        gen = torch.Generator().manual_seed(seed)
        directions = (filter_normalised_direction(params, gen),
                      filter_normalised_direction(params, gen))
    d1, d2 = directions
    if draws is None:
        draws = ops.square_draws(x)
    alphas = np.linspace(-span, span, resolution)
    betas = np.linspace(-span, span, resolution)
    w0 = [p.clone() for p in params]
    grid = np.zeros((resolution, resolution))
    try:
        for i, a in enumerate(alphas):
            for j, b in enumerate(betas):
                for p, w, u, v in zip(params, w0, d1, d2):
                    p.copy_(w + float(a) * u + float(b) * v)
                grid[i, j] = float(cross_entropy(ops.logits_eval(x, draws), y))
    finally:
        for p, w in zip(params, w0):
            p.copy_(w)
    return {"alphas": alphas, "betas": betas, "loss": grid}


def plot_loss_landscape(landscape: dict, out_path: str) -> Optional[str]:
    """The loss-landscape surface as an image; None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401
    a, b = np.meshgrid(landscape["alphas"], landscape["betas"], indexing="ij")
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(a, b, landscape["loss"], cmap="viridis", alpha=0.9)
    ax.set_xlabel("alpha")
    ax.set_ylabel("beta")
    ax.set_zlabel("loss")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    return out_path


def plot_training_curves(log_paths: dict[str, str], out_path: str,
                         metric: str = "adv_top1") -> Optional[str]:
    """A metric's curve per epoch from one or more logs; None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, path in log_paths.items():
        y = parse_train_log(path)[metric]
        ax.plot(np.arange(len(y)), y, label=label, linewidth=1.5)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    return out_path
