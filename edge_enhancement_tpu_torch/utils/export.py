"""Serving export: the eval forward as one torch.export artifact, as
edge_enhancement_tpu/utils/export.py does with jax.export.

The whole eval forward (the EE front-end and the backbone, BatchNorm on its
running statistics, the weights saved in the artifact) is exported with
`torch.export` into one `.pt2` file that a process loads and runs without
the model zoo, the config system or the checkpoint format.

What differs from the JAX artifact:
- An exported torch graph holds no seeded generator, so the square
  front-end's draws are inputs of the exported program:
  `program(x, stripes (B, 1, W, C), square_mask (H, W), channel_sign
  (1, 1, 1, C))` (ops/square.py's layout; with n_queries > 1 the masks and
  signs stacked on a leading query axis); a model without a square takes x
  only. `load_serving_artifact` wraps it as JAX's `(x, seed) -> logits`,
  the draws made from `torch.Generator().manual_seed(seed)` by
  ops/square.add_square_draws.
- The fused front-end's kernel K1 is the operator ee_tpu_torch::ee_fused_fwd
  (ops/cuda/ee_fused.py), one node of the graph: loading needs torch and an
  import of edge_enhancement_tpu_torch.ops.cuda.ee_fused, which registers
  it (load_serving_artifact imports it); JAX's artifact needs jax alone.
  On a CUDA input the node launches K1, on a CPU input its plain version.
- The artifact runs on the device it was exported on.

The batch dimension is exported as `torch.export.Dim("b")` (up to
MAX_BATCH) unless `batch` pins it, so one artifact serves any batch size.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

import torch

META = "serving.json"
# the largest batch a symbolic artifact takes: CUDA operators of the
# forward guard the batch to 65535 when they are traced
MAX_BATCH = 65535


class _EvalForward(torch.nn.Module):
    """The model's eval forward with the square draws as arguments."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x, stripes=None, square_mask=None, channel_sign=None):
        draws = None if stripes is None else (stripes, square_mask, channel_sign)
        return self.model(x, square_draws=draws)


def _square(model) -> tuple[bool, int]:
    ee = getattr(model, "ee", None)
    if ee is None or not ee.square:
        return False, 0
    return True, int(ee.n_queries)


def _draws(shape, seed: int, n_queries: int, device) -> tuple:
    """The square draws of one call, from a CPU generator seeded `seed`, on
    `device`."""
    from ..ops.square import add_square_draws
    gen = torch.Generator().manual_seed(int(seed))
    return tuple(t.to(device) for t in
                 add_square_draws(shape, gen, n_queries=n_queries))


def make_serving_fn(ops) -> Callable:
    """The live eval forward, (x, seed) -> logits, the draws made as the
    artifact makes them."""
    square, n_queries = _square(ops.model)

    @torch.no_grad()
    def serve(x, seed):
        draws = _draws(x.shape, seed, n_queries, x.device) if square else None
        return ops.logits_eval(x, draws)

    return serve


def export_serving(ops, image_size: int, channels: int,
                   batch: Optional[int] = None,
                   device=None) -> torch.export.ExportedProgram:
    """Export the eval forward on `device` (the model's by default).
    `batch=None` exports a symbolic batch dimension; an int pins it."""
    model = ops.model.eval()
    if device is None:
        device = next(model.parameters()).device
    square, n_queries = _square(model)
    n = batch or 2
    shape = (n, image_size, image_size, channels)
    x = torch.zeros(shape, device=device)
    args = (x, *(_draws(shape, 0, n_queries, device) if square else ()))
    dynamic = None
    if batch is None:
        # the bound of a CUDA operator's shape checks (a grid dimension)
        b = torch.export.Dim("b", max=MAX_BATCH)
        dynamic = ({0: b}, {0: b}, None, None)[:len(args)]
    with torch.no_grad():
        return torch.export.export(_EvalForward(model), args, dynamic_shapes=dynamic)


def save_serving_artifact(path: str, ops, image_size: int, channels: int,
                          batch: Optional[int] = None, device=None) -> None:
    ep = export_serving(ops, image_size, channels, batch=batch, device=device)
    square, n_queries = _square(ops.model)
    meta = dict(square=square, n_queries=n_queries)
    torch.export.save(ep, path, extra_files={META: json.dumps(meta)})


class ServingArtifact:
    """A loaded artifact: called as (x, seed) -> logits (x NHWC float32 in
    [0, 1], on the device it was exported on); `program(x, *draws)` is the
    exported program with the square draws given; `exported` the
    ExportedProgram; `meta` whether the model has a square, and its number
    of queries (how __call__ draws)."""

    def __init__(self, exported: torch.export.ExportedProgram, meta: dict):
        self.exported, self.meta = exported, meta
        self.program = exported.module()

    def __call__(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        draws = (_draws(x.shape, seed, self.meta["n_queries"], x.device)
                 if self.meta["square"] else ())
        with torch.no_grad():
            return self.program(x, *draws)


def load_serving_artifact(path: str) -> ServingArtifact:
    """Load an artifact into a callable (x, seed) -> logits. Needs torch
    and the port's ee_tpu_torch::ee_fused_fwd operator, registered here."""
    from ..ops.cuda import ee_fused  # noqa: F401  (registers the operator)
    extra = {META: ""}
    ep = torch.export.load(path, extra_files=extra)
    return ServingArtifact(ep, json.loads(extra[META]))

