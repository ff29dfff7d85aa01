"""The port's serving export (edge_enhancement_tpu_torch/utils/export.py,
tools/export_model.py) against tests/test_export.py's semantics: the
artifact of Net2_EE_square, with the JAX model's weights carried across
and JAX's square draws at key 7 replayed, gives JAX's logits_eval; it
equals the port's live eval forward exactly; one artifact serves two batch
sizes; the exported graph holds K1's operator; the CLI round trip."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as helpers
from edge_enhancement_tpu.models import ee_frontend as jee
from edge_enhancement_tpu.ops import square as jsquare
from edge_enhancement_tpu_torch.models.registry import build_model
from edge_enhancement_tpu_torch.train import checkpoint as ckpt
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.train.trainer import OptimConfig, create_train_state
from edge_enhancement_tpu_torch.utils.export import (export_serving,
                                                      load_serving_artifact,
                                                      make_serving_fn,
                                                      save_serving_artifact)
from torch_checkpoints import drop_written_checkpoints  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_export.py's model
ARGS = dict(r=8, w=1.0, gf=False, low=38.0, high=76.0, alpha=0.0, sigma=1.0,
            type_canny="CannyFilter_step125_1", epsilon=0.0627, n_queries=1,
            cize=28)
SHAPE = (4, 28, 28, 1)
OP = torch.ops.ee_tpu_torch.ee_fused_fwd.default


def _jax_logits_and_draws(monkeypatch, ops_j, params, batch_stats, x):
    """JAX's eval logits at key 7, and the draws of its square at the key it
    was given, from JAX's add_square_draws (the same key splits as
    add_square's), in the port's layout."""
    seen = []
    real = jee.add_square

    def record(xx, key, **kw):
        draws = jsquare.add_square_draws(key, xx.shape, epsilon=kw["epsilon"])
        seen.append(tuple(torch.from_numpy(np.array(t)) for t in draws))
        return real(xx, key, **kw)

    monkeypatch.setattr(jee, "add_square", record)
    logits = ops_j.logits_eval(params, batch_stats, jnp.asarray(x), jax.random.PRNGKey(7))
    assert len(seen) == 1
    return np.asarray(logits), seen[0]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    ops_j, params, batch_stats, model = helpers.jax_and_port_models(
        SHAPE, arch="Net2_EE_square", ee_args=ARGS, num_classes=10)
    path = str(tmp_path_factory.mktemp("export") / "m.pt2")
    ops = ModelOps(model)
    save_serving_artifact(path, ops, 28, 1)
    yield ops_j, params, batch_stats, ops, load_serving_artifact(path)
    os.remove(path)


def test_roundtrip_matches_jax_logits_eval(exported, monkeypatch):
    ops_j, params, batch_stats, ops, art = exported
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    for n in (4, 2):   # the symbolic batch: one artifact, two batch sizes
        want, draws = _jax_logits_and_draws(monkeypatch, ops_j, params, batch_stats, x[:n])
        with torch.no_grad():
            got = art.program(torch.from_numpy(x[:n]), *draws)
        assert got.shape == (n, 10)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        # the live eval forward on the same draws: the same operations
        live = ops.logits_eval(torch.from_numpy(x[:n]), draws)
        assert torch.equal(got, live)


def test_seeded_call_equals_the_live_serving_fn(exported):
    *_, ops, art = exported
    x = torch.from_numpy(np.random.default_rng(1).random((3, 28, 28, 1)).astype(np.float32))
    serve = make_serving_fn(ops)
    for seed in (0, 7):
        assert torch.equal(art(x, seed), serve(x, seed))
    assert not torch.equal(art(x, 0), art(x, 7))
    assert art.meta == dict(square=True, n_queries=1)


def test_graph_holds_the_k1_operator(exported):
    """K1 is one node of the exported graph (the plain front-end is not
    traced in its place), called once a forward."""
    *_, art = exported
    nodes = [n for n in art.exported.graph.nodes if n.op == "call_function"]
    assert sum(n.target is OP for n in nodes) == 1
    assert not any("canny" in str(n.target) or "hfs" in str(n.target) for n in nodes)


def test_pinned_batch_refuses_another(exported):
    *_, ops, _ = exported
    ep = export_serving(ops, 28, 1, batch=4)
    x = torch.rand(SHAPE)
    draws = [torch.ones(4, 1, 28, 1), torch.zeros(28, 28), torch.ones(1, 1, 1, 1)]
    m = ep.module()
    assert m(x, *draws).shape == (4, 10)
    with pytest.raises(Exception):
        m(x[:2], draws[0][:2], *draws[1:])


def test_model_without_square_takes_x_only(tmp_path):
    args = {k: v for k, v in ARGS.items() if k != "type_canny"}
    ops = ModelOps(build_model("Net2", args, 10, generator=torch.Generator().manual_seed(0)))
    path = str(tmp_path / "net2.pt2")
    save_serving_artifact(path, ops, 28, 1)
    art = load_serving_artifact(path)
    x = torch.rand(5, 28, 28, 1, generator=torch.Generator().manual_seed(2))
    assert torch.equal(art(x, 3), ops.logits_eval(x))
    assert torch.equal(art.program(x), ops.logits_eval(x))
    os.remove(path)


def test_export_cli_round_trip(tmp_path):
    """tools/export_model.py on the CPU from a checkpoint directory the test
    writes: the artifact equals the checkpoint's live eval forward."""
    config = os.path.join(REPO, "edge_enhancement_tpu", "configs", "mnist",
                          "ee_at_bpda3_square.yml")
    model = build_model("Net2_EE_square", dict(ARGS, epsilon=0.3, r=4, alpha=0.3,
                                               high=51.0, low=25.0), 10,
                        generator=torch.Generator().manual_seed(5))
    ckpt_dir = str(tmp_path / "run" / "ckpt")
    ckpt.save_checkpoint(ckpt_dir, create_train_state(model), 3, "Net2_EE_square",
                         best_prec1=0.0, is_best=True, opt=OptimConfig(), lr=0.1)
    out = str(tmp_path / "model.pt2")
    proc = subprocess.run(
        [sys.executable, "-m", "edge_enhancement_tpu_torch.tools.export_model",
         "--config", config, "--resume", ckpt_dir, "--out", out, "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "=> loaded checkpoint (epoch 3)" in proc.stdout
    assert "batch=symbolic" in proc.stdout
    art = load_serving_artifact(out)
    x = torch.from_numpy(np.random.default_rng(4).random((6, 28, 28, 1)).astype(np.float32))
    assert torch.equal(art(x, 11), make_serving_fn(ModelOps(model))(x, 11))
    os.remove(out)


@pytest.mark.parametrize("square", [True, False], ids=["square", "no_square"])
def test_k1_operator_passes_opcheck(square):
    """ee_tpu_torch::ee_fused_fwd: its CPU implementation is the plain
    version, and torch.library.opcheck passes (schema, fake tensors,
    dynamic shapes under AOT dispatch)."""
    from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
    from edge_enhancement_tpu_torch.ops.square import add_square_draws, kernel_layout
    g = torch.Generator().manual_seed(0)
    x = torch.rand(3, 3, 16, 16, generator=g)
    st = sq = None
    if square:
        st, sq = kernel_layout(add_square_draws((3, 16, 16, 3), g), 0.06)
    k = F.FusedConsts(r=4, eps=0.06, w=1.0, alpha=0.0, high=0.3, sigma=1.0, square=square)
    args = (x, st, sq, *dataclasses.astuple(k))
    got = F.ee_fused_fwd_op(*args)
    want = F.ee_fused_fwd_plain(x, st, sq, k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    result = torch.library.opcheck(F.ee_fused_fwd_op, args)
    assert set(result.values()) == {"SUCCESS"}, result
