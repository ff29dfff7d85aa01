"""The port's analysis tools (edge_enhancement_tpu_torch/utils/analysis.py)
against the JAX package's utils/analysis.py: the log scraper on the port
driver's own log.txt and on a log in the JAX format, the frequency split,
the HFS image and edge map of one image, and the loss landscape on the
same weights and directions."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_port_helpers as helpers
from torch_checkpoints import drop_written_checkpoints  # noqa: F401
from edge_enhancement_tpu.train.modelops import cross_entropy as jax_cross_entropy
from edge_enhancement_tpu.utils import analysis as janalysis
from edge_enhancement_tpu.utils import meters as jmeters
from edge_enhancement_tpu_torch.convert import arch_state_dict_from_jax
from edge_enhancement_tpu_torch.train.modelops import ModelOps
from edge_enhancement_tpu_torch.utils import analysis as tanalysis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "edge_enhancement_tpu", "configs", "tiny_imagenet",
                      "ee_at_bpda3_square.yml")


def test_parse_train_log_reads_the_port_log_and_the_jax_format(tmp_path):
    from edge_enhancement_tpu_torch.train.driver import run
    from edge_enhancement_tpu_torch.utils.config import load_config
    summary = run(load_config(CONFIG, dict(
        data="synthetic", synthetic_size=8, batch_size=4, epochs=2, limit_batches=2,
        num_steps_1=1, print_freq=1, device="cpu", output=str(tmp_path))))
    log = os.path.join(summary["out_dir"], "log", "log.txt")
    got = tanalysis.parse_train_log(log)
    assert list(got["epochs"]) == [0, 0, 1, 1] and list(got["iters"]) == [0, 1, 0, 1]
    assert len(got["clean_top1"]) == len(got["adv_top1"]) == 2
    assert np.isfinite(got["loss_avg"]).all()
    want = janalysis.parse_train_log(log)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # a log in the JAX package's format, from its own meters
    meters = [jmeters.AverageMeter() for _ in range(5)]
    lines = []
    for epoch in range(3):
        for i, v in enumerate((2.5, 1.25)):
            for m in meters:
                m.update(v + epoch, 4)
            lines.append(jmeters.train_line(epoch, i, 2, *meters))
        lines += [jmeters.clean_summary(meters[3], meters[4]),
                  jmeters.adv_summary(meters[2], meters[3])]
    path = tmp_path / "jax_log.txt"
    path.write_text("\n".join(lines) + "\n")
    got, want = tanalysis.parse_train_log(str(path)), janalysis.parse_train_log(str(path))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["epochs"]) == 6 and len(got["adv_top1"]) == 3


@pytest.mark.parametrize("r", [4, 8])
def test_frequency_split_matches_jax(r):
    img = np.random.default_rng(r).random((32, 24, 3))
    (lo, hi), (jlo, jhi) = tanalysis.frequency_split(img, r), janalysis.frequency_split(img, r)
    np.testing.assert_allclose(lo, jlo, atol=1e-6)
    np.testing.assert_allclose(hi, jhi, atol=1e-6)
    np.testing.assert_allclose(lo + hi, img, atol=1e-12)


@pytest.mark.parametrize("variant", ["CannyFilter", "CannyFilter_BPDA"])
def test_edge_visualization_matches_jax(variant):
    rng = np.random.default_rng(3)
    img = rng.random((32, 32, 3)).astype(np.float32)
    img[8:20, 8:20] = 0.9                         # a square: an edge ring
    got = tanalysis.edge_visualization(img, variant=variant, low=0.1, high=0.3)
    want = janalysis.edge_visualization(img, variant=variant, low=0.1, high=0.3)
    assert got["edges"].shape == want["edges"].shape == (32, 32, 1)
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert got["edges"].sum() > 0
    np.testing.assert_allclose(got["hfs"], want["hfs"], atol=1e-5)


def _direction_pair(params, rng):
    """Two direction trees of the JAX parameters' shapes, 0.05 N(0, 1)."""
    return [jax.tree.map(lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32),
                         params) for _ in range(2)]


def test_loss_landscape_matches_jax_at_the_same_directions():
    """A 3 x 3 grid on Net2 (MNIST) with the same two directions on both
    sides: the port's loss_landscape against the JAX model's mean
    cross-entropy at p + a d1 + b d2, to 1e-5."""
    shape = (6, 28, 28, 1)
    ops_j, params, bs, model = helpers.jax_and_port_models(shape, arch="Net2", ee_args={},
                                                           num_classes=10)
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int32)
    trees = _direction_pair(params, rng)
    names = [n for n, _ in model.named_parameters()]
    dirs = tuple([arch_state_dict_from_jax("Net2", helpers.to_numpy_tree(t), {})[n]
                  for n in names] for t in trees)
    before = [p.clone() for p in model.parameters()]
    got = tanalysis.loss_landscape(ModelOps(model), torch.from_numpy(x),
                                   torch.from_numpy(y).long(), span=0.5, resolution=3,
                                   directions=dirs)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))

    @jax.jit
    def loss_at(a, b):
        p = jax.tree.map(lambda w, u, v: w + a * u + b * v, params, *trees)
        return jax_cross_entropy(ops_j.logits_eval(p, bs, jnp.asarray(x),
                                                   jax.random.PRNGKey(1)),
                                 jnp.asarray(y), "mean")

    want = np.array([[float(loss_at(jnp.float32(a), jnp.float32(b)))
                      for b in got["betas"]] for a in got["alphas"]])
    np.testing.assert_array_equal(got["alphas"], [-0.5, 0.0, 0.5])
    np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    assert got["loss"].std() > 0


def test_filter_normalised_directions_and_plots(monkeypatch, tmp_path):
    """The default directions: from the seed's generator, each tensor's
    norm its parameter's; the plots return None without matplotlib."""
    params = [torch.randn(3, 4), torch.randn(5)]
    a = tanalysis.filter_normalised_direction(params, torch.Generator().manual_seed(2))
    b = tanalysis.filter_normalised_direction(params, torch.Generator().manual_seed(2))
    for p, d, e in zip(params, a, b):
        assert torch.equal(d, e) and d.shape == p.shape
        torch.testing.assert_close(torch.linalg.vector_norm(d), torch.linalg.vector_norm(p))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    grid = {"alphas": np.zeros(2), "betas": np.zeros(2), "loss": np.zeros((2, 2))}
    assert tanalysis.plot_loss_landscape(grid, str(tmp_path / "l.png")) is None
    assert tanalysis.plot_training_curves({}, str(tmp_path / "c.png")) is None
