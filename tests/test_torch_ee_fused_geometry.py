"""The block geometry of the row-band kernels K1/K2 (ops/cuda/ee_fused.py:
band_geometry, band_operators) at every image size a shipped config gives
the fused front-end: a block's shared memory fits a Hopper block and the
bands tile every image row exactly once. The kernels themselves run only on
a card (tests/test_torch_cuda.py); this pins on any host that each shipped
step125 config is inside their envelope."""

import glob
import os
import re

import numpy as np
import pytest
import yaml

from edge_enhancement_tpu_torch.ops.cuda import ee_fused as F
from edge_enhancement_tpu_torch.ops.hfs import _hfs_axis_operators

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "edge_enhancement_tpu", "configs")
SOURCE = os.path.join(os.path.dirname(__file__), "..", "edge_enhancement_tpu_torch", "csrc",
                      "ee_fused.cu")


def _step125_configs():
    """(config path relative to configs/, C, cize) of every shipped config
    whose front-end is the fused step125 Canny."""
    out = []
    for path in sorted(glob.glob(os.path.join(CONFIGS, "*", "*.yml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        if cfg.get("type_canny") != "CannyFilter_step125_1":
            continue
        channels = 1 if cfg.get("dataset") == "mnist" else 3
        out.append((os.path.relpath(path, CONFIGS), channels, int(cfg["cize"])))
    return out


STEP125 = _step125_configs()


def test_the_shipped_sizes_are_all_there():
    """28 px MNIST, 64 px Tiny-ImageNet, 128 / 224 / 288 px ImageNet."""
    assert len(STEP125) == 16
    assert {(c, n) for _, c, n in STEP125} == {(1, 28), (3, 64), (3, 128), (3, 224),
                                               (3, 288)}


@pytest.mark.parametrize("name,channels,cize", STEP125, ids=[n for n, _, _ in STEP125])
@pytest.mark.parametrize("backward", [False, True], ids=["K1", "K2"])
def test_band_geometry_fits_and_tiles_every_row(name, channels, cize, backward):
    geo = F.band_geometry(channels, cize, cize, backward)
    assert 0 < geo.smem_bytes <= F.MAX_SMEM_BYTES
    rows = np.zeros(cize, int)
    for band in range(geo.bands):
        rows[band * F.BAND_ROWS:(band + 1) * F.BAND_ROWS] += 1
    assert (rows == 1).all()
    assert (geo.bands - 1) * F.BAND_ROWS < cize <= geo.bands * F.BAND_ROWS
    # the kernel reads whole chunks and panels of the padded operators
    lh, lk = geo.l_shape
    rk, rw = geo.r_shape
    assert lh == geo.bands * F.BAND_ROWS and lk % F.CHUNK == 0 and lk >= cize
    assert rk % F.CHUNK == 0 and rk >= cize and rw % F.PANEL == 0 and rw >= cize


@pytest.mark.parametrize("backward", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("h,w", [(30, 30), (28, 28), (24, 40), (64, 64)])
def test_band_operators_are_the_hfs_operators_zero_padded(h, w, backward):
    """K1 gets (Ar, Ai, Br^T, Bi^T), K2 (Ar^T, Ai^T, Br, Bi), zeros outside."""
    ar, ai, br, bi = _hfs_axis_operators(h, w, 8)
    want = (ar.T, ai.T, br, bi) if backward else (ar, ai, br.T, bi.T)
    geo = F.band_geometry(3, h, w, backward)
    got = F.band_operators(h, w, 8, backward, "cpu")
    for g, m, shape in zip(got, want, (geo.l_shape,) * 2 + (geo.r_shape,) * 2):
        g = g.numpy()
        assert g.shape == shape and g.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(g[:m.shape[0], :m.shape[1]], m)
        g[:m.shape[0], :m.shape[1]] = 0
        assert not g.any()


@pytest.mark.parametrize("cize,fits", [(64, 14), (288, 6)])
def test_the_envelope_in_channels(cize, fits):
    """The halo tile grows with C: the largest C that fits a block, which
    the wrapper checks before any launch."""
    for backward in (False, True):
        assert F.band_geometry(fits, cize, cize, backward).smem_bytes <= F.MAX_SMEM_BYTES
    assert F.band_geometry(fits + 1, cize, cize, True).smem_bytes > F.MAX_SMEM_BYTES


def test_the_envelope_in_width():
    """T and the band's planes grow with W: RGB fits up to 384 px."""
    assert F.band_geometry(3, 384, 384, True).smem_bytes <= F.MAX_SMEM_BYTES
    assert F.band_geometry(3, 385, 385, True).smem_bytes > F.MAX_SMEM_BYTES


def test_the_constants_are_the_kernel_sources():
    """The wrapper lays a block out with the constants that the kernels are
    compiled with."""
    with open(SOURCE) as f:
        src = f.read()
    found = {name: int(v) for name, v in
             re.findall(r"constexpr int (kBandRows|kBandThreads|kChunk|kStripW) = (\d+);", src)}
    assert found == {"kBandRows": F.BAND_ROWS, "kBandThreads": F.BAND_THREADS,
                     "kChunk": F.CHUNK, "kStripW": F.STRIP_W}


@pytest.mark.parametrize("backward", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("c,h,w", [(3, 30, 30), (1, 28, 28), (3, 24, 40), (3, 72, 72),
                                   (3, 100, 100), (3, 224, 224), (3, 288, 288),
                                   (14, 64, 64)])
def test_band_layout_is_aligned_and_disjoint(c, h, w, backward):
    """The band's Canny plane, T and the shared region follow one another
    without overlap, each starting on 16 bytes (float4 stores, 16-byte
    cp.async); T's row stride puts a warp's 4 rows on distinct banks."""
    geo = F.band_geometry(c, h, w, backward)
    assert geo.wq >= w and geo.wq % 4 == 0
    assert geo.wt >= w and geo.wt % F.PANEL == 0
    assert geo.ld_t >= geo.wt and geo.ld_t % 64 == 4
    assert geo.t >= F.BAND_ROWS * geo.wq and geo.t % 4 == 0
    assert geo.s >= geo.t + 2 * F.BAND_ROWS * geo.ld_t and geo.s % 4 == 0
    assert geo.smem_bytes > 4 * geo.s
    assert len(geo.layout) == 7
