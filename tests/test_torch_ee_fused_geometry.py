"""The block geometry of the row-band kernels K1/K2 (ops/cuda/ee_fused.py:
band_geometry, band_operators) and of the Canny-only tile kernels K3a/K3b
(canny_geometry) at every image size a shipped config gives the fused
front-end: a block's shared memory fits a Hopper block, the bands tile every
image row and the tiles every pixel exactly once. The kernels themselves run
only on a card (tests/test_torch_cuda.py); this pins on any host that each
shipped step125 config is inside their envelope."""

import functools
import glob
import os
import re

import numpy as np
import pytest
import torch
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
    names = "kBandRows|kBandThreads|kChunk|kStripW|kCannyRows|kCannyCols"
    found = {name: int(v) for name, v in
             re.findall(rf"constexpr int ({names}) = (\d+);", src)}
    assert found == {"kBandRows": F.BAND_ROWS, "kBandThreads": F.BAND_THREADS,
                     "kChunk": F.CHUNK, "kStripW": F.STRIP_W,
                     "kCannyRows": F.CANNY_ROWS, "kCannyCols": F.CANNY_COLS}


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


# the shipped step125 sizes, then the card tests' K3 shapes: ragged tiles
# with W not a multiple of 4, one tile smaller than the halo, several tiles
# with ragged last ones, the card tests' largest C
CANNY_SHAPES = ([(c, n, n) for _, c, n in STEP125]
                + [(3, 32, 64), (3, 37, 45), (3, 2, 5), (3, 100, 100), (3, 224, 224),
                   (3, 72, 72), (F.canny_geometry(1, 20, 20).max_channels, 20, 20)])


@pytest.mark.parametrize("c,h,w", CANNY_SHAPES)
def test_canny_geometry_fits_and_tiles_every_pixel(c, h, w):
    geo = F.canny_geometry(c, h, w)
    rows, cols = F.CANNY_ROWS, F.CANNY_COLS
    assert c <= geo.max_channels
    assert 0 < geo.fwd_smem_bytes <= F.MAX_SMEM_BYTES
    assert 0 < geo.bwd_smem_bytes <= F.MAX_SMEM_BYTES
    seen = np.zeros((h, w), int)
    for i in range(geo.tiles_h):
        for j in range(geo.tiles_w):
            assert i * rows < h and j * cols < w        # no tile wholly off the image
            seen[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols] += 1
    assert (seen == 1).all()


def test_the_canny_envelope_in_channels():
    """K3a's block holds C tiles of x: the most channels that fit is what
    both wrappers refuse above, before any launch (the checks run on any
    host; the device is checked last)."""
    geo = F.canny_geometry(1, 64, 64)
    top = geo.max_channels
    assert F.canny_geometry(top, 64, 64).fwd_smem_bytes <= F.MAX_SMEM_BYTES
    assert F.canny_geometry(top + 1, 64, 64).fwd_smem_bytes > F.MAX_SMEM_BYTES
    assert F.canny_geometry(top + 1, 64, 64).bwd_smem_bytes == geo.bwd_smem_bytes
    with pytest.raises(ValueError, match="channels"):
        F._check_canny(torch.zeros(1, top + 1, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        F._check_canny(torch.zeros(1, top, 64, 64))
    plane = torch.zeros(1, 1, 64, 64)
    with pytest.raises(ValueError, match="channels"):     # K3b's dx
        F._check_canny(torch.zeros(1, top + 1, 64, 64), plane, plane, plane, plane)
    with pytest.raises(ValueError, match="CUDA"):
        F._check_canny(torch.zeros(1, top, 64, 64), plane, plane, plane, plane)


def _body(src, function):
    """The source text of the device function or kernel `function`."""
    body = src[re.search(rf"\n{function}\(|\s{function}\(", src).start():]
    return body[:body.index("\n}\n")]


def _tiles(body):
    """{name: halo} of the Tile<> types that a function's body declares."""
    return {n: int(h) for n, h in re.findall(r"using (\w) = Tile<\w+, \w+, (\d+)>;", body)}


@pytest.mark.parametrize("c,h,w", [(1, 28, 28), (3, 64, 64), (3, 37, 45), (3, 224, 224),
                                   (14, 64, 64), (3, 288, 288)])
def test_the_shared_memory_holds_the_kernel_sources_tiles(c, h, w):
    """The wrappers size shared memory by the Tile<> layout of the source:
    its column padding, each function's halos and its count of tiles. K3a
    takes C x tiles and the summed blur's (canny_tile), K3b four input
    tiles and u_summed's (canny_adjoint_tail); K1/K2's Canny strips fit the
    region they share with the HFS stages."""
    with open(SOURCE) as f:
        src = f.read()
    (pad,) = re.findall(r"kLd = COLS \+ (\d+);", src)
    assert int(pad) == 2 * F.TILE_PAD

    def floats(rows, cols, halo):
        return (rows + 2 * halo) * (cols + int(pad))

    fwd, tail = _body(src, "canny_tile"), _body(src, "canny_adjoint_tail")
    kbwd, band_bwd = _body(src, "canny_bwd_kernel"), _body(src, "band_canny_adjoint")
    x, s = _tiles(fwd)["X"], _tiles(fwd)["S"]
    assert "float* sS = smem + C * X::kFloats;" in fwd
    (n_in,) = re.findall(r"float\* sU = sIn \+ (\d+) \* G::kFloats;", kbwd)
    u = _tiles(tail)["U"]
    assert _tiles(tail)["G"] == _tiles(kbwd)["G"]

    canny = functools.partial(floats, F.CANNY_ROWS, F.CANNY_COLS)
    geo = F.canny_geometry(c, h, w)
    assert geo.fwd_smem_bytes == 4 * (c * canny(x) + canny(s))
    assert geo.bwd_smem_bytes == 4 * (int(n_in) * canny(_tiles(kbwd)["G"]) + canny(u))

    band = functools.partial(floats, F.BAND_ROWS, F.STRIP_W)
    bt = _tiles(band_bwd)
    for line in ("float* sS = smem + C * X::kFloats;", "float* sG0 = sS + S::kFloats;",
                 "float* sG1 = sG0 + G::kFloats;", "float* sU = sG1 + G::kFloats;"):
        assert line in band_bwd
    k1, k2 = F.band_geometry(c, h, w, False), F.band_geometry(c, h, w, True)
    assert k1.smem_bytes >= 4 * (k1.s + c * band(x) + band(s))
    assert k2.smem_bytes >= 4 * (k2.s + c * band(bt["X"]) + band(bt["S"]) + 2 * band(bt["G"])
                                 + band(u))


# ---- the bfloat16 forms ----------------------------------------------------
# K1 bf16 stages its planes as float32, so its geometry is K1's; K2 bf16
# works on column bands of the transposed problem (dx^T = B^T U^T A: JAX
# contracts its adjoint over W first), its Canny strips STRIP_W rows by
# BAND_ROWS columns.

@pytest.mark.parametrize("name,channels,cize", STEP125, ids=[n for n, _, _ in STEP125])
def test_bf16_geometry_fits_and_tiles_every_column(name, channels, cize):
    k1 = F.kernel_geometry(channels, cize, cize, False, torch.bfloat16)
    assert k1 == F.band_geometry(channels, cize, cize, False)
    geo = F.kernel_geometry(channels, cize, cize, True, torch.bfloat16)
    assert geo == F.band_geometry(channels, cize, cize, True, columns=True)
    assert 0 < geo.smem_bytes <= F.MAX_SMEM_BYTES
    cols = np.zeros(cize, int)
    for band in range(geo.bands):
        cols[band * F.BAND_ROWS:(band + 1) * F.BAND_ROWS] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("h,w", [(24, 40), (30, 30), (128, 128)])
def test_bf16_operators_are_rounded_and_transposed(h, w):
    """K1 bf16 gets (Ar, Ai, Br^T, Bi^T), K2 bf16 (Br^T, Bi^T, Ar, Ai): the
    values rounded to bfloat16, held as float32, zero-padded to its column
    geometry's shapes."""
    ar, ai, br, bi = (torch.from_numpy(m).to(torch.bfloat16).float().numpy()
                      for m in _hfs_axis_operators(h, w, 8))
    for backward, want in ((False, (ar, ai, br.T, bi.T)), (True, (br.T, bi.T, ar, ai))):
        geo = F.kernel_geometry(3, h, w, backward, torch.bfloat16)
        got = F.band_operators(h, w, 8, backward, "cpu", torch.bfloat16)
        for g, m, shape in zip(got, want, (geo.l_shape,) * 2 + (geo.r_shape,) * 2):
            g = g.numpy().copy()
            assert g.dtype == np.float32 and g.shape == shape
            np.testing.assert_array_equal(g[:m.shape[0], :m.shape[1]], m)
            g[:m.shape[0], :m.shape[1]] = 0
            assert not g.any()


@pytest.mark.parametrize("c,h,w", [(3, 64, 64), (3, 128, 128), (3, 224, 224), (3, 24, 40),
                                   (1, 28, 28), (3, 288, 288)])
def test_the_column_bands_hold_the_kernel_sources_tiles(c, h, w):
    """band_canny_adjoint<COLUMNS> walks strips of kStripW rows by
    kBandRows columns; its tiles fit the region column geometry gives it."""
    with open(SOURCE) as f:
        src = f.read()
    body = _body(src, "band_canny_adjoint")
    assert ("constexpr int ROWS = COLUMNS ? kStripW : kBandRows, "
            "COLS = COLUMNS ? kBandRows : kStripW;") in body
    halos = _tiles(body)
    (pad,) = re.findall(r"kLd = COLS \+ (\d+);", src)
    tile = lambda halo: (F.STRIP_W + 2 * halo) * (F.BAND_ROWS + int(pad))
    geo = F.band_geometry(c, h, w, True, columns=True)
    need = c * tile(halos["X"]) + tile(halos["S"]) + 2 * tile(halos["G"]) + tile(1)
    assert geo.smem_bytes >= 4 * (geo.s + need)
    # T and the Canny plane of a column band: H takes W's place
    assert geo.wq >= h and geo.wt >= h and geo.hk >= w and geo.bands * F.BAND_ROWS >= w


def test_bf16_and_float32_entry_points():
    """The wrappers pick K1/K2's entry point and launch counter by dtype."""
    assert F._entry("ee_fused_fwd", torch.float32) == "ee_fused_fwd"
    assert F._entry("ee_fused_bwd", torch.bfloat16) == "ee_fused_bwd_bf16"
    assert {"ee_fused_fwd_bf16", "ee_fused_bwd_bf16"} <= set(F.LAUNCHES)
    with open(SOURCE) as f:
        src = f.read()
    for name in ("ee_fused_fwd", "ee_fused_bwd", "ee_fused_fwd_bf16", "ee_fused_bwd_bf16"):
        assert re.search(rf"^int {name}\(", src, re.MULTILINE), name
