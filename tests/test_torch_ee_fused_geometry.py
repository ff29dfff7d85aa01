"""The block geometry of the row-band kernels K1/K2 (ops/cuda/ee_fused.py:
band_geometry, band_operators) and of the Canny-only tile kernels K3a/K3b
(canny_geometry) at every image size a shipped config gives the fused
front-end: a block's shared memory fits a Hopper block, the bands tile every
image row and the tiles every pixel exactly once. The kernels themselves run
only on a card (tests/test_torch_cuda.py); this pins on any host that each
shipped step125 config is inside their envelope."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
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
    names = ("kBandRows|kBandThreads|kChunk|kStripW|kCannyRows|kCannyCols|kCannyBf16Rows|"
             "kCannyBf16Cols")
    found = {name: int(v) for name, v in
             re.findall(rf"constexpr int ({names}) = (\d+);", src)}
    assert found == {"kBandRows": F.BAND_ROWS, "kBandThreads": F.BAND_THREADS,
                     "kChunk": F.CHUNK, "kStripW": F.STRIP_W,
                     "kCannyRows": F.CANNY_ROWS, "kCannyCols": F.CANNY_COLS,
                     "kCannyBf16Rows": F.CANNY_BF16_ROWS, "kCannyBf16Cols": F.CANNY_BF16_COLS}


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
# with ragged last ones, the card tests' largest C; in float32, then the
# same in bfloat16 (its own tiles) with the bfloat16 card tests' odd sizes
# and its largest C
CANNY_SHAPES = ([(c, n, n) for _, c, n in STEP125]
                + [(3, 32, 64), (3, 37, 45), (3, 2, 5), (3, 100, 100), (3, 224, 224),
                   (3, 72, 72), (F.canny_geometry(1, 20, 20).max_channels, 20, 20)])
CANNY_BF16_SHAPES = (CANNY_SHAPES[:-1]
                     + [(3, 35, 39), (3, 7, 3), (2, 1, 1), (3, 33, 67), (3, 40, 64),
                        (F.canny_geometry(1, 20, 20, torch.bfloat16).max_channels, 20, 20)])


@pytest.mark.parametrize("c,h,w,dtype",
                         [pytest.param(c, h, w, torch.float32, id=f"{c}-{h}-{w}")
                          for c, h, w in CANNY_SHAPES]
                         + [pytest.param(c, h, w, torch.bfloat16, id=f"{c}-{h}-{w}-bf16")
                            for c, h, w in CANNY_BF16_SHAPES])
def test_canny_geometry_fits_and_tiles_every_pixel(c, h, w, dtype):
    geo = F.canny_geometry(c, h, w, dtype)
    rows, cols = ((F.CANNY_BF16_ROWS, F.CANNY_BF16_COLS) if dtype == torch.bfloat16
                  else (F.CANNY_ROWS, F.CANNY_COLS))
    assert c <= geo.max_channels
    assert 0 < geo.fwd_smem_bytes <= F.MAX_SMEM_BYTES
    assert 0 < geo.bwd_smem_bytes <= F.MAX_SMEM_BYTES
    seen = np.zeros((h, w), int)
    for i in range(geo.tiles_h):
        for j in range(geo.tiles_w):
            assert i * rows < h and j * cols < w        # no tile wholly off the image
            seen[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype,envelope", [(torch.float32, 71), (torch.bfloat16, 66)],
                         ids=["f32", "bf16"])
def test_the_canny_envelope_in_channels(dtype, envelope):
    """K3a's block holds C tiles of x: the most channels that fit is what
    both wrappers refuse above, before any launch (the checks run on any
    host; the device is checked last). A bfloat16 tile holds half the bytes
    of a float32 one; the bfloat16 block's tile is 32 x 32 pixels, twice the
    float32 one's."""
    geo = F.canny_geometry(1, 64, 64, dtype)
    top = geo.max_channels
    assert top == envelope
    assert F.canny_geometry(top, 64, 64, dtype).fwd_smem_bytes <= F.MAX_SMEM_BYTES
    assert F.canny_geometry(top + 1, 64, 64, dtype).fwd_smem_bytes > F.MAX_SMEM_BYTES
    assert F.canny_geometry(top + 1, 64, 64, dtype).bwd_smem_bytes == geo.bwd_smem_bytes
    with pytest.raises(ValueError, match="channels"):
        F._check_canny(torch.zeros(1, top + 1, 64, 64, dtype=dtype))
    with pytest.raises(ValueError, match="CUDA"):
        F._check_canny(torch.zeros(1, top, 64, 64, dtype=dtype))
    plane = torch.zeros(1, 1, 64, 64, dtype=dtype)
    with pytest.raises(ValueError, match="channels"):     # K3b's dx
        F._check_canny(torch.zeros(1, top + 1, 64, 64, dtype=dtype), plane, plane, plane, plane)
    with pytest.raises(ValueError, match="CUDA"):
        F._check_canny(torch.zeros(1, top, 64, 64, dtype=dtype), plane, plane, plane, plane)


def _body(src, function):
    """The source text of the device function or kernel `function`."""
    body = src[re.search(rf"\n{function}\(|\s{function}\(", src).start():]
    return body[:body.index("\n}\n")]


def _tiles(body):
    """{name: halo} of the Tile<> types that a function's body declares."""
    return {n: int(h) for n, h in re.findall(r"using (\w) = Tile<\w+, \w+, (\d+)>;", body)}


def _struct(src, name):
    """The source text of the struct `name`."""
    body = src[src.index(f"\nstruct {name} {{"):]
    return body[:body.index("\n};\n")]


@pytest.mark.parametrize("c,h,w", [(3, 64, 64), (3, 128, 128), (3, 37, 45), (3, 224, 224),
                                   (1, 20, 20), (3, 288, 288)])
def test_the_bf16_shared_memory_holds_the_kernel_sources_tiles(c, h, w):
    """The bfloat16 K3a takes C x tiles (Tile2, halo 2) and the summed
    blur's (Mid2), K3b four input tiles (Tile2) and u_summed's (Mid2), of
    bfloat16: canny_geometry sizes them by the source's padding, halos and
    counts."""
    with open(SOURCE) as f:
        src = f.read()
    tile2, mid2 = _struct(src, "Tile2"), _struct(src, "Mid2")
    (pad,) = re.findall(r"kLd = COLS \+ (\d+);", tile2)
    (mid_pad,) = re.findall(r"kLd = COLS \+ (\d+);", mid2)
    assert (int(pad), int(mid_pad)) == (2 * F.TILE2_PAD, F.MID2_PAD)
    assert "kRows = ROWS + 2 * HALO;" in tile2 and "kRows = ROWS + 2;" in mid2
    fwd, bwd = _body(src, "canny_fwd_bf16_kernel"), _body(src, "canny_bwd_bf16_kernel")
    (x_halo,) = re.findall(r"using X = Tile2<kCannyBf16Rows, kCannyBf16Cols, (\d)>;", fwd)
    (g_halo,) = re.findall(r"using G = Tile2<kCannyBf16Rows, kCannyBf16Cols, (\d)>;", bwd)
    assert "using S = Mid2<kCannyBf16Rows, kCannyBf16Cols>;" in fwd
    assert "using U = Mid2<kCannyBf16Rows, kCannyBf16Cols>;" in bwd
    assert "bf16* sS = sX + C * X::kElems;" in fwd
    (n_in,) = re.findall(r"bf16\* sU = sIn \+ (\d+) \* G::kElems;", bwd)
    rows, cols = F.CANNY_BF16_ROWS, F.CANNY_BF16_COLS

    def tile(halo):
        return 2 * (rows + 2 * halo) * (cols + int(pad))
    mid = 2 * (rows + 2) * (cols + int(mid_pad))
    geo = F.canny_geometry(c, h, w, torch.bfloat16)
    assert geo.fwd_smem_bytes == c * tile(int(x_halo)) + mid
    assert geo.bwd_smem_bytes == int(n_in) * tile(int(g_halo)) + mid
    # 16-byte units of 8 columns, rows on 16 bytes; an odd quad's 8-byte stores
    assert (cols + int(pad)) % 8 == 0 and (cols + int(mid_pad)) % 4 == 0
    assert geo.fwd_smem_bytes % 16 == 0 and geo.bwd_smem_bytes % 16 == 0


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
    (pad,) = re.findall(r"kLd = COLS \+ (\d+);", _struct(src, "Tile"))
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
# The bfloat16 K1/K2 run their HFS products on the tensor cores, on operators
# and tiles held as bfloat16 (mma_geometry). K1 on row bands; K2 on column
# bands of the transposed problem (dx^T = B^T U^T A: JAX contracts its
# adjoint over W first), its Canny strips STRIP_W rows by BAND_ROWS columns.

HALF = sorted({n for name, c, n in STEP125 if c == 3 and n >= 128})


def _two_a_sm(smem_bytes):
    """Whether two blocks of `smem_bytes` dynamic shared memory (and up to
    128 bytes of static) share an SM."""
    return 2 * (smem_bytes + 128 + F.BLOCK_RESERVED_BYTES) <= F.SM_SMEM_BYTES


def test_the_half_configs_are_the_imagenet_sizes():
    """Every shipped `half: true` config with an edge-enhancement front-end
    is an ImageNet recipe at 128, 224 or 288 px on the fused step125 Canny
    (the others are plain ResNet-50s)."""
    half = []
    for path in sorted(glob.glob(os.path.join(CONFIGS, "*", "*.yml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
        if cfg.get("half"):
            half.append((cfg["arch"], cfg.get("type_canny"), int(cfg["cize"])))
    ee = [(t, n) for arch, t, n in half if arch.endswith("_EE")]
    assert len(ee) == 8 and all(t is None for arch, t, _ in half if not arch.endswith("_EE"))
    assert {t for t, _ in ee} == {"CannyFilter_step125_1"}
    assert {n for _, n in ee} == set(HALF) == {128, 224, 288}


@pytest.mark.parametrize("name,channels,cize", STEP125, ids=[n for n, _, _ in STEP125])
def test_bf16_geometry_fits_and_tiles_every_column(name, channels, cize):
    k1 = F.kernel_geometry(channels, cize, cize, False, torch.bfloat16)
    assert k1 == F.mma_geometry(channels, cize, cize, False)
    geo = F.kernel_geometry(channels, cize, cize, True, torch.bfloat16)
    assert geo == F.mma_geometry(channels, cize, cize, True)
    # K1's ring: the deepest that keeps two blocks an SM (2 where none does);
    # K2 runs its products on two stages
    assert 2 <= k1.depth <= F.MMA_DEPTH and geo.depth == 2
    assert (k1.depth == F.MMA_DEPTH
            or not _two_a_sm(k1.stages + (k1.depth + 1) * F.MMA_STAGE_BYTES))
    for g in (k1, geo):
        assert 0 < g.smem_bytes <= F.MAX_SMEM_BYTES
        if cize in HALF:                      # two blocks an SM at fast-AT's sizes
            assert _two_a_sm(g.smem_bytes)
        cols = np.zeros(cize, int)
        for band in range(g.bands):
            cols[band * F.BAND_ROWS:(band + 1) * F.BAND_ROWS] += 1
        assert (cols == 1).all()
        # whole chunks of the first contraction (K1's on the FP32 pipes, K2's
        # on the tensor cores), whole 32-column warp tiles, K1's whole panels
        assert g.kp % (F.MMA_CHUNK if g is geo else F.CHUNK) == 0 and g.kp >= cize
        assert g.np % 32 == 0 and g.np >= cize
    assert k1.wt % F.PANEL == 0 and k1.wt >= k1.np


@pytest.mark.parametrize("h,w", [(24, 40), (30, 30), (128, 128)])
def test_bf16_operators_are_rounded_and_transposed(h, w):
    """K1 bf16 gets (Ar, Ai, Br^T, Bi^T), K2 bf16 (Br^T, Bi^T, Ar, Ai): the
    values rounded to bfloat16, zero-padded to its mma_geometry's shapes (L:
    bands x BAND_ROWS by kp; R: np x np), held as bfloat16 but for K1's A,
    float32 for its first product on the FP32 pipes."""
    ar, ai, br, bi = (torch.from_numpy(m).to(torch.bfloat16)
                      for m in _hfs_axis_operators(h, w, 8))
    for backward, want in ((False, (ar, ai, br.T, bi.T)), (True, (br.T, bi.T, ar, ai))):
        geo = F.kernel_geometry(3, h, w, backward, torch.bfloat16)
        got = F.band_operators(h, w, 8, backward, "cpu", torch.bfloat16)
        for i, (g, m, shape) in enumerate(zip(got, want,
                                              (geo.l_shape,) * 2 + (geo.r_shape,) * 2)):
            dtype = torch.float32 if i < 2 and not backward else torch.bfloat16
            assert g.dtype == dtype and tuple(g.shape) == shape
            assert g.is_contiguous()
            assert torch.equal(g[:m.shape[0], :m.shape[1]], m.to(dtype))
            g = g.clone()
            g[:m.shape[0], :m.shape[1]] = 0
            assert not g.any()


@pytest.mark.parametrize("c,h,w", [(3, 64, 64), (3, 128, 128), (3, 224, 224), (3, 24, 40),
                                   (1, 28, 28), (3, 288, 288)])
def test_the_column_bands_hold_the_kernel_sources_tiles(c, h, w):
    """band_canny_adjoint<COLUMNS> walks strips of kStripW rows by
    kBandRows columns; its tiles fit the region mma_geometry gives it."""
    with open(SOURCE) as f:
        src = f.read()
    body = _body(src, "band_canny_adjoint")
    assert ("constexpr int ROWS = COLUMNS ? kStripW : kBandRows, "
            "COLS = COLUMNS ? kBandRows : kStripW;") in body
    halos = _tiles(body)
    (pad,) = re.findall(r"kLd = COLS \+ (\d+);", _struct(src, "Tile"))
    tile = lambda halo: (F.STRIP_W + 2 * halo) * (F.BAND_ROWS + int(pad))
    geo = F.mma_geometry(c, h, w, True)
    need = c * tile(halos["X"]) + tile(halos["S"]) + 2 * tile(halos["G"]) + tile(1)
    assert geo.smem_bytes >= geo.t + 4 * need
    # T and the Canny plane of a column band: H takes W's place; the plane
    # holds a row of BAND_ROWS floats for each image row
    assert geo.lde == F.BAND_ROWS and geo.t >= 4 * F.BAND_ROWS * h
    assert geo.np >= h and geo.kp >= w and geo.bands * F.BAND_ROWS >= w


def test_the_mma_constants_and_layout_are_the_kernel_sources():
    """The wrapper lays a bfloat16 block out with the tile constants and the
    MmaLayout fields that the kernels are compiled with."""
    with open(SOURCE) as f:
        src = f.read()
    found = {name: int(v) for name, v in
             re.findall(r"constexpr int (kMmaChunk|kMmaPanel|kMmaPad) = (\d+);", src)}
    assert found == {"kMmaChunk": F.MMA_CHUNK, "kMmaPanel": F.MMA_PANEL,
                     "kMmaPad": F.MMA_PAD}
    # a stage: R's chunk, Rr and Ri, of kMmaChunk rows of kLdN bfloat16
    assert "constexpr int kLdN = kMmaPanel + kMmaPad;" in src
    assert "constexpr int kMmaStage = 2 * kMmaChunk * kLdN;" in src
    assert F.MMA_STAGE_BYTES == 2 * 2 * F.MMA_CHUNK * (F.MMA_PANEL + F.MMA_PAD)
    (fields,) = re.findall(r"struct MmaLayout \{\s*int ([\w, ]+);", src)
    assert tuple(f.strip() for f in fields.split(",")) == (
        "kp", "np", "wt", "lde", "ldt", "t", "stages", "depth")
    geo = F.mma_geometry(3, 128, 128, False)
    assert geo.layout == (geo.kp, geo.np, geo.wt, geo.lde, geo.ldt, geo.t, geo.stages,
                          geo.depth)


@pytest.mark.parametrize("backward", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("c,h,w", [(3, 30, 30), (1, 28, 28), (3, 24, 40), (3, 72, 72),
                                   (3, 100, 100), (3, 128, 128), (3, 224, 224),
                                   (3, 288, 288)])
def test_bf16_layout_is_aligned_and_disjoint(c, h, w, backward):
    """The band's Canny plane, T and the two stages follow one another
    without overlap, on 128 bytes; the Canny strips fit between t and the
    end; T's row stride is 16 bytes past a multiple of 32, so the 8 rows of
    an ldmatrix fall on distinct banks, and 16-byte aligned."""
    geo = F.mma_geometry(c, h, w, backward)
    width = h if backward else w              # T's width, the result's
    plane = 4 * F.BAND_ROWS * (-(-width // 8) * 8)
    assert geo.t >= plane and geo.t % 128 == 0
    assert geo.lde * 4 % 16 == 0
    assert geo.ldt >= geo.np and (2 * geo.ldt) % 32 == 16
    assert geo.stages >= geo.t + 2 * 2 * F.BAND_ROWS * geo.ldt and geo.stages % 128 == 0
    assert geo.smem_bytes >= geo.stages + geo.depth * F.MMA_STAGE_BYTES
    assert geo.smem_bytes % 16 == 0 and len(geo.layout) == 8


def _round_bf16(t):
    return t.to(torch.bfloat16).double()


@pytest.mark.parametrize("h,w", [(24, 40), (30, 30), (72, 72)])
def test_bf16_operators_compute_the_hfs_products_in_the_kernels_frame(h, w):
    """The kernels' arithmetic on their padded operators, band by band, with
    float64 sums: K1's T = bf16(L P) and bf16(Tr Rr - Ti Ri) are the HFS
    sandwich's A X and Ar X Br^T - Ai X Bi^T; K2's, on the transposed
    problem with P = U^T, are JAX's dt = bf16(U B) and Ar^T dt_r - Ai^T dt_i,
    transposed. Zero padding changes nothing."""
    rng = np.random.default_rng(0)
    plane = torch.from_numpy(rng.random((h, w))).to(torch.bfloat16).double()
    ar, ai, br, bi = (torch.from_numpy(m).to(torch.bfloat16).double()
                      for m in _hfs_axis_operators(h, w, 8))
    for backward in (False, True):
        geo = F.mma_geometry(1, h, w, backward)
        lr, li, rr, ri = (m.double() for m in
                          F.band_operators(h, w, 8, backward, "cpu", torch.bfloat16))
        p = plane.T if backward else plane                  # (first contraction, T's width)
        pad = torch.zeros(geo.kp, geo.np, dtype=torch.float64)
        pad[:p.shape[0], :p.shape[1]] = p
        t_r, t_i, out = [], [], []
        for band in range(geo.bands):
            rows = slice(band * F.BAND_ROWS, (band + 1) * F.BAND_ROWS)
            tr, ti = _round_bf16(lr[rows] @ pad), _round_bf16(li[rows] @ pad)
            t_r.append(tr)
            t_i.append(ti)
            out.append(_round_bf16(tr @ rr - ti @ ri))
        n_rows, n_cols = p.shape[1], p.shape[0]             # the result's frame
        t_r = torch.cat(t_r)[:n_cols, :n_rows]
        t_i = torch.cat(t_i)[:n_cols, :n_rows]
        out = torch.cat(out)[:n_cols, :n_rows]
        if backward:                                        # dt^T and dx_hfs^T
            dt_r, dt_i = _round_bf16(plane @ br), _round_bf16(plane @ bi)
            assert torch.equal(t_r, dt_r.T) and torch.equal(t_i, dt_i.T)
            assert torch.equal(out, _round_bf16(ar.T @ dt_r - ai.T @ dt_i).T)
        else:
            x_r, x_i = _round_bf16(ar @ plane), _round_bf16(ai @ plane)
            assert torch.equal(t_r, x_r) and torch.equal(t_i, x_i)
            assert torch.equal(out, _round_bf16(x_r @ br.T - x_i @ bi.T))
        assert out.abs().max() > 0


def test_the_profile_tool_marks_every_phase_of_the_source():
    """tools/profile_ee_fused.py instruments csrc/ee_fused.cu by anchors: each
    is found once, and every phase gets its mark."""
    from edge_enhancement_tpu_torch.tools import profile_ee_fused as prof
    src = prof.instrumented_source()
    marks = {int(i) for i in re.findall(r"prof_mark\((-?\d+)\);", src)}
    assert marks == set(range(-1, len(prof.PHASES)))
    assert src.count("prof_init();") == 2 and src.count("prof_flush(stripes);") == 2


def test_the_profile_tool_marks_every_canny_kernel(monkeypatch):
    """The K3 marks: a K3Prof opens the body of every Canny-only kernel, in
    float32 and bfloat16, and every barrier after the helpers ends a phase;
    a kernel of the earlier form, a template on the number policy, takes
    the same marks."""
    from edge_enhancement_tpu_torch.tools import profile_ee_fused as prof
    src = prof.k3_instrumented_source()
    names = prof.K3_KERNEL.findall(src)
    assert sorted(names) == ["canny_bwd_bf16_kernel", "canny_bwd_kernel",
                             "canny_fwd_bf16_kernel", "canny_fwd_kernel"]
    assert src.count("K3Prof k3_prof(gtaps);") == 4
    for name in names:
        body = src[src.index(f"\n{name}("):]
        assert body[body.index("{\n") + 2:].startswith("  K3Prof k3_prof(gtaps);")
    assert src.index("#define __syncthreads() k3_barrier()") < src.index("\ncanny_fwd_kernel(")
    earlier = ("namespace {\ntemplate <class P>\n__global__ void __launch_bounds__(128, 6)\n"
               "canny_fwd_kernel(const typename P::T* __restrict__ x, const float* "
               "__restrict__ gtaps, Params p) {\n  __syncthreads();\n}\n}  // namespace\n")
    monkeypatch.setattr(prof, "_source", lambda: earlier)
    marked = prof.k3_instrumented_source()
    assert "Params p) {\n  K3Prof k3_prof(gtaps);\n  __syncthreads();" in marked


def test_sass_counts_classes_each_kernels_instructions():
    """build.sass_counts on cuobjdump's layout: one count a kernel whose
    name holds the pattern, predicated instructions included, packed bf16x2
    in both of ptxas's forms."""
    from edge_enhancement_tpu_torch.ops.cuda import build
    sass = """
\t\tFunction : _ZN12_GLOBAL__N_121canny_fwd_bf16_kernelEPK13__nv_bfloat16
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   HFMA2.MMA.BF16_V2 R16, R24, R17, -RZ ;   /* 0x0 */
        /*0020*/              @P0  HADD2.BF16_V2 R0, R1, R2 ;      /* 0x0 */
        /*0030*/                   HMUL2.BF16_V2 R0, R25, R0 ;     /* 0x0 */
        /*0040*/                   F2FP.BF16.F32.PACK_AB R6, R19, R18 ;   /* 0x0 */
        /*0050*/             @!P1  FADD R18, R18, R9 ;             /* 0x0 */
        /*0060*/                   LDS.64 R4, [R2] ;               /* 0x0 */
        /*0070*/                   PRMT R18, R17, 0x5432, R19 ;    /* 0x0 */
        /*0080*/                   EXIT ;                          /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_118ee_fused_fwd_kernelEPKf
        /*0000*/                   HADD2.BF16_V2 R0, R1, R2 ;      /* 0x0 */
"""
    counts = build.sass_counts(sass)
    assert list(counts) == ["_ZN12_GLOBAL__N_121canny_fwd_bf16_kernelEPK13__nv_bfloat16"]
    (c,) = counts.values()
    assert c == {"all": 9, "F2FP": 1, "FMUL/FADD/FFMA": 1, "bf16x2": 3, "LDS": 1, "STS": 0,
                 "PRMT": 1, "MUFU": 0}


def test_bf16_and_float32_entry_points():
    """The wrappers pick K1/K2's entry point and launch counter by dtype."""
    assert F._entry("ee_fused_fwd", torch.float32) == "ee_fused_fwd"
    assert F._entry("ee_fused_bwd", torch.bfloat16) == "ee_fused_bwd_bf16"
    assert {"ee_fused_fwd_bf16", "ee_fused_bwd_bf16"} <= set(F.LAUNCHES)
    with open(SOURCE) as f:
        src = f.read()
    for name in ("ee_fused_fwd", "ee_fused_bwd", "ee_fused_fwd_bf16", "ee_fused_bwd_bf16"):
        assert re.search(rf"^int {name}\(", src, re.MULTILINE), name
