"""The fused edge-enhancement front-end: CUDA kernels K1 (forward) and K2
(adjoint), and the Canny-only pair K3a/K3b, with their plain PyTorch
versions beside them.

K1/K2 replace edge_enhancement_tpu/ops/pallas/ee_fused.py::_fwd_kernel and
::_bwd_kernel, the `_ee_fused` custom_vjp pair. One pass computes the whole
front-end of the square / BPDA-3 models:

    xs   = add_square(x)                   (n_queries = 1, draws made outside)
    hfs  = HFS(xs)                         (per-axis operator sandwich)
    edge = canny_step125(x)                (clean x)
    out  = clip(hfs + w * edge, 0, 1)

and K2 is its exact adjoint from the residuals (x, y = hfs + w * edge).

K3a/K3b replace ::_canny_fwd_kernel and ::_canny_bwd_kernel, the
`canny_step125_fused` pair: K3a is the edge map alone, with the residuals
mag, gx, gy; K3b its adjoint from them. The front-end runs them where K1
does not apply (the edge map smoothed by a Gaussian, `with_gf`, or more
than one square query).
Source and design notes: edge_enhancement_tpu_torch/csrc/ee_fused.cu.

K1/K2 take (B, C, H, W) float32 or bfloat16 (the bf16 policy: the JAX
kernels compute in x's dtype, rounding where it is bfloat16; the square
draws come in x's dtype too; the bfloat16 forms run their HFS products on
the tensor cores, with their own block geometry, mma_geometry). K3a/K3b
take float32 or bfloat16 too: JAX's Canny-only kernel computes in the
image's dtype, and its bfloat16 form rounds every step but the channel
sum, where K1's keeps the division and the magnitude in float32 (the
bfloat16 K3a/K3b compute on pixel pairs in packed bf16x2 instructions, on
bfloat16 tiles of their own size: canny_geometry takes the dtype). On a CPU
tensor the wrappers run the plain versions; on a CUDA tensor they launch
the kernel or raise, and never convert a tensor to reach another form.
The plain versions are also the oracle of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from ..canny import _blur_sobel_magnitude_nchw, _channel_sum, canny_step125_nchw
from ..filters import gaussian_kernel, sobel_kernel
from ..hfs import _hfs_axis_operators, hfs_nchw
from ..square import clip01, square_forward_nchw
from ..stencil import stencil_taps, weak_scalar
from ..ste import to_compare

# Launches of each kernel since the last reset_launches(); the wrappers add
# one where they launch and nowhere else.
LAUNCHES = {"ee_fused_fwd": 0, "ee_fused_bwd": 0,
            "ee_fused_fwd_bf16": 0, "ee_fused_bwd_bf16": 0,
            "canny_fused_fwd": 0, "canny_fused_bwd": 0,
            "canny_fused_fwd_bf16": 0, "canny_fused_bwd_bf16": 0}
# Largest dynamic shared memory a Hopper block may opt into (232,448 bytes);
# an SM's 233,472 bytes of shared memory and the 1,024 the card keeps for
# each resident block.
MAX_SMEM_BYTES, SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 232448, 233472, 1024
# K1/K2's block geometry. This module owns the layout of a block and passes
# it to the launch; the four constants are csrc/ee_fused.cu's kBandRows,
# kBandThreads, kChunk and kStripW, which the kernels are compiled with (a
# CPU test holds the two files to the same values): a block owns BAND_ROWS
# image rows of one image; the HFS products stream CHUNK-deep chunks; the
# Canny branch runs in strips of STRIP_W columns.
BAND_ROWS, BAND_THREADS, CHUNK, STRIP_W = 32, 256, 16, 64
# columns of one product panel: 4 columns a thread, BAND_ROWS / 2 row groups
PANEL = 4 * BAND_THREADS // (BAND_ROWS // 2)
# The bfloat16 K1/K2's products on the tensor cores (csrc/ee_fused.cu's
# kMmaChunk, kMmaPanel and kMmaPad; the CPU test holds these too): chunks
# MMA_CHUNK deep, passes of MMA_PANEL columns, MMA_PAD bfloat16 after each
# staged row; a stage holds the largest chunk, R's (Rr, Ri, each MMA_CHUNK x
# (MMA_PANEL + MMA_PAD) bfloat16); the tensor-core products run on two
# stages, K1's first product on a ring of 2 to MMA_DEPTH.
MMA_CHUNK, MMA_PANEL, MMA_PAD, MMA_DEPTH = 32, 128, 8, 4
MMA_STAGE_BYTES = 2 * 2 * MMA_CHUNK * (MMA_PANEL + MMA_PAD)
# K3a/K3b's tile: a block owns CANNY_ROWS x CANNY_COLS pixels of one image;
# csrc/ee_fused.cu's kCannyRows and kCannyCols (the CPU test holds these too).
CANNY_ROWS, CANNY_COLS = 16, 32
# csrc/ee_fused.cu's Tile<ROWS, COLS, HALO>: rows +- HALO, columns +- TILE_PAD
TILE_PAD = 4
# The bfloat16 K3a/K3b's own tile, CANNY_BF16_ROWS x CANNY_BF16_COLS pixels
# (csrc/ee_fused.cu's kCannyBf16Rows and kCannyBf16Cols), and their tiles in
# shared memory: Tile2<ROWS, COLS, HALO>, rows +- HALO and columns
# +- TILE2_PAD; Mid2<ROWS, COLS>, rows +- 1 and COLS + MID2_PAD columns (the
# CPU test reads all four from the source)
CANNY_BF16_ROWS, CANNY_BF16_COLS = 32, 32
TILE2_PAD, MID2_PAD = 8, 4


def _tile_floats(rows: int, cols: int, halo: int) -> int:
    """The floats of one Tile<rows, cols, halo> of the Canny tile functions."""
    return (rows + 2 * halo) * (cols + 2 * TILE_PAD)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class BandGeometry:
    """Where K1/K2 put a (C, H, W) problem: `bands` blocks per image, band i
    owning rows [i * BAND_ROWS, (i + 1) * BAND_ROWS) of [0, H); the block's
    shared-memory layout in floats (csrc/ee_fused.cu's BandLayout: the
    band's Canny plane of BAND_ROWS x wq at 0, T = [Lr; Li] P of
    2 BAND_ROWS x ld_t at t, of which wt columns are computed, and at s the
    region the Canny strips, then the HFS stages and the exchange share);
    the padded operators' inner sizes hk (L) and wk (R); and the bytes. The
    float32 forms' geometry (the bfloat16 forms': MmaGeometry)."""
    bands: int
    wq: int
    wt: int
    ld_t: int
    hk: int
    wk: int
    t: int
    s: int
    smem_bytes: int

    @property
    def layout(self) -> tuple:
        """BandLayout's fields, in the order the launch takes them."""
        return (self.wq, self.wt, self.ld_t, self.hk, self.wk, self.t, self.s)

    @property
    def l_shape(self) -> tuple:
        """Shape of the padded Lr, Li (K1: Ar, Ai; K2: their transposes)."""
        return (self.bands * BAND_ROWS, self.hk)

    @property
    def r_shape(self) -> tuple:
        """Shape of the padded Rr, Ri (K1: Br^T, Bi^T; K2: Br, Bi)."""
        return (self.wk, self.wt)


@functools.lru_cache(maxsize=None)
def band_geometry(c: int, h: int, w: int, backward: bool) -> BandGeometry:
    """The float32 K1's (backward=False) or K2's block geometry for C
    channels of H x W."""
    bh, sw = BAND_ROWS, STRIP_W
    tile = functools.partial(_tile_floats, bh, sw)
    wq, wt = _round_up(w, 4), _round_up(w, PANEL)
    ld_t = wt + 4              # 4 more than a multiple of 64: T's rows on distinct banks
    if backward:               # x (4-pixel halo), summed blur (3), u_gx, u_gy (2), u_summed (1)
        canny = c * tile(4) + tile(3) + 2 * tile(2) + tile(1)
    else:                      # x (2-pixel halo), summed blur (1)
        canny = c * tile(2) + tile(1)
    chunk_plane, chunk_ops = CHUNK * PANEL, 2 * bh * (CHUNK + 4)
    stage = max(chunk_ops + chunk_plane, 2 * chunk_plane)
    hfs = 2 * stage + bh * PANEL
    t = bh * wq
    s = t + 2 * bh * ld_t
    return BandGeometry(bands=-(-h // bh), wq=wq, wt=wt, ld_t=ld_t,
                        hk=_round_up(h, CHUNK), wk=_round_up(w, CHUNK), t=t, s=s,
                        smem_bytes=4 * (s + max(canny, hfs)))


@dataclasses.dataclass(frozen=True)
class MmaGeometry:
    """Where the bfloat16 K1/K2 put a (C, H, W) problem (csrc/ee_fused.cu's
    MmaLayout). K1 on row bands: band i owns image rows [i * BAND_ROWS,
    (i + 1) * BAND_ROWS); T = A X contracts over H and is W wide. K2 on
    column bands of the transposed problem dx^T = B^T U^T A: band i owns
    image columns, T = B^T U^T contracts over W and is H wide. kp: the first
    contraction padded, L's row length (K1: to CHUNK, float32 L for the FP32
    pipes; K2: to MMA_CHUNK, bfloat16 L); np: T's width, the second
    contraction and the result's width, padded to 32 (R is np x np); wt: the
    columns of T that K1 computes, whole PANELs (K2: 0). The block's shared
    memory, in bytes: the band's Canny plane at 0 (K1: BAND_ROWS rows of lde
    floats; K2: a row of lde = BAND_ROWS floats for each image row); at t the
    Canny strips, then T (2 BAND_ROWS x ldt bfloat16); `depth` stages of
    MMA_STAGE_BYTES at `stages`: K1's the deepest ring, up to MMA_DEPTH, that
    still lets two blocks share an SM (2 where none does), K2's 2."""
    bands: int
    kp: int
    np: int
    wt: int
    lde: int
    ldt: int
    t: int
    stages: int
    depth: int
    smem_bytes: int

    @property
    def layout(self) -> tuple:
        """MmaLayout's fields, in the order the launch takes them."""
        return (self.kp, self.np, self.wt, self.lde, self.ldt, self.t, self.stages,
                self.depth)

    @property
    def l_shape(self) -> tuple:
        """Shape of the padded Lr, Li (K1: Ar, Ai; K2: Br^T, Bi^T)."""
        return (self.bands * BAND_ROWS, self.kp)

    @property
    def r_shape(self) -> tuple:
        """Shape of the padded Rr, Ri (K1: Br^T, Bi^T; K2: Ar, Ai)."""
        return (self.np, self.np)


@functools.lru_cache(maxsize=None)
def mma_geometry(c: int, h: int, w: int, backward: bool) -> MmaGeometry:
    """The bfloat16 K1's (backward=False) or K2's block geometry for C
    channels of H x W."""
    bh, sw = BAND_ROWS, STRIP_W
    if backward:               # column bands: H and W trade places
        h, w = w, h
        tile = functools.partial(_tile_floats, sw, bh)
        # x (4-pixel halo), summed blur (3), u_gx, u_gy (2), u_summed (1)
        canny = c * tile(4) + tile(3) + 2 * tile(2) + tile(1)
    else:                      # x (2-pixel halo), summed blur (1)
        tile = functools.partial(_tile_floats, bh, sw)
        canny = c * tile(2) + tile(1)
    np_ = _round_up(w, 32)
    ldt = np_ + MMA_PAD        # rows 16 bytes past a multiple of 32: ldmatrix without conflicts
    t = 4 * bh * _round_up(w, 8)
    stages = t + _round_up(2 * 2 * bh * ldt, 128)
    need = lambda depth: max(t + 4 * canny, stages + depth * MMA_STAGE_BYTES)
    # two blocks an SM, 128 bytes each left for the kernels' static shared memory
    two_a_sm = (SM_SMEM_BYTES - 2 * BLOCK_RESERVED_BYTES) // 2 - 128
    depth = max([d for d in range(2, MMA_DEPTH + 1)
                 if not backward and need(d) <= two_a_sm] or [2])
    return MmaGeometry(bands=-(-h // bh), kp=_round_up(h, MMA_CHUNK if backward else CHUNK),
                       np=np_, wt=0 if backward else _round_up(w, PANEL),
                       lde=bh if backward else _round_up(w, 8), ldt=ldt, t=t,
                       stages=stages, depth=depth, smem_bytes=need(depth))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class FusedConsts:
    """Static operands of the front-end (models/ee_frontend.EEConfig)."""
    r: int
    eps: float
    w: float
    alpha: float
    high: float        # already scaled to [0, 1]
    sigma: float
    square: bool


_OPERATORS: dict = {}
_TAPS: dict = {}


def gaussian_taps(sigma: float, device, dtype=torch.float32) -> torch.Tensor:
    """The 3x3 Gaussian's taps (9,) on `device` as float32, their values
    rounded to `dtype` (the JAX kernel's taps in x's dtype), built once per
    key."""
    key = (sigma, str(device), dtype)
    if key not in _TAPS:
        taps = gaussian_kernel(3, 0.0, sigma).reshape(9).copy()
        _TAPS[key] = torch.from_numpy(taps).to(dtype).float().to(device)
    return _TAPS[key]


def operators(h: int, w: int, r: int, sigma: float, device) -> tuple:
    """(Ar, Ai, Br, Bi, gaussian taps (9,)) on `device`, built once per
    (H, W, r, sigma, device) from the numpy constructors."""
    key = (h, w, r, sigma, str(device))
    if key not in _OPERATORS:
        mats = [torch.from_numpy(m).to(device) for m in _hfs_axis_operators(h, w, r)]
        _OPERATORS[key] = (*mats, gaussian_taps(sigma, device))
    return _OPERATORS[key]


def band_operators(h: int, w: int, r: int, backward: bool, device,
                   dtype=torch.float32) -> tuple:
    """The operators (Lr, Li, Rr, Ri) that K1 (K2 with `backward`) reads for
    `dtype`, contiguous and zero-padded to its geometry's shapes, built once
    per key on `device`. float32: K1's (Ar, Ai, Br^T, Bi^T), K2's (Ar^T,
    Ai^T, Br, Bi), padded to band_geometry's. bfloat16: rounded to bfloat16,
    padded to mma_geometry's: K1's (Ar, Ai) as float32 for its FP32 first
    product and (Br^T, Bi^T) as bfloat16; K2's (Br^T, Bi^T, Ar, Ai), those
    of its column bands, as bfloat16."""
    key = ("band", h, w, r, backward, str(device), dtype)
    if key not in _OPERATORS:
        ar, ai, br, bi = (torch.from_numpy(m).to(dtype).to(device)
                          for m in _hfs_axis_operators(h, w, r))
        if dtype == torch.float32:
            geo = band_geometry(1, h, w, backward)
            mats = (ar.T, ai.T, br, bi) if backward else (ar, ai, br.T, bi.T)
        else:
            geo = mma_geometry(1, h, w, backward)
            mats = (br.T, bi.T, ar, ai) if backward else (ar.float(), ai.float(), br.T, bi.T)

        def padded(m, shape):
            out = m.new_zeros(shape)
            out[:m.shape[0], :m.shape[1]] = m
            return out

        _OPERATORS[key] = (*(padded(m, geo.l_shape) for m in mats[:2]),
                           *(padded(m, geo.r_shape) for m in mats[2:]))
    return _OPERATORS[key]


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def ee_fused_fwd_plain(x, stripes, sq_delta, k: FusedConsts):
    """Transcription of `_fwd_kernel`: returns (out, y), in x's dtype
    (float32 or bfloat16, with the JAX kernel's casts: see hfs_nchw and
    canny._blur_sobel_magnitude_nchw). Differentiable, with JAX's gradient
    conventions (clip ties 0.5, the To_compare window), so torch autograd of
    it is a second oracle of the float32 adjoint."""
    ar, ai, br, bi, _ = operators(x.shape[2], x.shape[3], k.r, k.sigma, x.device)
    xs = square_forward_nchw(x, stripes, sq_delta, k.eps) if k.square else x
    edge = canny_step125_nchw(x, k.high, sigma=k.sigma, alpha=k.alpha)
    y = hfs_nchw(xs, ar, ai, br, bi) + weak_scalar(k.w, x.dtype) * edge
    return clip01(y), y


def _clip_mask(v):
    """d clip(v, 0, 1)/dv: 1 inside, 0.5 at an exact bound, 0 outside."""
    inside = ((v > 0.0) & (v < 1.0)).to(v.dtype)
    edge = ((v == 0.0) | (v == 1.0)).to(v.dtype)
    return inside + 0.5 * edge


def _max_masks(a, b):
    tie = (a == b).to(a.dtype)
    return (a > b).to(a.dtype) + 0.5 * tie, (b > a).to(a.dtype) + 0.5 * tie


def _min_masks(a, b):
    tie = (a == b).to(a.dtype)
    return (a < b).to(a.dtype) + 0.5 * tie, (b < a).to(a.dtype) + 0.5 * tie


def _square_backward(u_xs, x, stripes, sq_delta, eps):
    """Adjoint of square_forward_nchw w.r.t. x, through the perturbation
    chain and the projection bounds x +- eps, in x's dtype."""
    eps = weak_scalar(eps, x.dtype)
    t1 = x + eps * stripes
    t3 = clip01(t1) + sq_delta
    xl, xh = x - eps, x + eps
    t4 = torch.maximum(t3, xl)
    t5 = torch.minimum(t4, xh)
    u_t5 = u_xs * _clip_mask(t5)
    d_t4, d_xh = _min_masks(t4, xh)
    u_t4 = u_t5 * d_t4
    d_t3, d_xl = _max_masks(t3, xl)
    u_t1 = u_t4 * d_t3 * _clip_mask(t1)
    return u_t1 + u_t5 * d_xh + u_t4 * d_xl


def _edge_shift_adjoint(u, dh: int, dw: int):
    """Adjoint of the edge-replicated read x[clamp(h + dh), clamp(w + dw)]:
    the interior shifts back with zero fill and the border row/column
    absorbs the reads that the clamp folded onto it."""
    def axis_adjoint(v, d, dim):
        if d == 0:
            return v
        n = v.shape[dim]
        out = torch.zeros_like(v)
        if d > 0:
            out.narrow(dim, d, n - d).copy_(v.narrow(dim, 0, n - d))
            out.narrow(dim, n - 1, 1).add_(v.narrow(dim, n - d, d).sum(dim, keepdim=True))
        else:
            d = -d
            out.narrow(dim, 0, n - d).copy_(v.narrow(dim, d, n - d))
            out.narrow(dim, 0, 1).add_(v.narrow(dim, 0, d).sum(dim, keepdim=True))
        return out

    return axis_adjoint(axis_adjoint(u, dh, 2), dw, 3)


def _apply_taps_adjoint(u, kernel):
    """The adjoint of stencil2d_nchw(., kernel, "edge"), tap by tap in the
    taps' row-major order, each tap taken in u's dtype (JAX's weak typing)
    and each product and sum rounded to it."""
    out = None
    for dh, dw, c in stencil_taps(kernel):
        term = weak_scalar(c, u.dtype) * _edge_shift_adjoint(u, dh, dw)
        out = term if out is None else out + term
    return out


def ee_fused_bwd_plain(u, x, stripes, sq_delta, y, k: FusedConsts):
    """Transcription of `_bwd_kernel`: dx from the cotangent u of `out`, in
    x's dtype. bfloat16 takes the JAX kernel's casts: U B summed in float32
    and rounded before A^T (U B), the HFS adjoint and the square chain in
    bfloat16, the channel sum of U in float32 rounded once, the Canny
    adjoint in float32, and dx_hfs + dx_canny summed in float32 and rounded
    once."""
    ar, ai, br, bi, _ = operators(x.shape[2], x.shape[3], k.r, k.sigma, x.device)
    c, dt = x.shape[1], x.dtype
    u_y = u * _clip_mask(y)
    if dt == torch.float32:
        dxs = ar.T @ (u_y @ br) - ai.T @ (u_y @ bi)
    else:
        uf = u_y.float()
        r = lambda m: m.to(dt).float()
        adj = lambda a, b: r(a).T @ (uf @ r(b)).to(dt).float()
        dxs = (adj(ar, br) - adj(ai, bi)).to(dt)
    dx_hfs = (_square_backward(dxs, x, stripes, sq_delta, k.eps)
              if k.square else dxs)

    # Canny branch: recompute the forward, then the Canny pair's adjoint
    gx, gy, mag = _blur_sobel_magnitude_nchw(x, k.sigma)
    u_edge = weak_scalar(k.w, dt) * _channel_sum(u_y.float()).to(dt)
    dx_canny = canny_fused_bwd_plain(u_edge.float(), mag, gx, gy, c, k.high,
                                     k.sigma, k.alpha)
    return (dx_hfs.float() + dx_canny).to(dt)


def canny_fused_fwd_plain(x, high: float, sigma: float, alpha: float):
    """Transcription of `_canny_fwd_kernel`: (out, mag, gx, gy), each
    (B, 1, H, W) in x's dtype. A bfloat16 x takes the JAX kernel's casts:
    every operation in bfloat16 but the channel sum (float32, rounded once),
    the thresholds rounded to bfloat16 (weak typing). `out` carries the
    To_compare gradient, so torch autograd of it is a second oracle of the
    adjoint."""
    dt = x.dtype
    gx, gy, mag = _blur_sobel_magnitude_nchw(x, sigma, wide=False)
    mag_m = torch.where(mag < weak_scalar(alpha, dt), torch.zeros_like(mag), mag)
    return to_compare(mag_m, weak_scalar(high, dt)), mag, gx, gy


def canny_fused_bwd_plain(u, mag, gx, gy, channels: int, high: float,
                          sigma: float, alpha: float):
    """Transcription of `_canny_bwd_kernel`: dx (B, C, H, W) from the
    cotangent u (B, 1, H, W) of `out` and the residuals, in their dtype
    (bfloat16: each operation rounded, the thresholds and taps rounded)."""
    dt = mag.dtype
    alpha, high = weak_scalar(alpha, dt), weak_scalar(high, dt)
    zero = torch.zeros_like(mag)
    mag_m = torch.where(mag < alpha, zero, mag)
    keep = (mag_m > high) & (mag_m <= 1.001) & (mag >= alpha)
    u_mag = torch.where(keep, u, zero)
    mag_zero = mag == 0.0
    inv_mag = torch.where(mag_zero, zero,
                          1.0 / torch.where(mag_zero, torch.ones_like(mag), mag))
    sob = sobel_kernel(3)
    cdiv = torch.full((), float(channels), dtype=dt, device=mag.device)
    u_summed = (_apply_taps_adjoint(u_mag * gx * inv_mag, sob)
                + _apply_taps_adjoint(u_mag * gy * inv_mag, sob.T)) / cdiv
    # every channel gets the blur's adjoint of the same plane
    plane = _apply_taps_adjoint(u_summed, gaussian_kernel(3, 0.0, sigma))
    b, _, h, w = plane.shape
    return plane.expand(b, channels, h, w).contiguous()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind csrc/ee_fused.cu."""
    from . import build
    lib = build.load("ee_fused")
    c = lib.lib
    band = [ctypes.POINTER(_I), _I, ctypes.c_size_t, _P]   # layout, bands, bytes, stream
    for name in ("ee_fused_fwd", "ee_fused_fwd_bf16"):
        getattr(c, name).argtypes = [_P] * 10 + [_I] * 4 + [_F] * 4 + [_I] + band
        getattr(c, name).restype = _I
    for name in ("ee_fused_bwd", "ee_fused_bwd_bf16"):
        getattr(c, name).argtypes = [_P] * 11 + [_I] * 4 + [_F] * 4 + [_I] + band
        getattr(c, name).restype = _I
    tiles = [_I, _I, ctypes.c_size_t, _P]                  # tiles_w, tiles_h, bytes, stream
    for name in ("canny_fused_fwd", "canny_fused_bwd", "canny_fused_fwd_bf16",
                 "canny_fused_bwd_bf16"):
        getattr(c, name).argtypes = [_P] * 6 + [_I] * 4 + [_F] * 2 + tiles
        getattr(c, name).restype = _I
    c.ee_fused_error_string.argtypes = [_I]
    c.ee_fused_error_string.restype = ctypes.c_char_p
    return lib


def kernel_geometry(c: int, h: int, w: int, backward: bool, dtype):
    """The block geometry that K1 (K2 with `backward`) launches with for a
    (B, C, H, W) tensor of `dtype`: band_geometry's for float32,
    mma_geometry's for bfloat16."""
    if dtype == torch.bfloat16:
        return mma_geometry(c, h, w, backward)
    return band_geometry(c, h, w, backward)


def _check(x, stripes, sq_delta, k: FusedConsts, *same_as_x):
    """Raise on what K1 (K2 with u and y given) does not take; return the
    block geometry."""
    if x.device.type != "cuda":
        raise ValueError(f"the fused front-end kernel takes CUDA tensors, got {x.device}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4
            or not x.is_contiguous()):
        raise ValueError("x must be a contiguous (B, C, H, W) float32 or bfloat16 "
                         f"tensor (got {x.dtype}, shape {tuple(x.shape)})")
    b, c, h, w = x.shape
    # a block holds its band's planes and C channels of the Canny halo tile;
    # K1 refuses what K2 could not take, so no step fails in its backward
    need = max(kernel_geometry(c, h, w, bwd, x.dtype).smem_bytes for bwd in (False, True))
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{c} channels at {h}x{w} need {need} bytes of shared "
                         f"memory per block, above the {MAX_SMEM_BYTES} a block "
                         "may use")
    for t in same_as_x:
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError("u and y must match x in shape, dtype, device and "
                             "contiguity")
    if k.square:
        for t, shape in ((stripes, (b, c, 1, w)), (sq_delta, (1, c, h, w))):
            if (t is None or tuple(t.shape) != shape or t.dtype != x.dtype
                    or t.device != x.device or not t.is_contiguous()):
                raise ValueError(f"square draws must be contiguous {shape} "
                                 f"tensors of x's dtype on {x.device}")
    return kernel_geometry(c, h, w, bool(same_as_x), x.dtype)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _band_args(geo) -> tuple:
    """(layout, bands, bytes) as K1/K2's entry points take them."""
    return (_I * len(geo.layout))(*geo.layout), geo.bands, geo.smem_bytes


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.lib.ee_fused_error_string(err).decode()}")


def _entry(name: str, dtype) -> str:
    """The entry point and launch counter of a kernel for `dtype`."""
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


def _scalars(k: FusedConsts, dtype) -> tuple:
    """(eps, w, alpha, high) as the kernels take them: eps and w rounded to
    x's dtype (JAX's weak typing), the thresholds float32."""
    return (weak_scalar(k.eps, dtype), weak_scalar(k.w, dtype), k.alpha, k.high)


def ee_fused_fwd(x, stripes, sq_delta, k: FusedConsts):
    """K1: (out, y) of the front-end; plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ee_fused_fwd_plain(x, stripes, sq_delta, k)
    geo = _check(x, stripes, sq_delta, k)
    lib = _library()
    b, c, h, w = x.shape
    lr, li, rr, ri = band_operators(h, w, k.r, False, x.device, x.dtype)
    taps = gaussian_taps(k.sigma, x.device, x.dtype)
    out, y = torch.empty_like(x), torch.empty_like(x)
    name = _entry("ee_fused_fwd", x.dtype)
    with torch.cuda.device(x.device):
        err = getattr(lib.lib, name)(
            _ptr(x), _ptr(stripes), _ptr(sq_delta), _ptr(lr), _ptr(li),
            _ptr(rr), _ptr(ri), _ptr(taps), _ptr(out), _ptr(y), b, c, h, w,
            *_scalars(k, x.dtype), int(k.square), *_band_args(geo),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return out, y


def ee_fused_bwd(u, x, stripes, sq_delta, y, k: FusedConsts):
    """K2: dx from the cotangent u of `out`; plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ee_fused_bwd_plain(u, x, stripes, sq_delta, y, k)
    geo = _check(x, stripes, sq_delta, k, u, y)
    lib = _library()
    b, c, h, w = x.shape
    lr, li, rr, ri = band_operators(h, w, k.r, True, x.device, x.dtype)
    taps = gaussian_taps(k.sigma, x.device, x.dtype)
    dx = torch.empty_like(x)
    name = _entry("ee_fused_bwd", x.dtype)
    with torch.cuda.device(x.device):
        err = getattr(lib.lib, name)(
            _ptr(u), _ptr(x), _ptr(stripes), _ptr(sq_delta), _ptr(y),
            _ptr(lr), _ptr(li), _ptr(rr), _ptr(ri), _ptr(taps), _ptr(dx),
            b, c, h, w, *_scalars(k, x.dtype), int(k.square),
            *_band_args(geo), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return dx


# K1 as an operator of the dispatcher, ee_tpu_torch::ee_fused_fwd, so that
# torch.export and other tracers keep it as one node of the graph (they
# cannot trace into a ctypes launch). Its CUDA implementation is K1's
# launch, its CPU implementation the plain version; its fake implementation
# only allocates, so the checks on shapes (_check) run in the real ones and
# a symbolic batch is not fixed to one size. It is registered through
# torch.library.Library rather than torch.library.custom_op: custom_op
# wraps each implementation in torch._disable_dynamo, whose first call
# imports torch._dynamo, which took ~9 s of a training process's first step
# on the H100's host (PERF.md).
_LIB = torch.library.Library("ee_tpu_torch", "DEF")
_LIB.define("ee_fused_fwd(Tensor x, Tensor? stripes, Tensor? sq_delta, int r, float eps, "
            "float w, float alpha, float high, float sigma, bool square) -> (Tensor, Tensor)")


def _ee_fused_fwd_op_cuda(x, stripes, sq_delta, r, eps, w, alpha, high, sigma, square):
    return ee_fused_fwd(x, stripes, sq_delta,
                        FusedConsts(r, eps, w, alpha, high, sigma, square))


def _ee_fused_fwd_op_cpu(x, stripes, sq_delta, r, eps, w, alpha, high, sigma, square):
    return ee_fused_fwd_plain(x, stripes, sq_delta,
                              FusedConsts(r, eps, w, alpha, high, sigma, square))


_LIB.impl("ee_fused_fwd", _ee_fused_fwd_op_cuda, "CUDA")
_LIB.impl("ee_fused_fwd", _ee_fused_fwd_op_cpu, "CPU")


@torch.library.register_fake("ee_tpu_torch::ee_fused_fwd", lib=_LIB)
def _ee_fused_fwd_op_fake(x, stripes, sq_delta, r, eps, w, alpha, high, sigma, square):
    return torch.empty_like(x), torch.empty_like(x)


# K1's (out, y) through the dispatcher, the constants given one by one
# (FusedConsts' fields)
ee_fused_fwd_op = torch.ops.ee_tpu_torch.ee_fused_fwd.default


class EEFused(torch.autograd.Function):
    """K1 in forward (through the operator ee_tpu_torch::ee_fused_fwd), K2
    in backward; the draws get no gradient (they are random constants
    w.r.t. the attack)."""

    @staticmethod
    def forward(ctx, x, stripes, sq_delta, k: FusedConsts):
        out, y = ee_fused_fwd_op(x, stripes, sq_delta, *dataclasses.astuple(k))
        ctx.save_for_backward(x, stripes, sq_delta, y)
        ctx.k = k
        return out

    @staticmethod
    def backward(ctx, u):
        x, stripes, sq_delta, y = ctx.saved_tensors
        dx = ee_fused_bwd(u.contiguous(), x, stripes, sq_delta, y, ctx.k)
        return dx, None, None, None


def ee_fused(x, stripes, sq_delta, k: FusedConsts):
    """Differentiable front-end of a (B, C, H, W) batch; `stripes` and
    `sq_delta` are None when k.square is False."""
    return EEFused.apply(x, stripes, sq_delta, k)


# --------------------------------------------------------------------------
# K3a/K3b: the Canny-only pair
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CannyGeometry:
    """Where K3a/K3b put a (C, H, W) problem: tiles_h x tiles_w tiles of
    rows x cols pixels per image (CANNY_ROWS x CANNY_COLS in float32,
    CANNY_BF16_ROWS x CANNY_BF16_COLS in bfloat16), one block each, tile
    (i, j) owning rows from i * rows and columns from j * cols; the dynamic
    shared memory of a K3a block (C x tiles and the summed blur's) and of a
    K3b block (u, mag, gx, gy and u_summed, whatever C); and the most
    channels a K3a block holds, above which both wrappers refuse."""
    tiles_h: int
    tiles_w: int
    fwd_smem_bytes: int
    bwd_smem_bytes: int
    max_channels: int


@functools.lru_cache(maxsize=None)
def canny_geometry(c: int, h: int, w: int, dtype=torch.float32) -> CannyGeometry:
    """K3a's and K3b's grid and shared memory for C channels of H x W in
    `dtype`. Bytes of a tile: x's and K3b's u, mag, gx, gy; the summed
    blur's and u_summed's."""
    if dtype == torch.bfloat16:
        rows, cols = CANNY_BF16_ROWS, CANNY_BF16_COLS
        x_tile = 2 * (rows + 4) * (cols + 2 * TILE2_PAD)
        s_tile = 2 * (rows + 2) * (cols + MID2_PAD)
    else:
        rows, cols = CANNY_ROWS, CANNY_COLS
        x_tile = 4 * _tile_floats(rows, cols, 2)
        s_tile = 4 * _tile_floats(rows, cols, 1)
    return CannyGeometry(tiles_h=-(-h // rows), tiles_w=-(-w // cols),
                         fwd_smem_bytes=c * x_tile + s_tile,
                         bwd_smem_bytes=4 * x_tile + s_tile,
                         max_channels=(MAX_SMEM_BYTES - s_tile) // x_tile)


def _check_canny(x, *planes) -> CannyGeometry:
    """x: the (B, C, H, W) image of K3a, or the dx that K3b writes; planes:
    (B, 1, H, W) each, of x's dtype. Raises on what the kernels do not take
    (the device last, so that any host can test the rest); returns the
    geometry."""
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4
            or not x.is_contiguous()):
        raise ValueError("x and dx must be contiguous (B, C, H, W) float32 or bfloat16 "
                         f"tensors (got {x.dtype}, shape {tuple(x.shape)})")
    b, c, h, w = x.shape
    geo = canny_geometry(c, h, w, x.dtype)
    if c > geo.max_channels:
        raise ValueError(f"{c} channels need {geo.fwd_smem_bytes} bytes of shared memory "
                         f"per block, above {MAX_SMEM_BYTES}: the Canny kernels take at "
                         f"most {geo.max_channels}")
    for t in planes:
        if (tuple(t.shape) != (b, 1, h, w) or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"u, mag, gx and gy must be contiguous {x.dtype} "
                             f"{(b, 1, h, w)} tensors on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"the Canny kernels take CUDA tensors, got {x.device}")
    return geo


def _canny_scalars(alpha: float, high: float, dtype) -> tuple:
    """(alpha, high) as K3a/K3b take them: rounded to the tensors' dtype, as
    JAX's weak typing rounds them in the Canny-only kernel's comparisons."""
    return weak_scalar(alpha, dtype), weak_scalar(high, dtype)


def canny_fused_fwd(x, high: float, sigma: float, alpha: float):
    """K3a: (out, mag, gx, gy) of a (B, C, H, W) float32 or bfloat16 batch,
    in its dtype; plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return canny_fused_fwd_plain(x, high, sigma, alpha)
    geo = _check_canny(x)
    lib = _library()
    b, c, h, w = x.shape
    out, mag, gx, gy = (x.new_empty((b, 1, h, w)) for _ in range(4))
    name = _entry("canny_fused_fwd", x.dtype)
    with torch.cuda.device(x.device):
        err = getattr(lib.lib, name)(
            _ptr(x), _ptr(gaussian_taps(sigma, x.device, x.dtype)), _ptr(out), _ptr(mag),
            _ptr(gx), _ptr(gy), b, c, h, w, *_canny_scalars(alpha, high, x.dtype),
            geo.tiles_w, geo.tiles_h, geo.fwd_smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return out, mag, gx, gy


def canny_fused_bwd(u, mag, gx, gy, channels: int, high: float, sigma: float,
                    alpha: float):
    """K3b: dx (B, channels, H, W) from the cotangent u (B, 1, H, W) of
    `out`, in the residuals' dtype; plain version on a CPU tensor."""
    if mag.device.type == "cpu":
        return canny_fused_bwd_plain(u, mag, gx, gy, channels, high, sigma, alpha)
    b, _, h, w = mag.shape
    dx = mag.new_empty((b, channels, h, w))
    geo = _check_canny(dx, u, mag, gx, gy)
    lib = _library()
    name = _entry("canny_fused_bwd", mag.dtype)
    with torch.cuda.device(mag.device):
        err = getattr(lib.lib, name)(
            _ptr(u), _ptr(mag), _ptr(gx), _ptr(gy),
            _ptr(gaussian_taps(sigma, mag.device, mag.dtype)), _ptr(dx), b, channels,
            h, w, *_canny_scalars(alpha, high, mag.dtype), geo.tiles_w, geo.tiles_h,
            geo.bwd_smem_bytes, torch.cuda.current_stream(mag.device).cuda_stream)
    _raise_on(err, lib, name)
    LAUNCHES[name] += 1
    return dx


class CannyFused(torch.autograd.Function):
    """K3a in forward, K3b in backward, on (B, C, H, W) -> (B, 1, H, W)."""

    @staticmethod
    def forward(ctx, x, high: float, sigma: float, alpha: float):
        out, mag, gx, gy = canny_fused_fwd(x, high, sigma, alpha)
        ctx.save_for_backward(mag, gx, gy)
        ctx.consts = (x.shape[1], high, sigma, alpha)
        return out

    @staticmethod
    def backward(ctx, u):
        mag, gx, gy = ctx.saved_tensors
        return canny_fused_bwd(u.contiguous(), mag, gx, gy, *ctx.consts), None, None, None


def canny_step125_fused(img, high_threshold: float, sigma: float = 1.0,
                        alpha: float = 0.0):
    """The step125 edge map of an NHWC batch, (B, H, W, 1), on the K3 pair:
    the signature of the JAX `canny_step125_fused` without its TPU
    `batch_tile`."""
    x = img.permute(0, 3, 1, 2).contiguous()
    out = CannyFused.apply(x, float(high_threshold), float(sigma), float(alpha))
    return out.permute(0, 2, 3, 1)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bfloat16 ulps of the larger magnitude of the two, as
    float32: how the bfloat16 forms of K1/K2 are held to their plain
    versions and the plain versions to JAX."""
    a, b = got.float(), want.float()
    exponent = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), exponent - 8)
