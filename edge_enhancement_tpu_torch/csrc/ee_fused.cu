// Fused edge-enhancement front-end for Hopper (sm_90a): forward K1 and its
// exact adjoint K2, and the Canny-only pair K3a/K3b, all four on one set of
// halo-tile Canny functions.
//
// K1/K2 replace the Pallas TPU kernels edge_enhancement_tpu/ops/pallas/
// ee_fused.py::_fwd_kernel and ::_bwd_kernel. Per image (all C planes):
//
//   xs   = add_square(x)               (n_queries=1; draws made outside)
//   hfs  = Ar xs Br^T - Ai xs Bi^T     (per channel plane, A contraction first)
//   edge = canny_step125(x)            (clean x: blur, channel sum, Sobel / C,
//                                       zero-safe |g|, alpha mask, > high)
//   y    = hfs + w edge,  out = clip(y, 0, 1)
//
// K2 takes (u, x, y) and returns dx under JAX's subgradient conventions
// (clip and min/max split exact ties 0.5/0.5), the To_compare window
// (high, 1.001], the alpha gate, 1/|g| := 0 at |g| = 0 and the adjoints of
// the edge-replicated stencils. Its HFS adjoint is
// dxs = (Ar^T U) Br - (Ai^T U) Bi with U = u clip'(y): it contracts over H
// first, where the plain version computes Ar^T (U Br); the two round
// differently, well inside the tests' 1e-4.
//
// What bounds them: the four HFS products, 4 H W (H + W) FLOPs a plane, on
// the FP32 pipes (9.39 us at 100 x 3 x 64 x 64 against 4.46 us of bytes).
// Design: a block owns a band of kBandRows image rows of one image (grid:
// bands x images, 200 blocks of 256 threads at 100 x 64 px, all resident at
// once), so shared memory depends on the band, W and C, not on H^2: any
// H x W runs, with ragged bands and columns masked. Per block:
//   1. the band's Canny branch, once for all channels, in strips of
//      kStripW columns (the Canny tile functions below). K1: canny_tile,
//      the edge map. K2: mag, gx, gy recomputed on the band plus 2 rows from
//      a 4-pixel x halo, u_edge = w sum_c U, the gate, then
//      canny_adjoint_tail: one plane, added to every channel's dx.
//   2. per channel, T = [Lr; Li]_band P (2 kBandRows x W, contracting over
//      H), then Tr Rr - Ti Ri (contracting over W), then the epilogue. P is
//      the plane, built as it is staged (K1: the square chain of x; K2: U).
//      K1 takes L = A, R = B^T; K2 L = A^T, R = B: the wrapper caches them,
//      transposed and zero-padded to whole chunks and panels, on the device
//      once, so every operator copy is a 16-byte cp.async with no mask.
//   Both products stream kChunk-deep chunks through two shared-memory
//   stages (cp.async for the operators, a register prefetch for the plane,
//   whose transform needs the threads), one barrier a chunk. A thread
//   holds a 4 x 4 register tile whose rows are kBandRows / 4 apart; a warp
//   holds 4 consecutive rows and 8 column groups, so the row strides of the
//   operator chunk (kChunk + 4) and of T (4 more than a multiple of 64) put
//   its 4 row reads on distinct banks and its column reads are 128
//   contiguous bytes. In the second product half the threads take Tr Rr and
//   half Ti Ri; an exchange through shared memory forms pr - pi, as the
//   plain version does, each half finishing half of the tile's rows.
// On the card the kernels stay well above that bound (PERF.md): at 64 px a
// block's work is short, so load latency, barriers and the 2-or-1 blocks an
// SM (200 blocks on 132 SMs) weigh as much as the FP32 pipes.
//
// K3a/K3b replace ::_canny_fwd_kernel and ::_canny_bwd_kernel: the edge map
// alone with the residuals mag, gx, gy, and its adjoint from them. A block
// owns a kCannyRows x kCannyCols tile of one image. Bytes bound them (3.42 us
// each at 100 x 3 x 64 x 64): the stencils are a few dozen FP32 operations a
// pixel.
//
// All four run one copy of the Canny code, on tiles that hold a plane and
// its halo in shared memory: staged by cp.async, 16 bytes at a time where the
// row allows, the halo holding the edge's reads (x) or zeros (cotangents), so
// no tap clamps; the last stage on quads, 4 pixels a thread, read and
// written 16 bytes at a time. The forward rounds every product and sum on
// its own (__fmul_rn, __fadd_rn: no FMA contraction) in the tap order of the
// PyTorch composition (row-major), so the edge maps of K1, K3a and the plain
// version agree exactly: `mag > high` flips on one-ulp differences. The
// square chain does the same, since its clips decide gradient ties. The HFS products stay on the FP32 pipes.
//
// K1 and K2 also take bfloat16, as the JAX kernels compute in x's dtype (the
// bf16 policy of the fast-AT recipes). A number policy (F32, BF16 below)
// loads and stores the tensors' type and rounds to bfloat16 at exactly the
// points where the JAX kernel's dtype is bfloat16 (`_fwd_kernel`,
// `_bwd_kernel` and their helpers in edge_enhancement_tpu/ops/pallas/
// ee_fused.py): each product and sum of the blur, the Sobel and the square
// chain; the channel sum (summed in float32, rounded once); the HFS
// intermediate A X (K1) and U B (K2) and the float32 difference of the two
// sandwiches; w * edge and y; dx = dx_hfs + dx_canny summed in float32 and
// rounded once. Everything else computes in float32 registers, as the JAX
// kernel's float32 accumulations and its float32 magnitude chain and Canny
// adjoint do. Shared memory holds float32 either way, so the block layout is
// the float32 one. JAX contracts K2's adjoint over W first (U B, then A^T),
// so the bfloat16 K2 works on the transposed problem, dx^T = B^T U^T A: a
// block owns a band of kBandRows image columns, its HFS products read the
// planes transposed, and its Canny branch walks the column band in strips of
// kStripW rows (band_canny_adjoint<true>).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

struct Params {
  int B, C, H, W;
  float eps, w, alpha, high;
  int square;
};

// The number policies of K1/K2: the tensors' element type, its loads and
// stores through float32, and r(v), the rounding of a float32 result to what
// a bfloat16 operation gives (products and sums of two bfloat16 values are
// exact in float32, so rounding the float32 result is the bfloat16 result).
struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float r(float v) { return v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(const T* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(T* p, float v) { *p = __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// d clip(v, 0, 1) / dv: 1 inside, 0.5 at an exact bound, 0 outside.
__device__ __forceinline__ float clip_mask(float v) {
  if (v > 0.f && v < 1.f) return 1.f;
  if (v == 0.f || v == 1.f) return 0.5f;
  return 0.f;
}

struct Grad {
  float gx, gy, mag;
};

__device__ __forceinline__ float edge_of(float mag, const Params& p) {
  const float mag_m = (mag < p.alpha) ? 0.f : mag;
  return (mag_m > p.high) ? 1.f : 0.f;
}

template <class P>
__device__ __forceinline__ float square_fwd(float x, float st, float sqd,
                                            float eps) {
  const float t2 = clip01(P::r(__fadd_rn(x, P::r(__fmul_rn(eps, st)))));
  const float t3 = P::r(__fadd_rn(t2, sqd));
  const float t5 = fminf(fmaxf(t3, P::r(__fsub_rn(x, eps))), P::r(__fadd_rn(x, eps)));
  return clip01(t5);
}

// Adjoint of square_fwd w.r.t. x (stripes and delta are constants): through
// the perturbation chain and through the projection bounds x +- eps.
template <class P>
__device__ __forceinline__ float square_bwd(float u, float x, float st,
                                            float sqd, float eps) {
  const float t1 = P::r(__fadd_rn(x, P::r(__fmul_rn(eps, st))));
  const float t2 = clip01(t1);
  const float t3 = P::r(__fadd_rn(t2, sqd));
  const float xl = P::r(__fsub_rn(x, eps)), xh = P::r(__fadd_rn(x, eps));
  const float t4 = fmaxf(t3, xl);
  const float t5 = fminf(t4, xh);
  const float u_t5 = u * clip_mask(t5);
  const float tie_min = (t4 == xh) ? 0.5f : 0.f;
  const float d_t4 = (t4 < xh ? 1.f : 0.f) + tie_min;
  const float d_xh = (xh < t4 ? 1.f : 0.f) + tie_min;
  const float u_t4 = u_t5 * d_t4;
  const float tie_max = (t3 == xl) ? 0.5f : 0.f;
  const float d_t3 = (t3 > xl ? 1.f : 0.f) + tie_max;
  const float d_xl = (xl > t3 ? 1.f : 0.f) + tie_max;
  const float u_t1 = u_t4 * d_t3 * clip_mask(t1);
  // the products by 0, 0.5 and 1 are exact; the sums round
  return P::r(__fadd_rn(P::r(__fadd_rn(u_t1, __fmul_rn(u_t5, d_xh))), __fmul_rn(u_t4, d_xl)));
}

// ---- K1/K2: row bands ------------------------------------------------------
//
// ops/cuda/ee_fused.py (band_geometry) owns the shared-memory layout of a
// block: it passes the offsets and strides below (BandLayout), the bands of
// the grid and the bytes. It mirrors the four constants here as BAND_ROWS,
// BAND_THREADS, CHUNK and STRIP_W, and a CPU test reads them from this file.

constexpr int kBandRows = 32;     // image rows of one block
constexpr int kBandThreads = 256;
constexpr int kChunk = 16;        // contraction depth of one staged chunk
constexpr int kStripW = 64;       // columns of one Canny strip
// blocks an SM must hold (registers <= 65536 / (2 x 256) = 128 a thread), so
// that the flagship's 200 blocks are resident at once (264 slots)
constexpr int kBandMinBlocks = 2;

// A thread's register tile is 4 x 4: the 2 kBandRows product rows make
// kRowGroups groups of 4, and the threads left for each row group take
// kColGroups groups of 4 columns, a panel of kPanel columns.
constexpr int kRowGroups = kBandRows / 2;
constexpr int kColGroups = kBandThreads / kRowGroups;
constexpr int kPanel = 4 * kColGroups;
constexpr int kLdL = kChunk + 4;                   // row stride of an operator chunk
constexpr int kChunkPlane = kChunk * kPanel;       // floats of a plane or R chunk
constexpr int kChunkOps = 2 * kBandRows * kLdL;    // floats of an operator chunk
constexpr int kStage = kChunkOps + kChunkPlane > 2 * kChunkPlane
                           ? kChunkOps + kChunkPlane : 2 * kChunkPlane;
constexpr int kPlanePerThread = kChunkPlane / kBandThreads;  // a thread stages
constexpr int kRowStep = kBandRows / 4;            // row step of a thread's tile
constexpr int kWarpsAcross = kColGroups / 8;       // warps across a panel
static_assert(kBandRows % 16 == 0 && kBandThreads % kRowGroups == 0 &&
                  kColGroups % 8 == 0 && kPanel % kChunk == 0 &&
                  kChunkPlane % kBandThreads == 0,
              "band geometry");

// Shared-memory layout of one block, in floats, from the wrapper: the band's
// Canny plane (K1: edge map; K2: the Canny branch's dx) of kBandRows x wq at
// 0, T (2 kBandRows x ld_t, wt columns computed) at t, then at s one region
// used first by the Canny strips, then by the two HFS stages and the
// exchange of Ti Ri. Operators: L (lr, li) padded to whole bands x hk, R
// (rr, ri) to wk x wt, zeros outside.
struct BandLayout {
  int wq, wt, ld_t, hk, wk;
  int t, s;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i][j] += sum over one chunk of a[i * a_step + k] b[k * LDB + j]: a at
// the thread's first row, b at its first column.
template <int LDB>
__device__ __forceinline__ void fma_chunk(float acc[4][4], const float* a, int a_step,
                                          const float* b) {
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * a_step + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (kk + q) * LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = component(av[i], q);
        acc[i][0] = fmaf(ai, bv.x, acc[i][0]);
        acc[i][1] = fmaf(ai, bv.y, acc[i][1]);
        acc[i][2] = fmaf(ai, bv.z, acc[i][2]);
        acc[i][3] = fmaf(ai, bv.w, acc[i][3]);
      }
    }
  }
}

// Two stages, one barrier a chunk: chunk t + 1 is copied (issue) and its
// plane values loaded into registers (fetch) while chunk t is computed;
// then the values go to the other stage (put).
template <class Issue, class Fetch, class Put, class Compute>
__device__ __forceinline__ void pipeline(int nk, float* stages, int stage_floats,
                                         Issue issue, Fetch fetch, Put put,
                                         Compute compute) {
  issue(0, stages);
  cp_async_commit();
  fetch(0);
  put(stages);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    float* cur = stages + (t & 1) * stage_floats;
    float* nxt = stages + ((t + 1) & 1) * stage_floats;
    const bool more = t + 1 < nk;
    if (more) {
      issue(t + 1, nxt);
      cp_async_commit();
      fetch(t + 1);
    }
    compute(t, cur);
    if (more) put(nxt);
    cp_async_wait_all();
    __syncthreads();
  }
}

// K1's plane: xs = add_square(x) of one channel, 0 off the plane.
template <int Q, class P>
struct SquarePlane {
  using T = typename P::T;
  const T *x, *st, *sqd;
  int H, W;
  float eps;
  int square;
  float vx[Q], vs[Q], vd[Q];
  bool ok[Q];
  __device__ __forceinline__ void load(int q, int h, int w) {
    ok[q] = h < H && w < W;
    if (!ok[q]) return;
    vx[q] = P::load(x + h * W + w);
    if (square) {
      vs[q] = P::load(st + w);
      vd[q] = P::load(sqd + h * W + w);
    }
  }
  __device__ __forceinline__ float value(int q) const {
    if (!ok[q]) return 0.f;
    return square ? square_fwd<P>(vx[q], vs[q], vd[q], eps) : vx[q];
  }
};

// K2's plane: U = u clip'(y) of one channel, 0 off the plane; TRANSPOSED
// reads U^T: (k, j) is pixel (j, k) of the H x W plane.
template <int Q, class P, bool TRANSPOSED>
struct CotangentPlane {
  using T = typename P::T;
  const T *u, *y;
  int H, W;
  float vu[Q], vy[Q];
  bool ok[Q];
  __device__ __forceinline__ void load(int q, int k, int j) {
    const int h = TRANSPOSED ? j : k, w = TRANSPOSED ? k : j;
    ok[q] = h < H && w < W;
    if (!ok[q]) return;
    vu[q] = P::load(u + h * W + w);
    vy[q] = P::load(y + h * W + w);
  }
  __device__ __forceinline__ float value(int q) const {
    return ok[q] ? P::r(vu[q] * clip_mask(vy[q])) : 0.f;
  }
};

// One channel's HFS products on the band [h0, h0 + kBandRows): T = [Lr; Li] P
// into sT (rounded by the policy P), then hfs = Tr Rr - Ti Ri, handed to
// epilogue(r, h, w, hfs) for each pixel (h0 + r, w) of the band that lies in
// the H x W plane.
template <class P, class Plane, class Epilogue>
__device__ __forceinline__ void band_hfs(const BandLayout& L, int H, int W, int h0,
                                         const float* __restrict__ lr,
                                         const float* __restrict__ li,
                                         const float* __restrict__ rr,
                                         const float* __restrict__ ri, float* sT,
                                         float* stages, Plane& plane,
                                         Epilogue epilogue) {
  // A thread's 4 x 4 tile: rows half kBandRows + rq + kRowStep i (i < 4) of
  // the 2 kBandRows product rows (half 0: Lr / Tr, half 1: Li / Ti) and
  // columns 4 cg + j of a panel. A warp holds 4 consecutive rq and 8
  // consecutive cg of one half: its A reads (4 rows, a float4 each) fall on
  // distinct banks, its B reads are 8 contiguous float4, and all its threads
  // read one B (Rr or Ri).
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int WPH = kBandThreads / 64;  // warps per half
  const int half = warp / WPH, wh = warp % WPH;
  const int rq = 4 * (wh / kWarpsAcross) + lane / 8;
  const int cg = 8 * (wh % kWarpsAcross) + lane % 8;
  const int row0 = half * kBandRows + rq;
  float acc[4][4];
  auto zero = [&] {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  };

  // T, panel by panel of its columns, contracting over H
  for (int pc0 = 0; pc0 < L.wt; pc0 += kPanel) {
    auto issue = [&](int t, float* st) {
      const int k0 = t * kChunk;
      for (int e = tid; e < 2 * kBandRows * (kChunk / 4); e += kBandThreads) {
        const int i = e / (kChunk / 4), m = e % (kChunk / 4);
        const float* src =
            (i < kBandRows ? lr : li) + (size_t)(h0 + i % kBandRows) * L.hk + k0 + 4 * m;
        cp_async16(st + i * kLdL + 4 * m, src);
      }
    };
    auto fetch = [&](int t) {
#pragma unroll
      for (int q = 0; q < kPlanePerThread; ++q) {
        const int e = tid + q * kBandThreads;
        plane.load(q, t * kChunk + e / kPanel, pc0 + e % kPanel);
      }
    };
    auto put = [&](float* st) {
#pragma unroll
      for (int q = 0; q < kPlanePerThread; ++q)
        st[kChunkOps + tid + q * kBandThreads] = plane.value(q);
    };
    auto compute = [&](int, const float* st) {
      fma_chunk<kPanel>(acc, st + row0 * kLdL, kRowStep * kLdL,
                        st + kChunkOps + 4 * cg);
    };
    zero();
    pipeline(L.hk / kChunk, stages, kStage, issue, fetch, put, compute);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sT + (row0 + kRowStep * i) * L.ld_t + pc0 + 4 * cg) =
          make_float4(P::r(acc[i][0]), P::r(acc[i][1]), P::r(acc[i][2]), P::r(acc[i][3]));
  }
  __syncthreads();

  // Tr Rr (half 0) and Ti Ri (half 1), panel by panel, contracting over W;
  // an exchange through shared memory forms the difference
  float* sX = stages + 2 * kStage;
  const bool im = half == 1;
  for (int pc0 = 0; pc0 < W; pc0 += kPanel) {
    auto issue = [&](int t, float* st) {
      const int k0 = t * kChunk;
      constexpr int per_row = kPanel / 4, per_op = kChunk * per_row;
      for (int e = tid; e < 2 * per_op; e += kBandThreads) {
        const int s = e / per_op, k = (e % per_op) / per_row, m = e % per_row;
        const float* src = (s ? ri : rr) + (size_t)(k0 + k) * L.wt + pc0 + 4 * m;
        cp_async16(st + s * kChunkPlane + k * kPanel + 4 * m, src);
      }
    };
    auto compute = [&](int t, const float* st) {
      fma_chunk<kPanel>(acc, sT + row0 * L.ld_t + t * kChunk, kRowStep * L.ld_t,
                        st + (im ? kChunkPlane : 0) + 4 * cg);
    };
    zero();
    pipeline(L.wk / kChunk, stages, kStage, issue, [](int) {}, [](float*) {},
             compute);
    // each half hands the other the rows it does not finish: half 0 ends
    // tile rows 0 and 1 (pr - pi), half 1 rows 2 and 3
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((i < 2) == im)
        *reinterpret_cast<float4*>(sX + (rq + kRowStep * i) * kPanel + 4 * cg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((i < 2) == im) continue;
      const int r = rq + kRowStep * i, h = h0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = pc0 + 4 * cg + j;
        const float other = sX[r * kPanel + 4 * cg + j];
        if (h < H && w < W) epilogue(r, h, w, im ? other - acc[i][j] : acc[i][j] - other);
      }
    }
  }
}

// ---- The Canny tile functions (K1, K2, K3a, K3b) ---------------------------
//
// A Tile holds rows [h0 - HALO, h0 + ROWS + HALO) and columns
// [w0 - 4, w0 + COLS + 4) of one plane around the ROWS x COLS pixels at
// (h0, w0), COLS + 8 floats a row: pixel (h0 + r, w0 + s) sits at at(r, s),
// and columns w0, w0 + 4, ... start on 16 bytes, so that rows are staged and
// quads read 16 bytes at a time. ops/cuda/ee_fused.py sizes shared memory by
// this layout (TILE_PAD, _tile_floats); a CPU test reads the padding, each
// function's halos and its count of tiles from this file.
template <int ROWS, int COLS, int HALO>
struct Tile {
  static_assert(COLS % 4 == 0 && HALO <= 4, "tile");
  static constexpr int kTileRows = ROWS, kCols = COLS, kHalo = HALO;
  static constexpr int kRows = ROWS + 2 * HALO;
  static constexpr int kLd = COLS + 8;
  static constexpr int kFloats = kRows * kLd;
  __host__ __device__ static constexpr int at(int r, int s) {
    return (r + HALO) * kLd + s + 4;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v to p[0 .. 3]: 16 bytes at once when `vec`, else the first n one by one.
__device__ __forceinline__ void store_quad(float* p, float4 v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
  for (int j = 0; j < n && j < 4; ++j) p[j] = a[j];
}

// Stages n planes (plane(i) points at plane i's pixel (0, 0), rows W floats
// apart) into n consecutive tiles T at dst. Unit e is 4 columns of one row,
// floats [4 e, 4 e + 4) of every tile: one 16-byte cp.async a plane where
// its 4 pixels lie in the plane and `vec` holds (W % 4 == 0 and the planes
// start on 16 bytes), else 4-byte copies. A read off the plane takes the
// nearest edge pixel (REPLICATE) or zero. A thread that has waited for its
// own copies may read its own units before any barrier. Planes of the
// policy P's type: float32 by cp.async; bfloat16 loaded, converted to float32
// and stored by the thread, so the tile is float32 either way.
template <class T, int THREADS, bool REPLICATE, class P, class Plane>
__device__ __forceinline__ void stage_tile(float* dst, int n, Plane plane, int H, int W,
                                           int h0, int w0, bool vec) {
  constexpr int kUnitsPerRow = T::kLd / 4;
  constexpr bool kAsync = std::is_same<P, F32>::value;
  for (int e = threadIdx.x; e < T::kFloats / 4; e += THREADS) {
    const int h = h0 - T::kHalo + e / kUnitsPerRow, w = w0 - 4 + 4 * (e % kUnitsPerRow);
    float* d = dst + 4 * e;
    const bool row_in = h >= 0 && h < H;
    if constexpr (kAsync) {
      if (vec && row_in && w >= 0 && w + 4 <= W) {
        for (int i = 0; i < n; ++i) cp_async16(d + i * T::kFloats, plane(i) + (size_t)h * W + w);
        continue;
      }
    }
    const size_t row = (size_t)clampi(h, 0, H - 1) * W;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = row_in && w + j >= 0 && w + j < W;
      const size_t q = row + clampi(w + j, 0, W - 1);
      for (int i = 0; i < n; ++i) {
        if (!REPLICATE && !in)
          d[i * T::kFloats + j] = 0.f;
        else if constexpr (kAsync)
          cp_async4(d + i * T::kFloats + j, plane(i) + q);
        else
          d[i * T::kFloats + j] = P::load(plane(i) + q);
      }
    }
  }
}

// Sobel-x and Sobel-y taps (edge_enhancement_tpu/ops/filters.py), row-major,
// as values the compiler knows: it folds them and skips their zeros.
__device__ __forceinline__ void sobel_taps(float (&kx)[9], float (&ky)[9]) {
  const float x[9] = {-0.5f, 0.f, 0.5f, -1.f, 0.f, 1.f, -0.5f, 0.f, 0.5f};
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    kx[t] = x[t];
    ky[t] = x[(t % 3) * 3 + t / 3];  // Sobel-y is Sobel-x transposed
  }
}

// The sum over k's taps t, row-major, of k[t] a(t / 3 - 1, t % 3 - 1),
// a(i, j) reading a pixel's (row + i, column + j): each product and sum
// rounded on its own, in the order of the PyTorch composition. That skips
// zero taps; so does SKIP_ZEROS, for taps the compiler knows (Sobel). A
// runtime test a tap would branch around each of its loads, so the blur
// multiplies all its taps: on finite pixels a zero tap adds a zero, which
// changes no sum but the sign of a zero one.
template <bool SKIP_ZEROS, class P, class A>
__device__ __forceinline__ float tap_sum(A a, const float (&k)[9]) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (SKIP_ZEROS && k[t] == 0.f) continue;
    const float v = P::r(__fmul_rn(k[t], a(t / 3 - 1, t % 3 - 1)));
    acc = first ? v : P::r(__fadd_rn(acc, v));
    first = false;
  }
  return acc;
}

// The summed blur into tile S (the tile plus S's halo) from the C x tiles X:
// each channel blurred, the channels summed in order (in float32, rounded
// once by P); off the image S holds the nearest edge pixel's value, the
// Sobel's edge replication.
template <class X, class S, int THREADS, class P>
__device__ __forceinline__ void blur_stage(const float* sX, float* sS, const float (&g)[9],
                                           int C, int H, int W, int h0, int w0) {
  constexpr int kCols = S::kCols + 2 * S::kHalo;
  for (int i = threadIdx.x; i < S::kRows * kCols; i += THREADS) {
    const int r = i / kCols - S::kHalo, s = i % kCols - S::kHalo;
    const int hr = clampi(h0 + r, 0, H - 1) - h0, ws = clampi(w0 + s, 0, W - 1) - w0;
    const float* at = sX + X::at(hr, ws);
    float sum = 0.f;
    for (int c = 0; c < C; ++c, at += X::kFloats) {
      const float b = tap_sum<false, P>([&](int di, int dj) { return at[di * X::kLd + dj]; }, g);
      sum = c == 0 ? b : __fadd_rn(sum, b);
    }
    sS[S::at(r, s)] = P::r(sum);
  }
}

// Sobel / C and the zero-safe magnitude at a pixel of the summed image, read
// by a(i, j) as in tap_sum. A zero operand would send the IEEE division and
// square root down their slow paths even where the result is not taken (flat
// regions make many): they get 1 there, and the zero is selected, bit for bit
// the same. The Sobel sums round by P; the division and the magnitude are
// float32.
template <class P, class A>
__device__ __forceinline__ Grad sobel_mag_tile(A a, int C) {
  float kx[9], ky[9];
  sobel_taps(kx, ky);
  const float cf = (float)C;
  auto over_c = [&](float v) { return v == 0.f ? v : __fdiv_rn(v == 0.f ? 1.f : v, cf); };
  Grad g;
  g.gx = over_c(tap_sum<true, P>(a, kx));
  g.gy = over_c(tap_sum<true, P>(a, ky));
  const float v = __fadd_rn(__fmul_rn(g.gx, g.gx), __fmul_rn(g.gy, g.gy));
  g.mag = (v == 0.f) ? 0.f : __fsqrt_rn(v == 0.f ? 1.f : v);
  return g;
}

// fn(r, s, win) for each quad of pixels (r, s .. s + 3) of tile T's pixels,
// s a multiple of 4, in the image or not: win[i][j] = T at (r + i - 1,
// s + j - 1), the 3 x 6 window around the quad, three 16-byte reads a row.
template <class T, int THREADS, class Fn>
__device__ __forceinline__ void for_each_quad(const float* tile, Fn fn) {
  constexpr int kQuads = T::kCols / 4;
  for (int e = threadIdx.x; e < T::kTileRows * kQuads; e += THREADS) {
    const int r = e / kQuads, s = 4 * (e % kQuads);
    float win[3][6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4* row = reinterpret_cast<const float4*>(tile + T::at(r + i - 1, s));
      const float4 lo = row[-1], mid = row[0], hi = row[1];
      const float v[6] = {lo.w, mid.x, mid.y, mid.z, mid.w, hi.x};
#pragma unroll
      for (int j = 0; j < 6; ++j) win[i][j] = v[j];
    }
    fn(r, s, win);
  }
}

// The step125 Canny forward of the ROWS x COLS pixels at (h0, w0) of the C
// planes at xb, K1's and K3a's: x staged with a 2-pixel edge-replicated
// halo (smem: C tiles, then the summed blur's), the summed blur with a
// 1-pixel halo, then epilogue(r, s, q) for every quad of the tile, in the
// image or not, q[j] being the Grad of pixel (h0 + r, w0 + s + j). Ends
// without a barrier.
template <int ROWS, int COLS, int THREADS, class P, class Epilogue>
__device__ __forceinline__ void canny_tile(const typename P::T* __restrict__ xb,
                                           const float (&g)[9], int C, int H, int W, int h0,
                                           int w0, bool vec, float* smem, Epilogue epilogue) {
  using X = Tile<ROWS, COLS, 2>;
  using S = Tile<ROWS, COLS, 1>;
  float* sS = smem + C * X::kFloats;
  stage_tile<X, THREADS, true, P>(
      smem, C, [&](int c) { return xb + (size_t)c * H * W; }, H, W, h0, w0, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  blur_stage<X, S, THREADS, P>(smem, sS, g, C, H, W, h0, w0);
  __syncthreads();
  for_each_quad<S, THREADS>(sS, [&](int r, int s, const float (&win)[3][6]) {
    Grad q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = sobel_mag_tile<P>([&](int di, int dj) { return win[1 + di][1 + j + dj]; }, C);
    epilogue(r, s, q);
  });
}

// The gate of the JAX _canny_bwd_kernel at one pixel, K2's and K3b's: the
// edge map's cotangent u through the To_compare window (high, 1.001], the
// alpha gate and d|g|/dg with 1/|g| := 0 at |g| = 0; returns (u_gx, u_gy).
__device__ __forceinline__ float2 gate(float u, float mag, float gx, float gy,
                                       const Params& p) {
  const float mag_m = (mag < p.alpha) ? 0.f : mag;
  const bool keep = mag_m > p.high && mag_m <= 1.001f && mag >= p.alpha;
  const float u_mag = keep ? u : 0.f;
  const float inv = (mag == 0.f) ? 0.f : __frcp_rn(mag == 0.f ? 1.f : mag);  // as in sobel_mag_tile
  return make_float2(u_mag * gx * inv, u_mag * gy * inv);
}

// Adjoint of the edge-replicated 3x3 stencil k at pixel (h, w) of an (H, W)
// plane, where a(i, j) reads the cotangent at (h + i, w + j) from a tile
// that holds zeros off the plane: the zero-padded adjoint, plus the outer
// rows and columns that the clamp maps onto a border pixel (above row 0
// only k's first row reads the plane, below row H - 1 only its last;
// likewise for columns). The sums run in another order than the plain
// version's, well inside the tests' 1e-4.
template <class A>
__device__ __forceinline__ float stencil3_adjoint_tile(A a, const float (&k)[9], int H, int W,
                                                     int h, int w) {
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) z += k[i * 3 + j] * a(1 - i, 1 - j);
  const bool top = h == 0, bottom = h == H - 1, left = w == 0, right = w == W - 1;
  if (top || bottom || left || right) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (top) z += k[j] * a(0, 1 - j);
      if (bottom) z += k[6 + j] * a(0, 1 - j);
      if (left) z += k[j * 3] * a(1 - j, 0);
      if (right) z += k[j * 3 + 2] * a(1 - j, 0);
    }
    if (top && left) z += k[0] * a(0, 0);
    if (top && right) z += k[2] * a(0, 0);
    if (bottom && left) z += k[6] * a(0, 0);
    if (bottom && right) z += k[8] * a(0, 0);
  }
  return z;
}

// K2's and K3b's last stages: from u_gx, u_gy in tiles G (2-pixel halo,
// zeros off the plane), u_summed = (Sobel-x^T u_gx + Sobel-y^T u_gy) / C on
// the tile plus 1 in tile sU (zeros off the plane); then epilogue(r, s, v)
// for every quad of the tile, in the image or not, v's components being the
// blur's adjoint of u_summed at pixels (h0 + r, w0 + s .. s + 3). Ends
// without a barrier.
template <int ROWS, int COLS, int THREADS, class Epilogue>
__device__ __forceinline__ void canny_adjoint_tail(const float* sG0, const float* sG1,
                                                   float* sU, const float (&g)[9], int C,
                                                   int H, int W, int h0, int w0,
                                                   Epilogue epilogue) {
  using G = Tile<ROWS, COLS, 2>;
  using U = Tile<ROWS, COLS, 1>;
  float sx[9], sy[9];
  sobel_taps(sx, sy);
  constexpr int kCols = COLS + 2;
  for (int i = threadIdx.x; i < U::kRows * kCols; i += THREADS) {
    const int r = i / kCols - 1, s = i % kCols - 1, h = h0 + r, w = w0 + s;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const float* a0 = sG0 + G::at(r, s);
      const float* a1 = sG1 + G::at(r, s);
      v = (stencil3_adjoint_tile([&](int di, int dj) { return a0[di * G::kLd + dj]; }, sx,
                               H, W, h, w) +
           stencil3_adjoint_tile([&](int di, int dj) { return a1[di * G::kLd + dj]; }, sy,
                               H, W, h, w)) /
          (float)C;
    }
    sU[U::at(r, s)] = v;
  }
  __syncthreads();
  for_each_quad<U, THREADS>(sU, [&](int r, int s, const float (&win)[3][6]) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = stencil3_adjoint_tile([&](int di, int dj) { return win[1 + di][1 + j + dj]; }, g,
                                 H, W, h0 + r, w0 + s + j);
    epilogue(r, s, make_float4(v[0], v[1], v[2], v[3]));
  });
}

// ---- K1/K2: the band's Canny branch and the kernels -----------------------

// K1's Canny branch: the band's edge map into sE (row stride lde, a multiple
// of 4), strip by strip.
template <class P>
__device__ __forceinline__ void band_edge(const typename P::T* __restrict__ xb,
                                          const float (&g)[9], const Params& p, int h0,
                                          bool vec, float* smem, float* sE, int lde) {
  for (int w0 = 0; w0 < p.W; w0 += kStripW) {
    canny_tile<kBandRows, kStripW, kBandThreads, P>(
        xb, g, p.C, p.H, p.W, h0, w0, vec, smem, [&](int r, int s, const Grad (&q)[4]) {
          if (w0 + s < p.W)
            store_quad(sE + r * lde + w0 + s,
                       make_float4(edge_of(q[0].mag, p), edge_of(q[1].mag, p),
                                   edge_of(q[2].mag, p), edge_of(q[3].mag, p)),
                       true, 4);
        });
    __syncthreads();
  }
}

// K2's Canny branch: the band's share of dx from the edge map, one plane for
// every channel, into sE (row stride lde, a multiple of 4). Per strip: x
// with a 4-pixel halo and u_edge = w sum_c U on the strip plus 2, the summed
// blur with 3, u_gx / u_gy on the strip plus 2 (mag, gx, gy recomputed, then
// the gate), then canny_adjoint_tail. A row band (the float32 K2) walks
// strips of kBandRows x kStripW pixels across the band, sE[r][w] holding
// image row band0 + r; a column band (COLUMNS, the bfloat16 K2) walks strips
// of kStripW x kBandRows pixels down it, sE[s][h] holding image column
// band0 + s.
template <bool COLUMNS, class P>
__device__ __forceinline__ void band_canny_adjoint(const typename P::T* __restrict__ xb,
                                                   const typename P::T* __restrict__ ub,
                                                   const typename P::T* __restrict__ yb,
                                                   const float (&g)[9], const Params& p,
                                                   int band0, bool vec, float* smem, float* sE,
                                                   int lde) {
  constexpr int ROWS = COLUMNS ? kStripW : kBandRows, COLS = COLUMNS ? kBandRows : kStripW;
  using X = Tile<ROWS, COLS, 4>;
  using S = Tile<ROWS, COLS, 3>;
  using G = Tile<ROWS, COLS, 2>;
  const int C = p.C, H = p.H, W = p.W;
  float* sS = smem + C * X::kFloats;
  float* sG0 = sS + S::kFloats;  // u_edge, then u_gx; 0 off the plane
  float* sG1 = sG0 + G::kFloats;  // u_gy
  float* sU = sG1 + G::kFloats;   // u_summed
  constexpr int kCols = COLS + 4;
  for (int k0 = 0; k0 < (COLUMNS ? H : W); k0 += COLUMNS ? ROWS : COLS) {
    const int h0 = COLUMNS ? k0 : band0, w0 = COLUMNS ? band0 : k0;
    stage_tile<X, kBandThreads, true, P>(
        smem, C, [&](int c) { return xb + (size_t)c * H * W; }, H, W, h0, w0, vec);
    cp_async_commit();
    for (int i = threadIdx.x; i < G::kRows * kCols; i += kBandThreads) {
      const int r = i / kCols - 2, s = i % kCols - 2, h = h0 + r, w = w0 + s;
      float u_edge = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        for (int c = 0; c < C; ++c) {
          const size_t k = ((size_t)c * H + h) * W + w;
          u_edge += P::r(P::load(ub + k) * clip_mask(P::load(yb + k)));
        }
      }
      sG0[G::at(r, s)] = P::r(P::r(u_edge) * p.w);
    }
    cp_async_wait_all();
    __syncthreads();
    blur_stage<X, S, kBandThreads, P>(smem, sS, g, C, H, W, h0, w0);
    __syncthreads();
    for (int i = threadIdx.x; i < G::kRows * kCols; i += kBandThreads) {
      const int r = i / kCols - 2, s = i % kCols - 2, h = h0 + r, w = w0 + s;
      float2 v = make_float2(0.f, 0.f);
      if (h >= 0 && h < H && w >= 0 && w < W) {
        const float* a = sS + S::at(r, s);
        const Grad gd =
            sobel_mag_tile<P>([&](int di, int dj) { return a[di * S::kLd + dj]; }, C);
        v = gate(sG0[G::at(r, s)], gd.mag, gd.gx, gd.gy, p);
      }
      sG0[G::at(r, s)] = v.x;
      sG1[G::at(r, s)] = v.y;
    }
    __syncthreads();
    canny_adjoint_tail<ROWS, COLS, kBandThreads>(
        sG0, sG1, sU, g, C, H, W, h0, w0, [&](int r, int s, float4 v) {
          if (!COLUMNS) {
            if (w0 + s < W) store_quad(sE + r * lde + w0 + s, v, true, 4);
            return;
          }
          if (h0 + r >= H) return;
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) sE[(s + j) * lde + h0 + r] = vs[j];
        });
    __syncthreads();
  }
}

__device__ __forceinline__ void load_taps(const float* __restrict__ gtaps, float (&g)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = __ldg(gtaps + i);
}

// K1 in the policy P's type. The wrapper gives bfloat16 its operators, taps,
// eps and w already rounded to bfloat16.
template <class P>
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_fwd_kernel(const typename P::T* __restrict__ x,
                    const typename P::T* __restrict__ stripes,
                    const typename P::T* __restrict__ sq_delta, const float* __restrict__ lr,
                    const float* __restrict__ li, const float* __restrict__ rr,
                    const float* __restrict__ ri, const float* __restrict__ gtaps,
                    typename P::T* __restrict__ out, typename P::T* __restrict__ y, Params p,
                    BandLayout L) {
  using T = typename P::T;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, h0 = blockIdx.x * kBandRows;
  float* sE = smem;
  float* sT = smem + L.t;
  float* sS = smem + L.s;
  float g[9];
  load_taps(gtaps, g);
  const T* xb = x + (size_t)b * C * HW;
  band_edge<P>(xb, g, p, h0, W % 4 == 0 && aligned16(x), sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)b * C + c) * HW;
    SquarePlane<kPlanePerThread, P> plane{
        xb + (size_t)c * HW, p.square ? stripes + ((size_t)b * C + c) * W : nullptr,
        p.square ? sq_delta + (size_t)c * HW : nullptr, H, W, p.eps, p.square};
    T* yc = y + off;
    T* oc = out + off;
    band_hfs<P>(L, H, W, h0, lr, li, rr, ri, sT, sS, plane,
                [&](int r, int h, int w, float hfs) {
                  const float yv = P::r(__fadd_rn(
                      P::r(hfs), P::r(__fmul_rn(p.w, sE[r * L.wq + w]))));
                  P::store(yc + h * W + w, yv);
                  P::store(oc + h * W + w, clip01(yv));
                });
  }
}

// K2 in the policy P's type: float32 on row bands; bfloat16 on column bands
// (COLUMNS), the HFS products on the transposed problem dx^T = R^T U^T L with
// the operators the wrapper gives it (L = B^T, R = A, rounded to bfloat16).
template <class P, bool COLUMNS>
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_bwd_kernel(const typename P::T* __restrict__ u, const typename P::T* __restrict__ x,
                    const typename P::T* __restrict__ stripes,
                    const typename P::T* __restrict__ sq_delta,
                    const typename P::T* __restrict__ y, const float* __restrict__ lr,
                    const float* __restrict__ li, const float* __restrict__ rr,
                    const float* __restrict__ ri, const float* __restrict__ gtaps,
                    typename P::T* __restrict__ dx, Params p, BandLayout L) {
  using T = typename P::T;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, band0 = blockIdx.x * kBandRows;
  float* sE = smem;
  float* sT = smem + L.t;
  float* sS = smem + L.s;
  float g[9];
  load_taps(gtaps, g);
  const size_t img = (size_t)b * C * HW;
  band_canny_adjoint<COLUMNS, P>(x + img, u + img, y + img, g, p, band0,
                                 W % 4 == 0 && aligned16(x), sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = img + (size_t)c * HW;
    CotangentPlane<kPlanePerThread, P, COLUMNS> plane{u + off, y + off, H, W};
    const T* xc = x + off;
    const T* st = p.square ? stripes + ((size_t)b * C + c) * W : nullptr;
    const T* sqd = p.square ? sq_delta + (size_t)c * HW : nullptr;
    T* dxc = dx + off;
    // (i, j) of the product: pixel (i, j), or (j, i) on the transposed problem
    auto epilogue = [&](int r, int i, int j, float dxs_sum) {
      const int h = COLUMNS ? j : i, w = COLUMNS ? i : j, q = h * W + w;
      const float dxs = P::r(dxs_sum);
      const float d = p.square ? square_bwd<P>(dxs, P::load(xc + q), P::load(st + w),
                                               P::load(sqd + q), p.eps)
                               : dxs;
      P::store(dxc + q, d + sE[r * L.wq + (COLUMNS ? h : w)]);
    };
    band_hfs<P>(L, COLUMNS ? W : H, COLUMNS ? H : W, band0, lr, li, rr, ri, sT, sS, plane,
                epilogue);
  }
}

// ---- K3a/K3b: the Canny-only pair ------------------------------------------
//
// A block owns a kCannyRows x kCannyCols tile of one image (grid: tiles
// across, tiles down, images; ragged tiles masked). ops/cuda/ee_fused.py
// (canny_geometry) mirrors kCannyRows and kCannyCols as CANNY_ROWS and
// CANNY_COLS, computes the grid and a block's shared memory, and passes both
// to the launch. K3a: C x tiles and the summed blur's; K3b: four tiles and
// u_summed's, whatever C.

constexpr int kCannyRows = 16;
constexpr int kCannyCols = 32;
constexpr int kCannyThreads = 128;
constexpr int kCannyMinBlocks = 6;

// K3a: writes out (the edge map), mag, gx, gy, each (B, 1, H, W).
__global__ void __launch_bounds__(kCannyThreads, kCannyMinBlocks)
canny_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gtaps,
                 float* __restrict__ out, float* __restrict__ mag,
                 float* __restrict__ gx, float* __restrict__ gy, Params p) {
  extern __shared__ float4 smem4[];
  const int H = p.H, W = p.W, b = blockIdx.z;
  const int h0 = blockIdx.y * kCannyRows, w0 = blockIdx.x * kCannyCols;
  float g[9];
  load_taps(gtaps, g);
  // the outputs are the wrapper's own tensors: their rows start on 16 bytes
  // whenever x's do
  const bool vec = W % 4 == 0 && aligned16(x);
  const size_t plane = (size_t)b * H * W;
  canny_tile<kCannyRows, kCannyCols, kCannyThreads, F32>(
      x + plane * p.C, g, p.C, H, W, h0, w0, vec, reinterpret_cast<float*>(smem4),
      [&](int r, int s, const Grad (&q)[4]) {
        const int h = h0 + r, w = w0 + s;
        if (h >= H || w >= W) return;
        const size_t at = plane + (size_t)h * W + w;
        store_quad(out + at,
                   make_float4(edge_of(q[0].mag, p), edge_of(q[1].mag, p),
                               edge_of(q[2].mag, p), edge_of(q[3].mag, p)),
                   vec, W - w);
        store_quad(mag + at, make_float4(q[0].mag, q[1].mag, q[2].mag, q[3].mag), vec, W - w);
        store_quad(gx + at, make_float4(q[0].gx, q[1].gx, q[2].gx, q[3].gx), vec, W - w);
        store_quad(gy + at, make_float4(q[0].gy, q[1].gy, q[2].gy, q[3].gy), vec, W - w);
      });
}

// K3b: writes dx (B, C, H, W), the same plane in every channel.
__global__ void __launch_bounds__(kCannyThreads, kCannyMinBlocks)
canny_bwd_kernel(const float* __restrict__ u, const float* __restrict__ mag,
                 const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ gtaps, float* __restrict__ dx, Params p) {
  using G = Tile<kCannyRows, kCannyCols, 2>;
  extern __shared__ float4 smem4[];
  // u, mag, gx, gy; the gate turns u's tile into u_gx and mag's into u_gy
  float* sIn = reinterpret_cast<float*>(smem4);
  float* sU = sIn + 4 * G::kFloats;
  const int C = p.C, H = p.H, W = p.W, b = blockIdx.z;
  const int h0 = blockIdx.y * kCannyRows, w0 = blockIdx.x * kCannyCols;
  float g[9];
  load_taps(gtaps, g);
  // dx is the wrapper's own tensor: its rows start on 16 bytes whenever the
  // inputs' do
  const bool vec = W % 4 == 0 && aligned16(u) && aligned16(mag) && aligned16(gx) &&
                   aligned16(gy);
  const size_t plane = (size_t)b * H * W;
  stage_tile<G, kCannyThreads, false, F32>(
      sIn, 4,
      [&](int i) { return (i == 0 ? u : i == 1 ? mag : i == 2 ? gx : gy) + plane; }, H, W,
      h0, w0, vec);
  cp_async_commit();
  cp_async_wait_all();
  // the gate on this thread's own units, in place
  for (int e = threadIdx.x; e < G::kFloats / 4; e += kCannyThreads) {
    float4* t = reinterpret_cast<float4*>(sIn) + e;
    constexpr int kTile = G::kFloats / 4;
    const float4 vu = t[0], vm = t[kTile], vx = t[2 * kTile], vy = t[3 * kTile];
    const float2 a0 = gate(vu.x, vm.x, vx.x, vy.x, p), a1 = gate(vu.y, vm.y, vx.y, vy.y, p);
    const float2 a2 = gate(vu.z, vm.z, vx.z, vy.z, p), a3 = gate(vu.w, vm.w, vx.w, vy.w, p);
    t[0] = make_float4(a0.x, a1.x, a2.x, a3.x);
    t[kTile] = make_float4(a0.y, a1.y, a2.y, a3.y);
  }
  __syncthreads();
  canny_adjoint_tail<kCannyRows, kCannyCols, kCannyThreads>(
      sIn, sIn + G::kFloats, sU, g, C, H, W, h0, w0, [&](int r, int s, float4 v) {
        const int h = h0 + r, w = w0 + s;
        if (h >= H || w >= W) return;
        float* d = dx + ((size_t)b * C * H + h) * W + w;
        for (int c = 0; c < C; ++c, d += (size_t)H * W) store_quad(d, v, vec, W - w);
      });
}

constexpr int kMaxDevices = 64;
size_t g_fwd_smem[kMaxDevices], g_bwd_smem[kMaxDevices];
size_t g_fwd_bf16_smem[kMaxDevices], g_bwd_bf16_smem[kMaxDevices];
size_t g_canny_fwd_smem[kMaxDevices], g_canny_bwd_smem[kMaxDevices];

// Launches `kernel` on `stream` with `smem_bytes` of dynamic shared memory,
// opting the kernel into that much once per device and size (in done[]): the
// attribute outlives the launch, and setting it on every launch would put a
// host call inside CUDA graph captures of the launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t* done, dim3 grid, int threads, size_t smem_bytes,
           void* stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
    done[dev] = smem_bytes;
  }
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

BandLayout band_layout(const int* layout) {
  return BandLayout{layout[0], layout[1], layout[2], layout[3],
                    layout[4], layout[5], layout[6]};
}

template <class P>
int fused_fwd(const void* x, const void* stripes, const void* sq_delta, const float* lr,
              const float* li, const float* rr, const float* ri, const float* gtaps,
              void* out, void* y, int B, int C, int H, int W, float eps, float w,
              float alpha, float high, int square, const int* layout, int bands,
              size_t smem_bytes, void* stream, size_t* done) {
  using T = typename P::T;
  return launch(ee_fused_fwd_kernel<P>, done, dim3(bands, B), kBandThreads, smem_bytes,
                stream, static_cast<const T*>(x), static_cast<const T*>(stripes),
                static_cast<const T*>(sq_delta), lr, li, rr, ri, gtaps, static_cast<T*>(out),
                static_cast<T*>(y), Params{B, C, H, W, eps, w, alpha, high, square},
                band_layout(layout));
}

template <class P, bool COLUMNS>
int fused_bwd(const void* u, const void* x, const void* stripes, const void* sq_delta,
              const void* y, const float* lr, const float* li, const float* rr,
              const float* ri, const float* gtaps, void* dx, int B, int C, int H, int W,
              float eps, float w, float alpha, float high, int square, const int* layout,
              int bands, size_t smem_bytes, void* stream, size_t* done) {
  using T = typename P::T;
  return launch(ee_fused_bwd_kernel<P, COLUMNS>, done, dim3(bands, B), kBandThreads,
                smem_bytes, stream, static_cast<const T*>(u), static_cast<const T*>(x),
                static_cast<const T*>(stripes), static_cast<const T*>(sq_delta),
                static_cast<const T*>(y), lr, li, rr, ri, gtaps, static_cast<T*>(dx),
                Params{B, C, H, W, eps, w, alpha, high, square}, band_layout(layout));
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t: 0 when the launch was accepted.
// K1/K2 take the block geometry that the wrapper computed: `layout` holds
// BandLayout's seven fields in order, `bands` the blocks per image and
// `smem_bytes` a block's dynamic shared memory; and the operators it padded
// to layout's shapes (lr, li: bands x band rows by hk; rr, ri: wk x wt).
// The _bf16 forms take bfloat16 tensors, and the operators, taps, eps and w
// rounded to bfloat16; K2's operators and layout are those of its column
// bands (L = B^T, R = A).
// K3a/K3b take the tiles across and down an image and a block's dynamic
// shared memory from the wrapper's canny_geometry.
int ee_fused_fwd(const float* x, const float* stripes, const float* sq_delta,
                 const float* lr, const float* li, const float* rr,
                 const float* ri, const float* gtaps, float* out, float* y,
                 int B, int C, int H, int W, float eps, float w, float alpha,
                 float high, int square, const int* layout, int bands,
                 size_t smem_bytes, void* stream) {
  return fused_fwd<F32>(x, stripes, sq_delta, lr, li, rr, ri, gtaps, out, y, B, C, H, W, eps,
                        w, alpha, high, square, layout, bands, smem_bytes, stream, g_fwd_smem);
}

int ee_fused_bwd(const float* u, const float* x, const float* stripes,
                 const float* sq_delta, const float* y, const float* lr,
                 const float* li, const float* rr, const float* ri,
                 const float* gtaps, float* dx, int B, int C, int H, int W,
                 float eps, float w, float alpha, float high, int square,
                 const int* layout, int bands, size_t smem_bytes, void* stream) {
  return fused_bwd<F32, false>(u, x, stripes, sq_delta, y, lr, li, rr, ri, gtaps, dx, B, C, H,
                               W, eps, w, alpha, high, square, layout, bands, smem_bytes,
                               stream, g_bwd_smem);
}

int ee_fused_fwd_bf16(const void* x, const void* stripes, const void* sq_delta,
                      const float* lr, const float* li, const float* rr, const float* ri,
                      const float* gtaps, void* out, void* y, int B, int C, int H, int W,
                      float eps, float w, float alpha, float high, int square,
                      const int* layout, int bands, size_t smem_bytes, void* stream) {
  return fused_fwd<BF16>(x, stripes, sq_delta, lr, li, rr, ri, gtaps, out, y, B, C, H, W,
                         eps, w, alpha, high, square, layout, bands, smem_bytes, stream,
                         g_fwd_bf16_smem);
}

int ee_fused_bwd_bf16(const void* u, const void* x, const void* stripes,
                      const void* sq_delta, const void* y, const float* lr,
                      const float* li, const float* rr, const float* ri,
                      const float* gtaps, void* dx, int B, int C, int H, int W, float eps,
                      float w, float alpha, float high, int square, const int* layout,
                      int bands, size_t smem_bytes, void* stream) {
  return fused_bwd<BF16, true>(u, x, stripes, sq_delta, y, lr, li, rr, ri, gtaps, dx, B, C, H,
                               W, eps, w, alpha, high, square, layout, bands, smem_bytes,
                               stream, g_bwd_bf16_smem);
}

int canny_fused_fwd(const float* x, const float* gtaps, float* out, float* mag,
                    float* gx, float* gy, int B, int C, int H, int W,
                    float alpha, float high, int tiles_w, int tiles_h,
                    size_t smem_bytes, void* stream) {
  return launch(canny_fwd_kernel, g_canny_fwd_smem, dim3(tiles_w, tiles_h, B),
                kCannyThreads, smem_bytes, stream, x, gtaps, out, mag, gx, gy,
                Params{B, C, H, W, 0.f, 0.f, alpha, high, 0});
}

int canny_fused_bwd(const float* u, const float* mag, const float* gx,
                    const float* gy, const float* gtaps, float* dx, int B,
                    int C, int H, int W, float alpha, float high, int tiles_w,
                    int tiles_h, size_t smem_bytes, void* stream) {
  return launch(canny_bwd_kernel, g_canny_bwd_smem, dim3(tiles_w, tiles_h, B),
                kCannyThreads, smem_bytes, stream, u, mag, gx, gy, gtaps, dx,
                Params{B, C, H, W, 0.f, 0.f, alpha, high, 0});
}

const char* ee_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
