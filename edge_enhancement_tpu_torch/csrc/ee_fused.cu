// Fused edge-enhancement front-end for Hopper (sm_90a): forward K1 and its
// exact adjoint K2, and the Canny-only pair K3a/K3b (at the end of the file).
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
//      kStripW columns with edge-replicated halos. K1: the edge map from a
//      2-pixel x halo, with the arithmetic of K3a's blur_sum, sobel_mag and
//      edge_of in the same order, so the edge maps are K3a's bit for bit.
//      K2: mag, gx, gy recomputed on the band plus 2 rows from a 4-pixel x
//      halo, u_edge = w sum_c U, then the Sobel and blur adjoints as
//      zero-padded stencils plus the rows and columns the clamp folds onto
//      the border: one plane, added to every channel's dx.
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
// The Canny branch rounds every product and sum on its own (__fmul_rn,
// __fadd_rn: no FMA contraction) and keeps the tap order of the PyTorch
// composition (row-major, zero taps skipped), so the edge maps of kernel and
// plain version agree exactly: `mag > high` flips on one-ulp differences.
// The square chain does the same, since its clips decide gradient ties.
// The HFS products stay on the FP32 pipes; 3xTF32 on wgmma is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // K3a/K3b

// Sobel-x and Sobel-y taps (edge_enhancement_tpu/ops/filters.py), row-major.
__constant__ float kSobelX[9] = {-0.5f, 0.f, 0.5f, -1.f, 0.f, 1.f, -0.5f, 0.f, 0.5f};
__constant__ float kSobelY[9] = {-0.5f, -1.f, -0.5f, 0.f, 0.f, 0.f, 0.5f, 1.f, 0.5f};

struct Params {
  int B, C, H, W;
  float eps, w, alpha, high;
  int square;
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

// Edge-replicated 3x3 stencil of one (H, W) plane at (h, w), taps row-major,
// zero taps skipped, every product and sum rounded on its own.
__device__ __forceinline__ float stencil3(const float* p, const float* k,
                                          int H, int W, int h, int w) {
  float acc = 0.f;
  bool first = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float c = k[i * 3 + j];
      if (c == 0.f) continue;
      const float t = __fmul_rn(c, p[clampi(h + i - 1, 0, H - 1) * W +
                                     clampi(w + j - 1, 0, W - 1)]);
      acc = first ? t : __fadd_rn(acc, t);
      first = false;
    }
  }
  return acc;
}

// Indices p in [0, n) with clamp(p + d, 0, n - 1) == q, for |d| <= 1: the
// reads that an edge-replicated stencil tap folded onto q.
__device__ __forceinline__ int folded(int q, int d, int n, int* ps) {
  int m = 0;
  const int p = q - d;
  if (p >= 0 && p < n) ps[m++] = p;
  if (d > 0 && q == n - 1) ps[m++] = n - 1;
  if (d < 0 && q == 0) ps[m++] = 0;
  return m;
}

// Adjoint of the edge-replicated 3x3 stencil `k` on an (H, W) plane,
// gathered at (qh, qw). u holds a window of the cotangent plane: global
// (h, w) sits at u[(h - r0) * ld + (w - c0)], and the window covers the
// rows and columns within 1 of (qh, qw) that lie in the plane.
__device__ float stencil3_adjoint(const float* u, int ld, int r0, int c0,
                                  const float* k, int H, int W, int qh,
                                  int qw) {
  float acc = 0.f;
  for (int i = 0; i < 3; ++i) {
    int rows[2];
    const int nr = folded(qh, i - 1, H, rows);
    for (int j = 0; j < 3; ++j) {
      const float c = k[i * 3 + j];
      if (c == 0.f) continue;
      int cols[2];
      const int nc = folded(qw, j - 1, W, cols);
      float s = 0.f;
      for (int a = 0; a < nr; ++a)
        for (int b = 0; b < nc; ++b) s += u[(rows[a] - r0) * ld + cols[b] - c0];
      acc += c * s;
    }
  }
  return acc;
}

// Blur each channel, sum the channels in order (the summed image the Sobel
// reads), at (h, w).
__device__ __forceinline__ float blur_sum(const float* X, const float* g,
                                          int C, int H, int W, int h, int w) {
  float s = stencil3(X, g, H, W, h, w);
  for (int c = 1; c < C; ++c)
    s = __fadd_rn(s, stencil3(X + c * H * W, g, H, W, h, w));
  return s;
}

struct Grad {
  float gx, gy, mag;
};

// Sobel / C and the zero-safe magnitude at (h, w) of the summed image S.
__device__ __forceinline__ Grad sobel_mag(const float* S, int C, int H, int W,
                                          int h, int w) {
  Grad g;
  const float cf = (float)C;
  g.gx = __fdiv_rn(stencil3(S, kSobelX, H, W, h, w), cf);
  g.gy = __fdiv_rn(stencil3(S, kSobelY, H, W, h, w), cf);
  const float v = __fadd_rn(__fmul_rn(g.gx, g.gx), __fmul_rn(g.gy, g.gy));
  g.mag = (v == 0.f) ? 0.f : __fsqrt_rn(v);
  return g;
}

__device__ __forceinline__ float edge_of(float mag, const Params& p) {
  const float mag_m = (mag < p.alpha) ? 0.f : mag;
  return (mag_m > p.high) ? 1.f : 0.f;
}

__device__ __forceinline__ float square_fwd(float x, float st, float sqd,
                                            float eps) {
  const float t2 = clip01(__fadd_rn(x, __fmul_rn(eps, st)));
  const float t3 = __fadd_rn(t2, sqd);
  const float t5 = fminf(fmaxf(t3, __fsub_rn(x, eps)), __fadd_rn(x, eps));
  return clip01(t5);
}

// Adjoint of square_fwd w.r.t. x (stripes and delta are constants): through
// the perturbation chain and through the projection bounds x +- eps.
__device__ __forceinline__ float square_bwd(float u, float x, float st,
                                            float sqd, float eps) {
  const float t1 = __fadd_rn(x, __fmul_rn(eps, st));
  const float t2 = clip01(t1);
  const float t3 = __fadd_rn(t2, sqd);
  const float xl = __fsub_rn(x, eps), xh = __fadd_rn(x, eps);
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
  return u_t1 + u_t5 * d_xh + u_t4 * d_xl;
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
template <int Q>
struct SquarePlane {
  const float *x, *st, *sqd;
  int H, W;
  float eps;
  int square;
  float vx[Q], vs[Q], vd[Q];
  bool ok[Q];
  __device__ __forceinline__ void load(int q, int h, int w) {
    ok[q] = h < H && w < W;
    if (!ok[q]) return;
    vx[q] = x[h * W + w];
    if (square) {
      vs[q] = st[w];
      vd[q] = sqd[h * W + w];
    }
  }
  __device__ __forceinline__ float value(int q) const {
    if (!ok[q]) return 0.f;
    return square ? square_fwd(vx[q], vs[q], vd[q], eps) : vx[q];
  }
};

// K2's plane: U = u clip'(y) of one channel, 0 off the plane.
template <int Q>
struct CotangentPlane {
  const float *u, *y;
  int H, W;
  float vu[Q], vy[Q];
  bool ok[Q];
  __device__ __forceinline__ void load(int q, int h, int w) {
    ok[q] = h < H && w < W;
    if (!ok[q]) return;
    vu[q] = u[h * W + w];
    vy[q] = y[h * W + w];
  }
  __device__ __forceinline__ float value(int q) const {
    return ok[q] ? vu[q] * clip_mask(vy[q]) : 0.f;
  }
};

// One channel's HFS products on the band [h0, h0 + kBandRows): T = [Lr; Li] P
// into sT, then hfs = Tr Rr - Ti Ri, handed to epilogue(r, h, w, hfs) for
// each pixel (h0 + r, w) of the band that lies in the image.
template <class Plane, class Epilogue>
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
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

// blur_sum and sobel_mag on a tile whose halo holds the edge-replicated
// reads, so that no tap needs a clamp: the same products and sums in the
// same order, bit for bit, with the Gaussian's taps in registers and the
// Sobel taps (kSobelX, kSobelY) and their zeros fixed at compile time.
template <int LD, int PLANE>
__device__ __forceinline__ float blur_sum_tile(const float* X, const float (&g)[9],
                                               int C, int r, int s) {
  const float* at = X + r * LD + s;
  float sum = 0.f;
  for (int c = 0; c < C; ++c, at += PLANE) {
    float acc = 0.f;
    bool first = true;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (g[i * 3 + j] == 0.f) continue;
        const float t = __fmul_rn(g[i * 3 + j], at[(i - 1) * LD + j - 1]);
        acc = first ? t : __fadd_rn(acc, t);
        first = false;
      }
    sum = c == 0 ? acc : __fadd_rn(sum, acc);
  }
  return sum;
}

template <int LD>
__device__ __forceinline__ Grad sobel_mag_tile(const float* S, int C, int r, int s) {
  const float* a = S + r * LD + s;
  float sx = __fmul_rn(-0.5f, a[-LD - 1]);
  sx = __fadd_rn(sx, __fmul_rn(0.5f, a[-LD + 1]));
  sx = __fadd_rn(sx, __fmul_rn(-1.f, a[-1]));
  sx = __fadd_rn(sx, __fmul_rn(1.f, a[1]));
  sx = __fadd_rn(sx, __fmul_rn(-0.5f, a[LD - 1]));
  sx = __fadd_rn(sx, __fmul_rn(0.5f, a[LD + 1]));
  float sy = __fmul_rn(-0.5f, a[-LD - 1]);
  sy = __fadd_rn(sy, __fmul_rn(-1.f, a[-LD]));
  sy = __fadd_rn(sy, __fmul_rn(-0.5f, a[-LD + 1]));
  sy = __fadd_rn(sy, __fmul_rn(0.5f, a[LD - 1]));
  sy = __fadd_rn(sy, __fmul_rn(1.f, a[LD]));
  sy = __fadd_rn(sy, __fmul_rn(0.5f, a[LD + 1]));
  Grad g;
  const float cf = (float)C;
  g.gx = __fdiv_rn(sx, cf);
  g.gy = __fdiv_rn(sy, cf);
  const float v = __fadd_rn(__fmul_rn(g.gx, g.gx), __fmul_rn(g.gy, g.gy));
  g.mag = (v == 0.f) ? 0.f : __fsqrt_rn(v);
  return g;
}

// K1's Canny branch: the band's edge map into sE (row stride lde), strip by
// strip, with K3a's staging and device functions.
__device__ __forceinline__ void band_edge(const float* __restrict__ xb, const float* g,
                                          const Params& p, int h0, float* sX,
                                          float* sE, int lde) {
  constexpr int XH = kBandRows + 4, XW = kStripW + 4;  // x, 2-pixel halo
  constexpr int SH = kBandRows + 2, SW = kStripW + 2;  // summed blur, 1-pixel halo
  const int C = p.C, H = p.H, W = p.W;
  float* sS = sX + C * XH * XW;
  float gr[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) gr[i] = g[i];
  for (int w0 = 0; w0 < W; w0 += kStripW) {
    for (int i = threadIdx.x; i < C * XH * XW; i += kBandThreads) {
      const int c = i / (XH * XW), r = (i / XW) % XH, s = i % XW;
      cp_async4(sX + i, xb + ((size_t)c * H + clampi(h0 - 2 + r, 0, H - 1)) * W +
                            clampi(w0 - 2 + s, 0, W - 1));
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < SH * SW; i += kBandThreads) {
      const int h = clampi(h0 - 1 + i / SW, 0, H - 1);
      const int w = clampi(w0 - 1 + i % SW, 0, W - 1);
      sS[i] = blur_sum_tile<XW, XH * XW>(sX, gr, C, h - h0 + 2, w - w0 + 2);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBandRows * kStripW; i += kBandThreads) {
      const int r = i / kStripW, s = i % kStripW, h = h0 + r, w = w0 + s;
      if (h >= H || w >= W) continue;
      sE[r * lde + w] = edge_of(sobel_mag_tile<SW>(sS, C, r + 1, s + 1).mag, p);
    }
    __syncthreads();
  }
}

// Adjoint of the edge-replicated 3x3 stencil k at an (h, w) of an (H, W)
// plane, from a tile of the cotangent that holds zeros off the plane: the
// zero-padded adjoint at (h, w), plus the outer rows and columns that the
// clamp folded onto a border pixel (above row 0 only k's first row reads
// the plane, below row H - 1 only its last; likewise for columns). `at`
// points at (h, w) in the tile; the tile covers (h +- 1, w +- 1). The sums
// run in another order than the plain version's, well inside K2's 1e-4.
template <int LD>
__device__ __forceinline__ float stencil3_adjoint_tile(const float* at,
                                                       const float (&k)[9], int H,
                                                       int W, int h, int w) {
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) z += k[i * 3 + j] * at[(1 - i) * LD + 1 - j];
  const bool top = h == 0, bottom = h == H - 1, left = w == 0, right = w == W - 1;
  if (top || bottom || left || right) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (top) z += k[j] * at[1 - j];
      if (bottom) z += k[6 + j] * at[1 - j];
      if (left) z += k[j * 3] * at[(1 - j) * LD];
      if (right) z += k[j * 3 + 2] * at[(1 - j) * LD];
    }
    if (top && left) z += k[0] * at[0];
    if (top && right) z += k[2] * at[0];
    if (bottom && left) z += k[6] * at[0];
    if (bottom && right) z += k[8] * at[0];
  }
  return z;
}

// K2's Canny branch: the band's share of dx from the edge map, one plane for
// every channel, into sE. Per strip: x with a 4-pixel halo (cp.async) and
// u_edge = w sum_c U on the band plus 2, the summed blur with 3, u_gx / u_gy
// on the band plus 2 (mag, gx, gy recomputed), u_summed plus 1 (K3b's Sobel
// adjoints), then the blur's adjoint.
__device__ __forceinline__ void band_canny_adjoint(const float* __restrict__ xb,
                                                   const float* __restrict__ ub,
                                                   const float* __restrict__ yb,
                                                   const float* g, const Params& p,
                                                   int h0, float* sX, float* sE,
                                                   int lde) {
  constexpr int XH = kBandRows + 8, XW = kStripW + 8;
  constexpr int SH = kBandRows + 6, SW = kStripW + 6;
  constexpr int GH = kBandRows + 4, GW = kStripW + 4;
  constexpr int UH = kBandRows + 2, UW = kStripW + 2;
  const int C = p.C, H = p.H, W = p.W;
  float* sS = sX + C * XH * XW;
  float* sG0 = sS + SH * SW;  // u_gx at (h0-2+r, w0-2+s), 0 off the plane
  float* sG1 = sG0 + GH * GW;  // u_gy
  float* sU = sG1 + GH * GW;   // u_summed at (h0-1+r, w0-1+s), 0 off the plane
  float gr[9], sx[9], sy[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    gr[i] = g[i];
    sx[i] = kSobelX[i];
    sy[i] = kSobelY[i];
  }
  for (int w0 = 0; w0 < W; w0 += kStripW) {
    for (int i = threadIdx.x; i < C * XH * XW; i += kBandThreads) {
      const int c = i / (XH * XW), r = (i / XW) % XH, s = i % XW;
      cp_async4(sX + i, xb + ((size_t)c * H + clampi(h0 - 4 + r, 0, H - 1)) * W +
                            clampi(w0 - 4 + s, 0, W - 1));
    }
    for (int i = threadIdx.x; i < GH * GW; i += kBandThreads) {
      const int h = h0 - 2 + i / GW, w = w0 - 2 + i % GW;
      float u_edge = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        for (int c = 0; c < C; ++c) {
          const size_t k = ((size_t)c * H + h) * W + w;
          u_edge += ub[k] * clip_mask(yb[k]);
        }
      }
      sG0[i] = u_edge * p.w;
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < SH * SW; i += kBandThreads) {
      const int h = clampi(h0 - 3 + i / SW, 0, H - 1);
      const int w = clampi(w0 - 3 + i % SW, 0, W - 1);
      sS[i] = blur_sum_tile<XW, XH * XW>(sX, gr, C, h - h0 + 4, w - w0 + 4);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GH * GW; i += kBandThreads) {
      const int r = i / GW, s = i % GW, h = h0 - 2 + r, w = w0 - 2 + s;
      float v0 = 0.f, v1 = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        const Grad gd = sobel_mag_tile<SW>(sS, C, r + 1, s + 1);
        const float u_edge = sG0[i];
        const float mag_m = (gd.mag < p.alpha) ? 0.f : gd.mag;
        const bool keep = mag_m > p.high && mag_m <= 1.001f && gd.mag >= p.alpha;
        const float u_mag = keep ? u_edge : 0.f;
        const float inv = (gd.mag == 0.f) ? 0.f : __frcp_rn(gd.mag);
        v0 = u_mag * gd.gx * inv;
        v1 = u_mag * gd.gy * inv;
      }
      sG0[i] = v0;
      sG1[i] = v1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < UH * UW; i += kBandThreads) {
      const int r = i / UW, s = i % UW, h = h0 - 1 + r, w = w0 - 1 + s;
      float v = 0.f;
      if (h >= 0 && h < H && w >= 0 && w < W) {
        const int at = (r + 1) * GW + s + 1;
        v = (stencil3_adjoint_tile<GW>(sG0 + at, sx, H, W, h, w) +
             stencil3_adjoint_tile<GW>(sG1 + at, sy, H, W, h, w)) / (float)C;
      }
      sU[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBandRows * kStripW; i += kBandThreads) {
      const int r = i / kStripW, s = i % kStripW, h = h0 + r, w = w0 + s;
      if (h >= H || w >= W) continue;
      sE[r * lde + w] =
          stencil3_adjoint_tile<UW>(sU + (r + 1) * UW + s + 1, gr, H, W, h, w);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ stripes,
                    const float* __restrict__ sq_delta, const float* __restrict__ lr,
                    const float* __restrict__ li, const float* __restrict__ rr,
                    const float* __restrict__ ri, const float* __restrict__ gtaps,
                    float* __restrict__ out, float* __restrict__ y, Params p,
                    BandLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, h0 = blockIdx.x * kBandRows;
  float* sE = smem;
  float* sT = smem + L.t;
  float* sS = smem + L.s;
  __shared__ float g[9];
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  __syncthreads();
  const float* xb = x + (size_t)b * C * HW;
  band_edge(xb, g, p, h0, sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)b * C + c) * HW;
    SquarePlane<kPlanePerThread> plane{
        xb + (size_t)c * HW, p.square ? stripes + ((size_t)b * C + c) * W : nullptr,
        p.square ? sq_delta + (size_t)c * HW : nullptr, H, W, p.eps, p.square};
    float* yc = y + off;
    float* oc = out + off;
    band_hfs(L, H, W, h0, lr, li, rr, ri, sT, sS, plane,
             [&](int r, int h, int w, float hfs) {
               const float yv = __fadd_rn(hfs, __fmul_rn(p.w, sE[r * L.wq + w]));
               yc[h * W + w] = yv;
               oc[h * W + w] = clip01(yv);
             });
  }
}

__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_bwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
                    const float* __restrict__ stripes,
                    const float* __restrict__ sq_delta, const float* __restrict__ y,
                    const float* __restrict__ lr, const float* __restrict__ li,
                    const float* __restrict__ rr, const float* __restrict__ ri,
                    const float* __restrict__ gtaps, float* __restrict__ dx,
                    Params p, BandLayout L) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, h0 = blockIdx.x * kBandRows;
  float* sE = smem;
  float* sT = smem + L.t;
  float* sS = smem + L.s;
  __shared__ float g[9];
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  __syncthreads();
  const size_t img = (size_t)b * C * HW;
  band_canny_adjoint(x + img, u + img, y + img, g, p, h0, sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = img + (size_t)c * HW;
    CotangentPlane<kPlanePerThread> plane{u + off, y + off, H, W};
    const float* xc = x + off;
    const float* st = p.square ? stripes + ((size_t)b * C + c) * W : nullptr;
    const float* sqd = p.square ? sq_delta + (size_t)c * HW : nullptr;
    float* dxc = dx + off;
    band_hfs(L, H, W, h0, lr, li, rr, ri, sT, sS, plane,
             [&](int r, int h, int w, float dxs) {
               const int q = h * W + w;
               const float d = p.square ? square_bwd(dxs, xc[q], st[w], sqd[q], p.eps)
                                        : dxs;
               dxc[q] = d + sE[r * L.wq + w];
             });
  }
}

// ---- K3a/K3b: the Canny-only pair ------------------------------------------
//
// Replaces ee_fused.py::_canny_fwd_kernel and ::_canny_bwd_kernel. A block
// owns a kCannyH x kCannyW tile of one image. K3a stages the C planes of x
// with a 2-pixel edge-replicated halo (the blur's and the Sobel's reach) and
// the summed blur with a 1-pixel halo in shared memory; K3b stages the
// Sobel-adjoint inputs with a 2-pixel halo and u_summed with a 1-pixel halo.
// Halo entries hold the clamped reads, so the stencil helpers above run on
// tile-local planes unchanged and K3a's edge map is K1's bit for bit. Any
// H x W takes ceil(H/16) x ceil(W/32) tiles; only C is bounded (by shared
// memory). What bounds both: bytes. K3a reads x and writes four (B, 1, H, W)
// planes, K3b reads those four and writes dx; the stencils are a few dozen
// FP32 operations a pixel.

constexpr int kCannyH = 16, kCannyW = 32;
constexpr int kXH = kCannyH + 4, kXW = kCannyW + 4;  // 2-pixel halo
constexpr int kSH = kCannyH + 2, kSW = kCannyW + 2;  // 1-pixel halo

__host__ __device__ inline size_t canny_fwd_smem_floats(int C) {
  return (size_t)C * kXH * kXW + (size_t)kSH * kSW;
}

__global__ void __launch_bounds__(kThreads)
canny_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gtaps,
                 float* __restrict__ out, float* __restrict__ mag,
                 float* __restrict__ gx, float* __restrict__ gy, Params p) {
  extern __shared__ float smem[];
  const int C = p.C, H = p.H, W = p.W;
  const int b = blockIdx.z, h0 = blockIdx.y * kCannyH, w0 = blockIdx.x * kCannyW;
  float* sX = smem;                 // x at (clamp(h0-2+r), clamp(w0-2+s))
  float* sS = sX + C * kXH * kXW;   // summed blur at (clamp(h0-1+r), clamp(w0-1+s))
  __shared__ float g[9];
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  const float* xb = x + (size_t)b * C * H * W;
  for (int i = threadIdx.x; i < C * kXH * kXW; i += blockDim.x) {
    const int c = i / (kXH * kXW), r = (i / kXW) % kXH, s = i % kXW;
    sX[i] = xb[((size_t)c * H + clampi(h0 - 2 + r, 0, H - 1)) * W +
               clampi(w0 - 2 + s, 0, W - 1)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSH * kSW; i += blockDim.x) {
    const int h = clampi(h0 - 1 + i / kSW, 0, H - 1);
    const int w = clampi(w0 - 1 + i % kSW, 0, W - 1);
    sS[i] = blur_sum(sX, g, C, kXH, kXW, h - h0 + 2, w - w0 + 2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kCannyH * kCannyW; i += blockDim.x) {
    const int r = i / kCannyW, s = i % kCannyW, h = h0 + r, w = w0 + s;
    if (h >= H || w >= W) continue;
    const Grad gr = sobel_mag(sS, C, kSH, kSW, r + 1, s + 1);
    const size_t q = ((size_t)b * H + h) * W + w;
    out[q] = edge_of(gr.mag, p);
    mag[q] = gr.mag;
    gx[q] = gr.gx;
    gy[q] = gr.gy;
  }
}

__global__ void __launch_bounds__(kThreads)
canny_bwd_kernel(const float* __restrict__ u, const float* __restrict__ mag,
                 const float* __restrict__ gx, const float* __restrict__ gy,
                 const float* __restrict__ gtaps, float* __restrict__ dx,
                 Params p) {
  __shared__ float sG0[kXH * kXW];  // u_gx at (h0-2+r, w0-2+s), 0 off the plane
  __shared__ float sG1[kXH * kXW];  // u_gy
  __shared__ float sU[kSH * kSW];   // u_summed at (h0-1+r, w0-1+s)
  __shared__ float g[9];
  const int C = p.C, H = p.H, W = p.W;
  const int b = blockIdx.z, h0 = blockIdx.y * kCannyH, w0 = blockIdx.x * kCannyW;
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  const size_t plane = (size_t)b * H * W;
  for (int i = threadIdx.x; i < kXH * kXW; i += blockDim.x) {
    const int h = h0 - 2 + i / kXW, w = w0 - 2 + i % kXW;
    float v0 = 0.f, v1 = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) {
      const size_t q = plane + (size_t)h * W + w;
      const float m = mag[q];
      const float mag_m = (m < p.alpha) ? 0.f : m;
      const bool keep = mag_m > p.high && mag_m <= 1.001f && m >= p.alpha;
      const float u_mag = keep ? u[q] : 0.f;
      const float inv = (m == 0.f) ? 0.f : 1.f / m;
      v0 = u_mag * gx[q] * inv;
      v1 = u_mag * gy[q] * inv;
    }
    sG0[i] = v0;
    sG1[i] = v1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSH * kSW; i += blockDim.x) {
    const int h = h0 - 1 + i / kSW, w = w0 - 1 + i % kSW;
    if (h < 0 || h >= H || w < 0 || w >= W) continue;
    sU[i] = (stencil3_adjoint(sG0, kXW, h0 - 2, w0 - 2, kSobelX, H, W, h, w) +
             stencil3_adjoint(sG1, kXW, h0 - 2, w0 - 2, kSobelY, H, W, h, w)) /
            (float)C;
  }
  __syncthreads();
  // the blur's adjoint of the channel-broadcast u_summed: one plane, written
  // to every channel
  for (int i = threadIdx.x; i < kCannyH * kCannyW; i += blockDim.x) {
    const int h = h0 + i / kCannyW, w = w0 + i % kCannyW;
    if (h >= H || w >= W) continue;
    const float v = stencil3_adjoint(sU, kSW, h0 - 1, w0 - 1, g, H, W, h, w);
    for (int c = 0; c < C; ++c) dx[(((size_t)b * C + c) * H + h) * W + w] = v;
  }
}

constexpr int kMaxDevices = 64;
size_t g_fwd_smem[kMaxDevices], g_bwd_smem[kMaxDevices], g_canny_smem[kMaxDevices];

// Opt `kernel` into `bytes` of dynamic shared memory on the current device,
// once per kernel, device and size: the attribute outlives the launch, and
// setting it on every launch would put a host call inside CUDA graph
// captures of the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t: 0 when the launch was accepted.
// K1/K2 take the block geometry that the wrapper computed: `layout` holds
// BandLayout's seven fields in order, `bands` the blocks per image and
// `smem_bytes` a block's dynamic shared memory; and the operators it padded
// to layout's shapes (lr, li: bands x band rows by hk; rr, ri: wk x wt).
int ee_fused_fwd(const float* x, const float* stripes, const float* sq_delta,
                 const float* lr, const float* li, const float* rr,
                 const float* ri, const float* gtaps, float* out, float* y,
                 int B, int C, int H, int W, float eps, float w, float alpha,
                 float high, int square, const int* layout, int bands,
                 size_t smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(ee_fused_fwd_kernel, smem_bytes, g_fwd_smem);
  if (err != cudaSuccess) return (int)err;
  const Params p{B, C, H, W, eps, w, alpha, high, square};
  const BandLayout L{layout[0], layout[1], layout[2], layout[3],
                     layout[4], layout[5], layout[6]};
  ee_fused_fwd_kernel<<<dim3(bands, B), kBandThreads, smem_bytes,
                        (cudaStream_t)stream>>>(x, stripes, sq_delta, lr, li, rr, ri,
                                                gtaps, out, y, p, L);
  return (int)cudaGetLastError();
}

int ee_fused_bwd(const float* u, const float* x, const float* stripes,
                 const float* sq_delta, const float* y, const float* lr,
                 const float* li, const float* rr, const float* ri,
                 const float* gtaps, float* dx, int B, int C, int H, int W,
                 float eps, float w, float alpha, float high, int square,
                 const int* layout, int bands, size_t smem_bytes, void* stream) {
  const cudaError_t err = allow_smem(ee_fused_bwd_kernel, smem_bytes, g_bwd_smem);
  if (err != cudaSuccess) return (int)err;
  const Params p{B, C, H, W, eps, w, alpha, high, square};
  const BandLayout L{layout[0], layout[1], layout[2], layout[3],
                     layout[4], layout[5], layout[6]};
  ee_fused_bwd_kernel<<<dim3(bands, B), kBandThreads, smem_bytes,
                        (cudaStream_t)stream>>>(u, x, stripes, sq_delta, y, lr, li, rr,
                                                ri, gtaps, dx, p, L);
  return (int)cudaGetLastError();
}

size_t canny_fused_smem_bytes(int C) {
  return canny_fwd_smem_floats(C) * sizeof(float);
}

int canny_fused_fwd(const float* x, const float* gtaps, float* out, float* mag,
                    float* gx, float* gy, int B, int C, int H, int W,
                    float alpha, float high, void* stream) {
  const size_t bytes = canny_fused_smem_bytes(C);
  const cudaError_t err = allow_smem(canny_fwd_kernel, bytes, g_canny_smem);
  if (err != cudaSuccess) return (int)err;
  Params p{B, C, H, W, 0.f, 0.f, alpha, high, 0};
  const dim3 grid((W + kCannyW - 1) / kCannyW, (H + kCannyH - 1) / kCannyH, B);
  canny_fwd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, gtaps, out, mag, gx, gy, p);
  return (int)cudaGetLastError();
}

int canny_fused_bwd(const float* u, const float* mag, const float* gx,
                    const float* gy, const float* gtaps, float* dx, int B,
                    int C, int H, int W, float alpha, float high,
                    void* stream) {
  Params p{B, C, H, W, 0.f, 0.f, alpha, high, 0};
  const dim3 grid((W + kCannyW - 1) / kCannyW, (H + kCannyH - 1) / kCannyH, B);
  canny_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      u, mag, gx, gy, gtaps, dx, p);
  return (int)cudaGetLastError();
}

const char* ee_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
