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
// pixel. They take float32 (canny_fwd_kernel, canny_bwd_kernel) or bfloat16
// (canny_fwd_bf16_kernel, canny_bwd_bf16_kernel): JAX's Canny-only kernel
// computes in the image's dtype, so its bfloat16 form rounds every step to
// bfloat16 but the channel sum, the division by C and the magnitude
// included (K1's keep those in float32), and its adjoint tap by tap. The
// bfloat16 pair runs that arithmetic on packed bf16x2 instructions, two
// pixels an instruction, on bfloat16 tiles, and gives its bits (the section
// "K3a/K3b in bfloat16" below); the float32 K3b sums the taps in another
// order.
//
// K1, K2 and the float32 K3a/K3b run one copy of the Canny code, on tiles
// that hold a plane and its halo in shared memory: staged by cp.async, 16
// bytes at a time where the row allows, the halo holding the edge's reads
// (x) or zeros (cotangents), so no tap clamps; the last stage on quads, 4
// pixels a thread, read and written 16 bytes at a time. The forward rounds every product and sum on
// its own (__fmul_rn, __fadd_rn: no FMA contraction) in the tap order of the
// PyTorch composition (row-major), so the edge maps of K1, K3a and the plain
// version agree exactly: `mag > high` flips on one-ulp differences. The
// square chain does the same, since its clips decide gradient ties. The
// float32 HFS products stay on the FP32 pipes.
//
// K1 and K2 also take bfloat16 (ee_fused_fwd_bf16_kernel,
// ee_fused_bwd_bf16_kernel), as the same JAX kernels compute in x's dtype
// (the bf16 policy of the fast-AT recipes). A number policy (F32, BF16
// below) loads and stores the tensors' type and rounds to bfloat16 at
// exactly the points where the JAX kernel's dtype is bfloat16: each product
// and sum of the blur, the Sobel and the square chain; the channel sum
// (summed in float32, rounded once); T = A X (K1) and U B (K2), each one
// float32 sum rounded once; hfs, the float32 difference of the two
// sandwiches, rounded once; w * edge and y; dx = dx_hfs + dx_canny summed in
// float32 and rounded once. Everything else computes in float32 registers,
// as the JAX kernel's float32 accumulations, magnitude chain and Canny
// adjoint do. JAX contracts K2's adjoint over W first (U B, then A^T), so the
// bfloat16 K2 works on the transposed problem, dx^T = B^T U^T A: a block
// owns a band of kBandRows image columns, and its Canny branch walks the
// column band in strips of kStripW rows (band_canny_adjoint<true>).
//
// What bounds the bfloat16 pair: bytes (22.6 us for K1, 30.1 us for K2 at
// fast-AT's 256 x 3 x 128 x 128). Their products, 12.9 GFLOP a launch there,
// are bf16 x bf16 summed in float32, as JAX's `_bmm` (a bf16 dot_general with
// preferred_element_type float32): on the FP32 pipes they alone take at least
// 0.19 ms, on the bf16 tensor cores 13 us. So the bfloat16 forms run products
// on the tensor cores: mma.sync m16n8k16 (bf16 in, float32 accumulators) fed
// by ldmatrix from bfloat16 tiles in shared memory, the operators streamed by
// 16-byte cp.async and the planes by 16-byte row segments through registers
// (their transforms need the threads), two stages deep, the next chunk's
// copies in flight during this chunk's mma. mma.sync, not wgmma: the second
// product has 32 rows a band (Tr Rr and Ti Ri have different B operands),
// below wgmma's 64, and a warp holding both of its accumulators forms
// Tr Rr - Ti Ri in registers; at these shapes the tensor cores are not the
// limit either way. The Canny branch stays on the FP32 pipes, exactly
// rounded and shared with the float32 forms.
//
// The order of the sums is part of K1's result. K1's out and y are held to
// one bf16 ulp of the plain version, whose products are float32 FMA chains
// in k order; where hfs is small beside its terms, and T rounds to bfloat16
// once before the second product, any other order moves hfs by more than an
// ulp (up to 27 ulps at 224 and 288 px on an H100; exact sums do no
// better). So K1 computes T on the FP32 pipes in that order (band_hfs's
// tiles and chunks, on a ring of up to 4 stages with x staged raw by
// cp.async: band_t_ring), and hfs on the tensor cores with a bound on its
// distance from the FMA chains' result: the 2-3% of outputs whose bound
// straddles a bfloat16 rounding point are recomputed as FMA chains, and K1
// gives the plain version's bits (mma_hfs<EXACT>). K2's limits allow its
// sums' order: both its products run on the tensor cores. JAX contracts K2
// over W first, so its U is the plane of the transposed problem; K2 stages U
// in its own row-major layout, which is already [column][k] of U^T, and
// feeds the B fragments by plain ldmatrix (the tiles of R by .trans), so no
// load or store of K2 strides across W: u, y, x, sq_delta and dx move as
// 16-byte row segments, the result tiles go out through shared memory, and
// the column Canny branch writes its plane as float4 row segments.

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
// The Canny branch's division by C, magnitude and adjoint are float32 (the
// JAX fused kernel computes them in float32).
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

// The float32 values of the low and high bfloat16 of a 32-bit word.
__device__ __forceinline__ float bf16_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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
template <class T, class Issue, class Fetch, class Put, class Compute>
__device__ __forceinline__ void pipeline(int nk, T* stages, int stage_elems,
                                         Issue issue, Fetch fetch, Put put,
                                         Compute compute) {
  issue(0, stages);
  cp_async_commit();
  fetch(0);
  put(stages);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    T* cur = stages + (t & 1) * stage_elems;
    T* nxt = stages + ((t + 1) & 1) * stage_elems;
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

// K2's plane: U = u clip'(y) of one channel, 0 off the plane.
template <int Q, class P>
struct CotangentPlane {
  using T = typename P::T;
  const T *u, *y;
  int H, W;
  float vu[Q], vy[Q];
  bool ok[Q];
  __device__ __forceinline__ void load(int q, int h, int w) {
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

__device__ __forceinline__ bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
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

// v to p[0 .. 3] as bfloat16: 8 bytes at once when `vec`, else the first n
// one by one.
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, float4 v, bool vec, int n) {
  const float a[4] = {v.x, v.y, v.z, v.w};
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&lo);
    q.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
    return;
  }
  for (int j = 0; j < n && j < 4; ++j) p[j] = __float2bfloat16_rn(a[j]);
}

// Stages n planes (plane(i) points at plane i's pixel (0, 0), rows W floats
// apart) into n consecutive tiles T at dst. Unit e is 4 columns of one row,
// floats [4 e, 4 e + 4) of every tile: one 16-byte cp.async a plane where
// its 4 pixels lie in the plane and `vec` holds (W % 4 == 0 and the planes
// start on 16 bytes), else 4-byte copies. A read off the plane takes the
// nearest edge pixel (REPLICATE) or zero. A thread that has waited for its
// own copies may read its own units before any barrier. Planes of the
// policy P's type: float32 by cp.async; bfloat16 loaded by the thread, all
// of its units of a plane at once (8 bytes each where `vec` holds), then
// converted to float32 and stored, so the tile is float32 either way.
template <class T, int THREADS, bool REPLICATE, class P, class Plane>
__device__ __forceinline__ void stage_tile(float* dst, int n, Plane plane, int H, int W,
                                           int h0, int w0, bool vec) {
  constexpr int kUnitsPerRow = T::kLd / 4;
  if constexpr (std::is_same<P, F32>::value) {
    for (int e = threadIdx.x; e < T::kFloats / 4; e += THREADS) {
      const int h = h0 - T::kHalo + e / kUnitsPerRow, w = w0 - 4 + 4 * (e % kUnitsPerRow);
      float* d = dst + 4 * e;
      const bool row_in = h >= 0 && h < H;
      if (vec && row_in && w >= 0 && w + 4 <= W) {
        for (int i = 0; i < n; ++i) cp_async16(d + i * T::kFloats, plane(i) + (size_t)h * W + w);
        continue;
      }
      const size_t row = (size_t)clampi(h, 0, H - 1) * W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = row_in && w + j >= 0 && w + j < W;
        const size_t q = row + clampi(w + j, 0, W - 1);
        for (int i = 0; i < n; ++i) {
          if (!REPLICATE && !in)
            d[i * T::kFloats + j] = 0.f;
          else
            cp_async4(d + i * T::kFloats + j, plane(i) + q);
        }
      }
    }
  } else {
    constexpr int kUnits = T::kFloats / 4, kPer = (kUnits + THREADS - 1) / THREADS;
    for (int i = 0; i < n; ++i) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(plane(i));
      uint2 v[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * THREADS;
        v[q] = make_uint2(0u, 0u);
        if (e >= kUnits) continue;
        const int h = h0 - T::kHalo + e / kUnitsPerRow, w = w0 - 4 + 4 * (e % kUnitsPerRow);
        const bool row_in = h >= 0 && h < H;
        if (vec && row_in && w >= 0 && w + 4 <= W) {
          v[q] = __ldg(reinterpret_cast<const uint2*>(src + (size_t)h * W + w));
          continue;
        }
        const size_t row = (size_t)clampi(h, 0, H - 1) * W;
        unsigned b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = row_in && w + j >= 0 && w + j < W;
          b[j] = (!REPLICATE && !in) ? 0u : __ldg(src + row + clampi(w + j, 0, W - 1));
        }
        v[q] = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * THREADS;
        if (e < kUnits)
          *reinterpret_cast<float4*>(dst + i * T::kFloats + 4 * e) =
              make_float4(bf16_lo(v[q].x), bf16_hi(v[q].x), bf16_lo(v[q].y), bf16_hi(v[q].y));
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
// the same. The Sobel sums round by P; the division, each product and sum of
// the magnitude and its square root are float32.
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
// (In bfloat16 the window's top is 1: no bfloat16 value lies in (1, 1.001].)
__device__ __forceinline__ bool gate_keeps(float mag, const Params& p) {
  const float mag_m = (mag < p.alpha) ? 0.f : mag;
  return mag_m > p.high && mag_m <= 1.001f && mag >= p.alpha;
}

// 1 / mag, 0 at mag = 0 (the operand guarded as in sobel_mag_tile).
__device__ __forceinline__ float inv_mag(float mag) {
  return (mag == 0.f) ? 0.f : __frcp_rn(mag == 0.f ? 1.f : mag);
}

__device__ __forceinline__ float2 gate(float u, float mag, float gx, float gy,
                                       const Params& p) {
  const float u_mag = gate_keeps(mag, p) ? u : 0.f;
  const float inv = inv_mag(mag);
  return make_float2(__fmul_rn(__fmul_rn(u_mag, gx), inv), __fmul_rn(__fmul_rn(u_mag, gy), inv));
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
// blur's adjoint of u_summed at pixels (h0 + r, w0 + s .. s + 3), in
// float32. Ends without a barrier.
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
      auto r0 = [&](int di, int dj) { return a0[di * G::kLd + dj]; };
      auto r1 = [&](int di, int dj) { return a1[di * G::kLd + dj]; };
      v = (stencil3_adjoint_tile(r0, sx, H, W, h, w) + stencil3_adjoint_tile(r1, sy, H, W, h, w)) /
          (float)C;
    }
    sU[U::at(r, s)] = v;
  }
  __syncthreads();
  for_each_quad<U, THREADS>(sU, [&](int r, int s, const float (&win)[3][6]) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      auto a = [&](int di, int dj) { return win[1 + di][1 + j + dj]; };
      v[j] = stencil3_adjoint_tile(a, g, H, W, h0 + r, w0 + s + j);
    }
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
// of kStripW x kBandRows pixels down it, sE[h][s] holding image row h of
// columns band0 + s (lde = kBandRows), so both store row segments.
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
  const bool quads = W % 4 == 0 && aligned8(ub) && aligned8(yb);
  for (int k0 = 0; k0 < (COLUMNS ? H : W); k0 += COLUMNS ? ROWS : COLS) {
    const int h0 = COLUMNS ? k0 : band0, w0 = COLUMNS ? band0 : k0;
    stage_tile<X, kBandThreads, true, P>(
        smem, C, [&](int c) { return xb + (size_t)c * H * W; }, H, W, h0, w0, vec);
    cp_async_commit();
    if constexpr (COLUMNS) {
      // the bfloat16 K2: quads of 4 image columns from w0 - 4, 8-byte loads
      // where the rows allow, every channel's issued together (the columns
      // past the halo are never read)
      constexpr int kQuads = COLS / 4 + 2;
      for (int i = threadIdx.x; i < G::kRows * kQuads; i += kBandThreads) {
        const int r = i / kQuads - 2, s = 4 * (i % kQuads) - 4, h = h0 + r, w = w0 + s;
        float u_edge[4] = {0.f, 0.f, 0.f, 0.f};
        if (h >= 0 && h < H) {
          if (quads && w >= 0 && w + 4 <= W) {
            for (int c = 0; c < C; ++c) {
              const size_t k = ((size_t)c * H + h) * W + w;
              const uint2 vu = __ldg(reinterpret_cast<const uint2*>(ub + k));
              const uint2 vy = __ldg(reinterpret_cast<const uint2*>(yb + k));
              const float uj[4] = {bf16_lo(vu.x), bf16_hi(vu.x), bf16_lo(vu.y), bf16_hi(vu.y)};
              const float yj[4] = {bf16_lo(vy.x), bf16_hi(vy.x), bf16_lo(vy.y), bf16_hi(vy.y)};
#pragma unroll
              for (int j = 0; j < 4; ++j) u_edge[j] += P::r(uj[j] * clip_mask(yj[j]));
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (w + j < 0 || w + j >= W) continue;
              for (int c = 0; c < C; ++c) {
                const size_t k = ((size_t)c * H + h) * W + w + j;
                u_edge[j] += P::r(P::load(ub + k) * clip_mask(P::load(yb + k)));
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sG0[G::at(r, s + j)] = P::r(P::r(u_edge[j]) * p.w);
      }
    } else {
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
          } else if (h0 + r < H) {
            store_quad(sE + (h0 + r) * lde + s, v, true, 4);
          }
        });
    __syncthreads();
  }
}

__device__ __forceinline__ void load_taps(const float* __restrict__ gtaps, float (&g)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = __ldg(gtaps + i);
}

// K1 in float32.
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ stripes,
                    const float* __restrict__ sq_delta, const float* __restrict__ lr,
                    const float* __restrict__ li, const float* __restrict__ rr,
                    const float* __restrict__ ri, const float* __restrict__ gtaps,
                    float* __restrict__ out, float* __restrict__ y, Params p, BandLayout L) {
  using P = F32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, h0 = blockIdx.x * kBandRows;
  float* sE = smem;
  float* sT = smem + L.t;
  float* sS = smem + L.s;
  float g[9];
  load_taps(gtaps, g);
  const float* xb = x + (size_t)b * C * HW;
  band_edge<P>(xb, g, p, h0, W % 4 == 0 && aligned16(x), sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)b * C + c) * HW;
    SquarePlane<kPlanePerThread, P> plane{
        xb + (size_t)c * HW, p.square ? stripes + ((size_t)b * C + c) * W : nullptr,
        p.square ? sq_delta + (size_t)c * HW : nullptr, H, W, p.eps, p.square};
    float* yc = y + off;
    float* oc = out + off;
    band_hfs<P>(L, H, W, h0, lr, li, rr, ri, sT, sS, plane,
                [&](int r, int h, int w, float hfs) {
                  const float yv = P::r(__fadd_rn(
                      P::r(hfs), P::r(__fmul_rn(p.w, sE[r * L.wq + w]))));
                  P::store(yc + h * W + w, yv);
                  P::store(oc + h * W + w, clip01(yv));
                });
  }
}

// K2 in float32, on row bands.
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_bwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
                    const float* __restrict__ stripes, const float* __restrict__ sq_delta,
                    const float* __restrict__ y, const float* __restrict__ lr,
                    const float* __restrict__ li, const float* __restrict__ rr,
                    const float* __restrict__ ri, const float* __restrict__ gtaps,
                    float* __restrict__ dx, Params p, BandLayout L) {
  using P = F32;
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
  band_canny_adjoint<false, P>(x + img, u + img, y + img, g, p, band0,
                               W % 4 == 0 && aligned16(x), sS, sE, L.wq);

  for (int c = 0; c < C; ++c) {
    const size_t off = img + (size_t)c * HW;
    CotangentPlane<kPlanePerThread, P> plane{u + off, y + off, H, W};
    const float* xc = x + off;
    const float* st = p.square ? stripes + ((size_t)b * C + c) * W : nullptr;
    const float* sqd = p.square ? sq_delta + (size_t)c * HW : nullptr;
    float* dxc = dx + off;
    auto epilogue = [&](int r, int h, int w, float dxs) {
      const int q = h * W + w;
      const float d = p.square ? square_bwd<P>(dxs, P::load(xc + q), P::load(st + w),
                                               P::load(sqd + q), p.eps)
                               : dxs;
      P::store(dxc + q, d + sE[r * L.wq + w]);
    };
    band_hfs<P>(L, H, W, band0, lr, li, rr, ri, sT, sS, plane, epilogue);
  }
}

// ---- K1/K2 in bfloat16: the HFS products on the tensor cores ---------------
//
// The same bands and Canny branches as above; K1 keeps T on the FP32 pipes
// (band_t_ring) and runs hfs on the tensor cores (mma_hfs<EXACT>), K2 runs
// both products there (mma_t, mma_hfs). ops/cuda/ee_fused.py (mma_geometry)
// owns the layout of a block and passes it in (MmaLayout); it mirrors
// kMmaChunk, kMmaPanel and kMmaPad as MMA_CHUNK, MMA_PANEL and MMA_PAD, and
// a CPU test reads them from this file.

using bf16 = __nv_bfloat16;

constexpr int kMmaChunk = 32;   // contraction depth of a chunk: two k16 steps
constexpr int kMmaPanel = 128;  // columns of T, or of the result, in one pass
constexpr int kMmaPad = 8;      // bfloat16 after each staged row
constexpr int kLdK = kMmaChunk + kMmaPad;  // row stride of a chunk stored [row][k]
constexpr int kLdN = kMmaPanel + kMmaPad;  // row stride of a chunk stored [k][column]
// A stage, in bfloat16: the largest chunk, R's (Rr, Ri, each kMmaChunk x
// kLdN); K2's first product's (the operator rows [Lr; Li], then U's chunk,
// kMmaPanel x kLdK, U's own layout, [column][k]); K1's T stage (float32
// operator rows and plane, raw x and sq_delta). After a pass of mma_hfs the
// first stage holds the result tile ([row][column], kLdN apart, or K2's
// [column][row], kLdK apart) and (EXACT) the second the outputs to
// recompute.
constexpr int kMmaStage = 2 * kMmaChunk * kLdN;
static_assert(2 * kBandRows * kLdK + kMmaPanel * kLdK <= kMmaStage &&
                  kBandRows * kLdN <= kMmaStage && kMmaPanel * kLdK <= kMmaStage &&
                  kBandRows * kMmaPanel * sizeof(unsigned short) <= kMmaStage * sizeof(bf16) &&
                  2 * kBandRows * (kMmaChunk / 8) == kBandThreads &&
                  kBandThreads == 256 && kBandRows == 32,
              "mma geometry: 8 warps, one operator copy a thread");

// Shared memory of a bfloat16 block, from the wrapper: the band's Canny plane
// (K1: kBandRows x lde floats, the edge map; K2: rows of kBandRows floats, one
// per image row, the Canny branch's dx) at 0; at byte t, first the Canny
// strips, then T (2 kBandRows x ldt bfloat16, np columns used); a ring of
// `depth` stages of kMmaStage bfloat16 at byte `stages` (K1's T stage runs
// on all of them, the tensor-core products on the first two). Operators: L
// (lr, li) of bands x kBandRows rows by kp (K1: float32, K2: bfloat16); R
// (rr, ri: bfloat16) of np x np; zeros outside; wt: the columns of T that K1
// computes.
struct MmaLayout {
  int kp, np, wt, lde, ldt, t, stages, depth;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bfloat16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8; .trans hands each thread the transposed
// pairs.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: a 16 x 16 and b 16 x 8 of bfloat16, d 16 x 8
// of float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bfloat16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Element j of 8 bfloat16 held in a uint4, as float32.
__device__ __forceinline__ float bf16_at(const uint4& v, int j) {
  const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return (j & 1) ? bf16_hi(w) : bf16_lo(w);
}

// The 8 bfloat16 at p as raw bits: one 16-byte load when `vec` (and n = 8),
// else the first n (up to 8) one by one and zeros after.
__device__ __forceinline__ uint4 load8(const bf16* p, bool vec, int n) {
  if (vec && n >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  unsigned v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = 2 * i < n ? s[2 * i] : 0u, hi = 2 * i + 1 < n ? s[2 * i + 1] : 0u;
    v[i] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// v rounded to bfloat16 into p[0 .. 7]: one 16-byte store when `vec` (and
// n = 8), else the first n one by one.
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8], bool vec, int n) {
  if (vec && n >= 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    return;
  }
  for (int j = 0; j < n && j < 8; ++j) p[j] = __float2bfloat16_rn(v[j]);
}

// A ring of `depth` stages of kMmaStage bfloat16 (2 to 4, the wrapper's
// choice): chunk t in stage t % depth, depth - 1 chunks in flight. issue(t,
// stage) starts chunk t's copies (one commit group a chunk); once chunk t has
// landed, land(t, stage) lets each thread finish its own copies (it may read
// them before any barrier); then one barrier, the copies of chunk
// t + depth - 1 into the stage that chunk t - 1 held, and compute(t, stage).
// Ends with every copy landed and a barrier.
template <class Issue, class Land, class Compute>
__device__ __forceinline__ void ring(int nk, int depth, bf16* stages, Issue issue, Land land,
                                     Compute compute) {
  for (int s = 0; s < depth - 1; ++s) {
    if (s < nk) issue(s, stages + s * kMmaStage);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    bf16* cur = stages + (t % depth) * kMmaStage;
    // chunk t has landed once at most depth - 2 later groups are in flight
    if (depth >= 4)
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (depth == 3)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      cp_async_wait_all();
    land(t, cur);
    __syncthreads();
    const int next = t + depth - 1;
    if (next < nk) issue(next, stages + (next % depth) * kMmaStage);
    cp_async_commit();
    compute(t, cur);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The bfloat16 K2's plane: U = u clip'(y) of one channel, 0 off the plane,
// on the transposed problem, whose contraction rows k are image columns and
// its columns n image rows. A chunk of kMmaChunk rows at k0 by kMmaPanel
// columns at n0 is 512 segments of 8 pixels of an image row, two a thread:
// load() reads a thread's segments of u and y into registers (16 bytes at
// once where `vec` holds), store() forms U and writes it to the chunk, which
// is U's own [column][k] (plain ldmatrix gives the B fragments of U^T).
struct CotangentMma {
  const bf16 *u, *y;
  int H, W;
  bool vec;
  uint4 vu[2], vy[2];
  int n[2];
  __device__ __forceinline__ void load(int k0, int n0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = threadIdx.x + q * kBandThreads;
      const int h = n0 + e / (kMmaChunk / 8), w = k0 + 8 * (e % (kMmaChunk / 8));
      n[q] = h < H ? min(8, W - w) : 0;
      vu[q] = load8(u + (size_t)h * W + w, vec, n[q]);
      vy[q] = load8(y + (size_t)h * W + w, vec, n[q]);
    }
  }
  __device__ __forceinline__ void store(bf16* chunk) const {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = threadIdx.x + q * kBandThreads;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = j < n[q] ? BF16::r(bf16_at(vu[q], j) * clip_mask(bf16_at(vy[q], j))) : 0.f;
      *reinterpret_cast<uint4*>(chunk + (e / (kMmaChunk / 8)) * kLdK +
                                8 * (e % (kMmaChunk / 8))) =
          make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                     pack_bf16(v[6], v[7]));
    }
  }
};

// The lane's row and column in the four 8 x 8 matrices of an ldmatrix, for
// the fragments of mma m16n8k16: A tiles stored [row][k]; B tiles stored
// [k][n] (ldmatrix.trans) or [n][k].
struct Frag {
  int a_r, a_c, bt_k, bt_n, bn_n, bn_k;
  __device__ __forceinline__ explicit Frag(int lane)
      : a_r(lane % 16), a_c(8 * (lane / 16)), bt_k(lane % 8 + 8 * ((lane / 8) & 1)),
        bt_n(8 * (lane / 16)), bn_n(lane % 8 + 8 * (lane / 16)), bn_k(8 * ((lane / 8) & 1)) {}
  // the B fragments of the 4 n8 tiles at columns c0 .. c0 + 31, contraction
  // rows k .. k + 15, of a [k][n] tile (TRANS, row stride ld) or an [n][k] one
  template <bool TRANS>
  __device__ __forceinline__ void b4(unsigned (&b)[4][2], const bf16* tile, int ld, int k,
                                     int c0) const {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      unsigned r[4];
      if constexpr (TRANS)
        ldsm4_trans(r, tile + (k + bt_k) * ld + c0 + 16 * jj + bt_n);
      else
        ldsm4(r, tile + (c0 + 16 * jj + bn_n) * ld + k + bn_k);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
  }
};

// The bfloat16 K2's T = [Lr; Li] X on the tensor cores, for the band of
// kBandRows product rows at band0, into T's tile (2 kBandRows x ldt), each
// float32 sum rounded to bfloat16 once; pass by pass of kMmaPanel columns,
// chunk by chunk of kMmaChunk on two stages: the operator rows by cp.async,
// the plane through registers. 8 warps, 2 x 4: a warp owns 32 rows (wm = 0:
// Lr / Tr, wm = 1: Li / Ti) by 32 columns of a pass, 2 x 4 mma tiles; a warp
// whose columns lie past np (a multiple of 32) skips its mma. Ends with a
// barrier.
template <class Plane>
__device__ __forceinline__ void mma_t(const MmaLayout& L, int band0,
                                      const bf16* __restrict__ lr,
                                      const bf16* __restrict__ li, char* smem, Plane& plane) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, tg = lane % 4;
  const Frag f(lane);
  bf16* sT = reinterpret_cast<bf16*>(smem + L.t);
  bf16* stages = reinterpret_cast<bf16*>(smem + L.stages);
  float acc[2][4][4];
  for (int n0 = 0; n0 < L.np; n0 += kMmaPanel) {
    const bool active = n0 + 32 * wn < L.np;
    auto issue = [&](int t, bf16* st) {
      const int i = tid / (kMmaChunk / 8), m = tid % (kMmaChunk / 8);
      cp_async16(st + i * kLdK + 8 * m, (i < kBandRows ? lr : li) +
                                            (size_t)(band0 + i % kBandRows) * L.kp +
                                            t * kMmaChunk + 8 * m);
    };
    auto fetch = [&](int t) { plane.load(t * kMmaChunk, n0); };
    auto put = [&](bf16* st) { plane.store(st + 2 * kBandRows * kLdK); };
    auto compute = [&](int, const bf16* st) {
      if (!active) return;
#pragma unroll
      for (int ks = 0; ks < kMmaChunk; ks += 16) {
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm4(a[mi], st + (32 * wm + 16 * mi + f.a_r) * kLdK + ks + f.a_c);
        f.b4<false>(b, st + 2 * kBandRows * kLdK, kLdK, ks, 32 * wn);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], a[mi], b[j][0], b[j][1]);
      }
    };
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    pipeline(L.kp / kMmaChunk, stages, kMmaStage, issue, fetch, put, compute);
    if (active) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf16* d = sT + (32 * wm + 16 * mi + g) * L.ldt + n0 + 32 * wn + 8 * j + 2 * tg;
          *reinterpret_cast<unsigned*>(d) = pack_bf16(acc[mi][j][0], acc[mi][j][1]);
          *reinterpret_cast<unsigned*>(d + 8 * L.ldt) = pack_bf16(acc[mi][j][2], acc[mi][j][3]);
        }
    }
  }
  __syncthreads();
}

// hfs = Tr Rr - Ti Ri on the tensor cores from T's tile (2 kBandRows x ldt
// bfloat16), the two float32 sums in one warp's registers and their
// difference rounded to bfloat16 once, a pass of kMmaPanel columns at a
// time, into a result tile in the first stage, handed to out(tile, n0). The
// tile is [band row][column] (kLdN apart), or with TRANSPOSED [column][band
// row] (kLdK apart), so that `out` writes row segments of the image either
// way. 8 warps, 2 x 4: a warp owns 16 rows by 32 columns of a pass.
//
// EXACT (K1): the result is what a plain float32 product gives, sums as FMA
// chains from zero in k order, bit for bit: `out` and `y` of K1 are held to
// one bf16 ulp of the plain version, and where hfs is small beside its terms
// any other order moves it by more. So each k16 step's mma starts from zero
// and is added to an IEEE float32 total, and beside the sums an mma of the
// magnitudes gives S = sum |Tr||Rr| + |Ti||Ri|; both orders' sums lie within
// (np + np / 16 + 66) u S of the exact one (u = 2^-24: the FMA chain's
// gamma_np, 64 u for each k16 step inside the tensor core and the totals'
// additions), and that with a factor 2 of margin bounds how far the plain
// hfs can be from this one. Where the bound's ends round to two bfloat16
// values (rows of the band in the image only), the block recomputes the
// pair as FMA chains from T's tile and R (a few % of the outputs).
template <bool TRANSPOSED, bool EXACT, class Out>
__device__ __forceinline__ void mma_hfs(const MmaLayout& L, int rows, int cols,
                                        const bf16* __restrict__ rr,
                                        const bf16* __restrict__ ri, char* smem, Out out) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, tg = lane % 4;
  const Frag f(lane);
  const bf16* sT = reinterpret_cast<const bf16*>(smem + L.t);
  bf16* stages = reinterpret_cast<bf16*>(smem + L.stages);
  // the outputs to recompute (EXACT): packed band row * kMmaPanel + column
  __shared__ int n_exact;
  unsigned short* exact = reinterpret_cast<unsigned short*>(stages + kMmaStage);
  const float margin = 2.f * (L.np + L.np / 16 + 66) * 0x1p-24f * (1.f + 0x1p-8f);
  float acc[3][4][4];  // Tr Rr, Ti Ri, and (EXACT) S
  for (int n0 = 0; n0 < L.np; n0 += kMmaPanel) {
    const bool active = n0 + 32 * wn < L.np;
    auto issue = [&](int t, bf16* st) {
      constexpr int kSegs = kMmaChunk * (kMmaPanel / 8);
      for (int e = tid; e < 2 * kSegs; e += kBandThreads) {
        const int s = e / kSegs, k = (e % kSegs) / (kMmaPanel / 8), m = e % (kMmaPanel / 8);
        if (n0 + 8 * m >= L.np) continue;
        cp_async16(st + s * kMmaChunk * kLdN + k * kLdN + 8 * m,
                   (s ? ri : rr) + (size_t)(t * kMmaChunk + k) * L.np + n0 + 8 * m);
      }
    };
    auto compute = [&](int t, const bf16* st) {
      if (!active) return;
#pragma unroll
      for (int ks = 0; ks < kMmaChunk; ks += 16) {
        const int kk = t * kMmaChunk + ks;
        unsigned a[2][4], b[2][4][2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          ldsm4(a[s], sT + (s * kBandRows + 16 * wm + f.a_r) * L.ldt + kk + f.a_c);
          f.b4<true>(b[s], st + s * kMmaChunk * kLdN, kLdN, ks, 32 * wn);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (EXACT) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(part, a[s], b[s][j][0], b[s][j][1]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[s][j][q] = __fadd_rn(acc[s][j][q], part[q]);
              unsigned m[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) m[q] = a[s][q] & 0x7fff7fffu;
              mma_bf16(acc[2][j], m, b[s][j][0] & 0x7fff7fffu, b[s][j][1] & 0x7fff7fffu);
            } else {
              mma_bf16(acc[s][j], a[s], b[s][j][0], b[s][j][1]);
            }
          }
      }
    };
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    if (EXACT && tid == 0) n_exact = 0;
    pipeline(L.np / kMmaChunk, stages, kMmaStage, issue, [](int) {}, [](bf16*) {}, compute);
    bf16* tile = stages;
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = 16 * wm + g + 8 * (q / 2), c = 32 * wn + 8 * j + 2 * tg + q % 2;
          const float hfs = __fsub_rn(acc[0][j][q], acc[1][j][q]);
          tile[TRANSPOSED ? c * kLdK + r : r * kLdN + c] = __float2bfloat16_rn(hfs);
          if constexpr (EXACT) {
            const float d = __fmaf_ru(margin, acc[2][j][q], 0x1p-22f * fabsf(hfs));
            if (r < rows && n0 + c < cols &&
                __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rd(hfs, d))) !=
                    __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_ru(hfs, d))))
              exact[atomicAdd(&n_exact, 1)] = r * kMmaPanel + c;
          }
        }
    }
    __syncthreads();
    if constexpr (EXACT) {
      for (int e = tid; e < n_exact; e += kBandThreads) {
        const int r = exact[e] / kMmaPanel, c = exact[e] % kMmaPanel;
        const bf16 *tr = sT + r * L.ldt, *ti = sT + (kBandRows + r) * L.ldt;
        const bf16 *br = rr + n0 + c, *bi = ri + n0 + c;  // column n0 + c of R
        float pr = 0.f, pi = 0.f;
        for (int k = 0; k < L.np; k += 8) {
          const uint4 vtr = *reinterpret_cast<const uint4*>(tr + k);
          const uint4 vti = *reinterpret_cast<const uint4*>(ti + k);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const size_t q = (size_t)(k + j) * L.np;
            pr = fmaf(bf16_at(vtr, j), __bfloat162float(__ldg(br + q)), pr);
            pi = fmaf(bf16_at(vti, j), __bfloat162float(__ldg(bi + q)), pi);
          }
        }
        tile[TRANSPOSED ? c * kLdK + r : r * kLdN + c] = __float2bfloat16_rn(__fsub_rn(pr, pi));
      }
      __syncthreads();
    }
    out(tile, n0);
    __syncthreads();
  }
}

// The bfloat16 K1's T = [Lr; Li] xs on the FP32 pipes, for the band
// [h0, h0 + kBandRows), on band_hfs's tiles, chunks and FMA order (each sum a
// chain of FMAs from zero in k order, the order of a plain float32 matrix
// product), so that T rounds to bfloat16 where the plain version's does.
// The chunks stream on the ring: the operator rows (float32) by cp.async, and
// xs = add_square(x) from x and sq_delta copied raw by cp.async, 8 pixels a
// segment, turned into float32 by the thread that copied them (a segment off
// the plane, or not on 16 bytes, is formed from loads as it is issued).
// Hands store(r, c, v) the sums of product row r at columns c .. c + 3 of
// every panel of kPanel columns up to wt.
constexpr int kTX = kChunkOps + kChunkPlane;    // floats before raw x (then raw sq_delta)
constexpr int kTSegs = kChunkPlane / 8;         // segments of 8 pixels a chunk
static_assert((kTX + kChunkPlane) * sizeof(float) <= kMmaStage * sizeof(bf16) &&
                  2 * kBandRows * (kChunk / 4) == kBandThreads && kTSegs <= kBandThreads,
              "K1's T stage");

template <class Store>
__device__ __forceinline__ void band_t_ring(const MmaLayout& L, int h0,
                                            const float* __restrict__ lr,
                                            const float* __restrict__ li,
                                            const bf16* __restrict__ x,
                                            const bf16* __restrict__ st,
                                            const bf16* __restrict__ sqd, const Params& p,
                                            bool vec, char* smem, Store store) {
  // threads as in band_hfs: a 4 x 4 tile, rows half kBandRows + rq + kRowStep i
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int WPH = kBandThreads / 64;
  const int half = warp / WPH, wh = warp % WPH;
  const int rq = 4 * (wh / kWarpsAcross) + lane / 8;
  const int cg = 8 * (wh % kWarpsAcross) + lane % 8;
  const int row0 = half * kBandRows + rq;
  const int H = p.H, W = p.W;
  // this thread's segment: chunk row sk, columns 8 sc .. 8 sc + 7 of a panel
  const int sk = tid / (kPanel / 8), sc = 8 * (tid % (kPanel / 8));
  bf16* stages = reinterpret_cast<bf16*>(smem + L.stages);
  float acc[4][4];
  for (int pc0 = 0; pc0 < L.wt; pc0 += kPanel) {
    const int w = pc0 + sc;
    uint4 vs{};
    if (p.square && tid < kTSegs) vs = load8(st + w, vec, W - w);
    auto raw = [&](int h) { return vec && h < H && w + 8 <= W; };
    auto form = [&](float* d, const uint4& vx, const uint4& vd, int n) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xv = bf16_at(vx, j);
        v[j] = j >= n       ? 0.f
               : p.square ? square_fwd<BF16>(xv, bf16_at(vs, j), bf16_at(vd, j), p.eps)
                          : xv;
      }
      *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(d + 4) = make_float4(v[4], v[5], v[6], v[7]);
    };
    auto issue = [&](int t, bf16* stage) {
      float* f = reinterpret_cast<float*>(stage);
      const int k0 = t * kChunk, i = tid / (kChunk / 4), m = tid % (kChunk / 4);
      cp_async16(f + i * kLdL + 4 * m,
                 (i < kBandRows ? lr : li) + (size_t)(h0 + i % kBandRows) * L.kp + k0 + 4 * m);
      if (tid >= kTSegs) return;
      const int h = k0 + sk;
      const size_t q = (size_t)h * W + w;
      bf16* xr = reinterpret_cast<bf16*>(f + kTX) + tid * 8;
      if (raw(h)) {
        cp_async16(xr, x + q);
        if (p.square) cp_async16(xr + kChunkPlane, sqd + q);
        return;
      }
      const int n = h < H ? min(8, W - w) : 0;
      form(f + kChunkOps + sk * kPanel + sc, load8(x + q, false, n),
           p.square ? load8(sqd + q, false, n) : uint4{}, n);
    };
    auto land = [&](int t, bf16* stage) {
      float* f = reinterpret_cast<float*>(stage);
      if (tid >= kTSegs || !raw(t * kChunk + sk)) return;
      const bf16* xr = reinterpret_cast<const bf16*>(f + kTX) + tid * 8;
      form(f + kChunkOps + sk * kPanel + sc, *reinterpret_cast<const uint4*>(xr),
           p.square ? *reinterpret_cast<const uint4*>(xr + kChunkPlane) : uint4{}, 8);
    };
    auto compute = [&](int, const bf16* stage) {
      const float* f = reinterpret_cast<const float*>(stage);
      fma_chunk<kPanel>(acc, f + row0 * kLdL, kRowStep * kLdL, f + kChunkOps + 4 * cg);
    };
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    ring(L.kp / kChunk, L.depth, stages, issue, land, compute);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store(row0 + kRowStep * i, pc0 + 4 * cg,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  }
}

// K1 in bfloat16: row bands. T = A X on the FP32 pipes in the plain
// version's order (band_t_ring), hfs on the tensor cores, exactly
// (mma_hfs<EXACT>). The wrapper gives it A (lr, li) as float32 holding
// bfloat16 values, bands x kBandRows rows by kp = H padded to kChunk; R = B^T
// (rr, ri) as bfloat16 in mma_geometry's layout; and the taps, eps and w
// rounded to bfloat16.
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ stripes,
                         const bf16* __restrict__ sq_delta, const float* __restrict__ lr,
                         const float* __restrict__ li, const bf16* __restrict__ rr,
                         const bf16* __restrict__ ri, const float* __restrict__ gtaps,
                         bf16* __restrict__ out, bf16* __restrict__ y, Params p, MmaLayout L) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* sE = reinterpret_cast<float*>(smem);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, h0 = blockIdx.x * kBandRows;
  float g[9];
  load_taps(gtaps, g);
  const bf16* xb = x + (size_t)b * C * HW;
  band_edge<BF16>(xb, g, p, h0, W % 4 == 0 && aligned16(x),
                  reinterpret_cast<float*>(smem + L.t), sE, L.lde);
  // x, sq_delta and stripes in 16-byte segments: W % 8 == 0 and each on 16
  // bytes (out and y are the wrapper's own)
  const bool vec = W % 8 == 0 && aligned16(x) &&
                   (!p.square || (aligned16(stripes) && aligned16(sq_delta)));
  bf16* sT = reinterpret_cast<bf16*>(smem + L.t);

  for (int c = 0; c < C; ++c) {
    const size_t off = ((size_t)b * C + c) * HW;
    band_t_ring(L, h0, lr, li, xb + (size_t)c * HW,
                p.square ? stripes + ((size_t)b * C + c) * W : nullptr,
                p.square ? sq_delta + (size_t)c * HW : nullptr, p, vec, smem,
                [&](int r, int c4, float4 v) {
                  if (c4 >= L.np) return;
                  *reinterpret_cast<uint2*>(sT + r * L.ldt + c4) =
                      make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
                });
    __syncthreads();
    bf16* yc = y + off;
    bf16* oc = out + off;
    mma_hfs<false, true>(L, H - h0, W, rr, ri, smem, [&](const bf16* tile, int n0) {
      for (int e = threadIdx.x; e < kBandRows * (kMmaPanel / 8); e += kBandThreads) {
        const int r = e / (kMmaPanel / 8), s = 8 * (e % (kMmaPanel / 8));
        const int h = h0 + r, w = n0 + s;
        if (h >= H || w >= W) continue;
        const uint4 hv = *reinterpret_cast<const uint4*>(tile + r * kLdN + s);
        const float* edge = sE + r * L.lde + w;
        float yv[8], ov[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          yv[j] = BF16::r(__fadd_rn(bf16_at(hv, j), BF16::r(__fmul_rn(p.w, edge[j]))));
          ov[j] = clip01(yv[j]);
        }
        store8(yc + (size_t)h * W + w, yv, W % 8 == 0, W - w);
        store8(oc + (size_t)h * W + w, ov, W % 8 == 0, W - w);
      }
    });
  }
}

// K2 in bfloat16: column bands of the transposed problem dx^T = R^T U^T L,
// both products on the tensor cores (its limits allow their sums' order).
// The wrapper gives it L = B^T and R = A as bfloat16 in mma_geometry's
// layout.
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
ee_fused_bwd_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ x,
                         const bf16* __restrict__ stripes, const bf16* __restrict__ sq_delta,
                         const bf16* __restrict__ y, const bf16* __restrict__ lr,
                         const bf16* __restrict__ li, const bf16* __restrict__ rr,
                         const bf16* __restrict__ ri, const float* __restrict__ gtaps,
                         bf16* __restrict__ dx, Params p, MmaLayout L) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* sE = reinterpret_cast<float*>(smem);
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.y, band0 = blockIdx.x * kBandRows;
  float g[9];
  load_taps(gtaps, g);
  const size_t img = (size_t)b * C * HW;
  band_canny_adjoint<true, BF16>(x + img, u + img, y + img, g, p, band0,
                                 W % 4 == 0 && aligned16(x),
                                 reinterpret_cast<float*>(smem + L.t), sE, L.lde);
  // rows of 16-byte segments: W % 8 == 0 and every tensor on 16 bytes (dx is
  // the wrapper's own)
  const bool vec = W % 8 == 0 && aligned16(u) && aligned16(x) && aligned16(y) &&
                   (!p.square || (aligned16(stripes) && aligned16(sq_delta)));

  for (int c = 0; c < C; ++c) {
    const size_t off = img + (size_t)c * HW;
    CotangentMma plane{u + off, y + off, H, W, vec};
    mma_t(L, band0, lr, li, smem, plane);
    const bf16* xc = x + off;
    const bf16* st = p.square ? stripes + ((size_t)b * C + c) * W : nullptr;
    const bf16* sqd = p.square ? sq_delta + (size_t)c * HW : nullptr;
    bf16* dxc = dx + off;
    // the tile holds image rows n0 .. n0 + kMmaPanel - 1 of the band's columns
    mma_hfs<true, false>(L, W - band0, H, rr, ri, smem, [&](const bf16* tile, int n0) {
      for (int e = threadIdx.x; e < kMmaPanel * (kBandRows / 8); e += kBandThreads) {
        const int hr = e / (kBandRows / 8), s = 8 * (e % (kBandRows / 8));
        const int h = n0 + hr, w = band0 + s, n = W - w;
        if (h >= H || w >= W) continue;
        const uint4 dv = *reinterpret_cast<const uint4*>(tile + hr * kLdK + s);
        const float* canny = sE + h * L.lde + s;
        const size_t q = (size_t)h * W + w;
        uint4 vx{}, vs{}, vd{};
        if (p.square) {
          vx = load8(xc + q, vec, n);
          vs = load8(st + w, vec, n);
          vd = load8(sqd + q, vec, n);
        }
        float d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dxs = bf16_at(dv, j);
          d[j] = (p.square ? square_bwd<BF16>(dxs, bf16_at(vx, j), bf16_at(vs, j),
                                              bf16_at(vd, j), p.eps)
                           : dxs) +
                 canny[j];
        }
        store8(dxc + q, d, vec, n);
      }
    });
  }
}

// ---- K3a/K3b: the Canny-only pair ------------------------------------------
//
// A block owns a kCannyRows x kCannyCols tile of one image (grid: tiles
// across, tiles down, images; ragged tiles masked). ops/cuda/ee_fused.py
// (canny_geometry) mirrors kCannyRows and kCannyCols as CANNY_ROWS and
// CANNY_COLS, computes the grid and a block's shared memory, and passes both
// to the launch. K3a: C x tiles and the summed blur's; K3b: four tiles and
// u_summed's, whatever C; float32 tiles (Tile) or bfloat16 ones (Tile2,
// Mid2).

constexpr int kCannyRows = 16;
constexpr int kCannyCols = 32;
constexpr int kCannyThreads = 128;
constexpr int kCannyMinBlocks = 6;

// K3a in float32: writes out (the edge map), mag, gx, gy, each (B, 1, H, W).
__global__ void __launch_bounds__(kCannyThreads, kCannyMinBlocks)
canny_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gtaps,
                 float* __restrict__ out, float* __restrict__ mag, float* __restrict__ gx,
                 float* __restrict__ gy, Params p) {
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

// K3b in float32: writes dx (B, C, H, W), the same plane in every channel.
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

// ---- K3a/K3b in bfloat16: packed bf16x2 arithmetic on bfloat16 tiles -------
//
// JAX's Canny-only kernel computes in the image's dtype: in bfloat16 each
// product and sum of the blur, the Sobel, the magnitude, the gate and the
// two adjoints rounds to bfloat16, and so do the division by C, the square
// root and the reciprocal; only the channel sum is float32, rounded once.
// A float32 operation on bfloat16 operands rounded once more to bfloat16 is
// one correct rounding of the exact result (24 >= 2 x 8 + 2 significand
// bits; tests/test_torch_canny_fused.py holds that on a dense grid), so the
// correctly rounded bf16x2 instructions give the plain version's bits, two
// pixels an instruction: mul.rn.bf16x2 and add.rn.bf16x2, never an fma (a
// contraction would skip a rounding). The division by C, the square root
// and the reciprocal stay float32 IEEE operations, each pair rounded by one
// cvt.rn.bf16x2.f32. (Computing each step in float32 and rounding each result
// on its own costs a conversion and a shift a value, ~92 a pixel in K3a:
// more time than the bytes.)
//
// The tiles hold the bfloat16 planes as loaded, half the bytes of float32
// tiles. A 32-bit word holds two neighbouring pixels of a row, the left one
// in the low half. A thread takes a quad, 4 pixels of a row, as two pairs:
// its 3 x 3 window is 3 words a row, the columns -1, 0, +1 of the first pair
// being words 0, (0 | 1), 1 and of the second 1, (1 | 2), 2, where (a | b)
// is a's high pixel with b's low one (a byte permute). A quad that starts on
// an odd column reads a tile that holds even columns at word boundaries
// (Tile2, staged from device memory); one that starts on an even column
// reads a tile that holds odd columns there (Mid2: the summed blur,
// u_summed), which the odd quads of the stage before write whole words of.
//
// At the image's edges no thread takes another path: x is staged with its
// edge pixels replicated into the halo, and the summed blur's columns off
// the image are set where the Sobel reads them (replicate_edges); a quad
// that read pixel by pixel there made its whole warp wait (a third of K3a's
// time). K3b's folds run only in blocks that touch the plane's border.
//
// What bounds them: bytes, 17.53 us each at fast-AT's 256 x 3 x 128 x 128;
// the arithmetic is ~40 packed operations a pixel and the float32 division,
// square root and reciprocal of a pair. A block owns 32 x 32 pixels of one
// image (128 threads, 8 blocks an SM at 64 registers): 16 x 32 tiles spend
// more of their bytes and blur on the halo, and a block that walked several
// tiles with the next one's copies in flight was slower than the blocks an
// SM holds at once. ops/cuda/ee_fused.py mirrors the tile as CANNY_BF16_ROWS
// and CANNY_BF16_COLS.
constexpr int kCannyBf16Rows = 32;
constexpr int kCannyBf16Cols = 32;
constexpr int kCannyBf16Threads = 128;
constexpr int kCannyBf16MinBlocks = 8;

__device__ __forceinline__ unsigned mul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// v, a bfloat16 value held as float32, in both halves.
__device__ __forceinline__ unsigned splat2(float v) {
  const unsigned h = __float_as_uint(v) >> 16;
  return h | (h << 16);
}

// a's halves where m is set, b's elsewhere.
__device__ __forceinline__ unsigned pick2(unsigned m, unsigned a, unsigned b) {
  return (a & m) | (b & ~m);
}

// The halves of the pair at columns w, w + 1 that lie at column `col`.
__device__ __forceinline__ unsigned halves_at(int w, int col) {
  return (w == col ? 0xffffu : 0u) | (w + 1 == col ? 0xffff0000u : 0u);
}

// f on each half of the pair v in float32, both results rounded at once.
template <class Fn>
__device__ __forceinline__ unsigned each2(unsigned v, Fn f) {
  return pack_bf16(f(bf16_lo(v)), f(bf16_hi(v)));
}

// k times the pair a, rounded: a Gaussian tap as a splat word, or a Sobel
// tap as a float the compiler knows (+-1 are exact: a, -a).
__device__ __forceinline__ unsigned tap2(unsigned k, unsigned a) { return mul2(k, a); }
__device__ __forceinline__ unsigned tap2(float k, unsigned a) {
  if (k == 1.f) return a;
  if (k == -1.f) return a ^ 0x80008000u;
  return mul2(splat2(k), a);
}

// Whether a tap is skipped: the Sobel's zeros; every Gaussian tap is taken.
__device__ __forceinline__ bool zero_tap(unsigned) { return false; }
__device__ __forceinline__ bool zero_tap(float k) { return k == 0.f; }

// tap_sum on a pair: k's taps row-major, each product and sum rounded.
template <class K, class A>
__device__ __forceinline__ unsigned tap_sum2(A a, const K (&k)[9]) {
  unsigned acc = 0u;
  bool first = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (zero_tap(k[t])) continue;
    const unsigned v = tap2(k[t], a(t / 3 - 1, t % 3 - 1));
    acc = first ? v : add2(acc, v);
    first = false;
  }
  return acc;
}

// The adjoint of the edge-replicated 3x3 stencil k on a pair, as JAX
// computes it tap by tap (_apply_taps_adjoint): for each tap t (row-major),
// the cotangent a (zeros off the plane) moved back by the tap's offset
// (dh, dw), rows first, the border row (column) adding the read that the
// clamp folded onto it; k[t] times that, rounded; the terms summed in tap
// order, each sum rounded. top and bottom: the pair's row is the plane's
// first or last; left and right: the halves at its first or last column.
template <class K, class A>
__device__ __forceinline__ unsigned adjoint_taps2(A a, const K (&k)[9], bool top, bool bottom,
                                                  unsigned left, unsigned right) {
  unsigned acc = 0u;
  bool first = true;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (zero_tap(k[t])) continue;
    const int dh = t / 3 - 1, dw = t % 3 - 1;
    const bool fold_row = (dh == 1 && bottom) || (dh == -1 && top);
    auto rows = [&](int j) {
      const unsigned v = a(-dh, j);
      return fold_row ? add2(v, a(0, j)) : v;
    };
    unsigned v = rows(-dw);
    const unsigned m = dw == 1 ? right : dw == -1 ? left : 0u;
    if (m) v = pick2(m, add2(v, rows(0)), v);
    const unsigned term = tap2(k[t], v);
    acc = first ? term : add2(acc, term);
    first = false;
  }
  return acc;
}

// A bfloat16 tile of one plane: rows [h0 - HALO, h0 + ROWS + HALO) and
// columns [w0 - 8, w0 + COLS + 8), pixel (h0 + r, w0 + s) at at(r, s); even
// columns on word boundaries, rows and 8-column units on 16 bytes.
// ops/cuda/ee_fused.py sizes shared memory by this layout (TILE2_PAD).
template <int ROWS, int COLS, int HALO>
struct Tile2 {
  static_assert(COLS % 8 == 0 && HALO <= 2, "tile");
  static constexpr int kHalo = HALO;
  static constexpr int kRows = ROWS + 2 * HALO;
  static constexpr int kLd = COLS + 16;
  static constexpr int kElems = kRows * kLd;
  __host__ __device__ static constexpr int at(int r, int s) {
    return (r + HALO) * kLd + s + 8;
  }
};

// A bfloat16 tile of rows [h0 - 1, h0 + ROWS + 1) and columns
// [w0 - 1, w0 + COLS + 3): odd columns on word boundaries, an odd quad's
// two words on 8 bytes (MID2_PAD in ops/cuda/ee_fused.py).
template <int ROWS, int COLS>
struct Mid2 {
  static_assert(COLS % 4 == 0, "tile");
  static constexpr int kRows = ROWS + 2;
  static constexpr int kLd = COLS + 4;
  static constexpr int kElems = kRows * kLd;
  __host__ __device__ static constexpr int at(int r, int s) { return (r + 1) * kLd + s + 1; }
};

// Stages n bfloat16 planes (plane(i) points at plane i's pixel (0, 0), rows
// W apart) into n consecutive tiles T (Tile2) at dst; a read off the plane
// takes the nearest edge pixel (REPLICATE) or zero. Unit e is 8 columns of
// one row. Where `vec` holds (W % 8 == 0 and the planes start on 16 bytes),
// a unit lies in the plane's columns or off them: in them, one 16-byte
// cp.async a plane (from the nearest edge row, or zeros stored without
// REPLICATE); off them, the nearest edge pixel loaded once and stored 8
// times, or zeros. Else every unit is loaded by the thread pixel by pixel.
// Stores are 16 bytes. A thread that has waited for its own copies may read
// its own units before any barrier.
template <class T, int THREADS, bool REPLICATE, class Plane>
__device__ __forceinline__ void stage_tile2(bf16* dst, int n, Plane plane, int H, int W,
                                            int h0, int w0, bool vec) {
  constexpr int kUnitsPerRow = T::kLd / 8;
  for (int e = threadIdx.x; e < T::kElems / 8; e += THREADS) {
    const int h = h0 - T::kHalo + e / kUnitsPerRow, w = w0 - 8 + 8 * (e % kUnitsPerRow);
    bf16* d = dst + 8 * e;
    const bool row_in = h >= 0 && h < H;
    if (vec) {
      const size_t row = (size_t)clampi(h, 0, H - 1) * W;
      if (!REPLICATE && !row_in) {
        for (int i = 0; i < n; ++i) *reinterpret_cast<uint4*>(d + i * T::kElems) = uint4{};
      } else if (w >= 0 && w + 8 <= W) {
        for (int i = 0; i < n; ++i) cp_async16(d + i * T::kElems, plane(i) + row + w);
      } else {
        const size_t q = row + (w < 0 ? 0 : W - 1);
        for (int i = 0; i < n; ++i) {
          const unsigned v =
              REPLICATE ? 0x10001u * __ldg(reinterpret_cast<const unsigned short*>(plane(i)) + q)
                        : 0u;
          *reinterpret_cast<uint4*>(d + i * T::kElems) = make_uint4(v, v, v, v);
        }
      }
      continue;
    }
    const size_t row = (size_t)clampi(h, 0, H - 1) * W;
    for (int i = 0; i < n; ++i) {
      const unsigned short* src = reinterpret_cast<const unsigned short*>(plane(i)) + row;
      unsigned v[4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = w + j;
        const bool in = row_in && c >= 0 && c < W;
        const unsigned b = (!REPLICATE && !in) ? 0u : __ldg(src + clampi(c, 0, W - 1));
        v[j / 2] = (j & 1) ? v[j / 2] | (b << 16) : b;
      }
      *reinterpret_cast<uint4*>(d + i * T::kElems) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The window of the quad (r, s .. s + 3) in tile T: w[i][k] the word whose
// low pixel is (r + i - 1, s - 1 + 2 k).
template <class T>
__device__ __forceinline__ void window2(const bf16* tile, int r, int s, unsigned (&w)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      w[i][k] = *reinterpret_cast<const unsigned*>(tile + T::at(r + i - 1, s - 1 + 2 * k));
}

// Column w - 1 + c of a quad's window (the quad's first pixel at image
// column w) set to the value of column w - 2 + c: its nearest edge column
// where that is column -1 (c = 0) or W (the summed blur's edge
// replication, set here rather than where the blur computes it).
__device__ __forceinline__ void replicate_edges(unsigned (&win)[3][3], int w, int W) {
  const int right = W - w + 1;  // the window column of image column W
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (k == 0 && w == 0) win[i][0] = __byte_perm(win[i][0], 0, 0x3232);
      if (right == 2 * k + 1) win[i][k] = __byte_perm(win[i][k], 0, 0x1010);
      if (k > 0 && right == 2 * k)
        win[i][k] = __byte_perm(win[i][k - 1], win[i][k], 0x7632);
    }
}

// fn(r, s, win) for each even quad of pixels (r, s .. s + 3) of the tile,
// in the image or not, win its window in tile T (Mid2).
template <class T, class Fn>
__device__ __forceinline__ void for_each_quad2(const bf16* tile, Fn fn) {
  constexpr int kQuads = kCannyBf16Cols / 4;
  for (int e = threadIdx.x; e < kCannyBf16Rows * kQuads; e += kCannyBf16Threads) {
    const int r = e / kQuads, s = 4 * (e % kQuads);
    unsigned win[3][3];
    window2<T>(tile, r, s, win);
    fn(r, s, win);
  }
}

// Pair q (0 or 1) of a quad read at offset (di, dj) from its window.
__device__ __forceinline__ unsigned pair_at(const unsigned (&w)[3][3], int q, int di, int dj) {
  const unsigned* row = w[di + 1];
  return dj == 0 ? __byte_perm(row[q], row[q + 1], 0x5432) : row[q + (dj + 1) / 2];
}

// v's 4 pixels (two pairs) to p[0 .. 3]: 8 bytes at once when `vec`, else
// the first n one by one.
__device__ __forceinline__ void store_pairs(bf16* p, uint2 v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<uint2*>(p) = v;
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
  const unsigned short a[4] = {(unsigned short)v.x, (unsigned short)(v.x >> 16),
                               (unsigned short)v.y, (unsigned short)(v.y >> 16)};
  for (int j = 0; j < n && j < 4; ++j) q[j] = a[j];
}

// The Gaussian taps, rounded to bfloat16 by the wrapper, as splat words.
__device__ __forceinline__ void load_taps2(const float* __restrict__ gtaps, unsigned (&g)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = splat2(__ldg(gtaps + i));
}

// K3a in bfloat16: out (the edge map), mag, gx, gy, each (B, 1, H, W). x
// staged with a 2-pixel edge-replicated halo (Tile2); the summed blur (Mid2,
// a 1-pixel halo holding the nearest edge pixel's value: the Sobel's edge
// replication) by odd quads, each channel blurred in packed bf16 and the
// channels summed in float32, rounded once; then Sobel / C, the zero-safe
// magnitude and the edge map by even quads.
__global__ void __launch_bounds__(kCannyBf16Threads, kCannyBf16MinBlocks)
canny_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gtaps,
                      bf16* __restrict__ out, bf16* __restrict__ mag, bf16* __restrict__ gx,
                      bf16* __restrict__ gy, Params p) {
  using X = Tile2<kCannyBf16Rows, kCannyBf16Cols, 2>;
  using S = Mid2<kCannyBf16Rows, kCannyBf16Cols>;
  extern __shared__ uint4 smem16[];
  const int C = p.C, H = p.H, W = p.W, b = blockIdx.z;
  const int h0 = blockIdx.y * kCannyBf16Rows, w0 = blockIdx.x * kCannyBf16Cols;
  bf16* sX = reinterpret_cast<bf16*>(smem16);
  bf16* sS = sX + C * X::kElems;
  unsigned g[9];
  load_taps2(gtaps, g);
  const size_t plane = (size_t)b * H * W;
  const bf16* xb = x + plane * C;
  stage_tile2<X, kCannyBf16Threads, true>(
      sX, C, [&](int c) { return xb + (size_t)c * H * W; }, H, W, h0, w0,
      W % 8 == 0 && aligned16(x));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the summed blur at S's rows -1 .. ROWS and the quads from column -1; off
  // the image a row is its nearest edge row; a column off the image is set
  // to its nearest edge column's value where the Sobel reads it
  constexpr int kQuads = kCannyBf16Cols / 4 + 1;
  for (int e = threadIdx.x; e < (kCannyBf16Rows + 2) * kQuads; e += kCannyBf16Threads) {
    const int r = e / kQuads - 1, s = 4 * (e % kQuads) - 1;
    const int hr = clampi(h0 + r, 0, H - 1) - h0;
    float sum[4];
    for (int c = 0; c < C; ++c) {
      unsigned win[3][3];
      window2<X>(sX + c * X::kElems, hr, s, win);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // channel c's blur of pair q, summed in float32
        const unsigned v = tap_sum2([&](int di, int dj) { return pair_at(win, q, di, dj); }, g);
        sum[2 * q] = c == 0 ? bf16_lo(v) : __fadd_rn(sum[2 * q], bf16_lo(v));
        sum[2 * q + 1] = c == 0 ? bf16_hi(v) : __fadd_rn(sum[2 * q + 1], bf16_hi(v));
      }
    }
    *reinterpret_cast<uint2*>(sS + S::at(r, s)) =
        make_uint2(pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]));
  }
  __syncthreads();
  float kx[9], ky[9];
  sobel_taps(kx, ky);
  const float cf = (float)C;
  const bool quads = W % 4 == 0;  // the outputs are the wrapper's own tensors
  for_each_quad2<S>(sS, [&](int r, int s, unsigned (&win)[3][3]) {
    const int h = h0 + r, w = w0 + s;
    replicate_edges(win, w, W);
    unsigned vx[2], vy[2], vm[2], ve[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      auto a = [&](int di, int dj) { return pair_at(win, q, di, dj); };
      // as in sobel_mag_tile: zero operands kept off the slow paths
      auto over_c = [&](float v) { return v == 0.f ? v : __fdiv_rn(v == 0.f ? 1.f : v, cf); };
      vx[q] = each2(tap_sum2(a, kx), over_c);
      vy[q] = each2(tap_sum2(a, ky), over_c);
      vm[q] = each2(add2(mul2(vx[q], vx[q]), mul2(vy[q], vy[q])), [](float v) {
        return v == 0.f ? 0.f : __fsqrt_rn(v == 0.f ? 1.f : v);
      });
      ve[q] = (edge_of(bf16_lo(vm[q]), p) != 0.f ? 0x3f80u : 0u) |
              (edge_of(bf16_hi(vm[q]), p) != 0.f ? 0x3f800000u : 0u);
    }
    if (h >= H || w >= W) return;
    const size_t at = plane + (size_t)h * W + w;
    store_pairs(out + at, make_uint2(ve[0], ve[1]), quads, W - w);
    store_pairs(mag + at, make_uint2(vm[0], vm[1]), quads, W - w);
    store_pairs(gx + at, make_uint2(vx[0], vx[1]), quads, W - w);
    store_pairs(gy + at, make_uint2(vy[0], vy[1]), quads, W - w);
  });
}

// The gate on a pair (gate, in packed bf16): (u_gx, u_gy).
__device__ __forceinline__ uint2 gate2(unsigned u, unsigned mag, unsigned gx, unsigned gy,
                                       const Params& p) {
  const unsigned keep = (gate_keeps(bf16_lo(mag), p) ? 0xffffu : 0u) |
                        (gate_keeps(bf16_hi(mag), p) ? 0xffff0000u : 0u);
  const unsigned u_mag = u & keep;
  const unsigned inv = each2(mag, [](float m) { return inv_mag(m); });
  return make_uint2(mul2(mul2(u_mag, gx), inv), mul2(mul2(u_mag, gy), inv));
}

// adjoint_taps2 of k on pair q of a quad's window, the pair's first pixel at
// (h, w), with the folds of the plane's border where EDGE (a block that
// touches the border) and none elsewhere.
template <bool EDGE, class K>
__device__ __forceinline__ unsigned adjoint_pair(const unsigned (&win)[3][3], int q,
                                                 const K (&k)[9], int h, int w, int H, int W) {
  return adjoint_taps2([&](int di, int dj) { return pair_at(win, q, di, dj); }, k,
                       EDGE && h == 0, EDGE && h == H - 1, EDGE ? halves_at(w, 0) : 0u,
                       EDGE ? halves_at(w, W - 1) : 0u);
}

// K3b in bfloat16: dx (B, C, H, W), the same plane in every channel. u, mag,
// gx, gy staged with a 2-pixel zero halo (Tile2) and gated in place (u's
// tile becomes u_gx, mag's u_gy); u_summed = (Sobel-x^T u_gx + Sobel-y^T
// u_gy) / C by odd quads into Mid2 (zeros off the plane); the blur's adjoint
// of u_summed by even quads, written to every channel. A block that touches
// no border of the plane runs the adjoints without their folds; the Gaussian
// taps are loaded for the last stage only, out of the Sobel adjoints'
// registers.
__global__ void __launch_bounds__(kCannyBf16Threads, kCannyBf16MinBlocks)
canny_bwd_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ mag,
                      const bf16* __restrict__ gx, const bf16* __restrict__ gy,
                      const float* __restrict__ gtaps, bf16* __restrict__ dx, Params p) {
  using G = Tile2<kCannyBf16Rows, kCannyBf16Cols, 2>;
  using U = Mid2<kCannyBf16Rows, kCannyBf16Cols>;
  extern __shared__ uint4 smem16[];
  const int C = p.C, H = p.H, W = p.W, b = blockIdx.z;
  const int h0 = blockIdx.y * kCannyBf16Rows, w0 = blockIdx.x * kCannyBf16Cols;
  // u, mag, gx, gy; the gate turns u's tile into u_gx and mag's into u_gy
  bf16* sIn = reinterpret_cast<bf16*>(smem16);
  bf16* sU = sIn + 4 * G::kElems;
  const size_t plane = (size_t)b * H * W;
  stage_tile2<G, kCannyBf16Threads, false>(
      sIn, 4,
      [&](int i) { return (i == 0 ? u : i == 1 ? mag : i == 2 ? gx : gy) + plane; }, H, W,
      h0, w0,
      W % 8 == 0 && aligned16(u) && aligned16(mag) && aligned16(gx) && aligned16(gy));
  cp_async_commit();
  cp_async_wait_all();
  // the gate on this thread's own units, in place
  constexpr int kTile = G::kElems / 8;
  for (int e = threadIdx.x; e < kTile; e += kCannyBf16Threads) {
    uint4* t = reinterpret_cast<uint4*>(sIn) + e;
    const uint4 vu = t[0], vm = t[kTile], vx = t[2 * kTile], vy = t[3 * kTile];
    const uint2 a0 = gate2(vu.x, vm.x, vx.x, vy.x, p), a1 = gate2(vu.y, vm.y, vx.y, vy.y, p);
    const uint2 a2 = gate2(vu.z, vm.z, vx.z, vy.z, p), a3 = gate2(vu.w, vm.w, vx.w, vy.w, p);
    t[0] = make_uint4(a0.x, a1.x, a2.x, a3.x);
    t[kTile] = make_uint4(a0.y, a1.y, a2.y, a3.y);
  }
  __syncthreads();
  const float cf = (float)C;
  auto adjoints = [&](auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    float sx[9], sy[9];
    sobel_taps(sx, sy);
    // u_summed at U's rows -1 .. ROWS and the quads from column -1
    constexpr int kQuads = kCannyBf16Cols / 4 + 1;
    for (int e = threadIdx.x; e < (kCannyBf16Rows + 2) * kQuads; e += kCannyBf16Threads) {
      const int r = e / kQuads - 1, s = 4 * (e % kQuads) - 1, h = h0 + r;
      uint2 v = make_uint2(0u, 0u);
      if (h >= 0 && h < H) {
        unsigned wx[3][3], wy[3][3];
        window2<G>(sIn, r, s, wx);
        window2<G>(sIn + G::kElems, r, s, wy);
        unsigned o[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int w = w0 + s + 2 * q;
          const unsigned sum = add2(adjoint_pair<kEdge>(wx, q, sx, h, w, H, W),
                                    adjoint_pair<kEdge>(wy, q, sy, h, w, H, W));
          const unsigned in = (w >= 0 && w < W ? 0xffffu : 0u) |
                              (w + 1 >= 0 && w + 1 < W ? 0xffff0000u : 0u);
          o[q] = in & each2(sum, [&](float v) {
                   return v == 0.f ? v : __fdiv_rn(v == 0.f ? 1.f : v, cf);
                 });
        }
        v = make_uint2(o[0], o[1]);
      }
      *reinterpret_cast<uint2*>(sU + U::at(r, s)) = v;
    }
    __syncthreads();
    unsigned g[9];
    load_taps2(gtaps, g);
    const bool quads = W % 4 == 0;  // dx is the wrapper's own tensor
    for_each_quad2<U>(sU, [&](int r, int s, const unsigned (&win)[3][3]) {
      const int h = h0 + r, w = w0 + s;
      const uint2 o = make_uint2(adjoint_pair<kEdge>(win, 0, g, h, w, H, W),
                                 adjoint_pair<kEdge>(win, 1, g, h, w + 2, H, W));
      if (h >= H || w >= W) return;
      bf16* d = dx + ((size_t)b * C * H + h) * W + w;
      for (int c = 0; c < C; ++c, d += (size_t)H * W) store_pairs(d, o, quads, W - w);
    });
  };
  // the folds reach u_summed's rows and columns -1 .. ROWS (COLS + 2)
  if (h0 == 0 || h0 + kCannyBf16Rows + 1 >= H || w0 == 0 || w0 + kCannyBf16Cols + 3 >= W)
    adjoints(std::true_type{});
  else
    adjoints(std::false_type{});
}

constexpr int kMaxDevices = 64;
size_t g_fwd_smem[kMaxDevices], g_bwd_smem[kMaxDevices];
size_t g_fwd_bf16_smem[kMaxDevices], g_bwd_bf16_smem[kMaxDevices];
size_t g_canny_fwd_smem[kMaxDevices], g_canny_bwd_smem[kMaxDevices];
size_t g_canny_fwd_bf16_smem[kMaxDevices], g_canny_bwd_bf16_smem[kMaxDevices];

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

MmaLayout mma_layout(const int* layout) {
  return MmaLayout{layout[0], layout[1], layout[2], layout[3],
                   layout[4], layout[5], layout[6], layout[7]};
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t: 0 when the launch was accepted.
// K1/K2 take the block geometry that the wrapper computed: `layout` holds
// BandLayout's seven fields in order (the _bf16 forms: MmaLayout's six),
// `bands` the blocks per image and `smem_bytes` a block's dynamic shared
// memory; and the operators it padded to layout's shapes (lr, li: bands x
// band rows by hk; rr, ri: wk x wt; the _bf16 forms: bfloat16, bands x band
// rows by kp and np x np). The _bf16 forms take bfloat16 tensors, and the
// taps, eps and w rounded to bfloat16; K2's operators and layout are those
// of its column bands (L = B^T, R = A).
// K3a/K3b take the tiles across and down an image and a block's dynamic
// shared memory from the wrapper's canny_geometry.
int ee_fused_fwd(const float* x, const float* stripes, const float* sq_delta,
                 const float* lr, const float* li, const float* rr,
                 const float* ri, const float* gtaps, float* out, float* y,
                 int B, int C, int H, int W, float eps, float w, float alpha,
                 float high, int square, const int* layout, int bands,
                 size_t smem_bytes, void* stream) {
  return launch(ee_fused_fwd_kernel, g_fwd_smem, dim3(bands, B), kBandThreads, smem_bytes,
                stream, x, stripes, sq_delta, lr, li, rr, ri, gtaps, out, y,
                Params{B, C, H, W, eps, w, alpha, high, square}, band_layout(layout));
}

int ee_fused_bwd(const float* u, const float* x, const float* stripes,
                 const float* sq_delta, const float* y, const float* lr,
                 const float* li, const float* rr, const float* ri,
                 const float* gtaps, float* dx, int B, int C, int H, int W,
                 float eps, float w, float alpha, float high, int square,
                 const int* layout, int bands, size_t smem_bytes, void* stream) {
  return launch(ee_fused_bwd_kernel, g_bwd_smem, dim3(bands, B), kBandThreads, smem_bytes,
                stream, u, x, stripes, sq_delta, y, lr, li, rr, ri, gtaps, dx,
                Params{B, C, H, W, eps, w, alpha, high, square}, band_layout(layout));
}

int ee_fused_fwd_bf16(const void* x, const void* stripes, const void* sq_delta,
                      const float* lr, const float* li, const void* rr, const void* ri,
                      const float* gtaps, void* out, void* y, int B, int C, int H, int W,
                      float eps, float w, float alpha, float high, int square,
                      const int* layout, int bands, size_t smem_bytes, void* stream) {
  auto in = [](const void* t) { return static_cast<const bf16*>(t); };
  return launch(ee_fused_fwd_bf16_kernel, g_fwd_bf16_smem, dim3(bands, B), kBandThreads,
                smem_bytes, stream, in(x), in(stripes), in(sq_delta), lr, li, in(rr), in(ri),
                gtaps, static_cast<bf16*>(out), static_cast<bf16*>(y),
                Params{B, C, H, W, eps, w, alpha, high, square}, mma_layout(layout));
}

int ee_fused_bwd_bf16(const void* u, const void* x, const void* stripes,
                      const void* sq_delta, const void* y, const void* lr,
                      const void* li, const void* rr, const void* ri,
                      const float* gtaps, void* dx, int B, int C, int H, int W, float eps,
                      float w, float alpha, float high, int square, const int* layout,
                      int bands, size_t smem_bytes, void* stream) {
  auto in = [](const void* t) { return static_cast<const bf16*>(t); };
  return launch(ee_fused_bwd_bf16_kernel, g_bwd_bf16_smem, dim3(bands, B), kBandThreads,
                smem_bytes, stream, in(u), in(x), in(stripes), in(sq_delta), in(y), in(lr),
                in(li), in(rr), in(ri), gtaps, static_cast<bf16*>(dx),
                Params{B, C, H, W, eps, w, alpha, high, square}, mma_layout(layout));
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

// The bfloat16 K3a/K3b: bfloat16 tensors, the taps, alpha and high rounded
// to bfloat16 (JAX's weak typing).
int canny_fused_fwd_bf16(const void* x, const float* gtaps, void* out, void* mag,
                         void* gx, void* gy, int B, int C, int H, int W,
                         float alpha, float high, int tiles_w, int tiles_h,
                         size_t smem_bytes, void* stream) {
  auto o = [](void* t) { return static_cast<bf16*>(t); };
  return launch(canny_fwd_bf16_kernel, g_canny_fwd_bf16_smem,
                dim3(tiles_w, tiles_h, B), kCannyBf16Threads, smem_bytes, stream,
                static_cast<const bf16*>(x), gtaps, o(out), o(mag), o(gx), o(gy),
                Params{B, C, H, W, 0.f, 0.f, alpha, high, 0});
}

int canny_fused_bwd_bf16(const void* u, const void* mag, const void* gx,
                         const void* gy, const float* gtaps, void* dx, int B,
                         int C, int H, int W, float alpha, float high, int tiles_w,
                         int tiles_h, size_t smem_bytes, void* stream) {
  auto in = [](const void* t) { return static_cast<const bf16*>(t); };
  return launch(canny_bwd_bf16_kernel, g_canny_bwd_bf16_smem,
                dim3(tiles_w, tiles_h, B), kCannyBf16Threads, smem_bytes, stream, in(u),
                in(mag), in(gx), in(gy), gtaps, static_cast<bf16*>(dx),
                Params{B, C, H, W, 0.f, 0.f, alpha, high, 0});
}

const char* ee_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
