// Fused edge-enhancement front-end for Hopper (sm_90a): forward K1 and its
// exact adjoint K2, and the Canny-only pair K3a/K3b (at the end of the file).
//
// K1/K2 replace the Pallas TPU kernels edge_enhancement_tpu/ops/pallas/
// ee_fused.py::_fwd_kernel and ::_bwd_kernel. Per image (all C planes):
//
//   xs   = add_square(x)               (n_queries=1; draws made outside)
//   hfs  = Ar xs Br^T - Ai xs Bi^T     (per channel plane)
//   edge = canny_step125(x)            (clean x: blur, channel sum, Sobel / C,
//                                       zero-safe |g|, alpha mask, > high)
//   y    = hfs + w edge,  out = clip(y, 0, 1)
//
// K2 takes (u, x, y) and returns dx under JAX's subgradient conventions
// (clip and min/max split exact ties 0.5/0.5), the To_compare window
// (high, 1.001], the alpha gate, 1/|g| := 0 at |g| = 0 and the adjoints of
// the edge-replicated stencils.
//
// Design: one block per image; the image's C planes, the four HFS
// operators and per-plane work buffers live in dynamic shared memory
// (176 KB at 64x64x3; the entry points opt into it once per device), so
// nothing but x, u, y and the outputs touches device memory. The products
// are FP32 FMA loops over 4x4 register tiles.
// What bounds it: the 4 (64x64x64) products per plane, FP32 FMA from shared
// memory, with 100 blocks on 132 SMs (one block per SM by its footprint).
// Tensor cores (wgmma) and bf16 are later work.
//
// The Canny branch rounds every product and sum on its own (__fmul_rn,
// __fadd_rn: no FMA contraction) and keeps the tap order of the PyTorch
// composition (row-major, zero taps skipped), so the edge maps of kernel and
// plain version agree exactly: `mag > high` flips on one-ulp differences.
// The square chain does the same, since its clips decide gradient ties.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4;  // register tile of the matrix products

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

// acc[i][j] = sum_k L(r0 + i, k) R(k, c0 + j) with L(i, k) = L[i*lsi + k*lsk]
// and R(k, j) = R[k*rsk + j*rsj].
__device__ __forceinline__ void mm_tile(const float* L, int lsi, int lsk,
                                        const float* R, int rsk, int rsj,
                                        int K, int r0, int c0,
                                        float acc[kTile][kTile]) {
#pragma unroll
  for (int i = 0; i < kTile; ++i)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < K; ++k) {
    float a[kTile], b[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) a[i] = L[(r0 + i) * lsi + k * lsk];
#pragma unroll
    for (int j = 0; j < kTile; ++j) b[j] = R[k * rsk + (c0 + j) * rsj];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Shared-memory layout, in floats: operators Ar, Ai (H*H), Br, Bi (W*W);
// the image X (C*H*W); S (H*W); three work planes (3*H*W).
__host__ __device__ inline size_t smem_floats(int C, int H, int W) {
  return 2 * (size_t)H * H + 2 * (size_t)W * W + (size_t)C * H * W +
         4 * (size_t)H * W;
}

__device__ __forceinline__ void load(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
ee_fused_fwd_kernel(const float* __restrict__ x, const float* __restrict__ stripes,
                    const float* __restrict__ sq_delta, const float* __restrict__ ar,
                    const float* __restrict__ ai, const float* __restrict__ br,
                    const float* __restrict__ bi, const float* __restrict__ gtaps,
                    float* __restrict__ out, float* __restrict__ y, Params p) {
  extern __shared__ float smem[];
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.x;
  float* sAr = smem;
  float* sAi = sAr + H * H;
  float* sBr = sAi + H * H;
  float* sBi = sBr + W * W;
  float* sX = sBi + W * W;
  float* sS = sX + C * HW;
  float* sXS = sS + HW;
  float* sTr = sXS + HW;
  float* sTi = sTr + HW;
  __shared__ float g[9];
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  load(sAr, ar, H * H);
  load(sAi, ai, H * H);
  load(sBr, br, W * W);
  load(sBi, bi, W * W);
  const float* xb = x + (size_t)b * C * HW;
  load(sX, xb, C * HW);
  __syncthreads();

  for (int q = threadIdx.x; q < HW; q += blockDim.x)
    sS[q] = blur_sum(sX, g, C, H, W, q / W, q % W);
  __syncthreads();

  const int tiles_w = W / kTile, n_tiles = (H / kTile) * tiles_w;
  for (int c = 0; c < C; ++c) {
    const float* xc = sX + c * HW;
    const float* st = stripes + ((size_t)b * C + c) * W;
    const float* sqd = sq_delta + (size_t)c * HW;
    for (int q = threadIdx.x; q < HW; q += blockDim.x)
      sXS[q] = p.square ? square_fwd(xc[q], st[q % W], sqd[q], p.eps) : xc[q];
    __syncthreads();

    // T = A xs (H x W)
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int r0 = (t / tiles_w) * kTile, c0 = (t % tiles_w) * kTile;
      float acc[kTile][kTile];
      mm_tile(sAr, H, 1, sXS, W, 1, H, r0, c0, acc);
      for (int i = 0; i < kTile; ++i)
        for (int j = 0; j < kTile; ++j) sTr[(r0 + i) * W + c0 + j] = acc[i][j];
      mm_tile(sAi, H, 1, sXS, W, 1, H, r0, c0, acc);
      for (int i = 0; i < kTile; ++i)
        for (int j = 0; j < kTile; ++j) sTi[(r0 + i) * W + c0 + j] = acc[i][j];
    }
    __syncthreads();

    // hfs = Tr Br^T - Ti Bi^T, then y and out
    float* yc = y + ((size_t)b * C + c) * HW;
    float* oc = out + ((size_t)b * C + c) * HW;
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int r0 = (t / tiles_w) * kTile, c0 = (t % tiles_w) * kTile;
      float pr[kTile][kTile], pi[kTile][kTile];
      mm_tile(sTr, W, 1, sBr, 1, W, W, r0, c0, pr);
      mm_tile(sTi, W, 1, sBi, 1, W, W, r0, c0, pi);
      for (int i = 0; i < kTile; ++i) {
        for (int j = 0; j < kTile; ++j) {
          const int h = r0 + i, w = c0 + j;
          const float hfs = pr[i][j] - pi[i][j];
          const float e = edge_of(sobel_mag(sS, C, H, W, h, w).mag, p);
          const float yv = __fadd_rn(hfs, __fmul_rn(p.w, e));
          yc[h * W + w] = yv;
          oc[h * W + w] = clip01(yv);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
ee_fused_bwd_kernel(const float* __restrict__ u, const float* __restrict__ x,
                    const float* __restrict__ stripes,
                    const float* __restrict__ sq_delta, const float* __restrict__ y,
                    const float* __restrict__ ar, const float* __restrict__ ai,
                    const float* __restrict__ br, const float* __restrict__ bi,
                    const float* __restrict__ gtaps, float* __restrict__ dx,
                    Params p) {
  extern __shared__ float smem[];
  const int C = p.C, H = p.H, W = p.W, HW = H * W;
  const int b = blockIdx.x;
  float* sAr = smem;
  float* sAi = sAr + H * H;
  float* sBr = sAi + H * H;
  float* sBi = sBr + W * W;
  float* sX = sBi + W * W;
  float* sS = sX + C * HW;   // summed blur, then the Canny branch's dx
  float* sW0 = sS + HW;      // Canny: u_gx;      HFS: u_y of one plane
  float* sW1 = sW0 + HW;     // Canny: u_gy;      HFS: U Br
  float* sW2 = sW1 + HW;     // Canny: u_summed;  HFS: U Bi
  __shared__ float g[9];
  if (threadIdx.x < 9) g[threadIdx.x] = gtaps[threadIdx.x];
  load(sAr, ar, H * H);
  load(sAi, ai, H * H);
  load(sBr, br, W * W);
  load(sBi, bi, W * W);
  const size_t img = (size_t)b * C * HW;
  load(sX, x + img, C * HW);
  __syncthreads();

  // ---- Canny branch: recompute the forward, then its adjoint -------------
  for (int q = threadIdx.x; q < HW; q += blockDim.x)
    sS[q] = blur_sum(sX, g, C, H, W, q / W, q % W);
  __syncthreads();
  for (int q = threadIdx.x; q < HW; q += blockDim.x) {
    const Grad gr = sobel_mag(sS, C, H, W, q / W, q % W);
    float u_edge = 0.f;
    for (int c = 0; c < C; ++c) {
      const size_t k = img + (size_t)c * HW + q;
      u_edge += u[k] * clip_mask(y[k]);
    }
    u_edge *= p.w;
    const float mag_m = (gr.mag < p.alpha) ? 0.f : gr.mag;
    const bool keep = mag_m > p.high && mag_m <= 1.001f && gr.mag >= p.alpha;
    const float u_mag = keep ? u_edge : 0.f;
    const float inv = (gr.mag == 0.f) ? 0.f : 1.f / gr.mag;
    sW0[q] = u_mag * gr.gx * inv;
    sW1[q] = u_mag * gr.gy * inv;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < HW; q += blockDim.x) {
    const int h = q / W, w = q % W;
    sW2[q] = (stencil3_adjoint(sW0, W, 0, 0, kSobelX, H, W, h, w) +
              stencil3_adjoint(sW1, W, 0, 0, kSobelY, H, W, h, w)) / (float)C;
  }
  __syncthreads();
  // the blur's adjoint of the channel-broadcast u_summed is the same plane
  // for every channel
  for (int q = threadIdx.x; q < HW; q += blockDim.x)
    sS[q] = stencil3_adjoint(sW2, W, 0, 0, g, H, W, q / W, q % W);
  __syncthreads();

  // ---- HFS branch per channel: A^T (U B), through the square chain --------
  const int tiles_w = W / kTile, n_tiles = (H / kTile) * tiles_w;
  for (int c = 0; c < C; ++c) {
    const size_t off = img + (size_t)c * HW;
    for (int q = threadIdx.x; q < HW; q += blockDim.x)
      sW0[q] = u[off + q] * clip_mask(y[off + q]);
    __syncthreads();

    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int r0 = (t / tiles_w) * kTile, c0 = (t % tiles_w) * kTile;
      float acc[kTile][kTile];
      mm_tile(sW0, W, 1, sBr, W, 1, W, r0, c0, acc);
      for (int i = 0; i < kTile; ++i)
        for (int j = 0; j < kTile; ++j) sW1[(r0 + i) * W + c0 + j] = acc[i][j];
      mm_tile(sW0, W, 1, sBi, W, 1, W, r0, c0, acc);
      for (int i = 0; i < kTile; ++i)
        for (int j = 0; j < kTile; ++j) sW2[(r0 + i) * W + c0 + j] = acc[i][j];
    }
    __syncthreads();

    const float* xc = sX + c * HW;
    const float* st = stripes + ((size_t)b * C + c) * W;
    const float* sqd = sq_delta + (size_t)c * HW;
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int r0 = (t / tiles_w) * kTile, c0 = (t % tiles_w) * kTile;
      float qr[kTile][kTile], qi[kTile][kTile];
      mm_tile(sAr, 1, H, sW1, W, 1, H, r0, c0, qr);
      mm_tile(sAi, 1, H, sW2, W, 1, H, r0, c0, qi);
      for (int i = 0; i < kTile; ++i) {
        for (int j = 0; j < kTile; ++j) {
          const int q = (r0 + i) * W + c0 + j;
          const float dxs = qr[i][j] - qi[i][j];
          const float d_hfs =
              p.square ? square_bwd(dxs, xc[q], st[c0 + j], sqd[q], p.eps) : dxs;
          dx[off + q] = d_hfs + sS[q];
        }
      }
    }
    __syncthreads();
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

// Bytes of dynamic shared memory one block needs.
size_t ee_fused_smem_bytes(int C, int H, int W) {
  return smem_floats(C, H, W) * sizeof(float);
}

// Each entry point returns a cudaError_t: 0 when the launch was accepted.
int ee_fused_fwd(const float* x, const float* stripes, const float* sq_delta,
                 const float* ar, const float* ai, const float* br,
                 const float* bi, const float* gtaps, float* out, float* y,
                 int B, int C, int H, int W, float eps, float w, float alpha,
                 float high, int square, void* stream) {
  const size_t bytes = ee_fused_smem_bytes(C, H, W);
  const cudaError_t err = allow_smem(ee_fused_fwd_kernel, bytes, g_fwd_smem);
  if (err != cudaSuccess) return (int)err;
  Params p{B, C, H, W, eps, w, alpha, high, square};
  ee_fused_fwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      x, stripes, sq_delta, ar, ai, br, bi, gtaps, out, y, p);
  return (int)cudaGetLastError();
}

int ee_fused_bwd(const float* u, const float* x, const float* stripes,
                 const float* sq_delta, const float* y, const float* ar,
                 const float* ai, const float* br, const float* bi,
                 const float* gtaps, float* dx, int B, int C, int H, int W,
                 float eps, float w, float alpha, float high, int square,
                 void* stream) {
  const size_t bytes = ee_fused_smem_bytes(C, H, W);
  const cudaError_t err = allow_smem(ee_fused_bwd_kernel, bytes, g_bwd_smem);
  if (err != cudaSuccess) return (int)err;
  Params p{B, C, H, W, eps, w, alpha, high, square};
  ee_fused_bwd_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      u, x, stripes, sq_delta, y, ar, ai, br, bi, gtaps, dx, p);
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
