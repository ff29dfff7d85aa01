// 3x3 SAME stride-1 convolution as an implicit GEMM for Hopper (sm_90a):
// kernel K4.
//
// Replaces the Pallas TPU kernel edge_enhancement_tpu/ops/pallas/
// gemm_conv.py::_kernel. On NHWC activations and tap-major packed weights
// (C_out, 9 * C_in) it computes
//
//   out[m, n] = sum_k A[m, k] W[n, k],   m = (b, h, w), k = (tap, ci),
//   A[m, k]   = x[b, h + dh - 1, w + dw - 1, ci]  (0 off the image),
//
// M = B*H*W, N = C_out, K = 9*C_in, accumulated in FP32, stored in the
// input's type (float32 or bfloat16). The TPU kernel's channel-major
// layout, tap pairing to K = 128 and images per block were lane and MXU
// workarounds and are not carried over.
//
// Design: a block computes a 128 x 64 tile of `out`; each step gathers a
// 128 x 16 slice of A (the im2col rows, zero-padded by masks, never stored
// in device memory; each thread decomposes its rows into (h, w) once) and
// a 16 x 64 slice of W into shared memory as FP32, and each of 256 threads
// accumulates an 8 x 4 register tile with FP32 FMA from 16-byte shared
// loads. What bounds it: at the bench shapes (C 64 -> 64) the FMAs, on the
// FP32 pipes; tensor cores (wgmma), TMA and a bf16 datapath are later
// work. Any B, H, W, C_in and C_out: ragged tiles are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kTM = 8, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Each thread gathers the same k column (tid % kBK) of kRows rows of the A
// slice at every step, and kWRows rows of the W slice.
constexpr int kRows = kBM * kBK / kThreads;   // 8
constexpr int kWRows = kBN * kBK / kThreads;  // 4
constexpr int kRowStep = kThreads / kBK;      // 16

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int B, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float sA[kBK][kBM + 4];
  __shared__ __align__(16) float sW[kBK][kBN + 4];
  const int HW = H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tn = tid % (kBN / kTN), tm = tid / (kBN / kTN);
  const int kk = tid % kBK, row0 = tid / kBK;

  // the (h, w) and NHWC offset of this thread's gather rows; h = -4 marks a
  // row past M, which every tap then reads as padding
  int rh[kRows], rw[kRows];
  long long roff[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long m = m0 + row0 + j * kRowStep;
    const int b = (int)(m / HW), r = (int)(m - (long long)b * HW);
    rh[j] = m < M ? r / W : -4;
    rw[j] = r % W;
    roff[j] = m * Cin;
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: consecutive threads take consecutive k, i.e. consecutive input
    // channels of one tap (contiguous in NHWC)
    const int k = k0 + kk;
    const int tap = k < K ? k / Cin : 0, ci = k - tap * Cin;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const long long delta = ((long long)dh * W + dw) * Cin + ci;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int h = rh[j] + dh, wc = rw[j] + dw;
      float v = 0.f;
      if (k < K && h >= 0 && h < H && wc >= 0 && wc < W)
        v = to_f32(x[roff[j] + delta]);
      sA[kk][row0 + j * kRowStep] = v;
    }
#pragma unroll
    for (int j = 0; j < kWRows; ++j) {
      const int n = n0 + row0 + j * kRowStep;
      sW[kk][row0 + j * kRowStep] =
          (n < Cout && k < K) ? to_f32(w[(long long)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sA[q][tm * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sA[q][tm * kTM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sW[q][tn * kTN]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + tm * kTM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tn * kTN + j;
      if (n < Cout) out[m * Cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W,
           int Cin, int Cout, void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  conv3x3_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin), w (Cout, 9 * Cin) tap-major, out (B, H, W, Cout), all of
// one type: dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t, 0 when
// the launch was accepted.
int conv3x3_cgemm(const void* x, const void* w, void* out, int B, int H, int W,
                  int Cin, int Cout, int dtype, void* stream) {
  if (dtype == 0) return launch<float>(x, w, out, B, H, W, Cin, Cout, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, stream);
  return (int)cudaErrorInvalidValue;
}

const char* gemm_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
