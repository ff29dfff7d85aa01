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
// workarounds and are not carried over. Two kernels compute it: one for
// each type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// float32: an FP32-datapath implicit GEMM.
//
// Design: a block computes a 128 x 64 tile of `out`; each step gathers a
// 128 x 16 slice of A (the im2col rows, zero-padded by masks, never stored
// in device memory; each thread decomposes its rows into (h, w) once) and
// a 16 x 64 slice of W into shared memory as FP32, and each of 256 threads
// accumulates an 8 x 4 register tile with FP32 FMA from 16-byte shared
// loads. What bounds it: at the bench shapes (C 64 -> 64) the FMAs, on the
// FP32 pipes (441.7 us at 67 TFLOP/s for 128 x 56 x 56). Any B, H, W, C_in
// and C_out: ragged tiles are masked.

constexpr int kBM = 128, kBN = 64, kBK = 16;
constexpr int kTM = 8, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bfloat16: one warpgroup of wgmma fed by a cp.async ring.
//
// Bound at 128 x 56 x 56, 64 -> 64: 102.8 MB (x and out, each once) at
// 3.35 TB/s is 30.7 us, and 29.6 GFLOP at 989 TFLOP/s (dense bf16 tensor
// cores) is 29.9 us: balanced, so the kernel must keep the tensor cores
// and the memory busy at once.
//
// Design: a block of one warpgroup (128 threads) computes a 128 x 64 tile
// of `out`. Its K loop runs over 9 taps x ceil(C_in / 64) chunks of 64
// channels; a step's A tile (128 rows x 64 channels) and W tile (64 output
// channels x the same 64 k) are 128-byte rows, i.e. K-major tiles in the
// 128-byte swizzle layout (16-byte chunk c of row r at r*128 + (c ^ r%8)*16,
// tile bases 1024-byte aligned). Each thread fills its chunks with 16-byte
// cp.async.cg copies whose source size is 0 where the tap leaves the
// image, the row is past M, the chunk is past C_in or the output channel
// is past C_out: the zero fill is the SAME padding and the ragged edges,
// one predicate per chunk. A ring of 3 such stages (24 KB each; 73 KB a
// block, so three blocks share an SM) keeps the next two steps' loads in
// flight while the tensor cores work: per 16-deep k step two wgmma
// m64n64k16 (rows 0-63 and 64-127), both operands read from shared memory
// through SW128 descriptors, FP32 accumulators in registers (64 a thread).
// A block waits for its step's wgmmas before the next barrier; the other
// blocks on the SM keep the tensor cores busy meanwhile. The epilogue
// rounds the accumulators to bf16 once, stages them in shared memory and
// writes 16-byte rows. Tried on an H100 and slower: 4 stages with one
// wgmma group kept in flight (two blocks an SM), 5 stages (one block an
// SM), and 4-byte stores straight from the accumulators; blocks per SM hide
// the load latency better than a deeper ring. A and W are streamed
// together; keeping the 9 W tiles of a 64-channel layer resident (72 KB)
// moves the same bytes per block, leaves one block an SM, and was not
// measured.
//
// What it leaves: each input row is fetched by up to 9 tap tiles (at
// 128 x 56 x 56 about 0.46 GB of L2-to-SM traffic per call for 51 MB of
// input, and 0.23 GB more for the 72 KB of weights each of the 3136 blocks
// reads), and a block's first loads are not overlapped with anything of
// its own. Reusing a halo tile in shared memory, more output rows per
// weight tile, TMA with a producer warp and a persistent grid are the next
// levers.

constexpr int kWgThreads = 128;                   // one warpgroup
constexpr int kWgBM = 128, kWgBN = 64;            // out tile
constexpr int kChunk = 64;                        // channels (128 B) a step
constexpr int kStages = 3;
constexpr int kATileBytes = kWgBM * kChunk * 2;   // 16 KB
constexpr int kWTileBytes = kWgBN * kChunk * 2;   // 8 KB
constexpr int kStageBytes = kATileBytes + kWTileBytes;
// + 1 KB so the ring can start on a 1024-byte boundary
constexpr int kWgSmemBytes = kStages * kStageBytes + 1024;
// a thread copies 16-byte chunk (tid % 8) of rows tid / 8 + 16 i
constexpr int kWgRowStep = kWgThreads / 8;             // 16
constexpr int kWgARows = kWgBM / kWgRowStep;           // 8
constexpr int kWgWRows = kWgBN / kWgRowStep;           // 4

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with `valid` false, 16 zero bytes (source
// size 0: nothing is read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle
// layout: start address >> 4, leading byte offset 1 (unused for swizzled
// K-major), stride byte offset 1024 B >> 4 (one 8-row swizzle atom), layout
// type 1 = SWIZZLE_128B in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A and B K-major in shared memory;
// thread t holds d rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns
// 8 j + 2 (t % 4) (+ 1) at d[4 j .. 4 j + 3]
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// C_in % 8 == 0 and 16-byte aligned x and w (the wrapper sees to both)
__global__ void __launch_bounds__(kWgThreads)
conv3x3_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          __nv_bfloat16* __restrict__ out, int B, int H, int W,
                          int Cin, int Cout) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int HW = H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const int nck = (Cin + kChunk - 1) / kChunk;
  const int nsteps = 9 * nck;
  const long long m0 = (long long)blockIdx.x * kWgBM;
  const int n0 = blockIdx.y * kWgBN;
  const int tid = threadIdx.x;
  const int jc = tid % 8, row0 = tid / 8;
  // the swizzled byte offset of this thread's chunk in each of its rows
  // (row0 + 16 i has the same row % 8 as row0)
  const uint32_t swz = (uint32_t)((jc ^ (row0 & 7)) << 4);

  // the (h, w) and NHWC offset of this thread's A rows; h = -4 marks a row
  // past M, which every tap then reads as padding
  int rh[kWgARows], rw[kWgARows];
  long long roff[kWgARows];
#pragma unroll
  for (int i = 0; i < kWgARows; ++i) {
    const long long m = m0 + row0 + i * kWgRowStep;
    const int b = (int)(m / HW), r = (int)(m - (long long)b * HW);
    rh[i] = m < M ? r / W : -4;
    rw[i] = r % W;
    roff[i] = m * Cin;
  }

  auto load = [&](int s, int stage) {
    const int tap = s / nck, c = (s - tap * nck) * kChunk + jc * 8;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const bool cin_ok = c < Cin;
    const long long delta = ((long long)dh * W + dw) * Cin + c;
    const uint32_t sa = ring + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < kWgARows; ++i) {
      const int h = rh[i] + dh, wc = rw[i] + dw;
      const bool ok = cin_ok && h >= 0 && h < H && wc >= 0 && wc < W;
      cp_async_16(sa + (row0 + i * kWgRowStep) * 128 + swz,
                  ok ? x + roff[i] + delta : x, ok);
    }
    const uint32_t sw = sa + kATileBytes;
#pragma unroll
    for (int i = 0; i < kWgWRows; ++i) {
      const int n = n0 + row0 + i * kWgRowStep;
      const bool ok = cin_ok && n < Cout;
      cp_async_16(sw + (row0 + i * kWgRowStep) * 128 + swz,
                  ok ? w + (long long)n * K + tap * Cin + c : w, ok);
    }
  };

  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;

  // Ring: step s reads stage s % kStages; the loads of step s + kStages - 1
  // go into the stage that step s - 1 read, after this step's barrier: every
  // thread waited for step s - 1's wgmmas (wait_group 0) before it, so no
  // warp still reads that stage.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step s landed
    fence_proxy_async();
    __syncthreads();               // ... and every thread's
    const int next = s + kStages - 1;
    if (next < nsteps) load(next, next % kStages);
    cp_async_commit();
    wgmma_fence();
    const uint32_t sa = ring + (s % kStages) * kStageBytes;
    const uint32_t sw = sa + kATileBytes;
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {  // 32 bytes a k16 step
      const uint64_t db = sw128_desc(sw + 32 * k);
      wgmma_m64n64k16(acc0, sw128_desc(sa + 32 * k), db);
      wgmma_m64n64k16(acc1, sw128_desc(sa + 64 * 128 + 32 * k), db);
    }
    wgmma_commit();
    wgmma_wait<0>();
  }

  // Epilogue: the accumulators rounded to bf16 once into a 128 x 64 tile
  // of the (now idle) ring, swizzled as the A tiles are (conflict-free
  // 4-byte writes), then written out as 16-byte rows of 8 channels.
  cp_async_wait<0>();
  __syncthreads();
  uint8_t* tile = smem_raw + (ring - smem_u32(smem_raw));
  const int warp = tid / 32, lane = tid % 32;
  const int rl = warp * 16 + lane / 4, cb = 4 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows rl, rl + 8 of acc0, then of acc1
      const int r = rl + (q & 1) * 8 + (q >> 1) * 64, i = 4 * j + 2 * (q & 1);
      const float v0 = q < 2 ? acc0[i] : acc1[i];
      const float v1 = q < 2 ? acc0[i + 1] : acc1[i + 1];
      *reinterpret_cast<__nv_bfloat162*>(tile + r * 128 + ((j ^ (r & 7)) << 4) + cb) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  const int n = n0 + jc * 8;
  const bool vec = Cout % 8 == 0;  // then every row is 16-byte aligned
#pragma unroll
  for (int i = 0; i < kWgARows; ++i) {
    const int r = row0 + i * kWgRowStep;
    const long long m = m0 + r;
    if (m >= M || n >= Cout) continue;
    const uint8_t* src = tile + r * 128 + swz;
    __nv_bfloat16* dst = out + m * Cout + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int t = 0; t < 8 && n + t < Cout; ++t) dst[t] = e[t];
    }
  }
}

// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
size_t g_wgmma_smem[kMaxDevices];

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

int launch_f32(const void* x, const void* w, void* out, int B, int H, int W,
               int Cin, int Cout, void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  conv3x3_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* w, void* out, int B, int H, int W,
                int Cin, int Cout, void* stream) {
  if (Cin % 8 != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaError_t err =
      allow_smem(conv3x3_bf16_wgmma_kernel, kWgSmemBytes, g_wgmma_smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kWgBM - 1) / kWgBM), (Cout + kWgBN - 1) / kWgBN);
  conv3x3_bf16_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes,
                              (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, B,
      H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, Cin), w (Cout, 9 * Cin) tap-major, out (B, H, W, Cout), all of
// one type: dtype 0 = float32, 1 = bfloat16 (then Cin % 8 == 0 and x, w
// 16-byte aligned). Returns a cudaError_t, 0 when the launch was accepted.
int conv3x3_cgemm(const void* x, const void* w, void* out, int B, int H, int W,
                  int Cin, int Cout, int dtype, void* stream) {
  if (dtype == 0) return launch_f32(x, w, out, B, H, W, Cin, Cout, stream);
  if (dtype == 1) return launch_bf16(x, w, out, B, H, W, Cin, Cout, stream);
  return (int)cudaErrorInvalidValue;
}

const char* gemm_conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
