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
// workarounds and are not carried over. Two kernels compute it, one for
// each type, both on Hopper's tensor cores (wgmma) fed by the same
// cp.async ring: bfloat16 as one bf16 product, float32 as three TF32
// products (3xTF32) that keep float32 accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
// float32: three TF32 products on wgmma (3xTF32), on the bf16 kernel's ring.
//
// One TF32 product (10 mantissa bits an operand) misses the float32 limit
// by 30x; three keep float32 accuracy. Each operand v is split into
// v_hi = tf32(v) and v_lo = tf32(v - v_hi), both rounded to nearest with
// ties away from zero (cvt.rna), and
//
//   out = A_lo W_hi + A_hi W_lo + A_hi W_hi
//
// accumulates in FP32, the small products first in each k step (A_lo W_lo,
// below 2^-22 relative, is dropped). The tensor cores truncate each
// wgmma's FP32 sum, so summing all 9 C_in / 8 k steps x 3 products in one
// accumulator biases outputs of order 10 by ~6e-5 (1.2e-4 at C_in 128, over
// the limit; measured on an H100). So each ring step sums its 12 wgmmas
// into accumulators started at zero (scale-d 0), which the threads then add
// to a float32 total with IEEE adds: the truncation then acts on one step's
// partial sums only (4.5e-6 from a float64 convolution, measured).
//
// Bound at 128 x 56 x 56, 64 -> 64: three products of 29.6 GFLOP at 494.7
// TFLOP/s (dense TF32 tensor cores) is 179.5 us; the bytes (x and out in
// float32, 102.8 MB each, and 2 x 147 KB of split weights) at 3.35 TB/s
// 61.4 us. Operations bound it.
//
// Design: the bf16 kernel's ring at 32 channels (128 bytes) a step. One
// warpgroup computes a 64 x 64 tile of `out` over 9 taps x
// ceil(C_in / 32) ring steps (18 for C_in 64), loading K-major SW128 tiles
// with 16-byte cp.async.cg copies whose source size 0 is the SAME padding
// and every ragged edge, then fence.proxy.async and the barrier as in the
// bf16 kernel. The weights arrive split (the wrapper's split_tf32, once at
// pack time): a stage holds the A tile, W_hi and W_lo (8 + 2 x 8 KB); 3
// stages make 73 KB a block, so three blocks share an SM (152 registers a
// thread, no spills). The activations are split in registers: each
// thread loads its A fragments of the step from the swizzled tile (a
// 4-byte load a value, conflict-free), splits them with two cvt.rna, and
// wgmma m64n64k8.f32.tf32.tf32 takes A from registers (RS form) and W from
// shared memory through SW128 descriptors, the start advancing 32 B a k8
// step inside the swizzle atom as for bf16 (tf32 takes both operands
// K-major and has no transpose operands). A stage is refilled only after the
// barrier that follows every warp's wgmma wait. The epilogue stages the
// float32 tile in the idle ring (256-byte rows, 16-byte chunks swizzled by
// row % 8: conflict-free 8-byte writes) and writes 16-byte chunks of 4
// channels.
//
// Tried on an H100 (PERF.md has the times): A split in shared memory
// instead (each thread splitting the chunks it copied, hi in place and lo
// into an A_lo tile, read by wgmma in the SS form) was 3.4% slower at 128 x
// 56 x 56 (2 stages; 3 stages slower still); 128-row tiles (2 blocks an SM)
// were slower than 64-row ones (3 blocks an SM), and 2 or 4 stages slower
// than 3; the big product first took the same time and was less accurate
// (5.5e-6 from float64 against 4.5e-6).
//
// What it leaves: each 64-row block streams 16 KB of split weights and
// 8 KB of A a step, about 2.7 GB of L2-to-SM traffic per call at 128 x 56
// x 56, most of it weights; resident or shared weight tiles and TMA are
// the next levers.

constexpr int kF32BM = 64;                           // out rows a block
constexpr int kF32Stages = 3;
constexpr int kF32Chunk = 32;                        // channels (128 B) a step
constexpr int kF32KSteps = kF32Chunk / 8;            // k8 steps a ring step
constexpr int kF32ATileBytes = kF32BM * 128;
constexpr int kF32WTileBytes = kWgBN * 128;          // 8 KB
// a stage: A, W_hi, W_lo
constexpr int kF32StageBytes = kF32ATileBytes + 2 * kF32WTileBytes;
constexpr int kF32SmemBytes = kF32Stages * kF32StageBytes + 1024;
constexpr int kF32ARows = kF32BM / kWgRowStep;       // A rows a thread copies
static_assert(kF32BM * kWgBN * 4 <= kF32Stages * kF32StageBytes,
              "the epilogue's float32 tile fits in the ring");

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// v = hi + lo to 2^-22 relative, both TF32; lo = 0 where hi is not finite
// (split_tf32 in ops/cuda/gemm_conv.py is the same function)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(v);
  hi = __float_as_uint(h);
  lo = (hi & 0x7f800000u) != 0x7f800000u ? __float_as_uint(tf32_rna(v - h)) : 0u;
}

// d[64 x 64] = A[64 x 8] * B[8 x 64] (+ d unless scale_d is 0) in TF32: A
// from registers, a[0..3] holding rows 16 (t / 32) + (t % 32) / 4 (+ 8 in
// a[1], a[3]) and columns t % 4 (+ 4 in a[2], a[3]); B K-major in shared
// memory (tf32 has no transpose operands); d laid out as in wgmma_m64n64k16
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// C_in % 4 == 0 and 16-byte aligned x, w_hi and w_lo (the wrapper pads C_in
// to a multiple of 8 and checks the alignment)
__global__ void __launch_bounds__(kWgThreads)
conv3x3_f32_3xtf32_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_hi,
                          const float* __restrict__ w_lo,
                          float* __restrict__ out, int B, int H, int W, int Cin,
                          int Cout) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const ring_p = smem_raw + (ring - smem_u32(smem_raw));
  const int HW = H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const int nck = (Cin + kF32Chunk - 1) / kF32Chunk;
  const int nsteps = 9 * nck;
  const long long m0 = (long long)blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * kWgBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int jc = tid % 8, row0 = tid / 8;
  const uint32_t swz = (uint32_t)((jc ^ (row0 & 7)) << 4);

  int rh[kF32ARows], rw[kF32ARows];
  long long roff[kF32ARows];
#pragma unroll
  for (int i = 0; i < kF32ARows; ++i) {
    const long long m = m0 + row0 + i * kWgRowStep;
    const int b = (int)(m / HW), r = (int)(m - (long long)b * HW);
    rh[i] = m < M ? r / W : -4;
    rw[i] = r % W;
    roff[i] = m * Cin;
  }

  auto load = [&](int s, int stage) {
    const int tap = s / nck, c = (s - tap * nck) * kF32Chunk + jc * 4;
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    const bool cin_ok = c < Cin;
    const long long delta = ((long long)dh * W + dw) * Cin + c;
    const uint32_t sa = ring + stage * kF32StageBytes;
#pragma unroll
    for (int i = 0; i < kF32ARows; ++i) {
      const int h = rh[i] + dh, wc = rw[i] + dw;
      const bool ok = cin_ok && h >= 0 && h < H && wc >= 0 && wc < W;
      cp_async_16(sa + (row0 + i * kWgRowStep) * 128 + swz,
                  ok ? x + roff[i] + delta : x, ok);
    }
    const uint32_t sw = sa + kF32ATileBytes;
#pragma unroll
    for (int i = 0; i < kWgWRows; ++i) {
      const int n = n0 + row0 + i * kWgRowStep;
      const bool ok = cin_ok && n < Cout;
      const long long off = (long long)n * K + tap * Cin + c;
      const uint32_t dst = sw + (row0 + i * kWgRowStep) * 128 + swz;
      cp_async_16(dst, ok ? w_hi + off : w_hi, ok);
      cp_async_16(dst + kF32WTileBytes, ok ? w_lo + off : w_lo, ok);
    }
  };

  // part: one ring step's sums, in the wgmma accumulators; acc: their
  // total, added up with IEEE float32 adds
  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  // this thread's A fragments of a step: [k8 step][hi, lo][register]
  uint32_t fa[kF32KSteps][2][4];

  // The ring as in the bf16 kernel: step s reads stage s % kF32Stages; the
  // loads of step s + kF32Stages - 1 refill the stage that step s - 1 read,
  // after this step's barrier, which every warp reaches after waiting for
  // its step s - 1 wgmmas.
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    const int stage = s % kF32Stages;
    cp_async_wait<kF32Stages - 2>();  // this thread's copies of step s landed
    fence_proxy_async();              // ... for wgmma's reads of W
    __syncthreads();                  // ... and every thread's
    const int next = s + kF32Stages - 1;
    if (next < nsteps) load(next, next % kF32Stages);
    cp_async_commit();
    const uint8_t* const a = ring_p + stage * kF32StageBytes;
#pragma unroll
    for (int k = 0; k < kF32KSteps; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = warp * 16 + lane / 4 + (j & 1) * 8;
        const int q = 2 * k + (j >> 1);  // the value's 16-byte chunk
        split_tf32(*reinterpret_cast<const float*>(
                       a + r * 128 + ((q ^ (r & 7)) << 4) + (lane % 4) * 4),
                   fa[k][0][j], fa[k][1][j]);
      }
    wgmma_fence();
    const uint32_t sw = ring + stage * kF32StageBytes + kF32ATileBytes;
#pragma unroll
    for (int k = 0; k < kF32KSteps; ++k) {  // 32 bytes a k8 step
      const uint64_t dwh = sw128_desc(sw + 32 * k);
      const uint64_t dwl = sw128_desc(sw + kF32WTileBytes + 32 * k);
      // p = 0, 1, 2: A_lo W_hi, A_hi W_lo, A_hi W_hi
#pragma unroll
      for (int p = 0; p < 3; ++p)
        wgmma_m64n64k8_tf32_rs(part, fa[k][p == 0], p == 1 ? dwl : dwh, k + p > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the wgmmas read fa until the wait: keep it live and unmoved till here
#pragma unroll
    for (int k = 0; k < kF32KSteps; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) asm volatile("" : "+r"(fa[k][j / 4][j % 4]));
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
  }

  // Epilogue: the accumulators into a 64 x 64 float32 tile of the (now
  // idle) ring, 256-byte rows whose 16-byte chunk q sits at (q ^ row % 8),
  // then written out as 16-byte chunks of 4 channels.
  cp_async_wait<0>();
  __syncthreads();
  const int rl = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // rows rl, rl + 8
      const int r = rl + q * 8, i = 4 * j + 2 * q;
      *reinterpret_cast<float2*>(ring_p + r * 256 + (((c >> 2) ^ (r & 7)) << 4) +
                                 (c & 3) * 4) = make_float2(acc[i], acc[i + 1]);
    }
  }
  __syncthreads();
  const int jq = tid % 16, r0 = tid / 16;  // chunk jq of rows r0 + 8 i
  const int n = n0 + jq * 4;
  const bool vec = Cout % 4 == 0;  // then every row is 16-byte aligned
#pragma unroll
  for (int i = 0; i < kF32BM / 8; ++i) {
    const int r = r0 + 8 * i;
    const long long m = m0 + r;
    if (m >= M || n >= Cout) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(ring_p + r * 256 + ((jq ^ (r & 7)) << 4));
    float* const dst = out + m * Cout + n;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (int t = 0; t < 4 && n + t < Cout; ++t) dst[t] = e[t];
    }
  }
}

// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;
size_t g_wgmma_smem[kMaxDevices], g_f32_smem[kMaxDevices];

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
  if (Cin % 8 != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaError_t err =
      allow_smem(conv3x3_f32_3xtf32_kernel, kF32SmemBytes, g_f32_smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + kF32BM - 1) / kF32BM), (Cout + kWgBN - 1) / kWgBN);
  const float* w_hi = (const float*)w;
  conv3x3_f32_3xtf32_kernel<<<grid, kWgThreads, kF32SmemBytes,
                              (cudaStream_t)stream>>>(
      (const float*)x, w_hi, w_hi + (long long)Cout * 9 * Cin, (float*)out, B, H,
      W, Cin, Cout);
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

// x (B, H, W, Cin), out (B, H, W, Cout), both of one type: dtype 0 =
// float32, w (2, Cout, 9 * Cin) tap-major, its TF32 high then low part; 1 =
// bfloat16, w (Cout, 9 * Cin) tap-major. Cin % 8 == 0 and x, w 16-byte
// aligned. Returns a cudaError_t, 0 when the launch was accepted.
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
