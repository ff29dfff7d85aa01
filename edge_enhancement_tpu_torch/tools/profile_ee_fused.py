"""Where the block time of the front-end kernels goes, on one CUDA device:

    python -m edge_enhancement_tpu_torch.tools.profile_ee_fused [--shape B C H W]

K1/K2 in bfloat16: builds a copy of csrc/ee_fused.cu with clock64() marks
at the barriers between the phases of the two kernels (read by thread 0 of
each block), runs K1 and K2 once each on noise with constant and zero
patches, the square off (its `stripes` pointer then carries the counters),
and prints each phase's share of the block cycles summed over all blocks,
and the share of K1's outputs that its exact stage recomputed.

K3a/K3b in bfloat16 and in float32: a second copy in which every barrier of
the Canny-only kernels (every function named canny_{fwd,bwd}[_bf16]_kernel)
ends a phase and the block's end ends the last: the stage (K3b: and the
gate) up to the first barrier, then, alternating, the blur and Sobel /
magnitude / stores (K3b: the Sobel adjoints, and the blur adjoint and
stores). Each block writes its phase cycles behind the Gaussian taps
(`gaussian_taps`' buffer is widened). It prints each phase's share, the
mean cycles and phases of a block, and each kernel's device time from the
uninstrumented build. Being keyed on kernel names and barriers, not on
lines, the K3 marks fit any revision of the source: run this file from a
checkout of another revision to profile that revision's kernels.

Many blocks share an SM, so a share is of block time, not of the launch's
time. The copies are the kernels' code with the marks added; time the
kernels themselves with chip_smoke.py. It also prints the instruction
classes of the K3 kernels' SASS (`build.sass_counts`).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import tempfile

import torch

from ..ops.cuda import build
from ..ops.cuda import ee_fused as F

PHASES = ("Canny branch", "T (K1, FP32 pipes)", "hfs on the tensor cores",
          "T (K2, tensor cores)", "result tile and recompute marks", "recompute",
          "epilogue")
_SLOTS = 8          # the phases, then the count of recomputed outputs

_HELPERS = r'''
__shared__ unsigned long long s_prof_last, s_prof[8];
__device__ __forceinline__ void prof_init() {
  if (threadIdx.x == 0) {
    s_prof_last = clock64();
    for (int i = 0; i < 8; ++i) s_prof[i] = 0;
  }
}
__device__ __forceinline__ void prof_mark(int i) {
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    if (i >= 0) s_prof[i] += now - s_prof_last;
    s_prof_last = now;
  }
}
__device__ __forceinline__ void prof_flush(const void* out) {
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) atomicAdd((unsigned long long*)out + i, s_prof[i]);
}
'''
_K1_CANNY = ("h0, W % 4 == 0 && aligned16(x),\n"
             "                  reinterpret_cast<float*>(smem + L.t), sE, L.lde);\n")
_K2_CANNY = ("band0,\n                                 W % 4 == 0 && aligned16(x),\n"
             "                                 reinterpret_cast<float*>(smem + L.t), sE, "
             "L.lde);\n")
_HFS_RING = ("    pipeline(L.np / kMmaChunk, stages, kMmaStage, issue, [](int) {}, [](bf16*) {}, "
             "compute);\n")
# (anchor, replacement): each anchor occurs once in the source
EDITS = (
    ("using bf16 = __nv_bfloat16;\n", "using bf16 = __nv_bfloat16;\n" + _HELPERS),
    ("  band_edge<BF16>(xb, g, p, h0,", "  prof_init();\n  band_edge<BF16>(xb, g, p, h0,"),
    (_K1_CANNY, _K1_CANNY + "  prof_mark(0);\n"),
    ("    mma_hfs<false, true>(L, H - h0, W, rr, ri, smem,",
     "    prof_mark(1);\n    mma_hfs<false, true>(L, H - h0, W, rr, ri, smem,"),
    (_HFS_RING, _HFS_RING + "    prof_mark(2);\n"),
    ("    __syncthreads();\n    if constexpr (EXACT) {\n",
     "    __syncthreads();\n    prof_mark(4);\n    if constexpr (EXACT) {\n"),
    ("      __syncthreads();\n    }\n    out(tile, n0);\n    __syncthreads();\n",
     "      __syncthreads();\n    }\n    prof_mark(5);\n"
     "    if (threadIdx.x == 0) s_prof[7] += n_exact;\n"
     "    out(tile, n0);\n    __syncthreads();\n    prof_mark(6);\n"),
    ("  band_canny_adjoint<true, BF16>(x + img,",
     "  prof_init();\n  band_canny_adjoint<true, BF16>(x + img,"),
    (_K2_CANNY, _K2_CANNY + "  prof_mark(0);\n"),
    ("    mma_t(L, band0, lr, li, smem, plane);",
     "    prof_mark(-1);\n    mma_t(L, band0, lr, li, smem, plane);\n    prof_mark(3);"),
    ("        store8(oc + (size_t)h * W + w, ov, W % 8 == 0, W - w);\n      }\n    });\n  }\n}",
     "        store8(oc + (size_t)h * W + w, ov, W % 8 == 0, W - w);\n      }\n    });\n  }\n"
     "  prof_flush(stripes);\n}"),
    ("        store8(dxc + q, d, vec, n);\n      }\n    });\n  }\n}",
     "        store8(dxc + q, d, vec, n);\n      }\n    });\n  }\n  prof_flush(stripes);\n}"),
)


def _source() -> str:
    with open(os.path.join(build.CSRC, "ee_fused.cu")) as f:
        return f.read()


def instrumented_source() -> str:
    """csrc/ee_fused.cu with K1/K2's phase marks; raises if an anchor is not
    found exactly once (the source moved on without this tool)."""
    src = _source()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor found {src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, text)
    return src


K3_PHASES = {"K3a": ("stage", "blur", "Sobel, magnitude and stores"),
             "K3b": ("stage and gate", "Sobel adjoints", "blur adjoint and stores")}
K3_KERNEL = re.compile(r"\n(canny_(?:fwd|bwd)(?:_bf16)?_kernel)\(")
_K3_COUNTERS = 16       # float offset of the blocks' records in the widened taps
# thread 0 of a block reads the clock at the kernel's start, after every
# barrier and at its end (K3Prof's destructor), and writes the block's
# record: its cycles in the three phases and its count of phases
_K3_HELPERS = r'''
__shared__ unsigned long long s_k3_last, s_k3[3];
__shared__ int s_k3_phase;
__device__ __forceinline__ void k3_mark() {
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    s_k3[s_k3_phase == 0 ? 0 : 2 - (s_k3_phase & 1)] += now - s_k3_last;
    s_k3_last = now;
    ++s_k3_phase;
  }
}
__device__ __forceinline__ void k3_barrier() {
  __syncthreads();
  k3_mark();
}
struct K3Prof {
  unsigned long long* out;
  __device__ explicit K3Prof(const float* taps)
      : out(reinterpret_cast<unsigned long long*>(const_cast<float*>(taps) + COUNTERS)) {
    if (threadIdx.x == 0) {
      s_k3_last = clock64();
      s_k3_phase = 0;
      for (int i = 0; i < 3; ++i) s_k3[i] = 0;
    }
  }
  __device__ ~K3Prof() {
    k3_mark();
    if (threadIdx.x == 0) {
      unsigned long long* rec =
          out + 4 * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
      for (int i = 0; i < 3; ++i) rec[i] = s_k3[i];
      rec[3] = s_k3_phase;
    }
  }
};
#define __syncthreads() k3_barrier()
'''


def k3_instrumented_source() -> str:
    """csrc/ee_fused.cu with the K3 marks: the helpers at the top of the
    anonymous namespace, a K3Prof at the start of every K3 kernel."""
    src = _source()
    kernels = K3_KERNEL.findall(src)
    if sorted(kernels) != sorted(set(kernels)) or not kernels:
        raise RuntimeError(f"K3 kernels not found once each: {kernels}")
    helpers = _K3_HELPERS.replace("COUNTERS", str(_K3_COUNTERS))
    src = src.replace("namespace {\n", "namespace {\n" + helpers, 1)
    for name in kernels:
        at = src.index("{\n", src.index(f"\n{name}(")) + 2
        src = src[:at] + "  K3Prof k3_prof(gtaps);\n" + src[at:]
    return src


def _build(tmp: str, tag: str, source: str):
    """Starts nvcc on `source` in `tmp`; returns a function that waits for
    it and gives the library."""
    src, so = os.path.join(tmp, f"{tag}.cu"), os.path.join(tmp, f"lib{tag}.so")
    with open(src, "w") as f:
        f.write(source)
    proc = subprocess.Popen([build._cuda_tool(), *build.NVCC_FLAGS, "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def done() -> build.Library:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {tag} copy:\n{log}")
        return build.Library(so, 0.0, log)
    return done


def _use(lib: build.Library) -> None:
    """Make the wrappers launch from `lib`."""
    build.load = lambda name: lib
    F._library.cache_clear()


def _widen_taps(shape, dev, sigma: float) -> dict:
    """{dtype: records}: the Gaussian taps of each dtype moved into a buffer
    that carries a record of 4 int64 for each block of a K3 launch on
    `shape` behind them (from float _K3_COUNTERS on; room for tiles down to
    8 x 8 pixels), put where the wrappers find the taps."""
    b, _, h, w = shape
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        wide = torch.zeros(_K3_COUNTERS + 8 * b * -(-h // 8) * -(-w // 8), device=dev)
        wide[:9] = F.gaussian_taps(sigma, dev, dtype)
        F._TAPS[(sigma, str(dev), dtype)] = wide[:9]
        records[dtype] = wide[_K3_COUNTERS:].view(torch.int64).view(-1, 4)
    return records


def _inputs(shape, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, h, w = shape
    x = torch.rand(shape, generator=gen, device=dev)
    x[:, :, h // 8:h // 3, w // 8:w // 3] = 0.5
    x[1::2, :, h // 2:3 * h // 4, w // 2:3 * w // 4] = 0.0
    u = torch.randn(shape, generator=gen, device=dev)
    return x.to(torch.bfloat16), u.to(torch.bfloat16)


def _k1_k2(shape, x, u, dev) -> dict:
    k = F.FusedConsts(r=8, eps=0.062745098039216, w=1.0, alpha=0.0,
                      high=76.0 / 255.0, sigma=1.0, square=False)
    counts = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
    _, y = F.ee_fused_fwd(x, counts, None, k)
    result = {}
    for name, run in (("K1", lambda: F.ee_fused_fwd(x, counts, None, k)),
                      ("K2", lambda: F.ee_fused_bwd(u, x, counts, None, y, k))):
        counts.zero_()
        run()
        torch.cuda.synchronize()
        cycles = counts[:len(PHASES)].double()
        shares = {p: round(100 * c / cycles.sum().item(), 1)
                  for p, c in zip(PHASES, cycles.tolist()) if c > 0}
        result[name] = shares
        line = (f"{name} bf16 at {shape} on {torch.cuda.get_device_name(0)}: "
                f"% of block cycles {shares}")
        if name == "K1":
            result["recomputed"] = counts[7].item() / x.numel()
            line += f"; outputs recomputed {100 * result['recomputed']:.3f}%"
        print(line, flush=True)
    return result


def _tag(name: str, dtype) -> str:
    return f"{name} {'bf16' if dtype == torch.bfloat16 else 'f32'}"


def _k3_runs(x, u):
    """(kernel, dtype, run) of K3a and K3b in both dtypes on x and the
    plane u."""
    high, sigma, alpha = 76.0 / 255.0, 1.0, 0.0
    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        xd, ud = x.to(dtype), u.to(dtype)
        _, mag, gx, gy = F.canny_fused_fwd(xd, high, sigma, alpha)
        runs.append(("K3a", dtype, lambda xd=xd: F.canny_fused_fwd(xd, high, sigma, alpha)))
        runs.append(("K3b", dtype, lambda ud=ud, m=mag, a=gx, b=gy: F.canny_fused_bwd(
            ud, m, a, b, x.shape[1], high, sigma, alpha)))
    return runs


def _k3(shape, x, u, times: dict) -> dict:
    records = _widen_taps(shape, x.device, 1.0)
    result = {}
    for name, dtype, run in _k3_runs(x, u):
        rec = records[dtype]
        rec.zero_()
        run()
        torch.cuda.synchronize()
        rec = rec[rec[:, 3] > 0].double()      # the launched blocks'
        cycles = rec[:, :3].sum(0)
        blocks = rec.shape[0]
        shares = {p: round(100 * c / cycles.sum().item(), 1)
                  for p, c in zip(K3_PHASES[name], cycles.tolist())}
        tag = _tag(name, dtype)
        result[tag] = {"shares": shares, "block_cycles": cycles.sum().item() / blocks,
                       "phases": rec[:, 3].mean().item(), "blocks": blocks, "ms": times[tag]}
        print(f"{tag} at {shape} on {torch.cuda.get_device_name(0)}: % of block cycles "
              f"{shares}; {blocks} blocks of {result[tag]['block_cycles']:.0f} cycles and "
              f"{result[tag]['phases']:.2f} phases on average; {times[tag]:.4f} ms a launch "
              "(uninstrumented)", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[256, 3, 128, 128],
                    metavar=("B", "C", "H", "W"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ee_fused needs a CUDA device")
    from ..utils.cuda_timing import device_ms
    dev = torch.device("cuda")
    shape = tuple(args.shape)
    with tempfile.TemporaryDirectory() as tmp:
        k12 = _build(tmp, "k12", instrumented_source())
        k3 = _build(tmp, "k3", k3_instrumented_source())
        x, u = _inputs(shape, dev)
        plane = u[:, :1].contiguous()
        lib = build.load("ee_fused")
        for kernel, counts in build.sass_counts(build.sass(lib.path)).items():
            print(f"SASS {kernel}: {counts}", flush=True)
        times = {}
        for name, dtype, run in _k3_runs(x, plane):
            times[_tag(name, dtype)] = device_ms(run)
        _use(k12())
        result = _k1_k2(shape, x, u, dev)
        _use(k3())
        result.update(_k3(shape, x, plane, times))
    return result


if __name__ == "__main__":
    main()
