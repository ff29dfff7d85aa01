"""Where the block time of the bfloat16 front-end pair K1/K2 goes, on one
CUDA device:

    python -m edge_enhancement_tpu_torch.tools.profile_ee_fused [--shape B C H W]

Builds a copy of csrc/ee_fused.cu with clock64() marks at the barriers
between the phases of the two bfloat16 kernels (read by thread 0 of each
block), runs K1 and K2 once each on noise with constant and zero patches,
the square off (its `stripes` pointer then carries the counters), and
prints each phase's share of the block cycles summed over all blocks, and
the share of K1's outputs that its exact stage recomputed. Two blocks share
an SM, so a share is of block time, not of the launch's time. The copy is
the kernels' code with the marks added; time the kernels themselves with
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import os
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


def instrumented_source() -> str:
    """csrc/ee_fused.cu with the phase marks; raises if an anchor is not
    found exactly once (the source moved on without this tool)."""
    with open(os.path.join(build.CSRC, "ee_fused.cu")) as f:
        src = f.read()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor found {src.count(anchor)} times: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def _load_instrumented(tmp: str) -> None:
    """Build the instrumented copy into `tmp` and make the wrappers use it."""
    src, so = os.path.join(tmp, "ee_fused.cu"), os.path.join(tmp, "libee_fused.so")
    with open(src, "w") as f:
        f.write(instrumented_source())
    done = subprocess.run([build._cuda_tool(), *build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n{done.stdout}{done.stderr}")
    lib = build.Library(so, 0.0, "")
    build.load = lambda name: lib
    F._library.cache_clear()


def _inputs(shape, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    b, c, h, w = shape
    x = torch.rand(shape, generator=gen, device=dev)
    x[:, :, h // 8:h // 3, w // 8:w // 3] = 0.5
    x[1::2, :, h // 2:3 * h // 4, w // 2:3 * w // 4] = 0.0
    u = torch.randn(shape, generator=gen, device=dev)
    return x.to(torch.bfloat16), u.to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=[256, 3, 128, 128],
                    metavar=("B", "C", "H", "W"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ee_fused needs a CUDA device")
    dev = torch.device("cuda")
    shape = tuple(args.shape)
    with tempfile.TemporaryDirectory() as tmp:
        _load_instrumented(tmp)
        x, u = _inputs(shape, dev)
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


if __name__ == "__main__":
    main()
