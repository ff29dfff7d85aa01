"""Build a CUDA source of this package into a shared library and load it.

The sources in edge_enhancement_tpu_torch/csrc/ export a plain C interface;
nvcc compiles one into a shared library for Hopper (sm_90a) at first use,
into edge_enhancement_tpu_torch/_build/ (listed in .gitignore), keyed by a
hash of the source and the flags, and ctypes loads it. A missing nvcc or a
failed compile raises: there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "edge_enhancement_tpu_torch are built with it")


class Library:
    """One compiled source: the ctypes handle, the build's seconds (0.0 when
    it was already built) and the compiler's output."""

    def __init__(self, name: str):
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
        self.build_seconds, self.log = 0.0, ""
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.time()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            self.build_seconds = time.time() - t0
            self.log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{self.log}")
            os.replace(tmp, so)
        self.path = so
        self.lib = ctypes.CDLL(so)


_LIBS: dict[str, Library] = {}


def load(name: str) -> Library:
    """Build (once per source revision) and load csrc/<name>.cu."""
    if name not in _LIBS:
        _LIBS[name] = Library(name)
    return _LIBS[name]
