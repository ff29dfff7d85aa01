"""Build the CUDA sources of this package into shared libraries and load
them.

The sources in edge_enhancement_tpu_torch/csrc/ export a plain C interface;
nvcc compiles each into a shared library for Hopper (sm_90a) at first use,
into edge_enhancement_tpu_torch/_build/ (listed in .gitignore), keyed by a
hash of the source and the flags, and ctypes loads it. `load_all` starts one
nvcc for each source that is not built yet, all at once. A missing nvcc or
a failed compile raises: there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ee_fused", "gemm_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _cuda_tool(name: str = "nvcc") -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", name),
                 os.path.join("/usr/local/cuda/bin", name), shutil.which(name) or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (set CUDA_HOME); the CUDA kernels of "
                       "edge_enhancement_tpu_torch are built with the CUDA toolkit")


class Library:
    """One compiled source: the ctypes handle, the build's seconds (0.0 when
    it was already built) and the compiler's output."""

    def __init__(self, path: str, build_seconds: float, log: str):
        self.path, self.build_seconds, self.log = path, build_seconds, log
        self.lib = ctypes.CDLL(path)


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


_LIBS: dict[str, Library] = {}


def load_all(names=SOURCES) -> dict[str, Library]:
    """Build (once per source revision, the missing ones in parallel) and
    load csrc/<name>.cu for each name."""
    todo = [n for n in names if n not in _LIBS]
    started = []
    for name in todo:
        src, so = _target(name)
        if os.path.exists(so):
            _LIBS[name] = Library(so, 0.0, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_cuda_tool(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started.append((name, src, so, tmp, proc, time.time()))
    failed = []
    for name, src, so, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, so)
        _LIBS[name] = Library(so, time.time() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: _LIBS[n] for n in names}


def load(name: str) -> Library:
    """Build (once per source revision) and load csrc/<name>.cu."""
    return load_all((name,))[name]


def sass(path: str) -> str:
    """The SASS of a built library, as cuobjdump --dump-sass prints it."""
    return subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", path],
                          capture_output=True, text=True, check=True).stdout


# SASS instruction classes: the conversions that round to bfloat16 (F2FP),
# the FP32 pipe's products and sums, packed bf16x2 arithmetic (HFMA2.MMA is
# the form that issues to the second pipe), shared-memory loads and stores,
# byte permutes, the special-function unit
SASS_CLASSES = {
    "F2FP": r"F2FP\.\S*", "FMUL/FADD/FFMA": r"F(?:MUL|ADD|FMA)(?:\.\S*)?",
    "bf16x2": r"H(?:ADD|MUL|FMA)2(?:\.MMA)?\.BF16\S*", "LDS": r"LDS(?:\.\S*)?",
    "STS": r"STS(?:\.\S*)?", "PRMT": r"PRMT", "MUFU": r"MUFU\.\S*",
}


def sass_counts(sass_text: str, pattern: str = "canny") -> dict:
    """{kernel: {class: count, "all": instructions}} of the kernels in
    `sass_text` (as `sass` prints it) whose mangled names hold `pattern`:
    static counts, each instruction of the code once."""
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass_text,
                                 re.S):
        if pattern not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", body)
        counts = collections.Counter()
        for op in ops:
            for cls, rx in SASS_CLASSES.items():
                if re.fullmatch(rx, op):
                    counts[cls] += 1
        out[name] = {"all": len(ops), **{c: counts[c] for c in SASS_CLASSES}}
    return out
