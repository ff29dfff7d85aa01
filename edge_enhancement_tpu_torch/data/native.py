"""The port's host JPEG decoder (csrc/eedata.cpp), built and bound with
ctypes: the arithmetic of the JAX package's native data runtime (libjpeg
at the smallest M/8 DCT scale, JDCT_IFAST, the crop in scaled
coordinates, Q8 fixed-point bilinear), so that a folder decodes to the
same pixels as in the JAX package where both link the same libjpeg.

g++ builds csrc/eedata.cpp at first use into edge_enhancement_tpu_torch/
_build/ (listed in .gitignore), keyed by a hash of the source and the
flags, with `-DEE_HAVE_JPEG -ljpeg` when a probe finds libjpeg.
`stream_decode_files` returns None where there is no libjpeg (or no
compiler) and where any file of the batch failed; the caller then decodes
the whole batch with PIL, as the JAX package does. `decode_path()` says
which of the two a loader will take.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "eedata.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")

# OpenMP threads of a decode call; None is the OpenMP runtime's default
_THREADS: Optional[int] = None


def set_num_threads(n: Optional[int]) -> None:
    """The OpenMP threads of each decode call (None: OMP_NUM_THREADS, else
    one a core). The CPU tests set 1: their workers share the host."""
    global _THREADS
    _THREADS = n


def _have_libjpeg() -> bool:
    """Whether g++ compiles and links a program against jpeglib.h."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    probe = os.path.join(BUILD_DIR, f"jpeg_probe_{os.getpid()}.cpp")
    with open(probe, "w") as f:
        # jpeglib.h relies on size_t and FILE being declared by the includer
        f.write("#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n"
                "int main(){return JPEG_LIB_VERSION>0?0:1;}\n")
    try:
        r = subprocess.run(["g++", "-std=c++17", probe, "-ljpeg", "-o", os.devnull],
                           capture_output=True)
        return r.returncode == 0
    except OSError:
        return False
    finally:
        os.unlink(probe)


def build() -> str:
    """Build csrc/eedata.cpp (once per source revision and libjpeg probe)
    and return the library's path. Raises when g++ fails."""
    define, link = (["-DEE_HAVE_JPEG"], ["-ljpeg"]) if _have_libjpeg() else ([], [])
    flags = [*CXX_FLAGS, *define]
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags + link).encode())
    so = os.path.join(BUILD_DIR, f"libeedata_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run(["g++", *flags, SOURCE, "-o", tmp, *link],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The bound library, or None where it cannot be built (no g++)."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError):
        return None
    i64 = ctypes.c_int64
    lib.ee_set_num_threads.argtypes = [ctypes.c_int32]
    lib.ee_has_jpeg.restype = ctypes.c_int
    lib.ee_stream_decode_files.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        i64, ctypes.c_int32,
        ctypes.c_void_p,                 # draws (float*, may be NULL)
        ctypes.c_int32, ctypes.c_int32, i64, i64,
        ctypes.c_void_p,                 # out u8 (may be NULL)
        ctypes.c_void_p,                 # out f32 (may be NULL)
        ctypes.c_void_p]                 # flip flags (uint8*, may be NULL)
    lib.ee_stream_decode_files.restype = ctypes.c_int
    return lib


def has_jpeg() -> bool:
    lib = _load()
    return lib is not None and bool(lib.ee_has_jpeg())


def _have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def decode_path() -> str:
    """"libjpeg" where the native decoder has libjpeg, else "pil"; raises
    where neither is present."""
    if has_jpeg():
        return "libjpeg"
    if _have_pil():
        return "pil"
    raise RuntimeError("no JPEG decoder: the native decoder found no libjpeg "
                       "(jpeglib.h, -ljpeg) and PIL is not installed")


def stream_decode_files(paths, mode: int, draws, eval_resize: int,
                        eval_crop: int, oh: int, ow: int, flip_flags,
                        dtype=np.uint8) -> Optional[np.ndarray]:
    """One batch read, decoded, cropped and resized (and flipped, and
    scaled to [0, 1] for dtype float32) in the native decoder. mode 0 =
    the full image, 1 = RandomResizedCrop from `draws` (n, 40), 2 = the
    eval centre box. Returns None where libjpeg is absent or any file
    failed: the caller decodes the batch with PIL."""
    lib = _load()
    if lib is None or not lib.ee_has_jpeg():
        return None
    n = len(paths)
    enc = [os.fsencode(p) + b"\0" for p in paths]
    offsets = np.zeros(n, np.int64)
    lens = np.asarray([len(e) for e in enc], np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    blob = b"".join(enc)
    out = np.empty((n, oh, ow, 3), dtype)
    out_p = out.ctypes.data_as(ctypes.c_void_p)
    u8_p, f32_p = (out_p, None) if dtype == np.uint8 else (None, out_p)
    draws_p = None
    if draws is not None:
        draws = np.ascontiguousarray(draws, np.float32)
        draws_p = draws.ctypes.data_as(ctypes.c_void_p)
    flags_p = None
    if flip_flags is not None:
        flip_flags = np.ascontiguousarray(flip_flags, np.uint8)
        flags_p = flip_flags.ctypes.data_as(ctypes.c_void_p)
    lib.ee_set_num_threads(_THREADS or 0)
    fails = lib.ee_stream_decode_files(
        blob, offsets, n, int(mode), draws_p, int(eval_resize or 0),
        int(eval_crop or 0), oh, ow, u8_p, f32_p, flags_p)
    return out if fails == 0 else None
