"""The port's host JPEG decoder (csrc/eedata.cpp), built and bound with
ctypes: the arithmetic of the JAX package's native data runtime (libjpeg
at the smallest M/8 DCT scale, JDCT_IFAST, the crop in scaled
coordinates, Q8 fixed-point bilinear), so that a folder decodes to the
same pixels as in the JAX package (tests/test_torch_jpeg_bundled.py holds
the decoder on Pillow's bundled libjpeg-turbo to the JAX package's on the
system's, bit for bit).

The libjpeg to link is the first of these whose probe program compiles,
links and runs (`find_libjpeg`):
  1. the system's: <jpeglib.h> with -ljpeg;
  2. the ABI-62 libjpeg that PIL loads (a Pillow wheel bundles
     libjpeg-turbo as pillow.libs/libjpeg-<hash>.so.62.*, without
     headers), compiled against the ABI-62 headers vendored in
     csrc/third_party/libjpeg62, linked by its full path with an rpath to
     its directory.
The probe calls jpeg_create_decompress, which checks the headers'
JPEG_LIB_VERSION and struct size against the library, round-trips a small
image through it and prints the library's path; a candidate that fails
any of that is rejected, and its reason kept (`rejected_libjpeg`).

g++ builds csrc/eedata.cpp at first use into edge_enhancement_tpu_torch/
_build/ (listed in .gitignore), keyed by a hash of the source, the flags
and the library, with `-DEE_HAVE_JPEG` where a libjpeg was found.
`stream_decode_files` returns None where there is none (or no compiler)
and where any file of the batch failed; the caller then decodes the whole
batch with PIL, as the JAX package does. `decode_path()` says which of
the two a loader will take, `jpeg_library()` which library was linked.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "eedata.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
VENDORED_HEADERS = os.path.join(_PKG, "csrc", "third_party", "libjpeg62")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")

# OpenMP threads of a decode call; None is the OpenMP runtime's default
_THREADS: Optional[int] = None

# The probe program: jpeg_create_{,de}compress check JPEG_LIB_VERSION and the
# struct sizes of the headers it was compiled with against the library; a
# 16 x 16 ramp encoded at quality 100 must decode (JDCT_IFAST, as
# csrc/eedata.cpp) to within 8 of itself; prints the library's path.
# libjpeg's default error_exit prints its message and exits with 1.
_PROBE = r"""
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <dlfcn.h>
#include <jpeglib.h>
int main() {
  const int n = 16;
  unsigned char px[n * n * 3], got[n * n * 3];
  for (int i = 0; i < n * n; ++i) {
    px[3 * i] = 16 * (i % n); px[3 * i + 1] = 16 * (i / n); px[3 * i + 2] = 128;
  }
  jpeg_error_mgr err;
  jpeg_compress_struct c;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  unsigned char* jpg = nullptr;
  unsigned long len = 0;
  jpeg_mem_dest(&c, &jpg, &len);
  c.image_width = n; c.image_height = n; c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 100, TRUE);
  for (int k = 0; k < 3; ++k) c.comp_info[k].h_samp_factor = c.comp_info[k].v_samp_factor = 1;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < (unsigned)n) {
    JSAMPROW row = px + c.next_scanline * n * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_decompress_struct d;
  d.err = jpeg_std_error(&err);
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, jpg, len);
  jpeg_read_header(&d, TRUE);
  d.out_color_space = JCS_RGB;
  d.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&d);
  if (d.output_width != (unsigned)n || d.output_height != (unsigned)n) {
    std::fprintf(stderr, "decoded %ux%u, not %dx%d\n", d.output_width, d.output_height, n, n);
    return 1;
  }
  while (d.output_scanline < d.output_height) {
    JSAMPROW row = got + d.output_scanline * n * 3;
    jpeg_read_scanlines(&d, &row, 1);
  }
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  std::free(jpg);
  for (int i = 0; i < n * n * 3; ++i) {
    if (std::abs(int(got[i]) - int(px[i])) > 8) {
      std::fprintf(stderr, "sample %d decoded as %d, encoded %d\n", i, got[i], px[i]);
      return 1;
    }
  }
  Dl_info info;
  if (!dladdr(dlsym(RTLD_DEFAULT, "jpeg_CreateDecompress"), &info) || !info.dli_fname) {
    std::fprintf(stderr, "dladdr found no library for jpeg_CreateDecompress\n");
    return 1;
  }
  std::printf("%s\n", info.dli_fname);
  return 0;
}
"""


@dataclasses.dataclass(frozen=True)
class Libjpeg:
    """A libjpeg the probe ran against: the flags that compile against its
    headers, the arguments that link it, and the library's path."""
    cflags: tuple
    link: tuple
    path: str


def set_num_threads(n: Optional[int]) -> None:
    """The OpenMP threads of each decode call (None: OMP_NUM_THREADS, else
    one a core). The CPU tests set 1: their workers share the host."""
    global _THREADS
    _THREADS = n


def vendored(library: str) -> tuple:
    """(cflags, link) of a libjpeg.so.62 without headers of its own: the
    vendored ABI-62 headers, the file by its full path, an rpath to its
    directory."""
    return (("-I", VENDORED_HEADERS),
            (library, f"-Wl,-rpath,{os.path.dirname(library)}"))


def _pil_libjpeg() -> Optional[str]:
    """The file of the libjpeg that PIL's _imaging runs: the mapping of
    /proc/self/maps that holds the jpeg_CreateDecompress its handle
    resolves (a Pillow wheel's pillow.libs/libjpeg-<hash>.so.62.*, or a
    distribution's libjpeg.so.62). None without PIL, and where that file is
    not an ABI-62 libjpeg (linked into _imaging, libjpeg.so.8)."""
    try:
        from PIL import _imaging
        fn = ctypes.CDLL(_imaging.__file__).jpeg_CreateDecompress
        addr = ctypes.cast(fn, ctypes.c_void_p).value
        with open("/proc/self/maps") as f:
            rows = [ln.split(maxsplit=5) for ln in f]
    except (ImportError, OSError, AttributeError):
        return None
    for row in rows:
        lo, hi = (int(v, 16) for v in row[0].split("-"))
        if lo <= addr < hi and len(row) == 6:
            path = os.path.realpath(row[5].strip())
            if re.fullmatch(r"libjpeg[-.\w]*\.so\.62(\..*)?", os.path.basename(path)):
                return path
    return None


def _candidates() -> list:
    """(cflags, link) of each libjpeg in the order tried: the system's,
    then the one PIL runs, with the vendored headers."""
    pil = _pil_libjpeg()
    return [((), ("-ljpeg",))] + ([vendored(pil)] if pil else [])


def probe(cflags, link) -> Libjpeg:
    """Build and run the probe program against one candidate. Raises
    RuntimeError with the reason where g++ fails or the program does."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="jpeg_probe_", dir=BUILD_DIR) as tmp:
        src, exe = os.path.join(tmp, "probe.cpp"), os.path.join(tmp, "probe")
        with open(src, "w") as f:
            f.write(_PROBE)
        # a position-independent program: jpeg_CreateDecompress's address is
        # then the library's, not a PLT stub of the program's own
        try:
            r = subprocess.run(["g++", "-std=c++17", "-fPIE", "-pie", *cflags, src, "-o", exe,
                                *link, "-ldl"], capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ did not run: {e}") from e
        if r.returncode != 0:
            errors = [ln.strip() for ln in r.stderr.splitlines()
                      if "error" in ln or "undefined reference" in ln]
            raise RuntimeError(f"g++ failed: {' | '.join(errors[:3]) or r.stderr[-300:]}")
        r = subprocess.run([exe], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"the probe exited {r.returncode}: "
                           f"{(r.stderr or r.stdout).strip()[-400:]}")
    return Libjpeg(tuple(cflags), tuple(link), os.path.realpath(r.stdout.strip()))


def search(candidates) -> tuple:
    """(the first candidate whose probe runs or None, the reason each one
    before it was rejected)."""
    rejected = []
    for cflags, link in candidates:
        try:
            return probe(cflags, link), tuple(rejected)
        except RuntimeError as e:
            rejected.append(f"{' '.join(link)}: {e}")
    return None, tuple(rejected)


@functools.lru_cache(maxsize=None)
def find_libjpeg() -> tuple:
    """search(_candidates()), once a process."""
    return search(_candidates())


def rejected_libjpeg() -> tuple:
    """Why each candidate libjpeg tried before the one linked (or all of
    them, where none was) was rejected."""
    return find_libjpeg()[1]


def build() -> str:
    """Build csrc/eedata.cpp (once per source revision and libjpeg) and
    return the library's path. Raises when g++ fails."""
    jpeg = find_libjpeg()[0]
    flags = [*CXX_FLAGS, *(("-DEE_HAVE_JPEG", *jpeg.cflags) if jpeg else ())]
    link = list(jpeg.link) if jpeg else []
    with open(SOURCE, "rb") as f:
        key = f.read() + " ".join(flags + link + [jpeg.path if jpeg else ""]).encode()
    so = os.path.join(BUILD_DIR, f"libeedata_{hashlib.sha256(key).hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
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
    lib.ee_num_threads.restype = ctypes.c_int
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


def num_threads() -> int:
    """The OpenMP threads a decode call runs (0 where the decoder cannot
    be built)."""
    lib = _load()
    if lib is None:
        return 0
    lib.ee_set_num_threads(_THREADS or 0)
    return lib.ee_num_threads()


def jpeg_library() -> Optional[str]:
    """The path of the libjpeg the decoder links, or None where it has
    none."""
    return find_libjpeg()[0].path if has_jpeg() else None


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
                       f"({'; '.join(rejected_libjpeg()) or 'the decoder did not build'}) and PIL "
                       "is not installed")


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
