"""The port's JPEG decoder (data/native.py, csrc/eedata.cpp) linked against
the libjpeg that PIL bundles, with the ABI-62 headers vendored in
csrc/third_party/libjpeg62: the route a machine without libjpeg's headers
takes (the H100 host). Here the search is forced past the system's
libjpeg in a subprocess (tests/torch_jpeg_bundled_worker.py), and its
batches are held bit for bit against the JAX package's native decoder,
which links the system's libjpeg; decoded_sha256.json is held to the JAX
decoder; the search rejects a candidate whose probe fails, with its
reason, and takes the next; jpeg_library() names the file the decoder's
build links."""

import torch_threads  # noqa: F401  (first: CPU torch on one thread)
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from edge_enhancement_tpu.data import native as jax_native
from edge_enhancement_tpu_torch.data import native

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_jpeg_bundled_worker.py")
_spec = importlib.util.spec_from_file_location(
    "decoded_sha256", os.path.join(REPO, "tests", "data", "jpeg", "decoded_sha256.py"))
digests = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(digests)

# generated JPEGs: (name, (h, w), PIL save options, grayscale)
GENERATED = {
    "444": ((233, 311), dict(quality=95, subsampling=0), False),
    "422": ((301, 207), dict(quality=75, subsampling=1), False),
    "420": ((128, 517), dict(quality=60, subsampling=2), False),
    "progressive": ((260, 340), dict(quality=85, progressive=True), False),
    "gray": ((190, 250), dict(quality=80), True),
}


@pytest.fixture(scope="module")
def bundled() -> str:
    """The ABI-62 libjpeg file PIL runs here (its wheel's pillow.libs copy)."""
    lib = native._pil_libjpeg()
    assert lib is not None, "PIL runs no ABI-62 libjpeg of its own here"
    assert "pillow.libs" in lib, lib
    return lib


def _write(path: str, kind: str, seed: int) -> str:
    (h, w), opts, gray = GENERATED[kind]
    rng = np.random.default_rng(seed)
    px = (np.linspace(0, 1, h)[:, None, None] * rng.uniform(0, 220, 3)
          + np.linspace(0, 1, w)[None, :, None] * rng.uniform(0, 220, 3))
    px = np.clip(px + rng.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    im = Image.fromarray(px)
    (im.convert("L") if gray else im).save(path, "JPEG", **opts)
    return path


def _run_bundled(tmp_path, paths) -> dict:
    """The worker's output: the port's decoder built against PIL's libjpeg."""
    out = str(tmp_path / "bundled.npz")
    r = subprocess.run([sys.executable, WORKER, out, *paths], cwd=REPO,
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _linked_libjpeg(so: str) -> str:
    """The libjpeg file the dynamic linker resolves for `so` (ldd)."""
    r = subprocess.run(["ldd", so], capture_output=True, text=True, check=True)
    hits = re.findall(r"libjpeg\S*\s+=>\s+(\S+)", r.stdout)
    assert len(hits) == 1, r.stdout
    return os.path.realpath(hits[0])


@pytest.mark.parametrize("kind", ["fixtures", *GENERATED])
def test_bundled_decoder_equals_jax(tmp_path, bundled, kind):
    """Every decode case (modes 0, 1, 2; uint8 and float32; every other
    image flipped) through the port's decoder on PIL's libjpeg equals the
    JAX package's on the system's, bit for bit: the committed fixtures
    (4:2:0, 4:4:4, 4:2:2, progressive, grayscale), then each generated kind
    in a batch of three at other sizes and qualities."""
    if kind == "fixtures":
        paths = digests.fixtures()
    else:
        paths = [_write(str(tmp_path / f"{kind}_{i}.JPEG"), kind, 10 * i + len(kind))
                 for i in range(3)]
    got = _run_bundled(tmp_path, paths)
    assert str(got["library"]) == bundled
    assert str(got["decode_path"]) == "libjpeg"
    assert "pillow.libs" not in _linked_libjpeg(os.path.join(REPO, "runtime", "libeedata.so"))
    want = digests.decode_cases(jax_native.stream_decode_files, paths)
    assert len(want) == 6
    for case, arr in want.items():
        mine = got[case.replace("/", "__")]
        assert mine.dtype == arr.dtype and mine.shape == arr.shape, case
        assert np.array_equal(mine, arr), (case, int((mine != arr).sum()))


@pytest.mark.parametrize("decoder", ["jax", "port"])
def test_decoded_sha256_json_is_current(decoder):
    """decoded_sha256.json is what the JAX package's decoder gives here (so
    it cannot go stale), and the port's decoder on the system's libjpeg
    gives the same."""
    with open(digests.DIGESTS) as f:
        committed = json.load(f)
    decode = {"jax": jax_native.stream_decode_files,
              "port": native.stream_decode_files}[decoder]
    assert len(committed) == 6 * len(digests.fixtures()) == 54
    assert digests.digests(decode) == committed


def _version_80_headers(tmp_path) -> str:
    """The vendored headers with jconfig.h's JPEG_LIB_VERSION set to 80."""
    inc = tmp_path / "libjpeg80"
    shutil.copytree(native.VENDORED_HEADERS, inc)
    conf = inc / "jconfig.h"
    text, n = re.subn(r"#define JPEG_LIB_VERSION\s+62", "#define JPEG_LIB_VERSION 80",
                      conf.read_text())
    assert n == 1
    conf.write_text(text)
    return str(inc)


def _library_without_jpeg(tmp_path) -> str:
    """A shared library that exports no jpeg_* symbol."""
    src, so = tmp_path / "notjpeg.cpp", tmp_path / "libjpeg-notjpeg.so.62"
    src.write_text('extern "C" int not_jpeg() { return 62; }\n')
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(so)], check=True)
    return str(so)


@pytest.mark.parametrize("bad", ["lib_version_80", "no_jpeg_symbols"])
def test_a_candidate_whose_probe_fails_is_rejected(tmp_path, bundled, bad):
    """The search keeps the reason a candidate failed and takes the next:
    headers of ABI 80 against an ABI-62 library compile and link, and
    their probe's jpeg_create_decompress refuses the library at run time;
    a library without jpeg_* symbols fails to link."""
    good = native.vendored(bundled)
    if bad == "lib_version_80":
        first = (("-I", _version_80_headers(tmp_path)), good[1])
        reason = r"the probe exited 1: .*(Wrong JPEG library version|struct mismatch)"
    else:
        first = native.vendored(_library_without_jpeg(tmp_path))
        reason = r"failed: .*undefined reference to .jpeg_"
    found, rejected = native.search([first, good])
    assert found == native.Libjpeg(good[0], good[1], bundled)
    assert len(rejected) == 1 and rejected[0].startswith(" ".join(first[1]))
    assert re.search(reason, rejected[0], re.S), rejected[0]
    assert native.search([first]) == (None, rejected)


@pytest.mark.parametrize("route", ["system", "bundled"])
def test_jpeg_library_names_the_linked_file(tmp_path, bundled, route):
    """jpeg_library() is the libjpeg the dynamic linker resolves for the
    decoder's build: the system's libjpeg.so.62 here, PIL's bundled copy
    where the search starts there."""
    if route == "system":
        lib, so = native.jpeg_library(), native.build()
        assert lib is not None and "pillow.libs" not in lib
        assert native.rejected_libjpeg() == ()
    else:
        got = _run_bundled(tmp_path, digests.fixtures()[:1])
        lib, so = str(got["library"]), str(got["build"])
        assert lib == bundled
    assert _linked_libjpeg(so) == lib
