"""Imported first by every tests/test_torch_*.py: CPU torch on one thread,
and the two native data libraries built once, before any test runs.

The suite runs under pytest-xdist, several worker processes on one host,
and CPU torch's default of one OpenMP thread per core makes each worker's
threads compete with the others' (a port test file that takes 34 s alone
took 457 s with six workers so). One thread a worker keeps each worker's
time its own. Inter-op threads are left alone: setting them raises once
inter-op work has started in the process. The port's JPEG decoder
(data/native.py) runs an OpenMP team of its own, on the loader's lookahead
thread, which torch's setting does not reach: it is held to one thread
too. The module imports no JAX, so the card-only tests
(tests/test_torch_cuda.py) can import it too.

The libraries. A fresh checkout holds neither runtime/libeedata.so (the
JAX package's, which its data/native.py builds at first use straight into
place) nor the port's _build/libeedata_*.so. Each xdist worker imports
this module at collection, so the first worker to get here builds both,
under an exclusive lock on a file in the temp directory, while the others
wait, and then finds them built. The JAX library is built with
runtime/build.py's own command into a temporary path and renamed into
place, so no worker ever opens a half-written file: one that did would
keep the JAX package's numpy or PIL fallback for the rest of its life,
and every test holding the port to JAX's native arithmetic there would
fail.
"""

import fcntl
import hashlib
import importlib.util
import os
import tempfile

import torch

from edge_enhancement_tpu_torch.data import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNTIME = os.path.join(REPO, "runtime")


def _build_jax_runtime() -> None:
    """runtime/libeedata.so, where it is missing or older than its source:
    runtime/build.py's command into a temporary file, then renamed."""
    out, src = os.path.join(RUNTIME, "libeedata.so"), os.path.join(RUNTIME, "eedata.cpp")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return
    spec = importlib.util.spec_from_file_location(
        "ee_runtime_build", os.path.join(RUNTIME, "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.OUT = f"{out}.{os.getpid()}.tmp"
    try:
        mod.build(verbose=False)
        os.replace(mod.OUT, out)
    finally:
        if os.path.exists(mod.OUT):
            os.unlink(mod.OUT)


def build_native_libraries() -> None:
    """Both native libraries, built by one process at a time. Where one
    cannot be built (no g++), the packages take their own fallbacks."""
    key = hashlib.sha256(REPO.encode()).hexdigest()[:16]
    lock = os.path.join(tempfile.gettempdir(), f"ee_native_build_{key}.lock")
    with open(lock, "w") as f:      # closing the file releases the lock
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            _build_jax_runtime()
        except Exception:           # noqa: BLE001  (no compiler: numpy/PIL paths)
            pass
        try:
            native.build()
        except (OSError, RuntimeError):
            pass


torch.set_num_threads(1)
native.set_num_threads(1)
build_native_libraries()
