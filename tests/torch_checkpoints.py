"""The fixture that deletes the checkpoints a port test wrote, once the
test has read and checked them: a ResNet-50's checkpoint is 0.2 GB a
file, and pytest keeps the temporary directories of its last three runs.
A test module takes it by importing it:

    from torch_checkpoints import drop_written_checkpoints  # noqa: F401

The module imports no JAX, so the JAX-free port tests can import it."""

import os
import shutil

import pytest

# the files a run of the port writes beside its checkpoint (train/checkpoint.py)
CHECKPOINT_FILES = ("checkpoint.pth.tar", "model_best.pth.tar", "noise.pt")


def drop_checkpoints(root) -> int:
    """Delete the checkpoints written under `root`: the driver's files, any
    .pth, and the JAX package's Orbax checkpoint directories (those holding
    _CHECKPOINT_METADATA); returns how many went."""
    n = 0
    for dirpath, dirs, files in os.walk(root):
        if "_CHECKPOINT_METADATA" in files:
            shutil.rmtree(dirpath)
            dirs[:] = []
            n += 1
            continue
        for f in files:
            if f in CHECKPOINT_FILES or f.endswith(".pth"):
                os.remove(os.path.join(dirpath, f))
                n += 1
    return n


@pytest.fixture(autouse=True)
def drop_written_checkpoints(request):
    """Autouse where a test module imports it: after each test, the
    checkpoints under its tmp_path go."""
    # asked for before the test, so tmp_path is torn down after this
    root = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if root is not None:
        drop_checkpoints(root)
