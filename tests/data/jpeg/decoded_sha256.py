"""The decode cases of the JPEG fixtures here, and decoded_sha256.json, the
SHA-256 of each image that the JAX package's native decoder
(edge_enhancement_tpu/data/native.py::stream_decode_files) gives in each.

A case decodes every fixture in one batch: mode 0 (the full image resized
to 96 x 128), mode 1 (RandomResizedCrop at 128 px from seeded draws) and
mode 2 (the eval centre box of Resize(146) + CenterCrop(128)), each as
uint8 and as float32, every other image flipped. The port's decoder must
give the same bytes (tests/test_torch_jpeg_bundled.py here, chip_smoke.py
phase n on the card). This module imports no JAX: only main() does.

    python tests/data/jpeg/decoded_sha256.py    # rewrites decoded_sha256.json
"""

import glob
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DIGESTS = os.path.join(HERE, "decoded_sha256.json")
# (mode, oh, ow, eval_resize, eval_crop)
CASES = ((0, 96, 128, 0, 0), (1, 128, 128, 0, 0), (2, 128, 128, 146, 128))


def fixtures() -> list:
    return sorted(glob.glob(os.path.join(HERE, "*.JPEG")))


def decode_cases(decode, paths) -> dict:
    """{"mode{m}/{dtype}": (n, oh, ow, 3) array} of `paths` through
    `decode`, a stream_decode_files(paths, mode, draws, eval_resize,
    eval_crop, oh, ow, flip_flags, dtype); raises where it refuses a
    batch."""
    n = len(paths)
    draws = np.random.default_rng(7).random((n, 40), dtype=np.float32)
    flips = (np.arange(n) % 2).astype(np.uint8)
    out = {}
    for mode, oh, ow, resize, crop in CASES:
        for dtype in (np.uint8, np.float32):
            got = decode(paths, mode, draws if mode == 1 else None, resize, crop, oh, ow,
                         flips, dtype)
            if got is None:
                raise RuntimeError(f"the decoder refused mode {mode} {dtype.__name__}")
            out[f"mode{mode}/{dtype.__name__}"] = got
    return out


def digests(decode, paths=None) -> dict:
    """{"mode{m}/{dtype}/{file name}": SHA-256 of that image's bytes}."""
    paths = fixtures() if paths is None else paths
    return {f"{case}/{os.path.basename(p)}": hashlib.sha256(arr[i].tobytes()).hexdigest()
            for case, arr in decode_cases(decode, paths).items()
            for i, p in enumerate(paths)}


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    from edge_enhancement_tpu.data import native as jax_native
    with open(DIGESTS, "w") as f:
        json.dump(digests(jax_native.stream_decode_files), f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
