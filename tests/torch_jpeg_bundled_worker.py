"""One process of tests/test_torch_jpeg_bundled.py: the port's JPEG decoder
built against the libjpeg that PIL runs (a Pillow wheel's bundled copy)
and the vendored ABI-62 headers, with the system's libjpeg left out of the
search, then the decode cases of tests/data/jpeg/decoded_sha256.py over
the given files. Writes <out>.npz: the library linked, the decoder's
build, and one array a case.

    python tests/torch_jpeg_bundled_worker.py <out>.npz <jpeg> [<jpeg> ...]
"""

import os
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(TESTS), os.path.join(TESTS, "data", "jpeg")]

import decoded_sha256  # noqa: E402
from edge_enhancement_tpu_torch.data import native  # noqa: E402


def main(out: str, paths: list) -> None:
    pil = native._pil_libjpeg()
    if pil is None:
        raise SystemExit("PIL runs no ABI-62 libjpeg of its own")
    native._candidates = lambda: [native.vendored(pil)]
    native.set_num_threads(1)
    arrays = decoded_sha256.decode_cases(native.stream_decode_files, paths)
    np.savez(out, library=native.jpeg_library(), build=native.build(),
             decode_path=native.decode_path(),
             **{k.replace("/", "__"): v for k, v in arrays.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
