"""Write the JPEG fixtures of this directory.

- One quality-92 JPEG for each image shape (h, w) that chip_smoke.py's
  folder phase writes, a smooth colour ramp under light noise.
  chip_smoke.py copies them into its folders where PIL is not installed.
- Four more, for the decoder's parity checks (decoded_sha256.json,
  tests/test_torch_jpeg_bundled.py): chroma subsampling 4:4:4 and 4:2:2
  (the five above are 4:2:0), a progressive JPEG and a grayscale one.

    python tests/data/jpeg/make_fixtures.py
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((375, 500), (500, 375), (500, 333), (480, 640), (64, 64))
# (file name, (h, w), PIL save options)
VARIANTS = (("200x280_444.JPEG", (200, 280), dict(subsampling=0)),
            ("180x240_422.JPEG", (180, 240), dict(subsampling=1)),
            ("210x150_progressive.JPEG", (210, 150), dict(progressive=True)),
            ("160x200_gray.JPEG", (160, 200), dict()))


def ramp(h: int, w: int, seed: int, noise: int = 8) -> np.ndarray:
    """(h, w, 3) uint8: a smooth colour ramp under noise in [0, noise)."""
    rng = np.random.default_rng(seed)
    px = (np.linspace(0, 1, h)[:, None, None] * rng.uniform(0, 200, 3)
          + np.linspace(0, 1, w)[None, :, None] * rng.uniform(0, 200, 3))
    return np.clip(px + rng.integers(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


def main() -> None:
    for i, (h, w) in enumerate(SHAPES):
        Image.fromarray(ramp(h, w, i)).save(os.path.join(HERE, f"{h}x{w}.JPEG"), "JPEG",
                                            quality=92)
    for i, (name, (h, w), opts) in enumerate(VARIANTS):
        im = Image.fromarray(ramp(h, w, 100 + i))
        if "gray" in name:
            im = im.convert("L")
        im.save(os.path.join(HERE, name), "JPEG", quality=90, **opts)


if __name__ == "__main__":
    main()
