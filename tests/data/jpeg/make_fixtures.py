"""Write the JPEG fixtures of this directory: one quality-92 JPEG for each
image shape (h, w) that chip_smoke.py's folder phase writes, a smooth
colour ramp under light noise. chip_smoke.py copies them into its folders
where PIL is not installed.

    python tests/data/jpeg/make_fixtures.py
"""

import os

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((375, 500), (500, 375), (500, 333), (480, 640), (64, 64))


def main() -> None:
    for i, (h, w) in enumerate(SHAPES):
        rng = np.random.default_rng(i)
        ramp = (np.linspace(0, 1, h)[:, None, None] * rng.uniform(0, 200, 3)
                + np.linspace(0, 1, w)[None, :, None] * rng.uniform(0, 200, 3))
        px = np.clip(ramp + rng.integers(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(px).save(os.path.join(HERE, f"{h}x{w}.JPEG"), "JPEG", quality=92)


if __name__ == "__main__":
    main()
